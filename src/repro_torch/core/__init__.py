from repro_torch.core import (
    decision_tree,
    forest_trainer,
    mapreduce,
    pca,
    rotation_forest,
)

__all__ = ["decision_tree", "forest_trainer", "mapreduce", "pca", "rotation_forest"]
