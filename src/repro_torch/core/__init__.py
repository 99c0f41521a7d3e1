from repro_torch.core import (
    decision_tree,
    ensemble,
    forest_trainer,
    mapreduce,
    pca,
    rotation_forest,
)

__all__ = ["decision_tree", "ensemble", "forest_trainer", "mapreduce", "pca", "rotation_forest"]
