from repro_torch.core import pca, rotation_forest

__all__ = ["pca", "rotation_forest"]
