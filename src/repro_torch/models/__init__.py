from repro_torch.models.model import Model, build, for_shape

__all__ = ["Model", "build", "for_shape"]
