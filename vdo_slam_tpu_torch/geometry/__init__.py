from . import camera, metrics, se3

__all__ = ["se3", "camera", "metrics"]
