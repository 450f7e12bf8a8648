from . import fast, fast_cuda, frontend, image, select

__all__ = ["fast", "fast_cuda", "frontend", "image", "select"]
