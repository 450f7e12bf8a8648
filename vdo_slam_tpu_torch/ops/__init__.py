from . import fast, fast_cuda, frontend, grid, image, orb, select

__all__ = ["fast", "fast_cuda", "frontend", "grid", "image", "orb", "select"]
