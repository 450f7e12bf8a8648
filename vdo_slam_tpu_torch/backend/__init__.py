from .factor_graph import Graph, LMParams, Variables, lm_solve
from .full_ba import full_ba_inplace
from .window_ba import local_ba_inplace

__all__ = ["Graph", "Variables", "LMParams", "lm_solve", "local_ba_inplace",
           "full_ba_inplace"]
