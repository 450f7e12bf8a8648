from . import flow_lm, ransac, reproj_lm
from .flow_lm import FlowLMParams
from .reproj_lm import ReprojLMParams

__all__ = ["flow_lm", "ransac", "reproj_lm", "FlowLMParams", "ReprojLMParams"]
