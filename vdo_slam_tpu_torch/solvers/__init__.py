from . import flow_lm, ransac
from .flow_lm import FlowLMParams

__all__ = ["flow_lm", "ransac", "FlowLMParams"]
