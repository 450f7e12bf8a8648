from .checkpoint import (load_checkpoint, load_fused_checkpoint,
                         save_checkpoint, save_fused_checkpoint,
                         tracker_from_numpy)
from .profiling import StageTimer, recording

__all__ = ["save_checkpoint", "load_checkpoint", "save_fused_checkpoint",
           "load_fused_checkpoint", "tracker_from_numpy", "StageTimer",
           "recording"]
