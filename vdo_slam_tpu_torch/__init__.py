"""vdo_slam_tpu_torch — the PyTorch/CUDA port of vdo_slam_tpu.

Both tracking modes of the JAX package's System, the host-orchestrated
Tracker (mode "reference", the default) and the fused per-frame step
(mode "fused", also batched over S streams), with the window and
full-batch BA passes (backend/), the run CLI (run.py) and every option of
the stages, on PyTorch, with the FAST-9/16 corner score as a CUDA kernel
written for Hopper (ops/fast_cuda.py, csrc/fast_score.cu).  The JAX
package beside it is the reference every module is tested against.
"""

import torch as _torch

# SLAM geometry needs true fp32 matmuls (vdo_slam_tpu/__init__.py pins
# "highest" for the same reason): TF32 keeps ~3 decimal digits, which breaks
# the 3x3/4x4 pose algebra and the LM normal equations.  cuDNN's TF32 switch
# defaults to True, so both are set.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .config import VDOConfig, load_settings  # noqa: E402

__version__ = "0.1.0"
__all__ = ["VDOConfig", "load_settings", "__version__"]
