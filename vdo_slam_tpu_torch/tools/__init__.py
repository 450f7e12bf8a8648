"""Offline tools of the port: `pack_sequence` (a reference-layout
sequence to a packed dataset) and `cube_segmentation` (OMD cube labels
from RGB frames).  Each runs as `python -m vdo_slam_tpu_torch.tools.<name>`.
"""
