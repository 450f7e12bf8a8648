"""Tools of the port, each run as `python -m vdo_slam_tpu_torch.tools.<name>`:
`pack_sequence` (a reference-layout sequence to a packed dataset) and
`cube_segmentation` (OMD cube labels from RGB frames).
"""
