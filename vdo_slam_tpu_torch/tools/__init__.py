"""Tools of the port, each run as `python -m vdo_slam_tpu_torch.tools.<name>`:
`pack_sequence` (a reference-layout sequence to a packed dataset),
`cube_segmentation` (OMD cube labels from RGB frames), `probe_loop` and
`probe_chunk` (the fused drive's time per frame and per chunk, phase by
phase) and `capture_extras` (the bench's non-default modes, one JSON
file).
"""
