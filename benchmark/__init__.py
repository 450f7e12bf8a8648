"""The benchmark of the PyTorch port (vdo_slam_tpu_torch): see run.py and
BENCHMARK.json at the root of the repo."""
