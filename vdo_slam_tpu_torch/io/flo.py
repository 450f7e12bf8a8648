"""Copy of vdo_slam_tpu/io/flo.py, unchanged apart from this line.

Middlebury .flo optical-flow file IO.

Replaces cv::optflow::readOpticalFlow (reference example/vdo_slam.cc:117).
Format: magic float 202021.25, int32 width, int32 height, then
width*height*2 float32 (u, v) interleaved, row-major.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_MAGIC = 202021.25


def read_flo(path: str | Path) -> np.ndarray:
    data = Path(path).read_bytes()
    magic, w, h = struct.unpack("<fii", data[:12])
    if abs(magic - _MAGIC) > 1e-3:
        raise ValueError(f"{path}: bad .flo magic {magic}")
    flow = np.frombuffer(data[12:], dtype="<f4", count=w * h * 2)
    return flow.reshape(h, w, 2).copy()


def write_flo(path: str | Path, flow: np.ndarray) -> None:
    h, w, c = flow.shape
    assert c == 2
    with open(path, "wb") as f:
        f.write(struct.pack("<fii", _MAGIC, w, h))
        f.write(np.ascontiguousarray(flow, dtype="<f4").tobytes())
