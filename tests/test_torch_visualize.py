"""The port's eval/visualize.py against the JAX package's: the same numpy
inputs through both packages' draw_frame, draw_trajectory (over a small
MapState built here, the same arrays in each package's MapState) and
draw_scene_flow_birdeye give pixel-equal PNGs, each larger than 5000 bytes
(the JAX package's own check, tests/test_frontend.py:301-320, 352-362).
"""

import numpy as np
import pytest
import torch

from vdo_slam_tpu.eval import visualize as jvis
from vdo_slam_tpu.pipeline.map_state import MapState as JaxMapState
from vdo_slam_tpu_torch.eval import visualize as pvis
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.pipeline.map_state import MapState

MIN_BYTES = 5000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _drawing_libraries():
    pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")


def same_png(a, b):
    from PIL import Image

    pa, pb = (np.asarray(Image.open(p)) for p in (a, b))
    assert pa.shape == pb.shape
    np.testing.assert_array_equal(pa, pb)
    for p in (a, b):
        assert p.stat().st_size > MIN_BYTES, (p, p.stat().st_size)


def test_draw_frame(tmp_path):
    sc = make_scene(num_frames=2, width=160, height=120, num_objects=2,
                    seed=3)
    rng = np.random.default_rng(0)
    stat_xy = rng.uniform([0, 0], [160, 120], (300, 2)).astype(np.float32)
    stat_valid = rng.random(300) > 0.2
    dyn_xy = rng.uniform([20, 20], [140, 100], (200, 2)).astype(np.float32)
    dyn_label = rng.integers(0, 4, 200).astype(np.int32)
    dyn_valid = rng.random(200) > 0.1
    args = (sc.rgb[1], stat_xy, stat_valid, dyn_xy, dyn_label, dyn_valid)
    speeds = {1: 23.4, 3: 7.25}
    out = {}
    for name, mod in (("port", pvis), ("jax", jvis)):
        out[name] = tmp_path / f"{name}.png"
        assert mod.draw_frame(*args, out[name], speeds=speeds) == str(
            out[name])
    same_png(out["port"], out["jax"])


def _fill_map(m, seed: int):
    """A 12-frame archive: a camera path and two objects' centres."""
    rng = np.random.default_rng(seed)
    for f in range(12):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.1 * f + rng.normal(0, 0.01), 0.0, 0.8 * f]
        m.cam_pose.append(T)
        m.centres.append([np.zeros(3, np.float32)]
                         + [np.asarray([x + 0.3 * f, 0.5, 10.0 + 0.7 * f],
                                       np.float32) for x in (-4.0, 3.0)])
        m.rm_label.append([0, 1, 2 + f // 6])
    return m


def test_draw_trajectory(tmp_path):
    maps = {"port": _fill_map(MapState(), 1),
            "jax": _fill_map(JaxMapState(), 1)}
    out = {}
    for name, mod in (("port", pvis), ("jax", jvis)):
        out[name] = tmp_path / f"{name}.png"
        mod.draw_trajectory(maps[name], out[name])
    same_png(out["port"], out["jax"])


def test_draw_scene_flow_birdeye(tmp_path):
    rng = np.random.default_rng(0)
    P = rng.uniform([-10, -2, 2], [10, 2, 25], size=(50, 3))
    F = rng.normal(0, 0.3, size=(50, 3))
    valid = rng.random(50) > 0.1
    out = {}
    for name, mod in (("port", pvis), ("jax", jvis)):
        out[name] = tmp_path / f"{name}.png"
        mod.draw_scene_flow_birdeye(P, F, valid, out[name])
    same_png(out["port"], out["jax"])
