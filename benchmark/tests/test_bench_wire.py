"""The benchmark's device packer against the port's pack_frame, byte for
byte, on the benchmark's own frames and on frames with many exceptions."""

import numpy as np
import pytest
import torch

from benchmark import scene as S
from benchmark.wire import pack_entropy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(gray, draw, flow, mask, scale, seg_cap, exc_cap):
    from vdo_slam_tpu_torch.io.packing import pack_frame

    return np.stack([pack_frame(g, d, f, m, depth_scale=scale,
                                flow_down=2, flow_delta=True, entropy=True,
                                seg_cap=seg_cap, depth_exc_cap=exc_cap)
                     for g, d, f, m in zip(gray, draw, flow, mask)])


@pytest.mark.parametrize("width,height,factor", [(160, 96, 256.0),
                                                 (161, 97, 1000.0)])
def test_scene_frames_pack_as_pack_frame(width, height, factor):
    lay = S.make_layout(5, width, height, 3, float(width), float(width), 11)
    R = S.Renderer(lay, "cpu")
    fr = [R.frame(f) for f in range(4)]
    gray = torch.stack([x["gray"] for x in fr])
    draw = S.depth_raw(torch.stack([x["depth"] for x in fr]), factor,
                       387.5744)
    flow = torch.stack([x["flow"] for x in fr])
    mask = torch.stack([x["mask"] for x in fr])
    scale = 256.0 / factor
    got = pack_entropy(gray, draw, flow, mask, scale, 8192, 8192).numpy()
    want = _ref(gray.numpy(), draw.numpy(), flow.numpy(), mask.numpy(),
                scale, 8192, 8192)
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)


def test_random_frames_pack_as_pack_frame():
    g = torch.Generator().manual_seed(5)
    B, H, W = 3, 33, 50
    gray = torch.rand(B, H, W, generator=g)
    draw = torch.rand(B, H, W, generator=g) * 70000.0     # clipped too
    draw[:, :4] = 0.0
    flow = torch.randn(B, H, W, 2, generator=g) * 30.0
    mask = torch.randint(0, 300, (B, H, W), generator=g, dtype=torch.int32)
    got = pack_entropy(gray, draw, flow, mask, 1.0, 4096, 4096).numpy()
    want = _ref(gray.numpy(), draw.numpy(), flow.numpy(), mask.numpy(),
                1.0, 4096, 4096)
    np.testing.assert_array_equal(got, want)


def test_over_cap_raises():
    g = torch.Generator().manual_seed(6)
    mask = torch.randint(0, 9, (1, 20, 20), generator=g, dtype=torch.int32)
    z = torch.zeros(1, 20, 20)
    with pytest.raises(ValueError, match="seg transition"):
        pack_entropy(z, z, torch.zeros(1, 20, 20, 2), mask, 1.0, 8, 8)
