"""The frame wire: vdo_slam_tpu_torch/io/packing.py against
vdo_slam_tpu/io/packing.py on the same seeded numpy frames (96x64 and the
odd 97x63), for every wire layout.

Tolerances: atol = 0 throughout.  `pack_frame` is bytes.  `unpack_frame`'s
gray, depth, seg and undownsampled flow are integer work and one float
multiply.  The seg-aware 2x upsample (the flow of `flow_down` 2 and 4, the
depth of `depth_down=2`) is float arithmetic written in the JAX package's
order of operations: against the numpy mirror and against the JAX function
run eagerly on the CPU it reaches 0 too.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdo_slam_tpu import config as jconfig
from vdo_slam_tpu.io import packing as jpk
from vdo_slam_tpu_torch import config as pconfig
from vdo_slam_tpu_torch.io import packing as ppk

SIZES = [(64, 96), (63, 97)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs in several worker processes at once, and each worker's idle
    OpenMP threads spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
WIRES = {
    "dense": dict(),
    "dense_delta": dict(flow_delta=True),
    "down2": dict(flow_down=2),
    "half_legacy": dict(flow_half=True),
    "down4": dict(flow_down=4),
    "down2_delta": dict(flow_down=2, flow_delta=True),
    "depth_down2": dict(flow_down=2, depth_down=2),
    "depth_resid": dict(flow_down=2, depth_down=2, depth_resid=64),
    "entropy": dict(flow_down=2, entropy=True, seg_cap=1024,
                    depth_exc_cap=2048),
    "entropy_down4_delta": dict(flow_down=4, flow_delta=True, entropy=True,
                                seg_cap=1024, depth_exc_cap=2048),
}


def make_frame(H, W, seed=0):
    """A seeded frame: textured gray, piecewise-planar disparity with a few
    holes and jumps, block labels, smooth flow that differs per label."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    gray = rng.random((H, W), dtype=np.float32)
    seg = np.zeros((H, W), np.int32)
    seg[H // 5:H // 2, W // 6:W // 2] = 3
    seg[H // 2:H - 4, W // 2:W - 5] = 7
    seg[5:12, W - 20:W - 3] = 255
    depth = 2000.0 + 8.0 * xs + 5.0 * ys
    depth = np.where(seg == 3, 6000.0 + 3.0 * xs, depth)
    depth = np.where(seg == 7, 9000.0 - 2.0 * ys, depth)
    depth += rng.normal(0.0, 2.0, (H, W))
    depth[rng.random((H, W)) < 0.02] = 0.0           # invalid samples
    depth = depth.astype(np.float32)
    flow = np.stack([0.03 * xs - 1.0, 0.02 * ys + 0.5], -1)
    flow = np.where((seg == 3)[..., None], flow + [4.0, -2.5], flow)
    flow = np.where((seg == 7)[..., None], flow * -1.5, flow)
    flow = (flow + rng.normal(0.0, 0.05, (H, W, 2))).astype(np.float32)
    return gray, depth, flow, seg


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def unpack_both(buf, H, W, kw, scale=1.0):
    ukw = dict(kw, depth_scale=scale, hw=(H, W))
    jout = [np.asarray(x) for x in jpk.unpack_frame(jnp.asarray(buf), **ukw)]
    pout = [x.numpy() for x in ppk.unpack_frame(t(buf), **ukw)]
    return jout, pout


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("wire", list(WIRES))
class TestWire:
    def test_pack_frame_bytes_equal(self, wire, size):
        H, W = size
        frame = make_frame(H, W, seed=1)
        for scale in (1.0, 0.5):
            a = jpk.pack_frame(*frame, depth_scale=scale, **WIRES[wire])
            b = ppk.pack_frame(*frame, depth_scale=scale, **WIRES[wire])
            assert a.dtype == b.dtype == np.int16 and a.shape == b.shape
            assert a.tobytes() == b.tobytes()

    def test_unpack_matches_jax(self, wire, size):
        H, W = size
        kw = WIRES[wire]
        buf = jpk.pack_frame(*make_frame(H, W, seed=2), depth_scale=0.5,
                             **kw)
        (jg, jd, jf, js), (pg, pd, pf, ps) = unpack_both(buf, H, W, kw, 0.5)
        assert pg.dtype == pd.dtype == pf.dtype == np.float32
        assert ps.dtype == np.int32
        assert pg.shape == pd.shape == ps.shape == (H, W)
        assert pf.shape == (H, W, 2)
        np.testing.assert_array_equal(pg, jg)
        np.testing.assert_array_equal(ps, js)
        np.testing.assert_array_equal(pd, jd)
        np.testing.assert_array_equal(pf, jf)

    def test_round_trip(self, wire, size):
        H, W = size
        kw = WIRES[wire]
        gray, depth, flow, seg = make_frame(H, W, seed=3)
        buf = ppk.pack_frame(gray, depth, flow, seg, depth_scale=1.0, **kw)
        g, d, f, s = (x.numpy() for x in ppk.unpack_frame(
            t(buf), depth_scale=1.0, hw=(H, W), **kw))
        assert np.abs(g - gray).max() <= 0.5 / 255 + 1e-6
        np.testing.assert_array_equal(s, seg)
        dd = kw.get("depth_down", 1)
        # carried samples: exact, or through 1 / (1 / z) for depth_down=2
        np.testing.assert_allclose(d[::dd, ::dd], np.rint(depth)[::dd, ::dd],
                                   rtol=0 if dd == 1 else 2e-7, atol=0)
        down = 2 if kw.get("flow_half") else kw.get("flow_down", 1)
        np.testing.assert_array_equal(
            f[::down, ::down],
            flow[::down, ::down].astype(np.float16).astype(np.float32))
        if down > 1:   # interpolated samples stay near the smooth field
            assert np.abs(f - flow).max() < 0.5


@pytest.mark.parametrize("case", [
    dict(flow_down=3), dict(flow_down=2, depth_down=3), dict(depth_down=2),
    dict(flow_down=2, depth_resid=8), dict(entropy=True),
    dict(flow_down=2, depth_down=2, entropy=True),
    dict(flow_down=2, entropy=True, seg_cap=4),
    dict(flow_down=2, entropy=True, depth_exc_cap=2),
], ids=["flow_down3", "depth_down3", "depth_down_dense", "resid_no_down",
        "entropy_dense", "entropy_depth_down", "seg_cap", "depth_exc_cap"])
def test_pack_frame_raises_like_jax(case):
    frame = make_frame(64, 96, seed=4)
    with pytest.raises(ValueError) as je:
        jpk.pack_frame(*frame, **case)
    with pytest.raises(ValueError) as pe:
        ppk.pack_frame(*frame, **case)
    assert str(je.value) == str(pe.value)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("extrap", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
def test_upsample2x_seg_three_ways(with_valid, extrap, size):
    """torch vs the numpy mirror (atol = 0) vs the JAX function."""
    H, W = size
    _, depth, flow, seg = make_frame(H, W, seed=5)
    f = np.concatenate([flow, depth[..., None] * 1e-3], -1)[0::2, 0::2]
    valid = (depth[0::2, 0::2] > 0) if with_valid else None
    ref_np = jpk._upsample2x_seg(f, seg, valid, extrap=extrap, xp=np)
    own_np = ppk._upsample2x_seg_np(f, seg, valid, extrap=extrap)
    np.testing.assert_array_equal(own_np, ref_np)
    got = ppk._upsample2x_seg(t(f), t(seg),
                              None if valid is None else t(valid),
                              extrap=extrap).numpy()
    assert got.shape == (2 * f.shape[0], 2 * f.shape[1], 3)
    np.testing.assert_array_equal(got, ref_np)
    ref_jax = np.asarray(jpk._upsample2x_seg(
        jnp.asarray(f), jnp.asarray(seg),
        None if valid is None else jnp.asarray(valid), extrap=extrap))
    np.testing.assert_array_equal(got, ref_jax)
    np.testing.assert_array_equal(got[0::2, 0::2][valid], f[valid]) \
        if with_valid else np.testing.assert_array_equal(got[0::2, 0::2], f)


@pytest.mark.parametrize("wire", ["dense_delta", "depth_resid",
                                  "entropy_down4_delta"])
def test_unpack_leading_dims_equal_single_frames(wire):
    """(C, ...) and (S, C, ...) buffers decode as their frames do alone."""
    H, W = 63, 97
    kw = WIRES[wire]
    bufs = np.stack([ppk.pack_frame(*make_frame(H, W, seed=10 + i), **kw)
                     for i in range(4)])
    single = [ppk.unpack_frame(t(b), hw=(H, W), **kw) for b in bufs]
    both = ppk.unpack_frame(t(bufs), hw=(H, W), **kw)
    nested = ppk.unpack_frame(t(bufs.reshape((2, 2) + bufs.shape[1:])),
                              hw=(H, W), **kw)
    for k in range(4):
        for i in range(4):
            assert torch.equal(both[k][i], single[i][k])
            assert torch.equal(nested[k][i // 2, i % 2], single[i][k])


def test_row_delta_round_trip_and_helpers():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 65536, (7, 33)).astype(np.uint16)
    d = ppk._row_delta_u16(a)
    np.testing.assert_array_equal(d, jpk._row_delta_u16(a))
    back = ppk._row_undelta_u16(t(d.astype(np.int32)))
    np.testing.assert_array_equal(back.numpy(), a)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jpk._row_undelta_u16(jnp.asarray(d))))
    for factor in (1.0, 256.0, 5000.0):
        assert ppk.depth_wire_scale(factor) == jpk.depth_wire_scale(factor)
    v = rng.integers(0, 256, 11)
    np.testing.assert_array_equal(ppk._pack_u8_pairs(v),
                                  jpk._pack_u8_pairs(v))


@pytest.mark.parametrize("preset", ["default", "tpu_fast", "resid"])
def test_wire_kwargs_equal_jax(preset):
    jc, pc = jconfig.VDOConfig(), pconfig.VDOConfig()
    if preset == "tpu_fast":
        jc, pc = jconfig.tpu_fast(jc), pconfig.tpu_fast(pc)
    elif preset == "resid":
        kw = dict(wire_flow_down=4, wire_depth_down=2, wire_depth_resid=32)
        jc = jc.replace(tracking=dataclasses.replace(jc.tracking, **kw))
        pc = pc.replace(tracking=dataclasses.replace(pc.tracking, **kw))
    assert ppk.wire_kwargs(pc.tracking) == jpk.wire_kwargs(jc.tracking)
    frame = make_frame(63, 97, seed=7)
    assert (ppk.pack_frame(*frame, **ppk.wire_kwargs(pc.tracking)).tobytes()
            == jpk.pack_frame(*frame,
                              **jpk.wire_kwargs(jc.tracking)).tobytes())
