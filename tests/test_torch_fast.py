"""The FAST detector: the port's plain `fast_score` against the JAX
package's `fast_score` and its Pallas kernel in interpret mode (as
tests/test_frontend.py runs it on the CPU), with atol=0; detect_level
identical at level 0; the whole pyramid overlapping by >= 99% (the
antialiased resizes of the two packages differ by <= 2.9e-5, which can flip
a compare).

The CUDA kernel itself runs only on a GPU (test_torch_kernel_cuda.py).  Its
arithmetic is replayed here by a numpy emulation of each block (the launch
geometry of `pyramid_layout`, the clamped shared-memory tile, the compass
early exit and the doubling arcs), held to the plain version and to the
Pallas kernel at atol=0: min, max, compares and one fp32 subtraction per
neighbour are exact, so any difference is a fault.  The pyramid itself is
held to the float64 product of JAX's own float32 resize weights within
2e-6, at 1242x375 as well as on the small frame.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from vdo_slam_tpu.ops import fast as jfast
from vdo_slam_tpu.ops.fast_pallas import fast_score_pair_pallas
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.ops import fast
from vdo_slam_tpu_torch.ops.fast_cuda import (KERNEL, MAX_LEVELS, TILE,
                                              fast_score_pair,
                                              fast_score_pyramid,
                                              pyramid_layout)

TH_INI, TH_MIN = 20 / 255.0, 7 / 255.0


def _binary(shape, seed):
    return (np.random.default_rng(seed).random(shape) > 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def frame():
    return make_scene(num_frames=2, width=200, height=120, num_objects=2,
                      seed=3).rgb[0]


CASES = [("binary_120x200", (120, 200), 0, TH_INI),
         ("binary_97x131", (97, 131), 1, 15 / 255.0)]


class TestPlainScore:
    @pytest.mark.parametrize("name,shape,seed,th_ini", CASES)
    def test_matches_jax_and_pallas(self, name, shape, seed, th_ini):
        img = _binary(shape, seed)
        s_ini, s_min = fast_score_pair(torch.from_numpy(img), th_ini, TH_MIN)
        p_ini, p_min = fast_score_pair_pallas(jnp.asarray(img), th_ini, TH_MIN,
                                              interpret=True)
        for port, th, pal in ((s_ini, th_ini, p_ini), (s_min, TH_MIN, p_min)):
            ref = np.asarray(jfast.fast_score(jnp.asarray(img), th))
            np.testing.assert_allclose(port, ref, atol=0, rtol=0)
            np.testing.assert_allclose(port, np.asarray(pal), atol=0, rtol=0)
            assert (ref > 0).any()

    def test_batch_of_3(self):
        imgs = _binary((3, 64, 150), 2)
        b_ini, b_min = fast_score_pair(torch.from_numpy(imgs), TH_INI, TH_MIN)
        for s in range(3):
            p_ini, p_min = fast_score_pair_pallas(jnp.asarray(imgs[s]), TH_INI,
                                                  TH_MIN, interpret=True)
            np.testing.assert_allclose(b_ini[s], np.asarray(p_ini), atol=0,
                                       rtol=0)
            np.testing.assert_allclose(b_min[s], np.asarray(p_min), atol=0,
                                       rtol=0)

    def test_difference_exactly_on_the_threshold(self):
        """A difference of exactly fp32(20/255) is not a corner: the compare
        is in float32 (in double it would be one)."""
        img = np.zeros((16, 16), np.float32)
        img[:, 8:] = np.float32(TH_INI)
        img[5:9, 8:] = 1.0
        port = fast.fast_score(torch.from_numpy(img), TH_INI)
        ref = np.asarray(jfast.fast_score(jnp.asarray(img), TH_INI))
        np.testing.assert_array_equal(port, ref)
        assert float(np.float32(TH_INI)) > TH_INI  # the double would flip

    def test_synthetic_frame(self, frame):
        for th in (TH_INI, TH_MIN):
            port = fast.fast_score(torch.from_numpy(frame), th)
            ref = jfast.fast_score(jnp.asarray(frame), th)
            np.testing.assert_allclose(port, np.asarray(ref), atol=0, rtol=0)
            assert (port > 0).sum() > 100
        pal = fast_score_pair_pallas(jnp.asarray(frame), TH_INI, TH_MIN,
                                     interpret=True)
        np.testing.assert_allclose(fast.fast_score(torch.from_numpy(frame),
                                                   TH_INI),
                                   np.asarray(pal[0]), atol=0, rtol=0)


class TestDetect:
    def test_detect_level0_identical(self, frame):
        xy, sc, ok = fast.detect_level(torch.from_numpy(frame), TH_INI,
                                       TH_MIN, 30, 400)
        jxy, jsc, jok = jfast.detect_level(jnp.asarray(frame), TH_INI, TH_MIN,
                                           30, 400)
        np.testing.assert_array_equal(xy, np.asarray(jxy))
        np.testing.assert_array_equal(sc, np.asarray(jsc))
        np.testing.assert_array_equal(ok, np.asarray(jok))
        assert int(ok.sum()) > 50

    def test_every_level_identical_on_the_same_image(self, frame):
        """detect_level is exact given the same level image: all of the
        pyramid's disagreement comes from the resize."""
        import jax

        detect = jax.jit(jfast.detect_level, static_argnums=(1, 2, 3, 4))
        shapes = fast.level_shapes(120, 200, 8, 1.2)
        for l in (1, 4, 7):
            img = np.array(jax.image.resize(jnp.asarray(frame), shapes[l],
                                            method="bilinear"))
            cell = max(int(30 / 1.2 ** l), 8)
            port = fast.detect_level(torch.from_numpy(img), TH_INI, TH_MIN,
                                     cell, 100)
            ref = detect(jnp.asarray(img), TH_INI, TH_MIN, cell, 100)
            for p, r in zip(port, ref):
                np.testing.assert_array_equal(p, np.asarray(r))

    def test_pyramid_overlap(self, frame):
        """>= 99% of detections shared over the whole pyramid.  The frame
        gets seeded sensor-like noise (sigma 0.003): the noise-free
        checkerboard has exact score ties at every corner, and a 1e-6
        resize difference reorders ties inside the per-cell top-k."""
        noisy = np.clip(frame + np.random.default_rng(0).normal(
            0.0, 0.003, frame.shape), 0.0, 1.0).astype(np.float32)
        port = fast.detect_pyramid(torch.from_numpy(noisy), n_features=800,
                                   n_levels=8)
        ref = jfast.detect_pyramid(jnp.asarray(noisy), n_features=800,
                                   n_levels=8, use_pallas=False)
        np.testing.assert_array_equal(port["octave"], np.asarray(ref["octave"]))

        def keyset(d):
            xy = np.asarray(d["xy"])[np.asarray(d["valid"])]
            oc = np.asarray(d["octave"])[np.asarray(d["valid"])]
            return {(int(o), round(float(x), 3), round(float(y), 3))
                    for o, (x, y) in zip(oc, xy)}

        a, b = keyset(port), keyset(ref)
        assert len(a & b) >= 0.99 * max(len(a), len(b)), (len(a), len(b),
                                                           len(a & b))

    def test_pyramid_resize_close(self, frame):
        import jax

        for (Hl, Wl), img in zip(fast.level_shapes(120, 200, 8, 1.2)[1:],
                                 fast.pyramid(torch.from_numpy(frame))[1:]):
            ref = jax.image.resize(jnp.asarray(frame), (Hl, Wl),
                                   method="bilinear")
            np.testing.assert_allclose(img, np.asarray(ref), rtol=0,
                                       atol=3e-5)


class TestWrapperContract:
    @pytest.mark.parametrize("bad,err", [
        (torch.zeros(20, 20, dtype=torch.float64), TypeError),
        (torch.zeros(6, 20), ValueError),
        (torch.zeros(2, 2, 20, 20), ValueError),
        (torch.zeros(20, 40)[:, ::2], ValueError),
    ])
    def test_rejects(self, bad, err):
        with pytest.raises(err):
            fast_score_pair(bad, TH_INI, TH_MIN)

    @pytest.mark.parametrize("levels", [
        [],
        [torch.zeros(16, 16)] * (MAX_LEVELS + 1),
        [torch.zeros(2, 16, 16), torch.zeros(3, 9, 9)],
        [torch.zeros(16, 16), torch.zeros(1, 9, 9)],
    ], ids=["none", "too_many", "mixed_S", "mixed_rank"])
    def test_pyramid_rejects(self, levels):
        with pytest.raises(ValueError):
            fast_score_pyramid(levels, TH_INI, TH_MIN)

    def test_cpu_path_does_not_count(self):
        before = KERNEL.launches
        fast_score_pair(torch.zeros(16, 16), TH_INI, TH_MIN)
        assert KERNEL.launches == before


# ---------------------------------------------------------------------------
# the kernel's arithmetic, replayed in numpy (csrc/fast_score.cu)
# ---------------------------------------------------------------------------

R = 3


def _best_arc(e):
    """best_arc of the source: max(0, largest 9-arc minimum of e (16, ...)),
    the arcs by doubling."""
    m = np.minimum(e, np.roll(e, -1, 0))
    m = np.minimum(m, np.roll(m, -2, 0))
    m = np.minimum(m, np.roll(m, -4, 0))       # min of e[i..i+7]
    arcs = np.minimum(m, np.roll(m, -1, 0))    # min of e[i..i+8]
    return np.maximum(np.float32(0), arcs.max(0))


def _tile_scores(tile, t):
    """Phases 1 and 2 of the source for every pixel of a (TILE+6)^2 shared
    tile: the compass test at t puts a pixel on the bright and/or the dark
    list; each listed side's arc value is kept if it is > t; M is the
    largest kept value, else 0.  Returns (M, bright, dark), (TILE, TILE)."""
    c = tile[R:R + TILE, R:R + TILE]
    d = np.stack([tile[R + dy:R + dy + TILE, R + dx:R + dx + TILE] - c
                  for dx, dy in fast._CIRCLE])
    comp, nxt = d[[0, 4, 8, 12]], d[[4, 8, 12, 0]]
    bright = ((comp > t) & (nxt > t)).any(0)
    dark = ((comp < -t) & (nxt < -t)).any(0)
    m = np.zeros_like(c)
    for listed, side in ((bright, _best_arc(d)), (dark, _best_arc(-d))):
        m = np.where(listed & (side > t), np.maximum(m, side), m)
    return m, bright, dark


def emulate_launch(levels, th_ini, th_min):
    """The pyramid launch block by block: the same geometry
    (`pyramid_layout`), the level found by scanning the prefix table, the
    tile loaded with clamped indices, the per-pixel algebra, the writes.
    Returns ([(s_ini, s_min)] per level, share of interior pixels on a
    list)."""
    levels = [np.asarray(g, np.float32) for g in levels]
    S = levels[0].shape[0] if levels[0].ndim == 3 else 1
    rows, n_tiles, size = pyramid_layout([g.shape[-2:] for g in levels], S)
    out = np.full(size, np.nan, np.float32)  # NaN: never written
    ti, tm = np.float32(th_ini), np.float32(th_min)
    t = min(ti, tm)
    n_listed = n_interior = 0
    for b in range(n_tiles):
        k = 0
        for j in range(1, len(rows)):
            if b >= rows[j][4]:
                k = j
        lv, off, H, W, tile0, tiles_x = rows[k]
        ty, tx = divmod(b - tile0, tiles_x)
        y0, x0 = ty * TILE, tx * TILE
        gy = np.clip(np.arange(y0 - R, y0 + TILE + R), 0, H - 1)
        gx = np.clip(np.arange(x0 - R, x0 + TILE + R), 0, W - 1)
        ys = np.arange(y0, y0 + TILE)[:, None]
        xs = np.arange(x0, x0 + TILE)[None, :]
        inside = (ys < H) & (xs < W)
        interior = (ys >= R) & (ys < H - R) & (xs >= R) & (xs < W - R)
        yy, xx = np.nonzero(inside)
        for s in range(S):
            img = levels[lv].reshape(S, H, W)[s]
            m, bright, dark = _tile_scores(img[np.ix_(gy, gx)], t)
            m = np.where(interior, m, np.float32(0))
            n_listed += int(((bright | dark) & interior).sum())
            n_interior += int(interior.sum())
            idx = off + s * H * W + (y0 + yy) * W + (x0 + xx)
            out[idx] = np.where(m > ti, m, np.float32(0))[inside]
            out[idx + S * H * W] = np.where(m > tm, m, np.float32(0))[inside]
    assert not np.isnan(out).any(), "a pixel was never written"
    offs = {row[0]: row[1] for row in rows}
    pairs = [(out[offs[l]:offs[l] + g.size].reshape(g.shape),
              out[offs[l] + g.size:offs[l] + 2 * g.size].reshape(g.shape))
             for l, g in enumerate(levels)]
    return pairs, n_listed / max(n_interior, 1)


def _tie_image():
    """Differences landing exactly on fp32(20/255)."""
    img = np.zeros((16, 16), np.float32)
    img[:, 8:] = np.float32(TH_INI)
    img[5:9, 8:] = 1.0
    return img


def _hold_to_plain_and_pallas(levels, th_ini, th_min, pallas=True):
    pairs, share = emulate_launch(levels, th_ini, th_min)
    for g, (e_ini, e_min) in zip(levels, pairs):
        gt = torch.from_numpy(np.ascontiguousarray(g))
        for em, th in ((e_ini, th_ini), (e_min, th_min)):
            np.testing.assert_array_equal(em, fast.fast_score(gt, th).numpy())
        if pallas:
            gj = jnp.asarray(g)
            for img, e_i, e_m in (zip(gj, e_ini, e_min) if g.ndim == 3
                                  else [(gj, e_ini, e_min)]):
                p_ini, p_min = fast_score_pair_pallas(img, th_ini, th_min,
                                                      interpret=True)
                np.testing.assert_array_equal(e_i, np.asarray(p_ini))
                np.testing.assert_array_equal(e_m, np.asarray(p_min))
    return pairs, share


class TestKernelAlgebra:
    @pytest.mark.parametrize("name,shape,seed,th_ini", CASES + [
        ("binary_batch_3x64x150", (3, 64, 150), 2, TH_INI)])
    def test_binary(self, name, shape, seed, th_ini):
        pairs, share = _hold_to_plain_and_pallas([_binary(shape, seed)],
                                                 th_ini, TH_MIN)
        assert (pairs[0][1] > 0).any() and 0.0 < share < 1.0

    def test_pyramid_levels_one_launch(self, frame):
        levels = [g.numpy() for g in fast.pyramid(torch.from_numpy(frame))]
        assert len(levels) == 8 and all(g.shape[0] % TILE for g in levels)
        pairs, share = _hold_to_plain_and_pallas(levels, TH_INI, TH_MIN)
        assert all((e_min > 0).any() for _, e_min in pairs)
        assert 0.0 < share < 1.0

    def test_threshold_ties(self):
        _hold_to_plain_and_pallas([_tie_image()], TH_INI, TH_MIN)
        _hold_to_plain_and_pallas([_tie_image()], TH_MIN, TH_INI)

    @settings(max_examples=40, deadline=None, derandomize=True)
    @given(img=hnp.arrays(np.int8, st.sampled_from([(9, 11), (12, 40)]),
                          elements=st.integers(0, 4)),
           ths=st.sampled_from([(1 / 8, 2 / 8), (2 / 8, 1 / 8),
                                (TH_INI, TH_MIN), (TH_MIN, 1 / 8)]))
    def test_coarse_grid_ties(self, img, ths):
        """Values on a grid of 1/8: differences tie with the 1/8 and 2/8
        thresholds exactly; th_ini is above and below th_min."""
        _hold_to_plain_and_pallas([img.astype(np.float32) / 8], *ths)

    def test_compass_test_never_drops_a_corner(self, frame):
        """Every pixel with a score at min(th_ini, th_min) is on a list."""
        g = np.ascontiguousarray(
            np.pad(frame, R, mode="edge")[:TILE + 2 * R, :TILE + 2 * R])
        _, bright, dark = _tile_scores(g, np.float32(TH_MIN))
        score = fast.fast_score(torch.from_numpy(g), TH_MIN).numpy()
        corner = score[R:-R, R:-R] > 0
        assert corner.any() and bright.any() and dark.any()
        assert not (corner & ~(bright | dark)).any()


class TestPyramidCall:
    def test_cpu_pyramid_equals_per_level_pair(self, frame):
        levels = fast.pyramid(torch.from_numpy(frame))
        batch = [torch.stack([g, 1.0 - g]).contiguous() for g in levels[3:]]
        for lv in (levels, batch):
            before = KERNEL.launches
            pairs = fast_score_pyramid(lv, TH_INI, TH_MIN)
            assert KERNEL.launches == before
            assert len(pairs) == len(lv)
            for g, (s_ini, s_min) in zip(lv, pairs):
                r_ini, r_min = fast_score_pair(g, TH_INI, TH_MIN)
                assert s_ini.shape == g.shape
                assert torch.equal(s_ini, r_ini) and torch.equal(s_min, r_min)

    def test_layout(self):
        shapes = fast.level_shapes(375, 1242, 8, 1.2)
        rows, n_tiles, size = pyramid_layout(shapes, 3)
        assert size == 2 * 3 * sum(h * w for h, w in shapes) == 6 * 1441692
        assert n_tiles == 1492
        # the table runs from the last level to the first, tiles in order
        assert [r[0] for r in rows] == list(range(7, -1, -1))
        assert [r[4] for r in rows] == sorted(r[4] for r in rows)
        tile_end = [r[4] for r in rows[1:]] + [n_tiles]
        for (level, off, H, W, tile0, tiles_x), end in zip(rows, tile_end):
            assert (H, W) == shapes[level]
            assert off == 6 * sum(h * w for h, w in shapes[:level])
            assert end - tile0 == tiles_x * -(-H // TILE)

    def test_detect_pyramid_uses_the_pyramid_call(self, frame, monkeypatch):
        calls = []
        real = fast.fast_score_pyramid

        def spy(levels, th_ini, th_min):
            calls.append(len(levels))
            return real(levels, th_ini, th_min)

        monkeypatch.setattr(fast, "fast_score_pyramid", spy)
        fast.detect_pyramid(torch.from_numpy(frame), n_features=400)
        assert calls == [8]


def _resize_weights(n_in, n_out):
    """The weights jax.image.resize uses for an antialiased bilinear resize
    of one axis, as JAX computes them (float32): (n_in, n_out)."""
    from jax._src.image import scale

    return np.asarray(scale.compute_weight_mat(
        n_in, n_out, n_out / n_in, 0.0,
        scale._kernels[scale.ResizeMethod.LINEAR], True), np.float64)


@pytest.mark.parametrize("which", ["random_375x1242", "synthetic_120x200"])
def test_pyramid_equals_float64_resize(which, frame):
    """Each level within 2e-6 of the float64 product of the resize weights
    (float32 rounding of a sum of a few products; jax.image.resize on the
    CPU is further off, see test_pyramid_resize_close)."""
    img = (np.random.default_rng(5).random((375, 1242), dtype=np.float32)
           if which.startswith("random") else frame)
    H, W = img.shape
    levels = fast.pyramid(torch.from_numpy(img))
    for (Hl, Wl), got in zip(fast.level_shapes(H, W, 8, 1.2)[1:], levels[1:]):
        exact = (_resize_weights(H, Hl).T @ img.astype(np.float64)
                 @ _resize_weights(W, Wl))
        err = np.abs(got.numpy().astype(np.float64) - exact).max()
        assert err <= 2e-6, ((Hl, Wl), err)
