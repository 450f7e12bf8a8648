"""The port's ORB ops and feature grid (vdo_slam_tpu_torch/ops/orb.py,
ops/grid.py) against the JAX package's, on seeded numpy inputs, plus the
JAX package's own TestGrid and TestORB (tests/test_frontend.py:255-269,
320-347) run on the port.

Tolerances: orientations within 1e-5 rad where the centroid moment |m| is
strong, and within 2e-3 / |m| everywhere (the two packages sum the 31x31
moments in another order; test_orientations_match_jax says why);
descriptors bit-equal, except a test whose rotated offset lands within
1e-5 px of a pixel edge, where a truncation may take the neighbouring
pixel in one package (the angle is given to both, so only the rotation's
rounding differs); match_hamming, the grid table and counts, and
features_in_area exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdo_slam_tpu.ops import grid as jgrid
from vdo_slam_tpu.ops import orb as jorb
from vdo_slam_tpu_torch.ops import grid, orb


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs in several worker processes at once, and each worker's idle
    OpenMP threads spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the JAX package's TestGrid and TestORB, on the port
# ---------------------------------------------------------------------------

class TestGrid:
    def test_assign_and_query(self):
        xy = torch.tensor([[10.0, 10.0], [12.0, 11.0], [600.0, 300.0],
                           [0.0, 0.0]])
        valid = torch.tensor([True, True, True, False])
        table, counts = grid.assign_to_grid(xy, valid, width=640, height=480,
                                            cap=4)
        assert int(counts.sum()) == 3
        idx, ok = grid.features_in_area(xy, valid, torch.tensor([11.0, 10.0]),
                                        radius=5.0, k=4)
        found = set(idx[ok].tolist())
        assert found == {0, 1}


class TestORB:
    def test_orientation_gradient_direction(self):
        # intensity ramp along +x -> centroid to the right -> angle ~ 0
        img = torch.linspace(0, 1, 64)[None, :].repeat(64, 1)
        ang = orb.orientations(img, torch.tensor([[32.0, 32.0]]))
        assert abs(float(ang[0])) < 0.1
        # ramp along +y -> angle ~ pi/2
        ang2 = orb.orientations(img.T.contiguous(),
                                torch.tensor([[32.0, 32.0]]))
        assert abs(float(ang2[0]) - np.pi / 2) < 0.1

    def test_descriptor_selfmatch_under_translation(self):
        rng = np.random.default_rng(0)
        img = torch.from_numpy(rng.random((128, 128)).astype(np.float32))
        pts_a = torch.from_numpy(
            rng.uniform(30, 98, size=(20, 2)).astype(np.float32))
        da = orb.descriptors(img, pts_a)
        # same image shifted by whole pixels: descriptors at shifted
        # points match
        shift = torch.tensor([3.0, 2.0])
        img_b = torch.roll(img, shifts=(2, 3), dims=(0, 1))
        db = orb.descriptors(img_b, pts_a + shift[None])
        valid = torch.ones(20, dtype=torch.bool)
        best, dist = orb.match_hamming(da, db, valid, valid)
        # most keypoints match themselves with small Hamming distance
        self_match = (best.numpy() == np.arange(20)).mean()
        assert self_match > 0.8, (self_match, dist.numpy())


# ---------------------------------------------------------------------------
# parity with the JAX functions
# ---------------------------------------------------------------------------

def _image_and_points(seed, n=200, h=96, w=128):
    """A smooth seeded image (noise blurred by a box) and keypoints inside
    and across its borders, at fractional positions."""
    rng = np.random.default_rng(seed)
    img = rng.random((h, w)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    img = np.apply_along_axis(np.convolve, 0, img, k, "same")
    img = np.apply_along_axis(np.convolve, 1, img, k, "same")
    xy = np.stack([rng.uniform(-4, w + 4, n), rng.uniform(-4, h + 4, n)],
                  -1).astype(np.float32)
    xy[:20] = np.round(xy[:20])          # some on whole pixels
    return img.astype(np.float32), xy


def test_constants_equal_jax():
    np.testing.assert_array_equal(orb._UMAX, jorb._UMAX)
    np.testing.assert_array_equal(orb._MASK, np.asarray(jorb._MASK))
    np.testing.assert_array_equal(orb._DX, jorb._DX)
    np.testing.assert_array_equal(orb._DY, jorb._DY)
    np.testing.assert_array_equal(orb._PATTERN, np.asarray(jorb._PATTERN))


def moment_norm(img, xy) -> np.ndarray:
    """|(m10, m01)| per keypoint, in float64: the length of the centroid
    vector whose angle orientations() returns."""
    p = orb._gather_patches(_t(img).double(), _t(xy)).numpy() * orb._MASK
    return np.hypot((p * orb._DX).sum((1, 2)), (p * orb._DY).sum((1, 2)))


@pytest.mark.parametrize("seed", [0, 1])
def test_orientations_match_jax(seed):
    """Each package sums the 961 masked moment terms (each at most 15 in
    magnitude) in float32 in its own order: ~961 * 15 * 2^-24 = 8.6e-4 of
    rounding each, so the angles differ by up to ~2e-3 / |m|.  Held: the
    angle gap times |m| within 2e-3 everywhere (1.24e-3 measured), and
    the gap within 1e-5 rad wherever |m| >= 200, about the median here."""
    img, xy = _image_and_points(seed)
    ref = np.asarray(jorb.orientations(jnp.asarray(img), jnp.asarray(xy)))
    got = orb.orientations(_t(img), _t(xy))
    assert got.dtype == torch.float32 and got.shape == (len(xy),)
    gap = np.abs(np.angle(np.exp(1j * (got.numpy().astype(np.float64)
                                       - ref))))
    m = moment_norm(img, xy)
    assert (gap * m).max() <= 2e-3
    strong = m >= 200.0
    assert strong.sum() >= 20
    assert gap[strong].max() <= 1e-5


def _edge_tests(xy, angle):
    """(N, 256) True where a test's rotated offset (either point, either
    axis) lands within 1e-5 px of a pixel edge, in float64."""
    p = np.asarray(orb._PATTERN, np.float64)
    ca, sa = np.cos(angle)[:, None], np.sin(angle)[:, None]
    near = np.zeros((len(xy), len(p)), bool)
    for px, py in ((p[:, 0], p[:, 1]), (p[:, 2], p[:, 3])):
        for v in (xy[:, 0:1] + ca * px - sa * py,
                  xy[:, 1:2] + sa * px + ca * py):
            near |= np.abs(v - np.round(v)) < 1e-5
    return near


@pytest.mark.parametrize("seed", [0, 1])
def test_descriptors_match_jax(seed):
    img, xy = _image_and_points(seed)
    angle = np.asarray(jorb.orientations(jnp.asarray(img), jnp.asarray(xy)))
    ref = np.asarray(jorb.descriptors(jnp.asarray(img), jnp.asarray(xy),
                                      jnp.asarray(angle)))
    got = orb.descriptors(_t(img), _t(xy), _t(angle))
    assert got.dtype == torch.uint8 and got.shape == (len(xy), 32)
    bits_ref = np.unpackbits(ref, axis=1, bitorder="little")
    bits = np.unpackbits(got.numpy(), axis=1, bitorder="little")
    near = _edge_tests(xy.astype(np.float64), angle.astype(np.float64))
    np.testing.assert_array_equal(bits[~near], bits_ref[~near])
    # without an angle each package finds its own: the same bits but for
    # a handful where the two orientations round apart
    own = orb.descriptors(_t(img), _t(xy))
    ref_own = np.asarray(jorb.descriptors(jnp.asarray(img), jnp.asarray(xy)))
    agree = (np.unpackbits(own.numpy(), axis=1)
             == np.unpackbits(ref_own, axis=1)).mean()
    assert agree >= 0.99


def test_match_hamming_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (50, 32), dtype=np.uint8)
    b[::7] = a[:8]                       # exact matches, and ties
    b[20] = b[13]
    va = rng.random(40) > 0.2
    vb = rng.random(50) > 0.3
    for vb_ in (vb, np.zeros(50, bool)):
        jb, jd = jorb.match_hamming(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(va), jnp.asarray(vb_))
        pb, pd = orb.match_hamming(_t(a), _t(b), _t(va), _t(vb_))
        assert pb.dtype == pd.dtype == torch.int32
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


@pytest.mark.parametrize("cap", [1, 4, 16])
def test_assign_to_grid_matches_jax(cap):
    rng = np.random.default_rng(cap)
    n, w, h = 3000, 320, 240
    xy = np.stack([rng.uniform(-5, w + 5, n), rng.uniform(-5, h + 5, n)],
                  -1).astype(np.float32)
    xy[:500] = xy[500:1000]              # crowded cells, past the cap
    xy[:50] = [[w * (i % 64) / 64, h * (i // 64) / 48] for i in range(50)]
    valid = rng.random(n) > 0.25
    jt, jc = jgrid.assign_to_grid(jnp.asarray(xy), jnp.asarray(valid),
                                  width=w, height=h, cap=cap)
    pt, pc = grid.assign_to_grid(_t(xy), _t(valid), width=w, height=h,
                                 cap=cap)
    assert pt.dtype == pc.dtype == torch.int32
    assert pt.shape == (grid.GRID_ROWS, grid.GRID_COLS, cap)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    # crowded cells hold more than the smallest caps
    assert int(pc.sum()) == int(valid.sum()) and int(pc.max()) > 4


@pytest.mark.parametrize("k", [8, 64, 5000])
def test_features_in_area_matches_jax(k):
    rng = np.random.default_rng(k)
    xy = rng.uniform(0, 100, (1000, 2)).astype(np.float32)
    xy[100:140] = xy[:40]                # equal distances: index order
    valid = rng.random(1000) > 0.2
    for c, r in (((50.0, 50.0), 8.0), ((3.0, 97.0), 20.0), ((-50, 0), 1.0)):
        center = np.asarray(c, np.float32)
        ji, jok = jgrid.features_in_area(jnp.asarray(xy), jnp.asarray(valid),
                                         jnp.asarray(center), r, k=k)
        pi, pok = grid.features_in_area(_t(xy), _t(valid), _t(center), r,
                                        k=k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
