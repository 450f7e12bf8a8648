"""The FAST detector: the port's plain `fast_score` against the JAX
package's `fast_score` and its Pallas kernel in interpret mode (as
tests/test_frontend.py runs it on the CPU), with atol=0; detect_level
identical at level 0; the whole pyramid overlapping by >= 99% (the
antialiased resizes differ by <= 2.9e-5, which can flip a compare).

The CUDA kernel itself runs only on a GPU: see test_torch_kernel_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdo_slam_tpu.ops import fast as jfast
from vdo_slam_tpu.ops.fast_pallas import fast_score_pair_pallas
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.ops import fast
from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL, fast_score_pair

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

    def test_cpu_path_does_not_count(self):
        before = KERNEL.launches
        fast_score_pair(torch.zeros(16, 16), TH_INI, TH_MIN)
        assert KERNEL.launches == before
