"""The port's image, selection and front-end ops against the JAX package's
on the same numpy inputs (a seeded rng and a small synthetic frame).

Selections (indices, masks, candidate banks) must be identical.  Values
that are one fp32 op chain on both sides are compared with atol=0; the
scene-flow unprojections with 1e-5 relative.  The object candidates'
random priority is drawn with jax.random exactly where frontend.py:85 draws
it and fed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdo_slam_tpu.ops import frontend as jfe
from vdo_slam_tpu.ops import image as jimg
from vdo_slam_tpu.ops import select as jsel
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.io.synthetic import make_scene
from vdo_slam_tpu_torch.ops import frontend, image, select


def _t(x):
    return torch.from_numpy(np.array(x))


def same(port, ref):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


@pytest.fixture(scope="module")
def frames():
    scene = make_scene(num_frames=3, width=160, height=120, num_objects=2,
                       seed=3)
    ds = SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)
    out = []
    for i in range(2):
        fd = ds[i]
        depth = np.asarray(jimg.preprocess_depth(jnp.asarray(fd.depth_raw),
                                                 2, 40.0, 1.0))
        out.append({"gray": fd.rgb, "depth": depth, "flow": fd.flow,
                    "seg": fd.mask})
    return out


class TestSelect:
    def test_masked_top_k_ties_lowest_index(self):
        score = np.asarray([1, 3, 3, 2, 3, 0, 3], np.float32)
        valid = np.ones(7, bool)
        idx, ok = select.masked_top_k(_t(score), _t(valid), 3)
        same(idx, [1, 2, 4])
        jidx, jok = jsel.masked_top_k(jnp.asarray(score), jnp.asarray(valid), 3)
        same(idx, jidx)
        same(ok, jok)

    @pytest.mark.parametrize("k", [5, 40, 64])  # k < n, k = n... k > n pads
    def test_masked_top_k_random(self, k):
        rng = np.random.default_rng(k)
        score = rng.integers(0, 6, 40).astype(np.float32)
        valid = rng.random(40) > 0.3
        idx, ok = select.masked_top_k(_t(score), _t(valid), k)
        jidx, jok = jsel.masked_top_k(jnp.asarray(score), jnp.asarray(valid), k)
        same(idx, jidx)
        same(ok, jok)

    def test_compact(self):
        valid = np.random.default_rng(1).random(50) > 0.5
        perm, n = select.compact(_t(valid))
        jperm, jn = jsel.compact(jnp.asarray(valid))
        same(perm, jperm)
        assert int(n) == int(jn)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_quota_select_duplicate_priorities(self, seed):
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, 4, 200).astype(np.int32)
        valid = rng.random(200) > 0.2
        pri = rng.integers(0, 5, 200).astype(np.float32)  # many ties
        pri[:10] = -np.inf
        idx, ok = select.quota_select(_t(labels), _t(valid), _t(pri), 17, 48)
        jidx, jok = jsel.quota_select(jnp.asarray(labels), jnp.asarray(valid),
                                      jnp.asarray(pri), 17, 48)
        same(idx, jidx)
        same(ok, jok)

    def test_gather_rows_and_min_dist(self):
        rng = np.random.default_rng(3)
        arr = rng.normal(size=(30, 2)).astype(np.float32)
        idx = rng.integers(0, 30, 12)
        valid = rng.random(12) > 0.4
        same(select.gather_rows(_t(arr), _t(idx), _t(valid), fill=-1),
             jsel.gather_rows(jnp.asarray(arr), jnp.asarray(idx),
                              jnp.asarray(valid), fill=-1))
        ref = rng.normal(size=(20, 2)).astype(np.float32) * 3
        rv = rng.random(20) > 0.5
        port = select.min_dist_to_set(_t(arr), _t(ref), _t(rv)).numpy()
        jax_out = np.asarray(jsel.min_dist_to_set(
            jnp.asarray(arr), jnp.asarray(ref), jnp.asarray(rv)))
        # The same formula on both sides, but XLA may round its fused sum of
        # squares once differently (1 ulp on some hosts), so both are held
        # to a float64 evaluation, and to each other, within 2 fp32 ulp.
        d2 = ((arr[:, None, :].astype(np.float64) - ref[None]) ** 2).sum(-1)
        want = np.sqrt(np.where(rv[None], d2, np.inf).min(-1))
        ulp2 = 2 * np.finfo(np.float32).eps       # 2.4e-7
        np.testing.assert_allclose(port, want, rtol=ulp2, atol=0)
        np.testing.assert_allclose(jax_out, want, rtol=ulp2, atol=0)
        np.testing.assert_allclose(port, jax_out, rtol=ulp2, atol=0)


class TestImage:
    @pytest.mark.parametrize("dataset", [1, 2, 3, 9])
    def test_preprocess_depth(self, dataset):
        raw = np.random.default_rng(4).uniform(-5, 300, (30, 40)).astype(
            np.float32)
        raw[0, :5] = 0.0
        same(image.preprocess_depth(_t(raw), dataset, 387.5744, 256.0),
             jimg.preprocess_depth(jnp.asarray(raw), dataset, 387.5744, 256.0))

    def test_gather_int_and_gray(self):
        rng = np.random.default_rng(5)
        img = rng.normal(size=(30, 40, 2)).astype(np.float32)
        uv = rng.uniform(-5, 45, (100, 2)).astype(np.float32)
        same(image.gather_int(_t(img), _t(uv)),
             jimg.gather_int(jnp.asarray(img), jnp.asarray(uv)))
        same(image.gather_int(_t(img[..., 0]), _t(uv), fill=-3.0),
             jimg.gather_int(jnp.asarray(img[..., 0]), jnp.asarray(uv),
                             fill=-3.0))
        rgb = rng.random((8, 9, 3)).astype(np.float32)
        np.testing.assert_allclose(
            image.rgb_to_gray(_t(rgb)),
            jimg.rgb_to_gray(jnp.asarray(rgb)), rtol=1e-6)


    @pytest.mark.parametrize("channels", [0, 2])
    def test_gather_bilinear(self, channels):
        rng = np.random.default_rng(22)
        shape = (30, 40) + ((channels,) if channels else ())
        img = rng.normal(size=shape).astype(np.float32)
        uv = rng.uniform(-3, 43, (200, 2)).astype(np.float32)
        uv[:4] = [[0, 0], [39, 29], [39.5, 29.5], [-0.5, 10]]
        np.testing.assert_allclose(
            image.gather_bilinear(_t(img), _t(uv), fill=-1.0),
            jimg.gather_bilinear(jnp.asarray(img), jnp.asarray(uv),
                                 fill=-1.0), rtol=0, atol=1e-6)

    @pytest.mark.parametrize("seed", [23, 24])
    def test_per_label_rank(self, seed):
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, 5, 300).astype(np.int32)
        valid = rng.random(300) > 0.25
        same(select.per_label_rank(_t(labels), _t(valid)),
             jsel.per_label_rank(jnp.asarray(labels), jnp.asarray(valid)))


class TestFrontend:
    def test_static_candidates(self, frames):
        f = frames[0]
        rng = np.random.default_rng(6)
        xy = rng.uniform(0, 160, (300, 2)).astype(np.float32)
        xy[:, 1] *= 0.75
        v = rng.random(300) > 0.1
        score = rng.integers(1, 9, 300).astype(np.float32)
        args = (f["depth"], f["flow"], f["seg"])
        port = frontend.static_candidates(_t(xy), _t(v), _t(score),
                                          *map(_t, args), 40.0, 120)
        ref = jfe.static_candidates(jnp.asarray(xy), jnp.asarray(v),
                                    jnp.asarray(score),
                                    *map(jnp.asarray, args), 40.0, 120)
        for k in ref:
            same(port[k], ref[k])

    def test_object_candidates_with_jax_priority(self, frames):
        f = frames[0]
        key = jax.random.PRNGKey(11)
        args = (f["depth"], f["flow"], f["seg"])
        ref = jfe.object_candidates(*map(jnp.asarray, args), 25.0, 4, 300,
                                    100, key)
        H, W = f["depth"].shape
        n = frontend.object_grid_size(H, W, 4)
        pri = np.asarray(jax.random.uniform(key, (n,)))   # frontend.py:85
        port = frontend.object_candidates(*map(_t, args), 25.0, 4, 300, 100,
                                          _t(pri))
        assert bool(np.asarray(ref["valid"]).any())
        for k in ref:
            same(port[k], ref[k])

    def test_inherit_and_scene_flow(self, frames):
        f0, f1 = frames
        rng = np.random.default_rng(7)
        corres = rng.uniform(-3, 165, (200, 2)).astype(np.float32)
        valid = rng.random(200) > 0.2
        same_keys = frontend.inherit_static(_t(corres), _t(valid),
                                            _t(f1["depth"]))
        ref = jfe.inherit_static(jnp.asarray(corres), jnp.asarray(valid),
                                 jnp.asarray(f1["depth"]))
        for k in ref:
            same(same_keys[k], ref[k])
        port = frontend.inherit_objects(_t(corres), _t(valid),
                                        _t(f1["depth"]), _t(f1["seg"]), 25.0)
        ref = jfe.inherit_objects(jnp.asarray(corres), jnp.asarray(valid),
                                  jnp.asarray(f1["depth"]),
                                  jnp.asarray(f1["seg"]), 25.0)
        for k in ref:
            same(port[k], ref[k])
        K = np.asarray([160.0, 160.0, 80.0, 60.0], np.float32)
        T0 = np.eye(4, dtype=np.float32)
        T1 = np.eye(4, dtype=np.float32)
        T1[:3, 3] = [0.1, 0.0, -0.25]
        d = rng.uniform(3, 20, 200).astype(np.float32)
        sf, xp = frontend.scene_flow_world(_t(corres), _t(d), _t(T0),
                                           _t(corres + 1), _t(d * 1.01),
                                           _t(T1), _t(K))
        jsf, jxp = jfe.scene_flow_world(
            jnp.asarray(corres), jnp.asarray(d), jnp.asarray(T0),
            jnp.asarray(corres + 1), jnp.asarray(d * 1.01), jnp.asarray(T1),
            jnp.asarray(K))
        np.testing.assert_allclose(sf, jsf, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(xp, jxp, rtol=1e-5, atol=1e-5)

    def test_label_slots_and_stats(self):
        rng = np.random.default_rng(8)
        sem = rng.integers(0, 6, 300).astype(np.int32)
        table = np.asarray([3, 1, 0, 5, 3], np.int32)
        slots = frontend.label_slots(_t(sem), _t(table))
        jslots = jfe.label_slots(jnp.asarray(sem), jnp.asarray(table))
        same(slots, jslots)
        valid = rng.random(300) > 0.3
        xy = rng.uniform(0, 160, (300, 2)).astype(np.float32)
        depth = rng.uniform(1, 30, 300).astype(np.float32)
        sf = rng.normal(scale=0.2, size=(300, 3)).astype(np.float32)
        args = (valid, xy, depth, sf)
        port = frontend.per_label_stats(slots, *map(_t, args), 160, 120, 5,
                                        0.12, 8, 12)
        ref = jfe.per_label_stats(jslots, *map(jnp.asarray, args), 160, 120,
                                  5, 0.12, 8, 12)
        for k in ref:  # counts exact; the depth sum up to summation order
            np.testing.assert_allclose(port[k], ref[k], rtol=1e-6)

    @pytest.mark.parametrize("drop", [False, True])
    def test_propagate_mask(self, frames, drop):
        """With `drop`, label 1 vanishes from the current mask and the
        repair branch runs; without, the vote keeps the mask as is."""
        f0, f1 = frames
        key = jax.random.PRNGKey(0)
        oc = jfe.object_candidates(jnp.asarray(f0["depth"]),
                                   jnp.asarray(f0["flow"]),
                                   jnp.asarray(f0["seg"]), 25.0, 2, 800, 400,
                                   key)
        seg_cur = np.where(f1["seg"] == 1, 0, f1["seg"]) if drop else f1["seg"]
        seg_cur = seg_cur.astype(np.int32)
        table = np.asarray([1, 2, 0, 0], np.int32)
        ref_seg, ref_lost = jfe.propagate_mask(
            jnp.asarray(seg_cur), jnp.asarray(f0["seg"]),
            jnp.asarray(f0["flow"]), oc["corres"], oc["sem_label"],
            oc["valid"], jnp.asarray(table), min_points=50)
        seg, lost = frontend.propagate_mask(
            _t(seg_cur), _t(f0["seg"]), _t(f0["flow"]),
            _t(oc["corres"]), _t(oc["sem_label"]), _t(oc["valid"]),
            _t(table), min_points=50)
        same(lost, ref_lost)
        assert bool(np.asarray(lost)[0]) == drop
        same(seg, ref_seg)
