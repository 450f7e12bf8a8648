"""The full graph built by tensor ops (backend/builders.py:
build_full_graph_on) against the JAX package's numpy builder
(vdo_slam_tpu.backend.builders.build_full_graph), on the CPU, at atol=0,
dtypes and shapes included, on small archives made here:

  * "edge": one archive with every case the chaining and the filters
    must get right: a many-to-one association into a live track (two
    features of one frame continue one track), two new tracks anchored
    on one dead feature, invalid features, a frame with no features,
    tracks shorter than track_len_thres, a dynamic label above every
    rm_label, a non-first dynamic observation with no motion vertex, a
    track whose later features carry another label, a label twice in
    one frame pair and a negative one in two;
  * "random0".."random2": random associations over 30 frames;
  * "packed": random3's archive with its coordinates as the fused
    tracker archives them, strided column views of packed frame vectors
    (the build stages such rows by their bytes);
  * "no_dynamic": no dynamic feature slots; "two_frames": the shortest
    archive with an association;

each without caps (bucket shapes), with caps that hold and with an
observation cap that overflows.  The write-back's indices (stat_obs,
dyn_obs) and the rest of the GraphMeta are held equal too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_slice import port_config
from vdo_slam_tpu import config as jconfig
from vdo_slam_tpu.backend import builders as jbuilders
from vdo_slam_tpu.pipeline import map_state as jmap_state
from vdo_slam_tpu_torch.backend import builders as pbuilders
from vdo_slam_tpu_torch.pipeline import map_state as pmap_state
from vdo_slam_tpu_torch.pipeline.fused import unpack_host

GRAPH = [f.name for f in dataclasses.fields(jbuilders.Graph)]
VARS = ("poses", "motions", "points")
CAPS = {
    "buckets": {},
    "caps": dict(full_obs_cap=8192, full_ter_cap=4096, full_point_cap=8192,
                 full_motion_cap=128, full_smo_cap=128),
    "overflow": dict(full_obs_cap=16, full_ter_cap=4096,
                     full_point_cap=8192, full_motion_cap=128,
                     full_smo_cap=128),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _motion(rng):
    R, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = R
    M[:3, 3] = rng.standard_normal(3) * 3
    return M


def _archive(valid_s, assoc_s, valid_d, assoc_d, label_d, rm_label, seed):
    """A MapState of the given topology (valid (N, J), assoc (N - 1, J),
    the dynamic labels (N, Jd), rm_label per frame pair) with random
    coordinates, poses and motions."""
    rng = np.random.default_rng(seed)
    m = jmap_state.MapState()
    N = len(valid_s)
    for f in range(N):
        for kind, valid in (("stat", valid_s), ("dyn", valid_d)):
            J = len(valid[f])
            getattr(m, f"{kind}_xy").append(
                (rng.random((J, 2)) * [320, 240]).astype(np.float32))
            getattr(m, f"{kind}_depth").append(
                (rng.random(J) * 30 + 0.5).astype(np.float32))
            getattr(m, f"{kind}_3d").append(
                rng.standard_normal((J, 3)).astype(np.float32) * 10)
            getattr(m, f"{kind}_valid").append(np.asarray(valid[f], bool))
        m.dyn_obj_label.append(np.asarray(label_d[f], np.int32))
        m.dyn_sem_label.append(np.zeros(len(valid_d[f]), np.int32))
        m.cam_pose.append(_motion(rng))
        if f:
            m.stat_assoc.append(np.asarray(assoc_s[f - 1], np.int32))
            m.dyn_assoc.append(np.asarray(assoc_d[f - 1], np.int32))
            m.rigid_motion.append([_motion(rng) for _ in rm_label[f - 1]])
            m.rm_label.append(list(rm_label[f - 1]))
    return m


def _edge():
    N, Js, Jd = 9, 7, 8
    vs = np.ones((N, Js), bool)
    as_ = np.tile(np.arange(Js), (N - 1, 1))     # as_[g - 1]: frame g
    # many-to-one into a live track: frame 4's features 0 and 1 both
    # continue frame 3's feature 0; feature 1 goes on from there
    as_[3, 1] = 0
    # two new tracks anchored on one dead feature: frame 2's feature 3
    # has no association, frame 3's features 3 and 4 both start from it
    as_[1, 3] = -1
    as_[2, 4] = 3
    # invalid features: associated, but not valid
    vs[2, 2] = vs[5, 5] = False
    # a frame with no features: frame 6 none valid, nothing chains through
    vs[6] = False
    as_[5] = -1
    as_[6] = -1
    # tracks shorter than track_len_thres: feature 6 lives two frames
    as_[:, 6] = -1
    as_[4, 6] = 6
    vd = np.ones((N, Jd), bool)
    ad = np.tile(np.arange(Jd), (N - 1, 1))
    lab = np.tile(np.array([1, 2, 9, 0, 1, 1, 1, -1]), (N, 1))
    # feature 0 changes label mid-track: the track keeps its first
    lab[5:, 0] = 2
    # many-to-one into a live dynamic track
    ad[2, 5] = 4
    vd[6] = False
    ad[5] = -1
    vd[3, 7] = False
    # object 2 has no motion vertex from frame 3 to 4: feature 1's
    # observation at frame 4 is dropped and its chain breaks there;
    # label 9 has none anywhere; label 1 twice in frame pair 5; label -1
    # in frame pairs 6 and 7 (smoothness reads negative labels too)
    rm = [[0, 1, 2], [0, 1, 2], [0, 1, 2], [0, 1], [0, 2, 1], [0, 1, 1, 2],
          [0, -1, 1, 2], [0, 2, -1, 1]]
    return _archive(vs, as_, vd, ad, lab, rm, seed=5)


def _random(seed, N=30, Js=40, Jd=36, n_obj=4):
    rng = np.random.default_rng(seed)

    def topo(J):
        valid = rng.random((N, J)) < 0.9
        assoc = np.where(rng.random((N - 1, J)) < 0.85,
                         rng.integers(0, J, (N - 1, J)), -1)
        return valid, assoc

    vs, as_ = topo(Js)
    vd, ad = topo(Jd)
    lab = rng.integers(0, n_obj + 2, (N, Jd))
    rm = [[0] + sorted(rng.choice(np.arange(1, n_obj + 1),
                                  rng.integers(0, n_obj + 1),
                                  replace=False).tolist())
          for _ in range(N - 1)]
    return _archive(vs, as_, vd, ad, lab, rm, seed)


def _packed():
    """random3's archive as the fused tracker archives it
    (pipeline/fused.py:unpack_host): each frame's coordinates are strided
    column views into its packed output vector, four frames to a base,
    so that rows start at offsets that are not 8-byte aligned."""
    m = _random(3)
    B, D = len(m.stat_valid[0]), len(m.dyn_valid[0])
    L = B * 8 + D * 10 + 25 + 32 + 5
    for f in range(m.num_frames):
        if f % 4 == 0:
            base = np.zeros((4, L), np.float32)
        vec = base[f % 4]
        stat = vec[:B * 8].reshape(B, 8)
        dyn = vec[B * 8:B * 8 + D * 10].reshape(D, 10)
        for block, kind in ((stat, "stat"), (dyn, "dyn")):
            block[:, 0:2] = getattr(m, f"{kind}_xy")[f]
            block[:, 2] = getattr(m, f"{kind}_depth")[f]
            block[:, 3:6] = getattr(m, f"{kind}_3d")[f]
        host = unpack_host(vec, B, D, 1)
        for kind in ("stat", "dyn"):
            xy, depth, p3 = host[kind][:3]
            assert not xy.flags.c_contiguous and xy.base is base
            getattr(m, f"{kind}_xy")[f] = xy
            getattr(m, f"{kind}_depth")[f] = depth
            getattr(m, f"{kind}_3d")[f] = p3
    return m


def _no_dynamic():
    m = _random(7, N=12)
    for name in ("dyn_xy", "dyn_depth", "dyn_3d", "dyn_valid", "dyn_assoc",
                 "dyn_obj_label", "dyn_sem_label"):
        setattr(m, name, [x[:0] for x in getattr(m, name)])
    return m


def _two_frames():
    return _archive(np.ones((2, 5), bool), [[0, 1, -1, 3, 3]],
                    np.ones((2, 4), bool), [[0, -1, 2, 2]],
                    np.ones((2, 4), int), [[0, 1]], seed=2)


ARCHIVES = {"edge": _edge, "random0": lambda: _random(0),
            "random1": lambda: _random(1), "random2": lambda: _random(2),
            "packed": _packed, "no_dynamic": _no_dynamic,
            "two_frames": _two_frames}


def _port_map(jm):
    pm = pmap_state.MapState()
    for f in dataclasses.fields(jm):
        setattr(pm, f.name, getattr(jm, f.name))
    return pm


def test_edge_archive_has_its_cases():
    """The "edge" archive holds the cases its docstring names."""
    m = _edge()
    a4 = m.stat_assoc[3]
    assert a4[0] == a4[1] == 0 and m.stat_valid[3][0]        # many-to-one
    a3 = m.stat_assoc[2]
    assert a3[3] == a3[4] == 3 and m.stat_assoc[1][3] == -1  # dead anchor
    assert not m.stat_valid[6].any() and not m.dyn_valid[6].any()
    labels = {x for fp in m.rm_label for x in fp[1:]}
    assert 9 in set(np.concatenate(m.dyn_obj_label)) and max(labels) < 9
    assert 2 not in m.rm_label[3][1:] and -1 in labels
    _, _, meta = jbuilders.build_full_graph(m, jconfig.VDOConfig())
    d_frm, d_fea = meta.dyn_obs
    assert not np.any((d_frm == 4) & (d_fea == 1))    # dropped: no motion
    assert np.any((d_frm == 3) & (d_fea == 1))


@pytest.mark.parametrize("caps", list(CAPS))
@pytest.mark.parametrize("archive", list(ARCHIVES))
def test_full_build_equals_jax_builder(archive, caps):
    jm = ARCHIVES[archive]()
    jcfg = jconfig.VDOConfig()
    jcfg = jcfg.replace(backend=dataclasses.replace(jcfg.backend,
                                                    **CAPS[caps]))
    pcfg = port_config(jcfg)
    gj, vj, mj = jbuilders.build_full_graph(jm, jcfg)
    gp, vp, mp = pbuilders.build_full_graph(_port_map(jm), pcfg)
    for a, b, names in ((gp, gj, GRAPH), (vp, vj, VARS)):
        for n in names:
            x, y = np.asarray(getattr(a, n)), np.asarray(getattr(b, n))
            assert x.dtype == y.dtype and x.shape == y.shape, n
            np.testing.assert_array_equal(x, y, err_msg=n)
    for f in dataclasses.fields(mj):
        x, y = getattr(mp, f.name), getattr(mj, f.name)
        if isinstance(y, tuple):
            assert len(x) == len(y), f.name
            for u, w in zip(x, y):
                assert u.dtype == np.int64, f.name
                np.testing.assert_array_equal(u, w, err_msg=f.name)
        else:
            assert x == y, f.name
    assert mp.chain_rounds == pbuilders.chain_rounds(jm.num_frames)
    if archive == "edge":
        assert int(np.sum(gp.ter_w > 0)) > 0 and int(np.sum(gp.smo_w > 0))


@pytest.mark.parametrize("n_frames,rounds", [(1, 0), (2, 0), (3, 0), (4, 1),
                                             (6, 2), (10, 3), (1028, 11)])
def test_chain_rounds_cover_the_longest_chain(n_frames, rounds):
    """ceil(log2(n_frames - 2)): a track's first new feature is at frame
    1 or later, so the longest chain has n_frames - 2 links."""
    assert pbuilders.chain_rounds(n_frames) == rounds
    assert 2 ** rounds >= n_frames - 2
