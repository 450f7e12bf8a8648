"""The port's window build on a long synthetic archive, without a tracked
session: a seeded 200-frame MapState made in numpy (1,200 static features
a frame, ~90 % of them continuing from the frame before, ~3 % invalid,
tracklets alive across every window start).

  * Parity: the port's build_window_graph gives the JAX package's Graph,
    Variables and GraphMeta at atol=0, for window ends at the window
    length, one and two frames past it, and deep into the drive.
  * Bounded reads: the port's build gives the same arrays when every
    frame before `start - 1` is garbage (NaN positions, depths, points and
    poses, random validity and associations), and when each is None, which
    fails any read: it reads nothing there.
  * Counter: `meta.build_frames`, the archive frames the build read, is
    min(N, W + 1).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_backend import (GRAPH, VARS, _same_arrays, _same_meta,
                                      _same_stat_obs)
from tests.test_torch_slice import port_config
from vdo_slam_tpu import config as jconfig
from vdo_slam_tpu.backend import builders as jbuilders
from vdo_slam_tpu.pipeline import map_state as jmap_state
from vdo_slam_tpu_torch.backend import builders as pbuilders
from vdo_slam_tpu_torch.pipeline import map_state as pmap_state

F, K, W = 200, 1200, 20
ENDS = [W, W + 1, W + 2, 100, 200]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _archive(seed: int = 20260518) -> dict:
    """Per-frame static banks as the trackers archive them: stat_assoc and
    rigid_motion from frame 1 on."""
    rng = np.random.default_rng(seed)
    a = {k: [] for k in ("stat_xy", "stat_depth", "stat_3d", "stat_valid",
                         "stat_assoc", "cam_pose", "rigid_motion")}
    for f in range(F):
        a["stat_xy"].append(rng.uniform((0, 0), (1242, 375),
                                        (K, 2)).astype(np.float32))
        a["stat_depth"].append(rng.uniform(2, 40, K).astype(np.float32))
        a["stat_3d"].append(rng.normal(0, 10, (K, 3)).astype(np.float32))
        a["stat_valid"].append(rng.random(K) > 0.03)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] += rng.normal(0, 0.01, (3, 3)).astype(np.float32)
        pose[:3, 3] = (0, 0, f) + rng.normal(0, 0.1, 3)
        a["cam_pose"].append(pose)
        if f:
            cont = rng.random(K) < 0.9
            a["stat_assoc"].append(
                np.where(cont, rng.permutation(K), -1).astype(np.int32))
            motion = np.eye(4, dtype=np.float32)
            motion[:3, 3] = rng.normal(0, 1, 3)
            a["rigid_motion"].append([motion, np.eye(4, dtype=np.float32)])
    return a


def _garbled(a: dict, lo: int, kind: str, seed: int = 7) -> dict:
    """`a` with every frame before `lo` replaced by garbage ("nan"), or by
    None, which fails any read of the frame ("none")."""
    rng = np.random.default_rng(seed)
    g = {k: list(v) for k, v in a.items()}
    nan = np.float32(np.nan)
    for f in range(lo):
        frame = {"stat_xy": np.full((K, 2), nan),
                 "stat_depth": np.full(K, nan),
                 "stat_3d": np.full((K, 3), nan),
                 "stat_valid": rng.random(K) > 0.5,
                 "cam_pose": np.full((4, 4), nan)}
        if f:      # stat_assoc and rigid_motion hold frames 1 .. F - 1
            frame["stat_assoc"] = rng.integers(-1, K, K).astype(np.int32)
            frame["rigid_motion"] = [np.full((4, 4), nan)] * 2
        for k, v in frame.items():
            g[k][f - (k in ("stat_assoc", "rigid_motion"))] = (
                None if kind == "none" else v)
    return g


@pytest.fixture(scope="module")
def archive():
    jcfg = jconfig.VDOConfig()
    return _archive(), jcfg, port_config(jcfg)


def _lo(n_frames: int) -> int:
    return max(n_frames - W - 1, 0)


@pytest.mark.parametrize("n_frames", ENDS)
def test_window_build_matches_jax(archive, n_frames):
    a, jcfg, pcfg = archive
    gj, vj, mj = jbuilders.build_window_graph(jmap_state.MapState(**a), jcfg,
                                              window=W, n_frames=n_frames)
    gp, vp, mp = pbuilders.build_window_graph(pmap_state.MapState(**a), pcfg,
                                              window=W, n_frames=n_frames)
    _same_arrays(gp, gj, GRAPH)
    _same_arrays(vp, vj, VARS)
    _same_meta(mp, mj)
    _same_stat_obs(mp, mj)
    assert mp.frame_ids == list(range(n_frames - W, n_frames))
    assert mp.n_static_points > 1000


@pytest.mark.parametrize("kind", ["nan", "none"])
@pytest.mark.parametrize("n_frames", ENDS)
def test_window_build_reads_only_window_frames(archive, n_frames, kind):
    a, _, pcfg = archive
    gp, vp, mp = pbuilders.build_window_graph(pmap_state.MapState(**a), pcfg,
                                              window=W, n_frames=n_frames)
    g = _garbled(a, _lo(n_frames), kind)
    gg, vg, mg = pbuilders.build_window_graph(pmap_state.MapState(**g), pcfg,
                                              window=W, n_frames=n_frames)
    _same_arrays(gg, gp, GRAPH)
    _same_arrays(vg, vp, VARS)
    _same_meta(mg, mp)
    _same_stat_obs(mg, mp)
    assert not np.isnan(np.asarray(vg.points)).any()


@pytest.mark.parametrize("n_frames", ENDS)
def test_window_build_counts_frames_read(archive, n_frames):
    a, _, pcfg = archive
    _, _, mp = pbuilders.build_window_graph(pmap_state.MapState(**a), pcfg,
                                            window=W, n_frames=n_frames)
    assert mp.build_frames == min(n_frames, W + 1) == n_frames - _lo(n_frames)
