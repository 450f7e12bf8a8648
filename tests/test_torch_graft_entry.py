"""vdo_slam_tpu_torch/graft_entry.py against the repository root's
__graft_entry__.py, on the CPU (conftest's 8 virtual CPU devices give the
JAX functions their mesh; the port runs its device lists as ["cpu"] * n).

* `_tiny_config` and `_medium_config` equal the JAX ones field by field;
  `_example_inputs` equal them exactly.
The step tests below replace the port's pyramid levels by
jax.image.resize's (`jax_levels`): the resize is the one stage whose float
rounding the packages do not share (up to 2.9e-5 apart, ROADMAP "Pyramid
resize"), and on the 96x64 frames, with ~90 static points and 32 RANSAC
samples, it alone moves a stream by up to 1.07e-2 m after one tracking
frame (measured on the CPU).  Each substituted level is first held
within 2.9e-5 of the port's own level of the same gray (2.4e-7 measured
at 96x64).  With it, the JAX and port steps detect the same keypoints and
are held tightly:

* entry()'s step, on a state carried over from the JAX state by
  `state_from_numpy` and with the JAX key's draws replayed (JaxDraws,
  PRNGKey(0)), against jax.jit of the JAX entry()'s step: equal static
  banks; then one tracking step more from each package's own state with
  PRNGKey(1): T_cw within 2e-5 m and 1e-4 deg (7.5e-7 m and 3.1e-6 deg
  measured on the CPU), the same camera inlier count and active slot
  labels, each active slot's H within 5e-3 m.
* Legs (a) and (b) over ["cpu"] * n against JAX's make_multistream_step
  over an n-device mesh (n = 2, 8), with the JAX dry run's keys: each
  stream's draws are the JAX key's (object and renewal priorities as
  drawn, RANSAC picks as the uniforms that floor to the JAX picks).  Every
  stream's T_cw within 2e-5 m / 1e-4 deg of the JAX stream's (4.3e-6 m,
  1.7e-5 deg measured), equal inlier counts, the fleet's mean t_rpe within
  1e-5 and mean r_rpe within 1e-4 (9.6e-7 and 6.5e-6 measured), equal
  object totals; leg (b) within the original's bounds (pose entries 1e-5,
  t_rpe 1e-6; 0 measured).
* dryrun_multichip(2, ["cpu"] * 2) whole: the three legs with the
  original's asserts (~10 s on the CPU with one thread), and leg (c)'s
  graph sizes and its costs before and after the solve within 1 % of the
  JAX run's in MULTICHIP_r05.json.
* Without a card, entry() and dryrun_multichip() raise (no CPU fallback);
  in a fresh process with jax blocked, the module imports and entry() runs
  on the CPU with no jax or vdo_slam_tpu module loaded.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from tests.test_torch_slice import JaxDraws, pose_gap
from vdo_slam_tpu_torch import graft_entry as P
from vdo_slam_tpu_torch.ops import fast
from vdo_slam_tpu_torch.parallel import make_stream_state, state_from_numpy
from vdo_slam_tpu_torch.pipeline.draws import uniform_shapes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_TOL_M, R_TOL_DEG, H_TOL_M = 2e-5, 1e-4, 5e-3
FLEET_T_TOL, FLEET_R_TOL = 1e-5, 1e-4
# the port's levels against jax.image.resize's: ROADMAP "Pyramid resize"
# puts jax.image.resize on the CPU 2.9e-5 off the float64 product of the
# weights, the port within 2e-6 (2.4e-7 apart at 96x64, measured)
RESIZE_TOL = 2.9e-5
# leg (c)'s costs against the JAX run's digits (MULTICHIP_r05.json): 0.18 %
# (cost0) and 0.31 % (cost) apart on the CPU over ["cpu"] * 2, 0.46 % and
# 0.13 % on an H100 over cuda:0 eight times
COST_DIGITS_REL_TOL = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs in several worker processes at once, and each worker's idle
    OpenMP threads spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["_tiny_config", "_medium_config"])
def test_configs_equal_field_by_field(name):
    port, ref = getattr(P, name)(), getattr(G, name)()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("seed", [0, 5])
def test_example_inputs_equal(seed):
    port = P._example_inputs(P._tiny_config(), seed=seed, device="cpu")
    ref = G._example_inputs(G._tiny_config(), seed=seed)
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        want = np.asarray(v)
        assert port[k].numpy().dtype == want.dtype, k
        np.testing.assert_array_equal(port[k].numpy(), want, err_msg=k)


@pytest.fixture
def jax_levels(monkeypatch):
    """The port's pyramid with jax.image.resize's levels, each first held
    within RESIZE_TOL of the port's own level of the same gray."""
    own = fast.pyramid

    def pyramid(gray, n_levels=8, scale_factor=1.2):
        H, W = gray.shape[-2:]
        flat = gray.numpy().reshape((-1, H, W))
        out = [gray.contiguous()]
        for Hl, Wl in fast.level_shapes(H, W, n_levels, scale_factor)[1:]:
            lv = np.stack([np.asarray(jax.image.resize(
                jnp.asarray(x), (Hl, Wl), method="bilinear")) for x in flat])
            out.append(torch.from_numpy(lv.reshape(gray.shape[:-2]
                                                   + (Hl, Wl))))
        for a, b in zip(own(gray, n_levels, scale_factor), out):
            gap = float((a - b).abs().max())
            assert gap <= RESIZE_TOL, (tuple(a.shape), gap)
        return out

    monkeypatch.setattr(fast, "pyramid", pyramid)


def _close(T, T_ref):
    t, r = pose_gap(T, T_ref)
    assert t < T_TOL_M and r < R_TOL_DEG, (t, r)


def _same_slots(metrics, jmetrics, state, jstate):
    act = metrics["slot_active"].numpy()
    jact = np.asarray(jmetrics["slot_active"])
    sem = metrics["slot_sem"].numpy()
    assert set(sem[act].tolist()) == set(
        np.asarray(jmetrics["slot_sem"])[jact].tolist())
    H = state.slot_H.numpy()
    jH = np.asarray(jstate["slot_H"])
    jsem = list(np.asarray(jmetrics["slot_sem"]))
    for k in np.flatnonzero(act):
        j = jsem.index(sem[k])
        assert np.linalg.norm(H[k][:3, 3] - jH[j][:3, 3]) < H_TOL_M


def test_entry_step_against_jax(jax_levels):
    K = P._tiny_config().shapes.max_objects
    jfn, (jstate, jinputs, jkey) = G.entry()
    jstep = jax.jit(jfn)
    fn, (state, inputs, draws, initialized) = P.entry(device="cpu")
    assert initialized is False and hasattr(draws, "u")
    carried, init = state_from_numpy(jax.device_get(jstate), "cpu")
    assert init is False
    for a, b in zip(dataclasses.astuple(carried.frame),
                    dataclasses.astuple(state.frame)):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
    jst, jm = jstep(jstate, jinputs, jkey)
    st, m = fn(carried, inputs, JaxDraws(jkey, False, K), False)
    jst, jm = jax.device_get((jst, jm))
    _close(st.frame.T_cw.numpy(), jst["frame"].T_cw)
    np.testing.assert_array_equal(st.frame.static.valid.numpy(),
                                  np.asarray(jst["frame"].static.valid))
    np.testing.assert_allclose(st.frame.static.xy.numpy(),
                               np.asarray(jst["frame"].static.xy), atol=1e-5)
    # one tracking step more, each package from its own state
    key1 = jax.random.PRNGKey(1)
    jst2, jm2 = jax.device_get(jstep(jst, jinputs, key1))
    st2, m2 = fn(st, inputs, JaxDraws(key1, True, K), True)
    _close(st2.frame.T_cw.numpy(), jst2["frame"].T_cw)
    assert int(m2["n_inlier"]) == int(jm2["n_inlier"])
    _same_slots(m2, jm2, st2, jst2)


class _Recording(JaxDraws):
    """JaxDraws that also keeps the uniforms which give the port's
    UniformDraws the same numbers: priorities as drawn, picks p of n as
    (p + 0.5) / n, which floor(u * n) maps back to p."""

    def _set(self, *args):
        super()._set(*args)
        self.u = {}

    def object_priority(self, n):
        self.u["object_priority"] = out = super().object_priority(n)
        return out

    def renew_priority(self, n):
        self.u["renew_priority"] = out = super().renew_priority(n)
        return out

    def camera_picks(self, n_samples, n_valid):
        out = super().camera_picks(n_samples, n_valid)
        self.u["camera_picks"] = ((out.double() + 0.5)
                                  / max(int(n_valid), 1)).float()
        return out

    def object_picks(self, n_samples, n_valid):
        out = super().object_picks(n_samples, n_valid)
        n = n_valid.clamp(min=1).double().reshape(-1, 1, 1)
        self.u["object_picks"] = ((out.double() + 0.5) / n).float()
        return out


def _jax_multistream(jcfg, n):
    """The JAX dry run's leg (a) over an n-device mesh
    (__graft_entry__.py:161-180): the states and metrics after two frames,
    the fleet, and each frame's per-stream keys."""
    from jax.sharding import Mesh

    from vdo_slam_tpu.parallel import make_multistream_step, make_stream_state

    mesh = Mesh(np.array(jax.devices()[:n]), ("stream",))
    pstep, shard_tree, _ = make_multistream_step(jcfg, mesh)
    states = shard_tree(jax.tree.map(
        lambda *xs: jnp.stack(xs), *[make_stream_state(jcfg)
                                     for _ in range(n)]))
    key, keys = jax.random.PRNGKey(0), []
    inputs = shard_tree(jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[G._example_inputs(jcfg, seed=s) for s in range(n)]))
    for i in range(2):
        key, *ks = jax.random.split(key, n + 1)
        keys.append(ks)
        states, metrics, fleet = pstep(states, inputs, jnp.stack(ks))
    return jax.device_get((states, metrics, fleet)), keys


@pytest.mark.parametrize("n", [2, 8])
def test_multistream_and_solo_legs_against_jax_mesh(n, jax_levels):
    cfg = P._tiny_config()
    K = cfg.shapes.max_objects
    (jstates, jmetrics, jfleet), keys = _jax_multistream(G._tiny_config(), n)
    # each stream's uniforms: its JAX keys replayed through the solo step
    step = P.entry(device="cpu")[0]
    blank = {k: torch.zeros(s) for k, s in uniform_shapes(cfg).items()}
    per_frame = [[None] * n for _ in keys]
    for s in range(n):
        inputs = P._example_inputs(cfg, seed=s, device="cpu")
        st = make_stream_state(cfg, "cpu")
        for i, ks in enumerate(keys):
            rec = _Recording(ks[s], i > 0, K)
            st, _ = step(st, inputs, rec, i > 0)
            per_frame[i][s] = dict(blank, **rec.u)
    ms = P._multistream_leg(cfg, ["cpu"] * n, uniforms=lambda i: P._stacked(
        per_frame[i]))
    for s in range(n):             # one stream per device
        _close(ms["states"][s].frame.T_cw[0].numpy(),
               np.asarray(jstates["frame"].T_cw)[s])
        assert int(ms["metrics"][s]["n_inlier"][0]) == int(
            np.asarray(jmetrics["n_inlier"])[s])
    assert ms["fleet"]["total_objects"] == float(jfleet["total_objects"])
    assert abs(ms["fleet"]["mean_t_rpe"]
               - float(jfleet["mean_t_rpe"])) < FLEET_T_TOL
    assert abs(ms["fleet"]["mean_r_rpe"]
               - float(jfleet["mean_r_rpe"])) < FLEET_R_TOL
    solo = P._solo_leg(cfg, "cpu", ms)
    assert solo["pose_gap"] < P.SOLO_POSE_TOL, solo
    assert solo["rpe_gap"] < P.SOLO_RPE_TOL, solo


def test_dryrun_on_two_cpu_devices(capsys):
    """The whole dry run over ["cpu"] * 2 with the original's asserts; leg
    (c)'s graph within 1 % of the JAX run's (MULTICHIP_r05.json)."""
    res = P.dryrun_multichip(2, devices=["cpu"] * 2)
    out = capsys.readouterr().out
    for line in ("dryrun_multichip tracking OK:",
                 "dryrun_multichip per-stream-equals-solo OK:",
                 "dryrun_multichip sharded full-BA (production builder) OK:"):
        assert line in out
    ba = res["full_ba"]
    assert res["devices"] == [torch.device("cpu")] * 2
    assert ba["cost"] <= ba["cost0"] and ba["pose_err"] < P.POSE_TOL
    with open(os.path.join(REPO, "MULTICHIP_r05.json")) as fh:
        tail = json.load(fh)["tail"]
    jax_nums = re.search(r"(\d+) points, (\d+) edges, (\d+) motion vertices, "
                         r"(\d+) dyn obs", tail).groups()
    for got, want in zip((ba["n_points"], ba["n_edges"], ba["n_motions"],
                          ba["n_dyn"]), jax_nums):
        assert abs(got - int(want)) <= 0.01 * int(want), (got, want)
    cost0, cost = map(float, re.search(r"OK: ([\d.]+) -> ([\d.]+)",
                                       tail).groups())
    for got, want in ((ba["cost0"], cost0), (ba["cost"], cost)):
        assert abs(got - want) <= COST_DIGITS_REL_TOL * want, (got, want)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the defaults run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.dryrun_multichip(2)
    with pytest.raises(ValueError, match="2 devices given"):
        P.dryrun_multichip(3, devices=["cpu"] * 2)


NO_JAX = r"""
import sys
if sys.argv[1] == "block":
    sys.modules["jax"] = None
    sys.modules["flax"] = None
import torch
from vdo_slam_tpu_torch import graft_entry
fn, args = graft_entry.entry(device="cpu")
state, metrics = fn(*args)
assert torch.isfinite(state.frame.T_cw).all()
bad = [m for m in sys.modules if sys.modules[m] is not None and (
    m in ("jax", "vdo_slam_tpu", "__graft_entry__") or m.startswith(
        ("jax.", "flax", "vdo_slam_tpu.")))]
assert not bad, bad
print("NO_JAX_OK")
"""


@pytest.mark.parametrize("block", ["block", "free"])
def test_graft_entry_without_jax(block):
    """In a fresh process the module imports and entry()'s step runs on the
    CPU with jax unimportable ("block"), and with jax importable but never
    imported ("free")."""
    out = subprocess.run([sys.executable, "-c", NO_JAX, block], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
