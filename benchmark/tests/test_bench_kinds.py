"""Traffic kinds are files: a kind is found by its file name under
benchmark/kinds/, an unknown one stops the run naming the kinds there
are, a new kind runs through the harness with nothing but its own file
and a traffic that names it, and the "streams" kind gives each stream a
world of its own, the same on every call with one seed."""

import copy
import json

import numpy as np
import pytest

from benchmark import loads
from benchmark import run as harness
from benchmark.program import build_config
from benchmark.run import HERE, load_cell

# a kind that runs no program: two streams whose answers are the
# reference's own, on a small world
ECHO = '''
import numpy as np

from benchmark import loads
from benchmark import reference as R
from benchmark import scene


def worlds(cfg_file, cfg, traffic, seed, seconds):
    return [loads.Stream(scene.make_layout(12, 160, 96, 2, 160.0, 160.0,
                                           [seed, s]), list(range(4, 10)))
            for s in range(traffic["n_streams"])]


def run(cfg_file, cfg, traffic, seed, seconds, trace, device, t_start):
    r = loads.Run(attempted=12, e2e={"frames_per_s": 12.0})
    r.streams = worlds(cfg_file, cfg, traffic, seed, seconds)
    for st in r.streams:
        gt = R.truth(st.layout.T_wc, st.layout.L)
        F, K = st.layout.L.shape[:2]
        st.outputs = {"cam": gt["T_wc"], "cam_ba": gt["T_wc"], "obj": [
            (f, k, gt["L"][f, k] @ R._inv(gt["L"][f - 1, k]))
            for f in range(1, F) for k in range(K)]}
    return r
'''


def test_a_kind_is_found_by_its_file_name(tmp_path):
    (tmp_path / "echo.py").write_text(ECHO)
    kinds = loads.Kinds(tmp_path)
    assert kinds["echo"].__module__ == "benchmark_kind_echo"
    assert kinds["echo"] is kinds["echo"]          # loaded once
    with pytest.raises(SystemExit, match=r"'nope'.*\['echo'\]"):
        kinds["nope"]


def test_an_unknown_kind_names_the_kinds_there_are():
    with pytest.raises(SystemExit, match=r"\['drive', 'streams'\]"):
        loads.kind_module("no-such-kind")
    assert set(loads.kind_module("streams").__dict__) >= {"run", "worlds"}


def test_a_new_kind_needs_only_its_file_and_a_traffic(monkeypatch, tmp_path):
    """A traffic that names a kind the harness has never seen runs and is
    judged in every stream, with no edit to the harness."""
    (tmp_path / "echo.py").write_text(ECHO)
    cell = load_cell("kitti-drive")

    def echo_cell(name):
        c = copy.deepcopy(cell)
        c["traffic"] = {"kind": "echo", "n_streams": 2}
        return c

    monkeypatch.setattr(loads, "KINDS", loads.Kinds(tmp_path))
    monkeypatch.setattr(harness, "load_cell", echo_cell)
    result, lines = harness.run_cell("kitti-drive", 5, 1, False, "cpu")
    assert result["correct"], lines
    assert result["metrics"]["frames_per_s"]["value"] == 12.0
    assert result["checks"]["frames_missing"]["value"] == 0.0


def test_streams_get_worlds_of_their_own_from_one_seed():
    conf = load_cell("kitti-drive")["config"]
    traffic = json.loads((HERE / "traffic" / "streams6.json").read_text())
    kind = loads.kind_module(traffic["kind"])
    cfg = build_config(conf)

    def worlds(seed):
        return kind.worlds(conf, cfg, traffic, seed, 2)

    a, b = worlds(2**31 + 3), worlds(2**31 + 3)
    assert len(a) == traffic["n_streams"] == 6
    assert len({st.layout.L.tobytes() for st in a}) == 6
    assert len({st.layout.tex_phase.tobytes() for st in a}) == 6
    for x, y in zip(a, b):
        assert np.array_equal(x.layout.L, y.layout.L)
        assert np.array_equal(x.layout.tex_phase, y.layout.tex_phase)
        assert x.judged_frames == y.judged_frames
    other = worlds(2**31 + 4)
    assert not any(np.array_equal(x.layout.L, y.layout.L)
                   for x in a for y in other)
