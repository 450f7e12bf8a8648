"""The comparison that decides `correct` in omd-swinging4 (kind "room"),
at the cell's own size, with the reference's own answers in the
program's place: they pass; the control (bfloat16 poses) fails; so does
each planted fault, one box turned 30 degrees on one frame in 20, and an
object motion model cut to a car's (each estimated rotation reduced to
its yaw about the world's vertical), which the driving cells cannot
see: their cars only yaw."""

import numpy as np
import pytest

from benchmark import loads
from benchmark import reference as R
from benchmark import scene as S
from benchmark.program import build_config
from benchmark.run import load_cell


def _window(cell, seed):
    c = load_cell(cell)
    kind = loads.kind_module(c["traffic"]["kind"])
    (st,) = kind.worlds(c["config"], build_config(c["config"]), c["traffic"],
                        seed, 20)
    return c, st.layout, st.judged_frames


def _exact(lay):
    gt = R.truth(lay.T_wc, lay.L)
    F, K = lay.L.shape[:2]
    Lw = gt["L"]
    return {"cam": gt["T_wc"].copy(), "cam_ba": gt["T_wc"].copy(),
            "obj": [(f, k, Lw[f, k] @ R._inv(Lw[f - 1, k]))
                    for f in range(1, F) for k in range(K)]}


def _judge(c, lay, frames, out):
    got = R.judge(out, lay.T_wc, lay.L, R.corners(lay.obj_patches), frames)
    return R.verdict(got, c["limits"])


def _yaw_only(H):
    """H with its rotation cut to the yaw about the world's y axis, its
    translation kept."""
    yaw = np.arctan2(H[0, 2], H[2, 2])
    out = H.copy()
    out[:3, :3] = S.pose([0.0, yaw, 0.0], [0.0, 0.0, 0.0])[:3, :3]
    return out


@pytest.mark.parametrize("seed", [2**31 + 11, 5])
def test_exact_answers_pass_and_the_control_fails(seed):
    c, lay, frames = _window("omd-swinging4", seed)
    ok, lines = _judge(c, lay, frames, _exact(lay))
    assert ok, lines
    got = R.control(lay.T_wc, lay.L, R.corners(lay.obj_patches), frames)
    ok, lines = R.verdict(got, c["limits"])
    assert not ok, lines


def test_one_box_turned_fails():
    c, lay, frames = _window("omd-swinging4", 2**31 + 12)
    out = _exact(lay)
    turn = S.pose([0.0, 0.0, np.radians(30.0)], [0.0, 0.0, 0.0])
    out["obj"] = [(f, k, H @ turn if k == 1 and f % 20 == 0 else H)
                  for f, k, H in out["obj"]]
    ok, lines = _judge(c, lay, frames, out)
    assert not ok, lines


def test_a_cars_motion_model_fails_here_and_passes_the_drive():
    c, lay, frames = _window("omd-swinging4", 2**31 + 13)
    out = _exact(lay)
    out["obj"] = [(f, k, _yaw_only(H)) for f, k, H in out["obj"]]
    ok, lines = _judge(c, lay, frames, out)
    assert not ok, lines
    c, lay, frames = _window("kitti-drive", 2**31 + 13)
    out = _exact(lay)
    out["obj"] = [(f, k, _yaw_only(H)) for f, k, H in out["obj"]]
    ok, lines = _judge(c, lay, frames, out)
    assert ok, lines
