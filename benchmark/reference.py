"""The plain reference and the comparison that decides `correct`.

The scene is a closed-form world (benchmark/scene.py), so the exact answer
to every question the program answers per frame is known: the camera's
motion from frame to frame, and each object's motion in its own body
frame, both from the layout's float64 poses.  The reference is that
geometry; it imports nothing of the program and reads the program's
outputs only to judge them.

What is judged, on every frame of the measured window:
- cam_t_max (m), cam_r_max (deg): the widest gap between the tracked
  frame-to-frame camera motion and the true one, the error of the
  reference's GetMetricError (Tracking.cc:3243-3386) per frame;
- ba_cam_t_max, ba_cam_r_max: the same over the poses after the window
  solves' write-back;
- obj_t_p99 (m): the 99th percentile over the object motion estimates of
  the translation gap between an estimate, taken into the object's body
  frame at its true previous pose, and the true body-frame motion;
- obj_corner_p99 (m): the 99th percentile over the same estimates of the
  widest gap, over the object's four corners, between where the estimated
  motion carries a corner and where the corner truly goes.  A wrong
  rotation about the object's centre leaves the translation gap as it is
  and moves the corners: this is the number that judges the objects'
  rotation.  The rotation gap itself is not compared: the control reads
  it no higher than sound runs do, since a motion taken from two poses
  both rounded alike keeps its rotation.
  Neither is the widest gap: an object that shows the camera a sliver past
  a nearer one gives an estimate metres and tens of degrees off now and
  then on a sound run (PERF.md, the look), so the widest gap reads no
  lower than the control; the 99th percentile still moves when more than
  one estimate in a hundred goes wrong.  A run with no object estimate reads
  inf;
- frames_missing: frames offered that have no pose.

A run of several streams judges each against its own world (`worst`):
frames_missing is the sum over the streams, every other number the worst
stream's.  Not the 99th percentile of all streams' estimates pooled: a
fault in one stream of six, one object broken on one frame in 20, is 1.7
% of that stream's estimates and 0.28 % of the pool, under its tail.

A cell compares the numbers its limits file (benchmark/limits/<cell>.json)
names: one whose control reads less than 3x its sound runs has no upper
reading and is left out there (PERF.md §2 gives the readings).

`control` is the reference in the program's place, computed in bfloat16,
the precision below the float32 that the configuration states: the poses
held in bfloat16.  (Each frame-to-frame motion rounded to bfloat16 alone
reads as close to the truth as the program does, 1e-3 deg and 1e-4 m on
a short drive: the small angles and steps keep their relative precision.)
"""

from __future__ import annotations

import numpy as np

def _inv(T: np.ndarray) -> np.ndarray:
    R = np.swapaxes(T[..., :3, :3], -1, -2)
    out = np.zeros(T.shape, np.float64)
    out[..., :3, :3] = R
    out[..., :3, 3] = -(R @ T[..., :3, 3, None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def _angle_deg(E: np.ndarray) -> np.ndarray:
    """Rotation angle of each 3x3 block, stable near 0."""
    R = E[..., :3, :3]
    w = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], -1)
    s = 0.5 * np.linalg.norm(w, axis=-1)
    c = 0.5 * (np.trace(R, axis1=-2, axis2=-1) - 1.0)
    return np.degrees(np.arctan2(s, c))


def truth(T_wc: np.ndarray, L: np.ndarray) -> dict:
    """The reference's answers from the layout: camera poses and object
    poses in the world of the first frame's camera (the program's world),
    in float64."""
    W0 = _inv(T_wc[0])
    return {"T_wc": W0 @ T_wc, "L": W0[None, None] @ L}


def cam_errors(P: np.ndarray, G: np.ndarray) -> tuple:
    """(t (m), r (deg)) errors of (n, 2, 4, 4) pairs (previous, current)
    of camera->world poses P against the true pairs G
    (Tracking.cc:3256-3259)."""
    E = (P[:, 1] @ _inv(P[:, 0])) @ (G[:, 0] @ _inv(G[:, 1]))
    return np.linalg.norm(E[:, :3, 3], axis=-1), _angle_deg(E)


def corners(obj_patches: list) -> np.ndarray:
    """(K, 4, 4) homogeneous corners, one column each, of every object's
    plane in its own body frame, from the scene's (origin, eu, ev)."""
    out = []
    for o, eu, ev in obj_patches:
        pts = np.stack([o, o + eu, o + ev, o + eu + ev], -1)
        out.append(np.concatenate([pts, np.ones((1, 4))], 0))
    return np.asarray(out, np.float64)


def obj_errors(ests: list, L: np.ndarray, C: np.ndarray) -> tuple:
    """(t (m), r (deg), corner (m)) errors of object estimates [(frame f,
    object k, 4x4 world motion f-1 -> f)] against the true motion: the
    body-frame translation and rotation gaps, and the widest gap over the
    object's corners C (K, 4, 4) between where the estimate carries a
    corner and where it truly goes."""
    if not ests:
        return np.zeros(0), np.zeros(0), np.zeros(0)
    f = np.array([e[0] for e in ests])
    k = np.array([e[1] for e in ests])
    if k.min() < 0 or k.max() >= L.shape[1]:
        bad = np.full(1, np.inf)                   # a label no object has
        return bad, bad, bad
    Hm = np.stack([np.asarray(e[2], np.float64) for e in ests])
    Lp, Lc = L[f - 1, k], L[f, k]
    body = _inv(Lp) @ Hm @ Lp
    E = _inv(body) @ (_inv(Lp) @ Lc)
    gap = (Hm @ Lp - Lc) @ C[k]
    corner = np.linalg.norm(gap[:, :3, :], axis=1).max(-1)
    return np.linalg.norm(E[:, :3, 3], axis=-1), _angle_deg(E), corner


def judge(out: dict, T_wc: np.ndarray, L: np.ndarray, C: np.ndarray,
          frames) -> dict:
    """The numbers compared, over `frames` (indices into the drive, each
    judged with the frame before it); C are the objects' corners
    (`corners`).

    out: "cam" (F, 4, 4) tracked camera->world poses with NaN rows for
    frames without a pose, "cam_ba" the same after the window solves,
    "obj" [(frame, object index, 4x4 world motion)] in any order."""
    gt = truth(T_wc, L)
    frames = np.asarray(list(frames))
    frames = frames[frames >= 1]
    cam = np.asarray(out["cam"], np.float64)
    ba = np.asarray(out["cam_ba"], np.float64)
    have = np.isfinite(cam[:, 0, 0])
    missing = int(np.sum(~have[frames]))
    ok = frames[have[frames] & have[frames - 1]]
    res = {"frames_missing": float(missing)}
    for tag, P in (("", cam), ("ba_", ba)):
        pairs = np.stack([P[ok - 1], P[ok]], 1)
        gts = np.stack([gt["T_wc"][ok - 1], gt["T_wc"][ok]], 1)
        t, r = cam_errors(pairs, gts)
        res[f"{tag}cam_t_max"] = float(t.max()) if t.size else np.inf
        res[f"{tag}cam_r_max"] = float(r.max()) if r.size else np.inf
    fs = set(frames.tolist())
    ests = [e for e in out["obj"] if e[0] in fs]
    t, _, c = obj_errors(ests, gt["L"], C)
    res["obj_t_p99"] = float(np.percentile(t, 99)) if t.size else np.inf
    res["obj_corner_p99"] = (float(np.percentile(c, 99)) if c.size
                             else np.inf)
    return res


def worst(numbers: list) -> dict:
    """The numbers compared over several streams, from each stream's own
    (`judge`): frames_missing their sum, every other number the largest
    over the streams (NaN where a stream reads NaN)."""
    out = {k: float(np.max([n[k] for n in numbers])) for k in numbers[0]}
    out["frames_missing"] = float(sum(n["frames_missing"] for n in numbers))
    return out


def control(T_wc: np.ndarray, L: np.ndarray, C: np.ndarray,
            frames) -> dict:
    """The reference in the program's place in bfloat16, the precision
    below the float32 the configuration states: the camera's and each
    object's pose in the program's world held in bfloat16, as a tracker
    whose state is bfloat16 holds them, and each object's motion taken
    from two such poses and rounded to bfloat16."""
    import torch

    gt = truth(T_wc, L)

    def bf16(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            torch.bfloat16).double().numpy()

    cam = bf16(gt["T_wc"])
    Lb = bf16(gt["L"])
    Hm = bf16(Lb[1:] @ _inv(Lb[:-1]))             # (F-1, K, 4, 4)
    F, K = L.shape[:2]
    ests = [(f, k, Hm[f - 1, k]) for f in range(1, F) for k in range(K)]
    return judge({"cam": cam, "cam_ba": cam, "obj": ests}, T_wc, L, C,
                 frames)


def describe(out: dict, T_wc: np.ndarray, L: np.ndarray, C: np.ndarray,
             frames) -> list:
    """Lines on how the errors spread, for the log: quantiles of the
    camera's and the objects' per-frame errors and the worst object
    estimates with how far ahead of the camera the object was."""
    gt = truth(T_wc, L)
    frames = np.asarray([f for f in frames if f >= 1])
    cam = np.asarray(out["cam"], np.float64)
    ok = frames[np.isfinite(cam[frames, 0, 0])
                & np.isfinite(cam[frames - 1, 0, 0])]
    t, r = cam_errors(np.stack([cam[ok - 1], cam[ok]], 1),
                      np.stack([gt["T_wc"][ok - 1], gt["T_wc"][ok]], 1))
    q = (50, 90, 99, 100)
    lines = [f"camera errors over {t.size} frames: t (m) at "
             f"{q} % {np.percentile(t, q).tolist()}, r (deg) "
             f"{np.percentile(r, q).tolist()}" if t.size else
             "camera errors: none"]
    fs = set(frames.tolist())
    ests = [e for e in out["obj"] if e[0] in fs]
    t, r, c = obj_errors(ests, gt["L"], C)
    if t.size and np.isfinite(t).all():
        lines.append(f"object errors over {t.size} estimates: t (m) at "
                     f"{q} % {np.percentile(t, q).tolist()}, r (deg) "
                     f"{np.percentile(r, q).tolist()}, corner (m) "
                     f"{np.percentile(c, q).tolist()}")
        ahead = (_inv(gt["T_wc"])[:, None] @ gt["L"])[..., 2, 3]
        for i in np.argsort(-c)[:5]:
            f, k = ests[i][0], ests[i][1]
            lines.append(f"  object {k} at frame {f}, {ahead[f, k]:.2f} m "
                         f"ahead: t {t[i]:.6f} m, r {r[i]:.6f} deg, "
                         f"corner {c[i]:.6f} m")
    return lines


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, lines): each number that the cell's limits name, beside
    its limit; correct when every one is finite and at most its limit."""
    ok, lines = True, []
    for k in limits:
        v, lim = numbers[k], limits[k]
        good = bool(np.isfinite(v) and v <= lim)
        ok &= good
        lines.append(f"{k} {v!r} limit {lim!r} {'ok' if good else 'FAIL'}")
    return ok, lines
