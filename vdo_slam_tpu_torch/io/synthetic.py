"""Copy of vdo_slam_tpu/io/synthetic.py without its unused jax import.

Same generator, same RNG stream: `make_scene` returns arrays identical to
the JAX package's for the same arguments.  The original docstring follows.

Synthetic RGB-D + flow + instance-mask scene generator with exact GT.

The reference has no test suite (SURVEY.md §4); its de-facto oracle is a
downloaded KITTI demo with GT in the loop.  This module replaces that with a
closed-form renderable world, giving every pipeline stage an analytic oracle:

  world  = a set of textured 3D planar patches:
             * background planes (ground + walls), static in world frame
             * object planes, each rigidly moved per frame by H_k in SE(3)
  camera = smooth SE(3) trajectory T_wc(k)

For every frame we ray-cast each pixel against all planes (closed form),
z-buffer for the winning patch, and derive depth / instance mask / forward
optical flow / GT camera pose / GT object poses exactly — the same input
tuple the reference's demo loader produces (example/vdo_slam.cc:98-141).

Everything is vectorized numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# numpy SE3 helpers (host-side generation keeps the device free)


def _rodrigues(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _pose(w, t) -> np.ndarray:
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = _rodrigues(np.asarray(w, dtype=np.float64))
    T[:3, 3] = t
    return T


def _inv(T: np.ndarray) -> np.ndarray:
    Ti = np.eye(4, dtype=T.dtype)
    Ti[:3, :3] = T[:3, :3].T
    Ti[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return Ti


@dataclasses.dataclass
class Patch:
    """A finite textured rectangle: origin o, edge vectors e_u, e_v (world).

    Points: X(a,b) = o + a*e_u + b*e_v for a,b in [0,1].  label 0 = background.
    """

    origin: np.ndarray
    eu: np.ndarray
    ev: np.ndarray
    label: int


@dataclasses.dataclass
class SyntheticScene:
    """Generated sequence with exact ground truth."""

    rgb: np.ndarray          # (F, H, W) float32 grayscale in [0,1]
    depth: np.ndarray        # (F, H, W) float32 metric depth (0 = invalid)
    flow: np.ndarray         # (F, H, W, 2) float32 forward flow k -> k+1
    mask: np.ndarray         # (F, H, W) int32 instance labels (0 = static)
    T_wc_gt: np.ndarray      # (F, 4, 4) camera poses, camera->world
    obj_H_gt: np.ndarray     # (F, K, 4, 4) world-frame motion k-1 -> k per object
    obj_pose_gt: np.ndarray  # (F, K, 4, 4) object pose L_w per frame
    obj_labels: np.ndarray   # (K,) instance labels of the objects
    K_mat: np.ndarray        # (3, 3) intrinsics


def _distort_norm_np(x, y, dist):
    """Forward Brown-Conrady on normalized coords (numpy, render-time)."""
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def _undistort_norm_np(xd, yd, dist, iters: int = 10):
    """Fixed-point inversion of _distort_norm_np (matches ops/undistort)."""
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        fx_, fy_ = _distort_norm_np(x, y, dist)
        x = xd - (fx_ - x)
        y = yd - (fy_ - y)
    return x, y


def _checker(a: np.ndarray, b: np.ndarray, freq_u: float, freq_v: float,
             phase: float) -> np.ndarray:
    """Checkerboard texture over patch coords — every cell corner is a FAST
    corner, giving the detector dense, well-spread responses.  Frequencies
    are per-patch and derived from metric size so corner density is roughly
    constant per meter."""
    ca = np.floor(a * freq_u + phase).astype(np.int64)
    cb = np.floor(b * freq_v + 0.7 * phase).astype(np.int64)
    base = ((ca + cb) % 2).astype(np.float64)
    return 0.2 + 0.6 * base


def make_scene(
    num_frames: int = 12,
    width: int = 320,
    height: int = 240,
    num_objects: int = 2,
    fx: float | None = None,
    fy: float | None = None,
    seed: int = 0,
    cam_speed: float = 0.25,
    obj_speed: float = 0.5,
    cam_yaw_rate: float = 0.004,
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0),
    obj_spacing: float = 6.0,
    obj_cross_frac: float = 0.0,
) -> SyntheticScene:
    """Build a KITTI-like forward-driving scene with moving planar objects.

    dist: Brown-Conrady coefficients (k1, k2, p1, p2, k3).  When nonzero the
    whole sequence is rendered in DISTORTED image space: each raw pixel's ray
    goes through the undistortion model, and flow targets are re-distorted
    after pinhole projection — exactly what a real distorted sensor + flow
    network would produce (the geometry a pipeline must undistort to use).
    """
    rng = np.random.default_rng(seed)
    fx = float(width) if fx is None else fx  # ~53 deg horizontal FOV
    fy = fx if fy is None else fy
    cx, cy = width / 2.0, height / 2.0
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64)

    # --- static background: ground plane + two side walls + far wall
    patches: list[Patch] = [
        Patch(np.array([-40.0, 2.0, -5.0]), np.array([80.0, 0.0, 0.0]),
              np.array([0.0, 0.0, 120.0]), 0),
        Patch(np.array([-12.0, 2.0, -5.0]), np.array([0.0, -10.0, 0.0]),
              np.array([0.0, 0.0, 120.0]), 0),
        Patch(np.array([12.0, 2.0, -5.0]), np.array([0.0, -10.0, 0.0]),
              np.array([0.0, 0.0, 120.0]), 0),
        Patch(np.array([-40.0, 2.0, 110.0]), np.array([80.0, 0.0, 0.0]),
              np.array([0.0, -30.0, 0.0]), 0),
    ]
    # static near-field "building facades" so the background has trackable
    # corners inside the depth gate at every frame of the trajectory
    bb_z = np.linspace(6.0, 95.0, 14)
    for j, z in enumerate(bb_z):
        side = -1.0 if j % 2 == 0 else 1.0
        x0 = side * rng.uniform(5.0, 9.0)
        w_, h_ = rng.uniform(3.0, 5.0), rng.uniform(3.0, 6.0)
        patches.append(
            Patch(np.array([x0 - w_ / 2, 1.8, z]), np.array([w_, 0.0, 0.0]),
                  np.array([0.0, -h_, 0.0]), 0)
        )

    # --- objects: upright planar "vehicles" ahead of the camera
    obj_patches: list[Patch] = []
    obj_T0: list[np.ndarray] = []
    obj_vel: list[np.ndarray] = []  # per-frame body twist (w, v)
    for k in range(num_objects):
        side = -1.0 if k % 2 == 0 else 1.0
        x0 = side * rng.uniform(1.8, 3.2)
        z0 = rng.uniform(10.0, 14.0) + obj_spacing * k
        w_, h_ = rng.uniform(2.2, 3.0), rng.uniform(1.5, 2.0)
        # object local frame at its centre; patch defined in LOCAL coords
        obj_patches.append(
            Patch(np.array([-w_ / 2, h_ / 2, 0.0]), np.array([w_, 0.0, 0.0]),
                  np.array([0.0, -h_, 0.0]), k + 1)
        )
        obj_T0.append(_pose([0.0, 0.0, 0.0], [x0, 0.9, z0]))
        fwd = obj_speed * rng.uniform(0.7, 1.3)
        yaw = rng.uniform(-0.01, 0.01)
        vx = rng.uniform(-0.02, 0.02)
        # crossing objects drift laterally toward the other side of the
        # road, producing genuine occlusion crossings in the z-buffered
        # render (the nearer object hides the farther one).  Guarded so the
        # default path draws exactly the same RNG stream as before
        # (fixture scenes and the cached bench scene stay bit-identical).
        if obj_cross_frac > 0 and rng.uniform() < obj_cross_frac:
            vx = -side * rng.uniform(0.08, 0.15)
        obj_vel.append((np.array([0.0, yaw, 0.0]),
                        np.array([vx, 0.0, fwd])))

    # --- camera trajectory: forward motion with gentle turning (linear yaw
    # rate plus a slow weave; bounded for arbitrarily long sequences)
    T_wc = np.zeros((num_frames, 4, 4))
    for f in range(num_frames):
        yaw = cam_yaw_rate * f + 0.05 * np.sin(0.05 * f)
        t = np.array([0.3 * np.sin(0.08 * f), 0.0, cam_speed * f])
        T_wc[f] = _pose([0.0, yaw, 0.0], t)

    # --- object pose chains L_w(f) and world motions H(f): L(f) = H(f) L(f-1)
    L = np.zeros((num_frames, num_objects, 4, 4))
    Hs = np.tile(np.eye(4), (num_frames, num_objects, 1, 1))
    for k in range(num_objects):
        L[0, k] = obj_T0[k]
        step = _pose(*obj_vel[k])  # constant body-frame step
        for f in range(1, num_frames):
            L[f, k] = L[f - 1, k] @ step        # body-frame increment
            Hs[f, k] = L[f, k] @ _inv(L[f - 1, k])  # world-frame motion

    # --- render
    distorted = any(d != 0.0 for d in dist)
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    xn = (xs - cx) / fx
    yn = (ys - cy) / fy
    if distorted:
        # raw pixel grid -> undistorted normalized ray directions
        xn, yn = _undistort_norm_np(xn, yn, dist)
    rays_cam = np.stack(
        [xn, yn, np.ones_like(xs, dtype=np.float64)], axis=-1
    )  # (H, W, 3) unit-z camera rays

    rgb = np.zeros((num_frames, height, width), np.float32)
    depth = np.zeros((num_frames, height, width), np.float32)
    flow = np.zeros((num_frames, height, width, 2), np.float32)
    mask = np.zeros((num_frames, height, width), np.int32)

    n_patches = len(patches) + num_objects
    tex_phase = rng.uniform(0, 6.0, size=n_patches)
    cells_per_m = rng.uniform(0.9, 1.4, size=n_patches)
    all_sizes = [(np.linalg.norm(p.eu), np.linalg.norm(p.ev))
                 for p in patches + obj_patches]
    tex_freq_u = np.array([max(s[0] * c, 2.0) for s, c in zip(all_sizes, cells_per_m)])
    tex_freq_v = np.array([max(s[1] * c, 2.0) for s, c in zip(all_sizes, cells_per_m)])

    def world_patches(f: int) -> list[Patch]:
        """All patches in world coords at frame f."""
        out = list(patches)
        for k, p in enumerate(obj_patches):
            Tw = L[f, k]
            out.append(
                Patch(
                    Tw[:3, :3] @ p.origin + Tw[:3, 3],
                    Tw[:3, :3] @ p.eu,
                    Tw[:3, :3] @ p.ev,
                    p.label,
                )
            )
        return out

    def raycast(f: int):
        """Returns per-pixel (z, label, patch_idx, a, b)."""
        Twc = T_wc[f]
        Rcw, tcw = _inv(Twc)[:3, :3], _inv(Twc)[:3, 3]
        zbuf = np.full((height, width), np.inf)
        lab = np.zeros((height, width), np.int32)
        pidx = np.full((height, width), -1, np.int32)
        aa = np.zeros((height, width))
        bb = np.zeros((height, width))
        cam_origin_w = Twc[:3, 3]
        rays_w = rays_cam @ Twc[:3, :3].T  # rotate rays to world
        for i, p in enumerate(world_patches(f)):
            n = np.cross(p.eu, p.ev)
            denom = rays_w @ n
            num = (p.origin - cam_origin_w) @ n
            # rays parallel to the plane (denom ~ 0) can't hit it: give them
            # s = -1 so the `s > 0.1` hit test rejects them with finite math
            # (num/denom would spray inf/nan through every op downstream)
            safe_denom = np.where(np.abs(denom) < 1e-12, 1.0, denom)
            s = np.where(np.abs(denom) < 1e-12, -1.0, num / safe_denom)
            X = cam_origin_w + s[..., None] * rays_w
            rel = X - p.origin
            # patch coordinates via normal equations
            G = np.array([[p.eu @ p.eu, p.eu @ p.ev], [p.eu @ p.ev, p.ev @ p.ev]])
            Gi = np.linalg.inv(G)
            pa = rel @ p.eu
            pb = rel @ p.ev
            a = Gi[0, 0] * pa + Gi[0, 1] * pb
            b = Gi[1, 0] * pa + Gi[1, 1] * pb
            zc = (X @ Rcw[2]) + tcw[2]  # z in camera frame
            hit = (s > 0.1) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1) & (zc > 0.1)
            closer = hit & (zc < zbuf)
            zbuf = np.where(closer, zc, zbuf)
            lab = np.where(closer, p.label, lab)
            pidx = np.where(closer, i, pidx)
            aa = np.where(closer, a, aa)
            bb = np.where(closer, b, bb)
        return zbuf, lab, pidx, aa, bb

    n_bg = len(patches)
    for f in range(num_frames):
        zbuf, lab, pidx, aa, bb = raycast(f)
        valid = np.isfinite(zbuf)
        depth[f] = np.where(valid, zbuf, 0.0).astype(np.float32)
        mask[f] = np.where(valid, lab, 0)
        pi = np.maximum(pidx, 0)
        rgb[f] = np.where(
            valid,
            _checker(aa, bb, tex_freq_u[pi], tex_freq_v[pi], tex_phase[pi]),
            0.0,
        ).astype(np.float32)

        # forward flow to frame f+1: re-project each pixel's 3D point
        if f + 1 < num_frames:
            Twc = T_wc[f]
            # sky pixels carry zbuf = inf; zero them (they're masked out of
            # the flow below via `valid`) so the matmuls stay finite
            z_safe = np.where(valid, zbuf, 0.0)
            X_cam = rays_cam * z_safe[..., None]
            X_w = X_cam @ Twc[:3, :3].T + Twc[:3, 3]
            # move object points by their world motion H(f+1)
            X_w_next = X_w.copy()
            for k in range(num_objects):
                m = lab == (k + 1)
                H = Hs[f + 1, k]
                X_w_next[m] = X_w[m] @ H[:3, :3].T + H[:3, 3]
            Tcw_next = _inv(T_wc[f + 1])
            X_c2 = X_w_next @ Tcw_next[:3, :3].T + Tcw_next[:3, 3]
            z2_ok = X_c2[..., 2] > 0.1
            z2 = np.where(z2_ok, X_c2[..., 2], 1.0)  # behind-camera pixels
            x2n = X_c2[..., 0] / z2                  # are masked out below
            y2n = X_c2[..., 1] / z2
            if distorted:
                # flow lives in raw (distorted) pixel space
                x2n, y2n = _distort_norm_np(x2n, y2n, dist)
            u2 = fx * x2n + cx
            v2 = fy * y2n + cy
            fu = np.where(valid & z2_ok, u2 - xs, 0.0)
            fv = np.where(valid & z2_ok, v2 - ys, 0.0)
            # the reference treats exactly-zero flow as invalid (Frame.cc:119)
            fu = np.where((fu == 0.0) & (fv == 0.0), 1e-4, fu)
            flow[f] = np.stack([fu, fv], axis=-1).astype(np.float32)

    return SyntheticScene(
        rgb=rgb,
        depth=depth,
        flow=flow,
        mask=mask,
        T_wc_gt=T_wc.astype(np.float32),
        obj_H_gt=Hs.astype(np.float32),
        obj_pose_gt=L.astype(np.float32),
        obj_labels=np.arange(1, num_objects + 1, dtype=np.int32),
        K_mat=K.astype(np.float32),
    )

def _erode_label_mask(mask: np.ndarray, k: int) -> np.ndarray:
    """Erode every object label (>0) by k pixels: a pixel keeps its label
    only if the whole (2k+1)^2 window shares it (becomes 0 otherwise) —
    the under-segmentation a real instance-segmentation network produces
    at object boundaries."""
    if k <= 0:
        return mask
    out = mask.copy()
    for dy in range(-k, k + 1):
        for dx in range(-k, k + 1):
            if dy == 0 and dx == 0:
                continue
            shifted = np.roll(np.roll(mask, dy, axis=0), dx, axis=1)
            # roll wraps; wrapped rows/cols get label 0 (treated as border)
            if dy > 0:
                shifted[:dy] = 0
            elif dy < 0:
                shifted[dy:] = 0
            if dx > 0:
                shifted[:, :dx] = 0
            elif dx < 0:
                shifted[:, dx:] = 0
            out = np.where((mask > 0) & (shifted != mask), 0, out)
    return out


def _jitter_label_mask(mask: np.ndarray, rng, j: int) -> np.ndarray:
    """Shift each object's mask independently by up to ±j px (mask/image
    misregistration).  Shifted pixels only land on background so object
    identities never swap."""
    if j <= 0:
        return mask
    out = np.where(mask > 0, 0, mask)
    for lab in np.unique(mask):
        if lab <= 0:
            continue
        dy = int(rng.integers(-j, j + 1))
        dx = int(rng.integers(-j, j + 1))
        region = np.roll(np.roll(mask == lab, dy, axis=0), dx, axis=1)
        out = np.where(region & (out == 0), lab, out)
    return out


def degrade_scene(
    scene: SyntheticScene,
    *,
    flow_noise_px: float = 0.0,
    flow_outlier_frac: float = 0.0,
    flow_outlier_px: float = 15.0,
    mask_erode_px: int = 0,
    mask_jitter_px: int = 0,
    merge_labels: dict | None = None,
    depth_noise_scale: float = 0.0,
    seed: int = 0,
) -> SyntheticScene:
    """Corrupt a clean oracle scene's INPUTS while keeping its ground truth
    exact — the noise regime of learned optical flow + Mask R-CNN masks the
    reference's thresholds were tuned for (README.md:97-118; scene-flow and
    size gates at Tracking.cc:1366-1612, depth gates at 2691/2849).

    flow_noise_px      gaussian sigma added per flow component
    flow_outlier_frac  fraction of pixels whose flow gets a uniform
                       ±flow_outlier_px gross error (bad matches)
    mask_erode_px      erode object labels by k px (under-segmentation)
    mask_jitter_px     shift each object's mask by up to ±j px per frame
    merge_labels       {src_label: dst_label} instance-merge failures
    depth_noise_scale  sigma = scale * z^2 depth noise (the reference's own
                       stereo-depth model, Frame.cc:489-493)
    """
    rng = np.random.default_rng(seed)
    flow = scene.flow.copy()
    mask = scene.mask.copy()
    depth = scene.depth.copy()

    if flow_noise_px > 0:
        has_flow = np.any(flow != 0.0, axis=-1, keepdims=True)
        flow = flow + np.where(
            has_flow,
            rng.normal(0.0, flow_noise_px, flow.shape).astype(np.float32),
            0.0)
    if flow_outlier_frac > 0:
        bad = rng.uniform(size=flow.shape[:-1]) < flow_outlier_frac
        gross = rng.uniform(-flow_outlier_px, flow_outlier_px,
                            flow.shape).astype(np.float32)
        flow = np.where(bad[..., None], flow + gross, flow)
    if merge_labels:
        for src, dst in merge_labels.items():
            mask = np.where(mask == src, dst, mask)
    for f in range(mask.shape[0]):
        m = _erode_label_mask(mask[f], mask_erode_px)
        mask[f] = _jitter_label_mask(m, rng, mask_jitter_px)
    if depth_noise_scale > 0:
        noise = rng.normal(0.0, 1.0, depth.shape).astype(np.float32)
        depth = np.where(depth > 0,
                         depth + depth_noise_scale * depth * depth * noise,
                         depth)
        depth = np.maximum(depth, 0.0)

    return SyntheticScene(
        rgb=scene.rgb, depth=depth, flow=flow.astype(np.float32), mask=mask,
        T_wc_gt=scene.T_wc_gt, obj_H_gt=scene.obj_H_gt,
        obj_pose_gt=scene.obj_pose_gt, obj_labels=scene.obj_labels,
        K_mat=scene.K_mat,
    )
