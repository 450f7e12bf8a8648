"""Minimal-solve RANSAC for pose/motion initialization — port of
vdo_slam_tpu/solvers/ransac.py.

3-point rigid hypotheses from closed-form triangle frames, scored by 2D
reprojection inliers; the motion-model comparison and the all-inlier
polar-Kabsch refit are the JAX package's.  The vmaps over hypotheses and
object slots are leading batch dimensions here.  The random picks are an
input: `ransac_rigid` takes a `sample(n_valid) -> picks` callable, so a
caller can draw from a torch.Generator and a test can replay the JAX
package's `jax.random.randint` draws (ransac.py:164).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..geometry import camera as cam
from ..geometry import se3
from ..ops.select import compact

Tensor = torch.Tensor


def _cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def rigid_from_triangle(P: Tensor, Q: Tensor) -> Tensor:
    """Rigid transform mapping the 3-point triangle P onto Q, from
    orthonormal frames built on both.  P, Q: (..., 3, 3), rows are points.
    Returns (..., 4, 4)."""
    def frame(A):
        e1 = A[..., 1, :] - A[..., 0, :]
        e1 = e1 / (torch.linalg.vector_norm(e1, dim=-1, keepdim=True) + 1e-12)
        v2 = A[..., 2, :] - A[..., 0, :]
        e2 = v2 - torch.sum(v2 * e1, dim=-1, keepdim=True) * e1
        e2 = e2 / (torch.linalg.vector_norm(e2, dim=-1, keepdim=True) + 1e-12)
        return torch.stack([e1, e2, _cross(e1, e2)], dim=-1)  # columns

    R = frame(Q) @ frame(P).transpose(-1, -2)
    t = Q.mean(dim=-2) - torch.einsum("...ij,...j->...i", R, P.mean(dim=-2))
    return se3.from_Rt(R, t)


def _det3(A: Tensor) -> Tensor:
    return torch.sum(A[..., 0, :] * _cross(A[..., 1, :], A[..., 2, :]), dim=-1)


def _inv3(A: Tensor) -> Tensor:
    """Closed-form 3x3 inverse (adjugate / det)."""
    c0 = _cross(A[..., 1, :], A[..., 2, :])
    c1 = _cross(A[..., 2, :], A[..., 0, :])
    c2 = _cross(A[..., 0, :], A[..., 1, :])
    det = torch.sum(A[..., 0, :] * c0, dim=-1)
    return torch.stack([c0, c1, c2], dim=-1) / det[..., None, None]


def _polar3(M: Tensor, n_iters: int = 8) -> Tensor:
    """Orthogonal polar factor of 3x3 matrices by the scaled Newton
    iteration X <- (g X + X^-T / g) / 2 (Higham scaling)."""
    X = M / torch.clamp(torch.linalg.matrix_norm(M, keepdim=True), min=1e-12)
    for _ in range(n_iters):
        Xinv_t = _inv3(X).transpose(-1, -2)
        g = torch.sqrt(torch.sqrt(
            (torch.sum(Xinv_t * Xinv_t, dim=(-2, -1), keepdim=True) + 1e-20)
            / (torch.sum(X * X, dim=(-2, -1), keepdim=True) + 1e-20)))
        X = 0.5 * (g * X + Xinv_t / g)
    return X


def kabsch_polar(P: Tensor, Q: Tensor, w: Tensor,
                 T_fallback: Tensor) -> Tensor:
    """SVD-free weighted rigid alignment Q ~= R P + t, R = polar(M) with
    M = sum w Qc Pc^T; T_fallback where the set is degenerate (fewer than 3
    weighted points, det <= 0 or near-singular M)."""
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    p_bar = torch.einsum("...n,...ni->...i", wn, P)
    q_bar = torch.einsum("...n,...ni->...i", wn, Q)
    Pc = P - p_bar[..., None, :]
    Qc = Q - q_bar[..., None, :]
    M = torch.einsum("...n,...ni,...nj->...ij", wn, Qc, Pc)
    det = _det3(M)
    scale2 = torch.sum(M * M, dim=(-2, -1))
    ok = ((torch.sum(w > 0, dim=-1) >= 3)
          & (det > 1e-9 * scale2 * torch.sqrt(torch.clamp(scale2, min=1e-30))))
    R = _polar3(M)
    t = q_bar - torch.einsum("...ij,...j->...i", R, p_bar)
    return torch.where(ok[..., None, None], se3.from_Rt(R, t), T_fallback)


def kabsch(P: Tensor, Q: Tensor, w: Tensor) -> Tensor:
    """Weighted rigid alignment by SVD: T (4x4) minimizing
    sum w ||Q - T(P)||^2, the reflection removed by the determinant sign.
    P, Q (N, 3), w (N,) nonnegative.  No path calls it: it is the classic
    solve that kabsch_polar is held to."""
    wn = w / torch.clamp(torch.sum(w), min=1e-9)
    p_bar = torch.einsum("n,ni->i", wn, P)
    q_bar = torch.einsum("n,ni->i", wn, Q)
    M = torch.einsum("n,ni,nj->ij", wn, Q - q_bar, P - p_bar)
    U, _, Vt = torch.linalg.svd(M)
    D = torch.ones(3, dtype=M.dtype, device=M.device)
    D[2] = torch.linalg.det(U @ Vt)
    R = U @ torch.diag(D) @ Vt
    return se3.from_Rt(R, q_bar - R @ p_bar)


def reprojection_inliers(T: Tensor, X_src: Tensor, uv_obs: Tensor,
                         valid: Tensor, K: Tensor, thres: float):
    """Inliers under T: ||uv_obs - pi(T X_src)|| < thres and in front of
    the camera (Tracking.cc:1673-1688).  T (..., 4, 4), points (..., N, .).
    Returns (mask (..., N), count (...,))."""
    Y = se3.apply(T[..., None, :, :], X_src)
    err = torch.linalg.vector_norm(uv_obs - cam.project(Y, K), dim=-1)
    ok = valid & (err < thres) & (Y[..., 2] > 0)
    return ok, ok.sum(dim=-1)


def ransac_rigid(X_src: Tensor, X_tgt: Tensor, uv_obs: Tensor, valid: Tensor,
                 K: Tensor, sample: Callable[[Tensor], Tensor],
                 thres: float = 0.4):
    """RANSAC over 3-point rigid hypotheses.

    X_src (..., N, 3) previous-frame points; X_tgt (..., N, 3) current
    camera-frame points; uv_obs (..., N, 2) current pixels; valid (..., N).
    sample(n_valid (...,)) -> picks (..., S, 3) int64 in [0, n_valid) draws
    the hypotheses' members among the compacted valid points.
    Returns (T_best (..., 4, 4), inlier mask (..., N), n_inliers (...,)).
    """
    perm, n_valid = compact(valid)
    picks = sample(torch.clamp(n_valid, min=1))
    idx = torch.gather(perm, -1, picks.flatten(-2)).reshape(picks.shape)

    def rows(X):  # (..., N, 3) -> (..., S, 3, 3)
        flat = torch.gather(X, -2, idx.flatten(-2)[..., None].expand(
            idx.shape[:-2] + (idx.shape[-2] * 3, 3)))
        return flat.reshape(idx.shape + (3,))

    Ts = rigid_from_triangle(rows(X_src), rows(X_tgt))      # (..., S, 4, 4)
    _, counts = reprojection_inliers(
        Ts, X_src[..., None, :, :], uv_obs[..., None, :, :],
        valid[..., None, :], K, thres)                      # (..., S)
    best = torch.argmax(counts, dim=-1)                     # first maximum
    T_best = torch.gather(Ts, -3, best[..., None, None, None].expand(
        best.shape + (1, 4, 4)))[..., 0, :, :]
    mask, n_in = reprojection_inliers(T_best, X_src, uv_obs, valid, K, thres)
    return T_best, mask, n_in


def refine_with_inliers(T: Tensor, X_src: Tensor, X_tgt: Tensor,
                        inlier: Tensor) -> Tensor:
    """All-inlier rigid refit of the RANSAC / motion-model winner (the LM
    init polish); falls back to T on degenerate inlier sets."""
    return kabsch_polar(X_src, X_tgt, inlier.to(torch.float32), T)


def choose_init(T_ransac, mask_ransac, n_ransac, T_model, X_src, uv_obs,
                valid, K, thres: float = 0.4):
    """RANSAC vs motion model by inlier count (Tracking.cc:1693-1713).
    Returns (T, mask, n, used_model)."""
    mask_mm, n_mm = reprojection_inliers(T_model, X_src, uv_obs, valid, K,
                                         thres)
    use_mm = n_mm >= n_ransac
    return (torch.where(use_mm[..., None, None], T_model, T_ransac),
            torch.where(use_mm[..., None], mask_mm, mask_ransac),
            torch.where(use_mm, n_mm, n_ransac), use_mm)
