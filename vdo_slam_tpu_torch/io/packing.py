"""Wire format of one frame — port of vdo_slam_tpu/io/packing.py.

A frame travels to the device as ONE int16 buffer and is decoded there:

  gray u8 | seg u8 << 8      gray quantized to 1/255, labels < 256
  depth u16                  round(raw * depth_scale): 1/256 m (or px of
                             disparity) whatever the dataset's
                             depth_map_factor (depth_wire_scale)
  flow_u, flow_v fp16 bits   full float range, relative precision

in one of three layouts: the (4, H, W) wire; the flat wire of
`flow_down` 2 or 4, which carries every 2nd/4th flow sample and, with
`depth_down=2`, every 2nd depth sample plus `depth_resid` sparse exact
corrections; and the lossless entropy wire (u8-pair gray, int8-delta depth
with sparse exceptions, sparse seg transitions).  `flow_delta` stores the
flow planes as row-wise bit-pattern deltas, inverted by a cumulative sum.

The host half (`pack_frame` and what it calls) is numpy, copied from the
JAX package and held to it byte for byte by tests/test_torch_packing.py: a
buffer packed by either package decodes in both.  The device half
(`unpack_frame`, `_upsample2x_seg`, `_row_undelta_u16`) is PyTorch; it
takes any leading batch dimensions, so a chunk of C frames or the frames
of S streams decode in one pass.  Integer fields decode exactly; the
upsampled flow and the `depth_down=2` depth go through float sums written
in the JAX package's order of operations.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def depth_wire_scale(depth_map_factor: float, steps: int = 256) -> float:
    """Raw-sample -> u16 wire scale: `steps` per unit of raw /
    depth_map_factor whatever the factor, 1/256 m or 1/256 px of disparity
    at the default (a raw u16 KITTI disparity PNG with factor 256
    round-trips bit-exactly: scale = 1).  Fewer steps carry nearer
    surfaces of a stereo camera (TrackingConfig.wire_depth_steps)."""
    return float(steps) / float(depth_map_factor)


def _row_delta_u16(a: np.ndarray) -> np.ndarray:
    """Lossless row-wise bit-pattern delta of a (h, w) uint16 plane (mod
    2^16, inverted exactly by a cumulative sum): neighbouring fp16 flow
    samples share sign, exponent and most mantissa bits, so the deltas
    concentrate near zero and compress.  Precision is untouched."""
    d = a.copy()
    d[:, 1:] = (a[:, 1:].astype(np.int32)
                - a[:, :-1].astype(np.int32)).astype(np.uint16)
    return d


def _row_undelta_u16(d: Tensor) -> Tensor:
    """Device-side inverse of _row_delta_u16 on (..., h, w) samples held as
    integers in [0, 65535]: cumulative sum along rows, mod 2^16.  The int64
    accumulator cannot wrap (w terms below 2^16)."""
    return torch.cumsum(d.to(torch.int64), dim=-1) & 0xFFFF


def _norm_flow_down(flow_half: bool, flow_down: int | None) -> int:
    """Normalize the (flow_half legacy bool, flow_down factor) pair to a
    downsample factor in {1, 2, 4}."""
    d = int(flow_down) if flow_down is not None else (2 if flow_half else 1)
    if d not in (1, 2, 4):
        raise ValueError(f"flow_down must be 1, 2 or 4, got {d}")
    return d


def _norm_depth_down(depth_down: int | None, flow_d: int) -> int:
    """Validate the depth wire downsample factor.  Only 1 (full res) and 2
    are supported, and 2 requires the flat flow_down>1 wire layout (the
    (4,H,W) exact-parity layout has no room for a short depth plane)."""
    d = int(depth_down) if depth_down else 1
    if d not in (1, 2):
        raise ValueError(f"depth_down must be 1 or 2, got {d}")
    if d > 1 and flow_d == 1:
        raise ValueError("depth_down=2 requires flow_down>1 (flat wire)")
    return d


def wire_kwargs(tr) -> dict:
    """The wire-format keyword set shared by pack_frame and unpack_frame,
    derived from a TrackingConfig — the single place call sites pick up
    every wire knob (flow down/delta, depth down/resid, entropy caps).
    unpack_frame callers add hw=(H, W)."""
    return dict(depth_scale=depth_wire_scale(tr.depth_map_factor,
                                             tr.wire_depth_steps),
                flow_down=tr.flow_down, flow_delta=tr.flow_delta,
                depth_down=tr.depth_down, depth_resid=tr.depth_resid,
                entropy=tr.entropy, seg_cap=tr.wire_seg_cap,
                depth_exc_cap=tr.wire_depth_exc_cap)


def _pack_u8_pairs(a: np.ndarray) -> np.ndarray:
    """(n,) uint8-range values -> (ceil(n/2),) int16, two per lane."""
    a = a.astype(np.uint16)
    if a.size % 2:
        a = np.concatenate([a, a[-1:]])
    return (a[0::2] | (a[1::2] << 8)).astype(np.int16)


def _delta_i8_exc(v: np.ndarray, cap: int, what: str):
    """Raveled-order lossless delta coding of an integer sequence: int8
    deltas where they fit, plus <= cap sparse (index, true-delta) exception
    pairs for the rest (the int8 slot is zeroed there; the device adds the
    sparse delta back before the cumulative sum).  Raises if the sequence
    needs more than `cap` exceptions — the cap is a static-shape config
    knob (TrackingConfig.wire_*_cap), not a silent quality cliff."""
    d = np.diff(np.concatenate([np.zeros(1, np.int64), v.astype(np.int64)]))
    big = np.abs(d) > 127
    n = int(np.sum(big))
    if n > cap:
        raise ValueError(
            f"entropy wire: frame needs {n} {what} exceptions > cap {cap}; "
            f"raise the wire_{what}_cap config knob")
    i8 = np.where(big, 0, d).astype(np.int8)
    idx = np.flatnonzero(big).astype(np.int64)
    exc = d[idx].astype(np.int64)
    if n < cap:                       # pad with no-op (idx 0, delta 0)
        pad = cap - n
        idx = np.concatenate([idx, np.zeros(pad, np.int64)])
        exc = np.concatenate([exc, np.zeros(pad, np.int64)])
    return i8, idx, exc


def _exc_planes(idx: np.ndarray, val: np.ndarray) -> list[np.ndarray]:
    """Sparse (index, i32 value) pairs -> four contiguous u16 planes
    [idx_lo | idx_hi | val_lo | val_hi] viewed int16 (the wire dtype)."""
    v = val.astype(np.int64)
    return [(idx & 0xFFFF).astype(np.uint16).view(np.int16),
            ((idx >> 16) & 0xFFFF).astype(np.uint16).view(np.int16),
            (v & 0xFFFF).astype(np.uint16).view(np.int16),
            ((v >> 16) & 0xFFFF).astype(np.uint16).view(np.int16)]


def _depth_residuals(depth_raw: np.ndarray, seg: np.ndarray,
                     depth_scale: float, dd: int, cap: int):
    """Host-side ranking of the `cap` worst pixels of the half-res depth
    reconstruction, for the sparse-residual wire block (pack_frame
    depth_resid).

    Runs the device reconstruction's arithmetic in numpy
    (_upsample2x_seg_np, extrap path) on the quantized coarse samples the
    wire will carry, compares against the quantized full-res truth, and
    returns the indices + true u16 values of the `cap` largest absolute
    errors in meters, indices ascending.  Even-pixel samples are carried
    exactly, so the ranking lands on the interpolated pixels where the
    planar-in-1/z model fails."""
    H, W = depth_raw.shape
    tgt16 = np.clip(np.rint(depth_raw * depth_scale), 0,
                    65535).astype(np.uint16)
    dc = tgt16[0::dd, 0::dd].astype(np.float32) * np.float32(1.0 /
                                                             depth_scale)
    vmask = dc > 0
    inv = np.where(vmask, 1.0 / np.maximum(dc, 1e-6), 0.0).astype(
        np.float32)
    seg_i = np.clip(seg, 0, 255).astype(np.int32)
    up = _upsample2x_seg_np(inv[..., None], seg_i, vmask,
                            extrap=True)[:H, :W, 0]
    rec = np.where(up > 1e-9, 1.0 / np.maximum(up, 1e-9), 0.0)
    tgt = tgt16.astype(np.float32) * np.float32(1.0 / depth_scale)
    err = np.abs(rec - tgt).ravel()
    cap = min(int(cap), err.size)
    idx = np.sort(np.argpartition(err, -cap)[-cap:]).astype(np.int64)
    return idx, tgt16.ravel()[idx]


def pack_frame(gray: np.ndarray, depth_raw: np.ndarray, flow: np.ndarray,
               seg: np.ndarray, depth_scale: float = 1.0,
               flow_half: bool = False,
               flow_down: int | None = None,
               flow_delta: bool = False,
               depth_down: int = 1,
               depth_resid: int = 0,
               entropy: bool = False,
               seg_cap: int = 8192,
               depth_exc_cap: int = 8192) -> np.ndarray:
    """Host-side pack: (H,W) gray [0,1], (H,W) raw depth samples,
    (H,W,2) float flow, (H,W) int labels -> (4,H,W) int16, or a flat int16
    vector for flow_down > 1.

    depth_scale: see depth_wire_scale — raw samples are stored as
    round(depth_raw * depth_scale) in u16.

    flow_half / flow_down: carry every 2nd/4th flow sample (fp16); the
    device upsamples seg-aware (_upsample2x_seg).  flow_half=True is the
    legacy spelling of flow_down=2.  Flat layout: [gray|seg (H*W), depth
    (H*W), flow_u (Hd*Wd), flow_v (Hd*Wd)].

    flow_delta: the flow planes as lossless row-wise bit-pattern deltas.

    depth_down: carry every 2nd depth sample; the device reconstructs the
    dense map by seg-aware bilinear interpolation in inverse depth.
    Requires flow_down>1.

    depth_resid: with depth_down>1, also carry the `depth_resid`
    worst-reconstructed pixels as sparse exact corrections
    ([idx_lo | idx_hi | value] planes after the flow).

    entropy: the lossless entropy wire (requires flow_down>1; excludes
    depth_down/depth_resid): gray as u8 pairs, depth as raveled int8
    deltas plus <= depth_exc_cap sparse exact exceptions, seg as <=
    seg_cap sparse raveled transitions.  The device inverts both delta
    streams with one integer cumsum each; reconstruction is identical to
    the dense wire.  Caps are static shapes; a frame over cap raises."""
    d = _norm_flow_down(flow_half, flow_down)
    dd = _norm_depth_down(depth_down, d)
    if depth_resid and dd <= 1:
        raise ValueError("depth_resid requires depth_down>1")
    if entropy:
        if d == 1:
            raise ValueError("entropy wire requires flow_down>1")
        if dd > 1 or depth_resid:
            raise ValueError("entropy wire excludes depth_down/depth_resid "
                             "(it carries full-res depth losslessly)")
    g8 = np.clip(np.rint(gray * 255.0), 0, 255).astype(np.uint16)
    s8 = np.clip(seg, 0, 255).astype(np.uint16)
    d16 = np.clip(np.rint(depth_raw * depth_scale), 0,
                  65535).astype(np.uint16)

    def enc(plane_f16_i16: np.ndarray) -> np.ndarray:  # (h, w) int16
        if not flow_delta:
            return plane_f16_i16
        return _row_delta_u16(plane_f16_i16.view(np.uint16)).view(np.int16)

    if entropy:
        dep_i8, dep_idx, dep_exc = _delta_i8_exc(
            d16.ravel(), depth_exc_cap, "depth_exc")
        seg_d = np.diff(np.concatenate(
            [np.zeros(1, np.int64), s8.ravel().astype(np.int64)]))
        tr_idx = np.flatnonzero(seg_d != 0).astype(np.int64)
        if tr_idx.size > seg_cap:
            raise ValueError(
                f"entropy wire: frame has {tr_idx.size} seg transitions > "
                f"cap {seg_cap}; raise the wire_seg_cap config knob")
        tr_val = seg_d[tr_idx]
        if tr_idx.size < seg_cap:
            pad = seg_cap - tr_idx.size
            tr_idx = np.concatenate([tr_idx, np.zeros(pad, np.int64)])
            tr_val = np.concatenate([tr_val, np.zeros(pad, np.int64)])
        fh = np.ascontiguousarray(
            flow[0::d, 0::d].astype(np.float16)).view(np.int16)
        parts = [_pack_u8_pairs(g8.ravel()),
                 _pack_u8_pairs(dep_i8.view(np.uint8)),
                 enc(fh[..., 0]).ravel(), enc(fh[..., 1]).ravel()]
        parts += _exc_planes(dep_idx, dep_exc)
        parts += _exc_planes(tr_idx, tr_val)
        return np.concatenate(parts)
    ch0 = (g8 | (s8 << 8)).astype(np.int16)
    ch1 = d16.view(np.int16)
    if dd > 1:
        ch1 = np.ascontiguousarray(ch1[0::dd, 0::dd])

    if d > 1:
        fh = np.ascontiguousarray(
            flow[0::d, 0::d].astype(np.float16)).view(np.int16)
        parts = [ch0.ravel(), ch1.ravel(),
                 enc(fh[..., 0]).ravel(), enc(fh[..., 1]).ravel()]
        if depth_resid:
            idx, vals = _depth_residuals(depth_raw, seg, depth_scale, dd,
                                         depth_resid)
            if idx.size < depth_resid:      # pad by repeating the first
                pad = depth_resid - idx.size
                idx = np.concatenate([idx, np.full(pad, idx[0] if idx.size
                                                   else 0)])
                vals = np.concatenate(
                    [vals, np.full(pad, vals[0] if vals.size else 0,
                                   np.uint16)])
            parts += [(idx & 0xFFFF).astype(np.uint16).view(np.int16),
                      (idx >> 16).astype(np.uint16).view(np.int16),
                      vals.view(np.int16)]
        return np.concatenate(parts)
    f = np.ascontiguousarray(flow.astype(np.float16)).view(np.int16)
    return np.stack([ch0, ch1, enc(f[..., 0]), enc(f[..., 1])])


def _entropy_offsets(hw: tuple[int, int], flow_down: int) -> tuple[int, int]:
    """(nh, o) of the entropy wire at hw = (H, W): gray and the depth
    deltas take nh u16 words each (u8 pairs), the two flow planes at
    1/flow_down follow, and the depth exception block (4 planes of
    depth_exc_cap) starts at o, the seg exception block after it."""
    H, W = hw
    d = flow_down
    nh = (H * W + 1) // 2
    return nh, 2 * nh + 2 * ((H + d - 1) // d) * ((W + d - 1) // d)


def depth_exceptions(buf: np.ndarray, hw: tuple[int, int], flow_down: int,
                     depth_exc_cap: int) -> int:
    """The depth exceptions one entropy-wire buffer carries, the number
    that `depth_exc_cap` bounds: its exception slots that are not padding
    (index 0, delta 0).  A real exception has a delta beyond int8, so none
    reads as padding."""
    _, o = _entropy_offsets(hw, flow_down)
    block = np.asarray(buf).reshape(-1)[o:o + 4 * depth_exc_cap]
    planes = block.view(np.uint16).reshape(4, depth_exc_cap)
    return int(np.count_nonzero(planes.any(axis=0)))


def _upsample2x_seg_np(f, seg, valid=None, extrap=False):
    """The numpy mirror of `_upsample2x_seg` on one (h, w, C) grid: the
    same arithmetic in the same order, run by `_depth_residuals` on the
    host to rank the pixels the device will reconstruct worst."""
    jnp = np
    h, w, _ = f.shape
    seg2 = jnp.pad(seg, ((0, 2 * h - seg.shape[0]),
                         (0, 2 * w - seg.shape[1])), mode="edge")
    sh = seg2[0::2, 0::2]                                  # (h, w) labels

    def pad_r(x):   # neighbor to the right, edge-clamped
        return jnp.concatenate([x[:, 1:], x[:, -1:]], axis=1)

    def pad_d(x):   # neighbor below, edge-clamped
        return jnp.concatenate([x[1:], x[-1:]], axis=0)

    f00, f01 = f, pad_r(f)
    f10, f11 = pad_d(f), pad_r(pad_d(f))
    s00, s01 = sh, pad_r(sh)
    s10, s11 = pad_d(sh), pad_r(pad_d(sh))
    if valid is not None:
        vf = valid.astype(f.dtype)
        v4 = (vf, pad_r(vf), pad_d(vf), pad_r(pad_d(vf)))
    else:
        v4 = (None, None, None, None)

    if extrap:
        vb = (valid if valid is not None
              else jnp.ones((h, w), bool))

        def _axis_grad(sh_n, fb, vb_):
            zc = jnp.zeros((h, 1), bool)
            zr = jnp.zeros((1, w), bool)
            if sh_n == "x":
                ok_l = jnp.concatenate(
                    [zc, (sh[:, :-1] == sh[:, 1:]) & vb_[:, :-1]], axis=1)
                ok_r = jnp.concatenate(
                    [(sh[:, 1:] == sh[:, :-1]) & vb_[:, 1:], zc], axis=1)
                f_l = jnp.concatenate([fb[:, :1], fb[:, :-1]], axis=1)
                f_r = pad_r(fb)
            else:
                ok_l = jnp.concatenate(
                    [zr, (sh[:-1] == sh[1:]) & vb_[:-1]], axis=0)
                ok_r = jnp.concatenate(
                    [(sh[1:] == sh[:-1]) & vb_[1:], zr], axis=0)
                f_l = jnp.concatenate([fb[:1], fb[:-1]], axis=0)
                f_r = pad_d(fb)
            okl = ok_l[..., None].astype(fb.dtype)
            okr = ok_r[..., None].astype(fb.dtype)
            dl, dr = fb - f_l, f_r - fb
            minmod = jnp.where(
                dl * dr > 0,
                jnp.sign(dl) * jnp.minimum(jnp.abs(dl), jnp.abs(dr)), 0.0)
            one_sided = okr * dr + (1.0 - okr) * okl * dl
            both = okl * okr
            return both * minmod + (1.0 - both) * one_sided

        gx, gy = _axis_grad("x", f, vb), _axis_grad("y", f, vb)
        g4 = ((gx, gy), (pad_r(gx), pad_r(gy)),
              (pad_d(gx), pad_d(gy)), (pad_r(pad_d(gx)), pad_r(pad_d(gy))))
        c4 = ((0.0, 0.0), (0.0, 1.0), (1.0, 0.0), (1.0, 1.0))
    else:
        g4 = ((None, None),) * 4
        c4 = ((0.0, 0.0),) * 4

    C = f.shape[-1]
    vals = []
    for (dy, dx) in ((0, 0), (0, 1), (1, 0), (1, 1)):
        w00, w01, w10, w11 = _PHASES[(dy, dx)]
        lab = seg2[dy::2, dx::2]                           # (h, w)
        acc = 0.0
        acc_x = 0.0
        macc = 0.0
        pacc = 0.0
        pmacc = 0.0
        for wgt, fv, sv, vv, gv, cc in ((w00, f00, s00, v4[0], g4[0], c4[0]),
                                        (w01, f01, s01, v4[1], g4[1], c4[1]),
                                        (w10, f10, s10, v4[2], g4[2], c4[2]),
                                        (w11, f11, s11, v4[3], g4[3], c4[3])):
            if wgt == 0.0:
                continue
            m = (sv == lab).astype(f.dtype)[..., None] * wgt
            pw = wgt
            if vv is not None:
                m = m * vv[..., None]
                pw = wgt * vv[..., None]
            acc = acc + fv * m
            macc = macc + m
            pacc = pacc + fv * pw
            pmacc = pmacc + pw
            if extrap:
                ddy, ddx = dy * 0.5 - cc[0], dx * 0.5 - cc[1]
                acc_x = acc_x + (fv + ddy * gv[1] + ddx * gv[0]) * m
        if valid is None:
            plain = pacc                      # exact bilinear (weights sum 1)
        else:
            plain = jnp.where(pmacc > 0, pacc / jnp.maximum(pmacc, 1e-6),
                              jnp.zeros_like(pacc))
        mix = acc
        if extrap:
            mix = jnp.where(macc < 1.0 - 1e-4, acc_x, acc)
        vals.append(jnp.where(macc > 0, mix / jnp.maximum(macc, 1e-6),
                              plain))
    grid = jnp.stack(vals).reshape(2, 2, h, w, C)
    return grid.transpose(2, 0, 3, 1, 4).reshape(2 * h, 2 * w, C)


# output phase (dy, dx) in the 2x2 cell -> bilinear weights of the cell's
# four coarse corners (00, 01, 10, 11)
_PHASES = {(0, 0): (1.0, 0.0, 0.0, 0.0), (0, 1): (.5, .5, 0.0, 0.0),
           (1, 0): (.5, 0.0, .5, 0.0), (1, 1): (.25, .25, .25, .25)}


def _next(x: Tensor, dim: int) -> Tensor:
    """The neighbour at +1 along dim, edge-clamped."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)],
                     dim=dim)


def _upsample2x_seg(f: Tensor, seg: Tensor, valid: Tensor | None = None,
                    extrap: bool = False) -> Tensor:
    """Seg-aware bilinear 2x upsample of (..., h, w, C) samples ->
    (..., 2h, 2w, C), out[2i, 2j] = f[i, j] (the host's even-pixel
    downsample).  `seg` is the (..., Hs, Ws) label map of the output grid,
    edge-padded to (2h, 2w).

    Each output pixel mixes only the coarse corners of its cell that share
    its label (weights renormalized; plain bilinear where none matches), so
    nothing is interpolated across a motion boundary.  `valid` (..., h, w)
    marks usable coarse samples (depth 0 = invalid): invalid ones carry no
    weight, and a pixel with no valid contributor comes out 0.  With
    `extrap`, corners of cells that lost a corner to label or validity
    vote with their same-label plane extended to the target pixel, the
    gradients minmod-limited; cells whose four corners all match keep the
    plain bilinear bit for bit.

    The arithmetic and its order are those of the JAX package's function
    and of the numpy mirror above, which ranks the depth residuals by
    running what this function will compute.
    """
    h, w, C = f.shape[-3:]
    dev = f.device
    # edge-pad to exactly (2h, 2w) by clamped indexing: for odd H or W the
    # coarse grid's last row or column covers one fine row or column less
    rows = torch.arange(2 * h, device=dev).clamp(max=seg.shape[-2] - 1)
    cols = torch.arange(2 * w, device=dev).clamp(max=seg.shape[-1] - 1)
    seg2 = seg[..., rows[:, None], cols[None, :]]
    sh = seg2[..., 0::2, 0::2]                             # (..., h, w)

    def corners(x, has_c):  # x and its right, lower and diagonal neighbours
        r, d = (-2, -3) if has_c else (-1, -2)
        xd = _next(x, d)
        return x, _next(x, r), xd, _next(xd, r)

    f4 = corners(f, True)
    s4 = corners(sh, False)
    v4 = ((None,) * 4 if valid is None
          else corners(valid.to(f.dtype), False))

    if extrap:
        # same-label gradients per coarse sample (f units per coarse px).
        # A neighbour across the image border is unusable; a sample with
        # no usable neighbour on either side gets gradient 0 there.
        vb = (valid if valid is not None
              else torch.ones(sh.shape, dtype=torch.bool, device=dev))

        def axis_grad(dm, df):  # dm, df: the axis in a map and in f
            n = sh.shape[dm]
            lo, hi = sh.narrow(dm, 0, n - 1), sh.narrow(dm, 1, n - 1)
            z = torch.zeros_like(sh.narrow(dm, 0, 1), dtype=torch.bool)
            ok_l = torch.cat([z, (lo == hi) & vb.narrow(dm, 0, n - 1)], dm)
            ok_r = torch.cat([(hi == lo) & vb.narrow(dm, 1, n - 1), z], dm)
            f_l = torch.cat([f.narrow(df, 0, 1), f.narrow(df, 0, n - 1)], df)
            f_r = _next(f, df)
            okl = ok_l[..., None].to(f.dtype)
            okr = ok_r[..., None].to(f.dtype)
            dl, dr = f - f_l, f_r - f
            # minmod: same sign -> the smaller magnitude, else 0
            minmod = torch.where(
                dl * dr > 0,
                torch.sign(dl) * torch.minimum(torch.abs(dl), torch.abs(dr)),
                0.0)
            one_sided = okr * dr + (1.0 - okr) * okl * dl
            both = okl * okr
            return both * minmod + (1.0 - both) * one_sided

        gx4 = corners(axis_grad(-1, -2), True)
        gy4 = corners(axis_grad(-2, -3), True)
        c4 = ((0.0, 0.0), (0.0, 1.0), (1.0, 0.0), (1.0, 1.0))

    vals = []
    for (dy, dx) in ((0, 0), (0, 1), (1, 0), (1, 1)):
        lab = seg2[..., dy::2, dx::2]                      # (..., h, w)
        acc = acc_x = macc = pacc = pmacc = 0.0
        for k, wgt in enumerate(_PHASES[(dy, dx)]):
            if wgt == 0.0:
                continue
            fv = f4[k]
            m = (s4[k] == lab).to(f.dtype)[..., None] * wgt
            pw = wgt
            if valid is not None:
                m = m * v4[k][..., None]
                pw = wgt * v4[k][..., None]
            acc = acc + fv * m
            macc = macc + m
            pacc = pacc + fv * pw
            pmacc = pmacc + pw
            if extrap:
                # this corner's plane extended to the target pixel
                ddy, ddx = dy * 0.5 - c4[k][0], dx * 0.5 - c4[k][1]
                acc_x = acc_x + (fv + ddy * gy4[k] + ddx * gx4[k]) * m
        if valid is None:
            plain = pacc                      # exact bilinear (weights sum 1)
        else:
            plain = torch.where(pmacc > 0,
                                pacc / torch.clamp(pmacc, min=1e-6),
                                torch.zeros_like(pacc))
        mix = acc
        if extrap:
            # extrapolated votes only where a corner was excluded
            mix = torch.where(macc < 1.0 - 1e-4, acc_x, acc)
        vals.append(torch.where(macc > 0, mix / torch.clamp(macc, min=1e-6),
                                plain))
    # (..., 2, 2, h, w, C) -> out[..., 2i+dy, 2j+dx, :] = vals[dy][dx][i, j]
    lead = f.shape[:-3]
    nb = len(lead)
    grid = torch.stack(vals, dim=nb).reshape(lead + (2, 2, h, w, C))
    perm = tuple(range(nb)) + (nb + 2, nb, nb + 3, nb + 1, nb + 4)
    return grid.permute(perm).reshape(lead + (2 * h, 2 * w, C))


def _f16_bits_to_f32(u: Tensor) -> Tensor:
    """Integers in [0, 65535] holding fp16 bit patterns -> float32.  A
    pattern above 32767 wraps to a negative int16 before the bit cast."""
    i16 = (((u + 0x8000) & 0xFFFF) - 0x8000).to(torch.int16)
    return i16.contiguous().view(torch.float16).to(torch.float32)


def _upsample_flow(f: Tensor, seg: Tensor, d: int, H: int, W: int) -> Tensor:
    """Upsample 2x at a time; each stage takes the labels subsampled to its
    output grid, so every mix stays label-consistent."""
    lvl = d
    while lvl > 1:
        lvl //= 2
        seg_s = seg[..., 0::lvl, 0::lvl]
        hs = (H + lvl - 1) // lvl
        ws = (W + lvl - 1) // lvl
        f = _upsample2x_seg(f, seg_s)[..., :hs, :ws, :]
    return f


def unpack_frame(buf: Tensor, depth_scale: float = 1.0,
                 flow_half: bool = False,
                 hw: tuple[int, int] | None = None,
                 flow_down: int | None = None,
                 flow_delta: bool = False,
                 depth_down: int = 1,
                 depth_resid: int = 0,
                 entropy: bool = False,
                 seg_cap: int = 8192,
                 depth_exc_cap: int = 8192):
    """Device-side unpack of an int16 buffer (..., 4, H, W) — or the flat
    flow_down>1 layouts (..., wire_len), with hw=(H, W) — into (gray f32
    (..., H, W), depth_raw f32 (..., H, W), flow f32 (..., H, W, 2), seg
    i32 (..., H, W)).  Leading dimensions are frames decoded together.

    The bit fields are widened to int32 (`& 0xFFFF`) and taken apart with
    integer arithmetic; the delta streams are inverted by integer cumulative
    sums, which cannot wrap (u16 samples, u8 labels, int64 accumulators);
    the sparse additions are integer `scatter_add`s whose padding entries
    are (index 0, value 0), so duplicates and atomics stay exact.
    """
    d = _norm_flow_down(flow_half, flow_down)
    dd = _norm_depth_down(depth_down, d)
    u = buf.to(torch.int32) & 0xFFFF                    # raw bit patterns
    inv_scale = 1.0 / depth_scale

    def dec(plane):                 # (..., Hd, Wd) u16 patterns -> f32
        if flow_delta:
            plane = _row_undelta_u16(plane)
        return _f16_bits_to_f32(plane)

    if d == 1:
        gray = (u[..., 0, :, :] & 0xFF).to(torch.float32) * (1.0 / 255.0)
        seg = u[..., 0, :, :] >> 8
        depth = u[..., 1, :, :].to(torch.float32) * inv_scale
        flow = torch.stack([dec(u[..., 2, :, :]), dec(u[..., 3, :, :])],
                           dim=-1)
        return gray, depth, flow, seg

    H, W = hw
    lead = u.shape[:-1]
    Hd, Wd = (H + d - 1) // d, (W + d - 1) // d
    n = H * W

    def flow_from(fu16):            # (..., 2 * Hd * Wd) -> (..., Hd, Wd, 2)
        planes = fu16.reshape(lead + (2, Hd, Wd))
        return torch.stack([dec(planes[..., 0, :, :]),
                            dec(planes[..., 1, :, :])], dim=-1)

    if entropy:
        nh, o = _entropy_offsets(hw, d)

        def unpair(plane):                       # (..., nh) u16 -> (..., n) u8
            return torch.stack([plane & 0xFF, plane >> 8],
                               dim=-1).reshape(lead + (-1,))[..., :n]

        def exc(block):                          # 4 planes -> (idx, i32 val)
            cap = block.shape[-1] // 4
            b64 = block.to(torch.int64)
            idx = b64[..., :cap] | (b64[..., cap:2 * cap] << 16)
            val = b64[..., 2 * cap:3 * cap] | (b64[..., 3 * cap:] << 16)
            # the value is a signed int32 carried as two u16 halves
            return idx, ((val + 0x80000000) & 0xFFFFFFFF) - 0x80000000

        gray = unpair(u[..., :nh]).to(torch.float32) * (1.0 / 255.0)
        b = unpair(u[..., nh:2 * nh])
        deltas = ((b ^ 0x80) - 0x80).to(torch.int64)  # sign-extended int8
        dep_idx, dep_val = exc(u[..., o:o + 4 * depth_exc_cap])
        o2 = o + 4 * depth_exc_cap
        seg_idx, seg_val = exc(u[..., o2:o2 + 4 * seg_cap])
        d16 = torch.cumsum(deltas.scatter_add(-1, dep_idx, dep_val), dim=-1)
        depth = (d16.to(torch.float32) * inv_scale).reshape(lead + (H, W))
        seg = torch.cumsum(torch.zeros_like(deltas).scatter_add(
            -1, seg_idx, seg_val), dim=-1).to(torch.int32).reshape(
                lead + (H, W))
        flow = _upsample_flow(flow_from(u[..., 2 * nh:o]), seg, d, H, W)
        return gray.reshape(lead + (H, W)), depth, flow, seg

    c0 = u[..., :n].reshape(lead + (H, W))
    gray = (c0 & 0xFF).to(torch.float32) * (1.0 / 255.0)
    seg = c0 >> 8
    if dd > 1:
        Hdd, Wdd = (H + dd - 1) // dd, (W + dd - 1) // dd
        nd = Hdd * Wdd
        dc = u[..., n:n + nd].reshape(lead + (Hdd, Wdd)).to(
            torch.float32) * inv_scale
        # seg-aware bilinear in INVERSE depth (1/z is affine in the pixel
        # on a 3D plane, so planar interiors reconstruct exactly); zero
        # samples are invalid and carry no weight.  full_like / x, not
        # 1.0 / x: torch's scalar / tensor is reciprocal-then-multiply
        vmask = dc > 0
        inv = torch.where(vmask, torch.full_like(dc, 1.0)
                          / torch.clamp(dc, min=1e-6), 0.0)
        up = _upsample2x_seg(inv[..., None], seg, vmask,
                             extrap=True)[..., :H, :W, 0]
        depth = torch.where(up > 1e-9, torch.full_like(up, 1.0)
                            / torch.clamp(up, min=1e-9), 0.0)
        if depth_resid:
            # sparse exact corrections: overwrite the worst-reconstructed
            # pixels with their true u16 samples.  Padding repeats a real
            # correction, so duplicate indices carry the same value
            nf = Hd * Wd * 2
            r = u[..., n + nd + nf:n + nd + nf + 3 * depth_resid]
            lo = r[..., :depth_resid]
            hi = r[..., depth_resid:2 * depth_resid]
            dv = r[..., 2 * depth_resid:].to(torch.float32) * inv_scale
            depth = depth.reshape(lead + (n,)).scatter(
                -1, (lo | (hi << 16)).to(torch.int64), dv).reshape(
                    lead + (H, W))
    else:
        nd = n
        depth = u[..., n:2 * n].reshape(lead + (H, W)).to(
            torch.float32) * inv_scale
    flow = _upsample_flow(flow_from(u[..., n + nd:n + nd + 2 * Hd * Wd]),
                          seg, d, H, W)
    return gray, depth, flow, seg
