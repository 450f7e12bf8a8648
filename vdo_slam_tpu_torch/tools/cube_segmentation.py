"""Offline color-cube segmentation for the Oxford Multi-motion Dataset; a
jax-free port of tools/cube_segmentation.py.

    python -m vdo_slam_tpu_torch.tools.cube_segmentation <image_dir> \
        <out_dir> [--sat-thres 0.28] [--min-size 10000] [--erode 9] \
        [--dilate 38]

Equivalent of the reference's tools/cube_segmentation.m (MATLAB): produces
per-frame instance-label matrices for the OMD swinging-cubes sequences from
raw RGB frames, via

  1. Otsu foreground/background thresholding on the gray image, with the
     reference's 0.78 threshold relaxation (cube_segmentation.m:27),
  2. HSV saturation thresholding at S > 0.28 on the foreground
     (cube_segmentation.m:32),
  3. square-structuring-element erosion (9 px) then dilation (38 px)
     (cube_segmentation.m:36-40),
  4. 8-connected component labeling with components under 10 000 px dropped
     (cube_segmentation.m:47-56),

and writes one whitespace-int matrix per frame, the format the pipeline's
semantic reader consumes (``semantic/%06d.txt``).  PNGs are read by the
port's native reader (io/native_loader.py: g++ and zlib, no libpng).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def otsu_threshold(gray: np.ndarray) -> float:
    """Otsu's method on a [0, 255] gray image (MATLAB graythresh returns the
    normalized threshold; this returns it on the 0-255 scale)."""
    hist, _ = np.histogram(gray.ravel(), bins=256, range=(0.0, 256.0))
    hist = hist.astype(np.float64)
    total = hist.sum()
    if total == 0:
        return 0.0
    levels = np.arange(256, dtype=np.float64)
    w0 = np.cumsum(hist)
    w1 = total - w0
    mu0 = np.cumsum(hist * levels)
    mu_total = mu0[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        m0 = mu0 / w0
        m1 = (mu_total - mu0) / w1
        between = w0 * w1 * (m0 - m1) ** 2
    between = np.nan_to_num(between)
    return float(np.argmax(between))


def rgb_to_hsv_saturation(rgb: np.ndarray) -> np.ndarray:
    """S channel of HSV for a float RGB image in [0, 1]: (max-min)/max."""
    mx = rgb.max(axis=-1)
    mn = rgb.min(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(mx > 0, (mx - mn) / mx, 0.0)
    return s


def _box_count(mask: np.ndarray, k: int) -> np.ndarray:
    """Count of True values in each k x k window (zero-padded), via an
    integral image — O(HW) regardless of k."""
    h, w = mask.shape
    lo = -((k - 1) // 2)     # window covers [lo, lo+k) relative offsets;
    hi = lo + k              # MATLAB strel centers even kernels at
                             # floor((k+1)/2), i.e. offsets [-(k/2-1), k/2]
    ii = np.zeros((h + 1, w + 1), dtype=np.int64)
    ii[1:, 1:] = np.cumsum(np.cumsum(mask.astype(np.int64), axis=0), axis=1)
    y0 = np.clip(np.arange(h) + lo, 0, h)
    y1 = np.clip(np.arange(h) + hi, 0, h)
    x0 = np.clip(np.arange(w) + lo, 0, w)
    x1 = np.clip(np.arange(w) + hi, 0, w)
    return (ii[y1][:, x1] - ii[y1][:, x0] - ii[y0][:, x1] + ii[y0][:, x0])


def erode(mask: np.ndarray, k: int) -> np.ndarray:
    """Binary erosion with a k x k square structuring element.  Border
    pixels erode (zero padding), matching MATLAB imerode's default."""
    if k <= 1:
        return mask.copy()
    return _box_count(mask, k) == k * k


def dilate(mask: np.ndarray, k: int) -> np.ndarray:
    """Binary dilation with a k x k square structuring element."""
    if k <= 1:
        return mask.copy()
    return _box_count(mask, k) > 0


def label_components(mask: np.ndarray) -> np.ndarray:
    """8-connected component labeling (MATLAB bwlabel default connectivity)."""
    from scipy import ndimage

    labels, _ = ndimage.label(mask, structure=np.ones((3, 3), dtype=np.int64))
    return labels.astype(np.int64)


def segment_cubes(rgb: np.ndarray, sat_thres: float = 0.28,
                  min_size: int = 10000, erode_k: int = 9,
                  dilate_k: int = 38) -> np.ndarray:
    """Full per-frame pipeline: RGB uint8/float (H, W, 3) -> label matrix.

    Labels are renumbered 1..K (background 0) after the small-component drop,
    so downstream consumers see dense instance ids.
    """
    rgb = np.asarray(rgb)
    if rgb.dtype == np.uint8:
        rgbf = rgb.astype(np.float64) / 255.0
    else:
        rgbf = rgb.astype(np.float64)
        if rgbf.max() > 1.0:
            rgbf = rgbf / 255.0
    gray = 0.2989 * rgbf[..., 0] + 0.5870 * rgbf[..., 1] + 0.1140 * rgbf[..., 2]
    t = otsu_threshold(gray * 255.0)
    fore = gray * 255.0 > 0.78 * t

    sat = rgb_to_hsv_saturation(rgbf * fore[..., None])
    mask_hsv = sat > sat_thres

    cleaned = dilate(erode(mask_hsv, erode_k), dilate_k)
    labels = label_components(cleaned)

    # drop components under min_size px, then renumber densely
    ids, counts = np.unique(labels, return_counts=True)
    keep = ids[(ids > 0) & (counts >= min_size)]
    remap = np.zeros(int(labels.max()) + 1, dtype=np.int64)
    remap[keep] = np.arange(1, len(keep) + 1)
    return remap[labels]


def _read_png_rgb(path: Path) -> np.ndarray:
    """(H, W, 3) float RGB through the port's native PNG reader."""
    from ..io import native_loader

    lib = native_loader.build_native_loader()
    if lib is None:
        raise RuntimeError("native loader unavailable: "
                           + native_loader.BUILD_LOG)
    arr = native_loader.read_png_native(lib, str(path))
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    return arr[..., :3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image_dir", type=Path)
    ap.add_argument("out_dir", type=Path)
    ap.add_argument("--sat-thres", type=float, default=0.28)
    ap.add_argument("--min-size", type=int, default=10000)
    ap.add_argument("--erode", type=int, default=9)
    ap.add_argument("--dilate", type=int, default=38)
    args = ap.parse_args(argv)

    args.out_dir.mkdir(parents=True, exist_ok=True)
    frames = sorted(args.image_dir.glob("*.png"))
    if not frames:
        print(f"no .png frames in {args.image_dir}", file=sys.stderr)
        return 1
    for f in frames:
        rgb = _read_png_rgb(f)
        labels = segment_cubes(rgb, args.sat_thres, args.min_size,
                               args.erode, args.dilate)
        out = args.out_dir / (f.stem + ".txt")
        np.savetxt(out, labels, fmt="%d")
        print(f"{f.name}: {labels.max()} instances -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
