"""The FAST kernel's share of its roofline (csrc/fast_score.cu): the least
time one launch over the pyramids it scores could take (`run.fast_px`:
one frame's pyramid, or every stream's in a batched step), its bytes at
the H100's published 3.35 TB/s, over the mean device time of the
`fast_pyramid_kernel` launches that ran wholly inside the traced
stretch."""

from benchmark.counting import H100_HBM_BYTES_PER_S, fast_pyramid_bytes


def read(run):
    tr = run.trace
    if tr is None or not run.fast_px:
        return None
    ks = [e - s for name, s, e, _ in tr.kernels(whole=True)
          if "fast_pyramid_kernel" in name]
    if not ks:
        return None
    mean_s = sum(ks) / len(ks) / 1e9
    return 100.0 * fast_pyramid_bytes(run.fast_px) / H100_HBM_BYTES_PER_S \
        / mean_s
