"""The full-batch refine's LM solve against its memory roofline: the
floor bytes of the traced refine (benchmark/refine_counting.py: every
stored edge field read once per linearisation and once per CG iteration)
at the H100's published 3.35 TB/s, over its LM device time
(refine_lm_device_ms).  A floor count, so the share cannot pass 100 %."""

from benchmark.counting import H100_HBM_BYTES_PER_S
from benchmark.refine_counting import lm_device_ns


def read(run):
    r = getattr(run, "refine", None)
    ns = lm_device_ns(run)
    if not r or not r.get("floor_bytes") or not ns:
        return None
    return 100.0 * r["floor_bytes"] / H100_HBM_BYTES_PER_S / (ns / 1e9)
