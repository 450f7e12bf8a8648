"""Offline sequence packer: reference-layout directory -> packed dataset;
a jax-free port of tools/pack_sequence.py.

    python -m vdo_slam_tpu_torch.tools.pack_sequence <seq_dir> <out_dir> \
        [--depth-map-factor 256] [--full-res-flow] [--flow-delta] \
        [--depth-down 2 --depth-resid N] [--entropy] \
        [--depth-exc-cap N] [--depth-steps N] [--frames N]

Converts a sequence directory (example/vdo_slam.cc:150-450 layout) into the
device wire format (io/packing.py), so that the tracking loop's host work
per frame is a memmap read and one upload (io/packed_dataset.py).  The
output directory is byte-equal to the original tool's for the same flags.
Beside them, --entropy packs the lossless entropy wire (tpu_fast's
wire_entropy), which the original's flags cannot reach, and
--depth-exc-cap / --depth-steps match a configuration that changes
wire_depth_exc_cap or the port-only wire_depth_steps (configs/omd.json:
32768 and 64).
"""

from __future__ import annotations

import argparse

from ..io.dataset import SequenceDataset
from ..io.packed_dataset import pack_dataset


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("seq_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--depth-map-factor", type=float, default=256.0,
                    help="DepthMapFactor from the run's settings yaml")
    ap.add_argument("--full-res-flow", action="store_true",
                    help="pack full-resolution flow (8 B/px wire) instead "
                         "of the half-res 5 B/px wire")
    ap.add_argument("--flow-delta", action="store_true",
                    help="row-delta code the fp16 flow planes (lossless; "
                         "matches tpu_fast's wire_flow_delta; the run "
                         "config must match)")
    ap.add_argument("--depth-down", type=int, default=1, choices=(1, 2),
                    help="depth plane downsample (2 = half-res inverse-"
                         "depth wire; run config wire_depth_down must "
                         "match)")
    ap.add_argument("--depth-resid", type=int, default=0,
                    help="with --depth-down 2: carry the N worst-"
                         "reconstructed pixels as bit-exact corrections "
                         "(matches wire_depth_resid)")
    ap.add_argument("--entropy", action="store_true",
                    help="the lossless entropy wire (matches tpu_fast's "
                         "wire_entropy; needs the half-res flow)")
    ap.add_argument("--depth-exc-cap", type=int, default=8192,
                    help="with --entropy: depth exceptions a frame may "
                         "carry (matches wire_depth_exc_cap)")
    ap.add_argument("--depth-steps", type=int, default=256,
                    help="u16 depth steps per unit of raw / depth-map-"
                         "factor (matches wire_depth_steps)")
    ap.add_argument("--frames", type=int, default=None)
    args = ap.parse_args(argv)

    ds = SequenceDataset(args.seq_dir)
    out = pack_dataset(ds, args.out_dir,
                       depth_map_factor=args.depth_map_factor,
                       flow_half=not args.full_res_flow, n=args.frames,
                       flow_delta=args.flow_delta,
                       depth_down=args.depth_down,
                       depth_resid=args.depth_resid,
                       entropy=args.entropy,
                       depth_exc_cap=args.depth_exc_cap,
                       depth_steps=args.depth_steps)
    print(f"packed {args.frames or len(ds)} frames -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
