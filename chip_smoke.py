#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, in order (any failure raises and exits nonzero):
  1. the card's name and power limit (nvidia-smi); no GPU -> exit 1;
  2. build the FAST-9/16 CUDA kernel from vdo_slam_tpu_torch/csrc;
  3. the kernel against its plain PyTorch version on the card, atol=0:
     one-level launches on binary test images, each pyramid level of a
     1242x375 synthetic frame and a batch of 3; then one launch for the
     whole 8-level pyramid of that frame, and of frames 0-2 (S=3), level
     by level, and of the decoded first frames of the four streams of
     phase 7 (S=4) and of the six of phase 13b (S=6), stream by stream.
     Then the pyramid's device time (torch.profiler) and event time per
     frame against its bound, the plain version's, the compass test's pass
     shares, per-level times, and the S=1, S=4 and S=6 launches
     interleaved, each against its byte bound;
  3b. the edge Hessian-vector kernels (csrc/edge_hessian.cu) at the
     1,028-frame refine's caps (a graph of about a drive's counts,
     tests/hv_graphs.py, linearised by the solver): H t + damp t and the
     block-Jacobi apply against their plain versions on the card (within
     1e-5 relative), then each timed by CUDA events and on the device
     beside its byte bound and the plain version's time.
     `python3 chip_smoke.py --edge-hessian` runs this phase alone;
  4. the main path: System(mode="fused", device="cuda").run_sequence over
     the bench scene (make_scene(num_frames=101, 1242x375, 3 objects,
     seed 7); the dataset tracks num_frames - 1) cut to its first 25
     frames, the same inputs as make_scene(num_frames=26)'s, with the bench
     config, lm_iters 10 / lm_iters_obj 6 and BA off.  Checks:
     25 frames reported, one kernel launch per frame, finite poses, and
     accuracy within the gates below against the JAX package's numbers;
  5. bench.py's whole path: System(enable_local_ba=True,
     enable_global_ba=True, mode="fused", device="cuda") over 100 frames of
     the same scene, with the bench config plus bench.py's full-graph caps
     and tpu_fast's 4 window-BA iterations: tracking, a window solve at
     every trigger (6 of them, on the tracker's background solve thread
     and its own CUDA stream), the full-batch solve at the end.  Checks:
     100 frames, one FAST launch per frame, 6 window solves at the window
     ends 20, 36, 52, 68, 84 and 100, none of which raises the cost,
     ba_failures 0, a full BA that lowers it and goes through the edge
     Hessian kernels (edge types x CG steps x LM iterations edge launches,
     (2 x CG steps + 1) x LM iterations vertex passes, counted from zero
     for the run), and metrics() and metrics(refined=True) within the gates
     against the JAX package's numbers; prints the seconds flush waited for
     solves still running.
     Then, on the final map, one window solve and one full BA under
     torch.profiler (kernel launches, device busy share), both solvers on
     the card against the same solve on the CPU, and (5d) one trace of a
     window solve on the tracker's solve thread overlapping tracking steps
     on this thread: the solve stream non-blocking (cuStreamGetFlags), the
     solve's kernels on a stream the steps' never use, no
     cudaDeviceSynchronize from the solve thread.  The tracker packs every
     frame into the dense (4, H, W) wire: this is the run "with no wire
     flags and fused_chunk=1";
  6. the wire path, bench.py's path as bench.py configures it: phase 5's
     config with tpu_fast's wire flags (half-res delta-coded flow, entropy
     wire, drains of 8 chunks) and fused_chunk=4, over an
     InMemoryPackedDataset of the same 100 frames.  Checks as in phase 5
     (window ends and ba_failures included), against the JAX package's
     numbers under the same config.  Prints the
     upload bytes per frame, the wire decode's device time and kernel
     launches per frame for both wires, a whole step's launches, and fps;
  7. the S-stream path: MultiStreamSystem(n_streams=4, enable_local_ba=True)
     on four 40-frame windows of the packed sequence (offsets 0, 7, 14, 21,
     as bench.py --streams 4 takes them), one batched step per frame, each
     stream's window solves on its tracker's own thread and stream.
     Checks: one FAST launch per frame for all four streams; window ends
     20 and 36 and ba_failures 0 for every stream; every stream
     against a solo System on its window and config (each frame's pose
     within 1e-3 m and 0.01 deg, equal object-estimate counts).  Prints
     aggregate and per-stream fps beside the solo fps of the same call,
     launches and device busy share of one batched step and one solo step,
     and peak memory;
  8. the default path: System(cfg, device="cuda"), so mode "reference"
     (the host Tracker) with both BA passes, over the 100 frames of phase 5
     under bench_ba_config, each frame uploaded dense as the JAX tracker
     uploads it.  Checks: 100 frames, one FAST launch per frame, 6 window
     solves none of which raises its cost, a full BA that lowers it, and
     metrics() and metrics(refined=True) within the gates against the JAX
     package's System(mode="reference") (JAX_REF_HOST).  Prints fps, the
     five spans of timing(), peak memory, the host syncs, copies, host
     launch calls and kernel launches per steady frame (torch.profiler;
     the stages replay their graphs from frame 2 on), and the gap between
     one frame on the card and the same frame on the CPU, both started from
     the same tracker state with the same draws;
  9. the options, 25 frames each through System(mode="reference"), BA off,
     each gated against the JAX package's run: configs/omd.yaml on a
     640x480 OMD scene (grid-sampled keypoints: no FAST launch);
     joint_flow=False with depth noise on the bench scene; the bench scene
     rendered through a barrel lens with k1/k2 configured, beside the
     unconfigured control (configured cam_t under 0.4x the control's); and
     the distorted run in mode "fused";
  10. the CLI, `vdo_slam_tpu_torch.run.main` on its synthetic scene on the
     card (report keys and result files), and a checkpoint of the host
     Tracker after frame 6 resumed in a fresh one: every pose equal to the
     uninterrupted run's within 1e-6;
  11. the on-disk input path: the first 26 frames of the bench scene written
     in the reference's layout (io/sequence_writer.py) beside a
     reference-format settings file for bench_ba_config; (a) the native C++
     reader (io/native_loader.py, built with g++ from csrc/loader.cpp)
     against the Python reader on every frame, and each reader's host ms per
     frame; (b) the CLI's positional form, run.main([settings, sequence]),
     on the card in its default mode with both BA passes, gated against the
     JAX CLI on the same files (JAX_REF_DISK); (c) System(mode="fused") over
     the native reader (over the Python reader where the native one cannot
     be built), gated the same way, with the reader's host ms per frame
     while the card tracks; (d) the three drawings of
     eval/visualize.py from (b)'s map.  One FAST launch per frame in (b)
     and (c).  A part whose host library (PIL, matplotlib, g++ with zlib)
     is missing prints "not run" and its reason and counts as not passed;
  12. the multi-device paths, on a list that repeats the one card: (a) a
     copy of phase 5's map from before its full BA, refined by
     full_ba_inplace(devices=["cuda:0"] * n) for n = 1, 2 and 4 (the edges
     sharded over n), each held to phase 5's full BA with the bounds of
     the JAX package's own sharded check (__graft_entry__.py:253-256):
     cost within 10 %, refined poses within 1e-3, and its refined metrics
     gated as phase 5's; t_solve_s of each; then for n = 2 and 4 the
     same solve from FullBAGraphs over [cuda:0] * n (warmup_full_ba
     first) against the eager sharded solve, the cost within 1e-6
     relative, with its host launch calls per chunk and kernels per LM
     iteration (torch.profiler); (b) MultiStreamSystem(n_streams=4,
     devices=["cuda:0", "cuda:0"]) over the first 16 frames of phase 7's
     four windows against the one-device S = 4 run of the same frames:
     two FAST launches per frame (one per group), each frame's pose within
     phase 7's stream bounds, equal estimate counts; (c) the ORB
     orientations, descriptors and Hamming matches and the feature grid
     (ops/orb.py, ops/grid.py) on the card at one bench frame's FAST
     keypoints, against the same on the CPU;
  13. the port's bench (vdo_slam_tpu_torch/bench.py) and pack tool, in
     this process with stdout captured: (a) bench.main(hard=True) at full
     size (bench.py --hard): its JSON line, one FAST launch per frame plus
     the stage probe's, both metric reports gated against JAX_REF_HARD,
     and its first window solve against the rest; (b)
     bench_multistream(6, tag="_throughput") (bench.py --throughput):
     its JSON line, one FAST launch per frame for all six streams, each
     stream gated against JAX_REF_S6, peak memory; (c) the pack tool
     (tools/pack_sequence.py) over phase 11's written sequence with
     tpu_fast's wire flags, PackedDataset(dir) byte-equal to an
     InMemoryPackedDataset of the same frames, and System(mode="fused")
     over the directory against the same over the in-memory frames (poses
     within phase 7's bounds), with the reader's host ms per frame;
  15. the port's driver entry points (vdo_slam_tpu_torch/graft_entry.py,
     the counterpart of __graft_entry__.py): entry()'s step once (one FAST
     launch, a finite pose); dryrun_multichip(8) over cuda:0 eight times
     (the S = 8 step for two frames, stream 0 against the solo step, the
     sharded full BA of a 25-frame 256x192 sequence against one device's)
     with the original's bounds and 42 FAST launches; leg (c)'s cost,
     pose gap, points, edges, motion vertices and dynamic observations
     beside the JAX run's (MULTICHIP_r05.json); (d) leg (c)'s solve from
     the graphs the leg captured against the eager sharded
     solve (cost within 1e-6 relative), and one chunk's host launch calls
     and kernels (torch.profiler); and the kernel held to its plain
     version (atol=0) at the phase's own pyramids: 2 levels of 96x64,
     alone and as S = 1 stacks, and 3 levels of 256x192.
  16. the compiled programs (vdo_slam_tpu_torch/utils/cuda_graph.py; every
     fused tracker, S-stream group and window solve above runs from its
     CUDA graphs), graphed against eager in this process: (a) phase 4's 25
     frames against the same frames through make_frame_step op by op and
     (b) phase 7's four 40-frame windows against the batched step op by
     op, each frame's pose within 1e-3 m and 0.01 deg with equal object
     counts, and equal object estimates over the run; one S = 4 frame's
     host launch calls each way (at most 50 graphed, one FAST kernel);
     (c) the S = 1 chunk steps on the same staged frames each way:
     dispatch and device ms per frame, kernels and host launch calls per
     frame (at most 50 graphed), the FAST kernels the profiler saw
     against KERNEL.launches, peak memory; (d) each
     window-solve tier (builders.WINDOW_TIERS) on a window of phase 5's
     map, graphed against eager, with the solver "schur" (the cost within
     1e-5 relative) and the solver "lm" (within 1e-6): the poses within
     the bounds of (a), wall ms per solve each way, and each graph's
     warm-up and capture seconds and pool bytes.
  17. the full BA's graphs and the host Tracker's stage graphs (PR 14),
     graphed against eager in this process: (a) phase 5's map from
     before its full BA at bench.py's caps, warmup_full_ba (its seconds
     and each capture's record), then the full BA from the graphs against
     the eager full BA (wall ms per solve, solve seconds, host launch
     calls, the cost within 1e-5 relative, the refined poses within the
     bounds of 16a, each capture's edge Hessian launches a replay equal to
     edge types x CG steps x its iterations); (b) phase 8's 100 frames (its run is the graphed
     one) through the host Tracker with its stage functions called
     directly: each frame's pose within the bounds of 16a with the same
     objects, equal object estimates, fps over tracking each way, host
     launch calls, host waits and kernels per steady frame each way (the
     FAST kernels the profiler saw equal to KERNEL.launches), peak memory
     each way, and each stage graph's record.  The bench's --hard (13a)
     prints its full BA's solve from its graphs.  The script prints its
     total seconds before the kernels' line.
Phases 5-7, 12b, 13a and 13b print the seconds the tracker's thread
waited in flush for window solves still running (chip_smoke wraps
FusedTracker._join_ba to time it) and fail on a tracker whose
ba_failures is not 0.
Phase 6 ends with the fused path's stage-time probe
(FusedTracker.calibrate_stage_times) on the wire path's tracker, where
bench.py runs it: the seven spans, each the device time per frame of its
span's CUDA graph, their sum within 0.85-1.15 of the frame
program's, the probe's graphs (one shared pool, its bytes) and its FAST
launches as their records say (each warm-up's, and one per replay of the
mask_update span and of the frame program), the tracker's state
unchanged, timing() non-zero for every span; then each span's kernel
launches and device time run eagerly under torch.profiler, and each
span's graph and the frame program replayed alone under the profiler,
each span within max(25 %, 0.2 ms) of its graph's summed device time
and _frame_ms 0.95-1.25x the frame program's.
Phases 4 and 5 use `bench_config` / `bench_ba_config` (no wire flags);
phases 6 and 7 take bench.py's configs, scene, packed frames and stream
offsets from the port's bench (vdo_slam_tpu_torch/bench.py: bench_config,
multistream_config).  Each phase prints its seconds.
The line before the last holds the kernels' JSON record, the one before it
the card as nvidia-smi reports it; the last line is the device JSON.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# The JAX package's numbers for the same 25 frames and config, taken by
# running vdo_slam_tpu's System(cfg, enable_local_ba=False,
# enable_global_ba=False, mode="fused").run_sequence on the CPU (JAX 0.9.0,
# JAX_PLATFORMS=cpu), with the scene and config that `main_path` builds.
JAX_REF = {
    "cam_t_rpe": 0.0002617016249354637,
    "cam_r_rpe_deg": 0.00022229936464838678,
    "obj_t_rpe": 0.0004971564036774604,
    "obj_r_rpe_deg": 0.0061579478500530865,
    "n_obj_estimates": 48,
}
# The JAX package's numbers for phase 5, taken by running vdo_slam_tpu's
# System(cfg, enable_local_ba=True, enable_global_ba=True,
# mode="fused").run_sequence on the CPU (JAX 0.9.0, JAX_PLATFORMS=cpu) over
# the 100 frames and config that `ba_path` builds: the metrics before
# (after the window solves) and after the full BA, and each window solve's
# cost before and after.
JAX_REF_BA = {
    "initial": {
        "cam_t_rpe": 0.00024307842081164633,
        "cam_r_rpe_deg": 0.00015362603113119517,
        "obj_t_rpe": 0.0004485694268677274,
        "obj_r_rpe_deg": 0.00684782311929928,
        "n_obj_estimates": 136,
    },
    "refined": {
        "cam_t_rpe": 0.00024372028437102944,
        "cam_r_rpe_deg": 0.0001517146937128464,
        "obj_t_rpe": 0.0003854773732361055,
        "obj_r_rpe_deg": 0.0026634063385592706,
        "n_obj_estimates": 136,
    },
    "window_cost": [(1.423598289489746, 1.065406084060669),
                    (0.5091784596443176, 0.41150006651878357),
                    (0.2155500203371048, 0.19330984354019165),
                    (0.35663899779319763, 0.3334866166114807),
                    (0.7532920837402344, 0.654660701751709),
                    (0.3620983362197876, 0.31730034947395325)],
}
# The JAX package's numbers for phase 6: the same run under bench.py's
# config (the port's bench_config: tpu_fast's wire flags, fused_chunk=4)
# over an InMemoryPackedDataset, printed by `JAX_PLATFORMS=cpu python
# tools/jax_wire_reference.py` (JAX 0.9.0 on the CPU).
JAX_REF_WIRE = {
    "initial": {
        "cam_t_rpe": 0.0002674052025226827,
        "cam_r_rpe_deg": 0.00024964885502388036,
        "obj_t_rpe": 0.00047633394173959354,
        "obj_r_rpe_deg": 0.007022382614301775,
        "n_obj_estimates": 136,
    },
    "refined": {
        "cam_t_rpe": 0.00026716805567061403,
        "cam_r_rpe_deg": 0.0002394885450558477,
        "obj_t_rpe": 0.00038233257702599717,
        "obj_r_rpe_deg": 0.0021332038818608077,
        "n_obj_estimates": 136,
    },
    "window_cost": [(0.7353934049606323, 0.5556303858757019),
                    (0.23227889835834503, 0.18792425096035004),
                    (0.01417376846075058, 0.011513757519423962),
                    (0.07281715422868729, 0.06883376836776733),
                    (0.39788001775741577, 0.2842198610305786),
                    (0.060070980340242386, 0.04095756635069847)],
    "wire_bytes_per_frame": 1529564,
}
# The JAX package's numbers for phases 8 and 9: System(mode="reference")
# (and, for "distorted_fused", mode "fused") on the same scenes and configs,
# printed by `JAX_PLATFORMS=cpu python tools/jax_reference_mode.py` (JAX
# 0.9.0 on the CPU).  "reference": 100 frames with both BA passes, the
# metrics before and after the full BA; the others 25 frames, BA off.
JAX_REF_HOST = {
    "reference": {
        "initial": {
            "cam_t_rpe": 0.00024247035099750648,
            "cam_r_rpe_deg": 0.00016012295710519524,
            "obj_t_rpe": 0.0004426540884143084,
            "obj_r_rpe_deg": 0.006260969186353022,
            "n_obj_estimates": 136,
        },
        "refined": {
            "cam_t_rpe": 0.00024323345778188326,
            "cam_r_rpe_deg": 0.00015609814761453891,
            "obj_t_rpe": 0.0003848462170828819,
            "obj_r_rpe_deg": 0.0024580376888249816,
            "n_obj_estimates": 136,
        },
        "window_solves": 6,
    },
    "omd": {"cam_t_rpe": 0.0002792332855918336,
            "cam_r_rpe_deg": 0.0003302509176934207,
            "obj_t_rpe": 0.0006180943200888578,
            "obj_r_rpe_deg": 0.007428061283589659,
            "n_obj_estimates": 48},
    "nonjoint": {"cam_t_rpe": 0.0002598692791910241,
                 "cam_r_rpe_deg": 0.0002873487476294675,
                 "obj_t_rpe": 0.0004821884528306934,
                 "obj_r_rpe_deg": 0.004928150145535853,
                 "n_obj_estimates": 48},
    "distorted": {"cam_t_rpe": 0.0029093472802023275,
                  "cam_r_rpe_deg": 0.0018210809582279639,
                  "obj_t_rpe": 0.00281619685968811,
                  "obj_r_rpe_deg": 0.006107384404701737,
                  "n_obj_estimates": 48},
    "control": {"cam_t_rpe": 0.02716557712004608,
                "cam_r_rpe_deg": 0.03372432497959165,
                "obj_t_rpe": 0.02310873419143415,
                "obj_r_rpe_deg": 0.3489464722573492,
                "n_obj_estimates": 48},
    "distorted_fused": {"cam_t_rpe": 0.0029932012980219366,
                        "cam_r_rpe_deg": 0.002184947983457314,
                        "obj_t_rpe": 0.0027957632458613566,
                        "obj_r_rpe_deg": 0.006363972357767777,
                        "n_obj_estimates": 48},
}
# The JAX package's numbers for phase 11: the CLI (run.main([settings,
# sequence]), default mode, both BA passes) and System(mode="fused") (BA
# off) over the same written sequence, printed by `JAX_PLATFORMS=cpu python
# tools/jax_reference_mode.py --runs disk_cli disk_fused` (JAX 0.9.0 on the
# CPU).
JAX_REF_DISK = {
    "disk_cli": {
        "initial": {
            "cam_t_rpe": 0.0002621669039109316,
            "cam_r_rpe_deg": 0.0002380790122050489,
            "obj_t_rpe": 0.00048814878118719207,
            "obj_r_rpe_deg": 0.0054588456835171105,
            "n_obj_estimates": 48
        },
        "refined": {
            "cam_t_rpe": 0.0002614623085740237,
            "cam_r_rpe_deg": 0.00023588547731864023,
            "obj_t_rpe": 0.0004063367244574086,
            "obj_r_rpe_deg": 0.002151687126918735,
            "n_obj_estimates": 48
        },
    },
    "disk_fused": {
        "initial": {
            "cam_t_rpe": 0.0002615847821227058,
            "cam_r_rpe_deg": 0.00022235377040079842,
            "obj_t_rpe": 0.0004974820834225587,
            "obj_r_rpe_deg": 0.006150584786304152,
            "n_obj_estimates": 48
        },
    },
}
# The JAX package's numbers for phase 13a, the port's bench --hard:
# bench.py's degraded scene (bench.py:246-259) under bench.py's config,
# System(mode="fused") with both BA passes, printed by `JAX_PLATFORMS=cpu
# python tools/jax_wire_reference.py --hard` (JAX 0.9.0 on the CPU, numpy
# 2.0.2).
JAX_REF_HARD = {
    "initial": {
        "cam_t_rpe": 0.01196788325210891,
        "cam_r_rpe_deg": 0.02841260962552219,
        "obj_t_rpe": 0.023125777803361416,
        "obj_r_rpe_deg": 0.9013225063652698,
        "n_obj_estimates": 100
    },
    "refined": {
        "cam_t_rpe": 0.011967585026881694,
        "cam_r_rpe_deg": 0.02841062758825719,
        "obj_t_rpe": 0.005738687867997214,
        "obj_r_rpe_deg": 0.40438695420666015,
        "n_obj_estimates": 100
    },
    "window_solves": 6,
}
# The JAX package's numbers for phase 13b, the port's bench --throughput:
# bench_multistream(6)'s config, windows and drive (bench.py:40-162), JAX
# MultiStreamSystem with window BA on one device, each stream's metrics,
# printed by `JAX_PLATFORMS=cpu python tools/jax_wire_reference.py
# --streams 6` (JAX 0.9.0 on the CPU).  `--streams 4` prints the first four
# of these six streams, digit for digit.
JAX_REF_S6 = {
    "offsets": [0, 7, 14, 21, 28, 35],
    "window_solves": [2, 2, 2, 2, 2, 2],
    "per_stream": [
        {
            "cam_t_rpe": 0.0002774139771607658,
            "cam_r_rpe_deg": 0.0003604535232664692,
            "obj_t_rpe": 0.0005370200723470924,
            "obj_r_rpe_deg": 0.0071678554471188,
            "n_obj_estimates": 76
        },
        {
            "cam_t_rpe": 0.000256539277570662,
            "cam_r_rpe_deg": 0.0003736250420942366,
            "obj_t_rpe": 0.0005133838619388241,
            "obj_r_rpe_deg": 0.0061716552587219135,
            "n_obj_estimates": 70
        },
        {
            "cam_t_rpe": 0.0002470560539292845,
            "cam_r_rpe_deg": 0.00025800250365700143,
            "obj_t_rpe": 0.0004914399549072127,
            "obj_r_rpe_deg": 0.006928687104786842,
            "n_obj_estimates": 62
        },
        {
            "cam_t_rpe": 0.0002522383380191672,
            "cam_r_rpe_deg": 0.00023492160789941868,
            "obj_t_rpe": 0.0005551935832375999,
            "obj_r_rpe_deg": 0.00771473223371896,
            "n_obj_estimates": 55
        },
        {
            "cam_t_rpe": 0.00027169363418987275,
            "cam_r_rpe_deg": 0.00021249527077345467,
            "obj_t_rpe": 0.0005146374863519062,
            "obj_r_rpe_deg": 0.0068668614894156835,
            "n_obj_estimates": 48
        },
        {
            "cam_t_rpe": 0.00025597501917137816,
            "cam_r_rpe_deg": 0.00023725964763387462,
            "obj_t_rpe": 0.00047656611796134175,
            "obj_r_rpe_deg": 0.00498266563677098,
            "n_obj_estimates": 39
        },
    ],
}
DIST = (-0.28, 0.07, 0.0, 0.0, 0.0)    # tests/test_pipeline_e2e.py:258
N_OPT_FRAMES = 25
RESUME_TOL = 1e-6
N_BA_FRAMES = 100
N_STREAMS, N_STREAM_FRAMES = 4, 40   # bench.py --streams 4 (bench.py:40, 110)
N_THROUGHPUT = 6                      # bench.py --throughput (bench.py:451)
PHASE13_BUDGET_S = 120
N_GRAFT = 8               # phase 15: dryrun_multichip(8) as __graft_entry__
PHASE15_BUDGET_S = 120
STREAM_T_TOL_M, STREAM_R_TOL_DEG = 1e-3, 0.01
# window ends (archive lengths at the triggers, Tracking.cc:1168-1183) of
# 100 frames and of 40 frames with window 20 / overlap 4
BA_WINDOW_ENDS = [20, 36, 52, 68, 84, 100]
STREAM_WINDOW_ENDS = [20, 36]
OVERLAP_STEPS = 6      # phase 5d: most tracking steps queued during a solve
# A metric passes if it is within 2x the JAX number or under this floor,
# whichever is looser.
ABS_FLOOR = {"cam_t_rpe": 1e-3, "cam_r_rpe_deg": 0.01, "obj_t_rpe": 5e-3,
             "obj_r_rpe_deg": 0.05}
N_FRAMES = 25
N_DISK = 25                  # frames tracked from disk (26 written)
PROBE_ROUNDS, PROBE_ITERS = 2, 8
# phase 6c: each span within max(25 %, 0.2 ms) of the summed device time
# of its graph replayed alone under the profiler; _frame_ms 0.95-1.25x the
# frame program's (the events also see the gaps between the graph's ~6,500
# kernel nodes, ~15 % of the kernels' summed time on an H100); the
# spans summing to 0.85-1.15 of _frame_ms
PROBE_SPAN_RTOL, PROBE_SPAN_ATOL_MS = 0.25, 0.2
PROBE_FRAME_RATIO = (0.95, 1.25)
PROBE_COVER = (0.85, 1.15)
SCENE_FIELDS = ("rgb", "depth", "flow", "mask", "T_wc_gt", "obj_H_gt",
                "obj_pose_gt")
W, H = 1242, 375
TH_INI, TH_MIN = 20 / 255.0, 7 / 255.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12     # H100 SXM data sheet, fp32 outside tensor cores
# fp32 operations of the kernel (csrc/fast_score.cu): each interior pixel
# 4 subtractions, 8 compass compares and 2 output compares; each entry of
# the bright list 16 subtractions, 80 min/max for the 16 arcs and 1 compare;
# a dark entry also 16 negations.
OPS_PER_PIXEL, OPS_PER_BRIGHT, OPS_PER_DARK = 14, 97, 113
KERNEL_NAME = "fast_pyramid"  # in the profiler's name of the CUDA kernel


def card_line() -> str:
    """The card as nvidia-smi gives its name and power limit."""
    from vdo_slam_tpu_torch.bench import card_line as port_card_line

    return port_card_line(torch.device("cuda", 0))


def bench_config(width: int = W, height: int = H):
    """bench.py's config (bench.py:262-284) with tpu_fast's LM budgets and
    no wire flags, so frames travel on the dense (4, H, W) wire: phase 4
    (the backend capacities do not matter with BA off)."""
    from vdo_slam_tpu_torch.config import (KITTI, ShapeConfig, TrackingConfig,
                                           VDOConfig)

    cfg = VDOConfig()
    return cfg.replace(
        camera=dataclasses.replace(
            cfg.camera, fx=721.5377, fy=721.5377, cx=width / 2.0,
            cy=height / 2.0, width=width, height=height, bf=387.5744),
        tracking=dataclasses.replace(TrackingConfig(), dataset=KITTI,
                                     depth_map_factor=256.0),
        shapes=ShapeConfig(),
        solver=dataclasses.replace(cfg.solver, lm_iters=10, lm_iters_obj=6),
    )


def bench_ba_config(width: int = W, height: int = H):
    """bench_config() with bench.py's fixed full-graph capacities
    (bench.py:279-282) and tpu_fast's 4 window-BA iterations: phase 5."""
    cfg = bench_config(width, height)
    return cfg.replace(backend=dataclasses.replace(
        cfg.backend, full_obs_cap=245760, full_ter_cap=131072,
        full_point_cap=122880, full_motion_cap=192, full_smo_cap=192,
        local_iters=4))


def stream_offsets(n_total: int, n_streams: int = N_STREAMS) -> list[int]:
    """Where each stream's window starts (the port's bench, as bench.py:110
    takes them)."""
    from vdo_slam_tpu_torch import bench as port_bench

    return port_bench.stream_offsets(n_total, n_streams, N_STREAM_FRAMES)


def stream_first_grays(pds, cfg, device, n_streams: int = N_STREAMS):
    """(S, H, W): the decoded gray of each stream's first frame, what the
    S-stream step hands the FAST kernel at frame 0."""
    from vdo_slam_tpu_torch.io.packing import unpack_frame, wire_kwargs

    bufs = np.stack([np.asarray(pds[o].packed)
                     for o in stream_offsets(len(pds), n_streams)])
    return unpack_frame(torch.from_numpy(bufs).to(device), hw=(H, W),
                        **wire_kwargs(cfg.tracking))[0]


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int = 5, match: str | None = None,
               between=None, per: str | None = None) -> float:
    """Device time of fn per call: the sum of its kernels' durations under
    torch.profiler (CUDA activity only), without the host's launch cost.
    `between` runs before each call (an L2 flush); `match` keeps only the
    kernels whose name holds it, so the flush is not counted.  Where fn
    launches the kernel named `per` once per call, the sum is divided by
    the launches of it that the profiler recorded, not by reps: a session
    now and then records fewer device events than ran (a one-level time
    once read 0), and would read low."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        calls = (reps if per is None
                 else sum(e.count for e in events if per in e.key))
        if calls:
            us = sum(e.self_device_time_total for e in events
                     if match is None or match in e.key)
            return us / calls / 1e3
    raise RuntimeError(f"the profiler recorded no {per} launch in 5 "
                       f"sessions of {reps} calls")


def compass_shares(levels, t: float):
    """Per level (bright, dark, listed, interior, active warps, warps): the
    interior pixels that the kernel's compass test at t puts on its bright
    list, on its dark list, and on either (the others leave after 5 loads);
    and the warps (32-pixel row segments of a tile) that hold a listed
    pixel, all of which would run the arc code without the lists."""
    out = []
    for g in levels:
        if g.ndim == 3:    # (S, H_l, W_l): the sums over the S images
            per = [compass_shares([x], t)[0] for x in g]
            out.append(tuple(sum(r[k] for r in per) for k in range(6)))
            continue
        Hl, Wl = g.shape
        c = g[3:Hl - 3, 3:Wl - 3]
        comp = [g[3 + dy:Hl - 3 + dy, 3 + dx:Wl - 3 + dx] - c
                for dx, dy in ((0, -3), (3, 0), (0, 3), (-3, 0))]
        bright = torch.zeros_like(c, dtype=torch.bool)
        dark = torch.zeros_like(bright)
        for i in range(4):
            a, b = comp[i], comp[(i + 1) % 4]
            bright |= (a > t) & (b > t)
            dark |= (a < -t) & (b < -t)
        listed = bright | dark
        full = torch.zeros((Hl, -(-Wl // 32) * 32), dtype=torch.bool,
                           device=g.device)
        full[3:Hl - 3, 3:Wl - 3] = listed
        warps = full.view(Hl, -1, 32).any(-1)
        out.append((int(bright.sum()), int(dark.sum()), int(listed.sum()),
                    c.numel(), int(warps.sum()), warps.numel()))
    return out


def _pyramids(scene, device, frames):
    from vdo_slam_tpu_torch.ops import fast

    return [fast.pyramid(torch.from_numpy(scene.rgb[f]).to(device), 8, 1.2)
            for f in frames]


def held(name, img, k_ini, k_min, ti, tm) -> float:
    """The kernel's two score maps `k_ini`, `k_min` of `img` against the
    plain version's (atol=0); their largest abs error."""
    from vdo_slam_tpu_torch.ops import fast

    p_ini, p_min = fast.fast_score(img, ti), fast.fast_score(img, tm)
    err = max(float((k_ini - p_ini).abs().max()),
              float((k_min - p_min).abs().max()))
    if not (torch.equal(k_ini, p_ini) and torch.equal(k_min, p_min)):
        raise RuntimeError(f"{name}: kernel != plain, max abs err {err}")
    nz = float((p_min > 0).float().mean())
    print(f"kernel == plain (atol=0): {name}, corner share {nz:.4f}")
    return err


def check_kernel(scene, device, stream_grays: dict) -> tuple[float, dict]:
    """Phase 3a: kernel == plain version (atol=0), one level per launch and
    one launch per pyramid.  Returns the largest abs error seen, and per S
    the largest over the S-stream pyramid that the S-stream step launches
    at its first frame (`stream_grays` {S: (S, H, W)}: phase 7's S = 4 and
    phase 13b's S = 6), held stream by stream."""
    from vdo_slam_tpu_torch.ops import fast
    from vdo_slam_tpu_torch.ops.fast_cuda import (KERNEL, fast_score_pair,
                                                  fast_score_pyramid)

    rng0, rng1, rng2 = (np.random.default_rng(s) for s in (0, 1, 2))
    cases = [
        ("binary 120x200", (rng0.random((120, 200)) > 0.5), TH_INI, TH_MIN),
        ("binary 97x131", (rng1.random((97, 131)) > 0.5), 15 / 255.0,
         TH_MIN),
        ("binary batch 3x64x150", (rng2.random((3, 64, 150)) > 0.5), TH_INI,
         TH_MIN),
    ]
    levels = _pyramids(scene, device, [0])[0]
    cases += [(f"level {l} {tuple(g.shape)}", g, TH_INI, TH_MIN)
              for l, g in enumerate(levels)]
    cases.append(("frames 0-2 batched S=3",
                  torch.from_numpy(np.ascontiguousarray(scene.rgb[:3])),
                  TH_INI, TH_MIN))

    max_err = 0.0
    for name, img, ti, tm in cases:
        g = (img if torch.is_tensor(img)
             else torch.from_numpy(img.astype(np.float32))).to(device)
        before = KERNEL.launches
        k_ini, k_min = fast_score_pair(g, ti, tm)
        torch.cuda.synchronize()
        if KERNEL.launches != before + 1:
            raise RuntimeError(f"{name}: launch counter did not go up")
        max_err = max(max_err, held(name, g, k_ini, k_min, ti, tm))

    batch = [torch.stack(lv).contiguous()
             for lv in zip(*_pyramids(scene, device, [0, 1, 2]))]
    for what, lv in (("frame 0", levels), ("frames 0-2 S=3", batch)):
        before = KERNEL.launches
        pairs = fast_score_pyramid(lv, TH_INI, TH_MIN)
        torch.cuda.synchronize()
        if KERNEL.launches != before + 1:
            raise RuntimeError(f"pyramid of {what}: "
                               f"{KERNEL.launches - before} launches, want 1")
        for l, (g, (k_ini, k_min)) in enumerate(zip(lv, pairs)):
            max_err = max(max_err, held(
                f"one launch for the pyramid of {what}, level {l} "
                f"{tuple(g.shape)}", g, k_ini, k_min, TH_INI, TH_MIN))

    err_batched = {}
    for S, grays in stream_grays.items():
        lvs = fast.pyramid(grays, 8, 1.2)
        before = KERNEL.launches
        pairs = fast_score_pyramid(lvs, TH_INI, TH_MIN)
        torch.cuda.synchronize()
        if KERNEL.launches != before + 1:
            raise RuntimeError(f"S={S} pyramid: "
                               f"{KERNEL.launches - before} launches, want 1")
        err_batched[S] = 0.0
        for l, (g, (k_ini, k_min)) in enumerate(zip(lvs, pairs)):
            if not g.is_contiguous():
                raise RuntimeError(f"batched level {l} is not contiguous")
            for st in range(S):
                err_batched[S] = max(err_batched[S], held(
                    f"one launch for the S={S} pyramid of the streams' "
                    f"first frames, stream {st}, level {l} "
                    f"{tuple(g[st].shape)}",
                    g[st], k_ini[st], k_min[st], TH_INI, TH_MIN))
    return max_err, err_batched


def _bound_ms(levels) -> tuple[float, float, float]:
    """(byte ms, operation ms, bound ms) of one launch over `levels`: each
    pixel read once and written twice over the memory rate, and the fp32
    operations this data needs (what the compass test lets through) over
    the fp32 rate."""
    n_px = sum(g.numel() for g in levels)
    shares = compass_shares(levels, min(TH_INI, TH_MIN))
    n_bright, n_dark, _, n_interior = (sum(r[k] for r in shares)
                                       for k in range(4))
    byte_ms = 12.0 * n_px / HBM_BYTES_PER_S * 1e3
    ops_ms = ((OPS_PER_PIXEL * n_interior + OPS_PER_BRIGHT * n_bright
               + OPS_PER_DARK * n_dark) / FP32_OPS_PER_S * 1e3)
    return byte_ms, ops_ms, max(byte_ms, ops_ms)


def time_batched(scene, device, card: str, stream_grays: dict) -> dict:
    """Phase 3c: the kernel at S=1 and at each S of `stream_grays` in one
    call, interleaved: device time per launch and the share of each
    launch's byte bound."""
    from vdo_slam_tpu_torch.ops import fast
    from vdo_slam_tpu_torch.ops.fast_cuda import fast_score_pyramid

    first = next(iter(stream_grays.values()))[0].contiguous()
    lv = {1: fast.pyramid(first, 8, 1.2)}
    lv.update({S: fast.pyramid(g, 8, 1.2) for S, g in stream_grays.items()})
    ms = {S: [] for S in lv}
    for S in list(lv) + list(lv)[::-1]:
        ms[S].append(_device_ms(
            lambda: fast_score_pyramid(lv[S], TH_INI, TH_MIN), 20,
            per=KERNEL_NAME))
    out = {}
    for S in lv:
        byte_ms, ops_ms, bound = _bound_ms(lv[S])
        best = min(ms[S])
        out[S] = {"ms": best, "bound_ms": bound}
        print(f"pyramid at S={S} (decoded first frames of the streams), one "
              f"launch: {best:.5f} ms on the device (runs "
              f"{', '.join(f'{x:.5f}' for x in ms[S])}); bound "
              f"{bound * 1e3:.3f} us (bytes {byte_ms * 1e3:.3f} us, "
              f"operations {ops_ms * 1e3:.3f} us); share of the bound "
              f"reached {bound / best:.3f} [{card}]")
    for S in stream_grays:
        print(f"S={S} launch / S=1 launch: {out[S]['ms'] / out[1]['ms']:.3f}x "
              f"the device time for {S}x the pixels [{card}]")
    return out


def time_pyramid(scene, device, card: str, reps: int = 20) -> dict:
    """Phase 3b: the 8-level pyramid of frame 0, per frame: the kernel (one
    launch) and the plain version (two fast_score calls per level), device
    and event time, against the kernel's bound; what the compass test lets
    through; one-level launches per level."""
    from vdo_slam_tpu_torch.ops import fast
    from vdo_slam_tpu_torch.ops.fast_cuda import (fast_score_pair,
                                                  fast_score_pyramid)

    levels = _pyramids(scene, device, [0])[0]
    n_px = sum(g.numel() for g in levels)
    shares = compass_shares(levels, min(TH_INI, TH_MIN))
    n_bright, n_dark, n_listed, n_interior, n_warp, n_warps = (
        sum(r[k] for r in shares) for k in range(6))
    byte_ms, ops_ms, bound_ms = _bound_ms(levels)
    bound_by = "bytes" if byte_ms >= ops_ms else "operations"

    def kernel():
        return fast_score_pyramid(levels, TH_INI, TH_MIN)

    def plain():
        return [(fast.fast_score(g, TH_INI), fast.fast_score(g, TH_MIN))
                for g in levels]

    # a process's first profiler session has read kernel times longer than
    # the sessions after it: spend it on something else
    _device_ms(lambda: torch.ones(4, device=device) + 1)
    # kernel, plain, plain, kernel: each side once early and once late
    ev = {"kernel": [], "plain": []}
    dev = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        fn = kernel if name == "kernel" else plain
        ev[name].append(_time_ms(fn, reps))
        dev[name].append(_device_ms(fn, 20, per=KERNEL_NAME)
                         if name == "kernel" else _device_ms(fn, 5))
    k_ev, k_dev = min(ev["kernel"]), min(dev["kernel"])
    p_ev, p_dev = min(ev["plain"]), min(dev["plain"])
    # reading 64 MB (> the 50 MB L2) evicts the levels and leaves no dirty
    # lines for the kernel to write back
    flush = torch.ones(64 * 2**20 // 4, device=device)
    cold = _device_ms(kernel, match=KERNEL_NAME, per=KERNEL_NAME,
                      between=lambda: flush.sum())
    flat = [torch.full_like(g, 0.5) for g in levels]
    flat_ms = _device_ms(lambda: fast_score_pyramid(flat, TH_INI, TH_MIN),
                         per=KERNEL_NAME)

    def runs(xs):
        return ", ".join(f"{x:.5f}" for x in xs)

    print(f"pyramid of 8 levels per frame ({n_px} px), one launch: "
          f"{k_dev:.5f} ms on the device (profiler; runs "
          f"{runs(dev['kernel'])}), {k_ev:.5f} ms by CUDA events over "
          f"{reps} back-to-back calls, host call included (runs "
          f"{runs(ev['kernel'])}) [{card}]")
    print(f"pyramid bound: {bound_ms * 1e3:.3f} us by {bound_by} (12 B/px "
          f"at {HBM_BYTES_PER_S / 1e12} TB/s: {byte_ms * 1e3:.3f} us; fp32 "
          f"operations of this frame at {FP32_OPS_PER_S / 1e12} TFLOP/s: "
          f"{ops_ms * 1e3:.3f} us); share of the bound reached "
          f"{bound_ms / k_dev:.3f} [{card}]")
    print(f"pyramid with the L2 flushed (read) before each call: "
          f"{cold:.5f} ms on "
          f"the device; flat image (every pixel leaves at the compass "
          f"test): {flat_ms:.5f} ms [{card}]")
    print(f"plain version per frame: {p_dev:.5f} ms on the device (runs "
          f"{runs(dev['plain'])}), {p_ev:.5f} ms by CUDA events [{card}]")
    print(f"compass test at min(th_ini, th_min): {n_listed / n_interior:.4f}"
          f" of interior pixels listed ({n_bright} bright, {n_dark} dark "
          f"entries), {n_warp / n_warps:.4f} of warps hold one")
    for l, (g, row) in enumerate(zip(levels, shares)):
        one = _device_ms(lambda: fast_score_pair(g, TH_INI, TH_MIN),
                         per=KERNEL_NAME)
        lv_bound = 12.0 * g.numel() / HBM_BYTES_PER_S * 1e6
        print(f"level {l} {tuple(g.shape)}: one-level launch {one:.5f} ms on "
              f"the device, byte bound {lv_bound:.3f} us; listed "
              f"{row[2] / row[3]:.4f} of pixels, {row[4] / row[5]:.4f} of "
              f"warps [{card}]")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(f"after timing, clocks.sm, clocks.max.sm, power.draw, "
          f"temperature.gpu: {clocks.stdout.strip()}")
    return {"ms": k_dev, "plain_ms": p_dev, "bound_ms": bound_ms,
            "bound_by": bound_by}


class _View:
    """n frames of a dataset from `start` (bench.py:100-108)."""

    def __init__(self, base, start: int, n: int):
        self.base, self.start, self.n = base, start, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.base[self.start + i]


WARM = 3


def _kernel_times(fn, reps: int) -> dict:
    """{kernel name: (launches, mean device ms)} of the kernels fn launches
    under torch.profiler (CUDA activity only), over reps calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total / e.count / 1e3)
            for e in prof.key_averages() if e.count}


def hv_bytes(g, blocks, weights, t) -> tuple[int, int, int]:
    """The floor bytes of one product H t + damp * t (edge fields and the
    vertex rows), of its edge launches alone, and of one block-Jacobi
    apply: every weight read once, and the indices and Jacobian blocks of
    every edge whose weight is not 0 (a zero-weight edge adds nothing to
    the product; a block of edge stride 0 reads nothing; a transposed view
    reads its 9 floats), each tangent and damping row read once, each
    output row written once."""
    from vdo_slam_tpu_torch.ops import edge_hessian_cuda as EH

    edges = 0
    for edge, inc in EH.INCIDENCE.items():
        w = weights[edge]
        live = int((w != 0).sum())
        per = 8 * len(inc)
        for J, _, _ in inc:
            b = blocks[J]
            per += 0 if b.stride(0) == 0 else 4 * b.shape[1] * b.shape[2]
        edges += 4 * w.shape[0] + live * per
    rows = sum(4 * x.numel() for x in (t.poses, t.motions, t.points))
    blocks_jacobi = sum(4 * x.numel() * w
                        for x, w in ((t.poses, 6), (t.motions, 6),
                                     (t.points, 3)))
    return edges + 3 * rows, edges, blocks_jacobi + 2 * rows


def edge_hessian_phase(device, card: str, reps: int = 20) -> dict:
    """Phase 3b: the edge Hessian-vector kernels (csrc/edge_hessian.cu) at
    the 1,028-frame refine's caps, on a graph of about a drive's counts
    (tests/hv_graphs.py) with the blocks, weights, damping and inverted
    block-Jacobi blocks of factor_graph's own linearisation: each output
    against the plain version on the card (within 1e-5 relative), then
    one product's launch set (the vertex pass and six edge launches) and
    one block-Jacobi apply timed by CUDA events and by the profiler,
    beside their byte bounds and the plain versions' times."""
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import hv_graphs
    from vdo_slam_tpu_torch.backend import factor_graph as fg
    from vdo_slam_tpu_torch.ops import edge_hessian_cuda as EH

    EH.KERNEL.build()
    print(f"edge Hessian kernels built and loaded in "
          f"{EH.KERNEL.build_seconds:.2f} s")
    for line in EH.KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas: {line.strip()}")
    t0 = time.perf_counter()
    g, v = hv_graphs.upload(*hv_graphs.make_graph(
        seed=11, caps=hv_graphs.REFINE_CAPS, **hv_graphs.REFINE_SHAPE),
        device)
    F, M, P = v.poses.shape[0], v.motions.shape[0], v.points.shape[0]
    _, weights, blocks = fg._linearize(g, v, fg.LMParams())
    D = fg._block_diag(g, blocks, weights, F, M, P)
    damp = fg._damped_diag(D, torch.full((), 1e-4, device=device))
    Dinv = fg._invert_precond(tuple(
        x + torch.diag_embed(d)
        for x, d in zip(D, (damp.poses, damp.motions, damp.points))))
    t = hv_graphs.random_tangent(v, seed=2)
    torch.cuda.synchronize()
    print(f"graph at the refine's caps: F {F}, M {M}, P {P}, edges "
          f"{ {e: weights[e].shape[0] for e in EH.INCIDENCE} } (of them "
          f"weight 0: { {e: int((weights[e] == 0).sum()) for e in EH.INCIDENCE} }"
          f"), made in "
          f"{time.perf_counter() - t0:.1f} s")

    def kern():
        return EH.hessian_vector(g, blocks, weights, t, damp)

    def plain():
        return EH.damped_plain(EH.matvec_plain(g, blocks, weights, t), damp,
                               t)

    def pre_kern():
        return EH.block_jacobi(Dinv, t)

    def pre_plain():
        return EH.precond_plain(Dinv, t)

    gap = max(float((a - b).abs().max()) / float(b.abs().max())
              for a, b in zip(kern(), plain()))
    gap_pre = max(float((a - b).abs().max()) / float(b.abs().max())
                  for a, b in zip(pre_kern(), pre_plain()))
    print(f"H t + damp t against the plain version on the card: largest "
          f"gap {gap:.3e} of each output's largest entry; Dinv r "
          f"{gap_pre:.3e}")
    if not (gap <= 1e-5 and gap_pre <= 1e-5):
        raise RuntimeError("the edge Hessian kernels depart from their "
                           "plain version")
    hv_all, hv_edges, pre_b = hv_bytes(g, blocks, weights, t)
    out = {"ms": _time_ms(kern, reps), "plain_ms": _time_ms(plain, reps),
           "pre_ms": _time_ms(pre_kern, reps),
           "pre_plain_ms": _time_ms(pre_plain, reps)}
    times = _kernel_times(kern, reps)
    edge_ms = sum(n * ms for k, (n, ms) in times.items()
                  if "edge_hv_kernel" in k) / reps
    vx_ms = sum(n * ms for k, (n, ms) in times.items()
                if "vertex_kernel" in k) / reps
    pre_dev = sum(n * ms for k, (n, ms) in _kernel_times(
        pre_kern, reps).items()) / reps
    plain_dev = sum(n * ms for _, (n, ms) in _kernel_times(
        plain, reps).items()) / reps
    pre_plain_dev = sum(n * ms for _, (n, ms) in _kernel_times(
        pre_plain, reps).items()) / reps
    bound = hv_all / HBM_BYTES_PER_S * 1e3
    bound_edges = hv_edges / HBM_BYTES_PER_S * 1e3
    bound_pre = pre_b / HBM_BYTES_PER_S * 1e3
    for k, (n, ms) in sorted(times.items()):
        print(f"  {k[:90]}: {n / reps:.0f} a product, {ms:.4f} ms each on "
              f"the device")
    print(f"one product H t + damp t (7 launches): {out['ms']:.4f} ms by "
          f"events, {edge_ms + vx_ms:.4f} ms on the device (edges "
          f"{edge_ms:.4f}, vertex pass {vx_ms:.4f}); byte bound "
          f"{bound:.4f} ms ({hv_all / 1e9:.3f} GB at 3.35 TB/s; edges alone "
          f"{bound_edges:.4f} ms), share {bound / (edge_ms + vx_ms):.3f}; "
          f"the plain version {out['plain_ms']:.4f} ms by events, "
          f"{plain_dev:.4f} ms on the device [{card}]")
    print(f"one block-Jacobi apply Dinv r (1 launch): {out['pre_ms']:.4f} ms "
          f"by events, {pre_dev:.4f} ms on the device; byte bound "
          f"{bound_pre:.4f} ms, share {bound_pre / pre_dev:.3f}; the plain "
          f"version {out['pre_plain_ms']:.4f} ms by events, "
          f"{pre_plain_dev:.4f} ms on the device [{card}]")
    out.update(device_ms=edge_ms + vx_ms, edge_ms=edge_ms, vertex_ms=vx_ms,
               plain_device_ms=plain_dev, pre_device_ms=pre_dev,
               pre_plain_device_ms=pre_plain_dev, bound_ms=bound,
               pre_bound_ms=bound_pre, gap=gap, gap_pre=gap_pre)
    del g, v, blocks, weights, D, Dinv, t
    torch.cuda.empty_cache()
    return out


def _timed_run(run, ds_list):
    """bench.py's timing (bench.py:328-350): `run` over the first WARM
    frames of every dataset, then, timed on the host clock between two
    synchronizes, over the rest.  Returns (frames per second of one
    dataset's rest, what the two runs returned)."""
    n = len(ds_list[0])
    first = run([_View(d, 0, WARM) for d in ds_list])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rest = run([_View(d, WARM, n - WARM) for d in ds_list])
    torch.cuda.synchronize()
    return (n - WARM) / (time.perf_counter() - t0), (first, rest)


def main_path(scene, cfg, device, card: str) -> dict:
    """Phase 4: the port's System over the 25-frame bench scene."""
    from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL
    from vdo_slam_tpu_torch.pipeline import System

    ds = _View(SyntheticDataset(scene, depth_map_factor=256.0, bf=387.5744),
               0, N_FRAMES)
    sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  mode="fused", device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.launches = 0
    fps, (first, rest) = _timed_run(lambda d: sysm.run_sequence(d[0]), [ds])
    reports = first + rest
    launches = KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"tracking fps after {WARM} warm frames: {fps:.3f} "
          f"({N_FRAMES - WARM} frames, host clock, each frame packed into "
          f"the dense wire and staged as it comes) [{card}]")
    print(f"peak device memory (max_memory_allocated): {peak} bytes "
          f"({peak / 2**20:.1f} MiB) [{card}]")
    if len(reports) != N_FRAMES:
        raise RuntimeError(f"{len(reports)} frames reported, want {N_FRAMES}")
    if launches != N_FRAMES:
        raise RuntimeError(f"{launches} FAST kernel launches, want "
                           f"{N_FRAMES}, one per frame")
    if not all(np.isfinite(r["T_cw"]).all() for r in reports):
        raise RuntimeError("non-finite pose in a report")
    print(f"main path: {len(reports)} frames, {launches} FAST kernel "
          f"launches")
    rep = sysm.metrics()
    gate(rep, JAX_REF, "")
    return {"launches": launches, "fps": fps, "peak_bytes": peak,
            "metrics": rep, "reports": reports, "ds": ds,
            "graph": sysm.tracker._graph.track.record}


def gate(rep: dict, ref: dict, what: str) -> None:
    """Raise unless each metric is within 2x the JAX number or under its
    floor, and the estimates reach 90 % of the JAX count."""
    print(f"port metrics{what}: {json.dumps(rep)}")
    print(f"JAX metrics{what}:  {json.dumps(ref)}")
    for k, floor in ABS_FLOOR.items():
        bound = max(2.0 * ref[k], floor)
        if not (math.isfinite(rep[k]) and rep[k] <= bound):
            raise RuntimeError(f"{k}{what} = {rep[k]} above {bound}")
        print(f"gate {k}{what}: {rep[k]:.6g} <= {bound:.6g}")
    need = 0.9 * ref["n_obj_estimates"]
    if rep["n_obj_estimates"] < need:
        raise RuntimeError(f"n_obj_estimates{what} {rep['n_obj_estimates']} "
                           f"< {need}")
    print(f"gate n_obj_estimates{what}: {rep['n_obj_estimates']} >= {need}")


# seconds the tracker's thread waited in FusedTracker.flush for window
# solves still running, summed over every tracker since the last read
JOIN_WAIT = {"s": 0.0, "joins": 0}


def time_joins() -> None:
    """Wrap FusedTracker._join_ba (flush's wait for the window solves) so
    that it adds its seconds to JOIN_WAIT; the package times none of it."""
    from vdo_slam_tpu_torch.pipeline.fused import FusedTracker

    join = FusedTracker._join_ba

    def timed(self):
        t0 = time.perf_counter()
        try:
            join(self)
        finally:
            JOIN_WAIT["s"] += time.perf_counter() - t0
            JOIN_WAIT["joins"] += 1

    FusedTracker._join_ba = timed


def join_wait(what: str, card: str) -> float:
    """Print the flush waits since the last read, and start again at 0."""
    s, n = JOIN_WAIT["s"], JOIN_WAIT["joins"]
    JOIN_WAIT.update(s=0.0, joins=0)
    print(f"{what}: the tracker's thread waited {s:.4f} s in flush for "
          f"window solves still running ({n} tracker joins) [{card}]")
    return s


def record_ends(tracker) -> list:
    """Wrap the tracker's window-BA hook so that each solve's window end
    (n_frames) is appended to the list returned."""
    ends, hook = [], tracker.local_ba_hook

    def recording(m, n_frames=None):
        ends.append(n_frames)
        return hook(m, n_frames)

    tracker.local_ba_hook = recording
    return ends


def no_ba_failures(trackers, what: str) -> None:
    """Raise if a tracker counted a window solve that raised."""
    failures = [t.ba_failures for t in trackers]
    if any(failures):
        raise RuntimeError(f"{what}: window solves failed: ba_failures "
                           f"{failures}")
    print(f"{what}: ba_failures {failures}")


def _profiled(fn, what: str, host_ops: bool = True):
    """fn() once under torch.profiler: (result, kernel launches, device ms,
    wall ms), and a line of the operators the host called most.  Launches
    count the kernels the device ran (copies and fills by the copy engine
    are not kernels); device ms sums every device activity (kernels and
    copies; one stream, so they do not overlap); wall ms is the host clock
    to the final synchronize, profiler overhead included.  host_ops=False
    records the device alone (no operator line): a run of ~10^5 launches
    then takes seconds, not a minute, to trace and read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * host_ops
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    launches = sum(1 for e in dev
                   if not e.name.startswith(("Memcpy", "Memset")))
    dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    if not (host_ops or launches):
        raise RuntimeError(f"{what}: the profiler recorded no kernel")
    if host_ops:
        ops = sorted((e for e in prof.key_averages()
                      if e.key.startswith("aten::")), key=lambda e: -e.count)
        print(f"{what}, operators called most (calls): " + ", ".join(
            f"{e.key} {e.count}" for e in ops[:10]))
    return out, launches, dev_ms, wall


def solver_gap(m, cfg, device, card: str) -> dict:
    """The last window's Schur solve and the full-batch solve on the card
    against the same solves on the CPU, from the same numpy graph of the
    final map: the largest pose-entry and point gaps and the final costs."""
    from vdo_slam_tpu_torch.backend import builders
    from vdo_slam_tpu_torch.backend.factor_graph import (fetch,
                                                         lm_solve_chunked,
                                                         lm_solve_schur,
                                                         upload)
    from vdo_slam_tpu_torch.backend.full_ba import scaled_lm_params
    from vdo_slam_tpu_torch.backend.window_ba import _lm_params

    g_w, v_w, _ = builders.build_window_graph(m, cfg)
    g_f, v_f, _ = builders.build_full_graph(m, cfg)
    p_f = scaled_lm_params(cfg, g_f.obs_w.shape[0])
    chunk = min(cfg.backend.full_ba_chunk, p_f.iters)
    cases = {
        "window (lm_solve_schur)": lambda d: lm_solve_schur(
            *upload(g_w, v_w, d), _lm_params(cfg)),
        "full (lm_solve_chunked)": lambda d: lm_solve_chunked(
            *upload(g_f, v_f, d), p_f, chunk=chunk),
    }
    out = {}
    for name, solve in cases.items():
        res = {}
        for d in (device, torch.device("cpu")):
            t0 = time.perf_counter()
            v, info = solve(d)
            res[d.type] = fetch((v.poses, v.points, info["cost0"],
                                 info["cost"]))
            res[d.type + "_s"] = time.perf_counter() - t0
        (pc, xc, c0c, cc), (pg, xg, c0g, cg) = res["cpu"], res["cuda"]
        gap = {"pose": float(np.abs(pg - pc).max()),
               "point": float(np.abs(xg - xc).max()),
               "cost_cuda": float(cg), "cost_cpu": float(cc),
               "cost0_cuda": float(c0g), "cost0_cpu": float(c0c)}
        out[name] = gap
        print(f"card vs CPU, {name}: max pose-entry gap {gap['pose']:.3e}, "
              f"max point gap {gap['point']:.3e} m, cost0 {float(c0g):.9g} "
              f"(card) / {float(c0c):.9g} (CPU), cost {float(cg):.9g} / "
              f"{float(cc):.9g}; {res['cuda_s']:.3f} s on the card, "
              f"{res['cpu_s']:.3f} s on the CPU [{card}]")
    return out


def ba_path(ds, cfg, device, card: str, ref: dict, what: str,
            solvers: bool = True, keep_map: bool = False) -> dict:
    """Phases 5 and 6: tracking, every window solve and the full BA, as
    bench.py runs them, through the port's System on the 100 frames of
    `ds` (frames, or pre-packed wire buffers), gated against `ref`.
    keep_map: also return a copy of the map from before the full BA
    ("pre_full_map"; its copying is not timed)."""
    import copy

    from vdo_slam_tpu_torch.backend.full_ba import full_ba_inplace
    from vdo_slam_tpu_torch.backend.window_ba import local_ba_inplace
    from vdo_slam_tpu_torch.ops import edge_hessian_cuda as EH
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL
    from vdo_slam_tpu_torch.pipeline import System

    n = len(ds)
    sysm = System(cfg, enable_local_ba=True, enable_global_ba=True,
                  mode="fused", device=device)
    C = sysm.tracker.chunk
    ends = record_ends(sysm.tracker)
    kept = {"s": 0.0}
    if keep_map:
        full_ba = sysm.refine

        def copy_then_full_ba():
            t = time.perf_counter()
            kept["map"] = copy.deepcopy(sysm.map)
            kept["s"] = time.perf_counter() - t
            return full_ba()

        sysm.refine = copy_then_full_ba
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.launches = EH.KERNEL.launches = EH.VERTEX.launches = 0
    JOIN_WAIT.update(s=0.0, joins=0)
    t0 = time.perf_counter()
    reports = sysm.run_sequence(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - kept["s"]
    launches = KERNEL.launches
    hv_launches, vx_launches = EH.KERNEL.launches, EH.VERTEX.launches
    waited = join_wait(what, card)
    peak = torch.cuda.max_memory_allocated()
    health, full = sysm.tracker.ba_health, sysm.full_ba_report
    tr = cfg.tracking
    w, o = tr.window_size, tr.overlap_size
    want = sum(1 for f in range(n) if f >= w - 1 and (f - o + 1) % (w - o)
               == 0)
    # a padded tail chunk steps its padding frames too
    want_launches = -(-n // C) * C
    tracked = wall - full["t_build_s"] - full["t_solve_s"] \
        - full["t_writeback_s"]
    print(f"{what}: {len(reports)} frames in {wall:.3f} s (host clock, "
          f"tracking + {len(health)} window solves + full BA); "
          f"{n / tracked:.3f} fps over tracking and window solves, "
          f"fused_chunk={C} [{card}]")
    print(f"{what} peak device memory (max_memory_allocated): {peak} bytes "
          f"({peak / 2**20:.1f} MiB) [{card}]")
    print(f"{what}: {launches} FAST kernel launches in {n} frames")
    if len(reports) != n or launches != want_launches:
        raise RuntimeError(f"{len(reports)} frames reported and {launches} "
                           f"FAST launches, want {n} and {want_launches}")
    if [r["frame_id"] for r in reports] != list(range(n)):
        raise RuntimeError("the reports are not in frame order")
    if len(health) != want:
        raise RuntimeError(f"{len(health)} window solves, want {want}")
    no_ba_failures([sysm.tracker], what)
    print(f"{what}: window ends {ends}, each solve on the tracker's solve "
          f"thread and stream")
    if n == N_BA_FRAMES and ends != BA_WINDOW_ENDS:
        raise RuntimeError(f"{what}: window ends {ends}, want "
                           f"{BA_WINDOW_ENDS}")
    for i, (h, ms) in enumerate(zip(health, sysm.map.lba_times)):
        j0, j1 = (ref["window_cost"][i] if n == N_BA_FRAMES
                  else (math.nan, math.nan))
        print(f"window solve {i + 1}/{want}: {h['window']} poses, "
              f"{h['n_points']} points, cost {h['cost0']:.6g} -> "
              f"{h['cost']:.6g} (JAX {j0:.6g} -> {j1:.6g}); {ms:.3f} ms: "
              f"build {h['t_build_ms']:.3f}, solve {h['t_dispatch_ms']:.3f} "
              f"dispatch + {h['t_exec_ms']:.3f} wait, fetch "
              f"{h['t_fetch_ms']:.3f}, write-back {h['t_writeback_ms']:.3f} "
              f"ms [{card}]")
        if not h["cost"] <= h["cost0"]:
            raise RuntimeError(f"window solve {i + 1} raised the cost")
    print(f"full BA: {full['iters_run']} LM iterations, cost "
          f"{full['cost0']:.6g} -> {full['cost']:.6g}; build "
          f"{full['t_build_s']:.4f} s, solve {full['t_solve_s']:.4f} s, "
          f"write-back {full['t_writeback_s']:.4f} s; {full['n_static']} "
          f"static + {full['n_dyn']} dynamic points, {full['n_motions']} "
          f"motions [{card}]")
    if not full["cost"] < full["cost0"]:
        raise RuntimeError("the full BA did not lower the cost")
    # the refine is the only solve of the run that takes PCG's product (the
    # window solves are "schur"): one edge launch per edge type with edges
    # per CG step, a vertex pass per product and per preconditioner apply
    n_types = sum(1 for x in full["edges"].values() if x)
    want_hv = n_types * full["cg_iters"] * full["iters_run"]
    want_vx = (2 * full["cg_iters"] + 1) * full["iters_run"]
    print(f"{what}: full BA through the edge Hessian kernels: "
          f"{hv_launches} edge launches ({n_types} edge types x "
          f"{full['cg_iters']} CG steps x {full['iters_run']} LM iterations "
          f"= {want_hv}), {vx_launches} vertex passes (want {want_vx}); "
          f"chunks {full['chunk_modes']}")
    if (hv_launches, vx_launches) != (want_hv, want_vx) or not want_hv:
        raise RuntimeError(f"{what}: {hv_launches} edge launches and "
                           f"{vx_launches} vertex passes in the full BA, "
                           f"want {want_hv} and {want_vx}")
    for r in reports:
        if not np.isfinite(r["T_cw"]).all():
            raise RuntimeError("non-finite pose in a report")
    metrics = {"initial": sysm.metrics(),
               "refined": sysm.metrics(refined=True)}
    if n == N_BA_FRAMES:
        gate(metrics["initial"], ref["initial"], f" ({what}, before full BA)")
        gate(metrics["refined"], ref["refined"], f" ({what}, refined)")
    out = {"fast_launches": launches, "hv_launches": hv_launches,
           "vertex_launches": vx_launches, "peak_bytes": peak, "wall_s": wall,
           "metrics": metrics, "system": sysm, "join_wait_s": waited,
           "pre_full_map": kept.get("map")}
    if not solvers:
        return out

    # one more of each pass on copies of the final map, under the profiler
    m = sysm.map
    _, wl, wdev, wwall = _profiled(lambda: local_ba_inplace(
        copy.deepcopy(m), cfg, device=device), "window solve")
    print(f"one window solve under torch.profiler: {wl} kernel launches, "
          f"{wdev:.3f} ms on the device in {wwall:.3f} ms, busy share "
          f"{wdev / wwall:.4f} [{card}]")
    rep, fl, fdev, fwall = _profiled(lambda: full_ba_inplace(
        copy.deepcopy(m), cfg, device=device), "full BA")
    it = rep["iters_run"]
    print(f"one full BA under torch.profiler: {fl} kernel launches in {it} "
          f"LM iterations ({fl / it:.1f} per iteration, graph build, upload "
          f"and fetch included), {fdev:.3f} ms on the device in "
          f"{fwall:.3f} ms, busy share {fdev / fwall:.4f} [{card}]")
    out.update(window_launches=wl, full_launches_per_iter=fl / it,
               gap=solver_gap(m, cfg, device, card),
               overlap=solve_overlap(sysm, ds, card))
    return out


def _stream_nonblocking(stream) -> bool:
    """Whether `stream` was made with CU_STREAM_NON_BLOCKING (libcuda's
    cuStreamGetFlags), i.e. does not synchronize with the legacy default
    stream."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuStreamGetFlags.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_uint)]
    cuda.cuStreamGetFlags.restype = ctypes.c_int
    flags = ctypes.c_uint()
    rc = cuda.cuStreamGetFlags(ctypes.c_void_p(stream.cuda_stream),
                               ctypes.byref(flags))
    if rc != 0:
        raise RuntimeError(f"cuStreamGetFlags returned {rc}")
    return bool(flags.value & 1)


def _trace_tids() -> set:
    """The ids under which torch.profiler's trace names the calling
    thread's CUDA runtime calls: the low 32 bits of its pthread id (as the
    trace prints them) or its kernel thread id."""
    import ctypes
    import threading

    return {abs(ctypes.c_int32(threading.get_ident()).value),
            threading.get_native_id()}


def attribute_trace(events, tids: dict):
    """A chrome trace's kernels by the thread that launched them: each
    kernel is matched to the API call that launched it by correlation id,
    and the call's thread to a key of `tids` ({key: set of trace thread
    ids}; "other" if none).  Returns ({key: Counter of stream ids},
    {key: [(start, end) us of each kernel]}, Counter of (synchronize call,
    key))."""
    import collections

    def who(tid):
        return next((k for k, v in tids.items() if tid in v), "other")

    runtime = [e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    launcher = {e["args"]["correlation"]: who(e.get("tid"))
                for e in runtime if "correlation" in e.get("args", {})}
    streams = collections.defaultdict(collections.Counter)
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "kernel":
            k = launcher.get(e["args"].get("correlation"), "other")
            streams[k][e["args"].get("stream")] += 1
            spans[k].append((e["ts"], e["ts"] + e.get("dur", 0.0)))
    syncs = collections.Counter((e["name"], who(e.get("tid")))
                                for e in runtime
                                if e["name"].endswith("Synchronize"))
    return streams, spans, syncs


def solve_overlap(sysm, ds, card: str) -> dict:
    """Phase 5d: a window solve on the tracker's own solve thread while
    this thread, the tracker's, queues tracking steps, under torch.profiler
    (CUDA activity, the runtime calls included).  Checks: the solve stream
    is a non-blocking stream; the solve's kernels ran on a stream of their
    own, which no kernel of the steps used; the solve thread called no
    cudaDeviceSynchronize.  The solve refines a copy of the final map (the
    window of its last 20 frames); the steps start from the tracker's
    state, with its last frame as input, and are thrown away."""
    import copy
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    tr = sysm.tracker
    if not _stream_nonblocking(tr.ba_stream):
        raise RuntimeError("the solve stream synchronizes with the legacy "
                           "default stream")
    staged, draws = tr.probe_inputs(ds[len(ds) - 1])
    saved_map, hook = tr.map, tr.local_ba_hook
    tids = {"tracker": _trace_tids()}

    def hook_noting(m, n_frames=None):
        tids["solve"] = _trace_tids()
        return hook(m, n_frames)

    tr.map, tr.local_ba_hook = copy.deepcopy(saved_map), hook_noting
    steps = 0
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr._queue_ba(tr.map.num_frames)
            while steps < OVERLAP_STEPS and (steps == 0 or tr._ba_thread):
                tr.step(tr.state, staged, draws, True)
                steps += 1
            tr.flush()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "overlap.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
    finally:
        tr.map, tr.local_ba_hook = saved_map, hook
    if tr.ba_failures:
        raise RuntimeError("phase 5d: the solve failed")
    streams, spans, syncs = attribute_trace(events, tids)
    solve_k, step_k = sum(streams["solve"].values()), sum(
        streams["tracker"].values())
    lo = min((a for a, _ in spans["solve"]), default=0.0)
    hi = max((b for _, b in spans["solve"]), default=0.0)
    inside = sum(1 for a, _ in spans["tracker"] if lo <= a <= hi)
    print(f"5d, a window solve on the solve thread overlapping {steps} "
          f"tracking steps, torch.profiler: {wall:.3f} ms; solve kernels "
          f"by stream {dict(streams['solve'])}, the steps' "
          f"{dict(streams['tracker'])}, unattributed "
          f"{sum(streams['other'].values())}; {inside} of the steps' "
          f"{step_k} kernels started while the solve's kernels ran; "
          f"synchronize calls by thread {dict(syncs)} [{card}]")
    if not (solve_k and step_k):
        raise RuntimeError(f"phase 5d: {solve_k} solve kernels and {step_k} "
                           f"step kernels in the trace")
    if set(streams["solve"]) & set(streams["tracker"]):
        raise RuntimeError("phase 5d: the solve's kernels share a stream "
                           "with the tracking steps")
    if syncs[("cudaDeviceSynchronize", "solve")]:
        raise RuntimeError("phase 5d: the solve thread called "
                           "cudaDeviceSynchronize")
    return {"steps": steps, "solve_kernels": solve_k, "step_kernels": step_k,
            "step_kernels_during_solve": inside,
            "solve_streams": sorted(streams["solve"]),
            "step_streams": sorted(streams["tracker"])}


def wire_costs(pds, dense_ds, cfgs: dict, device, card: str) -> dict:
    """Phase 6b: what each wire costs per frame on the card: the bytes
    uploaded, the decode's device time and kernel launches, and the kernel
    launches and device time of one whole tracking step."""
    from vdo_slam_tpu_torch.pipeline import stages
    from vdo_slam_tpu_torch.pipeline.fused import FusedTracker

    out = {}
    for name, (cfg, ds) in {"tpu_fast wire": (cfgs["wire"], pds),
                            "dense (4, H, W) wire": (cfgs["dense"],
                                                     dense_ds)}.items():
        cfg1 = cfg.replace(tracking=dataclasses.replace(cfg.tracking,
                                                        fused_chunk=1))
        tracker = FusedTracker(cfg1, device=device)
        unpack = stages.make_unpack(cfg1)
        for f in range(3):                     # a tracked state to step from
            tracker.grab_frame(ds[f])
        tracker.flush()
        inputs = tracker.device_inputs(ds[3])
        inputs.pop("_T_cw_gt_host")
        n_bytes = inputs["packed"].numel() * inputs["packed"].element_size()
        dec_ms = _device_ms(lambda: unpack(inputs), 5)
        _, dec_launches, _, _ = _profiled(lambda: unpack(inputs),
                                          f"decode of the {name}")
        state = tracker.state

        def one_step():
            from vdo_slam_tpu_torch.pipeline.draws import UniformDraws

            return tracker.step(state, inputs,
                                UniformDraws(tracker.frame_draws(3)), True)

        _, launches, dev_ms, wall_ms = _profiled(one_step,
                                                 f"one step on the {name}")
        print(f"{name}: {n_bytes} bytes uploaded per frame; decode "
              f"{dec_ms:.5f} ms on the device in {dec_launches} kernel "
              f"launches; one whole step {launches} kernel launches, "
              f"{dev_ms:.3f} ms on the device in {wall_ms:.3f} ms under "
              f"torch.profiler, busy share {dev_ms / wall_ms:.4f} [{card}]")
        out[name] = {"bytes": n_bytes, "decode_ms": dec_ms,
                     "decode_launches": dec_launches,
                     "step_launches": launches, "step_device_ms": dev_ms}
    return out


def _pose_gap(T, T_ref):
    """(translation m, rotation deg) between two 4x4 poses."""
    E = np.linalg.inv(np.asarray(T_ref, np.float64)) @ np.asarray(T,
                                                                  np.float64)
    sk = np.asarray([E[2, 1] - E[1, 2], E[0, 2] - E[2, 0], E[1, 0] - E[0, 1]])
    ang = np.degrees(np.arctan2(0.5 * np.linalg.norm(sk),
                                0.5 * (np.trace(E[:3, :3]) - 1.0)))
    return float(np.linalg.norm(E[:3, 3])), float(ang)


def stream_path(pds, cfg, device, card: str) -> dict:
    """Phase 7: four streams in one batched step per frame, each held
    against a solo System on its window."""
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL
    from vdo_slam_tpu_torch.parallel import MultiStreamSystem
    from vdo_slam_tpu_torch.pipeline import System

    views = [_View(pds, off, N_STREAM_FRAMES)
             for off in stream_offsets(len(pds))]
    msys = MultiStreamSystem(cfg, n_streams=N_STREAMS, enable_local_ba=True,
                             device=device)
    ends = [record_ends(t) for t in msys.trackers]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.launches = 0
    JOIN_WAIT.update(s=0.0, joins=0)
    fps, (first, rest) = _timed_run(msys.run, views)
    reps = [a + b for a, b in zip(first, rest)]
    launches = KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    waited = join_wait(f"S={N_STREAMS} path", card)
    agg_fps = fps * N_STREAMS
    no_ba_failures(msys.trackers, f"S={N_STREAMS} path")
    print(f"S={N_STREAMS} path: window ends per stream {ends}")
    if any(e != STREAM_WINDOW_ENDS for e in ends):
        raise RuntimeError(f"window ends per stream {ends}, want "
                           f"{STREAM_WINDOW_ENDS} for each")
    print(f"S={N_STREAMS} path: {N_STREAM_FRAMES} frames per stream, "
          f"{launches} FAST kernel launches ({launches / N_STREAM_FRAMES:.3f} "
          f"per frame for all {N_STREAMS} streams); aggregate "
          f"{agg_fps:.3f} fps after {WARM} warm frames "
          f"({agg_fps / N_STREAMS:.3f} per stream; host clock, window BA "
          f"on, {sum(len(t.ba_health) for t in msys.trackers)} window "
          f"solves) [{card}]")
    print(f"S={N_STREAMS} path peak device memory (max_memory_allocated): "
          f"{peak} bytes ({peak / 2**20:.1f} MiB) [{card}]")
    if launches != N_STREAM_FRAMES:
        raise RuntimeError(f"{launches} FAST launches in {N_STREAM_FRAMES} "
                           f"batched frames, want one per frame")
    if any(len(r) != N_STREAM_FRAMES for r in reps):
        raise RuntimeError(f"reports per stream {[len(r) for r in reps]}, "
                           f"want {N_STREAM_FRAMES}")
    per = msys.metrics()["per_stream"]
    solo_fps = []
    worst = (0.0, 0.0)
    for st, view in enumerate(views):
        solo = System(cfg, enable_local_ba=True, enable_global_ba=False,
                      mode="fused", device=device)
        one_fps, _ = _timed_run(lambda d: solo.run_sequence(d[0]), [view])
        solo_fps.append(one_fps)
        sm = solo.metrics()
        gaps = [_pose_gap(a, b) for a, b in zip(msys.maps[st].cam_pose,
                                                solo.map.cam_pose)]
        dt, dr = max(g[0] for g in gaps), max(g[1] for g in gaps)
        worst = (max(worst[0], dt), max(worst[1], dr))
        print(f"stream {st} (frames {view.start}-"
              f"{view.start + N_STREAM_FRAMES - 1}): {json.dumps(per[st])}")
        print(f"solo   {st}: {json.dumps(sm)}; {solo_fps[-1]:.3f} fps; "
              f"largest pose gap to the stream {dt:.3e} m, {dr:.3e} deg "
              f"[{card}]")
        if not (dt < STREAM_T_TOL_M and dr < STREAM_R_TOL_DEG):
            raise RuntimeError(f"stream {st}: pose gap to its solo run "
                               f"{dt} m, {dr} deg")
        if per[st]["n_obj_estimates"] != sm["n_obj_estimates"]:
            raise RuntimeError(
                f"stream {st}: {per[st]['n_obj_estimates']} object "
                f"estimates, its solo run {sm['n_obj_estimates']}")
        if len(msys.trackers[st].ba_health) != len(solo.tracker.ba_health):
            raise RuntimeError(f"stream {st}: window solve counts differ")
        no_ba_failures([solo.tracker], f"solo {st}")
        last_solo = solo
    mean_solo = float(np.mean(solo_fps))
    print(f"S={N_STREAMS} aggregate {agg_fps:.3f} fps against the solo runs' "
          f"{mean_solo:.3f} fps (mean of {N_STREAMS}, same call): "
          f"{agg_fps / mean_solo:.3f}x one stream, "
          f"{agg_fps / (N_STREAMS * mean_solo):.3f} of {N_STREAMS}x "
          f"[{card}]")
    # one more batched frame and one more solo frame under the profiler
    nxt = [pds[v.start + N_STREAM_FRAMES] for v in views]
    _, ml, mdev, mwall = _profiled(lambda: msys.step_frame(nxt),
                                   f"one S={N_STREAMS} step_frame")

    def solo_frame():
        last_solo.tracker.grab_frame(nxt[-1])
        return last_solo.tracker.flush()

    _, sl, sdev, swall = _profiled(solo_frame, "one solo frame")
    print(f"one S={N_STREAMS} step_frame under torch.profiler: {ml} kernel "
          f"launches, {mdev:.3f} ms on the device in {mwall:.3f} ms, busy "
          f"share {mdev / mwall:.4f}; one solo frame: {sl} launches, "
          f"{sdev:.3f} ms in {swall:.3f} ms, busy share "
          f"{sdev / swall:.4f} [{card}]")
    return {"launches": launches, "agg_fps": agg_fps, "solo_fps": mean_solo,
            "peak_bytes": peak, "step_launches": ml, "busy": mdev / mwall,
            "worst_gap": worst, "join_wait_s": waited, "reports": reps,
            "views": views, "metrics": per, "system": msys,
            "graphs": [g.graph.track.record for g in msys.groups]
            + [r for wg in msys.window_graphs.values()
               for r in wg.records()]}


def _count_syncs(prof) -> tuple[int, int]:
    """(host waits, host<->device copies) the CPU side of a profile
    recorded: CUDA runtime calls that block the host (stream, device and
    event synchronizes) and memcpy calls."""
    names = [e.name for e in prof.events()]
    syncs = sum(1 for n in names if n.startswith("cuda")
                and "Synchronize" in n)
    copies = sum(1 for n in names if n.startswith("cudaMemcpy"))
    return syncs, copies


def steady_frames(cfg, ds, device, card: str, n_warm: int = 3,
                  n_prof: int = 3, plain: bool = False) -> dict:
    """Phase 8b (and 17b's eager side, plain=True: the stage functions
    called directly, no graphs): host syncs, copies, host launch calls
    (LAUNCH_CALLS) and kernel launches per frame of the host Tracker in
    steady state (frames n_warm .. n_warm + n_prof - 1 under
    torch.profiler, BA off), the device busy share, and the FAST kernels
    in the profile against KERNEL.launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL
    from vdo_slam_tpu_torch.pipeline import System

    sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  device=device)
    if plain:
        plain_stages(sysm.tracker)
    for f in range(n_warm):
        sysm.track_rgbd(ds[f])
    torch.cuda.synchronize()
    before = KERNEL.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in range(n_warm, n_warm + n_prof):
            sysm.track_rgbd(ds[f])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    counted = KERNEL.launches - before
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    syncs, copies = _count_syncs(prof)
    calls = sum(1 for e in events if e.name in LAUNCH_CALLS)
    fast = sum(1 for e in kernels if KERNEL_NAME in e.name)
    out = {"syncs_per_frame": syncs / n_prof,
           "copies_per_frame": copies / n_prof,
           "host_calls_per_frame": calls / n_prof,
           "launches_per_frame": len(kernels) / n_prof,
           "device_ms_per_frame": dev_ms / n_prof,
           "wall_ms_per_frame": wall / n_prof,
           "fast_profiled": fast, "fast_counted": counted}
    what = "eager stages" if plain else "stage graphs"
    print(f"reference path ({what}), steady frames {n_warm}-"
          f"{n_warm + n_prof - 1} under torch.profiler: "
          f"{out['launches_per_frame']:.1f} kernel launches, "
          f"{out['host_calls_per_frame']:.1f} host launch calls, "
          f"{out['syncs_per_frame']:.1f} host waits (cuda*Synchronize), "
          f"{out['copies_per_frame']:.1f} memcpy calls per frame; "
          f"{out['device_ms_per_frame']:.3f} ms on the device in "
          f"{out['wall_ms_per_frame']:.3f} ms per frame, busy share "
          f"{dev_ms / wall:.4f}; FAST {fast} in the profile / {counted} "
          f"counted over {n_prof} frames [{card}]")
    if fast != counted or counted != n_prof:
        raise RuntimeError(f"reference path ({what}): the profiler saw "
                           f"{fast} FAST kernels, KERNEL.launches counted "
                           f"{counted} over {n_prof} frames")
    return out


# the host Tracker's stages that run every tracked frame, each a
# GraphedStage (vdo_slam_tpu_torch/pipeline/tracking.py)
HOST_STAGES = ("_prepare", "_mask_prop", "_inherit", "_camera",
               "_scene_flow", "_objects", "_renew_static", "_renew_dynamic")


def plain_stages(tracker):
    """Phase 17b's eager side: the tracker's stage functions called
    directly, op by op, where their graphs stood."""
    for name in HOST_STAGES:
        setattr(tracker, name, getattr(tracker, name).fn)
    return tracker


def frame_gap(cfg, ds, device, card: str, fid: int = 5) -> dict:
    """Phase 8c: one frame on the card and on the CPU, both started from
    the state of the card's tracker after frame fid - 1 (through a
    checkpoint payload) with the same draws."""
    import pickle
    import tempfile

    from vdo_slam_tpu_torch.pipeline import System
    from vdo_slam_tpu_torch.utils.checkpoint import (save_checkpoint,
                                                     tracker_from_numpy)

    sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                  device=device)
    for f in range(fid):
        sysm.track_rgbd(ds[f])
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(sysm.tracker, f"{tmp}/ck.pkl")
        with open(f"{tmp}/ck.pkl", "rb") as fh:
            payload = pickle.load(fh)
    reps, secs = {}, {}
    for name, d in (("card", device), ("cpu", torch.device("cpu"))):
        # each tracker's own draws of frame fid: the same on both devices
        tr = tracker_from_numpy(payload, cfg, device=d)
        t0 = time.perf_counter()
        reps[name] = tr.grab_frame(ds[fid])
        secs[name] = time.perf_counter() - t0
    dt, dr = _pose_gap(reps["card"]["T_cw"], reps["cpu"]["T_cw"])

    def ids(rep):
        return [(o["model_label"], o["sem_label"], o["status"])
                for o in rep["objects"]]

    same = ids(reps["card"]) == ids(reps["cpu"])
    h_gap = max([float(np.linalg.norm(a["H"][:3, 3] - b["H"][:3, 3]))
                 for a, b in zip(reps["card"]["objects"],
                                 reps["cpu"]["objects"]) if b["status"]]
                or [0.0])
    print(f"frame {fid} from the same state, card vs CPU: T_cw gap "
          f"{dt:.3e} m, {dr:.3e} deg; camera inliers "
          f"{reps['card']['n_inlier_cam']} / {reps['cpu']['n_inlier_cam']}; "
          f"objects {'equal' if same else 'DIFFER'} ({ids(reps['card'])}), "
          f"largest H translation gap {h_gap:.3e} m; {secs['card']:.3f} s on "
          f"the card, {secs['cpu']:.3f} s on the CPU [{card}]")
    if not (dt < STREAM_T_TOL_M and dr < STREAM_R_TOL_DEG and same
            and h_gap < 5e-3):
        raise RuntimeError("the frame on the card and on the CPU disagree")
    return {"t_gap": dt, "r_gap": dr, "h_gap": h_gap}


def reference_path(scene, device, card: str) -> dict:
    """Phase 8: the default entry point, System(cfg) in mode "reference"
    with both BA passes, over the 100 frames of the bench scene."""
    from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL
    from vdo_slam_tpu_torch.pipeline import System, Tracker

    cfg = bench_ba_config()
    ds = SyntheticDataset(scene, depth_map_factor=256.0, bf=387.5744)
    n = len(ds)
    sysm = System(cfg, device=device)
    if not isinstance(sysm.tracker, Tracker):
        raise RuntimeError("System(cfg) did not build the host Tracker")
    health = []
    hook = sysm.tracker.local_ba_hook
    sysm.tracker.local_ba_hook = lambda m: health.append(hook(m))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.launches = 0
    t0 = time.perf_counter()
    reports = sysm.run_sequence(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    full = sysm.full_ba_report
    lba_s = sum(sysm.map.lba_times) / 1e3
    tracking_s = (wall - full["t_build_s"] - full["t_solve_s"]
                  - full["t_writeback_s"] - lba_s)
    print(f"reference path: {len(reports)} frames in {wall:.3f} s (host "
          f"clock, tracking + {len(health)} window solves + full BA); "
          f"{n / tracking_s:.3f} fps over tracking alone, "
          f"{n / (tracking_s + lba_s):.3f} fps with the window solves "
          f"({lba_s:.3f} s) [{card}]")
    print(f"reference path timing() spans (ms per frame): "
          f"{json.dumps(sysm.timing())} [{card}]")
    print(f"reference path peak device memory (max_memory_allocated): "
          f"{peak} bytes ({peak / 2**20:.1f} MiB) [{card}]")
    print(f"reference path: {launches} FAST kernel launches in {n} frames")
    if len(reports) != n or launches != n:
        raise RuntimeError(f"{len(reports)} frames reported and {launches} "
                           f"FAST launches, want {n} and {n}")
    if [r["frame_id"] for r in reports] != list(range(n)):
        raise RuntimeError("the reports are not in frame order")
    want = JAX_REF_HOST["reference"]["window_solves"]
    if len(health) != want:
        raise RuntimeError(f"{len(health)} window solves, want {want}")
    for i, (h, ms) in enumerate(zip(health, sysm.map.lba_times)):
        print(f"window solve {i + 1}/{want}: {h['window']} poses, "
              f"{h['n_points']} points, cost {h['cost0']:.6g} -> "
              f"{h['cost']:.6g}; {ms:.3f} ms [{card}]")
        if not h["cost"] <= h["cost0"]:
            raise RuntimeError(f"window solve {i + 1} raised the cost")
    print(f"full BA: {full['iters_run']} LM iterations, cost "
          f"{full['cost0']:.6g} -> {full['cost']:.6g}; solve "
          f"{full['t_solve_s']:.4f} s [{card}]")
    if not full["cost"] < full["cost0"]:
        raise RuntimeError("the full BA did not lower the cost")
    if not all(np.isfinite(r["T_cw"]).all() for r in reports):
        raise RuntimeError("non-finite pose in a report")
    metrics = {"initial": sysm.metrics(),
               "refined": sysm.metrics(refined=True)}
    ref = JAX_REF_HOST["reference"]
    gate(metrics["initial"], ref["initial"], " (reference path, before "
         "full BA)")
    gate(metrics["refined"], ref["refined"], " (reference path, refined)")
    steady = steady_frames(bench_config(), ds, device, card)
    gap = frame_gap(bench_config(), ds, device, card)
    return {"launches": launches, "fps": n / tracking_s, "peak_bytes": peak,
            "metrics": metrics, "steady": steady, "gap": gap,
            "timing": sysm.timing(), "reports": reports, "system": sysm,
            "ds": ds}


def omd_scene_config():
    """(scene, config) of phase 9's OMD run: configs/omd.yaml, the scene
    rendered with its focal lengths, the principal point set to the
    scene's image centre (tools/jax_reference_mode.py does the same)."""
    from pathlib import Path

    from vdo_slam_tpu_torch.config import load_settings
    from vdo_slam_tpu_torch.io.synthetic import make_scene

    cfg = load_settings(Path(__file__).resolve().parent / "configs"
                        / "omd.yaml")
    scene = make_scene(num_frames=N_OPT_FRAMES + 1, width=cfg.camera.width,
                       height=cfg.camera.height, num_objects=2,
                       fx=cfg.camera.fx, fy=cfg.camera.fy, seed=7)
    K = scene.K_mat
    return scene, cfg.replace(camera=dataclasses.replace(
        cfg.camera, cx=float(K[0, 2]), cy=float(K[1, 2])))


def option_paths(scene, device, card: str) -> dict:
    """Phase 9: each option through System(mode="reference") (and the
    distorted config once in mode "fused") over 25 frames, BA off, gated
    against the JAX package's runs."""
    from vdo_slam_tpu_torch.io.dataset import (SyntheticDataset,
                                               SyntheticOMDDataset)
    from vdo_slam_tpu_torch.io.synthetic import make_scene
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL
    from vdo_slam_tpu_torch.pipeline import System

    def run(name, cfg, ds, mode="reference", launches_want=None):
        sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                      mode=mode, device=device)
        KERNEL.launches = 0
        t0 = time.perf_counter()
        reps = sysm.run_sequence(_View(ds, 0, N_OPT_FRAMES))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = KERNEL.launches
        print(f"option {name} (mode {mode}): {len(reps)} frames in "
              f"{secs:.3f} s, {launches} FAST launches [{card}]")
        if len(reps) != N_OPT_FRAMES:
            raise RuntimeError(f"{name}: {len(reps)} frames reported")
        want = N_OPT_FRAMES if launches_want is None else launches_want
        if launches != want:
            raise RuntimeError(f"{name}: {launches} FAST launches, want "
                               f"{want}")
        rep = sysm.metrics()
        gate(rep, JAX_REF_HOST[name], f" (option {name})")
        return rep, launches

    out = {}
    t0 = time.perf_counter()
    oscene, ocfg = omd_scene_config()
    print(f"OMD scene {oscene.rgb.shape} made in "
          f"{time.perf_counter() - t0:.1f} s")
    out["omd"] = run("omd", ocfg, SyntheticOMDDataset(
        oscene, depth_map_factor=1000.0, bf=ocfg.camera.bf),
        launches_want=0)
    bench = SyntheticDataset(scene, depth_map_factor=256.0, bf=387.5744)
    cfg = bench_config()
    out["nonjoint"] = run("nonjoint", cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, joint_flow=False, depth_noise=True)), bench)
    t0 = time.perf_counter()
    dscene = make_scene(num_frames=N_OPT_FRAMES + 1, width=W, height=H,
                        num_objects=3, fx=721.5377, seed=7, dist=DIST)
    print(f"distorted scene {dscene.rgb.shape} made in "
          f"{time.perf_counter() - t0:.1f} s")
    dds = SyntheticDataset(dscene, depth_map_factor=256.0, bf=387.5744)
    dcfg = cfg.replace(camera=dataclasses.replace(cfg.camera, k1=DIST[0],
                                                  k2=DIST[1]))
    out["distorted"] = run("distorted", dcfg, dds)
    out["control"] = run("control", cfg, dds)
    ratio = (out["distorted"][0]["cam_t_rpe"]
             / out["control"][0]["cam_t_rpe"])
    print(f"distorted scene: configured cam_t / unconfigured cam_t = "
          f"{ratio:.4f} (must be under 0.4)")
    if not ratio < 0.4:
        raise RuntimeError("undistortion does not beat the control")
    out["distorted_fused"] = run("distorted_fused", dcfg, dds, mode="fused")
    return out


def cli_and_resume(device, card: str) -> dict:
    """Phase 10: the CLI on the card, and a host-Tracker checkpoint after
    frame 6 resumed in a fresh tracker."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    from vdo_slam_tpu_torch import run as cli
    from vdo_slam_tpu_torch.config import KITTI, TrackingConfig, VDOConfig
    from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
    from vdo_slam_tpu_torch.io.synthetic import make_scene
    from vdo_slam_tpu_torch.pipeline import System
    from vdo_slam_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                     save_checkpoint)

    n = 12
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--synthetic", "--frames", str(n), "--out",
                           f"{tmp}/out", "--quiet"])
        secs = time.perf_counter() - t0
        rep = json.loads(buf.getvalue())
        keys = {"metrics_initial", "metrics_refined", "timing", "frames",
                "velocity"}
        files = ("initial_stereo_new.txt", "refined_stereo_new.txt",
                 "obj_mot_stereo_new.txt", "speed_estimated.txt",
                 "dynamic_slam_graph_after_opt.g2o")
        missing = [f for f in files if not (Path(tmp) / "out" / f).exists()]
        print(f"CLI (run.main --synthetic --frames {n}) on the card: exit "
              f"{rc} in {secs:.1f} s; report keys {sorted(rep)}; "
              f"frames {rep['frames']}; metrics_refined "
              f"{json.dumps(rep['metrics_refined'])} [{card}]")
        if rc != 0 or set(rep) != keys or rep["frames"] != n or missing:
            raise RuntimeError(f"CLI: exit {rc}, keys {sorted(rep)}, "
                               f"missing files {missing}")

        # the CLI's scene and config (vdo_slam_tpu_torch/run.py)
        scene = make_scene(num_frames=n + 1, width=640, height=256,
                           num_objects=2, seed=0)
        cfg = VDOConfig()
        cfg = cfg.replace(
            camera=dataclasses.replace(cfg.camera, fx=640.0, fy=640.0,
                                       cx=320.0, cy=128.0, width=640,
                                       height=256, bf=40.0),
            tracking=dataclasses.replace(TrackingConfig(), dataset=KITTI,
                                         depth_map_factor=1.0))
        ds = SyntheticDataset(scene, depth_map_factor=1.0, bf=40.0)

        def system():
            return System(cfg, enable_local_ba=False, enable_global_ba=False,
                          device=device)

        whole = system()
        whole.run_sequence(ds)
        first = system()
        for i in range(7):                      # frames 0-6
            first.track_rgbd(ds[i])
        save_checkpoint(first.tracker, f"{tmp}/ck.pkl")
        resumed = system()
        load_checkpoint(resumed.tracker, f"{tmp}/ck.pkl")
        for i in range(7, n):
            resumed.track_rgbd(ds[i])
    gap = max(float(np.abs(a - b).max())
              for a, b in zip(whole.map.cam_pose, resumed.map.cam_pose))
    print(f"checkpoint after frame 6, resumed in a fresh Tracker: "
          f"{resumed.map.num_frames} frames, largest pose-entry gap to the "
          f"uninterrupted run {gap:.3e} (tolerance {RESUME_TOL}) [{card}]")
    if resumed.map.num_frames != n or not gap <= RESUME_TOL:
        raise RuntimeError(f"resume: {resumed.map.num_frames} frames, pose "
                           f"gap {gap}")
    return {"resume_gap": gap}


def host_libraries() -> dict:
    """What the on-disk path needs of the host: PIL (the writer and the
    Python reader), matplotlib (the drawings), g++ and zlib (the native
    reader, built here; it decodes PNG on zlib alone).  Returns {part: None
    if present, else why not}."""
    import importlib.util
    import shutil

    from vdo_slam_tpu_torch.io import native_loader

    def module(name):
        return (None if importlib.util.find_spec(name) is not None
                else f"{name} is not installed")

    found = {"PIL": module("PIL"), "matplotlib": module("matplotlib")}
    if shutil.which("g++") is None:
        found["native"] = "g++ is not installed"
    elif native_loader.build_native_loader() is None:
        found["native"] = ("the native loader did not build: "
                           + native_loader.BUILD_LOG.strip()[-400:])
    else:
        found["native"] = None
    print("host libraries: " + "; ".join(
        f"{k} {'present' if v is None else 'MISSING (' + v + ')'}"
        for k, v in found.items()))
    return found


def probe_fast_launches(report: dict) -> int:
    """The FAST launches a stage probe made, from its graphs' records
    (FusedTracker.probe_report): each graph's warm-up's, and its capture's
    per replay times its replays."""
    return sum(g["kernel_launches_warm"].get("FastScoreKernel", 0)
               + g["kernel_launches_per_replay"].get("FastScoreKernel", 0)
               * g["replays"] for g in report["graphs"])


def replay_device_ms(call, n: int) -> float:
    """The device activity's summed ms per call of n calls of `call` (a
    captured GraphedCall) under torch.profiler (CUDA activity only); a
    session that recorded none is retried, twice at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            return sum(e.time_range.elapsed_us() for e in dev) / n / 1e3
    raise RuntimeError("the profiler recorded no device activity in 3 "
                       "sessions")


def stage_probe(sysm, ds, device, card: str) -> dict:
    """Phase 6c: the fused path's stage-time probe on the wire path's
    tracker, after its timed run, on the frame after the warm frames (as
    bench.py:390-420 runs it).  The probe's graphs (their FAST launches,
    one memory pool), the tracker unchanged and the split archived; then
    each span eagerly under the profiler (its launches and summed device
    time), and each span's graph and the frame program replayed alone
    under the profiler (summed device time), which the probe's times are
    held to (PROBE_SPAN_RTOL / PROBE_SPAN_ATOL_MS, PROBE_FRAME_RATIO); the
    spans' sum against _frame_ms (PROBE_COVER)."""
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL
    from vdo_slam_tpu_torch.parallel.multistream import (PROBE_SPANS,
                                                         STAGE_SPANS,
                                                         _flatten,
                                                         make_scan_probe)

    tracker = sysm.tracker
    fd = ds[WARM]
    before = [t.clone() for t in _flatten(tracker.state)]
    fid = tracker.frame_id
    torch.cuda.synchronize()
    KERNEL.launches = 0
    t0 = time.perf_counter()
    times = tracker.calibrate_stage_times(fd, rounds=PROBE_ROUNDS,
                                          n_iters=PROBE_ITERS)
    secs = time.perf_counter() - t0
    launches = KERNEL.launches
    rep = tracker.probe_report
    spans = {k: times[k] for k in PROBE_SPANS}
    total = sum(spans.values())
    print(f"stage probe ({secs:.2f} s, {PROBE_ROUNDS} rounds of "
          f"{PROBE_ITERS}): " + ", ".join(f"{k} {v:.3f} ms"
                                         for k, v in spans.items())
          + f"; _frame_ms {times['_frame_ms']:.3f}, _rtt_ms "
          f"{times['_rtt_ms']:.4f}; spans sum to {total:.3f} ms, "
          f"{total / times['_frame_ms']:.3f} of the frame program [{card}]")
    want = probe_fast_launches(rep)
    print(f"stage probe's graphs: {len(rep['graphs'])} in one pool of "
          f"{rep['pool_reserved_bytes']} bytes "
          f"({rep['pool_reserved_bytes'] / 2**20:.1f} MiB), "
          f"{launches} FAST launches (the records say {want}); "
          f"{json.dumps(rep['graphs'])} [{card}]")
    if len(rep["graphs"]) != len(PROBE_SPANS) + 1 or launches != want:
        raise RuntimeError(f"stage probe: {len(rep['graphs'])} graphs, "
                           f"{launches} FAST launches, want "
                           f"{len(PROBE_SPANS) + 1} and {want}")
    if not (all(math.isfinite(v) for v in spans.values())
            and times["_frame_ms"] > 0):
        raise RuntimeError(f"stage probe: bad times {times}")
    after = _flatten(tracker.state)
    if tracker.frame_id != fid or not all(
            torch.equal(a, b) for a, b in zip(after, before)):
        raise RuntimeError("the stage probe changed the tracker's state")
    rows = np.stack(sysm.map.timings)
    timing = sysm.timing()
    print(f"timing() after the probe: {json.dumps(timing)}")
    if not (rows.shape[0] == sysm.map.num_frames
            and (rows == tracker._stage_ms).all()
            and all(timing[f"{k}_ms"] > 0 for k in STAGE_SPANS)):
        raise RuntimeError("the probe's stage times are not archived with "
                           "every frame")
    # each span alone and eagerly under the profiler: its kernels and
    # summed device time
    staged, draws = tracker.probe_inputs(fd)
    probe = make_scan_probe(tracker.cfg, device)
    per_span = {}
    for name, span, ctx in probe.contexts(tracker.state, staged, draws):
        _, n_k, dev_ms, wall_ms = _profiled(lambda: span(ctx),
                                            f"span {name}")
        per_span[name] = {"launches": n_k, "eager_device_ms": dev_ms,
                          "eager_wall_ms": wall_ms}
        print(f"span {name} under torch.profiler: {n_k} kernel launches, "
              f"{dev_ms:.3f} ms on the device in {wall_ms:.3f} ms [{card}]")
    print(f"spans' launches sum to "
          f"{sum(r['launches'] for r in per_span.values())} per frame "
          f"[{card}]")
    # each program of the probe replayed alone under the profiler
    progs = probe.programs(tracker.state, staged, draws)
    progs.build()
    for name, call in zip(PROBE_SPANS, progs.spans):
        per_span[name]["graph_device_ms"] = replay_device_ms(call,
                                                             PROBE_ITERS)
    progs.reset_frame()
    frame_dev = replay_device_ms(progs.frame, PROBE_ITERS)
    progs.close()
    rows = [(k, spans[k], per_span[k]["graph_device_ms"],
             per_span[k]["eager_device_ms"]) for k in PROBE_SPANS]
    rows.append(("_frame_ms", times["_frame_ms"], frame_dev,
                 sum(r[3] for r in rows)))
    for k, t, dev, eager in rows:
        # a span of copies alone (output_pack) launches no kernel eagerly
        share = f"{t / eager:.3f}" if eager > 0 else "no kernel"
        print(f"6c, {k}: probe {t:.3f} ms; its graph replayed alone under "
              f"the profiler {dev:.3f} ms of device activity (probe / that "
              f"{t / dev:.3f}); eagerly {eager:.3f} ms ({share}) "
              f"[{card}]")
    cover = total / times["_frame_ms"]
    print(f"6c, the spans sum to {total:.3f} ms, {cover:.3f} of _frame_ms "
          f"{times['_frame_ms']:.3f} (bounds {PROBE_COVER}) [{card}]")
    for k, t, dev, _ in rows[:-1]:
        if not abs(t - dev) <= max(PROBE_SPAN_RTOL * dev,
                                   PROBE_SPAN_ATOL_MS):
            raise RuntimeError(f"6c: span {k} {t:.4f} ms, its graph "
                               f"{dev:.4f} ms of device activity")
    ratio = times["_frame_ms"] / frame_dev
    if not PROBE_FRAME_RATIO[0] <= ratio <= PROBE_FRAME_RATIO[1]:
        raise RuntimeError(f"6c: _frame_ms {times['_frame_ms']:.4f}, the "
                           f"frame program {frame_dev:.4f} ms of device "
                           f"activity ({ratio:.3f}x)")
    if not PROBE_COVER[0] <= cover <= PROBE_COVER[1]:
        raise RuntimeError(f"6c: the spans cover {cover:.3f} of _frame_ms")
    return {"times": times, "launches": launches, "per_span": per_span,
            "frame_device_ms": frame_dev, "report": rep, "seconds": secs}


def settings_yaml(cfg) -> str:
    """cfg's camera, front end and tracking as a reference-format settings
    file: every key load_settings reads (tools/jax_reference_mode.py
    writes its settings with this function too)."""
    c, fe, tr = cfg.camera, cfg.frontend, cfg.tracking
    keys = (
        ("Camera.fx", c.fx), ("Camera.fy", c.fy), ("Camera.cx", c.cx),
        ("Camera.cy", c.cy), ("Camera.k1", c.k1), ("Camera.k2", c.k2),
        ("Camera.p1", c.p1), ("Camera.p2", c.p2), ("Camera.k3", c.k3),
        ("Camera.width", c.width), ("Camera.height", c.height),
        ("Camera.fps", c.fps), ("Camera.bf", c.bf),
        ("Camera.RGB", int(c.rgb)), ("ChooseData", tr.dataset),
        ("DepthMapFactor", tr.depth_map_factor),
        ("ThDepthBG", tr.th_depth_bg), ("ThDepthOBJ", tr.th_depth_obj),
        ("MaxTrackPointBG", tr.max_track_points_bg),
        ("MaxTrackPointOBJ", tr.max_track_points_obj),
        ("SFMgThres", tr.sf_mg_thres), ("SFDsThres", tr.sf_ds_thres),
        ("WINDOW_SIZE", tr.window_size), ("OVERLAP_SIZE", tr.overlap_size),
        ("UseSampleFeature", int(fe.use_sample_feature)),
        ("ORBextractor.nFeatures", fe.n_features),
        ("ORBextractor.scaleFactor", fe.scale_factor),
        ("ORBextractor.nLevels", fe.n_levels),
        ("ORBextractor.iniThFAST", fe.ini_th_fast),
        ("ORBextractor.minThFAST", fe.min_th_fast))
    return "%YAML:1.0\n" + "".join(f"{k}: {v!r}\n" for k, v in keys)


class _TimedReads:
    """A dataset whose reads are timed on the host clock."""

    def __init__(self, base):
        self.base, self.secs, self.n = base, 0.0, 0

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        t0 = time.perf_counter()
        fd = self.base[i]
        self.secs += time.perf_counter() - t0
        self.n += 1
        return fd


def disk_path(scene, device, card: str, libs: dict, seq_root) -> dict:
    """Phase 11: a sequence written to disk (under `seq_root`, kept for
    phase 13c), read by both readers, and driven through the CLI and
    through System over the native reader."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    import vdo_slam_tpu_torch.pipeline as pipeline
    from vdo_slam_tpu_torch import run as cli
    from vdo_slam_tpu_torch.config import load_settings
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL

    out = {"cli_launches": None, "fused_launches": None, "not_run": []}
    if libs["PIL"]:
        print(f"disk path: not run: {libs['PIL']} (the writer and the "
              f"Python reader need it)")
        out["not_run"].append("disk path")
        return out
    from vdo_slam_tpu_torch.io.dataset import SequenceDataset
    from vdo_slam_tpu_torch.io.sequence_writer import write_reference_sequence

    cfg = bench_ba_config()
    tr = cfg.tracking
    z = scene.depth[:N_DISK + 1]
    raw_max = tr.depth_map_factor * cfg.camera.bf / float(z[z > 0].min())
    print(f"disk path: DepthMapFactor * bf / z is at most {raw_max:.1f} "
          f"(uint16 holds 65535)")
    if raw_max > 65535:
        raise RuntimeError("the scene's depth does not fit the uint16 PNG")
    with tempfile.TemporaryDirectory() as tmp:
        first = dataclasses.replace(scene, **{
            f: getattr(scene, f)[:N_DISK + 1] for f in SCENE_FIELDS})
        t0 = time.perf_counter()
        seq = write_reference_sequence(first, Path(seq_root) / "seq",
                                       depth_map_factor=tr.depth_map_factor,
                                       bf=cfg.camera.bf)
        print(f"disk path: {N_DISK + 1} frames written in "
              f"{time.perf_counter() - t0:.2f} s")
        out["seq"] = seq
        yaml = Path(tmp) / "settings.yaml"
        yaml.write_text(settings_yaml(cfg))

        # (a) the readers
        py = SequenceDataset(seq)
        py_frames, t0 = [], time.perf_counter()
        for i in range(N_DISK):
            py_frames.append(py[i])
        py_ms = (time.perf_counter() - t0) / N_DISK * 1e3
        print(f"(a) Python reader: {py_ms:.3f} ms per frame (host clock, "
              f"{N_DISK} frames)")
        if libs["native"]:
            print(f"(a) native reader: not run: {libs['native']}")
            out["not_run"].append("native reader")
        else:
            from vdo_slam_tpu_torch.io.native_loader import \
                NativeSequenceDataset

            nat = NativeSequenceDataset(seq)
            try:
                t0 = time.perf_counter()
                nat_frames = [nat[i] for i in range(N_DISK)]
                nat_ms = (time.perf_counter() - t0) / N_DISK * 1e3
            finally:
                nat.close()
            rgb_err = 0.0
            for a, b in zip(nat_frames, py_frames):
                rgb_err = max(rgb_err, float(np.abs(a.rgb - b.rgb).max()))
                if not (rgb_err <= 1e-5
                        and np.array_equal(a.depth_raw, b.depth_raw)
                        and np.array_equal(a.flow, b.flow)
                        and np.array_equal(a.mask, b.mask)):
                    raise RuntimeError("the native reader differs from the "
                                       "Python reader")
            print(f"(a) native reader: {nat_ms:.3f} ms per frame (host "
                  f"clock, in order, prefetching); equal to the Python "
                  f"reader on all {N_DISK} frames (rgb within {rgb_err:.2e}, "
                  f"depth, flow and mask exact)")
            out["native_ms"] = nat_ms
        out["python_ms"] = py_ms
        del py_frames

        # (b) the CLI's positional form, default mode, both BA passes
        made = []

        class Recording(pipeline.System):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)

        buf = io.StringIO()
        pipeline.System = Recording
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        KERNEL.launches = 0
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli.main([str(yaml), str(seq), "--out",
                               f"{tmp}/out", "--quiet"])
        finally:
            pipeline.System = Recording.__base__
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = KERNEL.launches
        peak = torch.cuda.max_memory_allocated()
        rep = json.loads(buf.getvalue())
        print(f"(b) CLI run.main([settings, sequence]) on the card: exit "
              f"{rc}, {rep['frames']} frames in {secs:.3f} s (host clock, "
              f"reading, tracking, window BA, full BA, result files): "
              f"{rep['frames'] / secs:.3f} fps; {launches} FAST launches; "
              f"peak device memory {peak / 2**20:.1f} MiB [{card}]")
        if rc != 0 or rep["frames"] != N_DISK or launches != N_DISK:
            raise RuntimeError(f"CLI from disk: exit {rc}, {rep['frames']} "
                               f"frames, {launches} FAST launches")
        gate(rep["metrics_initial"], JAX_REF_DISK["disk_cli"]["initial"],
             " (CLI from disk, before full BA)")
        gate(rep["metrics_refined"], JAX_REF_DISK["disk_cli"]["refined"],
             " (CLI from disk, refined)")
        out.update(cli_launches=launches, cli_s=secs, cli_peak=peak)

        # (c) System(mode="fused") over the native reader; without it,
        # over the Python reader, so that the fused path from disk is
        # still gated (the native part stays "not run")
        if libs["native"]:
            print(f"(c) System over the native reader: not run: "
                  f"{libs['native']}; mode fused runs over the Python "
                  f"reader instead")
            out["not_run"].append("mode fused over the native reader")
            reader, what = _TimedReads(SequenceDataset(seq)), "Python"
        else:
            from vdo_slam_tpu_torch.io.native_loader import \
                NativeSequenceDataset

            reader = _TimedReads(NativeSequenceDataset(seq))
            what = "native"
        sysm = pipeline.System(load_settings(yaml), enable_local_ba=False,
                               enable_global_ba=False, mode="fused",
                               device=device)
        KERNEL.launches = 0
        t0 = time.perf_counter()
        try:
            reps = sysm.run_sequence(reader)
        finally:
            if what == "native":
                reader.base.close()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = KERNEL.launches
        read_ms = reader.secs / reader.n * 1e3
        print(f"(c) System(mode='fused') over the {what} reader: "
              f"{len(reps)} frames in {secs:.3f} s, {launches} FAST "
              f"launches; the reader took {read_ms:.3f} ms per frame on "
              f"its thread while the card tracked [{card}]")
        if len(reps) != N_DISK or launches != N_DISK:
            raise RuntimeError(f"fused from disk: {len(reps)} frames, "
                               f"{launches} FAST launches")
        gate(sysm.metrics(), JAX_REF_DISK["disk_fused"]["initial"],
             f" (mode fused over the {what} reader)")
        out.update(fused_launches=launches, fused_reader=what,
                   read_ms_tracking=read_ms)

        # (d) the drawings of (b)'s map
        if libs["matplotlib"]:
            print(f"(d) drawings: not run: {libs['matplotlib']}")
            out["not_run"].append("drawings")
        else:
            from vdo_slam_tpu_torch.eval.visualize import (
                draw_frame, draw_scene_flow_birdeye, draw_trajectory)

            m = made[0].map
            f = N_DISK // 2
            P, Pl = m.dyn_3d[f], m.dyn_3d[f - 1]
            a = m.dyn_assoc[f - 1]
            ok = m.dyn_valid[f] & (a >= 0)
            flow3d = P - Pl[np.clip(a, 0, len(Pl) - 1)]
            paths = [
                draw_frame(SequenceDataset(seq)[f].rgb, m.stat_xy[f],
                           m.stat_valid[f], m.dyn_xy[f],
                           m.dyn_obj_label[f], m.dyn_valid[f],
                           f"{tmp}/frame.png"),
                draw_trajectory(m, f"{tmp}/trajectory.png"),
                draw_scene_flow_birdeye(P, flow3d, ok, f"{tmp}/birdeye.png",
                                        x_range=(-30.0, 30.0),
                                        z_range=(0.0, 60.0))]
            sizes = [Path(p).stat().st_size for p in paths]
            print(f"(d) drawings of (b)'s map: {dict(zip(paths, sizes))} "
                  f"bytes")
            if min(sizes) <= 5000:
                raise RuntimeError(f"a drawing is {min(sizes)} bytes, want "
                                   f"> 5000")
    return out


N_GROUPED_FRAMES = 16       # phase 12b: frames per stream
SHARDS = (1, 2, 4)          # phase 12a: edge shards on the one card
# phase 12a: the JAX package's own sharded check (__graft_entry__.py:
# 253-256): cost within 10 % of the single-device solve, poses within 1e-3
SHARD_COST_REL, SHARD_POSE_TOL = 0.1, 1e-3
# phase 12c: orientations within 1e-4 rad where the centroid moment is at
# least 20, and (gap x moment) within 2e-3 everywhere: each side's fp32 sum
# of 961 terms of magnitude <= 15 rounds by up to ~8.6e-4
# (tests/test_torch_orb_grid.py); descriptor bits equal on >= 99 %
ORB_ANGLE_TOL, ORB_STRONG_M, ORB_MOMENT_TOL, ORB_BITS = 1e-4, 20.0, 2e-3, 0.99


def sharded_ba(ba: dict, cfg, device, card: str) -> dict:
    """Phase 12a: phase 5's map from before its full BA, refined with the
    edges sharded over [device] * n, against phase 5's full BA; then each
    n > 1 from its graphs against the eager sharded solve
    (sharded_graphs)."""
    import copy

    from vdo_slam_tpu_torch.backend.full_ba import full_ba_inplace
    from vdo_slam_tpu_torch.eval.results import metric_report
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL

    pre, ref = ba["pre_full_map"], ba["system"].map
    ref_rep = ba["system"].full_ba_report
    ref_poses = np.stack(ref.cam_pose_rf).astype(np.float64)
    print(f"torch.cuda.device_count() = {torch.cuda.device_count()}; the "
          f"shards below share one card [{card}]")
    out = {"t_solve_s": {}, "pose_gap": {}}
    reps = {}
    KERNEL.launches = 0
    for n in SHARDS:
        m = copy.deepcopy(pre)
        torch.cuda.synchronize()
        rep = full_ba_inplace(m, cfg, device=device, devices=[device] * n)
        gap = float(np.abs(np.stack(m.cam_pose_rf).astype(np.float64)
                           - ref_poses).max())
        rel = abs(rep["cost"] - ref_rep["cost"]) / max(ref_rep["cost"], 1e-6)
        print(f"full BA over {n} shard(s): {rep['iters_run']} LM iterations, "
              f"cost {rep['cost0']:.9g} -> {rep['cost']:.9g} (phase 5: "
              f"{ref_rep['cost0']:.9g} -> {ref_rep['cost']:.9g}, "
              f"{rel:.3e} apart); t_solve_s {rep['t_solve_s']:.4f} "
              f"(phase 5: {ref_rep['t_solve_s']:.4f}); largest pose-entry "
              f"gap to phase 5 {gap:.3e} [{card}]")
        if not (rel <= SHARD_COST_REL and gap < SHARD_POSE_TOL):
            raise RuntimeError(f"{n} shards: cost {rel:.3e} apart, pose gap "
                               f"{gap:.3e} from the single-device full BA")
        if not rep["cost"] < rep["cost0"]:
            raise RuntimeError(f"{n} shards: the full BA did not lower the "
                               f"cost")
        gate(metric_report(m, refined=True), JAX_REF_BA["refined"],
             f" (full BA over {n} shard(s), refined)")
        reps[n] = (rep, m)
        out["t_solve_s"][n] = rep["t_solve_s"]
        out["pose_gap"][n] = gap
    out["graphed"] = sharded_graphs(pre, cfg, device, card, reps, ref_rep)
    if KERNEL.launches:
        raise RuntimeError("the full BA launched the FAST kernel")
    return out


def sharded_graphs(pre, cfg, device, card: str, eager: dict,
                   one: dict) -> dict:
    """Phase 12a, graphed: for each shard count n > 1, FullBAGraphs over
    [device] * n warmed by warmup_full_ba (one graph per chunk length),
    then full_ba_inplace from them on a copy of `pre`, against the eager
    sharded solve of the same n (`eager`: its report and map): the cost
    within GRAPH_SHARD_COST_RTOL, the refined poses within the stream
    bounds; beside the one-device full BA's cost (`one`), and the host
    launch calls per chunk of a graphed solve."""
    import copy

    from vdo_slam_tpu_torch.backend.full_ba import (FullBAGraphs,
                                                    full_ba_inplace,
                                                    warmup_full_ba)

    out = {}
    for n in SHARDS[1:]:
        devices = [device] * n
        graphs = FullBAGraphs(devices)
        t0 = time.perf_counter()
        warmup_full_ba(cfg, pre.num_frames, graphs)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        m = copy.deepcopy(pre)
        t0 = time.perf_counter()
        rep = full_ba_inplace(m, cfg, device=device, devices=devices,
                              graphs=graphs)
        wall = (time.perf_counter() - t0) * 1e3
        e_rep, e_map = eager[n]
        rel = abs(rep["cost"] - e_rep["cost"]) / e_rep["cost"]
        rel_one = abs(rep["cost"] - one["cost"]) / one["cost"]
        gaps = [_pose_gap(a, b) for a, b in zip(m.cam_pose_rf,
                                               e_map.cam_pose_rf)]
        dt, dr = max(x[0] for x in gaps), max(x[1] for x in gaps)
        mm = copy.deepcopy(pre)
        calls, kernels, _ = _host_launches(
            lambda: full_ba_inplace(mm, cfg, device=device, devices=devices,
                                    graphs=graphs))
        chunks = len(rep["chunk_times"])
        per_iter = kernels / rep["iters_run"]
        out[n] = {"warm_s": warm, "wall_ms": wall, "cost": rep["cost"],
                  "cost_rel_eager": rel, "cost_rel_one": rel_one,
                  "pose_gap": (dt, dr), "host_calls": calls,
                  "host_calls_per_chunk": calls / chunks,
                  "kernels": kernels, "kernels_per_iter": per_iter,
                  "records": graphs.records()}
        print(f"12a, full BA over {n} shards from its graphs: warm-up and "
              f"capture {warm:.3f} s ({len(graphs.records())} graphs: "
              f"{json.dumps(graphs.records())}); {rep['iters_run']} LM "
              f"iterations in {chunks} chunks, cost {rep['cost0']:.9g} -> "
              f"{rep['cost']:.9g}, {rel:.3e} from the eager sharded solve "
              f"({e_rep['cost']:.9g}) and {rel_one:.3e} from one device's "
              f"({one['cost']:.9g}); largest pose gap to the eager sharded "
              f"solve {dt:.3e} m, {dr:.3e} deg; wall {wall:.3f} ms, solve "
              f"{rep['t_solve_s']:.4f} s against {e_rep['t_solve_s']:.4f} s "
              f"eager; {calls} host launch calls ({calls / chunks:.1f} per "
              f"chunk) and {kernels} kernels per graphed solve "
              f"({per_iter:.1f} per LM iteration, graph build, upload and "
              f"fetch included) [{card}]")
        if not rel <= GRAPH_SHARD_COST_RTOL:
            raise RuntimeError(f"12a: {n} shards graphed, cost {rel:.3e} "
                               f"from the eager sharded solve")
        if not (dt < STREAM_T_TOL_M and dr < STREAM_R_TOL_DEG):
            raise RuntimeError(f"12a: {n} shards graphed, poses {dt} m, "
                               f"{dr} deg from the eager sharded solve")
    return out


def grouped_streams(pds, cfg, device, card: str) -> dict:
    """Phase 12b: four streams in two groups on [device] * 2 against the
    four in one group, over the first N_GROUPED_FRAMES frames of phase 7's
    windows, in the same call."""
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL
    from vdo_slam_tpu_torch.parallel import MultiStreamSystem

    views = [_View(pds, off, N_GROUPED_FRAMES)
             for off in stream_offsets(len(pds))]
    runs = {}
    for groups, devices in ((1, [device]), (2, [device] * 2)):
        msys = MultiStreamSystem(cfg, n_streams=N_STREAMS,
                                 enable_local_ba=False, devices=devices)
        if len(msys.groups) != groups:
            raise RuntimeError(f"{len(msys.groups)} stream groups, want "
                               f"{groups}")
        torch.cuda.synchronize()
        KERNEL.launches = 0
        JOIN_WAIT.update(s=0.0, joins=0)
        t0 = time.perf_counter()
        msys.run(views)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = KERNEL.launches
        join_wait(f"S={N_STREAMS} in {groups} group(s)", card)
        no_ba_failures(msys.trackers, f"S={N_STREAMS} in {groups} group(s)")
        agg = N_STREAMS * N_GROUPED_FRAMES / wall
        print(f"S={N_STREAMS} in {groups} group(s): {launches} FAST launches "
              f"in {N_GROUPED_FRAMES} frames; {agg:.3f} aggregate fps (host "
              f"clock, window BA off, first frame included) [{card}]")
        if launches != groups * N_GROUPED_FRAMES:
            raise RuntimeError(f"{launches} FAST launches, want "
                               f"{groups * N_GROUPED_FRAMES}: one per group "
                               f"per frame")
        runs[groups] = (msys, launches, agg)
    one, two = runs[1][0], runs[2][0]
    per1, per2 = one.metrics()["per_stream"], two.metrics()["per_stream"]
    worst = (0.0, 0.0)
    for st in range(N_STREAMS):
        gaps = [_pose_gap(a, b) for a, b in zip(two.maps[st].cam_pose,
                                                one.maps[st].cam_pose)]
        dt, dr = max(g[0] for g in gaps), max(g[1] for g in gaps)
        worst = (max(worst[0], dt), max(worst[1], dr))
        if not (dt < STREAM_T_TOL_M and dr < STREAM_R_TOL_DEG):
            raise RuntimeError(f"stream {st}: two groups against one: pose "
                               f"gap {dt} m, {dr} deg")
        if per2[st]["n_obj_estimates"] != per1[st]["n_obj_estimates"]:
            raise RuntimeError(f"stream {st}: {per2[st]['n_obj_estimates']} "
                               f"object estimates in two groups, "
                               f"{per1[st]['n_obj_estimates']} in one")
    print(f"two groups against one: largest pose gap {worst[0]:.3e} m, "
          f"{worst[1]:.3e} deg (bound {STREAM_T_TOL_M} m / "
          f"{STREAM_R_TOL_DEG} deg); equal estimate counts [{card}]")
    return {"launches": runs[2][1], "agg_fps": {g: r[2] for g, r in
                                                 runs.items()},
            "worst_gap": worst}


def orb_grid(scene, device, card: str) -> dict:
    """Phase 12c: ORB and the feature grid on the card at the FAST
    keypoints of the bench scene's first frame, against the CPU."""
    from vdo_slam_tpu_torch.ops import fast, grid, orb

    gray = torch.from_numpy(np.ascontiguousarray(scene.rgb[0],
                                                 np.float32)).to(device)
    det = fast.detect_pyramid(gray)
    xy = det["xy"][det["valid"]].contiguous()
    H, W = gray.shape

    def run(d, angle=None):
        """Every function on device d; `angle` given to a second
        descriptor call (its own angles where None)."""
        g, p = gray.to(d), xy.to(d)
        ang = orb.orientations(g, p)
        desc = orb.descriptors(g, p)
        shared = orb.descriptors(g, p, ang if angle is None else angle.to(d))
        valid = torch.ones(len(p), dtype=torch.bool, device=d)
        best, dist = orb.match_hamming(desc, desc.roll(1, 0), valid, valid)
        table, counts = grid.assign_to_grid(p, valid, width=W, height=H)
        areas = [grid.features_in_area(p, valid, c, 20.0)
                 for c in p[::max(len(p) // 8, 1)]]
        return ([x.cpu() for x in (ang, desc, shared, best, dist, table,
                                   counts)],
                [x.cpu() for pair in areas for x in pair])

    (ang_c, desc_c, _, best_c, dist_c, tab_c, cnt_c), areas_c = run(
        torch.device("cpu"))
    (ang_g, desc_g, shared_g, best_g, dist_g, tab_g, cnt_g), areas_g = run(
        device, angle=ang_c)
    p64 = orb._gather_patches(gray.double(), xy).cpu().numpy() * orb._MASK
    m = np.hypot((p64 * orb._DX).sum((1, 2)), (p64 * orb._DY).sum((1, 2)))
    gap = np.abs(np.angle(np.exp(1j * (ang_g.double() - ang_c.double())
                                 .numpy())))
    strong = m >= ORB_STRONG_M

    def bits_equal(a, b):
        return float((np.unpackbits(a.numpy(), axis=1)
                      == np.unpackbits(b.numpy(), axis=1)).mean())

    bits = bits_equal(desc_g, desc_c)
    same_grid = (torch.equal(tab_g, tab_c) and torch.equal(cnt_g, cnt_c)
                 and all(torch.equal(a, b) for a, b in zip(areas_g, areas_c)))
    same_match = torch.equal(best_g, best_c) and torch.equal(dist_g, dist_c)
    print(f"ORB at {len(xy)} FAST keypoints of frame 0, card against CPU: "
          f"orientation gap {gap.max():.3e} rad at most "
          f"({gap[strong].max(initial=0.0):.3e} where |m| >= "
          f"{ORB_STRONG_M}, {int((~strong).sum())} keypoints below; gap x "
          f"|m| {(gap * m).max():.3e}); descriptor bits equal {bits:.6f} "
          f"(with the CPU's angles {bits_equal(shared_g, desc_c):.6f}); "
          f"Hamming matches identical {same_match}; grid table, counts and "
          f"{len(areas_c) // 2} area queries identical {same_grid} [{card}]")
    if not (gap[strong].max(initial=0.0) <= ORB_ANGLE_TOL
            and (gap * m).max() <= ORB_MOMENT_TOL):
        raise RuntimeError("ORB orientations differ from the CPU's")
    if not (bits >= ORB_BITS and same_grid and same_match):
        raise RuntimeError("ORB descriptors, matches or the grid differ "
                           "from the CPU's")
    return {"n_keypoints": len(xy), "angle_gap": float(gap.max()),
            "bits_equal": bits}


def _bench_record(text: str, metric: str) -> dict:
    """The port's bench printed one JSON line, with bench.py's keys and
    `metric`, and vs_baseline = fps / 0.249 (value is fps to 3 places)."""
    lines = text.splitlines()
    if len(lines) != 1:
        raise RuntimeError(f"the bench printed {len(lines)} stdout lines, "
                           f"want 1: {lines}")
    rec = json.loads(lines[0])
    if (set(rec) != {"metric", "value", "unit", "vs_baseline"}
            or rec["metric"] != metric or rec["unit"] != "frames/sec"
            or not rec["value"] > 0
            or abs(rec["vs_baseline"] - rec["value"] / 0.249) > 3e-3):
        raise RuntimeError(f"the bench's JSON line {rec}, want metric "
                           f"{metric}")
    print(f"bench JSON line: {lines[0]}")
    return rec


def bench_hard(device, card: str) -> dict:
    """Phase 13a: the port's bench.main(hard=True) at full size, stdout
    captured: its JSON line, one FAST launch per frame (plus those of the
    stage probe after the timed region), and both metric reports gated
    against JAX_REF_HARD."""
    import contextlib
    import io
    import os

    from vdo_slam_tpu_torch import bench as port_bench
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL

    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.launches = 0
    JOIN_WAIT.update(s=0.0, joins=0)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = port_bench.main(hard=True, device=device)
    secs = time.perf_counter() - t0
    launches = KERNEL.launches
    join_wait("bench --hard (warm and timed run_sequence)", card)
    no_ba_failures([res["system"].tracker], "bench --hard")
    peak = torch.cuda.max_memory_allocated()
    rec = _bench_record(buf.getvalue(), "kitti_synth_hard_fps")
    n = res["frames"]
    # the stage probe's, from its graphs' records: each warm-up's, and
    # each capture's launch per replay
    probe = (0 if os.environ.get("VDO_BENCH_NO_PROBE")
             else probe_fast_launches(res["system"].tracker.probe_report))
    solves = res["window_solve_ms"]
    first = solves[0] if solves else math.nan
    rest = float(np.median(solves[1:])) if len(solves) > 1 else math.nan
    full = res["full_ba"]
    print(f"bench --hard, the full BA replayed from its graphs: solve "
          f"{full['t_solve_s']:.4f} s, build {full['t_build_s']:.4f} s, "
          f"write-back {full['t_writeback_s']:.4f} s; captures "
          f"{json.dumps(res['full_ba_graphs'])} [{card}]")
    if not res["full_ba_graphs"]:
        raise RuntimeError("bench --hard: the full BA's graphs were not "
                           "captured")
    print(f"bench --hard: {rec['value']} fps over {n - port_bench.warmup_frames()}"
          f" timed frames (tracking, {len(solves)} window solves and the "
          f"full BA: {full['t_build_s'] + full['t_solve_s'] + full['t_writeback_s']:.3f} s); "
          f"{secs:.1f} s in all with the scene, packing, warm frames and "
          f"the probe; {launches} FAST launches ({n} frames + {probe} in "
          f"the probe); peak device memory {peak / 2**20:.1f} MiB [{card}]")
    print(f"bench --hard, window solves in the timed region: the first "
          f"{first:.3f} ms, the median of the rest {rest:.3f} ms "
          f"({first / rest:.3f}x); all {json.dumps(solves)} [{card}]")
    if launches != n + probe:
        raise RuntimeError(f"bench --hard: {launches} FAST launches, want "
                           f"{n} + {probe}")
    if len(solves) != JAX_REF_HARD["window_solves"]:
        raise RuntimeError(f"bench --hard: {len(solves)} window solves, want "
                           f"{JAX_REF_HARD['window_solves']}")
    if not full["cost"] < full["cost0"]:
        raise RuntimeError("bench --hard: the full BA did not lower the cost")
    sysm = res["system"]
    gate(sysm.metrics(), JAX_REF_HARD["initial"], " (bench --hard, before "
         "full BA)")
    gate(sysm.metrics(refined=True), JAX_REF_HARD["refined"],
         " (bench --hard, refined)")
    return {"launches": launches, "fps": rec["value"], "peak_bytes": peak,
            "first_solve_ms": first, "median_solve_ms": rest}


def bench_throughput(device, card: str, peak_s4: int) -> dict:
    """Phase 13b: the port's bench_multistream(6, tag="_throughput") (6
    streams x 40 frames), stdout captured: its JSON line, one FAST launch
    per frame for all six streams, each stream gated against JAX_REF_S6,
    and peak memory within 1.25x of phase 7's S = 4 peak scaled by 6 / 4."""
    import contextlib
    import io

    from vdo_slam_tpu_torch import bench as port_bench
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL

    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.launches = 0
    JOIN_WAIT.update(s=0.0, joins=0)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = port_bench.bench_multistream(N_THROUGHPUT, tag="_throughput",
                                           device=device)
    secs = time.perf_counter() - t0
    launches = KERNEL.launches
    join_wait(f"bench --throughput (S={N_THROUGHPUT})", card)
    no_ba_failures(res["system"].trackers, "bench --throughput")
    peak = torch.cuda.max_memory_allocated()
    rec = _bench_record(
        buf.getvalue(),
        f"kitti_synth_multistream{N_THROUGHPUT}_throughput_aggregate_fps")
    msys = res["system"]
    bound = 1.25 * peak_s4 * N_THROUGHPUT / N_STREAMS
    print(f"bench --throughput: S={N_THROUGHPUT}, {rec['value']} aggregate "
          f"fps ({rec['value'] / N_THROUGHPUT:.3f} per stream) after "
          f"{port_bench.WARM} warm frames; {secs:.1f} s in all; {launches} "
          f"FAST launches in {N_STREAM_FRAMES} frames; peak device memory "
          f"{peak} bytes ({peak / 2**20:.1f} MiB; bound {bound / 2**20:.1f} "
          f"MiB) [{card}]")
    if launches != N_STREAM_FRAMES:
        raise RuntimeError(f"bench --throughput: {launches} FAST launches in "
                           f"{N_STREAM_FRAMES} batched frames, want one per "
                           f"frame")
    if res["offsets"] != JAX_REF_S6["offsets"]:
        raise RuntimeError(f"stream offsets {res['offsets']}")
    if ([len(t.ba_health) for t in msys.trackers]
            != JAX_REF_S6["window_solves"]):
        raise RuntimeError("bench --throughput: window solve counts differ "
                           "from the JAX run's")
    if not peak <= bound:
        raise RuntimeError(f"bench --throughput: peak memory {peak} above "
                           f"{bound}")
    for st, (rep, ref) in enumerate(zip(msys.metrics()["per_stream"],
                                        JAX_REF_S6["per_stream"])):
        gate(rep, ref, f" (bench --throughput, stream {st})")
    return {"launches": launches, "fps": rec["value"], "peak_bytes": peak}


def packed_dir(seq, device, card: str) -> dict:
    """Phase 13c: the port's pack_sequence CLI over phase 11's written
    sequence with tpu_fast's wire flags; PackedDataset(dir) byte-equal to
    an InMemoryPackedDataset of the same frames; System(mode="fused") over
    the directory (bench.py's config, fused_chunk 1, BA off) against the
    same over the in-memory frames."""
    import contextlib
    import io
    import tempfile

    from vdo_slam_tpu_torch import bench as port_bench
    from vdo_slam_tpu_torch.io.dataset import SequenceDataset
    from vdo_slam_tpu_torch.io.packed_dataset import (InMemoryPackedDataset,
                                                      PackedDataset)
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL
    from vdo_slam_tpu_torch.pipeline import System
    from vdo_slam_tpu_torch.tools import pack_sequence

    if seq is None:
        print("(13c) packed directory: not run: phase 11 wrote no sequence")
        return {"launches": None}
    cfg = port_bench.bench_config()
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking,
                                                   fused_chunk=1))
    tr = cfg.tracking
    with tempfile.TemporaryDirectory() as tmp:
        argv = [str(seq), f"{tmp}/packed", "--depth-map-factor",
                str(tr.depth_map_factor), "--flow-delta", "--entropy"]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = pack_sequence.main(argv)
        pack_s = time.perf_counter() - t0
        pdir = PackedDataset(f"{tmp}/packed")
        pdir.check_config(cfg)
        mem = InMemoryPackedDataset(
            SequenceDataset(seq), depth_map_factor=tr.depth_map_factor,
            flow_down=tr.flow_down, flow_delta=tr.flow_delta,
            depth_down=tr.depth_down, depth_resid=tr.depth_resid,
            entropy=tr.entropy, seg_cap=tr.wire_seg_cap,
            depth_exc_cap=tr.wire_depth_exc_cap)
        print(f"(13c) pack_sequence {' '.join(argv[2:])}: exit {rc}, "
              f"{buf.getvalue().strip()!r}, {len(pdir)} frames in "
              f"{pack_s:.2f} s, {pdir.meta['wire_len'] * 2} bytes per frame")
        if rc != 0 or len(pdir) != len(mem):
            raise RuntimeError(f"pack_sequence: exit {rc}, {len(pdir)} "
                               f"frames packed, want {len(mem)}")
        for i in range(len(mem)):
            a, b = pdir[i], mem[i]
            if not (np.array_equal(np.asarray(a.packed), b.packed.ravel())
                    and np.array_equal(a.pose_gt_raw, b.pose_gt_raw)
                    and np.array_equal(a.obj_gt_rows, b.obj_gt_rows)
                    and a.timestamp == b.timestamp):
                raise RuntimeError(f"packed directory frame {i} differs from "
                                   f"the in-memory pack")
        t0 = time.perf_counter()
        for i in range(len(pdir)):
            np.array(pdir[i].packed)
        row_ms = (time.perf_counter() - t0) / len(pdir) * 1e3
        print(f"(13c) PackedDataset: every frame's packed bytes, pose, "
              f"object rows and time equal to the in-memory pack's "
              f"({len(pdir)} frames); a frame's read (memmap row and a copy "
              f"of it) {row_ms:.4f} ms on the host")
        runs = {}
        reads = _TimedReads(pdir)
        for name, ds in (("directory", reads), ("in memory", mem)):
            sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                          mode="fused", device=device)
            torch.cuda.synchronize()
            KERNEL.launches = 0
            t0 = time.perf_counter()
            reps = sysm.run_sequence(_View(ds, 0, N_DISK))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = KERNEL.launches
            print(f"(13c) System(mode='fused') over the {name} packs: "
                  f"{len(reps)} frames in {secs:.3f} s, {launches} FAST "
                  f"launches [{card}]")
            if len(reps) != N_DISK or launches != N_DISK:
                raise RuntimeError(f"{name}: {len(reps)} frames, {launches} "
                                   f"FAST launches, want {N_DISK} and "
                                   f"{N_DISK}")
            runs[name] = (sysm, launches)
    print(f"(13c) the directory reader's __getitem__ took "
          f"{reads.secs / reads.n * 1e3:.4f} ms per frame on its thread "
          f"while the card tracked (the memmap row is copied by the upload)")
    (a, la), (b, _) = runs["directory"], runs["in memory"]
    gaps = [_pose_gap(x, y) for x, y in zip(a.map.cam_pose, b.map.cam_pose)]
    dt, dr = max(g[0] for g in gaps), max(g[1] for g in gaps)
    ea, eb = a.metrics(), b.metrics()
    print(f"(13c) directory against in memory: largest pose gap {dt:.3e} m, "
          f"{dr:.3e} deg (bound {STREAM_T_TOL_M} m / {STREAM_R_TOL_DEG} "
          f"deg); metrics {json.dumps(ea)} / {json.dumps(eb)} [{card}]")
    if not (dt < STREAM_T_TOL_M and dr < STREAM_R_TOL_DEG
            and ea["n_obj_estimates"] == eb["n_obj_estimates"]):
        raise RuntimeError("the packed directory's run differs from the "
                           "in-memory run")
    return {"launches": la, "row_ms": row_ms, "pose_gap": (dt, dr)}


# The JAX package's own dry run, leg (c), from MULTICHIP_r05.json (JAX on a
# virtual mesh of 8 CPU devices): accuracy figures, not times.
JAX_REF_GRAFT = {"cost0": 0.1849, "cost": 0.09363, "cost_ref": 0.09363,
                 "pose_err": 2.98e-8, "n_points": 19697, "n_edges": 52854,
                 "n_motions": 50, "n_dyn": 18226}


def check_graft_pyramids(args, device) -> float:
    """Phase 15's FAST launches at the shapes its paths give the kernel,
    against the plain version (atol=0), one launch per pyramid: entry()'s
    frame as its 2-level 96x64 pyramid, the dry run's eight streams' frames
    as S = 1 stacks (leg (a) runs one stream per device group), and frames
    0, 12 and 24 of leg (c)'s 256x192 scene as its 3-level pyramid.
    Returns the largest abs error."""
    from vdo_slam_tpu_torch import graft_entry
    from vdo_slam_tpu_torch.io.synthetic import make_scene
    from vdo_slam_tpu_torch.ops import fast
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL, fast_score_pyramid
    from vdo_slam_tpu_torch.ops.image import rgb_to_gray

    cfg, mcfg = graft_entry._tiny_config(), graft_entry._medium_config()
    cases = [("entry()'s frame", cfg, rgb_to_gray(args[1]["rgb"]))]
    cases += [(f"leg (a)'s stream {s} as an S = 1 stack", cfg, rgb_to_gray(
        graft_entry._example_inputs(cfg, seed=s, device=device)["rgb"])[None])
        for s in range(N_GRAFT)]
    scene = make_scene(num_frames=25, width=mcfg.camera.width,
                       height=mcfg.camera.height, num_objects=3, seed=11)
    cases += [(f"leg (c)'s frame {f}", mcfg,
               torch.from_numpy(scene.rgb[f]).to(device)) for f in (0, 12, 24)]
    max_err = 0.0
    for what, c, gray in cases:
        fe = c.frontend
        ti, tm = fe.ini_th_fast * (1.0 / 255.0), fe.min_th_fast * (1.0 / 255.0)
        lv = fast.pyramid(gray, fe.n_levels, fe.scale_factor)
        before = KERNEL.launches
        pairs = fast_score_pyramid(lv, ti, tm)
        torch.cuda.synchronize()
        if KERNEL.launches != before + 1:
            raise RuntimeError(f"pyramid of {what}: "
                               f"{KERNEL.launches - before} launches, want 1")
        for l, (g, (k_ini, k_min)) in enumerate(zip(lv, pairs)):
            stacks = (g, k_ini, k_min) if g.ndim == 3 else (
                g[None], k_ini[None], k_min[None])
            for gs, ks_ini, ks_min in zip(*stacks):
                max_err = max(max_err, held(
                    f"one launch for the pyramid of {what}, level {l} "
                    f"{tuple(g.shape)}", gs, ks_ini, ks_min, ti, tm))
    return max_err


def graft_entry_phase(device, card: str) -> dict:
    """Phase 15: the port's counterpart of __graft_entry__.py.  entry()'s
    step once (one FAST launch, a finite pose), then dryrun_multichip(8)
    over the one card (cuda:0 eight times) with the original's asserts,
    its FAST launches (one per stream group per frame in leg (a): 16; 2 for
    the solo step; 24 for leg (c)'s tracking), leg (c)'s numbers beside the
    JAX run's, leg (c)'s full BA from its graphs (captured in the leg)
    against the eager one (cost within GRAPH_SHARD_COST_RTOL) with its
    host launch calls and kernels per chunk, and the kernel against its
    plain version at this phase's pyramid shapes."""
    from vdo_slam_tpu_torch import graft_entry
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL

    fn, args = graft_entry.entry()
    KERNEL.launches = 0
    state, _ = fn(*args)
    torch.cuda.synchronize()
    entry_launches = KERNEL.launches
    T = state.frame.T_cw.cpu().numpy()
    print(f"(15a) entry(): one step on {args[0].frame.T_cw.device}, "
          f"{entry_launches} FAST launch(es), T_cw finite "
          f"{bool(np.isfinite(T).all())} [{card}]")
    if entry_launches != 1 or not np.isfinite(T).all():
        raise RuntimeError("entry(): want one FAST launch and a finite pose")

    KERNEL.launches = 0
    t0 = time.perf_counter()
    res = graft_entry.dryrun_multichip(N_GRAFT)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = KERNEL.launches
    # leg (a): one batched launch per stream group per frame; leg (b): one
    # per solo frame; leg (c): one per frame tracked (the dataset of a
    # 25-frame scene holds 24)
    want = 2 * N_GRAFT + 2 + 24
    solo, ba = res["solo"], res["full_ba"]
    print(f"(15b) dryrun_multichip({N_GRAFT}) over {len(res['devices'])} x "
          f"{res['devices'][0]} in {secs:.1f} s, {launches} FAST launches "
          f"(want {want}); stream 0 against the solo step: pose "
          f"{solo['pose_gap']:.3e} (bound {graft_entry.SOLO_POSE_TOL}), "
          f"t_rpe {solo['rpe_gap']:.3e} (bound {graft_entry.SOLO_RPE_TOL}) "
          f"[{card}]")
    print(f"(15b) leg (c), port on the card / JAX (MULTICHIP_r05, virtual "
          f"CPU mesh): " + ", ".join(
              f"{k} {ba[k]:.6g} / {v:.6g}" for k, v in JAX_REF_GRAFT.items()))
    if launches != want:
        raise RuntimeError(f"dryrun_multichip: {launches} FAST launches, "
                           f"want {want}")
    if not (solo["pose_gap"] < graft_entry.SOLO_POSE_TOL
            and solo["rpe_gap"] < graft_entry.SOLO_RPE_TOL):
        raise RuntimeError("dryrun_multichip: stream 0 against the solo "
                           "step out of bounds")
    if not (ba["cost"] <= ba["cost0"] and ba["pose_err"]
            < graft_entry.POSE_TOL and abs(ba["cost"] - ba["cost_ref"])
            <= graft_entry.COST_REL_TOL * ba["cost_ref"] + 1e-6):
        raise RuntimeError("dryrun_multichip: the sharded full BA out of "
                           "bounds")
    graphed = graft_graphs(ba, device, card)
    err = check_graft_pyramids(args, device)
    return {"entry_launches": entry_launches, "launches": launches,
            "seconds": secs, "max_abs_err": err, "graphed": graphed}


def graft_graphs(ba: dict, device, card: str) -> dict:
    """Phase 15d: dryrun_multichip's leg (c) solved over its N_GRAFT shards
    from the graphs the leg captured (full_ba.graphs_for) against the
    eager sharded solve of the same map: the costs, the relative gap
    (GRAPH_SHARD_COST_RTOL), the largest pose gap (the stream bounds),
    wall ms each way; then one chunk's solve (full_ba_chunk iterations,
    which replays the same graph) under torch.profiler: host launch calls
    and kernels per chunk (a trace of the whole solve's ~265,000 kernels
    takes tens of seconds to read)."""
    import copy

    from vdo_slam_tpu_torch import graft_entry
    from vdo_slam_tpu_torch.backend.full_ba import full_ba_inplace

    graphs = ba["graphs"]
    chunk = ba["config"].backend.full_ba_chunk
    if graphs is None or not graphs.records():
        raise RuntimeError("15d: leg (c) captured no full-BA graph")
    devices = [device] * N_GRAFT
    res = {}
    for name, g in (("eager", None), ("graphed", graphs)):
        m = copy.deepcopy(ba["map"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = full_ba_inplace(m, ba["config"],
                              iters=graft_entry.FULL_BA_ITERS, device=device,
                              devices=devices, graphs=g)
        res[name] = (rep, m, (time.perf_counter() - t0) * 1e3)
    (e, me, wall_e), (gr, mg, wall_g) = res["eager"], res["graphed"]
    rel = abs(gr["cost"] - e["cost"]) / e["cost"]
    gaps = [_pose_gap(a, b) for a, b in zip(mg.cam_pose_rf, me.cam_pose_rf)]
    dt, dr = max(x[0] for x in gaps), max(x[1] for x in gaps)
    mh = copy.deepcopy(ba["map"])
    n_calls = len(graphs._calls)
    one = {}
    calls, kernels, _ = _host_launches(
        lambda: one.update(full_ba_inplace(
            mh, ba["config"], iters=chunk, device=device,
            devices=devices, graphs=graphs)))
    print(f"(15d) leg (c)'s full BA over {N_GRAFT} shards from its graphs "
          f"({json.dumps(graphs.records())}): cost {gr['cost0']:.9g} -> "
          f"{gr['cost']:.9g} graphed, {e['cost0']:.9g} -> {e['cost']:.9g} "
          f"eager (relative gap {rel:.3e}; the leg's own solve "
          f"{ba['cost']:.9g}); largest pose gap {dt:.3e} m, {dr:.3e} deg; "
          f"wall {wall_g:.3f} / {wall_e:.3f} ms over "
          f"{len(gr['chunk_times'])} chunks; one chunk's solve: {calls} host "
          f"launch calls and {kernels} kernels ({kernels / chunk:.0f} per "
          f"LM iteration, graph build, upload and fetch included) "
          f"[{card}]")
    if not rel <= GRAPH_SHARD_COST_RTOL:
        raise RuntimeError(f"15d: graphed cost {gr['cost']}, eager "
                           f"{e['cost']}")
    if not (dt < STREAM_T_TOL_M and dr < STREAM_R_TOL_DEG):
        raise RuntimeError(f"15d: poses {dt} m, {dr} deg apart")
    if len(graphs._calls) != n_calls or one["iters_run"] != chunk:
        raise RuntimeError("15d: the one-chunk solve did not replay the "
                           "leg's graph")
    return {"cost_rel": rel, "pose_gap": (dt, dr), "wall_ms": wall_g,
            "eager_wall_ms": wall_e, "host_calls_per_chunk": calls,
            "kernels_per_chunk": kernels}


# phase 16: graphed against eager.  The S = 1 cell is phase 4's 25 frames,
# the S = 4 cell phase 7's four 40-frame windows; both held per frame to
# the step's card-vs-CPU bounds (STREAM_T_TOL_M, STREAM_R_TOL_DEG) and to
# equal object estimates.  A tier's graphed window solve is held to the
# eager one within GRAPH_COST_RTOL of the cost and the same pose bounds.
GRAPH_COST_RTOL = 1e-5
# the window solver "lm" and the edge-sharded full BA: graphed
# against eager within 1e-6 of the cost
GRAPH_LM_COST_RTOL = GRAPH_SHARD_COST_RTOL = 1e-6
GRAPH_HOST_CALLS_MAX = 50      # host launch calls per steady tracked frame
GRAPH_DISPATCH_CHUNKS = 6      # chunks of 4 frames timed each way
GRAPH_SOLVE_REPS = 3
# CUDA runtime and driver calls that queue device work: what the host
# issues per frame
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync", "cuMemcpyAsync",
                "cuMemsetD8Async", "cuMemsetD32Async")


def _host_launches(fn) -> tuple[int, int, int]:
    """fn() once under torch.profiler (CPU and CUDA activity): (host calls
    that queue device work (LAUNCH_CALLS), kernels the device ran, FAST
    kernels among them).  A session that recorded no kernel is retried,
    twice at most, and then raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        calls = sum(1 for e in events if e.name in LAUNCH_CALLS)
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
        if dev:
            return calls, len(dev), sum(1 for e in dev
                                        if KERNEL_NAME in e.name)
    raise RuntimeError("the profiler recorded no kernel in 3 sessions")


def _eager_fused_drive(cfg, ds, device):
    """Phase 16a's reference: the packed step called by hand, op by op
    (make_frame_step, no graph), on `ds` with each frame's draws, archived
    by a FusedTracker's host half.  Returns (map, reports)."""
    from vdo_slam_tpu_torch.parallel.multistream import (make_frame_step,
                                                         make_stream_state)
    from vdo_slam_tpu_torch.pipeline.draws import UniformDraws
    from vdo_slam_tpu_torch.pipeline.fused import FusedTracker, pack_outputs

    host = FusedTracker(cfg, device=device, build_step=False)
    step = make_frame_step(cfg, device, packed=True)
    st = make_stream_state(cfg, device)
    reps = []
    for f in range(len(ds)):
        fd = ds[f]
        inputs = host.device_inputs(fd)
        T_cw_gt = inputs.pop("_T_cw_gt_host")
        st, m = step(st, inputs, UniformDraws(host.frame_draws(f)), f > 0)
        vec = pack_outputs(st, m).cpu().numpy()
        reps.append(host._finish_frame(fd, T_cw_gt, f, vec,
                                       time.perf_counter()))
    return host.map, reps


def _eager_stream_drive(cfg, views, device):
    """Phase 16b's reference: the S-stream batched step called by hand
    (`_Group.step`, no graph) on `views`, archived by a MultiStreamSystem's
    host half.  Returns (system, reports per stream)."""
    from vdo_slam_tpu_torch.parallel import MultiStreamSystem

    hand = MultiStreamSystem(cfg, n_streams=len(views), enable_local_ba=False,
                             device=device)
    g = hand.groups[0]
    states = g.states
    reps = [[] for _ in views]
    for f in range(len(views[0])):
        fds = [v[f] for v in views]
        staged = hand._stage(fds)[0]
        gts = staged.pop("_gts_host")
        states, vecs = g.step(states, staged, hand._frame_draws(f)[0], f > 0)
        for s, r in enumerate(hand._archive_frame(
                fds, gts, f, vecs.cpu().numpy(), time.perf_counter())):
            reps[s].append(r)
    return hand, reps


def _held_per_frame(graphed: list, eager: list, what: str) -> tuple:
    """Each frame's T_cw and object count of the graphed reports against
    the eager ones: raise beyond the stream bounds; (dt, dr) largest."""
    if len(graphed) != len(eager):
        raise RuntimeError(f"{what}: {len(graphed)} graphed frames, "
                           f"{len(eager)} eager")
    dt = dr = 0.0
    for a, b in zip(graphed, eager):
        t, r = _pose_gap(_np_inv(a["T_cw"]), _np_inv(b["T_cw"]))
        dt, dr = max(dt, t), max(dr, r)
        if a["n_objects"] != b["n_objects"]:
            raise RuntimeError(f"{what}, frame {a['frame_id']}: "
                               f"{a['n_objects']} objects graphed, "
                               f"{b['n_objects']} eager")
    if not (dt < STREAM_T_TOL_M and dr < STREAM_R_TOL_DEG):
        raise RuntimeError(f"{what}: graphed against eager {dt} m, {dr} deg")
    return dt, dr


def _np_inv(T):
    return np.linalg.inv(np.asarray(T, np.float64))


def graphs_dispatch(cfg, pds, device, card: str) -> dict:
    """Phase 16c: the fused tracker's chunk steps (bench config, chunks of
    4, tpu_fast's wire) on the same staged frames, graphed (step_chunk's
    replays) and eager (the same frames through make_frame_step op by op,
    as step_chunk ran before the graphs), in one process: dispatch ms per
    frame (host time to queue, no sync) and device ms per frame (every
    device activity under torch.profiler), host launch calls and kernels
    per frame, the FAST kernel's profiler count against KERNEL.launches,
    and peak memory each way."""
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL
    from vdo_slam_tpu_torch.pipeline.draws import UniformDraws
    from vdo_slam_tpu_torch.pipeline.fused import FusedTracker, pack_outputs

    tr = FusedTracker(cfg, device=device)
    C = tr.chunk
    chunks = [[pds[i * C + c] for c in range(C)] for i in range(3)]
    for ch in chunks[:2]:                    # init, warm-up, capture
        tr.grab_chunk(ch)
    tr.flush()
    staged = [tr.device_inputs_chunk(chunks[i]) for i in (1, 2)]
    for st in staged:
        st.pop("_T_cw_gt_host")
    fid = tr.frame_id
    state0 = tr.state

    def graphed(n):
        for i in range(n):
            tr._step_chunk(staged[i % 2], fid + i * C)

    def eager(n):
        st = state0
        for i in range(n):
            vecs = []
            for c in range(C):
                st, m = tr.step(st, {k: v[c] for k, v in
                                     staged[i % 2].items()},
                                UniformDraws(tr.frame_draws(fid + i * C
                                                            + c)), True)
                vecs.append(pack_outputs(st, m))
            torch.stack(vecs)

    out = {}
    for name, run in (("graphed", graphed), ("eager", eager)):
        run(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run(GRAPH_DISPATCH_CHUNKS)
        disp = (time.perf_counter() - t0) / (GRAPH_DISPATCH_CHUNKS * C) * 1e3
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        _, kernels, dev_ms, _ = _profiled(lambda: run(2), f"16c {name}",
                                          host_ops=False)
        before = KERNEL.launches
        calls, prof_kernels, fast = _host_launches(lambda: run(1))
        counted = KERNEL.launches - before
        out[name] = {"dispatch_ms_frame": disp,
                     "device_ms_frame": dev_ms / (2 * C),
                     "kernels_per_frame": kernels / (2 * C),
                     "host_calls_per_frame": calls / C,
                     "fast_profiled": fast, "fast_counted": counted,
                     "peak_bytes": peak}
        print(f"16c, {name} chunk steps (S = 1, chunks of {C}): dispatch "
              f"{disp:.3f} ms/frame, device {dev_ms / (2 * C):.3f} "
              f"ms/frame, {kernels / (2 * C):.1f} kernels and "
              f"{calls / C:.1f} host launch calls per frame, FAST "
              f"{fast} in the profile / {counted} counted over {C} frames, "
              f"peak memory {peak} bytes ({peak / 2**20:.1f} MiB) [{card}]")
        if fast != counted or counted != C:
            raise RuntimeError(f"16c {name}: the profiler saw {fast} FAST "
                               f"kernels, KERNEL.launches counted {counted} "
                               f"over {C} frames")
    g, e = out["graphed"], out["eager"]
    print(f"16c, dispatch ms/frame graphed {g['dispatch_ms_frame']:.3f} "
          f"against eager {e['dispatch_ms_frame']:.3f} "
          f"({e['dispatch_ms_frame'] / g['dispatch_ms_frame']:.1f}x); "
          f"host launch calls per frame {g['host_calls_per_frame']:.1f} "
          f"against {e['host_calls_per_frame']:.1f}; the graph's capture "
          f"{json.dumps(tr._graph.track.record)} [{card}]")
    if g["host_calls_per_frame"] > GRAPH_HOST_CALLS_MAX:
        raise RuntimeError(f"16c: {g['host_calls_per_frame']} host launch "
                           f"calls per graphed frame, want at most "
                           f"{GRAPH_HOST_CALLS_MAX}")
    return out


def graphs_solves(m, cfg, device, card: str) -> dict:
    """Phase 16d: each window-solve tier, graphed against eager, with
    each window solver (window_ba.SOLVERS: "schur" and "lm"),
    on window graphs of phase 5's map before its full BA (the first window
    end that falls in each builders.WINDOW_TIERS entry): the cost within
    GRAPH_COST_RTOL ("schur") or GRAPH_LM_COST_RTOL ("lm"), every pose
    within the stream bounds, and each way's wall ms per solve (upload,
    solve, wait, fetch; graphed the median of GRAPH_SOLVE_REPS, eager one
    solve after an untimed one)."""
    from vdo_slam_tpu_torch.backend import builders
    from vdo_slam_tpu_torch.backend.factor_graph import fetch, upload
    from vdo_slam_tpu_torch.backend.window_ba import (SOLVERS, WindowGraphs,
                                                      _lm_params)

    p = _lm_params(cfg)
    tiers = {}
    for end in BA_WINDOW_ENDS:
        g, v, meta = builders.build_window_graph(m, cfg, n_frames=end)
        tier = [pc for pc, _ in builders.WINDOW_TIERS].index(
            v.points.shape[0])
        tiers.setdefault(tier, (end, g, v, meta))
    if len(tiers) != len(builders.WINDOW_TIERS):
        raise RuntimeError(f"16d: the window ends {BA_WINDOW_ENDS} fill "
                           f"tiers {sorted(tiers)} only")
    graphs = WindowGraphs(device)
    solver = "schur"

    def eager(g, v):
        vv, info = SOLVERS[solver](*upload(g, v, device), p)
        return fetch((vv.poses, info["cost0"], info["cost"]))

    def graphed(g, v):
        with graphs.solve(g, v, p, solver) as (vv, info):
            return fetch((vv.poses, info["cost0"], info["cost"]))

    def wall(fn, g, v, reps=GRAPH_SOLVE_REPS):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = fn(g, v)
            ts.append((time.perf_counter() - t0) * 1e3)
        return res, float(np.median(ts))

    out = {}
    for solver, tier in ((sv, t) for sv in SOLVERS for t in sorted(tiers)):
        end, g, v, meta = tiers[tier]
        rtol = GRAPH_COST_RTOL if solver == "schur" else GRAPH_LM_COST_RTOL
        eager(g, v)
        graphed(g, v)                        # the warm-up
        (pe, c0e, ce), ms_e = wall(eager, g, v, reps=1)
        (pg, c0g, cg), ms_g = wall(graphed, g, v)   # capture, replays
        (pg, c0g, cg), ms_g = wall(graphed, g, v)   # replays
        calls, kernels, _ = _host_launches(lambda: graphed(g, v))
        gaps = [_pose_gap(a, b) for a, b in zip(pg, pe)]
        dt, dr = max(x[0] for x in gaps), max(x[1] for x in gaps)
        rel = abs(float(cg) - float(ce)) / float(ce)
        rec = graphs.records()[-1] if graphs.records() else None
        out[solver, tier] = {"end": end, "points": meta.n_static_points,
                     "eager_ms": ms_e, "graphed_ms": ms_g,
                     "cost_eager": float(ce), "cost_graphed": float(cg),
                     "cost_rel": rel, "pose_gap": (dt, dr),
                     "host_calls": calls, "kernels": kernels,
                     "capture": rec}
        print(f"16d, solver {solver}, window tier {tier} "
              f"{builders.WINDOW_TIERS[tier]} (end {end}, "
              f"{meta.n_static_points} points): wall {ms_g:.3f} ms "
              f"graphed against {ms_e:.3f} ms eager per solve; cost "
              f"{float(c0g):.9g} -> {float(cg):.9g} graphed, "
              f"{float(c0e):.9g} -> {float(ce):.9g} eager (relative gap "
              f"{rel:.3e}); largest pose gap {dt:.3e} m, {dr:.3e} deg; "
              f"{calls} host launch calls and {kernels} kernels per graphed "
              f"solve; capture {json.dumps(rec)} [{card}]")
        if not rel <= rtol:
            raise RuntimeError(f"16d {solver} tier {tier}: cost {cg} "
                               f"graphed, {ce} eager")
        if not (dt < STREAM_T_TOL_M and dr < STREAM_R_TOL_DEG):
            raise RuntimeError(f"16d {solver} tier {tier}: poses {dt} m, "
                               f"{dr} deg apart")
    return out


def graphs_phase(path: dict, streams: dict, ba: dict, pds, device,
                 card: str) -> dict:
    """Phase 16: the compiled programs (utils/cuda_graph.py), graphed
    against eager in this process.  (a) phase 4's 25 frames, tracked
    through the fused tracker's graph there, against the same frames
    through make_frame_step op by op; (b) phase 7's S = 4 windows against
    the batched step op by op; each per frame within the stream bounds with
    equal object counts, and equal object estimates over the run; (c) the
    chunk steps' dispatch, device time, host launch calls and FAST counts
    each way; (d) each window-solve tier each way.  Prints each graph's
    capture (warm-up and capture seconds, pool bytes)."""
    from vdo_slam_tpu_torch import bench as port_bench
    from vdo_slam_tpu_torch.eval.results import metric_report

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    emap, ereps = _eager_fused_drive(bench_config(), path["ds"], device)
    peak1 = torch.cuda.max_memory_allocated()
    dt, dr = _held_per_frame(path["reports"], ereps, "16a S = 1")
    est_g, est_e = (path["metrics"]["n_obj_estimates"],
                    metric_report(emap)["n_obj_estimates"])
    print(f"16a, S = 1, {len(ereps)} frames graphed (phase 4) against "
          f"eager: largest pose gap {dt:.3e} m, {dr:.3e} deg; object "
          f"estimates {est_g} / {est_e}; eager drive's peak memory {peak1} "
          f"bytes ({peak1 / 2**20:.1f} MiB), graphed {path['peak_bytes']} "
          f"({path['peak_bytes'] / 2**20:.1f} MiB); capture "
          f"{json.dumps(path['graph'])} [{card}]")
    if est_g != est_e:
        raise RuntimeError(f"16a: {est_g} object estimates graphed, {est_e} "
                           f"eager")

    torch.cuda.reset_peak_memory_stats()
    hand, sreps = _eager_stream_drive(port_bench.multistream_config(),
                                      streams["views"], device)
    peak4 = torch.cuda.max_memory_allocated()
    worst = (0.0, 0.0)
    for s in range(N_STREAMS):
        t, r = _held_per_frame(streams["reports"][s], sreps[s],
                               f"16b stream {s}")
        worst = (max(worst[0], t), max(worst[1], r))
        est_g = streams["metrics"][s]["n_obj_estimates"]
        est_e = metric_report(hand.maps[s])["n_obj_estimates"]
        if est_g != est_e:
            raise RuntimeError(f"16b stream {s}: {est_g} object estimates "
                               f"graphed, {est_e} eager")
    print(f"16b, S = {N_STREAMS}, {N_STREAM_FRAMES} frames graphed (phase 7) "
          f"against eager: largest pose gap {worst[0]:.3e} m, "
          f"{worst[1]:.3e} deg, equal object counts; eager drive's peak "
          f"memory {peak4} bytes ({peak4 / 2**20:.1f} MiB), graphed (window "
          f"BA on) {streams['peak_bytes']} "
          f"({streams['peak_bytes'] / 2**20:.1f} MiB); captures "
          f"{json.dumps(streams['graphs'])} [{card}]")
    # one more frame each way, the batched step alone: the group's graph
    # (phase 7's system, its state where phase 7 left it) against the
    # eager batched step from the eager drive's state
    from vdo_slam_tpu_torch.pipeline.draws import frame_uniforms

    fid = N_STREAM_FRAMES + 1
    nxt = [pds[v.start + fid] for v in streams["views"]]
    g, gg = hand.groups[0], streams["system"].groups[0]
    states = g.states
    staged = hand._stage(nxt)[0]
    staged.pop("_gts_host")
    u = hand._frame_draws(fid)[0]
    u_host = frame_uniforms(hand.cfg, fid, torch.Generator())
    calls_e, kern_e, _ = _host_launches(
        lambda: g.step(states, staged, u, True))
    calls_g, kern_g, fast_g = _host_launches(
        lambda: gg.graph(staged, u_host, True))
    print(f"16b, one S = {N_STREAMS} frame's batched step: graphed "
          f"{calls_g} host launch calls, {kern_g} kernels ({fast_g} FAST); "
          f"eager {calls_e} host launch calls, {kern_e} kernels [{card}]")
    if calls_g > GRAPH_HOST_CALLS_MAX or fast_g != 1:
        raise RuntimeError(f"16b: {calls_g} host launch calls and {fast_g} "
                           f"FAST kernels in one graphed S = {N_STREAMS} "
                           f"frame")
    disp = graphs_dispatch(port_bench.bench_config(), pds, device, card)
    solves = graphs_solves(ba["pre_full_map"], bench_ba_config(), device,
                           card)
    return {"dispatch": disp, "solves": solves, "s1_gap": (dt, dr),
            "s4_gap": worst}


# phase 17: the full BA's graphs and the host Tracker's stage graphs,
# graphed against eager.  The full BA is phase 5's map from before its full
# BA at bench.py's caps, held within GRAPH_COST_RTOL of the eager cost and
# the stream bounds per pose; the host Tracker is phase 8's 100 frames,
# held per frame to the stream bounds with equal objects, and to equal
# object estimates over the run.
N_FULL_BA_REPS = 3


def full_ba_graphs(ba: dict, device, card: str) -> dict:
    """Phase 17a: warmup_full_ba for phase 5's map at bench.py's caps
    (bench_ba_config), then full_ba_inplace from the graphs against the
    eager full_ba_inplace on copies of the map from before phase 5's full
    BA: each capture's record, wall ms per solve (the median of
    N_FULL_BA_REPS), the report's solve seconds and host launch calls per
    solve each way, the costs and their relative gap, the largest refined
    pose gap, and each capture's edge Hessian and vertex-pass launches a
    replay against their counts."""
    import copy

    from vdo_slam_tpu_torch.backend.full_ba import (FullBAGraphs,
                                                    full_ba_inplace,
                                                    warmup_full_ba)

    cfg = bench_ba_config()
    pre = ba["pre_full_map"]
    graphs = FullBAGraphs(device)
    t0 = time.perf_counter()
    warmup_full_ba(cfg, pre.num_frames, graphs)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    recs = graphs.records()
    print(f"17a, warmup_full_ba over {pre.num_frames} frames at bench.py's "
          f"caps: {warm:.3f} s; captures {json.dumps(recs)} [{card}]")
    out = {"warm_s": warm, "records": recs}
    for name, g in (("eager", None), ("graphed", graphs)):
        maps = [copy.deepcopy(pre) for _ in range(N_FULL_BA_REPS + 1)]
        walls, reps = [], []
        for m in maps[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reps.append(full_ba_inplace(m, cfg, device=device, graphs=g))
            walls.append((time.perf_counter() - t0) * 1e3)
        calls, kernels, _ = _host_launches(
            lambda: full_ba_inplace(maps[0], cfg, device=device, graphs=g))
        rep = reps[-1]
        n_types = sum(1 for x in rep["edges"].values() if x)
        cg = rep["cg_iters"]
        out[name] = {"wall_ms": float(np.median(walls)),
                     "solve_s": float(np.median([r["t_solve_s"]
                                                 for r in reps])),
                     "host_calls": calls, "kernels": kernels,
                     "cost0": rep["cost0"], "cost": rep["cost"],
                     "iters": rep["iters_run"], "map": maps[-1]}
        print(f"17a, {name} full BA: wall {out[name]['wall_ms']:.3f} ms per "
              f"solve (median of {N_FULL_BA_REPS}: {json.dumps(walls)}), "
              f"solve {out[name]['solve_s']:.4f} s (build "
              f"{rep['t_build_s']:.4f} s, write-back "
              f"{rep['t_writeback_s']:.4f} s); {calls} host launch calls and "
              f"{kernels} kernels per solve; {rep['iters_run']} LM "
              f"iterations, cost {rep['cost0']:.9g} -> {rep['cost']:.9g} "
              f"[{card}]")
    e, g = out["eager"], out["graphed"]
    rel = abs(g["cost"] - e["cost"]) / e["cost"]
    gaps = [_pose_gap(a, b) for a, b in zip(g["map"].cam_pose_rf,
                                           e["map"].cam_pose_rf)]
    dt, dr = max(x[0] for x in gaps), max(x[1] for x in gaps)
    out.update(cost_rel=rel, pose_gap=(dt, dr))
    for k in ("eager", "graphed"):
        del out[k]["map"]
    print(f"17a, full BA graphed against eager: cost {g['cost']:.9g} / "
          f"{e['cost']:.9g} (relative gap {rel:.3e}); largest refined pose "
          f"gap {dt:.3e} m, {dr:.3e} deg; wall {g['wall_ms']:.3f} / "
          f"{e['wall_ms']:.3f} ms per solve "
          f"({e['wall_ms'] / g['wall_ms']:.2f}x), host launch calls "
          f"{g['host_calls']} / {e['host_calls']} [{card}]")
    if not rel <= GRAPH_COST_RTOL:
        raise RuntimeError(f"17a: cost {g['cost']} graphed, {e['cost']} "
                           f"eager")
    if not (dt < STREAM_T_TOL_M and dr < STREAM_R_TOL_DEG):
        raise RuntimeError(f"17a: refined poses {dt} m, {dr} deg apart")
    if g["iters"] != e["iters"] or len(recs) != len(graphs._calls):
        raise RuntimeError(f"17a: {g['iters']} / {e['iters']} LM "
                           f"iterations, {len(recs)} captures of "
                           f"{len(graphs._calls)} graphs")
    # each captured LM chunk records an edge launch per edge type with
    # edges per CG step and a vertex pass per product and per
    # preconditioner apply, for each of its iterations
    per_replay = []
    for r in recs:
        iters = int(r["name"].split("iters=")[1].split()[0])
        got = r["kernel_launches_per_replay"]
        want = {"EdgeHessianKernel": n_types * cg * iters,
                "VertexPassKernel": (2 * cg + 1) * iters}
        per_replay.append(got)
        if {k: got.get(k, 0) for k in want} != want:
            raise RuntimeError(f"17a: {r['name']} records {got} launches a "
                               f"replay, want {want}")
    print(f"17a, launches a replay of each capture: {per_replay} [{card}]")
    out["launches_per_replay"] = per_replay
    return out


def _eager_reference_drive(ds, device):
    """Phase 17b's reference: phase 8's run (System(bench_ba_config()),
    mode "reference", both BA passes) with the host Tracker's stage
    functions called directly, op by op (the System's one full BA runs
    eagerly, as its graphs' warm-up, in both runs).  Returns (system,
    reports, seconds of tracking alone, peak bytes)."""
    from vdo_slam_tpu_torch.pipeline import System

    sysm = System(bench_ba_config(), device=device)
    plain_stages(sysm.tracker)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reports = sysm.run_sequence(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    full = sysm.full_ba_report
    tracking_s = (wall - full["t_build_s"] - full["t_solve_s"]
                  - full["t_writeback_s"] - sum(sysm.map.lba_times) / 1e3)
    return sysm, reports, tracking_s, torch.cuda.max_memory_allocated()


def tracker_graphs(ref: dict, device, card: str) -> dict:
    """Phase 17b: phase 8's 100 frames through the host Tracker's stage
    graphs (phase 8's run) against the stage functions called directly:
    each frame's pose within the stream bounds and the same objects, the
    same object estimates; fps over tracking each way, host launch calls,
    host waits and FAST kernels per steady frame each way (phase 8b's
    profile for the graphs), peak memory each way, and each stage graph's
    record."""
    from vdo_slam_tpu_torch.eval.results import metric_report

    ds = ref["ds"]
    esys, ereps, tracking_s, peak = _eager_reference_drive(ds, device)
    n = len(ds)
    fps_e = n / tracking_s
    dt = dr = 0.0
    for a, b in zip(ref["reports"], ereps, strict=True):
        t, r = _pose_gap(_np_inv(a["T_cw"]), _np_inv(b["T_cw"]))
        dt, dr = max(dt, t), max(dr, r)
        ids = [[(o["model_label"], o["sem_label"], o["status"])
                for o in rep["objects"]] for rep in (a, b)]
        if ids[0] != ids[1]:
            raise RuntimeError(f"17b, frame {a['frame_id']}: objects "
                               f"{ids[0]} graphed, {ids[1]} eager")
    est_g = ref["metrics"]["initial"]["n_obj_estimates"]
    est_e = metric_report(esys.map)["n_obj_estimates"]
    steady = steady_frames(bench_config(), ds, device, card, plain=True)
    g, e = ref["steady"], steady
    recs = ref["system"].tracker.graph_records()
    print(f"17b, host Tracker, {n} frames graphed (phase 8) against eager "
          f"stage calls: largest pose gap {dt:.3e} m, {dr:.3e} deg, equal "
          f"objects every frame; object estimates {est_g} / {est_e}; "
          f"{ref['fps']:.3f} / {fps_e:.3f} fps over tracking; per steady "
          f"frame {g['host_calls_per_frame']:.1f} / "
          f"{e['host_calls_per_frame']:.1f} host launch calls, "
          f"{g['syncs_per_frame']:.1f} / {e['syncs_per_frame']:.1f} host "
          f"waits, {g['launches_per_frame']:.1f} / "
          f"{e['launches_per_frame']:.1f} kernels, "
          f"{g['wall_ms_per_frame']:.3f} / {e['wall_ms_per_frame']:.3f} ms "
          f"wall; peak memory {ref['peak_bytes']} / {peak} bytes "
          f"({ref['peak_bytes'] / 2**20:.1f} / {peak / 2**20:.1f} MiB) "
          f"[{card}]")
    for rec in recs:
        print(f"17b, stage graph {json.dumps(rec)} [{card}]")
    if not (dt < STREAM_T_TOL_M and dr < STREAM_R_TOL_DEG):
        raise RuntimeError(f"17b: graphed against eager {dt} m, {dr} deg")
    if est_g != est_e:
        raise RuntimeError(f"17b: {est_g} object estimates graphed, "
                           f"{est_e} eager")
    if len(recs) != len(HOST_STAGES):
        raise RuntimeError(f"17b: {len(recs)} stage graphs captured, want "
                           f"{len(HOST_STAGES)}")
    return {"pose_gap": (dt, dr), "fps": (ref["fps"], fps_e),
            "steady": (g, e), "peak_bytes": (ref["peak_bytes"], peak),
            "records": recs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on a GPU only", file=sys.stderr)
        return 1
    try:
        import vdo_slam_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from the "
              f"repository root", file=sys.stderr)
        return 1
    from vdo_slam_tpu_torch.ops.fast_cuda import KERNEL

    card = card_line()
    print(f"card: {card}")
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    device = torch.device("cuda", 0)
    t_phase = [time.perf_counter(), time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name}: {now - t_phase[0]:.1f} s (script "
              f"{now - t_phase[1]:.1f} s)")
        t_phase[0] = now

    if "--edge-hessian" in sys.argv[1:]:
        hv = edge_hessian_phase(device, card)
        phase_done("3b (edge Hessian kernels against their plain version, "
                   "timing)")
        print(json.dumps({"edge_hessian": hv}))
        return 0
    KERNEL.build()
    print(f"FAST kernel built and loaded in {KERNEL.build_seconds:.2f} s")
    time_joins()
    for line in KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    import tempfile

    from vdo_slam_tpu_torch import bench as port_bench

    libs = host_libraries()
    t0 = time.perf_counter()
    scene = port_bench.bench_scene()
    print(f"scene: {scene.rgb.shape} made in {time.perf_counter() - t0:.1f} s")
    from vdo_slam_tpu_torch.io.dataset import SyntheticDataset

    cfg_wire = port_bench.bench_config()
    t0 = time.perf_counter()
    pds = port_bench.packed_dataset(scene, cfg_wire)
    print(f"{len(pds)} frames packed under tpu_fast's wire in "
          f"{time.perf_counter() - t0:.1f} s, {pds[0].packed.nbytes} bytes "
          f"per frame (JAX package: "
          f"{JAX_REF_WIRE['wire_bytes_per_frame']})")
    if pds[0].packed.nbytes != JAX_REF_WIRE["wire_bytes_per_frame"]:
        raise RuntimeError("the wire's length differs from the JAX package's")
    grays = {S: stream_first_grays(pds, cfg_wire, device, S)
             for S in (N_STREAMS, N_THROUGHPUT)}
    phase_done("1-2 (card, build, scene, packing)")
    max_err, err_batched = check_kernel(scene, device, grays)
    kern = time_pyramid(scene, device, card)
    kern_s = time_batched(scene, device, card, grays)
    phase_done("3 (kernel against its plain version, timing)")
    hv = edge_hessian_phase(device, card)
    phase_done("3b (edge Hessian kernels against their plain version, "
               "timing)")
    path = main_path(scene, bench_config(), device, card)
    phase_done("4 (fused tracking path)")
    dense_ds = SyntheticDataset(scene, depth_map_factor=256.0, bf=387.5744)
    ba = ba_path(dense_ds, bench_ba_config(), device, card, JAX_REF_BA,
                 "BA path (dense wire)", keep_map=True)
    phase_done("5 (BA path)")
    wire = ba_path(pds, cfg_wire, device, card, JAX_REF_WIRE,
                   "wire path (tpu_fast wire)", solvers=False)
    for key in ("initial", "refined"):
        print(f"{key}: dense wire {json.dumps(ba['metrics'][key])}; "
              f"tpu_fast wire {json.dumps(wire['metrics'][key])}")
    wire_costs(pds, dense_ds, {"wire": cfg_wire, "dense": bench_ba_config()},
               device, card)
    probe = stage_probe(wire["system"], pds, device, card)
    phase_done("6 (wire path, stage probe)")
    streams = stream_path(pds, port_bench.multistream_config(), device,
                          card)
    phase_done("7 (S-stream path)")
    ref = reference_path(scene, device, card)
    phase_done("8 (default path, mode reference)")
    opts = option_paths(scene, device, card)
    phase_done("9 (options)")
    cli_and_resume(device, card)
    phase_done("10 (CLI and resume)")
    work = tempfile.TemporaryDirectory()
    disk = disk_path(scene, device, card, libs, work.name)
    phase_done("11 (on-disk input path)")
    sharded_ba(ba, bench_ba_config(), device, card)
    phase_done("12a (the full BA over 1, 2 and 4 edge shards)")
    grouped = grouped_streams(pds, port_bench.multistream_config(), device,
                              card)
    phase_done("12b (four streams in two groups)")
    orb_grid(scene, device, card)
    phase_done("12c (ORB and the grid)")
    t13 = time.perf_counter()
    hard = bench_hard(device, card)
    phase_done("13a (the port's bench, --hard)")
    thr = bench_throughput(device, card, streams["peak_bytes"])
    phase_done("13b (the port's bench, --throughput: S = 6)")
    pdir = packed_dir(disk.get("seq"), device, card)
    work.cleanup()
    if pdir["launches"] is None:
        disk["not_run"].append("the packed directory (13c)")
    phase_done("13c (pack_sequence and PackedDataset)")
    print(f"phase 13: {time.perf_counter() - t13:.1f} s (budget "
          f"{PHASE13_BUDGET_S} s)")
    t15 = time.perf_counter()
    graft = graft_entry_phase(device, card)
    print(f"phase 15: {time.perf_counter() - t15:.1f} s (budget "
          f"{PHASE15_BUDGET_S} s) [{card}]")
    phase_done("15 (graft_entry: entry() and dryrun_multichip(8))")
    t16 = time.perf_counter()
    graphs = graphs_phase(path, streams, ba, pds, device, card)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s [{card}]")
    phase_done("16 (graphs: graphed against eager)")
    full_graphs = full_ba_graphs(ba, device, card)
    phase_done("17a (the full BA's graphs against eager)")
    host_graphs = tracker_graphs(ref, device, card)
    phase_done("17b (the host Tracker's stage graphs against eager)")
    if disk["not_run"]:
        print(f"NOT RUN (a host library is missing; not passed): "
              f"{', '.join(disk['not_run'])}")

    print(json.dumps({"kernels": [{
        "name": "fast_score_pyramid",
        "route": "cuda",
        "source": "vdo_slam_tpu_torch/csrc/fast_score.cu",
        "replaces": "vdo_slam_tpu/ops/fast_pallas.py:37",
        "launches": path["launches"],
        "launches_per_frame": path["launches"] / N_FRAMES,
        "launches_ba_path": ba["fast_launches"],
        "launches_wire_path": wire["fast_launches"],
        "launches_multistream_path": streams["launches"],
        "launches_reference_path": ref["launches"],
        "launches_omd_path": opts["omd"][1],
        "launches_disk_path": disk["cli_launches"],
        "launches_disk_fused_path": disk["fused_launches"],
        "launches_probe": probe["launches"],
        "launches_grouped_streams_path": grouped["launches"],
        "launches_hard_path": hard["launches"],
        "launches_throughput_path": thr["launches"],
        "launches_packed_dir_path": pdir["launches"],
        "launches_graft_entry": graft["entry_launches"],
        "launches_dryrun": graft["launches"],
        "launches_graphs_dispatch": graphs["dispatch"]["graphed"][
            "fast_counted"],
        "launches_host_tracker_graphs": host_graphs["steady"][0][
            "fast_counted"],
        "launches_host_tracker_eager": host_graphs["steady"][1][
            "fast_counted"],
        "streams": N_STREAMS,
        "streams_throughput": N_THROUGHPUT,
        "max_abs_err": max_err,
        "max_abs_err_batched": err_batched[N_STREAMS],
        "max_abs_err_batched_s6": err_batched[N_THROUGHPUT],
        "max_abs_err_graft": graft["max_abs_err"],
        "ms": kern["ms"],
        "ms_s4": kern_s[N_STREAMS]["ms"],
        "ms_s6": kern_s[N_THROUGHPUT]["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_ms_s4": kern_s[N_STREAMS]["bound_ms"],
        "bound_ms_s6": kern_s[N_THROUGHPUT]["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": None,
    }, {
        "name": "hessian_vector",
        "route": "cuda",
        "source": "vdo_slam_tpu_torch/csrc/edge_hessian.cu",
        "replaces": None,
        "launches_ba_path": ba["hv_launches"],
        "vertex_launches_ba_path": ba["vertex_launches"],
        "launches_wire_path": wire["hv_launches"],
        "vertex_launches_wire_path": wire["vertex_launches"],
        "launches_per_replay_full_graphs": full_graphs["launches_per_replay"],
        "max_rel_err": hv["gap"],
        "max_rel_err_precond": hv["gap_pre"],
        "ms": hv["device_ms"],
        "plain_ms": hv["plain_device_ms"],
        "bound_ms": hv["bound_ms"],
        "precond_ms": hv["pre_device_ms"],
        "precond_plain_ms": hv["pre_plain_device_ms"],
        "precond_bound_ms": hv["pre_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(f"chip_smoke: {time.perf_counter() - t_phase[1]:.1f} s in all "
          f"(full BA graphed {full_graphs['graphed']['wall_ms']:.3f} ms per "
          f"solve against {full_graphs['eager']['wall_ms']:.3f} eager)")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
