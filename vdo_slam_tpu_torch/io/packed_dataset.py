"""Pre-packed sequence ingest: the wire format as a dataset — a jax-free
copy of vdo_slam_tpu/io/packed_dataset.py (the original sits behind a
package import of jax).

The frame tensors are packed into the device wire format (io/packing.py)
once, offline, and the tracking loop ingests ready-to-upload int16 buffers
through a memmap: per frame the host reads one row and uploads it.  A
directory written by either package is read by both
(tests/test_torch_packed_dataset.py).

On-disk layout (directory):
    meta.json       {"n", "H", "W", "wire_len", "depth_scale", "flow_half",
                     "flow_down", "flow_delta", "depth_down", "depth_resid",
                     "entropy", "seg_cap", "depth_exc_cap",
                     "depth_map_factor", "version"}; the version names the
                    layout, so a reader from before a layout never misparses
                    it: 1 = flow_down in {1, 2}; 2 = flow_down == 4;
                    3 = flow planes row-delta coded; 4 = depth plane
                    downsampled 2x; 5 = sparse depth residual block;
                    6 = lossless entropy wire
    frames.i16      memmap (n, wire_len) int16 — one wire buffer per frame
    poses.npy       (n, 4, 4) float32 raw GT camera poses (pose_gt.txt rows)
    obj_rows.npy    (sum_i k_i, 10) float32 concatenated object GT rows
    obj_offsets.npy (n + 1,) int64 — frame i owns rows [off[i], off[i+1])
    times.npy       (n,) float64 timestamps

pack_dataset() packs any dataset object yielding FrameData.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from .packing import depth_wire_scale, pack_frame

_VERSION = 1          # flow_down in {1, 2}
_VERSION_DOWN4 = 2    # flow_down == 4 (different wire layout)
_VERSION_DELTA = 3    # flow planes row-delta coded (packing._row_delta_u16)
_VERSION_DDOWN = 4    # depth plane downsampled 2x (packing depth_down=2)
_VERSION_RESID = 5    # sparse depth residual block appended (depth_resid>0)
_VERSION_ENTROPY = 6  # lossless entropy wire (packing entropy=True)


@dataclasses.dataclass
class PackedFrameData:
    """A frame that is already in wire format.

    Carries exactly what the fused tracking loop needs: the device buffer
    plus the host-side GT bookkeeping (pose/object rows feed the archive,
    never the device).  FusedTracker.device_inputs_chunk detects the
    `packed` attribute and skips pack_frame.
    """

    packed: np.ndarray       # (wire_len,) or (4, H, W) int16
    pose_gt_raw: np.ndarray  # (4, 4) float32
    obj_gt_rows: np.ndarray  # (k, 10) float32
    timestamp: float


def pack_dataset(dataset, out_dir: str | Path, depth_map_factor: float,
                 flow_half: bool = True, n: int | None = None,
                 flow_down: int | None = None,
                 flow_delta: bool = False,
                 depth_down: int = 1,
                 depth_resid: int = 0,
                 entropy: bool = False,
                 seg_cap: int = 8192,
                 depth_exc_cap: int = 8192) -> Path:
    """Pack any FrameData-yielding dataset into a PackedDataset directory."""
    from .packing import _norm_flow_down

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = len(dataset) if n is None else min(n, len(dataset))
    dscale = depth_wire_scale(depth_map_factor)
    down = _norm_flow_down(flow_half, flow_down)

    fd0 = dataset[0]
    H, W = fd0.rgb.shape
    w0 = pack_frame(fd0.rgb, fd0.depth_raw, fd0.flow, fd0.mask,
                    depth_scale=dscale, flow_down=down,
                    flow_delta=flow_delta, depth_down=depth_down,
                    depth_resid=depth_resid, entropy=entropy,
                    seg_cap=seg_cap, depth_exc_cap=depth_exc_cap).ravel()
    wire_len = int(w0.size)

    buf = np.memmap(out / "frames.i16", dtype=np.int16, mode="w+",
                    shape=(n, wire_len))
    poses = np.zeros((n, 4, 4), np.float32)
    times = np.zeros((n,), np.float64)
    rows_all, offs = [], [0]
    for i in range(n):
        fd = dataset[i] if i else fd0
        w = (w0 if i == 0 else pack_frame(
            fd.rgb, fd.depth_raw, fd.flow, fd.mask, depth_scale=dscale,
            flow_down=down, flow_delta=flow_delta,
            depth_down=depth_down, depth_resid=depth_resid,
            entropy=entropy, seg_cap=seg_cap,
            depth_exc_cap=depth_exc_cap).ravel())
        buf[i] = w
        poses[i] = np.asarray(fd.pose_gt_raw, np.float32)
        times[i] = float(fd.timestamp)
        r = np.asarray(fd.obj_gt_rows, np.float32).reshape(-1, 10)
        rows_all.append(r)
        offs.append(offs[-1] + r.shape[0])
    buf.flush()
    np.save(out / "poses.npy", poses)
    np.save(out / "times.npy", times)
    np.save(out / "obj_rows.npy",
            np.concatenate(rows_all) if offs[-1] else
            np.zeros((0, 10), np.float32))
    np.save(out / "obj_offsets.npy", np.asarray(offs, np.int64))
    (out / "meta.json").write_text(json.dumps({
        "version": (_VERSION_ENTROPY if entropy else
                    _VERSION_RESID if depth_resid else
                    _VERSION_DDOWN if depth_down > 1 else
                    _VERSION_DELTA if flow_delta else
                    _VERSION_DOWN4 if down == 4 else _VERSION),
        "n": n, "H": int(H), "W": int(W),
        "wire_len": wire_len, "depth_scale": float(dscale),
        "flow_half": down == 2, "flow_down": down,
        "flow_delta": bool(flow_delta),
        "depth_down": int(depth_down),
        "depth_resid": int(depth_resid),
        "entropy": bool(entropy),
        "seg_cap": int(seg_cap),
        "depth_exc_cap": int(depth_exc_cap),
        "depth_map_factor": float(depth_map_factor),
    }))
    return out


class PackedDataset:
    """Memmap-backed reader of a pack_dataset() directory.

    __getitem__ is O(1) host work (a memmap row view + tiny GT slices);
    suitable only for the fused tracking path (the raw image tensors are
    not recoverable losslessly — by design, the wire IS the dataset).
    """

    def __init__(self, path: str | Path):
        self.dir = Path(path)
        self.meta = json.loads((self.dir / "meta.json").read_text())
        if self.meta.get("version") not in (_VERSION, _VERSION_DOWN4,
                                            _VERSION_DELTA, _VERSION_DDOWN,
                                            _VERSION_RESID,
                                            _VERSION_ENTROPY):
            raise ValueError(f"packed dataset version mismatch: {self.meta}")
        n, L = self.meta["n"], self.meta["wire_len"]
        self.frames = np.memmap(self.dir / "frames.i16", dtype=np.int16,
                                mode="r", shape=(n, L))
        self.poses = np.load(self.dir / "poses.npy")
        self.times = np.load(self.dir / "times.npy")
        self.obj_rows = np.load(self.dir / "obj_rows.npy")
        self.obj_offsets = np.load(self.dir / "obj_offsets.npy")

    def __len__(self) -> int:
        return int(self.meta["n"])

    def check_config(self, cfg) -> None:
        """Assert the pack-time wire parameters match the run config."""
        tr = cfg.tracking
        want_scale = depth_wire_scale(tr.depth_map_factor)
        if abs(want_scale - self.meta["depth_scale"]) > 1e-9:
            raise ValueError(
                f"packed depth_scale {self.meta['depth_scale']} != config "
                f"{want_scale} (depth_map_factor {tr.depth_map_factor})")
        packed_down = int(self.meta.get(
            "flow_down", 2 if self.meta.get("flow_half") else 1))
        if tr.flow_down != packed_down:
            raise ValueError(
                f"packed flow_down={packed_down} != config "
                f"flow_down={tr.flow_down}")
        packed_delta = bool(self.meta.get("flow_delta", False))
        if tr.flow_delta != packed_delta:
            raise ValueError(
                f"packed flow_delta={packed_delta} != config "
                f"flow_delta={tr.flow_delta}")
        packed_dd = int(self.meta.get("depth_down", 1))
        if tr.depth_down != packed_dd:
            raise ValueError(
                f"packed depth_down={packed_dd} != config "
                f"depth_down={tr.depth_down}")
        packed_dr = int(self.meta.get("depth_resid", 0))
        if tr.depth_resid != packed_dr:
            raise ValueError(
                f"packed depth_resid={packed_dr} != config "
                f"depth_resid={tr.depth_resid}")
        packed_en = bool(self.meta.get("entropy", False))
        if tr.entropy != packed_en or (packed_en and (
                tr.wire_seg_cap != int(self.meta.get("seg_cap", 0)) or
                tr.wire_depth_exc_cap != int(
                    self.meta.get("depth_exc_cap", 0)))):
            raise ValueError(
                f"packed entropy wire {packed_en}/{self.meta.get('seg_cap')}"
                f"/{self.meta.get('depth_exc_cap')} != config "
                f"{tr.entropy}/{tr.wire_seg_cap}/{tr.wire_depth_exc_cap}")
        if (cfg.camera.height, cfg.camera.width) != (self.meta["H"],
                                                     self.meta["W"]):
            raise ValueError("packed H/W mismatch with config camera")

    def __getitem__(self, i: int) -> PackedFrameData:
        o0, o1 = int(self.obj_offsets[i]), int(self.obj_offsets[i + 1])
        return PackedFrameData(
            packed=self.frames[i],
            pose_gt_raw=self.poses[i],
            obj_gt_rows=self.obj_rows[o0:o1],
            timestamp=float(self.times[i]),
        )


class InMemoryPackedDataset:
    """pack_dataset semantics without touching disk: every frame is packed
    at construction, so a timed loop does no per-frame packing."""

    def __init__(self, dataset, depth_map_factor: float,
                 flow_half: bool = True, n: int | None = None,
                 flow_down: int | None = None,
                 flow_delta: bool = False,
                 depth_down: int = 1,
                 depth_resid: int = 0,
                 entropy: bool = False,
                 seg_cap: int = 8192,
                 depth_exc_cap: int = 8192):
        n = len(dataset) if n is None else min(n, len(dataset))
        dscale = depth_wire_scale(depth_map_factor)
        self._items = []
        for i in range(n):
            fd = dataset[i]
            self._items.append(PackedFrameData(
                packed=pack_frame(fd.rgb, fd.depth_raw, fd.flow, fd.mask,
                                  depth_scale=dscale, flow_half=flow_half,
                                  flow_down=flow_down,
                                  flow_delta=flow_delta,
                                  depth_down=depth_down,
                                  depth_resid=depth_resid,
                                  entropy=entropy, seg_cap=seg_cap,
                                  depth_exc_cap=depth_exc_cap),
                pose_gt_raw=np.asarray(fd.pose_gt_raw, np.float32),
                obj_gt_rows=np.asarray(fd.obj_gt_rows,
                                       np.float32).reshape(-1, 10),
                timestamp=float(fd.timestamp),
            ))

    def __len__(self):
        return len(self._items)

    def __getitem__(self, i):
        return self._items[i]
