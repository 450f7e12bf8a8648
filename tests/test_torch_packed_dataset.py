"""Pre-packed datasets: vdo_slam_tpu_torch/io/packed_dataset.py against
vdo_slam_tpu/io/packed_dataset.py.  A directory written by either package
is read by both, byte for byte; the version stamps agree; a config that
does not match the pack is rejected by both; the in-memory dataset holds
the same buffers; and the port's System runs a directory it reads.
Everything here is bytes or metadata: atol = 0.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tests.test_torch_slice import WIRE, port_config, tiny_pair
from vdo_slam_tpu.io import packed_dataset as jpd
from vdo_slam_tpu.io.dataset import SyntheticDataset as JSyntheticDataset
from vdo_slam_tpu.io.synthetic import make_scene as jmake_scene
from vdo_slam_tpu_torch.io import packed_dataset as ppd
from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
from vdo_slam_tpu_torch.io.prefetch import ThreadedPrefetcher, iterate
from vdo_slam_tpu_torch.io.synthetic import make_scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small CPU ops: the suite
    runs in several worker processes at once, and each worker's idle
    OpenMP threads spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

PACKS = {
    "half": (dict(flow_half=True), 1),
    "dense": (dict(flow_half=False), 1),
    "down4": (dict(flow_down=4), 2),
    "delta": (dict(flow_down=2, flow_delta=True), 3),
    "depth_down": (dict(flow_down=2, depth_down=2), 4),
    "resid": (dict(flow_down=2, depth_down=2, depth_resid=32), 5),
    "entropy": (dict(flow_down=2, flow_delta=True, entropy=True,
                     seg_cap=1024, depth_exc_cap=2048), 6),
}
FILES = ("frames.i16", "poses.npy", "times.npy", "obj_rows.npy",
         "obj_offsets.npy")


@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_frames=5, width=96, height=64, num_objects=1, seed=1)
    return (JSyntheticDataset(jmake_scene(**kw), depth_map_factor=1.0,
                              bf=40.0),
            SyntheticDataset(make_scene(**kw), depth_map_factor=1.0, bf=40.0))


def _same_frame(a, b):
    np.testing.assert_array_equal(np.asarray(a.packed), np.asarray(b.packed))
    np.testing.assert_array_equal(a.pose_gt_raw, b.pose_gt_raw)
    np.testing.assert_array_equal(a.obj_gt_rows, b.obj_gt_rows)
    assert a.timestamp == b.timestamp


@pytest.mark.parametrize("pack", list(PACKS))
def test_directories_are_byte_equal_and_cross_readable(datasets, tmp_path,
                                                       pack):
    jds, pds = datasets
    kw, version = PACKS[pack]
    jdir = jpd.pack_dataset(jds, tmp_path / "jax", depth_map_factor=1.0, **kw)
    pdir = ppd.pack_dataset(pds, tmp_path / "port", depth_map_factor=1.0,
                            **kw)
    for name in FILES:
        assert (jdir / name).read_bytes() == (pdir / name).read_bytes(), name
    jmeta = json.loads((jdir / "meta.json").read_text())
    pmeta = json.loads((pdir / "meta.json").read_text())
    assert jmeta == pmeta and pmeta["version"] == version
    # written by the port, read by the JAX package, and the reverse
    for reader, path in ((jpd.PackedDataset, pdir), (ppd.PackedDataset, jdir)):
        got, own = reader(path), ppd.PackedDataset(pdir)
        assert len(got) == len(own) == len(pds)
        for i in range(len(own)):
            _same_frame(got[i], own[i])


def test_in_memory_dataset_equals_jax(datasets):
    jds, pds = datasets
    kw = dict(PACKS["entropy"][0])
    a = jpd.InMemoryPackedDataset(jds, depth_map_factor=1.0, **kw)
    b = ppd.InMemoryPackedDataset(pds, depth_map_factor=1.0, **kw)
    assert len(a) == len(b) == len(pds)
    for i in range(len(b)):
        _same_frame(a[i], b[i])
    assert len(ppd.InMemoryPackedDataset(pds, 1.0, n=2)) == 2


def test_version_stamp_rejected(datasets, tmp_path):
    _, pds = datasets
    out = ppd.pack_dataset(pds, tmp_path / "p", depth_map_factor=1.0, n=2)
    meta = json.loads((out / "meta.json").read_text())
    assert meta["n"] == 2
    meta["version"] = 99
    (out / "meta.json").write_text(json.dumps(meta))
    for reader in (ppd.PackedDataset, jpd.PackedDataset):
        with pytest.raises(ValueError):
            reader(out)


@pytest.mark.parametrize("bad", [
    dict(wire_flow_down=4), dict(wire_flow_delta=False),
    dict(wire_entropy=False), dict(wire_seg_cap=512),
    dict(depth_map_factor=2.0), "camera",
], ids=["flow_down", "flow_delta", "entropy", "seg_cap", "depth_scale",
        "camera"])
def test_config_mismatch_rejected(datasets, tmp_path, bad):
    _, pds = datasets
    kw, _ = PACKS["entropy"]
    out = ppd.pack_dataset(pds, tmp_path / "p", depth_map_factor=1.0, **kw)
    jcfg, cfg = tiny_pair(**WIRE)
    ppd.PackedDataset(out).check_config(cfg)          # matches
    jpd.PackedDataset(out).check_config(jcfg)
    if bad == "camera":
        jbad = jcfg.replace(camera=dataclasses.replace(jcfg.camera, width=98))
    else:
        jbad = jcfg.replace(tracking=dataclasses.replace(jcfg.tracking,
                                                         **bad))
    with pytest.raises(ValueError) as je:
        jpd.PackedDataset(out).check_config(jbad)
    with pytest.raises(ValueError) as pe:
        ppd.PackedDataset(out).check_config(port_config(jbad))
    assert str(je.value) == str(pe.value)


def test_omd_wire_steps_round_trip_through_a_directory(tmp_path):
    """The offline packer at a configuration's wire_depth_steps (a port-
    only field; configs/omd.json's 64, for disparities over the 256 px
    that the JAX package's 1/256 px plane can hold): the directory holds
    the bytes the live wire packs for that configuration, check_config
    takes it and refuses it under the default 256 steps, and the depth
    comes back as the packed steps exactly (atol = 0)."""
    from vdo_slam_tpu_torch.io.packing import (pack_frame, unpack_frame,
                                               wire_kwargs)

    factor, steps = 1000.0, 64            # omd.yaml's DepthMapFactor
    pds = SyntheticDataset(make_scene(num_frames=3, width=96, height=64,
                                      num_objects=1, seed=1),
                           depth_map_factor=factor, bf=3000.0)
    assert max(pds[i].depth_raw.max() for i in range(3)) / factor > 256
    _, cfg = tiny_pair(**{**WIRE, "wire_depth_exc_cap": 4096})
    tr = dataclasses.replace(cfg.tracking, depth_map_factor=factor,
                             wire_depth_steps=steps)
    cfg = cfg.replace(tracking=tr)
    kw = wire_kwargs(tr)
    out = ppd.pack_dataset(pds, tmp_path / "p", depth_map_factor=factor,
                           flow_down=2, flow_delta=True, entropy=True,
                           seg_cap=tr.wire_seg_cap,
                           depth_exc_cap=tr.wire_depth_exc_cap,
                           depth_steps=steps)
    packed = ppd.PackedDataset(out)
    packed.check_config(cfg)
    with pytest.raises(ValueError, match="depth_scale"):
        packed.check_config(cfg.replace(tracking=dataclasses.replace(
            tr, wire_depth_steps=256)))
    mem = ppd.InMemoryPackedDataset(
        pds, factor, flow_down=2, flow_delta=True, entropy=True,
        seg_cap=tr.wire_seg_cap, depth_exc_cap=tr.wire_depth_exc_cap,
        depth_steps=steps)
    H, W = packed.meta["H"], packed.meta["W"]
    for i in range(len(pds)):
        fd = pds[i]
        live = pack_frame(fd.rgb, fd.depth_raw, fd.flow, fd.mask, **kw)
        np.testing.assert_array_equal(np.asarray(packed[i].packed), live)
        np.testing.assert_array_equal(mem[i].packed, live)
        _, depth, _, _ = unpack_frame(torch.from_numpy(live.copy()),
                                      hw=(H, W), **kw)
        want = np.round(fd.depth_raw.astype(np.float64) * steps / factor)
        assert want.max() < 65535            # no step saturates the u16
        np.testing.assert_array_equal(
            depth.numpy().astype(np.float64) * steps / factor, want)


def test_system_runs_a_packed_directory(datasets, tmp_path):
    """The wire is the dataset: a run over the directory archives what a
    run over the frames archives (the tracker packs those itself)."""
    from vdo_slam_tpu_torch.pipeline import System

    _, pds = datasets
    kw, _ = PACKS["entropy"]
    out = ppd.pack_dataset(pds, tmp_path / "p", depth_map_factor=1.0, **kw)
    _, cfg = tiny_pair(fused_chunk=2, **WIRE)
    packed = ppd.PackedDataset(out)
    packed.check_config(cfg)
    poses = []
    for ds in (packed, pds):
        sysm = System(cfg, enable_local_ba=False, enable_global_ba=False,
                      mode="fused", device="cpu")
        assert len(sysm.run_sequence(ds)) == len(pds)
        poses.append(np.stack(sysm.map.cam_pose))
    np.testing.assert_array_equal(poses[0], poses[1])


def test_prefetcher_yields_in_order_and_surfaces_errors(datasets):
    _, pds = datasets
    assert [fd.timestamp for fd in iterate(pds)] == [
        pds[i].timestamp for i in range(len(pds))]

    class Broken:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            if i == 1:
                raise KeyError("frame 1")
            return i

    pf = ThreadedPrefetcher(Broken())
    it = iter(pf)
    assert next(it) == 0
    with pytest.raises(KeyError):
        next(it)
    pf.close()
