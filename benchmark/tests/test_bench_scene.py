"""The benchmark's scene against the port's make_scene, and its frames'
encodings against the port's dataset readers, on a few small frames."""

import numpy as np
import pytest
import torch

from benchmark import scene as S


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(num_frames=5, width=160, height=96, num_objects=2, seed=3, fx=None):
    from vdo_slam_tpu_torch.io.synthetic import make_scene

    fx = float(width) if fx is None else fx
    ref = make_scene(num_frames=num_frames, width=width, height=height,
                     num_objects=num_objects, fx=fx, seed=seed)
    lay = S.make_layout(num_frames, width, height, num_objects, fx, fx, seed)
    R = S.Renderer(lay, "cpu")
    frames = [R.frame(f) for f in range(num_frames)]
    return ref, lay, frames


@pytest.mark.parametrize("seed,fx", [(3, None), (7, 120.0)])
def test_layout_is_make_scenes(seed, fx):
    ref, lay, _ = _both(seed=seed, fx=fx)
    np.testing.assert_array_equal(lay.T_wc.astype(np.float32), ref.T_wc_gt)
    np.testing.assert_array_equal(lay.L.astype(np.float32), ref.obj_pose_gt)
    np.testing.assert_array_equal(lay.H.astype(np.float32), ref.obj_H_gt)
    np.testing.assert_array_equal(lay.K.astype(np.float32), ref.K_mat)


@pytest.mark.parametrize("seed,fx", [(3, None), (7, 120.0)])
def test_render_is_make_scenes(seed, fx):
    ref, _, frames = _both(seed=seed, fx=fx)
    for f, fr in enumerate(frames):
        mask = fr["mask"].numpy()
        same = mask == ref.mask[f]
        # float64 sums in another order may move a pixel on a plane's edge
        assert same.mean() > 0.999, f
        np.testing.assert_allclose(fr["depth"].numpy()[same],
                                   ref.depth[f][same], rtol=1e-6)
        agree = same & (fr["gray"].numpy() == ref.rgb[f])
        assert agree.mean() > 0.999
        np.testing.assert_allclose(fr["flow"].numpy()[same],
                                   ref.flow[f][same], atol=1e-4)


def test_follow_keeps_objects_in_view():
    follow = {"heading_amp_rad": [0.02, 0.06],
              "heading_period_frames": [120.0, 240.0],
              "speed_amp": [0.05, 0.15],
              "speed_period_frames": [150.0, 300.0]}
    lay = S.make_layout(1201, 160, 96, 3, 160.0, 160.0, 2**33 + 5,
                        cam_yaw_rate=0.0, obj_spacing=4.0,
                        road_extra=0.25 * 1201, motion="follow",
                        follow=follow)
    rel = np.einsum("fij,fkjl->fkil", S.inv(lay.T_wc), lay.L)[..., :3, 3]
    ahead = rel[..., 2]
    assert ahead.min() > 5.0 and ahead.max() < 30.0
    assert np.abs(rel[..., 0]).max() < 6.0


def test_depth_raw_and_rows_are_the_datasets():
    from vdo_slam_tpu_torch.io.dataset import SyntheticDataset
    from vdo_slam_tpu_torch.io.synthetic import make_scene

    ref = make_scene(num_frames=4, width=160, height=96, num_objects=2,
                     fx=160.0, seed=3)
    lay = S.make_layout(4, 160, 96, 2, 160.0, 160.0, 3)
    ds = SyntheticDataset(ref, depth_map_factor=256.0, bf=387.5744)
    for f in range(3):
        fd = ds[f]
        np.testing.assert_array_equal(S.obj_rows_kitti(lay, f),
                                      fd.obj_gt_rows)
        assert S.timestamp(f) == fd.timestamp
        d = S.depth_raw(torch.from_numpy(ref.depth[f]), 256.0, 387.5744)
        np.testing.assert_array_equal(d.numpy(), fd.depth_raw)
