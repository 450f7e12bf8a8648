"""Typed configuration — a jax-free copy of vdo_slam_tpu/config.py.

The dataclasses (every field and default), `tpu_fast` and `load_settings`
are the JAX package's, so a config built for one package means the same in
the other (tests/test_torch_host.py compares them field by field).  Only
the yaml import moved into `load_settings`: the GPU host may lack PyYAML
and nothing else here needs it.  The comments are cut to what each field
is and where the reference sets it; the measurements behind the defaults
were taken on a TPU and stay in the original's comments.

One dataclass surfaces every knob of the reference: the yaml keys parsed
by Tracking's ctor (reference src/Tracking.cc:53-161), the constants the
reference hardcodes, and the static-shape capacities that replace its
dynamic std::vectors.  `load_settings` reads the reference's
OpenCV-FileStorage yaml files directly.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any

OMD = 1
KITTI = 2
VIRTUAL_KITTI = 3


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    fx: float = 721.5377
    fy: float = 721.5377
    cx: float = 609.5593
    cy: float = 172.8540
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 1242
    height: int = 375
    fps: float = 10.0
    bf: float = 387.5744
    rgb: bool = True


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    # ORBextractor params (yaml ORBextractor.*; descriptors are disabled in the
    # reference — ORBextractor.cc:1091 — so only FAST corners are produced).
    n_features: int = 2500
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    fast_cell: int = 30            # FAST detection cell size, ORBextractor.cc:789
    edge_threshold: int = 19       # ORBextractor.cc EDGE_THRESHOLD
    # background feature policy
    use_sample_feature: bool = False   # yaml UseSampleFeature
    n_sample_points: int = 3000        # Frame::SampleKeyPoints N (Frame.cc:676)
    sample_grid_div: int = 20          # Frame.cc:677
    # semi-dense object sampling
    obj_sample_step: int = 4           # Frame.cc:201


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    dataset: int = KITTI               # yaml ChooseData
    depth_map_factor: float = 256.0    # yaml DepthMapFactor
    th_depth_bg: float = 40.0          # yaml ThDepthBG
    th_depth_obj: float = 25.0         # yaml ThDepthOBJ
    max_track_points_bg: int = 1200    # yaml MaxTrackPointBG
    max_track_points_obj: int = 800    # yaml MaxTrackPointOBJ
    sf_mg_thres: float = 0.12          # yaml SFMgThres (scene-flow magnitude)
    sf_ds_thres: float = 0.3           # yaml SFDsThres (static fraction)
    window_size: int = 20              # yaml WINDOW_SIZE
    overlap_size: int = 4              # yaml OVERLAP_SIZE
    joint_flow: bool = True            # bJoint, hardcoded true Tracking.cc:170
    # dynamic-object gating (hardcoded in reference)
    boundary_shrink_row: int = 25      # Tracking.cc:1404-1408 (KITTI only)
    boundary_shrink_col: int = 50
    boundary_frac_thres: float = 0.5   # Tracking.cc:1413 count_thres
    min_obj_points: int = 150          # Tracking.cc:1490
    min_init_inliers: int = 50         # Tracking.cc:879-890
    renew_depth_gate_bg: float = 40.0  # Tracking.cc:2691
    renew_depth_gate_obj: float = 25.0 # Tracking.cc:2849
    mask_recover_min_points: int = 100 # Tracking.cc:3044 (LabTmp.size()<100)
    # run the UpdateMask label-propagation repair (Tracking.cc:2997-3241)
    # inside the fused device step
    fused_mask_prop: bool = True
    # depth-noise fault injection (Frame.cc:489-493): sigma = z^2/(725*0.5)*0.15
    depth_noise: bool = False
    depth_noise_scale: float = 0.15 / (725.0 * 0.5)
    # fused mode: frames tracked per call of the tracker (grab_chunk)
    fused_chunk: int = 1
    # The packed wire (io/packing.py): half-res fp16 flow, the flow
    # downsample factor (0 = derive from wire_flow_half; 1, 2 or 4), the
    # lossless row-delta flow coding, the depth downsample factor (1 or 2)
    # and its sparse residual corrections, the lossless entropy wire, and
    # the entropy wire's per-frame exception capacities.
    wire_flow_half: bool = False
    wire_flow_down: int = 0
    wire_flow_delta: bool = False
    wire_depth_down: int = 1
    wire_depth_resid: int = 0
    wire_entropy: bool = False
    wire_seg_cap: int = 8192
    wire_depth_exc_cap: int = 8192
    # The depth plane's u16 steps per unit of raw / depth_map_factor: a
    # metre of RGB-D depth, a pixel of stereo disparity (KITTI, OMD).  256
    # is the JAX package's wire, up to 255.996 px of disparity (1.514 m at
    # bf 387.5744); 64 carries up to 1023.98 px (0.379 m), a hand-held
    # camera's range.  A port-only field: every other value keeps the
    # JAX package's bytes.
    wire_depth_steps: int = 256

    def __post_init__(self):
        # the JAX package's validation: fail at config time
        if self.wire_flow_down not in (0, 1, 2, 4):
            raise ValueError(
                f"wire_flow_down must be one of 0 (derive from "
                f"wire_flow_half), 1, 2, 4 — got {self.wire_flow_down}")
        if self.wire_depth_down not in (1, 2):
            raise ValueError(f"wire_depth_down must be 1 or 2 — got "
                             f"{self.wire_depth_down}")
        if self.wire_depth_down > 1 and self.flow_down == 1:
            raise ValueError("wire_depth_down=2 requires a flow-downsampled "
                             "wire (wire_flow_half or wire_flow_down>1)")
        if self.wire_depth_resid and self.wire_depth_down <= 1:
            raise ValueError("wire_depth_resid requires wire_depth_down=2")
        if self.wire_depth_steps < 1:
            raise ValueError(f"wire_depth_steps must be >= 1 — got "
                             f"{self.wire_depth_steps}")
        if self.wire_depth_resid < 0:
            raise ValueError(f"wire_depth_resid must be >= 0 — got "
                             f"{self.wire_depth_resid}")
        if self.wire_entropy:
            if self.flow_down == 1:
                raise ValueError("wire_entropy requires a flow-downsampled "
                                 "wire (wire_flow_half or wire_flow_down>1)")
            if self.wire_depth_down > 1 or self.wire_depth_resid:
                raise ValueError("wire_entropy excludes wire_depth_down/"
                                 "wire_depth_resid (it carries full-res "
                                 "depth losslessly)")

    @property
    def flow_down(self) -> int:
        return self.wire_flow_down or (2 if self.wire_flow_half else 1)

    @property
    def flow_delta(self) -> bool:
        return self.wire_flow_delta

    @property
    def depth_down(self) -> int:
        return self.wire_depth_down

    @property
    def depth_resid(self) -> int:
        return self.wire_depth_resid

    @property
    def entropy(self) -> bool:
        return self.wire_entropy

    # fused mode: chunks (frames, in the S-stream system) per batched
    # output drain
    fused_drain_chunks: int = 4


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    # RANSAC init (Tracking.cc:1652-1655)
    ransac_iters: int = 500
    ransac_reproj_thres: float = 0.4
    ransac_confidence: float = 0.98
    # joint flow-pose LM (Optimizer.cc:2333-2542 / 2755-2972)
    rp_thres: float = 0.04             # chi2 outlier threshold + Huber delta^2
    info_proj: float = 0.1             # projection-edge information (2335)
    info_flow_cam: float = 0.3         # flow-prior information, camera (2440)
    info_flow_obj: float = 0.5         # flow-prior information, object (2869)
    lm_iters: int = 15                 # g2o runs 100 (2455)
    lm_iters_obj: int | None = None    # object-LM override (None = lm_iters)
    lm_lambda_init: float = 1e-5
    lm_lambda_factor: float = 10.0
    # all-inlier rigid re-fit of the RANSAC / motion-model winner before the
    # flow-LM (solvers/ransac.refine_with_inliers, SVD-free polar Kabsch);
    # the reference re-runs full LM from the raw init instead
    # (Tracking.cc:1693-1713 -> Optimizer.cc:2333)
    refit_init: bool = True
    lm_unroll: int = 2                 # scan unroll of the JAX LM; the
                                       # port's fixed-length loop gives the
                                       # same result for every value
    update_flow: bool = True           # refined flow overwrites keypoints (2524)


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    # windowed (local) BA — Optimizer::PartialBatchOptimization (Optimizer.cc:42-)
    local_sigma2_cam: float = 1e-4     # Optimizer.cc:190
    local_sigma2_3d_sta: float = 16.0  # Optimizer.cc:191
    local_gain_thres: float = 1e-3     # Optimizer.cc:141
    local_iters: int = 100
    local_unroll: int = 4              # XLA scan unroll of the JAX window
                                       # solve; inert in the port
    # full-batch BA — Optimizer::FullBatchOptimization (Optimizer.cc:1232-)
    # odometry-chain information; the reference ships 1e-3 for KITTI and
    # 1e-4 for OMD (Optimizer.cc:1330), the JAX package defaults to 1e-4
    full_sigma2_cam: float = 1e-4
    full_sigma2_3d_sta: float = 80.0
    full_sigma2_obj_smo: float = 1e-3
    full_sigma2_obj: float = 100.0
    full_sigma2_3d_dyn: float = 80.0
    full_sigma2_alti: float = 0.1
    full_gain_thres: float = 1e-4
    full_iters: int = 3                # g2o uses up to 300 w/ early stop
    prior_information: float = 1e5     # Optimizer.cc:1341 (*100000)
    huber_delta: float = 1e-4          # deltaHuberCamMot/ObjMot/3D, Optimizer.cc:1352
    # fp32-adjusted Huber delta for SE(3) chain edges (odo/smooth); see
    # factor_graph.LMParams.pose_huber_delta of the JAX package
    pose_huber_delta: float = 1e-3
    track_len_thres: int = 3           # FeaLengthThresSta/Dyn (Optimizer.cc:74,85)
    robust_kernel: bool = True
    smooth_constraint: bool = True
    altitude_constraint: bool = False
    local_static_only: bool = True     # STATIC_ONLY=true in local BA (Optimizer.cc:211)
    # full BA: PCG iterations and tolerance (inert in both packages) per
    # LM iteration, PCG scan unroll (inert in the port), LM iterations per
    # chunk (the gain test runs at chunk ends), and optional fixed
    # capacities of the full graph (obs edges, ternary edges, point
    # vertices, motion vertices, smoothness edges; None = bucket-rounded
    # shapes)
    cg_iters: int = 12
    cg_tol: float = 1e-6
    cg_unroll: int = 4
    full_ba_chunk: int = 3
    full_obs_cap: int | None = None
    full_ter_cap: int | None = None
    full_point_cap: int | None = None
    full_motion_cap: int | None = None
    full_smo_cap: int | None = None


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """Static padding capacities (in place of the reference's dynamic
    vectors)."""
    max_static: int = 1200             # == MaxTrackPointBG
    max_dynamic: int = 4096            # total dynamic feature slots per frame
    max_objects: int = 16              # concurrent object motion slots
    max_sem_labels: int = 32           # distinct instance labels in one frame
    ransac_samples: int = 256          # minimal solves per RANSAC
    # Per-slot feature capacity of the object motion solve.  Renewal caps
    # each semantic label at max_track_points_obj features (quota_select),
    # so gathering each slot's members into a (K, M) bank before RANSAC+LM
    # is exact.  None = auto (max_track_points_obj * 1.25 rounded up to
    # 128, floored at 256; the 25% headroom absorbs transient over-quota
    # membership when a mask merge relabels inherited features mid-frame).
    obj_solver_cap: int | None = None


@dataclasses.dataclass(frozen=True)
class VDOConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    backend: BackendConfig = dataclasses.field(default_factory=BackendConfig)
    shapes: ShapeConfig = dataclasses.field(default_factory=ShapeConfig)
    seed: int = 0                      # deterministic PRNG (ref uses time(NULL))

    def replace(self, **kwargs: Any) -> "VDOConfig":
        return dataclasses.replace(self, **kwargs)


# The port's fields that the JAX package's dataclasses lack, each with the
# value at which the port does what the JAX package does.
PORT_ONLY = {"tracking": {"wire_depth_steps": 256}}


def jax_fields(cfg: VDOConfig) -> dict:
    """dataclasses.asdict(cfg) without the port-only fields: the JAX
    package's VDOConfig of the same configuration, as a dict.  ValueError
    where a port-only field is off its JAX value: no JAX configuration
    does the same."""
    d = dataclasses.asdict(cfg)
    for section, fields in PORT_ONLY.items():
        for name, jax_value in fields.items():
            value = d[section].pop(name)
            if value != jax_value:
                raise ValueError(f"{section}.{name} = {value!r}: the JAX "
                                 f"package has only {jax_value!r}")
    return d


def tpu_fast(cfg: VDOConfig) -> VDOConfig:
    """The JAX package's throughput preset (bench.py uses it): camera and
    object LM iterations 10 and 6, the lossless packed wire (half-res flow,
    row-delta flow coding, entropy wire), 8 chunks per output drain, and 4
    window-BA iterations; the port runs all of them, the wire flags
    included (io/packing.py).  Why each value was chosen, and what was
    measured on a TPU for it, is in the original's docstring.
    """
    return cfg.replace(
        solver=dataclasses.replace(cfg.solver, lm_iters=10, lm_iters_obj=6),
        tracking=dataclasses.replace(cfg.tracking, wire_flow_half=True,
                                     wire_flow_delta=True,
                                     wire_entropy=True,
                                     fused_drain_chunks=8),
        backend=dataclasses.replace(cfg.backend, local_iters=4),
    )


def _parse_opencv_yaml(path: str | Path) -> dict:
    """Parse an OpenCV FileStorage yaml (the reference's settings format)."""
    import yaml

    text = Path(path).read_text()
    text = re.sub(r"^%YAML:[\d.]+\s*", "", text)
    text = text.replace("!!opencv-matrix", "")
    return yaml.safe_load(text) or {}


def load_settings(path: str | Path, **overrides: Any) -> VDOConfig:
    """Build a VDOConfig from a reference-format settings yaml.

    Mirrors the key list in Tracking's ctor (Tracking.cc:53-161).  Unknown
    keys are ignored; missing keys keep the KITTI defaults.
    """
    raw = _parse_opencv_yaml(path)

    def g(key, default):
        v = raw.get(key, default)
        return v if v is not None else default

    cam = CameraConfig(
        fx=float(g("Camera.fx", 721.5377)),
        fy=float(g("Camera.fy", 721.5377)),
        cx=float(g("Camera.cx", 609.5593)),
        cy=float(g("Camera.cy", 172.8540)),
        k1=float(g("Camera.k1", 0.0)),
        k2=float(g("Camera.k2", 0.0)),
        p1=float(g("Camera.p1", 0.0)),
        p2=float(g("Camera.p2", 0.0)),
        k3=float(g("Camera.k3", 0.0)),
        width=int(g("Camera.width", 1242)),
        height=int(g("Camera.height", 375)),
        fps=float(g("Camera.fps", 10.0)) or 30.0,
        bf=float(g("Camera.bf", 387.5744)),
        rgb=bool(int(g("Camera.RGB", 1))),
    )
    fe = FrontendConfig(
        n_features=int(g("ORBextractor.nFeatures", 2500)),
        scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(g("ORBextractor.minThFAST", 7)),
        use_sample_feature=bool(int(g("UseSampleFeature", 0))),
    )
    tr = TrackingConfig(
        dataset=int(g("ChooseData", KITTI)),
        depth_map_factor=float(g("DepthMapFactor", 256.0)),
        th_depth_bg=float(g("ThDepthBG", 40.0)),
        th_depth_obj=float(g("ThDepthOBJ", 25.0)),
        max_track_points_bg=int(g("MaxTrackPointBG", 1200)),
        max_track_points_obj=int(g("MaxTrackPointOBJ", 800)),
        sf_mg_thres=float(g("SFMgThres", 0.12)),
        sf_ds_thres=float(g("SFDsThres", 0.3)),
        window_size=int(g("WINDOW_SIZE", 20)),
        overlap_size=int(g("OVERLAP_SIZE", 4)),
    )
    shapes = ShapeConfig(max_static=tr.max_track_points_bg)
    cfg = VDOConfig(camera=cam, frontend=fe, tracking=tr, shapes=shapes)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
