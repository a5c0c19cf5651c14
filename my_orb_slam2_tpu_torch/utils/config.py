"""Configuration for the TPU SLAM engine.

Collects every behavioural constant of the reference pipeline (camera
intrinsics, ORB extractor settings, matcher thresholds, keyframe policy,
capacities) into frozen dataclasses that are hashable, so they can be passed
as static arguments to jitted functions.

Reference parity: the camera/ORB keys mirror the cv::FileStorage YAML schema
parsed in the reference Tracking ctor (reference src/Tracking.cc:53-164), and
the fixed thresholds mirror the constants catalogued in SURVEY.md §2.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera + stereo baseline parameters (YAML `Camera.*` keys)."""

    fx: float = 517.306408
    fy: float = 516.469215
    cx: float = 318.643040
    cy: float = 255.313989
    # Radial/tangential distortion (k1 k2 p1 p2 k3); zeros = rectified input.
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    # Stereo baseline times fx ("Camera.bf"); 0 for monocular.
    bf: float = 40.0
    fps: float = 30.0
    width: int = 640
    height: int = 480
    # Depth threshold factor: close/far split at th_depth * baseline
    # (reference src/Tracking.cc:124-129).
    th_depth: float = 40.0
    # RGB-D depth map scaling ("DepthMapFactor", reference src/Tracking.cc:131-137).
    depth_map_factor: float = 5000.0

    @property
    def baseline(self) -> float:
        return self.bf / self.fx if self.fx else 0.0

    @property
    def close_depth(self) -> float:
        return self.th_depth * self.baseline


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """ORB feature extraction settings (YAML `ORBextractor.*` keys).

    Mirrors reference src/ORBextractor.cc constructor parameters plus the
    internal constants (patch size, edge threshold, FAST ring radius).
    """

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # FAST circle: 16-pixel Bresenham ring of radius 3; arc length 9
    # (cv::FAST 9_16, used by reference src/ORBextractor.cc:786).
    fast_arc: int = 9
    # Spatial-binning cell size for uniform keypoint distribution. The
    # reference uses 30px FAST cells + a quadtree NMS (DistributeOctTree,
    # src/ORBextractor.cc:539); we reproduce the spatial-uniformity contract
    # with per-cell top-k selection, which is the batched/TPU formulation.
    cell_size: int = 32
    # BRIEF patch geometry (reference src/ORBextractor.cc:72-74).
    patch_size: int = 31
    half_patch_size: int = 15
    edge_threshold: int = 19

    @property
    def padded_n_features(self) -> int:
        """Feature capacity padded to a lane-friendly multiple of 128."""
        return _round_up(self.n_features, 128)


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Hamming matcher thresholds (reference src/ORBmatcher.cc:37-39)."""

    th_high: int = 100
    th_low: int = 50
    histo_length: int = 30  # rotation-consistency histogram bins
    nn_ratio_tracking: float = 0.9  # SearchByProjection local-map ratio
    nn_ratio_bow: float = 0.7
    # Word-bucket gating — the direct-index (DBoW2 FeatureVector) analog:
    # candidate pairs in SearchForTriangulation and the loop BoW join must
    # share the vocabulary node `levels_up` levels above the leaves
    # (reference joins per node at L-4 of the 6-level ORBvoc,
    # src/ORBmatcher.cc:702-877; for the packed k-ary tree the node id is
    # simply word // k^levels_up). 0 disables (no vocabulary wired, or LSH
    # fallback). SlamSystem sets this from its vocabulary at construction.
    bow_gate_div: int = 0


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Tracking state-machine thresholds (reference src/Tracking.cc)."""

    # Minimum matches for TrackReferenceKeyFrame (src/Tracking.cc:815).
    min_bow_matches: int = 15
    # Minimum matches for TrackWithMotionModel (src/Tracking.cc:966).
    min_motion_matches: int = 20
    # TrackLocalMap inlier gates (src/Tracking.cc:1025-1032).
    min_localmap_inliers: int = 30
    min_localmap_inliers_after_reloc: int = 50
    # Keyframe policy (NeedNewKeyFrame, src/Tracking.cc:1049-1140).
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30
    # Stereo initialization needs this many keypoints (src/Tracking.cc:560).
    min_stereo_init_points: int = 500
    # Monocular initialization gates (src/Tracking.cc:617-637).
    min_mono_init_keypoints: int = 100
    min_mono_init_matches: int = 100
    # Local keyframe window cap (src/Tracking.cc:1388).
    max_local_keyframes: int = 80


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Local mapping policy (reference src/LocalMapping.cc)."""

    # MapPointCulling thresholds (src/LocalMapping.cc:201-243).
    min_found_ratio: float = 0.25
    # Covisible neighbors used for triangulation: 10 stereo / 20 mono
    # (src/LocalMapping.cc:272-275).
    triangulation_neighbors_stereo: int = 10
    triangulation_neighbors_mono: int = 20
    # KeyFrameCulling redundancy threshold (src/LocalMapping.cc:708-772).
    kf_cull_redundancy: float = 0.9
    kf_cull_min_obs: int = 3
    # Local BA iteration schedule (src/Optimizer.cc:577,687: 5 then 10).
    # Reference schedule is 5 robust + 10 post-demotion LM iterations
    # (src/Optimizer.cc:577-715) with a fresh linearization per accept
    # test. The dense engine's damping-feedback steps converge the small
    # local window faster; the capacity drive measured 3+4 as the knee
    # (ATE 0.13 m / 120 m at 20 fps; 4+6 gives the same ATE slower; 2+3
    # collapses to 3.2 m with keyframe spam). Gated by the drive's ATE
    # floor and the local-mapping/loop tests.
    local_ba_iters1: int = 3
    local_ba_iters2: int = 4
    # Cap on the number of local-BA camera vertices (static shape bound).
    max_local_ba_cams: int = 64
    max_local_ba_points: int = 8192
    max_local_ba_obs: int = 32768


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop closing policy (reference src/LoopClosing.cc)."""

    covisibility_consistency_th: int = 3  # src/LoopClosing.cc:43
    min_kfs_since_last_loop: int = 10  # src/LoopClosing.cc:128
    sim3_min_bow_matches: int = 20  # src/LoopClosing.cc:300
    sim3_min_inliers: int = 20  # src/LoopClosing.cc:331
    sim3_ransac_iters: int = 300
    min_total_matches: int = 40  # src/LoopClosing.cc:462
    essential_graph_min_weight: int = 100  # src/Optimizer.cc:814
    pose_graph_iters: int = 20  # src/Optimizer.cc:1007
    global_ba_iters: int = 10  # src/LoopClosing.cc:759


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """Fixed array capacities for the SoA map state (TPU static shapes)."""

    max_keyframes: int = 512
    max_map_points: int = 65536
    # Max observations gathered for global BA (static bound).
    max_global_ba_obs: int = 262144
    # Observer-list capacity per map point (the inverted observation index,
    # reference MapPoint::mObservations). Observations past this are dropped
    # and counted in MapState.obs_overflow. Live observers are bounded by
    # the live keyframe count (~30 after culling at KITTI capacity), so 32
    # makes drops rare; the local-BA problem still uses a 16-entry
    # in-window subset per point (extract_local_ba_dense) so LM cost does
    # not scale with this.
    max_obs_per_point: int = 32
    # Optional observation BUDGET per landmark: once a point's n_obs
    # (stereo counts 2, reference MapPoint::AddObservation) reaches this,
    # new keyframes stop wiring it — it keeps serving motion-model tracking
    # but fades out of local windows as its observers age out. 0 (default)
    # disables, matching the reference's unbounded observations; the
    # multi-seed capacity ablation (tools/ate_seed_sweep.py) showed no
    # significant ATE difference between budgeted and unbounded, so the
    # reference-faithful default stands.
    obs_budget: int = 0


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    sensor: Sensor = Sensor.STEREO
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    orb: OrbConfig = dataclasses.field(default_factory=OrbConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    loop: LoopConfig = dataclasses.field(default_factory=LoopConfig)
    capacity: CapacityConfig = dataclasses.field(default_factory=CapacityConfig)
    # bfloat16 for image-plane compute where precision allows.
    use_bf16_frontend: bool = False

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


def load_yaml_settings(path: str, sensor: Sensor) -> SlamConfig:
    """Build a SlamConfig from a reference-format settings YAML.

    Accepts the exact cv::FileStorage schema used by the reference examples
    (e.g. reference Examples/RGB-D/TUM1.yaml, Examples/Stereo/KITTI00-02.yaml):
    Camera.{fx,fy,cx,cy,k1,k2,p1,p2,k3,bf,fps,width,height}, ThDepth,
    DepthMapFactor, ORBextractor.{nFeatures,scaleFactor,nLevels,iniThFAST,
    minThFAST}.
    """
    import re

    text = open(path).read()
    # cv::FileStorage YAML has a %YAML directive and key: value lines.
    vals = {}
    for m in re.finditer(r"^([A-Za-z0-9_.]+):\s*([-0-9.eE+]+)\s*$", text, re.M):
        vals[m.group(1)] = float(m.group(2))

    def g(key, default):
        return vals.get(key, default)

    cam = CameraConfig(
        fx=g("Camera.fx", 517.3),
        fy=g("Camera.fy", 516.5),
        cx=g("Camera.cx", 318.6),
        cy=g("Camera.cy", 255.3),
        k1=g("Camera.k1", 0.0),
        k2=g("Camera.k2", 0.0),
        p1=g("Camera.p1", 0.0),
        p2=g("Camera.p2", 0.0),
        k3=g("Camera.k3", 0.0),
        # The reference's YAMLs carry Camera.bf even for monocular runs;
        # mono must see bf = 0 (stereo-ness is bf > 0 throughout the
        # engine — init branch, octave windows, VO anchors).
        bf=0.0 if sensor == Sensor.MONOCULAR else g("Camera.bf", 0.0),
        fps=g("Camera.fps", 30.0),
        width=int(g("Camera.width", 640)),
        height=int(g("Camera.height", 480)),
        th_depth=g("ThDepth", 40.0),
        depth_map_factor=g("DepthMapFactor", 1.0) or 1.0,
    )
    orb = OrbConfig(
        n_features=int(g("ORBextractor.nFeatures", 1000)),
        scale_factor=g("ORBextractor.scaleFactor", 1.2),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(g("ORBextractor.minThFAST", 7)),
    )
    # Engine extension keys (absent from the reference schema; the
    # reference hardcodes these, e.g. the stereo-init gate N>500 at
    # src/Tracking.cc:556-609 — synthetic fixtures need them tunable).
    tracking = TrackingConfig(
        min_stereo_init_points=int(
            g("Tracking.minStereoInitPoints",
              TrackingConfig.min_stereo_init_points)
        ),
    )
    return SlamConfig(sensor=sensor, camera=cam, orb=orb, tracking=tracking)
