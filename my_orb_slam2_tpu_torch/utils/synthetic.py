"""Synthetic worlds, drives and trajectory error in numpy (counterpart of
my_orb_slam2_tpu/utils/synthetic.py and of the drive in bench.py).

- `SyntheticWorld`: the reference's landmark field with per-landmark
  descriptors; `observe` renders keypoint frames (no images) straight into
  the port's `FrameData` on a given device. The same seed and pose give the
  reference's frame bit for bit. `capacity_config` / `capacity_world` are
  tools/capacity_drive.py's KITTI-00-scale drive.

- `loop_config` / `loop_world`: tools/loop_drive.py's closed circuit
  (the tool imports jax, so its world is rebuilt here in numpy).

- `ate_rmse`: absolute trajectory error (RMSE of camera centres) after a
  closed-form Horn alignment, here in numpy float64 (the reference uses
  ops/horn.horn_align in JAX float32).
- `render_stereo_pair` / `stereo_drive`: the blob world, stereo renderer
  and forward-with-yaw pose sequence of bench.py, so the port is driven on
  the same images. bench.py also draws an (H, W) normal field per image
  and multiplies it by 0; that draw cannot change a pixel, so it is left
  out here.
"""

from __future__ import annotations

import numpy as np

import torch

from my_orb_slam2_tpu_torch.ops import lie
from my_orb_slam2_tpu_torch.utils.config import (
    CameraConfig, CapacityConfig, OrbConfig, SlamConfig, Sensor, TrackingConfig,
)


class SyntheticWorld:
    """A random landmark box ahead of the initial camera, with a stable
    random descriptor, a base octave, a reference distance (the octave
    follows the distance like a pyramid detector) and a detection priority
    per landmark. Draws from `default_rng(seed)` in the reference's order."""

    def __init__(self, cfg: SlamConfig, n_landmarks: int = 2000, seed: int = 0,
                 extent=(20.0, 8.0, 30.0), depth_range=(2.0, 40.0)):
        self.cfg = cfg
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.landmarks = np.stack(
            [
                rng.uniform(-extent[0], extent[0], n_landmarks),
                rng.uniform(-extent[1], extent[1], n_landmarks),
                rng.uniform(depth_range[0], depth_range[1], n_landmarks),
            ],
            axis=1,
        )
        self.desc = rng.integers(0, 2 ** 32, size=(n_landmarks, 8), dtype=np.uint32)
        self.base_octave = rng.integers(0, 3, n_landmarks)
        self.z_ref = np.maximum(np.linalg.norm(self.landmarks, axis=1), 1.0) * (1.2 ** self.base_octave)
        self.priority = rng.random(n_landmarks)

    def circular_trajectory(self, n_frames: int, radius: float = 5.0, forward_per_frame: float = 0.06,
                            yaw_per_frame: float = 0.0) -> np.ndarray:
        """Forward motion with optional yaw; returns (n, 4, 4) Tcw (float64,
        each step an f32 rotation as in the reference)."""
        step = np.eye(4, dtype=np.float32)
        step[:3, :3] = lie.so3_exp(torch.tensor([0.0, yaw_per_frame, 0.0])).numpy()
        step[:3, 3] = [0.0, 0.0, forward_per_frame]
        poses = []
        Twc = np.eye(4)
        for _ in range(n_frames):
            Twc = Twc @ step
            poses.append(np.linalg.inv(Twc))
        return np.stack(poses)

    def observe(self, Tcw: np.ndarray, capacity: int, noise_px: float = 0.3, desc_noise_bits: int = 4,
                dropout: float = 0.05, stereo: bool = True, stereo_fraction: float = 1.0, seed=None,
                device="cpu"):
        """Render up to `capacity` visible landmarks (strongest first) as a
        FrameData on `device`. Returns (frame, landmark id per slot, -1
        for padding)."""
        from my_orb_slam2_tpu_torch.utils.bridge import frame_from_numpy

        cam = self.cfg.camera
        rng = np.random.default_rng(seed) if seed is not None else self.rng
        pc = self.landmarks @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = cam.fx * pc[:, 0] / z + cam.cx
            v = cam.fy * pc[:, 1] / z + cam.cy
        vis = (z > 0.3) & (u >= 10) & (u < cam.width - 10) & (v >= 10) & (v < cam.height - 10)
        vis &= rng.random(len(z)) > dropout
        ids = np.nonzero(vis)[0]
        ids = ids[np.argsort(-self.priority[ids])][:capacity]
        k = len(ids)

        uv = np.zeros((capacity, 2), np.float32)
        ur = np.full((capacity,), -1.0, np.float32)
        depth = np.full((capacity,), -1.0, np.float32)
        octave = np.zeros((capacity,), np.int32)
        desc = np.zeros((capacity, 8), np.uint32)
        valid = np.zeros((capacity,), bool)
        lm = np.full((capacity,), -1, np.int32)
        uv[:k, 0] = u[ids] + rng.normal(0, noise_px, k)
        uv[:k, 1] = v[ids] + rng.normal(0, noise_px, k)
        if stereo:
            has_st = rng.random(k) < stereo_fraction
            ur[:k] = np.where(has_st, uv[:k, 0] - cam.bf / z[ids] + rng.normal(0, noise_px, k), -1.0)
            depth[:k] = np.where(has_st, cam.bf / np.maximum(uv[:k, 0] - ur[:k], 1e-6), -1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            oct_f = np.log(self.z_ref[ids] / np.maximum(z[ids], 0.1)) / np.log(self.cfg.orb.scale_factor)
        octave[:k] = np.clip(np.round(oct_f).astype(np.int32), 0, self.cfg.orb.n_levels - 1)
        d = self.desc[ids].copy()
        for _ in range(desc_noise_bits):  # flip a few random bits per observation
            word = rng.integers(0, 8, k)
            bit = rng.integers(0, 32, k).astype(np.uint32)
            d[np.arange(k), word] ^= (np.uint32(1) << bit)
        desc[:k] = d
        valid[:k] = True
        lm[:k] = ids
        frame = frame_from_numpy(
            dict(uv=uv, ur=ur, depth=depth, octave=octave, angle=np.zeros((capacity,), np.float32),
                 desc=desc, valid=valid),
            device,
        )
        return frame, lm


def horn_align(p1: np.ndarray, p2: np.ndarray, fix_scale: bool = False):
    """Solve p1 ~= s * R @ p2 + t in closed form (Horn 1987 quaternion
    method, the same construction as ops/horn.horn_align)."""
    c1 = p1.mean(axis=0)
    c2 = p2.mean(axis=0)
    q1 = p1 - c1
    q2 = p2 - c2
    M = q1.T @ q2
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = M
    N = np.array(
        [
            [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
            [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
            [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
            [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
        ]
    )
    _, evecs = np.linalg.eigh(N)
    qw, qx, qy, qz = evecs[:, 3]
    R = np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
        ]
    ).T
    rq2 = q2 @ R.T
    s = 1.0 if fix_scale else float(np.sum(q1 * rq2) / max(np.sum(rq2 * rq2), 1e-12))
    return R, c1 - s * (R @ c2), s


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True,
             align_scale: bool = False) -> float:
    """RMSE of camera-centre translation after optional SE3 (or Sim3 with
    align_scale) alignment, the TUM evaluation metric."""
    est_c = np.stack([-T[:3, :3].T @ T[:3, 3] for T in np.asarray(est_poses, np.float64)])
    gt_c = np.stack([-T[:3, :3].T @ T[:3, 3] for T in np.asarray(gt_poses, np.float64)])
    if align:
        R, t, s = horn_align(gt_c, est_c, fix_scale=not align_scale)
        est_c = s * (est_c @ R.T) + t
    err = est_c - gt_c
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def bench_config(height: int = 480, width: int = 640, n_features: int = 1000) -> SlamConfig:
    """bench.py's stereo configuration (640x480, 1000 features, 8 levels at
    1.2, 64 keyframes, 16384 map points, 200 stereo init points)."""
    return SlamConfig(
        sensor=Sensor.STEREO,
        camera=CameraConfig(
            fx=500.0, fy=500.0, cx=width / 2, cy=height / 2, bf=40.0, th_depth=40.0,
            width=width, height=height,
        ),
        orb=OrbConfig(n_features=n_features),
        capacity=CapacityConfig(max_keyframes=64, max_map_points=16384),
        tracking=TrackingConfig(min_stereo_init_points=200),
    )


def capacity_config() -> SlamConfig:
    """tools/capacity_drive.py's KITTI-00-scale configuration: KITTI 00
    intrinsics (1241x376), 2000 features, 1536 keyframes, 262,144 map
    points, 300 stereo init points, a keyframe at least every 10 frames."""
    return SlamConfig(
        sensor=Sensor.STEREO,
        camera=CameraConfig(fx=718.856, fy=718.856, cx=607.19, cy=185.21, bf=386.1448, th_depth=35.0,
                            width=1241, height=376),
        orb=OrbConfig(n_features=2000),
        capacity=CapacityConfig(max_keyframes=1536, max_map_points=262144),
        tracking=TrackingConfig(min_stereo_init_points=300, max_frames_between_kf=10),
    )


def capacity_world(cfg: SlamConfig, n_frames: int, n_landmarks: int = 120000):
    """tools/capacity_drive.py's world: a 1200 m corridor of landmarks and a
    trajectory of 0.8 m and 0.001 rad a frame. Returns (world, poses)."""
    world = SyntheticWorld(cfg, n_landmarks=n_landmarks, seed=0, extent=(25.0, 8.0, 1200.0),
                           depth_range=(2.0, 1200.0))
    return world, world.circular_trajectory(n_frames, forward_per_frame=0.8, yaw_per_frame=0.001)


def loop_config() -> SlamConfig:
    """tools/loop_drive.py's configuration: KITTI 00's intrinsics, 2000
    features, 2048 keyframes, 262,144 map points, 300 stereo init points, a
    keyframe at least every 10 frames."""
    return SlamConfig(
        sensor=Sensor.STEREO,
        camera=CameraConfig(fx=718.856, fy=718.856, cx=607.19, cy=185.21, bf=386.1448, th_depth=35.0,
                            width=1241, height=376),
        orb=OrbConfig(n_features=2000),
        capacity=CapacityConfig(max_keyframes=2048, max_map_points=262144),
        tracking=TrackingConfig(min_stereo_init_points=300, max_frames_between_kf=10),
    )


def loop_world(cfg: SlamConfig, n_frames: int, n_landmarks: int = 120000):
    """tools/loop_drive.py's closed circuit in numpy: one lap of 0.4 m a
    frame in (n_frames - overlap) frames, overlap = max(n_frames // 12, 60)
    frames revisiting the start, and a ring of landmarks 25 m inside to 45 m
    outside the road, 8 m high, with viewing distances of 8-60 m. Returns
    (world, poses (n, 4, 4) Tcw, overlap)."""
    overlap = max(n_frames // 12, 60)
    fwd = 0.4
    yaw = 2.0 * np.pi / (n_frames - overlap)
    R = fwd / yaw
    world = SyntheticWorld(cfg, n_landmarks=n_landmarks, seed=0)
    rng = np.random.default_rng(1)
    rng.uniform(0, 2 * np.pi, n_landmarks)  # the tool's first ring, replaced below
    rng.uniform(-25.0, 45.0, n_landmarks)
    rng.uniform(-8.0, 8.0, n_landmarks)
    world.z_ref = rng.uniform(8.0, 60.0, n_landmarks) * (1.2 ** world.base_octave)
    poses = world.circular_trajectory(n_frames, forward_per_frame=fwd, yaw_per_frame=yaw)
    c_xz = np.stack([np.linalg.inv(T)[:3, 3] for T in poses])[:, [0, 2]].mean(axis=0)
    rng = np.random.default_rng(1)
    theta = rng.uniform(0, 2 * np.pi, n_landmarks)
    r = R + rng.uniform(-25.0, 45.0, n_landmarks)
    world.landmarks = np.stack(
        [c_xz[0] + r * np.cos(theta), rng.uniform(-8.0, 8.0, n_landmarks), c_xz[1] + r * np.sin(theta)], axis=1
    )
    return world, poses, overlap


def _se3_exp_np(xi: np.ndarray) -> np.ndarray:
    """SE3 exponential in float64 (closed form, theta > 0)."""
    ups, omg = xi[:3], xi[3:]
    th = np.linalg.norm(omg)
    K = np.array([[0, -omg[2], omg[1]], [omg[2], 0, -omg[0]], [-omg[1], omg[0], 0]])
    if th < 1e-12:
        R, V = np.eye(3) + K, np.eye(3)
    else:
        a, b, c = np.sin(th) / th, (1 - np.cos(th)) / th ** 2, (th - np.sin(th)) / th ** 3
        R = np.eye(3) + a * K + b * (K @ K)
        V = np.eye(3) + b * K + c * (K @ K)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ ups
    return T


def render_stereo_pair(world_pts, intensities, Tcw, cam: CameraConfig, H: int, W: int):
    """Render left/right float32 images of the blob world (bench.py's
    renderer: a sinusoid background plus one square blob per visible
    point)."""
    yy, xx = np.mgrid[0:H, 0:W]
    base = 28.0 + 16.0 * np.sin(xx * 0.11) * np.cos(yy * 0.07)
    imgs = []
    for dx in (0.0, cam.baseline):
        pc = world_pts @ Tcw[:3, :3].T + Tcw[:3, 3]
        pc[:, 0] -= dx
        z = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = cam.fx * pc[:, 0] / z + cam.cx
            v = cam.fy * pc[:, 1] / z + cam.cy
        img = base.copy()
        ok = (z > 0.5) & (u > 12) & (u < W - 12) & (v > 12) & (v < H - 12)
        for i in np.nonzero(ok)[0]:
            ui, vi = int(u[i]), int(v[i])
            s = 2 + i % 4
            img[vi - s : vi + s + 1, ui - s : ui + s + 1] = intensities[i]
        imgs.append(img.astype(np.float32))
    return imgs[0], imgs[1]


def stereo_drive(cfg: SlamConfig, n_frames: int = 100, seed: int = 0, n_pts: int = 900):
    """bench.py's drive: a 900-blob world from `seed`, the camera advancing
    0.03 m and yawing 0.002 rad per frame. Returns (poses (n, 4, 4) float32
    ground-truth Tcw, [(left, right) uint8 images])."""
    cam = cfg.camera
    H, W = cam.height, cam.width
    rng = np.random.default_rng(seed)
    world_pts = np.stack(
        [rng.uniform(-6, 6, n_pts), rng.uniform(-4, 4, n_pts), rng.uniform(3, 25, n_pts)], 1
    )
    intensities = rng.uniform(70, 240, n_pts)
    step = _se3_exp_np(np.array([0.0, 0.0, 0.03, 0.0, 0.002, 0.0]))
    poses = []
    Twc = np.eye(4)
    for _ in range(n_frames):
        Twc = Twc @ step
        poses.append(np.linalg.inv(Twc).astype(np.float32))
    pairs = [
        tuple(np.clip(im, 0, 255).astype(np.uint8) for im in render_stereo_pair(world_pts, intensities, T, cam, H, W))
        for T in poses
    ]
    return np.stack(poses), pairs
