"""The rendered worlds of the image cells: textured blobs along a camera
path, rendered on the card from the seed.

A world is a traffic file's `world` and `path` groups:

- `path`: the camera advances `step` metres along its own +z and yaws
  `yaw` radians about its +y axis a frame (ORB-SLAM2's synthetic drives of
  this repository: KITTI 0.4 m, TUM 0.25 m, both 0.004 rad);
- `world`: drawn from its own `seed` (one world for every run: the run's
  seed draws the sensor noise, so every seed drives the same amount of
  work); `blobs` blob centres spread evenly over `extent` (half-widths
  x and y, depth z) from `z_near` metres ahead of the first camera, the
  density kept as the path goes on: the blobs lie at an arc length `s` along
  the path (from `z_near` to the last frame's arc length plus the depth
  `extent[2]`), at uniform offsets across it, so every frame sees the same
  density ahead of it.

Each blob has a 16 x 16 texture (uniform in 20-255, smoothed three times,
stretched to 20-255), a size of 6-13 pixels at 6 m, and the views share a
smooth 32 x 32 background field; a view paints its blobs far to near, each
over its whole square, as the numpy renderer of the repository's synthetic
drives does. Everything is drawn from `torch.Generator`s on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TEX = 16


def step_transform(step: float, yaw: float) -> np.ndarray:
    """The camera-to-world increment of one frame (float64): exp of the
    twist (0, 0, step, 0, yaw, 0)."""
    c, s = math.cos(yaw), math.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    # Left Jacobian of a rotation about y applied to (0, 0, step).
    if abs(yaw) < 1e-12:
        T[:3, 3] = [0.0, 0.0, step]
    else:
        T[:3, 3] = [step * (1.0 - c) / yaw, 0.0, step * s / yaw]
    return T


def camera_path(n: int, step: float, yaw: float) -> np.ndarray:
    """(n, 4, 4) float64 camera-to-world poses, the first the identity."""
    d = step_transform(step, yaw)
    out = np.empty((n, 4, 4))
    T = np.eye(4)
    for i in range(n):
        out[i] = T
        T = T @ d
    return out


def _smooth(t: torch.Tensor, times: int, dims: tuple) -> torch.Tensor:
    a, b = dims
    for _ in range(times):
        t = (t + torch.roll(t, 1, a) + torch.roll(t, 1, b) + torch.roll(t, -1, a) + torch.roll(t, -1, b)) / 5.0
    return t


def build(world: dict, path: dict, n_frames: int, device) -> dict:
    """The blobs of a world (drawn from its own `seed`) seen by `n_frames`
    frames of `path`, and the frames' ground-truth world-to-camera poses.
    Returns a dict of device tensors (pts (n, 3) f64, tex (n, 16, 16) f64,
    sizes (n,), background (32, 32) f64) and "Tcw": (n_frames, 4, 4)
    float32 numpy."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(world["seed"]))
    step, yaw = float(path["step"]), float(path["yaw"])
    hx, hy, depth = (float(v) for v in world["extent"])
    z_near = float(world["z_near"])
    s_end = (n_frames - 1) * step + depth
    n = int(round(world["blobs"] * (s_end - z_near) / (depth - z_near)))
    n_path = int(math.ceil(s_end / step)) + 1
    Twc = torch.as_tensor(camera_path(n_path, step, yaw), device=dev)

    def uniform(lo, hi, shape, dtype=torch.float64):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev, dtype=dtype)

    arc = uniform(z_near, s_end, (n,))
    f = torch.clamp(torch.floor(arc / step).to(torch.int64), 0, n_path - 1)
    local = torch.stack([uniform(-hx, hx, (n,)), uniform(-hy, hy, (n,)), arc - f.to(torch.float64) * step], dim=1)
    pts = (Twc[f, :3, :3] @ local[:, :, None])[:, :, 0] + Twc[f, :3, 3]

    tex = _smooth(uniform(20.0, 255.0, (n, TEX, TEX), torch.float32), 3, (1, 2))
    lo = tex.amin(dim=(1, 2), keepdim=True)
    ptp = (tex.amax(dim=(1, 2), keepdim=True) - lo).clamp(min=1e-3)
    tex = 20.0 + (tex - lo) * (235.0 / ptp)
    sizes = torch.randint(6, 14, (n,), generator=gen, device=dev)
    bg = _smooth(uniform(25.0, 70.0, (32, 32), torch.float32), 2, (0, 1))
    Tcw = np.linalg.inv(Twc[:n_frames].cpu().numpy()).astype(np.float32)
    return {"pts": pts, "tex": tex.to(torch.float64), "sizes": sizes, "background": bg.to(torch.float64),
            "Tcw": Tcw}


def render(w: dict, cam: dict, Tcw: np.ndarray, right_shift: float = 0.0, noise=None):
    """One grayscale uint8 view (H, W) and its z-buffer depth (metres, f32;
    0 on the background) on the device. `cam` holds fx, fy, cx, cy, width,
    height; `right_shift` moves the camera that many metres along its +x
    (the right view of a stereo pair); `noise` (sigma, generator) adds
    N(0, sigma) grey levels to every pixel before it is quantized."""
    dev = w["pts"].device
    H, W = int(cam["height"]), int(cam["width"])
    T = torch.as_tensor(Tcw, dtype=torch.float64, device=dev)
    pc = w["pts"] @ T[:3, :3].T + T[:3, 3]
    x = pc[:, 0] - right_shift
    z = pc[:, 2]
    zs = torch.where(z == 0, torch.full_like(z, 1e-300), z)
    u = cam["fx"] * x / zs + cam["cx"]
    v = cam["fy"] * pc[:, 1] / zs + cam["cy"]

    # The background: the 32 x 32 field, bilinear over the image.
    gy = torch.linspace(0, 31, H, dtype=torch.float64, device=dev)
    gx = torch.linspace(0, 31, W, dtype=torch.float64, device=dev)
    y0b, x0b = torch.floor(gy).long(), torch.floor(gx).long()
    y1b, x1b = torch.clamp(y0b + 1, max=31), torch.clamp(x0b + 1, max=31)
    wyb, wxb = (gy - y0b)[:, None], (gx - x0b)[None, :]
    B = w["background"]
    img = (B[y0b][:, x0b] * (1 - wyb) * (1 - wxb) + B[y1b][:, x0b] * wyb * (1 - wxb)
           + B[y0b][:, x1b] * (1 - wyb) * wxb + B[y1b][:, x1b] * wyb * wxb)
    depth = torch.zeros((H, W), dtype=torch.float32, device=dev)

    ok = (z > 0.5) & (u > 4) & (u < W - 4) & (v > 4) & (v < H - 4)
    vis = torch.nonzero(ok)[:, 0]
    idx = vis[torch.argsort(-z[vis], stable=True)]  # paint order: far to near
    if idx.numel() == 0:
        return torch.clamp(img, 0, 255).to(torch.uint8), depth
    ui, vi = u[idx].long(), v[idx].long()
    s = torch.clamp(torch.round(w["sizes"][idx] * 6.0 / torch.clamp(z[idx], min=1.0)).long(), min=1)
    y0, y1 = torch.clamp(vi - s, min=0), torch.clamp(vi + s + 1, max=H)
    x0, x1 = torch.clamp(ui - s, min=0), torch.clamp(ui + s + 1, max=W)
    hs, ws = y1 - y0, x1 - x0
    counts = hs * ws
    rank = torch.repeat_interleave(torch.arange(idx.numel(), device=dev), counts)
    start = torch.cumsum(counts, 0) - counts
    off = torch.arange(rank.numel(), device=dev) - start[rank]
    pix = (y0[rank] + off // ws[rank]) * W + x0[rank] + off % ws[rank]
    # Each pixel takes the last blob painted over it: the nearest.
    owner = torch.full((H * W,), -1, dtype=torch.int64, device=dev).scatter_reduce(0, pix, rank, "amax")
    owned = torch.nonzero(owner >= 0)[:, 0]
    k = owner[owned]
    ys, xs = owned // W, owned % W
    span = torch.clamp(2 * s[k] + 1, min=1).to(torch.float64)
    fy = ((ys - y0[k]).to(torch.float64) + 0.5) * TEX / span - 0.5
    fx = ((xs - x0[k]).to(torch.float64) + 0.5) * TEX / span - 0.5
    y0i = torch.clamp(torch.floor(fy).long(), 0, TEX - 1)
    x0i = torch.clamp(torch.floor(fx).long(), 0, TEX - 1)
    y1i, x1i = torch.clamp(y0i + 1, max=TEX - 1), torch.clamp(x0i + 1, max=TEX - 1)
    wy, wx = torch.clamp(fy - y0i, 0, 1), torch.clamp(fx - x0i, 0, 1)
    t, b = w["tex"], idx[k]
    img[ys, xs] = (t[b, y0i, x0i] * (1 - wy) * (1 - wx) + t[b, y1i, x0i] * wy * (1 - wx)
                   + t[b, y0i, x1i] * (1 - wy) * wx + t[b, y1i, x1i] * wy * wx)
    depth[ys, xs] = z[b].to(torch.float32)
    if noise is not None:
        sigma, gen = noise
        img = img + sigma * torch.randn(img.shape, generator=gen, device=dev, dtype=img.dtype)
    return torch.clamp(img, 0, 255).to(torch.uint8), depth


def render_sequence(w: dict, cam: dict, sensor: str, n_frames: int, sigma: float, seed: int) -> list:
    """Every frame of the sequence, rendered on the device with the sensor
    noise of `seed` (N(0, `sigma`) grey levels a pixel, every image its
    own draw) and copied to the host as a reader hands decoded images over:
    stereo, (left uint8, right uint8); RGB-D, (gray uint8, depth uint16 at
    depth_map_factor, clipped to 65535 as the repository's TUM writer
    stores it)."""
    gen = torch.Generator(device=w["pts"].device)
    gen.manual_seed(int(seed))
    noise = (float(sigma), gen)
    out = []
    for i in range(n_frames):
        img, depth = render(w, cam, w["Tcw"][i], noise=noise)
        if sensor == "stereo":
            right, _ = render(w, cam, w["Tcw"][i], right_shift=cam["bf"] / cam["fx"], noise=noise)
            out.append((img, right))
        else:
            raw = torch.clamp(depth * cam["depth_map_factor"], 0, 65535).to(torch.int32)
            out.append((img, raw))
    host = []
    for a, b in out:
        b = b.cpu().numpy()
        host.append((a.cpu().numpy(), b.astype(np.uint16) if b.dtype == np.int32 else b))
    return host
