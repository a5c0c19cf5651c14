"""ORB feature extraction on torch tensors (counterpart of
my_orb_slam2_tpu/ops/frontend.py).

Same pipeline and geometry as the reference: all pyramid levels are packed
into one atlas (levels stacked with reflected-border gaps), FAST + 3x3 NMS
runs once over the whole atlas (`ops/fast_nms.py`: the CUDA kernel on the
card, the plain version on the CPU), per-cell top-m and per-level top-quota
select keypoints, and one raw-patch gather feeds both the IC-angle moments
and the blur-folded rotated-BRIEF matmul.

Where PyTorch and XLA differ, the port follows the reference explicitly:

- A stereo pair is extracted with one FAST+NMS call over both atlases
  (`extract_batch`); a single image with `forward`.
- Resize: `jax.image.resize(method="linear")` antialiases when it
  downsamples (a triangle kernel widened by 1/scale). The port rebuilds
  those separable weights in numpy with the same float32 formula and applies
  them as two matmuls. `F.interpolate(antialias=False)` would differ by up
  to 134 gray levels. Summation order differs, so atlases agree to a
  tolerance (see tests/test_torch_frontend.py), not bit for bit.
- top_k: every `jax.lax.top_k` is a stable descending sort, which keeps the
  lower index first on ties, as top_k does (torch.topk does not).
- dynamic_slice wraps a negative start index once and clamps it to
  [0, dim - size]; the patch and window gathers compute their starts the
  same way (`slice_start`).
- Descriptors are (K, 8) int32 words holding the reference's uint32 bits
  (torch has no shifts on uint32).
- BRIEF: the reference multiplies bf16 patches by a bf16 table with f32
  accumulation. The port rounds both operands to bf16 and multiplies them in
  f32 (each product is exact), so only the summation order differs; a bit
  flips only where a sum is within rounding of 0.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from my_orb_slam2_tpu_torch.ops.fast_nms import FAST_RING, fast_nms, fast_score_map, nms3x3  # noqa: F401
from my_orb_slam2_tpu_torch.utils.config import OrbConfig

EDGE = 19  # detection margin: all patch gathers stay inside the level
GAP = 8  # atlas inter-level gap (> blur radius + SAD slide margin bleed)


def _brief_pattern(seed: int = 42, n_bits: int = 256, radius: int = 13) -> np.ndarray:
    """Deterministic BRIEF sampling pattern (the reference's numpy code):
    pairs ~ N(0, (patch/5)^2), clipped to `radius`. int32 (n_bits, 4)."""
    rng = np.random.default_rng(seed)
    sigma = 31 / 5.0
    pts = rng.normal(0.0, sigma, size=(n_bits, 4))
    pts = np.clip(np.round(pts), -radius, radius).astype(np.int32)
    same = (pts[:, 0] == pts[:, 2]) & (pts[:, 1] == pts[:, 3])
    pts[same, 2] += 1
    return pts


def _gauss_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 weights of jax.image.resize's linear
    (triangle) kernel with antialiasing, computed with the same float32
    formula as jax._src.image.scale.compute_weight_mat (scale = out/in,
    translation 0)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    ).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, f32(0.0)).astype(f32)
    return np.ascontiguousarray(w.T)


def topk_stable(x: torch.Tensor, k: int):
    """jax.lax.top_k over the last axis: values descending, lower index
    first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def slice_start(start: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """Start index of lax.dynamic_slice: a negative start counts from the
    end, then the start is clamped to [0, dim - size] so the window stays
    inside the array."""
    start = torch.where(start < 0, start + dim, start)
    return torch.clamp(start, 0, dim - size)


def jnp_mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """jnp.mod for floats: fmod, then shifted into the divisor's sign."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


class LevelSpec(NamedTuple):
    h: int
    w: int
    scale: float  # multiply level coords by this to get level-0 coords
    n_cells_y: int
    n_cells_x: int
    quota: int  # number of keypoints retained at this level
    atlas_off: int  # row offset of this level inside the atlas


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (padded; `valid` masks live entries)."""

    uv: torch.Tensor  # (K, 2) float32, level-0 pixel coords (x, y)
    uv_level: torch.Tensor  # (K, 2) float32, own-level pixel coords
    response: torch.Tensor  # (K,)
    octave: torch.Tensor  # (K,) int64
    angle: torch.Tensor  # (K,) float32 radians
    desc: torch.Tensor  # (K, 8) int32 words holding 256-bit BRIEF
    valid: torch.Tensor  # (K,) bool


class OrbExtractor(nn.Module):
    """ORB extractor for one image size. The BRIEF pattern, the blur-folded
    BRIEF table `desc_D`, the moment matrix `moment_M`, the resize weights
    and the level tables are buffers, built on `device`.

    Usage: ex = OrbExtractor(cfg, height, width, device=dev)
           kps, atlas = ex(image)
    """

    def __init__(self, cfg: OrbConfig, height: int, width: int, cell: int | None = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.cfg = cfg
        self.h0, self.w0 = height, width
        self.cell = cell or cfg.cell_size
        s = cfg.scale_factor
        inv = 1.0 / s
        total = (1.0 - inv ** cfg.n_levels) / (1.0 - inv)
        per0 = cfg.n_features / total
        quotas = [int(round(per0 * inv ** l)) for l in range(cfg.n_levels)]
        quotas[-1] = max(cfg.n_features - sum(quotas[:-1]), 8)
        self.levels = []
        off = GAP
        for l in range(cfg.n_levels):
            sc = s ** l
            h = int(round(height / sc))
            w = int(round(width / sc))
            self.levels.append(
                LevelSpec(
                    h=h, w=w, scale=sc,
                    n_cells_y=max(1, math.ceil(h / self.cell)),
                    n_cells_x=max(1, math.ceil(w / self.cell)),
                    quota=quotas[l], atlas_off=off,
                )
            )
            off += h + GAP
        self.atlas_h = ((off + 7) // 8) * 8
        self.atlas_w = width + 2 * GAP
        self.capacity = ((sum(q.quota for q in self.levels) + 127) // 128) * 128
        self.register_buffer("pattern", torch.as_tensor(_brief_pattern()))
        # One raw (PATCH, PATCH) slice per keypoint serves both the moments
        # (circle radius 15) and the rotated, blur-folded BRIEF samples:
        # pattern radius 13 * sqrt2 (-> 18) + blur radius 3 = 21.
        self.PATCH_R = 21
        self.PATCH = 2 * self.PATCH_R + 2  # 44
        P2 = self.PATCH * self.PATCH
        r = cfg.half_patch_size
        yy, xx = np.mgrid[-r : r + 1, -r : r + 1]
        circ = (xx * xx + yy * yy) <= r * r
        M = np.zeros((P2, 2), np.float32)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if circ[dy + r, dx + r]:
                    f = (dy + self.PATCH_R) * self.PATCH + (dx + self.PATCH_R)
                    M[f, 0] = dx
                    M[f, 1] = dy
        self.register_buffer("moment_M", torch.as_tensor(M))
        # Blur-folded BRIEF-as-matmul: bit_j = (raw_patch @ D[:, a*256+j]) > 0.
        self.N_ANGLE_BINS = 64
        pat = _brief_pattern().astype(np.float64)
        k1d = _gauss_kernel_1d(7, 2.0).astype(np.float64)
        blur2d = np.outer(k1d, k1d)  # (7, 7)
        D = np.zeros((P2, self.N_ANGLE_BINS * 256), np.float32)
        cols = np.arange(256)
        for a in range(self.N_ANGLE_BINS):
            th = 2.0 * np.pi * a / self.N_ANGLE_BINS
            ca, sa = np.cos(th), np.sin(th)
            x1 = np.round(pat[:, 0] * ca - pat[:, 1] * sa).astype(int)
            y1 = np.round(pat[:, 0] * sa + pat[:, 1] * ca).astype(int)
            x2 = np.round(pat[:, 2] * ca - pat[:, 3] * sa).astype(int)
            y2 = np.round(pat[:, 2] * sa + pat[:, 3] * ca).astype(int)
            for dy in range(-3, 4):
                for dx in range(-3, 4):
                    wgt = blur2d[dy + 3, dx + 3]
                    f1 = (y1 + dy + self.PATCH_R) * self.PATCH + (x1 + dx + self.PATCH_R)
                    f2 = (y2 + dy + self.PATCH_R) * self.PATCH + (x2 + dx + self.PATCH_R)
                    np.add.at(D, (f2, a * 256 + cols), wgt)
                    np.add.at(D, (f1, a * 256 + cols), -wgt)
        # The reference stores D in bf16; keep the same bf16-rounded values
        # in f32 so the product below is an f32 matmul of bf16 operands.
        self.register_buffer("desc_D", torch.as_tensor(D).to(torch.bfloat16).to(torch.float32))
        for l, spec in enumerate(self.levels):
            if l:
                self.register_buffer(f"resize_y{l}", torch.as_tensor(resize_weights(height, spec.h)))
                self.register_buffer(f"resize_x{l}", torch.as_tensor(resize_weights(width, spec.w)))
        self.register_buffer("scale_factors", torch.tensor([lv.scale for lv in self.levels], dtype=torch.float32))
        self.register_buffer("level_offsets", torch.tensor([lv.atlas_off for lv in self.levels], dtype=torch.int64))
        self.register_buffer("level_h", torch.tensor([lv.h for lv in self.levels], dtype=torch.int64))
        self.register_buffer("level_w", torch.tensor([lv.w for lv in self.levels], dtype=torch.int64))
        self.to(device)

    # -- atlas -------------------------------------------------------------

    def _resize(self, img: torch.Tensor, level: int) -> torch.Tensor:
        wy = getattr(self, f"resize_y{level}")
        wx = getattr(self, f"resize_x{level}")
        return (wy @ img) @ wx.T

    def build_atlas(self, img: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        """Pyramid levels stacked into one canvas with 3px reflected borders
        written into the gaps. Each level resizes directly from level 0.
        With `out` (an (atlas_h, atlas_w) f32 tensor, e.g. one slice of a
        batch), the canvas is written there and returned."""
        if out is None:
            atlas = img.new_zeros((self.atlas_h, self.atlas_w))
        else:
            atlas = out.zero_()
        G = GAP
        for l, spec in enumerate(self.levels):
            cur = img if l == 0 else self._resize(img, l)
            o, h, w = spec.atlas_off, spec.h, spec.w
            atlas[o : o + h, G : G + w] = cur
            atlas[o - 3 : o, G : G + w] = cur[1:4].flip(0)
            atlas[o + h : o + h + 3, G : G + w] = cur[-4:-1].flip(0)
            atlas[o : o + h, G - 3 : G] = cur[:, 1:4].flip(1)
            atlas[o : o + h, G + w : G + w + 3] = cur[:, -4:-1].flip(1)
        return atlas

    # -- per level detection ----------------------------------------------

    def _detect_level(self, score_atlas, spec: LevelSpec, per_cell: int = 4):
        """Per-cell top-m + global top-quota on one level of the NMS'd FAST
        score atlas. Returns (xy (q, 2) int64 level coords, resp, valid)."""
        dev = score_atlas.device
        h, w = spec.h, spec.w
        score = score_atlas[spec.atlas_off : spec.atlas_off + h, GAP : GAP + w]
        ys = torch.arange(h, device=dev)[:, None]
        xs = torch.arange(w, device=dev)[None, :]
        ok = (ys >= EDGE) & (ys < h - EDGE) & (xs >= EDGE) & (xs < w - EDGE)
        score = torch.where(ok, score, torch.zeros_like(score))
        Hc, Wc, c = spec.n_cells_y, spec.n_cells_x, self.cell
        sp = score.new_zeros((Hc * c, Wc * c))
        sp[:h, :w] = score
        cells = sp.reshape(Hc, c, Wc, c).permute(0, 2, 1, 3).reshape(Hc * Wc, c * c)
        vals, idx = topk_stable(cells, per_cell)
        cell_id = torch.arange(Hc * Wc, device=dev)[:, None]
        y = ((cell_id // Wc) * c + idx // c).reshape(-1)
        x = ((cell_id % Wc) * c + idx % c).reshape(-1)
        vals = vals.reshape(-1)
        q = min(spec.quota, vals.shape[0])
        top_vals, top_i = topk_stable(vals, q)
        xy = torch.stack([x[top_i], y[top_i]], dim=1)
        return xy, top_vals, top_vals > 0.0

    # -- keypoint-level ops on the atlas ----------------------------------

    def _gather_patches(self, atlas, ax, ay):
        """(K, PATCH*PATCH) patch slices around atlas coords, with the start
        indices of lax.dynamic_slice (`slice_start`)."""
        P, R = self.PATCH, self.PATCH_R
        H, W = atlas.shape
        ar = torch.arange(P, device=atlas.device)
        rows = slice_start(ay - R, H, P)[:, None] + ar
        cols = slice_start(ax - R, W, P)[:, None] + ar
        return atlas[rows[:, :, None], cols[:, None, :]].reshape(ax.shape[0], P * P)

    def _orientation_from_patches(self, patches_flat):
        """IC_Angle via moment matmul: (K,) angles in radians."""
        m = patches_flat @ self.moment_M  # (K, 2) = (m10, m01)
        return torch.atan2(m[:, 1], m[:, 0])

    def _descriptors_from_patches(self, patches_flat, angle):
        """Rotated BRIEF as one matmul over all angle bins + per-keypoint bin
        selection; packed to (K, 8) int32 words."""
        K = patches_flat.shape[0]
        A = self.N_ANGLE_BINS
        two_pi = 2.0 * math.pi
        ang = jnp_mod(angle, two_pi)
        bin_ = torch.round(ang * (A / two_pi)).to(torch.int64) % A
        patches_bf = patches_flat.to(torch.bfloat16).to(torch.float32)
        diffs = patches_bf @ self.desc_D  # (K, A*256)
        sel = torch.gather(diffs.reshape(K, A, 256), 1, bin_[:, None, None].expand(K, 1, 256))[:, 0]
        return pack_bits(sel > 0)

    # -- whole image -------------------------------------------------------

    def fast_scores(self, atlas: torch.Tensor) -> torch.Tensor:
        """FAST V-score + 3x3 NMS over one atlas or a (B, H, W) batch of
        them, in one call (one kernel launch on the card)."""
        return fast_nms(atlas, float(self.cfg.min_th_fast), self.cfg.fast_arc)

    def extract_batch(self, images) -> list:
        """ORB extraction of several (H, W) images with one FAST+NMS call:
        the atlases are built into one (B, atlas_h, atlas_w) buffer, then
        each image is detected and described on its own. Returns
        [(Keypoints, atlas)] in input order, each equal to `forward`'s."""
        imgs = [im.to(torch.float32) for im in images]
        atlases = imgs[0].new_empty((len(imgs), self.atlas_h, self.atlas_w))
        for img, out in zip(imgs, atlases):
            self.build_atlas(img, out=out)
        scores = self.fast_scores(atlases)
        return [(self.detect_and_describe(a, s), a) for a, s in zip(atlases, scores)]

    def detect_and_describe(self, atlas: torch.Tensor, score_atlas: torch.Tensor) -> Keypoints:
        """Keypoints of one image from its atlas and its NMS'd FAST score
        atlas: per-level selection, orientation and rotated BRIEF."""
        xs, ys, resps, octs, valids = [], [], [], [], []
        for l, spec in enumerate(self.levels):
            xy, resp, valid = self._detect_level(score_atlas, spec)
            xs.append(xy[:, 0])
            ys.append(xy[:, 1])
            resps.append(resp)
            octs.append(torch.full((xy.shape[0],), l, dtype=torch.int64, device=atlas.device))
            valids.append(valid)
        x = torch.cat(xs)
        y = torch.cat(ys)
        resp = torch.cat(resps)
        octv = torch.cat(octs)
        valid = torch.cat(valids)

        ax = x + GAP
        ay = y + self.level_offsets[octv]
        raw_patches = self._gather_patches(atlas, ax, ay)
        ang = self._orientation_from_patches(raw_patches)
        desc = self._descriptors_from_patches(raw_patches, ang)
        sc = self.scale_factors[octv]
        uv0 = torch.stack([x.to(torch.float32) * sc, y.to(torch.float32) * sc], dim=1)
        uv_level = torch.stack([x, y], dim=1).to(torch.float32)

        pad = self.capacity - uv0.shape[0]
        if pad > 0:
            def padded(t):
                return torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])

            uv0, uv_level, resp, octv, ang, desc, valid = map(
                padded, (uv0, uv_level, resp, octv, ang, desc, valid)
            )
        return Keypoints(
            uv=uv0, uv_level=uv_level, response=resp, octave=octv,
            angle=ang, desc=desc, valid=valid,
        )

    def forward(self, image):
        """image: (H, W) grayscale in [0, 255] (any real dtype).
        Returns (Keypoints, atlas)."""
        atlas = self.build_atlas(image.to(torch.float32))
        return self.detect_and_describe(atlas, self.fast_scores(atlas)), atlas


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, 256) bool -> (K, 8) int32 words, bit j of word i = bits[:, 32i+j]
    (the reference's uint32 packing, reinterpreted as int32)."""
    K = bits.shape[0]
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(K, 8, 32).to(torch.int64) << shifts).sum(dim=2)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


_PM1_BYTE_TABLES = {}


def unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    """Unpack (..., N, 8) int32 descriptor words to (..., N, 256) float32
    in {-1, +1}: one gather of each byte's 8 signs from a (256, 8) table.
    The bytes of a word are read little-endian (x86 and CUDA), so byte b of
    word i holds bits 8b..8b+7 of that word, in the packing's order."""
    table = _PM1_BYTE_TABLES.get(desc.device)
    if table is None:
        byte = torch.arange(256, dtype=torch.int32, device=desc.device)
        bits = (byte[:, None] >> torch.arange(8, dtype=torch.int32, device=desc.device)) & 1
        table = _PM1_BYTE_TABLES[desc.device] = bits.to(torch.float32) * 2.0 - 1.0
    byte_ids = desc.to(torch.int32).contiguous().view(torch.uint8).to(torch.int64)
    return table[byte_ids].reshape(desc.shape[:-1] + (256,))


def hamming_distance(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances (..., N, M) int32 between packed
    descriptors (leading batch dims broadcast), as (256 - s1 . s2) / 2 over
    {-1, +1} vectors. The f32 matmul of +-1 entries is exact (integers below
    2^24, TF32 off)."""
    s1 = unpack_pm1(desc1)
    s2 = s1 if desc2 is desc1 else unpack_pm1(desc2)
    return ((256.0 - s1 @ s2.transpose(-1, -2)) * 0.5).to(torch.int32)
