"""ORB extraction with the row-band stereo search and the RGB-D depth read,
plain: the pyramid as one atlas (antialiased linear resize, reflected
borders), FAST-9/16 V-scores and 3x3 non-maximum suppression by rolled
copies and a max-pool, per-cell top-4 and per-level top-quota selection
(ORB-SLAM2's 8 levels at 1.2 and its per-level feature quotas), IC angles
from patch moments, rotated BRIEF (a 256-pair pattern, 64 angle bins,
the Gaussian blur folded into the table), then for stereo a Hamming search
in the row band refined by an 11x11 SAD slide and a parabola, with the
median-SAD outlier cut.

`Extractor(orb, height, width, device)` builds every table from the
configuration; `stereo_frame(ex, left, right, camera)` and
`rgbd_frame(ex, image, depth, camera)` return a dict of the per-keypoint
fields the system's frames carry: uv, ur, depth, octave, angle, desc,
valid.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# FAST Bresenham circle of radius 3 (dy, dx), OpenCV 9_16 order.
FAST_RING = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


def fast_score_map(img: torch.Tensor, threshold: float, arc: int = 9) -> torch.Tensor:
    """Dense FAST-9/16 corner response over (..., H, W) image(s): 0 for
    non-corners, else the OpenCV V-score. The 3px border scores 0."""
    h, w = img.shape[-2:]
    ring = torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(-2, -1)) for dy, dx in FAST_RING]
    )  # (16, ..., H, W)
    diff = ring - img[None]

    def arc_max_min(d):
        m = d
        m = torch.minimum(m, torch.roll(m, -1, dims=0))  # window 2
        m = torch.minimum(m, torch.roll(m, -2, dims=0))  # window 4
        m = torch.minimum(m, torch.roll(m, -4, dims=0))  # window 8
        w9 = torch.minimum(m, torch.roll(d, -(arc - 1), dims=0))  # window 9
        return torch.amax(w9, dim=0)

    score = torch.maximum(arc_max_min(diff), arc_max_min(-diff))
    score = torch.where(score > threshold, score, torch.zeros_like(score))
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    interior = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return torch.where(interior, score, torch.zeros_like(score))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep pixels that are the max of their 3x3 neighbourhood. max_pool2d
    pads with -inf, exactly like the reference's reduce_window."""
    lead = score.shape[:-2]
    s4 = score.reshape((-1, 1) + score.shape[-2:])
    neigh = F.max_pool2d(s4, 3, stride=1, padding=1).reshape(lead + score.shape[-2:])
    return torch.where(score >= neigh, score, torch.zeros_like(score))



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


class Extractor:
    """ORB extractor for one image size. The BRIEF pattern, the blur-folded
    BRIEF table `desc_D`, the moment matrix `moment_M`, the resize weights
    and the level tables are buffers, built on `device`.

    Usage: ex = OrbExtractor(cfg, height, width, device=dev)
           kps, atlas = ex(image)
    """

    def __init__(self, cfg, height: int, width: int, cell: int | None = None,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
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
        self._buffer("pattern", torch.as_tensor(_brief_pattern()))
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
        self._buffer("moment_M", torch.as_tensor(M))
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
        self._buffer("desc_D", torch.as_tensor(D).to(torch.bfloat16).to(torch.float32))
        for l, spec in enumerate(self.levels):
            if l:
                self._buffer(f"resize_y{l}", torch.as_tensor(resize_weights(height, spec.h)))
                self._buffer(f"resize_x{l}", torch.as_tensor(resize_weights(width, spec.w)))
        self._buffer("scale_factors", torch.tensor([lv.scale for lv in self.levels], dtype=torch.float32))
        self._buffer("level_offsets", torch.tensor([lv.atlas_off for lv in self.levels], dtype=torch.int64))
        self._buffer("level_h", torch.tensor([lv.h for lv in self.levels], dtype=torch.int64))
        self._buffer("level_w", torch.tensor([lv.w for lv in self.levels], dtype=torch.int64))

    def _buffer(self, name: str, t: torch.Tensor):
        setattr(self, name, t.to(self.device))

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
        return nms3x3(fast_score_map(atlas, float(self.cfg.min_th_fast), self.cfg.fast_arc))

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

    def extract(self, image):
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


def unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    """Unpack (..., N, 8) int32 descriptor words to (..., N, 256) float32
    in {-1, +1}: one gather of each byte's 8 signs from a (256, 8) table.
    The bytes of a word are read little-endian (x86 and CUDA), so byte b of
    word i holds bits 8b..8b+7 of that word, in the packing's order."""
    byte = torch.arange(256, dtype=torch.int32, device=desc.device)
    bits = (byte[:, None] >> torch.arange(8, dtype=torch.int32, device=desc.device)) & 1
    table = bits.to(torch.float32) * 2.0 - 1.0
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


SAD_W = 5  # 11x11 window
SLIDE = 5  # +-5 sub-pixel search


def _windows(atlas, y0, x0, h: int, w: int):
    """(N, h, w) windows with top-left corners (y0, x0), with the start
    indices of lax.dynamic_slice."""
    H, W = atlas.shape
    dev = atlas.device
    rows = slice_start(y0, H, h)[:, None] + torch.arange(h, device=dev)
    cols = slice_start(x0, W, w)[:, None] + torch.arange(w, device=dev)
    return atlas[rows[:, :, None], cols[:, None, :]]


def _nanmedian_masked(x, ok):
    """jnp.nanmedian of where(ok, x, nan) over the last axis: the midpoint
    of the two middle entries among ok ones (nan when none)."""
    s, _ = torch.sort(torch.where(ok, x, torch.full_like(x, float("inf"))), dim=-1)
    n = ok.sum(-1, keepdim=True)
    lo = torch.clamp((n - 1) // 2, min=0)
    med = (s.gather(-1, lo) + s.gather(-1, n // 2))[..., 0] * 0.5
    return torch.where(n[..., 0] > 0, med, torch.full_like(med, float("nan")))


def match_stereo(
    kpL_uv, kpL_uv_level, kpL_octave, kpL_valid, kpR_uv, kpR_octave, kpR_valid,
    descL, descR, atlasL, atlasR, level_offsets, level_w, level_h, scale_factors,
    min_d, max_d, bf, th_desc: float = 75.0, col_offset: int = 0,
):
    """Row-band stereo correspondence for all left keypoints at once.
    Returns (u_right (N,), depth (N,)): -1 where unmatched."""
    dist = hamming_distance(descL, descR).to(torch.float32)  # (N, M)
    sf_L = scale_factors[kpL_octave]
    rL = 2.0 * sf_L
    dv = torch.abs(kpR_uv[None, :, 1] - kpL_uv[:, None, 1])
    band = dv <= rL[:, None]
    oct_ok = torch.abs(kpR_octave[None, :] - kpL_octave[:, None]) <= 1
    disp = kpL_uv[:, None, 0] - kpR_uv[None, :, 0]
    disp_ok = (disp >= min_d) & (disp <= max_d)
    valid = kpL_valid[:, None] & kpR_valid[None, :]
    mask = band & oct_ok & disp_ok & valid
    dist = torch.where(mask, dist, torch.full_like(dist, 1e9))
    best_r = torch.argmin(dist, dim=1)
    best_d = torch.gather(dist, 1, best_r[:, None])[:, 0]
    matched = best_d < th_desc

    # --- SAD sub-pixel refinement on the atlas ----------------------------
    u_r0 = kpR_uv[best_r, 0]
    inv_s = 1.0 / sf_L
    off = level_offsets[kpL_octave]
    wl = level_w[kpL_octave]
    hl = level_h[kpL_octave]
    mrg = SAD_W + SLIDE + 1

    def clamp_round(v, hi):
        r = torch.round(v).to(torch.int64)
        return torch.minimum(torch.clamp(r, min=mrg), hi - mrg - 1)

    uL = clamp_round(kpL_uv_level[:, 0], wl)
    vL = clamp_round(kpL_uv_level[:, 1], hl)
    u0 = clamp_round(u_r0 * inv_s, wl)

    W11 = 2 * SAD_W + 1
    ayL = vL + off
    winL = _windows(atlasL, ayL - SAD_W, uL + col_offset - SAD_W, W11, W11)  # (N, 11, 11)
    winL = winL - winL[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]
    wideR = _windows(atlasR, ayL - SAD_W, u0 + col_offset - SAD_W - SLIDE, W11, W11 + 2 * SLIDE)
    sads = []
    for s in range(2 * SLIDE + 1):
        winR = wideR[:, :, s : s + W11]
        winR = winR - winR[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]
        sads.append(torch.sum(torch.abs(winL - winR), dim=(1, 2)))
    sad = torch.stack(sads, dim=1)  # (N, 11)
    best = torch.argmin(sad, dim=1)
    bi = torch.clamp(best, 1, 2 * SLIDE - 1)
    s_m = torch.gather(sad, 1, (bi - 1)[:, None])[:, 0]
    s_0 = torch.gather(sad, 1, bi[:, None])[:, 0]
    s_p = torch.gather(sad, 1, (bi + 1)[:, None])[:, 0]
    denom = torch.clamp(2.0 * (s_m + s_p - 2.0 * s_0), min=1e-6)
    delta = torch.clamp((s_m - s_p) / denom, -1.0, 1.0)
    at_edge = (best == 0) | (best == 2 * SLIDE)
    u_best = u0.to(torch.float32) + (bi - SLIDE).to(torch.float32) + delta
    u_right = u_best * sf_L

    disp_final = kpL_uv[:, 0] - u_right
    ok = matched & ~at_edge & (disp_final >= min_d) & (disp_final < max_d)
    # Median SAD outlier cut: drop accepted matches above 1.5 * 1.4 * median.
    sad_best = torch.gather(sad, 1, best[:, None])[:, 0]
    thr = 1.5 * 1.4 * _nanmedian_masked(sad_best, ok)
    ok = ok & torch.where(torch.isfinite(thr), sad_best <= thr, torch.ones_like(ok))
    depth = torch.where(ok, bf / torch.clamp(disp_final, min=1e-6), torch.full_like(disp_final, -1.0))
    u_right = torch.where(ok, u_right, torch.full_like(u_right, -1.0))
    return u_right, depth


def depth_to_uright(kp_uv, kp_valid, depth_map, depth_factor, bf):
    """RGB-D: read depth at each keypoint, synthesize a virtual right u."""
    h, w = depth_map.shape
    x = torch.clamp(torch.round(kp_uv[:, 0]).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.round(kp_uv[:, 1]).to(torch.int64), 0, h - 1)
    # XLA folds the division by a constant into a product with its f32
    # reciprocal; the same product keeps the depths bit-equal.
    d = depth_map[y, x] * (1.0 / depth_factor)
    ok = (d > 0) & kp_valid
    u_right = torch.where(ok, kp_uv[:, 0] - bf / torch.clamp(d, min=1e-9), torch.full_like(d, -1.0))
    depth = torch.where(ok, d, torch.full_like(d, -1.0))
    return u_right, depth


def stereo_frame(ex: Extractor, left, right, cam) -> dict:
    """The per-keypoint fields of a stereo frame: both images extracted,
    the left keypoints matched along their row band in the right image.
    `cam` holds fx and bf."""
    (kl, al), (kr, ar) = ex.extract_batch([torch.as_tensor(left).to(ex.device), torch.as_tensor(right).to(ex.device)])
    ur, depth = match_stereo(kl.uv, kl.uv_level, kl.octave, kl.valid, kr.uv, kr.octave, kr.valid, kl.desc, kr.desc,
                             al, ar, ex.level_offsets, ex.level_w, ex.level_h, ex.scale_factors, min_d=0.0,
                             max_d=cam["fx"], bf=cam["bf"], col_offset=GAP)
    return {"uv": kl.uv, "ur": ur, "depth": depth, "octave": kl.octave, "angle": kl.angle, "desc": kl.desc,
            "valid": kl.valid}


def rgbd_frame(ex: Extractor, image, depth_raw, cam) -> dict:
    """The per-keypoint fields of an RGB-D frame: one image extracted, each
    keypoint's depth read from the raw depth map (metres = raw /
    depth_map_factor) and a virtual right u = u - bf / depth."""
    kp, _ = ex.extract(torch.as_tensor(image).to(ex.device))
    dmap = torch.as_tensor(np.asarray(depth_raw, np.float32)).to(ex.device)
    ur, depth = depth_to_uright(kp.uv, kp.valid, dmap, cam["depth_map_factor"], cam["bf"])
    return {"uv": kp.uv, "ur": ur, "depth": depth, "octave": kp.octave, "angle": kp.angle, "desc": kp.desc,
            "valid": kp.valid}
