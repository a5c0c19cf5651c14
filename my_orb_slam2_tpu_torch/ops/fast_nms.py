"""Fused FAST-9/16 V-score + 3x3 NMS: the CUDA kernel, its plain PyTorch
version, and the wrapper that chooses by the tensor's device.

Counterpart of my_orb_slam2_tpu/ops/fast_pallas.py (`fast_nms_pallas`) and
of the XLA formulation `frontend.fast_score_map` + `frontend.nms3x3`.

- `fast_score_map` / `nms3x3` are the plain version, written exactly like
  the reference (16 rolled copies, log-step arc minimum, reduce-window max).
  Subtraction, min, max and compares are exact in f32, so they are
  bit-identical to the JAX functions on the same input.
- `compass_candidates` is the kernel's exact early-rejection rule as a
  plain function, for the tests and for counting the operations a given
  image needs; nothing on the card's path calls it.
- `fast_nms` takes the plain version only for a tensor on the CPU. For a
  CUDA tensor it launches the hand-written kernel `csrc/fast_nms.cu` or
  raises; there is no fallback. A (B, H, W) batch is one launch (the
  stereo front-end's L+R pair). Every launch adds one to
  `fast_nms.launches`.
- The kernel is a shared library with a plain C interface, built with nvcc
  for sm_90a at first use into `<package>/build/` and loaded with ctypes.
  The library name carries a hash of the source, so an edited source is
  rebuilt; `build` / `_launch` take another source with the same C
  interface, to time an earlier kernel beside the current one
  (`python -m my_orb_slam2_tpu_torch.time_fast_nms --against OLD.cu`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

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

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fast_nms.cu"
BUILD_DIR = _PKG / "build"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-ldl",
)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


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


def compass_candidates(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """The kernel's exact early-rejection rule over (..., H, W) image(s):
    False where a pixel's V-score cannot exceed `threshold`.

    A score above the threshold needs 9 consecutive ring diffs all
    > threshold (bright) or all < -threshold (dark), and every 9 consecutive
    entries of the 16 hold two cyclically adjacent compass entries (0, 4,
    8, 12). So a pixel passes only if (d0 or d8) and (d4 or d12) exceed the
    threshold, or the same holds below -threshold. A pixel that passes has
    at least 2 compass diffs beyond the threshold on one side, so the rule
    is at least as strict as "2 of the 4". The 3-pixel border never passes.
    A plain helper for the tests and the bound; the kernel applies the rule
    itself."""
    h, w = img.shape[-2:]
    d = torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(-2, -1)) for dy, dx in FAST_RING[[0, 4, 8, 12]]]
    ) - img[None]  # compass diffs N, E, S, W
    up, down = d > threshold, d < -threshold
    cand = ((up[0] | up[2]) & (up[1] | up[3])) | ((down[0] | down[2]) & (down[1] | down[3]))
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    return cand & (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)


def work(img: torch.Tensor, threshold: float) -> dict:
    """What FAST+NMS must do on this input, for its bound: each pixel read
    once and written once, and the operations its data needs. Per pixel:
    the compass test (6 min/max, 2 subtractions, 2 compares) and the NMS's
    test of the score (1 compare); per compass candidate: one arc (55
    min/max, 1 subtraction, 1 compare); per non-zero score: the 3x3 max and
    its compare (9)."""
    n = img.numel()
    candidates = int(compass_candidates(img, threshold).sum())
    corners = int((fast_score_map(img, threshold) > 0).sum())
    return {
        "bytes": 2 * n * img.element_size(),
        "ops": 11 * n + 57 * candidates + 9 * corners,
        "pixels": n, "candidates": candidates, "corners": corners,
    }


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep pixels that are the max of their 3x3 neighbourhood. max_pool2d
    pads with -inf, exactly like the reference's reduce_window."""
    lead = score.shape[:-2]
    s4 = score.reshape((-1, 1) + score.shape[-2:])
    neigh = F.max_pool2d(s4, 3, stride=1, padding=1).reshape(lead + score.shape[-2:])
    return torch.where(score >= neigh, score, torch.zeros_like(score))


# ---------------------------------------------------------------------------
# Kernel build and launch
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found: the FAST+NMS CUDA kernel cannot be built")


def library_path(source: Path = SOURCE) -> Path:
    tag = hashlib.sha256(Path(source).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libfast_nms_{tag}.so"


def build(source: Path = SOURCE) -> dict:
    """Compile `source` (default `csrc/fast_nms.cu`) if no library for its
    current hash exists. Returns {"path", "seconds", "log"}; "log" holds
    nvcc's -Xptxas -v report (registers, shared memory, spills) of a fresh
    build."""
    so = library_path(source)
    log_path = so.with_suffix(".log")
    if so.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(so), "seconds": 0.0, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    log = res.stdout + res.stderr
    log_path.write_text(log)
    return {"path": str(so), "seconds": seconds, "log": log}


@functools.cache
def _load(source: Path = SOURCE) -> ctypes.CDLL:
    lib = ctypes.CDLL(build(source)["path"])
    fn = lib.fast_nms_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _launch(img: torch.Tensor, threshold: float, arc: int, source: Path = SOURCE) -> torch.Tensor:
    """Launch the kernel built from `source` on a CUDA (H, W) or (B, H, W)
    f32 tensor, on the current stream. Raises on anything the kernel does
    not take or on a refused launch."""
    if img.device.type != "cuda":
        raise ValueError(f"the FAST+NMS kernel needs a CUDA tensor, got {img.device}")
    if img.dtype != torch.float32 or img.dim() not in (2, 3):
        raise ValueError(f"the FAST+NMS kernel takes (H, W) or (B, H, W) float32, got {img.dtype} {tuple(img.shape)}")
    if arc != 9:
        raise ValueError(f"the FAST+NMS kernel is built for the 9-of-16 arc, got arc={arc}")
    img = img.contiguous()
    out = torch.empty_like(img)
    batch = 1 if img.dim() == 2 else img.shape[0]
    h, w = img.shape[-2:]
    lib = _load(source)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.fast_nms_f32(
            img.data_ptr(), out.data_ptr(), batch, h, w, float(threshold), int(arc), stream
        )
    if err != 0:
        raise RuntimeError(f"fast_nms_f32 launch failed with CUDA error {err}")
    return out


def fast_nms(img: torch.Tensor, threshold: float, arc: int = 9) -> torch.Tensor:
    """Dense FAST V-score + 3x3 NMS. CPU tensors take the plain version;
    CUDA tensors launch the kernel (counted in `fast_nms.launches`)."""
    if img.device.type == "cpu":
        return nms3x3(fast_score_map(img, threshold, arc))
    out = _launch(img, threshold, arc)
    fast_nms.launches += 1
    return out


fast_nms.launches = 0
