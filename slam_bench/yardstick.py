"""The frozen arithmetic of the roofline shares: the card's peaks and the
bytes each kernel's inputs need. Later changes to the program do not move
these numbers.

- Peaks: NVIDIA H100 SXM (80 GB HBM3), dense, at its 700 W limit (NVIDIA's
  data sheet): 3.35 TB/s of HBM and 67 TFLOP/s of f32 outside the tensor
  cores.
- FAST+NMS over a frame's image pyramids: each pixel of each level read
  once and each output score written once, f32: 2 x 4 bytes a pixel,
  counted over the levels' own sizes (`pyramid_pixels`: level l is the image
  scaled by 1 / scale^l and rounded), not over the
  rectangle the program packs them into. Its operations, at most
  77 a pixel (11 for the compass test and the NMS's compare, 57 for an arc,
  9 for the 3x3 max), take at most 77 / 67e12 s a pixel against 8 /
  3.35e12 s for its bytes, so the bytes bound it on every input.
- A fixed-order segment sum of `rows` live rows of `k` f32 components into
  `n` live segments (those that hold a live row): each value and its int64
  segment index read once, each live segment's output written once; one add
  a value (the bytes bound it).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float = 0.0) -> float:
    """The least time (s) of a kernel: the larger of its bytes over the
    memory rate and its f32 operations over the f32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def pyramid_pixels(height: int, width: int, n_levels: int, scale: float) -> int:
    """Pixels of an image pyramid: level l is round(height / scale^l) x
    round(width / scale^l)."""
    return sum(round(height / scale ** lvl) * round(width / scale ** lvl) for lvl in range(n_levels))


def fast_nms_bytes(batch: int, height: int, width: int, n_levels: int, scale: float) -> int:
    """Bytes FAST+NMS needs over `batch` pyramids of a height x width image,
    f32 in and out."""
    return 2 * 4 * batch * pyramid_pixels(height, width, n_levels, scale)


def segment_sum_bytes(rows: int, k: int, n: int) -> int:
    """Bytes a segment sum needs: rows x k values and rows int64 indices
    read, n x k sums written (n: the segments that hold a live row)."""
    return rows * k * 4 + rows * 8 + n * k * 4
