"""Fixed-order float segment sums: the CUDA kernel, its plain PyTorch
version, and the wrapper that chooses by the tensor's device.

The Gauss-Newton solvers (`ops/ba.bundle_adjust`, `ops/pose_graph`, their
`parallel/` twins) reduce per-observation blocks onto cameras, points and
keyframes: `zeros(n).at[idx].add(vals)` in the reference, deterministic on
every backend. `index_add_` adds with atomics on CUDA, so its float sums
change in the last bits from run to run there, and a whole drive with them.

- `segments(n, idx, live)` is a sum's layout, built once per solve (the
  indices do not change within one): the rows sorted by segment, stable
  (`order`), and each segment's start (`offsets`, n + 1), from a stable
  argsort and a searchsorted on the device, with no host sync. Rows
  outside `live` are left out of the layout: the solvers pass their
  observation or edge mask, whose masked rows carry a zero weight and so
  add an exact zero to every sum (a solve's padding, all at index 0, would
  otherwise make one serial segment of up to the whole padding). Adding
  +0.0 changes a sum only in the sign of a zero result. `csr` builds the
  layout on any device; `segments` builds it only for a CUDA index (the
  plain version needs none).
- `segment_sum(seg, vals)` sums the (rows, ...) `vals` into (n, ...). On
  the CPU it is the plain version, `index_add_`, which adds the rows in
  order. On a CUDA tensor it launches `csrc/segment_sum.cu`, which sums
  each (segment, component) sequentially in the rows' order, so the card
  gives the CPU's bits on the same input, and the same bits on every run.
  The kernel has two routes, chosen from shapes alone (`route`): long
  segments (at least `LONG_MIN_MEAN` rows a segment on average, rows of at
  most `LONG_MAX_K` components: a camera's observations) take one block a
  segment, its rows staged in shared memory, the longest segments first
  (the layout's `longest_first`); short ones (a point's observations, a
  keyframe's edges) one thread a (segment, component). No tensor value is
  read on the host, so a solve stays free of syncs and capturable in a
  CUDA graph. A build or launch failure raises; nothing falls back to
  `index_add_`. Every launch adds one to `segment_sum.launches`, and a
  long-route launch also to `segment_sum.long_launches`.
- Integer counters (`index_add_` of ints, `add_drop`) are exact in any
  order and do not come here; neither do `amax` / `amin` scatters.

The kernel is built with nvcc for sm_90a at first use into `<package>/build/`
(`ops/fast_nms.build`) and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from my_orb_slam2_tpu_torch.ops import fast_nms

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "segment_sum.cu"


# The long route takes rows of at most LONG_MAX_K components (one thread
# each, in at most half of a block of 256) when the segments hold at least
# LONG_MIN_MEAN rows on average: below that a block a segment costs more in
# round trips than it saves (the pose graph's 4 rows a keyframe, the
# points' 1).
LONG_MIN_MEAN = 16
LONG_MAX_K = 128


class Segments(NamedTuple):
    """A segment sum's layout: `n` segments, the row -> segment index, and
    on CUDA the CSR order and offsets of the live rows and the long route's
    block order (all three None on the CPU)."""

    n: int
    idx: torch.Tensor  # (rows,) int64
    order: Optional[torch.Tensor]  # (rows,) int64: rows sorted by segment, stable
    offsets: Optional[torch.Tensor]  # (n + 1,) int64: segment s is order[offsets[s]:offsets[s + 1]]
    # (n,) int64: segments by length, descending, stable; the long route
    # stops at the first empty one
    longest_first: Optional[torch.Tensor]


def route(rows: int, n: int, k: int) -> str:
    """"long" (a block a segment) or "short" (a thread a (segment,
    component)) for `rows` rows of `k` components into `n` segments."""
    return "long" if 1 <= k <= LONG_MAX_K and rows >= LONG_MIN_MEAN * n else "short"


def csr(n: int, idx: torch.Tensor, live: Optional[torch.Tensor] = None):
    """(order, offsets) of the rows of each segment in [0, n): a stable
    argsort and a searchsorted, on idx's device, no host sync. Rows outside
    `live` sort after segment n - 1, beyond offsets[n]."""
    key = idx if live is None else torch.where(live.reshape(-1), idx, n)
    order = torch.argsort(key, stable=True)
    bounds = torch.arange(n + 1, dtype=idx.dtype, device=idx.device)
    return order, torch.searchsorted(key[order], bounds)


def longest_first(offsets: torch.Tensor) -> torch.Tensor:
    """The segments of a CSR layout by length, longest first, ties in
    segment order (a stable argsort on offsets' device, no host sync)."""
    return torch.argsort(offsets[:-1] - offsets[1:], stable=True)


def segments(n: int, idx: torch.Tensor, live: Optional[torch.Tensor] = None) -> Segments:
    """The layout of sums of rows into `n` segments by `idx` (all in
    range). A CUDA index gets its CSR order of the `live` rows (all by
    default) and the long route's block order for the kernel; the rows
    outside `live` must add zeros."""
    idx = idx.reshape(-1).to(torch.int64)
    if idx.device.type == "cpu":
        return Segments(n, idx, None, None, None)
    order, offsets = csr(n, idx, live)
    return Segments(n, idx, order, offsets, longest_first(offsets))


def plain(seg: Segments, vals: torch.Tensor) -> torch.Tensor:
    """zeros(n).at[idx].add(vals) by `index_add_` (sequential on the CPU,
    atomic on CUDA)."""
    out = torch.zeros((seg.n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg.idx, vals)


def work(rows: int, k: int, n: int) -> dict:
    """What a sum of `rows` live rows (a layout's offsets[n]; the masked
    rows are never read) of `k` f32 components into `n` segments must move
    and do: each value and its segment index (int64) read once, each output
    written once; one add a value."""
    return {"bytes": rows * k * 4 + rows * 8 + n * k * 4, "ops": rows * k}


@functools.cache
def _load(source: Path = SOURCE) -> ctypes.CDLL:
    """The library built from `source`, with the argument types of its
    entries: `segment_sum_f32` (the short route) and, where the source has
    it (an earlier source may not), `segment_sum_long_f32`."""
    lib = ctypes.CDLL(fast_nms.build(source)["path"])
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.segment_sum_f32.argtypes = [ptr, ptr, ptr, ptr, i64, i32, ptr]
    lib.segment_sum_f32.restype = i32
    if hasattr(lib, "segment_sum_long_f32"):
        lib.segment_sum_long_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, ptr]
        lib.segment_sum_long_f32.restype = i32
    return lib


def build() -> dict:
    """Compile `csrc/segment_sum.cu` if needed ({"path", "seconds", "log"})."""
    return fast_nms.build(SOURCE)


def _checked(seg: Segments, vals: torch.Tensor):
    """(contiguous vals, k, an empty output) for a launch; raises on
    anything the kernel does not take."""
    if vals.device.type != "cuda" or seg.order is None or seg.order.device != vals.device:
        raise ValueError(f"the segment-sum kernel needs CUDA values and a CUDA layout, got {vals.device}")
    if vals.dtype != torch.float32:
        raise ValueError(f"the segment-sum kernel takes float32, got {vals.dtype}")
    if vals.shape[0] != seg.idx.shape[0]:
        raise ValueError(f"{vals.shape[0]} rows against a layout of {seg.idx.shape[0]}")
    k = math.prod(vals.shape[1:])
    vals = vals.contiguous()
    return vals, k, torch.empty((seg.n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)


def _call(entry: str, source: Path, vals: torch.Tensor, *args) -> None:
    lib = _load(source)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = getattr(lib, entry)(vals.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {err}")


def _launch_short(seg: Segments, vals: torch.Tensor, source: Path = SOURCE) -> torch.Tensor:
    """The short route (a thread a (segment, component)) on CUDA f32 `vals`
    (rows, ...), on the current stream."""
    vals, k, out = _checked(seg, vals)
    _call("segment_sum_f32", source, vals, seg.order.data_ptr(), seg.offsets.data_ptr(), out.data_ptr(), seg.n, k)
    return out


def _launch_long(seg: Segments, vals: torch.Tensor) -> torch.Tensor:
    """The long route (a block a segment, longest first) on CUDA f32 `vals`
    (rows, ...) of at most LONG_MAX_K components, on the current stream."""
    vals, k, out = _checked(seg, vals)
    if not 1 <= k <= LONG_MAX_K or vals.shape[0] >= 2**31:
        raise ValueError(f"the long route takes 1..{LONG_MAX_K} components and < 2^31 rows; got k={k}, "
                         f"{vals.shape[0]} rows")
    _call("segment_sum_long_f32", SOURCE, vals, seg.order.data_ptr(), seg.offsets.data_ptr(),
          seg.longest_first.data_ptr(), out.data_ptr(), seg.n, k)
    return out


def _launch(seg: Segments, vals: torch.Tensor) -> torch.Tensor:
    """Launch the kernel's route for this shape (`route`) on CUDA f32
    `vals` (rows, ...) with a CUDA layout, on the current stream. Raises on
    anything the kernel does not take or on a refused launch."""
    if route(vals.shape[0], seg.n, math.prod(vals.shape[1:])) == "long":
        return _launch_long(seg, vals)
    return _launch_short(seg, vals)


def segment_sum(seg: Segments, vals: torch.Tensor) -> torch.Tensor:
    """Sum the rows of `vals` into seg.n segments. CPU tensors take the
    plain version; CUDA tensors launch the kernel (counted in
    `segment_sum.launches`)."""
    if vals.device.type == "cpu":
        return plain(seg, vals)
    out = _launch(seg, vals)
    segment_sum.launches += 1
    segment_sum.long_launches += route(vals.shape[0], seg.n, math.prod(vals.shape[1:])) == "long"
    return out


segment_sum.launches = 0
segment_sum.long_launches = 0
