"""The global BA's PCG matvec: the Schur complement of the camera system
applied to a camera vector, fused into two CUDA kernels a step, with its
plain PyTorch version and the wrapper that chooses by the tensor's device.

`ops/ba.bundle_adjust`'s PCG branch solves S dx = b for the free cameras
with S = U_d - W V^-1 W^T over the flat observation rows, never forming S:

    S x = (U_d (x * free) - W V_inv W^T (x * free)) * free

- `plan(cam_seg, pt_seg)`, once a solve (the indices do not change within
  one): the two segment-sum layouts (`ops/segment_sum.segments`) and, on
  CUDA, each pass's int32 tables: the rows' other index in the pass's
  order (the camera of each row in point order, the point of each row in
  camera order), the offsets, the long route's longest-first order, and
  the route (`route`, from shapes alone).
- `schur(plan, Wo, V_inv, U_d, free_cam)`, once an LM iteration: on
  CUDA, Wo (O, 6, 3) permuted into each pass's row order, plane-major
  (18, O), so that the kernels read it coalesced; the scratch for y.
- `schur_matvec(op, x)`, each PCG step. CPU tensors take `plain`, which is
  the einsums, gathers and `segment_sum`s that the solver ran before the
  kernels. CUDA tensors launch `csrc/pcg_matvec.cu`'s two kernels in one
  call (a point pass, then a camera pass) or raise; nothing falls back.
  Each (segment, component) is summed in the rows' order without atomics,
  so two runs give the same bits; the per-row products are fused
  multiply-adds and round differently from the einsums. No tensor value is
  read on the host. Every call adds 2 to `schur_matvec.launches`.

The kernels are built with nvcc for sm_90a at first use into
`<package>/build/` (`ops/fast_nms.build`) and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from my_orb_slam2_tpu_torch.ops import fast_nms
from my_orb_slam2_tpu_torch.ops.segment_sum import LONG_MIN_MEAN, Segments, segment_sum

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "pcg_matvec.cu"


class Pass(NamedTuple):
    """One kernel's tables on CUDA: for each row in the pass's CSR order its
    other index, the offsets, the segments longest first (the long route
    only, else None) and the route."""

    nbr: torch.Tensor  # (O,) int32
    offsets: torch.Tensor  # (n + 1,) int32
    longest_first: Optional[torch.Tensor]  # (n,) int32
    long: bool


class Plan(NamedTuple):
    """A solve's layouts: the camera and point segment sums' (the plain
    version's), and on CUDA the two passes' tables (None on the CPU)."""

    cam_seg: Segments
    pt_seg: Segments
    points: Optional[Pass]
    cameras: Optional[Pass]


class Schur(NamedTuple):
    """S for one LM iteration: its operands and, on CUDA, Wo in each pass's
    order (18, O), the y scratch and the kernel's leading arguments (raw
    pointers into the tensors held here)."""

    plan: Plan
    Wo: torch.Tensor  # (O, 6, 3)
    V_inv: torch.Tensor  # (P, 3, 3)
    U_d: torch.Tensor  # (C, 6, 6)
    free_cam: torch.Tensor  # (C, 1)
    pt_w: Optional[torch.Tensor]
    cam_w: Optional[torch.Tensor]
    y: Optional[torch.Tensor]  # (P, 3)
    head: Optional[tuple]


def route(rows: int, n: int) -> str:
    """"long" (a block a segment) or "short" (a thread a segment) for a pass
    over `rows` rows into `n` segments: as `segment_sum.route`."""
    return "long" if rows >= LONG_MIN_MEAN * n else "short"


def plan(cam_seg: Segments, pt_seg: Segments) -> Plan:
    """The layouts of one solve from its camera and point segment-sum
    layouts (`segment_sum.segments` of obs_cam / obs_pt and the mask)."""
    if cam_seg.order is None:
        return Plan(cam_seg, pt_seg, None, None)
    rows = cam_seg.idx.shape[0]
    if max(rows, cam_seg.n, pt_seg.n) >= 2**31:
        raise ValueError(f"the PCG matvec kernels take < 2^31 rows and segments; got {rows} rows, "
                         f"{cam_seg.n} cameras, {pt_seg.n} points")

    def tables(seg: Segments, other: Segments) -> Pass:
        long = route(rows, seg.n) == "long"
        return Pass(other.idx[seg.order].to(torch.int32), seg.offsets.to(torch.int32),
                    seg.longest_first.to(torch.int32) if long else None, long)

    return Plan(cam_seg, pt_seg, tables(pt_seg, cam_seg), tables(cam_seg, pt_seg))


def schur(p: Plan, Wo: torch.Tensor, V_inv: torch.Tensor, U_d: torch.Tensor, free_cam: torch.Tensor) -> Schur:
    """S from one LM iteration's blocks: Wo (O, 6, 3), V_inv (P, 3, 3), U_d
    (C, 6, 6) and free_cam (C, 1), all f32. On CUDA it permutes Wo for the
    kernels; raises on what they do not take."""
    if p.points is None:
        return Schur(p, Wo, V_inv, U_d, free_cam, None, None, None, None)
    C, P, O = p.cam_seg.n, p.pt_seg.n, p.cam_seg.idx.shape[0]
    want = {"Wo": (Wo, (O, 6, 3)), "V_inv": (V_inv, (P, 3, 3)), "U_d": (U_d, (C, 6, 6)),
            "free_cam": (free_cam, (C, 1))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the plan needs {shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"the PCG matvec kernels take float32; {name} is {t.dtype}")
        if t.device != p.cam_seg.order.device:
            raise ValueError(f"{name} on {t.device}, the plan on {p.cam_seg.order.device}")
    V_inv, U_d, free_cam = V_inv.contiguous(), U_d.contiguous(), free_cam.contiguous()
    planes = Wo.reshape(O, 18).t()
    pt_w = torch.index_select(planes, 1, p.pt_seg.order)
    cam_w = torch.index_select(planes, 1, p.cam_seg.order)
    y = torch.empty(P, 3, dtype=torch.float32, device=Wo.device)
    a, b = p.points, p.cameras

    def first(t: Pass) -> int:
        return t.longest_first.data_ptr() if t.long else 0

    head = (pt_w.data_ptr(), a.nbr.data_ptr(), a.offsets.data_ptr(), first(a), P, int(a.long),
            cam_w.data_ptr(), b.nbr.data_ptr(), b.offsets.data_ptr(), first(b), C, int(b.long), O,
            free_cam.data_ptr(), V_inv.data_ptr(), U_d.data_ptr(), y.data_ptr())
    return Schur(p, Wo, V_inv, U_d, free_cam, pt_w, cam_w, y, head)


def plain(op: Schur, x: torch.Tensor) -> torch.Tensor:
    """S x by the einsums, gathers and segment sums (the CPU's path)."""
    p = op.plan
    x = x * op.free_cam
    y = segment_sum(p.pt_seg, torch.einsum("oij,oi->oj", op.Wo, x[p.cam_seg.idx]))
    y = torch.einsum("pij,pj->pi", op.V_inv, y)
    t2 = segment_sum(p.cam_seg, torch.einsum("oij,oj->oi", op.Wo, y[p.pt_seg.idx]))
    return (torch.einsum("cij,cj->ci", op.U_d, x) - t2) * op.free_cam


def work(rows: int, all_rows: int, n_cams: int, n_pts: int, live_pts: int, cg_iters: int) -> dict:
    """Bytes and f32 operations one matvec must take, over `rows` live rows
    of `all_rows`, `n_cams` camera and `n_pts` point segments of which
    `live_pts` hold a live row. Each input byte read once, each output byte
    written once: per pass, each live row's W (72 B) and int32 index; each
    segment's int32 offset, and the cameras' longest-first order; x,
    free_cam and U_d of every camera, out written; V_inv of the live
    points, y written and read back. The permutation of W into the two
    passes' orders (all rows: W read, the two int64 orders read, two copies
    written) is shared by the `cg_iters` steps of an LM iteration.
    Operations: 18 multiply-adds and 3 or 6 adds a row a pass, 9 / 36
    multiply-adds a live point / camera."""
    step = (2 * rows * (72 + 4) + 8 * n_cams + 4 * n_pts + n_cams * (24 + 4 + 144 + 24)
            + live_pts * (36 + 2 * 12))
    pack = all_rows * (72 + 2 * (8 + 72)) / cg_iters
    return {"bytes": step + pack, "ops": rows * (2 * 36 + 3 + 6) + live_pts * 18 + n_cams * 72}


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(fast_nms.build(SOURCE)["path"])
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.pcg_matvec_f32.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr, ptr, ptr, ptr, i32, i32, i64,
                                   ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.pcg_matvec_f32.restype = i32
    return lib


def _launch(op: Schur, x: torch.Tensor) -> torch.Tensor:
    """Both kernels on CUDA f32 x (C, 6) with an operand built on the card,
    on the current stream. Raises on anything the kernels do not take or on
    a refused launch."""
    C = op.plan.cam_seg.n
    if tuple(x.shape) != (C, 6):
        raise ValueError(f"x: shape {tuple(x.shape)}, S needs ({C}, 6)")
    if x.dtype != torch.float32:
        raise ValueError(f"the PCG matvec kernels take float32, got {x.dtype}")
    if x.device.type != "cuda" or op.head is None or op.y.device != x.device:
        raise ValueError(f"the PCG matvec kernels need CUDA x and an S built on it, got x on {x.device}")
    x = x.contiguous()
    out = torch.empty(C, 6, dtype=torch.float32, device=x.device)
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pcg_matvec_f32(*op.head, x.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pcg_matvec_f32 launch failed with CUDA error {err}")
    return out


def schur_matvec(op: Schur, x: torch.Tensor) -> torch.Tensor:
    """S x for a camera vector x (C, 6). CPU tensors take the plain version;
    CUDA tensors launch the two kernels (counted in
    `schur_matvec.launches`)."""
    if x.device.type == "cpu":
        return plain(op, x)
    out = _launch(op, x)
    schur_matvec.launches += 2
    return out


schur_matvec.launches = 0
