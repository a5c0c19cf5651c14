"""Process groups for the sharded solvers: the port's stand-in for a
`jax.sharding.Mesh` plus `lax.psum`.

A `Group` holds the rank, the world size, the rank's device and the
backend, all explicit. `init_group` starts a torch.distributed process
group with the backend the caller names and never chooses one itself:
NCCL on CUDA tensors, gloo on CPU or CUDA tensors. A rank's CUDA device
is `cuda:{rank % device_count}`, so one NCCL rank per card on a 4-card
machine and several gloo ranks on one card run the same code. NCCL
refuses two ranks on one device ("duplicate GPU"), so `init_group`
raises for NCCL with more ranks than cards; it never switches to gloo.
Several ranks on one card test correctness and the cost of the
collectives, not scaling.

`local_group` is a lone rank without a process group: its collectives
are the identity, and the solvers run the same code as on a real group.

Collectives:
- `psum(x)`: `all_reduce(SUM)` on a copy of `x`;
- `all_gather_rows(x)`: every rank's equal-sized block of rows, in rank
  order, on every rank. Built from `all_reduce` over a zero-filled buffer
  (each element has one non-zero term, so the result is exact), because
  torch.distributed's gloo backend offers `all_reduce` and `broadcast` on
  CUDA tensors but not `all_gather`.
Each all-reduce adds one to `n_all_reduce` and its bytes to
`all_reduce_bytes`.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
TIMEOUT_S = 300.0  # a collective that waits longer than this raises on every rank


def rank_device(device, rank: int) -> torch.device:
    """The device of `rank`: the CPU, or `cuda:{rank % device_count}`.
    Raises when CUDA is asked for and there is no card."""
    kind = torch.device(device).type
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"a rank runs on 'cpu' or 'cuda', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank was asked for, but torch.cuda.is_available() is False")
    return torch.device(f"cuda:{rank % torch.cuda.device_count()}")


def check_world(backend: str, world: int, device) -> None:
    """Raise for a (backend, world, device) that cannot run: an unknown
    backend, NCCL on the CPU or without CUDA, NCCL with more ranks than
    cards."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if world < 1:
        raise ValueError(f"world size must be >= 1, got {world}")
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise ValueError("NCCL reduces CUDA tensors only; use gloo for CPU ranks")
    if not torch.cuda.is_available():
        raise RuntimeError("NCCL needs CUDA, and torch.cuda.is_available() is False")
    n_cards = torch.cuda.device_count()
    if world > n_cards:
        raise RuntimeError(
            f"NCCL needs one card per rank: {world} ranks on {n_cards} card(s) would put two ranks on one "
            "device, which NCCL refuses (duplicate GPU); run gloo ranks to share a card"
        )


class Group:
    """One rank of a process group (or a lone rank with `backend=None`)."""

    def __init__(self, rank: int, world: int, device, backend: str | None):
        if backend is None and world != 1:
            raise ValueError("a group without a backend has exactly one rank")
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.backend = backend
        self.n_all_reduce = 0
        self.all_reduce_bytes = 0

    def _all_reduce(self, buf: torch.Tensor) -> torch.Tensor:
        if self.backend is not None:
            dist.all_reduce(buf, op=dist.ReduceOp.SUM)
            self.n_all_reduce += 1
            self.all_reduce_bytes += buf.numel() * buf.element_size()
        return buf

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of `x` over the ranks (a new tensor)."""
        return self._all_reduce(x.clone(memory_format=torch.contiguous_format))

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(world * n, ...) from every rank's (n, ...) block, rank r's block
        at rows [r * n, (r + 1) * n). Bool blocks travel as uint8."""
        n = x.shape[0]
        wire = torch.uint8 if x.dtype == torch.bool else x.dtype
        buf = torch.zeros((self.world * n,) + tuple(x.shape[1:]), dtype=wire, device=x.device)
        buf[self.rank * n : (self.rank + 1) * n] = x
        out = self._all_reduce(buf)
        return out.to(torch.bool) if x.dtype == torch.bool else out

    def close(self) -> None:
        """Tear down the process group (a lone rank has none)."""
        if self.backend is not None and dist.is_initialized():
            dist.destroy_process_group()


def init_group(backend: str, rank: int, world: int, init_method: str, device="cuda") -> Group:
    """Join a process group as `rank` of `world` through `init_method`
    (`file:///path`, a FileStore that must not exist yet, or
    `tcp://localhost:PORT`). The backend is the caller's; this raises
    rather than change it."""
    check_world(backend, world, device)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    return Group(rank, world, dev, backend)


def local_group(device="cuda") -> Group:
    """A lone rank on `device` with identity collectives."""
    return Group(0, 1, rank_device(device, 0), None)
