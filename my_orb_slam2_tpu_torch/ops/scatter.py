"""Scatter helpers that reproduce two jax `.at[]` semantics torch lacks.

- `set_last_wins`: `x.at[idx].set(vals)` with repeated indices. JAX on the
  CPU applies the writes in order, so the last one wins; `index_put_` with
  duplicates is undefined on CUDA. The helper picks, for each target, the
  largest source position (a scatter-amax of positions) and gathers its
  value, so the result is deterministic and equal to the reference's.
- `put_drop`: `x.at[idx].set(vals, mode="drop")`. Out-of-range rows go to
  one extra dummy row that is sliced off, so torch never sees an
  out-of-range index. The reference's sentinels are always >= len; a
  negative index, which JAX would wrap, is dropped here.
- `add_drop`: `x.at[idx].add(vals, mode="drop")`, the same way.
- `nonzero_static`: `jnp.nonzero(mask, size=size, fill_value=fill)[0]` as
  a stable argsort of the negated mask, padded with `fill`: no
  data-dependent shape, no host sync.
"""

from __future__ import annotations

import torch


def set_last_wins(target: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Return a copy of `target` with target[idx[i]] = vals[i] along dim 0,
    where the last i wins among repeated indices (all idx in range). Rows
    of a 2-D target take whole rows of `vals`."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    winner = torch.full(target.shape[:1], -1, dtype=pos.dtype, device=idx.device).scatter_reduce(
        0, idx, pos, "amax"
    )
    hit = (winner >= 0).reshape((-1,) + (1,) * (target.dim() - 1))
    return torch.where(hit, vals[torch.clamp(winner, min=0)].to(target.dtype), target)


def put_drop(target: torch.Tensor, idx: torch.Tensor, vals, cols=None) -> torch.Tensor:
    """Return target with target[idx] = vals (or target[idx, cols] = vals)
    where rows outside [0, len) are dropped. In-range rows must be unique."""
    n = target.shape[0]
    buf = torch.cat([target, target[:1]])
    rows = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    if cols is None:
        buf[rows] = vals
    else:
        buf[rows, cols] = vals
    return buf[:n]


def add_drop(target: torch.Tensor, idx, vals, cols=None) -> torch.Tensor:
    """Return target with vals added at target[idx] (or target[idx, cols]);
    rows outside [0, len) are dropped, repeated indices accumulate."""
    n = target.shape[0]
    buf = torch.cat([target, torch.zeros_like(target[:1])])
    rows = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    vals = torch.as_tensor(vals, dtype=target.dtype, device=target.device)
    # index_add_ (atomics) rather than index_put_(accumulate=True), whose
    # sort-based CUDA kernel took half the mapper's device time; the sums
    # are exact for the integer counters this serves.
    if cols is not None:
        rows = rows * target.shape[1] + cols
        buf = buf.reshape((-1,) + target.shape[2:])
    flat = rows.reshape(-1)
    buf.index_add_(0, flat, vals.expand(rows.shape + buf.shape[1:]).reshape((flat.shape[0],) + buf.shape[1:]))
    return buf.reshape((n + 1,) + target.shape[1:])[:n]


def nonzero_static(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Indices of the True entries of 1-D `mask` in order, the first `size`
    of them, padded with `fill` (size may exceed len(mask))."""
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    ok = mask[order]
    if size > order.shape[0]:
        pad = size - order.shape[0]
        order = torch.cat([order, order.new_full((pad,), fill)])
        ok = torch.cat([ok, ok.new_zeros(pad)])
    return torch.where(ok[:size], order[:size], torch.full_like(order[:size], fill))
