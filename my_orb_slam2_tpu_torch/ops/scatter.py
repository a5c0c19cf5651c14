"""Scatter helpers that reproduce two jax `.at[]` semantics torch lacks.

- `set_last_wins`: `x.at[idx].set(vals)` with repeated indices. JAX on the
  CPU applies the writes in order, so the last one wins; `index_put_` with
  duplicates is undefined on CUDA. The helper picks, for each target, the
  largest source position (a scatter-amax of positions) and gathers its
  value, so the result is deterministic and equal to the reference's.
- `put_drop`: `x.at[idx].set(vals, mode="drop")`. Out-of-range rows go to
  one extra dummy row that is sliced off, so torch never sees an
  out-of-range index.
"""

from __future__ import annotations

import torch


def set_last_wins(target: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Return a copy of 1-D `target` with target[idx[i]] = vals[i], where
    the last i wins among repeated indices (all idx in range)."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    winner = torch.full(target.shape, -1, dtype=pos.dtype, device=idx.device).scatter_reduce(
        0, idx, pos, "amax"
    )
    hit = winner >= 0
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
