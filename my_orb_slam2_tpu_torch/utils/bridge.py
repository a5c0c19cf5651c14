"""Convert frames, map states and local-BA problems between numpy arrays
and the port's tensors, so the port can be put in exactly the state of the
JAX package.

The JAX `FrameData` / `MapState` hold the same fields under the same names;
`np.asarray` of each field gives the numpy side. Conversions keep the bits:
uint32 descriptor words are reinterpreted as int32 with `.view`, integer
fields widen to int64 (and narrow back to int32), floats stay float32.
Every tensor is a copy, so in-place updates in the port never write into
the caller's arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from my_orb_slam2_tpu_torch.models.frame import FrameData
from my_orb_slam2_tpu_torch.models.map_state import MapState
from my_orb_slam2_tpu_torch.ops.ba import DenseBAProblem

_DESC_FIELDS = {"desc", "mp_desc", "kf_desc"}


def _to_tensor(name: str, value, device) -> torch.Tensor:
    a = np.asarray(value)
    if name in _DESC_FIELDS:
        a = np.ascontiguousarray(a.astype(np.uint32, copy=False)).view(np.int32)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int64)
    elif a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if name in _DESC_FIELDS:
        return np.ascontiguousarray(a.astype(np.int32)).view(np.uint32)
    if a.dtype.kind in "iu":
        return a.astype(np.int32)
    return a


def _fields(obj, names):
    if isinstance(obj, dict):
        return {n: obj[n] for n in names}
    return {n: getattr(obj, n) for n in names}


def frame_from_numpy(frame, device) -> FrameData:
    """FrameData from any object (or dict) with the reference's frame fields."""
    return FrameData(**{n: _to_tensor(n, v, device) for n, v in _fields(frame, FrameData._fields).items()})


def frame_to_numpy(frame: FrameData) -> dict:
    return {n: _to_numpy(n, getattr(frame, n)) for n in FrameData._fields}


def map_state_from_numpy(state, device) -> MapState:
    """MapState from any object (or dict) with the reference's map fields."""
    return MapState(**{n: _to_tensor(n, v, device) for n, v in _fields(state, MapState._fields).items()})


def map_state_to_numpy(state: MapState) -> dict:
    """Numpy arrays in the reference's dtypes (int32, uint32 descriptors)."""
    return {n: _to_numpy(n, getattr(state, n)) for n in MapState._fields}


def ba_problem_from_numpy(prob, device) -> DenseBAProblem:
    """DenseBAProblem from any object (or dict) with the reference's fields."""
    return DenseBAProblem(**{n: _to_tensor(n, v, device) for n, v in _fields(prob, DenseBAProblem._fields).items()})


def ba_problem_to_numpy(prob: DenseBAProblem) -> dict:
    return {n: _to_numpy(n, getattr(prob, n)) for n in DenseBAProblem._fields}


def aux_from_numpy(aux: dict, device) -> dict:
    """The local-BA `aux` dict (index arrays and masks)."""
    return {n: _to_tensor(n, v, device) for n, v in aux.items()}


def aux_to_numpy(aux: dict) -> dict:
    return {n: _to_numpy(n, t) for n, t in aux.items()}
