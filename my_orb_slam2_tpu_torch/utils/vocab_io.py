"""Packed vocabulary loading (counterpart of the query half of
my_orb_slam2_tpu/utils/vocab_io.py: `load_packed`, `default_vocabulary`).

The port reads the vocabularies the JAX package ships,
`my_orb_slam2_tpu/assets/orbvoc_k10_L{5,4}.npz`, by path: it never imports
that package (whose modules import jax) and keeps no copy of the assets.
"""

from __future__ import annotations

import os

import numpy as np

from my_orb_slam2_tpu_torch.ops.bow import LshVocabulary, TreeVocabulary

_ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "my_orb_slam2_tpu", "assets",
)
# The 100k-word k=10 / L=5 tree (place recognition) and the 10k-word
# k=10 / L=4 tree (the word gate's quantizer and the fallback).
DEFAULT_ASSET = os.path.join(_ASSET_DIR, "orbvoc_k10_L5.npz")
FALLBACK_ASSET = os.path.join(_ASSET_DIR, "orbvoc_k10_L4.npz")


def load_packed(path: str, device="cuda") -> TreeVocabulary:
    d = np.load(path)
    return TreeVocabulary(d["centers"], d["children"], d["leaf_word"], int(d["k"]), int(d["depth"]), device=device)


def default_vocabulary(device="cuda"):
    """The default place-recognition vocabulary, resolved in the
    reference's order: $SLAM_VOCAB (packed npz path) -> the packed
    100k-word k10_L5 asset -> the packed 10k-word k10_L4 asset -> the
    training-free 14-bit LSH vocabulary."""
    override = os.environ.get("SLAM_VOCAB", "")
    if override and os.path.exists(override):
        return load_packed(override, device)
    if os.path.exists(DEFAULT_ASSET):
        return load_packed(DEFAULT_ASSET, device)
    if os.path.exists(FALLBACK_ASSET):
        return load_packed(FALLBACK_ASSET, device)
    return LshVocabulary(n_bits=14, device=device)
