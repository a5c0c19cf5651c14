"""Vocabulary files (counterpart of my_orb_slam2_tpu/utils/vocab_io.py):
the DBoW2 text format and the packed npz.

- DBoW2 text (the reference's ORBvoc.txt; TemplatedVocabulary::
  loadFromTextFile / saveToTextFile): a header line `k L scoring
  weighting`, then one line per non-root node in BFS order, `parent_id
  is_leaf d0 .. d31 weight` with the 32 descriptor bytes.
  `load_dbow2_text` packs it into the TreeVocabulary arrays (centres,
  children, leaf word ids); `save_dbow2_text` writes one.
- Packed npz (`save_packed` / `load_packed`): centres as uint32, children
  and leaf words as int32, k and depth; the arrays and dtypes the
  reference writes, so each package loads the other's files.

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


def _tree_arrays(voc: TreeVocabulary):
    """(centres (n, 8) uint32, children (n, k) int32, leaf words (n,) int32)."""
    centers = np.ascontiguousarray(voc.centers.cpu().numpy()).view(np.uint32)
    return centers, voc.children.cpu().numpy().astype(np.int32), voc.leaf_word.cpu().numpy().astype(np.int32)


def save_packed(voc: TreeVocabulary, path: str):
    centers, children, leaf_word = _tree_arrays(voc)
    np.savez_compressed(path, centers=centers, children=children, leaf_word=leaf_word, k=voc.k, depth=voc.depth)


def load_dbow2_text(path: str, device="cuda") -> TreeVocabulary:
    """A DBoW2 text vocabulary as a TreeVocabulary: node ids 1..n in file
    order (0 is the implicit root), each parent's first k children kept,
    leaf words numbered in node order."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, descs = [], []
        for line in f:
            p = line.split()
            if len(p) < 34:
                continue
            parents.append(int(p[0]))
            descs.append([int(x) for x in p[2:34]])
    n = len(parents)
    n_nodes = n + 1
    centers = np.zeros((n_nodes, 8), np.uint32)
    centers[1:] = np.asarray(descs, np.uint8).view("<u4").reshape(n, 8)
    children = np.full((n_nodes, k), -1, np.int32)
    child_count = np.zeros(n_nodes, np.int32)
    for i, p in enumerate(parents):
        if child_count[p] < k:
            children[p, child_count[p]] = i + 1
            child_count[p] += 1
    leaf_word = np.zeros(n_nodes, np.int32)
    leaves = np.nonzero(child_count == 0)[0]
    leaf_word[leaves] = np.arange(len(leaves))
    return TreeVocabulary(centers, children, leaf_word, k, L, device=device)


def save_dbow2_text(voc: TreeVocabulary, path: str):
    """Write a TreeVocabulary in the DBoW2 text format: every non-root
    node in BFS (array) order with its parent, leaf flag, 32 descriptor
    bytes and weight 1.0. Round-trips through `load_dbow2_text`."""
    centers, children, _ = _tree_arrays(voc)
    n_nodes = centers.shape[0]
    parent = np.zeros(n_nodes, np.int32)
    for nid in range(n_nodes):
        kids = children[nid]
        parent[kids[kids >= 0]] = nid
    is_leaf = (children.max(axis=1) < 0).astype(int)
    byte_view = centers.view("<u1").reshape(n_nodes, 32)
    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.depth} 0 0\n")
        for nid in range(1, n_nodes):
            d = " ".join(str(int(b)) for b in byte_view[nid])
            f.write(f"{parent[nid]} {is_leaf[nid]} {d} 1.0\n")


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
