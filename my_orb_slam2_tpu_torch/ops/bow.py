"""Bag-of-words vocabularies, query path (counterpart of
my_orb_slam2_tpu/ops/bow.py: `LshVocabulary`, `TreeVocabulary`,
`_lsh_words`, `_tree_words`).

A vocabulary maps (N, 8) packed descriptors (int32 words holding the
reference's uint32 bits) to (N,) int64 word ids:

- `LshVocabulary`: word id = `n_bits` fixed random descriptor bits, drawn
  from numpy's `default_rng(seed)` as the reference draws them;
- `TreeVocabulary`: the k-ary Hamming tree, descended `depth` times by
  XOR + popcount against each node's children and an argmin (first index
  on ties in both frameworks); a leaf stays put.

The popcount runs on the words widened to int64 and masked to their low 32
bits, so the sign of the int32 view never enters the count. Training
(`train_tree_vocabulary`) and the dense scoring helpers are not ported:
nothing on the system path calls them.
"""

from __future__ import annotations

import numpy as np
import torch

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 or int64 input) as int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


class LshVocabulary:
    """Word id = concatenation of `n_bits` fixed random descriptor bits."""

    def __init__(self, n_bits: int = 16, seed: int = 123, device="cpu"):
        assert n_bits <= 24
        self.n_bits = n_bits
        self.n_words = 1 << n_bits
        rng = np.random.default_rng(seed)
        bit_idx = rng.choice(256, size=n_bits, replace=False)
        self.word_word = torch.tensor(bit_idx // 32, dtype=torch.int64, device=device)
        self.word_bit = torch.tensor(bit_idx % 32, dtype=torch.int32, device=device)

    def words(self, desc: torch.Tensor) -> torch.Tensor:
        """(N, 8) int32 packed descriptors -> (N,) int64 word ids."""
        return _lsh_words(desc, self.word_word, self.word_bit, self.n_bits)


class TreeVocabulary:
    """k-ary Hamming tree: descend by argmin distance to node centers.

    centers (n_nodes, 8) int32 words; children (n_nodes, k) int64 (-1 =
    none); leaf word id = position among the leaves. Arrays may be given as
    numpy (uint32 centers) and are moved to `device`."""

    def __init__(self, centers, children, leaf_word, k: int, depth: int, device="cpu"):
        c = np.ascontiguousarray(np.asarray(centers).astype(np.uint32, copy=False)).view(np.int32)
        self.centers = torch.tensor(c, device=device)
        self.children = torch.tensor(np.asarray(children), dtype=torch.int64, device=device)
        self.leaf_word = torch.tensor(np.asarray(leaf_word), dtype=torch.int64, device=device)
        self.k = k
        self.depth = depth
        self.n_words = int(np.asarray(leaf_word).max()) + 1

    def pack(self):
        """(centers, children, leaf_word): the tables `_tree_words` takes."""
        return self.centers, self.children, self.leaf_word

    def words(self, desc: torch.Tensor) -> torch.Tensor:
        return _tree_words(desc, self.centers, self.children, self.leaf_word, self.depth)


def _lsh_words(desc, word_word, word_bit, n_bits: int):
    sel = desc[:, word_word]  # (N, n_bits)
    bits = ((sel >> word_bit[None, :]) & 1).to(torch.int64)
    weights = torch.ones(n_bits, dtype=torch.int64, device=desc.device) << torch.arange(
        n_bits, dtype=torch.int64, device=desc.device
    )
    return (bits * weights[None, :]).sum(dim=1)


def _tree_words(desc, centers, children, leaf_word, depth: int):
    """Batched tree descent: `depth` rounds of an (N, k, 8) XOR + popcount
    against the current node's children."""
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    big = torch.iinfo(torch.int64).max
    for _ in range(depth):
        ch = children[node]  # (N, k)
        cent = centers[torch.clamp(ch, min=0)]  # (N, k, 8); -1 gathers the last row in JAX, masked below
        d = popcount32(torch.bitwise_xor(desc[:, None, :], cent)).sum(dim=-1)
        d = torch.where(ch >= 0, d, big)
        best = torch.argmin(d, dim=1)
        nxt = torch.gather(ch, 1, best[:, None])[:, 0]
        node = torch.where(nxt >= 0, nxt, node)  # stay if leaf
    return leaf_word[node]
