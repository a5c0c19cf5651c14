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
bits, so the sign of the int32 view never enters the count.

Training (`train_tree_vocabulary`, the offline path of `make_vocab.py`) is
the reference's level-batched k-medians on the tensor's device: every node
of a level trains at once, each iteration one (N, k) XOR + popcount
distance against each descriptor's group centres, an argmin (first index
on ties, as `jnp.argmin`), a segmented bit count by `index_add_` (integer
counts in f32, exact in any order, so the atomics on the card change
nothing) and a bitwise majority that keeps the old centre where a
subcluster is empty. The initial centres are drawn on the host from
`np.random.default_rng(seed)` exactly as the reference draws them, so the
tree is bit-identical to the reference's on the same corpus, on the card
and on the CPU. `bow_counts` and `l1_scores_against_all` are the
reference's dense scoring helpers.
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

    def __init__(self, n_bits: int = 16, seed: int = 123, device="cuda"):
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

    def __init__(self, centers, children, leaf_word, k: int, depth: int, device="cuda"):
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


def _bit_planes(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 words -> (N, 256) f32 bits, bit b of word w at 32 w + b."""
    shifts = torch.arange(32, dtype=torch.int64, device=desc.device)
    return ((desc.to(torch.int64)[:, :, None] >> shifts) & 1).reshape(desc.shape[0], 256).to(torch.float32)


def _pack_planes(maj: torch.Tensor) -> torch.Tensor:
    """(M, 256) bool majority bits -> (M, 8) int32 words (inverse of
    `_bit_planes`)."""
    shifts = torch.arange(32, dtype=torch.int64, device=maj.device)
    words = (maj.reshape(-1, 8, 32).to(torch.int64) << shifts).sum(dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def _kmedians_level(desc, bits, group, centers, n_groups: int, k: int):
    """One k-medians iteration for every group of a level. group: (N,)
    int64 node of each descriptor; centers: (n_groups, k, 8) int32.
    Returns (assign (N,), new centers)."""
    d = popcount32(torch.bitwise_xor(desc[:, None, :], centers[group])).sum(dim=-1)  # (N, k)
    assign = torch.argmin(d, dim=1)
    flat = group * k + assign
    sums = torch.zeros(n_groups * k, 256, dtype=torch.float32, device=desc.device).index_add_(0, flat, bits)
    cnt = torch.zeros(n_groups * k, dtype=torch.float32, device=desc.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.float32))
    new = _pack_planes(sums * 2 > cnt[:, None]).reshape(n_groups, k, 8)
    empty = (cnt == 0).reshape(n_groups, k)
    return assign, torch.where(empty[:, :, None], centers, new)


def train_tree_vocabulary(desc_corpus, k: int = 8, depth: int = 3, iters: int = 8, seed: int = 0,
                          device="cuda") -> TreeVocabulary:
    """Hierarchical k-medians over packed binary descriptors (the DBoW2
    training replacement), level-batched on `device`. desc_corpus: (N, 8)
    uint32 words (numpy) or int32 words (tensor)."""
    rng = np.random.default_rng(seed)
    if isinstance(desc_corpus, torch.Tensor):
        desc_np = np.ascontiguousarray(desc_corpus.cpu().numpy().astype(np.int32, copy=False)).view(np.uint32)
    else:
        desc_np = np.ascontiguousarray(np.asarray(desc_corpus).astype(np.uint32, copy=False))
    N = desc_np.shape[0]
    desc = torch.tensor(desc_np.view(np.int32), device=device)
    bits = _bit_planes(desc)

    group = np.zeros(N, np.int64)  # node of each descriptor at this level
    level_centers = []
    n_groups = 1
    for _ in range(depth):
        # Initial centres: k members of each group, drawn on the host.
        init = np.zeros((n_groups, k, 8), np.uint32)
        order = np.argsort(group, kind="stable")
        bounds = np.searchsorted(group[order], np.arange(n_groups + 1))
        for g in range(n_groups):
            members = order[bounds[g] : bounds[g + 1]]
            if len(members) == 0:
                init[g] = rng.integers(0, 2 ** 32, (k, 8), dtype=np.uint32)
            else:
                init[g] = desc_np[rng.choice(members, size=k, replace=len(members) < k)]
        centers = torch.tensor(init.view(np.int32), device=device)
        group_t = torch.tensor(group, device=device)
        for _ in range(iters):
            assign, centers = _kmedians_level(desc, bits, group_t, centers, n_groups, k)
        level_centers.append(centers.cpu().numpy().view(np.uint32))
        group = group * k + assign.cpu().numpy()
        n_groups *= k

    # The BFS-ordered node arrays: the root, then each level's k^(l+1) nodes.
    n_nodes = sum(k ** (l + 1) for l in range(depth)) + 1
    centers_arr = np.zeros((n_nodes, 8), np.uint32)
    child_arr = np.full((n_nodes, k), -1, np.int32)
    level_base = [0]
    base = 1
    for level in range(depth):
        level_base.append(base)
        base += k ** (level + 1)
    for level in range(depth):
        lb = level_base[level + 1]
        cl = level_centers[level].reshape(-1, 8)
        centers_arr[lb : lb + cl.shape[0]] = cl
        parents = level_base[level] + np.arange(k ** level)
        child_arr[parents] = lb + np.arange(k ** level)[:, None] * k + np.arange(k)[None, :]
    leaf_word = np.zeros(n_nodes, np.int32)
    lb = level_base[depth]
    leaf_word[lb:] = np.arange(n_nodes - lb)
    return TreeVocabulary(centers_arr, child_arr, leaf_word, k, depth, device=device)


# ---------------------------------------------------------------------------
# Dense BoW scoring
# ---------------------------------------------------------------------------


def bow_counts(words: torch.Tensor, valid: torch.Tensor, n_words: int) -> torch.Tensor:
    """(N,) word ids -> (n_words,) counts, wrapped to 16 bits as the
    reference's uint16 (int32 here: torch's uint16 has no comparisons)."""
    tgt = torch.where(valid, words, n_words)
    cnt = torch.zeros(n_words + 1, dtype=torch.int32, device=words.device).index_add_(
        0, tgt, torch.ones_like(tgt, dtype=torch.int32))
    return cnt[:n_words] & 0xFFFF


def l1_scores_against_all(query_words, query_valid, kf_bow, kf_l1, idf):
    """TF-IDF L1 similarity of a query frame against every keyframe, the
    DBoW2 L1 score s = sum_w min(v_hat_w, q_hat_w) over the query's
    distinct words (kf_bow (KF, n_words) counts, kf_l1 (KF,) the rows' L1
    norms, idf (n_words,)). Returns (scores (KF,) f32, shared words (KF,))."""
    n_words = idf.shape[0]
    f32 = torch.float32
    tgt = torch.where(query_valid, query_words, 0)
    q_cnt = torch.zeros(n_words, dtype=f32, device=idf.device).index_add_(0, tgt, query_valid.to(f32))
    q_l1 = (q_cnt * idf).sum()
    sorted_w = torch.sort(torch.where(query_valid, query_words, n_words - 1)).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=idf.device), sorted_w[1:] != sorted_w[:-1]])
    cols = torch.where(first, sorted_w, 0)
    col_mask = first & query_valid.any()
    kf_cols = kf_bow[:, cols].to(f32)
    kf_vals = kf_cols * idf[cols][None, :]
    q_vals = (q_cnt[cols] * idf[cols])[None, :]
    inter_norm = (torch.minimum(kf_vals / torch.clamp(kf_l1[:, None], min=1e-9), q_vals / torch.clamp(q_l1, min=1e-9))
                  * col_mask[None, :]).sum(dim=1)
    shared = ((kf_cols > 0) & (q_cnt[cols] > 0)[None, :] & col_mask[None, :]).sum(dim=1)
    return inter_norm, shared
