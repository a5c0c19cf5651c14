"""Keyframe database: place-recognition queries over all keyframes on torch
tensors (counterpart of my_orb_slam2_tpu/models/keyframe_db.py).

The inverted file is a dense (KF, n_words) uint8 matrix of saturating word
counts on the device (205 MB at 2048 keyframes x 100k words). A query
gathers only its own words (at most MAX_QUERY_WORDS columns), so its cost
does not grow with the vocabulary. Each keyframe's L1 norm is frozen under
the idf of its insert. The candidate gates are the reference's: loop
candidates exclude every keyframe sharing a point with the query, need
shared words > 0.8 * max and a score >= the lowest covisible-neighbour
score, and are accumulated over covisibility groups (keyframe + top-10
covisible, groups above 0.75 * best); relocalization candidates skip the
exclusion and the floor.

In place: `add_keyframe` writes the keyframe's count row and `erase_mask`
zeroes the killed rows of the given database's `kf_bow` (the reference
donates the database to the same update); the small fields are new
tensors. `jax.lax.top_k` is `topk_stable`, `jnp.nonzero(size=)` is
`nonzero_static`, and the `.at[best_of_group].max` dedup is a
`scatter_reduce("amax")` that keeps the initial -1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from my_orb_slam2_tpu_torch.models import map_state as ms
from my_orb_slam2_tpu_torch.ops.frontend import topk_stable
from my_orb_slam2_tpu_torch.ops.scatter import nonzero_static

# A query carries at most its keypoint capacity of distinct words; every
# configuration uses <= 2048 keypoint slots a frame.
MAX_QUERY_WORDS = 2048


class KfDatabase(NamedTuple):
    kf_bow: torch.Tensor  # (KF, n_words) uint8 word counts (saturating)
    kf_valid: torch.Tensor  # (KF,) bool
    kf_l1: torch.Tensor  # (KF,) f32 L1 norm of the idf-weighted row at insert time
    df: torch.Tensor  # (n_words,) document frequency
    n_docs: torch.Tensor  # () documents
    n_words: torch.Tensor  # () vocabulary size


def init_db(max_kf: int, n_kp: int, n_words: int, device) -> KfDatabase:
    return KfDatabase(
        kf_bow=torch.zeros((max_kf, n_words), dtype=torch.uint8, device=device),
        kf_valid=torch.zeros(max_kf, dtype=torch.bool, device=device),
        kf_l1=torch.zeros(max_kf, dtype=torch.float32, device=device),
        df=torch.zeros(n_words, dtype=torch.int64, device=device),
        n_docs=torch.zeros((), dtype=torch.int64, device=device),
        n_words=torch.tensor(n_words, dtype=torch.int64, device=device),
    )


def _idf_from(df, n_docs):
    n = torch.clamp(n_docs, min=1).to(torch.float32)
    return torch.log(n / (df.to(torch.float32) + 1.0) + 1.0)


def idf_table(db: KfDatabase) -> torch.Tensor:
    """Running inverse document frequency."""
    return _idf_from(db.df, db.n_docs)


def _word_counts(words, valid, n_words: int):
    ok = valid & (words >= 0)
    tgt = torch.where(ok, words, n_words)
    return torch.zeros(n_words + 1, dtype=torch.int64, device=words.device).index_add_(
        0, tgt, torch.ones_like(tgt)
    )[:n_words], ok


def add_keyframe(db: KfDatabase, kf_id, words, valid) -> KfDatabase:
    """Insert keyframe `kf_id` (a host int or 0-dim tensor) with its
    keypoint words; its row of `db.kf_bow` is written in place."""
    n_words = db.df.shape[0]
    cnt, ok = _word_counts(words, valid, n_words)
    kf = torch.as_tensor(kf_id, dtype=torch.int64, device=words.device).reshape(1)
    db.kf_bow.index_copy_(0, kf, torch.clamp(cnt, max=255).to(torch.uint8)[None])
    df = db.df + (cnt > 0).to(torch.int64)
    n_docs = db.n_docs + 1
    # Row L1 under the idf as of this insert (df first, so the row's own
    # words count): gather only the row's words.
    idf = _idf_from(df, n_docs)
    l1 = (idf[torch.where(ok, words, 0)] * ok.to(torch.float32)).sum()
    return db._replace(
        kf_valid=db.kf_valid.index_fill(0, kf, True),
        kf_l1=db.kf_l1.index_copy(0, kf, torch.clamp(l1, min=1e-9).reshape(1)),
        df=df,
        n_docs=n_docs,
    )


def erase_mask(db: KfDatabase, kill: torch.Tensor) -> KfDatabase:
    """Batch-erase keyframes (the culling sync); the killed rows of
    `db.kf_bow` are zeroed in place."""
    kill = kill & db.kf_valid
    df_dec = ((db.kf_bow > 0) & kill[:, None]).sum(dim=0)
    db.kf_bow.masked_fill_(kill[:, None], 0)
    return db._replace(
        kf_valid=db.kf_valid & ~kill,
        kf_l1=torch.where(kill, 0.0, db.kf_l1),
        df=db.df - df_dec,
        n_docs=torch.clamp(db.n_docs - kill.sum(), min=0),
    )


def erase_keyframe(db: KfDatabase, kf_id) -> KfDatabase:
    kill = torch.zeros_like(db.kf_valid)
    kill[kf_id] = True
    return erase_mask(db, kill)


def _query_scores_from_counts(db: KfDatabase, q_cnt):
    """TF-IDF L1 similarity of a (W,)-count query against every keyframe,
    sum_w min(v_hat_w, q_hat_w) over the query's own words. Returns
    (scores (KF,), -1 where invalid; shared words (KF,))."""
    W = db.df.shape[0]
    n_q = min(MAX_QUERY_WORDS, W)
    idf = idf_table(db)
    qw = nonzero_static(q_cnt > 0, n_q, W)
    ok_w = qw < W
    qwc = torch.clamp(qw, 0, W - 1)
    q_idf = idf[qwc]
    q_vals = torch.where(ok_w, q_cnt[qwc].to(torch.float32) * q_idf, 0.0)
    q_hat = q_vals / torch.clamp(q_vals.sum(), min=1e-9)
    cols = db.kf_bow[:, qwc].to(torch.float32) * ok_w[None, :]
    kf_w = cols * q_idf[None, :] / torch.clamp(db.kf_l1, min=1e-9)[:, None]
    inter = torch.minimum(kf_w, q_hat[None, :]).sum(dim=1)
    shared = (cols > 0).sum(dim=1)
    return torch.where(db.kf_valid, inter, -1.0), torch.where(db.kf_valid, shared, 0)


def _query_scores(db: KfDatabase, words, valid):
    """_query_scores_from_counts with the query given as keypoint words."""
    return _query_scores_from_counts(db, _word_counts(words, valid, db.df.shape[0])[0])


def _group_accumulate(scores, ok, covis):
    """Covisibility-group accumulated scoring: group = keyframe + its top-10
    covisible; accumulated score = sum of the members' scores that are
    candidates themselves; the best member of each group above 0.75 * the
    best accumulated score keeps its score. Returns the per-keyframe
    candidate score (-1 where not kept)."""
    KF = scores.shape[0]
    dev = scores.device
    top_w, members = topk_stable(torch.where(ok[:, None], covis, -1), 10)
    m_ok = (top_w > 0) & ok[members]
    m_sc = torch.where(m_ok, scores[members], 0.0)
    own = torch.where(ok, scores, 0.0)
    acc = own + m_sc.sum(dim=1)
    all_sc = torch.cat([own[:, None], m_sc], dim=1)
    all_id = torch.cat([torch.arange(KF, device=dev)[:, None], members], dim=1)
    best_of_group = torch.gather(all_id, 1, torch.argmax(all_sc, dim=1, keepdim=True))[:, 0]
    acc = torch.where(ok, acc, -1.0)
    keep = acc > 0.75 * acc.max()
    cand_score = torch.where(keep, scores[best_of_group], -1.0)
    return torch.full((KF,), -1.0, device=dev).scatter_reduce(0, best_of_group, cand_score, "amax")


def detect_loop_candidates(db: KfDatabase, state: ms.MapState, kf_id, max_candidates: int = 8):
    """Loop candidates for keyframe kf_id (already in the database), the
    min-score floor computed from the same score pass. Returns (cand_ids
    (C,), cand_scores (C,), min_score): -1 padded, best first."""
    KF = db.kf_valid.shape[0]
    dev = db.kf_valid.device
    kf = torch.as_tensor(kf_id, dtype=torch.int64, device=dev).reshape(1)
    scores, shared = _query_scores_from_counts(db, db.kf_bow.index_select(0, kf)[0].to(torch.int64))
    covis_row = state.covis.index_select(0, kf)[0]
    connected = (covis_row >= 15) & state.kf_valid & db.kf_valid
    min_score = torch.where(connected, scores, torch.inf).min()
    min_score = torch.where(torch.isfinite(min_score), min_score, 1.0)
    # Exclude self and every keyframe sharing at least one map point (the
    # reference's full GetConnectedKeyFrames weight map, weight >= 1).
    excl = ((covis_row >= 1) & state.kf_valid) | (torch.arange(KF, device=dev) == kf)
    shared = torch.where(excl, 0, shared)
    scores = torch.where(excl, -1.0, scores)
    min_common = (0.8 * shared.max().to(torch.float32)).to(torch.int64)
    ok = (shared > min_common) & (scores >= min_score)
    top_sc, top_id = topk_stable(_group_accumulate(scores, ok, state.covis), max_candidates)
    return torch.where(top_sc > 0, top_id, -1), top_sc, min_score


def detect_reloc_candidates(db: KfDatabase, state: ms.MapState, words, valid, max_candidates: int = 16):
    """Relocalization candidates for an untracked frame (no covisibility
    exclusion, no score floor); 16 is the static bound."""
    scores, shared = _query_scores(db, words, valid)
    min_common = (0.8 * shared.max().to(torch.float32)).to(torch.int64)
    ok = shared > min_common
    top_sc, top_id = topk_stable(_group_accumulate(scores, ok, state.covis), max_candidates)
    return torch.where(top_sc > 0, top_id, -1), top_sc
