"""The vocabulary-training half of place recognition, JAX reference vs
PyTorch port, on the CPU: `ops/bow.train_tree_vocabulary`, `bow_counts`,
`l1_scores_against_all`, `utils/vocab_io` (DBoW2 text and packed npz,
crossing between the packages both ways), `keyframe_db.score_between`
and the `make_vocab` tool.

Tolerances: the trained tree is bit-identical (integer arithmetic, the
same host draws); word ids, counts and shared-word counts exact; the L1
scores within 1e-6 (f32 sums in another order); score_between within
1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from my_orb_slam2_tpu.models import keyframe_db as jkdb
from my_orb_slam2_tpu.ops import bow as jbow
from my_orb_slam2_tpu.utils import vocab_io as jvio
from my_orb_slam2_tpu_torch import make_vocab
from my_orb_slam2_tpu_torch.models import keyframe_db as tkdb
from my_orb_slam2_tpu_torch.ops import bow as tbow
from my_orb_slam2_tpu_torch.utils import vocab_io as tvio
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)
from tests.test_place_recognition import flip_bits, rand_desc

SCORE_TOL = 1e-6


def _t(desc):
    return torch.tensor(np.ascontiguousarray(desc).view(np.int32))


def _tree(voc):
    """(centres uint32, children, leaf words) of either package's tree."""
    if isinstance(voc, tbow.TreeVocabulary):
        return (voc.centers.numpy().view(np.uint32), voc.children.numpy(), voc.leaf_word.numpy())
    return tuple(np.asarray(a) for a in (voc.centers, voc.children, voc.leaf_word))


def assert_same_tree(a, b):
    for x, y in zip(_tree(a), _tree(b)):
        assert np.array_equal(x, y)
    assert (a.k, a.depth, a.n_words) == (b.k, b.depth, b.n_words)


@pytest.fixture(scope="module")
def trained():
    """tests/test_place_recognition.py:40's corpus and training call, in
    both packages."""
    corpus = rand_desc(np.random.default_rng(0), 2000)
    ref = jbow.train_tree_vocabulary(corpus, k=4, depth=3, iters=4)
    port = tbow.train_tree_vocabulary(corpus, k=4, depth=3, iters=4, device="cpu")
    return corpus, ref, port


def test_train_tree_vocabulary_bit_identical(trained):
    corpus, ref, port = trained
    assert_same_tree(port, ref)
    words_j = np.asarray(ref.words(jnp.asarray(corpus)))
    assert np.array_equal(port.words(_t(corpus)).numpy(), words_j)


@pytest.mark.parametrize("k, depth, iters, n", [(10, 2, 3, 1500), (3, 4, 2, 40)])
def test_train_tree_vocabulary_shapes(k, depth, iters, n):
    """A wide tree, and a deep one whose groups run empty (random centres
    drawn for them, old centres kept for empty subclusters)."""
    corpus = flip_bits(np.random.default_rng(5), rand_desc(np.random.default_rng(4), n), 3)
    ref = jbow.train_tree_vocabulary(corpus, k=k, depth=depth, iters=iters, seed=3)
    port = tbow.train_tree_vocabulary(_t(corpus), k=k, depth=depth, iters=iters, seed=3, device="cpu")
    assert_same_tree(port, ref)


def test_bit_planes_round_trip():
    desc = _t(rand_desc(np.random.default_rng(1), 64))
    bits = tbow._bit_planes(desc)
    assert bits.shape == (64, 256)
    assert torch.equal(tbow._pack_planes(bits > 0.5), desc)
    assert torch.equal(bits.sum(dim=1).to(torch.int64), tbow.popcount32(desc).sum(dim=1))


@pytest.mark.parametrize("kind", ["text", "npz"])
def test_vocabulary_files_cross_packages(trained, kind, tmp_path):
    """Each package reads the other's files, and its own, to the same tree."""
    corpus, ref, port = trained
    save = {"text": (jvio.save_dbow2_text, tvio.save_dbow2_text), "npz": (jvio.save_packed, tvio.save_packed)}[kind]
    load = {"text": (jvio.load_dbow2_text, tvio.load_dbow2_text), "npz": (jvio.load_packed, tvio.load_packed)}[kind]
    suffix = ".txt" if kind == "text" else ".npz"
    from_jax, from_port = tmp_path / f"jax{suffix}", tmp_path / f"port{suffix}"
    save[0](ref, str(from_jax))
    save[1](port, str(from_port))
    if kind == "text":
        assert from_jax.read_text() == from_port.read_text()
    for path in (from_jax, from_port):
        assert_same_tree(load[0](str(path)), ref)
        got = load[1](str(path), device="cpu")
        assert_same_tree(got, ref)
        assert torch.equal(got.words(_t(corpus)), port.words(_t(corpus)))


def test_load_dbow2_text_tree_shapes(tmp_path):
    """A hand-written file with an uneven tree: a parent with more than k
    children keeps its first k, leaves are numbered in node order."""
    rng = np.random.default_rng(2)
    lines = ["2 2 0 0"]
    for parent, leaf in [(0, 0), (0, 1), (0, 1), (1, 1), (1, 1), (1, 1)]:
        lines.append(" ".join([str(parent), str(leaf)] + [str(b) for b in rng.integers(0, 256, 32)] + ["0.5"]))
    path = tmp_path / "voc.txt"
    path.write_text("\n".join(lines) + "\n")
    assert_same_tree(tvio.load_dbow2_text(str(path), device="cpu"), jvio.load_dbow2_text(str(path)))


def test_bow_counts_exact():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 50, 300)
    valid = rng.random(300) > 0.2
    ref = np.asarray(jbow.bow_counts(jnp.asarray(words, jnp.int32), jnp.asarray(valid), 50))
    got = tbow.bow_counts(torch.tensor(words), torch.tensor(valid), 50)
    assert np.array_equal(got.numpy(), ref.astype(np.int64))


def _scoring_inputs(seed, n_kf=6, n_words=64, n=120):
    rng = np.random.default_rng(seed)
    kf_bow = rng.integers(0, 4, (n_kf, n_words)) * (rng.random((n_kf, n_words)) > 0.6)
    idf = rng.uniform(0.1, 3.0, n_words).astype(np.float32)
    kf_l1 = (kf_bow * idf[None, :]).sum(axis=1).astype(np.float32)
    words = rng.integers(0, n_words, n)
    valid = rng.random(n) > 0.3
    return words, valid, kf_bow, kf_l1, idf


@pytest.mark.parametrize("seed", [0, 1])
def test_l1_scores_against_all(seed):
    words, valid, kf_bow, kf_l1, idf = _scoring_inputs(seed)
    sj, shj = jbow.l1_scores_against_all(jnp.asarray(words, jnp.int32), jnp.asarray(valid),
                                         jnp.asarray(kf_bow, jnp.uint16), jnp.asarray(kf_l1), jnp.asarray(idf))
    st, sht = tbow.l1_scores_against_all(torch.tensor(words), torch.tensor(valid), torch.tensor(kf_bow),
                                         torch.tensor(kf_l1), torch.tensor(idf))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=SCORE_TOL)
    assert np.array_equal(sht.numpy(), np.asarray(shj))


def test_score_between_on_both_databases(trained):
    """Keyframes 0-3 see one scene, 4-5 another: the same words go into a
    database of each package, and every pair scores alike."""
    corpus, ref, port = trained
    rng = np.random.default_rng(6)
    scenes = [corpus[:256], corpus[300:556]]
    db_j = jkdb.init_db(8, 256, ref.n_words)
    db_t = tkdb.init_db(8, 256, port.n_words, "cpu")
    valid = np.ones(256, bool)
    for kf, scene in enumerate([0, 0, 0, 0, 1, 1]):
        d = flip_bits(rng, scenes[scene], 2)
        db_j = jkdb.add_keyframe(db_j, jnp.int32(kf), ref.words(jnp.asarray(d)), jnp.asarray(valid))
        db_t = tkdb.add_keyframe(db_t, kf, port.words(_t(d)), torch.tensor(valid))
    got = np.array([[float(tkdb.score_between(db_t, a, b)) for b in range(6)] for a in range(6)])
    want = np.array([[float(jkdb.score_between(db_j, jnp.int32(a), jnp.int32(b))) for b in range(6)] for a in range(6)])
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)
    assert got[0, 1] > got[0, 4]


def test_make_vocab_cpu(tmp_path):
    """make_vocab at a cut size on the CPU: one world's frames through the
    batch extractor, a k=4 / L=2 tree that equals the reference's training
    on the same corpus, the npz written and read back."""
    out = tmp_path / "voc.npz"
    res = make_vocab.main(["--frames", "4", "--k", "4", "--depth", "2", "--iters", "2", "--device", "cpu",
                           "--out", str(out)])
    corpus = res["corpus"]
    assert res["frames"] == 4 and corpus.dtype == np.uint32 and corpus.shape[1] == 8 and len(corpus) > 1000
    assert_same_tree(res["vocabulary"], jbow.train_tree_vocabulary(corpus, k=4, depth=2, iters=2, seed=0))
    assert_same_tree(tvio.load_packed(str(out), device="cpu"), res["vocabulary"])
    assert 1 <= res["held_out_words"] <= 16
