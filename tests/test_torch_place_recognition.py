"""Place recognition, JAX reference vs PyTorch port, on the CPU:
bag-of-words vocabularies (ops/bow.py, utils/vocab_io.py), the keyframe
database (models/keyframe_db.py), EPnP and its RANSAC (ops/epnp.py). The
relocalizer built on them (models/relocalization.py) is held against the
reference with the replayed key chain in tests/test_torch_system.py, on the
map the two systems recorded.

Tolerances: word ids, word counts, document frequencies, candidate ids and
inlier masks identical; keyframe L1 norms and scores within 1e-5 relative;
EPnP poses within 1e-3 (rotation entries) / 1e-3 m on noise-free input and
2e-3 / 5e-3 m after RANSAC on noisy input. RANSAC draws: the reference's
key is split per iteration here with jax, and its uniforms are fed to the
port's RANSAC."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from my_orb_slam2_tpu.models import keyframe_db as jkdb
from my_orb_slam2_tpu.models import map_state as jms
from my_orb_slam2_tpu.ops import bow as jbow
from my_orb_slam2_tpu.ops import epnp as jepnp
from my_orb_slam2_tpu.ops import lie as jlie
from my_orb_slam2_tpu.utils import config as jcfg
from my_orb_slam2_tpu.utils import vocab_io as jvio
from my_orb_slam2_tpu_torch.models import keyframe_db as tkdb
from my_orb_slam2_tpu_torch.ops import bow as tbow
from my_orb_slam2_tpu_torch.ops import epnp as tepnp
from my_orb_slam2_tpu_torch.utils import bridge
from my_orb_slam2_tpu_torch.utils import vocab_io as tvio
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)


SCORE_RTOL = 1e-5
CAM = (500.0, 500.0, 320.0, 240.0)


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint32)


def _t(desc):
    return torch.tensor(desc.view(np.int32))


@pytest.fixture(scope="module")
def vocabs():
    return {name: (jvio.load_packed(path), tvio.load_packed(path, device="cpu"))
            for name, path in (("L4", jvio._FALLBACK_ASSET), ("L5", jvio._DEFAULT_ASSET))}


# ---------------------------------------------------------------------------
# Vocabularies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["L4", "L5"])
def test_tree_words_exact(vocabs, name):
    jv, tv = vocabs[name]
    assert (tv.k, tv.depth, tv.n_words) == (jv.k, jv.depth, jv.n_words)
    desc = _desc(np.random.default_rng(1), 2048)
    ref = np.asarray(jv.words(jnp.asarray(desc)))
    assert np.array_equal(tv.words(_t(desc)).numpy(), ref)
    assert np.array_equal(bridge.vocabulary_from_numpy(jv, "cpu").words(_t(desc)).numpy(), ref)
    assert len(np.unique(ref)) > 500  # the descent really spreads


def test_lsh_words_and_popcount():
    desc = _desc(np.random.default_rng(2), 512)
    jv, tv = jbow.LshVocabulary(n_bits=14), tbow.LshVocabulary(n_bits=14, device="cpu")
    ref = np.asarray(jv.words(jnp.asarray(desc)))
    assert np.array_equal(tv.words(_t(desc)).numpy(), ref)
    assert np.array_equal(bridge.vocabulary_from_numpy(jv, "cpu").words(_t(desc)).numpy(), ref)
    ref = np.asarray(jax.lax.population_count(jnp.asarray(desc))).astype(np.int64)
    assert np.array_equal(tbow.popcount32(_t(desc)).numpy(), ref)


def test_vocab_io_resolution(monkeypatch):
    monkeypatch.delenv("SLAM_VOCAB", raising=False)
    jv, tv = jvio.default_vocabulary(), tvio.default_vocabulary(device="cpu")
    assert (tv.k, tv.depth, tv.n_words) == (jv.k, jv.depth, jv.n_words) == (10, 5, 100000)
    assert tvio.DEFAULT_ASSET.endswith("my_orb_slam2_tpu/assets/orbvoc_k10_L5.npz")
    monkeypatch.setenv("SLAM_VOCAB", jvio._FALLBACK_ASSET)
    assert tvio.default_vocabulary(device="cpu").depth == jvio.default_vocabulary().depth == 4
    monkeypatch.setenv("SLAM_VOCAB", "/nonexistent/vocab.npz")
    assert tvio.default_vocabulary(device="cpu").depth == 5


# ---------------------------------------------------------------------------
# Keyframe database
# ---------------------------------------------------------------------------

KF_DB, N_KP, N_WORDS = 32, 256, 1000


def _db_scenario():
    """32 keyframes whose words come from 8 places (keyframe k revisits place
    k % 8), a banded covisibility, a culled keyframe."""
    rng = np.random.default_rng(3)
    place_words = [rng.choice(N_WORDS, 200, replace=False) for _ in range(8)]
    words = np.stack([rng.choice(place_words[k % 8], N_KP) for k in range(KF_DB)]).astype(np.int32)
    words[:, -20:] = rng.integers(0, N_WORDS, (KF_DB, 20))
    valid = rng.random((KF_DB, N_KP)) < 0.9
    i = np.arange(KF_DB)
    d = np.abs(i[:, None] - i[None, :])
    covis = np.where(d == 0, 0, np.where(d <= 2, 40, np.where(d == 3, 5, 0))).astype(np.int32)
    kf_valid = np.ones(KF_DB, bool)
    kf_valid[13] = False
    return words, valid, covis, kf_valid


def _db_state(cfg_mod, covis, kf_valid):
    cfg = cfg_mod.SlamConfig(capacity=cfg_mod.CapacityConfig(max_keyframes=KF_DB, max_map_points=1024))
    state = jms.init_map_state(cfg, 8)
    return state._replace(covis=jnp.asarray(covis), kf_valid=jnp.asarray(kf_valid))


@pytest.fixture(scope="module")
def databases():
    words, valid, covis, kf_valid = _db_scenario()
    jdb = jkdb.init_db(KF_DB, N_KP, N_WORDS)
    tdb = tkdb.init_db(KF_DB, N_KP, N_WORDS, "cpu")
    for k in range(24):
        jdb = jkdb.add_keyframe(jdb, jnp.int32(k), jnp.asarray(words[k]), jnp.asarray(valid[k]))
        tdb = tkdb.add_keyframe(tdb, k, torch.tensor(words[k], dtype=torch.int64), torch.tensor(valid[k]))
    kill = np.zeros(KF_DB, bool)
    kill[[13, 30]] = True  # 30 was never inserted
    jdb = jkdb.erase_mask(jdb, jnp.asarray(kill))
    tdb = tkdb.erase_mask(tdb, torch.tensor(kill))
    state = _db_state(jcfg, covis, kf_valid)
    return jdb, tdb, state, bridge.map_state_from_numpy(state, "cpu"), words, valid


def test_database_counts(databases):
    jdb, tdb, *_ = databases
    ref, got = {k: np.asarray(v) for k, v in jdb._asdict().items()}, bridge.kf_database_to_numpy(tdb)
    for k in ("kf_bow", "kf_valid", "df", "n_docs", "n_words"):
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    np.testing.assert_allclose(got["kf_l1"], ref["kf_l1"], rtol=SCORE_RTOL)
    assert int(ref["n_docs"]) == 23 and not ref["kf_valid"][13]
    # erase_keyframe on copies (the port zeroes kf_bow rows in place)
    ej = {k: np.asarray(v) for k, v in jkdb.erase_keyframe(jdb, jnp.int32(5))._asdict().items()}
    et = bridge.kf_database_to_numpy(tkdb.erase_keyframe(bridge.kf_database_from_numpy(ref, "cpu"), 5))
    for k in ("kf_bow", "kf_valid", "df", "n_docs"):
        assert np.array_equal(et[k], ej[k]), k


def test_database_scores(databases):
    jdb, tdb, _, _, words, valid = databases
    js, jsh = jkdb._query_scores(jdb, jnp.asarray(words[26]), jnp.asarray(valid[26]))
    ts, tsh = tkdb._query_scores(tdb, torch.tensor(words[26], dtype=torch.int64), torch.tensor(valid[26]))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SCORE_RTOL)
    assert np.array_equal(tsh.numpy(), np.asarray(jsh))


@pytest.mark.parametrize("kf_id", [16, 20, 23])
def test_detect_loop_candidates(databases, kf_id):
    jdb, tdb, jstate, tstate, *_ = databases
    jid, jsc, jmin = jkdb.detect_loop_candidates(jdb, jstate, jnp.int32(kf_id))
    tid, tsc, tmin = tkdb.detect_loop_candidates(tdb, tstate, kf_id)
    assert np.array_equal(tid.numpy(), np.asarray(jid))
    assert (np.asarray(jid) >= 0).any(), "the scenario must produce candidates"
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=SCORE_RTOL)
    np.testing.assert_allclose(float(tmin), float(jmin), rtol=SCORE_RTOL)


def test_detect_reloc_candidates(databases):
    jdb, tdb, jstate, tstate, words, valid = databases
    q = (words[29], valid[29])
    jid, jsc = jkdb.detect_reloc_candidates(jdb, jstate, jnp.asarray(q[0]), jnp.asarray(q[1]))
    tid, tsc = tkdb.detect_reloc_candidates(tdb, tstate, torch.tensor(q[0], dtype=torch.int64), torch.tensor(q[1]))
    assert np.array_equal(tid.numpy(), np.asarray(jid)) and (np.asarray(jid) >= 0).sum() >= 2
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=SCORE_RTOL)


# ---------------------------------------------------------------------------
# EPnP
# ---------------------------------------------------------------------------


def _pnp_problem(seed, n=200, noise=0.0, outliers=0.0):
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = CAM
    T = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.2, 6), jnp.float32)))
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(4, 15, n)], 1)
    pts_w = (pts - T[:3, 3]) @ T[:3, :3]  # camera-frame points -> world
    uv = np.stack([fx * pts[:, 0] / pts[:, 2] + cx, fy * pts[:, 1] / pts[:, 2] + cy], 1) + rng.normal(0, noise, (n, 2))
    bad = rng.random(n) < outliers
    uv[bad] += rng.uniform(30, 80, (bad.sum(), 2))
    mask = rng.random(n) < 0.9
    return T, pts_w.astype(np.float32), uv.astype(np.float32), mask


def test_epnp_noise_free():
    T, pts_w, uv, mask = _pnp_problem(4)
    w = mask.astype(np.float32)
    Rj, tj, _ = jepnp.epnp(jnp.asarray(pts_w), jnp.asarray(uv), jnp.asarray(w), *CAM)
    Rt, tt, _ = tepnp.epnp(torch.tensor(pts_w), torch.tensor(uv), torch.tensor(w), *CAM)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-3)
    np.testing.assert_allclose(Rt.numpy(), T[:3, :3], atol=1e-3)


def _jax_uniforms(key, n_iters, n):
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(jax.random.split(key, n_iters)))


def test_ransac_epnp_key_chain():
    T, pts_w, uv, mask = _pnp_problem(5, noise=0.5, outliers=0.25)
    key = jax.random.PRNGKey(21)
    max_err2 = np.full(len(mask), 5.991, np.float32)
    ref = jepnp.ransac_epnp(key, jnp.asarray(pts_w), jnp.asarray(uv), jnp.asarray(mask), jnp.asarray(max_err2),
                            *CAM, n_iters=128)
    got = tepnp.ransac_epnp(torch.tensor(_jax_uniforms(key, 128, len(mask))), torch.tensor(pts_w), torch.tensor(uv),
                            torch.tensor(mask), torch.tensor(max_err2), *CAM)
    assert np.array_equal(got["inliers"].numpy(), np.asarray(ref["inliers"]))
    assert int(got["n_inliers"]) == int(ref["n_inliers"]) > 100
    np.testing.assert_allclose(got["R"].numpy(), np.asarray(ref["R"]), atol=2e-3)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(ref["t"]), atol=5e-3)
