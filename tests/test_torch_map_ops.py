"""The geometry, matching and map algebra that local mapping adds to the
port, JAX reference vs PyTorch port on the CPU, on seeded inputs.

Tolerances: masks, indices and every integer field identical; floats
within 1e-5 (absolute, or relative where the quantity spans orders of
magnitude: squared epipolar distances, triangulated points).
SyntheticWorld frames are bit-identical; trajectories within 1e-6."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from my_orb_slam2_tpu.models import map_state as jms
from my_orb_slam2_tpu.ops import lie as jlie
from my_orb_slam2_tpu.ops import matching as jmatch
from my_orb_slam2_tpu.ops import projection as jproj
from my_orb_slam2_tpu.utils import config as jcfg
from my_orb_slam2_tpu.utils.synthetic import SyntheticWorld as JWorld
from my_orb_slam2_tpu_torch.models import map_state as tms
from my_orb_slam2_tpu_torch.ops import matching as tmatch
from my_orb_slam2_tpu_torch.ops import projection as tproj
from my_orb_slam2_tpu_torch.ops.scatter import add_drop, nonzero_static
from my_orb_slam2_tpu_torch.utils import bridge
from my_orb_slam2_tpu_torch.utils import config as tcfg
from my_orb_slam2_tpu_torch.utils.synthetic import SyntheticWorld as TWorld

TOL = 1e-5
MP, KF, K_OBS, N = 128, 8, 6, 40
FX, FY, CX, CY = 500.0, 480.0, 320.0, 240.0


def _T(rng, scale=0.5):
    xi = np.r_[rng.normal(0, scale, 3), rng.normal(0, 0.1, 3)].astype(np.float32)
    return np.array(jlie.se3_exp(jnp.asarray(xi)))


def t(x, name=""):
    """numpy -> the port's tensor (int64 integers; name="desc" keeps
    uint32 descriptor words as int32 bits)."""
    return bridge._to_tensor(name, x, "cpu")


def same(a, b):
    return np.array_equal(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b))


# ---------------------------------------------------------------------------
# Projection and matching additions
# ---------------------------------------------------------------------------


def test_two_view_geometry():
    rng = np.random.default_rng(0)
    T1 = _T(rng)
    T2 = np.stack([_T(rng) for _ in range(5)])
    X = np.stack([rng.uniform(-3, 3, 64), rng.uniform(-2, 2, 64), rng.uniform(4, 30, 64)], 1).astype(np.float32)
    uv1 = np.asarray(jproj.project(jnp.asarray(T1), jnp.asarray(X), FX, FY, CX, CY)[0])
    uv2 = np.asarray(jproj.project(jnp.asarray(T2[0]), jnp.asarray(X), FX, FY, CX, CY)[0]) + rng.normal(0, 0.3, (64, 2)).astype(np.float32)
    # triangulation: the reference vmaps over T2; the port broadcasts
    T2b = np.repeat(T2[:1], 64, 0)
    Xj, okj = jax.vmap(lambda T, a, b: jproj.triangulate_dlt(jnp.asarray(T1), T, a, b, FX, FY, CX, CY))(
        jnp.asarray(T2b), jnp.asarray(uv1), jnp.asarray(uv2))
    Xt, okt = tproj.triangulate_dlt(t(T1), t(T2b), t(uv1), t(uv2), FX, FY, CX, CY)
    assert same(okj, okt)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tproj.parallax_cos(t(T1), t(T2[0]), t(X)).numpy(), np.asarray(jproj.parallax_cos(T1, T2[0], X)), rtol=0, atol=TOL)
    F_ref = np.stack([np.asarray(jproj.fundamental_from_poses(jnp.asarray(T1), jnp.asarray(T), FX, FY, CX, CY)) for T in T2])
    F_t = tproj.fundamental_from_poses(t(T1), t(T2), FX, FY, CX, CY).numpy()
    np.testing.assert_allclose(F_t, F_ref, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(tproj.fundamental_from_poses(t(T1), t(T2[1]), FX, FY, CX, CY).numpy(), F_ref[1], rtol=1e-5, atol=1e-9)
    d_ref = np.asarray(jproj.epipolar_dist_sq(jnp.asarray(F_ref[0]), jnp.asarray(uv1)[:, None], jnp.asarray(uv2)[None]))
    d_t = tproj.epipolar_dist_sq(t(F_ref[0]), t(uv1)[:, None], t(uv2)[None]).numpy()
    np.testing.assert_allclose(d_t, d_ref, rtol=1e-4, atol=1e-6)


def test_batched_frustum_and_projection():
    rng = np.random.default_rng(1)
    Ts = np.stack([_T(rng) for _ in range(4)])
    X = rng.normal(0, 5, (50, 3)).astype(np.float32) + [0, 0, 8]
    nrm = rng.normal(size=(50, 3)).astype(np.float32)
    args = (t(nrm), t(np.full(50, 1.0, np.float32)), t(np.full(50, 20.0, np.float32)), FX, FY, CX, CY, 0.0, 640.0, 0.0, 480.0)
    batched = tproj.frustum_check(t(Ts), t(X), *args)
    for b in range(4):
        one = tproj.frustum_check(t(Ts[b]), t(X), *args)
        ref = jproj.frustum_check(jnp.asarray(Ts[b]), jnp.asarray(X), *[jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a for a in args])
        assert same(ref[0], one[0]) and same(ref[0], batched[0][b])
        for i in (1, 2, 3, 4):
            np.testing.assert_allclose(batched[i][b].numpy(), np.asarray(ref[i]), rtol=TOL, atol=TOL)


def test_word_bucket_mask():
    rng = np.random.default_rng(2)
    w1, w2 = rng.integers(-1, 50, 30), rng.integers(-1, 50, 20)
    for div in (1, 10):
        assert same(jmatch.word_bucket_mask(jnp.asarray(w1), jnp.asarray(w2), div), tmatch.word_bucket_mask(t(w1), t(w2), div))


def _kp_side(rng, n):
    uv = rng.uniform([0, 0], [640, 480], (n, 2)).astype(np.float32)
    return dict(
        uv=uv, valid=rng.random(n) < 0.9, has_mp=rng.random(n) < 0.2,
        desc=rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32), angle=rng.uniform(-3, 3, n).astype(np.float32),
        ur=np.where(rng.random(n) < 0.5, uv[:, 0] - 10, -1).astype(np.float32), octave=rng.integers(0, 8, n),
        words=rng.integers(-1, 40, n),
    )


@pytest.mark.parametrize("bucket_div", [0, 4])
def test_search_for_triangulation(bucket_div):
    """One neighbour and a batch of 3 (the reference's vmap): 40 of 48
    points seen by both keyframes of each pair, near-copy descriptors."""
    rng = np.random.default_rng(3)
    T1 = _T(rng, 0.05)
    X = np.stack([rng.uniform(-4, 4, 48), rng.uniform(-3, 3, 48), rng.uniform(5, 20, 48)], 1).astype(np.float32)
    a = _kp_side(rng, 48)
    a["uv"] = np.array(jproj.project(jnp.asarray(T1), jnp.asarray(X), FX, FY, CX, CY)[0])
    a["has_mp"][:] = False
    O1 = -(T1[:3, :3].T @ T1[:3, 3])
    bs, T2 = [], []
    for _ in range(3):
        T = _T(rng, 0.05)
        T[0, 3] += 0.5
        b = _kp_side(rng, 56)
        b["uv"][:40] = np.asarray(jproj.project(jnp.asarray(T), jnp.asarray(X[:40]), FX, FY, CX, CY)[0]) + rng.normal(0, 0.3, (40, 2))
        b["desc"][:40] = a["desc"][:40] ^ (rng.random((40, 8)) < 0.02).astype(np.uint32)
        bs.append(b)
        T2.append(T)
    T2 = np.stack(T2)
    F = np.stack([np.asarray(jproj.fundamental_from_poses(jnp.asarray(T1), jnp.asarray(T), FX, FY, CX, CY)) for T in T2])
    epi = np.stack([np.asarray(jproj.project(jnp.asarray(T), jnp.asarray(O1[None]), FX, FY, CX, CY)[0][0]) for T in T2])
    sig2 = [np.asarray([1.2 ** (2 * o) for o in b["octave"]], np.float32) for b in bs]
    keys1 = ("uv", "valid", "has_mp", "desc", "angle", "ur")
    keys2 = ("uv", "octave", "valid", "has_mp", "desc", "angle", "ur")

    def ref(i):
        b = bs[i]
        return jmatch.search_for_triangulation(
            *(jnp.asarray(a[k]) for k in keys1), *(jnp.asarray(b[k]) for k in keys2),
            jnp.asarray(F[i]), jnp.asarray(epi[i]), jnp.asarray(sig2[i]),
            words1=jnp.asarray(a["words"]), words2=jnp.asarray(b["words"]), bucket_div=bucket_div,
        )

    side1 = [t(a[k], k) for k in keys1]
    stack = lambda k: t(np.stack([b[k] for b in bs]), k)  # noqa: E731
    out = tmatch.search_for_triangulation(
        *side1, *(stack(k) for k in keys2), t(F), t(epi), t(np.stack(sig2)),
        words1=t(a["words"]), words2=stack("words"), bucket_div=bucket_div,
    )
    n_ok = 0
    for i in range(3):
        r = ref(i)
        one = tmatch.search_for_triangulation(
            *side1, *(t(bs[i][k], k) for k in keys2), t(F[i]), t(epi[i]), t(sig2[i]),
            words1=t(a["words"]), words2=t(bs[i]["words"]), bucket_div=bucket_div,
        )
        for j in range(3):
            assert same(r[j], one[j]) and same(r[j], out[j][i]), (i, j)
        n_ok += int(np.asarray(r[1]).sum())
    assert n_ok > (30 if bucket_div == 0 else 5)  # random words: the gate removes most


def test_batched_search_by_projection_matches_loop():
    rng = np.random.default_rng(4)
    P, M, B = 30, 50, 3
    pt_desc = t(rng.integers(0, 2 ** 32, (P, 8), dtype=np.uint32), "desc")
    kp = [_kp_side(rng, M) for _ in range(B)]
    pred = rng.uniform([0, 0], [640, 480], (B, P, 2)).astype(np.float32)
    for b in range(B):
        kp[b]["uv"][:P] = pred[b] + rng.normal(0, 2, (P, 2))
        kp[b]["desc"][:P] = pt_desc.numpy().view(np.uint32)
    lvl = rng.integers(0, 8, (B, P))
    for b in range(B):
        kp[b]["octave"][:P] = lvl[b]
    st = lambda k: t(np.stack([x[k] for x in kp]), k)  # noqa: E731
    args = dict(max_dist=50.0, ratio=1.0)
    bi, bo, bd = tmatch.search_by_projection(
        t(pred), t(lvl), t(np.ones((B, P), bool)), pt_desc, t(np.full((B, P), 8.0, np.float32)),
        st("uv"), st("octave"), st("valid"), st("desc"), kp_ur=st("ur"), pred_ur=t(pred[..., 0] - 10),
        level_lo=t(lvl - 1), level_hi=t(lvl + 1), **args,
    )
    for b in range(B):
        ref = jmatch.search_by_projection(
            jnp.asarray(pred[b]), jnp.asarray(lvl[b]), jnp.ones(P, bool), jnp.asarray(pt_desc.numpy().view(np.uint32)),
            jnp.full(P, 8.0), *(jnp.asarray(kp[b][k]) for k in ("uv", "octave", "valid", "desc")),
            kp_ur=jnp.asarray(kp[b]["ur"]), pred_ur=jnp.asarray(pred[b][:, 0] - 10),
            level_lo=jnp.asarray(lvl[b] - 1), level_hi=jnp.asarray(lvl[b] + 1), **args,
        )
        assert same(ref[0], bi[b]) and same(ref[1], bo[b]) and same(ref[2], bd[b])
    assert bo.sum() > 10


# ---------------------------------------------------------------------------
# Map algebra
# ---------------------------------------------------------------------------


def _cfg(mod):
    return mod.SlamConfig(capacity=mod.CapacityConfig(max_keyframes=KF, max_map_points=MP, max_obs_per_point=K_OBS))


@pytest.fixture(scope="module")
def populated():
    """A JAX state with 100 points in front of 6 keyframes that share them,
    so observer rows overlap, fill up and overflow."""
    rng = np.random.default_rng(5)
    state = jms.init_map_state(_cfg(jcfg), N)
    pos = np.stack([rng.uniform(-3, 3, 100), rng.uniform(-2, 2, 100), rng.uniform(4, 20, 100)], 1)
    state, _, _ = jms.add_map_points(
        state, jnp.asarray(pos, jnp.float32), jnp.asarray(rng.integers(0, 2 ** 32, (100, 8), dtype=np.uint32)),
        jnp.zeros((100, 3)), jnp.ones(100), 2 * jnp.ones(100), jnp.zeros(100, jnp.int32), jnp.ones(100, bool),
    )
    for k in range(6):
        assign = rng.choice(np.r_[np.arange(30), rng.integers(30, 100, 20), -np.ones(10, int)], N, replace=False)
        uv = rng.uniform(0, 600, (N, 2)).astype(np.float32)
        ur = np.where(rng.random(N) < 0.6, uv[:, 0] - 10, -1.0).astype(np.float32)
        state, _ = jms.insert_keyframe(
            state, jnp.asarray(_T(rng, 0.3)), jnp.int32(k), jnp.float32(k), jnp.asarray(uv), jnp.asarray(ur),
            jnp.asarray(np.where(ur >= 0, 5.0, -1.0).astype(np.float32)), jnp.asarray(rng.integers(0, 8, N).astype(np.int32)),
            jnp.zeros(N), jnp.asarray(rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32)),
            jnp.asarray(rng.random(N) < 0.95), jnp.asarray(assign.astype(np.int32)),
        )
    return rng, {k: np.asarray(v) for k, v in state._asdict().items()}


def J(d):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def P_(d):
    return bridge.map_state_from_numpy(d, "cpu")


def assert_states(port, ref, tol=TOL):
    a = bridge.map_state_to_numpy(port)
    for k, v in ref._asdict().items():
        v = np.asarray(v)
        if v.dtype.kind in "biu":
            assert np.array_equal(a[k], v), k
        else:
            np.testing.assert_allclose(a[k], v, rtol=0, atol=tol, err_msg=k)


def test_rebuild_and_recount(populated):
    _, st = populated
    st = dict(st)
    kf_mp = st["kf_mp"].copy()
    kf_mp[1, :5] = kf_mp[1, 5]  # duplicate (point, keyframe) pairs
    st["kf_mp"] = kf_mp
    ref = jms.rebuild_obs_index(J(st))
    assert int(ref.obs_overflow) > int(st["obs_overflow"])
    assert_states(tms.rebuild_obs_index(P_(st)), ref)
    assert_states(tms.recount_observations(P_(st)), jms.recount_observations(J(st)))


def test_obs_row_ops(populated):
    rng, st = populated
    okf, osl = st["mp_obs_kf"], st["mp_obs_slot"]
    E = 80
    pid = rng.integers(-2, MP + 2, E)
    pid[:10] = 3  # repeats
    rows = np.clip(pid, 0, MP - 1)
    col = rng.integers(0, K_OBS, E)
    kf, slot = okf[rows, col], osl[rows, col]
    kf[::7] = 99  # not present
    mask = rng.random(E) < 0.9
    i32 = lambda a: jnp.asarray(np.asarray(a).astype(np.int32))  # noqa: E731
    ref = jms.obs_remove_pairs(i32(okf), i32(osl), i32(pid), i32(kf), i32(slot), jnp.asarray(mask))
    out = tms.obs_remove_pairs(t(okf), t(osl), t(pid), t(kf), t(slot), t(mask))
    assert same(ref[0], out[0]) and same(ref[1], out[1])
    holes_kf, holes_slot = np.asarray(ref[0]), np.asarray(ref[1])
    ids = rng.integers(-1, MP + 1, 50)
    m = rng.random(50) < 0.8
    ref = jms.obs_compact_rows(i32(holes_kf), i32(holes_slot), i32(ids), jnp.asarray(m))
    out = tms.obs_compact_rows(t(holes_kf), t(holes_slot), t(ids), t(m))
    assert same(ref[0], out[0]) and same(ref[1], out[1])
    ck, cs = np.asarray(ref[0]), np.asarray(ref[1])
    pid = rng.integers(-1, MP, 120)
    pid[:30] = 7  # one point gains many observations: overflow
    cnt = (ck[np.clip(pid, 0, MP - 1)] >= 0).sum(1)
    kf, slot, mask = rng.integers(0, KF, 120), rng.integers(0, N, 120), rng.random(120) < 0.9
    ref = jms.obs_add_pairs_multi(i32(ck), i32(cs), i32(pid), i32(kf), i32(slot), jnp.asarray(mask), i32(cnt))
    out = tms.obs_add_pairs_multi(t(ck), t(cs), t(pid), t(kf), t(slot), t(mask), t(cnt))
    for r, o in zip(ref, out):
        assert same(r, o)
    assert int(ref[3]) > 0


def test_covisibility_ops(populated):
    rng, st = populated
    ids = np.array([0, 3, -1, 5, KF + 2, 2])
    assert_states(tms.refresh_covisibility(P_(st), t(ids)), jms.refresh_covisibility(J(st), jnp.asarray(ids.astype(np.int32))))
    E = 30
    pid = rng.integers(-1, MP, E)
    kf = rng.integers(-1, KF + 1, E)
    mask = rng.random(E) < 0.8
    ref = jms.covis_sub_removed_obs(J(st), *(jnp.asarray(a.astype(np.int32)) for a in (pid, kf)), jnp.asarray(mask))
    assert_states(tms.covis_sub_removed_obs(P_(st), t(pid), t(kf), t(mask)), ref)
    for k in range(KF):
        for n in (3, KF + 4):
            rj, rt = jms.best_covisible(J(st), jnp.int32(k), n), tms.best_covisible(P_(st), k, n)
            assert same(rj[0], rt[0]) and same(rj[1], rt[1])
    ids = np.array([1, 5, -1, 7, 7])
    assert same(jms.mp_observations_mask(J(st), jnp.asarray(ids.astype(np.int32))), tms.mp_observations_mask(P_(st), t(ids)))


def test_point_geometry(populated):
    rng, st = populated
    st = dict(st)
    ref_kf = st["mp_ref_kf"].copy()
    ref_kf[::3] = 4  # stale reference keyframes fall back to the first observer
    st["mp_ref_kf"] = ref_kf
    ids = np.r_[rng.choice(MP, 40, replace=False), [MP, -1]]
    ok = rng.random(42) < 0.9
    ref = jms.update_point_geometry_ids(J(st), jnp.asarray(ids.astype(np.int32)), jnp.asarray(ok), 1.2, 8)
    assert_states(tms.update_point_geometry_ids(P_(st), t(ids), t(ok), 1.2, 8), ref)
    mask = st["mp_valid"] & (rng.random(MP) < 0.5)
    for cap in (0, 16):
        ref = jms.update_point_geometry(J(st), jnp.asarray(mask), 1.2, 8, max_touched=cap)
        assert_states(tms.update_point_geometry(P_(st), t(mask), 1.2, 8, max_touched=cap), ref)
    s_j, is_j = jms.scale_sigma2_table(1.2, 8)
    s_t, is_t = tms.scale_sigma2_table(1.2, 8)
    assert np.array_equal(s_t.numpy(), np.asarray(s_j)) and np.array_equal(is_t.numpy(), np.asarray(is_j))


def test_erase_ops(populated):
    rng, st = populated
    for kill in (st["mp_valid"] & (rng.random(MP) < 0.3), np.zeros(MP, bool)):
        for max_kill in (8192, 5):
            ref = jms.erase_map_points(J(st), jnp.asarray(kill), max_kill=max_kill)
            assert_states(tms.erase_map_points(P_(st), t(kill), max_kill=max_kill), ref)
    kf_ids = np.array([1, 4, 2, -1])
    ok = np.array([True, True, False, True])
    ref = jms.erase_keyframe_observations(J(st), jnp.asarray(kf_ids.astype(np.int32)), jnp.asarray(ok))
    assert_states(tms.erase_keyframe_observations(P_(st), t(kf_ids), t(ok)), ref)


def test_scatter_helpers():
    rng = np.random.default_rng(6)
    for n, size in ((20, 8), (5, 9), (6, 6)):
        mask = rng.random(n) < 0.5
        ref = np.asarray(jnp.nonzero(jnp.asarray(mask), size=size, fill_value=n)[0])
        assert np.array_equal(nonzero_static(t(mask), size, n).numpy(), ref)
    base = rng.normal(size=(6, 3)).astype(np.float32)
    idx = np.array([0, 6, 3, 0, 9])  # out-of-range sentinels are >= len, as in the reference
    vals = rng.normal(size=(5, 3)).astype(np.float32)
    ref = np.asarray(jnp.asarray(base).at[jnp.asarray(idx)].add(jnp.asarray(vals), mode="drop"))
    np.testing.assert_allclose(add_drop(t(base), t(idx), t(vals)).numpy(), ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# SyntheticWorld and the bridge
# ---------------------------------------------------------------------------


def test_synthetic_world_matches_reference():
    cj = jcfg.SlamConfig(camera=jcfg.CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0))
    ct = tcfg.SlamConfig(camera=tcfg.CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0))
    wj, wt = JWorld(cj, n_landmarks=3000, seed=4), TWorld(ct, n_landmarks=3000, seed=4)
    pj = wj.circular_trajectory(12, forward_per_frame=0.2, yaw_per_frame=0.04)
    pt = wt.circular_trajectory(12, forward_per_frame=0.2, yaw_per_frame=0.04)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    for i, (sf, seed) in enumerate(((1.0, 9), (0.4, None), (0.0, 11))):
        fj, lj = wj.observe(pj[i], 256, stereo_fraction=sf, seed=seed)
        ft, lt = wt.observe(pj[i], 256, stereo_fraction=sf, seed=seed)
        assert np.array_equal(lj, lt)
        port = bridge.frame_to_numpy(ft)
        for k in ("uv", "ur", "depth", "octave", "angle", "desc", "valid"):
            v = np.asarray(getattr(fj, k))
            assert port[k].dtype == v.dtype and np.array_equal(port[k], v), (i, k)
        assert ft.octave.dtype == torch.int64 and ft.desc.dtype == torch.int32


def test_bridge_ba_problem_and_aux():
    rng = np.random.default_rng(7)
    d = {
        "cam_Tcw": rng.normal(size=(4, 4, 4)).astype(np.float32), "cam_fixed": rng.random(4) < 0.5,
        "pt_pos": rng.normal(size=(9, 3)).astype(np.float32), "pt_valid": rng.random(9) < 0.5,
        "e_cam": rng.integers(-1, 4, (9, 3)).astype(np.int32), "e_uv": rng.normal(size=(9, 3, 2)).astype(np.float32),
        "e_ur": rng.normal(size=(9, 3)).astype(np.float32), "e_inv_sigma2": rng.random((9, 3)).astype(np.float32),
        "e_mask": rng.random((9, 3)) < 0.5,
    }
    prob = bridge.ba_problem_from_numpy(d, "cpu")
    assert prob.e_cam.dtype == torch.int64 and prob.e_mask.dtype == torch.bool
    back = bridge.ba_problem_to_numpy(prob)
    for k, v in d.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    aux = {"cam_ids": np.arange(4, dtype=np.int32), "cam_ok": d["cam_fixed"], "e_col": d["e_cam"]}
    back = bridge.aux_to_numpy(bridge.aux_from_numpy(aux, "cpu"))
    assert all(back[k].dtype == v.dtype and np.array_equal(back[k], v) for k, v in aux.items())
