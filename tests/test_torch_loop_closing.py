"""Loop closing, JAX reference vs PyTorch port, on the CPU: the Sim3 group
(ops/lie.py), Horn alignment and the Sim3 RANSAC (ops/horn.py),
SearchBySim3 (ops/matching.py), the Sim3 LM (ops/sim3_opt.py), the
essential graph (ops/pose_graph.py), the flat bundle adjustment on both of
its branches (ops/ba.py) and models/loop_closing.py: match_and_sim3, the
loop-point count, correct_loop_state, global BA, the asynchronous GBA with
a mid-flight keyframe and LoopCloser.process / drain / tick.

The map fixtures come from tests/test_loop_quality.py::_build_drifted_loop
(imported, not edited): a 20-keyframe circle with injected drift whose last
keyframe re-observes keyframe 0's landmarks as duplicate points.

Tolerances: index outputs, masks, counts and every integer map field
identical; Lie maps within 1e-5; Horn / RANSAC / Sim3 LM within 1e-4;
the pose graph within 1e-4 (poses); the flat BA within 1e-4 (poses) /
1e-3 m (points); after the loop correction (Sim3 propagation, fuse and 20
Gauss-Newton steps with 64-step PCG in f32) poses within 2e-4 and points
within 2e-3 m (the viewing normals too: the points are >= 1 m away);
after a further global BA poses within 1e-3 and points within 1e-2 m
(points up to 16 m away). A loop closed by LoopCloser with the estimated
Sim3 is held to 3e-3 / 1e-2 m: the reference itself moves keyframe poses
by 3.3e-4 when its input Sim3 changes by 6e-8 (the pose graph's accept
tests flip), and the port's Sim3 differs from its by that much. RANSAC draws replay the
reference's key chains with jax (PRNGKey(11) for the loop closer).

The monocular loop closer (free scale) runs on a scaled copy of the
drifted loop: keyframe M - 1 and the points it created scaled by 1.3, no
stereo. The pose graph runs with fix_scale True and False; match_and_sim3
recovers s = 1.3 within 0.02; correct_loop_state under that Sim3 is held
to PG_TOL (poses) and LOOP_PT_TOL (points); LoopCloser closes it within
the closer's tolerances. The monocular global BA after it is held by its
integers, rotations and accuracy, not its positions (its docstring says
why)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from my_orb_slam2_tpu.models import keyframe_db as jkdb
from my_orb_slam2_tpu.models import loop_closing as jlc
from my_orb_slam2_tpu.models import map_state as jms
from my_orb_slam2_tpu.ops import ba as jba
from my_orb_slam2_tpu.ops import horn as jhorn
from my_orb_slam2_tpu.ops import lie as jlie
from my_orb_slam2_tpu.ops import matching as jmatch
from my_orb_slam2_tpu.ops import pose_graph as jpg
from my_orb_slam2_tpu.ops import sim3_opt as jsim3
from my_orb_slam2_tpu.utils import config as jcfg
from my_orb_slam2_tpu.utils import vocab_io as jvio
from my_orb_slam2_tpu_torch.models import loop_closing as tlc
from my_orb_slam2_tpu_torch.models import map_state as tms
from my_orb_slam2_tpu_torch.ops import ba as tba
from my_orb_slam2_tpu_torch.ops import horn as thorn
from my_orb_slam2_tpu_torch.ops import lie as tlie
from my_orb_slam2_tpu_torch.ops import matching as tmatch
from my_orb_slam2_tpu_torch.ops import pose_graph as tpg
from my_orb_slam2_tpu_torch.ops import sim3_opt as tsim3
from my_orb_slam2_tpu_torch.utils import bridge
from my_orb_slam2_tpu_torch.utils import config as tcfg
from my_orb_slam2_tpu_torch.utils import vocab_io as tvio
from tests.test_loop_quality import _build_drifted_loop
from tests.test_obs_index import check_obs_invariants
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)


M = 20
CAM = (500.0, 500.0, 320.0, 240.0)
LIE_TOL = 1e-5
SIM3_TOL = 1e-4
PG_TOL = 1e-4
BA_POSE_TOL, BA_PT_TOL = 1e-4, 1e-3
LOOP_POSE_TOL, LOOP_PT_TOL = 2e-4, 2e-3
GBA_POSE_TOL, GBA_PT_TOL = 1e-3, 1e-2
CLOSER_POSE_TOL, CLOSER_PT_TOL = 3e-3, 1e-2
# Point-derived fields: positions, scale ring, and the viewing normal (its
# error is the position error over a distance of at least 1 m).
POS_FIELDS = ("mp_pos", "mp_min_dist", "mp_max_dist", "mp_normal")


def _cfg(mod):
    return mod.SlamConfig(
        sensor=mod.Sensor.STEREO,
        camera=mod.CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=40.0, th_depth=40.0),
        capacity=mod.CapacityConfig(max_keyframes=32, max_map_points=8192),
        loop=mod.LoopConfig(essential_graph_min_weight=40),
    )


CJ, CT = _cfg(jcfg), _cfg(tcfg)
# The monocular loop closer: free scale (fix_scale = sensor != MONOCULAR).
CJ_MONO, CT_MONO = (dataclasses.replace(c, sensor=m.Sensor.MONOCULAR) for c, m in ((CJ, jcfg), (CT, tcfg)))
SCALE = 1.3  # the revisit's scale drift in the monocular copy of the loop


def _np(state):
    return {k: np.array(v) for k, v in state._asdict().items()}


def assert_maps_close(port, ref, pose_tol, pt_tol, what=""):
    a, r = bridge.map_state_to_numpy(port), ref if isinstance(ref, dict) else _np(ref)
    for k, v in r.items():
        assert a[k].dtype == v.dtype, (what, k)
        if v.dtype.kind in "biu":
            assert np.array_equal(a[k], v), f"{what}: integer field {k} differs at {np.argwhere(a[k] != v)[:5].tolist()}"
        else:
            np.testing.assert_allclose(a[k], v, rtol=0, atol=pt_tol if k in POS_FIELDS else pose_tol,
                                       err_msg=f"{what}: {k}")


def _jax_uniforms(key, n_iters, n):
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(jax.random.split(key, n_iters)))


class LoopKeyChain:
    """The reference loop closer's draws: PRNGKey(11), split once per tried
    candidate, the subkey split per RANSAC iteration."""

    def __init__(self):
        self.key = jax.random.PRNGKey(11)

    def __call__(self, shape):
        self.key, sub = jax.random.split(self.key)
        return torch.tensor(_jax_uniforms(sub, *shape))


@pytest.fixture(scope="module")
def loop_map():
    """The drifted loop (numpy copies: the reference donates its state)."""
    state, gt, kp_loop_match, loop_pt_mask = _build_drifted_loop(CJ, M=M)
    S = (gt[M - 1] @ np.linalg.inv(gt[0])).astype(np.float32)
    return {"state": _np(state), "gt": gt, "kp": np.asarray(kp_loop_match), "loop_pts": np.asarray(loop_pt_mask),
            "S": S}


def _jstate(d):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def _tstate(d):
    return bridge.map_state_from_numpy(d, "cpu")


# ---------------------------------------------------------------------------
# Sim3 group, Horn, RANSAC
# ---------------------------------------------------------------------------


def _xis(seed=0, n=16):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 0.4, (n, 7)).astype(np.float32)
    xi[0] = 0.0  # identity
    xi[1, 3:6] = 0.0  # pure translation + scale
    xi[2, 6] = 0.0  # rigid
    xi[3, 3:] = [1e-6, -2e-6, 1e-6, 3e-6]  # both small-angle branches
    return xi


def test_sim3_lie():
    xi = _xis()
    Sj = np.asarray(jlie.sim3_exp_b(jnp.asarray(xi)))
    St = tlie.sim3_exp(torch.tensor(xi))
    np.testing.assert_allclose(St.numpy(), Sj, atol=LIE_TOL)
    np.testing.assert_allclose(tlie.sim3_log(St).numpy(), np.asarray(jlie.sim3_log_b(jnp.asarray(Sj))), atol=LIE_TOL)
    np.testing.assert_allclose(tlie.sim3_log(St).numpy(), xi, atol=2e-5)
    np.testing.assert_allclose(tlie.sim3_inverse(St).numpy(), np.asarray(jlie.sim3_inverse_b(jnp.asarray(Sj))),
                               atol=LIE_TOL)
    np.testing.assert_allclose(tlie.sim3_to_se3(St).numpy(), np.asarray(jax.vmap(jlie.sim3_to_se3)(jnp.asarray(Sj))),
                               atol=LIE_TOL)
    for name in ("sim3_scale", "sim3_R", "sim3_t"):
        np.testing.assert_allclose(getattr(tlie, name)(St).numpy(),
                                   np.asarray(jax.vmap(getattr(jlie, name))(jnp.asarray(Sj))), atol=LIE_TOL, err_msg=name)
    T = np.asarray(jlie.se3_exp_b(jnp.asarray(xi[:, :6])))
    np.testing.assert_allclose(tlie.se3_log(torch.tensor(T)).numpy(), np.asarray(jlie.se3_log_b(jnp.asarray(T))),
                               atol=LIE_TOL)
    # Unbatched calls give the batched rows.
    np.testing.assert_allclose(tlie.sim3_exp(torch.tensor(xi[5])).numpy(), Sj[5], atol=LIE_TOL)
    np.testing.assert_allclose(tlie.sim3_apply(St[5], torch.ones(4, 3)).numpy(),
                               np.asarray(jlie.sim3_apply(jnp.asarray(Sj[5]), jnp.ones((4, 3)))), atol=LIE_TOL)


def _sim3_pair(seed, n=120, outliers=0.0):
    rng = np.random.default_rng(seed)
    S = np.asarray(jlie.sim3_exp(jnp.asarray(np.r_[rng.normal(0, 0.3, 6), 0.2], jnp.float32)))
    p2 = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)], 1).astype(np.float32)
    p1 = p2 @ S[:3, :3].T + S[:3, 3] + rng.normal(0, 0.002, (n, 3))
    bad = rng.random(n) < outliers
    p1[bad] += rng.normal(0, 1.0, (bad.sum(), 3))
    return S, p1.astype(np.float32), p2


def test_horn_align():
    S, p1, p2 = _sim3_pair(1)
    w = (np.arange(len(p1)) % 5 != 0).astype(np.float32)
    for fix in (False, True):
        Rj, tj, sj = jhorn.horn_align(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w), fix_scale=fix)
        Rt, tt, st = thorn.horn_align(torch.tensor(p1), torch.tensor(p2), torch.tensor(w), fix_scale=fix)
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=SIM3_TOL)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=SIM3_TOL)
        np.testing.assert_allclose(float(st), float(sj), atol=SIM3_TOL)


def test_ransac_sim3_key_chain():
    S, p1, p2 = _sim3_pair(2, outliers=0.3)
    fx, fy, cx, cy = CAM
    proj = lambda p: np.stack([fx * p[:, 0] / p[:, 2] + cx, fy * p[:, 1] / p[:, 2] + cy], 1)  # noqa: E731
    uv1, uv2 = proj(p1).astype(np.float32), proj(p2).astype(np.float32)
    mask = np.random.default_rng(3).random(len(p1)) < 0.9
    e = np.full(len(p1), 9.21, np.float32)
    key = jax.random.PRNGKey(5)
    for fix in (False, True):
        ref = jhorn.ransac_sim3(key, *map(jnp.asarray, (p1, p2, uv1, uv2, mask, e, e)), *CAM, n_iters=128,
                                fix_scale=fix)
        got = thorn.ransac_sim3(torch.tensor(_jax_uniforms(key, 128, len(p1))),
                                *map(torch.tensor, (p1, p2, uv1, uv2, mask, e, e)), *CAM, fix_scale=fix)
        assert np.array_equal(got["inliers"].numpy(), np.asarray(ref["inliers"]))
        assert int(got["n_inliers"]) == int(ref["n_inliers"])
        np.testing.assert_allclose(got["S12"].numpy(), np.asarray(ref["S12"]), atol=SIM3_TOL)
        if not fix:  # the pair has scale 1.22: only the free-scale fit explains it
            assert int(ref["n_inliers"]) > 40


# ---------------------------------------------------------------------------
# SearchBySim3, the Sim3 LM, the loop-closing passes on the drifted loop
# ---------------------------------------------------------------------------


def test_search_by_sim3_and_optimize_sim3(loop_map):
    d = loop_map["state"]
    c, k = M - 1, 0
    sf_tab = np.asarray([1.2 ** l for l in range(8)], np.float32)
    S = loop_map["S"] @ jlie_np_se3_perturb()

    def inputs(x):
        mp_c, mp_d = x["kf_mp"][c], x["kf_mp"][k]
        ok_c = (mp_c >= 0) & x["kf_kp_valid"][c]
        ok_d = (mp_d >= 0) & x["kf_kp_valid"][k]
        return (x["mp_pos"][np.maximum(mp_c, 0)], ok_c, x["kf_desc"][c], x["mp_pos"][np.maximum(mp_d, 0)], ok_d,
                x["kf_desc"][k], x["kf_Tcw"][c], x["kf_Tcw"][k], S, x["kf_uv"][c], x["kf_octave"][c], x["kf_uv"][k],
                x["kf_octave"][k], sf_tab)

    ref = jmatch.search_by_sim3(*map(jnp.asarray, inputs(d)), *CAM)
    t = bridge.map_state_to_numpy(_tstate(d))
    targs = [torch.tensor(a.view(np.int32)) if a.dtype == np.uint32 else torch.tensor(a) for a in inputs(t)]
    got = tmatch.search_by_sim3(*targs, *CAM)
    idx, ok = np.asarray(ref[0]), np.asarray(ref[1])
    assert np.array_equal(got[0].numpy(), idx) and np.array_equal(got[1].numpy(), ok)
    assert ok.sum() > 40

    # Sim3 LM on those matches, from a perturbed start.
    p1 = inputs(d)[0] @ d["kf_Tcw"][c][:3, :3].T + d["kf_Tcw"][c][:3, 3]
    p2 = inputs(d)[3][idx] @ d["kf_Tcw"][k][:3, :3].T + d["kf_Tcw"][k][:3, 3]
    args = (S, p1, p2, d["kf_uv"][c], d["kf_uv"][k][idx], 1.2 ** (-2.0 * d["kf_octave"][c]),
            1.2 ** (-2.0 * d["kf_octave"][k][idx]), ok)
    args = [np.asarray(a, np.float32) if a.dtype.kind == "f" else a for a in map(np.asarray, args)]
    for fix in (True,):  # the stereo loop closer's setting
        ref = jsim3.optimize_sim3(*map(jnp.asarray, args), *CAM, fix_scale=fix)
        got = tsim3.optimize_sim3(*map(torch.tensor, args), *CAM, fix_scale=fix)
        assert np.array_equal(got["inliers"].numpy(), np.asarray(ref["inliers"]))
        np.testing.assert_allclose(got["S12"].numpy(), np.asarray(ref["S12"]), atol=SIM3_TOL)


def jlie_np_se3_perturb():
    return np.asarray(jlie.se3_exp(jnp.asarray([0.02, -0.01, 0.03, 0.004, -0.003, 0.002], jnp.float32)))


def test_match_and_sim3_and_loop_points(loop_map):
    d = loop_map["state"]
    key = jax.random.PRNGKey(11)
    _, k1 = jax.random.split(key)
    ok_j, S_j, n_j, idx_j, mok_j = jlc.match_and_sim3(CJ, _jstate(d), jnp.int32(M - 1), jnp.int32(0), k1)
    ok_t, S_t, n_t, idx_t, mok_t = tlc.match_and_sim3(CT, _tstate(d), M - 1, 0, LoopKeyChain()((128, d["kf_mp"].shape[1])))
    assert bool(ok_j) and bool(ok_t) and int(n_t) == int(n_j)
    assert np.array_equal(idx_t.numpy(), np.asarray(idx_j)) and np.array_equal(mok_t.numpy(), np.asarray(mok_j))
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), atol=SIM3_TOL)
    nj, lpj, kpj = jlc.count_loop_point_matches(CJ, _jstate(d), jnp.int32(M - 1), jnp.int32(0), S_j)
    nt, lpt, kpt = tlc.count_loop_point_matches(CT, _tstate(d), M - 1, 0, torch.tensor(np.asarray(S_j)))
    assert int(nt) == int(nj) >= CJ.loop.min_total_matches
    assert np.array_equal(lpt.numpy(), np.asarray(lpj)) and np.array_equal(kpt.numpy(), np.asarray(kpj))


# ---------------------------------------------------------------------------
# Essential graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fix_scale", [True, False], ids=["stereo", "mono"])
def test_pose_graph(loop_map, fix_scale):
    d = loop_map["state"]
    loop_edges = d["loop_edges"].copy()
    loop_edges[M - 1, 0] = loop_edges[0, M - 1] = True
    args = (d["covis"], d["kf_parent"], loop_edges, d["kf_valid"], d["kf_Tcw"])
    ej = jpg.build_essential_edges(*map(jnp.asarray, args), min_weight=40)
    et = tpg.build_essential_edges(*(torch.tensor(a).long() if a.dtype.kind == "i" else torch.tensor(a) for a in args),
                                   min_weight=40)
    for a, b in zip(et[:2] + et[3:], ej[:2] + ej[3:]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(et[2].numpy(), np.asarray(ej[2]), atol=LIE_TOL)
    # Vertices: the drifted poses with the loop measurement set to truth.
    gt = loop_map["gt"]
    Sji = np.asarray(ej[2]).copy()
    ei_np, ej_np = np.asarray(ej[0]), np.asarray(ej[1])
    hit = (ei_np == 0) & (ej_np == M - 1)
    Sji[hit] = (gt[M - 1] @ np.linalg.inv(gt[0])).astype(np.float32)
    fixed = np.zeros(32, bool)
    fixed[0] = True
    # Stereo fixes the scale; the free-scale graph is the monocular one.
    ref = jpg.optimize_pose_graph(jnp.asarray(d["kf_Tcw"]), jnp.asarray(d["kf_valid"]), jnp.asarray(fixed), ej[0],
                                  ej[1], jnp.asarray(Sji), ej[3], n_iters=10, fix_scale=fix_scale)
    got = tpg.optimize_pose_graph(torch.tensor(d["kf_Tcw"]), torch.tensor(d["kf_valid"]), torch.tensor(fixed), et[0],
                                  et[1], torch.tensor(Sji), et[3], n_iters=10, fix_scale=fix_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=PG_TOL)
    assert np.abs(np.asarray(ref) - d["kf_Tcw"]).max() > 1e-2  # the graph really moved


# ---------------------------------------------------------------------------
# Flat bundle adjustment, both branches
# ---------------------------------------------------------------------------


def _flat_problem(n_cams, n_pts, seed):
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy = CAM
    bf = 40.0
    # Camera c looks down +z from (0.3 c, 0, 0), slightly rotated.
    Tw = [np.asarray(jlie.se3_exp(jnp.asarray(np.r_[-0.3 * c, rng.normal(0, 0.05, 2), rng.normal(0, 0.02, 3)],
                                              jnp.float32))) for c in range(n_cams)]
    span = 0.3 * n_cams
    pts = np.stack([rng.uniform(-2, span + 2, n_pts), rng.uniform(-2, 2, n_pts), rng.uniform(5, 12, n_pts)], 1)
    obs = []
    for p in range(n_pts):
        near = np.argsort(np.abs(0.3 * np.arange(n_cams) - pts[p, 0]))[:8]
        for c in rng.choice(near, rng.integers(4, 8), replace=False):
            pc = Tw[c][:3, :3] @ pts[p] + Tw[c][:3, 3]
            u, v = fx * pc[0] / pc[2] + cx, fy * pc[1] / pc[2] + cy
            if pc[2] < 1.0 or not (0 <= u < 640 and 0 <= v < 480):
                continue
            octv = rng.integers(0, 4)
            noise = rng.normal(0, 0.5 * 1.2 ** octv, 3)
            if rng.random() < 0.05:
                noise += rng.uniform(20, 40, 3)
            ur = u - bf / pc[2] + noise[2] if rng.random() < 0.5 else -1.0
            obs.append((c, p, u + noise[0], v + noise[1], ur, 1.0 / 1.2 ** (2 * octv)))
    obs = np.array(obs)
    cam_T = np.stack([np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.01, 6), jnp.float32))) @ T if c % 4 else T
                      for c, T in enumerate(Tw)]).astype(np.float32)
    O = len(obs)
    mask = np.ones(O, bool)
    mask[-3:] = False
    return {
        "cam_Tcw": cam_T, "cam_fixed": np.arange(n_cams) % 4 == 0,  # anchors keep the chain well conditioned
        "pt_pos": (pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32), "pt_valid": rng.random(n_pts) < 0.97,
        "obs_cam": obs[:, 0].astype(np.int32), "obs_pt": obs[:, 1].astype(np.int32),
        "obs_uv": obs[:, 2:4].astype(np.float32), "obs_ur": obs[:, 4].astype(np.float32),
        "obs_inv_sigma2": obs[:, 5].astype(np.float32), "obs_mask": mask,
    }


@pytest.mark.parametrize("n_cams,n_pts,branch", [(8, 256, "dense"), (96, 600, "pcg")])
def test_bundle_adjust_flat(n_cams, n_pts, branch):
    d = _flat_problem(n_cams, n_pts, seed=n_cams)
    assert (n_cams * 6 <= 512 and n_pts * n_cams <= 1 << 21) == (branch == "dense")
    fx, fy, cx, cy = CAM
    ref, lam_j = jba.bundle_adjust(jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()}), fx, fy, cx, cy, 40.0,
                                   n_iters=6, cg_iters=48, return_lam=True)
    got, lam_t = tba.bundle_adjust(bridge.flat_ba_problem_from_numpy(d, "cpu"), fx, fy, cx, cy, 40.0, n_iters=6,
                                   cg_iters=48, return_lam=True)
    np.testing.assert_allclose(got.cam_Tcw.numpy(), np.asarray(ref.cam_Tcw), atol=BA_POSE_TOL)
    np.testing.assert_allclose(got.pt_pos.numpy(), np.asarray(ref.pt_pos), atol=BA_PT_TOL)
    assert float(lam_t) == pytest.approx(float(lam_j))
    assert np.abs(np.asarray(ref.cam_Tcw) - d["cam_Tcw"]).max() > 1e-3  # it moved
    mj = jba.classify_outliers(ref, fx, fy, cx, cy, 40.0)
    mt = tba.classify_outliers(got, fx, fy, cx, cy, 40.0)
    assert np.array_equal(mt.numpy(), np.asarray(mj))


# ---------------------------------------------------------------------------
# Loop correction, global BA, asynchronous GBA
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corrected(loop_map):
    d = loop_map
    args = (jnp.int32(M - 1), jnp.int32(0), jnp.asarray(d["S"]), jnp.asarray(d["loop_pts"]), jnp.asarray(d["kp"]))
    ref = _np(jlc.correct_loop_state(CJ, _jstate(d["state"]), *args))
    got = tlc.correct_loop_state(CT, _tstate(d["state"]), M - 1, 0, torch.tensor(d["S"]),
                                 torch.tensor(d["loop_pts"]), torch.tensor(d["kp"], dtype=torch.int64))
    return ref, got


def _kf_ate(kf_Tcw, gt):
    c = lambda T: -T[:3, :3].T @ T[:3, 3]  # noqa: E731
    return float(np.sqrt(np.mean([np.sum((c(a) - c(b)) ** 2) for a, b in zip(kf_Tcw[:M], gt)])))


def test_correct_loop_state(loop_map, corrected):
    ref, got = corrected
    assert_maps_close(got, ref, LOOP_POSE_TOL, LOOP_PT_TOL, "corrected map")
    check_obs_invariants(type("S", (), bridge.map_state_to_numpy(got)))
    assert ref["loop_edges"][M - 1, 0] and ref["mp_valid"].sum() < loop_map["state"]["mp_valid"].sum()
    assert _kf_ate(ref["kf_Tcw"], loop_map["gt"]) < 0.85 * _kf_ate(loop_map["state"]["kf_Tcw"], loop_map["gt"])


def test_global_ba(loop_map, corrected):
    ref, got = corrected
    cam = CJ.camera
    pj = jlc.extract_global_ba(CJ, _jstate(ref), max_obs=8192)
    pt = tlc.extract_global_ba(CT, got, max_obs=8192)
    for k, v in bridge.flat_ba_problem_to_numpy(pt).items():
        np.testing.assert_allclose(v, np.asarray(getattr(pj, k)), rtol=0, atol=LOOP_POSE_TOL if k == "cam_Tcw" else
                                   LOOP_PT_TOL if k == "pt_pos" else 0, err_msg=k)
    pj = jba.bundle_adjust(pj, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, n_iters=15, cg_iters=64)
    pt = tba.bundle_adjust(pt, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, n_iters=15, cg_iters=64)
    sj = jlc.writeback_global_ba(CJ, _jstate(ref), pj)
    st = tlc.writeback_global_ba(CT, got, pt)
    assert_maps_close(st, sj, GBA_POSE_TOL, GBA_PT_TOL, "after global BA")
    gt = loop_map["gt"]
    assert _kf_ate(np.asarray(sj.kf_Tcw), gt) < 0.35 * _kf_ate(loop_map["state"]["kf_Tcw"], gt)


def test_global_ba_counts_dropped_observations(corrected):
    _, got = corrected
    m = bridge.map_state_to_numpy(got)
    kf_mp = m["kf_mp"]
    live = (kf_mp >= 0) & m["kf_kp_valid"] & m["kf_valid"][:, None]
    live &= m["mp_valid"][np.clip(kf_mp, 0, None)]
    n_live = int(live.sum())
    assert 0 < n_live < 8192
    for max_obs, dropped in ((n_live - 37, 37), (n_live, 0), (8192, 0)):
        assert int(tlc.global_ba_obs_dropped(got, max_obs)) == dropped
        assert int(tlc.extract_global_ba(CT, got, max_obs=max_obs).obs_mask.sum()) == n_live - dropped
    assert int(tlc.AsyncGba(CT, got, n_kf_start=M, n_iters=1).obs_dropped) == 0


def test_async_gba_with_midflight_keyframe(loop_map, corrected):
    ref, got = corrected
    gj = jlc.AsyncGba(CJ, _jstate(ref), n_kf_start=M, n_iters=12)
    gt_ = tlc.AsyncGba(CT, got, n_kf_start=M, n_iters=12)
    T_rel = np.asarray(jlie.se3_exp(jnp.asarray([0.05, 0.0, 0.2, 0.0, 0.02, 0.0], jnp.float32)))
    T_new = (T_rel @ ref["kf_Tcw"][M - 1]).astype(np.float32)
    rows = {k: ref[k][M - 1] for k in ("kf_uv", "kf_ur", "kf_depth", "kf_octave", "kf_angle", "kf_desc",
                                        "kf_kp_valid", "kf_mp")}
    sj, _ = jms.insert_keyframe(_jstate(ref), jnp.asarray(T_new), jnp.int32(999), jnp.float32(9.9),
                                *(jnp.asarray(rows[k]) for k in rows))
    t_rows = bridge.map_state_to_numpy(got)
    st, _ = tms.insert_keyframe(got, torch.tensor(T_new), 999, 9.9,
                                *(torch.tensor(t_rows[k][M - 1].view(np.int32)) if k == "kf_desc" else
                                  torch.tensor(t_rows[k][M - 1]).long() if t_rows[k].dtype.kind == "i" else
                                  torch.tensor(t_rows[k][M - 1]) for k in rows))
    assert int(st.kf_parent[M]) == int(sj.kf_parent[M]) == M - 1
    for _ in range(12):
        gj.step()
        gt_.step()
    assert gj.finished and gt_.finished
    aj, at = gj.apply(sj), gt_.apply(st)
    assert_maps_close(at, aj, GBA_POSE_TOL, GBA_PT_TOL, "async GBA")
    rel = at.kf_Tcw[M].numpy() @ np.linalg.inv(at.kf_Tcw[M - 1].numpy())
    np.testing.assert_allclose(rel, T_rel, atol=1e-4)


# ---------------------------------------------------------------------------
# LoopCloser: detection, consistency, Sim3, correction, GBA ticks
# ---------------------------------------------------------------------------


def test_loop_closer_process(loop_map):
    """Four detections of the revisit keyframe build the 3-deep consistency
    chain; drain resolves them (the 4th is consistent), closes the loop and
    starts the asynchronous GBA, which ticks to completion."""
    d = loop_map["state"]
    jv = jvio.load_packed(jvio._FALLBACK_ASSET)
    tv = tvio.load_packed(jvio._FALLBACK_ASSET, device="cpu")
    jdb = jkdb.init_db(32, d["kf_uv"].shape[1], jv.n_words)
    for k in range(M):
        jdb = jkdb.add_keyframe(jdb, jnp.int32(k), jv.words(jnp.asarray(d["kf_desc"][k])), jnp.asarray(d["kf_kp_valid"][k]))
    tdb = bridge.kf_database_from_numpy(jdb, "cpu")
    jl, tl = jlc.LoopCloser(CJ, jv), tlc.LoopCloser(CT, tv, "cpu", draws=LoopKeyChain())
    sj, st = _jstate(d), _tstate(d)
    for _ in range(4):
        sj, cj = jl.process(sj, jdb, M - 1, n_docs=M)
        st, ct = tl.process(st, tdb, M - 1, n_docs=M)
        assert cj == ct is False
    assert [np.asarray(p) for _, p in jl._pending_detect][-1].tolist() == tl._pending_detect[-1][1].tolist()
    sj, cj = jl.drain(sj)
    st, ct = tl.drain(st)
    assert cj and ct and jl.loops_closed == tl.loops_closed == 1 and tl.last_loop_kf == M - 1
    # Closed with the estimated Sim3 (6e-8 apart here), not the true one.
    assert_maps_close(st, sj, CLOSER_POSE_TOL, CLOSER_PT_TOL, "closed loop")
    applied = []
    for _ in range(CJ.loop.global_ba_iters + 1):
        sj, aj = jl.tick(sj)
        st, at = tl.tick(st)
        applied.append((aj, at))
    assert applied[-1] == (True, True) and not any(a or b for a, b in applied[:-1])
    assert jl.gbas_completed == tl.gbas_completed == 1 and int(tl.gba_obs_dropped) == 0
    assert_maps_close(st, sj, CLOSER_POSE_TOL, CLOSER_PT_TOL, "after the asynchronous GBA")


# ---------------------------------------------------------------------------
# The monocular (free-scale) loop: a scaled copy of the drifted loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mono_loop_map(loop_map):
    """The drifted loop as a monocular map whose revisit keyframe drifted in
    scale: keyframe M - 1's translation and the points it created scaled by
    SCALE (its own observations of them unchanged), no stereo
    measurements, counts and geometry rebuilt by the reference. The true
    Sim3 from keyframe 0's camera to keyframe M - 1's is then SCALE times
    the rigid one."""
    d = {k: v.copy() for k, v in loop_map["state"].items()}
    d["kf_Tcw"][M - 1, :3, 3] *= SCALE
    dup = d["mp_valid"] & (d["mp_ref_kf"] == M - 1)
    d["mp_pos"][dup] *= SCALE
    d["kf_ur"][:] = -1.0
    d["kf_depth"][:] = -1.0
    state = jms.rebuild_obs_index(_jstate(d))
    state = jms.update_point_geometry(state, state.mp_valid, CJ.orb.scale_factor, CJ.orb.n_levels)
    S = np.diag([SCALE, SCALE, SCALE, 1.0]).astype(np.float32) @ loop_map["S"]
    return {"state": _np(state), "S": S, "gt": loop_map["gt"], "kp": loop_map["kp"], "loop_pts": loop_map["loop_pts"],
            "n_dup": int(dup.sum())}


def test_match_and_sim3_free_scale(mono_loop_map):
    """The mono loop closer's Sim3 RANSAC + LM recovers the revisit's scale;
    the port's equals the reference's, and so does the loop-point count."""
    d = mono_loop_map["state"]
    assert mono_loop_map["n_dup"] > 40 and not (d["kf_ur"] >= 0).any()
    _, k1 = jax.random.split(jax.random.PRNGKey(11))
    ok_j, S_j, n_j, idx_j, mok_j = jlc.match_and_sim3(CJ_MONO, _jstate(d), jnp.int32(M - 1), jnp.int32(0), k1)
    ok_t, S_t, n_t, idx_t, mok_t = tlc.match_and_sim3(CT_MONO, _tstate(d), M - 1, 0,
                                                      LoopKeyChain()((128, d["kf_mp"].shape[1])))
    assert bool(ok_j) and bool(ok_t) and int(n_t) == int(n_j)
    assert np.array_equal(idx_t.numpy(), np.asarray(idx_j)) and np.array_equal(mok_t.numpy(), np.asarray(mok_j))
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), atol=SIM3_TOL)
    s = float(tlie.sim3_scale(S_t))
    assert abs(s - SCALE) < 0.02, s  # the free-scale branch: a rigid fit would give 1
    nj, lpj, kpj = jlc.count_loop_point_matches(CJ_MONO, _jstate(d), jnp.int32(M - 1), jnp.int32(0), S_j)
    nt, lpt, kpt = tlc.count_loop_point_matches(CT_MONO, _tstate(d), M - 1, 0, torch.tensor(np.asarray(S_j)))
    assert int(nt) == int(nj) >= CJ.loop.min_total_matches
    assert np.array_equal(lpt.numpy(), np.asarray(lpj)) and np.array_equal(kpt.numpy(), np.asarray(kpj))


def test_correct_loop_state_free_scale(mono_loop_map):
    """correct_loop_state under the Sim3 with s = SCALE on the mono map: the
    corrected group's points move with the scale. Integers exact, poses
    within PG_TOL, points within LOOP_PT_TOL."""
    d = mono_loop_map
    args = (jnp.int32(M - 1), jnp.int32(0), jnp.asarray(d["S"]), jnp.asarray(d["loop_pts"]), jnp.asarray(d["kp"]))
    ref = _np(jlc.correct_loop_state(CJ_MONO, _jstate(d["state"]), *args))
    got = tlc.correct_loop_state(CT_MONO, _tstate(d["state"]), M - 1, 0, torch.tensor(d["S"]),
                                 torch.tensor(d["loop_pts"]), torch.tensor(d["kp"], dtype=torch.int64))
    assert_maps_close(got, ref, PG_TOL, LOOP_PT_TOL, "free-scale corrected map")
    check_obs_invariants(type("S", (), bridge.map_state_to_numpy(got)))
    assert ref["loop_edges"][M - 1, 0]
    moved = np.linalg.norm(ref["mp_pos"] - d["state"]["mp_pos"], axis=1)[ref["mp_valid"]]
    assert moved.max() > 0.1  # the Sim3 with s != 1 moved the corrected group's points


def test_loop_closer_process_free_scale(mono_loop_map):
    """LoopCloser on the mono map: detection, consistency, the free-scale
    Sim3 and the correction against the reference within the closer's
    tolerances; then the asynchronous GBA. A monocular global BA with one
    fixed keyframe leaves the scale free and the depth of points seen over a
    short baseline ill-conditioned, so f32 order moves its solution: on this
    map the two land 0.036 m apart in camera centres and up to 0.24 m in
    points, with rotations within 2e-6 (measured). After it, integers
    identical, rotations within CLOSER_POSE_TOL, and both keyframe ATEs
    under a tenth of the drifted map's."""
    d = mono_loop_map["state"]
    jv = jvio.load_packed(jvio._FALLBACK_ASSET)
    tv = tvio.load_packed(jvio._FALLBACK_ASSET, device="cpu")
    jdb = jkdb.init_db(32, d["kf_uv"].shape[1], jv.n_words)
    for k in range(M):
        jdb = jkdb.add_keyframe(jdb, jnp.int32(k), jv.words(jnp.asarray(d["kf_desc"][k])), jnp.asarray(d["kf_kp_valid"][k]))
    tdb = bridge.kf_database_from_numpy(jdb, "cpu")
    jl, tl = jlc.LoopCloser(CJ_MONO, jv), tlc.LoopCloser(CT_MONO, tv, "cpu", draws=LoopKeyChain())
    sj, st = _jstate(d), _tstate(d)
    for _ in range(4):
        sj, cj = jl.process(sj, jdb, M - 1, n_docs=M)
        st, ct = tl.process(st, tdb, M - 1, n_docs=M)
        assert cj == ct is False
    sj, cj = jl.drain(sj)
    st, ct = tl.drain(st)
    assert cj and ct and jl.loops_closed == tl.loops_closed == 1
    (kf, cand, S12), = tl.closures
    assert (kf, cand) == (M - 1, 0) and abs(float(tlie.sim3_scale(S12)) - SCALE) < 0.02
    assert_maps_close(st, sj, CLOSER_POSE_TOL, CLOSER_PT_TOL, "closed free-scale loop")
    for _ in range(CJ.loop.global_ba_iters + 1):
        sj, aj = jl.tick(sj)
        st, at = tl.tick(st)
        assert aj == at
    assert jl.gbas_completed == tl.gbas_completed == 1
    a, r = bridge.map_state_to_numpy(st), _np(sj)
    for k, v in r.items():
        if v.dtype.kind in "biu":
            assert np.array_equal(a[k], v), f"after the asynchronous GBA (mono): integer field {k}"
    np.testing.assert_allclose(a["kf_Tcw"][:M, :3, :3], r["kf_Tcw"][:M, :3, :3], rtol=0, atol=CLOSER_POSE_TOL)
    gt, before = mono_loop_map["gt"], _kf_ate(d["kf_Tcw"], mono_loop_map["gt"])
    assert max(_kf_ate(a["kf_Tcw"], gt), _kf_ate(r["kf_Tcw"], gt)) < 0.1 * before
