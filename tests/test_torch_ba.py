"""Dense local bundle adjustment (ops/ba.py), JAX reference vs PyTorch port,
on the CPU, on a seeded problem: 8 cameras (the first 4 may be free, the
rest fixed anchors), 256 points, 16 entries per point (one per camera, the
rest empty), mono and stereo observations, 10% gross outliers, perturbed
starting poses and points.

Tolerances: masks identical; poses within 1e-4 (matrix entries), points
within 1e-3 m (points 4-12 m away); costs within 1e-4 relative. The problem
is well conditioned (every point seen by >= 5 cameras), so only f32
summation order differs between the two."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from my_orb_slam2_tpu.ops import ba as jba
from my_orb_slam2_tpu.ops import lie as jlie
from my_orb_slam2_tpu_torch.ops import ba as tba
from my_orb_slam2_tpu_torch.ops import lie as tlie
from my_orb_slam2_tpu_torch.utils import bridge

C, P, K, N_FREE = 8, 256, 16, 4
CAM = (500.0, 500.0, 320.0, 240.0, 40.0)
POSE_TOL = 1e-4
PT_TOL = 1e-3


def _se3(xi):
    return np.asarray(jlie.se3_exp(jnp.asarray(xi, jnp.float32)), np.float64)


def make_problem(seed=0):
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy, bf = CAM
    Tw = [_se3(np.r_[rng.normal(0, 0.3, 3) + [0.4 * c, 0, 0], rng.normal(0, 0.05, 3)]) for c in range(C)]
    pts = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(4, 12, P)], 1)
    e_cam = np.full((P, K), -1, np.int32)
    e_uv = np.zeros((P, K, 2), np.float32)
    e_ur = np.full((P, K), -1.0, np.float32)
    e_is2 = np.ones((P, K), np.float32)
    e_mask = np.zeros((P, K), bool)
    for p in range(P):
        cams = rng.choice(C, rng.integers(5, C + 1), replace=False)
        for k, c in enumerate(cams):
            pc = Tw[c][:3, :3] @ pts[p] + Tw[c][:3, 3]
            u, v = fx * pc[0] / pc[2] + cx, fy * pc[1] / pc[2] + cy
            octv = rng.integers(0, 4)
            noise = rng.normal(0, 0.5 * 1.2 ** octv, 3)
            if rng.random() < 0.1:  # gross outlier
                noise += rng.choice([-1, 1], 3) * rng.uniform(20, 40, 3)
            e_cam[p, k] = c
            e_uv[p, k] = (u + noise[0], v + noise[1])
            if rng.random() < 0.5:
                e_ur[p, k] = u - bf / pc[2] + noise[2]
            e_is2[p, k] = 1.0 / 1.2 ** (2 * octv)
            e_mask[p, k] = True
    cam_T = np.stack([_se3(rng.normal(0, 0.01, 6)) @ T if c < N_FREE else T for c, T in enumerate(Tw)])
    pt_valid = rng.random(P) < 0.97
    return {
        "cam_Tcw": cam_T.astype(np.float32),
        "cam_fixed": np.arange(C) >= N_FREE - 1,  # cameras 3..7 fixed: one free-block camera pinned
        "pt_pos": (pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32),
        "pt_valid": pt_valid,
        "e_cam": e_cam, "e_uv": e_uv, "e_ur": e_ur, "e_inv_sigma2": e_is2, "e_mask": e_mask,
    }


@pytest.fixture(scope="module")
def problem():
    d = make_problem()
    return d, jba.DenseBAProblem(**{k: jnp.asarray(v) for k, v in d.items()}), bridge.ba_problem_from_numpy(d, "cpu")


def test_inv3x3():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    M = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    M[0] = 0.0  # singular: the |det| guard
    ref = np.asarray(jba._inv3x3(jnp.asarray(M)))
    out = tba._inv3x3(torch.tensor(M)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_se3_exp_batch():
    rng = np.random.default_rng(2)
    xi = rng.normal(0, 0.5, (20, 6)).astype(np.float32)
    xi[0] = 0.0
    xi[1, 3:] = 1e-6  # below the small-angle switch
    ref = np.stack([np.asarray(jlie.se3_exp(jnp.asarray(x))) for x in xi])
    np.testing.assert_allclose(tlie.se3_exp_batch(torch.tensor(xi)).numpy(), ref, rtol=0, atol=1e-6)


def test_classify_outliers_dense(problem):
    d, pj, pt = problem
    ref = np.asarray(jba.classify_outliers_dense(pj, *CAM))
    out = tba.classify_outliers_dense(pt, *CAM).numpy()
    assert np.array_equal(out, ref)
    assert 0 < (d["e_mask"] & ~ref).sum() < d["e_mask"].sum()


@pytest.mark.parametrize("use_huber", [True, False])
def test_lm_step_dense(problem, use_huber):
    d, pj, pt = problem
    lam, cost = 1e-4, 3.4e38
    rj = jba.lm_step_dense(pj, pj.cam_Tcw, pj.pt_pos, jnp.float32(cost), jnp.float32(lam), *CAM,
                           use_huber=use_huber, n_free=N_FREE)
    rt = tba.lm_step_dense(pt, pt.cam_Tcw, pt.pt_pos, cost, lam, *CAM, use_huber=use_huber, n_free=N_FREE)
    np.testing.assert_allclose(rt[0].cam_Tcw.numpy(), np.asarray(rj[0].cam_Tcw), rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(rt[0].pt_pos.numpy(), np.asarray(rj[0].pt_pos), rtol=0, atol=PT_TOL)
    np.testing.assert_allclose(float(rt[3]), float(rj[3]), rtol=1e-4)
    assert float(rt[4]) == float(rj[4])
    # the fixed cameras never move
    assert np.array_equal(rt[0].cam_Tcw.numpy()[N_FREE - 1:], d["cam_Tcw"][N_FREE - 1:])


def test_bundle_adjust_dense_carry(problem):
    d, pj, pt = problem
    oj = jba.bundle_adjust_dense(pj, *CAM, n_iters=4, n_free=N_FREE, return_carry=True)
    ot = tba.bundle_adjust_dense(pt, *CAM, n_iters=4, n_free=N_FREE, return_carry=True)
    np.testing.assert_allclose(float(ot[3]), float(oj[3]), rtol=1e-4)
    np.testing.assert_allclose(ot[1].numpy(), np.asarray(oj[1]), rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(ot[2].numpy(), np.asarray(oj[2]), rtol=0, atol=PT_TOL)


def test_local_ba_dense(problem):
    d, pj, pt = problem
    prob_j, mask_j = jba.local_ba_dense(pj, *CAM, iters1=3, iters2=4, n_free=N_FREE)
    prob_t, mask_t = tba.local_ba_dense(pt, *CAM, iters1=3, iters2=4, n_free=N_FREE)
    assert np.array_equal(prob_t.e_mask.numpy(), np.asarray(prob_j.e_mask))
    assert np.array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_allclose(prob_t.cam_Tcw.numpy(), np.asarray(prob_j.cam_Tcw), rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(prob_t.pt_pos.numpy(), np.asarray(prob_j.pt_pos), rtol=0, atol=PT_TOL)
    out = bridge.ba_problem_to_numpy(prob_t)
    assert out["e_cam"].dtype == np.int32 and np.array_equal(out["e_cam"], d["e_cam"])
    # the outliers were demoted and the free cameras moved toward the truth
    assert (d["e_mask"] & ~np.asarray(mask_j)).sum() >= 0.05 * d["e_mask"].sum()


def test_singular_window_stays_finite():
    """A free camera with no observation (zero U diagonal) is pinned, and an
    all-masked problem returns its input unchanged."""
    d = make_problem(1)
    d["e_mask"] = d["e_mask"] & (d["e_cam"] != 0)
    d["e_cam"] = np.where(d["e_mask"], d["e_cam"], -1)
    pj = jba.DenseBAProblem(**{k: jnp.asarray(v) for k, v in d.items()})
    rj = jba.bundle_adjust_dense(pj, *CAM, n_iters=2, n_free=N_FREE)
    rt = tba.bundle_adjust_dense(bridge.ba_problem_from_numpy(d, "cpu"), *CAM, n_iters=2, n_free=N_FREE)
    assert np.isfinite(rt.cam_Tcw.numpy()).all()
    np.testing.assert_allclose(rt.cam_Tcw.numpy(), np.asarray(rj.cam_Tcw), rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(rt.cam_Tcw.numpy()[0], d["cam_Tcw"][0], rtol=0, atol=0)
    d["e_mask"][:] = False
    rt = tba.bundle_adjust_dense(bridge.ba_problem_from_numpy(d, "cpu"), *CAM, n_iters=2, n_free=N_FREE)
    assert np.array_equal(rt.cam_Tcw.numpy(), d["cam_Tcw"]) and np.array_equal(rt.pt_pos.numpy(), d["pt_pos"])
