"""Parity of the PyTorch geometry (ops.lie, ops.projection, ops.pose_opt)
against the JAX reference, on the CPU, with numpy inputs from a seed."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from my_orb_slam2_tpu.ops import lie as jlie
from my_orb_slam2_tpu.ops import pose_opt as jpo
from my_orb_slam2_tpu.ops import projection as jproj
from my_orb_slam2_tpu_torch.ops import lie as tlie
from my_orb_slam2_tpu_torch.ops import pose_opt as tpo
from my_orb_slam2_tpu_torch.ops import projection as tproj

# f32 elementwise geometry: both sides evaluate the same formulas, so they
# differ only by a few ulps of O(1) quantities.
GEO_TOL = 1e-5
FX, FY, CX, CY, BF = 500.0, 500.0, 320.0, 240.0, 40.0


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(port, ref, tol=GEO_TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=tol)


@pytest.mark.parametrize("scale", [0.0, 1e-6, 1e-3, 0.5, 2.0, 3.1])
def test_so3_se3_exp_log(scale):
    rng = np.random.default_rng(int(scale * 1000) + 1)
    axis = rng.normal(size=3)
    phi = (axis / np.linalg.norm(axis) * scale).astype(np.float32)
    xi = np.concatenate([rng.normal(size=3), phi]).astype(np.float32)
    _close(tlie.so3_exp(_t(phi)), jlie.so3_exp(jnp.asarray(phi)))
    R = np.asarray(jlie.so3_exp(jnp.asarray(phi)))
    _close(tlie.so3_log(_t(R)), jlie.so3_log(jnp.asarray(R)))
    T = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    _close(tlie.se3_exp(_t(xi)), T)
    _close(tlie.se3_inverse(_t(T)), jlie.se3_inverse(jnp.asarray(T)))
    pts = rng.normal(size=(7, 3)).astype(np.float32)
    _close(tlie.se3_apply(_t(T), _t(pts)), jlie.se3_apply(jnp.asarray(T), jnp.asarray(pts)))


def test_rotation_to_quaternion_all_branches():
    # trace > 0, and each of the x / y / z dominant branches (rotations by
    # ~pi about each axis).
    for phi in ([0.1, 0.2, 0.3], [3.0, 0.1, 0.0], [0.0, 3.0, 0.2], [0.1, 0.0, 3.0]):
        R = np.asarray(jlie.so3_exp(jnp.asarray(phi, jnp.float32)))
        _close(tlie.rotation_to_quaternion(_t(R)), jlie.rotation_to_quaternion(jnp.asarray(R)))


def test_se3_from_Rt_and_orthonormalize():
    rng = np.random.default_rng(3)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3).astype(np.float32))))
    t = rng.normal(size=3).astype(np.float32)
    T = np.asarray(jlie.se3_from_Rt(jnp.asarray(R), jnp.asarray(t)))
    _close(tlie.se3_from_Rt(_t(R), _t(t)), T)
    Tn = T + 1e-3 * rng.normal(size=(4, 4)).astype(np.float32)
    _close(tlie.se3_orthonormalize(_t(Tn)), jlie.se3_orthonormalize(jnp.asarray(Tn)))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(11)
    pts = np.stack([rng.uniform(-8, 8, 300), rng.uniform(-5, 5, 300), rng.uniform(-2, 30, 300)], 1)
    xi = np.array([0.2, -0.1, 0.3, 0.02, -0.05, 0.01], np.float32)
    T = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    return pts.astype(np.float32), T


def test_projection_functions(scene):
    pts, T = scene
    uvr_j, z_j = jproj.project_stereo(jnp.asarray(T), jnp.asarray(pts), FX, FY, CX, CY, BF)
    uvr_t, z_t = tproj.project_stereo(_t(T), _t(pts), FX, FY, CX, CY, BF)
    front = np.asarray(z_j) > 0.5
    np.testing.assert_allclose(uvr_t.numpy()[front], np.asarray(uvr_j)[front], rtol=1e-6, atol=1e-3)
    _close(z_t, z_j)
    uv = np.asarray(uvr_j)[front, :2]
    z = np.asarray(z_j)[front]
    _close(tproj.backproject(_t(uv), _t(z), FX, FY, CX, CY), jproj.backproject(jnp.asarray(uv), jnp.asarray(z), FX, FY, CX, CY), tol=1e-4)
    k = (-0.2, 0.05, 1e-3, -2e-3, 0.01)
    _close(
        tproj.undistort_points(_t(uv), FX, FY, CX, CY, *k),
        jproj.undistort_points(jnp.asarray(uv), FX, FY, CX, CY, *k),
        tol=1e-3,
    )


def test_frustum_and_predict_scale(scene):
    pts, T = scene
    rng = np.random.default_rng(5)
    normals = rng.normal(size=pts.shape).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    dist = np.linalg.norm(pts, axis=1)
    min_d = (dist * rng.uniform(0.3, 1.1, len(pts))).astype(np.float32)
    max_d = (dist * rng.uniform(0.9, 3.0, len(pts))).astype(np.float32)
    args = (FX, FY, CX, CY, 0.0, 640.0, 0.0, 480.0)
    ref = jproj.frustum_check(jnp.asarray(T), jnp.asarray(pts), jnp.asarray(normals), jnp.asarray(min_d), jnp.asarray(max_d), *args)
    port = tproj.frustum_check(_t(T), _t(pts), _t(normals), _t(min_d), _t(max_d), *args)
    assert np.array_equal(port[0].numpy(), np.asarray(ref[0]))
    for p, r in zip(port[2:], ref[2:]):
        _close(p, r, tol=1e-4)
    lvl_j = jproj.predict_scale(ref[3], jnp.asarray(max_d), float(np.log(1.2)), 8)
    lvl_t = tproj.predict_scale(port[3], _t(max_d), float(np.log(1.2)), 8)
    assert np.array_equal(lvl_t.numpy(), np.asarray(lvl_j))


def test_solve6_block_schur():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(6, 6))
    H = (A @ A.T + 6 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    _close(tpo._solve6(_t(H), _t(b)), jpo._solve6(jnp.asarray(H), jnp.asarray(b)), tol=1e-5)


# Pose optimization: 40 LM steps of f32 normal equations summed in another
# order; on a well-conditioned stereo problem the poses agree to 1e-4 and
# the inlier classification is identical.
POSE_TOL = 1e-4


@pytest.mark.parametrize("stereo_fraction", [1.0, 0.5])
def test_pose_optimization(scene, stereo_fraction):
    pts, T_true = scene
    rng = np.random.default_rng(int(stereo_fraction * 10))
    uvr, z = jproj.project_stereo(jnp.asarray(T_true), jnp.asarray(pts), FX, FY, CX, CY, BF)
    uvr, z = np.asarray(uvr), np.asarray(z)
    mask = (z > 1.0) & (uvr[:, 0] > 0) & (uvr[:, 0] < 640) & (uvr[:, 1] > 0) & (uvr[:, 1] < 480)
    uv = (uvr[:, :2] + rng.normal(0, 0.5, (len(pts), 2))).astype(np.float32)
    ur = (uvr[:, 2] + rng.normal(0, 0.5, len(pts))).astype(np.float32)
    ur = np.where(rng.random(len(pts)) < stereo_fraction, ur, -1.0).astype(np.float32)
    # 10% gross outliers.
    out = rng.random(len(pts)) < 0.1
    uv[out] += rng.uniform(20, 60, (out.sum(), 2)).astype(np.float32)
    octave = rng.integers(0, 4, len(pts))
    inv_s2 = (1.0 / 1.2 ** (2 * octave)).astype(np.float32)
    T0 = np.asarray(jlie.se3_exp(jnp.asarray(np.array([0.05, 0.02, -0.04, 0.01, 0.005, -0.01], np.float32)))) @ T_true
    T0 = T0.astype(np.float32)
    ref = jpo.pose_optimization(
        jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(ur), jnp.asarray(inv_s2),
        jnp.asarray(mask), FX, FY, CX, CY, BF,
    )
    port = tpo.pose_optimization(_t(T0), _t(pts), _t(uv), _t(ur), _t(inv_s2), torch.tensor(mask), FX, FY, CX, CY, BF)
    _close(port["Tcw"], ref["Tcw"], tol=POSE_TOL)
    assert np.array_equal(port["inliers"].numpy(), np.asarray(ref["inliers"]))
    assert int(port["n_inliers"]) == int(ref["n_inliers"]) > 0.8 * mask.sum()
    np.testing.assert_allclose(port["chi2"].numpy()[mask], np.asarray(ref["chi2"])[mask], rtol=1e-2, atol=1e-2)
