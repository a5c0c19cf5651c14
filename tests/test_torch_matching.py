"""Parity of the PyTorch matchers (ops.matching, ops.stereo) against the JAX
reference, on the CPU. Indices and masks must be identical; stereo u_right
and depth agree within the stated tolerance."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from my_orb_slam2_tpu.models.frame import FrameFactory as JFrameFactory
from my_orb_slam2_tpu.ops import matching as jm
from my_orb_slam2_tpu.ops import stereo as jst
from my_orb_slam2_tpu.ops.frontend import GAP
from my_orb_slam2_tpu.utils import config as jcfg
from my_orb_slam2_tpu_torch.ops import matching as tm
from my_orb_slam2_tpu_torch.ops import stereo as tst
from my_orb_slam2_tpu_torch.utils.synthetic import bench_config, stereo_drive

# Stereo refinement sums 121 f32 |differences| per SAD window in another
# order than XLA; at pyramid levels above 0 the atlas is non-integer, so
# u_right moves by float rounding only (measured <= 3.1e-5 px).
UR_TOL = 1e-3
DEPTH_RTOL = 1e-4


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _flip_bits(rng, d, n_bits):
    d = d.copy()
    for _ in range(n_bits):
        word = rng.integers(0, 8, len(d))
        bit = rng.integers(0, 32, len(d)).astype(np.uint32)
        d[np.arange(len(d)), word] ^= np.uint32(1) << bit
    return d


def _ti(d):
    return torch.tensor(np.ascontiguousarray(d).view(np.int32))


def test_masked_best2_and_ratio():
    rng = np.random.default_rng(0)
    dist = rng.integers(0, 40, (50, 70)).astype(np.float32)  # many ties
    mask = rng.random((50, 70)) < 0.3
    mask[3] = False
    ref = jm.masked_best2(jnp.asarray(dist), jnp.asarray(mask))
    port = tm.masked_best2(torch.tensor(dist), torch.tensor(mask))
    for p, r in zip(port, ref):
        assert np.array_equal(p.numpy(), np.asarray(r))
    assert np.array_equal(
        tm.ratio_test(port[1], port[2], 0.8).numpy(), np.asarray(jm.ratio_test(ref[1], ref[2], 0.8))
    )


def test_one_to_one_ties():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 20, 200)
    d = rng.integers(0, 5, 200).astype(np.float32)  # equal-distance collisions
    ok = rng.random(200) < 0.8
    ref = jm.one_to_one(jnp.asarray(idx), jnp.asarray(d), jnp.asarray(ok), 20)
    port = tm.one_to_one(torch.tensor(idx), torch.tensor(d), torch.tensor(ok), 20)
    assert np.array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [2, 3])
def test_rotation_consistency(seed):
    rng = np.random.default_rng(seed)
    dang = np.concatenate([rng.normal(0.3, 0.05, 150), rng.uniform(-7, 7, 80), [0.0, 2 * np.pi, -np.pi]])
    dang = dang.astype(np.float32)
    ok = rng.random(len(dang)) < 0.9
    ref = jm.rotation_consistency(jnp.asarray(dang), jnp.asarray(ok))
    port = tm.rotation_consistency(torch.tensor(dang), torch.tensor(ok))
    assert np.array_equal(port.numpy(), np.asarray(ref))


def test_search_by_projection():
    rng = np.random.default_rng(4)
    P, K = 300, 400
    kp_uv = rng.uniform(0, 640, (K, 2)).astype(np.float32)
    kp_oct = rng.integers(0, 8, K)
    kp_valid = rng.random(K) < 0.95
    kp_desc = _desc(rng, K)
    kp_ur = np.where(rng.random(K) < 0.7, kp_uv[:, 0] - rng.uniform(1, 40, K), -1.0).astype(np.float32)
    src = rng.integers(0, K, P)
    pred_uv = (kp_uv[src] + rng.normal(0, 3, (P, 2))).astype(np.float32)
    pt_desc = _flip_bits(rng, kp_desc[src], 20)
    pred_level = kp_oct[src]
    pred_ur = (kp_ur[src] + rng.normal(0, 2, P)).astype(np.float32)
    pred_valid = rng.random(P) < 0.9
    radius = rng.uniform(3, 12, P).astype(np.float32)
    kp_taken = rng.random(K) < 0.1
    j = [jnp.asarray(a) for a in (pred_uv, pred_level, pred_valid, pt_desc, radius, kp_uv, kp_oct, kp_valid, kp_desc)]
    t = [torch.tensor(a) for a in (pred_uv, pred_level, pred_valid)] + [_ti(pt_desc)] + [
        torch.tensor(a) for a in (radius, kp_uv, kp_oct, kp_valid)] + [_ti(kp_desc)]
    kw = dict(level_lo=pred_level - 1, level_hi=pred_level + 1, max_dist=100.0, ratio=0.8)
    ref = jm.search_by_projection(*j, kp_ur=jnp.asarray(kp_ur), pred_ur=jnp.asarray(pred_ur), kp_taken=jnp.asarray(kp_taken),
                                  **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    port = tm.search_by_projection(*t, kp_ur=torch.tensor(kp_ur), pred_ur=torch.tensor(pred_ur), kp_taken=torch.tensor(kp_taken),
                                   **{k: (torch.tensor(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    for p, r in zip(port, ref):
        assert np.array_equal(p.numpy(), np.asarray(r))
    assert port[1].sum() > 100


def test_search_brute():
    rng = np.random.default_rng(5)
    N1, N2 = 256, 300
    d2 = _desc(rng, N2)
    src = rng.permutation(N2)[:N1]
    d1 = _flip_bits(rng, d2[src], 12)
    a2 = rng.uniform(-np.pi, np.pi, N2).astype(np.float32)
    a1 = (a2[src] + 0.2 + rng.normal(0, 0.03, N1)).astype(np.float32)
    v1, v2 = rng.random(N1) < 0.9, rng.random(N2) < 0.9
    ref = jm.search_brute(jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2), jnp.asarray(a1), jnp.asarray(a2))
    port = tm.search_brute(_ti(d1), torch.tensor(v1), _ti(d2), torch.tensor(v2), torch.tensor(a1), torch.tensor(a2))
    for p, r in zip(port, ref):
        assert np.array_equal(p.numpy(), np.asarray(r))
    assert port[1].sum() > 100


def test_nanmedian_even_count():
    x = torch.tensor([4.0, 1.0, 3.0, 2.0, 9.0])
    ok = torch.tensor([True, True, True, True, False])
    assert float(tst._nanmedian_masked(x, ok)) == float(jnp.nanmedian(jnp.asarray([4.0, 1.0, 3.0, 2.0, np.nan]))) == 2.5
    assert np.isnan(float(tst._nanmedian_masked(x, torch.zeros(5, dtype=torch.bool))))


def test_match_stereo_same_inputs():
    """Both matchers on the JAX extractor's keypoints and atlases of one
    rendered stereo pair from the bench drive."""
    ct = bench_config(240, 320, 300)
    cj = jcfg.SlamConfig(
        sensor=jcfg.Sensor.STEREO, camera=jcfg.CameraConfig(**vars(ct.camera)), orb=jcfg.OrbConfig(**vars(ct.orb)),
    )
    _, pairs = stereo_drive(ct, 1)
    ex = JFrameFactory(cj).extractor
    (kL, aL), (kR, aR) = (ex(jnp.asarray(im.astype(np.float32))) for im in pairs[0])
    args = [kL.uv, kL.uv_level, kL.octave, kL.valid, kR.uv, kR.octave, kR.valid, kL.desc, kR.desc, aL, aR,
            ex.level_offsets, ex.level_w, ex.level_h, ex.scale_factors]
    kw = dict(min_d=0.0, max_d=cj.camera.fx, bf=cj.camera.bf, col_offset=GAP)
    ur_j, dep_j = (np.asarray(a) for a in jst.match_stereo(*args, **kw))

    def to_t(a):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            return torch.tensor(a.view(np.int32))
        return torch.tensor(a.astype(np.int64) if a.dtype.kind in "iu" else a)

    ur_t, dep_t = (a.numpy() for a in tst.match_stereo(*map(to_t, args), **kw))
    assert np.array_equal(ur_t >= 0, ur_j >= 0)
    assert (ur_j >= 0).sum() > 100
    np.testing.assert_allclose(ur_t, ur_j, rtol=0, atol=UR_TOL)
    np.testing.assert_allclose(dep_t, dep_j, rtol=DEPTH_RTOL, atol=1e-6)


def test_depth_to_uright():
    rng = np.random.default_rng(6)
    depth_map = np.where(rng.random((60, 80)) < 0.8, rng.uniform(500, 20000, (60, 80)), 0).astype(np.float32)
    kp_uv = rng.uniform(-3, 83, (50, 2)).astype(np.float32)  # some outside: clamped
    kp_valid = rng.random(50) < 0.9
    ref = jst.depth_to_uright(jnp.asarray(kp_uv), jnp.asarray(kp_valid), jnp.asarray(depth_map), 5000.0, 40.0)
    port = tst.depth_to_uright(torch.tensor(kp_uv), torch.tensor(kp_valid), torch.tensor(depth_map), 5000.0, 40.0)
    for p, r in zip(port, ref):
        assert np.array_equal(p.numpy() >= 0, np.asarray(r) >= 0)
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-6, atol=1e-5)
