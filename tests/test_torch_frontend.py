"""Parity of the PyTorch front-end (my_orb_slam2_tpu_torch.ops.frontend /
ops.fast_nms) against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The FAST
plain version is held bit-exact against the JAX XLA formulation and against
the Pallas kernel itself (interpret mode)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from my_orb_slam2_tpu.ops import frontend as jfe
from my_orb_slam2_tpu.ops.fast_pallas import fast_nms_pallas
from my_orb_slam2_tpu.utils.config import OrbConfig as JOrbConfig
from my_orb_slam2_tpu_torch.ops import fast_nms as tfast
from my_orb_slam2_tpu_torch.ops import frontend as tfe
from my_orb_slam2_tpu_torch.utils.config import OrbConfig as TOrbConfig

H, W = 240, 320
N_FEATURES = 300
# Atlas tolerance: the port applies jax.image.resize's antialiased triangle
# weights as two f32 matmuls; only the summation order differs, so levels
# 1-7 agree to well under 1e-2 gray levels (measured 5.5e-4 on uniform
# noise). Level 0 is a plain copy and must be exact.
ATLAS_TOL = 2e-3
# Keypoints over all levels: level-0 sets are identical; on levels 1-7 a
# score within rounding of a neighbour's can reorder a cell, so the sets
# must overlap by at least this fraction.
KP_OVERLAP = 0.95
# Descriptors from the same atlas and keypoints: a bit may flip only where a
# BRIEF sum is within f32 rounding of 0.
HAMMING_BOUND = 2
# Slot-by-slot agreement of the whole extraction: a reordered cell shifts
# every later slot of its level, so fewer slots than keypoints match.
SAME_SLOT = 0.75


def _texture(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 60, (h, w)).astype(np.float32)
    for _ in range(200):
        y, x = rng.integers(20, h - 20), rng.integers(20, w - 20)
        s = rng.integers(2, 6)
        img[y - s : y + s, x - s : x + s] = rng.uniform(80, 255)
    return np.round(img).astype(np.float32)


@pytest.fixture(scope="module")
def extractors():
    ej = jfe.OrbExtractor(JOrbConfig(n_features=N_FEATURES), H, W)
    et = tfe.OrbExtractor(TOrbConfig(n_features=N_FEATURES), H, W, device="cpu")
    return ej, et


@pytest.fixture(scope="module")
def extracted(extractors):
    ej, et = extractors
    img = _texture(3)
    kj, aj = ej(jnp.asarray(img))
    kt, at = et(torch.tensor(img))
    return img, kj, np.asarray(aj), kt, at.numpy()


def test_extract_batch_equals_forward(extractors):
    """The stereo path's one FAST+NMS call over both atlases gives each
    image exactly what the single-image forward gives."""
    _, et = extractors
    imgs = [torch.tensor(_texture(seed)) for seed in (4, 5)]
    for (kb, ab), img in zip(et.extract_batch(imgs), imgs):
        kf, af = et(img)
        assert torch.equal(ab, af)
        for name in kf._fields:
            assert torch.equal(getattr(kb, name), getattr(kf, name)), name


def test_extractor_tables_equal(extractors):
    ej, et = extractors
    assert et.levels == ej.levels
    assert (et.atlas_h, et.atlas_w, et.capacity) == (ej.atlas_h, ej.atlas_w, ej.capacity)
    assert np.array_equal(et.pattern.numpy(), np.asarray(ej.pattern))
    assert np.array_equal(et.moment_M.numpy(), np.asarray(ej.moment_M))
    assert np.array_equal(et.desc_D.numpy(), np.asarray(ej.desc_D.astype(jnp.float32)))
    assert np.array_equal(et.scale_factors.numpy(), np.asarray(ej.scale_factors))
    assert np.array_equal(et.level_offsets.numpy(), np.asarray(ej.level_offsets))


@pytest.mark.parametrize("shape", [(136, 200), (97, 130)])
def test_fast_plain_bit_exact_random(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape).astype(np.float32)
    ref = np.asarray(jfe.nms3x3(jfe.fast_score_map(jnp.asarray(img), 7.0, 9)))
    pallas = np.asarray(fast_nms_pallas(jnp.asarray(img), 7.0, 9, interpret=True))
    port = tfast.fast_nms(torch.tensor(img), 7.0, 9).numpy()
    assert np.array_equal(port, ref)
    assert np.array_equal(port, pallas)
    assert (ref > 0).sum() > 100


def test_fast_plain_bit_exact_on_atlas(extractors):
    ej, et = extractors
    atlas = np.asarray(ej.build_atlas(jnp.asarray(_texture(5))))
    ref = np.asarray(jfe.nms3x3(jfe.fast_score_map(jnp.asarray(atlas), 7.0, 9)))
    pallas = np.asarray(fast_nms_pallas(jnp.asarray(atlas), 7.0, 9, interpret=True))
    port = tfe.fast_nms(torch.tensor(atlas), 7.0, 9).numpy()
    assert np.array_equal(port, ref)
    assert np.array_equal(port, pallas)
    # Batched plain version (the kernel takes a leading batch dim too).
    both = tfast.nms3x3(tfast.fast_score_map(torch.tensor(np.stack([atlas, atlas[::-1].copy()])), 7.0))
    assert np.array_equal(both[0].numpy(), ref)


def test_resize_weights_match_jax():
    from jax._src.image.scale import compute_weight_mat, _fill_triangle_kernel

    for n_in, n_out in [(240, 200), (320, 154), (240, 67)]:
        ref = np.asarray(
            compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, _fill_triangle_kernel, True)
        ).T
        np.testing.assert_allclose(tfe.resize_weights(n_in, n_out), ref, rtol=0, atol=1e-7)


def test_atlas_within_tolerance(extracted, extractors):
    _, _, aj, _, at = extracted
    ej = extractors[0]
    lv0 = ej.levels[0]
    rows = slice(lv0.atlas_off - 3, lv0.atlas_off + lv0.h + 3)
    assert np.array_equal(at[rows], aj[rows])
    assert np.abs(at - aj).max() <= ATLAS_TOL


def _kp_set(uv_level, octave, valid, level=None):
    keep = valid if level is None else valid & (octave == level)
    return set(map(tuple, np.c_[uv_level[keep], octave[keep]].tolist()))


def test_keypoint_sets(extracted):
    _, kj, _, kt, _ = extracted
    vj, vt = np.asarray(kj.valid), kt.valid.numpy()
    args_j = (np.asarray(kj.uv_level), np.asarray(kj.octave), vj)
    args_t = (kt.uv_level.numpy(), kt.octave.numpy(), vt)
    assert vj.sum() == vt.sum() == N_FEATURES
    assert _kp_set(*args_j, level=0) == _kp_set(*args_t, level=0)
    sj, st = _kp_set(*args_j), _kp_set(*args_t)
    assert len(sj & st) >= KP_OVERLAP * len(sj)


def _popcount_rows(x):
    x = x.astype(np.uint32)
    bits = np.unpackbits(x.view(np.uint8), axis=1)
    return bits.sum(axis=1)


def test_descriptors_same_atlas_and_keypoints(extracted, extractors):
    """Port orientation + BRIEF on the JAX atlas and JAX keypoints."""
    _, kj, aj, _, _ = extracted
    et = extractors[1]
    valid = np.asarray(kj.valid)
    octv = torch.tensor(np.asarray(kj.octave).astype(np.int64))
    uvl = torch.tensor(np.asarray(kj.uv_level)).to(torch.int64)
    ax = uvl[:, 0] + tfe.GAP
    ay = uvl[:, 1] + et.level_offsets[octv]
    patches = et._gather_patches(torch.tensor(aj), ax, ay)
    ang = et._orientation_from_patches(patches)
    desc = et._descriptors_from_patches(patches, ang).numpy().view(np.uint32)
    np.testing.assert_allclose(ang.numpy()[valid], np.asarray(kj.angle)[valid], atol=1e-4)
    ham = _popcount_rows(np.bitwise_xor(desc, np.asarray(kj.desc)))[valid]
    assert ham.max() <= HAMMING_BOUND, ham.max()


def test_gather_patches_clamps_like_dynamic_slice(extractors):
    """Keypoints near or past the atlas edge read a clamped window."""
    ej, et = extractors
    rng = np.random.default_rng(1)
    atlas = rng.uniform(0, 255, (ej.atlas_h, ej.atlas_w)).astype(np.float32)
    ax = np.array([0, 3, 10, ej.atlas_w - 1, ej.atlas_w + 40, -30], np.int32)
    ay = np.array([0, ej.atlas_h - 2, 50, 7, -5, ej.atlas_h + 9], np.int32)
    ref = np.asarray(ej._gather_patches(jnp.asarray(atlas), jnp.asarray(ax), jnp.asarray(ay)))
    port = et._gather_patches(torch.tensor(atlas), torch.tensor(ax.astype(np.int64)), torch.tensor(ay.astype(np.int64)))
    assert np.array_equal(port.numpy(), ref)


def test_topk_stable_matches_lax_top_k():
    x = np.array([[3, 5, 5, 1, 5], [0, 0, 0, 0, 0], [2, 9, 2, 9, 1]], np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(x), 3)
    vt, it = tfe.topk_stable(torch.tensor(x), 3)
    assert np.array_equal(it.numpy(), np.asarray(ij))
    assert np.array_equal(vt.numpy(), np.asarray(vj))


def test_hamming_distance_exact():
    rng = np.random.default_rng(7)
    d1 = rng.integers(0, 2 ** 32, (37, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2 ** 32, (53, 8), dtype=np.uint32)
    d2[:5] = d1[:5]
    d2[5] = ~d1[6]
    ref = np.asarray(jfe.hamming_distance(jnp.asarray(d1), jnp.asarray(d2)))
    t1, t2 = (torch.tensor(d.view(np.int32)) for d in (d1, d2))
    assert np.array_equal(tfe.hamming_distance(t1, t2).numpy(), ref)
    assert np.array_equal(tfe.unpack_pm1(t1).numpy(), np.asarray(jfe.unpack_pm1(jnp.asarray(d1))).astype(np.float32))
    bits = torch.tensor(np.unpackbits(d1.view(np.uint8), axis=1, bitorder="little").astype(bool))
    assert np.array_equal(tfe.pack_bits(bits).numpy().view(np.uint32), d1)


def test_extract_outputs_agree(extracted):
    """Whole-image extraction: same valid count, and wherever both picked the
    same keypoint its level-0 position, octave and response agree."""
    _, kj, _, kt, _ = extracted
    same = np.all(np.asarray(kj.uv_level) == kt.uv_level.numpy(), axis=1) & (
        np.asarray(kj.octave) == kt.octave.numpy()
    ) & np.asarray(kj.valid)
    assert same.sum() >= SAME_SLOT * N_FEATURES
    np.testing.assert_allclose(kt.uv.numpy()[same], np.asarray(kj.uv)[same], rtol=1e-6)
    np.testing.assert_allclose(kt.response.numpy()[same], np.asarray(kj.response)[same], atol=ATLAS_TOL * 20)
