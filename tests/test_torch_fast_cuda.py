"""The FAST+NMS CUDA kernel (csrc/fast_nms.cu) against its plain PyTorch
version, the kernel's early-rejection rule, the wrapper's dispatch rules,
and the port's device defaults.

Tests marked `cuda` need an NVIDIA GPU with nvcc and skip without one. This
file imports neither jax nor the JAX package, so it also runs on the GPU
machine: python -m pytest --noconftest tests/test_torch_fast_cuda.py
"""

import inspect

import numpy as np
import pytest
import torch

from my_orb_slam2_tpu_torch.models.frame import FrameFactory
from my_orb_slam2_tpu_torch.models.loop_closing import LoopCloser
from my_orb_slam2_tpu_torch.models.relocalization import Relocalizer
from my_orb_slam2_tpu_torch.models.system import SlamSystem
from my_orb_slam2_tpu_torch.models.tracking import Tracker
from my_orb_slam2_tpu_torch.ops import fast_nms as fk
from my_orb_slam2_tpu_torch.ops.bow import LshVocabulary, TreeVocabulary
from my_orb_slam2_tpu_torch.ops.frontend import OrbExtractor
from my_orb_slam2_tpu_torch.time_fast_nms import bench_inputs
from my_orb_slam2_tpu_torch.utils import vocab_io
from my_orb_slam2_tpu_torch.utils.config import OrbConfig

THRESHOLD = 7.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: torch.cuda.is_available() is False")
    return torch.device("cuda:0")


def _plain(x):
    return fk.nms3x3(fk.fast_score_map(x, THRESHOLD, 9))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 640), (97, 131), (7, 9), (3, 64, 40)])
def test_kernel_bit_exact_random(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    x = torch.tensor(rng.integers(0, 256, shape).astype(np.float32), device=cuda)
    out = fk.fast_nms(x, THRESHOLD, 9)
    torch.cuda.synchronize()
    assert torch.equal(out, _plain(x))


@pytest.mark.cuda
def test_kernel_bit_exact_on_bench_atlas(cuda):
    atlas = bench_inputs(cuda)["bench atlas"]
    out = fk.fast_nms(atlas, THRESHOLD, 9)
    torch.cuda.synchronize()
    ref = _plain(atlas)
    assert torch.equal(out, ref)
    assert int((ref > 0).sum()) > 1000


@pytest.mark.cuda
def test_kernel_bit_exact_on_stereo_batch(cuda):
    """The main path's one launch per stereo frame: the (2, 2288, 656) L+R
    batch, whose 16-byte-aligned pitch takes the TMA tile loader ((97, 131)
    and (7, 9) above take the unaligned one)."""
    batch = bench_inputs(cuda)["L+R batch"]
    out = fk.fast_nms(batch, THRESHOLD, 9)
    torch.cuda.synchronize()
    assert batch.shape == (2, 2288, 656)
    assert torch.equal(out, _plain(batch))


@pytest.mark.cuda
def test_kernel_counts_launches_and_rejects_bad_input(cuda):
    x = torch.rand(64, 80, device=cuda) * 255
    before = fk.fast_nms.launches
    fk.fast_nms(x, THRESHOLD, 9)
    fk.fast_nms(x.cpu(), THRESHOLD, 9)  # plain version: not a launch
    assert fk.fast_nms.launches == before + 1
    with pytest.raises(ValueError):
        fk.fast_nms(x.double(), THRESHOLD, 9)
    with pytest.raises(ValueError):
        fk.fast_nms(x, THRESHOLD, 12)


def _two_of_four(img, thr):
    """The looser form of the rule: at least 2 of the 4 compass diffs
    beyond the threshold on one side."""
    d = torch.stack([torch.roll(img, (-int(dy), -int(dx)), dims=(-2, -1)) for dy, dx in fk.FAST_RING[[0, 4, 8, 12]]])
    d = d - img[None]
    return ((d > thr).sum(0) >= 2) | ((d < -thr).sum(0) >= 2)


def _check_rejection_exact(img, thr):
    cand = fk.compass_candidates(img, thr)
    score = fk.fast_score_map(img, thr, 9)
    assert not bool((score[~cand] != 0).any()), "a rejected pixel scores above the threshold"
    assert not bool((cand & ~_two_of_four(img, thr)).any())
    return cand, score


@pytest.mark.parametrize("thr", [0.0, 7.0, 20.0])
@pytest.mark.parametrize("shape", [(97, 131), (64, 80)])
def test_compass_rejection_is_exact_on_random_images(shape, thr):
    rng = np.random.default_rng(sum(shape) + int(thr))
    for x in (rng.integers(0, 256, shape), rng.normal(100.0, 12.0, shape)):
        cand, _ = _check_rejection_exact(torch.tensor(np.asarray(x, np.float32)), thr)
        assert 0 < int(cand.sum()) < cand.numel()


def test_compass_rejection_is_exact_at_ties():
    """Diffs equal to +-thr exactly: strict inequalities on both sides."""
    thr, c = 7.0, 100.0
    imgs = []
    for sign in (1.0, -1.0):
        img = np.full((15, 15), c, np.float32)
        for dy, dx in fk.FAST_RING:  # a full bright (dark) ring ...
            img[7 + dy, 7 + dx] = c + sign * (thr + 5.0)
        for dy, dx in fk.FAST_RING[[0, 4, 8, 12]]:  # ... whose compass diffs sit on the threshold
            img[7 + dy, 7 + dx] = c + sign * thr
        imgs.append(img)
        past = img.copy()  # two adjacent compass entries (N, E) past it: one 9-run
        past[7 - 3, 7] = past[7, 7 + 3] = c + sign * (thr + 1.0)
        imgs.append(past)
    rng = np.random.default_rng(5)
    imgs.append((c + thr * rng.integers(-1, 2, (40, 40))).astype(np.float32))  # all diffs in {0, +-thr, +-2 thr}
    for img in imgs:
        _check_rejection_exact(torch.tensor(img), thr)
    centre = [bool(fk.compass_candidates(torch.tensor(img), thr)[7, 7]) for img in imgs[:4]]
    scores = [float(fk.fast_score_map(torch.tensor(img), thr, 9)[7, 7]) for img in imgs[:4]]
    assert centre == [False, True, False, True]
    assert scores[0] == scores[2] == 0.0 and scores[1] == scores[3] == thr + 1.0


def test_compass_rejection_on_bench_atlas():
    """Exact on the rendered bench atlas; prints the pass shares that size
    the kernel's operation bound (PERF.md)."""
    atlas = bench_inputs("cpu")["bench atlas"]
    cand, score = _check_rejection_exact(atlas, THRESHOLD)
    h, w = atlas.shape
    groups = {n: cand[:, : w // n * n].reshape(h, w // n, n).any(-1).float().mean().item() for n in (4, 32)}
    share = cand.float().mean().item()
    print(f"bench atlas {h}x{w}: compass pass {share:.4f} of pixels, corners {(score > 0).float().mean().item():.4f}; "
          f"row groups with a candidate: 4 px {groups[4]:.4f}, 32 px (a warp vote) {groups[32]:.4f}")
    assert 0.0 < share < 0.5 and groups[32] > share


def test_entry_points_default_to_the_card():
    """The port runs on the card unless the caller asks for the CPU."""
    for fn in (OrbExtractor.__init__, LshVocabulary.__init__, TreeVocabulary.__init__, vocab_io.load_packed,
               vocab_io.default_vocabulary, SlamSystem.__init__, Tracker.__init__, FrameFactory.__init__,
               Relocalizer.__init__, LoopCloser.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__


def test_cpu_tensor_takes_plain_version():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.integers(0, 256, (50, 60)).astype(np.float32))
    before = fk.fast_nms.launches
    assert torch.equal(fk.fast_nms(x, THRESHOLD, 9), _plain(x))
    assert fk.fast_nms.launches == before


def test_kernel_launch_refuses_cpu_tensor():
    with pytest.raises(ValueError):
        fk._launch(torch.zeros(16, 16), THRESHOLD, 9)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(fk.shutil, "which", lambda name: None)
    monkeypatch.setattr(fk, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(fk, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        fk.build()


def test_extractor_on_cpu_never_reaches_the_kernel():
    ex = OrbExtractor(OrbConfig(n_features=100), 120, 160, device="cpu")
    before = fk.fast_nms.launches
    kps, _ = ex(torch.zeros(120, 160))
    assert fk.fast_nms.launches == before
    assert not bool(kps.valid.any())
