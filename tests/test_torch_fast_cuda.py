"""The FAST+NMS CUDA kernel (csrc/fast_nms.cu) against its plain PyTorch
version, and the wrapper's dispatch rules.

Tests marked `cuda` need an NVIDIA GPU with nvcc and skip without one. This
file imports neither jax nor the JAX package, so it also runs on the GPU
machine: python -m pytest --noconftest tests/test_torch_fast_cuda.py
"""

import numpy as np
import pytest
import torch

from my_orb_slam2_tpu_torch.ops import fast_nms as fk
from my_orb_slam2_tpu_torch.ops.frontend import OrbExtractor
from my_orb_slam2_tpu_torch.utils.config import OrbConfig
from my_orb_slam2_tpu_torch.utils.synthetic import bench_config, stereo_drive

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
    cfg = bench_config()
    _, pairs = stereo_drive(cfg, 1)
    ex = OrbExtractor(cfg.orb, cfg.camera.height, cfg.camera.width, device=cuda)
    atlas = ex.build_atlas(torch.as_tensor(pairs[0][0]).to(cuda).float())
    out = fk.fast_nms(atlas, THRESHOLD, 9)
    torch.cuda.synchronize()
    ref = _plain(atlas)
    assert torch.equal(out, ref)
    assert int((ref > 0).sum()) > 1000


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
    ex = OrbExtractor(OrbConfig(n_features=100), 120, 160)
    before = fk.fast_nms.launches
    kps, _ = ex(torch.zeros(120, 160))
    assert fk.fast_nms.launches == before
    assert not bool(kps.valid.any())
