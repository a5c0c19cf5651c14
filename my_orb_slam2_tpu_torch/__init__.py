"""PyTorch/CUDA port of the sparse visual SLAM engine (stereo tracking slice).

The JAX package `my_orb_slam2_tpu` is the reference. This package keeps its
module layout and function names so each counterpart is easy to find, and
runs the stereo main path (ORB front-end, stereo matching, motion-model /
reference-keyframe / local-map tracking, keyframe insertion) on PyTorch
tensors. The one TPU kernel on that path, fused FAST + 3x3 NMS, is a
hand-written CUDA kernel for Hopper (`csrc/fast_nms.cu`, wrapped by
`ops/fast_nms.py`); everything else is plain PyTorch.

Nothing here depends on jax or on the JAX package, whose `__init__` loads
jax.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry (pose chains, normal-equation sums) needs full f32 products. The
# reference sets jax_default_matmul_precision="highest" for the same reason
# (my_orb_slam2_tpu/__init__.py); here TF32 is turned off for both matmul
# and cuDNN so no product silently drops to a 10-bit mantissa.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from my_orb_slam2_tpu_torch.utils.config import SlamConfig  # noqa: E402,F401
