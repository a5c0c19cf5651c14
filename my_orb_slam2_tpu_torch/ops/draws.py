"""RANSAC draws for the relocalizer and the loop closer.

The reference draws its RANSAC uniforms from split `jax.random` keys; torch
cannot draw the same numbers. So the port's RANSAC functions take the
(n_iters, n) uniforms as an argument, and their host-side callers draw them from
an injectable source: by default `DeviceUniforms`, a seeded
`torch.Generator` on the device. A caller that needs other draws (a replay
of another generator, say) passes any callable shape -> tensor instead.
"""

from __future__ import annotations

import torch


class DeviceUniforms:
    """Uniforms in [0, 1) from a seeded generator on `device`."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def __call__(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)
