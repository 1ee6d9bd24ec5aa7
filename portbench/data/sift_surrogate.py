"""SIFT-shaped 128-d descriptors made on the device from a seed.

A frozen PyTorch copy of the recipe of ``tpu_ann_torch.utils.datasets.
sift_surrogate`` (which draws in host numpy): a bank of prototype gradient
patterns (4x4 cells x 8 orientation bins, gamma marginals, a dominant
orientation per prototype, spatially smooth cell energy), a log-normal
jitter per draw, then SIFT's normalisation (unit norm, clip at 0.2,
renormalise, x512) and uint8 saturation, so every value is an integer in
[0, 255] as in the real SIFT1M files. ``nproto=64, sigma=1.3`` is the
preset calibrated to real SIFT1M's IVF recall curve.

The prototype bank (nproto x 128 values) is drawn on the host from the
seed; every row is drawn on the device by one ``torch.Generator`` seeded
with the same seed, in a few large calls. The same seed on the same
device gives the same rows.
"""

from __future__ import annotations

import numpy as np
import torch

D = 128


def _prototypes(seed: int, nproto: int) -> np.ndarray:
    """(nproto, 16, 8) float32 prototype patterns."""
    rs = np.random.Generator(np.random.PCG64(seed))
    proto = rs.gamma(0.65, 1.0, size=(nproto, 16, 8)).astype(np.float32)
    dom = rs.integers(8, size=(nproto, 1, 1))
    ori = np.arange(8).reshape(1, 1, 8)
    ang = np.minimum(np.abs(ori - dom), 8 - np.abs(ori - dom))
    kappa = rs.gamma(2.0, 1.0, size=(nproto, 1, 1)).astype(np.float32)
    proto *= np.exp(-kappa * (ang.astype(np.float32) ** 2) / 4.0)
    cell = rs.gamma(1.5, 1.0, size=(nproto, 4, 4)).astype(np.float32)
    cell = (cell + np.roll(cell, 1, 1) + np.roll(cell, 1, 2)) / 3.0
    proto *= cell.reshape(nproto, 16, 1)
    return proto


def sift_surrogate(n: int, seed: int, device, *, nproto: int = 64,
                   sigma: float = 1.3, chunk: int = 1 << 19) -> torch.Tensor:
    """(n, 128) float32 rows on ``device``, integer-valued in [0, 255]."""
    seed = int(seed) % (1 << 63)
    device = torch.device(device)
    proto = torch.from_numpy(_prototypes(seed, nproto)).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    which = torch.randint(nproto, (n,), generator=gen, device=device)
    out = torch.empty((n, D), dtype=torch.float32, device=device)
    for i0 in range(0, n, chunk):
        m = min(chunk, n - i0)
        jit = torch.randn((m, 16, 8), generator=gen, device=device)
        v = (proto[which[i0:i0 + m]] * torch.exp(sigma * jit)).reshape(m, D)
        v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-12)
        v = torch.clamp(v, max=0.2)
        v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-12)
        out[i0:i0 + m] = torch.clamp(torch.floor(v * 512.0), max=255.0)
    return out


def make(n: int, seed: int, device, params: dict) -> torch.Tensor:
    """The generator as a configuration names it: ``params`` is the
    configuration's ``data`` entry."""
    return sift_surrogate(n, seed, device, nproto=params["nproto"],
                          sigma=params["sigma"])
