"""QINCo neural residual codec — PyTorch counterpart of
`tpu_ann/ops/qinco.py` (faiss `utils/NeuralNet.{h,cpp}`: QINCoStep, QINCo,
a translation of facebookresearch/Qinco `model_qinco.py`).

`QINCo` and `QINCoStep` are `nn.Module`s whose `state_dict()` keys are
the exported PyTorch reference's (``codebook0.weight``,
``steps.<i>.codebook.weight``, ``steps.<i>.MLPconcat.{weight,bias}``,
``steps.<i>.residual_blocks.<j>.linear{1,2}.weight``), so
`load_state_dict` takes such a file as it is. Linear weights are in
torch's (out, in) layout; MLPconcat's input is [code, xhat].

  decode:  xhat = codebook0[c0]; per step: z = cb[c] + MLPconcat([cb[c],
           xhat]); L x (z += FFN(z)); xhat += z
  encode:  greedy per step over all K candidate deltas, keeping the one
           that minimizes ||x - (xhat + delta)||^2.

The encode keeps the reference's factored MLPconcat: ``cb @ W_cb`` once a
step, ``xhat @ W_xh`` a row, a broadcast add into (chunk, K, d); the
(n K, 2d) concat of the C++ is never formed. `encode_chunked` bounds the
(chunk, K, h) activations. The weights are inference state: `QINCo.random`
draws the reference's numbers from `np.random.RandomState(seed)` in its
order, `QINCo.from_arrays` loads a state dict of arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from . import distances as D


class _ResidualBlock(nn.Module):
    """z + linear2(relu(linear1(z))), no biases (NeuralNet.h:77-84)."""

    def __init__(self, d: int, h: int):
        super().__init__()
        self.linear1 = nn.Linear(d, h, bias=False)
        self.linear2 = nn.Linear(h, d, bias=False)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        hdn = torch.relu(z @ self.linear1.weight.T)
        return z + hdn @ self.linear2.weight.T


class QINCoStep(nn.Module):
    """One refinement step (QINCoStep, NeuralNet.h:98-126)."""

    def __init__(self, d: int, K: int, L: int, h: int):
        super().__init__()
        self.d, self.K, self.L, self.h = d, K, L, h
        self.codebook = nn.Embedding(K, d)
        self.MLPconcat = nn.Linear(2 * d, d)
        self.residual_blocks = nn.ModuleList(
            [_ResidualBlock(d, h) for _ in range(L)])

    def _weights(self):
        """(W_cb, W_xh) (d, d): MLPconcat's halves as right factors."""
        w = self.MLPconcat.weight
        return w[:, :self.d].T, w[:, self.d:].T

    def _blocks(self, z: torch.Tensor) -> torch.Tensor:
        for blk in self.residual_blocks:
            z = blk(z)
        return z

    def decode(self, xhat: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """QINCoStep::decode (NeuralNet.cpp:190-202): the step's delta."""
        w_cb, w_xh = self._weights()
        zqs = self.codebook.weight[codes]
        zqs = zqs + zqs @ w_cb + xhat @ w_xh + self.MLPconcat.bias
        return self._blocks(zqs)

    def encode(self, xhat: torch.Tensor, x: torch.Tensor):
        """QINCoStep::encode (NeuralNet.cpp:204-260): every candidate delta,
        the greedy argmin (the first index on a tie). Returns (codes (n,)
        int64, delta (n, d))."""
        w_cb, w_xh = self._weights()
        cb = self.codebook.weight
        cb_term = cb + cb @ w_cb + self.MLPconcat.bias            # (K, d)
        z = self._blocks(cb_term[None] + (xhat @ w_xh)[:, None])  # (n, K, d)
        r = (x - xhat)[:, None, :] - z
        codes = torch.argmin((r * r).sum(-1), dim=1)
        delta = z[torch.arange(len(z), device=z.device), codes]
        return codes, delta


class QINCo(nn.Module):
    """QINCo(d, K, L, M, h) (NeuralNet.h:128-140): codebook0 and M - 1
    steps."""

    def __init__(self, d: int, K: int, L: int, M: int, h: int):
        super().__init__()
        self.d, self.K, self.L, self.M, self.h = d, K, L, M, h
        self.codebook0 = nn.Embedding(K, d)
        self.steps = nn.ModuleList(
            [QINCoStep(d, K, L, h) for _ in range(M - 1)])

    @classmethod
    def from_arrays(cls, state: Dict[str, np.ndarray]) -> "QINCo":
        """A QINCo from a state dict of arrays with the reference's keys
        (the shapes give d, K, L, M and h)."""
        cb0 = np.asarray(state["codebook0.weight"], np.float32)
        K, d = cb0.shape
        M = 1
        while f"steps.{M - 1}.codebook.weight" in state:
            M += 1
        L = 0
        while f"steps.0.residual_blocks.{L}.linear1.weight" in state:
            L += 1
        h = (np.shape(state["steps.0.residual_blocks.0.linear1.weight"])[0]
             if L else 1)
        model = cls(d, K, L, M, h)
        model.load_state_dict({key: torch.as_tensor(np.asarray(v,
                                                               np.float32))
                               for key, v in state.items()})
        return model

    @classmethod
    def random(cls, d: int, K: int, L: int, M: int, h: int,
               seed: int = 42) -> "QINCo":
        """The reference's deterministic init (QINCoParams.random): per
        step the codebook ~ N(0, 1), then W_cb, W_xh and the bias, then the
        L expand and L project weights, all U(-1/sqrt(fan_in), ..) as
        nn.Linear's default; codebook0 last."""
        rs = np.random.RandomState(seed)

        def lin(shape, fan_in):
            bound = 1.0 / np.sqrt(fan_in)
            return rs.uniform(-bound, bound, size=shape).astype(np.float32)

        state = {}
        for i in range(M - 1):
            state[f"steps.{i}.codebook.weight"] = \
                rs.randn(K, d).astype(np.float32)
            w_cb, w_xh = lin((d, d), 2 * d), lin((d, d), 2 * d)
            state[f"steps.{i}.MLPconcat.weight"] = np.concatenate(
                [w_cb.T, w_xh.T], axis=1)
            state[f"steps.{i}.MLPconcat.bias"] = lin((d,), 2 * d)
            w1, w2 = lin((L, d, h), d), lin((L, h, d), h)
            for j in range(L):
                state[f"steps.{i}.residual_blocks.{j}.linear1.weight"] = \
                    w1[j].T
                state[f"steps.{i}.residual_blocks.{j}.linear2.weight"] = \
                    w2[j].T
        state["codebook0.weight"] = rs.randn(K, d).astype(np.float32)
        model = cls(d, K, L, M, h)
        model.load_state_dict({key: torch.from_numpy(np.ascontiguousarray(v))
                               for key, v in state.items()})
        return model

    @torch.no_grad()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """QINCo::decode (NeuralNet.cpp:300-307): (n, M) codes -> (n, d)."""
        codes = codes.long()
        xhat = self.codebook0.weight[codes[:, 0]]
        for i, step in enumerate(self.steps):
            xhat = xhat + step.decode(xhat, codes[:, i + 1])
        return xhat

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """QINCo::encode (NeuralNet.cpp:309-344): (n, d) -> (n, M) int64;
        stage 0 is the nearest codebook0 row."""
        x = x.float()
        _, c0 = D.knn(x, self.codebook0.weight, 1)
        c0 = c0[:, 0]
        xhat = self.codebook0.weight[c0]
        codes = [c0]
        for step in self.steps:
            ci, delta = step.encode(xhat, x)
            xhat = xhat + delta
            codes.append(ci)
        return torch.stack(codes, dim=1)


def encode_chunked(model: QINCo, x, chunk: int = 4096) -> torch.Tensor:
    """`QINCo.encode` in row chunks bounding the (chunk, K, h) activations;
    ``x`` a numpy array or a tensor. Returns (n, M) int64 on the model's
    device."""
    dev = model.codebook0.weight.device
    outs = []
    for i in range(0, len(x), chunk):
        xi = x[i:i + chunk]
        xi = xi.to(dev) if isinstance(xi, torch.Tensor) else \
            torch.from_numpy(np.array(xi, np.float32)).to(dev)
        outs.append(model.encode(xi))
    return torch.cat(outs) if outs else torch.zeros(
        (0, model.M), dtype=torch.long, device=dev)


# --- bit packing (the BitstringWriter role, vectorized) --------------------

def pack_codes(codes: np.ndarray, nbits: int) -> np.ndarray:
    """(n, M) ints -> (n, ceil(M nbits / 8)) uint8, a little-endian
    bitstream (reference :212-229)."""
    n, M = codes.shape
    total = M * nbits
    nbytes = -(-total // 8)
    codes = np.asarray(codes, np.uint64)
    shifts = np.arange(nbits, dtype=np.uint64)
    bits = ((codes[:, :, None] >> shifts) & np.uint64(1)).astype(np.uint8)
    bits = bits.reshape(n, total)
    pad = nbytes * 8 - total
    if pad:
        bits = np.concatenate([bits, np.zeros((n, pad), np.uint8)], axis=1)
    return np.packbits(bits.reshape(n, nbytes, 8), axis=-1,
                       bitorder="little")[:, :, 0]


def unpack_codes(packed: np.ndarray, M: int, nbits: int) -> np.ndarray:
    """Inverse of `pack_codes`: (n, nbytes) uint8 -> (n, M), uint64 above
    31 bits a code, int32 otherwise (reference :232-240)."""
    n = len(packed)
    bits = np.unpackbits(packed[:, :, None], axis=-1,
                         bitorder="little").reshape(n, -1)
    bits = bits[:, :M * nbits].reshape(n, M, nbits)
    shifts = np.arange(nbits, dtype=np.uint64)
    wide = (bits.astype(np.uint64) << shifts).sum(-1, dtype=np.uint64)
    return wide if nbits > 31 else wide.astype(np.int32)


def unpack_codes_device(packed: torch.Tensor, M: int,
                        nbits: int) -> torch.Tensor:
    """`unpack_codes` on the packed rows' device: (n, nbytes) uint8 ->
    (n, M) int64 (codes of at most 63 bits)."""
    if nbits > 63:
        raise ValueError(f"{nbits}-bit codes do not fit int64")
    n = packed.shape[0]
    dev = packed.device
    bits = (packed.long()[:, :, None] >> torch.arange(8, device=dev)) & 1
    bits = bits.reshape(n, -1)[:, :M * nbits].reshape(n, M, nbits)
    return (bits << torch.arange(nbits, device=dev)).sum(-1)
