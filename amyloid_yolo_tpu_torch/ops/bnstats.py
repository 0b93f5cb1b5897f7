"""Train-mode BN statistics as matrix products (reference package
``ops/bnstats.py``).

Same math as the reduction form of ``models.darknet`` (torch
``BatchNorm2d`` as the reference trains it: the biased batch variance
normalises, the caller derives the unbiased one for the running
statistics), in another summation order:

* :func:`channel_sums` — ``Σx`` and ``Σx²`` per channel of an (N, C)
  matrix as one product, a ones row times ``[x | x²]``, summed in float32;
* :func:`bn_normalize` — the affine normalize as a
  ``torch.autograd.Function`` whose backward takes its two sums, ``Σdy``
  and ``Σdy·x``, as products too.  It returns the exact gradients of the
  inline form, treating ``mean`` and ``inv`` as inputs, so they flow back
  through the caller's statistics.

Where the reference multiplies by an 8-row ones block (``_LHS_ROWS = 8``:
XLA turns a one-row product back into the reduction), the port uses one
row.  The products run in float32 with TF32 off on the card
(:func:`~..utils.device.no_tf32`): TF32 would move the sums by ~1e-3.
``torch.matmul`` is a library call; the reference computes these products
outside any Pallas kernel too.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from ..utils.device import no_tf32


def _ones_dot(x2d: torch.Tensor) -> torch.Tensor:
    """Per-column sums of ``x2d`` (N, K) as ``ones(1, N) @ x2d`` in float32."""
    x2d = x2d.to(torch.float32)
    scope = no_tf32() if x2d.is_cuda else contextlib.nullcontext()
    with scope:
        return torch.ones((1, x2d.shape[0]), dtype=torch.float32, device=x2d.device).matmul(x2d)[0]


def channel_sums(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(Σ_n x[n, c], Σ_n x[n, c]²)`` in float32 for ``x2d`` (N, C); the
    square is taken in ``x2d``'s dtype (one rounding more in bf16, as the
    reference)."""
    c = x2d.shape[1]
    sums = _ones_dot(torch.cat([x2d, x2d * x2d], dim=1))
    return sums[:c], sums[c:]


class _BNNormalize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mean, inv, gamma, beta):
        ctx.save_for_backward(x, mean, inv, gamma)
        k = gamma * inv
        return ((x.to(torch.float32) - mean[None, :, None, None]) * k[None, :, None, None]
                + beta[None, :, None, None]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, mean, inv, gamma = ctx.saved_tensors
        c = x.shape[1]
        x2d = x.permute(0, 2, 3, 1).reshape(-1, c)
        g2d = g.permute(0, 2, 3, 1).reshape(-1, c)
        s1 = _ones_dot(g2d)              # Σdy
        sgx = _ones_dot(g2d * x2d)       # Σdy·x, the product in x's dtype
        k = gamma * inv
        ct_x = (g.to(torch.float32) * k[None, :, None, None]).to(x.dtype)
        centred = sgx - mean * s1        # Σdy·(x − mean)
        return ct_x, -k * s1, gamma * centred, inv * centred, s1


def bn_normalize(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                 gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """``(x − mean)·(gamma·inv) + beta`` in float32, rounded to ``x``'s dtype,
    for an NCHW ``x`` and per-channel float32 vectors (``inv = rsqrt(var +
    ε)``, computed by the caller)."""
    return _BNNormalize.apply(x, mean, inv, gamma, beta)


__all__ = ["channel_sums", "bn_normalize"]
