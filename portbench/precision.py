"""Rounding to a lower precision than the configuration states, for the
control of the comparison that decides ``correct``: the plain reference,
its product inputs rounded to fp8 (e4m3 in the forward, e5m2 for the
gradients in a backward) with one scale per tensor, as an fp8 path of the
program would round them."""

from __future__ import annotations

import torch


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    scale = torch.finfo(dtype).max / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 with a per-tensor scale (its gradient to
    e5m2)."""
    return _Fp8.apply(x)
