"""Deterministic gradient compression with error feedback (int8-style).

Port of ``repro.dist.compression``. :func:`_quant_dequant` is blockwise
max-scaled int8 quantization (symmetric, round half to even, no stochastic
rounding), so the same grads always compress to the same values. Error
feedback carries the residual ``e_t = y_t - C(y_t)`` (``y_t = g_t +
e_{t-1}``) in fp32 in the train state (``state["ef"]``, see
``train/step.py``), so the sum of compressed grads tracks the true gradient
sum to within one step's quantization error.

Every operation is elementwise or a max over a block, which has no rounding,
so on fp32 inputs the results equal the reference's bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.train.optimizer import tree_map

F32 = torch.float32

BLOCK = 256          # quantization block (values share one fp32 scale)
QMAX = 127.0         # symmetric int8 range; max error = scale/2 = |block|max/254


def _quant_dequant(x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Blockwise max-scaled int8 quantize→dequantize.

    Per block of ``block`` consecutive values: ``scale = max|x| / 127`` (an
    all-zero block takes scale 1), ``q = clip(round(x / scale))``. Returns
    the dequantized tensor in the input's shape and dtype.
    """
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1).to(F32)
    n = flat.numel()
    pad = (-n) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    xb = flat.reshape(-1, block)
    amax = torch.amax(torch.abs(xb), dim=1, keepdim=True)
    # a tensor divisor: the card divides by a Python scalar through its
    # reciprocal, which rounds differently from a true division
    scale = amax / torch.full_like(amax, QMAX)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xb / scale), -QMAX, QMAX)
    deq = (q * scale).reshape(-1)[:n].reshape(shape)
    return deq.to(dtype)


def ef_init(params):
    """Zero error-feedback state mirroring ``params`` (fp32 residuals)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)


def compress_grads(grads, ef):
    """``y = g + e``; ``c = quant_dequant(y)``; ``e' = y - c``. Returns
    ``(compressed fp32 grads, new ef)``."""
    y = tree_map(lambda g, e: g.to(F32) + e, grads, ef)
    c = tree_map(_quant_dequant, y)
    new_ef = tree_map(lambda a, b: a - b, y, c)
    return c, new_ef
