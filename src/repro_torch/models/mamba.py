"""Mamba selective-SSM block (Jamba's ``mamba`` and ``mamba_moe`` layers).

Counterpart of ``repro.models.mamba``: the same parameters, casts and
entry point. The depthwise causal conv is k shift-adds in fp32; the scan
is ``kernels/scan.py`` (the CUDA kernels on the card, the sequential
recurrence on the CPU), which keeps no (B, S, Din, N) tensor and serves
the decode step too: at S = 1 with the carried state. The reference's
``chunk`` (its associative-scan chunk) is ``cfg.ssm_chunk`` here, the
interval of the states the scan keeps for its backward: it changes memory,
not results. The decode state ``(conv_state, ssm_state)`` is what the
reference carries.

The three projections are ``torch.matmul`` in the model dtype, as the
reference's ``jnp.einsum`` over model-dtype operands (fp32 accumulation,
one rounding); the ``dt`` projection runs in fp32, as there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import scan as SCAN
from repro_torch.models.module import ParamDef as PD

F32 = torch.float32


def mamba_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    dt_rank = max(1, cfg.d_model // 16)
    return d_in, dt_rank, cfg.ssm_state_dim, cfg.ssm_conv


def mamba_defs(cfg):
    d = cfg.d_model
    d_in, dt_rank, d_state, k_conv = mamba_dims(cfg)
    return {
        "in_proj": PD((d, 2 * d_in)),
        "conv_w": PD((k_conv, d_in), "scaled"),
        "conv_b": PD((d_in,), "zeros"),
        "x_proj": PD((d_in, dt_rank + 2 * d_state)),
        "dt_w": PD((dt_rank, d_in)),
        "dt_b": PD((d_in,), "ones"),
        "A_log": PD((d_in, d_state), "ones", F32),
        "D": PD((d_in,), "ones", F32),
        "out_proj": PD((d_in, d), "scaled"),
    }


def _causal_conv(x, w, b, k_conv, state=None):
    """Depthwise causal conv via k shift-adds. x: (B, S, Din); w: (k, Din)
    fp32. With ``state`` (B, k-1, Din): the continuation of an earlier
    call (the decode step). Returns (y in x's dtype, the new state: the
    last k-1 inputs)."""
    if state is not None:
        x_ext = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        x_ext = F.pad(x, (0, 0, k_conv - 1, 0))
    s = x.shape[1]
    y = torch.zeros(x.shape, dtype=F32, device=x.device)
    for i in range(k_conv):
        y = y + x_ext[:, i:i + s, :].to(F32) * w[i]
    new_state = x_ext[:, x_ext.shape[1] - (k_conv - 1):, :]
    return (y + b).to(x.dtype), new_state


def apply_mamba(p, x, cfg, state=None):
    """x: (B, S, D). ``state=None``: train/prefill from a zero state;
    ``state=(conv_state, ssm_state)``: continue from it (the decode step).
    Returns (y (B, S, D), (new conv_state, new ssm_state))."""
    d_in, dt_rank, d_state, k_conv = mamba_dims(cfg)
    b, s, _ = x.shape
    u = torch.matmul(x, p["in_proj"].to(x.dtype))
    x1, z = u[..., :d_in], u[..., d_in:]

    conv_state = state[0] if state is not None else None
    ssm_state = state[1] if state is not None else torch.zeros(
        (b, d_in, d_state), dtype=F32, device=x.device)
    x1, new_conv_state = _causal_conv(x1, p["conv_w"].to(F32),
                                      p["conv_b"].to(F32), k_conv, conv_state)
    x1 = F.silu(x1.to(F32))

    proj = torch.matmul(x1.to(x.dtype), p["x_proj"].to(x.dtype)).to(F32)
    dt_low = proj[..., :dt_rank]
    B_mat = proj[..., dt_rank:dt_rank + d_state].contiguous()
    C_mat = proj[..., dt_rank + d_state:].contiguous()
    dt = F.softplus(torch.matmul(dt_low, p["dt_w"].to(F32)) + p["dt_b"])
    A = -torch.exp(p["A_log"])                                   # (Din, N)
    y, h_last = SCAN.selective_scan(x1, dt, A, B_mat, C_mat, p["D"],
                                    z.contiguous(), ssm_state.contiguous(),
                                    cfg.ssm_chunk)
    out = torch.matmul(y, p["out_proj"].to(x.dtype))
    return out, (new_conv_state, h_last)
