"""xLSTM blocks (arXiv:2405.04517): the mLSTM and sLSTM mixers of
xLSTM-350M.

Counterpart of ``repro.models.xlstm``: the same parameters, casts and
entry points. mLSTM (a matrix memory) runs the quadratic parallel form
without a state (``forward``, training) and the ``(C, n, m)`` recurrence
with one (prefill and decode, as the reference's ``prefill_step`` carries
the caches), both in ``kernels/mlstm.py``; sLSTM (a scalar memory with
recurrent matrices) is always the recurrence, ``kernels/slstm.py``. On the
card those are ``csrc/mlstm.cu`` and ``csrc/slstm.cu``, their training
backwards ``csrc/mlstm_parallel_bwd.cu`` and ``csrc/slstm_bwd.cu``; on the
CPU the plain versions, under autograd.

The projections are ``torch.matmul``, as the reference leaves them to
XLA: q, k, v, the skip gate and the output projections in the model dtype
(``k / sqrt(hd)`` cast back to k's dtype), the mLSTM gate projections and
the sLSTM input projections in fp32. The mixers' outputs are fp32 and are
cast to the model dtype before the skip gate and ``w_o`` (mLSTM) or
``w_out`` (sLSTM), as there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import mlstm as ML
from repro_torch.kernels import slstm as SL
from repro_torch.models.module import ParamDef as PD

F32 = torch.float32


# ------------------------------------------------------------------ mLSTM
def mlstm_defs(cfg):
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    inner = h * hd
    return {
        "wq": PD((d, inner)),
        "wk": PD((d, inner)),
        "wv": PD((d, inner)),
        "w_i": PD((d, h), "scaled"),
        "w_f": PD((d, h), "scaled"),
        "b_i": PD((h,), "zeros", F32),
        "b_f": PD((h,), "ones", F32),
        "w_o": PD((inner, d), "scaled"),
        "skip_gate": PD((d, inner), "scaled"),
    }


def apply_mlstm(p, x, cfg, *, state=None):
    """x: (B, S, D). ``state=None``: the parallel form; ``state=(C (B, H,
    hd, hd), n (B, H, hd), m (B, H))``: the recurrence from it. Returns (y,
    the new state or None)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = torch.matmul(x, p["wq"].to(x.dtype)).reshape(b, s, h, hd)
    k = torch.matmul(x, p["wk"].to(x.dtype)).reshape(b, s, h, hd)
    v = torch.matmul(x, p["wv"].to(x.dtype)).reshape(b, s, h, hd)
    k = k / torch.sqrt(torch.tensor(float(hd), dtype=F32)).to(k.dtype)
    xf = x.to(F32)
    ig = torch.matmul(xf, p["w_i"].to(F32)) + p["b_i"]          # log-space
    fg = F.logsigmoid(torch.matmul(xf, p["w_f"].to(F32)) + p["b_f"])
    if state is None:
        out = ML.mlstm_parallel(q, k, v, ig, fg)
        new_state = None
    else:
        out, new_state = ML.mlstm_recurrent(q, k, v, ig, fg,
                                            *(t.contiguous() for t in state))
    out = out.reshape(b, s, h * hd).to(x.dtype)
    gate = F.silu(torch.matmul(x, p["skip_gate"].to(x.dtype)))
    y = torch.matmul(out * gate, p["w_o"].to(x.dtype))
    return y, new_state


def mlstm_init_state(cfg, batch, device):
    h, hd = cfg.n_heads, cfg.head_dim
    return (torch.zeros((batch, h, hd, hd), dtype=F32, device=device),
            torch.zeros((batch, h, hd), dtype=F32, device=device),
            torch.zeros((batch, h), dtype=F32, device=device))


# ------------------------------------------------------------------ sLSTM
SL_GATES = ("i", "f", "z", "o")


def slstm_defs(cfg):
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    inner = h * hd
    gates = {}
    for g in SL_GATES:
        gates[f"w_{g}"] = PD((d, inner), "scaled")
        gates[f"r_{g}"] = PD((h, hd, hd), "scaled")
        gates[f"b_{g}"] = PD((inner,), "zeros", F32)
    gates["w_out"] = PD((inner, d), "scaled")
    return gates


def apply_slstm(p, x, cfg, *, state=None):
    """The sLSTM recurrence with exponential gating and its stabilizer. x:
    (B, S, D); ``state=(c, n, h, m)``, each (B, H, hd), or None for the
    initial one. Returns (y, the new state)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    xf = x.to(F32)
    z = tuple((torch.matmul(xf, p[f"w_{g}"].to(F32)).reshape(b, s, h, hd)
               + p[f"b_{g}"].reshape(h, hd)) for g in SL_GATES)
    if state is None:
        state = slstm_init_state(cfg, b, x.device)
    out, new_state = SL.slstm(z, tuple(p[f"r_{g}"] for g in SL_GATES),
                              tuple(t.contiguous() for t in state))
    out = out.reshape(b, s, h * hd)
    y = torch.matmul(out.to(x.dtype), p["w_out"].to(x.dtype))
    return y, new_state


def slstm_init_state(cfg, batch, device):
    h, hd = cfg.n_heads, cfg.head_dim
    z = torch.zeros((batch, h, hd), dtype=F32, device=device)
    return (z, z.clone(), z.clone(),
            torch.full((batch, h, hd), ML.NEG, dtype=F32, device=device))
