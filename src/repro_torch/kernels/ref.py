"""Dense fp32 oracle for the DASH attention kernels.

All math in fp32 regardless of input dtype (the kernels accumulate in fp32
too). ``mha_fwd`` returns (out, lse); ``mha_bwd`` implements Algorithm 1's formulas
(paper Appendix C) without tiling, as ``repro.kernels.ref.mha_bwd`` does.
"""
from __future__ import annotations

import torch


def _mask(logits, causal):
    """End-aligned causal triangle (query i sees keys <= i + sk - sq), as in
    ``repro.kernels.ref``. Masked lanes go to -inf."""
    if not causal:
        return logits
    sq, sk = logits.shape[-2], logits.shape[-1]
    msk = torch.ones((sq, sk), dtype=torch.bool,
                     device=logits.device).tril(sk - sq)
    return logits.masked_fill(~msk, float("-inf"))


def mha_fwd(q, k, v, causal=False, sm_scale=None):
    """Reference attention forward.

    Args:  q, k, v: (BH, S, D) tensors (batch*heads flattened).
    Returns: out (BH, S, D) in q.dtype, lse (BH, S) fp32.
    """
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    s = _mask(s, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    return out.to(q.dtype), lse


def mha_bwd(q, k, v, out, lse, do, causal=False, sm_scale=None):
    """Reference backward (Algorithm 1 math, untiled).

    Args:  q, k, v, out, do: (BH, S, D); lse: (BH, S) fp32 (natural log).
    Returns: dq, dk, dv in fp32.
    """
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof, outf = do.float(), out.float()
    s = _mask(torch.einsum("bqd,bkd->bqk", qf, kf) * sm_scale, causal)
    p = torch.exp(s - lse[..., None])                    # (BH, Sq, Sk)
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    delta = torch.sum(dof * outf, dim=-1)                # D = rowsum(dO ∘ O)
    ds = p * (dp - delta[..., None]) * sm_scale
    dq = torch.einsum("bqk,bkd->bqd", ds, kf)
    dk = torch.einsum("bqk,bqd->bkd", ds, qf)
    return dq, dk, dv
