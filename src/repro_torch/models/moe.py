"""Mixture-of-Experts FFN with a deterministic router.

Counterpart of ``repro.models.moe`` over the same parameter layout:
``router`` (d, e) in fp32, ``w_up``/``w_gate`` (e, d, f), ``w_down``
(e, f, d). Two dispatch implementations give the same routing:

* :func:`apply_moe` (``moe_impl="einsum"``): the one-hot formulation — a
  (b, s, e, c) dispatch tensor gathers each expert's queue with one product
  and a combine tensor of gates scatters the outputs back;
* :func:`apply_moe_gather` (``moe_impl="gather"``): two stable argsorts
  over the expert ids and two gathers, no (b, s, e, c) tensor.

What makes routing a function of the data alone, on any device:

* the router runs in fp32 (``x.float() @ router``, fp32 softmax);
* top-k breaks ties toward the lowest expert index: a stable descending
  sort, sliced to k (``torch.topk`` promises no tie order on the card);
* a token's place in its expert's queue is an exclusive cumulative sum in
  (s, k) scan order, taken in integers, so it is exact whatever order the
  device adds in; a place at or past the capacity drops the token
  (``keep``), a pure function of the routing;
* the gather path's argsorts are stable (ties by position).

The expert products run in ``cfg.dtype`` as ``torch.einsum``, as the
reference's einsums do (no fp32 accumulation type), and the dispatch and
combine tensors are cast to ``cfg.dtype`` where the reference casts them.
The aux loss is the Switch load-balancing loss in fp32. With
``cfg.moe_groups > 1`` the sequence splits into token-parallel dispatch
groups when the reference's condition holds; on one device that only
changes which tokens compete for capacity.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.layers import activate
from repro_torch.models.module import ParamDef as PD

F32 = torch.float32


def moe_defs(cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": PD((d, e), "scaled", F32),
        "w_up": PD((e, d, f)),
        "w_down": PD((e, f, d), "scaled"),
    }
    if cfg.activation in ("silu", "geglu"):
        p["w_gate"] = PD((e, d, f))
    return p


def _act(h_gate, h_up, cfg):
    return activate(h_gate, h_up, cfg.activation)


def _groups(x, cfg):
    """The token-parallel dispatch groups: (b0·g, s0/g, d) when
    ``moe_groups`` = g splits the sequence and every group still fills the
    experts (the reference's condition), else ``x``."""
    b0, s0, d = x.shape
    gpr = cfg.moe_groups
    if gpr > 1 and s0 % gpr == 0 and (s0 // gpr) * cfg.top_k >= cfg.n_experts:
        return x.reshape(b0 * gpr, s0 // gpr, d)
    return x


def capacity(s: int, cfg) -> int:
    """Slots per expert and group: ``s·k/e·capacity_factor`` truncated, then
    rounded up to a multiple of 8, at least 8 (the reference's expression,
    evaluated in the same order)."""
    cap = int(s * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, (cap + 7) // 8 * 8)


def route(p, x, cfg):
    """fp32 router: (probs (b, s, e), gate_vals (b, s, k), gate_idx (b, s, k)
    int64). Ties go to the lowest expert index; ``renorm_topk`` rescales the
    k gates to sum to one."""
    logits = torch.matmul(x.to(F32), p["router"].to(F32))
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.top_k
    gate_vals, gate_idx = vals[..., :k], idx[..., :k]
    if cfg.renorm_topk:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    return probs, gate_vals, gate_idx


def one_hot(idx, n: int):
    """int64 one-hot of ``idx`` over ``n`` classes (a compare, so no
    device sync for a range check)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def queue_positions(gate_idx, n_experts: int):
    """Each (token, k)'s place in its expert's queue, in (s, k) scan order:
    the exclusive cumulative sum over the (b, s·k, e) one-hot, in int64.
    Returns (onehot (b, s, k, e) int64, pos (b, s, k) int64)."""
    b, s, k = gate_idx.shape
    onehot = one_hot(gate_idx, n_experts)
    flat = onehot.reshape(b, s * k, n_experts)
    pos = ((torch.cumsum(flat, dim=1) - flat).reshape(b, s, k, n_experts)
           * onehot).sum(-1)
    return onehot, pos


def _aux(probs, top1, e):
    """Switch load-balancing loss: e · Σ_e mean(probs) · mean(top-1 one-hot),
    in fp32."""
    me = probs.mean(dim=(0, 1))
    ce = one_hot(top1, e).to(F32).mean(dim=(0, 1))
    return e * torch.sum(me * ce)


def _experts(p, xin, cfg):
    """The expert FFNs over (e, b, c, d) queues, in ``cfg.dtype``."""
    dt = cfg.dtype
    up = torch.einsum("ebcd,edf->ebcf", xin, p["w_up"].to(dt))
    gate = (torch.einsum("ebcd,edf->ebcf", xin, p["w_gate"].to(dt))
            if "w_gate" in p else up)
    h = _act(gate, up, cfg).to(dt)
    return torch.einsum("ebcf,efd->ebcd", h, p["w_down"].to(dt))


def apply_moe(p, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (y, aux_loss): one-hot einsum dispatch.

    Groups are the batch rows (or, with ``moe_groups``, sub-sequences);
    capacity per group C = :func:`capacity`."""
    b0, s0, d = x.shape
    x = _groups(x, cfg)
    b, s, _ = x.shape
    e = cfg.n_experts
    cap = capacity(s, cfg)

    probs, gate_vals, gate_idx = route(p, x, cfg)
    onehot, pos = queue_positions(gate_idx, e)
    keep = pos < cap
    gate_vals = gate_vals * keep

    # (b, s, k, c) one-hot of the queue place; a dropped place matches none
    cap_oh = (pos[..., None] == torch.arange(cap, device=x.device)).to(F32)
    onehot_f = onehot.to(F32)
    dispatch = torch.einsum("bske,bskc->bsec", onehot_f, cap_oh)
    combine = torch.einsum("bske,bskc->bsec", onehot_f * gate_vals[..., None],
                           cap_oh)

    dt = cfg.dtype
    xin = torch.einsum("bsec,bsd->ebcd", dispatch.to(dt), x)
    out = _experts(p, xin, cfg)
    y = torch.einsum("bsec,ebcd->bsd", combine.to(dt), out)

    aux = _aux(probs, gate_idx[:, :, 0], e)
    y = y.to(x.dtype)
    if b != b0:
        y = y.reshape(b0, s0, d)
    return y, aux


def apply_moe_gather(p, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (y, aux_loss): sort/gather dispatch.

    A stable argsort of the slots' expert ids lays each expert's queue out
    contiguously (ties by slot, so the dropped set is the einsum path's); a
    gather fills the (e, b, c, d) queues and another takes each slot's
    output back, weighted by its gate and ``keep``."""
    b0, s0, d = x.shape
    x = _groups(x, cfg)
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(s, cfg)
    sk = s * k
    dev = x.device

    probs, gate_vals, gate_idx = route(p, x, cfg)
    eid = gate_idx.reshape(b, sk)                     # expert of each slot
    gates = gate_vals.reshape(b, sk)
    order = torch.argsort(eid, dim=1, stable=True)    # slots grouped by expert
    inv = torch.argsort(order, dim=1, stable=True)    # slot -> sorted place

    counts = one_hot(eid, e).sum(1)                              # (b, e)
    starts = torch.cumsum(counts, dim=1) - counts                # exclusive

    # dispatch: xin[b, e, c] = x[token of the c-th routed slot of e]
    cpos = torch.arange(cap, device=dev)[None, None, :]
    src_slot = torch.clamp(starts[:, :, None] + cpos, 0, sk - 1)  # (b, e, c)
    valid_in = cpos < counts[:, :, None]
    tok_of_sorted = torch.gather(order, 1, src_slot.reshape(b, e * cap))
    tok_idx = tok_of_sorted // k                                  # (b, e·c)
    xin = torch.gather(x, 1, tok_idx[..., None].expand(b, e * cap, d))
    xin = xin.reshape(b, e, cap, d) * valid_in[..., None].to(x.dtype)
    out = _experts(p, xin.transpose(0, 1), cfg)                   # (e,b,c,d)

    # combine: a slot's output sits at (eid, rank) if rank < cap
    rank = inv - torch.gather(starts, 1, eid)                     # (b, sk)
    keep = rank < cap
    slot = torch.clamp(eid * cap + rank, 0, e * cap - 1)
    out_flat = out.transpose(0, 1).reshape(b, e * cap, d)
    y_slots = torch.gather(out_flat, 1, slot[..., None].expand(b, sk, d))
    y_slots = y_slots * (gates * keep)[..., None].to(cfg.dtype)
    y = y_slots.reshape(b, s, k, d).sum(2)

    aux = _aux(probs, gate_idx[:, :, 0], e)
    y = y.to(x.dtype)
    if b != b0:
        y = y.reshape(b0, s0, d)
    return y, aux


def apply(p, x, cfg):
    """The configured dispatch (``cfg.moe_impl``)."""
    fn = apply_moe_gather if cfg.moe_impl == "gather" else apply_moe
    return fn(p, x, cfg)
