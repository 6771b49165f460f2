"""Native grouped-query attention (GQA) indexing shared by the kernels.

The kernels run on head-flattened operands: queries as ``(B·H, S, D)`` and —
natively, without repeating them — keys/values as ``(B·Hk, S, D)``. A
flattened query-head index ``b = batch·H + h`` reads the KV rows of its
group's single KV head:

    kv_head_index(b) = (b // H)·Hk + (b % H) // g,   g = H // Hk

The CUDA kernels compute the same map from ``blockIdx`` (``csrc/``).
"""
from __future__ import annotations


def kv_head_index(b, n_heads: int, n_kv_heads: int):
    """Map a flattened query-head index to its flattened KV-head index.

    ``b`` may be a python int or an integer tensor; ``n_heads`` /
    ``n_kv_heads`` are static. Identity when the head counts match.
    """
    if n_heads == n_kv_heads:
        return b
    group = n_heads // n_kv_heads
    return (b // n_heads) * n_kv_heads + (b % n_heads) // group


def validate_group(n_heads: int, n_kv_heads: int) -> int:
    """Check GQA divisibility up front; returns the group size ``H // Hk``."""
    if n_kv_heads <= 0 or n_heads % n_kv_heads:
        raise ValueError(
            f"GQA requires the query head count to be a multiple of the KV head "
            f"count; got n_heads={n_heads}, n_kv_heads={n_kv_heads} "
            f"(check the model config's `n_kv_heads` field)")
    return n_heads // n_kv_heads
