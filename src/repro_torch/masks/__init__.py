"""repro_torch.masks — block-sparse mask subsystem (port of ``repro.masks``).

Declarative :mod:`~repro_torch.masks.spec` mask specs classify tiles into
FULL / PARTIAL / EMPTY block maps, and :mod:`~repro_torch.masks.schedule`
compiles a block map into a deterministic
:class:`repro_torch.core.schedules.Schedule` (ragged worker chains +
per-column reduction orders) that drives the masked backward kernels.
"""
from repro_torch.masks.spec import (EMPTY, FULL, PARTIAL, And, Causal,
                                    Document, Full, MaskSpec, Or, PrefixLM,
                                    Sink, SlidingWindow, streaming_mask)
from repro_torch.masks.schedule import (PLACEMENTS, cached_block_schedule,
                                        compile_block_schedule,
                                        ragged_columns)


def cache_info():
    """lru statistics for every schedule/block-map memo in the stack, keyed
    by cache name — ``{"hits", "misses", "maxsize", "currsize"}`` each.

    The caches keep schedule compilation off the step path: a miss storm on
    a fixed shape set is a key-space bug."""
    from repro_torch.core.schedules import cached_schedule
    from repro_torch.masks.spec import _block_map
    return {
        "cached_schedule": cached_schedule.cache_info()._asdict(),
        "cached_block_schedule": cached_block_schedule.cache_info()._asdict(),
        "block_map": _block_map.cache_info()._asdict(),
    }


__all__ = [
    "EMPTY", "PARTIAL", "FULL",
    "MaskSpec", "Full", "Causal", "SlidingWindow", "PrefixLM", "Document",
    "Sink", "And", "Or", "streaming_mask",
    "PLACEMENTS", "compile_block_schedule", "cached_block_schedule",
    "ragged_columns", "cache_info",
]
