"""repro_torch.masks — block-sparse mask subsystem (port of ``repro.masks``).

Declarative :mod:`~repro_torch.masks.spec` mask specs classify tiles into
FULL / PARTIAL / EMPTY block maps, and :mod:`~repro_torch.masks.schedule`
compiles a block map into a deterministic
:class:`repro_torch.core.schedules.Schedule` (ragged worker chains +
per-column reduction orders) that drives the masked backward kernels.
The reference's ``cache_info`` is not ported yet (ROADMAP A7).
"""
from repro_torch.masks.spec import (EMPTY, FULL, PARTIAL, And, Causal,
                                    Document, Full, MaskSpec, Or, PrefixLM,
                                    Sink, SlidingWindow, streaming_mask)
from repro_torch.masks.schedule import (PLACEMENTS, cached_block_schedule,
                                        compile_block_schedule,
                                        ragged_columns)

__all__ = [
    "EMPTY", "PARTIAL", "FULL",
    "MaskSpec", "Full", "Causal", "SlidingWindow", "PrefixLM", "Document",
    "Sink", "And", "Or", "streaming_mask",
    "PLACEMENTS", "compile_block_schedule", "cached_block_schedule",
    "ragged_columns",
]
