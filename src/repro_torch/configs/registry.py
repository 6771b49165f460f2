"""Architecture registry over the configs ported so far. ``get(name)`` returns
a ModelConfig; ``--arch <id>`` in the launchers resolves through here. The
other architectures of ``repro.configs.registry`` raise until their model
families are ported. ``drafter_for`` is the reference's speculative-decoding
pairing, over the ported targets."""
from __future__ import annotations

import importlib

ARCHS = [
    "stablelm_1_6b",
    "qwen1_5_110b",
    "nemotron_4_15b",
    "mistral_nemo_12b",
    "phi3_5_moe",
    "llama4_scout",
    "jamba_1_5_large",
    "xlstm_350m",
    "dash_paper",
]

ALIASES = {
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen1.5-110b": "qwen1_5_110b",
    "nemotron-4-15b": "nemotron_4_15b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "llama4-scout-17b-a16e": "llama4_scout",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "xlstm-350m": "xlstm_350m",
    "dash-paper": "dash_paper",
}

# The drafter of each paged-servable target (``serve/spec.py``): the
# registry arch that drafts for it, or None for self-draft. The reference's
# pairing, restricted to the ported archs. Drafter and target must share a
# vocabulary, which the engine checks (true across ``reduced()`` configs).
DRAFTERS = {
    "stablelm_1_6b": None,
    "qwen1_5_110b": "stablelm_1_6b",
    "nemotron_4_15b": "stablelm_1_6b",
    "mistral_nemo_12b": "stablelm_1_6b",
}


def _canon(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get(name: str):
    mod_name = _canon(name)
    if mod_name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP A8: 'Other model "
            f"families'); ported: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def drafter_for(name: str):
    """The drafter arch for ``name`` (aliases resolve), or None for
    self-draft. Raises KeyError for a target without a pairing, as the
    reference does."""
    canon = _canon(name)
    if canon not in DRAFTERS:
        raise KeyError(
            f"{name!r} has no drafter pairing: speculative serving covers "
            f"the paged-servable archs {sorted(DRAFTERS)}")
    return DRAFTERS[canon]
