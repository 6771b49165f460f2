"""Architecture registry over the configs ported so far. ``get(name)`` returns
a ModelConfig; ``--arch <id>`` in the launchers resolves through here. The
other architectures of ``repro.configs.registry`` raise until their model
families are ported."""
from __future__ import annotations

import importlib

ARCHS = [
    "stablelm_1_6b",
]

ALIASES = {
    "stablelm-1.6b": "stablelm_1_6b",
}


def get(name: str):
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP A8: 'Other model "
            f"families'); ported: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG

