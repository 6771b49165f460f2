"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import neither
JAX nor the JAX package, and entry points refuse to fall back to the CPU."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len([m for m in sys.modules if m.startswith("repro_torch")]))
if bad:
    raise SystemExit("imported: " + ", ".join(bad))
"""

FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro(\.|\s+import\b))", re.MULTILINE)


def test_importing_the_port_pulls_in_no_jax():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 26     # every submodule imported


def test_sources_do_not_import_jax_or_the_jax_package():
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) >= 26
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in sources for m in FORBIDDEN.finditer(p.read_text())]
    assert not offenders, offenders


# CUDA's atomic functions (atomicAdd, cuda::atomic_ref, ...) and PTX's
# atom.* / red.* instructions: a sum whose order follows thread timing
ATOMIC = re.compile(r"atomic|\batom\.|\bred\.", re.IGNORECASE)


def test_kernel_sources_use_no_atomics():
    """The port's no-atomics rule: every reduction of the kernels has a
    fixed order, so no CUDA source or header names an atomic operation."""
    sources = sorted((PORT / "kernels" / "csrc").glob("*.cu*"))
    assert len(sources) >= 5
    offenders = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
                 for p in sources
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if ATOMIC.search(line)]
    assert not offenders, offenders


def test_entry_points_refuse_to_run_on_the_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    from repro_torch.configs import registry
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import from_jax_params
    cfg = registry.get("stablelm-1.6b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced", "--prompt-len", "128", "--gen", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "2", "--batch", "2", "--seq",
                    "128"])


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_build_sources_are_the_cuda_sources():
    """``kernels/build.py``'s SOURCES name every ``csrc/*.cu`` and nothing
    else, so ``build.build()`` (chip_smoke.py's build phase) compiles each
    kernel of the port, the xLSTM ones included."""
    from repro_torch.kernels import build
    on_disk = sorted(p.stem for p in (PORT / "kernels" / "csrc").glob("*.cu"))
    assert sorted(build.SOURCES) == on_disk
    assert {"mlstm", "slstm", "selective_scan"} <= set(build.SOURCES)
