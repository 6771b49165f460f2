"""Build the CUDA sources under ``csrc/`` into shared libraries and load them.

Each source ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``<repo>/build/repro_torch/lib<name>-<hash>.so``
(the hash covers the source and the headers beside it, so an edited source
never loads a stale build), then loaded with :mod:`ctypes`. Building happens at first use, never at
import; :func:`build` compiles several sources at once, one ``nvcc`` process
each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_fwd", "flash_bwd", "fold", "paged_attn", "gemm", "rows",
           "fingerprint", "paged_attn_v1", "gemm_v1", "rows_v1",
           "selective_scan", "selective_scan_v1", "mlstm", "slstm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def library_path(name: str) -> Path:
    """The build of ``csrc/<name>.cu``, named by a hash of the source and of
    every header in ``csrc/``."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every named source that has no current build, in parallel.

    Returns ``{name: {"path", "seconds", "ptxas"}}`` (``seconds`` 0 for a
    library that was already built; ``ptxas`` is the compiler's report,
    kept beside the library). Raises with the compiler's output if any
    build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    result, running = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            log = out.with_suffix(".ptxas")
            result[name] = {"path": out, "seconds": 0.0,
                            "ptxas": log.read_text() if log.exists() else ""}
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".ptxas").write_text(log)
        os.replace(tmp, out)
        result[name] = {"path": out, "seconds": seconds, "ptxas": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build([name])[name]["path"]))
    return _LIBS[name]
