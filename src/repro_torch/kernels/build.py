"""Build the CUDA sources under ``csrc/`` into shared libraries and load them.

Each source ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``<repo>/build/repro_torch/lib<name>-<hash>.so``
(the hash covers the source and the headers beside it, so an edited source
never loads a stale build), then loaded with :mod:`ctypes`. Building happens at first use, never at
import; :func:`build` compiles several sources at once, one ``nvcc`` process
each, all started together (:func:`build_variants` also with ``-D``
defines, each pair its own library).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_fwd", "flash_bwd", "fold", "paged_attn", "gemm", "rows",
           "fingerprint", "paged_attn_v1", "gemm_v1", "rows_v1",
           "selective_scan", "selective_scan_v1", "mlstm", "slstm", "mlstm_v1",
           "slstm_v1", "mlstm_parallel_v1", "mlstm_parallel_bwd", "slstm_bwd",
           "mlstm_parallel_bwd_v1")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """The build of ``csrc/<name>.cu`` (with ``-D`` of each of ``defines``),
    named by a hash of the source, of every header in ``csrc/`` and of the
    defines."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    for define in defines:
        digest.update(b"-D" + define.encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES,
          defines: Tuple[str, ...] = ()) -> Dict[str, dict]:
    """Compile every named source that has no current build, in parallel,
    each with ``-D`` of every entry of ``defines`` (a variant: its own
    library, as for the kernels' clock64() stamps).

    Returns ``{name: {"path", "seconds", "ptxas"}}`` (``seconds`` 0 for a
    library that was already built; ``ptxas`` is the compiler's report,
    kept beside the library). Raises with the compiler's output if any
    build fails.
    """
    defines = tuple(defines)
    names = list(names)
    built = build_variants([(name, defines) for name in names])
    return {name: built[(name, defines)] for name in names}


def build_variants(jobs: Iterable[Tuple[str, Tuple[str, ...]]]
                   ) -> Dict[Tuple[str, Tuple[str, ...]], dict]:
    """:func:`build` of several (source, defines) pairs at once, one ``nvcc``
    process each, all started together; keyed by the pair."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    result, running = {}, {}
    for name, defines in jobs:
        key = (name, tuple(defines))
        out = library_path(*key)
        if out.exists():
            log = out.with_suffix(".ptxas")
            result[key] = {"path": out, "seconds": 0.0,
                           "ptxas": log.read_text() if log.exists() else ""}
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in key[1]), "-o",
               str(tmp), str(CSRC / f"{name}.cu")]
        # the compiler's report goes to a file, so that each build's own
        # time can be taken as it ends, whatever the order
        log = tmp.with_suffix(".log").open("w+")
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        running[key] = (proc, log, tmp, out, time.perf_counter())
    failed, seconds = [], {}
    while len(seconds) < len(running):
        for key, (proc, _, _, _, t0) in running.items():
            if key not in seconds and proc.poll() is not None:
                seconds[key] = time.perf_counter() - t0
        time.sleep(0.05)
    for key, (proc, log, tmp, out, _) in running.items():
        log.seek(0)
        text = log.read()
        log.close()
        os.remove(log.name)
        if proc.returncode != 0:
            failed.append(f"{key[0]}.cu {list(key[1])} (exit "
                          f"{proc.returncode}):\n{text}")
            continue
        out.with_suffix(".ptxas").write_text(text)
        os.replace(tmp, out)
        result[key] = {"path": out, "seconds": seconds[key], "ptxas": text}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return result


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built with ``defines``),
    built first if needed."""
    key = (name, tuple(defines))
    if key not in _LIBS:
        _LIBS[key] = ctypes.CDLL(
            str(build([name], key[1])[name]["path"]))
    return _LIBS[key]
