"""Async, crash-safe checkpoints of train-state trees (nested dicts of tensors).

Port of ``repro.ckpt.checkpoint``, in its on-disk format, so a checkpoint
written by either package restores in the other:
``<dir>/step_<k>/arrays.npz`` + ``manifest.json`` (format version 2: per
leaf its shape, original dtype, stored dtype and
:func:`repro_torch.verify.digest.leaf_digest`, plus the ``tree_digest``).
Leaf keys are the ``/``-joined key paths of :func:`tree_paths`, which equal
the reference's. The reference's ``treedef`` field holds a jax structure
string; the port writes its sorted key list there, and ``restore`` never
reads the field.

Writes go to ``.tmp_step_<k>`` renamed into place, manifest last: a crashed
save never publishes, and a ``.tmp_*`` directory a killed writer leaves is
never listed. npz has no bf16, so a bf16 leaf is stored as its lossless fp32
upcast (through torch: no ``ml_dtypes`` needed); the manifest keeps the
original dtype and the digest of the original bits. ``restore`` refuses a
target leaf of another dtype and re-verifies every leaf digest after the
round trip.

Transient write errors (``OSError`` only) are retried on a fixed schedule
(``IO_RETRIES`` extra attempts, backoff ``RETRY_BACKOFF_S * attempt``). A
restore in flight pins its checkpoint (``_reading``): ``_gc`` skips it, and a
same-step overwrite waits for the pin, failing the save rather than breaking
the reader after ``_PUBLISH_PIN_TIMEOUT`` seconds.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.module import set_path, tree_paths
from repro_torch.verify import digest as D

FORMAT_VERSION = 2

# how long a same-step overwrite save waits for a concurrent restore's read
# pin before failing the save (it never breaks the reader)
_PUBLISH_PIN_TIMEOUT = 60.0

# bounded deterministic retry for transient write IO errors (OSError only):
# IO_RETRIES extra attempts, backoff RETRY_BACKOFF_S * attempt number, no
# jitter. Anything else fails at once.
IO_RETRIES = 2
RETRY_BACKOFF_S = 0.01

# fault-injection seam: when set, called as ``_IO_HOOK(step=, attempt=)`` at
# the top of every write attempt; it may raise OSError. None: no call.
_IO_HOOK = None

# (directory, step) → count of restores in flight
_READS_LOCK = threading.Lock()
_ACTIVE_READS: Dict[Any, int] = {}


@contextlib.contextmanager
def _reading(directory: str, step: int):
    key = (os.path.abspath(directory), int(step))
    with _READS_LOCK:
        _ACTIVE_READS[key] = _ACTIVE_READS.get(key, 0) + 1
    try:
        yield
    finally:
        with _READS_LOCK:
            _ACTIVE_READS[key] -= 1
            if not _ACTIVE_READS[key]:
                del _ACTIVE_READS[key]


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name for a torch dtype (``torch.bfloat16`` → ``"bfloat16"``)."""
    return str(dtype).removeprefix("torch.")


def _to_storage(t: torch.Tensor) -> np.ndarray:
    """The array npz stores: bf16 as its exact fp32 upcast."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _threaded(fn, items):
    """``[fn(x) for x in items]`` on a few threads (device copies release
    the interpreter lock); the result does not depend on the thread count."""
    with ThreadPoolExecutor(max_workers=D._DIGEST_THREADS) as pool:
        return list(pool.map(fn, items))


def _snapshot(tree) -> Dict[str, torch.Tensor]:
    """``{path: host copy}``; the copies do not alias the live tensors."""
    named = list(tree_paths(tree))
    copies = _threaded(lambda x: x.detach().to("cpu", copy=True),
                       [x for _, x in named])
    return {path: c for (path, _), c in zip(named, copies)}


def save(directory: str, step: int, tree, *, async_: bool = False,
         keep_last: int = 3):
    """Checkpoint ``tree`` at ``step``. ``async_=True`` returns the writer
    Thread (join to wait; its ``stats`` dict gets ``write_s``, the writer's
    seconds, when it ends); the device→host copy is made before it starts,
    so the caller may go on changing the live state."""
    flat = _snapshot(tree)
    stats: Dict[str, float] = {}

    def _write():
        t0 = time.perf_counter()
        digests = D.tree_leaf_digests(flat)     # of the original bits
        stored = {k: _to_storage(v) for k, v in flat.items()}
        manifest = {
            "format_version": FORMAT_VERSION,
            "step": step,
            "treedef": sorted(flat),
            "tree_digest": D.combine_leaf_digests(digests),
            "arrays": {k: {"shape": list(flat[k].shape),
                           "dtype": _dtype_name(flat[k].dtype),
                           "stored_dtype": str(stored[k].dtype),
                           "digest": digests[k]}
                       for k in flat},
        }
        tmp = os.path.join(directory, f".tmp_step_{step}")
        final = os.path.join(directory, f"step_{step}")
        for attempt in range(1 + IO_RETRIES):
            try:
                hook = _IO_HOOK
                if hook is not None:
                    hook(step=step, attempt=attempt)
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, "arrays.npz"), **stored)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)              # manifest last
                break
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)
                if attempt == IO_RETRIES:
                    raise
                time.sleep(RETRY_BACKOFF_S * (attempt + 1))
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)  # non-IO: no retry
                raise
        try:
            # publish under the read guard: a same-step overwrite waits for
            # a restore's pin; past the timeout the save fails instead
            key = (os.path.abspath(directory), int(step))
            deadline = time.monotonic() + _PUBLISH_PIN_TIMEOUT
            displaced = None
            while True:
                with _READS_LOCK:
                    if key not in _ACTIVE_READS:
                        if os.path.exists(final):
                            displaced = os.path.join(
                                directory,
                                f".trash_step_{step}_{time.monotonic_ns()}")
                            os.rename(final, displaced)
                        os.rename(tmp, final)           # atomic publish
                        break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"save(step={step}): a concurrent restore held its "
                        f"read pin > {_PUBLISH_PIN_TIMEOUT}s; checkpoint not "
                        "published")
                time.sleep(0.005)
            if displaced is not None:
                shutil.rmtree(displaced, ignore_errors=True)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)      # never leave a torn tmp
            raise
        _gc(directory, keep_last)
        stats["write_s"] = time.perf_counter() - t0

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.stats = stats
        t.start()
        return t
    _write()
    return None


def _gc(directory: str, keep_last: int):
    """Remove all but the newest ``keep_last`` checkpoints, skipping any a
    restore has pinned (pin check and rename under one lock)."""
    trash = []
    for s in sorted(available_steps(directory))[:-keep_last]:
        with _READS_LOCK:
            if (os.path.abspath(directory), s) in _ACTIVE_READS:
                continue
            dst = os.path.join(directory,
                               f".trash_step_{s}_{time.monotonic_ns()}")
            try:
                os.rename(os.path.join(directory, f"step_{s}"), dst)
            except OSError:
                continue
        trash.append(dst)
    for dst in trash:
        shutil.rmtree(dst, ignore_errors=True)


def available_steps(directory: str):
    """Published steps (a ``step_<k>`` directory holding its manifest)."""
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, "manifest.json")):
            out.append(int(name.split("_", 1)[1]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = available_steps(directory)
    return steps[-1] if steps else None


def read_manifest(directory: str, step: int) -> Dict[str, Any]:
    with open(os.path.join(directory, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def restore(directory: str, step: int, target_tree, *, verify: bool = True):
    """Restore into the structure of ``target_tree`` (nested dicts of
    tensors), each leaf on its target leaf's device.

    The manifest's (original) dtypes are authoritative: a target leaf whose
    dtype disagrees raises instead of casting, and with ``verify=True``
    every leaf's digest is re-checked after the storage round trip (bf16 →
    fp32 → bf16 must give back the saved bits).
    """
    with _reading(directory, step):
        path = os.path.join(directory, f"step_{step}")
        manifest = read_manifest(directory, step)
        # v1 manifests recorded the storage dtype for bf16 leaves: their
        # "dtype" field cannot be validated against targets
        entries = (manifest.get("arrays", {})
                   if manifest.get("format_version", 1) >= 2 else {})
        host: Dict[str, torch.Tensor] = {}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for key, ref in tree_paths(target_tree):
                arr = data[key]
                if tuple(arr.shape) != tuple(ref.shape):
                    raise ValueError(f"checkpoint shape mismatch for "
                                     f"'{key}': saved {arr.shape}, target "
                                     f"expects {tuple(ref.shape)}")
                saved_dtype = entries.get(key, {}).get("dtype")  # None: v1
                if (saved_dtype is not None
                        and saved_dtype != _dtype_name(ref.dtype)):
                    raise ValueError(
                        f"checkpoint dtype mismatch for '{key}': saved "
                        f"{saved_dtype}, target expects {ref.dtype} — "
                        "refusing to cast silently (pass a target tree with "
                        "the saved dtypes, then cast explicitly)")
                # fp32 → bf16 on the host gives back the saved bits, and the
                # digest check hashes host memory
                host[key] = torch.from_numpy(np.asarray(arr, order="C")).to(
                    ref.dtype)
        if verify:
            got = D.tree_leaf_digests(host)
            for key, want in ((k, entries.get(k, {}).get("digest"))
                              for k in host):
                if want and got[key] != want:
                    raise ValueError(
                        f"checkpoint digest mismatch for '{key}' at step "
                        f"{step}: manifest {want[:16]}…, restored "
                        f"{got[key][:16]}… — corrupted or lossy round trip")
        named = list(tree_paths(target_tree))
        placed = _threaded(lambda kr: host[kr[0]].to(kr[1].device), named)
        out: Dict[str, Any] = {}
        for (key, _), x in zip(named, placed):
            set_path(out, key, x)
        return out
