"""The port's checkpoints (``repro_torch.ckpt.checkpoint``): the cases of the
reference's ``tests/test_fault_tolerance.py`` that need no mesh and all of
``tests/test_ckpt_retry.py``, run on the port; plus the cross-package
format: the port's manifest for a state bridged from the reference has the
reference's leaf keys, leaf digests and tree digest, and a checkpoint
written by either package restores in the other bit for bit."""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as JC
from repro.configs import registry as jregistry
from repro.train import optimizer as JO
from repro.train import step as JS
from repro_torch.ckpt import checkpoint as C
from repro_torch.configs import registry
from repro_torch.models.convert import from_jax_params
from repro_torch.train import optimizer as O
from repro_torch.train import step as S
from repro_torch.verify import digest as D


def _small_state():
    cfg = registry.get("stablelm-1.6b").reduced()
    tcfg = S.TrainConfig(opt=O.OptConfig(total_steps=10))
    return S.init_state(cfg, tcfg, seed=0, device="cpu")


def _assert_bitwise(a, b):
    la, lb = O.tree_leaves(a), O.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert D.leaf_digest(x) == D.leaf_digest(y)


def _no_torn_tmp(directory):
    return not any(n.startswith(".tmp") for n in os.listdir(directory))


# ------------------------------------------------ tests/test_fault_tolerance
def test_checkpoint_roundtrip_bitwise(tmp_path):
    state = _small_state()
    C.save(str(tmp_path), 5, state)
    assert C.available_steps(str(tmp_path)) == [5]
    restored = C.restore(str(tmp_path), 5, state)
    _assert_bitwise(state, restored)
    assert restored["step"].shape == () and restored["step"].dtype == \
        torch.int32
    m = C.read_manifest(str(tmp_path), 5)
    assert m["format_version"] == C.FORMAT_VERSION == 2
    assert m["tree_digest"] == D.tree_digest(state)


def test_checkpoint_async_and_gc(tmp_path):
    state = _small_state()
    threads = [C.save(str(tmp_path), s, state, async_=True, keep_last=2)
               for s in (1, 2, 3)]
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive() and t.stats["write_s"] >= 0
    assert C.available_steps(str(tmp_path)) == [2, 3]


def test_checkpoint_atomic_under_partial_write(tmp_path):
    """A directory without a manifest (crashed mid-save) is never listed,
    nor is the ``.tmp_step_*`` directory a killed async writer leaves."""
    state = _small_state()
    C.save(str(tmp_path), 7, state)
    os.makedirs(tmp_path / "step_9")          # torn save: no manifest
    os.makedirs(tmp_path / ".tmp_step_11")    # killed writer
    (tmp_path / ".tmp_step_11" / "manifest.json").write_text("{}")
    assert C.latest_step(str(tmp_path)) == 7


def test_manifest_records_original_bf16_dtype(tmp_path):
    tree = {"w": torch.tensor([1.5, -2.25, 3e-2], dtype=torch.bfloat16),
            "b": torch.zeros(2)}
    C.save(str(tmp_path), 1, tree)
    manifest = C.read_manifest(str(tmp_path), 1)
    assert manifest["arrays"]["w"]["dtype"] == "bfloat16"
    assert manifest["arrays"]["w"]["stored_dtype"] == "float32"
    assert manifest["arrays"]["b"]["dtype"] == "float32"
    assert manifest["treedef"] == ["b", "w"]


def test_bf16_roundtrip_bitwise_and_wrong_dtype_target_rejected(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(64, generator=gen).to(torch.bfloat16)}
    C.save(str(tmp_path), 1, tree)
    restored = C.restore(str(tmp_path), 1, tree)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16),
                       tree["w"].view(torch.int16))
    with pytest.raises(ValueError, match="dtype mismatch.*'w'"):
        C.restore(str(tmp_path), 1, {"w": torch.zeros(64)})
    with pytest.raises(ValueError, match="shape mismatch.*'w'"):
        C.restore(str(tmp_path), 1, {"w": torch.zeros(65,
                                                      dtype=torch.bfloat16)})


def test_restore_verifies_leaf_digests(tmp_path):
    tree = {"w": torch.arange(16, dtype=torch.float32)}
    C.save(str(tmp_path), 3, tree)
    npz = tmp_path / "step_3" / "arrays.npz"
    corrupt = {"w": np.arange(16, dtype=np.float32)}
    corrupt["w"][7] += 1e-4
    np.savez(npz, **corrupt)
    with pytest.raises(ValueError, match="digest mismatch.*'w'"):
        C.restore(str(tmp_path), 3, tree)
    assert C.restore(str(tmp_path), 3, tree, verify=False) is not None


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_async_save_killed_midwrite_keeps_latest_restorable(tmp_path,
                                                            monkeypatch):
    state = _small_state()
    C.save(str(tmp_path), 5, state)

    def dying_savez(*a, **kw):
        raise RuntimeError("simulated node death mid-write")

    monkeypatch.setattr(C.np, "savez", dying_savez)
    t = C.save(str(tmp_path), 6, state, async_=True)
    t.join(timeout=60)
    monkeypatch.undo()
    assert not t.is_alive() and "write_s" not in t.stats
    assert C.latest_step(str(tmp_path)) == 5
    assert _no_torn_tmp(tmp_path)
    _assert_bitwise(state, C.restore(str(tmp_path), 5, state))


def test_gc_never_deletes_checkpoint_under_concurrent_restore(tmp_path,
                                                              monkeypatch):
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    for s in (1, 2, 3):
        C.save(str(tmp_path), s, tree, keep_last=10)

    entered, release = threading.Event(), threading.Event()
    real_load = C.np.load

    def slow_load(path, *a, **kw):
        entered.set()
        assert release.wait(timeout=30)
        return real_load(path, *a, **kw)

    monkeypatch.setattr(C.np, "load", slow_load)
    result = {}

    def reader():
        result["tree"] = C.restore(str(tmp_path), 1, tree)

    th = threading.Thread(target=reader)
    th.start()
    assert entered.wait(timeout=30)
    C.save(str(tmp_path), 4, tree, keep_last=1)
    assert 1 in C.available_steps(str(tmp_path))
    release.set()
    th.join(timeout=30)
    assert not th.is_alive()
    monkeypatch.undo()
    assert torch.equal(result["tree"]["w"], tree["w"])
    C._gc(str(tmp_path), 1)
    assert C.available_steps(str(tmp_path)) == [4]


def test_same_step_overwrite_waits_for_concurrent_restore(tmp_path):
    old = {"w": torch.arange(8, dtype=torch.float32)}
    new = {"w": torch.arange(8, dtype=torch.float32) + 1}
    C.save(str(tmp_path), 2, old)
    with C._reading(str(tmp_path), 2):
        t = C.save(str(tmp_path), 2, new, async_=True)
        t.join(timeout=0.5)
        assert t.is_alive()                 # publish is parked on the pin
        assert torch.equal(C.restore(str(tmp_path), 2, old)["w"], old["w"])
    t.join(timeout=30)
    assert not t.is_alive()
    assert torch.equal(C.restore(str(tmp_path), 2, new)["w"], new["w"])


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_same_step_overwrite_fails_rather_than_breaking_a_wedged_reader(
        tmp_path, monkeypatch):
    old = {"w": torch.arange(4, dtype=torch.float32)}
    new = {"w": torch.arange(4, dtype=torch.float32) * 2}
    C.save(str(tmp_path), 1, old)
    monkeypatch.setattr(C, "_PUBLISH_PIN_TIMEOUT", 0.05)
    with C._reading(str(tmp_path), 1):
        t = C.save(str(tmp_path), 1, new, async_=True)
        t.join(timeout=30)
        assert not t.is_alive()             # save gave up (TimeoutError)
        assert torch.equal(C.restore(str(tmp_path), 1, old)["w"], old["w"])
    assert _no_torn_tmp(tmp_path)
    assert torch.equal(C.restore(str(tmp_path), 1, old)["w"], old["w"])


# ----------------------------------------------------- tests/test_ckpt_retry
TREE = {"w": torch.arange(24, dtype=torch.float32).reshape(4, 6),
        "b": torch.ones(6)}


def _flaky_hook(fail_attempts, calls, exc=OSError):
    def hook(*, step, attempt):
        calls.append((step, attempt))
        if attempt < fail_attempts:
            raise exc(f"transient (step={step}, attempt={attempt})")
    return hook


@pytest.fixture
def clean_hook():
    assert C._IO_HOOK is None
    yield
    C._IO_HOOK = None


def test_transient_then_success(tmp_path, monkeypatch, clean_hook):
    calls = []
    monkeypatch.setattr(C, "_IO_HOOK", _flaky_hook(C.IO_RETRIES, calls))
    monkeypatch.setattr(C, "RETRY_BACKOFF_S", 0.0)
    C.save(str(tmp_path), 3, TREE)
    assert calls == [(3, a) for a in range(C.IO_RETRIES + 1)]
    restored = C.restore(str(tmp_path), 3,
                         {k: torch.zeros_like(v) for k, v in TREE.items()})
    assert D.tree_digest(restored) == D.tree_digest(TREE)
    assert _no_torn_tmp(tmp_path)


def test_exhausted_retries_surface_original_error(tmp_path, monkeypatch,
                                                  clean_hook):
    calls = []

    class DiskGone(OSError):
        pass

    monkeypatch.setattr(C, "_IO_HOOK",
                        _flaky_hook(C.IO_RETRIES + 10, calls, exc=DiskGone))
    monkeypatch.setattr(C, "RETRY_BACKOFF_S", 0.0)
    with pytest.raises(DiskGone, match="transient"):
        C.save(str(tmp_path), 5, TREE)
    assert calls == [(5, a) for a in range(C.IO_RETRIES + 1)]
    assert C.available_steps(str(tmp_path)) == []
    assert _no_torn_tmp(tmp_path)


def test_non_oserror_is_not_retried(tmp_path, monkeypatch, clean_hook):
    calls = []
    monkeypatch.setattr(C, "_IO_HOOK",
                        _flaky_hook(99, calls, exc=RuntimeError))
    with pytest.raises(RuntimeError):
        C.save(str(tmp_path), 1, TREE)
    assert calls == [(1, 0)]
    assert _no_torn_tmp(tmp_path)


def test_async_writer_retries_too(tmp_path, monkeypatch, clean_hook):
    calls = []
    monkeypatch.setattr(C, "_IO_HOOK", _flaky_hook(1, calls))
    monkeypatch.setattr(C, "RETRY_BACKOFF_S", 0.0)
    t = C.save(str(tmp_path), 7, TREE, async_=True)
    assert isinstance(t, threading.Thread)
    t.join(timeout=60)
    assert not t.is_alive()
    assert calls == [(7, 0), (7, 1)]
    assert C.latest_step(str(tmp_path)) == 7
    assert _no_torn_tmp(tmp_path)


def test_retry_preserves_digests_and_latest(tmp_path, monkeypatch,
                                            clean_hook):
    C.save(str(tmp_path), 1, TREE)
    clean = C.read_manifest(str(tmp_path), 1)
    monkeypatch.setattr(C, "_IO_HOOK", _flaky_hook(1, []))
    monkeypatch.setattr(C, "RETRY_BACKOFF_S", 0.0)
    C.save(str(tmp_path), 2, TREE)
    retried = C.read_manifest(str(tmp_path), 2)
    assert retried["tree_digest"] == clean["tree_digest"]
    assert retried["arrays"] == clean["arrays"]
    assert C.available_steps(str(tmp_path)) == [1, 2]


# ------------------------------------------------------------ cross-package
@pytest.fixture(scope="module")
def bridged():
    """A bf16 reference train state (params + AdamW moments + step) and the
    port's state around the same bridged params."""
    jcfg = jregistry.get("stablelm-1.6b").reduced(n_layers=2)
    tcfg = registry.get("stablelm-1.6b").reduced(n_layers=2)
    opt = dict(total_steps=10)
    jstate = JS.init_state(jcfg, JS.TrainConfig(opt=JO.OptConfig(**opt)),
                           jax.random.PRNGKey(0))
    tstate = S.state_from_params(
        from_jax_params(jax.tree.map(np.asarray, jstate["params"]), tcfg,
                        device="cpu"), S.TrainConfig(opt=O.OptConfig(**opt)))
    return jstate, tstate


def test_manifest_equals_the_references(bridged, tmp_path):
    jstate, tstate = bridged
    JC.save(str(tmp_path / "ref"), 4, jstate)
    C.save(str(tmp_path / "port"), 4, tstate)
    ref = JC.read_manifest(str(tmp_path / "ref"), 4)
    ours = C.read_manifest(str(tmp_path / "port"), 4)
    assert sorted(ours["arrays"]) == sorted(ref["arrays"])
    assert ours["arrays"] == ref["arrays"]      # shape, dtypes, digest
    assert ours["tree_digest"] == ref["tree_digest"]
    assert ours["format_version"] == ref["format_version"]
    assert ours["treedef"] == sorted(ref["arrays"])


def test_reference_checkpoint_restores_in_the_port(bridged, tmp_path):
    jstate, tstate = bridged
    JC.save(str(tmp_path), 2, jstate["params"])
    zeros = O.tree_map(torch.zeros_like, tstate["params"])
    restored = C.restore(str(tmp_path), 2, zeros)
    _assert_bitwise(restored, tstate["params"])
    assert D.tree_digest(restored) == D.tree_digest(
        jax.tree.map(np.asarray, jstate["params"]))


def test_port_checkpoint_restores_in_the_reference(bridged, tmp_path):
    jstate, tstate = bridged
    C.save(str(tmp_path), 2, tstate)
    target = jax.tree.map(jnp.zeros_like, jstate)
    restored = JC.restore(str(tmp_path), 2, target)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(
            np.atleast_1d(np.asarray(a)).view(np.uint8),
            np.atleast_1d(np.asarray(b)).view(np.uint8))
