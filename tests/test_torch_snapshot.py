"""Engine snapshots in the port (``repro_torch.serve.snapshot``).

Within the port: a crash restored from the latest snapshot finishes every
stream bitwise; snapshots are observation only; a corrupted snapshot and
another config are refused; the pools round-trip bit for bit. Against the
reference: a snapshot the reference wrote loads through the port's
``load_engine_snapshot`` with every digest verified; its host state equals
the port's own snapshot at the same engine step field by field (except
``cfg_key``, and the float logprobs within 2e-5), and its pool leaves have
the port's keys, shapes and dtypes. ``restore_engine`` across the packages
is refused (``cfg_key`` hashes each package's config repr)."""
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro.serve import snapshot as JSN
from repro_torch.ckpt import checkpoint as C
from repro_torch.configs import registry
from repro_torch.faults import EngineCrash, Fault, FaultPlan, Injector
from repro_torch.models.convert import from_jax_params
from repro_torch.serve import snapshot as SN
from repro_torch.serve.engine import ContinuousEngine, SampleConfig
from repro_torch.verify import digest as D

GEN = 8
PROMPT_LENS = [5, 13, 32, 7, 21, 9, 17, 3]
ENGINE_KW = dict(n_slots=4, max_seq=64, page_size=8, prefill_chunk=16)


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return {i: rng.randint(1, vocab, size=n).tolist()
            for i, n in enumerate(PROMPT_LENS)}


@pytest.fixture(scope="module")
def setup():
    cfg = registry.get("stablelm-1.6b").reduced()
    jparams = JT.init(jregistry.get("stablelm-1.6b").reduced(),
                      jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return cfg, params, _prompts(cfg.vocab)


def build(setup, *, scfg=SampleConfig(temperature=0.7, seed=11), ids=None,
          **kw):
    cfg, params, prompts = setup
    eng = ContinuousEngine(cfg, params, scfg=scfg, **ENGINE_KW, **kw)
    for i in (ids if ids is not None else sorted(prompts)):
        eng.submit(prompts[i], req_id=i, max_new_tokens=GEN)
    return eng


@pytest.fixture(scope="module")
def baseline(setup):
    eng = build(setup)
    return eng.run(), eng.result_logprobs


def _pool_digests(pools):
    return D.tree_leaf_digests(SN._pool_tree(pools))


# ------------------------------------------------------------ within the port
def test_crash_restore_bitwise(setup, baseline, tmp_path):
    """Injected crash → ``from_snapshot`` → every stream finishes bitwise,
    tokens and logprobs, and the restored engine drains."""
    cfg, params, _ = setup
    inj = Injector(FaultPlan(faults=(Fault(7, "crash"),
                                     Fault(3, "revoke_slot", arg=1))))
    eng = build(setup, faults=inj, snapshot_dir=str(tmp_path),
                snapshot_every=3)
    with pytest.raises(EngineCrash):
        eng.run()
    assert C.available_steps(str(tmp_path)) == [3, 6]
    assert len(eng.snapshot_s) == 2
    eng2 = ContinuousEngine.from_snapshot(str(tmp_path), cfg, params,
                                          faults=inj)
    assert eng2.engine_steps == 6 and eng2.preemptions == eng.preemptions
    got = eng2.run()
    for i in baseline[0]:
        np.testing.assert_array_equal(baseline[0][i], got[i],
                                      err_msg=f"request {i}")
        np.testing.assert_array_equal(baseline[1][i],
                                      eng2.result_logprobs[i])
    assert eng2.cache.free_pages == eng2.cache.layout.n_pages
    assert inj.history[-1]["kind"] == "crash"


def test_snapshot_round_trip_is_exact(setup, tmp_path):
    """Save mid-run, restore: pools bit for bit, host state equal, and the
    restored engine's own snapshot is the same blob."""
    cfg, params, _ = setup
    eng = build(setup)
    for _ in range(3):
        eng.step()
    step = eng.save_snapshot(str(tmp_path / "a"))
    eng2 = ContinuousEngine.from_snapshot(str(tmp_path / "a"), cfg, params)
    assert _pool_digests(eng2.cache.pools) == _pool_digests(eng.cache.pools)
    assert SN._host_state(eng2) == SN._host_state(eng)
    assert eng2.cache.pools["b0_attn"]["attn"][0].device.type == "cpu"
    assert eng2.save_snapshot(str(tmp_path / "b")) == step == 3
    m1 = C.read_manifest(str(tmp_path / "a"), 3)
    m2 = C.read_manifest(str(tmp_path / "b"), 3)
    assert m1["tree_digest"] == m2["tree_digest"]


def test_snapshot_layout_is_the_references(setup, tmp_path):
    """Manifest keys and dtypes as the reference writes them: ``host``
    (uint8), ``pools/<block>/attn/{0,1}`` (bf16 stored as fp32)."""
    eng = build(setup, ids=[0, 1])
    eng.step()
    eng.save_snapshot(str(tmp_path))
    m = C.read_manifest(str(tmp_path), 1)
    assert sorted(m["arrays"]) == ["host", "pools/b0_attn/attn/0",
                                   "pools/b0_attn/attn/1"]
    assert m["arrays"]["host"]["dtype"] == "uint8"
    pool = m["arrays"]["pools/b0_attn/attn/0"]
    assert (pool["dtype"], pool["stored_dtype"]) == ("bfloat16", "float32")
    state, raw, _ = SN.load_engine_snapshot(str(tmp_path))
    assert state["format"] == SN.SNAPSHOT_FORMAT == JSN.SNAPSHOT_FORMAT
    assert raw["pools/b0_attn/attn/0"].dtype == np.float32


def test_snapshot_restore_rejects_wrong_config(setup, tmp_path):
    cfg, params, _ = setup
    eng = build(setup, ids=[0, 1])
    eng.step()
    eng.save_snapshot(str(tmp_path))
    other = registry.get("stablelm-1.6b").reduced(n_layers=2)
    with pytest.raises(ValueError, match="different model config"):
        ContinuousEngine.from_snapshot(str(tmp_path), other, params)


@pytest.mark.parametrize("where", ["pool", "host"])
def test_snapshot_restore_detects_corruption(setup, tmp_path, where):
    """A flipped bit in a pool leaf (an fp32 exponent bit: a low mantissa
    bit of the fp32 storage may round back to the saved bf16) or in the
    host blob is refused."""
    cfg, params, _ = setup
    eng = build(setup, ids=[0, 1])
    eng.step()
    step = eng.save_snapshot(str(tmp_path))
    d = tmp_path / f"step_{step}"
    with np.load(d / "arrays.npz") as data:
        arrays = {k: data[k].copy() for k in data.files}
    key = "pools/b0_attn/attn/1" if where == "pool" else "host"
    flat = arrays[key].reshape(-1).view(np.uint8)
    at = len(flat) // 3
    flat[at - at % 4 + 3 if where == "pool" else at] ^= 0x40
    np.savez(d / "arrays.npz", **arrays)
    with pytest.raises(ValueError, match="digest mismatch"):
        ContinuousEngine.from_snapshot(str(tmp_path), cfg, params)


def test_snapshot_restore_detects_torn_bytes(setup, tmp_path):
    cfg, params, _ = setup
    eng = build(setup, ids=[0, 1])
    eng.step()
    step = eng.save_snapshot(str(tmp_path))
    npz = glob.glob(str(tmp_path / f"step_{step}" / "arrays.npz"))[0]
    blob = bytearray(open(npz, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(npz, "wb").write(bytes(blob))
    with pytest.raises(Exception):
        ContinuousEngine.from_snapshot(str(tmp_path), cfg, params)


def test_snapshot_unarmed_engine_unaffected(setup, baseline, tmp_path):
    eng = build(setup, snapshot_dir=str(tmp_path), snapshot_every=4)
    got = eng.run()
    for i in baseline[0]:
        np.testing.assert_array_equal(baseline[0][i], got[i])
    steps = C.available_steps(str(tmp_path))
    assert len(steps) == 3 and all(s % 4 == 0 for s in steps)  # newest 3


def test_snapshot_of_a_separate_drafter_needs_its_params(setup, tmp_path):
    cfg, params, _ = setup
    eng = build(setup, spec_k=2, draft_cfg=cfg, draft_params=params)
    eng.step()
    eng.save_snapshot(str(tmp_path))
    m = C.read_manifest(str(tmp_path), 1)
    assert "draft_pools/b0_attn/attn/0" in m["arrays"]
    with pytest.raises(ValueError, match="separate drafter"):
        ContinuousEngine.from_snapshot(str(tmp_path), cfg, params)
    other = registry.get("stablelm-1.6b").reduced(d_ff=128)
    with pytest.raises(ValueError, match="drafter config mismatch"):
        ContinuousEngine.from_snapshot(str(tmp_path), cfg, params,
                                       draft_cfg=other, draft_params=params)
    eng2 = ContinuousEngine.from_snapshot(str(tmp_path), cfg, params,
                                          draft_cfg=cfg, draft_params=params)
    assert _pool_digests(eng2.spec.pools) == _pool_digests(eng.spec.pools)


def test_load_engine_snapshot_of_an_empty_directory(tmp_path):
    with pytest.raises(FileNotFoundError):
        SN.load_engine_snapshot(str(tmp_path))


def test_deadlines_and_quarantine_survive_a_restore(setup, baseline,
                                                    tmp_path):
    """A snapshot taken under a quarantine, a stall and pending deadlines
    restores them: the restored run cancels and finishes as the straight
    one does."""
    cfg, params, prompts = setup
    plan = FaultPlan(faults=(Fault(2, "pool_exhaust", arg=20, duration=6),
                             Fault(3, "decode_stall", arg=3)))

    def start():
        eng = ContinuousEngine(cfg, params, faults=Injector(plan),
                               scfg=SampleConfig(temperature=0.7, seed=11),
                               **ENGINE_KW)
        for i in sorted(prompts):
            eng.submit(prompts[i], req_id=i, max_new_tokens=GEN,
                       deadline_steps=9 if i == 7 else None)
        return eng

    straight = start()
    got = straight.run()
    eng = start()
    for _ in range(4):
        eng.step()
    assert eng._quarantine and eng._stall_until > 4
    eng.save_snapshot(str(tmp_path))
    eng2 = ContinuousEngine.from_snapshot(str(tmp_path), cfg, params,
                                          faults=Injector(plan))
    got2 = eng2.run()
    assert sorted(got2) == sorted(got)
    for i in got:
        np.testing.assert_array_equal(got[i], got2[i])
        np.testing.assert_array_equal(got[i], baseline[0][i])
    assert {k: v.tolist() for k, v in eng2.cancelled.items()} == \
        {k: v.tolist() for k, v in straight.cancelled.items()}


# ---------------------------------------------------------- vs the reference
@pytest.fixture(scope="module")
def fp32():
    kw = dict(dtype_name="float32", n_layers=2)
    jcfg = jregistry.get("stablelm-1.6b").reduced(**kw)
    tcfg = registry.get("stablelm-1.6b").reduced(**kw)
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("steps,spec_k", [(3, 0), (6, 0), (2, 2)])
def test_reference_snapshot_loads_through_the_port(fp32, tmp_path, steps,
                                                   spec_k):
    """Both engines on the same requests and plan (greedy fp32) to the same
    engine step, each snapshotted: the reference's snapshot loads through
    the port with every digest verified, its host state is the port's
    field by field, its pool leaves have the port's keys, shapes and
    dtypes; restoring it into the port refuses the foreign config key."""
    jcfg, tcfg, jparams, tparams = fp32
    from repro.faults import Fault as JFault
    from repro.faults import FaultPlan as JPlan
    from repro.faults import Injector as JInjector
    prompts = _prompts(tcfg.vocab)
    faults = ((2, "revoke_slot", 1, 1), (4, "pool_exhaust", 12, 3))
    kw = dict(ENGINE_KW, spec_k=spec_k, max_queue_depth=7)
    jeng = JE.ContinuousEngine(jcfg, jparams, **kw, faults=JInjector(
        JPlan(faults=tuple(JFault(*f) for f in faults))))
    teng = ContinuousEngine(tcfg, tparams, **kw, faults=Injector(
        FaultPlan(faults=tuple(Fault(*f) for f in faults))))
    for eng in (jeng, teng):
        for i, p in prompts.items():
            try:
                eng.submit(p, req_id=i, max_new_tokens=GEN,
                           deadline_steps=20 if i == 5 else None)
            except RuntimeError:
                pass
        for _ in range(steps):
            eng.step()
    jeng.save_snapshot(str(tmp_path / "ref"))
    teng.save_snapshot(str(tmp_path / "port"))
    ref, ref_raw, ref_m = SN.load_engine_snapshot(str(tmp_path / "ref"))
    own, own_raw, own_m = SN.load_engine_snapshot(str(tmp_path / "port"))
    assert sorted(ref) == sorted(own)
    floats = {"active", "results", "result_logprobs", "resume"}
    for key in sorted(set(ref) - floats - {"cfg_key"}):
        assert ref[key] == own[key], key
    assert ref["cfg_key"] != own["cfg_key"]
    for slot_r, slot_o in zip(ref["active"], own["active"]):
        assert slot_r[:5] + slot_r[6:] == slot_o[:5] + slot_o[6:]
        np.testing.assert_allclose(slot_r[5], slot_o[5], atol=2e-5,
                                   rtol=2e-5)
    assert ref["results"] == own["results"]
    for rid in ref["result_logprobs"]:
        np.testing.assert_allclose(ref["result_logprobs"][rid],
                                   own["result_logprobs"][rid], atol=2e-5,
                                   rtol=2e-5)
    assert {r: p for r, (p, _) in ref["resume"].items()} == \
        {r: p for r, (p, _) in own["resume"].items()}
    assert sorted(ref_m["arrays"]) == sorted(own_m["arrays"])
    for key, entry in ref_m["arrays"].items():
        mine = own_m["arrays"][key]
        assert (entry["dtype"], entry["stored_dtype"]) == (
            mine["dtype"], mine["stored_dtype"]), key
        if key != "host":       # the blob's length follows its floats
            assert entry["shape"] == mine["shape"], key
            assert ref_raw[key].shape == own_raw[key].shape
    if steps == 6:
        assert ref["quarantine"] and ref["preemptions"] > 0
    with pytest.raises(ValueError, match="different model config"):
        SN.restore_engine(str(tmp_path / "ref"), tcfg, tparams)


def test_reference_snapshot_digests_are_verified(fp32, tmp_path):
    """A flipped bit in a pool leaf of the reference's snapshot is refused
    by the port's loader."""
    jcfg, _, jparams, _ = fp32
    jeng = JE.ContinuousEngine(jcfg, jparams, **ENGINE_KW)
    for i, p in _prompts(jcfg.vocab).items():
        jeng.submit(p, req_id=i, max_new_tokens=GEN)
    jeng.step()
    step = jeng.save_snapshot(str(tmp_path))
    SN.load_engine_snapshot(str(tmp_path))
    d = tmp_path / f"step_{step}"
    with np.load(d / "arrays.npz") as data:
        arrays = {k: data[k].copy() for k in data.files}
    arrays["pools/b0_attn/attn/0"].reshape(-1)[7] += 1.0
    np.savez(d / "arrays.npz", **arrays)
    with pytest.raises(ValueError, match="digest mismatch for 'pools/"):
        SN.load_engine_snapshot(str(tmp_path))
    state = json.loads(bytes(arrays["host"]).decode())
    assert state["format"] == 2 and os.path.isdir(d)
    assert torch.from_numpy(arrays["host"]).dtype == torch.uint8
