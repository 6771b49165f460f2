"""Port parity for the tuner (``repro_torch.tune``) and its shared-memory
budget (``kernels/smem.py``).

  * the enumeration equals the reference's with its 256-block candidates
    removed — same keys, same order — for every geometry the port's kernels
    take, and offers nothing they refuse;
  * under the reference's roofline constants (read from
    ``repro.tune.model`` here) the ranking and every modeled number equal
    the reference's (``==``); the port's own defaults are H100 peaks;
  * the cache, the measure tie-break under fake clocks, ``pick_placement``
    and ``masks.cache_info`` behave as the reference's;
  * ``dash_attention(tune=True)`` is bitwise equal to the hand-picked call,
    and agrees with the reference's ``dash_attention`` at the same knobs
    within the reference's tolerances (fp32: 2e-5 out, 5e-5 grads);
  * the train launcher's ``--tune`` and a fresh process make the same pick.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import masks as JM
from repro import tune as JT
from repro.kernels import ops as jops
from repro.tune import model as jmodel
from repro_torch import masks as TM
from repro_torch import tune as TT
from repro_torch.kernels import flash_fwd as FF
from repro_torch.kernels import ops as tops
from repro_torch.kernels import smem
from repro_torch.launch import train as launch_train
from repro_torch.masks.schedule import cached_block_schedule
from repro_torch.tune import model as tmodel

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = dict(peak_flops=jmodel.PEAK_FLOPS,
           hbm_bytes_per_s=jmodel.HBM_BYTES_PER_S)


def _masks(m, s):
    return {
        "window": m.SlidingWindow(s // 4),
        "prefix": m.PrefixLM(s // 3),
        "document": m.Document.from_lengths((s // 4, s - s // 4)),
        "sink": m.Causal() & m.Sink(s // 16),
    }


GEOMETRIES = [dict(seq_q=s, head_dim=d, causal=c, dtype_bytes=b)
              for s in (128, 256, 512, 1024, 2048) for d in (32, 64, 128)
              for c in (False, True) for b in (2, 4)]


def _keys(cands):
    return [c.key() for c in cands]


@pytest.mark.parametrize("kw", GEOMETRIES,
                         ids=lambda kw: "s{seq_q}-d{head_dim}-c{causal:d}-"
                                        "b{dtype_bytes}".format(**kw))
def test_enumeration_is_the_reference_minus_its_256_blocks(kw):
    ours = TT.enumerate_candidates(**kw)
    ref = JT.enumerate_candidates(**kw)
    assert _keys(ours) == [c.key() for c in ref if c.block_q != 256]
    assert ours == tuple(TT.Candidate(**c.to_dict()) for c in ref
                         if c.block_q != 256)
    assert all(c.block_q == c.block_k == FF.BLOCK for c in ours)


@pytest.mark.parametrize("family", list(_masks(JM, 1024)))
@pytest.mark.parametrize("s", [512, 1024])
def test_mask_enumeration_is_the_reference_minus_its_256_blocks(family, s):
    ours = TT.enumerate_candidates(seq_q=s, head_dim=64,
                                   mask=_masks(TM, s)[family])
    ref = JT.enumerate_candidates(seq_q=s, head_dim=64,
                                  mask=_masks(JM, s)[family])
    assert _keys(ours) == [c.key() for c in ref if c.block_q != 256]
    assert {c.schedule for c in ours} <= {"shift", "fa3"}


def test_no_candidate_the_kernels_would_refuse():
    assert TT.legal_blocks(1024, 1024, 64) == (FF.BLOCK,)
    assert TT.legal_blocks(1024, 1024, 96) == ()        # no such instance
    assert TT.legal_blocks(512, 1024, 64) == ()         # backward: Sq == Sk
    assert TT.legal_blocks(1024, 1024, 64, blocks=(256, 128)) == (128,)
    assert TT.legal_blocks(1024, 1024, 128, smem_budget=0.5) == ()
    with pytest.raises(ValueError, match="no legal candidate"):
        TT.enumerate_candidates(seq_q=100, head_dim=64)
    with pytest.raises(ValueError, match="supersedes"):
        TT.enumerate_candidates(seq_q=512, head_dim=64, causal=True,
                                mask=TM.SlidingWindow(64))


@pytest.mark.parametrize("d", FF.HEAD_DIMS)
def test_smem_footprints(d):
    """The forward's buffers sum to the host arithmetic the kernel shares
    (``fwd_smem_bytes``); the backward's bf16 layout is ``Tc<D>`` of
    ``csrc/flash_bwd.cu`` (K/V + two stages of Q/dO + dS^T hi/lo + lse and
    delta, rows padded by 8), its fp32 one ``Layout<D>``. The card holds
    both equal to the built libraries (``chip_smoke.py``, gpu test)."""
    fwd = smem.fwd_footprint(128, 128, d)
    assert fwd.total == FF.fwd_smem_bytes(d, FF.fwd_stages(d))
    assert fwd.fits() and fwd.total <= FF.SMEM_MAX
    assert smem.fwd_footprint(128, 128, d, 4).total == 2 * 64 * d * 4
    ld = d + 8
    assert smem.bwd_footprint(128, 128, d).total == (
        4 * 128 * ld * 2 + 2 * 128 * 72 * 2 + 4 * 64 * 4)
    assert smem.bwd_footprint(128, 128, d, 4).total == 4 * (
        2 * 128 * (d + 1) + 2 * 32 * (d + 1) + 2 * 128 * 33 + 2 * 128)
    assert smem.best_block(d, causal=True) == FF.BLOCK
    with pytest.raises(ValueError, match="built for"):
        smem.bwd_footprint(256, 256, d)
    with pytest.raises(ValueError, match="bf16"):
        smem.fwd_footprint(128, 128, d, 8)


@pytest.mark.parametrize("causal,mask_family", [
    (False, None), (True, None), (False, "window"), (False, "document")])
@pytest.mark.parametrize("s,d", [(512, 64), (1024, 128), (2048, 32)])
def test_ranking_equals_reference_under_its_constants(s, d, causal,
                                                      mask_family):
    tmask = _masks(TM, s)[mask_family] if mask_family else None
    jmask = _masks(JM, s)[mask_family] if mask_family else None
    ours = tmodel.rank_candidates(
        TT.enumerate_candidates(seq_q=s, head_dim=d, causal=causal,
                                mask=tmask),
        seq_q=s, head_dim=d, causal=causal, mask=tmask, **REF)
    ref = jmodel.rank_candidates(
        [c for c in JT.enumerate_candidates(seq_q=s, head_dim=d,
                                            causal=causal, mask=jmask)
         if c.block_q != 256],
        seq_q=s, head_dim=d, causal=causal, mask=jmask)
    assert [r["candidate"].key() for r in ours] == \
        [r["candidate"].key() for r in ref]
    for a, b in zip(ours, ref):
        for k in ("modeled_makespan_s", "modeled_utilization", "n_tasks",
                  "lower_bound_s"):
            assert a[k] == b[k], k


def test_defaults_are_h100_peaks():
    assert tmodel.PEAK_FLOPS == 989.4e12 and tmodel.HBM_BYTES_PER_S == 3.35e12
    assert tmodel.task_costs(128, 128, 64) == (
        8 * 128 * 128 * 64 / 989.4e12, 8 * 128 * 64 / 3.35e12)
    assert (tmodel.task_costs(128, 128, 64, **REF)
            == jmodel.task_costs(128, 128, 64))


# ------------------------------------------------------------------- cache
class _Log:
    def __init__(self):
        self.events = []

    def log(self, kind, payload):
        self.events.append((kind, payload))


def test_cache_roundtrip_keys_and_self_addressing(tmp_path):
    kw = dict(mask_key="causal", seq_q=1024, seq_kv=1024, head_dim=64,
              n_heads=32, n_kv_heads=32, dtype="bfloat16")
    key = TT.make_key(backend="cuda-sm90", **kw)
    assert key == JT.make_key(backend="cuda-sm90", **kw)
    assert key.endswith("|backend=cuda-sm90")
    assert key != JT.make_key(backend="pallas-tpu", **kw)
    log = _Log()
    cache = TT.TuneCache(root=str(tmp_path), tracker=log)
    assert os.path.basename(cache.path(key)) == os.path.basename(
        JT.TuneCache(root=str(tmp_path)).path(key))
    assert cache.get(key) is None
    cand = TT.Candidate("symmetric_shift", 128, 128, True, 8)
    cache.put(key, cand, {"modeled_makespan_s": 1e-6})
    rec = cache.get(key)
    assert TT.TuneCache.candidate_of(rec) == cand
    assert cache.cache_info() == {"hits": 1, "misses": 1, "entries": 1}
    assert [(k, e["result"]) for k, e in log.events] == [
        ("tune_cache", "miss"), ("tune_cache", "hit")]
    with open(cache.path(key)) as f:
        broken = json.load(f)
    broken["key"] = "something-else"
    with open(cache.path(key), "w") as f:
        json.dump(broken, f)
    assert cache.get(key) is None                  # no longer self-addressed
    broken["key"], broken["tuner_version"] = key, TT.TUNER_VERSION + 1
    with open(cache.path(key), "w") as f:
        json.dump(broken, f)
    assert cache.get(key) is None                  # stale version
    assert not list(tmp_path.glob("*.tmp"))        # writes were atomic


def test_default_cache_has_its_own_root(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert TT.TuneCache().root == str(tmp_path / ".cache" / "repro_torch"
                                      / "tune")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t"))
    assert TT.default_cache().root == str(tmp_path / "t")


# --------------------------------------------------------------------- api
def test_tune_attention_keys_normalization_and_stickiness(tmp_path):
    log = _Log()
    cache = TT.TuneCache(root=str(tmp_path))
    a = TT.tune_attention(seq=1024, head_dim=64, causal=True, cache=cache,
                          n_heads=32, tracker=log)
    assert (a.source, a.candidate.key()) == (
        "sim", "symmetric_shift|bq128|bk128|par|w8")
    assert a.key.endswith("backend=cuda-sm90")
    again = TT.tune_attention(seq=1024, head_dim=64, mask=TM.Causal(),
                              cache=cache, n_heads=32, tracker=log)
    assert (again.source, again.candidate, again.key) == (
        "cache", a.candidate, a.key)
    assert [k for k, _ in log.events] == [
        "tune_cache", "tune_choice", "tune_cache", "tune_choice"]
    full = TT.tune_attention(seq=1024, head_dim=64, mask=TM.Full(),
                             cache=cache)
    assert full.candidate.schedule == "shift" and full.key != a.key
    fp32 = TT.tune_attention(seq=1024, head_dim=64, causal=True,
                             dtype=torch.float32, cache=cache, n_heads=32)
    assert "dtype=float32" in fp32.key and fp32.key != a.key
    # measure without a runner ranks as sim does
    m = TT.tune_attention(seq=512, head_dim=64, causal=True, mode="measure",
                          cache=TT.TuneCache(root=str(tmp_path / "m")))
    s = TT.tune_attention(seq=512, head_dim=64, causal=True,
                          cache=TT.TuneCache(root=str(tmp_path / "s")))
    assert (m.candidate, m.source) == (s.candidate, "sim")
    with pytest.raises(ValueError, match="tune mode"):
        TT.tune_attention(seq=512, head_dim=64, mode="fast", cache=cache)


def _jitter_clock():
    calls = {"n": 0}

    def clock():
        calls["n"] += 1
        return calls["n"] * 1e-9
    return clock


class _FakeClock:
    def __init__(self):
        self.t, self.pending = 0.0, 0.0

    def __call__(self):
        self.t += self.pending
        self.pending = 0.0
        return self.t


@pytest.mark.parametrize("slow_rank", [0, 1])
def test_measure_tie_break_equals_reference(slow_rank):
    """Within rel_tol the modeled order decides; a decisively slower
    candidate drops behind — the same timed rows as the reference's under
    the same fake clocks."""
    kw = dict(seq_q=1024, head_dim=64, causal=True)
    ours = tmodel.rank_candidates(TT.enumerate_candidates(**kw), **kw, **REF)
    ref = jmodel.rank_candidates(
        [c for c in JT.enumerate_candidates(**kw) if c.block_q != 256], **kw)

    def rows(timed):
        return [(r["candidate"].key(), r["measured_s"]) for r in timed]

    t1 = TT.measure_topk(ours, lambda c: None, k=4, clock=_jitter_clock())
    r1 = JT.measure_topk(ref, lambda c: None, k=4, clock=_jitter_clock())
    assert rows(t1) == rows(r1)
    assert t1[0]["candidate"].key() == ours[0]["candidate"].key()

    slow = ours[slow_rank]["candidate"].key()
    results = []
    for ranked, measure in ((ours, TT.measure_topk), (ref, JT.measure_topk)):
        clk = _FakeClock()

        def runner(cand, clk=clk):
            clk.pending += 10.0 if cand.key() == slow else 1.0
        results.append(rows(measure(ranked, runner, k=4, clock=clk)))
    assert results[0] == results[1]
    assert results[0][-1][0] == slow and results[0][0][1] == 1.0


@pytest.mark.parametrize("n,block", [(8, 64), (16, 128)])
@pytest.mark.parametrize("family", list(_masks(JM, 1024)))
def test_pick_placement_and_tuned_block_schedule(family, n, block):
    s = n * block
    tmask, jmask = _masks(TM, s)[family], _masks(JM, s)[family]
    ref = JT.pick_placement(jmask, n, n, block, block)
    assert TT.pick_placement(tmask, n, n, block, block, **REF) == ref
    picked = TT.pick_placement(tmask, n, n, block, block)
    tuned = cached_block_schedule(tmask, n, n, block, block, tune=True)
    assert tuned is cached_block_schedule(tmask, n, n, block, block,
                                          placement=picked)


def test_masks_cache_info_keys_equal_reference():
    ours, ref = TM.cache_info(), JM.cache_info()
    assert set(ours) == set(ref) == {"cached_schedule",
                                     "cached_block_schedule", "block_map"}
    for name, stats in ours.items():
        assert set(stats) == set(ref[name])
        assert stats["maxsize"] is not None


# ------------------------------------------- tuned ≡ hand-picked, reference
def _inputs(b, h, hk, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hk, s, d), (b, hk, s, d),
                          (b, h, s, d))]


CASES = [  # (heads, kv heads, S, D, causal, mask family)
    pytest.param(4, 4, 256, 32, False, None, id="full"),
    pytest.param(4, 2, 256, 64, True, None, id="causal-gqa"),
    pytest.param(2, 2, 512, 32, False, "window", id="window"),
    pytest.param(2, 1, 512, 32, False, "document", id="document-gqa"),
]


@pytest.mark.parametrize("h,hk,s,d,causal,family", CASES)
def test_tuned_equals_handpicked_and_the_reference(h, hk, s, d, causal,
                                                   family, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path))
    tmask = _masks(TM, s)[family] if family else None
    jmask = _masks(JM, s)[family] if family else None
    q, k, v, do = _inputs(1, h, hk, s, d, seed=s + d)
    cand = TT.tune_attention(seq=s, head_dim=d, dtype=torch.float32,
                             causal=causal, mask=tmask, n_heads=h,
                             n_kv_heads=hk).candidate
    knobs = dict(schedule=cand.schedule, block=cand.block_q,
                 worker_parallel=cand.worker_parallel)

    def run(**kw):
        x = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = tops.dash_attention(*x, causal=causal, mask=tmask, **kw)
        return [out.detach()] + list(torch.autograd.grad(
            out, x, torch.from_numpy(do)))

    tuned, hand = run(tune=True), run(**knobs)
    for a, b in zip(tuned, hand):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    ref_out, pull = jax.vjp(
        lambda a, b_, c: jops.dash_attention(a, b_, c, causal=causal,
                                             mask=jmask, interpret=True,
                                             **knobs),
        *[jnp.asarray(a) for a in (q, k, v)])
    np.testing.assert_allclose(tuned[0].numpy(), np.asarray(ref_out),
                               atol=2e-5, rtol=2e-5)
    for g, r, nm in zip(tuned[1:], pull(jnp.asarray(do)), ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5,
                                   rtol=5e-5, err_msg=nm)


def test_train_launcher_prints_the_tuned_key(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path))
    launch_train.main(["--reduced", "--device", "cpu", "--steps", "1",
                       "--batch", "2", "--seq", "256", "--tune", "sim"])
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[tune] "))
    _, cfg = launch_train.configure(["--reduced", "--device", "cpu"])[:2]
    res = TT.tune_attention(seq=256, head_dim=cfg.head_dim,
                            dtype=cfg.dtype_name, causal=True,
                            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    assert res.source == "cache"            # the launcher's decision
    assert line.split()[1] == res.candidate.key()
    assert f"modeled_makespan={res.modeled_makespan_s:.3e}s" in line


_SUBPROC = r"""
import json, sys
from repro_torch.tune import TuneCache, tune_attention
res = tune_attention(seq=2048, head_dim=64, causal=True, n_heads=32,
                     cache=TuneCache(root=sys.argv[1]))
print(json.dumps({"key": res.key, "candidate": res.candidate.key(),
                  "source": res.source}))
"""


def test_a_fresh_process_makes_the_same_sim_pick(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _SUBPROC,
                           str(tmp_path / "fresh")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    theirs = json.loads(proc.stdout.strip().splitlines()[-1])
    ours = TT.tune_attention(seq=2048, head_dim=64, causal=True, n_heads=32,
                             cache=TT.TuneCache(root=str(tmp_path / "ours")))
    assert theirs == {"key": ours.key, "candidate": ours.candidate.key(),
                      "source": "sim"}
