"""Checks of the port that need the card (marker ``gpu``; they skip without
one). Run them there with ``python -m pytest -q -m gpu tests/test_torch_cuda.py``.
This file imports no JAX, so it also runs where JAX is not installed."""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.schedules import make_schedule
from repro_torch.kernels import flash_bwd as FB
from repro_torch.kernels import flash_fwd as FF
from repro_torch.kernels import ops
from repro_torch import masks as M
from repro_torch.models import transformer as T
from repro_torch.models.module import set_path, tree_paths
from repro_torch.train import optimizer as O
from repro_torch.train import step as S
from repro_torch.verify.digest import tree_digest

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 2e-5)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_kernel_matches_plain_version(dtype, tol, d):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(d)
    q = torch.randn((4, 256, d), generator=gen, device="cuda")
    k = torch.randn((2, 256, d), generator=gen, device="cuda")
    v = torch.randn((2, 256, d), generator=gen, device="cuda")
    q, k, v = (x.to(getattr(torch, dtype)) for x in (q, k, v))
    before = FF.launches
    out, lse = FF.flash_fwd(q, k, v, causal=True, n_heads=2, n_kv_heads=1)
    assert FF.launches == before + 1
    ref_out, ref_lse = FF.flash_fwd_plain(q, k, v, d ** -0.5, 2, 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=tol)
    assert ((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1)).max() <= 1e-3


def test_kernel_raises_on_shapes_it_does_not_take():
    _card()
    q = torch.zeros((2, 256, 96), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        FF.flash_fwd(q, q, q, causal=True)
    with pytest.raises(ValueError, match="square-tiled"):
        FF.flash_fwd(q[..., :64].contiguous(), q[..., :64].contiguous(),
                     q[..., :64].contiguous(), causal=True, block_q=64,
                     block_k=64)


@torch.inference_mode()
def test_reduced_prefill_cuda_matches_plain_attention():
    _card()
    cfg = registry.get("stablelm-1.6b").reduced(attention_impl="cuda")
    params = T.init(cfg, seed=0, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 256), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0))
    before = FF.launches
    logits, _ = T.prefill_step(params, {"tokens": tokens}, cfg)
    assert FF.launches == before + cfg.n_layers
    plain, _ = T.prefill_step(params, {"tokens": tokens},
                              cfg.replace(attention_impl="torch"))
    torch.testing.assert_close(logits, plain, atol=2e-2, rtol=2e-2)


# ------------------------------------------------ full-mask forward, backward
BWD_CASES = [  # (schedule, causal)
    ("fa3", False), ("descending", False), ("shift", False),
    ("fa3", True), ("descending", True), ("symmetric_shift", True),
]
# the reference's grad tolerances (tests/test_kernels.py:59)
GRAD_TOLS = {"bfloat16": dict(atol=0.1, rtol=5e-2),
             "float32": dict(atol=2e-5, rtol=2e-5)}


def _bwd_inputs(b, h, hk, s, d, dtype, causal, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((b * h, s, d), generator=gen, device="cuda")
             for _ in range(2))
    k, v = (torch.randn((b * hk, s, d), generator=gen, device="cuda")
            for _ in range(2))
    q, k, v, do = (x.to(getattr(torch, dtype)) for x in (q, k, v, do))
    out, lse = FF.flash_fwd_plain(q, k, v, d ** -0.5, h, hk, causal)
    return q, k, v, do, out, lse


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 2e-5)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_full_mask_kernel_matches_plain_version(dtype, tol, d):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(d + 1)
    q = torch.randn((4, 256, d), generator=gen, device="cuda")
    k = torch.randn((2, 384, d), generator=gen, device="cuda")
    v = torch.randn((2, 384, d), generator=gen, device="cuda")
    q, k, v = (x.to(getattr(torch, dtype)) for x in (q, k, v))
    before = FF.launches_full
    out, lse = FF.flash_fwd(q, k, v, causal=False, n_heads=2, n_kv_heads=1)
    assert FF.launches_full == before + 1
    ref_out, ref_lse = FF.flash_fwd_plain(q, k, v, d ** -0.5, 2, 1, False)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=tol)
    assert ((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1)).max() <= 1e-3


@pytest.mark.parametrize("sched,causal", BWD_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("h,hk,d,n", [(2, 2, 64, 3), (4, 2, 128, 3),
                                      (2, 1, 32, 3), (2, 2, 64, 8),
                                      (2, 1, 128, 8)])
def test_backward_kernels_match_plain_and_each_other(sched, causal, dtype, h,
                                                     hk, d, n):
    """worker kernel + fold vs the plain version at the reference's grad
    tolerances; serialized kernel ≡ worker kernel + fold, bit for bit. At
    n = 8 tiles the runs of KV rows differ in length (fa3 and descending
    causal: 8 tasks down to 1; shift: 8 each), which the serialized kernel,
    the only one that crosses from one run to the next, must keep apart."""
    _card()
    q, k, v, do, out, lse = _bwd_inputs(1, h, hk, 128 * n, d, dtype, causal,
                                        seed=d + h)
    schedule = make_schedule(sched, n, 1, causal)
    w0, f0 = FB.launches_worker, FB.launches_fold
    par = FB.flash_bwd(q, k, v, out, lse, do, schedule, causal=causal,
                       n_heads=h, n_kv_heads=hk)
    assert FB.launches_worker == w0 + 1
    assert FB.launches_fold == f0 + 1 + (2 if h != hk else 0)
    s0 = FB.launches_serial
    ser = FB.flash_bwd(q, k, v, out, lse, do, schedule, causal=causal,
                       n_heads=h, n_kv_heads=hk, worker_parallel=False)
    assert FB.launches_serial == s0 + 1
    plain = FB.flash_bwd(q.cpu(), k.cpu(), v.cpu(), out.cpu(), lse.cpu(),
                         do.cpu(), schedule, causal=causal, n_heads=h,
                         n_kv_heads=hk)
    torch.cuda.synchronize()
    for got, same, want, nm in zip(par, ser, plain, ("dq", "dk", "dv")):
        assert torch.equal(got, same), f"{nm}: serialized != worker + fold"
        torch.testing.assert_close(got.cpu(), want, msg=nm, **GRAD_TOLS[dtype])


def test_worker_backward_is_bitwise_reproducible():
    _card()
    q, k, v, do, out, lse = _bwd_inputs(2, 4, 4, 512, 64, "bfloat16", True,
                                        seed=7)
    schedule = make_schedule("symmetric_shift", 4, 1, True)
    first = FB.flash_bwd(q, k, v, out, lse, do, schedule, causal=True)
    for _ in range(5):
        again = FB.flash_bwd(q, k, v, out, lse, do, schedule, causal=True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_fold_kernel_is_the_ordered_left_fold():
    """Bitwise against the plain fold, with skipped (garbage) partials and
    -0.0 lanes that a 0.0 + x start would turn into +0.0."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    parts = torch.randn((3, 4, 384, 64), generator=gen, device="cuda") * 100
    parts[:, 1, :128] = -0.0
    parts[:, 0, :128] = float("nan")          # never visited: must not leak
    visited = torch.ones((4, 3), dtype=torch.int32)
    visited[[0, 2, 3], 0] = 0                 # tile 0: partial 1 alone
    visited[2, 1] = 0
    got = FB.fold_combine(parts, visited.cuda(), 128)
    want = FB.fold_plain(parts.cpu(), visited, 128)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.signbit(got[:, :128]).all()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_reduced_train_step_cuda_matches_plain_attention(dtype, tol):
    """One AdamW step of the reduced model with the DASH kernels against the
    same step with the plain attention: loss and grad norm within ``tol``
    (fp32: summation order only; bf16: bf16 activations), the kernels
    launched as remat predicts, and the kernel step bitwise reproducible."""
    _card()
    cfg = registry.get("stablelm-1.6b").reduced(
        n_layers=2, dtype_name=dtype, attention_impl="cuda")
    tcfg = S.TrainConfig(opt=O.OptConfig(warmup_steps=1))
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, 257), device="cuda", generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    state = S.init_state(cfg, tcfg, seed=0, device="cuda")
    counts = (FF.launches, FB.launches_worker, FB.launches_fold)
    new, m = S.make_train_step(cfg, tcfg)(state, batch)
    assert (FF.launches - counts[0], FB.launches_worker - counts[1],
            FB.launches_fold - counts[2]) == (2 * cfg.n_layers, cfg.n_layers,
                                              cfg.n_layers)
    again, _ = S.make_train_step(cfg, tcfg)(state, batch)
    assert tree_digest(new) == tree_digest(again)
    _, mp = S.make_train_step(cfg.replace(attention_impl="torch"),
                              tcfg)(state, batch)
    for key in ("loss", "grad_norm"):
        a, b = float(m[key]), float(mp[key])
        assert abs(a - b) <= tol * abs(b), (key, a, b)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_reduced_moe_forward_and_backward_are_bitwise(arch, impl):
    """A reduced MoE model's loss and every grad (router and experts
    included) on the DASH kernels, twice under deterministic algorithms:
    bitwise equal, and within bf16 reach of the plain attention's loss."""
    _card()
    cfg = registry.get(arch).reduced(n_layers=2, attention_impl="cuda",
                                     moe_impl=impl)
    params = T.init(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, 257), device="cuda", generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def run(c):
        tree, leaves = {}, []
        for path, x in tree_paths(params):
            leaves.append(x.detach().requires_grad_(True))
            set_path(tree, path, leaves[-1])
        loss, m = T.loss_fn(tree, batch, c, remat=True)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), m["aux"].detach(), grads

    torch.use_deterministic_algorithms(True)
    try:
        a, b = run(cfg), run(cfg)
        plain = run(cfg.replace(attention_impl="torch"))[0]
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert float(a[1]) > 0
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
    assert abs(float(a[0]) - float(plain)) <= 2e-2 * abs(float(plain))


def test_reduced_jamba_forward_and_backward_are_bitwise(monkeypatch):
    """The reduced Jamba period (7 Mamba layers, 4 of them MoE, and a NoPE
    attention layer) on the scan and DASH kernels, remat on, twice under
    deterministic algorithms: loss and every grad bitwise equal, the scan
    launched as remat predicts (forward twice a Mamba layer, backward and
    fold once), and within bf16 reach of the plain attention and plain
    scan's loss."""
    _card()
    from repro_torch.kernels import scan as SC
    cfg = registry.get("jamba-1.5-large-398b").reduced(attention_impl="cuda")
    params = T.init(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, 257), device="cuda", generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def run(c):
        tree, leaves = {}, []
        for path, x in tree_paths(params):
            leaves.append(x.detach().requires_grad_(True))
            set_path(tree, path, leaves[-1])
        loss, m = T.loss_fn(tree, batch, c, remat=True)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), m["aux"].detach(), grads

    torch.use_deterministic_algorithms(True)
    try:
        before = ops.launch_counts()
        a = run(cfg)
        after = ops.launch_counts()
        b = run(cfg)
        monkeypatch.setattr(SC, "selective_scan",
                            lambda *x: SC.selective_scan_plain(*x[:8]))
        plain = run(cfg.replace(attention_impl="torch"))[0]
    finally:
        torch.use_deterministic_algorithms(False)
    launched = {k: after[k] - before[k] for k in after}
    assert (launched["scan_fwd"], launched["scan_bwd"],
            launched["scan_fold"]) == (14, 7, 7)
    assert launched["fwd_causal"] == 2 and launched["bwd_worker"] == 1
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
    assert abs(float(a[0]) - float(plain)) <= 2e-2 * abs(float(plain))


# ------------------------------------------- block-sparse masks (masks slice)
MASKS = {   # the reference's families at S = 512
    "window": lambda: M.SlidingWindow(192),
    "prefix": lambda: M.PrefixLM(160),
    "document": lambda: M.Document.from_lengths((200, 312)),
    "streaming": lambda: M.streaming_mask(128, 32),
    "sink": lambda: M.Causal() & M.Sink(32),
    # narrower than a tile: rows 192-255 see nothing of KV tile 0, the
    # first live tile of their q tile
    "window_narrow": lambda: M.SlidingWindow(64),
}


@pytest.mark.parametrize("hk", [2, 1])
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 2e-5)])
@pytest.mark.parametrize("name", list(MASKS))
def test_masked_forward_kernel_matches_plain_version(name, dtype, tol, hk):
    _card()
    mask = MASKS[name]()
    gen = torch.Generator(device="cuda").manual_seed(len(name))
    q = torch.randn((2, 512, 64), generator=gen, device="cuda")
    k = torch.randn((hk, 512, 64), generator=gen, device="cuda")
    v = torch.randn((hk, 512, 64), generator=gen, device="cuda")
    q, k, v = (x.to(getattr(torch, dtype)) for x in (q, k, v))
    before = FF.launches_mask
    out, lse = FF.flash_fwd(q, k, v, mask=mask, n_heads=2, n_kv_heads=hk)
    assert FF.launches_mask == before + 1
    ref_out, ref_lse = FF.flash_fwd_plain(q, k, v, 64 ** -0.5, 2, hk,
                                          mask=mask)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=tol)
    assert ((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1)).max() <= 1e-3


@pytest.mark.parametrize("placement,d", [("shift", 64), ("fa3", 64),
                                         ("fa3", 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", list(MASKS))
def test_masked_backward_kernels_match_plain_and_each_other(name, dtype,
                                                            placement, d):
    """Masked worker kernel + fold vs the plain version; serialized ≡ worker
    + fold bit for bit; KV rows no task visits exactly 0 (the kernels leave
    them unwritten, NaN under deterministic algorithms). The ragged chains
    give KV-row runs of unequal length, in another order under fa3."""
    _card()
    mask = MASKS[name]()
    gen = torch.Generator(device="cuda").manual_seed(len(name) + 1)
    q, do = (torch.randn((4, 512, d), generator=gen, device="cuda")
             .to(getattr(torch, dtype)) for _ in range(2))
    k, v = (torch.randn((2, 512, d), generator=gen, device="cuda")
            .to(getattr(torch, dtype)) for _ in range(2))
    out, lse = FF.flash_fwd_plain(q, k, v, d ** -0.5, 2, 1, mask=mask)
    schedule = make_schedule(placement, 4, mask=mask)
    kw = dict(mask=mask, n_heads=2, n_kv_heads=1)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        w0 = FB.launches_worker
        par = FB.flash_bwd(q, k, v, out, lse, do, schedule, **kw)
        ser = FB.flash_bwd(q, k, v, out, lse, do, schedule,
                           worker_parallel=False, **kw)
        assert FB.launches_worker == w0 + 1
    finally:
        torch.use_deterministic_algorithms(deterministic)
    plain = FB.flash_bwd(q.cpu(), k.cpu(), v.cpu(), out.cpu(), lse.cpu(),
                         do.cpu(), schedule, **kw)
    torch.cuda.synchronize()
    for got, same, want, nm in zip(par, ser, plain, ("dq", "dk", "dv")):
        assert torch.equal(got, same), f"{nm}: serialized != worker + fold"
        assert bool(torch.isfinite(got).all()), nm
        torch.testing.assert_close(got.cpu(), want, msg=nm, **GRAD_TOLS[dtype])


def test_windowed_dash_attention_matches_the_plain_op():
    """dash_attention(mask=SlidingWindow) forward and grads vs the plain
    masked attention (query-chunked), and it is not the causal op."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, do = (torch.randn((1, 4, 1024, 64), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    mask = M.SlidingWindow(256)
    x = [t.clone().requires_grad_(True) for t in (q, k, v)]
    m0 = FF.launches_mask
    out = ops.dash_attention(*x, mask=mask)
    grads = torch.autograd.grad(out, x, do)
    assert FF.launches_mask == m0 + 1
    y = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = ops.torch_attention(*y, mask=mask, chunk_q=256)
    ref_grads = torch.autograd.grad(ref, y, do)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g.float(), r.float(), **GRAD_TOLS["bfloat16"])
    causal = ops.dash_attention(q, k, v, causal=True)
    assert (causal[:, :, 256:].float() - out[:, :, 256:].float()).abs().max() \
        > 0.1


@pytest.mark.parametrize("causal,mask", [(True, None), (False, None),
                                         (False, "window")])
def test_tuned_dash_attention_equals_handpicked(causal, mask, tmp_path,
                                                monkeypatch):
    """dash_attention(tune=True) on the card: outputs and q/k/v grads equal
    to the hand-picked call with the knobs the tuner resolved, and the
    serialized candidate of the same family equal to the worker one."""
    _card()
    from repro_torch.tune import tune_attention
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path))
    mask = MASKS[mask]() if mask else None
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((2, 4, 512, 64), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    cand = tune_attention(seq=512, head_dim=64, dtype=q.dtype, causal=causal,
                          mask=mask, n_heads=4, n_kv_heads=4).candidate

    def run(**kw):
        x = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = ops.dash_attention(*x, causal=causal, mask=mask, **kw)
        return [out] + list(torch.autograd.grad(out, x, do))

    hand = dict(schedule=cand.schedule, block=cand.block_q)
    tuned = run(tune=True)
    for got, want, ser in zip(tuned, run(worker_parallel=cand.worker_parallel,
                                         **hand),
                              run(worker_parallel=False, **hand)):
        assert torch.equal(got, want) and torch.equal(got, ser)


def test_host_shared_memory_budget_equals_the_libraries():
    """kernels/smem.py's footprints are what the built kernels launch
    with, for every instantiated (head_dim, dtype)."""
    _card()
    from repro_torch.kernels import smem
    for d in FF.HEAD_DIMS:
        for dtype, nbytes in ((torch.bfloat16, 2), (torch.float32, 4)):
            assert (smem.fwd_footprint(128, 128, d, nbytes).total
                    == FF.kernel_smem_bytes(d, dtype)), (d, dtype)
            assert (smem.bwd_footprint(128, 128, d, nbytes).total
                    == FB.smem_bytes(d, dtype)), (d, dtype)


def test_forward_kernels_repeat_bitwise_and_agree_on_shared_memory():
    """20 launches of each bf16 forward mode give identical out and lse; the
    library's shared memory per head dim is the host's budget."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn((4, 512, 64), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    runs = {"causal": lambda: FF.flash_fwd(q, k, v, causal=True),
            "full": lambda: FF.flash_fwd(q, k, v, causal=False),
            "mask": lambda: FF.flash_fwd(q, k, v, mask=M.SlidingWindow(200))}
    for name, run in runs.items():
        out, lse = run()
        for _ in range(20):
            again = run()
            assert torch.equal(again[0], out) and torch.equal(again[1], lse), (
                name)
    for d in FF.HEAD_DIMS:
        assert FF.kernel_smem_bytes(d, torch.bfloat16) == FF.fwd_smem_bytes(
            d, FF.fwd_stages(d))


def test_causal_forward_is_batch_invariant():
    """Each sequence of a batch-4 causal launch equals, bit for bit, the same
    sequence launched alone (the serving contract)."""
    _card()
    b, h, hk, s, d = 4, 4, 2, 384, 64
    gen = torch.Generator(device="cuda").manual_seed(12)
    q = torch.randn((b * h, s, d), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((b * hk, s, d), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    out, lse = FF.flash_fwd(q, k, v, causal=True, n_heads=h, n_kv_heads=hk)
    for i in range(b):
        qi = q[i * h:(i + 1) * h].contiguous()
        ki, vi = (x[i * hk:(i + 1) * hk].contiguous() for x in (k, v))
        one, one_lse = FF.flash_fwd(qi, ki, vi, causal=True, n_heads=h,
                                    n_kv_heads=hk)
        assert torch.equal(one, out[i * h:(i + 1) * h])
        assert torch.equal(one_lse, lse[i * h:(i + 1) * h])



def test_checkpoint_of_card_tensors_restores_onto_the_card(tmp_path):
    """bf16 and fp32 leaves on the card (and an int32 step) go through a
    checkpoint (bf16 stored as its fp32 upcast) and come back onto the card
    with the same bits."""
    _card()
    from repro_torch.ckpt import checkpoint as CK

    gen = torch.Generator(device="cuda").manual_seed(5)
    tree = {"params": {"w": torch.randn((64, 48), generator=gen,
                                        device="cuda").bfloat16(),
                       "b": torch.randn(48, generator=gen, device="cuda")},
            "step": torch.tensor(7, dtype=torch.int32, device="cuda")}
    CK.save(str(tmp_path), 7, tree, async_=True).join(timeout=60)
    target = {"params": {k: torch.zeros_like(v)
                         for k, v in tree["params"].items()},
              "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    restored = CK.restore(str(tmp_path), 7, target)
    assert CK.read_manifest(str(tmp_path), 7)["tree_digest"] == tree_digest(
        tree)
    for got, want in ((restored["params"]["w"], tree["params"]["w"]),
                      (restored["params"]["b"], tree["params"]["b"]),
                      (restored["step"], tree["step"])):
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert torch.equal(got.view(torch.uint8) if got.dim() else got,
                           want.view(torch.uint8) if want.dim() else want)


# ------------------------------------------- the continuous engine's kernels
def _paged_case(b, l, h, hk, d, ps, n_pg, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_pages = b * n_pg + 2
    kp, vp = (torch.randn((n_pages, ps, hk, d), generator=gen, device="cuda")
              .to(dtype) for _ in range(2))
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(
        seed))[:b * n_pg]
    table = perm.reshape(b, n_pg).to(torch.int32).cuda()
    q = torch.randn((b, l, h, d), generator=gen, device="cuda").to(dtype)
    start = torch.randint(0, n_pg * ps - l, (b, 1),
                          generator=torch.Generator().manual_seed(seed + 1))
    qpos = (start + torch.arange(l)).to(torch.int32).cuda()
    return q, kp, vp, table, qpos


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 2e-5)])
@pytest.mark.parametrize("shape", [(4, 1, 8, 8, 64, 16, 8),     # decode
                                   (1, 16, 8, 2, 64, 16, 8),    # prefill, GQA
                                   (2, 3, 4, 4, 128, 8, 4),
                                   (2, 5, 4, 2, 32, 8, 6)])
def test_paged_attention_kernel_matches_plain_and_holds_its_bits(dtype, tol,
                                                                 shape):
    """Kernel vs plain (window and segment ids too); each row bitwise the
    same launched alone, behind trailing pages, and over 20 repetitions."""
    _card()
    from repro_torch.kernels import decode as D
    b, l, h, hk, d, ps, n_pg = shape
    q, kp, vp, table, qpos = _paged_case(b, l, h, hk, d, ps, n_pg,
                                         getattr(torch, dtype), sum(shape))
    seg = torch.randint(0, 2, (b, l), dtype=torch.int32, device="cuda")
    kv_seg = torch.randint(0, 2, kp.shape[:2], dtype=torch.int32,
                           device="cuda")
    for kw in ({}, {"window": 5}, {"q_segments": seg, "kv_segments": kv_seg}):
        before = D.launches
        out = D.paged_attention(q, kp, vp, table, qpos, **kw)
        assert D.launches == before + 1
        plain = D.paged_attention_plain(q, kp, vp, table, qpos, d ** -0.5,
                                        kw.get("window"),
                                        kw.get("q_segments"),
                                        kw.get("kv_segments"))
        torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                                   rtol=tol)
    out = D.paged_attention(q, kp, vp, table, qpos)
    for i in range(b):
        one = D.paged_attention(q[i:i + 1].contiguous(), kp, vp,
                                table[i:i + 1].contiguous(),
                                qpos[i:i + 1].contiguous())
        assert torch.equal(one, out[i:i + 1])
    longer = torch.cat([table, table[:, :3]], 1).contiguous()
    assert torch.equal(D.paged_attention(q, kp, vp, longer, qpos), out)
    for _ in range(20):
        assert torch.equal(D.paged_attention(q, kp, vp, table, qpos), out)


@pytest.mark.parametrize("width", [0, 64, 176])
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 1e-3), ("float32", 1e-4)])
def test_gemm_kernel_matches_plain_and_rows_are_m_invariant(dtype, tol, width):
    _card()
    from repro_torch.kernels import gemm
    gen = torch.Generator(device="cuda").manual_seed(width)
    k = 352 if width == 176 else 256
    x = torch.randn((64, k), generator=gen, device="cuda").to(
        getattr(torch, dtype))
    w = (torch.randn((k, 200), generator=gen, device="cuda") * 0.05).to(
        getattr(torch, dtype))
    before = gemm.launches
    y = gemm.matmul(x, w, shard_width=width)
    assert gemm.launches == before + 1 and y.dtype == torch.float32
    torch.testing.assert_close(y, gemm.matmul_plain(x, w, shard_width=width),
                               atol=tol, rtol=tol)
    for m in (1, 3, 4, 32):
        assert torch.equal(gemm.matmul(x[:m].contiguous(), w,
                                       shard_width=width), y[:m])
    moved = gemm.matmul(torch.cat([x[7:10], x[:1]]).contiguous(), w,
                        shard_width=width)
    assert torch.equal(moved[3], y[0])
    with pytest.raises(ValueError, match="contiguous"):
        gemm.matmul(x.t(), w[:64].contiguous())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(4, 1, 8, 8, 64, 16, 8),     # decode
                                   (1, 16, 8, 2, 64, 16, 8),    # prefill, GQA
                                   (2, 3, 4, 4, 128, 8, 4),
                                   (2, 5, 4, 2, 32, 8, 6),
                                   (1, 20, 16, 2, 64, 5, 12)])  # 3 row tiles
def test_paged_attention_kernel_gives_its_first_designs_bits(dtype, shape):
    """csrc/paged_attn.cu against csrc/paged_attn_v1.cu on the same
    inputs, bit for bit: plain, window, segment ids, trailing NaN pages; the
    first design counts in no launch counter."""
    _card()
    from repro_torch.kernels import decode as D
    b, l, h, hk, d, ps, n_pg = shape
    q, kp, vp, table, qpos = _paged_case(b, l, h, hk, d, ps, n_pg,
                                         getattr(torch, dtype), sum(shape))
    seg = torch.randint(0, 2, (b, l), dtype=torch.int32, device="cuda")
    kv_seg = torch.randint(0, 2, kp.shape[:2], dtype=torch.int32,
                           device="cuda")
    nan_k, nan_v = kp.clone(), vp.clone()
    used = torch.zeros(kp.shape[0], dtype=torch.bool, device="cuda")
    used[table.long().flatten()] = True
    nan_k[~used], nan_v[~used] = float("nan"), float("nan")
    spare = torch.nonzero(~used).flatten().to(torch.int32)
    longer = torch.cat([table, spare[None].expand(b, -1)], 1).contiguous()
    for kw in ({}, {"window": 5}, {"q_segments": seg, "kv_segments": kv_seg}):
        for pools in ((kp, vp, table), (nan_k, nan_v, longer)):
            before = D.launches
            v1 = D.paged_attention_v1(q, *pools, qpos, d ** -0.5, **kw)
            assert D.launches == before
            assert torch.equal(D.paged_attention(q, *pools, qpos, **kw), v1)


@pytest.mark.parametrize("k,n,width", [(256, 200, 0), (352, 200, 176),
                                       (512, 4232, 64), (2048, 8448, 0),
                                       (1536, 64, 1536), (256, 24, 16)])
def test_gemm_kernel_gives_its_first_designs_bits(k, n, width):
    """csrc/gemm.cu against csrc/gemm_v1.cu on the same bf16 inputs, bit
    for bit, at every M from 1 to 70 and with an fp32 and a bf16 output
    (tiles BN 16/32/64; canonical shards narrower and wider than a stage,
    ending inside one); the first design counts in no launch counter."""
    _card()
    from repro_torch.kernels import gemm
    gen = torch.Generator(device="cuda").manual_seed(k + n)
    x = torch.randn((70, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device="cuda") * 0.05).to(
        torch.bfloat16)
    for m in range(1, 71):
        xm = x[:m].contiguous()
        for out_dtype in (None, torch.bfloat16):
            before = gemm.launches
            v1 = gemm.matmul_v1(xm, w, out_dtype, width)
            assert gemm.launches == before
            assert torch.equal(gemm.matmul(xm, w, out_dtype, width), v1), m


def test_row_kernels_match_plain_and_rows_are_m_invariant():
    _card()
    from repro_torch.kernels import rows
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.randn((16, 384), generator=gen, device="cuda") * 2 + 1)
    scale = torch.randn(384, generator=gen, device="cuda") + 1
    bias = torch.randn(384, generator=gen, device="cuda")
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        for b in (bias, None):
            y = rows.norm(x.to(dtype), scale, b)
            torch.testing.assert_close(
                y.float(), rows.norm_plain(x.to(dtype), scale, b).float(),
                atol=tol, rtol=tol)
            for m in (1, 3, 4):
                assert torch.equal(rows.norm(x[:m].to(dtype), scale, b),
                                   y[:m])
    logits = torch.randn((6, 1000), generator=gen, device="cuda") * 4
    logits[2, 5] = logits[2, 600] = logits[2].max() + 1
    lp, arg = rows.log_softmax_argmax(logits)
    plp, parg = rows.log_softmax_argmax_plain(logits)
    torch.testing.assert_close(lp, plp, atol=2e-5, rtol=2e-5)
    assert torch.equal(arg, parg) and int(arg[2]) == 5
    for m in (1, 4):
        sub, sub_arg = rows.log_softmax_argmax(logits[:m].contiguous())
        assert torch.equal(sub, lp[:m]) and torch.equal(sub_arg, arg[:m])


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t.view(
        torch.int16)


@pytest.mark.parametrize("d", [384, 8192])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_row_norm_gives_its_first_designs_bits(d, dtype):
    """csrc/rows.cu's norm against csrc/rows_v1.cu's on the same inputs,
    bit for bit, LayerNorm and RMSNorm at M = 1, 3, 4; only the new kernel
    counts its launches; a row wider than 8192 is refused."""
    _card()
    from repro_torch.kernels import rows
    gen = torch.Generator(device="cuda").manual_seed(d)
    x = (torch.randn((4, d), generator=gen, device="cuda") * 3 + 1).to(
        getattr(torch, dtype))
    scale = torch.randn(d, generator=gen, device="cuda") + 1
    bias = torch.randn(d, generator=gen, device="cuda")
    for b in (bias, None):
        for m in (1, 3, 4):
            xm = x[:m].contiguous()
            before = rows.launches_norm
            v1 = rows.norm_v1(xm, scale, b)
            assert rows.launches_norm == before
            y = rows.norm_cuda(xm, scale, b)
            assert rows.launches_norm == before + 1
            assert torch.equal(_bits(y), _bits(v1)), (m, b is None)
    wide = torch.zeros((1, 8193), device="cuda")
    with pytest.raises(ValueError, match="8192"):
        rows.norm_cuda(wide, torch.ones(8193, device="cuda"))


@pytest.mark.parametrize("v", [1000, 1024 * 3 + 17])
def test_row_log_softmax_gives_its_first_designs_bits(v):
    """csrc/rows.cu's cluster log-softmax against csrc/rows_v1.cu's one-CTA
    kernel on the same logits, bit for bit through integer views (NaN
    included), at M = 1, 3, 4: a tie at the maximum, +-inf, the top-k
    mask's -1e30, a NaN heading chain 0 and one inside a chain; only the new
    kernel counts its launches."""
    _card()
    from repro_torch.kernels import rows
    gen = torch.Generator(device="cuda").manual_seed(v)
    x = torch.randn((8, v), generator=gen, device="cuda") * 4
    x[1, 11] = x[1, 600] = x[1].max() + 1
    x[2, v // 3] = float("inf")
    x[2, [5, v - 1]] = float("-inf")
    x[3, :] = -1e30
    x[3, [7, v // 2]] = 1.5
    x[5, 0] = float("nan")
    x[6, v - 4] = float("nan")
    for rows_at in ([0, 1, 2, 3], [5, 6, 7], [4], [1, 2, 3, 5]):
        xm = x[rows_at].contiguous()
        before = rows.launches_log_softmax
        lp1, arg1 = rows.log_softmax_argmax_v1(xm)
        assert rows.launches_log_softmax == before
        lp, arg = rows.log_softmax_argmax_cuda(xm)
        assert rows.launches_log_softmax == before + 1
        assert torch.equal(_bits(lp), _bits(lp1)) and torch.equal(arg, arg1)


@torch.inference_mode()
def test_reduced_continuous_engine_on_the_card():
    """The reduced StableLM through the continuous engine on the card: a
    request's tokens and logprobs are bitwise the same alone, co-batched, at
    2 slots and another chunk; decode launches the paged attention once per
    layer a step."""
    _card()
    from repro_torch.kernels import decode as D
    from repro_torch.serve.engine import ContinuousEngine
    cfg = registry.get("stablelm-1.6b").reduced(n_layers=2)
    params = T.init(cfg, seed=0, device="cuda")
    gen = torch.Generator().manual_seed(0)
    prompts = {i: torch.randint(1, cfg.vocab, (n,), generator=gen).tolist()
               for i, n in enumerate((5, 13, 32, 7))}

    def run(ids, n_slots=4, chunk=16):
        eng = ContinuousEngine(cfg, params, n_slots=n_slots, max_seq=64,
                               page_size=8, prefill_chunk=chunk)
        for i in ids:
            eng.submit(prompts[i], req_id=i, max_new_tokens=6)
        return eng.run(), eng.result_logprobs, eng

    before = D.launches
    full, lps, eng = run([0, 1, 2, 3])
    chunks = sum(-(-len(prompts[i]) // 16) for i in range(4))
    assert D.launches - before == cfg.n_layers * (chunks + eng.decode_steps)
    for ids, kw in (([0], {}), ([1, 3], {}), ([0, 1, 2, 3], {"n_slots": 2}),
                    ([0, 1, 2, 3], {"chunk": 8})):
        got, got_lps, _ = run(ids, **kw)
        for i in ids:
            assert np.array_equal(got[i], full[i]), (ids, kw, i)
            assert np.array_equal(got_lps[i], lps[i]), (ids, kw, i)


def _reduced_serving(n_layers=2):
    cfg = registry.get("stablelm-1.6b").reduced(n_layers=n_layers)
    params = T.init(cfg, seed=0, device="cuda")
    gen = torch.Generator().manual_seed(0)
    prompts = {i: torch.randint(1, cfg.vocab, (n,), generator=gen).tolist()
               for i, n in enumerate((5, 13, 32, 7, 21))}
    return cfg, params, prompts


@torch.inference_mode()
def test_reduced_spec_self_draft_is_plain_decoding_on_the_card():
    """Self-draft speculation (k=3) on the card: tokens and logprobs bitwise
    the plain engine's, greedy and sampled; k + 1 paged attentions a layer a
    round."""
    _card()
    from repro_torch.kernels import decode as D
    from repro_torch.serve.engine import ContinuousEngine, SampleConfig
    cfg, params, prompts = _reduced_serving()

    def run(scfg, **kw):
        eng = ContinuousEngine(cfg, params, n_slots=3, max_seq=64,
                               page_size=8, prefill_chunk=16, scfg=scfg, **kw)
        for i, p in prompts.items():
            eng.submit(p, req_id=i, max_new_tokens=9)
        return eng.run(), eng

    for scfg in (SampleConfig(), SampleConfig(temperature=0.7, top_k=20,
                                              seed=11)):
        base, plain = run(scfg)
        before = D.launches
        got, eng = run(scfg, spec_k=3)
        chunks = sum(-(-len(p) // 16) for p in prompts.values())
        assert D.launches - before == cfg.n_layers * (
            chunks + 4 * eng.spec.rounds)
        assert eng.spec.acceptance_rate() == 1.0
        for i in prompts:
            assert np.array_equal(got[i], base[i]), (scfg, i)
            assert np.array_equal(eng.result_logprobs[i],
                                  plain.result_logprobs[i]), (scfg, i)


@torch.inference_mode()
def test_snapshot_round_trip_on_the_card(tmp_path):
    """An engine snapshot saved mid-run on the card restores onto the card
    digest-equal (pools and host state), and both finish bitwise alike."""
    _card()
    from repro_torch.serve import snapshot as SN
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.verify.digest import tree_leaf_digests
    cfg, params, prompts = _reduced_serving()
    eng = ContinuousEngine(cfg, params, n_slots=3, max_seq=64, page_size=8,
                           prefill_chunk=16)
    for i, p in prompts.items():
        eng.submit(p, req_id=i, max_new_tokens=9)
    for _ in range(4):
        eng.step()
    eng.save_snapshot(str(tmp_path))
    eng2 = ContinuousEngine.from_snapshot(str(tmp_path), cfg, params)
    pools = eng2.cache.pools["b0_attn"]["attn"][0]
    assert pools.is_cuda
    assert tree_leaf_digests(SN._pool_tree(eng2.cache.pools)) == \
        tree_leaf_digests(SN._pool_tree(eng.cache.pools))
    assert SN._host_state(eng2) == SN._host_state(eng)
    a, b = eng.run(), eng2.run()
    for i in prompts:
        assert np.array_equal(a[i], b[i])
        assert np.array_equal(eng.result_logprobs[i],
                              eng2.result_logprobs[i])


# ------------------------------------------------------ state fingerprint
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32, torch.int32, torch.int8,
                                   torch.uint8, torch.bool])
def test_fingerprint_kernel_equals_its_plain_version(dtype):
    _card()
    from repro_torch.kernels import fingerprint as FP
    gen = torch.Generator(device="cuda").manual_seed(3)
    raw = torch.randint(-2 ** 31, 2 ** 31 - 1, ((1 << 18) + 9,),
                        generator=gen, device="cuda", dtype=torch.int64)
    x = (raw % 2 == 0 if dtype == torch.bool
         else raw.to(torch.int32).view(torch.float32).nan_to_num().to(dtype)
         if dtype.is_floating_point else raw.to(dtype))
    leaves = [x, x[1:], x[5:1000], x[:7].reshape(7, 1).expand(7, 3),
              x[0].clone(), x[:0]]
    before = FP.launches
    got = FP.leaf_fingerprints(leaves)
    assert FP.launches == before + 1
    assert got == [FP.fingerprint_plain(t.cpu()) for t in leaves]


def test_fingerprint_state_on_the_card_equals_the_cpu():
    _card()
    from repro_torch.verify.digest import tree_fingerprint
    cfg = registry.get("stablelm-1.6b").reduced(attention_impl="cuda")
    tcfg = S.TrainConfig(digest_metrics=True)
    state = S.init_state(cfg, tcfg, seed=0, device="cuda")
    fp = tree_fingerprint(state)
    assert fp == tree_fingerprint(O.tree_map(lambda t: t.cpu(), state))
    with pytest.raises(TypeError, match="covers"):
        tree_fingerprint({"x": torch.zeros(3, device="cuda",
                                           dtype=torch.int64)})


# ------------------------------ the selective scan against its first design
# |kernel - other| <= tol * max(1, max|other|), as chip_smoke.py's SCAN_TOL:
# sums over the states and the channels in another order; bf16 y and dz one
# rounding apart
SCAN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SCAN_SHAPES = {                   # (B, S, Din, chunk)
    "ragged_s": (1, 100, 256, 32),    # S not a multiple of the 16-step tile
    "chunk_24": (1, 80, 128, 24),     # chunk not a multiple of 16
    "batch_2": (2, 64, 256, 32),
    "one_step": (2, 1, 256, 512),
}
SCAN_GRADS = ("u", "dt", "A", "B", "C", "D", "z", "h0")


def _scan_operands(b, s, din, dtype, seed=0):
    rng = np.random.default_rng(seed)
    n = 16

    def f(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).cuda()
    x = dict(u=torch.nn.functional.silu(f(b, s, din)),
             dt=torch.nn.functional.softplus(f(b, s, din) - 1.0),
             A=-torch.exp(f(din, n, scale=0.5)), B=f(b, s, n), C=f(b, s, n),
             D=f(din), z=f(b, s, din).to(getattr(torch, dtype)),
             h0=f(b, din, n, scale=0.5))
    dy = f(b, s, din).to(getattr(torch, dtype))
    return [x[k] for k in SCAN_GRADS], dy, f(b, din, n, scale=0.1)


def _scan_grads(partials, args, dy, h_chk, chunk, dh_last):
    """(du, ddt, dA, dB, dC, dD, dz, dh0) from a backward's partials folded
    by the plain fold."""
    from repro_torch.kernels import scan as SC
    du, ddt, dz, dh0, bc_part, ad_part = partials(*args, dy, h_chk, chunk,
                                                  dh_last)
    bc, ad = SC.fold_plain(bc_part, ad_part)
    din = args[0].shape[-1]
    return (du, ddt, ad[:din * 16].view(din, 16), bc[..., :16],
            bc[..., 16:], ad[din * 16:], dz, dh0)


def _scan_plain_grads(args, dy, dh_last):
    from repro_torch.kernels import scan as SC
    leaves = [a.detach().requires_grad_(True) for a in args]
    y, h = SC.selective_scan_plain(*leaves)
    loss = (y.float() * dy.float()).sum() + (h * dh_last).sum()
    return y.detach(), h.detach(), torch.autograd.grad(loss, leaves)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        1.0, float(want.float().abs().max()))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", list(SCAN_SHAPES))
def test_scan_redesign_keeps_its_first_designs_states(shape, dtype):
    """csrc/selective_scan.cu against csrc/selective_scan_v1.cu on the same
    inputs: h_last and h_chk bitwise; y and every gradient within SCAN_TOL
    of the first design's and of the plain version's."""
    _card()
    from repro_torch.kernels import scan as SC
    b, s, din, chunk = SCAN_SHAPES[shape]
    args, dy, dh_last = _scan_operands(b, s, din, dtype)
    y, h, h_chk = SC.scan_fwd_cuda(*args, chunk)
    y1, h1, h_chk1 = SC.scan_fwd_v1_cuda(*args, chunk)
    yp, hp, gp = _scan_plain_grads(args, dy, dh_last)
    assert torch.equal(h, h1) and torch.equal(h_chk, h_chk1)
    assert _rel(y, y1) <= SCAN_TOL[dtype] and _rel(y, yp) <= SCAN_TOL[dtype]
    assert _rel(h, hp) <= SCAN_TOL["float32"]
    g = _scan_grads(SC.scan_bwd_partials_cuda, args, dy, h_chk, chunk,
                    dh_last)
    g1 = _scan_grads(SC.scan_bwd_partials_v1_cuda, args, dy, h_chk1, chunk,
                     dh_last)
    assert torch.equal(g[7], g1[7])      # dh0: the same products, in order
    for name, got, old, plain in zip(SCAN_GRADS, g, g1, gp):
        tol = SCAN_TOL[dtype if name == "z" else "float32"]
        assert _rel(got, old) <= tol, name
        if name != "h0":                 # the model's h0 takes no gradient
            assert _rel(got, plain) <= tol, name


def test_scan_redesign_repeats_bitwise():
    """Ten launches of the forward and of the backward give the same bits."""
    _card()
    from repro_torch.kernels import scan as SC
    b, s, din, chunk = SCAN_SHAPES["ragged_s"]
    args, dy, dh_last = _scan_operands(b, s, din, "bfloat16", seed=1)
    y, h, h_chk = SC.scan_fwd_cuda(*args, chunk)
    g = SC.scan_bwd_cuda(*args, dy, h_chk, chunk, dh_last)
    for _ in range(10):
        y2, h2, h_chk2 = SC.scan_fwd_cuda(*args, chunk)
        assert torch.equal(y, y2) and torch.equal(h, h2)
        assert torch.equal(h_chk, h_chk2)
        g2 = SC.scan_bwd_cuda(*args, dy, h_chk, chunk, dh_last)
        assert all(torch.equal(a, c) for a, c in zip(g, g2))


def test_scan_redesign_results_do_not_depend_on_chunk():
    """y, the last state and every gradient are the same bits at any
    chunk: the sums' order depends on none of S, chunk or the launch."""
    _card()
    from repro_torch.kernels import scan as SC
    b, s, din, _ = SCAN_SHAPES["ragged_s"]
    args, dy, dh_last = _scan_operands(b, s, din, "bfloat16", seed=2)
    results = []
    for chunk in (16, 24, 64, s):
        y, h, h_chk = SC.scan_fwd_cuda(*args, chunk)
        results.append((y, h) + SC.scan_bwd_cuda(*args, dy, h_chk, chunk,
                                                  dh_last))
    for other in results[1:]:
        assert all(torch.equal(a, c) for a, c in zip(results[0], other))


# ------------------------------------------ the xLSTM kernels (mlstm, slstm)
# |kernel - plain| <= tol * max(1, max |plain|): both compute in fp32 from
# the same inputs and differ by the order of their sums
XLSTM_TOL = 1e-4


def _xlstm_err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        1.0, float(want.float().abs().max()))


def _xlstm_operands(b, s, h, hd, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    mlstm = (r(b, s, h, hd).to(dtype), (r(b, s, h, hd) / hd ** 0.5).to(dtype),
             r(b, s, h, hd).to(dtype), r(b, s, h),
             torch.nn.functional.logsigmoid(r(b, s, h) + 1.0))
    m_state = (0.1 * r(b, h, hd, hd), 0.1 * r(b, h, hd), r(b, h).tanh())
    z = tuple(r(b, s, h, hd) for _ in range(4))
    rr = tuple((r(h, hd, hd) / hd ** 0.5).to(dtype) for _ in range(4))
    s_state = (0.3 * r(b, h, hd), 1.0 + r(b, h, hd).abs(),
               0.3 * r(b, h, hd), r(b, h, hd).tanh())
    return mlstm, m_state, (z, rr, s_state)


def _halves(args, t):
    return (tuple(a[:, :t].contiguous() for a in args),
            tuple(a[:, t:].contiguous() for a in args))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,hd", [(2, 300, 4, 256), (2, 77, 4, 32),
                                      (1, 1, 4, 256)])
@torch.no_grad()
def test_xlstm_kernels_match_plain_and_hold_their_bits(b, s, h, hd, dtype):
    """csrc/mlstm.cu (parallel form, recurrence) and csrc/slstm.cu against
    their plain versions (ragged S, hd 256 and 32, the decode step S = 1),
    each launch repeated bitwise, each recurrence split in two launches
    bitwise one launch."""
    _card()
    from repro_torch.kernels import mlstm as ML
    from repro_torch.kernels import slstm as SL
    margs, mst, (z, rr, sst) = _xlstm_operands(b, s, h, hd, dtype, seed=s)
    out = ML.mlstm_parallel_cuda(*margs)
    assert _xlstm_err(out, ML.mlstm_parallel_plain(*margs)) <= XLSTM_TOL
    assert torch.equal(out, ML.mlstm_parallel_cuda(*margs))
    runs = {"mlstm": (lambda a, st: ML.mlstm_recurrent_cuda(*a, *st),
                      lambda a, st: ML.mlstm_recurrent_plain(*a, *st),
                      margs, mst),
            "slstm": (lambda a, st: SL.slstm_cuda(a, rr, st),
                      lambda a, st: SL.slstm_plain(a, rr, st), z, sst)}
    for name, (run, plain, args, st) in runs.items():
        got, want = run(args, st), plain(args, st)
        for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
            assert _xlstm_err(g, w) <= XLSTM_TOL, name
        again = run(args, st)
        assert all(torch.equal(g, a) for g, a in
                   zip((got[0], *got[1]), (again[0], *again[1]))), name
        if s > 1:
            first, second = _halves(args, s // 2)
            o1, st1 = run(first, st)
            o2, st2 = run(second, st1)
            assert torch.equal(torch.cat([o1, o2], 1), got[0]), name
            assert all(torch.equal(x, y) for x, y in zip(st2, got[1])), name


def _xlstm_initial(mst, sst, carried):
    """The carried states, or the model's initial ones (mLSTM zeros; sLSTM
    zeros with m = -1e30)."""
    if carried:
        return mst, sst
    m0 = tuple(torch.zeros_like(x) for x in mst)
    s0 = tuple(torch.zeros_like(x) for x in sst[:3]) + (
        torch.full_like(sst[3], -1e30),)
    return m0, s0


def _xlstm_recurrences(rr):
    """(redesign, first design) of each recurrence, as run(args, state)."""
    from repro_torch.kernels import mlstm as ML
    from repro_torch.kernels import slstm as SL
    return {"mlstm": (lambda a, st: ML.mlstm_recurrent_cuda(*a, *st),
                      lambda a, st: ML.mlstm_recurrent_v1_cuda(*a, *st)),
            "slstm": (lambda a, st: SL.slstm_cuda(a, rr, st),
                      lambda a, st: SL.slstm_v1_cuda(a, rr, st))}


def _leaves(result):
    out, state = result
    return (out, *state)


@pytest.mark.parametrize("carried", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,hd", [(2, 300, 4, 256), (2, 77, 4, 32),
                                      (1, 1, 4, 256), (3, 45, 4, 256)])
@torch.no_grad()
def test_xlstm_redesigns_keep_their_first_designs_bits(b, s, h, hd, dtype,
                                                       carried):
    """csrc/mlstm.cu's recurrence and csrc/slstm.cu against their first
    designs (csrc/mlstm_v1.cu, csrc/slstm_v1.cu) on the same inputs: every
    output and state leaf bitwise, from carried states and from the
    model's initial ones, at a ragged S, hd 256 and 32, the decode step
    S = 1 and an odd B."""
    _card()
    margs, mst, (z, rr, sst) = _xlstm_operands(b, s, h, hd, dtype,
                                               seed=s + b)
    mst, sst = _xlstm_initial(mst, sst, carried)
    inputs = {"mlstm": (margs, mst), "slstm": (z, sst)}
    for name, (new, old) in _xlstm_recurrences(rr).items():
        args, st = inputs[name]
        got, want = _leaves(new(args, st)), _leaves(old(args, st))
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w), (name, i)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@torch.no_grad()
def test_xlstm_redesigns_repeat_and_split_bitwise(dtype):
    """Ten launches of each redesigned recurrence give the same bits, and a
    recurrence split at S - 1 (a prefill, then a one-step decode from its
    state) gives the bits of one launch."""
    _card()
    b, s, h, hd = 2, 130, 4, 256
    margs, mst, (z, rr, sst) = _xlstm_operands(b, s, h, hd, dtype, seed=7)
    inputs = {"mlstm": (margs, mst), "slstm": (z, sst)}
    for name, (new, _) in _xlstm_recurrences(rr).items():
        args, st = inputs[name]
        first = _leaves(new(args, st))
        for _ in range(10):
            again = _leaves(new(args, st))
            assert all(torch.equal(x, y) for x, y in zip(first, again)), name
        head, tail = _halves(args, s - 1)
        o1, st1 = new(head, st)
        o2, st2 = new(tail, st1)
        assert torch.equal(torch.cat([o1, o2], 1), first[0]), name
        assert all(torch.equal(x, y) for x, y in zip(st2, first[1:])), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,hd", [(4, 512, 4, 256), (2, 300, 4, 256),
                                      (2, 77, 4, 32), (1, 1, 4, 256),
                                      (1, 1, 4, 32), (3, 45, 4, 256)])
@torch.no_grad()
def test_xlstm_parallel_redesign_against_its_first_design(b, s, h, hd,
                                                          dtype):
    """csrc/mlstm.cu's parallel form against its first design
    (csrc/mlstm_parallel_v1.cu) on the same inputs: fp32 operands bitwise
    (q . k on the CUDA cores in v1's order), bf16 ones (q . k on the
    tensor cores) within XLSTM_TOL of the first design and of the plain
    version; at the serve shape, a ragged S, hd 32, S = 1 and an odd B;
    ten launches bitwise, and the first design counts no launches."""
    _card()
    from repro_torch.kernels import mlstm as ML
    margs, _, _ = _xlstm_operands(b, s, h, hd, dtype, seed=s + b + 1)
    new = ML.mlstm_parallel_cuda(*margs)
    before = ML.launches_parallel
    old = ML.mlstm_parallel_v1_cuda(*margs)
    assert ML.launches_parallel == before
    if dtype == torch.float32:
        assert torch.equal(new, old)
    else:
        assert _xlstm_err(new, old) <= XLSTM_TOL
        assert _xlstm_err(new, ML.mlstm_parallel_plain(*margs)) <= XLSTM_TOL
    assert all(torch.equal(ML.mlstm_parallel_cuda(*margs), new)
               for _ in range(10))


def test_xlstm_kernels_raise_on_what_they_do_not_take():
    _card()
    from repro_torch.kernels import mlstm as ML
    from repro_torch.kernels import slstm as SL
    margs, mst, (z, rr, sst) = _xlstm_operands(1, 8, 4, 64, torch.bfloat16,
                                               seed=0)
    with pytest.raises(ValueError, match="hd in"):
        ML.mlstm_parallel_cuda(*margs)
    with pytest.raises(ValueError, match="hd in"):
        ML.mlstm_recurrent_cuda(*margs, *mst)
    with pytest.raises(ValueError, match="hd in"):
        SL.slstm_cuda(z, rr, sst)
    margs, _, _ = _xlstm_operands(1, 8, 4, 32, torch.float16, seed=0)
    with pytest.raises(TypeError):
        ML.mlstm_parallel_cuda(*margs)


@torch.inference_mode()
def test_reduced_xlstm_serves_on_the_kernels():
    """The reduced xLSTM-350M (hd 32) on the card: the static engine's
    prefill through the recurrent kernels against the plain mixers, and
    forward (the parallel kernel) equal to prefill + decode within the
    reference's 5e-2 (fp32)."""
    _card()
    from repro_torch.kernels import mlstm as ML
    from repro_torch.kernels import slstm as SL
    cfg = registry.get("xlstm-350m").reduced(dtype_name="float32")
    params = T.init(cfg, seed=0, device="cuda")
    toks = torch.randint(1, cfg.vocab, (2, 64), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
    before = ops.launch_counts()
    full, _ = T.forward(params, {"tokens": toks}, cfg)
    last, caches = T.prefill_step(params, {"tokens": toks[:, :-1]}, cfg,
                                  max_seq=64)
    step, _ = T.decode_step(params, caches, toks[:, -1:], 63, cfg)
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == dict(mlstm_parallel=7, mlstm_recurrent=14, slstm=3)
    torch.testing.assert_close(last[:, 0], full[:, -2], atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(step[:, 0], full[:, -1], atol=5e-2, rtol=5e-2)
    saved = (ML.mlstm_recurrent, SL.slstm)
    ML.mlstm_recurrent, SL.slstm = ML.mlstm_recurrent_plain, SL.slstm_plain
    try:
        plain, _ = T.prefill_step(params, {"tokens": toks[:, :-1]}, cfg,
                                  max_seq=64)
    finally:
        ML.mlstm_recurrent, SL.slstm = saved
    torch.testing.assert_close(last, plain, atol=1e-4, rtol=1e-4)


# ------------------------------- the xLSTM backwards (training on the card)
def _leafed(tensors):
    """fp32 leaves of ``tensors`` (bf16 operands exact in fp32) that take
    a gradient."""
    return [t.detach().float().requires_grad_(True) for t in tensors]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,hd", [(2, 64, 2, 32), (2, 77, 4, 256),
                                      (1, 1, 4, 256), (3, 45, 4, 32)])
@torch.no_grad()
def test_xlstm_backward_kernels_match_plain_and_repeat_bitwise(b, s, h, hd,
                                                               dtype):
    """csrc/mlstm_parallel_bwd.cu and csrc/slstm_bwd.cu against their plain
    backwards on the same inputs and against autograd of the plain
    forwards (every gradient within XLSTM_TOL), three launches bitwise
    (the mLSTM's from the forward's row statistics, whose ``out`` is
    bitwise the forward's without them); the sLSTM forward with its states
    kept bitwise its first design's h_all and state, its kept states within
    XLSTM_TOL of the plain forward's."""
    _card()
    from repro_torch.kernels import mlstm as ML
    from repro_torch.kernels import slstm as SL
    margs, _, (z, rr, sst) = _xlstm_operands(b, s, h, hd, dtype, seed=s + 3)
    gen = torch.Generator(device="cuda").manual_seed(s)
    out, F, stats = ML.mlstm_parallel_stats_cuda(*margs)
    assert torch.equal(out, ML.mlstm_parallel_cuda(*margs))
    dout = torch.randn(out.shape, generator=gen, device="cuda")
    saved = (*margs[:4], F, out)
    got = ML.mlstm_parallel_backward_cuda(*saved, dout, stats)
    plain = ML.mlstm_parallel_backward_plain(*margs, dout)
    with torch.enable_grad():
        leaves = _leafed(margs)
        auto = torch.autograd.grad(ML.mlstm_parallel_plain(*leaves), leaves,
                                   dout)
    for name, g, p, a in zip(("dq", "dk", "dv", "dig", "dfg"), got, plain,
                             auto):
        assert g.dtype == torch.float32, name
        assert _xlstm_err(g, p) <= XLSTM_TOL, name
        assert _xlstm_err(g, a) <= XLSTM_TOL, name
    for _ in range(3):
        again = ML.mlstm_parallel_backward_cuda(*saved, dout, stats)
        assert all(torch.equal(x, y) for x, y in zip(got, again))

    h_all, new, kept = SL.slstm_cuda(z, rr, sst, keep=True)
    v1_h, v1_new = SL.slstm_v1_cuda(z, rr, sst)
    assert torch.equal(h_all, v1_h)
    assert all(torch.equal(x, y) for x, y in zip(new, v1_new))
    _, _, plain_kept = SL.slstm_plain(z, rr, sst, keep=True)
    assert _xlstm_err(kept, plain_kept) <= XLSTM_TOL
    dh = torch.randn(h_all.shape, generator=gen, device="cuda")
    dstate = tuple(torch.randn(t.shape, generator=gen, device="cuda")
                   for t in sst)
    got = SL.slstm_backward_cuda(z, rr, sst, (h_all, kept), dh, dstate)
    plain = SL.slstm_backward_plain(z, rr, sst, (h_all, kept), dh, dstate)
    with torch.enable_grad():
        leaves = _leafed((*z, *rr, *sst))
        h2, new2 = SL.slstm_plain(leaves[:4], leaves[4:8], leaves[8:])
        auto = torch.autograd.grad((h2, *new2), leaves, (dh, *dstate))
    flat = [*got[0], *got[1], *got[2]]
    for i, (g, p, a) in enumerate(zip(flat, [*plain[0], *plain[1],
                                             *plain[2]], auto)):
        assert g.dtype == torch.float32, i
        assert _xlstm_err(g, p) <= XLSTM_TOL, i
        assert _xlstm_err(g, a) <= XLSTM_TOL, i
    for _ in range(3):
        again = SL.slstm_backward_cuda(z, rr, sst, (h_all, kept), dh, dstate)
        assert all(torch.equal(x, y) for x, y in
                   zip(flat, [*again[0], *again[1], *again[2]]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,hd", [(2, 64, 2, 32), (2, 77, 4, 256),
                                      (1, 1, 4, 256), (3, 45, 4, 32),
                                      (1, 130, 4, 256)])
@torch.no_grad()
def test_xlstm_backward_redesign_against_its_first_design(b, s, h, hd,
                                                          dtype):
    """csrc/mlstm_parallel_bwd.cu against its first design
    (csrc/mlstm_parallel_bwd_v1.cu) on the same inputs: fp32 operands give
    its bits on all five gradients, bf16 ones (q . k on the tensor cores)
    agree within XLSTM_TOL; the forward's statistics hold the plain
    forward's m_i and ties exactly, and the rows pass built on them v1's
    m_i (and, for fp32, ds_i and share_i) bitwise; the first design
    counts no launches."""
    _card()
    from repro_torch.kernels import mlstm as ML
    margs, _, _ = _xlstm_operands(b, s, h, hd, dtype, seed=s + 11)
    gen = torch.Generator(device="cuda").manual_seed(s + 1)
    out, F, stats = ML.mlstm_parallel_stats_cuda(*margs)
    _, _, want = ML.mlstm_parallel_stats_plain(*margs)
    assert torch.equal(stats[..., 0], want[..., 0])
    assert torch.equal(stats[..., 2], want[..., 2])
    dout = torch.randn(out.shape, generator=gen, device="cuda")
    rows = ML.backward_row_terms(*margs, out, dout, stats)
    rows_v1 = ML.backward_row_terms(*margs, out, dout)
    assert torch.equal(rows[..., 1], rows_v1[..., 0])
    if dtype == torch.float32:
        assert torch.equal(rows[..., 2:], rows_v1[..., 2:])
    got = ML.mlstm_parallel_backward_cuda(*margs[:4], F, out, dout, stats)
    before = ML.launches_parallel_bwd
    old = ML.mlstm_parallel_backward_v1_cuda(*margs, out, dout)
    assert ML.launches_parallel_bwd == before
    for name, g, o in zip(("dq", "dk", "dv", "dig", "dfg"), got, old):
        if dtype == torch.float32:
            assert torch.equal(g, o), name
        else:
            assert _xlstm_err(g, o) <= XLSTM_TOL, name


def test_reduced_xlstm_trains_on_the_kernels():
    """The reduced xLSTM-350M (hd 32, fp32) on the card: loss_fn's grads
    with remat through the kernels (per mLSTM layer the parallel forward
    twice and its backward's three passes once; the sLSTM's forward twice
    and its backward once) against the plain mixers', every leaf within
    1e-3 of its norm (the sLSTM's b_i of its block's); the same grads again
    bitwise."""
    _card()
    from repro_torch.kernels import mlstm as ML
    from repro_torch.kernels import slstm as SL
    cfg = registry.get("xlstm-350m").reduced(dtype_name="float32")
    params = T.init(cfg, seed=0, device="cuda")
    toks = torch.randint(1, cfg.vocab, (2, 65), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    paths = [p for p, _ in tree_paths(params)]

    def grads():
        leaves = [x.detach().requires_grad_(True)
                  for x in O.tree_leaves(params)]
        tree = {}
        for path, leaf in zip(paths, leaves):
            set_path(tree, path, leaf)
        loss, _ = T.loss_fn(tree, batch, cfg, remat=True)
        return torch.autograd.grad(loss, leaves)

    before = ops.launch_counts()
    got = grads()
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == dict(mlstm_parallel=14, mlstm_parallel_bwd=21, slstm=2,
                      slstm_bwd=1)
    assert all(torch.equal(x, y) for x, y in zip(got, grads()))
    saved = (ML.mlstm_parallel, SL.slstm)
    ML.mlstm_parallel, SL.slstm = ML.mlstm_parallel_plain, SL.slstm_plain
    try:
        want = grads()
    finally:
        ML.mlstm_parallel, SL.slstm = saved
    # the sLSTM's b_i has an exact gradient of 0 (h is invariant under a
    # uniform shift of the input gate), so both runs hold rounding there:
    # its difference is held over its block's gradient norm instead
    block = {}
    for path, w in zip(paths, want):
        key = path.rsplit("/", 1)[0]
        block[key] = block.get(key, 0.0) + float(torch.sum(w * w))
    for path, g, w in zip(paths, got, want):
        norm = (block[path.rsplit("/", 1)[0]] ** 0.5
                if path.endswith("slstm/b_i")
                else float(torch.linalg.vector_norm(w)))
        err = float(torch.linalg.vector_norm(g - w)) / max(norm, 1e-12)
        assert err <= 1e-3, (path, err)
