"""Checks of the port that need the card (marker ``gpu``; they skip without
one). Run them there with ``python -m pytest -q -m gpu tests/test_torch_cuda.py``.
This file imports no JAX, so it also runs where JAX is not installed."""
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.schedules import make_schedule
from repro_torch.kernels import flash_bwd as FB
from repro_torch.kernels import flash_fwd as FF
from repro_torch.kernels import ops
from repro_torch import masks as M
from repro_torch.models import transformer as T
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
