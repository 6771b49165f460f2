"""Checks of the port that need the card (marker ``gpu``; they skip without
one). Run them there with ``python -m pytest -q -m gpu tests/test_torch_cuda.py``.
This file imports no JAX, so it also runs where JAX is not installed."""
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.schedules import make_schedule
from repro_torch.kernels import flash_bwd as FB
from repro_torch.kernels import flash_fwd as FF
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
@pytest.mark.parametrize("h,hk,d", [(2, 2, 64), (4, 2, 128), (2, 1, 32)])
def test_backward_kernels_match_plain_and_each_other(sched, causal, dtype, h,
                                                     hk, d):
    """worker kernel + fold vs the plain version at the reference's grad
    tolerances; serialized kernel ≡ worker kernel + fold, bit for bit."""
    _card()
    q, k, v, do, out, lse = _bwd_inputs(1, h, hk, 384, d, dtype, causal,
                                        seed=d + h)
    schedule = make_schedule(sched, 3, 1, causal)
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
