"""Checks of the port that need the card (marker ``gpu``; they skip without
one). Run them there with ``python -m pytest -q -m gpu tests/test_torch_cuda.py``.
This file imports no JAX, so it also runs where JAX is not installed."""
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import flash_fwd as FF
from repro_torch.models import transformer as T

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
