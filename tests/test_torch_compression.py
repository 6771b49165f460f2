"""Port parity for int8 error-feedback gradient compression.

``_quant_dequant``, ``ef_init`` and ``compress_grads`` are elementwise, a
block max, an IEEE division and round-half-even: on the same fp32 inputs
the port must equal the reference **bit for bit** (sizes that are not
multiples of the 256-value block, all-zero blocks, exact rounding ties).

The int8 train step (two steps, four microbatches) is held against the
reference's. Rounding is discontinuous: the two frameworks' grads already
differ by ~4e-8 (summation order), so where a value lies that close to a
rounding boundary the two compressed grads differ by one quantization step
of its block (``max|y_block| / 127``). The test records both packages'
``compress_grads`` inputs and outputs and holds the compressed grads
within fp32 5e-5 plus one quantization step, at a handful of elements at
most; the error feedback likewise; and the params within fp32 5e-5 wherever
the compressed grads agreed, and within AdamW's largest update (lr for each
step, 2·lr with headroom) at the elements where they did not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.dist import compression as JC
from repro.train import optimizer as JO
from repro.train import step as JS
from repro_torch.configs import registry as tregistry
from repro_torch.dist import compression as TC
from repro_torch.models.convert import from_jax_params
from repro_torch.train import optimizer as TO
from repro_torch.train import step as TS


def _bits(x):
    """fp32 (or bf16) bit patterns of a jax array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x.view(
        np.uint32)


def _values(n, seed):
    """fp32 values with a wide range, all-zero blocks, and exact rounding
    ties (127 * (k + 0.5) / 127-scaled values) among them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 2, n)).astype(
        np.float32)
    x[: min(n, 300)] = 0.0                      # a zero block (and a part)
    if n > 600:                                 # a block of exact ties
        blk = np.arange(512, 768)
        x[blk] = ((np.arange(256) % 254) - 127 + 0.5).astype(np.float32)
        x[blk[0]] = 127.0                       # scale = 1: ties at k + 0.5
    return x


@pytest.mark.parametrize("shape", [(1,), (255,), (256,), (257,), (1000,),
                                   (3, 700), (2, 5, 131), (64, 256)])
def test_quant_dequant_is_bitwise_equal_to_reference(shape):
    x = _values(int(np.prod(shape)), seed=len(shape) * 1000 + shape[-1])
    x = x.reshape(shape)
    ours = TC._quant_dequant(torch.from_numpy(x))
    ref = JC._quant_dequant(jnp.asarray(x))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == shape
    np.testing.assert_array_equal(_bits(ours), _bits(ref))
    # the error bound: |x - q| <= scale / 2 per block
    err = np.abs(ours.numpy() - x)
    assert np.all(err <= _quant_step(x) / 2 * (1 + 1e-6))


def test_quant_dequant_bf16_is_bitwise_equal_to_reference():
    x = _values(1000, seed=7)
    ours = TC._quant_dequant(torch.from_numpy(x).to(torch.bfloat16))
    ref = JC._quant_dequant(jnp.asarray(x).astype(jnp.bfloat16))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(ours), _bits(ref))


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((3, 300)) * 1e-3).astype(np.float32),
            "b": {"x": rng.standard_normal(257).astype(np.float32),
                  "z": np.zeros(40, np.float32)}}


def test_ef_init_and_compress_grads_are_bitwise_equal_to_reference():
    g0 = _grad_tree(0)
    tef = TC.ef_init({"w": torch.zeros(3, 300, dtype=torch.bfloat16),
                      "b": {"x": torch.zeros(257), "z": torch.zeros(40)}})
    jef = JC.ef_init(jax.tree.map(jnp.asarray, g0))
    assert tef["w"].dtype == torch.float32 and not tef["w"].any()
    for step in range(3):                      # error feedback carried
        g = _grad_tree(step)
        tc, tef = TC.compress_grads(jax.tree.map(torch.from_numpy, g), tef)
        jc, jef = JC.compress_grads(jax.tree.map(jnp.asarray, g), jef)
        for ours, ref in ((tc, jc), (tef, jef)):
            for path in (("w",), ("b", "x"), ("b", "z")):
                o, r = ours, ref
                for k in path:
                    o, r = o[k], r[k]
                np.testing.assert_array_equal(_bits(o), _bits(r),
                                              err_msg=f"{step} {path}")


def test_compress_grads_keeps_the_residual_bounded():
    """With error feedback the accumulated compressed stream tracks the true
    gradient sum within one step's quantization error."""
    rng = np.random.default_rng(3)
    ef = TC.ef_init({"g": torch.zeros(1000)})
    true, sent = torch.zeros(1000), torch.zeros(1000)
    for _ in range(20):
        g = {"g": torch.from_numpy(rng.standard_normal(1000)
                                   .astype(np.float32))}
        c, ef = TC.compress_grads(g, ef)
        true += g["g"]
        sent += c["g"]
    assert float((true - sent).abs().max()) < 0.05


# ------------------------------------------------------ the int8 train step
def _leaves(tree, prefix=""):
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], path)
        else:
            yield path, np.asarray(tree[key].float() if isinstance(
                tree[key], torch.Tensor) else tree[key], np.float32)


def _quant_step(y):
    """Per element, its block's quantization step max|y_block| / 127."""
    flat = y.reshape(-1)
    pad = (-flat.size) % 256
    blocks = np.concatenate([flat, np.zeros(pad, np.float32)]).reshape(-1, 256)
    step = np.abs(blocks).max(1, keepdims=True) / 127.0
    return np.broadcast_to(step, blocks.shape).reshape(-1)[:flat.size] \
        .reshape(y.shape)


def test_int8_train_step_matches_reference(monkeypatch):
    kw = dict(n_layers=2, dtype_name="float32")
    jcfg = jregistry.get("stablelm-1.6b").reduced(attention_impl="xla", **kw)
    tcfg = tregistry.get("stablelm-1.6b").reduced(attention_impl="cuda", **kw)
    opt = dict(warmup_steps=1, lr=1e-3)
    jt = JS.TrainConfig(opt=JO.OptConfig(**opt), microbatches=4,
                        grad_compression="int8")
    tt = TS.TrainConfig(opt=TO.OptConfig(**opt), microbatches=4,
                        grad_compression="int8")
    jstate = JS.init_state(jcfg, jt, jax.random.PRNGKey(0))
    tstate = TS.state_from_params(from_jax_params(
        jax.tree.map(np.asarray, jstate["params"]), tcfg, device="cpu"), tt)
    assert sorted(dict(_leaves(tstate["ef"]))) == sorted(
        dict(_leaves(jstate["ef"])))
    records = {"ref": [], "port": []}

    def recording(mod, name):
        real = mod.compress_grads

        def rec(grads, ef):
            c, new_ef = real(grads, ef)
            y = jax.tree.map(lambda g, e: np.asarray(g, np.float32)
                             + np.asarray(e), dict(_leaves(grads)),
                             dict(_leaves(ef)))
            records[name].append((y, dict(_leaves(c))))
            return c, new_ef
        monkeypatch.setattr(mod, "compress_grads", rec)

    recording(JC, "ref")
    recording(TC, "port")
    jstep, tstep = JS.make_train_step(jcfg, jt), TS.make_train_step(tcfg, tt)
    rng = np.random.default_rng(0)
    flipped = {}
    for _ in range(2):
        toks = rng.integers(0, jcfg.vocab, (4, 129)).astype(np.int32)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks[:, :-1]),
                                    "labels": jnp.asarray(toks[:, 1:])})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(
            toks[:, :-1]).long(), "labels": torch.from_numpy(
            toks[:, 1:]).long()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=2e-5, rtol=2e-5)
        (y_ref, c_ref), (_, c_port) = records["ref"][-1], records["port"][-1]
        jef, tef = dict(_leaves(jstate["ef"])), dict(_leaves(tstate["ef"]))
        for path, cr in c_ref.items():
            q = _quant_step(y_ref[path])
            diff = np.abs(c_port[path] - cr)
            # agreement within fp32 rounding, or one quantization step
            assert np.all(diff <= 5e-5 + q * (1 + 1e-3)), path
            flip = diff > 5e-5
            assert np.all(np.abs(tef[path] - jef[path])[~flip] <= 5e-5), path
            assert np.all(np.abs(tef[path] - jef[path])[flip]
                          <= 5e-5 + q[flip] * (1 + 1e-3)), path
            flipped[path] = flipped.get(path, np.zeros_like(flip)) | flip
    n_flip = sum(int(f.sum()) for f in flipped.values())
    n_all = sum(f.size for f in flipped.values())
    assert n_flip <= 1e-3 * n_all, (n_flip, n_all)
    jp, tp = (dict(_leaves(jstate["params"])),
              dict(_leaves(tstate["params"])))
    for path, r in jp.items():
        diff = np.abs(tp[path] - r)
        flip = flipped[path]
        np.testing.assert_array_less(diff[~flip], 5e-5, err_msg=path)
        np.testing.assert_array_less(diff[flip], 5e-5 + 2 * 2 * opt["lr"],
                                     err_msg=path)
