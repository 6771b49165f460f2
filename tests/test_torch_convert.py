"""The weight bridge ``repro_torch.models.convert.from_jax_params``: every leaf
of ``repro.models.transformer.init`` is used exactly once, bit for bit, and
anything that does not map raises."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro_torch.configs import registry as tregistry
from repro_torch.models import transformer as TT
from repro_torch.models.convert import from_jax_params
from repro_torch.models.module import iter_defs


def _tree(dtype):
    jcfg = jregistry.get("stablelm-1.6b").reduced(n_layers=2, dtype_name=dtype)
    tcfg = tregistry.get("stablelm-1.6b").reduced(n_layers=2, dtype_name=dtype)
    return jax.tree.map(np.asarray, JT.init(jcfg, jax.random.PRNGKey(3))), tcfg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_leaf_used_once_bit_for_bit(dtype):
    tree, tcfg = _tree(dtype)
    params = from_jax_params(tree, tcfg, device="cpu")
    ref, ours = _flat(tree), _flat(params)
    assert sorted(ref) == sorted(ours) == sorted(
        p for p, _ in iter_defs(TT.param_defs(tcfg)))
    for path, arr in ref.items():
        t = ours[path]
        assert tuple(t.shape) == arr.shape, path
        if dtype == "float32" or "ln" in path:      # norms stay fp32
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), arr)
        else:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          arr.view(np.int16))


def test_extra_leaf_raises():
    tree, tcfg = _tree("float32")
    tree["blocks"]["b0_attn"]["attn"]["bq"] = np.zeros((2, 128), np.float32)
    with pytest.raises(KeyError, match="no counterpart"):
        from_jax_params(tree, tcfg, device="cpu")


def test_missing_leaf_raises():
    tree, tcfg = _tree("float32")
    del tree["lm_head"]
    with pytest.raises(KeyError, match="lacks"):
        from_jax_params(tree, tcfg, device="cpu")


def test_shape_mismatch_raises():
    tree, tcfg = _tree("float32")
    tree["blocks"]["b0_attn"]["mlp"]["w_up"] = np.zeros((2, 128, 255),
                                                         np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(tree, tcfg, device="cpu")
