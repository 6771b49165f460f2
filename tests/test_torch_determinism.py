"""Port parity for the pinned-order reductions of ``core.determinism``: each
is a chain of elementwise IEEE adds in a declared order, so on the CPU the
port's fp32 result must equal the reference's **bit for bit** (compared as
raw bytes, so -0.0 and NaN payloads count) — ordered folds along any axis,
fixed-arity trees with padding, permuted folds, the schedule-ordered dQ
accumulation and the Table-1 deviation metric. The cross-device ring is
not ported and raises."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import determinism as jdet
from repro.core import schedules as jsched
from repro_torch.core import determinism as tdet


def _parts(shape, seed):
    """fp32 values spread over many binades, so the order of the adds
    changes the bits."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp2(rng.integers(-12, 12, shape))
    return x.astype(np.float32)


def _bitwise(ours, ref):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.dtype == ref.dtype == np.float32
    assert ours.shape == ref.shape
    assert ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize("shape,axis", [((7,), 0), ((9, 33), 0), ((9, 33), 1),
                                        ((5, 6, 17), 2), ((4, 6, 17), -2)])
def test_ordered_sum_bitwise(shape, axis):
    x = _parts(shape, seed=len(shape) + axis)
    _bitwise(tdet.ordered_sum(torch.from_numpy(x), axis),
             jdet.ordered_sum(jnp.asarray(x), axis))
    # and it is the left fold from zero, not torch.sum's tree
    moved = np.moveaxis(x, axis, 0)
    acc = np.zeros(moved.shape[1:], np.float32)
    for row in moved:
        acc = acc + row
    assert tdet.ordered_sum(torch.from_numpy(x), axis).numpy().tobytes() \
        == acc.tobytes()


@pytest.mark.parametrize("arity", [2, 3, 4])
@pytest.mark.parametrize("n", [1, 5, 8, 9, 27])
def test_tree_sum_fixed_bitwise(n, arity):
    x = _parts((n, 3, 19), seed=n * arity)
    _bitwise(tdet.tree_sum_fixed(torch.from_numpy(x), 0, arity),
             jdet.tree_sum_fixed(jnp.asarray(x), 0, arity))
    xt = np.ascontiguousarray(np.moveaxis(x, 0, 2))
    _bitwise(tdet.tree_sum_fixed(torch.from_numpy(xt), 2, arity),
             jdet.tree_sum_fixed(jnp.asarray(xt), 2, arity))


@pytest.mark.parametrize("seed", range(4))
def test_permuted_sum_bitwise(seed):
    x = _parts((12, 8, 16), seed=seed)
    perm = np.random.default_rng(100 + seed).permutation(12)
    _bitwise(tdet.permuted_sum(torch.from_numpy(x), perm),
             jdet.permuted_sum(jnp.asarray(x), perm))
    xt = np.ascontiguousarray(np.moveaxis(x, 0, 1))
    _bitwise(tdet.permuted_sum(torch.from_numpy(xt), perm, axis=1),
             jdet.permuted_sum(jnp.asarray(xt), perm, axis=1))


@pytest.mark.parametrize("name,causal", [("fa3", False), ("shift", False),
                                         ("descending", True),
                                         ("symmetric_shift", True)])
def test_schedule_ordered_dq_bitwise(name, causal):
    """Every (head, q) column of a schedule, its dQ partials folded in the
    column's reduction order."""
    n = 6
    sch = jsched.make_schedule(name, n, 2, causal)
    x = _parts((n, 16, 8), seed=n)
    for (h, q), order in sorted(sch.reduction_order.items()):
        kvs = [kv for kv, _ in order]
        ours = tdet.schedule_ordered_dq(torch.from_numpy(x[kvs]),
                                        list(range(len(kvs)))[::-1])
        ref = jdet.schedule_ordered_dq(jnp.asarray(x[kvs]),
                                       list(range(len(kvs)))[::-1])
        _bitwise(ours, ref)
        _bitwise(tdet.schedule_ordered_dq(torch.from_numpy(x), kvs),
                 jdet.schedule_ordered_dq(jnp.asarray(x), kvs))


def test_max_deviation_equals_reference():
    """Table-1's metric over permuted accumulations: the same float (the
    reference's unused key is dropped from the port's signature)."""
    x = _parts((32, 64), seed=7)
    perms = [np.random.default_rng(i).permutation(32) if i else np.arange(32)
             for i in range(6)]
    ours = tdet.max_deviation(
        lambda i: tdet.permuted_sum(torch.from_numpy(x), perms[i]), n_runs=6)
    ref = jdet.max_deviation(
        lambda i: jdet.permuted_sum(jnp.asarray(x), perms[i]),
        jax.random.PRNGKey(0), n_runs=6)
    assert ours == ref
    assert ours > 0.0      # the orders really differ in the last bits
    assert tdet.max_deviation(
        lambda i: tdet.ordered_sum(torch.from_numpy(x)), n_runs=4) == 0.0


def test_ring_ordered_psum_raises_until_the_distributed_slice():
    with pytest.raises(NotImplementedError, match="A9"):
        tdet.ring_ordered_psum(torch.zeros(3), "data")
