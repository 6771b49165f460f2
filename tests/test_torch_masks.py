"""Port parity for the block-sparse mask subsystem: every mask layer
(``repr``, ``key()``, ``materialize``, ``block_map``, ``token_info``), every
array of a compiled block schedule (``shift`` and ``fa3``) and the forward's
``mask_grid`` equal the reference's exactly (``np.array_equal``), for every
atom and composition over several (S, block); plus the schedule entry
points' mask routing and guards, and the kernels' mask program (emulated
here) against the dense mask."""
import numpy as np
import pytest
import torch

from repro import masks as JM
from repro.kernels.flash_fwd import mask_grid as j_mask_grid
from repro.tune import pick_placement as j_pick_placement
from repro_torch import masks as TM
from repro_torch.core import schedules as tsched
from repro_torch.kernels import flash_fwd as tfwd

SHAPES = [(256, 64), (256, 128), (512, 64), (512, 128)]
WORKER_KEYS = ("kv_ids", "q_ids", "valid", "q_first", "visited")


def _specs(m, s):
    """The same specs built from one package's ``masks`` module."""
    return {
        "full": m.Full(),
        "causal": m.Causal(),
        "window": m.SlidingWindow(96),
        "window_1": m.SlidingWindow(1),
        "prefix": m.PrefixLM(80),
        "sink": m.Causal() & m.Sink(16),
        "document": m.Document.from_lengths((100, s - 100)),
        "document_bidir": m.Document.from_lengths((60, 70, s - 130),
                                                  causal=False),
        "streaming": m.streaming_mask(64, 16),
        "window_or_prefix": m.SlidingWindow(32) | m.PrefixLM(40),
        "document_window": (m.Document.from_lengths((s // 2, s // 2))
                            & m.SlidingWindow(48)),
    }


NAMES = list(_specs(TM, 256))


def _pair(name, s):
    return _specs(JM, s)[name], _specs(TM, s)[name]


@pytest.mark.parametrize("s,block", SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_mask_layers_equal_reference(name, s, block):
    ref, ours = _pair(name, s)
    assert repr(ours) == repr(ref)
    assert ours.key() == ref.key()
    assert hash(ours) == hash(_specs(TM, s)[name])
    assert np.array_equal(ours.materialize(s), ref.materialize(s))
    n = s // block
    bm_r, bm_t = ref.block_map(n, n, block, block), ours.block_map(n, n, block,
                                                                   block)
    assert bm_t.dtype == np.int8 and np.array_equal(bm_t, bm_r)
    ti_r, ti_t = ref.token_info(s), ours.token_info(s)
    assert (ti_r is None) == (ti_t is None)
    if ti_r is not None:
        assert ti_t.dtype == np.int32 and np.array_equal(ti_t, ti_r)


@pytest.mark.parametrize("placement", ["shift", "fa3"])
@pytest.mark.parametrize("s,block", SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_block_schedules_equal_reference(name, s, block, placement):
    jmask, tmask = _pair(name, s)
    n = s // block
    ref = JM.compile_block_schedule(jmask, n, n, block, block, placement)
    ours = TM.compile_block_schedule(tmask, n, n, block, block, placement)
    for field in ("name", "causal", "n_workers", "n_kv", "n_q", "n_heads",
                  "chains", "reduction_order", "cells", "partial_cells",
                  "mask_key"):
        assert getattr(ours, field) == getattr(ref, field), field
    for a, b in zip(ours.prefetch_arrays(), ref.prefetch_arrays()):
        assert a.dtype == np.int32 and np.array_equal(a, b)
    wt, wr = ours.worker_chains(), ref.worker_chains()
    assert wt["single_visit"] == wr["single_visit"]
    for key in WORKER_KEYS:
        assert wt[key].dtype == np.int32
        assert np.array_equal(wt[key], wr[key]), key


@pytest.mark.parametrize("s,block", SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_mask_grid_equals_reference(name, s, block):
    jmask, tmask = _pair(name, s)
    n = s // block
    for a, b in zip(tfwd.mask_grid(tmask, n, n, block, block),
                    j_mask_grid(jmask, n, n, block, block)):
        assert a.dtype == np.int32 and np.array_equal(a, b)


def test_train_window_grid_and_schedule():
    """The train-window slice's mask at S = 4096, block 128: 252 live tiles,
    56 of them PARTIAL; 32 workers with chains of 9 down to 1, single
    visit (so the worker-parallel backward runs); the reference's key."""
    mask = TM.SlidingWindow(1024)
    grid = tfwd.mask_grid(mask, 32, 32, 128, 128)
    assert len(grid[0]) == 252 and int(grid[4].sum()) == 56
    sch = tsched.cached_schedule("shift", 32, mask=mask)
    wc = sch.worker_chains()
    assert wc["single_visit"] and sch.n_workers == 32
    assert wc["valid"].sum(1).tolist() == [9] * 24 + list(range(8, 0, -1))
    assert sch.mask_key == "SlidingWindow:e7319b6e612c"
    assert sch.mask_key == JM.SlidingWindow(1024).key()


def test_schedule_entry_points_route_masks():
    mask = TM.SlidingWindow(96)
    compiled = TM.compile_block_schedule(mask, 4, 4, 64, 64, "fa3")
    made = tsched.make_schedule("fa3", 4, mask=mask, block_q=64, block_k=64)
    assert made.chains == compiled.chains and made.mask_key == mask.key()
    a = tsched.cached_schedule("shift", 4, mask=mask, block_q=64, block_k=64)
    b = TM.cached_block_schedule(mask, 4, 4, 64, 64, "shift")
    assert a is b
    # a different mask with the same tile counts never shares the schedule
    other = tsched.cached_schedule("shift", 4, mask=TM.SlidingWindow(97),
                                   block_q=64, block_k=64)
    assert other is not a and other.mask_key != a.mask_key
    for fn in (tsched.make_schedule, tsched.cached_schedule):
        with pytest.raises(ValueError, match="placements"):
            fn("symmetric_shift", 4, mask=mask)
        with pytest.raises(ValueError, match="placements"):
            fn("descending", 4, mask=mask)
    with pytest.raises(KeyError, match="placement"):
        TM.compile_block_schedule(mask, 4, 4, 64, 64, "descending")
    # tune=True: the placement the reference's tuner picks, on the same
    # memoized instance a hand-picked call gets
    picked = j_pick_placement(JM.SlidingWindow(96), 4, 4, 64, 64)
    assert tsched.cached_schedule("fa3", 4, mask=mask, block_q=64,
                                  block_k=64, tune=True) is \
        TM.cached_block_schedule(mask, 4, 4, 64, 64, picked)
    assert TM.cached_block_schedule(mask, 4, 4, tune=True) is \
        TM.cached_block_schedule(
            mask, 4, 4, placement=j_pick_placement(JM.SlidingWindow(96), 4,
                                                   4))


def test_masks_that_hide_a_row_raise():
    hidden = TM.Causal() & TM.Sink(0)
    with pytest.raises(ValueError, match="attend to nothing"):
        hidden.check(64)
    with pytest.raises(ValueError, match="attend to nothing"):
        hidden.block_map(2, 2, 32, 32)


@pytest.mark.parametrize("name", NAMES)
def test_tile_mask_on_torch_tiles_equals_the_dense_mask(name):
    """The plain kernels' per-tile evaluation (torch iotas, token_info
    slices) agrees with ``materialize`` on every tile."""
    s, block = 256, 64
    mask = _specs(TM, s)[name]
    dense = mask.materialize(s)
    info = tfwd.token_info(mask, s, "cpu")
    iota = torch.arange(block)
    for qi in range(s // block):
        for ki in range(s // block):
            qs = slice(qi * block, (qi + 1) * block)
            ks = slice(ki * block, (ki + 1) * block)
            got = mask.tile_mask(qi * block + iota[:, None],
                                 ki * block + iota[None, :], info[qs],
                                 info[ks])
            assert np.array_equal(got.numpy(), dense[qs, ks]), (qi, ki)


def _run_program(prog, info, q, k):
    """The CUDA kernels' evaluator (``csrc/mask_program.cuh::visible``),
    step for step — a one-bit-per-entry stack in an unsigned word — on
    numpy position grids."""
    stack = np.zeros(np.broadcast_shapes(q.shape, k.shape), np.uint32)
    for op, arg in prog:
        if op == tfwd.OP_AND:
            stack = ((stack >> 2) << 1) | (stack & (stack >> 1) & 1)
            continue
        if op == tfwd.OP_OR:
            stack = ((stack >> 2) << 1) | ((stack | (stack >> 1)) & 1)
            continue
        v = {tfwd.OP_FULL: np.ones_like(q >= k),
             tfwd.OP_CAUSAL: q >= k,
             tfwd.OP_WINDOW: (q >= k) & (k > q - arg),
             tfwd.OP_PREFIX: (q >= k) | (k < arg),
             tfwd.OP_SINK: k < arg,
             tfwd.OP_DOC: info[q] == info[k],
             tfwd.OP_DOC_CAUSAL: (info[q] == info[k]) & (q >= k)}[op]
        stack = (stack << 1) | v.astype(np.uint32)
    return (stack & 1).astype(bool)


@pytest.mark.parametrize("name", NAMES)
def test_mask_program_equals_the_dense_mask(name):
    s = 256
    mask = _specs(TM, s)[name]
    prog = tfwd.mask_program(mask)
    assert 0 < len(prog) <= tfwd.MAX_PROGRAM
    info = tfwd.token_info(mask, s, "cpu").numpy()
    q = np.arange(s)[:, None]
    k = np.arange(s)[None, :]
    got = np.broadcast_to(_run_program(prog, info, q, k), (s, s))
    assert np.array_equal(got, mask.materialize(s))


def test_mask_program_refuses_what_the_kernels_cannot_evaluate():
    class Custom(TM.MaskSpec):
        def mask_fn(self, q, k):
            return q >= k

    with pytest.raises(ValueError, match="atoms"):
        tfwd.mask_program(Custom())
    deep = TM.SlidingWindow(8)
    for _ in range(8):
        deep = deep & TM.SlidingWindow(8)
    with pytest.raises(ValueError, match="at most 16"):
        tfwd.mask_arrays(deep, 256, 128, "cpu")
