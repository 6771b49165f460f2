"""Port parity for the DASH schedules: every integer array the backward
kernels consume — the serialized task list, the padded per-worker chains and
the first-visit flags — equals the reference's exactly (``np.array_equal``),
for every generator, mask, tile count n in 2..16 and head count 1..3."""
import numpy as np
import pytest

from repro.core import schedules as jsched
from repro.kernels.flash_bwd import first_visit_flags as j_first_visit
from repro_torch.core import schedules as tsched
from repro_torch.kernels.flash_bwd import first_visit_flags as t_first_visit

GENERATORS = [("fa3", False), ("fa3", True), ("descending", False),
              ("descending", True), ("shift", False),
              ("symmetric_shift", True)]
WORKER_KEYS = ("kv_ids", "q_ids", "valid", "q_first", "visited")


def _worker_chains(schedule, head):
    try:
        return schedule.worker_chains(head)
    except ValueError as err:    # a worker with no task for this head
        return str(err)


@pytest.mark.parametrize("n", range(2, 17))
@pytest.mark.parametrize("name,causal", GENERATORS)
def test_schedule_arrays_equal_reference(name, causal, n):
    for n_heads in (1, 2, 3):
        ref = jsched.make_schedule(name, n, n_heads, causal)
        ours = tsched.make_schedule(name, n, n_heads, causal)
        ours.validate()
        assert ours.chains == ref.chains
        assert ours.reduction_order == ref.reduction_order
        for head in range(n_heads):
            kv_r, q_r = ref.prefetch_arrays(head)
            kv_t, q_t = ours.prefetch_arrays(head)
            assert kv_t.dtype == np.int32 and q_t.dtype == np.int32
            assert np.array_equal(kv_t, kv_r) and np.array_equal(q_t, q_r)
            assert np.array_equal(t_first_visit(kv_t, q_t),
                                  j_first_visit(kv_r, q_r))
            wr, wt = _worker_chains(ref, head), _worker_chains(ours, head)
            if isinstance(wr, str):
                assert wt == wr
                continue
            assert wt["single_visit"] == wr["single_visit"]
            for key in WORKER_KEYS:
                assert wt[key].dtype == np.int32
                assert np.array_equal(wt[key], wr[key]), (key, head)


def test_cached_schedule_shares_one_instance_and_refuses_masks():
    a = tsched.cached_schedule("symmetric_shift", 8, n_heads=1, causal=True)
    b = tsched.cached_schedule("symmetric_shift", 8, 1, True)
    assert a is b
    # one head: symmetric_shift has no head pair and plays descending's
    # chains (the reference's odd-head branch), the default causal backward
    desc = tsched.make_schedule("descending", 8, 1, True)
    assert a.chains == desc.chains
    with pytest.raises(NotImplementedError, match="masks slice"):
        tsched.cached_schedule("shift", 4, mask=object())
    with pytest.raises(NotImplementedError, match="masks slice"):
        tsched.make_schedule("shift", 4, mask=object())
    with pytest.raises(ValueError, match="full-mask optimum"):
        tsched.make_schedule("shift", 4, causal=True)
