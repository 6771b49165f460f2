"""torch's intra-op threads under pytest-xdist.

Each xdist worker is a process of its own, and torch's intra-op pool takes
every core in each of them: with 6 workers on 8 cores the port's CPU tests
ran at a load of ~43 and took several times as long. Every worker collects
every test module, so this one caps torch's threads when it is imported, in
every worker and before any test runs: ``max(1, os.cpu_count() //
PYTEST_XDIST_WORKER_COUNT)``. Outside xdist nothing changes."""
import os

import torch


def xdist_thread_cap():
    """The intra-op thread count a worker may use, None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, (os.cpu_count() or 1) // int(workers))


CAP = xdist_thread_cap()
if CAP is not None and torch.get_num_threads() > CAP:
    torch.set_num_threads(CAP)


def test_thread_cap_rule(monkeypatch):
    monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
    assert xdist_thread_cap() is None
    cores = os.cpu_count() or 1
    for workers in (1, 6, 4 * cores):
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", str(workers))
        assert xdist_thread_cap() == max(1, cores // workers)


def test_thread_cap_is_in_effect_under_xdist():
    """Under xdist the worker's torch runs on at most its share of the
    cores; outside it, the cap is not set."""
    assert CAP == xdist_thread_cap()
    if CAP is None:
        assert os.environ.get("PYTEST_XDIST_WORKER_COUNT") is None
    else:
        assert 1 <= torch.get_num_threads() <= CAP
