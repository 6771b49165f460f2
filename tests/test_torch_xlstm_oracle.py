"""The xLSTM recurrences' redesigns beside their first designs, on the CPU:
the first designs' wrappers refuse CPU tensors, all four sources are built
and exported under distinct names, none names an atomic, and the
algorithm of the mLSTM's reduce-scatter of 32 row sums gives each sum the
bits of the first design's butterfly. That the kernels keep the first
designs' bits is held on the card (``tests/test_torch_cuda.py``)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import mlstm as ML
from repro_torch.kernels import slstm as SL

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
EXPORT = re.compile(r'^extern "C" \w+ (\w+)\(', re.MULTILINE)
# as tests/test_torch_hygiene.py: CUDA's atomic functions and PTX's atom.* /
# red.* instructions
ATOMIC = re.compile(r"atomic|\batom\.|\bred\.", re.IGNORECASE)
SOURCES = ("mlstm", "mlstm_v1", "slstm", "slstm_v1")


def _mlstm_operands(b=1, s=3, h=2, hd=32, seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return (f(b, s, h, hd), f(b, s, h, hd), f(b, s, h, hd), f(b, s, h),
            f(b, s, h)), (f(b, h, hd, hd), f(b, h, hd), f(b, h))


def test_mlstm_first_design_refuses_cpu_tensors():
    args, state = _mlstm_operands()
    with pytest.raises(ValueError, match="one CUDA device"):
        ML.mlstm_recurrent_v1_cuda(*args, *state)


def test_slstm_first_design_refuses_cpu_tensors():
    rng = np.random.default_rng(1)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    z = tuple(f(1, 3, 2, 32) for _ in range(4))
    r = tuple(f(2, 32, 32) for _ in range(4))
    state = tuple(f(1, 2, 32) for _ in range(4))
    with pytest.raises(ValueError, match="one CUDA device"):
        SL.slstm_v1_cuda(z, r, state)


def test_first_designs_count_no_launches():
    """A refused first-design call leaves the redesigns' counters alone
    (the first designs count in none)."""
    before = (ML.launches_recurrent, SL.launches)
    args, state = _mlstm_operands()
    with pytest.raises(ValueError):
        ML.mlstm_recurrent_v1_cuda(*args, *state)
    assert (ML.launches_recurrent, SL.launches) == before


@pytest.mark.parametrize("name", SOURCES)
def test_xlstm_sources_are_built(name):
    assert name in build.SOURCES
    assert (CSRC / f"{name}.cu").is_file()


def test_first_designs_export_their_own_names():
    """All four libraries can be loaded into one process: the first
    designs' entry points are the redesigns' with a ``_v1`` suffix, and the
    mLSTM's first design leaves out the parallel form."""
    names = {n: set(EXPORT.findall((CSRC / f"{n}.cu").read_text()))
             for n in SOURCES}
    assert {"dash_mlstm_parallel", "dash_mlstm_recurrent",
            "dash_mlstm_recurrent_layout"} <= names["mlstm"]
    assert names["mlstm_v1"] == {"dash_mlstm_recurrent_v1"}
    assert "dash_slstm" in names["slstm"]
    assert names["slstm_v1"] == {"dash_slstm_v1"}
    everything = [x for n in SOURCES for x in names[n]]
    assert len(everything) == len(set(everything))


@pytest.mark.parametrize("name", SOURCES)
def test_xlstm_sources_use_no_atomics(name):
    path = CSRC / f"{name}.cu"
    offenders = [f"{i}: {line.strip()}" for i, line in
                 enumerate(path.read_text().splitlines(), 1)
                 if ATOMIC.search(line)]
    assert not offenders, offenders


def _butterfly(x):
    """v1's warp_sum of each column of x (32 lanes, N values), fp32: every
    lane's result (all equal)."""
    x = x.copy()
    o = 16
    while o:
        x = (x + x[np.arange(32) ^ o]).astype(np.float32)
        o //= 2
    return x


def _reduce_scatter(x):
    """A NumPy model of csrc/mlstm.cu's reduce_scatter of N values a lane
    (x: 32 x N fp32): lane l's v[0] after the five xor stages."""
    lanes = np.arange(32)
    v = x.copy()
    n, o = x.shape[1], 16
    while o:
        up = (lanes & o) != 0
        if n > 1:
            half = n // 2
            lo, hi = v[:, :half], v[:, half:n]
            send = np.where(up[:, None], lo, hi)
            keep = np.where(up[:, None], hi, lo)
            v = (keep + send[lanes ^ o]).astype(np.float32)
            n = half
        else:
            v = (v + v[lanes ^ o]).astype(np.float32)
        o //= 2
    return v[:, 0]


@pytest.mark.parametrize("n", [32, 16, 8, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reduce_scatter_gives_the_butterflys_bits(n, seed):
    """Each lane's sum from the reduce-scatter is bitwise the butterfly's
    sum of that value (value l >> (5 - log2 n) for lane l), on values
    spread over many magnitudes so that the order of the additions
    shows. This checks the algorithm in a NumPy model, not the kernel: the
    kernel's bits are held against the first design's on the card."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((32, n)) * 10.0 ** rng.integers(
        -4, 5, (32, n))).astype(np.float32)
    got = _reduce_scatter(x)
    want = _butterfly(x)
    index = np.arange(32) >> (5 - int(np.log2(n)))
    assert np.array_equal(got.view(np.int32),
                          want[np.arange(32), index].view(np.int32))
    # a different association (lanes summed in order) differs somewhere
    if n == 32 and seed == 0:
        seq = np.zeros(n, dtype=np.float32)
        for lane in range(32):
            seq = (seq + x[lane]).astype(np.float32)
        assert not np.array_equal(seq.view(np.int32),
                                  want[0].view(np.int32))


def test_variant_builds_are_libraries_of_their_own():
    """A source built with -D defines (the clock64() stamps) gets its own
    library path for each set of defines; the plain build's path is
    unchanged by the option."""
    plain = build.library_path("mlstm")
    assert build.library_path("mlstm", ()) == plain
    stamped = build.library_path("mlstm", ("DASH_STAMPS",))
    assert stamped != plain and stamped.parent == plain.parent
    assert build.library_path("mlstm", ("DASH_STAMPS", "NDEBUG")) not in (
        plain, stamped)
