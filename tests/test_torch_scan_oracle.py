"""The selective scan's redesign beside its first design, on the CPU: the
first design's wrappers refuse CPU tensors, both sources are built and
exported under distinct names, neither names an atomic, and the bound that
``chip_smoke.py`` reports counts the exponentials at the SFU's rate."""
import importlib
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import scan as SCAN

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
EXPORT = re.compile(r'^extern "C" int (\w+)\(', re.MULTILINE)
# as tests/test_torch_hygiene.py: CUDA's atomic functions and PTX's atom.* /
# red.* instructions
ATOMIC = re.compile(r"atomic|\batom\.|\bred\.", re.IGNORECASE)


def _operands(b=1, s=4, din=128, seed=0):
    rng = np.random.default_rng(seed)
    n = SCAN.STATE

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = dict(u=f(b, s, din), dt=torch.nn.functional.softplus(f(b, s, din)),
             A=-torch.exp(f(din, n)), B=f(b, s, n), C=f(b, s, n), D=f(din),
             z=f(b, s, din), h0=f(b, din, n))
    return [x[k] for k in ("u", "dt", "A", "B", "C", "D", "z", "h0")]


def test_first_design_forward_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="one CUDA device"):
        SCAN.scan_fwd_v1_cuda(*_operands(), chunk=2)


def test_first_design_backward_refuses_cpu_tensors():
    args = _operands()
    dy = torch.zeros_like(args[0])
    h_chk = torch.zeros((1, 2, SCAN.STATE, 128))
    with pytest.raises(ValueError, match="one CUDA device"):
        SCAN.scan_bwd_partials_v1_cuda(*args, dy, h_chk, 2)


@pytest.mark.parametrize("name", ["selective_scan", "selective_scan_v1"])
def test_scan_sources_are_built(name):
    assert name in build.SOURCES
    assert (CSRC / f"{name}.cu").is_file()


def test_first_design_exports_its_own_names():
    """Both libraries can be loaded into one process: the first design's
    entry points are the redesign's with a ``_v1`` suffix, none shared."""
    new = EXPORT.findall((CSRC / "selective_scan.cu").read_text())
    old = EXPORT.findall((CSRC / "selective_scan_v1.cu").read_text())
    assert {"dash_scan_fwd", "dash_scan_bwd", "dash_scan_fold"} <= set(new)
    assert sorted(old) == ["dash_scan_bwd_v1", "dash_scan_fold_v1",
                           "dash_scan_fwd_v1"]
    assert not set(new) & set(old)


@pytest.mark.parametrize("name", ["selective_scan", "selective_scan_v1"])
def test_scan_sources_use_no_atomics(name):
    path = CSRC / f"{name}.cu"
    assert path in sorted(CSRC.glob("*.cu*"))   # the hygiene test's sweep
    offenders = [f"{i}: {line.strip()}" for i, line in
                 enumerate(path.read_text().splitlines(), 1)
                 if ATOMIC.search(line)]
    assert not offenders, offenders


def test_redesign_keeps_the_state_recurrence():
    """The redesign's state steps (forward, backward pass 1, pass 2 and the
    recomputed first half) are the first design's expression, so the
    states keep their bits."""
    new = (CSRC / "selective_scan.cu").read_text()
    old = (CSRC / "selective_scan_v1.cu").read_text()
    assert "h[n] = fmaf(expf(dtv * an[n]), h[n], dtu * sm.B[i][n]);" in old
    assert "h[n] = fmaf(a, h[n], dtu * sB[j][n]);" in old
    assert "const float a = expf(dtv * an[i]);" in new
    assert "h[i] = fmaf(a, h[i], dtu * bv[i]);" in new
    assert "h[n] = fmaf(expf(dtv * an[n]), h[n], dtu * bv[n]);" in new
    assert "av[n] = expf(dtv * an[n]);" in new
    assert "h[n] = fmaf(av[n], h[n], dtu * bv[n]);" in new
    assert "hs[i + 1][n] = fmaf(av[n], hs[i][n], dtu * bv[n]);" in new
    # dt * u is one product, then B's: never fused into the state's fma
    assert new.count("dtu = dtv * uv;") + new.count(
        "dtu = dtv * st.u[i][cl];") >= 3


def test_scan_bound_counts_exponentials_at_the_sfu_rate():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    cs = importlib.import_module("chip_smoke")
    b, s, din, _ = cs.SCAN_TRAIN
    fwd_ms, fwd_by = cs._scan_bound(b, s, din, False)
    bwd_ms, bwd_by = cs._scan_bound(b, s, din, True)
    exps = b * s * din * SCAN.STATE
    assert cs.SFU_EXP_PER_S == pytest.approx(132 * 16 * 1.98e9)
    assert fwd_by == "operations"
    assert fwd_ms == pytest.approx(exps / cs.SFU_EXP_PER_S * 1e3)
    assert 0.25 < fwd_ms < 0.26
    assert bwd_by == "bytes" and 0.44 < bwd_ms < 0.45
    # a decode step moves more than it computes
    assert cs._bound(10 * 2 ** 20, 0, torch.float32, exps=1000)[1] == "bytes"
