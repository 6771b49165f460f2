"""The port's training-lifecycle contract on the CPU (reduced StableLM, as
the reference's ``LifecycleConfig``): for every cell, N straight steps ≡ k
steps → async checkpoint → crash → restore → N−k steps, bitwise by digest
chain; a chain that catches a real divergence; run-to-run stability;
token-stream digests invariant to the host split; the unported cells and
scenarios raise; and the operator path — ``launch.train`` killed with
``os._exit(17)`` then ``--resume``d in subprocesses, and
``launch.failures`` — ends on the straight run's chain head."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import failures
from repro_torch.launch import train as tlaunch
from repro_torch.verify import lifecycle as L
from repro_torch.verify.digest import DigestChain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = sorted(L.MATRIX) + sorted(L.EXTRA)


@pytest.mark.parametrize("cell", CELLS)
def test_straight_and_resume_are_bitwise_equal(cell, tmp_path):
    lc = L.cell_config(cell)
    straight = L.run_straight(lc, device="cpu")
    resume = L.run_with_crash_resume(lc, str(tmp_path / "resume"),
                                     crash_at=2, device="cpu")
    assert [s for s, _ in straight.records] == list(range(1, lc.steps + 1))
    assert resume == straight, (
        f"crash/resume diverged at step {resume.first_divergence(straight)}")


def test_matrix_holds_the_references_cells():
    assert sorted(L.MATRIX) == ["base", "bf16opt", "gqa", "int8", "mb4",
                                "moe", "remat"]
    assert L.MATRIX["moe"].arch == "phi3.5-moe-42b-a6.6b"
    assert L.MATRIX["remat"].remat_policy == "dots"
    assert L.MATRIX["int8"].grad_compression == "int8"
    assert L.SCENARIOS == ("straight", "resume")


def test_chain_detects_real_divergence():
    a = L.run_straight(L.MATRIX["base"], device="cpu")
    b = L.run_straight(L.LifecycleConfig(seed=1), device="cpu")
    assert a != b
    assert a.first_divergence(b) == 1


def test_run_to_run_bitwise_stable():
    lc = L.MATRIX["int8"]
    assert L.run_straight(lc, device="cpu") == L.run_straight(lc,
                                                              device="cpu")


@pytest.mark.parametrize("cell", ["base", "packed"])
def test_token_stream_digest_invariant_to_host_split(cell):
    lc = L.cell_config(cell)
    one = L.stream_chain(lc, host_count=1)
    assert one == L.stream_chain(lc, host_count=2)
    assert one == L.stream_chain(lc, host_count=4)
    digests = [d for _, d in one.records]
    assert len(set(digests)) == len(digests)   # every step draws fresh data


@pytest.mark.parametrize("call,item", [
    (lambda: L.run_train_serve_parity(archs=("whisper-base",),
                                      device="cpu"), "A8"),
    (lambda: L.run_cell("base", scenarios=("straight", "elastic"),
                        device="cpu"), "A9"),
    (lambda: L.run_elastic_reshard(L.MATRIX["base"], "d", 2), "A9"),
])
def test_unported_cells_and_scenarios_raise(call, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        call()


def test_parity_cell_refuses_moe_as_the_reference_does():
    """An MoE arch has no paged path: the parity cell raises the paged
    engine's refusal, as the reference's engine refuses it."""
    from repro.verify import lifecycle as JL
    with pytest.raises(AssertionError, match="attention-only"):
        JL.run_train_serve_parity(archs=("phi3.5-moe-42b-a6.6b",))
    with pytest.raises(NotImplementedError,
                       match="MoE capacity routing is batch-coupled"):
        L.run_train_serve_parity(archs=("phi3.5-moe-42b-a6.6b",),
                                 device="cpu")


def test_parity_cell_refuses_jamba_with_the_paged_reason():
    """Jamba is ported but has no paged path (its SSM states are unpaged):
    the parity cell raises the paged engine's refusal, not ROADMAP A8, as
    the reference's engine refuses it."""
    from repro.verify import lifecycle as JL
    with pytest.raises(AssertionError, match="attention-only"):
        JL.run_train_serve_parity(archs=("jamba-1.5-large-398b",))
    with pytest.raises(NotImplementedError, match="SSM states are unpaged"):
        L.run_train_serve_parity(archs=("jamba-1.5-large-398b",),
                                 device="cpu")


def test_parity_cell_refuses_xlstm_with_the_paged_reason():
    """xLSTM is ported but has no paged path (its states are unpaged): the
    parity cell raises the paged engine's refusal, not ROADMAP A8, as the
    reference's engine refuses it."""
    from repro.verify import lifecycle as JL
    with pytest.raises(AssertionError, match="attention-only"):
        JL.run_train_serve_parity(archs=("xlstm-350m",))
    with pytest.raises(NotImplementedError, match="SSM states are unpaged"):
        L.run_train_serve_parity(archs=("xlstm-350m",), device="cpu")


def test_run_cell_report_and_cli(tmp_path, capsys):
    report = L.run_cell("base", device="cpu")
    assert report["conformant"] is True
    assert set(report["heads"]) == {"straight", "resume"}
    assert report["first_divergence"] == {}
    json.dumps(report)
    out = tmp_path / "conformance.json"
    assert L.main(["--cells", "base,int8", "--device", "cpu", "--out",
                   str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["conformant"] and [c["cell"] for c in doc["cells"]] == [
        "base", "int8"]
    assert capsys.readouterr().out.strip().splitlines()[-1] == "conformant"


# ------------------------------------------------------ the operator path
BASE = ["--reduced", "--device", "cpu", "--steps", "4", "--batch", "2",
        "--seq", "64", "--log-every", "1", "--verify"]


def _launch(args):
    # the launcher's CPU reductions split by torch's intra-op threads, so a
    # subprocess compared with an in-process run gets this process's count
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                          + args, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)


def test_launcher_kill_and_resume_gives_the_straight_chain(tmp_path, capsys):
    straight = tlaunch.main(BASE)
    d = str(tmp_path / "ckpt")
    flags = BASE + ["--ckpt-dir", d, "--ckpt-every", "1", "--verify-out",
                    str(tmp_path / "chain.json")]
    b = _launch(flags + ["--die-at-step", "2"])
    assert b.returncode == 17, b.stdout + b.stderr
    assert "simulated failure at step 2" in b.stdout
    assert 1 in L.C.available_steps(d)
    partial = DigestChain.from_json((tmp_path / "chain.json").read_text())
    assert [s for s, _ in partial.records] == [1, 2]
    c = _launch(flags + ["--resume"])
    assert c.returncode == 0, c.stdout + c.stderr
    summary = json.loads(c.stdout.strip().splitlines()[-1])
    k = summary["start_step"]
    assert k in (1, 2) and f"resumed from step {k}" in c.stdout
    assert len(summary["step_ms"]) == 4 - k
    assert summary["digest_chain_head"] == straight["digest_chain_head"]
    assert summary["final_loss"] == straight["final_loss"]
    assert [e["step"] for e in summary["ckpt"]] == list(range(k + 1, 5))


def test_launcher_resume_flag_needs_a_checkpoint_dir():
    with pytest.raises(SystemExit):
        tlaunch.configure(BASE + ["--resume"])


def test_failures_harness(capsys):
    """Killed at the top of step 4 (from 0): step 2's save was joined before
    step 4's began, so run C resumes from 2 or, if step 4's save landed, 4."""
    out = failures.main(["--device", "cpu", "--steps", "5", "--die-at", "4",
                         "--ckpt-every", "2", "--batch", "2", "--seq", "64"])
    assert out["a"]["digest_chain_head"] == out["c"]["digest_chain_head"]
    assert out["c"]["start_step"] in (2, 4)
    assert "PASSED" in capsys.readouterr().out
