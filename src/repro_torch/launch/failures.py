"""Fault-tolerance harness: failure injection → restart → bitwise verification.

    PYTHONPATH=src python -m repro_torch.launch.failures --device cpu

Port of ``repro.launch.failures``. Protocol:
  1. run A: train N steps uninterrupted (``launch.train``, in a subprocess);
  2. run B: the same run, hard-killed (``os._exit(17)``) at step k, after its
     last checkpoint — a node failure with an async save possibly in flight;
  3. run C: restart with ``--resume`` from the latest durable checkpoint;
  4. C's final loss and digest-chain head must equal A's bit for bit
     (stateless data sampler, full optimizer state, fixed reduction orders).

The runs execute ``python -m repro_torch.launch.train`` from the repository
root found from this file, with ``src`` on ``PYTHONPATH``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def run_train(args_list, check=True):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                       + args_list, capture_output=True, text=True, env=env,
                       cwd=ROOT)
    if check and r.returncode != 0:
        raise RuntimeError(f"train failed rc={r.returncode}:\n{r.stdout}\n"
                           f"{r.stderr}")
    return r


def summary(stdout: str) -> dict:
    """The launcher's last-line summary JSON."""
    for line in reversed(stdout.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise ValueError(f"no summary in output:\n{stdout}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--die-at", type=int, default=22)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (default; the runs raise without a card) or "
                         "cpu")
    args = ap.parse_args(argv)

    base = ["--arch", args.arch, "--reduced", "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--ckpt-every", str(args.ckpt_every), "--log-every", "5",
            "--verify"]
    if args.device:
        base += ["--device", args.device]
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        print("run A: uninterrupted", flush=True)
        a = summary(run_train(base + ["--ckpt-dir", d1]).stdout)

        print(f"run B: hard kill at step {args.die_at}", flush=True)
        b = run_train(base + ["--ckpt-dir", d2, "--die-at-step",
                              str(args.die_at)], check=False)
        if b.returncode != 17:
            raise AssertionError(f"expected the simulated-failure exit 17, "
                                 f"got {b.returncode}:\n{b.stdout}\n"
                                 f"{b.stderr}")

        print("run C: restart --resume from the latest checkpoint",
              flush=True)
        c = summary(run_train(base + ["--ckpt-dir", d2, "--resume"]).stdout)

    print(f"loss A={a['final_loss']!r}  C={c['final_loss']!r}; chain head "
          f"A={a['digest_chain_head'][:16]}  C={c['digest_chain_head'][:16]} "
          f"(C resumed from step {c['start_step']})")
    if (a["final_loss"] != c["final_loss"]
            or a["digest_chain_head"] != c["digest_chain_head"]):
        raise AssertionError("restart is not bitwise-identical")
    print("fault-tolerance check PASSED: kill → restore → bitwise-identical "
          "loss and digest chain")
    return dict(a=a, c=c)


if __name__ == "__main__":
    main()
