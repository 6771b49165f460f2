"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. build   — compile every CUDA source of the port with nvcc, in parallel,
               and report the registers, spills and shared memory of each
               forward and backward kernel instantiation (``[ptxas]``
               lines); the library's shared memory per head dim must be the
               host's budget (``flash_fwd.fwd_smem_bytes``);
  2. device  — the card's name and power limit (nvidia-smi);
  3. kernels — hold each kernel against its plain PyTorch version on the
               card: the causal and full-mask forwards (with the edge cases
               one tile, seq_k != seq_q, GQA 32/8 at D=128, D=32); 20
               repetitions of each forward mode bitwise identical, and each
               sequence of a batch-4 causal launch equal bit for bit to the
               sequence launched alone; and for every
               backward schedule (fa3, descending, shift full; fa3,
               descending, symmetric_shift causal) the worker-parallel
               backward + ordered fold; the serialized backward must equal
               worker + fold bit for bit, and 20 repetitions of the worker
               backward must be bitwise identical. Then the block-sparse
               masks (sliding window, prefix-LM, documents, streaming,
               causal ∧ sink at S=1024; bf16 and fp32; GQA 32/32 and 32/8):
               the masked forward and both masked backwards against their
               plain versions, serialized ≡ worker + fold bit for bit, KV
               rows no task visits exactly 0, and 20 bitwise-identical
               repetitions of the window's worker backward. Then the
               continuous engine's kernels: the paged attention (decode
               (4, 1), prefill (1, 32), a 1024-token window, segment ids,
               GQA 32/8; bf16 and fp32) against its plain version, with a
               permuted page table, trailing NaN pages, rows launched alone
               and 20 repetitions bitwise equal; the GEMM (plain and
               canonical, shard widths 64 and 176, StableLM's widths) and the
               row norm (d = 2048, 5120, 8192) and log-softmax (V = 100352,
               131072, 152064, 1000, 3089; rows with ties, +-inf, -1e30 and
               NaNs) against theirs, each row bitwise the same at M = 1, 3,
               4, 32, 64; every paged, GEMM and row launch of these checks
               bitwise equal to the kernel's first design
               (``csrc/{paged_attn,gemm,rows}_v1.cu``; the rows through
               integer views, so NaNs compare) on the same inputs; and a
               printed finding: whether
               torch.matmul, F.layer_norm and torch.log_softmax give rows the
               same bits at M = 1, 4, 32 on this card; and the state
               fingerprint (``csrc/fingerprint.cu``) equal to its plain
               version as uint32s on leaves of every covered dtype (0-dim,
               1, 7, 1000, 2^20+3 elements, aligned and not) and leaf by
               leaf on the full-width train state (~16 GB), where a
               one-bit flip and a swap must each change it, timed there;
               the selective scan (``csrc/selective_scan.cu``: forward,
               backward, fold; ``[kernel-check] scan``) against its plain
               version's outputs and autograd grads at Jamba's layer
               (Din=16384, the train slice's S=4096 in 8 chunks of 512,
               bf16 and fp32), two ragged small shapes
               and the serve prefill (B=4, S=512), 10 repetitions of each
               kernel bitwise, the fold bitwise its plain version,
               prefill then one-step decodes equal to the full pass and the
               decode step against plain; at each of those cases, the split
               and the decode the kernels also against their first design
               (``csrc/selective_scan_v1.cu``; ``[kernel-check] scan v1``):
               ``h_last`` and ``h_chk`` bitwise, y and every gradient
               within ``SCAN_TOL``;
               the xLSTM kernels (``[kernel-check] xlstm``:
               ``csrc/mlstm.cu``'s parallel form and recurrence,
               ``csrc/slstm.cu``) against their plain versions within
               ``XLSTM_TOL`` at xLSTM-350M's 4 heads of 256 (the serve
               slice's B=4, S=512, and S=2048 for the parallel form), a
               ragged S, fp32 and hd=32; each recurrence also at the decode
               step (S=1) from the state its prefill leaves; 10 repetitions
               of each bitwise, and each recurrence split at 3/5 of S and at
               S-1 bitwise one launch; at each recurrence case and decode
               step both recurrences also against their first designs
               (``csrc/mlstm_v1.cu``, ``csrc/slstm_v1.cu``; ``[kernel-check]
               xlstm v1``): every output and state leaf ``torch.equal``;
               at each parallel-form case the parallel form against its
               first design (``csrc/mlstm_parallel_v1.cu``): fp32
               ``torch.equal``, bf16 within ``XLSTM_TOL``; the two
               backward kernels (``csrc/mlstm_parallel_bwd.cu``,
               ``csrc/slstm_bwd.cu``) at xLSTM-350M's train shape (B=4,
               S=1024, 4 heads of 256) and at (2, 64, 2 heads of 32), bf16
               and fp32 operands, against their plain backwards and
               against autograd of the plain forwards within
               ``XLSTM_TOL``, 10 repetitions bitwise, the mLSTM's (from
               the forward's row statistics, whose ``out`` is bitwise the
               forward's without them, whose m_i and ties are the plain
               forward's and v1's) against its first design
               (``csrc/mlstm_parallel_bwd_v1.cu``): fp32 every gradient
               ``torch.equal``, bf16 within ``XLSTM_TOL``; and the sLSTM
               forward with its states kept bitwise its first design's
               h_all and state;
               and the GQA groups of this slice's models (``[kernel-check]
               gqa``: 40/8 and 48/8 at D=128, S=1024): the causal forward,
               the worker backward with its dQ and dK/dV group folds (each
               fold bitwise its plain version, ``flash_bwd`` twice
               bitwise), and the paged attention at 48/8 (decode and a
               prefill chunk) against plain, first design, rows alone and
               20 repetitions; the GEMM and row checks include
               Nemotron-4-15B's widths (LM head N=256000, w_down as 48
               shards of 512, d=6144, V=256000);
  4. serve   — serve StableLM-1.6B at full width and depth in bf16 (random
               weights, seed 0) through the static engine: greedy, batch 4,
               prompt 512, 32 new tokens. Checks that the prefill launched the
               attention kernel once per layer, that tokens are in range and
               bitwise equal across two runs, and that the prefill logits match
               the plain attention's on the same weights;
     serve-continuous — StableLM-1.6B at full width and depth through
               ``launch.serve.main --engine continuous``: 8 requests of
               64-512 prompt tokens, 32 greedy tokens each, 4 slots, 16-token
               pages, 32-token chunks; the run's launches and one decode
               step's (24 paged attentions, 169 GEMMs, 49 norms, 1
               log-softmax) equal to the code's count; prefill chunk ms,
               TTFT, decode step ms and tok/s, peak memory; one profiled
               decode step's device ms, host ms, busy share and the GEMM's
               and paged attention's device ms, beside the same step with
               the kernels' first designs;
     serve-invariance — the same requests: tokens and logprobs bitwise
               equal across a second run, request subsets, 2 slots, chunks
               16/64, a tight pool (page reuse), and seeded sampling across
               subsets and slots; prefill logits bitwise across chunks and
               within 0.1 of the plain attention's;
     serve-spec — the same traffic with speculative decoding, 4 drafts a
               round: self-draft greedy (``launch.serve --spec-k 4``),
               self-draft sampled (temperature 0.7, top-k 20, seed 11)
               against a plain sampled run, and a separate full-width
               drafter (``--draft-model stablelm-1.6b``, weights from seed
               1, which rejects nearly every draft): tokens and logprobs
               bitwise the plain runs', launches as the rounds, draft steps
               and prefill chunks predict; rounds, acceptance, tokens a
               round, host ms a round, decode tok/s;
     serve-chaos — the same traffic under faults: ``--chaos 1`` (seeded
               pool exhaustion, slot revocations, decode stalls), and a
               crash at engine step 7 with a snapshot every 6 steps (on
               tmpfs) restored through ``ContinuousEngine.from_snapshot``,
               plain (the first 4 requests) and with ``spec_k=4`` (all 8):
               every request bitwise the
               fault-free run's, the engine drained, launches as predicted
               (the recompute-restores' chunks included); the plan key,
               faults landed, preemptions, landing digest, the snapshot's
               bytes and its save and restore seconds;
     serve-obs — the same traffic with ``--track`` and ``--trace-out``,
               plain and ``--spec-k 4``: bitwise the unarmed runs, launches
               and span counts as the engine's telemetry predicts, a valid
               trace with modeled and achieved lanes; RunReport's TTFT and
               per-token percentiles beside the engine's TTFT;
     serve-moe — the static engine as in phase 4 at full width for
               Phi-3.5-MoE (4 of 32 layers) and Llama-4-Scout (1 of 48),
               batch 4, prompt 512, 32 greedy tokens: bitwise across two
               runs, one causal forward a layer, prefill logits against
               the plain attention's with the router's choices pinned to
               the kernel run's (each row's relative error); ``launch.serve --engine continuous``
               with Phi-3.5-MoE must raise the paged engine's refusal;
     serve-nemotron — Nemotron-4-15B at full width (2 of 32 layers;
               squared ReLU, LayerNorm, half rotary, 48/8 heads, vocab
               256000) through the continuous engine over the
               serve-continuous traffic at 4 and at 2 slots: tokens and
               logprobs bitwise equal, launches as the engine's work
               predicts; decode step ms and tok/s;
     serve-jamba — the static engine as in phase 4 for Jamba-1.5-Large at
               full width cut to its period's first five layers (mamba,
               mamba_moe, mamba, mamba_moe, attn; ~24 B parameters): bitwise
               across two runs, one causal forward for the attention layer
               and one scan forward a Mamba layer in the prefill and in each
               decode step, prefill logits against the plain attention and
               plain scan with the router's choices pinned;
               ``launch.serve --engine continuous`` with Jamba must raise
               the paged engine's refusal (SSM states are unpaged);
     serve-xlstm — the static engine as in phase 4 for xLSTM-350M at full
               width and depth (24 layers: 21 mLSTM, 3 sLSTM; ~0.23 B
               parameters): bitwise across two runs, the mLSTM recurrence
               and the sLSTM once a layer in the prefill and in each decode
               step, prefill logits against the plain mixers' (a reading:
               24 bf16 layers amplify a flipped rounding); then one
               ``forward`` at (4, 512) through the parallel kernel (its
               launches and ms), the bf16 model cut to one mLSTM and one
               sLSTM layer (``XLSTM_CUT``) and the fp32 model at full
               width and depth: prefill and forward logits against the
               plain mixers' within ``LOGITS_ATOL`` and
               ``XLSTM_FP32_LOGITS_ATOL``; ``forward`` against prefill +
               decode at full width (a reading) and at the reduced config
               within ``XLSTM_IDENTITY_ATOL`` (fp32 1e-4, bf16 0.1; the
               reference's allclose(5e-2) beside it);
               ``launch.serve --engine continuous`` with xLSTM must raise
               the paged engine's refusal;
  5. train   — train StableLM-1.6B at full width cut to 12 of its 24
               layers (bf16, AdamW, remat, causal, B=4, S=1024, 3 steps, warmup 1, ``--tune sim``,
               which prints the tuner's pick and changes nothing else) through
               the DASH kernels, twice from seed 0 under
               ``torch.use_deterministic_algorithms``: equal state digests
               after every step, weights that move, the launch counts remat
               predicts (and one fingerprint a step), step 1 against the
               plain attention's step, then one profiled step. Run 1 is
               tracked (``--track``, ``--trace-out``), run 2 against run 1's
               file (``--track-reference``): ``fingerprint_ok`` in both,
               equal fingerprint streams, a clean ``diff_runs``, a valid
               trace with a data, step and digest span a step; each step's
               ``utilization_vs_modeled`` printed (``[obs]``). The
               train-window and dash-paper phases run the same way;
  6. train-resume — the train phase's flags (full width, 12 layers) as two
               launcher subprocesses: run B with a checkpoint after every
               step (in a temporary directory on tmpfs, the newest one
               kept), killed with ``os._exit(17)`` at the top of step 2
               (step 2's async save possibly in flight), run C
               ``--resume``d from the latest durable checkpoint, saving
               none of its own; run C's digest chain head must
               equal the train phase's first run's, it must resume from step
               1 or 2, and each of its steps must launch 24 causal forwards,
               12 worker backwards and 12 folds. Prints the checkpoint's
               bytes, save and restore seconds, the directory's filesystem
               and free bytes;
  7. lifecycle — every cell of ``verify.lifecycle`` (base, mb4, int8, remat
               "dots", gqa, moe, bf16opt, plus adafactor and packed
               documents) on 2 layers, base at full width, the others at
               the reference's reduced widths, B=2 (mb4: 4), S=1024, 3
               steps, crash at 2, on the DASH kernels: straight ≡
               crash/resume bit for bit, with the launches each cell
               predicts (3 folds a layer under GQA); then the
               train_serve_parity cell at full width cut to 2 layers for
               StableLM-1.6B, Qwen1.5-110B and Mistral-NeMo-12B: the
               canonical forward's logits digest equal to the engine's;
     chaos-matrix — ``faults.conformance.run_matrix`` (its 11 cells:
               unarmed, pool exhaustion, slot revocation, decode stall,
               deadlines, load shedding, crash/restore, checkpoint IO retry,
               speculation under revocations, two seeded mixes) at full
               width cut to 2 layers: every cell ok, launches equal to what
               its engines dispatched;
     train-chaos — ``launch.train`` at full width cut to 2 layers (B=2,
               S=1024, 3 steps) with ``--chaos 3`` (seeded transient
               checkpoint IO failures) and a checkpoint every step, against the same steps unarmed and
               without checkpoints: equal digest chains, every planned
               failure landed within the retry budget, 4/2/2 launches a
               step;
  8. ops     — ``dash_attention`` forward and backward at the training
               shape, full mask (schedule ``shift``) and serialized, against
               the plain op, counting the kernels each path launches; and a
               1024-token sliding window at the windowed training shape
               (B=1, H=32, S=4096, D=64; worker-parallel and serialized)
               against the plain query-chunked masked op, which must differ
               from the causal op beyond the window;
  9. slice-window — the serving slice with ``attn_window=1024``: batch 2,
               prompt 2048, 32 new tokens; the prefill must launch the
               block-sparse forward once per layer;
 10. train-window — the train phase again with ``--attn-window 1024`` at
               B=1, S=4096, 6 of the 24 layers (the launcher's flags): 12
               block-sparse forwards, 6 masked worker backwards and 6
               folds a step, no causal
               forward, step 1 and every layer's attention grads against the
               plain masked, query-chunked attention's step, then one
               profiled step;
     train-moe — the train phase for Phi-3.5-MoE at full width cut to 1 of
               its 32 layers (16 experts top-2, einsum dispatch; B=4,
               S=1024, 3 steps, ``--verify``), twice: equal digest chains
               and fingerprints, per layer 2 causal forwards, 1 worker
               backward and 3 folds a step, step 1 against the plain
               attention's (the router's choices pinned to the kernel
               run's), ce and aux; then one full-width expert layer's
               gather dispatch against the einsum one on a (4, 1024)
               batch at capacity factors 1.25 and 0.5: in fp32 within
               tests/test_moe.py's tolerance, in bf16 within 3 bf16 ulps
               of the largest expert output; in bf16 each twice bitwise;
     train-jamba — the train phase for Jamba-1.5-Large at full width cut to
               its period's layers 0 and 4 (mamba, attn; ``--layers 0,4``,
               B=1, S=4096, 3 steps, ``--verify``), twice: equal digest
               chains and fingerprints; a step launches the scan forward
               twice and its backward and fold once, the flash kernels for
               the attention layer (2 forwards, 1 worker backward, 3
               folds); step 1 at S=1024 against the plain attention and
               plain scan's;
     train-xlstm — the train phase for xLSTM-350M at full width and depth
               (24 layers: 21 mLSTM, 3 sLSTM; B=4, S=1024, 3 steps,
               ``--verify``), twice: equal digest chains and fingerprints;
               a step launches per mLSTM layer the parallel form's forward
               twice and its backward's three passes once, per sLSTM layer
               its forward twice and its backward once, one fingerprint;
               step 1 against the plain mixers (the bf16 model at 24
               layers a reading; gated: the fp32 model at 24 layers, loss,
               grad norm and every mixer leaf's grads per layer, and the
               bf16 model at layers 0 and 7);
 11. tune    — the tuner (``repro_torch.tune``) in measure mode over every
               legal candidate (schedule family x worker-parallel or
               serialized), the runner one synchronized ``dash_attention``
               fwd + bwd in bf16: at the training slice's shape, the paper's
               §4.1 shapes (16384 tokens, hidden 2048 as 32 heads of 64 or 16
               of 128, S = 1024, 4096, 16384, full and causal) and the
               1024-token window at S=4096; one line per candidate (modeled
               makespan x B·H, measured host and device ms, their ratio) and
               whether the measured winner is the modeled one. Checks: a
               second call is a cache hit on the same candidate;
               ``dash_attention(tune=True)`` equals the hand-picked call bit
               for bit; ``cached_block_schedule(tune=True)`` is the picked
               placement's schedule and the kernels run on it equal the op; a
               fresh process with an empty cache makes this process's sim
               picks; ``kernels/smem.py``'s footprints equal the libraries'
               shared memory for every (head dim, dtype); every kernel of the
               path launched. Then ``launch/train.py --arch dash-paper --tune
               measure --batch 16 --seq 1024 --steps 3`` as the train phase
               runs it, twice: equal digest chains and the launches one layer
               predicts;
 12. timing  — each kernel at its training slice's attention shape beside
               its plain version, the PyTorch library call for the same
               function where there is one (for a mask, SDPA with the dense
               boolean mask; for the fold, ``torch.sum`` over the partials
               with the unvisited tiles zeroed), and its bound; and the four
               serving kernels at the serve shapes (paged attention beside
               SDPA over the gathered K/V, the GEMM beside torch.matmul, the
               norm beside F.layer_norm, the log-softmax beside
               torch.log_softmax), each serving kernel also beside its
               first design in turns (``v1_ms``), bitwise equal to it at
               every timed shape (the norm also at a prefill chunk's M = 32,
               the log-softmax at M = 1); the selective scan's forward and
               backward at the train shape, its forward at the serve prefill
               (4, 512) and the decode step (4, 1), each beside its first
               design in turns (``v1_ms``), with ptxas' registers and spills
               (a spill fails the run); the three xLSTM kernels at the
               serve slice's shapes (the recurrences also at the decode
               step) beside their plain versions and bounds, their
               launches those of ``[serve-xlstm]``, each beside its first
               design in turns (``v1_ms``; the recurrences also at their
               decode steps) with the clock64() share of each phase of a
               recurrence's step (``[phases]``), the parallel form's wrapper
               split into its launch and its ``F = cumsum(fg)``
               (``launch_ms``, ``cumsum_ms``); the two xLSTM backward
               kernels at ``[train-xlstm]``'s shape beside their plain
               backwards and bounds, with that cell's launches a step;
               the fingerprint's entry
               is timed in its kernel check, at the full-width train
               state.
The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script exits
non-zero and prints no result; so does a machine without CUDA.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# cuBLAS reads this when the card's first handle is made: set it before
# torch touches the card, so the train phase's GEMMs are deterministic
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.ckpt import checkpoint as CK  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.schedules import cached_schedule  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode as DEC  # noqa: E402
from repro_torch.kernels import gemm as GEMM  # noqa: E402
from repro_torch.kernels import rows as ROWS  # noqa: E402
from repro_torch.kernels import flash_bwd as FB  # noqa: E402
from repro_torch.kernels import flash_fwd as FF  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch import masks as M  # noqa: E402
from repro_torch.models.module import (count_params, init_tree,  # noqa: E402
                                       set_path, tree_paths)
from repro_torch.serve.engine import (ContinuousEngine, Engine,  # noqa: E402
                                      SampleConfig)
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch import tune as TUNE  # noqa: E402
from repro_torch.kernels import smem as SMEM  # noqa: E402
from repro_torch.tune import measure as TUNE_MEASURE  # noqa: E402
from repro_torch.verify import lifecycle as LC  # noqa: E402
from repro_torch.faults import (EngineCrash, Fault, FaultPlan,  # noqa: E402
                                Injector)
from repro_torch.faults import conformance as CF  # noqa: E402
from repro_torch.kernels import fingerprint as FPK  # noqa: E402
from repro_torch.kernels import scan as SCAN  # noqa: E402
from repro_torch.kernels import mlstm as MLSTM  # noqa: E402
from repro_torch.kernels import slstm as SLSTM  # noqa: E402
from repro_torch import obs as OBS  # noqa: E402
from repro_torch.obs import export as OBS_EX  # noqa: E402
from repro_torch.verify import digest as DG  # noqa: E402

# H100 SXM, NVIDIA's data sheet (dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# exponentials a second: the special function units (MUFU.EX2) take 16 a
# clock on each of the 132 SMs of sm_90, at the 1.98 GHz boost clock
SFU_EXP_PER_S = 132 * 16 * 1.98e9

# |out - plain| <= tol + tol * |plain| (the reference's kernel tolerances)
OUT_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
LSE_RTOL = 1e-3                                         # |Δlse| / max(|lse|, 1)
# prefill logits (fp32 head over bf16 activations), cuda vs plain attention:
# the two round the attention output to bf16 from differently ordered fp32
# sums, and one-ulp differences grow through 24 layers
LOGITS_ATOL = 0.1
# over an MoE model (the router's choices pinned, _PinnedRouting) each
# prompt row's logits are held by their relative error norm
# |cuda - plain| / |plain| instead: the absolute difference grows with
# depth whatever the FFN (scripts/moe_logits_noise.py over all 2048 rows of
# B=4 x S=512 on an H100 80GB HBM3 at 700 W: Mistral-NeMo's dense layers
# read max 0.084 at 2 layers and 0.134 at 4; Phi-3.5-MoE 0.063 / 0.124 /
# 0.218 at 1 / 2 / 4 layers), while the relative norm stays small
# (Phi-3.5-MoE at 4 layers: at most 0.036; Llama-4-Scout at 1: 0.0075) and
# reads ~1 for a wrong attention or a flipped route
MOE_LOGITS_REL = 5e-2

# the reference's grad tolerances (tests/test_kernels.py:59)
GRAD_TOL = {torch.bfloat16: dict(atol=0.1, rtol=5e-2),
            torch.float32: dict(atol=2e-5, rtol=2e-5)}
# train step 1, DASH kernels vs the plain attention on the same weights and
# batch (bf16 activations, 24 layers): the two round the attention output to
# bf16 from differently ordered fp32 sums, and one-ulp differences grow
# through the layers. Measured on an H100 80GB HBM3 at 700 W: loss rel. diff
# 2.2e-5, grad-norm rel. diff 3.1e-4; each limit is ten times its reading.
# The loss is the forward's check; the grad norm over 1.6e9 grads is
# dominated by the LM head and embedding, so the backward kernels are held
# per layer too: |g_cuda - g_plain| / |g_plain| of each layer's wq (through
# dQ), wk (dK), wv (dV) and wo. A wrong or swapped dQ/dK/dV reads ~1 there.
LOSS_RTOL = 2e-4
GNORM_RTOL = 3e-3
ATTN_GRAD_RTOL = 5e-2
ATTN_WEIGHTS = ("wq", "wk", "wv", "wo")

# (name, batch, heads, kv heads, seq, head_dim, dtype)
KERNEL_CASES = [
    ("slice", 4, 32, 32, 512, 64, torch.bfloat16),
    ("gqa", 1, 32, 8, 1024, 128, torch.bfloat16),
    ("fp32", 2, 8, 8, 384, 64, torch.float32),
    ("reduced", 2, 4, 4, 256, 32, torch.bfloat16),
]
# the training slice's attention shape first
TRAIN_CASES = [("train", 4, 32, 32, 1024, 64, torch.bfloat16)] + KERNEL_CASES[1:]
# forward edge cases (the last field, where present, is seq_k; full mask
# only): one 128-row tile, seq_k != seq_q, GQA 32/8 at D=128 with two
# batches, D=32
FWD_EDGE_CASES = [
    ("one_tile", 2, 8, 8, 128, 64, torch.bfloat16),
    ("gqa_d128", 2, 32, 8, 512, 128, torch.bfloat16),
    ("d32", 2, 8, 8, 512, 32, torch.bfloat16),
]
FULL_EDGE_CASES = FWD_EDGE_CASES + [
    ("seq_k_1024", 2, 8, 8, 512, 64, torch.bfloat16, 1024)]
BWD_SCHEDULES = [("fa3", False), ("descending", False), ("shift", False),
                 ("fa3", True), ("descending", True), ("symmetric_shift", True)]
SLICE = dict(arch="stablelm-1.6b", batch=4, prompt=512, gen=32, window=0)
SLICE_WINDOW = dict(arch="stablelm-1.6b", batch=2, prompt=2048, gen=32,
                    window=1024)
# the train launcher's flags for the train phase (3 steps, warmup 1 so the
# weights move; cut to 12 of the 24 layers) and for the windowed one (cut
# to 6) for the run's time limit: the host's digests and checkpoints of
# the state take most of these phases' time
TRAIN_ARGV = ["--arch", "stablelm-1.6b", "--layers", "12", "--batch", "4",
              "--seq", "1024", "--steps", "3", "--warmup-steps", "1",
              "--seed", "0", "--log-every", "1", "--verify", "--tune", "sim"]
TRAIN_WINDOW_ARGV = ["--arch", "stablelm-1.6b", "--layers", "6", "--batch",
                     "1", "--seq", "4096", "--attn-window", "1024", "--steps",
                     "3", "--warmup-steps", "1", "--seed", "0", "--log-every",
                     "1", "--verify"]
# [train-moe]: Phi-3.5-MoE at its published widths (16 experts top-2,
# 32 heads over 8 KV heads), cut to 1 of its 32 layers (the run's time
# limit; 3 would not fit the card's 80 GB with bf16 params and fp32 AdamW
# moments), through the launcher as
# [train] runs it; then one full-width expert layer's gather dispatch
# against the einsum dispatch on a (B, S) batch of normal inputs at the
# capacity factors given (the config's, and one that drops tokens): in fp32
# within tests/test_moe.py's tolerance (dot association), in bf16 within
# MOE_BF16_ULPS
TRAIN_MOE_ARGV = ["--arch", "phi3.5-moe-42b-a6.6b", "--layers", "1",
                  "--batch", "4", "--seq", "1024", "--steps", "3",
                  "--warmup-steps", "1", "--seed", "0", "--log-every", "1",
                  "--verify"]
MOE_GATHER_SHAPE = (4, 1024)
MOE_GATHER_CAPACITY = (1.25, 0.5)
MOE_IMPL_TOL = dict(atol=2e-3, rtol=2e-2)
# the bf16 gather-vs-einsum limit, in bf16 ulps of the largest expert output
# (moe_bf16_gap says why)
MOE_BF16_ULPS = 3
# [serve-moe]: the static engine at full width with the [slice] traffic,
# Phi-3.5-MoE cut to 4 layers (~10.9 GB of bf16 weights) and Llama-4-Scout
# to 1 (~8.6 GB: its vocab-202752 embedding and head are half of it)
SERVE_MOE = [dict(SLICE, arch="phi3.5-moe-42b-a6.6b", layers=4),
             dict(SLICE, arch="llama4-scout-17b-a16e", layers=1)]
# [serve-jamba]: Jamba-1.5-Large at full width (d=8192, 64 heads over 8 KV
# heads of 128, 16 experts top-2, vocab 65536, NoPE attention), cut to its
# period's first five layers (mamba, mamba_moe, mamba, mamba_moe, attn:
# ~24 B parameters, ~48 GB of bf16; a whole period is ~45 B), through the
# static engine with the [slice] traffic
SERVE_JAMBA = dict(SLICE, arch="jamba-1.5-large-398b", layers="0,1,2,3,4")
# [train-jamba]: its period's layers 0 and 4 (mamba, attn: ~2.85 B
# parameters; one expert layer's train state alone would pass 200 GB) at
# full width, B=1, S=4096, through the launcher as [train] runs it; step 1
# held against the plain attention and plain scan at S=1024: at S=4096 the
# plain scan's autograd (~4 MB a step a Mamba layer, ~16 GB) would not fit
# beside the kernel run's 75 GB peak
TRAIN_JAMBA_ARGV = ["--arch", "jamba-1.5-large-398b", "--layers", "0,4",
                    "--batch", "1", "--seq", "4096", "--steps", "3",
                    "--warmup-steps", "1", "--seed", "0", "--log-every", "1",
                    "--verify"]
TRAIN_JAMBA_COMPARE_ARGV = [("1024" if a == "4096" else a)
                            for a in TRAIN_JAMBA_ARGV]
# [train-xlstm]: xLSTM-350M at full width and depth (24 layers: 21 mLSTM,
# 3 sLSTM; 0.234 B parameters), B=4, S=1024, through the launcher as
# [train] runs it, on the mLSTM parallel form's and the sLSTM's kernels
# and their backwards
TRAIN_XLSTM_ARGV = ["--arch", "xlstm-350m", "--batch", "4", "--seq", "1024",
                    "--steps", "3", "--warmup-steps", "1", "--seed", "0",
                    "--log-every", "1", "--verify"]
# its step 1 against the plain mixers': the loss and grad norm of the fp32
# model at 24 layers within LOSS_RTOL and GNORM_RTOL, and every mixer
# leaf's gradient, per layer, |g_kernels - g_plain| / |g_plain| within
# XLSTM_FP32_GRAD_RTOL in the fp32 model at its first period's 8 layers
# (7 mLSTM, 1 sLSTM; the kernels read 1.1e-4 there), while at 24 layers
# rounding alone moves the mLSTM leaves by up to 3.9e-2 (the plain mixers
# with q . k summed in reverse against the plain mixers, the control
# [train-xlstm-step1] prints at both depths; H100 80GB HBM3, 700 W), so
# the 24 layers' leaves are a reading beside that control (bf16 at
# XLSTM_CUT: ATTN_GRAD_RTOL; bf16 at 24 layers a reading, as the bf16
# model amplifies one flipped rounding with depth)
XLSTM_FP32_GRAD_RTOL = 1e-3
XLSTM_FP32_LEAF_LAYERS = "8"
# leaves whose exact gradient is 0, so that both runs' grads are rounding
# noise of their own: h is invariant under a uniform shift of the sLSTM's
# input gate (c and n scale alike; tests/test_torch_xlstm_train.py holds
# it in float64). Their difference is held over the norm of their layer's
# mixer grads instead
XLSTM_ZERO_GRAD_LEAVES = ("slstm/b_i",)
# [serve-nemotron]: Nemotron-4-15B at full width, cut to 2 layers (its
# vocab-256000 embedding and head are 3.15 B of its 3.9 B parameters),
# through the continuous engine over [serve-continuous]'s traffic, at these
# slot counts
NEMOTRON_LAYERS = 2
NEMOTRON_SLOTS = (4, 2)
# [train-resume]: TRAIN_ARGV killed with os._exit(17) at the top of step 2
# (from 0) after a checkpoint at every step (the newest kept), then resumed;
# each run a subprocess of the launcher with up to this many seconds
RESUME_DIE_AT = 2
RESUME_TIMEOUT_S = 600
# checkpoints go to RAM (tmpfs): a full-width checkpoint is ~20 GB, and the
# chip machine's disk takes ~45 GB of writes in one call, freed blocks
# included
CKPT_ROOT = "/dev/shm"
# [lifecycle]: the lifecycle cells on 2 layers (so that a layer mixed up
# across save and restore shows), B=2 (mb4: B=4, so each of its 4
# microbatches holds a row), S=1024, 3 steps, crash at 2, on the DASH
# kernels; the cells of LIFECYCLE_FULL_WIDTH at full width, the others at
# the reference's own reduced widths (their LifecycleConfig default): at
# full width a cell's time goes to the host's digests and its checkpoint of
# the vocab-100352 embedding and head (~35 s a cell), and [train-resume]
# carries the full-width crash/resume contract
LIFECYCLE = dict(steps=3, batch=2, seq=1024)
LIFECYCLE_OVERRIDES = (("n_layers", 2), ("attention_impl", "cuda"))
LIFECYCLE_CRASH_AT = 2
LIFECYCLE_FULL_WIDTH = ("base",)
# the windowed training slice's attention shape (B, H, Hk, S, D, dtype) and
# mask
WINDOW_CASE = ("train_window", 1, 32, 32, 4096, 64, torch.bfloat16)
WINDOW = M.SlidingWindow(1024)
# [serve-continuous]: StableLM-1.6B at full width and depth through the
# continuous engine (launch.serve --engine continuous): 8 requests, prompts
# of 64-512 tokens from the launcher's seeded draws, 32 greedy tokens each, 4
# slots, 1024 positions a slot; the launcher's 16-token pages and 32-token
# prefill chunks (min(32, prompt length))
SERVE_REQUESTS, SERVE_SLOTS, SERVE_GEN, SERVE_SEED = 8, 4, 32, 0
SERVE_MIN_PROMPT, SERVE_PROMPT = 64, 512
SERVE_PAGE, SERVE_CHUNK, SERVE_MAX_SEQ = 16, 32, 1024
SERVE_PAGES = SERVE_MAX_SEQ // SERVE_PAGE
SERVE_ARGV = ["--engine", "continuous", "--arch", "stablelm-1.6b",
              "--requests", str(SERVE_REQUESTS), "--slots", str(SERVE_SLOTS),
              "--min-prompt-len", str(SERVE_MIN_PROMPT), "--prompt-len",
              str(SERVE_PROMPT), "--gen", str(SERVE_GEN), "--max-seq",
              str(SERVE_MAX_SEQ), "--seed", str(SERVE_SEED)]
# [serve-continuous-profile]: the same profiled decode step with the GEMM
# and the paged attention of their first designs (csrc/*_v1.cu), measured
# by this script on an H100 80GB HBM3 at 700 W: device and traced wall ms,
# the busy share, the two kernels' device ms, an unprofiled step's median ms
FIRST_DESIGN_DECODE_STEP = dict(device_busy_ms=13.24, wall_ms_traced=52.41,
                                busy_share=0.253, gemm_ms=9.73,
                                paged_attention_ms=1.19, step_ms=20.29)
# unused pool pages beside the rows' pages in the paged-attention checks
PAGED_SPARE = 5
# [serve-spec] / [serve-chaos], on [serve-continuous]'s traffic: K drafts a
# round; the sampled run's config; the separate drafter (full width, its
# weights from seed 1); the seeded chaos plan; a crash at engine step 7
# with a snapshot every 6 steps (under CKPT_ROOT)
SPEC_K = 4
SPEC_SAMPLED = dict(temperature=0.7, top_k=20, seed=11)
SPEC_DRAFTER = "stablelm-1.6b"
CHAOS_SEED = 1
CRASH_AT, SNAPSHOT_EVERY = 7, 6
# the plain crash serves the first 4 requests (one wave, 31 engine steps,
# 5 snapshots of 1.6 GB); with spec_k=4 all 8 (2 waves of 7 rounds), so
# that the engine is still busy at step 7
CRASH_REQUESTS = {0: 4, SPEC_K: SERVE_REQUESTS}
# [chaos-matrix]: the 11 conformance cells at full width cut to 2 layers
CHAOS_MATRIX_OVERRIDES = (("n_layers", 2),)
# [train-chaos]: 2 full-width layers, B=2, S=1024, 3 steps through the
# train launcher, with --chaos 3 and a checkpoint every step, against the
# same steps unarmed and without checkpoints (each save of the 2-layer
# state, ~6.2 GB, takes ~10 s)
TRAIN_CHAOS_SEED = 3
TRAIN_CHAOS_ARGV = ["--arch", "stablelm-1.6b", "--layers", "2", "--batch",
                    "2", "--seq", "1024", "--steps", "3", "--ckpt-every", "1",
                    "--ckpt-keep", "1", "--verify", "--log-every", "1"]
# [kernel-check] fingerprint: element counts of the small leaves (the 0-dim
# leaf besides), each also as views 1 and 3 elements in (unaligned), and
# the state the full-width train step carries (StableLM-1.6B, AdamW)
FP_SIZES = (1, 7, 1000, (1 << 20) + 3)
# the achieved lane of a --trace-out: attention_timeline's warm-up and reps
TIMELINE_BWD_CALLS = 4
# the GEMM kernel's fp32 product vs its plain version: both sum the same
# exact products in fp32, in another order (up to 5632 terms of |x w| of a
# few 1e-2)
GEMM_TOL = 1e-4
# [tune]: the tuner's measure mode over every legal candidate, the runner
# one synchronized fwd + bwd of dash_attention (bf16) at the candidate's
# knobs: (label, batch, heads, seq, head_dim, causal, mask). The training
# slice's attention shape; the paper's §4.1 shapes (16384 tokens, hidden
# 2048: 32 heads of 64 or 16 of 128; S 1024, 4096, 16384; full and causal);
# the windowed slice's shape under the 1024-token window
PAPER_TOKENS, PAPER_HIDDEN = 16384, 2048
TUNE_GEOMETRIES = [("train", 4, 32, 1024, 64, True, None)] + [
    (f"paper_d{d}_s{s}_{'causal' if c else 'full'}", PAPER_TOKENS // s,
     PAPER_HIDDEN // d, s, d, c, None)
    for d in (64, 128) for s in (1024, 4096, 16384) for c in (False, True)
] + [("window", 1, 32, 4096, 64, False, WINDOW)]
# the sim-mode picks a fresh process makes with an empty cache
TUNE_SUBPROCESS = r"""
import json, sys
from repro_torch import masks as M
from repro_torch.tune import TuneCache, tune_attention
picks = [tune_attention(seq=1024, head_dim=64, dtype="bfloat16", causal=True,
                        n_heads=32, cache=TuneCache(sys.argv[1])),
         tune_attention(seq=4096, head_dim=64, dtype="bfloat16",
                        mask=M.SlidingWindow(1024), n_heads=32,
                        cache=TuneCache(sys.argv[1]))]
print(json.dumps([[p.key, p.candidate.key(), p.source] for p in picks]))
"""
# the launcher on the paper's config, tuned in measure mode, twice
PAPER_ARGV = ["--arch", "dash-paper", "--tune", "measure", "--batch", "16",
              "--seq", "1024", "--steps", "3", "--warmup-steps", "1",
              "--seed", "0", "--log-every", "1", "--verify"]
# the mask families of the kernel checks: the reference's
# (tests/test_mask_kernels.py:43-48) scaled from S=256 to S=1024, and
# causal ∧ sink, which leaves KV rows with no task
MASK_S = 1024
# [kernel-check] gqa: the GQA groups of Llama-4-Scout (40/8) and
# Nemotron-4-15B (48/8) at their head dim 128, S=1024 (name, B, H, Hk, S, D,
# dtype); Nemotron's paged attention (H, Hk, D)
GQA_CASES = [("llama4_40_8", 1, 40, 8, 1024, 128, torch.bfloat16),
             ("nemotron_48_8", 1, 48, 8, 1024, 128, torch.bfloat16)]
GQA_PAGED = (48, 8, 128)
MASK_CASES = [
    ("window", M.SlidingWindow(384)),
    ("prefix", M.PrefixLM(320)),
    ("document", M.Document.from_lengths((400, 624))),
    ("streaming", M.streaming_mask(256, 64)),
    ("sink", M.Causal() & M.Sink(64)),
]


def _qkv(b, h, hk, s, d, dtype, seed=0, sk=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b * h, s, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b * hk, sk or s, d), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    return q, k, v


def _ptxas_entries(ptxas, classify):
    """Per kernel instantiation in nvcc's ``-Xptxas -v`` log that
    ``classify(mangled name)`` names (a dict, else None): registers and
    spilled bytes added to that dict."""
    out, kernel = [], None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            kernel = classify(line.split("'")[1])
            if kernel is not None:
                out.append(kernel)
        elif kernel is not None and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill", line)
            kernel.update(spill_store_bytes=int(stores),
                          spill_load_bytes=int(loads))
        elif kernel is not None and "Used" in line and "registers" in line:
            kernel["registers"] = int(re.search(r"Used (\d+) registers",
                                                line).group(1))
    return out


def bwd_resources(ptxas):
    """Per backward kernel instantiation of ``csrc/flash_bwd.cu`` (each runs
    the task body ``play`` of its dtype): registers and spilled bytes, with
    the dynamic shared memory it launches with."""
    def classify(name):
        kind = next((k for k in ("worker_bwd", "serial_bwd") if k in name),
                    None)
        head_dim = re.search(r"ILi(\d+)E", name)
        if not (kind and head_dim):
            return None
        dtype = torch.bfloat16 if "bfloat16" in name else torch.float32
        d = int(head_dim.group(1))
        return dict(kernel=kind, head_dim=d, dtype=str(dtype).split(".")[-1],
                    smem_bytes=FB.smem_bytes(d, dtype))
    return _ptxas_entries(ptxas, classify)


FWD_MODES = {0: "full", 1: "causal", 2: "block_sparse"}


def fwd_resources(ptxas):
    """Per forward kernel instantiation of ``csrc/flash_fwd.cu`` (``fwd_bf16``
    and ``fwd_f32`` per head dim and mode): registers and spilled bytes,
    with the dynamic shared memory it launches with (bf16: the K/V ring of
    ``fwd_stages`` stages)."""
    def classify(name):
        found = re.search(r"fwd_(bf16|f32)ILi(\d+)ELi(\d)E", name)
        if found is None:
            return None
        bf16, d = found.group(1) == "bf16", int(found.group(2))
        kernel = dict(kernel="fwd_" + found.group(1), head_dim=d,
                      mode=FWD_MODES[int(found.group(3))],
                      dtype="bfloat16" if bf16 else "float32",
                      smem_bytes=FF.kernel_smem_bytes(
                          d, torch.bfloat16 if bf16 else torch.float32))
        if bf16:
            kernel["stages"] = FF.fwd_stages(d)
        return kernel
    return _ptxas_entries(ptxas, classify)


def scan_resources(built=None):
    """Per scan kernel instantiation (``csrc/selective_scan.cu`` and its
    first design ``selective_scan_v1.cu``; forward, backward, fold; fp32 and
    bf16 z): registers and spilled bytes, with the redesign's dynamic shared
    memory."""
    built = built or build.build(["selective_scan", "selective_scan_v1"])
    layout = SCAN.layout()
    out = []
    for source in ("selective_scan", "selective_scan_v1"):
        def classify(name, source=source):
            found = re.search(r"scan_(fwd|bwd|fold)_kernel", name)
            if found is None:
                return None
            kind = found.group(1)
            bf16 = "bfloat16" in name
            entry = dict(source=source, kernel=kind,
                         dtype="bfloat16" if bf16 else "float32")
            if source == "selective_scan" and kind != "fold":
                dt = "bf16" if bf16 else "fp32"
                entry.update(lanes=layout["lanes"], stages=layout[
                    "stages" if kind == "fwd" else f"bwd_stages_{dt}"],
                    threads=layout["threads"],
                    smem_bytes=layout[f"{kind}_smem_{dt}"])
            return entry
        out += _ptxas_entries(built[source]["ptxas"], classify)
    return out


# the builds beside build.SOURCES: the xLSTM recurrences with their
# clock64() stamps (time_xlstm's [phases])
STAMPED = (("mlstm", ("DASH_STAMPS",)), ("slstm", ("DASH_STAMPS",)))


def xlstm_resources(ptxas):
    """Per xLSTM kernel instantiation in an ``-Xptxas -v`` log
    (``csrc/mlstm.cu``'s parallel form and recurrence, ``csrc/slstm.cu``,
    the parallel form's backward passes ``mlstm_bwd_{rows,keys,queries}``
    and their first designs): head dim, rows of C a warp (the mLSTM
    recurrence's instantiations), registers and spilled bytes."""
    def classify(name):
        found = re.search(r"(mlstm_parallel|mlstm_recurrent|slstm|"
                          r"bwd_rows|bwd_keys|bwd_queries)_kernel", name)
        if found is None:
            return None
        dims = [int(x) for x in re.findall(r"Li(\d+)E", name)]
        kernel = found.group(1)
        entry = dict(kernel=f"mlstm_{kernel}" if kernel.startswith("bwd_")
                     else kernel,
                     dtype="bfloat16" if "bfloat16" in name else "float32",
                     head_dim=dims[0])
        if len(dims) > 1:
            entry["warp_rows"] = dims[1]
        return entry
    return _ptxas_entries(ptxas, classify)


def phase_build():
    t0 = time.perf_counter()
    variants = build.build_variants([(name, ()) for name in build.SOURCES]
                                    + list(STAMPED))
    built = {name: variants[(name, ())] for name in build.SOURCES}
    for (name, defines), info in variants.items():
        tag = "".join(f" -D{d}" for d in defines)
        print(f"[build] {name}{tag}: {info['path'].relative_to(ROOT)} "
              f"({info['seconds']:.1f}s)")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] {time.perf_counter() - t0:.1f}s in all", flush=True)
    # the slices launch the bf16, D = 64 instantiations
    kernels = (fwd_resources(built["flash_fwd"]["ptxas"])
               + bwd_resources(built["flash_bwd"]["ptxas"]))
    for k in kernels:
        k["launched_by_slices"] = (k["dtype"], k["head_dim"]) == (
            "bfloat16", 64)
        print("[ptxas] " + json.dumps(k), flush=True)
    for k in scan_resources(built):
        print("[ptxas] " + json.dumps(k), flush=True)
    for source in ("mlstm", "slstm", "mlstm_v1", "slstm_v1",
                   "mlstm_parallel_v1", "mlstm_parallel_bwd",
                   "mlstm_parallel_bwd_v1"):
        for k in xlstm_resources(built[source]["ptxas"]):
            print("[ptxas] " + json.dumps(dict(k, source=source)),
                  flush=True)
    budget = {d: (FF.kernel_smem_bytes(d, torch.bfloat16),
                  FF.fwd_smem_bytes(d, FF.fwd_stages(d)))
              for d in FF.HEAD_DIMS}
    if any(lib != host or lib > FF.SMEM_MAX for lib, host in budget.values()):
        raise AssertionError(f"bf16 forward shared memory, library vs host "
                             f"budget: {budget}")


def phase_device():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    print(line, flush=True)
    return line


def check_forward(causal, cases):
    """Each case: the causal or full-mask forward kernel vs its plain
    version on the same inputs on the card."""
    results, failed = [], []
    for name, b, h, hk, s, d, dtype, *sk in cases:
        q, k, v = _qkv(b, h, hk, s, d, dtype, seed=int(not causal),
                       sk=sk[0] if sk else None)
        scale = d ** -0.5
        out, lse = FF.flash_fwd_cuda(q, k, v, scale, h, hk, causal)
        ref_out, ref_lse = FF.flash_fwd_plain(q, k, v, scale, h, hk, causal)
        torch.cuda.synchronize()
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = ((lse - ref_lse).abs()
                   / ref_lse.abs().clamp_min(1.0)).max().item()
        tol = OUT_TOL[dtype]
        ok = (bool(torch.isfinite(out).all()) and err_lse <= LSE_RTOL
              and torch.allclose(out.float(), ref_out.float(), atol=tol,
                                 rtol=tol))
        results.append(dict(case=name, shape=[b, h, hk, s, d] + sk,
                            dtype=str(dtype).split(".")[-1],
                            max_abs_err_out=err_out, max_rel_err_lse=err_lse,
                            tol_out=OUT_TOL[dtype], tol_lse=LSE_RTOL, ok=ok))
        if not ok:
            failed.append(name)
    kind = "causal" if causal else "full-mask"
    print(f"[kernel-check] {kind} forward " + json.dumps(results), flush=True)
    if failed:
        raise AssertionError(f"{kind} forward disagrees with its plain "
                             f"version in cases {failed}")
    return results


def check_forward_bits():
    """20 repetitions of each forward mode (causal and full at the training
    slice's shape, block-sparse at the windowed one's) give out and lse
    identical bit for bit to the first launch; and each sequence of a
    batch-4 causal launch at the serving slice's shape equals, bit for bit,
    the same sequence launched alone (a tile's arithmetic does not depend on
    its batch neighbours: the serving contract)."""
    name, b, h, hk, s, d, dtype = TRAIN_CASES[0]
    q, k, v = _qkv(b, h, hk, s, d, dtype, seed=7)
    _, wb, wh, whk, ws, wd, wdtype = WINDOW_CASE
    wq, wk, wv = _qkv(wb, wh, whk, ws, wd, wdtype, seed=8)
    runs = dict(
        causal=lambda: FF.flash_fwd_cuda(q, k, v, d ** -0.5, h, hk, True),
        full=lambda: FF.flash_fwd_cuda(q, k, v, d ** -0.5, h, hk, False),
        block_sparse=lambda: FF.flash_fwd_mask_cuda(wq, wk, wv, wd ** -0.5,
                                                    wh, whk, WINDOW))
    reps = {}
    for mode, run in runs.items():
        out, lse = run()
        same = True
        for _ in range(20):
            again = run()
            same &= torch.equal(again[0], out) and torch.equal(again[1], lse)
        reps[mode] = bool(same)
    name, b, h, hk, s, d, dtype = KERNEL_CASES[0]
    q, k, v = _qkv(b, h, hk, s, d, dtype, seed=9)
    out, lse = FF.flash_fwd_cuda(q, k, v, d ** -0.5, h, hk, True)
    alone = []
    for i in range(b):
        one, one_lse = FF.flash_fwd_cuda(
            q[i * h:(i + 1) * h].contiguous(),
            k[i * hk:(i + 1) * hk].contiguous(),
            v[i * hk:(i + 1) * hk].contiguous(), d ** -0.5, h, hk, True)
        alone.append(torch.equal(one, out[i * h:(i + 1) * h])
                     and torch.equal(one_lse, lse[i * h:(i + 1) * h]))
    torch.cuda.synchronize()
    result = dict(reps20_bitwise=reps, batch_invariant=alone,
                  batch_shape=[b, h, hk, s, d])
    print("[kernel-check] forward bits " + json.dumps(result), flush=True)
    if not (all(reps.values()) and all(alone)):
        raise AssertionError(f"forward kernels are not bitwise reproducible "
                             f"or batch invariant: {result}")
    return result


_counts = ops.launch_counts


def _zero_counts():
    FF.launches = FF.launches_full = FF.launches_mask = 0
    FB.launches_worker = FB.launches_serial = FB.launches_fold = 0
    FPK.launches = 0
    SCAN.launches_fwd = SCAN.launches_bwd = SCAN.launches_fold = 0
    MLSTM.launches_parallel = MLSTM.launches_recurrent = SLSTM.launches = 0
    MLSTM.launches_parallel_bwd = SLSTM.launches_bwd = 0


def _no_launches():
    """Every counter of ``_counts`` at 0."""
    return dict.fromkeys(_counts(), 0)


def _bwd_operands(b, h, hk, s, d, dtype, causal, seed, mask=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((b * h, s, d), generator=gen, device="cuda")
             .to(dtype) for _ in range(2))
    k, v = (torch.randn((b * hk, s, d), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    if mask is None:
        out, lse = FF.flash_fwd_cuda(q, k, v, d ** -0.5, h, hk, causal=causal)
    else:
        out, lse = FF.flash_fwd_mask_cuda(q, k, v, d ** -0.5, h, hk, mask)
    delta = torch.sum(do.float() * out.float(), dim=-1)
    return q, k, v, do, out, lse, delta


def check_backward():
    """Per case and schedule: worker kernel + fold vs the plain worker
    backward + plain fold, and the serialized kernel vs the plain serialized
    backward, at the reference's grad tolerances; the serialized kernel ≡
    worker + fold bit for bit; the fold kernel ≡ the plain fold bit for bit
    on the same partials; 20 repetitions of the worker backward bitwise
    identical on each case's default schedule."""
    results, failed = [], []
    for name, b, h, hk, s, d, dtype in TRAIN_CASES:
        n = s // FB.BLOCK
        for sched, causal in BWD_SCHEDULES:
            q, k, v, do, out, lse, delta = _bwd_operands(
                b, h, hk, s, d, dtype, causal, seed=len(sched) + causal)
            schedule = cached_schedule(sched, n, n_heads=1, causal=causal)
            wc = schedule.worker_chains()
            scale = d ** -0.5
            part, dk, dv = FB.worker_bwd_cuda(q, k, v, do, lse, delta,
                                              schedule, scale, causal, h, hk)
            visited = torch.from_numpy(wc["visited"]).cuda()
            dq = FB.fold_cuda(part, visited, FB.BLOCK)
            sdq, sdk, sdv = FB.serial_bwd_cuda(q, k, v, do, lse, delta,
                                               schedule, scale, causal, h, hk)
            ppart, pdk, pdv = FB.worker_bwd_plain(
                q, k, v, do, lse, delta, wc, scale, causal, FB.BLOCK,
                FB.BLOCK, h, hk)
            pdq = FB.fold_plain(ppart, visited, FB.BLOCK)
            kv_ids, q_ids = schedule.prefetch_arrays()
            pser = FB.serial_bwd_plain(
                q, k, v, do, lse, delta, kv_ids, q_ids,
                FB.first_visit_flags(kv_ids, q_ids), scale, causal, FB.BLOCK,
                FB.BLOCK, h, hk)
            # the fold alone, on the kernel's own partials
            fold_ref = FB.fold_plain(part, visited, FB.BLOCK)
            fold_same = torch.equal(dq, fold_ref)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(x, y) for x, y in
                          ((dq, sdq), (dk, sdk), (dv, sdv)))
            # each kernel's own error against its plain version: the worker
            # kernel's partials on the tiles a worker visits (the rest is
            # never written), the serialized kernel's dq/dk/dv, the fold's
            # output on the same partials
            seen = visited.repeat_interleave(FB.BLOCK, 1).bool()[None, :, :,
                                                                 None]
            err = dict(
                worker=dict(dq_part=(part - ppart).abs().where(
                    seen, 0.0).max().item(),
                    dk=(dk - pdk).abs().max().item(),
                    dv=(dv - pdv).abs().max().item()),
                serial=dict(zip(("dq", "dk", "dv"), (
                    (x - y).abs().max().item()
                    for x, y in zip((sdq, sdk, sdv), pser)))),
                fold=(dq - fold_ref).abs().max().item())
            pairs = ((dq, pdq), (dk, pdk), (dv, pdv)) + tuple(
                zip((sdq, sdk, sdv), pser))
            close = all(torch.allclose(x, y, **GRAD_TOL[dtype])
                        for x, y in pairs)
            finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
            reps_equal = None
            if sched in ("shift", "symmetric_shift"):
                reps_equal = True
                for _ in range(20):
                    again = FB.worker_bwd_cuda(q, k, v, do, lse, delta,
                                               schedule, scale, causal, h, hk)
                    again_dq = FB.fold_cuda(again[0], visited, FB.BLOCK)
                    reps_equal &= (torch.equal(again_dq, dq)
                                   and torch.equal(again[1], dk)
                                   and torch.equal(again[2], dv))
            ok = (bitwise and close and finite and fold_same
                  and reps_equal is not False)
            results.append(dict(case=name, schedule=sched, causal=causal,
                                dtype=str(dtype).split(".")[-1],
                                max_abs_err=err,
                                serial_bitwise_eq_worker_fold=bitwise,
                                fold_bitwise_eq_plain=fold_same,
                                reps20_bitwise=reps_equal, ok=ok))
            if not ok:
                failed.append(f"{name}/{sched}/causal={causal}")
    print("[kernel-check] backward " + json.dumps(results), flush=True)
    _print_kernel_errors("backward", results)
    if failed:
        raise AssertionError(f"backward kernels failed their checks in "
                             f"{failed}")
    return results


def _print_kernel_errors(label, results):
    """Each backward kernel's largest |kernel - plain| over the checks, per
    dtype (bf16: the tensor-core products; fp32: the CUDA-core body)."""
    worst = {}
    for r in results:
        for kernel in ("worker", "serial"):
            key = f"{kernel}/{r['dtype']}"
            worst[key] = max(worst.get(key, 0.0),
                             max(r["max_abs_err"][kernel].values()))
    print(f"[kernel-check] {label} max |kernel - plain| " + json.dumps(worst),
          flush=True)


def check_masks():
    """Per mask family, dtype and GQA group at S=1024, D=64: the block-sparse
    forward kernel vs its plain version; the masked worker kernel + fold and
    the masked serialized kernel vs their plain versions (on the KV rows
    some task visits: the kernels leave the others unwritten); serialized ≡
    worker + fold bit for bit; the host ``flash_bwd`` under deterministic
    algorithms (which fill fresh memory with NaN) gives exact zeros on the
    unvisited KV rows; 20 repetitions of the window's worker backward are
    bitwise identical."""
    results, failed = [], []
    b, h, s, d = 1, 32, MASK_S, 64
    n = s // FB.BLOCK
    scale = d ** -0.5
    for name, mask in MASK_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            for hk in (32, 8):
                q, k, v = _qkv(b, h, hk, s, d, dtype, seed=len(name) + hk)
                out, lse = FF.flash_fwd_mask_cuda(q, k, v, scale, h, hk, mask)
                ref_out, ref_lse = FF.flash_fwd_plain(q, k, v, scale, h, hk,
                                                      mask=mask)
                torch.cuda.synchronize()
                err_out = (out.float() - ref_out.float()).abs().max().item()
                err_lse = ((lse - ref_lse).abs()
                           / ref_lse.abs().clamp_min(1.0)).max().item()
                tol = OUT_TOL[dtype]
                fwd_ok = (bool(torch.isfinite(out).all())
                          and err_lse <= LSE_RTOL
                          and torch.allclose(out.float(), ref_out.float(),
                                             atol=tol, rtol=tol))

                q, k, v, do, out, lse, delta = _bwd_operands(
                    b, h, hk, s, d, dtype, False, seed=len(name), mask=mask)
                schedule = cached_schedule("shift", n, mask=mask)
                wc = schedule.worker_chains()
                visited = torch.from_numpy(wc["visited"]).cuda()
                args = (q, k, v, do, lse, delta)
                part, dk, dv = FB.worker_bwd_cuda(*args, schedule, scale,
                                                  False, h, hk, mask)
                dq = FB.fold_cuda(part, visited, FB.BLOCK)
                sdq, sdk, sdv = FB.serial_bwd_cuda(*args, schedule, scale,
                                                   False, h, hk, mask)
                ppart, pdk, pdv = FB.worker_bwd_plain(
                    *args, wc, scale, False, FB.BLOCK, FB.BLOCK, h, hk, mask)
                pdq = FB.fold_plain(ppart, visited, FB.BLOCK)
                kv_ids, q_ids = schedule.prefetch_arrays()
                pser = FB.serial_bwd_plain(
                    *args, kv_ids, q_ids, FB.first_visit_flags(kv_ids, q_ids),
                    scale, False, FB.BLOCK, FB.BLOCK, h, hk, mask)
                live = FB._live_rows(schedule, FB.BLOCK, q.device)[None]
                n_dead = s - int(live.sum())
                seen = visited.repeat_interleave(FB.BLOCK, 1).bool()[
                    None, :, :, None]

                def on_live(x):
                    return x.where(live, 0.0)

                bitwise = (torch.equal(dq, sdq)
                           and torch.equal(on_live(dk), on_live(sdk))
                           and torch.equal(on_live(dv), on_live(sdv)))
                err = dict(
                    fwd=err_out,
                    worker=dict(dq_part=(part - ppart).abs().where(
                        seen, 0.0).max().item(),
                        dk=on_live((dk - pdk).abs()).max().item(),
                        dv=on_live((dv - pdv).abs()).max().item()),
                    serial=dict(
                        dq=(sdq - pser[0]).abs().max().item(),
                        dk=on_live((sdk - pser[1]).abs()).max().item(),
                        dv=on_live((sdv - pser[2]).abs()).max().item()))
                pairs = ((dq, pdq), (on_live(dk), pdk), (on_live(dv), pdv),
                         (sdq, pser[0]), (on_live(sdk), pser[1]),
                         (on_live(sdv), pser[2]))
                close = all(torch.allclose(x, y, **GRAD_TOL[dtype])
                            for x, y in pairs)
                # the host path: dead rows zeroed, before the GQA fold
                torch.use_deterministic_algorithms(True)
                try:
                    hdq, hdk, hdv = FB.flash_bwd(q, k, v, out, lse, do,
                                                 schedule, n_heads=h,
                                                 n_kv_heads=hk, mask=mask)
                finally:
                    torch.use_deterministic_algorithms(False)
                host_ok = all(bool(torch.isfinite(x).all())
                              and bool((x.where(~live, 0.0) == 0).all())
                              for x in (hdk, hdv)) and bool(
                                  torch.isfinite(hdq).all())
                reps_equal = None
                if name == "window" and dtype == torch.bfloat16:
                    reps_equal = True
                    for _ in range(20):
                        again = FB.worker_bwd_cuda(*args, schedule, scale,
                                                   False, h, hk, mask)
                        again_dq = FB.fold_cuda(again[0], visited, FB.BLOCK)
                        reps_equal &= (torch.equal(again_dq, dq)
                                       and torch.equal(on_live(again[1]),
                                                       on_live(dk))
                                       and torch.equal(on_live(again[2]),
                                                       on_live(dv)))
                torch.cuda.synchronize()
                ok = (fwd_ok and bitwise and close and host_ok
                      and reps_equal is not False)
                results.append(dict(
                    mask=name, key=mask.key(), dtype=str(dtype).split(".")[-1],
                    heads=[h, hk], tasks=int(wc["valid"].sum()),
                    partial_tiles=len(schedule.partial_cells),
                    dead_kv_rows=n_dead, max_abs_err=err,
                    max_rel_err_lse=err_lse,
                    serial_bitwise_eq_worker_fold=bitwise,
                    host_dead_rows_zero=host_ok, reps20_bitwise=reps_equal,
                    ok=ok))
                if not ok:
                    failed.append(f"{name}/{dtype}/hk={hk}")
    print("[kernel-check] mask " + json.dumps(results), flush=True)
    _print_kernel_errors("masked backward", results)
    if failed:
        raise AssertionError(f"block-sparse mask kernels failed their checks "
                             f"in {failed}")
    return results


class _PinnedRouting:
    """The router's top-k choices (``models/moe.py::route``) recorded in one
    run and replayed, call by call, in another: the replaying run takes the
    recorded experts with its own probabilities for them (renormalised as
    its config says). A kernel run and the plain attention's over an MoE
    model are compared so: a bf16 difference in a hidden state flips
    near-tied router choices (Phi-3.5-MoE, 4 layers, B=4, S=512: 21 of 2048
    tokens in layer 1, 601 by layer 4; ``scripts/moe_logits_noise.py``),
    and a flip moves its token by O(1)
    and, through the queues, other tokens' capacity drops. ``flips`` counts
    the replayed calls' own choices that differ from the recorded ones, of
    ``choices``. A model without experts records nothing."""

    def __init__(self):
        self.calls, self.flips, self.choices = [], 0, 0

    @contextlib.contextmanager
    def _routed(self, route):
        orig = MOE.route
        MOE.route = lambda p, x, cfg: route(orig, p, x, cfg)
        try:
            yield self
        finally:
            MOE.route = orig

    def record(self):
        def route(orig, p, x, cfg):
            out = orig(p, x, cfg)
            self.calls.append(out[2])
            return out
        return self._routed(route)

    def replay(self):
        queue = list(self.calls)

        def route(orig, p, x, cfg):
            probs, _, own = orig(p, x, cfg)
            idx = queue.pop(0)
            self.flips += int((own != idx).any(-1).sum())
            self.choices += own[..., 0].numel()
            vals = probs.gather(-1, idx)
            if cfg.renorm_topk:
                vals = vals / vals.sum(-1, keepdim=True)
            return probs, vals, idx
        return self._routed(route)


@contextlib.contextmanager
def _plain_mixers():
    """The models' selective scan and xLSTM mixers on their plain versions
    (the scan's sequential recurrence, differentiated by autograd; the
    mLSTM parallel form and recurrence and the sLSTM recurrence) while the
    context is open: the plain runs that a kernel run is held against.
    Outside it a CUDA tensor always takes the kernels."""
    orig = (SCAN.selective_scan, MLSTM.mlstm_parallel,
            MLSTM.mlstm_recurrent, SLSTM.slstm)

    def plain(u, dt, A, B, C, D, z, h0, chunk):
        return SCAN.selective_scan_plain(u, dt, A, B, C, D, z, h0)
    SCAN.selective_scan = plain
    MLSTM.mlstm_parallel = MLSTM.mlstm_parallel_plain
    MLSTM.mlstm_recurrent = MLSTM.mlstm_recurrent_plain
    SLSTM.slstm = SLSTM.slstm_plain
    try:
        yield
    finally:
        (SCAN.selective_scan, MLSTM.mlstm_parallel, MLSTM.mlstm_recurrent,
         SLSTM.slstm) = orig


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@torch.inference_mode()
def _profiled(fn, top=6):
    """One call of ``fn`` under torch.profiler (CUPTI): ``(summary, ops)``,
    the summary its wall ms (host clock, synchronised, the profiler's
    overhead included), the device's busy ms (the sum of the device ops'
    own time), the busy share and the ``top`` device ops that took the
    most; ``ops`` the profiler's device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops_ = [a for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA]
    busy_ms = sum(a.self_device_time_total for a in ops_) / 1e3
    most = [dict(ms=a.self_device_time_total / 1e3, count=a.count,
                 name=a.key[:80])
            for a in sorted(ops_,
                            key=lambda a: -a.self_device_time_total)[:top]]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                busy_share=busy_ms / wall_ms, top=most), ops_


def _serve_static(slice_, profile_prefill=False):
    """The static engine at full width and depth (or the slice's
    ``layers``): greedy, twice (bitwise equal tokens), the generate's
    launches (the prefill's attention forward, causal or block-sparse under
    a window, once per attention layer; the scan, the mLSTM recurrence and
    the sLSTM once a layer of theirs in the prefill and each decode step),
    prefill ms and decode tok/s. Returns (result, vs_plain): ``vs_plain()``
    runs the timed prefill again on the plain attention and mixers (over an
    MoE model with the router's choices pinned to the kernel run's:
    :class:`_PinnedRouting`) and gives its logits' errors against the
    kernels'. ``profile_prefill``: one more prefill under the profiler
    (``prefill_profile``: its device-busy ms beside the host's)."""
    cfg = registry.get(slice_["arch"]).replace(attention_impl="cuda",
                                               attn_window=slice_["window"])
    if "layers" in slice_:
        cfg = launch_train.cut_layers(cfg, str(slice_["layers"]))
    attn_layers, mamba_layers, mlstm_layers, slstm_layers = _layer_kinds(cfg)
    b, s, n = slice_["batch"], slice_["prompt"], slice_["gen"]
    params = T.init(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(1, cfg.vocab, (b, s), generator=gen, device="cuda")
    batch = {"tokens": prompt}
    engine = Engine(cfg, params, max_seq=s + n)

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    tokens, t_run = _timed(lambda: engine.generate(batch, n))
    counts = _counts()
    kind = "fwd_mask" if cfg.attn_window else "fwd_causal"
    launches = counts[kind]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the prefill's attention forward once an attention layer; the scan,
    # the mLSTM recurrence and the sLSTM once a layer of theirs in the
    # prefill and in each decode step
    want = dict(_no_launches(), scan_fwd=mamba_layers * n,
                mlstm_recurrent=mlstm_layers * n, slstm=slstm_layers * n)
    want[kind] = attn_layers
    if counts != want:
        raise AssertionError(f"generate launched {counts}, expected {want}")
    if tokens.shape != (b, n) or not bool(
            ((tokens >= 0) & (tokens < cfg.padded_vocab)).all()):
        raise AssertionError(f"tokens out of range or misshapen: "
                             f"{tuple(tokens.shape)}")
    again = engine.generate(batch, n)
    if not torch.equal(tokens, again):
        raise AssertionError("two greedy runs gave different tokens")

    # prefill and decode times, outside the counted run
    pin = _PinnedRouting()
    with pin.record():
        (logits, caches), t_prefill = _timed(
            lambda: T.prefill_step(params, batch, cfg, max_seq=s + n))

    def decode_all():
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        for i in range(1, n):
            out, _ = T.decode_step(params, caches, tok, s + i - 1, cfg)
            tok = torch.argmax(out[:, -1], -1)[:, None].to(torch.int32)
        return tok
    _, t_decode = _timed(decode_all)
    profile = (_profiled(lambda: T.prefill_step(params, batch, cfg,
                                                max_seq=s + n))[0]
               if profile_prefill else None)

    def vs_plain():
        plain_cfg = cfg.replace(attention_impl="torch")
        with pin.replay(), _plain_mixers():
            plain_logits, _ = T.prefill_step(params, batch, plain_cfg,
                                             max_seq=s)
        rel = (torch.linalg.vector_norm(logits - plain_logits, dim=-1)
               / torch.linalg.vector_norm(plain_logits, dim=-1)).max().item()
        same = (logits.argmax(-1) == plain_logits.argmax(-1)).float().mean()
        return dict(
            logits_finite=bool(torch.isfinite(logits).all()),
            logits_max_abs_err_vs_plain=(logits - plain_logits).abs().max()
            .item(),
            logits_row_rel_err_vs_plain=rel,
            max_abs_logit=plain_logits.abs().max().item(),
            argmax_agreement=same.item(),
            router_choices_flipped_unpinned=[pin.flips, pin.choices])

    result = dict(
        arch=cfg.name, layers=cfg.n_layers, params=count_params(params),
        batch=b, prompt=s,
        new_tokens=n, attn_window=cfg.attn_window, attention_launches=launches,
        pattern=list(cfg.block_pattern), scan_launches=counts["scan_fwd"],
        xlstm_launches=dict(mlstm_recurrent=counts["mlstm_recurrent"],
                            slstm=counts["slstm"]),
        run_s=t_run, prefill_ms=t_prefill * 1e3,
        decode_tok_per_s=b * (n - 1) / t_decode, peak_mem_gb=peak_gb,
        tokens_bitwise_equal=True, tokens_row0=tokens[0, :8].tolist())
    if profile is not None:
        result["prefill_profile"] = profile
    return result, vs_plain


@torch.inference_mode()
def run_slice(slice_=SLICE, label="slice"):
    """:func:`_serve_static`, and its prefill logits against the plain
    attention's: within ``LOGITS_ATOL``, an MoE model's rows within
    ``MOE_LOGITS_REL``."""
    result, vs_plain = _serve_static(slice_)
    result.update(vs_plain())
    moe = bool(registry.get(slice_["arch"]).n_experts)
    result["logits_bound"] = (f"row rel. err <= {MOE_LOGITS_REL}" if moe
                              else f"max abs err <= {LOGITS_ATOL}")
    print(f"[{label}] " + json.dumps(result), flush=True)
    close = (result["logits_row_rel_err_vs_plain"] <= MOE_LOGITS_REL if moe
             else result["logits_max_abs_err_vs_plain"] <= LOGITS_ATOL)
    if not (result["logits_finite"] and close):
        raise AssertionError(
            f"prefill logits: finite={result['logits_finite']}, max |cuda - "
            f"plain| = {result['logits_max_abs_err_vs_plain']}, row rel. err "
            f"{result['logits_row_rel_err_vs_plain']}: beyond "
            f"{result['logits_bound']}")
    return result


def _attn_leaves(params):
    """The stacked attention projections of the first block with attention
    (``b0_attn``, ``b0_attn_moe``, or Jamba's ``b{i}_attn``): wq, wk, wv,
    wo."""
    key = min((k for k in params["blocks"] if "attn" in params["blocks"][k]),
              key=lambda k: int(k.split("_")[0][1:]))
    return tuple(f"blocks/{key}/attn/{w}" for w in ATTN_WEIGHTS)


def _layer_kinds(cfg):
    """(attention, Mamba, mLSTM, sLSTM) layers of ``cfg``."""
    n_rep = cfg.n_layers // len(cfg.block_pattern)
    return tuple(n_rep * sum(k.startswith(f) for k in cfg.block_pattern)
                 for f in ("attn", "mamba", "mlstm", "slstm"))


def _train_launches(cfg, verify):
    """What one remat'd train step launches: per attention layer the
    forward twice (block-sparse under a window, else causal), the worker
    backward once, and its folds (the dQ partials, and under GQA dK and dV
    over each group); per Mamba layer the scan's forward twice, its
    backward and fold once; per mLSTM layer the parallel form's forward
    twice and its backward's passes once each; per sLSTM layer its forward
    twice and its backward once; one fingerprint under ``--verify``."""
    attn, mamba, mlstm, slstm = _layer_kinds(cfg)
    folds = 3 if cfg.n_kv_heads < cfg.n_heads else 1
    want = dict(_no_launches(), bwd_worker=attn, fold=folds * attn,
                fingerprint=int(verify), scan_fwd=2 * mamba, scan_bwd=mamba,
                scan_fold=mamba, mlstm_parallel=2 * mlstm,
                mlstm_parallel_bwd=len(MLSTM.BWD_PASSES) * mlstm,
                slstm=2 * slstm, slstm_bwd=slstm)
    want["fwd_mask" if cfg.attn_window else "fwd_causal"] = 2 * attn
    return want


def _attn_grads(cfg, params, batch):
    """Step 1's loss grads of every layer's attention projections (the
    stacked wq, wk, wv, wo), as the train step takes them: remat on. dQ
    reaches wq, dK wk, dV wv; wo sees the attention output."""
    paths = [p for p, _ in tree_paths(params)]
    wanted_paths = _attn_leaves(params)
    leaves = [x.detach().requires_grad_(p in wanted_paths)
              for p, x in zip(paths, O.tree_leaves(params))]
    tree = {}
    for path, leaf in zip(paths, leaves):
        set_path(tree, path, leaf)
    loss, _ = T.loss_fn(tree, batch, cfg, remat=True)
    wanted = [(p, x) for p, x in zip(paths, leaves) if x.requires_grad]
    grads = torch.autograd.grad(loss, [x for _, x in wanted])
    return {p: g for (p, _), g in zip(wanted, grads)}


def run_train(argv=TRAIN_ARGV, label="train", compare_argv=None,
              gate_step1=True):
    """StableLM-1.6B at full width (``TRAIN_ARGV``: 12 of its 24 layers),
    3 AdamW steps through the train launcher
    (``repro_torch.launch.train.main``, the DASH kernels) with the flags
    ``argv``, twice from seed 0; the launcher's step 1 against the
    plain attention's (and the plain scan's, over Mamba layers) on the same
    weights and batch (with a window: the plain masked, query-chunked
    attention); step 3 of the second run under the profiler. With
    ``compare_argv`` (flags that differ in the batch's shape only), step 1
    is held against the plain path on that batch instead, both steps run
    here: the plain scan's autograd keeps (B, S, Din, N) states. A model
    without attention has no attention grads to hold; with ``gate_step1``
    False step 1 against the plain path is a reading, printed and not
    held to a limit."""
    args, cfg, tcfg, data, device = launch_train.configure(argv)
    want = _train_launches(cfg, args.verify)
    c_args, c_cfg, c_tcfg, c_data, _ = (
        launch_train.configure(compare_argv) if compare_argv
        else (args, cfg, tcfg, data, device))
    batch0 = c_data.batch(0)

    # step 1 on the plain attention (and scan), and the attention grads both
    # ways; over an MoE model the plain runs take the kernel runs' router
    # choices (_PinnedRouting), the kernel's step 1 then run here too, and it
    # must be the launcher's step 1 bit for bit
    torch.use_deterministic_algorithms(True)
    pins = [_PinnedRouting(), _PinnedRouting()]
    kernel_m = None
    try:
        state = TS.init_state(c_cfg, c_tcfg, seed=args.seed, device=device)
        plain_cfg = c_cfg.replace(attention_impl="torch")
        if cfg.n_experts or compare_argv:
            with pins[0].record():
                kernel_m = TS.make_train_step(c_cfg, c_tcfg)(state,
                                                             batch0)[1]
            kernel_m = {k: float(kernel_m[k]) for k in ("loss", "grad_norm")}
        with pins[0].replay(), _plain_mixers():
            plain_m = TS.make_train_step(plain_cfg, c_tcfg)(state, batch0)[1]
        plain_m = {k: float(plain_m[k]) for k in ("loss", "grad_norm")}
        attn_leaves, ga, gp = (), {}, {}
        if _layer_kinds(c_cfg)[0]:
            with pins[1].record():
                ga = _attn_grads(c_cfg, state["params"], batch0)
            with pins[1].replay(), _plain_mixers():
                gp = _attn_grads(plain_cfg, state["params"], batch0)
            attn_leaves = _attn_leaves(state["params"])
        torch.cuda.synchronize()
        del state
    finally:
        torch.use_deterministic_algorithms(False)
    # per leaf, the largest over layers of |g_cuda - g_plain| / |g_plain|
    attn_err = {}
    for path in attn_leaves:
        a, p = ga[path].float(), gp[path].float()
        attn_err[path.split("/")[-1]] = max(
            (torch.linalg.vector_norm(x - y) / torch.linalg.vector_norm(y))
            .item() for x, y in zip(a, p))
    del ga, gp

    runs = []
    track_dir = tempfile.mkdtemp(prefix="repro_torch_track_")
    track = [os.path.join(track_dir, f"run{i}.jsonl") for i in range(2)]
    trace = os.path.join(track_dir, "run0.json")
    obs_flags = [["--track", track[0], "--trace-out", trace],
                 ["--track", track[1], "--track-reference", track[0]]]
    for run in range(2):
        counts, metrics1, changed = [], {}, []

        def on_step(step, state, metrics):
            counts.append(_counts())
            _zero_counts()
            if step == 1:
                metrics1.update({k: float(metrics[k]) for k in (
                    "loss", "grad_norm", "ce", "aux")})
            if step == args.steps and run == 0:   # against the seed's init
                initial = T.init(cfg, seed=args.seed, device=device)
                changed.append(sum(int((x != y).sum()) for x, y in zip(
                    O.tree_leaves(state["params"]), O.tree_leaves(initial))))

        run_argv = argv + obs_flags[run] + (
            ["--profile-step", str(args.steps)] if run else [])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        summary = launch_train.main(run_argv, on_step=on_step)
        runs.append(dict(summary, launches=counts, step1=metrics1,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         params_changed=changed[0] if changed else None))
    a, b_ = runs
    obs = _train_obs(args, track, trace, a, b_,
                     attn=bool(_layer_kinds(cfg)[0]))
    shutil.rmtree(track_dir, ignore_errors=True)
    for i, c in enumerate(a["launches"] + b_["launches"]):
        if c != want:
            raise AssertionError(f"train step {i % args.steps + 1} launched "
                                 f"{c}, expected {want}")
    # the second run's last step ran under the profiler
    steady = statistics.median(a["step_ms"][1:] + b_["step_ms"][1:-1])
    prof = b_["profile"]
    first = dict(kernel_m if compare_argv else a["step1"],
                 plain_loss=plain_m["loss"],
                 plain_grad_norm=plain_m["grad_norm"])
    rel_loss = abs(first["loss"] - first["plain_loss"]) / abs(
        first["plain_loss"])
    rel_gn = abs(first["grad_norm"] - first["plain_grad_norm"]) / abs(
        first["plain_grad_norm"])
    result = dict(
        arch=cfg.name, layers=cfg.n_layers, batch=args.batch, seq=args.seq,
        steps=args.steps, attn_window=cfg.attn_window,
        pattern=list(cfg.block_pattern),
        entry="repro_torch.launch.train.main " + " ".join(argv),
        step1_compared_at=dict(batch=c_args.batch, seq=c_args.seq),

        # a hash chain over every step's state digest: equal heads mean
        # equal params and moments after every step
        digest_chain_heads=[a["digest_chain_head"], b_["digest_chain_head"]],
        digests_equal=a["digest_chain_head"] == b_["digest_chain_head"],
        final_losses=[a["final_loss"], b_["final_loss"]],
        params_changed=a["params_changed"],
        launches_per_step=a["launches"][0], step_ms=a["step_ms"],
        step_ms_run2=b_["step_ms"], steady_step_ms=steady,
        tokens_per_s=args.batch * args.seq / (steady / 1e3),
        peak_mem_gb=a["peak_gb"], step1_vs_plain=first,
        loss_rel_diff=rel_loss, loss_rtol=LOSS_RTOL, gnorm_rel_diff=rel_gn,
        gnorm_rtol=GNORM_RTOL, attn_grad_rel_err=attn_err,
        attn_grad_rtol=ATTN_GRAD_RTOL, step1_gated=gate_step1,
        router_choices_flipped_unpinned=[[p.flips, p.choices] for p in pins])
    print(f"[{label}] " + json.dumps(result), flush=True)
    print(f"[{label}-obs] " + json.dumps(obs), flush=True)
    print(f"[{label}-profile] " + json.dumps(dict(
        step=args.steps, wall_ms_traced=b_["step_ms"][-1],
        device_busy_ms=prof["busy_ms"],
        device_busy_share_of_steady_step=prof["busy_ms"] / steady,
        device_ops=prof["ops"], top_device_ops=prof["top_ops"])), flush=True)
    if not result["digests_equal"]:
        raise AssertionError("two training runs from seed 0 gave different "
                             "state digests")
    if not result["params_changed"]:
        raise AssertionError("three training steps changed no parameter")
    if not all(x == x and abs(x) < 1e4 for x in result["final_losses"]):
        raise AssertionError(f"non-finite losses {result['final_losses']}")
    if kernel_m is not None and not compare_argv and kernel_m != {
            k: a["step1"][k] for k in kernel_m}:
        raise AssertionError(f"the pinned kernel step 1 {kernel_m} is not "
                             f"the launcher's {a['step1']}")
    if gate_step1 and (rel_loss > LOSS_RTOL or rel_gn > GNORM_RTOL):
        raise AssertionError(f"train step 1 vs the plain attention: loss "
                             f"rel. diff {rel_loss} (tol {LOSS_RTOL}), grad "
                             f"norm rel. diff {rel_gn} (tol {GNORM_RTOL})")
    if attn_err and max(attn_err.values()) > ATTN_GRAD_RTOL:
        raise AssertionError(f"attention grads vs the plain attention: "
                             f"{attn_err} > {ATTN_GRAD_RTOL}")
    if obs["problems"]:
        raise AssertionError(f"[{label}] observability: {obs['problems']}")
    return dict(result, obs=obs)


def _train_obs(args, track, trace, a, b_, attn=True):
    """What the two tracked train runs recorded: run 0 with ``--track`` and
    ``--trace-out``, run 1 with ``--track`` against run 0's file. Both must
    report ``fingerprint_ok``, record one equal fingerprint a step, diff
    clean, and run 0's trace must validate (with the attention schedule's
    modeled and achieved lanes when the model has ``attn`` layers) and
    hold a train_data / train_step / train_digest span a step.
    Returns the record with ``problems``, empty when all holds; prints each
    step's utilization against the tuner's modeled attention time."""
    fps = [[(e["step"], e["fingerprint"])
            for e in OBS.read_jsonl(t, event="fingerprint")] for t in track]
    steps = OBS.read_jsonl(track[0], event="step")
    diff = OBS.diff_runs(OBS.RunReport.from_jsonl(track[0]),
                         OBS.RunReport.from_jsonl(track[1]))
    with open(trace) as f:
        obj = json.load(f)
    invalid = OBS_EX.validate_trace(
        obj, (OBS_EX.PROCESS_MODELED, OBS_EX.PROCESS_ACHIEVED) if attn
        else ())
    lanes = {}
    for ev in obj["traceEvents"]:
        if ev.get("pid") == OBS_EX.PID_RUN and ev.get("ph") == "X":
            lanes[ev["cat"]] = lanes.get(ev["cat"], 0) + 1
    achieved = next((ev["args"]["achieved_s"] for ev in obj["traceEvents"]
                     if ev.get("pid") == OBS_EX.PID_ACHIEVED
                     and ev.get("ph") == "X"), None)
    if attn and achieved is None:
        raise AssertionError("the trace has no achieved attention lane")
    want_lanes = {p: args.steps for p in ("train_data", "train_step")}
    if args.verify:
        want_lanes["train_digest"] = args.steps
    problems = []
    if args.verify:
        if not (a.get("fingerprint_ok") and b_.get("fingerprint_ok")):
            problems.append("fingerprint_ok is not true in both runs")
        if fps[0] != fps[1] or [s for s, _ in fps[0]] != list(
                range(1, args.steps + 1)):
            problems.append(f"fingerprint streams {fps}")
    if not diff.clean:
        problems.append(f"diff_runs: {diff}")
    if invalid:
        problems.append(f"trace: {invalid[:3]}")
    if lanes != want_lanes:
        problems.append(f"span lanes {lanes}, expected {want_lanes}")
    per_step = [dict(step=e["step"], step_ms=e["step_ms"],
                     modeled_step_attn_s=e.get("modeled_step_s"),
                     utilization_vs_modeled=e.get("utilization_vs_modeled"))
                for e in steps]
    for row in per_step:
        if row["modeled_step_attn_s"] is not None:
            print(f"[obs] step {row['step']}: modeled_step(attn)="
                  f"{row['modeled_step_attn_s']:.3e}s, step "
                  f"{row['step_ms']:.1f} ms, utilization_vs_modeled="
                  f"{row['utilization_vs_modeled']:.3e}", flush=True)
    return dict(fingerprints=[fp for _, fp in fps[0]],
                fingerprints_equal=fps[0] == fps[1],
                fingerprint_ok=[a.get("fingerprint_ok"),
                                b_.get("fingerprint_ok")],
                diff=str(diff), trace_events=len(obj["traceEvents"]),
                span_lanes=lanes, timeline_achieved_s=achieved,
                steps=per_step, problems=problems)


def bf16_ulp(v):
    """The spacing of bf16 values at magnitude ``v`` > 0."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


@contextlib.contextmanager
def expert_out_max(into):
    """Appends max |expert output| of every ``models/moe.py::_experts`` call
    made inside to ``into`` (a 0-dim tensor each; the outputs unchanged)."""
    orig = MOE._experts

    def experts(p, xin, cfg):
        out = orig(p, xin, cfg)
        into.append(out.float().abs().max())
        return out
    MOE._experts = experts
    try:
        yield into
    finally:
        MOE._experts = orig


def moe_bf16_gap(p, x, cfg, gather_x=None, gather_cfg=None):
    """``apply_moe(p, x, cfg)`` against ``apply_moe_gather`` (on
    ``gather_x``/``gather_cfg`` where given, else the same): the largest
    |difference|, the gather run's max |expert output| m, and the limit
    ``MOE_BF16_ULPS`` bf16 ulps of m. The gather path rounds each gated
    slot output (|gate·out| <= m) to bf16 before the sum over k, half an
    ulp of m each, and the two paths' last roundings of |y| <= 2m take at
    most an ulp of m each. Returns (that dict, y_einsum, aux_einsum,
    y_gather, aux_gather)."""
    seen = []
    ye, ae = MOE.apply_moe(p, x, cfg)
    with expert_out_max(seen):
        yg, ag = MOE.apply_moe_gather(p, x if gather_x is None else gather_x,
                                      gather_cfg or cfg)
    m = seen[0].item()
    gap = (ye.float() - yg.float()).abs().max().item()
    limit = MOE_BF16_ULPS * bf16_ulp(m)
    return (dict(max_abs_err=gap, max_abs_expert_out=m,
                 max_abs_y=ye.float().abs().max().item(), limit=limit,
                 ulps_of_m=gap / bf16_ulp(m), ok=gap <= limit),
            ye, ae, yg, ag)


def check_moe_gather(label="train-moe-gather"):
    """One full-width expert layer of ``TRAIN_MOE_ARGV``'s arch (weights from
    seed 0, normal inputs of ``MOE_GATHER_SHAPE``) under deterministic
    algorithms, the gather dispatch against the einsum dispatch at each
    capacity factor of ``MOE_GATHER_CAPACITY`` (the tighter one drops
    tokens): in fp32 within ``MOE_IMPL_TOL``, aux within 1e-5; in bf16, the
    model's dtype, within :func:`moe_bf16_gap`'s limit (the gather path
    rounds each gated slot output to bf16 before the sum over k, the einsum
    path once after it, so they differ by bf16 ulps of the slot outputs,
    more than ``MOE_IMPL_TOL`` allows at |y| ~ 0), aux within 1e-5; at the
    model's own capacity factor each twice bitwise, both ms reported."""
    base = registry.get(TRAIN_MOE_ARGV[1])
    gen = torch.Generator(device="cuda").manual_seed(0)
    p16 = init_tree(MOE.moe_defs(base), gen, base.dtype, "cuda")
    b, s = MOE_GATHER_SHAPE
    x16 = torch.randn((b, s, base.d_model), generator=gen,
                      device="cuda").to(base.dtype)
    fp32, bf16, ok = [], [], True
    torch.use_deterministic_algorithms(True)
    try:
        with torch.inference_mode():
            for cf in MOE_GATHER_CAPACITY:
                cfg = base.replace(dtype_name="float32", capacity_factor=cf)
                p32 = {k: v.float() for k, v in p16.items()}
                x = x16.float()
                ye, ae = MOE.apply_moe(p32, x, cfg)
                yg, ag = MOE.apply_moe_gather(p32, x, cfg)
                _, _, idx = MOE.route(p32, x, cfg)
                _, pos = MOE.queue_positions(idx, cfg.n_experts)
                aux_rel = abs(ae.item() - ag.item()) / abs(ae.item())
                close = torch.allclose(ye, yg, **MOE_IMPL_TOL)
                ok &= close and aux_rel <= 1e-5 and bool(
                    torch.isfinite(ye).all())
                fp32.append(dict(
                    capacity_factor=cf, capacity=MOE.capacity(s, cfg),
                    kept_share=(pos < MOE.capacity(s, cfg)).float().mean()
                    .item(), max_abs_err=(ye - yg).abs().max().item(),
                    aux_rel_diff=aux_rel, ok=close))
                del p32
                cfg = base.replace(capacity_factor=cf)
                gap, ye, ae, yg, ag = moe_bf16_gap(p16, x16, cfg)
                aux_rel = abs(ae.item() - ag.item()) / abs(ae.item())
                gap.update(capacity_factor=cf, aux_rel_diff=aux_rel)
                ok &= gap["ok"] and aux_rel <= 1e-5 and bool(
                    torch.isfinite(ye).all() & torch.isfinite(yg).all())
                bf16.append(gap)
            cfg = base
            ye, ae = MOE.apply_moe(p16, x16, cfg)
            yg, ag = MOE.apply_moe_gather(p16, x16, cfg)
            (ye2, ae2), t_e = _timed(lambda: MOE.apply_moe(p16, x16, cfg))
            (yg2, ag2), t_g = _timed(lambda: MOE.apply_moe_gather(p16, x16,
                                                                 cfg))
    finally:
        torch.use_deterministic_algorithms(False)
    bitwise = (torch.equal(ye, ye2) and torch.equal(ae, ae2)
               and torch.equal(yg, yg2) and torch.equal(ag, ag2))
    ok &= bitwise
    result = dict(arch=base.name, d_model=base.d_model, d_ff=base.d_ff,
                  experts=base.n_experts, top_k=base.top_k, shape=[b, s],
                  tol=MOE_IMPL_TOL, fp32=fp32, bf16_ulps=MOE_BF16_ULPS,
                  bf16=bf16, bf16_twice_bitwise=bitwise,
                  einsum_ms=t_e * 1e3, gather_ms=t_g * 1e3)
    print(f"[{label}] " + json.dumps(result), flush=True)
    if not ok:
        raise AssertionError(f"gather vs einsum dispatch: {result}")
    return result


def run_train_moe(label="train-moe"):
    """Phi-3.5-MoE at full width, 1 layer, through the train launcher as
    :func:`run_train` drives it (``TRAIN_MOE_ARGV``, einsum dispatch): two
    runs with equal digest chains and fingerprints, step 1 within
    ``LOSS_RTOL``/``GNORM_RTOL`` of the plain attention's, the launches a
    step (per layer 2 causal forwards, 1 worker backward, 3 folds); then
    :func:`check_moe_gather`."""
    _free_device_memory()
    train = run_train(TRAIN_MOE_ARGV, label)
    _free_device_memory()
    return dict(train, gather=check_moe_gather())


def _free_device_memory():
    """Drop this process's cached device memory before a subprocess takes
    the card."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 1e9


def _filesystem(path):
    """(mount point, type) of the filesystem holding ``path``."""
    path, best = os.path.realpath(path), ("?", "?")
    with open("/proc/mounts") as f:
        for line in f:
            _, mount, fstype = line.split()[:3]
            if (path == mount or path.startswith(mount.rstrip("/") + "/")) \
                    and len(mount) >= len(best[0]):
                best = (mount, fstype)
    return best


def _mem_available_gb():
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 1e6
    return None


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _launcher(argv, timeout=RESUME_TIMEOUT_S):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                       + argv, env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=timeout)
    return r, time.perf_counter() - t0


def run_train_resume(straight, label="train-resume"):
    """StableLM-1.6B at full width, 12 layers, with ``TRAIN_ARGV``'s flags, as
    two launcher subprocesses: run B saves a checkpoint after every step and
    is killed with ``os._exit(17)`` at the top of step ``RESUME_DIE_AT``
    (step 2's async save possibly in flight); run C resumes from the latest
    durable checkpoint and saves none of its own (nothing would read them).
    Run C's digest chain head must equal ``straight``'s (the first run of
    ``[train]``, in this process), and each of its steps must launch what
    ``[train]``'s did."""
    args, cfg, *_ = launch_train.configure(TRAIN_ARGV)
    want = _train_launches(cfg, args.verify)
    reserved_gb = _free_device_memory()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_",
                                     dir=CKPT_ROOT) as d:
        mount, fstype = _filesystem(d)
        free_before = shutil.disk_usage(d).free
        host_gb = _mem_available_gb()
        chain = ["--verify-out", os.path.join(d, "chain.json")]
        b, b_s = _launcher(TRAIN_ARGV + ["--ckpt-dir", d, "--ckpt-every", "1",
                                         "--ckpt-keep", "1"] + chain
                           + ["--die-at-step", str(RESUME_DIE_AT)])
        if b.returncode != 17:
            raise AssertionError(f"run B exited {b.returncode}, not 17:\n"
                                 f"{b.stdout[-4000:]}\n{b.stderr[-4000:]}")
        after_b = sorted(os.listdir(d))
        durable = CK.available_steps(d)
        ckpt_bytes = {s: _dir_bytes(os.path.join(d, f"step_{s}"))
                      for s in durable}
        b_saves = [dict(step=int(m[1]), snapshot_s=float(m[2]),
                        write_s=float(m[3]), wait_s=float(m[4]))
                   for m in re.finditer(r"\[ckpt\] step (\d+): snapshot "
                                        r"([\d.]+)s, written in ([\d.]+)s "
                                        r"\(([\d.]+)s waited\)", b.stdout)]
        c, c_s = _launcher(TRAIN_ARGV + ["--ckpt-dir", d] + chain
                           + ["--resume"])
        if c.returncode != 0:
            raise AssertionError(f"run C exited {c.returncode}:\n"
                                 f"{c.stdout[-4000:]}\n{c.stderr[-4000:]}")
        resumed = re.search(r"^resumed from step (\d+)$", c.stdout, re.M)
        summary = json.loads(c.stdout.strip().splitlines()[-1])
    k = int(resumed[1]) if resumed else None
    result = dict(
        arch=cfg.name, batch=args.batch, seq=args.seq, steps=args.steps,
        entry="python -m repro_torch.launch.train " + " ".join(TRAIN_ARGV)
        + " --ckpt-dir D --ckpt-every 1 --ckpt-keep 1 --verify-out "
        f"D/chain.json --die-at-step {RESUME_DIE_AT}, then without "
        "--ckpt-every/--ckpt-keep and --resume",
        ckpt_dir_filesystem=dict(mount=mount, type=fstype),
        free_bytes_before=free_before, host_mem_available_gb=host_gb,
        parent_reserved_gb=reserved_gb,
        run_b=dict(exit=b.returncode, seconds=b_s, dir_after=after_b,
                   durable_steps=durable, saves=b_saves),
        checkpoint_bytes=ckpt_bytes, resumed_from=k,
        restore_s=summary.get("restore_s"), run_c_saves=summary.get("ckpt"),
        run_c=dict(exit=c.returncode, seconds=c_s,
                   step_ms=summary["step_ms"],
                   final_loss=summary["final_loss"]),
        launches_per_step=summary.get("launches"),
        digest_chain_head=summary.get("digest_chain_head"),
        straight_head=straight, heads_equal=summary.get(
            "digest_chain_head") == straight)
    print(f"[{label}] " + json.dumps(result), flush=True)
    if k is None or not 1 <= k <= RESUME_DIE_AT or summary["start_step"] != k:
        raise AssertionError(f"run C resumed from {k} (summary "
                             f"{summary.get('start_step')}); expected a "
                             f"durable step in 1..{RESUME_DIE_AT}")
    if not result["heads_equal"]:
        raise AssertionError("the resumed run's digest chain head differs "
                             "from the straight run's")
    if [l for l in summary["launches"] if l != want] or \
            len(summary["launches"]) != args.steps - k:
        raise AssertionError(f"run C's steps launched {summary['launches']},"
                             f" expected {want} for each of "
                             f"{args.steps - k} steps")
    return result


def _lifecycle_config(name):
    """The cell's config on 2 layers and the DASH kernels: at full width
    for a cell of ``LIFECYCLE_FULL_WIDTH``, else at its reduced widths."""
    base = LC.cell_config(name)
    kw = dict(LIFECYCLE, reduced=name not in LIFECYCLE_FULL_WIDTH,
              overrides=base.overrides + LIFECYCLE_OVERRIDES)
    if base.microbatches > LIFECYCLE["batch"]:
        kw["batch"] = base.microbatches
    return dataclasses.replace(base, **kw)


def _lifecycle_launches(lc, cfg):
    """What a cell's runs launch: straight and resume both take ``steps``
    steps; a step runs each layer's forward once per microbatch (twice
    under remat) and its backward and folds once; packed batches take the
    plain segment-masked attention."""
    if lc.packed:
        return _no_launches()
    per = 2 * lc.steps * lc.microbatches * cfg.n_layers
    # a GQA backward folds dK and dV over each group besides the dQ partials
    folds = 3 if cfg.n_kv_heads < cfg.n_heads else 1
    return dict(_no_launches(), fwd_causal=per * (2 if lc.remat else 1),
                bwd_worker=per, fold=folds * per)


def run_lifecycle(label="lifecycle", names=None):
    """Every lifecycle cell (the reference's matrix, plus Adafactor and
    packed documents), or those of ``names``, through straight ≡
    crash/resume on the card."""
    reports = []
    for name in names or list(LC.MATRIX) + list(LC.EXTRA):
        lc = _lifecycle_config(name)
        cfg = lc.model_config()
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        rep = LC.run_cell(name, crash_at=LIFECYCLE_CRASH_AT, device="cuda",
                          lc=lc, tmp_root=CKPT_ROOT)
        torch.cuda.synchronize()
        counts = _counts()
        want = _lifecycle_launches(lc, cfg)
        line = dict(cell=name, heads=rep["heads"],
                    conformant=rep["conformant"],
                    first_divergence=rep["first_divergence"],
                    layers=cfg.n_layers, d_model=cfg.d_model,
                    n_kv_heads=cfg.n_kv_heads, batch=lc.batch, seq=lc.seq,
                    steps=lc.steps, crash_at=LIFECYCLE_CRASH_AT,
                    launches=counts, launches_expected=want,
                    seconds=time.perf_counter() - t0)
        print(f"[{label}] " + json.dumps(line), flush=True)
        reports.append(line)
        if counts != want:
            raise AssertionError(f"lifecycle cell {name} launched {counts}, "
                                 f"expected {want}")
    bad = [r["cell"] for r in reports if not r["conformant"]]
    if bad:
        raise AssertionError(f"lifecycle cells not conformant: {bad}")
    _free_device_memory()
    return reports


def _op_path(q, k, v, do, dtype, kw, ref_kw):
    """One ``dash_attention`` path forward + backward, its launches counted
    from zero, against ``torch_attention(**ref_kw)`` on the same inputs."""
    x = [t.clone().requires_grad_(True) for t in (q, k, v)]
    torch.cuda.synchronize()
    _zero_counts()
    out = ops.dash_attention(*x, **kw)
    grads = torch.autograd.grad(out, x, do)
    torch.cuda.synchronize()
    counts = _counts()
    y = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = ops.torch_attention(*y, **ref_kw)
    ref_grads = torch.autograd.grad(ref, y, do)
    err = [(g.float() - r.float()).abs().max().item()
           for g, r in zip((out,) + grads, (ref,) + ref_grads)]
    ok = (torch.allclose(out.float(), ref.float(), atol=OUT_TOL[dtype],
                         rtol=OUT_TOL[dtype])
          and all(torch.allclose(g.float(), r.float(), **GRAD_TOL[dtype])
                  for g, r in zip(grads, ref_grads)))
    return out.detach(), dict(launches=counts, max_abs_err=dict(
        zip(("out", "dq", "dk", "dv"), err)), ok=ok)


def run_ops():
    """``dash_attention`` forward + backward at the training shape, through
    its default path (causal, worker-parallel + fold) and its two others,
    and at the windowed training shape with the 1024-token window
    (worker-parallel + fold, and serialized), against the plain op at the
    reference's grad tolerances (the window's: masked and query-chunked);
    each path's launches are counted from zero. The window's output must
    also differ from the causal op's beyond the window."""
    name, b, h, hk, s, d, dtype = TRAIN_CASES[0]
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    results = {}
    for label, kw in (("causal_default", dict(causal=True)),
                      ("full_shift", dict(causal=False, schedule="shift")),
                      ("causal_serialized", dict(causal=True,
                                                 worker_parallel=False))):
        _, results[label] = _op_path(q, k, v, do, dtype, kw,
                                     dict(causal=kw["causal"]))
    name, b, h, hk, s, d, dtype = WINDOW_CASE
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    ref_kw = dict(mask=WINDOW, chunk_q=1024)
    out, results["window_default"] = _op_path(q, k, v, do, dtype,
                                              dict(mask=WINDOW), ref_kw)
    _, results["window_serialized"] = _op_path(
        q, k, v, do, dtype, dict(mask=WINDOW, worker_parallel=False), ref_kw)
    with torch.no_grad():
        causal = ops.dash_attention(q, k, v, causal=True)
    beyond = WINDOW.window
    gap = (causal[:, :, beyond:].float() - out[:, :, beyond:].float()).abs()
    results["window_default"]["max_abs_diff_vs_causal_beyond_window"] = (
        gap.max().item())
    window_dropped = gap.max().item() <= OUT_TOL[dtype]
    print("[ops] " + json.dumps(results), flush=True)
    if not all(r["ok"] for r in results.values()):
        raise AssertionError(f"dash_attention disagrees with the plain op: "
                             f"{results}")
    if window_dropped:
        raise AssertionError("the windowed op equals the causal op beyond "
                             "the window: the window was dropped")
    none = _no_launches()
    want = dict(
        causal_default=dict(none, fwd_causal=1, bwd_worker=1, fold=1),
        full_shift=dict(none, fwd_full=1, bwd_worker=1, fold=1),
        causal_serialized=dict(none, fwd_causal=1, bwd_serial=1),
        window_default=dict(none, fwd_mask=1, bwd_worker=1, fold=1),
        window_serialized=dict(none, fwd_mask=1, bwd_serial=1))
    if any(results[k]["launches"] != w for k, w in want.items()):
        raise AssertionError(f"unexpected launches: {results}")
    return results


def _tune_cache(tune_root, name):
    """Point the process-wide tuner store (what ``dash_attention(tune=)``
    and the launcher's ``--tune`` read, in this process and the launcher
    subprocesses) at a fresh directory under this run's temporary root."""
    root = os.path.join(tune_root, name)
    os.environ["REPRO_TORCH_TUNE_CACHE"] = root
    return root


def _tune_geometry(label, b, h, s, d, causal, mask, root):
    """One geometry of ``[tune]``: ``tune_attention(mode="measure")`` over
    every legal candidate, the runner one synchronized fwd + bwd of
    ``dash_attention`` at the candidate's knobs (its host time, what the
    tuner reads, and its device time by CUDA events kept per call); each
    candidate's modeled makespan x B·H beside its measured time; a second
    call a cache hit; ``dash_attention(tune=True)`` equal to the hand-picked
    call bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(len(label))
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    x = [t.clone().requires_grad_(True) for t in (q, k, v)]
    calls = {}

    def runner(cand):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        out = ops.dash_attention(*x, causal=causal, mask=mask,
                                 schedule=cand.schedule, block=cand.block_q,
                                 worker_parallel=cand.worker_parallel)
        torch.autograd.grad(out, x, do)
        end.record()
        torch.cuda.synchronize()
        calls.setdefault(cand.key(), []).append(
            (time.perf_counter() - t0, start.elapsed_time(end)))

    kw = dict(seq=s, head_dim=d, dtype=torch.bfloat16, causal=causal,
              mask=mask, n_heads=h, n_kv_heads=h)
    cands = TUNE.enumerate_candidates(seq_q=s, head_dim=d, causal=causal,
                                      mask=mask)
    ranked = TUNE.rank_candidates(cands, seq_q=s, head_dim=d, causal=causal,
                                  mask=mask)
    cache = TUNE.TuneCache(os.path.join(root, label))
    t0 = time.perf_counter()
    res = TUNE.tune_attention(mode="measure", topk=len(cands), cache=cache,
                              runner=runner, **kw)
    tune_s = time.perf_counter() - t0
    again = TUNE.tune_attention(mode="measure", topk=len(cands), cache=cache,
                                runner=runner, **kw)
    if (again.source, again.candidate) != ("cache", res.candidate):
        raise AssertionError(f"[tune] {label}: the second call gave "
                             f"{again.source} {again.candidate}, not a cache "
                             f"hit on {res.candidate}")
    skip = TUNE_MEASURE.DEFAULT_WARMUP
    rows = []
    for row in ranked:
        key = row["candidate"].key()
        timed = calls[key][skip:]
        modeled_ms = row["modeled_makespan_s"] * b * h * 1e3
        measured_ms = min(t for t, _ in timed) * 1e3
        rows.append(dict(candidate=key, modeled_ms=modeled_ms,
                         measured_ms=measured_ms,
                         device_ms=min(e for _, e in timed),
                         measured_over_modeled=measured_ms / modeled_ms))
        print(f"[tune] {label} {key} modeled_ms={modeled_ms:.6f} "
              f"measured_ms={measured_ms:.4f} "
              f"device_ms={rows[-1]['device_ms']:.4f} "
              f"measured/modeled={measured_ms / modeled_ms:.1f}", flush=True)

    # tuned ≡ hand-picked: the sim pick from the process-wide store
    pick = TUNE.tune_attention(mode="sim", **kw).candidate

    def run(**knobs):
        y = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = ops.dash_attention(*y, causal=causal, mask=mask, **knobs)
        return [out] + list(torch.autograd.grad(out, y, do))

    tuned = run(tune=True)
    hand = run(schedule=pick.schedule, block=pick.block_q,
               worker_parallel=pick.worker_parallel)
    if not all(torch.equal(a, b_) for a, b_ in zip(tuned, hand)):
        raise AssertionError(f"[tune] {label}: dash_attention(tune=True) "
                             f"differs from the hand-picked {pick.key()}")
    by_key = {r["candidate"]: r for r in rows}
    fa3_par = [r["measured_ms"] for k_, r in by_key.items()
               if k_.startswith("fa3|") and "|par|" in k_]
    line = dict(
        geometry=label, batch=b, heads=h, seq=s, head_dim=d, causal=causal,
        mask=mask.key() if mask is not None else None,
        candidates=len(cands), source=res.source,
        measured_winner=res.candidate.key(),
        modeled_winner=ranked[0]["candidate"].key(),
        winner_is_modeled=res.candidate.key() == ranked[0]["candidate"].key(),
        tuner_measured_ms=res.measured_s * 1e3,
        fa3_par_over_winner=(fa3_par[0] / by_key[res.candidate.key()][
            "measured_ms"]) if fa3_par else None,
        sim_pick=pick.key(), tuned_equals_handpicked=True, tune_s=tune_s)
    print("[tune] " + json.dumps(line), flush=True)
    return dict(line, rows=rows)


def _tune_window_schedule():
    """``cached_block_schedule(tune=True)`` at the windowed slice's shape:
    the placement ``pick_placement`` chooses, on the instance a hand-picked
    call gets; the block-sparse forward and the masked worker backward run
    on that schedule directly, equal bit for bit to ``dash_attention`` with
    the same placement."""
    _, b, h, _, s, d, dtype = WINDOW_CASE
    n = s // FF.BLOCK
    placement = TUNE.pick_placement(WINDOW, n, n)
    sch = M.cached_block_schedule(WINDOW, n, n, tune=True)
    if sch is not M.cached_block_schedule(WINDOW, n, n, placement=placement):
        raise AssertionError("cached_block_schedule(tune=True) is not the "
                             "picked placement's schedule")
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn((b * h, s, d), generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    out, lse = FF.flash_fwd(q, k, v, mask=WINDOW, n_heads=h, n_kv_heads=h)
    grads = FB.flash_bwd(q, k, v, out, lse, do, sch, mask=WINDOW, n_heads=h,
                         n_kv_heads=h)
    y = [t.reshape(b, h, s, d).clone().requires_grad_(True) for t in (q, k, v)]
    op_out = ops.dash_attention(*y, mask=WINDOW, schedule=placement)
    op_grads = torch.autograd.grad(op_out, y, do.reshape(b, h, s, d))
    same = torch.equal(out, op_out.reshape(b * h, s, d)) and all(
        torch.equal(g.to(dtype), og.reshape(b * h, s, d))
        for g, og in zip(grads, op_grads))
    if not same:
        raise AssertionError("the kernels on cached_block_schedule(tune="
                             "True) differ from dash_attention's")
    return dict(placement=placement, schedule=sch.name,
                workers=sch.n_workers, bitwise_equal_to_op=same)


def run_tune(tune_root, label="tune"):
    """The tuner on the card: every geometry of ``TUNE_GEOMETRIES`` through
    :func:`_tune_geometry`, the window's placement through
    ``cached_block_schedule(tune=True)``, the sim picks of a fresh process
    with an empty cache against this process's, and the host's
    shared-memory footprints against the built libraries'. Every kernel of
    the tune path must have launched."""
    _free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    root = _tune_cache(tune_root, "tune-phase")
    footprints = {}
    for d in FF.HEAD_DIMS:
        for dtype, nbytes in ((torch.bfloat16, 2), (torch.float32, 4)):
            host = (SMEM.fwd_footprint(FF.BLOCK, FF.BLOCK, d, nbytes).total,
                    SMEM.bwd_footprint(FF.BLOCK, FF.BLOCK, d, nbytes).total)
            lib = (FF.kernel_smem_bytes(d, dtype), FB.smem_bytes(d, dtype))
            footprints[f"d{d}_{str(dtype)[6:]}"] = dict(fwd=host[0],
                                                        bwd=host[1])
            if host != lib:
                raise AssertionError(f"kernels/smem.py says {host} bytes "
                                     f"(fwd, bwd) at d={d} {dtype}; the "
                                     f"libraries launch with {lib}")
    print("[tune] shared memory (fwd, bwd bytes) equal to the libraries' "
          + json.dumps(footprints), flush=True)
    torch.cuda.synchronize()
    _zero_counts()
    geometries = [_tune_geometry(*g, root=os.path.join(root, "measure"))
                  for g in TUNE_GEOMETRIES]
    window = _tune_window_schedule()
    torch.cuda.synchronize()
    launches = _counts()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    fresh = os.path.join(root, "fresh")
    r = subprocess.run([sys.executable, "-c", TUNE_SUBPROCESS, fresh],
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    if r.returncode:
        raise AssertionError(f"[tune] subprocess failed:\n{r.stderr}")
    theirs = json.loads(r.stdout.strip().splitlines()[-1])
    ours = [TUNE.tune_attention(seq=1024, head_dim=64, dtype="bfloat16",
                                causal=True, n_heads=32,
                                cache=TUNE.TuneCache(os.path.join(root, "in"))),
            TUNE.tune_attention(seq=4096, head_dim=64, dtype="bfloat16",
                                mask=WINDOW, n_heads=32,
                                cache=TUNE.TuneCache(os.path.join(root, "in")))]
    ours = [[p.key, p.candidate.key(), p.source] for p in ours]
    result = dict(
        seconds=time.perf_counter() - t0,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches, window_schedule=window,
        subprocess_sim_picks=theirs, subprocess_equal=theirs == ours,
        winners_modeled=sum(g["winner_is_modeled"] for g in geometries),
        geometries=len(geometries))
    print(f"[{label}] " + json.dumps(result), flush=True)
    if theirs != ours:
        raise AssertionError(f"[tune] a fresh process picked {theirs}, this "
                             f"one {ours}")
    # the tune path runs the attention kernels only
    attention = ("fwd_causal", "fwd_full", "fwd_mask", "bwd_worker",
                 "bwd_serial", "fold")
    idle = [k for k in attention if not launches[k]]
    if idle:
        raise AssertionError(f"[tune] the tune path never launched {idle}: "
                             f"{launches}")
    return dict(result, geometry_results=geometries)


def _ms(fn, reps, rounds=5, warmup=3):
    """Median over rounds of the mean time of `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def _queued_ms(fn, reps=50, rounds=5):
    """Like ``_ms``, but the calls are enqueued behind a ~25 ms spin kernel,
    so they run back to back on the card whatever the host's cost a call
    (30-50 µs for the forward's wrapper, more than a kernel of 20 µs)."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def _bound(moved_bytes, flops, dtype, exps=0, tc_flops=0):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    operations over their peak rate: ``flops`` at the dtype's plus
    ``tc_flops`` at the bf16 tensor cores', ``exps`` exponentials at the
    special function units' (all "operations")."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = max(flops / PEAK_FLOPS[dtype]
                + tc_flops / PEAK_FLOPS[torch.bfloat16],
                exps / SFU_EXP_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bound_fwd(q, k, v, causal, block=FF.BLOCK, mask=None):
    """Least time for the forward on these inputs: q, k, v read once, out
    and lse written once, against the live tiles' products (QK^T and PV, 2
    flops per multiply-add; under a mask, the tiles of its grid) at the peak
    rate of the dtype."""
    bh, s, d = q.shape
    sk = k.shape[1]
    moved = (q.numel() + k.numel() + v.numel() + q.numel()) * q.element_size()
    moved += bh * s * 4
    if mask is not None:
        n_tiles = len(FF.mask_grid(mask, s // block, s // block, block,
                                   block)[0])
    elif causal:
        n_tiles = len(FF.causal_grid(s // block, s // block, block, block)[0])
    else:
        n_tiles = (s // block) * (sk // block)
    return _bound(moved, bh * n_tiles * 4 * block * block * d, q.dtype)


def bound_bwd(q, k, schedule, worker, block=FB.BLOCK):
    """Least time for the backward on these inputs: q, k, v, do read once
    (q's dtype), lse and delta read once (fp32), dK/dV written once (fp32)
    and dQ written once — as the visited tiles of the worker partials for
    the worker kernel, as one fp32 array for the serialized one — against
    the live tasks' five products (10·block²·D flops each)."""
    bh, s, d = q.shape
    wc = schedule.worker_chains()
    n_tasks = int(wc["valid"].sum())
    moved = (2 * q.numel() + 2 * k.numel()) * q.element_size() + 2 * bh * s * 4
    moved += 2 * bh * s * d * 4
    if worker:
        moved += bh * int(wc["visited"].sum()) * block * d * 4
    else:
        moved += bh * s * d * 4
    return _bound(moved, bh * n_tasks * 10 * block * block * d, q.dtype)


def bound_fold(part, visited, block=FB.BLOCK):
    """Least time for the fold: the visited partial tiles read once, the
    output written once; one fp32 add per element beyond the first."""
    n, r, s, d = part.shape
    tiles = int(visited.sum())
    moved = n * (tiles + s // block) * block * d * 4
    return _bound(moved, n * (tiles - s // block) * block * d, torch.float32)


def _entry(name, source, replaces, launches, path, err, ms, plain_ms, bound,
           library_ms, tasks=None):
    """One kernel's entry of the ``{"kernels": ...}`` line. The worker
    backward also reports its tasks (over all bh) and the time a task holds
    an SM (ms · SMs / tasks), which compares schedules and masks."""
    t = dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches, launch_path=path, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
             library_ms=library_ms)
    per_task = ""
    if tasks is not None:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        t.update(tasks=tasks, us_per_task_per_sm=ms * 1e3 * sms / tasks)
        per_task = (f", {tasks} tasks, {t['us_per_task_per_sm']:.1f} us a "
                    f"task per SM")
    print(f"[timing] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {'-' if library_ms is None else f'{library_ms:.4f}'} ms, "
          f"bound {bound[0]:.4f} ms ({bound[1]}), {bound[0] / ms:.1%} of "
          f"bound{per_task}", flush=True)
    return t


@torch.inference_mode()
def time_forward(fwd_check, full_check, launches):
    """Both forwards at the training slice's attention shape; the causal one
    also at the serving slice's. Beside ``_ms``, the kernel's and SDPA's
    ``_queued_ms``."""
    entries = []
    for causal in (True, False):
        name, b, h, hk, s, d, dtype = TRAIN_CASES[0]
        q, k, v = _qkv(b, h, hk, s, d, dtype)
        scale = d ** -0.5

        def kernel():
            return FF.flash_fwd_cuda(q, k, v, scale, h, hk, causal)
        q4, k4, v4 = (x.view(b, -1, s, d) for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  is_causal=causal,
                                                  scale=scale)
        ms = _ms(kernel, reps=50)
        plain_ms = _ms(lambda: FF.flash_fwd_plain(q, k, v, scale, h, hk,
                                                  causal), reps=5)
        library_ms = _ms(library, reps=50)
        queued = dict(queued_ms=_queued_ms(kernel),
                      library_queued_ms=_queued_ms(library))
        print(f"[timing] {'causal' if causal else 'full-mask'} forward, "
              f"calls queued: kernel {queued['queued_ms']:.4f} ms, library "
              f"{queued['library_queued_ms']:.4f} ms", flush=True)
        if causal:
            err = next(c for c in fwd_check if c["case"] == "train")
            entries.append(_entry(
                "flash_fwd_causal", "src/repro_torch/kernels/csrc/flash_fwd.cu",
                "src/repro/kernels/flash_fwd.py:177", launches["fwd_causal"],
                "train step (remat: 2 per layer)", err["max_abs_err_out"], ms,
                plain_ms, bound_fwd(q, k, v, True), library_ms))
            entries[-1].update(queued)
        else:
            err = next(c for c in full_check if c["case"] == "train")
            entries.append(_entry(
                "flash_fwd_full", "src/repro_torch/kernels/csrc/flash_fwd.cu",
                "src/repro/kernels/flash_fwd.py:157", launches["fwd_full"],
                "dash_attention(causal=False, schedule='shift') fwd + bwd",
                err["max_abs_err_out"], ms, plain_ms,
                bound_fwd(q, k, v, False), library_ms))
            entries[-1].update(queued)
    name, b, h, hk, s, d, dtype = KERNEL_CASES[0]
    q, k, v = _qkv(b, h, hk, s, d, dtype)
    q4, k4, v4 = (x.view(b, -1, s, d) for x in (q, k, v))

    def kernel():
        return FF.flash_fwd_cuda(q, k, v, d ** -0.5, h, hk)

    def library():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              scale=d ** -0.5)
    serving = dict(serving_shape_ms=_ms(kernel, reps=50),
                   serving_shape_library_ms=_ms(library, reps=50),
                   serving_shape_queued_ms=_queued_ms(kernel),
                   serving_shape_library_queued_ms=_queued_ms(library),
                   serving_shape_bound_ms=bound_fwd(q, k, v, True)[0])
    print(f"[timing] flash_fwd_causal at the serving slice's shape B={b} "
          f"H={h} S={s} D={d}: " + json.dumps(serving), flush=True)
    entries[0].update(serving)
    return entries


def time_backward(bwd_check, launches):
    """The worker backward, the serialized backward and the fold at the
    training slice's attention shape, on its default causal schedule."""
    name, b, h, hk, s, d, dtype = TRAIN_CASES[0]
    q, k, v, do, out, lse, delta = _bwd_operands(b, h, hk, s, d, dtype, True,
                                                 seed=2)
    scale = d ** -0.5
    schedule = cached_schedule("symmetric_shift", s // FB.BLOCK, n_heads=1,
                               causal=True)
    wc = schedule.worker_chains()
    visited = torch.from_numpy(wc["visited"]).cuda()
    args = (q, k, v, do, lse, delta)
    worker_ms = _ms(lambda: FB.worker_bwd_cuda(*args, schedule, scale, True,
                                               h, hk), reps=10)
    serial_ms = _ms(lambda: FB.serial_bwd_cuda(*args, schedule, scale, True,
                                               h, hk), reps=3)
    part = FB.worker_bwd_cuda(*args, schedule, scale, True, h, hk)[0]
    fold_ms = _ms(lambda: FB.fold_cuda(part, visited, FB.BLOCK), reps=50)
    worker_plain_ms = _ms(lambda: FB.worker_bwd_plain(
        *args, wc, scale, True, FB.BLOCK, FB.BLOCK, h, hk), reps=2, rounds=3)
    kv_ids, q_ids = schedule.prefetch_arrays()
    first = FB.first_visit_flags(kv_ids, q_ids)
    serial_plain_ms = _ms(lambda: FB.serial_bwd_plain(
        *args, kv_ids, q_ids, first, scale, True, FB.BLOCK, FB.BLOCK, h, hk),
        reps=2, rounds=3)
    fold_plain_ms = _ms(lambda: FB.fold_plain(part, visited, FB.BLOCK),
                        reps=5)
    # one PyTorch call for the fold: a sum over the workers, which computes
    # the same function once the tiles no worker visits are zeroed (done
    # here, outside the timing)
    seen = visited.repeat_interleave(FB.BLOCK, 1).bool()[None, :, :, None]
    part0 = part.where(seen, 0.0)
    fold_library_ms = _ms(lambda: torch.sum(part0, dim=1), reps=50)
    fold_vs_sum = (torch.sum(part0, dim=1)
                   - FB.fold_cuda(part, visited, FB.BLOCK)).abs().max().item()
    print(f"[timing] fold vs torch.sum over the zeroed partials: max |diff| "
          f"{fold_vs_sum}", flush=True)
    del part0
    # one PyTorch call for the same function: SDPA's backward (all three
    # grads), through autograd over one retained SDPA graph
    q4, k4, v4 = (x.view(b, -1, s, d).detach().requires_grad_(True)
                  for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                          scale=scale)
    do4 = do.view(b, h, s, d)
    library_ms = _ms(lambda: torch.autograd.grad(sdpa, (q4, k4, v4), do4,
                                                 retain_graph=True), reps=20)
    tasks = b * h * int(wc["valid"].sum())
    errs = next(c for c in bwd_check if c["case"] == "train"
                and c["schedule"] == "symmetric_shift")["max_abs_err"]
    worker_err = max(errs["worker"].values())
    serial_err = max(errs["serial"].values())
    src = "src/repro_torch/kernels/csrc/"
    return [
        _entry("flash_bwd_worker", src + "flash_bwd.cu",
               "src/repro/kernels/flash_bwd.py:249", launches["bwd_worker"],
               "train step (one per layer)", worker_err, worker_ms,
               worker_plain_ms, bound_bwd(q, k, schedule, True), library_ms,
               tasks),
        _entry("flash_bwd_serial", src + "flash_bwd.cu",
               "src/repro/kernels/flash_bwd.py:132", launches["bwd_serial"],
               "dash_attention(causal=True, worker_parallel=False) fwd + bwd",
               serial_err, serial_ms, serial_plain_ms,
               bound_bwd(q, k, schedule, False), library_ms),
        _entry("fold", src + "fold.cu", "src/repro/kernels/flash_bwd.py:380",
               launches["fold"], "train step (dQ combine, one per layer)",
               errs["fold"], fold_ms, fold_plain_ms,
               bound_fold(part, visited), fold_library_ms),
    ]


def time_masks(mask_check, launches):
    """The block-sparse forward and both masked backwards at the windowed
    training slice's attention shape (B=1, H=32, S=4096, D=64, bf16, the
    1024-token window), beside their plain versions and SDPA with the dense
    boolean window mask (forward; backward through autograd)."""
    name, b, h, hk, s, d, dtype = WINDOW_CASE
    scale = d ** -0.5
    q, k, v, do, out, lse, delta = _bwd_operands(b, h, hk, s, d, dtype, False,
                                                 seed=3, mask=WINDOW)
    fwd_ms = _ms(lambda: FF.flash_fwd_mask_cuda(q, k, v, scale, h, hk,
                                                WINDOW), reps=50)
    fwd_plain_ms = _ms(lambda: FF.flash_fwd_plain(q, k, v, scale, h, hk,
                                                  mask=WINDOW), reps=2,
                       rounds=3)
    q4, k4, v4 = (x.view(b, -1, s, d).detach().requires_grad_(True)
                  for x in (q, k, v))
    dense = torch.from_numpy(WINDOW.materialize(s)).cuda()
    with torch.no_grad():
        fwd_library_ms = _ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=dense, scale=scale), reps=20)
    schedule = cached_schedule("shift", s // FB.BLOCK, mask=WINDOW)
    wc = schedule.worker_chains()
    args = (q, k, v, do, lse, delta)
    worker_ms = _ms(lambda: FB.worker_bwd_cuda(*args, schedule, scale, False,
                                               h, hk, WINDOW), reps=10)
    serial_ms = _ms(lambda: FB.serial_bwd_cuda(*args, schedule, scale, False,
                                               h, hk, WINDOW), reps=3)
    worker_plain_ms = _ms(lambda: FB.worker_bwd_plain(
        *args, wc, scale, False, FB.BLOCK, FB.BLOCK, h, hk, WINDOW), reps=1,
        rounds=3, warmup=1)
    kv_ids, q_ids = schedule.prefetch_arrays()
    first = FB.first_visit_flags(kv_ids, q_ids)
    serial_plain_ms = _ms(lambda: FB.serial_bwd_plain(
        *args, kv_ids, q_ids, first, scale, False, FB.BLOCK, FB.BLOCK, h, hk,
        WINDOW), reps=1, rounds=3, warmup=1)
    sdpa = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=dense,
                                          scale=scale)
    do4 = do.view(b, h, s, d)
    bwd_library_ms = _ms(lambda: torch.autograd.grad(
        sdpa, (q4, k4, v4), do4, retain_graph=True), reps=10)
    tasks = b * h * int(wc["valid"].sum())
    window_checks = [c for c in mask_check if c["mask"] == "window"]
    fwd_err = max(c["max_abs_err"]["fwd"] for c in window_checks)
    worker_err = max(max(c["max_abs_err"]["worker"].values())
                     for c in window_checks)
    serial_err = max(max(c["max_abs_err"]["serial"].values())
                     for c in window_checks)
    src = "src/repro_torch/kernels/csrc/"
    return [
        _entry("flash_fwd_mask", src + "flash_fwd.cu",
               "src/repro/kernels/flash_fwd.py:198", launches["fwd_mask"],
               "windowed train step (remat: 2 per layer)", fwd_err, fwd_ms,
               fwd_plain_ms, bound_fwd(q, k, v, False, mask=WINDOW),
               fwd_library_ms),
        _entry("flash_bwd_worker_mask", src + "flash_bwd.cu",
               "src/repro/kernels/flash_bwd.py:249", launches["bwd_worker"],
               "windowed train step (one per layer)", worker_err, worker_ms,
               worker_plain_ms, bound_bwd(q, k, schedule, True),
               bwd_library_ms, tasks),
        _entry("flash_bwd_serial_mask", src + "flash_bwd.cu",
               "src/repro/kernels/flash_bwd.py:132", launches["bwd_serial"],
               "dash_attention(mask=SlidingWindow(1024), "
               "worker_parallel=False) fwd + bwd", serial_err, serial_ms,
               serial_plain_ms, bound_bwd(q, k, schedule, False),
               bwd_library_ms),
    ]


# ------------------------------------------------ the continuous engine slice
def _rand(shape, gen, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _paged_inputs(b, l, h, hk, d, dtype, seed, positions=None, pages=None):
    """Pools of ``b`` rows of ``SERVE_PAGES`` pages (page ``SERVE_PAGE``) at
    permuted physical ids plus ``PAGED_SPARE`` unused ones, a page table, q,
    and positions (``positions``, or each row's last ``l`` up to a seeded
    length)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ps, n_pg = SERVE_PAGE, pages or SERVE_PAGES
    n_pages = b * n_pg + PAGED_SPARE
    kp, vp = (_rand((n_pages, ps, hk, d), gen, dtype) for _ in range(2))
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(
        seed))
    table = perm[:b * n_pg].reshape(b, n_pg).to(torch.int32).cuda()
    q = _rand((b, l, h, d), gen, dtype)
    if positions is None:
        ends = torch.randint(l, n_pg * ps, (b, 1),
                             generator=torch.Generator().manual_seed(seed))
        positions = ends - l + torch.arange(l)
    qpos = torch.as_tensor(positions).to(torch.int32).cuda()
    return q, kp, vp, table, qpos, perm[b * n_pg:]


def check_paged():
    """The paged attention kernel against its plain version, bf16 and fp32:
    decode (4, 1), prefill (1, 32), a 1024-token window, segment ids, GQA
    32/8, at the serve path's width (H=32, D=64, 16-token pages, 1024
    positions a row); and its bits: a permuted page table, trailing pages
    (over NaN-filled unused pages), each row of a co-batched launch equal to
    the row alone, 20 repetitions, and every one of these launches bitwise
    equal to the first design's (``csrc/paged_attn_v1.cu``) on the same
    inputs."""
    results, failed = [], []
    h, d = 32, 64
    cases = [("decode", 4, 1, 32, {}), ("prefill", 1, 32, 32, {}),
             ("window", 2, 32, 32, {"window": 1024}),
             ("gqa_32_8", 4, 1, 8, {}), ("segments", 2, 16, 8, {"seg": 1})]
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, l, hk, kw in cases:
            seed = len(name) + b
            q, kp, vp, table, qpos, spare = _paged_inputs(b, l, h, hk, d,
                                                          dtype, seed)
            args = dict(window=kw.get("window"))
            if kw.get("seg"):
                gen = torch.Generator(device="cuda").manual_seed(seed)
                args["q_segments"] = torch.randint(
                    0, 2, (b, l), generator=gen, device="cuda",
                    dtype=torch.int32)
                args["kv_segments"] = torch.randint(
                    0, 2, kp.shape[:2], generator=gen, device="cuda",
                    dtype=torch.int32)
            v1_equal = []

            def kernel(q=q, kp=kp, vp=vp, table=table, qpos=qpos, **over):
                kw_ = dict(args, **over)
                y = DEC.paged_attention_cuda(q, kp, vp, table, qpos,
                                             d ** -0.5, **kw_)
                v1_equal.append(torch.equal(y, DEC.paged_attention_v1(
                    q, kp, vp, table, qpos, d ** -0.5, **kw_)))
                return y
            out = kernel()
            plain = DEC.paged_attention_plain(q, kp, vp, table, qpos,
                                              d ** -0.5, **args)
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            tol = OUT_TOL[dtype]
            close = torch.allclose(out.float(), plain.float(), atol=tol,
                                   rtol=tol)
            # the same rows over the pages (and their segment ids) moved to
            # other physical ids
            moved = torch.roll(torch.arange(kp.shape[0]), 3).cuda()
            kp2, vp2 = torch.empty_like(kp), torch.empty_like(vp)
            kp2[moved], vp2[moved] = kp, vp
            over = {}
            if "kv_segments" in args:
                over["kv_segments"] = torch.empty_like(args["kv_segments"])
                over["kv_segments"][moved] = args["kv_segments"]
            permuted = torch.equal(kernel(kp=kp2, vp=vp2,
                                          table=moved[table.long()]
                                          .to(torch.int32).contiguous(),
                                          **over), out)
            # trailing table columns over unused pages full of NaN
            kp3, vp3 = kp.clone(), vp.clone()
            kp3[spare.cuda()] = float("nan")
            vp3[spare.cuda()] = float("nan")
            extra = spare[:3].to(torch.int32).cuda().expand(b, 3)
            trailing = torch.equal(kernel(kp=kp3, vp=vp3, table=torch.cat(
                [table, extra], 1).contiguous()), out)
            single = all(torch.equal(kernel(
                q=q[i:i + 1].contiguous(), table=table[i:i + 1].contiguous(),
                qpos=qpos[i:i + 1].contiguous(),
                **({} if "q_segments" not in args else
                   {"q_segments": args["q_segments"][i:i + 1].contiguous()})),
                out[i:i + 1]) for i in range(b))
            reps = all(torch.equal(DEC.paged_attention_cuda(
                q, kp, vp, table, qpos, d ** -0.5, **args), out)
                for _ in range(20))
            v1 = all(v1_equal)
            ok = close and permuted and trailing and single and reps and v1 \
                and bool(torch.isfinite(out).all())
            results.append(dict(case=name, shape=[b, l, h, hk, d, SERVE_PAGE],
                                dtype=str(dtype).split(".")[-1],
                                max_abs_err=err, tol=tol,
                                permuted_pages_bitwise=permuted,
                                trailing_nan_pages_bitwise=trailing,
                                rows_alone_bitwise=single,
                                reps20_bitwise=reps,
                                v1_bitwise_launches=len(v1_equal),
                                v1_bitwise=v1, ok=ok))
            if not ok:
                failed.append(f"{name}/{dtype}")
    print("[kernel-check] paged " + json.dumps(results), flush=True)
    if failed:
        raise AssertionError(f"paged attention failed its checks in {failed}")
    return results


# (name, K, N, shard width) at StableLM-1.6B's widths: the up projection,
# wo and w_down in canonical form, the LM head, wq/wk/wv; then
# Nemotron-4-15B's ([serve-nemotron]): its up projection, w_down as 48
# shards of 512, its LM head over vocab 256000, wq, wk/wv (8 KV heads) and
# wo in canonical form. Between them every bf16 tile the serve paths launch
# (BN 64/32/16, plain and canonical) is held here at a width they use.
GEMM_CASES = [("w_up", 2048, 5632, 0), ("wo_canonical", 2048, 2048, 64),
              ("w_down_canonical", 5632, 2048, 176),
              ("lm_head", 2048, 100352, 0),
              ("wqkv", 2048, 2048, 0),
              ("nemotron_w_up", 6144, 24576, 0),
              ("nemotron_w_down_canonical", 24576, 6144, 512),
              ("nemotron_lm_head", 6144, 256000, 0),
              ("nemotron_wq", 6144, 6144, 0),
              ("nemotron_wkv", 6144, 1024, 0),
              ("nemotron_wo_canonical", 6144, 6144, 128)]
M_VALUES = (1, 3, 4, 32, 64)


def check_gemm():
    """The GEMM kernel against its plain version in bf16 (and fp32 on the
    up projection) at the serve path's widths, with an fp32 and a bf16
    output; each output row bitwise the same at every M of ``M_VALUES`` and
    at another row position, plain and canonical mode; and every one of
    these launches bitwise equal to the first design's
    (``csrc/gemm_v1.cu``) on the same inputs. Prints the bf16 tile
    (BN, BK) of each case: a function of K and N."""
    results, failed = [], []
    gen = torch.Generator(device="cuda").manual_seed(21)
    cases = [(c, torch.bfloat16) for c in GEMM_CASES] + [
        (GEMM_CASES[0], torch.float32), (GEMM_CASES[2], torch.float32)]
    for (name, k, n, width), dtype in cases:
        x = _rand((max(M_VALUES), k), gen, dtype)
        w = _rand((k, n), gen, dtype, 0.02)
        v1_equal = []

        def kernel(xm, out_dtype=None):
            y = GEMM.matmul_cuda(xm, w, out_dtype, width)
            v1_equal.append(torch.equal(
                y, GEMM.matmul_v1(xm, w, out_dtype, width)))
            return y
        y = kernel(x)
        plain = GEMM.matmul_plain(x, w, shard_width=width)
        torch.cuda.synchronize()
        err = (y - plain).abs().max().item()
        close = torch.allclose(y, plain, atol=GEMM_TOL, rtol=GEMM_TOL)
        rows_eq = {m: torch.equal(kernel(x[:m].contiguous()), y[:m])
                   for m in M_VALUES}
        moved = kernel(torch.cat([x[5:9], x[:1]]).contiguous())
        at_row4 = torch.equal(moved[4], y[0])
        cast_err = None
        if dtype == torch.bfloat16:
            yb = kernel(x, torch.bfloat16)
            cast_err = (yb.float() - y).abs().max().item()
            close &= torch.equal(yb, y.to(torch.bfloat16))
            for m in M_VALUES:
                kernel(x[:m].contiguous(), torch.bfloat16)
        v1 = all(v1_equal)
        ok = close and all(rows_eq.values()) and at_row4 and v1
        results.append(dict(case=name, k=k, n=n, shard_width=width,
                            dtype=str(dtype).split(".")[-1],
                            tile_bn_bk=(GEMM.tile(k, n)
                                        if dtype == torch.bfloat16 else None),
                            max_abs_err=err,
                            tol=GEMM_TOL, bf16_out_max_abs_err=cast_err,
                            rows_bitwise_at_m={str(m): v
                                               for m, v in rows_eq.items()},
                            row_moved_bitwise=at_row4,
                            v1_bitwise_launches=len(v1_equal),
                            v1_bitwise=v1, ok=ok))
        if not ok:
            failed.append(f"{name}/{dtype}")
    print("[kernel-check] gemm " + json.dumps(results), flush=True)
    if failed:
        raise AssertionError(f"the GEMM kernel failed its checks in {failed}")
    return results


_INT_VIEWS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _bits(t):
    """An integer view of a float tensor, so that equality compares bits
    (a NaN included); other tensors as they are."""
    return t.view(_INT_VIEWS[t.dtype]) if t.dtype in _INT_VIEWS else t


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


# the row checks' widths: StableLM-1.6B, Mistral-NeMo-12B, Qwen1.5-110B and
# Nemotron-4-15B (d; V), a vocabulary narrower than the log-softmax's 1024
# chains, and one that is no multiple of 4 (the kernel's 4-byte copies and
# stores)
ROW_NORM_WIDTHS = (2048, 5120, 8192, 6144)
ROW_VOCABS = (100352, 131072, 152064, 256000, 1000, 3089)


def _special_logits(v, gen):
    """(max(M_VALUES), V) fp32 logits, the first rows special: 1 the
    sampled path's top-k mask (all but 40 entries -1e30) with a tie at the
    maximum; 2 a tie at the maximum (indices 11 and 7V/10); 3 +inf at one
    index and -inf at five; 4 a NaN inside a chain; 5 a NaN at index 0,
    the head of chain 0; 6 -inf everywhere but one entry; 7 +inf at two
    indices."""
    x = _rand((max(M_VALUES), v), gen, scale=4.0)
    keep = torch.randperm(v, generator=torch.Generator().manual_seed(v))[:40]
    masked = torch.full((v,), -1e30, device="cuda")
    masked[keep] = x[1, keep]
    masked[keep[3]] = masked[keep[17]] = masked.max() + 1.0
    x[1] = masked
    x[2, 11] = x[2, 7 * v // 10] = x[2].max() + 1.0
    x[3, v // 3] = float("inf")
    x[3, [5, v // 7, v // 2, v - 9, v - 1]] = float("-inf")
    x[4, v // 5 + 3] = float("nan")
    x[5, 0] = float("nan")
    x[6] = float("-inf")
    x[6, v // 4] = 2.0
    x[7, v // 6] = x[7, v - 2] = float("inf")
    return x


def check_rows():
    """The row norm (LayerNorm and RMSNorm, bf16 and fp32, d = 2048, 5120,
    8192) and the row log-softmax (fp32, V = 100352, 131072, 152064, 1000,
    3089;
    rows with ties at the maximum, +-inf, the top-k mask's -1e30 and NaNs)
    against their plain versions; each row bitwise the same at every M of
    ``M_VALUES``; and every launch of these checks bitwise equal to the
    first design's (``csrc/rows_v1.cu``) on the same inputs, compared
    through integer views so that NaNs compare too."""
    results, failed = [], []
    gen = torch.Generator(device="cuda").manual_seed(22)
    for d in ROW_NORM_WIDTHS:
        scale = _rand((d,), gen) + 1.0
        bias = _rand((d,), gen)
        for dtype in (torch.bfloat16, torch.float32):
            x = (_rand((max(M_VALUES), d), gen) * 3 + 1).to(dtype)
            for kind, b in (("layernorm", bias), ("rmsnorm", None)):
                v1_equal = []

                def kernel(xm, b=b):
                    y = ROWS.norm_cuda(xm, scale, b)
                    v1_equal.append(_same_bits(y, ROWS.norm_v1(xm, scale, b)))
                    return y
                y = kernel(x)
                plain = ROWS.norm_plain(x, scale, b)
                torch.cuda.synchronize()
                err = (y.float() - plain.float()).abs().max().item()
                close = torch.allclose(y.float(), plain.float(),
                                       atol=OUT_TOL[dtype],
                                       rtol=OUT_TOL[dtype])
                rows_eq = {m: _same_bits(kernel(x[:m].contiguous()), y[:m])
                           for m in M_VALUES}
                v1 = all(v1_equal)
                ok = close and all(rows_eq.values()) and v1
                results.append(dict(kernel="norm", case=kind, d=d,
                                    dtype=str(dtype).split(".")[-1],
                                    max_abs_err=err, tol=OUT_TOL[dtype],
                                    rows_bitwise_at_m={
                                        str(m): e for m, e in rows_eq.items()},
                                    v1_bitwise_launches=len(v1_equal),
                                    v1_bitwise=v1, ok=ok))
                if not ok:
                    failed.append(f"norm/{kind}/d={d}/{dtype}")
    for v in ROW_VOCABS:
        logits = _special_logits(v, gen)
        v1_equal = []

        def kernel(xm):
            lp_, arg_ = ROWS.log_softmax_argmax_cuda(xm)
            ref, ref_arg = ROWS.log_softmax_argmax_v1(xm)
            v1_equal.append(_same_bits(lp_, ref) and torch.equal(arg_,
                                                                 ref_arg))
            return lp_, arg_
        lp, arg = kernel(logits)
        plp, parg = ROWS.log_softmax_argmax_plain(logits)
        torch.cuda.synchronize()
        both = torch.isfinite(lp) & torch.isfinite(plp)
        err = (lp - plp)[both].abs().max().item()
        # torch.argmax takes a NaN as the maximum; the kernel's chains pass
        # over a NaN unless it heads one: rows 4 and 5 are held to v1 only
        no_nan = [i for i in range(logits.shape[0]) if i not in (4, 5)]
        close = torch.allclose(lp, plp, atol=OUT_TOL[torch.float32],
                               rtol=OUT_TOL[torch.float32], equal_nan=True)
        arg_equal = torch.equal(arg[no_nan], parg[no_nan])
        tie = int(arg[2]) == 11
        rows_eq = {}
        for m in M_VALUES:
            sub, sub_arg = kernel(logits[:m].contiguous())
            rows_eq[m] = (_same_bits(sub, lp[:m])
                          and torch.equal(sub_arg, arg[:m]))
        v1 = all(v1_equal)
        ok = close and arg_equal and tie and all(rows_eq.values()) and v1
        results.append(dict(kernel="log_softmax", v=v, dtype="float32",
                            max_abs_err=err, tol=OUT_TOL[torch.float32],
                            argmax_equal=arg_equal, tie_to_lowest_id=tie,
                            argmax_special_rows=[int(a) for a in arg[1:8]],
                            rows_bitwise_at_m={str(m): e for m, e in
                                               rows_eq.items()},
                            v1_bitwise_launches=len(v1_equal),
                            v1_bitwise=v1, ok=ok))
        if not ok:
            failed.append(f"log_softmax/V={v}")
    print("[kernel-check] rows " + json.dumps(results), flush=True)
    if failed:
        raise AssertionError(f"the row kernels failed their checks in "
                             f"{failed}")
    return results


def check_gqa():
    """The GQA groups this slice's models bring, at D=128, S=1024, bf16:
    Llama-4-Scout's 40/8 (a group of 5) and Nemotron-4's 48/8 (a group of
    6). Per case: the causal forward against its plain version; the worker
    backward, the dQ fold and the dK/dV group folds as ``flash_bwd`` runs
    them for the train step, against the plain worker backward and plain
    folds at the reference's grad tolerances, each fold bitwise its plain
    version on the same partials, and a second call bitwise the first. Then
    the paged attention at Nemotron's group (decode (4, 1) and a (1, 32)
    prefill chunk) against its plain version, bitwise its first design, row
    by row and over 20 repetitions."""
    results, failed = [], []
    for name, b, h, hk, s, d, dtype in GQA_CASES:
        g, n = h // hk, s // FB.BLOCK
        q, k, v, do, out, lse, delta = _bwd_operands(b, h, hk, s, d, dtype,
                                                     True, seed=h)
        scale = d ** -0.5
        ref_out, ref_lse = FF.flash_fwd_plain(q, k, v, scale, h, hk, True)
        fwd_err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = ((lse - ref_lse).abs()
                   / ref_lse.abs().clamp_min(1.0)).max().item()
        tol = OUT_TOL[dtype]
        fwd_ok = (torch.allclose(out.float(), ref_out.float(), atol=tol,
                                 rtol=tol) and lse_err <= LSE_RTOL)
        sched = cached_schedule("symmetric_shift", n, n_heads=1, causal=True)
        wc = sched.worker_chains()
        visited = torch.from_numpy(wc["visited"]).cuda()
        ones = torch.ones((g, n), dtype=torch.int32, device="cuda")
        part, dk_h, dv_h = FB.worker_bwd_cuda(q, k, v, do, lse, delta, sched,
                                              scale, True, h, hk)
        dq = FB.fold_cuda(part, visited, FB.BLOCK)
        dk = FB.fold_cuda(dk_h.reshape(b * hk, g, s, d), ones, FB.BLOCK)
        dv = FB.fold_cuda(dv_h.reshape(b * hk, g, s, d), ones, FB.BLOCK)
        folds_bitwise = (
            torch.equal(dq, FB.fold_plain(part, visited, FB.BLOCK))
            and torch.equal(dk, FB.fold_plain(dk_h.reshape(b * hk, g, s, d),
                                              ones, FB.BLOCK))
            and torch.equal(dv, FB.fold_plain(dv_h.reshape(b * hk, g, s, d),
                                              ones, FB.BLOCK)))
        path = FB.flash_bwd(q, k, v, out, lse, do, sched, causal=True,
                            sm_scale=scale, n_heads=h, n_kv_heads=hk)
        again = FB.flash_bwd(q, k, v, out, lse, do, sched, causal=True,
                             sm_scale=scale, n_heads=h, n_kv_heads=hk)
        path_bitwise = all(torch.equal(x, y) for x, y in zip(path,
                                                             (dq, dk, dv)))
        reps_bitwise = all(torch.equal(x, y) for x, y in zip(again, path))
        ppart, pdk, pdv = FB.worker_bwd_plain(q, k, v, do, lse, delta, wc,
                                              scale, True, FB.BLOCK, FB.BLOCK,
                                              h, hk)
        plain = (FB.fold_plain(ppart, visited, FB.BLOCK),
                 FB.fold_plain(pdk.reshape(b * hk, g, s, d), ones, FB.BLOCK),
                 FB.fold_plain(pdv.reshape(b * hk, g, s, d), ones, FB.BLOCK))
        torch.cuda.synchronize()
        err = {k_: (x - y).abs().max().item()
               for k_, x, y in zip(("dq", "dk", "dv"), (dq, dk, dv), plain)}
        close = all(torch.allclose(x, y, **GRAD_TOL[dtype])
                    for x, y in zip((dq, dk, dv), plain))
        finite = all(bool(torch.isfinite(x).all()) for x in (out, dq, dk, dv))
        ok = (fwd_ok and close and folds_bitwise and path_bitwise
              and reps_bitwise and finite)
        results.append(dict(kernel="causal_fwd+worker_bwd+fold", case=name,
                            shape=[b, h, hk, s, d], group=g,
                            dtype=str(dtype).split(".")[-1],
                            fwd_max_abs_err=fwd_err, lse_max_rel_err=lse_err,
                            fwd_tol=tol, bwd_max_abs_err=err,
                            bwd_tol=GRAD_TOL[dtype],
                            folds_bitwise_eq_plain=folds_bitwise,
                            flash_bwd_bitwise_eq_kernels=path_bitwise,
                            flash_bwd_twice_bitwise=reps_bitwise, ok=ok))
        if not ok:
            failed.append(name)
    h, hk, d = GQA_PAGED
    for name, b, l in (("decode", 4, 1), ("prefill_chunk", 1, SERVE_CHUNK)):
        dtype = torch.bfloat16
        q, kp, vp, table, qpos, _ = _paged_inputs(b, l, h, hk, d, dtype,
                                                  seed=h + l)
        out = DEC.paged_attention_cuda(q, kp, vp, table, qpos, d ** -0.5)
        plain = DEC.paged_attention_plain(q, kp, vp, table, qpos, d ** -0.5)
        v1 = torch.equal(out, DEC.paged_attention_v1(q, kp, vp, table, qpos,
                                                     d ** -0.5))
        single = all(torch.equal(DEC.paged_attention_cuda(
            q[i:i + 1].contiguous(), kp, vp, table[i:i + 1].contiguous(),
            qpos[i:i + 1].contiguous(), d ** -0.5), out[i:i + 1])
            for i in range(b))
        reps = all(torch.equal(DEC.paged_attention_cuda(
            q, kp, vp, table, qpos, d ** -0.5), out) for _ in range(20))
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs().max().item()
        tol = OUT_TOL[dtype]
        ok = (torch.allclose(out.float(), plain.float(), atol=tol, rtol=tol)
              and v1 and single and reps and bool(torch.isfinite(out).all()))
        results.append(dict(kernel="paged_attention", case=name,
                            shape=[b, l, h, hk, d, SERVE_PAGE], group=h // hk,
                            dtype="bfloat16", max_abs_err=err, tol=tol,
                            v1_bitwise=v1, rows_alone_bitwise=single,
                            reps20_bitwise=reps, ok=ok))
        if not ok:
            failed.append(f"paged/{name}")
    print("[kernel-check] gqa " + json.dumps(results), flush=True)
    if failed:
        raise AssertionError(f"GQA kernel checks failed in {failed}")
    return results


def _fp_leaf(dtype, n, gen):
    """A leaf of ``n`` elements of ``dtype`` whose every bit is data."""
    raw = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                        device="cuda", dtype=torch.int64)
    if dtype == torch.bool:
        return raw % 2 == 0
    if dtype.is_floating_point:
        return raw.to(torch.int32).view(torch.float32).nan_to_num().to(dtype)
    return raw.to(dtype)


def _fp_state():
    """The full-width StableLM-1.6B AdamW train state (``init_state`` from
    seed 0, ~16 GB on the card) with the moments drawn from a seed, so every
    byte the fingerprint reads is data."""
    cfg = registry.get("stablelm-1.6b").replace(attention_impl="cuda")
    state = TS.init_state(cfg, TS.TrainConfig(), seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    for leaf in O.tree_leaves(state["opt"]):
        leaf.normal_(generator=gen)
    return state


def check_fingerprint():
    """``csrc/fingerprint.cu`` against its plain version, exactly (uint32
    ``==``): leaves of every covered dtype at 0-dim, 1, 7, 1000 and 2^20+3
    elements, each also as views 1 and 3 elements in (unaligned: the
    kernel's element-by-element path), launched as one tree; then the
    full-width train state, leaf by leaf, where a one-bit flip and a swap of
    two unequal elements must each change the tree's fingerprint. Times the
    kernel there (``_queued_ms``; the wrapper's whole call beside it) and
    its plain version, with the state's bytes over the memory rate as the
    bound. No single PyTorch call computes this function, so it has no
    library time."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    leaves, names = [], []
    for dtype in FPK.KINDS:
        for n in FP_SIZES:
            x = _fp_leaf(dtype, n + 3, gen)
            for off in (0, 1, 3):
                leaves.append(x[off:off + n])
                names.append(f"{dtype}/{n}/+{off}")
        leaves.append(_fp_leaf(dtype, 1, gen).reshape(()))
        names.append(f"{dtype}/0-dim")
    got = FPK.leaf_fingerprints_cuda(leaves)
    plain = [FPK.fingerprint_plain(x) for x in leaves]
    small_bad = [n for n, g, w in zip(names, got, plain) if g != w]
    unaligned = sum(1 for x in leaves if x.data_ptr() % 16)
    del leaves

    state = _fp_state()
    named = sorted(tree_paths(state), key=lambda kv: kv[0])
    flat = [x for _, x in named]
    nbytes = sum(x.numel() * x.element_size() for x in flat)
    n_elem = sum(x.numel() for x in flat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = FPK.leaf_fingerprints_cuda(flat)
    call_first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain = [FPK.fingerprint_plain(x) for x in flat]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    state_bad = [p for (p, _), g, w in zip(named, got, plain) if g != w]
    base = DG.tree_fingerprint(state)
    emb = state["params"]["embed"]["tok"].view(-1)
    emb.view(torch.int16)[12345] ^= 1                     # one bit
    flipped = DG.tree_fingerprint(state)
    emb.view(torch.int16)[12345] ^= 1
    i, j = 7, 100_000
    m = O.tree_leaves(state["opt"])[0].view(-1)
    if bool(m[i] == m[j]):
        raise AssertionError("the swap's two elements are equal")
    m[[i, j]] = m[[j, i]]
    swapped = DG.tree_fingerprint(state)
    m[[i, j]] = m[[j, i]]
    restored = DG.tree_fingerprint(state)
    # the launch alone, with the plan (pointers, tables, buffers) made once:
    # the whole call copies the pointers in and the values out, which a
    # queued timing cannot overlap
    plan = FPK.plan_cuda(flat)
    ms = _queued_ms(lambda: FPK.launch_cuda(plan), reps=10)
    call_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        DG.tree_fingerprint(state)
        call_ms.append((time.perf_counter() - t0) * 1e3)
    bound = _bound(nbytes + 4 * len(flat), 2 * n_elem, torch.float32)
    result = dict(
        small_leaves=len(names), small_mismatched=small_bad,
        unaligned_views=unaligned, state_leaves=len(flat),
        state_bytes=nbytes, state_elements=n_elem,
        state_mismatched=state_bad, tree_fingerprint=base,
        bit_flip_changes=flipped != base, swap_changes=swapped != base,
        restored_equal=restored == base, ms=ms,
        call_ms_median=statistics.median(call_ms), call_ms=call_ms,
        call_first_ms=call_first_ms, plain_ms=plain_ms,
        bound_ms=bound[0], bound_by=bound[1])
    print("[kernel-check] fingerprint " + json.dumps(result), flush=True)
    print(f"[timing] fingerprint ({len(flat)} leaves, {nbytes / 1e9:.2f} "
          f"GB): kernel {ms:.4f} ms, whole call {result['call_ms_median']:.3f}"
          f" ms, plain {plain_ms:.1f} ms, library - ms, bound {bound[0]:.4f}"
          f" ms ({bound[1]}), {bound[0] / ms:.1%} of bound", flush=True)
    del state, named, flat, emb, m, plan
    _free_device_memory()
    if small_bad or state_bad:
        raise AssertionError(f"fingerprint kernel != its plain version: "
                             f"{small_bad[:5]} {state_bad[:5]}")
    if not (result["bit_flip_changes"] and result["swap_changes"]
            and result["restored_equal"]):
        raise AssertionError(f"fingerprint blind to a flip or a swap: "
                             f"{result}")
    return result


# the main paths' shapes: the train slice's mamba layer (B=1, S=4096, chunk
# 512: 8 chunks) and the serve slice's decode step (B=4)
SCAN_TRAIN = (1, 4096, 16384, 512)
SCAN_DECODE = (4, 16384)
# [kernel-check] scan: csrc/selective_scan.cu against its plain version.
# (B, S, Din, chunk, z dtype, grads): two small ragged shapes (a partial tile
# and a partial chunk, both dtypes), Jamba's layer at the train slice's
# shape, both z dtypes (the plain version's autograd keeps ~4 MB a step, ~16
# GB at S = 4096, and is run there alone), and the serve slice's batch 4 at
# its prompt length (forward only)
SCAN_CASES = [("ragged_fp32", 2, 100, 256, 32, torch.float32, True),
              ("ragged_bf16", 2, 100, 256, 32, torch.bfloat16, True),
              ("jamba_layer", *SCAN_TRAIN, torch.bfloat16, True),
              ("jamba_layer_fp32", *SCAN_TRAIN, torch.float32, True),
              ("jamba_prefill", 4, 512, 16384, 512, torch.bfloat16, False)]
# |kernel - plain| <= tol * max(1, max|plain|), per output: fp32 sums taken
# in another order (the sum over the 16 states, fma vs mul+add, dB/dC over
# 16384 channels, dA/dD over 4096 steps); bf16 y and dz: one rounding apart
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# prefill then decode vs the full pass (the reference's
# tests/test_models_numerics.py limits)
SCAN_SPLIT_TOL = dict(atol=2e-4, rtol=2e-3)
# flops a (step, channel, state) beside its exponentials: forward dt*A,
# dtu*B, the state's fma, the output's fma (6); backward the state
# recomputed (4) and the reverse step's (14). Exponentials, on the special
# function units (SFU_EXP_PER_S): at least one a (step, channel, state)
# each way (the backward's reverse step needs exp(dt*A), which the forward
# does not keep)
SCAN_FWD_FLOPS, SCAN_BWD_FLOPS = 6, 18


def _scan_inputs(b, s, din, dtype, seed):
    """Operands at a Mamba layer's magnitudes: u a SiLU output, dt a
    softplus, A = -exp(A_log) with A_log in [-1, 1], B, C, D, z, dy ~ N(0,
    1), a carried state h0 and a last-state gradient."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    n = SCAN.STATE
    return dict(
        u=F.silu(r(b, s, din)), dt=F.softplus(r(b, s, din) - 1.0),
        A=-torch.exp(torch.rand((din, n), generator=gen, device="cuda")
                     * 2 - 1),
        B=r(b, s, n), C=r(b, s, n), D=r(din), z=r(b, s, din).to(dtype),
        h0=0.5 * r(b, din, n)), r(b, s, din).to(dtype), 0.1 * r(b, din, n)


_SCAN_ARGS = ("u", "dt", "A", "B", "C", "D", "z", "h0")


def _scan_plain_grads(x, dy, dh_last):
    """The plain version's outputs and, by autograd, the grads of
    sum(y * dy) + sum(h_last * dh_last) w.r.t. u, dt, A, B, C, D, z."""
    leaves = {k: (v.detach().requires_grad_(k != "h0"))
              for k, v in x.items()}
    y, h_last = SCAN.selective_scan_plain(*(leaves[k] for k in _SCAN_ARGS))
    loss = (y.float() * dy.float()).sum() + (h_last * dh_last).sum()
    names = [k for k in _SCAN_ARGS if k != "h0"]
    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    return y.detach(), h_last.detach(), dict(zip(names, grads))


def _scan_err(got, want, abs_err=None):
    """max |got - want| / max(1, max |want|); the unscaled max |got -
    want| goes into ``abs_err`` (a list) when given."""
    diff = float((got.float() - want.float()).abs().max())
    if abs_err is not None:
        abs_err.append(diff)
    return diff / max(1.0, float(want.float().abs().max()))


def _scan_vs_v1(name, args, chunk, dtype, got, grads=None):
    """The redesign against its first design (``csrc/selective_scan_v1.cu``)
    on the same inputs: ``h_last`` and ``h_chk`` ``torch.equal``, y and, with
    ``grads`` = (dy, dh_last, the redesign's ``scan_bwd_cuda`` outputs),
    every gradient within ``SCAN_TOL`` (a sum over the 16 states and one over
    the channels taken in another order). One ``[kernel-check] scan v1``
    line."""
    y, h_last, h_chk = got
    y1, h1, hc1 = SCAN.scan_fwd_v1_cuda(*args, chunk)
    line = dict(case=name, h_last_equal=bool(torch.equal(h_last, h1)),
                h_chk_equal=bool(torch.equal(h_chk, hc1)),
                err=dict(y=_scan_err(y, y1)), tol=dict(y=SCAN_TOL[dtype]))
    if grads is not None:
        dy, dh_last, g = grads
        du, ddt, dz, dh0, bc_part, ad_part = SCAN.scan_bwd_partials_v1_cuda(
            *args, dy, hc1, chunk, dh_last)
        bc, ad = SCAN.fold_plain(bc_part, ad_part)
        n, din = SCAN.STATE, args[0].shape[-1]
        want = dict(u=du, dt=ddt, A=ad[:din * n].view(din, n),
                    B=bc[..., :n], C=bc[..., n:], D=ad[din * n:], z=dz,
                    h0=dh0)
        for k, v in zip(("u", "dt", "A", "B", "C", "D", "z", "h0"), g):
            line["err"]["d" + k] = _scan_err(v, want[k])
            line["tol"]["d" + k] = SCAN_TOL[dtype if k == "z"
                                            else torch.float32]
    line["ok"] = (line["h_last_equal"] and line["h_chk_equal"] and all(
        line["err"][k] <= line["tol"][k] for k in line["err"]))
    print("[kernel-check] scan v1 " + json.dumps(line), flush=True)
    return line


def check_scan():
    """``csrc/selective_scan.cu`` against its plain version on the card:
    the forward's y and last state, and the backward's du, ddt, dA, dB, dC,
    dD, dz (through the fold) against the plain version's autograd, at each
    of ``SCAN_CASES``; 10 repeated launches of each kernel bitwise; the
    fold against its plain version bitwise; prefill then one-step decodes
    with the carried state equal to the full pass; the decode step at the
    serve shape against plain. At every case, the split and the decode it
    also holds the kernels to their first design (``_scan_vs_v1``: states
    bitwise). Each grads case also times the plain version (``plain_ms``
    its forward alone, ``plain_grads_ms`` forward and autograd backward:
    one call each, it walks S steps from Python)."""
    results, failed, v1_lines = [], [], []
    for name, b, s, din, chunk, dtype, grads in SCAN_CASES:
        x, dy, dh_last = _scan_inputs(b, s, din, dtype, seed=s + din)
        args = [x[k] for k in _SCAN_ARGS]
        y, h_last, h_chk = SCAN.scan_fwd_cuda(*args, chunk)
        times = {}
        if grads:
            with torch.no_grad():
                times["plain_ms"] = _ms(
                    lambda: SCAN.selective_scan_plain(*args), reps=1,
                    rounds=1, warmup=1)
            t0 = time.perf_counter()
            yp, hp, gp = _scan_plain_grads(x, dy, dh_last)
            torch.cuda.synchronize()
            times["plain_grads_ms"] = (time.perf_counter() - t0) * 1e3
        else:
            with torch.no_grad():
                yp, hp = SCAN.selective_scan_plain(*args)
        abs_y, abs_grads = [], []
        err = dict(y=_scan_err(y, yp, abs_y), h_last=_scan_err(h_last, hp))
        tol = dict(y=SCAN_TOL[dtype], h_last=SCAN_TOL[torch.float32])
        reps = dict(fwd=all(torch.equal(y, SCAN.scan_fwd_cuda(
            *args, chunk)[0]) for _ in range(10)))
        if grads:
            g = SCAN.scan_bwd_cuda(*args, dy, h_chk, chunk, dh_last)
            got = dict(zip(("u", "dt", "A", "B", "C", "D", "z"), g[:7]))
            for k, v in got.items():
                err["d" + k] = _scan_err(v, gp[k], abs_grads)
                tol["d" + k] = SCAN_TOL[dtype if k == "z" else torch.float32]
            reps["bwd"] = all(
                all(torch.equal(a, b_) for a, b_ in zip(g, SCAN.scan_bwd_cuda(
                    *args, dy, h_chk, chunk, dh_last))) for _ in range(10))
            _, _, _, _, bc_part, ad_part = SCAN.scan_bwd_partials_cuda(
                *args, dy, h_chk, chunk, dh_last)
            folded = SCAN.scan_fold_cuda(bc_part, ad_part)
            plain_fold = SCAN.fold_plain(bc_part, ad_part)
            reps["fold_vs_plain"] = all(torch.equal(a, b_) for a, b_ in
                                        zip(folded, plain_fold))
            del got, gp, bc_part, ad_part, folded, plain_fold
        v1_lines.append(_scan_vs_v1(name, args, chunk, dtype,
                                    (y, h_last, h_chk),
                                    (dy, dh_last, g) if grads else None))
        if grads:
            del g
        ok = (all(err[k] <= tol[k] for k in err) and all(reps.values()))
        line = dict(case=name, B=b, S=s, Din=din, chunk=chunk,
                    dtype=str(dtype), err=err, tol=tol, bitwise=reps, ok=ok,
                    max_abs_err_y=abs_y[0],
                    max_abs_err_grads=max(abs_grads, default=None), **times)
        print("[kernel-check] scan " + json.dumps(line), flush=True)
        results.append(line)
        if not ok:
            failed.append(name)
        del x, dy, dh_last, args, y, h_last, h_chk, yp, hp
    split = _scan_split()
    decode = _scan_decode()
    _free_device_memory()
    not_v1 = [line["case"] for line in v1_lines if not line["ok"]]
    if failed or not split["ok"] or not decode["ok"] or not_v1:
        raise AssertionError(f"scan kernels vs plain failed: {failed}, "
                             f"split {split['ok']}, decode {decode['ok']}; "
                             f"vs their first design: {not_v1}")
    return dict(cases=results, split=split, decode=decode, v1=v1_lines)


@torch.no_grad()
def _scan_split():
    """Prefill of S - 8 steps, then 8 one-step launches carrying the state
    (the decode path), against one launch over all S: within the
    reference's limits, and whether bitwise."""
    b, s, din = 4, 512, 16384
    x, _, _ = _scan_inputs(b, s, din, torch.bfloat16, seed=11)
    args = [x[k] for k in _SCAN_ARGS]
    p = s - 8

    def split(fwd):
        def part(lo, hi, h0):
            sl = {k: (v[:, lo:hi].contiguous()
                      if k in ("u", "dt", "B", "C", "z") else v)
                  for k, v in x.items()}
            sl["h0"] = h0
            return fwd(*(sl[k] for k in _SCAN_ARGS), 512,
                       keep_states=False)[:2]
        ys, h = [], x["h0"]
        y, h = part(0, p, h)
        ys.append(y)
        for t in range(p, s):
            y, h = part(t, t + 1, h)
            ys.append(y)
        return torch.cat(ys, 1), h
    full, h_full, _ = SCAN.scan_fwd_cuda(*args, 512, keep_states=False)
    got, h = split(SCAN.scan_fwd_cuda)
    ok = bool(torch.allclose(got.float(), full.float(), **SCAN_SPLIT_TOL)
              and torch.allclose(h, h_full, **SCAN_SPLIT_TOL))
    line = dict(B=b, prefill=p, decode_steps=s - p, Din=din,
                max_abs_err=float((got.float() - full.float()).abs().max()),
                state_max_abs_err=float((h - h_full).abs().max()),
                bitwise=bool(torch.equal(got, full) and torch.equal(h, h_full)),
                ok=ok)
    print("[kernel-check] scan split " + json.dumps(line), flush=True)
    # the first design over the same split and the full pass
    got1, h1 = split(SCAN.scan_fwd_v1_cuda)
    full1, h_full1, _ = SCAN.scan_fwd_v1_cuda(*args, 512, keep_states=False)
    tol = SCAN_TOL[torch.bfloat16]
    v1 = dict(case="split", h_last_equal=bool(torch.equal(h, h1)),
              full_h_last_equal=bool(torch.equal(h_full, h_full1)),
              err=dict(y=_scan_err(got, got1), full_y=_scan_err(full, full1)),
              tol=dict(y=tol, full_y=tol))
    v1["ok"] = (v1["h_last_equal"] and v1["full_h_last_equal"]
                and max(v1["err"].values()) <= tol)
    print("[kernel-check] scan v1 " + json.dumps(v1), flush=True)
    line["v1"] = v1
    line["ok"] = ok and v1["ok"]
    return line


@torch.no_grad()
def _scan_decode():
    """The decode step at the serve shape (S = 1, a carried state) against
    plain, and its time."""
    b, din = SCAN_DECODE
    x, _, _ = _scan_inputs(b, 1, din, torch.bfloat16, seed=12)
    args = [x[k] for k in _SCAN_ARGS]
    y, h, _ = SCAN.scan_fwd_cuda(*args, 512, keep_states=False)
    yp, hp = SCAN.selective_scan_plain(*args)
    err = dict(y=_scan_err(y, yp), h_last=_scan_err(h, hp))
    ok = err["y"] <= SCAN_TOL[torch.bfloat16] and err["h_last"] <= SCAN_TOL[
        torch.float32]
    y1, h1, _ = SCAN.scan_fwd_v1_cuda(*args, 512, keep_states=False)
    v1 = dict(case="decode", h_last_equal=bool(torch.equal(h, h1)),
              err=dict(y=_scan_err(y, y1)),
              tol=dict(y=SCAN_TOL[torch.bfloat16]))
    v1["ok"] = v1["h_last_equal"] and v1["err"]["y"] <= v1["tol"]["y"]
    print("[kernel-check] scan v1 " + json.dumps(v1), flush=True)
    ms, v1_ms = _turns_ms(
        lambda: SCAN.scan_fwd_cuda(*args, 512, keep_states=False),
        lambda: SCAN.scan_fwd_v1_cuda(*args, 512, keep_states=False))
    plain_ms = _ms(lambda: SCAN.selective_scan_plain(*args), reps=20)
    moved = b * din * (4 + 4 + 2 + 2 + 2 * 4 * SCAN.STATE) + din * (
        SCAN.STATE + 1) * 4 + 2 * b * SCAN.STATE * 4
    bound = _bound(moved, SCAN_FWD_FLOPS * b * din * SCAN.STATE,
                   torch.float32, exps=b * din * SCAN.STATE)
    line = dict(B=b, Din=din, err=err, ok=ok and v1["ok"], ms=ms,
                v1_ms=v1_ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], v1=v1)
    print("[kernel-check] scan decode " + json.dumps(line), flush=True)
    return line


def _scan_bound(b, s, din, backward, z_bytes=2):
    """Least time for the scan at (b, s, din): each input read once and
    each output written once (forward: u, dt, z, B, C, A, D, h0 in; y,
    h_last and the kept states out; backward: those and dy in, du, ddt, dz,
    dA, dB, dC, dD out), against SCAN_{FWD,BWD}_FLOPS a state a step at
    the fp32 rate and one exponential a state a step at the SFU's."""
    n = SCAN.STATE
    per_tok = b * s * din
    states = b * din * n * 4
    if backward:
        moved = per_tok * (4 + 4 + 2 * z_bytes + 4 + 4 + z_bytes) + 4 * (
            b * s * n * 4) + 2 * din * (n + 1) * 4 + states * (
            2 + SCAN.n_chunks(s, SCAN_TRAIN[3]))
        flops = SCAN_BWD_FLOPS * per_tok * n
    else:
        moved = per_tok * (4 + 4 + 2 * z_bytes) + 2 * b * s * n * 4 + din * (
            n + 1) * 4 + states * (2 + SCAN.n_chunks(s, SCAN_TRAIN[3]))
        flops = SCAN_FWD_FLOPS * per_tok * n
    return _bound(moved, flops, torch.float32, exps=per_tok * n)


def time_scan(scan_check, launches):
    """The three scan kernels at the train slice's mamba shape (and the
    forward at the serve prefill's), beside the plain version's times that
    ``check_scan`` took there (its ``jamba_layer`` case) and, for the fold,
    ``torch.sum`` of each partial — the ``{"kernels": ...}`` entries."""
    b, s, din, chunk = SCAN_TRAIN
    jamba = {c["case"]: c for c in scan_check["cases"]}["jamba_layer"]
    assert (jamba["B"], jamba["S"], jamba["Din"], jamba["chunk"]) == SCAN_TRAIN
    plain_fwd_ms = jamba["plain_ms"]
    plain_bwd_ms = jamba["plain_grads_ms"] - plain_fwd_ms
    x, dy, _ = _scan_inputs(b, s, din, torch.bfloat16, seed=13)
    args = [x[k] for k in _SCAN_ARGS]
    with torch.no_grad():
        fwd_ms, fwd_v1_ms = _turns_ms(
            lambda: SCAN.scan_fwd_cuda(*args, chunk),
            lambda: SCAN.scan_fwd_v1_cuda(*args, chunk), reps=10)
        _, _, h_chk = SCAN.scan_fwd_cuda(*args, chunk)
        bwd_ms, bwd_v1_ms = _turns_ms(
            lambda: SCAN.scan_bwd_partials_cuda(*args, dy, h_chk, chunk),
            lambda: SCAN.scan_bwd_partials_v1_cuda(*args, dy, h_chk, chunk),
            reps=5)
        part = SCAN.scan_bwd_partials_cuda(*args, dy, h_chk, chunk)
        fold_ms = _queued_ms(lambda: SCAN.scan_fold_cuda(part[4], part[5]),
                             reps=20)
        fold_library_ms = _queued_ms(lambda: (part[4].sum(1),
                                              part[5].sum(0)), reps=20)
    plain_fold_ms = _ms(lambda: SCAN.fold_plain(part[4], part[5]), reps=3)
    fold_moved = (part[4].numel() + part[5].numel()) * 4 + (
        b * s * 2 * SCAN.STATE + din * (SCAN.STATE + 1)) * 4
    fold_bound = _bound(fold_moved, part[4].numel() + part[5].numel(),
                        torch.float32)
    pb, ps = 4, 512
    xp, _, _ = _scan_inputs(pb, ps, din, torch.bfloat16, seed=14)
    argsp = [xp[k] for k in _SCAN_ARGS]
    with torch.no_grad():
        prefill_ms, prefill_v1_ms = _turns_ms(
            lambda: SCAN.scan_fwd_cuda(*argsp, chunk, keep_states=False),
            lambda: SCAN.scan_fwd_v1_cuda(*argsp, chunk, keep_states=False),
            reps=20)
    del x, dy, args, h_chk, part, xp, argsp
    _free_device_memory()
    src = "src/repro_torch/kernels/csrc/selective_scan.cu"
    rep = ("no TPU kernel: XLA lax.scan/associative_scan "
           "(src/repro/models/mamba.py:64-89, decode :116-125)")
    path = (f"train step (B={b}, S={s}): forward twice a mamba layer "
            f"(remat), backward and fold once")
    kernels = [
        _entry("selective_scan_fwd", src, rep, launches["scan_fwd"], path,
               jamba["max_abs_err_y"], fwd_ms, plain_fwd_ms,
               _scan_bound(b, s, din, False), None),
        _entry("selective_scan_bwd", src, rep, launches["scan_bwd"], path,
               jamba["max_abs_err_grads"], bwd_ms, plain_bwd_ms,
               _scan_bound(b, s, din, True), None),
        _entry("selective_scan_fold", src, rep + "; the backward's sums",
               launches["scan_fold"], path,
               0.0 if jamba["bitwise"]["fold_vs_plain"] else float("nan"),
               fold_ms, plain_fold_ms,
               fold_bound, fold_library_ms)]
    for k in kernels[:2]:
        k["library_note"] = "none: no single PyTorch call computes it"
    kernels[2]["library_note"] = ("torch.sum over each partial: "
                                  "bc_part.sum(1) + ad_part.sum(0)")
    for k in kernels:
        k["bound_note"] = ("operations: exponentials at the SFU rate "
                           "(SFU_EXP_PER_S)" if k["bound_by"] == "operations"
                           else "bytes")
    decode = scan_check["decode"]
    res = scan_resources()
    kernels[0].update(
        v1_ms=fwd_v1_ms, prefill_ms=prefill_ms, prefill_v1_ms=prefill_v1_ms,
        prefill_shape=[pb, ps, din], decode_ms=decode["ms"],
        decode_v1_ms=decode["v1_ms"], decode_bound_ms=decode["bound_ms"],
        ptxas=[r for r in res if r["kernel"] == "fwd"])
    kernels[1].update(v1_ms=bwd_v1_ms,
                      ptxas=[r for r in res if r["kernel"] == "bwd"])
    kernels[2]["ptxas"] = [r for r in res if r["kernel"] == "fold"]
    _vs_v1(f"selective_scan_fwd ({b}, {s}, {din})", fwd_ms, fwd_v1_ms)
    _vs_v1(f"selective_scan_bwd ({b}, {s}, {din})", bwd_ms, bwd_v1_ms)
    _vs_v1(f"selective_scan_fwd serve prefill ({pb}, {ps}, {din})",
           prefill_ms, prefill_v1_ms)
    _vs_v1(f"selective_scan_fwd decode step ({SCAN_DECODE[0]}, 1, {din})",
           decode["ms"], decode["v1_ms"])
    spilled = [r for r in res if r["source"] == "selective_scan" and (
        r.get("spill_store_bytes") or r.get("spill_load_bytes"))]
    if spilled:
        raise AssertionError(f"selective scan kernels spill: {spilled}")
    return kernels


# [kernel-check] xlstm: csrc/mlstm.cu (parallel form, recurrence) and
# csrc/slstm.cu against their plain versions. (case, B, S, hd, dtype of
# q/k/v or r): xLSTM-350M's widths (4 heads of 256) at the serve slice's
# batch and prompt and at S = 2048 (parallel form), a ragged S that is no
# multiple of the 32-query tile, fp32, and the reduced configs' hd = 32
XLSTM_HEADS = 4
XLSTM_PAR_CASES = [("serve", 4, 512, 256, torch.bfloat16),
                   ("long", 4, 2048, 256, torch.bfloat16),
                   ("ragged", 2, 300, 256, torch.bfloat16),
                   ("fp32", 1, 512, 256, torch.float32),
                   ("hd32", 2, 100, 32, torch.float32),
                   ("hd32_bf16", 2, 77, 32, torch.bfloat16)]
# the backward kernels (csrc/mlstm_parallel_bwd.cu, csrc/slstm_bwd.cu):
# (case, B, S, H, hd, dtype of q/k/v or r) at xLSTM-350M's train shape
# ([train-xlstm]: B=4, S=1024, 4 heads of 256) and at a small one, each in
# bf16 and fp32 operands
XLSTM_BWD_CASES = [("train", 4, 1024, 4, 256, torch.bfloat16),
                   ("train_fp32", 4, 1024, 4, 256, torch.float32),
                   ("small", 2, 64, 2, 32, torch.bfloat16),
                   ("small_fp32", 2, 64, 2, 32, torch.float32)]
# the recurrences: the serve prefill from the model's initial state (then
# its decode step, S = 1, from the state it leaves), and from carried states
XLSTM_REC_CASES = [("serve_prefill", 4, 512, 256, torch.bfloat16, False),
                   ("ragged", 2, 77, 256, torch.bfloat16, True),
                   ("fp32", 2, 200, 256, torch.float32, True),
                   ("hd32", 2, 100, 32, torch.float32, True)]
# |kernel - plain| <= tol * max(1, max |plain|), per output: both compute
# in fp32 from the same inputs (bf16 operands are exact in fp32) and differ
# by the order of their sums (over hd, and over the keys in the parallel
# form) and by fused multiply-adds in the dot products
XLSTM_TOL = 1e-4
# the reference's identity forward ~ prefill + decode
# (tests/test_archs_smoke.py:59-89) at the reduced config: its own limit,
# allclose(5e-2, 5e-2) on the bf16 model, printed as a reading: the
# reference itself fails it on the CPU at PRNGKey(2), max |diff| 0.069
# (tests/test_torch_xlstm.py::test_bf16_identity_readings). The gates, on
# max |diff| of the logits (which reach ~1): fp32 within 1e-4 (its
# readings, CPU and card, 3e-6 to 1.7e-5), bf16 within 0.1
XLSTM_IDENTITY_TOL = dict(atol=5e-2, rtol=5e-2)
XLSTM_IDENTITY_ATOL = {"float32": 1e-4, "bfloat16": 0.1}
# xLSTM-350M's logits through the kernels against the plain mixers' at full
# width and depth in fp32: each mixer agrees within ~1e-6 of its outputs
# and the 24 layers amplify a perturbation ~x200-500 (their prefill and
# forward logits differ by 2.7e-4 and 2.6e-3 on an H100 80GB HBM3 at 700
# W, scripts/xlstm_conditioning.py). In bf16 a rounding that flips one ulp
# (4e-3) is amplified the same way, to 0.9 at 24 layers: the bf16 model's
# comparison at full depth is a reading, and is gated within LOGITS_ATOL
# at XLSTM_CUT (one mLSTM and one sLSTM layer, 2e-3 and 6e-3 there)
XLSTM_FP32_LOGITS_ATOL = 1e-2
XLSTM_CUT = "0,7"
SERVE_XLSTM = dict(SLICE, arch="xlstm-350m")


def _xl_rand(gen):
    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    return r


def _mlstm_inputs(b, s, hd, dtype, seed, carried=True, h=XLSTM_HEADS):
    """q, k (divided by sqrt(hd)), v (B, S, h, hd) in ``dtype``; the log
    input gate ~ N(0, 1) and the log forget gate log_sigmoid(N(1, 1)) (the
    model's forget bias 1); and a carried (C, n, m), or the model's
    zeros."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = _xl_rand(gen)
    args = (r(b, s, h, hd).to(dtype),
            (r(b, s, h, hd) / math.sqrt(hd)).to(dtype),
            r(b, s, h, hd).to(dtype), r(b, s, h),
            F.logsigmoid(r(b, s, h) + 1.0))
    state = (0.1 * r(b, h, hd, hd), 0.1 * r(b, h, hd),
             torch.rand((b, h), generator=gen, device="cuda") * 2 - 1)
    if not carried:
        state = tuple(torch.zeros_like(t) for t in state)
    return args, state


def _slstm_inputs(b, s, hd, dtype, seed, carried=True, h=XLSTM_HEADS):
    """The four pre-activations (B, S, h, hd) ~ N(0, 1), r_g at their
    fan-in scale in ``dtype``, and a carried (c, n, h, m) or the model's
    initial state."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = _xl_rand(gen)
    z = tuple(r(b, s, h, hd) for _ in range(4))
    rr = tuple((r(h, hd, hd) / math.sqrt(hd)).to(dtype) for _ in range(4))
    if carried:
        u = torch.rand((2, b, h, hd), generator=gen, device="cuda")
        state = (0.3 * r(b, h, hd), 0.5 + 1.5 * u[0], 0.3 * r(b, h, hd),
                 2 * u[1] - 1)
    else:
        zero = torch.zeros((b, h, hd), device="cuda")
        state = (zero, zero.clone(), zero.clone(), torch.full_like(
            zero, -1e30))
    return z, rr, state


def _flat_tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _flat_tensors(y)]


def _same(a, b_):
    fa, fb = _flat_tensors(a), _flat_tensors(b_)
    return len(fa) == len(fb) and all(torch.equal(x, y)
                                      for x, y in zip(fa, fb))


def _sliced(args, lo, hi):
    return tuple(a[:, lo:hi].contiguous() for a in args)


def _split_equal(run, args, state, full, t):
    """A recurrence launched over steps [0, t) then [t, S) from the first
    launch's state: bitwise the one launch ``full`` over [0, S)."""
    out1, st1 = run(_sliced(args, 0, t), state)
    out2, st2 = run(_sliced(args, t, args[0].shape[1]), st1)
    return _same((torch.cat([out1, out2], 1), st2), full)


@torch.no_grad()
def check_xlstm():
    """The three xLSTM kernels against their plain versions on the card,
    at ``XLSTM_PAR_CASES`` and ``XLSTM_REC_CASES`` (and each recurrence's
    decode step at the serve shape): every output within ``XLSTM_TOL``, 10
    repeated launches bitwise, and each recurrence split at two points
    (3/5 of S, and S - 1: a prefill then a one-step decode) bitwise one
    launch. One ``[kernel-check] xlstm`` line a case; and one
    ``[kernel-check] xlstm v1`` line a case: the recurrences' every output
    and state leaf ``torch.equal`` to the first design's
    (``mlstm_recurrent_v1_cuda``, ``slstm_v1_cuda``, also at each decode
    step), the parallel form's output ``torch.equal`` to
    ``mlstm_parallel_v1_cuda``'s for fp32 operands and within
    ``XLSTM_TOL`` of it for bf16 ones (whose q . k the redesign sums on the
    tensor cores; max abs diff printed). Then the backward kernels at
    ``XLSTM_BWD_CASES`` (:func:`_check_xlstm_backward`). Raises on any
    failure. Returns the lines and the serve shapes' max abs errors (the
    backwards' at the train shape)."""
    lines = []

    def report(kernel, case, shape, dtype, pairs, bitwise):
        err = {k: _scan_err(g, w) for k, (g, w) in pairs.items()}
        line = dict(kernel=kernel, case=case, shape=list(shape),
                    dtype=str(dtype).split(".")[-1], err=err, tol=XLSTM_TOL,
                    max_abs_err=max(float((g.float() - w.float()).abs().max())
                                    for g, w in pairs.values()),
                    bitwise=bitwise)
        line["ok"] = (all(e <= XLSTM_TOL for e in err.values())
                      and all(bitwise.values()))
        print("[kernel-check] xlstm " + json.dumps(line), flush=True)
        lines.append(line)
        return line

    def reps10(run, first):
        return all(_same(run(), first) for _ in range(10))

    v1_lines = []

    def report_v1(kernel, case, run_v1, args, state, got, names):
        """Every output and state leaf of the redesign ``torch.equal`` to
        the first design's on the same inputs."""
        old = _flat_tensors(run_v1(args, state))
        equal = {name: bool(torch.equal(g, o)) for name, g, o in
                 zip(names, _flat_tensors(got), old)}
        line = dict(kernel=kernel, case=case,
                    shape=list(args[0].shape), equal=equal,
                    ok=len(old) == len(names) and all(equal.values()))
        print("[kernel-check] xlstm v1 " + json.dumps(line), flush=True)
        return line

    for case, b, s, hd, dtype in XLSTM_PAR_CASES:
        args, _ = _mlstm_inputs(b, s, hd, dtype, seed=s + hd)
        out = MLSTM.mlstm_parallel_cuda(*args)
        want = MLSTM.mlstm_parallel_plain(*args)
        report("mlstm_parallel", case, (b, s, XLSTM_HEADS, hd), dtype,
               {"out": (out, want)},
               {"reps10": reps10(lambda: MLSTM.mlstm_parallel_cuda(*args),
                                 out)})
        old = MLSTM.mlstm_parallel_v1_cuda(*args)
        line = dict(kernel="mlstm_parallel", case=case,
                    shape=list(args[0].shape),
                    dtype=str(dtype).split(".")[-1],
                    max_abs_diff=float((out - old).abs().max()))
        if dtype == torch.float32:
            line.update(equal={"out": bool(torch.equal(out, old))})
            line["ok"] = line["equal"]["out"]
        else:
            line.update(err=_scan_err(out, old), tol=XLSTM_TOL)
            line["ok"] = line["err"] <= XLSTM_TOL
        print("[kernel-check] xlstm v1 " + json.dumps(line), flush=True)
        v1_lines.append(line)
        del args, out, want, old

    def mlstm_run(args, state):
        return MLSTM.mlstm_recurrent_cuda(*args, *state)

    def slstm_run(args, state, rr=None):
        return SLSTM.slstm_cuda(args, rr, state)

    for kernel in ("mlstm_recurrent", "slstm"):
        names = (("out", "C", "n", "m") if kernel == "mlstm_recurrent"
                 else ("h_all", "c", "n", "h", "m"))
        for case, b, s, hd, dtype, carried in XLSTM_REC_CASES:
            seed = s + hd + (kernel == "slstm")
            if kernel == "mlstm_recurrent":
                args, state = _mlstm_inputs(b, s, hd, dtype, seed, carried)
                run, plain = mlstm_run, (
                    lambda a, st: MLSTM.mlstm_recurrent_plain(*a, *st))
                run_v1 = (
                    lambda a, st: MLSTM.mlstm_recurrent_v1_cuda(*a, *st))
            else:
                args, rr, state = _slstm_inputs(b, s, hd, dtype, seed,
                                                carried)
                run = functools.partial(slstm_run, rr=rr)
                plain = functools.partial(
                    lambda a, st, rr: SLSTM.slstm_plain(a, rr, st), rr=rr)
                run_v1 = functools.partial(
                    lambda a, st, rr: SLSTM.slstm_v1_cuda(a, rr, st), rr=rr)
            got = run(args, state)
            want = plain(args, state)
            v1_lines.append(report_v1(kernel, case, run_v1, args, state,
                                      got, names))
            pairs = dict(zip(names, zip(_flat_tensors(got),
                                        _flat_tensors(want))))
            bitwise = dict(
                reps10=reps10(lambda: run(args, state), got),
                split_3_5=_split_equal(run, args, state, got, s * 3 // 5),
                split_last=_split_equal(run, args, state, got, s - 1))
            report(kernel, case, (b, s, XLSTM_HEADS, hd), dtype, pairs,
                   bitwise)
            if case == "serve_prefill":
                # the decode step from the state the prefill leaves
                if kernel == "mlstm_recurrent":
                    dargs, _ = _mlstm_inputs(b, 1, hd, dtype, seed + 1)
                else:
                    dargs = _slstm_inputs(b, 1, hd, dtype, seed + 1)[0]
                dstate = tuple(_flat_tensors(got)[1:])
                dgot = run(dargs, dstate)
                dwant = plain(dargs, dstate)
                v1_lines.append(report_v1(kernel, "serve_decode", run_v1,
                                          dargs, dstate, dgot, names))
                report(kernel, "serve_decode", (b, 1, XLSTM_HEADS, hd),
                       dtype, dict(zip(names, zip(_flat_tensors(dgot),
                                                  _flat_tensors(dwant)))),
                       dict(reps10=reps10(lambda: run(dargs, dstate), dgot)))
            del args, state, got, want
    _free_device_memory()
    for case in XLSTM_BWD_CASES:
        _check_xlstm_backward(case, report, v1_lines)
        _free_device_memory()
    failed = [f"{x['kernel']}/{x['case']}" for x in lines if not x["ok"]]
    not_v1 = [f"{x['kernel']}/{x['case']}" for x in v1_lines if not x["ok"]]
    if failed or not_v1:
        raise AssertionError(f"xLSTM kernels vs plain failed: {failed}; "
                             f"not their first designs' bits (tolerance "
                             f"for the parallel form's bf16): {not_v1}")
    by = {(x["kernel"], x["case"]): x["max_abs_err"] for x in lines}
    return dict(lines=lines, v1_lines=v1_lines, max_abs_err=dict(
        mlstm_parallel=by[("mlstm_parallel", "serve")],
        mlstm_recurrent=max(by[("mlstm_recurrent", "serve_prefill")],
                            by[("mlstm_recurrent", "serve_decode")]),
        slstm=max(by[("slstm", "serve_prefill")],
                  by[("slstm", "serve_decode")]),
        mlstm_parallel_bwd=by[("mlstm_parallel_bwd", "train")],
        slstm_bwd=by[("slstm_bwd", "train")]))


def _fp32_leaves(tensors):
    """fp32 leaves of ``tensors`` (bf16 operands are exact in fp32) that
    take a gradient."""
    return [t.detach().float().requires_grad_(True) for t in tensors]


def _check_xlstm_backward(case, report, v1_lines):
    """The two backward kernels at one of ``XLSTM_BWD_CASES``, each against
    its plain backward on the same inputs and against autograd of its plain
    forward, within ``XLSTM_TOL``, and 10 repeated launches bitwise
    (``report``'s ``[kernel-check] xlstm`` lines, kernels
    ``mlstm_parallel_bwd`` and ``slstm_bwd``); the mLSTM's from the
    forward's row statistics (``mlstm_parallel_stats_cuda``, the forward
    the train step runs) and against its first design
    (:func:`_mlstm_bwd_v1_lines`); the sLSTM's forward with its states kept
    (``slstm_cuda(keep=True)``, the one the train step runs) bitwise its
    first design's h_all and state (a ``[kernel-check] xlstm v1`` line,
    kernel ``slstm_keep``, appended to ``v1_lines``). The sLSTM runs from
    the model's initial state, as training does; the gradients of every h
    and of the returned state are random."""
    name, b, s, h, hd, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(s + hd + 7)
    args, _ = _mlstm_inputs(b, s, hd, dtype, seed=s + hd + 5, h=h)
    out, F_, stats = MLSTM.mlstm_parallel_stats_cuda(*args)
    dout = torch.randn(out.shape, generator=gen, device="cuda")
    saved = (*args[:4], F_, out)
    got = MLSTM.mlstm_parallel_backward_cuda(*saved, dout, stats)
    plain = MLSTM.mlstm_parallel_backward_plain(*args, dout)
    with torch.enable_grad():
        leaves = _fp32_leaves(args)
        auto = torch.autograd.grad(MLSTM.mlstm_parallel_plain(*leaves),
                                   leaves, dout)
    names = ("dq", "dk", "dv", "dig", "dfg")
    pairs = dict(zip(names, zip(got, plain)))
    pairs.update({f"{n}_vs_autograd": (g, a)
                  for n, g, a in zip(names, got, auto)})
    report("mlstm_parallel_bwd", name, (b, s, h, hd), dtype, pairs, dict(
        reps10=all(_same(MLSTM.mlstm_parallel_backward_cuda(*saved, dout,
                                                            stats), got)
                   for _ in range(10))))
    del plain, auto, leaves, pairs
    v1_lines.extend(_mlstm_bwd_v1_lines(name, args, out, stats, dout, got))
    del args, out, dout, got, saved, stats

    z, rr, st = _slstm_inputs(b, s, hd, dtype, seed=s + hd + 6,
                              carried=False, h=h)
    h_all, new, kept = SLSTM.slstm_cuda(z, rr, st, keep=True)
    v1_h, v1_new = SLSTM.slstm_v1_cuda(z, rr, st)
    equal = {n: bool(torch.equal(g, w)) for n, g, w in zip(
        ("h_all", "c", "n", "h", "m"), (h_all, *new), (v1_h, *v1_new))}
    line = dict(kernel="slstm_keep", case=name, shape=[b, s, h, hd],
                dtype=str(dtype).split(".")[-1], equal=equal,
                ok=all(equal.values()))
    print("[kernel-check] xlstm v1 " + json.dumps(line), flush=True)
    v1_lines.append(line)
    dh = torch.randn(h_all.shape, generator=gen, device="cuda")
    dst = tuple(torch.randn(t.shape, generator=gen, device="cuda")
                for t in st)
    saved = (h_all, kept)
    got = SLSTM.slstm_backward_cuda(z, rr, st, saved, dh, dst)
    plain = SLSTM.slstm_backward_plain(z, rr, st, saved, dh, dst)
    with torch.enable_grad():
        leaves = _fp32_leaves((*z, *rr, *st))
        h2, new2 = SLSTM.slstm_plain(leaves[:4], leaves[4:8], leaves[8:])
        auto = torch.autograd.grad((h2, *new2), leaves, (dh, *dst))
    names = ([f"dz_{g}" for g in "ifzo"] + [f"dr_{g}" for g in "ifzo"]
             + ["dc0", "dn0", "dh0", "dm0"])
    flat = _flat_tensors(got)
    pairs = dict(zip(names, zip(flat, _flat_tensors(plain))))
    pairs.update({f"{n}_vs_autograd": (g, a)
                  for n, g, a in zip(names, flat, auto)})
    report("slstm_bwd", name, (b, s, h, hd), dtype, pairs, dict(
        reps10=all(_same(SLSTM.slstm_backward_cuda(z, rr, st, saved, dh,
                                                   dst), got)
                   for _ in range(10))))


def _mlstm_bwd_v1_lines(case, args, out, stats, dout, got):
    """Two ``[kernel-check] xlstm v1`` lines of the mLSTM parallel
    backward at one case. ``mlstm_parallel_stats``: the forward with its
    row statistics gives ``out`` bitwise the forward's without them, its
    m_i and tie counts equal the plain forward's (exact: a max and a count
    of equal roundings) and the first design's rows pass's m_i, and the
    redesign's rows pass on them gives the first design's ds_i and share_i
    bitwise for fp32 operands (so s_i and the ties are its bits).
    ``mlstm_parallel_bwd``: the five gradients ``torch.equal`` to the first
    design's (``mlstm_parallel_backward_v1_cuda``) for fp32 operands,
    within ``XLSTM_TOL`` for bf16 ones (whose q . k the redesign sums on
    the tensor cores as the forward does; max abs diff printed)."""
    b, s, h, hd = args[0].shape
    fp32 = args[0].dtype == torch.float32
    dtype = str(args[0].dtype).split(".")[-1]
    rows = MLSTM.backward_row_terms(*args, out, dout, stats)
    rows_v1 = MLSTM.backward_row_terms(*args, out, dout)
    equal = dict(out=bool(torch.equal(out, MLSTM.mlstm_parallel_cuda(*args))),
                 m_v1=bool(torch.equal(rows[..., 1], rows_v1[..., 0])))
    if s * s * b * h <= 2 ** 24:       # the plain statistics' (B, S, S, H)
        _, _, want = MLSTM.mlstm_parallel_stats_plain(*args)
        equal.update(m_plain=bool(torch.equal(stats[..., 0], want[..., 0])),
                     ties_plain=bool(torch.equal(stats[..., 2],
                                                 want[..., 2])))
        del want
    if fp32:
        equal["ds_share_v1"] = bool(torch.equal(rows[..., 2:],
                                                rows_v1[..., 2:]))
    stats_line = dict(kernel="mlstm_parallel_stats", case=case,
                      shape=[b, s, h, hd], dtype=dtype, equal=equal,
                      ok=all(equal.values()))
    old = MLSTM.mlstm_parallel_backward_v1_cuda(*args, out, dout)
    names = ("dq", "dk", "dv", "dig", "dfg")
    line = dict(kernel="mlstm_parallel_bwd", case=case, shape=[b, s, h, hd],
                dtype=dtype, max_abs_diff=max(
                    float((g - o).abs().max()) for g, o in zip(got, old)))
    if fp32:
        line["equal"] = {n: bool(torch.equal(g, o))
                         for n, g, o in zip(names, got, old)}
        line["ok"] = all(line["equal"].values())
    else:
        line.update(err={n: _scan_err(g, o)
                         for n, g, o in zip(names, got, old)}, tol=XLSTM_TOL)
        line["ok"] = all(e <= XLSTM_TOL for e in line["err"].values())
    for x in (stats_line, line):
        print("[kernel-check] xlstm v1 " + json.dumps(x), flush=True)
    return [stats_line, line]


def _xlstm_bounds(b, s, hd, elt):
    """Least time of each xLSTM kernel at (b, s, 4 heads of hd), q/k/v or
    r in ``elt``-byte elements: inputs read once, outputs written once,
    against the operations (2 a multiply-add) and the exponentials at the
    SFU's rate. The parallel form's two products run over the s (s + 1) / 2
    live pairs: q k^T, whose bf16 operands multiply exactly into an fp32
    sum, at the bf16 tensor cores' rate (at the CUDA cores' for fp32
    operands), and S v, whose scores are fp32, at the CUDA cores'. The
    recurrence's 6 a state element a step (fi C, v k, ii (v k), their sum,
    C q) and the sLSTM's four (hd x hd) matrix-vector products a step over
    the fp32 h run at the CUDA cores' rate."""
    h = XLSTM_HEADS
    tok, gates = b * s * h * hd, b * s * h
    pairs = b * h * s * (s + 1) // 2
    state = b * h * (hd * hd + hd + 1) * 4
    qk = 2 * hd * pairs
    return dict(
        mlstm_parallel=_bound(3 * tok * elt + 2 * gates * 4 + tok * 4,
                              qk * (elt == 4) + 2 * hd * pairs,
                              torch.float32, exps=pairs,
                              tc_flops=qk * (elt == 2)),
        mlstm_recurrent=_bound(3 * tok * elt + 2 * gates * 4 + tok * 4
                               + 2 * state, 6 * b * h * s * hd * hd,
                               torch.float32, exps=3 * gates),
        slstm=_bound(4 * tok * 4 + 4 * h * hd * hd * elt + tok * 4
                     + 2 * 4 * b * h * hd * 4, 8 * b * h * s * hd * hd,
                     torch.float32, exps=5 * tok))


def _xlstm_bwd_bounds(b, s, h, hd, elt):
    """Least time of each backward kernel at (b, s, h heads of hd), q/k/v
    or r in ``elt``-byte elements (as :func:`_xlstm_bounds` prices the
    forwards). The parallel backward: q, k, v, out, dout, ig, fg read once,
    dq, dk, dv, dig, dfg written once (fp32); over the s (s + 1) / 2 live
    pairs a (b, h) q k^T (recomputed: bf16 operands at the tensor cores'
    rate) and four fp32 products at the CUDA cores' (dnum . v, and dv, dk,
    dq), and the exponential of w. The sLSTM's: the kept states (7 planes),
    dh_all and h_all read, dz written, r read and dr written, the states;
    per step and (b, h) the four (hd x hd) matrix-vector products of dh_rec
    and, in dr, as many multiply-adds, at the fp32 rate; seven
    exponentials (i', f', tanh, two sigmoids, log_sigmoid's two) an
    element."""
    tok, gates = b * s * h * hd, b * s * h
    pairs = b * h * s * (s + 1) // 2
    qk = 2 * hd * pairs
    return dict(
        mlstm_parallel_bwd=_bound(
            3 * tok * elt + 2 * tok * 4 + 2 * gates * 4 + 3 * tok * 4
            + 2 * gates * 4, qk * (elt == 4) + 4 * 2 * hd * pairs,
            torch.float32, exps=pairs, tc_flops=qk * (elt == 2)),
        slstm_bwd=_bound(
            9 * tok * 4 + 4 * tok * 4 + 4 * h * hd * hd * (elt + 4)
            + 12 * b * h * hd * 4, 16 * b * h * s * hd * hd, torch.float32,
            exps=7 * tok))


def _mlstm_bwd_passes_ms(saved, dout, stats):
    """The parallel backward's three launches and its reverse
    ``torch.cumsum``, each ``_queued_ms`` alone on the same operands."""
    q, k, v, ig, F_, out = saved
    b, s, h, hd = q.shape
    n = -(-s // MLSTM.BWD_TILE)
    lib = MLSTM._bwd_lib()
    stream = torch.cuda.current_stream().cuda_stream
    rows = torch.empty((b, s, h, 4), device=q.device)
    dnum, dq, dk, dv = (torch.empty(q.shape, device=q.device)
                        for _ in range(4))
    scratch = torch.empty((2, b * h * n * (n + 1) // 2,
                           MLSTM.BWD_TILE ** 2), device=q.device)
    dig, dF = torch.empty_like(ig), torch.empty_like(ig)
    shape = (b, s, h, hd, int(q.dtype == torch.bfloat16), stream)

    def ptrs(*ts):
        return [x.data_ptr() for x in ts]
    calls = dict(
        rows=lambda: lib.dash_mlstm_bwd_rows(
            *ptrs(F_, stats, out, dout, rows, dnum), *shape),
        keys=lambda: lib.dash_mlstm_bwd_keys(
            *ptrs(q, k, v, F_, ig, rows, dnum, dk, dv, dig, scratch),
            *shape),
        queries=lambda: lib.dash_mlstm_bwd_queries(
            *ptrs(k, scratch, dig, dq, dF), *shape),
        reverse_cumsum=lambda: torch.flip(torch.cumsum(torch.flip(
            dF, (1,)), 1), (1,)))
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    return {name: _queued_ms(fn, reps=10) for name, fn in calls.items()}


def _parallel_split_ms(q, k, v, ig, fg):
    """The parallel form's wrapper split in two, each ``_queued_ms`` alone:
    its kernel's launch on a precomputed F (``launch_ms``) and the
    wrapper's ``F = torch.cumsum(fg, 1)`` (``cumsum_ms``)."""
    b, s, h, hd = q.shape
    F_ = torch.cumsum(fg, 1)
    out = torch.empty((b, s, h, hd), dtype=torch.float32, device=q.device)
    lib, stream = MLSTM._lib(), torch.cuda.current_stream().cuda_stream

    def launch():
        lib.dash_mlstm_parallel(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                F_.data_ptr(), ig.data_ptr(), out.data_ptr(),
                                0, b, s, h, hd,
                                int(q.dtype == torch.bfloat16), stream)
    return dict(launch_ms=_queued_ms(launch, reps=20),
                cumsum_ms=_queued_ms(lambda: torch.cumsum(fg, 1), reps=20))


@torch.no_grad()
def time_xlstm(xlstm_check, serve, train):
    """The three xLSTM kernels at the serve slice's shapes (B = 4, prompt
    512; the recurrences also at the decode step, S = 1), each beside its
    plain version and its bound — the ``{"kernels": ...}`` entries, whose
    launches are ``[serve-xlstm]``'s: the static engine's generate for the
    recurrences, its ``forward`` for the parallel form. Each kernel also
    beside its first design in turns (``v1_ms``; the recurrences'
    decode steps ``decode_v1_ms``), with the clock64() share of each phase
    of a recurrence's step at the prefill shape (``[phases]``). The
    parallel form's ``ms`` is its wrapper's, ``F = cumsum(fg)`` included;
    ``launch_ms`` and ``cumsum_ms`` split it (each queued alone). Then the
    two backward kernels at ``[train-xlstm]``'s shape (B = 4, S = 1024,
    bf16), each its wrapper's time beside its plain backward's, with
    ``[train-xlstm]``'s launches a step (:func:`_time_xlstm_backward`)."""
    b, s = SERVE_XLSTM["batch"], SERVE_XLSTM["prompt"]
    hd, dtype = registry.get(SERVE_XLSTM["arch"]).head_dim, torch.bfloat16
    args, _ = _mlstm_inputs(b, s, hd, dtype, seed=31)
    _, zero = _mlstm_inputs(b, 1, hd, dtype, seed=31, carried=False)
    dargs, dstate = _mlstm_inputs(b, 1, hd, dtype, seed=32)
    z, rr, st0 = _slstm_inputs(b, s, hd, dtype, seed=33, carried=False)
    dz, _, dst = _slstm_inputs(b, 1, hd, dtype, seed=34)
    ms, v1_ms = {}, {}
    # each kernel (and the recurrences' decode steps) in turns with its
    # first design (new, old, old, new), the calls queued behind a spin
    # kernel
    for name, new_fn, old_fn, reps in (
            ("mlstm_parallel", lambda: MLSTM.mlstm_parallel_cuda(*args),
             lambda: MLSTM.mlstm_parallel_v1_cuda(*args), 20),
            ("mlstm_recurrent",
             lambda: MLSTM.mlstm_recurrent_cuda(*args, *zero),
             lambda: MLSTM.mlstm_recurrent_v1_cuda(*args, *zero), 20),
            ("mlstm_recurrent_decode",
             lambda: MLSTM.mlstm_recurrent_cuda(*dargs, *dstate),
             lambda: MLSTM.mlstm_recurrent_v1_cuda(*dargs, *dstate), 50),
            ("slstm", lambda: SLSTM.slstm_cuda(z, rr, st0),
             lambda: SLSTM.slstm_v1_cuda(z, rr, st0), 20),
            ("slstm_decode", lambda: SLSTM.slstm_cuda(dz, rr, dst),
             lambda: SLSTM.slstm_v1_cuda(dz, rr, dst), 50)):
        ms[name], v1_ms[name] = _turns_ms(new_fn, old_fn, reps=reps)
    split = _parallel_split_ms(*args)
    phases = dict(mlstm_recurrent=_xlstm_phase_shares(
        MLSTM.recurrent_phases(*args, *zero), XLSTM_MLSTM_PHASES),
        slstm=_xlstm_phase_shares(SLSTM.slstm_phases(z, rr, st0),
                                  XLSTM_SLSTM_PHASES))
    for name, share in phases.items():
        print(f"[phases] {name} (B={b}, S={s}): " + json.dumps(share),
              flush=True)
    plain = dict(
        mlstm_parallel=_ms(lambda: MLSTM.mlstm_parallel_plain(*args),
                           reps=3),
        mlstm_recurrent=_ms(lambda: MLSTM.mlstm_recurrent_plain(
            *args, *zero), reps=1, rounds=3, warmup=1),
        mlstm_recurrent_decode=_ms(lambda: MLSTM.mlstm_recurrent_plain(
            *dargs, *dstate), reps=20),
        slstm=_ms(lambda: SLSTM.slstm_plain(z, rr, st0), reps=1, rounds=3,
                  warmup=1),
        slstm_decode=_ms(lambda: SLSTM.slstm_plain(dz, rr, dst), reps=20))
    bounds = _xlstm_bounds(b, s, hd, 2)
    decode_bounds = _xlstm_bounds(b, 1, hd, 2)
    ml_src = "src/repro_torch/kernels/csrc/mlstm.cu"
    gen = serve["launches"]
    shape = f"(B={b}, S={s}, 4 heads of {hd}, bf16)"
    kernels = [
        _entry("mlstm_parallel", ml_src,
               "no TPU kernel: XLA einsums (src/repro/models/xlstm.py:57-69)",
               serve["forward_launches"]["mlstm_parallel"],
               f"forward {shape}: one a mLSTM layer",
               xlstm_check["max_abs_err"]["mlstm_parallel"],
               ms["mlstm_parallel"], plain["mlstm_parallel"],
               bounds["mlstm_parallel"], None),
        _entry("mlstm_recurrent", ml_src,
               "no TPU kernel: XLA lax.scan (src/repro/models/xlstm.py:"
               "70-89)", gen["mlstm_recurrent"],
               f"static engine generate {shape}, 32 tokens: one a mLSTM "
               f"layer in the prefill and in each decode step",
               xlstm_check["max_abs_err"]["mlstm_recurrent"],
               ms["mlstm_recurrent"], plain["mlstm_recurrent"],
               bounds["mlstm_recurrent"], None),
        _entry("slstm", "src/repro_torch/kernels/csrc/slstm.cu",
               "no TPU kernel: XLA lax.scan (src/repro/models/xlstm.py:"
               "128-145)", gen["slstm"],
               f"static engine generate {shape}, 32 tokens: one a sLSTM "
               f"layer in the prefill and in each decode step",
               xlstm_check["max_abs_err"]["slstm"], ms["slstm"],
               plain["slstm"], bounds["slstm"], None)]
    for k in kernels:
        k["library_note"] = ("none: no single PyTorch call computes this "
                             "function")
        k["bound_note"] = ("operations: fp32 at the CUDA cores' rate"
                           if k["bound_by"] == "operations" else "bytes")
    if kernels[0]["bound_by"] == "operations":
        kernels[0]["bound_note"] = (
                "operations: q k^T (bf16 operands, fp32 sums) at the bf16 "
            "tensor cores' rate plus S v (fp32 scores) at the fp32 CUDA "
            "cores' rate")
    kernels[0].update(v1_ms=v1_ms["mlstm_parallel"], **split)
    _vs_v1(f"mlstm_parallel ({b}, {s})", kernels[0]["ms"],
           kernels[0]["v1_ms"])
    print(f"[timing] mlstm_parallel ({b}, {s}): launch alone "
          f"{split['launch_ms']:.4f} ms, F = cumsum(fg) alone "
          f"{split['cumsum_ms']:.4f} ms", flush=True)
    for k in kernels[1:]:
        name = k["name"]
        k.update(v1_ms=v1_ms[name], decode_ms=ms[f"{name}_decode"],
                 decode_v1_ms=v1_ms[f"{name}_decode"],
                 decode_plain_ms=plain[f"{name}_decode"],
                 decode_bound_ms=decode_bounds[name][0],
                 decode_bound_by=decode_bounds[name][1],
                 phases=phases[name])
        print(f"[timing] {name} decode step (B={b}, S=1): kernel "
              f"{k['decode_ms']:.4f} ms, plain {k['decode_plain_ms']:.4f} "
              f"ms, bound {k['decode_bound_ms']:.4f} ms "
              f"({k['decode_bound_by']})", flush=True)
        _vs_v1(f"{name} ({b}, {s})", k["ms"], k["v1_ms"])
        _vs_v1(f"{name} decode step ({b}, 1)", k["decode_ms"],
               k["decode_v1_ms"])
    kernels[2]["bound_note"] += (
        f"; latency-paced instead: {s} dependent steps, each two chains of "
        f"hd / 2 dependent multiply-adds, the gates, the state update and "
        f"an exchange of h across the cluster")
    del args, zero, dargs, dstate, z, rr, st0, dz, dst
    _free_device_memory()
    kernels += _time_xlstm_backward(xlstm_check, train)
    _free_device_memory()
    return kernels


def _time_xlstm_backward(xlstm_check, train):
    """The ``{"kernels": ...}`` entries of the two backward kernels at
    ``[train-xlstm]``'s shape: each wrapper's ms (the parallel backward's
    three passes with the reverse ``torch.cumsum``; the sLSTM's kernel with
    dr's einsum) beside its plain backward's and its bound
    (:func:`_xlstm_bwd_bounds`); its launches those of a ``[train-xlstm]``
    step; no library call computes either gradient. The parallel backward
    also beside its first design in turns (``v1_ms``: its wrapper, with
    its own ``torch.cumsum`` of fg), each pass alone (``passes_ms``, queued),
    and the forward with its row statistics beside the forward without
    them, in turns (``fwd_stats_ms``, ``fwd_ms``)."""
    _, b, s, h, hd, dtype = XLSTM_BWD_CASES[0]
    gen = torch.Generator(device="cuda").manual_seed(41)
    args, _ = _mlstm_inputs(b, s, hd, dtype, seed=41, h=h)
    out, F_, stats = MLSTM.mlstm_parallel_stats_cuda(*args)
    dout = torch.randn(out.shape, generator=gen, device="cuda")
    z, rr, st = _slstm_inputs(b, s, hd, dtype, seed=42, carried=False, h=h)
    h_all, _, kept = SLSTM.slstm_cuda(z, rr, st, keep=True)
    dh = torch.randn(h_all.shape, generator=gen, device="cuda")
    saved = (*args[:4], F_, out)
    new_ms, v1_ms = _turns_ms(
        lambda: MLSTM.mlstm_parallel_backward_cuda(*saved, dout, stats),
        lambda: MLSTM.mlstm_parallel_backward_v1_cuda(*args, out, dout),
        reps=5)
    fwd_stats_ms, fwd_ms = _turns_ms(
        lambda: MLSTM.mlstm_parallel_stats_cuda(*args),
        lambda: MLSTM.mlstm_parallel_cuda(*args), reps=20)
    passes = _mlstm_bwd_passes_ms(saved, dout, stats)
    ms = dict(
        mlstm_parallel_bwd=new_ms,
        slstm_bwd=_ms(lambda: SLSTM.slstm_backward_cuda(
            z, rr, st, (h_all, kept), dh), reps=5))
    plain = dict(
        mlstm_parallel_bwd=_ms(lambda: MLSTM.mlstm_parallel_backward_plain(
            *args, dout), reps=1, rounds=3, warmup=1),
        slstm_bwd=_ms(lambda: SLSTM.slstm_backward_plain(
            z, rr, st, (h_all, kept), dh), reps=1, rounds=1, warmup=0))
    bounds = _xlstm_bwd_bounds(b, s, h, hd, 2)
    steps = train["launches_per_step"]
    shape = f"(B={b}, S={s}, {h} heads of {hd}, bf16)"
    kernels = [
        _entry("mlstm_parallel_bwd",
               "src/repro_torch/kernels/csrc/mlstm_parallel_bwd.cu",
               "no TPU kernel: jax.grad of XLA einsums (src/repro/models/"
               "xlstm.py:57-69)", steps["mlstm_parallel_bwd"],
               f"[train-xlstm] step {shape}: three passes a mLSTM layer",
               xlstm_check["max_abs_err"]["mlstm_parallel_bwd"],
               ms["mlstm_parallel_bwd"], plain["mlstm_parallel_bwd"],
               bounds["mlstm_parallel_bwd"], None),
        _entry("slstm_bwd", "src/repro_torch/kernels/csrc/slstm_bwd.cu",
               "no TPU kernel: jax.grad of an XLA lax.scan (src/repro/"
               "models/xlstm.py:128-145)", steps["slstm_bwd"],
               f"[train-xlstm] step {shape}: one a sLSTM layer",
               xlstm_check["max_abs_err"]["slstm_bwd"], ms["slstm_bwd"],
               plain["slstm_bwd"], bounds["slstm_bwd"], None)]
    for k in kernels:
        k["library_note"] = ("none: no single PyTorch call computes this "
                             "gradient")
    kernels[0]["bound_note"] = (
        "operations: q k^T recomputed (bf16 operands) at the bf16 tensor "
        "cores' rate plus dnum . v, dv, dk, dq (fp32) at the fp32 CUDA "
        "cores' rate" if kernels[0]["bound_by"] == "operations" else "bytes")
    kernels[0].update(v1_ms=v1_ms, passes_ms=passes, fwd_stats_ms=fwd_stats_ms,
                      fwd_ms=fwd_ms)
    _vs_v1(f"mlstm_parallel_bwd ({b}, {s})", new_ms, v1_ms)
    print(f"[timing] mlstm_parallel_bwd ({b}, {s}) passes alone: "
          + json.dumps(passes) + f"; forward with stats {fwd_stats_ms:.4f} "
          f"ms, without {fwd_ms:.4f} ms", flush=True)
    kernels[1]["bound_note"] = (
        f"{kernels[1]['bound_by']}; latency-paced instead: {s} dependent "
        f"steps, each two chains of hd / 2 dependent multiply-adds, eight "
        f"partial sums, the elementwise terms and an exchange of dpre "
        f"across the cluster")
    return kernels


# the phases of a step that the recurrences' clock64() stamps split a
# warp's clocks into (kernels/mlstm.py::recurrent_phases,
# kernels/slstm.py::slstm_phases), per group of warps: (warps, names)
XLSTM_MLSTM_PHASES = {
    "consumer": (slice(0, -1), MLSTM.CONSUMER_PHASES),
    "scalar": (slice(-1, None), MLSTM.SCALAR_PHASES)}


# the sLSTM's warps by role (warp w the (gate w % 4, half w // 4), each
# half taking one of the cluster's two batch rows): the gate-i warps that
# update a row's state (all five phases), the other warps that take a gate
# (wait, sum, gate)
XLSTM_SLSTM_PHASES = {
    "updaters": ([0, 4], SLSTM.PHASES),
    "gates": ([1, 2, 3, 5, 6, 7], SLSTM.PHASES[:3])}


def _xlstm_phase_shares(stamps, groups):
    """The median share of each phase in a warp's clocks over the CTAs'
    warps of each group, and the group's median clocks in all, from
    ``stamps`` (CTAs, warps, phases + 1)."""
    out = {}
    for group, (warps, names) in groups.items():
        x = stamps[:, warps].reshape(-1, stamps.shape[-1]).astype(float)
        out[group] = {name: float(statistics.median(x[:, i] / x[:, -1]))
                      for i, name in enumerate(names)}
        out[group]["clocks"] = float(statistics.median(x[:, -1]))
    return out


def _vs_plain(fn):
    """(max |kernels - plain|, max row rel. error, argmax agreement) of the
    logits ``fn()`` gives through the kernels and under
    :func:`_plain_mixers`."""
    got = fn()
    with _plain_mixers():
        want = fn()
    rel = (torch.linalg.vector_norm((got - want).float(), dim=-1)
           / torch.linalg.vector_norm(want.float(), dim=-1)).max().item()
    return dict(max_abs_err=(got - want).abs().max().item(), row_rel_err=rel,
                argmax_agreement=(got.argmax(-1) == want.argmax(-1)).float()
                .mean().item())


def _forward_identity(params, cfg, toks):
    """forward's logits at the last two positions against prefill of all
    but the last token and one decode step: (max |diff| of each, both
    within the reference's ``XLSTM_IDENTITY_TOL``)."""
    s = toks.shape[1]
    full, _ = T.forward(params, {"tokens": toks}, cfg)
    last, caches = T.prefill_step(params, {"tokens": toks[:, :-1]}, cfg,
                                  max_seq=s)
    step, _ = T.decode_step(params, caches, toks[:, -1:], s - 1, cfg)
    pairs = ((last[:, 0], full[:, -2]), (step[:, 0], full[:, -1]))
    return dict(prefill_max_abs=(pairs[0][0] - pairs[0][1]).abs().max().item(),
                decode_max_abs=(pairs[1][0] - pairs[1][1]).abs().max().item(),
                within_tol=all(bool(torch.allclose(
                    a.float(), b_.float(), **XLSTM_IDENTITY_TOL))
                    for a, b_ in pairs))


@torch.inference_mode()
def _xlstm_model_checks(label):
    """xLSTM-350M beside ``[serve-xlstm]``'s bf16 serve: its ``forward`` at
    (4, 512), full width and depth, through the parallel kernel (the
    launches: the parallel form once a mLSTM layer, the sLSTM once a sLSTM
    layer, nothing else; its ms; its logits against the plain mixers', a
    reading); the bf16 model cut to ``XLSTM_CUT``'s two layers, its prefill
    and forward logits against the plain mixers' within ``LOGITS_ATOL``;
    the fp32 model's at full width and depth within
    ``XLSTM_FP32_LOGITS_ATOL``; ``forward`` against prefill + decode (the
    reference's identity) at full width (a reading) and at the reduced
    config (hd 32) within ``XLSTM_IDENTITY_ATOL`` in each dtype, the
    reference's own allclose beside it."""
    cfg = registry.get(SERVE_XLSTM["arch"])
    b, s = SERVE_XLSTM["batch"], SERVE_XLSTM["prompt"]
    _, _, mlstm_layers, slstm_layers = _layer_kinds(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(1, cfg.vocab, (b, s), generator=gen, device="cuda")
    batch = {"tokens": prompt}
    params = T.init(cfg, seed=0, device="cuda")
    _zero_counts()
    (logits, _), t_fwd = _timed(lambda: T.forward(params, batch, cfg))
    counts = _counts()
    want = dict(_no_launches(), mlstm_parallel=mlstm_layers,
                slstm=slstm_layers)
    if counts != want:
        raise AssertionError(f"forward launched {counts}, expected {want}")
    bf16 = _vs_plain(lambda: T.forward(params, batch, cfg)[0])
    identity_full_width = _forward_identity(params, cfg, prompt)
    del params, logits

    def vs_plain(c):
        p = T.init(c, seed=0, device="cuda")
        return dict(
            prefill=_vs_plain(lambda: T.prefill_step(p, batch, c,
                                                     max_seq=s)[0]),
            forward=_vs_plain(lambda: T.forward(p, batch, c)[0]))
    cut = launch_train.cut_layers(cfg, XLSTM_CUT)
    bf16_cut = dict(vs_plain(cut), pattern=list(cut.block_pattern),
                    bound=f"max abs err <= {LOGITS_ATOL}")
    fp32 = dict(vs_plain(cfg.replace(dtype_name="float32")),
                bound=f"max abs err <= {XLSTM_FP32_LOGITS_ATOL}")
    reduced = {}
    for dtype in ("float32", "bfloat16"):
        rcfg = cfg.reduced(dtype_name=dtype)
        rtoks = torch.randint(1, rcfg.vocab, (2, 64), generator=gen,
                              device="cuda")
        reduced[dtype] = _forward_identity(
            T.init(rcfg, seed=0, device="cuda"), rcfg, rtoks)
    reduced.update(reference_tol=XLSTM_IDENTITY_TOL,
                   bound=XLSTM_IDENTITY_ATOL)
    result = dict(forward_ms=t_fwd * 1e3, forward_shape=[b, s],
                  forward_launches=dict(mlstm_parallel=counts[
                      "mlstm_parallel"], slstm=counts["slstm"]),
                  forward_bf16_vs_plain=bf16, bf16_cut_vs_plain=bf16_cut,
                  fp32_vs_plain=fp32,
                  identity_full_width=identity_full_width,
                  identity_reduced=reduced)
    print(f"[{label}-model] " + json.dumps(result), flush=True)
    off = [f"{name} {k}" for name, got, atol in (
               ("bf16 cut", bf16_cut, LOGITS_ATOL),
               ("fp32", fp32, XLSTM_FP32_LOGITS_ATOL))
           for k in ("prefill", "forward")
           if not got[k]["max_abs_err"] <= atol]
    off += [f"reduced {dtype} identity" for dtype, atol
            in XLSTM_IDENTITY_ATOL.items()
            if not max(reduced[dtype]["prefill_max_abs"],
                       reduced[dtype]["decode_max_abs"]) <= atol]
    if off:
        raise AssertionError(f"xLSTM-350M through the kernels: beyond its "
                             f"bound in {off}: {result}")
    return result


def run_serve_xlstm(label="serve-xlstm"):
    """xLSTM-350M at full width and depth (24 layers: 21 mLSTM, 3 sLSTM)
    through the static engine by :func:`_serve_static` (greedy twice,
    bitwise; the mLSTM recurrence and the sLSTM once a layer in the prefill
    and in each decode step; prefill ms, decode tok/s, peak memory; one
    profiled prefill's device-busy ms beside its host ms; its
    prefill logits against the plain mixers', a reading: the bf16 model is
    gated at ``XLSTM_CUT`` in :func:`_xlstm_model_checks`, which follows);
    ``launch.serve --engine continuous`` with xLSTM must raise the paged
    engine's refusal (its states are unpaged)."""
    _free_device_memory()
    with torch.inference_mode():
        out, vs_plain = _serve_static(SERVE_XLSTM, profile_prefill=True)
        out.update(vs_plain())
    print(f"[{label}] " + json.dumps(out), flush=True)
    if not out["logits_finite"]:
        raise AssertionError("xLSTM-350M's prefill logits are not finite")
    _free_device_memory()
    out.update(_xlstm_model_checks(label))
    out["launches"] = dict(out["xlstm_launches"])
    _free_device_memory()
    argv = ["--engine", "continuous", "--arch", SERVE_XLSTM["arch"],
            "--reduced"]
    try:
        launch_serve.main(argv)
    except NotImplementedError as e:
        refusal = str(e)
    else:
        raise AssertionError(f"launch.serve {' '.join(argv)} served an "
                             f"xLSTM arch on the paged engine")
    print(f"[{label}-refusal] " + json.dumps(dict(
        entry="repro_torch.launch.serve.main " + " ".join(argv),
        refusal=refusal)), flush=True)
    if "SSM states are unpaged" not in refusal:
        raise AssertionError(f"the paged engine refused with {refusal!r}")
    return out


def library_m_invariance():
    """A finding, not a check: whether ``torch.matmul`` (bf16, and fp32 as
    the training path's ``layers.dot`` calls it), ``F.layer_norm`` and
    ``torch.log_softmax`` give each row the same bits at M = 1, 4 and 32 on
    this card, at the serve path's widths (the record of why the GEMM and
    the row kernels exist)."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    x = _rand((32, 2048), gen, torch.bfloat16)
    w = _rand((2048, 5632), gen, torch.bfloat16, 0.02)
    h = _rand((32, 2048), gen, scale=3.0)
    scale, bias = _rand((2048,), gen) + 1, _rand((2048,), gen)
    logits = _rand((32, 100352), gen, scale=4.0)
    fns = {
        "torch.matmul bf16 (2048x5632)": lambda m: torch.matmul(x[:m], w),
        "torch.matmul fp32 (2048x5632)": lambda m: torch.matmul(
            x[:m].float(), w.float()),
        "F.layer_norm (2048)": lambda m: F.layer_norm(h[:m], (2048,), scale,
                                                      bias),
        "torch.log_softmax (100352)": lambda m: torch.log_softmax(logits[:m],
                                                                  -1),
    }
    finding = {}
    for name, fn in fns.items():
        full = fn(32)
        finding[name] = {str(m): torch.equal(fn(m), full[:m])
                         for m in (1, 4, 32)}
    print("[finding] library rows bitwise equal at M=1/4/32 (row-prefix of "
          "the M=32 call): " + json.dumps(finding), flush=True)
    return finding


def _serve_counts():
    return dict(paged_attention=DEC.launches, gemm=GEMM.launches,
                row_norm=ROWS.launches_norm,
                row_log_softmax=ROWS.launches_log_softmax)


def _zero_serve_counts():
    DEC.launches = GEMM.launches = 0
    ROWS.launches_norm = ROWS.launches_log_softmax = 0


def _step_launches(cfg, decode=True):
    """Launches of one paged step, from the code (``models/layers.py``): per
    layer the ln1 and ln2 norms, q/k/v/wo/up/down GEMMs (wo and w_down in
    canonical form), gate too for a gated MLP, and one paged attention; then
    ln_f and the LM head. A decode step's sampler adds one row
    log-softmax."""
    n = cfg.n_layers
    mlp = 3 if cfg.activation in ("silu", "geglu") else 2
    return dict(paged_attention=n, gemm=(4 + mlp) * n + 1,
                row_norm=2 * n + 1, row_log_softmax=int(decode))


def _continuous_engine(params, cfg, **kw):
    args = dict(n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                page_size=SERVE_PAGE, prefill_chunk=SERVE_CHUNK)
    args.update(kw)
    return ContinuousEngine(cfg, params, **args)


@torch.inference_mode()
def run_serve_continuous(label="serve-continuous"):
    """StableLM-1.6B at full width and depth (bf16, weights from seed 0)
    through ``repro_torch.launch.serve.main --engine continuous``: 8
    requests, prompts of 64-512 tokens, 32 greedy tokens each, 4 slots,
    16-token pages, 32-token prefill chunks, 1024 positions a slot. The
    run's launches must equal what the code predicts (per paged step and
    sampler call); one decode step alone must launch exactly the predicted
    count (24 paged attentions among them). Reports prefill ms a chunk, TTFT,
    decode step ms, decode tok/s, peak memory and the busy share of one
    profiled decode step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    _zero_serve_counts()
    eng = launch_serve.main(SERVE_ARGV)
    torch.cuda.synchronize()
    counts = _serve_counts()
    flash = _counts()
    cfg, params = eng.cfg, eng.params
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prompts = launch_serve.continuous_prompts(cfg.vocab, SERVE_REQUESTS,
                                              SERVE_MIN_PROMPT, SERVE_PROMPT,
                                              SERVE_SEED)
    chunks = sum(-(-len(p) // SERVE_CHUNK) for p in prompts)
    steps = chunks + eng.decode_steps
    per_chunk = _step_launches(cfg, decode=False)
    want = {k: per_chunk[k] * steps for k in per_chunk}
    want["row_log_softmax"] = SERVE_REQUESTS + eng.decode_steps
    results = eng.results
    in_range = all(len(results[i]) == SERVE_GEN and all(
        0 <= t < cfg.padded_vocab for t in results[i])
        for i in range(SERVE_REQUESTS))
    finite = all(np.isfinite(eng.result_logprobs[i]).all()
                 and (eng.result_logprobs[i] <= 0).all()
                 for i in range(SERVE_REQUESTS))

    # one decode step alone: 4 requests admitted and prefilled, then a step
    # with nothing to admit
    probe = _continuous_engine(params, cfg)
    for i in range(SERVE_SLOTS):
        probe.submit(prompts[i], req_id=i, max_new_tokens=SERVE_GEN)
    probe.step()
    torch.cuda.synchronize()
    _zero_serve_counts()
    probe.step()
    torch.cuda.synchronize()
    per_decode = _serve_counts()
    want_decode = _step_launches(cfg)
    # the busy share of one profiled decode step
    prof, ops_ = _profiled(probe.step, top=8)
    wall_ms, busy_ms = prof["wall_ms"], prof["device_busy_ms"]
    top = prof["top"]
    # unprofiled decode steps of the probe, and prefill chunks alone
    decode_ms = [s * 1e3 for s in eng.decode_s]
    table = torch.from_numpy(probe.cache.page_table[[SERVE_SLOTS - 1]]).cuda()
    chunk_toks = torch.tensor([prompts[0][:SERVE_CHUNK]], device="cuda")
    chunk_pos = torch.arange(SERVE_CHUNK, dtype=torch.int32,
                             device="cuda")[None]
    trash = probe.cache.layout.trash_page
    wp = torch.full((SERVE_CHUNK,), trash, dtype=torch.int32, device="cuda")
    wo = torch.arange(SERVE_CHUNK, dtype=torch.int32,
                      device="cuda") % SERVE_PAGE
    chunk_ms = []
    for _ in range(6):
        _, dt = _timed(lambda: T.paged_step(params, probe.cache.pools,
                                            chunk_toks, chunk_pos, table, wp,
                                            wo, cfg))
        chunk_ms.append(dt * 1e3)
    del probe
    first_tokens = SERVE_REQUESTS
    decode_tokens = sum(len(v) for v in results.values()) - first_tokens
    ttft_steps = [eng.first_token_step[i] for i in range(SERVE_REQUESTS)]
    ttft_ms = [eng.ttft_s[i] * 1e3 for i in range(SERVE_REQUESTS)]
    result = dict(
        arch=cfg.name, params=count_params(params),
        entry="repro_torch.launch.serve.main " + " ".join(SERVE_ARGV),
        requests=SERVE_REQUESTS, prompt_lens=[len(p) for p in prompts],
        new_tokens=SERVE_GEN, slots=SERVE_SLOTS, page_size=SERVE_PAGE,
        prefill_chunk=SERVE_CHUNK, max_seq=SERVE_MAX_SEQ,
        run_s=eng.run_s, engine_steps=eng.engine_steps,
        decode_steps=eng.decode_steps, prefill_chunks=chunks,
        launches=counts, launches_expected=want,
        flash_launches=flash,
        launches_per_decode_step=per_decode,
        launches_per_decode_step_expected=want_decode,
        prefill_chunk_ms=statistics.median(chunk_ms[1:]),
        prefill_chunk_ms_all=chunk_ms,
        decode_step_ms_median=statistics.median(decode_ms),
        decode_step_ms_p90=sorted(decode_ms)[int(0.9 * len(decode_ms))],
        decode_tok_per_s=decode_tokens / sum(eng.decode_s),
        ttft_engine_steps=ttft_steps, ttft_ms=ttft_ms,
        ttft_ms_median=statistics.median(ttft_ms),
        peak_mem_gb=peak_gb, tokens_in_range=in_range,
        logprobs_finite_nonpositive=finite,
        tokens_req0=[int(t) for t in results[0][:8]])
    print(f"[{label}] " + json.dumps(result), flush=True)
    by_kernel = {k: sum(a.self_device_time_total for a in ops_
                        if name in a.key) / 1e3
                 for k, name in (("gemm", "gemm_bf16"),
                                 ("paged_attention", "paged_attn"),
                                 ("row_norm", "row_norm"),
                                 ("row_log_softmax", "row_log_softmax"))}
    print(f"[{label}-profile] " + json.dumps(dict(
        step="one decode step over 4 live slots", wall_ms_traced=wall_ms,
        device_busy_ms=busy_ms, host_ms=wall_ms - busy_ms,
        busy_share=busy_ms / wall_ms, device_ms_by_kernel=by_kernel,
        step_ms_unprofiled=statistics.median(decode_ms),
        unprofiled_step_beyond_device_ms=statistics.median(decode_ms)
        - busy_ms,
        device_ops=sum(a.count for a in ops_), top_device_ops=top,
        first_design=FIRST_DESIGN_DECODE_STEP)), flush=True)
    if counts != want or any(flash.values()):
        raise AssertionError(f"the continuous run launched {counts} (flash "
                             f"{flash}), expected {want} and no flash kernel")
    if per_decode != want_decode:
        raise AssertionError(f"one decode step launched {per_decode}, "
                             f"expected {want_decode}")
    if not (in_range and finite):
        raise AssertionError("continuous serving gave tokens out of range or "
                             "non-finite logprobs")
    return result, eng


def run_serve_moe(label="serve-moe"):
    """Each config of ``SERVE_MOE`` through the static engine as
    :func:`run_slice` drives StableLM (twice, bitwise; the prefill's causal
    forward once a layer; prefill logits against the plain attention's);
    then ``launch.serve --engine continuous`` with the first MoE arch
    (``--reduced``) must raise the paged engine's refusal."""
    out = []
    for slice_ in SERVE_MOE:
        _free_device_memory()
        out.append(run_slice(slice_, label))
    _free_device_memory()
    argv = ["--engine", "continuous", "--arch", SERVE_MOE[0]["arch"],
            "--reduced"]
    try:
        launch_serve.main(argv)
    except NotImplementedError as e:
        refusal = str(e)
    else:
        raise AssertionError(f"launch.serve {' '.join(argv)} served an MoE "
                             f"arch on the paged engine")
    print(f"[{label}-refusal] " + json.dumps(dict(
        entry="repro_torch.launch.serve.main " + " ".join(argv),
        refusal=refusal)), flush=True)
    if "MoE capacity routing is batch-coupled" not in refusal:
        raise AssertionError(f"the paged engine refused with {refusal!r}")
    return out


def run_serve_jamba(label="serve-jamba"):
    """``SERVE_JAMBA`` through the static engine as :func:`run_slice`
    drives StableLM: greedy twice (bitwise), the causal forward once for
    its attention layer and the scan forward once a Mamba layer in the
    prefill and in each decode step, prefill logits against the plain
    attention and plain scan with the router's choices pinned; then
    ``launch.serve --engine continuous --arch`` Jamba must raise the paged
    engine's refusal (its SSM states are unpaged)."""
    _free_device_memory()
    out = run_slice(SERVE_JAMBA, label)
    _free_device_memory()
    argv = ["--engine", "continuous", "--arch", SERVE_JAMBA["arch"],
            "--reduced"]
    try:
        launch_serve.main(argv)
    except NotImplementedError as e:
        refusal = str(e)
    else:
        raise AssertionError(f"launch.serve {' '.join(argv)} served a Mamba "
                             f"arch on the paged engine")
    print(f"[{label}-refusal] " + json.dumps(dict(
        entry="repro_torch.launch.serve.main " + " ".join(argv),
        refusal=refusal)), flush=True)
    if "SSM states are unpaged" not in refusal:
        raise AssertionError(f"the paged engine refused with {refusal!r}")
    return out


def run_train_jamba(label="train-jamba"):
    """Jamba's (mamba, attn) cut at full width through the train launcher
    as :func:`run_train` drives it (``TRAIN_JAMBA_ARGV``): two runs with
    equal digest chains and fingerprints, the launches a step (the scan's
    forward twice, its backward and fold once for the Mamba layer; the
    flash kernels for the attention layer), step 1 at S=1024 within
    ``LOSS_RTOL``/``GNORM_RTOL`` of the plain attention and plain scan."""
    _free_device_memory()
    out = run_train(TRAIN_JAMBA_ARGV, label,
                    compare_argv=TRAIN_JAMBA_COMPARE_ARGV)
    _free_device_memory()
    return out


def _reversed_qk_parallel(q, k, v, ig, fg):
    """The plain parallel form with q . k summed over hd in reverse: the
    same function, rounded otherwise. Run beside the plain mixers, it reads
    how far rounding alone moves the model's step 1."""
    qk = torch.einsum("bihe,bjhe->bijh", q.float().flip(-1),
                      k.float().flip(-1))
    return MLSTM.mlstm_parallel_from_qk(qk, v, ig, fg)


def _xlstm_step1(cfg, batch, seed, control=False):
    """Step 1's loss, grad norm (the train step's: fp32 squares summed in
    tree order) and every mixer leaf's grads (``blocks/*/mlstm/*``,
    ``blocks/*/slstm/*``) through the kernels and through the plain mixers
    (:func:`_plain_mixers`) on the same weights (from ``seed``) and batch,
    remat on as the launcher trains: the two losses' and grad norms'
    relative differences, and per leaf the largest over its layers of
    |g_kernels - g_plain| / |g_plain| (for ``XLSTM_ZERO_GRAD_LEAVES``, over
    the norm of its layer's mixer grads). With ``control``, the same
    errors of the plain mixers with q . k reversed
    (:func:`_reversed_qk_parallel`) against the plain mixers: what
    rounding alone moves (``control_*``)."""
    params = T.init(cfg, seed=seed, device="cuda")
    paths = [p for p, _ in tree_paths(params)]
    mixer = [i for i, p in enumerate(paths)
             if p.split("/")[-2] in ("mlstm", "slstm")]

    def step1():
        leaves = [x.detach().requires_grad_(True)
                  for x in O.tree_leaves(params)]
        tree = {}
        for path, leaf in zip(paths, leaves):
            set_path(tree, path, leaf)
        loss, _ = T.loss_fn(tree, batch, cfg, remat=True)
        grads = torch.autograd.grad(loss, leaves)
        total = None
        for g in grads:
            sq = torch.sum(torch.square(g.to(torch.float32)))
            total = sq if total is None else total + sq
        return (float(loss.detach()), float(torch.sqrt(total)),
                {paths[i]: grads[i].float() for i in mixer})

    kernel = step1()
    with _plain_mixers():
        plain = step1()
        if control:
            MLSTM.mlstm_parallel = _reversed_qk_parallel
            other = step1()
    layer_norm = {}                    # (block, layer): |its mixer grads|
    for path, w in plain[2].items():
        for i, x in enumerate(w):
            key = (path.rsplit("/", 1)[0], i)
            layer_norm[key] = layer_norm.get(key, 0.0) + float(
                torch.sum(torch.square(x)))

    def errors(run, prefix=""):
        loss, gnorm, got = run
        err = {path: max((torch.linalg.vector_norm(a - b) / (
            layer_norm[(path.rsplit("/", 1)[0], i)] ** 0.5
            if path.endswith(XLSTM_ZERO_GRAD_LEAVES)
            else torch.linalg.vector_norm(b))).item()
            for i, (a, b) in enumerate(zip(got[path], plain[2][path])))
            for path in got}
        return {prefix + k: v for k, v in dict(
            loss=loss, loss_rel_diff=abs(loss - plain[0]) / abs(plain[0]),
            grad_norm=gnorm,
            gnorm_rel_diff=abs(gnorm - plain[1]) / abs(plain[1]),
            mixer_grad_rel_err=err,
            max_mixer_grad_rel_err=max(err.values())).items()}
    out = dict(layers=cfg.n_layers, pattern=list(cfg.block_pattern),
               dtype=cfg.dtype_name, plain_loss=plain[0],
               plain_grad_norm=plain[1], **errors(kernel))
    if control:
        out.update(errors(other, "control_"))
    return out


def run_train_xlstm(label="train-xlstm"):
    """xLSTM-350M at full width and depth through the train launcher as
    :func:`run_train` drives it (``TRAIN_XLSTM_ARGV``): two runs with
    equal digest chains and fingerprints, the launches a step (per mLSTM
    layer the parallel forward twice and its backward's passes once, per
    sLSTM layer its forward twice and its backward once, one
    fingerprint), weights that move, finite losses, the profiled step's
    top device ops; the bf16 model's step 1 at 24 layers against the plain
    mixers' a reading. Then step 1 against the plain mixers on the
    launcher's seed and first batch (:func:`_xlstm_step1`), gated where the
    model is well conditioned: the fp32 model at 24 layers (loss within
    ``LOSS_RTOL``, grad norm within ``GNORM_RTOL``; its mixer leaves a
    reading beside the control's), at ``XLSTM_FP32_LEAF_LAYERS`` (the same
    limits, every mixer leaf per layer within ``XLSTM_FP32_GRAD_RTOL``; the
    control printed beside it, a reading) and
    the bf16 model at ``XLSTM_CUT`` (one mLSTM and the sLSTM layer: the
    same loss and grad norm limits, the leaves within
    ``ATTN_GRAD_RTOL``)."""
    _free_device_memory()
    out = run_train(TRAIN_XLSTM_ARGV, label, gate_step1=False)
    _free_device_memory()
    args, cfg, _, data, _ = launch_train.configure(TRAIN_XLSTM_ARGV)
    batch = data.batch(0)
    fp32 = cfg.replace(dtype_name="float32")
    torch.use_deterministic_algorithms(True)
    try:
        full = _xlstm_step1(fp32, batch, args.seed, control=True)
        gated = dict(
            fp32_leaves=(_xlstm_step1(launch_train.cut_layers(
                fp32, XLSTM_FP32_LEAF_LAYERS), batch, args.seed,
                control=True), XLSTM_FP32_GRAD_RTOL),
            bf16_cut=(_xlstm_step1(launch_train.cut_layers(cfg, XLSTM_CUT),
                                   batch, args.seed), ATTN_GRAD_RTOL))
    finally:
        torch.use_deterministic_algorithms(False)
    _free_device_memory()
    result = {k: dict(r, grad_rtol=tol, loss_rtol=LOSS_RTOL,
                      gnorm_rtol=GNORM_RTOL) for k, (r, tol) in gated.items()}
    result["fp32_24_layers"] = dict(full, loss_rtol=LOSS_RTOL,
                                    gnorm_rtol=GNORM_RTOL,
                                    mixer_grads_gated=False)
    result["bf16_24_layers_reading"] = dict(
        loss_rel_diff=out["loss_rel_diff"],
        gnorm_rel_diff=out["gnorm_rel_diff"], gated=False)
    print(f"[{label}-step1] " + json.dumps(result), flush=True)
    checks = [(k, r, tol) for k, (r, tol) in gated.items()]
    checks.append(("fp32_24_layers", full, None))
    off = [f"{k}: {name}" for k, r, tol in checks
           for name, bad in (("loss", r["loss_rel_diff"] > LOSS_RTOL),
                             ("grad norm", r["gnorm_rel_diff"] > GNORM_RTOL),
                             ("mixer grads", tol is not None and
                              r["max_mixer_grad_rel_err"] > tol))
           if bad]
    if off:
        raise AssertionError(f"xLSTM-350M's step 1 through the kernels vs "
                             f"the plain mixers beyond its limits: {off}")
    return dict(out, step1=result)


@torch.inference_mode()
def run_serve_nemotron(label="serve-nemotron"):
    """Nemotron-4-15B at full width (squared ReLU, LayerNorm, half rotary,
    48 heads over 8 KV heads, vocab 256000), ``NEMOTRON_LAYERS`` layers,
    through the continuous engine over ``[serve-continuous]``'s traffic at
    each slot count of ``NEMOTRON_SLOTS``: every request's tokens and
    logprobs bitwise the first run's, tokens in range, logprobs finite and
    <= 0, the launches the engine's work predicts (6 GEMMs a layer: no gate);
    decode step ms, tok/s, TTFT and peak memory."""
    cfg = registry.get("nemotron-4-15b").replace(n_layers=NEMOTRON_LAYERS)
    params = T.init(cfg, seed=0, device="cuda")
    prompts, lens = _serve_prompts(cfg)
    runs, ref = [], None
    for slots in NEMOTRON_SLOTS:
        torch.cuda.reset_peak_memory_stats()
        eng, counts, flash = _counted(
            lambda: _serve_all(params, cfg, prompts, n_slots=slots))
        want = _predicted_launches(cfg, CF.engine_work(eng, lens))
        if ref is None:
            ref = eng
        decode_ms = [t * 1e3 for t in eng.decode_s]
        decode_tokens = (sum(len(v) for v in eng.results.values())
                         - SERVE_REQUESTS)
        ok_values = all(
            len(eng.results[i]) == SERVE_GEN
            and all(0 <= t < cfg.padded_vocab for t in eng.results[i])
            and np.isfinite(eng.result_logprobs[i]).all()
            and (eng.result_logprobs[i] <= 0).all()
            for i in range(SERVE_REQUESTS))
        runs.append(dict(
            slots=slots, run_s=eng.run_s, engine_steps=eng.engine_steps,
            decode_steps=eng.decode_steps,
            decode_step_ms_median=statistics.median(decode_ms),
            decode_tok_per_s=decode_tokens / sum(eng.decode_s),
            ttft_ms_median=statistics.median(
                [eng.ttft_s[i] * 1e3 for i in range(SERVE_REQUESTS)]),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=counts, launches_expected=want, flash_launches=flash,
            mismatched=_bitwise_streams(ref, eng, range(SERVE_REQUESTS)),
            values_ok=ok_values,
            tokens_req0=[int(t) for t in eng.results[0][:8]]))
    result = dict(arch=cfg.name, layers=cfg.n_layers,
                  params=count_params(params), activation=cfg.activation,
                  heads=[cfg.n_heads, cfg.n_kv_heads], vocab=cfg.vocab,
                  requests=SERVE_REQUESTS, prompt_lens=list(lens.values()),
                  new_tokens=SERVE_GEN, runs=runs)
    print(f"[{label}] " + json.dumps(result), flush=True)
    for r in runs:
        if r["launches"] != r["launches_expected"] or any(
                r["flash_launches"].values()):
            raise AssertionError(f"{label} at {r['slots']} slots launched "
                                 f"{r['launches']} (flash "
                                 f"{r['flash_launches']}), expected "
                                 f"{r['launches_expected']}")
        if r["mismatched"] or not r["values_ok"]:
            raise AssertionError(f"{label} at {r['slots']} slots: requests "
                                 f"{r['mismatched']} differ from "
                                 f"{NEMOTRON_SLOTS[0]} slots', values ok: "
                                 f"{r['values_ok']}")
    return result


def _served(eng, ids):
    return {i: (np.asarray(eng.results[i]), eng.result_logprobs[i])
            for i in ids}


@torch.inference_mode()
def run_serve_invariance(base_eng, label="serve-invariance"):
    """The requests of ``[serve-continuous]`` again: per request, tokens and
    logprobs bitwise equal to that run across a second run, request subsets
    ({0}, {0,2}, {1,3} of all 8), 2 slots, prefill chunks 16 and 64, a tight
    pool that forces page reuse; seeded sampling (temperature 1, top_k 20)
    bitwise equal across subsets and slots; captured prefill logits bitwise
    equal across chunks 16/32/64 and within ``LOGITS_ATOL`` of the plain
    attention's (the training forward, cuBLAS GEMMs)."""
    cfg, params = base_eng.cfg, base_eng.params
    prompts = launch_serve.continuous_prompts(cfg.vocab, SERVE_REQUESTS,
                                              SERVE_MIN_PROMPT, SERVE_PROMPT,
                                              SERVE_SEED)
    all_ids = list(range(SERVE_REQUESTS))
    base = _served(base_eng, all_ids)

    def run(ids, **kw):
        eng = _continuous_engine(params, cfg, **kw)
        for i in ids:
            eng.submit(prompts[i], req_id=i, max_new_tokens=SERVE_GEN)
        t0 = time.perf_counter()
        eng.run()
        return eng, time.perf_counter() - t0

    def same(ref, eng, ids):
        got = _served(eng, ids)
        return all(np.array_equal(ref[i][0], got[i][0])
                   and np.array_equal(ref[i][1], got[i][1]) for i in ids)

    checks, seconds = {}, {}
    pages_one = -(-(max(len(p) for p in prompts) + SERVE_GEN) // SERVE_PAGE)
    greedy = [("second_run", all_ids, {}), ("subset_0", [0], {}),
              ("subset_0_2", [0, 2], {}), ("subset_1_3", [1, 3], {}),
              ("slots_2", all_ids, {"n_slots": 2}),
              ("chunk_16", all_ids, {"prefill_chunk": 16,
                                     "capture_prefill_logits": True}),
              ("chunk_64", all_ids, {"prefill_chunk": 64,
                                     "capture_prefill_logits": True}),
              ("chunk_32_capture", all_ids, {"capture_prefill_logits": True}),
              ("tight_pool", all_ids, {"n_pages": pages_one + 8})]
    captured = {}
    for name, ids, kw in greedy:
        eng, seconds[name] = run(ids, **kw)
        checks[name] = same(base, eng, ids)
        if kw.get("capture_prefill_logits"):
            captured[kw.get("prefill_chunk", SERVE_CHUNK)] = eng.prefill_logits
        del eng
    logits_bitwise = all(
        np.array_equal(captured[32][i], captured[c][i])
        for c in (16, 64) for i in all_ids)
    scfg = SampleConfig(temperature=1.0, top_k=20, seed=SERVE_SEED)
    sampled_all, seconds["sampled_all"] = run(all_ids, scfg=scfg)
    sampled = _served(sampled_all, all_ids)
    for name, ids, kw in (("sampled_subset_1_3", [1, 3], {}),
                          ("sampled_slots_2", all_ids, {"n_slots": 2})):
        eng, seconds[name] = run(ids, scfg=scfg, **kw)
        checks[name] = same(sampled, eng, ids)
    differs = any(not np.array_equal(sampled[i][0], base[i][0])
                  for i in all_ids)
    # prefill logits against the plain attention's on two prompts
    plain_cfg = cfg.replace(attention_impl="torch")
    errs = []
    for i in (0, 1):
        toks = torch.tensor([prompts[i]], device="cuda")
        plain_logits = T.forward(params, {"tokens": toks}, plain_cfg)[0][0]
        errs.append(float(np.abs(plain_logits.float().cpu().numpy()
                                 - captured[32][i]).max()))
        del plain_logits
    result = dict(checks=checks, prefill_logits_bitwise_across_chunks=
                  logits_bitwise, prefill_logits_max_abs_err_vs_plain=errs,
                  logits_atol=LOGITS_ATOL, sampled_differs_from_greedy=differs,
                  tight_pool_pages=pages_one + 8, seconds=seconds)
    print(f"[{label}] " + json.dumps(result), flush=True)
    if not (all(checks.values()) and logits_bitwise and differs):
        raise AssertionError(f"serve invariance failed: {result}")
    if max(errs) > LOGITS_ATOL:
        raise AssertionError(f"prefill logits vs the plain attention: {errs} "
                             f"> {LOGITS_ATOL}")
    return result


def _serve_prompts(cfg):
    prompts = launch_serve.continuous_prompts(cfg.vocab, SERVE_REQUESTS,
                                              SERVE_MIN_PROMPT, SERVE_PROMPT,
                                              SERVE_SEED)
    return prompts, {i: len(p) for i, p in enumerate(prompts)}


def _predicted_launches(cfg, work, dcfg=None):
    """A run's launches from what its engines dispatched
    (``conformance.engine_work``): each paged step of the target or the
    drafter launches ``_step_launches``, each sampler call one row
    log-softmax."""
    per = _step_launches(cfg, decode=False)
    dper = _step_launches(dcfg or cfg, decode=False)
    want = {k: per[k] * work["paged_steps"] + dper[k] * work["draft_steps"]
            for k in per}
    want["row_log_softmax"] = work["sampler_calls"]
    return want


def _counted(fn):
    """``fn()`` with every launch counter set to 0 just before: (its
    result, the serve kernels' launches, the flash kernels')."""
    torch.cuda.synchronize()
    _zero_counts()
    _zero_serve_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, _serve_counts(), _counts()


def _bitwise_streams(ref, eng, ids):
    """Requests whose tokens or logprobs differ from ``ref``'s."""
    return [i for i in ids if i not in eng.results
            or not np.array_equal(np.asarray(ref.results[i]),
                                  np.asarray(eng.results[i]))
            or not np.array_equal(ref.result_logprobs[i],
                                  eng.result_logprobs[i])]


def _drained(eng):
    return (eng.cache.free_pages == eng.cache.layout.n_pages
            and not eng._quarantine and eng.sched.idle)


def _serve_all(params, cfg, prompts, **kw):
    eng = _continuous_engine(params, cfg, **kw)
    for i, p in enumerate(prompts):
        eng.submit(p, req_id=i, max_new_tokens=SERVE_GEN)
    eng.run()
    return eng


def _spec_report(name, eng, ref, lens, counts, flash, dcfg=None):
    sp = eng.spec
    decode_tokens = (sum(len(v) for v in eng.results.values())
                     - len(eng.first_token_step))
    want = _predicted_launches(eng.cfg, CF.engine_work(eng, lens), dcfg)
    round_ms = [s * 1e3 for s in eng.decode_s]
    ref_ms = [s * 1e3 for s in ref.decode_s]
    return dict(
        run=name, spec_k=sp.k, self_draft=sp.self_draft,
        mismatched=_bitwise_streams(ref, eng, range(SERVE_REQUESTS)),
        rounds=sp.rounds, acceptance=sp.acceptance_rate(),
        accepted=sp.accepted, drafted=sp.drafted, truncated=sp.truncated,
        draft_steps=sp.draft_steps,
        tokens_per_round=decode_tokens / sp.rounds,
        round_ms_median=statistics.median(round_ms),
        round_ms_p90=sorted(round_ms)[int(0.9 * len(round_ms))],
        decode_tok_per_s=decode_tokens / sum(eng.decode_s),
        plain_decode_step_ms_median=statistics.median(ref_ms),
        plain_decode_tok_per_s=(sum(len(v) for v in ref.results.values())
                                - SERVE_REQUESTS) / sum(ref.decode_s),
        run_s=eng.run_s, launches=counts, launches_expected=want,
        flash_launches=flash)


@torch.inference_mode()
def run_serve_spec(base, label="serve-spec"):
    """Speculative decoding (``--spec-k 4``) on ``[serve-continuous]``'s
    traffic at full width: (a) self-draft, greedy, through the launcher;
    (b) self-draft, sampled (temperature 0.7, top-k 20, seed 11), against a
    plain sampled run of the same engine; (c) a separate full-width drafter
    (``--draft-model stablelm-1.6b``, weights from seed 1), which rejects
    nearly every draft. Each: tokens and logprobs bitwise the plain run's,
    launches equal to what its rounds, draft steps and prefill chunks
    predict."""
    cfg, params = base.cfg, base.params
    prompts, lens = _serve_prompts(cfg)
    spec_argv = SERVE_ARGV + ["--spec-k", str(SPEC_K)]
    reports = []
    eng, counts, flash = _counted(lambda: launch_serve.main(spec_argv))
    reports.append(_spec_report("self_greedy", eng, base, lens, counts,
                                flash))
    del eng
    scfg = SampleConfig(**SPEC_SAMPLED)
    plain = _serve_all(params, cfg, prompts, scfg=scfg)
    eng, counts, flash = _counted(lambda: _serve_all(
        params, cfg, prompts, scfg=scfg, spec_k=SPEC_K))
    reports.append(_spec_report("self_sampled", eng, plain, lens, counts,
                                flash))
    sampled_differs = any(not np.array_equal(plain.results[i],
                                             base.results[i])
                          for i in range(SERVE_REQUESTS))
    del eng, plain
    eng, counts, flash = _counted(lambda: launch_serve.main(
        spec_argv + ["--draft-model", SPEC_DRAFTER]))
    reports.append(_spec_report("separate_drafter", eng, base, lens, counts,
                                flash, eng.spec.dcfg))
    del eng
    _free_device_memory()
    for r in reports:
        print(f"[{label}] " + json.dumps(r), flush=True)
    bad = [r["run"] for r in reports
           if r["mismatched"] or r["launches"] != r["launches_expected"]
           or any(r["flash_launches"].values())]
    if bad:
        raise AssertionError(f"speculative runs not bitwise the plain ones "
                             f"or launching other than predicted: {bad}")
    if not (reports[0]["acceptance"] == reports[1]["acceptance"] == 1.0
            and reports[2]["acceptance"] < 1.0 and sampled_differs):
        raise AssertionError("self-draft acceptance is not 1.0, the drafter "
                             "accepted every draft, or the sampled run is "
                             "the greedy one")
    return reports


@torch.inference_mode()
def run_serve_obs(base, label="serve-obs"):
    """``[serve-continuous]``'s traffic through the launcher again with
    ``--track`` and ``--trace-out``, plain and with ``--spec-k 4``
    (self-draft): tokens and logprobs bitwise the unarmed run's (``base``;
    the unarmed ``--spec-k 4`` run of ``[serve-spec]`` is bitwise it too);
    launches as predicted; span counts exactly as the engine's telemetry
    predicts (a request, queue and prefill span a request, a chunk span a
    prefill chunk, a decode span a decode step or a round span a round);
    the trace valid with its modeled and achieved lanes, the achieved one
    timed on the CUDA backward kernels. Prints ``RunReport``'s TTFT and
    per-token percentiles beside the engine's own TTFT median."""
    cfg = base.cfg
    _, lens = _serve_prompts(cfg)
    chunks = sum(-(-n // SERVE_CHUNK) for n in lens.values())
    tmp = tempfile.mkdtemp(prefix="repro_torch_serve_obs_")
    lines = []
    try:
        for name, extra in (("plain", []),
                            ("spec_self", ["--spec-k", str(SPEC_K)])):
            track = os.path.join(tmp, f"{name}.jsonl")
            trace = os.path.join(tmp, f"{name}.json")
            eng, counts, flash = _counted(lambda: launch_serve.main(
                SERVE_ARGV + extra + ["--track", track, "--trace-out",
                                      trace]))
            events = OBS.read_jsonl(track)
            spans = {}
            for e in events:
                if e["event"] == "span":
                    spans[e["phase"]] = spans.get(e["phase"], 0) + 1
            want_spans = dict(request=SERVE_REQUESTS, queue=SERVE_REQUESTS,
                              prefill=SERVE_REQUESTS, prefill_chunk=chunks)
            if eng.spec is not None:
                want_spans["spec_round"] = eng.spec.rounds
            else:
                want_spans["decode"] = eng.decode_steps
            with open(trace) as f:
                obj = json.load(f)
            invalid = OBS_EX.validate_trace(
                obj, (OBS_EX.PROCESS_MODELED, OBS_EX.PROCESS_ACHIEVED))
            rep = OBS.RunReport.from_jsonl(track)
            want = _predicted_launches(cfg, CF.engine_work(eng, lens))
            ttft = rep.latency.get("ttft_s", {})
            per_token = rep.latency.get("per_token_s", {})
            lines.append(dict(
                run=name, mismatched=_bitwise_streams(
                    base, eng, range(SERVE_REQUESTS)),
                spans=spans, spans_expected=want_spans,
                events=len(events), trace_events=len(obj["traceEvents"]),
                trace_problems=invalid[:3], launches=counts,
                launches_expected=want, timeline_flash_launches=flash,
                report_ttft_ms={k: ttft[k] * 1e3 for k in ("p50", "p90",
                                                           "p99")
                                if k in ttft},
                report_per_token_ms={k: per_token[k] * 1e3
                                     for k in ("p50", "p90", "p99")
                                     if k in per_token},
                engine_ttft_ms_median=statistics.median(
                    eng.ttft_s.values()) * 1e3,
                report_decode_tokens_per_s=rep.throughput.get(
                    "decode_tokens_per_s"),
                run_s=eng.run_s, unarmed_run_s=base.run_s,
                counters=rep.counters))
            del eng
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _free_device_memory()
    for line in lines:
        print(f"[{label}] " + json.dumps(line), flush=True)
    bad = [r["run"] for r in lines
           if r["mismatched"] or r["spans"] != r["spans_expected"] or r["trace_problems"]
            or r["launches"] != r["launches_expected"]
            or r["timeline_flash_launches"]["fwd_causal"] != 1
            or r["timeline_flash_launches"]["bwd_worker"]
            + r["timeline_flash_launches"]["bwd_serial"]
            != TIMELINE_BWD_CALLS]
    if bad:
        raise AssertionError(f"[{label}] tracked runs not bitwise the "
                             f"unarmed one, spans or launches other than "
                             f"predicted, or an invalid trace: {bad}")
    return lines


def _crash_restore(base, spec_k, lens, prompts):
    """A crash at ``CRASH_AT`` with a snapshot every ``SNAPSHOT_EVERY``
    engine steps (under ``CKPT_ROOT``), restored through
    ``ContinuousEngine.from_snapshot`` and run to its end, over the first
    ``CRASH_REQUESTS[spec_k]`` requests."""
    cfg, params = base.cfg, base.params
    ids = range(CRASH_REQUESTS[spec_k])
    tmp = tempfile.mkdtemp(prefix="serve_snapshot_", dir=CKPT_ROOT)
    try:
        inj = Injector(FaultPlan(name=f"crash@{CRASH_AT}",
                                 faults=(Fault(CRASH_AT, "crash"),)))

        def run():
            eng1 = _continuous_engine(params, cfg, faults=inj,
                                      snapshot_dir=tmp,
                                      snapshot_every=SNAPSHOT_EVERY,
                                      spec_k=spec_k)
            for i in ids:
                eng1.submit(prompts[i], req_id=i, max_new_tokens=SERVE_GEN)
            try:
                eng1.run()
            except EngineCrash:
                pass
            else:
                raise AssertionError("the planned crash did not land")
            step = CK.latest_step(tmp)
            nbytes = _dir_bytes(os.path.join(tmp, f"step_{step}"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng2 = ContinuousEngine.from_snapshot(tmp, cfg, params,
                                                  faults=inj)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            since = CF.restored_at(eng2)
            eng2.run()
            return eng1, eng2, since, step, nbytes, restore_s

        (eng1, eng2, since, step, nbytes, restore_s), counts, flash = \
            _counted(run)
        fs = _filesystem(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    w1, w2 = CF.engine_work(eng1, lens), CF.engine_work(eng2, lens, since)
    want = _predicted_launches(cfg, {k: w1[k] + w2[k] for k in w1})
    save_s = eng1.snapshot_s + eng2.snapshot_s
    return dict(
        run=f"crash_restore{'_spec' if spec_k else ''}", spec_k=spec_k,
        requests=len(ids), crash_at=CRASH_AT, snapshot_every=SNAPSHOT_EVERY,
        restored_from_step=step, crashed=bool(inj.history)
        and inj.history[-1]["kind"] == "crash",
        mismatched=_bitwise_streams(base, eng2, ids),
        drained=_drained(eng2), snapshots=len(save_s),
        snapshot_bytes=nbytes, snapshot_save_s_median=statistics.median(
            save_s), snapshot_save_s=save_s, restore_s=restore_s,
        filesystem=fs, engine_steps=eng2.engine_steps,
        launches=counts, launches_expected=want, flash_launches=flash)


@torch.inference_mode()
def run_serve_chaos(base, label="serve-chaos"):
    """Faults on ``[serve-continuous]``'s traffic at full width: (a) the
    launcher's ``--chaos 1`` (seeded pool exhaustion, slot revocations,
    decode stalls); (b) a crash at engine step 7 with a snapshot every 6
    steps, restored through ``ContinuousEngine.from_snapshot`` (the first
    4 requests); (c) the same with ``spec_k=4`` (all 8). Every request
    bitwise the fault-free run's, tokens
    and logprobs; the engine drained (every page free, no quarantine, the
    scheduler idle); launches as predicted, the recompute-restores'
    prefill chunks included."""
    cfg = base.cfg
    prompts, lens = _serve_prompts(cfg)
    eng, counts, flash = _counted(lambda: launch_serve.main(
        SERVE_ARGV + ["--chaos", str(CHAOS_SEED)]))
    inj = eng.faults
    reports = [dict(
        run="seeded_chaos", plan=inj.plan.key(), scheduled=len(inj.plan),
        faults_landed=len(inj.history),
        landed_kinds={k: sum(e["kind"] == k for e in inj.history)
                      for k in ("pool_exhaust", "revoke_slot",
                                "decode_stall")},
        preemptions=eng.preemptions, history_digest=inj.history_digest(),
        restore_positions=eng.restore_positions,
        mismatched=_bitwise_streams(base, eng, range(SERVE_REQUESTS)),
        drained=_drained(eng), engine_steps=eng.engine_steps,
        decode_steps=eng.decode_steps, run_s=eng.run_s, launches=counts,
        launches_expected=_predicted_launches(cfg, CF.engine_work(eng, lens)),
        flash_launches=flash)]
    del eng
    for spec_k in (0, SPEC_K):
        reports.append(_crash_restore(base, spec_k, lens, prompts))
    _free_device_memory()
    for r in reports:
        print(f"[{label}] " + json.dumps(r), flush=True)
    bad = [r["run"] for r in reports
           if r["mismatched"] or not r["drained"]
           or r["launches"] != r["launches_expected"]
           or any(r["flash_launches"].values())]
    if bad or not reports[0]["preemptions"] or not all(
            r["crashed"] for r in reports[1:]):
        raise AssertionError(f"serving under faults: not bitwise, not "
                             f"drained, launches other than predicted, or a "
                             f"fault that never landed: {bad}")
    return reports


def run_chaos_matrix(label="chaos-matrix"):
    """``repro_torch.faults.conformance.run_matrix`` on the card at full
    width cut to 2 layers (snapshots and checkpoints under
    ``CKPT_ROOT``): all 11 cells ok, launches equal to what the matrix's
    engines dispatched."""
    t0 = time.perf_counter()
    rep, counts, flash = _counted(lambda: CF.run_matrix(
        device="cuda", reduced=False, overrides=CHAOS_MATRIX_OVERRIDES,
        tmp_root=CKPT_ROOT))
    cfg = registry.get(CF.ARCH).replace(**dict(CHAOS_MATRIX_OVERRIDES))
    want = _predicted_launches(cfg, rep["work"])
    line = dict(
        ok=rep["ok"], layers=cfg.n_layers, sampled=rep["config"]["sampled"],
        cells={c["cell"]: dict(ok=c["ok"], plan=c["plan"],
                               faults_landed=c["faults_landed"],
                               history_digest=(c["history_digest"] or "")[:16],
                               preemptions=c["detail"].get("preemptions"))
               for c in rep["cells"]},
        work=rep["work"], launches=counts, launches_expected=want,
        flash_launches=flash, seconds=time.perf_counter() - t0)
    print(f"[{label}] " + json.dumps(line), flush=True)
    _free_device_memory()
    if not rep["ok"] or len(rep["cells"]) != 11:
        raise AssertionError("chaos conformance cells failed: " + str(
            [c["cell"] for c in rep["cells"] if not c["ok"]]))
    if counts != want or any(flash.values()):
        raise AssertionError(f"the chaos matrix launched {counts}, expected "
                             f"{want} and no flash kernel")
    return line


def run_train_chaos(label="train-chaos"):
    """The train launcher at full width cut to 2 layers (B=2, S=1024, 3
    steps) with ``--chaos 3`` and a checkpoint every step on
    ``CKPT_ROOT``, against the same steps unarmed and without checkpoints:
    equal digest chains (neither the saves nor the faults touch the state),
    every planned IO failure landed and absorbed by the writer's retry
    (each within its budget), every save published, two causal forwards,
    a worker backward and a fold a layer and one fingerprint (``--verify``)
    a step."""
    layers = int(TRAIN_CHAOS_ARGV[TRAIN_CHAOS_ARGV.index("--layers") + 1])
    steps = int(TRAIN_CHAOS_ARGV[TRAIN_CHAOS_ARGV.index("--steps") + 1])
    want = dict(_no_launches(), fwd_causal=2 * layers, bwd_worker=layers,
                fold=layers, fingerprint=1)
    runs = {}
    t0 = time.perf_counter()
    runs["unarmed"] = dict(launch_train.main(TRAIN_CHAOS_ARGV),
                           seconds=time.perf_counter() - t0)
    d = tempfile.mkdtemp(prefix="train_chaos_", dir=CKPT_ROOT)
    try:
        t0 = time.perf_counter()
        summary = launch_train.main(TRAIN_CHAOS_ARGV + [
            "--ckpt-dir", d, "--chaos", str(TRAIN_CHAOS_SEED)])
        runs["armed"] = dict(summary, seconds=time.perf_counter() - t0)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    plan = FaultPlan.seeded_ckpt(TRAIN_CHAOS_SEED, steps=steps, every=1,
                                 rate=0.5, max_failures=CK.IO_RETRIES,
                                 name=f"train-chaos-{TRAIN_CHAOS_SEED}")
    a, b_ = runs["unarmed"], runs["armed"]
    line = dict(
        entry="repro_torch.launch.train.main " + " ".join(TRAIN_CHAOS_ARGV),
        plan=b_["chaos_plan"], plan_expected=plan.key(),
        planned_failures=[[f.step, f.arg] for f in plan.faults],
        io_retries=CK.IO_RETRIES, faults_landed=b_["chaos_faults_landed"],
        landing_digest=b_["chaos_landing_digest"],
        heads=[a["digest_chain_head"], b_["digest_chain_head"]],
        saves=len(b_["ckpt"]), write_s=[c["write_s"] for c in b_["ckpt"]],
        step_ms=[a["step_ms"], b_["step_ms"]],
        seconds=[a["seconds"], b_["seconds"]],
        launches_per_step=a["launches"][0], launches_expected=want)
    print(f"[{label}] " + json.dumps(line), flush=True)
    if a["digest_chain_head"] != b_["digest_chain_head"]:
        raise AssertionError("the chaos-armed run's digest chain differs "
                             "from the unarmed run's")
    if (b_["chaos_plan"] != plan.key() or not plan.faults
            or b_["chaos_faults_landed"] != sum(f.arg for f in plan.faults)
            or max(f.arg for f in plan.faults) > CK.IO_RETRIES
            or line["saves"] != steps):
        raise AssertionError(f"train chaos: {line}")
    if any(c != want for r in (a, b_) for c in r["launches"]):
        raise AssertionError(f"a train-chaos step launched other than "
                             f"{want}")
    return line


def run_train_serve_parity(label="lifecycle"):
    """The ``train_serve_parity`` lifecycle cell at full width cut to 2
    layers, for each of the reference's parity archs (StableLM-1.6B,
    Qwen1.5-110B, Mistral-NeMo-12B): the canonical forward's logits digest
    equal to the engine's prefill logits digest."""
    torch.cuda.synchronize()
    _zero_serve_counts()
    t0 = time.perf_counter()
    rep = LC.run_train_serve_parity(device="cuda", reduced=False,
                                    overrides=(("n_layers", 2),))
    torch.cuda.synchronize()
    counts = _serve_counts()
    line = dict(cell=rep["cell"], archs=rep["config"]["archs"], layers=2,
                page_size=rep["config"]["page_size"],
                prompt_lens=rep["config"]["prompt_lens"], heads=rep["heads"],
                conformant=rep["conformant"],
                first_divergence=rep["first_divergence"], launches=counts,
                seconds=time.perf_counter() - t0)
    print(f"[{label}] " + json.dumps(line), flush=True)
    _free_device_memory()
    if not rep["conformant"] or not all(counts.values()):
        raise AssertionError(f"train_serve_parity: conformant="
                             f"{rep['conformant']}, launches {counts}")
    return line


def bound_paged(qpos, hk, d, elt, q_bytes, window=None):
    """Least time for the paged attention on these inputs: the K and V
    positions each row's walk needs (its live positions, once per KV head
    it reads) read once, q read once, out written once."""
    pos = qpos.to(torch.int64).cpu() + 1
    if window:
        pos = pos.clamp(max=window)
    # rows of one (b, kv head) share pages: count the widest row of each b
    per_b = pos.max(dim=1).values
    moved = int(per_b.sum()) * hk * d * elt * 2 + 2 * q_bytes
    return _bound(moved, 0, torch.bfloat16)


def _turns_ms(new, old, reps=50):
    """``_queued_ms`` of a kernel and of its first design in turns (new,
    old, old, new) in this call: the mean of each pair."""
    a, b, c, d = (_queued_ms(fn, reps) for fn in (new, old, old, new))
    return (a + d) / 2, (b + c) / 2


def _vs_v1(label, ms, v1_ms):
    print(f"[timing] {label}: kernel {ms:.4f} ms, first design {v1_ms:.4f} "
          f"ms, {v1_ms / ms:.2f}x", flush=True)


@torch.inference_mode()
def time_serve(serve, paged_check, gemm_check, rows_check):
    """The four serving kernels at the serve path's shapes (StableLM-1.6B,
    bf16): the paged attention at decode (4 rows at positions from the
    serving run) and a prefill chunk; the GEMM at the decode shape (M=4)
    of the up projection, with the prefill chunk (M=32), canonical w_down
    and the LM head beside it; the row norm at M=4; the row log-softmax at
    M=4 over the vocabulary, with the norm at the prefill chunk (M=32) and
    the log-softmax at M=1 beside them. Each beside its plain version, its
    bound and one PyTorch call (SDPA over the ``gather_kv`` output, the
    gather excluded, with a length mask at decode and a causal one for the
    prefill chunk; ``torch.matmul``; ``F.layer_norm``;
    ``torch.log_softmax``), and beside its first design (``csrc/*_v1.cu``,
    in turns within this call, ``v1_ms``), whose bits it must give at every
    timed shape. The kernel's and the library
    call's ``ms`` are ``_queued_ms`` (the calls back to back on the card:
    the wrappers' host time, ~20 µs a call, exceeds these kernels);
    ``event_ms`` beside them is ``_ms``, host included. The plain versions
    synchronise inside, so they take ``_ms``."""
    launches = serve["launches"]
    src = "src/repro_torch/kernels/csrc/"
    entries, not_v1 = [], []
    h, hk, d, dt = 32, 32, 64, torch.bfloat16
    ends = [[p - 1 + SERVE_GEN // 2] for p in serve["prompt_lens"][:4]]
    q, kp, vp, table, qpos, _ = _paged_inputs(4, 1, h, hk, d, dt, 31,
                                              positions=ends)
    scale = d ** -0.5

    def both(fn):
        return _queued_ms(fn), _ms(fn, reps=50)

    def paged(fn, *a):
        return lambda: fn(*a, scale)
    args = (q, kp, vp, table, qpos)
    if not torch.equal(DEC.paged_attention_cuda(*args, scale),
                       DEC.paged_attention_v1(*args, scale)):
        not_v1.append("paged decode")
    ms, v1_ms = _turns_ms(paged(DEC.paged_attention_cuda, *args),
                          paged(DEC.paged_attention_v1, *args))
    event_ms = _ms(paged(DEC.paged_attention_cuda, *args), reps=50)
    plain_ms = _ms(lambda: DEC.paged_attention_plain(q, kp, vp, table, qpos,
                                                     scale), reps=2, rounds=3)
    s = int(qpos.max()) + 1
    kg = DEC.gather_kv(kp, table, s).permute(0, 2, 1, 3)
    vg = DEC.gather_kv(vp, table, s).permute(0, 2, 1, 3)
    mask = (torch.arange(s, device="cuda")[None, :]
            <= qpos.long())[:, None, None, :]     # (B, 1, 1, S)
    qt = q.permute(0, 2, 1, 3)
    library_ms, library_event_ms = both(lambda: F.scaled_dot_product_attention(
        qt, kg, vg, attn_mask=mask, scale=scale))
    err = max(c["max_abs_err"] for c in paged_check
              if c["dtype"] == "bfloat16")
    e = _entry("paged_attention", src + "paged_attn.cu",
               "src/repro/kernels/decode.py:58 (lax.scan, not Pallas)",
               launches["paged_attention"],
               "continuous engine: prefill chunks and decode steps (one per "
               "layer a step)", err, ms, plain_ms,
               bound_paged(qpos, hk, d, 2, q.numel() * 2), library_ms)
    _vs_v1("paged_attention decode (4, 1)", ms, v1_ms)
    e.update(v1_ms=v1_ms, event_ms=event_ms,
             library_event_ms=library_event_ms,
             library_note="SDPA over gather_kv's K/V (boolean length mask), "
             "the gather excluded")
    pq, pkp, pvp, ptable, pqpos, _ = _paged_inputs(
        1, SERVE_CHUNK, h, hk, d, dt, 32,
        positions=[list(range(480, 480 + SERVE_CHUNK))])
    pargs = (pq, pkp, pvp, ptable, pqpos)
    if not torch.equal(DEC.paged_attention_cuda(*pargs, scale),
                       DEC.paged_attention_v1(*pargs, scale)):
        not_v1.append("paged prefill chunk")
    chunk_ms, chunk_v1_ms = _turns_ms(paged(DEC.paged_attention_cuda, *pargs),
                                      paged(DEC.paged_attention_v1, *pargs))
    ps_ = int(pqpos.max()) + 1
    pkg = DEC.gather_kv(pkp, ptable, ps_).permute(0, 2, 1, 3)
    pvg = DEC.gather_kv(pvp, ptable, ps_).permute(0, 2, 1, 3)
    causal = (torch.arange(ps_, device="cuda")[None, :]
              <= pqpos[0].long()[:, None])[None, None]   # (1, 1, L, S)
    pqt = pq.permute(0, 2, 1, 3)
    e.update(prefill_chunk_ms=chunk_ms, prefill_chunk_v1_ms=chunk_v1_ms,
             prefill_chunk_library_ms=_queued_ms(
                 lambda: F.scaled_dot_product_attention(
                     pqt, pkg, pvg, attn_mask=causal, scale=scale)),
             prefill_chunk_bound_ms=bound_paged(pqpos, hk, d, 2,
                                                pq.numel() * 2)[0])
    print(f"[timing] paged_attention prefill chunk (1, {SERVE_CHUNK}): "
          f"{chunk_ms:.4f} ms, library "
          f"{e['prefill_chunk_library_ms']:.4f} ms (SDPA, causal mask, the "
          f"gather excluded), bound {e['prefill_chunk_bound_ms']:.4f} ms",
          flush=True)
    _vs_v1(f"paged_attention prefill chunk (1, {SERVE_CHUNK})", chunk_ms,
           chunk_v1_ms)
    entries.append(e)

    gen = torch.Generator(device="cuda").manual_seed(33)

    def gemm_times(m, k, n, width):
        x = _rand((m, k), gen, dt)
        w = _rand((k, n), gen, dt, 0.02)
        if not torch.equal(GEMM.matmul_cuda(x, w, shard_width=width),
                           GEMM.matmul_v1(x, w, shard_width=width)):
            not_v1.append(f"gemm M={m} K={k} N={n} shard {width}")
        kernel, v1 = _turns_ms(
            lambda: GEMM.matmul_cuda(x, w, shard_width=width),
            lambda: GEMM.matmul_v1(x, w, shard_width=width))
        lib = _queued_ms(lambda: torch.matmul(x, w))
        bound = _bound((m * k + k * n) * 2 + m * n * 4, 2 * m * k * n, dt)
        _vs_v1(f"gemm M={m} K={k} N={n} shard {width}", kernel, v1)
        return x, w, kernel, v1, lib, bound
    x, w, ms, v1_ms, library_ms, bound = gemm_times(SERVE_SLOTS, 2048, 5632,
                                                    0)
    event_ms = _ms(lambda: GEMM.matmul_cuda(x, w), reps=50)
    plain_ms = _ms(lambda: GEMM.matmul_plain(x, w), reps=2, rounds=3)
    err = max(c["max_abs_err"] for c in gemm_check
              if c["dtype"] == "bfloat16")
    e = _entry("gemm", src + "gemm.cu",
               "no TPU kernel: XLA dot_general (src/repro/models/layers.py:31"
               ", src/repro/dist/fold.py:155)", launches["gemm"],
               "continuous engine: every projection (7 a layer + LM head a "
               "step)", err, ms, plain_ms, bound, library_ms)
    e.update(v1_ms=v1_ms, event_ms=event_ms,
             library_note="torch.matmul bf16 (cuBLAS), bf16 output")
    for name, m, k, n, width in (("prefill_w_up", SERVE_CHUNK, 2048, 5632, 0),
                                 ("w_qkv", SERVE_SLOTS, 2048, 2048, 0),
                                 ("wo_canonical", SERVE_SLOTS, 2048, 2048,
                                  64),
                                 ("w_down_canonical", SERVE_SLOTS, 5632, 2048,
                                  176),
                                 ("lm_head", SERVE_SLOTS, 2048, 100352, 0)):
        _, _, k_ms, k_v1, l_ms, b = gemm_times(m, k, n, width)
        e[name] = dict(m=m, k=k, n=n, shard_width=width, ms=k_ms, v1_ms=k_v1,
                       library_ms=l_ms, bound_ms=b[0], bound_by=b[1])
        print(f"[timing] gemm {name} M={m} K={k} N={n}: kernel {k_ms:.4f} ms"
              f", library {l_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]})",
              flush=True)
    entries.append(e)
    if not_v1:
        raise AssertionError(f"not bitwise the first design's at the timed "
                             f"shapes: {not_v1}")

    # the row kernels beside their first design, in turns, at the decode
    # shape and one other: the norm at a prefill chunk's M, the
    # log-softmax at one row (a lone request's decode step)
    sc, bi = _rand((2048,), gen) + 1, _rand((2048,), gen)
    sc16, bi16 = sc.to(dt), bi.to(dt)

    def norm_times(m):
        xn = (_rand((m, 2048), gen) * 3).to(dt)
        if not _same_bits(ROWS.norm_cuda(xn, sc, bi),
                          ROWS.norm_v1(xn, sc, bi)):
            not_v1.append(f"norm M={m}")
        kernel, v1 = _turns_ms(lambda: ROWS.norm_cuda(xn, sc, bi),
                               lambda: ROWS.norm_v1(xn, sc, bi))
        lib = both(lambda: F.layer_norm(xn, (2048,), sc16, bi16))
        bound = _bound(2 * xn.numel() * 2 + 2 * 2048 * 4, 0, dt)
        _vs_v1(f"row_norm ({m}, 2048) bf16 layernorm", kernel, v1)
        return xn, kernel, v1, lib, bound
    xn, ms, v1_ms, (library_ms, library_event_ms), bound = norm_times(
        SERVE_SLOTS)
    event_ms = _ms(lambda: ROWS.norm_cuda(xn, sc, bi), reps=50)
    plain_ms = _ms(lambda: ROWS.norm_plain(xn, sc, bi), reps=5)
    err = max(c["max_abs_err"] for c in rows_check if c["kernel"] == "norm"
              and c["dtype"] == "bfloat16" and c["d"] == 2048)
    e = _entry("row_norm", src + "rows.cu",
               "no TPU kernel: XLA reduction (src/repro/models/layers.py:44)",
               launches["row_norm"],
               "continuous engine: ln1, ln2 a layer and ln_f a step", err,
               ms, plain_ms, bound, library_ms)
    e.update(v1_ms=v1_ms, event_ms=event_ms,
             library_event_ms=library_event_ms,
             library_note="F.layer_norm with bf16 weight and bias")
    _, k_ms, k_v1, (l_ms, _), b = norm_times(SERVE_CHUNK)
    e["prefill_chunk"] = dict(m=SERVE_CHUNK, d=2048, ms=k_ms, v1_ms=k_v1,
                              library_ms=l_ms, bound_ms=b[0], bound_by=b[1])
    print(f"[timing] row_norm ({SERVE_CHUNK}, 2048): kernel {k_ms:.4f} ms, "
          f"library {l_ms:.4f} ms, bound {b[0]:.4f} ms", flush=True)
    entries.append(e)

    def lsm_times(m):
        lg = _rand((m, 100352), gen, scale=4.0)
        got, ref = (ROWS.log_softmax_argmax_cuda(lg),
                    ROWS.log_softmax_argmax_v1(lg))
        if not (_same_bits(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            not_v1.append(f"log_softmax M={m}")
        kernel, v1 = _turns_ms(lambda: ROWS.log_softmax_argmax_cuda(lg),
                               lambda: ROWS.log_softmax_argmax_v1(lg))
        lib = both(lambda: torch.log_softmax(lg, -1))
        bound = _bound(2 * lg.numel() * 4 + m * 8, 0, torch.float32)
        _vs_v1(f"row_log_softmax ({m}, 100352)", kernel, v1)
        return lg, kernel, v1, lib, bound
    lg, ms, v1_ms, (library_ms, library_event_ms), bound = lsm_times(
        SERVE_SLOTS)
    event_ms = _ms(lambda: ROWS.log_softmax_argmax_cuda(lg), reps=50)
    plain_ms = _ms(lambda: ROWS.log_softmax_argmax_plain(lg), reps=5)
    err = next(c["max_abs_err"] for c in rows_check
               if c["kernel"] == "log_softmax" and c["v"] == 100352)
    e = _entry(
        "row_log_softmax", src + "rows.cu",
        "no TPU kernel: XLA log_softmax/argmax "
        "(src/repro/serve/engine.py:128-130)", launches["row_log_softmax"],
        "continuous engine sampler: one a decode step and a first token",
        err, ms, plain_ms, bound, library_ms)
    e.update(v1_ms=v1_ms, event_ms=event_ms,
             library_event_ms=library_event_ms)
    _, k_ms, k_v1, (l_ms, _), b = lsm_times(1)
    e["one_row"] = dict(m=1, v=100352, ms=k_ms, v1_ms=k_v1, library_ms=l_ms,
                        bound_ms=b[0], bound_by=b[1])
    print(f"[timing] row_log_softmax (1, 100352): kernel {k_ms:.4f} ms, "
          f"library {l_ms:.4f} ms, bound {b[0]:.4f} ms", flush=True)
    entries.append(e)
    if not_v1:
        raise AssertionError(f"not bitwise the first design's at the timed "
                             f"shapes: {not_v1}")
    return entries


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    tune_root = tempfile.mkdtemp(prefix="repro_torch_tune_")
    try:
        return _main(t0, tune_root)
    finally:
        shutil.rmtree(tune_root, ignore_errors=True)


class _Laps:
    """Prints the wall seconds since the previous call as a ``[phase-s]``
    line: where the call's time limit goes."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, name):
        now = time.perf_counter()
        print(f"[phase-s] {name} {now - self.t:.1f}", flush=True)
        self.t = now


def _main(t0, tune_root):
    lap = _Laps()
    phase_build()
    phase_device()
    lap("build")
    fwd_check = check_forward(True, KERNEL_CASES + TRAIN_CASES[:1]
                              + FWD_EDGE_CASES)
    full_check = check_forward(False, TRAIN_CASES + FULL_EDGE_CASES)
    check_forward_bits()
    bwd_check = check_backward()
    mask_check = check_masks()
    paged_check = check_paged()
    gemm_check = check_gemm()
    rows_check = check_rows()
    lap("kernel-check")
    check_gqa()
    lap("kernel-check gqa")
    fp_check = check_fingerprint()
    lap("kernel-check fingerprint")
    scan_check = check_scan()
    lap("kernel-check scan")
    xlstm_check = check_xlstm()
    lap("kernel-check xlstm")
    library_m_invariance()
    serve = run_slice()
    serve_window = run_slice(SLICE_WINDOW, "slice-window")
    lap("slice")
    continuous, cont_eng = run_serve_continuous()
    run_serve_invariance(cont_eng)
    lap("serve-continuous")
    spec = run_serve_spec(cont_eng)
    lap("serve-spec")
    chaos = run_serve_chaos(cont_eng)
    lap("serve-chaos")
    serve_obs = run_serve_obs(cont_eng)
    lap("serve-obs")
    del cont_eng
    serve_moe = run_serve_moe()
    lap("serve-moe")
    _free_device_memory()
    nemotron = run_serve_nemotron()
    lap("serve-nemotron")
    serve_jamba = run_serve_jamba()
    lap("serve-jamba")
    serve_xlstm = run_serve_xlstm()
    lap("serve-xlstm")
    _tune_cache(tune_root, "train")
    train = run_train()
    lap("train")
    resume = run_train_resume(train["digest_chain_heads"][0])
    lap("train-resume")
    run_lifecycle()
    lap("lifecycle")
    run_train_serve_parity()
    lap("train-serve-parity")
    matrix = run_chaos_matrix()
    lap("chaos-matrix")
    train_chaos = run_train_chaos()
    lap("train-chaos")
    train_window = run_train(TRAIN_WINDOW_ARGV, "train-window")
    lap("train-window")
    train_moe = run_train_moe()
    lap("train-moe")
    train_jamba = run_train_jamba()
    lap("train-jamba")
    train_xlstm = run_train_xlstm()
    lap("train-xlstm")
    op_paths = run_ops()
    tune = run_tune(tune_root)
    lap("ops+tune")
    _free_device_memory()
    _tune_cache(tune_root, "dash-paper")
    paper = run_train(PAPER_ARGV, "train-dash-paper")
    lap("train-dash-paper")
    launches = dict(train["launches_per_step"])
    launches["fwd_full"] = op_paths["full_shift"]["launches"]["fwd_full"]
    launches["bwd_serial"] = op_paths["causal_serialized"]["launches"][
        "bwd_serial"]
    window_launches = dict(train_window["launches_per_step"])
    window_launches["bwd_serial"] = op_paths["window_serialized"][
        "launches"]["bwd_serial"]
    kernels = time_forward(fwd_check, full_check, launches)
    kernels += time_backward(bwd_check, launches)
    kernels += time_masks(mask_check, window_launches)
    kernels += time_serve(continuous, paged_check, gemm_check, rows_check)
    kernels += time_scan(scan_check, train_jamba["launches_per_step"])
    kernels += time_xlstm(xlstm_check, serve_xlstm, train_xlstm)
    lap("timing")
    kernels.append(dict(
        name="fingerprint", route="cuda",
        source="src/repro_torch/kernels/csrc/fingerprint.cu",
        replaces="no TPU kernel: XLA verify/digest.py::tree_fingerprint "
                 "(src/repro/verify/digest.py:175)",
        launches=train["launches_per_step"]["fingerprint"],
        launch_path="train step with --verify: one a step (its two passes)",
        max_abs_err=0, ms=fp_check["ms"], plain_ms=fp_check["plain_ms"],
        bound_ms=fp_check["bound_ms"], bound_by=fp_check["bound_by"],
        library_ms=None,
        library_note="no single PyTorch call computes this function",
        call_ms=fp_check["call_ms_median"],
        state_bytes=fp_check["state_bytes"]))
    print(f"[done] serving prefill launched the causal forward "
          f"{serve['attention_launches']} times, the windowed one the "
          f"block-sparse forward {serve_window['attention_launches']} times; "
          f"the continuous engine served {SERVE_REQUESTS} requests with "
          f"{continuous['launches']['paged_attention']} paged attentions; "
          f"training resumed from step {resume['resumed_from']} with the "
          f"straight run's digest chain; the tuner measured "
          f"{tune['geometries']} geometries in {tune['seconds']:.1f}s "
          f"({tune['winners_modeled']} winners the modeled ones); "
          f"dash-paper trained {len(paper['step_ms'])} steps twice to one "
          f"digest chain; speculation (k={SPEC_K}) bitwise in "
          f"{len(spec)} runs, acceptance "
          f"{[round(r['acceptance'], 3) for r in spec]}; "
          f"{chaos[0]['faults_landed']} faults and "
          f"{chaos[0]['preemptions']} preemptions, two crash restores, "
          f"{len(matrix['cells'])} chaos cells and "
          f"{train_chaos['faults_landed']} checkpoint IO faults, all "
          f"bitwise; the state fingerprint ({fp_check['state_bytes'] / 1e9:.1f}"
          f" GB) in {fp_check['ms']:.3f} ms, equal in both tracked train "
          f"runs; {len(serve_obs)} serve-obs runs bitwise; "
          f"{train_moe['arch']} trained {train_moe['layers']} layers twice "
          f"to one digest chain at {train_moe['steady_step_ms']:.1f} ms a "
          f"step, gather == einsum dispatch; "
          f"{', '.join(r['arch'] for r in serve_moe)} served bitwise on the "
          f"static engine; {nemotron['arch']} on the continuous engine "
          f"bitwise at {len(nemotron['runs'])} slot counts; "
          f"{serve_jamba['arch']} served {serve_jamba['layers']} layers "
          f"bitwise ({serve_jamba['scan_launches']} scan launches) and "
          f"trained {train_jamba['layers']} twice to one digest chain at "
          f"{train_jamba['steady_step_ms']:.1f} ms a step; "
          f"{serve_xlstm['arch']} served {serve_xlstm['layers']} layers "
          f"bitwise ({serve_xlstm['launches']}) at "
          f"{serve_xlstm['decode_tok_per_s']:.1f} tok/s and trained "
          f"{train_xlstm['layers']} twice to one digest chain at "
          f"{train_xlstm['steady_step_ms']:.1f} ms a step; "
          f"{time.perf_counter() - t0:.1f}s in all",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
