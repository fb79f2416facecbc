#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--log-dir DIR]

Run from the root of a checkout.  Phases, each of which must pass:

  1. build    the five hand-written kernels (three forward, two backward) from
              src/repro_torch/kernels/csrc, all at once; ptxas's registers,
              shared memory and spills of the f32 flash forward
              (flash_fwd_fma at every head dim and q-block height) and of
              every rmsnorm forward instantiation, none spilling, rmsnorm's
              registers within what its plan counts for its wave, the f32
              flash forward's shared memory as its plan counts it; the
              decode kernel's tensor-core route (the int8 cache under a
              bf16 q, decode_int8_mma_kernel at every head dim): HMMA in its
              SASS, no spill, at most 128 registers at D <= 128 (4 CTAs an
              SM), its shared memory as decode_plan counts it
  2. kernels  each kernel against its plain PyTorch version at the serving
              path's shapes and ragged ones, in bf16 and f32, timed beside its
              plain version, one PyTorch library call and its bound (decode
              attention with a cold L2, as the path finds it); flash also at
              minicpm3's MLA prefill shape (D = 96, V zero-padded from 64,
              scale 1/sqrt(96)), timed, and at D = 24 (padded to 32); and
              every kernel at the shapes phase 8's qwen1.5-4b and minicpm3-4b
              give it (n_rep 1 at D = 128 and 96, d = 2560, 768, 256); and
              at phase 9's shapes, timed: flash and decode at olmoe's D = 128
              and zamba2's D = 80 (n_rep 1), decode also at the served
              cache size S = 552, rmsnorm at d = 1024, 2048, 5120; and at
              phase 10's shapes, timed: flash at grok-1's n_rep 6,
              nemotron's D = 192 (96/8 heads), whisper's encoder (1500
              frames), cross-attention (512 x 1500) and decoder
              self-attention (512, causal), each at B = 1 and the served B
              = 4, and pixtral's 1088-token prompt; decode at n_rep 3 (D =
              16), grok-1's n_rep 6, nemotron's n_rep 12 at D = 192,
              whisper's cross cache (S = 1500) and self cache, pixtral's
              n_rep 4, each at the served S = 552 with lengths 0 and 544;
              rmsnorm at d = 18432 (cold: 37.8 MB) and 1280; untimed, the
              one-sequence decode of phase 10's parity runs and whisper's
              128-token split; timed, phase 11's train microbatch (rmsnorm
              8192 rows of d = 4096, flash 4 x 2048 x 32/8 x 128 causal);
              at the serving prefill and the train microbatch, flash's
              log-sum-exp output (the training path's call) against its
              plain version, the output bit-equal to the call without it,
              and in bf16 timed beside that call; a one-element PyTorch add
              timed the same way, the launch floor, beside each rmsnorm row;
              the decode kernel over an int8 cache with its scales
              (decode_attention_int8), bf16 and f32 q, at the serving shape,
              grok-1's n_rep 6, nemotron's 12 at D = 192, whisper's D = 64,
              zamba2's D = 80 and 8 and 16 x 32/8 x 32768 x 128, timed cold
              beside its plain version and, as another function, SDPA over
              the cache dequantized to bf16 beforehand; each int8 case's
              share of its byte bound and cache elements a second beside
              PR 21's time
  3. parity   granite-8b, qwen1.5-4b and minicpm3-4b at full width, 2 layers,
              and granite-8b and qwen1.5-4b with kv_quant: the kernel path
              and the plain path agree over a 512-token prefill and 16
              decode steps (f32: equal token ids; bf16: as close to the f32
              run as the plain path)
  4. serve    granite-8b, 36 layers, bf16, random weights from a seed:
              InstanceEngine (4 slots, max_seq 1024; its decode step a CUDA
              graph captured at the first admission, timed apart) answers 8
              requests of 512
              prompt tokens and 32 new tokens; launch counts must match the
              path, and the tokens must equal those of the same engine
              stepping eagerly
  5. live     cooperative_forward equals train_forward bit for bit for k in
              {0, 1, 18, 36} (granite-8b) and {0, 1, 31, 62} (the 62-layer
              minicpm3-4b)
  6. profile  torch.profiler over 3 full-batch decode steps, captured and
              eager, and over one idle 512-token prefill: device time by
              kernel, the share of the step or of the TTFT the card is busy,
              the host's launch calls, and the attention kernels' launches
              per step / prefill, each window held to L of them (a record
              the profiler lost excused only as that window shows it)
  7. cluster  the serving CLI's paths (repro_torch.launch.serve) on phase 4's
              36-layer weights, every engine on that one parameter dict:
              (a) the colocated loop, 16 requests of 512 + 32 tokens, until
              the live-scaled engine holds all 36 layers; (b) run_disagg,
              24 requests on the wall clock: every handoff completes, no
              request is dropped or gapped, migrated bytes equal the payloads';
              (c) the disagg runtime on a simulated clock against a lone
              engine: first tokens bit-equal, a later divergence only at a
              bf16 near tie; (d) run_disagg's runtime built as the CLI
              builds it, with a span tracer and a flight recorder on its
              FlowSim, serving (b)'s 24 requests on the wall clock: every
              request done, launches the path's, at least one closed
              scale_op, each op's makespan split exactly (Fractions) into
              plan / queue / transfer / stall / cutover, the same report
              after a round trip through the Chrome trace, and one incident
              bundle dumped at the end that parses as a Chrome trace and
              lists the ops; and the host tools' CLIs (repro_torch.obs.report
              --sim, with --scale-ops, and repro_torch.obs.perfdiff on the
              smoke baselines), subprocesses started before the build and
              awaited after it, each exiting 0.  The modelled cluster's 8
              devices all compute on this one card; the network between
              them is the flow model.
 7b. long     granite-8b whole (phase 4's weights), its caches filled to
              32768 tokens a slot by write_prompt_kv from seeded random K/V
              (no prefill): the captured decode step at 8 slots with the
              int8 cache and with bf16 and at 16 slots with int8 (~40 GB,
              where bf16 would need 77.5 GB), each cache freed before the
              next: the decode kernel on layer 0's filled cache against its
              plain version (a flat and a peaked softmax), the first step's
              tokens equal to the eager step's, wall ms, profiled device ms
              (the window held to 3L decode launches), byte bound, peak
              memory
  8. maas     run_maas, the CLI's --maas path, serving granite-8b (phase 4's
              weights), qwen1.5-4b and minicpm3-4b (phase 5's) at full width
              and depth on one fleet: 24 requests of 128 + 16 tokens on the
              wall clock; every request served, none dropped or gapped, the
              parameter pool's invariant on every tick, at least one
              scale-to-zero and one cold start, each tenant's launches exact
              for its path and its migrated bytes equal to its payloads
  9. families olmoe-1b-7b (MoE), mamba2-370m (SSM) and zamba2-2.7b (hybrid,
              flash and decode at head dim 80) at full width, after phase 8's
              models are freed: (a) parity as in phase 3, cut to 2 layers
              (zamba2 to 6: one shared-block site); (b) the colocated CLI
              loop at full depth, 16 requests of 512 + 32 tokens on 4
              slots, launches exact (zamba2: flash and decode 9 per prefill
              or step); the idle prefill and the decode step, captured and
              eager, on the wall clock and profiled, peak memory; (c) the live split bit for bit at k
              in {0, 1, L/2, L}; (d) zamba2's --disagg, every handoff done
 10. last     grok-1-314b (MoE, n_rep 6), nemotron-4-340b (squared ReLU, D =
              192, n_rep 12), whisper-large-v3 (enc-dec) and pixtral-12b
              (VLM) at full width, after phase 9's models are freed: (a)
              parity as in phase 3 (grok-1 and nemotron cut to 1 layer,
              whisper to 2 + 2 with 1500 frames, pixtral to 2 with 1024
              patch frames on a 1088-token prompt), and whisper under the
              reference's init law, 2 + 2 and whole: both f32 paths against
              a float64 plain run, the kernel path no farther than twice the
              plain path's distance; (b) grok-1 and nemotron
              cut to 2 layers (628 and 680 GB in bf16 whole) and pixtral
              whole through the colocated CLI loop, 8 requests of 512 + 32
              tokens on 4 slots (pixtral 16), launches exact, the idle
              prefill and the decode step (captured and eager) timed and
              profiled; whisper whole at the model API (the engine passes
              no frames): 4 prompts of 512 tokens with 1500 frames, 32
              steps, launches exact, then an engine's captured step over
              caches that prefill filled, beside the eager step, timed and
              profiled; (c) the live split of pixtral and whisper bit for
              bit at k in {0, 1, L/2, L}
 11. train    after phase 10's models are freed: (a) the flash backward
              library's SASS holds HGMMA (wgmma) in each bf16 pass at every
              head dim, and ptxas reports no spill in any instantiation of
              either backward library (registers and shared memory logged);
              the two backward kernels (rmsnorm_bwd, flash_attention_bwd)
              against their plain versions, bf16 and f32, two runs
              bit-equal, at the train loop's shapes (rmsnorm 8192 rows of d
              = 4096, also 18432 and 1280; flash 4 x 2048 x 32/8 x 128
              causal), whisper's 512 x 1500 cross-attention and small at
              every head dim, timed beside their bound, plain version and
              library autograd call, with their time by launch from a
              torch.profiler trace; (b)
              gradient parity of granite-8b at full width cut to 2 layers,
              one 512-token sequence, fan-in weights: f32 every leaf
              within 3e-5 of its scale, bf16 within 1.05x the plain path's
              mean error; under the reference's init law (a saturated
              softmax) a float64 witness: per f32 leaf past 3e-5, and the
              bf16 kernel path's mean error within 1.25x the plain path's; (c) run_train on granite-8b at full width cut to
              4 layers, bf16 weights and f32 moments, 8 x 2048 tokens in 2
              microbatches: 12 steps, launches exactly 12 x one step's
              (per microbatch flash 2L and rmsnorm 4L+1 with the remat
              recompute, flash_attention_bwd L, rmsnorm_bwd 2L+1) and a
              falling loss, a run checkpointed at step 6 and a run resumed
              from it, whose losses equal the unbroken run's bit for bit;
              (d) torch.profiler over one more step (also the backward
              kernels' time by launch within it)
 12. mesh     (a) run_train sharded (repro_torch.launch.train with a mesh)
              on a one-rank NCCL group, the ("data", "model") host mesh,
              phase 11c's config, batch, schedule and seed, 3 steps: the
              parameters and Adam moments DTensors in the rules' placements,
              the four training kernels launched exactly as 3 of 11c's
              steps (on the DTensors' local blocks), each loss and grad norm
              within 2e-2 of 11c's first 3 (bit-equal or not, recorded),
              step ms and peak GiB beside 11c's, and the step-3 checkpoint
              restored into an unsharded run that trains step 3 as 11c did;
              then 2 steps of qwen1.5-4b (2 layers, full width) under its
              own rules ("seq" over "model"), every flash call through
              ops' sequence-parallel path (q a local shard, the forward
              and backward kernels at its offset), launches, losses and
              grad norms, and every parameter's update within 2e-2 of its
              unsharded steps from the same seed;
              (b) the dry-run CLI (repro_torch.launch.dryrun, a fake
              process group of 256 / 512 ranks on the CPU) for granite-8b's
              train_4k, prefill_32k and decode_32k on both production
              meshes, in a subprocess started before the build and
              awaited after it, so that no timed phase runs beside it:
              every cell ok; its per-device GB, roofline terms and
              bottleneck logged
 13. examples the static checker and the six examples: (a) beside the build,
              as subprocesses without a CUDA device on this machine without
              JAX, the checker over src/repro_torch under
              analysis_baseline_torch.json ("simcheck: clean"), the import
              smoke over src/repro_torch and examples_torch (every module
              imported), examples_torch/quickstart.py and net_scenarios.py
              ("all five scenarios behaved as modelled"), each exiting 0;
              (b) after phase 12's models are freed, each tensor example's
              main() in this process on the card, launches counted from 0:
              serve_autoscale (both runs serve all 16 requests),
              serve_disagg (all 32 arrivals served, every handoff done, none
              gapped) and serve_maas (its fleet summary, on a simulated
              clock, the CPU run's: 6 grants, 1 cold start from the O(1)
              host copy, 3 scale-to-zero events, 4.86 GPU-seconds), each
              launching the three forward kernels and no backward one;
              train_100m (8 layers, d 768) for 120 steps over its step-100
              checkpoint, launches exactly 120 steps' (flash 2L, rmsnorm
              4L+1, flash_attention_bwd L, rmsnorm_bwd 2L+1 a step), the
              loss at step 119 below step 0's, then a run to 140 resumed
              from step 100 whose step-100 loss is the unbroken run's; each
              example's wall seconds and train_100m's tokens/s logged beside
              the card's name and power limit
 14. shards   whole problems cut by hand into the blocks a mesh gives, the
              variants' launch counts set to 0 before and read after: (a)
              granite-8b's decode at 8 x 32k in bf16 and int8, the cache cut
              into 4 and 16 sequence blocks, the kernel with its lse over
              each (lengths cut to the block: one ends inside the first
              16-way block, one is 0), merged by ops.merge_partials, held to
              the whole call and to the plain version (bf16 2e-2; lse -inf
              at length 0); whisper's 1500-frame cross cache over 16 uneven
              blocks; timed: the block with the most valid rows (cold), the
              merge and the whole call; (b) the flash forward cut into 4 q
              row blocks at their q_offset, with and without lse (bit-equal),
              at granite's 1 x 512, the train shape 4 x 2048 (causal) and
              whisper's non-causal cross-attention, in bf16 and f32, out
              and lse held to the whole call and to the plain version
              (bf16 2e-2, f32 3e-5); timed: the last block at its offset
              beside its plain version, SDPA with the offset as a mask and
              the whole call; (c) granite-8b (2 layers, full width) served
              through a one-rank NCCL mesh whose rules put the cache's
              sequence over "model", so each decode runs ops'
              flash-decoding path: logits within 2e-2 and token ids equal
              to the unsharded run, n_layers x steps decode launches with
              lse; (d) the flash backward over the same 4 q blocks of the
              train shape and whisper's cross case, bf16 and f32: each
              block's forward with lse and backward at its q_offset, dq
              concatenated and dk, dv summed held to the whole call and to
              the plain version (each gradient's scale), dk = dv = 0 past
              each causal block's last row, two runs bit-equal; timed: the
              last block beside its plain version, SDPA forward + backward
              with the offset as a mask less its forward, and the whole
              call; (e) minicpm3-4b's absorbed decode at full width (40
              heads, kv_lora 256, rope 32) over 8 slots x 32,768 latent rows,
              bf16 and f32 caches, cut into 4 and 16 blocks (local_block's
              cuts) and by hand into uneven blocks with one empty:
              ops.mla_decode_block over each from its start, merged, held to
              the whole unsharded core (bf16 2e-2, f32 3e-5; lse too), two
              runs bit-equal, every block past a row's length weighing 0;
              timed cold: the block with the most valid rows beside its
              byte bound, the merge and the whole call; (f) minicpm3-4b (2
              layers, full width) served through the one-rank mesh with
              the latent cache's sequence over "model", so each decode
              runs the block path: logits and tokens bit-equal to the
              unsharded run, n_layers x steps block calls; (g) grok-1-314b
              and olmoe-1b-7b (2 layers, full width) served the same way
              (a prefill of 4 x 128, 4 decode steps): logits bit-equal to
              the unsharded run, and the product that contracts a sharded
              index (grok-1's down projection over d_ff, olmoe's combine
              over the experts) partial on every layer of every pass; (h)
              mamba2-370m (2 layers) and zamba2-2.7b (6: its shared block
              runs once) the same: logits bit-equal, every prefill layer's
              SSD scan given x head-sharded and run on the rank's heads;
              (i) mamba2-370m's SSD scan at full width (4 x 8,192 tokens,
              32 heads of 64, state 128, chunk 128, f32) cut into 16 head
              blocks, each block's y and final state within 1e-5 of the
              whole call's (of its largest magnitude), two runs bit-equal;
              timed cold: the whole call and the largest block beside their
              bounds; (j) nemotron-4-340b's decode K/V projections at full
              width, x (8, 18432) bf16 against wk and wv (18432, 1536): the
              16 d_model blocks' f32 partials summed, held to the whole
              product at bf16 2e-2; timed cold: both whole products and one
              block of each beside their bounds; and (g)'s grok-1 pass
              bit-equal with the idle-axis rule checked and never applied;
              every time logged beside the card's name and power limit

It prints one JSON ``kernels`` line (the three forward kernels, the decode
kernel over the int8 cache with its launches in phase 7b, the two backward
kernels, and phase 14's variants: the decode kernel with its lse at one of
4 blocks of the bf16 8 x 32k cache, and the flash forward and backward at
the train shape's last q block) and the card's name and power limit before its last
line, which is ``{"ok": true, "device": {...}}``.  It exits non-zero,
printing no result, without a CUDA device or outside a checkout.  With
``--log-dir`` it also writes the nvcc logs, every measurement, the
decode-step and prefill traces, phase 7(d)'s Chrome trace and incident
bundle, the host tools' output and each example's stdout there.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import io
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # dense tensor-core bf16; f32 without tensor cores
TOL = {"f32": 3e-5, "bf16": 2e-2}  # tests/test_kernels.py:16-17
L2_BYTES = 50e6  # H100 SXM
COLD_BYTES = 128e6  # rotating input copies of a cold timing: over 2.5x the L2
SEED = 0
# phase 2 cases timed (the first word of the case): the main path's shapes,
# minicpm3's MLA prefill, and phase 9's families (also at its served cache size)
TIMED = ("main", "mla", "olmoe", "mamba2", "zamba2", "olmoe-serve", "zamba2-serve",
         "grok", "grok-serve", "nemotron", "nemotron-serve", "whisper", "whisper-enc",
         "whisper-cross", "whisper-serve", "whisper-self", "whisper-self-b4", "whisper-enc-b4",
         "whisper-cross-b4", "pixtral", "pixtral-serve", "train", "int8-grok", "int8-nemotron",
         "int8-whisper", "int8-zamba2", "int8-long", "long", "int8-long16")

KERNELS = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:23"),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:39",
    ),
    "decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:36",
    ),
}
# the decode kernel over an int8 cache: the int8 branch of the reference's
# jnp decode (its Pallas kernel takes no int8); one launch counter with the
# bf16 decode, read over the long-context phase's int8 steps
INT8_DECODE = (
    "decode_attention_int8", "src/repro_torch/kernels/csrc/decode_attention.cu",
    "src/repro/models/layers.py:decode_attention_reference (int8 branch; jnp, no Pallas kernel)",
)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------


def time_ms(torch, fns: dict, input_sets: list, iters: int = 30) -> dict:
    """Mean device ms per call of each fn(*inputs), timed with CUDA events in
    turns (a, b, c, c, b, a) after a warm-up; call i takes input_sets[i % n].
    A spin kernel keeps the card busy while the host enqueues the calls, so
    that the events bracket the calls' device time and not the host's launch
    rate.

    One input set times a kernel warm.  That is how the path finds rmsnorm
    and flash attention: their inputs were written by the product just
    before them, a few MB that sit in the 50 MB L2.  Decode attention is
    given copies whose bytes together exceed twice the L2 (``cold_sets``),
    because on the path each of the 36 layers reads its own cache (16.8 MB at
    the serving shape, 604 MB per step), which comes from HBM; so is any
    case whose bytes moved exceed half the L2 (nemotron's rmsnorm, 37.8 MB),
    which could not sit in it on the path either."""
    n = len(input_sets)
    for fn in fns.values():
        for i in range(max(3, n)):
            fn(*input_sets[i % n])
    torch.cuda.synchronize()
    total = {k: 0.0 for k in fns}
    for name in list(fns) + list(fns)[::-1]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)  # ~20 ms of device cycles, more than the enqueueing takes
        start.record()
        for i in range(iters):
            fns[name](*input_sets[i % n])
        end.record()
        end.synchronize()
        total[name] += start.elapsed_time(end) / iters
    return {k: v / 2 for k, v in total.items()}


def cold_sets(inputs) -> list:
    """Copies of ``inputs`` whose bytes together reach COLD_BYTES, so that
    cycling through them finds none of them in the L2."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    return [tuple(t.clone() for t in inputs) for _ in range(max(2, -(-int(COLD_BYTES) // nbytes)))]


def bound(nbytes: float, flops: float, dt: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def max_err(torch, got, want, dt: str, scaled: bool = False) -> float:
    """Max |got - want|; raises unless |got - want| <= tol + tol*|want|
    everywhere, and with ``scaled`` also unless it is <= tol * max|want|.
    The second criterion is for outputs far below 1, where the first would
    let an error as large as the output itself pass: decode attention over
    n rows of unit-scale V averages them to about n**-0.5 (0.0055 at 32k)."""
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), "kernel output is not finite")
    diff = (g - w).abs()
    ok = bool((diff <= TOL[dt] + TOL[dt] * w.abs()).all())
    err = float(diff.max())
    check(ok, f"kernel disagrees with its plain version: max abs err {err} (tol {TOL[dt]})")
    if scaled:
        top = float(w.abs().max())
        check(err <= TOL[dt] * top, f"kernel disagrees with its plain version: max abs err {err} "
              f"> {TOL[dt]} x the output's largest magnitude {top}")
    return err


# ---------------------------------------------------------------------------
# Phase 1: the forward kernels as built
# ---------------------------------------------------------------------------

def fwd_build_report() -> dict:
    """ptxas's report of the f32 flash forward (flash_fwd_fma<D, BQ> at every
    head dim and both q-block heights) and of every rmsnorm forward
    instantiation (dtype, vector width, vectors a lane): each must be there
    and spill nothing; an rmsnorm instantiation must need no more registers
    than ``rmsnorm.fwd_regs`` counts for its plan's wave, and the f32 flash
    kernel's dynamic shared memory must be what ``fwd_plan`` counts.  Logged
    per instantiation: registers, static shared memory, stack, spills, and
    flash's dynamic shared memory and CTAs an SM."""
    import ctypes
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rmsnorm as rk

    smem_of = _build.function("flash_attention", "flash_attention_f32_smem", [ctypes.c_int] * 2)
    rows = {}
    found = _ptxas_report(_build.log_path("flash_attention").read_text())
    for d in fk.HEAD_DIMS:
        for bq, sq in ((32, 64), (64, 64 * fk.SMS)):  # a one-CTA grid: 32 rows; SMS CTAs: 64
            hits = [v for k, v in found.items() if f"flash_fwd_fmaILi{d}ELi{bq}E" in k]
            check(len(hits) == 1, f"flash_attention: no single ptxas report of flash_fwd_fma<{d}, {bq}>")
            plan = fk.fwd_plan(1, sq, sq, 1, d, 4)
            check(plan.block_q == bq and smem_of(d, bq) == plan.smem,
                  f"flash_fwd_fma<{d}, {bq}>: the kernel's {smem_of(d, bq)} bytes of shared memory "
                  f"are not fwd_plan's {plan.smem} (block {plan.block_q})")
            rows[f"flash_fwd_fma<{d}, {bq}>"] = {**hits[0], "dynamic_smem": plan.smem,
                                                 "ctas_per_sm": plan.per_sm, "stages": plan.stages,
                                                 "block_k": plan.block_k}
    found = _ptxas_report(_build.log_path("rmsnorm").read_text())
    for k, v in found.items():
        m = re.search(r"rmsnorm_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", k)
        if m:
            vector, nv = m.group(2) != "1", int(m.group(3))
            name = f"rmsnorm<{'f32' if m.group(1) == 'f' else 'bf16'}, vec {m.group(2)}, nv {nv}>"
            regs = rk.fwd_regs(nv, vector)
            check("registers" in v and v["registers"] <= regs,
                  f"{name} needs {v.get('registers')} registers, more than the plan's {regs}")
            rows[name] = v
    want = 2 * 2 * (1 + rk.FWD_NV.bit_length())  # dtype, vector width: nv 0 and 1, 2, 4, 8
    got = sum(r.startswith("rmsnorm<") for r in rows)
    check(got == want, f"rmsnorm: {got} instantiations, want {want}")
    for k, v in rows.items():
        check("registers" in v and v.get("spill_stores", 0) == 0 and v.get("spill_loads", 0) == 0,
              f"forward kernel {k} spills registers: {v}")
    log("[build] forward kernels' ptxas " + json.dumps(rows))
    return rows


# the decode kernel's tensor-core route (the int8 cache under a bf16 q), one
# instantiation per head dim
DECODE_MMA = {d: f"decode_int8_mma_kernelILi{d}E" for d in (16, 32, 64, 80, 128, 192)}


def decode_build_report() -> dict:
    """The decode library as built: each instantiation of the tensor-core
    route (``decode_int8_mma_kernel<D>``) must be there, hold HMMA (mma.sync)
    in its SASS, spill nothing and need no more registers than its CTAs an
    SM allow (``decode_attention.MMA_CTAS_PER_SM``: 128 at D <= 128, 4 CTAs
    of 128 threads); a CTA's shared memory, on every route, must be what
    ``decode_plan`` counts at phase 2's, 7b's and the tests' shapes, at
    every head dim and head group.  Logged per instantiation: registers,
    stack, spills, HMMA and I2F counts; and the plans of the int8 cache
    under a bf16 q with the clusters the card holds at once."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dk

    found = _ptxas_report(_build.log_path("decode_attention").read_text())
    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.lib_path("decode_attention"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"hmma": 0, "i2f": 0}
        elif fn and "HMMA" in line:
            counts[fn]["hmma"] += 1
        elif fn and "I2F" in line:
            counts[fn]["i2f"] += 1
    rows = {}
    for d, want in DECODE_MMA.items():
        hits = [k for k in found if want in k]
        check(len(hits) == 1, f"decode_attention: no single ptxas report of {want}: {hits}")
        v = found[hits[0]]
        regs = 65536 // (128 * dk.MMA_CTAS_PER_SM[d])
        check("registers" in v and v["registers"] <= regs and v.get("spill_stores", 0) == 0
              and v.get("spill_loads", 0) == 0,
              f"decode_int8_mma_kernel<{d}>: {v} (at most {regs} registers, no spill)")
        c = next((n for f, n in counts.items() if want in f), {"hmma": 0, "i2f": 0})
        check(c["hmma"] > 0, f"decode_int8_mma_kernel<{d}> has no HMMA in its SASS")
        rows[f"decode_int8_mma_kernel<{d}>"] = {**v, **c}
    smem_of = _build.function("decode_attention", "decode_attention_smem", [ctypes.c_int] * 6)
    fit = dk.clusters_fit_on(0)
    plans, checked = {}, 0
    for d in dk.HEAD_DIMS:
        for n_rep in (1, 3, 4, 6, 8, 12, 32):
            for b, kv, s in ((4, 8, 1024), (4, 8, 552), (8, 8, 32768), (16, 8, 32768), (5, 2, 600)):
                for dtype, elem, quant in ((1, 1, True), (0, 1, True), (1, 2, False), (0, 4, False)):
                    mma = dtype == 1 and quant
                    plan = dk.decode_plan(b, kv, s, d, elem, n_rep, mma=mma,
                                          clusters_fit=fit if mma else None)
                    got = smem_of(d, n_rep // plan.groups, dtype, int(quant), plan.chunk, plan.ring)
                    check(got == plan.smem, f"decode at D {d}, n_rep {n_rep}, {b} x {kv} x {s}, dtype "
                          f"{dtype}, int8 {quant}: {got} bytes of shared memory at chunk {plan.chunk}, "
                          f"ring {plan.ring}; decode_plan counts {plan.smem}")
                    checked += 1
                    if mma and n_rep == 4:
                        plans[f"D {d} {b} x {kv} x {s}"] = (
                            f"cluster {plan.cluster} chunk {plan.chunk} ring {plan.ring}, "
                            f"{fit(d, plan.chunk, plan.ring, plan.cluster)} clusters at once")
    log(f"[build] decode's tensor-core route: SASS and ptxas {json.dumps(rows)}; shared memory as "
        f"decode_plan counts it in {checked} plans; int8 under bf16 q {json.dumps(plans)}")
    return rows


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_cases(torch, dt: str):
    """(kernel, case, make_inputs) at the serving path's shapes and ragged ones."""
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def lens(*vals):
        return torch.tensor(vals, dtype=torch.int32, device="cuda")

    def mla(s, h, d, vdim):  # mla_prefill's call: V zero-padded from v_head_dim to d
        q, k, v = randn(1, s, h, d), randn(1, s, h, d), randn(1, s, h, d)
        v[..., vdim:] = 0
        return q, k, v

    def int8(b, h, kv, s, d, *lengths):  # an int8 cache quantized by the cache's own writer
        from repro_torch.models.kvcache import quantize_kv

        (kq, ks), (vq, vs) = (quantize_kv(randn(b, kv, s, d)) for _ in range(2))
        return randn(b, h, d), kq, vq, lens(*lengths), ks, vs

    return [
        ("rmsnorm", "main N=512 d=4096", lambda: (randn(512, 4096), randn(4096)), {}),
        ("rmsnorm", "ragged N=37 d=1001", lambda: (randn(37, 1001), randn(1001)), {}),
        # the widths of phase 8's other tenants: qwen1.5-4b and minicpm3-4b's
        # d, and MLA's q_norm and kv_norm
        ("rmsnorm", "N=128 d=2560", lambda: (randn(128, 2560), randn(2560)), {}),
        ("rmsnorm", "N=128 d=768", lambda: (randn(128, 768), randn(768)), {}),
        ("rmsnorm", "N=128 d=256", lambda: (randn(128, 256), randn(256)), {}),
        ("flash_attention", "main B=1 S=512 H=32 KV=8 D=128 causal",
         lambda: (randn(1, 512, 32, 128), randn(1, 512, 8, 128), randn(1, 512, 8, 128)),
         {"causal": True}),
        ("flash_attention", "ragged S=300 causal",
         lambda: (randn(1, 300, 32, 128), randn(1, 300, 8, 128), randn(1, 300, 8, 128)),
         {"causal": True}),
        ("flash_attention", "Sq=200 Sk=333 non-causal scale 0.05",
         lambda: (randn(2, 200, 32, 128), randn(2, 333, 8, 128), randn(2, 333, 8, 128)),
         {"causal": False, "softmax_scale": 0.05}),
        ("flash_attention", "D=16 Sq=200 Sk=333 non-causal scale 0.05",
         lambda: (randn(2, 200, 8, 16), randn(2, 333, 2, 16), randn(2, 333, 2, 16)),
         {"causal": False, "softmax_scale": 0.05}),
        ("flash_attention", "mla B=1 S=512 H=40 KV=40 D=96 causal scale 1/sqrt(96), V padded from 64",
         lambda: mla(512, 40, 96, 64), {"causal": True, "softmax_scale": 1 / math.sqrt(96)}),
        ("flash_attention", "phase 8 qwen1.5-4b B=1 S=128 H=20 KV=20 D=128 causal",
         lambda: (randn(1, 128, 20, 128), randn(1, 128, 20, 128), randn(1, 128, 20, 128)),
         {"causal": True}),
        ("flash_attention", "phase 8 minicpm3 B=1 S=128 H=40 KV=40 D=96 causal scale 1/sqrt(96), V padded from 64",
         lambda: mla(128, 40, 96, 64), {"causal": True, "softmax_scale": 1 / math.sqrt(96)}),
        ("flash_attention", "D=24 (padded to 32) S=37 H=4 KV=4 causal scale 1/sqrt(24), V padded from 16",
         lambda: mla(37, 4, 24, 16), {"causal": True, "softmax_scale": 1 / math.sqrt(24)}),
        ("decode_attention", "main B=4 H=32 KV=8 S=1024 D=128",
         lambda: (randn(4, 32, 128), randn(4, 8, 1024, 128), randn(4, 8, 1024, 128),
                  lens(1, 300, 517, 1024)), {}),
        ("decode_attention", "ragged S=1000 lengths 1..999",
         lambda: (randn(3, 32, 128), randn(3, 8, 1000, 128), randn(3, 8, 1000, 128),
                  lens(999, 1, 129)), {}),
        ("decode_attention", "phase 8 qwen1.5-4b B=4 H=20 KV=20 S=152 D=128 lengths 0, 129, 144, 152",
         lambda: (randn(4, 20, 128), randn(4, 20, 152, 128), randn(4, 20, 152, 128),
                  lens(0, 129, 144, 152)), {}),
        ("decode_attention", "lengths 0, S, 1, 65; n_rep 8; S=4096",
         lambda: (randn(4, 64, 128), randn(4, 8, 4096, 128), randn(4, 8, 4096, 128),
                  lens(0, 4096, 1, 65)), {}),
        # phase 9's families: olmoe's attention (n_rep 1, D = 128), zamba2's
        # shared block (n_rep 1, D = 80), and the norms of mamba2 (d = 1024
        # and the gated norm over d_inner = 2048), olmoe (2048) and zamba2's
        # gated norm (d_inner = 5120); each timed
        ("rmsnorm", "mamba2 N=512 d=1024", lambda: (randn(512, 1024), randn(1024)), {}),
        ("rmsnorm", "olmoe N=512 d=2048", lambda: (randn(512, 2048), randn(2048)), {}),
        ("rmsnorm", "zamba2 N=512 d=5120", lambda: (randn(512, 5120), randn(5120)), {}),
        ("flash_attention", "olmoe B=1 S=512 H=16 KV=16 D=128 causal",
         lambda: (randn(1, 512, 16, 128), randn(1, 512, 16, 128), randn(1, 512, 16, 128)),
         {"causal": True}),
        ("flash_attention", "zamba2 B=1 S=512 H=32 KV=32 D=80 causal",
         lambda: (randn(1, 512, 32, 80), randn(1, 512, 32, 80), randn(1, 512, 32, 80)),
         {"causal": True}),
        ("decode_attention", "olmoe B=4 H=16 KV=16 S=1024 D=128 lengths 0, 300, 517, 1024",
         lambda: (randn(4, 16, 128), randn(4, 16, 1024, 128), randn(4, 16, 1024, 128),
                  lens(0, 300, 517, 1024)), {}),
        ("decode_attention", "zamba2 B=4 H=32 KV=32 S=1024 D=80 lengths 0, 300, 517, 1023",
         lambda: (randn(4, 32, 80), randn(4, 32, 1024, 80), randn(4, 32, 1024, 80),
                  lens(0, 300, 517, 1023)), {}),
        # the caches phase 9's served path gives the decode kernel: run_colocated's
        # max_seq is 512 + 32 + 8 = 552, where decode_plan splits the rows
        # otherwise than at 1024 (olmoe: 9 chunks on 8 CTAs, some holding none)
        ("decode_attention", "olmoe-serve B=4 H=16 KV=16 S=552 D=128 lengths 0, 512, 530, 544",
         lambda: (randn(4, 16, 128), randn(4, 16, 552, 128), randn(4, 16, 552, 128),
                  lens(0, 512, 530, 544)), {}),
        ("decode_attention", "zamba2-serve B=4 H=32 KV=32 S=552 D=80 lengths 0, 512, 530, 544",
         lambda: (randn(4, 32, 80), randn(4, 32, 552, 80), randn(4, 32, 552, 80),
                  lens(0, 512, 530, 544)), {}),
        # phase 10's archs at the shapes their paths give the kernels:
        # grok-1 (n_rep 6, D = 128), nemotron (n_rep 12, D = 192, d = 18432),
        # whisper (D = 64, n_rep 1: the encoder's 1500 frames, the decoder's
        # cross-attention from a 512-token prompt to them, the static cross
        # cache of 1500 rows and the self cache; d = 1280) and pixtral (n_rep
        # 4 at a 1088-token prompt); decode at the served max_seq of 552
        # with lengths 0 and 544 among them; each timed
        ("rmsnorm", "nemotron N=512 d=18432", lambda: (randn(512, 18432), randn(18432)), {}),
        ("rmsnorm", "whisper N=512 d=1280", lambda: (randn(512, 1280), randn(1280)), {}),
        ("flash_attention", "grok B=1 S=512 H=48 KV=8 D=128 causal",
         lambda: (randn(1, 512, 48, 128), randn(1, 512, 8, 128), randn(1, 512, 8, 128)),
         {"causal": True}),
        ("flash_attention", "nemotron B=1 S=512 H=96 KV=8 D=192 causal",
         lambda: (randn(1, 512, 96, 192), randn(1, 512, 8, 192), randn(1, 512, 8, 192)),
         {"causal": True}),
        ("flash_attention", "whisper-enc B=1 S=1500 H=20 KV=20 D=64 non-causal",
         lambda: (randn(1, 1500, 20, 64), randn(1, 1500, 20, 64), randn(1, 1500, 20, 64)),
         {"causal": False}),
        ("flash_attention", "whisper-cross B=1 Sq=512 Sk=1500 H=20 KV=20 D=64 non-causal",
         lambda: (randn(1, 512, 20, 64), randn(1, 1500, 20, 64), randn(1, 1500, 20, 64)),
         {"causal": False}),
        ("flash_attention", "pixtral B=1 S=1088 H=32 KV=8 D=128 causal",
         lambda: (randn(1, 1088, 32, 128), randn(1, 1088, 8, 128), randn(1, 1088, 8, 128)),
         {"causal": True}),
        # whisper's decoder self-attention prefill (one prompt: parity and the
        # idle prefill; four: the served prefill), and its encoder and cross
        # prefill at the served B = 4
        ("flash_attention", "whisper-self B=1 S=512 H=20 KV=20 D=64 causal",
         lambda: (randn(1, 512, 20, 64), randn(1, 512, 20, 64), randn(1, 512, 20, 64)),
         {"causal": True}),
        ("flash_attention", "whisper-self-b4 B=4 S=512 H=20 KV=20 D=64 causal",
         lambda: (randn(4, 512, 20, 64), randn(4, 512, 20, 64), randn(4, 512, 20, 64)),
         {"causal": True}),
        ("flash_attention", "whisper-enc-b4 B=4 S=1500 H=20 KV=20 D=64 non-causal",
         lambda: (randn(4, 1500, 20, 64), randn(4, 1500, 20, 64), randn(4, 1500, 20, 64)),
         {"causal": False}),
        ("flash_attention", "whisper-cross-b4 B=4 Sq=512 Sk=1500 H=20 KV=20 D=64 non-causal",
         lambda: (randn(4, 512, 20, 64), randn(4, 1500, 20, 64), randn(4, 1500, 20, 64)),
         {"causal": False}),
        # untimed: the shapes of phase 10's parity runs (one sequence, max_seq
        # 1024, pixtral's 1152, at the last decode step's length) and of
        # whisper's live split (128 tokens)
        ("flash_attention", "live whisper B=1 S=128 H=20 KV=20 D=64 causal",
         lambda: (randn(1, 128, 20, 64), randn(1, 128, 20, 64), randn(1, 128, 20, 64)),
         {"causal": True}),
        ("decode_attention", "parity grok B=1 H=48 KV=8 S=1024 D=128 length 528",
         lambda: (randn(1, 48, 128), randn(1, 8, 1024, 128), randn(1, 8, 1024, 128), lens(528)), {}),
        ("decode_attention", "parity nemotron B=1 H=96 KV=8 S=1024 D=192 length 528",
         lambda: (randn(1, 96, 192), randn(1, 8, 1024, 192), randn(1, 8, 1024, 192), lens(528)), {}),
        ("decode_attention", "parity whisper self B=1 H=20 KV=20 S=1024 D=64 length 528",
         lambda: (randn(1, 20, 64), randn(1, 20, 1024, 64), randn(1, 20, 1024, 64), lens(528)), {}),
        ("decode_attention", "parity whisper cross B=1 H=20 KV=20 S=1500 D=64 length 1500",
         lambda: (randn(1, 20, 64), randn(1, 20, 1500, 64), randn(1, 20, 1500, 64), lens(1500)), {}),
        ("decode_attention", "parity pixtral B=1 H=32 KV=8 S=1152 D=128 length 1104",
         lambda: (randn(1, 32, 128), randn(1, 8, 1152, 128), randn(1, 8, 1152, 128), lens(1104)), {}),
        ("decode_attention", "n_rep 3 D=16 B=5 H=6 KV=2 S=600 lengths 0, 600, 1, 33, 333",
         lambda: (randn(5, 6, 16), randn(5, 2, 600, 16), randn(5, 2, 600, 16),
                  lens(0, 600, 1, 33, 333)), {}),
        ("decode_attention", "grok-serve B=4 H=48 KV=8 S=552 D=128 lengths 0, 512, 530, 544",
         lambda: (randn(4, 48, 128), randn(4, 8, 552, 128), randn(4, 8, 552, 128),
                  lens(0, 512, 530, 544)), {}),
        ("decode_attention", "nemotron-serve B=4 H=96 KV=8 S=552 D=192 lengths 0, 512, 530, 544",
         lambda: (randn(4, 96, 192), randn(4, 8, 552, 192), randn(4, 8, 552, 192),
                  lens(0, 512, 530, 544)), {}),
        ("decode_attention", "whisper-cross B=4 H=20 KV=20 S=1500 D=64 lengths 1500 x 4",
         lambda: (randn(4, 20, 64), randn(4, 20, 1500, 64), randn(4, 20, 1500, 64),
                  lens(1500, 1500, 1500, 1500)), {}),
        ("decode_attention", "whisper-serve B=4 H=20 KV=20 S=552 D=64 lengths 0, 512, 530, 544",
         lambda: (randn(4, 20, 64), randn(4, 20, 552, 64), randn(4, 20, 552, 64),
                  lens(0, 512, 530, 544)), {}),
        ("decode_attention", "pixtral-serve B=4 H=32 KV=8 S=552 D=128 lengths 0, 512, 530, 544",
         lambda: (randn(4, 32, 128), randn(4, 8, 552, 128), randn(4, 8, 552, 128),
                  lens(0, 512, 530, 544)), {}),
        # the int8 cache (kv_quant) under q of the case's dtype: the serving
        # shape, the n_rep and head dims of phases 9 and 10 (grok's 6,
        # nemotron's 12 at D = 192, whisper's D = 64, zamba2's D = 80) at
        # their served S = 552, and the long-context phase's 8 and 16 x 32k;
        # each timed cold
        ("decode_attention_int8", "main B=4 H=32 KV=8 S=1024 D=128 int8 lengths 1, 300, 517, 1024",
         lambda: int8(4, 32, 8, 1024, 128, 1, 300, 517, 1024), {}),
        ("decode_attention_int8", "int8-grok B=4 H=48 KV=8 S=552 D=128 lengths 0, 512, 530, 544",
         lambda: int8(4, 48, 8, 552, 128, 0, 512, 530, 544), {}),
        ("decode_attention_int8", "int8-nemotron B=4 H=96 KV=8 S=552 D=192 lengths 0, 512, 530, 544",
         lambda: int8(4, 96, 8, 552, 192, 0, 512, 530, 544), {}),
        ("decode_attention_int8", "int8-whisper B=4 H=20 KV=20 S=552 D=64 lengths 0, 512, 530, 544",
         lambda: int8(4, 20, 20, 552, 64, 0, 512, 530, 544), {}),
        ("decode_attention_int8", "int8-zamba2 B=4 H=32 KV=32 S=552 D=80 lengths 0, 512, 530, 544",
         lambda: int8(4, 32, 32, 552, 80, 0, 512, 530, 544), {}),
        ("decode_attention_int8", "int8-long B=8 H=32 KV=8 S=32768 D=128 lengths 32768 x 7, 30001",
         lambda: int8(8, 32, 8, 32768, 128, *([32768] * 7), 30001), {}),
        ("decode_attention_int8", "int8-long16 B=16 H=32 KV=8 S=32768 D=128 lengths 32768 x 15, 30001",
         lambda: int8(16, 32, 8, 32768, 128, *([32768] * 15), 30001), {}),
        # the long-context phase's bf16 cache beside its int8 one
        ("decode_attention", "long B=8 H=32 KV=8 S=32768 D=128 lengths 32768 x 7, 30001",
         lambda: (randn(8, 32, 128), randn(8, 8, 32768, 128), randn(8, 8, 32768, 128),
                  lens(*([32768] * 7), 30001)), {}),
        # phase 11's train loop, one microbatch of 4 x 2048 tokens: the
        # forward kernels (and their recompute under remat); each timed
        ("rmsnorm", "train N=8192 d=4096", lambda: (randn(8192, 4096), randn(4096)), {}),
        ("flash_attention", "train B=4 S=2048 H=32 KV=8 D=128 causal",
         lambda: (randn(4, 2048, 32, 128), randn(4, 2048, 8, 128), randn(4, 2048, 8, 128)),
         {"causal": True}),
        # untimed: phase 14(k)'s granite-8b with one KV head, its prefill of
        # 4 x 512 at 32/1 heads and its decode at n_rep 32 (4 head groups)
        ("flash_attention", "kv1 B=4 S=512 H=32 KV=1 D=128 causal",
         lambda: (randn(4, 512, 32, 128), randn(4, 512, 1, 128), randn(4, 512, 1, 128)),
         {"causal": True}),
        ("decode_attention", "kv1 B=4 H=32 KV=1 S=515 D=128 lengths 1, 300, 513, 515",
         lambda: (randn(4, 32, 128), randn(4, 1, 515, 128), randn(4, 1, 515, 128),
                  lens(1, 300, 513, 515)), {}),
    ]


def work(name: str, inputs, kw, dt: str) -> tuple[float, float]:
    """(bytes, flops) the function needs on these inputs: each input read
    once and each output written once; data-dependent work counted as this
    data needs it (causal pairs, valid cache rows)."""
    es = 2 if dt == "bf16" else 4
    if name == "rmsnorm":
        x, w = inputs
        n, d = x.numel() // x.shape[-1], x.shape[-1]
        return 2 * n * d * es + d * es, 4 * n * d
    if name == "flash_attention":
        q, k, _ = inputs
        b, sq, h, d = q.shape
        sk, kv = k.shape[1], k.shape[2]
        off = kw.get("q_offset", 0)  # row i is position off + i
        pairs = sum(min(off + i + 1, sk) for i in range(sq)) if kw.get("causal", True) else sq * sk
        return (2 * b * sq * h * d + 2 * b * sk * kv * d) * es, 4 * b * h * d * pairs
    q, k, _, lengths = inputs[:4]
    b, h, d = q.shape
    kv = k.shape[1]
    rows = int(lengths.clamp(0, k.shape[2]).sum())
    if name == "decode_attention_int8":  # int8 rows and their two f32 scales
        return 2 * b * h * d * es + rows * kv * (2 * d + 8) + 4 * b, 4 * h * d * rows
    return (2 * b * h * d + 2 * rows * kv * d) * es + 4 * b, 4 * h * d * rows


def library_call(torch, name: str, inputs, kw):
    """One PyTorch call computing the same function, as a function of an
    input set (timed only, never used by the port).  For decode attention the
    mask is built once: the cold copies share the lengths' values.  None
    for the int8 decode: no PyTorch call takes an int8 cache with scales."""
    F = torch.nn.functional
    if name == "decode_attention_int8":
        return None
    if name == "rmsnorm":
        return lambda x, w: F.rms_norm(x, (x.shape[-1],), w, 1e-5)
    if name == "flash_attention":
        causal, off = kw.get("causal", True), kw.get("q_offset", 0)
        mask = None
        if causal and off:  # SDPA's is_causal keeps the diagonal at 0: the offset's as a mask
            sq, sk = inputs[0].shape[1], inputs[1].shape[1]
            mask = (torch.arange(sq, device="cuda")[:, None] + off
                    >= torch.arange(sk, device="cuda")[None, :])
        return lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            is_causal=causal and not off, scale=kw.get("softmax_scale"), enable_gqa=True)
    _, k, _, lengths = inputs
    mask = (torch.arange(k.shape[2], device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    return lambda q, k, v, _lengths: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)


def dequant_sdpa(torch, inputs):
    """Beside the int8 decode, a different function: SDPA over the cache
    dequantized to bf16 beforehand (not timed), as a function of an input
    set, and the dequantized input sets' bytes."""
    F = torch.nn.functional
    q, kq, vq, lengths, ks, vs = inputs
    k, v = ((c.to(torch.bfloat16) * s[..., None]).to(torch.bfloat16) for c, s in ((kq, ks), (vq, vs)))
    mask = (torch.arange(k.shape[2], device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    return (q.to(torch.bfloat16), k, v), lambda q, k, v: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)


# PR 21's device ms of phase 2's int8 cases (PERF.md §6, H100 80GB HBM3 at
# 700 W; its CUDA-core loop at every q dtype), printed beside this run's
PR21_INT8_MS = {
    ("main", "bf16"): 0.01316, ("int8-grok", "bf16"): 0.01326, ("int8-nemotron", "bf16"): 0.03479,
    ("int8-whisper", "bf16"): 0.00964, ("int8-zamba2", "bf16"): 0.01329,
    ("int8-long", "bf16"): 0.37066, ("int8-long16", "bf16"): 0.70591,
    ("main", "f32"): 0.01406, ("int8-long", "f32"): 0.37832,
}


def int8_report(row: dict, inputs, tag: str, dt: str, card: str) -> None:
    """A timed int8 case's share of its bound and cache elements a second
    (its valid K and V values), beside PR 21's time, into ``row`` and the
    log."""
    from repro_torch.kernels import decode_attention as dk

    q, k, lengths = inputs[0], inputs[1], inputs[3]
    (b, h, d), (kv, s) = q.shape, k.shape[1:3]
    elems = 2 * int(lengths.clamp(0, s).sum()) * kv * d
    mma = dt == "bf16"
    plan = dk.decode_plan(b, kv, s, d, 1, h // kv, mma=mma,
                          clusters_fit=dk.clusters_fit_on(q.device.index) if mma else None)
    row.update(bound_share=row["bound_ms"] / row["ms"], elements_per_s=elems / (row["ms"] * 1e-3),
               pr21_ms=PR21_INT8_MS.get((tag, dt)),
               plan=dict(cluster=plan.cluster, chunk=plan.chunk, ring=plan.ring, smem=plan.smem))
    log(f"[kernels] int8 {dt} q, {row['case']}: {row['ms']:.5f} ms (PR 21 {row['pr21_ms']} ms), "
        f"bound {row['bound_ms']:.5f} ms, {100 * row['bound_share']:.1f}% of it, "
        f"{row['elements_per_s'] / 1e12:.3f} T elements/s, plan {row['plan']} | {card}")


# phase 2's flash cases that also check and time the forward's log-sum-exp
# output (the training path's call): the serving prefill and the train microbatch
LSE_TIMED = ("main", "train")


def check_forward_lse(torch, ref, inputs, kw, dt: str) -> dict:
    """flash_attention(return_lse=True): the output bit-equal to the call
    without it, each row's log-sum-exp within the kernel's tolerance of
    ``ref.flash_attention_lse_ref``."""
    from repro_torch.kernels import flash_attention as fk

    o, lse = fk.flash_attention(*inputs, return_lse=True, **kw)
    check(torch.equal(o, fk.flash_attention(*inputs, **kw)),
          f"flash forward {dt}: the output with return_lse differs from the output without it")
    want = ref.flash_attention_lse_ref(inputs[0], inputs[1], **kw)
    return {"lse_max_abs_err": max_err(torch, lse, want, dt), "lse_out_bit_equal": True}


def phase_kernels(torch, ops, ref, card: str) -> dict:
    from repro_torch.kernels import flash_attention as fk

    def int8_kernel(q, k, v, lengths, ks, vs, **kw):
        return ops.decode_attention(q, k, v, lengths, k_scale=ks, v_scale=vs, **kw)

    def int8_plain(q, k, v, lengths, ks, vs, **kw):
        return ref.decode_attention_ref(q, k, v, lengths, k_scale=ks, v_scale=vs, **kw)

    kernel_fn = {"rmsnorm": ops.rmsnorm, "flash_attention": ops.flash_attention,
                 "decode_attention": ops.decode_attention, "decode_attention_int8": int8_kernel}
    plain_fn = {"rmsnorm": ref.rmsnorm_ref, "flash_attention": ref.flash_attention_ref,
                "decode_attention": ref.decode_attention_ref, "decode_attention_int8": int8_plain}
    one = torch.zeros(1, device="cuda")
    floor = time_ms(torch, {"add": lambda t: t + 1}, [(one,)])["add"]
    results = {("launch_floor",): {"kernel": "launch floor", "case": "one-element torch add", "ms": floor}}
    log(f"[kernels] launch floor: a one-element add takes {floor:.5f} ms")
    for dt in ("bf16", "f32"):
        for name, case, make, kw in kernel_cases(torch, dt):
            inputs = make()
            got = kernel_fn[name](*inputs, impl="kernel", **kw)
            torch.cuda.synchronize()
            want = plain_fn[name](*inputs, **kw)
            if name.startswith("decode_attention"):
                # a row of length 0 gives 0, as the TPU kernel's acc / max(l,
                # 1e-30) does; the plain oracle averages V there
                want[inputs[3] == 0] = 0
            err = max_err(torch, got, want, dt, scaled=name.startswith("decode_attention"))
            row = {"kernel": name, "case": case, "dtype": dt, "max_abs_err": err,
                   "want_max_abs": float(want.float().abs().max())}
            tag = case.split()[0]
            lse = name == "flash_attention" and tag in LSE_TIMED
            if lse:
                row.update(check_forward_lse(torch, ref, inputs, kw, dt))
            if tag in TIMED:
                nbytes, flops = work(name, inputs, kw, dt)
                cold = name.startswith("decode_attention") or nbytes > L2_BYTES / 2
                sets = cold_sets(inputs) if cold else [inputs]
                fns = {
                    "plain": lambda *a: plain_fn[name](*a, **kw),
                    "kernel": lambda *a: kernel_fn[name](*a, impl="kernel", **kw),
                    "library": library_call(torch, name, inputs, kw),
                }
                if fns["library"] is None:
                    del fns["library"]
                if lse and dt == "bf16":  # the training path's forward, beside serving's
                    fns["kernel_lse"] = lambda *a: fk.flash_attention(*a, return_lse=True, **kw)
                if name == "rmsnorm":  # each call after a plain kernel, as on the model's path
                    fns["add"] = lambda *a: one + 1
                    fns["add_kernel"] = lambda *a: (one + 1, kernel_fn[name](*a, impl="kernel", **kw))
                times = time_ms(torch, fns, sets)
                row.update(ms=times["kernel"], plain_ms=times["plain"],
                           library_ms=times.get("library"), bytes=nbytes, flops=flops,
                           timed="cold" if len(sets) > 1 else "warm", copies=len(sets))
                if name == "decode_attention_int8":  # SDPA over a bf16 copy: another function
                    dq_sets = [dequant_sdpa(torch, inp) for inp in sets]
                    fn = dq_sets[0][1]
                    row["dequant_bf16_sdpa_ms"] = time_ms(torch, {"sdpa": fn},
                                                          [d for d, _ in dq_sets])["sdpa"]
                    del dq_sets
                if "kernel_lse" in times:
                    row["lse_ms"] = times["kernel_lse"]
                if name == "rmsnorm":
                    # ms chains the PDL launches into each other; after_add_ms is
                    # a call after a plain kernel, that kernel's own time taken off
                    row.update(launch_floor_ms=floor, after_add_ms=times["add_kernel"] - times["add"])
                del sets
                row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dt)
                if name == "decode_attention_int8":
                    int8_report(row, inputs, tag, dt, card)
                results[(name, dt) if tag == "main" else (name, dt, tag)] = row
            log("[kernels] " + json.dumps(row))
            del inputs, got, want
    return results


# ---------------------------------------------------------------------------
# Phase 3: kernel path against plain path, whole model
# ---------------------------------------------------------------------------


def rescale_fan_in_(params: dict, template: dict, d_model: int) -> None:
    """Scale every stacked weight drawn from a normal (the layers' and the
    encoder's leaves with a leading layer axis) from the reference's std
    1/sqrt(n_layers) to 1/sqrt(d_model), in place."""
    for k, v in params.items():
        if isinstance(v, dict):
            rescale_fan_in_(v, template[k], d_model)
        elif template[k].init == "normal" and v.dim() > 2:
            v.mul_(math.sqrt(v.shape[0] / d_model))


def stub_frames(torch, cfg, b: int, seed: int):
    """(b, n_frontend_tokens, d_model) stub frame embeddings, normal x 0.02
    as the JAX package's data pipeline draws them, from ``seed``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return torch.randn((b, cfg.n_frontend_tokens, cfg.d_model), generator=gen, device="cuda") * 0.02


def _logits_run(torch, ops, TF, cfg, params, impl, tokens, frames, max_seq, feed=None):
    """Prefill of ``tokens`` (one sequence) and 16 decode steps on ``impl``:
    (17, V) logits in the run's dtype, and the fed tokens, which are the
    run's own argmax unless ``feed`` is given."""
    own = feed is None
    feed = [] if own else feed
    with ops.use_impl(impl):
        caches = TF.init_caches(cfg, 1, max_seq, device="cuda")
        logits, caches = TF.prefill_logits(cfg, params, tokens, caches, frames)
        steps = [logits]
        for t in range(16):
            if own:
                feed.append(logits.argmax(-1).to(torch.int32))
            logits, caches = TF.decode_logits(cfg, params, feed[t], caches)
            steps.append(logits)
    return torch.stack(steps)[:, 0, :cfg.vocab_size], feed


def phase_parity(torch, np, ops, TF, base_cfg, n_layers: int = 2, prompt_len: int = 512,
                 fan_in: bool = False, **cut) -> dict:
    """Kernel path against plain path at full width, cut to ``n_layers``
    layers (and the config fields in ``cut``): a ``prompt_len``-token
    prefill and 16 decode steps, every run fed the tokens that the f32
    kernel path chooses.  A vlm or encdec config gets n_frontend_tokens
    stub frames (normal x 0.02, from the seed) in its prefill.  With
    ``fan_in`` every stacked weight is drawn at std 1/sqrt(d_model) instead
    of the reference's 1/sqrt(n_layers) (see PARITY_CUTS).

    f32: the token ids must be equal.  bf16: the two paths round at other
    places (the plain decode casts the probabilities to bf16 as the reference
    does, the kernel keeps them in f32), and this random model's saturated
    softmax turns a one-ulp difference into logit differences of a few 1e-2.
    So each bf16 path is held against the f32 plain run of the same weights:
    the kernel path's mean error may exceed the plain path's by at most 5%,
    and the mean kernel-vs-plain difference must stay within 2e-2.  Run for
    granite-8b (GQA, n_rep 4), qwen1.5-4b (n_rep 1 at D = 128) and
    minicpm3-4b (MLA: flash at D = 96, the absorbed decode in plain
    products, 4L+1 rmsnorms per pass), and in phases 9 and 10 for each arch
    there.

    The bf16 weights are the f32 ones cast leaf by leaf in place, each f32
    leaf freed as its bf16 copy is made: nemotron's one-layer cut is 51.5 GB
    in f32, and a whole bf16 copy beside it would not fit the card."""
    tag = base_cfg.name + (" kv_quant" if cut.get("kv_quant") else "")
    V = base_cfg.vocab_size
    max_seq = max(1024, prompt_len + 64)
    prompt = np.random.default_rng(SEED).integers(0, V, size=(1, prompt_len))
    tokens = torch.as_tensor(prompt.astype(np.int32), device="cuda")
    frames = stub_frames(torch, base_cfg, 1, SEED) if base_cfg.family in ("vlm", "encdec") else None

    def run(cfg, params, impl, feed=None):
        return _logits_run(torch, ops, TF, cfg, params, impl, tokens, frames, max_seq, feed)

    def cast_(tree, template):
        """Each leaf to its dtype in the bf16 model's template (the MoE
        router and Mamba2's A, dt bias and skip stay f32), in place."""
        for k, v in tree.items():
            if isinstance(v, dict):
                cast_(v, template[k])
            else:
                tree[k] = v.to(template[k].dtype)
                del v

    cfg32 = base_cfg.replace(n_layers=n_layers, dtype=torch.float32, **cut)
    p32 = TF.init_params(cfg32, SEED, device="cuda")
    if fan_in:
        rescale_fan_in_(p32, TF.param_template(cfg32), base_cfg.d_model)
    k32, feed = run(cfg32, p32, "kernel")
    r32, _ = run(cfg32, p32, "ref", feed)
    check(bool(torch.isfinite(k32).all()), f"parity {tag} f32: logits not finite")
    k_ids, r_ids = k32.argmax(-1), r32.argmax(-1)
    top2 = r32.topk(2, dim=-1).values
    f32 = {"positions": int(k_ids.numel()), "ids_equal": bool(torch.equal(k_ids, r_ids)),
           "max_abs_logit_diff": float((k32 - r32).abs().max()),
           "min_top2_margin": float((top2[:, 0] - top2[:, 1]).min())}
    log(f"[parity] {tag} f32 " + json.dumps(f32))
    check(f32["ids_equal"], f"parity {tag} f32: token ids differ: {k_ids.tolist()} vs {r_ids.tolist()}")

    cfg16 = base_cfg.replace(n_layers=n_layers, dtype=torch.bfloat16, **cut)
    cast_(p32, TF.param_template(cfg16))
    p16 = p32
    del p32
    k16 = run(cfg16, p16, "kernel", feed)[0].float()
    r16 = run(cfg16, p16, "ref", feed)[0].float()
    check(bool(torch.isfinite(k16).all()), f"parity {tag} bf16: logits not finite")
    diff = (k16 - r16).abs()
    bf16 = {"mean_abs_diff": float(diff.mean()), "max_abs_diff": float(diff.max()),
            "kernel_vs_f32_mean_err": float((k16 - r32).abs().mean()),
            "plain_vs_f32_mean_err": float((r16 - r32).abs().mean()),
            "kernel_vs_f32_max_err": float((k16 - r32).abs().max()),
            "plain_vs_f32_max_err": float((r16 - r32).abs().max())}
    log(f"[parity] {tag} bf16 " + json.dumps(bf16))
    check(bf16["kernel_vs_f32_mean_err"] <= 1.05 * bf16["plain_vs_f32_mean_err"],
          f"parity {tag} bf16: the kernel path is less accurate than the plain path")
    check(bf16["mean_abs_diff"] <= 2e-2, f"parity {tag} bf16: mean logit difference above 2e-2")
    del p16
    torch.cuda.empty_cache()
    return {"f32": f32, "bf16": bf16}


WITNESS_RATIO = 2.0  # kernel path's distance from the f64 run, at most this x the plain path's


def phase_f64_witness(torch, np, ops, TF, base_cfg, **cut) -> dict:
    """Both f32 paths against a float64 run of the plain path (the same f32
    weights widened), under the reference's init law, where phase_parity
    cannot hold whisper's f32 ids equal (PARITY_CUTS): the encoder's output
    alone, and phase_parity's 512-token prefill and 16 decode steps, every
    run fed the tokens that the f32 kernel path picks.  Rounding amplified
    by the weights puts the two f32 paths at about one distance from the
    f64 run; a kernel that computed something else at these scores would
    put the kernel path farther.  Held: the kernel path's max and mean
    distances (encoder output, logits) within WITNESS_RATIO of the plain
    path's."""
    cfg32 = base_cfg.replace(dtype=torch.float32, **cut)
    tag = f"{base_cfg.name} {cfg32.n_enc_layers} + {cfg32.n_layers}"
    prompt = np.random.default_rng(SEED).integers(0, cfg32.vocab_size, size=(1, 512))
    tokens = torch.as_tensor(prompt.astype(np.int32), device="cuda")
    frames = stub_frames(torch, base_cfg, 1, SEED)
    p32 = TF.init_params(cfg32, SEED, device="cuda")

    def widen(tree):
        return {k: widen(v) if isinstance(v, dict) else v.double() for k, v in tree.items()}

    runs = (("kernel", cfg32, p32), ("plain", cfg32, p32),
            ("f64", cfg32.replace(dtype=torch.float64), widen(p32)))
    enc, logits, feed = {}, {}, None
    for name, cfg, p in runs:
        impl = "kernel" if name == "kernel" else "ref"
        with ops.use_impl(impl):
            enc[name] = TF._run_encoder(cfg, p, frames)
        logits[name], feed = _logits_run(torch, ops, TF, cfg, p, impl, tokens, frames, 1024, feed)
    del runs
    row = {}
    for what, out in (("encoder", enc), ("logits", logits)):
        truth = out["f64"]
        for name in ("kernel", "plain"):
            d = (out[name].double() - truth).abs()
            row[f"{what}_{name}_max"], row[f"{what}_{name}_mean"] = float(d.max()), float(d.mean())
        row[f"{what}_scale"] = float(truth.abs().max())
        row[f"{what}_kernel_vs_plain_max"] = float((out["kernel"] - out["plain"]).abs().max())
    ids = {name: out.argmax(-1) for name, out in logits.items()}
    row["ids_equal"] = {name: bool(torch.equal(ids[name], ids["f64"])) for name in ("kernel", "plain")}
    log(f"[witness] {tag} " + json.dumps(row))
    check(bool(torch.isfinite(logits["kernel"]).all()), f"witness {tag}: logits not finite")
    for what in ("encoder", "logits"):
        for stat in ("max", "mean"):
            k, r = row[f"{what}_kernel_{stat}"], row[f"{what}_plain_{stat}"]
            check(k <= WITNESS_RATIO * r,
                  f"witness {tag}: the kernel path's {stat} {what} distance from f64 {k} exceeds "
                  f"{WITNESS_RATIO} x the plain path's {r}")
    del enc, logits, p32
    gc.collect()
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Phase 4: serve full granite-8b
# ---------------------------------------------------------------------------


def phase_serve(torch, np, ops, TF, cfg, engine_mod, params) -> dict:
    n_req, prompt_len, new_tokens, n_slots, max_seq = 8, 512, 32, 4, 1024
    L = cfg.n_layers
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len).astype(np.int32)
               for _ in range(n_req)]
    eng = engine_mod.InstanceEngine(cfg, params, n_slots=n_slots, max_seq=max_seq)

    # warm-up (cuBLAS handles, allocator) and idle-instance TTFT: one prefill
    ttft = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.prefill_only(engine_mod.ServeRequest(-1 - i, prompts[i], 1))  # ends in a host read
        ttft.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()

    # the capture the first admission makes, timed apart from serving: a
    # warm-up step and the capture, and the memory its graph pool keeps
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    eng._capture()
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    capture_mib = (torch.cuda.memory_reserved() - reserved0) / 2**20

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    steps0 = eng.steps
    for i, p in enumerate(prompts):
        eng.submit(engine_mod.ServeRequest(i, p, new_tokens))
    decode_step_ms = []
    t_start = time.perf_counter()
    done = []
    while eng.queue or eng.active:
        admits = min(len(eng.queue), len(eng.free_slots))
        t0 = time.perf_counter()
        done.extend(eng.step())  # ends in a host read of the step's tokens
        dt_s = time.perf_counter() - t0
        if admits == 0:
            decode_step_ms.append(dt_s * 1e3)
        check(eng.steps - steps0 < 10 * n_req * new_tokens, "serve: engine does not finish")
    wall_s = time.perf_counter() - t_start
    counts = ops.launch_counts()
    steps = eng.steps - steps0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    check(len(done) == n_req, f"serve: {len(done)} of {n_req} requests finished")
    for r in done:
        check(len(r.out_tokens) == new_tokens, f"serve: request {r.rid} has {len(r.out_tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens), f"serve: request {r.rid} token out of range")
    want = {"rmsnorm": (2 * L + 1) * (n_req + steps), "flash_attention": L * n_req,
            "decode_attention": L * steps, "rmsnorm_bwd": 0, "flash_attention_bwd": 0}
    check(counts == want, f"serve: launch counts {counts} != the path's {want}")
    check(all(counts[k] > 0 for k in FWD_KERNELS), f"serve: a kernel was not launched: {counts}")

    tok = torch.as_tensor(prompts[0][None], device="cuda")
    logits, _ = TF.prefill_logits(cfg, params, tok, TF.init_caches(cfg, 1, max_seq, device="cuda"))
    check(bool(torch.isfinite(logits[:, : cfg.vocab_size]).all()), "serve: logits not finite")

    # the captured step against an eager loop of TF.decode_step over the same
    # prompts and the same kind of caches: an engine that never captures
    # steps eagerly on its buffers (_decode_all, the captured region)
    eager = engine_mod.InstanceEngine(cfg, params, n_slots=n_slots, max_seq=max_seq)
    eager._capture_pending = False
    for i, p in enumerate(prompts):
        eager.submit(engine_mod.ServeRequest(i, p, new_tokens))
    want_tokens = {r.rid: r.out_tokens for r in eager.run_until_done()}
    check({r.rid: r.out_tokens for r in done} == want_tokens,
          "serve: the captured engine's tokens differ from the eager loop's")
    del eager

    step_ms = sorted(decode_step_ms)[len(decode_step_ms) // 2]
    row = {
        "requests": n_req, "prompt_tokens": prompt_len, "new_tokens": new_tokens,
        "n_slots": n_slots, "max_seq": max_seq, "layers": L, "decode_steps": steps,
        "ttft_idle_ms": sorted(ttft)[1], "wall_s": wall_s,
        "tokens_per_s": n_req * new_tokens / wall_s,
        "pure_decode_steps": len(decode_step_ms), "decode_step_ms_median": step_ms,
        "decode_tokens_per_s_full_batch": n_slots / (step_ms / 1e3),
        "peak_mem_gib": peak_gib, "launches": counts, "tokens_equal_to_eager_loop": True,
        "graph_launches_per_step": eng._graph_launches, "capture_ms": capture_ms,
        "capture_reserved_mib": capture_mib,
    }
    log("[serve] " + json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# Phase 5: live split
# ---------------------------------------------------------------------------


def attn_blocks(cfg) -> int:
    """Attention blocks per pass: every layer of a dense or MoE stack, none
    of an SSM stack, one per shared-block site of a hybrid."""
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers


def norms_per_pass(cfg) -> int:
    """rmsnorm launches per prefill or decode step: norm1 and norm2 per
    attention block (MLA's q_norm and kv_norm besides), norm1 and the gated
    norm per Mamba2 layer, and the final norm."""
    ssm_layers = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    return 2 * ssm_layers + (4 if cfg.attn == "mla" else 2) * attn_blocks(cfg) + 1


def path_launches(cfg, prefills: int, steps: int) -> dict:
    """The kernel launches of ``prefills`` prefills and ``steps`` decode
    steps: flash once per attention block per prefill, decode attention once
    per attention block per step (MLA decodes in plain products), the
    norms of every pass.  An enc-dec prefill also runs the encoder (flash
    and 2 norms a layer, and enc_norm), and each decoder block's
    cross-attention adds a flash per prefill, a decode per step and its
    norm_x to every pass.  Serving takes no gradient: no backward kernel."""
    want = {"rmsnorm": norms_per_pass(cfg) * (prefills + steps),
            "flash_attention": attn_blocks(cfg) * prefills,
            "decode_attention": 0 if cfg.attn == "mla" else attn_blocks(cfg) * steps,
            "rmsnorm_bwd": 0, "flash_attention_bwd": 0}
    if cfg.family == "encdec":
        want["rmsnorm"] += (2 * cfg.n_enc_layers + 1) * prefills + cfg.n_layers * (prefills + steps)
        want["flash_attention"] += (cfg.n_enc_layers + cfg.n_layers) * prefills
        want["decode_attention"] += cfg.n_layers * steps
    return want


def phase_live(torch, np, ops, TF, live, cfg, params, seq: int = 128, frames=None) -> dict:
    """cooperative_forward against the monolithic forward at k in {0, 1,
    L/2, L}, bit for bit: both run the same kernels in the same order on one
    card.  A vlm's ``frames`` enter both.  An enc-dec model's split runs the
    decoder layers without cross-attention (the reference's
    forward_layers_range), so its monolithic forward is the decoder stack
    run whole the same way, not train_forward."""
    L = cfg.n_layers
    tokens = torch.as_tensor(
        np.random.default_rng(SEED + 2).integers(0, cfg.vocab_size, size=(1, seq)).astype(np.int32),
        device="cuda")
    ks = (0, 1, L // 2, L)
    ops.reset_launch_counts()
    if cfg.family == "encdec":
        x = TF.forward_layers_range(cfg, params["layers"], TF._embed(cfg, params, tokens), 0, L,
                                    TF._positions(tokens))
        x = ops.rmsnorm(x, params["final_norm"], eps=cfg.norm_eps)
        full = TF.layers.unembed(params["embed"], x, cfg)
    else:
        full, _ = TF.train_forward(cfg, params, tokens, frames)
    check(bool(torch.isfinite(full).all()), f"live {cfg.name}: logits not finite")
    errs = {}
    for k in ks:
        coop = live.cooperative_forward(cfg, params, tokens, k, frames)
        diff = (coop.float() - full.float()).abs()
        errs[k] = float(diff.max())
        check(bool(torch.equal(coop, full)), f"live {cfg.name}: split k={k} differs from the monolithic forward by {errs[k]}")
    counts = ops.launch_counts()
    want = path_launches(cfg.replace(family="dense") if cfg.family == "encdec" else cfg,
                         1 + len(ks), 0)
    check(counts == want, f"live {cfg.name}: launch counts {counts} != the path's {want}")
    row = {"model": cfg.name, "ks": list(ks), "max_abs_diff": errs,
           "launches": counts}
    log("[live] " + json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# Phase 6: where a decode step's and a prefill's time goes
# ---------------------------------------------------------------------------


LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
               "cudaGraphLaunch", "cuGraphLaunch")
DEVICE_RECORDS = ("kernel", "gpu_memcpy", "gpu_memset")  # trace categories of device activity
TRACE_DIR = ROOT / "build" / "smoke_traces"  # the traces read back when no --log-dir is given


def _traced(torch, fn, units: int, log_dir: Path | None, trace_name: str,
            record: bool = False) -> tuple[list, float, dict, dict | None]:
    """torch.profiler over ``fn()``: (kernels as (device us, name, launches)
    sorted by time, profiled wall ms per unit, the host's kernel-launch API
    calls per unit: count and CPU ms, the profiler's cost included, and with
    ``record`` the window's launch record: ``_launch_record`` of its trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        ((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
         if e.device_type != DeviceType.CPU and e.self_device_time_total > 0),
        reverse=True,
    )
    api = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU and e.key in LAUNCH_APIS]
    host = {"launch_calls": sum(e.count for e in api) / units,
            "launch_cpu_ms": sum(e.self_cpu_time_total for e in api) / (units * 1e3)}
    path = None
    if log_dir is not None:
        path = log_dir / trace_name
    elif record:
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        path = TRACE_DIR / trace_name
    if path is not None:
        prof.export_chrome_trace(str(path))
    launched = _launch_record(json.loads(path.read_text())) if record else None
    return kernels, wall_ms / units, host, launched


def _is_launch_call(name: str) -> bool:
    """A host API call that launches device work: a kernel or a graph."""
    return name.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")) \
        and "HostFunc" not in name


def _launch_record(trace: dict) -> dict:
    """One window's chrome trace joined by CUPTI correlation id: for each
    host call that launched a kernel or a graph, its name and the names of
    the device records that carry its id (a graph replay's records all
    carry its launch's id)."""
    calls, records = {}, {}
    for e in trace.get("traceEvents", []):
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        if e.get("cat") in DEVICE_RECORDS:
            records.setdefault(corr, []).append(e.get("name", ""))
        elif _is_launch_call(e.get("name", "")):
            calls[corr] = e["name"]
    return {c: (name, records.get(c, [])) for c, name in calls.items()}


def check_launched(launched: dict, kernel: str, per_unit: int, units: int, what: str) -> dict:
    """Hold one profiled window to ``kernel`` recorded ``per_unit`` times in
    each of its ``units``.  The profiler now and then loses a device record
    (PERF.md §7), and only the same window can tell a lost record from a
    launch that did not happen: a kernel launch call whose id no record
    carries, or a replay holding fewer records than the window's fullest
    replay of its one graph, lost records.  The kernel's count may fall
    short only by records lost so (in the replay that lost them, for a
    graph); any other shortfall, or any excess, fails."""
    graphs = {c: recs for c, (name, recs) in launched.items() if "Graph" in name}
    full = max((len(r) for r in graphs.values()), default=0)
    lost = sum(1 for name, recs in launched.values() if "Graph" not in name and not recs)
    lost += sum(full - len(r) for r in graphs.values())
    found = sum(kernel in n for _, recs in launched.values() for n in recs)
    per_replay = [sum(kernel in n for n in r) for r in graphs.values()]
    short = [len(r) < full for r in graphs.values()]
    if graphs:
        check(len(graphs) == units, f"{what}: {len(graphs)} graph launches recorded, not {units}")
        for got, r in zip(per_replay, graphs.values()):
            check(got == per_unit or (got < per_unit and per_unit - got <= full - len(r)),
                  f"{what}: a replay recorded {kernel} {got} times, not {per_unit}, and lost "
                  f"{full - len(r)} records (per replay: {per_replay}, short: {short})")
    want = per_unit * units
    check(found == want or (found < want and want - found <= lost),
          f"{what}: {kernel} recorded {found} times, not {want}, with {lost} records lost")
    return {"kernel": kernel, "recorded": found, "launched": want, "records_lost": lost,
            "recorded_per_replay": per_replay or None}


def eager_step(eng):
    """``eng.step`` with the engine's graph dropped for the call: the eager
    decode step (``_decode_all``, the captured region, run op by op) on the
    same buffers, for the captured step's comparison."""
    def step():
        graph, eng._graph = eng._graph, None
        try:
            return eng.step()
        finally:
            eng._graph = graph
    return step


def _wall_ms(step, n: int = 8) -> float:
    """Median wall ms of ``n`` calls of ``step`` (each ends in a host read)."""
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        ms.append((time.perf_counter() - t0) * 1e3)
    return sorted(ms)[n // 2]


def _step_row(torch, step, units: int, wall_ms: float, log_dir, trace: str,
              expect: tuple[str, int] | None = None) -> dict:
    """torch.profiler over ``units`` calls of ``step``: device ms per step,
    the busy share of ``wall_ms``, kernels and host launch calls per step
    (a graph replay is one cudaGraphLaunch); with ``expect`` = (kernel, n),
    ``check_launched`` holds the window to n launches of the kernel a step."""
    kernels, prof_ms, host, launched = _traced(
        torch, lambda: [step() for _ in range(units)], units, log_dir, trace, record=expect is not None)
    device_ms = sum(k[0] for k in kernels) / (units * 1e3)
    check(device_ms > 0, f"{trace}: no device time recorded")
    return {"launch_record": expect and check_launched(launched, *expect, units, trace),
            "wall_ms": wall_ms, "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
            "profiled_wall_ms": prof_ms, "kernels_launched": sum(n for *_, n in kernels) / units,
            "host_launch_calls": host["launch_calls"], "host_launch_cpu_ms": host["launch_cpu_ms"],
            "top_kernels_ms": [[k[:90], round(us / (units * 1e3), 5), n / units]
                               for us, k, n in kernels[:8]], "_kernels": kernels}


def phase_profile(torch, np, cfg, engine_mod, params, step_ms: float, ttft_ms: float,
                  log_dir: Path | None) -> dict:
    """torch.profiler over 3 decode steps at a full batch (4 slots, 512-token
    prompts) and over one idle 512-token prefill: device time of the kernels
    by name, per step or per prefill.  The busy share is that device time
    over phase 4's unprofiled median step time or idle TTFT (one stream, so
    kernels do not overlap; the profiler's own cost lengthens the profiled
    wall time, which is reported apart).  The host's time in the CUDA
    kernel-launch calls shows how much of the step the eager enqueueing
    costs (profiled, so an upper bound).  The decode step must launch the
    decode-attention kernel once per layer, and the prefill the flash
    kernel once per layer, in the one profiled window (``check_launched``).
    The captured step (one graph replay) is profiled beside the same
    engine's eager step (its graph dropped), whose unprofiled median is
    taken here."""
    L = cfg.n_layers
    eng = engine_mod.InstanceEngine(cfg, params, n_slots=4, max_seq=1024)
    rng = np.random.default_rng(SEED + 3)
    for i in range(4):
        eng.submit(engine_mod.ServeRequest(i, rng.integers(0, cfg.vocab_size, 512).astype(np.int32), 64))
    eng.step()
    eng.step()

    eager = eager_step(eng)
    eager_ms = _wall_ms(eager)

    def steps(step):
        return lambda: [step() for _ in range(3)]

    prompt = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
    rows = {}
    for what, fn, units, ref_ms, attn in (
        ("decode_step", steps(eng.step), 3, step_ms, "decode_attention_kernel"),
        ("decode_step_eager", steps(eager), 3, eager_ms, "decode_attention_kernel"),
        ("prefill", lambda: eng.prefill_only(engine_mod.ServeRequest(-9, prompt, 1)), 1, ttft_ms,
         "flash_fwd_sm90"),
    ):
        # one window each: a record the profiler lost is told apart from a
        # launch that did not happen within it (check_launched)
        kernels, wall_ms, host, launched = _traced(torch, fn, units, log_dir, f"{what}_trace.json",
                                                   record=True)
        device_ms = sum(k[0] for k in kernels) / (units * 1e3)
        check(device_ms > 0, f"profile {what}: no device time recorded")
        record = check_launched(launched, attn, L, units, f"profile {what}")
        rows[what] = {
            "units": units, "profiled_wall_ms": wall_ms, "device_ms": device_ms,
            "unprofiled_ms": ref_ms, "device_busy_share": device_ms / ref_ms,
            f"{attn}_launches": record["recorded"] / units, "launch_record": record,
            "kernels_launched": sum(n for *_, n in kernels) / units,
            "host_launch_calls": host["launch_calls"], "host_launch_cpu_ms": host["launch_cpu_ms"],
            "top_kernels_ms": [[k[:90], round(us / (units * 1e3), 5), n / units]
                               for us, k, n in kernels[:14]],
        }
        log(f"[profile] {what} " + json.dumps(rows[what]))
    return rows


# ---------------------------------------------------------------------------
# Phase 7: the serving control plane and the disaggregated runtime
# ---------------------------------------------------------------------------


NEAR_TIE = 0.05  # largest bf16 logit gap at which two paths may pick different tokens


def _path_launches(counts: dict, cfg, prefills: int, what: str) -> dict:
    """Launch counts of a serving run against the path (``path_launches``),
    the decode steps read off the decode kernel's count."""
    steps, rem = divmod(counts["decode_attention"], attn_blocks(cfg))
    want = path_launches(cfg, prefills, steps)
    check(rem == 0 and counts == want, f"{what}: launch counts {counts} != the path's {want}")
    check(all(counts[k] > 0 for k in FWD_KERNELS), f"{what}: a kernel was not launched: {counts}")
    return {"counts": counts, "decode_steps": steps}


def _router_times(np, router) -> dict:
    """TTFT p50/p99 and mean TBT in ms, from the router's records."""
    ttft = np.asarray([r.ttft for r in router.records.values() if r.ttft is not None])
    rep = router.slo_report()
    return {"ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
            "ttft_p99_ms": float(np.percentile(ttft, 99)) * 1e3,
            "tbt_mean_ms": rep.mean_tbt * 1e3, "tbt_p99_ms": rep.p99_tbt * 1e3,
            "slo_attainment": rep.attainment}


def _checked_disagg(torch, np, ops, TF, cfg, params, serve, disagg, args, what: str) -> dict:
    """``run_disagg`` as the CLI drives it, on the wall clock: every handoff
    completes, no request is dropped or gapped, each has its tokens,
    migrated bytes equal the payloads (the prompt share of a 1-slot cache:
    KV caches, SSM states), every engine shares ``params``, launches are the
    path's."""
    n, new_tokens, prompt_len = args.requests, args.gen_len, args.prompt_len
    max_seq = prompt_len + new_tokens + 8
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rt = serve.run_disagg(args, cfg, params)
    except SystemExit as e:
        raise SmokeFailure(f"{what}: {e}") from None
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _path_launches(ops.launch_counts(), cfg, n, what)
    s = rt.stats
    handoffs, gapped = rt.router.handoff_report()
    check(handoffs == s.migrations == n, f"{what}: handoffs {handoffs}/{s.migrations}, requests {n}")
    check(gapped == 0 and rt.n_outstanding == 0, f"{what}: {gapped} gapped, {rt.n_outstanding} outstanding")
    check(len(rt.completed) == n, f"{what}: {len(rt.completed)} of {n} completed")
    for r in rt.completed.values():
        check(len(r.out_tokens) == r.max_new_tokens == new_tokens,
              f"{what}: request {r.rid} has {len(r.out_tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens), f"{what}: request {r.rid} token out of range")
    payload = disagg.payload_bytes(TF.init_caches(cfg, 1, max_seq, device="cuda"), prompt_len, max_seq)
    check(s.migrated_bytes == n * payload, f"{what}: migrated bytes {s.migrated_bytes} != {n} payloads of {payload}")
    check(all(pe.engine.params is params for pe in rt.pool.all()), f"{what}: an engine copied the params")
    row = {
        "requests": n, "wall_s": wall, "tokens_per_s": n * new_tokens / wall,
        **_router_times(np, rt.router),
        "handoffs": handoffs, "migrations": s.migrations, "migrated_bytes": s.migrated_bytes,
        "payload_bytes_each": payload,
        "mutations": s.mutations, "mutation_param_bytes": s.mutation_param_bytes,
        "live_scaled_prefill": s.live_scaled_prefill, "direct_decode_scales": s.direct_decode_scales,
        "prescaled_decodes": s.prescaled_decodes, "scale_downs": s.scale_downs, "retired": s.retired,
        "engines_at_end": sorted((pe.device_id, pe.phase, pe.state) for pe in rt.pool.all()),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches["counts"],
    }
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _traced_disagg(torch, np, ops, cfg, params, disagg, args, log_dir: Path | None) -> dict:
    """7(d): ``run_disagg``'s runtime (launch/serve.py) built as the CLI builds
    it, with a span tracer and a flight recorder on its FlowSim, driven on the
    wall clock: every closed scale_op's makespan split exactly, the split
    unchanged by a round trip through the Chrome trace, and one incident
    bundle dumped at the end.  The trace and the bundle go to ``log_dir``, or
    to a temporary directory that is deleted."""
    from fractions import Fraction

    from repro_torch.core import topology as topo_mod
    from repro_torch.core.autoscaler import PolicyConfig
    from repro_torch.obs import (SCALE_SEGMENTS, FlightRecorder, Tracer, analyze_scale_ops,
                                 chrome_trace, format_scale_report, load_chrome)

    what = "cluster traced"
    n, new_tokens = args.requests, args.gen_len
    out_dir = log_dir if log_dir is not None else Path(tempfile.mkdtemp(prefix="chip_smoke_trace_"))
    try:
        rng = np.random.default_rng(args.seed)
        tracer = Tracer()
        rt = disagg.ClusterRuntime(
            cfg, params, topo=topo_mod.add_host_sources(topo_mod.make_cluster(2, 4, bw_gbps=100.0)),
            policy=PolicyConfig(max_instances=4, kv_upper=0.5, scale_down_timeout_s=0.5),
            n_prefill=args.n_prefill, n_decode=args.n_decode, n_slots=args.n_slots,
            max_seq=args.prompt_len + new_tokens + 8, model_bytes=cfg.approx_params() * 2,
            prefill_capacity_tps=2000.0, decode_capacity_tps=200.0, tracer=tracer)
        # the window holds the whole run, so the final bundle covers every op
        rec = FlightRecorder(tracer, window_s=3600.0, out_dir=str(out_dir)).attach(rt.net)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        clock = lambda: time.perf_counter() - t0  # noqa: E731
        for _ in range(n):
            prompt = rng.integers(0, cfg.vocab_size, size=args.prompt_len).astype(np.int32)
            rt.submit(prompt, new_tokens, clock())
        done = rt.run_until_done(clock)
        torch.cuda.synchronize()
        wall = clock()
        launches = _path_launches(ops.launch_counts(), cfg, n, what)
        check(done and rt.n_outstanding == 0 and len(rt.completed) == n,
              f"{what}: {len(rt.completed)} of {n} requests done, {rt.n_outstanding} outstanding")
        check(all(len(r.out_tokens) == new_tokens for r in rt.completed.values()),
              f"{what}: a request ended short of {new_tokens} tokens")
        spans = list(tracer.spans)
        reports = analyze_scale_ops(spans)
        check(len(reports) >= 1, f"{what}: no scale_op span closed ({rt.stats.live_scaled_prefill} "
              f"prefill and {rt.stats.direct_decode_scales} decode live scales)")
        for r in reports:
            check(tuple(r.segments_exact) == SCALE_SEGMENTS,
                  f"{what}: op {r.sid} segments {list(r.segments_exact)}")
            check(sum(r.segments_exact.values(), Fraction(0)) == Fraction(r.t1) - Fraction(r.t0),
                  f"{what}: op {r.sid}'s segments do not sum to its window {r.t0}..{r.t1}")
        text = format_scale_report(reports)
        exported = chrome_trace(spans)
        again = analyze_scale_ops(load_chrome(exported))
        check([r.sid for r in again] == [r.sid for r in reports] and format_scale_report(again) == text,
              f"{what}: the report changed through the Chrome trace:\n{text}\n---\n"
              f"{format_scale_report(again)}")
        path = rec.trigger("smoke:end", clock())
        check(path is not None and len(rec.dumps) == 1, f"{what}: {len(rec.dumps)} bundles dumped")
        doc = json.loads(Path(path).read_text())
        check(doc.get("displayTimeUnit") == "ms" and doc.get("traceEvents"),
              f"{what}: the bundle is not a Chrome trace")
        inc = doc.get("incident", {})
        cp_sids = [op["sid"] for op in inc.get("critical_path", {}).get("ops", [])]
        check(inc.get("trigger") == "smoke:end" and cp_sids == [r.sid for r in reports],
              f"{what}: the bundle's critical path lists ops {cp_sids}, the trace {[r.sid for r in reports]}")
        if log_dir is not None:
            (log_dir / "cluster_trace.json").write_text(exported)
            (log_dir / "cluster_scale_ops.txt").write_text(text + "\n")
        ops_ms = [{"sid": r.sid, "phase": r.phase, "t0_s": r.t0, "makespan_ms": r.makespan * 1e3,
                   "n_flows": r.n_flows, "aborted": r.aborted,
                   **{f"{k}_ms": v * 1e3 for k, v in r.breakdown().items()},
                   "bottleneck": r.bottleneck.cause if r.bottleneck else None} for r in reports]
        row = {"requests": n, "wall_s": wall, "tokens_per_s": n * new_tokens / wall,
               **_router_times(np, rt.router), "spans": len(spans), "scale_ops": ops_ms,
               "live_scaled_prefill": rt.stats.live_scaled_prefill,
               "direct_decode_scales": rt.stats.direct_decode_scales,
               "ring_events": len(inc["ring"]["events"]), "bundle_bytes": len(Path(path).read_bytes()),
               "launches": launches["counts"]}
        log("[cluster] scale ops (wall-clock ms on this card) " + json.dumps(ops_ms))
    finally:
        if log_dir is None:
            shutil.rmtree(out_dir, ignore_errors=True)
    del rt, rec, tracer
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_host_tools(tools: dict, log_dir: Path | None) -> dict:
    """7, the host tools' CLIs: each subprocess (started before the build,
    ended after it) exited 0."""
    rows = {}
    for name, (rc, out) in tools.items():
        if log_dir is not None:
            (log_dir / f"tool_{name}.log").write_text(out)
        check(rc == 0, f"tool {name}: exit {rc}:\n{out[-3000:]}")
        last = [line for line in out.splitlines() if line.strip()][-1:]
        rows[name] = {"exit": rc, "last_line": last[0] if last else ""}
        log(f"[tools] {name}: exit 0, {rows[name]['last_line']}")
    return rows


def phase_cluster(torch, np, ops, TF, cfg, params, serve, disagg, engine_mod, tools: dict,
                  log_dir: Path | None) -> dict:
    L, prompt_len, new_tokens, n_slots = cfg.n_layers, 512, 32, 4
    max_seq = prompt_len + new_tokens + 8
    t_phase = time.perf_counter()
    base = ["--arch", "granite-8b", "--prompt-len", str(prompt_len), "--gen-len", str(new_tokens),
            "--n-slots", str(n_slots), "--seed", str(SEED), "--device", "cuda"]
    rows = {}

    # (a) the colocated loop: one engine takes the burst, a second live-scales in
    n_a = 16
    args = serve.build_parser().parse_args(base + ["--requests", str(n_a)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.run_colocated(args, cfg, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _path_launches(ops.launch_counts(), cfg, n_a, "cluster colocated")
    eng0, eng1 = out["engines"]
    check(eng0.params is params and eng1.params is params, "cluster colocated: an engine copied the params")
    check(len(out["finished"]) == n_a, f"cluster colocated: {len(out['finished'])} of {n_a} requests finished")
    for r in out["finished"]:
        check(len(r.out_tokens) == new_tokens and all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"cluster colocated: request {r.rid} has tokens {r.out_tokens}")
    check(eng1.loaded_layers == L, f"cluster colocated: the scaled engine holds {eng1.loaded_layers} of {L} layers")
    check(launches["decode_steps"] == eng0.steps + eng1.steps,
          f"cluster colocated: {launches['decode_steps']} decode launches per layer, {eng0.steps + eng1.steps} steps")
    rows["colocated"] = {
        "requests": n_a, "wall_s": wall, "tokens_per_s": n_a * new_tokens / wall,
        "loop_steps": out["steps"], "engine_steps": [eng0.steps, eng1.steps],
        "phase": out["session"].phase.value,
        "modelled_load_ms": out["plan"].transfer_seconds(cfg.approx_params() * 2) * 1e3,
        "router_at_completion": _router_times(np, out["router"]),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches["counts"],
    }
    log("[cluster] colocated " + json.dumps(rows["colocated"]))
    del out, eng0, eng1
    torch.cuda.empty_cache()

    # (b) run_disagg on the wall clock, as the CLI drives it
    args = serve.build_parser().parse_args(
        base + ["--disagg", "--requests", "24", "--n-prefill", "2", "--n-decode", "1"])
    rows["disagg"] = _checked_disagg(torch, np, ops, TF, cfg, params, serve, disagg, args, "cluster disagg")
    log("[cluster] disagg " + json.dumps(rows["disagg"]))

    # (c) tokens: the runtime on a simulated clock against a lone engine
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len).astype(np.int32) for _ in range(4)]
    from repro_torch.core import topology as topo_mod
    from repro_torch.core.autoscaler import PolicyConfig

    rt = disagg.ClusterRuntime(
        cfg, params, topo=topo_mod.add_host_sources(topo_mod.make_cluster(2, 4, bw_gbps=100.0)),
        policy=PolicyConfig(max_instances=4, kv_upper=0.5, scale_down_timeout_s=0.5),
        n_prefill=2, n_decode=1, n_slots=n_slots, max_seq=max_seq,
        model_bytes=cfg.approx_params() * 2, prefill_capacity_tps=2000.0, decode_capacity_tps=200.0)
    rids = [rt.submit(p, new_tokens, 0.0) for p in prompts]
    t = 0.0
    for _ in range(5000):
        if rt.n_outstanding == 0:
            break
        t += 0.01
        rt.tick(t)
    check(rt.n_outstanding == 0, f"cluster tokens: {rt.n_outstanding} requests outstanding")
    lone = engine_mod.InstanceEngine(cfg, params, n_slots=n_slots, max_seq=max_seq)
    compared = []
    for rid, prompt in zip(rids, prompts):
        lone.submit(engine_mod.ServeRequest(100 + rid, prompt, new_tokens))
        (ref,) = lone.run_until_done()
        got, want = rt.completed[rid].out_tokens, ref.out_tokens
        check(got[0] == want[0], f"cluster tokens: request {rid} first token {got[0]} != {want[0]}")
        row = {"rid": rid, "equal": got == want}
        j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if j is not None:
            # the logits where the two first differ, after their shared prefix
            seq = np.concatenate([prompt, np.asarray(want[:j], np.int32)])[None]
            logits, _ = TF.prefill_logits(cfg, params, torch.as_tensor(seq, device="cuda"),
                                          TF.init_caches(cfg, 1, max_seq, device="cuda"))
            gap = float((logits[0, want[j]] - logits[0, got[j]]).abs())
            row.update(first_diff=j, tokens=[got[j], want[j]], logit_gap=gap)
            check(gap <= NEAR_TIE, f"cluster tokens: request {rid} diverges at {j} with a logit gap {gap} > {NEAR_TIE}")
        compared.append(row)
    rows["tokens"] = {"sim_seconds": t, "requests": compared, "near_tie": NEAR_TIE,
                      "mutations": rt.stats.mutations, "migrations": rt.stats.migrations}
    log("[cluster] tokens " + json.dumps(rows["tokens"]))
    del rt, lone
    torch.cuda.empty_cache()

    # (d) (b)'s runtime traced, with a flight recorder; then the host tools
    args = serve.build_parser().parse_args(
        base + ["--disagg", "--requests", "24", "--n-prefill", "2", "--n-decode", "1"])
    rows["traced"] = _traced_disagg(torch, np, ops, cfg, params, disagg, args, log_dir)
    log("[cluster] traced " + json.dumps({k: v for k, v in rows["traced"].items() if k != "scale_ops"}))
    rows["tools"] = phase_host_tools(tools, log_dir)
    rows["wall_s"] = time.perf_counter() - t_phase
    log(f"[cluster] phase passed in {rows['wall_s']:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 7b: granite-8b's decode step at 32k contexts, int8 against bf16
# ---------------------------------------------------------------------------


LONG_CTX = 32768  # tokens held per slot: the §Perf C3 decode_32k shape cut to one card
LONG_RUNS = ((8, True), (8, False), (16, True))  # (slots, kv_quant); 16 x 32k bf16 does not fit


def _fill_long(torch, TF, kvcache, eng, seed: int) -> float:
    """Fill every slot of every layer's cache to LONG_CTX tokens by
    kvcache.write_prompt_kv from seeded normal K/V (bf16, std 1; no prefill
    runs), 4 slots of one layer at a time to bound the quantizer's f32
    temporaries; every slot live, the last tokens seeded.  Returns the
    seconds it took."""
    t0 = time.perf_counter()
    cfg = eng.cfg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (4, LONG_CTX, cfg.n_kv_heads, cfg.resolved_head_dim)
    lengths = torch.full((4,), LONG_CTX, dtype=torch.int32, device="cuda")
    for i in range(cfg.n_layers):
        layer = TF.layer_slice(eng.caches["layers"], i)
        for lo in range(0, eng.n_slots, 4):
            k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
                    for _ in range(2))
            kvcache.write_prompt_kv({n: t[lo:lo + 4] for n, t in layer.items()}, k, v, lengths)
            del k, v
    eng.last_tokens.copy_(torch.randint(0, cfg.vocab_size, (eng.n_slots,), generator=gen,
                                        device="cuda", dtype=torch.int32))
    eng.slot_live.fill_(True)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _long_kernel_check(torch, ops, TF, eng, seed: int, tag: str) -> dict:
    """ops.decode_attention on layer 0's filled cache, as the model calls
    it, against ref.decode_attention_ref on the same tensors: for q of std
    1 and of std 3, max|err| within the bf16 tolerance by ``max_err``, and
    also within it times the output's largest magnitude."""
    from repro_torch.kernels import ref

    cfg = eng.cfg
    layer = TF.layer_slice(eng.caches["layers"], 0)
    kw = {"k_scale": layer.get("k_scale"), "v_scale": layer.get("v_scale")}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    out = {}
    for std in (1.0, 3.0):
        q = (std * torch.randn((eng.n_slots, cfg.n_heads, cfg.resolved_head_dim), generator=gen,
                               device="cuda")).to(torch.bfloat16)
        with ops.uncounted():
            got = ops.decode_attention(q, layer["k"], layer["v"], layer["lengths"], impl="kernel", **kw)
        want = ref.decode_attention_ref(q, layer["k"], layer["v"], layer["lengths"], **kw)
        out[f"q_std_{std:g}"] = {"max_abs_err": max_err(torch, got, want, "bf16", scaled=True),
                                 "want_max_abs": float(want.float().abs().max())}
        del got, want
    log(f"[long] {tag}: decode kernel on layer 0's cache against its plain version "
        + json.dumps(out))
    return out


def phase_long_context(torch, np, ops, TF, kvcache, cfg, params, engine_mod, log_dir) -> dict:
    """granite-8b at full width and depth, its engine's captured decode step
    at contexts of LONG_CTX tokens: 8 slots with the int8 cache and with
    bf16, and 16 slots with int8 (about 40 GB of cache, where bf16 would
    need 77.5 GB beside 16.5 GB of weights).  Each cache is freed before
    the next is built.  Per run: the first step's tokens equal the eager
    step's from the same state; the captured step on the wall clock (median
    of 8) and profiled (3 steps); its byte bound (the cache's valid rows,
    scales included, and every weight, once a step, at 3.35 TB/s); the
    decode kernel's launches over the timed steps (L a step, counted) and in
    the profiled window (3L, recorded: ``check_launched``); peak memory.
    Before the steps, the decode kernel on layer 0's filled cache (the
    tensors the steps read) against its plain version, for q of std 1 (a
    near-flat softmax over 32k rows: outputs near 32768**-0.5, so the error
    is also held to the tolerance times the output's largest magnitude)
    and of std 3 (a softmax peaked on a few rows)."""
    from repro_torch.training.optimizer import tree_leaves

    t_phase = time.perf_counter()
    L = cfg.n_layers
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    rows, int8_launches = {}, 0
    for slots, quant in LONG_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tag = f"{slots} slots {'int8' if quant else 'bf16'}"
        eng = engine_mod.InstanceEngine(cfg.replace(kv_quant=quant), params, n_slots=slots,
                                        max_seq=LONG_CTX + 64)
        # no admission fills these slots: captured now, while all are free
        eng._capture()
        cache_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(eng.caches))
        fill_s = _fill_long(torch, TF, kvcache, eng, SEED + 20 + slots)
        log(f"[long] {tag}: caches filled to {LONG_CTX} tokens from seeded random K/V by "
            f"write_prompt_kv in {fill_s:.1f} s ({cache_bytes / 1e9:.2f} GB of cache)")
        kernel_check = _long_kernel_check(torch, ops, TF, eng, SEED + 40 + slots, tag)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()  # the peak below is the steps', not the check's
        # the first step, captured and eager, from one state: lengths and
        # last tokens put back between (each rewrites the same K/V entry)
        lens = [c["lengths"] for c in (eng.caches["layers"],)]
        saved = [t.clone() for t in lens] + [eng.last_tokens.clone()]
        eng._decode()
        got = eng.last_tokens.tolist()
        for t, old in zip(lens + [eng.last_tokens], saved):
            t.copy_(old)
        eng._decode_all()
        want = eng.last_tokens.tolist()
        check(got == want, f"long {tag}: captured tokens {got} != eager {want}")
        check(all(0 <= t < cfg.vocab_size for t in got), f"long {tag}: tokens {got}")

        def step():
            eng._decode()
            eng.last_tokens.tolist()

        ops.reset_launch_counts()
        wall = _wall_ms(step)
        launches = ops.launch_counts()["decode_attention"]
        check(launches == 8 * L, f"long {tag}: {launches} decode launches in 8 steps, not {8 * L}")
        if quant:
            int8_launches += launches
        # the int8 cache under granite's bf16 q runs the tensor-core route
        kernel = "decode_int8_mma_kernel" if quant else "decode_attention_kernel"
        prof = _step_row(torch, step, 3, wall, log_dir, f"long_{slots}_{'int8' if quant else 'bf16'}_trace.json",
                         expect=(kernel, L))
        kernels = prof.pop("_kernels")
        decode_ms = sum(us for us, k, _ in kernels if kernel in k) / 3e3
        # bytes a profiled step must move: every weight once, and each valid
        # cache row (K and V, and their scales in int8) of every layer; the
        # 3 profiled steps read length + 1, + 2, + 3 rows
        length = int(eng.caches["layers"]["lengths"][0, 0]) - 3
        es = 1 if quant else 2
        row_bytes = L * cfg.n_kv_heads * (2 * cfg.resolved_head_dim * es + (8 if quant else 0))
        nbytes = weight_bytes + slots * (length + 2) * row_bytes
        rows[tag] = {
            "slots": slots, "kv_quant": quant, "context": LONG_CTX, "cache_gb": cache_bytes / 1e9,
            "weights_gb": weight_bytes / 1e9, "fill_s": fill_s, "tokens_equal_to_eager": True,
            "kernel_vs_plain": kernel_check,
            **prof, "decode_attention_device_ms": decode_ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "decode_launches_8_steps": launches,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        }
        log(f"[long] {tag} " + json.dumps(rows[tag]))
        del eng
    gc.collect()
    torch.cuda.empty_cache()
    rows["int8_decode_launches"] = int8_launches
    rows["wall_s"] = time.perf_counter() - t_phase
    log(f"[long] phase passed in {rows['wall_s']:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 8: the MaaS fleet (--maas) serving three full-width models
# ---------------------------------------------------------------------------


def _instrument_tenant(tenant, ops, seen: dict) -> None:
    """Record every engine the tenant's runtime builds, each engine's
    prefills, and the kernel launches made inside the runtime's ticks (all of
    the tenant's compute runs there)."""
    rt = tenant.runtime
    rec = seen[tenant.name] = {"engines": [], "prefills": [0], "launches": dict.fromkeys(ops.KERNELS, 0)}

    def track(eng):
        fn = eng.prefill_only

        def prefill_only(req):
            rec["prefills"][0] += 1
            return fn(req)

        eng.prefill_only = prefill_only
        rec["engines"].append(eng)
        return eng

    for pe in rt.pool.all():
        track(pe.engine)
    new_engine, tick = rt._new_engine, rt.tick
    rt._new_engine = lambda: track(new_engine())

    def counted_tick(now):
        before = ops.launch_counts()
        out = tick(now)
        for k, v in ops.launch_counts().items():
            rec["launches"][k] += v - before[k]
        return out

    rt.tick = counted_tick


def phase_maas(torch, np, ops, TF, cfgs: dict, params: dict, serve, maas, disagg) -> dict:
    n_req, prompt_len, new_tokens, n_slots = 24, 128, 16, 4
    max_seq = prompt_len + new_tokens + 8
    archs = list(cfgs)
    args = serve.build_parser().parse_args([
        "--maas", "--models", ",".join(archs), "--requests", str(n_req),
        "--prompt-len", str(prompt_len), "--gen-len", str(new_tokens), "--n-slots", str(n_slots),
        "--seed", str(SEED), "--device", "cuda"])
    seen: dict = {}
    add_model = maas.FleetScheduler.add_model

    def instrumented_add_model(self, cfg, p, **kw):
        tenant = add_model(self, cfg, p, **kw)
        _instrument_tenant(tenant, ops, seen)
        return tenant

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    maas.FleetScheduler.add_model = instrumented_add_model
    t0 = time.perf_counter()
    try:
        fleet = serve.run_maas(args, cfgs, params)
    except SystemExit as e:
        raise SmokeFailure(f"maas: {e}") from None
    finally:
        maas.FleetScheduler.add_model = add_model
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = ops.launch_counts()

    s = fleet.stats
    check(fleet.n_outstanding == 0, f"maas: {fleet.n_outstanding} requests outstanding")
    check(fleet.param_pool.invariant_ok(), "maas: parameter pool invariant broken at the end")
    check(s.scale_to_zero_events >= 1 and s.cold_starts >= 1,
          f"maas: {s.scale_to_zero_events} scale-to-zero events, {s.cold_starts} cold starts")
    by_cfg = {cfgs[a].name: a for a in archs}
    check(sorted(fleet.tenants) == sorted(by_cfg), f"maas: tenants {sorted(fleet.tenants)}")
    served = 0
    tenants = {}
    for name, t in fleet.tenants.items():
        arch, cfg, rt, rec = by_cfg[name], t.runtime.cfg, t.runtime, seen[name]
        L, n = cfg.n_layers, len(rt.completed)
        served += n
        check(n >= 1, f"maas {name}: served no request")
        handoffs, gapped = rt.router.handoff_report()
        check(gapped == 0 and rt.n_outstanding == 0, f"maas {name}: {gapped} gapped, {rt.n_outstanding} outstanding")
        for r in rt.completed.values():
            check(len(r.out_tokens) == new_tokens and all(0 <= x < cfg.vocab_size for x in r.out_tokens),
                  f"maas {name}: request {r.rid} has tokens {r.out_tokens}")
        check(all(e.params is params[arch] for e in rec["engines"]),
              f"maas {name}: an engine does not hold the model's one parameter dict")
        prefills, steps = rec["prefills"][0], sum(e.steps for e in rec["engines"])
        want = path_launches(cfg, prefills, steps)
        check(rec["launches"] == want, f"maas {name}: launch counts {rec['launches']} != the path's {want}")
        check(prefills >= n and steps > 0, f"maas {name}: {prefills} prefills, {steps} steps for {n} requests")
        payload = disagg.payload_bytes(TF.init_caches(cfg, 1, max_seq, device="cuda"), prompt_len, max_seq)
        check(rt.stats.migrated_bytes == rt.stats.migrations * payload and rt.stats.migrations >= n,
              f"maas {name}: migrated {rt.stats.migrated_bytes} bytes in {rt.stats.migrations} "
              f"migrations, payload {payload}")
        tenants[name] = {
            "attn": cfg.attn, "layers": L, "served": n, "prefills": prefills, "decode_steps": steps,
            "engines_built": len(rec["engines"]), "handoffs": handoffs,
            **(_router_times(np, rt.router)),
            "cold_starts": rt.stats.cold_starts, "cold_starts_from_host": rt.stats.cold_starts_from_host,
            "scaled_to_zero": t.stats.scaled_to_zero, "preempted": t.stats.preempted,
            "gpu_seconds": t.stats.gpu_seconds, "migrations": rt.stats.migrations,
            "payload_bytes_each": payload, "state_at_end": t.state, "launches": rec["launches"],
        }
        log(f"[maas] {name} " + json.dumps(tenants[name]))
    check(served == n_req, f"maas: {served} of {n_req} requests served")
    summed = {k: sum(r["launches"][k] for r in seen.values()) for k in total}
    check(summed == total, f"maas: per-tenant launches {summed} != the run's {total}")
    check(all(total[k] > 0 for k in FWD_KERNELS), f"maas: a kernel was not launched: {total}")
    row = {
        "requests": n_req, "prompt_tokens": prompt_len, "new_tokens": new_tokens, "wall_s": wall,
        "grants": s.grants, "cold_starts": s.cold_starts, "scale_to_zero_events": s.scale_to_zero_events,
        "preemptions": s.preemptions, "rejections": s.rejections, "fleet_gpu_seconds": s.gpu_seconds,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": total,
        "tenants": tenants,
    }
    log("[maas] fleet " + json.dumps({k: v for k, v in row.items() if k != "tenants"}))
    del fleet
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Phase 9: the MoE, SSM and hybrid families at full width
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("olmoe-1b-7b", "mamba2-370m", "zamba2-2.7b")


def _family_args(serve, arch: str, *extra: str):
    return serve.build_parser().parse_args(
        ["--arch", arch, "--prompt-len", "512", "--gen-len", "32", "--n-slots", "4",
         "--seed", str(SEED), "--device", "cuda", *extra])


def _family_serve(torch, ops, arch, cfg, params, serve, whole: bool = True) -> dict:
    """(b) the CLI's colocated loop: 8 requests of 512 + 32 tokens on 4
    slots (16 for a model at full depth); every request finishes and the
    launches are exactly the path's.  With ``whole`` (a model at full
    depth) the loop must also outlast the modelled load, so that the
    live-scaled engine ends holding every layer: on captured decode steps 8
    requests of olmoe-1b-7b end before the flow model has moved its 13.8
    GB, so a whole model serves 16.  A depth cut computes its 8 requests
    before the flow model has moved its bytes (grok-1's 2-layer cut: ~0.7 s
    against 1.8 s for 23 GB), and its scaled engine's layers are only
    reported."""
    n = 16 if whole else 8
    args = _family_args(serve, arch, "--requests", str(n))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.run_colocated(args, cfg, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    eng0, eng1 = out["engines"]
    steps = eng0.steps + eng1.steps
    want = path_launches(cfg, n, steps)
    check(counts == want, f"families {cfg.name} serve: launch counts {counts} != the path's {want}")
    check(all(counts[k] > 0 for k, v in want.items() if v > 0),
          f"families {cfg.name} serve: a kernel of the path was not launched: {counts}")
    check(eng0.params is params and eng1.params is params,
          f"families {cfg.name} serve: an engine copied the params")
    check(len(out["finished"]) == n, f"families {cfg.name} serve: {len(out['finished'])} of {n} finished")
    for r in out["finished"]:
        check(len(r.out_tokens) == args.gen_len and all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"families {cfg.name} serve: request {r.rid} has tokens {r.out_tokens}")
    check(not whole or eng1.loaded_layers == cfg.n_layers,
          f"families {cfg.name} serve: the scaled engine is not whole")
    return {"requests": n, "wall_s": wall, "tokens_per_s": n * args.gen_len / wall,
            "engine_steps": [eng0.steps, eng1.steps], "scaled_engine_layers": eng1.loaded_layers,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": counts}


def _serve_timing(torch, name: str, prefill_one, start, step, log_dir, eager=None) -> dict:
    """Idle one-prompt prefill (TTFT: ``prefill_one(i)`` for i in 0..2, each
    ending in a host read) and, after ``start()`` has filled the 4 slots,
    the full-batch decode ``step()`` (the captured one) on the wall clock;
    then torch.profiler over 3 of those steps: device time per step, the
    card's busy share of the step and the host's launch calls.  The same
    for the ``eager`` step, under ``"eager"``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ttft = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill_one(i)
        ttft.append((time.perf_counter() - t0) * 1e3)
    start()
    rows = {}
    for mode, fn in (("captured", step), ("eager", eager)):
        if fn is not None:
            rows[mode] = _step_row(torch, fn, 3, _wall_ms(fn), log_dir, f"{name}_{mode}_decode_trace.json")
            rows[mode].pop("_kernels")
    cap = rows["captured"]
    med = cap["wall_ms"]
    return {"ttft_idle_ms": sorted(ttft)[1], "decode_step_ms_median": med,
            "decode_tokens_per_s": 4 / (med / 1e3), "decode_device_ms": cap["device_ms"],
            "device_busy_share": cap["device_busy_share"], "profiled_wall_ms": cap["profiled_wall_ms"],
            "kernels_launched": cap["kernels_launched"], "host_launch_calls": cap["host_launch_calls"],
            "top_kernels_ms": cap["top_kernels_ms"], "eager": rows.get("eager"),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def _family_timing(torch, np, cfg, params, engine_mod, log_dir) -> dict:
    """_serve_timing on the engine: 512-token prompts, 4 slots at 512 + ~10
    tokens."""
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(0, cfg.vocab_size, 512).astype(np.int32) for _ in range(4)]
    eng = engine_mod.InstanceEngine(cfg, params, n_slots=4, max_seq=552)

    def prefill_one(i):
        eng.prefill_only(engine_mod.ServeRequest(-1 - i, prompts[i], 1))

    def start():
        for i, p in enumerate(prompts):
            eng.submit(engine_mod.ServeRequest(i, p, 32))
        eng.step()  # admits all four
        check(len(eng.active) == 4, f"families {cfg.name} timing: {len(eng.active)} slots live")

    return _serve_timing(torch, cfg.name, prefill_one, start, eng.step, log_dir, eager_step(eng))


def phase_families(torch, np, ops, TF, get_config, live, serve, disagg, engine_mod, log_dir) -> dict:
    """Phase 9: olmoe-1b-7b (MoE), mamba2-370m (SSM) and zamba2-2.7b (hybrid)
    at full width, one at a time: (a) kernel path against plain path cut to
    2 layers (zamba2 to 6, one shared-block site); (b) the colocated CLI
    loop at full depth; the idle prefill and decode step times with a
    profile; (c) the live split; (d) for zamba2, --disagg."""
    t_phase = time.perf_counter()
    rows = {}
    for i, arch in enumerate(FAMILY_ARCHS):
        cfg = get_config(arch)
        row = {"parity": phase_parity(torch, np, ops, TF, cfg,
                                      n_layers=cfg.attn_every if cfg.family == "hybrid" else 2)}
        t0 = time.perf_counter()
        params = TF.init_params(cfg, SEED + 5 + i, device="cuda")
        torch.cuda.synchronize()
        row["params"] = cfg.approx_params()
        row["init_s"] = time.perf_counter() - t0
        row["serve"] = _family_serve(torch, ops, arch, cfg, params, serve)
        log(f"[families] {arch} serve " + json.dumps(row["serve"]))
        row["timing"] = _family_timing(torch, np, cfg, params, engine_mod, log_dir)
        log(f"[families] {arch} timing " + json.dumps(row["timing"]))
        row["live"] = phase_live(torch, np, ops, TF, live, cfg, params)
        if cfg.family == "hybrid":  # (d): SSM states and shared-block caches migrate
            args = _family_args(serve, arch, "--disagg", "--requests", "12", "--n-prefill", "2",
                                "--n-decode", "1")
            row["disagg"] = _checked_disagg(torch, np, ops, TF, cfg, params, serve, disagg, args,
                                            f"families {arch} disagg")
            log(f"[families] {arch} disagg " + json.dumps(row["disagg"]))
        del params
        gc.collect()
        torch.cuda.empty_cache()
        rows[arch] = row
    rows["wall_s"] = time.perf_counter() - t_phase
    log(f"[families] phase passed in {rows['wall_s']:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 10: the last four reference configs at full width
# ---------------------------------------------------------------------------

LAST_ARCHS = ("grok-1-314b", "nemotron-4-340b", "whisper-large-v3", "pixtral-12b")
# parity cuts: nemotron's one-layer f32 cut is already 51.5 GB (its embed and
# unembed are 37.7 GB of it); pixtral's prompt holds its 1024 patch frames.
# whisper's weights are rescaled to fan-in (rescale_fan_in_): under the
# reference's init law (std 1/sqrt(n_layers) for every stacked weight, 0.71
# at this cut and 0.18 whole) each of its 1280-wide products multiplies the
# activations by ~25, they reach ~8,500 after one encoder layer, and the two
# paths' f32 rounding grows to a 0.64 logit difference at the 2 + 2 cut and
# 4.1 whole, so their token ids part.  That law is held by WITNESS_CUTS.
PARITY_CUTS = {"grok-1-314b": dict(n_layers=1), "nemotron-4-340b": dict(n_layers=1),
               "whisper-large-v3": dict(n_layers=2, n_enc_layers=2, fan_in=True),
               "pixtral-12b": dict(n_layers=2, prompt_len=1088)}
# phase_f64_witness under the reference's init law: whisper at the parity
# cut and whole
WITNESS_CUTS = {"whisper-large-v3": (dict(n_layers=2, n_enc_layers=2), {})}
# serve depth cuts: 314 B and 340 B parameters are 628 and 680 GB in bf16;
# 2 layers at full width are 23 and 33 GB
SERVE_LAYERS = {"grok-1-314b": 2, "nemotron-4-340b": 2}


def _encdec_serve(torch, np, ops, TF, cfg, params, engine_mod, log_dir) -> dict:
    """whisper at the model API (the engine passes no frames, as the JAX
    engine does): 4 prompts of 512 tokens with 1500 frames each in one
    prefill, then 32 decode steps over the self caches and the static cross
    cache; tokens in range, the cross cache full, launches exactly the
    path's.  Then the idle prefill of one prompt (TTFT, ending in a host
    read) and the 4-row decode step on the wall clock, and torch.profiler
    over 3 steps: the step an engine captures (its caches filled by the
    4-prompt prefill in place, every slot live), beside the same step run
    eagerly."""
    b, prompt_len, steps = 4, 512, 32
    max_seq = prompt_len + steps + 8
    rng = np.random.default_rng(SEED + 6)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(b, prompt_len)).astype(np.int32),
                           device="cuda")
    frames = stub_frames(torch, cfg, b, SEED + 6)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    caches = TF.init_caches(cfg, b, max_seq, device="cuda")
    nxt, caches = TF.prefill(cfg, params, toks, caches, frames)
    out = [nxt]
    for _ in range(steps):
        nxt, caches = TF.decode_step(cfg, params, nxt, caches)
        out.append(nxt)
    ids = torch.stack(out, 1).tolist()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = path_launches(cfg, 1, steps)
    check(counts == want, f"last {cfg.name} serve: launch counts {counts} != the path's {want}")
    check(all(0 <= t < cfg.vocab_size for row in ids for t in row) and len(ids[0]) == steps + 1,
          f"last {cfg.name} serve: tokens {ids}")
    cross = caches["cross"]
    check(cross["lengths"].tolist() == [cfg.n_frontend_tokens] * b
          and bool(torch.isfinite(cross["k"]).all()), f"last {cfg.name} serve: cross cache")
    check(caches["layers"]["lengths"].tolist() == [[prompt_len + steps] * b] * cfg.n_layers,
          f"last {cfg.name} serve: self-cache lengths")
    row = {"requests": b, "prompt_tokens": prompt_len, "frames": cfg.n_frontend_tokens,
           "new_tokens": steps + 1, "wall_s": wall, "tokens_per_s": b * (steps + 1) / wall,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": counts}
    del caches

    eng = engine_mod.InstanceEngine(cfg, params, n_slots=b, max_seq=max_seq)
    # no admission fills these slots: captured now, while all are free
    eng._capture()

    def prefill_one(i):
        one = TF.init_caches(cfg, 1, max_seq, device="cuda")
        TF.prefill(cfg, params, toks[i:i + 1], one, frames[i:i + 1])[0].tolist()

    def start():
        nxt, _ = TF.prefill(cfg, params, toks, eng.caches, frames)
        eng.last_tokens.copy_(nxt)
        eng.slot_live.fill_(True)

    def step(decode):
        def run():
            decode()
            eng.last_tokens.tolist()
        return run

    row["timing"] = _serve_timing(torch, cfg.name, prefill_one, start, step(eng._decode), log_dir,
                                  step(eng._decode_all))
    return row


def phase_last_configs(torch, np, ops, TF, get_config, live, serve, engine_mod, log_dir) -> dict:
    """Phase 10: grok-1-314b (MoE, n_rep 6), nemotron-4-340b (squared ReLU,
    flash and decode at D = 192, n_rep 12), whisper-large-v3 (enc-dec) and
    pixtral-12b (VLM) at full width, one at a time: (a) kernel path against
    plain path (grok and nemotron cut to 1 layer, whisper to 2 + 2, pixtral
    to 2 at a 1088-token prompt with its 1024 patch frames), and whisper's
    two f32 paths against a float64 run under the reference's init law, cut
    and whole (phase_f64_witness); (b) grok and
    nemotron cut to 2 layers and pixtral whole through the colocated CLI loop
    (text only, as the engine serves it), launches exact, the idle prefill
    and decode step timed and profiled; whisper whole at the model API;
    (c) the live split of pixtral and whisper at k in {0, 1, L/2, L}."""
    t_phase = time.perf_counter()
    rows = {}
    for i, arch in enumerate(LAST_ARCHS):
        cfg = get_config(arch)
        row = {"parity": phase_parity(torch, np, ops, TF, cfg, **PARITY_CUTS[arch])}
        if arch in WITNESS_CUTS:
            row["f64_witness"] = [phase_f64_witness(torch, np, ops, TF, cfg, **c)
                                  for c in WITNESS_CUTS[arch]]
        scfg = cfg.replace(n_layers=SERVE_LAYERS[arch]) if arch in SERVE_LAYERS else cfg
        t0 = time.perf_counter()
        params = TF.init_params(scfg, SEED + 10 + i, device="cuda")
        torch.cuda.synchronize()
        row.update(params=scfg.approx_params(), full_params=cfg.approx_params(),
                   served_layers=scfg.n_layers, init_s=time.perf_counter() - t0)
        if cfg.family == "encdec":
            row["serve"] = _encdec_serve(torch, np, ops, TF, scfg, params, engine_mod, log_dir)
        else:
            row["serve"] = _family_serve(torch, ops, arch, scfg, params, serve,
                                         whole=arch not in SERVE_LAYERS)
            row["timing"] = _family_timing(torch, np, scfg, params, engine_mod, log_dir)
            log(f"[last] {arch} timing " + json.dumps(row["timing"]))
        log(f"[last] {arch} serve " + json.dumps(row["serve"]))
        if cfg.family in ("encdec", "vlm"):
            vlm = cfg.family == "vlm"
            row["live"] = phase_live(torch, np, ops, TF, live, scfg, params, seq=1088 if vlm else 128,
                                     frames=stub_frames(torch, cfg, 1, SEED + 7) if vlm else None)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        rows[arch] = row
    rows["wall_s"] = time.perf_counter() - t_phase
    log(f"[last] phase passed in {rows['wall_s']:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 11: training (the backward kernels, gradient parity, the train loop)
# ---------------------------------------------------------------------------


FWD_KERNELS = ("rmsnorm", "flash_attention", "decode_attention")
BWD_KERNELS = {  # port-only: the TPU side has no backward kernel
    "rmsnorm_bwd": "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
    "flash_attention_bwd": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
}
BWD_TIMED = ("main", "nemotron", "whisper", "whisper-cross")
GRAD_LAYERS = 2  # gradient parity: granite-8b at full width cut to 2 layers
TRAIN_LAYERS = 4  # the train loop: ~1.27 B params; all 36 layers need ~99 GB of state
TRAIN = dict(batch=8, seq=2048, microbatches=2, steps=12, ckpt_at=6)
WITNESS_GRAD_RATIO = 3.0  # a leaf past 3e-5: its distance from the f64 run, at most this x the plain path's
# bf16 under the reference's law: the kernel path's mean distance from the f64
# run at most this x the plain path's (the kernel's bf16 P before PV adds
# rounding the plain path's f32 P has not)
BF16_WITNESS_RATIO = 1.25


def bwd_cases(torch, dt: str):
    """(kernel, case, make_inputs, kw): the backward kernels at the train
    loop's shapes (8192 rows of d = 4096; flash 4 x 2048 x 32/8 x 128,
    causal), nemotron's and whisper's norm widths, whisper's cross-attention
    (512 x 1500, non-causal) and, small, every head dim the kernel takes.
    Flash's inputs carry the forward kernel's output o and log-sum-exp."""
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def rms(n, d):
        return randn(n, d), 1 + 0.3 * randn(d), randn(n, d)

    def flash(b, sq, sk, h, kv, d, causal):
        from repro_torch.kernels import flash_attention as fk

        q, k, v, do = randn(b, sq, h, d), randn(b, sk, kv, d), randn(b, sk, kv, d), randn(b, sq, h, d)
        o, lse = fk.flash_attention(q, k, v, causal=causal, return_lse=True)
        return q, k, v, o, do, lse

    cases = [
        ("rmsnorm_bwd", "main N=8192 d=4096", lambda: rms(8192, 4096), {}),
        ("rmsnorm_bwd", "nemotron N=8192 d=18432", lambda: rms(8192, 18432), {}),
        ("rmsnorm_bwd", "whisper N=8192 d=1280", lambda: rms(8192, 1280), {}),
        ("flash_attention_bwd", "main B=4 S=2048 H=32 KV=8 D=128 causal",
         lambda: flash(4, 2048, 2048, 32, 8, 128, True), {"causal": True}),
        ("flash_attention_bwd", "whisper-cross B=1 Sq=512 Sk=1500 H=20 KV=20 D=64 non-causal",
         lambda: flash(1, 512, 1500, 20, 20, 64, False), {"causal": False}),
    ]
    for d in (16, 24, 32, 64, 80, 96, 128, 192):
        cases.append(("flash_attention_bwd", f"D={d} B=2 S=200 H=8 KV=2 causal",
                      lambda d=d: flash(2, 200, 200, 8, 2, d, True), {"causal": True}))
    return cases


def bwd_work(name: str, inputs, kw, dt: str) -> tuple[float, float]:
    """(bytes, flops) of a backward call on these inputs: each input read and
    each output written once (flash: q, k, v, o, do, the f32 lse; dq, dk,
    dv); flash's operations 2.5x the forward's (4 D per query-key pair, the
    causal pairs counted as these shapes have them at the call's offset)."""
    es = 2 if dt == "bf16" else 4
    if name == "rmsnorm_bwd":
        x, w, _ = inputs
        n, d = x.numel() // x.shape[-1], x.shape[-1]
        return (3 * n * d + 2 * d) * es, 12 * n * d
    q, k = inputs[0], inputs[1]
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    off = kw.get("q_offset", 0)  # row i is position off + i
    pairs = sum(min(off + i + 1, sk) for i in range(sq)) if kw.get("causal", True) else sq * sk
    return ((4 * b * sq * h * d + 4 * b * sk * kv * d) * es + 4 * b * h * sq,
            2.5 * 4 * b * h * d * pairs)


def bwd_library_call(torch, name: str, kw, inputs=None):
    """One PyTorch autograd call computing the same gradients (forward and
    backward; its forward alone is timed apart and taken off): F.rms_norm
    and SDPA (a causal call at a query offset with the offset as a mask, as
    ``library_call``; ``inputs`` give its shape), timed only, never used by
    the port."""
    F = torch.nn.functional
    if name == "rmsnorm_bwd":
        def fwd(x, w):
            return F.rms_norm(x, (x.shape[-1],), w, 1e-5)

        def fwd_bwd(x, w, g):
            x, w = x.detach().requires_grad_(), w.detach().requires_grad_()
            return torch.autograd.grad(fwd(x, w), (x, w), g)

        return (lambda x, w, g: fwd(x, w)), fwd_bwd

    causal, off = kw.get("causal", True), kw.get("q_offset", 0)
    mask = None
    if causal and off:
        sq, sk = inputs[0].shape[1], inputs[1].shape[1]
        mask = (torch.arange(sq, device="cuda")[:, None] + off
                >= torch.arange(sk, device="cuda")[None, :])

    def fwd(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            is_causal=causal and not off, enable_gqa=True)

    def fwd_bwd(q, k, v, o, do, lse):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        return torch.autograd.grad(fwd(q, k, v), (q, k, v), do.transpose(1, 2))

    return (lambda q, k, v, o, do, lse: fwd(q, k, v)), fwd_bwd


# the bf16 backward's wgmma kernels, one per pass and head dim
BWD_SM90 = [f"flash_bwd_{p}_sm90ILi{d}E" for p in ("dkv", "dq") for d in (16, 32, 64, 80, 96, 128, 192)]
# the f32 backward's FMA kernel (both passes, one launch), one per head dim
BWD_FMA = [f"flash_bwd_fmaILi{d}E" for d in (16, 32, 64, 80, 96, 128, 192)]
# rmsnorm_bwd's rows kernel per dtype: the ring at 1, 2 and 4 rows a step and
# the scalar path; and its column sum
RMS_BWD = [f"rmsnorm_bwd_rowsI{t}Li{v}ELb1ELi{r}EE" for t, v in (("f", 4), ("13__nv_bfloat16", 8))
           for r in (1, 2, 4)] + [
    "rmsnorm_bwd_rowsIfLi1ELb0ELi1EE", "rmsnorm_bwd_rowsI13__nv_bfloat16Li1ELb0ELi1EE",
    "rmsnorm_bwd_colsumIfE", "rmsnorm_bwd_colsumI13__nv_bfloat16E"]


def _ptxas_report(log_text: str) -> dict:
    """Mangled kernel name -> registers, static shared bytes, stack and
    spills, from ptxas -v."""
    import re

    kernels, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            kernels[name] = {}
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            kernels[name]["registers"] = int(m.group(1))
            if sm := re.search(r"(\d+) bytes smem", line):
                kernels[name]["static_smem"] = int(sm.group(1))
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            kernels[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
    return kernels


def bwd_build_report() -> dict:
    """Both backward libraries as built: every bf16 flash pass at every head
    dim must hold HGMMA (wgmma) in its SASS; every instantiation of both
    libraries (the bf16 passes, the f32 FMA kernel at every head dim,
    rmsnorm_bwd's rows and column-sum kernels) must be there and spill
    nothing.  Logged per instantiation: ptxas's registers, static shared
    memory, stack and spills, the f32 kernel's dynamic shared memory, and
    whether ptxas serialized a kernel's wgmma (its C7520 note)."""
    import ctypes
    import re

    from repro_torch.kernels import _build

    kernels, wanted = {}, {}
    for lib_name, want in (("flash_attention_bwd", BWD_SM90 + BWD_FMA), ("rmsnorm_bwd", RMS_BWD)):
        found = _ptxas_report(_build.log_path(lib_name).read_text())
        for w in want:
            hits = [k for k in found if w in k]
            check(len(hits) == 1, f"{lib_name}: no single ptxas report of {w}: {hits}")
            wanted[hits[0]] = w
        kernels.update(found)
    for k, v in kernels.items():
        check("registers" in v and v.get("spill_stores", 0) == 0 and v.get("spill_loads", 0) == 0,
              f"backward kernel {k} spills registers: {v}")
    log_text = _build.log_path("flash_attention_bwd").read_text()
    serialized = set(re.findall(r"wgmma.mma_async instructions are serialized.* in the function '(\S+)'", log_text))
    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.lib_path("flash_attention_bwd"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    hgmma, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            hgmma[fn] = 0
        elif fn and "HGMMA" in line:
            hgmma[fn] += 1
    for want in BWD_SM90:
        got = [f for f in hgmma if want in f]
        check(len(got) == 1 and hgmma[got[0]] > 0, f"flash backward: {want} has no HGMMA in its SASS: {got}")
    smem_of = _build.function("flash_attention_bwd", "flash_attention_bwd_f32_smem", [ctypes.c_int])
    rows = {}  # short name (flash_bwd_fma<Li128>) -> ptxas's report, + HGMMA count
    for k, v in kernels.items():
        m = re.search(r"(flash_bwd_[a-z0-9_]+?|rmsnorm_bwd_(?:rows|colsum))I(\w+?)E(?:v|E)", k)
        short = f"{m.group(1)}<{m.group(2)}>" if m else k
        row = {**v, "hgmma": next((n for f, n in hgmma.items() if k in f), 0),
               "wgmma_serialized": k in serialized}
        if (d := re.fullmatch(r"flash_bwd_fmaILi(\d+)E", wanted.get(k, ""))):
            row["dynamic_smem"] = smem_of(int(d.group(1)))
        rows[short] = row
    log("[train] backward kernels' SASS and ptxas " + json.dumps(rows))
    return rows


def _bwd_kernel_ms(kernels: list) -> dict:
    """Short backward-kernel name -> mean device ms of its launches in
    _traced's kernels.  The mean is over the launches the trace holds: late
    in a long process the profiler has been seen to record only some of a
    short window's launches.  rmsnorm_bwd's column sum is a programmatic
    dependent launch, so its span includes its wait for the rows kernel."""
    import re

    tot = {}
    for us, key, n in kernels:
        if m := re.search(r"((?:flash|rmsnorm)_bwd_[a-z0-9_]+)", key):
            t = tot.setdefault(m.group(1), [0.0, 0])
            t[0] += us
            t[1] += n
    return {k: us / (n * 1e3) for k, (us, n) in tot.items()}


def grads_err(torch, got, want, dt: str) -> float:
    """The largest |got - want| over a backward's gradients; raises unless
    each is within dt's tolerance of its largest magnitude (a summed
    gradient: dw, dk and dv over the sequence)."""
    errs = []
    for g, w in zip(got, want):
        sc = max(1.0, float(w.float().abs().max()))
        max_err(torch, g / sc, w / sc, dt)
        errs.append(float((g.float() - w.float()).abs().max()))
    return max(errs)


def launch_split(torch, fn, iters: int = 10) -> dict:
    """Device ms per launch of each kernel that ``fn()`` launches, from a
    torch.profiler trace of ``iters`` calls (short kernel name -> ms)."""
    kernels, _, _, _ = _traced(torch, lambda: [fn() for _ in range(iters)], iters, None, "")
    return _bwd_kernel_ms(kernels)


def phase_bwd_kernels(torch, ops, ref) -> dict:
    """11a: each backward kernel against its plain version (bf16 2e-2, f32
    3e-5 of the value, tests/test_kernels.py:16-17), two runs bit-equal, the
    timed cases beside their bound, the plain version and the library's
    forward + backward less its forward."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rmsnorm as rk

    kernel_fn = {"rmsnorm_bwd": rk.fused_rmsnorm_bwd, "flash_attention_bwd": fk.flash_attention_bwd}
    plain_fn = {"rmsnorm_bwd": ref.rmsnorm_bwd_ref, "flash_attention_bwd": ref.flash_attention_bwd_ref}
    results = {}
    for dt in ("bf16", "f32"):
        for name, case, make, kw in bwd_cases(torch, dt):
            inputs = make()
            got = kernel_fn[name](*inputs, **kw)
            again = kernel_fn[name](*inputs, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} {case} {dt}: two runs differ (not deterministic)")
            want = plain_fn[name](*inputs, **kw)
            err = grads_err(torch, got, want, dt)
            row = {"kernel": name, "case": case, "dtype": dt, "max_abs_err": err, "deterministic": True}
            tag = case.split()[0]
            if tag in BWD_TIMED:
                nbytes, flops = bwd_work(name, inputs, kw, dt)
                lib_fwd, lib_fwd_bwd = bwd_library_call(torch, name, kw)
                iters = 10 if nbytes > L2_BYTES or flops > 1e11 else 30
                times = time_ms(torch, {
                    "plain": lambda *a: plain_fn[name](*a, **kw),
                    "kernel": lambda *a: kernel_fn[name](*a, **kw),
                    "library": lib_fwd_bwd, "library_fwd": lib_fwd,
                }, [inputs], iters=iters)
                row.update(ms=times["kernel"], plain_ms=times["plain"],
                           library_ms=times["library"] - times["library_fwd"],
                           library_fwd_bwd_ms=times["library"], bytes=nbytes, flops=flops, iters=iters)
                row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dt)
                # the time by launch: flash's delta and passes, rmsnorm's rows and column sum
                row["launch_ms"] = launch_split(torch, lambda: kernel_fn[name](*inputs, **kw))
                if name == "rmsnorm_bwd":
                    x = inputs[0]
                    row["plan"] = rk.bwd_plan(x.numel() // x.shape[-1], x.shape[-1], x.element_size(), True)
                    if "rmsnorm_bwd_rows" in row["launch_ms"]:  # the column sum's own share of a call
                        row["colsum_own_ms"] = row["ms"] - row["launch_ms"]["rmsnorm_bwd_rows"]
                results[(name, dt) if tag == "main" else (name, dt, tag)] = row
            log("[train] kernels " + json.dumps(row))
            del inputs, got, again, want
    torch.cuda.empty_cache()
    return results


def _loss_and_grads(torch, ops, TF, cfg, params, tokens, labels, impl: str):
    """lm_loss and its gradient per leaf (by path) on ``impl``."""
    from repro_torch.training.optimizer import tree_paths

    def alias(t):
        return {k: alias(v) for k, v in t.items()} if isinstance(t, dict) else t.detach().requires_grad_()

    ap = alias(params)
    paths, leaves = zip(*tree_paths(ap))
    with ops.use_impl(impl):
        loss = TF.lm_loss(cfg, ap, tokens, labels)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(paths, grads))


def phase_grad_parity(torch, np, ops, TF, base_cfg) -> dict:
    """11b: lm_loss and every gradient leaf of granite-8b at full width, cut
    to 2 layers, on one 512-token sequence (labels: the next tokens, every
    8th -100), the kernel path against the plain path, on two draws of the
    weights.  Fan-in (every stacked weight at std 1/sqrt(d_model), as
    phase 10 draws whisper's): f32 every leaf within 3e-5 of its largest
    magnitude and the loss within 3e-5; bf16 the kernel path's mean
    relative error against the f32 plain run at most 1.05x the plain
    path's.  The reference's law (std 1/sqrt(2) for a 2-layer cut): q and k
    come out ~45 a component, the attention logits run to the thousands and
    the softmax saturates, so either path's gradient through it is mostly
    rounding noise; there a float64 run of the plain path witnesses both
    dtypes: an f32 leaf past 3e-5 of the plain path's may be no farther
    from it than WITNESS_GRAD_RATIO x the plain path, and the bf16 kernel
    path's mean relative distance from it may be at most BF16_WITNESS_RATIO
    x the plain path's."""
    cfg32 = base_cfg.replace(n_layers=GRAD_LAYERS, dtype=torch.float32)
    rng = np.random.default_rng(SEED + 11)
    seq = rng.integers(0, cfg32.vocab_size, size=(1, 513))
    labels = seq[:, 1:].copy()
    labels[:, ::8] = -100
    tokens = torch.as_tensor(seq[:, :-1].astype(np.int32), device="cuda")
    labels = torch.as_tensor(labels.astype(np.int32), device="cuda")

    def cast(t, dtype):
        return {k: cast(v, dtype) for k, v in t.items()} if isinstance(t, dict) else t.to(dtype)

    def mean_rel(g, base):
        """The mean over the leaves of |g - base| / |base|, each a leaf's mean."""
        return float(np.mean([float((g[k].double() - base[k]).abs().mean()
                                    / base[k].double().abs().mean().clamp_min(1e-30)) for k in base]))

    def f32_run(params, law: str, g64=None):
        lk, gk = _loss_and_grads(torch, ops, TF, cfg32, params, tokens, labels, "kernel")
        lr_, gr = _loss_and_grads(torch, ops, TF, cfg32, params, tokens, labels, "ref")
        check(bool(torch.isfinite(lk)) and all(bool(torch.isfinite(g).all()) for g in gk.values()),
              f"grad parity f32 {law}: loss or gradients not finite")
        check(abs(float(lk) - float(lr_)) <= TOL["f32"] * abs(float(lr_)),
              f"grad parity f32 {law}: loss {float(lk)} vs {float(lr_)}")
        rel = {k: float((gk[k] - gr[k]).abs().max()) / max(float(gr[k].abs().max()), 1e-30) for k in gr}
        row = {"weights": law, "loss_kernel": float(lk), "loss_plain": float(lr_), "leaves": len(rel),
               "max_rel_leaf_err": max(rel.values()), "worst_leaf": max(rel, key=rel.get),
               "rel_leaf_err": rel}
        far = [k for k, r in rel.items() if r > TOL["f32"]]
        if g64 is None:
            check(not far, f"grad parity f32 {law}: leaves past 3e-5 of their scale: "
                           + ", ".join(f"{k} {rel[k]:.3g}" for k in far))
        elif far:
            wit = {}
            for k in far:
                dk_, dr_ = float((gk[k] - g64[k]).abs().max()), float((gr[k] - g64[k]).abs().max())
                wit[k] = {"kernel_vs_f64": dk_, "plain_vs_f64": dr_, "ratio": dk_ / max(dr_, 1e-30)}
                check(dk_ <= WITNESS_GRAD_RATIO * dr_,
                      f"grad parity f32 {law}: leaf {k} {rel[k]:.3g} from the plain path and {dk_} "
                      f"from f64 (plain {dr_})")
            row["f64_witness"] = wit
        log(f"[train] grad parity f32 {law} " + json.dumps({k: v for k, v in row.items() if k != "rel_leaf_err"}))
        del gk
        return row, gr

    def bf16_run(params32, law: str, base, limit: float, against: str):
        p16 = cast(params32, torch.bfloat16)  # every leaf of granite is bf16 in the bf16 model
        cfg16 = cfg32.replace(dtype=torch.bfloat16)
        _, k16 = _loss_and_grads(torch, ops, TF, cfg16, p16, tokens, labels, "kernel")
        _, r16 = _loss_and_grads(torch, ops, TF, cfg16, p16, tokens, labels, "ref")
        row = {"weights": law, "against": against, "kernel_mean_rel_err": mean_rel(k16, base),
               "plain_mean_rel_err": mean_rel(r16, base), "limit_ratio": limit}
        row["ratio"] = row["kernel_mean_rel_err"] / max(row["plain_mean_rel_err"], 1e-30)
        log(f"[train] grad parity bf16 {law} " + json.dumps(row))
        check(row["kernel_mean_rel_err"] <= limit * row["plain_mean_rel_err"],
              f"grad parity bf16 {law}: the kernel path's gradients are {row['ratio']:.3f}x as far "
              f"from the {against} gradients as the plain path's (limit {limit}x)")
        return row

    p32 = TF.init_params(cfg32, SEED, device="cuda")
    _, g64 = _loss_and_grads(torch, ops, TF, cfg32.replace(dtype=torch.float64),
                             cast(p32, torch.float64), tokens, labels, "ref")
    ref_law, _ = f32_run(p32, "reference law", g64=g64)
    ref_law16 = bf16_run(p32, "reference law", g64, BF16_WITNESS_RATIO, "float64")
    del g64
    gc.collect()
    torch.cuda.empty_cache()
    rescale_fan_in_(p32, TF.param_template(cfg32), base_cfg.d_model)
    fan_in, gr = f32_run(p32, "fan-in")
    fan_in16 = bf16_run(p32, "fan-in", gr, 1.05, "f32 plain")
    del p32, gr
    gc.collect()
    torch.cuda.empty_cache()
    return {"f32": fan_in, "f32_reference_law": ref_law, "bf16": fan_in16, "bf16_reference_law": ref_law16}


def train_launches(cfg, microbatches: int) -> dict:
    """Kernel launches of one train step with remat: per microbatch the
    forward (flash L, rmsnorm 2L+1), the recompute of each checkpointed layer
    in the backward (flash L, rmsnorm 2L) and the backward kernels (flash
    L, rmsnorm 2L+1: the final norm is not checkpointed)."""
    L = cfg.n_layers
    return {"rmsnorm": (4 * L + 1) * microbatches, "flash_attention": 2 * L * microbatches,
            "decode_attention": 0, "rmsnorm_bwd": (2 * L + 1) * microbatches,
            "flash_attention_bwd": L * microbatches}


def phase_train_loop(torch, np, ops, TF, base_cfg, train_cli, opt_mod, step_mod, log_dir) -> dict:
    """11c and 11d: run_train on granite-8b at full width cut to 4 layers,
    bf16 weights and f32 moments, 8 x 2048 tokens a step in 2 microbatches:
    (A) 12 steps unbroken, 12 x one step's launches exactly, the loss finite and
    falling; (B) a second run stopped after its checkpoint at step 6 (its
    losses equal A's); (C) a third resuming from that checkpoint, whose
    losses for steps 6-11 equal A's bit for bit.  Then torch.profiler over
    one more step: device time, busy share, tokens/s, model TFLOP/s."""
    cfg = base_cfg.replace(n_layers=TRAIN_LAYERS)
    t = TRAIN
    opt_cfg = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=t["steps"])
    kw = dict(batch=t["batch"], seq=t["seq"], microbatches=t["microbatches"], log_every=1,
              seed=SEED, device="cuda")
    want = train_launches(cfg, t["microbatches"])

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    a = train_cli.run_train(cfg, opt_cfg, steps=t["steps"], **kw)
    wall_a = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    totals = ops.launch_counts()
    check(totals == {k: v * t["steps"] for k, v in want.items()},
          f"train: launch counts {totals} != {t['steps']} steps of the path's {want}")
    check(all(totals[k] > 0 for k in ("rmsnorm", "flash_attention", *BWD_KERNELS)),
          f"train: a kernel of the path was not launched: {totals}")
    losses, grad_norms = a["losses"], a["grad_norms"]
    check(all(math.isfinite(x) for x in losses + grad_norms), f"train: losses {losses}")
    check(losses[-1] < losses[0], f"train: the loss did not fall: {losses}")
    n_params = sum(p.numel() for p in opt_mod.tree_leaves(a["params"]))
    embed = a["params"]["embed"]["tok"].numel()
    step_s = a["step_s"]
    del a
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        t0 = time.perf_counter()
        b = train_cli.run_train(cfg, opt_cfg, steps=t["ckpt_at"], ckpt_dir=ckpt_dir,
                                ckpt_every=t["ckpt_at"], **kw)
        b_s = time.perf_counter() - t0
        check(b["losses"] == losses[: t["ckpt_at"]], f"train: a second run from step 0 gave {b['losses']}")
        del b
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        c = train_cli.run_train(cfg, opt_cfg, steps=t["steps"], ckpt_dir=ckpt_dir,
                                ckpt_every=t["steps"] + 1, **kw)
        c_s = time.perf_counter() - t0
    check(c["start_step"] == t["ckpt_at"], f"train: resumed from step {c['start_step']}")
    check(c["losses"] == losses[t["ckpt_at"]:],
          f"train: resumed losses {c['losses']} != the unbroken run's {losses[t['ckpt_at']:]}")

    # 11d: one more step, profiled
    step_fn = step_mod.build_train_step(cfg, opt_cfg, microbatches=t["microbatches"])
    batch = train_cli._device_batch(cfg, t["batch"], t["seq"], t["steps"], SEED, torch.device("cuda"))
    state = {"p": c["params"], "o": c["opt_state"]}
    del c

    def one_step():
        state["p"], state["o"], m = step_fn(state["p"], state["o"], batch)
        float(m["loss"])

    kernels, prof_ms, host, _ = _traced(torch, one_step, 1, log_dir, "train_step_trace.json")
    device_ms = sum(k[0] for k in kernels) / 1e3
    check(device_ms > 0, "train profile: no device time recorded")
    bwd_split = _bwd_kernel_ms(kernels)  # the backward kernels by launch, at 11a's main shapes
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()

    # model FLOPs of a step: 6 per parameter of the products per token (the
    # embedding gather has none) and attention's 4 D per causal query-key
    # pair, x3 for forward and backward; remat's recompute not counted
    tokens = t["batch"] * t["seq"]
    pairs = t["seq"] * (t["seq"] + 1) // 2
    d_head = cfg.resolved_head_dim
    model_flops = (6 * (n_params - embed) * tokens
                   + 3 * 4 * t["batch"] * cfg.n_heads * d_head * pairs * cfg.n_layers)
    med_ms = sorted(step_s)[len(step_s) // 2] * 1e3
    row = {
        "model": cfg.name, "layers": cfg.n_layers, "params": n_params, "dtype": "bf16",
        "moments": "f32", "batch": t["batch"], "seq": t["seq"], "microbatches": t["microbatches"],
        "steps": t["steps"], "losses": losses, "grad_norms": grad_norms,
        "loss_first": losses[0], "loss_last": losses[-1],
        "launches_per_step": want, "launches_total": totals,
        "step_ms": [x * 1e3 for x in step_s], "step_ms_median": med_ms,
        "tokens_per_s": tokens / (med_ms / 1e3), "model_tflops_per_step": model_flops / 1e12,
        "model_tflop_per_s": model_flops / (med_ms / 1e3) / 1e12,
        "model_flops_share_of_989": model_flops / (med_ms / 1e3) / PEAK_FLOPS["bf16"],
        "peak_mem_gib": peak_gib, "wall_s_unbroken": wall_a, "wall_s_to_checkpoint": b_s,
        "wall_s_resumed": c_s, "resumed_from": t["ckpt_at"], "resumed_losses_equal": True,
        "profile": {"device_ms": device_ms, "profiled_wall_ms": prof_ms, "bwd_launch_ms": bwd_split,
                    "device_busy_share": device_ms / med_ms, "kernels_launched": sum(n for *_, n in kernels),
                    "host_launch_calls": host["launch_calls"],
                    "top_kernels_ms": [[k[:90], round(us / 1e3, 5), n] for us, k, n in kernels[:14]]},
    }
    log("[train] loop " + json.dumps({k: v for k, v in row.items() if k != "profile"}))
    log("[train] profile " + json.dumps(row["profile"]))
    return row


def phase_train(torch, np, ops, ref, TF, get_config, train_cli, opt_mod, step_mod, log_dir) -> dict:
    """Phase 11: 11a the backward kernels, 11b gradient parity, 11c the
    train loop and 11d its profile."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("granite-8b")
    rows = {"build": bwd_build_report(), "kernels": phase_bwd_kernels(torch, ops, ref),
            "grad_parity": phase_grad_parity(torch, np, ops, TF, cfg),
            "loop": phase_train_loop(torch, np, ops, TF, cfg, train_cli, opt_mod, step_mod, log_dir)}
    rows["wall_s"] = time.perf_counter() - t_phase
    log(f"[train] phase passed in {rows['wall_s']:.1f} s")
    return rows


MESH_STEPS = 3  # phase 12a: sharded steps, held to 11c's first three
MESH_TOL = TOL["bf16"]  # relative, on each loss and grad norm
# 12a's sequence-parallel steps: qwen1.5-4b at full width cut to 2 layers,
# "seq" over "model" (its own rules), 11c's batch, against its unsharded steps
MESH_SEQ = dict(arch="qwen1.5-4b", layers=2, steps=2)
DRYRUN_ARCH = "granite-8b"  # phase 12b: its train_4k, prefill_32k, decode_32k on both meshes


def start_dryrun(out_dir: Path):
    """Phase 12b's dry-run in a subprocess on the CPU (a fake process group
    cannot share a process with NCCL), started before the kernels' build so
    that it runs beside nvcc and ends before any phase is timed; one
    thread, no CUDA device."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DRYRUN_ARCH,
           "--mesh", "both", "--out", str(out_dir), "--force"]
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


# phase 7's host tools: each CLI as a user runs it, on the CPU, no JAX
HOST_TOOLS = {
    "report": ["-m", "repro_torch.obs.report", "--sim", "--duration", "20", "--min-attribution", "0.95"],
    "report_scale_ops": ["-m", "repro_torch.obs.report", "--sim", "--duration", "20", "--scale-ops",
                         "--min-makespan-attribution", "0.95"],
    "perfdiff": ["-m", "repro_torch.obs.perfdiff", "benchmarks/baselines/smoke",
                 "benchmarks/baselines/smoke"],
}


def start_host_tools(tools: dict) -> dict:
    """Host CLIs (phase 7's ``HOST_TOOLS``, phase 13's ``EXAMPLE_HOST``) in
    subprocesses, started before the kernels' build beside the dry-run, so
    that they end before any phase is timed; one thread each, no CUDA
    device."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    return {name: subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, argv in tools.items()}


def phase_mesh_train(torch, ops, TF, base_cfg, train_cli, opt_mod, mesh_mod, sh, steps_mod,
                     train_row: dict) -> dict:
    """12a: 3 sharded steps of phase 11c's run on a one-rank NCCL group, held
    to 11c's first three; the step-3 checkpoint restored unsharded."""

    cfg = base_cfg.replace(n_layers=TRAIN_LAYERS)
    t = TRAIN
    opt_cfg = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=t["steps"])  # 11c's
    kw = dict(batch=t["batch"], seq=t["seq"], microbatches=t["microbatches"], log_every=1,
              seed=SEED, device="cuda")
    started = mesh_mod.init_process_group("cuda")
    try:
        mesh = mesh_mod.make_host_mesh()
        rules = steps_mod.make_rules(cfg, mesh)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as ckpt_dir:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            a = train_cli.run_train(cfg, opt_cfg, steps=MESH_STEPS, mesh=mesh, ckpt_dir=ckpt_dir,
                                    ckpt_every=MESH_STEPS, **kw)
            wall = time.perf_counter() - t0
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            counts = ops.launch_counts()
            want = {k: v * MESH_STEPS for k, v in train_launches(cfg, t["microbatches"]).items()}
            check(counts == want, f"mesh: launch counts {counts} != {MESH_STEPS} steps of {want}")
            tmpl = TF.param_template(cfg)
            placed = 0
            for tree in (a["params"], a["opt_state"]["m"], a["opt_state"]["v"]):
                def one(leaf, spec):
                    nonlocal placed
                    pl = sh.placements_for(rules.spec_for_shape(spec.shape, spec.axes), mesh,
                                           spec.shape)
                    check(sh.is_dtensor(leaf) and tuple(leaf.placements) == pl,
                          f"mesh: a leaf {spec.shape} is not a DTensor in {pl}")
                    placed += 1

                sh.map_pair(one, tree, tmpl)
            ref_l, ref_g = train_row["losses"][:MESH_STEPS], train_row["grad_norms"][:MESH_STEPS]
            rel = [abs(x - y) / abs(y) for x, y in zip(a["losses"] + a["grad_norms"], ref_l + ref_g)]
            check(max(rel) <= MESH_TOL, f"mesh: losses {a['losses']} / grad norms "
                  f"{a['grad_norms']} against 11c's {ref_l} / {ref_g}")
            bit_equal = a["losses"] == ref_l and a["grad_norms"] == ref_g
            step_ms = [x * 1e3 for x in a["step_s"]]
            del a
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            b = train_cli.run_train(cfg, opt_cfg, steps=MESH_STEPS + 1, ckpt_dir=ckpt_dir,
                                    ckpt_every=t["steps"] + 1, **kw)
            restore_s = time.perf_counter() - t0
        check(b["start_step"] == MESH_STEPS, f"mesh: the unsharded run resumed at {b['start_step']}")
        check(not sh.is_dtensor(b["params"]["embed"]["tok"]), "mesh: the restored run is sharded")
        resumed = b["losses"][0]
        want_l = train_row["losses"][MESH_STEPS]
        check(abs(resumed - want_l) <= MESH_TOL * abs(want_l),
              f"mesh: the restored run's step {MESH_STEPS} loss {resumed} against 11c's {want_l}")
        del b
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        if started:
            torch.distributed.destroy_process_group()
    row = {"model": cfg.name, "mesh": list(mesh.shape), "steps": MESH_STEPS,
           "launches": counts, "leaves_placed": placed, "max_rel_diff": max(rel),
           "bit_equal": bit_equal, "step_ms": step_ms, "step_ms_median": sorted(step_ms)[len(step_ms) // 2],
           "phase11_step_ms_median": train_row["step_ms_median"], "peak_gib": peak_gib,
           "phase11_peak_gib": train_row["peak_mem_gib"], "wall_s": wall,
           "restored_step_loss": resumed, "phase11_loss": want_l,
           "restored_bit_equal": resumed == want_l, "restore_run_s": restore_s}
    log("[mesh] sharded train " + json.dumps(row))
    return row


def phase_mesh_seq(torch, ops, TF, base_cfg, train_cli, opt_mod, mesh_mod, sh, steps_mod) -> dict:
    """12a, sequence parallel: 2 train steps of qwen1.5-4b at full width cut
    to 2 layers on a one-rank NCCL group, its rules putting "seq" over
    "model": every attention takes ops' DTensor path (``_flash_blocks``)
    with q a local sequence shard, its forward and backward through
    ``_FlashAttention`` (the kernels at offset 0 on one rank).  The loss
    and grad norm of each step within MESH_TOL of the unsharded steps from
    the same seed, and every parameter's update over the steps within
    MESH_TOL of theirs (relative norm, leaf by leaf)."""
    t = TRAIN
    cfg = base_cfg.replace(n_layers=MESH_SEQ["layers"])
    steps = MESH_SEQ["steps"]
    opt_cfg = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=t["steps"])
    kw = dict(batch=t["batch"], seq=t["seq"], microbatches=t["microbatches"], log_every=1,
              seed=SEED, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    start = TF.init_params(cfg, SEED, device="cuda")
    ops.reset_launch_counts()
    plain = train_cli.run_train(cfg, opt_cfg, steps=steps, **kw)
    plain_counts = ops.launch_counts()
    seen = []
    blocks = ops._flash_blocks

    def recorded(q, *a):
        seen.append([str(p) for p in q.placements])
        return blocks(q, *a)

    started = mesh_mod.init_process_group("cuda")
    ops._flash_blocks = recorded
    try:
        mesh = mesh_mod.make_host_mesh()
        rules = steps_mod.make_rules(cfg, mesh)
        check(rules.mesh_axes_for("seq") == ("model",),
              f"mesh seq: 'seq' is over {rules.mesh_axes_for('seq')}")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        a = train_cli.run_train(cfg, opt_cfg, steps=steps, mesh=mesh, **kw)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        got = {k: v.full_tensor() for k, v in opt_mod.tree_paths(a["params"])}
    finally:
        ops._flash_blocks = blocks
        if started:
            torch.distributed.destroy_process_group()
    want_launches = {k: v * steps for k, v in train_launches(cfg, t["microbatches"]).items()}
    check(counts == want_launches == plain_counts,
          f"mesh seq: launches {counts} (unsharded {plain_counts}) != {steps} steps of {want_launches}")
    calls = 2 * cfg.n_layers * t["microbatches"] * steps  # the forward and remat's recompute
    check(len(seen) == calls and all(p[1] == "S(1)" for p in seen),
          f"mesh seq: {len(seen)} flash calls through _flash_blocks (want {calls}), q placed {seen[:2]}")
    rel = [abs(x - y) / abs(y) for x, y in zip(a["losses"] + a["grad_norms"],
                                               plain["losses"] + plain["grad_norms"])]
    check(max(rel) <= MESH_TOL, f"mesh seq: losses {a['losses']} / grad norms {a['grad_norms']} "
          f"against the unsharded {plain['losses']} / {plain['grad_norms']}")
    apart, equal = {}, True
    unsharded = dict(opt_mod.tree_paths(plain["params"]))
    for k, p0 in opt_mod.tree_paths(start):
        w, g = unsharded[k].float(), got[k].float()
        moved = float((w - p0.float()).norm())
        apart[k] = float((g - w).norm()) / moved if moved else float((g - w).norm())
        equal = equal and torch.equal(g, w)
    worst = max(apart, key=apart.get)
    check(apart[worst] <= MESH_TOL, f"mesh seq: {worst}'s update {apart[worst]} from the unsharded one's")
    row = {"model": cfg.name, "layers": cfg.n_layers, "mesh": list(mesh.shape), "steps": steps,
           "q_placements": seen[0], "flash_calls": len(seen), "launches": counts,
           "losses": a["losses"], "unsharded_losses": plain["losses"], "max_rel_diff": max(rel),
           "worst_update_rel": apart[worst], "worst_leaf": worst,
           "bit_equal": equal and a["losses"] == plain["losses"],
           "step_ms": [x * 1e3 for x in a["step_s"]],
           "unsharded_step_ms": [x * 1e3 for x in plain["step_s"]], "wall_s": wall}
    log("[mesh] sequence-parallel train " + json.dumps(row))
    del a, plain, got, start
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_mesh_dryrun(rc: int, out: str, out_dir: Path, log_dir: Path | None) -> dict:
    """12b: the dry-run subprocess's cells (it ended after the build, before
    phase 1): every cell ok."""
    if log_dir is not None:
        (log_dir / "dryrun.log").write_text(out)
    check(rc == 0, f"dryrun: exit {rc}:\n{out[-3000:]}")
    cells = {}
    for path in sorted(out_dir.glob("*.json")):
        rec = json.loads(path.read_text())
        check(rec.get("ok"), f"dryrun: {path.name} failed: {rec.get('error')}")
        gb = (rec["argument_bytes_per_dev"] + rec["temp_bytes_per_dev"]) / 1e9
        cells[f"{rec['shape']} {rec['mesh']}"] = {
            "chips": rec["chips"], "argument_gb": rec["argument_bytes_per_dev"] / 1e9,
            "temp_gb": rec["temp_bytes_per_dev"] / 1e9, "fits_80gb": rec["fits_80gb"],
            "t_compute_ms": rec["t_compute"] * 1e3, "t_memory_ms": rec["t_memory"] * 1e3,
            "t_collective_ms": rec["t_collective"] * 1e3, "bottleneck": rec["bottleneck"],
            "useful_flop_frac": rec["useful_flop_frac"], "run_s": rec["run_s"]}
        log(f"[dryrun] {DRYRUN_ARCH} {rec['shape']} {rec['mesh']} ({rec['chips']} devices): "
            f"{gb:.2f} GB a device, t_compute {rec['t_compute'] * 1e3:.2f} ms, t_memory "
            f"{rec['t_memory'] * 1e3:.2f} ms, t_collective {rec['t_collective'] * 1e3:.2f} ms, "
            f"bottleneck {rec['bottleneck']}")
    check(len(cells) == 6, f"dryrun: {len(cells)} cells, not granite-8b's 3 x 2 meshes")
    return cells


def phase_mesh(torch, ops, TF, get_config, train_cli, opt_mod, train_row, dryrun, log_dir) -> dict:
    """Phase 12: 12a the sharded train step (and the sequence-parallel one),
    12b the dry-run's cells."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps as steps_mod

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rows = {"train": phase_mesh_train(torch, ops, TF, get_config("granite-8b"), train_cli,
                                      opt_mod, mesh_mod, sh, steps_mod, train_row)}
    rows["seq"] = phase_mesh_seq(torch, ops, TF, get_config(MESH_SEQ["arch"]), train_cli, opt_mod,
                                 mesh_mod, sh, steps_mod)
    rows["dryrun"] = phase_mesh_dryrun(*dryrun, log_dir)
    rows["wall_s"] = time.perf_counter() - t_phase
    log(f"[mesh] phase passed in {rows['wall_s']:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 13: the static checker, the import smoke and the six examples
# ---------------------------------------------------------------------------

# 13(a): host work beside the build, each as a user runs it, on a machine
# without JAX: the checker over the port, the import smoke over the port and
# its examples, and the two examples that hold no tensor
EXAMPLE_HOST = {
    "simcheck": ["-m", "repro_torch.analysis.check", "src/repro_torch", "--baseline",
                 "analysis_baseline_torch.json"],
    "import_smoke": ["-m", "repro_torch.analysis.import_smoke", "src/repro_torch", "examples_torch"],
    "quickstart": ["examples_torch/quickstart.py"],
    "net_scenarios": ["examples_torch/net_scenarios.py"],
}
# 13(b): the examples that hold tensors, on the card (their default device)
SERVE_EXAMPLES = ("serve_autoscale", "serve_disagg", "serve_maas")
# serve_maas runs on a simulated clock: its summary is the CPU run's, which
# is what the JAX example prints
MAAS_SUMMARY = {"grants": 6, "cold_starts": 1, "scale_to_zero": 3, "gpu_seconds": "4.86",
                "source": "O(1) host copy"}
N_AUTOSCALE, N_DISAGG = 16, 32  # the examples' requests and trace arrivals
# train_100m: its granite cut to 8 layers; a run over the step-100
# checkpoint, then one resumed from it
EXAMPLE_TRAIN = dict(layers=8, batch=16, seq=256, steps=120, ckpt_step=100, resume_steps=140)


def parse_maas_summary(text: str) -> dict:
    """serve_maas's fleet totals and its cold start's multicast source."""
    m = re.search(r"^fleet totals: (\d+) grants, (\d+) cold starts, (\d+) scale-to-zero events, "
                  r"(\d+\.\d+) GPU-seconds occupied$", text, re.M)
    src = re.search(r"multicast source: (.+)$", text, re.M)
    check(m is not None and src is not None, "serve_maas: no fleet summary in its output")
    return {"grants": int(m[1]), "cold_starts": int(m[2]), "scale_to_zero": int(m[3]),
            "gpu_seconds": m[4], "source": src[1].strip()}


def parse_autoscale(text: str) -> dict:
    """serve_autoscale's two runs: requests served and wall seconds each."""
    out = {}
    for key, label in (("live", "live scaling"), ("stop_the_world", "stop-the-world")):
        m = re.search(rf"^{label}: +all (\d+) requests in (\d+\.\d+)s$", text, re.M)
        check(m is not None, f"serve_autoscale: no {label!r} line in its output")
        out[key] = {"served": int(m[1]), "wall_s": float(m[2])}
    return out


def parse_disagg(text: str) -> dict:
    """serve_disagg's summary: served, handoffs, gapped and the scale events."""
    s = re.search(r"^served (\d+) requests in (\d+\.\d+)s", text, re.M)
    h = re.search(r"^migrations (\d+)  mutations (\d+) .*replacement live-scales (\d+)  "
                  r"scale-downs (\d+)  handoffs (\d+) gapped (\d+)$", text, re.M)
    check(s is not None and h is not None, "serve_disagg: no summary in its output")
    return {"served": int(s[1]), "wall_s": float(s[2]), "migrations": int(h[1]),
            "mutations": int(h[2]), "live_scales": int(h[3]), "scale_downs": int(h[4]),
            "handoffs": int(h[5]), "gapped": int(h[6])}


def parse_train(text: str) -> dict:
    """train_100m's logged steps (loss, tok/s), checkpoints and resume."""
    steps = {int(m[1]): {"loss": float(m[2]), "tok_s": float(m[3].replace(",", ""))}
             for m in re.finditer(r"^step +(\d+)  loss (\S+)  lr \S+  tok/s ([\d,]+)$", text, re.M)}
    resumed = re.search(r"^resumed from step (\d+)$", text, re.M)
    return {"steps": steps, "resumed": int(resumed[1]) if resumed else None,
            "checkpoints": len(re.findall(r"^  checkpoint -> ", text, re.M))}


def example_train_launches(steps: int) -> dict:
    """Kernel launches of ``steps`` steps of train_100m (one microbatch,
    remat): ``steps`` x phase 11c's per-step arithmetic at its 8 layers."""
    from types import SimpleNamespace

    one = train_launches(SimpleNamespace(n_layers=EXAMPLE_TRAIN["layers"]), 1)
    return {k: v * steps for k, v in one.items()}


def run_example(torch, name: str, argv: list[str]):
    """examples_torch/<name>.py's ``main(argv)`` in this process, its stdout
    captured (printed whole if it raises) -> (main's result, stdout, wall s)."""
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            result = mod.main(argv)
        torch.cuda.synchronize()
    except BaseException:
        print(buf.getvalue()[-6000:], flush=True)
        raise
    return result, buf.getvalue(), time.perf_counter() - t0


def phase_example_host(host: dict, log_dir: Path | None) -> dict:
    """13(a): the subprocesses exited 0 with the lines each must end in."""
    from repro_torch.analysis.import_smoke import iter_modules

    n = (len(iter_modules(str(ROOT / "src" / "repro_torch")))
         + len(iter_modules(str(ROOT / "examples_torch"))))
    rows = phase_host_tools(host, log_dir)
    want = {"simcheck": "simcheck: clean",
            "import_smoke": f"import-smoke: {n} compiled, {n} imported, 0 failure(s)",
            "net_scenarios": "all five scenarios behaved as modelled"}
    for name, line in want.items():
        check(rows[name]["last_line"] == line,
              f"{name}: last line {rows[name]['last_line']!r}, not {line!r}")
    check(rows["quickstart"]["last_line"].strip().startswith("exact ILP"),
          f"quickstart: last line {rows['quickstart']['last_line']!r}")
    rows["modules_imported"] = n
    rows["jax_installed"] = importlib.util.find_spec("jax") is not None
    return rows


def _example_log(log_dir: Path | None, name: str, out: str) -> None:
    if log_dir is not None:
        (log_dir / f"example_{name}.log").write_text(out)


def phase_example_serve(torch, ops, name: str, card: str, log_dir: Path | None) -> dict:
    """13(b), one serving example on the card: its facts, the three forward
    kernels launched, no backward kernel."""
    ops.reset_launch_counts()
    _, out, wall = run_example(torch, name, [])
    counts = ops.launch_counts()
    _example_log(log_dir, name, out)
    check(all(counts[k] > 0 for k in FWD_KERNELS), f"{name}: a forward kernel never launched: {counts}")
    check(all(counts[k] == 0 for k in BWD_KERNELS), f"{name}: a backward kernel launched: {counts}")
    if name == "serve_autoscale":
        facts = parse_autoscale(out)
        check(all(r["served"] == N_AUTOSCALE for r in facts.values()),
              f"serve_autoscale: served {facts}, not all {N_AUTOSCALE} in both runs")
    elif name == "serve_disagg":
        facts = parse_disagg(out)
        check(facts["served"] == N_DISAGG and facts["handoffs"] == facts["served"]
              and facts["gapped"] == 0, f"serve_disagg: {facts}")
    else:
        facts = parse_maas_summary(out)
        check(facts == MAAS_SUMMARY, f"serve_maas: {facts}, not the CPU run's {MAAS_SUMMARY}")
    row = {"wall_s": wall, "launches": counts, **facts}
    log(f"[examples] {name}: {wall:.3f} s wall, launches {counts}, {facts} | {card}")
    return row


def phase_example_train(torch, ops, card: str, log_dir: Path | None) -> dict:
    """13(b), train_100m on the card: 120 steps over the step-100 checkpoint,
    launches exactly 120 steps' worth, a falling loss; then a run resumed
    from step 100 whose step-100 loss is the unbroken run's."""
    from repro_torch.training.checkpoint import latest_step

    t = EXAMPLE_TRAIN
    shape = ["--batch", str(t["batch"]), "--seq", str(t["seq"])]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_100m_") as ckpt:
        ops.reset_launch_counts()
        _, out, wall = run_example(torch, "train_100m",
                                   ["--steps", str(t["steps"]), *shape, "--ckpt", ckpt])
        counts = ops.launch_counts()
        _example_log(log_dir, "train_100m", out)
        want = example_train_launches(t["steps"])
        check(counts == want, f"train_100m: launches {counts} != {t['steps']} steps of {want}")
        run = parse_train(out)
        last = t["steps"] - 1
        check(run["checkpoints"] == 1 and latest_step(ckpt) == t["ckpt_step"],
              f"train_100m: checkpoints {run['checkpoints']}, latest {latest_step(ckpt)}")
        check(0 in run["steps"] and last in run["steps"], f"train_100m: logged steps {sorted(run['steps'])}")
        loss0, loss_last = run["steps"][0]["loss"], run["steps"][last]["loss"]
        check(loss_last < loss0, f"train_100m: loss {loss0} at step 0, {loss_last} at step {last}")

        ops.reset_launch_counts()
        _, out2, wall2 = run_example(torch, "train_100m",
                                     ["--steps", str(t["resume_steps"]), *shape, "--ckpt", ckpt])
        counts2 = ops.launch_counts()
        _example_log(log_dir, "train_100m_resumed", out2)
        resumed = parse_train(out2)
        check(resumed["resumed"] == t["ckpt_step"], f"train_100m: resumed from {resumed['resumed']}")
        want2 = example_train_launches(t["resume_steps"] - t["ckpt_step"])
        check(counts2 == want2, f"train_100m resumed: launches {counts2} != {want2}")
        at = t["ckpt_step"]
        check(resumed["steps"][at]["loss"] == run["steps"][at]["loss"],
              f"train_100m: step {at} loss {resumed['steps'][at]['loss']} resumed, "
              f"{run['steps'][at]['loss']} unbroken")
    tokens = t["steps"] * t["batch"] * t["seq"]
    row = {"wall_s": wall, "launches": counts, "loss_step0": loss0, f"loss_step{last}": loss_last,
           "tok_s_logged": run["steps"][last]["tok_s"], "tok_s_wall": tokens / wall,
           "resumed_wall_s": wall2, "resumed_launches": counts2,
           "resumed_step_loss": resumed["steps"][t["ckpt_step"]]["loss"]}
    log(f"[examples] train_100m: {t['steps']} steps in {wall:.3f} s wall ({tokens / wall:,.0f} tok/s "
        f"with the checkpoint write; the example logs {row['tok_s_logged']:,.0f}), loss {loss0} -> "
        f"{loss_last}, launches {counts}; resumed from step {t['ckpt_step']} to {t['resume_steps']} "
        f"in {wall2:.3f} s | {card}")
    return row


def phase_examples(torch, ops, card: str, host: dict, log_dir: Path | None) -> dict:
    """Phase 13: 13(a) the host subprocesses' results, 13(b) the examples
    that hold tensors, in this process on the card, after phase 12's models
    are freed."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rows = {"host": phase_example_host(host, log_dir)}
    for name in SERVE_EXAMPLES:
        rows[name] = phase_example_serve(torch, ops, name, card, log_dir)
        gc.collect()
        torch.cuda.empty_cache()
    rows["train_100m"] = phase_example_train(torch, ops, card, log_dir)
    rows["wall_s"] = time.perf_counter() - t_phase
    log(f"[examples] phase passed in {rows['wall_s']:.1f} s | {card}")
    return rows


# ---------------------------------------------------------------------------
# Phase 14: sequence shards on one card
# ---------------------------------------------------------------------------

SHARD_CUTS = (4, 16)  # sequence blocks: a 4-way "model" axis and production's 16-way one
# granite-8b's decode at 8 x 32k: lengths at the blocks' boundaries, one that
# ends inside the first 16-way block (the later blocks hold none of its keys)
# and one of 0
SHARD_DECODE = dict(b=8, h=32, kv=8, s=32768, d=128,
                    lengths=(32768, 32731, 20000, 8192, 2048, 1000, 1, 0))
# whisper's cross cache of 1500 frames, cut 16 ways into uneven blocks (94 x 15, 90)
SHARD_CROSS = dict(b=4, h=20, kv=20, s=1500, d=64, lengths=(1500,) * 4)
# the flash forward cut into 4 row blocks, each at its q_offset:
# case -> (b, sq, sk, h, kv, d, causal)
SHARD_FLASH = {
    "main B=1 S=512 H=32 KV=8 D=128 causal": (1, 512, 512, 32, 8, 128, True),
    "train B=4 S=2048 H=32 KV=8 D=128 causal": (4, 2048, 2048, 32, 8, 128, True),
    "whisper-cross B=4 Sq=512 Sk=1500 H=20 KV=20 D=64 non-causal": (4, 512, 1500, 20, 20, 64, False),
}
SHARD_Q_BLOCKS = 4
# 14(d): the flash backward over the same 4 q blocks at their offsets:
# case -> (b, sq, sk, h, kv, d, causal)
SHARD_FLASH_BWD = {k: v for k, v in SHARD_FLASH.items() if k.split()[0] in ("train", "whisper-cross")}
# 14(c): granite-8b at full width through a one-rank mesh, its cache's
# sequence over the (1-way) "model" axis: the decode of ops' DTensor path
SHARD_SERVE = dict(layers=2, batch=4, prompt=128, steps=4)
# 14(e): minicpm3-4b's absorbed decode over 8 slots x 32,768 latent rows;
# lengths of at least 1, as after a step's append: the later blocks hold no
# key of the short rows
SHARD_MLA = dict(b=8, s=32768, lengths=(32768, 32731, 20000, 8192, 2048, 1000, 17, 1))
SHARD_MLA_UNEVEN = (0, 1000, 1000, 9000, 20000, 32768)  # a hand cut: one empty block
# 14(f): minicpm3-4b at full width through the one-rank mesh, its latent
# cache's sequence over "model": MLA's decode on the block path
SHARD_SERVE_MLA = dict(layers=2, batch=4, prompt=128, steps=4)
# 14(g), (h): the MoE and SSM archs at full width through the one-rank mesh,
# served as 14(c): arch -> layers (zamba2's shared block runs after its 6th)
SHARD_SERVE_FAMILIES = {"grok-1-314b": 2, "olmoe-1b-7b": 2, "mamba2-370m": 2, "zamba2-2.7b": 6}
# the MoE product that contracts a sharded index (grok-1's d_ff, olmoe's experts)
MOE_CONTRACTED = {"grok-1-314b": "gecf,efd->gecd", "olmoe-1b-7b": "gsec,gecd->gsd"}
# 14(i): mamba2-370m's SSD scan over 4 x 8,192 tokens cut into 16 head blocks
SHARD_SSD = dict(b=4, s=8192, blocks=16)
SSD_TOL = 1e-5  # a block's y and state against the whole call's, of its largest magnitude
# 14(j): nemotron-4-340b's decode K/V projections at full width: the 8 rows a
# rank holds in decode_32k (128 over the 16-way "data" axis) against wk and wv,
# d_model cut into the 16 blocks that the idle "model" axis contracts under
# the FSDP overlay (``sharding.idle_contraction``)
SHARD_KV_PROJ = dict(arch="nemotron-4-340b", rows=8, blocks=16)
# 14(k): granite-8b at full width with one KV head through the one-rank
# mesh: the KV head (a size-1 dim) over the 1-way "model" axis, which
# placements leave whole; flash at 32/1 heads, decode at n_rep 32 (four head
# groups of 8), bf16
SHARD_SERVE_KV1 = dict(arch="granite-8b", layers=2, batch=4, prompt=512, steps=3)
# the kernel line's rows of the variants: (name, source, replaces, the case timed)
SHARD_VARIANTS = (
    ("decode_attention_lse", "src/repro_torch/kernels/csrc/decode_attention.cu",
     "src/repro/kernels/decode_attention.py:36", ("decode", "bf16", 4)),
    ("flash_attention_q_offset", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:39", ("flash", "bf16", "train")),
    ("flash_attention_bwd_q_offset", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
     None, ("flash_bwd", "bf16", "train")),  # port-only, as flash_attention_bwd
)


def block_starts(rows: int, n: int) -> list[int]:
    """The first row of each of n blocks of ``rows`` and the end, as a mesh's
    ceil chunking (``sharding.local_block``) cuts them."""
    c = -(-rows // n)
    return [min(i * c, rows) for i in range(n + 1)]


def _shard_decode_inputs(torch, spec: dict, quant: bool, seed: int):
    """(q, k, v, lengths[, k_scale, v_scale]) in bf16, the cache int8 with
    its scales under ``quant``."""
    from repro_torch.models.kvcache import quantize_kv

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    b, h, kv, s, d = (spec[x] for x in ("b", "h", "kv", "s", "d"))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    lens = torch.tensor(spec["lengths"], dtype=torch.int32, device="cuda")
    if not quant:
        return randn(b, h, d), randn(b, kv, s, d), randn(b, kv, s, d), lens
    (kq, ks), (vq, vs) = (quantize_kv(randn(b, kv, s, d)) for _ in range(2))
    return randn(b, h, d), kq, vq, lens, ks, vs


def _slice_fns(ops, ref):
    """One cache block's decode with lse, kernel and plain: what a rank runs."""
    def scales(sc):
        return dict(k_scale=sc[0], v_scale=sc[1]) if sc else {}

    def kernel(q, k, v, lengths, *sc):
        return ops.decode_attention(q, k, v, lengths, return_lse=True, impl="kernel", **scales(sc))

    def plain(q, k, v, lengths, *sc):
        return ref.decode_attention_ref(q, k, v, lengths, return_lse=True, **scales(sc))

    return kernel, plain


def shard_decode(torch, ops, ref, name: str, inputs, n: int, timed: bool) -> dict:
    """The cache cut into n sequence blocks, the kernel with lse over each
    (its lengths cut to the block), merged by ``ops.merge_partials``: held
    to the whole call and to the plain version (out within bf16's 2e-2 of
    the output's largest magnitude, lse within 2e-2, -inf for the row of
    length 0).  Timed: the block with the most valid rows, cold (a rank's
    call), and the merge of the n partials."""
    q, k, v, lens, *sc = inputs
    scales = dict(k_scale=sc[0], v_scale=sc[1]) if sc else {}
    kernel, plain = _slice_fns(ops, ref)
    starts = block_starts(k.shape[2], n)
    blocks = [(q, *(t[:, :, a:e].contiguous() for t in (k, v)), (lens - a).clamp(0, e - a).int(),
               *(t[:, :, a:e].contiguous() for t in sc)) for a, e in zip(starts, starts[1:])]
    parts = [kernel(*blk) for blk in blocks]  # the path: counted
    outs, lses = torch.stack([o for o, _ in parts]), torch.stack([x for _, x in parts])
    out, lse = ops.merge_partials(outs, lses)
    out = out.to(q.dtype)
    with ops.uncounted():
        whole = ops.decode_attention(q, k, v, lens, impl="kernel", **scales)
    want, want_lse = ref.decode_attention_ref(q, k, v, lens, return_lse=True, **scales)
    torch.cuda.synchronize()
    live = lens > 0
    check(bool((lse[~live] == float("-inf")).all()), f"shards {name}/{n}: a row of length 0 has a finite lse")
    row = {"case": name, "blocks": n, "rows_per_block": [e - a for a, e in zip(starts, starts[1:])],
           "max_abs_err_whole": max_err(torch, out, whole, "bf16", scaled=True),
           "max_abs_err": max_err(torch, out, want, "bf16", scaled=True),
           "lse_max_abs_err": max_err(torch, lse[live], want_lse[live], "bf16"),
           "launches": n}
    if timed:
        big = max(range(n), key=lambda i: int(blocks[i][3].sum()))
        blk = blocks[big]
        with ops.uncounted():
            t = time_ms(torch, {"kernel": kernel, "plain": plain}, cold_sets(blk))
            merge = time_ms(torch, {"merge": ops.merge_partials}, [(outs, lses)])["merge"]
        quant = bool(sc)
        nbytes, flops = work("decode_attention_int8" if quant else "decode_attention", blk, {}, "bf16")
        nbytes += 4 * q.shape[0] * q.shape[1]  # the lse, written once
        row.update(block=big, block_valid_rows=int(blk[3].sum()), ms=t["kernel"], plain_ms=t["plain"],
                   merge_ms=merge, library_ms=None, bytes=nbytes, flops=flops, timed="cold")
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, "bf16")
    del blocks, parts
    return row


def shard_flash(torch, ops, ref, case: str, dt: str, shape) -> dict:
    """q cut into 4 row blocks, each through the flash forward at its
    q_offset with and without lse (the serving call; the two outputs
    bit-equal), concatenated: held to the whole call and to the plain
    version, out and lse, at dt's tolerance.  Timed warm (or cold past half
    the L2, as phase 2): the heaviest block (the last) at its offset, its
    plain version and SDPA with the offset as a mask, and the whole call."""
    from repro_torch.kernels import flash_attention as fk

    b, sq, sk, h, kv, d, causal = shape
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 14)
    q, k, v = (torch.randn(s_, generator=gen, device="cuda").to(dtype)
               for s_ in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
    starts = block_starts(sq, SHARD_Q_BLOCKS)
    outs, lses = [], []
    for a, e in zip(starts, starts[1:]):  # the path: counted
        qb = q[:, a:e].contiguous()
        o, x = fk.flash_attention(qb, k, v, causal=causal, return_lse=True, q_offset=a)
        check(torch.equal(o, fk.flash_attention(qb, k, v, causal=causal, q_offset=a)),
              f"shards {case} {dt}: a block's output with lse differs from the one without")
        outs.append(o)
        lses.append(x)
    got, got_lse = torch.cat(outs, dim=1), torch.cat(lses, dim=2)
    with ops.uncounted():
        whole, whole_lse = fk.flash_attention(q, k, v, causal=causal, return_lse=True)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    want_lse = ref.flash_attention_lse_ref(q, k, causal=causal)
    row = {"case": case, "dtype": dt, "blocks": SHARD_Q_BLOCKS, "q_offsets": starts[:-1],
           "max_abs_err_whole": max_err(torch, got, whole, dt),
           "max_abs_err": max_err(torch, got, want, dt),
           "lse_max_abs_err_whole": max_err(torch, got_lse, whole_lse, dt),
           "lse_max_abs_err": max_err(torch, got_lse, want_lse, dt),
           "launches": 2 * sum(1 for a in starts[:-1] if a)}
    del want, want_lse
    a, e = starts[-2], starts[-1]
    kw = {"causal": causal, "q_offset": a}
    blk = (q[:, a:e].contiguous(), k, v)
    nbytes, flops = work("flash_attention", blk, kw, dt)
    sets = cold_sets(blk) if nbytes > L2_BYTES / 2 else [blk]
    fns = {"kernel": lambda *x: fk.flash_attention(*x, **kw),
           "plain": lambda *x: ref.flash_attention_ref(*x, **kw),
           "library": library_call(torch, "flash_attention", blk, kw)}
    with ops.uncounted():
        t = time_ms(torch, fns, sets)
        whole_ms = time_ms(torch, {"whole": lambda *x: fk.flash_attention(*x, causal=causal)},
                           cold_sets((q, k, v)) if len(sets) > 1 else [(q, k, v)])["whole"]
    row.update(block_q_offset=a, ms=t["kernel"], plain_ms=t["plain"], library_ms=t["library"],
               whole_ms=whole_ms, bytes=nbytes, flops=flops,
               timed="cold" if len(sets) > 1 else "warm")
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dt)
    return row


def shard_flash_bwd(torch, ops, ref, case: str, dt: str, shape) -> dict:
    """14(d): q cut into 4 row blocks, each through the flash forward with
    lse and the backward at its q_offset with the block's rows of the whole
    call's dO, as a sequence-parallel rank runs them; the blocks' dq
    concatenated and their dk and dv summed (in f32, as an exact reduction
    across the shards gives them) held to the whole backward call and to
    the plain version at dt's tolerance of each gradient's largest
    magnitude (phase 11a's rule); under causal, the keys past each block's
    last row get dk = dv = 0 exactly; each block's backward run twice gives
    the same bits.  Timed cold: the last block's backward at its offset,
    its plain version, SDPA forward + backward with the offset as a mask
    less its forward, and the whole backward call."""
    from repro_torch.kernels import flash_attention as fk

    b, sq, sk, h, kv, d, causal = shape
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 16)
    q, do, k, v = (torch.randn(s_, generator=gen, device="cuda").to(dtype)
                   for s_ in ((b, sq, h, d), (b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
    starts = block_starts(sq, SHARD_Q_BLOCKS)
    dqs, dk, dv = [], torch.zeros(k.shape, device="cuda"), torch.zeros(v.shape, device="cuda")
    zero_keys, blocks = 0, []
    for a, e in zip(starts, starts[1:]):  # the path: counted
        kw = {"causal": causal, "q_offset": a}
        qb, dob = q[:, a:e].contiguous(), do[:, a:e].contiguous()
        o, lse = fk.flash_attention(qb, k, v, return_lse=True, **kw)
        g = fk.flash_attention_bwd(qb, k, v, o, dob, lse, **kw)
        with ops.uncounted():
            again = fk.flash_attention_bwd(qb, k, v, o, dob, lse, **kw)
        check(all(torch.equal(x, y) for x, y in zip(g, again)),
              f"shards bwd {case} {dt}: the block at {a} differs between two runs")
        if causal:
            check(not g[1][:, e:].any() and not g[2][:, e:].any(),
                  f"shards bwd {case} {dt}: keys past row {e - 1} of the block at {a} have dk or dv")
            zero_keys += (sk - min(e, sk)) * b * kv
        dqs.append(g[0])
        dk += g[1].float()
        dv += g[2].float()
        blocks.append((qb, k, v, o, dob, lse))
    got = (torch.cat(dqs, dim=1), dk, dv)
    with ops.uncounted():
        o, lse = fk.flash_attention(q, k, v, causal=causal, return_lse=True)
        whole = fk.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    row = {"case": case, "dtype": dt, "blocks": SHARD_Q_BLOCKS, "q_offsets": starts[:-1],
           "max_abs_err_whole": grads_err(torch, got, whole, dt),
           "max_abs_err": grads_err(torch, got, want, dt),
           "zero_key_rows": zero_keys, "deterministic": True,
           "launches": sum(1 for a in starts[:-1] if a), "fwd_launches": sum(1 for a in starts[:-1] if a)}
    del want, got, dqs, dk, dv
    a = starts[-2]
    kw = {"causal": causal, "q_offset": a}
    blk = blocks[-1]
    nbytes, flops = bwd_work("flash_attention_bwd", blk, kw, dt)
    lib_fwd, lib_fwd_bwd = bwd_library_call(torch, "flash_attention_bwd", kw, blk)
    iters = 10 if flops > 1e11 else 30
    with ops.uncounted():
        t = time_ms(torch, {"plain": lambda *x: ref.flash_attention_bwd_ref(*x, **kw),
                            "kernel": lambda *x: fk.flash_attention_bwd(*x, **kw),
                            "library": lib_fwd_bwd, "library_fwd": lib_fwd}, cold_sets(blk), iters=iters)
        whole_ms = time_ms(torch, {"whole": lambda *x: fk.flash_attention_bwd(*x, causal=causal)},
                           cold_sets((q, k, v, o, do, lse)), iters=iters)["whole"]
    row.update(block_q_offset=a, ms=t["kernel"], plain_ms=t["plain"],
               library_ms=t["library"] - t["library_fwd"], library_fwd_bwd_ms=t["library"],
               whole_ms=whole_ms, bytes=nbytes, flops=flops, iters=iters, timed="cold")
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dt)
    del blocks, blk, whole
    return row


def mla_cuts(rows: int) -> dict:
    """14(e)'s cuts of the latent cache: the first row of each block and
    the end; 4 and 16 blocks as a mesh cuts them, and the hand cut."""
    return {4: block_starts(rows, 4), 16: block_starts(rows, 16), "uneven": list(SHARD_MLA_UNEVEN)}


def mla_block_work(q_abs, q_rope, ckv, krope, lengths, start: int) -> tuple[float, float]:
    """(bytes, flops) of ``ops.mla_decode_block`` on one block: the ckv and
    krope rows that hold a key (start + j < length) read once, q_abs and
    q_rope read, ctx and lse (f32) written; the scores' and p·c's products
    over those rows."""
    b, h, r = q_abs.shape
    rope = q_rope.shape[-1]
    rows = int((lengths - start).clamp(0, ckv.shape[1]).sum())
    nbytes = (rows * (r * ckv.element_size() + rope * krope.element_size())
              + b * h * (r * q_abs.element_size() + rope * q_rope.element_size()) + 4 * b * h * (r + 1))
    return nbytes, 2 * h * rows * (2 * r + rope)


def shard_mla_decode(torch, ops, cfg, dt: str, card: str) -> dict:
    """14(e): minicpm3-4b's absorbed decode core at full width over 8 x 32k
    latent rows, cut into ``mla_cuts``' blocks: ``ops.mla_decode_block``
    over each block from its start (the rank's call; plain products, no
    kernel, as the reference computes it), merged by ``ops.merge_partials``
    and held to the whole unsharded core (``ops.mla_decode_attention``)
    at dt's tolerance of its largest magnitude, lse too; two runs
    bit-equal; a block past a row's length has lse -inf (weight 0), an
    empty block ctx 0.  Timed cold: the block with the most valid rows
    beside its bound, the merge and the whole call."""
    t = SHARD_MLA
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 17)
    b, s, h, r, rope = t["b"], t["s"], cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_dim
    q_abs, q_rope, ckv, krope = (torch.randn(x, generator=gen, device="cuda").to(dtype)
                                 for x in ((b, h, r), (b, h, rope), (b, s, r), (b, s, rope)))
    lens = torch.tensor(t["lengths"], dtype=torch.int32, device="cuda")
    kw = {"softmax_scale": 1.0 / math.sqrt(cfg.mla_qk_head_dim)}
    whole, whole_lse = ops.mla_decode_block(q_abs, q_rope, ckv, krope, lens, return_lse=True, **kw)
    check(torch.equal(whole, ops.mla_decode_attention(q_abs, q_rope, ckv, krope, lens, **kw)),
          f"shards mla {dt}: the whole block's ctx differs from the unsharded core's")
    whole_ms = None
    rows = {}
    for n, starts in mla_cuts(s).items():
        blocks = [(q_abs, q_rope, ckv[:, a:e].contiguous(), krope[:, a:e].contiguous(), lens, a)
                  for a, e in zip(starts, starts[1:])]

        def merged():
            parts = [ops.mla_decode_block(*blk[:5], start=blk[5], return_lse=True, **kw)
                     for blk in blocks]
            outs, lses = torch.stack([c for c, _ in parts]), torch.stack([x for _, x in parts])
            return ops.merge_partials(outs, lses), (outs, lses)

        (ctx, lse), (outs, lses) = merged()
        (again, again_lse), _ = merged()
        torch.cuda.synchronize()
        check(torch.equal(ctx, again) and torch.equal(lse, again_lse),
              f"shards mla {dt}/{n}: two runs differ")
        keyless = [(lens <= a)[:, None].expand(b, h) for a in starts[:-1]]
        check(all(bool(x[k].isinf().all() and (x[k] < 0).all()) for x, k in zip(lses, keyless)),
              f"shards mla {dt}/{n}: a block past a row's length has a finite lse")
        check(all(not o.any() for o, (a, e) in zip(outs, zip(starts, starts[1:])) if a == e),
              f"shards mla {dt}/{n}: an empty block's ctx is not 0")
        row = {"case": f"minicpm3-4b B={b} S={s} {dt}", "blocks": n,
               "rows_per_block": [e - a for a, e in zip(starts, starts[1:])],
               "max_abs_err": max_err(torch, ctx, whole, dt, scaled=True),
               "lse_max_abs_err": max_err(torch, lse, whole_lse, dt), "bit_equal_twice": True}
        big = max(range(len(blocks)), key=lambda i: int((lens - starts[i]).clamp(0, starts[i + 1] - starts[i]).sum()))
        blk, a = blocks[big][:5], blocks[big][5]
        nbytes, flops = mla_block_work(*blk, a)
        with ops.uncounted():
            ms = time_ms(torch, {"block": lambda *x: ops.mla_decode_block(
                *x, start=a, return_lse=True, **kw)}, cold_sets(blk))["block"]
            merge = time_ms(torch, {"merge": ops.merge_partials}, [(outs, lses)])["merge"]
            if whole_ms is None:
                whole_ms = time_ms(torch, {"whole": lambda *x: ops.mla_decode_attention(*x, **kw)},
                                   cold_sets((q_abs, q_rope, ckv, krope, lens)))["whole"]
        row.update(block=big, block_start=a, block_valid_rows=int((lens - a).clamp(0, blk[2].shape[1]).sum()),
                   ms=ms, merge_ms=merge, whole_ms=whole_ms, bytes=nbytes, flops=flops,
                   byte_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, timed="cold")
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, "f32")  # the products run in f32
        rows[(dt, n)] = row
        log(f"[shards] mla {dt} over {n} blocks: block {ms:.5f} ms (byte bound "
            f"{row['byte_bound_ms']:.5f} ms, bound {row['bound_ms']:.5f} ms by {row['bound_by']}), "
            f"merge {merge:.5f} ms, whole call {whole_ms:.5f} ms | {card} | " + json.dumps(row))
        del blocks, outs, lses
    del q_abs, q_rope, ckv, krope
    return rows


def _mesh_serve(torch, np, ops, TF, cfg, t: dict, leaf: str, record=contextlib.nullcontext):
    """``cfg`` from seeded weights: a prefill of t["batch"] x t["prompt"]
    tokens and t["steps"] decode steps, once unsharded (uncounted) and once
    through a one-rank NCCL mesh under its rules.  Returns (the unsharded
    passes' logits, the sharded ones', the placements of the cache's
    ``leaf``, the mesh's shape, what ``record()``, entered around the
    sharded run only, yielded, and a dict of both runs' last caches, leaf
    by leaf (``caches``, the sharded leaves gathered), and each sharded
    decode step's ms on the card's stream (``step_ms``, CUDA events around
    the step: the host's dispatch is inside))."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps as steps_mod

    params = TF.init_params(cfg, SEED, device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(SEED + 14).integers(
        0, cfg.vocab_size, size=(t["batch"], t["prompt"])).astype(np.int32), device="cuda")
    max_seq = t["prompt"] + t["steps"]

    def full(x):
        return x.full_tensor() if sh.is_dtensor(x) else x

    def leaves(tree, path=""):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{path}{k}/") if isinstance(v, dict) else {path + k: full(v)})
        return out

    step_ms = []

    def run(params, caches, toks, rules):
        step = (lambda fn: fn) if rules is None else (lambda fn: steps_mod._with_rules(rules, fn))
        logits, caches = step(TF.prefill_logits)(cfg, params, toks, caches)
        out = [full(logits)]
        for _ in range(t["steps"]):
            nxt = full(logits).argmax(-1).to(torch.int32)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            logits, caches = step(TF.decode_logits)(cfg, params, nxt, caches)
            ev[1].record()
            out.append(full(logits))
            if rules is not None:
                step_ms.append(ev)
        torch.cuda.synchronize()
        return out, leaves(caches)

    with ops.uncounted():
        plain, plain_caches = run(params, TF.init_caches(cfg, t["batch"], max_seq, device="cuda"),
                                  tokens, None)
    started = mesh_mod.init_process_group("cuda")
    try:
        mesh = mesh_mod.make_host_mesh()
        rules = steps_mod.make_rules(cfg, mesh)
        caches = TF.init_caches(cfg, t["batch"], max_seq, device="cuda")
        specs = sh.specs_for_axes(caches, TF.cache_axes(cfg), rules)
        caches = sh.map_pair(lambda x, spec: sh.distribute(x, spec, mesh), caches, specs)
        placements = caches["layers"][leaf].placements
        sparams = sh.distribute_tree(params, TF.param_template(cfg), rules)
        with record() as seen:
            got, got_caches = run(sparams, caches, sh.distribute(tokens, rules.spec_for_shape(
                tuple(tokens.shape), ("batch", "seq")), mesh), rules)
        shape = list(mesh.shape)
        del sparams, caches
    finally:
        if started:
            torch.distributed.destroy_process_group()
    del params
    extra = {"caches": (plain_caches, got_caches),
             "step_ms": [a.elapsed_time(b) for a, b in step_ms]}
    return plain, got, placements, shape, seen, extra


def _logits_apart(torch, got, plain, what: str) -> tuple[list, bool]:
    """Each pass's largest logit difference from the unsharded run (within
    bf16's 2e-2, token ids equal, or fail) and whether all are bit-equal."""
    errs = []
    for i, (g, p) in enumerate(zip(got, plain)):
        diff = (g.float() - p.float()).abs()
        errs.append(float(diff.max()))
        check(bool((diff <= TOL["bf16"] + TOL["bf16"] * p.float().abs()).all()),
              f"{what}: pass {i} logits {errs[-1]} from the unsharded run")
        check(torch.equal(g.argmax(-1), p.argmax(-1)), f"{what}: pass {i} tokens differ")
    return errs, all(torch.equal(g, p) for g, p in zip(got, plain))


def shard_serve(torch, np, ops, TF, get_config, arch: str = "granite-8b") -> dict:
    """14(c): granite-8b cut to 2 layers at full width, a prefill of 4 x 128
    and 4 decode steps, once unsharded and once through a one-rank NCCL
    mesh whose rules put the cache's sequence over "model": each sharded
    decode runs ops' flash-decoding path (the kernel with lse on the rank's
    block, the all-gather and the merge).  Logits within bf16's 2e-2, token
    ids equal.  14(f), ``arch`` minicpm3-4b: the latent cache's sequence
    over "model", so each sharded decode runs MLA's block path
    (``ops.mla_decode_block`` on the rank's rows, the merge); logits
    bit-equal to the unsharded run (one block merged gives its bits)."""
    mla = arch == "minicpm3-4b"
    t = SHARD_SERVE_MLA if mla else SHARD_SERVE
    leaf, seq_dim = ("ckv", 2) if mla else ("k", 3)  # the stacked leaf's sequence dim
    cfg = get_config(arch).replace(n_layers=t["layers"])
    before = (ops.mla_block_calls, ops.variant_counts()["decode_attention_lse"])
    plain, got, placements, mesh_shape, _, _ = _mesh_serve(torch, np, ops, TF, cfg, t, leaf)
    blocks = ops.mla_block_calls - before[0]
    launched = ops.variant_counts()["decode_attention_lse"] - before[1]
    placed = [str(p) for p in placements]
    check(placements[1].is_shard(seq_dim),
          f"shards serve {arch}: the cache's sequence is not over 'model': {placed}")
    want = cfg.n_layers * t["steps"]
    check((blocks, launched) == ((want, 0) if mla else (0, want)),
          f"shards serve {arch}: {blocks} MLA block calls and {launched} decode launches with lse, "
          f"not {want} of the {'first' if mla else 'second'} and 0 of the other")
    errs, bit_equal = _logits_apart(torch, got, plain, f"shards serve {arch}")
    check(bit_equal or not mla, f"shards serve {arch}: logits not bit-equal to the unsharded run: {errs}")
    row = {"model": cfg.name, "layers": cfg.n_layers, "mesh": mesh_shape, "cache": placed,
           "decode_lse_launches": launched, "mla_block_calls": blocks, "max_abs_diff": errs,
           "bit_equal": bit_equal}
    log(f"[shards] serve {arch} " + json.dumps(row))
    return row


def shard_serve_family(torch, np, ops, TF, get_config, arch: str) -> dict:
    """14(g), (h): ``arch`` at full width cut to ``SHARD_SERVE_FAMILIES``'
    depth, served as 14(c) through the one-rank NCCL mesh under its rules;
    logits bit-equal to the unsharded run.  A recorder around the sharded
    run shows the block paths: the MoE's product that contracts a sharded
    index (``MOE_CONTRACTED``: grok-1's d_ff, olmoe's experts) gives a
    partial output over "model" on every layer of every pass; every prefill
    layer's SSD scan (mamba2, zamba2) is given x head-sharded over "model"
    and runs on the rank's block of H / 1 heads.  Decode launches with lse:
    n_layers x steps where the cache's sequence is over "model" (grok-1),
    else none."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import mamba2, moe

    cfg = get_config(arch).replace(n_layers=SHARD_SERVE_FAMILIES[arch])
    t = dict(SHARD_SERVE, layers=cfg.n_layers)
    ssm = cfg.family in ("ssm", "hybrid")
    eq = MOE_CONTRACTED.get(arch)

    @contextlib.contextmanager
    def record():
        seen = {"products": [], "ssd_in": [], "ssd_blocks": [], "idle": []}
        einsum, ssd, idle = moe.einsum, mamba2.ssd_chunked, sh.idle_contraction

        def recorded_idle(*a):
            seen["idle"].append(idle(*a))
            return seen["idle"][-1]

        def recorded_einsum(e, *ts):
            out = einsum(e, *ts)
            if e == eq:
                seen["products"].append(["P" if p.is_partial() else str(p) for p in out.placements])
            return out

        def recorded_ssd(x, *a, **kw):
            if sh.is_dtensor(x):
                seen["ssd_in"].append([str(p) for p in x.placements])
            else:  # the rank's block
                seen["ssd_blocks"].append(list(x.shape))
            return ssd(x, *a, **kw)

        moe.einsum, mamba2.ssd_chunked = recorded_einsum, recorded_ssd
        sh.idle_contraction = recorded_idle
        try:
            yield seen
        finally:
            moe.einsum, mamba2.ssd_chunked = einsum, ssd
            sh.idle_contraction = idle

    kv_heads = (cfg.sharding_overrides or {}).get("cache_kv_heads")  # else the cache's sequence
    leaf, dim = ("h", 2) if ssm else ("k", 2 if kv_heads else 3)
    before = ops.variant_counts()["decode_attention_lse"]
    plain, got, placements, mesh_shape, seen, _ = _mesh_serve(torch, np, ops, TF, cfg, t, leaf,
                                                              record)
    launched = ops.variant_counts()["decode_attention_lse"] - before
    placed = [str(p) for p in placements]
    check(placements[1].is_shard(dim), f"shards serve {arch}: the cache's {leaf} is not S({dim}) "
          f"over 'model': {placed}")
    passes = 1 + t["steps"]
    if eq:
        check(len(seen["products"]) == cfg.n_layers * passes
              and all(p[1] == "P" for p in seen["products"]),
              f"shards serve {arch}: {eq} not partial over 'model' on every layer and pass: "
              f"{seen['products']}")
    if ssm:
        check(len(seen["ssd_in"]) == cfg.n_layers and all(p[1] == "S(2)" for p in seen["ssd_in"]),
              f"shards serve {arch}: the SSD scan's x not head-sharded over 'model': {seen['ssd_in']}")
        check(len(seen["ssd_blocks"]) == cfg.n_layers and all(
            x[2] == cfg.ssm_nheads // mesh_shape[1] for x in seen["ssd_blocks"]),
            f"shards serve {arch}: the SSD scan did not run on the rank's heads: {seen['ssd_blocks']}")
    # every axis of the one-rank mesh has size 1: the idle-axis rule never applies
    check(seen["idle"] and not any(seen["idle"]),
          f"shards serve {arch}: the idle-axis contraction applied on a one-rank mesh: "
          f"{seen['idle']}")
    want = cfg.n_layers * t["steps"] if placements[1].is_shard(3) else 0
    check(launched == want, f"shards serve {arch}: {launched} decode launches with lse, not {want}")
    errs, bit_equal = _logits_apart(torch, got, plain, f"shards serve {arch}")
    check(bit_equal, f"shards serve {arch}: logits not bit-equal to the unsharded run: {errs}")
    row = {"model": cfg.name, "layers": cfg.n_layers, "mesh": mesh_shape, "cache": placed,
           "decode_lse_launches": launched, "contracted_partial": len(seen["products"]),
           "ssd_head_blocks": seen["ssd_blocks"], "idle_rule_checks": len(seen["idle"]),
           "max_abs_diff": errs, "bit_equal": bit_equal}
    log(f"[shards] serve {arch} " + json.dumps(row))
    return row


def ssd_work(b: int, s: int, h: int, p: int, n: int, q: int) -> tuple[float, float]:
    """(bytes, flops) of ``mamba2.ssd_chunked`` in f32 over (b, s, h, p)
    with one group of state n and chunk q: x, dt, A, B and C read once, y
    and the final state written; per (sequence, chunk, head) the scores
    (2 q^2 n), y's diagonal term (2 q^2 p), the chunk's state and the
    off-diagonal term (2 q n p each)."""
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n + b * h * p * n)
    return nbytes, (b * (s // q) * h) * (2 * q * q * (n + p) + 4 * q * n * p)


def shard_ssd(torch, cfg, card: str) -> dict:
    """14(i): mamba2-370m's SSD scan (``mamba2.ssd_chunked``: plain products
    in f32, no kernel, as the reference computes it) at full width over
    ``SHARD_SSD``'s tokens, inputs in f32 (dt and A from the init laws'
    ranges), cut into blocks of heads as the sharded mixer cuts them (x, dt
    and A cut, B and C of the one group whole): each block's y and final
    state within ``SSD_TOL`` of the whole call's heads, of their largest
    magnitude; the whole call twice bit-equal.  Timed cold: the whole call
    and the largest block, beside their bounds (f32 operations)."""
    from repro_torch.distributed.sharding import ssm_a_from_uniform
    from repro_torch.models import mamba2

    b, s, k = SHARD_SSD["b"], SHARD_SSD["s"], SHARD_SSD["blocks"]
    h, p, n, q = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 29)
    x = torch.randn((b, s, h, p), generator=gen, device="cuda")
    u = torch.rand((b, s, h), generator=gen, device="cuda")
    dt = torch.exp(u * math.log(0.1 / 1e-3) + math.log(1e-3))  # the ssm_dt law's range
    a = ssm_a_from_uniform(torch.rand((h,), generator=gen, device="cuda"))
    bm, cm = (torch.randn((b, s, 1, n), generator=gen, device="cuda") for _ in range(2))
    y, hf = mamba2.ssd_chunked(x, dt, a, bm, cm, q)
    y2, hf2 = mamba2.ssd_chunked(x, dt, a, bm, cm, q)
    torch.cuda.synchronize()
    check(torch.equal(y, y2) and torch.equal(hf, hf2), "shards ssd: two runs of the whole call differ")
    cuts = block_starts(h, k)
    blocks = [(x[:, :, lo:hi].contiguous(), dt[..., lo:hi].contiguous(), a[lo:hi].contiguous(), bm, cm)
              for lo, hi in zip(cuts, cuts[1:])]
    errs = []
    for (lo, hi), blk in zip(zip(cuts, cuts[1:]), blocks):
        yb, hb = mamba2.ssd_chunked(*blk, q)
        for got, want in ((yb, y[:, :, lo:hi]), (hb, hf[:, lo:hi])):
            check(bool(torch.isfinite(got).all()), f"shards ssd: heads [{lo}, {hi}) not finite")
            err, top = float((got - want).abs().max()), float(want.abs().max())
            check(err <= SSD_TOL * max(top, 1.0),
                  f"shards ssd: heads [{lo}, {hi}) {err} from the whole call (largest {top})")
            errs.append(err)
    big = max(range(len(blocks)), key=lambda i: cuts[i + 1] - cuts[i])
    whole_work, block_work = ssd_work(b, s, h, p, n, q), ssd_work(b, s, cuts[big + 1] - cuts[big], p, n, q)
    whole_ms = time_ms(torch, {"whole": lambda *t: mamba2.ssd_chunked(*t, q)},
                       cold_sets((x, dt, a, bm, cm)))["whole"]
    block_ms = time_ms(torch, {"block": lambda *t: mamba2.ssd_chunked(*t, q)}, cold_sets(blocks[big]))["block"]
    row = {"case": f"mamba2-370m B={b} S={s} H={h} P={p} N={n} chunk={q} f32", "blocks": k,
           "heads_per_block": [hi - lo for lo, hi in zip(cuts, cuts[1:])], "max_abs_err": max(errs),
           "bit_equal_twice": True, "whole_ms": whole_ms, "block_ms": block_ms,
           "whole_bytes": whole_work[0], "whole_flops": whole_work[1],
           "block_bytes": block_work[0], "block_flops": block_work[1], "timed": "cold"}
    row["whole_bound_ms"], row["whole_bound_by"] = bound(*whole_work, "f32")
    row["block_bound_ms"], row["block_bound_by"] = bound(*block_work, "f32")
    log(f"[shards] ssd over {k} head blocks: whole call {whole_ms:.5f} ms (bound "
        f"{row['whole_bound_ms']:.5f} ms by {row['whole_bound_by']}), block {block_ms:.5f} ms (bound "
        f"{row['block_bound_ms']:.5f} ms), max err {row['max_abs_err']:.3g} | {card} | " + json.dumps(row))
    del x, dt, a, bm, cm, y, hf, y2, hf2, blocks
    return row


def shard_kv_proj(torch, cfg, card: str) -> dict:
    """14(j): ``SHARD_KV_PROJ``'s decode rows against wk and wv (d_model x
    KV * head dim) at full width in bf16, x unit-scale and the weights
    under the init law: the sum over the 16 d_model blocks of each block's
    partial (``sharding.contract_block``: f32, the reduction's dtype) held
    to the whole product at bf16 2e-2.  Timed cold: both whole products
    (the unsharded path's) and one block of each (a rank's work under the
    rule), beside their bounds, and the block with its operands cast to f32
    first (``cast``: the path under autograd, and the reference's compiled
    arithmetic)."""
    from repro_torch.distributed import sharding as sh

    rows, n = SHARD_KV_PROJ["rows"], SHARD_KV_PROJ["blocks"]
    d, cols = cfg.d_model, cfg.n_kv_heads * cfg.resolved_head_dim
    kb = d // n
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 30)
    x = torch.randn((rows, d), generator=gen, device="cuda").to(torch.bfloat16)
    wk, wv = (torch.randn((d, cols), generator=gen, device="cuda").mul_(d ** -0.5)
              .to(torch.bfloat16) for _ in range(2))

    def whole(x, wk, wv):
        return x @ wk, x @ wv

    def block(xb, wkb, wvb):
        return sh.contract_block(xb, wkb), sh.contract_block(xb, wvb)

    def cast(xb, wkb, wvb):
        return xb.float() @ wkb.float(), xb.float() @ wvb.float()

    want = whole(x, wk, wv)
    sums = [torch.zeros((rows, cols), device="cuda") for _ in range(2)]
    for i in range(n):
        for acc, part in zip(sums, block(x[:, i * kb:(i + 1) * kb], wk[i * kb:(i + 1) * kb],
                                         wv[i * kb:(i + 1) * kb])):
            acc += part
    errs = [max_err(torch, acc.to(torch.bfloat16), w, "bf16") for acc, w in zip(sums, want)]
    one = (x[:, :kb].contiguous(), wk[:kb].contiguous(), wv[:kb].contiguous())
    whole_ms = time_ms(torch, {"whole": whole}, cold_sets((x, wk, wv)))["whole"]
    block_ms = time_ms(torch, {"block": block, "cast": cast}, cold_sets(one))
    # each input read once, each output written once; two products of 2 rows x K x N
    whole_bytes = 2 * (rows * d + 2 * d * cols + 2 * rows * cols)
    block_bytes = 2 * (rows * kb + 2 * kb * cols) + 4 * 2 * rows * cols
    row = {"case": f"{cfg.name} x ({rows}, {d}) bf16 @ wk, wv ({d}, {cols}), {n} d_model blocks",
           "max_abs_err": max(errs), "whole_ms": whole_ms, "block_ms": block_ms["block"],
           "block_cast_ms": block_ms["cast"], "whole_bytes": whole_bytes,
           "block_bytes": block_bytes, "timed": "cold"}
    row["whole_bound_ms"], row["whole_bound_by"] = bound(whole_bytes, 4 * rows * d * cols, "bf16")
    row["block_bound_ms"], row["block_bound_by"] = bound(block_bytes, 4 * rows * kb * cols, "f32")
    log(f"[shards] kv projections over {n} d_model blocks: whole {whole_ms:.5f} ms (bound "
        f"{row['whole_bound_ms']:.5f} ms by {row['whole_bound_by']}), block {row['block_ms']:.5f} ms "
        f"(bound {row['block_bound_ms']:.5f} ms; operands cast first {row['block_cast_ms']:.5f} ms), "
        f"max err {row['max_abs_err']:.3g} | {card} | " + json.dumps(row))
    del x, wk, wv, want, sums, one
    return row


def _bf16_apart(torch, got, want) -> tuple[float, bool]:
    """The largest difference of two tensors and whether it is within
    bf16's 2e-2 (and 2e-2 of each value's magnitude) for floats, none for
    integers."""
    diff = (got.float() - want.float()).abs()
    if not want.is_floating_point():
        return float(diff.max()) if diff.numel() else 0.0, torch.equal(got, want)
    ok = bool((diff <= TOL["bf16"] + TOL["bf16"] * want.float().abs()).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def shard_serve_kv1(torch, np, ops, ref, TF, get_config, card: str) -> dict:
    """14(k): ``SHARD_SERVE_KV1``: granite-8b at full width cut to 2
    layers with one KV head under its 32 q heads, a prefill of 4 x 512 and
    3 decode steps in bf16, once unsharded and once through the one-rank
    NCCL mesh under its rules (the KV head, a size-1 dim, over the 1-way
    "model" axis in the spec and whole in the placements; the cache's
    sequence over "model", so each decode takes the flash-decoding path).
    First the decode kernel with lse at the path's shape (B 4, H 32, KV 1,
    S 515, D 128: four head groups of 8) against its plain version (out
    within bf16's 2e-2 of its largest magnitude, lse within 2e-2; uncounted;
    phase 2 holds the flash kernel at 4 x 512 x 32/1).  Then the run:
    logits and every cache leaf within bf16's 2e-2 of the unsharded run
    (bit-equality recorded), the launches of the sharded run exactly the
    path's (flash a layer per prefill, decode with lse a layer per step,
    the norms), and ``sharding.idle_contraction`` checked on every product
    and never applied (every axis has one rank).  The step's ms on the
    card's stream is logged beside the card."""
    from repro_torch.distributed import sharding as sh

    t = SHARD_SERVE_KV1
    cfg = get_config(t["arch"]).replace(n_layers=t["layers"], n_kv_heads=1)
    b, h, d, s = t["batch"], cfg.n_heads, cfg.resolved_head_dim, t["prompt"] + t["steps"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 31)
    q, kc, vc = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                 for shape in ((b, h, d), (b, 1, s, d), (b, 1, s, d)))
    lens = torch.tensor([1, 300, s - 2, s], dtype=torch.int32, device="cuda")
    kernel, plain = _slice_fns(ops, ref)
    with ops.uncounted():
        (out, lse), (want, want_lse) = kernel(q, kc, vc, lens), plain(q, kc, vc, lens)
    torch.cuda.synchronize()
    kernel_err = {"max_abs_err": max_err(torch, out, want, "bf16", scaled=True),
                  "lse_max_abs_err": max_err(torch, lse, want_lse, "bf16")}
    del q, kc, vc, out, lse, want, want_lse

    @contextlib.contextmanager
    def record():
        seen = {"idle": []}
        idle = sh.idle_contraction

        def recorded_idle(*a):
            seen["idle"].append(idle(*a))
            return seen["idle"][-1]

        sh.idle_contraction = recorded_idle
        try:
            yield seen
        finally:
            sh.idle_contraction = idle

    before = (ops.launch_counts(), ops.variant_counts()["decode_attention_lse"])
    plain_logits, got, placements, mesh_shape, seen, extra = _mesh_serve(
        torch, np, ops, TF, cfg, t, "k", record)
    counts = {k: v - before[0][k] for k, v in ops.launch_counts().items()}
    lse_launches = ops.variant_counts()["decode_attention_lse"] - before[1]
    want_counts = path_launches(cfg, 1, t["steps"])
    placed = [str(p) for p in placements]
    check(placements[1].is_shard(3), f"shards serve kv1: the cache's sequence is not over 'model': "
          f"{placed}")
    check(counts == want_counts and lse_launches == cfg.n_layers * t["steps"],
          f"shards serve kv1: launches {counts} ({lse_launches} with lse), not the path's "
          f"{want_counts} ({cfg.n_layers * t['steps']} with lse)")
    check(seen["idle"] and not any(seen["idle"]),
          f"shards serve kv1: the idle-axis contraction applied on a one-rank mesh: {seen['idle']}")
    errs, bit_equal = _logits_apart(torch, got, plain_logits, "shards serve kv1")
    plain_caches, got_caches = extra["caches"]
    check(set(plain_caches) == set(got_caches), f"shards serve kv1: cache leaves differ: "
          f"{sorted(plain_caches)} vs {sorted(got_caches)}")
    cache_err = {}
    for key, want in plain_caches.items():
        cache_err[key], ok = _bf16_apart(torch, got_caches[key], want)
        check(ok, f"shards serve kv1: cache leaf {key} {cache_err[key]} from the unsharded run")
        bit_equal = bit_equal and torch.equal(got_caches[key], want)
    step_ms = sorted(extra["step_ms"])[len(extra["step_ms"]) // 2]
    row = {"model": f"{cfg.name} n_kv_heads=1", "layers": cfg.n_layers, "mesh": mesh_shape,
           "cache": placed, "launches": counts, "decode_lse_launches": lse_launches,
           "idle_rule_checks": len(seen["idle"]), "max_abs_diff": errs, "cache_max_abs_diff": cache_err,
           "bit_equal": bit_equal, "decode_kernel_n_rep32": kernel_err,
           "step_ms": extra["step_ms"], "step_ms_median": step_ms}
    log(f"[shards] serve kv1: a sharded decode step {step_ms:.3f} ms on the card's stream (median of "
        f"{len(extra['step_ms'])}, CUDA events) | {card} | " + json.dumps(row))
    return row


def phase_shards(torch, np, ops, ref, TF, get_config, card: str) -> dict:
    """Phase 14: whole problems cut by hand into the blocks a mesh gives, on
    one card: (a) decode over 4 and 16 cache blocks merged, in bf16 and
    int8, and whisper's cross cache over 16 uneven blocks; (b) the flash
    forward over 4 q blocks at their offsets, in bf16 and f32; (c) the
    sharded decode of the model through a one-rank mesh; (d) the flash
    backward over 4 q blocks at their offsets, in bf16 and f32; (e) MLA's
    absorbed decode over latent cache blocks merged, bf16 and f32; (f)
    minicpm3-4b's sharded decode through the one-rank mesh, bit-equal; (g),
    (h) the MoE and SSM archs the same way, bit-equal, their block paths
    recorded; (i) mamba2's SSD scan over 16 head blocks; (j) nemotron's
    decode K/V projections over 16 d_model blocks, and (g)'s grok-1 pass
    bit-equal with the idle-axis rule never applied on the one-rank mesh;
    (k) granite-8b with one KV head through the one-rank mesh.
    The variants' launch counts are set to 0 before and read after;
    comparisons and timings are not counted."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    rows = {"decode": {}, "flash": {}, "flash_bwd": {}}
    for quant in (False, True):
        tag = "int8" if quant else "bf16"
        inputs = _shard_decode_inputs(torch, SHARD_DECODE, quant, SEED + 14)
        with ops.uncounted():
            whole_ms = time_ms(torch, {"whole": lambda q, k, v, lens, *sc: ops.decode_attention(
                q, k, v, lens, impl="kernel",
                **(dict(k_scale=sc[0], v_scale=sc[1]) if sc else {}))}, cold_sets(inputs))["whole"]
        for n in SHARD_CUTS:
            row = shard_decode(torch, ops, ref, f"granite B=8 S=32768 {tag}", inputs, n, True)
            row["whole_ms"] = whole_ms
            rows["decode"][(tag, n)] = row
            log(f"[shards] decode {tag} over {n} blocks: block {row['ms']:.5f} ms "
                f"(bound {row['bound_ms']:.5f} ms, plain {row['plain_ms']:.5f} ms), merge "
                f"{row['merge_ms']:.5f} ms, whole call {whole_ms:.5f} ms | {card} | " + json.dumps(row))
        del inputs
    inputs = _shard_decode_inputs(torch, SHARD_CROSS, False, SEED + 15)
    row = shard_decode(torch, ops, ref, "whisper-cross B=4 S=1500 bf16", inputs, 16, False)
    rows["decode"][("whisper-cross", 16)] = row
    log("[shards] decode " + json.dumps(row))
    del inputs
    for dt in ("bf16", "f32"):
        for case, shape in SHARD_FLASH.items():
            row = shard_flash(torch, ops, ref, case, dt, shape)
            rows["flash"][(dt, case.split()[0])] = row
            log(f"[shards] flash {dt} {case}: block at q_offset {row['block_q_offset']} "
                f"{row['ms']:.5f} ms (bound {row['bound_ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, "
                f"SDPA {row['library_ms']:.5f} ms), whole call {row['whole_ms']:.5f} ms | {card} | "
                + json.dumps(row))
            gc.collect()
            torch.cuda.empty_cache()
    rows["serve"] = shard_serve(torch, np, ops, TF, get_config)
    mcfg = get_config("minicpm3-4b")
    rows["mla"] = {}
    t0 = time.perf_counter()
    for dt in ("bf16", "f32"):
        rows["mla"].update(shard_mla_decode(torch, ops, mcfg, dt, card))
        gc.collect()
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    rows["serve_mla"] = shard_serve(torch, np, ops, TF, get_config, "minicpm3-4b")
    rows["mla_wall_s"] = [t1 - t0, time.perf_counter() - t1]  # (e), (f)
    t2 = time.perf_counter()
    rows["serve_families"] = {}
    for arch in SHARD_SERVE_FAMILIES:  # (g), (h)
        rows["serve_families"][arch] = shard_serve_family(torch, np, ops, TF, get_config, arch)
        gc.collect()
        torch.cuda.empty_cache()
    t3 = time.perf_counter()
    with ops.uncounted():
        rows["ssd"] = shard_ssd(torch, get_config("mamba2-370m"), card)  # (i)
    gc.collect()
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    rows["kv_proj"] = shard_kv_proj(torch, get_config(SHARD_KV_PROJ["arch"]), card)  # (j)
    grok = rows["serve_families"]["grok-1-314b"]
    check(grok["bit_equal"] and grok["idle_rule_checks"] > 0,
          f"shards: grok-1 through the one-rank mesh not bit-equal: {grok}")
    gc.collect()
    torch.cuda.empty_cache()
    t5 = time.perf_counter()
    rows["serve_kv1"] = shard_serve_kv1(torch, np, ops, ref, TF, get_config, card)  # (k)
    gc.collect()
    torch.cuda.empty_cache()
    # (g) and (h), (i), (j), (k)
    rows["family_wall_s"] = [t3 - t2, t4 - t3, t5 - t4, time.perf_counter() - t5]
    for dt in ("bf16", "f32"):
        for case, shape in SHARD_FLASH_BWD.items():
            row = shard_flash_bwd(torch, ops, ref, case, dt, shape)
            rows["flash_bwd"][(dt, case.split()[0])] = row
            log(f"[shards] flash backward {dt} {case}: block at q_offset {row['block_q_offset']} "
                f"{row['ms']:.5f} ms (bound {row['bound_ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, "
                f"SDPA {row['library_ms']:.5f} ms), whole call {row['whole_ms']:.5f} ms | {card} | "
                + json.dumps(row))
            gc.collect()
            torch.cuda.empty_cache()
    counts = ops.variant_counts()
    want = {"decode_attention_lse": sum(r["launches"] for r in rows["decode"].values())
            + rows["serve"]["decode_lse_launches"] + rows["serve_kv1"]["decode_lse_launches"]
            + sum(r["decode_lse_launches"] for r in rows["serve_families"].values()),
            "flash_attention_q_offset": sum(r["launches"] for r in rows["flash"].values())
            + sum(r["fwd_launches"] for r in rows["flash_bwd"].values()),
            "flash_attention_bwd_q_offset": sum(r["launches"] for r in rows["flash_bwd"].values())}
    check(counts == want, f"shards: variant launches {counts} != the phase's {want}")
    rows["launches"] = counts
    rows["wall_s"] = time.perf_counter() - t_phase
    log(f"[shards] phase passed in {rows['wall_s']:.1f} s ((e) {rows['mla_wall_s'][0]:.1f} s, (f) "
        f"{rows['mla_wall_s'][1]:.1f} s, (g) and (h) {rows['family_wall_s'][0]:.1f} s, (i) "
        f"{rows['family_wall_s'][1]:.1f} s, (j) {rows['family_wall_s'][2]:.1f} s, (k) "
        f"{rows['family_wall_s'][3]:.1f} s), launches {counts} | {card}")
    return rows


# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-dir", type=Path, default=None,
                    help="also write the nvcc logs and every measurement here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    dryrun_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    proc = start_dryrun(dryrun_dir)
    tool_procs = start_host_tools(HOST_TOOLS)
    example_procs = start_host_tools(EXAMPLE_HOST)
    try:
        build_s = _build.build()
        log(f"[build] {len(_build.SOURCES)} kernel libraries built in {build_s:.1f} s")
        if args.log_dir is not None:
            args.log_dir.mkdir(parents=True, exist_ok=True)
            for name in _build.SOURCES:
                if _build.log_path(name).exists():
                    shutil.copy(_build.log_path(name), args.log_dir / f"nvcc_{name}.log")
        fwd_build = fwd_build_report()
        fwd_build["decode_mma"] = decode_build_report()
        t0 = time.perf_counter()
        out, _ = proc.communicate(timeout=600)
        log(f"[dryrun] subprocess ended {time.perf_counter() - t0:.1f} s after the build "
            f"(exit {proc.returncode}); no phase ran beside it")
        dryrun = (proc.returncode, out, dryrun_dir)
        tools = {}
        for name, p in tool_procs.items():
            out, _ = p.communicate(timeout=300)
            tools[name] = (p.returncode, out)
        host13 = {}
        for name, p in example_procs.items():
            out, _ = p.communicate(timeout=300)
            host13[name] = (p.returncode, out)
        log(f"[tools] {len(tools) + len(host13)} host subprocesses ended "
            f"{time.perf_counter() - t0:.1f} s after the build")
        return _phases(args, torch, np, t_all, card, kind, build_s, fwd_build, dryrun, tools,
                       host13)
    finally:
        for p in (proc, *tool_procs.values(), *example_procs.values()):
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(dryrun_dir, ignore_errors=True)


def _phases(args, torch, np, t_all, card, kind, build_s, fwd_build, dryrun, tools,
            host13) -> int:
    from repro_torch.configs import get_config
    from repro_torch.core import live_scaling as live
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models import kvcache
    from repro_torch.models import transformer as TF
    from repro_torch.serving import disagg, maas
    from repro_torch.serving import engine as engine_mod
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_step as step_mod

    kern = phase_kernels(torch, ops, ref, card)
    cfg = get_config("granite-8b")
    mcfg = get_config("minicpm3-4b")
    qcfg = get_config("qwen1.5-4b")
    parity = {c.name: phase_parity(torch, np, ops, TF, c) for c in (cfg, qcfg, mcfg)}
    parity.update({f"{c.name} kv_quant": phase_parity(torch, np, ops, TF, c, kv_quant=True)
                   for c in (cfg, qcfg)})
    t0 = time.perf_counter()
    params = TF.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] granite-8b init: {cfg.approx_params()} params in {time.perf_counter() - t0:.1f} s")
    serve = phase_serve(torch, np, ops, TF, cfg, engine_mod, params)
    live_row = phase_live(torch, np, ops, TF, live, cfg, params)
    t0 = time.perf_counter()
    mparams = TF.init_params(mcfg, SEED + 1, device="cuda")
    torch.cuda.synchronize()
    log(f"[live] minicpm3-4b init: {mcfg.approx_params()} params in {time.perf_counter() - t0:.1f} s")
    live_mla = phase_live(torch, np, ops, TF, live, mcfg, mparams)
    prof = phase_profile(torch, np, cfg, engine_mod, params, serve["decode_step_ms_median"],
                         serve["ttft_idle_ms"], args.log_dir)
    cluster = phase_cluster(torch, np, ops, TF, cfg, params, serve_cli, disagg, engine_mod, tools,
                            args.log_dir)
    long_ctx = phase_long_context(torch, np, ops, TF, kvcache, cfg, params, engine_mod, args.log_dir)
    t0 = time.perf_counter()
    qparams = TF.init_params(qcfg, SEED + 2, device="cuda")
    torch.cuda.synchronize()
    log(f"[maas] qwen1.5-4b init: {qcfg.approx_params()} params in {time.perf_counter() - t0:.1f} s")
    fleet_row = phase_maas(
        torch, np, ops, TF, {"granite-8b": cfg, "qwen1.5-4b": qcfg, "minicpm3-4b": mcfg},
        {"granite-8b": params, "qwen1.5-4b": qparams, "minicpm3-4b": mparams},
        serve_cli, maas, disagg)
    # the runtimes' engines hold the params in reference cycles: collect them
    del params, mparams, qparams
    gc.collect()
    torch.cuda.empty_cache()
    families = phase_families(torch, np, ops, TF, get_config, live, serve_cli, disagg, engine_mod,
                              args.log_dir)
    last = phase_last_configs(torch, np, ops, TF, get_config, live, serve_cli, engine_mod,
                              args.log_dir)
    train = phase_train(torch, np, ops, ref, TF, get_config, train_cli, opt_mod, step_mod,
                        args.log_dir)
    mesh = phase_mesh(torch, ops, TF, get_config, train_cli, opt_mod, train["loop"], dryrun,
                      args.log_dir)
    examples = phase_examples(torch, ops, card, host13, args.log_dir)
    shards = phase_shards(torch, np, ops, ref, TF, get_config, card)

    line = {"kernels": []}
    for name, (source, replaces) in KERNELS.items():
        r = kern[(name, "bf16")]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": serve["launches"][name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    name, source, replaces = INT8_DECODE
    r = kern[(name, "bf16", "int8-long")]  # the shape phase 7b's int8 steps give it
    line["kernels"].append({
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": long_ctx["int8_decode_launches"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    })
    for name, source in BWD_KERNELS.items():
        r = train["kernels"][(name, "bf16")]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": None,
            "launches": train["loop"]["launches_total"][name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    for name, source, replaces, (kind_, dt, case) in SHARD_VARIANTS:
        r = shards[kind_][(dt, case)]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": shards["launches"][name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    if args.log_dir is not None:
        shard_rows = {k: [{"key": list(key), **r} for key, r in shards[k].items()]
                      for k in ("decode", "flash", "flash_bwd", "mla")}
        record = {"card": card, "torch": torch.__version__, "build_s": build_s,
                  "fwd_build": fwd_build, "kernels": [kern[k] for k in sorted(kern)], "parity": parity,
                  "serve": serve, "live": [live_row, live_mla], "profile": prof, "cluster": cluster,
                  "long_context": long_ctx,
                  "maas": fleet_row, "families": families, "last_configs": last,
                  "train": {**train, "kernels": [train["kernels"][k] for k in sorted(train["kernels"])]},
                  "mesh": mesh, "examples": examples,
                  "shards": {**shards, **shard_rows},
                  "wall_s": time.perf_counter() - t_all}
        (args.log_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1, default=str))
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
