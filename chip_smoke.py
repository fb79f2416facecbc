#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--log-dir DIR]

Run from the root of a checkout.  Phases, each of which must pass:

  1. build    the three hand-written kernels from src/repro_torch/kernels/csrc
  2. kernels  each kernel against its plain PyTorch version at the serving
              path's shapes and ragged ones, in bf16 and f32, timed beside its
              plain version, one PyTorch library call and its bound (decode
              attention with a cold L2, as the path finds it)
  3. parity   granite-8b at full width, 2 layers: the kernel path and the plain
              path agree over a 512-token prefill and 16 decode steps (f32:
              equal token ids; bf16: as close to the f32 run as the plain path)
  4. serve    granite-8b, 36 layers, bf16, random weights from a seed:
              InstanceEngine (4 slots, max_seq 1024) answers 8 requests of 512
              prompt tokens and 32 new tokens; launch counts must match the path
  5. live     cooperative_forward equals train_forward for k in {0, 1, 18, 36}
  6. profile  torch.profiler over 3 full-batch decode steps and over one idle
              512-token prefill: device time by kernel, the share of the step
              or of the TTFT the card is busy, and the attention kernels'
              launches per step / prefill

It prints one JSON ``kernels`` line and the card's name and power limit before
its last line, which is ``{"ok": true, "device": {...}}``.  It exits non-zero,
printing no result, without a CUDA device or outside a checkout.  With
``--log-dir`` it also writes the nvcc logs, every measurement and the
decode-step and prefill traces there.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # dense tensor-core bf16; f32 without tensor cores
TOL = {"f32": 3e-5, "bf16": 2e-2}  # tests/test_kernels.py:16-17
COLD_BYTES = 128e6  # rotating input copies of a cold timing: over 2.5x the H100's 50 MB L2
SEED = 0

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
    the serving shape, 604 MB per step), which comes from HBM."""
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


def max_err(torch, got, want, dt: str) -> float:
    """Max |got - want|; raises unless |got - want| <= tol + tol*|want| everywhere."""
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), "kernel output is not finite")
    diff = (g - w).abs()
    ok = bool((diff <= TOL[dt] + TOL[dt] * w.abs()).all())
    err = float(diff.max())
    check(ok, f"kernel disagrees with its plain version: max abs err {err} (tol {TOL[dt]})")
    return err


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

    return [
        ("rmsnorm", "main N=512 d=4096", lambda: (randn(512, 4096), randn(4096)), {}),
        ("rmsnorm", "ragged N=37 d=1001", lambda: (randn(37, 1001), randn(1001)), {}),
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
        ("decode_attention", "main B=4 H=32 KV=8 S=1024 D=128",
         lambda: (randn(4, 32, 128), randn(4, 8, 1024, 128), randn(4, 8, 1024, 128),
                  lens(1, 300, 517, 1024)), {}),
        ("decode_attention", "ragged S=1000 lengths 1..999",
         lambda: (randn(3, 32, 128), randn(3, 8, 1000, 128), randn(3, 8, 1000, 128),
                  lens(999, 1, 129)), {}),
        ("decode_attention", "lengths 0, S, 1, 65; n_rep 8; S=4096",
         lambda: (randn(4, 64, 128), randn(4, 8, 4096, 128), randn(4, 8, 4096, 128),
                  lens(0, 4096, 1, 65)), {}),
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
        pairs = sum(min(i + 1, sk) for i in range(sq)) if kw.get("causal", True) else sq * sk
        return (2 * b * sq * h * d + 2 * b * sk * kv * d) * es, 4 * b * h * d * pairs
    q, k, _, lengths = inputs
    b, h, d = q.shape
    kv = k.shape[1]
    rows = int(lengths.clamp(0, k.shape[2]).sum())
    return (2 * b * h * d + 2 * rows * kv * d) * es + 4 * b, 4 * h * d * rows


def library_call(torch, name: str, inputs, kw):
    """One PyTorch call computing the same function, as a function of an
    input set (timed only, never used by the port).  For decode attention the
    mask is built once: the cold copies share the lengths' values."""
    F = torch.nn.functional
    if name == "rmsnorm":
        return lambda x, w: F.rms_norm(x, (x.shape[-1],), w, 1e-5)
    if name == "flash_attention":
        return lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=kw.get("causal", True), enable_gqa=True)
    _, k, _, lengths = inputs
    mask = (torch.arange(k.shape[2], device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    return lambda q, k, v, _lengths: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)


def phase_kernels(torch, ops, ref) -> dict:
    kernel_fn = {"rmsnorm": ops.rmsnorm, "flash_attention": ops.flash_attention,
                 "decode_attention": ops.decode_attention}
    plain_fn = {"rmsnorm": ref.rmsnorm_ref, "flash_attention": ref.flash_attention_ref,
                "decode_attention": ref.decode_attention_ref}
    results = {}
    for dt in ("bf16", "f32"):
        for name, case, make, kw in kernel_cases(torch, dt):
            inputs = make()
            got = kernel_fn[name](*inputs, impl="kernel", **kw)
            torch.cuda.synchronize()
            want = plain_fn[name](*inputs, **kw)
            if name == "decode_attention":
                # a row of length 0 gives 0, as the TPU kernel's acc / max(l,
                # 1e-30) does; the plain oracle averages V there
                want[inputs[3] == 0] = 0
            err = max_err(torch, got, want, dt)
            row = {"kernel": name, "case": case, "dtype": dt, "max_abs_err": err}
            if case.startswith("main"):
                sets = cold_sets(inputs) if name == "decode_attention" else [inputs]
                times = time_ms(torch, {
                    "plain": lambda *a: plain_fn[name](*a, **kw),
                    "kernel": lambda *a: kernel_fn[name](*a, impl="kernel", **kw),
                    "library": library_call(torch, name, inputs, kw),
                }, sets)
                nbytes, flops = work(name, inputs, kw, dt)
                row.update(ms=times["kernel"], plain_ms=times["plain"],
                           library_ms=times["library"], bytes=nbytes, flops=flops,
                           timed="cold" if len(sets) > 1 else "warm", copies=len(sets))
                del sets
                row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dt)
                results[(name, dt)] = row
            log("[kernels] " + json.dumps(row))
            del inputs, got, want
    return results


# ---------------------------------------------------------------------------
# Phase 3: kernel path against plain path, whole model
# ---------------------------------------------------------------------------


def phase_parity(torch, np, ops, TF, base_cfg) -> dict:
    """Kernel path against plain path at full width, cut to 2 layers: a
    512-token prefill and 16 decode steps, every run fed the tokens that the
    f32 kernel path chooses.

    f32: the token ids must be equal.  bf16: the two paths round at other
    places (the plain decode casts the probabilities to bf16 as the reference
    does, the kernel keeps them in f32), and this random model's saturated
    softmax turns a one-ulp difference into logit differences of a few 1e-2.
    So each bf16 path is held against the f32 plain run of the same weights:
    the kernel path's mean error may exceed the plain path's by at most 5%,
    and the mean kernel-vs-plain difference must stay within 2e-2."""
    V = base_cfg.vocab_size
    prompt = np.random.default_rng(SEED).integers(0, V, size=(1, 512))
    tokens = torch.as_tensor(prompt.astype(np.int32), device="cuda")

    def run(cfg, params, impl, feed=None):
        own = feed is None
        feed = [] if own else feed
        with ops.use_impl(impl):
            caches = TF.init_caches(cfg, 1, 1024, device="cuda")
            logits, caches = TF.prefill_logits(cfg, params, tokens, caches)
            steps = [logits]
            for t in range(16):
                if own:
                    feed.append(logits.argmax(-1).to(torch.int32))
                logits, caches = TF.decode_logits(cfg, params, feed[t], caches)
                steps.append(logits)
        return torch.stack(steps)[:, 0, :V].float(), feed

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.to(torch.bfloat16)

    cfg32 = base_cfg.replace(n_layers=2, dtype=torch.float32)
    p32 = TF.init_params(cfg32, SEED, device="cuda")
    k32, feed = run(cfg32, p32, "kernel")
    r32, _ = run(cfg32, p32, "ref", feed)
    check(bool(torch.isfinite(k32).all()), "parity f32: logits not finite")
    k_ids, r_ids = k32.argmax(-1), r32.argmax(-1)
    top2 = r32.topk(2, dim=-1).values
    f32 = {"positions": int(k_ids.numel()), "ids_equal": bool(torch.equal(k_ids, r_ids)),
           "max_abs_logit_diff": float((k32 - r32).abs().max()),
           "min_top2_margin": float((top2[:, 0] - top2[:, 1]).min())}
    log("[parity] f32 " + json.dumps(f32))
    check(f32["ids_equal"], f"parity f32: token ids differ: {k_ids.tolist()} vs {r_ids.tolist()}")

    cfg16 = base_cfg.replace(n_layers=2, dtype=torch.bfloat16)
    p16 = cast(p32)
    del p32
    k16, _ = run(cfg16, p16, "kernel", feed)
    r16, _ = run(cfg16, p16, "ref", feed)
    check(bool(torch.isfinite(k16).all()), "parity bf16: logits not finite")
    diff = (k16 - r16).abs()
    bf16 = {"mean_abs_diff": float(diff.mean()), "max_abs_diff": float(diff.max()),
            "kernel_vs_f32_mean_err": float((k16 - r32).abs().mean()),
            "plain_vs_f32_mean_err": float((r16 - r32).abs().mean()),
            "kernel_vs_f32_max_err": float((k16 - r32).abs().max()),
            "plain_vs_f32_max_err": float((r16 - r32).abs().max())}
    log("[parity] bf16 " + json.dumps(bf16))
    check(bf16["kernel_vs_f32_mean_err"] <= 1.05 * bf16["plain_vs_f32_mean_err"],
          "parity bf16: the kernel path is less accurate than the plain path")
    check(bf16["mean_abs_diff"] <= 2e-2, "parity bf16: mean logit difference above 2e-2")
    del p16
    torch.cuda.empty_cache()
    return {"f32": f32, "bf16": bf16}


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
            "decode_attention": L * steps}
    check(counts == want, f"serve: launch counts {counts} != the path's {want}")
    check(all(v > 0 for v in counts.values()), f"serve: a kernel was not launched: {counts}")

    tok = torch.as_tensor(prompts[0][None], device="cuda")
    logits, _ = TF.prefill_logits(cfg, params, tok, TF.init_caches(cfg, 1, max_seq, device="cuda"))
    check(bool(torch.isfinite(logits[:, : cfg.vocab_size]).all()), "serve: logits not finite")

    step_ms = sorted(decode_step_ms)[len(decode_step_ms) // 2]
    row = {
        "requests": n_req, "prompt_tokens": prompt_len, "new_tokens": new_tokens,
        "n_slots": n_slots, "max_seq": max_seq, "layers": L, "decode_steps": steps,
        "ttft_idle_ms": sorted(ttft)[1], "wall_s": wall_s,
        "tokens_per_s": n_req * new_tokens / wall_s,
        "pure_decode_steps": len(decode_step_ms), "decode_step_ms_median": step_ms,
        "decode_tokens_per_s_full_batch": n_slots / (step_ms / 1e3),
        "peak_mem_gib": peak_gib, "launches": counts,
    }
    log("[serve] " + json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# Phase 5: live split
# ---------------------------------------------------------------------------


def phase_live(torch, np, ops, TF, live, cfg, params) -> dict:
    L = cfg.n_layers
    tokens = torch.as_tensor(
        np.random.default_rng(SEED + 2).integers(0, cfg.vocab_size, size=(1, 128)).astype(np.int32),
        device="cuda")
    ks = (0, 1, L // 2, L)
    ops.reset_launch_counts()
    full, _ = TF.train_forward(cfg, params, tokens)
    check(bool(torch.isfinite(full).all()), "live: logits not finite")
    errs = {}
    for k in ks:
        coop = live.cooperative_forward(cfg, params, tokens, k)
        diff = (coop.float() - full.float()).abs()
        errs[k] = float(diff.max())
        check(bool((diff <= 2e-2 + 2e-2 * full.float().abs()).all()),
              f"live: split k={k} differs from the monolithic forward by {errs[k]}")
    counts = ops.launch_counts()
    n = 1 + len(ks)
    want = {"rmsnorm": (2 * L + 1) * n, "flash_attention": L * n, "decode_attention": 0}
    check(counts == want, f"live: launch counts {counts} != the path's {want}")
    row = {"ks": list(ks), "max_abs_diff": errs, "launches": counts}
    log("[live] " + json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# Phase 6: where a decode step's and a prefill's time goes
# ---------------------------------------------------------------------------


LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def _traced(torch, fn, units: int, log_dir: Path | None, trace_name: str) -> tuple[list, float, dict]:
    """torch.profiler over ``fn()``: (kernels as (device us, name, launches)
    sorted by time, profiled wall ms per unit, the host's kernel-launch API
    calls per unit: count and CPU ms, the profiler's cost included)."""
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
    if log_dir is not None:
        prof.export_chrome_trace(str(log_dir / trace_name))
    return kernels, wall_ms / units, host


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
    kernel once per layer."""
    L = cfg.n_layers
    eng = engine_mod.InstanceEngine(cfg, params, n_slots=4, max_seq=1024)
    rng = np.random.default_rng(SEED + 3)
    for i in range(4):
        eng.submit(engine_mod.ServeRequest(i, rng.integers(0, cfg.vocab_size, 512).astype(np.int32), 64))
    eng.step()
    eng.step()

    def steps():
        for _ in range(3):
            eng.step()

    prompt = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
    rows = {}
    for what, fn, units, ref_ms, attn in (
        ("decode_step", steps, 3, step_ms, "decode_attention_kernel"),
        ("prefill", lambda: eng.prefill_only(engine_mod.ServeRequest(-9, prompt, 1)), 1, ttft_ms,
         "flash_fwd_sm90"),
    ):
        kernels, wall_ms, host = _traced(torch, fn, units, log_dir, f"{what}_trace.json")
        device_ms = sum(k[0] for k in kernels) / (units * 1e3)
        check(device_ms > 0, f"profile {what}: no device time recorded")
        launches = sum(n for _, k, n in kernels if attn in k) / units
        check(launches == L, f"profile {what}: {attn} launched {launches} times per unit, not {L}")
        rows[what] = {
            "units": units, "profiled_wall_ms": wall_ms, "device_ms": device_ms,
            "unprofiled_ms": ref_ms, "device_busy_share": device_ms / ref_ms,
            f"{attn}_launches": launches, "kernels_launched": sum(n for *_, n in kernels) / units,
            "host_launch_calls": host["launch_calls"], "host_launch_cpu_ms": host["launch_cpu_ms"],
            "top_kernels_ms": [[k[:90], round(us / (units * 1e3), 5), n / units]
                               for us, k, n in kernels[:14]],
        }
        log(f"[profile] {what} " + json.dumps(rows[what]))
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

    from repro_torch.configs import get_config
    from repro_torch.core import live_scaling as live
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models import transformer as TF
    from repro_torch.serving import engine as engine_mod

    t_all = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    build_s = _build.build()
    log(f"[build] {len(_build.SOURCES)} kernel libraries built in {build_s:.1f} s")
    if args.log_dir is not None:
        args.log_dir.mkdir(parents=True, exist_ok=True)
        for name in _build.SOURCES:
            if _build.log_path(name).exists():
                shutil.copy(_build.log_path(name), args.log_dir / f"nvcc_{name}.log")

    kern = phase_kernels(torch, ops, ref)
    cfg = get_config("granite-8b")
    parity = phase_parity(torch, np, ops, TF, cfg)
    t0 = time.perf_counter()
    params = TF.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] granite-8b init: {cfg.approx_params()} params in {time.perf_counter() - t0:.1f} s")
    serve = phase_serve(torch, np, ops, TF, cfg, engine_mod, params)
    live_row = phase_live(torch, np, ops, TF, live, cfg, params)
    prof = phase_profile(torch, np, cfg, engine_mod, params, serve["decode_step_ms_median"],
                         serve["ttft_idle_ms"], args.log_dir)

    line = {"kernels": []}
    for name, (source, replaces) in KERNELS.items():
        r = kern[(name, "bf16")]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": serve["launches"][name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    if args.log_dir is not None:
        record = {"card": card, "torch": torch.__version__, "build_s": build_s,
                  "kernels": [kern[k] for k in sorted(kern)], "parity": parity,
                  "serve": serve, "live": live_row, "profile": prof,
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
