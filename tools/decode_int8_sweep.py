#!/usr/bin/env python3
"""Sweep the decode kernel's launch shape on the int8 cache under a bf16 q, on one card.

    python3 tools/decode_int8_sweep.py [--cases int8-long int8-long16 ...] [--json FILE] [--sass FILE]

For each of chip_smoke.py's phase 2 int8 cases named (by the first word of
the case: main, int8-grok, int8-nemotron, int8-whisper, int8-zamba2,
int8-long, int8-long16; default the two 32k ones), the tensor-core route
run under the plan ``decode_plan`` gives it on this card and under others:
clusters of 1 to 8 CTAs, each with one chunk a CTA and with chunks of 64
and 128 rows (a ring of the kernel's 3 stages, or as many as a CTA has
chunks) where a CTA's shared memory allows.  Each held
to the wrapper's own output (bf16's 2e-2 of its largest magnitude: another
split sums in another order) and timed cold (``chip_smoke.time_ms``) beside
its byte bound and the clusters the card holds at once
(``cudaOccupancyMaxActiveClusters``).  Also the opcode counts of
``decode_int8_mma_kernel<128>``'s SASS (cuobjdump).  Needs a CUDA device;
prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))


def sass_opcodes(lib: Path, nvcc: str, kernel: str, out: Path | None = None) -> dict:
    """Opcode -> count in ``kernel``'s SASS (its text into ``out``, if given)."""
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, inside, text = collections.Counter(), False, []
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        if inside:
            text.append(line)
        if inside and "/*" in line and ";" in line and "Function :" not in line:
            op = line.split("*/", 1)[1].strip().split()
            if op:
                counts[op[0].split(".")[0] if not op[0].startswith("@") else op[1].split(".")[0]] += 1
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("\n".join(text))
    return dict(counts.most_common())


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="*", default=["int8-long", "int8-long16"])
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--sass", type=Path, default=None, help="also write the D = 128 kernel's SASS here")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dk

    card = cs.card_line()
    _build.build(("decode_attention",))
    ops = sass_opcodes(_build.lib_path("decode_attention"), _build._nvcc(), "decode_int8_mma_kernelILi128E",
                       args.sass)
    print(f"decode_int8_mma_kernel<128> SASS: {sum(ops.values())} instructions {json.dumps(ops)}")
    fit = dk.clusters_fit_on(torch.cuda.current_device())
    default_plan = dk.decode_plan
    cases = {case.split()[0]: (case, make) for name, case, make, _ in cs.kernel_cases(torch, "bf16")
             if name == "decode_attention_int8"}
    rows = []
    for tag in args.cases:
        case, make = cases[tag]
        inputs = make()
        q, kq = inputs[0], inputs[1]
        b, h, d = q.shape
        kv, s = kq.shape[1], kq.shape[2]
        nbytes, flops = cs.work("decode_attention_int8", inputs, {}, "bf16")
        bound_ms, _ = cs.bound(nbytes, flops, "bf16")

        def run(q, k, v, lengths, k_scale, v_scale):
            return dk.decode_attention(q, k, v, lengths, k_scale=k_scale, v_scale=v_scale)

        want = run(*inputs)
        sets = cs.cold_sets(inputs)
        groups = dk.head_groups(h // kv)
        plans = [("decode_plan", default_plan(b, kv, s, d, 1, h // kv, mma=True, clusters_fit=fit))]
        for c in range(1, dk.MAX_CLUSTER + 1):
            for chunk in sorted({16 * -(-(-(-s // c)) // 16), 64, 128}):  # one chunk a CTA, 64, 128
                n = -(-s // chunk)
                cluster = min(c, n)
                per = -(-n // cluster)
                ring = min(dk.MMA_STAGES, per)
                smem = dk.mma_smem(d, chunk, ring)
                if cluster == c and smem <= dk.SMEM_PER_BLOCK:
                    plans.append((f"cluster {c} chunk {chunk}", dk.DecodePlan(
                        groups, c, chunk, per, (c, kv * groups, b), ring, smem)))
        for name, plan in plans:
            dk.decode_plan = lambda *a, _p=plan, **k: _p
            try:
                got = run(*inputs)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                cs.check(err <= cs.TOL["bf16"] * float(want.float().abs().max()),
                         f"{name}: max abs diff {err} from the wrapper's output")
                ms = cs.time_ms(torch, {"k": run}, sets)["k"]
            finally:
                dk.decode_plan = default_plan
            at_once = fit(d, plan.chunk, plan.ring, plan.cluster)
            row = {"case": case, "plan": name, "cluster": plan.cluster, "chunk": plan.chunk,
                   "ring": plan.ring, "smem": plan.smem, "ctas": plan.cluster * kv * groups * b,
                   "clusters": kv * groups * b, "max_active_clusters": at_once, "ms": ms,
                   "bound_ms": bound_ms, "bound_share": bound_ms / ms, "max_abs_diff": err}
            rows.append(row)
            print(f"{tag}, {name} (cluster {plan.cluster} chunk {plan.chunk} ring {plan.ring}): "
                  f"{ms:.5f} ms, {100 * bound_ms / ms:.1f}% of the byte bound {bound_ms:.5f} ms "
                  f"({row['ctas']} CTAs of {plan.smem} B; {row['clusters']} clusters, {at_once} at "
                  f"once) | {card}", flush=True)
        del sets, inputs, want
        torch.cuda.empty_cache()
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "sass": ops, "rows": rows}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
