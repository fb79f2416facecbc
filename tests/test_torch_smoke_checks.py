"""The launch-record check of ``chip_smoke.py`` (pure Python, no card): a
profiled window's kernel count may fall short only by device records the
profiler lost in that same window."""

import importlib.util
from pathlib import Path

import pytest

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def _ev(cat, name, corr):
    return {"ph": "X", "cat": cat, "name": name, "args": {"correlation": corr}}


def _graph_window(per_replay, drop=None):
    """3 replays of one graph whose records are ``per_replay``; ``drop`` =
    (replay, index) loses one record."""
    events = [{"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 1}]
    for r in range(3):
        events.append(_ev("cuda_runtime", "cudaGraphLaunch_v10000", 100 + r))
        events += [_ev("kernel", n, 100 + r) for i, n in enumerate(per_replay) if (r, i) != drop]
    return {"traceEvents": events}


def _eager_window(drop_record=False, no_launch=False):
    """4 kernel launches, two of them attention; a copy beside them."""
    events = [_ev("cuda_runtime", "cudaMemcpyAsync", 99), _ev("gpu_memcpy", "Memcpy DtoH", 99)]
    for i, name in enumerate(["gemm", "attn_kernel<128>", "add", "attn_kernel<128>"]):
        if no_launch and i == 3:
            continue
        api = "cudaLaunchKernelExC_v11060" if "attn" in name else "cudaLaunchKernel"
        events.append(_ev("cuda_runtime", api, i))
        if not (drop_record and i == 3):
            events.append(_ev("kernel", name, i))
    return {"traceEvents": events}


STEP = ["gemm", "attn_kernel<128>", "add", "attn_kernel<128>", "copy"]


@pytest.mark.parametrize("trace,units,want_lost", [
    (_graph_window(STEP), 3, 0),
    (_graph_window(STEP, drop=(1, 1)), 3, 1),  # the replay short one record: an attention one
    (_graph_window(STEP, drop=(2, 0)), 3, 1),  # a lost record that is not attention
    (_eager_window(), 1, 0),
    (_eager_window(drop_record=True), 1, 1),  # a launch call with no record
], ids=["graph", "graph-lost-attention", "graph-lost-other", "eager", "eager-lost"])
def test_check_launched_passes_a_full_or_lossy_window(trace, units, want_lost):
    got = cs.check_launched(cs._launch_record(trace), "attn_kernel", 2, units, "window")
    assert got["records_lost"] == want_lost
    assert got["launched"] == 2 * units


@pytest.mark.parametrize("trace,units", [
    (_graph_window(["gemm", "attn_kernel<128>", "add", "copy"]), 3),  # every replay one short
    (_graph_window(STEP + ["attn_kernel<128>"]), 3),  # one too many
    (_graph_window(STEP), 2),  # more replays than steps
    (_eager_window(no_launch=True), 1),  # never launched: no call, no record
], ids=["graph-short", "graph-excess", "graph-replays", "eager-short"])
def test_check_launched_fails_a_real_shortfall(trace, units):
    with pytest.raises(cs.SmokeFailure):
        cs.check_launched(cs._launch_record(trace), "attn_kernel", 2, units, "window")


def test_host_tools_are_the_cli_gates():
    """Phase 7's subprocesses: both report gates and the perfdiff self-diff."""
    assert set(cs.HOST_TOOLS) == {"report", "report_scale_ops", "perfdiff"}
    assert "--min-attribution" in cs.HOST_TOOLS["report"]
    assert "--min-makespan-attribution" in cs.HOST_TOOLS["report_scale_ops"]
    assert cs.HOST_TOOLS["perfdiff"][-2:] == ["benchmarks/baselines/smoke"] * 2


def test_host_tools_fail_on_a_non_zero_exit(tmp_path):
    ok = {"report": (0, "table\nattribution gate OK: all 9 requests >= 95%\n")}
    assert cs.phase_host_tools(ok, tmp_path)["report"]["last_line"].startswith("attribution gate OK")
    assert (tmp_path / "tool_report.log").read_text() == ok["report"][1]
    with pytest.raises(cs.SmokeFailure):
        cs.phase_host_tools({**ok, "perfdiff": (1, "PERF GATE: FAIL\n")}, None)


# ---------------------------------------------------------------------------
# phase 13: the checker, the import smoke and the examples
# ---------------------------------------------------------------------------

MAAS_TAIL = """   served at t=0.72s: cold-start TTFT 30ms (submitted t=0.64s), multicast source: O(1) host copy

fleet totals: 6 grants, 1 cold starts, 3 scale-to-zero events, 4.86 GPU-seconds occupied
"""


def test_maas_summary_parser_reads_the_cpu_runs_line():
    assert cs.parse_maas_summary(MAAS_TAIL) == cs.MAAS_SUMMARY
    assert cs.parse_maas_summary(MAAS_TAIL.replace("O(1) host copy", "GPU copy")) != cs.MAAS_SUMMARY
    assert cs.parse_maas_summary(MAAS_TAIL.replace("4.86", "4.87"))["gpu_seconds"] == "4.87"
    with pytest.raises(cs.SmokeFailure):
        cs.parse_maas_summary(MAAS_TAIL.splitlines()[0])


def test_serving_example_parsers():
    auto = ("live scaling:      all 16 requests in 4.83s\n"
            "stop-the-world:    all 16 requests in 0.08s\n\nZigZag vs best-effort ...\n")
    assert cs.parse_autoscale(auto) == {"live": {"served": 16, "wall_s": 4.83},
                                        "stop_the_world": {"served": 16, "wall_s": 0.08}}
    with pytest.raises(cs.SmokeFailure):
        cs.parse_autoscale(auto.splitlines()[0])
    disagg = ("[scale] retired decode dev 4\n\n"
              "served 32 requests in 12.03s  mean_ttft 29ms attainment 84%\n"
              "migrations 32  mutations 1 (param bytes moved: 0)  replacement live-scales 1  "
              "scale-downs 4  handoffs 31 gapped 1\n")
    assert cs.parse_disagg(disagg) == {"served": 32, "wall_s": 12.03, "migrations": 32,
                                       "mutations": 1, "live_scales": 1, "scale_downs": 4,
                                       "handoffs": 31, "gapped": 1}
    with pytest.raises(cs.SmokeFailure):
        cs.parse_disagg(disagg.splitlines()[2])


def test_train_example_parser():
    text = ("granite-100m: 99.9M params, batch 16 x seq 256\n"
            "resumed from step 100\n"
            "step  100  loss 7.0312  lr 1.04e-04  tok/s 878\n"
            "step  119  loss 6.9710  lr 6.00e-05  tok/s 34,534\n"
            "  checkpoint -> /tmp/x/step_00000100\n"
            "\nloss 7.031 -> 6.971 over 40 steps\n")
    got = cs.parse_train(text)
    assert got == {"steps": {100: {"loss": 7.0312, "tok_s": 878.0},
                             119: {"loss": 6.971, "tok_s": 34534.0}},
                   "resumed": 100, "checkpoints": 1}
    assert cs.parse_train(text.replace("resumed from step 100\n", ""))["resumed"] is None


@pytest.mark.parametrize("steps,want", [
    (120, {"rmsnorm": 3960, "flash_attention": 1920, "decode_attention": 0,
           "rmsnorm_bwd": 2040, "flash_attention_bwd": 960}),
    (40, {"rmsnorm": 1320, "flash_attention": 640, "decode_attention": 0,
          "rmsnorm_bwd": 680, "flash_attention_bwd": 320}),
])
def test_train_example_launch_arithmetic(steps, want):
    """train_100m's 8 layers, one microbatch, remat: per step flash 2L,
    rmsnorm 4L+1, flash_attention_bwd L, rmsnorm_bwd 2L+1."""
    assert cs.EXAMPLE_TRAIN["layers"] == 8
    assert cs.example_train_launches(steps) == want


def test_example_host_work_is_the_checker_the_smoke_and_two_examples():
    assert cs.EXAMPLE_HOST == {
        "simcheck": ["-m", "repro_torch.analysis.check", "src/repro_torch", "--baseline",
                     "analysis_baseline_torch.json"],
        "import_smoke": ["-m", "repro_torch.analysis.import_smoke", "src/repro_torch",
                         "examples_torch"],
        "quickstart": ["examples_torch/quickstart.py"],
        "net_scenarios": ["examples_torch/net_scenarios.py"],
    }
    assert set(cs.SERVE_EXAMPLES) | {"train_100m"} | {"quickstart", "net_scenarios"} == {
        p.stem for p in (Path(cs.ROOT) / "examples_torch").glob("*.py")}


def _host_outputs(n: int) -> dict:
    return {"simcheck": (0, "simcheck: clean\n"),
            "import_smoke": (0, f"import-smoke: {n} compiled, {n} imported, 0 failure(s)\n"),
            "quickstart": (0, "plan: 1 chain(s) in 0.10 ms\n  exact ILP   avg latency 15.7 (solved in 0.5 ms)\n"),
            "net_scenarios": (0, "...\n\nall five scenarios behaved as modelled\n")}


def test_example_host_checks_each_last_line(tmp_path):
    from repro_torch.analysis.import_smoke import iter_modules

    n = len(iter_modules(str(cs.ROOT / "src" / "repro_torch"))) + len(
        iter_modules(str(cs.ROOT / "examples_torch")))
    rows = cs.phase_example_host(_host_outputs(n), tmp_path)
    assert rows["modules_imported"] == n
    assert (tmp_path / "tool_simcheck.log").read_text() == "simcheck: clean\n"
    for name, bad in (("simcheck", (0, "simcheck: 1 finding(s) across 1 rule(s), 0 stale\n")),
                      ("import_smoke", (0, f"import-smoke: {n} compiled, {n - 1} imported, 1 failure(s)\n")),
                      ("net_scenarios", (1, "Traceback ...\n")),
                      ("quickstart", (0, "plan: 1 chain(s) in 0.10 ms\n"))):
        with pytest.raises(cs.SmokeFailure):
            cs.phase_example_host({**_host_outputs(n), name: bad}, None)


class _Rank:
    """One rank of a 1-D mesh of ``n``: what ``sharding.local_block`` reads."""

    def __init__(self, n, rank):
        self.n, self.rank = n, rank

    def get_coordinate(self):
        return [self.rank]

    def size(self, i):
        return self.n


@pytest.mark.parametrize("rows,n", [(32768, 4), (32768, 16), (1500, 16), (512, 4), (6, 4), (7, 4)])
def test_shard_blocks_are_the_mesh_blocks(rows, n):
    """Phase 14 cuts a whole problem where a mesh's ranks would hold it:
    block r is rank r's ``sharding.local_block`` (ceil chunks, uneven or
    empty at the tail)."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import sharding as sh

    starts = cs.block_starts(rows, n)
    for r in range(n):
        (blk,) = sh.local_block((rows,), _Rank(n, r), (Shard(0),))
        assert (blk.start, blk.stop) == (starts[r], starts[r + 1])


def test_flash_work_counts_each_blocks_causal_pairs():
    """The flash bound of a q block at its offset counts the causal pairs
    its rows see: the 4 blocks' FLOPs add up to the whole call's."""
    import torch

    q, k = torch.empty(1, 512, 4, 64), torch.empty(1, 512, 2, 64)
    whole = cs.work("flash_attention", (q, k, k), {"causal": True}, "bf16")[1]
    starts = cs.block_starts(512, 4)
    parts = [cs.work("flash_attention", (q[:, a:e], k, k), {"causal": True, "q_offset": a}, "bf16")[1]
             for a, e in zip(starts, starts[1:])]
    assert sum(parts) == whole and parts == sorted(parts)


def test_flash_bwd_work_counts_each_blocks_causal_pairs():
    """The backward's bound of a q block at its offset counts the causal
    pairs its rows see, as the forward's: the 4 blocks' FLOPs add up to the
    whole call's, the last block the heaviest."""
    import torch

    q, k = torch.empty(1, 512, 4, 64), torch.empty(1, 512, 2, 64)
    whole = cs.bwd_work("flash_attention_bwd", (q, k), {"causal": True}, "bf16")[1]
    starts = cs.block_starts(512, 4)
    parts = [cs.bwd_work("flash_attention_bwd", (q[:, a:e], k), {"causal": True, "q_offset": a},
                         "bf16")[1] for a, e in zip(starts, starts[1:])]
    assert sum(parts) == whole and parts == sorted(parts)


def test_kernel_line_lists_every_variant():
    """Phase 14's rows of the kernel line are the dispatch's variants, each
    from the source of its kernel."""
    from repro_torch.kernels import ops

    assert [name for name, *_ in cs.SHARD_VARIANTS] == list(ops.VARIANTS)
    for name, source, *_ in cs.SHARD_VARIANTS:
        mod, _ = ops.VARIANTS[name]
        assert Path(mod.__file__).stem in source


def test_mla_shard_cuts_are_the_mesh_blocks():
    """Phase 14(e) cuts minicpm3-4b's latent cache where the ranks of a 4-
    and a 16-way axis hold it (``sharding.local_block``), and by hand into
    uneven blocks of which exactly one is empty, each cut covering every
    row once."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import sharding as sh

    rows = cs.SHARD_MLA["s"]
    cuts = cs.mla_cuts(rows)
    for n in (4, 16):
        for r in range(n):
            (blk,) = sh.local_block((rows,), _Rank(n, r), (Shard(0),))
            assert (blk.start, blk.stop) == (cuts[n][r], cuts[n][r + 1])
    u = cuts["uneven"]
    sizes = [e - a for a, e in zip(u, u[1:])]
    assert u[0] == 0 and u[-1] == rows and min(sizes) == 0
    assert sizes.count(0) == 1 and len(set(sizes)) > 2


def test_mla_block_work_counts_the_latent_rows():
    """14(e)'s block bound counts the ckv and krope rows that hold a key
    (read once, in the cache's dtype) beside q_abs and q_rope read and ctx
    and lse written in f32: over the blocks of a cut, with an empty block
    and blocks past a row's length, the rows' bytes and the FLOPs add up
    to the whole cache's."""
    import torch

    b, h, r, rope, s = 3, 4, 16, 8, 40
    q_abs, q_rope, ckv, krope = (torch.empty(x, dtype=torch.bfloat16)
                                 for x in ((b, h, r), (b, h, rope), (b, s, r), (b, s, rope)))
    lens = torch.tensor([40, 13, 1])
    fixed = b * h * (r + rope) * 2 + 4 * b * h * (r + 1)
    nbytes, flops = cs.mla_block_work(q_abs, q_rope, ckv, krope, lens, 0)
    assert nbytes - fixed == 54 * (r + rope) * 2
    assert flops == 2 * h * 54 * (2 * r + rope)
    for cut in ([0, 10, 20, 30, 40], [0, 5, 5, 12, 40]):
        parts = [cs.mla_block_work(q_abs, q_rope, ckv[:, a:e], krope[:, a:e], lens, a)
                 for a, e in zip(cut, cut[1:])]
        assert sum(p[0] - fixed for p in parts) == nbytes - fixed
        assert sum(p[1] for p in parts) == flops


def test_ssd_work_counts_the_scans_products():
    """14(i)'s bound counts the SSD scan's products as torch's flop counter
    counts ``mamba2.ssd_chunked`` (its einsums), and its blocks of heads
    add up to the whole call: FLOPs exactly, bytes but for B and C, which
    every block reads whole."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import mamba2

    b, s, h, p, n, q = 2, 32, 4, 8, 6, 8
    args = (torch.randn(b, s, h, p), torch.rand(b, s, h), -torch.rand(h), torch.randn(b, s, 1, n),
            torch.randn(b, s, 1, n))
    with FlopCounterMode(display=False) as fc:
        mamba2.ssd_chunked(*args, q)
    nbytes, flops = cs.ssd_work(b, s, h, p, n, q)
    assert flops == fc.get_total_flops()
    cuts = cs.block_starts(h, 2)
    parts = [cs.ssd_work(b, s, e - a, p, n, q) for a, e in zip(cuts, cuts[1:])]
    assert sum(f for _, f in parts) == flops
    assert sum(nb for nb, _ in parts) - nbytes == 4 * 2 * b * s * n  # B and C read by both blocks


def test_family_serving_records_the_models_products():
    """14(g)'s recorder looks for the MoE's products by the equations the
    model writes (grok-1's down projection, olmoe's combine), and 14(h)'s
    archs are the SSM and hybrid families."""
    import inspect

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    src = inspect.getsource(moe)
    assert all(f'einsum("{eq}"' in src for eq in cs.MOE_CONTRACTED.values())
    fams = {a: get_config(a).family for a in cs.SHARD_SERVE_FAMILIES}
    assert fams == {"grok-1-314b": "moe", "olmoe-1b-7b": "moe", "mamba2-370m": "ssm",
                    "zamba2-2.7b": "hybrid"}
    cfg = get_config("zamba2-2.7b")
    assert cs.SHARD_SERVE_FAMILIES["zamba2-2.7b"] % cfg.attn_every == 0  # its shared block runs
