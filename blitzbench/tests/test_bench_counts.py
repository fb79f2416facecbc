"""The counts, pinned: the kernels' bounds at the shapes PERF.md times them
at, and a model step's FLOPs against a hand count for both configurations."""

import json
from pathlib import Path

import pytest

from blitzbench import counts
from blitzbench.reference.model import Spec

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
GRANITE = Spec.from_config(json.loads((CONFIGS / "granite-8b.json").read_text()))
OLMOE = Spec.from_config(json.loads((CONFIGS / "olmoe-1b-7b-port.json").read_text()))


def test_int8_decode_bound_at_16_slots_of_32k():
    rows = 15 * 32768 + 30001
    ms, by = counts.bound(*counts.decode_work(16, 32, 8, 128, rows, int8=True))
    assert by == "bytes" and round(ms, 5) == 0.32887


def test_flash_bound_at_512_tokens():
    ms, by = counts.bound(*counts.flash_fwd_work(1, 512, 512, 32, 8, 128))
    assert by == "bytes" and round(ms, 5) == 0.00313


def test_bf16_decode_bound_at_8_slots_of_32k():
    ms, _ = counts.bound(*counts.decode_work(8, 32, 8, 128, 7 * 32768 + 30001, int8=False))
    assert round(ms, 5) == 0.31718


def test_granite_step_flops_by_hand():
    per_layer = 4096 * 4096 * 2 + 4096 * 1024 * 2 + 3 * 4096 * 14336  # q, o; k, v; SwiGLU
    assert counts.layer_params(GRANITE) == per_layer == 218_103_808
    head = 2 * 4096 * 49152
    rows = [600, 1000]
    want = 2 * (36 * 2 * per_layer + head) + 36 * 4 * 32 * 128 * 1600
    assert counts.decode_flops(GRANITE, rows) == want


def test_olmoe_counts_routed_experts_only():
    attn = 2048 * 2048 * 4  # 16 heads and 16 KV heads of 128
    routed = 8 * 3 * 2048 * 1024 + 2048 * 64  # top 8 of 64 SwiGLU experts, and the router
    assert counts.layer_params(OLMOE) == attn + routed
    want = 16 * 2 * (attn + routed) + 2 * 2048 * 50304 + 16 * 4 * 16 * 128 * 300
    assert counts.decode_flops(OLMOE, [300]) == want


@pytest.mark.parametrize("s", [1, 2, 300])
def test_causal_pairs(s):
    _, flops = counts.flash_fwd_work(1, s, s, 1, 1, 1)
    assert flops == 4 * s * (s + 1) // 2
