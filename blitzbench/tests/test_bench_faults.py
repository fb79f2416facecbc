"""A run with its timed path broken underneath comes out not correct.

Each cell's driver runs here on the CPU at a small width (the port's plain
path), with the cell's own sessions, limits and compared tokens, past the
look for a card: sound it is correct; with each fault that a serving cell
can have planted in the program it is not.  The faults: a decode step that leaves the cache as it
was (no append, the length kept); half of the batch left out (every other
slot not decoded); a token altered where the engine produces it.  A cell on
one card exchanges nothing between cards, so that fault has no place here.
"""

import time

import pytest
import torch

from blitzbench import harness
from blitzbench.drivers import replay
from repro_torch.models import kvcache
from repro_torch.models import transformer as TF
from repro_torch.serving.engine import InstanceEngine

SMALL = {"name": "small", "num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 2, "intermediate_size": 96, "vocab_size": 300,
         "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "torch_dtype": "bfloat16"}


def _cell(name: str) -> harness.Cell:
    """The cell at the small width: its settings, limits and session count,
    its contexts short."""
    cell = harness.load_cell(name)
    conf = dict(SMALL)
    if "num_experts" in cell.config:
        conf.update(num_experts=8, num_experts_per_tok=2,
                    norm_topk_prob=cell.config["norm_topk_prob"],
                    deployment=cell.config["deployment"])
    mix = {**cell.traffic, "max_seq": 1200, "warm_steps": 1,
           "context": {**cell.traffic["context"], "lo": 40, "hi": 60}}
    return harness.Cell(cell.name, 1, conf, mix, cell.settings, [], [])


def _correct(cell: harness.Cell, seconds: float) -> bool:
    out = replay.run(cell, seed=2**31 + 3, seconds=seconds, trace=False, device="cpu",
                     t_start=time.perf_counter())
    assert out.reading["requests"] == cell.traffic["sessions"]
    assert out.reading["tokens"] > 0
    return harness.result_line(cell, out, False)["correct"]


def _unchanged_state(monkeypatch):
    monkeypatch.setattr(kvcache, "append_kv", lambda cache, k, v, live=None: cache)


def _half_batch(monkeypatch):
    def decode_half(self):
        live = self.slot_live.clone()
        live[1::2] = False
        nxt, _ = TF.decode_step(self.cfg, self.params, self.last_tokens, self.caches, live)
        self.last_tokens.copy_(torch.where(live, nxt, self.last_tokens))

    monkeypatch.setattr(InstanceEngine, "_decode_all", decode_half)


def _altered_token(monkeypatch):
    step = InstanceEngine.step

    def altered_step(self):
        out = step(self)
        for r in list(self.active.values())[:1] + out[:1]:
            r.out_tokens[-1] = (r.out_tokens[-1] + 1) % self.cfg.vocab_size
        return out

    monkeypatch.setattr(InstanceEngine, "step", altered_step)


CELLS = {"granite-8b.long32k": 1.0, "olmoe-1b-7b-port.long32k": 1.0}
FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_token": _altered_token}


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    assert _correct(_cell(name), CELLS[name])


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_run_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    assert not _correct(_cell(name), CELLS[name])
