"""What a driver needs beside its traffic: the spans it records around the
engine's calls, the device block of the result line, and the weights'
fingerprint check."""

from __future__ import annotations

import gc
import sys

import torch

from blitzbench import weights as W
from blitzbench.trace import Recorder


def rows_of(engine) -> list[int]:
    """Cache rows each live slot's next decode step attends over: its prompt
    (or context) and every token it has so far."""
    return [len(r.prompt) + len(r.out_tokens) for r in engine.active.values()]


def record_engine(rec: Recorder) -> None:
    """A span of each decode step, with its live slots' rows."""
    from repro_torch.serving.engine import InstanceEngine

    rec.wrap(InstanceEngine, "step", "decode", lambda eng: {"rows": rows_of(eng)})


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_block(device, n: int, trace=None) -> dict:
    """The result's ``device``: the card's name, the cards used, the peak of
    allocated memory, and, traced, the busy and the traced seconds."""
    dev = torch.device(device)
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": n, "memory_peak_bytes": 0}
    if trace is not None:
        out.update(busy_s=trace.busy_s(), window_s=trace.window_s)
    return out


def changed_leaves(weights: dict, before: list[float]) -> int:
    return sum(a != b for a, b in zip(W.fingerprint(weights), before))


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def note(msg: str) -> None:
    """An earlier line of standard output."""
    print(msg, flush=True)
    sys.stdout.flush()
