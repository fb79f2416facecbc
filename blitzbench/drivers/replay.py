"""The replay driver: one engine (``InstanceEngine``) holding a fixed set of
long sessions, decoding through the window.

Set-up builds the engine with the mix's cache (the int8 cache with
``kv_cache: int8``) and, for each session, a 1-slot cache of the engine's
length into which ``kvcache.write_prompt_kv`` writes the session's context:
keys and values drawn from the seed (``context_kv``, rotary embedding taken
as already applied, as a cache holds them), at the mix's ``k_std`` and
``v_std``; no prefill runs.  ``admit_prefilled`` splices each into a slot
(the first admission captures the decode step), with a first token from the
seed.  The window runs ``step`` until its seconds have passed; the tokens
it served are what the sessions' ``out_tokens`` grew by.  The check compares
the first ``head_tokens`` served tokens of every session.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from blitzbench import check, generate, harness
from blitzbench import weights as W
from blitzbench.drivers import common as C
from blitzbench.reference.model import Spec
from blitzbench.trace import Recorder, Slice


def context_kv(conf: dict, mix: dict, seed: int, layer: int, session: int, n: int, device):
    """One session's cached keys and values (1, n, KV, D) of one layer, in
    the served dtype."""
    gen = torch.Generator(device=device)
    gen.manual_seed(W.seed_for(seed, 2, layer, session))
    kv = conf["num_key_value_heads"]
    hd = conf.get("head_dim") or conf["hidden_size"] // conf["num_attention_heads"]
    dt = W.DTYPES[conf.get("torch_dtype", "bfloat16")]
    c = mix["context"]
    return tuple(torch.randn((1, n, kv, hd), generator=gen, device=device, dtype=dt).mul_(std)
                 for std in (c["k_std"], c["v_std"]))


def run(cell: harness.Cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, controls: dict | None = None) -> harness.Outcome:
    """One run; with ``controls`` (``check.readings``') also each control's
    reading on the same sample."""
    from repro_torch.models import kvcache
    from repro_torch.models import transformer as TF
    from repro_torch.serving.engine import InstanceEngine, ServeRequest

    conf, mix = cell.config, cell.traffic
    cfg = W.port_config(conf, kv_quant=mix["kv_cache"] == "int8")
    spec = Spec.from_config(conf)
    weights = W.make_weights(conf, seed, device)
    before = W.fingerprint(weights)
    lengths, firsts = generate.sessions(mix, seed, conf["vocab_size"])
    max_seq = mix["max_seq"]
    eng = InstanceEngine(cfg, weights, n_slots=mix["sessions"], max_seq=max_seq)
    reqs = []
    for s, (n, first) in enumerate(zip(lengths.tolist(), firsts.tolist())):
        one = TF.init_caches(cfg, 1, max_seq, device=device)
        for i in range(cfg.n_layers):
            k, v = context_kv(conf, mix, seed, i, s, n, device)
            kvcache.write_prompt_kv(TF.layer_slice(one["layers"], i), k, v,
                                    torch.tensor([n], dtype=torch.int32, device=device))
        req = ServeRequest(s, np.zeros(n, np.int32), max_seq - n - 8, out_tokens=[first])
        eng.admit_prefilled(req, first, one)
        reqs.append(req)
        del one, k, v
    for _ in range(mix["warm_steps"]):
        eng.step()
    rec, prof = Recorder(), None
    if trace:
        Slice.warm()
        s = cell.settings["trace_slice"]
        prof = Slice(s["start"] * seconds, s["seconds"])
        C.record_engine(rec)
    C.sync(device)
    setup_s = time.perf_counter() - t_start

    served_before = sum(len(r.out_tokens) for r in reqs)
    t0 = time.perf_counter()
    steps, now = 0, 0.0
    while now < seconds and eng.active:
        if prof is not None:
            prof.poll(now)
        eng.step()
        steps += 1
        now = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    rec.restore()
    tokens = sum(len(r.out_tokens) for r in reqs) - served_before
    C.note(f"[long] {steps} steps of {len(reqs)} sessions in {now:.3f} s; contexts "
           f"{sorted(lengths.tolist())}")
    dev = C.device_block(device, cell.chips, prof.read() if prof else None)
    finished = len(eng.active) != len(reqs)
    served = [check.Served(np.asarray([r.out_tokens[0]], np.int64), list(r.out_tokens[1:]),
                           n_ctx=int(n), key=r.rid) for r, n in zip(reqs, lengths.tolist())]
    del eng
    C.free(device)
    changed = C.changed_leaves(weights, before)
    samples = check.heads(served, cell.settings["head_tokens"])
    kind = None if mix["kv_cache"] == "bf16" else mix["kv_cache"]

    def context(i, key):
        return tuple(t[0] for t in context_kv(conf, mix, seed, i, key, int(lengths[key]), device))

    got, ctl = check.readings(spec, weights, samples, kv=kind, context=context,
                              controls=controls)
    C.note(f"[check] {got['requests']} sessions, {got['tokens']} served tokens compared")
    return harness.Outcome(
        metrics={"output_tokens_per_s": tokens / now, "setup_s": setup_s},
        attempted=len(reqs), failed=int(finished),
        checks={**{k: (got[k], lim) for k, lim in cell.settings["limits"].items()},
                "sessions_ended": (int(finished), 0), "weights_changed": (changed, 0)},
        device=dev,
        record=harness.RunRecord(cell, spec, rec.spans, prof.host if prof else None,
                                 prof.read() if prof else None),
        reading=got, control=ctl,
    )
