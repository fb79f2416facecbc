"""The benchmark's plain reference against the port's plain path, on the CPU
at small widths in float32: the port's prefill and its decode steps through
the cache give the reference's teacher-forced logits, for a dense GQA
decoder, for OLMoE's block (dropless: the port's capacity at E / k), and for
the int8 cache filled from given keys and values as the long cell fills it.
The reference's rounding helpers are checked against their definitions."""

import numpy as np
import pytest
import torch

from blitzbench import weights as W
from blitzbench.reference import model as R
from blitzbench.reference.quant import fp8_round, kv_round
from repro_torch.models import kvcache
from repro_torch.models import transformer as TF

DENSE = {"name": "small-dense", "num_hidden_layers": 2, "hidden_size": 64,
         "num_attention_heads": 4, "num_key_value_heads": 2, "intermediate_size": 96,
         "vocab_size": 300, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
         "torch_dtype": "float32"}
MOE = {**DENSE, "name": "small-moe", "num_key_value_heads": 4, "intermediate_size": 32,
       "num_experts": 8, "num_experts_per_tok": 2, "norm_topk_prob": True,
       "deployment": {"capacity_factor": 4.0}}
TOL = dict(atol=1e-4, rtol=1e-4)


def _port_logits(cfg, params, prompt, fed, max_seq=64):
    """The port's prefill of ``prompt`` and a decode step for each fed token:
    (1 + len(fed), V) logits."""
    caches = TF.init_caches(cfg, 1, max_seq, device="cpu")
    logits, caches = TF.prefill_logits(cfg, params, prompt[None], caches)
    out = [logits[0]]
    for t in fed:
        logits, caches = TF.decode_logits(cfg, params, torch.tensor([t], dtype=torch.int32), caches)
        out.append(logits[0])
    return torch.stack(out)[:, : cfg.vocab_size]


@pytest.mark.parametrize("conf", [DENSE, MOE], ids=["dense_gqa", "olmoe_block"])
def test_reference_matches_the_port_prefill_and_decode(conf):
    cfg = W.port_config(conf)
    params = W.make_weights(conf, 7, "cpu")
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, conf["vocab_size"], 11), dtype=torch.int32)
    fed = [int(t) for t in rng.integers(0, conf["vocab_size"], 6)]
    got = _port_logits(cfg, params, prompt, fed)
    seq = torch.cat([prompt, torch.tensor(fed, dtype=torch.int32)]).long()
    rows = torch.arange(len(prompt) - 1, len(seq))
    want = R.forward(R.Spec.from_config(conf), params, seq, rows=rows)
    torch.testing.assert_close(got, want, **TOL)


def test_moe_reference_drops_nothing_and_weighs_by_renormalized_probability():
    """Every token gets exactly its top-k experts: one expert's output
    removed changes exactly the rows routed to it."""
    conf = MOE
    spec = R.Spec.from_config(conf)
    params = W.make_weights(conf, 3, "cpu")
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    h = torch.randn(40, conf["hidden_size"], generator=torch.Generator().manual_seed(1))
    full = R.moe(spec, lp, h, R._Products(False))
    order = torch.sort(-torch.softmax(h @ lp["router"], -1), dim=-1, stable=True).indices[:, :2]
    cut = dict(lp, w_down=lp["w_down"].clone())
    cut["w_down"][5] = 0
    part = R.moe(spec, cut, h, R._Products(False))
    routed = (order == 5).any(-1)
    assert torch.equal((full != part).any(-1), routed)


def test_int8_context_reference_matches_the_port_engine_cache():
    """The long cell's path at small width: keys and values given for a
    context of 40 positions, written into a 1-slot int8 cache by
    ``kvcache.write_prompt_kv``, then decode steps; the reference rounds the
    same keys and values to int8 itself."""
    conf = DENSE
    cfg = W.port_config(conf, kv_quant=True)
    params = W.make_weights(conf, 5, "cpu")
    spec = R.Spec.from_config(conf)
    n_ctx, kvh, hd = 40, conf["num_key_value_heads"], 16
    g = torch.Generator().manual_seed(2)
    ctx = [(2.5 * torch.randn(1, n_ctx, kvh, hd, generator=g), torch.randn(1, n_ctx, kvh, hd, generator=g))
           for _ in range(spec.n_layers)]
    caches = TF.init_caches(cfg, 1, 64, device="cpu")
    for i, (k, v) in enumerate(ctx):
        kvcache.write_prompt_kv(TF.layer_slice(caches["layers"], i), k, v,
                                torch.tensor([n_ctx], dtype=torch.int32))
    fed = [3, 17, 250, 9, 9]
    got = []
    for t in fed:
        logits, caches = TF.decode_logits(cfg, params, torch.tensor([t], dtype=torch.int32), caches)
        got.append(logits[0, : conf["vocab_size"]])
    want = R.forward(spec, params, torch.tensor(fed), n_ctx=n_ctx,
                     context=lambda i: (ctx[i][0][0], ctx[i][1][0]), kv="int8")
    torch.testing.assert_close(torch.stack(got), want, **TOL)


def test_kv_round_is_absmax_per_token_and_head():
    x = torch.tensor([[[1.0, -2.0, 0.5, 127.0]]])
    torch.testing.assert_close(kv_round(x, "int8"), torch.tensor([[[1.0, -2.0, 0.0, 127.0]]]))
    y = kv_round(torch.tensor([[7.0, 3.4, -1.6, 0.49]]), "int4")
    torch.testing.assert_close(y, torch.tensor([[7.0, 3.0, -2.0, 0.0]]))


def test_fp8_round_scales_each_row_to_e4m3():
    x = torch.tensor([[448.0, 1.0, 17.0], [0.5, -0.25, 0.0]])
    r = fp8_round(x, -1)
    assert r[0, 0] == 448.0 and r[0, 2] == 16.0  # e4m3 has 3 mantissa bits: 17 -> 16
    torch.testing.assert_close(r[1], x[1])
