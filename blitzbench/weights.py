"""The served model as the benchmark makes it: the port's configuration from
a configuration file, and seeded weights on the device.

The weights are the benchmark's, handed alike to the program and to the
plain reference.  One stacked leaf is one ``torch.randn`` on the device, in
the dtype it is served in (the router in float32), from a generator seeded
by ``--seed``, with a fan-in law: a product's weight has std 1/sqrt(its
contracted width), the token embedding std 1, and the norms 1 + N(0, 0.1^2).
The port's own init law (std 1/sqrt(leading dim), 1/6 for every layer
weight of granite-8b) makes the attention softmax nearly one-hot, where one
rounding flips the row a query picks; under the fan-in law the scores are of
unit scale, as in a trained model, so a comparison of logits can tell bf16
from a lower precision.  Layouts are the port's parameter tree (stacked
layer axis first), which is the program's input format.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_config(path: Path) -> dict:
    conf = json.loads(Path(path).read_text())
    if conf.get("hidden_act", "silu") != "silu":
        raise ValueError(f"{path}: only SwiGLU (hidden_act silu) decoders are served here")
    return conf


def padded_vocab(vocab: int) -> int:
    """The port pads the vocab to a multiple of 512 (the tail is masked)."""
    return -(-vocab // 512) * 512


def port_config(conf: dict, **overrides):
    """The port's ``ModelConfig`` for a configuration file."""
    from repro_torch.models.config import ModelConfig

    dep = conf.get("deployment", {})
    h = conf["num_attention_heads"]
    experts = conf.get("num_experts", 0)
    fields = dict(
        name=conf["name"], family="moe" if experts else "dense",
        n_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"], n_heads=h,
        n_kv_heads=conf["num_key_value_heads"], head_dim=conf.get("head_dim"),
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"], mlp="swiglu", attn="gqa",
        rope_theta=float(conf["rope_theta"]), norm_eps=float(conf["rms_norm_eps"]),
        tie_embeddings=bool(conf.get("tie_word_embeddings", False)),
        n_experts=experts, top_k=conf.get("num_experts_per_tok", 0),
        dtype=DTYPES[conf.get("torch_dtype", "bfloat16")],
    )
    if experts:
        # dropless: a capacity of every token of the group in every expert
        fields["capacity_factor"] = float(dep["capacity_factor"])
    fields.update(overrides)
    return ModelConfig(**fields)


def seed_for(seed: int, *tags: int) -> int:
    """A 63-bit generator seed from --seed and integer tags."""
    return int(np.random.SeedSequence([int(seed) % 2**64, *tags]).generate_state(2, np.uint32)
               .astype(np.uint64) @ np.array([1, 2**32], np.uint64)) & (2**63 - 1)


def make_weights(conf: dict, seed: int, device) -> dict:
    """The port's parameter tree for ``conf``, drawn on ``device``."""
    dtype = DTYPES[conf.get("torch_dtype", "bfloat16")]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_for(seed, 1))
    L, d = conf["num_hidden_layers"], conf["hidden_size"]
    h, kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // h
    f, e = conf["intermediate_size"], conf.get("num_experts", 0)
    pv = padded_vocab(conf["vocab_size"])

    def normal(shape, fan_in, dt=dtype):
        t = torch.randn(shape, generator=gen, device=device, dtype=dt)
        return t.mul_(1.0 / math.sqrt(fan_in))

    def norm(shape):
        return (1.0 + 0.1 * torch.randn(shape, generator=gen, device=device)).to(dtype)

    lead = (L, e) if e else (L,)
    ffn = {"w_up": normal((*lead, d, f), d), "w_gate": normal((*lead, d, f), d),
           "w_down": normal((*lead, f, d), f)}
    if e:
        ffn["router"] = normal((L, d, e), d, torch.float32)
    layers = {
        "norm1": norm((L, d)), "norm2": norm((L, d)),
        "attn": {"wq": normal((L, d, h, hd), d), "wk": normal((L, d, kv, hd), d),
                 "wv": normal((L, d, kv, hd), d), "wo": normal((L, h, hd, d), h * hd)},
        "moe" if e else "mlp": ffn,
    }
    return {"embed": {"tok": normal((pv, d), 1), "unembed": normal((d, pv), d)},
            "layers": layers, "final_norm": norm((d,))}


def leaves(tree: dict) -> list[torch.Tensor]:
    out = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def fingerprint(tree: dict) -> list[float]:
    """One float64 sum of each leaf, in chunks of 2**24 elements: read before
    the window and after it, so that weights written by the program show."""
    out = []
    for t in leaves(tree):
        flat = t.reshape(-1)
        out.append(sum(float(c.sum(dtype=torch.float64)) for c in flat.split(1 << 24)))
    return out
