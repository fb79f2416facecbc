"""The comparison that decides ``correct``: the served tokens against the plain
reference.

Once the window has closed and the program's state is freed, the first
``head_tokens`` served tokens of every request (``heads``) are run through
the reference, teacher-forced on the request's prompt or context and the
tokens the program served.  A served token's gap is how far its reference
logit lies below the reference's best at that position (0 where the
program picked the reference's own argmax).  The numbers a cell compares
(its ``limits``) are among the widest gap, the mean gap and the share of
tokens not the reference's first.  Each control reads the same numbers, at
the same positions, for the token that the reference in a lower precision
puts first.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blitzbench.reference import model as R


@dataclasses.dataclass
class Served:
    prompt: np.ndarray  # the tokens before the first served one
    tokens: list  # the served tokens, in order
    n_ctx: int = 0  # cached context before the prompt (the long cell)
    key: int = 0  # the context generator's session index


def heads(served: list[Served], n: int) -> list[Served]:
    """Every request that served a token, cut to its first ``n`` served
    tokens."""
    return [dataclasses.replace(s, tokens=s.tokens[:n]) for s in served if s.tokens]


def _logits(spec: R.Spec, weights: dict, s: Served, context, **kw) -> torch.Tensor:
    seq = torch.as_tensor(np.concatenate([s.prompt, np.asarray(s.tokens[:-1], np.int64)]),
                          dtype=torch.long)
    rows = torch.arange(len(s.prompt) - 1, len(seq))
    ctx = None if context is None else (lambda i: context(i, s.key))
    return R.forward(spec, weights, seq, rows=rows, n_ctx=s.n_ctx, context=ctx, **kw)


def gaps(ref: torch.Tensor, tokens) -> torch.Tensor:
    """Each position's gap: the best logit less the token's; +inf for a
    token outside the vocab."""
    t = torch.as_tensor(tokens, dtype=torch.long, device=ref.device)
    ok = (t >= 0) & (t < ref.shape[-1])
    picked = ref.gather(-1, t.clamp(0, ref.shape[-1] - 1)[:, None])[:, 0]
    return torch.where(ok, ref.amax(-1) - picked, torch.full_like(picked, float("inf")))


def _numbers(g: list, n_req: int) -> dict:
    """The widest gap, the mean gap, and the share of tokens that are not
    the reference's first (gap above 0), over every compared position; no
    position compared reads as infinite."""
    if not g:
        return {"gap": float("inf"), "mean_gap": float("inf"), "mismatch": float("inf"),
                "tokens": 0, "requests": n_req}
    g = torch.cat(g)
    return {"gap": float(g.max()), "mean_gap": float(g.mean()),
            "mismatch": float((g > 0).float().mean()), "tokens": int(g.numel()),
            "requests": n_req}


def readings(spec: R.Spec, weights: dict, samples: list[Served], *, context=None,
             kv: str | None = None, controls: dict | None = None) -> tuple[dict, dict]:
    """The numbers (``_numbers``) of the served tokens' gaps, and of each
    control's: for ``controls[name]`` (``fp8=True`` or ``kv="int4"``), the gap
    of the token that the reference so computed puts first at each position
    of ``samples``, read in the reference's logits."""
    controls = controls or {}
    got, low = [], {name: [] for name in controls}
    for s in samples:
        ref = _logits(spec, weights, s, context, kv=kv)
        got.append(gaps(ref, s.tokens))
        for name, kw in controls.items():
            low[name].append(gaps(ref, _logits(spec, weights, s, context,
                                               **{"kv": kv, **kw}).argmax(-1)))
        del ref
    n = len(samples)
    return _numbers(got, n), {name: _numbers(g, n) for name, g in low.items()}
