"""Operations and bytes that the served work needs, and the card's peaks.

Counted from the shapes of what the inputs need, not from what the program
does: a kernel reads each input byte once and writes each output byte once;
causal attention takes its (q, k) pairs at or below the diagonal; a decode
step counts the live slots and the cache rows each reads; an MoE token
counts its routed experts only (and the router), not every expert the
program runs.  ``bound`` and the kernels' counts are ``chip_smoke.py``'s
``bound`` and ``work``.
"""

from __future__ import annotations

from blitzbench.reference.model import Spec

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # dense tensor-core bf16; f32 without tensor cores


def bound(nbytes: float, flops: float, dt: str = "bf16") -> tuple[float, str]:
    """The least ms the card could take, and which of bytes or operations
    sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def flash_fwd_work(b: int, sq: int, sk: int, h: int, kv: int, d: int, *, causal: bool = True,
                   es: int = 2) -> tuple[float, float]:
    """(bytes, flops) of one flash forward: q, k, v read and out written once;
    4 h d flops a (q, k) pair."""
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    return (2 * b * sq * h * d + 2 * b * sk * kv * d) * es, 4 * b * h * d * pairs


def decode_work(b: int, h: int, kv: int, d: int, rows: int, *, int8: bool,
                es: int = 2) -> tuple[float, float]:
    """(bytes, flops) of one decode-attention call over ``rows`` valid cache
    rows in all: q read and out written, each row's K and V (and their f32
    scales in an int8 cache) read once, and the int32 lengths."""
    row = kv * (2 * d + 8) if int8 else 2 * kv * d * es
    return 2 * b * h * d * es + rows * row + 4 * b, 4 * h * d * rows


def layer_params(spec: Spec) -> int:
    """Weights one token multiplies by in one layer: the attention
    projections and the MLP, or the router and its top-k experts."""
    d, hd = spec.d_model, spec.head_dim
    attn = d * spec.n_heads * hd * 2 + d * spec.n_kv_heads * hd * 2
    if spec.n_experts:
        return attn + d * spec.n_experts + spec.top_k * 3 * d * spec.d_ff
    return attn + 3 * d * spec.d_ff


def decode_flops(spec: Spec, rows: list[int]) -> float:
    """One decode step of the live slots, slot i attending over rows[i]
    cache rows."""
    per_token = spec.n_layers * 2 * layer_params(spec) + 2 * spec.d_model * spec.vocab_size
    attn = spec.n_layers * 4 * spec.n_heads * spec.head_dim * sum(rows)
    return len(rows) * per_token + attn
