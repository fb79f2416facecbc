"""The decode step's share of the card's bf16 peak: the model FLOPs of the
window's decode steps outside the profiled slice (``counts.decode_flops``
of each step's live slots and cache rows), over their host-clock time,
against 989 TFLOP/s, in %."""

from blitzbench.counts import PEAK_FLOPS, decode_flops


def read(run):
    dec = run.spans_of("decode")
    if not dec:
        return None
    flops = sum(decode_flops(run.spec, s.info["rows"]) for s in dec)
    return 100 * flops / sum(s.t1 - s.t0 for s in dec) / PEAK_FLOPS["bf16"]
