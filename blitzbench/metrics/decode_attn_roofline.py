"""The int8-cache decode kernel (``decode_int8_mma_kernel`` of
``kernels/csrc/decode_attention.cu``) against its byte bound, in %: over
the decode steps of the profiled slice, the summed bound of its launches
(one a layer over every live slot's cache rows: ``counts.decode_work``)
over their summed device time.  A step holding fewer records than layers
lost one to the profiler and is left out."""

from blitzbench.counts import bound, decode_work

KERNEL = "decode_int8_mma_kernel"


def read(run):
    sp = run.spec
    best = took = 0.0
    for span, start, end in run.annotated("decode"):
        recs = run.trace.inside(start, end, KERNEL)
        if len(recs) != sp.n_layers:
            continue
        rows = span.info["rows"]
        best += sp.n_layers * bound(*decode_work(len(rows), sp.n_heads, sp.n_kv_heads,
                                                 sp.head_dim, sum(rows), int8=True))[0]
        took += sum(e - b for b, e, _ in recs) / 1e6
    return 100 * best / took if took else None
