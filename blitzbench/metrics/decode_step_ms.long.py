"""Mean decode step: the host clock around each ``InstanceEngine.step``
call (one graph replay, ending in ``tolist``), over the window's steps
outside the profiled slice, in ms."""


def read(run):
    steps = run.spans_of("decode")
    if not steps:
        return None
    return sum(s.t1 - s.t0 for s in steps) / len(steps) * 1e3
