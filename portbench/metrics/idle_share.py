"""Device: the share of the traced slice in which no device operation
ran (1 - the union of kernel intervals over the slice), in %.  The slice
is the mix's trace.dispatches consecutive dispatches after its
trace.skip_dispatches (traffic/<mix>.json)."""

import pb_trace


def read(run):
    sl = run.slice
    if sl is None or not sl.events:
        return None
    length = sl.t1 - sl.t0
    return 100.0 * (1.0 - pb_trace.busy_s(sl.events, sl.t0, sl.t1) / length)
