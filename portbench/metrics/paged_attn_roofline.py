"""Kernel #6: paged attention's bound (pb_roofline.attn_bound_s: each
row's context and the KV dtype) over the device time of the kernels named
here, in the traced slice, in %."""

import pb_trace

KERNELS = ("paged_attn_kernel", "paged_attn_combine", "paged_attn_tc_kernel",
           "paged_attn_latent_tc_kernel")


def read(run):
    sl = run.slice
    if sl is None or not sl.events or run.slice_range is None:
        return None
    t = pb_trace.device_time(sl.events, sl.t0, sl.t1, pb_trace.kernel_matcher(KERNELS))
    if t <= 0:
        return None
    e = run.mix["engine"]
    ps, b = e["page_size"], e["max_batch"]
    pages = -(-e["max_seq"] // ps)
    bound = 0.0
    lo, hi = run.slice_range
    for d in run.dispatches[lo:hi]:
        if d["kind"] == "step":
            bound += run.roofline.attn_bound_s(run.cfg, d["rows"], ps, b, e["prefill_chunk"],
                                               pages)
        else:
            for i in range(d["passes"]):
                rows = [(p0 + i, 1) for p0, _ in d["rows"]]
                bound += run.roofline.attn_bound_s(run.cfg, rows, ps, b, 1, pages)
    return 100.0 * bound / t
