"""Kernels #1-#4: the DBB linears' bound (pb_roofline.dbb_bound_s, each
pass at its computed rows) over the device time of the kernels named
here, in the traced slice, in %."""

import pb_trace

KERNELS = ("dbb_int8_tc_kernel", "dbb_int8_generic_kernel", "epilogue_kernel",
           "dbb_tc_kernel", "dbb_bf16_kernel", "dbb_f32_kernel", "reduce_kernel")


def read(run):
    sl = run.slice
    if sl is None or not sl.events or run.slice_range is None:
        return None
    t = pb_trace.device_time(sl.events, sl.t0, sl.t1, pb_trace.kernel_matcher(KERNELS))
    if t <= 0:
        return None
    a, b = run.slice_range
    bound = 0.0
    for d in run.dispatches[a:b]:
        rows_per_pass = d["computed"] // d["passes"]
        bound += d["passes"] * run.roofline.dbb_bound_s(run.cfg, rows_per_pass)
    return 100.0 * bound / t
