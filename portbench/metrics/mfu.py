"""Model step: the model work of the tokens fed over the window's wall
time times the wire's peak (int8 1979 TOP/s, bf16 989 TFLOP/s), in %.
The work is counted from the configuration and the tokens
(pb_roofline.model_work), never from launches or padded rows."""


def read(run):
    rf = run.roofline
    rows = [row for d in run.dispatches for row in d["rows"]]
    if not rows:
        return None
    work = rf.model_work(run.cfg, rows, sum(d["sampled"] for d in run.dispatches))
    return 100.0 * work / (run.window_s * rf.peak_ops(run.cfg))
