"""Model step: host time inside lm.paged_step and lm.paged_decode_loop
per forward pass (a decode run of n steps is n passes)."""


def read(run):
    passes = sum(d["passes"] for d in run.dispatches)
    return sum(d["host_s"] for d in run.dispatches) / passes * 1e3 if passes else None
