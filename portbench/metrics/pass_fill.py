"""Scheduler: tokens the requests needed fed (prompt chunks and generated
tokens fed back) over the rows the passes computed ([max_batch,
prefill_chunk] a mixed step, max_batch x n_steps a decode run), in %."""


def read(run):
    computed = sum(d["computed"] for d in run.dispatches)
    return 100.0 * sum(d["fed"] for d in run.dispatches) / computed if computed else None
