"""Admission to a batch row to the first committed token, 90th percentile
over every request of the window (the queue a round builds is the
benchmark's own batch submission, so it is left out)."""

import numpy as np


def read(run):
    xs = [r["ttft_s"] for r in run.requests if r["n_gen"] >= 1]
    return float(np.percentile(xs, 90)) * 1e3 if xs else None
