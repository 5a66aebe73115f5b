"""Per request with two or more tokens, (last token's commit - first
token's commit) / (tokens - 1); 90th percentile over every such request
of the window."""

import numpy as np


def read(run):
    xs = [r["tpot_s"] for r in run.requests if r["tpot_s"] is not None]
    return float(np.percentile(xs, 90)) * 1e3 if xs else None
