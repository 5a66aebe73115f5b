"""Tokens generated in the window's rounds over the window's whole wall time."""


def read(run):
    return run.gen_tokens / run.window_s
