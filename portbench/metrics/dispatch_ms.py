"""Engine loop: the window's wall time over the engine's dispatches
(mixed steps and decode runs)."""


def read(run):
    return run.window_s / run.step_calls * 1e3 if run.step_calls else None
