"""Set-up: process start to the window opening (imports, CUDA, the kernel
libraries, the weights drawn, the engine built and packed, the warm-up)."""


def read(run):
    return run.setup_s
