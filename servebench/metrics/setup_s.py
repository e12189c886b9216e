"""Set-up seconds: process start to the window's opening (imports, weights
drawn on the card, kernels loaded or built, warm-up)."""


def read(run):
    return run.setup_s
