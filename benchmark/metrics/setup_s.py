"""setup_s: from the process's start to the window's opening (host
clock): imports, the card's context, kernels built or loaded, weights and
traffic made, calibration, the warm-up of the cell's shapes."""


def read(ctx):
    return ctx.setup_s
