"""setup_s: seconds from the process's start to the first timed call:
imports, bringing up the card, building or loading the kernels, making
the ring on the device, the engine and the warm-up calls."""


def read(ctx):
    return ctx["setup_s"]
