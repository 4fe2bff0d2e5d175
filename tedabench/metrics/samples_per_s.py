"""samples_per_s: every sample whose verdict summary reached the host
in the timed window, over the window's whole time (first hand-over to
last summary)."""


def read(ctx):
    t = ctx["timed"]
    return t["samples"] / t["window_s"] if t["window_s"] > 0 else None
