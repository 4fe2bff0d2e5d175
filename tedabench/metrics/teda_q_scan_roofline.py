"""teda_q_scan_roofline: the Q kernel's share of its roofline: the
least time its work needs on the chip (roofline/teda_q_scan.py) over
its profiled device time per launch."""
from tedabench.rooflines import share


def read(ctx):
    return share(ctx, "teda_q_scan")
