"""Work of one launch of the Q kernel (`csrc/teda_q_scan.cu`) in the
engine's verdict contract, counted from the contract's shapes.

Bytes: x read once (a 4 B word a sample), ecc written once (4 B), the
flag written once (1 B); per channel the rows msq1, vlen, k, mean and
var read once and k, mean and var written once (8 rows of 4 B).
Operations: Algorithm 1's 19 a sample, as for the float kernel: the
count is the algorithm's, whatever instructions a divider takes.
"""
KERNEL = "teda_q_scan_kernel"
OPS_PER_SAMPLE = 19
BYTES_PER_SAMPLE = 4 + 4 + 1
BYTES_PER_CHANNEL = 8 * 4


def work(t: int, c: int):
    """(bytes, operations) of one (T, C) launch."""
    return (t * c * BYTES_PER_SAMPLE + c * BYTES_PER_CHANNEL,
            t * c * OPS_PER_SAMPLE)
