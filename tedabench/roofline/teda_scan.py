"""Work of one launch of the float kernel (`csrc/teda_scan.cu`) in the
engine's verdict contract, counted from the contract's shapes.

Bytes: x read once (4 B a sample), ecc written once (4 B), the flag
written once (1 B); per channel the rows m, vlen, k, sum and var read
once and k, sum and var written once (8 rows of 4 B).  Operations:
Algorithm 1's 19 a sample (counter 2, sum, mean, difference, square,
(k-1)/k 2, variance 2, d2/k, 1/k, k var, d2/(k var), ecc, zeta, 2k,
threshold, two compares).
"""
KERNEL = "teda_scan_kernel"
OPS_PER_SAMPLE = 19
BYTES_PER_SAMPLE = 4 + 4 + 1
BYTES_PER_CHANNEL = 8 * 4


def work(t: int, c: int):
    """(bytes, operations) of one (T, C) launch."""
    return (t * c * BYTES_PER_SAMPLE + c * BYTES_PER_CHANNEL,
            t * c * OPS_PER_SAMPLE)
