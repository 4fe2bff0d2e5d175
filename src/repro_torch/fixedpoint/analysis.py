"""Word-length sweep: the bit-accurate simulation figures of the paper.

For each candidate `QFormat` the quantized datapath (`teda_q_stream`)
runs over a stream and is compared against the float64 software oracle
(`core.teda.teda_numpy_loop`): max/mean eccentricity error and the
fraction of identical outlier verdicts — the word-length against
detection-efficacy curve a hardware designer needs to pick WL/FL for
the FPGA.  Host-side analysis: it runs on the CPU.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.teda import teda_numpy_loop
from repro_torch.fixedpoint.qformat import QFormat
from repro_torch.fixedpoint.teda_q import teda_q_stream

__all__ = ["DEFAULT_FORMATS", "evaluate_format", "wordlength_sweep"]

# WL in {16, 24, 32} with the FL range a designer would actually sweep.
DEFAULT_FORMATS: List[QFormat] = [
    QFormat(16, 8), QFormat(16, 10), QFormat(16, 12),
    QFormat(24, 12), QFormat(24, 16), QFormat(24, 18),
    QFormat(32, 16), QFormat(32, 20), QFormat(32, 24),
]


def evaluate_format(x: np.ndarray, fmt: QFormat, m: float = 3.0,
                    ref: Optional[dict] = None) -> Dict[str, object]:
    """Run Q-TEDA on x (T, N) and score it against the float64 oracle.

    Metrics are over k >= 2 (eq (5) is undefined at k=1).  Verdict
    agreement counts exact outlier-flag equality; hit/miss counts
    summarize how disagreement splits.
    """
    x = np.asarray(x, np.float32)
    if ref is None:
        ref = teda_numpy_loop(x.astype(np.float64), m)
    _, out = teda_q_stream(torch.from_numpy(x), fmt, m)
    ecc_q = fmt.dequantize_np(out.ecc)
    flag_q = out.outlier.numpy().astype(bool)
    flag_ref = np.asarray(ref["outlier"], bool)
    sl = slice(1, None)  # k >= 2
    err = np.abs(ecc_q[sl] - ref["ecc"][sl])
    agree = float((flag_q[sl] == flag_ref[sl]).mean())
    return {
        "word_len": fmt.word_len,
        "frac_len": fmt.frac_len,
        "rounding": fmt.rounding,
        "label": fmt.label(),
        "resolution": fmt.resolution,
        "max_abs_err_ecc": float(err.max()),
        "mean_abs_err_ecc": float(err.mean()),
        "verdict_agreement": agree,
        "n_outliers_q": int(flag_q.sum()),
        "n_outliers_ref": int(flag_ref.sum()),
        "missed": int((flag_ref & ~flag_q).sum()),
        "spurious": int((~flag_ref & flag_q).sum()),
    }


def wordlength_sweep(x: np.ndarray,
                     formats: Optional[Sequence[QFormat]] = None,
                     m: float = 3.0) -> List[Dict[str, object]]:
    """Evaluate every format on one stream; oracle computed once."""
    formats = DEFAULT_FORMATS if formats is None else list(formats)
    x = np.asarray(x, np.float32)
    ref = teda_numpy_loop(x.astype(np.float64), m)
    return [evaluate_format(x, f.validate(), m, ref=ref) for f in formats]
