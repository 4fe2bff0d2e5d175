"""Bit-accurate fixed-point emulation of the paper's FPGA datapath:
`QFormat` with saturating add/sub/mul and the bit-serial divider
(`qformat.py`), Algorithm 1 in Q-format ops (`teda_q.py`), and the
word-length sweep against the float64 oracle (`analysis.py`)."""
from repro_torch.fixedpoint.analysis import (DEFAULT_FORMATS,
                                             evaluate_format,
                                             wordlength_sweep)
from repro_torch.fixedpoint.qformat import (QFormat, div_qi, div_qq, sat,
                                            sat_add, sat_mul, sat_sub)
from repro_torch.fixedpoint.teda_q import (msq1_const, teda_q_init,
                                           teda_q_scan_chan, teda_q_step,
                                           teda_q_stream)

__all__ = ["QFormat", "sat", "sat_add", "sat_sub", "sat_mul", "div_qq",
           "div_qi", "msq1_const", "teda_q_init", "teda_q_step",
           "teda_q_stream", "teda_q_scan_chan", "DEFAULT_FORMATS",
           "evaluate_format", "wordlength_sweep"]
