"""TEDA core: the paper's Algorithm 1 as PyTorch functions."""
from repro_torch.core.teda import (TedaOutput, TedaState, teda_init,
                                   teda_numpy_loop, teda_step, teda_stream,
                                   teda_threshold)
from repro_torch.core.scan import linear_recurrence_scan, teda_scan

__all__ = ["TedaOutput", "TedaState", "teda_init", "teda_step",
           "teda_stream", "teda_threshold", "teda_numpy_loop", "teda_scan",
           "linear_recurrence_scan"]
