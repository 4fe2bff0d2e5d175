"""Data pipeline: synthetic token streams + DAMADICS-like fault streams."""
from repro_torch.data.stream import PrefetchIterator, TokenStream, batch_stats
from repro_torch.data.damadics import (TABLE2, FaultWindow, base_signals,
                                       detection_report, inject,
                                       make_benchmark)

__all__ = ["PrefetchIterator", "TokenStream", "batch_stats", "TABLE2",
           "FaultWindow", "base_signals", "detection_report", "inject",
           "make_benchmark"]
