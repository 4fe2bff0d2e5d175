"""TEDA core: the paper's Algorithm 1 as PyTorch functions, the data
clouds classifier and the training guard."""
from repro_torch.core.teda import (TedaOutput, TedaState, teda_init,
                                   teda_numpy_loop, teda_step, teda_stream,
                                   teda_threshold)
from repro_torch.core.scan import (linear_recurrence_scan, teda_scan,
                                   welford_combine)
from repro_torch.core.clouds import (CloudState, clouds_init, clouds_run,
                                     clouds_step)
from repro_torch.core.guard import (GuardConfig, GuardState, GuardVerdict,
                                    StragglerDetector, apply_guard,
                                    guard_init, guard_step)

__all__ = ["TedaOutput", "TedaState", "teda_init", "teda_step",
           "teda_stream", "teda_threshold", "teda_numpy_loop", "teda_scan",
           "linear_recurrence_scan", "welford_combine", "GuardConfig",
           "GuardState", "GuardVerdict", "StragglerDetector", "apply_guard",
           "guard_init", "guard_step", "CloudState", "clouds_init",
           "clouds_run", "clouds_step"]
