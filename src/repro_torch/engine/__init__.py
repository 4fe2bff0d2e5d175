"""repro_torch.engine — the stateful multi-stream TEDA engine.

`StreamEngine` carries exact per-stream state across arbitrary-length
chunks for every registered backend ("scan", "cuda", "cuda-q"), with
ragged multi-tenant attach/detach/reset slots; `SlotPool` keeps one
engine per capacity bucket and re-pads the state across them.
"""
from repro_torch.engine.state import (EngineState, engine_attach,
                                      engine_detach, engine_init,
                                      engine_process, engine_reset,
                                      engine_state_from_numpy, engine_step,
                                      slot_mask)
from repro_torch.engine.backends import (Backend, get_backend,
                                         list_backends, register_backend)
from repro_torch.engine.engine import StreamEngine
from repro_torch.engine.pool import PoolFull, SlotPool

__all__ = [
    "Backend", "get_backend", "list_backends", "register_backend",
    "EngineState", "StreamEngine", "SlotPool", "PoolFull",
    "engine_init", "engine_process", "engine_step", "engine_reset",
    "engine_attach", "engine_detach", "engine_state_from_numpy",
    "slot_mask",
]
