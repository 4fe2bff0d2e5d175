"""repro_torch.launch — the serving layers over the engine.

`batching` is the continuous-batching scheduler (`BatchingScheduler`
over a `SlotPool`); `serve` is the detection gateway `serve_streams`
and its CLI (`python -m repro_torch.launch.serve --mode streams`).
"""
