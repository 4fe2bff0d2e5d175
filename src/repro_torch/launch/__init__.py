"""repro_torch.launch — the serving layers over the engine, and training.

`batching` is the continuous-batching scheduler (`BatchingScheduler`
over a `SlotPool`); `serve` is the detection gateway `serve_streams`
and its CLI (`python -m repro_torch.launch.serve --mode streams`);
`train` is the TEDA-guarded training loop and its CLI (`python -m
repro_torch.launch.train`), over the step that `specs` builds; `specs`
also builds the (arch x shape x mesh) cells.  `mesh` builds meshes and
their process groups, `cost_analysis` counts collectives, operations
and bytes against the H100's roofline, `teda_dryrun` costs the
time-sharded TEDA scan on the production meshes (`python -m
repro_torch.launch.teda_dryrun`), `dryrun` every model cell (`python -m
repro_torch.launch.dryrun`) and `hillclimb` one cell under a named
change.
"""
