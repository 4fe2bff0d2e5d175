"""repro_torch — the TEDA streaming detector in PyTorch, with CUDA
kernels written by hand for Hopper (sm_90a).

A port of the JAX package `repro`, module for module: `core/` (the
paper-faithful TEDA forms, the scan sharded over time across devices,
the data clouds, the training guard),
`fixedpoint/` (the bit-accurate Q-format datapath), `kernels/` (the
CUDA kernels, their plain PyTorch versions and the contract layer),
`detectors/` (the ensemble), `obs/` (metrics and tracing), `engine/`
(the stateful multi-stream engine, its pools and shards), `sharding/`
(the channel split, the mesh axes and the pipeline), `launch/` (the
serving gateway, the training loop, meshes and the TEDA dry run), and
the training substrate: `models/` (the dense decoder LM), `configs/`,
`optim/`, `data/` and `checkpoint/`.  It imports neither JAX nor the JAX package.
Entry points run on the CUDA device unless the caller passes
`device="cpu"`.
"""
