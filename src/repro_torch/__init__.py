"""repro_torch — the TEDA streaming detector in PyTorch, with CUDA
kernels written by hand for Hopper (sm_90a).

A port of the JAX package `repro`, module for module: `core/` (the
paper-faithful TEDA forms), `fixedpoint/` (the bit-accurate Q-format
datapath), `kernels/` (the CUDA kernels, their plain PyTorch versions
and the contract layer), `obs/` (metrics and tracing) and `engine/`
(the stateful multi-stream engine).  It imports neither JAX nor the JAX
package.  Entry points run on the CUDA device unless the caller passes
`device="cpu"`.
"""
