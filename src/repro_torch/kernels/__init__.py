"""The kernels: CUDA C++ sources in `csrc/`, built at first use by
`_build.py`; each wrapper module holds its kernel's plain PyTorch
version and launch count; `ops.py` is the contract layer."""
