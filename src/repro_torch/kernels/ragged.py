"""Shared ragged-stream helpers.

One definition of the valid-length contract every kernel wrapper
speaks: per-channel valid-length normalization (`vlen_vec`, clamped to
[0, T]), verdict masking of ragged tails (`mask_ragged_rows`), and the
block-argument check (`norm_block_c`).  The CUDA kernels
take unpadded (T, C) tensors and mask their edges themselves, so there
is no layout padding here.
"""
from __future__ import annotations

import torch

__all__ = ["norm_block_c", "vlen_vec", "mask_ragged_rows"]


def norm_block_c(block_c) -> int:
    """Normalize the channel-block width to an int (0 = one strip).

    The kernels' results do not depend on it; it is validated as the
    reference validates it so the two packages accept the same
    arguments.
    """
    bc = int(block_c or 0)
    if bc and bc % 128 != 0:
        raise ValueError(f"block_c must be a multiple of 128, got {bc}")
    return bc


def vlen_vec(valid_lens, t_len: int, c: int, dtype, device):
    """Normalize `valid_lens` to a per-channel (C,) vector on `device`.

    Returns (vlen, ragged): `ragged` says the caller asked for a
    valid-length restriction at all (None means the whole chunk is
    valid for every channel).  Values are clamped to [0, T], so the
    final k always agrees with the state the carries hold.
    """
    if valid_lens is None:
        return torch.full((c,), t_len, dtype=dtype, device=device), False
    vl = torch.as_tensor(valid_lens, device=device).to(dtype)
    vl = vl.clamp(0, t_len).reshape(-1)
    return vl.expand(c) if vl.numel() == 1 else vl.reshape(c), True


def mask_ragged_rows(outlier, vlen, t_len: int):
    """No verdicts beyond a channel's valid length (eq (6) gate)."""
    rows = torch.arange(t_len, dtype=vlen.dtype,
                        device=vlen.device)[:, None]
    return outlier & (rows < vlen[None, :])
