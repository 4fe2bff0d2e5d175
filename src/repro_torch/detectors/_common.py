"""Argument normalization shared by the detector oracles."""
from __future__ import annotations

import torch

from repro_torch.kernels.ragged import vlen_vec

__all__ = ["valid_rows", "stack_rows"]


def valid_rows(valid_lens, t_len: int, c: int, device) -> torch.Tensor:
    """(T, C) bool: row t of channel c lies inside its valid prefix
    (`valid_lens` clamped to [0, T]; None means every row)."""
    vl, _ = vlen_vec(valid_lens, t_len, c, torch.float32, device)
    rows = torch.arange(t_len, dtype=torch.float32, device=device)
    return rows[:, None] < vl[None, :]


def stack_rows(rows, t_len: int, c: int, dtype, device) -> torch.Tensor:
    """Stack per-row (C,) outputs into (T, C); an empty (0, C) for T = 0."""
    if not rows:
        return torch.zeros((t_len, c), dtype=dtype, device=device)
    return torch.stack(rows)
