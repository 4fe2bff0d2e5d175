"""Architecture registry: --arch <id> resolves here.

Each module in repro_torch.configs defines make_config() with the exact
published numbers (sources cited per-file) plus input-shape metadata.
"""
from __future__ import annotations

import importlib
from typing import List, NamedTuple

from repro_torch.models.common import ModelConfig

ARCHS: List[str] = [
    "chameleon_34b",
    "starcoder2_3b",
    "llama3_2_1b",
    "gemma2_2b",
    "qwen2_7b",
    "seamless_m4t_medium",
    "dbrx_132b",
    "mixtral_8x7b",
    "zamba2_2p7b",
    "xlstm_350m",
]

ALIASES = {
    "chameleon-34b": "chameleon_34b",
    "starcoder2-3b": "starcoder2_3b",
    "llama3.2-1b": "llama3_2_1b",
    "gemma2-2b": "gemma2_2b",
    "qwen2-7b": "qwen2_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "dbrx-132b": "dbrx_132b",
    "mixtral-8x7b": "mixtral_8x7b",
    "zamba2-2.7b": "zamba2_2p7b",
    "xlstm-350m": "xlstm_350m",
}


class ShapeSpec(NamedTuple):
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: List[ShapeSpec] = [
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
]

# long_500k requires sub-quadratic state; pure full-attention archs skip
# (DESIGN.md §Arch-applicability / long_500k handling)
LONG_OK = {"zamba2_2p7b", "xlstm_350m", "mixtral_8x7b", "starcoder2_3b",
           "gemma2_2b"}


def get_config(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch)
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.make_config()


def shape_specs(arch: str) -> List[ShapeSpec]:
    """The shape cells defined for this arch (40 total across the pool)."""
    arch = ALIASES.get(arch, arch)
    out = []
    for sp in SHAPES:
        if sp.name == "long_500k" and arch not in LONG_OK:
            continue
        out.append(sp)
    return out


def all_cells():
    for arch in ARCHS:
        for sp in SHAPES:
            skip = sp.name == "long_500k" and arch not in LONG_OK
            yield arch, sp, skip
