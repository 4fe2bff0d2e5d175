"""Shared model configuration covering all 10 assigned architectures.

One dataclass drives every family (dense / moe / ssm / hybrid / encdec /
vlm / audio backbones); family-specific fields are ignored elsewhere.
Configs in `repro_torch.configs` instantiate it with the exact published
values.  `cdtype` and `pdtype` are `torch.dtype`s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # attention variants
    rope_theta: float = 10000.0
    qkv_bias: bool = False  # qwen2
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    final_softcap: Optional[float] = None  # gemma2: 30.0
    window: Optional[int] = None  # sliding-window size (mixtral/starcoder2)
    local_global_period: int = 0  # gemma2: 2 => alternate local/global
    attn_scale: Optional[float] = None

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_chunk: int = 65536  # block-wise dispatch above this token count

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # hybrid (zamba2): a shared attention block every `shared_period` SSM
    # layers, reusing one set of attention weights (the zamba trick)
    shared_period: int = 0

    # xLSTM: one sLSTM block every `slstm_every` mLSTM blocks (0 = none)
    slstm_every: int = 0
    mlstm_proj_factor: float = 2.0

    # encoder-decoder
    enc_layers: int = 0
    dec_layers: int = 0
    tie_embeddings: bool = True

    # layer flavor
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm (starcoder2, seamless)
    mlp_act: str = "silu"  # silu | gelu
    mlp_gated: bool = True  # False: classic 2-matrix MLP

    # numerics / memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots | everything
    scan_layers: bool = True
    # two-level layer scan (sqrt-remat): outer_scan outer steps, each an
    # inner scan of n_groups/outer_scan checkpointed groups — shrinks the
    # saved-residual stack from n_groups to outer_scan (+inner transient)
    outer_scan: int = 0
    norm_eps: float = 1e-6

    # attention chunking (flash-style) — perf-tunable
    q_chunk: int = 512
    kv_chunk: int = 1024
    # chunked cross-entropy: logits are computed (and re-computed in the
    # backward) per sequence chunk, never materializing (B, S, V); 0 = off
    ce_chunk: int = 1024
    # KV-cache storage dtype (decode): bfloat16 | float8_e4m3fn (halves
    # long-context cache traffic; dequant on read)
    kv_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv, 1)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv=max(1, min(self.n_kv, 2)),
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            window=min(self.window, 64) if self.window else None,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=32,
            enc_layers=min(self.enc_layers, 2),
            dec_layers=min(self.dec_layers, 2),
            shared_period=2 if self.shared_period else 0,
            slstm_every=2 if self.slstm_every else 0,
            q_chunk=32,
            kv_chunk=64,
            remat=False,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


def vocab_padded(cfg: ModelConfig) -> int:
    """Embedding rows padded to a shardable multiple of 128 (production
    practice: seamless's 256206 would otherwise block vocab sharding and
    replicate multi-GB logits). The pad tail is masked in unembed."""
    return -(-cfg.vocab // 128) * 128


def param_count(cfg: ModelConfig) -> int:
    """Rough total parameter count (for 6ND roofline bookkeeping)."""
    d, h, kv, hd, ff, v = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                           cfg.d_ff, cfg.vocab)
    attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
    if cfg.family == "moe":
        mlp = cfg.n_experts * 3 * d * ff + d * cfg.n_experts
    elif cfg.family == "ssm":  # xlstm
        din = int(d * cfg.mlstm_proj_factor)
        mlp = 0
        attn = 2 * d * din + 3 * din * din // 1 + din * d  # per mLSTM block
    else:
        mlp = 3 * d * ff
    if cfg.family == "hybrid":
        d_in = cfg.ssm_expand * d
        ssm = d * (2 * d_in + 2 * cfg.n_heads * 0) + d_in * d
        per = ssm + 2 * d_in * cfg.ssm_state
        shared = attn + mlp
        n_shared = cfg.n_layers // max(cfg.shared_period, 1)
        return cfg.n_layers * per + shared * 1 + n_shared * 0 + 2 * v * d
    layers = cfg.enc_layers + cfg.dec_layers if cfg.family == "encdec" \
        else cfg.n_layers
    per = attn + mlp + 2 * d
    if cfg.family == "encdec":
        per = per + attn  # cross attention
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    return layers * per + emb


def active_param_count(cfg: ModelConfig) -> int:
    """Active-per-token parameters (MoE: top_k of n_experts)."""
    if cfg.family != "moe":
        return param_count(cfg)
    total = param_count(cfg)
    expert_p = cfg.n_experts * 3 * cfg.d_model * cfg.d_ff * cfg.n_layers
    active_p = cfg.top_k * 3 * cfg.d_model * cfg.d_ff * cfg.n_layers
    return total - expert_p + active_p
