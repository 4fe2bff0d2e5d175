"""starcoder2-3b [arXiv:2402.19173; hf].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152. RoPE, sliding
window 4096, LayerNorm, classic (non-gated) GeLU MLP.
"""
from repro_torch.models.common import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2_3b", family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv=2, d_ff=12288,
        vocab=49152, head_dim=128, rope_theta=999999.0,
        window=4096, norm_type="layernorm", mlp_act="gelu",
        mlp_gated=False, qkv_bias=True,
    )
