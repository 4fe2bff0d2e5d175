"""seamless-m4t-medium backbone [arXiv:2308.11596; hf].

12L+12L enc-dec, d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
Audio frontend is a stub per assignment: the encoder consumes precomputed
frame embeddings (B, S_src, d). LayerNorm + non-gated GeLU MLP.
"""
from repro_torch.models.common import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="seamless_m4t_medium", family="encdec",
        n_layers=24, enc_layers=12, dec_layers=12,
        d_model=1024, n_heads=16, n_kv=16, d_ff=4096,
        vocab=256206, head_dim=64, norm_type="layernorm",
        mlp_act="gelu", mlp_gated=False,
    )
