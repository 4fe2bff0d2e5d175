"""mixtral-8x7b [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8 experts
top-2, sliding-window attention 4096.
"""
from repro_torch.models.common import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral_8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
        vocab=32000, head_dim=128, rope_theta=1000000.0,
        n_experts=8, top_k=2, window=4096,
    )
