"""qwen2-7b [arXiv:2407.10671; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064. QKV bias.
"""
from repro_torch.models.common import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2_7b", family="dense",
        n_layers=28, d_model=3584, n_heads=28, n_kv=4, d_ff=18944,
        vocab=152064, head_dim=128, rope_theta=1000000.0, qkv_bias=True,
    )
