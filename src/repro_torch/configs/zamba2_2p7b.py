"""zamba2-2.7b [arXiv:2411.15242; hf].

54 Mamba2 layers d_model=2560, ssm_state=64, with a shared attention+MLP
block (32H kv=32, d_ff=10240) invoked every 6 SSM layers on
concat(x, embedding) — the zamba weight-sharing trick. Adaptation notes
in DESIGN.md (per-invocation LoRA deltas omitted).
"""
from repro_torch.models.common import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2_2p7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv=32, d_ff=10240,
        vocab=32000, head_dim=80, ssm_state=64, ssm_head_dim=64,
        ssm_expand=2, shared_period=6, ssm_chunk=128,
    )
