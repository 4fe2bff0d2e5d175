"""dbrx-132b [hf:databricks/dbrx-base; unverified].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
fine-grained MoE: 16 experts, top-4.
"""
from repro_torch.models.common import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx_132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv=8, d_ff=10752,
        vocab=100352, head_dim=128, rope_theta=500000.0,
        n_experts=16, top_k=4,
        outer_scan=5,  # sqrt-remat: 40 groups -> 5 outer x 8 inner
    )
