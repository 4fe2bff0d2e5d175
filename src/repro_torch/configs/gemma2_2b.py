"""gemma2-2b [arXiv:2408.00118; hf].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, head_dim=256.
Alternating local(4096)/global attention, attn softcap 50, final softcap
30, sandwich norms, GeGLU.
"""
from repro_torch.models.common import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2_2b", family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv=4, d_ff=9216,
        vocab=256000, head_dim=256, rope_theta=10000.0,
        attn_softcap=50.0, final_softcap=30.0,
        window=4096, local_global_period=2, mlp_act="gelu",
        attn_scale=256 ** -0.5,
    )
