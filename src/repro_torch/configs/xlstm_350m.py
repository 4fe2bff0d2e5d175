"""xlstm-350m [arXiv:2405.04517; unverified].

24 xLSTM blocks d_model=1024 4H vocab=50304, d_ff=0 (no separate FFN:
mLSTM blocks carry an internal 2x up-projection). One sLSTM block every
4 blocks (mLSTM:sLSTM = 3:1).
"""
from repro_torch.models.common import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm_350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv=4, d_ff=0,
        vocab=50304, head_dim=256, slstm_every=4, mlstm_proj_factor=2.0,
        ssm_chunk=128,
    )
