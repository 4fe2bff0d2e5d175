"""chameleon-34b — early-fusion VLM backbone [arXiv:2405.09818; unverified].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536. Image modality is
VQ tokens in the shared vocabulary, so the backbone is a dense decoder-only
LM; the VQ tokenizer frontend is a stub per assignment (input_specs feeds
token ids). Simplification noted in DESIGN.md: qk-norm omitted.
"""
from repro_torch.models.common import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="chameleon_34b", family="dense",
        n_layers=48, d_model=8192, n_heads=64, n_kv=8, d_ff=22016,
        vocab=65536, head_dim=128, rope_theta=10000.0,
        outer_scan=8,  # sqrt-remat: 48 groups -> 8 outer x 6 inner
    )
