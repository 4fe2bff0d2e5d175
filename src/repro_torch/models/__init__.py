"""The dense decoder LM: config, layers, attention, assembly, and the
carriers to and from the reference's parameter tree."""
from repro_torch.models.common import (ModelConfig, active_param_count,
                                       param_count, vocab_padded)
from repro_torch.models.convert import (lm_params_from_numpy,
                                        lm_params_to_numpy)
from repro_torch.models.transformer import (LM, BlockDef, block_layout,
                                            chunked_ce, init_lm_params,
                                            lm_backbone, lm_forward,
                                            lm_logits, lm_loss)

__all__ = [
    "ModelConfig", "active_param_count", "param_count", "vocab_padded",
    "LM", "BlockDef", "block_layout", "chunked_ce", "init_lm_params",
    "lm_backbone", "lm_forward", "lm_logits", "lm_loss",
    "lm_params_from_numpy", "lm_params_to_numpy",
]
