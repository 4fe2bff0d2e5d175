"""The dense decoder LM: config, layers, attention, assembly, the
decode path (KV cache, one-token step, prefill), and the carriers to
and from the reference's parameter and cache trees."""
from repro_torch.models.common import (ModelConfig, active_param_count,
                                       param_count, vocab_padded)
from repro_torch.models.attention import KVCache
from repro_torch.models.convert import (lm_cache_from_numpy,
                                        lm_cache_to_numpy,
                                        lm_params_from_numpy,
                                        lm_params_to_numpy)
from repro_torch.models.transformer import (LM, BlockDef, block_layout,
                                            chunked_ce, init_cache,
                                            init_lm_params, lm_backbone,
                                            lm_decode_step, lm_forward,
                                            lm_logits, lm_loss, lm_prefill)

__all__ = [
    "ModelConfig", "active_param_count", "param_count", "vocab_padded",
    "LM", "BlockDef", "block_layout", "chunked_ce", "init_lm_params",
    "lm_backbone", "lm_forward", "lm_logits", "lm_loss", "KVCache",
    "init_cache", "lm_decode_step", "lm_prefill", "lm_params_from_numpy",
    "lm_params_to_numpy", "lm_cache_from_numpy", "lm_cache_to_numpy",
]
