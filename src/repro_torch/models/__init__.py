"""The model zoo: config, layers, attention, the decoder LM of every
decoder family (dense, MoE, the Mamba2 hybrid, xLSTM), the
encoder-decoder, their decode paths, and the carriers to and from the
reference's parameter and cache trees."""
from repro_torch.models.common import (ModelConfig, active_param_count,
                                       param_count, vocab_padded)
from repro_torch.models.attention import KVCache
from repro_torch.models.convert import (encdec_cache_from_numpy,
                                        encdec_cache_to_numpy,
                                        encdec_params_from_numpy,
                                        encdec_params_to_numpy,
                                        lm_cache_from_numpy,
                                        lm_cache_to_numpy,
                                        lm_params_from_numpy,
                                        lm_params_to_numpy)
from repro_torch.models.encdec import (EncDec, build_cross_cache,
                                       decode_train, encdec_decode_step,
                                       encdec_loss, encode,
                                       init_encdec_cache,
                                       init_encdec_params)
from repro_torch.models.ssm import SSMCache
from repro_torch.models.transformer import (LM, BlockDef, block_layout,
                                            chunked_ce, init_cache,
                                            init_lm_params, lm_backbone,
                                            lm_decode_step, lm_forward,
                                            lm_logits, lm_loss, lm_prefill)
from repro_torch.models.xlstm import MLSTMCache, SLSTMCache

__all__ = [
    "ModelConfig", "active_param_count", "param_count", "vocab_padded",
    "LM", "BlockDef", "block_layout", "chunked_ce", "init_lm_params",
    "lm_backbone", "lm_forward", "lm_logits", "lm_loss", "KVCache",
    "SSMCache", "MLSTMCache", "SLSTMCache", "init_cache",
    "lm_decode_step", "lm_prefill", "EncDec", "init_encdec_params",
    "encode", "decode_train", "encdec_loss", "init_encdec_cache",
    "build_cross_cache", "encdec_decode_step", "lm_params_from_numpy",
    "lm_params_to_numpy", "lm_cache_from_numpy", "lm_cache_to_numpy",
    "encdec_params_from_numpy", "encdec_params_to_numpy",
    "encdec_cache_from_numpy", "encdec_cache_to_numpy",
]
