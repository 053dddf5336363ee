from repro_torch.models.layers import RuntimeCfg, DEFAULT_RT, dense
from repro_torch.models.transformer import (
    PAGED_KINDS, prefill, decode_step, init_params, init_cache,
    init_paged_cache, paged_decode_step, forward, forward_hidden,
    params_shape, cache_shape,
)

__all__ = ["RuntimeCfg", "DEFAULT_RT", "dense", "prefill", "decode_step",
           "init_params", "init_cache", "PAGED_KINDS", "init_paged_cache",
           "paged_decode_step", "forward", "forward_hidden",
           "params_shape", "cache_shape"]
