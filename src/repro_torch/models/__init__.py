from repro_torch.models.layers import RuntimeCfg, DEFAULT_RT, dense
from repro_torch.models.transformer import (
    prefill, decode_step, init_params, init_cache,
)

__all__ = ["RuntimeCfg", "DEFAULT_RT", "dense", "prefill", "decode_step",
           "init_params", "init_cache"]
