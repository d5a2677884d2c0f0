"""Models (counterpart of mxnet_tpu.models, serving subset)."""
from .convert import init_params, load_jax_params
from .gpt2 import (GPT2Config, GPT2ForCausalLM, GPT2Model, gpt2_774m_config,
                   gpt2_medium_config, gpt2_small_config, gpt2_xl_config)
from .kv_cache import KVCache, PagedKVCache

__all__ = ["GPT2Config", "GPT2ForCausalLM", "GPT2Model", "KVCache",
           "PagedKVCache",
           "gpt2_774m_config", "gpt2_medium_config", "gpt2_small_config",
           "gpt2_xl_config", "init_params", "load_jax_params"]
