"""Models (counterpart of mxnet_tpu.models: GPT-2 serving and generation,
BERT MLM, Transformer NMT)."""
from .bert import (BertConfig, BertForMaskedLM, BertModel, bert_base_config,
                   bert_large_config)
from .convert import (init_params, load_gluon_params, load_jax_params,
                      load_jax_tree)
from .gpt2 import (AdapterBatch, GPT2Config, GPT2ForCausalLM, GPT2Model,
                   gpt2_774m_config, gpt2_medium_config, gpt2_small_config,
                   gpt2_xl_config)
from .kv_cache import (KVCache, PagedKVCache, gather_kv_pages,
                       scatter_kv_pages)
from .nmt import NMTConfig, TransformerNMT, nmt_base_config

__all__ = ["AdapterBatch", "BertConfig", "BertForMaskedLM", "BertModel", "GPT2Config",
           "GPT2ForCausalLM", "GPT2Model", "KVCache", "NMTConfig",
           "PagedKVCache", "TransformerNMT", "bert_base_config",
           "bert_large_config",
           "gpt2_774m_config", "gpt2_medium_config", "gpt2_small_config",
           "gpt2_xl_config", "init_params", "load_gluon_params",
           "load_jax_params", "load_jax_tree",
           "gather_kv_pages", "nmt_base_config", "scatter_kv_pages"]
