"""Continuous-batching serving (counterpart of mxnet_tpu.serving: the
engine, its pools and caches, the host KV tier, the robustness layer,
the in-process multi-replica router and the HTTP frontend over an
engine or a router). The cross-process fleet is the `fleet`
subpackage."""
from .adapters import (AdapterPool, AdapterPoolExhausted, merged_weights,
                       random_lora)
from .engine import ServingEngine
from .faults import FaultError, FaultPlan, ReplicaFaultPlan
from .frontend import ServingFrontend, TokenStream
from .host_tier import HostPagePool
from .page_pool import PagePool, PagePoolExhausted
from .policy import SheddingPolicy
from .prefix_cache import PrefixCache
from .router import ServingRouter
from .sampling import filtered_logits, sample_tokens
from .scheduler import (TERMINAL_STATUSES, QueueFullError, RejectedError,
                        Request, ShedError, SlotScheduler, TenantQuota,
                        TenantQuotaError)
from .speculative import PromptLookupProposer, verify_tokens
from .weight_quant import (QuantizedWeight, build_weight_plan, dequantize,
                           pick_out_tile, quantize_weight)

__all__ = ["ServingEngine", "PagePool", "PagePoolExhausted", "PrefixCache",
           "filtered_logits", "sample_tokens", "TERMINAL_STATUSES",
           "QueueFullError", "RejectedError", "Request", "ShedError",
           "SlotScheduler", "TenantQuota", "TenantQuotaError",
           "AdapterPool", "AdapterPoolExhausted", "merged_weights",
           "random_lora", "PromptLookupProposer", "verify_tokens",
           "QuantizedWeight", "build_weight_plan", "dequantize",
           "pick_out_tile", "quantize_weight", "FaultError", "FaultPlan",
           "HostPagePool", "SheddingPolicy", "ServingFrontend",
           "TokenStream", "ServingRouter", "ReplicaFaultPlan"]
