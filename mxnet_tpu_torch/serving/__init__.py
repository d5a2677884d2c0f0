"""Continuous-batching serving (counterpart of mxnet_tpu.serving, core)."""
from .engine import ServingEngine
from .page_pool import PagePool, PagePoolExhausted
from .prefix_cache import PrefixCache
from .sampling import filtered_logits, sample_tokens
from .scheduler import (TERMINAL_STATUSES, QueueFullError, RejectedError,
                        Request, ShedError, SlotScheduler, TenantQuota,
                        TenantQuotaError)

__all__ = ["ServingEngine", "PagePool", "PagePoolExhausted", "PrefixCache",
           "filtered_logits", "sample_tokens", "TERMINAL_STATUSES",
           "QueueFullError", "RejectedError", "Request", "ShedError",
           "SlotScheduler", "TenantQuota", "TenantQuotaError"]
