from .batching import ContinuousBatchingEngine
from .engine import (CacheList, allocate_caches, decode_steps, generate,
                     prefill)
from .kv_cache import (InferenceParams, KVCache, PagedKVCache, cache_append,
                       calibrate_kv_scale, check_pages, paged_append_prompt,
                       paged_append_token, paged_gather_kv, paged_init,
                       quantize_for_cache)
