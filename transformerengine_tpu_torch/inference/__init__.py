from .engine import decode_steps, generate, prefill
from .kv_cache import (InferenceParams, KVCache, cache_append,
                       calibrate_kv_scale, quantize_for_cache)
