from .llama import LLAMA_8B, LLAMA_TINY, LlamaConfig, LlamaModel, load_flax_params
