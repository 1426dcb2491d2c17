from .llama import (LLAMA_8B, LLAMA_TINY, LlamaConfig, LlamaModel,
                    cross_entropy_loss, load_flax_params)
