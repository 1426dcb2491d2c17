from .llama import (LLAMA_8B, LLAMA_TINY, LlamaConfig, LlamaModel,
                    cross_entropy_loss, load_flax_opt_state, load_flax_params)
from .mixtral import (MIXTRAL_8X7B, MIXTRAL_TINY, MixtralConfig,
                      MixtralModel, collect_aux_loss, mixtral_loss)
from .gptoss import (GPTOSS_20B, GPTOSS_120B, GPTOSS_TINY, GptOssConfig,
                     GptOssModel, gptoss_loss)
