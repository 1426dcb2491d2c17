from .module import (DenseGeneral, LayerNorm, LayerNormDenseGeneral,
                     LayerNormMLP, kernel_caches)
from .moe import MoELayerNormMLP
from .transformer import MultiHeadAttention, TransformerLayer
