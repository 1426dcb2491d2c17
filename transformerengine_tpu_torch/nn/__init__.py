from .module import DenseGeneral, LayerNorm, LayerNormDenseGeneral, LayerNormMLP
from .moe import MoELayerNormMLP
from .transformer import MultiHeadAttention, TransformerLayer
