from .module import DenseGeneral, LayerNorm, LayerNormDenseGeneral, LayerNormMLP
from .transformer import MultiHeadAttention, TransformerLayer
