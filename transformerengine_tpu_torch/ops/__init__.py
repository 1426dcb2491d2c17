"""Ops and the wrappers of the hand-written kernels. The kernel modules
(``decode_matmul``, ``flash_attention``, ``decode_attention``) are
imported by name; their functions are not re-exported here, so the
module names stay the modules."""
from .activation import act_lu, normalize_activation_type
from .gemm import tn_dot
from .normalization import rmsnorm_fwd
from .rope import apply_rope, rope_frequencies
