"""Context parallelism over ``torch.distributed`` process groups
(counterpart of the context-parallel part of transformerengine_tpu/
parallel/): the collectives (``group.py``), the load-balancing reorders
(``cp_utils.py``) and the all-gather, ring, Ulysses and hierarchical
attention (``ring_attention.py``). Not ported yet: the reference's
sharding rules, quantized collectives, sequence-parallel layers and
pipeline schedule (ROADMAP.md)."""
from .cp_utils import (dual_chunk_positions,
                       inverse_reorder_causal_dual_chunk_swap,
                       inverse_reorder_causal_striped,
                       reorder_causal_dual_chunk_swap, reorder_causal_striped)
from .ring_attention import (all_gather_attn, hierarchical_attn, ring_attn,
                             ring_attn_in_group, ulysses_attn)

__all__ = ["all_gather_attn", "dual_chunk_positions", "hierarchical_attn",
           "inverse_reorder_causal_dual_chunk_swap",
           "inverse_reorder_causal_striped",
           "reorder_causal_dual_chunk_swap", "reorder_causal_striped",
           "ring_attn", "ring_attn_in_group", "ulysses_attn"]
