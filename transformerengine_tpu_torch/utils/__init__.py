"""Utilities (counterpart of transformerengine_tpu/utils): train-state
checkpoints."""
from .checkpoint import (restore_checkpoint, save_checkpoint,
                         state_with_quantize_meta)
