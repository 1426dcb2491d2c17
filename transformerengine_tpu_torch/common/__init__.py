from .recipe import (E4M3, E5M2, HYBRID, DelayedScaling, Float8CurrentScaling,
                     Format, MXFP8BlockScaling, Recipe)

__all__ = ["E4M3", "E5M2", "HYBRID", "DelayedScaling", "Float8CurrentScaling",
           "Format", "MXFP8BlockScaling", "Recipe"]
