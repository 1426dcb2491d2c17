from .recipe import (E2M1, E4M3, E5M2, HYBRID, DelayedScaling,
                     Float8CurrentScaling, Format, MXFP8BlockScaling,
                     NVFP4BlockScaling, QParams, Recipe)

__all__ = ["E2M1", "E4M3", "E5M2", "HYBRID", "DelayedScaling",
           "Float8CurrentScaling", "Format", "MXFP8BlockScaling",
           "NVFP4BlockScaling", "QParams", "Recipe"]
