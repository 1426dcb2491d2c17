from .recipe import Float8CurrentScaling, Recipe

__all__ = ["Float8CurrentScaling", "Recipe"]
