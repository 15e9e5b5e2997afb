from . import adamw

__all__ = ["adamw"]
