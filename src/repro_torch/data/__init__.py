from . import pipeline

__all__ = ["pipeline"]
