from .api import Model, get_model, param_shapes

__all__ = ["Model", "get_model", "param_shapes"]
