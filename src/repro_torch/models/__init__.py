"""The port's models: the dense decoder family on PyTorch tensors."""
from .model import Model, build_model

__all__ = ["Model", "build_model"]
