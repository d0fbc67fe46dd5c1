"""The port's serving engine (static batches)."""
from .engine import Engine, ServeConfig

__all__ = ["Engine", "ServeConfig"]
