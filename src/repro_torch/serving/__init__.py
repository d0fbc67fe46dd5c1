"""The port's serving engine; the continuous-batching scheduler lives in
``repro_torch.serving.sched`` (imported by its users, not re-exported
here, as in the reference)."""
from .engine import Engine, ServeConfig

__all__ = ["Engine", "ServeConfig"]
