"""tasks: the queue over the port's executor (counterpart of
lut_renderer_tpu/tasks, whose package import loads jax)."""

from .manager import TaskManager
from .runner import TaskRunner, extract_cover, load_lut_table
from .signals import Signal

__all__ = ["Signal", "TaskRunner", "TaskManager", "extract_cover",
           "load_lut_table"]
