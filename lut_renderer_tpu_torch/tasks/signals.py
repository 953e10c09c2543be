"""Minimal thread-safe signal/slot — the Qt-free event channel.

Callbacks run synchronously on the emitting thread; UI layers that need
thread affinity marshal in their own connect wrappers.

The port's copy of lut_renderer_tpu/tasks/signals.py: importing that module
runs the JAX package's tasks/__init__, which loads jax.
"""

from __future__ import annotations

import threading
import traceback
from typing import Callable, List


class Signal:
    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._slots: List[Callable] = []

    def connect(self, fn: Callable) -> None:
        with self._lock:
            if fn not in self._slots:
                self._slots.append(fn)

    def disconnect(self, fn: Callable) -> None:
        with self._lock:
            if fn in self._slots:
                self._slots.remove(fn)

    def emit(self, *args) -> None:
        with self._lock:
            slots = list(self._slots)
        for fn in slots:
            try:
                fn(*args)
            except Exception:  # a bad listener must not break the pipeline
                traceback.print_exc()
