"""The hooks through which the port runs inside a runtime it does not import.

The port imports neither ``jax`` nor ``ray_tpu``. Where it meets a
runtime (the object plane, the serve plane's metrics and errors, a model
registry), it calls what a :class:`RuntimeHooks` hands it; the caller fills
one with its runtime's functions and passes it to the device plane
(``_private.device_plane.install``), the serving engine (``serve.llm``) and
the train loop (``train.loop``). The default does nothing the caller did not
ask for: no metrics, no out-of-band buffers, the port's own error classes.

A hooks object is pickled by reference to the functions and classes it
holds, so one built from a runtime's module-level functions can travel to
another process of that runtime (a serve replica's constructor arguments).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.serve.errors import BackPressureError, TaskCancelledError

__all__ = ["NullMetrics", "RecordingMetrics", "RuntimeHooks"]

Tags = Optional[Dict[str, str]]


class NullMetrics:
    """A metrics sink that drops everything (the default)."""

    def inc(self, name: str, value: float = 1.0, tags: Tags = None) -> None:
        pass

    def set_gauge(self, name: str, value: float, tags: Tags = None) -> None:
        pass

    def observe(self, name: str, value: float, tags: Tags = None) -> None:
        pass


class RecordingMetrics:
    """A metrics sink that keeps every call in memory, keyed by (name,
    sorted tags): counters summed, a gauge's last value, every observation
    of a histogram. For tests and smoke runs without a runtime."""

    def __init__(self):
        self.counters: Dict[tuple, float] = {}
        self.gauges: Dict[tuple, float] = {}
        self.observations: Dict[tuple, list] = {}

    @staticmethod
    def key(name: str, tags: Tags = None) -> tuple:
        return (name, tuple(sorted((tags or {}).items())))

    def inc(self, name: str, value: float = 1.0, tags: Tags = None) -> None:
        k = self.key(name, tags)
        self.counters[k] = self.counters.get(k, 0.0) + float(value)

    def set_gauge(self, name: str, value: float, tags: Tags = None) -> None:
        self.gauges[self.key(name, tags)] = float(value)

    def observe(self, name: str, value: float, tags: Tags = None) -> None:
        self.observations.setdefault(self.key(name, tags), []).append(float(value))


@dataclasses.dataclass(frozen=True)
class RuntimeHooks:
    """What the port calls where it meets a runtime.

    * ``metrics``: a sink with ``inc(name, value, tags)``,
      ``set_gauge(name, value, tags)`` and ``observe(name, value, tags)``.
    * The object plane's out-of-band buffers, used by the device plane's
      reducer inside the runtime's serialize call:
      ``serialize_scope_active() -> bool``; ``append_oob_buffer(buf) ->
      index``; ``lazy_buffer(nbytes, write(dest: memoryview))``, a buffer
      whose bytes are written straight into the destination when the
      object is written out; ``get_indexed_buffer(index) -> memoryview``,
      the receiver's view of buffer ``index`` while it rebuilds the object.
    * ``fetch_adapter(model_id) -> {"A", "B", "scale"}``: a LoRA adapter
      from the runtime's model registry (raises ``KeyError`` when unknown).
    * ``caller_cancelled() -> bool``: whether the runtime cancelled the
      request the current thread serves (a client that hung up).
    * ``backpressure_error`` and ``cancelled_error``: the classes raised for
      a shed request (``(message, retry_after_s=...)``) and a cancelled one
      (``(task_desc)``), so the runtime's front end recognises them.
    """

    metrics: Any = dataclasses.field(default_factory=NullMetrics)
    serialize_scope_active: Optional[Callable[[], bool]] = None
    append_oob_buffer: Optional[Callable[[Any], int]] = None
    lazy_buffer: Optional[Callable[[int, Callable[[memoryview], None]], Any]] = None
    get_indexed_buffer: Optional[Callable[[int], memoryview]] = None
    fetch_adapter: Optional[Callable[[str], Any]] = None
    caller_cancelled: Optional[Callable[[], bool]] = None
    backpressure_error: type = BackPressureError
    cancelled_error: type = TaskCancelledError

    def in_serialize_scope(self) -> bool:
        """True inside the runtime's serialize call (where out-of-band
        buffers may be appended)."""
        return (self.serialize_scope_active is not None and self.append_oob_buffer is not None
                and self.serialize_scope_active())
