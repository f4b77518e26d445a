"""The hooks through which the port runs inside a runtime it does not import.

The port imports neither ``jax`` nor ``ray_tpu``. Where it meets a
runtime (the object plane, the serve plane's metrics and errors, a model
registry), it calls what a :class:`RuntimeHooks` hands it; the caller fills
one with its runtime's functions and passes it to the device plane
(``_private.device_plane.install``), the serving engine (``serve.llm``),
the train loop (``train.loop``) and the RL algorithms (``rl``). The default
does nothing the caller did not ask for: no metrics, no out-of-band
buffers, the port's own error classes, actors that run in the caller's
process and no collective.

A hooks object is pickled by reference to the functions and classes it
holds, so one built from a runtime's module-level functions can travel to
another process of that runtime (a serve replica's constructor arguments).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.serve.errors import BackPressureError, TaskCancelledError

__all__ = ["LocalRef", "NullMetrics", "RecordingMetrics", "RuntimeHooks", "local_get",
           "local_kill", "local_remote", "local_wait"]

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


class LocalRef:
    """The result of a method called through ``local_remote``: already
    computed."""

    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value


class _LocalMethod:
    def __init__(self, method: Callable):
        self._method = method

    def remote(self, *args, **kwargs) -> LocalRef:
        return LocalRef(self._method(*args, **kwargs))


class _LocalHandle:
    """An instance behind the actor surface: ``handle.m.remote(...)`` calls
    ``m`` at once."""

    def __init__(self, instance: Any):
        self._instance = instance

    def __getattr__(self, name: str) -> _LocalMethod:
        return _LocalMethod(getattr(self._instance, name))


class _LocalActorClass:
    def __init__(self, cls: type):
        self._cls = cls

    def remote(self, *args, **kwargs) -> _LocalHandle:
        return _LocalHandle(self._cls(*args, **kwargs))


def local_remote(cls: type) -> _LocalActorClass:
    """The default ``remote``: ``local_remote(cls).remote(*args)`` builds
    ``cls(*args)`` in this process, and each ``handle.method.remote(...)``
    runs the method there and then (its exception raises at the call)."""
    return _LocalActorClass(cls)


def local_get(refs: Any, timeout: Optional[float] = None) -> Any:
    """The default ``get``: a ``LocalRef``'s value, or a list's values."""
    if isinstance(refs, list):
        return [r.value for r in refs]
    return refs.value


def local_wait(refs: List[LocalRef], num_returns: int = 1, timeout: Optional[float] = None
               ) -> Tuple[List[LocalRef], List[LocalRef]]:
    """The default ``wait``: every local ref is ready, so the first
    ``num_returns`` in order."""
    return list(refs[:num_returns]), list(refs[num_returns:])


def local_kill(handle: Any) -> None:
    """The default ``kill``: a local actor goes with its last reference."""


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
    * Actors, in the shape of ray's API: ``remote(cls)`` gives a factory
      whose ``.remote(*args)`` starts the actor and gives a handle whose
      methods have ``.remote(*args) -> ref``; ``get(refs, timeout=)``;
      ``wait(refs, num_returns=, timeout=) -> (ready, not_ready)``;
      ``kill(handle)``. The default runs every actor in the caller's
      process, each call at once.
    * A host collective for actors: ``init_collective_group(world, rank,
      group_name=)`` and ``allreduce(array, group_name=) -> array`` (a sum
      over numpy arrays). None by default: actors that run one after another
      in one process cannot meet in a collective.
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
    remote: Callable[[type], Any] = local_remote
    get: Callable[..., Any] = local_get
    wait: Callable[..., Any] = local_wait
    kill: Callable[[Any], None] = local_kill
    init_collective_group: Optional[Callable[..., Any]] = None
    allreduce: Optional[Callable[..., Any]] = None

    def in_serialize_scope(self) -> bool:
        """True inside the runtime's serialize call (where out-of-band
        buffers may be appended)."""
        return (self.serialize_scope_active is not None and self.append_oob_buffer is not None
                and self.serialize_scope_active())
