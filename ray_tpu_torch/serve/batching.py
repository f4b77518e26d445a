"""In-process continuous batching (the port's copy of the reference's
``serve/batching.py`` continuous batcher, without actors or a runtime).

``@continuous_batch`` turns a *step* function ``fn(self, sequences)`` into
an item-at-a-time callable: callers block on their sequence while a
scheduler thread calls the step function repeatedly with the active set,
admitting queued requests into free slots between steps. A sequence leaves
the moment it is finished or failed. ``bucket_pad_size`` keeps the shape
discipline: step functions pad to a configured bucket so that the device
only ever sees the configured shapes.

Batchers are keyed by weakref to the bound instance and are stopped when
the instance is collected or ``shutdown_batchers()`` is called.
"""

from __future__ import annotations

import functools
import logging
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)


def bucket_pad_size(n: int, bucket_sizes: Sequence[int]) -> int:
    """The smallest configured bucket >= ``n`` (or the largest bucket when
    ``n`` exceeds them all)."""
    buckets = sorted(bucket_sizes)
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


class _Sequence:
    """One caller's request inside a continuous batch.

    The step fn reads ``item``, keeps per-sequence scratch in ``state`` and
    calls ``finish()`` or ``fail()`` when the sequence is done.
    ``enqueued_at`` (monotonic) is stamped at submission. ``on_release`` is
    an optional zero-argument hook that the scheduler calls exactly once when
    the sequence leaves for any reason (finish, fail, step poison,
    cancellation, shutdown): the anchor for per-sequence leases such as KV
    blocks."""

    __slots__ = ("item", "state", "_result", "_error", "_done", "_event",
                 "enqueued_at", "cancelled", "on_release", "_released")

    def __init__(self, item):
        self.item = item
        self.state: Any = None
        self._result = None
        self._error: Optional[BaseException] = None
        self._done = False
        self._event = threading.Event()
        self.enqueued_at = time.monotonic()
        self.cancelled = False
        self.on_release: Optional[Callable[[], None]] = None
        self._released = False

    def finish(self, result) -> None:
        self._result = result
        self._done = True

    def fail(self, error: BaseException) -> None:
        self._error = error
        self._done = True

    @property
    def done(self) -> bool:
        return self._done

    def _release(self) -> None:
        if self._released:
            return
        self._released = True
        cb = self.on_release
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — release hooks must not poison
                logger.exception("release hook of a sequence failed")


class _ContinuousBatcher:
    """Iteration-level scheduler: admits queued requests into the active
    set between calls of the step fn.

    With ``hooks`` whose ``caller_cancelled`` is set (a runtime's way to say
    that the request the calling thread serves was cancelled, e.g. its
    client hung up), a blocked caller polls it every ``poll_interval_s`` and
    raises ``hooks.cancelled_error``; the scheduler then drops the sequence
    and runs its release hook."""

    #: how often a blocked caller re-checks for cancellation
    poll_interval_s = 0.02

    def __init__(self, step_fn, max_batch_size, batch_wait_timeout_s,
                 name="fn", hooks=None):
        self.step_fn = step_fn
        self.name = name
        self.hooks = hooks
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self.queue: List[_Sequence] = []
        self.cv = threading.Condition()
        self._stop = False
        self.thread = threading.Thread(
            target=self._loop, daemon=True, name=f"serve-cbatch:{name}")
        self.thread.start()

    def submit(self, item):
        seq = _Sequence(item)
        with self.cv:
            if self._stop:
                raise RuntimeError(f"batcher for {self.name!r} is shut down")
            self.queue.append(seq)
            self.cv.notify_all()
        cancelled = getattr(self.hooks, "caller_cancelled", None)
        try:
            if cancelled is None:
                seq._event.wait()
            while not seq._event.wait(self.poll_interval_s):
                if cancelled():
                    raise self.hooks.cancelled_error(self.name)
        except BaseException:
            # the caller is abandoning the sequence (cancelled above, or an
            # interrupt): flag it so the scheduler drops it and runs its
            # release hook
            seq.cancelled = True
            with self.cv:
                self.cv.notify_all()
            raise
        if seq._error is not None:
            raise seq._error
        return seq._result

    def shutdown(self, drain: bool = True) -> None:
        with self.cv:
            self._stop = True
            orphans: List[_Sequence] = []
            if not drain:
                orphans, self.queue = self.queue, []
            self.cv.notify_all()
        for s in orphans:
            s._error = RuntimeError(f"batcher for {self.name!r} shut down")
            s._release()
            s._event.set()

    def _loop(self):
        active: List[_Sequence] = []
        while True:
            with self.cv:
                while not self.queue and not active and not self._stop:
                    self.cv.wait()
                if self._stop and not self.queue and not active:
                    return
                if not active and self.timeout > 0 and not self._stop:
                    # cold batch: give the queue one beat to fill
                    start = time.monotonic()
                    while (
                        len(self.queue) < self.max_batch_size
                        and time.monotonic() - start < self.timeout
                        and not self._stop
                    ):
                        self.cv.wait(self.timeout / 4)
                while self.queue and len(active) < self.max_batch_size:
                    s = self.queue.pop(0)
                    if s.cancelled:
                        s._release()
                        s._event.set()
                        continue
                    active.append(s)
            live: List[_Sequence] = []
            for s in active:
                if s.cancelled:
                    s._release()
                    s._event.set()
                else:
                    live.append(s)
            active = live
            if not active:
                continue
            step = list(active)
            try:
                self.step_fn(step)
            except BaseException as e:  # noqa: BLE001
                # a failed step poisons the whole in-flight batch
                for s in step:
                    s._error = e
                    s._release()
                    s._event.set()
                active = []
                continue
            active = []
            for s in step:
                if s._done:
                    s._release()
                    s._event.set()
                else:
                    active.append(s)


# ---------------------------------------------------------------------------
# batcher registry: weakref-keyed, reaped on instance GC / explicit shutdown
# ---------------------------------------------------------------------------

_HOLDERS: Dict[int, dict] = {}


def _reap(holder: dict, key) -> None:
    b = holder.pop(key, None)
    if b is not None:
        b.shutdown(drain=True)


def _bound_call(fn, owner):
    """``fn`` bound to ``owner`` through a weakref, so that the batcher does
    not keep the instance alive."""
    ref = weakref.ref(owner)
    del owner

    def call(items):
        inst = ref()
        if inst is None:
            raise RuntimeError("batcher owner was garbage collected")
        return fn(inst, items)

    return call


def _batcher_for(holder: dict, owner, factory):
    key = weakref.ref(owner)
    b = holder.get(key)
    if b is not None:
        return b
    nb = factory()
    b = holder.setdefault(key, nb)  # atomic under the GIL: one batcher wins
    if b is not nb:
        nb.shutdown(drain=False)
        return b
    _HOLDERS[id(holder)] = holder
    weakref.finalize(owner, _reap, holder, key)
    return b


def shutdown_batchers(instance=None) -> int:
    """Shut down batchers made in this process (all of them, or only those
    bound to ``instance``), letting in-flight sequences finish. Returns the
    number stopped."""
    stopped = 0
    for holder in list(_HOLDERS.values()):
        for key, b in list(holder.items()):
            if instance is not None and key() is not instance:
                continue
            if holder.pop(key, None) is not None:
                b.shutdown(drain=True)
                stopped += 1
    return stopped


def continuous_batch(*, max_batch_size: int = 8,
                     batch_wait_timeout_s: float = 0.002):
    """Decorator for iteration-level (continuous) batching of a method: the
    wrapped ``fn(self, sequences)`` is a step function; callers invoke the
    wrapper with one item and block until their sequence finishes. Each
    instance gets its own batcher, which polls the instance's ``hooks``
    (a ``RuntimeHooks``, where it has one) for cancelled callers."""

    def deco(fn):
        holder: dict = {}

        @functools.wraps(fn)
        def wrapper(owner, item):
            b = _batcher_for(
                holder,
                owner,
                lambda: _ContinuousBatcher(
                    _bound_call(fn, owner), max_batch_size,
                    batch_wait_timeout_s, name=fn.__name__,
                    hooks=getattr(owner, "hooks", None),
                ),
            )
            return b.submit(item)

        return wrapper

    return deco
