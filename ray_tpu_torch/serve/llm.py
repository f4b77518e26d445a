"""LLM inference engine for the port: paged KV cache, prefill/decode split,
prefix caching and LoRA multiplexing over the port's GPT extend step
(counterpart of ``ray_tpu/serve/llm.py``).

The design is the reference's; what differs is where the data lives:

* :class:`KVBlockPool` keeps ``k_data``/``v_data`` as **device tensors**
  ``[num_blocks, layers, block_size, heads, head_dim]`` (the reference keeps
  host numpy arenas and re-stages the whole padded cache from the host on
  every step). ``_gather`` and ``_scatter`` index the pool on the device.
* The LoRA delta and the argmax run on the device; only token ids (and
  logits, when ``return_logits`` is set) go to the host.

Sequences lease blocks on admission and a :class:`KVLease` frees them
exactly once on finish, cancel, shed or step poison. Prefill runs as its own
bucketed extend call, decode as a tc=1 call; every engine step runs at most
one prefill chunk and one decode step. Full prompt blocks are keyed by a
chained hash and shared copy-on-write. On CUDA each engine step runs its
device work under ``torch.use_deterministic_algorithms`` and gives the
caller's setting back after it (``deterministic_algorithms``): with equal
shapes the extend step gives equal bits, so prefix-cached decode is
bitwise-equal to uncached decode. The setting is process-wide: the steps
of every engine in the process share one count, so it is the caller's
again once no step runs, and work on another thread meanwhile runs under
it too. cuBLAS reads
``CUBLAS_WORKSPACE_CONFIG`` when it makes its first handle, so a CUDA
engine refuses to start unless the variable is set (before the process's
first cuBLAS call, which the engine cannot check).
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import os
import queue as queue_mod
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.inference import init_params
from ray_tpu_torch.serve import batching
from ray_tpu_torch.serve.errors import BackPressureError, TaskCancelledError
from ray_tpu_torch.serve.multiplex import _MultiplexWrapper

__all__ = [
    "KVBlockPool", "KVLease", "NoKVBlocksError", "PrefixCache", "chain_hashes",
    "LLMEngine", "LLMServer", "make_params", "register_lora", "random_lora",
]

_STREAM_KEY = "_stream"
_CANCEL_KEY = "_cancel"
_DEFAULT_MAX_NEW_TOKENS = 16


# the open ``deterministic_algorithms`` blocks of every thread, and the
# setting (enabled, warn_only) that the first of them found
_deterministic_lock = threading.Lock()
_deterministic_users = 0
_deterministic_before = (False, False)


@contextlib.contextmanager
def deterministic_algorithms() -> Iterator[None]:
    """``torch.use_deterministic_algorithms(True)`` inside the block. The
    setting is process-wide, so the blocks of all threads share one count
    under a lock: the first to open saves the setting (and its warn-only
    flag) and turns the mode on, the last to close restores it, also when a
    block raises. Two engines stepping on two threads thus never restore the
    setting under each other's step, and it is the caller's again once no
    block is open. Work on other threads meanwhile runs under the mode."""
    global _deterministic_users, _deterministic_before
    with _deterministic_lock:
        if _deterministic_users == 0:
            _deterministic_before = (torch.are_deterministic_algorithms_enabled(),
                                     torch.is_deterministic_algorithms_warn_only_enabled())
            torch.use_deterministic_algorithms(True)
        _deterministic_users += 1
    try:
        yield
    finally:
        with _deterministic_lock:
            _deterministic_users -= 1
            if _deterministic_users == 0:
                enabled, warn_only = _deterministic_before
                torch.use_deterministic_algorithms(enabled, warn_only=warn_only)


class NoKVBlocksError(RuntimeError):
    """The pool cannot satisfy an allocation even after evicting every
    idle prefix-cache block: the admission-control signal."""


def make_params(cfg=None, seed: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """Deterministically initialised params for ``cfg`` (default
    ``gpt_nano``): every replica builds the same weights from one seed."""
    return init_params(cfg or gpt.gpt_nano(), device=device, seed=seed)


# ---------------------------------------------------------------------------
# paged KV block pool + exactly-once lease
# ---------------------------------------------------------------------------


class KVBlockPool:
    """Fixed-size token blocks of K/V storage on the device, refcounted.

    ``k_data``/``v_data`` are ``[num_blocks, layers, block_size, heads,
    head_dim]`` in ``cfg.dtype``. A sequence owns an ordered list of block
    ids whose concatenation is its cache. One more block, past the end and
    never handed out, stays zero: gathers point unused slots at it."""

    def __init__(self, cfg, *, num_blocks: int = 128, block_size: int = 16,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        shape = (self.num_blocks + 1, cfg.num_layers, self.block_size,
                 cfg.num_heads, cfg.head_dim)
        self._k_store = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self._v_store = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.k_data = self._k_store[:self.num_blocks]
        self.v_data = self._v_store[:self.num_blocks]
        self.zero_block = self.num_blocks
        self._free: List[int] = list(range(self.num_blocks))
        self._ref: Dict[int, int] = {}
        self._lock = threading.RLock()
        self._evict_cb: Optional[weakref.WeakMethod] = None
        self.freed_total = 0

    def set_evict_cb(self, cb: weakref.WeakMethod) -> None:
        """Hook called (under the pool lock) with the shortfall when an
        allocation would fail: the prefix cache drops idle entries here.
        ``cb`` is a ``weakref.WeakMethod``; once its object is gone the
        hook does nothing."""
        self._evict_cb = cb

    def allocate(self, n: int) -> List[int]:
        with self._lock:
            evict = self._evict_cb() if self._evict_cb is not None else None
            if len(self._free) < n and evict is not None:
                evict(n - len(self._free))
            if len(self._free) < n:
                raise NoKVBlocksError(
                    f"need {n} KV blocks, {len(self._free)} free "
                    f"of {self.num_blocks}"
                )
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
            return out

    def incref(self, blocks: Sequence[int]) -> None:
        with self._lock:
            for b in blocks:
                self._ref[b] += 1

    def free(self, blocks: Sequence[int]) -> None:
        with self._lock:
            for b in blocks:
                self._decref_locked(b)

    def _decref_locked(self, b: int) -> None:
        r = self._ref.get(b)
        if r is None:
            return
        if r <= 1:
            del self._ref[b]
            self._free.append(b)
            self.freed_total += 1
        else:
            self._ref[b] = r - 1

    def refcount(self, b: int) -> int:
        with self._lock:
            return self._ref.get(b, 0)

    def in_use(self) -> int:
        with self._lock:
            return self.num_blocks - len(self._free)

    def ensure_private(self, blocks: List[int], idx: int) -> int:
        """Copy-on-write: make ``blocks[idx]`` safe to mutate. A shared
        block is cloned (on the device) into a fresh block, in place in the
        caller's list, and the shared original is decrefed."""
        with self._lock:
            b = blocks[idx]
            if self._ref.get(b, 0) <= 1:
                return b
            new = self.allocate(1)[0]
            self.k_data[new] = self.k_data[b]
            self.v_data[new] = self.v_data[b]
            self._decref_locked(b)
            blocks[idx] = new
            return new


class KVLease:
    """Exactly-once ownership of a sequence's KV blocks: however many of
    finish, fail, cancel, step poison and shutdown fire for one sequence,
    the blocks are decrefed once."""

    def __init__(self, pool: KVBlockPool):
        self.pool = pool
        self.blocks: List[int] = []
        self._released = False
        self._lock = threading.Lock()

    def add(self, blocks: Sequence[int]) -> None:
        with self._lock:
            if self._released:
                self.pool.free(list(blocks))  # late add after release
                return
            self.blocks.extend(blocks)

    def release(self) -> None:
        with self._lock:
            if self._released:
                return
            self._released = True
            blocks, self.blocks = list(self.blocks), []
        self.pool.free(blocks)


# ---------------------------------------------------------------------------
# prefix cache: rolling hash over full prompt blocks, LRU under pressure
# ---------------------------------------------------------------------------


def chain_hashes(prompt: Sequence[int], block_size: int) -> List[bytes]:
    """One hash per FULL prompt block, each chained on its predecessor:
    block i's key commits to tokens [0, (i+1)*block_size)."""
    h = b"ray_tpu-llm-prefix-v1"
    out: List[bytes] = []
    for i in range(len(prompt) // block_size):
        blk = np.asarray(
            prompt[i * block_size:(i + 1) * block_size], np.int64
        ).tobytes()
        h = hashlib.sha1(h + blk).digest()
        out.append(h)
    return out


class PrefixCache:
    """hash -> block id, LRU-ordered. The cache holds its own reference on
    every cached block; entries whose block is otherwise idle are evicted
    when the pool runs dry."""

    def __init__(self, pool: KVBlockPool):
        self.pool = pool
        self._map: "OrderedDict[bytes, int]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # a weak method: the pool's hook must not keep the cache (and so
        # the pool itself) alive in a reference cycle
        pool.set_evict_cb(weakref.WeakMethod(self._evict_for))

    def match(self, hashes: Sequence[bytes]) -> List[int]:
        """Block ids of the longest cached prefix chain, increfed for the
        caller (released through the caller's lease)."""
        with self.pool._lock:
            out: List[int] = []
            for h in hashes:
                b = self._map.get(h)
                if b is None:
                    break
                self._map.move_to_end(h)
                out.append(b)
            if out:
                self.pool.incref(out)
                self.hits += len(out)
            self.misses += len(hashes) - len(out)
            return out

    def insert(self, hashes: Sequence[bytes], blocks: Sequence[int]) -> None:
        """Cache a freshly prefilled chain; first writer wins per hash."""
        with self.pool._lock:
            for h, b in zip(hashes, blocks):
                if h in self._map:
                    continue
                if self.pool._ref.get(b, 0) <= 0:
                    continue  # lease already released
                self._map[h] = b
                self.pool.incref([b])

    def _evict_for(self, shortfall: int) -> None:
        # called under the pool lock by KVBlockPool.allocate
        freed = 0
        for h in list(self._map):
            if freed >= shortfall:
                break
            b = self._map[h]
            if self.pool._ref.get(b, 0) == 1:  # only the cache holds it
                del self._map[h]
                self.pool._decref_locked(b)
                self.evictions += 1
                freed += 1

    def clear(self) -> None:
        """Drop every entry and the cache's reference on its block."""
        with self.pool._lock:
            for b in self._map.values():
                self.pool._decref_locked(b)
            self._map.clear()

    def __len__(self) -> int:
        with self.pool._lock:
            return len(self._map)


# ---------------------------------------------------------------------------
# LoRA adapters: low-rank logit deltas over the base model
# ---------------------------------------------------------------------------

_LORA: Dict[str, Dict[str, Any]] = {}
_LORA_LOCK = threading.Lock()


def random_lora(cfg, rank: int = 4, seed: int = 0, scale: float = 1.0):
    """A deterministic random adapter ``{"A", "B", "scale"}``:
    ``logits += scale * (hidden @ A) @ B``."""
    rng = np.random.RandomState(seed)
    return {
        "A": rng.randn(cfg.embed_dim, rank).astype(np.float32) * 0.1,
        "B": rng.randn(rank, cfg.vocab_size).astype(np.float32) * 0.1,
        "scale": float(scale),
    }


def register_lora(model_id: str, adapter: Dict[str, Any]) -> None:
    """Register an adapter under ``model_id`` in this process; engines load
    it on first use through their LRU."""
    with _LORA_LOCK:
        _LORA[model_id] = adapter


def _fetch_lora(model_id: str):
    with _LORA_LOCK:
        a = _LORA.get(model_id)
    if a is None:
        raise KeyError(f"model {model_id!r} is not registered")
    return a["A"], a["B"], float(a.get("scale", 1.0))


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def _adapter_to_device(adapter, device):
    a, bmat, scale = adapter
    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return dev(a), dev(bmat), float(scale)


class _SeqState:
    __slots__ = (
        "prompt", "max_new", "eos", "model_id", "adapter", "lease", "blocks",
        "pos", "length", "out", "last_token", "cached_tokens", "hashes",
        "ttft_s", "stream_q", "cancel_ev", "return_logits", "logits",
    )


class LLMEngine:
    """The scheduler and paged-attention runtime behind ``LLMServer``.

    ``step(seqs)`` is a continuous-batching step function: it admits new
    sequences (leasing KV blocks or shedding), runs at most one bucketed
    prefill chunk and one tc=1 decode over every decoding lane, and
    finishes or streams tokens. Every shape reaching the extend step is
    drawn from the configured buckets."""

    def __init__(self, cfg=None, params=None, *, device=None,
                 num_blocks: int = 128, block_size: int = 16,
                 prefill_chunk: int = 32, prefill_lanes: int = 4,
                 lane_buckets: Sequence[int] = (1, 2, 4, 8, 16),
                 prefill_token_buckets: Sequence[int] = (8, 16, 32),
                 cache_buckets: Sequence[int] = (32, 64, 128),
                 max_adapters: int = 4, adapter_loader=None,
                 prefix_caching: bool = True, step_delay_s: float = 0.0):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and "CUBLAS_WORKSPACE_CONFIG" not in os.environ:
            # equal shapes must give equal bits (bitwise prefix caching): the
            # steps' deterministic cuBLAS needs the variable before the first
            # handle, which setting it here is too late for
            raise RuntimeError(
                "set CUBLAS_WORKSPACE_CONFIG (e.g. ':4096:8') before the process's "
                "first cuBLAS call; the engine's deterministic decode needs it")
        self.cfg = cfg or gpt.gpt_nano()
        self._params = params if params is not None else make_params(
            self.cfg, device=self.device)
        self._extend = gpt.make_extend_fn(self.cfg)
        self.block_size = int(block_size)
        self.prefill_chunk = int(prefill_chunk)
        self.prefill_lanes = int(prefill_lanes)
        self.lane_buckets = sorted(lane_buckets)
        self.prefill_token_buckets = sorted(prefill_token_buckets)
        self.cache_buckets = sorted(cache_buckets)
        self.max_context = min(self.cfg.max_seq_len, self.cache_buckets[-1])
        self.pool = KVBlockPool(
            self.cfg, num_blocks=num_blocks, block_size=block_size,
            device=self.device,
        )
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(self.pool) if prefix_caching else None
        )
        loader, dev = adapter_loader or _fetch_lora, self.device
        # the loader holds the device, not the engine: a closed server's
        # engine, pool and weights then go by reference count
        self._mux = _MultiplexWrapper(
            lambda mid: _adapter_to_device(loader(mid), dev), int(max_adapters))
        #: fault injection: stretch every engine step
        self.step_delay_s = float(step_delay_s)
        self.steps = 0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

    # -- public stats ------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {
            "kv_blocks_total": self.pool.num_blocks,
            "kv_blocks_in_use": self.pool.in_use(),
            "kv_blocks_freed_total": self.pool.freed_total,
            "prefix_hits": self.prefix.hits if self.prefix else 0,
            "prefix_misses": self.prefix.misses if self.prefix else 0,
            "prefix_evictions": self.prefix.evictions if self.prefix else 0,
            "prefix_cached_blocks": len(self.prefix) if self.prefix else 0,
            "adapters_resident": self._mux.loaded_ids(),
            "steps": self.steps,
            "decode_tokens": self.decode_tokens,
            "prefill_tokens": self.prefill_tokens,
            "prefill_seconds": self.prefill_seconds,
            "decode_seconds": self.decode_seconds,
        }

    # -- scheduling --------------------------------------------------------

    def step(self, seqs: List[Any]) -> None:
        try:
            if self.step_delay_s:
                time.sleep(self.step_delay_s)
            self._admit(seqs)
            self._sweep_cancelled(seqs)
            deterministic = (deterministic_algorithms() if self.device.type == "cuda"
                             else contextlib.nullcontext())
            with torch.inference_mode(), deterministic:
                # each phase ends in a host copy of token ids, so these
                # wall times include the device work
                t0 = time.monotonic()
                self._prefill_step(seqs)
                t1 = time.monotonic()
                self._decode_step(seqs)
                self.prefill_seconds += t1 - t0
                self.decode_seconds += time.monotonic() - t1
            self.steps += 1
        except BaseException:
            # a crashed forward poisons the batch; the leases must not ride
            # down with it
            for s in seqs:
                st = s.state
                if isinstance(st, _SeqState) and st.lease is not None:
                    st.lease.release()
            raise

    def _admit(self, seqs) -> None:
        for s in seqs:
            if s.state is not None or s.done:
                continue
            item = s.item if isinstance(s.item, dict) else {"prompt": s.item}
            st = _SeqState()
            st.prompt = [int(t) for t in item.get("prompt", [])]
            st.max_new = int(
                item.get("max_new_tokens", _DEFAULT_MAX_NEW_TOKENS))
            st.eos = item.get("eos_token")
            st.model_id = item.get("model_id")
            st.adapter = None
            st.lease = None
            st.stream_q = item.get(_STREAM_KEY)
            st.cancel_ev = item.get(_CANCEL_KEY)
            st.return_logits = bool(item.get("return_logits"))
            st.logits = [] if st.return_logits else None
            st.out = []
            st.last_token = None
            st.ttft_s = None
            if not st.prompt or st.max_new < 1:
                s.fail(ValueError("payload needs a non-empty 'prompt'"))
                continue
            total = len(st.prompt) + st.max_new
            if total > self.max_context:
                s.fail(ValueError(
                    f"prompt+max_new_tokens = {total} exceeds the engine "
                    f"context of {self.max_context}"
                ))
                continue
            lease = KVLease(self.pool)
            st.lease = lease
            st.blocks = lease.blocks
            s.on_release = lease.release
            bs = self.block_size
            st.hashes = (
                chain_hashes(st.prompt, bs) if self.prefix is not None else []
            )
            # never reuse the whole prompt: the last prompt token must be
            # fed through prefill to produce the first sampled token
            reuse_cap = (len(st.prompt) - 1) // bs
            cached = (
                self.prefix.match(st.hashes[:reuse_cap])
                if self.prefix is not None else []
            )
            lease.add(cached)
            need = math.ceil(len(st.prompt) / bs) - len(cached)
            try:
                lease.add(self.pool.allocate(need))
            except NoKVBlocksError as e:
                lease.release()
                s.fail(BackPressureError(str(e), retry_after_s=0.05))
                continue
            st.pos = len(cached) * bs       # prompt tokens already cached
            st.length = st.pos              # tokens resident in the cache
            st.cached_tokens = st.pos
            if st.model_id:
                try:
                    st.adapter = self._mux.load(st.model_id)
                except KeyError as e:
                    lease.release()
                    s.fail(e)
                    continue
            s.state = st

    def _sweep_cancelled(self, seqs) -> None:
        for s in seqs:
            st = s.state
            if (isinstance(st, _SeqState) and not s.done
                    and st.cancel_ev is not None and st.cancel_ev.is_set()):
                st.lease.release()
                s.fail(TaskCancelledError(f"llm:{id(self):x}"))

    def _live(self, seqs) -> List[Any]:
        return [
            s for s in seqs
            if isinstance(s.state, _SeqState) and not s.done
        ]

    def _prefill_step(self, seqs) -> None:
        pending = [
            s for s in self._live(seqs) if s.state.pos < len(s.state.prompt)
        ]
        if not pending:
            return
        lanes = pending[:self.prefill_lanes]
        states = [s.state for s in lanes]
        chunks = [
            min(self.prefill_chunk, len(st.prompt) - st.pos) for st in states
        ]
        tc = batching.bucket_pad_size(max(chunks), self.prefill_token_buckets)
        logits, hidden, k_new, v_new = self._run_extend(
            states, [st.prompt[st.pos:st.pos + c]
                     for st, c in zip(states, chunks)], tc)
        self._scatter(states, chunks, k_new, v_new)
        emits = []
        for i, (s, st, c) in enumerate(zip(lanes, states, chunks)):
            st.pos += c
            st.length += c
            self.prefill_tokens += c
            if st.pos >= len(st.prompt):
                if self.prefix is not None:
                    # cache every full prompt block (first writer wins)
                    self.prefix.insert(st.hashes, st.blocks[:len(st.hashes)])
                emits.append((s, st, logits[i, c - 1], hidden[i, c - 1]))
        self._emit(emits)

    def _decode_step(self, seqs) -> None:
        decoding = [
            s for s in self._live(seqs)
            if s.state.pos >= len(s.state.prompt)
        ]
        max_lanes = self.lane_buckets[-1]
        while decoding:
            lanes, decoding = decoding[:max_lanes], decoding[max_lanes:]
            states = []
            for s in lanes:
                st = s.state
                # grow the cache for the token about to be written
                need_blocks = (st.length // self.block_size) + 1
                try:
                    if need_blocks > len(st.blocks):
                        st.lease.add(self.pool.allocate(
                            need_blocks - len(st.blocks)))
                    self.pool.ensure_private(
                        st.blocks, st.length // self.block_size)
                except NoKVBlocksError as e:
                    st.lease.release()
                    s.fail(BackPressureError(str(e), retry_after_s=0.05))
                    continue
                states.append((s, st))
            if not states:
                continue
            sts = [st for _, st in states]
            logits, hidden, k_new, v_new = self._run_extend(
                sts, [[st.last_token] for st in sts], 1)
            self._scatter(sts, [1] * len(sts), k_new, v_new)
            for st in sts:
                st.length += 1
            self.decode_tokens += len(sts)
            self._emit([(s, st, logits[i, 0], hidden[i, 0])
                        for i, (s, st) in enumerate(states)])

    # -- device call + paging ---------------------------------------------

    def _run_extend(self, states, token_chunks, tc: int):
        b = batching.bucket_pad_size(len(states), self.lane_buckets)
        t_max = max(
            st.length + len(ch) for st, ch in zip(states, token_chunks))
        t_cap = batching.bucket_pad_size(t_max, self.cache_buckets)
        tokens = np.zeros((b, tc), np.int64)
        lengths = np.zeros((b,), np.int64)
        for i, (st, ch) in enumerate(zip(states, token_chunks)):
            tokens[i, :len(ch)] = ch
            lengths[i] = st.length
        k_cache, v_cache = self._gather(states, b, t_cap)
        return self._extend(
            self._params, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(lengths).to(self.device), k_cache, v_cache,
        )

    def _gather(self, states, b: int, t_cap: int):
        """Padded caches [layers, b, t_cap, heads, head_dim] gathered from
        the pool on the device. Slots past a lane's blocks read the zero
        block; slots past its length inside its last block hold stale (finite)
        values, which the extend step's mask gives weight exactly 0."""
        bs = self.block_size
        nblk = math.ceil(t_cap / bs)
        table = np.full((b, nblk), self.pool.zero_block, np.int64)
        for i, st in enumerate(states):
            n = math.ceil(st.length / bs)
            table[i, :n] = st.blocks[:n]
        idx = torch.from_numpy(table).to(self.device)
        cfg = self.cfg
        shape = (cfg.num_layers, b, nblk * bs, cfg.num_heads, cfg.head_dim)

        def gather(store):
            # [b, nblk, L, bs, h, d] -> [L, b, nblk*bs, h, d]
            g = store[idx].permute(2, 0, 1, 3, 4, 5).reshape(shape)
            return g[:, :, :t_cap].contiguous()

        return gather(self.pool._k_store), gather(self.pool._v_store)

    def _scatter(self, states, counts, k_new, v_new) -> None:
        """Write each lane's first ``counts[i]`` new K/V rows into its
        blocks at positions ``length ..``, with one indexed copy per pool."""
        bs = self.block_size
        blk, off, lane, tok = [], [], [], []
        for i, (st, n) in enumerate(zip(states, counts)):
            for j in range(n):
                pos = st.length + j
                blk.append(st.blocks[pos // bs])
                off.append(pos % bs)
                lane.append(i)
                tok.append(j)
        dev = self.device
        blk_t, off_t, lane_t, tok_t = (
            torch.tensor(x, dtype=torch.long, device=dev)
            for x in (blk, off, lane, tok))
        # k_new[:, lane, tok] is [L, n, h, d]; the pool slot view is [n, L, h, d]
        self.pool.k_data[blk_t, :, off_t] = k_new[:, lane_t, tok_t].transpose(0, 1)
        self.pool.v_data[blk_t, :, off_t] = v_new[:, lane_t, tok_t].transpose(0, 1)

    # -- sampling / completion --------------------------------------------

    def _emit(self, items) -> None:
        """Sample the next token of each ``(seq, state, logits_row,
        hidden_row)`` on the device (LoRA delta, then argmax); one host copy
        for the token ids, and one for the logits rows when asked for."""
        if not items:
            return
        rows = []
        for _, st, logits_row, hidden_row in items:
            if st.adapter is not None:
                a, bmat, scale = st.adapter
                logits_row = logits_row + scale * ((hidden_row @ a) @ bmat)
            rows.append(logits_row)
        rows_t = torch.stack(rows)
        toks = rows_t.argmax(dim=-1).tolist()
        host = (
            rows_t.cpu().numpy()
            if any(st.logits is not None for _, st, _, _ in items) else None
        )
        now = time.monotonic()
        for i, (s, st, _, _) in enumerate(items):
            tok = toks[i]
            st.out.append(tok)
            st.last_token = tok
            if st.logits is not None:
                st.logits.append(host[i].copy())
            if st.ttft_s is None:
                st.ttft_s = now - s.enqueued_at
            if st.stream_q is not None:
                st.stream_q.put(("tok", tok))
            if len(st.out) >= st.max_new or (st.eos is not None
                                             and tok == st.eos):
                self._finish(s, st)

    def _finish(self, s, st: _SeqState) -> None:
        st.lease.release()
        result: Dict[str, Any] = {
            "tokens": st.out,
            "ttft_s": st.ttft_s,
            "prefix_cached_tokens": st.cached_tokens,
            "prefill_tokens": len(st.prompt) - st.cached_tokens,
            "model_id": st.model_id,
        }
        if st.logits is not None:
            result["logits"] = np.stack(st.logits)
        s.finish(result)
        if st.stream_q is not None:
            st.stream_q.put(("end", result))


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class LLMServer:
    """``__call__(payload) -> result`` (blocking) and ``stream(payload)``
    (token generator), in process. Payloads:

    ``{"prompt": [token ids], "max_new_tokens": n, "model_id": "lora:x",
    "eos_token": id, "return_logits": bool}``

    Results carry ``tokens``, ``ttft_s``, ``prefix_cached_tokens``,
    ``prefill_tokens`` and ``model_id`` (and ``logits`` when asked for).
    Call ``close()`` (or ``batching.shutdown_batchers(server)``) to stop the
    scheduler thread."""

    def __init__(self, cfg=None, params=None, device=None, **engine_kwargs):
        self._engine = LLMEngine(cfg, params, device=device, **engine_kwargs)

    @batching.continuous_batch(max_batch_size=16, batch_wait_timeout_s=0.001)
    def generate(self, seqs):
        self._engine.step(seqs)

    def __call__(self, payload):
        return self.generate(payload)

    def stream(self, payload):
        """Yield tokens as they decode. Closing the generator cancels the
        sequence and releases its KV blocks."""
        out: "queue_mod.Queue" = queue_mod.Queue()
        cancel = threading.Event()
        payload = dict(payload)
        payload[_STREAM_KEY] = out
        payload[_CANCEL_KEY] = cancel

        def run():
            try:
                self.generate(payload)
            except BaseException as e:  # noqa: BLE001 — handed to the reader
                out.put(("error", e))

        threading.Thread(target=run, daemon=True).start()
        try:
            while True:
                kind, val = out.get(timeout=120.0)
                if kind == "tok":
                    yield val
                elif kind == "end":
                    return
                else:
                    raise val
        finally:
            cancel.set()

    def kv_stats(self) -> Dict[str, Any]:
        return self._engine.stats()

    def close(self) -> None:
        batching.shutdown_batchers(self)
