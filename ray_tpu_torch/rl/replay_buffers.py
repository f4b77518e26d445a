"""Replay buffers: uniform ring buffer + proportional prioritized replay.

Reference: rllib/utils/replay_buffers/replay_buffer.py (ReplayBuffer.add /
sample over a ring of timesteps) and prioritized_replay_buffer.py
(proportional prioritization with importance-sampling weights, following
the PER formulation: P(i) ∝ p_i^alpha, w_i = (N * P(i))^-beta / max w).
The storage is columnar numpy arrays (one array per SampleBatch key)
rather than a deque of dicts — sampling a minibatch is a single fancy
index per column, which keeps the hot path vectorized.

A copy of ``ray_tpu/rl/replay_buffers.py``, which the port may not import:
numpy on the host, as there, so a seed draws the reference's rows and
weights.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.rl.sample_batch import SampleBatch


class ReplayBuffer:
    """Uniform-sampling ring buffer of timesteps."""

    def __init__(self, capacity: int, seed: Optional[int] = None):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._cols: Dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def _ensure_storage(self, batch: SampleBatch):
        for k, v in batch.items():
            if k not in self._cols:
                v = np.asarray(v)
                self._cols[k] = np.zeros(
                    (self.capacity,) + v.shape[1:], dtype=v.dtype
                )

    def add(self, batch: SampleBatch) -> np.ndarray:
        """Append a batch of timesteps; returns the slots they landed in."""
        self._ensure_storage(batch)
        n = len(batch)
        if n > self.capacity:
            # only the tail survives a wrap-around anyway
            batch = SampleBatch({k: v[-self.capacity:] for k, v in batch.items()})
            n = self.capacity
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._cols[k][idx] = np.asarray(v)
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)
        return idx

    def sample(self, num_items: int) -> SampleBatch:
        if self._size == 0:
            raise ValueError("cannot sample from an empty buffer")
        idx = self._rng.integers(0, self._size, size=num_items)
        return SampleBatch({k: v[idx] for k, v in self._cols.items()})

    def stats(self) -> Dict[str, int]:
        return {"size": self._size, "capacity": self.capacity}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional PER: sample ∝ priority^alpha, correct with IS weights.

    ``sample`` attaches two extra columns: ``weights`` (normalized
    importance-sampling weights for the loss) and ``batch_indexes`` (slots,
    to be passed back to :meth:`update_priorities` with the TD errors).
    """

    def __init__(
        self,
        capacity: int,
        alpha: float = 0.6,
        seed: Optional[int] = None,
    ):
        super().__init__(capacity, seed=seed)
        if alpha < 0:
            raise ValueError("alpha must be >= 0")
        self.alpha = alpha
        self._priorities = np.zeros(capacity, np.float64)
        self._max_priority = 1.0

    def add(self, batch: SampleBatch) -> np.ndarray:
        idx = super().add(batch)
        # new experience enters at max priority so it is seen at least once
        self._priorities[idx] = self._max_priority**self.alpha
        return idx

    def sample(self, num_items: int, beta: float = 0.4) -> SampleBatch:
        if self._size == 0:
            raise ValueError("cannot sample from an empty buffer")
        p = self._priorities[: self._size]
        total = p.sum()
        if total <= 0:
            probs = np.full(self._size, 1.0 / self._size)
        else:
            probs = p / total
        idx = self._rng.choice(self._size, size=num_items, p=probs)
        weights = (self._size * probs[idx]) ** (-beta)
        weights = weights / weights.max()
        out = SampleBatch({k: v[idx] for k, v in self._cols.items()})
        out["weights"] = weights.astype(np.float32)
        out["batch_indexes"] = idx.astype(np.int64)
        return out

    def update_priorities(self, indexes: np.ndarray, priorities: np.ndarray):
        priorities = np.abs(np.asarray(priorities, np.float64)) + 1e-6
        self._priorities[np.asarray(indexes)] = priorities**self.alpha
        self._max_priority = max(self._max_priority, float(priorities.max()))
