"""Connectors: composable observation/action preprocessing pipelines.

Reference surface: rllib/connectors/ (connector.py Connector/
ConnectorPipeline ABCs, agent/obs_preproc.py-style obs connectors,
action/clip.py-style action connectors). Connectors sit between env and
policy on the rollout worker: obs connectors transform observations before
inference, action connectors transform policy outputs before env.step.
Stateful connectors (MeanStdFilter) expose state()/set_state() so the
algorithm can sync statistics across workers the way the reference syncs
filter state through WorkerSet.

All transforms are pure numpy — they run on the rollout worker's host; the
policy never sees them (static shapes in, static shapes out). A copy of
``ray_tpu/rl/connectors.py``, which the port may not import.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np


class Connector:
    """One transform step. ``__call__`` maps a [batch, ...] array."""

    def __call__(self, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class ConnectorPipeline(Connector):
    """Ordered composition (reference: connector.py ConnectorPipeline)."""

    def __init__(self, connectors: Sequence[Connector] = ()):
        self.connectors: List[Connector] = list(connectors)

    def __call__(self, data: np.ndarray) -> np.ndarray:
        for c in self.connectors:
            data = c(data)
        return data

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def state(self) -> Dict[str, Any]:
        return {str(i): c.state() for i, c in enumerate(self.connectors)}

    def set_state(self, state: Dict[str, Any]) -> None:
        for i, c in enumerate(self.connectors):
            if str(i) in state:
                c.set_state(state[str(i)])


class FlattenObs(Connector):
    """[batch, *dims] -> [batch, prod(dims)]."""

    def __call__(self, data: np.ndarray) -> np.ndarray:
        return np.asarray(data).reshape(len(data), -1)


class ClipObs(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, data: np.ndarray) -> np.ndarray:
        return np.clip(data, self.low, self.high)


class MeanStdFilter(Connector):
    """Running mean/std observation normalizer (reference:
    rllib/utils/filter.py MeanStdFilter, applied as an agent connector).
    Welford accumulation; ``frozen`` stops updates (evaluation mode)."""

    def __init__(self, eps: float = 1e-8):
        self.count = 0.0
        self.mean: np.ndarray | float = 0.0
        self.m2: np.ndarray | float = 0.0
        self.eps = eps
        self.frozen = False

    def __call__(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, np.float64)
        if not self.frozen:
            for row in data:
                self.count += 1.0
                delta = row - self.mean
                self.mean = self.mean + delta / self.count
                self.m2 = self.m2 + delta * (row - self.mean)
        std = np.sqrt(self.m2 / max(1.0, self.count - 1)) + self.eps
        return ((data - self.mean) / std).astype(np.float32)

    def state(self) -> Dict[str, Any]:
        return {"count": self.count, "mean": self.mean, "m2": self.m2}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.count = state["count"]
        self.mean = state["mean"]
        self.m2 = state["m2"]


class ClipActions(Connector):
    """Clamp continuous actions to the env bounds (reference:
    rllib/connectors/action/clip.py)."""

    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def __call__(self, data: np.ndarray) -> np.ndarray:
        return np.clip(data, self.low, self.high)


class UnsquashActions(Connector):
    """Map [-1, 1] policy outputs onto [low, high] env bounds (reference:
    rllib/connectors/action/lambdas.py unsquash)."""

    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def __call__(self, data: np.ndarray) -> np.ndarray:
        return self.low + (np.asarray(data) + 1.0) * 0.5 * (self.high - self.low)
