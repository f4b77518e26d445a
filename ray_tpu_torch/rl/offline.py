"""Offline experience I/O: SampleBatches ⇄ columnar datasets (counterpart
of ``ray_tpu/rl/offline.py``).

Reference surface: rllib/offline/ (JsonWriter/JsonReader, the
input_/output_ config keys, and offline training via DatasetReader). The
reference writes and reads parquet through its runtime's datasets, which
the port may not import: the dataset comes in through
``RuntimeHooks.write_dataset`` / ``read_dataset`` (by default one parquet
file through pyarrow, the layout of a one-block dataset of the reference's
runtime). The columns are the reference's: a multi-dimensional column
flattens to ``<name>__<i>`` columns plus a ``<name>__shape`` marker, so a
file either side wrote reads back on the other.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from ray_tpu_torch.rl.replay_buffers import ReplayBuffer
from ray_tpu_torch.rl.sample_batch import SampleBatch
from ray_tpu_torch.runtime import RuntimeHooks

__all__ = ["load_replay_buffer", "read_sample_batches", "write_sample_batches"]


def _flatten(batch: SampleBatch) -> dict:
    """Columnar view: multi-dim columns (obs, continuous actions) flatten
    to fixed-width rows with a shape marker column for exact round-trip."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.ndim == 1:
            out[k] = v
        else:
            flat = v.reshape(len(v), -1)
            for i in range(flat.shape[1]):
                out[f"{k}__{i}"] = flat[:, i]
            out[f"{k}__shape"] = np.full(
                len(v), ",".join(map(str, v.shape[1:])), dtype=object
            )
    return out


def _unflatten(columns: dict) -> SampleBatch:
    out: dict = {}
    shapes = {
        k[: -len("__shape")]: v[0]
        for k, v in columns.items()
        if k.endswith("__shape")
    }
    grouped: dict = {}
    for k, v in columns.items():
        if k.endswith("__shape"):
            continue
        if "__" in k:
            base, idx = k.rsplit("__", 1)
            grouped.setdefault(base, {})[int(idx)] = np.asarray(v)
        else:
            out[k] = np.asarray(v)
    for base, cols in grouped.items():
        width = len(cols)
        mat = np.stack([cols[i] for i in range(width)], axis=1)
        shape = tuple(int(s) for s in str(shapes[base]).split(","))
        out[base] = mat.reshape((len(mat),) + shape)
    return SampleBatch(out)


def write_sample_batches(batches: List[SampleBatch], path: str,
                         hooks: Optional[RuntimeHooks] = None) -> List[str]:
    """Persist experience as an offline dataset (the reference's parquet
    columns) through ``hooks.write_dataset``; returns the files written."""
    hooks = hooks or RuntimeHooks()
    return hooks.write_dataset(_flatten(SampleBatch.concat(batches)), path)


def read_sample_batches(path: str, *, batch_size: int = 4096,
                        hooks: Optional[RuntimeHooks] = None) -> Iterator[SampleBatch]:
    """Stream SampleBatches back from an offline dataset."""
    hooks = hooks or RuntimeHooks()
    for cols in hooks.read_dataset(path, batch_size=batch_size):
        yield _unflatten(cols)


def load_replay_buffer(path: str, capacity: Optional[int] = None,
                       hooks: Optional[RuntimeHooks] = None) -> ReplayBuffer:
    """Fill a ReplayBuffer from an offline dataset — the bridge into DQN /
    SAC-style off-policy training from logged experience (reference:
    rllib/offline/dataset_reader.py feeding replay)."""
    batches = list(read_sample_batches(path, hooks=hooks))
    total = sum(len(b) for b in batches)
    buf = ReplayBuffer(capacity or max(1, total))
    for b in batches:
        buf.add(b)
    return buf
