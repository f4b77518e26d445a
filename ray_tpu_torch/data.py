"""Columns between a runtime's datasets and torch (counterpart of
``Dataset.to_jax`` in ``ray_tpu/data/dataset.py`` and ``from_jax`` in
``ray_tpu/data/read_api.py``).

``to_torch(batches)`` concatenates a dataset's numpy batches
(``ds.iter_batches(batch_size=None, batch_format="numpy")``) column by
column and uploads each column once. ``from_torch(tensors)`` gives numpy
columns for the runtime to build a dataset from
(``ray_tpu.data.from_numpy(from_torch(...))``); bf16 and the float8 types,
which numpy lacks, become float32 (the reference keeps ``ml_dtypes``'
bfloat16 there).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.util.collective import to_host

__all__ = ["to_torch", "from_torch"]


def to_torch(batches: Iterable[Dict[str, Any]], columns: Optional[List[str]] = None,
             device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """{column: tensor on ``device``} (default CUDA) of the batches'
    columns (all of the first batch's, or ``columns``), each the batches'
    arrays concatenated; {} for no batches."""
    dev = resolve_device(device)
    batches = list(batches)
    if not batches:
        return {}
    names = columns or list(batches[0].keys())
    return {name: torch.from_numpy(np.concatenate([b[name] for b in batches])).to(dev)
            for name in names}


def from_torch(tensors) -> Dict[str, np.ndarray]:
    """{column: numpy array} of a tensor or a dict of tensors (a bare tensor
    is the column ``"data"``, as in the reference)."""
    if not isinstance(tensors, dict):
        tensors = {"data": tensors}
    return {name: to_host(t)[0] for name, t in tensors.items()}
