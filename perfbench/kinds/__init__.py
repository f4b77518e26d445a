"""Step kinds: one module per value of a traffic file's ``step``, each with
a ``Kind(cell, seed, device)`` that the run drives: ``setup``, ``step(i)``
in the window, ``finish``, then ``check`` (``core/runner.py``)."""

import time
from typing import Dict, List

import torch

from perfbench.core import inputs, program
from perfbench.core.inputs import DTYPES
from perfbench.reference import load as load_reference


def sync_time(timings: Dict[str, float], name: str, t0: float, device) -> None:
    """``timings[name]``: the seconds since ``t0``, the card's queue drained."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    timings[name] = time.monotonic() - t0


class Base:
    """What every kind of a GPT configuration shares: the reference, the
    shape, the batch, the weights and the pool from the seed, and set-up's
    log of its parts."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.traffic = cell.config, cell.traffic
        self.ref = load_reference(self.config["reference"])
        self.shape = self.ref.Shape.from_config(self.config)
        self.batch, self.seq = self.traffic["batch"], self.traffic["seq"]
        self.param_dtype = DTYPES[self.config["train"]["param_dtype"]]
        self.item = DTYPES[self.config["train"]["compute_dtype"]].itemsize
        self.check_s = 0.0  # set-up time spent on the check's readings
        self.timings: Dict[str, float] = {}  # set-up's parts, for the log

    def worst_gaps(self, readings: List[dict], ref) -> Dict[str, float]:
        """Each number compared, by the worst of the program's ``readings``
        against the reference's (each reading's own in ``each_gaps``)."""
        self.each_gaps = [self.gaps(r, ref) for r in readings]
        return {k: max(g[k] for g in self.each_gaps) for k in self.each_gaps[0]}

    def check(self) -> Dict[str, float]:
        return self.worst_gaps(self.readings(), self.reference_readings())

    def tokens_per_step(self) -> int:
        return self.batch * self.seq

    def _weights(self) -> Dict[str, torch.Tensor]:
        return inputs.make_weights(self.ref.param_table(self.shape), self.param_dtype,
                                   self.seed, self.device, self.config["init_std"])

    def _inputs(self) -> None:
        """Checks the reference's parameter table against the port's, then
        makes the pool."""
        t0 = time.monotonic()
        table = {n: tuple(shape) for n, shape, _ in self.ref.param_table(self.shape)}
        if program.state_dict_shapes(self.config) != table:
            raise ValueError("the reference's parameter table is not the port's state_dict")
        self.timings["the port's import"] = time.monotonic() - t0
        t0 = time.monotonic()
        self.pool = inputs.token_pool(self.seed, self.shape.vocab, self.traffic["pool"],
                                      self.batch, self.seq, self.device)
        sync_time(self.timings, "the card and the pool", t0, self.device)
