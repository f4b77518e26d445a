"""Step kind "eval": the port's ``make_eval_step(...)``'s
``eval_step(params, tokens) -> loss``, the forward and the blockwise loss
without gradients, on a fresh batch of the pool each step.

Set-up makes the weights and the pool and runs ``WARMUP`` steps on the
pool's first batches. Each step's answer is its loss; once the window has
closed and the program's state is freed, ``CHECK_BATCHES`` of the batches
answered in the window, drawn from the seed, are run through the reference,
and ``loss_gap`` is the largest absolute gap between a program's answer and
the reference's loss of its batch.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Tuple

import torch

from perfbench.core import compare, flops, inputs, program
from perfbench.kinds import Base, sync_time

#: steps that set-up runs on the pool's first batches
WARMUP = 2
#: batches answered in the window that the reference judges
CHECK_BATCHES = 6


class Kind(Base):
    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        self.answers: List[Tuple[int, torch.Tensor]] = []

    def work(self) -> Dict[str, object]:
        s, b, t = self.shape, self.batch, self.seq
        return {"flops_per_step": flops.eval_step_flops(s, b, t),
                "attn_fwd": flops.attn_fwd_work(b, s.heads, t, s.head_dim, self.item)}

    def _batch(self, i: int) -> int:
        return (i + WARMUP) % self.traffic["pool"]

    def setup(self) -> None:
        self._inputs()
        t0 = time.monotonic()
        self.params = self._weights()
        self.eval_fn = program.eval_step(self.config, self.device)
        sync_time(self.timings, "weights and state", t0, self.device)
        for i in range(WARMUP):
            t0 = time.monotonic()
            self.eval_fn(self.params, self.pool[i])
            sync_time(self.timings, f"step {i + 1}", t0, self.device)

    def step(self, i: int) -> None:
        k = self._batch(i)
        self.answers.append((k, self.eval_fn(self.params, self.pool[k])))

    def finish(self) -> Dict[str, int]:
        losses = torch.stack([loss for _, loss in self.answers]).double().cpu()
        by_batch: Dict[int, List[float]] = {}
        for (k, _), loss in zip(self.answers, losses.tolist()):
            by_batch.setdefault(k, []).append(loss)
        # every answer for a batch is judged: a batch answered twice counts
        # by its farthest answer
        rng = random.Random(inputs.stream_seed(self.seed, "check"))
        chosen = rng.sample(sorted(by_batch), min(CHECK_BATCHES, len(by_batch)))
        self.program_answers = {k: by_batch[k] for k in chosen}
        failed = int((~torch.isfinite(losses)).sum())
        del self.params, self.eval_fn
        self.answers = []
        return {"attempted": len(losses), "failed": failed}

    def reference_readings(self, precision: str = "fp32") -> Dict[int, List[float]]:
        params = self._weights()
        return {k: [self.ref.eval_loss(params, self.pool[k], self.shape,
                                       chunk=self.config["train"]["ce_chunk"],
                                       precision=precision)]
                for k in self.program_answers}

    def readings(self) -> List[Dict[int, List[float]]]:
        return [self.program_answers]

    @staticmethod
    def gaps(mine: Dict[int, List[float]], ref: Dict[int, List[float]]) -> Dict[str, float]:
        return {"loss_gap": max(compare.max_abs_gap(answers, ref[k] * len(answers))
                                for k, answers in mine.items())}
