"""Step kind "train": the port's single-device train step,
``make_train_step(...)``'s ``step(state, tokens)``, on a fresh batch of the
pool each step.

Set-up builds the one step that the window drives and runs the first
``CHECK_STEPS`` steps through it from the weights drawn from the seed, on
the pool's first batches: they warm every shape, and the reference follows
them. Once the window has closed and its state is freed, the same call runs
those steps again from the same weights, so that what the window's call has
become after all its steps is judged too. Each number compared is the worse
of the two runs' (``Base.worst_gaps``); the reference runs once, after both:

* ``loss_gap``: each of those steps' loss against the reference's, the
  largest absolute gap;
* ``grad_gap``: each leaf's norm of the first clipped gradient, which the
  program's first moment holds after one step (mu = (1 - b1) g), by the
  worst leaf (``compare.leaf_gap``);
* ``update_gap``: each leaf's norm of the change of the parameters over
  those steps, as the next step finds them, by the worst leaf, over the
  leaves that the reference's first gradient moves (``compare.moved_leaves``).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from perfbench.core import compare, flops, program
from perfbench.kinds import Base, sync_time

#: steps of set-up that the reference follows, run again after the window
CHECK_STEPS = 3


class Kind(Base):
    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        self.losses: List[torch.Tensor] = []

    def work(self) -> Dict[str, object]:
        s, b, t = self.shape, self.batch, self.seq
        return {"flops_per_step": flops.train_step_flops(s, b, t),
                "attn_fwd": flops.attn_fwd_work(b, s.heads, t, s.head_dim, self.item),
                "attn_bwd": flops.attn_bwd_work(b, s.heads, t, s.head_dim, self.item),
                "attn_bwd_per_step": s.layers}

    def setup(self) -> None:
        self._inputs()
        self.step_fn, self.opt = program.train_step(self.config, self.device)
        self.first = self._checked_steps(self.timings)

    def _checked_steps(self, timings: Dict[str, float]) -> dict:
        """Runs the check's steps through the window's call from the weights
        drawn from the seed, leaving its state in ``self.state``; their
        readings. The seconds spent reading go to ``check_s``."""
        t0 = time.monotonic()
        self.state = program.train_state(self._weights(), self.opt)
        sync_time(timings, "weights and state", t0, self.device)
        for k in range(CHECK_STEPS):
            t0 = time.monotonic()
            self._step(k)
            sync_time(timings, f"step {k + 1}", t0, self.device)
            if k == 0:
                t0 = time.monotonic()
                norms = _norms(self.state.opt_state.mu)
                grad_norms = {n: x / (1 - self.opt.b1) for n, x in
                              zip(self.state.params, norms)}
                self.check_s += time.monotonic() - t0
        t0 = time.monotonic()
        readings = {"losses": torch.stack(self.losses).double().cpu().tolist(),
                    "grad_norms": grad_norms,
                    "update_norms": self._change_norms(self.state.params)}
        self.losses = []
        self.check_s += time.monotonic() - t0
        return readings

    def _change_norms(self, params: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Each leaf's norm of its change from the weights drawn at the
        start (drawn again from the seed)."""
        start = self._weights()
        return dict(zip(params, _norms(p.float() - start[n].float()
                                       for n, p in params.items())))

    def step(self, i: int) -> None:
        self._step((CHECK_STEPS + i) % self.traffic["pool"])

    def _step(self, k: int) -> None:
        self.state, metrics = self.step_fn(self.state, self.pool[k])
        self.losses.append(metrics["loss"])

    def finish(self) -> Dict[str, int]:
        """After the window's synchronize: (attempted, failed) over the
        window's steps, and the window's state freed. The checked steps are
        judged by ``check``, not here."""
        losses = torch.tensor([float(x) for x in self.losses], dtype=torch.float64)
        failed = int((~torch.isfinite(losses)).sum())
        del self.state
        self.losses = []
        return {"attempted": len(losses), "failed": failed}

    def reference_readings(self, precision: str = "fp32") -> dict:
        """The reference's losses, first clipped gradient norms and changes
        over the check's steps, from its own draw of the weights."""
        params = self._weights()
        batches = [self.pool[k] for k in range(CHECK_STEPS)]
        out = self.ref.train_steps(params, batches, self.shape,
                                   self.ref.AdamW.from_config(self.config),
                                   chunk=self.config["train"]["ce_chunk"],
                                   precision=precision)
        out["update_norms"] = self._change_norms(params)
        return out

    def readings(self) -> List[dict]:
        """Set-up's readings, and those of the check's steps run again
        through the window's call; the program's state freed after."""
        again = self._checked_steps(timings={})
        del self.state, self.step_fn
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        return [self.first, again]

    @staticmethod
    def gaps(mine: dict, ref: dict) -> Dict[str, float]:
        moved = compare.moved_leaves(ref["grad_norms"])
        return {"loss_gap": compare.max_abs_gap(mine["losses"], ref["losses"]),
                "grad_gap": compare.leaf_gap(mine["grad_norms"], ref["grad_norms"]),
                "update_gap": compare.leaf_gap(mine["update_norms"], ref["update_norms"],
                                               moved)}


def _norms(tensors) -> List[float]:
    """Each tensor's 2-norm, accumulated in float32, one tensor at a time
    (``tensors`` may be a generator, so only one lives at once)."""
    return torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32)
                        for t in tensors]).double().tolist()
