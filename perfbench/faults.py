"""Faults planted in the program under test, for the check's calibration
(``calibrate.py``) and its tests: each must make ``correct`` come out
false. Each is a context manager that patches ``ray_tpu_torch`` while
inside."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name: str, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def unchanged_state():
    """A train step that returns its state unchanged: the optimizer's update
    moves neither the parameters nor the moments."""
    import torch
    from ray_tpu_torch.models import training

    def update(self, params, grads, state, norm=None):
        return state, torch.zeros((), device=grads[0].device)

    with _patched(training.ClippedAdamW, "update", update):
        yield


@contextlib.contextmanager
def half_batch():
    """Half of each batch left out: the train and eval steps see the first
    half of the rows, and their mean is taken over those."""
    from ray_tpu_torch.models import training

    train, evaluate = training.make_train_step, training.make_eval_step

    def make_train_step(*args, **kwargs):
        step = train(*args, **kwargs)
        return lambda state, tokens: step(state, tokens[:tokens.shape[0] // 2])

    def make_eval_step(*args, **kwargs):
        step = evaluate(*args, **kwargs)
        return lambda params, tokens: step(params, tokens[:tokens.shape[0] // 2])

    with _patched(training, "make_train_step", make_train_step), \
            _patched(training, "make_eval_step", make_eval_step):
        yield


@contextlib.contextmanager
def answer_lag():
    """An answer altered where it is produced: each eval step returns the
    loss of the batch before its own (the first its own)."""
    from ray_tpu_torch.models import training

    evaluate = training.make_eval_step

    def make_eval_step(*args, **kwargs):
        step, answers = evaluate(*args, **kwargs), []

        def lagged(params, tokens):
            answers.append(step(params, tokens))
            return answers[-2] if len(answers) > 1 else answers[-1]
        return lagged

    with _patched(training, "make_eval_step", make_eval_step):
        yield


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "answer_lag": answer_lag}
#: the faults each step kind can have (one card: no exchange between chips)
BY_KIND = {"train": ("unchanged_state", "half_batch"), "eval": ("half_batch", "answer_lag")}
