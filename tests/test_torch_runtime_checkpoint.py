"""The sharded state's checkpoint (``training.gather_state`` /
``restore_sharded_state``) over gloo on four CPU ranks, at the layouts the
port's loops train: dp2·fsdp2, tp2 (dp2) and pp2·tp2 (stacked).

On every rank: the gathered tree at step 0 is the whole seed-0 weights
(``init_params``, stacked where the state is) with zero moments, and stays
so while the state trains on (the tree is a copy); after a
step, the restored state's blocks, moments, step and count are the
original's bit for bit; and the step after the restore gives the unbroken
run's loss, grad norm and parameters bit for bit. Every spawn has its own
time limit.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel import launch


def _round_trip(spec: dict, pipelined: bool, rank: int, world: int):
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.models.inference import init_params
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.sharding import pp_rules

    cfg = dataclasses.replace(gpt.gpt_nano(ce_chunk=16), num_layers=2, max_seq_len=32)
    mesh = MeshSpec(**spec).build("cpu")
    rules = pp_rules() if pipelined else None
    opt = training.default_optimizer(1e-3)
    state, sh = training.init_sharded_state(cfg, mesh, opt, seed=0, rules=rules,
                                            stacked=pipelined)
    if pipelined:
        step = training.make_pp_train_step(cfg, opt, mesh, num_microbatches=2, rules=rules,
                                           state_shardings_tree=sh)
    else:
        step = training.make_train_step(cfg, opt, mesh=mesh, state_shardings_tree=sh)
    batches = [torch.from_numpy(np.random.RandomState(k).randint(0, cfg.vocab_size, (8, 32)))
               for k in range(2)]

    whole = init_params(cfg, device="cpu", seed=0)
    if pipelined:
        whole = gpt.stack_layers(whole, cfg)
    tree0 = training.gather_state(state, mesh)
    at_init = (tree0["step"] == 0 and tree0["count"] == 0 and tree0["dtype"] == "float32"
               and set(tree0["params"]) == set(whole)
               and all(np.array_equal(tree0["params"][n], whole[n].numpy()) for n in whole)
               and all(not a.any() for a in (*tree0["mu"].values(), *tree0["nu"].values())))

    state, _ = step(state, batches[0])
    tree = training.gather_state(state, mesh)
    restored, _ = training.restore_sharded_state(tree, cfg, mesh, opt, rules=rules,
                                                 stacked=pipelined)

    def locals_of(s):
        return [t.to_local() for t in (*s.params.values(), *s.opt_state.mu, *s.opt_state.nu)]

    bitwise = (restored.step == state.step == 1 and restored.opt_state.count == 1
               and all(torch.equal(a, b) for a, b in zip(locals_of(state), locals_of(restored)))
               and all(tuple(a.placements) == tuple(b.placements)
                       for a, b in zip(state.params.values(), restored.params.values())))
    _, m_unbroken = step(state, batches[1])
    _, m_resumed = step(restored, batches[1])
    same_next = (float(m_unbroken["loss"]) == float(m_resumed["loss"])
                 and float(m_unbroken["grad_norm"]) == float(m_resumed["grad_norm"])
                 and all(torch.equal(a, b)
                         for a, b in zip(locals_of(state), locals_of(restored))))
    # the tree is a copy: the steps since it was gathered left it as it was
    # (at one rank a DTensor's whole is its live local tensor)
    at_init = at_init and all(np.array_equal(tree0["params"][n], whole[n].numpy())
                              for n in whole)
    return at_init, bitwise, same_next


@pytest.mark.parametrize("spec,pipelined", [({"dp": 2, "fsdp": 2}, False),
                                             ({"dp": 2, "tp": 2}, False),
                                             ({"pp": 2, "tp": 2}, True)],
                         ids=["dp2_fsdp2", "dp2_tp2", "pp2_tp2_stacked"])
def test_gather_and_restore_round_trip(spec, pipelined):
    res = launch.spawn(functools.partial(_round_trip, spec, pipelined), 4, device="cpu",
                       timeout=240)
    assert res == [(True, True, True)] * 4, res


def test_restore_refuses_another_dtype():
    from ray_tpu_torch.models import gpt, training

    cfg = gpt.gpt_nano()
    tree = {"dtype": "bfloat16", "params": {}, "mu": {}, "nu": {}, "step": 0, "count": 0}
    with pytest.raises(ValueError, match="the config wants"):
        training.restore_sharded_state(tree, cfg, {"dp": 1}, training.default_optimizer())
