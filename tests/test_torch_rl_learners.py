"""The port's RL learners (ray_tpu_torch.rl.learner, .pg, .a2c, .impala,
.appo) held to the reference's on the CPU.

The reference's loss functions are taken from its learners' jitted steps
and differentiated with ``jax.value_and_grad``; the port's learner starts
from the reference's weights (``rl.convert``) and takes the same numpy
batch. Each loss, its metrics and its gradient agree within rtol 1e-5 and
atol 1e-6; V-trace within 1e-6; the optimizer follows optax's
``chain(clip_by_global_norm, adam)`` over 10 steps within 1e-6; one whole
``update`` of each learner (PPO's: 6 epochs of 4 minibatches, 24 optimizer
steps) leaves every parameter within 1e-5 of the reference's; PPO over a
2-rank dp mesh (gloo) takes the one-rank step within 1e-6.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu import rl as ref
from ray_tpu_torch.models.training import ClippedAdamW
from ray_tpu_torch.parallel import launch
from ray_tpu_torch.rl import (
    APPOLearner,
    A2CLearner,
    ImpalaLearner,
    LearnerGroup,
    PGLearner,
    PPOLearner,
    SampleBatch,
    vtrace,
)
from ray_tpu_torch.rl.convert import params_to_state_dict, state_dict_to_params
from ray_tpu_torch.rl.learner import to_device

RTOL, ATOL = 1e-5, 1e-6
UPDATE_ATOL = 1e-5
OBS = 4

LEARNERS = {
    "ppo": (ref.PPOLearner, PPOLearner, dict(lr=3e-4)),
    "pg": (ref.PGLearner, PGLearner, dict(lr=2e-3, entropy_coeff=0.01)),
    "a2c": (ref.A2CLearner, A2CLearner, dict(lr=1e-3)),
    "impala": (ref.ImpalaLearner, ImpalaLearner, dict(lr=1e-3)),
    "appo": (ref.APPOLearner, APPOLearner, dict(lr=1e-3)),
}
TIME_MAJOR = ("impala", "appo")


def flat_batch(n: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.normal(size=(n, OBS)).astype(np.float32),
        actions=rng.integers(0, 2, size=n).astype(np.int32),
        logp=np.log(rng.uniform(0.2, 0.8, size=n)).astype(np.float32),
        advantages=rng.normal(size=n).astype(np.float32),
        returns=rng.normal(2.0, 3.0, size=n).astype(np.float32),
        rewards=np.ones(n, np.float32),
        dones=rng.uniform(size=n) < 0.05,
        values=rng.normal(size=n).astype(np.float32),
    )


def trajectory_batch(t: int = 32, b: int = 8, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.normal(size=(t, b, OBS)).astype(np.float32),
        actions=rng.integers(0, 2, size=(t, b)).astype(np.int32),
        rewards=rng.normal(1.0, 0.5, size=(t, b)).astype(np.float32),
        dones=rng.uniform(size=(t, b)) < 0.08,
        behavior_logp=np.log(rng.uniform(0.2, 0.8, size=(t, b))).astype(np.float32),
        bootstrap_obs=rng.normal(size=(b, OBS)).astype(np.float32),
    )


def _batch(kind: str) -> dict:
    return trajectory_batch() if kind in TIME_MAJOR else flat_batch(256)


def _pair(kind: str, seed: int = 0):
    ref_cls, port_cls, kw = LEARNERS[kind]
    r = ref_cls(OBS, 2, seed=seed, **kw)
    p = port_cls(OBS, 2, seed=seed + 1, device="cpu", **kw)
    p.set_weights(params_to_state_dict(jax.device_get(r.params)))
    return r, p


def _ref_loss_fn(learner):
    step = learner._grad_step if isinstance(learner, ref.PPOLearner) else learner._step
    return inspect.getclosurevars(step.__wrapped__).nonlocals["loss_fn"]


def _assert_tree_close(want, got, rtol, atol):
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(got)
    for path, a in jax.tree_util.tree_leaves_with_path(want):
        b = got
        for key in path:
            b = b[key.key]
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("kind", sorted(LEARNERS))
def test_loss_and_gradient_match_jax(kind):
    r, p = _pair(kind)
    batch = _batch(kind)
    (total, metrics), grads = jax.value_and_grad(_ref_loss_fn(r), has_aux=True)(
        r.params, {k: jnp.asarray(v) for k, v in batch.items()})
    p_grads, p_metrics = p.grad_step(to_device(SampleBatch(batch), p.device))
    np.testing.assert_allclose(float(p_metrics["total_loss"]), float(total), rtol=RTOL, atol=ATOL)
    assert set(p_metrics) == set(metrics) | {"total_loss"}
    for k, v in p_metrics.items():
        if k == "total_loss":
            continue
        np.testing.assert_allclose(float(v), float(metrics[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    got = state_dict_to_params(dict(zip(p.params, p_grads)))
    _assert_tree_close(jax.device_get(grads), got, RTOL, ATOL)


@pytest.mark.parametrize("kind", sorted(LEARNERS))
def test_one_update_matches_jax(kind):
    """One ``update`` from the same weights: PPO's over 512 rows in 6 epochs
    of 4 minibatches of 128 (24 optimizer steps), the others' one step;
    every parameter within 1e-5, the metrics within 1e-5."""
    r, p = _pair(kind, seed=2)
    if kind == "ppo":
        batch = flat_batch(512, seed=3)
        kw = dict(minibatch_size=128, num_epochs=6, seed=4)
        want = r.update(ref.SampleBatch(batch), **kw)
        got = p.update(SampleBatch(batch), **kw)
        assert p.opt_state.count == 24
    else:
        batch = _batch(kind)
        want = r.update(ref.SampleBatch(batch))
        got = p.update(SampleBatch(batch))
        assert p.opt_state.count == 1
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=UPDATE_ATOL, err_msg=k)
    _assert_tree_close(jax.device_get(r.params), state_dict_to_params(p.get_weights()),
                       0, UPDATE_ATOL)


def test_vtrace_matches_jax_with_episode_cuts():
    rng = np.random.default_rng(5)
    t, b = 32, 8
    args = [np.log(rng.uniform(0.1, 0.9, size=(t, b))).astype(np.float32) for _ in range(2)]
    args += [rng.normal(size=(t, b)).astype(np.float32) for _ in range(2)]
    args += [rng.normal(size=b).astype(np.float32), rng.uniform(size=(t, b)) < 0.1]
    assert args[-1].any()
    kw = dict(gamma=0.97, rho_bar=1.0, c_bar=0.9)
    want = ref.vtrace(*map(jnp.asarray, args), **kw)
    got = vtrace(*map(torch.from_numpy, args), **kw)
    for a, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), rtol=0, atol=1e-6)


def test_vtrace_outputs_carry_no_gradient():
    """vs and the policy-gradient advantages are targets (the reference's
    stop_gradient): no gradient flows back through them to the logp or the
    values."""
    t, b = 6, 3
    target = torch.zeros(t, b, requires_grad=True)
    values = torch.zeros(t, b, requires_grad=True)
    vs, adv = vtrace(target, torch.full((t, b), -0.5), torch.ones(t, b), values,
                     torch.zeros(b), torch.zeros(t, b, dtype=torch.bool))
    assert not vs.requires_grad and not adv.requires_grad


def test_optimizer_matches_optax_adam_chain():
    """``ClippedAdamW(b2=0.999)`` against ``optax.chain(clip_by_global_norm,
    adam(lr))`` over 10 steps of random gradients, some above the clip."""
    rng = np.random.default_rng(6)
    shapes = {"a": (64, 4), "b": (64,), "c": (2, 64)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))
    state = tx.init(params)
    port = {k: torch.tensor(v) for k, v in params.items()}
    opt = ClippedAdamW(learning_rate=3e-4, grad_clip=0.5, b1=0.9, b2=0.999, eps=1e-8)
    opt_state = opt.init(port)
    clipped = 0
    for step in range(10):
        scale = 0.02 if step % 2 else 1.0
        grads = {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
        clipped += float(optax.global_norm(grads)) > 0.5
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        opt_state, _ = opt.update(port, [torch.tensor(grads[k]) for k in port], opt_state)
        for k in params:
            np.testing.assert_allclose(port[k].numpy(), np.asarray(params[k]), rtol=0, atol=1e-6)
    assert 0 < clipped < 10


def test_learner_weights_round_trip_through_the_host():
    _, p = _pair("ppo")
    w = p.get_weights()
    assert all(v.device.type == "cpu" for v in w.values())
    w["torso_0.bias"] += 1.0  # a copy: the learner's parameters do not move
    assert not torch.equal(p.get_weights()["torso_0.bias"], w["torso_0.bias"])
    p.set_weights(w)
    assert torch.equal(p.get_weights()["torso_0.bias"], w["torso_0.bias"])


@pytest.mark.parametrize("kind", sorted(LEARNERS))
def test_learner_defaults_to_cuda_and_raises_without_a_card(kind):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LEARNERS[kind][1](OBS, 2)


def test_learner_group_of_several_needs_a_collective():
    with pytest.raises(ValueError, match="init_collective_group and allreduce"):
        LearnerGroup({"observation_size": OBS, "num_actions": 2, "device": "cpu"},
                     num_learners=2)


def test_local_learner_group_is_the_learner():
    batch = SampleBatch(flat_batch(256, seed=7))
    group = LearnerGroup({"observation_size": OBS, "num_actions": 2, "lr": 1e-2, "seed": 0,
                          "device": "cpu"})
    alone = PPOLearner(OBS, 2, lr=1e-2, seed=0, device="cpu")
    kw = dict(minibatch_size=64, num_epochs=2, seed=1)
    assert group.update(batch, **kw) == alone.update(batch, **kw)
    w, a = group.get_weights(), alone.get_weights()
    assert all(torch.equal(w[k], a[k]) for k in w)
    group.shutdown()


def _dp_rank(rank, world, batch, state, kw):
    from ray_tpu_torch.parallel.mesh import MeshSpec

    mesh = MeshSpec(dp=world).build("cpu")
    learner = PPOLearner(OBS, 2, lr=3e-4, seed=0, mesh=mesh, device="cpu")
    learner.set_weights(state)
    metrics = learner.update(SampleBatch(batch), **kw)
    return {k: v.numpy() for k, v in learner.get_weights().items()}, metrics


def test_ppo_dp_mesh_takes_the_one_rank_step():
    """Two gloo ranks over dp, each given the whole batch: every rank ends
    with the one-rank learner's weights and metrics within 1e-6."""
    batch = flat_batch(512, seed=8)
    kw = dict(minibatch_size=128, num_epochs=2, seed=9)
    alone = PPOLearner(OBS, 2, lr=3e-4, seed=0, device="cpu")
    state = alone.get_weights()
    want_metrics = alone.update(SampleBatch(batch), **kw)
    want = alone.get_weights()
    ranks = launch.spawn(functools.partial(_dp_rank, batch=batch, state=state, kw=kw), 2,
                         device="cpu", timeout=180)
    for weights, metrics in ranks:
        for k, v in want.items():
            np.testing.assert_allclose(weights[k], v.numpy(), rtol=0, atol=1e-6, err_msg=k)
        for k, v in want_metrics.items():
            np.testing.assert_allclose(metrics[k], v, rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(ranks[0][0]["torso_0.weight"], ranks[1][0]["torso_0.weight"])
