"""The port's off-policy learners (ray_tpu_torch.rl.dqn, .apex, .sac, .cql,
.td3, .bc) held to the reference's on the CPU.

Both sides start from the same seed, so from the same weights (the port
draws the reference's, ``rl.prng``), take the same numpy batch and the
same update key. DQN's and MARWIL's loss functions come out of the
reference's jitted steps and go through ``jax.value_and_grad``. SAC, CQL
and TD3 take up to three gradient steps inside one jitted update; the
reference's gradients are read from its optimizers, each wrapped so that
its state keeps the last gradient it was given. Loss, metrics and gradients agree
within rtol 1e-5 and atol 1e-6, and so do the parameters after 3 updates
under Adam, except where a step's gradient is at the rounding floor
(|g| < 1e-6, against typical gradients of 1e-3): Adam's first update there
is lr * g / (|g| + 1e-8), whose sign and size the last bits decide, so those
elements are held to 2 * lr a step (PR 10's rule for the pipelined step;
C51 at seed 3 has one such element, whose first gradient is -2.2e-8). TD3 covers an actor step and a skipped one (both targets
unchanged). ``categorical_projection`` (an integral ``b`` included),
``_nstep_batch`` (truncations included), the workers' transitions (argmax
ties included) and ``monte_carlo_returns`` are held to the reference's
values.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rl import apex as ref_apex
from ray_tpu.rl import bc as ref_bc
from ray_tpu.rl import cql as ref_cql
from ray_tpu.rl import dqn as ref_dqn
from ray_tpu.rl import sac as ref_sac
from ray_tpu.rl import td3 as ref_td3
from ray_tpu.rl.sample_batch import SampleBatch as RefBatch
from ray_tpu_torch.rl import apex, bc, cql, dqn, offline, sac, td3
from ray_tpu_torch.rl.convert import params_to_state_dict, state_dict_to_params
from ray_tpu_torch.rl.learner import to_device
from ray_tpu_torch.rl.sample_batch import SampleBatch
from ray_tpu_torch.runtime import RuntimeHooks

RTOL, ATOL = 1e-5, 1e-6
OBS = 4
CPU = torch.device("cpu")


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=err_msg)


GRAD_FLOOR = 1e-6


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _assert_tree_close(want, got, floor=None, slack=0.0, leaf_rtol=None):
    """Leaf by leaf within the limits; where the tree ``floor`` is True (a
    gradient at the rounding floor), within ``slack`` instead. With
    ``leaf_rtol`` each leaf within atol + leaf_rtol times its largest
    entry."""
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(got)
    for path, a in jax.tree_util.tree_leaves_with_path(want):
        a, b = np.asarray(a), np.asarray(_leaf(got, path))
        name = jax.tree_util.keystr(path)
        if leaf_rtol is not None:
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL + leaf_rtol * np.abs(a).max(),
                                       err_msg=name)
            continue
        if floor is not None:
            mask = np.asarray(_leaf(floor, path))
            assert (np.abs(b - a)[mask] <= slack).all(), name
            a, b = np.where(mask, 0, a), np.where(mask, 0, b)
        _close(b, a, name)


class _Steps:
    """Records each optimizer step's gradients of a port ``AdamParams``
    before taking it."""

    def __init__(self, opt, module):
        self.module, self.grads, step = module, [], opt.step

        def recorded(grads):
            self.grads.append([g.detach().clone() for g in grads])
            step(grads)
        opt.step = recorded

    def floor(self):
        """The tree of elements whose gradient was at the rounding floor at
        some step."""
        low = [torch.stack([g[i].abs() for g in self.grads]).amin(0) < GRAD_FLOOR
               for i in range(len(self.grads[0]))]
        return state_dict_to_params(dict(zip(dict(self.module.named_parameters()), low)))


def _params(module, **kw):
    return state_dict_to_params(module.state_dict(), **kw)


def _grads_tree(module, grads):
    return state_dict_to_params({k: g for k, g in zip(dict(module.named_parameters()), grads)})


# -- DQN ------------------------------------------------------------------

DQN_CASES = {
    "double_q": {},
    "double_q_prioritized": {"weights": True},
    "dueling_noisy_nstep": {"dueling": True, "noisy": True, "n_step": 3, "weights": True},
    "c51": {"num_atoms": 51},
    "rainbow": {"dueling": True, "noisy": True, "n_step": 3, "num_atoms": 51,
                "weights": True},
}


def dqn_batch(n=64, seed=0, weights=False, obs=OBS):
    rng = np.random.default_rng(seed)
    b = dict(obs=rng.normal(size=(n, obs)).astype(np.float32),
             actions=rng.integers(0, 2, n).astype(np.int32),
             rewards=rng.normal(1.0, 1.0, n),  # float64, as a replay column may be
             new_obs=rng.normal(size=(n, obs)).astype(np.float32),
             dones=rng.uniform(size=n) < 0.2)
    if weights:
        b["weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
        b["batch_indexes"] = np.arange(n, dtype=np.int64)
    return b


def _dqn_pair(case, seed=0):
    knobs = {k: v for k, v in DQN_CASES[case].items() if k != "weights"}
    r = ref_dqn.DQNLearner(OBS, 2, seed=seed, **knobs)
    p = dqn.DQNLearner(OBS, 2, seed=seed, device="cpu", **knobs)
    _assert_tree_close(jax.device_get(r.params), _params(p.net))
    return r, p


def _ref_loss_fn(learner):
    return inspect.getclosurevars(learner._step.__wrapped__).nonlocals["loss_fn"]


@pytest.mark.parametrize("case", sorted(DQN_CASES))
def test_dqn_loss_td_and_gradient_match_jax(case):
    r, p = _dqn_pair(case)
    batch = dqn_batch(weights=DQN_CASES[case].get("weights", False))
    # a target network a step away from the online one
    r.target_params = jax.tree_util.tree_map(lambda x: x * 0.9, r.params)
    p.target_net.load_state_dict(params_to_state_dict(jax.device_get(r.target_params)))
    key = jax.random.PRNGKey(5)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "batch_indexes"}
    (loss, td), grads = jax.value_and_grad(_ref_loss_fn(r), has_aux=True)(
        r.params, r.target_params, jb, key)
    tb = to_device({k: v for k, v in batch.items() if k != "batch_indexes"}, CPU)
    assert tb["rewards"].dtype == torch.float32
    p_grads, p_loss, p_td = p.grad_step(tb, np.asarray(key))
    _close(float(p_loss), float(loss))
    _close(p_td.numpy(), td)
    _assert_tree_close(jax.device_get(grads), _grads_tree(p.net, p_grads))


@pytest.mark.parametrize("case", sorted(DQN_CASES))
def test_dqn_three_updates_match_jax(case):
    """Three ``update`` calls (the update key split each time, prioritized
    weights where the case has them): losses, TD errors and every
    parameter within the limits."""
    r, p = _dqn_pair(case, seed=3)
    steps = _Steps(p.opt, p.net)
    for i in range(3):
        batch = dqn_batch(seed=10 + i, weights=DQN_CASES[case].get("weights", False))
        want_loss, want_td = r.update(RefBatch(batch))
        got_loss, got_td = p.update(SampleBatch(batch))
        _close(got_loss, want_loss)
        _close(got_td, want_td)
    assert p.opt_state.count == 3
    floor = steps.floor()
    _assert_tree_close(jax.device_get(r.params), _params(p.net), floor, 2 * 1e-3 * 3)
    p.sync_target()
    r.sync_target()
    _assert_tree_close(jax.device_get(r.target_params), _params(p.target_net), floor,
                       2 * 1e-3 * 3)


def test_c51_projection_and_support_match_the_reference():
    rng = np.random.default_rng(1)
    z_ref = ref_dqn.atom_support(0.0, 200.0, 51)
    z = dqn.atom_support(0.0, 200.0, 51)
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_ref))
    next_dist = rng.dirichlet(np.ones(51), size=32).astype(np.float32)
    rewards = rng.normal(1.0, 5.0, 32).astype(np.float32)
    not_done = (rng.uniform(size=32) > 0.3).astype(np.float32)
    # integral b: reward on an atom and a terminal -> all the mass on it
    rewards[:4] = [0.0, 4.0, 200.0, 96.0]
    not_done[:4] = 0.0
    for gamma_n in (0.99, 0.99 ** 3, 1.0):
        want = ref_dqn.categorical_projection(jnp.asarray(next_dist), jnp.asarray(rewards),
                                              jnp.asarray(not_done), gamma_n, z_ref)
        got = dqn.categorical_projection(torch.from_numpy(next_dist), torch.from_numpy(rewards),
                                         torch.from_numpy(not_done), gamma_n, z)
        _close(got.numpy(), want)
    atom = [0, 1, 50, 24]
    np.testing.assert_allclose(got.numpy()[np.arange(4), atom], 1.0, rtol=0, atol=1e-6)
    logits = rng.normal(size=(8, 2, 51)).astype(np.float32)
    _close(dqn.expected_q(torch.from_numpy(logits), z).numpy(),
           ref_dqn.expected_q(jnp.asarray(logits), z_ref))


def test_nstep_batch_matches_the_reference_with_truncations():
    """Random episodes over 12 steps of 3 envs, with terminals and
    time-limit truncations (which end a chain but are not ``done``)."""
    rng = np.random.default_rng(2)
    T, E = 12, 3
    obs_l = [rng.normal(size=(E, OBS)).astype(np.float32) for _ in range(T)]
    act_l = [rng.integers(0, 2, E).astype(np.int32) for _ in range(T)]
    rew_l = [rng.normal(size=E).astype(np.float32) for _ in range(T)]
    next_l = [rng.normal(size=(E, OBS)).astype(np.float32) for _ in range(T)]
    done_l = [rng.uniform(size=E) < 0.15 for _ in range(T)]
    trunc_l = [(rng.uniform(size=E) < 0.15) & ~d for d in done_l]
    ended_l = [d | t for d, t in zip(done_l, trunc_l)]
    assert any(t.any() for t in trunc_l) and any(d.any() for d in done_l)
    for n_step, gamma in ((3, 0.99), (5, 0.5)):
        ref = ref_dqn.DQNRolloutWorker._cls.__new__(ref_dqn.DQNRolloutWorker._cls)
        port = dqn.DQNRolloutWorker.__new__(dqn.DQNRolloutWorker)
        for w in (ref, port):
            w.n_step, w.gamma = n_step, gamma
        want = ref._nstep_batch(obs_l, act_l, rew_l, next_l, done_l, ended_l)
        got = port._nstep_batch(obs_l, act_l, rew_l, next_l, done_l, ended_l)
        assert set(want) == set(got)
        for k in want:
            assert want[k].dtype == got[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


WORKER_CASES = {"epsilon": {}, "noisy_dueling": {"noisy": True, "dueling": True},
                "c51_nstep": {"num_atoms": 21, "v_max": 120.0, "n_step": 3},
                "ties": {}}


@pytest.mark.parametrize("case", sorted(WORKER_CASES))
def test_dqn_worker_samples_the_reference_transitions(case):
    """The same seed, so the same weights, env episodes, epsilon draws and
    noise keys: the same transitions, actions included. Under "ties" the
    two actions' Q-values are equal everywhere: argmax takes the first
    action on both sides."""
    knobs = WORKER_CASES[case]
    ref = ref_dqn.DQNRolloutWorker._cls("CartPole-v1", num_envs=3, seed=4, **knobs)
    port = dqn.DQNRolloutWorker("CartPole-v1", num_envs=3, seed=4, device="cpu", **knobs)
    if case == "ties":
        params = jax.tree.map(np.array, jax.device_get(ref.params))
        params["q_head"]["kernel"][:, 1] = params["q_head"]["kernel"][:, 0]
        params["q_head"]["bias"][1] = params["q_head"]["bias"][0]
        ref.set_weights(params)
        port.set_weights(params_to_state_dict(params))
    for _ in range(2):
        want, got = ref.sample(16, 0.3), port.sample(16, 0.3)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if case == "ties":
        greedy_ref, greedy_port = ref.sample(8, 0.0), port.sample(8, 0.0)
        assert (greedy_port["actions"] == 0).all()
        np.testing.assert_array_equal(greedy_port["actions"], greedy_ref["actions"])
    assert ref.episode_returns() == port.episode_returns()


@pytest.mark.parametrize("n_step", [1, 3])
def test_apex_worker_td_error_matches_the_reference(n_step):
    ref = ref_apex.ApexRolloutWorker._cls("CartPole-v1", num_envs=4, seed=2, n_step=n_step,
                                          gamma=0.97)
    port = apex.ApexRolloutWorker("CartPole-v1", num_envs=4, seed=2, n_step=n_step,
                                  gamma=0.97, device="cpu")
    batch = ref.sample(16, 0.5)
    want = ref._td(ref.params, jnp.asarray(batch["obs"]), jnp.asarray(batch["actions"]),
                   jnp.asarray(batch["rewards"]), jnp.asarray(batch["new_obs"]),
                   jnp.asarray(batch["dones"], jnp.float32))
    _close(port.td_error(SampleBatch(batch)), want)


# -- SAC, CQL, TD3 ----------------------------------------------------------

def cont_batch(n=64, seed=0, obs=3, act=1):
    rng = np.random.default_rng(seed)
    return dict(obs=rng.normal(size=(n, obs)).astype(np.float32),
                actions=rng.uniform(-2, 2, (n, act)).astype(np.float32),
                rewards=rng.normal(-5.0, 2.0, n).astype(np.float32),
                next_obs=rng.normal(size=(n, obs)).astype(np.float32),
                dones=(rng.uniform(size=n) < 0.1).astype(np.float32))


def capturing(tx):
    """``tx`` whose state also keeps the last gradient it was given."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)
    return optax.GradientTransformation(init, update)


def _ref_algo(cls, config, optimizers):
    """The reference algorithm's update state without its rollout actors
    (its ``__init__`` up to the workers), each optimizer ``optax.adam``
    under ``capturing``."""
    algo = cls.__new__(cls)
    algo.config = config
    algo.scale = 2.0
    rng = jax.random.PRNGKey(config.seed)
    obs0, act0 = jnp.zeros((1, 3)), jnp.zeros((1, 1))
    algo.policy = (ref_td3.DeterministicPolicy if cls is ref_td3.TD3 else ref_sac.GaussianPolicy)(
        1, tuple(config.hidden))
    algo.qnet = ref_sac.TwinQ(tuple(config.hidden))
    algo.pi_params = algo.policy.init(rng, obs0)["params"]
    algo.q_params = algo.qnet.init(rng, obs0, act0)["params"]
    algo.q_target = jax.tree.map(jnp.copy, algo.q_params)
    if cls is ref_td3.TD3:
        algo.pi_target = jax.tree.map(jnp.copy, algo.pi_params)
    if cls is ref_sac.SAC:
        algo.log_alpha = jnp.zeros(())
        algo.target_entropy = -1.0
    for name, lr in optimizers.items():
        setattr(algo, name, capturing(optax.adam(lr)))
    algo.pi_opt_state = algo.pi_opt.init(algo.pi_params)
    algo.q_opt_state = algo.q_opt.init(algo.q_params)
    if cls is ref_sac.SAC:
        algo.a_opt_state = algo.a_opt.init(algo.log_alpha)
    algo._update = algo._build_update()
    return algo


def _memory_hooks(batch) -> RuntimeHooks:
    """Hooks whose dataset read gives ``batch``'s columns from memory."""
    cols = offline._flatten(SampleBatch(batch))
    return RuntimeHooks(read_dataset=lambda path, batch_size=4096: iter([cols]))


def _sac_port(**cfg):
    return sac.SACConfig(device="cpu", rollout_device="cpu", num_envs_per_worker=1,
                         **cfg).build()


def _cql_port(**cfg):
    return cql.CQLConfig(device="cpu", batch_size=64, hooks=_memory_hooks(cont_batch(64)),
                         **cfg).build()


def _td3_port(ddpg=False, **cfg):
    config = (td3.DDPGConfig if ddpg else td3.TD3Config)(
        device="cpu", rollout_device="cpu", num_envs_per_worker=1, **cfg)
    return config.build()


ALGOS = {
    # name: (reference class, reference config, optimizer lrs, port factory,
    #        state names (reference attribute, port module))
    "sac": (ref_sac.SAC, lambda: ref_sac.SACConfig(),
            {"pi_opt": 3e-4, "q_opt": 3e-4, "a_opt": 3e-4}, _sac_port),
    "sac_fixed_alpha": (ref_sac.SAC, lambda: ref_sac.SACConfig(fixed_alpha=0.2),
                        {"pi_opt": 3e-4, "q_opt": 3e-4, "a_opt": 3e-4},
                        lambda: _sac_port(fixed_alpha=0.2)),
    "cql": (ref_cql.CQL, lambda: ref_cql.CQLConfig(batch_size=64),
            {"pi_opt": 3e-4, "q_opt": 3e-4}, _cql_port),
    "td3": (ref_td3.TD3, lambda: ref_td3.TD3Config(), {"pi_opt": 3e-4, "q_opt": 3e-4},
            _td3_port),
    "ddpg": (ref_td3.TD3, lambda: ref_td3.DDPGConfig(), {"pi_opt": 3e-4, "q_opt": 3e-4},
             lambda: _td3_port(ddpg=True)),
}


def _ref_call(name, algo, batch, key, step):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if name.startswith("sac"):
        out = algo._update(algo.pi_params, algo.q_params, algo.q_target, algo.log_alpha,
                           algo.pi_opt_state, algo.q_opt_state, algo.a_opt_state, jb, key)
        (algo.pi_params, algo.q_params, algo.q_target, algo.log_alpha, algo.pi_opt_state,
         algo.q_opt_state, algo.a_opt_state, metrics) = out
    elif name == "cql":
        out = algo._update(algo.pi_params, algo.q_params, algo.q_target, algo.pi_opt_state,
                           algo.q_opt_state, jb, key)
        (algo.pi_params, algo.q_params, algo.q_target, algo.pi_opt_state, algo.q_opt_state,
         metrics) = out
    else:
        out = algo._update(algo.pi_params, algo.q_params, algo.pi_target, algo.q_target,
                           algo.pi_opt_state, algo.q_opt_state, jb, key, jnp.asarray(step))
        (algo.pi_params, algo.q_params, algo.pi_target, algo.q_target, algo.pi_opt_state,
         algo.q_opt_state, metrics) = out
    return {k: float(v) for k, v in metrics.items()}


def _port_call(name, algo, batch, key, step):
    tb = to_device(batch, CPU)
    metrics = (algo.update(tb, key, step) if name in ("td3", "ddpg") else algo.update(tb, key))
    return {k: float(v) for k, v in metrics.items()}


def _compare_state(name, ref, port, floors=None, slack=0.0):
    """The port's parameters and targets against the reference's;
    ``floors``: (policy, critic) trees of rounding-floor elements, and the
    targets' share of a critic step is tau of it."""
    pi_floor, q_floor = floors or (None, None)
    _assert_tree_close(jax.device_get(ref.pi_params), _params(port.policy), pi_floor, slack)
    _assert_tree_close(jax.device_get(ref.q_params), _params(port.qnet), q_floor, slack)
    _assert_tree_close(jax.device_get(ref.q_target), _params(port.q_target), q_floor, slack)
    if name in ("td3", "ddpg"):
        _assert_tree_close(jax.device_get(ref.pi_target), _params(port.pi_target), pi_floor,
                           slack)
    if name == "sac":
        _close(float(port.log_alpha.detach()), float(ref.log_alpha))


STEP_SLACK = 2 * 3e-4  # a rounding-floor element's limit, a step
ACTOR_LEAF_RTOL = 2e-5
# SAC's metrics that are means of the tanh-corrected log-probability
SAC_LOGP_METRICS, SAC_LOGP_RTOL = ("entropy", "pi_loss"), 1e-4


def _port_steps(port):
    return {"q_opt": _Steps(port.q_opt, port.qnet), "pi_opt": _Steps(port.pi_opt, port.policy),
            **({"a_opt": _Steps(port.a_opt, port.temperature)} if hasattr(port, "a_opt")
               else {})}


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_update_metrics_and_gradients_match_jax(name):
    """Three updates (for TD3 an actor step, a skipped one, an actor
    step): each critic, actor and temperature gradient, every metric, and
    the parameters and targets after each. On TD3's skipped step neither
    target network moves and no actor gradient is taken.

    Each gradient leaf is held against its largest entry, not element by
    element: within atol 1e-6 plus 1e-5 of it for the critics, plus 2e-5
    for the actors. SAC's actor gradient runs through
    log(1 - tanh(x)^2 + 1e-6), where XLA's and torch's float32 tanh differ
    in the last bits and the cancellation magnifies that: against a float64
    run of the same first update the port's actor gradient is the nearer of
    the two (worst 1.7e-6 against the reference's 4.1e-6, on a leaf whose
    largest entry is 0.44), so the two float32 results differ by more than
    1e-5 of the leaf. For the same reason SAC's ``entropy`` and ``pi_loss``
    (means of that log-probability; 2.0e-5 apart at the third update) are
    held to rtol 1e-4, ``chip_smoke.py`` 9a's limit; every other metric to
    rtol 1e-5."""
    ref_cls, ref_cfg, opts, port_factory = ALGOS[name]
    ref = _ref_algo(ref_cls, ref_cfg(), opts)
    port = port_factory()
    steps = _port_steps(port)
    _compare_state(name, ref, port)
    for step in range(3):
        targets = (jax.device_get(ref.q_target), jax.device_get(getattr(ref, "pi_target", {})))
        taken = {k: len(v.grads) for k, v in steps.items()}
        batch, key = cont_batch(seed=20 + step), jax.random.PRNGKey(30 + step)
        want = _ref_call(name, ref, batch, key, step)
        got = _port_call(name, port, batch, np.asarray(key), step)
        assert set(want) == set(got)
        for k in want:
            rtol = SAC_LOGP_RTOL if name.startswith("sac") and k in SAC_LOGP_METRICS else RTOL
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=ATOL, err_msg=k)
        skipped = name == "td3" and step % 2 == 1
        for opt_name, rec in steps.items():
            if skipped and opt_name == "pi_opt":
                assert len(rec.grads) == taken[opt_name]
                continue
            assert len(rec.grads) == taken[opt_name] + 1, opt_name
            want_g = jax.device_get(getattr(ref, f"{opt_name}_state")[1])
            if opt_name == "a_opt":
                _close(float(rec.grads[-1][0]), float(want_g), "log_alpha")
            else:
                _assert_tree_close(want_g, _grads_tree(rec.module, rec.grads[-1]),
                                   leaf_rtol=ACTOR_LEAF_RTOL if opt_name == "pi_opt" else RTOL)
        floors = (steps["pi_opt"].floor() if steps["pi_opt"].grads else None,
                  steps["q_opt"].floor())
        _compare_state(name, ref, port, floors, STEP_SLACK * (step + 1))
        if skipped:
            # lax.cond's skip branch: neither target network moves
            _assert_tree_close(targets[0], _params(port.q_target))
            _assert_tree_close(targets[1], _params(port.pi_target))
            assert got["pi_loss"] == 0.0


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_three_adam_updates_match_jax(name):
    """Three updates at a batch of 256 (the configs' size): metrics and
    every parameter and target after them."""
    ref_cls, ref_cfg, opts, port_factory = ALGOS[name]
    ref = _ref_algo(ref_cls, ref_cfg(), opts)
    port = port_factory()
    steps = _port_steps(port)
    for step in range(3):
        batch, key = cont_batch(256, seed=40 + step), jax.random.PRNGKey(50 + step)
        want = _ref_call(name, ref, batch, key, step)
        got = _port_call(name, port, batch, np.asarray(key), step)
        for k in want:
            _close(got[k], want[k], k)
    _compare_state(name, ref, port, (steps["pi_opt"].floor(), steps["q_opt"].floor()),
                   STEP_SLACK * 3)


def test_sac_worker_samples_the_reference_actions():
    """Warm-up actions from numpy seeded by the key's first word (0), then
    policy actions from the split keys: the same transitions."""
    ref = ref_sac.SACRolloutWorker._cls("Pendulum-v1", num_envs=2, seed=3)
    port = sac.SACRolloutWorker("Pendulum-v1", num_envs=2, seed=3, device="cpu")
    for random_actions in (True, False, False):
        want, got = ref.sample(8, random_actions), port.sample(8, random_actions)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-5, err_msg=k)
    assert int(port._rng[0]) == int(ref._rng[0]) != 0


def test_td3_worker_samples_the_reference_actions():
    ref = ref_td3.TD3RolloutWorker._cls("Pendulum-v1", num_envs=2, seed=3)
    port = td3.TD3RolloutWorker("Pendulum-v1", num_envs=2, seed=3, device="cpu")
    for random_actions in (True, False):
        want, got = ref.sample(8, random_actions), port.sample(8, random_actions)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-5, err_msg=k)


# -- MARWIL / BC --------------------------------------------------------------

def offline_batch(n=768, seed=0):
    rng = np.random.default_rng(seed)
    return dict(obs=rng.normal(size=(n, OBS)).astype(np.float32),
                actions=rng.integers(0, 2, n).astype(np.int32),
                rewards=np.ones(n, np.float32),
                dones=rng.uniform(size=n) < 0.05)


def _marwil_pair(beta, monkeypatch, batch):
    monkeypatch.setattr(ref_bc.MARWIL, "_load",
                        staticmethod(lambda path: RefBatch({k: v for k, v in batch.items()})))
    ref_cfg, port_cfg = ((ref_bc.BCConfig, bc.BCConfig) if beta == 0.0 else
                         (ref_bc.MARWILConfig, bc.MARWILConfig))
    kw = dict(batch_size=256, seed=1) | ({} if beta == 0.0 else {"beta": beta})
    ref = ref_cfg(input_path="mem", **kw).build()
    port = port_cfg(input_path="mem", device="cpu", hooks=_memory_hooks(batch), **kw).build()
    _assert_tree_close(jax.device_get(ref.params), _params(port.net))
    np.testing.assert_array_equal(port.returns, ref.returns)
    return ref, port


@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_marwil_loss_and_gradient_match_jax(beta, monkeypatch):
    batch = offline_batch()
    ref, port = _marwil_pair(beta, monkeypatch, batch)
    idx = np.arange(256)
    rows = {"obs": ref.obs[idx], "actions": ref.actions[idx], "returns": ref.returns[idx]}
    # the normaliser a running E[adv^2] reaches: the weights' exponents O(1)
    norm = float(np.mean(rows["returns"] ** 2))
    (total, (pl, vl, new_norm)), grads = jax.value_and_grad(_ref_loss_fn(ref), has_aux=True)(
        ref.params, {k: jnp.asarray(v) for k, v in rows.items()}, jnp.asarray(norm))
    p_total, (p_pl, p_vl, p_norm) = port.loss({k: torch.from_numpy(v) for k, v in rows.items()},
                                              torch.tensor(norm))
    for got, want in ((p_total, total), (p_pl, pl), (p_vl, vl), (p_norm, new_norm)):
        _close(float(got.detach()), float(want))
    _assert_tree_close(jax.device_get(grads), _grads_tree(port.net, port.opt.grads(p_total)))


@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_marwil_three_steps_match_jax(beta, monkeypatch):
    """One epoch over 768 rows in the reference's shuffled order: 3 steps
    of 256, the moving normaliser carried between them."""
    ref, port = _marwil_pair(beta, monkeypatch, offline_batch(seed=2))
    steps = _Steps(port.opt, port.net)
    want, got = ref.train(epochs=1), port.train(epochs=1)
    assert port.opt.opt_state.count == 3
    for k in ("total_loss", "policy_loss", "vf_loss"):
        _close(got[k], want[k], k)
    _close(float(port._adv_norm), float(ref._adv_norm))
    _assert_tree_close(jax.device_get(ref.params), _params(port.net), steps.floor(),
                       2 * 1e-3 * 3)


def test_monte_carlo_returns_match_the_reference():
    rng = np.random.default_rng(4)
    rewards = rng.normal(size=200).astype(np.float32)
    dones = rng.uniform(size=200) < 0.1
    np.testing.assert_array_equal(bc.monte_carlo_returns(rewards, dones, 0.97),
                                  ref_bc.monte_carlo_returns(rewards, dones, 0.97))


def test_offpolicy_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for make in (lambda: dqn.DQNLearner(OBS, 2),
                 lambda: dqn.DQNRolloutWorker("CartPole-v1"),
                 lambda: sac.SACConfig().build(),
                 lambda: td3.TD3Config().build(),
                 lambda: sac.SACRolloutWorker("Pendulum-v1")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_clipped_adamw_without_a_clip_is_optax_adam():
    """``grad_clip=None`` is ``optax.adam`` alone: gradients far above any
    clip go in whole, a 0-d parameter included, over 5 steps."""
    from ray_tpu_torch.models.training import ClippedAdamW

    rng = np.random.default_rng(6)
    params = {"w": rng.normal(size=(8, 3)).astype(np.float32), "t": np.float32(0.3)}
    tx = optax.adam(3e-4)
    state = tx.init(params)
    port = {k: torch.tensor(v) for k, v in params.items()}
    opt = ClippedAdamW(learning_rate=3e-4, grad_clip=None, b1=0.9, b2=0.999, eps=1e-8)
    opt_state = opt.init(port)
    for _ in range(5):
        grads = {k: (100 * rng.normal(size=np.shape(v))).astype(np.float32)
                 for k, v in params.items()}
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        opt_state, norm = opt.update(port, [torch.tensor(grads[k]) for k in port], opt_state)
        assert norm is None
        for k in params:
            np.testing.assert_allclose(port[k].numpy(), np.asarray(params[k]), rtol=0, atol=1e-6)
