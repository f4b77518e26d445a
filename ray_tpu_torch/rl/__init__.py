"""ray_tpu_torch.rl: the reference's RL stack (``ray_tpu/rl/``) in PyTorch —
RLModule, the model catalog, rollouts, PPO and LearnerGroup, PG, A2C,
IMPALA (V-trace), APPO and multi-agent PPO; replay buffers, DQN (double-Q,
dueling, noisy nets, n-step, C51) and Ape-X, offline datasets, BC and
MARWIL, SAC, CQL, TD3 and DDPG, ES and the external-env policy server.

Reference surface: rllib new API stack (core/rl_module, core/learner,
evaluation/rollout_worker, algorithms/{ppo,pg,a2c,impala,appo}). The
learners' networks, optimizer state and losses live on their ``device``
(CUDA by default); rollout workers run the policy's forward on theirs and
step the numpy envs on the host. Actors and the learners' host collective
come through ``ray_tpu_torch.runtime.RuntimeHooks``; the default runs
every actor in the caller's process. ``prng`` computes the reference's
JAX and flax random streams in numpy, so every network starts from the
reference's weights for a seed and every update draws the reference's
noise; ``convert`` carries weights to and from the reference's parameter
trees.
"""

from ray_tpu_torch.rl import offline, prng
from ray_tpu_torch.rl.a2c import A2C, A2CConfig, A2CLearner
from ray_tpu_torch.rl.algorithm import PPO, PPOConfig
from ray_tpu_torch.rl.apex import ApexDQN, ApexDQNConfig, ApexRolloutWorker, ReplayShardActor
from ray_tpu_torch.rl.appo import APPO, APPOConfig, APPOLearner
from ray_tpu_torch.rl.bc import BC, BCConfig, MARWIL, MARWILConfig, monte_carlo_returns
from ray_tpu_torch.rl.catalog import (
    AttentionEncoder,
    CatalogPolicy,
    LSTMEncoder,
    MLPEncoder,
    ModelConfig,
    get_model,
)
from ray_tpu_torch.rl.connectors import (
    ClipActions,
    ClipObs,
    Connector,
    ConnectorPipeline,
    FlattenObs,
    MeanStdFilter,
    UnsquashActions,
)
from ray_tpu_torch.rl.cql import CQL, CQLConfig
from ray_tpu_torch.rl.dqn import (
    DQN,
    DQNConfig,
    DQNLearner,
    DQNRolloutWorker,
    NoisyDense,
    QNetwork,
    RainbowDQNConfig,
)
from ray_tpu_torch.rl.env import CartPole, Pendulum, VectorEnv, make_env
from ray_tpu_torch.rl.es import ES, ESConfig, ESEvalWorker
from ray_tpu_torch.rl.impala import Impala, ImpalaConfig, ImpalaLearner, vtrace
from ray_tpu_torch.rl.learner import LearnerGroup, PPOLearner, PPOLossConfig
from ray_tpu_torch.rl.multi_agent import (
    IndependentCartPoles,
    MultiAgentEnv,
    MultiAgentPPO,
    MultiAgentPPOConfig,
    MultiAgentRolloutWorker,
    make_multi_agent_env,
)
from ray_tpu_torch.rl.pg import PG, PGConfig, PGLearner
from ray_tpu_torch.rl.policy_server import PolicyClient, PolicyServer
from ray_tpu_torch.rl.replay_buffers import PrioritizedReplayBuffer, ReplayBuffer
from ray_tpu_torch.rl.rl_module import DiscretePolicyModule, RLModule
from ray_tpu_torch.rl.rollout_worker import RolloutWorker
from ray_tpu_torch.rl.sac import SAC, GaussianPolicy, SACConfig, SACRolloutWorker, TwinQ
from ray_tpu_torch.rl.sample_batch import SampleBatch, compute_gae
from ray_tpu_torch.rl.td3 import (
    DDPG,
    DDPGConfig,
    TD3,
    DeterministicPolicy,
    TD3Config,
    TD3RolloutWorker,
)

__all__ = [
    "A2C",
    "A2CConfig",
    "A2CLearner",
    "APPO",
    "APPOConfig",
    "APPOLearner",
    "ApexDQN",
    "ApexDQNConfig",
    "ApexRolloutWorker",
    "AttentionEncoder",
    "BC",
    "BCConfig",
    "CQL",
    "CQLConfig",
    "CartPole",
    "CatalogPolicy",
    "ClipActions",
    "ClipObs",
    "Connector",
    "ConnectorPipeline",
    "DDPG",
    "DDPGConfig",
    "DQN",
    "DQNConfig",
    "DQNLearner",
    "DQNRolloutWorker",
    "DeterministicPolicy",
    "DiscretePolicyModule",
    "ES",
    "ESConfig",
    "ESEvalWorker",
    "FlattenObs",
    "GaussianPolicy",
    "Impala",
    "ImpalaConfig",
    "ImpalaLearner",
    "IndependentCartPoles",
    "LSTMEncoder",
    "LearnerGroup",
    "MARWIL",
    "MARWILConfig",
    "MLPEncoder",
    "MeanStdFilter",
    "ModelConfig",
    "MultiAgentEnv",
    "MultiAgentPPO",
    "MultiAgentPPOConfig",
    "MultiAgentRolloutWorker",
    "NoisyDense",
    "PG",
    "PGConfig",
    "PGLearner",
    "PPO",
    "PPOConfig",
    "PPOLearner",
    "PPOLossConfig",
    "Pendulum",
    "PolicyClient",
    "PolicyServer",
    "PrioritizedReplayBuffer",
    "QNetwork",
    "RLModule",
    "RainbowDQNConfig",
    "ReplayBuffer",
    "ReplayShardActor",
    "RolloutWorker",
    "SAC",
    "SACConfig",
    "SACRolloutWorker",
    "SampleBatch",
    "TD3",
    "TD3Config",
    "TD3RolloutWorker",
    "TwinQ",
    "UnsquashActions",
    "VectorEnv",
    "compute_gae",
    "get_model",
    "make_env",
    "make_multi_agent_env",
    "monte_carlo_returns",
    "offline",
    "prng",
    "vtrace",
]
