"""ray_tpu_torch.rl: the on-policy half of the reference's RL stack
(``ray_tpu/rl/``) in PyTorch — RLModule, the model catalog, rollouts, PPO
and LearnerGroup, PG, A2C, IMPALA (V-trace), APPO and multi-agent PPO.

Reference surface: rllib new API stack (core/rl_module, core/learner,
evaluation/rollout_worker, algorithms/{ppo,pg,a2c,impala,appo}). The
learners' networks, optimizer state and losses live on their ``device``
(CUDA by default); rollout workers run the policy's forward on theirs and
step the numpy envs on the host. Actors and the learners' host collective
come through ``ray_tpu_torch.runtime.RuntimeHooks``; the default runs
every actor in the caller's process. ``convert`` carries weights to and
from the reference's parameter trees.
"""

from ray_tpu_torch.rl.a2c import A2C, A2CConfig, A2CLearner
from ray_tpu_torch.rl.algorithm import PPO, PPOConfig
from ray_tpu_torch.rl.appo import APPO, APPOConfig, APPOLearner
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
from ray_tpu_torch.rl.env import CartPole, Pendulum, VectorEnv, make_env
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
from ray_tpu_torch.rl.rl_module import DiscretePolicyModule, RLModule
from ray_tpu_torch.rl.rollout_worker import RolloutWorker
from ray_tpu_torch.rl.sample_batch import SampleBatch, compute_gae

__all__ = [
    "A2C",
    "A2CConfig",
    "A2CLearner",
    "APPO",
    "APPOConfig",
    "APPOLearner",
    "AttentionEncoder",
    "CartPole",
    "CatalogPolicy",
    "ClipActions",
    "ClipObs",
    "Connector",
    "ConnectorPipeline",
    "DiscretePolicyModule",
    "FlattenObs",
    "Impala",
    "ImpalaConfig",
    "ImpalaLearner",
    "IndependentCartPoles",
    "LSTMEncoder",
    "LearnerGroup",
    "MLPEncoder",
    "MeanStdFilter",
    "ModelConfig",
    "MultiAgentEnv",
    "MultiAgentPPO",
    "MultiAgentPPOConfig",
    "MultiAgentRolloutWorker",
    "PG",
    "PGConfig",
    "PGLearner",
    "PPO",
    "PPOConfig",
    "PPOLearner",
    "PPOLossConfig",
    "Pendulum",
    "RLModule",
    "RolloutWorker",
    "SampleBatch",
    "UnsquashActions",
    "VectorEnv",
    "compute_gae",
    "get_model",
    "make_env",
    "make_multi_agent_env",
    "vtrace",
]
