"""The harness's one door into the program under test, ``ray_tpu_torch``:
its configuration, its train and eval steps and its launch counters. The
port is imported here, inside the functions, and nowhere else."""

from __future__ import annotations

from typing import Dict

from perfbench.core.inputs import DTYPES
from perfbench.reference.gpt_parallel import Shape


def gpt_config(config: dict):
    """The port's ``GPTConfig`` for a configuration file."""
    from ray_tpu_torch.models.gpt import GPTConfig

    s = Shape.from_config(config)
    train = config["train"]
    return GPTConfig(vocab_size=s.vocab, num_layers=s.layers, num_heads=s.heads,
                     head_dim=s.head_dim, embed_dim=s.embed, mlp_dim=s.mlp,
                     max_seq_len=config["n_positions"], rotary_dim=s.rotary_dim,
                     dtype=DTYPES[train["compute_dtype"]],
                     param_dtype=DTYPES[train["param_dtype"]],
                     parallel_residual=True, tie_embeddings=config["tie_word_embeddings"],
                     remat=train["remat_policy"] is not None,
                     remat_policy=train["remat_policy"] or "nothing",
                     ce_chunk=train["ce_chunk"])


def optimizer(config: dict):
    from ray_tpu_torch.models.training import ClippedAdamW

    o = config["optimizer"]
    return ClippedAdamW(learning_rate=o["learning_rate"], weight_decay=o["weight_decay"],
                        grad_clip=o["grad_clip"], b1=o["b1"], b2=o["b2"], eps=o["eps"])


def train_step(config: dict, device):
    """(step, optimizer) of the single-device train step."""
    from ray_tpu_torch.models import training

    opt = optimizer(config)
    return training.make_train_step(gpt_config(config), opt, device=device), opt


def train_state(params: Dict, opt):
    """The train step's state over ``params`` (the port's ``state_dict``;
    updated in place)."""
    from ray_tpu_torch.models import training

    return training.init_train_state(params, opt)


def eval_step(config: dict, device):
    from ray_tpu_torch.models import training

    return training.make_eval_step(gpt_config(config), device=device)


def forward_launches() -> int:
    """The port's count of flash forward launches so far."""
    from ray_tpu_torch.ops import attention

    return attention.flash_fwd_launches


def state_dict_shapes(config: dict) -> Dict[str, tuple]:
    """{name: shape} of the port's parameters for a configuration."""
    from ray_tpu_torch.models.gpt import GPT

    return {n: tuple(p.shape) for n, p in
            GPT(gpt_config(config), device="meta").named_parameters()}
