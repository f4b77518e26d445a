"""Decoder-only transformer family, in PyTorch (counterpart of
``ray_tpu/models/gpt.py``).

Same configurations, same math, same dtype policy: activations and compute
in ``cfg.dtype`` (bf16 for the flagship), parameters in ``cfg.param_dtype``,
LayerNorm statistics in float32 with eps 1e-6, the tanh approximation of
GELU, rotary embeddings on the first ``rotary_dim`` features (half-split
layout, base 10000). The full-sequence forward runs its attention through
``ops.attention.dot_product_attention`` (the Hopper flash kernel on CUDA);
the KV-cache extend step (``make_extend_fn``) computes its attention with
plain matmul and softmax, as the reference's extend step does.

Training parts: ``remat`` per block under the reference's three policies,
``next_token_loss``, ``blockwise_next_token_loss`` and
``train_step_flops``; the train step itself is in ``models/training.py``.
With ``moe_num_experts > 0`` each block's MLP is ``models.moe.MoeMlp``.

Parameters are a flat ``state_dict`` (``models.convert`` carries them across
from the reference's flax tree). Each dense kernel is stored as an
``nn.Linear`` weight, ``[out_features, in_features]``; see ``convert`` for
the axis map.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ray_tpu_torch import resolve_device
from ray_tpu_torch.ops.attention import FLASH_FWD, NEG_INF, dot_product_attention

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50400
    num_layers: int = 28
    num_heads: int = 16
    head_dim: int = 256
    embed_dim: int = 4096
    mlp_dim: int = 16384
    max_seq_len: int = 2048
    rotary_dim: int = 64
    dtype: torch.dtype = torch.bfloat16       # activation/compute dtype
    param_dtype: torch.dtype = torch.float32  # parameter dtype
    parallel_residual: bool = True            # GPT-J style single-LN block
    tie_embeddings: bool = False
    # recompute each block in the backward instead of keeping its
    # activations (torch.utils.checkpoint per block, only while grad is on).
    # What the block keeps for the backward besides its input:
    #   "nothing" - nothing: the whole block runs again;
    #   "dots"    - the outputs of its 2-D matrix products (the reference's
    #               dots_with_no_batch_dims_saveable); the expert bmms and
    #               the flash forward run again;
    #   "attn"    - the flash forward's (out, lse), so it is not launched
    #               again (the reference's "attn_out" name)
    remat: bool = True
    remat_policy: str = "nothing"
    # sequence rows per [b, chunk, vocab] logits block of the blockwise loss
    ce_chunk: int = 256
    # mixture-of-experts (0 = dense MLP), models/moe.py
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def qkv_dim(self) -> int:
        return self.num_heads * self.head_dim

    def num_params(self) -> int:
        """Exact parameter count (for MFU math)."""
        d, h, hd, f, v = (
            self.embed_dim, self.num_heads, self.head_dim, self.mlp_dim,
            self.vocab_size,
        )
        if self.moe_num_experts:
            mlp_params = self.moe_num_experts * 2 * d * f + d * self.moe_num_experts
        else:
            mlp_params = 2 * d * f + f + d
        per_layer = (
            4 * d * h * hd
            + mlp_params
            + (2 * d if self.parallel_residual else 4 * d)
        )
        head = 0 if self.tie_embeddings else d * v + v
        return v * d + self.num_layers * per_layer + 2 * d + head


def gpt_nano(**kw) -> GPTConfig:
    return GPTConfig(
        vocab_size=256, num_layers=2, num_heads=4, head_dim=16, embed_dim=64,
        mlp_dim=256, max_seq_len=128, rotary_dim=16, dtype=torch.float32, **kw
    )


def gpt_125m(**kw) -> GPTConfig:
    return GPTConfig(
        vocab_size=50304, num_layers=12, num_heads=12, head_dim=64,
        embed_dim=768, mlp_dim=3072, max_seq_len=2048, rotary_dim=32, **kw
    )


def gpt_1b(**kw) -> GPTConfig:
    return GPTConfig(
        vocab_size=50304, num_layers=16, num_heads=16, head_dim=128,
        embed_dim=2048, mlp_dim=8192, max_seq_len=2048, rotary_dim=64, **kw
    )


def gpt_j_6b(**kw) -> GPTConfig:
    return GPTConfig(**kw)


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_attn(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op == FLASH_FWD
            else CheckpointPolicy.PREFER_RECOMPUTE)


#: each remat policy's context for torch.utils.checkpoint: "nothing" is
#: plain recomputation, the others selective (what their ops' policy saves)
REMAT_CONTEXTS = {
    "nothing": noop_context_fn,
    "dots": functools.partial(create_selective_checkpoint_contexts, _save_dots),
    "attn": functools.partial(create_selective_checkpoint_contexts, _save_attn),
}


def _check_remat(cfg: GPTConfig) -> None:
    if cfg.remat and cfg.remat_policy not in REMAT_CONTEXTS:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         f"one of {sorted(REMAT_CONTEXTS)}")


# ---------------------------------------------------------------------------
# shared math
# ---------------------------------------------------------------------------


def _rotary(x: torch.Tensor, positions: torch.Tensor, rotary_dim: int) -> torch.Tensor:
    """Apply RoPE to the first ``rotary_dim`` features of [b, t, h, d]; sin
    and cos are cast to the activation dtype."""
    if rotary_dim <= 0:
        return x
    rot, keep = x[..., :rotary_dim], x[..., rotary_dim:]
    half = rotary_dim // 2
    freqs = 1.0 / (
        10000.0 ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    )
    angles = positions[:, :, None].float() * freqs  # [b, t, half]
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    r1, r2 = rot[..., :half], rot[..., half:]
    rotated = torch.cat([r1 * cos - r2 * sin, r2 * cos + r1 * sin], dim=-1)
    return torch.cat([rotated, keep], dim=-1)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm with float32 statistics (var = E[x^2] - E[x]^2, clamped at
    0), rsqrt and eps 1e-6; the result is cast to ``dtype``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + LN_EPS)
    return (y * weight.float() + bias.float()).to(dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _logits(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
            dtype: torch.dtype) -> torch.Tensor:
    """``x @ weight.T`` in ``dtype``, then cast to float32 and the float32
    bias added."""
    logits = F.linear(x.to(dtype), weight.to(dtype)).float()
    if bias is not None:
        logits = logits + bias.float()
    return logits


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class Dense(nn.Module):
    """``y = x @ W.T (+ b)`` computed in ``cfg.dtype``; W is stored
    ``[out, in]`` in ``cfg.param_dtype``, the bias is added after the
    product in ``cfg.dtype``."""

    def __init__(self, in_features: int, out_features: int, cfg: GPTConfig,
                 bias: bool, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, dtype=cfg.param_dtype, device=device))
        if bias:
            self.bias = nn.Parameter(torch.empty(
                out_features, dtype=cfg.param_dtype, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class LayerNorm(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.weight = nn.Parameter(
            torch.empty(cfg.embed_dim, dtype=cfg.param_dtype, device=device))
        self.bias = nn.Parameter(
            torch.empty(cfg.embed_dim, dtype=cfg.param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.q = Dense(cfg.embed_dim, cfg.qkv_dim, cfg, False, device)
        self.k = Dense(cfg.embed_dim, cfg.qkv_dim, cfg, False, device)
        self.v = Dense(cfg.embed_dim, cfg.qkv_dim, cfg, False, device)
        self.o = Dense(cfg.qkv_dim, cfg.embed_dim, cfg, False, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        shape = (b, t, cfg.num_heads, cfg.head_dim)
        q = _rotary(self.q(x).view(shape), positions, cfg.rotary_dim)
        k = _rotary(self.k(x).view(shape), positions, cfg.rotary_dim)
        v = self.v(x).view(shape)
        # [b, t, h, d] -> [b, h, t, d] for the flash kernel
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        out = dot_product_attention(qh, kh, vh, causal=True)
        return self.o(out.transpose(1, 2).reshape(b, t, cfg.qkv_dim))


class Mlp(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.wi = Dense(cfg.embed_dim, cfg.mlp_dim, cfg, True, device)
        self.wo = Dense(cfg.mlp_dim, cfg.embed_dim, cfg, True, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(_gelu(self.wi(x)))


class Block(nn.Module):
    """``forward(x, positions)``: the block's output, or with experts
    ``(output, aux, dropped)`` (``MoeMlp``'s)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.parallel_residual = cfg.parallel_residual
        if cfg.parallel_residual:
            self.ln = LayerNorm(cfg, device)
        else:
            self.ln1 = LayerNorm(cfg, device)
            self.ln2 = LayerNorm(cfg, device)
        self.attn = Attention(cfg, device)
        self.moe = cfg.moe_num_experts > 0
        if self.moe:
            from ray_tpu_torch.models.moe import MoeMlp

            self.mlp = MoeMlp(cfg, device)
        else:
            self.mlp = Mlp(cfg, device)

    def _mlp(self, x: torch.Tensor):
        """(the MLP's output, MoeMlp's (aux, dropped) or ())"""
        if self.moe:
            y, aux, dropped = self.mlp(x)
            return y, (aux, dropped)
        return self.mlp(x), ()

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        if self.parallel_residual:
            hidden = self.ln(x)
            a = self.attn(hidden, positions)
            m, moe = self._mlp(hidden)
            out = x + a + m
        else:
            x = x + self.attn(self.ln1(x), positions)
            m, moe = self._mlp(self.ln2(x))
            out = x + m
        return (out, *moe) if moe else out


class LMHead(nn.Module):
    """The untied output projection: weight [vocab, embed], bias [vocab]."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.embed_dim, dtype=cfg.param_dtype, device=device))
        self.bias = nn.Parameter(
            torch.empty(cfg.vocab_size, dtype=cfg.param_dtype, device=device))


def _run_block(block: Block, params: Dict[str, torch.Tensor], x: torch.Tensor,
               positions: torch.Tensor):
    return functional_call(block, params, (x, positions))


class GPT(nn.Module):
    """``forward(tokens [b, t], positions=None) -> logits [b, t, vocab]``
    in float32. Logits are computed in ``cfg.dtype``, then cast to float32
    and the float32 head bias added. With ``return_hidden=True`` it returns
    ``(hidden [b, t, embed] in cfg.dtype, head weight [vocab, embed], head
    bias [vocab] or None)`` instead, for ``blockwise_next_token_loss``, which
    never holds the full logits. ``device`` defaults to CUDA (``"meta"``
    builds a skeleton without storage). With ``return_moe=True`` it returns
    ``(output, {"aux", "dropped"})``: the MoE blocks' aux losses summed and
    divided by ``num_layers`` (the reference's division of the sown sum),
    and the mean share of assignments dropped for capacity; both 0 for a
    dense config.

    While grad is enabled and ``cfg.remat`` is set, each block runs under
    ``torch.utils.checkpoint``: its input is kept, and so is what
    ``cfg.remat_policy`` names (``REMAT_CONTEXTS``); the backward runs the
    rest of the block's forward again. Under "nothing" and "dots" the
    attention forward launches twice per layer in a train step, under
    "attn" once. The block's parameters are handed to the checkpointed
    call, so the recomputation also works under
    ``torch.func.functional_call``, and the aux loss is recomputed with the
    rest."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        _check_remat(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.wte = nn.Embedding(
            cfg.vocab_size, cfg.embed_dim, dtype=cfg.param_dtype, device=device)
        self.blocks = nn.ModuleList(Block(cfg, device) for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg, device)
        self.lm_head = None if cfg.tie_embeddings else LMHead(cfg, device)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                return_hidden: bool = False, return_moe: bool = False):
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(
                tokens.shape[1], device=tokens.device).expand(tokens.shape)
        x = F.embedding(tokens, self.wte.weight.to(cfg.dtype))
        remat = cfg.remat and torch.is_grad_enabled()
        aux, dropped = [], []
        for block in self.blocks:
            if remat:
                out = checkpoint(_run_block, block, dict(block.named_parameters()),
                                 x, positions, use_reentrant=False,
                                 preserve_rng_state=False,
                                 context_fn=REMAT_CONTEXTS[cfg.remat_policy])
            else:
                out = block(x, positions)
            if block.moe:
                x, block_aux, block_dropped = out
                aux.append(block_aux)
                dropped.append(block_dropped)
            else:
                x = out
        x = self.ln_f(x)
        if self.lm_head is None:
            weight, bias = self.wte.weight, None
        else:
            weight, bias = self.lm_head.weight, self.lm_head.bias
        out = (x, weight, bias) if return_hidden else _logits(x, weight, bias, cfg.dtype)
        if not return_moe:
            return out
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        moe = {"aux": torch.stack(aux).sum() / cfg.num_layers if aux else zero,
               "dropped": torch.stack(dropped).mean() if dropped else zero}
        return out, moe


# ---------------------------------------------------------------------------
# KV-cache decode path (serve/llm.py)
# ---------------------------------------------------------------------------
#
# The serving engine runs `make_extend_fn(cfg)`: one "extend" step that
# appends `tc` new tokens per lane to a per-lane cache of `lengths` tokens
# and attends the new queries over the whole (padded) cache. Prefill is an
# extend with tc = prompt-chunk length, decode an extend with tc = 1.


def init_kv_cache(cfg: GPTConfig, batch: int, capacity: int, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed K/V caches [layers, batch, capacity, heads, head_dim]."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, capacity, cfg.num_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=dev),
            torch.zeros(shape, dtype=cfg.dtype, device=dev))


def make_extend_fn(cfg: GPTConfig):
    """``extend(params, tokens, lengths, k_cache, v_cache)``.

    ``tokens`` [b, tc] are the next tokens of each lane whose cache already
    holds ``lengths`` [b] tokens. Their K/V are written at positions
    ``lengths + arange(tc)``, in place into ``k_cache``/``v_cache``
    [layers, b, capacity, heads, head_dim] (the caller's tensors are
    updated; a write at or past ``capacity`` is dropped, not clamped); the
    new queries attend over the updated cache under ``key_pos <= query_pos``,
    which also hides never-written padding. Returns ``(logits, hidden,
    k_new, v_new)``: float32 logits and final hidden for every fed position,
    and the new K/V chunks [layers, b, tc, heads, head_dim].

    Scores are float32, the softmax is float32 and its weights are cast to
    ``cfg.dtype``; there is no atomic or split reduction, so equal shapes
    give equal bits (what makes prefix-cached decode bitwise-equal to
    uncached decode). MoE configs raise, as in the reference."""
    if cfg.moe_num_experts:
        raise NotImplementedError("KV-cache decode does not support MoE MLPs")
    dtype = cfg.dtype
    h, hd = cfg.num_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)

    def _ln(x, params, name):
        return layer_norm(x, params[f"{name}.weight"], params[f"{name}.bias"], dtype)

    def _dense(x, params, name, bias=True):
        y = F.linear(x, params[f"{name}.weight"].to(dtype))
        if bias:
            y = y + params[f"{name}.bias"].to(dtype)
        return y

    def _attend(params, pre, hidden, positions, write, kc, vc, mask):
        b, tc, _ = hidden.shape
        cap = kc.shape[1]
        q = _dense(hidden, params, pre + "q", False).view(b, tc, h, hd)
        k = _dense(hidden, params, pre + "k", False).view(b, tc, h, hd)
        v = _dense(hidden, params, pre + "v", False).view(b, tc, h, hd)
        q = _rotary(q, positions, cfg.rotary_dim)
        k = _rotary(k, positions, cfg.rotary_dim)
        dst, src = write
        kc.view(b * cap, h, hd).index_copy_(0, dst, k.reshape(b * tc, h, hd)[src])
        vc.view(b * cap, h, hd).index_copy_(0, dst, v.reshape(b * tc, h, hd)[src])
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc.float()) * scale
        scores = torch.where(mask, scores, NEG_INF)
        w = torch.softmax(scores, dim=-1).to(dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, vc).reshape(b, tc, h * hd)
        return _dense(out, params, pre + "o", False), k, v

    def extend(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
               lengths: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor):
        b, tc = tokens.shape
        cap = k_cache.shape[2]
        dev = tokens.device
        positions = lengths[:, None].long() + torch.arange(tc, device=dev)[None, :]
        # flat cache rows to write; rows at or past capacity are dropped
        dst = (torch.arange(b, device=dev)[:, None] * cap + positions).reshape(-1)
        keep = (positions < cap).reshape(-1)
        src = torch.arange(b * tc, device=dev)
        if not bool(keep.all()):
            src = keep.nonzero().squeeze(1)
            dst = dst[src]
        mask = (torch.arange(cap, device=dev)[None, None, :]
                <= positions[:, :, None])[:, None]  # [b, 1, tc, cap]
        x = F.embedding(tokens.clamp(0, cfg.vocab_size - 1),
                        params["wte.weight"].to(dtype))
        k_new, v_new = [], []
        for i in range(cfg.num_layers):
            pre = f"blocks.{i}."
            kc, vc = k_cache[i], v_cache[i]
            if cfg.parallel_residual:
                hidden = _ln(x, params, pre + "ln")
                a, k, v = _attend(params, pre + "attn.", hidden, positions,
                                  (dst, src), kc, vc, mask)
                m = _dense(_gelu(_dense(hidden, params, pre + "mlp.wi")),
                           params, pre + "mlp.wo")
                x = x + a + m
            else:
                a, k, v = _attend(params, pre + "attn.", _ln(x, params, pre + "ln1"),
                                  positions, (dst, src), kc, vc, mask)
                x = x + a
                hidden = _ln(x, params, pre + "ln2")
                x = x + _dense(_gelu(_dense(hidden, params, pre + "mlp.wi")),
                               params, pre + "mlp.wo")
            k_new.append(k)
            v_new.append(v)
        x = _ln(x, params, "ln_f")
        if cfg.tie_embeddings:
            logits = _logits(x, params["wte.weight"], None, dtype)
        else:
            logits = _logits(x, params["lm_head.weight"], params["lm_head.bias"], dtype)
        return logits, x.float(), torch.stack(k_new), torch.stack(v_new)

    return extend


# ---------------------------------------------------------------------------
# loss / flops helpers
# ---------------------------------------------------------------------------


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy of predicting tokens[t+1] from position t; with
    ``mask`` [b, t], the mean over positions whose target is unmasked."""
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if mask is not None:
        m = mask[:, 1:].float()
        return (nll * m).sum() / m.sum().clamp_min(1.0)
    return nll.mean()


def _chunk_nll(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               targets: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    logits = F.linear(x, weight).float()
    if bias is not None:
        logits = logits + bias.float()
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    return ((lse - target_logit) * valid).sum()


def blockwise_next_token_loss(
    hidden: torch.Tensor,
    head_weight: torch.Tensor,
    head_bias: Optional[torch.Tensor],
    tokens: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    chunk: int = 256,
) -> torch.Tensor:
    """Mean next-token cross-entropy without holding [b, t, vocab] logits.

    ``hidden`` [b, t, embed] is the final hidden state in the compute dtype,
    ``head_weight`` [vocab, embed] and ``head_bias`` [vocab] (or None) the
    output projection, as ``GPT(..., return_hidden=True)`` returns them.
    The t - 1 predicting positions are taken ``chunk`` at a time (the last
    chunk may be shorter): each chunk's logits are computed in the hidden
    dtype, cast to float32 with the float32 bias, reduced to logsumexp minus
    the target logit, and, while grad is enabled, recomputed in the backward
    (``torch.utils.checkpoint``), so only one [b, chunk, vocab] float32
    block lives at a time."""
    n = hidden.shape[1] - 1
    xs = hidden[:, :-1]
    targets = tokens[:, 1:].long()
    if mask is None:
        valid = torch.ones(targets.shape, dtype=torch.float32, device=hidden.device)
    else:
        valid = mask[:, 1:].float()
    weight = head_weight.to(hidden.dtype)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, n, chunk):
        args = (xs[:, c0:c0 + chunk], weight, head_bias,
                targets[:, c0:c0 + chunk], valid[:, c0:c0 + chunk])
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, *args, use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            total = total + _chunk_nll(*args)
    return total / valid.sum().clamp_min(1.0)


def train_step_flops(cfg: GPTConfig, batch: int, seq: int) -> float:
    """Approximate FLOPs of one forward and backward step
    (6 * matmul params * tokens + attention). The input embedding is a
    gather, not a matmul, so it is left out; a tied head is a matmul, so it
    counts once then. Recomputation under remat is not counted."""
    tokens = batch * seq
    matmul_params = cfg.num_params() - cfg.vocab_size * cfg.embed_dim
    if cfg.tie_embeddings:
        matmul_params += cfg.vocab_size * cfg.embed_dim
    matmul = 6.0 * matmul_params * tokens
    attn = 12.0 * cfg.num_layers * batch * cfg.num_heads * seq * seq * cfg.head_dim
    return matmul + attn
