"""Plain PyTorch reference of the GPT-J-style decoder that the benchmark's
configurations name (``"reference": "gpt_parallel"``).

The block, as the configuration files state it: one LayerNorm (float32
statistics, eps from the file) feeding both the causal self-attention
(no biases on q, k, v, o; rotary embeddings on the first ``rotary_dim``
features of q and k, half-split layout, base ``rotary_base``; softmax of
q k^T / sqrt(head_dim)) and the MLP (``wi`` with bias, GELU in its tanh
form, ``wo`` with bias), summed with the residual; then a final LayerNorm
and an untied head with bias. The loss is the mean next-token
cross-entropy over the b (t - 1) predicting positions.

Everything is computed in float32 with TF32 off: the weights are read from
storage in whatever type the configuration keeps them and widened. Memory
is planned for one card beside nothing else: the forward keeps only each
block's input, and the backward runs each block again from its input
(``train_step``), the loss ``chunk`` positions at a time. The optimizer is
AdamW after a clip by the global norm (optax's ``clip_by_global_norm`` then
``adamw``), computed in float32 and stored back in the state's type.

``precision="fp8"`` is the control: every matrix product's operands (and
in the backward its incoming gradient) rounded to 8-bit floats, e4m3 with
one scale a tensor (e5m2 for gradients), the products accumulated in
float32, as an fp8 training recipe runs them.

This module imports nothing of the program under test.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@dataclasses.dataclass(frozen=True)
class Shape:
    vocab: int
    layers: int
    heads: int
    head_dim: int
    embed: int
    mlp: int
    rotary_dim: int
    rotary_base: float
    eps: float

    @classmethod
    def from_config(cls, config: dict) -> "Shape":
        """The sizes of a configuration file (GPT-J's ``config.json`` keys)."""
        embed, heads = config["n_embd"], config["n_head"]
        if embed % heads:
            raise ValueError(f"n_embd {embed} does not divide into {heads} heads")
        return cls(vocab=config["vocab_size"], layers=config["n_layer"], heads=heads,
                   head_dim=embed // heads, embed=embed,
                   mlp=config["n_inner"] or 4 * embed, rotary_dim=config["rotary_dim"],
                   rotary_base=float(config["rotary_base"]),
                   # a configuration that the port runs with another
                   # epsilon than its source's names it apart
                   eps=float(config.get("layer_norm_epsilon_run",
                                        config["layer_norm_epsilon"])))


def param_table(s: Shape) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter, kind "matrix", "scale" (a
    LayerNorm's weight) or "bias". Linear weights are [out, in]."""
    d, qkv = s.embed, s.heads * s.head_dim
    rows = [("wte.weight", (s.vocab, d), "matrix")]
    for i in range(s.layers):
        p = f"blocks.{i}."
        rows += [(p + "ln.weight", (d,), "scale"), (p + "ln.bias", (d,), "bias")]
        rows += [(p + f"attn.{n}.weight", (qkv, d), "matrix") for n in "qkv"]
        rows += [(p + "attn.o.weight", (d, qkv), "matrix"),
                 (p + "mlp.wi.weight", (s.mlp, d), "matrix"), (p + "mlp.wi.bias", (s.mlp,), "bias"),
                 (p + "mlp.wo.weight", (d, s.mlp), "matrix"), (p + "mlp.wo.bias", (d,), "bias")]
    rows += [("ln_f.weight", (d,), "scale"), ("ln_f.bias", (d,), "bias"),
             ("lm_head.weight", (s.vocab, d), "matrix"), ("lm_head.bias", (s.vocab,), "bias")]
    return rows


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def _round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x through an 8-bit float with one scale for the tensor (its largest
    magnitude at the type's top), back in x's type."""
    scale = top / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa = _round_fp8(a, torch.float8_e4m3fn, E4M3_MAX)
        qb = _round_fp8(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round_fp8(g, torch.float8_e5m2, E5M2_MAX)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def _fp8_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if b.dim() == 2 and a.dim() > 2:  # a weight: one product over all rows
        return _Fp8Product.apply(a.reshape(-1, a.shape[-1]), b).view(*a.shape[:-1], -1)
    return _Fp8Product.apply(a, b)


def _fp32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


PRODUCTS: Dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "fp32": _fp32_product,
    "fp8": _fp8_product,
}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def layer_norm(x, w, b, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def rotary(x: torch.Tensor, s: Shape) -> torch.Tensor:
    """RoPE on the first rotary_dim features of [b, t, h, d], half-split:
    (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin), position p at angle
    p / base^(i / half)."""
    half = s.rotary_dim // 2
    if half == 0:
        return x
    t = x.shape[1]
    inv = 1.0 / s.rotary_base ** (torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:s.rotary_dim]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., s.rotary_dim:]], -1)


def block(x: torch.Tensor, w: Dict[str, torch.Tensor], s: Shape, mm) -> torch.Tensor:
    """One block on x [b, t, embed] (float32) with its float32 weights."""
    b, t, _ = x.shape
    h = layer_norm(x, w["ln.weight"], w["ln.bias"], s.eps)
    q, k, v = (mm(h, w[f"attn.{n}.weight"].t()).view(b, t, s.heads, s.head_dim)
               for n in "qkv")
    q, k = rotary(q, s), rotary(k, s)
    q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(s.head_dim)
    future = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    p = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    a = mm(p, v).transpose(1, 2).reshape(b, t, s.heads * s.head_dim)
    a = mm(a, w["attn.o.weight"].t())
    m = F.gelu(mm(h, w["mlp.wi.weight"].t()) + w["mlp.wi.bias"], approximate="tanh")
    m = mm(m, w["mlp.wo.weight"].t()) + w["mlp.wo.bias"]
    return x + a + m


def _layer(params: Dict[str, torch.Tensor], i: int, grad: bool) -> Dict[str, torch.Tensor]:
    prefix = f"blocks.{i}."
    return {n[len(prefix):]: p.float().detach().requires_grad_(grad)
            for n, p in params.items() if n.startswith(prefix)}


def _head_nll(x: torch.Tensor, params, targets: torch.Tensor, s: Shape, mm) -> torch.Tensor:
    """Sum of the next-token NLL over x's positions [b, c, embed]."""
    h = layer_norm(x, params["ln_f.weight"], params["ln_f.bias"], s.eps)
    logits = mm(h, params["lm_head.weight"].t()) + params["lm_head.bias"]
    return (torch.logsumexp(logits, -1) - logits.gather(-1, targets[..., None])[..., 0]).sum()


def _check_precision(precision: str):
    if precision not in PRODUCTS:
        raise ValueError(f"precision {precision!r} is not one of {sorted(PRODUCTS)}")
    return PRODUCTS[precision]


@torch.no_grad()
def eval_loss(params: Dict[str, torch.Tensor], tokens: torch.Tensor, s: Shape,
              chunk: int = 512, precision: str = "fp32") -> float:
    """The mean next-token cross-entropy of ``tokens`` [b, t]."""
    mm = _check_precision(precision)
    with _no_tf32():
        x = params["wte.weight"][tokens].float()
        for i in range(s.layers):
            x = block(x, _layer(params, i, False), s, mm)
        head = {n: params[n].float() for n in ("ln_f.weight", "ln_f.bias",
                                                "lm_head.weight", "lm_head.bias")}
        total, n = 0.0, tokens.shape[0] * (tokens.shape[1] - 1)
        for c0 in range(0, tokens.shape[1] - 1, chunk):
            c1 = min(c0 + chunk, tokens.shape[1] - 1)
            total += float(_head_nll(x[:, c0:c1], head, tokens[:, c0 + 1:c1 + 1], s, mm))
        return total / n


def loss_and_grads(params: Dict[str, torch.Tensor], tokens: torch.Tensor, s: Shape,
                   chunk: int = 512, precision: str = "fp32"
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(mean next-token loss, {name: float32 gradient}) of ``tokens``: a
    forward that keeps each block's input, the head's loss and gradient
    ``chunk`` positions at a time, then each block again from its input
    with its gradient."""
    mm = _check_precision(precision)
    b, t = tokens.shape
    count = b * (t - 1)
    grads: Dict[str, torch.Tensor] = {}
    with _no_tf32():
        with torch.no_grad():
            xs = [params["wte.weight"][tokens].float()]
            for i in range(s.layers):
                xs.append(block(xs[-1], _layer(params, i, False), s, mm))
        top = xs.pop().requires_grad_(True)
        head = {n: params[n].float().detach().requires_grad_(True)
                for n in ("ln_f.weight", "ln_f.bias", "lm_head.weight", "lm_head.bias")}
        loss = 0.0
        for c0 in range(0, t - 1, chunk):
            c1 = min(c0 + chunk, t - 1)
            part = _head_nll(top[:, c0:c1], head, tokens[:, c0 + 1:c1 + 1], s, mm) / count
            part.backward()
            loss += float(part.detach())
        grads.update({n: p.grad for n, p in head.items()})
        g = top.grad
        del top
        for i in reversed(range(s.layers)):
            x = xs.pop().requires_grad_(True)
            w = _layer(params, i, True)
            block(x, w, s, mm).backward(g)
            g = x.grad
            grads.update({f"blocks.{i}.{n}": p.grad for n, p in w.items()})
            del x, w
        wte = torch.zeros(params["wte.weight"].shape, dtype=torch.float32, device=g.device)
        wte.index_add_(0, tokens.reshape(-1), g.reshape(-1, s.embed))
        grads["wte.weight"] = wte
    return loss, {n: grads[n] for n in params}


@dataclasses.dataclass(frozen=True)
class AdamW:
    """clip_by_global_norm(clip) then adamw(lr, b1, b2, eps, weight_decay)."""

    lr: float
    clip: float
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8

    @classmethod
    def from_config(cls, config: dict) -> "AdamW":
        o = config["optimizer"]
        return cls(lr=o["learning_rate"], clip=o["grad_clip"], weight_decay=o["weight_decay"],
                   b1=o["b1"], b2=o["b2"], eps=o["eps"])

    @torch.no_grad()
    def update(self, params, grads, mu, nu, count: int) -> Dict[str, float]:
        """One step in place on ``params``, ``mu``, ``nu`` (stored in their
        own type); returns each leaf's norm of the clipped gradient."""
        total = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
        factor = 1.0 if total < self.clip else self.clip / total
        bc1, bc2 = 1.0 - self.b1 ** count, 1.0 - self.b2 ** count
        norms = {}
        for name, p in params.items():
            g = grads[name] * factor
            norms[name] = float(g.double().norm())
            m = self.b1 * mu[name].float() + (1.0 - self.b1) * g
            v = self.b2 * nu[name].float() + (1.0 - self.b2) * g * g
            mu[name].copy_(m)
            nu[name].copy_(v)
            m, v = mu[name].float() / bc1, nu[name].float() / bc2
            pf = p.float()
            p.copy_(pf - self.lr * (m / (v.sqrt() + self.eps) + self.weight_decay * pf))
        return norms


def train_steps(params: Dict[str, torch.Tensor], batches: Sequence[torch.Tensor], s: Shape,
                opt: AdamW, chunk: int = 512, precision: str = "fp32") -> dict:
    """Train ``params`` (updated in place, in their own type) on each of
    ``batches`` in turn. Returns {"losses": each step's loss, "grad_norms":
    {leaf: norm of the first step's clipped gradient}}."""
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first = [], None
    for count, tokens in enumerate(batches, start=1):
        loss, grads = loss_and_grads(params, tokens, s, chunk, precision)
        norms = opt.update(params, grads, mu, nu, count)
        del grads
        losses.append(loss)
        first = first or norms
    return {"losses": losses, "grad_norms": first}


class _no_tf32:
    """Matrix products in full float32 while inside."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
