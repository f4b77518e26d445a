"""The yardstick's arithmetic: the work of a step and of an attention call,
and the card's peaks. Frozen here so that a change to the program cannot
change what it is measured against.

* ``train_step_flops`` is the convention of the reference's
  ``train_step_flops`` (``ray_tpu/models/gpt.py``, copied into the port's
  ``models/gpt.py``): 6 N tokens for the matrix products of the forward and
  backward, N the parameters less the input embedding (a gather), plus
  12 L b h t^2 d for attention's two products, forward and backward,
  counted over the whole t x t square; recomputation under remat is not
  counted. ``eval_step_flops`` is its forward third: 2 N tokens plus
  4 L b h t^2 d.
* An attention call's least time is the larger of its products at the
  bf16 peak and its bytes at the memory's peak. Products count the pairs
  that a causal mask leaves visible, t (t + 1) / 2 a head: the forward
  4 d a pair (S and P V), the whole backward 10 d a pair (S once more, dP,
  dV, dQ, dK: the FlashAttention convention), whatever kernels implement
  it. Bytes count each input read once and each output written once:
  forward q, k, v in and o, lse out; backward q, k, v, o, dO, lse in and
  dq, dk, dv out.
* Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W):
  989 TFLOP/s in bf16 and fp16, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
LSE_BYTES = 4  # the row statistics are float32


def num_params(s) -> int:
    """Parameters of the parallel-residual block model of shape ``s`` (a
    reference ``Shape``) with an untied head: one LayerNorm a block, biases
    on the MLP and the head only."""
    per_layer = (4 * s.embed * s.heads * s.head_dim + 2 * s.embed * s.mlp + s.mlp + s.embed
                 + 2 * s.embed)
    return s.vocab * s.embed + s.layers * per_layer + 2 * s.embed + s.embed * s.vocab + s.vocab


def matmul_params(s) -> int:
    """The parameters that enter matrix products: all but the input
    embedding, which is a gather."""
    return num_params(s) - s.vocab * s.embed


def train_step_flops(s, batch: int, seq: int) -> float:
    return (6.0 * matmul_params(s) * batch * seq
            + 12.0 * s.layers * batch * s.heads * seq * seq * s.head_dim)


def eval_step_flops(s, batch: int, seq: int) -> float:
    return (2.0 * matmul_params(s) * batch * seq
            + 4.0 * s.layers * batch * s.heads * seq * seq * s.head_dim)


def causal_pairs(batch: int, heads: int, seq: int) -> int:
    return batch * heads * seq * (seq + 1) // 2


def attn_fwd_work(batch: int, heads: int, seq: int, head_dim: int,
                  itemsize: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one causal self-attention forward."""
    flops = 4.0 * head_dim * causal_pairs(batch, heads, seq)
    rows = batch * heads * seq
    return flops, 4.0 * rows * head_dim * itemsize + rows * LSE_BYTES


def attn_bwd_work(batch: int, heads: int, seq: int, head_dim: int,
                  itemsize: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one causal self-attention backward."""
    flops = 10.0 * head_dim * causal_pairs(batch, heads, seq)
    rows = batch * heads * seq
    return flops, 8.0 * rows * head_dim * itemsize + rows * LSE_BYTES


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
