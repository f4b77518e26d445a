#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json] [--profile]

Phases (any failure exits non-zero; nothing is caught):
  1. build: compile ray_tpu_torch/ops/csrc/flash_fwd_wgmma.cu,
     flash_fwd_d64.cu, flash_fwd_persistent.cu, flash_fwd.cu,
     flash_fwd_f32.cu, flash_fwd_wide.cu, flash_bwd_wgmma.cu,
     flash_bwd_d64.cu, flash_bwd_persistent.cu, flash_bwd.cu,
     flash_bwd_f32.cu, flash_bwd_wide.cu, flash_fwd_dsplit.cu,
     flash_bwd_dsplit.cu, flash_bwd_dcluster.cu, flash_fwd_dcluster.cu,
     flash_bwd_dcluster128.cu, flash_bwd_dcluster128_wgmma.cu and
     flash_fwd_dcluster128.cu with nvcc, in parallel
     (one nvcc a source), and print their register,
     shared-memory and spill reports; the wgmma forward and both wgmma
     backward kernels at head_dim 128 and 256 (the train paths': dQ, dK/dV
     and, at 256, the split dK/dV kernel), the persistent forward and the
     persistent dQ and dK/dV kernels at 16 and 32 and the float32 forward
     (3xTF32) and the float32 backward's dQ and dK/dV kernels (3xTF32) at
     64, 128, 256 and 384 to 768 (WIDE_D) must not spill; the wgmma
     backward's, the
     persistent forward's and backward's and the float32 forward's and
     backward's dynamic shared memory per CTA by head_dim, at most 232448
     bytes, and the persistent kernels' CTAs resident per SM, at least
     one; the d64 forward, dQ and dK/dV (bf16 and float16 at head_dim 64)
     and the wide forward, dQ and dK/dV (bf16 and float16 at WIDE_D; on no
     path now, the variants scripts' "before") must not spill, and their shared memory and CTAs an SM are printed and
     gated the same way; so are the dsplit forward, dQ and dK/dV (head_dim
     a runtime argument; one build each in bf16, float16 and float32; on
     no path now), by dtype, with their registers a thread; and the
     dcluster forward, dQ and dK/dV (from 896 up, the CTAs of a cluster
     sharing a resident tile; a build each in bf16, float16 and float32)
     must not spill, with their registers a thread, shared memory at most
     232448 bytes and the clusters resident at once
     (cudaOccupancyMaxActiveClusters) at each cluster size the plan uses,
     printed and above 0; so must the dcluster128 dQ and dK/dV (float32 at
     WIDE_D, 128-column groups in clusters of 3 to 6), gated and printed
     the same way, and the dcluster128 forward (bf16, float16 and float32 at
     WIDE_D, a build each) and the dcluster128 dQ and dK/dV's wgmma builds
     (bf16 and float16 at WIDE_D, dQ's by cluster size), with their CTAs an
     SM besides;
  2. kernel vs plain: the flash forward kernel against its plain PyTorch
     version on the same device tensors, per case (among them the shape of
     each train path and of the forward: gpt_1b at b=12, b=8, b=4 and the
     pipelined step's microbatch, b=3; every other float32 case on the
     tf32x3 design, every bf16 head_dim-16/32 case on the persistent design and
     every bf16 head_dim-64 case on d64, every case at WIDE_D on
     dcluster128, run twice and bit-equal, and
     every case from 896 up on dcluster (the tables'
     rule), one launch of it a case: gpt_nano's working case
     at 4g's b=512, the tiny flagship's at b=256, gpt_125m's at b=4 and 4h's
     b=16, d384_b2 to d768_b2 and d896_b2, d1024_b2 and d2048_b2 (2 x 8
     heads x 2048^2, causal, in bf16 and float32), and, checked only
     (CHECK_ONLY), long t, ragged, q the suffix, rows that see no key,
     ragged non-causal, float16, and head_dims 1152 (clusters of 5), 4096
     and 8192 (two and four passes)):
     each row of out held to its own norm and lse to an absolute limit
     (ray_tpu_torch/ops/tolerance.py), max abs error, the kernel's device
     time (torch.profiler's kernel durations over the calls that cuda_ms
     times, beside cuda_ms) / plain / library (scaled_dot_product_attention,
     a yardstick the port never calls, device time and cuda_ms, with the
     backend that ran it past head_dim 256), the bound and the ex2
     floor (one exponential per visible pair at 16 a clock an SM);
  3. backward kernels vs plain: the dQ and dK/dV kernels of the design
     BWD_DESIGNS names (wgmma; d64 at bf16 head_dim 64; persistent for
     bf16 at head_dim 16 and 32; tf32x3 for float32; dcluster128 in every
     dtype at WIDE_D, where a second run must give the same bits; dcluster
     from 896 up in every dtype; each case names them and must launch
     them)
     against flash_attention_bwd_plain, per
     case (the train paths' shapes among them, the pipelined step's b=3,
     gpt_j_6b's head_dim 256: its train shape, b=2, non-causal, q the
     suffix, ragged; phase 2's head_dim-16/32 cases; and in float32
     train_f32's shape, head_dims 16 to 256, ragged, non-causal and rows
     that see no key; phase 2's WIDE_D cases and those from 896 up): each row of dq,
     dk, dv held to its own norm (ray_tpu_torch/ops/tolerance.py; float32
     against the plain backward in float64, with the plain version's own
     float32 error beside it, not gated), max abs
     error, each kernel's device time and cuda_ms, bound and ex2 floor, the
     plain time and the library time (torch.autograd.grad through
     scaled_dot_product_attention, its backend named past 256);
  3b. plain_design: dot_product_attention with a backward through the
     dispatch tables' plain design (inputs no kernel takes, where the
     reference takes its XLA route: head_dim 48 in bf16, 16 in float16),
     and through the kernels at head_dim 64 in float16 and in bf16 at a
     negative scale, at head_dims 384, 512, 640 and 768 in bf16 and in
     float32 (the dcluster128 forward, dQ and dK/dV: this slice's path, the
     16-bit backward from its wgmma build) and at 896 in
     bf16 and float32 (the dcluster forward, dQ and dK/dV), every count set
     to 0 before each case; out and dq,
     dk, dv held to the CPU's row by row (float32 against the plain
     backward in float64), and
     the counters of the case's designs risen by exactly one forward and one
     of each backward launch a case; every other phase gates plain
     launches at 0;
  4. train: three float32 gpt_nano steps on the card held to the same steps
     on the CPU; then gpt_1b (bf16 compute, float32 master weights and Adam
     moments, remat "nothing"), b=12, t=2048, ce_chunk 512, lr 1e-4: one
     warm-up step and 5 timed steps on one repeated batch. Loss and grad
     norm finite, the last loss below the first, and per step exactly
     2 * num_layers forward launches and num_layers launches of each
     backward kernel, all on the wgmma designs;
  4b. remat_policies: the same gpt_1b train step, batch and fresh seed-0
     weights under the remat policies "attn" and "dots", one warm-up and 2
     timed steps each: the warm-up step's loss bitwise equal to phase 4's,
     its grad norm within 1e-3 relative, and per step num_layers ("attn":
     the flash forward's output is kept) or 2 * num_layers ("dots")
     forward launches and num_layers of each backward kernel, on wgmma;
     ms per step and peak memory per policy;
  4c. moe_small_vs_cpu: three float32 steps of a mixture-of-experts
     gpt_nano (4 experts, top 2, capacity factor 0.25, so tokens are
     dropped) on the card held to the same steps on the CPU (rtol 1e-4),
     and every block's slot of every assignment equal on both (the same
     kept set), some kept and some dropped;
  4d. train_moe: gpt_1b at full width with a 4-expert MLP per block (top 2,
     capacity factor 1.25, aux weight 0.01), b=8, t=2048, ce_chunk 512:
     one warm-up and 3 timed steps; the gates of phase 4; ms per step,
     tokens/s, MFU by train_step_flops and by the work the experts execute,
     peak memory, the aux loss and the share of assignments dropped;
  4e. train_gpt_j: gpt_j_6b at full width and depth (28 layers, d_model
     4096, 16 heads x 256, mlp 16384, vocab 50400) with bf16 parameters and
     Adam moments, b=1, t=2048, ce_chunk 256, remat "nothing", lr 1e-4 (the
     reference's _aot_gpt_j_6b step, one card's share of its batch): one
     warm-up and 3 timed steps; the gates of phase 4 (56 forward launches
     and 28 of each backward kernel a step, all wgmma, so the head_dim-256
     backward design), parameters and moments still bf16; ms per step,
     tokens/s, MFU, peak memory;
  4f. train_f32: gpt_1b in float32 (parameters, compute, Adam moments) at
     full width and depth, b=4, t=2048, ce_chunk 512, remat "nothing": one
     warm-up and 2 timed steps; the gates of phase 4 with 32 forward
     launches a step and 16 of each backward kernel, all on tf32x3 (the
     3xTF32 designs; none on the bf16 designs or the CUDA-core kernels),
     parameters and moments still float32; ms per step, tokens/s, peak
     memory and, with --profile, the flash group's device time. cuBLAS runs
     with TF32 off, so the step's GEMMs are float32 on the CUDA cores;
  4g. train_nano_bf16: gpt_nano (2 layers, 4 heads x 16) in bf16 compute
     with float32 master weights and moments, remat "nothing", b=512,
     t=128: one warm-up and 3 timed steps; the gates of phase 4 with 4
     forward launches a step on the persistent design and 2 of each
     backward kernel on persistent, the warm-up loss within 2e-2 of the same
     step on the CPU in float32 from the same weights; ms per step and,
     from one more step under torch.profiler, the idle share;
  4h. train_125m: gpt_125m (12 layers, 12 heads x 64, d_model 768, vocab
     50304) at full width and depth in bf16 compute with float32 master
     weights and moments, remat "nothing", at bench.py's 125m cell (b=16,
     t=2048, ce_chunk 256): one warm-up and 3 timed steps; the gates of
     phase 4 with 24 forward launches a step on d64, 12 dQ and 12 dK/dV on
     d64, none on wgmma or plain; the warm-up loss within LOSS_125M_RTOL of
     the same step in float32 on the card from the same weights and batch
     (the tf32x3 kernels, 24 / 12 / 12 launches), and the q, k and v
     projections' gradients of a bf16 forward and backward within
     ATTN_GRAD_125M_RTOL of the float32 one's, with two controls (dK and dV
     swapped, dq zeroed) that must fail that limit; ms per step, tokens/s,
     MFU against 989 TFLOP/s and, from one more step under torch.profiler,
     the idle share;
  5. forward: gpt_1b in bf16 (random weights from a seeded torch.Generator),
     b=4, t=2048; the wgmma forward kernel must launch num_layers times per
     forward;
  5b. entry_config (run after 8a, once phase 5's weights are freed): the
     reference's entry and configuration surface, every count set to 0
     first: (a) ray_tpu_torch.entry.entry() (gpt_1b, bf16 parameters, b=1,
     t=512; its shape is phase 2's entry_gpt_1b_b1_t512): 16 wgmma forward
     launches a forward, none on plain, finite logits, ms per forward and,
     from one more forward under torch.profiler, the idle share; (b) the
     same parameters with attn_use_pallas=False on random tokens: 16 plain
     forward launches and no kernel launch, layer 0's attention output
     within the bf16 row limit of the flash route's, the logits' largest
     difference printed; (c)
     bench.py's gpt_1b cell (attn_block_q = attn_block_k = 1024, ce_chunk
     512, scan_layers=False, bf16 parameters and moments, b=12, t=2048): a
     warm-up and 3 steps under phase 4's gates (32 / 16 / 16 wgmma launches
     a step, none on plain, the loss falling, the state bf16), ms per step
     and peak memory beside phase 4's step; (d) a causal call with t_q >
     t_kv at 1024 x 1024 tiles is refused, launching nothing;
  6. server: the in-process LLMServer at gpt_1b; 8 requests (4 share a
     512-token prefix), prefix-cache hits, bitwise cached-vs-uncached
     logits, engine prefill vs full forward, no KV block leaked, and
     torch's deterministic mode after close() what it was before the
     server (the engine scopes it to its steps); the closed server's pool
     and weights go by reference count (7b's peak reads phase 4's); the
     engine reports to a recording metrics sink (runtime.RecordingMetrics
     through RuntimeHooks): over the 8 requests 8 ray_tpu_llm_ttft_seconds
     observations, ray_tpu_llm_prefill_tokens_total equal to the engine's
     own count, ray_tpu_llm_prefix_cache_hits_total equal to kv_stats()'s,
     and ray_tpu_llm_kv_blocks_in_use last set to 0;
  8a. device_plane: phase 5's gpt_1b bf16 parameters (1.01 B, 2.03 GB)
     through the port's tensor reducer (_private/device_plane.py) into a
     stand-in object store (its own serialize scope, lazy buffers and one
     host arena), rebuilt on the card: every tensor bitwise equal and the
     sink counting exactly the tensors' bytes in each direction, for a
     pageable arena, the plane registering each region for its copy, and
     the arena registered once; device->host and host->device GB/s beside
     the PCIe link's rate (nvidia-smi), and the metadata's size a tensor;
  7a. lse_grad: flash_attention_with_lse (out and lse, both differentiable:
     the flash forward, then the dQ and dK/dV kernels with delta - dlse) at
     gpt_1b's heads (b=2, h=16, t=2048, d=128) in bf16 (wgmma) and float32
     (tf32x3), gpt_j_6b's (d=256), d=512 (the dcluster128 forward and
     backward) and d=1024 with 8 heads
     (the dcluster forward and backward, this slice's path: one launch of
     each kernel, none on plain)
     in bf16, causal (a ring's step 0)
     and not (a hop), under random cotangents of both outputs: against the plain flash versions on the same
     inputs, and against autograd through the plain float32
     attention_with_lse with the rounding of out in delta moved into the
     lse cotangent (the exact gradient of the kernels' route); every row of
     dq, dk and dv, and of out, held to ray_tpu_torch/ops/tolerance.py, lse
     to its absolute limit; times of this path, of autograd through the
     plain one and of FlashAttention (out only), forward and backward;
  7b. sharded_train_ws1: phase 4's step through the sharded train step,
     make_train_step(cfg, opt, mesh=MeshSpec(fsdp=-1).build(),
     state_shardings_tree=...), on a one-rank NCCL process group (a
     HashStore, no port): DTensor parameters and moments from
     init_sharded_state(seed=0); one warm-up and 3 timed steps. The
     warm-up loss equal to phase 4's to 1e-6 relative, its grad norm to
     1e-3; per step phase 4's launches, all on wgmma; ms per step beside
     phase 4's and peak memory;
  7c. sp_ring_ws1 / sp_ulysses_ws1: the same step on MeshSpec(sp=1) with
     seq_parallel_impl "ring" and "ulysses", a warm-up and 2 timed steps
     each: sequence_parallel_attention falls through to the flash kernels,
     with phase 4's launches per step and first loss;
  7d. pp_small_ws1 / pp_train_ws1, on the same group: the pipelined step
     (make_pp_train_step at MeshSpec(pp=1), state in the stacked layout
     under pp_rules, the GPipe tick schedule over one stage): (a) float32
     gpt_nano, 2 microbatches, against the dense step on the card, first
     loss within 1e-5; (b) phase 4's gpt_1b cell with 4 microbatches of 3
     rows, a warm-up and 3 timed steps: run_train's gates with 128 forward
     launches and 64 of each backward kernel a step (2 * num_layers * M and
     num_layers * M, all wgmma), the warm-up loss within PP_LOSS_RTOL of
     phase 4's (the reference's final norm computes in bf16), the peak
     within phase 4's + 1 GiB; ms per step, tokens/s and MFU beside phase
     4's;
  8b. train_loop, on the same group: phase 4's cell through
     train.loop.gpt_train_loop (the body of a runtime trainer's loop, with
     a stand-in session), fed by iter_device_batches from seeded numpy
     batches that differ each step: a warm-up and steps 1-4, the state
     gathered after step 2 (gather_state, the loop's checkpoint), restored
     into a fresh state (restore_sharded_state) and held to the tree bit
     for bit, then the loop resumed from the checkpoint for steps 3-4.
     Phase 4's launches a step, all wgmma; the resumed steps' loss and
     grad norm bitwise equal to the unbroken run's; ms per step (step 1,
     report to report: a step is reported once the next is queued) and
     over steps 3-4 (the first launched from an idle card after the
     checkpoint) beside phase 4's, and with --profile the device busy time
     and idle share over steps 3-4 beside phase 4's.
  9. rl, the RL stack (ray_tpu_torch.rl) with the default in-process hooks
     (every actor in this process), learners and the workers' forwards on
     the card, envs, replay and GAE on the host; no flash kernel may
     launch: 9a each on-policy learner's update (PPO's 24 optimizer steps)
     card vs CPU, parameters and metrics within rtol 1e-4 and atol 1e-6;
     9b the catalog's policies card vs CPU within 1e-5; 9c PPO and 9d
     IMPALA learn CartPole at the reference's gates (>= 120 within 30
     iterations, >= 80 within 40 calls); 9e each off-policy learner's
     update card vs CPU over three updates from the reference's initial
     weights, the same batches and the same rl.prng noise (DQN with
     prioritized weights, Rainbow with 51 atoms, Ape-X's worker TD error,
     SAC with the auto-tuned temperature, TD3 with a skipped actor step,
     DDPG, CQL, MARWIL and BC, the last three reading their data through an
     in-memory dataset hook), within 9a's limits (an element whose
     gradient was at the rounding floor, |g| < 1e-6, within 2 * lr a step);
     9f DQN learns CartPole at the reference's gate (>= 100 within 60
     iterations), the update's ms and, with --profile, its idle share; 9g
     Ape-X for 2 iterations, the policy server over 20 external episodes
     (updates > 0, transitions > 300, learner on the card), ES for 2
     iterations and SAC on Pendulum past its warm-up.
The card machine has one GPU and NCCL puts one rank on a device, so phases
7b-7d run the sharded and pipelined paths at world size 1: every
collective of more than one rank (the gathers and reductions over fsdp,
tp, ep and the data axes, ring's exchange, Ulysses' all-to-all, MoE's
count exchange, the pipeline's hops over pp) runs only in the CPU tests,
over gloo (tests/test_torch_parallel_*.py). With --profile, one more dense
train step under each policy, one more MoE train step, one more pipelined
step (7d), a forward and a wave of 4 requests run under torch.profiler;
device time by kernel, by operator and by range (the delta pass, the MoE
router, dispatch, experts and combine) and the idle share are printed
(and written to --out).

Prints the card's name and power limit, a {"kernels": [...]} line, and as
its last line {"ok": true, "device": {...}}. Exits non-zero without a card.
Each forward case names the design (FWD_DESIGNS: wgmma, d64, persistent,
tf32x3, dcluster128 or dcluster) and the
tiles that ran it; each backward case names its design (BWD_DESIGNS: wgmma,
d64, persistent, tf32x3, dcluster128 or dcluster). In
the kernels line, flash_fwd is the wgmma design, the one the main path
runs, at gpt_1b's forward shape (b=4) with the forward phase's launches,
and the backward kernels at the train step's shape (b=12) with the train
phase's; every entry names its shape and its launches on each path (train,
remat_attn, remat_dots, train_moe, train_gpt_j, forward, server,
sharded_ws1, sp_ring_ws1, sp_ulysses_ws1, pp_train_ws1, entry_forward
(5b(a)), entry_train (5b(c)): the timed steps or calls of each;
train_loop: all of 8b's steps, warm-ups and resumed run included); flash_fwd
carries entry()'s case (entry_gpt_1b_b1_t512) with 5b(a)'s launches under
"entry"
and the case of phases 2-3 that checked it at each path's shape, and
carries the head_dim-256 case's (d256_gpt_j, train_gpt_j's shape) numbers
under "d256" and the float32 case's (gpt_1b_f32_b4, train_f32's shape, on
the float32 designs with train_f32's launches) under "f32", which also
stand as entries of their own (flash_fwd_f32, flash_bwd_dq_f32,
flash_bwd_dkv_f32: the kernels of train_f32's path), and 4g's kernels
stand as flash_fwd_persistent, flash_bwd_dq_persistent and
flash_bwd_dkv_persistent at gpt_nano's working case with 4g's launches, the
tiny flagship's case under "d32"; 4h's kernels stand as flash_fwd_d64,
flash_bwd_dq_d64 and flash_bwd_dkv_d64 at gpt_125m's b=16 case with 4h's
launches, the b=4 case under "b4"; the bf16 backward at WIDE_D (no
model path runs it) stands as flash_bwd_dq_dcluster128_wgmma and
flash_bwd_dkv_dcluster128_wgmma at d640_b2, the other WIDE_D cases under
"d384", "d512" and "d768", each naming the library's backend, with the
launches of this slice's path at its head_dim (3b, and 7a at 512; the
port's launches_by_head_dim, read as BY_HEAD_DIM); the forward at WIDE_D
stands as flash_fwd_dcluster128 at d640_b2 (bf16), the other WIDE_D cases
under "d384", "d512" and "d768" and the float32 ones under "f32", each
with the launches of this slice's path at its head_dim and dtype (3b, and
7a at 512); the kernels from 896 up
stand as flash_fwd_dcluster, flash_bwd_dq_dcluster and flash_bwd_dkv_dcluster
at d1024_b2 (bf16), d896_b2 and d2048_b2 under "d896" and "d2048", the
float32 cases under "f32", each naming the library's backend, with the
launches of the path at that head_dim (3b at 896, 7a at 1024); the float32
backward at WIDE_D stands as flash_bwd_dq_dcluster128 and
flash_bwd_dkv_dcluster128 at d640_b2_f32, the other WIDE_D cases under
"d384", "d512" and "d768", with the launches of this slice's path at each
head_dim (3b); the backward kernels' plain and library
times are those of the whole backward (dq, dk and dv together). In the
kernels line ms and library_ms are device times (torch.profiler),
event_ms the time between events.
"""

from __future__ import annotations

import os

# cuBLAS reads this when it makes its first handle; the serving engine's
# deterministic steps need it, and the engine refuses to start without it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import ctypes  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

# NVIDIA H100 SXM data sheet, dense, and HBM3. bf16: the tensor cores' 989
# TFLOP/s. float32: a third of the dense TF32 rate (494.7 / 3), the fastest
# way the card does float32 work at float32 accuracy (3xTF32: three TF32
# products for each float32 one); the CUDA cores' 67 TFLOP/s would put a
# tensor-core kernel above 100% of its bound
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 494.7e12 / 3}
HBM_BYTES_PER_S = 3.35e12
# the head_dims past 256 that the tables' rows take
# (ray_tpu_torch/ops/attention.py's WIDE_HEAD_DIMS: the forward's and the
# backward's dcluster128 in every dtype)
WIDE_D = (384, 512, 640, 768)
# the head_dims from 896 up (the tables' rule, from DSPLIT_MIN_D: the
# forward's and the backward's dcluster in bf16, float16 and float32, d a
# runtime argument) that phases 2-3 time;
# they check 1152, 4096 and 8192 besides, and count launches at the first five
DSPLIT_D = (896, 1024, 2048)
DSPLIT_BY_D = (896, 1024, 1152, 2048, 4096)
# gpt_nano float32 steps on the card vs the CPU: summation order through two
# layers, the loss and three optimizer updates (dense and MoE)
TRAIN_SMALL_RTOL = 1e-4
# a remat policy's first step vs "nothing"'s: the same forward (the loss
# must agree bit for bit); the backward reads kept tensors that are the
# recomputed ones' bits, so the grad norm differs by summation order at most
POLICY_GRAD_NORM_RTOL = 1e-3
# gpt_1b engine prefill vs full forward, last-position logits, bf16: the two
# paths round in other places (flash kernel with bf16 P vs f32 softmax, other
# GEMM shapes) through 16 layers; logits have std ~1 at this init
ENGINE_VS_FORWARD_ATOL = 0.1
# the sharded step on one rank vs phase 4's first step: the same forward,
# but the loss sums the sequence's last position with weight 0 in 512-row
# chunks over 2048 positions (phase 4: 2047), so the sums differ in order
SHARDED_LOSS_RTOL = 1e-6
# the sharded step at world size 1 holds what phase 4's step holds: the same
# tensors, plus DTensor views that share their storage
SHARDED_PEAK_GIB = 0.1
# 7d: the pipelined step's microbatches (b=12 -> 4 of 3 rows, as the
# reference's default num_microbatches)
PP_MICROBATCHES = 4
# 7d(a): float32 gpt_nano, the pipelined step at pp 1 vs the dense step on
# the card: the same layers on the same rows, a microbatch at a time, and
# the reference's two-pass final norm, which in float32 differs from the
# model's LayerNorm by rounding only
PP_SMALL_LOSS_RTOL = 1e-5
# 7d(b): gpt_1b's first pipelined loss vs phase 4's; the only difference in
# values is the reference's final norm, whose statistics are bf16 there: the
# first run on an H100 read 2.45e-5, and the limit is four times that
PP_LOSS_RTOL = 1e-4
# 7d(b)'s peak over phase 4's: the stacked output ([12, 2048, 2048] bf16,
# 96 MiB) and its masked copy, the embedding kept for the ticks' selects
# (96 MiB), and each tick's selected input (24 MiB); the layers' kept inputs
# are phase 4's (16 x 4 ticks x 24 MiB = 16 x 96 MiB), and a recomputed
# layer is a quarter of phase 4's
PP_PEAK_GIB = 1.0
# 4g: gpt_nano's first bf16 loss on the card vs the float32 step on the CPU
# from the same weights: bf16 rounds every activation and P (2^-9 relative
# each) through 2 layers (the two steps on the CPU at b=64 read 3.4e-6
# apart); at these random weights the loss is ~ln(256) whatever attention
# gives, so phases 2-3 hold the kernels themselves
NANO_BF16_LOSS_RTOL = 2e-2


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    return timed(fn, iters, warmup)[0]


def timed(fn, iters: int, warmup: int = 2, kernel: str | None = None):
    """(ms, device_ms): ``cuda_ms`` of ``fn`` (CUDA events around ``iters``
    back-to-back calls, which at a small shape time the host's launches)
    and, with ``kernel``, the mean device time per call of the kernels whose
    names hold ``kernel`` ("" for every kernel), from torch.profiler's
    kernel durations over the same calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        prof = profile(activities=[ProfilerActivity.CUDA]) if kernel is not None else None
        if prof is not None:
            prof.__enter__()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        if prof is None:
            return start.elapsed_time(end) / iters, None
        prof.__exit__(None, None, None)
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and kernel in e.key and e.key not in RANGES]
        # some windows lose kernel records, so each kernel's mean is over the
        # records that arrived: a named kernel launches once a call, and
        # every kernel of a call ("") counts its mean as often as it
        # launches a call (its records over the calls, rounded), and one that
        # launches less than every other call its total over the calls
        calls = sum(e.count for e in events)
        if calls < iters // 2:
            continue
        if kernel:
            device_us = sum(e.self_device_time_total for e in events)
            return start.elapsed_time(end) / iters, device_us / calls / 1e3
        device_us = sum(e.self_device_time_total / e.count * round(e.count / iters)
                        if round(e.count / iters) else e.self_device_time_total / iters
                        for e in events if e.count)
        return start.elapsed_time(end) / iters, device_us / 1e3
    raise SystemExit(f"torch.profiler recorded {calls} kernels matching {kernel!r} over "
                     f"{iters} calls, three times")


def sdpa_backend(fn) -> str:
    """The backend of scaled_dot_product_attention that ``fn`` ran, read
    from the names of the kernels of one call under torch.profiler: flash,
    cudnn, efficient (the memory-efficient kernels) or math (plain
    operators)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(e.key.lower() for e in prof.key_averages())
    for backend, marks in (("flash", ("flash",)), ("cudnn", ("cudnn",)),
                           ("efficient", ("fmha", "efficient", "mem_eff"))):
        if any(m in names for m in marks):
            return backend
    return "math"


def ex2_floor_ms(b, h, t_q, t_kv, causal):
    """One exponential per visible (q, k) pair at the card's special-function
    rate: 16 ``ex2`` results a clock on each SM at the SMs' highest clock
    (``nvidia-smi`` clocks.max.sm), a floor that the bound leaves out."""
    off = t_kv - t_q
    pairs = (int(np.clip(np.arange(t_q) + off + 1, 0, t_kv).sum()) if causal
             else t_q * t_kv)
    return b * h * pairs / EX2_PER_S * 1e3


def ex2_rate() -> float:
    """``ex2`` results a second: SMs x 16 a clock x the highest SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * 16 * mhz * 1e6


# set by main() from the card (ex2_rate)
EX2_PER_S = float("nan")


def attention_bound(b, h, t_q, t_kv, d, causal, dtype):
    """(bound_ms, bound_by, flops, bytes): operations this input needs (the
    visible (q, k) pairs only) over the dtype's peak, and each input read
    once and each output written once over HBM bandwidth."""
    off = t_kv - t_q
    if causal:
        rows = np.arange(t_q)
        pairs = int(np.clip(rows + off + 1, 0, t_kv).sum())
    else:
        pairs = t_q * t_kv
    flops = 4.0 * b * h * d * pairs
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * h * d * elem * (2 * t_q + 2 * t_kv) + 4 * b * h * t_q
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes"), flops, nbytes


def bwd_bound(b, h, t_q, t_kv, d, causal, dtype, products):
    """(bound_ms, bound_by) of one backward kernel: ``products`` matrix
    products of 2 * d operations per visible (q, k) pair, and q, k, v, dO,
    lse and delta read once and its outputs written once (dQ: dq; dK/dV:
    dk and dv)."""
    _, _, flops4, _ = attention_bound(b, h, t_q, t_kv, d, causal, dtype)
    flops = flops4 / 4 * 2 * products
    elem = torch.tensor([], dtype=dtype).element_size()
    outs = t_q if products == 3 else 2 * t_kv
    nbytes = b * h * d * elem * (2 * t_q + 2 * t_kv + outs) + 8 * b * h * t_q
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def phase_build():
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.attention import DSPLIT_MIN_D, WIDE_HEAD_DIMS

    if WIDE_HEAD_DIMS != WIDE_D or DSPLIT_MIN_D != DSPLIT_D[0]:
        raise SystemExit(f"the port's wide head_dims are {WIDE_HEAD_DIMS} and dcluster's first "
                         f"{DSPLIT_MIN_D}, this script's {WIDE_D} and {DSPLIT_D[0]}")

    def timed(name):
        t0 = time.monotonic()
        return _build.build(name), time.monotonic() - t0

    t0 = time.monotonic()
    names = ("flash_fwd_wgmma", "flash_fwd_d64", "flash_fwd_persistent", "flash_fwd",
             "flash_fwd_f32", "flash_fwd_wide", "flash_bwd_wgmma", "flash_bwd_d64",
             "flash_bwd_persistent", "flash_bwd", "flash_bwd_f32", "flash_bwd_wide",
             "flash_fwd_dsplit", "flash_bwd_dsplit", "flash_bwd_dcluster", "flash_fwd_dcluster",
             "flash_bwd_dcluster128", "flash_bwd_dcluster128_wgmma", "flash_fwd_dcluster128")
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source
        built = dict(zip(names, pool.map(timed, names)))
    out = {"seconds": time.monotonic() - t0}
    for name, (lib, seconds) in built.items():
        print(f"[build] {lib.name} in {seconds:.1f} s")
        # the compiler's register, shared-memory and spill report, kept
        # beside the library
        report = lib.with_name(lib.name + ".log").read_text()
        for line in report.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "warning")):
                print(f"[build]   {line.strip()}")
        out[name] = {"seconds": seconds, "library": lib.name,
                     "spills": _spills_by_kernel(report),
                     "registers": _registers_by_kernel(report)}
    # the train paths' kernels (each in bf16 and float16: the mangled names
    # differ after the head_dim): the wgmma forward and both wgmma backward
    # kernels at head_dim 128 (gpt_1b) and 256 (gpt_j_6b: dK/dV is the split
    # kernel there), wgmma's dQ at 64 (the variants' "before"), the persistent
    # forward, dQ and dK/dV at 16 (gpt_nano) and 32, the float32 forward's
    # and backward's (3xTF32) at 64, 128, 256 and WIDE_D, and the wide
    # forward, dQ and dK/dV at WIDE_D
    f32 = [(source, kernel, d) for source, kernel in (
        ("flash_fwd_f32", "flash_fwd_f32x3_kernel"),
        ("flash_bwd_f32", "flash_bwd_dq_f32x3_kernel"),
        ("flash_bwd_f32", "flash_bwd_dkv_f32x3_kernel")) for d in (64, 128, 256, *WIDE_D)]
    wide = [(source, kernel, d) for source, kernel in (
        ("flash_fwd_wide", "flash_fwd_wide_kernel"),
        ("flash_bwd_wide", "flash_bwd_dq_wide_kernel"),
        ("flash_bwd_wide", "flash_bwd_dkv_wide_kernel")) for d in WIDE_D]
    for source, kernel, d in (("flash_fwd_wgmma", "flash_fwd_wgmma_kernel", 128),
                              ("flash_fwd_wgmma", "flash_fwd_wgmma_kernel", 256),
                              ("flash_bwd_wgmma", "flash_bwd_dq_wgmma_kernel", 64),
                              ("flash_bwd_wgmma", "flash_bwd_dq_wgmma_kernel", 128),
                              ("flash_bwd_wgmma", "flash_bwd_dkv_wgmma_kernel", 128),
                              ("flash_bwd_wgmma", "flash_bwd_dq_wgmma_kernel", 256),
                              ("flash_bwd_wgmma", "flash_bwd_dkv_wgmma_split_kernel", 256),
                              *[(source, kernel, d) for source, kernel in (
                                  ("flash_fwd_persistent", "flash_fwd_persistent_kernel"),
                                  ("flash_bwd_persistent", "flash_bwd_dq_persistent_kernel"),
                                  ("flash_bwd_persistent", "flash_bwd_dkv_persistent_kernel"))
                                for d in (16, 32)],
                              *f32, *wide):
        main = {k: v for k, v in out[source]["spills"].items()
                if f"{kernel}ILi{d}E" in k}
        if not main or any(main.values()):
            raise SystemExit(f"{kernel} at head_dim {d} spills: {main}")
    # the head_dim-64 designs (gpt_125m's) and the wide ones (WIDE_D):
    # no spill in any build, each kernel's shared memory and CTAs an SM (the
    # backward sources' functions take the kernel, 1 for dK/dV, after d)
    for source, kernel, head_dims, dkv in (
            ("flash_fwd_d64", "flash_fwd_d64_kernel", (64,), None),
            ("flash_bwd_d64", "flash_bwd_dq_d64_kernel", (64,), 0),
            ("flash_bwd_d64", "flash_bwd_dkv_d64_kernel", (64,), 1),
            ("flash_fwd_wide", "flash_fwd_wide_kernel", WIDE_D, None),
            ("flash_bwd_wide", "flash_bwd_dq_wide_kernel", WIDE_D, 0),
            ("flash_bwd_wide", "flash_bwd_dkv_wide_kernel", WIDE_D, 1)):
        main = {k: v for k, v in out[source]["spills"].items() if kernel in k}
        if not main or any(main.values()):
            raise SystemExit(f"{kernel} spills: {main}")
        lib = ctypes.CDLL(str(built[source][0]))
        args = () if dkv is None else (dkv,)
        for fn in ("smem_bytes", "ctas_per_sm"):
            getattr(lib, f"ray_tpu_{source}_{fn}").argtypes = [ctypes.c_int] * (1 + len(args))
        smem = {d: getattr(lib, f"ray_tpu_{source}_smem_bytes")(d, *args) for d in head_dims}
        ctas = {d: getattr(lib, f"ray_tpu_{source}_ctas_per_sm")(d, *args) for d in head_dims}
        print(f"[build] {kernel} by head_dim: {smem} bytes of dynamic shared memory per CTA "
              f"(of 232448), {ctas} CTAs resident per SM, spill bytes {main}")
        if any(not 0 < n <= 232448 for n in smem.values()) or any(n < 1 for n in ctas.values()):
            raise SystemExit(f"{kernel} asks for {smem} bytes of shared memory, {ctas} CTAs an SM")
        out[source].setdefault("smem_bytes", {})[kernel] = smem
        out[source].setdefault("ctas_per_sm", {})[kernel] = ctas
    # the dsplit kernels (every multiple of 128 from 896 up, d a runtime
    # argument): one build a dtype, bf16 and float16 on mma.sync m16n8k16 and
    # float32 in 3xTF32, none may spill; registers a thread, dynamic shared
    # memory and CTAs an SM by dtype (the backward's functions take 1 for
    # dK/dV after the dtype code)
    codes = {"bfloat16": ("I13__nv_bfloat16E", 0), "float16": ("I6__halfE", 2),
             "float32": ("IfE", 1)}
    for source, kernel, dkv in (("flash_fwd_dsplit", "flash_fwd_dsplit_kernel", None),
                                ("flash_bwd_dsplit", "flash_bwd_dq_dsplit_kernel", 0),
                                ("flash_bwd_dsplit", "flash_bwd_dkv_dsplit_kernel", 1)):
        spills = {name: next((n for k, n in out[source]["spills"].items() if kernel + mark in k),
                             None) for name, (mark, _) in codes.items()}
        regs = {name: next((n for k, n in out[source]["registers"].items()
                            if kernel + mark in k), None) for name, (mark, _) in codes.items()}
        lib = ctypes.CDLL(str(built[source][0]))
        args = () if dkv is None else (dkv,)
        for fn in ("smem_bytes", "ctas_per_sm"):
            getattr(lib, f"ray_tpu_{source}_{fn}").argtypes = [ctypes.c_int] * (1 + len(args))
        smem = {name: getattr(lib, f"ray_tpu_{source}_smem_bytes")(code, *args)
                for name, (_, code) in codes.items()}
        ctas = {name: getattr(lib, f"ray_tpu_{source}_ctas_per_sm")(code, *args)
                for name, (_, code) in codes.items()}
        print(f"[build] {kernel} by dtype: registers a thread {regs}, spill bytes {spills}, "
              f"{smem} bytes of dynamic shared memory per CTA (of 232448), {ctas} CTAs "
              f"resident per SM")
        if any(n != 0 for n in spills.values()):
            raise SystemExit(f"{kernel} spills, or a dtype's build is missing: {spills}")
        if any(not 0 < n <= 232448 for n in smem.values()) or any(n < 1 for n in ctas.values()):
            raise SystemExit(f"{kernel} asks for {smem} bytes of shared memory, {ctas} CTAs an SM")
        out[source].setdefault("smem_bytes", {})[kernel] = smem
        out[source].setdefault("ctas_per_sm", {})[kernel] = ctas
        out[source].setdefault("registers_by_dtype", {})[kernel] = regs
    # the dcluster kernels (the forward and the backward from 896 up, d a
    # runtime argument, the CTAs of a thread-block cluster sharing a resident
    # tile): one build a dtype and kernel, none may spill; registers a
    # thread, dynamic shared memory, and the clusters resident at once at
    # each cluster size the plan gives from 896 to 8192 (4 to 8 CTAs;
    # cudaOccupancyMaxActiveClusters), each above 0
    from ray_tpu_torch.ops.dcluster import dcluster_plan

    sizes = sorted({dcluster_plan(d, torch.float32).cluster
                    for d in range(DSPLIT_D[0], 8192 + 1, 128)})
    lib = ctypes.CDLL(str(built["flash_bwd_dcluster"][0]))
    lib.ray_tpu_flash_bwd_dcluster_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.ray_tpu_flash_bwd_dcluster_max_clusters.argtypes = [ctypes.c_int] * 3
    for dkv, name in enumerate(("flash_bwd_dq_dcluster", "flash_bwd_dkv_dcluster")):
        marks = {dt: f"{name}_kernel{tmark}" for dt, (tmark, _) in codes.items()}
        spills = {dt: next((n for k, n in out["flash_bwd_dcluster"]["spills"].items() if m in k),
                           None) for dt, m in marks.items()}
        regs = {dt: next((n for k, n in out["flash_bwd_dcluster"]["registers"].items()
                          if m in k), None) for dt, m in marks.items()}
        smem = {dt: lib.ray_tpu_flash_bwd_dcluster_smem_bytes(code, dkv)
                for dt, (_, code) in codes.items()}
        clusters = {dt: {c: lib.ray_tpu_flash_bwd_dcluster_max_clusters(code, dkv, c)
                         for c in sizes} for dt, (_, code) in codes.items()}
        print(f"[build] {name} by dtype: registers a thread {regs}, spill bytes {spills}, "
              f"{smem} bytes of dynamic shared memory per CTA (of 232448), clusters resident "
              f"at once by cluster size {clusters}")
        if any(n != 0 for n in spills.values()):
            raise SystemExit(f"{name} spills, or a dtype's build is missing: {spills}")
        if (any(not 0 < n <= 232448 for n in smem.values())
                or any(n < 1 for by_c in clusters.values() for n in by_c.values())):
            raise SystemExit(f"{name} asks for {smem} bytes of shared memory, {clusters} "
                             f"clusters resident at once")
        out["flash_bwd_dcluster"].setdefault("smem_bytes", {})[name] = smem
        out["flash_bwd_dcluster"].setdefault("max_active_clusters", {})[name] = clusters
        out["flash_bwd_dcluster"].setdefault("registers_by_dtype", {})[name] = regs
    fwd_dc = ctypes.CDLL(str(built["flash_fwd_dcluster"][0]))
    fwd_dc.ray_tpu_flash_fwd_dcluster_smem_bytes.argtypes = [ctypes.c_int]
    fwd_dc.ray_tpu_flash_fwd_dcluster_max_clusters.argtypes = [ctypes.c_int] * 2
    marks = {dt: f"flash_fwd_dcluster_kernel{tmark}" for dt, (tmark, _) in codes.items()}
    report = out["flash_fwd_dcluster"]
    spills = {dt: next((n for k, n in report["spills"].items() if m in k), None)
              for dt, m in marks.items()}
    regs = {dt: next((n for k, n in report["registers"].items() if m in k), None)
            for dt, m in marks.items()}
    smem = {dt: fwd_dc.ray_tpu_flash_fwd_dcluster_smem_bytes(code)
            for dt, (_, code) in codes.items()}
    clusters = {dt: {c: fwd_dc.ray_tpu_flash_fwd_dcluster_max_clusters(code, c) for c in sizes}
                for dt, (_, code) in codes.items()}
    print(f"[build] flash_fwd_dcluster by dtype: registers a thread {regs}, spill bytes "
          f"{spills}, {smem} bytes of dynamic shared memory per CTA (of 232448), clusters "
          f"resident at once by cluster size {clusters}")
    if any(n != 0 for n in spills.values()):
        raise SystemExit(f"flash_fwd_dcluster spills, or a dtype's build is missing: {spills}")
    if (any(not 0 < n <= 232448 for n in smem.values())
            or any(n < 1 for by_c in clusters.values() for n in by_c.values())):
        raise SystemExit(f"flash_fwd_dcluster asks for {smem} bytes of shared memory, "
                         f"{clusters} clusters resident at once")
    report.update(smem_bytes=smem, max_active_clusters=clusters, registers_by_dtype=regs)
    # the float32 backward at WIDE_D (dcluster128: 128-column groups, C = d /
    # 128 CTAs a cluster): no spill, registers a thread, dynamic shared
    # memory and the clusters resident at once at each cluster size of its
    # plan (3 to 6), each above 0
    from ray_tpu_torch.ops.dcluster import dcluster128_plan

    sizes = sorted({dcluster128_plan(d, torch.float32).cluster for d in WIDE_D})
    lib = ctypes.CDLL(str(built["flash_bwd_dcluster128"][0]))
    lib.ray_tpu_flash_bwd_dcluster128_smem_bytes.argtypes = [ctypes.c_int]
    lib.ray_tpu_flash_bwd_dcluster128_max_clusters.argtypes = [ctypes.c_int] * 2
    report = out["flash_bwd_dcluster128"]
    for dkv, name in enumerate(("flash_bwd_dq_dcluster128", "flash_bwd_dkv_dcluster128")):
        spills = next((n for k, n in report["spills"].items() if f"{name}_kernel" in k), None)
        regs = next((n for k, n in report["registers"].items() if f"{name}_kernel" in k), None)
        smem = lib.ray_tpu_flash_bwd_dcluster128_smem_bytes(dkv)
        clusters = {c: lib.ray_tpu_flash_bwd_dcluster128_max_clusters(dkv, c) for c in sizes}
        print(f"[build] {name}: registers a thread {regs}, spill bytes {spills}, {smem} bytes "
              f"of dynamic shared memory per CTA (of 232448), clusters resident at once by "
              f"cluster size {clusters}")
        if spills != 0:
            raise SystemExit(f"{name} spills, or its build is missing: {spills}")
        if not 0 < smem <= 232448 or any(n < 1 for n in clusters.values()):
            raise SystemExit(f"{name} asks for {smem} bytes of shared memory, {clusters} "
                             f"clusters resident at once")
        report.setdefault("smem_bytes", {})[name] = smem
        report.setdefault("max_active_clusters", {})[name] = clusters
        report.setdefault("registers_by_kernel", {})[name] = regs
    # the forward at WIDE_D (dcluster128: a build each in bf16, float16 and
    # float32, the same plan): no spill, registers a thread, dynamic shared
    # memory, CTAs an SM and the clusters resident at once at each cluster
    # size of its plan (3 to 6), each above 0
    from ray_tpu_torch.ops.dcluster import dcluster128_fwd_plan

    sizes = sorted({dcluster128_fwd_plan(d, torch.float32).cluster for d in WIDE_D})
    lib = ctypes.CDLL(str(built["flash_fwd_dcluster128"][0]))
    for fn, n_args in (("smem_bytes", 1), ("ctas_per_sm", 1), ("max_clusters", 2)):
        getattr(lib, f"ray_tpu_flash_fwd_dcluster128_{fn}").argtypes = [ctypes.c_int] * n_args
    report = out["flash_fwd_dcluster128"]
    marks = {dt: f"flash_fwd_dcluster128_kernel{tmark}" for dt, (tmark, _) in codes.items()}
    spills = {dt: next((n for k, n in report["spills"].items() if m in k), None)
              for dt, m in marks.items()}
    regs = {dt: next((n for k, n in report["registers"].items() if m in k), None)
            for dt, m in marks.items()}
    smem = {dt: lib.ray_tpu_flash_fwd_dcluster128_smem_bytes(code)
            for dt, (_, code) in codes.items()}
    ctas = {dt: lib.ray_tpu_flash_fwd_dcluster128_ctas_per_sm(code)
            for dt, (_, code) in codes.items()}
    clusters = {dt: {c: lib.ray_tpu_flash_fwd_dcluster128_max_clusters(code, c) for c in sizes}
                for dt, (_, code) in codes.items()}
    print(f"[build] flash_fwd_dcluster128 by dtype: registers a thread {regs}, spill bytes "
          f"{spills}, {smem} bytes of dynamic shared memory per CTA (of 232448), {ctas} CTAs "
          f"resident per SM, clusters resident at once by cluster size {clusters}")
    if any(n != 0 for n in spills.values()):
        raise SystemExit(f"flash_fwd_dcluster128 spills, or a dtype's build is missing: {spills}")
    if (any(not 0 < n <= 232448 for n in smem.values()) or any(n < 1 for n in ctas.values())
            or any(n < 1 for by_c in clusters.values() for n in by_c.values())):
        raise SystemExit(f"flash_fwd_dcluster128 asks for {smem} bytes of shared memory, {ctas} "
                         f"CTAs an SM, {clusters} clusters resident at once")
    report.update(smem_bytes=smem, ctas_per_sm=ctas, max_active_clusters=clusters,
                  registers_by_dtype=regs)
    # the bf16 and float16 backward at WIDE_D (dcluster128's wgmma build: a
    # build each in bf16 and float16; dQ's streamed side by cluster size,
    # two builds a dtype): no build may spill; registers a thread of each
    # build, and at each of WIDE_D the dynamic shared memory, CTAs an SM and
    # clusters resident at once of the build it launches there, each above 0
    source = "flash_bwd_dcluster128_wgmma"
    lib = ctypes.CDLL(str(built[source][0]))
    for fn in ("ctas_per_sm", "max_clusters"):
        getattr(lib, f"ray_tpu_{source}_{fn}").argtypes = [ctypes.c_int] * 3
    lib.ray_tpu_flash_bwd_dcluster128_wgmma_smem_bytes.argtypes = [ctypes.c_int] * 2
    report = out[source]
    half = {dt: c for dt, c in codes.items() if dt != "float32"}
    for dkv, name in enumerate(("flash_bwd_dq_dcluster128_wgmma",
                                "flash_bwd_dkv_dcluster128_wgmma")):
        marks = {dt: f"{name}_kernel{tmark.removesuffix('E')}" for dt, (tmark, _) in
                 half.items()}
        spills = {dt: {k: n for k, n in report["spills"].items() if m in k}
                  for dt, m in marks.items()}
        regs = {dt: sorted({n for k, n in report["registers"].items() if m in k})
                for dt, m in marks.items()}
        smem = {d: lib.ray_tpu_flash_bwd_dcluster128_wgmma_smem_bytes(dkv, d) for d in WIDE_D}
        ctas = {dt: {d: lib.ray_tpu_flash_bwd_dcluster128_wgmma_ctas_per_sm(code, dkv, d)
                     for d in WIDE_D} for dt, (_, code) in half.items()}
        clusters = {dt: {d: lib.ray_tpu_flash_bwd_dcluster128_wgmma_max_clusters(code, dkv, d)
                         for d in WIDE_D} for dt, (_, code) in half.items()}
        print(f"[build] {name} by dtype: registers a thread {regs}, spill bytes "
              f"{ {dt: sum(v.values()) for dt, v in spills.items()} }; by head_dim "
              f"{smem} bytes of dynamic shared memory per CTA (of 232448), CTAs resident "
              f"per SM {ctas}, clusters resident at once {clusters}")
        if any(not v or any(v.values()) for v in spills.values()):
            raise SystemExit(f"{name} spills, or a dtype's build is missing: {spills}")
        if (any(not 0 < n <= 232448 for n in smem.values())
                or any(n < 1 for by_d in (*ctas.values(), *clusters.values())
                       for n in by_d.values())):
            raise SystemExit(f"{name} asks for {smem} bytes of shared memory, {ctas} CTAs an "
                             f"SM, {clusters} clusters resident at once")
        report.setdefault("smem_bytes", {})[name] = smem
        report.setdefault("ctas_per_sm", {})[name] = ctas
        report.setdefault("max_active_clusters", {})[name] = clusters
        report.setdefault("registers_by_dtype", {})[name] = regs
    # dynamic shared memory, which the compiler's report does not show
    fwd_lib = ctypes.CDLL(str(built["flash_fwd_wgmma"][0]))
    fwd_lib.ray_tpu_flash_fwd_wgmma_smem_bytes.argtypes = [ctypes.c_int]
    smem = {d: fwd_lib.ray_tpu_flash_fwd_wgmma_smem_bytes(d) for d in (64, 128, 256)}
    print(f"[build] flash_fwd_wgmma dynamic shared memory per CTA by head_dim: {smem} "
          f"bytes (of 232448)")
    out["flash_fwd_wgmma"]["smem_bytes"] = smem
    small_lib = ctypes.CDLL(str(built["flash_fwd_persistent"][0]))
    for fn in ("smem_bytes", "ctas_per_sm"):
        getattr(small_lib, f"ray_tpu_flash_fwd_persistent_{fn}").argtypes = [ctypes.c_int]
    smem = {d: small_lib.ray_tpu_flash_fwd_persistent_smem_bytes(d) for d in (16, 32)}
    ctas = {d: small_lib.ray_tpu_flash_fwd_persistent_ctas_per_sm(d) for d in (16, 32)}
    print(f"[build] flash_fwd_persistent dynamic shared memory per CTA by head_dim: {smem} "
          f"bytes (of 232448); CTAs resident per SM {ctas}")
    if any(not 0 < n <= 232448 for n in smem.values()) or any(n < 1 for n in ctas.values()):
        raise SystemExit(f"the persistent forward asks for {smem} bytes of shared memory, "
                         f"{ctas} CTAs an SM")
    out["flash_fwd_persistent"].update(smem_bytes=smem, ctas_per_sm=ctas)
    small_bwd = ctypes.CDLL(str(built["flash_bwd_persistent"][0]))
    for fn in ("smem_bytes", "ctas_per_sm"):
        getattr(small_bwd, f"ray_tpu_flash_bwd_persistent_{fn}").argtypes = [ctypes.c_int,
                                                                              ctypes.c_int]
    smem = {kernel: {d: small_bwd.ray_tpu_flash_bwd_persistent_smem_bytes(d, dkv)
                     for d in (16, 32)} for kernel, dkv in (("dq", 0), ("dkv", 1))}
    ctas = {kernel: {d: small_bwd.ray_tpu_flash_bwd_persistent_ctas_per_sm(d, dkv)
                     for d in (16, 32)} for kernel, dkv in (("dq", 0), ("dkv", 1))}
    print(f"[build] flash_bwd_persistent dynamic shared memory per CTA by kernel and "
          f"head_dim: {smem} bytes (of 232448); CTAs resident per SM {ctas}")
    if (any(not 0 < n <= 232448 for by_d in smem.values() for n in by_d.values())
            or any(n < 1 for by_d in ctas.values() for n in by_d.values())):
        raise SystemExit(f"the persistent backward asks for {smem} bytes of shared memory, "
                         f"{ctas} CTAs an SM")
    out["flash_bwd_persistent"].update(smem_bytes=smem, ctas_per_sm=ctas)
    bwd_lib = ctypes.CDLL(str(built["flash_bwd_wgmma"][0]))
    bwd_lib.ray_tpu_flash_bwd_wgmma_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    smem = {kernel: {d: bwd_lib.ray_tpu_flash_bwd_wgmma_smem_bytes(d, dkv)
                     for d in (64, 128, 256)}
            for kernel, dkv in (("dq", 0), ("dkv", 1))}
    print(f"[build] flash_bwd_wgmma dynamic shared memory per CTA by kernel and head_dim: "
          f"{smem} bytes (of 232448)")
    if any(n > 232448 for by_d in smem.values() for n in by_d.values()):
        raise SystemExit(f"a wgmma backward kernel asks for more than 232448 bytes: {smem}")
    out["flash_bwd_wgmma"]["smem_bytes"] = smem
    f32_lib = ctypes.CDLL(str(built["flash_bwd_f32"][0]))
    f32_lib.ray_tpu_flash_bwd_f32_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    smem = {kernel: {d: f32_lib.ray_tpu_flash_bwd_f32_smem_bytes(d, dkv)
                     for d in (16, 32, 64, 128, 256, *WIDE_D)}
            for kernel, dkv in (("dq", 0), ("dkv", 1))}
    print(f"[build] flash_bwd_f32 dynamic shared memory per CTA by kernel and head_dim: "
          f"{smem} bytes (of 232448)")
    if any(not 0 < n <= 232448 for by_d in smem.values() for n in by_d.values()):
        raise SystemExit(f"a float32 backward kernel asks for more than 232448 bytes: {smem}")
    out["flash_bwd_f32"]["smem_bytes"] = smem
    fwd_f32_lib = ctypes.CDLL(str(built["flash_fwd_f32"][0]))
    fwd_f32_lib.ray_tpu_flash_fwd_f32_smem_bytes.argtypes = [ctypes.c_int]
    smem = {d: fwd_f32_lib.ray_tpu_flash_fwd_f32_smem_bytes(d)
            for d in (16, 32, 64, 128, 256, *WIDE_D)}
    print(f"[build] flash_fwd_f32 dynamic shared memory per CTA by head_dim: {smem} bytes "
          f"(of 232448)")
    if any(not 0 < n <= 232448 for n in smem.values()):
        raise SystemExit(f"the float32 forward kernel asks for more than 232448 bytes: {smem}")
    out["flash_fwd_f32"]["smem_bytes"] = smem
    return out


def _by_kernel(report: str, pattern: str, value):
    """{mangled kernel name: value(match)} for each line of a ``-Xptxas -v``
    report that ``pattern`` matches, under the kernel that the report's last
    "Function properties" line named."""
    out, current = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
        m = re.search(pattern, line)
        if m and current is not None:
            out[current] = value(m)
    return out


def _spills_by_kernel(report: str):
    """{mangled kernel name: spill stores + spill loads in bytes}."""
    return _by_kernel(report, r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      lambda m: int(m.group(1)) + int(m.group(2)))


def _registers_by_kernel(report: str):
    """{mangled kernel name: registers a thread}."""
    return _by_kernel(report, r"Used (\d+) registers", lambda m: int(m.group(1)))


def phase_kernel_vs_plain():
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops.tolerance import FWD_LSE_TOL, FWD_ROW_TOL, row_err

    cases = [
        # name, b, h, t_q, t_kv, d, causal, dtype
        ("gpt_1b_train_b12", 12, 16, 2048, 2048, 128, True, torch.bfloat16),
        ("gpt_1b_moe_b8", 8, 16, 2048, 2048, 128, True, torch.bfloat16),
        ("gpt_1b", 4, 16, 2048, 2048, 128, True, torch.bfloat16),
        ("gpt_1b_pp_mb3", 3, 16, 2048, 2048, 128, True, torch.bfloat16),
        *D64_CASES,
        ("d256_gpt_j", 1, 16, 2048, 2048, 256, True, torch.bfloat16),
        ("suffix_tq256_tkv2048", 4, 16, 256, 2048, 128, True, torch.bfloat16),
        ("ragged_tkv72_full", 4, 16, 64, 72, 128, False, torch.bfloat16),
        ("ragged_t2056_causal", 1, 16, 2056, 2056, 128, True, torch.bfloat16),
        ("noncausal", 4, 16, 2048, 2048, 128, False, torch.bfloat16),
        ("tq_gt_tkv_empty_rows", 1, 2, 160, 64, 128, True, torch.bfloat16),
        *SMALL_D_CASES,
        ("f32_ragged_d64", 1, 4, 200, 264, 64, True, torch.float32),
        *F32_CASES,
        *F16_CASES,
        *WIDE_CASES,
        *DSPLIT_CASES,
        # 5b(a)'s shape, entry()'s forward (last, so every earlier case
        # keeps the inputs the seeded stream gave it before)
        ("entry_gpt_1b_b1_t512", 1, 16, 512, 512, 128, True, torch.bfloat16),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, b, h, t_q, t_kv, d, causal, dtype in cases:
        q = torch.randn(b, h, t_q, d, device="cuda", dtype=dtype, generator=gen)
        k = torch.randn(b, h, t_kv, d, device="cuda", dtype=dtype, generator=gen)
        v = torch.randn(b, h, t_kv, d, device="cuda", dtype=dtype, generator=gen)
        scale = 1.0 / d ** 0.5
        design = attn.FWD_DESIGNS[(d, dtype)]
        want = ("dcluster" if d >= DSPLIT_D[0] else "dcluster128" if d in WIDE_D else
                "tf32x3" if dtype == torch.float32 else
                {16: "persistent", 32: "persistent", 64: "d64"}.get(d, "wgmma"))
        if design.name != want:
            raise SystemExit(f"FWD_DESIGNS sends {dtype} head_dim {d} to {design.name}, "
                             f"expected {want}")
        before = _launch_counts()
        out, lse = attn.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        launched = dict(zip(COUNTS, (a - b for a, b in zip(_launch_counts(), before))))
        if {n: c for n, c in launched.items() if c} != {
                "flash_fwd": 1, f"flash_fwd_{design.name}": 1,
                **_by_head_dim("flash_fwd", design.name, d)}:
            raise SystemExit(f"case {name}: the forward launched {launched}, expected one "
                             f"launch on the {design.name} design")
        # the cluster designs at WIDE_D: a second run gives the same bits
        again = (attn.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
                 if d in WIDE_D else (out, lse))
        ref_out, ref_lse = attn.flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
        torch.cuda.synchronize()
        err = float((out.float() - ref_out.float()).abs().max())
        out_row_err = row_err(out, ref_out)
        lse_err = float((lse - ref_lse).abs().max())
        out_tol, lse_tol = FWD_ROW_TOL[dtype], FWD_LSE_TOL[dtype]
        bit_equal = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        ok = (out_row_err <= out_tol and lse_err <= lse_tol and bit_equal
              and bool(torch.isfinite(out).all()))
        row = dict(case=name, shape=[b, h, t_q, t_kv, d], causal=causal,
                   dtype=str(dtype).replace("torch.", ""), design=design.name,
                   source=f"ray_tpu_torch/ops/csrc/{design.source}.cu",
                   tiles=[design.block_q, design.block_k], max_abs_err=err,
                   row_err=out_row_err, row_err_tol=out_tol,
                   lse_max_abs_err=lse_err, lse_tol=lse_tol, bit_equal=bit_equal, ok=ok)
        rows.append(row)
        verdict = (f"[kernel] {name:<22} {str(row['shape']):<28} {design.name} "
                   f"{design.block_q}x{design.block_k} worst-row err "
                   f"{out_row_err:.2e} (limit {out_tol:.0e}), max abs err {err:.2e}, lse "
                   f"{lse_err:.2e} (limit {lse_tol:.0e})"
                   f"{', second run bit-equal' if d in WIDE_D and bit_equal else ''} "
                   f"{'ok' if ok else 'FAIL'}")
        if name in CHECK_ONLY:
            print(verdict)
            continue
        big = b * h * t_q * t_kv >= 2 ** 26
        # the cases from 896 up take 1.6-41 ms a call: 5 calls a timing
        iters = 5 if d >= DSPLIT_D[0] else 20 if big else 50
        ms, device_ms = timed(
            lambda: attn.flash_attention_fwd(q, k, v, causal=causal, scale=scale),
            iters=iters, kernel="flash_fwd")
        plain_ms = cuda_ms(
            lambda: attn.flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale),
            iters=3, warmup=1)
        if causal and t_q != t_kv:
            # bottom-right causal mask: q is the suffix of the context
            mask = attn._causal_mask(t_q, t_kv, q.device)
            lib_fn = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)  # noqa: E731
        else:
            lib_fn = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=scale)  # noqa: E731
        library_ms, library_device_ms = timed(lib_fn, iters=iters, kernel="")
        backend = sdpa_backend(lib_fn) if d > 256 else None
        bound_ms, bound_by, flops, nbytes = attention_bound(b, h, t_q, t_kv, d, causal, dtype)
        row.update(ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
                   library_device_ms=library_device_ms, library_backend=backend,
                   bound_ms=bound_ms,
                   bound_by=bound_by, ex2_floor_ms=ex2_floor_ms(b, h, t_q, t_kv, causal),
                   tflops=flops / device_ms / 1e9, bound_share=bound_ms / device_ms)
        print(f"{verdict} | kernel {device_ms:.4f} ms on the device, {ms:.4f} between "
              f"events ({row['tflops']:.1f} TFLOP/s, {100 * row['bound_share']:.1f}% of "
              f"bound) plain {plain_ms:.3f} ms library {library_device_ms:.4f} ms on the "
              f"device, {library_ms:.4f} between events"
              f"{'' if backend is None else f' (SDPA backend {backend})'} | bound {bound_ms:.4f} ms "
              f"({bound_by}), ex2 floor {row['ex2_floor_ms']:.4f} ms")
    bad = [(r["case"], r["row_err"], r["lse_max_abs_err"]) for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version or with its own second "
                         f"run (case, worst-row error of out against {FWD_ROW_TOL}, lse "
                         f"error against {FWD_LSE_TOL}): {bad}")
    return rows


# bf16 at head_dim 16 and 32, in both phases: gpt_nano's heads (4 x 16,
# t=128) at 4g's batch of 512 and the tiny flagship's (8 x 32, t=256,
# __graft_entry__.py) at b=256, 65536 tokens a launch each, where the kernels
# do work; then, checked and not timed (CHECK_ONLY), long t (many kv tiles
# and the causal skip), ragged q and kv, q the suffix of kv, rows that see no
# key and a ragged non-causal pair; and the earlier small cases, timed
SMALL_D_CASES = [
    ("d16_nano_b512", 512, 4, 128, 128, 16, True, torch.bfloat16),
    ("d32_tiny_cfg_b256", 256, 8, 256, 256, 32, True, torch.bfloat16),
    *[(f"d{d}_{name}", b, h, t_q, t_kv, d, causal, torch.bfloat16)
      for d, h in ((16, 4), (32, 8))
      for name, b, t_q, t_kv, causal in (
          ("t2048", 1, 2048, 2048, True),
          ("ragged_tq200_tkv264", 2, 200, 264, True),
          ("suffix_tq64_tkv256", 2, 64, 256, True),
          ("tq_gt_tkv", 1, 160, 64, True),
          ("noncausal_tq200_tkv264", 2, 200, 264, False))],
    ("d16_tiny", 2, 4, 24, 40, 16, True, torch.bfloat16),
    ("d32_tiny_cfg", 2, 8, 256, 256, 32, True, torch.bfloat16),
]
# bf16 at head_dim 64, in both phases: gpt_125m's heads (12 x 64, t=2048,
# causal) at b=4 and at 4h's (and bench.py's) b=16, timed; then, checked
# only, ragged q and kv, q the suffix of kv, rows that see no key and a
# ragged non-causal pair (ragged ends inside the d64 forward's 128-row items
# and the dK/dV kernel's 128-row Q tiles)
D64_CASES = [
    ("d64_gpt_125m", 4, 12, 2048, 2048, 64, True, torch.bfloat16),
    ("d64_gpt_125m_b16", 16, 12, 2048, 2048, 64, True, torch.bfloat16),
    ("d64_ragged_tq200_tkv264", 2, 12, 200, 264, 64, True, torch.bfloat16),
    ("d64_suffix_tq320_tkv2048", 1, 12, 320, 2048, 64, True, torch.bfloat16),
    ("tq_gt_tkv_d64", 1, 2, 160, 64, 64, True, torch.bfloat16),
    ("d64_tq_gt_tkv_t520", 1, 4, 520, 200, 64, True, torch.bfloat16),
    ("d64_noncausal_tq200_tkv264", 2, 4, 200, 264, 64, False, torch.bfloat16),
]
# float16 at head_dim 64, 128 and 256 (the bf16 kernels' float16 builds), in
# both phases, checked only, last (so every earlier case keeps the inputs
# the seeded stream gave it before): gpt_125m's heads at b=4, ragged, rows
# that see no key, non-causal
F16_CASES = [
    ("f16_d64_gpt_125m", 4, 12, 2048, 2048, 64, True, torch.float16),
    ("f16_d64_ragged_tq200_tkv264", 2, 12, 200, 264, 64, True, torch.float16),
    ("f16_d64_tq_gt_tkv", 1, 2, 160, 64, 64, True, torch.float16),
    ("f16_d128_ragged_tq200_tkv264", 2, 16, 200, 264, 128, True, torch.float16),
    ("f16_d128_noncausal_t384", 2, 16, 384, 384, 128, False, torch.float16),
    ("f16_d256_ragged_tq200_tkv264", 2, 16, 200, 264, 256, True, torch.float16),
]
# head_dims WIDE_D (no model path: the reference's dispatcher takes any
# multiple of 128), in both phases, last, 384 and 512 before 640 and 768:
# timed at 2 x 8 heads x 2048^2, causal (model widths of 3072 to 6144) in
# bf16 and float32 (the forward's and the backward's dcluster128); checked
# only, ragged q and kv,
# rows that see no key (t_q 160, t_kv 64), non-causal, float16, and float32
# ragged and with rows that see no key
def _wide_cases(head_dims):
    return [
        *[(f"d{d}_b2{suffix}", 2, 8, 2048, 2048, d, True, dtype)
          for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_f32"))
          for d in head_dims],
        *[(f"{prefix}d{d}_{name}", b, h, t_q, t_kv, d, causal, dtype)
          for prefix, dtype in (("", torch.bfloat16), ("f16_", torch.float16),
                                ("f32_", torch.float32))
          for d in head_dims
          for name, b, h, t_q, t_kv, causal in (
              ("ragged_tq200_tkv264", 2, 8, 200, 264, True),
              ("tq_gt_tkv", 1, 2, 160, 64, True),
              ("noncausal_t384", 2, 8, 384, 384, False))],
    ]


WIDE_CASES = _wide_cases(WIDE_D[:2]) + _wide_cases(WIDE_D[2:])
WIDE_TIMED = {f"d{d}_b2{suffix}" for d in WIDE_D for suffix in ("", "_f32")}
# head_dims from 896 up (the tables' rule; no model path), in both
# phases, last: timed at 2 x 8 heads x 2048^2, causal, at DSPLIT_D in bf16
# and float32; checked only, at 1152 (4.5 column groups in clusters of 5,
# 13 rows a forward reducer, the last 12) ragged q and kv, rows that see no
# key (t_q 160, t_kv 64) and non-causal in bf16, float16 and float32, 4096
# at (1, 2, 256, 256) (two passes) and 8192 at (1, 1, 160, 64) (four
# passes, rows that see no key)
DSPLIT_CASES = [
    *[(f"d{d}_b2{suffix}", 2, 8, 2048, 2048, d, True, dtype)
      for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_f32")) for d in DSPLIT_D],
    *[(f"{prefix}d1152_{name}", b, h, t_q, t_kv, 1152, causal, dtype)
      for prefix, dtype in (("", torch.bfloat16), ("f16_", torch.float16),
                            ("f32_", torch.float32))
      for name, b, h, t_q, t_kv, causal in (
          ("ragged_tq200_tkv264", 2, 4, 200, 264, True),
          ("tq_gt_tkv", 1, 2, 160, 64, True),
          ("noncausal_t384", 1, 4, 384, 384, False))],
    *[(f"{prefix}d4096_t256", 1, 2, 256, 256, 4096, True, dtype)
      for prefix, dtype in (("", torch.bfloat16), ("f16_", torch.float16),
                            ("f32_", torch.float32))],
    *[(f"{prefix}d8192_tq_gt_tkv", 1, 1, 160, 64, 8192, True, dtype)
      for prefix, dtype in (("", torch.bfloat16), ("f16_", torch.float16),
                            ("f32_", torch.float32))],
]
DSPLIT_TIMED = {f"d{d}_b2{suffix}" for d in DSPLIT_D for suffix in ("", "_f32")}
CHECK_ONLY = ({name for name, *_ in SMALL_D_CASES[2:-2]}
              | {name for name, *_ in D64_CASES[2:]} | {name for name, *_ in F16_CASES}
              | {name for name, *_ in WIDE_CASES if name not in WIDE_TIMED}
              | {name for name, *_ in DSPLIT_CASES if name not in DSPLIT_TIMED})

# float32, in both phases: train_f32's shape (gpt_1b at b=4), gpt_125m's and
# gpt_j_6b's heads, ragged tiles (at 128 and at 256, where the forward and
# dK/dV cut d between warps), rows that see no key, non-causal, and the head_dims of
# gpt_nano (16) and the reference's tiny flagship (32)
F32_CASES = [
    ("gpt_1b_f32_b4", 4, 16, 2048, 2048, 128, True, torch.float32),
    ("d64_f32", 4, 12, 2048, 2048, 64, True, torch.float32),
    ("d256_f32", 1, 16, 2048, 2048, 256, True, torch.float32),
    ("d256_ragged_f32", 2, 16, 200, 264, 256, True, torch.float32),
    ("ragged_f32", 2, 16, 200, 264, 128, True, torch.float32),
    ("tq_gt_tkv_f32", 1, 2, 160, 64, 128, True, torch.float32),
    ("noncausal_t384_f32", 2, 16, 384, 384, 128, False, torch.float32),
    ("d16_f32_tiny", 2, 4, 24, 40, 16, True, torch.float32),
    ("d32_f32_tiny_cfg", 2, 8, 256, 256, 32, True, torch.float32),
]

BWD_CASES = [
    # name, b, h, t_q, t_kv, d, causal, dtype
    ("gpt_1b_train_b12", 12, 16, 2048, 2048, 128, True, torch.bfloat16),
    ("gpt_1b_moe_b8", 8, 16, 2048, 2048, 128, True, torch.bfloat16),
    ("gpt_1b", 4, 16, 2048, 2048, 128, True, torch.bfloat16),
    ("gpt_1b_pp_mb3", 3, 16, 2048, 2048, 128, True, torch.bfloat16),
    *D64_CASES,
    ("d256_gpt_j", 1, 16, 2048, 2048, 256, True, torch.bfloat16),
    ("d256_b2", 2, 16, 2048, 2048, 256, True, torch.bfloat16),
    ("d256_noncausal", 1, 16, 2048, 2048, 256, False, torch.bfloat16),
    ("d256_suffix_tq256_tkv2048", 1, 16, 256, 2048, 256, True, torch.bfloat16),
    ("d256_ragged_tq200_tkv264", 2, 16, 200, 264, 256, True, torch.bfloat16),
    ("suffix_tq256_tkv2048", 4, 16, 256, 2048, 128, True, torch.bfloat16),
    ("ragged_tq200_tkv264", 2, 16, 200, 264, 128, True, torch.bfloat16),
    ("ragged_tkv72_full", 4, 16, 64, 72, 128, False, torch.bfloat16),
    ("ragged_t2056_causal", 1, 16, 2056, 2056, 128, True, torch.bfloat16),
    ("noncausal", 4, 16, 2048, 2048, 128, False, torch.bfloat16),
    ("tq_gt_tkv_empty_rows", 1, 2, 160, 64, 128, True, torch.bfloat16),
    ("noncausal_t384", 2, 16, 384, 384, 128, False, torch.bfloat16),
    *SMALL_D_CASES,
    ("f32_ragged_d64", 1, 4, 200, 264, 64, True, torch.float32),
    *F32_CASES,
    *F16_CASES,
    *WIDE_CASES,
    *DSPLIT_CASES,
]


def phase_bwd_kernels_vs_plain():
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops.tolerance import BWD_TOL, row_err

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for name, b, h, t_q, t_kv, d, causal, dtype in BWD_CASES:
        q, k, v, do = (torch.randn(b, h, t, d, device="cuda", dtype=dtype, generator=gen)
                       for t in (t_q, t_kv, t_kv, t_q))
        scale = 1.0 / d ** 0.5
        design = attn.BWD_DESIGNS[(d, dtype)]
        names = {"dq": design.dq.name, "dkv": design.dkv.name}
        want = ({"dq": "dcluster", "dkv": "dcluster"} if d >= DSPLIT_D[0] else
                {"dq": "dcluster128", "dkv": "dcluster128"} if d in WIDE_D else
                {"dq": "tf32x3", "dkv": "tf32x3"} if dtype == torch.float32 else
                {16: {"dq": "persistent", "dkv": "persistent"},
                 32: {"dq": "persistent", "dkv": "persistent"},
                 64: {"dq": "d64", "dkv": "d64"}}.get(d, {"dq": "wgmma", "dkv": "wgmma"}))
        if names != want:
            raise SystemExit(f"BWD_DESIGNS sends {dtype} head_dim {d} to {names}, "
                             f"expected {want}")
        out, lse = attn.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        before = _launch_counts()
        got = attn.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, scale=scale)
        launched = dict(zip(COUNTS, (a - b for a, b in zip(_launch_counts(), before))))
        expected = {name: n for kernel in ("dq", "dkv")
                    for name, n in ((f"flash_bwd_{kernel}", 1),
                                    (f"flash_bwd_{kernel}_{names[kernel]}", 1),
                                    *_by_head_dim(f"flash_bwd_{kernel}", names[kernel],
                                                  d).items())}
        if {n: c for n, c in launched.items() if c} != expected:
            raise SystemExit(f"case {name}: the backward launched {launched}, expected "
                             f"{expected}")
        # the cluster designs at WIDE_D: a second run gives the same bits
        again = (attn.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, scale=scale)
                 if d in WIDE_D else got)
        # float32: the plain backward in float64 from the same inputs. The
        # exact dq of the first causal row is rounding noise (its one term
        # has dP = delta), and at long t and head_dim 384 and up the plain
        # version's own float32 rounding there reaches the gate's 1e-4 of the
        # row floor; the row's error of the plain version in float32 against
        # float64 is printed beside the kernels' (not gated)
        want = attn.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                              scale=scale)
        plain32_errs = None
        if dtype == torch.float32:
            want32 = want
            want = attn.flash_attention_bwd_plain(
                *(x.double() for x in (q, k, v, out, lse, do)), causal=causal, scale=scale)
            plain32_errs = {g_name: row_err(x, ref) for g_name, x, ref in
                            zip(("dq", "dk", "dv"), want32, want)}
            del want32
        torch.cuda.synchronize()
        errs, row_errs = {}, {}
        for g_name, x, ref in zip(("dq", "dk", "dv"), got, want):
            errs[g_name] = float((x.float() - ref.float()).abs().max())
            row_errs[g_name] = row_err(x, ref)
        tol = BWD_TOL[dtype]
        bit_equal = all(torch.equal(x, y) for x, y in zip(got, again))
        del again
        ok = all(e <= tol for e in row_errs.values()) and all(
            bool(torch.isfinite(x).all()) for x in got) and bit_equal
        row = dict(case=name, shape=[b, h, t_q, t_kv, d], causal=causal,
                   dtype=str(dtype).replace("torch.", ""),
                   design=names["dq"] if names["dq"] == names["dkv"] else
                   f"{names['dq']}/{names['dkv']}", designs=names,
                   sources={kn: f"ray_tpu_torch/ops/csrc/{getattr(design, kn).source}.cu"
                            for kn in ("dq", "dkv")},
                   source=f"ray_tpu_torch/ops/csrc/{design.dq.source}.cu", max_abs_err=errs,
                   row_err=row_errs, row_err_tol=tol, ok=ok, second_run_bit_equal=bit_equal,
                   plain_float32_row_err_vs_float64=plain32_errs)
        rows.append(row)
        verdict = (f"[bwd] {name:<22} {str(row['shape']):<28} {row['design']:<9} worst-row err "
                   f"dq {row_errs['dq']:.2e} dk {row_errs['dk']:.2e} dv {row_errs['dv']:.2e} "
                   f"(limit {tol:.0e}), max abs err {errs['dq']:.2e} {errs['dk']:.2e} "
                   f"{errs['dv']:.2e}{', second run bit-equal' if d in WIDE_D and bit_equal else ''}"
                   f"{'' if bit_equal else ', second run DIFFERS'} {'ok' if ok else 'FAIL'}"
                   + ("" if plain32_errs is None else
                      " (against the plain version in float64; the plain version in float32 "
                      "against it, not gated: " + " ".join(
                          f"{g} {e:.2e}" for g, e in plain32_errs.items()) + ")"))
        if name in CHECK_ONLY:
            print(verdict)
            del got, want
            continue
        big = b * h * t_q * t_kv >= 2 ** 26
        # the cases from 896 up take milliseconds a call: 5 calls a timing
        iters = 5 if d >= DSPLIT_D[0] else 10 if big else 50
        delta = attn.flash_bwd_delta(out, do)
        delta_ms = cuda_ms(lambda: attn.flash_bwd_delta(out, do), iters=iters)
        dq_ms, dq_device_ms = timed(
            lambda: attn.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale),
            iters=iters, kernel="flash_bwd_dq")
        dkv_ms, dkv_device_ms = timed(
            lambda: attn.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale),
            iters=iters, kernel="flash_bwd_dkv")
        plain_ms = cuda_ms(lambda: attn.flash_attention_bwd_plain(
            q, k, v, out, lse, do, causal=causal, scale=scale), iters=3, warmup=1)
        # the library's backward: autograd through a retained SDPA output
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        if causal and t_q != t_kv:
            lib_out = F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=attn._causal_mask(t_q, t_kv, q.device), scale=scale)
        else:
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                                     scale=scale)
        lib_bwd = lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True)  # noqa: E731
        library_ms, library_device_ms = timed(lib_bwd, iters=iters, kernel="")
        backend = sdpa_backend(lib_bwd) if d > 256 else None
        dq_bound, dq_by = bwd_bound(b, h, t_q, t_kv, d, causal, dtype, 3)
        dkv_bound, dkv_by = bwd_bound(b, h, t_q, t_kv, d, causal, dtype, 4)
        # dQ and dK/dV each take one exponential per visible pair (P again)
        ex2_ms = ex2_floor_ms(b, h, t_q, t_kv, causal)
        row.update(dq_ms=dq_ms, dkv_ms=dkv_ms, dq_device_ms=dq_device_ms,
                   dkv_device_ms=dkv_device_ms, delta_ms=delta_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   library_device_ms=library_device_ms, library_backend=backend,
                   dq_bound_ms=dq_bound,
                   dq_bound_by=dq_by, dkv_bound_ms=dkv_bound, dkv_bound_by=dkv_by,
                   ex2_floor_ms=ex2_ms, dq_bound_share=dq_bound / dq_device_ms,
                   dkv_bound_share=dkv_bound / dkv_device_ms)
        print(f"{verdict} | dQ {dq_device_ms:.4f} ms on the device, {dq_ms:.4f} between "
              f"events (bound {dq_bound:.4f}, {dq_by}) dK/dV {dkv_device_ms:.4f} ms on the "
              f"device, {dkv_ms:.4f} between events (bound {dkv_bound:.4f}, {dkv_by}), ex2 "
              f"floor {ex2_ms:.4f} ms each; delta {delta_ms:.4f} ms plain {plain_ms:.3f} ms "
              f"library {library_device_ms:.4f} ms on the device, {library_ms:.4f} between "
              f"events{'' if backend is None else f' (SDPA backend {backend})'}")
        del got, want, lib_out
    bad = [(r["case"], r["row_err"], r["second_run_bit_equal"]) for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"backward kernels disagree with their plain version "
                         f"(worst-row errors against {BWD_TOL}) or with their second run: {bad}")
    return rows


# the launch counts read around each path: every launch of each kernel, and
# each kernel's by design (the wgmma kernels are the bf16 paths' at head_dim
# 128 and 256; d64 the forward's, dQ's and dK/dV's at 64; at 16 and 32 the
# forward and the backward are persistent's; tf32x3 float32; the forward
# and the backward at WIDE_D in every dtype dcluster128, which phases 3b and
# 7a run and no model path does; every dtype from 896
# up dcluster, forward and backward, which phases 3b and 7a run; plain every
# input that no kernel takes, which only the plain_design phase may launch),
# and the dcluster128 kernels' by head_dim at WIDE_D and
# dcluster's at DSPLIT_BY_D (the port's launches_by_head_dim), which the
# kernels line reads for its 384-768 and dcluster entries
KERNEL_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
DESIGNS = {kernel: ("wgmma", "d64", "persistent", "tf32x3", "dcluster", "plain", "dcluster128")
           for kernel in KERNEL_NAMES}
BY_HEAD_DIM = tuple(f"{kernel}_{design}_d{d}" for kernel in KERNEL_NAMES
                    for design, dims in (("dcluster", DSPLIT_BY_D), ("dcluster128", WIDE_D))
                    for d in dims)
COUNTS = KERNEL_NAMES + tuple(
    f"{kernel}_{design}" for kernel in KERNEL_NAMES for design in DESIGNS[kernel]) + BY_HEAD_DIM


def _launch_counts():
    from ray_tpu_torch.ops import attention as attn

    return tuple(attn.launches_by_head_dim[name] if name in BY_HEAD_DIM else
                 getattr(attn, f"{name}_launches") for name in COUNTS)


def _reset_launch_counts():
    from ray_tpu_torch.ops import attention as attn

    for name in COUNTS:
        if name not in BY_HEAD_DIM:
            setattr(attn, f"{name}_launches", 0)
    attn.launches_by_head_dim.clear()


def _by_head_dim(kernel: str, design: str, d: int):
    """The count of BY_HEAD_DIM that a launch of ``kernel`` on ``design`` at
    head_dim ``d`` adds one to, or none."""
    name = f"{kernel}_{design}_d{d}"
    return {name: 1} if name in BY_HEAD_DIM else {}


def moe_slots(cfg, params, tokens):
    """Each MoE block's slot of every assignment (``moe.route`` on the
    block's MLP input; one past the last slot for a dropped one) in one
    forward of ``params`` without grad."""
    from ray_tpu_torch.models import gpt, moe

    model = gpt.GPT(cfg, device="meta")
    slots = []

    def grab(layer, args):
        # under functional_call the layer's router is the tensor of params
        xs = args[0].reshape(-1, cfg.embed_dim).to(cfg.dtype)
        slots.append(moe.route(xs, layer.router, cfg.moe_top_k,
                               moe.expert_capacity(cfg, xs.shape[0]))[3])

    for block in model.blocks:
        block.mlp.register_forward_pre_hook(grab)
    with torch.no_grad():
        torch.func.functional_call(model, params, (tokens,))
    return slots


def train_small_vs_cpu(steps: int = 3, **moe):
    """Float32 gpt_nano steps through the float32 kernels against
    the same steps on the CPU through the plain versions; ``moe`` (config
    fields) makes each block's MLP a mixture of experts: its aux loss is
    held to the same limit, and before the first step every block's slot of
    every assignment (so the kept set) must be equal on both devices, with
    some assignments dropped and some kept."""
    from ray_tpu_torch.models import gpt, inference, training
    from ray_tpu_torch.models.moe import expert_capacity

    cfg = gpt.gpt_nano(ce_chunk=32, **moe)
    label = "MoE gpt_nano" if moe else "gpt_nano"
    keys = ("loss", "grad_norm") + (("moe_aux",) if moe else ())
    tokens = torch.from_numpy(np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 80)))
    runs, slots, dropped = {}, {}, {}
    for dev in ("cpu", "cuda"):
        opt = training.default_optimizer(1e-2)
        params = {n: p.to(dev) for n, p in
                  inference.init_params(cfg, device="cpu", seed=4).items()}
        if moe:
            slots[dev] = [s.cpu() for s in moe_slots(cfg, params, tokens.to(dev))]
        state = training.init_train_state(params, opt)
        step = training.make_train_step(cfg, opt, device=dev)
        metrics, dropped[dev] = [], []
        for _ in range(steps):
            state, m = step(state, tokens)
            metrics.append([float(m[k]) for k in keys])
            dropped[dev].append(float(m["moe_dropped"]))
        runs[dev] = metrics
    worst = float(np.max(np.abs(np.array(runs["cuda"]) / np.array(runs["cpu"]) - 1)))
    print(f"[train] {label} f32 {steps} steps, card vs CPU: ({', '.join(keys)}) "
          f"{runs['cuda']} vs {runs['cpu']}, worst rel diff {worst:.2e} "
          f"(rtol {TRAIN_SMALL_RTOL})"
          + (f"; dropped share {dropped['cuda']} vs {dropped['cpu']}" if moe else ""))
    if not worst <= TRAIN_SMALL_RTOL:
        raise SystemExit(f"{label} steps on the card differ from the CPU by {worst}")
    out = dict(card=runs["cuda"], cpu=runs["cpu"], keys=list(keys), worst_rel_diff=worst,
               rtol=TRAIN_SMALL_RTOL)
    if moe:
        n_slots = cfg.moe_num_experts * expert_capacity(cfg, tokens.numel())
        kept = [int((s < n_slots).sum()) for s in slots["cpu"]]
        same = all(torch.equal(a, b) for a, b in zip(slots["cuda"], slots["cpu"]))
        print(f"[train] {label}: kept assignments per block {kept} of "
              f"{slots['cpu'][0].numel()}, card's slots equal to the CPU's: {same}")
        if not same or not all(0 < n < slots["cpu"][0].numel() for n in kept):
            raise SystemExit(f"{label}: the card kept other assignments than the CPU, or "
                             f"a block kept none or all (kept {kept})")
        out.update(config=moe, kept_per_block=kept, slots_equal=same,
                   dropped_card=dropped["cuda"], dropped_cpu=dropped["cpu"])
    return out


def single_device(cfg, opt):
    """(state, step) of the single-device train step from seed-0 weights."""
    from ray_tpu_torch.models import inference, training

    state = training.init_train_state(inference.init_params(cfg, device="cuda", seed=0), opt)
    return state, training.make_train_step(cfg, opt, device="cuda")


def run_train(cfg, tokens, steps: int, fwd_per_layer: int, label: str, profile: bool,
              build=single_device, microbatches: int = 1,
              designs=("wgmma", "wgmma", "wgmma")):
    """Train ``cfg`` on the card from fresh seed-0 weights on one repeated
    batch (``build(cfg, optimizer) -> (state, step)``, by default the
    single-device step): one warm-up step, then ``steps`` timed steps.
    Gates: per step ``fwd_per_layer * num_layers * microbatches`` forward
    launches and ``num_layers * microbatches`` of each backward kernel (the
    pipelined step runs every layer once per microbatch), all on the
    forward's, dQ's and dK/dV's ``designs`` (none on plain); loss
    and grad norm finite; the last loss below the first; parameters and
    Adam moments still in ``cfg.param_dtype`` (optax's adamw keeps the
    moments in the parameters' dtype). Returns the report; the state is
    freed before it returns."""
    from ray_tpu_torch.models import gpt, training

    batch, seq = tokens.shape
    opt = training.default_optimizer(1e-4)
    state, step = build(cfg, opt)
    state, warm = step(state, tokens)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    metrics, per_step = [], []
    t0 = time.monotonic()
    for _ in range(steps):
        before = _launch_counts()
        state, m = step(state, tokens)
        per_step.append([a - b for a, b in zip(_launch_counts(), before)])
        metrics.append(m)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = _launch_counts()
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    per_layer = cfg.num_layers * microbatches
    expected = {"flash_fwd": fwd_per_layer * per_layer, "flash_bwd_dq": per_layer,
                "flash_bwd_dkv": per_layer}
    expected.update({f"{name}_{design}": n
                     for (name, n), design in zip(list(expected.items()), designs)})
    want = [expected.get(name, 0) for name in COUNTS]
    if any(c != want for c in per_step):
        raise SystemExit(f"{label}: launches per step {dict(zip(COUNTS, zip(*per_step)))}, "
                         f"expected {dict(zip(COUNTS, want))}")
    if not all(np.isfinite(losses + norms)):
        raise SystemExit(f"{label}: train step gave loss {losses}, grad norm {norms}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"{label}: loss did not fall over {steps} steps: {losses}")
    state_dtypes = {str(t.dtype) for t in (*state.params.values(), *state.opt_state.mu,
                                           *state.opt_state.nu)}
    if state_dtypes != {str(cfg.param_dtype)}:
        raise SystemExit(f"{label}: parameters and moments in {state_dtypes}, expected "
                         f"{cfg.param_dtype}")
    ms = seconds / steps * 1e3
    flops = gpt.train_step_flops(cfg, batch, seq)
    report = dict(
        batch=batch, seq=seq, steps=steps, ce_chunk=cfg.ce_chunk, learning_rate=1e-4,
        microbatches=microbatches,
        remat_policy=cfg.remat_policy,
        ms_per_step=ms, tokens_per_s=batch * seq * steps / seconds,
        mfu=flops / (ms / 1e3) / PEAK_FLOPS[torch.bfloat16], train_step_flops=flops,
        warmup_loss=float(warm["loss"]), warmup_grad_norm=float(warm["grad_norm"]),
        losses=losses, grad_norms=norms,
        launches_per_step=dict(zip(COUNTS, want)),
        launches=dict(zip(COUNTS, launches)), state_dtype=str(cfg.param_dtype),
        max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if cfg.moe_num_experts:
        report.update(moe_aux=[float(m["moe_aux"]) for m in metrics],
                      moe_dropped=[float(m["moe_dropped"]) for m in metrics])
    print(f"[train] {label}, b={batch} t={seq}, remat '{cfg.remat_policy}': {ms:.1f} ms per "
          f"step, {report['tokens_per_s']:.0f} tokens/s, MFU {100 * report['mfu']:.1f}% of "
          f"989 TFLOP/s ({flops / 1e12:.1f} TFLOP per step), peak memory "
          f"{report['max_memory_gib']:.2f} GiB")
    print(f"[train] loss {[round(x, 4) for x in losses]} (warm-up step "
          f"{report['warmup_loss']:.4f}), grad norm {[round(x, 4) for x in norms]}, "
          f"launches per step {dict(zip(COUNTS, want))}")
    if profile:
        report["profile"] = profile_window(
            lambda: (step(state, tokens), torch.cuda.synchronize()),
            f"one {label} train step, b={batch} t={seq}")
    report["designs"] = dict(zip(KERNEL_NAMES, designs))
    del state, step, metrics
    torch.cuda.empty_cache()
    return report


def _train_tokens(cfg, batch: int, seq: int):
    gen = torch.Generator(device="cuda").manual_seed(3)
    return torch.randint(0, cfg.vocab_size, (batch, seq), device="cuda", generator=gen)


def phase_train(batch: int, seq: int, steps: int, profile: bool):
    from ray_tpu_torch.models import gpt

    report = {"gpt_nano_vs_cpu": train_small_vs_cpu()}
    cfg = gpt.gpt_1b(ce_chunk=512)  # bf16 compute, float32 params and moments
    report.update(run_train(cfg, _train_tokens(cfg, batch, seq), steps, 2,
                            "gpt_1b bf16 compute / f32 master", profile))
    return report


def phase_remat_policies(nothing, steps: int, profile: bool):
    """The dense train step of phase 4 under "attn" and "dots": the same
    batch, fresh seed-0 weights, so the warm-up step must reproduce phase
    4's loss bit for bit."""
    from ray_tpu_torch.models import gpt

    out = {}
    for policy, fwd_per_layer in (("attn", 1), ("dots", 2)):
        cfg = gpt.gpt_1b(ce_chunk=512, remat_policy=policy)
        tokens = _train_tokens(cfg, nothing["batch"], nothing["seq"])
        rep = run_train(cfg, tokens, steps, fwd_per_layer, "gpt_1b bf16 compute / f32 master",
                        profile)
        grad_rel = abs(rep["warmup_grad_norm"] / nothing["warmup_grad_norm"] - 1)
        print(f"[remat] '{policy}': warm-up loss {rep['warmup_loss']!r} vs 'nothing' "
              f"{nothing['warmup_loss']!r}, grad norm {rep['warmup_grad_norm']!r} vs "
              f"{nothing['warmup_grad_norm']!r} (rel {grad_rel:.2e}, limit "
              f"{POLICY_GRAD_NORM_RTOL}); {rep['ms_per_step']:.1f} ms per step "
              f"('nothing' {nothing['ms_per_step']:.1f}), peak {rep['max_memory_gib']:.2f} GiB "
              f"('nothing' {nothing['max_memory_gib']:.2f})")
        if rep["warmup_loss"] != nothing["warmup_loss"]:
            raise SystemExit(f"remat '{policy}' changed the first step's loss: "
                             f"{rep['warmup_loss']!r} vs {nothing['warmup_loss']!r}")
        if not grad_rel <= POLICY_GRAD_NORM_RTOL:
            raise SystemExit(f"remat '{policy}' changed the first step's grad norm by {grad_rel}")
        rep["warmup_grad_norm_rel_diff"] = grad_rel
        out[policy] = rep
    return out


def moe_executed_flops(cfg, batch: int, seq: int) -> float:
    """``train_step_flops`` with the expert products counted as executed:
    the formula counts every expert for every token (6 * 2 * d * f * E * s
    per layer), the step runs each expert over its C capacity slots
    (6 * 2 * d * f * E * C, empty slots included; E * C is about
    k * cf * s)."""
    from ray_tpu_torch.models import gpt, moe

    s = batch * seq
    n_exp = cfg.moe_num_experts
    cap = moe.expert_capacity(cfg, s)
    per_slot = 6.0 * 2 * cfg.embed_dim * cfg.mlp_dim
    return (gpt.train_step_flops(cfg, batch, seq)
            - cfg.num_layers * per_slot * n_exp * (s - cap))


def phase_train_moe(batch: int, seq: int, steps: int, profile: bool):
    from ray_tpu_torch.models import gpt

    cfg = gpt.gpt_1b(moe_num_experts=4, ce_chunk=512)
    rep = run_train(cfg, _train_tokens(cfg, batch, seq), steps, 2,
                    "gpt_1b MoE (4 experts, top 2, cf 1.25)", profile)
    executed = moe_executed_flops(cfg, batch, seq)
    rep.update(num_params=cfg.num_params(), experts=cfg.moe_num_experts,
               top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
               aux_weight=cfg.moe_aux_weight, executed_flops=executed,
               mfu_executed=executed / (rep["ms_per_step"] / 1e3) / PEAK_FLOPS[torch.bfloat16])
    print(f"[moe] {cfg.num_params() / 1e9:.3f} B parameters; MFU {100 * rep['mfu']:.1f}% by "
          f"train_step_flops (every expert for every token), {100 * rep['mfu_executed']:.1f}% "
          f"by the executed expert work ({executed / 1e12:.1f} TFLOP per step); aux "
          f"{[round(x, 4) for x in rep['moe_aux']]}, share of assignments dropped "
          f"{[round(x, 4) for x in rep['moe_dropped']]}")
    return rep


def phase_train_gpt_j(batch: int, seq: int, steps: int, profile: bool):
    """4e: gpt_j_6b as the reference's _aot_gpt_j_6b trains it (bf16
    compute, parameters and moments; ce_chunk 256, remat "nothing",
    default_optimizer(1e-4)) at full width and depth on one card: its
    attention runs the head_dim-256 kernels."""
    from ray_tpu_torch.models import gpt

    cfg = gpt.gpt_j_6b(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    rep = run_train(cfg, _train_tokens(cfg, batch, seq), steps, 2,
                    "gpt_j_6b bf16 parameters and moments", profile)
    rep.update(num_params=cfg.num_params(), num_layers=cfg.num_layers,
               head_dim=cfg.head_dim, embed_dim=cfg.embed_dim)
    print(f"[gpt_j] {cfg.num_params() / 1e9:.3f} B parameters, {cfg.num_layers} layers, "
          f"head_dim {cfg.head_dim}; state {rep['state_dtype']}")
    return rep


def phase_train_f32(batch: int, seq: int, steps: int, profile: bool):
    """4f: gpt_1b in float32 (parameters, compute and Adam moments; ce_chunk
    512, remat "nothing") at full width and depth: its attention runs the
    float32 designs, the forward and the backward on the 3xTF32 kernels
    (tf32x3)."""
    from ray_tpu_torch.models import gpt

    cfg = gpt.gpt_1b(dtype=torch.float32, ce_chunk=512)
    rep = run_train(cfg, _train_tokens(cfg, batch, seq), steps, 2,
                    "gpt_1b float32 (GEMMs on the CUDA cores)", profile,
                    designs=("tf32x3",) * 3)
    rep.update(dtype=str(cfg.dtype), num_params=cfg.num_params())
    flash = rep.get("profile", {}).get("groups_ms", {}).get("flash kernels")
    print(f"[train_f32] {cfg.num_params() / 1e9:.3f} B parameters, compute {cfg.dtype}, "
          f"state {rep['state_dtype']}; {rep['ms_per_step']:.1f} ms per step, "
          f"{rep['tokens_per_s']:.0f} tokens/s, peak {rep['max_memory_gib']:.2f} GiB"
          + ("" if flash is None else f"; flash kernels {flash:.1f} ms of device time a step"))
    return rep


def phase_train_nano_bf16(batch: int, seq: int, steps: int):
    """4g: gpt_nano in bf16 compute (float32 master weights and Adam
    moments, remat "nothing"), b=512, t=128: its attention runs the bf16
    head_dim-16 kernels, the forward on the persistent design (2 *
    num_layers = 4 launches a step) and dQ and dK/dV on persistent (2
    each).
    run_train's gates, with one more step under torch.profiler for the idle
    share; the warm-up step's loss within NANO_BF16_LOSS_RTOL of the same
    step on the CPU in float32 from the same weights and batch."""
    from ray_tpu_torch.models import gpt, inference, training

    # gpt_nano sets dtype itself (float32, as the reference's does)
    cfg = dataclasses.replace(gpt.gpt_nano(), dtype=torch.bfloat16)
    params0 = inference.init_params(cfg, device="cpu", seed=0)

    def build(cfg_, opt):
        state = training.init_train_state({n: p.to("cuda") for n, p in params0.items()}, opt)
        return state, training.make_train_step(cfg_, opt, device="cuda")

    tokens = _train_tokens(cfg, batch, seq)
    rep = run_train(cfg, tokens, steps, 2, "gpt_nano bf16 compute / f32 master", True,
                    build=build, designs=("persistent",) * 3)
    opt = training.default_optimizer(1e-4)
    cpu_state = training.init_train_state({n: p.clone() for n, p in params0.items()}, opt)
    cpu_step = training.make_train_step(gpt.gpt_nano(), opt, device="cpu")
    _, cpu_metrics = cpu_step(cpu_state, tokens.cpu())
    cpu_loss = float(cpu_metrics["loss"])
    rel = abs(rep["warmup_loss"] / cpu_loss - 1)
    rep.update(cpu_f32_warmup_loss=cpu_loss, warmup_loss_rel_diff=rel,
               loss_rtol=NANO_BF16_LOSS_RTOL, idle_share=rep["profile"]["idle_share"])
    print(f"[train_nano_bf16] warm-up loss {rep['warmup_loss']!r} on the card (bf16) vs "
          f"{cpu_loss!r} on the CPU (float32), rel {rel:.2e} (limit {NANO_BF16_LOSS_RTOL}); "
          f"{rep['ms_per_step']:.2f} ms per step, idle share {rep['idle_share']:.3f}")
    if not rel <= NANO_BF16_LOSS_RTOL:
        raise SystemExit(f"train_nano_bf16: the first loss differs from the CPU's float32 "
                         f"step by {rel}")
    return rep


# 4h: gpt_125m's warm-up loss and attention gradients in bf16 compute on the
# card vs the same step in float32 on the card from the same weights and
# batch (the float32 step runs the tf32x3 kernels, so the check does not
# lean on the d64 designs). The loss: bf16 rounds every activation, P and
# the GEMMs' inputs (2^-9 relative each, random in sign) through 12 layers,
# and the loss averages 32768 tokens' terms of ~ln(50304); at these random
# weights it is ~ln(vocab) whatever attention gives, so the loss alone
# cannot see a wrong kernel. The gradients of the q, k and v projections
# (x^T dq, x^T dk, x^T dv over the 12 layers, each kind's norm of the
# difference over the float32 step's norm) are what dQ and dK/dV move: on an
# H100 they read 1.6e-2 (q, k) and 8.8e-3 (v), bf16 rounding alone, and a
# wrong kernel moves them by order 1: dK and dV swapped reads 1.0, a zeroed
# dq 1.0 (the controls, computed from the same gradients, must fail the
# limit, which sits three times above the readings).
LOSS_125M_RTOL = 5e-3
ATTN_GRAD_125M_RTOL = 5e-2


def _attn_grads(cfg, params0, tokens):
    """(loss, {"q", "k", "v": the gradients of that projection's weight in
    every layer, flattened and joined, float32}, launches by counter) of one
    forward and backward of ``cfg`` on the card from ``params0``."""
    from ray_tpu_torch.models import gpt, training

    params = {n: p.to("cuda") for n, p in params0.items()}
    names = [n for n in params if re.fullmatch(r"blocks\.\d+\.attn\.[qkv]\.weight", n)]
    for n in names:
        params[n].requires_grad_(True)
    loss_fn = training._loss_fn(cfg, gpt.GPT(cfg, device="meta"))
    before = _launch_counts()
    with torch.enable_grad():
        loss, _ = loss_fn(params, tokens)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
    torch.cuda.synchronize()
    launched = dict(zip(COUNTS, (a - b for a, b in zip(_launch_counts(), before))))
    by_kind = {kind: torch.cat([g.float().flatten() for n, g in zip(names, grads)
                                if n.endswith(f".{kind}.weight")]) for kind in "qkv"}
    return float(loss.detach()), by_kind, {n: c for n, c in launched.items() if c}


def phase_train_125m(batch: int, seq: int, steps: int):
    """4h: gpt_125m (12 layers, 12 heads x 64, d_model 768, vocab 50304) at
    full width and depth in bf16 compute with float32 master weights and
    moments, remat "nothing", at bench.py's 125m cell (b=16, t=2048,
    ce_chunk 256): its attention runs the bf16 head_dim-64 kernels, the
    forward on the d64 design (2 * num_layers = 24 launches a step), dQ and
    dK/dV on d64 (12 each), none on wgmma or plain. run_train's gates, with
    one more step under torch.profiler for the idle share; the warm-up
    step's loss within LOSS_125M_RTOL of the same step in float32 on the card
    from the same weights and batch, and the gradients of the q, k and v
    projections of a bf16 forward and backward within ATTN_GRAD_125M_RTOL of
    the float32 one's, where the controls (dK and dV swapped, dq zeroed)
    fail it."""
    from ray_tpu_torch.models import gpt, inference, training

    cfg = gpt.gpt_125m()  # bf16 compute, float32 parameters and moments
    params0 = inference.init_params(cfg, device="cpu", seed=0)

    def build(cfg_, opt):
        state = training.init_train_state({n: p.to("cuda") for n, p in params0.items()}, opt)
        return state, training.make_train_step(cfg_, opt, device="cuda")

    tokens = _train_tokens(cfg, batch, seq)
    rep = run_train(cfg, tokens, steps, 2, "gpt_125m bf16 compute / f32 master", True,
                    build=build, designs=("d64", "d64", "d64"))
    layers = cfg.num_layers
    want = {"bf16": {"flash_fwd": 2 * layers, "flash_fwd_d64": 2 * layers,
                     "flash_bwd_dq": layers, "flash_bwd_dq_d64": layers,
                     "flash_bwd_dkv": layers, "flash_bwd_dkv_d64": layers},
            "float32": {"flash_fwd": 2 * layers, "flash_fwd_tf32x3": 2 * layers,
                        **{f"flash_bwd_{k}{s}": layers for k in ("dq", "dkv")
                           for s in ("", "_tf32x3")}}}
    grads, losses = {}, {}
    for name, cfg_ in (("bf16", cfg), ("float32", gpt.gpt_125m(dtype=torch.float32))):
        losses[name], grads[name], launched = _attn_grads(cfg_, params0, tokens)
        if launched != want[name]:
            raise SystemExit(f"train_125m: the {name} gradient pass launched {launched}, "
                             f"expected {want[name]}")
        torch.cuda.empty_cache()
    g16, g32 = grads["bf16"], grads["float32"]

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    grad_err = {kind: rel(g16[kind], g32[kind]) for kind in "qkv"}
    controls = {"dk and dv swapped": min(rel(g16["k"], g32["v"]), rel(g16["v"], g32["k"])),
                "dq zeroed": rel(torch.zeros_like(g32["q"]), g32["q"])}
    f32_loss = losses["float32"]
    rel_loss = abs(rep["warmup_loss"] / f32_loss - 1)
    flops = rep["train_step_flops"]
    rep.update(num_params=cfg.num_params(), f32_warmup_loss=f32_loss,
               warmup_loss_rel_diff=rel_loss, loss_rtol=LOSS_125M_RTOL,
               bf16_grad_pass_loss=losses["bf16"], attn_grad_rel_err=grad_err,
               attn_grad_rtol=ATTN_GRAD_125M_RTOL, attn_grad_controls=controls,
               idle_share=rep["profile"]["idle_share"])
    print(f"[train_125m] {cfg.num_params() / 1e6:.1f} M parameters, {cfg.num_layers} layers, "
          f"{cfg.num_heads} heads x {cfg.head_dim}; warm-up loss {rep['warmup_loss']!r} (bf16) "
          f"vs {f32_loss!r} (float32 on the card), rel {rel_loss:.2e} (limit {LOSS_125M_RTOL}); "
          f"q/k/v projection gradients vs float32 rel "
          f"{', '.join(f'{k} {v:.3e}' for k, v in grad_err.items())} (limit "
          f"{ATTN_GRAD_125M_RTOL}; controls "
          f"{', '.join(f'{k} {v:.3f}' for k, v in controls.items())}); "
          f"{rep['ms_per_step']:.1f} ms per step, {rep['tokens_per_s']:.0f} tokens/s, MFU "
          f"{100 * rep['mfu']:.1f}% of 989 TFLOP/s ({flops / 1e12:.2f} TFLOP a step), idle "
          f"share {rep['idle_share']:.3f}")
    if not rel_loss <= LOSS_125M_RTOL:
        raise SystemExit(f"train_125m: the first loss differs from the float32 step by "
                         f"{rel_loss}")
    if not all(e <= ATTN_GRAD_125M_RTOL for e in grad_err.values()):
        raise SystemExit(f"train_125m: the attention projections' gradients differ from the "
                         f"float32 step's by {grad_err}")
    if not all(c > ATTN_GRAD_125M_RTOL for c in controls.values()):
        raise SystemExit(f"train_125m: a control passes the gradient limit: {controls}")
    return rep


def phase_plain_design():
    """3b: what the reference computes beyond the kernels' first inputs, on
    the card, once each, causal, through dot_product_attention with a
    backward: the plain design at head_dim 48 in bf16 and 16 in float16 (the
    reference's XLA route), and the kernels at head_dim 64 in float16 and in
    bf16 at a negative scale (the forward's sign handed to q), at 384, 512,
    640 and 768 in bf16 and in float32 (the dcluster128 forward, dQ and
    dK/dV: this slice's path) and at 896 in bf16 and
    float32 (the tables' rule: the forward's and the backward's dcluster),
    every count set to 0 before each case. Out and dq, dk, dv held to the CPU's
    (ops/tolerance.py's limits for the dtype, row by row): the plain
    design's to the same function on the CPU, the kernels' to their plain
    backward on the CPU from the card's out (in float64 for float32; the
    backward reads out through delta, where a row with few keys cancels, so
    the forward kernel's rounding of P moves such a row's dq by more than
    the backward's own), and the
    counters of the case's designs risen by exactly one forward and one
    launch of each backward kernel, none of any other design."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops.tolerance import BWD_TOL, FWD_ROW_TOL, row_err

    rows = []
    gen = torch.Generator().manual_seed(9)
    d64 = ("d64",) * 3
    d896 = ("dcluster",) * 3
    for name, shape, dtype, scale, designs in (
            ("plain_d48_bf16", (2, 12, 256, 256, 48), torch.bfloat16, None, ("plain",) * 3),
            ("plain_d16_f16", (2, 12, 256, 256, 16), torch.float16, None, ("plain",) * 3),
            ("kernels_d64_f16", (2, 12, 256, 256, 64), torch.float16, None, d64),
            ("kernels_d64_scale_neg", (2, 12, 256, 256, 64), torch.bfloat16, -0.125, d64),
            *[(f"kernels_d{d}_bf16", (2, 4, 256, 256, d), torch.bfloat16, None,
               ("dcluster128",) * 3) for d in WIDE_D],
            *[(f"kernels_d{d}_f32", (1, 2, 256, 256, d), torch.float32, None,
               ("dcluster128",) * 3) for d in WIDE_D],
            ("kernels_d896_bf16", (1, 2, 256, 256, 896), torch.bfloat16, None, d896),
            ("kernels_d896_f32", (1, 2, 256, 256, 896), torch.float32, None, d896)):
        b, h, t_q, t_kv, d = shape
        cpu = [torch.randn(b, h, t, d, generator=gen).to(dtype).requires_grad_()
               for t in (t_q, t_kv, t_kv)]
        g = torch.randn(b, h, t_q, d, generator=gen).to(dtype)
        dev = [x.detach().cuda().requires_grad_() for x in cpu]
        _reset_launch_counts()
        before = _launch_counts()
        out = attn.dot_product_attention(*dev, causal=True, scale=scale)
        out.backward(g.cuda())
        torch.cuda.synchronize()
        launched = dict(zip(COUNTS, (a - c for a, c in zip(_launch_counts(), before))))
        want = {n: 1 for n in ("flash_fwd", f"flash_fwd_{designs[0]}", "flash_bwd_dq",
                               f"flash_bwd_dq_{designs[1]}", "flash_bwd_dkv",
                               f"flash_bwd_dkv_{designs[2]}")}
        for kernel, design in zip(KERNEL_NAMES, designs):
            want.update(_by_head_dim(kernel, design, d))
        out_cpu = attn.dot_product_attention(*cpu, causal=True, scale=scale)
        out_cpu.backward(g)
        ref_grads = [x.grad for x in cpu]
        if designs != ("plain",) * 3:
            # the kernels' plain backward from the card's out; in float64
            # for float32 (the plain version's own float32 rounding reads
            # 1e-4-scale on the first causal rows from 384 up)
            exact = torch.float64 if dtype == torch.float32 else dtype
            qkv = [x.detach().to(exact) for x in cpu]
            s = d ** -0.5 if scale is None else scale
            _, lse = attn.flash_attention_fwd_plain(*qkv, causal=True, scale=s)
            ref_grads = attn.flash_attention_bwd_plain(*qkv, out.detach().cpu().to(exact), lse,
                                                       g.to(exact), causal=True, scale=s)
        errs = {"out": row_err(out.detach().cpu(), out_cpu.detach()),
                **{n: row_err(x.grad.cpu(), y) for n, x, y in zip(("dq", "dk", "dv"),
                                                                  dev, ref_grads)}}
        ok = (errs["out"] <= FWD_ROW_TOL[dtype]
              and all(errs[n] <= BWD_TOL[dtype] for n in ("dq", "dk", "dv"))
              and {n: c for n, c in launched.items() if c} == want)
        print(f"[plain] {name} {list(shape)} {str(dtype).replace('torch.', '')} scale "
              f"{scale}, designs {'/'.join(designs)}: worst-row "
              f"err vs the CPU {', '.join(f'{k} {v:.2e}' for k, v in errs.items())} (limits "
              f"{FWD_ROW_TOL[dtype]:.0e} / {BWD_TOL[dtype]:.0e}); launched "
              f"{ {n: c for n, c in launched.items() if c} } {'ok' if ok else 'FAIL'}")
        rows.append(dict(case=name, shape=list(shape), dtype=str(dtype), scale=scale,
                         designs=list(designs), row_err=errs,
                         launches={n: c for n, c in launched.items() if c}, ok=ok))
        if not ok:
            raise SystemExit(f"3b: {name} disagrees with the CPU or launched "
                             f"{launched}, expected {want}")
    return rows


def phase_forward(cfg, params, batch: int, seq: int, n_forward: int):
    from ray_tpu_torch.models.inference import make_forward

    fwd = make_forward(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), device="cuda", generator=gen)
    logits = fwd(params, tokens)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.monotonic()
    for _ in range(n_forward):
        logits = fwd(params, tokens)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    counts = dict(zip(COUNTS, _launch_counts()))
    launches = counts["flash_fwd"]
    want = n_forward * cfg.num_layers
    if launches != want or counts["flash_fwd_wgmma"] != want or counts["flash_fwd_plain"]:
        raise SystemExit(f"flash forward launched {counts}, expected {want}, all on "
                         f"the wgmma design")
    if tuple(logits.shape) != (batch, seq, cfg.vocab_size) or logits.dtype != torch.float32:
        raise SystemExit(f"forward returned {tuple(logits.shape)} {logits.dtype}")
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit("forward logits are not finite")
    tok_s = batch * seq * n_forward / seconds
    ms = seconds / n_forward * 1e3
    print(f"[forward] gpt_1b bf16 b={batch} t={seq}: {ms:.1f} ms per forward, "
          f"{tok_s:.0f} tokens/s, flash launches {launches}, on wgmma "
          f"{counts['flash_fwd_wgmma']} ({cfg.num_layers} per forward)")
    return fwd, dict(batch=batch, seq=seq, n_forward=n_forward, ms_per_forward=ms,
                     tokens_per_s=tok_s, launches=counts,
                     max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


# 5b(b): layer 0's attention output (the o projection's input, every head's
# row of d held to its own norm) under attn_use_pallas=False against the
# flash route's from the same weights and tokens: the plain route's bf16 P
# against the kernel's, the forward's bf16 row limit (ops/tolerance.py). The
# tokens are random: entry()'s zeros give every position the same V, which
# any weights over the keys return exactly
def phase_entry_config(smi: str, train_nothing):
    """5b: the reference's entry and configuration surface on the card, every
    count set to 0 first. (a) ``ray_tpu_torch.entry.entry()`` (gpt_1b, bf16
    parameters, b=1, t=512): a warm-up, then 5 timed forwards of 16 wgmma
    launches each and none on plain, the logits finite, and one more under
    torch.profiler (device time by kernel, idle share); (b) the same
    parameters with ``attn_use_pallas=False`` on random tokens: 16 plain
    forward launches and no kernel launch, layer 0's attention output
    within the bf16 row limit of the flash route's on the same tokens, the
    logits' largest difference printed; (c) bench.py's gpt_1b
    cell (``attn_block_q = attn_block_k = 1024``, ``ce_chunk`` 512,
    ``scan_layers=False``, bf16 parameters and moments, b=12, t=2048):
    ``run_train``'s gates over a warm-up and 3 steps (32 / 16 / 16 wgmma
    launches a step, none on plain, the loss falling, the state bf16); (d)
    a causal call with t_q > t_kv at 1024 x 1024 tiles raises, launching
    nothing."""
    import dataclasses

    from torch.func import functional_call

    from ray_tpu_torch import entry
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models.inference import make_forward
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops.tolerance import FWD_ROW_TOL, row_err

    print(f"[entry] {smi}")
    _reset_launch_counts()
    fn, (params, tokens) = entry.entry()
    cfg = entry.flagship_config()
    n_forward = 5
    logits = fn(params, tokens)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.monotonic()
    for _ in range(n_forward):
        logits = fn(params, tokens)
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) / n_forward * 1e3
    counts = dict(zip(COUNTS, _launch_counts()))
    want = {"flash_fwd": 16 * n_forward, "flash_fwd_wgmma": 16 * n_forward}
    if {n: c for n, c in counts.items() if c} != want:
        raise SystemExit(f"5b(a): entry() launched {counts}, expected {want}")
    if (tuple(logits.shape) != (1, 512, cfg.vocab_size) or logits.dtype != torch.float32
            or not bool(torch.isfinite(logits).all())):
        raise SystemExit(f"5b(a): entry() gave {tuple(logits.shape)} {logits.dtype}, finite "
                         f"{bool(torch.isfinite(logits).all())}")
    profile = profile_window(lambda: (fn(params, tokens), torch.cuda.synchronize()),
                             "one entry() forward, gpt_1b bf16, b=1 t=512")
    forward = dict(batch=1, seq=512, n_forward=n_forward, ms_per_forward=ms,
                   tokens_per_s=512 / (ms / 1e3), launches=counts, profile=profile)
    print(f"[entry] (a) entry(): gpt_1b bf16 parameters, b=1 t=512, {ms:.2f} ms per forward, "
          f"{forward['tokens_per_s']:.0f} tokens/s, idle share {profile['idle_share']:.3f} "
          f"(profiled); launches {want} ({smi})")

    plain_cfg = dataclasses.replace(cfg, attn_use_pallas=False)
    gen = torch.Generator(device="cuda").manual_seed(12)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), device="cuda", generator=gen)
    logits = fn(params, tokens)
    _reset_launch_counts()
    plain_logits = make_forward(plain_cfg, "cuda")(params, tokens)
    torch.cuda.synchronize()
    counts = {n: c for n, c in zip(COUNTS, _launch_counts()) if c}
    if counts != {"flash_fwd": 16, "flash_fwd_plain": 16}:
        raise SystemExit(f"5b(b): attn_use_pallas=False launched {counts}, expected 16 on "
                         f"plain and no kernel")

    def layer0_attention(c):
        model = gpt.GPT(c, device="meta")
        got = []
        model.blocks[0].attn.o.register_forward_pre_hook(
            lambda mod, args: got.append(args[0].detach().clone()))
        with torch.inference_mode():
            functional_call(model, params, (tokens,))
        return got[0].view(1, 512, c.num_heads, c.head_dim)

    layer0_err = row_err(layer0_attention(plain_cfg), layer0_attention(cfg))
    logits_diff = float((plain_logits - logits).abs().max())
    tol = FWD_ROW_TOL[torch.bfloat16]
    print(f"[entry] (b) attn_use_pallas=False: plain launches {counts}; layer 0's attention "
          f"output worst-row err vs the flash route {layer0_err:.2e} (limit {tol:.0e}); logits' "
          f"largest difference {logits_diff:.4f} (not gated) ({smi})")
    if not layer0_err <= tol:
        raise SystemExit(f"5b(b): layer 0's attention output differs from the flash route's "
                         f"by {layer0_err}")
    plain = dict(launches=counts, layer0_row_err=layer0_err, row_err_tol=tol,
                 logits_max_abs_diff=logits_diff)
    del fn, params, tokens, logits, plain_logits
    torch.cuda.empty_cache()

    bench_cfg = gpt.gpt_1b(dtype=torch.bfloat16, param_dtype=torch.bfloat16, attn_block_q=1024,
                           attn_block_k=1024, ce_chunk=512, scan_layers=False)
    _reset_launch_counts()
    train = run_train(bench_cfg, _train_tokens(bench_cfg, 12, 2048), 3, 2,
                      "bench.py's gpt_1b (bf16 parameters and moments, 1024 x 1024 tiles "
                      "asked, scan_layers=False)", profile=False)
    train.update(attn_block_q=bench_cfg.attn_block_q, attn_block_k=bench_cfg.attn_block_k,
                 scan_layers=bench_cfg.scan_layers, phase4_ms_per_step=train_nothing["ms_per_step"])
    print(f"[entry] (c) bench.py's gpt_1b: {train['ms_per_step']:.1f} ms per step, peak "
          f"{train['max_memory_gib']:.2f} GiB; phase 4's f32-master step in this run "
          f"{train_nothing['ms_per_step']:.1f} ms ({smi})")

    gen.manual_seed(11)
    q = torch.randn(1, 2, 160, 128, device="cuda", dtype=torch.bfloat16, generator=gen)
    k, v = (torch.randn(1, 2, 64, 128, device="cuda", dtype=torch.bfloat16, generator=gen)
            for _ in range(2))
    _reset_launch_counts()
    try:
        attn.dot_product_attention(q, k, v, causal=True, block_q=1024, block_k=1024)
    except ValueError as e:
        refusal = str(e)
    else:
        raise SystemExit("5b(d): a causal call with t_q > t_kv at 1024 x 1024 tiles ran")
    if any(_launch_counts()):
        raise SystemExit("5b(d): the refused call launched a kernel")
    print(f"[entry] (d) refused: {refusal}")
    return dict(card=smi, forward=forward, plain_route=plain, train=train, refusal=refusal)


def profile_window(fn, label: str):
    """Device time by kernel over one call of ``fn`` (which must end in a
    synchronize), the device's busy time and its idle share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        wall_ms = (time.monotonic() - t0) * 1e3
    return profile_report(prof, wall_ms, label)


def profile_report(prof, wall_ms: float, label: str):
    """The breakdown of ``profile_window`` from a stopped profiler that
    covered ``wall_ms`` of wall time."""
    from torch.autograd import DeviceType
    # the port's record_function ranges also show as device events: they are
    # spans over kernels, not kernels, and are read apart below
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and e.key not in RANGES]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = [dict(name=e.key[:100], ms=e.self_device_time_total / 1e3, calls=e.count)
           for e in kernels[:12]]
    groups = {}
    for e in kernels:
        groups[_kernel_group(e.key)] = (groups.get(_kernel_group(e.key), 0.0)
                                        + e.self_device_time_total / 1e3)
    idle = max(0.0, 1.0 - busy_ms / wall_ms)
    # device time by operator: each kernel counts for the operator that
    # launched it (aten::bmm holds the expert products, forward and backward)
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0
           and e.key not in RANGES
           and not e.key.startswith(("autograd::", "ProfilerStep", "Command Buffer Full"))]
    ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    by_op = [dict(name=e.key, ms=e.self_device_time_total / 1e3, calls=e.count)
             for e in ops[:12]]
    # torch.profiler.record_function ranges of the port: the backward's delta
    # pass (ops/attention.py) and the MoE layer's parts (models/moe.py),
    # forward and recompute
    ranges = {e.key: dict(device_ms=e.device_time_total / 1e3, calls=e.count)
              for e in prof.key_averages() if e.key in RANGES}
    print(f"[profile] {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle share {idle:.3f}; by group: "
          + ", ".join(f"{g} {ms:.1f} ms" for g, ms in sorted(groups.items(),
                                                            key=lambda x: -x[1]))
          + "; by kernel:")
    for t in top:
        print(f"[profile]   {t['ms']:9.3f} ms  x{t['calls']:<5} {t['name']}")
    print("[profile] by operator:")
    for t in by_op:
        print(f"[profile]   {t['ms']:9.3f} ms  x{t['calls']:<5} {t['name']}")
    for name, r in ranges.items():
        print(f"[profile]   range {name}: {r['device_ms']:.3f} ms of device time "
              f"over {r['calls']} calls")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=idle, top=top,
                groups_ms=groups, by_op=by_op, ranges=ranges,
                flash_bwd_delta=ranges.get("flash_bwd_delta"))


#: the serving engine's metrics (the reference's names), by the sink's table
SERVER_METRICS = (("observations", "ray_tpu_llm_ttft_seconds"),
                  ("counters", "ray_tpu_llm_prefill_tokens_total"),
                  ("counters", "ray_tpu_llm_prefix_cache_hits_total"),
                  ("gauges", "ray_tpu_llm_kv_blocks_in_use"))

RANGES = ("flash_bwd_delta", "moe_router", "moe_dispatch", "moe_experts", "moe_combine")


def _kernel_group(name: str) -> str:
    """The profile's coarse groups: the port's kernels, cuBLAS GEMMs, the
    optimizer's multi-tensor (foreach) kernels, and everything else
    (elementwise, copies, reductions)."""
    if "flash_" in name:
        return "flash kernels"
    if name.startswith(("nvjet", "sm90_", "cutlass")) or "gemm" in name.lower():
        return "GEMM"
    if "multi_tensor_apply" in name:
        return "foreach"
    return "other"


def phase_server(cfg, params, fwd, profile: bool):
    from ray_tpu_torch.runtime import RecordingMetrics, RuntimeHooks
    from ray_tpu_torch.serve import llm

    sink = RecordingMetrics()
    srv = llm.LLMServer(
        cfg, params=params, device="cuda", num_blocks=1024, block_size=16,
        prefill_chunk=256, prefill_lanes=4, lane_buckets=(1, 2, 4, 8),
        prefill_token_buckets=(64, 128, 256),
        cache_buckets=(256, 512, 1024, 2048), max_adapters=2,
        hooks=RuntimeHooks(metrics=sink), deployment="smoke",
    )
    tags = {"deployment": "smoke"}

    def metric(kind, name):
        # a copy: the sink appends to its lists of observations in place
        value = getattr(sink, kind).get(sink.key(name, tags), 0.0)
        return list(value) if kind == "observations" else value
    rng = np.random.RandomState(2)

    def prompt(n):
        return [int(t) for t in rng.randint(0, cfg.vocab_size, n)]

    try:
        llm.register_lora("lora:smoke", llm.random_lora(cfg, rank=8, seed=1, scale=2.0))
        srv({"prompt": prompt(100), "max_new_tokens": 4})  # warm-up
        _reset_launch_counts()
        shared = prompt(512)
        payloads = [{"prompt": shared + prompt(n), "max_new_tokens": 32}
                    for n in (100, 200, 300, 400)]
        payloads += [{"prompt": prompt(n), "max_new_tokens": 32}
                     for n in (200, 450, 700, 1000)]
        payloads[-1]["model_id"] = "lora:smoke"

        def concurrently(batch):
            results = [None] * len(batch)

            def call(i):
                results[i] = srv(batch[i])

            threads = [threading.Thread(target=call, args=(i,)) for i in range(len(batch))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
                if t.is_alive():
                    raise SystemExit("a server request did not finish in 600 s")
            return results

        stats0 = srv.kv_stats()
        sink0 = {name: metric(kind, name) for kind, name in SERVER_METRICS}
        t0 = time.monotonic()
        # the first shared-prefix request fills the prefix cache
        results = [srv(payloads[0])] + concurrently(payloads[1:])
        seconds = time.monotonic() - t0
        stats1 = srv.kv_stats()
        sink1 = {name: metric(kind, name) for kind, name in SERVER_METRICS}
        if any(r is None or len(r["tokens"]) != 32 for r in results):
            raise SystemExit("not every request finished with 32 tokens")
        hits = stats1["prefix_hits"] - stats0["prefix_hits"]
        if hits <= 0 or any(r["prefix_cached_tokens"] < 512 for r in results[1:4]):
            raise SystemExit(f"prefix cache did not hit: {[r['prefix_cached_tokens'] for r in results]}")
        gen_tokens = sum(len(r["tokens"]) for r in results)
        prompt_tokens = sum(len(p["prompt"]) for p in payloads)
        ttft = np.array([r["ttft_s"] for r in results]) * 1e3

        # bitwise: one prompt, uncached then cached (prefix reuse ends on
        # the first prefill chunk's boundary, so both runs see equal shapes)
        p = prompt(264)
        r1 = srv({"prompt": p, "max_new_tokens": 8, "return_logits": True})
        r2 = srv({"prompt": p, "max_new_tokens": 8, "return_logits": True})
        if r1["prefix_cached_tokens"] != 0 or r2["prefix_cached_tokens"] != 256:
            raise SystemExit(f"unexpected prefix reuse {r1['prefix_cached_tokens']} "
                             f"{r2['prefix_cached_tokens']}")
        bitwise = r1["tokens"] == r2["tokens"] and np.array_equal(r1["logits"], r2["logits"])
        if not bitwise:
            raise SystemExit("cached decode is not bitwise equal to uncached decode")
        server_launches = dict(zip(COUNTS, _launch_counts()))

        # engine prefill vs the full forward at the last prompt position
        full = fwd(params, torch.tensor([p], device="cuda"))[0, -1].float().cpu().numpy()
        diff = float(np.abs(r1["logits"][0] - full).max())
        if not diff <= ENGINE_VS_FORWARD_ATOL:
            raise SystemExit(f"engine prefill vs forward logits differ by {diff}")

        prof = None
        if profile:
            fresh = [{"prompt": prompt(n), "max_new_tokens": 32} for n in (300, 300, 600, 600)]
            prof = profile_window(
                lambda: (concurrently(fresh), torch.cuda.synchronize()),
                "server, 4 concurrent requests (prompts 300-600, 32 new tokens)")

        srv._engine.prefix.clear()
        in_use = srv.kv_stats()["kv_blocks_in_use"]
        if in_use != 0:
            raise SystemExit(f"{in_use} KV blocks leaked")
        # the engine's metrics through the hooks' sink, over the 8 requests
        ttft_obs = len(sink1["ray_tpu_llm_ttft_seconds"]) - len(sink0["ray_tpu_llm_ttft_seconds"])
        prefill_sink = (sink1["ray_tpu_llm_prefill_tokens_total"]
                        - sink0["ray_tpu_llm_prefill_tokens_total"])
        hits_sink = (sink1["ray_tpu_llm_prefix_cache_hits_total"]
                     - sink0["ray_tpu_llm_prefix_cache_hits_total"])
        gauge_last = metric("gauges", "ray_tpu_llm_kv_blocks_in_use")
        sink_report = dict(
            ttft_observations=ttft_obs,
            prefill_tokens_total=prefill_sink,
            engine_prefill_tokens=stats1["prefill_tokens"] - stats0["prefill_tokens"],
            prefix_cache_hits_total=hits_sink, kv_stats_prefix_hits=hits,
            kv_blocks_in_use_last=gauge_last)
        print(f"[server] metrics sink over the 8 requests: {sink_report}")
        if (ttft_obs != len(payloads) or prefill_sink != sink_report["engine_prefill_tokens"]
                or hits_sink != hits or gauge_last != 0):
            raise SystemExit(f"the server's metrics disagree with the engine: {sink_report}")
        st = {k: stats1[k] - stats0[k]
              for k in ("prefill_seconds", "decode_seconds", "steps")}
        out = dict(
            requests=len(payloads), seconds=seconds, generated_tokens=gen_tokens,
            prompt_tokens=prompt_tokens, tokens_per_s=gen_tokens / seconds,
            ttft_p50_ms=float(np.percentile(ttft, 50)),
            ttft_p99_ms=float(np.percentile(ttft, 99)),
            ttft_ms=ttft.tolist(), prefix_hit_blocks=hits,
            prefix_cached_tokens=[r["prefix_cached_tokens"] for r in results],
            bitwise_cached_vs_uncached=bitwise, engine_vs_forward_max_abs=diff,
            engine_vs_forward_atol=ENGINE_VS_FORWARD_ATOL,
            kv_blocks_in_use_after=in_use, launches=server_launches,
            prefill_seconds=st["prefill_seconds"], decode_seconds=st["decode_seconds"],
            steps=st["steps"], metrics_sink=sink_report,
        )
        print(f"[server] {len(payloads)} requests, {prompt_tokens} prompt + {gen_tokens} "
              f"generated tokens in {seconds:.2f} s: {out['tokens_per_s']:.1f} tokens/s, "
              f"TTFT p50 {out['ttft_p50_ms']:.1f} ms p99 {out['ttft_p99_ms']:.1f} ms")
        print(f"[server] prefix hit blocks {hits}, cached tokens {out['prefix_cached_tokens']}, "
              f"bitwise cached==uncached {bitwise}, engine vs forward max |d| {diff:.4f} "
              f"(atol {ENGINE_VS_FORWARD_ATOL}), KV blocks in use after {in_use}, "
              f"engine time prefill {st['prefill_seconds']:.2f} s decode "
              f"{st['decode_seconds']:.2f} s over {st['steps']} steps (the 8 requests)")
        if prof is not None:
            out["profile"] = prof
        return out
    finally:
        srv.close()


def phase_lse_grad():
    """7a: flash_attention_with_lse, forward and backward under random
    cotangents of both outputs, at gpt_1b's heads (b=2, h=16, t=2048,
    d=128) in bf16 (the wgmma kernels) and float32 (tf32x3 forward and
    backward), at gpt_j_6b's (d=256) in bf16 (the wgmma split dK/dV
    kernel), at d=512 in bf16 (the dcluster128 forward and backward) and
    at d=1024 in bf16 with 8 heads (the dcluster forward and backward:
    this slice's path, every count set to 0 before it and read after, none
    on plain),
    causal and not. Two gates on
    every row of dq, dk and dv:
    - against the plain flash versions on the same inputs (the forward's
      out and lse feed both backwards, as in phase 3): the kernels'
      arithmetic;
    - against autograd through the plain attention_with_lse in float32 on
      the same inputs, with the lse cotangent dlse + rowsum(dO * (O32 -
      out)): delta is rowsum(dO * out) with the kernel's out, rounded to
      the input dtype as in every flash backward (the reference's too), so
      the kernels compute the exact gradient for that cotangent. This gate
      sees the delta - dlse route itself: without dlse, or with its sign
      turned, dq's worst row reads 0.26-2 at a small size, against ~2e-3.
    The worst rows against autograd under the given cotangents are
    printed beside those of FlashAttention's out-only backward against
    autograd: the first causal rows' dq moves by the same rounding of out
    in delta on both paths (not gated)."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops.tolerance import BWD_TOL, FWD_LSE_TOL, FWD_ROW_TOL, row_err

    b, t = 2, 2048
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for d, dtype, h in ((128, torch.bfloat16, 16), (128, torch.float32, 16),
                        (256, torch.bfloat16, 16), (512, torch.bfloat16, 16),
                        (1024, torch.bfloat16, 8)):
        scale = 1.0 / d ** 0.5
        design = attn.BWD_DESIGNS[(d, dtype)]
        for causal in (True, False):
            q, k, v, do = (torch.randn(b, h, t, d, device="cuda", dtype=dtype, generator=gen)
                           for _ in range(4))
            dlse = torch.randn(b, h, t, device="cuda", generator=gen)

            def kernel_path():
                xs = [x.detach().requires_grad_() for x in (q, k, v)]
                out, lse = attn.flash_attention_with_lse(*xs, causal, scale)
                grads = torch.autograd.grad((out, lse), xs, (do, dlse))
                return (out.detach(), lse.detach()) + grads

            def plain_flash(out, lse):
                ref = attn.flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
                return ref + attn.flash_attention_bwd_plain(
                    q, k, v, out, lse, do, causal=causal, scale=scale, dlse=dlse)

            def autograd_plain(out=None, with_lse=True):
                """(out, lse, dq, dk, dv) of autograd through the float32
                attention_with_lse; with ``out``, the lse cotangent takes
                the rounding of ``out`` in delta."""
                xs = [x.detach().float().requires_grad_() for x in (q, k, v)]
                o32, lse = attn.attention_with_lse(*xs, causal=causal, scale=scale)
                dl = dlse if with_lse else torch.zeros_like(dlse)
                if out is not None:
                    dl = dl + (do.float() * (o32.detach() - out.float())).sum(-1)
                grads = torch.autograd.grad((o32, lse), xs, (do.float(), dl))
                return (o32.detach(), lse.detach()) + grads

            def flash_out_only():
                xs = [x.detach().requires_grad_() for x in (q, k, v)]
                out = attn.FlashAttention.apply(*xs, causal, scale, None, None)[0]
                return torch.autograd.grad(out, xs, do)

            def grad_errs(got, want):
                return {name: row_err(x, ref) for name, x, ref in
                        zip(("dq", "dk", "dv"), got, want)}

            _reset_launch_counts()
            got = kernel_path()
            launched = dict(zip(COUNTS, _launch_counts()))
            expect = {f"flash_fwd_{attn.FWD_DESIGNS[(d, dtype)].name}": 1,
                      f"flash_bwd_dq_{design.dq.name}": 1,
                      f"flash_bwd_dkv_{design.dkv.name}": 1,
                      **{f"{kernel}_plain": 0 for kernel in KERNEL_NAMES}}
            if any(launched[name] != n for name, n in expect.items()):
                raise SystemExit(f"lse_grad: launched {launched}, expected {expect}")
            want = plain_flash(got[0], got[1])
            errs = {"out": row_err(got[0], want[0]), **grad_errs(got[2:], want[2:])}
            lse_err = float((got[1] - want[1]).abs().max())
            exact_errs = grad_errs(got[2:], autograd_plain(got[0])[2:])
            raw_errs = grad_errs(got[2:], autograd_plain()[2:])
            out_only_errs = grad_errs(flash_out_only(), autograd_plain(with_lse=False)[2:])
            torch.cuda.synchronize()
            ok = (errs["out"] <= FWD_ROW_TOL[dtype] and lse_err <= FWD_LSE_TOL[dtype]
                  and all(e[n] <= BWD_TOL[dtype] for e in (errs, exact_errs)
                          for n in ("dq", "dk", "dv"))
                  and all(bool(torch.isfinite(x).all()) for x in got))
            del got, want
            ms = cuda_ms(kernel_path, iters=10)
            flash_ms = cuda_ms(flash_out_only, iters=10)
            plain_ms = cuda_ms(autograd_plain, iters=3, warmup=1)
            name = f"lse_grad_d{d}_{str(dtype)[6:]}_{'causal' if causal else 'full'}"
            row = dict(case=name, shape=[b, h, t, t, d], causal=causal,
                       dtype=str(dtype)[6:],
                       design={"dq": design.dq.name, "dkv": design.dkv.name}, row_err=errs,
                       row_err_vs_exact_route=exact_errs,
                       row_err_vs_autograd_not_gated=raw_errs,
                       flash_out_only_row_err_vs_autograd_not_gated=out_only_errs,
                       lse_max_abs_err=lse_err,
                       row_err_tol={"out": FWD_ROW_TOL[dtype], "grads": BWD_TOL[dtype]},
                       lse_tol=FWD_LSE_TOL[dtype], ok=ok, ms=ms, plain_ms=plain_ms,
                       flash_attention_ms=flash_ms,
                       launches={n: c for n, c in launched.items() if c})
            rows.append(row)

            def fmt(e):
                return " ".join(f"{n} {e[n]:.2e}" for n in ("dq", "dk", "dv"))

            print(f"[lse_grad] {name:<24} {row['shape']} {row['design']}: worst-row err vs plain "
                  f"flash out {errs['out']:.2e} {fmt(errs)}, vs autograd (delta's rounding "
                  f"in the lse cotangent) {fmt(exact_errs)} (limits {FWD_ROW_TOL[dtype]:.0e}"
                  f" / {BWD_TOL[dtype]:.0e}), lse {lse_err:.2e} (limit "
                  f"{FWD_LSE_TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}; not gated: vs "
                  f"autograd {fmt(raw_errs)}, FlashAttention out only vs autograd "
                  f"{fmt(out_only_errs)} | forward + backward: with lse {ms:.4f} ms, "
                  f"FlashAttention (out only) {flash_ms:.4f} ms, autograd through the plain "
                  f"float32 attention_with_lse {plain_ms:.3f} ms")
    bad = [(r["case"], r["row_err"], r["row_err_vs_exact_route"], r["lse_max_abs_err"])
           for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"flash_attention_with_lse disagrees with its reference: {bad}")
    return rows


class _Lazy:
    """Stand-in for the object store's lazy buffer: ``nbytes`` and the
    write into the destination."""

    def __init__(self, nbytes, write):
        self.nbytes, self.write = nbytes, write


class _Arena:
    """Stand-in for the object store's serialize scope and its reserved
    region: lazy buffers collected while ``active``, then written into one
    host arena (64-byte aligned slices) and read back by index
    (``_arena_view``, while the arena is ``current``)."""

    current = None

    def __init__(self):
        self.active, self.buffers, self.views, self.host = False, [], [], None

    def scope_active(self):
        return self.active

    def append(self, buf):
        self.buffers.append(buf)
        return len(self.buffers) - 1

    def allocate(self):
        offsets, total = [], 0
        for b in self.buffers:
            offsets.append(total)
            total += (b.nbytes + 63) // 64 * 64
        self.host = torch.empty(total, dtype=torch.uint8)
        self.views = [memoryview(self.host[o:o + b.nbytes].numpy())
                      for o, b in zip(offsets, self.buffers)]



def _arena_view(index):
    """The stand-in's get_indexed_buffer: a module-level function, pickled
    by reference as the runtime's is."""
    return _Arena.current.views[index]


def pcie_bound_gbps():
    """The link's rate a direction: generation and width from nvidia-smi,
    else from the kernel's PCI sysfs entry of the card (nvidia-smi may read
    them as N/A in a container), else the H100 SXM5 data sheet's
    PCIe gen 5 x16. 128b/130b coding from gen 3 on."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.current,pcie.link.width.current,pci.bus_id",
         "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout
    gen, width, bus = (x.strip() for x in out.strip().splitlines()[0].split(","))
    per_lane = {"1": 2.5, "2": 5.0, "3": 8.0, "4": 16.0, "5": 32.0}
    if gen in per_lane and width.isdigit():
        source, gts, lanes = "nvidia-smi", per_lane[gen], int(width)
    else:
        dev = os.path.join("/sys/bus/pci/devices", bus.lower()[-12:])
        try:
            with open(os.path.join(dev, "current_link_speed")) as f:
                gts = float(f.read().split()[0])
            with open(os.path.join(dev, "current_link_width")) as f:
                lanes = int(f.read().strip())
            source = "sysfs"
        except (OSError, ValueError):
            source, gts, lanes = "H100 SXM5 data sheet (PCIe gen 5 x16)", 32.0, 16
    return dict(source=source, gt_per_s=gts, width=lanes,
                gbps=gts * lanes * (128 / 130 if gts >= 8 else 0.8) / 8)


def phase_device_plane(params):
    """8a: gpt_1b's bf16 parameters through the port's reducer
    (``_private.device_plane``) into a stand-in object store: inside the
    stand-in serialize scope every tensor becomes a lazy buffer, the lazy
    writers fill one host arena (the device->host copies), and the pickle
    rebuilds every tensor on the card from its arena slice (host->device).
    Three destinations, each a full round trip: pageable, the plane
    registering each host region for its copy (pin=True), and the arena
    registered once up front (the pinned bound). Gates: every tensor bitwise
    equal, the sink counting exactly the tensors' bytes in each direction."""
    import pickle

    from ray_tpu_torch._private import device_plane
    from ray_tpu_torch.runtime import RecordingMetrics, RuntimeHooks

    nbytes = sum(t.numel() * t.element_size() for t in params.values())
    out = dict(tensors=len(params), bytes=nbytes,
               params=sum(t.numel() for t in params.values()))
    runs = {}
    for mode in ("pageable", "register_per_copy", "arena_registered"):
        arena, sink = _Arena(), RecordingMetrics()
        hooks = RuntimeHooks(metrics=sink, serialize_scope_active=arena.scope_active,
                             append_oob_buffer=arena.append, lazy_buffer=_Lazy,
                             get_indexed_buffer=_arena_view)

        class Pickler(pickle.Pickler):
            dispatch_table = {}

        device_plane.install(Pickler.dispatch_table, hooks, pin=mode == "register_per_copy")
        try:
            import io

            f = io.BytesIO()
            arena.active = True
            Pickler(f, protocol=5).dump(params)
            arena.active = False
            meta = f.getvalue()
            arena.allocate()
            rt = torch.cuda.cudart()
            if mode == "arena_registered":
                rt.cudaHostRegister(arena.host.data_ptr(), arena.host.numel(), 0)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b, v in zip(arena.buffers, arena.views):
                    b.write(v)
                d2h = time.perf_counter() - t0
                t0 = time.perf_counter()
                _Arena.current = arena
                back = pickle.loads(meta)
                torch.cuda.synchronize()
                h2d = time.perf_counter() - t0
            finally:
                if mode == "arena_registered":
                    rt.cudaHostUnregister(arena.host.data_ptr())
        finally:
            # the hooks hold the arena, whose lazy buffers hold the plane
            # (their writers) and the parameters: a cycle the collector
            # would have to find (7b's peak reads what is left)
            _Arena.current, arena.buffers, arena.views = None, [], []
            device_plane.uninstall(Pickler.dispatch_table)
        same = all(back[n].device.type == "cuda" and back[n].dtype == t.dtype
                   and torch.equal(back[n], t) for n, t in params.items())
        counted = {d: sink.counters.get(sink.key("ray_tpu_device_transfer_bytes_total",
                                                 {"direction": d}), 0.0)
                   for d in ("device_to_host", "host_to_device")}
        runs[mode] = dict(d2h_s=d2h, h2d_s=h2d, d2h_gbps=nbytes / d2h / 1e9,
                          h2d_gbps=nbytes / h2d / 1e9, bitwise=same, counted_bytes=counted,
                          meta_bytes=len(meta), meta_bytes_per_tensor=len(meta) / len(params))
        del back, arena
        if not same:
            raise SystemExit(f"device_plane ({mode}): a rebuilt tensor differs")
        if counted != {"device_to_host": nbytes, "host_to_device": nbytes}:
            raise SystemExit(f"device_plane ({mode}): the sink counted {counted}, the tensors "
                             f"hold {nbytes} bytes")
    link = pcie_bound_gbps()
    out.update(runs=runs, link=link)
    for mode, r in runs.items():
        print(f"[device_plane] {mode}: {out['tensors']} tensors, {nbytes / 1e9:.3f} GB: "
              f"device->host {r['d2h_gbps']:.2f} GB/s, host->device {r['h2d_gbps']:.2f} GB/s "
              f"(link {link['gt_per_s']:g} GT/s x{link['width']} from {link['source']}: "
              f"{link['gbps']:.1f} GB/s a direction); bitwise {r['bitwise']}; sink bytes "
              f"{r['counted_bytes']}; metadata {r['meta_bytes']} B, "
              f"{r['meta_bytes_per_tensor']:.0f} B a tensor")
    torch.cuda.empty_cache()
    return out


class _LoopSession:
    """Stand-in for a trainer's session (ray_tpu.train's surface): reports
    kept with the time at each; an optional checkpoint to resume from;
    ``profile`` = (a, b) runs the profiler from step a's report to step
    b's (the loop reports a step once the next is queued, and a checkpoint's
    step at once, so from step 2's report to step 4's the window holds
    steps 3 and 4 whole: their batches' waits, launches and device work)."""

    class Checkpoint:
        def __init__(self, data):
            self.data = data

        @classmethod
        def from_dict(cls, data):
            return cls(dict(data))

        def to_dict(self):
            return dict(self.data)

    def __init__(self, checkpoint=None, profile=None):
        self.checkpoint, self.reports, self.checkpoints = checkpoint, [], {}
        self.window, self.prof, self.profile = profile, None, None

    def report(self, metrics, checkpoint=None):
        now = time.monotonic()
        self.reports.append(dict(metrics, at=now))
        if checkpoint is not None:
            self.checkpoints[metrics["step"]] = checkpoint
        if self.prof is not None and metrics["step"] == self.window[1]:
            self.prof.stop()
            self.profile = profile_report(
                self.prof, (now - self.prof_t0) * 1e3,
                f"gpt_train_loop steps {self.window[0] + 1}-{self.window[1]}")
            self.profile["steps"] = self.window[1] - self.window[0]
            self.prof = None
        if self.window is not None and metrics["step"] == self.window[0]:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self.prof_t0 = time.monotonic()

    def get_checkpoint(self):
        return self.checkpoint

    def get_world_rank(self):
        return 0

    def get_world_size(self):
        return 1


def phase_train_loop(nothing, profile: bool):
    """8b: phase 4's cell (gpt_1b, bf16 compute, float32 master weights and
    moments, b=12, t=2048, ce_chunk 512, remat "nothing") through
    ``train.loop.gpt_train_loop`` on the one-rank NCCL group, fed by
    ``iter_device_batches`` from seeded numpy batches that differ each step:
    a warm-up (step 0) and steps 1-4, the state gathered after step 2
    (``gather_state``, the loop's checkpoint); then ``restore_sharded_state``
    of that tree into a fresh state, held bitwise to the tree; then the loop
    resumed from the checkpoint for steps 3-4. Gates: phase 4's launches per
    step, on wgmma; the restored state bitwise equal to the gathered one;
    the resumed steps' losses and grad norms bitwise equal to the unbroken
    run's."""
    from ray_tpu_torch.models import training
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train.loop import gpt_train_loop, model_config

    config = dict(model="gpt_1b", model_overrides={"ce_chunk": 512}, batch=nothing["batch"],
                  seq=nothing["seq"], steps=5, lr=1e-4, data_seed=11,
                  checkpoint_every=3, device="cuda")
    want = dict(zip(COUNTS, (nothing["launches_per_step"][name] for name in COUNTS)))
    _reset_launch_counts()
    first = _LoopSession(profile=(2, 4) if profile else None)
    gpt_train_loop(config, session=first)
    first_counts = _launch_counts()
    tree = first.checkpoints[2].to_dict()["state"]
    # the restored state, leaf by leaf against the gathered tree
    cfg = model_config({"model_overrides": config["model_overrides"], "model": "gpt_1b"})
    mesh = MeshSpec(dp=-1).build("cuda")  # the loop's
    restored, _ = training.restore_sharded_state(tree, cfg, mesh,
                                                 training.default_optimizer(1e-4))
    leaves = [(tree["params"], restored.params.values()),
              (tree["mu"], restored.opt_state.mu), (tree["nu"], restored.opt_state.nu)]
    bitwise_state = (restored.step == tree["step"] == 3
                     and restored.opt_state.count == tree["count"]
                     and all(torch.equal(t.to_local(), torch.from_numpy(host[n]).to("cuda"))
                             for host, ts in leaves for n, t in zip(host, ts)))
    del restored, leaves
    torch.cuda.empty_cache()
    second = _LoopSession(checkpoint=first.checkpoints[2])
    gpt_train_loop(config, session=second)
    launches = dict(zip(COUNTS, _launch_counts()))
    run = first.reports
    # per step over each run (a report comes once the next step is queued,
    # so counts at reports are not a step's); the gather and the restores
    # launch no flash kernel
    per_step = [{n: c / len(r) for n, c in counts.items()} for r, counts in (
        (run, dict(zip(COUNTS, first_counts))),
        (second.reports, {n: launches[n] - c for n, c in zip(COUNTS, first_counts)}))]
    if any(p != want for p in per_step):
        raise SystemExit(f"train_loop: launches per step {per_step}, expected {want}")
    unbroken = [(r["loss"], r["grad_norm"]) for r in run[3:]]
    resumed = [(r["loss"], r["grad_norm"]) for r in second.reports]
    losses = [r["loss"] for r in run]
    # a step is reported once the next is queued, so from step 0's report to
    # step 1's the card ran step 1 with step 2 queued behind it: the steady
    # step. Later intervals mix steps: the host's launches of step 4 wait
    # for room in the launch queue, which holds step 3's report back; steps
    # 3-4 together start from an idle card after the checkpoint's gather
    ms = run[1]["step_ms"]
    after_checkpoint = (run[4]["at"] - run[2]["at"]) * 1e3 / 2
    out = dict(batch=config["batch"], seq=config["seq"], steps=4, warmup_steps=1,
               losses=losses, grad_norms=[r["grad_norm"] for r in run],
               resumed=resumed, unbroken_3_4=unbroken, ms_per_step=ms,
               phase4_ms_per_step=nothing["ms_per_step"],
               step_ms=[r["step_ms"] for r in run], ms_per_step_after_checkpoint=after_checkpoint,
               ms_per_step_note="step 1: from step 0's report to step 1's; after "
                                "checkpoint: steps 3-4, from step 2's report to step 4's",
               bitwise_restored_state=bitwise_state, resumed_bitwise=resumed == unbroken,
               launches_per_step=want, launches=launches,
               launches_by_run=dict(unbroken_5_steps=dict(zip(COUNTS, first_counts)),
                                    resumed_2_steps={n: launches[n] - c for n, c in
                                                     zip(COUNTS, first_counts)}),
               checkpoint_bytes=int(sum(a.nbytes for part in ("params", "mu", "nu")
                                        for a in tree[part].values())))
    if first.profile is not None:
        out["profile"] = first.profile
    print(f"[train_loop] gpt_train_loop, gpt_1b b={config['batch']} t={config['seq']}: losses "
          f"{[round(x, 4) for x in losses]}, {ms:.1f} ms per step (step 1; phase 4 "
          f"{nothing['ms_per_step']:.1f}), {after_checkpoint:.1f} over steps 3-4 after the "
          f"checkpoint; checkpoint after step 2: "
          f"{out['checkpoint_bytes'] / 1e9:.2f} GB gathered, restored bitwise {bitwise_state}; "
          f"resumed steps 3-4 {resumed} vs unbroken {unbroken}: bitwise "
          f"{out['resumed_bitwise']}" + (
              f"; idle share over steps 3-4 {first.profile['idle_share']:.3f} (phase 4 "
              f"{nothing['profile']['idle_share']:.3f})" if first.profile else ""))
    if not all(np.isfinite(losses)):
        raise SystemExit(f"train_loop: losses {losses}")
    if not bitwise_state:
        raise SystemExit("train_loop: the restored state differs from the gathered one")
    # the restored state is the gathered one bit for bit and the batches are
    # the same seeded ones, so steps 3-4 give the same bits: the step is
    # deterministic on the card (the same kernels and GEMM shapes, no
    # atomics in the flash backward, CUBLAS_WORKSPACE_CONFIG set)
    if resumed != unbroken:
        raise SystemExit(f"train_loop: resumed steps {resumed} differ from the unbroken "
                         f"run's {unbroken}")
    torch.cuda.empty_cache()
    return out


def phase_sharded_ws1(nothing, steps: int, profile: bool):
    """7b and 7c: phase 4's step through the sharded train step on a
    one-rank NCCL group, on MeshSpec(fsdp=-1) and, with ring and Ulysses
    named, MeshSpec(sp=1)."""
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.parallel.mesh import MeshSpec

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    out = {}
    try:
        for path, spec, impl, n in (("sharded_ws1", MeshSpec(fsdp=-1), "ring", steps),
                                    ("sp_ring_ws1", MeshSpec(sp=1), "ring", 2),
                                    ("sp_ulysses_ws1", MeshSpec(sp=1), "ulysses", 2)):
            mesh = spec.build("cuda")

            def build(cfg, opt):
                state, shardings = training.init_sharded_state(cfg, mesh, opt, seed=0)
                return state, training.make_train_step(cfg, opt, mesh=mesh,
                                                       state_shardings_tree=shardings)

            cfg = gpt.gpt_1b(ce_chunk=512, seq_parallel_impl=impl)
            tokens = _train_tokens(cfg, nothing["batch"], nothing["seq"])
            rep = run_train(cfg, tokens, n, 2, f"gpt_1b sharded ({path})", False, build)
            loss_rel = abs(rep["warmup_loss"] / nothing["warmup_loss"] - 1)
            grad_rel = abs(rep["warmup_grad_norm"] / nothing["warmup_grad_norm"] - 1)
            print(f"[sharded] {path}: mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}, "
                  f"impl '{impl}', backend {dist.get_backend()}: warm-up loss "
                  f"{rep['warmup_loss']!r} vs phase 4 {nothing['warmup_loss']!r} (rel "
                  f"{loss_rel:.2e}, limit {SHARDED_LOSS_RTOL}), grad norm rel {grad_rel:.2e} "
                  f"(limit {POLICY_GRAD_NORM_RTOL}); {rep['ms_per_step']:.1f} ms per step "
                  f"(phase 4 {nothing['ms_per_step']:.1f}), peak {rep['max_memory_gib']:.2f} "
                  f"GiB (phase 4 {nothing['max_memory_gib']:.2f})")
            if not loss_rel <= SHARDED_LOSS_RTOL:
                raise SystemExit(f"{path}: the first loss differs from phase 4's by {loss_rel}")
            if not grad_rel <= POLICY_GRAD_NORM_RTOL:
                raise SystemExit(f"{path}: the first grad norm differs from phase 4's by "
                                 f"{grad_rel}")
            mem_diff = rep["max_memory_gib"] - nothing["max_memory_gib"]
            if path == "sharded_ws1" and not abs(mem_diff) <= SHARDED_PEAK_GIB:
                # what the closed server (phase 6) or another phase left behind
                # would show here
                raise SystemExit(f"{path}: peak memory {rep['max_memory_gib']:.2f} GiB, phase "
                                 f"4's {nothing['max_memory_gib']:.2f}")
            rep.update(warmup_loss_rel_diff=loss_rel, warmup_grad_norm_rel_diff=grad_rel,
                       mesh=dict(zip(mesh.mesh_dim_names, map(int, mesh.mesh.shape))),
                       seq_parallel_impl=impl, backend=dist.get_backend())
            out[path] = rep
        out["pp_small_ws1"] = pp_small_vs_dense()
        out["pp_train_ws1"] = phase_pp_train_ws1(nothing, steps, profile)
        out["train_loop"] = phase_train_loop(nothing, profile)
    finally:
        dist.destroy_process_group()
    return out


def pp_small_vs_dense():
    """7d(a): a float32 gpt_nano pipelined step (``make_pp_train_step`` at
    MeshSpec(pp=1), 2 microbatches) against the dense single-device step,
    both on the card from the same weights and tokens: first loss within
    PP_SMALL_LOSS_RTOL."""
    from ray_tpu_torch.models import gpt, inference, training
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.sharding import pp_rules

    cfg = gpt.gpt_nano(ce_chunk=32)
    tokens = torch.from_numpy(
        np.random.RandomState(3).randint(0, cfg.vocab_size, (4, 80))).to("cuda")
    opt = training.default_optimizer(1e-2)
    state = training.init_train_state(inference.init_params(cfg, device="cuda", seed=4), opt)
    _, dense = training.make_train_step(cfg, opt, device="cuda")(state, tokens)
    mesh = MeshSpec(pp=1).build("cuda")
    pp_state, shardings = training.init_sharded_state(cfg, mesh, opt, seed=4, rules=pp_rules(),
                                                      stacked=True)
    step = training.make_pp_train_step(cfg, opt, mesh, num_microbatches=2,
                                       state_shardings_tree=shardings)
    _, pp = step(pp_state, tokens)
    dense_loss, pp_loss = float(dense["loss"]), float(pp["loss"])
    rel = abs(pp_loss / dense_loss - 1)
    print(f"[pp] gpt_nano f32, pp 1, 2 microbatches vs the dense step on the card: loss "
          f"{pp_loss!r} vs {dense_loss!r} (rel {rel:.2e}, limit {PP_SMALL_LOSS_RTOL}), grad "
          f"norm {float(pp['grad_norm'])!r} vs {float(dense['grad_norm'])!r}")
    if not rel <= PP_SMALL_LOSS_RTOL:
        raise SystemExit(f"pp_small_ws1: the pipelined gpt_nano loss differs from the dense "
                         f"step's by {rel}")
    return dict(loss=pp_loss, dense_loss=dense_loss, rel_diff=rel, rtol=PP_SMALL_LOSS_RTOL,
                grad_norm=float(pp["grad_norm"]), dense_grad_norm=float(dense["grad_norm"]))


def phase_pp_train_ws1(nothing, steps: int, profile: bool):
    """7d(b): phase 4's cell through the pipelined step
    (``make_pp_train_step`` at MeshSpec(pp=1), PP_MICROBATCHES
    microbatches, state from ``init_sharded_state(seed=0, rules=pp_rules(),
    stacked=True)``): run_train's gates with 2 * num_layers * M forward
    launches and num_layers * M of each backward kernel a step, the warm-up
    loss within PP_LOSS_RTOL of phase 4's, the peak within PP_PEAK_GIB of
    phase 4's."""
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.sharding import pp_rules

    mesh = MeshSpec(pp=1).build("cuda")
    rules = pp_rules()

    def build(cfg, opt):
        state, shardings = training.init_sharded_state(cfg, mesh, opt, seed=0, rules=rules,
                                                       stacked=True)
        return state, training.make_pp_train_step(
            cfg, opt, mesh, num_microbatches=PP_MICROBATCHES, rules=rules,
            state_shardings_tree=shardings)

    cfg = gpt.gpt_1b(ce_chunk=512)
    tokens = _train_tokens(cfg, nothing["batch"], nothing["seq"])
    rep = run_train(cfg, tokens, steps, 2, "gpt_1b pipelined (pp_train_ws1)", profile, build,
                    microbatches=PP_MICROBATCHES)
    loss_rel = abs(rep["warmup_loss"] / nothing["warmup_loss"] - 1)
    grad_rel = abs(rep["warmup_grad_norm"] / nothing["warmup_grad_norm"] - 1)
    mem_over = rep["max_memory_gib"] - nothing["max_memory_gib"]
    print(f"[pp] pp_train_ws1: pp 1, {PP_MICROBATCHES} microbatches of "
          f"{nothing['batch'] // PP_MICROBATCHES}: warm-up loss {rep['warmup_loss']!r} vs phase 4 "
          f"{nothing['warmup_loss']!r} (rel {loss_rel:.2e}, limit {PP_LOSS_RTOL}), grad norm "
          f"rel {grad_rel:.2e}; {rep['ms_per_step']:.1f} ms per step (phase 4 "
          f"{nothing['ms_per_step']:.1f}), {rep['tokens_per_s']:.0f} tokens/s (phase 4 "
          f"{nothing['tokens_per_s']:.0f}), MFU {100 * rep['mfu']:.1f}% (phase 4 "
          f"{100 * nothing['mfu']:.1f}%), peak {rep['max_memory_gib']:.2f} GiB (phase 4 "
          f"{nothing['max_memory_gib']:.2f}, limit +{PP_PEAK_GIB})")
    if not loss_rel <= PP_LOSS_RTOL:
        raise SystemExit(f"pp_train_ws1: the first loss differs from phase 4's by {loss_rel}")
    if not mem_over <= PP_PEAK_GIB:
        raise SystemExit(f"pp_train_ws1: peak memory {rep['max_memory_gib']:.2f} GiB, phase 4's "
                         f"{nothing['max_memory_gib']:.2f} + {PP_PEAK_GIB}")
    rep.update(warmup_loss_rel_diff=loss_rel, warmup_loss_rtol=PP_LOSS_RTOL,
               warmup_grad_norm_rel_diff=grad_rel, peak_over_phase4_gib=mem_over,
               mesh=dict(zip(mesh.mesh_dim_names, map(int, mesh.mesh.shape))))
    return rep


# 9a: an RL learner's update on the card vs the same update on the CPU, float32
# (4c's gpt_nano limits): parameters and metrics within rtol 1e-4 and atol
# 1e-6. The absolute floor is for a metric that is zero up to rounding: APPO's
# policy loss on a fresh batch is the mean of normalised advantages times a
# ratio of 1 (3.7e-9 on the CPU, and 121% away on the first card run)
RL_RTOL, RL_ATOL = 1e-4, 1e-6
# 9b: the catalog's policies on the card vs the CPU (float32, TF32 off)
RL_CATALOG_ATOL = 1e-5
# 9c / 9d: the reference's learning tests (tests/test_rl.py:84-107, :257-277)
RL_PPO_RETURN, RL_PPO_ITERATIONS = 120.0, 30
RL_IMPALA_RETURN, RL_IMPALA_CALLS = 80.0, 40
# phase 9's device; a rehearsal on the CPU sets it to "cpu"
RL_CARD = "cuda"


def rl_learners_card_vs_cpu():
    """9a: PPO's full update (6 epochs of 4 minibatches of 128 over a
    512-row batch), and one update of PG, A2C, IMPALA and APPO, each from
    the same seeded state dict on the card and on the CPU, over the same
    batch from a CPU rollout at seed 0 (``sample(128)`` of 4 envs, and
    ``sample_trajectory(32)`` for the V-trace learners)."""
    from ray_tpu_torch.rl import (A2CLearner, APPOLearner, ImpalaLearner, PGLearner,
                                  PPOLearner, RolloutWorker)

    worker = RolloutWorker("CartPole-v1", num_envs=4, seed=0, device="cpu")
    flat, trajectory = worker.sample(128), worker.sample_trajectory(32)
    cases = {"ppo": (PPOLearner, flat, dict(minibatch_size=128, num_epochs=6, seed=0)),
             "pg": (PGLearner, flat, {}), "a2c": (A2CLearner, flat, {}),
             "impala": (ImpalaLearner, trajectory, {}), "appo": (APPOLearner, trajectory, {})}
    out, bad = {}, []
    for name, (cls, batch, kw) in cases.items():
        state = cls(4, 2, seed=0, device="cpu").get_weights()
        runs = {}
        for dev in ("cpu", RL_CARD):
            learner = cls(4, 2, seed=0, device=dev)
            learner.set_weights(state)
            metrics = learner.update(batch, **kw)
            runs[dev] = (metrics, learner.get_weights(), learner.opt_state.count)
        (m_cpu, w_cpu, steps), (m_card, w_card, card_steps) = runs["cpu"], runs[RL_CARD]
        param_err = max(float((w_card[k] - w_cpu[k]).abs().max()) for k in w_cpu)
        params_ok = all(torch.allclose(w_card[k], w_cpu[k], rtol=RL_RTOL, atol=RL_ATOL)
                        for k in w_cpu)
        # each metric's distance over its limit (at most 1 passes)
        metric_share = {k: abs(m_card[k] - m_cpu[k]) / (RL_ATOL + RL_RTOL * abs(m_cpu[k]))
                        for k in m_cpu}
        worst = max(metric_share, key=metric_share.get)
        out[name] = dict(rows=len(batch) if name in ("ppo", "pg", "a2c") else
                         int(np.prod(batch["actions"].shape)), optimizer_steps=steps,
                         max_abs_param_err=param_err, params_ok=params_ok,
                         metric_share_of_limit=metric_share, card=m_card, cpu=m_cpu)
        print(f"[rl] 9a {name}: {steps} optimizer steps, card vs CPU: parameters max abs "
              f"{param_err:.2e} (rtol {RL_RTOL}, atol {RL_ATOL}: {params_ok}); metrics within "
              f"the same limits, the nearest {worst} {m_card[worst]:.9g} vs {m_cpu[worst]:.9g} "
              f"({metric_share[worst]:.3f} of its limit)")
        if not params_ok or metric_share[worst] > 1 or card_steps != steps:
            bad.append(name)
    if bad:
        raise SystemExit(f"rl: the card's update differs from the CPU's for {bad}")
    return out


def rl_catalog_card_vs_cpu():
    """9b: ``CatalogPolicy`` at the default widths (hidden (64, 64), cell 64,
    attention dim 64 with 2 heads) on the card vs the CPU, the same weights
    and inputs: the MLP under each activation, the LSTM over 3 steps
    threading its carry, attention over a 5-step window; 256 rows."""
    from ray_tpu_torch.rl import get_model

    rng = np.random.default_rng(0)
    cases = {f"mlp_{act}": {"fcnet_activation": act} for act in ("tanh", "relu", "gelu", "silu")}
    cases.update(lstm={"use_lstm": True}, attention={"use_attention": True})
    out, bad = {}, []
    for name, cfg in cases.items():
        shape = (256, 5, 4) if name == "attention" else (256, 4)
        steps = 3 if name == "lstm" else 1
        xs = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for _ in range(steps)]
        outs = {}
        for dev in ("cpu", RL_CARD):
            policy = get_model(2, cfg, observation_size=4, seed=0, device=dev)
            carry = policy.encoder.initial_carry(256) if name == "lstm" else None
            got = []
            with torch.no_grad():
                for x in xs:
                    y = policy(x.to(dev), carry) if carry is not None else policy(x.to(dev))
                    if carry is not None:
                        *y, carry = y
                        y = [*y, *carry]
                    got += [t.cpu() for t in y]
            outs[dev] = got
        err = max(float((a - b).abs().max()) for a, b in zip(outs[RL_CARD], outs["cpu"]))
        out[name] = dict(max_abs_err=err, steps=steps)
        if not err <= RL_CATALOG_ATOL:
            bad.append(name)
    print(f"[rl] 9b catalog card vs CPU, max abs err (atol {RL_CATALOG_ATOL}): "
          + ", ".join(f"{k} {v['max_abs_err']:.2e}" for k, v in out.items()))
    if bad:
        raise SystemExit(f"rl: the catalog's policies differ on the card for {bad}")
    return out


def rl_ppo_learns(profile: bool):
    """9c: the reference's PPO learning test on the card (learner and
    rollouts): 2 workers x 4 envs, fragment 128, lr 1e-3, 8 epochs,
    minibatch 256, seed 0; best mean return >= RL_PPO_RETURN within
    RL_PPO_ITERATIONS. Each iteration's wall time, the learner update's
    (synchronized), env steps/s and optimizer steps; with ``profile`` the
    second iteration's update under torch.profiler."""
    from ray_tpu_torch.rl import PPOConfig

    algo = PPOConfig(num_rollout_workers=2, num_envs_per_worker=4, rollout_fragment_length=128,
                     lr=1e-3, num_epochs=8, minibatch_size=256, seed=0, device=RL_CARD,
                     rollout_device=RL_CARD).build()
    learner = algo.learners.local
    update, timed = algo.learners.update, []

    def timed_update(batch, **kw):
        window = profile and len(timed) == 1
        prof = None
        if window:
            from torch.profiler import ProfilerActivity
            prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                      ProfilerActivity.CUDA])
            prof.start()
        torch.cuda.synchronize()
        t0, count = time.perf_counter(), learner.opt_state.count
        metrics = update(batch, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        timed.append(dict(update_ms=ms, optimizer_steps=learner.opt_state.count - count))
        if prof is not None:
            prof.stop()
            timed[-1]["profile"] = profile_report(prof, ms, "9c: one PPO learner update")
        return metrics

    algo.learners.update = timed_update
    rows, best = [], 0.0
    try:
        for i in range(RL_PPO_ITERATIONS):
            r = algo.train()
            row = dict(timed[-1], iteration=i + 1, wall_s=r["time_this_iter_s"],
                       env_steps=r["env_steps_this_iter"],
                       env_steps_per_s=r["env_steps_this_iter"] / r["time_this_iter_s"],
                       episode_return_mean=r["episode_return_mean"])
            row["outside_update_share"] = 1 - row["update_ms"] / 1e3 / row["wall_s"]
            rows.append(row)
            print(f"[rl] 9c ppo iteration {i + 1}: {row['wall_s']:.3f} s, learner update "
                  f"{row['update_ms']:.1f} ms ({row['optimizer_steps']} optimizer steps), "
                  f"{row['env_steps_per_s']:.0f} env steps/s, return "
                  f"{row['episode_return_mean']:.1f}")
            if np.isfinite(r["episode_return_mean"]):
                best = max(best, r["episode_return_mean"])
            if best >= RL_PPO_RETURN:
                break
    finally:
        algo.stop()
    if best < RL_PPO_RETURN:
        raise SystemExit(f"rl: PPO on the card reached {best} within {len(rows)} iterations "
                         f"(needs {RL_PPO_RETURN})")
    return dict(best_return=best, iterations=len(rows), rows=rows)


def rl_impala_learns():
    """9d: the reference's IMPALA learning test on the card: 2 workers x 4
    envs, fragment 32, lr 1e-3, seed 0, ``train(num_updates=8)`` until the
    best mean return reaches RL_IMPALA_RETURN within RL_IMPALA_CALLS."""
    from ray_tpu_torch.rl import ImpalaConfig

    algo = ImpalaConfig(num_rollout_workers=2, num_envs_per_worker=4, rollout_fragment_length=32,
                        lr=1e-3, seed=0, device=RL_CARD, rollout_device=RL_CARD).build()
    rows, best = [], 0.0
    try:
        for i in range(RL_IMPALA_CALLS):
            r = algo.train(num_updates=8)
            rows.append(dict(call=i + 1, wall_s=r["time_this_iter_s"],
                             episode_return_mean=r["episode_return_mean"]))
            if np.isfinite(r["episode_return_mean"]):
                best = max(best, r["episode_return_mean"])
            if best >= RL_IMPALA_RETURN:
                break
    finally:
        algo.stop()
    wall = sum(row["wall_s"] for row in rows)
    print(f"[rl] 9d impala: best return {best:.1f} after {len(rows)} calls of 8 updates, "
          f"{wall / len(rows) * 1e3:.1f} ms a call")
    if best < RL_IMPALA_RETURN:
        raise SystemExit(f"rl: IMPALA on the card reached {best} within {len(rows)} calls "
                         f"(needs {RL_IMPALA_RETURN})")
    return dict(best_return=best, calls=len(rows), ms_per_call=wall / len(rows) * 1e3,
                rows=rows)


# 9f: the reference's DQN learning test (tests/test_rl.py:231-256)
RL_DQN_RETURN, RL_DQN_ITERATIONS = 100.0, 60
# a gradient below this at some step is at the rounding floor: Adam's first
# update there is lr * g / (|g| + 1e-8), which the last bits decide, so such
# an element is held to 2 * lr a step (the CPU tests' rule)
RL_GRAD_FLOOR = 1e-6


def _record_steps(opts):
    """Wrap each ``AdamParams`` of ``opts`` (name -> it) so that it records
    every step's gradients before taking it."""
    grads = {name: [] for name in opts}
    for name, opt in opts.items():
        def recorded(g, step=opt.step, log=grads[name]):
            log.append([t.detach().to("cpu", copy=True) for t in g])
            step(g)
        opt.step = recorded
    return grads


def _state_share(card, cpu, grads, lr_steps):
    """Every parameter (and target) of ``card`` against ``cpu`` (name ->
    module each): the worst share of the limit (rtol RL_RTOL, atol
    RL_ATOL; a rounding-floor element's limit 2 * lr a step), and the max
    abs difference. ``grads``: the CPU run's recorded gradients by
    optimizer; ``lr_steps``: name -> (optimizer, lr * steps)."""
    worst, max_err = 0.0, 0.0
    for name, c_mod in cpu.items():
        opt, slack = lr_steps[name]
        g_mod = card[name]
        floor = {}
        if grads.get(opt):
            pnames = [n for n, _ in c_mod.named_parameters()]
            for i, pname in enumerate(pnames):
                floor[pname] = torch.stack([g[i].abs() for g in grads[opt]]).amin(0) < RL_GRAD_FLOOR
        c_state, g_state = c_mod.state_dict(), g_mod.state_dict()
        for k, c in c_state.items():
            diff = (g_state[k].detach().cpu() - c).abs()
            limit = RL_ATOL + RL_RTOL * c.abs()
            if k in floor:
                limit = torch.where(floor[k], torch.full_like(limit, 2 * slack), limit)
            max_err = max(max_err, float(diff.max()))
            worst = max(worst, float((diff / limit).max()))
    return worst, max_err


def _metric_share(card_rows, cpu_rows):
    worst = 0.0
    for m_card, m_cpu in zip(card_rows, cpu_rows):
        for k, v in m_cpu.items():
            worst = max(worst, abs(m_card[k] - v) / (RL_ATOL + RL_RTOL * abs(v)))
    return worst


def _memory_dataset(batch):
    """Hooks whose dataset read gives ``batch`` from memory: no file and no
    pyarrow on the card's machine."""
    from ray_tpu_torch.rl import offline
    from ray_tpu_torch.runtime import RuntimeHooks

    cols = offline._flatten(batch)
    return RuntimeHooks(read_dataset=lambda path, batch_size=4096: iter([cols]))


def rl_offpolicy_card_vs_cpu():
    """9e: each off-policy learner's update, card against CPU: the same
    reference-drawn weights (seed 0), the same batches and the same
    ``rl.prng`` noise for three consecutive updates; parameters, targets
    and metrics within RL_RTOL / RL_ATOL (rounding-floor elements within
    2 * lr a step). DQN (double-Q, prioritized weights), Rainbow (dueling,
    noisy, 3-step, C51 with 51 atoms), Ape-X's worker TD error, SAC with
    the auto-tuned temperature, TD3 (an actor step, a skipped one, an
    actor step), DDPG, CQL, MARWIL (beta 1) and BC (beta 0); CQL and MARWIL
    read their data through an in-memory dataset hook."""
    from ray_tpu_torch.rl import (ApexRolloutWorker, BCConfig, CQLConfig, DDPGConfig,
                                  DQNLearner, DQNRolloutWorker, MARWILConfig,
                                  PrioritizedReplayBuffer, RolloutWorker, SACConfig,
                                  SACRolloutWorker, SampleBatch, TD3Config, prng)
    from ray_tpu_torch.rl.learner import to_device

    out, bad = {}, []

    def report(name, share, max_err, metric_share, extra=""):
        out[name] = dict(state_share_of_limit=share, max_abs_param_err=max_err,
                         metric_share_of_limit=metric_share)
        print(f"[rl] 9e {name}: card vs CPU over 3 updates: parameters max abs {max_err:.2e} "
              f"({share:.3f} of the limit), metrics {metric_share:.3f} of the limit{extra}")
        if not (share <= 1 and metric_share <= 1):
            bad.append(name)

    # DQN and Rainbow: minibatches drawn once on the host from prioritized
    # replay over a CPU worker's transitions
    for name, knobs in (("dqn", {}), ("rainbow", dict(dueling=True, noisy=True, n_step=3,
                                                     num_atoms=51))):
        worker = DQNRolloutWorker("CartPole-v1", num_envs=4, seed=0, device="cpu", **knobs)
        buf = PrioritizedReplayBuffer(4096, alpha=0.6, seed=0)
        buf.add(worker.sample(64, 0.5))
        batches = [buf.sample(64, beta=0.4) for _ in range(3)]
        runs = {}
        for dev in ("cpu", RL_CARD):
            learner = DQNLearner(4, 2, seed=0, device=dev, **knobs)
            grads = _record_steps({"opt": learner.opt})
            rows = [learner.update(mb) for mb in batches]
            runs[dev] = (learner, grads, [dict(loss=l, td_max=float(np.abs(td).max()))
                                          for l, td in rows], [td for _, td in rows])
        (c, g, m_cpu, td_cpu), (d, _, m_card, td_card) = runs["cpu"], runs[RL_CARD]
        share, err = _state_share({"net": d.net, "target": d.target_net},
                                  {"net": c.net, "target": c.target_net}, g,
                                  {"net": ("opt", 1e-3 * 3), "target": ("opt", 1e-3 * 3)})
        td_share = max(float(np.max(np.abs(a - b) / (RL_ATOL + RL_RTOL * np.abs(b))))
                       for a, b in zip(td_card, td_cpu))
        report(name, share, err, max(_metric_share(m_card, m_cpu), td_share))

    # Ape-X: the worker's initial priorities over one batch, same weights
    tds = {}
    batch = None
    for dev in ("cpu", RL_CARD):
        w = ApexRolloutWorker("CartPole-v1", num_envs=4, seed=0, n_step=3, device=dev)
        batch = batch if batch is not None else w.sample(32, 0.5)
        tds[dev] = w.td_error(batch)
    share = float(np.max(np.abs(tds[RL_CARD] - tds["cpu"])
                         / (RL_ATOL + RL_RTOL * np.abs(tds["cpu"]))))
    report("apex_td_error", 0.0, float(np.abs(tds[RL_CARD] - tds["cpu"]).max()), share)

    # SAC, TD3, DDPG: three updates on replayed Pendulum transitions
    pendulum = SACRolloutWorker("Pendulum-v1", num_envs=4, seed=0, device="cpu")
    cont = [pendulum.sample(64, True) for _ in range(3)]
    keys = prng.split(prng.PRNGKey(7), 3)
    for name, make in (("sac", lambda dev: SACConfig(device=dev, rollout_device=dev,
                                                     num_envs_per_worker=1).build()),
                       ("td3", lambda dev: TD3Config(device=dev, rollout_device=dev,
                                                     num_envs_per_worker=1).build()),
                       ("ddpg", lambda dev: DDPGConfig(device=dev, rollout_device=dev,
                                                       num_envs_per_worker=1).build()),
                       ("cql", lambda dev: CQLConfig(
                           device=dev, batch_size=256,
                           hooks=_memory_dataset(SampleBatch.concat(cont))).build())):
        runs = {}
        for dev in ("cpu", RL_CARD):
            algo = make(dev)
            opts = {k: getattr(algo, k) for k in ("q_opt", "pi_opt", "a_opt")
                    if hasattr(algo, k)}
            grads = _record_steps(opts)
            rows = []
            for i, (b, k) in enumerate(zip(cont, keys)):
                tb = to_device(b, algo.device)
                m = algo.update(tb, k, i) if name in ("td3", "ddpg") else algo.update(tb, k)
                rows.append({kk: float(v) for kk, v in m.items()})
            runs[dev] = (algo, grads, rows)
            if hasattr(algo, "stop"):
                algo.stop()
        (c, g, m_cpu), (d, _, m_card) = runs["cpu"], runs[RL_CARD]
        mods = {"policy": ("pi_opt", 3e-4 * 3), "qnet": ("q_opt", 3e-4 * 3),
                "q_target": ("q_opt", 3e-4 * 3)}
        if name in ("td3", "ddpg"):
            mods["pi_target"] = ("pi_opt", 3e-4 * 3)
        if name == "sac":
            mods["temperature"] = ("a_opt", 3e-4 * 3)
        share, err = _state_share({k: getattr(d, k) for k in mods},
                                  {k: getattr(c, k) for k in mods}, g, mods)
        extra = ""
        if name == "td3":
            extra = f"; actor steps {len(g['pi_opt'])} of 3"
            if len(g["pi_opt"]) != 2:
                bad.append("td3 skipped step")
        report(name, share, err, _metric_share(m_card, m_cpu), extra)

    # MARWIL and BC: one epoch over 768 logged CartPole rows (3 steps)
    logged = RolloutWorker("CartPole-v1", num_envs=4, seed=0, device="cpu").sample(192)
    for name, cfg in (("marwil", MARWILConfig), ("bc", BCConfig)):
        runs = {}
        for dev in ("cpu", RL_CARD):
            algo = cfg(input_path="memory", batch_size=256, device=dev,
                       hooks=_memory_dataset(logged)).build()
            grads = _record_steps({"opt": algo.opt})
            m = algo.train(epochs=1)
            runs[dev] = (algo, grads, [{k: m[k] for k in ("total_loss", "policy_loss",
                                                          "vf_loss")}])
        (c, g, m_cpu), (d, _, m_card) = runs["cpu"], runs[RL_CARD]
        share, err = _state_share({"net": d.net}, {"net": c.net}, g,
                                  {"net": ("opt", 1e-3 * 3)})
        report(name, share, err, _metric_share(m_card, m_cpu),
               f"; {len(g['opt'])} optimizer steps")
    if bad:
        raise SystemExit(f"rl: the card's off-policy updates differ from the CPU's for {bad}")
    return out


def rl_dqn_learns(profile: bool):
    """9f: the reference's DQN learning test on the card (learner and the
    worker's forwards): 1 worker x 4 envs, fragment 64, learning starts
    256, epsilon over 3000 steps, 16 updates an iteration, target every
    100, seed 0; best mean return >= RL_DQN_RETURN within
    RL_DQN_ITERATIONS. Each iteration's wall time, its updates' time
    (synchronized) and env steps/s; with ``profile`` one iteration's 16
    updates under torch.profiler."""
    from ray_tpu_torch.rl import DQNConfig

    algo = DQNConfig(num_rollout_workers=1, num_envs_per_worker=4, rollout_fragment_length=64,
                     learning_starts=256, epsilon_decay_steps=3000, updates_per_iteration=16,
                     target_update_interval=100, seed=0, device=RL_CARD,
                     rollout_device=RL_CARD).build()
    learner = algo.learner
    update, update_ms = learner.update, []
    # with profile: one iteration's 16 updates (and the host's replay work
    # between them) under torch.profiler, from the first to the last
    win = dict(armed=False, prof=None, t0=0.0, n=0, report=None)

    def timed(batch):
        if win["armed"] and win["prof"] is None:
            from torch.profiler import ProfilerActivity
            win["prof"] = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                             ProfilerActivity.CUDA])
            win["prof"].start()
            win["t0"] = time.perf_counter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = update(batch)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
        if win["prof"] is not None and win["report"] is None:
            win["n"] += 1
            if win["n"] == algo.config.updates_per_iteration:
                wall = (time.perf_counter() - win["t0"]) * 1e3
                win["prof"].stop()
                win["report"] = profile_report(win["prof"], wall, "9f: 16 DQN learner updates")
        return result

    learner.update = timed
    rows, best = [], 0.0
    try:
        for i in range(RL_DQN_ITERATIONS):
            n_before = len(update_ms)
            win["armed"] = profile and algo._updates >= 32
            r = algo.train()
            ms = update_ms[n_before:]
            row = dict(iteration=i + 1, wall_s=r["time_this_iter_s"], updates=len(ms),
                       update_ms=ms, env_steps=256,
                       env_steps_per_s=256 / r["time_this_iter_s"],
                       episode_return_mean=r["episode_return_mean"])
            rows.append(row)
            if np.isfinite(r["episode_return_mean"]):
                best = max(best, r["episode_return_mean"])
            if best >= RL_DQN_RETURN:
                break
    finally:
        algo.stop()
    prof_report = win["report"]
    per_update = [ms for row in rows for ms in row["update_ms"]]
    steady = sorted(per_update[16:]) or sorted(per_update)
    med = steady[len(steady) // 2] if steady else float("nan")
    print(f"[rl] 9f dqn: best return {best:.1f} after {len(rows)} iterations; an update "
          f"{med:.2f} ms (median, synchronized), {min(steady) if steady else 0:.2f}-"
          f"{max(steady) if steady else 0:.2f}; an iteration "
          f"{np.median([r['wall_s'] for r in rows]) * 1e3:.1f} ms, "
          f"{np.median([r['env_steps_per_s'] for r in rows]):.0f} env steps/s"
          + (f"; updates' idle share {prof_report['idle_share']:.3f}" if prof_report else ""))
    if best < RL_DQN_RETURN:
        raise SystemExit(f"rl: DQN on the card reached {best} within {len(rows)} iterations "
                         f"(needs {RL_DQN_RETURN})")
    return dict(best_return=best, iterations=len(rows), update_ms_median=med, rows=rows,
                profile=prof_report)


def rl_offpolicy_mechanics():
    """9g: Ape-X (2 rollout workers, 2 replay shards, 8 updates an
    iteration) for 2 iterations; the
    policy server (learner on the card) over 20 external CartPole episodes
    through the in-process transport; ES for 2 iterations; SAC on Pendulum
    for 2 iterations past its warm-up."""
    from ray_tpu_torch.rl import (ApexDQNConfig, ESConfig, PolicyClient, PolicyServer,
                                  SACConfig, make_env)

    out, t0 = {}, time.monotonic()
    # in-process actors sample each call at once: one call in flight a
    # worker, 8 updates an iteration
    apex = ApexDQNConfig(num_rollout_workers=2, num_envs_per_worker=4, num_replay_shards=2,
                         rollout_fragment_length=16, max_inflight_per_worker=1,
                         updates_per_iteration=8, train_batch_size=32, seed=0,
                         device=RL_CARD, rollout_device=RL_CARD).build()
    try:
        rows = [apex.train() for _ in range(2)]
        on_card = next(apex.learner.net.parameters()).device.type
    finally:
        apex.stop()
    last = rows[-1]
    out["apex"] = dict(num_updates=last["num_updates"], env_steps=last["env_steps_total"],
                       shard_sizes=last["replay_shard_sizes"], mean_loss=last["mean_loss"],
                       worker_failures=last["worker_failures"], learner_device=on_card,
                       ms_per_iteration=[r["time_this_iter_s"] * 1e3 for r in rows])
    ok = (last["num_updates"] == 16 and last["worker_failures"] == 0
          and all(s > 0 for s in last["replay_shard_sizes"])
          and np.isfinite(last["mean_loss"]) and on_card == torch.device(RL_CARD).type)

    probe = make_env("CartPole-v1")
    server = PolicyServer(probe.observation_size, probe.num_actions, lr=1e-3,
                          learning_starts=300, train_every=8, epsilon_decay_steps=2500, seed=0,
                          device=RL_CARD)
    client = PolicyClient(server.address, timeout=30.0)
    env = make_env("CartPole-v1")
    t_server = time.monotonic()
    learner_device = server.device.type
    try:
        returns = []
        for ep in range(20):
            episode_id = client.start_episode()
            obs, _ = env.reset(seed=ep)
            done = False
            while not done:
                action = client.get_action(episode_id, obs)
                obs, reward, term, trunc, _ = env.step(action)
                client.log_returns(episode_id, reward)
                done = term or trunc
            returns.append(client.end_episode(episode_id, obs)["episode_return"])
        stats = client.get_stats()
    finally:
        client.close()
        server.stop()
    out["policy_server"] = dict(stats, returns=returns, learner_device=learner_device,
                                seconds=time.monotonic() - t_server)
    ok &= (stats["updates"] > 0 and stats["transitions"] > 300
           and learner_device == torch.device(RL_CARD).type)

    es = ESConfig(num_workers=4, population=12, sigma=0.1, lr=0.1, hidden=(32, 32), seed=0,
                  device=RL_CARD).build()
    try:
        es_rows = [es.train() for _ in range(2)]
    finally:
        es.stop()
    out["es"] = [dict(fitness_mean=r["episode_return_mean"], grad_norm=r["grad_norm"],
                      ms=r["time_this_iter_s"] * 1e3) for r in es_rows]
    ok &= all(np.isfinite(r["episode_return_mean"]) and np.isfinite(r["grad_norm"])
              for r in es_rows)

    sac = SACConfig(env="Pendulum-v1", warmup_steps=128, batch_size=64,
                    updates_per_iteration=4, rollout_fragment_length=32, num_envs_per_worker=4,
                    seed=0, device=RL_CARD, rollout_device=RL_CARD).build()
    try:
        sac_rows = [sac.train() for _ in range(3)]  # the warm-up, then 2 with updates
    finally:
        sac.stop()
    out["sac"] = [{k: v for k, v in r.items() if isinstance(v, (int, float))}
                  for r in sac_rows]
    ok &= all(np.isfinite(r["q_loss"]) and np.isfinite(r["pi_loss"]) and r["alpha"] > 0
              for r in sac_rows[1:])
    out["seconds"] = time.monotonic() - t0
    print(f"[rl] 9g apex: {last['num_updates']} updates, shards {last['replay_shard_sizes']}, "
          f"{np.mean(out['apex']['ms_per_iteration']):.1f} ms an iteration; policy server: "
          f"{stats['transitions']} transitions, {stats['updates']} updates on "
          f"{learner_device} in {out['policy_server']['seconds']:.2f} s; es fitness "
          f"{[round(r['fitness_mean'], 1) for r in out['es']]}; sac q_loss "
          f"{[round(r['q_loss'], 3) for r in out['sac'][1:]]}; {out['seconds']:.1f} s")
    if not ok:
        raise SystemExit(f"rl: an off-policy mechanics check failed: {out}")
    return out


def phase_rl(profile: bool):
    """9: the RL stack (ray_tpu_torch.rl) on the card with the default
    in-process hooks: 9a-9d on-policy, 9e-9g off-policy. The launch counts
    are set to 0 before and read after: RL runs no flash kernel."""
    _reset_launch_counts()
    t0 = time.monotonic()
    out = dict(learners=rl_learners_card_vs_cpu(), catalog=rl_catalog_card_vs_cpu(),
               ppo=rl_ppo_learns(profile), impala=rl_impala_learns(),
               offpolicy=rl_offpolicy_card_vs_cpu(), dqn=rl_dqn_learns(profile),
               mechanics=rl_offpolicy_mechanics())
    out["launches"] = dict(zip(COUNTS, _launch_counts()))
    out["seconds"] = time.monotonic() - t0
    print(f"[rl] phase 9 in {out['seconds']:.1f} s; flash launches {out['launches']}")
    if any(out["launches"].values()):
        raise SystemExit(f"rl: phase 9 launched flash kernels: {out['launches']}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write every measurement to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="profile a gpt_1b train step (dense, MoE, pipelined), a forward "
                         "and a server wave by kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models.inference import init_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t_start = time.monotonic()
    global EX2_PER_S
    EX2_PER_S = ex2_rate()
    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "ex2_per_s": EX2_PER_S}
    # the seconds each group of phases took, in order
    phase_seconds, last = {}, [t_start]

    def mark(name):
        now = time.monotonic()
        phase_seconds[name] = now - last[0]
        last[0] = now

    report["build"] = phase_build()
    mark("build")
    report["kernel_cases"] = phase_kernel_vs_plain()
    mark("kernel_cases")
    report["bwd_kernel_cases"] = phase_bwd_kernels_vs_plain()
    mark("bwd_kernel_cases")
    report["plain_design"] = phase_plain_design()
    mark("plain_design")
    report["train"] = phase_train(batch=12, seq=2048, steps=5, profile=args.profile)
    report["remat_policies"] = phase_remat_policies(report["train"], steps=2,
                                                    profile=args.profile)
    report["moe_small_vs_cpu"] = train_small_vs_cpu(
        moe_num_experts=4, moe_top_k=2, moe_capacity_factor=0.25)
    report["train_moe"] = phase_train_moe(batch=8, seq=2048, steps=3, profile=args.profile)
    report["train_gpt_j"] = phase_train_gpt_j(batch=1, seq=2048, steps=3, profile=args.profile)
    report["train_f32"] = phase_train_f32(batch=4, seq=2048, steps=2, profile=args.profile)
    report["train_nano_bf16"] = phase_train_nano_bf16(batch=512, seq=128, steps=3)
    report["train_125m"] = phase_train_125m(batch=16, seq=2048, steps=3)
    mark("train")

    cfg = gpt.gpt_1b(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    params = init_params(cfg, device="cuda", seed=0)
    fwd, report["forward"] = phase_forward(cfg, params, batch=4, seq=2048, n_forward=3)
    if args.profile:
        tokens = torch.zeros(4, 2048, dtype=torch.long, device="cuda")
        report["profile_forward"] = profile_window(
            lambda: (fwd(params, tokens), torch.cuda.synchronize()),
            "one gpt_1b forward, b=4 t=2048")
    deterministic = torch.are_deterministic_algorithms_enabled()
    report["server"] = phase_server(cfg, params, fwd, args.profile)
    if torch.are_deterministic_algorithms_enabled() != deterministic:
        raise SystemExit("the server left torch's deterministic mode changed after close()")
    report["server"]["deterministic_mode_restored"] = True
    report["device_plane"] = phase_device_plane(params)
    mark("forward_server_device_plane")
    # the closed server's pool went with it; the weights go here, by
    # reference count (7b's peak memory shows it)
    del params, fwd
    torch.cuda.empty_cache()
    report["entry_config"] = phase_entry_config(smi, report["train"])
    mark("entry_config")
    report["lse_grad"] = phase_lse_grad()
    mark("lse_grad")
    report.update(phase_sharded_ws1(report["train"], steps=3, profile=args.profile))
    mark("sharded_pp_loop")
    report["rl"] = phase_rl(args.profile)
    mark("rl")
    report["seconds"] = time.monotonic() - t_start
    report["phase_seconds"] = phase_seconds
    print(f"[done] seconds by phase group: "
          f"{ {name: round(t, 1) for name, t in phase_seconds.items()} }")

    # flash_fwd at gpt_1b's forward shape (b=4) with the forward
    # phase's launches; the backward kernels at the train step's case (b=12)
    # with the train phase's. Each entry names its case's shape and carries
    # the launches of every path. The backward kernels' plain and library
    # times are of the whole backward: both compute dq, dk and dv together.
    # ms and library_ms are device times (torch.profiler over the calls that
    # cuda_ms times), event_ms the time between events
    def case(rows, name):
        row = next(r for r in rows if r["case"] == name)
        b, h, t_q, t_kv, d = row["shape"]
        return row, dict(b=b, h=h, t_q=t_q, t_kv=t_kv, d=d, causal=row["causal"],
                         dtype=row["dtype"])

    fwd_case, fwd_shape = case(report["kernel_cases"], "gpt_1b")
    bwd_case, bwd_shape = case(report["bwd_kernel_cases"], "gpt_1b_train_b12")
    fwd_d256, fwd_d256_shape = case(report["kernel_cases"], "d256_gpt_j")
    bwd_d256, bwd_d256_shape = case(report["bwd_kernel_cases"], "d256_gpt_j")
    sharded = ("sharded_ws1", "sp_ring_ws1", "sp_ulysses_ws1")
    paths = {"train": report["train"], "remat_attn": report["remat_policies"]["attn"],
             "remat_dots": report["remat_policies"]["dots"], "train_moe": report["train_moe"],
             "train_gpt_j": report["train_gpt_j"], "train_f32": report["train_f32"],
             "train_nano_bf16": report["train_nano_bf16"], "train_125m": report["train_125m"],
             "forward": report["forward"], "server": report["server"],
             **{path: report[path] for path in sharded},
             "pp_train_ws1": report["pp_train_ws1"], "train_loop": report["train_loop"],
             "rl": report["rl"], "entry_forward": report["entry_config"]["forward"],
             "entry_train": report["entry_config"]["train"]}
    by_path = {name: {path: rep["launches"][name] for path, rep in paths.items()}
               for name in COUNTS}
    # only the plain_design phase may take the plain design
    plain = {f"{kernel}_plain": {path: n for path, n in by_path[f"{kernel}_plain"].items() if n}
             for kernel in KERNEL_NAMES}
    if any(plain.values()):
        raise SystemExit(f"a path took the plain design: {plain}")
    # the case of phases 2 and 3 that holds each kernel to its plain version
    # at the shape each path gives it (the server launches no wgmma kernel)
    train_case = {"train": "gpt_1b_train_b12", "remat_attn": "gpt_1b_train_b12",
                  "remat_dots": "gpt_1b_train_b12", "train_moe": "gpt_1b_moe_b8",
                  "train_gpt_j": "d256_gpt_j", "train_f32": "gpt_1b_f32_b4",
                  **{path: "gpt_1b_train_b12" for path in sharded},
                  "pp_train_ws1": "gpt_1b_pp_mb3", "train_loop": "gpt_1b_train_b12",
                  "entry_train": "gpt_1b_train_b12"}
    # the head_dim-256 case (train_gpt_j's shape) beside each entry's own
    d256 = {
        "flash_fwd": dict(shape=fwd_d256_shape, ms=fwd_d256["device_ms"], event_ms=fwd_d256["ms"],
                          bound_ms=fwd_d256["bound_ms"], bound_share=fwd_d256["bound_share"],
                          plain_ms=fwd_d256["plain_ms"], library_ms=fwd_d256["library_device_ms"],
                          max_abs_err=fwd_d256["max_abs_err"], row_err=fwd_d256["row_err"],
                          design=fwd_d256["design"], tiles=fwd_d256["tiles"]),
        **{f"flash_bwd_{k}": dict(shape=bwd_d256_shape, ms=bwd_d256[f"{k}_device_ms"], event_ms=bwd_d256[f"{k}_ms"],
                                  bound_ms=bwd_d256[f"{k}_bound_ms"],
                                  bound_share=bwd_d256[f"{k}_bound_share"],
                                  plain_ms=bwd_d256["plain_ms"],
                                  library_ms=bwd_d256["library_device_ms"],
                                  row_err=(bwd_d256["row_err"]["dq"] if k == "dq" else
                                           max(bwd_d256["row_err"]["dk"],
                                               bwd_d256["row_err"]["dv"])),
                                  design=bwd_d256["design"])
           for k in ("dq", "dkv")}}
    whole = "dq, dk and dv together"
    # the float32 case (train_f32's shape) on the float32 designs, with
    # train_f32's launches (its 2 timed steps): under "f32" in each entry
    # and, as the kernels of train_f32's path, entries of their own
    fwd_f32, fwd_f32_shape = case(report["kernel_cases"], "gpt_1b_f32_b4")
    bwd_f32, bwd_f32_shape = case(report["bwd_kernel_cases"], "gpt_1b_f32_b4")
    f32 = {
        "flash_fwd": dict(name="flash_fwd_f32", route="cuda", source=fwd_f32["source"],
                          replaces="ray_tpu/ops/attention.py:167",
                          launches=by_path[f"flash_fwd_{fwd_f32['design']}"]["train_f32"],
                          max_abs_err=fwd_f32["max_abs_err"], ms=fwd_f32["device_ms"], event_ms=fwd_f32["ms"],
                          plain_ms=fwd_f32["plain_ms"], bound_ms=fwd_f32["bound_ms"],
                          bound_by=fwd_f32["bound_by"], library_ms=fwd_f32["library_device_ms"],
                          bound_share=fwd_f32["bound_share"], design=fwd_f32["design"],
                          row_err=fwd_f32["row_err"],
                          row_err_ref="flash_attention_fwd_plain in float32",
                          shape=fwd_f32_shape, launches_path="train_f32"),
        **{f"flash_bwd_{k}": dict(name=f"flash_bwd_{k}_f32", route="cuda",
                                  source=bwd_f32["source"],
                                  replaces=f"ray_tpu/ops/attention.py:{line}",
                                  launches=by_path[f"flash_bwd_{k}_{bwd_f32['design']}"]
                                  ["train_f32"],
                                  max_abs_err=(bwd_f32["max_abs_err"]["dq"] if k == "dq" else
                                               max(bwd_f32["max_abs_err"]["dk"],
                                                   bwd_f32["max_abs_err"]["dv"])),
                                  ms=bwd_f32[f"{k}_device_ms"], event_ms=bwd_f32[f"{k}_ms"], plain_ms=bwd_f32["plain_ms"],
                                  bound_ms=bwd_f32[f"{k}_bound_ms"],
                                  bound_by=bwd_f32[f"{k}_bound_by"],
                                  library_ms=bwd_f32["library_device_ms"],
                                  bound_share=bwd_f32[f"{k}_bound_share"],
                                  design=bwd_f32["design"],
                                  row_err=(bwd_f32["row_err"]["dq"] if k == "dq" else
                                           max(bwd_f32["row_err"]["dk"],
                                               bwd_f32["row_err"]["dv"])),
                                  row_err_ref="flash_attention_bwd_plain in float64",
                                  shape=bwd_f32_shape, launches_path="train_f32",
                                  plain_ms_computes=whole, library_ms_computes=whole)
           for k, line in (("dq", 324), ("dkv", 394))}}
    fwd_cases = {**train_case, "forward": "gpt_1b", "entry_forward": "entry_gpt_1b_b1_t512"}
    bwd_cases = train_case
    # entry()'s forward (5b(a)): its case with 5b(a)'s launches, under
    # "entry" in flash_fwd's entry
    entry_row, entry_shape = case(report["kernel_cases"], "entry_gpt_1b_b1_t512")
    entry_fwd = dict(shape=entry_shape, launches=by_path["flash_fwd_wgmma"]["entry_forward"],
                     launches_path="entry_forward", ms=entry_row["device_ms"],
                     event_ms=entry_row["ms"], bound_ms=entry_row["bound_ms"],
                     bound_by=entry_row["bound_by"], bound_share=entry_row["bound_share"],
                     plain_ms=entry_row["plain_ms"], library_ms=entry_row["library_device_ms"],
                     max_abs_err=entry_row["max_abs_err"], row_err=entry_row["row_err"],
                     design=entry_row["design"], tiles=entry_row["tiles"])
    # 4g's kernels (bf16 at head_dim 16): the persistent forward and the
    # persistent backward pair at gpt_nano's working case, with 4g's launches
    # (its 3 timed steps), and the tiny flagship's head_dim-32 case under
    # "d32"
    def small_d(rows, name, kernel, line, path="train_nano_bf16"):
        row, shape = case(rows, name)
        if kernel == "flash_fwd":
            err, ms, event_ms = row["max_abs_err"], row["device_ms"], row["ms"]
            bound_ms, bound_by = row["bound_ms"], row["bound_by"]
            design, source = row["design"], row["source"]
        else:
            k = kernel.removeprefix("flash_bwd_")
            err = (row["max_abs_err"]["dq"] if k == "dq" else
                   max(row["max_abs_err"]["dk"], row["max_abs_err"]["dv"]))
            ms, event_ms = row[f"{k}_device_ms"], row[f"{k}_ms"]
            bound_ms, bound_by = row[f"{k}_bound_ms"], row[f"{k}_bound_by"]
            design, source = row["designs"][k], row["sources"][k]
        entry = dict(name=f"{kernel}_{design}", route="cuda", source=source,
                     replaces=f"ray_tpu/ops/attention.py:{line}",
                     launches=by_path[f"{kernel}_{design}"][path],
                     max_abs_err=err, ms=ms, plain_ms=row["plain_ms"], bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=row["library_device_ms"],
                     event_ms=event_ms, library_event_ms=row["library_ms"],
                     ex2_floor_ms=row["ex2_floor_ms"], design=design, shape=shape,
                     launches_path=path)
        if kernel != "flash_fwd":
            entry.update(plain_ms_computes=whole, library_ms_computes=whole)
        return entry

    nano = [dict(small_d(rows, "d16_nano_b512", kernel, line),
                 d32=small_d(rows, "d32_tiny_cfg_b256", kernel, line))
            for rows, kernel, line in (
                (report["kernel_cases"], "flash_fwd", 167),
                (report["bwd_kernel_cases"], "flash_bwd_dq", 324),
                (report["bwd_kernel_cases"], "flash_bwd_dkv", 394))]
    # 4h's kernels (bf16 at head_dim 64): the d64 forward, dQ and dK/dV at
    # 4h's case (b=16) with 4h's launches, b=4 under "b4"
    kernel_rows = ((report["kernel_cases"], "flash_fwd", 167),
                   (report["bwd_kernel_cases"], "flash_bwd_dq", 324),
                   (report["bwd_kernel_cases"], "flash_bwd_dkv", 394))
    d64 = [dict(small_d(rows, "d64_gpt_125m_b16", kernel, line, "train_125m"),
                b4=small_d(rows, "d64_gpt_125m", kernel, line, "train_125m"))
           for rows, kernel, line in kernel_rows]

    # the kernels of the tables' rule (every multiple of 128 from 896 up):
    # the dcluster forward, dQ and dK/dV, which this slice's
    # path runs and no model path does: 3b at 896 (bf16 and float32) and 7a
    # at 1024 (bf16). Each entry's launches are that path's at the case's
    # head_dim (BY_HEAD_DIM, counted from 0 on each of the path's runs); the
    # forward, dQ and dK/dV at d1024_b2 (bf16), d896_b2 and d2048_b2 under
    # "d896" and "d2048", the float32 cases under "f32"
    def on_path(rows, name, kernel, line, d):
        entry = small_d(rows, name, kernel, line)
        key, dtype = f"{kernel}_{entry['design']}_d{d}", case(rows, name)[0]["dtype"]
        by = {path: sum(r["launches"].get(key, 0) for r in report[path]
                        if r["dtype"].removeprefix("torch.") == dtype)
              for path in ("plain_design", "lse_grad")}
        entry.update(launches=sum(by.values()), launches_path="plain_design, lse_grad",
                     launches_by_path=by,
                     library_backend=case(rows, name)[0]["library_backend"])
        return entry

    by_rule = [dict(on_path(rows, "d1024_b2", kernel, line, 1024),
                    **{f"d{d}": on_path(rows, f"d{d}_b2", kernel, line, d)
                       for d in DSPLIT_D if d != 1024},
                    f32={f"d{d}": on_path(rows, f"d{d}_b2_f32", kernel, line, d)
                         for d in DSPLIT_D})
               for rows, kernel, line in kernel_rows]
    if any(min(e["launches"], e["d896"]["launches"], e["f32"]["d896"]["launches"]) < 1
           for e in by_rule):
        raise SystemExit("a kernel from 896 up launched no time on its path (7a at 1024 in bf16, "
                         "3b at 896 in bf16 and float32): " + str(
                             {e["name"]: (e["launches"], e["d896"]["launches"],
                                          e["f32"]["d896"]["launches"]) for e in by_rule}))
    # the bf16 backward at WIDE_D, dcluster128's dQ and dK/dV from its wgmma
    # build, which this slice's path runs (3b at each of WIDE_D, 7a at 512,
    # both in bf16) and no model path does: at d640_b2, the other head_dims'
    # cases under "d384", "d512" and "d768", each with the path's launches
    # at its head_dim
    def wgmma_named(entry):
        return dict(entry, name=f"{entry['name']}_wgmma")

    wide = [dict(wgmma_named(on_path(rows, "d640_b2", kernel, line, 640)),
                 **{f"d{d}": wgmma_named(on_path(rows, f"d{d}_b2", kernel, line, d))
                    for d in WIDE_D if d != 640})
            for rows, kernel, line in kernel_rows[1:]]
    if any(min(e["launches"], *(e[f"d{d}"]["launches"] for d in WIDE_D if d != 640)) < 1
           for e in wide):
        raise SystemExit("a bf16 backward kernel at 384 to 768 launched no time on its path "
                         "(3b, 7a): " + str({e["name"]: [e["launches"]] + [
                             e[f"d{d}"]["launches"] for d in WIDE_D if d != 640]
                                           for e in wide}))
    # the float32 backward at WIDE_D, dcluster128's dQ and dK/dV, which this
    # slice's path runs (3b at each of WIDE_D in float32) and no model path
    # does: at d640_b2_f32, the other head_dims' cases under "d384", "d512"
    # and "d768", each with 3b's launches at its head_dim
    wide_f32 = [dict(on_path(rows, "d640_b2_f32", kernel, line, 640),
                     **{f"d{d}": on_path(rows, f"d{d}_b2_f32", kernel, line, d)
                        for d in WIDE_D if d != 640})
                for rows, kernel, line in kernel_rows[1:]]
    if any(min(e["launches"], *(e[f"d{d}"]["launches"] for d in WIDE_D if d != 640)) < 1
           for e in wide_f32):
        raise SystemExit("a float32 backward kernel at 384 to 768 launched no time on its path "
                         "(3b): " + str({e["name"]: [e["launches"]] + [
                             e[f"d{d}"]["launches"] for d in WIDE_D if d != 640]
                                        for e in wide_f32}))
    # the forward at WIDE_D, dcluster128 in every dtype, which this slice's
    # path runs (3b at each of WIDE_D in bf16 and float32, 7a at 512 in
    # bf16) and no model path does: at d640_b2 (bf16), the other head_dims'
    # cases under "d384", "d512" and "d768", the float32 ones under "f32",
    # each with the path's launches at its head_dim and dtype
    fwd_rows = report["kernel_cases"]
    wide_fwd = dict(on_path(fwd_rows, "d640_b2", "flash_fwd", 167, 640),
                    **{f"d{d}": on_path(fwd_rows, f"d{d}_b2", "flash_fwd", 167, d)
                       for d in WIDE_D if d != 640},
                    f32={f"d{d}": on_path(fwd_rows, f"d{d}_b2_f32", "flash_fwd", 167, d)
                         for d in WIDE_D})
    fwd_launches = [wide_fwd["launches"]] + [wide_fwd[f"d{d}"]["launches"]
                                             for d in WIDE_D if d != 640] + [
        wide_fwd["f32"][f"d{d}"]["launches"] for d in WIDE_D]
    if min(fwd_launches) < 1:
        raise SystemExit(f"the forward at 384 to 768 launched no time on its path (3b, 7a) at "
                         f"some head_dim and dtype (bf16 640, 384, 512, 768, float32 384 to "
                         f"768): {fwd_launches}")
    kernels = {"kernels": [
        dict(name="flash_fwd", route="cuda", source=fwd_case["source"],
             replaces="ray_tpu/ops/attention.py:167",
             launches=by_path["flash_fwd_wgmma"]["forward"],
             max_abs_err=fwd_case["max_abs_err"], ms=fwd_case["device_ms"], event_ms=fwd_case["ms"],
             plain_ms=fwd_case["plain_ms"], bound_ms=fwd_case["bound_ms"],
             bound_by=fwd_case["bound_by"], library_ms=fwd_case["library_device_ms"],
             design=fwd_case["design"], tiles=fwd_case["tiles"],
             row_err=fwd_case["row_err"], row_err_tol=fwd_case["row_err_tol"],
             shape=fwd_shape, launches_path="forward",
             launches_by_path=by_path["flash_fwd_wgmma"], cases_by_path=fwd_cases,
             d256=d256["flash_fwd"], f32=f32["flash_fwd"], entry=entry_fwd),
        dict(name="flash_bwd_dq", route="cuda", source=bwd_case["source"],
             replaces="ray_tpu/ops/attention.py:324",
             launches=by_path[f"flash_bwd_dq_{bwd_case['design']}"]["train"],
             max_abs_err=bwd_case["max_abs_err"]["dq"], ms=bwd_case["dq_device_ms"], event_ms=bwd_case["dq_ms"],
             plain_ms=bwd_case["plain_ms"], bound_ms=bwd_case["dq_bound_ms"],
             bound_by=bwd_case["dq_bound_by"], library_ms=bwd_case["library_device_ms"],
             design=bwd_case["design"], shape=bwd_shape, launches_path="train",
             launches_by_path=by_path[f"flash_bwd_dq_{bwd_case['design']}"],
             cases_by_path=bwd_cases,
             row_err=bwd_case["row_err"]["dq"], row_err_tol=bwd_case["row_err_tol"],
             plain_ms_computes=whole, library_ms_computes=whole, d256=d256["flash_bwd_dq"],
             f32=f32["flash_bwd_dq"]),
        dict(name="flash_bwd_dkv", route="cuda", source=bwd_case["source"],
             replaces="ray_tpu/ops/attention.py:394",
             launches=by_path[f"flash_bwd_dkv_{bwd_case['design']}"]["train"],
             max_abs_err=max(bwd_case["max_abs_err"]["dk"], bwd_case["max_abs_err"]["dv"]),
             ms=bwd_case["dkv_device_ms"], event_ms=bwd_case["dkv_ms"], plain_ms=bwd_case["plain_ms"],
             bound_ms=bwd_case["dkv_bound_ms"], bound_by=bwd_case["dkv_bound_by"],
             library_ms=bwd_case["library_device_ms"],
             design=bwd_case["design"], shape=bwd_shape, launches_path="train",
             launches_by_path=by_path[f"flash_bwd_dkv_{bwd_case['design']}"],
             cases_by_path=bwd_cases,
             row_err=max(bwd_case["row_err"]["dk"], bwd_case["row_err"]["dv"]),
             row_err_tol=bwd_case["row_err_tol"],
             plain_ms_computes=whole, library_ms_computes=whole, d256=d256["flash_bwd_dkv"],
             f32=f32["flash_bwd_dkv"]),
        *f32.values(),
        *nano,
        *d64,
        wide_fwd,
        *wide,
        *wide_f32,
        *by_rule,
    ]}
    report.update(kernels)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(smi)
    print(f"[done] {report['seconds']:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
