#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port still builds, starts and agrees
with itself on the card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --phases card,build,kernels   # some, in order, to debug
    python3 chip_smoke.py --phases card,train           # the trainer alone
    python3 chip_smoke.py --phases card,serve_moe       # the moe family alone
    python3 chip_smoke.py --phases card,serve_ssm       # ssm and hybrid
    python3 chip_smoke.py --phases card,serve_vlm_audio # vlm and audio
    python3 chip_smoke.py --phases card,examples,mesh   # the example twins, ranks
    python3 chip_smoke.py --phases card,build,mesh,mesh_train  # across ranks
    python3 chip_smoke.py --phases card,dryrun          # the multi-pod dry run

Phases, each printing one JSON line:

  card     the card's name and power limit as nvidia-smi gives them
  build    nvcc-compiles every kernel under src/repro_torch/kernels/csrc
           (one nvcc per source, started together); per kernel its
           registers, shared memory and spills (ptxas) and its tensor-core
           instructions (cuobjdump -sass), failing where a wgmma flash
           kernel (bf16 and f16, tiles 16-256) has no HGMMA or the f64
           GEMM no DMMA
  kernels  each CUDA kernel against its plain PyTorch version on the card,
           at the shapes its main path gives it (the batched sweep's for
           abft_matmul and tile_sums, the llama3-8b prefill's for
           flash_attention) and at ragged ones, with the tolerance stated,
           timed with CUDA events beside the plain version, one library
           call and the card's bound; flash_attention also at head dims
           off its tile widths (hubert-xlarge's 80, and 48), f32 and bf16,
           causal and not, and at qwen2-vl-2b's prefill shape, q
           (2,4096,12,128) and k/v (2,4096,2,128): six query heads per KV
           head and a head count that is not a power of two, f32 and
           bf16, timed beside its bound, its plain version and SDPA.
           ssd_state_pass (the SSD's state passing, forward and backward)
           against the per-chunk loop it replaces at the benchmark's
           mamba2-130m training shape, zamba2-1.2b's layer, a TP rank's
           heads of each and ragged shapes: forward bit for bit, the
           contributions' gradient equal to the loop's autograd, the
           decays' within 1e-5 of their terms' magnitudes, two backward
           calls bit for bit; each direction timed beside its byte bound
           and the loop.
           Then every route no arch reaches, each held to its plain
           version and timed beside its bound, its plain version and its
           library call: abft_matmul's f16, mixed f16/f32 and f64-in-f32
           products at the sweep's shape and one of more row tiles than a
           launch takes; tile_sums' f16, f32-in-f64 and f64-in-f32 sums at
           the sweep's shape and a stack of more matrices than a launch
           takes; flash_attention's f16 at llama3-8b's shape, bf16 and f16
           at hd 256 and 192 (the 256 tile), bf16 and f32 at hd 100, f32
           and bf16 at hd 512 (128-column chunks), f64 and bf16/f32 mixed
           at (1, 1024, 8, 128), and f32 with B x H past grid y's 65535;
           before them the same routes at ragged shapes, f8 included
  sweep    the port's main path, ``sweep(engine="fork", mode="batched")``,
           on four workloads under the torn-crash figure's strategies and
           full plans; every cell must equal the port's ``mode="measure"``
           cell, no adcc cell may fall back, and both kernels must have
           been launched by the sweep itself
  sharded  two of those workloads again with ``workers=2``: the spawned
           children each create their own CUDA context and load the built
           libraries; they must give the serial sweep's cells and report
           launches of both kernels, and a failing shard fails the phase
  kv       the KV serving family: its int64 SplitMix64 math on the card
           bit for bit against the numpy oracle at 2^20 rows (row
           checksums at widths 7 and 15, value words of 24), then the KV
           figure's full matrix (three workloads of 48 requests, five
           strategies, no crash plus every step torn at three fractions
           twice: 4 335 cells) in ``mode="batched"``, which must equal
           ``mode="measure"`` cell for cell with no fallback, no device
           verdict overturned by the host and the figure's census gate met
  device   the ``device`` emulator backend (cache transitions on the card)
           against ``vectorized``: a streaming-prefix trace of 2 000 000
           elements where every span op must take the device path, the
           emulator benchmark's mixed trace under LRU and FIFO, and a
           batched CG sweep; images, traffic stats and cells identical
  serve    the dense LM's serving path on llama3-8b at full width and full
           depth, random weights from a seeded generator on the card:
           prefill of 2 prompts x 4096 tokens with flash attention (the
           kernel must launch once per layer), the same forward with plain
           attention beside it, 32 greedy KV-cache decode steps, and a
           teacher-forced decode of 16 prompt tokens that must give the
           plain forward's logits; the flash prefill again in float16
           compute on the same weights (the f16 route on 32 launches, each
           held to the kernel's plain version) against the float16 plain
           forward; prints tokens per second and peak memory
  serve_moe the moe family: deepseek-v2-lite-16b (MoE with latent attention)
           at full width and depth, 64.8 GB of f32 weights from a seeded
           generator on the card: prefill of 2 prompts x 1024 tokens, which
           must launch no flash_attention (MLA has no flash branch) and
           give the same logits with flash off; a teacher-forced decode of
           16 prompt tokens through the absorbed MLA path against the
           latent cache, held to the prefill's logits, and again in
           float32 compute against a float32 forward, where rounding
           cannot move routing; 16 greedy decode steps; the latent
           cache's bytes beside an expanded cache's; a profiler split of
           one prefill by group. Then kimi-k2-1t-a32b (MoE with GQA) at
           its reduced size, whose prefill launches flash_attention once
           per layer, each launch held to the kernel's plain version on
           its own inputs: in float32 the flash forward equals the plain
           one within a bound set from its reading; in bf16 each layer's
           flash output equals its plain output on the same input (tokens
           whose routing may flip at a near-tie excepted, under 5 %); a
           few decode steps
  serve_ssm the recurrent families at full width and depth, bf16
           compute, seeded weights on the card: mamba2-130m (ssm) and
           zamba2-1.2b (hybrid: Mamba2 layers and one shared attention
           block at 7 sites), each a prefill of 2 prompts x 4096 tokens;
           a teacher-forced decode of 64 prompt tokens held to the
           prefill's logits, and again in float32 compute against a
           float32 forward; 32 greedy decode steps; a profiler split of
           one prefill (projections, conv, SSD within chunks, the scan
           across chunks, attention, casts); long_500k's decode shape
           (batch 1, a step at position 524 287 and one at 16) against a
           cache of seeded values, zamba2's 30.1 GB, beside its bytes
           bound; and no launch of any kernel of the port but the SSD's
           state passing (ssd_state_pass), which every Mamba2 layer's
           prefill launches
  serve_vlm_audio the vlm and audio families at full width and depth,
           seeded weights on the card: qwen2-vl-2b's flash prefill of 2 x
           4096 (1024 patches, 3072 text tokens), whose 28 launches of
           flash_attention are each held to the kernel's plain version on
           their own q/k/v, against the plain-attention forward; a
           teacher-forced decode of 64 text tokens against a zero-patch
           prefill of them (the only prompt a text-only decode, all three
           M-RoPE streams at the cache index, reproduces), in bf16 and in
           float32 compute; 32 greedy decode steps; a profiler split.
           hubert-xlarge's forward over 2 x 4096 frames, asking for flash
           and launching nothing (not causal), its bf16 logits against
           float32 compute, no decode step or cache, a split of attention,
           gemm, casts and other. Then 3 steps of ``build_train_step`` for
           each (one-card mesh, AdamW, remat "dots", deterministic), the
           checksum chain within its bound
  examples the five example twins (``repro_torch.examples``) on the card
           through their ``main``: quickstart's crash and resume must end
           bitwise equal to an uninterrupted run, the ABFT demo's B1 and B2
           must launch, verify and find the element tampered at (5, 7),
           and no twin may give a non-finite loss; prints each twin's
           seconds and its launches per kernel (mc_xsbench at a tenth of
           its lookups, to fit the phase's budget of 150 s)
  mesh     serving across ranks. (a) each rank's own body at full width,
           for every rank of a 4-way layout on the one card: llama3-8b's
           attention (bf16, 2 x 4096) through the kernel on the heads of
           ranks 0-3 (8 query heads over the 2 KV heads they read), each
           launch held to the kernel's plain version and the four outputs,
           concatenated over heads, equal to one whole launch bit for bit;
           then the whole attention layer through ``attention_body`` in 4
           threads, each rank projecting its own query heads from its
           columns of wq and the 2 of 8 KV heads they read from its
           columns of the whole wk / wv, and multiplying by its rows of
           wo, the ranks' outputs summed in float32 in this process where
           the mesh sums them over "model", within 2 bf16 ulps of the
           layer output's largest value of one card's layer, each B3
           launch held to its plain version, each rank's materialised
           weight bytes beside the whole layer's, the KV heads of each
           rank's launch and the rank body's ms beside its figure from
           before the ranks projected only their KV heads
           (MESH_LAYER_PARENT_MS); one decode step of that layer on a
           cache of 2 x 4096 positions split by KV heads, each of the 4
           rank bodies in a thread on its own 2 of the 8 KV heads,
           projecting only those (256 of wk's and wv's 1024 columns),
           the outputs summed in float32 against one card's decode step
           on the whole cache and each rank's new cache entries against
           its heads of the whole cache's, both within the same 2 bf16
           ulps, the rank body's decode ms beside one card's;
           phi4-mini-3.8b's attention layer at full
           width through ``attention_body`` for the 16 ranks of tp = 16,
           which does not tile its 24 query heads: 8 blocks of 3 heads, 2
           ranks a block, each rank scoring its block's 3 heads from the
           block's columns of wq and multiplying its share of their output
           by its own rows of wo, the 16 outputs summed against one card's
           plain layer within the same 2 bf16 ulps, each rank's scored
           heads, score bytes, peak memory and ms beside the whole
           layer's; zamba2-1.2b's Mamba2 layer at full width (bf16, 2 x
           4096) through ``mamba2_body`` for the 16 ranks of tp = 16, each
           running the SSD for the 4 of 64 heads its rows of out_proj read
           (``mamba2.ssd_heads``), the 16 outputs summed against one
           card's layer within the same 2 bf16 ulps, each rank's SSD
           heads, peak memory and ms beside the whole layer's; one
           deepseek-v2-lite-16b MoE layer (64
           experts, 16 per rank, K = 6; 2 x 1024 tokens, float32) through
           the EP body of 4 ranks, each handed its own 16 experts' stacks,
           with an all-to-all between threads of this script, equal to
           moe_apply_dense within 1e-5 where nothing drops, and its drop
           share at the config's capacity factor. (b) the distributed path
           at world size 1: an NCCL process group of one rank and
           ``make_mesh((1, 1), ("data", "model"))``; deepseek-v2-lite-16b at
           full width and depth (2 x 1024) through ``moe_apply_ep`` with a
           real ``all_to_all_single``, equal bit for bit to the one-card
           path, then llama3-8b's flash prefill (2 x 4096) through
           ``flash_sdpa`` with the mesh, equal bit for bit to the one-card
           prefill
  mesh_train
           training across ranks at world size 1: an NCCL process group of
           one rank and ``make_mesh((1, 1), ("data", "model"))``; the ADCC
           trainer at llama3-8b's full width (2 of 32 layers, 2 x 4096)
           and at deepseek-v2-lite-16b's full width (2 of 27 layers, 2 x
           1024, on ``moe_apply_ep``), AdamW, remat "dots": each trainer's
           steps through the mesh (parameters and optimizer state placed
           as DTensors, the loss's numerator and count summed over "data",
           the gradients reduced by the layers' placements) must equal the
           one-card trainer's bit for bit, in every ledger record (loss
           and every checksum) and in the final parameters; for llama3-8b
           slots after steps 1 and 3, the newer torn, and a restart
           through the mesh that rejects it, recovers the step-1 slot and
           ends bitwise equal too. Prints the step seconds through the
           mesh beside the one-card step's (the first step, which sets up
           NCCL, apart) and the peak memory of each
  dryrun   the multi-pod dry run (``python -m repro_torch.launch.dryrun
           --all --mesh both`` in 8 spawned workers that see no card): all
           62 cells of the ten archs on fake process groups of 256 and 512
           ranks, rank 0's program on meta tensors, each OK, the 18 skips
           the reference's reasons letter for letter; per cell the rank's
           arguments plus its peak of live bytes in GB against one card's
           80, its FLOPs and its collective bytes. Then the grounding:
           llama3-8b at full width and depth, a plain-attention prefill of
           2 x 4096 on a one-rank NCCL mesh, whose dry run on a fake group
           of one must predict the bytes its placed weights and batch
           allocate exactly, and its peak within a factor of 2; the dry
           run's FLOPs over the measured seconds give its TFLOP/s beside
           the card's 989 (dense bf16). Budget: 120 s
  train    the ADCC trainer (``ADCCTrainer.run``) at llama3-8b's full width
           with depth cut to 2 of 32 layers (1 where the disk cannot hold
           two slots), random weights from a seeded generator on the card,
           AdamW, remat "dots", batch 2 x 4096, a slot every 2 steps, 2
           slots, each workdir in a temporary directory removed after use:
           6 steps without fault tolerance; 4 ADCC steps, the newest slot
           torn, and a new trainer that must reject it, verify the step-1
           slot, replay steps 2-5 and end bitwise equal to the first run;
           every ledger record within the linearity chain; 6 steps of the
           synchronous-checkpoint baseline. Prints per mode the step
           times with and without a slot, the ledger appends, the host
           copies, the writer's and the recovery's seconds, peak memory,
           a profiled step and the cost of deterministic algorithms. Then
           deepseek-v2-lite-16b at full width, 2 of 27 layers (19 GB slots),
           the same batch and options, its MoE layers on the trainer's
           one-card mesh (the expert-parallel path with capacity drops,
           whose share is printed): 6 uninterrupted steps, and the ADCC
           crash with a torn newest slot whose recovery must end bitwise
           equal; then the same for mamba2-130m at full width and depth
           (1.5 GB slots) and zamba2-1.2b at full width and depth (14 GB
           slots) at 2 x 2048, the length its shared block's plain
           attention leaves room for

Any failed check raises, so the exit code is non-zero and no result line
is printed. Without a CUDA card the script exits at once with code 2.
The last line of a full run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# the train phase runs with deterministic algorithms, which need cuBLAS's
# fixed workspace in the environment before the process's first cuBLAS
# call (repro_torch/launch/steps.py)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False; this "
                     "script runs the port on a CUDA card and has no CPU "
                     "mode\n")
    sys.exit(2)

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core.backends import batched  # noqa: E402
from repro_torch.core.nvm import CrashEmulator, NVMConfig  # noqa: E402
from repro_torch.kernels import _build, launch_counts  # noqa: E402
from repro_torch.kernels.abft_matmul import kernel as mm_kernel  # noqa: E402
from repro_torch.kernels.abft_matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.checksum_verify import kernel as cv_kernel  # noqa: E402
from repro_torch.kernels.checksum_verify import ops as cv_ops  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ss_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ss_ops  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.acc_state import (ChecksumLedger,  # noqa: E402
                                        LedgerRecord, flatten_checksums)
from repro_torch.launch.specs import make_batch  # noqa: E402
from repro_torch.launch.mesh import single_device_mesh  # noqa: E402
from repro_torch.launch.steps import (build_train_step,  # noqa: E402
                                      tree_checksums)
from repro_torch.launch.train import ADCCTrainer  # noqa: E402
from repro_torch.models.carry import (opt_tree, reference_tree,  # noqa: E402
                                      tree_items)
from repro_torch.models import build_model, get_config, list_archs  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.models import hybrid as hybrid_mod  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models import lm as lm_mod  # noqa: E402
from repro_torch.models import mla as mla_mod  # noqa: E402
from repro_torch.models import mamba2 as mamba2_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.scenarios import (CrashPlan, TornSpec,  # noqa: E402
                                   deterministic_cell_dict, sweep)
from repro_torch.scenarios import batched_engine, driver  # noqa: E402

PHASES = ("card", "build", "kernels", "sweep", "sharded", "kv", "device",
          "serve", "serve_moe", "serve_ssm", "serve_vlm_audio", "examples",
          "mesh", "mesh_train", "dryrun", "train")

# tensor-core instructions counted in each kernel's SASS, and the kernels
# that must have them: library -> (name in the kernel's symbol, kinds)
MMA_KINDS = ("HGMMA", "HMMA", "DMMA")
MMA_REQUIRED = {"flash_attention": ("flash_fwd_wgmma_kernel", ("HGMMA",)),
                "abft_matmul": ("abft_mm_f64_dmma_kernel", ("DMMA",))}
# instantiations that must be among them (template arguments as mangled):
# the flash kernel in bf16 and f16, at tile widths 128 and 256
MMA_INSTANCES = {"flash_attention": tuple(
    f"flash_fwd_wgmma_kernel<{e}Li{hd}E>"
    for e in ("13__nv_bfloat16", "6__half") for hd in (128, 256))}

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the bounds
# below are stated against these whatever the card's power limit is.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12,     # FP64 tensor-core rate, the
              torch.float32: 67e12,     # card's highest for the type
              torch.bfloat16: 989e12,
              torch.float16: 989e12}

# the serving phase: llama3-8b at full width and depth, the prefill shape
# of the flash kernel's record
SERVE_ARCH = "llama3-8b"
SERVE_BATCH, SERVE_PROMPT = 2, 4096
SERVE_DECODE_STEPS = 32
SERVE_TEACHER_TOKENS = 16
SERVE_SEED = 12
# bf16 logits of the flash forward, and of a teacher-forced decode, against
# the plain-attention forward on the same weights. The two paths round at
# other points (the plain one rounds the probabilities to bf16 before P.V,
# the kernel keeps them in f32) and cuBLAS sums 2 decode rows in another
# order than 8192 prefill rows. On an H100 the full-depth model gave 0.0176
# (flash) and 0.0210 (teacher-forced) with a largest logit of 1.38, and
# greedy argmax agreement of 97.6 % and 96.9 %: the bounds sit at about
# 2.5 x the readings, and the argmax share must stay above 90 %.
SERVE_ATOL = 0.05
SERVE_ARGMAX_FLOOR = 0.9
# the same prefill in float16 compute on the same weights (the f16 route of
# the flash kernel on a real model's 32 launches), against the plain
# forward in float16. Set before its first run: f16 keeps 3 more mantissa
# bits than bf16 at every rounding of the residual stream and of the
# kernel's output, so the bf16 reading of 0.0176 should shrink about
# eightfold, to near 0.002; the bound sits at five times that, and the
# argmax share must stay above the bf16 floor.
SERVE_F16_ATOL = 0.01

# the moe serving phase: deepseek-v2-lite-16b at full width and full depth
# (27 layers, 16.21e9 f32 parameters, 64.8 GB), prompts 2 x 1024
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_BATCH, MOE_PROMPT = 2, 1024
MOE_DECODE_STEPS = 16
MOE_TEACHER_TOKENS = 16
MOE_SEED = 16
# Teacher-forced decode (MLA absorbed into the latent cache, 2 tokens a
# step) against the prefill's logits (MLA expanded, 2048 tokens), bf16.
# The two paths round at other points, and a token whose K-th and
# (K+1)-th router probabilities are that close then takes another expert
# in one of them, which moves its logits far beyond a rounding step: on
# the CPU the reference itself differs so by 0.04-1.28 on deepseek
# reduced, logits near 2.5 (tests/test_torch_moe.py). On an H100 the
# full model gave 0.264 with a largest logit of 1.18 and argmax agreement
# on 26 of the 32 tokens (81 %): the bound sits at 2.5 x the reading, the
# floor 3 tokens below it.
MOE_TEACHER_ATOL = 0.66
MOE_TEACHER_ARGMAX_FLOOR = 0.7
# The same teacher-forced decode in float32 compute on the same weights,
# against a float32 forward of the same tokens: rounding no longer moves
# routing, so the check sees MLA's absorbed path itself (its scale, its
# RoPE term, its probability cast). A token may route differently in the
# two only where its margin is below MOE_F32_ROUTING_MARGIN (float32
# noise on the probabilities is about 1e-7); the logits are compared at
# the positions before a sequence's first such token, which no routing
# difference can reach under causal attention. On an H100 the full model
# gave 2.67e-6 (largest logit 1.07), no token routed differently in 864
# decisions, argmax agreement 100 %: the bound sits at 3.7 x the reading
# (the CPU tests hold the reduced model at 1e-4).
MOE_F32_ROUTING_MARGIN = 1e-5
MOE_F32_TEACHER_ATOL = 1e-5
# kimi-k2 at its reduced size: the moe family's flash branch
KIMI_ARCH = "kimi-k2-1t-a32b"
KIMI_BATCH, KIMI_PROMPT = 2, 1024
KIMI_DECODE_STEPS = 4
KIMI_SEED = 17
# bf16 flash against plain, layer by layer: tokens routed alike by the
# routing rule of repro_torch.models.moe (same_routing, check_flip_share),
# their outputs within two bf16 ulps of the layer's largest output
# (tests/test_torch_moe.py holds the port to the reference so); and every
# flash launch of the prefills held against the kernel's plain version on
# its own q/k/v at the kernel's tolerances. float32 flash against plain,
# the whole model: 2.5 x the reading of 8.3e-6 on an H100.
KIMI_F32_ATOL = 2.1e-5

# the recurrent families' serving phase: mamba2-130m (ssm) and zamba2-1.2b
# (hybrid) at full width and depth, prompts 2 x 4096
SSM_ARCHS = ("mamba2-130m", "zamba2-1.2b")
SSM_BATCH, SSM_PROMPT = 2, 4096
SSM_DECODE_STEPS = 32
SSM_TEACHER_TOKENS = 64
SSM_SEED = 18
# Teacher-forced decode (the recurrent update, one token a step) against
# the prefill's chunked SSD, bf16. The two paths round at other points
# (the prefill's chunk products in float32 over 128 positions, the
# decode's state update a token at a time; cuBLAS sums 2 rows and 8192
# in other orders). On the CPU, mamba2-130m at full width (prompt 128,
# 32 tokens) gave 0.087 on logits up to 5.2 and 97 % argmax agreement,
# zamba2-1.2b at 8 of its 38 layers 0.012 and 100 %: the bound is 3.5 x
# the larger reading, the floor 12 points under the lower agreement.
SSM_TEACHER_ATOL = 0.3
SSM_TEACHER_ARGMAX_FLOOR = 0.85
# The same in float32 compute on the same weights, against a float32
# forward of the 64 tokens: the CPU gave 9.8e-6 (mamba2-130m) and 3.3e-6
# (zamba2, 8 layers); the bound is 10 x the larger.
SSM_F32_TEACHER_ATOL = 1e-4
# long_500k's decode shape: batch 1, a step at the last position
LONG_SHAPE = SHAPES["long_500k"]
LONG_SHORT_POS = 16
LONG_REPS = 5

# the vlm and audio families' serving phase, full width and depth:
# qwen2-vl-2b (M-RoPE over 1024 patch embeddings, then 3072 text tokens;
# its flash prefill runs B3 at six query heads per KV head) and
# hubert-xlarge (a bidirectional encoder over frame embeddings)
VLM_ARCH, AUDIO_ARCH = "qwen2-vl-2b", "hubert-xlarge"
VA_BATCH, VA_PROMPT = 2, 4096
VLM_DECODE_STEPS = 32
VLM_TEACHER_TOKENS = 64
VA_SEED = 19
# Bounds set before the first run on a card, from CPU readings of the
# same checks (both archs at full width, 8 layers, bf16, prompts 2 x
# 128; at reduced() the readings are smaller: 0.014, 0.0 and 0.024):
# qwen2-vl's flash forward against its plain-attention forward 0.039,
# argmax agreement 97.7 %; its teacher-forced decode of 64 tokens
# against a zero-patch prefill (three equal M-RoPE streams, the only
# prompt a text-only decode reproduces) 0.031, 97.7 %, and 3.9e-6 in
# float32 compute; hubert's bf16 forward against its float32-compute
# forward 0.051, 99.2 %. The bf16 bounds are 3.5 x the readings, the
# float32 one 10 x, as for the recurrent families; the argmax floors are
# llama's 90 % (a forward against a forward) and 85 % (teacher-forced).
VLM_FLASH_ATOL = 0.14
VLM_TEACHER_ATOL = 0.11
VLM_F32_TEACHER_ATOL = 4e-5
AUDIO_BF16_ATOL = 0.18
# train steps of each through build_train_step on the one-card mesh,
# AdamW, remat "dots", deterministic algorithms; three steps give two
# links of the checksum chain
VA_TRAIN_SEQ = 4096
VA_TRAIN_STEPS = 3

# the examples phase: each twin's main on the card, its own defaults but
# mc_xsbench's lookups (a tenth: repro's example takes about 4 minutes on
# a CPU at 60 000), within a budget of 150 s for the phase
EXAMPLE_RUNS = (("quickstart", []), ("cg_crash_recovery", []),
                ("abft_matmul_demo", []),
                ("mc_xsbench", ["--lookups", "6000"]),
                ("train_e2e", []))
EXAMPLES_BUDGET_S = 150.0

# the mesh phase: a 4-way layout's per-rank bodies on the one card, at
# llama3-8b's attention (2 x 4096, bf16) and one deepseek-v2-lite-16b MoE
# layer (2 x 1024 tokens, float32); then the distributed path at world
# size 1 on deepseek-v2-lite-16b (2 x 1024) and llama3-8b (2 x 4096)
MESH_TP = 4
MESH_EP = 4
MESH_SEED = 20
# float32, summation order only (the grouped windows' products against
# the dense einsum over the same experts)
MESH_EP_ATOL = 1e-5
# the TP attention layer against one card's: two bf16 ulps (2 * 2^-7) of
# the output's largest value. Each rank's share of the output is a bf16
# product rounded once, as the whole layer's is; their float32 sum adds
# at most the roundings of the four shares
MESH_LAYER_RTOL = 2 * 2.0 ** -7
# a TP rank's body of that layer while every rank projected all 8 KV
# heads: the least and most of two runs on an H100 80GB HBM3 at 700.00 W
# (PERF.md section 5), printed beside this run's, where each rank
# projects the 2 its query heads read
MESH_LAYER_PARENT_MS = (1.255, 1.524)
# the decode step of that layer at tp = MESH_TP on a cache split by KV
# heads (8 over 4 ranks: 2 a rank, as the decode rules place a cache whose
# KV heads the TP degree divides), a cache of MESH_DECODE_LEN positions
# a row, held by the same rule
MESH_DECODE_LEN = 4096
# the head blocks of a TP degree that does not tile the query heads:
# phi4-mini-3.8b's attention layer at the production TP of 16 (24 heads:
# gcd(24, 16) = 8 blocks of 3, 2 ranks a block), held by the same rule
MESH_BLOCK_ARCH = "phi4-mini-3.8b"
MESH_BLOCK_TP = 16
# the SSD heads of a Mamba2 layer split over "model": zamba2-1.2b's layer
# at the production TP of 16 (64 heads, 4 a rank), held by the same rule
MESH_SSD_ARCH = "zamba2-1.2b"
MESH_SSD_TP = 16

# the mesh_train phase: (arch, depth cuts, sequence, crash and restart) of
# the trainers held to the one-card trainer through a mesh of one rank
MESH_TRAIN_RUNS = (("llama3-8b", (2, 1), 4096, True),
                   ("deepseek-v2-lite-16b", (2, 1), 1024, False))
# llama3-8b: 4 steps, slots after steps 1 and 3, the newer then torn;
# deepseek: 3 steps and no slot
MESH_TRAIN_STEPS = {True: 4, False: 3}

# the train phase: the ADCC trainer at llama3-8b's full width with depth
# cut to 2 of 32 layers (1 where the disk cannot hold two slots of 2),
# AdamW, remat "dots", batch 2 x the train_4k sequence length
# the dry run (repro_torch.launch.dryrun): every cell of both production
# meshes, run by the module's command line in spawned workers that see no
# card, with the reference's skips (src/repro/launch/dryrun.py) held here
# as literals; then one program of it grounded on the card
DRYRUN_WORKERS = min(8, os.cpu_count() or 1)
DRYRUN_BUDGET_S = 120.0
DRYRUN_CELLS = 62
_ENCODER_SKIP = "skip: encoder-only arch has no decode step"
_FULL_ATTENTION_SKIP = ("skip: full-attention arch — 500k decode needs "
                        "sub-quadratic attention (DESIGN.md §4)")
DRYRUN_SKIPS = {("hubert-xlarge", "decode_32k"): _ENCODER_SKIP,
                ("hubert-xlarge", "long_500k"): _ENCODER_SKIP,
                **{(arch, "long_500k"): _FULL_ATTENTION_SKIP for arch in (
                    "granite-8b", "phi4-mini-3.8b", "granite-3-8b",
                    "llama3-8b", "deepseek-v2-lite-16b", "kimi-k2-1t-a32b",
                    "qwen2-vl-2b")}}
# the grounding: llama3-8b at full width and depth, plain-attention
# prefill of 2 x 4096 on a one-rank mesh, predicted on a fake group of one
GROUND_ARCH = "llama3-8b"
GROUND_BATCH, GROUND_SEQ = 2, 4096
GROUND_SEED = 24
GROUND_PEAK_RATIO = (0.5, 2.0)
# dense bf16 tensor-core peak of an H100 SXM, TFLOP/s (no sparsity)
H100_BF16_TFLOPS = 989.0

TRAIN_ARCH = "llama3-8b"
TRAIN_LAYERS = (2, 1)
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
TRAIN_STEPS, TRAIN_CRASH_RUN = 6, 4
TRAIN_SLOT_EVERY, TRAIN_SLOTS = 2, 2
TRAIN_SEED = 15
# and deepseek-v2-lite-16b at full width, 2 of 27 layers, the same batch,
# its MoE layers on the trainer's one-card mesh (the expert-parallel path
# with capacity drops, as the reference's trainer runs them)
MOE_TRAIN_ARCH = "deepseek-v2-lite-16b"
# and the recurrent families at full width and depth: mamba2-130m at the
# same batch; zamba2-1.2b at 2 x 2048, since its shared block's plain
# attention keeps two float32 (B, 32, S, S) tensors for the backward pass
# at each of its 7 sites (60 GB at 2 x 4096)
ZAMBA_TRAIN_SEQ = 2048
# (arch, depth cuts to try or None for full depth, sequence, baselines)
TRAIN_RUNS = ((TRAIN_ARCH, TRAIN_LAYERS, TRAIN_SEQ, True),
              (MOE_TRAIN_ARCH, TRAIN_LAYERS, TRAIN_SEQ, False),
              ("mamba2-130m", None, TRAIN_SEQ, False),
              ("zamba2-1.2b", None, ZAMBA_TRAIN_SEQ, False))

# flash_attention against its plain version: bf16 two bf16 ulps of the
# value (rtol 1.6e-2, atol 1e-5), f32 1e-5; the reasons stand beside the
# numbers in the kernel's module, which the CPU tests read too
FLASH_BF16_RTOL, FLASH_BF16_ATOL = fa_kernel.BF16_RTOL, fa_kernel.BF16_ATOL
FLASH_F16_RTOL, FLASH_F16_ATOL = fa_kernel.F16_RTOL, fa_kernel.F16_ATOL
FLASH_F32_TOL = fa_kernel.F32_TOL
# head dims off the kernel's tile widths at a prefill's size: hubert-
# xlarge's attention (16 heads of 80, run in the 128-column tile) and 48
# (in the 64-column tile)
FLASH_HD_SHAPES = ((2, 4096, 16, 80), (2, 4096, 16, 48))

# the torn-crash figure's sweep axes (benchmarks/fig_torn.py, full size)
TORN_SEED = 23
TORN_FRACTIONS = (0.0, 0.25, 0.5, 0.75, 1.0)
TORN_SAMPLES = 3
STRATEGIES = ("adcc", "undo_log", "checkpoint_nvm@2")
WORKLOADS = (
    ("cg", {"n": 4096, "iters": 12, "seed": 5}),    # largest dense-route system
    ("cg", {"n": 2048, "iters": 12, "seed": 5}),    # the torn-crash figure's
    ("mm", {"n": 1024, "k": 256, "seed": 1024}),    # the recompute figure's largest
    ("mm", {"n": 64, "k": 16, "seed": 2}),          # the torn-crash figure's
)

# the KV phase: the integer math at 2^20 rows, then the KV figure's full
# matrix (benchmarks/fig_kv.py: WORKLOADS, STRATEGIES, FRACTIONS, SAMPLES,
# SEED, a 1 MiB cache)
KV_MATH_ROWS = 1 << 20
KV_VALUE_WORDS = 24
KV_MATH_SEED = 14
I64 = np.iinfo(np.int64)
# words with the top bit set, all bits set, the largest positive, and
# keys whose high bits overflow ``key << 21``
KV_EXTREMES = np.array([-1, I64.max, I64.min, 1 << 62, -(1 << 43),
                        (1 << 43) - 1, 0x5555555555555555, 0, 1],
                       dtype=np.int64)
KV_SEED = 31
KV_FRACTIONS = (0.25, 0.5, 0.75)
KV_SAMPLES = 2
KV_WORKLOADS = (
    ("kv", {"profile": "etc", "n_steps": 48, "seed": 11}),
    ("kv", {"profile": "udb", "n_steps": 48, "seed": 11}),
    ("kv", {"profile": "udb", "n_steps": 48, "seed": 11, "policy": "blind"}),
)
KV_STRATEGIES = ("none", "adcc", "undo_log", "checkpoint_nvm@4",
                 "shadow_snapshot")
# the figure's census gate: strategies that keep the acknowledged prefix
# by construction never give a durability or atomicity violation cell
KV_CLEAN_STRATEGIES = ("adcc", "shadow_snapshot", "undo_log")
KV_VIOLATION_CLASSES = ("durability_violation", "atomicity_violation",
                        "torn_corrupt", "lost_updates")

# the device phase: the sweep benchmark's streaming-prefix trace
# (benchmarks/scenarios_sweep.py) and the emulator benchmark's default
# mixed trace (benchmarks/emu_bench.py)
PREFIX_ELEMS, PREFIX_PASSES = 2_000_000, 6
EMU_ELEMS, EMU_OPS, EMU_CACHE_FRAC, EMU_SEED = 1_000_000, 2000, 0.5, 0
DEVICE_SWEEP_WORKLOAD = WORKLOADS[1]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events,
    after two warm-up calls. The operands used here exceed the L2 cache,
    so every call finds them in device memory."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(got, want) -> float:
    return float((got.to(torch.float64) - want.to(torch.float64)).abs().max())


def check_close(name, got, want, rtol, atol) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs plain "
                             f"{want.shape}/{want.dtype}")
    g, w = got.to(torch.float64), want.to(torch.float64)
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite values from the kernel")
    bad = (g - w).abs() > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max abs err {max_abs_err(got, want)} "
                             f"(rtol {rtol}, atol {atol})")
    return max_abs_err(got, want)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card() -> None:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    print(out.strip().splitlines()[0], flush=True)


def _ptxas_resources(log: str) -> dict:
    """Per kernel (mangled name): registers, static shared memory and spill
    bytes from the ``-Xptxas -v`` log of its library."""
    out, fn = {}, None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '(\S+)'", line)
        if hit:
            fn = hit.group(1)
            out[fn] = {"registers": None, "smem_static_bytes": 0,
                       "spill_store_bytes": 0, "spill_load_bytes": 0}
            continue
        if fn is None:
            continue
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        line)
        if hit:
            out[fn]["spill_store_bytes"] = int(hit.group(1))
            out[fn]["spill_load_bytes"] = int(hit.group(2))
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            out[fn]["registers"] = int(hit.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[fn]["smem_static_bytes"] = int(smem.group(1)) if smem else 0
    return out


def _kernel_label(symbol: str) -> str:
    """``name<template arguments>`` of a mangled kernel symbol, the
    arguments as mangled, e.g. ``flash_fwd_mma_kernel<Li128E>``."""
    end = symbol.find("_kernel")
    if end < 0:
        return symbol
    end += len("_kernel")
    # the name is preceded by its length in decimal
    for start in range(end - 1, 0, -1):
        if symbol[:start].endswith(str(end - start)):
            args = re.match(r"I(.*?)EEv", symbol[end:])
            return symbol[start:end] + (f"<{args.group(1)}>" if args else "")
    return symbol


def _sass_mma_counts(path) -> dict:
    """Per kernel (mangled name) of a built library, how many tensor-core
    instructions of each kind ``cuobjdump -sass`` shows."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        hit = re.match(r"\s*Function : (\S+)", line)
        if hit:
            fn = hit.group(1)
            out[fn] = dict.fromkeys(MMA_KINDS, 0)
            continue
        hit = re.search(r"\b(" + "|".join(MMA_KINDS) + r")\b", line)
        if fn is not None and hit:
            out[fn][hit.group(1)] += 1
    return out


def phase_build() -> None:
    """Builds every library, then states for each kernel in it the
    registers, shared memory and spills (ptxas) and the tensor-core
    instructions (SASS); fails where a kernel that must run on the tensor
    cores has none."""
    t0 = time.perf_counter()
    built = _build.build_all()
    seconds = time.perf_counter() - t0
    kernels = {}
    for name, info in built.items():
        res = _ptxas_resources(info["log"])
        for fn, counts in _sass_mma_counts(info["path"]).items():
            kernels[_kernel_label(fn)] = {"library": name, **res.get(fn, {}),
                                          **counts}
    for lib, (marker, kinds) in MMA_REQUIRED.items():
        found = {fn: k for fn, k in kernels.items()
                 if k["library"] == lib and fn.startswith(marker + "<")}
        if not found or any(sum(k[x] for x in kinds) == 0
                            for k in found.values()):
            raise AssertionError(f"{lib}: no {'/'.join(kinds)} instruction in "
                                 f"the SASS of {marker}: {found}")
        missing = [fn for fn in MMA_INSTANCES.get(lib, ()) if fn not in found]
        if missing:
            raise AssertionError(f"{lib}: no instantiation {missing} among "
                                 f"{sorted(found)}")
    emit({"phase": "build", "seconds": seconds,
          "sources": {name: {"seconds": info["seconds"],
                             "built": info["built"]}
                      for name, info in built.items()},
          "kernels": kernels})


def _mm_tolerance(c_dtype, acc) -> tuple:
    """``(rtol, atol)`` of abft_matmul's C against the plain version: the
    accumulator's summation order (float64 ``1e-12``, float32 ``1e-4 /
    1e-3``, the order of a float32 accumulation over k terms), or where C
    is narrower, two ulps of C's rounding (bfloat16 ``2e-2``, float16
    ``2e-3``). The checksums stay in the accumulator; their atol scales
    with k like the reference's tests."""
    if c_dtype == torch.bfloat16:
        return 2e-2, 2e-2
    if c_dtype == torch.float16:
        return 2e-3, 2e-3
    if acc == torch.float64 and c_dtype == torch.float64:
        return 1e-12, 1e-12
    return 1e-4, 1e-3


def _matmul_checks(dev) -> list:
    """abft_matmul's kernel at ragged shapes and every kind of type pair
    (operands f16 / bf16 / f32 / f64, of one type or two, accumulated in
    f32 or f64): product and both checksums against the plain version, at
    ``_mm_tolerance``; then the public ``abft_matmul``, which accumulates
    in float32 whatever its inputs (the reference's), on float64."""
    out = []
    f16, bf16 = torch.float16, torch.bfloat16
    f32, f64 = torch.float32, torch.float64
    for (m, k, n), a_dtype, b_dtype, acc, views in (
            ((257, 129, 65), f32, f32, f32, False),
            ((100, 130, 70), f32, f32, f32, False),
            ((256, 384, 128), bf16, bf16, f32, False),
            ((1, 512, 1), f32, f32, f32, False),
            ((1, 512, 1), bf16, bf16, f32, False),
            ((257, 129, 65), f64, f64, f64, False),
            ((100, 130, 70), f64, f64, f64, False),
            # odd k and n as views with even row strides: the f64 kernel's
            # 16-byte copies then end in half-filled chunks
            ((96, 61, 63), f64, f64, f64, True),
            # the types the reference's wrapper also takes
            ((257, 129, 65), f16, f16, f32, False),
            ((100, 130, 70), f16, f32, f32, False),     # mixed: f16 -> f32
            ((96, 61, 63), bf16, f64, f32, True),       # C f32 -> bf16
            ((100, 130, 70), f64, f64, f32, False),     # f64 in f32
            ((257, 129, 65), f32, f32, f64, False),
            ((100, 130, 70), f16, f16, f64, False),
            ((96, 61, 63), f16, f32, f64, True),        # C f64 -> f16
            ((1, 512, 1), f16, bf16, f32, False)):      # both -> f32
        rng = np.random.default_rng(m * 7 + k * 3 + n)
        pad = 1 if views else 0
        a = torch.from_numpy(rng.normal(size=(m, k + pad))
                             ).to(dev, a_dtype)[:, :k]
        b = torch.from_numpy(rng.normal(size=(k, n + pad))
                             ).to(dev, b_dtype)[:, :n]
        c, rowp_k, colp_k = mm_kernel.abft_matmul_cuda(a, b, acc_dtype=acc)
        row, col = rowp_k.sum(dim=1), colp_k.sum(dim=0)
        cp, rowp, colp = mm_kernel.abft_matmul_plain(a, b, acc_dtype=acc)
        rtol, atol = _mm_tolerance(a_dtype, acc)
        crtol, catol = _mm_tolerance(acc, acc)
        name = (f"abft_matmul{(m, k, n)}/{str(a_dtype)[6:]}"
                f"{'' if b_dtype == a_dtype else '@' + str(b_dtype)[6:]}"
                f" in {str(acc)[6:]}")
        errs = [check_close(name + " C", c, cp, rtol, atol),
                check_close(name + " row", row, rowp, crtol, catol * k),
                check_close(name + " col", col, colp, crtol, catol * k)]
        out.append({"case": name, "max_abs_err": max(errs),
                    "rtol": rtol, "atol": atol})
    rng = np.random.default_rng(64)
    a = torch.from_numpy(rng.normal(size=(100, 130))).to(dev)
    b = torch.from_numpy(rng.normal(size=(130, 70))).to(dev)
    c, row, col = mm_ops.abft_matmul(a, b)
    cp, rowp, colp = mm_kernel.abft_matmul_plain(a, b, acc_dtype=f32)
    if c.dtype != f64 or row.dtype != f32 or col.dtype != f32:
        raise AssertionError(f"abft_matmul f64: {c.dtype}/{row.dtype}, the "
                             f"reference gives float64/float32")
    name = "abft_matmul (100, 130, 70)/float64, float32 accumulator"
    out.append({"case": name, "rtol": 1e-4, "atol": 1e-3, "max_abs_err": max(
        check_close(name + " C", c, cp, 1e-4, 1e-3),
        check_close(name + " row", row, rowp, 1e-4, 1e-3 * 130),
        check_close(name + " col", col, colp, 1e-4, 1e-3 * 130))})
    # gemm_batch in f64 as the sweep calls it: wave widths below, across and
    # far above the 64-row tile at the largest operator, and a smaller one;
    # the tolerance of the record below
    for W, n in ((1, 4096), (193, 4096), (2048, 4096), (512, 2048)):
        rng = np.random.default_rng(W * 13 + n)
        Z = torch.from_numpy(rng.normal(size=(W, n))).to(dev)
        S = torch.from_numpy(rng.normal(size=(n, n))).to(dev)
        want, _, _ = mm_kernel.abft_matmul_plain(Z, S, acc_dtype=torch.float64)
        name = f"gemm_batch f64 ({W},{n})@({n},{n})"
        out.append({"case": name, "rtol": 1e-12, "atol": 1e-9,
                    "max_abs_err": check_close(
                        name, mm_ops.gemm_batch(Z, S, acc_dtype=torch.float64),
                        want, 1e-12, 1e-9)})
    return out


def _tile_sums_checks(dev) -> list:
    """tile_sums at ragged shapes, every input type with a float32 and a
    float64 accumulator, against the plain version: float32 sums ``1e-4 /
    1e-3`` (summation order), float64 ``1e-12``; then ``tile_sums`` and
    ``verify_checksums`` on float64, which sum in float32 (the
    reference's)."""
    out = []
    f16, bf16 = torch.float16, torch.bfloat16
    f32, f64 = torch.float32, torch.float64
    for (B, m, n), dtype, acc in (
            ((3, 257, 127), f32, f32),
            ((2, 100, 70), bf16, f32),
            ((5, 9, 5), f64, f64),
            ((3, 257, 127), f16, f32),
            ((2, 100, 70), f16, f64),
            ((2, 100, 70), bf16, f64),
            ((3, 257, 127), f32, f64),
            ((5, 9, 5), f64, f32)):
        rng = np.random.default_rng(B * 101 + m * 11 + n)
        full = torch.from_numpy(rng.normal(size=(B, m + 1, n + 1))
                                ).to(dev, dtype)
        x = full[:, :-1, :-1]       # strided, as the sweep passes it
        rtol, atol = (1e-12, 1e-12) if acc == f64 else (1e-4, 1e-3)
        row, col = cv_ops.tile_sums_batch(x, acc_dtype=acc)
        rowp, colp = cv_kernel.tile_sums_plain(x, acc_dtype=acc)
        name = f"tile_sums{(B, m, n)}/{str(dtype)[6:]} in {str(acc)[6:]}"
        errs = [check_close(name + " row", row, rowp, rtol, atol),
                check_close(name + " col", col, colp, rtol, atol)]
        out.append({"case": name, "max_abs_err": max(errs),
                    "rtol": rtol, "atol": atol})
    rng = np.random.default_rng(65)
    x = torch.from_numpy(rng.normal(size=(100, 70))).to(dev)
    row, col = cv_ops.tile_sums(x)
    rowp, colp = cv_kernel.tile_sums_plain(x[None], acc_dtype=f32)
    if row.dtype != f32:
        raise AssertionError(f"tile_sums f64 gave {row.dtype}, the reference "
                             f"float32")
    out.append({"case": "tile_sums (100, 70)/float64 in float32",
                "rtol": 1e-4, "atol": 1e-3, "max_abs_err": max(
                    check_close("tile_sums f64 row", row, rowp[0], 1e-4, 1e-3),
                    check_close("tile_sums f64 col", col, colp[0], 1e-4,
                                1e-3))})
    # the verdict built on it: a clean full-checksum matrix verifies, a
    # tampered element is located; in float64 the residuals are float32
    cf = mm_ops.abft_matmul_full(x[:, :64], x[:64, :64].T.contiguous())
    ok, rres, _ = cv_ops.verify_checksums(cf.to(f64))
    if not bool(ok) or rres.dtype != f32:
        raise AssertionError(f"verify_checksums f64: ok {bool(ok)}, "
                             f"residuals {rres.dtype}")
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.normal(size=(64, 64))).to(dev, torch.float32)
    b = torch.from_numpy(rng.normal(size=(64, 64))).to(dev, torch.float32)
    cf = mm_ops.abft_matmul_full(a, b)
    ok, _, _ = cv_ops.verify_checksums(cf)
    cf[10, 20] += 50.0
    ok2, rres, cres = cv_ops.verify_checksums(cf)
    if not (bool(ok) and not bool(ok2) and int(rres.abs().argmax()) == 10
            and int(cres.abs().argmax()) == 20):
        raise AssertionError("verify_checksums: wrong verdict on the card")
    out.append({"case": "verify_checksums clean/tampered", "ok": True})
    return out


def _decays_loop(a, S_c):
    """The plain state passing on the decays themselves, differentiated
    by autograd: the loop that the kernel pair's autograd function
    replaces."""
    state = torch.zeros_like(S_c[:, 0])
    states_in = []
    for c in range(S_c.shape[1]):
        states_in.append(state)
        state = state * a[:, c][:, :, None, None] + S_c[:, c]
    return torch.stack(states_in, dim=1)


def _bits_equal(x, y) -> bool:
    return x.shape == y.shape and torch.equal(x.view(torch.int32),
                                              y.view(torch.int32))


# (label, B, nc, H, hd, N, layout) of the state-passing checks: the
# benchmark's training shape, zamba2-1.2b's layer at the serve phase's
# prefill, one TP rank's heads of each at tp 16, and ragged ones
SSD_SCAN_CASES = (
    ("mamba2-130m train 8 x 4096", 8, 32, 24, 64, 128, "einsum"),
    ("zamba2-1.2b prefill 2 x 4096", 2, 32, 64, 64, 64, "einsum"),
    ("mamba2-130m tp 16 rank (2 heads)", 8, 32, 2, 64, 128, "einsum"),
    ("zamba2-1.2b tp 16 rank (4 heads)", 2, 32, 4, 64, 64, "einsum"),
    ("one chunk", 2, 1, 24, 64, 128, "einsum"),
    ("three chunks, five heads", 3, 3, 5, 64, 128, "einsum"),
    ("hd * N = 35 (one-wide)", 2, 5, 3, 7, 5, "einsum"),
    ("hd * N = 132, partial warp", 3, 4, 3, 12, 11, "einsum"),
    ("every other chunk of a stack (strided)", 2, 6, 3, 16, 32, "strided"),
    ("rows off 16 bytes (one-wide)", 2, 4, 3, 16, 32, "offset"),
    ("(hd, N) transposed (one copy)", 2, 4, 3, 16, 32, "transposed"),
)


def _ssd_scan_inputs(dev, B, nc, H, hd, N, layout, seed):
    """Summed log decays (B, nc, H) and contributions (B, nc, H, hd, N)
    on the card, the latter in ``layout``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    la_tot = -3.0 * torch.rand((B, nc, H), generator=g, device=dev)
    if layout == "strided":
        S_c = torch.randn((B, 2 * nc, H, hd, N), generator=g,
                          device=dev)[:, ::2]
    elif layout == "offset":
        flat = torch.randn(B * nc * H * hd * N + 1, generator=g, device=dev)
        S_c = flat[1:].view(B, nc, H, hd, N)
    elif layout == "transposed":
        S_c = torch.randn((B, nc, H, N, hd), generator=g,
                          device=dev).transpose(3, 4)
    else:
        S_c = torch.randn((B, nc, H, hd, N), generator=g, device=dev)
    return la_tot, S_c


def _ssd_scan_checks(dev) -> list:
    """ssd_state_pass against the loop on the card at every case of
    SSD_SCAN_CASES: the forward through the public route bit for bit
    against the loop on the log decays; the contributions' gradient equal
    to the loop's autograd; the decays' gradient within 1e-5 of the sum
    of its terms' magnitudes (summation order only); two backward calls
    equal bit for bit."""
    out = []
    for i, (label, B, nc, H, hd, N, layout) in enumerate(SSD_SCAN_CASES):
        la_tot, S_c = _ssd_scan_inputs(dev, B, nc, H, hd, N, layout, 33 + i)
        before = ss_kernel.launches
        got = ss_ops.state_pass(la_tot, S_c)
        want = ss_kernel.state_pass_plain(la_tot, S_c)
        torch.cuda.synchronize()
        if ss_kernel.launches != before + 1:
            raise AssertionError(f"ssd_state_pass {label}: the CUDA route "
                                 f"did not launch the kernel")
        if not _bits_equal(got, want):
            raise AssertionError(
                f"ssd_state_pass {label}: forward differs from the loop, "
                f"max abs err {max_abs_err(got, want)}")
        a = torch.exp(la_tot).requires_grad_(True)
        s = S_c.detach().clone().requires_grad_(True)
        G = torch.randn(S_c.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(i))
        states = _decays_loop(a, s)
        da_p, ds_p = (torch.autograd.grad(states, (a, s), G)
                      if states.requires_grad else
                      (torch.zeros_like(a), torch.zeros_like(s)))
        k_out = ss_ops._StatePass.apply(a, s)
        da_k, ds_k = torch.autograd.grad(k_out, (a, s), G)
        da_k2, ds_k2 = torch.autograd.grad(ss_ops._StatePass.apply(a, s),
                                           (a, s), G)
        torch.cuda.synchronize()
        if not _bits_equal(k_out, states.detach()):
            raise AssertionError(f"ssd_state_pass {label}: forward on the "
                                 f"decays differs from the loop")
        if not torch.equal(ds_k, ds_p):
            raise AssertionError(
                f"ssd_state_pass {label}: dS_c differs from the loop's "
                f"autograd, max abs err {max_abs_err(ds_k, ds_p)}")
        if not (_bits_equal(da_k, da_k2) and _bits_equal(ds_k, ds_k2)):
            raise AssertionError(f"ssd_state_pass {label}: two backward "
                                 f"calls differ")
        scale = (ds_p * states.detach()).abs().sum(dim=(-1, -2))
        gap = (da_k - da_p).abs()
        if bool((gap > 1e-5 * scale).any()):
            raise AssertionError(
                f"ssd_state_pass {label}: da beyond 1e-5 of its terms' "
                f"magnitudes, {float((gap / scale.clamp_min(1e-30)).max())}")
        out.append({"case": f"ssd_state_pass {label} {(B, nc, H, hd, N)}",
                    "layout": layout, "forward_bitwise": True,
                    "ds_equal": True, "ds_bitwise": _bits_equal(ds_k, ds_p),
                    "backward_repeats_bitwise": True,
                    "da_max_gap_over_terms": float(
                        (gap / scale.clamp_min(1e-30)).max()),
                    "rtol": 1e-5})
    return out


def _ssd_scan_record(dev) -> dict:
    """ssd_state_pass at the benchmark's training shape (mamba2-130m,
    batch 8 x 4096: B 8, nc 32, H 24, hd 64, N 128) and at zamba2-1.2b's
    prefill layer, each direction timed beside its byte bound and the
    loop it replaces (forward; forward and backward through autograd)."""
    rows = []
    for label, B, nc, H, hd, N, _ in SSD_SCAN_CASES[:2]:
        la_tot, S_c = _ssd_scan_inputs(dev, B, nc, H, hd, N, "einsum", 7)
        a = torch.exp(la_tot)
        s = ss_kernel.row_view(S_c)
        states = ss_kernel.state_pass_fwd_cuda(a, s)
        G = torch.randn_like(states)
        n = B * nc * H * hd * N
        fwd_bound = 1e3 * 8.0 * n / PEAK_BYTES_PER_S
        bwd_bound = 1e3 * 12.0 * n / PEAK_BYTES_PER_S
        fwd_ms = time_ms(lambda: ss_kernel.state_pass_fwd_cuda(a, s), 20)
        bwd_ms = time_ms(lambda: ss_kernel.state_pass_bwd_cuda(
            a, states, G), 20)
        ar = a.clone().requires_grad_(True)
        sr = S_c.clone().requires_grad_(True)
        G5 = G.view(S_c.shape)

        def kernel_both():
            torch.autograd.grad(ss_ops._StatePass.apply(ar, sr), (ar, sr), G5)

        def loop_both():
            torch.autograd.grad(_decays_loop(ar, sr), (ar, sr), G5)

        rows.append({
            "shape": f"{label}: (B, nc, H, hd, N) {(B, nc, H, hd, N)}",
            "forward_ms": fwd_ms, "forward_bound_ms": fwd_bound,
            "forward_bound_share": fwd_bound / fwd_ms,
            "backward_ms": bwd_ms, "backward_bound_ms": bwd_bound,
            "backward_bound_share": bwd_bound / bwd_ms,
            "bound_by": "bytes",
            "plain_forward_ms": time_ms(
                lambda: ss_kernel.state_pass_plain(la_tot, S_c), 5),
            "kernel_fwd_bwd_ms": time_ms(kernel_both, 10),
            "plain_fwd_bwd_ms": time_ms(loop_both, 3),
        })
        del la_tot, S_c, a, s, states, G, ar, sr, G5
        torch.cuda.empty_cache()
    head = rows[0]
    return {
        "name": "ssd_state_pass", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_state_pass.cu",
        "replaces": "none (the port's per-chunk loop in "
                    "models/mamba2.py::_ssd_chunk_scan)",
        "shape": head["shape"], "launches": None,
        "tolerance": "forward bit for bit; dS_c equal; da rtol 1e-5 of "
                     "its terms' magnitudes",
        "ms": head["forward_ms"], "bound_ms": head["forward_bound_ms"],
        "bound_by": "bytes", "plain_ms": head["plain_forward_ms"],
        "library_ms": None, "library_call": None,
        "rows": rows,
    }


def phase_kernels() -> list:
    """Returns the contract's per-kernel records, ``launches`` still to be
    filled in by the sweep phase."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    checks = _matmul_checks(dev) + _tile_sums_checks(dev)
    checks += _flash_checks(dev)
    checks += _ssd_scan_checks(dev)
    emit({"phase": "kernel_checks", "cases": checks})

    records = []

    # B1 at the sweep's shape: one wave of the CG scan on the largest
    # dense-route system, Z (W, n) @ S (n, n) in float64
    W, n = 256, batched.GEMM_MAX_N
    rng = np.random.default_rng(4096)
    Z = torch.from_numpy(rng.normal(size=(W, n))).to(dev)
    S = torch.from_numpy(rng.normal(size=(n, n))).to(dev)
    S = 0.5 * (S + S.T)
    got = mm_ops.gemm_batch(Z, S, acc_dtype=torch.float64)
    want, _, _ = mm_kernel.abft_matmul_plain(Z, S, acc_dtype=torch.float64)
    # float64, summation order only: k = 4096 terms of magnitude ~1 at
    # 1.1e-16 each stay far below 1e-9 absolute
    err = check_close("gemm_batch f64", got, want, rtol=1e-12, atol=1e-9)
    flops = 2.0 * W * n * n
    nbytes = 8.0 * (W * n + n * n + W * n)
    by_ops = flops / PEAK_FLOPS[torch.float64]
    by_bytes = nbytes / PEAK_BYTES_PER_S
    records.append({
        "name": "abft_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/abft_matmul.cu",
        "replaces": "src/repro/kernels/abft_matmul/kernel.py:99",
        "shape": f"gemm_batch f64 ({W},{n})@({n},{n})",
        "launches": None, "max_abs_err": err,
        "tolerance": "rtol 1e-12, atol 1e-9",
        "ms": time_ms(lambda: mm_ops.gemm_batch(
            Z, S, acc_dtype=torch.float64), 10),
        "launch_only_ms": time_ms(lambda: mm_kernel.abft_matmul_cuda(
            Z, S, acc_dtype=torch.float64), 10),
        "plain_ms": time_ms(lambda: mm_kernel.abft_matmul_plain(
            Z, S, acc_dtype=torch.float64), 10),
        "bound_ms": 1e3 * max(by_ops, by_bytes),
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "library_ms": time_ms(lambda: torch.matmul(Z, S), 10),
        "library_call": "torch.matmul",
        "routes": _matmul_routes(dev),
    })
    del Z, S, got, want

    # B2 at the sweep's shape: one launch group of the ABFT chunk screen at
    # n = 1024, the data block of (B, n+1, n+1) read through its strides
    m = 1025
    B = batched.mm_slabs_per_launch(m)
    V = torch.from_numpy(np.random.default_rng(1025).normal(
        size=(B, m, m))).to(dev)
    x = V[:, :-1, :-1]
    row, col = cv_ops.tile_sums_batch(x, acc_dtype=torch.float64)
    rowp, colp = cv_kernel.tile_sums_plain(x, acc_dtype=torch.float64)
    # float64, summation order only over 1024 terms of magnitude ~1
    err = max(check_close("tile_sums f64 row", row, rowp, 1e-12, 1e-10),
              check_close("tile_sums f64 col", col, colp, 1e-12, 1e-10))
    nbytes = 8.0 * (B * (m - 1) * (m - 1) + 2 * B * (m - 1))
    flops = 2.0 * B * (m - 1) * (m - 1)
    by_ops = flops / PEAK_FLOPS[torch.float64]
    by_bytes = nbytes / PEAK_BYTES_PER_S
    records.append({
        "name": "tile_sums", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tile_sums.cu",
        "replaces": "src/repro/kernels/checksum_verify/kernel.py:44",
        "shape": f"tile_sums_batch f64 V[:, :-1, :-1] of ({B},{m},{m})",
        "launches": None, "max_abs_err": err,
        "tolerance": "rtol 1e-12, atol 1e-10",
        "ms": time_ms(lambda: cv_ops.tile_sums_batch(
            x, acc_dtype=torch.float64), 10),
        "launch_only_ms": time_ms(lambda: cv_kernel.tile_sums_cuda(
            x, acc_dtype=torch.float64), 10),
        "plain_ms": time_ms(lambda: cv_kernel.tile_sums_plain(
            x, acc_dtype=torch.float64), 10),
        "bound_ms": 1e3 * max(by_ops, by_bytes),
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        # no single call gives both sums: the pair of reductions
        "library_ms": time_ms(lambda: (torch.sum(x, dim=2),
                                       torch.sum(x, dim=1)), 10),
        "library_call": "torch.sum(x, 2) and torch.sum(x, 1)",
        "routes": _tile_sums_routes(dev),
    })
    del V, x, row, col, rowp, colp
    records.append(_flash_record(dev))
    torch.cuda.empty_cache()
    records.append(_ssd_scan_record(dev))
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})
    return records


def _flash_checks(dev) -> list:
    """flash_attention against its plain version: the reference's four
    shapes, ragged S, GQA and MHA, head dims 8-128 (on the tile widths and
    off them), causal and not, a strided view. Tolerances: float32
    ``1e-5``, the reference's (tests/test_kernels.py; summation order of
    a float32 softmax, both sides full float32, no TF32); bfloat16 two
    ulps of the value
    (``FLASH_BF16_RTOL``), far tighter than the reference's ``5e-2``
    because both sides compute in float32 from the same bf16 inputs."""
    out = []
    cases = [((2, 128, 4, 2, 32), torch.float32, True),
             ((1, 256, 2, 2, 64), torch.float32, True),
             ((2, 64, 8, 2, 16), torch.float32, True),
             ((1, 64, 4, 4, 32), torch.float32, True),       # MHA
             ((2, 72, 4, 2, 32), torch.float32, True),       # ragged
             ((1, 200, 8, 2, 128), torch.float32, True),     # ragged, hd 128
             ((1, 100, 4, 2, 64), torch.float32, False),     # not causal
             ((2, 72, 4, 2, 32), torch.bfloat16, True),
             ((1, 130, 32, 8, 128), torch.bfloat16, True),   # llama3 heads
             ((1, 64, 4, 4, 32), torch.bfloat16, True),
             # bf16 (tensor cores, 128-row query and 64-row key tiles): every
             # head dim, S around the tiles, not causal
             ((1, 1, 4, 2, 64), torch.bfloat16, True),
             ((2, 8, 4, 2, 128), torch.bfloat16, True),
             ((1, 127, 4, 2, 16), torch.bfloat16, True),
             ((1, 129, 8, 2, 64), torch.bfloat16, True),
             ((1, 200, 8, 2, 128), torch.bfloat16, True),
             ((2, 200, 4, 1, 32), torch.bfloat16, True),
             ((1, 200, 4, 2, 128), torch.bfloat16, False),
             ((1, 129, 4, 4, 16), torch.bfloat16, False),
             # head dims off the tile widths: run in the next one with
             # the columns beyond hd zero
             ((1, 200, 4, 2, 48), torch.float32, True),
             ((1, 100, 4, 2, 80), torch.float32, False),
             ((2, 8, 4, 2, 8), torch.float32, True),
             ((1, 200, 4, 2, 48), torch.bfloat16, True),
             ((2, 129, 4, 2, 48), torch.bfloat16, False),
             ((2, 130, 4, 4, 80), torch.bfloat16, True),
             ((1, 72, 4, 2, 24), torch.bfloat16, True),
             ((2, 8, 4, 2, 8), torch.bfloat16, False),
             # kimi-k2 reduced's prefill: q (2,1024,4,32), k/v (2,1024,2,32)
             ((2, 1024, 4, 2, 32), torch.float32, True),
             ((2, 1024, 4, 2, 32), torch.bfloat16, True)]
    for (B, S, H, KV, hd), dtype, causal in cases:
        rng = np.random.default_rng(B * 1000 + S * 10 + hd)
        q, k, v = (torch.from_numpy(rng.normal(size=(B, S, n, hd))
                                    ).to(dev, dtype) for n in (H, KV, KV))
        got = fa_ops.flash_attention(q, k, v, causal=causal)
        want = fa_kernel.flash_attention_plain(q, k, v, causal=causal)
        rtol, atol = fa_kernel.tolerance(dtype)
        name = (f"flash_attention{(B, S, H, KV, hd)}/{str(dtype)[6:]}"
                f"{'' if causal else ' not causal'}")
        out.append({"case": name, "rtol": rtol, "atol": atol,
                    "max_abs_err": check_close(name, got, want, rtol, atol)})
    # every route of fa_kernel.route at ragged S, off the tiles: f16 on the
    # tensor cores, hd 129-256 (the 256 tile), bf16/f16 hd off multiples of
    # 8 (zero-padded copy), hd past 256 (128-column chunks, each type), f64
    # (computed in f32), mixed and float8 inputs (cast to f32)
    f16, bf16 = torch.float16, torch.bfloat16
    f32, f64 = torch.float32, torch.float64
    for (B, S, H, KV, hd), qd, kvd, causal in (
            ((2, 72, 4, 2, 32), f16, f16, True),
            ((1, 200, 8, 2, 128), f16, f16, True),
            ((2, 129, 4, 2, 48), f16, f16, False),
            ((1, 200, 4, 2, 256), bf16, bf16, True),
            ((1, 200, 4, 2, 256), f16, f16, False),
            ((2, 130, 4, 2, 136), bf16, bf16, True),
            ((1, 72, 4, 2, 192), f16, f16, True),
            ((1, 100, 4, 2, 44), bf16, bf16, True),
            ((1, 100, 4, 2, 100), f16, f16, False),
            ((1, 70, 4, 2, 250), bf16, bf16, True),
            ((1, 130, 4, 2, 200), f32, f32, True),
            ((2, 72, 4, 2, 256), f64, f64, False),
            ((1, 100, 4, 2, 300), f32, f32, True),
            ((1, 72, 4, 2, 512), bf16, bf16, False),
            ((1, 72, 4, 2, 384), f16, f16, True),
            ((1, 130, 4, 2, 520), f64, f64, True),
            ((2, 72, 4, 2, 64), f64, f64, True),
            ((2, 72, 4, 2, 64), bf16, f32, True),
            ((1, 100, 4, 2, 100), f32, bf16, False),
            ((1, 64, 4, 2, 32), torch.float8_e4m3fn, torch.float8_e4m3fn,
             True)):
        rng = np.random.default_rng(B * 1000 + S * 10 + hd)
        # float64 values as they are, the narrower types through float32
        q, k, v = (torch.from_numpy(rng.normal(size=(B, S, n, hd))).to(
            dev, f64 if d == f64 else f32).to(d)
                   for n, d in ((H, qd), (KV, kvd), (KV, kvd)))
        r = fa_kernel.route(q, k, v)
        got = fa_ops.flash_attention(q, k, v, causal=causal)
        want = fa_kernel.flash_attention_plain(q, k, v, causal=causal)
        rtol, atol = fa_kernel.tolerance(qd)
        if qd == torch.float8_e4m3fn:
            # the output rounds to e4m3 (3 mantissa bits): two ulps
            rtol, atol, got, want = 0.25, 1e-2, got.float(), want.float()
        name = (f"flash_attention{(B, S, H, KV, hd)}/{str(qd)[6:]}"
                f"{'' if kvd == qd else '/' + str(kvd)[6:]}"
                f"{'' if causal else ' not causal'} ({r.kernel}, tile "
                f"{r.tile})")
        out.append({"case": name, "rtol": rtol, "atol": atol,
                    "max_abs_err": check_close(name, got, want, rtol, atol)})
    # q/k/v as head views of one fused projection, read in place
    rng = np.random.default_rng(5)
    B, S, H, KV, hd = 2, 96, 8, 2, 64
    fused64 = rng.normal(size=(B, S, (H + 2 * KV) * hd))
    for dtype, rtol, atol in ((torch.float32, FLASH_F32_TOL, FLASH_F32_TOL),
                              (torch.bfloat16, FLASH_BF16_RTOL,
                               FLASH_BF16_ATOL)):
        fused = torch.from_numpy(fused64).to(dev, dtype)
        q = fused[..., :H * hd].reshape(B, S, H, hd)
        k = fused[..., H * hd:(H + KV) * hd].reshape(B, S, KV, hd)
        v = fused[..., (H + KV) * hd:].reshape(B, S, KV, hd)
        name = f"flash_attention strided views/{str(dtype)[6:]}"
        err = check_close(name, fa_ops.flash_attention(q, k, v),
                          fa_kernel.flash_attention_plain(q, k, v),
                          rtol, atol)
        out.append({"case": name, "rtol": rtol, "atol": atol,
                    "max_abs_err": err})
    return out


def _flash_head_dims(dev) -> list:
    """B3 at head dims off its tile widths, at a prefill's size
    (``FLASH_HD_SHAPES``): f32 and bf16, causal and not, against the plain
    version at the unchanged tolerances; the bf16 calls timed beside
    their bound (operations: 4 hd per visible (query, key) pair and head,
    against the bf16 peak), the plain version and SDPA."""
    out = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for B, S, H, hd in FLASH_HD_SHAPES:
        g = torch.Generator(device=dev).manual_seed(hd)
        qkv32 = [torch.randn((B, S, H, hd), generator=g, device=dev)
                 for _ in range(3)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in qkv32)
            rtol, atol = ((FLASH_F32_TOL, FLASH_F32_TOL)
                          if dtype == torch.float32
                          else (FLASH_BF16_RTOL, FLASH_BF16_ATOL))
            for causal in (True, False):
                name = (f"flash_attention{(B, S, H, H, hd)}/"
                        f"{str(dtype)[6:]}{'' if causal else ' not causal'}")
                got = fa_ops.flash_attention(q, k, v, causal=causal)
                want = fa_kernel.flash_attention_plain(q, k, v, causal=causal)
                rec = {"case": name, "rtol": rtol, "atol": atol,
                       "max_abs_err": check_close(name, got, want, rtol,
                                                  atol)}
                del got, want
                if dtype == torch.bfloat16:
                    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                    rec.update({
                        "ms": time_ms(lambda: fa_ops.flash_attention(
                            q, k, v, causal=causal), 10),
                        "plain_ms": time_ms(
                            lambda: fa_kernel.flash_attention_plain(
                                q, k, v, causal=causal), 3),
                        **_flash_bound(B, S, H, H, hd, causal),
                        "library_ms": time_ms(lambda: sdpa(
                            qt, kt, vt, is_causal=causal), 10)})
                out.append(rec)
                torch.cuda.empty_cache()
        del qkv32, q, k, v
    return out


def _flash_bound(B, S, H, KV, hd, causal, q_bytes=2, kv_bytes=2,
                 peak=torch.bfloat16) -> dict:
    """B3's bound, by default in bf16: the larger of its operations (each
    visible (query, key) pair of a head costs hd multiply-adds for q.k and
    hd for p.v) at the card's peak for ``peak`` and its bytes (q, k, v
    read once, o written once in q's type) at the memory rate."""
    pairs = S * (S + 1) / 2 if causal else S * S
    by_ops = 4.0 * hd * B * H * pairs / PEAK_FLOPS[peak]
    by_bytes = (2.0 * B * S * H * hd * q_bytes + 2.0 * B * S * KV * hd
                * kv_bytes) / PEAK_BYTES_PER_S
    return {"bound_ms": 1e3 * max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes"}


def _peak_type(*dtypes) -> torch.dtype:
    """The type whose peak bounds a kernel on operands of ``dtypes``: bf16
    or f16 on the tensor cores where all are that type, else float32 (the
    type mixed or other inputs are computed in), or float64."""
    if len(set(dtypes)) == 1 and dtypes[0] in PEAK_FLOPS:
        return dtypes[0]
    return torch.float64 if torch.float64 in dtypes else torch.float32


# Routes no arch of the registry reaches (every model runs bf16 or f32 at
# a head dim of 128 or below), timed at prefill-sized shapes: label, (B,
# S, H, KV, hd), q's and k/v's dtype; all causal.
FLASH_ROUTE_CASES = (
    ("f16 at llama3-8b's prefill", (2, 4096, 32, 8, 128),
     torch.float16, torch.float16),
    ("bf16 hd 256", (2, 4096, 16, 8, 256), torch.bfloat16, torch.bfloat16),
    ("f16 hd 256", (2, 4096, 16, 8, 256), torch.float16, torch.float16),
    ("bf16 hd 192 (256 tile)", (2, 4096, 16, 8, 192),
     torch.bfloat16, torch.bfloat16),
    ("f16 hd 192 (256 tile)", (2, 4096, 16, 8, 192),
     torch.float16, torch.float16),
    ("bf16 hd 100 (padded to 104, 128 tile)", (2, 4096, 16, 8, 100),
     torch.bfloat16, torch.bfloat16),
    ("f32 hd 100 (128 tile)", (2, 4096, 16, 8, 100),
     torch.float32, torch.float32),
    ("f32 hd 512 (128-column chunks)", (2, 4096, 16, 8, 512),
     torch.float32, torch.float32),
    ("bf16 hd 512 (128-column chunks)", (2, 4096, 16, 8, 512),
     torch.bfloat16, torch.bfloat16),
    ("f64 (computed in f32)", (1, 1024, 8, 2, 128),
     torch.float64, torch.float64),
    ("bf16 q, f32 k/v (cast to f32)", (1, 1024, 8, 2, 128),
     torch.bfloat16, torch.float32),
    ("f32, B x H = 81920 past grid y's 65535", (2048, 16, 40, 8, 16),
     torch.float32, torch.float32),
)
NO_ARCH = "no arch reaches it"
# CUDA's limit on grid y: row tiles of one B1 launch, matrices of one B2
# launch; past it the kernels' C launchers cut the work into launches
GRID_Y_MAX = 65535


def _flash_routes(dev) -> list:
    """B3's routes beyond the main path's (``FLASH_ROUTE_CASES``), each
    held to its plain version at ``fa_kernel.tolerance`` and timed beside
    its bound, the plain version and SDPA (on one dtype as it is; on
    float64 or mixed inputs, which SDPA would compute otherwise, on the
    float32 casts the wrapper makes)."""
    out = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, (B, S, H, KV, hd), qd, kvd in FLASH_ROUTE_CASES:
        g = torch.Generator(device=dev).manual_seed(B * S + hd)
        q, k, v = (torch.randn((B, S, n, hd), generator=g, device=dev).to(d)
                   for n, d in ((H, qd), (KV, kvd), (KV, kvd)))
        r = fa_kernel.route(q, k, v)
        rtol, atol = fa_kernel.tolerance(qd)
        fa_kernel.launches = 0
        got = fa_ops.flash_attention(q, k, v)
        if fa_kernel.launches != 1:
            raise AssertionError(f"flash_attention {label}: "
                                 f"{fa_kernel.launches} launches")
        err = check_close(f"flash_attention {label}", got,
                          fa_kernel.flash_attention_plain(q, k, v),
                          rtol, atol)
        del got
        same = qd == kvd and qd != torch.float64
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        # SDPA on one dtype, else on the float32 casts the wrapper makes
        lq, lk, lv = ((qt, kt, vt) if same else
                      (t.to(torch.float32) for t in (qt, kt, vt)))
        out.append({
            "case": label, "shape": f"q ({B},{S},{H},{hd}), k/v "
                                    f"({B},{S},{KV},{hd}), causal",
            "dtypes": [str(qd)[6:], str(kvd)[6:]],
            "route": r._asdict() | {"cast": str(r.cast)[6:] if r.cast
                                    else None},
            "launches": NO_ARCH, "max_abs_err": err,
            "tolerance": f"rtol {rtol}, atol {atol}",
            "ms": time_ms(lambda: fa_ops.flash_attention(q, k, v), 10),
            "plain_ms": time_ms(
                lambda: fa_kernel.flash_attention_plain(q, k, v), 3),
            **_flash_bound(B, S, H, KV, hd, True, q.element_size(),
                           k.element_size(), _peak_type(qd, kvd)),
            "library_ms": time_ms(lambda: sdpa(lq, lk, lv, is_causal=True,
                                               enable_gqa=True), 10),
            "library_call": ("torch.nn.functional.scaled_dot_product_"
                             "attention" + ("" if same else
                                            " on the float32 casts"))})
        del q, k, v, qt, kt, vt, lq, lk, lv
        torch.cuda.empty_cache()
    return out


def _matmul_routes(dev) -> list:
    """B1's type pairs beyond the sweep's f64, at the sweep's shape (256,
    4096) @ (4096, 4096), and a product of more row tiles than one launch
    takes; each against its plain version at ``_mm_tolerance``, timed
    beside its bound, the plain version and torch.matmul (on one type
    below float64 as it is, otherwise on the casts to the accumulator's
    type, the operands the kernel multiplies)."""
    out = []
    f16, f32, f64 = torch.float16, torch.float32, torch.float64
    tall = GRID_Y_MAX * 64 + 71
    for label, (m, k, n), ad, bd, acc in (
            ("f16 in f32", (256, 4096, 4096), f16, f16, f32),
            ("f16 a, f32 b in f32 (f16 -> f32)", (256, 4096, 4096),
             f16, f32, f32),
            ("f64 in f32 (abft_matmul on float64)", (256, 4096, 4096),
             f64, f64, f32),
            (f"f32 in f32, {tall} rows (cut into two launches)", (tall, 8, 8),
             f32, f32, f32)):
        rng = np.random.default_rng(m + k + n)
        a = torch.from_numpy(rng.normal(size=(m, k))).to(dev, ad)
        b = torch.from_numpy(rng.normal(size=(k, n))).to(dev, bd)
        def fn():
            c, rowp_k, colp_k = mm_kernel.abft_matmul_cuda(a, b,
                                                           acc_dtype=acc)
            return c, rowp_k.sum(dim=1), colp_k.sum(dim=0)

        mm_kernel.launches = 0
        c, row, col = fn()
        launches = mm_kernel.launches
        cp, rowp, colp = mm_kernel.abft_matmul_plain(a, b, acc_dtype=acc)
        rtol, atol = _mm_tolerance(ad, acc)
        crtol, catol = _mm_tolerance(acc, acc)
        err = max(check_close(f"abft_matmul {label} C", c, cp, rtol, atol),
                  check_close(f"abft_matmul {label} row", row, rowp, crtol,
                              catol * k),
                  check_close(f"abft_matmul {label} col", col, colp, crtol,
                              catol * k))
        del c, row, col, cp, rowp, colp
        wide = torch.promote_types(ad, bd)
        flops = 2.0 * m * n * k
        nbytes = (a.numel() * a.element_size() + b.numel() * b.element_size()
                  + m * n * a.element_size()
                  + (m + n) * torch.empty(0, dtype=acc).element_size())
        by_ops = flops / PEAK_FLOPS[_peak_type(wide)]
        by_bytes = nbytes / PEAK_BYTES_PER_S
        # torch.matmul on the operands as the kernel promotes them: one
        # type below f64 as they are, otherwise cast to the accumulator's
        same = ad == bd and ad != f64
        la, lb = (a, b) if same else (a.to(acc), b.to(acc))
        out.append({
            "case": label, "shape": f"({m},{k})@({k},{n})",
            "launches": NO_ARCH, "launches_in_check": launches,
            "max_abs_err": err, "tolerance": f"rtol {rtol}, atol {atol}",
            "ms": time_ms(fn, 10),
            "plain_ms": time_ms(lambda: mm_kernel.abft_matmul_plain(
                a, b, acc_dtype=acc), 10),
            "bound_ms": 1e3 * max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "library_ms": time_ms(lambda: torch.matmul(la, lb), 10),
            "library_call": "torch.matmul" + (
                "" if same else f" on the {str(acc)[6:]} casts")})
        del a, b, la, lb
        torch.cuda.empty_cache()
    return out


def _tile_sums_routes(dev) -> list:
    """B2's type pairs beyond the sweep's f64, at the sweep's shape (the
    data block of (B, 1025, 1025)), and a stack of more matrices than one
    launch takes; each against its plain version, timed beside its bound,
    the plain version and the pair of torch.sum calls with the
    accumulator's dtype."""
    out = []
    f16, f32, f64 = torch.float16, torch.float32, torch.float64
    m = 1025
    B = batched.mm_slabs_per_launch(m)
    many = GRID_Y_MAX + 4465
    for label, (nb, mm_), dtype, acc in (
            ("f16 in f32", (B, m), f16, f32),
            ("f32 in f64", (B, m), f32, f64),
            ("f64 in f32", (B, m), f64, f32),
            (f"f32 in f32, {many} matrices of 9 x 9 (cut into two launches)",
             (many, 10), f32, f32)):
        V = torch.from_numpy(np.random.default_rng(nb + mm_).normal(
            size=(nb, mm_, mm_))).to(dev, dtype)
        x = V[:, :-1, :-1]
        cv_kernel.launches = 0
        row, col = cv_ops.tile_sums_batch(x, acc_dtype=acc)
        launches = cv_kernel.launches
        rowp, colp = cv_kernel.tile_sums_plain(x, acc_dtype=acc)
        rtol, atol = (1e-12, 1e-10) if acc == f64 else (1e-4, 1e-3)
        err = max(check_close(f"tile_sums {label} row", row, rowp, rtol,
                              atol),
                  check_close(f"tile_sums {label} col", col, colp, rtol,
                              atol))
        del row, col, rowp, colp
        n_el = nb * (mm_ - 1) * (mm_ - 1)
        acc_bytes = torch.empty(0, dtype=acc).element_size()
        by_bytes = (n_el * x.element_size()
                    + 2 * nb * (mm_ - 1) * acc_bytes) / PEAK_BYTES_PER_S
        by_ops = 2.0 * n_el / PEAK_FLOPS[acc]
        out.append({
            "case": label, "shape": f"V[:, :-1, :-1] of ({nb},{mm_},{mm_})",
            "launches": NO_ARCH, "launches_in_check": launches,
            "max_abs_err": err, "tolerance": f"rtol {rtol}, atol {atol}",
            "ms": time_ms(lambda: cv_ops.tile_sums_batch(x, acc_dtype=acc),
                          10),
            "plain_ms": time_ms(lambda: cv_kernel.tile_sums_plain(
                x, acc_dtype=acc), 10),
            "bound_ms": 1e3 * max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "library_ms": time_ms(lambda: (torch.sum(x, dim=2, dtype=acc),
                                           torch.sum(x, dim=1, dtype=acc)),
                                  10),
            "library_call": "torch.sum(x, 2, dtype=acc) and "
                            "torch.sum(x, 1, dtype=acc)"})
        del V, x
        torch.cuda.empty_cache()
    return out


def _flash_vlm_record(dev) -> dict:
    """B3 at qwen2-vl-2b's prefill shape, q (2,4096,12,128) and k/v
    (2,4096,2,128), causal: six query heads per KV head, and a head count
    that is not a power of two. float32 at ``1e-5`` first (the FMA
    kernel's own head indexing), then bf16 at the kernel's tolerances,
    timed beside its bound, its plain version and SDPA."""
    cfg = get_config(VLM_ARCH)
    B, S = VA_BATCH, VA_PROMPT
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(VA_SEED)
    q, k, v = (torch.randn((B, S, n, hd), generator=g, device=dev,
                           dtype=torch.float32) for n in (H, KV, KV))
    f32_err = check_close("flash_attention qwen2-vl prefill f32",
                          fa_ops.flash_attention(q, k, v),
                          fa_kernel.flash_attention_plain(q, k, v),
                          FLASH_F32_TOL, FLASH_F32_TOL)
    torch.cuda.empty_cache()
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    err = check_close("flash_attention qwen2-vl prefill bf16",
                      fa_ops.flash_attention(q, k, v),
                      fa_kernel.flash_attention_plain(q, k, v),
                      FLASH_BF16_RTOL, FLASH_BF16_ATOL)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {
        "shape": f"prefill bf16 q ({B},{S},{H},{hd}), k/v ({B},{S},{KV},{hd}),"
                 f" causal",
        "max_abs_err": err,
        "tolerance": f"rtol {FLASH_BF16_RTOL}, atol {FLASH_BF16_ATOL}",
        "f32_max_abs_err": f32_err,
        "ms": time_ms(lambda: fa_ops.flash_attention(q, k, v), 10),
        "launch_only_ms": time_ms(
            lambda: fa_kernel.flash_attention_cuda(q, k, v), 10),
        "plain_ms": time_ms(
            lambda: fa_kernel.flash_attention_plain(q, k, v), 3),
        **_flash_bound(B, S, H, KV, hd, True),
        "library_ms": time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                           enable_gqa=True), 10)}
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def _flash_record(dev) -> dict:
    """B3 at the serving prefill's shape: one layer of llama3-8b on
    2 x 4096 tokens, q (2,4096,32,128), k/v (2,4096,8,128) in bf16.
    The same inputs in float32 are held to ``1e-5`` first: at S = 4096 a
    row's output is about sqrt(e/n) of unit-normal v, a few hundredths,
    so only a tight bound sees a key tile lost or counted twice in the
    late rows."""
    cfg = get_config(SERVE_ARCH)
    B, S = SERVE_BATCH, SERVE_PROMPT
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    q, k, v = (torch.randn((B, S, n, hd), generator=g, device=dev,
                           dtype=torch.float32) for n in (H, KV, KV))
    f32_err = check_close("flash_attention prefill f32",
                          fa_ops.flash_attention(q, k, v),
                          fa_kernel.flash_attention_plain(q, k, v),
                          FLASH_F32_TOL, FLASH_F32_TOL)
    torch.cuda.empty_cache()
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got = fa_ops.flash_attention(q, k, v)
    want = fa_kernel.flash_attention_plain(q, k, v)
    err = check_close("flash_attention prefill bf16", got, want,
                      FLASH_BF16_RTOL, FLASH_BF16_ATOL)
    del got, want
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:97",
        "shape": f"prefill bf16 q ({B},{S},{H},{hd}), k/v ({B},{S},{KV},{hd}),"
                 f" causal",
        "launches": None, "max_abs_err": err,
        "tolerance": f"rtol {FLASH_BF16_RTOL}, atol {FLASH_BF16_ATOL}",
        "f32_max_abs_err": f32_err,
        "f32_tolerance": f"rtol {FLASH_F32_TOL}, atol {FLASH_F32_TOL}",
        "ms": time_ms(lambda: fa_ops.flash_attention(q, k, v), 10),
        "launch_only_ms": time_ms(
            lambda: fa_kernel.flash_attention_cuda(q, k, v), 10),
        "plain_ms": time_ms(
            lambda: fa_kernel.flash_attention_plain(q, k, v), 3),
        **_flash_bound(B, S, H, KV, hd, True),
        "library_ms": time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                           enable_gqa=True), 10),
        "library_call": "torch.nn.functional.scaled_dot_product_attention"
                        "(is_causal=True, enable_gqa=True)",
        "head_dims": _flash_head_dims(dev),
        "qwen2_vl_prefill": _flash_vlm_record(dev),
        "routes": _flash_routes(dev),
    }


def _torn_plans():
    dense = tuple(
        CrashPlan.at_every_step(
            torn=TornSpec(fraction=f, seed=TORN_SEED, mode="random",
                          samples=TORN_SAMPLES))
        for f in TORN_FRACTIONS)
    evict = (CrashPlan.at_every_step(
        torn=TornSpec(fraction=0.5, seed=TORN_SEED, mode="eviction")),)
    return (CrashPlan.no_crash(),) + dense + evict


def _cell(res) -> dict:
    d = deterministic_cell_dict(res)
    d.pop("state_certified", None)      # fork/measure-only by contract
    return d


def phase_sweep(records: list) -> None:
    kw = dict(strategies=STRATEGIES, plans=_torn_plans(),
              cfg=NVMConfig(cache_bytes=1024 * 1024), engine="fork",
              workers=1)
    per_workload = []
    total_launches = {"abft_matmul": 0, "tile_sums": 0}
    for spec in WORKLOADS:
        # counts to zero just before the main path, read just after
        mm_kernel.launches = 0
        cv_kernel.launches = 0
        fa_kernel.launches = 0
        batched.reset_profile()
        batched_engine.reset_stats()
        t0 = time.perf_counter()
        cells = sweep([spec], mode="batched", **kw)
        torch.cuda.synchronize()
        t_batched = time.perf_counter() - t0
        launches = {"abft_matmul": mm_kernel.launches,
                    "tile_sums": cv_kernel.launches}
        if fa_kernel.launches:
            raise AssertionError(f"{spec}: the sweep launched flash_attention")
        profile = dict(batched.profile)
        stats = dict(batched_engine.stats)

        t0 = time.perf_counter()
        measured = sweep([spec], mode="measure", **kw)
        t_measure = time.perf_counter() - t0
        after_measure = (mm_kernel.launches, cv_kernel.launches)
        if after_measure != (launches["abft_matmul"], launches["tile_sums"]):
            raise AssertionError("the measure sweep launched a kernel")

        if len(cells) != len(measured) or not cells:
            raise AssertionError(f"{spec}: {len(cells)} batched cells vs "
                                 f"{len(measured)} measure cells")
        for got, want in zip(cells, measured):
            if _cell(got) != _cell(want):
                raise AssertionError(
                    f"{spec}: batched cell differs from measure cell\n"
                    f"batched: {_cell(got)}\nmeasure: {_cell(want)}")
            if got.strategy == "adcc" and "batched_fallback" in got.info:
                raise AssertionError(
                    f"{spec}: adcc cell fell back: "
                    f"{got.info['batched_fallback']} ({got.plan})")
            if got.crash_step is None and got.correct is not True:
                raise AssertionError(f"{spec}: crash-free run of "
                                     f"{got.strategy} finalized incorrect")
        kernel = "abft_matmul" if spec[0] == "cg" else "tile_sums"
        if launches[kernel] == 0:
            raise AssertionError(f"{spec}: the batched sweep never launched "
                                 f"the {kernel} kernel")
        for k, v in launches.items():
            total_launches[k] += v
        transfer = (profile["shared_upload_seconds"]
                    + profile["upload_seconds"]
                    + profile["download_seconds"])
        per_workload.append({
            "workload": [spec[0], spec[1]], "cells": len(cells),
            "adcc_cells": sum(c.strategy == "adcc" for c in cells),
            "batched_seconds": t_batched, "measure_seconds": t_measure,
            "cells_per_second_batched": len(cells) / t_batched,
            "launches": launches,
            "launch_groups": profile["launch_groups"],
            "shared_upload_seconds": profile["shared_upload_seconds"],
            "upload_seconds": profile["upload_seconds"],
            "device_seconds": profile["device_seconds"],
            "download_seconds": profile["download_seconds"],
            "transfer_seconds": transfer,
            "host_seconds": t_batched - transfer - profile["device_seconds"],
            **stats,
        })
        emit({"phase": "sweep", **per_workload[-1]})
    for rec in records:
        if rec["name"] in total_launches:
            rec["launches"] = total_launches[rec["name"]]
            if rec["launches"] <= 0:
                raise AssertionError(f"main path never launched "
                                     f"{rec['name']}")
    emit({"phase": "sweep_total",
          "cells": sum(w["cells"] for w in per_workload),
          "batched_seconds": sum(w["batched_seconds"] for w in per_workload),
          "measure_seconds": sum(w["measure_seconds"] for w in per_workload),
          "launches": total_launches})


def phase_sharded() -> None:
    """A sharded batched sweep after CUDA is initialised in this process:
    the workers must be spawned, select the card themselves, build or
    load the kernel libraries, launch both kernels and give the serial
    sweep's cells. A batched shard is never degraded to another mode
    (``driver._degrade_job``), so a worker that fails on the card fails
    this phase; the workers' own launch counts come back with their
    results."""
    kw = dict(strategies=STRATEGIES, plans=_torn_plans(),
              cfg=NVMConfig(cache_bytes=1024 * 1024), engine="fork",
              mode="batched")
    specs = [WORKLOADS[1], WORKLOADS[3]]
    serial = sweep(specs, workers=1, **kw)
    before = launch_counts()
    t0 = time.perf_counter()
    sharded = sweep(specs, workers=2, shard_retries=0, shard_timeout=240.0,
                    **kw)
    seconds = time.perf_counter() - t0
    if launch_counts() != before:
        raise AssertionError("the sharded sweep launched in the parent")
    if [_cell(c) for c in sharded] != [_cell(c) for c in serial]:
        raise AssertionError("sharded batched sweep differs from serial")
    if any("batched_fallback" in c.info for c in sharded
           if c.strategy == "adcc"):
        raise AssertionError("a sharded adcc cell fell back")
    worker_launches = dict(driver.shard_launches)
    for kernel in ("abft_matmul", "tile_sums"):
        if worker_launches.get(kernel, 0) <= 0:
            raise AssertionError(f"the spawned workers never launched the "
                                 f"{kernel} kernel: {worker_launches}")
    emit({"phase": "sharded", "workers": 2, "cells": len(sharded),
          "seconds": seconds, "worker_launches": worker_launches})


def _np_row_checksums(words: np.ndarray) -> np.ndarray:
    """The KV row checksum chain in numpy uint64 (the oracle)."""
    w = words.view(np.uint64)
    acc = np.full(len(w), batched._KV_MIX_INIT, dtype=np.uint64)
    for j in range(w.shape[1]):
        acc = batched._np_splitmix(acc ^ w[:, j])
    return (acc & np.uint64(batched._MASK63)).astype(np.int64)


def _np_value_words(keys: np.ndarray, seqs: np.ndarray, W: int):
    """The (N, W) value words of (key, seq) in numpy uint64 (the oracle)."""
    base = batched._np_splitmix(
        (keys.view(np.uint64) << np.uint64(batched._KV_VALUE_SALT))
        ^ seqs.view(np.uint64))
    with np.errstate(over="ignore"):
        expect = batched._np_splitmix(
            base[:, None] + np.arange(W, dtype=np.uint64)[None, :])
    return (expect & np.uint64(batched._MASK63)).astype(np.int64)


def _timed_call(fn, reps: int = 3) -> tuple:
    """``fn()``'s result, and its mean wall milliseconds over ``reps``
    calls after one warm-up with the seconds of ``batched.profile``'s
    phases a call (numpy in, numpy out: uploads, device math, download)."""
    out = fn()
    batched.reset_profile()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    ms = 1e3 * (time.perf_counter() - t0) / reps
    phases = {k: 1e3 * batched.profile[k] / reps
              for k in ("upload_seconds", "device_seconds",
                        "download_seconds")}
    return out, ms, {k.replace("_seconds", "_ms"): v
                     for k, v in phases.items()}


def _kv_math() -> dict:
    """The KV integer math on the card at 2^20 rows against the numpy
    oracle, bit for bit, from words over the whole 64-bit range. Times:
    the public call (numpy in, numpy out, host clock, by phase) and the
    device math alone on resident tensors (CUDA events), beside the bytes
    it must move at the card's rate."""
    dev = repro_torch.get_device()
    rng = np.random.default_rng(KV_MATH_SEED)
    N, W = KV_MATH_ROWS, KV_VALUE_WORDS
    out = {"rows": N}
    for width in (7, 15):
        words = rng.integers(I64.min, I64.max, size=(N, width),
                             dtype=np.int64, endpoint=True)
        words.reshape(-1)[:len(KV_EXTREMES)] = KV_EXTREMES
        want = _np_row_checksums(words)
        got, call_ms, phases = _timed_call(
            lambda: batched.kv_row_checksums(words))
        if not np.array_equal(got, want):
            bad = int(np.flatnonzero(got != want)[0])
            raise AssertionError(
                f"kv_row_checksums width {width}: row {bad} {words[bad]} "
                f"gives {got[bad]} on the card, {want[bad]} in numpy")
        wt = torch.from_numpy(words).to(dev)
        if not np.array_equal(batched._t_row_checksums(wt).cpu().numpy(),
                              want):
            raise AssertionError(f"row checksums width {width} on resident "
                                 f"tensors differ from numpy")
        out[f"row_checksums_w{width}"] = {
            "bit_equal": True, "call_ms": call_ms, "call_phases": phases,
            "device_ms": time_ms(lambda: batched._t_row_checksums(wt), 10),
            "bytes_bound_ms": 1e3 * 8.0 * N * (width + 1) / PEAK_BYTES_PER_S}
        del wt

    keys = rng.integers(I64.min, I64.max, size=N, dtype=np.int64,
                        endpoint=True)
    keys[:len(KV_EXTREMES)] = KV_EXTREMES
    seqs = rng.integers(I64.min, I64.max, size=N, dtype=np.int64,
                        endpoint=True)
    nwords = rng.integers(1, W + 1, size=N).astype(np.int64)
    expect = _np_value_words(keys, seqs, W)
    live = np.arange(W)[None, :] < nwords[:, None]
    # live words as the oracle gives them, dead ones arbitrary
    got = np.where(live, expect, rng.integers(I64.min, I64.max, size=(N, W),
                                              dtype=np.int64))
    # one live word of every even row corrupted in one random bit
    rows = np.arange(0, N, 2)
    cols = (rng.random(len(rows)) * nwords[rows]).astype(np.int64)
    got[rows, cols] ^= np.left_shift(
        np.int64(1), rng.integers(0, 63, size=len(rows)).astype(np.int64))
    want = np.ones(N, dtype=bool)
    want[rows] = False
    oracle = np.all(np.where(live, got == expect, True), axis=1)
    if not np.array_equal(oracle, want):
        raise AssertionError("the value-word oracle misses a corruption")
    ok, call_ms, phases = _timed_call(
        lambda: batched.kv_value_match(keys, seqs, got, nwords))
    if not np.array_equal(ok, want):
        bad = int(np.flatnonzero(ok != want)[0])
        raise AssertionError(f"kv_value_match: row {bad} (key {keys[bad]}, "
                             f"seq {seqs[bad]}, {nwords[bad]} words) is "
                             f"{ok[bad]} on the card, {want[bad]} in numpy")
    kt, st, gt, nt = (torch.from_numpy(x).to(dev)
                      for x in (keys, seqs, got, nwords))
    out["value_match_w24"] = {
        "bit_equal": True, "corrupted_rows": len(rows), "call_ms": call_ms,
        "call_phases": phases,
        "device_ms": time_ms(lambda: batched._t_value_match(kt, st, gt, nt),
                             10),
        "bytes_bound_ms": 1e3 * (8.0 * N * (W + 3) + N) / PEAK_BYTES_PER_S}
    del kt, st, gt, nt
    torch.cuda.empty_cache()
    return out


def _kv_plans():
    return (CrashPlan.no_crash(),) + tuple(
        CrashPlan.at_every_step(torn=TornSpec(fraction=f, seed=KV_SEED,
                                              mode="random",
                                              samples=KV_SAMPLES))
        for f in KV_FRACTIONS)


def _kv_census(cells) -> dict:
    """The KV figure's gates on the correctness classes of its cells
    (benchmarks/fig_kv.py ``check_kv_gates``, less the sharded and
    full-execution cross-checks and the overhead budget)."""
    violations, atom = {}, {}
    for c in cells:
        policy = c.workload_params.get("policy", "validate")
        if c.correctness_class in KV_VIOLATION_CLASSES and c.correct:
            raise AssertionError(f"violation cell finalized correct: "
                                 f"{c.strategy} {c.plan} {c.crash_step}")
        if c.correctness_class == "complete" and not c.correct:
            raise AssertionError(f"complete cell finalized incorrect: "
                                 f"{c.strategy} {c.plan} {c.crash_step}")
        if c.correctness_class in ("durability_violation",
                                   "atomicity_violation"):
            if policy == "validate":
                violations[c.strategy] = violations.get(c.strategy, 0) + 1
            if c.correctness_class == "atomicity_violation":
                atom[policy] = atom.get(policy, 0) + 1
    for strat in KV_CLEAN_STRATEGIES:
        if violations.get(strat):
            raise AssertionError(f"{strat} gave {violations[strat]} "
                                 f"durability/atomicity violation cells")
    if not violations.get("none"):
        raise AssertionError("scratch restart gave no durability violation")
    if not atom.get("blind"):
        raise AssertionError("blind recovery gave no atomicity violation")
    if atom.get("validate"):
        raise AssertionError("validating recovery gave atomicity violations")
    return {"violation_cells_validate": violations,
            "atomicity_cells_by_policy": atom}


def phase_kv() -> None:
    """The KV serving family on the card: its integer math, then the KV
    figure's full matrix, batched against measure."""
    if repro_torch.get_device().type != "cuda":
        raise AssertionError("the KV phase must run its math on the card")
    emit({"phase": "kv_math", **_kv_math()})
    kw = dict(strategies=KV_STRATEGIES, plans=_kv_plans(),
              cfg=NVMConfig(cache_bytes=1024 * 1024), engine="fork",
              workers=1)
    per_workload, every = [], []
    for spec in KV_WORKLOADS:
        # counts to zero just before the path, read just after
        mm_kernel.launches = cv_kernel.launches = fa_kernel.launches = 0
        ss_kernel.launches = 0
        batched.reset_profile()
        batched_engine.reset_stats()
        t0 = time.perf_counter()
        cells = sweep([spec], mode="batched", **kw)
        torch.cuda.synchronize()
        t_batched = time.perf_counter() - t0
        profile = dict(batched.profile)
        overturned = batched_engine.stats["kv_overturned"]
        if launch_counts() != dict.fromkeys(launch_counts(), 0):
            raise AssertionError(f"{spec}: the KV sweep launched a kernel: "
                                 f"{launch_counts()}")
        t0 = time.perf_counter()
        measured = sweep([spec], mode="measure", **kw)
        t_measure = time.perf_counter() - t0
        if len(cells) != len(measured) or not cells:
            raise AssertionError(f"{spec}: {len(cells)} batched cells vs "
                                 f"{len(measured)} measure cells")
        for got, want in zip(cells, measured):
            if _cell(got) != _cell(want):
                raise AssertionError(
                    f"{spec}: batched cell differs from measure cell\n"
                    f"batched: {_cell(got)}\nmeasure: {_cell(want)}")
        fallbacks = sum("batched_fallback" in c.info for c in cells)
        if fallbacks:
            raise AssertionError(f"{spec}: {fallbacks} cells fell back")
        if overturned:
            raise AssertionError(f"{spec}: the host overturned {overturned} "
                                 f"verdicts of the device math")
        if profile["kv_checksum_calls"] <= 0:
            raise AssertionError(f"{spec}: the KV math never ran")
        every += measured
        transfer = (profile["upload_seconds"] + profile["download_seconds"])
        per_workload.append({
            "workload": [spec[0], spec[1]], "cells": len(cells),
            "adcc_cells": sum(c.strategy == "adcc" for c in cells),
            "batched_seconds": t_batched, "measure_seconds": t_measure,
            "fallbacks": fallbacks, "overturned": overturned,
            "kv_checksum_calls": profile["kv_checksum_calls"],
            "kv_checksum_rows": profile["kv_checksum_rows"],
            "checksum_rows_per_call": (profile["kv_checksum_rows"]
                                       / profile["kv_checksum_calls"]),
            "kv_value_calls": profile["kv_value_calls"],
            "kv_value_rows": profile["kv_value_rows"],
            "value_rows_per_call": (profile["kv_value_rows"]
                                    / max(1, profile["kv_value_calls"])),
            "device_seconds": profile["device_seconds"],
            "transfer_seconds": transfer,
            "host_seconds": t_batched - transfer - profile["device_seconds"],
        })
        emit({"phase": "kv", **per_workload[-1]})
    emit({"phase": "kv_total",
          "cells": sum(w["cells"] for w in per_workload),
          "batched_seconds": sum(w["batched_seconds"] for w in per_workload),
          "measure_seconds": sum(w["measure_seconds"] for w in per_workload),
          "census": _kv_census(every)})


def _emu_trace(n_elems: int, n_ops: int, seed: int) -> list:
    """The emulator benchmark's trace (benchmarks/emu_bench.py
    ``make_trace``): (op, lo, hi) spans of 2048-16384 elements, writes
    and reads dominating, flushes of a span or of everything between."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        u = rng.random()
        span = int(rng.integers(2048, 16384))
        lo = int(rng.integers(0, max(1, n_elems - span)))
        hi = min(n_elems, lo + span)
        if u < 0.50:
            ops.append(("write", lo, hi))
        elif u < 0.80:
            ops.append(("read", lo, hi))
        elif u < 0.95:
            ops.append(("flush", lo, hi))
        else:
            ops.append(("flush", 0, n_elems))
    return ops


def _replay(backend: str, n_elems: int, cache_bytes: int, trace,
            replacement: str) -> dict:
    """One emulator over one region replaying ``trace``: its image,
    traffic stats, wall seconds, and (device) how many span ops took the
    device path and how many declined it."""
    emu = CrashEmulator(NVMConfig(backend=backend, cache_bytes=cache_bytes,
                                  replacement=replacement))
    region = emu.alloc("data", (n_elems,), np.float64)
    region.view[:] = np.arange(n_elems, dtype=np.float64)
    batched.reset_profile()
    t0 = time.perf_counter()
    for op, lo, hi in trace:
        getattr(emu, op)("data", lo, hi)
    emu.drain()
    seconds = time.perf_counter() - t0
    return {"image": emu.store.image["data"].copy(),
            "stats": dataclasses.asdict(emu.stats), "seconds": seconds,
            "device_ops": getattr(emu.backend, "device_ops", 0),
            "declined_ops": getattr(emu.backend, "declined_ops", 0),
            "profile": dict(batched.profile)}


def _same_replay(name: str, a: dict, b: dict) -> None:
    if not np.array_equal(a["image"], b["image"]):
        raise AssertionError(f"{name}: NVM images differ")
    if a["stats"] != b["stats"]:
        raise AssertionError(f"{name}: traffic stats differ: {a['stats']} "
                             f"vs {b['stats']}")


def _replay_line(run: dict) -> dict:
    prof = run["profile"]
    return {"seconds": run["seconds"], "device_ops": run["device_ops"],
            "declined_ops": run["declined_ops"],
            "cache_op_calls": prof["cache_op_calls"],
            "validity_calls": prof["validity_calls"],
            "upload_seconds": prof["upload_seconds"],
            "device_seconds": prof["device_seconds"],
            "download_seconds": prof["download_seconds"]}


def phase_device() -> None:
    """The ``device`` emulator backend on the card against
    ``vectorized``: identical images, traffic stats and cells."""
    # (a) the streaming prefix: every write and read spans the region, the
    # cache holds it, so every span op must take the device path. One
    # device run first loads the torch ops it uses on the card (reported
    # on its own), then the runs alternate, vectorized first
    n = PREFIX_ELEMS
    trace = [(op, 0, n) for _ in range(PREFIX_PASSES)
             for op in ("write", "read", "flush")]
    span_ops = 2 * PREFIX_PASSES
    first = _replay("device", n, n * 8, trace, "lru")
    runs = {"vectorized": [], "device": [first]}
    for backend in ("vectorized", "device", "device", "vectorized"):
        runs[backend].append(_replay(backend, n, n * 8, trace, "lru"))
    for dev_run in runs["device"]:
        _same_replay("prefix trace", runs["vectorized"][0], dev_run)
        if dev_run["device_ops"] != span_ops or dev_run["declined_ops"]:
            raise AssertionError(
                f"prefix trace: {dev_run['device_ops']} of {span_ops} span "
                f"ops on the device, {dev_run['declined_ops']} declined")
    _same_replay("prefix trace", runs["vectorized"][0],
                 runs["vectorized"][1])
    emit({"phase": "device_prefix", "elements": n, "passes": PREFIX_PASSES,
          "cache_bytes": n * 8, "replacement": "lru",
          "vectorized_seconds": [r["seconds"] for r in runs["vectorized"]],
          "device_first": _replay_line(first),
          "device": [_replay_line(r) for r in runs["device"][1:]]})

    # (b) the emulator benchmark's mixed trace under eviction pressure
    trace = _emu_trace(EMU_ELEMS, EMU_OPS, EMU_SEED)
    cache = int(EMU_ELEMS * 8 * EMU_CACHE_FRAC)
    for replacement in ("lru", "fifo"):
        vec = _replay("vectorized", EMU_ELEMS, cache, trace, replacement)
        dev = _replay("device", EMU_ELEMS, cache, trace, replacement)
        _same_replay(f"emulator trace {replacement}", vec, dev)
        emit({"phase": "device_emu_trace", "elements": EMU_ELEMS,
              "ops": EMU_OPS, "cache_bytes": cache,
              "replacement": replacement,
              "vectorized_seconds": vec["seconds"],
              "device": _replay_line(dev)})

    # (c) a batched sweep whose emulators run on the device backend, the
    # runs alternating
    kw = dict(strategies=STRATEGIES, plans=_torn_plans(), engine="fork",
              workers=1, mode="batched")
    lines = {"vectorized": [], "device": []}
    cells = {}
    for backend in ("vectorized", "device", "device", "vectorized"):
        mm_kernel.launches = cv_kernel.launches = fa_kernel.launches = 0
        batched.reset_profile()
        t0 = time.perf_counter()
        got = sweep([DEVICE_SWEEP_WORKLOAD],
                    cfg=NVMConfig(cache_bytes=1024 * 1024, backend=backend),
                    **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        prof = dict(batched.profile)
        transfer = (prof["shared_upload_seconds"] + prof["upload_seconds"]
                    + prof["download_seconds"])
        host = seconds - transfer - prof["device_seconds"]
        lines[backend].append({
            "batched_seconds": seconds, "host_seconds": host,
            "host_share": host / seconds,
            "abft_matmul_launches": mm_kernel.launches,
            "cache_op_calls": prof["cache_op_calls"],
            "validity_calls": prof["validity_calls"]})
        if mm_kernel.launches <= 0:
            raise AssertionError(f"the batched sweep on {backend} never "
                                 f"launched abft_matmul")
        if backend in cells and [_cell(c) for c in cells[backend]] \
                != [_cell(c) for c in got]:
            raise AssertionError(f"two batched sweeps on {backend} differ")
        cells[backend] = got
    if [_cell(c) for c in cells["device"]] \
            != [_cell(c) for c in cells["vectorized"]]:
        raise AssertionError("the batched sweep on the device backend "
                             "differs from the vectorized one")
    if any("batched_fallback" in c.info for c in cells["device"]
           if c.strategy == "adcc"):
        raise AssertionError("an adcc cell fell back on the device backend")
    emit({"phase": "device_sweep",
          "workload": list(DEVICE_SWEEP_WORKLOAD),
          "cells": len(cells["device"]), **lines})


def _device_profile(fn) -> dict:
    """Kernel time on the card during ``fn()`` by torch.profiler, beside
    the host wall time around it (ending in a synchronize): the device's
    busy and idle share and the time by kernel group. Only events that ran
    on the device count (kernels, copies); "Command Buffer Full" marks the
    host waiting for room in the launch queue and is reported on its own.
    The profiler's own host cost inflates the wall time, so the idle share
    is an upper bound. A profiler that fails or sees no device time fails
    the phase: the serve line's breakdown must come from its own run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        prof.stop()
    groups = {"flash_attention": 0.0, "gemm": 0.0, "copy_cast": 0.0,
              "other": 0.0}
    by_name, queue_full, n_device = {}, 0.0, 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        sec = evt.time_range.elapsed_us() / 1e6
        name = evt.name
        if name.startswith("Command Buffer Full"):
            queue_full += sec
            continue
        n_device += 1
        by_name[name] = by_name.get(name, 0.0) + sec
        low = name.lower()
        if "flash_fwd" in low:
            groups["flash_attention"] += sec
        elif any(t in low for t in ("gemm", "gemv", "nvjet", "xmma",
                                    "cutlass")):
            groups["gemm"] += sec
        elif "copy" in low or "memcpy" in low:
            groups["copy_cast"] += sec
        else:
            groups["other"] += sec
    busy = sum(by_name.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "device_s_by_group": groups,
            "device_events": n_device,
            "command_buffer_full_s": queue_full,
            "top": [[name[:80], sec] for name, sec in top]}


def _argmax_share(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.argmax(dim=-1) == b.argmax(dim=-1)).float().mean())


def _logits_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| of two (B, S, vocab) logit tensors, one sequence at a
    time (a float64 copy of the whole prefill's logits would be 8 GB)."""
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def phase_serve(records: list) -> None:
    """llama3-8b at full width and depth through the port's model API,
    random weights from a seeded generator on the card."""
    dev = torch.device("cuda")
    cfg = get_config(SERVE_ARCH)
    api = build_model(cfg)
    B, S = SERVE_BATCH, SERVE_PROMPT
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    lm = api.init(torch.Generator(device=dev).manual_seed(SERVE_SEED))
    batch = make_batch(cfg, B, S,
                       torch.Generator(device=dev).manual_seed(SERVE_SEED + 1))
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    param_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())

    # prefill with flash attention: counts to zero just before, read after
    mm_kernel.launches = cv_kernel.launches = fa_kernel.launches = 0
    t0 = time.perf_counter()
    logits = api.forward(lm, batch, flash=True)
    torch.cuda.synchronize()
    prefill_first_seconds = time.perf_counter() - t0
    launches = {"abft_matmul": mm_kernel.launches,
                "tile_sums": cv_kernel.launches,
                "flash_attention": fa_kernel.launches}
    if launches != {"abft_matmul": 0, "tile_sums": 0,
                    "flash_attention": cfg.n_layers}:
        raise AssertionError(f"prefill launched {launches}, expected "
                             f"flash_attention x {cfg.n_layers} and no other")
    if logits.shape != (B, S, cfg.vocab_size) \
            or logits.dtype != torch.bfloat16:
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             f"{logits.dtype}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite")
    del logits
    # the same prefill again, for its steady time
    t0 = time.perf_counter()
    logits = api.forward(lm, batch, flash=True)
    torch.cuda.synchronize()
    prefill_seconds = time.perf_counter() - t0

    # the plain-attention forward on the same weights
    t0 = time.perf_counter()
    plain = api.forward(lm, batch, flash=False)
    torch.cuda.synchronize()
    plain_seconds = time.perf_counter() - t0
    if fa_kernel.launches != 2 * cfg.n_layers:
        raise AssertionError("the plain forward launched flash_attention")
    flash_err = _logits_err(logits, plain)
    agree = _argmax_share(logits, plain)
    logit_absmax = float(plain.abs().max())
    if flash_err > SERVE_ATOL or agree < SERVE_ARGMAX_FLOOR:
        raise AssertionError(f"flash forward differs from the plain forward "
                             f"by {flash_err} (bound {SERVE_ATOL}), argmax "
                             f"agreement {agree} (floor {SERVE_ARGMAX_FLOOR})")
    n = SERVE_TEACHER_TOKENS
    plain_prefix = plain[:, :n].clone()
    del logits, plain
    torch.cuda.empty_cache()
    f16 = _serve_f16(cfg, lm, batch)

    # teacher-forced decode of the first prompt tokens == plain forward
    cache, _ = api.init_cache(B, S)
    outs = []
    for t in range(n):
        lg, cache = api.decode_step(lm, cache, batch["tokens"][:, t:t + 1], t)
        outs.append(lg)
    teacher = torch.cat(outs, dim=1)
    teacher_err = _logits_err(teacher, plain_prefix)
    teacher_agree = _argmax_share(teacher, plain_prefix)
    if teacher_err > SERVE_ATOL or teacher_agree < SERVE_ARGMAX_FLOOR:
        raise AssertionError(f"teacher-forced decode differs from the plain "
                             f"forward by {teacher_err} (bound {SERVE_ATOL}), "
                             f"argmax agreement {teacher_agree} "
                             f"(floor {SERVE_ARGMAX_FLOOR})")
    del cache, outs, teacher, plain_prefix

    # greedy decode into a cache of the prompt's length
    cache, _ = api.init_cache(B, S)
    tok = batch["tokens"][:, :1]
    generated = []
    before = fa_kernel.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pos in range(SERVE_DECODE_STEPS):
        lg, cache = api.decode_step(lm, cache, tok, pos)
        tok = lg.argmax(dim=-1).to(torch.int32)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_seconds = time.perf_counter() - t0
    if fa_kernel.launches != before:
        raise AssertionError("decode launched flash_attention")
    gen = torch.cat(generated, dim=1)
    if gen.shape != (B, SERVE_DECODE_STEPS) or int(gen.min()) < 0 \
            or int(gen.max()) >= cfg.vocab_size:
        raise AssertionError(f"greedy tokens out of range: {gen.shape}")

    # where the time goes: one traced prefill, four traced decode steps
    def decode4():
        nonlocal tok, cache
        for pos in range(SERVE_DECODE_STEPS, SERVE_DECODE_STEPS + 4):
            lg, cache = api.decode_step(lm, cache, tok, pos)
            tok = lg.argmax(dim=-1).to(torch.int32)

    profiles = {"decode_4_steps": _device_profile(decode4),
                "prefill": _device_profile(
                    lambda: api.forward(lm, batch, flash=True))}

    for rec in records:
        if rec["name"] == "flash_attention":
            rec["launches"] = launches["flash_attention"]
    emit({"phase": "serve", "arch": SERVE_ARCH,
          "n_layers": cfg.n_layers, "depth_cut": None,
          "d_model": cfg.d_model, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
          "param_gb": param_bytes / 1e9, "init_seconds": init_seconds,
          "batch": B, "prompt": S,
          "prefill_first_seconds": prefill_first_seconds,
          "prefill_seconds": prefill_seconds,
          "prefill_tokens_per_s": B * S / prefill_seconds,
          "plain_prefill_seconds": plain_seconds,
          "plain_prefill_tokens_per_s": B * S / plain_seconds,
          "prefill_launches": launches,
          "f16_prefill": f16,
          "flash_vs_plain_max_abs_err": flash_err,
          "flash_vs_plain_argmax_agree": agree,
          "logit_absmax": logit_absmax,
          "teacher_tokens": n, "teacher_max_abs_err": teacher_err,
          "teacher_argmax_agree": teacher_agree, "atol": SERVE_ATOL,
          "argmax_floor": SERVE_ARGMAX_FLOOR,
          "decode_steps": SERVE_DECODE_STEPS, "decode_seconds": decode_seconds,
          "decode_tokens_per_s": B * SERVE_DECODE_STEPS / decode_seconds,
          "decode_ms_per_step": 1e3 * decode_seconds / SERVE_DECODE_STEPS,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "profile": profiles})
    del lm, cache
    torch.cuda.empty_cache()


def _serve_f16(cfg, lm, batch) -> dict:
    """llama3-8b's flash prefill once more in float16 compute on the same
    weights: every flash launch held to the kernel's plain version at the
    f16 tolerance (``_FlashChecked``), one launch per layer, then the
    logits against the plain-attention forward in float16 within
    ``SERVE_F16_ATOL`` and the argmax share above ``SERVE_ARGMAX_FLOOR``."""
    api16 = build_model(dataclasses.replace(cfg, compute_dtype="float16"))
    fa_kernel.launches = 0
    with _FlashChecked() as checked:
        logits = api16.forward(lm, batch, flash=True)
    torch.cuda.synchronize()
    launches = fa_kernel.launches
    if launches != cfg.n_layers or len(checked.errs) != cfg.n_layers:
        raise AssertionError(f"f16 prefill launched flash_attention "
                             f"{launches} times, expected {cfg.n_layers}")
    if logits.dtype != torch.float16 \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"f16 prefill logits {logits.dtype}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    del logits
    t0 = time.perf_counter()
    logits = api16.forward(lm, batch, flash=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = api16.forward(lm, batch, flash=False)
    torch.cuda.synchronize()
    plain_seconds = time.perf_counter() - t0
    err, agree = _logits_err(logits, plain), _argmax_share(logits, plain)
    absmax = float(plain.abs().max())
    del logits, plain
    torch.cuda.empty_cache()
    if err > SERVE_F16_ATOL or agree < SERVE_ARGMAX_FLOOR:
        raise AssertionError(f"f16 flash forward differs from the plain one "
                             f"by {err} (bound {SERVE_F16_ATOL}), argmax "
                             f"agreement {agree} (floor {SERVE_ARGMAX_FLOOR})")
    return {"compute_dtype": "float16", "flash_launches": launches,
            "launch_max_abs_err": max(checked.errs),
            "launch_tolerance": list(fa_kernel.tolerance(torch.float16)),
            "prefill_seconds": seconds, "plain_prefill_seconds": plain_seconds,
            "flash_vs_plain_max_abs_err": err,
            "flash_vs_plain_argmax_agree": agree, "logit_absmax": absmax,
            "atol": SERVE_F16_ATOL, "argmax_floor": SERVE_ARGMAX_FLOOR}


class _Routing:
    """Records the port's router calls while it is open: per call the
    chosen ids (T, K) and the float32 probabilities (T, E)."""

    def __enter__(self):
        self.calls = []
        self._real = moe_mod.router_topk

        def spy(cfg, w, x):
            out = self._real(cfg, w, x)
            probs = torch.softmax(x.to(torch.float32) @ w.to(torch.float32),
                                  dim=-1)
            self.calls.append((out[1], probs))
            return out

        moe_mod.router_topk = spy
        return self

    def __exit__(self, *exc):
        moe_mod.router_topk = self._real


class _FlashChecked:
    """While open, every flash_attention call of the model's layers is
    held against the kernel's plain version on the same q/k/v, at the
    kernel's tolerances for its type; per call, its max abs error and the
    KV heads it was given. The plain version launches no kernel, so the
    counts are the model's."""

    def __enter__(self):
        self.errs, self.kv_heads = [], []
        self._real = layers_mod.flash_attention

        def checked(q, k, v, *, causal=True):
            out = self._real(q, k, v, causal=causal)
            self.kv_heads.append(int(k.shape[2]))
            rtol, atol = fa_kernel.tolerance(q.dtype)
            name = (f"flash_attention in the prefill, launch "
                    f"{len(self.errs) + 1}, q {tuple(q.shape)} "
                    f"{str(q.dtype)[6:]}")
            self.errs.append(check_close(
                name, out, fa_kernel.flash_attention_plain(
                    q, k, v, causal=causal), rtol, atol))
            return out

        layers_mod.flash_attention = checked
        return self

    def __exit__(self, *exc):
        layers_mod.flash_attention = self._real


def _flash_layer_by_layer(cfg, lm, batch) -> dict:
    """bf16, each layer twice on the plain forward's own layer input:
    with the flash kernel and with plain attention. Tokens routed alike
    must agree within two bf16 ulps of the layer's largest output."""
    h, positions, _ = lm_mod._embed_batch(cfg, lm, batch)
    sames, worst, bounds = [], 0.0, []
    with torch.no_grad():
        for lp in lm.layers:
            with _Routing() as plain_r:
                plain, _ = lm_mod._layer_apply(cfg, lp, h, positions)
            with _Routing() as flash_r:
                flash, _ = lm_mod._layer_apply(cfg, lp, h, positions,
                                               flash=True)
            (ids, probs), = plain_r.calls
            (f_ids, _), = flash_r.calls
            same = moe_mod.same_routing(cfg, ids, probs, f_ids)
            sames.append(same)
            p = plain.reshape(same.numel(), -1)[same].float()
            f = flash.reshape(same.numel(), -1)[same].float()
            bound = 2.0 ** -6 * float(p.abs().max())
            err = float((f - p).abs().max())
            if err > bound:
                raise AssertionError(f"flash layer differs from plain by "
                                     f"{err} (bound {bound})")
            worst = max(worst, err)
            bounds.append(bound)
            h = plain
    return {"tokens": int(positions.numel()), "layers": cfg.n_layers,
            "routing_flips": moe_mod.check_flip_share(sames), "max_abs_err": worst,
            "bounds": bounds}


def _teacher_forced_f32(cfg, lm, tokens) -> dict:
    """deepseek in float32 compute on the same weights: teacher-forced
    decode of ``tokens`` (B, n), absorbed MLA against the latent cache,
    against a forward of the same tokens. Routing of the two by
    ``MOE_F32_ROUTING_MARGIN``; logits within ``MOE_F32_TEACHER_ATOL`` at
    each sequence's positions before its first differently routed token
    (all of them where none is)."""
    fapi = build_model(dataclasses.replace(cfg, compute_dtype="float32"))
    B, n = tokens.shape
    L_ = cfg.n_layers
    with torch.no_grad():
        with _Routing() as fwd_r:
            fwd = fapi.forward(lm, {"tokens": tokens})
        cache, _ = fapi.init_cache(B, n)
        outs = []
        with _Routing() as dec_r:
            for t in range(n):
                lg, cache = fapi.decode_step(lm, cache, tokens[:, t:t + 1], t)
                outs.append(lg)
    dec = torch.cat(outs, dim=1)
    if fwd.dtype != torch.float32 or dec.shape != fwd.shape \
            or len(fwd_r.calls) != L_ or len(dec_r.calls) != n * L_:
        raise AssertionError(f"f32 teacher-forced decode: {dec.shape} "
                             f"{fwd.dtype}, router calls "
                             f"{len(fwd_r.calls)} / {len(dec_r.calls)}")
    routed_alike = torch.ones((B, n), dtype=torch.bool, device=fwd.device)
    for layer, (ids, probs) in enumerate(fwd_r.calls):
        # the decode's calls go step by step, each through every layer
        dec_ids = torch.stack([dec_r.calls[t * L_ + layer][0]
                               for t in range(n)], dim=1)     # (B, n, K)
        same = moe_mod.same_routing(cfg, ids, probs,
                                    dec_ids.reshape(B * n, -1),
                                    margin=MOE_F32_ROUTING_MARGIN)
        routed_alike &= same.reshape(B, n)
    # a sequence's positions before its first differently routed token
    clean = torch.cumprod(routed_alike.to(torch.int32), dim=1).bool()
    if not bool(clean[:, 0].all()):
        raise AssertionError("f32 teacher-forced decode: a first token "
                             "routed differently, nothing to compare")
    err = float((dec - fwd).abs().amax(dim=-1)[clean].max())
    if err > MOE_F32_TEACHER_ATOL:
        raise AssertionError(f"f32 teacher-forced decode differs from the "
                             f"forward by {err} (bound "
                             f"{MOE_F32_TEACHER_ATOL})")
    return {"tokens": B * n, "router_decisions": B * n * L_,
            "routed_differently": int((~routed_alike).sum()),
            "positions_compared": int(clean.sum()),
            "max_abs_err": err, "atol": MOE_F32_TEACHER_ATOL,
            "routing_margin": MOE_F32_ROUTING_MARGIN,
            "argmax_agree": _argmax_share(dec, fwd),
            "logit_absmax": float(fwd.abs().max())}


_CASTS = ("aten::to", "aten::_to_copy", "aten::copy_")


def _split_by_op(fn, spots: dict, groups, group_of) -> dict:
    """Device time of ``fn()`` by group, from torch.profiler: each kernel
    is attributed through the chain of CPU operations that launched it.
    ``spots`` maps a label to (module, function name): that function runs
    inside a range ``split::<label>`` while profiled. ``group_of(names)``
    names a kernel's group (one of ``groups``) from the chain's names,
    innermost first. Kernels launched outside any CPU operation (the
    port's own, through ctypes) are not seen: use it where none runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    real = {k: getattr(m, a) for k, (m, a) in spots.items()}

    def ranged(label, f):
        def run(*a, **kw):
            with record_function(label):
                return f(*a, **kw)
        return run

    for k, (m, a) in spots.items():
        setattr(m, a, ranged(f"split::{k}", real[k]))
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.stop()
    finally:
        for k, (m, a) in spots.items():
            setattr(m, a, real[k])
    out = dict.fromkeys(groups, 0.0)
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU or not evt.kernels:
            continue
        names, node = [], evt
        while node is not None:
            names.append(node.name)
            node = node.cpu_parent
        out[group_of(names)] += sum(k.duration for k in evt.kernels) / 1e6
    busy = sum(out.values())
    if busy <= 0:
        raise AssertionError("the profiler attributed no device time")
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "device_s_by_group": out}


def _prefill_split(fn) -> dict:
    """Device time of one deepseek prefill by group (:func:`_split_by_op`):
    the MoE layer (``moe_apply_dense``: its expert einsums apart from the
    router and combine), the MLA layer (``mla_apply``), the weight and
    activation casts (``aten::to`` / ``aten::copy_``) apart wherever they
    run, and everything else (embedding, norms, residuals, head)."""
    def group_of(names):
        if any(n in _CASTS for n in names):
            return "casts"
        if "split::moe" in names:
            return ("expert_einsums" if "aten::einsum" in names
                    and names.index("aten::einsum")
                    < names.index("split::moe")
                    else "moe_router_and_combine")
        return "mla" if "split::mla" in names else "other"

    return _split_by_op(
        fn, {"moe": (moe_mod, "moe_apply_dense"),
             "mla": (mla_mod, "mla_apply")},
        ("expert_einsums", "moe_router_and_combine", "mla", "casts",
         "other"), group_of)


def phase_serve_moe(records: list) -> None:
    """deepseek-v2-lite-16b at full width and depth, then kimi-k2 at its
    reduced size, through the port's model API; random weights from
    seeded generators on the card."""
    dev = torch.device("cuda")
    cfg = get_config(MOE_ARCH)
    api = build_model(cfg)
    B, S = MOE_BATCH, MOE_PROMPT
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    lm = api.init(torch.Generator(device=dev).manual_seed(MOE_SEED))
    batch = make_batch(cfg, B, S,
                       torch.Generator(device=dev).manual_seed(MOE_SEED + 1))
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    param_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())

    # the prefill asks for flash attention: MLA has no flash branch, so
    # no kernel of the port launches. Counts to zero just before, read after
    mm_kernel.launches = cv_kernel.launches = fa_kernel.launches = 0
    t0 = time.perf_counter()
    logits = api.forward(lm, batch, flash=True)
    torch.cuda.synchronize()
    prefill_first_seconds = time.perf_counter() - t0
    launches = {"abft_matmul": mm_kernel.launches,
                "tile_sums": cv_kernel.launches,
                "flash_attention": fa_kernel.launches}
    if any(launches.values()):
        raise AssertionError(f"deepseek's prefill launched {launches}: MLA "
                             f"takes no flash branch")
    if logits.shape != (B, S, cfg.vocab_size) \
            or logits.dtype != torch.bfloat16:
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             f"{logits.dtype}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite")
    del logits
    t0 = time.perf_counter()
    logits = api.forward(lm, batch, flash=True)
    torch.cuda.synchronize()
    prefill_seconds = time.perf_counter() - t0
    if not torch.equal(api.forward(lm, batch, flash=False), logits):
        raise AssertionError("deepseek's prefill depends on flash")
    logit_absmax = float(logits.abs().max())
    n = MOE_TEACHER_TOKENS
    prefix = logits[:, :n].clone()
    del logits
    torch.cuda.empty_cache()

    # teacher-forced decode: absorbed MLA against the latent cache
    cache, _ = api.init_cache(B, S)
    outs = []
    for t in range(n):
        lg, cache = api.decode_step(lm, cache, batch["tokens"][:, t:t + 1], t)
        outs.append(lg)
    teacher = torch.cat(outs, dim=1)
    teacher_err = _logits_err(teacher, prefix)
    teacher_agree = _argmax_share(teacher, prefix)
    if teacher_err > MOE_TEACHER_ATOL \
            or teacher_agree < MOE_TEACHER_ARGMAX_FLOOR:
        raise AssertionError(f"teacher-forced decode differs from the "
                             f"prefill by {teacher_err} (bound "
                             f"{MOE_TEACHER_ATOL}), argmax agreement "
                             f"{teacher_agree} (floor "
                             f"{MOE_TEACHER_ARGMAX_FLOOR})")
    del cache, outs, teacher, prefix
    teacher_f32 = _teacher_forced_f32(cfg, lm, batch["tokens"][:, :n])

    # greedy decode into a latent cache of the prompt's length
    cache, _ = api.init_cache(B, S)
    latent_bytes = sum(c.numel() * c.element_size() for c in cache.values())
    expanded_bytes = (cfg.n_layers * B * S * cfg.n_heads
                      * (cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim)
                      * torch.finfo(torch.bfloat16).bits // 8)
    tok = batch["tokens"][:, :1]
    generated = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pos in range(MOE_DECODE_STEPS):
        lg, cache = api.decode_step(lm, cache, tok, pos)
        tok = lg.argmax(dim=-1).to(torch.int32)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_seconds = time.perf_counter() - t0
    gen = torch.cat(generated, dim=1)
    if gen.shape != (B, MOE_DECODE_STEPS) or int(gen.min()) < 0 \
            or int(gen.max()) >= cfg.vocab_size or fa_kernel.launches:
        raise AssertionError(f"greedy decode: tokens {gen.shape}, flash "
                             f"launches {fa_kernel.launches}")
    del cache
    split = _prefill_split(lambda: api.forward(lm, batch, flash=True))
    peak = torch.cuda.max_memory_allocated()
    del lm, batch
    gc.collect()
    torch.cuda.empty_cache()

    kimi = _serve_kimi()
    for rec in records:
        if rec["name"] == "flash_attention":
            rec["launches_by_path"] = {
                "serve": rec["launches"], "serve_moe deepseek prefill": launches["flash_attention"],
                "serve_moe kimi bf16 prefill": kimi["launches"]}
    emit({"phase": "serve_moe", "arch": MOE_ARCH,
          "n_layers": cfg.n_layers, "depth_cut": None,
          "d_model": cfg.d_model, "n_heads": cfg.n_heads,
          "n_experts": cfg.n_experts, "experts_per_token":
              cfg.experts_per_token, "n_shared_experts": cfg.n_shared_experts,
          "moe_d_ff": cfg.moe_d_ff, "kv_lora_rank": cfg.kv_lora_rank,
          "vocab": cfg.vocab_size, "param_dtype": cfg.param_dtype,
          "compute_dtype": cfg.compute_dtype,
          "params": cfg.param_count(),
          "param_gb": param_bytes / 1e9, "init_seconds": init_seconds,
          "batch": B, "prompt": S, "prefill_launches": launches,
          "prefill_first_seconds": prefill_first_seconds,
          "prefill_seconds": prefill_seconds,
          "prefill_tokens_per_s": B * S / prefill_seconds,
          "logit_absmax": logit_absmax,
          "teacher_tokens": n, "teacher_max_abs_err": teacher_err,
          "teacher_argmax_agree": teacher_agree,
          "teacher_atol": MOE_TEACHER_ATOL,
          "teacher_argmax_floor": MOE_TEACHER_ARGMAX_FLOOR,
          "teacher_f32": teacher_f32,
          "decode_steps": MOE_DECODE_STEPS, "decode_seconds": decode_seconds,
          "decode_ms_per_step": 1e3 * decode_seconds / MOE_DECODE_STEPS,
          "latent_cache_gb": latent_bytes / 1e9,
          "expanded_cache_gb": expanded_bytes / 1e9,
          "peak_memory_gb": peak / 1e9, "prefill_split": split,
          "kimi": kimi})


def _serve_kimi() -> dict:
    """kimi-k2 (MoE with GQA) at its reduced size: the flash branch of the
    moe family, once per layer in bf16 and in float32."""
    dev = torch.device("cuda")
    cfg = get_config(KIMI_ARCH).reduced()
    api = build_model(cfg)
    B, S = KIMI_BATCH, KIMI_PROMPT
    lm = api.init(torch.Generator(device=dev).manual_seed(KIMI_SEED))
    batch = make_batch(cfg, B, S,
                       torch.Generator(device=dev).manual_seed(KIMI_SEED + 1))
    mm_kernel.launches = cv_kernel.launches = fa_kernel.launches = 0
    with _FlashChecked() as bf16_checked:
        flash = api.forward(lm, batch, flash=True)
    torch.cuda.synchronize()
    launches = {"abft_matmul": mm_kernel.launches,
                "tile_sums": cv_kernel.launches,
                "flash_attention": fa_kernel.launches}
    if launches != {"abft_matmul": 0, "tile_sums": 0,
                    "flash_attention": cfg.n_layers}:
        raise AssertionError(f"kimi's prefill launched {launches}, expected "
                             f"flash_attention x {cfg.n_layers} and no other")
    if flash.shape != (B, S, cfg.vocab_size) or flash.dtype != torch.bfloat16 \
            or not bool(torch.isfinite(flash).all()):
        raise AssertionError(f"kimi prefill logits {tuple(flash.shape)} "
                             f"{flash.dtype}, or not finite")
    plain = api.forward(lm, batch, flash=False)
    bf16_err = _logits_err(flash, plain)
    bf16_agree = _argmax_share(flash, plain)
    if bf16_agree < SERVE_ARGMAX_FLOOR:
        raise AssertionError(f"kimi bf16 flash forward: argmax agreement "
                             f"{bf16_agree} (floor {SERVE_ARGMAX_FLOOR})")
    layers = _flash_layer_by_layer(cfg, lm, batch)
    # float32 compute on the same weights: the whole model
    fcfg = dataclasses.replace(cfg, compute_dtype="float32")
    fapi = build_model(fcfg)
    before = fa_kernel.launches
    with _FlashChecked() as f32_checked:
        f32_flash = fapi.forward(lm, batch, flash=True)
    f32_launches = fa_kernel.launches - before
    f32_plain = fapi.forward(lm, batch, flash=False)
    f32_err = _logits_err(f32_flash, f32_plain)
    f32_agree = _argmax_share(f32_flash, f32_plain)
    if f32_launches != cfg.n_layers or f32_err > KIMI_F32_ATOL \
            or f32_agree < SERVE_ARGMAX_FLOOR:
        raise AssertionError(f"kimi f32 flash forward: {f32_launches} "
                             f"launches, differs from plain by {f32_err} "
                             f"(bound {KIMI_F32_ATOL}), argmax {f32_agree}")
    # a few greedy decode steps
    cache, _ = api.init_cache(B, KIMI_DECODE_STEPS)
    tok = batch["tokens"][:, :1]
    before = fa_kernel.launches
    for pos in range(KIMI_DECODE_STEPS):
        lg, cache = api.decode_step(lm, cache, tok, pos)
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError("kimi decode logits are not finite")
        tok = lg.argmax(dim=-1).to(torch.int32)
    if fa_kernel.launches != before:
        raise AssertionError("kimi decode launched flash_attention")
    return {"arch": KIMI_ARCH, "reduced": True, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "n_experts": cfg.n_experts,
            "head_dim": cfg.resolved_head_dim, "batch": B, "prompt": S,
            "launches": launches["flash_attention"],
            "bf16_launch_max_abs_err": bf16_checked.errs,
            "f32_launch_max_abs_err": f32_checked.errs,
            "launch_tolerance": {"bf16": [FLASH_BF16_RTOL, FLASH_BF16_ATOL],
                                 "f32": FLASH_F32_TOL},
            "bf16_flash_vs_plain_max_abs_err": bf16_err,
            "bf16_flash_vs_plain_argmax_agree": bf16_agree,
            "bf16_layer_by_layer": layers,
            "f32_launches": f32_launches,
            "f32_flash_vs_plain_max_abs_err": f32_err,
            "f32_flash_vs_plain_argmax_agree": f32_agree,
            "f32_atol": KIMI_F32_ATOL, "argmax_floor": SERVE_ARGMAX_FLOOR,
            "decode_steps": KIMI_DECODE_STEPS}


def _launch_counts() -> dict:
    return {"abft_matmul": mm_kernel.launches,
            "tile_sums": cv_kernel.launches,
            "flash_attention": fa_kernel.launches}


def _teacher_forced(api, lm, tokens, ref) -> tuple:
    """Teacher-forced decode of ``tokens`` (B, n) from an empty cache,
    against ``ref`` logits (B, n, vocab): (max abs err, argmax share)."""
    B, n = tokens.shape
    cache, _ = api.init_cache(B, n)
    outs = []
    for t in range(n):
        lg, cache = api.decode_step(lm, cache, tokens[:, t:t + 1], t)
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    if dec.shape != ref.shape or not bool(torch.isfinite(dec).all()):
        raise AssertionError(f"teacher-forced decode: {tuple(dec.shape)} "
                             f"against {tuple(ref.shape)}, or not finite")
    return _logits_err(dec, ref), _argmax_share(dec, ref)


def _ssm_prefill_split(fn) -> dict:
    """Device time of one prefill of the recurrent families by group
    (:func:`_split_by_op`). Weight and activation casts (``aten::to`` /
    ``aten::copy_``) wherever they run; in a Mamba2 layer the causal conv
    (``_causal_conv``), the SSD within chunks (``_ssd_intra``), the scan
    across chunks (``_ssd_chunk_scan``), the in / out projections (its
    products outside those) and its other elementwise work; the shared
    attention block's attention (``attention_apply``); everything else
    (embedding, norms, residuals, the shared SwiGLU, head)."""
    def group_of(names):
        if any(n in _CASTS for n in names):
            return "casts"
        for label in ("conv", "ssd_intra", "chunk_scan", "attention"):
            if f"split::{label}" in names:
                return label
        if "split::mamba" in names:
            return ("projections" if any(n in ("aten::mm", "aten::matmul")
                                         for n in names) else "mamba_other")
        return "other"

    return _split_by_op(
        fn, {"mamba": (mamba2_mod, "mamba2_apply"),
             "conv": (mamba2_mod, "_causal_conv"),
             "ssd_intra": (mamba2_mod, "_ssd_intra"),
             "chunk_scan": (mamba2_mod, "_ssd_chunk_scan"),
             "attention": (layers_mod, "attention_apply")},
        ("casts", "conv", "ssd_intra", "chunk_scan", "projections",
         "mamba_other", "attention", "other"), group_of)


def _timed_steps(step, reps: int) -> list:
    """Host seconds of ``reps`` calls of ``step()``, each ending in a
    synchronize, after one call not timed."""
    step()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def _long_decode(cfg, api, lm, param_bytes: int) -> dict:
    """long_500k's decode shape: batch 1, one step at its last position
    (and one at ``LONG_SHORT_POS``) against a cache whose contents are
    seeded values, as if a prompt of that length had been decoded. The
    bound is the bytes the step must read (the whole cache, which the
    attention reads up to the position, and the weights) at the card's
    memory rate."""
    dev = torch.device("cuda")
    n = LONG_SHAPE.seq_len
    gen = torch.Generator(device=dev).manual_seed(SSM_SEED + 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache, _ = api.init_cache(LONG_SHAPE.global_batch, n)
    for _, t in tree_items(cache):
        t.normal_(0.0, 0.5, generator=gen)
    torch.cuda.synchronize()
    fill_seconds = time.perf_counter() - t0
    cache_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_items(cache))
    tok = torch.randint(0, cfg.vocab_size, (LONG_SHAPE.global_batch, 1),
                        generator=gen, device=dev, dtype=torch.int32)
    out = {}

    def step(pos):
        out["logits"] = api.decode_step(lm, cache, tok, pos)[0]

    times = {f"pos_{pos}": _timed_steps(lambda: step(pos), LONG_REPS)
             for pos in (LONG_SHORT_POS, n - 1)}
    logits = out["logits"]
    if logits.shape != (LONG_SHAPE.global_batch, 1, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"long_500k decode logits {tuple(logits.shape)}"
                             f" not finite or misshapen")
    med = {k: _median(v) for k, v in times.items()}
    bound_s = (cache_bytes + param_bytes) / PEAK_BYTES_PER_S
    del cache, out
    return {"shape": LONG_SHAPE.name, "batch": LONG_SHAPE.global_batch,
            "positions": [LONG_SHORT_POS, n - 1],
            "cache_gb": cache_bytes / 1e9, "cache_fill_seconds": fill_seconds,
            "step_seconds": times, "median_step_ms":
                {k: 1e3 * v for k, v in med.items()},
            "bound_ms": 1e3 * bound_s,
            "bound_share_at_last_pos": bound_s / med[f"pos_{n - 1}"],
            "logit_absmax": float(logits.float().abs().max()),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_serve_ssm() -> None:
    """mamba2-130m (ssm) and zamba2-1.2b (hybrid) at full width and depth
    through the port's model API, random weights from seeded generators
    on the card. Mamba2's state passing across chunks launches the
    port's ``ssd_state_pass`` forward kernel once a layer a forward; no
    other kernel of the port runs: the rest of Mamba2 is torch ops, and
    the hybrid's shared attention takes the plain branch, as the
    reference's (no flash branch)."""
    for arch in SSM_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _serve_recurrent(arch)


def _serve_recurrent(arch: str) -> None:
    dev = torch.device("cuda")
    cfg = get_config(arch)
    api = build_model(cfg)
    B, S, n = SSM_BATCH, SSM_PROMPT, SSM_TEACHER_TOKENS
    t0 = time.perf_counter()
    lm = api.init(torch.Generator(device=dev).manual_seed(SSM_SEED))
    batch = make_batch(cfg, B, S,
                       torch.Generator(device=dev).manual_seed(SSM_SEED + 1))
    torch.cuda.synchronize()
    init_seconds = time.perf_counter() - t0
    param_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())

    # counts to zero just before the model's path, read after all of it
    mm_kernel.launches = cv_kernel.launches = fa_kernel.launches = 0
    ss_kernel.launches = 0
    t0 = time.perf_counter()
    logits = api.forward(lm, batch)
    torch.cuda.synchronize()
    prefill_first_seconds = time.perf_counter() - t0
    if logits.shape != (B, S, cfg.vocab_size) \
            or logits.dtype != torch.bfloat16 \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             f"{logits.dtype}, or not finite")
    del logits
    t0 = time.perf_counter()
    logits = api.forward(lm, batch)
    torch.cuda.synchronize()
    prefill_seconds = time.perf_counter() - t0
    logit_absmax = float(logits.abs().max())
    prefix = logits[:, :n].clone()
    del logits
    torch.cuda.empty_cache()

    # teacher-forced decode against the prefill (bf16), then in float32
    # compute against a float32 forward of the same tokens
    tokens = batch["tokens"][:, :n]
    teacher_err, teacher_agree = _teacher_forced(api, lm, tokens, prefix)
    if teacher_err > SSM_TEACHER_ATOL \
            or teacher_agree < SSM_TEACHER_ARGMAX_FLOOR:
        raise AssertionError(f"{arch}: teacher-forced decode differs from "
                             f"the prefill by {teacher_err} (bound "
                             f"{SSM_TEACHER_ATOL}), argmax agreement "
                             f"{teacher_agree} (floor "
                             f"{SSM_TEACHER_ARGMAX_FLOOR})")
    fapi = build_model(dataclasses.replace(cfg, compute_dtype="float32"))
    f32_fwd = fapi.forward(lm, {"tokens": tokens})
    f32_err, f32_agree = _teacher_forced(fapi, lm, tokens, f32_fwd)
    if f32_fwd.dtype != torch.float32 or f32_err > SSM_F32_TEACHER_ATOL:
        raise AssertionError(f"{arch}: float32 teacher-forced decode differs"
                             f" from the forward by {f32_err} (bound "
                             f"{SSM_F32_TEACHER_ATOL})")
    del prefix, f32_fwd

    # greedy decode from the first prompt token
    cache, _ = api.init_cache(B, S)
    cache_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_items(cache))
    tok = batch["tokens"][:, :1]
    generated = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pos in range(SSM_DECODE_STEPS):
        lg, cache = api.decode_step(lm, cache, tok, pos)
        tok = lg.argmax(dim=-1).to(torch.int32)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_seconds = time.perf_counter() - t0
    gen = torch.cat(generated, dim=1)
    if gen.shape != (B, SSM_DECODE_STEPS) or int(gen.min()) < 0 \
            or int(gen.max()) >= cfg.vocab_size:
        raise AssertionError(f"greedy decode: tokens {tuple(gen.shape)}")
    del cache
    split = _ssm_prefill_split(lambda: api.forward(lm, batch))
    peak = torch.cuda.max_memory_allocated()
    long = _long_decode(cfg, api, lm, param_bytes)
    launches = _launch_counts()
    if any(launches.values()) or not ss_kernel.launches:
        raise AssertionError(f"{arch} launched {launches} and "
                             f"{ss_kernel.launches} ssd_state_pass: only the "
                             f"SSD's state passing reaches a kernel of the "
                             f"port")
    launches["ssd_state_pass"] = ss_kernel.launches
    del lm, batch
    emit({"phase": "serve_ssm", "arch": arch, "family": cfg.family,
          "n_layers": cfg.n_layers, "depth_cut": None,
          "d_model": cfg.d_model, "ssm_state": cfg.ssm_state,
          "ssm_heads": mamba2_mod.mamba2_dims(cfg)[1],
          "ssm_chunk": cfg.ssm_chunk,
          "shared_attention_sites": (len(hybrid_mod.segments(cfg))
                                     if cfg.family == "hybrid" else 0),
          "vocab": cfg.vocab_size, "param_dtype": cfg.param_dtype,
          "compute_dtype": cfg.compute_dtype, "params": cfg.param_count(),
          "param_gb": param_bytes / 1e9, "init_seconds": init_seconds,
          "batch": B, "prompt": S, "launches": launches,
          "prefill_first_seconds": prefill_first_seconds,
          "prefill_seconds": prefill_seconds,
          "prefill_tokens_per_s": B * S / prefill_seconds,
          "logit_absmax": logit_absmax,
          "teacher_tokens": n, "teacher_max_abs_err": teacher_err,
          "teacher_argmax_agree": teacher_agree,
          "teacher_atol": SSM_TEACHER_ATOL,
          "teacher_argmax_floor": SSM_TEACHER_ARGMAX_FLOOR,
          "teacher_f32_max_abs_err": f32_err,
          "teacher_f32_argmax_agree": f32_agree,
          "teacher_f32_atol": SSM_F32_TEACHER_ATOL,
          "decode_steps": SSM_DECODE_STEPS, "decode_seconds": decode_seconds,
          "decode_ms_per_step": 1e3 * decode_seconds / SSM_DECODE_STEPS,
          "decode_cache_gb": cache_bytes / 1e9,
          "peak_memory_gb": peak / 1e9, "prefill_split": split,
          "long_500k": long})


def phase_serve_vlm_audio(records: list) -> None:
    """qwen2-vl-2b (vlm) and hubert-xlarge (audio) at full width and depth
    through the port's model API, random weights from seeded generators
    on the card: serving, then train steps through ``build_train_step``."""
    for arch, serve in ((VLM_ARCH, _serve_vlm), (AUDIO_ARCH, _serve_audio)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        api = build_model(cfg)
        lm = api.init(torch.Generator(device="cuda").manual_seed(VA_SEED))
        line = serve(cfg, api, lm)
        if arch == VLM_ARCH:
            for rec in records:
                if rec["name"] == "flash_attention":
                    rec.setdefault("launches_by_path", {}).update({
                        "serve_vlm_audio qwen2-vl prefill":
                            line["prefill_launches"]["flash_attention"],
                        "serve_vlm_audio hubert prefill": 0})
        line["train"] = _va_train_steps(cfg, api, lm)
        del lm
        emit(line)


def _vlm_zero_patch(cfg, tokens) -> dict:
    """A vlm prompt of text only: no patches and three equal M-RoPE
    streams 0..n-1, the prompt a decode (text only, all streams at the
    cache index, as the reference's) reproduces."""
    B, n = tokens.shape
    pos = torch.arange(n, dtype=torch.int32, device=tokens.device)
    return {"tokens": tokens,
            "patches": torch.zeros((B, 0, cfg.d_model), device=tokens.device),
            "positions": pos[None, None].expand(3, B, n)}


def _serve_vlm(cfg, api, lm) -> dict:
    """qwen2-vl-2b: flash prefill of 2 x 4096 (1024 patches, 3072 text
    tokens) with every B3 launch held to the plain version, against the
    plain-attention forward; teacher-forced decode against a zero-patch
    prefill in bf16 and float32 compute; greedy decode; a profiler split."""
    dev = torch.device("cuda")
    B, S, n = VA_BATCH, VA_PROMPT, VLM_TEACHER_TOKENS
    batch = make_batch(cfg, B, S,
                       torch.Generator(device=dev).manual_seed(VA_SEED + 1))
    P = batch["patches"].shape[1]
    param_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    # counts to zero just before the model's path, read after it
    mm_kernel.launches = cv_kernel.launches = fa_kernel.launches = 0
    t0 = time.perf_counter()
    with _FlashChecked() as checked:
        logits = api.forward(lm, batch, flash=True)
    torch.cuda.synchronize()
    checked_seconds = time.perf_counter() - t0
    launches = _launch_counts()
    if launches != {"abft_matmul": 0, "tile_sums": 0,
                    "flash_attention": cfg.n_layers} \
            or len(checked.errs) != cfg.n_layers:
        raise AssertionError(f"qwen2-vl's prefill launched {launches}, "
                             f"{len(checked.errs)} checked; expected "
                             f"flash_attention x {cfg.n_layers} and no other")
    if logits.shape != (B, S, cfg.vocab_size) \
            or logits.dtype != torch.bfloat16 \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             f"{logits.dtype}, or not finite")
    del logits
    t0 = time.perf_counter()
    logits = api.forward(lm, batch, flash=True)
    torch.cuda.synchronize()
    prefill_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = api.forward(lm, batch, flash=False)
    torch.cuda.synchronize()
    plain_seconds = time.perf_counter() - t0
    if fa_kernel.launches != 2 * cfg.n_layers:
        raise AssertionError("the plain forward launched flash_attention")
    flash_err = _logits_err(logits, plain)
    agree = _argmax_share(logits, plain)
    logit_absmax = float(plain.abs().max())
    del logits, plain
    torch.cuda.empty_cache()
    if flash_err > VLM_FLASH_ATOL or agree < SERVE_ARGMAX_FLOOR:
        raise AssertionError(f"qwen2-vl flash forward differs from the plain"
                             f" forward by {flash_err} (bound "
                             f"{VLM_FLASH_ATOL}), argmax agreement {agree} "
                             f"(floor {SERVE_ARGMAX_FLOOR})")

    # teacher-forced decode of the first text tokens against a zero-patch
    # prefill of them, bf16 and float32 compute
    tokens = batch["tokens"][:, :n]
    prompt = _vlm_zero_patch(cfg, tokens)
    teacher_err, teacher_agree = _teacher_forced(
        api, lm, tokens, api.forward(lm, prompt))
    if teacher_err > VLM_TEACHER_ATOL \
            or teacher_agree < SSM_TEACHER_ARGMAX_FLOOR:
        raise AssertionError(f"qwen2-vl teacher-forced decode differs from "
                             f"the zero-patch prefill by {teacher_err} "
                             f"(bound {VLM_TEACHER_ATOL}), argmax agreement "
                             f"{teacher_agree} (floor "
                             f"{SSM_TEACHER_ARGMAX_FLOOR})")
    fapi = build_model(dataclasses.replace(cfg, compute_dtype="float32"))
    f32_fwd = fapi.forward(lm, prompt)
    f32_err, f32_agree = _teacher_forced(fapi, lm, tokens, f32_fwd)
    if f32_fwd.dtype != torch.float32 or f32_err > VLM_F32_TEACHER_ATOL:
        raise AssertionError(f"qwen2-vl float32 teacher-forced decode "
                             f"differs from the forward by {f32_err} (bound "
                             f"{VLM_F32_TEACHER_ATOL})")
    del f32_fwd
    if fa_kernel.launches != 2 * cfg.n_layers:
        raise AssertionError("qwen2-vl's decode or its plain prefill "
                             "launched flash_attention")

    # greedy decode from the first text token into a cache of S
    cache, _ = api.init_cache(B, S)
    tok = batch["tokens"][:, :1]
    generated = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pos in range(VLM_DECODE_STEPS):
        lg, cache = api.decode_step(lm, cache, tok, pos)
        tok = lg.argmax(dim=-1).to(torch.int32)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_seconds = time.perf_counter() - t0
    gen = torch.cat(generated, dim=1)
    if gen.shape != (B, VLM_DECODE_STEPS) or int(gen.min()) < 0 \
            or int(gen.max()) >= cfg.vocab_size:
        raise AssertionError(f"greedy decode: tokens {tuple(gen.shape)}")
    del cache
    profile = _device_profile(lambda: api.forward(lm, batch, flash=True))
    return {"phase": "serve_vlm_audio", "arch": VLM_ARCH,
            "family": cfg.family, "n_layers": cfg.n_layers,
            "depth_cut": None, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size, "mrope_sections": cfg.mrope_sections,
            "param_dtype": cfg.param_dtype,
            "compute_dtype": cfg.compute_dtype, "params": cfg.param_count(),
            "param_gb": param_bytes / 1e9, "batch": B, "prompt": S,
            "patches": P, "text_tokens": S - P,
            "prefill_launches": launches,
            "launch_max_abs_err": checked.errs,
            "launch_tolerance": [FLASH_BF16_RTOL, FLASH_BF16_ATOL],
            "checked_prefill_seconds": checked_seconds,
            "prefill_seconds": prefill_seconds,
            "prefill_tokens_per_s": B * S / prefill_seconds,
            "plain_prefill_seconds": plain_seconds,
            "flash_vs_plain_max_abs_err": flash_err,
            "flash_vs_plain_argmax_agree": agree,
            "flash_atol": VLM_FLASH_ATOL, "logit_absmax": logit_absmax,
            "teacher_tokens": n, "teacher_prompt": "zero patches, equal "
                                                   "M-RoPE streams",
            "teacher_max_abs_err": teacher_err,
            "teacher_argmax_agree": teacher_agree,
            "teacher_atol": VLM_TEACHER_ATOL,
            "teacher_f32_max_abs_err": f32_err,
            "teacher_f32_argmax_agree": f32_agree,
            "teacher_f32_atol": VLM_F32_TEACHER_ATOL,
            "decode_steps": VLM_DECODE_STEPS,
            "decode_seconds": decode_seconds,
            "decode_ms_per_step": 1e3 * decode_seconds / VLM_DECODE_STEPS,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "profile": profile}


def _serve_audio(cfg, api, lm) -> dict:
    """hubert-xlarge: a prefill of 2 x 4096 frames asking for flash, which
    launches nothing (not causal), its bf16 logits against the float32-
    compute forward; no decode step or cache; a profiler split."""
    dev = torch.device("cuda")
    B, S = VA_BATCH, VA_PROMPT
    batch = make_batch(cfg, B, S,
                       torch.Generator(device=dev).manual_seed(VA_SEED + 2))
    param_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    if api.decode_step is not None or api.init_cache is not None:
        raise AssertionError("hubert-xlarge exposes a decode step or cache")
    mm_kernel.launches = cv_kernel.launches = fa_kernel.launches = 0
    t0 = time.perf_counter()
    logits = api.forward(lm, batch, flash=True)
    torch.cuda.synchronize()
    first_seconds = time.perf_counter() - t0
    launches = _launch_counts()
    if any(launches.values()):
        raise AssertionError(f"hubert's prefill launched {launches}: it is "
                             f"not causal, so it takes no flash branch")
    if logits.shape != (B, S, cfg.vocab_size) \
            or logits.dtype != torch.bfloat16 \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"hubert logits {tuple(logits.shape)} "
                             f"{logits.dtype}, or not finite")
    del logits
    t0 = time.perf_counter()
    logits = api.forward(lm, batch, flash=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    f32 = build_model(dataclasses.replace(
        cfg, compute_dtype="float32")).forward(lm, batch)
    err, agree = _logits_err(logits, f32), _argmax_share(logits, f32)
    logit_absmax = float(f32.abs().max())
    del logits, f32
    if err > AUDIO_BF16_ATOL or agree < SERVE_ARGMAX_FLOOR:
        raise AssertionError(f"hubert's bf16 forward differs from its "
                             f"float32 forward by {err} (bound "
                             f"{AUDIO_BF16_ATOL}), argmax agreement {agree} "
                             f"(floor {SERVE_ARGMAX_FLOOR})")

    def group_of(names):
        if any(n in _CASTS for n in names):
            return "casts"
        if "split::attention" in names:
            return "attention"
        return ("gemm" if any(n in ("aten::mm", "aten::matmul")
                              for n in names) else "other")

    split = _split_by_op(lambda: api.forward(lm, batch, flash=True),
                         {"attention": (layers_mod, "_sdpa")},
                         ("attention", "gemm", "casts", "other"), group_of)
    launches = _launch_counts()
    if any(launches.values()):
        raise AssertionError(f"hubert launched {launches}")
    return {"phase": "serve_vlm_audio", "arch": AUDIO_ARCH,
            "family": cfg.family, "n_layers": cfg.n_layers,
            "depth_cut": None, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "head_dim": cfg.resolved_head_dim,
            "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
            "causal": cfg.causal, "param_dtype": cfg.param_dtype,
            "compute_dtype": cfg.compute_dtype, "params": cfg.param_count(),
            "param_gb": param_bytes / 1e9, "batch": B, "frames": S,
            "launches": launches, "first_forward_seconds": first_seconds,
            "forward_seconds": seconds,
            "frames_per_s": B * S / seconds,
            "bf16_vs_f32_max_abs_err": err, "bf16_vs_f32_argmax_agree": agree,
            "atol": AUDIO_BF16_ATOL, "logit_absmax": logit_absmax,
            "decode_step": None, "init_cache": None,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "prefill_split": split}


def _va_train_steps(cfg, api, lm) -> dict:
    """``VA_TRAIN_STEPS`` steps of ``build_train_step`` on the one-card
    mesh at 2 x ``VA_TRAIN_SEQ``, a new batch each step: losses and grad
    norms finite, the checksum chain within ``CHAIN_RTOL``, no kernel."""
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tcfg = TrainConfig(optimizer="adamw", remat="dots", seed=VA_SEED)
    step, info, opt_init = build_train_step(api, tcfg, single_device_mesh())
    opt = opt_init(lm)
    recs, metrics, seconds = [], [], []
    before = _launch_counts()
    for t in range(VA_TRAIN_STEPS):
        batch = make_batch(cfg, VA_BATCH, VA_TRAIN_SEQ, torch.Generator(
            device=dev).manual_seed(VA_SEED + 10 + t))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm, opt, _, m, c = step(lm, opt, {}, batch, None)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(list(m.values()))):
            raise AssertionError(f"{cfg.name} train step {t}: {m}")
        metrics.append(m)
        recs.append(LedgerRecord(
            step=t, rng_seed=VA_SEED, cursor=[],
            cks_params=flatten_checksums(c["params"]),
            cks_opt=flatten_checksums(c["opt"]),
            cks_updates=flatten_checksums(c["updates"]), loss=m["loss"]))
    ratios = _chain_ratios(recs)
    if len(ratios) != VA_TRAIN_STEPS - 1 or max(ratios) >= 1.0:
        raise AssertionError(f"{cfg.name}: checksum chain ratios {ratios}")
    if _launch_counts() != before:
        raise AssertionError(f"{cfg.name}: the train steps launched a "
                             f"kernel; training runs plain attention")
    del opt
    return {"batch": VA_BATCH, "seq": VA_TRAIN_SEQ,
            "optimizer": tcfg.optimizer, "remat": tcfg.remat,
            "mesh": dict(info["mesh"].shape), "deterministic": True,
            "losses": [m["loss"] for m in metrics],
            "grad_norms": [m["grad_norm"] for m in metrics],
            "step_seconds": seconds, "chain_ratios": ratios,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def _slot_bytes(cfg) -> int:
    """Bytes of one AdamW slot: parameters, m and v in float32."""
    return 3 * 4 * cfg.param_count() + 4


def _train_cfg(arch: str, free_bytes: int, layers):
    """``arch`` at full width, depth cut to the largest of ``layers``
    whose two slots fit the free disk with a tenth to spare (full depth
    where ``layers`` is None)."""
    full = get_config(arch)
    for n in layers or (full.n_layers,):
        cfg = dataclasses.replace(full, n_layers=n)
        if 2.2 * _slot_bytes(cfg) <= free_bytes:
            return cfg
    raise AssertionError(f"{free_bytes / 1e9:.1f} GB free for the slots: "
                         f"not enough for two of {arch} at {n} layers")


def _chain_ratios(records) -> list:
    """|cur - (prev + upd)| / (CHAIN_RTOL * max(|cur|, 1)) for every record
    after the first, against the latest record before it in the file that
    holds the step before (a resumed run appends its replayed steps after
    the steps it abandoned), over all leaves: 1 is the chain's bound."""
    out, last = [], {}
    for rec in records:
        prev = last.get(rec.step - 1)
        if prev is not None:
            cur = np.asarray(rec.cks_params, np.float64)
            err = np.abs(cur - (np.asarray(prev.cks_params, np.float64)
                                + np.asarray(rec.cks_updates, np.float64)))
            scale = ChecksumLedger.CHAIN_RTOL * np.maximum(np.abs(cur), 1.0)
            out.append(float(np.max(err / scale)))
        last[rec.step] = rec
    return out


def _median(xs) -> float:
    return float(statistics.median(xs)) if xs else float("nan")


def _run_trainer(cfg, tcfg, workdir, mode, steps, seq, crash_at=None,
                 **kw) -> tuple:
    """(trainer, result, peak device bytes) of one ``run(steps)``."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = ADCCTrainer(cfg, tcfg, workdir, **{
        "batch": TRAIN_BATCH, "seq": seq, "slot_every": TRAIN_SLOT_EVERY,
        "n_slots": TRAIN_SLOTS, "mode": mode, **kw})
    res = tr.run(steps, crash_at_step=crash_at, log_every=0)
    torch.cuda.synchronize()
    if not all(np.isfinite(res.losses)):
        raise AssertionError(f"{mode}: non-finite losses {res.losses}")
    return tr, res, torch.cuda.max_memory_allocated()


def _mode_line(tr, res, peak, first_step: int) -> dict:
    """Step times split by slot steps (each trainer's first step left out:
    it includes set-up), and the trainer's own timings."""
    plain, slot = [], []
    for t, sec in zip(range(first_step, first_step + len(res.step_seconds)),
                      res.step_seconds):
        if t == first_step:
            continue
        (slot if (t + 1) % TRAIN_SLOT_EVERY == 0 else plain).append(sec)
    return {"steps": len(res.step_seconds), "step_seconds": res.step_seconds,
            "median_step_s": _median(plain + slot),
            "median_plain_step_s": _median(plain),
            "median_slot_step_s": _median(slot),
            "ledger_append_ms": [1e3 * x for x in tr.timings["ledger_append"]],
            "host_copy_s": tr.timings["host_copy"],
            "sync_slot_write_s": tr.timings["slot_write"],
            "async_writer_s_per_slot": (tr.writer.write_seconds
                                        if tr.writer is not None else []),
            "recover_read_s": tr.timings["recover_read"],
            "recover_verify_s": tr.timings["recover_verify"],
            "peak_memory_gb": peak / 1e9}


# ---------------------------------------------------------------------------
# examples
# ---------------------------------------------------------------------------

def _finite(xs) -> bool:
    return all(np.isfinite(x) for x in xs)


def phase_examples(records: list) -> None:
    """Each example twin's ``main`` on the card (its printing sent to
    stderr), its seconds and its launches per kernel wrapper; the counts
    are set to 0 just before each twin and read just after."""
    import contextlib
    import importlib
    runs = {}
    for name, args in EXAMPLE_RUNS:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        gc.collect()
        torch.cuda.empty_cache()
        mm_kernel.launches = cv_kernel.launches = fa_kernel.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            res = mod.main(list(args))
        torch.cuda.synchronize()
        runs[name] = {"args": args, "seconds": time.perf_counter() - t0,
                      "launches": _launch_counts(), "result": res}
    q = runs["quickstart"]["result"]
    if not (q["bitwise"] and q["sweep_ok"] and _finite(q["losses"])):
        raise AssertionError(f"quickstart: bitwise {q['bitwise']}, sweep "
                             f"{q['sweep_ok']}, finite "
                             f"{_finite(q['losses'])}")
    demo = runs["abft_matmul_demo"]
    d = demo["result"]
    if not (d["verified"] and d["tamper_flagged"] and d["corrected_exactly"]
            and d["tamper_at"] == (5, 7)):
        raise AssertionError(f"abft_matmul_demo: {d}")
    if not (demo["launches"]["abft_matmul"] and demo["launches"]["tile_sums"]):
        raise AssertionError(f"abft_matmul_demo launched {demo['launches']}")
    if not max(runs["cg_crash_recovery"]["result"]["max_error"]) < 1e-8:
        raise AssertionError(f"cg_crash_recovery: "
                             f"{runs['cg_crash_recovery']['result']}")
    if not runs["mc_xsbench"]["result"]["selective_bitwise"]:
        raise AssertionError("mc_xsbench: the selective restart's counts "
                             "differ from the no-crash run's")
    t = runs["train_e2e"]["result"]
    if not t["finite"]:
        raise AssertionError("train_e2e: a non-finite loss")
    for rec in records:
        if rec["name"] in ("abft_matmul", "tile_sums"):
            rec.setdefault("launches_by_path", {})[
                "examples abft_matmul_demo"] = demo["launches"][rec["name"]]
    # trim the per-step lists for the line
    q["losses"] = [q["losses"][0], q["losses"][-1]]
    t["losses"] = [t["losses"][0], t["losses"][-1]]
    total = sum(r["seconds"] for r in runs.values())
    emit({"phase": "examples", "seconds": total,
          "budget_seconds": EXAMPLES_BUDGET_S,
          "within_budget": total <= EXAMPLES_BUDGET_S, "runs": runs})


# ---------------------------------------------------------------------------
# mesh: serving across ranks
# ---------------------------------------------------------------------------

class _ThreadExchange:
    """``all_to_all_single`` among ``n`` threads of this process, each one
    rank of the EP body: rank r sends the i-th of n equal row blocks of its
    tensor to rank i and gets back the r-th block of every rank's, in rank
    order. Used here only, to run a 4-way layout's bodies on one card."""

    def __init__(self, n: int):
        import threading
        self.n = n
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=300)

    def for_rank(self, r: int):
        def exchange(t: torch.Tensor) -> torch.Tensor:
            self.slots[r] = t
            self.barrier.wait()
            out = torch.cat([s.chunk(self.n)[r] for s in self.slots])
            self.barrier.wait()
            return out
        return exchange


def _rank_experts(p, r: int):
    """The router and rank ``r``'s (E / MESH_EP, ...) expert stacks of
    ``p``: what ``moe.local_experts`` hands that rank's body."""
    from types import SimpleNamespace
    return SimpleNamespace(router=p.router, **{
        k: getattr(p, k).chunk(MESH_EP)[r]
        for k in ("w_gate", "w_up", "w_down")})


def _ep_bodies(p, cfg, x, capacity) -> tuple:
    """(the MESH_EP ranks' outputs concatenated, seconds): x (N, D) split
    over the ranks in order, each rank's body in its own thread."""
    from concurrent.futures import ThreadPoolExecutor
    ex = _ThreadExchange(MESH_EP)
    parts = x.chunk(MESH_EP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(MESH_EP) as pool:
        futs = [pool.submit(moe_mod.ep_body, cfg, _rank_experts(p, r), parts[r],
                            r, MESH_EP, capacity, ex.for_rank(r))
                for r in range(MESH_EP)]
        outs = [f.result() for f in futs]
    torch.cuda.synchronize()
    return torch.cat(outs), time.perf_counter() - t0


def _mesh_tp_attention() -> dict:
    """llama3-8b's attention at 2 x 4096, bf16, through the kernel on each
    rank's query heads and the KV heads they read for each rank of tp = 4,
    held to the plain version per launch and, concatenated over heads, to
    one whole launch bit for bit."""
    dev = torch.device("cuda")
    cfg = get_config(SERVE_ARCH)
    B, S = SERVE_BATCH, SERVE_PROMPT
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(MESH_SEED)
    q, k, v = (torch.randn((B, S, n, hd), generator=g, device=dev,
                           dtype=torch.bfloat16) for n in (H, KV, KV))
    H_loc = H // MESH_TP
    G = H // KV
    n_kv = max(1, -(-H_loc // G))
    # rank r's query heads and the KV heads they read, as attention_body
    # hands them to the kernel
    rank_qkv = [(q[:, :, r * H_loc:(r + 1) * H_loc],
                 k[:, :, r * H_loc // G:r * H_loc // G + n_kv],
                 v[:, :, r * H_loc // G:r * H_loc // G + n_kv])
                for r in range(MESH_TP)]
    fa_kernel.launches = 0
    parts = [fa_ops.flash_attention(*t) for t in rank_qkv]
    launches = fa_kernel.launches
    if launches != MESH_TP:
        raise AssertionError(f"the TP bodies launched B3 {launches} times")
    errs = []
    for r, out in enumerate(parts):
        want = fa_kernel.flash_attention_plain(*rank_qkv[r])
        errs.append(check_close(f"TP body rank {r}", out, want,
                                FLASH_BF16_RTOL, FLASH_BF16_ATOL))
        del want
    whole = fa_ops.flash_attention(q, k, v)
    if not torch.equal(torch.cat(parts, dim=2), whole):
        raise AssertionError("the TP bodies' heads differ from one whole "
                             "launch")
    layer = _mesh_tp_layer(cfg, B, S)
    decode = _mesh_tp_decode(cfg, B, MESH_DECODE_LEN)
    q0, k0, v0 = rank_qkv[0]
    qt, kt, vt = (t.transpose(1, 2) for t in (q0, k0, v0))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return {"shape": f"q ({B},{S},{H},{hd}) bf16, tp {MESH_TP}: "
                     f"{H_loc} query heads over {n_kv} KV heads a rank",
            "launches": launches, "max_abs_err_by_rank": errs,
            "bitwise_equal_whole": True,
            "rank_body_ms": time_ms(lambda: fa_ops.flash_attention(
                q0, k0, v0), 10),
            "whole_ms": time_ms(lambda: fa_ops.flash_attention(q, k, v), 10),
            "rank_plain_ms": time_ms(lambda: fa_kernel.flash_attention_plain(
                q0, k0, v0), 3),
            "rank_library_ms": time_ms(lambda: sdpa(
                qt, kt, vt, is_causal=True, enable_gqa=True), 10),
            **{f"rank_{k_}": v_ for k_, v_ in _flash_bound(
                B, S, H_loc, n_kv, hd, True).items()},
            "layer": layer, "decode": decode}


def _mesh_tp_layer(cfg, B: int, S: int) -> dict:
    """llama3-8b's attention layer (seeded float32 weights, bf16 input of
    B x S) through ``attention_body`` for each rank of tp = MESH_TP, in a
    thread each: the rank's columns of wq and rows of wo, wk / wv whole,
    of which each rank projects the KV heads its query heads read. Their
    outputs summed in float32 stand for the mesh's sum over "model"; held
    to one card's layer within MESH_LAYER_RTOL of its largest value,
    every B3 launch to its plain version. The KV heads of each launch,
    the rank body's ms beside MESH_LAYER_PARENT_MS, and its kernels' time
    on the card (``_device_profile`` of 10 calls, per call)."""
    from concurrent.futures import ThreadPoolExecutor
    from types import SimpleNamespace
    dev = torch.device("cuda")
    p = layers_mod.Attention(cfg, device=dev)
    p.init_(torch.Generator(device=dev).manual_seed(MESH_SEED + 2))
    x = torch.randn((B, S, cfg.d_model), device=dev, dtype=torch.bfloat16,
                    generator=torch.Generator(device=dev)
                    .manual_seed(MESH_SEED + 3))
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    ranks = [SimpleNamespace(wq=p.wq.chunk(MESH_TP, 1)[r], wk=p.wk, wv=p.wv,
                             wo=p.wo.chunk(MESH_TP, 0)[r])
             for r in range(MESH_TP)]

    def body(r):
        return layers_mod.attention_body(cfg, ranks[r], x, positions,
                                         rank=r, tp=MESH_TP, flash=True)[0]

    with torch.no_grad():
        fa_kernel.launches = 0
        whole, _ = layers_mod.attention_apply(cfg, p, x, positions,
                                              flash=True)
        whole_launches = fa_kernel.launches
        fa_kernel.launches = 0
        with _FlashChecked() as checked:
            with ThreadPoolExecutor(MESH_TP) as pool:
                outs = list(pool.map(body, range(MESH_TP)))
        torch.cuda.synchronize()
        launches = fa_kernel.launches
        summed = sum(o.float() for o in outs).to(whole.dtype)
        scale = float(whole.float().abs().max())
        err = check_close("TP attention layer vs one card's", summed, whole,
                          0.0, MESH_LAYER_RTOL * scale)
        rank_ms = time_ms(lambda: body(0), 10)
        rank_prof = _device_profile(lambda: [body(0) for _ in range(10)])
        whole_ms = time_ms(lambda: layers_mod.attention_apply(
            cfg, p, x, positions, flash=True), 10)
    if whole_launches != 1 or launches != MESH_TP:
        raise AssertionError(f"B3 launched {whole_launches} times for the "
                             f"whole layer, {launches} for its ranks")
    H, KV = cfg.n_heads, cfg.n_kv_heads
    n_kv = max(1, H // MESH_TP // (H // KV))
    if checked.kv_heads != [n_kv] * MESH_TP:
        raise AssertionError(f"the ranks' launches held {checked.kv_heads} "
                             f"KV heads, not the {n_kv} of {KV} that each "
                             f"rank's query heads read")
    nbytes = lambda ws: sum(w.numel() * w.element_size() for w in ws)
    return {"shape": f"x ({B},{S},{cfg.d_model}) bf16, weights f32, "
                     f"tp {MESH_TP}",
            "launches": launches, "max_abs_err_vs_one_card": err,
            "atol": MESH_LAYER_RTOL * scale,
            "b3_max_abs_err_by_launch": checked.errs,
            "rank_weight_bytes": [nbytes(vars(rp).values()) for rp in ranks],
            "whole_weight_bytes": nbytes(p.parameters()),
            "rank_kv_heads": checked.kv_heads, "whole_kv_heads": KV,
            "rank_body_ms": rank_ms,
            "parent_rank_body_ms": MESH_LAYER_PARENT_MS,
            "rank_body_device_ms": rank_prof["device_busy_s"] * 100,
            "rank_body_idle_share": rank_prof["device_idle_share"],
            "rank_body_top": rank_prof["top"],
            "whole_layer_ms": whole_ms}


class _Products(torch.overrides.TorchFunctionMode):
    """The widths of the products of ``x`` (``x @ w``) while the mode is
    on, in the thread that entered it."""

    def __init__(self, x):
        super().__init__()
        self.x, self.cols = x, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "__name__", "") == "matmul" and args[0] is self.x:
            self.cols.append(int(out.shape[-1]))
        return out


def _mesh_tp_decode(cfg, B: int, L: int) -> dict:
    """One decode step of llama3-8b's attention layer (seeded float32
    weights, a bf16 cache of B x L positions, the last one written by the
    step) through ``attention_body`` for each rank of tp = MESH_TP, in a
    thread each: the rank's columns of wq and rows of wo, wk / wv whole,
    and its own KV heads of the cache (a cache split by heads over
    "model"), of which the rank projects only those. Their outputs summed
    in float32 against one card's decode step on the whole cache, each
    rank's new cache entries against the whole cache's heads, both within
    MESH_LAYER_RTOL of the largest value; each rank's K/V projection
    columns, the rank body's ms and its kernels' time on the card
    (``_device_profile`` of 10 calls, per call)."""
    from concurrent.futures import ThreadPoolExecutor
    from types import SimpleNamespace
    dev = torch.device("cuda")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    kv_loc = KV // MESH_TP
    p = layers_mod.Attention(cfg, device=dev)
    p.init_(torch.Generator(device=dev).manual_seed(MESH_SEED + 6))
    g = torch.Generator(device=dev).manual_seed(MESH_SEED + 7)
    x = torch.randn((B, 1, cfg.d_model), device=dev, dtype=torch.bfloat16,
                    generator=g)
    whole = {k: torch.randn((B, L, KV, hd), device=dev, dtype=torch.bfloat16,
                            generator=g) for k in ("k", "v")}
    pos = L - 1
    positions = torch.full((B, 1), pos, device=dev, dtype=torch.int32)
    ranks = [SimpleNamespace(wq=p.wq.chunk(MESH_TP, 1)[r], wk=p.wk, wv=p.wv,
                             wo=p.wo.chunk(MESH_TP, 0)[r])
             for r in range(MESH_TP)]
    caches = [{k: c[:, :, r * kv_loc:(r + 1) * kv_loc].clone()
               for k, c in whole.items()} for r in range(MESH_TP)]

    def body(r):
        return layers_mod.attention_body(cfg, ranks[r], x, positions,
                                         rank=r, tp=MESH_TP, cache=caches[r],
                                         cache_index=pos)[0]

    def checked(r):
        with _Products(x) as products:
            out = body(r)
        return out, products.cols[1:]

    with torch.no_grad():
        want, _ = layers_mod.attention_apply(cfg, p, x, positions,
                                             cache=whole, cache_index=pos)
        with ThreadPoolExecutor(MESH_TP) as pool:
            outs, cols = zip(*pool.map(checked, range(MESH_TP)))
        torch.cuda.synchronize()
        summed = sum(o.float() for o in outs).to(want.dtype)
        scale = float(want.float().abs().max())
        err = check_close("TP attention decode vs one card's", summed, want,
                          0.0, MESH_LAYER_RTOL * scale)
        cache_err = {}
        for k in ("k", "v"):
            new = whole[k][:, pos]
            got = torch.cat([c[k][:, pos] for c in caches], dim=1)
            cache_err[k] = check_close(
                f"TP decode's new {k} entries vs one card's", got, new, 0.0,
                MESH_LAYER_RTOL * float(new.float().abs().max()))
        rank_ms = time_ms(lambda: body(0), 20)
        rank_prof = _device_profile(lambda: [body(0) for _ in range(10)])
        whole_ms = time_ms(lambda: layers_mod.attention_apply(
            cfg, p, x, positions, cache=whole, cache_index=pos), 20)
    if list(cols) != [[kv_loc * hd] * 2] * MESH_TP:
        raise AssertionError(f"the ranks' K/V projections had {list(cols)} "
                             f"columns, not the {kv_loc * hd} of their own "
                             f"{kv_loc} KV heads")
    return {"shape": f"x ({B},1,{cfg.d_model}) bf16, cache ({B},{L},{KV},"
                     f"{hd}) bf16, weights f32, tp {MESH_TP}: {kv_loc} of "
                     f"{KV} KV heads a rank",
            "max_abs_err_vs_one_card": err, "atol": MESH_LAYER_RTOL * scale,
            "new_cache_max_abs_err": cache_err,
            "rank_kv_columns": [c[0] for c in cols],
            "whole_kv_columns": KV * hd,
            "rank_decode_ms": rank_ms,
            "rank_decode_device_ms": rank_prof["device_busy_s"] * 100,
            "rank_decode_idle_share": rank_prof["device_idle_share"],
            "rank_decode_top": rank_prof["top"],
            "whole_decode_ms": whole_ms}


def _peak_gb(fn) -> tuple:
    """(``fn()``, the GB it allocated at its peak beyond what was live)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9


def _mesh_head_blocks_layer() -> dict:
    """phi4-mini-3.8b's attention layer (seeded float32 weights, bf16
    input of SERVE_BATCH x SERVE_PROMPT) through ``attention_body`` for
    each of the MESH_BLOCK_TP ranks, one after another: each rank its
    head block's columns of wq (its own and its block partners', as
    ``layers.gather_block`` gathers them), its own rows of wo, wk / wv
    whole; plain attention, as the reference's where the heads do not
    tile. Their outputs summed in float32 stand for the mesh's sum over
    "model"; held to one card's plain layer within MESH_LAYER_RTOL of its
    largest value. Each rank's scored heads (``layers._sdpa``'s q), score
    bytes (float32 logits) and peak memory beside the whole layer's."""
    from types import SimpleNamespace
    dev = torch.device("cuda")
    cfg = get_config(MESH_BLOCK_ARCH)
    B, S, tp = SERVE_BATCH, SERVE_PROMPT, MESH_BLOCK_TP
    g, m = layers_mod.head_blocks(cfg.n_heads, tp)
    p = layers_mod.Attention(cfg, device=dev)
    p.init_(torch.Generator(device=dev).manual_seed(MESH_SEED + 4))
    x = torch.randn((B, S, cfg.d_model), device=dev, dtype=torch.bfloat16,
                    generator=torch.Generator(device=dev)
                    .manual_seed(MESH_SEED + 5))
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    cols, rows = p.wq.chunk(tp, 1), p.wo.chunk(tp, 0)
    ranks = [SimpleNamespace(wq=torch.cat(cols[r // m * m:(r // m + 1) * m],
                                          1), wk=p.wk, wv=p.wv, wo=rows[r])
             for r in range(tp)]
    seen = []
    sdpa = layers_mod._sdpa

    def spy(q, *a, **k):
        seen.append(int(q.shape[2]))
        return sdpa(q, *a, **k)

    def body(r):
        return layers_mod.attention_body(cfg, ranks[r], x, positions,
                                         rank=r, tp=tp)[0]

    layers_mod._sdpa = spy
    try:
        with torch.no_grad():
            whole, whole_gb = _peak_gb(lambda: layers_mod.attention_apply(
                cfg, p, x, positions)[0])
            whole_heads = seen.pop()
            summed = torch.zeros(whole.shape, device=dev)
            rank_gb = []
            for r in range(tp):
                out, gb = _peak_gb(lambda: body(r))
                summed += out.float()
                rank_gb.append(gb)
                del out
            rank_heads = seen[:]
            scale = float(whole.float().abs().max())
            err = check_close("head-block attention layer vs one card's",
                              summed.to(whole.dtype), whole, 0.0,
                              MESH_LAYER_RTOL * scale)
            rank_ms = time_ms(lambda: body(0), 10)
            whole_ms = time_ms(lambda: layers_mod.attention_apply(
                cfg, p, x, positions), 10)
    finally:
        layers_mod._sdpa = sdpa
    if rank_heads != [cfg.n_heads // g] * tp:
        raise AssertionError(f"the ranks scored {rank_heads} heads, not "
                             f"{cfg.n_heads // g} each")
    score = lambda h: B * h * S * S * 4        # noqa: E731  float32 logits
    nbytes = lambda ws: sum(w.numel() * w.element_size() for w in ws)
    return {"shape": f"x ({B},{S},{cfg.d_model}) bf16, weights f32, "
                     f"{cfg.n_heads} / {cfg.n_kv_heads} heads, tp {tp}: "
                     f"{g} blocks of {cfg.n_heads // g} heads, {m} ranks a "
                     f"block",
            "max_abs_err_vs_one_card": err, "atol": MESH_LAYER_RTOL * scale,
            "rank_scored_heads": rank_heads, "whole_scored_heads": whole_heads,
            "rank_score_bytes": score(rank_heads[0]),
            "whole_score_bytes": score(whole_heads),
            "rank_peak_gb": rank_gb, "whole_peak_gb": whole_gb,
            "rank_weight_bytes": nbytes(vars(ranks[0]).values()),
            "whole_weight_bytes": nbytes(p.parameters()),
            "rank_body_ms": rank_ms, "whole_layer_ms": whole_ms}


def _mesh_ssd_heads_layer() -> dict:
    """zamba2-1.2b's Mamba2 layer (seeded float32 weights, bf16 input of
    SERVE_BATCH x SERVE_PROMPT) through ``mamba2_body`` for each of the
    MESH_SSD_TP ranks, one after another: each rank its own rows of
    out_proj, every other weight whole, the SSD run for the heads those
    rows read (``mamba2.ssd_heads``). Their outputs summed in float32
    stand for the mesh's sum over "model"; held to one card's layer
    within MESH_LAYER_RTOL of its largest value. Each rank's SSD heads
    (``_ssd_intra``'s), body ms and peak memory beside the whole
    layer's."""
    from types import SimpleNamespace
    dev = torch.device("cuda")
    cfg = get_config(MESH_SSD_ARCH)
    B, S, tp = SERVE_BATCH, SERVE_PROMPT, MESH_SSD_TP
    p = mamba2_mod.Mamba2(cfg, device=dev)
    p.init_(torch.Generator(device=dev).manual_seed(MESH_SEED + 6))
    x = torch.randn((B, S, cfg.d_model), device=dev, dtype=torch.bfloat16,
                    generator=torch.Generator(device=dev)
                    .manual_seed(MESH_SEED + 7))
    whole_w = {k: getattr(p, k) for k in mamba2_mod.Mamba2.AXES}
    ranks = [SimpleNamespace(**{**whole_w, "out_proj": rows})
             for rows in p.out_proj.chunk(tp, 0)]
    seen = []
    intra = mamba2_mod._ssd_intra

    def spy(la, *a):
        seen.append(int(la.shape[-1]))
        return intra(la, *a)

    def body(r):
        return mamba2_mod.mamba2_body(cfg, ranks[r], x, rank=r, tp=tp)

    mamba2_mod._ssd_intra = spy
    try:
        with torch.no_grad():
            whole, whole_gb = _peak_gb(lambda: mamba2_mod.mamba2_apply(
                cfg, p, x))
            whole_heads = seen.pop()
            summed = torch.zeros(whole.shape, device=dev)
            rank_gb = []
            for r in range(tp):
                out, gb = _peak_gb(lambda: body(r))
                summed += out.float()
                rank_gb.append(gb)
                del out
            rank_heads = seen[:]
            scale = float(whole.float().abs().max())
            err = check_close("SSD-head Mamba2 layer vs one card's",
                              summed.to(whole.dtype), whole, 0.0,
                              MESH_LAYER_RTOL * scale)
            rank_ms = time_ms(lambda: body(0), 10)
            whole_ms = time_ms(lambda: mamba2_mod.mamba2_apply(cfg, p, x), 10)
    finally:
        mamba2_mod._ssd_intra = intra
    d_inner, H, _ = mamba2_mod.mamba2_dims(cfg)
    want = [mamba2_mod.ssd_heads(d_inner, cfg.ssm_head_dim, tp, r)[1]
            for r in range(tp)]
    if rank_heads != want or set(want) != {-(-H // tp)}:
        raise AssertionError(f"the ranks ran {rank_heads} SSD heads, not "
                             f"{-(-H // tp)} each")
    return {"shape": f"x ({B},{S},{cfg.d_model}) bf16, weights f32, "
                     f"{H} SSM heads of {cfg.ssm_head_dim}, tp {tp}",
            "max_abs_err_vs_one_card": err, "atol": MESH_LAYER_RTOL * scale,
            "rank_ssd_heads": rank_heads, "whole_ssd_heads": whole_heads,
            "rank_peak_gb": rank_gb, "whole_peak_gb": whole_gb,
            "rank_body_ms": rank_ms, "whole_layer_ms": whole_ms}


def _mesh_ep_layer() -> dict:
    """One deepseek-v2-lite-16b MoE layer at full width, float32, 2 x 1024
    tokens, through the EP bodies of 4 ranks."""
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(MOE_ARCH), compute_dtype="float32")
    p = moe_mod.MoE(cfg, device=dev)
    p.init_(torch.Generator(device=dev).manual_seed(MESH_SEED))
    N = MOE_BATCH * MOE_PROMPT
    x = torch.randn((N, cfg.d_model), device=dev, dtype=torch.float32,
                    generator=torch.Generator(device=dev)
                    .manual_seed(MESH_SEED + 1))
    t_loc = N // MESH_EP
    dense = moe_mod.moe_apply_dense(cfg, p, x)
    moe_mod.EP_COUNTS.update(assignments=0, dropped=0)
    generous, _ = _ep_bodies(p, cfg, x, t_loc * cfg.experts_per_token)
    if moe_mod.EP_COUNTS["dropped"]:
        raise AssertionError(f"{moe_mod.EP_COUNTS['dropped']} assignments "
                             f"dropped at a capacity of every assignment")
    err = check_close("EP bodies vs moe_apply_dense", generous, dense, 0.0,
                      MESH_EP_ATOL)
    cap = moe_mod.ep_capacity(cfg, t_loc, MESH_EP)
    moe_mod.EP_COUNTS.update(assignments=0, dropped=0)
    _, seconds = _ep_bodies(p, cfg, x, cap)
    counts = dict(moe_mod.EP_COUNTS)
    one = moe_mod.ep_body(cfg, p, x, 0, 1, moe_mod.ep_capacity(cfg, N, 1),
                          lambda t: t)
    del one
    return {"shape": f"x ({N},{cfg.d_model}) f32, {cfg.n_experts} experts, "
                     f"{cfg.n_experts // MESH_EP} a rank, K "
                     f"{cfg.experts_per_token}, ep {MESH_EP}",
            "rank_expert_stacks": tuple(_rank_experts(p, 0).w_gate.shape),
            "max_abs_err_vs_dense": err, "atol": MESH_EP_ATOL,
            "capacity": cap, "capacity_factor": cfg.capacity_factor,
            "assignments": counts["assignments"],
            "dropped": counts["dropped"],
            "drop_share": counts["dropped"] / counts["assignments"],
            "ep_4_bodies_s": seconds,
            "ep_one_card_ms": time_ms(lambda: moe_mod.ep_body(
                cfg, p, x, 0, 1, moe_mod.ep_capacity(cfg, N, 1),
                lambda t: t), 3),
            "dense_ms": time_ms(lambda: moe_mod.moe_apply_dense(cfg, p, x),
                                3)}


def _ranked_equals_one_card(arch: str, B: int, S: int, seed: int, mesh,
                            flash_launches: int) -> dict:
    """``arch`` at full width and depth, seeded weights on the card: the
    forward through ``mesh`` (a DeviceMesh of one rank; its logits a
    DTensor placed as the reference places them, read whole) against the
    one-card forward (the one-card mesh, whose moe layers take the same
    expert-parallel path) bit for bit."""
    dev = torch.device("cuda")
    cfg = get_config(arch)
    api = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    lm = api.init(torch.Generator(device=dev).manual_seed(seed))
    batch = make_batch(cfg, B, S,
                       torch.Generator(device=dev).manual_seed(seed + 1))
    one = api.forward(lm, batch, single_device_mesh(), flash=True)
    del one
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = api.forward(lm, batch, single_device_mesh(), flash=True)
    torch.cuda.synchronize()
    one_seconds = time.perf_counter() - t0
    mm_kernel.launches = cv_kernel.launches = fa_kernel.launches = 0
    moe_mod.EP_COUNTS.update(assignments=0, dropped=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranked = api.forward(lm, batch, mesh, flash=True)
    torch.cuda.synchronize()
    first_seconds = time.perf_counter() - t0
    launches = _launch_counts()
    ep = dict(moe_mod.EP_COUNTS)
    # the steady time: the first call also sets up the group's first
    # collectives
    del ranked
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranked = api.forward(lm, batch, mesh, flash=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if launches != {"abft_matmul": 0, "tile_sums": 0,
                    "flash_attention": flash_launches}:
        raise AssertionError(f"{arch} through the mesh launched {launches}")
    ranked = ranked.full_tensor()
    if not torch.equal(ranked, one):
        raise AssertionError(f"{arch}: the forward through a one-rank mesh "
                             f"differs from the one-card forward by "
                             f"{_logits_err(ranked, one)}")
    del one, ranked
    profile = _device_profile(lambda: api.forward(lm, batch, mesh,
                                                  flash=True))
    del lm, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "batch": B, "prompt": S, "bitwise_equal": True,
            "launches": launches, "ep_counts": ep,
            "first_forward_seconds": first_seconds,
            "forward_seconds": seconds, "one_card_seconds": one_seconds,
            "profile": profile}


def phase_mesh(records: list) -> None:
    """(a) a 4-way layout's per-rank bodies on the one card; (b) the
    distributed path at world size 1 through NCCL."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    tp = _mesh_tp_attention()
    gc.collect()
    torch.cuda.empty_cache()
    blocks = _mesh_head_blocks_layer()
    gc.collect()
    torch.cuda.empty_cache()
    ssd = _mesh_ssd_heads_layer()
    gc.collect()
    torch.cuda.empty_cache()
    ep = _mesh_ep_layer()
    gc.collect()
    torch.cuda.empty_cache()
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
        rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        moe_run = _ranked_equals_one_card(MOE_ARCH, MOE_BATCH, MOE_PROMPT,
                                          MOE_SEED, mesh, 0)
        dense_run = _ranked_equals_one_card(
            SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_SEED, mesh,
            get_config(SERVE_ARCH).n_layers)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    for rec in records:
        if rec["name"] == "flash_attention":
            rec.setdefault("launches_by_path", {}).update({
                "mesh tp bodies": tp["launches"],
                "mesh llama3-8b prefill": dense_run["launches"][
                    "flash_attention"]})
    emit({"phase": "mesh", "tp_attention": tp, "head_blocks": blocks,
          "ssd_heads": ssd, "ep_layer": ep,
          "world_1": [moe_run, dense_run]})


def _ledger_rows(tr) -> list:
    """(step, loss, parameter / optimizer / update checksums) of every
    record of ``tr``'s ledger."""
    return [(r.step, r.loss, r.cks_params, r.cks_opt, r.cks_updates)
            for r in tr.ledger.read_all()]


def _step_line(res, peak) -> dict:
    return {"first_step_s": res.step_seconds[0],
            "median_step_s": _median(res.step_seconds[1:]),
            "step_seconds": res.step_seconds, "peak_memory_gb": peak / 1e9}


def _mesh_train_arch(root: str, arch: str, layers, seq: int, restart: bool,
                     mesh) -> dict:
    """The one-card trainer and the trainer through ``mesh`` (one NCCL
    rank), bit for bit: every ledger record and the final parameters;
    with ``restart`` the run through the mesh writes two slots, the newer
    is torn (a crash in its write), and a restart through the mesh must
    reject it, recover the older and replay to the same parameters."""
    cfg = _train_cfg(arch, shutil.disk_usage(root).free, layers)
    tcfg = TrainConfig(optimizer="adamw", remat="dots", seed=TRAIN_SEED)
    steps = MESH_TRAIN_STEPS[restart]
    no_slot = steps + 1
    mm_kernel.launches = cv_kernel.launches = fa_kernel.launches = 0
    one, res, peak = _run_trainer(cfg, tcfg, os.path.join(root, "one"),
                                  "adcc", steps, seq, slot_every=no_slot)
    want = _ledger_rows(one)
    final = {n: p.detach().clone()
             for n, p in one._final_params.named_parameters()}
    line = {"arch": arch, "n_layers": cfg.n_layers, "batch": TRAIN_BATCH,
            "seq": seq, "steps": steps, "one_card": _step_line(res, peak)}
    del one
    wd = os.path.join(root, "mesh")
    tr, res, peak = _run_trainer(
        cfg, tcfg, wd, "adcc", steps, seq, mesh=mesh,
        slot_every=TRAIN_SLOT_EVERY if restart else no_slot)
    line["mesh"] = {**_step_line(res, peak),
                    "host_copy_s": tr.timings["host_copy"]}
    if tr.info["mesh"] is not mesh or not tr.ranked:
        raise AssertionError(f"{arch}: the trainer's step has mesh "
                             f"{tr.info['mesh']}")
    got = _ledger_rows(tr)
    if got != want:
        raise AssertionError(f"{arch}: the ledger through the mesh differs "
                             f"from the one-card trainer's: {got} vs {want}")
    if restart:
        slots = tr.store.slots_by_recency()
        if [s for _, s in slots] != [steps - 1, 1]:
            raise AssertionError(f"{arch}: slots {slots}")
        d = tr.store.slot_dir(slots[0][0])
        leaf = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
        np.save(os.path.join(d, leaf),
                np.load(os.path.join(d, leaf)) + 1000.0)
        del tr
        tr, res, peak = _run_trainer(cfg, tcfg, wd, "none", steps, seq,
                                     mesh=mesh)
        checks = tr.recovery_checks
        if res.resumed_from != 1 or [c[1] for c in checks] != [steps - 1, 1] \
                or checks[0][2] == 0 or checks[1][2] != 0:
            raise AssertionError(f"{arch}: recovery through the mesh: "
                                 f"resumed_from {res.resumed_from}, checks "
                                 f"{checks}")
        if res.losses != [r[1] for r in want[2:]]:
            raise AssertionError(f"{arch}: replayed losses {res.losses}")
        line.update({"restart": _step_line(res, peak),
                     "recovery_checks": [list(c) for c in checks],
                     "recover_read_s": tr.timings["recover_read"],
                     "recover_verify_s": tr.timings["recover_verify"]})
    diff = [n for n, p in tr._final_params.named_parameters()
            if not torch.equal(p.to_local(), final[n])]
    if diff:
        raise AssertionError(f"{arch}: final parameters through the mesh "
                             f"differ from the one card's in {diff}")
    launches = _launch_counts()
    if any(launches.values()):
        raise AssertionError(f"{arch}: training launched {launches}")
    line.update({"ledger_records_bitwise_equal": len(want),
                 "final_params_bitwise_equal": True, "launches": launches})
    return line


def phase_mesh_train() -> None:
    """Training across ranks at world size 1 through NCCL, held bit for bit
    to the one-card trainer."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_train_")
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
        rank=0, world_size=1)
    runs = []
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        for arch, layers, seq, restart in MESH_TRAIN_RUNS:
            root = tempfile.mkdtemp(prefix="chip_smoke_mesh_train_")
            try:
                runs.append(_mesh_train_arch(root, arch, layers, seq,
                                             restart, mesh))
            finally:
                shutil.rmtree(root, ignore_errors=True)
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    emit({"phase": "mesh_train", "runs": runs})


def _dryrun_sweep(out_dir: str) -> dict:
    """``python -m repro_torch.launch.dryrun --all --mesh both`` in
    DRYRUN_WORKERS spawned workers with no card visible, its output in a
    log; every record checked: each run cell OK, each skip the
    reference's reason."""
    from repro_torch.launch.dryrun import MESH_NAMES
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    log = os.path.join(out_dir, "dryrun.log")
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--mesh", "both", "--workers", str(DRYRUN_WORKERS), "--out",
             out_dir], env=env, stdout=fh, stderr=subprocess.STDOUT,
            text=True)
        try:
            rc = proc.wait(timeout=DRYRUN_BUDGET_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "killed at the phase's budget"
    seconds = time.perf_counter() - t0
    with open(log) as fh:
        text = fh.read()
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("OK ", "SKIP ", "FAIL ", "done;", "# "))]
    if rc != 0 or not lines or lines[-1] != "done; failures=0":
        raise AssertionError(f"dry run: {rc} after {seconds:.1f} s:\n"
                             + "\n".join(lines[-40:]) + text[-2000:])
    n_ok = sum(ln.startswith("OK ") for ln in lines)
    n_skip = sum(ln.startswith("SKIP ") for ln in lines)
    if (n_ok, n_skip) != (DRYRUN_CELLS, len(DRYRUN_SKIPS) * 2):
        raise AssertionError(f"dry run: {n_ok} OK and {n_skip} SKIP lines")
    cells = []
    for arch in list_archs():
        for shape in SHAPES:
            for multi in (False, True):
                path = os.path.join(
                    out_dir, f"{arch}__{shape}__{MESH_NAMES[multi]}.json")
                with open(path) as fh:
                    rec = json.load(fh)
                want = DRYRUN_SKIPS.get((arch, shape), "ok")
                if rec["status"] != want:
                    raise AssertionError(f"{arch} {shape} multi={multi}: "
                                         f"{rec['status']!r}, not {want!r}")
                if want != "ok":
                    continue
                ma = rec["memory_analysis"]
                gb = (ma["argument_size_in_bytes"]
                      + ma["temp_size_in_bytes"]) / 1e9
                cells.append({"arch": arch, "shape": shape,
                              "mesh": "multi" if multi else "single",
                              "args_gb": ma["argument_size_in_bytes"] / 1e9,
                              "temp_gb": ma["temp_size_in_bytes"] / 1e9,
                              "gb": gb, "of_gb": 80,
                              "fits": rec["fits_h100_80gb"],
                              "flops": rec["cost_analysis"]["flops"],
                              "coll_bytes": rec["collectives"]["total_bytes"],
                              "trace_s": rec["trace_seconds"]})
    for c in cells:
        emit({"phase": "dryrun_cell", **c})
    return {"ok": n_ok, "skip": n_skip, "seconds": seconds,
            "fit": sum(c["fits"] for c in cells)}


def _dryrun_ground() -> dict:
    """The dry run of one program against the program on the card:
    llama3-8b's plain prefill of 2 x 4096 on a one-rank mesh. Predicted on
    a fake group of one rank (meta tensors), then run through NCCL on the
    card: the argument bytes must equal what the placed weights and batch
    allocate, exactly; the predicted peak over the measured one must lie
    within GROUND_PEAK_RATIO; the predicted FLOPs over the measured
    seconds give the achieved rate."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    cfg = get_config(GROUND_ARCH)
    shape = ShapeConfig("prefill_2x4096", GROUND_SEQ, GROUND_BATCH,
                        "prefill")
    with dryrun.fake_group(1):
        pred = dryrun.measure(dryrun.build_cell(
            cfg, shape, make_mesh((1, 1), ("data", "model"))))
    p_args = pred["memory_analysis"]["argument_size_in_bytes"]
    p_peak = p_args + pred["memory_analysis"]["temp_size_in_bytes"]
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
        rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        api = build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(GROUND_SEED)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        cell = dryrun.build_cell(
            cfg, shape, mesh, init=lambda: api.init(gen),
            specs=lambda t: torch.randint(0, cfg.vocab_size, tuple(t.shape),
                                          dtype=t.dtype, device="cuda",
                                          generator=gen))
        torch.cuda.synchronize()
        args = torch.cuda.memory_allocated() - base
        cell.program()                  # first run: cuBLAS's set-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = cell.program()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        finite = bool(torch.isfinite(out.to_local()).all())
        del out, cell
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    ground = {"arch": GROUND_ARCH, "batch": GROUND_BATCH, "seq": GROUND_SEQ,
              "args_predicted": p_args, "args_allocated": args,
              "peak_predicted": p_peak, "peak_measured": peak,
              "peak_ratio": p_peak / peak, "seconds": seconds,
              "flops_predicted": pred["cost_analysis"]["flops"],
              "tflops_achieved": pred["cost_analysis"]["flops"]
              / seconds / 1e12, "tflops_peak_bf16": H100_BF16_TFLOPS,
              "collectives_predicted": pred["collectives"]["counts"]}
    if args != p_args:
        raise AssertionError(f"predicted {p_args} argument bytes; the placed "
                             f"weights and batch allocate {args}")
    lo, hi = GROUND_PEAK_RATIO
    if not lo <= ground["peak_ratio"] <= hi:
        raise AssertionError(f"predicted peak {p_peak} over measured {peak} "
                             f"= {ground['peak_ratio']:.3f}, outside "
                             f"[{lo}, {hi}]: the live-bytes tracker is off")
    if not finite:
        raise AssertionError("the grounding prefill's logits are not finite")
    return ground


def phase_dryrun() -> None:
    """The multi-pod dry run's every cell, and one of its programs
    grounded on the card."""
    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    try:
        sweep_line = _dryrun_sweep(out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    ground = _dryrun_ground()
    seconds = time.perf_counter() - t0
    emit({"phase": "dryrun", "sweep": sweep_line, "ground": ground,
          "seconds": seconds, "budget_s": DRYRUN_BUDGET_S})
    if seconds > DRYRUN_BUDGET_S:
        raise AssertionError(f"the dryrun phase took {seconds:.1f} s, over "
                             f"its budget of {DRYRUN_BUDGET_S} s")


def phase_train() -> None:
    """The ADCC trainer through its entry point at llama3-8b's full width:
    uninterrupted, crashed-and-recovered from a torn slot, and the
    synchronous-checkpoint baseline, held bitwise against each other; then
    deepseek-v2-lite-16b at full width, mamba2-130m and zamba2-1.2b at
    full width and depth, each uninterrupted and crashed-and-recovered."""
    for arch, layers, seq, baselines in TRAIN_RUNS:
        root = tempfile.mkdtemp(prefix="chip_smoke_train_")
        try:
            _train_arch(root, arch, layers, seq, baselines)
        finally:
            shutil.rmtree(root, ignore_errors=True)


def _train_arch(root: str, arch: str, layers, seq: int,
                baselines: bool) -> None:
    """The train runs of one arch; with ``baselines`` also the run without
    deterministic algorithms and the synchronous-checkpoint baseline."""
    free = shutil.disk_usage(root).free
    emit({"phase": "train_disk", "arch": arch, "dir_free_gb": free / 1e9})
    cfg = _train_cfg(arch, free, layers)
    tcfg = TrainConfig(optimizer="adamw", remat="dots", seed=TRAIN_SEED)
    n_params = cfg.param_count()
    mm_kernel.launches = cv_kernel.launches = fa_kernel.launches = 0
    moe_mod.EP_COUNTS.update(assignments=0, dropped=0)
    lines = {}

    # 1. uninterrupted, no fault tolerance
    tr, res, peak = _run_trainer(cfg, tcfg, os.path.join(root, "none"),
                                 "none", TRAIN_STEPS, seq)
    if tr.info["mesh"] is None or tr.info["mesh"].size != 1:
        raise AssertionError(f"the trainer's step has mesh "
                             f"{tr.info['mesh']}, not one card")
    lines["none"] = _mode_line(tr, res, peak, 0)
    tr_mesh = tr.info["mesh"]
    ep = {k: int(v) for k, v in moe_mod.EP_COUNTS.items()}
    if bool(cfg.n_experts) != bool(ep["assignments"]):
        raise AssertionError(f"expert-parallel path counts {ep} for "
                             f"{cfg.n_experts} experts")
    final_none = {n: p.clone() for n, p in tr._final_params.named_parameters()}
    losses_none = res.losses
    # where a step's time goes: the forward and backward pass alone, a
    # whole step, a profiled step, and the ADCC checksums of its state
    batch = {k: torch.from_numpy(v).to(tr.device)
             for k, v in tr.pipeline.batch_at(TRAIN_STEPS).items()}
    lm, opt = tr._final_params, tr._final_opt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.info["value_and_grad"](lm, batch)
    torch.cuda.synchronize()
    fwd_bwd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm, opt, _, _, _ = tr.step_fn(lm, opt, {}, batch, None)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    profile = _device_profile(
        lambda: tr.step_fn(lm, opt, {}, batch, None))
    trees = (reference_tree(cfg, dict(lm.named_parameters())),
             opt_tree(cfg, opt))
    cks_ms = time_ms(lambda: [tree_checksums(t) for t in trees], 3)
    lines["none"].update({"fwd_bwd_s": fwd_bwd_s, "step_s": step_s,
                          "optimizer_and_checksums_s": step_s - fwd_bwd_s,
                          "tree_checksums_params_opt_ms": cks_ms,
                          "profile_one_step": profile})
    del tr, lm, opt, batch, trees

    if baselines:
        # the same run without deterministic algorithms: their cost
        tr, res, _ = _run_trainer(cfg, tcfg, os.path.join(root, "nondet"),
                                  "none", TRAIN_STEPS, seq,
                                  deterministic=False)
        lines["none_nondeterministic"] = {
            "median_step_s": _median(res.step_seconds[1:]),
            "step_seconds": res.step_seconds,
            "final_params_bitwise_equal": all(
                torch.equal(p, final_none[n])
                for n, p in tr._final_params.named_parameters())}
        del tr

    # 2. ADCC to step 3, tear the newest slot, recover and replay
    wd = os.path.join(root, "adcc")
    tr, res, peak = _run_trainer(cfg, tcfg, wd, "adcc", TRAIN_CRASH_RUN, seq)
    first = _mode_line(tr, res, peak, 0)
    if res.losses != losses_none[:TRAIN_CRASH_RUN]:
        raise AssertionError(f"adcc losses {res.losses} differ from the "
                             f"uninterrupted run's {losses_none}")
    recs = tr.ledger.validated_records()
    if [r.step for r in recs] != list(range(TRAIN_CRASH_RUN)):
        raise AssertionError(f"ledger holds {[r.step for r in recs]}")
    slots = tr.store.slots_by_recency()
    if slots != [(1, 3), (0, 1)]:
        raise AssertionError(f"slots {slots}, expected steps 3 and 1")
    d = tr.store.slot_dir(slots[0][0])
    leaf = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
    arr = np.load(os.path.join(d, leaf))
    np.save(os.path.join(d, leaf), arr + 1000.0)
    del tr, arr
    tr, res, peak = _run_trainer(cfg, tcfg, wd, "adcc", TRAIN_STEPS, seq)
    second = _mode_line(tr, res, peak, 2)
    checks = tr.recovery_checks
    if res.resumed_from != 1 or len(checks) != 2 \
            or checks[0][1] != 3 or checks[0][2] == 0 \
            or checks[1][1:] != (1, 0) \
            or res.recovery_report != f"slot {checks[1][0]} @ step 1 verified":
        raise AssertionError(f"recovery: resumed_from {res.resumed_from}, "
                             f"checks (slot, step, bad leaves) {checks}, "
                             f"report {res.recovery_report!r}")
    if res.losses != losses_none[2:]:
        raise AssertionError(f"replayed losses {res.losses} differ from "
                             f"{losses_none[2:]}")
    max_diff = max(float((p - final_none[n]).abs().max())
                   for n, p in tr._final_params.named_parameters())
    if max_diff != 0.0:
        raise AssertionError(f"resumed parameters differ from the "
                             f"uninterrupted run's by {max_diff}")
    # 3. every ledger record passes the chain
    all_recs = tr.ledger.read_all()
    ratios = _chain_ratios(all_recs)
    if len(ratios) != len(all_recs) - 1 or max(ratios) >= 1.0:
        raise AssertionError(f"ledger chain ratios {ratios}")
    lines["adcc"] = {"crash_run": first, "resumed_run": second}
    del tr, final_none
    shutil.rmtree(wd, ignore_errors=True)

    # 4. the synchronous-checkpoint baseline
    if baselines:
        tr, res, peak = _run_trainer(cfg, tcfg, os.path.join(root, "sync"),
                                     "sync", TRAIN_STEPS, seq)
        lines["sync"] = _mode_line(tr, res, peak, 0)
        if res.losses != losses_none:
            raise AssertionError(f"sync losses {res.losses} differ")
        del tr
    gc.collect()
    torch.cuda.empty_cache()

    launches = _launch_counts()
    if any(launches.values()):
        raise AssertionError(f"training launched {launches}: its loss runs "
                             f"plain attention, as the reference's")
    none_plain = lines["none"]["median_step_s"]
    adcc_steps = (first["step_seconds"][1:]
                  + second["step_seconds"][1:])
    if baselines:
        lines["sync_overhead_share_slot_step"] = \
            lines["sync"]["median_slot_step_s"] / none_plain - 1
        lines["determinism_cost_share"] = \
            none_plain / lines["none_nondeterministic"]["median_step_s"] - 1
    full_depth = get_config(arch).n_layers
    emit({"phase": "train", "arch": arch,
          "depth_cut": (f"{cfg.n_layers} of {full_depth} layers"
                        if cfg.n_layers != full_depth else None),
          "n_layers": cfg.n_layers, "family": cfg.family,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "n_experts": cfg.n_experts, "moe_d_ff": cfg.moe_d_ff,
          "use_mla": cfg.use_mla,
          "params": n_params, "slot_gb": _slot_bytes(cfg) / 1e9,
          "batch": TRAIN_BATCH, "seq": seq, "optimizer": tcfg.optimizer,
          "mesh": dict(tr_mesh.shape),
          "ep_assignments_first_run": ep["assignments"],
          "ep_dropped_share_first_run": (ep["dropped"] / ep["assignments"]
                                         if ep["assignments"] else None),
          "remat": tcfg.remat, "slot_every": TRAIN_SLOT_EVERY,
          "n_slots": TRAIN_SLOTS, "losses": losses_none,
          "recovery_checks": [list(c) for c in checks],
          "resumed_from": 1, "replayed_steps": [2, 3, 4, 5],
          "resumed_vs_uninterrupted_max_abs_diff": max_diff,
          "ledger_records": len(all_recs),
          "chain_worst_ratio": max(ratios),
          "slot_bad_leaves_accepted": checks[1][2],
          "adcc_overhead_share": {
              "plain_step": second["median_plain_step_s"] / none_plain - 1,
              "slot_step": _median(first["step_seconds"][1::2]
                                   + second["step_seconds"][1::2])
              / none_plain - 1,
              "all_steps": _median(adcc_steps) / none_plain - 1},
          "launches": launches, **lines})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated, in this order: " + ",".join(PHASES))
    want = [p for p in ap.parse_args().phases.split(",") if p]
    if want != [p for p in PHASES if p in want]:
        ap.error(f"--phases must name phases of {','.join(PHASES)} in order")

    # float32 products in full float32 (both are PyTorch's defaults for
    # matmul; cuDNN's is TF32): the float32 kernel checks compare with them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_card()
    records = []
    if "build" in want:
        phase_build()
    if "kernels" in want:
        records = phase_kernels()
    if "sweep" in want:
        phase_sweep(records)
    if "sharded" in want:
        phase_sharded()
    if "kv" in want:
        phase_kv()
    if "device" in want:
        phase_device()
    if "serve" in want:
        phase_serve(records)
    if "serve_moe" in want:
        phase_serve_moe(records)
    if "serve_ssm" in want:
        phase_serve_ssm()
    if "serve_vlm_audio" in want:
        phase_serve_vlm_audio(records)
    if "examples" in want:
        phase_examples(records)
    if "mesh" in want:
        phase_mesh(records)
    if "mesh_train" in want:
        phase_mesh_train()
    if "dryrun" in want:
        phase_dryrun()
    if "train" in want:
        phase_train()
    if want != list(PHASES):
        emit({"partial": True, "kernels": records})
        return
    emit({"kernels": records})
    emit({"phase": "total", "seconds": time.perf_counter() - t0})
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
