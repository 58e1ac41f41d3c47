#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card: the quickest proof that the port still builds, agrees with its
plain versions, serves h2o-danube-1.8b, mamba2-1.3b, qwen3-moe-235b-a22b,
deepseek-v3-671b, recurrentgemma-9b, whisper-tiny, llama-3.2-vision-90b,
minicpm-2b, deepseek-67b and llama3-405b at full width (the MoE, vision and
two largest dense models with their depth cut to fit the card), runs the
paper's loop (microbenchmark -> calibrate -> predict -> validate) on the
card, trains h2o-danube-1.8b at full width and depth, trains with int8 Adam
moments at full width: danube, recurrentgemma-9b whole, and qwen3-moe and
llama-3.2-vision with their depth cut, runs the two sharded paths on
two ranks that share the card (expert-parallel MoE, head-sharded SSD),
prices three production cells with the dry run, and runs the port's
contract gate and two of its examples.

    python3 chip_smoke.py

Phases, one line each (each raises on failure; the script then exits
non-zero and prints no result):

1. machine   - the card's name and power limit (nvidia-smi), torch, CUDA,
               nvcc, SM count, whether triton imports.
2. build     - nvcc builds every kernel of the paths from ``src/repro_torch/
               csrc``, one process per source, all started together; time
               and the compiler's report for each kernel function
               (registers, static shared memory, spills).
3. kernels   - each kernel against its plain PyTorch version on the card,
               at the main paths' shapes and at edge shapes; kernel, plain,
               library and bound times at the main paths' shapes, each
               line naming the kernel's design (DESIGN).
               flash_attention: fp32 at 5e-5 (the reference's kernel
               tolerance, tests/test_kernels.py:22), bf16 at atol 1e-3 +
               rtol 1e-2; head dims 16/64/80/128/256, recurrentgemma-9b's
               shape (D=256, MQA, window 2048), its smoke config's (D=16),
               a head dim the wrapper pads (d=40 runs at 64), qwen3-moe's
               (64 query heads on 4 kv heads, D=128, S=8192),
               deepseek-v3's dense prefix block's (128 heads of 128,
               S=2048), whisper-tiny's encoder's (non-causal, 6 heads of
               64, S=1536) and llama-3.2-vision's (64 query heads on 8,
               D=128, S=8192), each timed in both dtypes.
               ssd (fp32 only, as the model sends it): 1e-4 against the
               plain chunked version, the reference's 5e-4 /
               5e-3 (tests/test_kernels.py:181) against the exact scan,
               chunks 64/128/256 agreeing at 2e-4 / 2e-3, and the
               decay-stability case finite; timed at mamba2's main shape
               beside its 3xTF32 and fp32 CUDA-core bounds, with each of
               its three passes timed by torch.profiler (the
               "[kernel] ssd passes" line).  matmul (fp32 and bf16):
               the reference's 5e-5 * sqrt(k) / 5e-2 * sqrt(k)
               (tests/test_kernels.py:112-114) at edge shapes and the
               suite's 4096^3 and 8192^3, every instantiated tile (four
               fp32, six bf16) giving the same bits, fp32 also against the fp64 product at the
               same tolerance (cuBLAS's distance from it printed beside
               the kernel's); 8192^3 timed in fp32 (beside the fp32
               CUDA-core and the 3xTF32 bounds) and in bf16.  rmsnorm
               (fp32 and bf16): the reference's 5e-5 / 5e-2 over rows
               1/100/65536 x D 8/64/1024/2560/8192/16384 and a
               leading-dims case; at 65536 x 2560 the kernel and
               ``rms_norm`` timed interleaved, five timings each, and
               compared by their medians.
   loop      - the paper's loop at the card's sizes, through
               ``launch.validate.validate_device``: calibrate_device
               (measured parameters beside the datasheet h100.json values;
               run three times, each parameter's median and range
               printed; the vector rate above half the fp32 peak and
               below the peak), the validation suite (12 cases, among
               them the hand-written matmul and rmsnorm), each case's
               measured, model and roofline times, and four MAEs against
               roofline MAE.  Launch counts read around it: matmul and
               rmsnorm as the suite implies, flash attention and ssd 0.
   tiles     - the paper's adaptive tile selection (§IV-B): at six GEMM
               shapes, every instantiated matmul tile's model time
               (``kernels/matmul/ops.select_blocks``) beside its measured
               time, the model's pick, the measured best, the regret and
               the rank correlation; every tile checked against the plain
               version and bit for bit; matmul launches counted.
   predict_serve - the paper's serving surface on the card's numbers: a
               server subprocess of the port (``serve.subproc``, HTTP and
               the binary transport, a two-worker pool) is given the
               loop's measured parameters (read back equal) and measured
               suite (its class calibration equal to the in-process fit),
               and answers which matmul tile to run at each tiles shape
               (equal to ``select_blocks``' pick and cost bit for bit on
               both transports); each served pick is launched through the
               kernel (6 matmul launches), held to the plain version and to
               the tiles phase's bits.  The server's processes hold none of
               the card's device files open (no CUDA context); once
               started they do not map the driver library (importing the
               server loads no torch; its start is printed beside
               SERVER_START_TORCH_S, its start when it did).  Host-clock
               latencies (argmin over each transport, a 102,400-row
               lattice with the pool's start) are printed, not gated.
4. prefill   - each model's main path: ``make_prefill`` at full width
               (random weights from a seed) for one request, with every
               kernel's launch count read around it; held against the
               plain path in fp32, timed in bf16 (and held there too but
               for mamba2; see BF16_GATED).  h2o-danube-1.8b (full depth,
               8192 tokens) reaches flash attention 24 times, mamba2-1.3b
               (full depth, 8192) the SSD scan 48 times, qwen3-moe-235b-a22b
               (8 of 94 layers, 8192) flash attention 8 times and
               deepseek-v3-671b (one dense prefix and two MoE layers of 61,
               2048 tokens) once, in its prefix (MLA reaches no kernel, as
               in the reference); recurrentgemma-9b (full depth, 8192)
               flash attention 12 times (its local attention; the RG-LRU
               scan is plain torch, as the reference's is no kernel),
               whisper-tiny (full size, 1536 tokens and 1536 frames) 8
               times (4 non-causal in the encoder, 4 causal in the
               decoder; cross-attention reaches none, as in the reference)
               and llama-3.2-vision-90b (20 of 100 layers, 8192 tokens,
               1601 image embeddings) 20 times; minicpm-2b (whole, 8192;
               MHA at D=64, its head tied to the embedding) 40 times,
               deepseek-67b (30 of 95 layers) 30 and llama3-405b (6 of
               126) 6; PREFILL gives the cuts and why.  The fp32 check runs at depth 2 for the MoE models,
               5 for llama-3.2-vision, the others whole.  For the MoE
               models the lines also count, with ``models.moe.route``, the
               assignments each layer drops and those the fp32 paths route
               differently.  Every cross-attention gate (``xgate``, 0 at
               init, which would hide cross-attention) is set to XGATE on
               each model a check compares.  The kernel path drops the
               attention softcap (recurrentgemma-9b's 30), as the
               reference's does, so the plain path it is held to runs at
               softcap 0; the softcap's own effect is printed.
               RAGGED_PREFILL repeats three requests off the 8 grid:
               h2o-danube-1.8b at 3669 tokens (24 launches),
               recurrentgemma-9b at 3669 (none: off the 128 grid its
               softcap keeps the plain path, so both sides run it with the
               softcap) and whisper-tiny at 1500 tokens and frames (8).
               llama-3.2-vision's bf16 gap is traced (VISION_TRACE: one
               attn block, one cross_attn block, depths 5 and 20, every
               xgate at 0 and at XGATE), printed, not gated.
5. generate  - ``launch.serve.serve`` (batch 4, prompt 256, 32 new tokens)
               for each model (``greedy_generate`` on the depth-cut config
               for the MoE and vision models; the audio and vision models
               with fp32 memory embeddings from the seed); tokens checked,
               no kernel launched, the prompt's last-token logits of the
               kernel path held against the sequential cache prefill
               (danube in bf16, the others in fp32, llama-3.2-vision at its
               fp32 check depth; the MoE models on PROMPT_CHECK_ROWS of
               the prompt at their fp32 check depth with the capacity
               factor raised
               to E/k, so nothing drops, and the served forward's drops
               and the two paths' route flips printed; recurrentgemma-9b
               also holds the plain make_prefill against the sequential
               prefill at softcap 30).
6. train     - (a) h2o-danube-1.8b at full width with 2 layers, fp32:
               two ``make_train_step`` steps (batch 2, seq 256) on the
               card against the same steps on the CPU from one numpy
               parameter tree (``params_to_jax`` / ``params_from_jax``):
               loss, grad norm and every parameter after each step; then
               microbatches 2 and remat "block" / "full" against the plain
               steps on the card; qwen3moe-smoke and dsv3-smoke (the MoE
               dispatch, MLA, the dense prefix, the aux and MTP losses)
               card against CPU, and rg-smoke, whisper-smoke and vlm-smoke
               (the RG-LRU, the encoder, cross-attention with live gates)
               the same way; all at the reference's atol 2e-5 / rtol
               2e-4 (tests/test_substrate.py:213-215).  Resume through
               ``launch.train.train`` (danube-smoke, 2 + 2 steps with a
               checkpoint under ``build/``) against 4 straight steps at
               1e-6 (:263).  (b) the shipped config (bf16, remat "block",
               attn_chunk 1024) at full depth: 10 steps of batch 8 x seq
               2048 through ``launch.train.train`` at lr 1e-3; each step's
               loss, grad norm, lr and ms, the median step of steps 2-10,
               tokens/s, model FLOPs and their share of the bf16 peak,
               peak memory; losses finite and falling (mean of the last
               three below the first three).  No kernel is launched in the
               phase: the model trains on its plain paths, as the
               reference does.
7. train_q8  - int8 Adam moments (``optim/quantized_moments``), no kernel
               launched on any of its paths: (a) three chained
               ``q8nd_adamw_update`` steps at danube-smoke and vlm-smoke
               (gates at XGATE) on the CPU, each also run on the card from
               the CPU's state (codes differing by at most 1, in at most
               Q8_CODE_SHARE of them; params at Q8_STEP_PARAMS_TOL), and
               a free-running chain on the card (share gated, its largest
               code difference printed, params at Q8_PARAMS_TOL); (b)
               h2o-danube-1.8b as the train phase's (b), with
               ``init_state(moment_dtype="int8")`` and
               ``make_train_step(q8_moments=True)`` in the launcher's loop,
               beside the bf16-moment record (DANUBE_BF16_MOMENTS) and the
               memory the moments should save, printed before the run;
               losses falling, moments int8; (c) recurrentgemma-9b whole,
               qwen3-moe-235b-a22b (3 of 94 layers), llama-3.2-vision-90b
               (10 of 100) and whisper-tiny whole at full width, batch 1,
               S=2048 (whisper 1536 against 1536 frames), 3 steps at lr
               1e-3: each model's parameter count, its state reckoned
               (``state_bytes``), the memory it holds, its peak, each
               step's ms and loss, losses and grad norms finite; a model
               that runs out of memory runs at its next depth
               (Q8_MODELS), the miss printed; (d) deepseek-v3: one MoE
               layer with its embedding and head, counted on the meta
               device, over the card; not run.
8. sharded   - two spawned ranks share the card over gloo (NCCL refuses
               two ranks on one GPU) as a (data 1, model 2) mesh, after a
               probe that gloo takes CUDA tensors for its all-reduce and
               all-gather: qwen3-moe-235b-a22b at depth 2, full width, 64
               of each layer's 128 experts a rank (``moe_apply_sharded``):
               fp32 logits over the generate phase's 4 x 256 prompt at
               capacity E/k (1e-3) and one backward's expert grads,
               gathered on rank 0
               (TRAIN_TOL), against rank 0's one-device run of the same
               weights; bf16 at S=8192 and the config's capacity timed,
               each rank's drops a layer (their sum equal to one device's
               in the first layer), the gap to one device printed;
               mamba2-1.3b with ``ssd_shard_map`` (32 of 64 heads a rank):
               fp32 depth 4 at S=8192, logits and every gradient at
               SSD_SHARD_TOL against the one-device plain path, then the
               bf16 forward timed at SHARDED_MAMBA_TIMED_CUT; each
               collective's bytes a layer, its measured gloo time and
               ``core/collectives`` price on NVLink.  A rank that fails
               fails the phase.
9. dryrun    - the dry run (``launch/dryrun.py``), no card needed and no
               kernel launched (counted across the phase): (a) three
               production cells through its CLI, each a subprocess that
               sees no card (DRYRUN_CELLS: danube train_4k at 16x16,
               qwen3-moe decode_32k at 2x16x16, mamba2 long_500k at
               16x16), each row's H100-priced terms, dominant term, useful
               FLOP share, a rank's memory, ``fits`` and trace seconds; a
               cell that fails or outlives DRYRUN_TIMEOUT_S fails the
               phase; (b) meanwhile, the dry run's one-rank trace of each
               training step the card ran (the train phase's (b), the
               train_q8 phase's (c): same config, depth, batch and
               moments): its peak beside ``max_memory_allocated``, gated
               within DRYRUN_PEAK_BAND both ways, and its FLOPs over the
               measured step as a share of the bf16 peak (danube's beside
               the train phase's own share).
10. contracts - the port's contract gate, ``python -m repro_torch.analysis
               --json``, as a subprocess under this interpreter on the tree
               as this machine has it: errors, warnings and suppressed
               findings and its seconds; any error or warning fails it.
11. examples - two of the port's examples (``examples_torch/``) as
               subprocesses on the card (EXAMPLES): ``quickstart.py``
               (parts 1-2 on the host, then minicpm-2b's smoke config 30
               steps) and ``train_lm.py --preset 100m`` (138M parameters,
               16 x 512 tokens a step; TRAIN_LM_STEPS steps).  Each one's
               wall seconds and first and last loss; a non-zero exit or a
               last loss not below the first fails it.  They train on the
               plain paths (no kernel is on the training path).
12. result   - the script's seconds; one JSON line listing every kernel
               (a kernel's launches: the sum over the main paths' counted
               runs, each path's count under launches_by_path), then the
               last line
               ``{"ok": true, "device": {...}}``.

TF32 is switched off for matmuls and cuDNN, so every fp32 product on the
card is a full fp32 product.  Nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import gc
import json
import math
import multiprocessing
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# torch.compile (the loop's compiled cases) compiles in this process rather
# than in a pool of worker processes, so the script leaves none behind.
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch import distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch.configs import get_config, memory_len  # noqa: E402
from repro_torch.core import hardware, microbench  # noqa: E402
from repro_torch.core.collectives import collective_time  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    kernel as fa_kernel, ref as fa_ref)
from repro_torch.kernels.matmul import (  # noqa: E402
    kernel as mm_kernel, matmul, ops as mm_ops, ref as mm_ref)
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    kernel as rms_kernel, ref as rms_ref, rmsnorm)
from repro_torch.kernels.ssd import (  # noqa: E402
    kernel as ssd_kernel, ref as ssd_ref)
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.configs.registry import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    NVLINK_BYTES_PER_S_ONE_WAY, fake_world, make_test_mesh, mesh_spec_of)
from repro_torch.launch.serve import serve, setup  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.launch.validate import validate_device  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.attention import flash_takes_length  # noqa: E402
from repro_torch.models.blocks import CrossAttnBlock  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    jax_layout, params_from_jax, params_to_jax, state_from_jax,
    state_to_jax)
from repro_torch.optim.quantized_moments import (  # noqa: E402
    moment_bytes_per_param, q8nd_adamw_update)
from repro_torch.optim.schedule import for_arch  # noqa: E402
from repro_torch.train.serve_step import (  # noqa: E402
    greedy_generate, make_prefill)
from repro_torch.train.train_step import (  # noqa: E402
    init_state, make_train_step)

DANUBE = "h2o-danube-1.8b"
MAMBA2 = "mamba2-1.3b"
QWEN3 = "qwen3-moe-235b-a22b"
DSV3 = "deepseek-v3-671b"
RG = "recurrentgemma-9b"
WHISPER = "whisper-tiny"
VISION = "llama-3.2-vision-90b"
MINICPM = "minicpm-2b"
DS67 = "deepseek-67b"
LLAMA3 = "llama3-405b"
ARCHS = (DANUBE, MAMBA2, QWEN3, DSV3, RG, WHISPER, VISION, MINICPM, DS67,
         LLAMA3)
SEED = 0
PREFILL_LEN = 8192          # danube: > window + 1 = 4097, the SWA mask bites
# Each served model's prefill: (prompt length, the served config's depth
# cut, the fp32 check's depth cut), widths as published.  One 80 GB card
# forces the MoE cuts: in bf16 a qwen3-moe block is 4.97 GB (8 of 94 blocks
# and the 2.49 GB embedding and head: 42.3 GB), a deepseek-v3 MoE block
# 23.0 GB (its dense prefix block 1.03 GB, embedding and head 3.71 GB, MTP
# 1.23 GB: 52.0 GB for one prefix and two MoE blocks of 61).  The fp32
# checks hold the kernel path against the plain one at depth 2 (24.9 and
# 58.0 GB).  deepseek-v3 prefills 2048 tokens: MLA materialises its fp32
# scores whole, as the reference does, 2.15 GB a tensor at 2048 (8.6 GB at
# 4096, which does not fit beside the weights).  recurrentgemma-9b is whole
# in both dtypes: 17.3 GB in bf16, 34.5 GB in fp32, beside two fp32 logit
# tensors of 8.4 GB (8192 x 256,000) and the head's product.  whisper-tiny
# is whole, 1536 tokens against 1536 frames: 30 s of audio (1500 frames)
# rounded up to a multiple of 128, so that its times compare with the
# earlier runs', with the encoder and decoder lengths equal as the config
# maps them (enc_seq_ratio 1).  llama-3.2-vision-90b: 20 of 100 layers (4
# groups of four attn and a cross_attn block, 39.6 GB in bf16; 100 would be
# 181 GB), the fp32 check at 5 (one group, 26.1 GB); the memory is its 1601
# image embeddings.
# minicpm-2b is whole (5.45 GB in bf16: the only MHA config, 36 heads of 64,
# its head tied to the embedding).  deepseek-67b: 30 of 95 layers (1.384 GB
# a layer, 3.36 GB of embedding and head: 44.9 GB); llama3-405b: 6 of 126
# (6.375 GB a layer, 8.41 GB: 46.7 GB); each leaves the card room for the
# request's activations and logits.  Their fp32 checks run depth 2 (minicpm
# 1.62 GB; deepseek-67b 12.3 GB; llama3-405b 42.3 GB beside the plain path's
# fp32 score chunk, 128 x 1024 x 8192 x 4 B = 4.3 GB, and two fp32 logit
# tensors of 4.2 GB).
PREFILL = {DANUBE: (PREFILL_LEN, {}, {}),
           MAMBA2: (PREFILL_LEN, {}, {}),
           QWEN3: (PREFILL_LEN, {"n_layers": 8}, {"n_layers": 2}),
           DSV3: (2048, {"n_layers": 3, "first_dense": 1},
                  {"n_layers": 2, "first_dense": 1}),
           RG: (PREFILL_LEN, {}, {}),
           WHISPER: (1536, {}, {}),
           VISION: (PREFILL_LEN, {"n_layers": 20}, {"n_layers": 5}),
           MINICPM: (PREFILL_LEN, {}, {"n_layers": 2}),
           DS67: (PREFILL_LEN, {"n_layers": 30}, {"n_layers": 2}),
           LLAMA3: (PREFILL_LEN, {"n_layers": 6}, {"n_layers": 2})}
# Three models' requests again at a prompt length off the 8 grid, at
# PREFILL's cuts: danube at a chat prompt's 3669 tokens (the kernel, a
# ragged last tile), recurrentgemma-9b at the same (its softcap keeps the
# plain path there: no launch), whisper-tiny at 30 s of audio's own 1500
# frames (the non-causal encoder's ragged tile too).
RAGGED_PREFILL = {DANUBE: 3669, RG: 3669, WHISPER: 1500}
# Every cross-attention gate is set to this on each model a check compares
# (both sides): the reference's init sets it to 0, and tanh(0) = 0 would
# make a cross_attn block add nothing from the memory, so a check would pass
# whatever cross-attention computed.
XGATE = 0.5
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 256, 32
KERNELS = {"flash_attention": fa_kernel, "ssd": ssd_kernel,
           "matmul": mm_kernel, "rmsnorm": rms_kernel}

# Published H100 SXM peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3.
# They hold for that card only: ``machine`` refuses any other.  "3xtf32" is
# the rate of an fp32 product made of three TF32 products on the tensor
# cores (495 TFLOP/s TF32), the way the matmul and SSD kernels compute
# fp32.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              "3xtf32": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12

# Kernel against its plain version.  fp32: the reference's kernel
# tolerance.  bf16: both sides compute scores and softmax in fp32; the
# kernel rounds P to bf16 as p_hi + p_lo (~16 bits, so ~2^-16 of |v|) before
# the product with V, and both round the output once, so they differ by at
# most one bf16 unit (under 2^-7 of the value, inside rtol) plus that small
# term; atol covers it and the fp32 sums' own difference.  At the main shape
# |out| is ~0.02 (4097 live keys), so the bound there is ~6% of a typical
# value.  P rounded once to bf16 would not hold it: rows with a few live keys
# would move by up to a bf16 unit of |v| (scripts/flash_p_rounding.py
# measures that variant on the card).
KERNEL_TOL = {torch.float32: {"atol": 5e-5, "rtol": 5e-5},
              torch.bfloat16: {"atol": 1e-3, "rtol": 1e-2}}
# Full-model logits, kernel path against the plain chunked path.  fp32: the
# two paths differ only in the order of fp32 sums (32-key tiles against
# whole-row einsums), compounded over 24 layers.  bf16: every op rounds its
# output to 8 mantissa bits, so where the paths' fp32 sums straddle a
# rounding boundary the bf16 values differ by one unit (0.4%), and those
# flips propagate through 24 layers; the bound is loose for that reason.
FP32_REQUEST_TOL = 1e-3
BF16_REQUEST_TOL = {"atol": 1e-1, "rtol": 5e-2}
# mamba2 runs its SSD kernel in fp32 whatever the model's dtype, so its fp32
# request (gated above) already holds the kernel.  In bf16 its 48 recurrent
# layers carry a rounding flip anywhere into every later token and layer,
# so two paths that differ only in the order of fp32 sums give bf16 logits
# as far apart as the bound itself: a bf16 bound could not tell a fault from
# rounding.  For mamba2 the bf16 difference is printed beside the fp32 gate,
# not gated, and the prompt logits of make_prefill are held against the
# sequential cache prefill in fp32 (the served weights cast up).
# The MoE models' bf16 logits held the bound on the card with room
# (qwen3-moe 3.906e-2, deepseek-v3 6.445e-2: about two bf16 units of a
# logit near 7), so they are gated as danube's are; so is whisper-tiny
# (2.344e-2 on logits under 2, 4 + 4 layers).  recurrentgemma-9b is printed
# as mamba2 is: 26 recurrent layers carry a bf16 flip into every later
# token, and its kernel and plain paths were 1.914e-1 apart in bf16 on the
# card (4.268e-5 in fp32, gated), as far apart as the bound itself.  So is
# llama-3.2-vision: 1.309e-1 at depth 20 (6.253e-5 in fp32), past atol, so
# whether a run passes would turn on which logit the largest flip lands on.
# minicpm-2b held it with room (1.123e-2 over 40 MHA layers at D=64) and is
# gated.  deepseek-67b (30 layers) and llama3-405b (6 layers) are printed as
# vision is: D=128 GQA like vision, and in bf16 their kernel and plain paths
# were 1.406e-1 and 1.523e-1 apart on logits up to 7.7 and 11.8 (1-2% of
# the largest logit, a few bf16 units; 4.625e-5 and 8.488e-5 in fp32,
# gated), past atol where a logit is small.
# An ungated model's line says whether it held the bound.
BF16_GATED = {DANUBE: True, MAMBA2: False, QWEN3: True, DSV3: True,
              RG: False, WHISPER: True, VISION: False, MINICPM: True,
              DS67: False, LLAMA3: False}
# The MoE models' prompt logits are held in fp32, on the prefill phase's
# fp32 model (its depth cut: an fp32 copy of the served model would not fit
# beside it), with the capacity factor raised to E/k on both sides, so that
# cap = T and neither path drops an assignment (the served forward over
# 4 x 256 tokens drops by design, decode steps never do).  In bf16 the two
# paths route part of the prompt's assignments differently (rounding near
# ties), which moves the logits by up to the bf16 bound itself.  At
# cap = T the fp32 capacity buffer and the expert products' output are
# E x T x d each: qwen3-moe checks the whole 4 x 256 prompt (2.1 GB each
# beside its 24.9 GB model); deepseek-v3 its first 2 rows (3.8 GB each beside
# 58.0 GB; the whole prompt's 7.5 GB ran out of memory), still more than one
# row, so a fault across rows of the flattened dispatch or of the caches'
# batch index shows.
PROMPT_CHECK_DTYPE = {DANUBE: torch.bfloat16, MAMBA2: torch.float32,
                      QWEN3: torch.float32, DSV3: torch.float32,
                      RG: torch.float32, WHISPER: torch.float32,
                      VISION: torch.float32, MINICPM: torch.float32,
                      DS67: torch.float32, LLAMA3: torch.float32}
PROMPT_CHECK_ROWS = {QWEN3: GEN_BATCH, DSV3: 2}
# SSD kernel against ``ssd_chunked`` at the same chunk: the same algorithm
# in fp32 with its sums in another order (64-deep 3xTF32 partials, a warp
# scan for the cumsum, the decay applied after the C.h product).
SSD_TOL = {"atol": 1e-4, "rtol": 1e-4}
SSD_EXACT_TOL = {"atol": 5e-4, "rtol": 5e-3}     # tests/test_kernels.py:181
SSD_CHUNK_TOL = {"atol": 2e-4, "rtol": 2e-3}     # tests/test_kernels.py:198
# matmul and rmsnorm against their plain versions: the reference's kernel
# tolerances (tests/test_kernels.py:22); for the matmul atol is tol * sqrt(k)
# (tests/test_kernels.py:112-114).
MM_RMS_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
# What each kernel computes with, by input type (flash attention: by the
# name its wrapper's rule, ``kernel.select_design``, gives): printed on its
# lines and kept in its entry of the kernels JSON line.
DESIGN = {"flash_attention": {
              "wgmma": "wgmma + TMA, warp-specialised (attn_fwd_wg)",
              "mma.sync": "mma.sync bf16 + cp.async (attn_fwd_tc)",
              "fp32": "fp32 FMA, CUDA cores (attn_fwd_f32)"},
          "matmul": {torch.float32: "3xTF32 mma.sync + cp.async",
                     torch.bfloat16: "mma.sync bf16"},
          "ssd": {torch.float32: "3xTF32 mma.sync + cp.async, scores once "
                                 "per 16 heads"}}


def flash_design(q, k, v) -> str:
    """The design the flash wrapper picks for these inputs."""
    d = fa_kernel.padded_head_dim(q.shape[-1])
    return DESIGN["flash_attention"][fa_kernel.select_design(
        q.dtype, d, fa_kernel.tma_aligned(q, k, v))]


def expected_wgmma(cfg, flash_launches: int) -> int:
    """The flash launches of a request that take the wgmma kernel: all of
    them for a bf16 model whose (padded) head dim is among
    ``WGMMA_HEAD_DIMS`` (the models hand over 16-byte-aligned views), else
    none."""
    if flash_launches == 0 or cfg.dtype != "bfloat16":
        return 0
    d = fa_kernel.padded_head_dim(cfg.head_dim)
    return flash_launches if d in fa_kernel.WGMMA_HEAD_DIMS else 0


def check_wgmma(what: str, cfg, launches: dict) -> int:
    got = fa_kernel.wgmma_launches
    want = expected_wgmma(cfg, launches["flash_attention"])
    if got != want:
        raise AssertionError(f"{what}: {got} wgmma flash launches of "
                             f"{launches['flash_attention']}, want {want}")
    return got


def phase(label: str, **fields) -> None:
    print(f"[{label}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def max_abs_err(what: str, got, want) -> float:
    """Max |got - want|; raises if ``got`` has a non-finite value."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    return (got.float() - want.float()).abs().max().item()


def check_close(what: str, got, want, *, atol: float, rtol: float) -> float:
    err = max_abs_err(what, got, want)
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        raise AssertionError(f"{what}: max abs err {err:.3e} outside "
                             f"atol={atol} rtol={rtol}")
    return err


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn) -> float:
    """Wall time of one call that ends in a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


# --------------------------------------------------------------- phase 1-2

def machine() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    microbench.base_params()    # raises unless this is the SXM5 H100
    try:
        import triton  # noqa: F401
        has_triton = True
    except ImportError:
        has_triton = False
    props = torch.cuda.get_device_properties(0)
    phase("machine", card=repr(smi), torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=_build.nvcc_path(),
          sm_count=props.multi_processor_count,
          memory_gb=round(props.total_memory / 1e9, 1), triton=has_triton)


def build_kernels() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all(list(KERNELS))
    secs = time.perf_counter() - t0
    for name, lib in libs.items():
        phase("build", kernel=name, seconds=f"{secs:.1f}",
              library=lib.relative_to(ROOT))
        for line in (lib.parent / "build.log").read_text().splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"  ptxas: {line.strip()}", flush=True)


def reset_launches() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
    fa_kernel.wgmma_launches = 0


def read_launches() -> dict:
    return {name: mod.launches for name, mod in KERNELS.items()}


def expected_launches(cfg, seq, mlen) -> dict:
    """Kernel launches of one ``make_prefill`` request with the kernels on,
    over a prompt of ``seq`` tokens and a memory of ``mlen`` (None without
    one): one flash-attention call per GQA self-attention (the ``attn``,
    ``local_attn`` and ``cross_attn`` blocks, ``moe`` without MLA, each
    dense prefix block, and each encoder block over the memory) at the
    lengths ``flash_takes_length`` lets through, none for MLA or
    cross-attention, one SSD call per ssm block.  The models never reach
    the matmul or rmsnorm kernels, as in the reference."""
    per_group = {"flash_attention": sum(
        k in ("attn", "local_attn", "cross_attn")
        or (k == "moe" and not cfg.use_mla) for k in cfg.pattern),
        "ssd": sum(k == "ssm" for k in cfg.pattern),
        "matmul": 0, "rmsnorm": 0}
    want = {name: cfg.n_groups * n for name, n in per_group.items()}
    want["flash_attention"] += cfg.first_dense
    if not flash_takes_length(cfg, seq):
        want["flash_attention"] = 0
    if cfg.enc_layers and flash_takes_length(cfg, mlen):
        want["flash_attention"] += cfg.enc_layers
    return want


def check_launches(what: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, want {want}")


# ----------------------------------------------------------------- phase 3

def live_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave, i.e. the work these inputs
    need."""
    q = torch.arange(s, dtype=torch.int64)
    hi = q if causal else torch.full_like(q, s - 1)
    lo = (q - window).clamp(min=0) if window > 0 else torch.zeros_like(q)
    return int((hi - lo + 1).clamp(min=0).sum())


def attention_flops(b, hq, s, d, causal, window) -> float:
    return 4.0 * d * live_pairs(s, causal, window) * b * hq


def attention_bound_ms(b, hq, hkv, s, d, causal, window, dtype):
    flops = attention_flops(b, hq, s, d, causal, window)
    nbytes = torch.finfo(dtype).bits // 8 * (2 * b * hq * s * d
                                              + 2 * b * hkv * s * d)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def attention_inputs(b, hq, hkv, s, d, dtype, strided, gen):
    """q (B,Hq,S,D), k, v (B,Hkv,S,D).  ``strided``: transposed views of
    (B,S,H,D) tensors, the layout the model hands the kernel."""
    def make(h):
        if strided:
            return torch.randn((b, s, h, d), generator=gen,
                               device="cuda").to(dtype).transpose(1, 2)
        return torch.randn((b, h, s, d), generator=gen,
                           device="cuda").to(dtype)
    return make(hq), make(hkv), make(hkv)


CHECKS = [  # name, b, hq, hkv, s, d, causal, window, strided
    ("danube S=2048 w=4096", 1, 32, 8, 2048, 80, True, 4096, True),
    ("danube S=2048 w=256", 1, 32, 8, 2048, 80, True, 256, True),
    ("ragged S=1000", 1, 32, 8, 1000, 80, True, 4096, True),
    ("D=64 group 1", 1, 8, 8, 1024, 64, True, 0, False),
    ("D=64 group 4", 1, 32, 8, 1024, 64, True, 0, False),
    ("D=128 group 1", 1, 8, 8, 1024, 128, True, 0, False),
    ("D=128 group 4", 1, 32, 8, 1024, 128, True, 0, False),
    ("non-causal B=2", 2, 8, 2, 512, 80, False, 0, False),
    ("window 1", 1, 32, 8, 512, 80, True, 1, True),      # two live keys a row
    ("window 16", 1, 32, 8, 512, 80, True, 16, True),
    ("S=72 D=128", 1, 8, 2, 72, 128, True, 0, False),   # under one query tile
    ("D=256 ragged S=1000", 1, 16, 1, 1000, 256, True, 2048, False),
    ("D=256 strided S=2048 w=256", 1, 16, 1, 2048, 256, True, 256, True),
    # chat prompts off the 8 grid, as the chat traffic sends them: a ragged
    # last key tile and a partial query tile
    ("chat S=299 w=4096", 1, 32, 8, 299, 80, True, 4096, True),
    ("chat S=3669 w=4096", 1, 32, 8, 3669, 80, True, 4096, True),
    # non-causal off both grids, where only the key mask hides the tail:
    # whisper-tiny's 1500 frames, and D=128
    ("whisper encoder S=1500 non-causal", 1, 6, 6, 1500, 64, False, 0,
     True),
    ("non-causal S=999 D=128", 1, 8, 2, 999, 128, False, 0, True),
]
# The main path's call: one layer of the 8192-token prefill request, bf16.
MAIN = ("main path S=8192 w=4096", 1, 32, 8, PREFILL_LEN, 80, True, 4096,
        True)
# recurrentgemma-9b's local attention in its 8192-token prefill (12 calls a
# request): MQA, head dim 256, window 2048 (configs/recurrentgemma_9b.py).
D256 = ("recurrentgemma-9b S=8192 w=2048 D=256", 1, 16, 1, PREFILL_LEN, 256,
        True, 2048, True)
# The smallest instantiation: recurrentgemma-9b's smoke config (4 q heads, 1
# kv head, head dim 16, window 8; configs/recurrentgemma_9b.py), at the same
# prompt length.  And a head dim with no instantiation of its own: the
# wrapper zero-pads 40 to 64 and launches the D=64 kernel once.
D16 = ("recurrentgemma-9b smoke S=8192 w=8 D=16", 1, 4, 1, PREFILL_LEN, 16,
       True, 8, True)
D40 = ("padded d=40 S=8192 w=1024", 1, 8, 2, PREFILL_LEN, 40, True, 1024,
       True)
# The MoE paths' calls, as the models hand them over: qwen3-moe's GQA
# attention (64 query heads on 4 kv heads, head dim 128, causal) in its
# 8192-token prefill, and deepseek-v3's dense prefix block (MHA, 128 heads
# of 128) in its 2048-token prefill.
QWEN3_ATTN = ("qwen3-moe S=8192 Hq=64 Hkv=4 D=128", 1, 64, 4, PREFILL_LEN,
              128, True, 0, True)
DSV3_PREFIX = ("deepseek-v3 prefix S=2048 H=128 D=128", 1, 128, 128, 2048,
               128, True, 0, True)
# The encoder and cross-attention paths' calls: whisper-tiny's encoder
# (bidirectional, 6 heads of 64, over its 1536 frames; 4 calls a request)
# and llama-3.2-vision's self-attention (64 query heads on 8 kv heads, head
# dim 128, causal; 20 calls a request at depth 20).
WHISPER_ENC = ("whisper-tiny encoder S=1536 H=6 D=64 non-causal", 1, 6, 6,
               1536, 64, False, 0, True)
VISION_ATTN = ("llama-3.2-vision S=8192 Hq=64 Hkv=8 D=128", 1, 64, 8,
               PREFILL_LEN, 128, True, 0, True)


def sdpa_ms(q, k, v, *, sm_scale, causal, window, reps) -> float:
    """Yardstick only (the port never calls it): PyTorch's fused attention
    with the same boolean causal/window mask (none when bidirectional), on
    the kv heads repeated beforehand."""
    hq, hkv, s = q.shape[1], k.shape[1], q.shape[2]
    ids = torch.arange(s, device="cuda")
    mask = None
    if causal:
        mask = ids[None, :] <= ids[:, None]
        if window > 0:
            mask &= ids[None, :] >= ids[:, None] - window
    k_rep = k.repeat_interleave(hq // hkv, dim=1)
    v_rep = v.repeat_interleave(hq // hkv, dim=1)
    return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k_rep, v_rep, attn_mask=mask, scale=sm_scale), reps=reps)


def case_shape(spec) -> dict:
    _, b, hq, hkv, s, d, causal, window, strided = spec
    return {"b": b, "hq": hq, "hkv": hkv, "s": s, "d": d, "causal": causal,
            "window": window,
            "layout": "strided (B,S,H,D)" if strided else "(B,H,S,D)"}


def timed_case(spec, dtype, gen) -> dict:
    """One attention case in ``dtype``: checked against the plain version,
    timed beside its bound, the plain version's and SDPA's time; prints its
    ``[kernel]`` line."""
    name, b, hq, hkv, s, d, causal, window, strided = spec
    q, k, v = attention_inputs(b, hq, hkv, s, d, dtype, strided, gen)
    kw = dict(sm_scale=d ** -0.5, causal=causal, window=window)
    design = flash_design(q, k, v)
    fa_kernel.wgmma_launches = 0
    got = fa_kernel.mha(q, k, v, **kw)
    torch.cuda.synchronize()
    wgmma = fa_kernel.wgmma_launches
    tol = KERNEL_TOL[dtype]
    err = check_close(f"flash_attention {name} {dtype}", got,
                      fa_ref.attention(q, k, v, **kw), **tol)
    del got
    kernel_ms = cuda_ms(lambda: fa_kernel.mha(q, k, v, **kw), reps=10,
                        warmup=2)
    plain_ms = cuda_ms(lambda: fa_ref.attention(q, k, v, **kw), reps=3)
    library_ms = sdpa_ms(q, k, v, sm_scale=kw["sm_scale"], causal=causal,
                         window=window, reps=5)
    bound_ms, bound_by = attention_bound_ms(b, hq, hkv, s, d, causal, window,
                                            dtype)
    extra = {}
    if dtype == torch.bfloat16 and bound_by == "operations":
        # The work the design issues: P V twice (p_hi, p_lo), 6 D a live
        # pair.
        extra["split_p_bound_ms"] = f"{bound_ms * 1.5:.4f}"
    flops = attention_flops(b, hq, s, d, causal, window)
    dt = str(dtype)[6:]
    phase("kernel", kernel="flash_attention", case=repr(name), dtype=dt,
          design=repr(design), wgmma_launches=wgmma,
          max_abs_err=f"{err:.3e}", tol=tol, kernel_ms=f"{kernel_ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
          bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, **extra,
          tflops=f"{flops / kernel_ms / 1e9:.1f}")
    del q, k, v
    torch.cuda.empty_cache()
    return {"case": name, "dtype": dt, "max_abs_err": err, "tol": tol,
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "design": design}


def flash_attention_checks() -> dict:
    gen = generator(SEED, "cuda")
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        # bf16 at the main shape is checked below, where it is timed.  fp32
        # there needs the plain version's 8.6 GB score matrix.
        cases = CHECKS + [MAIN] if dtype == torch.float32 else CHECKS
        for name, b, hq, hkv, s, d, causal, window, strided in cases:
            q, k, v = attention_inputs(b, hq, hkv, s, d, dtype, strided, gen)
            out = fa_kernel.mha(q, k, v, sm_scale=d ** -0.5, causal=causal,
                                window=window)
            torch.cuda.synchronize()
            want = fa_ref.attention(q, k, v, sm_scale=d ** -0.5,
                                    causal=causal, window=window)
            tol = KERNEL_TOL[dtype]
            err = check_close(f"flash_attention {name} {dtype}", out, want,
                              **tol)
            checks.append({"case": name, "dtype": str(dtype)[6:],
                           "max_abs_err": err, "tol": tol})
            phase("kernel", kernel="flash_attention", case=repr(name),
                  dtype=str(dtype)[6:], design=repr(flash_design(q, k, v)),
                  max_abs_err=f"{err:.3e}", tol=tol)
            del q, k, v, out, want
            torch.cuda.empty_cache()

    main = timed_case(MAIN, torch.bfloat16, gen)
    checks.append({k: main[k] for k in ("case", "dtype", "max_abs_err",
                                        "tol")})
    extra_shapes = {}
    for key, spec in (("d256", D256), ("d16", D16), ("d40", D40),
                      ("qwen3_moe", QWEN3_ATTN),
                      ("dsv3_prefix", DSV3_PREFIX),
                      ("whisper_encoder", WHISPER_ENC),
                      ("vision", VISION_ATTN)):
        extra_shapes[key] = {"shape": case_shape(spec)}
        for dtype in (torch.float32, torch.bfloat16):
            case = timed_case(spec, dtype, gen)
            extra_shapes[key][case["dtype"]] = {k: case[k] for k in (
                "max_abs_err", "tol", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "design")}
    extra_shapes["d40"]["runs_at_head_dim"] = fa_kernel.padded_head_dim(40)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:100",
            "launches": None, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "design": main["design"],
            "shape": {**case_shape(MAIN), "dtype": "bfloat16"},
            "head_dims": list(fa_kernel.HEAD_DIMS), **extra_shapes,
            "checks": checks}


def ssd_work(b, s, h, p, n, chunk):
    """The operations and bytes of one SSD scan: the work the function needs
    on the live (j <= i) entries of each chunk, with C B^T once per chunk
    (it does not depend on the head); x, y, dt, a_log, b, c each moved
    once."""
    live = chunk * (chunk + 1) // 2
    per_chunk = 2 * live * n + h * (2 * live * p + 4 * chunk * n * p)
    flops = b * (s // chunk) * per_chunk
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n)
    return flops, nbytes


def ssd_inputs(b, s, h, p, n, gen, *, model_a_log=False):
    """x ~ N(0,1), dt = softplus(N(0,1)), B and C ~ N(0,1)/sqrt(N), as the
    reference's tests draw them; a_log is 0.5 N(0,1) there, or the model's
    own init log(linspace(1, 16, H)) (decay rates up to 16)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = randn(b, s, h, p)
    dt = torch.nn.functional.softplus(randn(b, s, h))
    if model_a_log:
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    else:
        a_log = 0.5 * randn(h)
    return x, dt, a_log, randn(b, s, n) / n ** 0.5, randn(b, s, n) / n ** 0.5


SSD_PASSES = ("chunk_state", "state_passing", "chunk_scan")


def ssd_pass_ms(args, chunk: int, reps: int = 10) -> dict:
    """Device time of each of the SSD kernel's three passes, mean ms a call,
    from torch.profiler's CUDA trace over ``reps`` calls; raises unless the
    trace holds every pass ``reps`` times."""
    from torch.profiler import ProfilerActivity, profile
    ssd_kernel.ssd(*args, chunk=chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            ssd_kernel.ssd(*args, chunk=chunk)
        torch.cuda.synchronize()
    us = dict.fromkeys(SSD_PASSES, 0.0)
    count = dict.fromkeys(SSD_PASSES, 0)
    for evt in prof.key_averages():
        for name in SSD_PASSES:
            if name in evt.key:
                us[name] += evt.device_time_total
                count[name] += evt.count
    if any(count[name] != reps or us[name] <= 0 for name in SSD_PASSES):
        raise AssertionError(f"the profiler saw passes {count} with device "
                             f"time {us} over {reps} calls")
    return {name: us[name] / reps / 1e3 for name in SSD_PASSES}


SSD_CHECKS = [  # name, b, s, h, p, n, chunk
    ("chunk 64", 1, 2048, 16, 64, 128, 64),
    ("chunk 128", 1, 2048, 16, 64, 128, 128),
    ("s < chunk (chunk = s = 200)", 1, 200, 16, 64, 128, 256),
    ("B=2", 2, 1024, 8, 64, 128, 256),
    ("N=P=16 chunk 16 (mamba2-smoke)", 2, 512, 8, 16, 16, 16),
    ("N=P=16 ragged chunk 100", 1, 300, 4, 16, 16, 100),
]
# The main path's call: one layer of the 8192-token mamba2-1.3b prefill.
SSD_MAIN = ("main path S=8192", 1, PREFILL_LEN, 64, 64, 128, 256)


def ssd_cases(gen) -> list:
    """The ssd checks' inputs, (name, (x, dt, a_log, b, c), chunk) each, the
    main path's call last."""
    cases = [(name, ssd_inputs(b, s, h, p, n, gen), min(chunk, s))
             for name, b, s, h, p, n, chunk in SSD_CHECKS]
    # Decay stability (tests/test_kernels.py:200-210) at the nearest
    # instantiated (N, P) = (16, 16): dt = 10, a_log = 2.
    x, _, _, bm, cm = ssd_inputs(1, 128, 1, 16, 16, gen)
    dt = torch.full((1, 128, 1), 10.0, device="cuda")
    a_log = torch.full((1,), 2.0, device="cuda")
    cases.append(("decay stability dt=10 a_log=2",
                  (x, dt, a_log, bm * 4.0, cm * 4.0), 64))  # N(0, 1), as there
    name, b, s, h, p, n, chunk = SSD_MAIN
    cases.append((name, ssd_inputs(b, s, h, p, n, gen, model_a_log=True),
                  chunk))
    return cases


def ssd_checks() -> dict:
    gen = generator(SEED + 2, "cuda")
    checks = []

    def check(name, args, chunk):
        y = ssd_kernel.ssd(*args, chunk=chunk)
        torch.cuda.synchronize()
        err = check_close(f"ssd {name} vs chunked", y,
                          ssd_ref.ssd_chunked(*args, chunk=chunk), **SSD_TOL)
        err_exact = check_close(f"ssd {name} vs exact scan", y,
                                ssd_ref.ssd_scan_ref(*args), **SSD_EXACT_TOL)
        checks.append({"case": name, "chunk": chunk, "max_abs_err": err,
                       "tol": SSD_TOL, "max_abs_err_exact": err_exact,
                       "tol_exact": SSD_EXACT_TOL})
        phase("kernel", kernel="ssd", case=repr(name), dtype="float32",
              design=repr(DESIGN["ssd"][torch.float32]),
              max_abs_err=f"{err:.3e}", tol=SSD_TOL,
              max_abs_err_exact=f"{err_exact:.3e}", tol_exact=SSD_EXACT_TOL)
        return y, err

    *edges, (name, args, chunk) = ssd_cases(gen)
    for case in edges:
        check(*case)
    y, err = check(name, args, chunk)
    for other in (64, 128):
        chunk_err = check_close(f"ssd {name} chunk {other} vs {chunk}",
                                ssd_kernel.ssd(*args, chunk=other), y,
                                **SSD_CHUNK_TOL)
        checks.append({"case": f"{name} chunk {other} vs {chunk}",
                       "max_abs_err": chunk_err, "tol": SSD_CHUNK_TOL})
        phase("kernel", kernel="ssd", case=repr(f"{name} chunk {other}"),
              max_abs_err_vs_chunk_256=f"{chunk_err:.3e}", tol=SSD_CHUNK_TOL)
    del y
    kernel_ms = cuda_ms(lambda: ssd_kernel.ssd(*args, chunk=chunk), reps=20,
                        warmup=2)
    plain_ms = cuda_ms(lambda: ssd_ref.ssd_chunked(*args, chunk=chunk),
                       reps=3)
    # The kernel's floor is its three TF32 products on the tensor cores; the
    # fp32 CUDA-core bound (what an fp32 FMA kernel could reach) beside it.
    _, b, s, h, p, n, _ = SSD_MAIN
    flops, nbytes = ssd_work(b, s, h, p, n, chunk)
    bnd, bound_by = bound_ms(flops, nbytes, "3xtf32")
    bnd_fp32, _ = bound_ms(flops, nbytes, torch.float32)
    design = DESIGN["ssd"][torch.float32]
    phase("kernel", kernel="ssd", case=repr(name), dtype="float32",
          design=repr(design), kernel_ms=f"{kernel_ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", library_ms=None,
          bound_ms=f"{bnd:.4f}", bound_by=bound_by,
          bound_fp32_cuda_cores_ms=f"{bnd_fp32:.4f}",
          tflops=f"{flops / kernel_ms / 1e9:.2f}")
    passes = ssd_pass_ms(args, chunk)
    print("[kernel] ssd passes " + " ".join(
        [f"case={name!r}"] + [f"{k}_ms={v:.4f}" for k, v in passes.items()]
        + [f"sum_ms={sum(passes.values()):.4f}"]), flush=True)
    del args
    torch.cuda.empty_cache()
    return {"name": "ssd", "route": "cuda", "source": "src/repro_torch/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:78",
            "launches": None, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": bound_by,
            # no single PyTorch call computes the SSD scan
            "library_ms": None, "design": design, "passes_ms": passes,
            "shape": {"b": b, "s": s, "h": h, "p": p, "n": n, "chunk": chunk,
                      "dtype": "float32"},
            "checks": checks}


# --------------------------------------------------- phase 3: matmul, rmsnorm

def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    """The larger of the operations over the peak rate of ``dtype`` (a
    ``PEAK_FLOPS`` key) on the CUDA cores or tensor cores, and the bytes
    over HBM's rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bits(t):
    """The tensor's bits, so that equality means the same bits."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def same_bits_from_every_tile(what: str, a, b):
    """Every instantiated tile for ``a``'s dtype on the same inputs: raises
    unless all give the same bits; returns (the first tile's output, the
    plain version's)."""
    tiles = mm_kernel.TILES[a.dtype]
    outs = [mm_kernel.matmul_tiled(a, b, bm=bm, bn=bn) for bm, bn in tiles]
    torch.cuda.synchronize()
    for tile, out in zip(tiles[1:], outs[1:]):
        if not torch.equal(bits(out), bits(outs[0])):
            raise AssertionError(f"{what}: tile {tile} differs in its bits "
                                 f"from tile {tiles[0]}")
    return outs[0], mm_ref.matmul(a, b)


MM_CHECKS = [(8, 8, 8), (64, 64, 8), (100, 257, 1000), (129, 4097, 257),
             (4095, 4097, 129), (256, 256, 8192)]
MM_PLAIN = (4, 512, 512)        # min(m, n, k) < 8: ops takes the plain version
MM_SUITE = [(n, n, n) for n in microbench.CARD.gemm_kernels]
MM_MAIN = (8192, 8192, 8192)    # the suite's largest hand-written case


def matmul_checks() -> dict:
    gen = generator(SEED + 3, "cuda")
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        tol = MM_RMS_TOL[dtype]
        tiles = mm_kernel.TILES[dtype]
        for m, n, k in MM_CHECKS + MM_SUITE:
            a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
            first, plain = same_bits_from_every_tile(
                f"matmul {(m, n, k)} {dtype}", a, b)
            err = check_close(f"matmul {(m, n, k)} {dtype}", first, plain,
                              atol=tol * k ** 0.5, rtol=tol)
            check = {"case": [m, n, k], "dtype": str(dtype)[6:],
                     "max_abs_err": err, "tol": tol,
                     "tiles_bit_identical": [list(t) for t in tiles]}
            if dtype == torch.float32:
                # A second witness: the fp64 product of the same inputs,
                # which tells the kernel's error from cuBLAS's own.
                exact = torch.matmul(a.double(), b.double())
                check["max_abs_err_vs_fp64"] = check_close(
                    f"matmul {(m, n, k)} fp32 vs fp64", first, exact,
                    atol=tol * k ** 0.5, rtol=tol)
                check["plain_max_abs_err_vs_fp64"] = max_abs_err(
                    f"plain matmul {(m, n, k)}", plain, exact)
                del exact
            checks.append(check)
            phase("kernel", kernel="matmul", case=[m, n, k],
                  dtype=str(dtype)[6:], design=repr(DESIGN["matmul"][dtype]),
                  max_abs_err=f"{err:.3e}",
                  atol=f"{tol * k ** 0.5:.3e}", rtol=tol,
                  tiles_bit_identical=len(tiles),
                  **{key: f"{check[key]:.3e}" for key in
                     ("max_abs_err_vs_fp64", "plain_max_abs_err_vs_fp64")
                     if key in check})
            del a, b, first, plain
        m, n, k = MM_PLAIN
        a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
        before = mm_kernel.launches
        got = matmul(a, b)
        if mm_kernel.launches != before:
            raise AssertionError(f"matmul {MM_PLAIN}: the op launched the "
                                 f"kernel for a product with m < 8")
        check_close(f"matmul {MM_PLAIN} {dtype}", got, mm_ref.matmul(a, b),
                    atol=tol * k ** 0.5, rtol=tol)
        phase("kernel", kernel="matmul", case=list(MM_PLAIN),
              dtype=str(dtype)[6:], path="plain (min(m, n, k) < 8)")
    torch.cuda.empty_cache()

    m, n, k = MM_MAIN
    dtype = torch.float32
    a = torch.randn((m, k), generator=gen, device="cuda")
    b = torch.randn((k, n), generator=gen, device="cuda")
    err = check_close(f"matmul main {MM_MAIN}", mm_kernel.matmul_tiled(a, b),
                      mm_ref.matmul(a, b), atol=MM_RMS_TOL[dtype] * k ** 0.5,
                      rtol=MM_RMS_TOL[dtype])
    kernel_ms = cuda_ms(lambda: mm_kernel.matmul_tiled(a, b), reps=5,
                        warmup=1)
    plain_ms = cuda_ms(lambda: mm_ref.matmul(a, b), reps=5, warmup=1)
    # Yardstick only (the port's kernel never calls it): cuBLAS, TF32 off.
    library_ms = cuda_ms(lambda: torch.matmul(a, b), reps=5, warmup=1)
    flops = 2.0 * m * n * k
    # The kernel's floor is its three TF32 products on the tensor cores; the
    # fp32 CUDA-core bound (what an fp32 FMA kernel could reach) beside it.
    bnd, bound_by = bound_ms(flops, 4.0 * (m * k + k * n + m * n), "3xtf32")
    bnd_fp32, _ = bound_ms(flops, 4.0 * (m * k + k * n + m * n), dtype)
    design = DESIGN["matmul"][dtype]
    phase("kernel", kernel="matmul", case=list(MM_MAIN), dtype="float32",
          design=repr(design), default_tile=mm_kernel.hopper_tile(m, n),
          kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
          library_ms=f"{library_ms:.4f}", bound_ms=f"{bnd:.4f}",
          bound_by=bound_by, bound_fp32_cuda_cores_ms=f"{bnd_fp32:.4f}",
          tflops=f"{flops / kernel_ms / 1e9:.2f}")
    del a, b
    torch.cuda.empty_cache()

    # bf16 at the same shape: the kernel against cuBLAS's bf16 product.
    a = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    b = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
    err16 = check_close(f"matmul main {MM_MAIN} bf16",
                        mm_kernel.matmul_tiled(a, b), mm_ref.matmul(a, b),
                        atol=MM_RMS_TOL[torch.bfloat16] * k ** 0.5,
                        rtol=MM_RMS_TOL[torch.bfloat16])
    ms16 = cuda_ms(lambda: mm_kernel.matmul_tiled(a, b), reps=10, warmup=2)
    plain16 = cuda_ms(lambda: mm_ref.matmul(a, b), reps=3, warmup=1)
    lib16 = cuda_ms(lambda: torch.matmul(a, b), reps=10, warmup=2)
    bnd16, by16 = bound_ms(flops, 2.0 * (m * k + k * n + m * n),
                           torch.bfloat16)
    design16 = DESIGN["matmul"][torch.bfloat16]
    phase("kernel", kernel="matmul", case=list(MM_MAIN), dtype="bfloat16",
          design=repr(design16), max_abs_err=f"{err16:.3e}",
          kernel_ms=f"{ms16:.4f}", plain_ms=f"{plain16:.4f}",
          library_ms=f"{lib16:.4f}", bound_ms=f"{bnd16:.4f}", bound_by=by16,
          tflops=f"{flops / ms16 / 1e9:.2f}")
    del a, b
    torch.cuda.empty_cache()
    return {"name": "matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/matmul.cu",
            "replaces": "src/repro/kernels/matmul/kernel.py:46",
            "launches": None, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": bound_by,
            "library_ms": library_ms, "design": design,
            "shape": {"m": m, "n": n, "k": k, "dtype": "float32",
                      "tile": mm_kernel.hopper_tile(m, n)},
            "bf16": {"design": design16, "max_abs_err": err16, "ms": ms16,
                     "plain_ms": plain16, "library_ms": lib16,
                     "bound_ms": bnd16, "bound_by": by16},
            "checks": checks}


RMS_ROWS = (1, 100, 65536)
RMS_DIMS = (8, 64, 1024, 2560, 8192, 16384)   # every path of the kernel
RMS_LEAD = (4, 2048, 2560)      # ops flattens the leading dims
RMS_MAIN = (65536, 2560)        # the suite's rmsnorm_kernel case
# The kernel and ``rms_norm`` at RMS_MAIN are timed interleaved, this many
# timings of 20 calls each, and compared by their medians.
RMS_TIMINGS = 5


def rmsnorm_checks() -> dict:
    gen = generator(SEED + 4, "cuda")
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        tol = MM_RMS_TOL[dtype]
        shapes = [(r, d) for r in RMS_ROWS for d in RMS_DIMS] + [RMS_LEAD]
        for shape in shapes:
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = torch.randn(shape[-1], generator=gen, device="cuda").to(dtype)
            before = rms_kernel.launches
            got = rmsnorm(x, w)
            torch.cuda.synchronize()
            if rms_kernel.launches != before + 1:
                raise AssertionError(f"rmsnorm {shape}: the op did not "
                                     f"launch the kernel")
            err = check_close(f"rmsnorm {shape} {dtype}", got,
                              rms_ref.rmsnorm(x, w), atol=tol, rtol=tol)
            checks.append({"case": list(shape), "dtype": str(dtype)[6:],
                           "max_abs_err": err, "tol": tol})
            phase("kernel", kernel="rmsnorm", case=list(shape),
                  dtype=str(dtype)[6:], max_abs_err=f"{err:.3e}", tol=tol)
            del x, w, got
    torch.cuda.empty_cache()

    r, d = RMS_MAIN
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((r, d), generator=gen, device="cuda").to(dtype)
        w = torch.randn(d, generator=gen, device="cuda").to(dtype)
        err = check_close(f"rmsnorm main {RMS_MAIN} {dtype}",
                          rms_kernel.rmsnorm_2d(x, w), rms_ref.rmsnorm(x, w),
                          atol=MM_RMS_TOL[dtype], rtol=MM_RMS_TOL[dtype])
        kern, lib = [], []
        for _ in range(RMS_TIMINGS):
            kern.append(cuda_ms(lambda: rms_kernel.rmsnorm_2d(x, w),
                                reps=20, warmup=2))
            # Yardstick only (the port never calls it).
            lib.append(cuda_ms(lambda: torch.nn.functional.rms_norm(
                x, (d,), w, 1e-6), reps=20, warmup=2))
        kernel_ms, library_ms = statistics.median(kern), \
            statistics.median(lib)
        plain_ms = cuda_ms(lambda: rms_ref.rmsnorm(x, w), reps=5, warmup=1)
        size = x.element_size()
        bnd, bound_by = bound_ms(4.0 * r * d, size * (2.0 * r * d + d),
                                 torch.float32)
        phase("kernel", kernel="rmsnorm", case=list(RMS_MAIN),
              dtype=str(dtype)[6:], max_abs_err=f"{err:.3e}",
              kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              library_ms=f"{library_ms:.4f}", bound_ms=f"{bnd:.4f}",
              bound_by=bound_by,
              gb_per_s=f"{size * 2.0 * r * d / kernel_ms / 1e6:.1f}",
              kernel_timings_ms=[round(t, 4) for t in kern],
              library_timings_ms=[round(t, 4) for t in lib],
              loses_to_library=kernel_ms > library_ms)
        timed[dtype] = (err, kernel_ms, plain_ms, library_ms, bnd, bound_by)
        del x, w
    torch.cuda.empty_cache()
    err, kernel_ms, plain_ms, library_ms, bnd, bound_by = timed[torch.float32]
    err16, ms16, plain16, lib16, bnd16, _ = timed[torch.bfloat16]
    return {"name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm/kernel.py:31",
            "launches": None, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": {"rows": r, "d": d, "dtype": "float32"},
            "bf16": {"max_abs_err": err16, "ms": ms16, "plain_ms": plain16,
                     "library_ms": lib16, "bound_ms": bnd16},
            "checks": checks}


# ------------------------------------------------------ phase: the loop

# calibrate_device runs per loop phase: two alone, then validate_device's
# own, so each parameter's spread between runs on one card is printed
# beside the ladder (the package takes one calibration, as the reference).
CALIBRATIONS = 3
# The vector chain counts as FLOP-bound above this share of the fp32 peak.
# At 128 flops a byte a bandwidth-bound run could pass the fp32 peak, so
# HBM's rate bounds nothing; a chain that fell back to the memory system
# (the reference's 4 FMAs: 1 flop a byte, ~3e12) or lost its fusion lands
# far under the floor.  Sound runs on the H100 read 81-86% of the peak.
VECTOR_FLOOR_SHARE = 0.5


def measured_params(hw) -> dict:
    return {"fp32_matrix_flops": hw.sustained_flops("fp32", matrix=True),
            "fp32_vector_flops": hw.sustained_flops("fp32", matrix=False),
            "hbm_bytes_per_s": hw.hbm_sustained_bw,
            "launch_latency_s": hw.launch_latency_s}


def check_physical(hw) -> None:
    """Full-fp32 products cannot beat the CUDA cores' peak (a TF32 product
    would); no stream beats HBM's rate; the vector chain is FLOP-bound: its
    rate is above ``VECTOR_FLOOR_SHARE`` of the fp32 peak, and below the
    peak (above it, the compiler removed work)."""
    p = measured_params(hw)
    for key, value in p.items():
        if not (value > 0 and value < float("inf")):
            raise AssertionError(f"measured {key} = {value}")
    if p["fp32_matrix_flops"] > PEAK_FLOPS[torch.float32]:
        raise AssertionError("fp32 GEMM faster than the fp32 peak: TF32 on?")
    if p["hbm_bytes_per_s"] > HBM_BYTES_PER_S:
        raise AssertionError("stream bandwidth above HBM's rate")
    floor = VECTOR_FLOOR_SHARE * PEAK_FLOPS[torch.float32]
    if not p["fp32_vector_flops"] > floor:
        raise AssertionError(f"vector rate {p['fp32_vector_flops']:.4g} not "
                             f"above {floor:.4g} ({VECTOR_FLOOR_SHARE} of "
                             f"the fp32 peak): the chain is not FLOP-bound")
    if p["fp32_vector_flops"] > PEAK_FLOPS[torch.float32]:
        raise AssertionError("vector chain faster than the fp32 peak: the "
                             "compiled chain lost work")


def loop(entries: dict):
    """The paper's loop at the card's sizes, through the entry point a user
    calls, after ``CALIBRATIONS - 1`` calibrations alone.  Records the
    matmul and rmsnorm launch counts of this run in their entries; returns
    the measured parameters the ladder used and the measured suite it
    validated."""
    sz = microbench.CARD
    runs = 1 + sz.warmups + sz.repeats      # a first call, then the timed
    want = {"flash_attention": 0, "ssd": 0,
            "matmul": len(sz.gemm_kernels) * runs, "rmsnorm": runs}
    t0 = time.perf_counter()
    reset_launches()
    calibrated, calib_secs = [], []
    for _ in range(CALIBRATIONS - 1):
        c0 = time.perf_counter()
        calibrated.append(microbench.calibrate_device(quick=False))
        torch.cuda.synchronize()
        calib_secs.append(time.perf_counter() - c0)
    v0 = time.perf_counter()
    hw, lad = validate_device(quick=False)
    torch.cuda.synchronize()
    launches = read_launches()
    secs = time.perf_counter() - t0
    validate_secs = time.perf_counter() - v0
    check_launches("the loop", launches, want)
    for name in ("matmul", "rmsnorm"):
        entries[name]["launches"] = launches[name]
    calibrated.append(hw)
    for run in calibrated:
        check_physical(run)

    sheet = measured_params(hardware.get("h100"))
    for key, measured in measured_params(hw).items():
        phase("loop", parameter=key, measured=f"{measured:.6g}",
              datasheet_h100=f"{sheet[key]:.6g}",
              ratio=f"{measured / sheet[key]:.4f}")
    for key in sheet:
        vals = sorted(measured_params(run)[key] for run in calibrated)
        med = vals[len(vals) // 2]
        phase("loop", spread=key, runs=len(vals), median=f"{med:.6g}",
              min=f"{vals[0]:.6g}", max=f"{vals[-1]:.6g}",
              range_pct=f"{(vals[-1] - vals[0]) / med * 100:.2f}",
              values=[f"{measured_params(run)[key]:.6g}"
                      for run in calibrated])
    fpb = microbench.vector_chain_flops(1, sz.calib_vector_fmas) / 8.0
    vec = measured_params(hw)["fp32_vector_flops"]
    bw = measured_params(hw)["hbm_bytes_per_s"]
    phase("loop", vector_chain_fmas=sz.calib_vector_fmas,
          flops_per_byte=fpb, rate=f"{vec:.6g}",
          bandwidth_ceiling=f"{fpb * bw:.6g}",
          floor=f"{VECTOR_FLOOR_SHARE * PEAK_FLOPS[torch.float32]:.6g}",
          fp32_peak=f"{PEAK_FLOPS[torch.float32]:.6g}",
          share_of_peak=f"{vec / PEAK_FLOPS[torch.float32]:.4f}",
          calibrate_seconds=[round(t, 1) for t in calib_secs],
          validate_device_seconds=f"{validate_secs:.1f}")

    if len(lad.suite) != 12:
        raise AssertionError(f"suite has {len(lad.suite)} cases, want 12")
    for row in lad.rows():
        for key in ("measured_us", "model_us"):
            if not (row[key] > 0 and row[key] < float("inf")):
                raise AssertionError(f"loop row {row}")
        phase("loop", **{k: row[k] for k in (
            "kernel", "class", "measured_us", "model_us", "model_err_pct",
            "roofline_err_pct", "base_model_err_pct")})
    maes = lad.maes()
    for rung, pair in maes.items():
        phase("loop", mae=rung, model_pct=f"{pair['model']:.3f}",
              roofline_pct=f"{pair['roofline']:.3f}")
    if maes["per_case"]["model"] > 1e-6:
        raise AssertionError(f"per-case calibration leaves "
                             f"{maes['per_case']['model']}% MAE")
    phase("loop", launches=launches, seconds=f"{secs:.1f}",
          derived=repr(lad.derived()))
    torch.cuda.empty_cache()
    return hw, lad.suite


# ------------------------------------------------------ phase: tile selection

# The paper's adaptive tile selection (§IV-B) on the card: the loop's
# gemm_kernel sizes, and h2o-danube-1.8b's prefill projections at S = 8192
# (q/o (2560, 2560), MLP up (2560, 6912), down (6912, 2560); the model runs
# them through torch.matmul, as the reference through einsum: here they are
# only shapes to pick tiles for).
TILE_SHAPES = [((4096, 4096, 4096), torch.float32),
               ((8192, 8192, 8192), torch.float32),
               ((8192, 8192, 8192), torch.bfloat16),
               ((PREFILL_LEN, 2560, 2560), torch.bfloat16),
               ((PREFILL_LEN, 6912, 2560), torch.bfloat16),
               ((PREFILL_LEN, 2560, 6912), torch.bfloat16)]
TILE_REPS, TILE_WARMUP = 5, 1


def ranks(xs) -> list:
    """Ranks from 1, ties given their mean rank."""
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    out = [0.0] * len(xs)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and xs[order[j + 1]] == xs[order[i]]:
            j += 1
        for idx in order[i:j + 1]:
            out[idx] = (i + j) / 2.0 + 1.0
        i = j + 1
    return out


def rank_correlation(xs, ys) -> float:
    """Spearman's rho: Pearson's correlation of the ranks."""
    rx, ry = ranks(xs), ranks(ys)
    mx, my = sum(rx) / len(rx), sum(ry) / len(ry)
    cov = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    var = (sum((a - mx) ** 2 for a in rx) * sum((b - my) ** 2 for b in ry))
    return cov / var ** 0.5 if var > 0 else float("nan")


def tile_selection(measured_hw, entries: dict) -> dict:
    """For each shape, the model's price of every instantiated tile
    (``select_blocks``: fp32 on the measured parameters, bf16 on the
    datasheet file, which ``calibrate_device`` does not measure) beside the
    tile's time (CUDA events, mean of ``TILE_REPS`` after a warm-up); every
    tile checked against the plain version and bit for bit against the
    others.  Regret: the measured time of the model's pick over the best
    measured time, minus 1.  Nothing is gated on it.  Returns each shape's
    inputs and output (every tile's bits), keyed by (shape, dtype), for
    the served picks to be held to."""
    gen = generator(SEED + 5, "cuda")
    sheet = hardware.get("h100")
    want = sum(len(mm_kernel.TILES[dtype]) * (1 + TILE_WARMUP + TILE_REPS)
               for _, dtype in TILE_SHAPES)
    reset_launches()
    summary, runs = [], {}
    for (m, n, k), dtype in TILE_SHAPES:
        precision = {torch.float32: "fp32", torch.bfloat16: "bf16"}[dtype]
        hw = measured_hw if dtype == torch.float32 else sheet
        pick, costs = mm_ops.select_blocks(m, n, k, precision=precision,
                                           hw=hw)
        a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
        what = f"tiles {(m, n, k)} {precision}"
        out, plain = same_bits_from_every_tile(what, a, b)
        tol = MM_RMS_TOL[dtype]
        err = check_close(what, out, plain, atol=tol * k ** 0.5, rtol=tol)
        runs[((m, n, k), dtype)] = (a, b, out, plain)
        blocks = list(costs)
        ms = [cuda_ms(lambda bm=bm, bn=bn: mm_kernel.matmul_tiled(
                  a, b, bm=bm, bn=bn), reps=TILE_REPS, warmup=TILE_WARMUP)
              for bm, bn, _ in blocks]
        model_us = [costs[c] * 1e6 for c in blocks]
        for c, mod, meas in zip(blocks, model_us, ms):
            phase("tiles", shape=[m, n, k], dtype=precision,
                  tile=f"{c[0]}x{c[1]}x{c[2]}", model_us=f"{mod:.1f}",
                  measured_us=f"{meas * 1e3:.1f}")
        best = blocks[min(range(len(ms)), key=ms.__getitem__)]
        regret = ms[blocks.index(pick)] / min(ms) - 1.0
        rho = rank_correlation(model_us, ms)
        phase("tiles", shape=[m, n, k], dtype=precision, params=hw.name,
              model_pick=f"{pick[0]}x{pick[1]}", measured_best=f"{best[0]}x"
              f"{best[1]}", regret=f"{regret:.4f}", rank_corr=f"{rho:.3f}",
              max_abs_err=f"{err:.3e}", tiles_bit_identical=len(blocks))
        # The kernels line carries measured times only; the model's prices
        # and what follows from them stay on the [tiles] lines.
        summary.append({"shape": [m, n, k], "dtype": precision,
                        "measured_ms": dict(zip([f"{c[0]}x{c[1]}"
                                                 for c in blocks], ms)),
                        "measured_best": list(best[:2])})
        del a, b, out, plain
    launches = read_launches()
    check_launches("tile selection", launches,
                   {"flash_attention": 0, "ssd": 0, "matmul": want,
                    "rmsnorm": 0})
    phase("tiles", launches=launches)
    entries["matmul"]["tile_selection"] = summary
    return runs


# ------------------------------------------------ phase: the prediction server

# Every client call of the phase has this deadline: a wedged server fails
# the run instead of hanging it.
SERVE_DEADLINE_S = 120.0
# The server's start to its banner, measured by this phase on an H100 80GB
# HBM3 at 700 W when importing the server still loaded torch (through the
# eager ``core.microbench``); printed beside this run's.
SERVER_START_TORCH_S = 13.988
SERVE_SMALL_REQUESTS = 200      # argmin requests timed over each transport
# ~100k rows: a (flops, bytes) grid over a bf16 GEMM, priced by the server
# as a streamed lattice plan.
SERVE_GRID = 320


def compute_app_pids() -> set:
    """Processes holding a CUDA context on the card, as nvidia-smi lists
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return {int(w) for w in out.split() if w.isdigit()}


def session_pids(sid: int) -> list:
    """Every live process of session ``sid``: the server and the workers
    its pool starts (the server is the leader of its own session)."""
    pids = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text()
        except OSError:
            continue
        # fields after the parenthesised command: state ppid pgrp session
        if int(stat.rsplit(")", 1)[1].split()[3]) == sid:
            pids.append(int(d.name))
    return sorted(pids)


def nvidia_fds(pid: int) -> int:
    """How many of the process's open files are the card's device files
    (/dev/nvidia*).  A process with a CUDA context holds them open; one
    that has only imported torch (which maps the driver library) holds
    none."""
    n = 0
    for fd in Path(f"/proc/{pid}/fd").iterdir():
        try:
            n += os.readlink(fd).startswith("/dev/nvidia")
        except OSError:
            continue
    return n


def maps_libcuda(pid: int):
    """Whether the process has the CUDA driver library mapped (None when
    its maps cannot be read)."""
    try:
        return "libcuda.so" in Path(f"/proc/{pid}/maps").read_text()
    except OSError:
        return None


def quantile_ms(secs: list, q: float) -> float:
    xs = sorted(secs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] * 1e3


def predict_serve(measured_hw, suite, tile_runs: dict, entries: dict) -> None:
    """The paper's serving surface on the card's own numbers: a server
    subprocess of the port is given the measured parameters and the
    measured suite, fits the class calibration, and answers which matmul
    tile to run at each of the tiles phase's shapes over HTTP and the
    binary transport; each served pick is launched through the
    hand-written kernel.  The server prices with numpy and must hold no
    CUDA context.  Host-clock latencies are printed, not gated."""
    from repro_torch.core import calibrate, sweep
    from repro_torch.core.workload import (LatticeSpec, TileConfig,
                                           WorkloadTable, gemm_workload)
    from repro_torch.serve import subproc
    from repro_torch.serve.client import PredictionClient

    dl = {"deadline_s": SERVE_DEADLINE_S}
    sheet = hardware.get("h100")
    t_phase = time.perf_counter()
    reset_launches()
    t0 = time.perf_counter()
    proc, host, port, bport = subproc.start_server_subprocess(
        ["--jobs", "2"], binary=True)
    start_s = time.perf_counter() - t0
    clients = []
    try:
        http = PredictionClient(host, port, transport="http")
        binary = PredictionClient(host, port, transport="binary",
                                  binary_port=bport)
        clients = [http, binary]
        health = http.health(**dl)
        # Importing the server loads no torch, so none of its processes
        # maps the driver library yet.  (Decoding a measured suite, at the
        # calibration request below, imports ``core.microbench`` and so
        # torch, as the reference's server imports jax there.)
        libcuda = {p: maps_libcuda(p) for p in session_pids(proc.pid)}
        phase("predict_serve", server_pid=proc.pid, http=f"{host}:{port}",
              binary=f"{host}:{bport}", start_to_banner_s=f"{start_s:.3f}",
              start_to_banner_s_when_it_imported_torch=SERVER_START_TORCH_S,
              jobs=2, status=health["status"], libcuda_mapped=libcuda)
        if any(libcuda.values()):
            raise AssertionError(f"the started server maps the CUDA driver "
                                 f"library (torch loaded): {libcuda}")

        # 1. the measured parameters, registered and read back
        http.hardware_register(measured_hw, overwrite=True, **dl)
        back = http.hardware_get(measured_hw.name, **dl)
        if back.params != measured_hw:
            raise AssertionError(f"{measured_hw.name} read back from the "
                                 f"server differs from what was registered")
        phase("predict_serve", registered=measured_hw.name,
              read_back_equal=True)

        # 2. the class calibration, fitted on the server and in process
        cal, report = http.calibrate(suite, measured_hw.name, mode="class",
                                     seed=0, register_as="h100-card", **dl)
        engine = sweep.SweepEngine()
        local_cal, local_report = calibrate.fit_with_holdout(
            suite.workloads, suite.measured_s,
            lambda w: engine.predict(w, measured_hw), mode="class", seed=0)
        if cal.to_dict() != local_cal.to_dict() or report != local_report:
            raise AssertionError(
                f"served calibration {cal.to_dict()} {report} differs from "
                f"the in-process fit {local_cal.to_dict()} {local_report}")
        phase("predict_serve", calibration="class", cases=len(suite),
              multipliers=cal.to_dict().get("per_class"),
              holdout_mae=f"{report['holdout_mae']:.3f}",
              equal_to_in_process=True)

        # 3. the served tile at each shape, launched through the kernel
        picks = []
        for (m, n, k), dtype in TILE_SHAPES:
            precision = {torch.float32: "fp32",
                         torch.bfloat16: "bf16"}[dtype]
            hw = measured_hw if dtype == torch.float32 else sheet
            blocks = mm_ops.kernel_blocks(precision)
            table = WorkloadTable.tile_lattice(
                gemm_workload(f"matmul_{m}x{n}x{k}", m, n, k,
                              precision=precision),
                [TileConfig(*blk) for blk in blocks])
            pick, costs = mm_ops.select_blocks(m, n, k, precision=precision,
                                               hw=hw)
            for client in clients:
                win = client.argmin(table, hw.name, **dl)
                if blocks[win.index] != pick or win.total != costs[pick]:
                    raise AssertionError(
                        f"served argmin at {(m, n, k)} {precision} over "
                        f"{client.transport}: {blocks[win.index]} "
                        f"{win.total!r}, select_blocks: {pick} "
                        f"{costs[pick]!r}")
            a, b, tiles_out, plain = tile_runs[((m, n, k), dtype)]
            got = mm_kernel.matmul_tiled(a, b, bm=pick[0], bn=pick[1])
            torch.cuda.synchronize()
            tol = MM_RMS_TOL[dtype]
            what = f"served pick {(m, n, k)} {precision}"
            err = check_close(what, got, plain, atol=tol * k ** 0.5,
                              rtol=tol)
            if not torch.equal(bits(got), bits(tiles_out)):
                raise AssertionError(f"{what}: bits differ from the tiles "
                                     f"phase's output")
            del got
            phase("predict_serve", shape=[m, n, k], dtype=precision,
                  params=hw.name, served=f"{pick[0]}x{pick[1]}x{pick[2]}",
                  transports="http+binary", equal_to_select_blocks=True,
                  max_abs_err=f"{err:.3e}", same_bits_as_tiles=True)
            picks.append({"shape": [m, n, k], "dtype": precision,
                          "params": hw.name, "tile": list(pick[:2]),
                          "max_abs_err": err, "same_bits_as_tiles": True})

        # 4. host-clock latencies (not gated)
        small = WorkloadTable.concat([
            WorkloadTable.tile_lattice(
                gemm_workload(f"matmul_{m}x{n}x{k}", m, n, k,
                              precision=precision),
                [TileConfig(*blk) for blk in mm_ops.kernel_blocks(precision)])
            for (m, n, k), precision in (((4096, 4096, 4096), "fp32"),
                                         ((8192, 8192, 8192), "bf16"))])
        for client in clients:
            secs = []
            for _ in range(SERVE_SMALL_REQUESTS):
                c0 = time.perf_counter()
                client.argmin(small, "h100", **dl)
                secs.append(time.perf_counter() - c0)
            phase("predict_serve", latency="argmin", rows=len(small),
                  transport=client.transport, requests=len(secs),
                  median_ms=f"{quantile_ms(secs, 0.5):.4f}",
                  p99_ms=f"{quantile_ms(secs, 0.99):.4f}")
        # The server streams a lattice plan through its worker pool (two
        # forkserver workers, started at the first such request); each run
        # prices another grid, so no cache answers it.
        for run in range(3):
            grid = np.geomspace(1e6, 1e14, SERVE_GRID) * (1.0 + run / 8)
            spec = LatticeSpec.cartesian(
                gemm_workload("lattice", 8192, 8192, 8192, precision="bf16"),
                flops=grid, bytes=grid)
            want = sweep.predict_table(spec.materialize(), sheet).totals
            label = "first (pool start)" if run == 0 else f"run {run + 1}"
            c0 = time.perf_counter()
            totals = http.predict_totals(spec, "h100", jobs=2, **dl)
            secs = time.perf_counter() - c0
            if not np.array_equal(totals, want):
                raise AssertionError(f"served totals of the {len(spec)}-row "
                                     f"lattice ({label}) differ from the "
                                     f"in-process sweep")
            phase("predict_serve", latency="predict_totals", rows=len(spec),
                  run=repr(label), ms=f"{secs * 1e3:.3f}",
                  equal_to_in_process=True)

        # 5. the server, and the pool it started, hold no CUDA context.
        # nvidia-smi may list the card's processes by pids of another pid
        # namespace (in a container it can list only pid 1 while this
        # process holds a context), so the device files each process holds
        # open are the witness that decides; this process, which holds a
        # context, shows that the witness sees one.
        pids = session_pids(proc.pid)
        apps = compute_app_pids()
        fds = {p: nvidia_fds(p) for p in pids}
        own_fds = nvidia_fds(os.getpid())
        phase("predict_serve", server_session_pids=pids,
              nvidia_smi_compute_pids=sorted(apps),
              this_process_listed=os.getpid() in apps,
              device_files_open=fds, this_process_device_files=own_fds,
              libcuda_mapped={p: maps_libcuda(p) for p in pids})
        if proc.pid not in pids or [p for p in pids if p in apps]:
            raise AssertionError(f"server processes {pids} listed among "
                                 f"nvidia-smi's compute apps {apps}")
        if own_fds == 0:
            raise AssertionError("this process holds a CUDA context, yet no "
                                 "/dev/nvidia* file is open in it: the "
                                 "witness cannot see a context")
        if any(fds.values()):
            raise AssertionError(f"server processes hold the card's device "
                                 f"files open (a CUDA context): {fds}")
    finally:
        for client in clients:
            client.close()
        subproc.stop_server_subprocess(proc)
    launches = read_launches()
    check_launches("the served picks", launches,
                   {"flash_attention": 0, "ssd": 0,
                    "matmul": len(TILE_SHAPES), "rmsnorm": 0})
    phase("predict_serve", launches=launches,
          seconds=f"{time.perf_counter() - t_phase:.1f}")
    entries["matmul"]["served_picks"] = picks


# ----------------------------------------------------------------- phase 4

def moe_layers(cfg) -> int:
    """MoE layers one pass of ``cfg``'s model runs through."""
    return cfg.n_groups * cfg.pattern.count("moe")


@contextlib.contextmanager
def recorded_routes(cfg, runs: int = 1):
    """Inside the block every ``moe_apply`` call also records
    ``moe.route`` of its input (the helper it routes with): one Route per
    MoE layer, in the order the layers run.  The block must run ``runs``
    passes of ``cfg``'s model (a sequential prefill: one a token): fails
    unless it recorded one route per MoE layer a pass, so a model that
    stops calling ``moe_apply`` through the module fails here rather than
    printing no routes.  Read untimed runs only."""
    routes = []
    real = moe_mod.moe_apply

    def recording(p, x, cfg):
        routes.append(moe_mod.route(p, x.reshape(-1, x.shape[-1]), cfg))
        return real(p, x, cfg)
    moe_mod.moe_apply = recording
    try:
        yield routes
    finally:
        moe_mod.moe_apply = real
    if len(routes) != runs * moe_layers(cfg):
        raise AssertionError(f"{cfg.name}: {len(routes)} routes recorded, "
                             f"want {runs} x {moe_layers(cfg)} MoE layers")


def dropped(routes) -> list:
    """Assignments dropped (rank >= cap) in each MoE layer."""
    return [int((~r.keep).sum()) for r in routes]


def flipped(routes_a, routes_b) -> list:
    """Per MoE layer of two runs on the same tokens: (assignments sent to
    another expert, assignments kept in one run only)."""
    return [(int((a.experts != b.experts).sum()),
             int((a.keep != b.keep).sum()))
            for a, b in zip(routes_a, routes_b)]


def depth(cfg) -> str:
    full = get_config(cfg.name)
    cut = f"{cfg.n_layers} of {full.n_layers} layers"
    if full.first_dense:
        cut += f", first_dense {cfg.first_dense} of {full.first_dense}"
    if full.enc_layers:
        cut += f", encoder {cfg.enc_layers} of {full.enc_layers}"
    return cut


def moe_fields(cfg, tokens: int) -> dict:
    if not cfg.n_experts:
        return {}
    return {"assignments_per_layer": tokens * cfg.top_k,
            "cap": moe_mod.capacity(cfg, tokens)}


def record_launches(entries: dict, path: str, launches: dict) -> None:
    """Each kernel's count in one main path's counted run: kept by path,
    and their sum as the entry's launches."""
    for name, n in launches.items():
        if n:
            by_path = entries[name].setdefault("launches_by_path", {})
            by_path[path] = n
            entries[name]["launches"] = sum(by_path.values())


def live_xgates(model) -> dict:
    """Set every cross-attention gate of ``model`` to XGATE; the fields its
    phase lines print (none for a model without one)."""
    gates = [m.xgate for m in model.modules() if isinstance(m, CrossAttnBlock)]
    with torch.no_grad():
        for g in gates:
            g.fill_(XGATE)
    return {"xgate": XGATE, "xgates_set": len(gates)} if gates else {}


def memory_for(cfg, batch: int, seq: int):
    """The stub frontend's fp32 memory embeddings (B, memory_len, d) for a
    prompt of ``seq`` tokens, from an explicit generator on the card; None
    for a text-only model."""
    mlen = memory_len(cfg, seq)
    if mlen is None:
        return None
    return torch.randn((batch, mlen, cfg.d_model),
                       generator=generator(SEED + 2, "cuda"), device="cuda")


def param_bytes(cfg) -> int:
    """The parameters' bytes, counted on the meta device."""
    return sum(p.numel() * p.element_size()
               for p in build(cfg, "meta").parameters())


def plain(cfg, seq: int):
    """The plain path a kernel path over ``seq`` positions is held to: no
    kernel, and no attention softcap where the kernel path drops it (on the
    128 grid), as the reference's does."""
    cap = cfg.attn_logit_softcap if not flash_takes_length(cfg, seq) else 0.0
    return cfg.replace(use_flash_kernel=False, attn_logit_softcap=cap)


def prefill_requests(arch: str, entries: dict, seq: int = 0) -> None:
    """The main path of ``arch``: fp32 kernel path against the plain path,
    then the bf16 request counted and timed, at PREFILL's depth cuts and
    length (``seq`` tokens instead, when given).  Records each kernel's
    launch count of the counted run in its entry; for the MoE models,
    prints the routes that differ between the fp32 paths and the dropped
    assignments of the bf16 request; for a model with an attention softcap,
    the kernel path's distance from the plain path with the softcap on (not
    gated)."""
    length, served_cut, check_cut = PREFILL[arch]
    path = f"{arch} S={seq}" if seq else arch
    seq = seq or length
    cfg = get_config(arch).replace(use_flash_kernel=True, **served_cut)
    tokens = torch.randint(0, cfg.vocab, (1, seq),
                           generator=generator(SEED + 1, "cuda"),
                           device="cuda")
    memory = memory_for(cfg, 1, seq)
    mlen = None if memory is None else memory.shape[1]
    want = expected_launches(cfg, seq, mlen)
    mem_fields = {} if memory is None else {"memory": mlen}

    # fp32: the kernel path against the plain path (attn_chunk=1024 ->
    # _sdpa_chunked; mamba2: ssd_chunked), tight tolerance.
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32", **check_cut)
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg32, "cuda").init(generator(SEED, "cuda"))
    gates = live_xgates(model)
    prefill = make_prefill(model)
    reset_launches()
    with recorded_routes(cfg32) as routes_k:
        logits_k = prefill(tokens, memory)
    torch.cuda.synchronize()
    launches32 = read_launches()
    check_launches(f"{path} fp32 prefill", launches32,
                   expected_launches(cfg32, seq, mlen))
    check_wgmma(f"{path} fp32 prefill", cfg32, launches32)
    model.cfg = plain(cfg32, seq)
    with recorded_routes(cfg32) as routes_p:
        logits_p = prefill(tokens, memory)
    what = f"{arch} fp32 prefill logits, kernel vs plain"
    err32 = max_abs_err(what, logits_k, logits_p)
    within = torch.allclose(logits_k, logits_p, atol=FP32_REQUEST_TOL,
                            rtol=FP32_REQUEST_TOL)
    logits_absmax = logits_p.abs().max().item()
    del logits_p
    extra = {}
    if cfg.n_experts:
        extra = {"route_flips_per_layer": flipped(routes_k, routes_p),
                 "dropped_per_layer": dropped(routes_p)}
    if cfg.attn_logit_softcap:
        model.cfg = cfg32.replace(use_flash_kernel=False)
        gap = max_abs_err(f"{arch} fp32 plain logits at softcap "
                          f"{cfg.attn_logit_softcap}", prefill(tokens, memory),
                          logits_k)
        extra["softcap_gap_not_gated"] = {cfg.attn_logit_softcap:
                                          f"{gap:.3e}"}
    phase("prefill", arch=arch, dtype="float32", tokens=seq, **mem_fields,
          depth=repr(depth(cfg32)), launches=launches32, **gates,
          max_abs_err=f"{err32:.3e}", tol=FP32_REQUEST_TOL,
          logits_absmax=f"{logits_absmax:.3f}",
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 2),
          **moe_fields(cfg32, seq), **extra)
    if not within:
        raise AssertionError(f"{what}: max abs err {err32:.3e} outside "
                             f"atol=rtol={FP32_REQUEST_TOL}")
    del model, prefill, logits_k, routes_k, routes_p
    torch.cuda.empty_cache()

    # bf16: the served dtype.  The counted run is the main path's run.
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, "cuda").init(generator(SEED, "cuda"))
    live_xgates(model)
    prefill = make_prefill(model)
    with recorded_routes(cfg) as routes:              # warm-up
        prefill(tokens, memory)
    drops = {"dropped_per_layer": dropped(routes)} if cfg.n_experts else {}
    del routes
    logits_k = None

    def request():
        nonlocal logits_k
        logits_k = prefill(tokens, memory)
    reset_launches()
    first_ms = host_ms(request)
    launches = read_launches()
    check_launches(f"{path} bf16 prefill", launches, want)
    wgmma = check_wgmma(f"{path} bf16 prefill", cfg, launches)
    record_launches(entries, path, launches)
    kernel_req_ms = sorted([first_ms] + [host_ms(request) for _ in range(2)])
    model.cfg = plain(cfg, seq)
    logits_p = None

    def plain_request():
        nonlocal logits_p
        logits_p = prefill(tokens, memory)
    plain_req_ms = sorted(host_ms(plain_request) for _ in range(3))
    what = f"{arch} bf16 prefill logits, kernel vs plain"
    if BF16_GATED[arch]:
        tol16 = BF16_REQUEST_TOL
        err16 = check_close(what, logits_k, logits_p, **tol16)
    else:
        held = torch.allclose(logits_k.float(), logits_p.float(),
                              **BF16_REQUEST_TOL)
        tol16 = f"not gated (see BF16_GATED); within {BF16_REQUEST_TOL}: " \
                f"{held}"
        err16 = max_abs_err(what, logits_k, logits_p)
    phase("prefill", arch=arch, dtype="bfloat16", tokens=seq, **mem_fields,
          depth=repr(depth(cfg)), launches=launches, wgmma_launches=wgmma,
          **gates,
          request_ms=[round(t, 3) for t in kernel_req_ms],
          plain_request_ms=[round(t, 3) for t in plain_req_ms],
          tok_per_s=f"{seq / kernel_req_ms[1] * 1e3:.1f}",
          max_abs_err=f"{err16:.3e}", tol=tol16,
          params_gb_reckoned=f"{param_bytes(cfg) / 1e9:.2f}",
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 2),
          **moe_fields(cfg, seq), **drops)
    del model, prefill, logits_k, logits_p
    torch.cuda.empty_cache()
    if arch == VISION and path == arch:
        vision_bf16_trace(tokens, memory)


# llama-3.2-vision's bf16 gap, kernel path against plain, traced before it
# is called rounding: one attn block alone, one cross_attn block alone, one
# group (four attn and a cross_attn block) and four groups, each with every
# xgate at 0 and at XGATE.  If the gap grew with the cross blocks or their
# gates, the cross block would be at fault.
VISION_TRACE = ((("attn",), 1), (("cross_attn",), 1), (None, 5), (None, 20))


def vision_bf16_trace(tokens, memory) -> None:
    """Printed, not gated; no launch count is read (the main path's run is
    the bf16 request above)."""
    base = get_config(VISION).replace(use_flash_kernel=True)
    for pattern, n in VISION_TRACE:
        cfg = base.replace(n_layers=n, **({"pattern": pattern}
                                          if pattern else {}))
        model = build(cfg, "cuda").init(generator(SEED, "cuda"))
        prefill = make_prefill(model)
        gates = [m.xgate for m in model.modules()
                 if isinstance(m, CrossAttnBlock)]
        gaps, absmax = {}, 0.0
        for gate in ((0.0, XGATE) if gates else (None,)):
            with torch.no_grad():
                for g in gates:
                    g.fill_(gate)
            model.cfg = cfg
            logits_k = prefill(tokens, memory)
            model.cfg = plain(cfg, tokens.shape[1])
            logits_p = prefill(tokens, memory)
            err = max_abs_err("vision trace", logits_k, logits_p)
            gaps[gate] = f"{err:.3e}"
            absmax = max(absmax, logits_p.float().abs().max().item())
            del logits_k, logits_p
        phase("prefill", arch=VISION, trace="bf16 kernel vs plain",
              pattern="+".join(cfg.pattern), depth=n,
              cross_blocks=len(gates), gap_by_xgate=gaps,
              logits_absmax=f"{absmax:.3f}")
        del model, prefill, gates
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 5

def prompt_route_flips(fast_routes, seq_routes, k: int) -> list:
    """Per MoE layer, the prompt's (token, choice) assignments that the
    forward over the whole prompt and the sequential prefill send to
    different experts.  The forward records one route a layer over (B, S)
    tokens; the sequential prefill one a layer a step, over B tokens."""
    n = len(fast_routes)
    flips = []
    for layer, fast in enumerate(fast_routes):
        steps = [r.experts.reshape(-1, k) for r in seq_routes[layer::n]]
        seq = torch.stack(steps, dim=1)                 # (B, S, k)
        flips.append(int((fast.experts.reshape(seq.shape) != seq).sum()))
    return flips


def cut_setup(arch: str):
    """``launch.serve.setup`` (weights from SEED; a prompt and, for the audio
    and vision families, fp32 memory embeddings from SEED + 1; all made on
    the card) on the served config cut to PREFILL's depth: the launcher
    takes the shipped configs only, as the reference's does."""
    cfg = get_config(arch).replace(**PREFILL[arch][1])
    model = build(cfg, "cuda").init(generator(SEED, "cuda"))
    gen = generator(SEED + 1, "cuda")
    prompt = torch.randint(0, cfg.vocab, (GEN_BATCH, GEN_PROMPT),
                           generator=gen, device="cuda")
    memory = None
    mlen = memory_len(cfg, GEN_PROMPT)
    if mlen is not None:
        memory = torch.randn((GEN_BATCH, max(mlen, 4), cfg.d_model),
                             generator=gen, device="cuda")
    return model, prompt, memory


def generation_request(arch: str) -> None:
    served_cut = PREFILL[arch][1]
    reset_launches()
    if served_cut:
        model, prompt, memory = cut_setup(arch)
        out = greedy_generate(model, prompt, max_new=GEN_NEW,
                              memory_embeds=memory)
    else:
        out = serve(arch, smoke=False, batch=GEN_BATCH,
                    prompt_len=GEN_PROMPT, max_new=GEN_NEW, seed=SEED,
                    device="cuda")
    torch.cuda.synchronize()
    gen_launches = read_launches()     # greedy decoding reaches no kernel
    check_launches(f"{arch} generation", gen_launches,
                   {name: 0 for name in KERNELS})
    vocab = get_config(arch).vocab
    if tuple(out.shape) != (GEN_BATCH, GEN_NEW) or out.dtype != torch.int32:
        raise AssertionError(f"tokens {tuple(out.shape)} {out.dtype}")
    if not bool(((out >= 0) & (out < vocab)).all()):
        raise AssertionError("token ids out of range")

    if not served_cut:
        model, prompt, memory = setup(arch, smoke=False, batch=GEN_BATCH,
                                      prompt_len=GEN_PROMPT, seed=SEED,
                                      device="cuda")
    served = model.cfg
    moe = {}
    if served.n_experts:
        tokens = GEN_BATCH * GEN_PROMPT
        with recorded_routes(served) as routes:
            make_prefill(model)(prompt)
        moe = {"served_cap": moe_mod.capacity(served, tokens),
               "served_dropped_per_layer": dropped(routes)}
        del routes
    check_dtype = PROMPT_CHECK_DTYPE[arch]
    if check_dtype == torch.float32 and served_cut:
        del model
        torch.cuda.empty_cache()
        checked = build(served.replace(
            dtype="float32", param_dtype="float32", **PREFILL[arch][2]),
            "cuda").init(generator(SEED, "cuda"))
        tol = {"atol": FP32_REQUEST_TOL, "rtol": FP32_REQUEST_TOL}
    elif check_dtype == torch.float32:
        checked = build(served.replace(dtype="float32",
                                       param_dtype="float32"), "cuda")
        checked.load_state_dict(model.state_dict())
        tol = {"atol": FP32_REQUEST_TOL, "rtol": FP32_REQUEST_TOL}
    else:
        checked, tol = model, BF16_REQUEST_TOL
    gates = live_xgates(checked)
    cfg = checked.cfg
    check_prompt, check_memory = prompt, memory
    if cfg.n_experts:
        check_prompt = prompt[:PROMPT_CHECK_ROWS[arch]]
        tokens = check_prompt.numel()
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
        if moe_mod.capacity(cfg, tokens) < tokens:
            raise AssertionError("the raised capacity still drops")
        moe.update(checked_depth=repr(depth(cfg)),
                   checked_prompt=tuple(check_prompt.shape),
                   checked_capacity_factor=cfg.capacity_factor,
                   checked_cap=moe_mod.capacity(cfg, tokens))
    # The kernel path drops the softcap, so it is held to the sequential
    # prefill at softcap 0; with a softcap, the plain path is held to it at
    # the config's value too.
    checks = [("kernel", True, 0.0)]
    if cfg.attn_logit_softcap:
        checks.append(("plain", False, cfg.attn_logit_softcap))
    for path, flash, cap in checks:
        checked.cfg = cfg.replace(use_flash_kernel=flash,
                                  attn_logit_softcap=cap)
        with recorded_routes(cfg) as fast_routes:
            last_fast = make_prefill(checked)(check_prompt, check_memory)
        checked.cfg = cfg.replace(attn_logit_softcap=cap)
        with recorded_routes(cfg, runs=check_prompt.shape[1]) as \
                seq_routes, torch.inference_mode():
            last_seq, _ = checked.prefill(
                check_prompt, checked.init_cache(*check_prompt.shape),
                memory_embeds=check_memory)
        if cfg.n_experts:
            moe["route_flips_per_layer"] = prompt_route_flips(
                fast_routes, seq_routes, cfg.top_k)
        del fast_routes, seq_routes
        what = (f"{arch} prompt logits, make_prefill ({path} path, softcap "
                f"{cap}) vs sequential prefill")
        err = max_abs_err(what, last_fast, last_seq)
        phase("generate", arch=arch, check=repr(what),
              prompt_logits_dtype=str(check_dtype)[6:], **gates,
              prompt_logits_err=f"{err:.3e}", tol=tol, **moe)
        check_close(what, last_fast, last_seq, **tol)
        del last_fast, last_seq
    del checked
    if served_cut and check_dtype == torch.float32:
        torch.cuda.empty_cache()
        model, prompt, memory = cut_setup(arch)
    else:
        model.cfg = served
    toks = None

    def generate():
        nonlocal toks
        toks = greedy_generate(model, prompt, max_new=GEN_NEW,
                               memory_embeds=memory)
    gen_ms = host_ms(generate)
    mem_fields = {} if memory is None else {"memory": memory.shape[1]}
    phase("generate", arch=arch, depth=repr(depth(served)), batch=GEN_BATCH,
          prompt=GEN_PROMPT, **mem_fields, new=GEN_NEW,
          kernel_launches=gen_launches, request_ms=f"{gen_ms:.1f}",
          tok_per_s=f"{GEN_BATCH * GEN_NEW / gen_ms * 1e3:.1f}",
          same_tokens_as_serve=bool(torch.equal(toks, out)))
    del model, prompt, memory
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 6

# Card against CPU, and one configuration against another on the card: the
# reference's own test_grad_accum_matches_full_batch tolerance
# (tests/test_substrate.py:213-215); resume against a straight run: its
# test_train_resume_from_checkpoint_exact tolerance (:263).
TRAIN_TOL = {"atol": 2e-5, "rtol": 2e-4}
RESUME_TOL = 1e-6
CHECK_BATCH, CHECK_SEQ, CHECK_STEPS, CHECK_LAYERS = 2, 256, 2, 2
CHECK_LR = 1e-3
# The full model: 16,384 tokens a step; S = 2048 > attn_chunk = 1024, so
# the chunked attention path runs.  lr 1e-3: at danube's init scale
# (|w| ~ 2560^-0.5 ~ 0.02) a bf16 weight drops updates under ~6e-5, which
# the default 3e-4's first warmup step (6e-5) would barely clear.
FULL_BATCH, FULL_SEQ, FULL_STEPS, FULL_LR = 8, 2048, 10, 1e-3


def _flat(tree, prefix=""):
    for key, val in sorted(tree.items()):
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


def trees_close(what: str, got: dict, want: dict, tol: dict) -> float:
    """Every leaf of two reference-layout trees of CPU tensors within
    ``tol``; returns the largest absolute difference."""
    got, want = dict(_flat(got)), dict(_flat(want))
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: leaves differ")
    return max(check_close(f"{what} {name}", got[name], want[name], **tol)
               for name in want)


def train_steps(tree, cfg, device, *, microbatches: int = 1) -> list:
    """CHECK_STEPS steps of ``make_train_step`` from the numpy params
    ``tree``: per step (loss, grad norm, params in the reference layout)."""
    model = params_from_jax(tree, cfg, device=device)
    state = init_state(model)
    step = make_train_step(model, lr=CHECK_LR, microbatches=microbatches)
    data = SyntheticLMData(cfg, batch=CHECK_BATCH, seq_len=CHECK_SEQ,
                           seed=SEED)
    out = []
    for i in range(CHECK_STEPS):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(i).items()}
        state, metrics = step(state, batch)
        out.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                    jax_layout(state["params"])))
    return out


def card_vs_cpu(tree, cfg) -> list:
    """CHECK_STEPS steps from the numpy params ``tree`` on the card against
    the same on the CPU: loss, grad norm and every parameter after each
    step at TRAIN_TOL.  Returns the card's steps."""
    cpu = train_steps(tree, cfg, "cpu")
    card = train_steps(tree, cfg, "cuda")
    for i, ((l_c, g_c, p_c), (l_g, g_g, p_g)) in enumerate(zip(cpu, card)):
        check_close(f"{cfg.name} card vs cpu loss", torch.tensor(l_g),
                    torch.tensor(l_c), **TRAIN_TOL)
        check_close(f"{cfg.name} card vs cpu grad norm", torch.tensor(g_g),
                    torch.tensor(g_c), **TRAIN_TOL)
        err = trees_close(f"{cfg.name} card vs cpu params", p_g, p_c,
                          TRAIN_TOL)
        phase("train", check="card_vs_cpu", config=cfg.name, step=i + 1,
              loss=f"{l_g:.6f}/{l_c:.6f}", grad_norm=f"{g_g:.6f}/{g_c:.6f}",
              params_max_abs_err=f"{err:.3e}", tol=TRAIN_TOL)
    return card


def train_checks() -> None:
    """(a) h2o-danube-1.8b at full width, CHECK_LAYERS layers, fp32: the
    card's steps against the CPU's from one numpy parameter tree, then
    microbatches 2 and remat block / full against the plain steps on the
    card; the MoE smoke configs (qwen3moe-smoke, dsv3-smoke: the dispatch,
    MLA, the dense prefix, the aux and MTP losses), rg-smoke (the RG-LRU),
    whisper-smoke (the encoder, cross-attention) and vlm-smoke
    (cross-attention to image embeddings), their gates at XGATE, card
    against CPU; and resume through ``launch.train.train`` (danube-smoke:
    the launcher takes the shipped configs only)."""
    t0 = time.perf_counter()
    cfg = get_config(DANUBE).replace(n_layers=CHECK_LAYERS, dtype="float32",
                                     param_dtype="float32", remat="none")
    tree = params_to_jax(build(cfg, "cpu").init(generator(SEED, "cpu")))
    card = card_vs_cpu(tree, cfg)
    variants = {"microbatches=2": (cfg, 2),
                "remat=block": (cfg.replace(remat="block"), 1),
                "remat=full": (cfg.replace(remat="full"), 1)}
    for name, (vcfg, micro) in variants.items():
        other = train_steps(tree, vcfg, "cuda", microbatches=micro)
        errs = []
        for (l_a, g_a, p_a), (l_b, g_b, p_b) in zip(other, card):
            check_close(f"{name} loss", torch.tensor(l_a), torch.tensor(l_b),
                        **TRAIN_TOL)
            check_close(f"{name} grad norm", torch.tensor(g_a),
                        torch.tensor(g_b), **TRAIN_TOL)
            errs.append(trees_close(f"{name} params", p_a, p_b, TRAIN_TOL))
        phase("train", check=f"{name}_vs_plain", steps=CHECK_STEPS,
              params_max_abs_err=f"{max(errs):.3e}", tol=TRAIN_TOL)
        del other
    del card, tree
    for arch in (QWEN3, DSV3, RG, WHISPER, VISION):
        smoke = get_config(arch, smoke=True)
        model = build(smoke, "cpu").init(generator(SEED, "cpu"))
        live_xgates(model)
        card_vs_cpu(params_to_jax(model), smoke)
    torch.cuda.empty_cache()

    ckpt_dir = ROOT / "build" / "train_resume"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    kw = dict(smoke=True, batch=4, seq=64, lr=CHECK_LR, log_every=0,
              seed=SEED, device="cuda")
    straight = train(DANUBE, steps=4, **kw)
    train(DANUBE, steps=2, ckpt_dir=str(ckpt_dir), **kw)
    resumed = train(DANUBE, steps=4, ckpt_dir=str(ckpt_dir), **kw)
    if resumed["losses"] != straight["losses"][2:]:
        raise AssertionError(f"resumed losses {resumed['losses']} vs "
                             f"{straight['losses'][2:]}")
    err = trees_close("resumed params",
                      jax_layout(resumed["state"]["params"]),
                      jax_layout(straight["state"]["params"]),
                      {"atol": RESUME_TOL, "rtol": 0.0})
    phase("train", check="resume", config="danube-smoke", steps="2+2 vs 4",
          checkpoints=sorted(p.name for p in ckpt_dir.iterdir()),
          params_max_abs_err=f"{err:.3e}", tol=RESUME_TOL,
          seconds=f"{time.perf_counter() - t0:.1f}")
    shutil.rmtree(ckpt_dir)


def model_flops_per_step(cfg, params: dict, tokens: int) -> float:
    """6 x (weights that multiply) x tokens, plus 12 x layers x heads x
    head dim x seq x tokens for attention's two products over all key
    positions (PaLM's convention: forward and backward, no recompute)."""
    weights = sum(p.numel() for name, p in params.items()
                  if p.dim() >= 2 and (name != "tok_embed"
                                       or cfg.tie_embeddings))
    attention = 12 * cfg.n_layers * cfg.n_heads * cfg.head_dim * FULL_SEQ
    return (6 * weights + attention) * tokens


def train_full() -> dict:
    """(b) h2o-danube-1.8b at full width and depth, the shipped config
    (bf16, remat "block", attn_chunk 1024): FULL_STEPS steps through
    ``launch.train.train`` with every launch count read around them.
    Returns the step as ``dryrun_vs_card`` reads it."""
    cfg = get_config(DANUBE)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = train(DANUBE, smoke=False, steps=FULL_STEPS, batch=FULL_BATCH,
                seq=FULL_SEQ, lr=FULL_LR, log_every=0, seed=SEED,
                device="cuda")
    launches = read_launches()
    check_launches("training", launches, {name: 0 for name in KERNELS})
    hist = out["history"]
    for i, h in enumerate(hist):
        phase("train", arch=DANUBE, step=i + 1, loss=f"{h['loss']:.6f}",
              grad_norm=f"{h['grad_norm']:.6f}", lr=f"{h['lr']:.3e}",
              ms=f"{h['ms']:.3f}")
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    if len(hist) != FULL_STEPS or not all(
            map(math.isfinite, losses + gnorms)):
        raise AssertionError(f"losses {losses}, grad norms {gnorms}")
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not last < first:
        raise AssertionError(f"loss did not fall: first three {first:.4f}, "
                             f"last three {last:.4f}")
    step_ms = statistics.median(h["ms"] for h in hist[1:])
    tokens = FULL_BATCH * FULL_SEQ
    flops = model_flops_per_step(cfg, out["state"]["params"], tokens)
    phase("train", arch=DANUBE, batch=FULL_BATCH, seq=FULL_SEQ,
          tokens_per_step=tokens, steps=FULL_STEPS,
          step_ms_median_2_to_10=f"{step_ms:.3f}",
          step_ms_range=f"{min(h['ms'] for h in hist[1:]):.3f}-"
                        f"{max(h['ms'] for h in hist[1:]):.3f}",
          first_step_ms=f"{hist[0]['ms']:.3f}",
          tokens_per_s=f"{tokens / step_ms * 1e3:.1f}",
          model_flops_per_step=f"{flops:.4e}",
          bf16_peak_share=f"{flops / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16]:.4f}",
          loss_first3=f"{first:.4f}", loss_last3=f"{last:.4f}",
          max_memory_allocated_gb=round(
              torch.cuda.max_memory_allocated() / 1e9, 2),
          max_memory_reserved_gb=round(
              torch.cuda.max_memory_reserved() / 1e9, 2),
          launches=launches)
    del out
    torch.cuda.empty_cache()
    return {"arch": DANUBE, "cfg": cfg, "batch": FULL_BATCH,
            "seq": FULL_SEQ, "moment_dtype": None,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "step_ms": step_ms, "flops_6nd": flops}


# ----------------------------------------------------------------- phase 7

# (a) int8-moment updates, the card against the CPU: three chained
# ``q8nd_adamw_update`` steps from one numpy parameter tree and one zero
# state, given the same numpy gradients.  Given the same state, the codes
# of a step may differ where the card's logf / expf and the CPU's differ by
# an ulp at a rounding boundary (or the global norms' sums, in another
# order, move the clip factor by an ulp): by 1, in at most Q8_CODE_SHARE of
# them.  So each step is also run on the card from the CPU's state, and
# held to that; run free, a code that parted carries its difference into
# the next steps (a free run's largest difference is printed).  One code
# step of v moves that element's update by a few percent of lr (a step of
# a block's log range of ~10-30 over 255 codes, halved by the square root):
# the params are held to a tenth of lr a step.
Q8_CHECK_STEPS, Q8_CHECK_LR = 3, 1e-3
Q8_CODE_SHARE = 1e-4
Q8_STEP_PARAMS_TOL = {"atol": 1e-4, "rtol": 0.0}
Q8_PARAMS_TOL = {"atol": 3e-4, "rtol": 0.0}
# (b) danube as the train phase's (b) runs it, with int8 moments; the record
# it is set beside: bf16 moments, measured by the train phase on an H100
# 80GB HBM3 at 700 W.
DANUBE_BF16_MOMENTS = {"step_ms_median_2_to_10": 2789.793,
                       "max_memory_allocated_gb": 46.6}
# (c) the other families at full width with int8 moments, batch 1, 3 steps
# at lr 1e-3 (the launcher's schedule); each model's depths, the first that
# fits is run: recurrentgemma-9b whole (its int8 state ~52 GB; bf16 moments
# would need ~69 GB before activations), qwen3-moe 3 of 94 layers (~53 GB),
# llama-3.2-vision 10 of 100 (two cross blocks, ~65 GB), whisper-tiny whole.
# whisper runs 1536 tokens against 1536 frames, as its prefill does.
Q8_STEPS, Q8_LR = 3, 1e-3
Q8_MODELS = {RG: (2048, ({}, {"n_layers": 19})),
             QWEN3: (2048, ({"n_layers": 3}, {"n_layers": 2})),
             VISION: (2048, ({"n_layers": 10}, {"n_layers": 5})),
             WHISPER: (1536, ({},))}


def code_diffs(got: dict, want: dict) -> dict:
    """Two int8-moment optimizer states in the reference layout: the codes,
    how many differ and by how much at most, and the scales' largest
    relative difference."""
    n = differ = most = 0
    scale_rel = 0.0
    got, want = dict(_flat(got)), dict(_flat(want))
    for name, w in want.items():
        g = got[name]
        if w.dtype == torch.int8:
            d = (g.int() - w.int()).abs()
            n, differ = n + d.numel(), differ + int((d > 0).sum())
            most = max(most, int(d.max()))
        elif w.dim():
            rel = ((g - w).abs() / w.abs().clamp(min=1e-30)).max().item()
            scale_rel = max(scale_rel, rel)
    return {"codes": n, "differing": differ, "max_diff": most,
            "scales_max_rel_diff": scale_rel}


def q8_card_vs_cpu(arch: str) -> None:
    smoke = get_config(arch, smoke=True)
    model = build(smoke, "cpu").init(generator(SEED, "cpu"))
    live_xgates(model)
    tree = params_to_jax(model)
    rng = np.random.default_rng(SEED + 3)
    grads = [{k: np.asarray(rng.standard_normal(p.shape) * 0.1, np.float32)
              for k, p in model.named_parameters()}
             for _ in range(Q8_CHECK_STEPS)]
    del model
    states = {name: init_state(params_from_jax(tree, smoke, device=dev),
                               moment_dtype="int8")
              for name, dev in (("cpu", "cpu"), ("card", "cuda"),
                                ("free", "cuda"))}
    for i, g in enumerate(grads):
        state_from_jax(state_to_jax(states["cpu"]), states["card"])
        for name, st in states.items():
            dev = st["opt"]["step"].device
            q8nd_adamw_update(
                st["params"],
                {k: torch.from_numpy(v).to(dev) for k, v in g.items()},
                st["opt"], lr=Q8_CHECK_LR)
        cpu, card = (state_to_jax(states[k]) for k in ("cpu", "card"))
        diffs = code_diffs(card["opt"], cpu["opt"])
        err = trees_close(f"{arch} q8 step {i + 1} card vs cpu params",
                          card["params"], cpu["params"], Q8_STEP_PARAMS_TOL)
        phase("train_q8", check="card_vs_cpu, each step from the cpu's "
              "state", config=smoke.name, step=i + 1, **diffs,
              share=f"{diffs['differing'] / diffs['codes']:.3e}",
              params_max_abs_err=f"{err:.3e}", tol=Q8_STEP_PARAMS_TOL,
              code_gate=f"share <= {Q8_CODE_SHARE}, diff <= 1")
        if diffs["max_diff"] > 1 \
                or diffs["differing"] > Q8_CODE_SHARE * diffs["codes"]:
            raise AssertionError(f"{smoke.name} step {i + 1}: {diffs}")
    free = state_to_jax(states["free"])
    diffs = code_diffs(free["opt"], cpu["opt"])
    err = trees_close(f"{arch} q8 free-running card vs cpu params",
                      free["params"], cpu["params"], Q8_PARAMS_TOL)
    phase("train_q8", check="card_vs_cpu, free-running", config=smoke.name,
          steps=Q8_CHECK_STEPS, **diffs,
          share=f"{diffs['differing'] / diffs['codes']:.3e}",
          params_max_abs_err=f"{err:.3e}", tol=Q8_PARAMS_TOL,
          code_gate=f"share <= {Q8_CODE_SHARE}")
    if diffs["differing"] > Q8_CODE_SHARE * diffs["codes"]:
        raise AssertionError(f"{smoke.name} free-running: {diffs}")


def state_bytes(model) -> int:
    """Params and grads in their dtypes, int8 moments at
    ``moment_bytes_per_param``: the state an int8-moment step holds before
    any activation."""
    return sum(p.numel() * (2 * p.element_size() + moment_bytes_per_param())
               for p in model.parameters())


def q8_train(arch: str, cfg, *, steps: int, batch: int, seq: int,
             lr: float) -> dict:
    """``steps`` int8-moment steps of ``cfg`` on the card, the launcher's
    loop (its schedule, data and seed) with ``init_state(moment_dtype=
    "int8")`` and ``make_train_step(q8_moments=True)``; every launch count
    read around them and held at 0.  Prints each step; returns the
    numbers."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    predicted = state_bytes(model)
    phase("train_q8", arch=arch, depth=repr(depth(cfg)), params=n_params,
          predicted_state_gb=f"{predicted / 1e9:.2f}")
    state = init_state(model, generator(SEED, "cuda"), moment_dtype="int8")
    held_gb = torch.cuda.memory_allocated() / 1e9
    step_fn = make_train_step(model, q8_moments=True, lr=for_arch(
        arch, lr, max(steps // 20, 5), steps))
    data = SyntheticLMData(cfg, batch=batch, seq_len=seq, seed=SEED)
    hist = []
    reset_launches()
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = {k: torch.from_numpy(v).to("cuda")
             for k, v in data.batch_at(i).items()}
        state, m = step_fn(state, b)
        torch.cuda.synchronize()
        hist.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "lr": float(m["lr"]),
                     "ms": (time.perf_counter() - t0) * 1e3})
        phase("train_q8", arch=arch, step=i + 1,
              loss=f"{hist[-1]['loss']:.6f}",
              grad_norm=f"{hist[-1]['grad_norm']:.6f}",
              lr=f"{hist[-1]['lr']:.3e}", ms=f"{hist[-1]['ms']:.3f}")
    launches = read_launches()
    check_launches(f"{arch} int8-moment training", launches,
                   {name: 0 for name in KERNELS})
    dtypes = {m["q"].dtype for m in state["opt"]["mu"].values()
              if "scale" in m}
    if dtypes != {torch.int8}:
        raise AssertionError(f"{arch}: moments are {dtypes}, not int8")
    values = [h["loss"] for h in hist] + [h["grad_norm"] for h in hist]
    if not all(map(math.isfinite, values)):
        raise AssertionError(f"{arch}: non-finite losses or grad norms "
                             f"{values}")
    out = {"params": n_params, "predicted_state_gb": predicted / 1e9,
           "state_held_gb": held_gb, "hist": hist,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches}
    del model, state, step_fn
    torch.cuda.empty_cache()
    return out


def train_q8() -> list:
    """(a) the int8-moment update, card against CPU, at danube-smoke and
    vlm-smoke; (b) danube at full width and depth as the train phase's (b),
    with int8 moments; (c) recurrentgemma-9b, qwen3-moe, llama-3.2-vision
    and whisper-tiny at full width with int8 moments, each at the first of
    its depths that fits; (d) deepseek-v3's reckoning, not run.  Returns
    (c)'s steps as ``dryrun_vs_card`` reads them."""
    t0 = time.perf_counter()
    reset_launches()
    for arch in (DANUBE, VISION):
        q8_card_vs_cpu(arch)
    check_launches("int8-moment updates", read_launches(),
                   {name: 0 for name in KERNELS})

    cfg = get_config(DANUBE)
    n = sum(p.numel() for p in build(cfg, "meta").parameters())
    saved = n * (4 - moment_bytes_per_param()) / 1e9
    peak = DANUBE_BF16_MOMENTS["max_memory_allocated_gb"] - saved
    phase("train_q8", arch=DANUBE, prediction="before the run",
          moment_memory_saved_gb=f"{saved:.2f}",
          peak_gb_predicted=f"{peak:.1f}",
          step_ms_predicted="2850-2950 (+2-6 %)")
    out = q8_train(DANUBE, cfg, steps=FULL_STEPS, batch=FULL_BATCH,
                   seq=FULL_SEQ, lr=FULL_LR)
    hist = out["hist"]
    losses = [h["loss"] for h in hist]
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not last < first:
        raise AssertionError(f"int8 moments: loss did not fall: first "
                             f"three {first:.4f}, last three {last:.4f}")
    step_ms = statistics.median(h["ms"] for h in hist[1:])
    phase("train_q8", arch=DANUBE, batch=FULL_BATCH, seq=FULL_SEQ,
          steps=FULL_STEPS, moments="int8",
          step_ms_median_2_to_10=f"{step_ms:.3f}",
          step_ms_range=f"{min(h['ms'] for h in hist[1:]):.3f}-"
                        f"{max(h['ms'] for h in hist[1:]):.3f}",
          max_memory_allocated_gb=round(out["peak_gb"], 2),
          state_held_gb=round(out["state_held_gb"], 2),
          loss_first3=f"{first:.4f}", loss_last3=f"{last:.4f}",
          bf16_moments=DANUBE_BF16_MOMENTS, launches=out["launches"])

    measured = []
    for arch, (seq, cuts) in Q8_MODELS.items():
        for i, cut in enumerate(cuts):
            cfg = get_config(arch).replace(**cut)
            out = None
            try:
                out = q8_train(arch, cfg, steps=Q8_STEPS, batch=1, seq=seq,
                               lr=Q8_LR)
            except torch.cuda.OutOfMemoryError:
                if i + 1 == len(cuts):
                    raise
            if out is None:         # the failed run's tensors freed first
                gc.collect()
                torch.cuda.empty_cache()
                phase("train_q8", arch=arch, depth=repr(depth(cfg)),
                      out_of_memory=True, next_depth=repr(depth(
                          get_config(arch).replace(**cuts[i + 1]))))
                continue
            phase("train_q8", arch=arch, depth=repr(depth(cfg)), batch=1,
                  seq=seq, params=out["params"],
                  predicted_state_gb=f"{out['predicted_state_gb']:.2f}",
                  state_held_gb=round(out["state_held_gb"], 2),
                  max_memory_allocated_gb=round(out["peak_gb"], 2),
                  step_ms=[round(h["ms"], 3) for h in out["hist"]],
                  losses=[round(h["loss"], 6) for h in out["hist"]],
                  launches=out["launches"])
            measured.append({
                "arch": arch, "cfg": cfg, "batch": 1, "seq": seq,
                "moment_dtype": "int8", "peak_gb": out["peak_gb"],
                "step_ms": statistics.median(h["ms"]
                                             for h in out["hist"][1:])})
            break

    # (d) one deepseek-v3 MoE layer with its embedding and head, counted on
    # the meta device: over the card before any activation.
    cfg = get_config(DSV3).replace(n_layers=1, first_dense=0, mtp_depth=0)
    meta = dict(build(cfg, "meta").named_parameters())
    layer = sum(p.numel() for k, p in meta.items() if k.startswith("groups."))
    rest = sum(p.numel() for k, p in meta.items()
               if not k.startswith("groups."))
    per_param = 2 + 2 + moment_bytes_per_param()
    phase("train_q8", arch=DSV3, run=False, moe_layer_params=layer,
          embed_head_params=rest, bytes_per_param=f"{per_param:.3f}",
          moe_layer_gb=f"{layer * per_param / 1e9:.1f}",
          with_embed_head_gb=f"{(layer + rest) * per_param / 1e9:.1f}",
          card_gb=round(torch.cuda.get_device_properties(0).total_memory
                        / 1e9, 1))
    phase("train_q8", seconds=f"{time.perf_counter() - t0:.1f}")
    return measured


# ----------------------------------------------------------------- phase 9

# Two ranks share the one card over gloo (NCCL refuses two ranks on one
# GPU): a (data 1, model 2) mesh.  Every product, scan and flash launch runs
# on the card; gloo stages the two collectives (all-reduce, all-gather)
# through the host.
SHARDED_WORLD = 2
SHARDED_TIMEOUT_S = 900
# qwen3-moe at depth 2, full width: each rank holds 64 of each layer's 128
# experts.  fp32 prompt: the MoE prompt check's (4 x 256) at capacity
# E/k, so nothing drops; bf16 request: S=8192, the config's capacity.
SHARDED_MOE_CUT = {"n_layers": 2}
# mamba2-1.3b, ssd_shard_map: 32 of its 64 heads a rank.  The fp32 check
# runs depth 4 at S=8192: the plain chunked scan keeps (H_local, nc, L, L)
# tiles of ~268 MB a layer (fp32, 32 heads, 32 chunks of 256), several of
# them saved for the backward, on both ranks and the one-device run.
SHARDED_MAMBA_CHECK_CUT = {"n_layers": 4}
# its bf16 forward, timed at 12 of 48 layers: each layer's all-gather is
# staged through the host by gloo (138 ms a layer), so the whole depth took
# 5.92-7.14 s a run and told nothing the first 12 layers do not
SHARDED_MAMBA_TIMED_CUT = {"n_layers": 12}
SHARDED_TIMED_RUNS = 3
# its whole-model forward spends ~5 s in 48 gloo all-gathers, so it is
# timed twice after a warm-up
SHARDED_MAMBA_TIMED_RUNS = 2
# the reference's own tolerance for ssd_shard_map against one device
# (tests/test_perf_switches.py:58-59)
SSD_SHARD_TOL = {"atol": 2e-4, "rtol": 2e-3}
def sharded(entries: dict) -> None:
    """Spawn the ranks, wait for them (a rank that fails fails the phase at
    once and the others are stopped), and record each rank's launches."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    run_dir = ROOT / "build" / "sharded"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=sharded_rank,
                         args=(r, SHARDED_WORLD, str(run_dir)))
             for r in range(SHARDED_WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs):
            failed = {r: p.exitcode for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)}
            if failed:
                raise AssertionError(f"[sharded] ranks failed: {failed}")
            if time.monotonic() > deadline:
                raise AssertionError(f"[sharded] ranks still running after "
                                     f"{SHARDED_TIMEOUT_S} s")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
    if failed:
        raise AssertionError(f"[sharded] ranks failed: {failed}")
    for r in range(SHARDED_WORLD):
        done = json.loads((run_dir / f"rank{r}.json").read_text())
        for path, launches in done["launches"].items():
            record_launches(entries, f"[sharded] {path} rank {r}", launches)
    phase("sharded", seconds=f"{time.perf_counter() - t0:.1f}")


def sharded_rank(rank: int, world: int, run_dir: str) -> None:
    """One rank: the gloo probe, the qwen3-moe layer, the mamba2 model.
    Writes its launch counts; any failure raises (exit code 1)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{run_dir}/store", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=SHARDED_TIMEOUT_S))
    try:
        mesh = make_test_mesh(model=world)
        gloo_cuda_probe(mesh, rank)
        launches = sharded_moe(mesh, rank)
        launches.update(sharded_mamba2(mesh, rank))
        (Path(run_dir) / f"rank{rank}.json").write_text(
            json.dumps({"launches": launches}))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def gloo_cuda_probe(mesh, rank: int) -> None:
    """gloo's all-reduce and all-gather take CUDA tensors, or this
    raises."""
    group = mesh.get_group("model")
    n = dist.get_world_size(group)
    x = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(x, group=group)
    parts = [torch.empty(2, device="cuda") for _ in range(n)]
    dist.all_gather(parts, torch.full((2,), float(rank), device="cuda"),
                    group=group)
    if x.tolist() != [n * (n + 1) / 2] * 4 or \
            [p.tolist() for p in parts] != [[float(r)] * 2
                                            for r in range(n)]:
        raise AssertionError(f"gloo on CUDA tensors: {x}, {parts}")
    phase("sharded", rank=rank, mesh=repr(shd.mesh_shape(mesh)),
          backend=dist.get_backend(), gloo_cuda_all_reduce="ok",
          gloo_cuda_all_gather="ok")


def same_on_every_rank(what: str, t) -> None:
    """Every rank holds the same values (a sum in fp64 compared)."""
    s = t.double().sum().reshape(1).cuda()
    parts = [torch.empty_like(s) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, s)
    if len({p.item() for p in parts}) != 1:
        raise AssertionError(f"{what} differs between ranks: {parts}")


def expert_names(model) -> list:
    return sorted(n for n, _ in model.named_parameters()
                  if n.rsplit(".", 1)[-1] in shd.EXPERT)


def logits_and_expert_grads(model, batch) -> tuple:
    """The forward's logits, then one backward of ``loss_fn`` with only the
    experts' weights taking gradients; (logits, {name: local grad})."""
    names = set(expert_names(model))
    for n, p in model.named_parameters():
        p.requires_grad_(n in names)
    with torch.no_grad():
        logits, _ = model.forward(batch["tokens"])
    loss, _ = model.loss_fn(batch)
    loss.backward()
    grads = {}
    for n, p in model.named_parameters():
        if n in names:
            g = p.grad
            grads[n] = g.to_local() if isinstance(g, DTensor) else g
            p.grad = None
        p.requires_grad_(False)
    return logits, grads


def shard_experts(model, mesh):
    """Keep this rank's experts only (the rest of the model whole)."""
    shd.distribute_params(model, moe_mod.expert_shardings(model, mesh))
    gc.collect()
    torch.cuda.empty_cache()
    return model


def built_in_turn(cfg, mesh, rank: int, first=None):
    """Each rank builds the whole model from SEED and keeps its experts,
    one rank at a time (two whole models would not fit beside each other);
    ``first(model)`` runs on rank 0's whole model before it is sharded."""
    out, model = None, None
    for r in range(dist.get_world_size()):
        if r == rank:
            model = build(cfg, "cuda").init(generator(SEED, "cuda"))
            if first is not None and rank == 0:
                out = first(model)
            model = shard_experts(model, mesh)
        dist.barrier()
    return model, out


def local_drops(routes, cfg, rank: int, n_model: int) -> list:
    """Assignments this rank's experts drop in each MoE layer."""
    e_loc = cfg.n_experts // n_model
    out = []
    for r in routes:
        _, _, keep, mine = moe_mod.local_route(
            r.experts.reshape(-1, cfg.top_k), e_loc, rank, r.cap)
        out.append(int((mine & ~keep).sum()))
    return out


def collective_price(op: str, nbytes: int, mesh) -> str:
    hw = dataclasses.replace(hardware.get("h100"),
                             ici_link_bw=NVLINK_BYTES_PER_S_ONE_WAY,
                             ici_links_per_axis=1)
    secs = collective_time(op, nbytes, "model", mesh_spec_of(mesh), hw)
    return f"{secs * 1e3:.4f}"


def measured_collective_ms(op: str, nbytes: int, mesh) -> str:
    """Median host time of the collective on a CUDA buffer over gloo."""
    group = mesh.get_group("model")
    x = torch.ones(nbytes // 4, device="cuda")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        if op == "all-reduce":
            shd.reduce_from(x, group)
        else:
            shd.gather_from(x, 0, group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return f"{statistics.median(times):.3f}"


def sharded_moe(mesh, rank: int) -> dict:
    """qwen3-moe at depth 2 over the two ranks: fp32 logits and expert
    grads (gathered on rank 0) held against rank 0's one-device run of the
    same weights; the bf16 request at S=8192 timed, its drops and gap
    printed.  Returns the counted run's launches."""
    t0 = time.perf_counter()
    n_model = shd.mesh_shape(mesh)["model"]
    base = get_config(QWEN3).replace(**SHARDED_MOE_CUT)
    cfg = base.replace(dtype="float32", param_dtype="float32",
                       capacity_factor=base.n_experts / base.top_k)
    gen = generator(SEED + 1, "cuda")
    shape = (GEN_BATCH, GEN_PROMPT)
    batch = {"tokens": torch.randint(0, cfg.vocab, shape, generator=gen,
                                     device="cuda"),
             "labels": torch.randint(0, cfg.vocab, shape, generator=gen,
                                     device="cuda")}
    if moe_mod.capacity(cfg, math.prod(shape)) < math.prod(shape):
        raise AssertionError("capacity E/k still drops")
    torch.cuda.reset_peak_memory_stats()

    def one_device(model):
        logits, grads = logits_and_expert_grads(model, batch)
        return logits.cpu(), {n: g.cpu() for n, g in grads.items()}
    model, want = built_in_turn(cfg, mesh, rank, first=one_device)
    with shd.use_mesh(mesh):
        logits, grads = logits_and_expert_grads(model, batch)
    same_on_every_rank("qwen3-moe fp32 logits", logits)
    fields = {}
    if rank == 0:
        want_logits, want_grads = want
        err = check_close("sharded qwen3-moe fp32 logits", logits,
                          want_logits.cuda(), atol=FP32_REQUEST_TOL,
                          rtol=FP32_REQUEST_TOL)
        fields["logits_err"] = f"{err:.3e}"
    grad_err = 0.0
    for name in expert_names(model):
        mine = grads[name].cpu()
        if rank != 0:
            dist.send(mine, dst=0)
            continue
        parts = [mine] + [torch.empty_like(mine)
                          for _ in range(1, n_model)]
        for r in range(1, n_model):
            dist.recv(parts[r], src=r)
        got = torch.cat(parts).cuda()
        grad_err = max(grad_err, check_close(
            f"sharded qwen3-moe fp32 grad {name}", got,
            want_grads.pop(name).cuda(), **TRAIN_TOL))
        del got, parts
    if rank == 0:
        fields.update(expert_grad_err=f"{grad_err:.3e}", grad_tol=TRAIN_TOL)
    phase("sharded", arch=QWEN3, rank=rank, dtype="float32",
          depth=repr(depth(cfg)), tokens=shape,
          experts_held=f"{base.n_experts // n_model} of {base.n_experts}",
          capacity_factor=cfg.capacity_factor, logits_tol=FP32_REQUEST_TOL,
          **fields, peak_mem_gb=round(torch.cuda.max_memory_allocated()
                                      / 1e9, 2),
          seconds=f"{time.perf_counter() - t0:.1f}")
    del model, want, logits, grads
    gc.collect()
    torch.cuda.empty_cache()

    # bf16: the served request.
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = base.replace(use_flash_kernel=True)
    tokens = torch.randint(0, cfg.vocab, (1, PREFILL_LEN),
                           generator=generator(SEED + 1, "cuda"),
                           device="cuda")

    def one_device(model):
        with torch.inference_mode():
            with recorded_routes(cfg) as routes:
                logits = model.forward(tokens)[0]
            ms = host_ms(lambda: model.forward(tokens))
        return logits.cpu(), dropped(routes), ms
    model, want = built_in_turn(cfg, mesh, rank, first=one_device)
    with torch.inference_mode(), shd.use_mesh(mesh):
        with recorded_routes(cfg) as routes:
            logits = model.forward(tokens)[0]
        drops = local_drops(routes, cfg, mesh.get_local_rank("model"),
                            n_model)
        del routes
        reset_launches()
        ms = [host_ms(lambda: model.forward(tokens))]
        launches = read_launches()
        check_launches("sharded qwen3-moe bf16 forward", launches,
                       expected_launches(cfg, PREFILL_LEN, None))
        ms = sorted(ms + [host_ms(lambda: model.forward(tokens))
                          for _ in range(SHARDED_TIMED_RUNS - 1)])
    all_drops = [torch.empty(len(drops), dtype=torch.long, device="cuda")
                 for _ in range(n_model)]
    dist.all_gather(all_drops, torch.tensor(drops, device="cuda"))
    same_on_every_rank("qwen3-moe bf16 logits", logits)
    fields = {}
    if rank == 0:
        want_logits, want_drops, one_ms = want
        want_logits = want_logits.cuda()
        gap = max_abs_err("sharded qwen3-moe bf16 logits", logits,
                          want_logits)
        last_gap = max_abs_err("sharded qwen3-moe bf16 last logits",
                               logits[:, -1], want_logits[:, -1])
        rows_held = torch.isclose(logits.float(), want_logits.float(),
                                  **BF16_REQUEST_TOL).all(-1).float().mean()
        summed = torch.stack(all_drops).sum(0).tolist()
        # the first MoE layer sees the same input on both paths, so the
        # ranks drop exactly what the one-device path drops there
        if summed[0] != want_drops[0]:
            raise AssertionError(f"first layer drops {summed} against one "
                                 f"device {want_drops}")
        t = PREFILL_LEN
        nbytes = t * cfg.d_model * 4      # one fp32 (T, D) all-reduce
        fields = {"one_device_dropped_per_layer": want_drops,
                  "ranks_dropped_summed": summed,
                  "bf16_gap_to_one_device_not_gated": f"{gap:.3e}",
                  "last_token_gap": f"{last_gap:.3e}",
                  "share_of_rows_within_bf16_tol": f"{rows_held:.4f}",
                  "one_device_ms": round(one_ms, 3),
                  "collective": "all-reduce over model, once a layer",
                  "collective_bytes_per_layer": nbytes,
                  "collective_ms_measured_gloo": measured_collective_ms(
                      "all-reduce", nbytes, mesh),
                  "collective_ms_model_nvlink": collective_price(
                      "all-reduce", nbytes, mesh)}
    else:
        measured_collective_ms("all-reduce", PREFILL_LEN * cfg.d_model * 4,
                               mesh)
    phase("sharded", arch=QWEN3, rank=rank, dtype="bfloat16",
          depth=repr(depth(cfg)), tokens=PREFILL_LEN,
          capacity_factor=cfg.capacity_factor,
          cap_local=moe_mod.capacity(cfg, PREFILL_LEN),
          dropped_per_layer=drops, launches=launches,
          request_ms=[round(m, 3) for m in ms], **fields,
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 2),
          seconds=f"{time.perf_counter() - t0:.1f}")
    del model, want, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {QWEN3: launches}


def sharded_mamba2(mesh, rank: int) -> dict:
    """mamba2-1.3b with ssd_shard_map over the two ranks: fp32 logits and
    every gradient at depth 4 held against rank 0's one-device plain path
    at the reference's tolerance; the bf16 forward at S=8192 timed at
    ``SHARDED_MAMBA_TIMED_CUT``.  The sharded scan is the plain chunked
    one, as the reference's is, so no kernel is launched (counted)."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(MAMBA2).replace(ssd_shard_map=True)
    cfg = full.replace(dtype="float32", param_dtype="float32",
                       use_flash_kernel=False, **SHARDED_MAMBA_CHECK_CUT)
    gen = generator(SEED + 1, "cuda")
    batch = {k: torch.randint(0, cfg.vocab, (1, PREFILL_LEN), generator=gen,
                              device="cuda") for k in ("tokens", "labels")}
    model = build(cfg, "cuda").init(generator(SEED, "cuda"))

    def run():
        model.requires_grad_(True)
        with torch.no_grad():
            logits, _ = model.forward(batch["tokens"])
        model.loss_fn(batch)[0].backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        model.requires_grad_(False)
        return logits, grads
    want = None
    if rank == 0:
        logits, grads = run()
        want = logits.cpu(), {n: g.cpu() for n, g in grads.items()}
        del logits, grads
    dist.barrier()
    with shd.use_mesh(mesh):
        logits, grads = run()
    same_on_every_rank("mamba2 fp32 logits", logits)
    for n, g in grads.items():
        same_on_every_rank(f"mamba2 fp32 grad {n}", g)
    fields = {}
    if rank == 0:
        err = check_close("sharded mamba2 fp32 logits", logits,
                          want[0].cuda(), **SSD_SHARD_TOL)
        grad_err = max(check_close(f"sharded mamba2 fp32 grad {n}", g,
                                   want[1][n].cuda(), **SSD_SHARD_TOL)
                       for n, g in grads.items())
        fields = {"logits_err": f"{err:.3e}", "grad_err": f"{grad_err:.3e}"}
    phase("sharded", arch=MAMBA2, rank=rank, dtype="float32",
          depth=repr(depth(cfg)), tokens=PREFILL_LEN,
          heads_held=f"{cfg.ssm_heads // shd.mesh_shape(mesh)['model']} "
                     f"of {cfg.ssm_heads}", tol=SSD_SHARD_TOL, **fields,
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 2),
          seconds=f"{time.perf_counter() - t0:.1f}")
    del model, want, logits, grads
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    full = full.replace(**SHARDED_MAMBA_TIMED_CUT)
    model = build(full, "cuda").init(generator(SEED, "cuda"))
    tokens = batch["tokens"]
    logits = None

    def request():
        nonlocal logits
        logits = model.forward(tokens)[0]
    with torch.inference_mode(), shd.use_mesh(mesh):
        request()                                   # warm-up
        reset_launches()
        ms = [host_ms(request)]
        launches = read_launches()
        check_launches("sharded mamba2 bf16 forward", launches,
                       {name: 0 for name in KERNELS})
        ms = sorted(ms + [host_ms(request)
                          for _ in range(SHARDED_MAMBA_TIMED_RUNS - 1)])
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("sharded mamba2 bf16 logits not finite")
    same_on_every_rank("mamba2 bf16 logits", logits)
    n_model = shd.mesh_shape(mesh)["model"]
    nbytes = PREFILL_LEN * full.ssm_heads // n_model * full.ssm_headdim * 4
    measured = measured_collective_ms("all-gather", nbytes, mesh)
    phase("sharded", arch=MAMBA2, rank=rank, dtype="bfloat16",
          depth=repr(depth(full)), tokens=PREFILL_LEN, launches=launches,
          request_ms=[round(m, 3) for m in ms],
          collective="all-gather of y over model, once a layer",
          collective_bytes_per_layer_per_rank=nbytes,
          collective_ms_measured_gloo=measured,
          collective_ms_model_nvlink=collective_price("all-gather", nbytes,
                                                      mesh),
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 2),
          seconds=f"{time.perf_counter() - t0:.1f}")
    del model, logits
    torch.cuda.empty_cache()
    return {MAMBA2: launches}


# ----------------------------------------------------------------- phase 10

# The dry run (launch/dryrun.py).  (a) Production cells through its CLI, each
# in a process of its own that sees no card, all started together: the
# trace of a step on rank 0 of a fake 256- or 512-rank world, priced on the
# h100 file.  (b) While they run, the dry run's memory and FLOP count of the
# steps the train phases ran on the card, traced on a one-rank world with
# the same config, depth, batch and moments; each predicted peak held
# within DRYRUN_PEAK_BAND of torch.cuda.max_memory_allocated, both ways.
DRYRUN_CELLS = ((DANUBE, "train_4k", False), (QWEN3, "decode_32k", True),
                (MAMBA2, "long_500k", False))
DRYRUN_TIMEOUT_S = 300
DRYRUN_PEAK_BAND = 1.5


def start_dryrun_cells() -> list:
    run_dir = ROOT / "build" / "dryrun"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    cells = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        out = run_dir / f"{arch}.{shape}.jsonl"
        log = run_dir / f"{arch}.{shape}.log"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--json", str(out)]
        with open(log, "w") as f:
            proc = subprocess.Popen(
                cmd + (["--multi-pod"] if multi_pod else []), cwd=ROOT,
                env=env, stdout=f, stderr=subprocess.STDOUT,
                start_new_session=True)
        cells.append((arch, shape, out, log, proc))
    return cells


def finish_dryrun_cells(cells: list, t0: float) -> None:
    """Wait for (a)'s processes (each killed at the deadline) and print
    each cell's row; a cell that failed fails the phase."""
    failed = []
    for arch, shape, out, log, proc in cells:
        left = t0 + DRYRUN_TIMEOUT_S - time.perf_counter()
        try:
            rc = proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
        if rc != 0:
            failed.append(f"{arch} {shape}: rc {rc}: "
                          f"{log.read_text()[-2000:]}")
            continue
        row = json.loads(out.read_text().splitlines()[-1])
        mem = row["memory"]
        phase("dryrun", arch=arch, shape=shape, mesh=row["mesh"],
              status=row["status"], chips=row["chips"], torch=row["torch"],
              compute_s=f"{row['compute_term_s']:.4e}",
              memory_s=f"{row['memory_term_s']:.4e}",
              collective_s=f"{row['collective_term_s']:.4e}",
              dominant=row["dominant"],
              useful_flops_ratio=f"{row['useful_flops_ratio']:.4f}",
              rank_gb=round((mem["argument_bytes"] + mem["temp_bytes"])
                            / 1e9, 3),
              fits=row["fits"],
              trace_seconds=f"{row['compile_seconds']:.1f}",
              collectives={k: f"{v:.3e}"
                           for k, v in row["collective_totals"].items()})
    if failed:
        raise AssertionError("dry-run cells failed:\n" + "\n".join(failed))


def dryrun_vs_card(steps: list) -> None:
    """(b): each step the train phases measured, traced on one rank."""
    for st in steps:
        t0 = time.perf_counter()
        cfg = st["cfg"]
        plan = {"rules": {}, "microbatches": 1,
                "moment_dtype": st["moment_dtype"],
                "accum_dtype": "float32", "remat": None}
        with fake_world(1):
            mesh = make_test_mesh(devices=1, model=1, device="cpu")
            art = dryrun.lower_cell(
                st["arch"], "train_4k", multi_pod=False, plan_override=plan,
                accounting=False, mesh=mesh, cfg=cfg,
                shape=ShapeSpec("card", "train", st["seq"], st["batch"]))
        mem = art["memory_analysis"]
        predicted = (mem["argument_bytes"] + mem["temp_bytes"]) / 1e9
        ratio = predicted / st["peak_gb"]
        flops = art["trace"].flops
        secs = st["step_ms"] / 1e3
        peak = PEAK_FLOPS[torch.bfloat16]
        fields = {}
        if "flops_6nd" in st:
            fields["six_nd_bf16_share"] = \
                f"{st['flops_6nd'] / secs / peak:.4f}"
        phase("dryrun", arch=st["arch"], depth=repr(depth(cfg)),
              batch=st["batch"], seq=st["seq"],
              moments=st["moment_dtype"] or cfg.param_dtype,
              predicted_peak_gb=f"{predicted:.3f}",
              measured_peak_gb=f"{st['peak_gb']:.3f}",
              ratio=f"{ratio:.4f}", band=DRYRUN_PEAK_BAND,
              argument_gb=f"{mem['argument_bytes'] / 1e9:.3f}",
              temp_gb=f"{mem['temp_bytes'] / 1e9:.3f}",
              dryrun_flops=f"{flops:.4e}", step_ms=f"{st['step_ms']:.3f}",
              dryrun_flops_bf16_share=f"{flops / secs / peak:.4f}",
              **fields, trace_seconds=f"{time.perf_counter() - t0:.1f}")
        if not 1 / DRYRUN_PEAK_BAND <= ratio <= DRYRUN_PEAK_BAND:
            raise AssertionError(
                f"{st['arch']}: the dry run's peak {predicted:.3f} GB is "
                f"x{ratio:.4f} of the card's {st['peak_gb']:.3f} GB, "
                f"outside x{DRYRUN_PEAK_BAND} either way")


def dryrun_phase(steps: list) -> None:
    t0 = time.perf_counter()
    reset_launches()
    cells = start_dryrun_cells()
    try:
        dryrun_vs_card(steps)
    except BaseException:
        for *_, proc in cells:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        raise
    finish_dryrun_cells(cells, t0)
    launches = read_launches()
    check_launches("the dry run", launches, {name: 0 for name in KERNELS})
    phase("dryrun", launches=launches,
          seconds=f"{time.perf_counter() - t0:.1f}")


# ------------------------------------------------- phase: the contract gate

CONTRACTS_TIMEOUT_S = 120


def contracts() -> None:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=CONTRACTS_TIMEOUT_S)
    secs = time.perf_counter() - t0
    report = json.loads(out.stdout)
    counts = report["counts"]
    phase("contracts", rc=out.returncode, errors=counts["errors"],
          warnings=counts["warnings"], suppressed=counts["suppressed"],
          seconds=f"{secs:.1f}")
    left = [f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']}"
            for f in report["findings"] if not f["suppressed"]]
    if out.returncode != 0 or counts["errors"] or counts["warnings"]:
        raise AssertionError("the contract gate found:\n" + "\n".join(left)
                             + out.stderr[-2000:])


# ------------------------------------------------------ phase: the examples

# 138M parameters at 16 x 512 tokens: ~6.8e12 FLOP a step, ~0.3 s a step
# on an H100 in fp32; the example's checkpoints (1.7 GB each, every 10
# steps and at the end) take longer than the steps.
TRAIN_LM_STEPS = 20
EXAMPLES = (
    ("quickstart", ["examples_torch/quickstart.py"]),
    ("train_lm", ["examples_torch/train_lm.py", "--preset", "100m",
                  "--steps", str(TRAIN_LM_STEPS),
                  "--ckpt-dir", "build/examples/train_lm_ckpt"]),
)
EXAMPLE_TIMEOUT_S = 300
# quickstart's "  loss 5.022 -> 3.792", train_lm's "[train_lm] loss ..."
LOSSES = re.compile(r"loss (\S+) -> (\S+)")


def examples() -> None:
    run_dir = ROOT / "build" / "examples"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t_phase = time.perf_counter()
    for name, args in EXAMPLES:
        log = run_dir / f"{name}.log"
        t0 = time.perf_counter()
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                                stdout=f, stderr=subprocess.STDOUT,
                                timeout=EXAMPLE_TIMEOUT_S).returncode
        secs = time.perf_counter() - t0
        text = log.read_text()
        if rc != 0:
            raise AssertionError(f"examples_torch: {name} exited {rc}:\n"
                                 f"{text[-3000:]}")
        first, last = (float(x) for x in LOSSES.findall(text)[-1])
        rates = [float(r) for r in re.findall(r"\(([\d.]+) it/s\)", text)]
        phase("examples", example=name, argv=" ".join(args[1:]),
              seconds=f"{secs:.1f}", first_loss=f"{first:.4f}",
              last_loss=f"{last:.4f}",
              it_per_s=rates[-1] if rates else None)
        if not last < first:
            raise AssertionError(f"examples_torch: {name}: the last loss "
                                 f"{last} is not below the first {first}")
    phase("examples", seconds=f"{time.perf_counter() - t_phase:.1f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    machine()
    build_kernels()
    entries = {"flash_attention": flash_attention_checks(),
               "ssd": ssd_checks(), "matmul": matmul_checks(),
               "rmsnorm": rmsnorm_checks()}
    measured_hw, suite = loop(entries)
    tile_runs = tile_selection(measured_hw, entries)
    predict_serve(measured_hw, suite, tile_runs, entries)
    del tile_runs
    torch.cuda.empty_cache()
    for arch in ARCHS:
        t_arch = time.perf_counter()
        prefill_requests(arch, entries)
        generation_request(arch)
        phase("serve", arch=arch,
              seconds=f"{time.perf_counter() - t_arch:.1f}")
    for arch, seq in RAGGED_PREFILL.items():
        prefill_requests(arch, entries, seq)
    torch.cuda.empty_cache()
    reset_launches()
    train_checks()
    danube_step = train_full()
    check_launches("the train phase", read_launches(),
                   {name: 0 for name in KERNELS})
    q8_steps = train_q8()
    sharded(entries)
    dryrun_phase([danube_step] + q8_steps)
    contracts()
    examples()
    phase("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
