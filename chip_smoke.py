"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out FILE]

Builds every CUDA kernel of the port from the sources in this checkout,
times the DCGAN and 3D-GAN train steps first (the DCGAN step is bound by
the host, which later phases leave slower), holds each kernel against
its plain PyTorch version on the card, drives
the port's serving paths through ``GanServer.generate`` (random weights
from a seed): the full-width DCGAN generator through the planar kernel
and the full-width 3D-GAN generator through the volumetric one, and
checks the outputs, the launch counts and the launches of each GANAX
route (``tc``, ``narrow``, either with split-K) of each path; then
times each layer's kernel (per call and as the device runs it) beside
its bound, its plain version, the whole op and one library call, and
each generator forward.  The serving-stack phases drive full-width
DCGAN through ``GanEngine`` (48 requests of 1-100 images from 4
producer threads, buckets 8-64, at ``pipeline_depth`` 1 and 2, then a
sweep of one request at a time that runs every bucket): every future
answered, the accounting invariant, every batch's launches and routes
by bucket, every bucket's images against the plain version on the same
latents, a single-bucket engine bit for bit against
``GanServer.generate``, and ``submit`` mixed with ``generate`` against
``generate`` alone, printing images/s and request latency; serve both
generators from a program built, saved and loaded back (the same images
as the direct path, ``ganax`` on every layer); and, with ``repro_torch.obs``
on, check that the ``engine.request``, ``serve.generate``,
``program.apply`` and ``program.layer`` spans nest and the registry
agrees with the servers, and that ``obs.profile`` writes a device trace
holding the GANAX kernels (and reads whether each engine batch's
device-to-host copy ran under the next batch's kernels).  The quant
phase holds the GANAX kernels' bf16 and f16 instances against their
plain version on every serving geometry of both networks of DCGAN and
3D-GAN (with a control that sums in the storage dtype and must fail
that gate), serves both generators at bf16 and f16 through
``GanServer.generate`` and holds them against a ``ganax-plain`` path
(with a planted fault that must fail that gate) and the reference's
calibration gates, serves an int8 DCGAN program through ``GanServer``
and ``GanEngine`` bit for bit, and times both generators at f32, bf16
and f16 beside cuDNN at the same dtype.  The training
phases hold every launch geometry
of an adversarial step (the discriminators' convs and every layer's
``dx``) against the plain version, run the TF32 control (the plain
version with TF32 matmuls must fail that gate), and time each beside
its ``dw`` contraction; drive full-width DCGAN training through the
quickstart entry point (``TrainLoop``, a checkpoint, 40 kernel launches
a step, every route) and 3D-GAN training through the same code; hold
one step's losses and gradients against the same step through
``ganax-plain``; and profile the steps.  The mixed_train phase holds
every launch geometry of both train steps at bf16 and f16 against the
plain version (the dx launches among them), trains full-width DCGAN and
3D-GAN through ``TrainLoop`` at bf16 and f16 (40 launches a step of the
dtype's instance, f32 parameters and checkpoints), gates one DCGAN
step's gradients against the plain path's (``PATH_ACCURACY``, with a
planted fault that must exceed it) and the reference's ``grad_rel`` at
its calibration configuration, and times the steps at f32, bf16 and
f16.  The tune phase holds every kernel route the autotuning planner
enumerates for the generators' layers against the plain version,
measures them into a plan file (no candidate may fail), rebuilds
``backend="auto"`` programs from it with zero measurements and serves a
batch through ``GanServer`` on them.  The paper phase checks the
paper's own models: the figure rows of ``repro_torch.paper_figs`` (the
analytical cycle/energy model's outputs, computed on the host) in the
reference test's bands, the μop ISA machine's float64 output against
the ``ganax_conv`` kernel on the card for tests/test_uop.py's geometries
and each 2-D Table-I generator geometry (with a planted dropped ``mac``
μop that must fail that gate), and the kernel's products against the
consequential MACs of every Table-I tconv layer.  The LLM phases hold the two
flash-attention kernels (the wgmma/TMA one for bf16 at hd 64, 128 and
256 and at (96, 64), the FFMA one for f32 and the smaller head dims)
against their plain
version on Gemma-7B's and Qwen's geometries, serve full-width Gemma-7B
(random bf16 weights from a seed) through ``DecodeEngine.run`` with
every prefill's attention launched through the wgmma kernel (28
launches a prefill), hold the kernel path's prefill and first decode
logits against the plain and naive attention paths (in f32 through the
FFMA kernel), and time and profile the prefill, the decode steps and
the kernels beside their bound, their plain version and one
``F.scaled_dot_product_attention`` call.  The llm_train phase trains
full-width Gemma-7B with 4 of its 28 layers (f32 masters, AdamW,
2x2048-token SyntheticLM batches, remat, the forward attention and its
recompute through the wgmma kernel, the backward a plain recompute):
step time, tokens/s, model-FLOP share, peak memory, the optimizer's
share, a loss that falls on one repeated batch; it holds the gradients
wrt the masters through the kernel against the naive path in bf16 (with
a planted backward fault that must fail that gate) and in f32 through
the FFMA kernel, remat, "dots" and grad_accum=2 against their controls.
The
gemma3 phase serves and trains full-width Gemma3-4B (sliding-window and
global layers).  The minicpm3 phase serves full-width MiniCPM3-4B (16
of its 62 layers of multi-head latent attention, random bf16 weights
from seed 0) through ``DecodeEngine.run``, every prefill's attention
through the wgmma kernel's split instance (q·k 96 against v 64; 16
launches a prefill), times it beside the FFMA kernel's instance at the
same head dims, holds each launch of a 4000-token prefill to float64, the
kernel path's logits to the naive path's (with a dropped kv tile and
the dv^-0.5 scale planted above the gate), the absorbed decode to the
expanded form (with W_uk and W_uv swapped above the gate), checks an f32
model through the f32 instance and the tiny preset through the (48,
32) instances, and trains 16 of the 62 layers (the loss falling, the
bf16 gradient gate with a planted backward fault on ``wkv_b``).  The
moe phase serves full-width OLMoE-1B-7B (16 layers, 64 experts at top-8,
random bf16 weights from seed 0; the mixture-of-experts layer in plain
PyTorch, as the reference's has no Pallas kernel) through
``DecodeEngine.run``, every prefill's attention through the wgmma
kernel's (128, 128) instance (16 launches a prefill), holds one layer's
routing to the reference's one-hot form bit for bit and its output to
float64 (a reversed tie order, an ignored capacity and unnormalised
gates planted above that gate), the logits to the naive path's, an f32
model through the FFMA kernel, trains 4 of the 16 layers (the aux
losses finite and nonzero, the bf16 gradient gate), and serves
Llama-4-Scout's first 8 of 48 layers at full width (GQA, top-1 of 16
experts and a shared expert).  The ssm phase serves full-width
Mamba2-2.7B (64 attention-free layers of the Mamba2 mixer, plain PyTorch
as the reference's has no Pallas kernel; no flash launch) and
Hymba-1.5B (32 hybrid layers, attention beside the mixer; its 3 global
layers through the wgmma kernel's bf16 hd-64 instance, 48 launches,
timed beside the FFMA kernel's on the same q, k, v)
through ``DecodeEngine.run``, holds one Mamba2 layer's chunked SSD to
its float64 token-by-token recurrence (a state not carried across
chunks, an undecayed inbound state and the mask after the ``exp``
planted above that gate), the prefill/decode handoff of both models,
Hymba's logits to the naive path's and an f32 Hymba through the f32
hd-64 instance, and trains 8 of Mamba2's 64 layers and 4 of Hymba's
32, two of them global (the gradient gates; Hymba's with teeth in f32,
4 layers, through the f32 hd-64 instance).  The encoder_vlm phase
encodes with full-width HuBERT-XLarge (48 non-causal layers of 16 heads
of 80, random bf16 weights from seed 0) 16 utterances of 100-1500
frames and one of 32,768, every attention through the wgmma kernel's
bf16 (80, 80) instance (48 launches an encode), holds each launch of
the longest utterance to its plain version and float64 (a dropped
second v panel planted above both gates), the logits to the naive and
plain paths, times the instance
beside the FFMA kernel's, its plain version and SDPA, trains the whole
depth with the masked-frame loss (the bf16 gradient gate), and checks
an f32 model through the FFMA kernel's f32 (80, 80) instance; then
serves full-width InternVL2-26B (48 layers, 19.9 B parameters) through
``DecodeEngine.run`` on text (the (128, 128) instance, 48 launches a
prefill) and through image-prefixed prefills and greedy decode steps,
holds its launches to float64 and its logits, with and without the
image, to the naive and plain paths (the image dropped above the gate),
checks it in f32 and trains 4 of its 48 layers with the image prefix.
The qwen phase, on an empty card, serves full-width Qwen1.5-32B (64
layers, 35.2 B parameters, 70.39 GB of bf16 weights, the QKV biases
drawn) through ``DecodeEngine.run`` on as many slots as keep the peak
under 95% of the card (the (128, 128) instance, 64 launches a prefill),
holds each launch of a prefill to its plain version and float64, decodes
16 steps from a 4 x 2048 int8 cache through ``decode_step`` (every
dequantized entry within its bound), and on conditioned weights holds
the logits to the plain path (a dropped QKV bias above the gate) and
the int8 cache's to a bf16 cache's (ignored scales above the gate).
The roofline phase counts, on ``meta`` tensors with the dry-run's
counter (``repro_torch/utils/opcount.py``), three steps those phases
ran on the card (Gemma-7B's train step, Qwen1.5-32B's prefill of its
longest prompt and its int8 decode step) and holds each count to the
card: the products' FLOPs to the profiler's, the flash launches by
geometry, the temp bytes and the peak memory, and the roofline bound of
the counts to the measured device time.
The mesh phase runs programs sharded over two ``gloo`` ranks that share the
card (started by the port's launcher once the kernels are built): the
full-width DCGAN and
3D-GAN generators at meshes (2, 1) and (1, 2), f32 and bf16, with each
Cout-sharded layer's kernel on the rank's slice, a DCGAN train step at
(2, 1) and (1, 2), ``GanEngine`` at (2, 1) and both ring matmuls, each
against the one-device path, then a (1, 1) program over NCCL in a world
of one, bit for bit; then, on the same two ranks, the sequence-sharded
decode of full-width Qwen1.5-32B at 4 of its 64 layers (a cache of 2 x
4096 rows, 2048 a rank; bf16 and f32, int8 and bf16 caches) against the
one-device ``decode_step``, with a combine that drops the rescaling
planted above the gates; and the dense transformer on the same ranks
(``mesh_lm_cases``): tensor- and data-parallel training of full-width
Gemma3-4B's first 6 layers (FSDP masters, ZeRO-1 moments), Qwen1.5-32B's
TP prefill and decode and the batch-sharded decode, Gemma3's windowed
layers under the sequence-sharded decode, and the reshard of a (2, 1)
state onto (1, 2) and one device, each against the one-device path with
a planted fault above its gate; and the other families on the same
ranks (``mesh_family_cases``): MiniCPM3-4B's MLA, OLMoE-1B-7B's and
Llama-4-Scout's MoE, Mamba2-2.7B's SSM and Hymba-1.5B's hybrid blocks
(heads padded) at full width with their layers cut, trained, prefilled
and decoded against the one-device path (MoE routing bit for bit), each
family with a planted fault above its gate; every rank's flash launches
counted by geometry and heads.  It imports nothing of JAX and nothing
of the JAX package; it prints the seconds of each phase.

The line before the last is a JSON object listing every kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero and prints no result; so does a machine without a CUDA card.
``--out`` also writes the whole record (per-layer times included) as
JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (data sheet, dense): FP32 outside the
# tensor cores, TF32 on them, and HBM3 bandwidth.  The bound of a GANAX
# launch is the larger of its bytes over HBM's rate and its useful
# products taken f32-exact the fastest way the card has: three TF32
# products each (3xTF32, csrc/ganax_conv_sm90.cuh) at the TF32 rate.
# The FP32 bound (the products at the FFMA rate) is printed beside it.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_TC_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
# dense bf16 on the tensor cores (f32 sums): the flash-attention bound
# counts a bf16 call's q.k at this rate
PEAK_BF16_TC_FLOPS = 989e12

BATCH = 64
# f32 against f32: the sums run in another order over K <= 16·1024
# terms, so a few ulps of the largest partial sums.
ATOL = RTOL = 1e-4
# the GANAX kernels' routes (KernelRoute.name); each kernel's training
# path runs all four
ROUTES = ("tc", "tc+split_k", "narrow", "narrow+split_k")
# the TF32 control: the plain version with TF32 matmuls on these wide
# launches must fail the gate above (at least one a kernel), which shows
# the gate tells 3xTF32 from 1xTF32
TF32_CONTROL = {"ganax_conv": ("dcgan g1", "dcgan d4"),
                "ganax_conv3d": ("3dgan g1", "3dgan d4")}

# name -> (source, the TPU kernel it replaces).  flash_attention has two
# kernels, picked by dtype and head dims: the wgmma/TMA one (bf16 at hd
# 64, 128 and 256 and at (96, 64), the served models) and the FFMA one
# (f32, bf16 at hd 8-32, the tiny split pair (48, 32)).
KERNELS = {
    "ganax_conv": ("src/repro_torch/kernels/csrc/ganax_conv.cu",
                   "src/repro/kernels/ganax_conv.py:99"),
    "ganax_conv3d": ("src/repro_torch/kernels/csrc/ganax_conv3d.cu",
                     "src/repro/kernels/ganax_conv.py:215"),
    "flash_attention_wgmma": (
        "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "src/repro/kernels/flash_attention.py:31"),
    "flash_attention_ffma": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:31"),
}
FLASH_VARIANTS = {"wgmma": "flash_attention_wgmma",
                  "ffma": "flash_attention_ffma"}
# the requests each serving path answers
REQUESTS = (64, 100, 37)
# the training paths: DCGAN steps through the quickstart entry point,
# 3D-GAN steps through the same training code
TRAIN_STEPS = 6
TRAIN3D_STEPS = 2
# kernel launches of one adversarial step: the D step runs G (4), D(real)
# and D(fake) (5 + 5), and the dx of d2-d5 of each (4 + 4; the reals and
# the no-grad fakes need no dx at d1); the G step runs G (4) and D(fake)
# (5), and the dx of d1-d5 (5) and of g1-g4 (4)
LAUNCHES_PER_STEP = 40
# one step's gradients through the kernel against the same step through
# ganax-plain: ||a - b|| <= GRAD_TOL * ||b|| per tensor.  A norm and not
# each element, because ReLU and LeakyReLU change slope at 0: the kernel
# and the plain version sum in another order, so an output within a few
# ulps of 0 can take one slope in one step and the other in the other,
# and such knife-edge elements move the gradients downstream of them by
# O(1) locally (on the card: one DCGAN step's g.proj_w off by 1.5e-3 in
# norm).
# The step through the polyphase oracle (cuDNN convs, a third summation
# order, no GANAX kernel) against ganax-plain is printed beside it as the
# control: what another f32 order alone does.  A missing tap or a wrong
# offset moves a gradient by several percent.
GRAD_TOL = 1e-2
# the same step's losses: |a - b| <= LOSS_TOL * max(1, |b|)
LOSS_TOL = 1e-4
# the autograd Function's profiler labels (core/dataflow.py)
RANGES = ("ganax.forward", "ganax.dx", "ganax.dw")

# The LLM serving path: full-width Gemma-7B in bf16, random weights from
# seed 0, LLM_REQUESTS prompts of lengths drawn from the seed in
# LLM_PROMPT_LENS, greedy, through an engine of LLM_SLOTS slots.
LLM_ARCH = "gemma-7b"
LLM_REQUESTS = 16
LLM_PROMPT_LENS = (128, 2048)
LLM_SLOTS, LLM_MAX_LEN, LLM_MAX_NEW = 8, 2112, 32
# the flash-attention kernel against its plain version, per element
# |a - b| <= atol + rtol |b|: f32 against f32 summed in another order; in
# bf16 both compute in f32 from the same inputs and round once, so at
# most one bf16 ulp apart (an ulp is <= 2^-7 |b|; rtol 2^-6 is two), and
# atol covers outputs within f32 noise of 0
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 2 ** -6)}
# the scale of q and k in the flash case of large scores: q.k hd^-1/2 of
# standard deviation FLASH_BIG_SCORES^2 = 100, a saturated softmax, as
# the reference's init gives in the llm_train phase's layers
FLASH_BIG_SCORES = 10.0
# the soft-cap instances of both kernels, held to their plain version at
# FLASH_TOL: (label, B, S, H, hd, dtype) at each (q/k scale, cap) of
# SOFTCAP_BITES, a cap that bites: scores of std 1 at cap 1, of std
# FLASH_BIG_SCORES^2 at cap 5
SOFTCAP_GEOMETRIES = (("gemma3 global S=4000", 1, 4000, 8, 256, torch.bfloat16),
                      ("f32 S=1024", 1, 1024, 8, 256, torch.float32),
                      ("hd64 S=1000", 1, 1000, 25, 64, torch.bfloat16))
SOFTCAP_BITES = ((1.0, 1.0), (FLASH_BIG_SCORES, 5.0))
# the split instances (q·k head dim, v head dim) -> heads: MiniCPM3-4B's
# 40 heads of 64 + 32 against 64, its tiny preset's 4 of 32 + 16 against
# 32; each at both dtypes on SPLIT_CASES (label, B, S, T, causal,
# soft-cap): causal and full, ragged S and T against the q tiles (128
# rows for the wgmma kernel's bf16 (96, 64), 64 for the FFMA kernel's)
# and the kv tiles (128 rows at the wgmma kernel's (96, 64), 32 at the
# FFMA kernel's, 64 at (48, 32)), one soft-capped case (a cap of 1,
# which bites on scores of std 1).  The FFMA kernel's bf16 (96, 64)
# instance, off the main path since the wgmma kernel takes that
# geometry, is held on the same cases, called through
# flash_attention_ffma: it is the wgmma instance's yardstick
SPLIT_HEADS = {(96, 64): 40, (48, 32): 4}
SPLIT_CASES = (("causal ragged", 1, 1000, 1000, True, 0.0),
               ("full ragged B=2", 2, 333, 197, False, 0.0),
               ("causal cap 1", 1, 300, 300, True, 1.0))
# prefill and first-decode logits of the kernel path against the naive
# path: ||a - b|| <= LLM_TOL * ||b||, in f32 (the same weights widened).
LLM_TOL = 1e-2
# the same in bf16, the served model, against the kernel's plain version
# through the same model: ||a - b|| <= LLM_TOL_BF16 * ||b||.  Looser,
# because the random weights (fan-in scaled by the layer count, as the
# reference draws them) make the 28 layers amplify the kernel's one-ulp
# differences in the attention output to a few percent of the logits'
# norm (3.4e-2 through the FFMA kernel, 5.6e-2 through the wgmma one,
# on an H100).  The limit lies between that and what the
# planted faults of PLANTED_FAULTS read; the script checks that both
# faults exceed it.
LLM_TOL_BF16 = 0.1
# negative controls of that gate: the kernel's function with one fault
# planted, in place of the kernel through the same model
PLANTED_FAULTS = ("diagonal tile dropped", "strict causal mask")

# The quant phase: the GANAX kernels' bf16 and f16 instances.  Per launch,
# kernel against plain at the same dtype: both sum the same exact
# products in f32 and round once, so they are at most one ulp apart;
# the gate is two ulps of the bottom of a binade (rtol 2^-6 for bf16's 8
# significant bits, 2^-9 for f16's 11), and atol covers outputs within
# f32 noise of 0 (FLASH_TOL's bf16 row).
STORAGE_TOL = {torch.bfloat16: (1e-3, 2 ** -6),
               torch.float16: (1e-3, 2 ** -9)}
STORAGE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                 torch.float16: "float16"}
STORAGE_DTYPES = {v: k for k, v in STORAGE_NAMES.items()}
# The accumulation control: the plain arithmetic with each tap's matmul
# and the sum kept in the storage dtype must fail the gate above on at
# least one of these wide launches of each kernel, at each dtype.
STORAGE_CONTROL = TF32_CONTROL
# The path gate.  The per-launch gate holds a launch to the plain
# version's function up to its one rounding; on the path the question is
# the same, asked of the whole generator: is the kernel path as accurate
# as the plain path?  Both are measured against the f32 plain path on
# the same latents (the random weights leave DCGAN's images at ~1e-3,
# where an elementwise gate would be all atol):
#   ||img - img32|| <= PATH_ACCURACY * ||plain - img32||.
# Flips of a last bit between two f32 summation orders leave the error
# where it was (1.000 on the CPU's emulation of the tc order); one layer
# summed in the storage dtype adds its taps' roundings (1.10-1.12 on the
# CPU, DCGAN and 3D-GAN), and must exceed the gate on every run.
PATH_ACCURACY = 1.05
# the planted fault of the path gate: this launch of each generator
# batch (g1, the widest) sums in the storage dtype
PATH_FAULT_LAYER = 0
# the reference's calibration configuration of its output gates
# (repro.quant.tolerance): channel scale, batch
CALIBRATION = (0.0625, 2)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, runs: int = 15) -> float:
    """Median CUDA-event time of ``fn()`` in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, warmup: int = 3, runs: int = 20) -> float:
    """CUDA-event time of ``fn()`` in ms, as the device runs it: the mean
    over ``runs`` back-to-back calls, enqueued while the device sleeps
    (``torch.cuda._sleep``) so that the host's time to issue them is not
    in the window.  Refuses a window the device reached before the host
    had issued every call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        reached = start.query()
        end.synchronize()
        if not reached:
            return start.elapsed_time(end) / runs
        cycles *= 4
    raise SmokeFailure("the host issued too slowly to time on the device")


def q_sizes(operands: dict) -> tuple[int, ...]:
    """The phase grid of one launch's operands: (qy, qx) or (qz, qy, qx)."""
    return tuple(operands[k] for k in ("qz", "qy", "qx") if k in operands)


def bound(operands: dict, bias) -> tuple[float, str, float, int, float]:
    """(bound ms, what bounds it, flops, bytes, FP32 bound ms) of one
    kernel launch, 2-D or 3-D: each input read once and the output
    written once (x_pad, w_taps and the output in their storage dtype,
    bias and tap tables at 4 bytes); the useful operations the tap
    tables of this geometry need (2 per consequential MAC, no padding of
    Cout or K), at f32 three TF32 products each at the tensor cores'
    rate, at bf16/f16 one dense product each at theirs; the FP32 bound
    takes them at the FFMA rate."""
    x_pad, w_taps = operands["x_pad"], operands["w_taps"]
    b, cin = x_pad.shape[0], x_pad.shape[-1]
    p, _, _, cout = w_taps.shape
    q = math.prod(q_sizes(operands))
    taps = sum(len(ph) for ph in operands["tables"].taps)
    flops = 2.0 * b * q * taps * cin * cout
    out_elems = b * p * q * cout
    tables = operands["tables"]
    nbytes = x_pad.element_size() * (x_pad.numel() + w_taps.numel()
                                     + out_elems) \
        + 4 * ((bias.numel() if bias is not None else 0)
               + tables.n_taps.numel()
               + sum(o.numel() for o in tables.offsets))
    t_ops = (3 * flops / PEAK_TF32_TC_FLOPS if x_pad.element_size() == 4
             else flops / PEAK_BF16_TC_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes,
            max(flops / PEAK_FP32_FLOPS * 1e3, t_bytes))


def route_of(operands: dict) -> str:
    """The route the wrapper takes for these operands."""
    from repro_torch.kernels.ganax_conv import kernel_route
    p, t, cin, cout = operands["w_taps"].shape
    rows = operands["x_pad"].shape[0] * math.prod(q_sizes(operands))
    return kernel_route(cin, cout, rows, t * cin, p,
                        operands["x_pad"].element_size()).name


def tol_share(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst output's share of its tolerance: max |a - b| / (ATOL +
    RTOL |b|); the gate passes at <= 1."""
    return ((got - ref).abs() / (ATOL + RTOL * ref.abs())).max().item()


def routes_launched(wrappers) -> dict:
    """Each GANAX kernel's launches by route since its counts were
    zeroed."""
    return {k: dict(w[0].launches_by_route) for k, w in wrappers.items()
            if hasattr(w[0], "launches_by_route")}


def tf32_control(operands: dict, bias, ep, ref) -> tuple[float, float, bool]:
    """The plain version's arithmetic with TF32 matmuls on, against the
    IEEE plain output ``ref``: (max abs err, worst share of the
    tolerance, whether it passes the gate).  TF32 is off again after."""
    from repro_torch.kernels.ganax_conv import (apply_epilogue_to_acc,
                                                plain_sums)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = apply_epilogue_to_acc(
            plain_sums(operands["x_pad"], operands["w_taps"],
                       operands["tables"], operands["out_strides"],
                       q_sizes(operands)), bias, ep.activation,
            ep.leaky_slope)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err, ok = max_err(got, ref)
    return err, tol_share(got, ref), ok


def profile(fn, runs: int, what: str, ranges_of=RANGES, *,
            flops: bool = False, warmup: bool = True, before=None) -> dict:
    """Device time by kernel over ``runs`` calls of ``fn`` (torch.profiler),
    the span on the device's timeline of each range of ``ranges_of``
    (by default the training ranges of ``RANGES``: the kernel backends'
    autograd Function labels its forward, ``dx`` and ``dw``; a span
    includes the device's idle gaps inside it), and the share of the
    wall time the device was busy.  ``fn`` runs once unprofiled first
    (``warmup``), then ``before()`` if given; with ``flops`` the
    profiler's FLOPs (``with_flops``) of the product ops (``mm``,
    ``addmm``, ``bmm``, ``baddbmm``) that ran are ``dot_flops_per_run``
    (those of the backward that launched no kernel left out: a
    recompute's early-stopped op), ``dot_flops_recorded_per_run`` every
    such op the profiler recorded.
    Prints the breakdown; returns it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from repro_torch.utils.opcount import DOT_OPS
    if warmup:
        fn()
    torch.cuda.synchronize()
    if before is not None:
        before()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       with_flops=flops) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dot_flops = dot_flops_all = 0.0
    if flops:
        # each product op's FLOPs, but for the ops in a backward that
        # launched no kernel: the profiler records an op at its entry, so
        # it also records the op at which the non-reentrant checkpoint's
        # early stop ends a recompute (in the backward, in the op's
        # autograd kernel, before any launch), whose FLOPs never ran.  A
        # forward op always counts (the profiler can miss the kernels of
        # its window's first ops)
        for evt in prof.events():
            if evt.device_type == DeviceType.CPU and evt.name in {
                    f"aten::{op}" for op in DOT_OPS}:
                dot_flops_all += evt.flops or 0
                if evt.kernels or not in_backward(evt):
                    dot_flops += evt.flops or 0
    by_name, ranges = {}, {}
    for evt in prof.key_averages():
        # kernels only: an operator's row repeats its kernels' time, and
        # a range's device-side row spans the kernels inside it
        if evt.device_type != DeviceType.CUDA:
            continue
        if evt.key in ranges_of:
            ranges[evt.key] = evt.self_device_time_total / 1e3 / runs
        else:
            by_name[evt.key] = (by_name.get(evt.key, 0.0)
                                + evt.self_device_time_total / 1e3)
    device_ms = sum(by_name.values())
    extra = {"dot_flops_per_run": dot_flops / runs,
             "dot_flops_recorded_per_run": dot_flops_all / runs} \
        if flops else {}
    if device_ms == 0:
        print(f"profile of {what}: the profiler saw no device time "
              f"(not measured)")
        return {"wall_ms_per_run": wall_ms / runs, "device": None, **extra}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    short = {}      # kernels whose names share 80 characters add up
    for k, v in top:
        short[k[:80]] = short.get(k[:80], 0.0) + v / runs
    out = {"wall_ms_per_run": wall_ms / runs,
           "device_ms_per_run": device_ms / runs,
           "device_busy_share": device_ms / wall_ms,
           "kernels_ms_per_run": short,
           "range_spans_ms_per_run": ranges, **extra}
    print(f"profile over {runs} {what}: wall {wall_ms / runs:.4f} ms/run, "
          f"device busy {device_ms / runs:.4f} ms/run "
          f"({100 * device_ms / wall_ms:.1f}% of the wall time)")
    for name, ms in top[:8]:
        print(f"  {ms / runs:9.4f} ms/run  {name[:90]}")
    for name, ms in ranges.items():
        print(f"  {ms:9.4f} ms/run  device-timeline span of {name}")
    return out


def in_backward(evt) -> bool:
    """Whether a profiler event ran inside the autograd engine's
    backward (an ancestor is one of its ``evaluate_function`` ranges)."""
    parent = evt.cpu_parent
    while parent is not None:
        if parent.name.startswith("autograd::engine::evaluate_function"):
            return True
        parent = parent.cpu_parent
    return False


def max_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, bool]:
    err = (got - ref).abs().max().item()
    ok = bool(torch.allclose(got, ref, atol=ATOL, rtol=RTOL))
    return err, ok


def library_conv_transpose(x, w, b, s, p):
    """One cuDNN transposed conv on channels-first tensors (TF32 off): a
    yardstick the port never calls."""
    nd = x.ndim - 2
    fn = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    xn = x.movedim(-1, 1).contiguous()
    wn = w.permute(nd, nd + 1, *range(nd)).contiguous()  # (Cin, Cout, K...)
    return lambda: fn(xn, wn, b, stride=s, padding=p)


def library_conv(x, w, b, s, p):
    """One cuDNN conv on channels-first tensors (TF32 off), the
    yardstick of a kernel launch in SIMD mode."""
    nd = x.ndim - 2
    fn = F.conv2d if nd == 2 else F.conv3d
    xn = x.movedim(-1, 1).contiguous()
    wn = w.permute(nd + 1, nd, *range(nd)).contiguous()  # (Cout, Cin, K...)
    return lambda: fn(xn, wn, b, stride=s, padding=p)


def train_cases(model: str, g_layers, d_layers) -> list[tuple]:
    """Every kernel launch geometry of one adversarial step at batch
    ``BATCH``: (label, part, transposed, x shape, w shape, strides,
    paddings, epilogue, kernel launches per step, dw contractions per
    step).  A layer's ``dx`` is the adjoint op on its output's
    cotangent with swapped weights: a conv for a tconv layer, an
    uncropped pad-0 tconv for a conv layer."""
    from repro_torch.core.dataflow import Epilogue
    from repro_torch.models.gan import (discriminator_epilogues,
                                        generator_epilogues)
    cases = []
    for l, ep in zip(g_layers, generator_epilogues(g_layers)):
        out = tuple((n - 1) * s + k - 2 * p for n, k, s, p in
                    zip(l.in_spatial, l.kernel, l.strides, l.paddings))
        cases += [
            (f"{model} {l.name}", "forward", True,
             (BATCH, *l.in_spatial, l.cin), (*l.kernel, l.cin, l.cout),
             l.strides, l.paddings, ep, 2, 1),
            (f"{model} {l.name} dx", "dx", False, (BATCH, *out, l.cout),
             (*l.kernel, l.cout, l.cin), l.strides, l.paddings, Epilogue(),
             1, 0)]
    for i, (l, ep) in enumerate(zip(d_layers,
                                    discriminator_epilogues(d_layers))):
        check(not l.transposed, f"{model} {l.name} is not a conv")
        q = tuple((n + 2 * p - k) // s + 1 for n, k, s, p in
                  zip(l.in_spatial, l.kernel, l.strides, l.paddings))
        cases += [
            (f"{model} {l.name}", "forward", False,
             (BATCH, *l.in_spatial, l.cin), (*l.kernel, l.cin, l.cout),
             l.strides, l.paddings, ep, 3, 2),
            (f"{model} {l.name} dx", "dx", True, (BATCH, *q, l.cout),
             (*l.kernel, l.cout, l.cin), l.strides, (0,) * len(q),
             Epilogue(), 1 if i == 0 else 3, 0)]
    return cases


def train_geometries(card, dev, wrappers, kernel_errs, tol_used) -> dict:
    """Each launch geometry of the train step, kernel against plain on
    the card (the TF32 control on the geometries of ``TF32_CONTROL``),
    then timed beside its bound, its plain version, the whole op and one
    cuDNN call of the same geometry, with the layer's dw contraction;
    returns the rows by kernel name."""
    from repro_torch.configs.gans import GAN_MODELS
    from repro_torch.core import dataflow as tdf
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(4321)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(dev)

    rows = {}
    for name, model in (("ganax_conv", "dcgan"), ("ganax_conv3d", "3dgan")):
        kernel, plain = wrappers[name]
        timing = dict(warmup=3, runs=15) if name == "ganax_conv" \
            else dict(warmup=1, runs=5)
        rows[name] = []
        controls = []
        for (label, part, tr, xs, ws, s, p, ep, launches,
             dw_launches) in train_cases(model, *GAN_MODELS[model]):
            nd = len(s)
            x = rand(*xs)
            w = rand(*ws, scale=(math.prod(ws[:nd]) * ws[-2]) ** -0.5)
            b = rand(ws[-1], scale=0.1) if ep.bias else None
            act = ep.activation
            with torch.no_grad():
                operands = ops.kernel_operands(x, w, s, p, transposed=tr)
                got = kernel(**operands, bias=b, activation=act,
                             leaky_slope=ep.leaky_slope)
                ref = plain(**operands, bias=b, activation=act,
                            leaky_slope=ep.leaky_slope)
                torch.cuda.synchronize()
                err, ok = max_err(got, ref)
                share = tol_share(got, ref)
                route = route_of(operands)
                kernel_errs[name].append(err)
                tol_used[name] = max(tol_used[name], share)
                print(f"{name} vs plain  {label:18s} x {tuple(xs)} "
                      f"[{route}] max_abs_err {err:.3e} (atol=rtol={ATOL:g}"
                      f"; worst output at {share:.4f} of its tolerance) "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok and bool(torch.isfinite(got).all()),
                      f"{label}: {name} disagrees with its plain version")
                if label in TF32_CONTROL[name]:
                    c_err, c_share, c_ok = tf32_control(operands, b, ep, ref)
                    controls.append(not c_ok)
                    verdict = ("PASSES the gate" if c_ok
                               else "fails the gate (as it must)")
                    print(f"TF32 control {label}: the plain version with "
                          f"TF32 matmuls vs plain, max_abs_err {c_err:.3e}, "
                          f"worst output at {c_share:.2f} of its tolerance: "
                          f"{verdict}")
                del got, ref
                op = ops.ganax_conv_transpose if tr else ops.ganax_conv
                ms = time_ms(lambda: kernel(**operands, bias=b,
                                            activation=act), **timing)
                plain_ms = time_ms(lambda: plain(**operands, bias=b,
                                                 activation=act), **timing)
                op_ms = time_ms(lambda: op(x, w, s, p, bias=b, epilogue=ep),
                                **timing)
                library = library_conv_transpose if tr else library_conv
                library_ms = time_ms(library(x, w, b, s, p), **timing)
                # the same two as the device runs them, the host's time
                # to issue each call out
                dev_runs = dict(runs=timing["runs"])
                dev_ms = device_ms(lambda: kernel(**operands, bias=b,
                                                  activation=act), **dev_runs)
                library_dev_ms = device_ms(library(x, w, b, s, p), **dev_runs)
                bound_ms, bound_by, flops, nbytes, fp32_ms = bound(operands,
                                                                   b)
                row = dict(layer=label, part=part, launches_per_step=launches,
                           route=route, ms=ms, device_ms=dev_ms,
                           library_device_ms=library_dev_ms,
                           plain_ms=plain_ms, op_ms=op_ms,
                           library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by, bound_fp32_ms=fp32_ms,
                           tol_share=share, gflop=flops / 1e9,
                           mbytes=nbytes / 1e6, dw_per_step=dw_launches)
                if part == "forward":
                    y_sp = op(x, w, s, p).shape[1:-1]
                    g = rand(BATCH, *y_sp, ws[-1])
                    wgrad = tdf._tconv_wgrad if tr else tdf._conv_wgrad
                    dw_ms = time_ms(lambda: wgrad(x, g, ws[:nd], s, p),
                                    **timing)
                    dw_bytes = 4 * (x.numel() + g.numel() + w.numel())
                    dw_bound = max(flops / PEAK_FP32_FLOPS,
                                   dw_bytes / PEAK_HBM_BYTES) * 1e3
                    row.update(dw_ms=dw_ms, dw_bound_ms=dw_bound)
                    del g
            rows[name].append(row)
            lib = ("conv_transpose" if tr else "conv") + f"{nd}d"
            dw = (f"; dw {row['dw_ms']:.4f} ms (bound "
                  f"{row['dw_bound_ms']:.4f})" if part == "forward" else "")
            print(f"train time {label} [{route}]: {launches}/step, kernel "
                  f"{ms:.4f} ms (device {row['device_ms']:.4f}), plain "
                  f"{plain_ms:.4f} ms, whole op {op_ms:.4f} ms, {lib} "
                  f"{library_ms:.4f} ms (device "
                  f"{row['library_device_ms']:.4f}), bound "
                  f"{bound_ms:.4f} ms ({bound_by}; FP32 bound "
                  f"{fp32_ms:.4f} ms; {flops / 1e9:.2f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB){dw} [{card}]")
            del x, w, b, operands
        check(any(controls), f"{name}: the TF32 control passed the gate on "
              f"every geometry of {TF32_CONTROL[name]}: the gate cannot tell "
              f"3xTF32 from 1xTF32")
        r = rows[name]
        per_step = {key: sum(row[key] * row["launches_per_step"] for row in r)
                    for key in ("ms", "bound_ms", "library_ms",
                                "bound_fp32_ms", "device_ms",
                                "library_device_ms")}
        by_route = {}
        for row in r:
            by_route.setdefault(row["route"], [0, 0.0])
            by_route[row["route"]][0] += row["launches_per_step"]
            by_route[row["route"]][1] += row["ms"] * row["launches_per_step"]
        per_step["by_route"] = {k: dict(launches=n, ms=t)
                                for k, (n, t) in by_route.items()}
        per_step["dw_ms"] = sum(row.get("dw_ms", 0.0) * row["dw_per_step"]
                                for row in r)
        per_step["dw_bound_ms"] = sum(row.get("dw_bound_ms", 0.0)
                                      * row["dw_per_step"] for row in r)
        print(f"{model} train step, per step: {sum(row['launches_per_step'] for row in r)} "
              f"{name} launches, kernels {per_step['ms']:.3f} ms (bound "
              f"{per_step['bound_ms']:.3f} ms, share "
              f"{per_step['bound_ms'] / per_step['ms']:.3f}; FP32 bound "
              f"{per_step['bound_fp32_ms']:.3f} ms; cuDNN "
              f"{per_step['library_ms']:.3f} ms, kernels/cuDNN "
              f"{per_step['ms'] / per_step['library_ms']:.3f}); as the "
              f"device runs them: kernels {per_step['device_ms']:.3f} ms, "
              f"cuDNN {per_step['library_device_ms']:.3f} ms (share of the "
              f"bound {per_step['bound_ms'] / per_step['device_ms']:.3f}); "
              f"dw contractions {per_step['dw_ms']:.3f} ms (bound "
              f"{per_step['dw_bound_ms']:.3f} ms) [{card}]")
        for k, v in sorted(per_step["by_route"].items()):
            print(f"  route {k}: {v['launches']} launches a step, "
                  f"{v['ms']:.3f} ms")
        edge = [row for row in r if row["layer"].split(" ", 1)[1]
                in ("g4", "g4 dx", "d1", "d1 dx")]
        for key in ("ms", "device_ms", "library_ms", "library_device_ms"):
            per_step[f"edge_{key}"] = sum(row[key] * row["launches_per_step"]
                                          for row in edge)
        print(f"  the image/volume-facing launches (g4, g4 dx, d1, d1 dx: "
              f"{sum(row['launches_per_step'] for row in edge)} a step): "
              f"{per_step['edge_ms']:.3f} ms (device "
              f"{per_step['edge_device_ms']:.3f}), cuDNN "
              f"{per_step['edge_library_ms']:.3f} ms (device "
              f"{per_step['edge_library_device_ms']:.3f})")
        rows[name] = dict(rows=r, per_step=per_step)
    return rows


def train_paths(dev, wrappers) -> dict:
    """The training paths: full-width DCGAN through the quickstart entry
    point (TrainLoop, checkpoints, then a served batch), and full-width
    3D-GAN through the same training code; each driven with every launch
    counter at 0 just before and read just after.  Returns the launches
    by kernel, and by kernel and route; each kernel's path must run all
    of ``ROUTES``."""
    from repro_torch import quickstart
    from repro_torch.models.gan import GanConfig

    def zero():
        for kernel, _ in wrappers.values():
            kernel.launches = 0
            if hasattr(kernel, "launches_by_route"):
                kernel.launches_by_route.clear()

    def counts():
        torch.cuda.synchronize()
        return {k: wrappers[k][0].launches for k in wrappers}

    def finite(loop, model):
        check(bool(loop.metrics_history), f"{model}: no losses logged")
        for m in loop.metrics_history:
            check(all(math.isfinite(v) for v in m.values()),
                  f"{model} step {m['step']}: a loss is not finite: {m}")

    zero()
    loop, server = quickstart.main([
        "--steps", str(TRAIN_STEPS), "--batch", str(BATCH),
        "--channel-scale", "1", "--device", "cuda"])
    c = counts()
    served = 4 * server.batches_served
    print(f"dcgan quickstart: {loop.steps} steps, {loop.checkpoints} "
          f"checkpoint(s), {loop.restarts} restarts; launches {c} = "
          f"{LAUNCHES_PER_STEP} x {TRAIN_STEPS} steps + {served} serving")
    check(loop.steps == TRAIN_STEPS and loop.restarts == 0
          and loop.checkpoints >= 1, f"dcgan: the loop ran {loop.steps} "
          f"steps, {loop.checkpoints} checkpoints, {loop.restarts} restarts")
    finite(loop, "dcgan")
    check(c["ganax_conv"] == LAUNCHES_PER_STEP * TRAIN_STEPS + served,
          f"dcgan training: {c['ganax_conv']} ganax_conv launches, "
          f"expected {LAUNCHES_PER_STEP} per step")
    check(c["ganax_conv3d"] == 0, f"dcgan launched the 3-D kernel: {c}")
    out = {"ganax_conv": c["ganax_conv"]}
    routes = {"ganax_conv": routes_launched(wrappers)["ganax_conv"]}

    zero()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        loop3, _ = quickstart.train(
            GanConfig("3dgan"), steps=TRAIN3D_STEPS, batch=BATCH, lr=4e-3,
            ckpt_dir=ckpt_dir, device=dev, ckpt_every=TRAIN3D_STEPS,
            log_every=1)
    c = counts()
    print(f"3dgan training: {loop3.steps} steps, {loop3.checkpoints} "
          f"checkpoint(s); launches {c} = {LAUNCHES_PER_STEP} x "
          f"{TRAIN3D_STEPS} steps")
    finite(loop3, "3dgan")
    check(c["ganax_conv3d"] == LAUNCHES_PER_STEP * TRAIN3D_STEPS,
          f"3dgan training: {c['ganax_conv3d']} ganax_conv3d launches, "
          f"expected {LAUNCHES_PER_STEP} per step")
    check(c["ganax_conv"] == 0, f"3dgan launched the 2-D kernel: {c}")
    out["ganax_conv3d"] = c["ganax_conv3d"]
    routes["ganax_conv3d"] = routes_launched(wrappers)["ganax_conv3d"]
    for name, by_route in routes.items():
        print(f"{name} training path, launches by route: {by_route}")
        check(sum(by_route.values()) == out[name]
              and all(by_route.get(k, 0) > 0 for k in ROUTES),
              f"{name}'s training path did not run every route {ROUTES}: "
              f"{by_route}")
    return out, routes


# (model, warm-up steps, timed steps, profiled steps)
STEP_TIMING = (("dcgan", 3, 10, 2), ("3dgan", 1, 3, 1))


def _train_nets(model: str, dev, backend=None, dtype="float32"):
    """Model ``model``'s generator and discriminator from seed 0 (through
    ``backend``, at storage ``dtype``), and one batch's latents and
    reals."""
    from repro_torch.models.gan import (Discriminator, GanConfig, Generator,
                                        init_gan)
    from repro_torch.quickstart import make_batch_fn
    cfg = GanConfig(model, backend=backend, dtype=dtype)
    g, d = init_gan(cfg, torch.Generator().manual_seed(0), dev)
    batch = make_batch_fn(cfg, BATCH, dev)(0)
    return Generator(cfg, g, dev), Discriminator(cfg, d, dev), batch


def _step_fn(gen, disc, batch, lr=0.02):
    """One adversarial step (D, then G, SGD), recording ``events[1]``
    between the two where given."""
    from repro_torch.train.loop import (discriminator_grads,
                                        generator_grads, sgd_update)
    z, real = batch["z"], batch["real"]

    def step(events=None):
        dl, dg = discriminator_grads(gen, disc, z, real)
        sgd_update(disc.params, dg, lr)
        if events:
            events[1].record()
        gl, gg = generator_grads(gen, disc, z)
        sgd_update(gen.params, gg, lr)
    return step


def train_step_times(card, dev) -> dict:
    """Per model: the D step, the G step and the whole step at batch
    ``BATCH`` through the kernels, timed with CUDA events (medians).  Run
    first in the process: the DCGAN step is bound by the host, which a
    profiler session or the other phases before it leave slower (on the
    card: 33 ms alone, 44-57 ms after them)."""
    out = {}
    for model, warmup, runs, _ in STEP_TIMING:
        step = _step_fn(*_train_nets(model, dev))
        times = []
        for i in range(warmup + runs):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            step(ev)
            ev[2].record()
            ev[2].synchronize()
            if i >= warmup:
                times.append((ev[0].elapsed_time(ev[1]),
                              ev[1].elapsed_time(ev[2]),
                              ev[0].elapsed_time(ev[2])))
        d_ms, g_ms, step_ms = (statistics.median(t) for t in zip(*times))
        print(f"{model} train step at batch {BATCH}: D step {d_ms:.3f} ms, "
              f"G step {g_ms:.3f} ms, whole step {step_ms:.3f} ms (median of "
              f"{runs}) [{card}]")
        out[model] = dict(d_step_ms=d_ms, g_step_ms=g_ms, step_ms=step_ms,
                          steps_timed=runs)
        del step
        torch.cuda.empty_cache()
    return out


def train_parity_and_profiles(card, dev, times: dict) -> dict:
    """Per model: one step's losses and every gradient through the kernel
    against the same step through ganax-plain on the card (and, as the
    control, through the polyphase oracle); then a profile of whole
    steps.  Returns them with ``times`` (``train_step_times``) merged."""
    from repro_torch.train.loop import discriminator_grads, generator_grads
    out = {}
    for model, _, _, prof_runs in STEP_TIMING:
        res, nets = {}, None
        for backend in (None, "ganax-plain", "polyphase"):
            gen, disc, batch = _train_nets(model, dev, backend)
            dl, dg = discriminator_grads(gen, disc, batch["z"], batch["real"])
            gl, gg = generator_grads(gen, disc, batch["z"])
            res[backend] = (dl, gl, {**{f"d.{k}": v for k, v in dg.items()},
                                     **{f"g.{k}": v for k, v in gg.items()}})
            if backend is None:
                nets = (gen, disc, batch)
        ((dl, gl, grads), (ref_dl, ref_gl, ref_grads),
         (_, _, ctl_grads)) = res.values()
        loss_err = max(abs(float(dl - ref_dl)), abs(float(gl - ref_gl)))
        print(f"{model} step vs ganax-plain step: d_loss {float(dl):.6f} / "
              f"{float(ref_dl):.6f}, g_loss {float(gl):.6f} / "
              f"{float(ref_gl):.6f}")
        check(loss_err <= LOSS_TOL * max(1.0, abs(float(ref_dl)),
                                         abs(float(ref_gl))),
              f"{model}: the losses disagree with ganax-plain by {loss_err}")
        def rel(a, b):
            return float((a - b).norm() / b.norm().clamp_min(1e-30))

        worst, worst_ctl, worst_name = 0.0, 0.0, None
        for k, ref in ref_grads.items():
            err, ctl = rel(grads[k], ref), rel(ctl_grads[k], ref)
            if err > worst:
                worst, worst_name = err, k
            worst_ctl = max(worst_ctl, ctl)
            check(bool(torch.isfinite(grads[k]).all()) and err <= GRAD_TOL,
                  f"{model} gradient {k} disagrees with ganax-plain: "
                  f"||a-b||/||b|| {err:.3e} (polyphase control {ctl:.3e})")
        print(f"{model}: {len(ref_grads)} gradients vs ganax-plain, worst "
              f"||a-b||/||b|| {worst:.3e} at {worst_name} (tolerance "
              f"{GRAD_TOL:g}); polyphase control vs ganax-plain worst "
              f"{worst_ctl:.3e} ok")
        del res, grads, ref_grads, ctl_grads
        prof = profile(_step_fn(*nets), prof_runs, f"{model} train steps")
        out[model] = dict(times[model], worst_grad_rel_err=worst,
                          worst_grad_rel_err_control=worst_ctl,
                          loss_err=loss_err, profile=prof)
        del nets
        torch.cuda.empty_cache()
    return out


def flash_cases() -> list[tuple]:
    """The kernels' geometries held against their plain version: (label,
    B, S, T, H, hd, causal, dtype, scale, softcap), q and k drawn N(0,
    scale^2), the scores soft-capped at ``softcap`` when it is > 0.
    Gemma-7B's heads at three prompt lengths, causal, bf16 (the wgmma
    kernel) and f32 (the FFMA kernel); one full (non-causal) case; a
    ragged B = 2 case (S and T not multiples of the tiles, a kv tail
    shorter than one TMA box); Qwen's 40 heads of 128 at a small S,
    causal and full; the five geometries of tests/test_kernels_flash.py;
    the llm_train phase's two (its steps' B = 2 x 2048 in bf16, its f32
    gate's 1 x 1024); Hymba-1.5B's 25 heads of 64 in bf16 (the wgmma
    kernel's hd-64 instance) at its longest served prompt and its train
    steps' geometry, and a ragged B = 2 full case; HuBERT-XLarge's 16
    heads of 80, full, in bf16 (the wgmma kernel's hd-80 instance) and
    f32 at its longest utterance, its train steps' geometry, and a
    ragged B = 2 causal case; the first again at
    FLASH_BIG_SCORES; the soft-cap instances of both kernels
    (SOFTCAP_GEOMETRIES: Gemma3's global geometry in bf16, the f32
    gate's, hd 64 in bf16), each at a cap that bites; and the
    split instances (SPLIT_CASES: MiniCPM3-4B's q·k 96 against v 64, on
    the wgmma kernel in bf16 and the FFMA kernel in f32, and its tiny
    preset's 48 against 32 on the FFMA kernel).  Each case ends with v's
    head dim ``dv`` (``hd`` but for the split instances)."""
    cases = []
    for s in (17, 1000, 2048):
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((f"gemma S={s}", 1, s, s, 16, 256, True, dtype))
    cases.append(("gemma S=1000 full", 1, 1000, 1000, 16, 256, False,
                  torch.bfloat16))
    cases.append(("gemma ragged B=2", 2, 333, 197, 16, 256, True,
                  torch.bfloat16))
    cases.append(("qwen S=300", 1, 300, 300, 40, 128, True, torch.bfloat16))
    cases.append(("qwen S=300 full", 1, 300, 300, 40, 128, False,
                  torch.bfloat16))
    for b, s, h, hd, causal in ((2, 128, 3, 32, True), (2, 128, 3, 32, False),
                                (1, 256, 2, 64, True), (1, 64, 4, 16, True),
                                (2, 96, 1, 8, True)):
        cases.append((f"pallas case {b}x{s}x{h}x{hd}", b, s, s, h, hd, causal,
                      torch.float32))
    cases.append(("gemma train B=2", 2, 2048, 2048, 16, 256, True,
                  torch.bfloat16))
    cases.append(("gemma train f32", 1, 1024, 1024, 16, 256, True,
                  torch.float32))
    # Hymba-1.5B's global layers (25 heads of 64, GQA expanded): the
    # longest prompt the ssm phase serves (seed 0 draws 3814 in
    # SSM_PROMPT_LENS) and its train steps' (SSM_TRAIN_BATCH)
    cases.append(("hymba S=3814", 1, 3814, 3814, 25, 64, True,
                  torch.bfloat16))
    cases.append(("hymba train B=2", 2, 2048, 2048, 25, 64, True,
                  torch.bfloat16))
    cases.append(("hd64 ragged B=2 full", 2, 333, 197, 25, 64, False,
                  torch.bfloat16))
    # HuBERT-XLarge's 16 heads of 80, full: a 1500-frame utterance (the
    # top of HUBERT_FRAMES) on both kernels' hd-80 instances, its train
    # steps' B = 2 x 2048, and a ragged causal B = 2 case
    for dtype in (torch.bfloat16, torch.float32):
        cases.append(("hubert S=1500 full", 1, 1500, 1500, 16, 80, False,
                      dtype))
    cases.append(("hubert train B=2 full", 2, 2048, 2048, 16, 80, False,
                  torch.bfloat16))
    cases.append(("hd80 ragged B=2 causal", 2, 333, 197, 16, 80, True,
                  torch.bfloat16))
    cases = [c + (1.0,) for c in cases]
    cases.append(("gemma train big", 2, 2048, 2048, 16, 256, True,
                  torch.bfloat16, FLASH_BIG_SCORES))
    cases = [c + (0.0,) for c in cases]
    for label, b, s, h, hd, dtype in SOFTCAP_GEOMETRIES:
        for scale, cap in SOFTCAP_BITES:
            cases.append((f"{label} cap {cap:g}", b, s, s, h, hd, True,
                          dtype, scale, cap))
    cases = [c + (c[5],) for c in cases]
    for (dk, dv), h in SPLIT_HEADS.items():
        for dtype in (torch.bfloat16, torch.float32):
            for label, b, s, t, causal, cap in SPLIT_CASES:
                cases.append((f"{dk}/{dv} {label}", b, s, t, h, dk, causal,
                              dtype, 1.0, cap, dv))
    return cases


def split_instance(dtype, dk: int, dv: int, variant: str | None = None
                   ) -> str:
    """The kernels line's name of the instance at the head dims (dk, dv)
    of ``variant``'s kernel (default: the one the variant table names):
    the line lists the split head dims and hd 64 by instance."""
    from repro_torch.kernels.flash_attention import kernel_variant
    variant = variant or kernel_variant(dtype, dk, dv)
    return (f"flash_attention_{variant}_{dk}x{dv}_"
            f"{'bf16' if dtype == torch.bfloat16 else 'f32'}")


def scaled_by_dv(attend):
    """``attend`` scoring by ``dv**-0.5`` in place of ``dk**-0.5`` (q
    scaled by ``(dk / dv)**0.5``): the planted fault of the split head
    dims, the one an MLA port is likeliest to make."""
    def faulty(q, k, v, causal=True, **cap):
        return attend(q * (q.shape[3] / v.shape[3]) ** 0.5, k, v,
                      causal=causal, **cap)
    return faulty


def flash_operands(b, s, t, h, hd, dtype, dev, seed, scale=1.0, dv=None):
    """q, k (B, S|T, H, hd) and v (B, T, H, dv, default hd) of ``dtype``
    on ``dev``, drawn from ``seed``: q and k N(0, scale^2), v N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn(shape, generator=gen) * c).to(dev, dtype)
            for shape, c in (((b, s, h, hd), scale), ((b, t, h, hd), scale),
                             ((b, t, h, dv or hd), 1.0))]


def flash_geometries(dev) -> dict[str, list[float]]:
    """Each geometry of ``flash_cases``: the kernel that the wrapper picks
    against its plain version on the card, and at a geometry that the
    wgmma kernel takes and the FFMA kernel is built for too (bf16 hd 64
    and (96, 64)), the FFMA kernel's instance (called through
    ``flash_attention_ffma``), the yardstick.  Returns the max abs errors
    by variant, and by instance (``split_instance``) for the split head
    dims, each of which must fail the gate scaled by ``dv**-0.5``, for
    bf16 hd 64 and for hd 80."""
    from repro_torch.kernels.flash_attention import (FFMA_GEOMETRIES,
                                                     flash_attention_cuda,
                                                     flash_attention_ffma,
                                                     flash_attention_plain,
                                                     kernel_variant)
    errs = {variant: [] for variant in FLASH_VARIANTS}
    for i, (label, b, s, t, h, hd, causal, dtype, scale, cap, dv) in \
            enumerate(flash_cases()):
        q, k, v = flash_operands(b, s, t, h, hd, dtype, dev, seed=100 + i,
                                 scale=scale, dv=dv)
        variant = kernel_variant(dtype, hd, dv)
        got = flash_attention_cuda(q, k, v, causal=causal, softcap=cap)
        ref = flash_attention_plain(q, k, v, causal=causal, softcap=cap)
        torch.cuda.synchronize()
        atol, rtol = FLASH_TOL[dtype]
        err = (got.float() - ref.float()).abs().max().item()
        ok = bool(torch.allclose(got.float(), ref.float(), atol=atol,
                                 rtol=rtol)) \
            and bool(torch.isfinite(got).all()) \
            and got.shape == (b, s, h, dv)
        by_instance = dv != hd or hd == 80 or \
            (dtype, hd) == (torch.bfloat16, 64)
        key = split_instance(dtype, hd, dv) if by_instance else variant
        errs.setdefault(key, []).append(err)
        print(f"flash_attention ({variant}) vs plain  {label:18s} B={b} S={s} "
              f"T={t} H={h} hd={hd}{f'/{dv}' if dv != hd else ''} "
              f"{'causal' if causal else 'full'} "
              f"{str(dtype).removeprefix('torch.')}"
              f"{f' q,k x{scale:g}' if scale != 1 else ''}"
              f"{f' softcap {cap:g}' if cap else ''} max_abs_err "
              f"{err:.3e} (atol {atol:g}, rtol {rtol:g}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{label}: flash_attention disagrees with its plain version")
        if cap:
            # the planted fault: the kernel without its cap must fail
            bad = flash_attention_cuda(q, k, v, causal=causal)
            fault = (bad.float() - ref.float()).abs().max().item()
            caught = not torch.allclose(bad.float(), ref.float(), atol=atol,
                                        rtol=rtol)
            print(f"  planted fault, the kernel at softcap 0 vs plain at "
                  f"{cap:g}: max_abs_err {fault:.3e} "
                  f"{'fails the gate, as it must' if caught else 'PASSES'}")
            check(caught, f"{label}: the gate cannot tell a kernel that "
                  f"ignores the soft-cap")
            del bad
        # the instance the wrapper picked, and the FFMA kernel's where the
        # wgmma kernel took the geometry; at the split head dims, each
        # scaled by dv**-0.5 must fail the gate
        attends = {variant: flash_attention_cuda}
        if variant == "wgmma" and (dtype, hd, dv) in FFMA_GEOMETRIES:
            attends["ffma"] = flash_attention_ffma
        for name, attend in attends.items():
            if name != variant:
                got = attend(q, k, v, causal=causal, softcap=cap)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                ok = bool(torch.allclose(got.float(), ref.float(),
                                         atol=atol, rtol=rtol)) \
                    and got.shape == (b, s, h, dv)
                errs.setdefault(split_instance(dtype, hd, dv, name),
                                []).append(err)
                print(f"  the {name} instance, called directly: max_abs_err "
                      f"{err:.3e} {'ok' if ok else 'FAIL'}")
                check(ok, f"{label}: the {name} instance disagrees with "
                      f"its plain version")
            if dv == hd:
                continue
            bad = scaled_by_dv(attend)(q, k, v, causal=causal, softcap=cap)
            fault = (bad.float() - ref.float()).abs().max().item()
            caught = not torch.allclose(bad.float(), ref.float(), atol=atol,
                                        rtol=rtol)
            print(f"  planted fault, the {name} kernel scaled by dv^-0.5 in "
                  f"place of dk^-0.5: max_abs_err {fault:.3e} "
                  f"{'fails the gate, as it must' if caught else 'PASSES'}")
            check(caught, f"{label}: the gate cannot tell a {name} kernel "
                  f"scaled by dv^-0.5")
            del bad
    return errs


def flash_bound(b, s, t, h, hd, dtype, causal) -> dict:
    """The least time the card could take for one attention call: the
    larger of its operations' time and its bytes' time (q, k, v read
    once and the output written once).  Operations: 2 hd FLOPs of q.k
    and 2 hd of p.v for each (query, key) pair the mask lets through.
    With bf16 operands both products run on the bf16 tensor cores with
    f32 sums at the function's own precision: q.k once (the hd**-0.5
    scale goes on the f32 scores), and p.v twice, because p is f32 and
    enters as two bf16 terms (p_hi + p_lo, see
    csrc/flash_attention_sm90.cu); all three at the bf16 tensor-core
    rate.  An f32 call counts both products at the FP32 FFMA rate.
    ``ops_ms_fp32_pv`` is the bound that counted a bf16 call's p.v at the
    FP32 rate (before the wgmma kernel), kept for comparison."""
    pairs = sum(min(i + 1, t) for i in range(s)) if causal else s * t
    half = 2.0 * b * h * hd * pairs
    nbytes = torch.finfo(dtype).bits // 8 * b * h * hd * (2 * s + 2 * t)
    if dtype == torch.bfloat16:
        tc_flops = 3 * half
        ops_ms = tc_flops / PEAK_BF16_TC_FLOPS * 1e3
        old_ms = (half / PEAK_BF16_TC_FLOPS + half / PEAK_FP32_FLOPS) * 1e3
    else:
        tc_flops = 0.0
        ops_ms = old_ms = 2 * half / PEAK_FP32_FLOPS * 1e3
    return dict(ops_ms=ops_ms, hbm_ms=nbytes / PEAK_HBM_BYTES * 1e3,
                flops=2 * half, tc_flops=tc_flops, ops_ms_fp32_pv=old_ms)


def sm_fill(b, s, h, sms) -> tuple[int, int, float]:
    """(blocks, waves, fill) of one launch of the wgmma kernel on a card
    of ``sms`` SMs: its grid is B*H times its q tiles of 128 rows, one
    block an SM (its shared memory), so it runs in ceil(blocks / sms)
    waves and fills blocks / (waves * sms) of the SMs' slots."""
    from repro_torch.kernels.flash_attention import WGMMA_BLOCK_Q
    blocks = b * h * -(-s // WGMMA_BLOCK_Q)
    waves = -(-blocks // sms)
    return blocks, waves, blocks / (waves * sms)


def attention_f64(q, k, v, causal: bool, window: int = 0) -> torch.Tensor:
    """Attention of the same q, k, v (B, S, H, hd) in float64, not
    rounded: the exact value the kernels and their plain version round.
    ``window`` > 0 keeps only keys less than ``window`` before the
    query."""
    sc = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double())
    sc = sc * q.shape[3] ** -0.5
    if causal:
        d = (torch.arange(q.shape[1], device=q.device)[:, None]
             - torch.arange(k.shape[1], device=q.device)[None])
        keep = (d >= 0) & (d < window) if window > 0 else d >= 0
        sc = sc.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1),
                        v.double())


def planted_fault(fault: str):
    """The kernel's function in plain PyTorch with one fault planted (see
    PLANTED_FAULTS): each query row drops the kv tile that holds its
    diagonal, a tile of the kernel that runs q's dtype at its head dims,
    or the causal mask keeps q > k in place of q >= k."""
    from repro_torch.kernels.flash_attention import (NEG_INF,
                                                     kernel_block_k)

    def attend(q, k, v, causal=True):
        hd = q.shape[3]
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None]
        if fault == "strict causal mask":
            keep = qpos > kpos
        else:
            bk = kernel_block_k(hd, q.dtype, v.shape[3])
            keep = (qpos >= kpos) & (kpos // bk != qpos // bk)
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float() * hd ** -0.5,
                          k.float())
        p = torch.softmax(torch.where(keep, sc, NEG_INF), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    check(fault in PLANTED_FAULTS, f"no planted fault '{fault}'")
    return attend


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """Inside: ``module.name`` is ``fn``."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def flash_attention_as(fn):
    """Inside: the model's flash attention calls ``fn(q, k, v, causal=)``
    in place of the kernel's wrapper on the card."""
    from repro_torch.models import attention
    return swapped(attention, "flash_attention_cuda", fn)


def recording(attend, calls: list):
    """``attend`` that appends (q, k, v, causal, out) to ``calls``."""
    def recorded(q, k, v, causal=True, **cap):
        o = attend(q, k, v, causal=causal, **cap)
        calls.append((q, k, v, causal, o))
        return o
    return recorded


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, in f32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def serve_requests(cfg, params, ecfg, prompts, impl, wrappers, dev):
    """``prompts`` served through ``DecodeEngine.run`` at
    ``attn_impl=impl``, every kernel's count at 0 just before and read
    just after: the requests, each one's (queued, prefill) seconds, each
    decode step's (seconds, active slots), the wall seconds, the
    counts."""
    from repro_torch.models import transformer as tr
    from repro_torch.serve.engine import DecodeEngine, Request
    engine = DecodeEngine(cfg, params, ecfg, tr.RunFlags(attn_impl=impl),
                          seed=0, device=dev)
    reqs = [Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
    admits, steps, start = {}, [], [0.0]
    admit, step = engine.try_admit, engine.step

    def timed_admit(req):
        # try_admit reads the first token back: it ends synchronised
        t = time.perf_counter()
        ok = admit(req)
        if ok:
            admits[req.rid] = (t - start[0], time.perf_counter() - t)
        return ok

    def timed_step():
        n = int(engine.active.sum())
        t = time.perf_counter()
        step()                      # reads the tokens back
        steps.append((time.perf_counter() - t, n))

    engine.try_admit, engine.step = timed_admit, timed_step
    for kernel, _ in wrappers.values():
        kernel.launches = 0
    start[0] = time.perf_counter()
    engine.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - start[0]
    counts = {k: wrappers[k][0].launches for k in wrappers}
    # the timed wrappers hold the engine's own methods: drop them, or the
    # cycle keeps the engine, its cache and the parameters alive
    del engine.try_admit, engine.step, engine
    return reqs, admits, steps, wall, counts


def llm_serving(card, dev, wrappers) -> dict:
    """Full-width Gemma-7B through ``DecodeEngine.run`` (every counter at 0
    just before, read just after): TTFT, prefill and decode rates, the
    flash launches; then the kernel path against the naive path on a
    2048-token prompt, profiles of a prefill and of decode steps, and the kernel timed at each
    prompt length beside its bound, its plain version and SDPA; last,
    the f32 check through the FFMA kernel (its counters at 0 just
    before, read just after)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_ffma,
                                                     flash_attention_plain)
    from repro_torch.models import transformer as tr
    from repro_torch.serve.engine import (DecodeEngine, EngineConfig,
                                          Request, _merge_slot_cache)
    from repro_torch.train.checkpoint import tree_leaves
    cfg = get_config(LLM_ARCH)
    out: dict = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tr.init(cfg, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == tr.count_params(cfg), "the parameters miss a spec")
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    print(f"{LLM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}x{cfg.resolved_head_dim} heads, vocab {cfg.vocab}: "
          f"{n_params:,} parameters, {weight_bytes / 1e9:.2f} GB in "
          f"{cfg.dtype}, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator().manual_seed(0)
    lens = torch.randint(LLM_PROMPT_LENS[0], LLM_PROMPT_LENS[1] + 1,
                         (LLM_REQUESTS,), generator=gen).tolist()
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist()
               for n in lens]
    ecfg = EngineConfig(n_slots=LLM_SLOTS, max_len=LLM_MAX_LEN,
                        max_new=LLM_MAX_NEW, temperature=0.0)

    def serve(impl):
        return serve_requests(cfg, params, ecfg, prompts, impl, wrappers,
                              dev)

    # warm up (cuBLAS handles and workspaces, the kernel's library): one
    # short prefill and one decode step, before the counted run
    warm = DecodeEngine(cfg, params, dataclasses.replace(ecfg, n_slots=1),
                        seed=0, device=dev)
    warm.try_admit(Request(rid=-1, prompt=prompts[0][:LLM_PROMPT_LENS[0]]))
    warm.step()
    del warm
    reqs, admits, steps, wall, counts = serve("flash")
    n_launches = cfg.n_layers * LLM_REQUESTS
    check(counts["flash_attention"] == n_launches
          and counts["flash_attention_wgmma"] == n_launches,
          f"{counts} flash_attention launches for {LLM_REQUESTS} prefills "
          f"of {cfg.n_layers} layers, all through the wgmma kernel")
    check(all(c == 0 for k, c in counts.items()
              if k not in ("flash_attention", "flash_attention_wgmma")),
          f"the LLM path launched another kernel: {counts}")
    for r in reqs:
        check(r.done and len(r.generated) == LLM_MAX_NEW
              and all(0 <= t < cfg.vocab for t in r.generated),
              f"request {r.rid}: done {r.done}, {len(r.generated)} tokens, "
              f"{r.generated[:8]}")
    prefill_s = sum(d for _, d in admits.values())
    decode_s = sum(d for d, _ in steps)
    decode_tokens = sum(n for _, n in steps)
    step_ms = statistics.median(d * 1e3 for d, _ in steps)
    print(f"{LLM_ARCH} served {LLM_REQUESTS} requests ({sum(lens)} prompt "
          f"tokens, {LLM_MAX_NEW} new each) in {wall:.3f} s through "
          f"{LLM_SLOTS} slots: {counts['flash_attention']} flash_attention "
          f"launches = {cfg.n_layers} x {LLM_REQUESTS} prefills, "
          f"{counts['flash_attention_wgmma']} of them through the wgmma "
          f"kernel [{card}]")
    for r in sorted(reqs, key=lambda r: len(r.prompt)):
        queued, pre = admits[r.rid]
        print(f"  request {r.rid:2d}: prompt {len(r.prompt):4d} tokens, "
              f"prefill {pre * 1e3:9.3f} ms, time to first token "
              f"{(queued + pre) * 1e3:9.3f} ms")
    print(f"prefill: {sum(lens)} tokens in {prefill_s:.3f} s = "
          f"{sum(lens) / prefill_s:.1f} tokens/s; decode: {len(steps)} "
          f"engine steps, median {step_ms:.3f} ms a step, {decode_tokens} "
          f"tokens in {decode_s:.3f} s = {decode_tokens / decode_s:.1f} "
          f"tokens/s (HBM bound of a step's weights "
          f"{weight_bytes / PEAK_HBM_BYTES * 1e3:.3f} ms) [{card}]")
    out.update(
        arch=LLM_ARCH, params=n_params, weight_gb=weight_bytes / 1e9,
        prompt_lens=lens, wall_s=wall, launches=counts["flash_attention"],
        requests=[dict(rid=r.rid, prompt=len(r.prompt),
                       prefill_ms=admits[r.rid][1] * 1e3,
                       ttft_ms=sum(admits[r.rid]) * 1e3) for r in reqs],
        prefill_tokens_per_s=sum(lens) / prefill_s, decode_steps=len(steps),
        decode_step_ms_median=step_ms,
        decode_tokens_per_s=decode_tokens / decode_s)

    # the kernel path against the naive path and against the kernel's
    # plain version, on one 2048-token prompt: prefill and first decode
    tokens = torch.randint(0, cfg.vocab, (1, LLM_PROMPT_LENS[1]),
                           generator=gen).to(dev)

    def prefill_and_decode(c, p, impl):
        flags = tr.RunFlags(attn_impl=impl)
        lg, pcache = tr.forward(p, {"tokens": tokens}, c, mode="prefill",
                                flags=flags)
        cache = tr.init_cache(c, 1, LLM_MAX_LEN, device=dev)
        _merge_slot_cache(cache, pcache, 0, tokens.shape[1])
        del pcache
        # the same next token on every path: the greedy one of run 1
        nxt[0] = torch.argmax(lg[:, -1].float(), dim=-1)[:, None] \
            if nxt[0] is None else nxt[0]
        first, _ = tr.decode_step(p, cache, nxt[0], torch.tensor(
            [tokens.shape[1]], device=dev), c, flags)
        return lg, first

    nxt = [None]
    calls = []
    with flash_attention_as(recording(flash_attention_cuda, calls)):
        runs = {"flash": prefill_and_decode(cfg, params, "flash")}
    check(len(calls) == cfg.n_layers, f"{len(calls)} flash calls in a "
          f"prefill of {cfg.n_layers} layers")
    # at the reference's init (the random weights) the kernel and its
    # plain version round an ill-conditioned function, and either can be
    # the one that is off by an ulp (an
    # elementwise gate against the plain version failed one draw of the
    # prompts at layer 14), so each launch is held to float64 as
    # Gemma3's and MiniCPM3's are (REGIME_F64_RATIO), with a dropped
    # diagonal tile above the gate
    out["flash_on_model_inputs"] = regime_forward(
        calls, f"{LLM_ARCH} {tokens.shape[1]}-token prefill (B=1 "
        f"S={tokens.shape[1]} H={cfg.n_heads} hd={cfg.resolved_head_dim})")
    del calls
    runs["naive"] = prefill_and_decode(cfg, params, "naive")
    with flash_attention_as(flash_attention_plain):
        runs["plain"] = prefill_and_decode(cfg, params, "flash")
    errs = {f"flash vs {b}": [rel_norm(x, y) for x, y in
                              zip(runs["flash"], runs[b])]
            for b in ("plain", "naive")}
    del runs["naive"]
    for fault in PLANTED_FAULTS:
        with flash_attention_as(planted_fault(fault)):
            lg = prefill_and_decode(cfg, params, "flash")
        errs[f"{fault} vs plain"] = [rel_norm(x, y) for x, y in
                                     zip(lg, runs["plain"])]
        del lg
    del runs
    torch.cuda.empty_cache()
    out["logits_rel_err"] = errs

    def report(what, tol=None, fault=False):
        pre, dec = errs[what]
        print(f"{LLM_ARCH} 2048-token prompt, {what}: prefill logits "
              f"||a-b||/||b|| {pre:.3e}, first decode logits {dec:.3e} "
              + ("(not gated: the naive path rounds p to bf16 for p.v)"
                 if tol is None else f"(must exceed {tol:g}: planted fault)"
                 if fault else f"(tolerance {tol:g})"))
        if fault:
            check(max(pre, dec) > tol, f"the logits gate of {tol:g} cannot "
                  f"tell the planted fault '{what}'")
        elif tol is not None:
            check(max(pre, dec) <= tol, f"{what}: the logits disagree")
    report("flash vs plain", LLM_TOL_BF16)
    for fault in PLANTED_FAULTS:
        report(f"{fault} vs plain", LLM_TOL_BF16, fault=True)
    report("flash vs naive")

    # a second engine run on the naive path, whose tokens were only read
    # against these (bf16 argmax ties flip), was cut for the script's time
    # in PR 30
    torch.cuda.empty_cache()

    # profiles: one 2048-token prefill, then decode steps of a full pool
    prof = profile(lambda: tr.forward(params, {"tokens": tokens}, cfg,
                                      mode="prefill"), 1,
                   f"{LLM_ARCH} prefills of {tokens.shape[1]} tokens")
    if "device_ms_per_run" in prof:
        attn_ms = sum(ms for name, ms in prof["kernels_ms_per_run"].items()
                      if "fa_kernel" in name or "fa_sm90_kernel" in name)
        prof["attention_share_of_device"] = attn_ms / prof["device_ms_per_run"]
        print(f"  flash_attention {attn_ms:.3f} ms a prefill, "
              f"{100 * prof['attention_share_of_device']:.1f}% of its device "
              f"time")
    out["prefill_profile"] = prof
    engine = DecodeEngine(cfg, params, ecfg, seed=0, device=dev)
    for i in sorted(range(LLM_REQUESTS), key=lambda i: lens[i])[:LLM_SLOTS]:
        check(engine.try_admit(Request(rid=i, prompt=prompts[i])),
              "the pool refused a request")
    out["decode_profile"] = profile(engine.step, 1,
                                    f"{LLM_ARCH} decode steps of "
                                    f"{LLM_SLOTS} slots")
    del engine
    torch.cuda.empty_cache()

    # the kernel at each prompt length of the path, against its bound,
    # its plain version and one SDPA call (a yardstick never on the path)
    # on the same inputs; the kernel and SDPA as the device runs them
    # (device_ms), the plain version with the host's time in (time_ms)
    rows = []
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for s in sorted(set(lens)):
        q, k, v = flash_operands(1, s, s, h, hd, cfg.activation_dtype, dev,
                                 seed=s)
        ms = device_ms(lambda: flash_attention_cuda(q, k, v))
        # one call (PR 30 cut 4 to 1 for the script's time)
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v), warmup=0,
                           runs=1)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        sdpa_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        bnd = flash_bound(1, s, s, h, hd, q.dtype, True)
        blocks, waves, fill = sm_fill(1, s, h, sms)
        rows.append(dict(s=s, requests=lens.count(s), ms=ms,
                         plain_ms=plain_ms, library_ms=sdpa_ms,
                         bound_ms=max(bnd["ops_ms"], bnd["hbm_ms"]),
                         bound_by="operations"
                         if bnd["ops_ms"] >= bnd["hbm_ms"] else "bytes",
                         ops_ms=bnd["ops_ms"], hbm_ms=bnd["hbm_ms"],
                         ops_ms_fp32_pv=bnd["ops_ms_fp32_pv"],
                         gflop=bnd["flops"] / 1e9,
                         tc_tflops=bnd["tc_flops"] / ms / 1e9,
                         blocks=blocks, waves=waves, sm_fill=fill))
        del q, k, v, qt, kt, vt
    edges = (128, 512, 1024, 1536, 2049)
    for lo, hi in zip(edges, edges[1:]):
        b = [r for r in rows if lo <= r["s"] < hi]
        if not b:
            continue
        n = sum(r["requests"] for r in b)

        def mean(key):
            return sum(r[key] * r["requests"] for r in b) / n
        print(f"flash_attention, prompts {lo}-{hi - 1} ({n} requests): "
              f"{mean('ms'):.4f} ms a launch (wgmma), SDPA "
              f"{mean('library_ms'):.4f} ms, plain {mean('plain_ms'):.4f} "
              f"ms; bound of the operations "
              f"{mean('ops_ms'):.4f} ms (with p.v at the FP32 rate, as "
              f"before: {mean('ops_ms_fp32_pv'):.4f} ms), HBM bound "
              f"{mean('hbm_ms'):.4f} ms; tensor-core work at "
              f"{mean('tc_tflops'):.1f} TFLOP/s; SM fill "
              f"{mean('sm_fill'):.3f} ({mean('blocks'):.0f} blocks, "
              f"{mean('waves'):.2f} waves of {sms} SMs) (means over the "
              f"requests; B=1 H={h} hd={hd} causal {cfg.dtype}) [{card}]")
    for r in rows:
        print(f"  S={r['s']:4d}: {r['ms']:.4f} ms, {r['tc_tflops']:.1f} "
              f"TFLOP/s, {r['blocks']} blocks, fill {r['sm_fill']:.3f}, "
              f"SDPA {r['library_ms']:.4f} ms")
    out["flash_rows"] = rows
    per_path = {key: cfg.n_layers * sum(r[key] * r["requests"] for r in rows)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "ops_ms_fp32_pv")}
    out["flash_per_path"] = per_path
    ratio = per_path["ms"] / per_path["library_ms"]
    share = per_path["bound_ms"] / per_path["ms"]
    print(f"flash_attention over the path's {n_launches} launches: wgmma "
          f"kernel {per_path['ms']:.3f} ms, {ratio:.2f}x SDPA's "
          f"{per_path['library_ms']:.3f} ms; bound "
          f"{per_path['bound_ms']:.3f} ms (share {share:.3f}; "
          f"with p.v at the FP32 rate, as before: "
          f"{per_path['ops_ms_fp32_pv']:.3f} ms); plain "
          f"{per_path['plain_ms']:.3f} ms; {100 * per_path['ms'] / 1e3 / prefill_s:.1f}% of the "
          f"measured prefill time [{card}]")

    out["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"{LLM_ARCH} in {cfg.dtype}: peak device memory "
          f"{out['peak_memory_gb']:.2f} GB (max_memory_allocated) [{card}]")
    # last, the same weights widened to f32 in place (the bf16 ones go),
    # through the FFMA kernel's f32 build against the naive path; the
    # FFMA kernel timed at the f32 prefill's geometry
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    _widen(params)
    for kernel, _ in wrappers.values():
        kernel.launches = 0
    runs = {"flash": prefill_and_decode(cfg32, params, "flash")}
    torch.cuda.synchronize()
    counts = {k: wrappers[k][0].launches for k in wrappers}
    check(counts["flash_attention_ffma"] == cfg.n_layers
          and counts["flash_attention"] == cfg.n_layers
          and all(c == 0 for k, c in counts.items() if k not in
                  ("flash_attention", "flash_attention_ffma")),
          f"the f32 prefill of {cfg.n_layers} layers launched {counts}")
    runs["naive"] = prefill_and_decode(cfg32, params, "naive")
    errs["flash vs naive, f32"] = [rel_norm(x, y) for x, y in
                                   zip(runs["flash"], runs["naive"])]
    del runs, params
    torch.cuda.empty_cache()
    report("flash vs naive, f32", LLM_TOL)
    s = LLM_PROMPT_LENS[1]
    q, k, v = flash_operands(1, s, s, h, hd, torch.float32, dev, seed=s)
    bnd = flash_bound(1, s, s, h, hd, torch.float32, True)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    f32 = dict(s=s, launches=counts["flash_attention_ffma"],
               ms=device_ms(lambda: flash_attention_ffma(q, k, v), runs=5),
               plain_ms=time_ms(lambda: flash_attention_plain(q, k, v),
                                warmup=1, runs=3),
               library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True), runs=5),
               bound_ms=max(bnd["ops_ms"], bnd["hbm_ms"]),
               bound_by="operations" if bnd["ops_ms"] >= bnd["hbm_ms"]
               else "bytes")
    del q, k, v, qt, kt, vt
    out["f32_flash"] = f32
    print(f"flash_attention (ffma), the f32 prefill's {f32['launches']} "
          f"launches at S={s}: {f32['ms']:.4f} ms a launch, bound "
          f"{f32['bound_ms']:.4f} ms ({f32['bound_by']}), SDPA in f32 "
          f"{f32['library_ms']:.4f} ms, plain {f32['plain_ms']:.4f} ms "
          f"[{card}]")
    return out


# -- LLM training: full-width Gemma-7B, depth cut ---------------------------

# The llm_train phase (ROADMAP item 16): Gemma-7B at full width with
# LLM_TRAIN_LAYERS of its 28 layers (f32 masters, two f32 AdamW moments
# and f32 gradients are 16 B a parameter: 136.6 GB for 28 layers, which
# no one card holds), LLM_TRAIN_BATCH tokens a step from SyntheticLM,
# AdamW at LLM_TRAIN_LR, RunFlags(attn_impl="flash", remat=True): one
# warm-up step, then LLM_TRAIN_TIMED timed steps.
LLM_TRAIN_LAYERS = 4
LLM_TRAIN_BATCH = (2, 2048)
LLM_TRAIN_TIMED = 5
LLM_TRAIN_LR = dict(peak_lr=3e-4, warmup_steps=2)
# the loss must fall over LLM_FIT_STEPS steps on one repeated batch (a
# separate run from the timed steps' state, at this learning rate)
LLM_FIT_STEPS = 5
LLM_FIT_LR = dict(peak_lr=1e-3, warmup_steps=1)
# Gradients wrt the f32 masters through the kernel path against the
# naive path (the whole autograd in plain PyTorch), per leaf
# ||a - b|| / ||b||.  At the reference's init (stacked weights scaled by
# fan-in = the layer count) the scores reach thousands (a 3072-wide
# rehearsal on the CPU: |max| ~3.4e3 at 4 layers, ~6.5e3 at 2) and the
# gradient is ill-conditioned at either dtype: one rounding of an
# attention output moves the leaves by tens of percent in bf16, and in
# f32 the forward replaced by float64 attention rounded once read 7.1e-2
# against the naive path (3072-wide, 2 layers, 1 x 1024).  There no
# model-level gate can hold a correct kernel, so the whole-model gap is
# printed beside that exact forward's, and the gates are local, on every
# launch's own q, k, v (see REGIME_F64_RATIO).  The model-level gates run
# on the same parameters conditioned (each matrix scaled to fan-in = its
# input width, the embedding to d_model^-1/2): there the CPU rehearsal
# read 5.6e-3 to 9.7e-3 in bf16 (the kernel's p stays f32, the naive
# path's is rounded to bf16 for p.v) and 7.5e-7 in f32.
GRAD_TOL_BF16 = 3e-2
GRAD_TOL_F32 = 1e-4
# f32 through the FFMA kernel (hd 256 in f32): layers, batch, tokens
LLM_TRAIN_F32 = (2, 1, 1024)
# remat=False against remat=True and remat_policy "dots" against
# "nothing": the same forward values, so the gradients agree but for
# the order of the backward's sums
REMAT_TOL = 1e-6
# the planted fault of the bf16 gate: the backward's recompute scales
# dv by 1 + 2^-4; it must fail the gate on at least one leaf
GRAD_FAULT = 2 ** -4
# At the reference's init, launch by launch on the model's own q, k, v:
# the kernel's mean |error| against float64 attention at most
# REGIME_F64_RATIO times its plain version's.  Both round the same exact
# value of an ill-conditioned function (an elementwise gate cannot hold
# there: the plain version itself reads 5-9x FLASH_TOL against float64
# in bf16 and ~600x in f32); two f32 summation orders read 1.000 there
# and 1.41-1.50 on conditioned weights, and a dropped diagonal tile
# 2.0e3-8.5e4 (CPU rehearsal, 3072 wide).  The Function's backward on
# the first LLM_TRAIN_LAYERS of those launches (bf16) against float64
# attention's, per input, within GRAD_TOL_BF16 (2.4e-3 on the CPU), with
# dv scaled by 1 + GRAD_FAULT failing it.
REGIME_F64_RATIO = 2.0


def counting_plain_attention(calls: list):
    """Inside: every call of the flash kernel's plain version through the
    model appends to ``calls`` (the train path must make none on the
    card)."""
    from repro_torch.models import attention
    plain = attention.flash_attention_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)
    return swapped(attention, "flash_attention_plain", counted)


def dv_scaled_backward(extra: float):
    """Inside: the flash attention's backward recompute scales dv by
    ``1 + extra`` (the forward values unchanged)."""
    from repro_torch.kernels import flash_attention as fa
    recompute = fa.recompute_attention

    def faulty(q, k, v, causal=True):
        more = v * extra
        return recompute(q, k, v + (more - more.detach()), causal=causal)
    return swapped(fa, "recompute_attention", faulty)


def leaf_rel(got: dict, ref: dict) -> dict[str, float]:
    """||a - b|| / ||b|| of each leaf of two gradient trees."""
    from repro_torch.train.checkpoint import tree_items
    a, b = tree_items(got), tree_items(ref)
    return {k: rel_norm(a[k], b[k]) for k in b}


def condition(params: dict, d_model: int) -> None:
    """In place: each stacked matrix scaled from the reference's fan-in
    (the layer count) to its input width (``repro_torch.sharding.parity.
    condition``, which the mesh phase's ranks run too)."""
    from repro_torch.sharding.parity import condition as conditioned
    conditioned(params, d_model)


def attend_as(dev, fn):
    """Inside: the model's flash attention on ``dev`` calls ``fn`` (the
    kernel's wrapper swapped on the card, its plain version on the
    CPU)."""
    from repro_torch.models import attention
    return swapped(attention, "flash_attention_cuda" if dev.type == "cuda"
                   else "flash_attention_plain", fn)


def exact_attention(q, k, v, causal=True):
    """float64 attention of q, k, v rounded once to q's dtype."""
    return attention_f64(q, k, v, causal).to(q.dtype)


def regime_forward(calls: list, label: str, plain_tiles: dict = {}) -> dict:
    """Each recorded launch (see REGIME_F64_RATIO): the kernel's and the
    plain version's mean |error| against float64 attention, gated; the
    scores' largest magnitude, and the elementwise FLASH_TOL's use,
    read; a dropped diagonal tile on the first launch must fail.
    ``plain_tiles`` (``block_q``, ``block_k``) walks the plain version
    over larger tiles than the kernel's (fewer Python steps; the same
    function summed in another f32 order)."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    ratios, used, score_max, fault = [], 0.0, 0.0, None
    for i, (q, k, v, causal, o) in enumerate(calls):
        exact = attention_f64(q, k, v, causal)
        ref = flash_attention_plain(q, k, v, causal=causal, **plain_tiles)
        e_plain = (ref.double() - exact).abs().mean().item()
        ratios.append((o.double() - exact).abs().mean().item() / e_plain)
        atol, rtol = FLASH_TOL[o.dtype]
        used = max(used, ((o.float() - ref.float()).abs()
                          / (atol + rtol * ref.float().abs())).max().item())
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        score_max = max(score_max, (sc.tril() if causal else sc).abs()
                        .max().item() * q.shape[3] ** -0.5)
        del sc
        if i == 0:
            bad = planted_fault("diagonal tile dropped")(q, k, v, causal)
            fault = (bad.double() - exact).abs().mean().item() / e_plain
            del bad
        del exact, ref
    print(f"{label}: {len(calls)} launches on the model's own q, k, v, "
          f"scores up to {score_max:.1f}; kernel's mean |error| against "
          f"float64 over the plain version's: worst {max(ratios):.4f} (gate "
          f"{REGIME_F64_RATIO:g}), a dropped diagonal tile {fault:.1f}; "
          f"kernel vs plain elementwise at {used:.2f} of FLASH_TOL (read, "
          f"not gated)")
    check(max(ratios) <= REGIME_F64_RATIO, f"{label}: the kernel is less "
          f"accurate than its plain version: {ratios}")
    check(fault > REGIME_F64_RATIO, f"{label}: the gate cannot tell a "
          f"dropped diagonal tile ({fault:.3f})")
    return dict(launches=len(calls), score_max=score_max, f64_ratio=ratios,
                fault_ratio=fault, flash_tol_used=used)


def regime_backward(calls: list, attend, label: str) -> dict:
    """The Function's dq, dk, dv on each recorded launch's q, k, v
    against float64 attention's, per input ||a - b|| / ||b|| within
    GRAD_TOL_BF16; the planted dv fault must fail on the first."""
    from repro_torch.kernels.flash_attention import FlashAttentionFn
    worst, fault = 0.0, None
    for i, (q, k, v, causal, _) in enumerate(calls):
        do = torch.randn(q.shape, generator=torch.Generator().manual_seed(i)
                         ).to(q.device, q.dtype)
        wide = [t.detach().double().requires_grad_() for t in (q, k, v)]
        g64 = torch.autograd.grad(attention_f64(*wide, causal), wide,
                                  do.double())

        def grads():
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(FlashAttentionFn.apply(
                *ins, causal, attend), ins, do)
        worst = max(worst, *(rel_norm(a, b) for a, b in zip(grads(), g64)))
        if i == 0:
            with dv_scaled_backward(GRAD_FAULT):
                fault = rel_norm(grads()[2], g64[2])
        del wide, g64
    print(f"{label}: the Function's backward on {len(calls)} launches' own "
          f"q, k, v against float64 attention's: worst input "
          f"{worst:.3e} (gate {GRAD_TOL_BF16:g}), dv scaled by 1 + "
          f"{GRAD_FAULT:g} {fault:.3e}")
    check(worst <= GRAD_TOL_BF16, f"{label}: the backward is off by {worst}")
    check(fault > GRAD_TOL_BF16, f"{label}: the backward gate cannot tell "
          f"dv scaled by 1 + {GRAD_FAULT:g}")
    return dict(worst=worst, fault=fault)


def llm_train_phase(card, dev, wrappers, kernel_errs: dict,
                    layers: int = LLM_TRAIN_LAYERS,
                    batch: tuple[int, int] = LLM_TRAIN_BATCH,
                    f32: tuple[int, int, int] = LLM_TRAIN_F32,
                    roofline: dict | None = None) -> dict:
    """Full-width Gemma-7B training with its depth cut to ``layers``
    (every counter at 0 just before the main path's steps, read just
    after): state, step time, tokens/s, model-FLOP share, peak memory,
    the optimizer's share; the loss falling on one batch; at the
    reference's init, the kernel on its launches' own q, k, v and the
    Function's backward against float64 attention (gated), the
    whole-model gradient gaps beside an exact forward's (read), in bf16
    and, at ``f32`` = (layers, B, S), through the FFMA kernel; the
    gradient gates on conditioned weights (kernel path against naive in
    bf16 and f32; a planted backward fault; remat, "dots" and
    grad_accum=2 against their controls); the kernel at the step's
    geometry against its plain version, beside its bound, SDPA and its
    recompute backward.  Appends the step geometry's kernel error to
    ``kernel_errs``; on the card, adds the profiled step (its meta
    arguments and the card's reading) to ``roofline`` for the roofline
    phase.  ``layers``, ``batch`` and ``f32`` shrink it for a rehearsal
    on the CPU."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM, make_batch_fn
    from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                     flash_attention_cuda,
                                                     flash_attention_plain)
    from repro_torch.models import transformer as tr
    from repro_torch import elastic_restart
    from repro_torch.launch import train as launch_train
    from repro_torch.train.checkpoint import all_steps, tree_leaves
    from repro_torch.train.optimizer import AdamWConfig, adamw_update
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    t_phase = time.perf_counter()
    out: dict = {}
    full = get_config(LLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=layers)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    n_full, n = tr.count_params(full), tr.count_params(cfg)
    t0 = time.perf_counter()
    state = init_train_state(cfg, torch.Generator(dev).manual_seed(0))
    sync()
    state_bytes = sum(t.numel() * t.element_size() for t in
                      tree_leaves(state["params"]) + tree_leaves(state["opt"]))
    print(f"{LLM_ARCH} training at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads}x{cfg.resolved_head_dim} heads, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}) with {layers} of its {full.n_layers} layers: "
          f"{n:,} parameters ({n_full:,} at 28 layers); f32 masters and "
          f"moments {state_bytes / 1e9:.1f} GB, with f32 gradients "
          f"{(state_bytes + 4 * n) / 1e9:.1f} GB (28 layers: "
          f"{16 * n_full / 1e9:.1f} GB, which no one card holds: the depth "
          f"is the cut); drawn on the card in {time.perf_counter() - t0:.2f} "
          f"s")
    b, s = batch
    tokens = b * s
    batch_fn = make_batch_fn(SyntheticLM(cfg, b, s, seed=0), device=dev)
    flags = tr.RunFlags(attn_impl="flash", remat=True)
    opt_cfg = AdamWConfig(total_steps=1 + LLM_TRAIN_TIMED, **LLM_TRAIN_LR)
    step = make_train_step(cfg, opt_cfg, flags)

    # -- the main path: a warm-up step and the timed steps ---------------
    plain_calls: list = []
    for kernel, _ in wrappers.values():
        kernel.launches = 0
    times, metrics = [], []
    with counting_plain_attention(plain_calls):
        for i in range(1 + LLM_TRAIN_TIMED):
            data = batch_fn(i)
            sync()
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            state, m = step(state, data)
            if on_card:
                end.record()
            sync()
            ms = start.elapsed_time(end) if on_card else \
                (time.perf_counter() - t0) * 1e3
            if i:
                times.append(ms)
            metrics.append({k: float(v) for k, v in m.items()})
    counts = {k: wrappers[k][0].launches for k in wrappers}
    steps = 1 + LLM_TRAIN_TIMED
    want = steps * layers * 2
    if on_card:
        check(counts["flash_attention"] == want
              and counts["flash_attention_wgmma"] == want,
              f"{counts} flash launches for {steps} steps of {layers} "
              f"layers (forward and remat recompute): {want} expected, all "
              f"through the wgmma kernel")
        check(all(c == 0 for k, c in counts.items()
                  if k not in ("flash_attention", "flash_attention_wgmma")),
              f"the train path launched another kernel: {counts}")
    check(not on_card or not plain_calls,
          f"the train path called the plain version {len(plain_calls)} "
          f"times on the card")
    for i, m in enumerate(metrics):
        check(all(math.isfinite(m[k]) for k in ("loss", "total_loss",
                                               "grad_norm")),
              f"step {i}: not finite: {m}")
    step_ms = statistics.median(times)
    flops = tr.model_flops_per_token(cfg) * tokens
    peak_mb = None
    if on_card:
        peak_mb = torch.cuda.max_memory_allocated(dev) / 1e6
    out.update(arch=LLM_ARCH, layers=layers, params=n, params_28=n_full,
               state_gb=state_bytes / 1e9, batch=list(batch),
               launches=counts["flash_attention"],
               launches_wgmma=counts["flash_attention_wgmma"],
               plain_calls=len(plain_calls), step_ms=times,
               step_ms_median=step_ms, tokens_per_s=tokens / step_ms * 1e3,
               model_flops=flops,
               mfu=flops / (step_ms / 1e3) / PEAK_BF16_TC_FLOPS,
               peak_memory_gb=None if peak_mb is None else peak_mb / 1e3,
               losses=[m["loss"] for m in metrics],
               grad_norms=[m["grad_norm"] for m in metrics])
    print(f"{LLM_ARCH} ({layers} layers) train steps of {b}x{s} tokens: "
          f"{steps} steps ({LLM_TRAIN_TIMED} timed), median "
          f"{step_ms:.3f} ms a step ({', '.join(f'{t:.3f}' for t in times)}),"
          f" {out['tokens_per_s']:.1f} tokens/s; model FLOPs 6N x tokens = "
          f"{flops / 1e12:.2f} TFLOP a step, {100 * out['mfu']:.2f}% of the "
          f"bf16 dense peak ({PEAK_BF16_TC_FLOPS / 1e12:.0f} TFLOP/s); peak "
          f"device memory {out['peak_memory_gb'] or 0:.2f} GB; flash launches "
          f"{counts['flash_attention']} = {steps} steps x {layers} layers x 2 "
          f"(forward and remat recompute), {counts['flash_attention_wgmma']} "
          f"through the wgmma kernel, {len(plain_calls)} plain-version calls "
          f"[{card}]")
    print(f"  losses {', '.join(f'{x:.4f}' for x in out['losses'])}; grad "
          f"norms {', '.join(f'{x:.4f}' for x in out['grad_norms'])}")
    if on_card:
        reading = StepReading(dev, state)
        out["step_profile"] = profile(lambda: step(state, batch_fn(0)), 1,
                                      f"{LLM_ARCH} train steps", flops=True,
                                      before=reading.start)
        if roofline is not None:
            roofline[f"{LLM_ARCH} train step ({layers} layers, {b}x{s} "
                     f"tokens)"] = dict(
                fn=step, args=(to_meta(state), to_meta(batch_fn(0))),
                measured=reading.stop(out["step_profile"]))

    # -- the loss falls on one repeated batch --------------------------------
    fit = make_train_step(cfg, AdamWConfig(total_steps=LLM_FIT_STEPS,
                                           **LLM_FIT_LR), flags)
    one = batch_fn(10_000)
    losses = []
    for _ in range(LLM_FIT_STEPS):
        state, m = fit(state, one)
        losses.append(float(m["loss"]))
    out["fit_losses"] = losses
    print(f"one repeated batch, {LLM_FIT_STEPS} steps at peak_lr "
          f"{LLM_FIT_LR['peak_lr']:g}: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"the loss does not fall on one repeated batch: {losses}")

    # -- the optimizer timed apart, on one step's gradients --------------
    _, _, grads = step.value_and_grad(state["params"], one)
    opt_ms = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        adamw_update(state["params"], grads, state["opt"], opt_cfg)
        if on_card:
            end.record()
        sync()
        opt_ms.append(start.elapsed_time(end) if on_card else
                      (time.perf_counter() - t0) * 1e3)
    del grads
    out["optimizer_ms"] = statistics.median(opt_ms)
    out["optimizer_share"] = out["optimizer_ms"] / step_ms
    print(f"adamw_update alone (per leaf, in place; {n:,} f32 parameters): "
          f"{out['optimizer_ms']:.3f} ms, {100 * out['optimizer_share']:.1f}% "
          f"of the step [{card}]")
    del state["opt"]
    params = state["params"]
    if on_card:
        torch.cuda.empty_cache()

    # -- gradients through the kernel against the naive path -------------
    def grads_of(p, data, **over):
        fn = make_train_step(cfg, opt_cfg, dataclasses.replace(flags, **over))
        return fn.value_and_grad(p, data)[2]

    def accum_grads(p, data):
        fn = make_train_step(cfg, opt_cfg, flags, grad_accum=2)
        return fn.value_and_grad(p, {k: v.reshape(2, v.shape[0] // 2,
                                                  *v.shape[1:])
                                     for k, v in data.items()})[2]

    def init_gaps(label, grads, data, n_layers):
        """At the reference's init: the gradients of the kernel path (its
        launches recorded) and of the exact forward against the naive
        path's, per leaf, read; the recorded launches gated locally."""
        calls: list = []
        with attend_as(dev, recording(kernel, calls)):
            g_kernel = grads(data)
        g_naive = grads(data, attn_impl="naive")
        with attend_as(dev, exact_attention):
            g_exact = grads(data)
        gaps = {"kernel": leaf_rel(g_kernel, g_naive),
                "exact forward": leaf_rel(g_exact, g_naive)}
        del g_kernel, g_naive, g_exact
        print(f"{label} gradients at the reference's init against the naive "
              f"path, per leaf (ill-conditioned: read, not gated): "
              + "; ".join(f"{k} worst {max(r.values()):.3e} "
                          f"({max(r, key=r.get)}), median "
                          f"{statistics.median(r.values()):.3e}"
                          for k, r in (("the kernel path", gaps["kernel"]),
                                       ("the forward as float64 attention "
                                        "rounded once",
                                        gaps["exact forward"]))))
        check(len(calls) == 2 * n_layers, f"{len(calls)} flash calls in the "
              f"gradients of {n_layers} layers")
        # the forward's launches (the remat recompute repeats their inputs)
        regime = regime_forward(calls[:n_layers], f"{LLM_ARCH} {label} at "
                                f"the reference's init")
        return gaps, regime, calls[:n_layers]

    kernel = flash_attention_cuda if on_card else flash_attention_plain
    gaps, regime, calls = init_gaps(
        "bf16", lambda data, **over: grads_of(params, data, **over), one,
        layers)
    regime["backward"] = regime_backward(calls, kernel, f"{LLM_ARCH} bf16 "
                                         f"at the reference's init")
    del calls
    out["reference_init"] = {"bf16": dict(grad_rel=gaps, **regime)}
    condition(params, cfg.d_model)
    g_flash = grads_of(params, one)
    g_naive = grads_of(params, one, attn_impl="naive")
    gates = {"flash vs naive, bf16": leaf_rel(g_flash, g_naive)}
    with dv_scaled_backward(GRAD_FAULT):
        g = grads_of(params, one)
    gates["planted fault vs naive, bf16"] = leaf_rel(g, g_naive)
    del g, g_naive
    for label, over in (("remat=False vs remat=True", dict(remat=False)),
                        ('"dots" vs "nothing"', dict(remat_policy="dots"))):
        g = grads_of(params, one, **over)
        gates[label] = leaf_rel(g, g_flash)
        del g
    g = accum_grads(params, one)
    gates["grad_accum=2 vs 1"] = leaf_rel(g, g_flash)
    del g, g_flash, state, params
    if on_card:
        torch.cuda.empty_cache()

    # f32 through the FFMA kernel, at f32 = (layers, B, S)
    l32, b32, s32 = f32
    cfg32 = dataclasses.replace(full, n_layers=l32, dtype="float32")
    p32 = tr.init(cfg32, torch.Generator(dev).manual_seed(1))
    data32 = make_batch_fn(SyntheticLM(cfg32, b32, s32, seed=1),
                           device=dev)(0)

    def grads32(data, **over):
        return make_train_step(cfg32, opt_cfg, dataclasses.replace(
            flags, **over)).value_and_grad(p32, data)[2]
    for wrapper, _ in wrappers.values():
        wrapper.launches = 0
    gaps, regime, calls = init_gaps("f32", grads32, data32, l32)
    del calls
    sync()
    counts32 = {k: wrappers[k][0].launches for k in wrappers}
    if on_card:
        check(counts32["flash_attention_ffma"] == 2 * l32
              and counts32["flash_attention"] == 2 * l32,
              f"the f32 gradients of {l32} layers launched {counts32}")
    out["reference_init"]["f32"] = dict(grad_rel=gaps, **regime)
    condition(p32, cfg32.d_model)
    gates["flash vs naive, f32"] = leaf_rel(grads32(data32),
                                            grads32(data32,
                                                    attn_impl="naive"))
    del p32
    if on_card:
        torch.cuda.empty_cache()
    out["grad_gates"] = gates
    out["launches_ffma_f32"] = counts32["flash_attention_ffma"]

    tols = {"flash vs naive, bf16": GRAD_TOL_BF16,
            "planted fault vs naive, bf16": GRAD_TOL_BF16,
            "remat=False vs remat=True": REMAT_TOL,
            '"dots" vs "nothing"': REMAT_TOL,
            "grad_accum=2 vs 1": GRAD_TOL_BF16,
            "flash vs naive, f32": GRAD_TOL_F32}
    for label, rel in gates.items():
        worst = max(rel, key=rel.get)
        tol = tols[label]
        fault = label.startswith("planted")
        print(f"gradients per leaf, {label}: worst {rel[worst]:.3e} "
              f"({worst}), {rel[worst] / tol:.3f} of "
              f"{'the gate (must exceed it)' if fault else 'its tolerance'} "
              f"{tol:g}; median {statistics.median(rel.values()):.3e}")
        if fault:
            check(rel[worst] > tol, f"the bf16 gradient gate of {tol:g} "
                  f"cannot tell dv scaled by 1 + {GRAD_FAULT:g}")
        else:
            check(rel[worst] <= tol, f"{label}: {worst} off by "
                  f"{rel[worst]:.3e}")
    out["grad_tol_used"] = {k: max(v.values()) / tols[k]
                            for k, v in gates.items()}

    # -- the kernel at the step's geometry -------------------------------
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    if on_card:
        q, k, v = flash_operands(b, s, s, h, hd, cfg.activation_dtype, dev,
                                 seed=7)
        bnd = flash_bound(b, s, s, h, hd, q.dtype, True)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        qg, kg, vg = (a.detach().requires_grad_() for a in (q, k, v))
        o = FlashAttentionFn.apply(qg, kg, vg, True, flash_attention_cuda)
        do = torch.randn_like(o)
        ref = flash_attention_plain(q, k, v)
        atol, rtol = FLASH_TOL[o.dtype]
        err = (o.float() - ref.float()).abs().max().item()
        check(bool(torch.allclose(o.float(), ref.float(), atol=atol,
                                  rtol=rtol)) and bool(torch.isfinite(o).all()),
              f"the kernel at the step's geometry disagrees with its plain "
              f"version: max_abs_err {err:.3e}")
        kernel_errs["flash_attention_wgmma"].append(err)
        del ref
        row = dict(
            b=b, s=s, h=h, hd=hd, max_abs_err=err,
            ms=device_ms(lambda: flash_attention_cuda(q, k, v)),
            plain_ms=time_ms(lambda: flash_attention_plain(q, k, v),
                             warmup=1, runs=1),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
            backward_ms=time_ms(lambda: torch.autograd.grad(
                o, (qg, kg, vg), do, retain_graph=True), warmup=1, runs=3),
            bound_ms=max(bnd["ops_ms"], bnd["hbm_ms"]),
            bound_by="operations" if bnd["ops_ms"] >= bnd["hbm_ms"]
            else "bytes", launches_per_step=2 * layers)
        del q, k, v, qt, kt, vt, qg, kg, vg, o, do
        torch.cuda.empty_cache()
        out["flash_row"] = row
        print(f"flash_attention (wgmma) at the step's geometry (B={b} S={s} "
              f"H={h} hd={hd} causal bf16): vs plain max_abs_err {err:.3e} "
              f"(atol {atol:g}, rtol {rtol:g}) ok; {row['ms']:.4f} ms a launch "
              f"(device), {2 * layers} launches a step; bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); SDPA forward "
              f"{row['library_ms']:.4f} ms; plain {row['plain_ms']:.3f} ms; "
              f"the recompute backward (plain PyTorch) {row['backward_ms']:.3f}"
              f" ms a layer [{card}]")

    # -- the train CLI at the tiny preset, the restart demo's replay -----
    # (in this process: the kernels are built once; the mesh phase runs
    # the CLI on a mesh and the reshard)
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "ckpt")
        t0 = time.perf_counter()
        loop, _ = launch_train.main(
            ["--arch", LLM_ARCH, "--preset", "tiny", "--steps", "4",
             "--ckpt-every", "2", "--batch", "2", "--seq", "32",
             "--ckpt-dir", ck, "--device", dev.type])
        sync()
        out["cli_s"] = time.perf_counter() - t0
        losses = [m["loss"] for m in loop.metrics_history]
        print(f"repro_torch.launch.train.main(--preset tiny --steps 4 "
              f"--ckpt-every 2): {out['cli_s']:.1f} s, checkpoints "
              f"{all_steps(ck)}, losses {[round(v, 4) for v in losses]}")
        check(all_steps(ck) == [2, 4] and len(losses) == 4
              and all(math.isfinite(v) for v in losses),
              f"the train CLI: checkpoints {all_steps(ck)}, losses {losses}")
    out["elastic_divergence"] = elastic_restart.replay(dev)
    check(out["elastic_divergence"] < 1e-5, f"the restart demo diverged by "
          f"{out['elastic_divergence']:.2e}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"llm_train phase: {out['seconds']:.1f} s")
    return out


# -- Gemma3-4B: sliding-window and global layers, served and trained ---------

# The gemma3 phase: full-width Gemma3-4B (34 layers, 29 windowed at 1024
# and 5 global at rope_theta 1e6, bf16, random weights from seed 0)
# serving GEMMA3_REQUESTS prompts of lengths drawn from seed 0 in
# GEMMA3_PROMPT_LENS (the local layers take swa's blocked branch, with a
# padded tail, above 2048 tokens and its naive one below), greedy,
# through GEMMA3_SLOTS slots; then training at full width with
# GEMMA3_TRAIN_LAYERS of its 34 layers (one group of 5 local and 1
# global, and a remainder segment of 2 local: the f32 state of 34
# layers, 62 GB with the gradients, leaves no room on one card for the
# activations of 4096 tokens and the 262,144-wide logits), a step of
# GEMMA3_TRAIN_BATCH SyntheticLM tokens (swa blocked, nb 4).
GEMMA3_ARCH = "gemma3-4b"
GEMMA3_PARAMS = 3_879_907_840
GEMMA3_REQUESTS = 16
GEMMA3_PROMPT_LENS = (128, 4000)
GEMMA3_SLOTS, GEMMA3_MAX_LEN, GEMMA3_MAX_NEW = 8, 4040, 32
GEMMA3_TRAIN_LAYERS = 8
GEMMA3_TRAIN_PARAMS = 1_426_106_880
GEMMA3_TRAIN_BATCH = (1, 4096)
GEMMA3_TRAIN_TIMED = 3
# the f32 check: full width with these layers, one prompt of these tokens
GEMMA3_F32 = (8, 3000)
# swa_attention on the card at (1, S, 8 q heads over 4 kv heads, 256):
# f32 against float64 windowed attention, per element (f32 sums in
# another order); bf16 against the naive windowed attention on the card
# in norm, ||a - b|| <= SWA_TOL_BF16 ||b|| (both round p to bf16 after a
# softmax summed in another order, so single outputs may differ by more
# than an ulp).  A window of w + 1 must fail both.
SWA_TOL_F32 = 2e-5
SWA_TOL_BF16 = 2 ** -8
# the logits of the kernel path against the naive path's (and the plain
# version's) on a 4000-token prompt, ||a - b|| <= tol ||b||, by the
# weights' regime.  At the reference's init (the served weights, stacked
# fan-in = the layer count) the global layers' softmax is saturated
# (scores to ~2.4e3), so the planted faults move the logits no more than
# the two paths' roundings do (3.2e-2 and 2.7e-2 against flash vs naive's
# 2.7e-2 on an H100): the paths are held to LLM_TOL_BF16 there, as
# Gemma-7B's, and the faults read.  On the same weights conditioned to
# fan-in = width (``condition``) the faults are gated: flash vs naive
# and vs plain read 1.8e-2 / 1.9e-2 (prefill / decode), the dropped
# diagonal tile 2.3e-1 and the strict causal mask 4.3e-2, so
# LLM_TOL_BF16 cannot tell the strict mask (one key of ~2000 in 5 of 34
# layers) and the gate is 3e-2, between them.
GEMMA3_LOGITS_TOL = {"reference init": LLM_TOL_BF16, "conditioned": 3e-2}
# profiler ranges of the prefill's profile (obs.annotate)
GEMMA3_RANGES = ("gemma3.swa_attention", "gemma3.logits")


def annotated(module, name: str, label: str):
    """Inside: ``module.name`` runs in the profiler range ``label``."""
    from repro_torch import obs
    fn = getattr(module, name)

    def ranged(*args, **kwargs):
        with obs.annotate(label):
            return fn(*args, **kwargs)
    return swapped(module, name, ranged)


def swa_gate(card, dev) -> dict:
    """swa_attention on the card at Gemma3's local geometry (S 4000, w
    1024): f32 against float64, bf16 against the naive windowed path,
    each with the planted window w + 1 that must fail."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.attention import naive_attention, swa_attention
    cfg = get_config(GEMMA3_ARCH)
    s, w = GEMMA3_PROMPT_LENS[1], cfg.local_window
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((1, s, hq, hd), generator=gen).to(dev)
    k, v = (torch.randn((1, s, hk, hd), generator=gen).to(dev)
            for _ in range(2))
    pos = torch.arange(s, device=dev)[None]
    out = {}
    exact = attention_f64(q, *(a.repeat_interleave(hq // hk, dim=2)
                               for a in (k, v)), True, window=w)
    for name, win in (("f32", w), ("f32, window w + 1", w + 1)):
        got = swa_attention(q, k, v, pos, pos, window=win)
        err = (got.double() - exact).abs().max().item()
        ok = bool(torch.allclose(got.double(), exact, atol=SWA_TOL_F32,
                                 rtol=SWA_TOL_F32))
        out[name] = err
        print(f"swa_attention on the card, {name}: S={s} H={hq}/{hk} "
              f"hd={hd} w={w} vs float64 windowed attention max_abs_err "
              f"{err:.3e} (atol = rtol = {SWA_TOL_F32:g}) "
              f"{'ok' if ok else 'fails'}")
        check(ok == (win == w), f"swa_attention {name}: the gate "
              f"{'fails' if win == w else 'cannot tell a wrong window'}")
    del exact
    qb, kb, vb = (a.to(torch.bfloat16) for a in (q, k, v))
    ref = naive_attention(qb, kb, vb, pos, pos, window=w)
    for name, win in (("bf16", w), ("bf16, window w + 1", w + 1)):
        rel = rel_norm(swa_attention(qb, kb, vb, pos, pos, window=win), ref)
        out[name] = rel
        print(f"swa_attention on the card, {name} vs the naive windowed "
              f"attention: ||a-b||/||b|| {rel:.3e} (tolerance "
              f"{SWA_TOL_BF16:g}) {'ok' if rel <= SWA_TOL_BF16 else 'fails'}")
        check((rel <= SWA_TOL_BF16) == (win == w), f"swa_attention {name}: "
              f"the gate {'fails' if win == w else 'cannot tell it'}")
    # the local layer's attention timed against the global layer's kernel
    # at the same S (no window in the kernel: ROADMAP's follow-up)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    kx, vx = (a.repeat_interleave(hq // hk, dim=2) for a in (kb, vb))
    out["swa_ms"] = device_ms(lambda: swa_attention(qb, kb, vb, pos, pos,
                                                    window=w), runs=5)
    out["flash_ms"] = device_ms(lambda: flash_attention_cuda(qb, kx, vx))
    out["gqa_copy_ms"] = device_ms(lambda: (kb.repeat_interleave(
        hq // hk, dim=2), vb.repeat_interleave(hq // hk, dim=2)))
    print(f"a local layer's attention at S={s} (bf16): swa_attention "
          f"(plain PyTorch) {out['swa_ms']:.4f} ms; the wgmma kernel over "
          f"the whole causal prefix {out['flash_ms']:.4f} ms; the GQA "
          f"repeat_interleave of k and v before a launch "
          f"{out['gqa_copy_ms']:.4f} ms [{card}]")
    return out


def gemma3_phase(card, dev, wrappers) -> dict:
    """Full-width Gemma3-4B: serving through ``DecodeEngine.run`` (every
    counter at 0 just before, read just after: the global layers'
    launches, all on the wgmma kernel, and no plain call), TTFT,
    prefill and decode rates; the kernel path's logits against the
    naive path's and the plain version's on a 4000-token prompt, with
    the planted faults; every launch of that prefill against float64
    attention (``regime_forward``); swa_attention on the card; the f32 check through the FFMA
    kernel; a profile of the prefill by layer kind; the kernel at each
    served length beside its bound and SDPA, and its soft-cap instances
    timed; then training with the depth cut: step time, tokens/s,
    model-FLOP share, peak memory, 2 launches a step, the loss falling
    on one batch and the bf16 gradient gate with its planted fault."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM, make_batch_fn
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    from repro_torch.models import attention
    from repro_torch.models import transformer as tr
    from repro_torch.serve.engine import (DecodeEngine, EngineConfig,
                                          Request, _merge_slot_cache)
    from repro_torch.train.checkpoint import tree_leaves
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step)
    t_phase = time.perf_counter()
    cfg = get_config(GEMMA3_ARCH)
    out: dict = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    def n_global(c):
        return sum(rep * sum(1 for d in descs if not d.window)
                   for descs, rep in c.layer_segments())
    t0 = time.perf_counter()
    params = tr.init(cfg, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == tr.count_params(cfg) == GEMMA3_PARAMS,
          f"{n_params} parameters, not {GEMMA3_PARAMS}")
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    globals_ = n_global(cfg)
    print(f"{GEMMA3_ARCH}: {cfg.n_layers} layers ({cfg.n_layers - globals_} "
          f"windowed at {cfg.local_window}, {globals_} global at rope_theta "
          f"1e6), d_model {cfg.d_model}, {cfg.n_heads} q heads over "
          f"{cfg.n_kv_heads} kv heads of {cfg.resolved_head_dim}, vocab "
          f"{cfg.vocab}: {n_params:,} parameters, {weight_bytes / 1e9:.2f} GB "
          f"in {cfg.dtype}, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")

    # -- serving: the main path ------------------------------------------
    gen = torch.Generator().manual_seed(0)
    lens = torch.randint(GEMMA3_PROMPT_LENS[0], GEMMA3_PROMPT_LENS[1] + 1,
                         (GEMMA3_REQUESTS,), generator=gen).tolist()
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist()
               for n in lens]
    ecfg = EngineConfig(n_slots=GEMMA3_SLOTS, max_len=GEMMA3_MAX_LEN,
                        max_new=GEMMA3_MAX_NEW, temperature=0.0)
    warm = DecodeEngine(cfg, params, dataclasses.replace(ecfg, n_slots=1),
                        seed=0, device=dev)
    warm.try_admit(Request(rid=-1, prompt=prompts[0][:GEMMA3_PROMPT_LENS[0]]))
    warm.step()
    del warm
    plain_calls: list = []
    with counting_plain_attention(plain_calls):
        reqs, admits, steps, wall, counts = serve_requests(
            cfg, params, ecfg, prompts, "flash", wrappers, dev)
    want = globals_ * GEMMA3_REQUESTS
    check(counts["flash_attention"] == want
          and counts["flash_attention_wgmma"] == want,
          f"{counts} flash launches for {GEMMA3_REQUESTS} prefills of "
          f"{globals_} global layers, all through the wgmma kernel")
    check(all(c == 0 for k, c in counts.items()
              if k not in ("flash_attention", "flash_attention_wgmma")),
          f"the Gemma3 path launched another kernel: {counts}")
    check(not plain_calls, f"the Gemma3 path called the plain version "
          f"{len(plain_calls)} times on the card")
    for r in reqs:
        check(r.done and len(r.generated) == GEMMA3_MAX_NEW
              and all(0 <= t < cfg.vocab for t in r.generated),
              f"request {r.rid}: done {r.done}, {len(r.generated)} tokens")
    prefill_s = sum(d for _, d in admits.values())
    decode_s = sum(d for d, _ in steps)
    decode_tokens = sum(n for _, n in steps)
    step_ms = statistics.median(d * 1e3 for d, _ in steps)
    ttft = sorted((len(r.prompt), sum(admits[r.rid]) * 1e3,
                   admits[r.rid][1] * 1e3) for r in reqs)
    print(f"{GEMMA3_ARCH} served {GEMMA3_REQUESTS} requests ({sum(lens)} "
          f"prompt tokens, {GEMMA3_MAX_NEW} new each) in {wall:.3f} s through "
          f"{GEMMA3_SLOTS} slots: {counts['flash_attention']} flash launches "
          f"= {globals_} global layers x {GEMMA3_REQUESTS} prefills, all "
          f"through the wgmma kernel, 0 plain calls; the {cfg.n_layers - globals_}"
          f" local layers through swa_attention [{card}]")
    for n, t, pre in ttft:
        print(f"  prompt {n:4d} tokens ({'blocked' if n > 2 * cfg.local_window else 'naive'}"
              f" swa): prefill {pre:9.3f} ms, time to first token {t:9.3f} ms")
    print(f"prefill: {sum(lens)} tokens in {prefill_s:.3f} s = "
          f"{sum(lens) / prefill_s:.1f} tokens/s; decode: {len(steps)} engine "
          f"steps, median {step_ms:.3f} ms a step, {decode_tokens} tokens in "
          f"{decode_s:.3f} s = {decode_tokens / decode_s:.1f} tokens/s (HBM "
          f"bound of a step's weights "
          f"{weight_bytes / PEAK_HBM_BYTES * 1e3:.3f} ms) [{card}]")
    out.update(
        arch=GEMMA3_ARCH, params=n_params, weight_gb=weight_bytes / 1e9,
        prompt_lens=lens, wall_s=wall, launches=counts["flash_attention"],
        requests=[dict(prompt=n, ttft_ms=t, prefill_ms=pre)
                  for n, t, pre in ttft],
        prefill_tokens_per_s=sum(lens) / prefill_s, decode_steps=len(steps),
        decode_step_ms_median=step_ms,
        decode_tokens_per_s=decode_tokens / decode_s)

    # -- the kernel path against the naive path on a 4000-token prompt ---
    s_max = GEMMA3_PROMPT_LENS[1]
    tokens = torch.randint(0, cfg.vocab, (1, s_max), generator=gen).to(dev)
    nxt = [None]

    def prefill_and_decode(c, p, impl):
        flags = tr.RunFlags(attn_impl=impl)
        lg, pcache = tr.forward(p, {"tokens": tokens}, c, mode="prefill",
                                flags=flags)
        cache = tr.init_cache(c, 1, GEMMA3_MAX_LEN, device=dev)
        _merge_slot_cache(cache, pcache, 0, s_max)
        del pcache
        nxt[0] = torch.argmax(lg[:, -1].float(), dim=-1)[:, None] \
            if nxt[0] is None else nxt[0]
        first, _ = tr.decode_step(p, cache, nxt[0], torch.tensor(
            [s_max], device=dev), c, flags)
        return lg, first

    calls: list = []
    with flash_attention_as(recording(flash_attention_cuda, calls)):
        runs = {"flash": prefill_and_decode(cfg, params, "flash")}
    check(len(calls) == globals_, f"{len(calls)} flash calls in a prefill "
          f"of {globals_} global layers")
    # the random weights are the reference's init (fan-in = the stacked
    # layer count, 5 for the group segment): scores in the thousands,
    # where the kernel and its plain version round an ill-conditioned
    # function, so each launch is held to float64 as llm_train holds its
    # own (REGIME_F64_RATIO), with a dropped diagonal tile above the gate
    out["flash_on_model_inputs"] = regime_forward(
        calls, f"{GEMMA3_ARCH} {s_max}-token prefill, the global layers "
        f"(B=1 S={s_max} H={cfg.n_heads} hd={cfg.resolved_head_dim})")
    del calls
    # the logits, at the reference's init and on conditioned weights
    out["logits_rel_err"] = {}
    for regime in ("reference init", "conditioned"):
        if regime == "conditioned":
            condition(params, cfg.d_model)
        runs = {"flash": prefill_and_decode(cfg, params, "flash"),
                "naive": prefill_and_decode(cfg, params, "naive")}
        with flash_attention_as(flash_attention_plain):
            runs["plain"] = prefill_and_decode(cfg, params, "flash")
        errs = {f"flash vs {b}": [rel_norm(x, y) for x, y in
                                  zip(runs["flash"], runs[b])]
                for b in ("naive", "plain")}
        del runs["plain"], runs["flash"]
        for fault in PLANTED_FAULTS:
            with flash_attention_as(planted_fault(fault)):
                lg = prefill_and_decode(cfg, params, "flash")
            errs[f"{fault} vs naive"] = [rel_norm(x, y) for x, y in
                                         zip(lg, runs["naive"])]
            del lg
        del runs
        torch.cuda.empty_cache()
        tol = GEMMA3_LOGITS_TOL[regime]
        for what, pair in errs.items():
            fault = not what.startswith("flash")
            gated = not fault or regime == "conditioned"
            print(f"{GEMMA3_ARCH} {s_max}-token prompt, {regime}, {what}: "
                  f"prefill logits ||a-b||/||b|| {pair[0]:.3e}, first decode "
                  f"logits {pair[1]:.3e} ("
                  + ((f"must exceed {tol:g}" if fault else f"tolerance {tol:g}")
                     if gated else "read, not gated: see GEMMA3_LOGITS_TOL")
                  + ")")
            if gated:
                check(max(pair) > tol if fault else max(pair) <= tol,
                      f"{regime}, {what}: the logits gate of {tol:g} "
                      f"{'cannot tell the planted fault' if fault else 'fails'}")
        out["logits_rel_err"][regime] = errs

    # -- profile of one prefill, by layer kind ---------------------------
    with annotated(attention, "swa_attention", GEMMA3_RANGES[0]), \
            annotated(tr, "_logits", GEMMA3_RANGES[1]):
        prof = profile(lambda: tr.forward(params, {"tokens": tokens}, cfg,
                                          mode="prefill"), 2,
                       f"{GEMMA3_ARCH} prefills of {s_max} tokens",
                       ranges_of=GEMMA3_RANGES)
    if "device_ms_per_run" in prof:
        kms = prof["kernels_ms_per_run"]
        flash_ms = sum(ms for n, ms in kms.items() if "fa_sm90_kernel" in n)
        gemm_ms = sum(ms for n, ms in kms.items()
                      if any(t in n.lower() for t in ("gemm", "xmma",
                                                      "cutlass", "nvjet")))
        spans = prof["range_spans_ms_per_run"]
        prof["by_kind_ms"] = dict(
            global_flash=flash_ms, gemm_kernels=gemm_ms,
            swa_span=spans.get(GEMMA3_RANGES[0]),
            logits_span=spans.get(GEMMA3_RANGES[1]))
        print(f"  a {s_max}-token prefill by kind: the {globals_} global "
              f"layers' flash launches {flash_ms:.3f} ms; the "
              f"{cfg.n_layers - globals_} local layers' swa_attention "
              f"(device span of its ranges, its own GEMMs in) "
              f"{spans.get(GEMMA3_RANGES[0], float('nan')):.3f} ms; every "
              f"GEMM kernel (the projections, MLPs, logits and swa's "
              f"einsums) {gemm_ms:.3f} ms; the logits (device span) "
              f"{spans.get(GEMMA3_RANGES[1], float('nan')):.3f} ms; device "
              f"busy {prof['device_ms_per_run']:.3f} ms [{card}]")
    out["prefill_profile"] = prof

    # -- the kernel at each served length, the soft-cap instances --------
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    rows = []
    for s in sorted(set(lens)):
        q, k, v = flash_operands(1, s, s, h, hd, cfg.activation_dtype, dev,
                                 seed=s)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        bnd = flash_bound(1, s, s, h, hd, q.dtype, True)
        rows.append(dict(
            s=s, requests=lens.count(s),
            ms=device_ms(lambda: flash_attention_cuda(q, k, v)),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
            bound_ms=max(bnd["ops_ms"], bnd["hbm_ms"]),
            bound_by="operations" if bnd["ops_ms"] >= bnd["hbm_ms"]
            else "bytes"))
        if s == max(lens):
            rows[-1]["plain_ms"] = time_ms(
                lambda: flash_attention_plain(q, k, v), warmup=1, runs=1)
        del q, k, v, qt, kt, vt
    per_path = {key: globals_ * sum(r[key] * r["requests"] for r in rows)
                for key in ("ms", "library_ms", "bound_ms")}
    top = rows[-1]
    print(f"flash_attention (wgmma) at Gemma3's global geometry (B=1 H={h} "
          f"hd={hd} causal bf16), over the path's {want} launches: "
          f"{per_path['ms']:.3f} ms, SDPA {per_path['library_ms']:.3f} ms, "
          f"bound {per_path['bound_ms']:.3f} ms; at S={top['s']}: "
          f"{top['ms']:.4f} ms a launch, SDPA {top['library_ms']:.4f} ms, "
          f"bound {top['bound_ms']:.4f} ms ({top['bound_by']}), plain "
          f"{top['plain_ms']:.3f} ms [{card}]")
    out.update(flash_rows=rows, flash_per_path=per_path)
    cap_rows = []
    for label, b, s, hh, dd, dtype in SOFTCAP_GEOMETRIES:
        q, k, v = flash_operands(b, s, s, hh, dd, dtype, dev, seed=5)
        bnd = flash_bound(b, s, s, hh, dd, dtype, True)
        cap_rows.append(dict(
            label=label, dtype=str(dtype).removeprefix("torch."),
            ms=device_ms(lambda: flash_attention_cuda(q, k, v, softcap=1.0)),
            ms_no_cap=device_ms(lambda: flash_attention_cuda(q, k, v)),
            plain_ms=time_ms(lambda: flash_attention_plain(
                q, k, v, softcap=1.0), warmup=1, runs=1),
            bound_ms=max(bnd["ops_ms"], bnd["hbm_ms"]),
            bound_by="operations" if bnd["ops_ms"] >= bnd["hbm_ms"]
            else "bytes"))
        r = cap_rows[-1]
        print(f"flash_attention soft-cap instance, {label} "
              f"{r['dtype']} causal: {r['ms']:.4f} ms a launch (the same "
              f"kernel without the cap {r['ms_no_cap']:.4f} ms), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; the tanh not "
              f"counted), plain {r['plain_ms']:.3f} ms, library: none (no "
              f"single PyTorch call soft-caps) [{card}]")
        del q, k, v
    out["softcap_rows"] = cap_rows
    out["swa"] = swa_gate(card, dev)
    out["serve_peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"{GEMMA3_ARCH} serving in bf16: peak device memory "
          f"{out['serve_peak_memory_gb']:.2f} GB [{card}]")
    del params
    torch.cuda.empty_cache()

    # -- the f32 check through the FFMA kernel ---------------------------
    l32, s32 = GEMMA3_F32
    cfg32 = dataclasses.replace(cfg, n_layers=l32, dtype="float32")
    p32 = tr.init(cfg32, torch.Generator(dev).manual_seed(1))
    tokens = tokens[:, :s32]
    s_max = s32
    nxt[0] = None
    for kernel, _ in wrappers.values():
        kernel.launches = 0
    runs = {"flash": prefill_and_decode(cfg32, p32, "flash")}
    torch.cuda.synchronize()
    counts32 = {k: wrappers[k][0].launches for k in wrappers}
    g32 = n_global(cfg32)
    check(counts32["flash_attention_ffma"] == g32 == counts32[
        "flash_attention"] and all(c == 0 for k, c in counts32.items()
                                   if k not in ("flash_attention",
                                                "flash_attention_ffma")),
          f"the f32 prefill of {l32} layers ({g32} global) launched "
          f"{counts32}")
    runs["naive"] = prefill_and_decode(cfg32, p32, "naive")
    pair = [rel_norm(x, y) for x, y in zip(runs["flash"], runs["naive"])]
    del runs, p32
    torch.cuda.empty_cache()
    print(f"{GEMMA3_ARCH} f32, {l32} layers ({g32} global, through the FFMA "
          f"kernel: {counts32['flash_attention_ffma']} launch), one {s32}-token"
          f" prompt, flash vs naive: prefill logits ||a-b||/||b|| "
          f"{pair[0]:.3e}, first decode logits {pair[1]:.3e} (tolerance "
          f"{LLM_TOL:g})")
    check(max(pair) <= LLM_TOL, "f32 flash vs naive: the logits disagree")
    out.update(f32_logits_rel_err=pair,
               launches_ffma=counts32["flash_attention_ffma"])

    # -- training at full width, the depth cut ----------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    tcfg = dataclasses.replace(cfg, n_layers=GEMMA3_TRAIN_LAYERS)
    n = tr.count_params(tcfg)
    check(n == GEMMA3_TRAIN_PARAMS, f"{n} parameters at "
          f"{GEMMA3_TRAIN_LAYERS} layers")
    state = init_train_state(tcfg, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    b, s = GEMMA3_TRAIN_BATCH
    batch_fn = make_batch_fn(SyntheticLM(tcfg, b, s, seed=0), device=dev)
    flags = tr.RunFlags(attn_impl="flash", remat=True)
    opt_cfg = AdamWConfig(total_steps=1 + GEMMA3_TRAIN_TIMED, **LLM_TRAIN_LR)
    step = make_train_step(tcfg, opt_cfg, flags)
    tg = n_global(tcfg)
    print(f"{GEMMA3_ARCH} training at full width with {GEMMA3_TRAIN_LAYERS} "
          f"of its {cfg.n_layers} layers (segments "
          f"{[(len(d), r) for d, r in tcfg.layer_segments()]}: {tg} global): "
          f"{n:,} parameters, f32 masters, moments and gradients "
          f"{16 * n / 1e9:.1f} GB (34 layers: {16 * GEMMA3_PARAMS / 1e9:.1f} "
          f"GB)")
    plain_calls = []
    for kernel, _ in wrappers.values():
        kernel.launches = 0
    times, metrics = [], []
    with counting_plain_attention(plain_calls):
        for i in range(1 + GEMMA3_TRAIN_TIMED):
            data = batch_fn(i)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, data)
            end.record()
            torch.cuda.synchronize()
            if i:
                times.append(start.elapsed_time(end))
            metrics.append({k: float(x) for k, x in m.items()})
    counts = {k: wrappers[k][0].launches for k in wrappers}
    steps_run = 1 + GEMMA3_TRAIN_TIMED
    want_train = 2 * tg * steps_run
    check(counts["flash_attention"] == want_train
          and counts["flash_attention_wgmma"] == want_train
          and all(c == 0 for k, c in counts.items()
                  if k not in ("flash_attention", "flash_attention_wgmma")),
          f"{counts} flash launches for {steps_run} steps of {tg} global "
          f"layer(s), forward and remat recompute: {want_train} expected")
    check(not plain_calls, f"the train path called the plain version "
          f"{len(plain_calls)} times on the card")
    for i, m in enumerate(metrics):
        check(all(math.isfinite(m[k]) for k in ("loss", "total_loss",
                                               "grad_norm")),
              f"step {i}: not finite: {m}")
    step_ms = statistics.median(times)
    flops = tr.model_flops_per_token(tcfg) * b * s
    out["train"] = dict(
        layers=GEMMA3_TRAIN_LAYERS, params=n, launches=counts[
            "flash_attention"], step_ms=times, step_ms_median=step_ms,
        tokens_per_s=b * s / step_ms * 1e3, model_flops=flops,
        mfu=flops / (step_ms / 1e3) / PEAK_BF16_TC_FLOPS,
        peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        losses=[m["loss"] for m in metrics])
    t = out["train"]
    print(f"{GEMMA3_ARCH} ({GEMMA3_TRAIN_LAYERS} layers) train steps of "
          f"{b}x{s} tokens: median {step_ms:.3f} ms a step "
          f"({', '.join(f'{x:.3f}' for x in times)}), "
          f"{t['tokens_per_s']:.1f} tokens/s; model FLOPs 6N x tokens = "
          f"{flops / 1e12:.2f} TFLOP a step, {100 * t['mfu']:.2f}% of the "
          f"bf16 dense peak; peak device memory {t['peak_memory_gb']:.2f} GB; "
          f"flash launches {counts['flash_attention']} = {steps_run} steps x "
          f"{tg} global layer x 2 (forward and remat recompute), all wgmma, "
          f"0 plain calls [{card}]")
    t["step_profile"] = profile(lambda: step(state, batch_fn(0)), 1,
                                f"{GEMMA3_ARCH} train steps")
    fit = make_train_step(tcfg, AdamWConfig(total_steps=LLM_FIT_STEPS,
                                            **LLM_FIT_LR), flags)
    one = batch_fn(10_000)
    losses = []
    for _ in range(LLM_FIT_STEPS):
        state, m = fit(state, one)
        losses.append(float(m["loss"]))
    t["fit_losses"] = losses
    print(f"one repeated batch, {LLM_FIT_STEPS} steps: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"the loss does not fall on one repeated batch: {losses}")
    del state["opt"]
    params = state["params"]
    torch.cuda.empty_cache()
    condition(params, tcfg.d_model)

    def grads_of(**over):
        fn = make_train_step(tcfg, opt_cfg, dataclasses.replace(flags,
                                                                **over))
        return fn.value_and_grad(params, one)[2]
    g_flash = grads_of()
    g_naive = grads_of(attn_impl="naive")
    gates = {"flash vs naive, bf16": leaf_rel(g_flash, g_naive)}
    del g_flash
    with dv_scaled_backward(GRAD_FAULT):
        g = grads_of()
    gates["planted fault vs naive, bf16"] = leaf_rel(g, g_naive)
    del g, g_naive, state, params
    torch.cuda.empty_cache()
    for label, rel in gates.items():
        worst = max(rel, key=rel.get)
        fault = label.startswith("planted")
        print(f"{GEMMA3_ARCH} gradients per leaf on conditioned weights, "
              f"{label}: worst {rel[worst]:.3e} ({worst}), "
              f"{rel[worst] / GRAD_TOL_BF16:.3f} of "
              f"{'the gate (must exceed it)' if fault else 'its tolerance'} "
              f"{GRAD_TOL_BF16:g}")
        check(rel[worst] > GRAD_TOL_BF16 if fault
              else rel[worst] <= GRAD_TOL_BF16,
              f"{label}: {worst} at {rel[worst]:.3e} against "
              f"{GRAD_TOL_BF16:g}")
    t["grad_gates"] = {k: max(v.values()) for k, v in gates.items()}
    out["launches_wgmma"] = out["launches"] + t["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    print(f"gemma3 phase: {out['seconds']:.1f} s")
    return out


# -- MiniCPM3-4B: multi-head latent attention, served and trained ------------

# The minicpm3 phase: full-width MiniCPM3-4B (62 MLA layers, d_model 2560,
# 40 heads of q·k 64 + 32 against v 64, q_lora 768, kv_lora 256, vocab
# 73,448 padded to 73,472; bf16, random weights from seed 0), its depth
# cut to MINICPM3_SERVE_LAYERS of the 62 (the script's time: every layer
# runs the same code; the serve CLI still draws all 62), serving
# MINICPM3_REQUESTS prompts of lengths drawn from seed 0 in
# MINICPM3_PROMPT_LENS, greedy, through MINICPM3_SLOTS slots: every
# prefill's attention through the wgmma kernel's bf16 (96, 64) instance,
# one launch a layer, and every decode step through the absorbed form
# (plain PyTorch over the latent cache of 288 values a token); then
# training at full width with MINICPM3_TRAIN_LAYERS of its 62 layers (16
# B a parameter of f32 masters, moments and gradients: 68.2 GB at 62
# layers, before the activations and the 73,472-wide logits; 22.1 GB at
# 16), steps of MINICPM3_TRAIN_BATCH SyntheticLM tokens.
MINICPM3_ARCH = "minicpm3-4b"
MINICPM3_PARAMS = 4_262_025_728
MINICPM3_REQUESTS = 16
MINICPM3_PROMPT_LENS = (128, 4000)
MINICPM3_SLOTS, MINICPM3_MAX_LEN, MINICPM3_MAX_NEW = 8, 4040, 32
MINICPM3_TRAIN_LAYERS = MINICPM3_SERVE_LAYERS = 16
MINICPM3_TRAIN_PARAMS = MINICPM3_SERVE_PARAMS = 1_378_978_304
MINICPM3_TRAIN_BATCH = (2, 2048)
MINICPM3_TRAIN_TIMED = 5
# the f32 check: full width with these layers, one prompt of these tokens
MINICPM3_F32 = (8, 3000)
# the absorbed decode against the expanded form: one slot, a prompt of
# this many tokens, then this many greedy decode steps
MINICPM3_DECODE = (1000, 4)
# the logits of the kernel path against the naive path's on a 4000-token
# prompt, ||a - b|| <= tol ||b||, by the weights' regime: at the
# reference's init as Gemma-7B's and Gemma3's (LLM_TOL_BF16, the faults
# read), on the same weights conditioned to fan-in = width (``condition``)
# at Gemma3's conditioned gate, with both planted faults of
# MINICPM3_FAULTS above it
MINICPM3_LOGITS_TOL = {"reference init": LLM_TOL_BF16, "conditioned": 3e-2}
MINICPM3_FAULTS = ("diagonal tile dropped", "dv scale")
# the f32 check's logits against the naive path's
MINICPM3_F32_TOL = 1e-4
# each decode step's logits against the last row of the expanded form's
# prefill of the prompt plus the tokens so far, ||a - b|| <= tol ||b||:
# in bf16 (the served layers, conditioned weights) at the logits' gate; in f32
# (MINICPM3_F32's layers, the reference's init) at the f32 logits'.
# W_uk and W_uv swapped in the decode (each head's halves of wkv_b;
# qk_nope = v_head_dim) must exceed both.
MINICPM3_DECODE_TOL = {torch.bfloat16: MINICPM3_LOGITS_TOL["conditioned"],
                       torch.float32: MINICPM3_F32_TOL}
# the plain version's tiles in the per-launch float64 gate (regime_forward):
# 256 x 256 in place of the kernel's 128 x 64, so that a launch at S =
# 4000 walks 128 tile pairs, not ~1000
MINICPM3_PLAIN_TILES = dict(block_q=256, block_k=256)
# the tiny preset's runs on the card, through the (48, 32) instance: the
# train CLI's arguments, and the f32 engine's prompts (flash vs naive)
MINICPM3_TINY_TRAIN = ["--preset", "tiny", "--steps", "3", "--batch", "2",
                       "--seq", "256"]
MINICPM3_TINY_PROMPTS = (70, 300, 131)


def swapped_absorption():
    """Inside: MLA's absorbed decode applies W_uv where W_uk goes and W_uk
    where W_uv goes (each head's two halves of ``wkv_b`` swapped, which
    needs qk_nope = v_head_dim); train and prefill untouched."""
    from repro_torch.models import attention
    mla = attention.mla_apply

    def faulty(params, x, cfg, desc, *, mode="train", **kw):
        if mode == "decode":
            kl, h = cfg.kv_lora_rank, cfg.n_heads
            w = params["wkv_b"].reshape(kl, h, 2, -1).flip(2)
            params = dict(params, wkv_b=w.reshape(kl, -1))
        return mla(params, x, cfg, desc, mode=mode, **kw)
    return swapped(attention, "mla_apply", faulty)


def split_bound(b, s, t, h, dk, dv, dtype, causal) -> dict:
    """The least time the card could take for one attention call at the
    split head dims: the larger of its operations' time (2 dk FLOPs of
    q·k and 2 dv of p·v for each (query, key) pair the mask lets
    through, at the bf16 tensor-core rate for bf16 operands and the FP32
    rate for f32) and its bytes' time (q, k, v read once, the output
    written once)."""
    pairs = sum(min(i + 1, t) for i in range(s)) if causal else s * t
    flops = 2.0 * b * h * (dk + dv) * pairs
    nbytes = torch.finfo(dtype).bits // 8 * b * h * (s * dk + t * dk
                                                     + t * dv + s * dv)
    peak = PEAK_BF16_TC_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    ops_ms, hbm_ms = flops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return dict(flops=flops, bytes=nbytes, ops_ms=ops_ms, hbm_ms=hbm_ms,
                bound_ms=max(ops_ms, hbm_ms),
                bound_by="operations" if ops_ms >= hbm_ms else "bytes")


def sdpa_backend(q, k, v, causal: bool = True) -> str:
    """The backend ``F.scaled_dot_product_attention`` picks for (B, H, S,
    hd) q, k, v, causal or not (read from PyTorch's own chooser)."""
    from torch.nn.attention import SDPBackend
    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v,
                                                  is_causal=causal)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        return f"unknown ({type(e).__name__})"


def split_launch_row(label, b, s, h, dk, dv, dtype, dev, on_card,
                     causal: bool = True, plain_tiles: dict | None = None
                     ) -> dict:
    """One launch (causal, or full at ``causal=False``) of the instance at
    (B, S, H, dk/dv) that the variant table names (``variant``): the
    kernel's device ms, its plain version's ms (over ``plain_tiles``,
    default the kernel's), one SDPA call's on the same q, k, v (which
    takes Ev != E) and the backend it picked, the bound; and the kernel
    against its plain version (max abs error).  Where that is the wgmma
    kernel and the FFMA kernel is built for the geometry too, ``ffma``
    holds the FFMA instance's ms and error on the same q, k, v, the
    yardstick."""
    from repro_torch.kernels.flash_attention import (FFMA_GEOMETRIES,
                                                     flash_attention_cuda,
                                                     flash_attention_ffma,
                                                     flash_attention_plain,
                                                     kernel_variant)
    q, k, v = flash_operands(b, s, s, h, dk, dtype, dev, seed=s + dk, dv=dv)
    variant = kernel_variant(dtype, dk, dv)
    tiles = plain_tiles or {}
    row = dict(label=label, b=b, s=s, h=h, dk=dk, dv=dv, variant=variant,
               dtype=str(dtype).removeprefix("torch."), causal=causal,
               plain_tiles=tiles or None,
               **split_bound(b, s, s, h, dk, dv, dtype, causal))
    if not on_card:
        return row
    atol, rtol = FLASH_TOL[dtype]
    ref = flash_attention_plain(q, k, v, causal=causal, **tiles)
    attends = {variant: flash_attention_cuda}
    if variant == "wgmma" and (dtype, dk, dv) in FFMA_GEOMETRIES:
        attends["ffma"] = flash_attention_ffma
    for name, attend in attends.items():
        got = attend(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        check(torch.allclose(got.float(), ref.float(), atol=atol, rtol=rtol),
              f"{label}: the {name} kernel disagrees with its plain version")
        ms = device_ms(lambda: attend(q, k, v, causal=causal), **(
            dict(warmup=1, runs=5) if name != variant else {}))
        if name == variant:
            row.update(max_abs_err=err, ms=ms)
        else:
            row[name] = dict(max_abs_err=err, ms=ms,
                             tflops=row["flops"] / (ms / 1e3) / 1e12)
        del got
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    row.update(
        plain_ms=time_ms(lambda: flash_attention_plain(
            q, k, v, causal=causal, **tiles), warmup=1, runs=1),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)),
        library_backend=sdpa_backend(qt, kt, vt, causal))
    row["tflops"] = row["flops"] / (row["ms"] / 1e3) / 1e12
    return row


def ffma_ms(row: dict) -> str:
    """The FFMA yardstick of a ``split_launch_row`` row, as printed."""
    f = row.get("ffma")
    return (f"{f['ms']:.4f} ms ({f['tflops']:.2f} TFLOP/s, max_abs_err "
            f"{f['max_abs_err']:.3e})" if f else "not run")


def reset_flash_counts(wrappers: dict) -> None:
    """Every flash wrapper's count, and both kernels' counts by geometry,
    at 0."""
    from repro_torch.kernels.flash_attention import (flash_attention_ffma,
                                                     flash_attention_wgmma)
    for kern, _ in wrappers.values():
        kern.launches = 0
    flash_attention_ffma.launches_by_geometry.clear()
    flash_attention_wgmma.launches_by_geometry.clear()


def read_flash_counts(wrappers: dict) -> tuple[dict, dict]:
    """Launches by wrapper, and by (dtype, dk, dv) both kernels'
    summed (each kernel's own count tells them apart)."""
    from repro_torch.kernels.flash_attention import (flash_attention_ffma,
                                                     flash_attention_wgmma)
    geo = dict(flash_attention_ffma.launches_by_geometry)
    for key, n in flash_attention_wgmma.launches_by_geometry.items():
        geo[key] = geo.get(key, 0) + n
    return {k: wrappers[k][0].launches for k in wrappers}, geo


def check_flash_path(on_card: bool, counts, geo, plain_calls, want, key,
                     what) -> None:
    """``want`` launches of the ``key`` instance (none at all for ``key``
    None) through its kernel, no other launch, no plain call (on the
    card)."""
    from repro_torch.kernels.flash_attention import kernel_variant
    if not on_card:
        return
    if key is None:
        check(all(c == 0 for c in counts.values()) and not geo,
              f"{what}: {counts}, {geo}: no flash launch expected")
    else:
        name = FLASH_VARIANTS[kernel_variant(*key)]
        check(counts["flash_attention"] == counts[name] == geo.get(key)
              == want and sum(geo.values()) == want
              and all(c == 0 for k, c in counts.items()
                      if k not in ("flash_attention", name)),
              f"{what}: {counts}, {geo}: {want} launches of the {key} "
              f"instance through {name} expected")
    check(not plain_calls, f"{what} called the plain version "
          f"{len(plain_calls)} times on the card")


def train_llm(c, dev, card: str, wrappers: dict, note: str, key,
              want_per_step: int, batch_shape: tuple, timed: int,
              profile_steps: bool = False):
    """Training ``c`` at ``batch_shape``: one warm and ``timed`` timed
    steps (counts at 0 just before, read just after), finite losses and
    gradient norms; with ``profile_steps`` a profile of a step on the
    card.  Returns the record and a function of the gradients on
    conditioned weights at other flags."""
    from repro_torch.data.pipeline import SyntheticLM, make_batch_fn
    from repro_torch.models import transformer as tr
    from repro_torch.sharding.parity import condition
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    n = tr.count_params(c)
    state = init_train_state(c, torch.Generator(dev).manual_seed(0))
    if on_card:
        torch.cuda.synchronize(dev)
    b, s = batch_shape
    batch_fn = make_batch_fn(SyntheticLM(c, b, s, seed=0), device=dev)
    flags = tr.RunFlags(attn_impl="flash", remat=True)
    opt_cfg = AdamWConfig(total_steps=1 + timed, **LLM_TRAIN_LR)
    step = make_train_step(c, opt_cfg, flags)
    print(f"{c.name} training {note}: {n:,} parameters, f32 masters, "
          f"moments and gradients {16 * n / 1e9:.1f} GB")
    plain_calls: list = []
    reset_flash_counts(wrappers)
    times, metrics = [], []
    with counting_plain_attention(plain_calls):
        for i in range(1 + timed):
            data = batch_fn(i)
            if on_card:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, m = step(state, data)
            if on_card:
                torch.cuda.synchronize(dev)
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(x) for k, x in m.items()})
    counts, geo = read_flash_counts(wrappers)
    check_flash_path(on_card, counts, geo, plain_calls,
                     want_per_step * (1 + timed), key,
                     f"{c.name} training ({1 + timed} steps)")
    for i, m in enumerate(metrics):
        check(all(math.isfinite(m[k]) for k in ("loss", "total_loss",
                                               "grad_norm")),
              f"{c.name} step {i}: not finite: {m}")
    step_ms = statistics.median(times)
    flops = tr.model_flops_per_token(c) * b * s
    t = dict(params=n, launches=counts["flash_attention"],
             step_ms=times, step_ms_median=step_ms,
             tokens_per_s=b * s / step_ms * 1e3, model_flops=flops,
             mfu=flops / (step_ms / 1e3) / PEAK_BF16_TC_FLOPS,
             peak_memory_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                             if on_card else None),
             losses=[m["loss"] for m in metrics],
             grad_norms=[m["grad_norm"] for m in metrics],
             tokens=[m["tokens"] for m in metrics])
    unit = "frames" if c.family == "encoder" else "tokens"
    print(f"{c.name} train steps of {b}x{s} {unit}: median "
          f"{step_ms:.3f} ms a step ("
          f"{', '.join(f'{x:.3f}' for x in times)}"
          f"; host clock after a synchronise), "
          f"{t['tokens_per_s']:.1f} {unit}/s; model FLOPs 6N x {unit} = "
          f"{flops / 1e12:.2f} TFLOP a step, {100 * t['mfu']:.2f}% of the "
          f"bf16 dense peak; peak device memory "
          f"{t['peak_memory_gb'] or 0:.2f} GB; flash launches "
          f"{counts['flash_attention']} ({geo}), {len(plain_calls)} plain "
          f"calls [{card}]")
    print(f"  losses {', '.join(f'{x:.4f}' for x in t['losses'])} over "
          f"{t['tokens'][0]:g} weighted {unit}; grad norms "
          f"{', '.join(f'{x:.3e}' for x in t['grad_norms'])}")
    if on_card and profile_steps:
        t["step_profile"] = profile(lambda: step(state, batch_fn(0)), 1,
                                    f"{c.name} train steps")
    one = batch_fn(10_000)
    del state["opt"]
    params = state["params"]
    if on_card:
        torch.cuda.empty_cache()
    condition(params, c.d_model)

    def grads_of(**over):
        fn = make_train_step(c, opt_cfg, dataclasses.replace(flags, **over))
        return fn.value_and_grad(params, one)[2]
    return t, grads_of


def minicpm3_phase(card, dev, wrappers, *, cfg=None,
                   requests: int = MINICPM3_REQUESTS,
                   prompt_lens: tuple[int, int] = MINICPM3_PROMPT_LENS,
                   decode: tuple[int, int] = MINICPM3_DECODE,
                   f32: tuple[int, int] = MINICPM3_F32,
                   train_layers: int = MINICPM3_TRAIN_LAYERS,
                   train_batch: tuple[int, int] = MINICPM3_TRAIN_BATCH
                   ) -> dict:
    """Full-width MiniCPM3-4B (``cfg``, default the registered config at
    MINICPM3_SERVE_LAYERS layers):
    serving through ``DecodeEngine.run`` (every counter at 0 just before,
    read just after: one launch of the bf16 (96, 64) instance of the
    kernel the variant table names, the wgmma one, a layer a prefill,
    none of the FFMA kernel, no plain call), TTFT, prefill and decode
    rates; every launch of a 4000-token prefill against float64
    (``regime_forward``); the kernel path's logits against the naive
    path's at the reference's init and on conditioned weights, with the
    planted faults; the absorbed decode against the expanded form, with
    W_uk and W_uv swapped as its fault; a profile of the prefill by kind
    and one launch at (1, 4000, 40, 96/64) beside the FFMA instance, its
    plain version, SDPA and the bound; the serve CLI at full width; the
    f32 check
    through the (96, 64) f32 instance; the tiny preset through the (48,
    32) instances (the train CLI in bf16, an f32 engine against the naive
    one); then training with the depth cut: step time, tokens/s,
    model-FLOP share, peak memory, the optimizer's time, the loss falling
    on one batch and the bf16 gradient gate with its planted fault on
    ``wkv_b``.  The keywords shrink it for a rehearsal on the CPU (the
    kernels' plain versions, no counts, no times)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM, make_batch_fn
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_ffma,
                                                     flash_attention_plain,
                                                     kernel_variant)
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as tr
    from repro_torch.serve.engine import EngineConfig, _merge_slot_cache
    from repro_torch.train.checkpoint import tree_leaves
    from repro_torch.train.optimizer import AdamWConfig, adamw_update
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step)
    on_card = dev.type == "cuda"
    full_width = cfg is None
    cfg = cfg or dataclasses.replace(get_config(MINICPM3_ARCH),
                                     n_layers=MINICPM3_SERVE_LAYERS)
    kernel = flash_attention_cuda if on_card else flash_attention_plain
    ffma_geo = flash_attention_ffma.launches_by_geometry
    bf16_key = (torch.bfloat16, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                cfg.v_head_dim)
    f32_key = (torch.float32,) + bf16_key[1:]
    # the kernel of the served and trained geometry, and its count's name
    variant = kernel_variant(*bf16_key)
    main_kernel = FLASH_VARIANTS[variant]
    check(cfg.qk_nope_head_dim == cfg.v_head_dim, "the swapped-absorption "
          "fault needs qk_nope_head_dim = v_head_dim")

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def live_rel(a, b):
        """rel_norm over the live vocab: the padding columns (73,448 of
        73,472 are live) hold -1e30 on both sides and would swamp it."""
        return rel_norm(a[..., :cfg.vocab], b[..., :cfg.vocab])

    t_phase = time.perf_counter()
    out: dict = {}
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tr.init(cfg, torch.Generator(dev).manual_seed(0))
    sync()
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == tr.count_params(cfg)
          and (n_params == MINICPM3_SERVE_PARAMS or not full_width),
          f"{n_params} parameters, not {MINICPM3_SERVE_PARAMS}")
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    L = cfg.n_layers
    dk, dv = bf16_key[1:]
    print(f"{MINICPM3_ARCH}: {L} MLA layers (of 62), d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of q·k {cfg.qk_nope_head_dim} + "
          f"{cfg.qk_rope_head_dim} against v {dv}, q_lora {cfg.q_lora_rank},"
          f" kv_lora {cfg.kv_lora_rank}, vocab {cfg.vocab} (padded "
          f"{cfg.padded_vocab}): {n_params:,} parameters, "
          f"{weight_bytes / 1e9:.2f} GB in {cfg.dtype}, drawn in "
          f"{time.perf_counter() - t0:.1f} s; the latent cache "
          f"{L * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2} B a token")

    # -- serving: the main path ------------------------------------------
    gen = torch.Generator().manual_seed(0)
    lens = torch.randint(prompt_lens[0], prompt_lens[1] + 1, (requests,),
                         generator=gen).tolist()
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist()
               for n in lens]
    max_len = prompt_lens[1] + MINICPM3_MAX_NEW + 8
    ecfg = EngineConfig(n_slots=MINICPM3_SLOTS, max_len=max_len,
                        max_new=MINICPM3_MAX_NEW, temperature=0.0)
    # a warm-up request through the same code
    serve_requests(cfg, params, dataclasses.replace(ecfg, n_slots=1),
                   [prompts[0][:prompt_lens[0]]], "flash", wrappers, dev)
    plain_calls: list = []
    reset_flash_counts(wrappers)
    with counting_plain_attention(plain_calls):
        reqs, admits, steps, wall, counts = serve_requests(
            cfg, params, ecfg, prompts, "flash", wrappers, dev)
    geo = read_flash_counts(wrappers)[1]
    want = L * requests
    if on_card:
        check(counts["flash_attention"] == counts[main_kernel]
              == geo.get(bf16_key) == want and sum(geo.values()) == want,
              f"{counts}, {geo}: {want} launches of the {dk}/{dv} bf16 "
              f"{variant} instance expected ({requests} prefills of {L} "
              f"layers)")
        check(all(c == 0 for k, c in counts.items()
                  if k not in ("flash_attention", main_kernel)),
              f"the MiniCPM3 path launched another kernel: {counts}")
        check(not plain_calls, f"the MiniCPM3 path called the plain version "
              f"{len(plain_calls)} times on the card")
    for r in reqs:
        check(r.done and len(r.generated) == MINICPM3_MAX_NEW
              and all(0 <= t < cfg.vocab for t in r.generated),
              f"request {r.rid}: done {r.done}, {len(r.generated)} tokens")
    prefill_s = sum(d for _, d in admits.values())
    decode_s = sum(d for d, _ in steps)
    decode_tokens = sum(n for _, n in steps)
    full_steps = [d * 1e3 for d, n in steps if n == MINICPM3_SLOTS]
    step_ms = statistics.median(full_steps or [d * 1e3 for d, _ in steps])
    ttft = sorted((len(r.prompt), sum(admits[r.rid]) * 1e3,
                   admits[r.rid][1] * 1e3) for r in reqs)
    top = ttft[-1]
    print(f"{MINICPM3_ARCH} served {requests} requests ({sum(lens)} prompt "
          f"tokens, {MINICPM3_MAX_NEW} new each) in {wall:.3f} s through "
          f"{MINICPM3_SLOTS} slots: {counts['flash_attention']} flash "
          f"launches = {L} layers x {requests} prefills, all through the "
          f"{variant} kernel's {dk}/{dv} instance ({geo}), "
          f"{counts['flash_attention_ffma']} FFMA "
          f"({ffma_geo.get(bf16_key, 0)} at {dk}/{dv} bf16), "
          f"{len(plain_calls)} plain calls [{card}]")
    for n, t, pre in ttft:
        print(f"  prompt {n:4d} tokens: prefill {pre:9.3f} ms, time to "
              f"first token {t:9.3f} ms")
    print(f"prefill: {sum(lens)} tokens in {prefill_s:.3f} s = "
          f"{sum(lens) / prefill_s:.1f} tokens/s; at the longest prompt "
          f"({top[0]} tokens) TTFT {top[1]:.3f} ms, "
          f"{top[0] / top[2] * 1e3:.1f} tokens/s; decode: {len(steps)} "
          f"engine steps, median {step_ms:.3f} ms a step at "
          f"{MINICPM3_SLOTS} slots ({len(full_steps)} such steps), "
          f"{decode_tokens} tokens in {decode_s:.3f} s = "
          f"{decode_tokens / decode_s:.1f} tokens/s (HBM bound of a step's "
          f"weights {weight_bytes / PEAK_HBM_BYTES * 1e3:.3f} ms) [{card}]")
    out.update(
        arch=MINICPM3_ARCH, params=n_params, weight_gb=weight_bytes / 1e9,
        prompt_lens=lens, wall_s=wall, variant=variant,
        launches=counts["flash_attention"],
        launches_by_geometry={str(k): v for k, v in geo.items()},
        requests=[dict(prompt=n, ttft_ms=t, prefill_ms=pre)
                  for n, t, pre in ttft],
        ttft_ms_longest=top[1], prefill_tokens_per_s_longest=top[0] / top[2]
        * 1e3, prefill_tokens_per_s=sum(lens) / prefill_s,
        decode_steps=len(steps), decode_step_ms_median=step_ms,
        decode_tokens_per_s=decode_tokens / decode_s)
    del reqs

    # -- every launch of the longest prefill against float64 -------------
    s_max = prompt_lens[1]
    tokens = torch.randint(0, cfg.vocab, (1, s_max), generator=gen).to(dev)
    nxt = [None]

    def prefill_and_decode(c, p, impl):
        flags = tr.RunFlags(attn_impl=impl)
        lg, pcache = tr.forward(p, {"tokens": tokens}, c, mode="prefill",
                                flags=flags)
        cache = tr.init_cache(c, 1, max_len, device=dev)
        _merge_slot_cache(cache, pcache, 0, tokens.shape[1])
        del pcache
        nxt[0] = torch.argmax(lg[:, -1].float(), dim=-1)[:, None] \
            if nxt[0] is None else nxt[0]
        first, _ = tr.decode_step(p, cache, nxt[0], torch.tensor(
            [tokens.shape[1]], device=dev), c, flags)
        return lg, first

    calls: list = []
    with attend_as(dev, recording(kernel, calls)):
        prefill_and_decode(cfg, params, "flash")
    check(len(calls) == L, f"{len(calls)} flash calls in a prefill of {L} "
          f"layers")
    out["flash_on_model_inputs"] = regime_forward(
        calls, f"{MINICPM3_ARCH} {s_max}-token prefill (B=1 S={s_max} "
        f"H={cfg.n_heads} dk={dk} dv={dv})", MINICPM3_PLAIN_TILES)
    del calls

    # -- the kernel path's logits against the naive path's ---------------
    faults = {"diagonal tile dropped": planted_fault("diagonal tile dropped"),
              "dv scale": scaled_by_dv(kernel)}
    out["logits_rel_err"] = {}
    for regime in ("reference init", "conditioned"):
        if regime == "conditioned":
            condition(params, cfg.d_model)
        runs = {impl: prefill_and_decode(cfg, params, impl)
                for impl in ("flash", "naive")}
        errs = {"flash vs naive": [live_rel(x, y) for x, y in
                                   zip(runs["flash"], runs["naive"])]}
        del runs["flash"]
        for fault in MINICPM3_FAULTS:
            with attend_as(dev, faults[fault]):
                lg = prefill_and_decode(cfg, params, "flash")
            errs[f"{fault} vs naive"] = [live_rel(x, y) for x, y in
                                         zip(lg, runs["naive"])]
            del lg
        del runs
        if on_card:
            torch.cuda.empty_cache()
        tol = MINICPM3_LOGITS_TOL[regime]
        for what, pair in errs.items():
            fault = not what.startswith("flash")
            gated = not fault or regime == "conditioned"
            print(f"{MINICPM3_ARCH} {s_max}-token prompt, {regime}, {what}: "
                  f"prefill logits ||a-b||/||b|| {pair[0]:.3e}, first decode "
                  f"logits {pair[1]:.3e} ("
                  + ((f"must exceed {tol:g}" if fault else f"tolerance {tol:g}")
                     if gated else "read, not gated: see MINICPM3_LOGITS_TOL")
                  + ")")
            if gated:
                check(max(pair) > tol if fault else max(pair) <= tol,
                      f"{regime}, {what}: the logits gate of {tol:g} "
                      f"{'cannot tell the planted fault' if fault else 'fails'}")
        out["logits_rel_err"][regime] = errs

    # -- the absorbed decode against the expanded form -------------------
    def absorbed_vs_expanded(c, p, n_prompt, n_steps):
        """One slot: the prefill of ``n_prompt`` tokens, then ``n_steps``
        greedy decode steps; each step's logits against the last row of
        the expanded form's prefill of the prompt and the tokens so far,
        ||a - b|| / ||b||."""
        flags = tr.RunFlags(attn_impl="flash")
        seq = tokens[:, :n_prompt]
        lg, pcache = tr.forward(p, {"tokens": seq}, c, mode="prefill",
                                flags=flags, last_logit_only=True)
        cache = tr.init_cache(c, 1, n_prompt + n_steps + 1, device=dev)
        _merge_slot_cache(cache, pcache, 0, n_prompt)
        del pcache
        nxt_tok = torch.argmax(lg[:, -1].float(), dim=-1)[:, None]
        errs = []
        for i in range(n_steps):
            step_lg, cache = tr.decode_step(p, cache, nxt_tok, torch.tensor(
                [n_prompt + i], device=dev), c, flags)
            seq = torch.cat([seq, nxt_tok], dim=1)
            ref, _ = tr.forward(p, {"tokens": seq}, c, mode="prefill",
                                flags=flags, last_logit_only=True)
            errs.append(live_rel(step_lg, ref[:, -1]))
            nxt_tok = torch.argmax(step_lg.float(), dim=-1)[:, None]
        return errs

    def decode_gate(c, p, what):
        tol = MINICPM3_DECODE_TOL[c.activation_dtype]
        got = absorbed_vs_expanded(c, p, *decode)
        with swapped_absorption():
            bad = absorbed_vs_expanded(c, p, *decode)
        print(f"{MINICPM3_ARCH} {what}: the absorbed decode against the "
              f"expanded form, {decode[1]} steps after a {decode[0]}-token "
              f"prompt: ||a-b||/||b|| {', '.join(f'{x:.3e}' for x in got)} "
              f"(tolerance {tol:g}); W_uk and W_uv swapped "
              f"{', '.join(f'{x:.3e}' for x in bad)} (must exceed it)")
        check(max(got) <= tol, f"{what}: the absorbed decode disagrees "
              f"with the expanded form: {got}")
        check(min(bad) > tol, f"{what}: the decode gate cannot tell W_uk "
              f"and W_uv swapped: {bad}")
        return dict(rel_err=got, swapped=bad, tol=tol)
    out["decode_vs_expanded"] = decode_gate(
        cfg, params, f"{cfg.dtype}, {L} layers, conditioned weights")

    # -- profile of one prefill by kind, one launch timed ------------------
    if on_card:
        prof = profile(lambda: tr.forward(params, {"tokens": tokens}, cfg,
                                          mode="prefill"), 2,
                       f"{MINICPM3_ARCH} prefills of {s_max} tokens")
        if "device_ms_per_run" in prof:
            kms = prof["kernels_ms_per_run"]
            flash_ms = sum(ms for n, ms in kms.items()
                           if "fa_kernel" in n or "fa_sm90_kernel" in n)
            gemm_ms = sum(ms for n, ms in kms.items()
                          if any(t in n.lower() for t in
                                 ("gemm", "xmma", "cutlass", "nvjet")))
            busy = prof["device_ms_per_run"]
            prof["by_kind_ms"] = dict(flash=flash_ms, gemm_kernels=gemm_ms,
                                      other=busy - flash_ms - gemm_ms)
            print(f"  a {s_max}-token prefill by kind: the {L} flash "
                  f"launches {flash_ms:.3f} ms, every GEMM kernel (the "
                  f"projections, MLPs and logits) {gemm_ms:.3f} ms, the rest "
                  f"(norms, RoPE, concatenations, elementwise) "
                  f"{busy - flash_ms - gemm_ms:.3f} ms; device busy "
                  f"{busy:.3f} ms of a {prof['wall_ms_per_run']:.3f} ms "
                  f"wall [{card}]")
        out["prefill_profile"] = prof
    row = split_launch_row(f"{MINICPM3_ARCH} serving", 1, s_max,
                           cfg.n_heads, dk, dv, cfg.activation_dtype, dev,
                           on_card)
    out["launch"] = row
    if on_card:
        print(f"flash_attention ({variant} {dk}/{dv}) at B=1 S={s_max} "
              f"H={cfg.n_heads} causal {row['dtype']}: {row['ms']:.4f} ms a "
              f"launch ({row['tflops']:.2f} TFLOP/s), plain "
              f"{row['plain_ms']:.3f} ms, SDPA {row['library_ms']:.4f} ms "
              f"(backend {row['library_backend']}), bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{row['flops'] / 1e9:.1f} GFLOP, {row['bytes'] / 1e6:.1f} "
              f"MB); over the {L} launches of the prefill "
              f"{L * row['ms']:.3f} ms; the FFMA instance on the same "
              f"q, k, v {ffma_ms(row)} [{card}]")
        out["serve_peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"{MINICPM3_ARCH} serving in bf16: peak device memory "
              f"{out['serve_peak_memory_gb']:.2f} GB [{card}]")
    del params
    if on_card:
        torch.cuda.empty_cache()
    # the serve CLI at full width (random weights from seed 0)
    if full_width:
        _, cli_reqs = serve_cli.main(["--arch", MINICPM3_ARCH, "--preset",
                                      "full", "--requests", "2",
                                      "--max-new", "4", "--device",
                                      dev.type])
        check(all(r.done and len(r.generated) == 4 for r in cli_reqs),
              "the serve CLI at full width did not finish its requests")
        if on_card:
            torch.cuda.empty_cache()

    # -- the f32 check through the (96, 64) f32 instance -----------------
    l32, s32 = f32
    cfg32 = dataclasses.replace(cfg, n_layers=l32, dtype="float32")
    p32 = tr.init(cfg32, torch.Generator(dev).manual_seed(1))
    tokens = tokens[:, :s32]
    nxt[0] = None
    reset_flash_counts(wrappers)
    runs = {"flash": prefill_and_decode(cfg32, p32, "flash")}
    sync()
    counts32, geo32 = read_flash_counts(wrappers)
    if on_card:
        check(counts32["flash_attention_ffma"] == l32
              == counts32["flash_attention"] == geo32.get(f32_key)
              and sum(geo32.values()) == l32,
              f"the f32 prefill of {l32} layers launched {counts32}, {geo32}")
    runs["naive"] = prefill_and_decode(cfg32, p32, "naive")
    pair = [live_rel(x, y) for x, y in zip(runs["flash"], runs["naive"])]
    del runs
    print(f"{MINICPM3_ARCH} f32, {l32} layers (through the FFMA kernel's "
          f"{dk}/{dv} f32 instance: {geo32.get(f32_key, 0)} launches), one "
          f"{s32}-token prompt, flash vs naive: prefill logits ||a-b||/||b|| "
          f"{pair[0]:.3e}, first decode logits {pair[1]:.3e} (tolerance "
          f"{MINICPM3_F32_TOL:g})")
    check(max(pair) <= MINICPM3_F32_TOL, "f32 flash vs naive: the logits "
          "disagree")
    out.update(f32_logits_rel_err=pair,
               launches_f32=geo32.get(f32_key, 0),
               f32_decode_vs_expanded=decode_gate(
                   cfg32, p32, f"float32, {l32} layers, the reference's "
                   f"init"))
    out["launch_f32"] = split_launch_row(
        f"{MINICPM3_ARCH} f32 check", 1, s32, cfg.n_heads, dk, dv,
        torch.float32, dev, on_card)
    del p32
    if on_card:
        torch.cuda.empty_cache()

    # -- the tiny preset through the (48, 32) instances ------------------
    tiny = train_cli.reduced_config(MINICPM3_ARCH, "tiny")
    tk = (tiny.qk_nope_head_dim + tiny.qk_rope_head_dim, tiny.v_head_dim)
    with tempfile.TemporaryDirectory() as ckpt:
        reset_flash_counts(wrappers)
        loop, _ = train_cli.main(["--arch", MINICPM3_ARCH]
                                 + MINICPM3_TINY_TRAIN
                                 + ["--ckpt-dir", ckpt, "--device", dev.type])
        sync()
        _, geo_cli = read_flash_counts(wrappers)
    cli_steps = int(MINICPM3_TINY_TRAIN[MINICPM3_TINY_TRAIN.index("--steps")
                                        + 1])
    want_cli = cli_steps * tiny.n_layers * 2
    tiny_bf16 = (torch.bfloat16,) + tk
    if on_card:
        check(geo_cli == {tiny_bf16: want_cli}, f"the tiny train CLI "
              f"launched {geo_cli}: {want_cli} launches of the {tk} bf16 "
              f"instance expected (forward and remat recompute)")
    tiny32 = dataclasses.replace(tiny, dtype="float32")
    tp = tr.init(tiny32, torch.Generator(dev).manual_seed(0))
    tprompts = [torch.randint(0, tiny.vocab, (n,), generator=torch.Generator(
        ).manual_seed(n)).tolist() for n in MINICPM3_TINY_PROMPTS]
    tiny_tokens, tiny_geo = {}, {}
    for impl in ("flash", "naive"):
        reset_flash_counts(wrappers)
        treqs, *_ = serve_requests(
            tiny32, tp, EngineConfig(n_slots=2, max_len=320, max_new=5),
            tprompts, impl, wrappers, dev)
        tiny_geo[impl] = read_flash_counts(wrappers)[1]
        tiny_tokens[impl] = [r.generated for r in treqs]
    tiny_f32 = (torch.float32,) + tk
    want_tiny = tiny.n_layers * len(tprompts)
    if on_card:
        check(tiny_geo == {"flash": {tiny_f32: want_tiny}, "naive": {}},
              f"the tiny f32 engine launched {tiny_geo}: {want_tiny} "
              f"launches of the {tk} f32 instance expected on flash")
    check(tiny_tokens["flash"] == tiny_tokens["naive"], "the tiny f32 "
          "engine's greedy tokens differ between flash and naive")
    check(loop.steps == cli_steps, f"the tiny train CLI ran {loop.steps} "
          f"steps of {cli_steps}")
    print(f"{MINICPM3_ARCH} tiny preset ({tiny.n_layers} layers, q·k {tk[0]}"
          f" against v {tk[1]}): the train CLI's {cli_steps} steps launched "
          f"the bf16 {tk[0]}/{tk[1]} instance {geo_cli.get(tiny_bf16, 0)} "
          f"times; an f32 "
          f"engine's {len(tprompts)} prompts launched the f32 instance "
          f"{tiny_geo['flash'].get(tiny_f32, 0)} times, greedy tokens "
          f"equal to the naive engine's")
    out.update(tiny_launches_bf16=geo_cli.get(tiny_bf16, 0),
               tiny_launches_f32=tiny_geo["flash"].get(tiny_f32, 0),
               tiny_launch_bf16=split_launch_row(
                   "tiny train CLI", 2, 256, tiny.n_heads, *tk,
                   torch.bfloat16, dev, on_card),
               tiny_launch_f32=split_launch_row(
                   "tiny f32 engine", 1, max(MINICPM3_TINY_PROMPTS),
                   tiny.n_heads, *tk, torch.float32, dev, on_card))
    del tp

    # -- training at full width, the depth cut ----------------------------
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    tcfg = dataclasses.replace(cfg, n_layers=train_layers)
    n = tr.count_params(tcfg)
    check(n == MINICPM3_TRAIN_PARAMS or not full_width,
          f"{n} parameters at {train_layers} layers")
    state = init_train_state(tcfg, torch.Generator(dev).manual_seed(0))
    sync()
    b, s = train_batch
    batch_fn = make_batch_fn(SyntheticLM(tcfg, b, s, seed=0), device=dev)
    flags = tr.RunFlags(attn_impl="flash", remat=True)
    opt_cfg = AdamWConfig(total_steps=1 + MINICPM3_TRAIN_TIMED,
                          **LLM_TRAIN_LR)
    step = make_train_step(tcfg, opt_cfg, flags)
    print(f"{MINICPM3_ARCH} training at full width with {train_layers} of "
          f"its 62 layers: {n:,} parameters, f32 masters, moments and "
          f"gradients {16 * n / 1e9:.1f} GB (62 layers: "
          f"{16 * MINICPM3_PARAMS / 1e9:.1f} GB)")
    plain_calls = []
    reset_flash_counts(wrappers)
    times, metrics = [], []
    with counting_plain_attention(plain_calls):
        for i in range(1 + MINICPM3_TRAIN_TIMED):
            data = batch_fn(i)
            sync()
            t0 = time.perf_counter()
            state, m = step(state, data)
            sync()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(x) for k, x in m.items()})
    counts, geo = read_flash_counts(wrappers)
    steps_run = 1 + MINICPM3_TRAIN_TIMED
    want_train = 2 * train_layers * steps_run
    if on_card:
        check(counts["flash_attention"] == counts[main_kernel]
              == geo.get(bf16_key) == want_train
              and all(c == 0 for k, c in counts.items()
                      if k not in ("flash_attention", main_kernel)),
              f"{counts}, {geo}: {want_train} launches of the {dk}/{dv} "
              f"bf16 {variant} instance expected ({steps_run} steps of "
              f"{train_layers} layers, forward and remat recompute)")
        check(not plain_calls, f"the train path called the plain version "
              f"{len(plain_calls)} times on the card")
    for i, m in enumerate(metrics):
        check(all(math.isfinite(m[k]) for k in ("loss", "total_loss",
                                               "grad_norm")),
              f"step {i}: not finite: {m}")
    step_ms = statistics.median(times)
    flops = tr.model_flops_per_token(tcfg) * b * s
    out["train"] = dict(
        layers=train_layers, params=n, launches=counts["flash_attention"],
        launches_by_geometry={str(k): v for k, v in geo.items()},
        step_ms=times, step_ms_median=step_ms,
        tokens_per_s=b * s / step_ms * 1e3, model_flops=flops,
        mfu=flops / (step_ms / 1e3) / PEAK_BF16_TC_FLOPS,
        peak_memory_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                        if on_card else None),
        losses=[m["loss"] for m in metrics])
    t = out["train"]
    print(f"{MINICPM3_ARCH} ({train_layers} layers) train steps of {b}x{s} "
          f"tokens: median {step_ms:.3f} ms a step "
          f"({', '.join(f'{x:.3f}' for x in times)}; host clock after a "
          f"synchronise), {t['tokens_per_s']:.1f} tokens/s; model FLOPs 6N x "
          f"tokens = {flops / 1e12:.2f} TFLOP a step, {100 * t['mfu']:.2f}% "
          f"of the bf16 dense peak; peak device memory "
          f"{t['peak_memory_gb'] or 0:.2f} GB; flash launches "
          f"{counts['flash_attention']} = {steps_run} steps x {train_layers}"
          f" layers x 2 (forward and remat recompute), all through the "
          f"{variant} kernel's {dk}/{dv} instance, {len(plain_calls)} plain "
          f"calls [{card}]")
    print(f"  losses {', '.join(f'{x:.4f}' for x in t['losses'])}")
    if on_card:
        t["step_profile"] = profile(lambda: step(state, batch_fn(0)), 1,
                                    f"{MINICPM3_ARCH} train steps")
    t["launch"] = row = split_launch_row(
        f"{MINICPM3_ARCH} training", b, s, cfg.n_heads, dk, dv,
        torch.bfloat16, dev, on_card)
    if on_card:
        print(f"flash_attention ({variant} {dk}/{dv}) at the step's geometry"
              f" (B={b} S={s} H={cfg.n_heads} causal bf16): {row['ms']:.4f} "
              f"ms a launch ({row['tflops']:.2f} TFLOP/s), plain "
              f"{row['plain_ms']:.3f} ms, SDPA forward {row['library_ms']:.4f}"
              f" ms (backend {row['library_backend']}), bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); the FFMA "
              f"instance on the same q, k, v {ffma_ms(row)} [{card}]")
    fit = make_train_step(tcfg, AdamWConfig(total_steps=LLM_FIT_STEPS,
                                            **LLM_FIT_LR), flags)
    one = batch_fn(10_000)
    losses = []
    for _ in range(LLM_FIT_STEPS):
        state, m = fit(state, one)
        losses.append(float(m["loss"]))
    t["fit_losses"] = losses
    print(f"one repeated batch, {LLM_FIT_STEPS} steps: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"the loss does not fall on one repeated batch: {losses}")
    _, _, grads = step.value_and_grad(state["params"], one)
    opt_ms = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        adamw_update(state["params"], grads, state["opt"], opt_cfg)
        sync()
        opt_ms.append((time.perf_counter() - t0) * 1e3)
    del grads
    t["optimizer_ms"] = statistics.median(opt_ms)
    print(f"adamw_update alone ({n:,} f32 parameters): "
          f"{t['optimizer_ms']:.3f} ms, "
          f"{100 * t['optimizer_ms'] / step_ms:.1f}% of the step [{card}]")
    del state["opt"]
    params = state["params"]
    if on_card:
        torch.cuda.empty_cache()
    condition(params, tcfg.d_model)

    def grads_of(**over):
        fn = make_train_step(tcfg, opt_cfg, dataclasses.replace(flags,
                                                                **over))
        return fn.value_and_grad(params, one)[2]
    g_flash = grads_of()
    g_naive = grads_of(attn_impl="naive")
    gates = {"flash vs naive, bf16": leaf_rel(g_flash, g_naive)}
    del g_flash
    with dv_scaled_backward(GRAD_FAULT):
        g = grads_of()
    gates["planted fault vs naive, bf16"] = leaf_rel(g, g_naive)
    del g, g_naive, state, params
    if on_card:
        torch.cuda.empty_cache()
    mla_leaf = "segments::seg0::pos0::attn::wkv_b"
    for label, rel in gates.items():
        worst = max(rel, key=rel.get)
        fault = label.startswith("planted")
        print(f"{MINICPM3_ARCH} gradients per leaf on conditioned weights, "
              f"{label}: worst {rel[worst]:.3e} ({worst}), "
              f"{rel[worst] / GRAD_TOL_BF16:.3f} of "
              f"{'the gate (must exceed it)' if fault else 'its tolerance'} "
              f"{GRAD_TOL_BF16:g}; {mla_leaf} {rel[mla_leaf]:.3e}")
        check(rel[mla_leaf] > GRAD_TOL_BF16 if fault
              else rel[worst] <= GRAD_TOL_BF16,
              f"{label}: {worst} at {rel[worst]:.3e}, {mla_leaf} at "
              f"{rel[mla_leaf]:.3e}, against {GRAD_TOL_BF16:g}")
    t["grad_gates"] = {k: max(v.values()) for k, v in gates.items()}
    t["grad_fault_wkv_b"] = gates["planted fault vs naive, bf16"][mla_leaf]
    out["seconds"] = time.perf_counter() - t_phase
    print(f"minicpm3 phase: {out['seconds']:.1f} s")
    return out


# -- mixture of experts: OLMoE-1B-7B and Llama-4-Scout ------------------------

# The moe phase: full-width OLMoE-1B-7B (16 layers, d_model 2048, 16 heads
# of 128, 64 experts of d_ff 1024 at top-8, vocab 50,304 padded to 50,432;
# bf16, random weights from seed 0) serving MOE_LONG[0] prompts of
# multiples of 256 tokens drawn from seed 0 in MOE_LONG[1:] and
# MOE_SHORT[0] prompts of MOE_SHORT[1:] tokens (the reference's routing
# groups of 256 tokens must divide a prompt's tokens), greedy, through
# MOE_SLOTS slots: every prefill's attention through the wgmma kernel's
# bf16 (128, 128) instance, one launch a layer, and every layer's MoE in
# plain PyTorch (``models/moe.py``: the reference has no Pallas kernel for
# it).  A decode step's MOE_SLOTS rows are one routing group, idle slots
# included, so an expert takes max(1, int(8·8·1.25/64)) = 1 token a step,
# as in the reference.  Then training at full width with MOE_TRAIN_LAYERS
# of its 16 layers (16 B a parameter of f32 masters, moments and
# gradients: 110.7 GB at 16 layers; 30.2 GB at 4), steps of
# MOE_TRAIN_BATCH SyntheticLM tokens; then Llama-4-Scout-17B-16E at full
# width with SCOUT_LAYERS of its 48 layers (its 215.5 GB of bf16 weights
# need four cards; 39.4 GB at 8): 40 query heads over 8 kv heads of 128
# (GQA expanded for the kernel), 16 experts at top-1 and a shared expert,
# a 202,240-wide vocab.
MOE_ARCH = "olmoe-1b-7b"
MOE_PARAMS = 6_919_620_608
# (prompts, least, most tokens): the long prompts are drawn as multiples
# of 256
MOE_LONG = (12, 256, 3840)
MOE_SHORT = (4, 16, 255)
MOE_SLOTS, MOE_MAX_LEN, MOE_MAX_NEW = 8, 4096, 32
# the prefill that is profiled and whose MoE input feeds the routing gate
# (16 groups of 256 tokens, capacity int(256·8·1.25/64) = 40), and the
# layer whose input it is
MOE_PREFILL_S = 4096
MOE_GATE_LAYER = 8
# The routing gate on the card: the routing of ``moe_apply``
# (``moe.route``: stable sort, flat cumsum) against ``moe_apply_plain``'s
# (``moe.route_plain``: argmax rounds, the reference's one-hot
# arithmetic) from the same bf16 router logits, experts, places and keep
# masks equal bit for bit, and ``y`` against ``moe_apply_plain`` in
# float64 on the same routing, ||a - b|| <= MOE_Y_TOL ||b||: bf16
# products summed in f32 and rounded, as the GEMMs of the other gates.
# Each fault of MOE_ROUTING_FAULTS must fail it: the reversed tie order on
# a router with columns MOE_TIED equal (ties certain), the capacity
# ignored, the gates not renormalised.
MOE_Y_TOL = 1e-2
MOE_ROUTING_FAULTS = ("tie order reversed", "capacity ignored",
                      "gates not renormalised")
MOE_TIED = (0, 1, 2)
# The logits of the kernel path against the naive path's on a
# MOE_GATE_S-token prompt, ||a - b|| <= tol ||b||, as the minicpm3
# phase's, with every token routed on both paths as on the naive one
# (``pinned_routing``).  Routing is a step function: where one rounding
# moves a token past the top-k boundary it takes other experts, and the
# change carries through the later layers.  Unpinned, the CPU rehearsal
# (4 layers, 256 wide, 64 experts, S = 768; the kernel's plain version in
# its place) read 0.50 between the plain and naive paths at the
# reference's init (29.9% of the pairs moved) and 2.4e-2 on conditioned
# weights (3.6%); the H100 at full width 1.20 (82.8%) and 4.8e-2
# (13.8%).  So the unpinned gaps and the share of pairs moved are
# printed and read, and the gate holds the paths on one routing (9.4e-3
# on the H100).  At the reference's init even one routing leaves the
# logits chaotic (the experts' fan-in is the layer count, so each layer
# adds outputs in the hundreds to the residual; 0.94 on one routing on
# the H100, 0.20 in the rehearsal): no
# model-level gate can hold a correct kernel there, so that regime is
# read and gated per launch against float64 instead (``regime_forward``),
# as the llm_train phase's gradients are.  The planted flash faults must
# exceed the conditioned gate.
MOE_GATE_S = 3840
MOE_LOGITS_TOL = {"conditioned": 3e-2}
# the f32 check: full width with these layers, one prompt of these tokens,
# through the FFMA kernel's f32 hd-128 instance, flash vs naive on one
# routing, on conditioned weights: at the reference's init the f32 logits
# are chaotic too (4.9e-3 on one routing on the H100, the attention
# scores up to 673 and each MoE layer adding outputs in the hundreds)
MOE_F32 = (4, 2048)
MOE_F32_TOL = 1e-4
MOE_TRAIN_LAYERS, MOE_TRAIN_PARAMS = 4, 1_884_833_792
MOE_TRAIN_BATCH = (2, 2048)
MOE_TRAIN_TIMED = 5
SCOUT_ARCH = "llama4-scout-17b-a16e"
SCOUT_LAYERS, SCOUT_PARAMS = 8, 19_687_756_800
# (requests, least, most prompt tokens, drawn as multiples of 256), slots
SCOUT_REQUESTS = (4, 256, 2048)
SCOUT_SLOTS = 4
# the profile's ranges: the MoE layer, and its routing inside it
MOE_RANGES = ("moe.moe_apply", "moe.route")


def faulty_route(fault: str):
    """Inside: ``moe.route`` with one fault of MOE_ROUTING_FAULTS planted:
    ties broken toward the higher expert index (the route of the experts
    in reverse order, mapped back), every pair kept, or the gates left
    as the top-k probabilities."""
    from repro_torch.models import moe
    route = moe.route

    def faulty(logits, k, capacity):
        if fault == "tie order reversed":
            r = route(logits.flip(-1), k, capacity)
            return r._replace(probs=r.probs.flip(-1),
                              idx=logits.shape[-1] - 1 - r.idx)
        if fault == "capacity ignored":
            return route(logits, k, logits.shape[1] * k)
        r = route(logits, k, capacity)
        return r._replace(gates=r.probs.gather(-1, r.idx))
    check(fault in MOE_ROUTING_FAULTS, f"no routing fault '{fault}'")
    return swapped(moe, "route", faulty)


@contextlib.contextmanager
def pinned_routing(routings: list, replay: bool = False):
    """Inside: ``moe.route`` appends each call's experts, places and keep
    masks to ``routings`` or, with ``replay``, takes them from the entry
    of ``routings`` at the call's index, the probabilities and the
    (renormalised) gates from the call's own logits.  Two paths that
    differ in their last bits then send every token to the same experts:
    routing is a step function of the hidden states, so without this one
    rounding may move a token to another expert (MOE_LOGITS_TOL)."""
    from repro_torch.models import moe
    route = moe.route
    at = [0]

    def pinned(logits, k, capacity):
        r = route(logits, k, capacity)
        if not replay:
            routings.append((r.idx, r.pos, r.keep))
            return r
        idx, pos, keep = routings[at[0]]
        at[0] += 1
        gates = r.probs.gather(-1, idx)
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        return r._replace(idx=idx, gates=gates, pos=pos, keep=keep)
    with swapped(moe, "route", pinned):
        yield
    check(not replay or at[0] == len(routings), f"{at[0]} routings "
          f"replayed of {len(routings)} recorded")


def moved_share(a: list, b: list) -> float:
    """The share of (token, slot) pairs whose expert differs between two
    recorded runs of ``pinned_routing``, over every call."""
    moved = sum(int((x[0] != y[0]).sum()) for x, y in zip(a, b))
    return moved / sum(x[0].numel() for x in a)


def routing_gate(params, x, cfg, label: str) -> dict:
    """One MoE layer's ``params`` on ``x`` (B, S, D): ``moe_apply``'s
    routing (through ``moe.route``, as the main path calls it) against
    ``moe.route_plain``'s from the same router logits, and ``y`` against
    ``moe_apply_plain`` in float64 on those logits; the share of tokens
    tied at the top-k boundary and the share of pairs dropped."""
    from repro_torch.models import moe
    b, s, d = x.shape
    k = cfg.top_k
    sg = min(moe.DEFAULT_GROUP, b * s)
    cap = moe.expert_capacity(sg, k, cfg.capacity_factor, cfg.n_experts)
    with torch.no_grad():
        logits = moe.router_logits(params, x.reshape(-1, sg, d))
        got = moe.route(logits, k, cap)
        want = moe.route_plain(logits, k, cap)
        same = {name: bool(torch.equal(getattr(got, name),
                                       getattr(want, name)))
                for name in ("idx", "pos", "keep")}
        y, _ = moe.moe_apply(params, x, cfg)
        wide = {n: v.double() for n, v in params.items()}
        y64, _ = moe.moe_apply_plain(wide, x.double(), cfg, logits=logits)
        rel = rel_norm(y.double(), y64)
        top = want.probs.sort(dim=-1, descending=True).values
        ties = (top[..., k - 1] == top[..., k]).double().mean().item()
        dropped = 1 - want.keep.double().mean().item()
    ok = all(same.values()) and rel <= MOE_Y_TOL
    print(f"{label}: routing of moe_apply vs moe_apply_plain's (experts, "
          f"places, keep) {'equal' if all(same.values()) else same}; y vs "
          f"the plain form in float64 ||a-b||/||b|| {rel:.3e} (tolerance "
          f"{MOE_Y_TOL:g}); {100 * ties:.3f}% of tokens tied at the top-{k} "
          f"boundary, {100 * dropped:.3f}% of pairs dropped at capacity "
          f"{cap}: {'met' if ok else 'FAILED'}")
    return dict(same=same, y_rel=rel, tie_share=ties, drop_share=dropped,
                capacity=cap, ok=ok)


def moe_phase(card, dev, wrappers, *, cfg=None, scout_cfg=None,
              long: tuple[int, int, int] = MOE_LONG,
              short: tuple[int, int, int] = MOE_SHORT,
              prefill_s: int = MOE_PREFILL_S, gate_s: int = MOE_GATE_S,
              gate_layer: int = MOE_GATE_LAYER,
              f32: tuple[int, int] = MOE_F32,
              train_layers: int = MOE_TRAIN_LAYERS,
              train_batch: tuple[int, int] = MOE_TRAIN_BATCH,
              scout_layers: int = SCOUT_LAYERS,
              scout_requests: tuple[int, int, int] = SCOUT_REQUESTS) -> dict:
    """Full-width OLMoE-1B-7B (``cfg``, default the registered config):
    serving through ``DecodeEngine.run`` (every counter at 0 just before,
    read just after: one launch of the wgmma kernel's bf16 (128, 128)
    instance a layer a prefill, none of the FFMA kernel, no plain call),
    TTFT, prefill and decode rates; the routing gate on one layer's input
    in a ``prefill_s``-token prefill, with its three planted faults; the
    kernel path's logits against the naive path's at the reference's
    init and on conditioned weights, with the planted flash faults; a
    profile of the prefill by kind with the MoE layer apart and one
    launch at the longest served prompt beside its plain version, SDPA
    and the bound; the f32 check through the FFMA kernel; training with
    the depth cut: step time, tokens/s, model-FLOP share (6·N_active),
    peak memory, the aux terms, the bf16 gradient gate with its planted
    fault; then Llama-4-Scout (``scout_cfg``, default the registered
    config) with its depth cut, served and gated the same way.  The
    keywords shrink it for a rehearsal on the CPU (the kernels' plain
    versions, no counts, no times)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM, make_batch_fn
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain,
                                                     kernel_variant)
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr
    from repro_torch.serve.engine import EngineConfig, _merge_slot_cache
    from repro_torch.train.checkpoint import tree_leaves
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step)
    on_card = dev.type == "cuda"
    full_width = cfg is None
    cfg = cfg or get_config(MOE_ARCH)
    scout_cfg = dataclasses.replace(scout_cfg or get_config(SCOUT_ARCH),
                                    n_layers=scout_layers)
    kernel = flash_attention_cuda if on_card else flash_attention_plain
    hd = cfg.resolved_head_dim
    bf16_key = (torch.bfloat16, hd, hd)
    f32_key = (torch.float32, hd, hd)
    variant = kernel_variant(*bf16_key)
    main_kernel = FLASH_VARIANTS[variant]

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def free():
        if on_card:
            torch.cuda.empty_cache()

    def live_rel(a, b, c):
        return rel_norm(a[..., :c.vocab], b[..., :c.vocab])

    def serve(c, params, prompts, slots, max_len, label):
        """The main path: ``prompts`` through ``DecodeEngine.run``; prints
        and returns its rates and counts."""
        ecfg = EngineConfig(n_slots=slots, max_len=max_len,
                            max_new=MOE_MAX_NEW, temperature=0.0)
        serve_requests(c, params, dataclasses.replace(ecfg, n_slots=1),
                       [prompts[-1][:16]], "flash", wrappers, dev)
        plain_calls: list = []
        reset_flash_counts(wrappers)
        with counting_plain_attention(plain_calls):
            reqs, admits, steps, wall, counts = serve_requests(
                c, params, ecfg, prompts, "flash", wrappers, dev)
        _, geo = read_flash_counts(wrappers)
        want = c.n_layers * len(prompts)
        check_flash_path(on_card, counts, geo, plain_calls, want, bf16_key,
                   f"{label} serving")
        for r in reqs:
            check(r.done and len(r.generated) == MOE_MAX_NEW
                  and all(0 <= t < c.vocab for t in r.generated),
                  f"{label} request {r.rid}: done {r.done}, "
                  f"{len(r.generated)} tokens")
        lens = [len(p) for p in prompts]
        prefill_s_ = sum(d for _, d in admits.values())
        decode_s = sum(d for d, _ in steps)
        decode_tokens = sum(n for _, n in steps)
        full = [d * 1e3 for d, n in steps if n == slots]
        step_ms = statistics.median(full or [d * 1e3 for d, _ in steps])
        ttft = sorted((len(r.prompt), sum(admits[r.rid]) * 1e3,
                       admits[r.rid][1] * 1e3) for r in reqs)
        top = ttft[-1]
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in tree_leaves(params))
        print(f"{label} served {len(prompts)} requests ({sum(lens)} prompt "
              f"tokens, {MOE_MAX_NEW} new each) in {wall:.3f} s through "
              f"{slots} slots: {counts['flash_attention']} flash launches = "
              f"{c.n_layers} layers x {len(prompts)} prefills, through the "
              f"{variant} kernel's {hd}/{hd} bf16 instance ({geo}), "
              f"{counts['flash_attention_ffma']} FFMA, {len(plain_calls)} "
              f"plain calls [{card}]")
        for n, t, pre in ttft:
            print(f"  prompt {n:4d} tokens: prefill {pre:9.3f} ms, time to "
                  f"first token {t:9.3f} ms")
        print(f"prefill: {sum(lens)} tokens in {prefill_s_:.3f} s = "
              f"{sum(lens) / prefill_s_:.1f} tokens/s; at the longest prompt "
              f"({top[0]} tokens) TTFT {top[1]:.3f} ms, "
              f"{top[0] / top[2] * 1e3:.1f} tokens/s; decode: {len(steps)} "
              f"engine steps, median {step_ms:.3f} ms a step at {slots} "
              f"slots ({len(full)} such steps), {decode_tokens} tokens in "
              f"{decode_s:.3f} s = {decode_tokens / decode_s:.1f} tokens/s; "
              f"HBM bound of a step (every weight read once: the dispatch "
              f"runs every expert's buffer) "
              f"{weight_bytes / PEAK_HBM_BYTES * 1e3:.3f} ms [{card}]")
        return dict(prompt_lens=lens, wall_s=wall,
                    launches=counts["flash_attention"],
                    launches_by_geometry={str(k): v for k, v in geo.items()},
                    requests=[dict(prompt=n, ttft_ms=t, prefill_ms=pre)
                              for n, t, pre in ttft],
                    ttft_ms_longest=top[1],
                    prefill_tokens_per_s=sum(lens) / prefill_s_,
                    decode_steps=len(steps), decode_step_ms_median=step_ms,
                    decode_tokens_per_s=decode_tokens / decode_s,
                    weight_gb=weight_bytes / 1e9,
                    decode_bound_ms=weight_bytes / PEAK_HBM_BYTES * 1e3)

    def prefill_and_decode(c, p, tokens, impl):
        flags = tr.RunFlags(attn_impl=impl)
        lg, pcache = tr.forward(p, {"tokens": tokens}, c, mode="prefill",
                                flags=flags)
        cache = tr.init_cache(c, 1, tokens.shape[1] + 8, device=dev)
        _merge_slot_cache(cache, pcache, 0, tokens.shape[1])
        del pcache
        nxt = torch.argmax(lg[:, -1].float(), dim=-1)[:, None]
        first, _ = tr.decode_step(p, cache, nxt, torch.tensor(
            [tokens.shape[1]], device=dev), c, flags)
        return lg, first

    def logits_gate(c, params, tokens, label) -> dict:
        """Every flash launch of a prefill of ``tokens`` against float64
        (``regime_forward``, at the reference's init); then the kernel
        path's prefill and first decode logits against the naive path's,
        at the reference's init (read) and conditioned (gated, the
        planted flash faults above the gate), each on its own routing
        (read) and on the naive path's."""
        calls: list = []
        with attend_as(dev, recording(kernel, calls)), torch.no_grad():
            prefill_and_decode(c, params, tokens, "flash")
        check(len(calls) == c.n_layers, f"{len(calls)} flash calls in a "
              f"prefill of {c.n_layers} layers")
        s, h = tokens.shape[1], c.n_heads
        out = {"flash_on_model_inputs": regime_forward(
            calls, f"{label} {s}-token prefill (B=1 S={s} H={h} hd={hd})",
            MINICPM3_PLAIN_TILES)}
        del calls
        faults = {f: planted_fault(f) for f in PLANTED_FAULTS}
        out = {}
        for regime in ("reference init", "conditioned"):
            if regime == "conditioned":
                condition(params, c.d_model)
            runs, routed = {}, {}
            for impl in ("flash", "naive"):
                routed[impl] = []
                with pinned_routing(routed[impl]):
                    runs[impl] = prefill_and_decode(c, params, tokens, impl)
            free_pair = [live_rel(x, y, c) for x, y in
                         zip(runs["flash"], runs["naive"])]
            moved = moved_share(routed["flash"], routed["naive"])
            print(f"{label} {tokens.shape[1]}-token prompt, {regime}, flash "
                  f"vs naive, each on its own routing: prefill logits "
                  f"||a-b||/||b|| {free_pair[0]:.3e}, first decode logits "
                  f"{free_pair[1]:.3e}; {100 * moved:.3f}% of the (token, "
                  f"slot) pairs routed to another expert (read, not gated)")
            with pinned_routing(routed["naive"], replay=True):
                lg = prefill_and_decode(c, params, tokens, "flash")
            errs = {"flash vs naive": [live_rel(x, y, c) for x, y in
                                       zip(lg, runs["naive"])]}
            del runs["flash"], lg
            for fault in PLANTED_FAULTS:
                with attend_as(dev, faults[fault]), \
                        pinned_routing(routed["naive"], replay=True):
                    lg = prefill_and_decode(c, params, tokens, "flash")
                errs[f"{fault} vs naive"] = [live_rel(x, y, c) for x, y in
                                             zip(lg, runs["naive"])]
                del lg
            del runs, routed
            free()
            tol = MOE_LOGITS_TOL.get(regime)
            for what, pair in errs.items():
                fault = not what.startswith("flash")
                gated = tol is not None
                print(f"{label} {tokens.shape[1]}-token prompt, {regime}, "
                      f"{what}, on the naive path's routing: prefill logits "
                      f"||a-b||/||b|| {pair[0]:.3e}, "
                      f"first decode logits {pair[1]:.3e} ("
                      + ((f"must exceed {tol:g}" if fault
                          else f"tolerance {tol:g}")
                         if gated else "read, not gated: see MOE_LOGITS_TOL")
                      + ")")
                if gated:
                    check(max(pair) > tol if fault else max(pair) <= tol,
                          f"{label} {regime}, {what}: the logits gate of "
                          f"{tol:g} "
                          f"{'cannot tell the planted fault' if fault else 'fails'}")
            out[regime] = dict(errs, unpinned=free_pair,
                               moved_share=moved)
        return out

    def launch_row(label, b, s, h):
        row = split_launch_row(label, b, s, h, hd, hd, torch.bfloat16, dev,
                               on_card)
        if on_card:
            print(f"flash_attention ({row['variant']} {hd}/{hd}) {label} at "
                  f"B={b} S={s} H={h} causal bf16: {row['ms']:.4f} ms a "
                  f"launch ({row['tflops']:.2f} TFLOP/s), max_abs_err "
                  f"{row['max_abs_err']:.3e} vs plain, plain "
                  f"{row['plain_ms']:.3f} ms, SDPA {row['library_ms']:.4f} "
                  f"ms (backend {row['library_backend']}), bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}) [{card}]")
        return row

    t_phase = time.perf_counter()
    out: dict = {}
    free()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tr.init(cfg, torch.Generator(dev).manual_seed(0))
    sync()
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == tr.count_params(cfg)
          and (n_params == MOE_PARAMS or not full_width),
          f"{n_params} parameters, not {MOE_PARAMS}")
    L = cfg.n_layers
    print(f"{MOE_ARCH}: {L} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads of {hd}, {cfg.n_experts} experts of d_ff "
          f"{cfg.expert_d_ff} at top-{cfg.top_k}, vocab {cfg.vocab} (padded "
          f"{cfg.padded_vocab}): {n_params:,} parameters "
          f"({tr.model_flops_per_token(cfg) / 6:,.0f} active a token), "
          f"drawn in {time.perf_counter() - t0:.1f} s")

    # -- serving: the main path ------------------------------------------
    gen = torch.Generator().manual_seed(0)
    n_long, lo, hi = long
    lens = (torch.randint(lo // 256, hi // 256 + 1, (n_long,),
                          generator=gen) * 256).tolist()
    lens += torch.randint(short[1], short[2] + 1, (short[0],),
                          generator=gen).tolist()
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist()
               for n in lens]
    out["serve"] = serve(cfg, params, prompts, MOE_SLOTS,
                         max(MOE_MAX_LEN, max(lens) + MOE_MAX_NEW + 8),
                         MOE_ARCH)
    out["launches"] = out["serve"]["launches"]
    cap = moe.expert_capacity(MOE_SLOTS, cfg.top_k, cfg.capacity_factor,
                              cfg.n_experts)
    print(f"  a decode step's {MOE_SLOTS} slots are one routing group, idle "
          f"slots included: capacity {cap} token(s) an expert a step (the "
          f"reference's rule)")

    # -- the routing gate on one layer's input ------------------------------
    tokens = torch.randint(0, cfg.vocab, (1, prefill_s), generator=gen
                           ).to(dev)
    seen: list = []
    apply = moe.moe_apply

    def recorded(p, x, c, **kw):
        if len(seen) == gate_layer:
            seen.append((p, x.detach().clone()))
        elif len(seen) < gate_layer:
            seen.append(None)
        return apply(p, x, c, **kw)
    with swapped(moe, "moe_apply", recorded), torch.no_grad():
        tr.forward(params, {"tokens": tokens}, cfg, mode="prefill",
                   last_logit_only=True)
    lp, x = seen[gate_layer]
    del seen
    label = f"{MOE_ARCH} layer {gate_layer}, {prefill_s}-token prefill"
    gates = {"main path": routing_gate(lp, x, cfg, label)}
    check(gates["main path"]["ok"], f"{label}: the routing gate fails")
    tied_router = lp["router"].clone()
    tied_router[:, list(MOE_TIED)] = tied_router[:, [MOE_TIED[0]]]
    tied = dict(lp, router=tied_router)
    gates["tied router"] = routing_gate(
        tied, x, cfg, f"{label}, router columns {MOE_TIED} equal")
    check(gates["tied router"]["ok"], f"{label}: the routing gate fails on "
          f"the tied router")
    for fault in MOE_ROUTING_FAULTS:
        on = tied if fault == "tie order reversed" else lp
        with faulty_route(fault):
            gates[fault] = routing_gate(
                on, x, cfg, f"{label}, planted: {fault}"
                + (" (tied router)" if on is tied else ""))
        check(not gates[fault]["ok"], f"{label}: the routing gate cannot "
              f"tell '{fault}'")
    out["routing_gate"] = gates
    del lp, x, tied, tied_router

    # -- profile of one prefill by kind, the MoE layer apart ---------------
    if on_card:
        with annotated(moe, "moe_apply", MOE_RANGES[0]), \
                annotated(moe, "route", MOE_RANGES[1]):
            prof = profile(lambda: tr.forward(params, {"tokens": tokens}, cfg,
                                              mode="prefill"), 2,
                           f"{MOE_ARCH} prefills of {prefill_s} tokens",
                           ranges_of=MOE_RANGES)
        if "device_ms_per_run" in prof:
            kms = prof["kernels_ms_per_run"]
            spans = prof["range_spans_ms_per_run"]
            flash_ms = sum(ms for n, ms in kms.items() if "fa_sm90_kernel" in n)
            gemm_ms = sum(ms for n, ms in kms.items()
                          if any(t in n.lower() for t in
                                 ("gemm", "xmma", "cutlass", "nvjet")))
            busy = prof["device_ms_per_run"]
            moe_ms = spans.get(MOE_RANGES[0], float("nan"))
            prof["by_kind_ms"] = dict(flash=flash_ms, gemm_kernels=gemm_ms,
                                      moe_span=moe_ms,
                                      moe_span_per_layer=moe_ms / L,
                                      route_span=spans.get(MOE_RANGES[1]),
                                      other=busy - flash_ms - gemm_ms)
            print(f"  a {prefill_s}-token prefill by kind: the {L} flash "
                  f"launches {flash_ms:.3f} ms; every GEMM kernel (the "
                  f"projections, the router, the experts' batched products, "
                  f"the logits) {gemm_ms:.3f} ms; the MoE layers (device span "
                  f"of their ranges) {moe_ms:.3f} ms = {moe_ms / L:.3f} ms a "
                  f"layer, their routing "
                  f"{spans.get(MOE_RANGES[1], float('nan')):.3f} ms; device "
                  f"busy {busy:.3f} ms of a {prof['wall_ms_per_run']:.3f} ms "
                  f"wall [{card}]")
        out["prefill_profile"] = prof
    out["launch"] = launch_row(f"{MOE_ARCH} serving", 1, max(lens),
                               cfg.n_heads)
    if on_card:
        out["serve_peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"{MOE_ARCH} serving in bf16: peak device memory "
              f"{out['serve_peak_memory_gb']:.2f} GB [{card}]")
    # last: it conditions the weights in place
    out["logits_rel_err"] = logits_gate(cfg, params, tokens[:, :gate_s],
                                        MOE_ARCH)
    del params
    free()

    # -- the f32 check through the FFMA kernel's f32 instance ---------------
    l32, s32 = f32
    cfg32 = dataclasses.replace(cfg, n_layers=l32, dtype="float32")
    p32 = tr.init(cfg32, torch.Generator(dev).manual_seed(1))
    condition(p32, cfg.d_model)
    routed: list = []
    with torch.no_grad(), pinned_routing(routed):
        runs = {"naive": prefill_and_decode(cfg32, p32, tokens[:, :s32],
                                            "naive")}
    reset_flash_counts(wrappers)
    with torch.no_grad(), pinned_routing(routed, replay=True):
        runs["flash"] = prefill_and_decode(cfg32, p32, tokens[:, :s32],
                                           "flash")
    sync()
    counts32, geo32 = read_flash_counts(wrappers)
    check_flash_path(on_card, counts32, geo32, [], l32, f32_key, "the f32 prefill")
    pair = [live_rel(x, y, cfg32) for x, y in zip(runs["flash"],
                                                   runs["naive"])]
    del runs, p32, routed
    free()
    print(f"{MOE_ARCH} f32, {l32} layers (through the FFMA kernel's {hd}/{hd}"
          f" f32 instance: {geo32.get(f32_key, 0)} launches), one "
          f"{s32}-token prompt, conditioned weights, flash vs naive on the "
          f"naive path's routing: "
          f"prefill logits ||a-b||/||b|| {pair[0]:.3e}, first decode logits "
          f"{pair[1]:.3e} (tolerance {MOE_F32_TOL:g})")
    check(max(pair) <= MOE_F32_TOL, "f32 flash vs naive: the logits disagree")
    out.update(f32_logits_rel_err=pair, launches_f32=geo32.get(f32_key, 0))
    f32_row = split_launch_row(f"{MOE_ARCH} f32 check", 1, s32, cfg.n_heads,
                               hd, hd, torch.float32, dev, on_card)
    out["launch_f32"] = f32_row

    # -- training at full width, the depth cut ----------------------------
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    tcfg = dataclasses.replace(cfg, n_layers=train_layers)
    n = tr.count_params(tcfg)
    check(n == MOE_TRAIN_PARAMS or not full_width,
          f"{n} parameters at {train_layers} layers")
    state = init_train_state(tcfg, torch.Generator(dev).manual_seed(0))
    sync()
    b, s = train_batch
    batch_fn = make_batch_fn(SyntheticLM(tcfg, b, s, seed=0), device=dev)
    flags = tr.RunFlags(attn_impl="flash", remat=True)
    opt_cfg = AdamWConfig(total_steps=1 + MOE_TRAIN_TIMED, **LLM_TRAIN_LR)
    step = make_train_step(tcfg, opt_cfg, flags)
    print(f"{MOE_ARCH} training at full width with {train_layers} of its {L} "
          f"layers: {n:,} parameters, f32 masters, moments and gradients "
          f"{16 * n / 1e9:.1f} GB ({L} layers: {16 * n_params / 1e9:.1f} GB)")
    plain_calls: list = []
    reset_flash_counts(wrappers)
    times, metrics = [], []
    with counting_plain_attention(plain_calls):
        for i in range(1 + MOE_TRAIN_TIMED):
            data = batch_fn(i)
            sync()
            t0 = time.perf_counter()
            state, m = step(state, data)
            sync()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(x) for k, x in m.items()})
    counts, geo = read_flash_counts(wrappers)
    steps_run = 1 + MOE_TRAIN_TIMED
    check_flash_path(on_card, counts, geo, plain_calls, 2 * train_layers * steps_run,
               bf16_key, f"{MOE_ARCH} training ({steps_run} steps of "
               f"{train_layers} layers, forward and remat recompute)")
    for i, m in enumerate(metrics):
        check(all(math.isfinite(m[k]) for k in ("loss", "total_loss",
                                               "grad_norm", "aux_lb",
                                               "aux_z"))
              and m["aux_lb"] > 0 and m["aux_z"] > 0,
              f"step {i}: not finite, or an aux term 0: {m}")
    step_ms = statistics.median(times)
    flops = tr.model_flops_per_token(tcfg) * b * s
    out["train"] = t = dict(
        layers=train_layers, params=n, launches=counts["flash_attention"],
        step_ms=times, step_ms_median=step_ms,
        tokens_per_s=b * s / step_ms * 1e3, model_flops=flops,
        mfu=flops / (step_ms / 1e3) / PEAK_BF16_TC_FLOPS,
        peak_memory_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                        if on_card else None),
        losses=[m["loss"] for m in metrics],
        aux_lb=[m["aux_lb"] for m in metrics],
        aux_z=[m["aux_z"] for m in metrics])
    print(f"{MOE_ARCH} ({train_layers} layers) train steps of {b}x{s} tokens: "
          f"median {step_ms:.3f} ms a step "
          f"({', '.join(f'{x:.3f}' for x in times)}; host clock after a "
          f"synchronise), {t['tokens_per_s']:.1f} tokens/s; model FLOPs "
          f"6N_active x tokens = {flops / 1e12:.2f} TFLOP a step, "
          f"{100 * t['mfu']:.2f}% of the bf16 dense peak; peak device memory "
          f"{t['peak_memory_gb'] or 0:.2f} GB; flash launches "
          f"{counts['flash_attention']} = {steps_run} steps x {train_layers} "
          f"layers x 2, all through the {variant} kernel, {len(plain_calls)} "
          f"plain calls [{card}]")
    print(f"  losses {', '.join(f'{x:.4f}' for x in t['losses'])}; aux_lb "
          f"{', '.join(f'{x:.4f}' for x in t['aux_lb'])}; aux_z "
          f"{', '.join(f'{x:.4f}' for x in t['aux_z'])}")
    if on_card:
        t["step_profile"] = profile(lambda: step(state, batch_fn(0)), 1,
                                    f"{MOE_ARCH} train steps")
    t["launch"] = launch_row(f"{MOE_ARCH} training", b, s, cfg.n_heads)
    one = batch_fn(10_000)
    del state["opt"]
    params = state["params"]
    free()
    condition(params, tcfg.d_model)

    def grads_of(routings, replay=False, **over):
        """The gradients wrt the masters, without remat (its recompute
        would route each layer a second time, in reverse order)."""
        fn = make_train_step(tcfg, opt_cfg, dataclasses.replace(
            flags, remat=False, **over))
        with pinned_routing(routings, replay):
            return fn.value_and_grad(params, one)[2]
    routed: list = []
    g_naive = grads_of(routed, attn_impl="naive")
    own: list = []
    rels = {"flash vs naive, each on its own routing":
            leaf_rel(grads_of(own), g_naive)}
    moved = moved_share(own, routed)
    del own
    rels["flash vs naive, bf16"] = leaf_rel(grads_of(routed, True), g_naive)
    with dv_scaled_backward(GRAD_FAULT):
        g = grads_of(routed, True)
    rels["planted fault vs naive, bf16"] = leaf_rel(g, g_naive)
    del g, g_naive, state, params, routed
    free()
    for what, rel in rels.items():
        worst = max(rel, key=rel.get)
        fault = what.startswith("planted")
        gated = "own routing" not in what
        router = max(v for k, v in rel.items() if k.endswith("router"))
        print(f"{MOE_ARCH} gradients per leaf on conditioned weights, {what}"
              + ("" if gated else f" ({100 * moved:.3f}% of the pairs "
                 f"routed to another expert)")
              + f": worst {rel[worst]:.3e} ({worst}), "
              f"{rel[worst] / GRAD_TOL_BF16:.3f} of "
              + ("the gate (must exceed it)" if fault else "its tolerance"
                 if gated else "the gate (read, not gated)")
              + f" {GRAD_TOL_BF16:g}; the routers' worst {router:.3e}")
        if gated:
            check(rel[worst] > GRAD_TOL_BF16 if fault
                  else rel[worst] <= GRAD_TOL_BF16,
                  f"{what}: {worst} at {rel[worst]:.3e} against "
                  f"{GRAD_TOL_BF16:g}")
    t["grad_gates"] = {k: max(v.values()) for k, v in rels.items()}
    t["grad_moved_share"] = moved

    # -- Llama-4-Scout: GQA, top-1 of 16 experts and a shared expert ---------
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sp = tr.init(scout_cfg, torch.Generator(dev).manual_seed(0))
    sync()
    n_scout = sum(t.numel() for t in tree_leaves(sp))
    check(n_scout == tr.count_params(scout_cfg)
          and (n_scout == SCOUT_PARAMS or not full_width),
          f"{n_scout} parameters at {scout_layers} layers, not "
          f"{SCOUT_PARAMS}")
    print(f"{SCOUT_ARCH}: {scout_layers} of its 48 layers at full width "
          f"(d_model {scout_cfg.d_model}, {scout_cfg.n_heads} heads over "
          f"{scout_cfg.n_kv_heads} kv heads of {hd}, {scout_cfg.n_experts} "
          f"experts of d_ff {scout_cfg.expert_d_ff} at top-{scout_cfg.top_k} "
          f"and {scout_cfg.n_shared_experts} shared, vocab {scout_cfg.vocab} "
          f"padded {scout_cfg.padded_vocab}): {n_scout:,} parameters, drawn "
          f"in {time.perf_counter() - t0:.1f} s")
    n_req, lo, hi = scout_requests
    slens = (torch.randint(lo // 256, hi // 256 + 1, (n_req,), generator=gen)
             * 256).tolist()
    sprompts = [torch.randint(0, scout_cfg.vocab, (n,), generator=gen
                              ).tolist() for n in slens]
    sc = out["scout"] = serve(scout_cfg, sp, sprompts, SCOUT_SLOTS,
                              max(slens) + MOE_MAX_NEW + 8, SCOUT_ARCH)
    sc["launch"] = launch_row(f"{SCOUT_ARCH} serving", 1, max(slens),
                              scout_cfg.n_heads)
    if on_card:
        sc["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"{SCOUT_ARCH} serving in bf16: peak device memory "
              f"{sc['peak_memory_gb']:.2f} GB [{card}]")
    stokens = torch.randint(0, scout_cfg.vocab, (1, max(slens)),
                            generator=gen).to(dev)
    sc["logits_rel_err"] = logits_gate(scout_cfg, sp, stokens, SCOUT_ARCH)
    del sp
    free()
    out["launches_wgmma"] = out["launches"] + t["launches"] + sc["launches"]
    # each timed launch against its plain version, for the kernels line
    out["errs_wgmma"] = [r["max_abs_err"] for r in
                         (out["launch"], t["launch"], sc["launch"])
                         if "max_abs_err" in r]
    out["errs_ffma"] = [f32_row["max_abs_err"]] \
        if "max_abs_err" in f32_row else []
    out["seconds"] = time.perf_counter() - t_phase
    print(f"moe phase: {out['seconds']:.1f} s")
    return out


# -- SSM and hybrid blocks: Mamba2-2.7B and Hymba-1.5B --------------------------

# The ssm phase: full-width Mamba2-2.7B (64 attention-free layers of the
# Mamba2 mixer, d_model 2560, 80 SSM heads of 64, state 128, conv 4; vocab
# 50,280 padded to 50,432; bf16, random weights from seed 0) and
# Hymba-1.5B (32 hybrid layers: attention, windowed at 1024 but on layers
# 0, 15 and 31, beside the mixer with 50 heads of 64 and state 16; 25 q
# heads over 5 kv heads of 64; vocab 32,001 padded to 32,256), each
# serving SSM_REQUESTS prompts of lengths drawn from seed 0 in
# SSM_PROMPT_LENS, SSM_MAX_NEW new tokens each, greedy, through SSM_SLOTS
# slots.  The mixer is plain PyTorch (the reference has no Pallas kernel
# for it); Hymba's global layers run the wgmma flash kernel's bf16
# hd-64 instance, one launch a global layer a prefill (the FFMA kernel's
# bf16 hd-64 instance is timed beside it on the same q, k, v: the
# yardstick).
MAMBA2_ARCH, MAMBA2_PARAMS = "mamba2-2.7b", 2_832_074_240
HYMBA_ARCH, HYMBA_PARAMS = "hymba-1.5b", 1_641_688_320
SSM_REQUESTS = 16
SSM_PROMPT_LENS = (16, 4000)
SSM_SLOTS, SSM_MAX_LEN, SSM_MAX_NEW = 8, 4096, 32
# the Mamba2 prefill that is profiled and whose layer SSM_GATE_LAYER's
# mixer input feeds the SSD gate
SSM_PREFILL_S = 4096
SSM_GATE_LAYER = 32
# The SSD gate: ``ssm_apply``'s output, final state h and conv cache on
# one layer's input against ``ssm_recurrence_plain`` (the token-by-token
# recurrence of the decode step) in float64 on the same input (bf16
# values, exact in float64): y by its worst token, max_t ||a_t - b_t|| /
# ||b_t|| over the 2560 outputs of token t, h and conv by ||a - b|| /
# ||b||, each within SSD_TOL; ``ssm_apply`` with ``ssd_chunked_plain`` in
# place of the chunked form held to the same gate and compared with the
# main path's.  A fault in the handoff between chunks moves the first
# tokens of each chunk by O(1) of their own norm and hardly the norm of
# the whole y (the decays of the reference's init, dt up to ~26 at A =
# -e, forget a chunk's state within a few tokens), hence the worst
# token.  f32 at 1e-3: the chunked form takes exp(cum_i - cum_j) of f32
# cumulative sums of dt·A that reach thousands within a chunk, an ulp of
# which is ~2.4e-4, so the worst token reads ~1e-4 and the whole y ~2e-5
# (CPU rehearsal, 4 layers of d 256, at the reference's init; 2.6e-5 and
# 3.5e-6 on conditioned weights); the float64 chunked form equals the
# recurrence to rounding.  bf16 at 0.1: the bf16 path rounds the in_proj
# output, the conv, y and the gate to bf16 (the rehearsal read 8.9e-3 at
# the reference's init, 5.3e-2 conditioned).  Each fault of SSD_FAULTS,
# planted in the chunked SSD, must fail it at either dtype (0.86-1.5 in
# the rehearsal), but the mask moved after the ``exp``, whose forward
# values are the same: it must make the gradients of a one-layer loss
# non-finite (an upper-triangle entry overflows to inf, and the gradient
# through the mask is inf·0), where the unfaulted gradients are finite.
SSD_TOL = {torch.float32: 1e-3, torch.bfloat16: 0.1}
# the chunked form in float64 against the float64 recurrence, on the
# same gate: 2.9e-16 on the CPU (6.6e-12 at full width on a random
# input), 2.3e-7 measured on one H100 at layer 32 of the reference's
# init, four orders below the f32 gate
SSD_F64_TOL = 1e-6
SSD_FAULTS = ("state not carried", "inbound decay dropped",
              "mask after exp")
# Prefill/decode handoff: a SSM_HANDOFF_S-token prompt (four chunks of
# 256, the last padded) prefilled, then one decode step of the next
# token, against the prefill of all SSM_HANDOFF_S + 1 tokens' last
# logits, ||a - b|| <= tol ||b|| over the live vocab.  Gated on
# conditioned weights (at the reference's init in_proj's fan-in is the
# layer count, dt reaches ~26 and the logits are chaotic at either
# dtype: read there, not gated): f32 at 1e-4; bf16 at LLM_TOL_BF16, as
# the other bf16 logits gates through a whole model (the decode step's
# recurrence rounds y to bf16 token by token where the chunked form sums
# a chunk in f32 first, as the reference's two paths do: Mamba2's 64
# layers read 3.1e-2 conditioned, 2.4e-2 at the reference's init,
# measured on one H100).  A handoff that drops the SSM state (the decode
# step from zeroed h and conv caches) must exceed the gate at either
# dtype.
SSM_HANDOFF_S = 1000
SSM_HANDOFF_TOL = {torch.float32: 1e-4, torch.bfloat16: LLM_TOL_BF16}
# Hymba's logits gate on a HYMBA_GATE_S-token prompt: the flash path
# against the naive path and against the path of the kernel's plain
# version (the same numerics, p kept in f32) at the reference's init and
# on conditioned weights, each within HYMBA_LOGITS_TOL; each planted
# flash fault against the plain path above it in at least one regime.
# Conditioning does not tame Hymba in bf16: on conditioned weights the
# flash and plain paths, which differ in the last bits of 3 global
# layers' outputs, read 3.8e-2 / 4.2e-2 (prefill / first decode) and
# flash vs naive 4.2e-2 / 4.9e-2; at the reference's init 3.1e-3 /
# 4.1e-3 and 9.9e-3 / 7.6e-3 (measured on one H100).  So the 3e-2
# of the attention-only models' conditioned gate cannot hold a right
# kernel here, and the gate is LLM_TOL_BF16 in both regimes, as the
# other bf16 logits gates through a whole model at the reference's
# init; each launch is held to float64 (``regime_forward``) and the f32
# check holds flash against naive at 1e-4.
HYMBA_GATE_S = 3840
HYMBA_LOGITS_TOL = LLM_TOL_BF16
# Hymba's f32 check: full width, HYMBA_F32 = (layers, tokens) with
# global layers HYMBA_F32_GLOBAL, so two windowed layers sit between two
# global ones and the window bites; the FFMA kernel's f32 hd-64
# instance, flash vs naive at HYMBA_F32_TOL
HYMBA_F32 = (4, 2048)
HYMBA_F32_GLOBAL = (0, 3)
HYMBA_F32_TOL = 1e-4
# training: SSM_TRAIN_BATCH SyntheticLM tokens a step, AdamW, remat,
# SSM_TRAIN_TIMED timed steps after one warm step; Mamba2 at full width
# with MAMBA2_TRAIN_LAYERS of its 64 layers (16 B a parameter of f32
# masters, moments and gradients: 9.3 GB; 45.3 GB at 64 layers, its
# largest leaf 6.9 GB in f32, before AdamW's temporaries), Hymba at full
# width with HYMBA_TRAIN_LAYERS of its 32, global at HYMBA_F32_GLOBAL as
# the f32 check's (4.7 GB; 26.3 GB whole).  Both depths are cut for the
# script's time: every layer runs the same code.  The gradients on
# conditioned weights: Hymba's flash path against the naive path
# (GRAD_TOL_BF16, the dv fault above it), Mamba2's through ``ssm_apply``
# against those through ``ssd_chunked_plain`` (SSD_GRAD_TOL: the same
# arithmetic a chunk, summed in another order; a state not carried must
# fail it).
SSM_TRAIN_BATCH = (2, 2048)
SSM_TRAIN_TIMED = 5
MAMBA2_TRAIN_LAYERS, MAMBA2_TRAIN_PARAMS = 8, 579_946_880
HYMBA_TRAIN_LAYERS, HYMBA_TRAIN_PARAMS = 4, 295_529_240
SSD_GRAD_TOL = 1e-2
# the mixer's A_log and dt_bias: their gradients sum (B, L, H, P, N)
# terms of both signs through every decay of the state, which cancel
# (tests/test_torch_ssm.py's DECAY_LEAVES: 16x the f32 error of the other
# leaves against float64), so one bf16 rounding elsewhere moves them
# more: Hymba's flash path against the naive path read 4.0e-2 on one
# dt_bias in the CPU rehearsal (4 layers of d 256, 2 x 512 tokens), the
# other leaves within GRAD_TOL_BF16.  They are held within
# SSM_DECAY_GRAD_TOL, and the planted faults are read on the other
# leaves.
SSM_DECAY_LEAVES = ("A_log", "dt_bias")
SSM_DECAY_GRAD_TOL = 0.3
# Hymba's gradients on conditioned weights.  In bf16 at full depth they
# are as chaotic as its logits (HYMBA_LOGITS_TOL): the flash path and
# the path of the kernel's plain version, which differ in the last bits
# of the 3 global layers' outputs, read 7.1e-2 on an in_proj leaf (1.0e-1
# on a dt_bias), and the dv fault of GRAD_TOL_BF16's gate 8.2e-2, no
# farther (measured on one H100).  So the bf16 gradients of the flash
# path are held within HYMBA_BF16_GRAD_TOL of the plain path's and the
# naive path's (7.8e-2 there), a bound on gross faults only, and the
# gate with teeth runs in f32 (HYMBA_GRAD_F32: full width, the layers
# and global layers of HYMBA_F32, this batch of SyntheticLM tokens)
# through the FFMA kernel's f32 hd-64 instance: flash against naive
# within GRAD_TOL_F32 on every leaf but the decay leaves (within
# SSM_DECAY_GRAD_TOL), the dv fault above it.
HYMBA_BF16_GRAD_TOL = 0.2
HYMBA_GRAD_F32 = (1, 2048)


def faulty_ssd(fault: str):
    """The SSD core with one fault of SSD_FAULTS planted: each chunk run
    from a zero state (the chunked plain form one chunk at a time), or
    the reference's chunk loop transcribed with the inbound state's
    contribution not decayed by exp(cum), or with the upper triangle
    masked after the ``exp``."""
    from repro_torch.models import ssm
    check(fault in SSD_FAULTS, f"no SSD fault '{fault}'")

    def not_carried(x, dt, A, B, C, D, h0=None, chunk=ssm.CHUNK):
        q = min(chunk, x.shape[1])
        parts = [ssm.ssd_chunked_plain(*(t[:, i:i + q] for t in (x, dt)), A,
                                       *(t[:, i:i + q] for t in (B, C)), D)
                 for i in range(0, x.shape[1], q)]
        return torch.cat([y for y, _ in parts], dim=1), parts[-1][1]

    def loop(x, dt, A, B, C, D, h0=None, chunk=ssm.CHUNK):
        b, l, h, p = x.shape
        g, n = B.shape[2], B.shape[3]
        r = h // g
        (xdt, dtc, Bc, Cc), q, nc = ssm._pad_and_chunk(x, dt, B, C, chunk)
        hprev = torch.zeros((b, h, p, n), device=x.device)
        tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        ys = []
        for c in range(nc):
            xd, bk, ck = xdt[:, c].float(), Bc[:, c].float(), Cc[:, c].float()
            cum = torch.cumsum(dtc[:, c].float() * A, dim=1)
            seg = cum[:, :, None, :] - cum[:, None, :, :]
            if fault == "mask after exp":
                lm = torch.where(tri[None, :, :, None], torch.exp(seg), 0.0)
            else:
                lm = torch.exp(torch.where(tri[None, :, :, None], seg,
                                           float("-inf")))
            scores = torch.einsum("bign,bjgn->bgij", ck, bk)
            y_in = torch.einsum("bgij,bijgr,bjgrp->bigrp", scores,
                                lm.reshape(b, q, q, g, r),
                                xd.reshape(b, q, g, r, p))
            y_st = torch.einsum("bign,bgrpn->bigrp", ck,
                                hprev.reshape(b, g, r, p, n))
            if fault != "inbound decay dropped":
                y_st = y_st * torch.exp(cum).reshape(b, q, g, r)[..., None]
            ys.append((y_in + y_st).reshape(b, q, h, p))
            decay_end = torch.exp(cum[:, -1:, :] - cum)
            h_add = torch.einsum("bjgrp,bjgn->bgrpn", (
                xd * decay_end[..., None]).reshape(b, q, g, r, p), bk)
            hprev = hprev * torch.exp(cum[:, -1, :])[:, :, None, None] + \
                h_add.reshape(b, h, p, n)
        y = torch.cat(ys, dim=1)[:, :l] + x * D[:, None]
        return y.to(x.dtype), hprev
    return swapped(ssm, "_ssd_chunked",
                   not_carried if fault == "state not carried" else loop)


def ssd_gate(params, x, cfg, label: str, dev) -> dict:
    """One mixer's ``params`` on ``x`` (1, S, D) in bf16: ``ssm_apply``
    (its y, h and conv cache) in bf16 and at f32 against
    ``ssm_recurrence_plain`` in float64, the plain chunked form against
    the main path's, the planted SSD faults, and the gradients of a
    one-layer loss with and without the mask after the ``exp``."""
    from repro_torch.models import ssm
    with torch.no_grad():
        wide = {k: v.double() for k, v in params.items()}
        t0 = time.perf_counter()
        y64, c64 = ssm.ssm_recurrence_plain(wide, x.double(), cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ref_s = time.perf_counter() - t0
        del wide
    ref = (y64, c64["h"], c64["conv"])

    def gaps(got, want):
        """(y's worst token, h, conv), and y's whole ||a - b|| / ||b||,
        in float64."""
        d = got[0].double() - want[0].double()
        tok = (d.norm(dim=-1) / want[0].double().norm(dim=-1)
               .clamp_min(1e-300)).max().item()
        rest = [((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-300)).item()
                for a, b in zip(got[1:], want[1:])]
        whole = (d.norm() / want[0].double().norm()).item()
        return [tok] + rest, whole

    def run(dtype, fault=None):
        p = {k: v.to(dtype) for k, v in params.items()}
        with torch.no_grad(), (faulty_ssd(fault) if fault
                               else contextlib.nullcontext()):
            y, c = ssm.ssm_apply(p, x.to(dtype), cfg, mode="prefill")
        return y, c["h"], c["conv"]
    out = {"reference_s": ref_s}
    with torch.no_grad():
        wide = {k: v.double() for k, v in params.items()}
        y_c, c_c = ssm.ssm_apply(wide, x.double(), cfg, mode="prefill")
        del wide
    exact, _ = gaps((y_c, c_c["h"], c_c["conv"]), ref)
    del y_c, c_c
    print(f"{label}: ssm_recurrence_plain in float64 over {x.shape[1]} "
          f"tokens in {ref_s:.1f} s; the chunked form in float64 against it: "
          f"y's worst token {exact[0]:.3e}, h {exact[1]:.3e}, conv "
          f"{exact[2]:.3e}")
    check(max(exact) <= SSD_F64_TOL, f"{label}: the chunked SSD in float64 "
          f"is not the recurrence: {exact}")
    out["float64_chunked_vs_recurrence"] = exact
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        tol = SSD_TOL[dtype]
        got = run(dtype)
        e, whole = gaps(got, ref)
        with swapped(ssm, "_ssd_chunked", ssm.ssd_chunked_plain):
            plain = run(dtype)
        e_plain, _ = gaps(plain, ref)
        vs_plain, _ = gaps(got, plain)
        del got, plain
        ok = max(e) <= tol and max(e_plain) <= tol
        print(f"{label}, {name}: ssm_apply vs the float64 recurrence: y's "
              f"worst token {e[0]:.3e} (the whole y {whole:.3e}), h "
              f"{e[1]:.3e}, conv {e[2]:.3e}; with ssd_chunked_plain "
              f"{e_plain[0]:.3e}, {e_plain[1]:.3e}, {e_plain[2]:.3e}; "
              f"ssm_apply vs the plain chunked form {vs_plain[0]:.3e}, "
              f"{vs_plain[1]:.3e}, {vs_plain[2]:.3e} (tolerance {tol:g}): "
              f"{'met' if ok else 'FAILED'}")
        check(ok, f"{label} {name}: the SSD gate fails")
        out[name] = dict(vs_f64=e, whole_y=whole, plain_vs_f64=e_plain,
                         vs_plain=vs_plain)
        for fault in SSD_FAULTS[:2]:
            ef, wf = gaps(run(dtype, fault), ref)
            print(f"{label}, {name}, planted: {fault}: y's worst token "
                  f"{ef[0]:.3e} (the whole y {wf:.3e}), h {ef[1]:.3e}, conv "
                  f"{ef[2]:.3e} (must exceed {tol:g})")
            check(max(ef) > tol, f"{label} {name}: the SSD gate cannot tell "
                  f"'{fault}'")
            out[name][fault] = ef
    # the mask after the exp: the forward the same, the gradients not
    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)
                    ).to(x.device, x.dtype)

    def grads(fault=None):
        p = {k: v.detach().clone().requires_grad_() for k, v in
             params.items()}
        xi = x.detach().clone().requires_grad_()
        with (faulty_ssd(fault) if fault else contextlib.nullcontext()):
            y, _ = ssm.ssm_apply(p, xi, cfg)
            names = sorted(p)
            g = torch.autograd.grad((y.float() * w.float()).sum(),
                                    [p[n] for n in names] + [xi])
        return y.detach(), dict(zip(names + ["x"], g))
    y_ok, g_ok = grads()
    y_bad, g_bad = grads("mask after exp")
    finite_ok = {k: bool(torch.isfinite(v).all()) for k, v in g_ok.items()}
    finite_bad = {k: bool(torch.isfinite(v).all()) for k, v in g_bad.items()}
    same_fwd = rel_norm(y_bad, y_ok)
    print(f"{label}, bf16, planted: mask after exp: the forward "
          f"||a-b||/||b|| {same_fwd:.3e} against the unfaulted; gradients of "
          f"sum(y·w) finite: unfaulted {all(finite_ok.values())}, faulted "
          f"{ {k: v for k, v in finite_bad.items() if not v} or 'all'}")
    check(all(finite_ok.values()), f"{label}: non-finite gradients "
          f"{finite_ok}")
    check(not all(finite_bad.values()), f"{label}: the gradients cannot "
          f"tell the mask after the exp")
    out["mask_after_exp"] = dict(forward_rel=same_fwd, finite=finite_bad)
    return out


def ssm_phase(card, dev, wrappers, *, mamba_cfg=None, hymba_cfg=None,
              requests: int = SSM_REQUESTS,
              prompt_lens: tuple[int, int] = SSM_PROMPT_LENS,
              prefill_s: int = SSM_PREFILL_S,
              gate_layer: int = SSM_GATE_LAYER,
              handoff_s: int = SSM_HANDOFF_S, gate_s: int = HYMBA_GATE_S,
              f32: tuple[int, int] = HYMBA_F32,
              train_layers: int = MAMBA2_TRAIN_LAYERS,
              train_batch: tuple[int, int] = SSM_TRAIN_BATCH) -> dict:
    """Full-width Mamba2-2.7B (``mamba_cfg``, default the registered
    config): serving through ``DecodeEngine.run`` (every counter at 0
    just before, read just after: no flash launch, no plain call), TTFT,
    prefill and decode rates and the decode step's HBM bound; the SSD
    gate on layer ``gate_layer``'s mixer input of a ``prefill_s``-token
    prefill with its planted faults; the
    prefill/decode handoff.  Then full-width Hymba-1.5B (``hymba_cfg``):
    serving (one launch of the wgmma kernel's bf16 hd-64 instance a
    global layer a prefill, no FFMA launch, no plain call), one launch
    timed beside the FFMA kernel's bf16 hd-64 instance on the same q, k,
    v, SDPA and its bound, the logits gate against the naive path with
    the planted flash faults, the handoff, the f32 check (the FFMA
    kernel's f32 hd-64 instance).  Then training both: step time,
    tokens/s, model-FLOP share (6·N, which leaves out the SSD's own
    quadratic term), peak memory, finite losses and gradients, the
    gradient gates.  Prints the seconds of each sub-phase.  The keywords
    shrink it for a rehearsal on the CPU (the kernels' plain versions,
    no counts, no times)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM, make_batch_fn
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain,
                                                     kernel_variant)
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tr
    from repro_torch.serve.engine import EngineConfig, _merge_slot_cache
    from repro_torch.train.checkpoint import tree_items, tree_leaves
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_state import make_train_step
    on_card = dev.type == "cuda"
    full_width = mamba_cfg is None
    mcfg = mamba_cfg or get_config(MAMBA2_ARCH)
    hcfg = hymba_cfg or get_config(HYMBA_ARCH)
    kernel = flash_attention_cuda if on_card else flash_attention_plain
    hd = hcfg.resolved_head_dim
    bf16_key, f32_key = (torch.bfloat16, hd, hd), (torch.float32, hd, hd)
    variant = kernel_variant(*bf16_key)
    t_phase = time.perf_counter()
    out: dict = {}
    laps: dict = {}
    t_lap = [t_phase]

    def lap(name: str) -> None:
        """The seconds since the last lap, as sub-phase ``name``."""
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def free():
        if on_card:
            torch.cuda.empty_cache()

    def n_global(c):
        return sum(rep * sum(1 for d in descs
                             if d.mixer != "ssm" and not d.window)
                   for descs, rep in c.layer_segments())

    def live_rel(a, b, c):
        return rel_norm(a[..., :c.vocab], b[..., :c.vocab])

    def draw(c, label, seed=0):
        t0 = time.perf_counter()
        params = tr.init(c, torch.Generator(dev).manual_seed(seed))
        sync()
        n = sum(t.numel() for t in tree_leaves(params))
        check(n == tr.count_params(c), f"{label}: {n} parameters drawn, "
              f"{tr.count_params(c)} counted")
        return params, n, time.perf_counter() - t0

    def serve(c, params, prompts, label, key, want):
        """The main path: ``prompts`` through ``DecodeEngine.run``;
        prints and returns its rates, counts and the decode step's HBM
        bound (every weight but the gathered embedding read once, and
        the SSM state of every slot read and written once)."""
        ecfg = EngineConfig(n_slots=SSM_SLOTS,
                            max_len=max(SSM_MAX_LEN, max(map(len, prompts))
                                        + SSM_MAX_NEW + 8),
                            max_new=SSM_MAX_NEW, temperature=0.0)
        serve_requests(c, params, dataclasses.replace(ecfg, n_slots=1),
                       [prompts[-1][:16]], "flash", wrappers, dev)
        plain_calls: list = []
        reset_flash_counts(wrappers)
        with counting_plain_attention(plain_calls):
            reqs, admits, steps, wall, counts = serve_requests(
                c, params, ecfg, prompts, "flash", wrappers, dev)
        _, geo = read_flash_counts(wrappers)
        check_flash_path(on_card, counts, geo, plain_calls, want, key, f"{label} serving")
        for r in reqs:
            check(r.done and len(r.generated) == SSM_MAX_NEW
                  and all(0 <= t < c.vocab for t in r.generated),
                  f"{label} request {r.rid}: done {r.done}, "
                  f"{len(r.generated)} tokens")
        lens = [len(p) for p in prompts]
        prefill_s_ = sum(d for _, d in admits.values())
        decode_s = sum(d for d, _ in steps)
        decode_tokens = sum(n for _, n in steps)
        full = [d * 1e3 for d, n in steps if n == SSM_SLOTS]
        step_ms = statistics.median(full or [d * 1e3 for d, _ in steps])
        ttft = sorted((len(r.prompt), sum(admits[r.rid]) * 1e3,
                       admits[r.rid][1] * 1e3) for r in reqs)
        top = ttft[-1]
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in tree_leaves(params))
        read_bytes = weight_bytes - params["embed"].numel() * \
            params["embed"].element_size()
        _, sh_, sp_, _, sn_, cd_ = ssm._dims(c)
        n_ssm = sum(rep * sum(1 for d in descs if d.mixer != "attn")
                    for descs, rep in c.layer_segments())
        state_bytes = n_ssm * SSM_SLOTS * (
            4 * sh_ * sp_ * sn_ + (c.ssm_conv - 1) * cd_
            * params["embed"].element_size())
        bound_ms = (read_bytes + 2 * state_bytes) / PEAK_HBM_BYTES * 1e3
        print(f"{label} served {len(prompts)} requests ({sum(lens)} prompt "
              f"tokens, {SSM_MAX_NEW} new each) in {wall:.3f} s through "
              f"{SSM_SLOTS} slots: {counts['flash_attention']} flash "
              f"launches ({geo}), {counts['flash_attention_wgmma']} wgmma, "
              f"{len(plain_calls)} plain calls [{card}]")
        for n, t, pre in ttft:
            print(f"  prompt {n:4d} tokens: prefill {pre:9.3f} ms, time to "
                  f"first token {t:9.3f} ms")
        print(f"prefill: {sum(lens)} tokens in {prefill_s_:.3f} s = "
              f"{sum(lens) / prefill_s_:.1f} tokens/s; at the longest prompt "
              f"({top[0]} tokens) TTFT {top[1]:.3f} ms, "
              f"{top[0] / top[2] * 1e3:.1f} tokens/s; decode: {len(steps)} "
              f"engine steps, median {step_ms:.3f} ms a step at "
              f"{SSM_SLOTS} slots ({len(full)} such steps), {decode_tokens} "
              f"tokens in {decode_s:.3f} s = "
              f"{decode_tokens / decode_s:.1f} tokens/s; HBM bound of a step "
              f"{bound_ms:.3f} ms ({read_bytes / 1e9:.2f} GB of weights read, "
              f"the gathered embedding left out, and "
              f"{state_bytes / 1e9:.2f} GB of SSM state read and written) "
              f"[{card}]")
        return dict(prompt_lens=lens, wall_s=wall,
                    launches=counts["flash_attention"],
                    launches_by_geometry={str(k): v for k, v in geo.items()},
                    requests=[dict(prompt=n, ttft_ms=t, prefill_ms=pre)
                              for n, t, pre in ttft],
                    ttft_ms_longest=top[1],
                    prefill_tokens_per_s=sum(lens) / prefill_s_,
                    decode_steps=len(steps), decode_step_ms_median=step_ms,
                    decode_tokens_per_s=decode_tokens / decode_s,
                    weight_gb=weight_bytes / 1e9,
                    decode_read_gb=read_bytes / 1e9,
                    state_gb=state_bytes / 1e9, decode_bound_ms=bound_ms)

    def handoff(c, params, tokens, drop_state=False) -> float:
        """The last logits of a prefill of ``tokens`` (1, S + 1) against a
        prefill of the first S and one decode step of the last (with
        ``drop_state``, from zeroed SSM caches: the planted fault)."""
        s = tokens.shape[1] - 1
        with torch.no_grad():
            _, pcache = tr.forward(params, {"tokens": tokens[:, :s]}, c,
                                   mode="prefill", last_logit_only=True)
            cache = tr.init_cache(c, 1, s + 8, device=dev)
            _merge_slot_cache(cache, pcache, 0, s)
            del pcache
            if drop_state:
                for path, t in tree_items(cache).items():
                    if "::ssm::" in path:
                        t.zero_()
            step, _ = tr.decode_step(params, cache, tokens[:, s:],
                                     torch.tensor([s], device=dev), c)
            del cache
            whole, _ = tr.forward(params, {"tokens": tokens}, c,
                                  mode="prefill", last_logit_only=True)
        return live_rel(step, whole[:, -1], c)

    def handoffs(c, params, tokens, label) -> dict:
        """``handoff`` at the reference's init (read) and conditioned
        (gated at the dtype's SSM_HANDOFF_TOL, the dropped state above
        it); ``params`` conditioned in place."""
        tol = SSM_HANDOFF_TOL[c.activation_dtype]
        rels = {"reference init": handoff(c, params, tokens)}
        condition(params, c.d_model)
        rels["conditioned"] = handoff(c, params, tokens)
        rels["state dropped"] = handoff(c, params, tokens, drop_state=True)
        print(f"{label}, {c.dtype}: prefill of {tokens.shape[1] - 1} tokens "
              f"+ one decode step vs the prefill of {tokens.shape[1]}, last "
              f"logits ||a-b||/||b||: reference init "
              f"{rels['reference init']:.3e} (read, not gated), conditioned "
              f"{rels['conditioned']:.3e} (tolerance {tol:g}); planted, the "
              f"SSM state dropped at the handoff: {rels['state dropped']:.3e}"
              f" (must exceed {tol:g})")
        check(rels["conditioned"] <= tol, f"{label} {c.dtype}: the "
              f"prefill/decode handoff disagrees")
        check(rels["state dropped"] > tol, f"{label} {c.dtype}: the handoff "
              f"gate cannot tell a dropped state")
        return rels

    def prefill_and_decode(c, p, tokens, impl):
        flags = tr.RunFlags(attn_impl=impl)
        lg, pcache = tr.forward(p, {"tokens": tokens}, c, mode="prefill",
                                flags=flags)
        cache = tr.init_cache(c, 1, tokens.shape[1] + 8, device=dev)
        _merge_slot_cache(cache, pcache, 0, tokens.shape[1])
        del pcache
        nxt = torch.argmax(lg[:, -1].float(), dim=-1)[:, None]
        first, _ = tr.decode_step(p, cache, nxt, torch.tensor(
            [tokens.shape[1]], device=dev), c, flags)
        return lg, first

    def leaf_gate(t, label, rels, tol):
        """Per leaf ||a - b|| / ||b|| within ``tol`` (a planted fault
        must exceed it or leave a leaf non-finite), the decay leaves
        within SSM_DECAY_GRAD_TOL; prints each and returns the
        failures."""
        failed = []
        for what, rel in rels.items():
            fault = what.startswith("planted")
            nonfinite = [k for k, v in rel.items() if not math.isfinite(v)]
            decay = {k: v for k, v in rel.items()
                     if k.endswith(SSM_DECAY_LEAVES)}
            rest = {k: v for k, v in rel.items() if k not in decay}
            worst = max(rest, key=lambda k: (not math.isfinite(rest[k]),
                                              rest[k]))
            top = sorted(decay.items(), key=lambda kv: -kv[1])[:1]
            print(f"{label} gradients per leaf on conditioned weights, "
                  f"{what}: worst {rest[worst]:.3e} ({worst}), "
                  f"{rest[worst] / tol:.3f} of "
                  f"{'the gate (must exceed it)' if fault else 'its tolerance'}"
                  f" {tol:g}"
                  + (f"; the decay leaves' worst {top[0][1]:.3e} ({top[0][0]}"
                     f", tolerance {SSM_DECAY_GRAD_TOL:g})" if top else "")
                  + (f"; non-finite: {nonfinite}" if nonfinite else ""))
            if fault and not (rest[worst] > tol or nonfinite):
                failed.append(f"{label} {what}: the gate cannot tell it")
            if not fault and (nonfinite or rest[worst] > tol or any(
                    v > SSM_DECAY_GRAD_TOL for v in decay.values())):
                failed.append(f"{label} {what}: {worst} at "
                              f"{rest[worst]:.3e} against {tol:g}, decay "
                              f"leaves {top}")
        t.setdefault("grad_gates", {}).update(
            {k: max(v.values()) for k, v in rels.items()})
        return failed

    # == Mamba2-2.7B ==========================================================
    free()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    params, n_params, draw_s = draw(mcfg, MAMBA2_ARCH)
    check(n_params == MAMBA2_PARAMS or not full_width,
          f"{n_params} parameters, not {MAMBA2_PARAMS}")
    di, sh, sp, sg, sn, conv_dim = ssm._dims(mcfg)
    print(f"{MAMBA2_ARCH}: {mcfg.n_layers} layers, d_model {mcfg.d_model}, "
          f"{sh} SSM heads of {sp}, state {sn}, {sg} B/C group, conv "
          f"{mcfg.ssm_conv} over {conv_dim} channels, vocab {mcfg.vocab} "
          f"(padded {mcfg.padded_vocab}): {n_params:,} parameters, drawn in "
          f"{draw_s:.1f} s")
    gen = torch.Generator().manual_seed(0)
    lens = torch.randint(prompt_lens[0], prompt_lens[1] + 1, (requests,),
                         generator=gen).tolist()
    prompts = [torch.randint(0, mcfg.vocab, (n,), generator=gen).tolist()
               for n in lens]
    m = out["mamba2"] = serve(mcfg, params, prompts, MAMBA2_ARCH, None, 0)
    lap("mamba2 serving")

    # the prefill's profile by kind (the SSD apart) was cut for the
    # script's time; PERF.md keeps its last reading
    tokens = torch.randint(0, mcfg.vocab, (1, prefill_s), generator=gen
                           ).to(dev)
    if on_card:
        m["serve_peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"{MAMBA2_ARCH} serving in bf16: peak device memory "
              f"{m['serve_peak_memory_gb']:.2f} GB [{card}]")

    # -- the SSD gate on one layer's mixer input ----------------------------
    seen: list = []
    apply = ssm.ssm_apply

    def recorded(p, x, c, **kw):
        if len(seen) == gate_layer:
            seen.append((p, x.detach().clone()))
        elif len(seen) < gate_layer:
            seen.append(None)
        return apply(p, x, c, **kw)
    with swapped(ssm, "ssm_apply", recorded), torch.no_grad():
        tr.forward(params, {"tokens": tokens}, mcfg, mode="prefill",
                   last_logit_only=True)
    lp, x = seen[gate_layer]
    del seen
    m["ssd_gate"] = ssd_gate(lp, x, mcfg, f"{MAMBA2_ARCH} layer {gate_layer}"
                             f", {prefill_s}-token prefill", dev)
    del lp, x
    free()
    lap("mamba2 SSD gate")

    # -- the prefill/decode handoff ----------------------------------------
    htok = torch.randint(0, mcfg.vocab, (1, handoff_s + 1), generator=gen
                         ).to(dev)
    m["handoff"] = {"bf16": handoffs(mcfg, params, htok, MAMBA2_ARCH)}
    del params
    free()
    c32 = dataclasses.replace(mcfg, dtype="float32")
    p32, _, _ = draw(c32, MAMBA2_ARCH, seed=1)
    m["handoff"]["f32"] = handoffs(c32, p32, htok, MAMBA2_ARCH)
    del p32
    free()
    lap("mamba2 handoffs")

    # == Hymba-1.5B ===========================================================
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    params, n_params, draw_s = draw(hcfg, HYMBA_ARCH)
    check(n_params == HYMBA_PARAMS or not full_width,
          f"{n_params} parameters, not {HYMBA_PARAMS}")
    globals_ = n_global(hcfg)
    print(f"{HYMBA_ARCH}: {hcfg.n_layers} hybrid layers ({globals_} global "
          f"at {hcfg.global_layers}, the others windowed at "
          f"{hcfg.local_window}), d_model {hcfg.d_model}, {hcfg.n_heads} q "
          f"heads over {hcfg.n_kv_heads} kv heads of {hd} (the {variant} "
          f"kernel's bf16 {hd}/{hd} instance), {hcfg.ssm_heads} SSM heads of "
          f"{hcfg.ssm_head_dim}, state {hcfg.ssm_state}, vocab {hcfg.vocab} "
          f"(padded {hcfg.padded_vocab}): {n_params:,} parameters, drawn in "
          f"{draw_s:.1f} s")
    hprompts = [torch.randint(0, hcfg.vocab, (n,), generator=gen).tolist()
                for n in lens]
    h = out["hymba"] = serve(hcfg, params, hprompts, HYMBA_ARCH, bf16_key,
                             globals_ * len(lens))
    row = split_launch_row(f"{HYMBA_ARCH} serving", 1, max(lens),
                           hcfg.n_heads, hd, hd, torch.bfloat16, dev, on_card)
    if on_card:
        print(f"flash_attention ({row['variant']} {hd}/{hd}) at B=1 "
              f"S={max(lens)} H={hcfg.n_heads} causal bf16: {row['ms']:.4f} "
              f"ms a launch ({row['tflops']:.2f} TFLOP/s), max_abs_err "
              f"{row['max_abs_err']:.3e} vs plain; the FFMA instance on the "
              f"same q, k, v {ffma_ms(row)}; plain "
              f"{row['plain_ms']:.3f} ms, SDPA {row['library_ms']:.4f} ms "
              f"(backend {row['library_backend']}; kernel/SDPA "
              f"{row['ms'] / row['library_ms']:.2f}), bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}) [{card}]")
        h["serve_peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    h["launch"] = row
    lap("hymba serving")

    # -- the logits gate: flash against naive on a long prompt --------------
    gtok = torch.randint(0, hcfg.vocab, (1, gate_s), generator=gen).to(dev)
    calls: list = []
    with attend_as(dev, recording(kernel, calls)), torch.no_grad():
        prefill_and_decode(hcfg, params, gtok, "flash")
    check(len(calls) == globals_, f"{len(calls)} flash calls in a prefill "
          f"of {globals_} global layers")
    h["flash_on_model_inputs"] = regime_forward(
        calls, f"{HYMBA_ARCH} {gate_s}-token prefill, the global layers "
        f"(B=1 S={gate_s} H={hcfg.n_heads} hd={hd})")
    del calls
    h["logits_rel_err"] = {}
    for regime in ("reference init", "conditioned"):
        if regime == "conditioned":
            condition(params, hcfg.d_model)
        with torch.no_grad():
            runs = {impl: prefill_and_decode(hcfg, params, gtok, impl)
                    for impl in ("flash", "naive")}
            with attend_as(dev, flash_attention_plain):
                runs["plain"] = prefill_and_decode(hcfg, params, gtok,
                                                   "flash")
            errs = {f"flash vs {b}": [live_rel(x, y, hcfg) for x, y in
                                      zip(runs["flash"], runs[b])]
                    for b in ("plain", "naive")}
            del runs["flash"]
            for fault in PLANTED_FAULTS:
                with attend_as(dev, planted_fault(fault)):
                    lg = prefill_and_decode(hcfg, params, gtok, "flash")
                for b in ("plain", "naive"):
                    errs[f"{fault} vs {b}"] = [live_rel(x, y, hcfg) for x, y
                                               in zip(lg, runs[b])]
                del lg
        del runs
        free()
        for what, pair in errs.items():
            fault = not what.startswith("flash")
            print(f"{HYMBA_ARCH} {gate_s}-token prompt, {regime}, {what}: "
                  f"prefill logits ||a-b||/||b|| {pair[0]:.3e}, first decode "
                  f"logits {pair[1]:.3e} ("
                  + ("read" if fault and what.endswith("naive") else
                     f"must exceed {HYMBA_LOGITS_TOL:g} in one regime"
                     if fault else f"tolerance {HYMBA_LOGITS_TOL:g}") + ")")
        h["logits_rel_err"][regime] = errs
    for regime, errs in h["logits_rel_err"].items():
        for what, pair in errs.items():
            if what.startswith("flash"):
                check(max(pair) <= HYMBA_LOGITS_TOL, f"{HYMBA_ARCH} {regime}, "
                      f"{what}: the logits gate of {HYMBA_LOGITS_TOL:g} fails")
    for fault in PLANTED_FAULTS:
        seen = [max(e[f"{fault} vs plain"])
                for e in h["logits_rel_err"].values()]
        check(max(seen) > HYMBA_LOGITS_TOL, f"{HYMBA_ARCH}: the logits gate "
              f"cannot tell '{fault}' in either regime ({seen})")
    del params
    free()
    lap("hymba logits gate")
    # the handoff: fresh weights (the gate above conditioned its own)
    htok = torch.randint(0, hcfg.vocab, (1, handoff_s + 1), generator=gen
                         ).to(dev)
    params, _, _ = draw(hcfg, HYMBA_ARCH)
    h["handoff"] = {"bf16": handoffs(hcfg, params, htok, HYMBA_ARCH)}
    del params
    free()
    c32 = dataclasses.replace(hcfg, dtype="float32")
    p32, _, _ = draw(c32, HYMBA_ARCH, seed=1)
    h["handoff"]["f32"] = handoffs(c32, p32, htok, HYMBA_ARCH)
    del p32
    free()
    lap("hymba handoffs")

    # -- the f32 check through the FFMA kernel's f32 hd-64 instance ----------
    l32, s32 = f32
    cfg32 = dataclasses.replace(hcfg, n_layers=l32, dtype="float32",
                                global_layers=HYMBA_F32_GLOBAL)
    p32, _, _ = draw(cfg32, HYMBA_ARCH, seed=1)
    g32 = n_global(cfg32)
    reset_flash_counts(wrappers)
    with torch.no_grad():
        runs = {"flash": prefill_and_decode(cfg32, p32, gtok[:, :s32],
                                            "flash")}
        sync()
        counts32, geo32 = read_flash_counts(wrappers)
        check_flash_path(on_card, counts32, geo32, [], g32, f32_key, "the f32 prefill")
        runs["naive"] = prefill_and_decode(cfg32, p32, gtok[:, :s32],
                                           "naive")
    pair = [live_rel(a, b, cfg32) for a, b in zip(runs["flash"],
                                                   runs["naive"])]
    del runs, p32
    free()
    print(f"{HYMBA_ARCH} f32, {l32} layers (global {HYMBA_F32_GLOBAL}, "
          f"through the FFMA kernel's {hd}/{hd} f32 instance: "
          f"{geo32.get(f32_key, 0)} launches), one {s32}-token prompt (window "
          f"{hcfg.local_window}), flash vs naive at the reference's init: "
          f"prefill logits ||a-b||/||b|| {pair[0]:.3e}, first decode logits "
          f"{pair[1]:.3e} (tolerance {HYMBA_F32_TOL:g})")
    check(max(pair) <= HYMBA_F32_TOL, f"{HYMBA_ARCH} f32 flash vs naive: "
          f"the logits disagree")
    h.update(f32_logits_rel_err=pair, launches_f32=geo32.get(f32_key, 0))
    h["launch_f32"] = split_launch_row(f"{HYMBA_ARCH} f32 check", 1, s32,
                                       hcfg.n_heads, hd, hd, torch.float32,
                                       dev, on_card)
    lap("hymba f32 check")

    # == training =========================================================
    mt = dataclasses.replace(mcfg, n_layers=train_layers)
    check(tr.count_params(mt) == MAMBA2_TRAIN_PARAMS or not full_width,
          f"{tr.count_params(mt)} parameters at {train_layers} layers")
    t, grads_of = train_llm(
        mt, dev, card, wrappers, f"at full width with {train_layers} of its "
        f"{mcfg.n_layers} layers ({mcfg.n_layers} layers: "
        f"{16 * MAMBA2_PARAMS / 1e9:.1f} GB)", None, 0, train_batch,
        SSM_TRAIN_TIMED, profile_steps=True)
    g_main = grads_of()
    with swapped(ssm, "_ssd_chunked", ssm.ssd_chunked_plain):
        g_plain = grads_of()
    rels = {"ssm_apply vs ssd_chunked_plain, bf16": leaf_rel(g_main,
                                                             g_plain)}
    del g_main
    with faulty_ssd("state not carried"):
        rels["planted: state not carried vs ssd_chunked_plain"] = leaf_rel(
            grads_of(), g_plain)
    del g_plain, grads_of
    free()
    failed = leaf_gate(t, MAMBA2_ARCH, rels, SSD_GRAD_TOL)
    check(not failed, "; ".join(failed))
    m["train"] = t
    lap("mamba2 training")

    ht = dataclasses.replace(hcfg, n_layers=HYMBA_TRAIN_LAYERS,
                             global_layers=HYMBA_F32_GLOBAL)
    check(tr.count_params(ht) == HYMBA_TRAIN_PARAMS or not full_width,
          f"{tr.count_params(ht)} parameters at {HYMBA_TRAIN_LAYERS} layers")
    t, grads_of = train_llm(
        ht, dev, card, wrappers, f"at full width with {HYMBA_TRAIN_LAYERS} "
        f"of its {hcfg.n_layers} layers (global {HYMBA_F32_GLOBAL})",
        bf16_key, 2 * n_global(ht), train_batch, SSM_TRAIN_TIMED,
        profile_steps=True)
    g_flash = grads_of()
    with attend_as(dev, flash_attention_plain):
        rels = {"flash vs plain, bf16": leaf_rel(g_flash, grads_of())}
    free()
    rels["flash vs naive, bf16"] = leaf_rel(g_flash, grads_of(
        attn_impl="naive"))
    del g_flash, grads_of
    free()
    failed = leaf_gate(t, HYMBA_ARCH, rels, HYMBA_BF16_GRAD_TOL)
    # the f32 gradient gate through the FFMA kernel's f32 hd-64 instance
    p32, _, _ = draw(cfg32, HYMBA_ARCH, seed=2)
    condition(p32, hcfg.d_model)
    b32, s32_ = HYMBA_GRAD_F32
    one32 = make_batch_fn(SyntheticLM(cfg32, b32, s32_, seed=1),
                          device=dev)(0)

    def grads32(**over):
        fn = make_train_step(cfg32, AdamWConfig(), tr.RunFlags(
            **dict(dict(attn_impl="flash", remat=True), **over)))
        return fn.value_and_grad(p32, one32)[2]
    g_naive = grads32(attn_impl="naive")
    reset_flash_counts(wrappers)
    rels32 = {"flash vs naive, f32": leaf_rel(grads32(), g_naive)}
    sync()
    counts_g, geo_g = read_flash_counts(wrappers)
    check_flash_path(on_card, counts_g, geo_g, [], 2 * g32, f32_key, "the f32 gradients "
               "(forward and remat recompute)")
    with dv_scaled_backward(GRAD_FAULT):
        rels32["planted fault vs naive, f32"] = leaf_rel(grads32(), g_naive)
    del g_naive, p32
    free()
    failed += leaf_gate(t, f"{HYMBA_ARCH} f32 ({cfg32.n_layers} layers, "
                        f"{b32}x{s32_} tokens)", rels32, GRAD_TOL_F32)
    check(not failed, "; ".join(failed))
    t["launches_f32"] = geo_g.get(f32_key, 0)
    t["launch"] = split_launch_row(f"{HYMBA_ARCH} training", train_batch[0],
                                   train_batch[1], hcfg.n_heads, hd, hd,
                                   torch.bfloat16, dev, on_card)
    h["train"] = t
    if on_card:
        print(f"{HYMBA_ARCH} training, a launch at B={train_batch[0]} "
              f"S={train_batch[1]} H={hcfg.n_heads} causal bf16 "
              f"({t['launch']['variant']} {hd}/{hd}): "
              f"{t['launch']['ms']:.4f} ms ({t['launch']['tflops']:.2f} "
              f"TFLOP/s); the FFMA instance {ffma_ms(t['launch'])}; SDPA "
              f"{t['launch']['library_ms']:.4f} ms; bound "
              f"{t['launch']['bound_ms']:.4f} ms [{card}]")
    lap("hymba training")
    out["launches_bf16"] = h["launches"] + t["launches"]
    out["launches_f32"] = h["launches_f32"] + t["launches_f32"]
    out["seconds"] = time.perf_counter() - t_phase
    out["sub_phase_s"] = laps
    print(f"ssm phase: {out['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in laps.items()) + ")")
    return out


# -- the encoder and the VLM: HuBERT-XLarge, InternVL2-26B -------------------

# HuBERT-XLarge (src/repro/configs/hubert_xlarge.py), not reduced: 48
# non-causal layers of 16 heads of 80 (the wgmma kernel's bf16 (80, 80)
# instance), a 504-target head.  Its traffic: HUBERT_UTTERANCES
# utterances of lengths drawn from seed 0 in HUBERT_FRAMES (2-30 s of
# audio at 20 ms a frame), each encoded alone at batch 1, then one of
# HUBERT_LONG frames (the reference's prefill_32k length, its pos_embed's
# rows).  Training: the whole depth, HUBERT_TRAIN_BATCH frames a step of
# SyntheticLM's {features, labels, label_mask} (an 8% mask), one warm
# step and HUBERT_TRAIN_TIMED timed.  The f32 check: HUBERT_F32 (layers,
# frames) through the FFMA kernel's f32 (80, 80) instance.
HUBERT_ARCH, HUBERT_PARAMS = "hubert-xlarge", 988_058_880
HUBERT_UTTERANCES = 16
HUBERT_FRAMES = (100, 1500)
HUBERT_LONG = 32768
HUBERT_TRAIN_BATCH = (2, 2048)
HUBERT_TRAIN_TIMED = 3
HUBERT_F32 = (4, 2048)
# InternVL2-26B (src/repro/configs/internvl2_26b.py), not reduced: 48
# layers of 48 q heads over 8 kv heads of 128 (the wgmma kernel's bf16
# (128, 128) instance), 256 image embeddings 3200 wide ahead of the text.
# Text serving through DecodeEngine.run (the reference's engine passes
# no image): VLM_REQUESTS prompts of lengths drawn from seed 0 in
# VLM_PROMPT_LENS, VLM_MAX_NEW new tokens each, VLM_SLOTS slots of
# VLM_MAX_LEN.  Image-prefixed serving: VLM_IMAGE_REQUESTS prompts of
# lengths drawn in (256, VLM_IMAGE_MAX], each a prefill through
# ``forward(mode="prefill")`` with its image then VLM_IMAGE_DECODE greedy
# ``decode_step``s.  The gates on a VLM_GATE_S-token prompt with the
# image.  Training: VLM_TRAIN_LAYERS of the 48 layers with the image
# prefix, VLM_TRAIN_BATCH tokens a step.  The f32 check: VLM_F32.
VLM_ARCH, VLM_PARAMS = "internvl2-26b", 19_882_383_360
VLM_REQUESTS = 16
VLM_PROMPT_LENS = (128, 4000)
VLM_SLOTS, VLM_MAX_LEN, VLM_MAX_NEW = 8, 4096, 32
VLM_IMAGE_REQUESTS, VLM_IMAGE_MAX, VLM_IMAGE_DECODE = 4, 2048, 16
VLM_GATE_S = 2048
VLM_TRAIN_LAYERS, VLM_TRAIN_BATCH, VLM_TRAIN_TIMED = 4, (2, 2048), 3
VLM_F32 = (4, 2048)
# The logits gates of both models: the flash path against the naive path
# and against the path of the kernel's plain version, ||a - b|| <= tol
# ||b|| over the live vocab, on conditioned weights (``condition``) at
# ENC_VLM_LOGITS_TOL, the other bf16 models' conditioned gate (PERF.md
# §2).  At the reference's init (fan-in = the layer count, 48) the 48
# layers amplify one-ulp differences past any gate: measured on one H100,
# HuBERT's flash vs plain paths read 0.52 and InternVL2's 0.12-0.14 while
# every launch's mean error against float64 equalled its plain
# version's; so there the logits are read beside the gap of two paths
# with no kernel at all (plain vs naive), and the launches are gated
# (``launch_gate``, ``regime_forward``).  At HUBERT_LONG frames the
# naive path would hold the (16, 32768, 32768) f32 scores, 68.7 GB:
# there the flash path is held against ``chunked_q`` (the same function
# a q block of 1024 at a time).  The f32 checks: flash against naive at
# ENC_VLM_F32_TOL, as the other configs' f32 checks; HuBERT's on
# conditioned weights (at the reference's init its 4 layers of fan-in 4
# give scores of std ~320 over 2048 keys, near-ties that two f32 orders
# break apart: 3.9e-3, measured on one H100), with the dropped v panel
# above the gate.
ENC_VLM_LOGITS_TOL = 3e-2
ENC_VLM_F32_TOL = 1e-4
# the plain version's tiles on the plain path and in the per-launch gates:
# 512 x 512 in place of the kernels' (the same function summed in another
# f32 order), so that a plain forward of 48 layers at 1400-2000 tokens
# walks tens of tile pairs a launch, not hundreds
ENC_VLM_PLAIN_TILES = dict(block_q=512, block_k=512)


def plain_over(tiles: dict):
    """The flash kernels' plain version over ``tiles``, called as the
    kernel's wrapper is."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    def attend(q, k, v, causal=True, **cap):
        return flash_attention_plain(q, k, v, causal=causal, **tiles, **cap)
    return attend


def panel_dropped(attend):
    """``attend`` with v's columns 64 and up zeroed: the output's last
    16 columns at hd 80 lost, what a kernel that dropped its second v
    panel would give (the planted fault of the (80, 80) gates)."""
    def faulty(q, k, v, causal=True, **cap):
        keep = torch.ones(v.shape[3], dtype=v.dtype, device=v.device)
        keep[64:] = 0
        return attend(q, k, v * keep, causal=causal, **cap)
    return faulty


def launch_gate(calls: list, label: str, plain_tiles: dict,
                fault: str = "the second v panel dropped") -> dict:
    """Each recorded launch (q, k, v, causal, out) against its plain
    version, elementwise at FLASH_TOL, and against float64 attention:
    the kernel's mean |error| at most REGIME_F64_RATIO times the plain
    version's.  The planted ``fault`` must fail both on the first
    launch: the second v panel dropped (the (80, 80) instance's), or a
    fault of PLANTED_FAULTS.  Returns the failures with the readings."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    if fault == "the second v panel dropped":
        planted = panel_dropped(flash_attention_plain)
    else:
        def planted(q, k, v, causal, **tiles):
            return planted_fault(fault)(q, k, v, causal)
    worst_used, ratios, failed = 0.0, [], []
    fault_used = fault_ratio = None
    for i, (q, k, v, causal, o) in enumerate(calls):
        exact = attention_f64(q, k, v, causal)
        ref = flash_attention_plain(q, k, v, causal=causal, **plain_tiles)
        atol, rtol = FLASH_TOL[o.dtype]
        e_plain = (ref.double() - exact).abs().mean().item()

        def used(x):
            return ((x.float() - ref.float()).abs()
                    / (atol + rtol * ref.float().abs())).max().item()
        worst_used = max(worst_used, used(o))
        ratios.append((o.double() - exact).abs().mean().item() / e_plain)
        if i == 0:
            bad = planted(q, k, v, causal, **plain_tiles)
            fault_used = used(bad)
            fault_ratio = (bad.double() - exact).abs().mean().item() \
                / e_plain
            del bad
        del exact, ref
    print(f"{label}: {len(calls)} launches on the model's own q, k, v; "
          f"kernel vs plain elementwise at {worst_used:.3f} of FLASH_TOL "
          f"(gate 1), mean |error| against float64 over the plain "
          f"version's worst {max(ratios):.4f} (gate {REGIME_F64_RATIO:g}); "
          f"{fault}: {fault_used:.1f} of FLASH_TOL, {fault_ratio:.1f} "
          f"against float64 (both must exceed)")
    if worst_used > 1 or max(ratios) > REGIME_F64_RATIO:
        failed.append(f"{label}: the kernel disagrees ({worst_used}, "
                      f"{max(ratios)})")
    if not (fault_used > 1 and fault_ratio > REGIME_F64_RATIO):
        failed.append(f"{label}: the gates cannot tell {fault}")
    return dict(launches=len(calls), flash_tol_used=worst_used,
                f64_ratio=ratios, fault_flash_tol_used=fault_used,
                fault_f64_ratio=fault_ratio, failed=failed)


def encoder_vlm_phase(card, dev, wrappers, *, hubert_cfg=None,
                      vlm_cfg=None, utterances: int = HUBERT_UTTERANCES,
                      frames: tuple[int, int] = HUBERT_FRAMES,
                      long_frames: int = HUBERT_LONG,
                      hubert_train: tuple[int, int] = HUBERT_TRAIN_BATCH,
                      hubert_f32: tuple[int, int] = HUBERT_F32,
                      requests: int = VLM_REQUESTS,
                      prompt_lens: tuple[int, int] = VLM_PROMPT_LENS,
                      image: tuple[int, int, int] = (VLM_IMAGE_REQUESTS,
                                                     VLM_IMAGE_MAX,
                                                     VLM_IMAGE_DECODE),
                      gate_s: int = VLM_GATE_S,
                      vlm_train: tuple[int, int, int] = (
                          VLM_TRAIN_LAYERS, *VLM_TRAIN_BATCH),
                      vlm_f32: tuple[int, int] = VLM_F32) -> dict:
    """Full-width HuBERT-XLarge (``hubert_cfg``, default the registered
    config): the utterances and the long encode through ``forward``
    (``mode="train"``, no remat, under ``torch.inference_mode``; every
    counter at 0 just before, read just after: one launch of the wgmma
    kernel's bf16 (80, 80) instance a layer an encode, none of the FFMA
    kernel, no plain call), frames/s and ms an utterance, the long
    encode's device time by kind; each (80, 80) launch of the longest
    utterance against its plain version and float64 (``launch_gate``,
    the dropped v panel above it); the logits against the naive and
    plain paths, read at the reference's init and gated on conditioned
    weights (the dropped panel through the model above the gate), the
    long encode's against ``chunked_q``; one launch
    timed at the longest utterance, the training batch and the long
    encode beside the FFMA instance, the plain version, SDPA and the
    bound; training the whole depth with the masked-frame loss (step
    time, frames/s, model-FLOP share, peak memory; the bf16 gradient
    gate against the naive path, the dv fault above it); the f32 check
    through the FFMA kernel's f32 (80, 80) instance, gated on
    conditioned weights.  Then full-width
    InternVL2-26B (``vlm_cfg``): text serving through
    ``DecodeEngine.run`` (one launch of the bf16 (128, 128) instance a
    layer a prefill), TTFT, prefill and decode rates, the decode step's
    HBM bound; image-prefixed prefills and greedy decode steps; the
    launches of an image-prefixed prefill against float64; the logits
    of the image-prefixed and the text prefill against the naive and
    plain paths (read at the reference's init, gated on conditioned
    weights), the image dropped above the gate; the f32 check;
    training with the depth cut and the image prefix, its gradient
    gate.  Prints the seconds of each sub-phase.  The keywords shrink it
    for a rehearsal on the CPU (the kernels' plain versions, no counts,
    no times)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain,
                                                     kernel_variant)
    from repro_torch.models import transformer as tr
    from repro_torch.serve.engine import EngineConfig, _merge_slot_cache
    from repro_torch.train.checkpoint import tree_leaves
    on_card = dev.type == "cuda"
    full_width = hubert_cfg is None
    hcfg = hubert_cfg or get_config(HUBERT_ARCH)
    vcfg = vlm_cfg or get_config(VLM_ARCH)
    kernel = flash_attention_cuda if on_card else flash_attention_plain
    hd_h, hd_v = hcfg.resolved_head_dim, vcfg.resolved_head_dim
    enc_key, enc_f32 = (torch.bfloat16, hd_h, hd_h), (torch.float32, hd_h,
                                                      hd_h)
    vlm_key, vlm_f32_key = (torch.bfloat16, hd_v, hd_v), (torch.float32,
                                                          hd_v, hd_v)
    t_phase = time.perf_counter()
    out: dict = {"hubert": {}, "internvl2": {}}
    laps: dict = {}
    t_lap = [t_phase]
    failed: list = []

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now
        print(f"  [{name}: {laps[name]:.1f} s]")

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def free():
        if on_card:
            torch.cuda.empty_cache()

    def live_rel(a, b, c):
        return rel_norm(a[..., :c.vocab], b[..., :c.vocab])

    def draw(c, label, seed=0, want=None):
        t0 = time.perf_counter()
        params = tr.init(c, torch.Generator(dev).manual_seed(seed))
        sync()
        n = sum(t.numel() for t in tree_leaves(params))
        check(n == tr.count_params(c) and (want is None or n == want),
              f"{label}: {n} parameters drawn, {tr.count_params(c)} "
              f"counted, {want} expected")
        return params, n, time.perf_counter() - t0

    def gate(label, runs, tol, fault_keys, read_keys=()):
        """Print each pair's ||a-b||/||b|| (prefill[, first decode]);
        the faults and controls of ``fault_keys`` must exceed ``tol``, the
        rest stay within it (``read_keys`` are printed only)."""
        for what, rels in runs.items():
            kind = ("read" if what in read_keys else
                    f"must exceed {tol:g}" if what in fault_keys
                    else f"tolerance {tol:g}")
            print(f"{label}, {what}: logits ||a-b||/||b|| "
                  + " / ".join(f"{x:.3e}" for x in rels) + f" ({kind})")
            if what in read_keys:
                continue
            if what in fault_keys and not max(rels) > tol:
                failed.append(f"{label}: the gate cannot tell {what}")
            if what not in fault_keys and max(rels) > tol:
                failed.append(f"{label}: {what} at {max(rels):.3e} "
                              f"against {tol:g}")

    def grad_gate(t, label, grads_of):
        """bf16 gradients on conditioned weights: the flash path against
        the naive path per leaf within GRAD_TOL_BF16, the backward's dv
        scaled by 1 + GRAD_FAULT above it."""
        g_naive = grads_of(attn_impl="naive")
        rels = {"flash vs naive": leaf_rel(grads_of(), g_naive)}
        with dv_scaled_backward(GRAD_FAULT):
            rels["planted dv fault vs naive"] = leaf_rel(grads_of(), g_naive)
        del g_naive
        free()
        for what, rel in rels.items():
            worst = max(rel, key=lambda k: (not math.isfinite(rel[k]),
                                            rel[k]))
            fault = what.startswith("planted")
            print(f"{label} gradients per leaf on conditioned weights, "
                  f"{what}: worst {rel[worst]:.3e} ({worst}; "
                  + ("must exceed" if fault else "tolerance")
                  + f" {GRAD_TOL_BF16:g})")
            if fault != (rel[worst] > GRAD_TOL_BF16):
                failed.append(f"{label} gradients, {what}: {worst} at "
                              f"{rel[worst]:.3e}")
        t["grad_gates"] = {k: max(v.values()) for k, v in rels.items()}

    def launch_row(label, b, s, h, hd, dtype, causal, plain_tiles=None):
        row = split_launch_row(label, b, s, h, hd, hd, dtype, dev, on_card,
                               causal=causal, plain_tiles=plain_tiles)
        if on_card:
            print(f"flash_attention ({row['variant']} {hd}/{hd}) {label} at "
                  f"B={b} S={s} H={h} {'causal' if causal else 'full'} "
                  f"{row['dtype']}: {row['ms']:.4f} ms a launch "
                  f"({row['tflops']:.2f} TFLOP/s), max_abs_err "
                  f"{row['max_abs_err']:.3e} vs plain; the FFMA instance on "
                  f"the same q, k, v {ffma_ms(row)}; plain "
                  f"{row['plain_ms']:.3f} ms, SDPA {row['library_ms']:.4f} ms "
                  f"(backend {row['library_backend']}; kernel/SDPA "
                  f"{row['ms'] / row['library_ms']:.2f}), bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}) [{card}]")
        return row

    # == HuBERT-XLarge ========================================================
    free()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    h = out["hubert"]
    params, n_params, draw_s = draw(hcfg, HUBERT_ARCH,
                                    want=HUBERT_PARAMS if full_width
                                    else None)
    L = hcfg.n_layers
    print(f"{HUBERT_ARCH}: {L} non-causal layers, d_model {hcfg.d_model}, "
          f"{hcfg.n_heads} heads of {hd_h} (the "
          f"{kernel_variant(*enc_key)} kernel's bf16 {hd_h}/{hd_h} "
          f"instance), features {hcfg.frontend_dim} wide, {hcfg.vocab} "
          f"targets (padded {hcfg.padded_vocab}): {n_params:,} parameters, "
          f"drawn in {draw_s:.1f} s")
    gen = torch.Generator().manual_seed(0)
    lens = torch.randint(frames[0], frames[1] + 1, (utterances,),
                         generator=gen).tolist()
    feats = [torch.randn((1, n, hcfg.frontend_dim), generator=gen)
             for n in lens]
    no_remat = tr.RunFlags(attn_impl="flash", remat=False)

    def encode(p, f, c=hcfg, flags=no_remat):
        with torch.inference_mode():
            return tr.forward(p, {"features": f}, c, flags=flags)[0]
    encode(params, feats[0][:, :64].to(dev))    # warm
    sync()
    plain_calls: list = []
    reset_flash_counts(wrappers)
    ms = []
    with counting_plain_attention(plain_calls):
        for f in feats:
            f = f.to(dev)
            sync()
            t0 = time.perf_counter()
            logits = encode(params, f)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            check(tuple(logits.shape) == (1, f.shape[1], hcfg.padded_vocab)
                  and bool(torch.isfinite(logits[..., :hcfg.vocab]).all()),
                  f"{HUBERT_ARCH}: logits {tuple(logits.shape)} not finite "
                  f"or misshapen")
    counts, geo = read_flash_counts(wrappers)
    check_flash_path(on_card, counts, geo, plain_calls, L * len(lens), enc_key,
               f"{HUBERT_ARCH} encoding {len(lens)} utterances")
    total_frames = sum(lens)
    h.update(utterance_frames=lens, utterance_ms=ms,
             frames_per_s=total_frames / sum(ms) * 1e3,
             launches=counts["flash_attention"],
             launches_by_geometry={str(k): v for k, v in geo.items()})
    top = lens.index(max(lens))
    f_top = feats[top].to(dev)
    if on_card:
        h["utterance_profile"] = profile(
            lambda: encode(params, f_top), 2,
            f"{HUBERT_ARCH} encodes of {max(lens)} frames")
    print(f"{HUBERT_ARCH} encoded {len(lens)} utterances of "
          f"{min(lens)}-{max(lens)} frames ({total_frames} frames, "
          f"{total_frames / 50:.1f} s of audio at 20 ms a frame) one at a "
          f"time: {h['frames_per_s']:.1f} frames/s, median "
          f"{statistics.median(ms):.3f} ms an utterance (the "
          f"{max(lens)}-frame one {ms[top]:.3f} ms); "
          f"flash launches {counts['flash_attention']} ({geo}), "
          f"{counts['flash_attention_ffma']} FFMA, {len(plain_calls)} plain "
          f"calls [{card}]")
    lap("hubert utterances")

    # -- the long encode ------------------------------------------------------
    long_f = torch.randn((1, long_frames, hcfg.frontend_dim),
                         generator=gen).to(dev)
    reset_flash_counts(wrappers)
    with counting_plain_attention(plain_calls):
        sync()
        t0 = time.perf_counter()
        long_logits = encode(params, long_f)
        sync()
        long_ms = (time.perf_counter() - t0) * 1e3
    counts, geo = read_flash_counts(wrappers)
    check_flash_path(on_card, counts, geo, plain_calls, L, enc_key,
               f"{HUBERT_ARCH} encoding {long_frames} frames")
    h.update(long_frames=long_frames, long_ms=long_ms,
             long_frames_per_s=long_frames / long_ms * 1e3,
             long_launches=counts["flash_attention"])
    print(f"{HUBERT_ARCH} encoded one utterance of {long_frames} frames "
          f"({long_frames / 50 / 60:.1f} min of audio) in {long_ms:.3f} ms, "
          f"{h['long_frames_per_s']:.1f} frames/s; {L} launches [{card}]")
    if on_card:
        prof = profile(lambda: encode(params, long_f), 1,
                       f"{HUBERT_ARCH} encodes of {long_frames} frames")
        if "device_ms_per_run" in prof:
            kms = prof["kernels_ms_per_run"]
            flash = sum(v for k, v in kms.items() if "fa_sm90" in k)
            gemm = sum(v for k, v in kms.items()
                       if any(t in k.lower() for t in
                              ("gemm", "xmma", "cutlass", "nvjet")))
            busy = prof["device_ms_per_run"]
            prof["by_kind_ms"] = dict(flash=flash, gemm=gemm,
                                      other=busy - flash - gemm)
            print(f"  the {long_frames}-frame encode by kind: the {L} flash "
                  f"launches {flash:.3f} ms ({100 * flash / busy:.1f}%), "
                  f"GEMMs {gemm:.3f} ms, the rest {busy - flash - gemm:.3f} "
                  f"ms; device busy {busy:.3f} of "
                  f"{prof['wall_ms_per_run']:.3f} ms of wall [{card}]")
        h["long_profile"] = prof
        h["serve_peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    lap("hubert long encode")

    # -- the gates: each launch, the logits ---------------------------------
    calls: list = []
    with attend_as(dev, recording(kernel, calls)), torch.no_grad():
        encode(params, f_top)
    h["launch_gate"] = launch_gate(
        calls, f"{HUBERT_ARCH} {max(lens)}-frame encode (B=1 S={max(lens)} "
        f"H={hcfg.n_heads} hd={hd_h}, full)", ENC_VLM_PLAIN_TILES)
    failed += h["launch_gate"].pop("failed")
    del calls

    def enc_rels(f, c=hcfg, p=None):
        """The flash path's logits on features ``f`` against the plain
        and naive paths', the plain against the naive (no kernel), and
        the dropped v panel's against the plain path's."""
        p = params if p is None else p
        runs = {"flash": encode(p, f, c)}
        with attend_as(dev, plain_over(ENC_VLM_PLAIN_TILES)):
            runs["plain"] = encode(p, f, c)
        runs["naive"] = encode(p, f, c, flags=dataclasses.replace(
            no_remat, attn_impl="naive"))
        with attend_as(dev, panel_dropped(kernel)):
            runs["fault"] = encode(p, f, c)
        return {"flash vs plain": [live_rel(runs["flash"], runs["plain"], c)],
                "flash vs naive": [live_rel(runs["flash"], runs["naive"], c)],
                "plain vs naive": [live_rel(runs["plain"], runs["naive"], c)],
                "v panel dropped vs plain": [live_rel(runs["fault"],
                                                      runs["plain"], c)]}
    faults = ("v panel dropped vs plain",)
    # the readings at the reference's init (0.52-0.56 in PR 29, chaotic,
    # not gated) were cut for the script's time in PR 30
    del long_logits
    condition(params, hcfg.d_model)
    h["logits_rel_err"] = {"conditioned": enc_rels(f_top)}
    gate(f"{HUBERT_ARCH} {max(lens)} frames, conditioned",
         h["logits_rel_err"]["conditioned"], ENC_VLM_LOGITS_TOL, faults,
         read_keys=("plain vs naive",))
    # the long encode's logits against chunked_q were cut for the
    # script's time: its launches stay gated against the plain version
    # (launch_long below)
    del params, long_f
    free()
    lap("hubert gates")

    # -- one launch timed at each geometry ----------------------------------
    h["launch"] = launch_row(f"{HUBERT_ARCH} longest utterance", 1,
                             max(lens), hcfg.n_heads, hd_h, torch.bfloat16,
                             False)
    h["launch_train"] = launch_row(f"{HUBERT_ARCH} training",
                                   *hubert_train, hcfg.n_heads, hd_h,
                                   torch.bfloat16, False)
    h["launch_long"] = launch_row(f"{HUBERT_ARCH} long encode", 1,
                                  long_frames, hcfg.n_heads, hd_h,
                                  torch.bfloat16, False,
                                  plain_tiles=dict(block_q=1024,
                                                   block_k=1024))
    lap("hubert launches")

    # -- training, the whole depth -----------------------------------------
    t, grads_of = train_llm(hcfg, dev, card, wrappers,
                            f"at full width and depth ({L} layers)",
                            enc_key, 2 * L, hubert_train, HUBERT_TRAIN_TIMED)
    grad_gate(t, HUBERT_ARCH, grads_of)
    del grads_of
    free()
    h["train"] = t
    lap("hubert training")

    # -- the f32 check through the FFMA kernel's f32 (80, 80) instance -----
    l32, s32 = hubert_f32
    c32 = dataclasses.replace(hcfg, n_layers=l32, dtype="float32")
    p32, _, _ = draw(c32, HUBERT_ARCH, seed=1)
    f32_feats = torch.randn((1, s32, hcfg.frontend_dim), generator=gen
                            ).to(dev)
    reset_flash_counts(wrappers)
    encode(p32, f32_feats, c32)
    sync()
    counts32, geo32 = read_flash_counts(wrappers)
    check_flash_path(on_card, counts32, geo32, [], l32, enc_f32, f"{HUBERT_ARCH} f32")
    label = (f"{HUBERT_ARCH} f32, {l32} layers, {s32} frames (the FFMA "
             f"kernel's f32 {hd_h}/{hd_h} instance: "
             f"{geo32.get(enc_f32, 0)} launches a forward)")
    rels32 = {"reference init": enc_rels(f32_feats, c32, p32)}
    gate(f"{label}, reference init", rels32["reference init"],
         ENC_VLM_F32_TOL, (), read_keys=tuple(rels32["reference init"]))
    condition(p32, c32.d_model)
    rels32["conditioned"] = enc_rels(f32_feats, c32, p32)
    gate(f"{label}, conditioned", rels32["conditioned"], ENC_VLM_F32_TOL,
         faults, read_keys=("plain vs naive",))
    del p32
    free()
    h.update(f32_logits_rel_err=rels32, launches_f32=geo32.get(enc_f32, 0))
    h["launch_f32"] = launch_row(f"{HUBERT_ARCH} f32 check", 1, s32,
                                 hcfg.n_heads, hd_h, torch.float32, False)
    lap("hubert f32 check")

    # == InternVL2-26B ========================================================
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    v = out["internvl2"]
    params, n_params, draw_s = draw(vcfg, VLM_ARCH,
                                    want=VLM_PARAMS if full_width else None)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    unread = sum(params[k].numel() * params[k].element_size()
                 for k in ("embed", "img_proj"))
    print(f"{VLM_ARCH}: {vcfg.n_layers} layers, d_model {vcfg.d_model}, "
          f"{vcfg.n_heads} q heads over {vcfg.n_kv_heads} kv heads of "
          f"{hd_v} (the {kernel_variant(*vlm_key)} kernel's bf16 "
          f"{hd_v}/{hd_v} instance), {vcfg.img_tokens} image embeddings "
          f"{vcfg.frontend_dim} wide, vocab {vcfg.vocab} (padded "
          f"{vcfg.padded_vocab}): {n_params:,} parameters, "
          f"{weight_bytes / 1e9:.2f} GB in {vcfg.dtype}, drawn in "
          f"{draw_s:.1f} s")
    vgen = torch.Generator().manual_seed(0)
    vlens = torch.randint(prompt_lens[0], prompt_lens[1] + 1, (requests,),
                          generator=vgen).tolist()
    prompts = [torch.randint(0, vcfg.vocab, (n,), generator=vgen).tolist()
               for n in vlens]
    ecfg = EngineConfig(n_slots=VLM_SLOTS, max_len=max(
        VLM_MAX_LEN, max(vlens) + VLM_MAX_NEW + 8), max_new=VLM_MAX_NEW,
        temperature=0.0)
    serve_requests(vcfg, params, dataclasses.replace(ecfg, n_slots=1),
                   [prompts[-1][:16]], "flash", wrappers, dev)
    plain_calls = []
    reset_flash_counts(wrappers)
    with counting_plain_attention(plain_calls):
        reqs, admits, steps, wall, counts = serve_requests(
            vcfg, params, ecfg, prompts, "flash", wrappers, dev)
    _, geo = read_flash_counts(wrappers)
    check_flash_path(on_card, counts, geo, plain_calls, vcfg.n_layers * len(vlens),
               vlm_key, f"{VLM_ARCH} text serving")
    for r in reqs:
        check(r.done and len(r.generated) == VLM_MAX_NEW
              and all(0 <= x < vcfg.vocab for x in r.generated),
              f"{VLM_ARCH} request {r.rid}: done {r.done}, "
              f"{len(r.generated)} tokens")
    prefill_s = sum(d for _, d in admits.values())
    decode_s = sum(d for d, _ in steps)
    decode_tokens = sum(n for _, n in steps)
    full = [d * 1e3 for d, n in steps if n == VLM_SLOTS]
    step_ms = statistics.median(full or [d * 1e3 for d, _ in steps])
    ttft = sorted((len(r.prompt), sum(admits[r.rid]) * 1e3,
                   admits[r.rid][1] * 1e3) for r in reqs)
    longest = ttft[-1]
    bound_ms = (weight_bytes - unread) / PEAK_HBM_BYTES * 1e3
    v.update(prompt_lens=vlens, wall_s=wall,
             launches=counts["flash_attention"],
             launches_by_geometry={str(k): n for k, n in geo.items()},
             requests=[dict(prompt=n, ttft_ms=t_, prefill_ms=pre)
                       for n, t_, pre in ttft],
             ttft_ms_longest=longest[1],
             prefill_tokens_per_s=sum(vlens) / prefill_s,
             decode_steps=len(steps), decode_step_ms_median=step_ms,
             decode_tokens_per_s=decode_tokens / decode_s,
             weight_gb=weight_bytes / 1e9, decode_bound_ms=bound_ms)
    print(f"{VLM_ARCH} served {len(vlens)} text requests ({sum(vlens)} prompt "
          f"tokens, {VLM_MAX_NEW} new each) in {wall:.3f} s through "
          f"{VLM_SLOTS} slots: {counts['flash_attention']} flash launches "
          f"({geo}), {counts['flash_attention_ffma']} FFMA, "
          f"{len(plain_calls)} plain calls [{card}]")
    print(f"prefill: {sum(vlens)} tokens in {prefill_s:.3f} s = "
          f"{v['prefill_tokens_per_s']:.1f} tokens/s; at the longest prompt "
          f"({longest[0]} tokens) TTFT {longest[1]:.3f} ms; decode: "
          f"{len(steps)} engine steps, median {step_ms:.3f} ms a step at "
          f"{VLM_SLOTS} slots ({len(full)} such steps), "
          f"{v['decode_tokens_per_s']:.1f} tokens/s; HBM bound of a step "
          f"{bound_ms:.3f} ms ({(weight_bytes - unread) / 1e9:.2f} GB of "
          f"weights read, the gathered embedding and img_proj left out; "
          f"{weight_bytes / 1e9:.2f} GB in all: "
          f"{weight_bytes / PEAK_HBM_BYTES * 1e3:.3f} ms) [{card}]")
    if on_card:
        v["serve_peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    lap("internvl2 text serving")

    # -- image-prefixed prefills and greedy decode steps -------------------
    n_img, img_max, n_dec = image
    ilens = torch.randint(vcfg.img_tokens + 1, img_max + 1, (n_img,),
                          generator=vgen).tolist()
    images = [torch.randn((1, vcfg.img_tokens, vcfg.frontend_dim),
                          generator=vgen) for _ in ilens]
    itoks = [torch.randint(0, vcfg.vocab, (1, n), generator=vgen)
             for n in ilens]

    def image_prefill(p, toks, img, c=vcfg, flags=tr.RunFlags()):
        batch = {"tokens": toks}
        if img is not None:
            batch["img_embeds"] = img
        return tr.forward(p, batch, c, mode="prefill", flags=flags,
                          last_logit_only=True)
    irows = []
    reset_flash_counts(wrappers)
    with counting_plain_attention(plain_calls), torch.no_grad():
        for toks, img in zip(itoks, images):
            toks, img = toks.to(dev), img.to(dev)
            s = toks.shape[1]
            sync()
            t0 = time.perf_counter()
            lg, pcache = image_prefill(params, toks, img)
            nxt = torch.argmax(lg[:, -1].float(), dim=-1)[:, None]
            first = int(nxt[0, 0])
            ttft_ms = (time.perf_counter() - t0) * 1e3
            cache = tr.init_cache(vcfg, 1, s + n_dec + 8, device=dev)
            _merge_slot_cache(cache, pcache, 0, s)
            del pcache
            gen_toks, t1 = [first], time.perf_counter()
            for i in range(n_dec):
                lg, cache = tr.decode_step(params, cache, nxt, torch.tensor(
                    [s + i], device=dev), vcfg)
                nxt = torch.argmax(lg.float(), dim=-1)[:, None]
                gen_toks.append(int(nxt[0, 0]))
            dec_ms = (time.perf_counter() - t1) * 1e3 / n_dec
            del cache
            check(all(0 <= x < vcfg.vocab for x in gen_toks),
                  f"{VLM_ARCH} image-prefixed request: tokens {gen_toks}")
            irows.append(dict(prompt=s, ttft_ms=ttft_ms,
                              decode_step_ms=dec_ms))
    counts, geo = read_flash_counts(wrappers)
    check_flash_path(on_card, counts, geo, plain_calls, vcfg.n_layers * n_img, vlm_key,
               f"{VLM_ARCH} image-prefixed prefills")
    v.update(image_requests=irows, image_launches=counts["flash_attention"])
    for r in irows:
        print(f"  image-prefixed prompt of {r['prompt']} tokens "
              f"({vcfg.img_tokens} of them the image): TTFT "
              f"{r['ttft_ms']:.3f} ms, then {n_dec} greedy decode steps at "
              f"{r['decode_step_ms']:.3f} ms a step (batch 1) [{card}]")
    lap("internvl2 image serving")

    # -- the gates: each launch of an image-prefixed prefill, the logits -----
    gtoks = torch.randint(0, vcfg.vocab, (1, gate_s), generator=vgen).to(dev)
    gimg = torch.randn((1, vcfg.img_tokens, vcfg.frontend_dim),
                       generator=vgen).to(dev)
    calls = []
    with attend_as(dev, recording(kernel, calls)), torch.no_grad():
        image_prefill(params, gtoks, gimg)
    v["flash_on_model_inputs"] = regime_forward(
        calls, f"{VLM_ARCH} {gate_s}-token prefill with its image (B=1 "
        f"S={gate_s} H={vcfg.n_heads} hd={hd_v})",
        plain_tiles=ENC_VLM_PLAIN_TILES)
    del calls

    def vlm_runs(img):
        runs = {}
        with torch.no_grad():
            for impl in ("flash", "naive"):
                runs[impl] = image_prefill(params, gtoks, img,
                                           flags=tr.RunFlags(
                                               attn_impl=impl))[0]
            with attend_as(dev, plain_over(ENC_VLM_PLAIN_TILES)):
                runs["plain"] = image_prefill(params, gtoks, img)[0]
        return runs
    v["logits_rel_err"] = {}
    # conditioned only: the readings at the reference's init (0.12-0.16
    # in PR 29, not gated) were cut for the script's time in PR 30
    for regime in ("conditioned",):
        condition(params, vcfg.d_model)
        with_img, text = vlm_runs(gimg), vlm_runs(None)
        rels = {}
        for what, runs in (("image", with_img), ("text", text)):
            for a, b in (("flash", "plain"), ("flash", "naive"),
                         ("plain", "naive")):
                rels[f"{what}, {a} vs {b}"] = [live_rel(runs[a], runs[b],
                                                        vcfg)]
        rels["image dropped vs image, plain"] = [live_rel(
            text["plain"], with_img["plain"], vcfg)]
        del with_img, text
        gate(f"{VLM_ARCH} {gate_s}-token prefill, {regime}", rels,
             ENC_VLM_LOGITS_TOL, ("image dropped vs image, plain",),
             read_keys=tuple(k for k in rels if "plain vs naive" in k))
        v["logits_rel_err"][regime] = rels
        free()
    del params
    free()
    lap("internvl2 gates")
    v["launch"] = launch_row(f"{VLM_ARCH} longest prompt", 1, max(vlens),
                             vcfg.n_heads, hd_v, torch.bfloat16, True)

    # -- the f32 check, then training with the depth cut ------------------
    l32, s32 = vlm_f32
    c32 = dataclasses.replace(vcfg, n_layers=l32, dtype="float32")
    p32, _, _ = draw(c32, VLM_ARCH, seed=1)
    reset_flash_counts(wrappers)
    with torch.no_grad():
        flash32 = image_prefill(p32, gtoks[:, :s32], gimg, c32)[0]
        sync()
        counts32, geo32 = read_flash_counts(wrappers)
        check_flash_path(on_card, counts32, geo32, [], l32, vlm_f32_key, f"{VLM_ARCH} f32")
        naive32 = image_prefill(p32, gtoks[:, :s32], gimg, c32,
                                tr.RunFlags(attn_impl="naive"))[0]
    rel = live_rel(flash32, naive32, c32)
    del p32, flash32, naive32
    free()
    gate(f"{VLM_ARCH} f32, {l32} layers, a {s32}-token prompt with its "
         f"image (the FFMA kernel's f32 {hd_v}/{hd_v} instance: "
         f"{geo32.get(vlm_f32_key, 0)} launches), flash vs naive",
         {"reference init": [rel]}, ENC_VLM_F32_TOL, ())
    v.update(f32_logits_rel_err=rel, launches_f32=geo32.get(vlm_f32_key, 0))
    lap("internvl2 f32 check")
    layers, b_, s_ = vlm_train
    ct = dataclasses.replace(vcfg, n_layers=layers)
    t, grads_of = train_llm(ct, dev, card, wrappers,
                            f"at full width with {layers} of its "
                            f"{vcfg.n_layers} layers and the image prefix",
                            vlm_key, 2 * layers, (b_, s_), VLM_TRAIN_TIMED)
    grad_gate(t, f"{VLM_ARCH} ({layers} layers)", grads_of)
    del grads_of
    free()
    v["train"] = t
    lap("internvl2 training")

    out["launches_80"] = h["launches"] + h["long_launches"] \
        + h["train"]["launches"]
    out["launches_80_f32"] = h["launches_f32"]
    out["launches_128"] = v["launches"] + v["image_launches"] \
        + v["train"]["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    out["sub_phase_s"] = laps
    print(f"encoder_vlm phase: {out['seconds']:.1f} s (" + ", ".join(
        f"{k} {x:.1f}" for k, x in laps.items()) + ")")
    check(not failed, "; ".join(failed))
    return out


# -- Qwen1.5-32B: served at full width, decoded from an int8 cache ------------

# Qwen1.5-32B (src/repro/configs/qwen15_32b.py), not reduced: 64 layers of
# 40 heads of 128 (MHA, QKV bias; the wgmma kernel's bf16 (128, 128)
# instance), d_ff 27,392, vocab 152,064: 70.39 GB of bf16 weights of the
# card's 80.  Served through DecodeEngine.run (the reference's engine,
# bf16 cache): QWEN_REQUESTS prompts of lengths drawn from seed 0 in
# QWEN_PROMPT_LENS, QWEN_MAX_NEW new tokens each, on as many slots of
# max(QWEN_MIN_LEN, longest + new) rows as keep the peak under
# QWEN_MEMORY_SHARE of the card (at least 2): reckoned from the peak of
# one prefill of the longest prompt, measured first.  The QKV biases,
# zeros at the reference's init, get a seeded draw of std QWEN_BIAS_STD
# first, so that their path runs on values a trained model has.
QWEN_ARCH, QWEN_PARAMS = "qwen1.5-32b", 35_197_096_960
QWEN_REQUESTS = 8
QWEN_PROMPT_LENS = (128, 2048)
QWEN_MAX_NEW = 32
QWEN_MIN_SLOTS, QWEN_MIN_LEN = 2, 2080
QWEN_MEMORY_SHARE = 0.95
QWEN_BIAS_STD = 0.5
# the card must hold less than this when the phase starts
QWEN_EMPTY_BYTES = 1e9
# the gates' prompt: every launch of its prefill against the plain version
# (elementwise at FLASH_TOL) and float64 (REGIME_F64_RATIO), a dropped
# diagonal tile above both; its logits on conditioned weights, flash
# against the plain version's path, at QWEN_LOGITS_TOL (the conditioned
# gate of the other bf16 models), the QKV bias dropped above it
QWEN_GATE_S = 1024
QWEN_LOGITS_TOL = 3e-2
# Decode from an int8 cache through decode_step: QWEN_INT8 (slots, rows),
# each slot filled by a bf16 prefill of a prompt drawn in (rows / 2, rows
# - steps], its k/v quantized by quantize_kv and its bf16 cache freed
# before the next; QWEN_INT8_STEPS greedy steps timed.  The gates:
#  (a) every dequantized entry p of a prefill against the bf16 value x it
#      came from: |p - x| <= s (1/2 + 2^-17) + |c| s (2^-7 + 2^-16), c
#      the code and s the token's f32 scale.  The first term is the
#      rounding to the nearest code (half a step, and the f32 division
#      x / s off by at most 127 2^-24 < 2^-17 of a step); the second the
#      dequantization in bf16 (8 significant bits, a relative rounding of
#      at most 2^-8): the scale rounded to bf16, the product rounded to
#      bf16, and their product term (2^-16).
#  (b) on conditioned weights, the logits of QWEN_INT8_STEPS steps with a
#      fixed token stream of the first QWEN_INT8_BF16_SLOTS slots of the
#      int8 cache against the same steps from a bf16 cache of those slots
#      (filled by the same prefills; the two caches never resident
#      together; both runs at the same batch, so that they differ in the
#      cache alone), per step ||a - b|| / ||b|| over the live vocab at
#      QWEN_INT8_TOL, the conditioned gate of the bf16 models;
#  (c) the planted faults of INT8_FAULTS, each above gate (a); the scales
#      ignored above gate (b) too.  The scale of the token before is read
#      at (b), not gated: at full width a token's scale is the max over
#      its 5120 values beside a fixed QKV bias, so it moves by a few
#      percent from one token to the next, and that fault moved the 64
#      layers' logits 1.18 times as far as the int8 rounding itself
#      (1.893e-2 against 1.600e-2; on an H100, the CPU rehearsals at 4-32
#      layers 1024-5120 wide read 2.3-6.5 times).  The decode path's use
#      of the scales is held to the reference's, codes and scales,
#      in tests/test_torch_kv_decode.py.
QWEN_INT8 = (4, 2048)
QWEN_INT8_STEPS = 16
QWEN_INT8_BF16_SLOTS = 2
QWEN_INT8_TOL = 3e-2
INT8_FAULTS = ("scales ignored", "scale of the token before")
# the faults gated at (b): above QWEN_INT8_TOL
INT8_LOGITS_FAULTS = ("scales ignored",)
# the ranges of a decode step's profile
QWEN_RANGES = ("qwen.decode_attention", "qwen.dequantize_kv")


def int8_fault(fault: str):
    """``dequantize_kv`` with a fault planted: the codes taken as values
    (the scales ignored), or each token's codes times the scale of the
    token before it (the first token keeps its own)."""
    from repro_torch.models.attention import dequantize_kv

    def faulty(codes, scales, dtype):
        if fault == "scales ignored":
            return codes.to(dtype)
        before = torch.cat([scales[:, :1], scales[:, :-1]], dim=1)
        return dequantize_kv(codes, before, dtype)
    check(fault in INT8_FAULTS, f"no planted int8 fault '{fault}'")
    return faulty


def int8_bound(codes, scales) -> torch.Tensor:
    """The element gate's bound on |dequantized - bf16| (QWEN_INT8 (a))."""
    s = scales.float()
    return s * (0.5 + 2 ** -17) + codes.float().abs() * s * (2 ** -7
                                                             + 2 ** -16)


def held_on_card(dev) -> int:
    """The bytes of live tensors on the card, after a garbage collection
    (reference cycles of earlier phases) and with cuBLAS's workspaces
    released (it keeps one, through the caching allocator, for every
    handle and stream it has run on: the engines' threads' among them)."""
    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(dev)


def largest_tensors(n: int = 8) -> list:
    """(bytes, shape, dtype) of the ``n`` largest live CUDA tensors."""
    found = []
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            found.append((o.numel() * o.element_size(), tuple(o.shape),
                          str(o.dtype)))
    return sorted(found, reverse=True)[:n]


def qwen_phase(card, dev, wrappers, *, cfg=None,
               requests: int = QWEN_REQUESTS,
               prompt_lens: tuple[int, int] = QWEN_PROMPT_LENS,
               min_len: int = QWEN_MIN_LEN, gate_s: int = QWEN_GATE_S,
               int8: tuple[int, int] = QWEN_INT8,
               steps: int = QWEN_INT8_STEPS,
               roofline: dict | None = None) -> dict:
    """Full-width Qwen1.5-32B (``cfg``, default the registered config),
    random bf16 weights from seed 0 with the QKV biases drawn: served
    through ``DecodeEngine.run`` on a bf16 cache sized to the card (every
    counter at 0 just before, read just after: one launch of the wgmma
    kernel's bf16 (128, 128) instance a layer a prefill, none of the FFMA
    kernel, no plain call), TTFT, prefill and decode rates beside the
    decode step's HBM bound, peak memory; each launch of a prefill
    against its plain version and float64 (``launch_gate``, a dropped
    diagonal tile above it); then decode from an int8 cache of
    ``int8`` (slots, rows) through ``decode_step``: the element gate on
    every entry of every prefill, ``steps`` greedy steps timed beside
    the HBM bound of the weights and the int8 cache, peak memory in int8
    and in bf16; then on conditioned weights the logits gates: the served
    path against its plain version's (the QKV bias dropped above it), the
    int8 cache's steps against a bf16 cache's (the scales ignored above
    it); profiles of a decode step from each cache; one launch timed at the longest prompt beside its plain
    version, SDPA and the bound.  On the card the longest prompt's
    prefill and the int8 decode step are profiled and added to
    ``roofline`` for the roofline phase.  The keywords shrink it for a
    rehearsal on the CPU (the kernel's plain version, no counts, no
    times)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_ffma,
                                                     flash_attention_plain,
                                                     flash_attention_wgmma)
    from repro_torch.models import attention
    from repro_torch.models import transformer as tr
    from repro_torch.serve.engine import EngineConfig, _merge_slot_cache
    from repro_torch.train.checkpoint import (tree_items, tree_leaves,
                                              tree_map)
    on_card = dev.type == "cuda"
    full_width = cfg is None
    cfg = cfg or get_config(QWEN_ARCH)
    hd = cfg.resolved_head_dim
    key = (torch.bfloat16, hd, hd)
    kernel = flash_attention_cuda if on_card else flash_attention_plain
    t_phase = time.perf_counter()
    out: dict = {}
    laps: dict = {}
    t_lap = [t_phase]
    failed: list = []

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now
        print(f"  [{name}: {laps[name]:.1f} s]")

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def peak_gb():
        return torch.cuda.max_memory_allocated(dev) / 1e9 if on_card \
            else None

    def reset_peak():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def live(x):
        return x[..., :cfg.vocab]

    # -- the weights, on an empty card --------------------------------------
    if on_card:
        held = held_on_card(dev)
        print(f"{QWEN_ARCH}: the card holds {held / 1e9:.3f} GB when the "
              f"phase starts (must be under {QWEN_EMPTY_BYTES / 1e9:g} GB)")
        check(held < QWEN_EMPTY_BYTES, f"{QWEN_ARCH}: {held} bytes already "
              f"allocated on the card; the largest live tensors (bytes, "
              f"shape, dtype): {largest_tensors()}")
        reset_peak()
    t0 = time.perf_counter()
    params = tr.init(cfg, torch.Generator(dev).manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == tr.count_params(cfg)
          and (not full_width or n_params == QWEN_PARAMS),
          f"{QWEN_ARCH}: {n_params} parameters drawn, "
          f"{tr.count_params(cfg)} counted, {QWEN_PARAMS} expected")
    bias_gen = torch.Generator(dev).manual_seed(1)
    with torch.no_grad():
        for path, t in tree_items(params).items():
            if path.rsplit("::", 1)[-1] in ("bq", "bk", "bv"):
                t.normal_(0.0, QWEN_BIAS_STD, generator=bias_gen)
    sync()
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    embed_bytes = params["embed"].numel() * params["embed"].element_size()
    per_token = 2 * cfg.n_layers * cfg.n_kv_heads * hd * 2
    print(f"{QWEN_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} kv heads of {hd} "
          f"(QKV bias, drawn at std {QWEN_BIAS_STD:g}), d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}: {n_params:,} parameters, "
          f"{weight_bytes / 1e9:.2f} GB in {cfg.dtype}, drawn in "
          f"{time.perf_counter() - t0:.1f} s; a token's bf16 cache "
          f"{per_token:,} bytes")
    out.update(params=n_params, weight_gb=weight_bytes / 1e9)
    lap("qwen weights")

    # -- serving through DecodeEngine.run, the cache sized to the card ------
    gen = torch.Generator().manual_seed(0)
    lens = torch.randint(prompt_lens[0], prompt_lens[1] + 1, (requests,),
                         generator=gen).tolist()
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist()
               for n in lens]
    max_len = max(min_len, max(lens) + QWEN_MAX_NEW)
    longest = torch.tensor([prompts[lens.index(max(lens))]], device=dev)
    reset_peak()

    def prefill_longest(p, batch):
        with torch.no_grad():
            return tr.forward(p, batch, cfg, mode="prefill")
    if on_card:
        # profiled: the roofline phase reads this prefill
        reading = StepReading(dev, (params, longest))
        prof = profile(lambda: prefill_longest(params, {"tokens": longest}),
                       1, f"{QWEN_ARCH} prefills of {longest.shape[1]} "
                       f"tokens", (), flops=True, warmup=False,
                       before=reading.start)
        if roofline is not None:
            roofline[f"{QWEN_ARCH} prefill ({longest.shape[1]} tokens)"] = \
                dict(fn=prefill_longest,
                     args=(to_meta(params), to_meta({"tokens": longest})),
                     measured=reading.stop(prof))
    else:
        prefill_longest(params, {"tokens": longest})
    sync()
    if on_card:
        total = torch.cuda.get_device_properties(dev).total_memory
        prefill_peak = torch.cuda.max_memory_allocated(dev)
        slots = min(requests, int((QWEN_MEMORY_SHARE * total - prefill_peak)
                                  // (max_len * per_token)))
        print(f"{QWEN_ARCH}: a prefill of the longest prompt ({max(lens)} "
              f"tokens) peaks at {prefill_peak / 1e9:.2f} GB of the card's "
              f"{total / 1e9:.2f}; {QWEN_MEMORY_SHARE:.0%} leaves room for "
              f"{slots} slots of {max_len} rows "
              f"({max_len * per_token / 1e9:.2f} GB a slot in bf16)")
        check(slots >= QWEN_MIN_SLOTS, f"{QWEN_ARCH}: room for {slots} "
              f"slots, {QWEN_MIN_SLOTS} needed")
    else:
        slots = QWEN_MIN_SLOTS
    ecfg = EngineConfig(n_slots=slots, max_len=max_len,
                        max_new=QWEN_MAX_NEW, temperature=0.0)
    plain_calls: list = []
    geo = flash_attention_wgmma.launches_by_geometry
    geo.clear()
    flash_attention_ffma.launches_by_geometry.clear()
    reset_peak()
    with counting_plain_attention(plain_calls):
        reqs, admits, dsteps, wall, counts = serve_requests(
            cfg, params, ecfg, prompts, "flash", wrappers, dev)
    want = cfg.n_layers * requests
    if on_card:
        check(counts["flash_attention"] == counts["flash_attention_wgmma"]
              == geo.get(key) == want and sum(geo.values()) == want
              and counts["flash_attention_ffma"] == 0
              and not flash_attention_ffma.launches_by_geometry
              and all(c == 0 for k, c in counts.items()
                      if k not in ("flash_attention",
                                   "flash_attention_wgmma")),
              f"{QWEN_ARCH} serving: {counts}, {dict(geo)}: {want} launches "
              f"of the {key} instance through the wgmma kernel expected")
        check(not plain_calls, f"{QWEN_ARCH} serving called the plain "
              f"version {len(plain_calls)} times on the card")
    for r in reqs:
        check(r.done and len(r.generated) == QWEN_MAX_NEW
              and all(0 <= x < cfg.vocab for x in r.generated),
              f"{QWEN_ARCH} request {r.rid}: done {r.done}, "
              f"{len(r.generated)} tokens")
    serve_peak = peak_gb()
    prefill_s = sum(d for _, d in admits.values())
    decode_s = sum(d for d, _ in dsteps)
    decode_tokens = sum(n for _, n in dsteps)
    step_ms = statistics.median(d * 1e3 for d, _ in dsteps)
    ttft = sorted((len(r.prompt), sum(admits[r.rid]) * 1e3,
                   admits[r.rid][1] * 1e3) for r in reqs)
    bound_ms = (weight_bytes - embed_bytes) / PEAK_HBM_BYTES * 1e3
    out.update(prompt_lens=lens, slots=slots, max_len=max_len, wall_s=wall,
               launches=counts["flash_attention"],
               launches_by_geometry={str(k): n for k, n in geo.items()},
               requests=[dict(prompt=n, ttft_ms=t_, prefill_ms=pre)
                         for n, t_, pre in ttft],
               ttft_ms_longest=ttft[-1][1],
               prefill_tokens_per_s=sum(lens) / prefill_s,
               decode_steps=len(dsteps), decode_step_ms_median=step_ms,
               decode_tokens_per_s=decode_tokens / decode_s,
               decode_bound_ms=bound_ms, serve_peak_memory_gb=serve_peak)
    print(f"{QWEN_ARCH} served {requests} requests ({sum(lens)} prompt "
          f"tokens, {QWEN_MAX_NEW} new each) in {wall:.3f} s through "
          f"{slots} slots of {max_len} rows: {counts['flash_attention']} "
          f"flash launches ({dict(geo)}), {counts['flash_attention_ffma']} "
          f"FFMA, {len(plain_calls)} plain calls [{card}]")
    for n, t_, pre in ttft:
        print(f"  prompt {n:4d} tokens: prefill {pre:9.3f} ms, TTFT "
              f"{t_:9.3f} ms")
    print(f"prefill: {sum(lens)} tokens in {prefill_s:.3f} s = "
          f"{out['prefill_tokens_per_s']:.1f} tokens/s; decode: "
          f"{len(dsteps)} engine steps, median {step_ms:.3f} ms a step, "
          f"{out['decode_tokens_per_s']:.1f} tokens/s; HBM bound of a step "
          f"{bound_ms:.3f} ms (the weights less the gathered embedding); "
          f"peak device memory {serve_peak or 0:.2f} GB [{card}]")
    if on_card:
        check(serve_peak * 1e9 < QWEN_MEMORY_SHARE * total,
              f"{QWEN_ARCH} serving peaked at {serve_peak:.2f} GB")
    lap("qwen serving")

    # -- every launch of a prefill against its plain version and float64 -----
    gtoks = torch.randint(0, cfg.vocab, (1, gate_s), generator=gen).to(dev)
    calls: list = []
    with attend_as(dev, recording(kernel, calls)), torch.no_grad():
        tr.forward(params, {"tokens": gtoks}, cfg, mode="prefill",
                   last_logit_only=True)
    gate = launch_gate(calls, f"{QWEN_ARCH} {gate_s}-token prefill (B=1 "
                       f"S={gate_s} H={cfg.n_heads} hd={hd})",
                       ENC_VLM_PLAIN_TILES, fault="diagonal tile dropped")
    failed += gate.pop("failed")
    out["flash_on_model_inputs"] = gate
    del calls
    lap("qwen launch gate")

    # -- decode from an int8 cache -------------------------------------------
    n_slots, rows = int8
    ilens = torch.randint(rows // 2 + 1, rows - steps + 1, (n_slots,),
                          generator=gen).tolist()
    iprompts = [torch.randint(0, cfg.vocab, (1, n), generator=gen)
                for n in ilens]
    dtoks = torch.randint(0, cfg.vocab, (steps, n_slots, 1),
                          generator=gen).to(dev)

    def fill(cache, slots_, gated=False):
        """Prefill ``slots_`` of ``cache`` one at a time (an int8 cache
        gets the k/v quantized layer by layer); with ``gated``, the
        element gate and its faults on every entry.  Returns the worst
        use of the bound, and the faults' on the first prefill."""
        used, faults = 0.0, {f: 0.0 for f in INT8_FAULTS}
        for slot in range(slots_):
            toks = iprompts[slot].to(dev)
            s = toks.shape[1]
            with torch.no_grad():
                _, pcache = tr.forward(params, {"tokens": toks}, cfg,
                                       mode="prefill", last_logit_only=True)
            for si, seg in pcache.items():
                for pos, blk in seg.items():
                    c, p = cache[si][pos]["attn"], blk["attn"]
                    if "k_s" not in c:
                        _merge_slot_cache(c, p, slot, s)
                        continue
                    for name in ("k", "v"):
                        for li in range(p[name].shape[0]):
                            x = p[name][li, 0]
                            codes, scales = attention.quantize_kv(x)
                            c[name][li, slot, :s] = codes
                            c[f"{name}_s"][li, slot, :s] = scales
                            if not gated:
                                continue
                            bound = int8_bound(codes, scales)
                            deq = attention.dequantize_kv(codes, scales,
                                                          x.dtype)
                            used = max(used, ((deq.float() - x.float()).abs()
                                              / bound).max().item())
                            for f in INT8_FAULTS if slot == 0 else ():
                                bad = int8_fault(f)(codes[None],
                                                    scales[None], x.dtype)
                                faults[f] = max(faults[f], (
                                    (bad[0].float() - x.float()).abs()
                                    / bound).max().item())
            del pcache
        return used, faults

    def decode(cache, slots_, greedy=False):
        """``steps`` steps of ``slots_`` slots from their prompts' ends:
        the fixed token stream, or greedy from the prefills' tokens.
        Returns each step's live logits (host) and ms."""
        lengths = torch.tensor(ilens[:slots_], device=dev)
        tok = dtoks[0, :slots_]
        logits, ms = [], []
        with torch.no_grad():
            for i in range(steps):
                sync()
                t0 = time.perf_counter()
                lg, cache = tr.decode_step(params, cache, tok, lengths + i,
                                           cfg)
                nxt = torch.argmax(lg.float(), dim=-1)[:, None]
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                logits.append(live(lg).float().cpu())
                tok = nxt if greedy else dtoks[(i + 1) % steps, :slots_]
        return torch.stack(logits), ms

    reset_peak()
    cache8 = tr.init_cache(cfg, n_slots, rows, kv_dtype="int8", device=dev)
    int8_bytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(cache8))
    used, faults = fill(cache8, n_slots, gated=True)
    print(f"{QWEN_ARCH} int8 cache of {n_slots} slots x {rows} rows "
          f"({int8_bytes / 1e9:.2f} GB; in bf16 {n_slots * rows * per_token / 1e9:.2f} GB), "
          f"filled by bf16 prefills of {ilens} tokens: every dequantized "
          f"entry within {used:.4f} of its bound |p - x| <= s (1/2 + "
          f"2^-17) + |c| s (2^-7 + 2^-16) (gate 1); on the first prefill "
          + ", ".join(f"{f}: {v:.1f}" for f, v in faults.items())
          + " of it (each must exceed 1)")
    if used > 1:
        failed.append(f"{QWEN_ARCH} int8 element gate at {used}")
    for f, v in faults.items():
        if not v > 1:
            failed.append(f"{QWEN_ARCH} int8 element gate cannot tell {f}")
    _, ms8 = decode(cache8, n_slots, greedy=True)
    int8_peak = peak_gb()
    lengths8 = torch.tensor(ilens, device=dev) + steps

    def one_step(cache, n):
        with torch.no_grad():
            tr.decode_step(params, cache, dtoks[0, :n], lengths8[:n], cfg)
    if on_card:
        reading = StepReading(dev, (params, cache8))
        with annotated(attention, "decode_attention", QWEN_RANGES[0]), \
                annotated(attention, "dequantize_kv", QWEN_RANGES[1]):
            out["int8_profile"] = profile(
                lambda: one_step(cache8, n_slots), 1,
                f"{QWEN_ARCH} decode steps of {n_slots} slots from the "
                f"int8 cache", QWEN_RANGES, flops=True,
                before=reading.start)
        if roofline is not None:
            def decode_step(p, cache, tokens, lengths):
                with torch.no_grad():
                    return tr.decode_step(p, cache, tokens, lengths, cfg)
            roofline[f"{QWEN_ARCH} decode step ({n_slots} slots of the "
                     f"int8 cache of {rows} rows)"] = dict(
                fn=decode_step, args=(to_meta(params), to_meta(cache8),
                                      to_meta(dtoks[0, :n_slots]),
                                      to_meta(lengths8[:n_slots])),
                measured=reading.stop(out["int8_profile"]))
    step8 = statistics.median(ms8)
    bound8 = (weight_bytes - embed_bytes + int8_bytes) / PEAK_HBM_BYTES * 1e3
    print(f"{QWEN_ARCH} decode from the int8 cache: {steps} greedy steps "
          f"of {n_slots} slots, median {step8:.3f} ms a step "
          f"({', '.join(f'{x:.1f}' for x in ms8)}); HBM bound {bound8:.3f} "
          f"ms (the weights less the embedding, and the int8 cache read "
          f"once); peak device memory {int8_peak or 0:.2f} GB; a bf16 "
          f"cache of the same rows would need "
          f"{n_slots * rows * per_token / 1e9:.2f} GB beside the weights "
          f"[{card}]")
    out["int8"] = dict(slots=n_slots, rows=rows, prompt_lens=ilens,
                       cache_gb=int8_bytes / 1e9,
                       bf16_cache_gb=n_slots * rows * per_token / 1e9,
                       element_gate_used=used, element_faults=faults,
                       step_ms=ms8, step_ms_median=step8, bound_ms=bound8,
                       peak_memory_gb=int8_peak)
    lap("qwen int8 decode")

    # -- on conditioned weights: the logits gates ------------------------------
    condition(params, cfg.d_model)
    rels: dict = {}
    with torch.no_grad():
        def prefill_logits(c=cfg):
            return live(tr.forward(params, {"tokens": gtoks[:, :gate_s]}, c,
                                   mode="prefill")[0])
        flash_lg = prefill_logits()
        with attend_as(dev, plain_over(ENC_VLM_PLAIN_TILES)):
            plain_lg = prefill_logits()
            rels["flash vs plain"] = rel_norm(flash_lg, plain_lg)
            del flash_lg
            rels["QKV bias dropped vs plain"] = rel_norm(
                prefill_logits(dataclasses.replace(cfg, qkv_bias=False)),
                plain_lg)
    del plain_lg
    for what, rel in rels.items():
        fault = what.startswith("QKV")
        print(f"{QWEN_ARCH} {gate_s}-token prefill on conditioned weights, "
              f"{what}: logits ||a-b||/||b|| {rel:.3e} ("
              + (f"must exceed {QWEN_LOGITS_TOL:g})" if fault
                 else f"tolerance {QWEN_LOGITS_TOL:g})"))
        if fault != (rel > QWEN_LOGITS_TOL):
            failed.append(f"{QWEN_ARCH} logits gate, {what}: {rel:.3e}")
    out["logits_rel_err"] = rels
    fill(cache8, n_slots)
    # the int8 steps at the bf16 run's batch (its first slots, views into
    # the cache), so that the two runs differ in the cache alone
    first = tree_map(lambda t: t[:, :QWEN_INT8_BF16_SLOTS], cache8)
    runs = {"int8": decode(first, QWEN_INT8_BF16_SLOTS)[0]}
    for f in INT8_FAULTS:
        with swapped(attention, "dequantize_kv", int8_fault(f)):
            runs[f] = decode(first, QWEN_INT8_BF16_SLOTS)[0]
    del cache8, first
    reset_peak()
    cache16 = tr.init_cache(cfg, QWEN_INT8_BF16_SLOTS, rows, device=dev)
    fill(cache16, QWEN_INT8_BF16_SLOTS)
    ref16, _ = decode(cache16, QWEN_INT8_BF16_SLOTS)
    bf16_peak = peak_gb()
    if on_card:
        with annotated(attention, "decode_attention", QWEN_RANGES[0]):
            out["bf16_profile"] = profile(
                lambda: one_step(cache16, QWEN_INT8_BF16_SLOTS), 1,
                f"{QWEN_ARCH} decode steps of {QWEN_INT8_BF16_SLOTS} "
                f"slots from a bf16 cache", QWEN_RANGES)
    del cache16
    int8_rels = {what: [rel_norm(a[i], ref16[i]) for i in range(steps)]
                 for what, a in runs.items()}
    worst8 = max(int8_rels["int8"])
    for what, r in int8_rels.items():
        fault = what in INT8_LOGITS_FAULTS
        kind = (f"must exceed {QWEN_INT8_TOL:g}" if fault else
                "read, not gated" if what in INT8_FAULTS else
                f"tolerance {QWEN_INT8_TOL:g}")
        print(f"{QWEN_ARCH} {steps} decode steps on conditioned weights, "
              f"the int8 cache{'' if what == 'int8' else f' with {what}'} "
              f"vs a bf16 cache of {QWEN_INT8_BF16_SLOTS} of its slots: "
              f"logits ||a-b||/||b|| worst {max(r):.3e} (step 0 "
              f"{r[0]:.3e}; {max(r) / worst8:.2f} times the int8 path's; "
              f"{kind})")
        if what in INT8_FAULTS and not fault:
            continue
        if fault != (max(r) > QWEN_INT8_TOL):
            failed.append(f"{QWEN_ARCH} int8 logits gate, {what}: "
                          f"{max(r):.3e}")
    print(f"{QWEN_ARCH} peak device memory: int8 cache of {n_slots} x "
          f"{rows} {int8_peak or 0:.2f} GB; bf16 cache of "
          f"{QWEN_INT8_BF16_SLOTS} x {rows} {bf16_peak or 0:.2f} GB; a bf16 "
          f"cache of {n_slots} x {rows} would add "
          f"{n_slots * rows * per_token / 1e9:.2f} GB to "
          f"{weight_bytes / 1e9:.2f} GB of weights [{card}]")
    out["int8"].update(logits_rel_err=int8_rels, bf16_peak_memory_gb=bf16_peak)
    del params
    if on_card:
        torch.cuda.empty_cache()
    lap("qwen gates")
    out["launch"] = split_launch_row(
        f"{QWEN_ARCH} longest prompt", 1, max(lens), cfg.n_heads, hd, hd,
        torch.bfloat16, dev, on_card)
    if on_card:
        row = out["launch"]
        print(f"flash_attention ({row['variant']} {hd}/{hd}) {QWEN_ARCH} "
              f"longest prompt at B=1 S={max(lens)} H={cfg.n_heads} causal "
              f"bf16: {row['ms']:.4f} ms a launch ({row['tflops']:.2f} "
              f"TFLOP/s), max_abs_err {row['max_abs_err']:.3e} vs plain; "
              f"plain {row['plain_ms']:.3f} ms, SDPA {row['library_ms']:.4f} "
              f"ms (backend {row['library_backend']}; kernel/SDPA "
              f"{row['ms'] / row['library_ms']:.2f}), bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}) [{card}]")
    lap("qwen launch row")
    out["seconds"] = time.perf_counter() - t_phase
    out["sub_phase_s"] = laps
    print(f"qwen phase: {out['seconds']:.1f} s (" + ", ".join(
        f"{k} {x:.1f}" for k, x in laps.items()) + ")")
    check(not failed, "; ".join(failed))
    return out


# -- the roofline: the dry-run's counts held against the card ---------------

# The roofline phase counts, on meta tensors (repro_torch/utils/opcount.py,
# the dry-run's counter), the steps that the llm_train and qwen phases ran
# at full width on the card (Gemma-7B's train step, Qwen1.5-32B's prefill
# of the longest prompt and its decode step from the int8 cache), and holds
# each count against the card's reading of the same step, taken around a
# profile those phases make anyway: the product ops' FLOPs (mm, addmm, bmm,
# baddbmm) against torch.profiler's with_flops FLOPs of the same ops, those
# that ran (``profile``), at ROOFLINE_FLOPS_TOL relative; the
# flash launches by kernel and (dtype, dk, dv) equal; the counted temp
# bytes (the peak of live storages less the arguments) over what the step
# allocated beyond what the card held as it began (max_memory_allocated
# less memory_allocated before the step) inside ROOFLINE_TEMP, and the
# counted peak (arguments + temp) over the step's peak less what the card
# held besides its arguments inside ROOFLINE_PEAK (on a serving step the
# arguments are nearly all of the peak: the temp gate is the one that reads
# the temp count); and the roofline bound of the counts at the H100's
# data-sheet rates (utils/roofline.py H100: no collectives on one card) at
# most ROOFLINE_SHARE of the device time the profiler measured for the step
# (a higher share means the counts exceed what the card did; a step the
# profiler saw no device time for fails).
ROOFLINE_FLOPS_TOL = 1e-6
ROOFLINE_TEMP = (0.9, 1.1)
ROOFLINE_PEAK = (0.8, 1.25)
ROOFLINE_SHARE = 1.05


def to_meta(tree):
    """A nested dict or tuple of tensors as ``meta`` tensors of the same
    shapes and dtypes (no data, nothing allocated)."""
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_meta(v) for v in tree)
    return tree.to("meta")


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages of a nested dict or tuple of
    tensors."""
    seen: dict = {}

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        else:
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    walk(tree)
    return sum(seen.values())


def flash_snapshot() -> dict:
    """``{"<kernel> <dtype>/<dk>/<dv>": launches}`` of both flash
    launchers' counts by geometry, as the dry-run's counts name them."""
    from repro_torch.kernels.flash_attention import (flash_attention_ffma,
                                                     flash_attention_wgmma)
    snap = {}
    for fn in (flash_attention_wgmma, flash_attention_ffma):
        for (dt, dk, dv), n in fn.launches_by_geometry.items():
            dtype = str(dt).removeprefix("torch.")
            snap[f"{fn.__name__} {dtype}/{dk}/{dv}"] = n
    return snap


class StepReading:
    """The card's reading of one profiled step for the roofline phase:
    ``start`` (a ``profile(..., before=)`` hook, after the warm-up) resets
    the peak and snapshots the flash counts; ``stop(prof)`` gives the
    step's temp bytes (``max_memory_allocated`` less what the card held
    as the step began) and peak (the same less what the card held beside
    the step's arguments ``args``), its flash launches by geometry, and
    the profile's product FLOPs and device ms a run."""

    def __init__(self, dev, args):
        self.dev = dev
        self.arg_bytes = storage_bytes(args)

    def start(self) -> None:
        torch.cuda.reset_peak_memory_stats(self.dev)
        self.held = torch.cuda.memory_allocated(self.dev)
        self.snap = flash_snapshot()

    def stop(self, prof: dict) -> dict:
        raw = torch.cuda.max_memory_allocated(self.dev)
        now = flash_snapshot()
        launches = {k: n - self.snap.get(k, 0) for k, n in now.items()
                    if n != self.snap.get(k, 0)}
        return dict(peak_bytes=raw - (self.held - self.arg_bytes),
                    temp_bytes=raw - self.held,
                    raw_peak_bytes=raw, held_bytes=self.held,
                    arg_bytes=self.arg_bytes, launches=launches,
                    dot_flops=prof.get("dot_flops_per_run"),
                    dot_flops_recorded=prof.get("dot_flops_recorded_per_run"),
                    device_ms=prof.get("device_ms_per_run"))


def roofline_phase(card: str, steps: dict) -> dict:
    """Count each step of ``steps`` (``{label: {"fn", "args" (meta
    tensors), "measured" (StepReading.stop)}}``) on meta and gate it
    against the card's reading (see ROOFLINE_*).  Prints a line a step
    and returns the counts and the readings."""
    from repro_torch.utils.opcount import count
    from repro_torch.utils.roofline import H100
    t_phase = time.perf_counter()
    out: dict = {"steps": {}}
    failed: list = []
    check(bool(steps), "the roofline phase has no step to count")
    for label, st in steps.items():
        m = st["measured"]
        check(bool(m["device_ms"]), f"the roofline phase, {label}: the "
              f"profiler saw no device time")
        rec = count(st["fn"], *st["args"])
        counted = {f"{k} {g}": n for k, r in rec.kernels.items()
                   for g, n in r["launches"].items()}
        dot = rec.op_flops()
        prof_flops = m["dot_flops"]
        flops_rel = abs(dot - prof_flops) / max(prof_flops, 1.0) \
            if prof_flops is not None else float("inf")
        temp_ratio = rec.memory["temp_bytes"] / m["temp_bytes"]
        peak_ratio = rec.memory["peak_bytes"] / m["peak_bytes"]
        compute_ms = rec.flops / H100.peak_flops * 1e3
        memory_ms = rec.bytes / H100.hbm_bw * 1e3
        bound_ms = max(compute_ms, memory_ms)
        measured_ms = m["device_ms"]
        share = bound_ms / measured_ms
        useful = sum(r["useful_flops"] for r in rec.kernels.values())
        row = dict(counted_dot_flops=dot, profiler_dot_flops=prof_flops,
                   flops_rel=flops_rel, flops=rec.flops, bytes=rec.bytes,
                   flash_flops=sum(r["flops"] for r in rec.kernels.values()),
                   flash_useful_flops=useful, launches_counted=counted,
                   launches_card=m["launches"], memory=rec.memory,
                   temp_ratio=temp_ratio, peak_ratio=peak_ratio,
                   compute_ms=compute_ms,
                   memory_ms=memory_ms, bound_ms=bound_ms,
                   bound_by="operations" if compute_ms >= memory_ms
                   else "bytes", measured_ms=measured_ms, share=share, count_s=rec.seconds, card=m)
        out["steps"][label] = row
        print(f"roofline, {label}: counted on meta in {rec.seconds:.1f} s "
              f"({len(rec.ops)} aten ops)")
        recorded = m["dot_flops_recorded"]
        print(f"  products' FLOPs: counted {dot:.6e}, torch.profiler "
              f"(with_flops, the ops that ran) "
              f"{prof_flops if prof_flops is None else f'{prof_flops:.6e}'}"
              f": relative gap {flops_rel:.3e} (gate {ROOFLINE_FLOPS_TOL:g}); "
              f"every recorded product op "
              f"{recorded if recorded is None else f'{recorded:.6e}'} (the "
              f"recomputes' early-stopped ops among them)")
        print(f"  flash launches: counted {counted or 'none'}, on the card "
              f"{m['launches'] or 'none'}; the kernel's counted work "
              f"{row['flash_flops']:.4e} FLOP (the mask's useful "
              f"{useful:.4e})")
        print(f"  temp: counted {rec.memory['temp_bytes'] / 1e9:.3f} GB, "
              f"the card {m['temp_bytes'] / 1e9:.3f} GB (max_memory_"
              f"allocated {m['raw_peak_bytes'] / 1e9:.3f} less "
              f"{m['held_bytes'] / 1e9:.3f} held as the step began): "
              f"ratio {temp_ratio:.4f} (gate {ROOFLINE_TEMP[0]:g}-"
              f"{ROOFLINE_TEMP[1]:g})")
        print(f"  peak: counted {rec.memory['peak_bytes'] / 1e9:.3f} GB "
              f"(arguments {rec.memory['argument_bytes'] / 1e9:.3f} + temp "
              f"{rec.memory['temp_bytes'] / 1e9:.3f}), the card "
              f"{m['peak_bytes'] / 1e9:.3f} GB (max_memory_allocated "
              f"{m['raw_peak_bytes'] / 1e9:.3f} less "
              f"{(m['held_bytes'] - m['arg_bytes']) / 1e9:.3f} held "
              f"beside the arguments): ratio {peak_ratio:.4f} (gate "
              f"{ROOFLINE_PEAK[0]:g}-{ROOFLINE_PEAK[1]:g})")
        print(f"  roofline of the counts at {H100.name} rates: compute "
              f"{compute_ms:.4f} ms ({rec.flops:.4e} FLOP), memory "
              f"{memory_ms:.4f} ms ({rec.bytes:.4e} B): bound "
              f"{bound_ms:.4f} ms ({row['bound_by']}); measured "
              f"{measured_ms:.4f} ms (device): share "
              f"{share:.4f} (at most {ROOFLINE_SHARE:g}) [{card}]")
        if not flops_rel <= ROOFLINE_FLOPS_TOL:
            failed.append(f"{label}: FLOPs {dot} counted, {prof_flops} "
                          f"profiled")
        if counted != m["launches"]:
            failed.append(f"{label}: flash launches {counted} counted, "
                          f"{m['launches']} on the card")
        if not ROOFLINE_TEMP[0] <= temp_ratio <= ROOFLINE_TEMP[1]:
            failed.append(f"{label}: temp ratio {temp_ratio:.4f}")
        if not ROOFLINE_PEAK[0] <= peak_ratio <= ROOFLINE_PEAK[1]:
            failed.append(f"{label}: peak ratio {peak_ratio:.4f}")
        if not share <= ROOFLINE_SHARE:
            failed.append(f"{label}: share of the bound {share:.4f}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"roofline phase: {out['seconds']:.1f} s")
    check(not failed, "; ".join(failed))
    return out


# -- the serving stack: GanEngine, programs, obs -----------------------------

# the engine phase: DCGAN at full width behind buckets ENGINE_BUCKETS, fed by
# ENGINE_PRODUCERS threads with ENGINE_REQUESTS requests whose sizes are
# drawn from seed 0, uniform on 1..100; then one producer sends ENGINE_SWEEP
# one request at a time: with the remainder carried from batch to batch,
# that runs batches of 8, 8, 16, 32 and 64, so every bucket serves
ENGINE_BUCKETS = (8, 16, 32, 64)
ENGINE_PRODUCERS = 4
ENGINE_REQUESTS = 48
ENGINE_SWEEP = (1, 9, 17, 33, 64)
# every future must resolve within this many seconds
ENGINE_WAIT_S = 120.0


def engine_sizes() -> list[int]:
    gen = torch.Generator().manual_seed(0)
    return torch.randint(1, 101, (ENGINE_REQUESTS,), generator=gen).tolist()


def count_buckets(engine, kernel) -> tuple[dict, list]:
    """Wrap the engine's program's ``apply`` so that the wrapper's counts
    around each batch (launches, launches by route) are booked to the
    batch's bucket, its size ``z.shape[0]``; also returns the sizes of
    the batches in the order they ran.  The scheduler thread is the only
    one launching while it serves."""
    from collections import Counter
    per = {b: {"batches": 0, "launches": 0, "routes": Counter()}
           for b in engine.buckets}
    order = []
    real = engine.program.apply

    def counted(params, z):
        n0, r0 = kernel.launches, Counter(kernel.launches_by_route)
        out = real(params, z)
        row = per[z.shape[0]]
        row["batches"] += 1
        row["launches"] += kernel.launches - n0
        row["routes"].update(Counter(kernel.launches_by_route) - r0)
        order.append(z.shape[0])
        return out
    engine.program.apply = counted
    return per, order


def stream_vs_plain(futures, order, plain, params, z_dim, dev) -> dict:
    """The engine's answers in stream order against the plain program on
    the same latents: the engine's draws (one a batch, seed 0) replayed
    in the order its batches ran.  Returns the max abs error by bucket;
    fails on any batch outside ATOL/RTOL."""
    offsets = [f.offset for f in futures]
    check(offsets == [sum(f.n for f in futures[:i])
                      for i in range(len(futures))],
          f"engine: the answers' offsets leave gaps: {offsets}")
    got = torch.cat([f.result(0) for f in futures])
    key = torch.Generator(device=dev).manual_seed(0)
    errs, pos = {}, 0
    with torch.inference_mode():
        for b in order:
            z = torch.randn((b, z_dim), generator=key, device=dev)
            take = min(b, len(got) - pos)
            check(take > 0, f"engine: a batch of {b} served no request")
            ref = plain.apply(params, z)[:take].cpu()
            err, ok = max_err(got[pos:pos + take], ref)
            check(ok, f"engine bucket {b}: the kernel's images and the "
                      f"plain version's on the same latents differ by "
                      f"{err:.3e} (atol=rtol={ATOL:g})")
            errs[b] = max(errs.get(b, 0.0), err)
            pos += take
    check(pos == len(got), f"engine: {len(got)} images served, "
                           f"{pos} drawn")
    return errs


def time_scheduler(engine) -> dict:
    """Book the host time of the scheduler's launches (``_dispatch``) and
    answers (``_resolve``, waiting for the copy included) per batch."""
    spent = {"_dispatch": [], "_resolve": []}
    for name, times in spent.items():
        def timed(batch, real=getattr(engine, name), times=times):
            t0 = time.perf_counter()
            real(batch)
            times.append((time.perf_counter() - t0) * 1e3)
        setattr(engine, name, timed)
    return spent


def drive_engine(engine, sizes) -> tuple[list, float]:
    """``sizes`` submitted by ENGINE_PRODUCERS threads in turn; every
    future resolved (bounded wait).  Returns the futures in stream order
    and the seconds from the first submit to the last answer."""
    import threading
    futures, lock, errors = [], threading.Lock(), []

    def produce(part):
        try:
            for n in part:
                f = engine.submit(n)
                with lock:
                    futures.append(f)
        except Exception as e:      # surfaced below
            errors.append(e)
    parts = [sizes[i::ENGINE_PRODUCERS] for i in range(ENGINE_PRODUCERS)]
    threads = [threading.Thread(target=produce, args=(p,)) for p in parts]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(ENGINE_WAIT_S)
    check(not errors and not any(t.is_alive() for t in threads),
          f"engine producers failed or hung: {errors}")
    deadline = t0 + ENGINE_WAIT_S
    for f in futures:
        try:
            f.result(max(0.0, deadline - time.perf_counter()))
        except TimeoutError:
            raise SmokeFailure(f"a request for {f.n} samples was not "
                               f"answered within {ENGINE_WAIT_S} s")
    wall = time.perf_counter() - t0
    check(len(futures) == len(sizes), "a submit was lost")
    return sorted(futures, key=lambda f: f.offset), wall


def gan_engine_phase(card, dev, wrappers) -> dict:
    """DCGAN through ``GanEngine``: the accounting invariant, every batch
    through the kernel (launches and routes by bucket, from the
    wrappers), every bucket served (the sweep), the engine's stream
    against the plain version on the same latents in every bucket, a
    single-bucket engine bit for bit against ``GanServer.generate``,
    ``GanServer.submit`` mixed with ``generate`` against ``generate``
    alone; images/s and request latency of the burst at
    ``pipeline_depth`` 1 and 2 are printed."""
    from repro_torch import obs
    from repro_torch.models.gan import GanConfig, init_gan
    from repro_torch.program import Program
    from repro_torch.serve.gan import GanServer
    from repro_torch.serve.gan_engine import GanEngine
    kernel = wrappers["ganax_conv"][0]
    cfg = GanConfig("dcgan")
    g, _ = init_gan(cfg, torch.Generator().manual_seed(0), device=dev)
    plain = Program.build(GanConfig("dcgan", backend="ganax-plain"), BATCH,
                          device=dev, differentiable=False)
    sizes = engine_sizes()
    out = {"sizes": sizes, "depth": {}}
    launches = 0
    for depth, traffic in ((1, "burst"), (2, "burst"), (1, "sweep")):
        engine = GanEngine(cfg, g, buckets=ENGINE_BUCKETS, seed=0,
                           pipeline_depth=depth, device=dev)
        per, order = count_buckets(engine, kernel)
        spent = time_scheduler(engine)
        for k, _ in wrappers.values():
            k.launches = 0
            if hasattr(k, "launches_by_route"):
                k.launches_by_route.clear()
        if traffic == "burst":
            asked = sizes
            futures, wall = drive_engine(engine, sizes)
        else:
            asked = list(ENGINE_SWEEP)
            futures, t0 = [], time.perf_counter()
            for n in ENGINE_SWEEP:
                futures.append(engine.submit(n))
                futures[-1].result(ENGINE_WAIT_S)
            wall = time.perf_counter() - t0
        engine.close(timeout=ENGINE_WAIT_S)
        counts = {k: wrappers[k][0].launches for k in wrappers}
        check(not engine._thread.is_alive(), "the engine did not close")
        for f in futures:
            img = f.result(0)
            check(tuple(img.shape) == (f.n, 64, 64, 3)
                  and img.device.type == "cpu"
                  and bool(torch.isfinite(img).all()),
                  f"engine answer for {f.n}: {tuple(img.shape)} on "
                  f"{img.device}")
        check(engine.samples_served + engine.samples_buffered
              + engine.samples_discarded
              == engine.samples_generated + engine.initial_spare,
              "engine: served + buffered + discarded != generated + spare")
        check(engine.samples_served == sum(asked)
              and engine.samples_discarded == 0,
              f"engine served {engine.samples_served} of {sum(asked)}")
        if traffic == "sweep":
            check(all(row["batches"] > 0 for row in per.values()),
                  f"engine sweep {ENGINE_SWEEP}: a bucket served no batch "
                  f"({order})")
        for b, row in per.items():
            check(row["launches"] == 4 * row["batches"]
                  and sum(row["routes"].values()) == row["launches"],
                  f"engine bucket {b}: {row['launches']} launches for "
                  f"{row['batches']} batches, routes {dict(row['routes'])}")
        check(len(order) == engine.batches_served
              and counts["ganax_conv"] == 4 * engine.batches_served
              and all(c == 0 for k, c in counts.items()
                      if k != "ganax_conv"),
              f"engine: launches {counts} for {engine.batches_served} "
              f"batches")
        launches += counts["ganax_conv"]
        # the comparison runs the plain version only: no kernel launch
        errs = stream_vs_plain(futures, order, plain, g, cfg.z_dim, dev)
        by_bucket = {b: {"batches": r["batches"], "launches": r["launches"],
                         "routes": dict(r["routes"]),
                         "max_abs_err_vs_plain": errs.get(b)}
                     for b, r in per.items()}
        print(f"gan_engine {traffic} (depth {depth}) vs the plain version "
              f"on the same latents, by bucket (atol=rtol={ATOL:g}): "
              f"{ {b: r['max_abs_err_vs_plain'] for b, r in by_bucket.items()} }"
              f" ok")
        if traffic == "sweep":
            out["sweep"] = {"sizes": asked, "batches": order,
                            "by_bucket": by_bucket}
            print(f"gan_engine sweep {asked}, one request at a time: "
                  f"batches {order}; by bucket {by_bucket} [{card}]")
            continue
        h = obs.histogram("engine.request_us", engine=engine.engine_id)
        rate = engine.samples_generated / wall
        row = {"images_per_s": rate, "wall_s": wall,
               "batches": engine.batches_served,
               "request_p50_us": h.percentile(50),
               "request_p99_us": h.percentile(99),
               "host_ms_per_batch": {k: statistics.median(v)
                                     for k, v in spent.items()},
               "by_bucket": by_bucket}
        out["depth"][depth] = row
        print(f"gan_engine depth {depth}: {len(sizes)} requests "
              f"({sum(sizes)} images) from {ENGINE_PRODUCERS} threads in "
              f"{wall:.4f} s: {engine.batches_served} batches, "
              f"{engine.samples_generated} generated, "
              f"{rate:.1f} images/s; engine.request_us p50 "
              f"{row['request_p50_us']:.1f} p99 {row['request_p99_us']:.1f}; "
              f"scheduler host ms a batch (median) "
              f"{row['host_ms_per_batch']}; by bucket {row['by_bucket']} "
              f"[{card}]")
    # a single bucket of 64 against the synchronous server, bit for bit
    engine = GanEngine(cfg, g, buckets=(BATCH,), seed=0, device=dev)
    futures, _ = drive_engine(engine, sizes)
    engine.close(timeout=ENGINE_WAIT_S)
    server = GanServer(cfg, g, batch_size=BATCH, seed=0, device=dev)
    same = all(torch.equal(f.result(0), server.generate(f.n).cpu())
               for f in futures)
    print(f"single-bucket engine (64) vs GanServer(batch_size=64).generate, "
          f"seed 0, {len(futures)} requests in stream order: "
          f"{'bit-identical' if same else 'DIFFERENT'}")
    check(same, "the single-bucket engine and GanServer.generate differ")
    # submit mixed with generate, against generate alone
    mixed_sizes = sizes[:8]
    alone = GanServer(cfg, g, batch_size=BATCH, seed=0, device=dev)
    ref = torch.cat([alone.generate(n) for n in mixed_sizes])
    mixed = GanServer(cfg, g, batch_size=BATCH, seed=0, device=dev)
    parts = [mixed.generate(n) if i % 2 == 0
             else mixed.submit(n).result(ENGINE_WAIT_S).to(dev)
             for i, n in enumerate(mixed_sizes)]
    mixed.close(timeout=ENGINE_WAIT_S)
    same = torch.equal(torch.cat(parts), ref)
    print(f"GanServer submit mixed with generate vs generate alone "
          f"({mixed_sizes}): {'bit-identical' if same else 'DIFFERENT'}")
    check(same, "GanServer.submit mixed with generate forked the stream")
    out["launches"] = launches
    return out


def program_phase(dev, wrappers) -> dict:
    """Program.build -> save -> ProgramSpec.load -> serve, for the DCGAN
    and 3D-GAN generators: the same images as the direct path, and
    ``ganax`` on every layer."""
    from repro_torch.models.gan import GanConfig, init_gan
    from repro_torch.program import Program, ProgramSpec
    from repro_torch.serve.gan import GanServer
    out = {}
    for name, model in (("ganax_conv", "dcgan"), ("ganax_conv3d", "3dgan")):
        cfg = GanConfig(model)
        g, _ = init_gan(cfg, torch.Generator().manual_seed(0), device=dev)
        with tempfile.TemporaryDirectory() as d:
            path = Path(d) / f"{model}-generator.json"
            Program.build(cfg, BATCH, device=dev,
                          differentiable=False).save(path)
            spec = ProgramSpec.load(path)
        served = GanServer(cfg, g, batch_size=BATCH, seed=0, device=dev,
                           program=Program(spec, device=dev,
                                           differentiable=False))
        direct = GanServer(cfg, g, batch_size=BATCH, seed=0, device=dev)
        for k, _ in wrappers.values():
            k.launches = 0
        img = served.generate(BATCH)
        torch.cuda.synchronize()
        n = wrappers[name][0].launches
        ref = direct.generate(BATCH)
        text = served.describe()
        every = [le.backend for le in spec.layers] == \
            ["ganax"] * len(spec.layers) and text.count("-> ganax ") == \
            len(spec.layers)
        same = torch.equal(img, ref)
        print(f"program {model}: build -> save -> load -> serve: "
              f"{'identical' if same else 'DIFFERENT'} to the direct path, "
              f"{n} {name} launches; layers on "
              f"{[le.backend for le in spec.layers]}")
        print(text)
        check(same, f"{model}: the loaded program serves other images")
        check(every, f"{model}: describe() does not name ganax on every "
                     f"layer")
        check(n == len(spec.layers), f"{model}: {n} launches for "
                                     f"{len(spec.layers)} layers")
        out[name] = n
        del img, ref, served, direct
    return out


def trace_overlap(path: Path) -> dict:
    """From a torch.profiler Chrome trace: the GANAX kernels' device
    events, and how many device-to-host copies run while a GANAX kernel
    runs on another stream."""
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "ganax" in e.get("name", "")]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "DtoH" in e.get("name", "")]

    def under(c):
        """µs of copy ``c`` during GANAX kernels of other streams."""
        return sum(max(0.0, min(c["ts"] + c["dur"], k["ts"] + k["dur"])
                       - max(c["ts"], k["ts"]))
                   for k in kernels if k["tid"] != c["tid"])
    shared = [under(c) for c in copies]
    return {"ganax_kernel_events": len(kernels),
            # one a launch; split-K adds its reduce kernel
            "ganax_launch_events": sum(
                "tc_kernel" in k["name"] or "narrow_kernel" in k["name"]
                for k in kernels),
            "dtoh_copies": len(copies),
            "dtoh_copies_under_ganax_kernels": sum(u > 0 for u in shared),
            "dtoh_us": sum(c["dur"] for c in copies),
            "dtoh_us_under_ganax_kernels": sum(shared)}


def obs_phase(dev, wrappers) -> dict:
    """With ``obs.enable()``: one engine request and one served 3D-GAN
    batch; their spans must be present and nest, and the registry's
    counters agree with the server's and the engine's properties.  Then
    ``obs.profile`` around one DCGAN batch must write a device trace
    holding the GANAX kernels and an ``obs.profile`` span; a second
    profile over four engine batches reads whether each batch's
    device-to-host copy ran under the next batch's kernels."""
    from repro_torch import obs
    from repro_torch.models.gan import GanConfig, init_gan
    from repro_torch.serve.gan import GanServer
    from repro_torch.serve.gan_engine import GanEngine
    cfg2, cfg3 = GanConfig("dcgan"), GanConfig("3dgan")
    g2, _ = init_gan(cfg2, torch.Generator().manual_seed(0), device=dev)
    g3, _ = init_gan(cfg3, torch.Generator().manual_seed(0), device=dev)
    engine = GanEngine(cfg2, g2, buckets=(BATCH,), seed=0, device=dev)
    server = GanServer(cfg3, g3, batch_size=BATCH, seed=0, device=dev)
    sink = obs.enable()
    try:
        engine.generate(BATCH, ENGINE_WAIT_S)
        # the scheduler emits engine.request after it answers: join it
        engine.close(timeout=ENGINE_WAIT_S)
        server.generate(BATCH)
        torch.cuda.synchronize()
    finally:
        obs.disable()
    spans = {n: sink.spans(n) for n in ("engine.request", "serve.generate",
                                        "program.apply", "program.layer")}
    print("obs spans: " + ", ".join(f"{n} x{len(v)}"
                                    for n, v in spans.items()))
    check(len(spans["engine.request"]) == 1
          and len(spans["serve.generate"]) == 1
          and len(spans["program.apply"]) == 2
          and len(spans["program.layer"]) == 8,
          f"obs: missing spans {[(n, len(v)) for n, v in spans.items()]}")

    def inside(inner, outer, same_thread=True):
        return (outer["ts_us"] <= inner["ts_us"] and inner["ts_us"]
                + inner["dur_us"] <= outer["ts_us"] + outer["dur_us"]
                and (not same_thread or (inner["tid"] == outer["tid"]
                                         and inner["depth"]
                                         == outer["depth"] + 1)))
    (req,), (gen,) = spans["engine.request"], spans["serve.generate"]
    applies = spans["program.apply"]
    check(all(sum(inside(lay, a) for a in applies) == 1
              for lay in spans["program.layer"]),
          "obs: a program.layer span is not inside one program.apply")
    check(sum(inside(a, gen) for a in applies) == 1
          and sum(inside(a, req, same_thread=False) for a in applies) == 1,
          "obs: program.apply does not nest in serve.generate and "
          "engine.request")
    snap = obs.snapshot()["counters"]
    sid, eid = server.server_id, engine.engine_id
    agree = (snap[f"serve.batches{{server={sid}}}"] == server.batches_served
             and snap[f"serve.samples_served{{server={sid}}}"]
             == server.samples_served
             and obs.gauge("serve.samples_buffered", server=sid).value
             == server.samples_buffered
             and snap[f"engine.samples_served{{engine={eid}}}"]
             == engine.samples_served
             and snap[f"engine.batches{{engine={eid}}}"]
             == engine.batches_served)
    print(f"obs registry vs properties: server {server}, engine "
          f"{engine}: {'agree' if agree else 'DISAGREE'}")
    check(agree, "obs: the registry's counters disagree with the "
                 "properties")
    out = {"spans": {n: len(v) for n, v in spans.items()}}
    # obs.profile around one DCGAN batch: a device trace with the kernels
    sync_server = GanServer(cfg2, g2, batch_size=BATCH, seed=0, device=dev)
    sync_server.generate(BATCH)
    with tempfile.TemporaryDirectory() as d:
        sink = obs.enable()
        try:
            with obs.profile(d):
                sync_server.generate(BATCH)
        finally:
            obs.disable()
        (prof,) = sink.spans("obs.profile")
        trace = prof["attrs"]["device_trace"]
        check(bool(trace) and Path(trace).exists(),
              f"obs.profile wrote no device trace: {prof['attrs']}")
        one = trace_overlap(Path(trace))
        print(f"obs.profile of one DCGAN batch: {one}")
        check(one["ganax_launch_events"] == 4,
              f"obs.profile's trace holds {one['ganax_launch_events']} "
              f"GANAX kernel launches for one batch, not 4")
        out["profile_one_batch"] = one
        # four engine batches of 64 after four others: copy k under the
        # kernels of k + 1?  (DCGAN is host-bound, 3D-GAN device-bound)
        for cfg, g in ((cfg2, g2), (cfg3, g3)):
            engine = GanEngine(cfg, g, buckets=(BATCH,), seed=0, device=dev)
            for f in [engine.submit(BATCH) for _ in range(4)]:
                f.result(ENGINE_WAIT_S)     # the steady state, not the start
            sink = obs.enable()
            try:
                with obs.profile(d):
                    futures = [engine.submit(BATCH) for _ in range(4)]
                    for f in futures:
                        f.result(ENGINE_WAIT_S)
            finally:
                obs.disable()
            engine.close(timeout=ENGINE_WAIT_S)
            (prof,) = sink.spans("obs.profile")
            four = trace_overlap(Path(prof["attrs"]["device_trace"]))
            print(f"obs.profile of 4 {cfg.name} engine batches "
                  f"(pipeline_depth 1): {four}")
            out[f"profile_engine_{cfg.name}"] = four
    return out


def storage_share(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst output's share of the two-ulp tolerance of ``ref``'s
    storage dtype (STORAGE_TOL); the gate passes at <= 1."""
    atol, rtol = STORAGE_TOL[ref.dtype]
    got, ref = got.float(), ref.float()
    return ((got - ref).abs() / (atol + rtol * ref.abs())).max().item()


@contextlib.contextmanager
def storage_sums_fault(nd: int, layer: int):
    """Plant the path gate's fault: while active, launch ``layer`` of
    each generator batch (counted per call of the rank-``nd`` kernel
    through ``kernels/ops.py``, ``layer`` modulo 4) runs the plain
    arithmetic with its sums in the storage dtype; the other launches
    run the kernel."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ganax_conv import (apply_epilogue_to_acc,
                                                plain_sums)
    kernel, plain = ops._KERNELS[nd]
    calls = [0]

    def faulty(x_pad, w_taps, tables, out_strides, bias=None,
               activation="none", leaky_slope=0.2, **q):
        i = calls[0]
        calls[0] += 1
        if i % 4 != layer:
            return kernel(x_pad=x_pad, w_taps=w_taps, tables=tables,
                          out_strides=out_strides, bias=bias,
                          activation=activation, leaky_slope=leaky_slope,
                          **q)
        sizes = tuple(q[k] for k in ("qz", "qy", "qx") if k in q)
        acc = plain_sums(x_pad, w_taps, tables, out_strides, sizes,
                         acc_dtype=x_pad.dtype)
        return apply_epilogue_to_acc(acc.float(), bias, activation,
                                     leaky_slope).to(x_pad.dtype)
    ops._KERNELS[nd] = (faulty, plain)
    try:
        yield
    finally:
        ops._KERNELS[nd] = (kernel, plain)


def quant_phase(card, dev, wrappers) -> dict:
    """The GANAX kernels' bf16 and f16 instances (ROADMAP item 9).

    1. Every serving geometry of both networks of DCGAN and 3D-GAN (g1-g4,
       d1-d5) at bf16 and f16, kernel against plain at the same dtype
       (STORAGE_TOL), and the accumulation control (STORAGE_CONTROL).
    2. The path: ``GanServer.generate`` at bf16 and f16 for both models
       through the kernels, against a ``ganax-plain`` program on the same
       latents (PATH_ACCURACY, with the planted fault of
       ``storage_sums_fault``); the launches of each instance counted
       from 0 here to the int8 engine's last batch; at the reference's
       calibration configuration each model's bf16 and f16 output within
       ``model_tolerance(...)["output_atol"]`` of its f32 output.
    3. int8: a DCGAN int8 export at bf16, saved and loaded; its weights
       dequantized on the card are the CPU's bits, and ``GanEngine(cfg,
       None, program=...)`` streams ``GanServer(..., program=...)``'s
       images bit for bit.
    4. Times, per model and dtype: a 64-batch's generator forward (median
       of 15) and samples/s; its four kernel launches (per call and as
       the device runs them) beside their bound, their plain version and
       one cuDNN transposed conv at the same dtype; the peak device
       memory of a 3D-GAN batch at f32 and bf16; a profile of the bf16
       forwards."""
    from repro_torch.configs.gans import GAN_MODELS
    from repro_torch.core.dataflow import Epilogue
    from repro_torch.kernels import ops
    from repro_torch.kernels.ganax_conv import (apply_epilogue_to_acc,
                                                plain_sums)
    from repro_torch.models.gan import (GanConfig, discriminator_epilogues,
                                        generator_epilogues, init_gan)
    from repro_torch.program import Program, ProgramSpec
    from repro_torch.quant import (dequantize_params, model_tolerance,
                                   quantize_program)
    from repro_torch.serve.gan import GanServer
    from repro_torch.serve.gan_engine import GanEngine
    gan = {k: wrappers[k] for k in ("ganax_conv", "ganax_conv3d")}
    models = (("ganax_conv", "dcgan"), ("ganax_conv3d", "3dgan"))
    dtypes = (torch.bfloat16, torch.float16)
    out = {"launches": {}, "errs": {}, "control": {}, "path": {},
           "calibration": {}, "times": {}}
    gen = torch.Generator().manual_seed(2718)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(dev)

    # -- 1. every serving geometry, kernel vs plain; the control -----------
    rows = {}       # (name, dtype) -> the generator layers' operands
    with torch.inference_mode():
        for name, model in models:
            kernel, plain = gan[name]
            g_layers, d_layers = GAN_MODELS[model]
            cases = [(l, True, ep) for l, ep in
                     zip(g_layers, generator_epilogues(g_layers))] + \
                [(l, False, ep) for l, ep in
                 zip(d_layers, discriminator_epilogues(d_layers))]
            for l, transposed, ep in cases:
                label = f"{model} {l.name}"
                x = rand(BATCH, *l.in_spatial, l.cin)
                w = rand(*l.kernel, l.cin, l.cout,
                         scale=(math.prod(l.kernel) * l.cin) ** -0.5)
                b = rand(l.cout, scale=0.1) if ep.bias else None
                for dt in dtypes:
                    dname = STORAGE_NAMES[dt]
                    o = ops.kernel_operands(x.to(dt), w.to(dt), l.strides,
                                            l.paddings, transposed=transposed)
                    got = kernel(**o, bias=b, activation=ep.activation,
                                 leaky_slope=ep.leaky_slope)
                    ref = plain(**o, bias=b, activation=ep.activation,
                                leaky_slope=ep.leaky_slope)
                    torch.cuda.synchronize()
                    share = storage_share(got, ref)
                    err = (got.float() - ref.float()).abs().max().item()
                    out["errs"].setdefault(f"{name}_{dname}", []).append(err)
                    ok = share <= 1 and got.dtype == dt and \
                        bool(torch.isfinite(got).all())
                    print(f"{name} {dname} vs plain  {label:10s} "
                          f"[{route_of(o)}] max_abs_err {err:.3e}, worst "
                          f"output at {share:.4f} of the two-ulp tolerance "
                          f"{'ok' if ok else 'FAIL'}")
                    check(ok, f"{label}: the {dname} instance of {name} "
                              f"disagrees with its plain version")
                    if label in STORAGE_CONTROL[name]:
                        acc = plain_sums(o["x_pad"], o["w_taps"],
                                         o["tables"], o["out_strides"],
                                         q_sizes(o), acc_dtype=dt)
                        low = apply_epilogue_to_acc(
                            acc.float(), b, ep.activation,
                            ep.leaky_slope).to(dt)
                        c_share = storage_share(low, ref)
                        out["control"].setdefault(f"{name}_{dname}",
                                                  {})[label] = c_share
                        print(f"  control: {label} with its sums in "
                              f"{dname}: worst output at {c_share:.2f} of "
                              f"the tolerance "
                              f"({'fails the gate' if c_share > 1 else 'passes'})")
                        del acc, low
                    if transposed:
                        rows.setdefault((name, dt), []).append(
                            (label, o, b, ep, x.to(dt), w.to(dt), l))
                    del got, ref
            for dt in dtypes:
                key = f"{name}_{STORAGE_NAMES[dt]}"
                check(max(out["control"][key].values()) > 1,
                      f"{key}: no wide launch with storage-dtype sums fails "
                      f"the two-ulp gate, so it cannot tell f32 sums from "
                      f"{STORAGE_NAMES[dt]} ones")

    # -- 2. the path --------------------------------------------------------
    launched = {name: {STORAGE_NAMES[dt]: 0 for dt in dtypes}
                for name, _ in models}

    def main_path(name, fn):
        """``fn()``, a call of the main path, with every count set to 0
        just before it and the kernel's launches by dtype booked just
        after."""
        for kernel, _ in wrappers.values():
            kernel.launches = 0
            if hasattr(kernel, "launches_by_route"):
                kernel.launches_by_route.clear()
                kernel.launches_by_dtype.clear()
        result = fn()
        torch.cuda.synchronize()
        for k, _ in wrappers.values():
            check(k is gan[name][0] or k.launches == 0,
                  f"the {name} path launched another kernel")
        for dname, n in gan[name][0].launches_by_dtype.items():
            check(dname in launched[name], f"the {name} path launched "
                                           f"its {dname} instance")
            launched[name][dname] += n
        return result

    servers = {}
    for name, model in models:
        cfg = GanConfig(model)
        g, _ = init_gan(cfg, torch.Generator().manual_seed(0), device=dev)
        plain_cfg = GanConfig(model, backend="ganax-plain")
        img32 = GanServer(plain_cfg, g, batch_size=BATCH, seed=0,
                          device=dev).generate(BATCH).double()
        for dt in dtypes:
            dname = STORAGE_NAMES[dt]
            n0 = launched[name][dname]
            server = GanServer(cfg, g, batch_size=BATCH, seed=0, dtype=dname,
                               device=dev)
            img = main_path(name, lambda: server.generate(BATCH))
            n = launched[name][dname] - n0
            check(img.dtype == dt and tuple(img.shape[1:]) ==
                  ((64, 64, 3) if model == "dcgan" else (64, 64, 64, 1)),
                  f"{model} {dname}: images {img.dtype} {tuple(img.shape)}")
            check(bool(torch.isfinite(img).all())
                  and img.abs().max().item() <= 1.0,
                  f"{model} {dname}: images not finite or outside [-1, 1]")
            check(n == 4, f"{model} {dname}: {n} launches of the {dname} "
                          f"instance for one batch of 4 layers")
            plain_img = GanServer(plain_cfg, g, batch_size=BATCH, seed=0,
                                  dtype=dname, device=dev).generate(BATCH)
            with storage_sums_fault(img.ndim - 2, PATH_FAULT_LAYER):
                fault_img = GanServer(cfg, g, batch_size=BATCH, seed=0,
                                      dtype=dname,
                                      device=dev).generate(BATCH)
            base = (plain_img.double() - img32).norm().item()
            ratio = (img.double() - img32).norm().item() / base
            fault = (fault_img.double() - img32).norm().item() / base
            rel = ((img.double() - plain_img.double()).norm()
                   / plain_img.double().norm()).item()
            out["path"][f"{model}_{dname}"] = dict(
                accuracy_ratio=ratio, fault_ratio=fault,
                rel_l2_vs_plain=rel, launches=n)
            print(f"{model} {dname} path (GanServer.generate, {BATCH}): "
                  f"||img - f32|| / ||plain - f32|| = {ratio:.4f} (gate "
                  f"{PATH_ACCURACY}; {'ok' if ratio <= PATH_ACCURACY else 'FAIL'}), "
                  f"planted fault ({dname} sums at layer "
                  f"{PATH_FAULT_LAYER + 1}) {fault:.4f} "
                  f"({'exceeds' if fault > PATH_ACCURACY else 'DOES NOT exceed'}); "
                  f"||img - plain|| / ||plain|| = {rel:.3e}")
            check(ratio <= PATH_ACCURACY,
                  f"{model} {dname}: the kernel path is less accurate than "
                  f"the plain path ({ratio:.4f} > {PATH_ACCURACY})")
            check(fault > PATH_ACCURACY,
                  f"{model} {dname}: the planted fault passes the path gate "
                  f"({fault:.4f}), so the gate cannot see it")
            servers[name, dt] = server
            del img, plain_img, fault_img
        servers[name, torch.float32] = GanServer(cfg, g, batch_size=BATCH,
                                                 seed=0, device=dev)
        del img32
        # the reference's calibration configuration
        scale, batch = CALIBRATION
        small = GanConfig(model, channel_scale=scale)
        gs, _ = init_gan(small, torch.Generator().manual_seed(0), device=dev)
        z = torch.randn((batch, small.z_dim),
                        generator=torch.Generator().manual_seed(1)).to(dev)
        y32 = Program.build(small, batch, device=dev,
                            differentiable=False).apply(gs, z)
        for dt in dtypes:
            dname = STORAGE_NAMES[dt]
            y = Program.build(small, batch, dtype=dname, device=dev,
                              differentiable=False).apply(gs, z)
            drift = (y.float() - y32).abs().max().item()
            gate = model_tolerance(model, dname)["output_atol"]
            out["calibration"][f"{model}_{dname}"] = dict(drift=drift,
                                                          gate=gate)
            print(f"{model} {dname} at the calibration configuration "
                  f"(channel_scale {scale}, batch {batch}): max |y - y32| "
                  f"{drift:.3e} (the reference's output_atol {gate:g}) "
                  f"{'ok' if drift < gate else 'FAIL'}")
            check(drift < gate, f"{model} {dname}: drift {drift:.3e} >= "
                                f"the reference's gate {gate:g}")

    # -- 3. int8 ------------------------------------------------------------
    cfg = GanConfig("dcgan", dtype="bf16")
    g, _ = init_gan(cfg, torch.Generator().manual_seed(0), device=dev)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "dcgan-int8.json"
        quantize_program(ProgramSpec.build(cfg, BATCH, "generator"),
                         g).save(path)
        spec = ProgramSpec.load(path)
    prog = Program(spec, device=dev, differentiable=False)
    cpu = dequantize_params(spec.quantized_params, spec.dtype)
    same_bits = all(torch.equal(v.cpu(), cpu[k])
                    and v.dtype == cpu[k].dtype
                    for k, v in prog.params.items())
    check(same_bits, "int8: the weights dequantized on the card differ "
                     "from the CPU's")
    base = GanConfig("dcgan")
    server = GanServer(base, None, batch_size=BATCH, seed=0, program=prog,
                       device=dev)
    ref = main_path("ganax_conv", lambda: server.generate(sum(REQUESTS)))
    with GanEngine(base, None, buckets=(BATCH,), seed=0, program=prog,
                   device=dev) as engine:
        stream = main_path("ganax_conv", lambda: torch.cat([
            f.result(ENGINE_WAIT_S)
            for f in [engine.submit(n) for n in REQUESTS]]))
        check(engine.cfg.dtype == "bfloat16",
              f"int8: the engine serves {engine.cfg.dtype}, not the "
              f"program's bfloat16")
    same = torch.equal(stream, ref.cpu())
    print(f"int8 DCGAN program at bf16 ({len(spec.quantized_params['params'])} "
          f"tensors): dequantized weights {'bit-identical' if same_bits else 'DIFFERENT'} "
          f"to the CPU's; GanEngine stream of {', '.join(map(str, REQUESTS))} "
          f"{'bit-identical' if same else 'DIFFERENT'} to GanServer.generate")
    check(same, "int8: the engine's stream differs from GanServer.generate")
    out["int8"] = dict(weights_bit_identical=same_bits,
                       stream_bit_identical=same)
    out["launches"] = launched
    print(f"quant main path (GanServer.generate at bf16 and f16, the int8 "
          f"program's server and engine): launches by dtype {launched}")
    for name, _ in models:
        for dname, n in launched[name].items():
            check(n > 0, f"the main path never launched the {dname} "
                         f"instance of {name}")
    del ref, stream, engine, prog, server

    # -- 4. times -----------------------------------------------------------
    z = torch.randn((BATCH, 100), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    with torch.inference_mode():
        for name, model in models:
            kernel, plain = gan[name]
            for dt in (torch.float32,) + dtypes:
                dname = STORAGE_NAMES[dt]
                server = servers.pop((name, dt))
                gen_ms = time_ms(lambda: server.generator(z))
                if dt == torch.float32:
                    layer_rows = [
                        (label, o32, b, ep, x.float(), w.float(), l)
                        for (label, _, b, ep, x, w, l), o32 in zip(
                            rows[name, torch.bfloat16],
                            [ops.kernel_operands(
                                x.float(), w.float(), l.strides, l.paddings,
                                transposed=True)
                             for (_, _, _, _, x, w, l)
                             in rows[name, torch.bfloat16]])]
                else:
                    layer_rows = rows[name, dt]
                tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0,
                           library_ms=0.0, library_device_ms=0.0,
                           bound_ms=0.0, ops_bound_ms=0.0)
                routes = {}
                for label, o, b, ep, x, w, l in layer_rows:
                    act = ep.activation
                    lib = library_conv_transpose(
                        x, w, b.to(dt) if b is not None else None,
                        l.strides, l.paddings)
                    bnd, by = bound(o, b)[:2]
                    tot["ms"] += time_ms(lambda: kernel(**o, bias=b,
                                                        activation=act))
                    tot["device_ms"] += device_ms(
                        lambda: kernel(**o, bias=b, activation=act))
                    tot["plain_ms"] += time_ms(
                        lambda: plain(**o, bias=b, activation=act),
                        warmup=1, runs=5)
                    tot["library_ms"] += time_ms(lib)
                    tot["library_device_ms"] += device_ms(lib)
                    tot["bound_ms"] += bnd
                    if by == "operations":
                        tot["ops_bound_ms"] += bnd
                    r = route_of(o)
                    routes[r] = routes.get(r, 0) + 1
                mem = None
                if model == "3dgan" and dt != torch.float16:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats(dev)
                    before = torch.cuda.memory_allocated(dev)
                    server.generator(z)
                    torch.cuda.synchronize()
                    mem = (torch.cuda.max_memory_allocated(dev) - before) / 1e9
                prof = profile(lambda: server.generator(z), 5,
                               f"{model} {dname} generator forwards") \
                    if dt == torch.bfloat16 else None
                row = dict(tot, generator_ms=gen_ms,
                           samples_per_s=BATCH / (gen_ms / 1e3),
                           routes=routes, peak_gb=mem, profile=prof,
                           bound_by="operations" if tot["ops_bound_ms"]
                           >= tot["bound_ms"] / 2 else "bytes")
                out["times"][f"{model}_{dname}"] = row
                print(f"{model} {dname}: generator forward at batch {BATCH} "
                      f"{gen_ms:.4f} ms ({row['samples_per_s']:.1f} samples/s); "
                      f"its 4 launches {tot['ms']:.4f} ms "
                      f"[{tot['device_ms']:.4f}] by route {routes}, plain "
                      f"{tot['plain_ms']:.4f} ms, cuDNN {tot['library_ms']:.4f} "
                      f"ms [{tot['library_device_ms']:.4f}], bound "
                      f"{tot['bound_ms']:.4f} ms ({row['bound_by']})"
                      + (f"; peak device memory of a batch {mem:.3f} GB"
                         if mem is not None else "") + f" [{card}]")
                del server
    torch.cuda.empty_cache()
    return out


# The mixed_train phase (ROADMAP item 9b): steps through TrainLoop per
# model, at each storage dtype
MIXED_STEPS = {"dcgan": 3, "3dgan": 1}
# (model, warm-up steps, timed steps) of the step times at f32, bf16, f16
MIXED_TIMING = (("dcgan", 1, 3), ("3dgan", 1, 1))   # (2, 5), (1, 2) before
#                                                    a cut for the time
# The gradient gate: the per-launch gate's question asked of one step's
# gradients (DCGAN at full width), as PATH_ACCURACY asks it of the
# images: is the kernel path at a storage dtype as accurate as the plain
# path at that dtype?  Both measured against the f32 plain step on the
# same parameters and batch:
#   ||g - g32|| <= PATH_ACCURACY * ||g_plain - g32||
# over every gradient ("tree") and over D's alone ("d"; the tree's norm
# sits in D's last layers, which no dx feeds).  G's gradients ("g") are
# read, not gated: their error sits in G's last layer, whose kernel/plain
# ratio swings from 0.49 to 2.44 between seeds at either dtype (a few
# terms carry it; tools/grad_gate.py --seed), where every other layer's
# holds within 0.98-1.06.
# The planted faults: each of these layers' dx summed in the storage
# dtype, every product added to a storage-dtype running sum.  A
# discriminator layer's dx feeds D's earlier gradients and all of G's, a
# generator layer's dx G's earlier ones only.  Each fault of
# GRAD_FAULT_SEEN must exceed a gated reading; the others are read.
GRAD_FAULT_LAYERS = ("d4", "g2")
GRAD_FAULT_SEEN = ("d4",)
GRAD_PARTS = ("tree", "d", "g")
GRAD_GATED = ("tree", "d")


def step_grads(cfg, dev, params, data) -> dict:
    """One adversarial step's gradients through ``cfg`` (its backend and
    storage dtype), from copies of ``params``: D's (``d.*``), then G's
    against the same D (``g.*``), one flat dict of f32 tensors."""
    from repro_torch.models.gan import Discriminator, Generator
    from repro_torch.train.loop import discriminator_grads, generator_grads
    g, d = ({k: v.clone() for k, v in p.items()} for p in params)
    gen, disc = Generator(cfg, g, dev), Discriminator(cfg, d, dev)
    _, dg = discriminator_grads(gen, disc, data["z"], data["real"])
    _, gg = generator_grads(gen, disc, data["z"])
    return {**{f"d.{k}": v for k, v in dg.items()},
            **{f"g.{k}": v for k, v in gg.items()}}


def dx_shapes(cfg, layer: str, batch: int) -> tuple[tuple, tuple]:
    """(x_pad, w_taps) shapes of the kernel call of ``layer``'s dx at
    ``batch``: the adjoint op on its output's cotangent with swapped
    weights (a conv for a generator layer, an uncropped pad-0 tconv for a
    discriminator layer)."""
    from repro_torch.kernels import ops
    l = next(l for l in cfg.layers[0] + cfg.layers[1] if l.name == layer)
    if l.transposed:
        out = tuple((n - 1) * s + k - 2 * p for n, k, s, p in
                    zip(l.in_spatial, l.kernel, l.strides, l.paddings))
        o = ops.kernel_operands(torch.zeros((batch, *out, l.cout)),
                                torch.zeros((*l.kernel, l.cout, l.cin)),
                                l.strides, l.paddings, transposed=False)
    else:
        q = tuple((n + 2 * p - k) // s + 1 for n, k, s, p in
                  zip(l.in_spatial, l.kernel, l.strides, l.paddings))
        o = ops.kernel_operands(torch.zeros((batch, *q, l.cout)),
                                torch.zeros((*l.kernel, l.cout, l.cin)),
                                l.strides, (0,) * len(q), transposed=True)
    return tuple(o["x_pad"].shape), tuple(o["w_taps"].shape)


def storage_accumulated(x_pad, w_taps, tables, out_strides,
                        sizes) -> torch.Tensor:
    """The sums of one call with an accumulator in the storage dtype, as a
    kernel that kept its running sum in it: per phase, each product added
    to the storage-dtype sum with one rounding; (B, P, *Q, Cout) in the
    storage dtype, before the epilogue."""
    dt = x_pad.dtype
    b, cin = x_pad.shape[0], x_pad.shape[-1]
    p, _, _, cout = w_taps.shape
    out = x_pad.new_empty((b, p, *sizes, cout))
    for ph, taps in enumerate(tables.taps):
        acc = x_pad.new_zeros((b * math.prod(sizes), cout))
        for t, tap in enumerate(taps):
            window = tuple(slice(d, d + (n - 1) * s + 1, s) for d, n, s
                           in zip(tap, sizes, out_strides))
            xt = x_pad[(slice(None),) + window].reshape(-1, cin).float()
            wt = w_taps[ph, t].float()
            for c in range(cin):
                acc = (acc.float() + xt[:, c, None] * wt[c]).to(dt)
        out[:, ph] = acc.reshape(b, *sizes, cout)
    return out


@contextlib.contextmanager
def storage_sums_at(nd: int, shapes: tuple[tuple, tuple]):
    """Plant a gradient gate fault: while active, every call of the
    rank-``nd`` kernel (on the card) or of its plain version (on the CPU)
    from the kernels' backward (a ``dx``) whose (x_pad, w_taps) shapes are
    ``shapes`` runs the plain arithmetic with its sums in the storage
    dtype (``storage_accumulated``); the other calls run as before
    (DCGAN's discriminator mirrors its generator, so a dx and a forward
    call can share their shapes).
    Yields a list whose length counts the faulty calls."""
    from repro_torch.core import dataflow as tdf
    from repro_torch.kernels import ops
    from repro_torch.kernels.ganax_conv import apply_epilogue_to_acc
    kernel, plain = ops._KERNELS[nd]
    backward = tdf._KernelOp.backward
    in_backward, hits = [], []

    def marked(ctx, *grads):
        in_backward.append(1)
        try:
            return backward(ctx, *grads)
        finally:
            in_backward.pop()

    def faulty(x_pad, w_taps, tables, out_strides, bias=None,
               activation="none", leaky_slope=0.2, route=None, **q):
        args = dict(x_pad=x_pad, w_taps=w_taps, tables=tables,
                    out_strides=out_strides, bias=bias,
                    activation=activation, leaky_slope=leaky_slope, **q)
        if not in_backward or \
                (tuple(x_pad.shape), tuple(w_taps.shape)) != shapes:
            return kernel(**args, route=route) if x_pad.is_cuda \
                else plain(**args)
        hits.append(1)
        sizes = tuple(q[k] for k in ("qz", "qy", "qx") if k in q)
        acc = storage_accumulated(x_pad, w_taps, tables, out_strides, sizes)
        return apply_epilogue_to_acc(acc.float(), bias, activation,
                                     leaky_slope).to(x_pad.dtype)
    ops._KERNELS[nd] = (faulty, faulty)
    tdf._KernelOp.backward = staticmethod(marked)
    try:
        yield hits
    finally:
        ops._KERNELS[nd] = (kernel, plain)
        tdf._KernelOp.backward = staticmethod(backward)


def grad_gate(model: str, dname: str, dev, batch: int,
              scale: float = 1.0,
              fault_layers: tuple[str, ...] = GRAD_FAULT_LAYERS,
              seed: int = 0) -> dict:
    """The gradient gate for ``model`` at storage ``dname`` on ``dev``:
    one step's gradients from parameters of ``seed`` and the quickstart's
    batch of that step, through the kernels, the plain version and the kernels
    with each planted fault, each against the f32 plain step, read over
    every gradient, D's and G's (``GRAD_PARTS``), and per layer.  On the
    CPU the kernel
    path is the plain version itself (ratio 1): what the CPU can say is
    how far each fault moves the ratios."""
    from repro_torch.models.gan import GanConfig, init_gan
    from repro_torch.quickstart import make_batch_fn
    base = GanConfig(model, channel_scale=scale)
    params = init_gan(base, torch.Generator().manual_seed(seed), dev)
    data = make_batch_fn(base, batch, dev)(seed)
    g32 = step_grads(dataclasses.replace(base, backend="ganax-plain"), dev,
                     params, data)
    low = dataclasses.replace(base, dtype=dname)
    plain = step_grads(dataclasses.replace(low, backend="ganax-plain"), dev,
                       params, data)
    kern = step_grads(low, dev, params, data)

    def sq(tree, base=g32):
        """Squared distance from ``base``, per tensor."""
        return {k: float((tree[k].double() - base[k].double()).square()
                         .sum()) for k in g32}
    ref = sq(plain)

    def ratios(e):
        """sqrt(sum e / sum ref) over each of ``GRAD_PARTS``."""
        def part(d, n):
            return sum(v for k, v in d.items()
                       if n == "tree" or k.startswith(n + "."))
        return {n: math.sqrt(part(e, n) / part(ref, n)) for n in GRAD_PARTS}

    def worst(e):
        k = max(g32, key=lambda k: e[k] / max(ref[k], 1e-300))
        return k, math.sqrt(e[k] / max(ref[k], 1e-300))

    def layers(e):
        """The same ratio over each layer's weight and bias."""
        names = dict.fromkeys(k.rsplit("_", 1)[0] for k in g32)
        return {n: math.sqrt(sum(v for k, v in e.items()
                                 if k.rsplit("_", 1)[0] == n) /
                             sum(v for k, v in ref.items()
                                 if k.rsplit("_", 1)[0] == n))
                for n in names}
    faults = {}
    for layer in fault_layers:
        with storage_sums_at(len(base.layers[0][0].kernel),
                             dx_shapes(base, layer, batch)) as hits:
            tree = step_grads(low, dev, params, data)
        check(len(hits) > 0, f"{model} {dname}: the planted fault at "
                             f"{layer} never ran")
        faults[layer] = dict(ratio=ratios(sq(tree)), calls=len(hits),
                             layers=layers(sq(tree)))
        del tree
    zero = {k: torch.zeros_like(v) for k, v in g32.items()}
    err = sq(kern)
    return dict(ratio=ratios(err), faults=faults, layers=layers(err),
                # ||g_plain - g32|| / ||g32|| per layer
                plain_layer_rel={n: 1 / r
                                 for n, r in layers(sq(zero)).items()},
                kernel_vs_plain=ratios(sq(kern, plain)),
                tensor_worst=worst(err)[0], tensor_ratio=worst(err)[1],
                # ||g_plain - g32|| / ||g32|| per net
                plain_rel={n: 1 / r for n, r in ratios(sq(zero)).items()},
                tensors=len(g32))


def calibration_grad_rel(model: str, dname: str, dev) -> float:
    """The reference's grad_rel protocol (``tests/test_quant.py``) at its
    calibration configuration through the kernels: the generator's
    parameter gradients of sum(y²) at ``dname`` against f32, relative L2
    over the tree."""
    from repro_torch.models.gan import GanConfig, Generator, init_gan
    scale, batch = CALIBRATION
    grads = {}
    for dt in ("float32", dname):
        cfg = GanConfig(model, channel_scale=scale, dtype=dt)
        g, _ = init_gan(cfg, torch.Generator().manual_seed(0), dev)
        gen = Generator(cfg, g, dev)
        z = torch.randn((batch, cfg.z_dim),
                        generator=torch.Generator().manual_seed(1)).to(dev)
        params = gen.params
        grads[dt] = dict(zip(params, torch.autograd.grad(
            gen(z).float().square().sum(), list(params.values()))))
    g32, g = grads["float32"], grads[dname]
    num = sum(float((g[k].double() - g32[k].double()).square().sum())
              for k in g32)
    den = sum(float(v.double().square().sum()) for v in g32.values())
    return math.sqrt(num / den)


def mixed_train_phase(card, dev, wrappers) -> dict:
    """Mixed-precision training (ROADMAP item 9b) on the card.

    1. Every launch geometry of DCGAN's and 3D-GAN's train step at batch
       ``BATCH`` at bf16 and f16, kernel against plain at the same dtype
       (STORAGE_TOL): the dx launches among them (d1's narrow dx, d5's
       flattened Cin 1, the 3-D ones) run here at 2 bytes for the first
       time; each kernel's device time beside its bound, summed per step
       (the host-clock, plain-version and cuDNN timings were cut for the
       script's time).
    2. The main path: full-width DCGAN through ``quickstart.train``
       (``TrainLoop``, a checkpoint) for ``MIXED_STEPS`` steps at bf16
       and at f16, 3D-GAN likewise, each with every count at 0 just
       before and read just after: 40 launches a step, all of the
       dtype's instance; the losses finite; the parameters and the
       checkpoint f32.
    3. The gradient gate (``grad_gate``: over every gradient and over
       D's, G's read) at bf16 and f16, with its planted faults; the
       reference's ``grad_rel`` at its calibration
       configuration for both models.
    4. ms per step at f32, bf16 and f16 (CUDA events, medians), and the
       peak device memory of a step."""
    from repro_torch import quickstart
    from repro_torch.configs.gans import GAN_MODELS
    from repro_torch.kernels import ops
    from repro_torch.models.gan import GanConfig
    from repro_torch.quant import model_tolerance
    from repro_torch.train import checkpoint as ckpt
    gan = {k: wrappers[k] for k in ("ganax_conv", "ganax_conv3d")}
    models = (("ganax_conv", "dcgan"), ("ganax_conv3d", "3dgan"))
    dtypes = (torch.bfloat16, torch.float16)
    out = {"geometries": {}, "launches": {}, "errs": {}, "gate": {},
           "calibration": {}, "steps": {}}
    gen = torch.Generator().manual_seed(8642)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(dev)

    # -- 1. every launch geometry of the step, kernel vs plain, timed ----
    for name, model in models:
        kernel, plain = gan[name]
        # (PR 30 cut the runs from 10 and 3 for the script's time)
        timing = dict(warmup=1, runs=5) if name == "ganax_conv" \
            else dict(warmup=1, runs=2)
        for dt in dtypes:
            dname = STORAGE_NAMES[dt]
            tot = {part: dict(launches=0, device_ms=0.0, bound_ms=0.0,
                              ops_bound_ms=0.0)
                   for part in ("forward", "dx")}
            worst = 0.0
            for (label, part, tr, xs, ws, s, p, ep, launches,
                 _) in train_cases(model, *GAN_MODELS[model]):
                nd = len(s)
                x = rand(*xs).to(dt)
                w = rand(*ws, scale=(math.prod(ws[:nd]) * ws[-2]) ** -0.5
                         ).to(dt)
                b = rand(ws[-1], scale=0.1) if ep.bias else None
                act, slope = ep.activation, ep.leaky_slope
                with torch.no_grad():
                    o = ops.kernel_operands(x, w, s, p, transposed=tr)
                    got = kernel(**o, bias=b, activation=act,
                                 leaky_slope=slope)
                    ref = plain(**o, bias=b, activation=act,
                                leaky_slope=slope)
                    torch.cuda.synchronize()
                    share = storage_share(got, ref)
                    err = (got.float() - ref.float()).abs().max().item()
                    out["errs"].setdefault(f"{name}_{dname}", []).append(err)
                    worst = max(worst, share)
                    ok = share <= 1 and got.dtype == dt and \
                        bool(torch.isfinite(got).all())
                    print(f"{name} {dname} train launch vs plain  "
                          f"{label:14s} [{route_of(o)}] max_abs_err "
                          f"{err:.3e}, worst output at {share:.4f} of the "
                          f"two-ulp tolerance {'ok' if ok else 'FAIL'}")
                    check(ok, f"{label} at {dname}: {name} disagrees with "
                              f"its plain version")
                    del got, ref
                    bnd, by = bound(o, b)[:2]
                    t = tot[part]
                    t["launches"] += launches
                    t["device_ms"] += launches * device_ms(
                        lambda: kernel(**o, bias=b, activation=act),
                        runs=timing["runs"])
                    t["bound_ms"] += launches * bnd
                    if by == "operations":
                        t["ops_bound_ms"] += launches * bnd
                del x, w, b, o
            for part, t in tot.items():
                t["bound_by"] = "operations" if t["ops_bound_ms"] >= \
                    t["bound_ms"] / 2 else "bytes"
                print(f"{model} {dname} train step, its {t['launches']} "
                      f"{part} launches: kernels {t['device_ms']:.4f} ms "
                      f"(device), bound {t['bound_ms']:.4f} ms "
                      f"({t['bound_by']}) [{card}]")
            out["geometries"][f"{model}_{dname}"] = dict(tot, worst_share=worst)
    torch.cuda.empty_cache()

    # -- 2. the main path: TrainLoop at bf16 and f16 --------------------------
    for name, model in models:
        kernel = gan[name][0]
        steps = MIXED_STEPS[model]
        out["launches"][name] = {}
        for dt in dtypes:
            dname = STORAGE_NAMES[dt]
            for k, _ in wrappers.values():
                k.launches = 0
                if hasattr(k, "launches_by_route"):
                    k.launches_by_route.clear()
                    k.launches_by_dtype.clear()
            with tempfile.TemporaryDirectory() as ckpt_dir:
                loop, nets = quickstart.train(
                    GanConfig(model, dtype=dname), steps=steps, batch=BATCH,
                    lr=4e-3, ckpt_dir=ckpt_dir, device=dev,
                    ckpt_every=steps, log_every=1)
                torch.cuda.synchronize()
                counts = {k: w[0].launches for k, w in wrappers.items()}
                by_dtype = dict(kernel.launches_by_dtype)
                by_route = dict(kernel.launches_by_route)
                restored = ckpt.restore(loop.state, ckpt_dir, steps)
            check(loop.steps == steps and loop.restarts == 0,
                  f"{model} {dname}: {loop.steps} steps, {loop.restarts} "
                  f"restarts")
            check(all(math.isfinite(v) for m in loop.metrics_history
                      for v in m.values()) and loop.metrics_history,
                  f"{model} {dname}: a loss is not finite")
            check(by_dtype == {dname: LAUNCHES_PER_STEP * steps}
                  and counts[name] == LAUNCHES_PER_STEP * steps
                  and all(c == 0 for k, c in counts.items() if k != name),
                  f"{model} {dname} training launched {counts}, by dtype "
                  f"{by_dtype}; expected {LAUNCHES_PER_STEP} of the "
                  f"{dname} instance a step")
            leaves = ckpt.tree_leaves(loop.state) + \
                ckpt.tree_leaves(restored)
            check(all(v.dtype == torch.float32 for v in leaves),
                  f"{model} {dname}: a parameter or checkpoint is not f32")
            out["launches"][name][dname] = counts[name]
            print(f"{model} {dname} training (TrainLoop, {steps} steps at "
                  f"batch {BATCH}, checkpoint f32): {counts[name]} {name} "
                  f"launches of the {dname} instance, by route {by_route}; "
                  f"losses {[round(m['loss'], 4) for m in loop.metrics_history]}")
            del loop, nets
    torch.cuda.empty_cache()

    # -- 3. the gradient gate; the reference's grad_rel ----------------------
    for dt in dtypes:
        dname = STORAGE_NAMES[dt]
        gate = out["gate"][f"dcgan_{dname}"] = grad_gate("dcgan", dname, dev,
                                                         BATCH)
        ok = all(gate["ratio"][n] <= PATH_ACCURACY for n in GRAD_GATED)

        def parts(r):
            return ", ".join(f"{n} {r[n]:.6f}" for n in GRAD_PARTS)
        print(f"dcgan {dname} gradient gate (one step, {gate['tensors']} "
              f"gradients, batch {BATCH}): ||g - g32|| / ||g_plain - g32|| "
              f"= {parts(gate['ratio'])} (gate {PATH_ACCURACY} on "
              f"{' and '.join(GRAD_GATED)}; {'ok' if ok else 'FAIL'}; not "
              f"gated: the worst tensor {gate['tensor_ratio']:.4f} at "
              f"{gate['tensor_worst']}, ||g - g_plain|| / ||g_plain - g32|| "
              f"{parts(gate['kernel_vs_plain'])}); ||g_plain - g32|| / "
              f"||g32|| = {parts(gate['plain_rel'])}; per layer "
              + ", ".join(f"{n} {r:.4f}" for n, r in gate["layers"].items()))
        check(ok, f"dcgan {dname}: the kernel step's gradients are less "
                  f"accurate than the plain step's ({gate['ratio']})")
        for layer, f in gate["faults"].items():
            seen = max(f["ratio"][n] for n in GRAD_GATED) > PATH_ACCURACY
            print(f"dcgan {dname} planted fault ({layer}'s dx summed in "
                  f"{dname}, {f['calls']} calls): {parts(f['ratio'])} "
                  f"({'exceeds' if seen else 'DOES NOT exceed'} the gate; "
                  f"{'required' if layer in GRAD_FAULT_SEEN else 'read'}); "
                  f"per layer " + ", ".join(
                      f"{n} {r:.4f}" for n, r in f["layers"].items()))
            check(seen or layer not in GRAD_FAULT_SEEN,
                  f"dcgan {dname}: the planted fault at {layer} passes the "
                  f"gradient gate ({f['ratio']})")
        for _, model in models:
            rel = calibration_grad_rel(model, dname, dev)
            ref_gate = model_tolerance(model, dname)["grad_rel"]
            out["calibration"][f"{model}_{dname}"] = dict(grad_rel=rel,
                                                          gate=ref_gate)
            print(f"{model} {dname} at the calibration configuration "
                  f"{CALIBRATION}: grad_rel {rel:.3e} (the reference's "
                  f"gate {ref_gate:g}) {'ok' if rel < ref_gate else 'FAIL'}")
            check(rel < ref_gate, f"{model} {dname}: grad_rel {rel:.3e} >= "
                                  f"{ref_gate:g}")
    torch.cuda.empty_cache()

    # -- 4. ms per step and peak memory --------------------------------------
    for model, warmup, runs in MIXED_TIMING:
        for dname in ("float32", "bfloat16", "float16"):
            step = _step_fn(*_train_nets(model, dev, dtype=dname))
            for _ in range(warmup):
                step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
            times = []
            for _ in range(runs):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                step()
                ev[1].record()
                ev[1].synchronize()
                times.append(ev[0].elapsed_time(ev[1]))
            peak = (torch.cuda.max_memory_allocated(dev) - before) / 1e9
            ms = statistics.median(times)
            out["steps"][f"{model}_{dname}"] = dict(step_ms=ms, peak_gb=peak,
                                                    steps_timed=runs)
            print(f"{model} train step at {dname}, batch {BATCH}: {ms:.3f} ms "
                  f"(median of {runs}); peak device memory of a step "
                  f"{peak:.3f} GB above the {before / 1e9:.3f} GB held "
                  f"[{card}]")
            del step
            torch.cuda.empty_cache()
    return out


# The tune phase (ROADMAP item 11): (model, storage dtype) of the
# generator plans warmed at batch BATCH, timed runs per candidate, and
# the phase's time limit
TUNE_WORK = (("dcgan", "float32"), ("dcgan", "bfloat16"),
             ("3dgan", "float32"))
TUNE_REPEATS = 3
TUNE_LIMIT_S = 120.0


def tune_phase(card, dev, wrappers) -> dict:
    """The autotuning planner on the card (ROADMAP item 11).

    1. For every generator layer of ``TUNE_WORK`` at batch ``BATCH``, each
       ``ganax`` candidate the tuner enumerates (kernel routes: tc tile
       widths and splits, narrow splits) against the plain version (1e-4
       at f32, STORAGE_TOL at bf16), on the layer's op with random
       inputs at the scale of the other phases (weights by fan-in^-1/2,
       so the outputs are of unit scale, as those gates assume; the
       tuner times on unit-normal weights, where outputs reach ~64).
    2. ``warm_gan_plans`` measures every candidate into a plan file in
       a temporary directory (its launches booked apart, as measurement
       launches); no candidate may fail (on the card a failed kernel
       candidate raises).  Prints each layer's winner and the heuristic
       route, each by the device time of its kernel launch (what the
       planner ranks) and by the whole op per call (a report).
    3. The programs rebuilt from the warm file with ``backend="auto"``
       and ``measure=True``: zero measurements, every layer tuned onto
       the kernel (``ganax``).
    4. The main path: one batch served through ``GanServer`` on each
       auto program, every count at 0 just before and read just after:
       the generator's 4 launches, all of the dtype's instance, each on
       the route its layer froze; against the heuristic path at 1e-4
       (f32) or against the f32 plain path by ``PATH_ACCURACY`` (bf16).
    The phase must end within ``TUNE_LIMIT_S``."""
    from repro_torch.core.dataflow import DataflowPolicy
    from repro_torch.device import platform_of
    from repro_torch.models.gan import GanConfig, init_gan
    from repro_torch.program import Program, ProgramSpec
    from repro_torch.serve.gan import GanServer
    from repro_torch.core import dataflow as tdf
    from repro_torch.tune import Planner, enumerate_candidates, warm_gan_plans
    t0 = time.perf_counter()
    platform = platform_of(dev)
    gan = {k: wrappers[k] for k in ("ganax_conv", "ganax_conv3d")}
    kernel_of = {"dcgan": "ganax_conv", "3dgan": "ganax_conv3d"}
    from repro_torch.kernels import ops
    out = {"candidates": {}, "layers": {}, "launches": {}, "serve": {}}
    # the served batches' launches (the main path), and the planner's
    # measurement launches apart
    launched = {name: {} for name in gan}
    measured = {name: {} for name in gan}

    def zero_counts():
        for k, _ in wrappers.values():
            k.launches = 0
            if hasattr(k, "launches_by_route"):
                k.launches_by_route.clear()
                k.launches_by_dtype.clear()

    def book(into):
        """The GANAX launches by kernel and dtype since ``zero_counts``,
        added to ``into``; every wrapper's count."""
        torch.cuda.synchronize()
        for name, (k, _) in gan.items():
            for dname, n in k.launches_by_dtype.items():
                into[name][dname] = into[name].get(dname, 0) + n
        return {name: k.launches for name, (k, _) in wrappers.items()}

    keys = {}
    for model, dname in TUNE_WORK:
        spec = ProgramSpec.build(GanConfig(model, dtype=dname), BATCH,
                                 "generator", policy=DataflowPolicy(),
                                 platform=platform)
        keys[model, dname] = spec.plan_keys()

    # -- 1. every kernel candidate against plain -----------------------------
    worst = 0.0
    gen = torch.Generator().manual_seed(97531)
    with torch.inference_mode():
        for (model, dname), layer_keys in keys.items():
            for lname, key in layer_keys:
                dt = STORAGE_DTYPES[dname]
                op = tdf.tconv if key.kind == "tconv" else tdf.conv
                x = torch.randn((key.batch, *key.in_spatial, key.cin),
                                generator=gen).to(dev, dt)
                w = (torch.randn((*key.kernel, key.cin, key.cout),
                                 generator=gen)
                     * (math.prod(key.kernel) * key.cin) ** -0.5
                     ).to(dev, dt)
                b = (0.1 * torch.randn((key.cout,), generator=gen)).to(dev)

                def run(backend, route=None):
                    return op(x, w, key.strides, key.paddings,
                              backend=backend, route=route,
                              bias=b if key.bias else None,
                              epilogue=key.epilogue)
                ref = run("ganax-plain")
                routes = []
                for cand in enumerate_candidates(key):
                    check(cand.backend == "ganax", f"tune: the card's pool "
                          f"holds {cand.describe()}")
                    got = run("ganax", cand.route)
                    torch.cuda.synchronize()
                    share = tol_share(got, ref) if dname == "float32" \
                        else storage_share(got, ref)
                    worst = max(worst, share)
                    routes.append((cand.route.describe(), share))
                    check(share <= 1 and bool(torch.isfinite(got).all()),
                          f"{model} {lname} {dname}: candidate "
                          f"{cand.describe()} disagrees with plain "
                          f"(worst output at {share:.3f} of its tolerance)")
                    del got
                out["candidates"][f"{model}_{dname}_{lname}"] = routes
                print(f"tune candidates {model} {lname} {dname}: "
                      f"{len(routes)} kernel routes vs plain, worst output "
                      f"at {max(r[1] for r in routes):.4f} of its tolerance "
                      f"({', '.join(r[0] for r in routes)})")
                del x, w, b, ref
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "plans.json"
        planner = Planner(path, warmup=1, repeats=TUNE_REPEATS)
        timings, op_times = {}, {}
        measure = planner.measure_candidates

        def spy(key, backends=None):
            op_times[key] = {}
            timings[key] = measure(key, backends, op_times=op_times[key])
            return timings[key]
        planner.measure_candidates = spy

        # -- 2. measure every candidate into the plan file -------------------
        zero_counts()
        for model, dname in TUNE_WORK:
            warm_gan_plans(GanConfig(model), BATCH, planner,
                           generator_only=True, dtype=dname,
                           platform=platform)
        book(measured)
        check(planner.failures == 0,
              f"tune: {planner.failures} candidates failed to run")
        for (model, dname), layer_keys in keys.items():
            for lname, key in layer_keys:
                plan = planner.lookup(key)
                t, op_t = timings[key], op_times[key]
                heur = next(iter(t))            # kernel_route's route
                win = next(c for c in t if c.backend == plan.backend
                           and c.route == plan.route)
                row = dict(winner=plan.describe(),
                           winner_us=plan.measured_us,
                           winner_op_us=op_t[win] * 1e6,
                           heuristic=heur.describe(),
                           heuristic_us=t[heur] * 1e6,
                           heuristic_op_us=op_t[heur] * 1e6,
                           candidates={c.describe(): v * 1e6
                                       for c, v in t.items()})
                out["layers"][f"{model}_{dname}_{lname}"] = row
                print(f"tune {model} {lname} {dname} at batch {BATCH}: "
                      f"winner {row['winner']} {row['winner_us']:.1f} us "
                      f"of device time a launch (whole op "
                      f"{row['winner_op_us']:.1f} us), heuristic "
                      f"{row['heuristic']} {row['heuristic_us']:.1f} us "
                      f"(whole op {row['heuristic_op_us']:.1f} us) "
                      f"({len(t)} candidates, median of {TUNE_REPEATS}) "
                      f"[{card}]")

        # -- 3. rebuilt from the warm file: zero measurements ---------------
        warm = Planner(path)
        progs = {}
        for model, dname in TUNE_WORK:
            progs[model, dname] = Program.build(
                GanConfig(model, dtype=dname), BATCH,
                policy=DataflowPolicy(backend="auto"), planner=warm,
                measure=True, device=dev, differentiable=False)
        check(warm.measurements == 0 and len(warm) == len(planner),
              f"tune: the warm plan file loaded {len(warm)} of "
              f"{len(planner)} plans and took {warm.measurements} "
              f"measurements")
        check(all(le.source == "tuned" and le.backend == "ganax"
                  for p in progs.values() for le in p.spec.layers),
              "tune: a layer was not tuned onto the kernel: " + "; ".join(
                  p.spec.summary() for p in progs.values()))
        print(f"tune: programs rebuilt from the warm plan file ({len(warm)} "
              f"plans) with {warm.measurements} measurements: "
              + "; ".join(f"{m} {dn} {p.spec.summary()}"
                          for (m, dn), p in progs.items()))

    # -- 4. one batch through GanServer on the auto programs ----------------
    for (model, dname), prog in progs.items():
        g, _ = init_gan(GanConfig(model), torch.Generator().manual_seed(0),
                        device=dev)
        cfg = GanConfig(model, dtype=dname)
        tuned = GanServer(cfg, g, batch_size=BATCH, seed=0, program=prog,
                          device=dev)
        heuristic = GanServer(cfg, g, batch_size=BATCH, seed=0, device=dev)
        # -- the main path: one served batch, its launches and routes -------
        nd = len(prog.spec.layers[0].kernel)
        kernel, plain = ops._KERNELS[nd]
        routes = []

        def spy_kernel(*a, route=None, **k):
            routes.append(route)
            return kernel(*a, route=route, **k)
        ops._KERNELS[nd] = (spy_kernel, plain)
        try:
            zero_counts()
            img = tuned.generate(BATCH)
            counts = book(launched)
        finally:
            ops._KERNELS[nd] = (kernel, plain)
        frozen = [le.route for le in prog.spec.layers]
        by_dtype = dict(gan[kernel_of[model]][0].launches_by_dtype)
        check(by_dtype == {dname: len(frozen)}
              and counts[kernel_of[model]] == len(frozen)
              and all(c == 0 for k, c in counts.items()
                      if k != kernel_of[model])
              and [r and r.describe() for r in routes]
              == [r.describe() for r in frozen],
              f"tune {model} {dname}: the served batch launched {counts}, "
              f"by dtype {by_dtype}, on routes "
              f"{[r and r.describe() for r in routes]}; expected "
              f"{len(frozen)} launches of the {dname} instance on "
              f"{[r.describe() for r in frozen]}")
        print(f"tune {model} {dname}: the served batch launched "
              f"{len(routes)} {kernel_of[model]} kernels of the {dname} "
              f"instance on the frozen routes "
              f"{[r.describe() for r in routes]}")
        if dname == "float32":
            ref = heuristic.generate(BATCH)
            err, ok = max_err(img, ref)
            row = dict(max_abs_err=err)
            print(f"tune {model} {dname}: GanServer on the auto program vs "
                  f"the heuristic path, max_abs_err {err:.3e} "
                  f"(atol=rtol={ATOL:g}) {'ok' if ok else 'FAIL'}")
        else:
            plain_cfg = GanConfig(model, backend="ganax-plain")
            img32 = GanServer(plain_cfg, g, batch_size=BATCH, seed=0,
                              device=dev).generate(BATCH).double()
            plain = GanServer(plain_cfg, g, batch_size=BATCH, seed=0,
                              dtype=dname, device=dev).generate(BATCH)
            ratio = (img.double() - img32).norm().item() / \
                (plain.double() - img32).norm().item()
            ok = ratio <= PATH_ACCURACY
            row = dict(accuracy_ratio=ratio)
            print(f"tune {model} {dname}: GanServer on the auto program, "
                  f"||img - f32|| / ||plain - f32|| = {ratio:.4f} (gate "
                  f"{PATH_ACCURACY}) {'ok' if ok else 'FAIL'}")
        check(ok, f"tune {model} {dname}: the auto program's images "
                  f"disagree with the heuristic path")
        # the generator forward on the tuned and the heuristic plans, in
        # turns (heuristic, tuned, tuned, heuristic)
        z = torch.randn((BATCH, cfg.z_dim), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
        ms = {"heuristic": [], "tuned": []}
        for which in ("heuristic", "tuned", "tuned", "heuristic"):
            srv = tuned if which == "tuned" else heuristic
            ms[which].append(time_ms(lambda: srv.generator(z), warmup=2,
                                     runs=10))
        row.update(generator_ms={k: v for k, v in ms.items()})
        print(f"tune {model} {dname}: generator forward at batch {BATCH}, "
              f"heuristic plans {ms['heuristic']} ms, tuned plans "
              f"{ms['tuned']} ms (medians of 10, in turns) [{card}]")
        out["serve"][f"{model}_{dname}"] = row
        del tuned, heuristic
    seconds = time.perf_counter() - t0
    out.update(launches=launched, measure_launches=measured,
               seconds=seconds, worst_share=worst,
               failures=planner.failures,
               measurements=planner.measurements)
    print(f"tune main path (the served batches): launches by kernel and "
          f"dtype {launched}; measurement launches apart {measured}; "
          f"{planner.measurements} measurements, {planner.failures} failed "
          f"candidates; phase {seconds:.1f} s (limit {TUNE_LIMIT_S:g})")
    check(seconds < TUNE_LIMIT_S, f"tune: {seconds:.1f} s >= "
                                  f"{TUNE_LIMIT_S:g} s")
    return out


# The mesh phase (ROADMAP item 12): programs sharded over MESH_WORLD gloo
# ranks that share cuda:0 (NCCL refuses two ranks on one card), started by
# the port's launcher, each case held against the one-device path from the
# same parameters and inputs; then the NCCL path in a world of one.
MESH_WORLD = 2
# (model, mesh, storage dtype) of the sharded generator forwards
MESH_FORWARDS = (("dcgan", (2, 1), "float32"), ("dcgan", (1, 2), "float32"),
                 ("3dgan", (1, 2), "float32"), ("dcgan", (1, 2), "bfloat16"))
# each sharded forward timed over this many more calls (two ranks on one
# card: a wall time, never a speed-up)
MESH_TIMED = 5
# the train step's meshes, its lr, and the tolerances of the reference's
# data-parallel step test (tests/test_sharded_gan.py:315-345)
MESH_TRAIN = ((2, 1), (1, 2))
MESH_LR = 0.05
MESH_TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
# GanEngine at (2, 1): its buckets, and requests (one at a time) that run
# both
MESH_ENGINE_BUCKETS = (32, 64)
MESH_ENGINE_REQUESTS = (20, 64, 40, 100, 9)
# the ring matmuls: (m, k, n) a rank
MESH_RING = (256, 256, 256)
KERNEL_OF = {"dcgan": "ganax_conv", "3dgan": "ganax_conv3d"}
# The sequence-sharded decode (RunFlags(mesh=(2, 1), seq_shard_decode=True))
# of full-width Qwen1.5-32B cut to MESH_DECODE_LAYERS of its 64 layers,
# random weights from seed 0 conditioned (``condition``; at the
# reference's init the scores reach hundreds, where the two GEMM shapes'
# last-bit differences move p by 1e-5: on one H100 the f32 flash-decode
# outputs read 3.6e-5 in norm, 368 times the elementwise 2e-5): a cache of
# MESH_DECODE_ROWS rows a slot, its rows split evenly over the data ranks,
# filled by one-device prefills of prompts of MESH_DECODE_LENS tokens
# (straddling the split, so the owner's write and the combine run on
# both ranks), then MESH_DECODE_STEPS steps of a fixed token stream; at
# bf16 and at f32, with an int8 and a bf16 (f32 at f32) cache, against
# the one-device decode_step of the same model.  Gates:
# * in f32, each global layer's flash_decode output against the
#   one-device decode_attention on the rank's own layer inputs
#   (parity.attention_oracle) at the reference's flash-decode tolerance,
#   atol = rtol = 2e-5 (tests/test_distributed.py); in bf16 the same
#   read;
# * the logits of every step, ||a - b|| / ||b|| against the one-device
#   steps: MESH_DECODE_TOL (f32: the f32 checks' 1e-4; bf16: the bf16
#   gate on conditioned weights, 3e-2);
# * a planted fault, the partials summed without their rescaling to the
#   global max (``no corr``), above both at each dtype;
# * 3 all_reduce calls a global layer a step on every rank.
MESH_DECODE_LAYERS = 4
MESH_DECODE_ROWS = 4096
MESH_DECODE_LENS = (1000, 3000)
MESH_DECODE_STEPS = 4
MESH_ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
MESH_DECODE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


# The dense transformer on the mesh (ROADMAP item 23, parts 3-4), on the
# same two gloo ranks, each case against the one-device path on the same
# weights and inputs, the one-device references run before the ranks
# start (the reshard's after them: it starts from the ranks' checkpoint).
# (a) Training full-width Gemma3-4B cut to its first MESH_LM_LAYERS layers
#     (one 5:1 group: 5 windowed layers of window 1024 and the global
#     one), MESH_LM_BATCH tokens, through make_train_step with the
#     build_cell shardings (Rules(fsdp=True) masters, the TP-only compute
#     copy), weights drawn from seed 0 and conditioned (parity.condition:
#     at the reference's init a last-bit change of the forward moves the
#     gradients by 1e-4 of their norm).  AdamW at MESH_LM_OPT, its clip
#     set to half the first one-device gradient norm (the clip binds) and
#     its eps to the RMS of the clipped gradient (at 1e-8 a gradient
#     element at rounding level turns into a +-lr step, which no
#     tolerance on the parameters holds).  f32: MESH_LM_STEPS steps at
#     (2, 1) and (1, 2); loss and grad_norm at rtol MESH_LM_TOL and each
#     leaf's update ||a - b|| / ||b|| within it, the f32 checks' 1e-4.
#     bf16: one step at (1, 2), the same reading within GRAD_TOL_BF16,
#     the gradient gate of llm_train for conditioned weights.  The planted
#     faults of parity.FAULTS (wo's partials not summed over model; the
#     norm of each rank's blocks only; the gradients summed, not averaged,
#     over data), one step each, must read MESH_FAULT_RATIO times the
#     tolerance or more.
# (b) Qwen1.5-32B at full width, MESH_DECODE_LAYERS layers, bf16,
#     conditioned: the TP prefill's last logits of the MESH_DECODE_LENS
#     prompts at (1, 2) (20 of the 40 heads a rank); MESH_DECODE_STEPS
#     steps of the TP decode at (1, 2) from bf16 and int8 caches of
#     MESH_DECODE_ROWS rows and of the batch-sharded decode at (2, 1)
#     (one slot a rank); each at MESH_TP_TOL, wo's partials not summed
#     and the lengths not cut to a rank's slots planted above it.
# (c) Gemma3-4B's MESH_LM_LAYERS layers under seq_shard_decode at (2, 1),
#     MESH_SWA_ROWS rows a slot (half a rank), prompts of MESH_SWA_LENS
#     tokens: at 3500 the window's live rows (2477-3500) all lie on rank
#     1, at 1000 (and the steps after) all on rank 0, so each rank holds a
#     slot with no live row; f32 and bf16, against the one-device
#     decode_step and each layer's attention against attention_oracle at
#     MESH_ATTN_TOL (f32), "no corr" planted.
# (d) The reshard: (a)'s (2, 1) f32 state saved after its first step,
#     restored at (1, 2) and on one device, each equal bit for bit to the
#     saved arrays; the next step at (1, 2) held as (a)'s against the
#     one-device step 2.
MESH_LM_LAYERS = 6
MESH_LM_BATCH = (2, 2048)
MESH_LM_STEPS = 2
MESH_LM_OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
MESH_LM_TOL = {"float32": 1e-4, "bfloat16": GRAD_TOL_BF16}
MESH_FAULT_RATIO = 10.0
# (b)'s gate on the bf16 logits, ||a - b|| / ||b|| against one device:
# on an H100 the sound cases read 4.8e-3 to 6.7e-3 and the planted faults
# 6.1e-2 to 8.6e-2, so MESH_DECODE_TOL's 3e-2 held a fault by 2.0-2.9x
# only; 1.5e-2 lies between the two, 2.2x above the sound readings and
# 4x below the faults'
MESH_TP_TOL = 1.5e-2
MESH_LM_FAULTS = (("wo not summed", (1, 2)), ("local norm", (1, 2)),
                  ("grads summed", (2, 1)))
MESH_SWA_ROWS = 4096
MESH_SWA_LENS = (1000, 3500)
# (e) TrainLoop on the mesh and the train CLI's --mesh, at the restart
#     demo's width (elastic_restart.RESHARD_CFG, f32): MESH_LOOP_STEPS
#     steps of MESH_LOOP_BATCH tokens at (2, 1), checkpoints every step
#     (the blocks gathered, rank 0 writing), once uninterrupted and once
#     failed at step 1 (every rank restoring its blocks): the two states
#     within the restart demo's 1e-5; then ``python -m
#     repro_torch.launch.train --preset tiny --mesh 1,2`` on the ranks,
#     MESH_CLI_STEPS steps, checkpoints at half of them and at the end.
MESH_LOOP_STEPS = 3
MESH_LOOP_BATCH = (4, 32)
MESH_CLI_STEPS = 4


def mesh_clip_opt(dev, cfg, batch: dict) -> tuple[dict, float]:
    """``(MESH_LM_OPT with grad_clip and eps, the first gradient norm)``:
    the clip half the first one-device gradient norm (it binds), eps the
    RMS of the clipped gradient (at 1e-8 a gradient element at rounding
    level turns into a +-lr step), from the conditioned seed-0 masters
    on ``batch``."""
    from repro_torch.models import transformer as tr
    from repro_torch.train.optimizer import AdamWConfig, global_norm
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step)
    state = init_train_state(cfg, torch.Generator(dev).manual_seed(0))
    condition(state["params"], cfg.d_model)
    _, _, grads = make_train_step(cfg, AdamWConfig(), tr.RunFlags()) \
        .value_and_grad(state["params"],
                        {k: v.to(dev) for k, v in batch.items()})
    norm = float(global_norm(grads))
    del grads, state
    clip = norm / 2
    return dict(MESH_LM_OPT, grad_clip=clip,
                eps=clip / math.sqrt(tr.count_params(cfg))), norm


def mesh_lm_references(dev, tmp: str, cfg, batches: list) -> dict:
    """(a)'s one-device runs before the ranks start: the optimizer's clip
    and eps from the first gradient norm (:func:`mesh_clip_opt`), the
    f32 steps and the bf16 step from the conditioned seed-0 masters,
    their metrics, and the parameters after them saved in ``tmp``
    (``ref_float32``, ``ref_bfloat16``) for the ranks to read their
    blocks of."""
    from repro_torch.models import transformer as tr
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step)

    def state_of(c):
        state = init_train_state(c, torch.Generator(dev).manual_seed(0))
        condition(state["params"], c.d_model)
        return state
    opt, norm = mesh_clip_opt(dev, cfg, batches[0])
    out = {"opt": opt, "norm0": norm, "metrics": {}}
    for dt, steps in (("float32", MESH_LM_STEPS), ("bfloat16", 1)):
        c = dataclasses.replace(cfg, dtype=dt)
        state = state_of(c)
        step = make_train_step(c, AdamWConfig(**opt), tr.RunFlags())
        metrics = []
        for b in batches[:steps]:
            _, m = step(state, {k: v.to(dev) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        out["metrics"][dt] = metrics
        ckpt.save(state["params"], os.path.join(tmp, f"ref_{dt}"), steps)
        del state, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def mesh_lm_cases(dev, tmp: str, gen, train_cfg, qcfg, decode_rows: int,
                  decode_lens, swa_rows: int, swa_lens) -> tuple[list,
                                                                  dict]:
    """(a)-(d)'s cases for the ranks, and the one-device references run
    here before they start (see MESH_LM_*)."""
    from repro_torch.models import transformer as tr
    from repro_torch.sharding import parity
    b, s = MESH_LM_BATCH if train_cfg.d_model > 1024 else (2, 128)
    batches = [{"tokens": torch.randint(0, train_cfg.vocab, (b, s),
                                        generator=gen).int()}
               for _ in range(MESH_LM_STEPS)]
    refs = mesh_lm_references(dev, tmp, train_cfg, batches)
    cfg32 = dataclasses.asdict(dataclasses.replace(train_cfg,
                                                   dtype="float32"))
    train = dict(kind="lm_train", seed=0, condition=True,
                 opt=refs["opt"], batches=batches)
    cases = [
        dict(train, name="lm f32 2x1", mesh=(2, 1), cfg=cfg32,
             ref_dir=f"{tmp}/ref_float32",
             save_dir=f"{tmp}/saved", save_at=0),
        dict(train, name="lm f32 1x2", mesh=(1, 2), cfg=cfg32,
             ref_dir=f"{tmp}/ref_float32"),
        dict(train, name="lm bf16 1x2", mesh=(1, 2), batches=batches[:1],
             cfg=dataclasses.asdict(dataclasses.replace(
                 train_cfg, dtype="bfloat16")),
             ref_dir=f"{tmp}/ref_bfloat16")]
    cases += [dict(train, name=f"lm fault {fault}", mesh=mesh, cfg=cfg32,
                   batches=batches[:1], fault=fault)
              for fault, mesh in MESH_LM_FAULTS]
    cases.append(dict(train, kind="reshard", name="lm reshard 1x2",
                      mesh=(1, 2), cfg=cfg32, from_dir=f"{tmp}/saved",
                      ref_dir=f"{tmp}/ref_float32"))
    cases += mesh_loop_cases(dev, tmp)
    # (b): Qwen's TP prefill and the decodes on a mesh
    q16 = dataclasses.replace(qcfg, dtype="bfloat16")
    prompts = [torch.randint(0, qcfg.vocab, (n,), generator=gen).tolist()
               for n in decode_lens]
    params = tr.init(q16, torch.Generator(dev).manual_seed(0))
    parity.condition(params, q16.d_model)
    with torch.no_grad():
        refs["prefill"] = [tr.forward(params, {"tokens": torch.tensor(
            p, device=dev)[None]}, q16, mode="prefill",
            last_logit_only=True)[0][0, -1].float().cpu() for p in prompts]
    prefill = dict(kind="lm_prefill", mesh=(1, 2), seed=0, condition=True,
                   cfg=dataclasses.asdict(q16), prompts=prompts)
    cases += [dict(prefill, name="lm prefill 1x2"),
              dict(prefill, name="lm prefill 1x2 wo not summed",
                   fault="wo not summed")]
    dtoks = torch.randint(0, qcfg.vocab, (MESH_DECODE_STEPS, 2, 1),
                          generator=gen)
    decode = dict(kind="lm_decode", seq_shard=False, seed=0, condition=True,
                  cfg=dataclasses.asdict(q16), prompts=prompts,
                  max_len=decode_rows, tokens=dtoks,
                  lengths=torch.tensor(decode_lens), drop_cache=True)
    dcases = [dict(decode, name=f"lm decode {kvd} 1x2{' ' + f if f else ''}",
                   mesh=(1, 2), kv_dtype=kvd, **({"fault": f} if f else {}))
              for kvd, f in (("bf16", None), ("int8", None),
                             ("bf16", "wo not summed"))]
    dcases += [dict(decode, name=f"lm decode bf16 2x1{' ' + f if f else ''}",
                    mesh=(2, 1), kv_dtype="bf16",
                    **({"fault": f} if f else {}))
               for f in (None, "lengths not cut")]
    refs["decode"] = {}
    memo: dict = {"params": {}}
    for case in dcases:
        key = case["kv_dtype"]
        if key in refs["decode"]:
            continue
        c, p_, cache, tokens, lengths = parity.decode_inputs(case, dev, memo)
        with torch.no_grad():
            refs["decode"][key] = torch.stack([
                tr.decode_step(p_, cache, tokens[i], lengths + i, c)[0]
                .float().cpu() for i in range(tokens.shape[0])])
        del cache
    del params, memo
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cases += dcases
    # (c): the windowed layers under seq_shard_decode
    swa = [torch.randint(0, train_cfg.vocab, (n,), generator=gen).tolist()
           for n in swa_lens]
    stoks = torch.randint(0, train_cfg.vocab, (MESH_DECODE_STEPS, 2, 1),
                          generator=gen)
    refs["swa"] = [dict(
        name=f"decode swa {dt}{' no corr' if fault else ''}", kind="decode",
        mesh=(MESH_WORLD, 1), seed=0, condition=True,
        cfg=dataclasses.asdict(dataclasses.replace(train_cfg, dtype=dt)),
        prompts=swa, max_len=swa_rows, kv_dtype="bf16", tokens=stoks,
        lengths=torch.tensor(swa_lens), **({"fault": "no corr"}
                                           if fault else {}))
        for dt, fault in (("float32", False), ("bfloat16", False),
                          ("float32", True))]
    cases += refs["swa"]
    refs.update(batches=batches, q_heads=qcfg.n_heads,
                q_hd=qcfg.resolved_head_dim, prompt_lens=tuple(decode_lens))
    return cases, refs


# MLA, MoE, SSM and hybrid layers on the mesh, on the
# same two gloo ranks, each case against the one-device path on the same
# seed-0 weights (parity.condition) and inputs, the one-device runs
# before the ranks start; each config at full width, its layers cut to
# MESH_FAMILIES' "layers" (the f32 training state reckoned from the
# config: MiniCPM3's 4 layers 0.63 B parameters, OLMoE's 2 layers 1.05 B
# (4 would be 1.9 B, ~36 GB a rank at (2, 1), too much for two ranks on
# one card), Scout's 2 layers 6.5 B (bf16 serving only, 12.9 GB),
# Mamba2's 4 layers 0.42 B, Hymba's 4 layers 0.30 B: global layer 0,
# three windowed):
# * f32 training (MESH_LM_STEPS steps of MESH_FAM_BATCH tokens, or one
#   for a planted fault) at each of "train", bf16 (one step at (1, 2))
#   where "bf16", held as (a)'s Gemma3 (loss and grad_norm, each leaf's
#   update: MESH_LM_TOL; the SSM's A_log, D and dt_bias:
#   MESH_ILL_FACTOR times it), the
#   MoE aux losses at MESH_AUX_TOL, OLMoE's
#   routing of every layer in the first forward bit for bit the
#   one-device routing (expert ids, places, kept pairs);
# * the TP prefill at (1, 2) in bf16: each rank's vocab columns of the
#   last logits of the MESH_FAM_LENS prompts (Hymba: MESH_SWA_LENS; the
#   MoE configs': cut to multiples of 256, 768 and 2816) at
#   MESH_TP_TOL; every rank's flash calls over its own heads (MiniCPM3
#   20 at (96, 64), OLMoE 8 and Scout 20 at (128, 128), Hymba 13 padded
#   at (64, 64)) on the wgmma instance;
# * MESH_DECODE_STEPS bf16 decode steps from a cache of MESH_FAM_ROWS
#   rows a slot filled by one-device prefills of the prompts: the TP
#   decode at (1, 2) and the batch-sharded one at (2, 1) (OLMoE's and
#   Scout's one routing group across the data ranks) at MESH_TP_TOL;
#   seq_shard_decode at (2, 1) at MESH_DECODE_TOL (Hymba's windowed
#   layers with one rank holding no live row of a slot; Mamba2's state
#   replicated);
# * Mamba2's reshard: its f32 (2, 1) state saved after step 1, restored
#   at (1, 2) and on one device bit for bit, step 2 from it as (a)'s;
# * the planted faults, one step each, each at least MESH_FAM_FAULT_RATIO
#   times its gate (loss and grad_norm against the one-device step;
#   MiniCPM3's and Hymba's, whose loss moves least, each leaf's update
#   too): the MoE combine not summed over model, q_norm's
#   RMS over half
#   of q_lora, the SSM gated norm over half of d_inner, aux_lb as the
#   mean of the data ranks' products (read on aux_lb against
#   MESH_AUX_TOL), the pad head kept (a rank's last n padded heads taken
#   for its n real ones), and on Scout's TP prefill the combine not
#   summed.
MESH_FAMILIES = {
    "minicpm3-4b": dict(layers=4, train=((2, 1), (1, 2)), bf16=True,
                        fault_updates=True, decode=((1, 2), (2, 1)),
                        seq=("bfloat16", "float32"),
                        faults=(("q_norm over a half", (1, 2)),)),
    "olmoe-1b-7b": dict(layers=2, train=((2, 1), (1, 2)), routing=True,
                        decode=((1, 2), (2, 1)), seq=("bfloat16",),
                        faults=(("moe combine not summed", (1, 2)),
                                ("aux_lb mean of products", (2, 1)))),
    "llama4-scout-17b-a16e": dict(layers=2, decode=((1, 2), (2, 1)),
                                  prefill_faults=("moe combine not summed",
                                                  )),
    "mamba2-2.7b": dict(layers=4, train=((2, 1), (1, 2)), bf16=True,
                        reshard=True, decode=((1, 2),), seq=("bfloat16",),
                        faults=(("ssm norm over a half", (1, 2)),)),
    "hymba-1.5b": dict(layers=4, global_layers=(0,), train=((1, 2),),
                       fault_updates=True, decode=((1, 2),),
                       seq=("bfloat16",), lens="swa",
                       faults=(("pad head kept", (1, 2)),))}
MESH_FAM_BATCH = (2, 2048)
MESH_FAM_ROWS = 4096
MESH_FAM_LENS = (1000, 3000)
MESH_AUX_TOL = 1e-6
MESH_FAM_FAULT_RATIO = 4.0
# The SSM's per-head scalars A_log, D and dt_bias: each one's gradient
# is a sum over every token of the batch whose terms cancel
# (tests/test_torch_ssm.py holds A_log and dt_bias to float64 only), so
# a TP rank's last-bit changes of the forward move their updates by far
# more than a matrix's (rehearsed on the CPU at a shrunken width:
# Hymba's A_log 4.9e-5 at (2, 1) and 1.3e-4 at (1, 2) in f32; on the
# H100, Mamba2's D 5.5e-2 in bf16 at (1, 2), PERF.md); their updates
# are gated at MESH_ILL_FACTOR times the dtype's MESH_LM_TOL and
# printed apart, every other leaf at MESH_LM_TOL
MESH_ILL_LEAVES = ("A_log", "D", "dt_bias")
MESH_ILL_FACTOR = 10.0
# A bf16 leaf whose update differs from one device's bf16 update by more
# than its gate passes if the mesh's lands no farther from the
# one-device f32 step than MESH_BF16_EXACT times one device's bf16 step
# does (as exact as one device; on the H100 Mamba2's ln_mix at bf16
# moved 4.2e-2 from one device's, PERF.md)
MESH_BF16_EXACT = 2.0


def mesh_family_cfg(name: str, plan: dict):
    """The family's config at full width, its layers cut as ``plan``
    says."""
    from repro_torch.configs.base import get_config
    over = {"n_layers": plan["layers"]}
    if "global_layers" in plan:
        over["global_layers"] = plan["global_layers"]
    return dataclasses.replace(get_config(name), **over)


def mesh_family_cases(dev, tmp: str, gen, cfgs: dict | None = None,
                      batch=MESH_FAM_BATCH, rows: int = MESH_FAM_ROWS,
                      lens=MESH_FAM_LENS, swa_lens=MESH_SWA_LENS
                      ) -> tuple[list, dict]:
    """The MESH_FAMILIES cases for the ranks and the one-device runs of
    the prefill and decode cases, run here before the ranks start (the
    training cases' run on the ranks: ``parity``'s ``one_device``);
    ``cfgs`` (name -> config), ``batch``, ``rows`` and the prompt lengths
    cut them down on the CPU."""
    from repro_torch.models import transformer as tr
    from repro_torch.sharding import parity
    cases, refs = [], {}
    for name, plan in MESH_FAMILIES.items():
        cfg = (cfgs or {}).get(name) or mesh_family_cfg(name, plan)
        sub = os.path.join(tmp, name)
        os.makedirs(sub, exist_ok=True)
        ref = refs[name] = {"cfg": cfg, "plan": plan}
        flens = swa_lens if plan.get("lens") == "swa" else lens
        if cfg.moe:
            # MoE routing groups of 256 tokens must divide a prompt (the
            # reference asserts): each length cut to a multiple of 256
            flens = [n if n <= 256 else n - n % 256 for n in flens]
        ref["lens"] = tuple(flens)
        t0 = time.perf_counter()
        if plan.get("train"):
            batches = [{"tokens": torch.randint(0, cfg.vocab, batch,
                                                generator=gen).int()}
                       for _ in range(MESH_LM_STEPS)]
            opt, norm = mesh_clip_opt(dev, cfg, batches[0])
            ref["train"] = {"opt": opt, "norm0": norm}
            cfg32 = dataclasses.asdict(dataclasses.replace(
                cfg, dtype="float32"))
            # each rank runs the one-device steps it is held against
            # itself, once a config (parity's one_device, kept on its
            # host): the references as checkpoints would write 23 GB to a
            # disk the card's machine meters at 45 GiB a call, and kept
            # on the card here they crowd the card the ranks use
            train = dict(kind="lm_train", seed=0, condition=True, opt=opt,
                         batches=batches,
                         one_device={"steps": MESH_LM_STEPS, "key": name})
            for mesh in plan["train"]:
                case = dict(train, name=f"fam {name} f32 {mesh[0]}x{mesh[1]}",
                            mesh=mesh, cfg=cfg32)
                if plan.get("reshard") and mesh == (2, 1):
                    case.update(save_dir=f"{sub}/saved", save_at=0)
                cases.append(case)
            if plan.get("bf16"):
                cases.append(dict(
                    train, name=f"fam {name} bf16 1x2", mesh=(1, 2),
                    batches=batches[:1],
                    one_device={"steps": 1, "f32_steps": 1, "key": name},
                    cfg=dataclasses.asdict(dataclasses.replace(
                        cfg, dtype="bfloat16"))))
            cases += [dict(train, name=f"fam {name} fault {fault}",
                           mesh=mesh, cfg=cfg32, batches=batches[:1],
                           fault=fault, one_device={"steps": 1, "key": name}
                           if plan.get("fault_updates") else None)
                      for fault, mesh in plan.get("faults", ())]
            if plan.get("reshard"):
                cases.append(dict(
                    train, kind="reshard", name=f"fam {name} reshard 1x2",
                    mesh=(1, 2), cfg=cfg32, from_dir=f"{sub}/saved"))
        # the TP prefill and the decodes, in bf16
        c16 = dataclasses.replace(cfg, dtype="bfloat16")
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist()
                   for n in flens]
        params = tr.init(c16, torch.Generator(dev).manual_seed(0))
        parity.condition(params, c16.d_model)
        with torch.no_grad():
            ref["prefill"] = [tr.forward(params, {"tokens": torch.tensor(
                p, device=dev)[None]}, c16, mode="prefill",
                last_logit_only=True)[0][0, -1].float().cpu()
                for p in prompts]
        del params
        prefill = dict(kind="lm_prefill", mesh=(1, 2), seed=0,
                       condition=True, cfg=dataclasses.asdict(c16),
                       prompts=prompts)
        cases.append(dict(prefill, name=f"fam {name} prefill 1x2"))
        cases += [dict(prefill, name=f"fam {name} prefill 1x2 {fault}",
                       fault=fault)
                  for fault in plan.get("prefill_faults", ())]
        dtoks = torch.randint(0, cfg.vocab, (MESH_DECODE_STEPS, 2, 1),
                              generator=gen)
        decode = dict(seed=0, condition=True, prompts=prompts, max_len=rows,
                      kv_dtype="bf16", tokens=dtoks,
                      lengths=torch.tensor(flens), drop_cache=True)
        dcases = [dict(decode, kind="lm_decode", seq_shard=False,
                       name=f"fam {name} decode {m[0]}x{m[1]}", mesh=m,
                       cfg=dataclasses.asdict(c16))
                  for m in plan["decode"]]
        dcases += [dict(decode, kind="decode", mesh=(2, 1),
                        name=f"fam {name} seq decode {dt}",
                        cfg=dataclasses.asdict(dataclasses.replace(
                            cfg, dtype=dt)))
                   for dt in plan.get("seq", ())]
        ref["decode"] = {}
        memo: dict = {}
        for case in dcases:
            dt = case["cfg"]["dtype"]
            if dt in ref["decode"]:
                continue
            c, p_, cache, tokens, lengths = parity.decode_inputs(case, dev,
                                                                 memo)
            with torch.no_grad():
                ref["decode"][dt] = torch.stack([
                    tr.decode_step(p_, cache, tokens[i], lengths + i, c)[0]
                    .float().cpu() for i in range(tokens.shape[0])])
            del cache, p_
        memo.clear()
        cases += dcases
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        print(f"mesh {name}: the one-device references in "
              f"{time.perf_counter() - t0:.1f} s")
    return cases, refs


def mesh_family_check(card: str, dev, refs: dict, ranks: list,
                      tmp: str) -> dict:
    """The ranks' MESH_FAMILIES cases against the one-device runs (see
    MESH_FAMILIES): every gate, every planted fault's factor over its
    gate, each rank's flash launches by (dtype, dk, dv) and heads a call,
    its collectives and peak memory beside the reckoned state; one
    launch at each new rank geometry timed alone beside SDPA."""
    from repro_torch.models import transformer as tr
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_state import init_train_state
    on_card = dev.type == "cuda"
    out = {}

    def launches(res):
        return {f"{k.removeprefix('flash_attention_')} {g}": v
                for k, geo in res["flash_launches"].items()
                for g, v in geo.items()}

    def flash_layers(cfg):
        return sum(rep for descs, rep in cfg.layer_segments()
                   for d in descs if d.mixer != "ssm"
                   and not (d.window and cfg.causal))

    for name, ref in refs.items():
        cfg, plan = ref["cfg"], ref["plan"]
        row = out[name] = {}
        n = tr.count_params(cfg)
        hq = cfg.n_heads
        heads = -(-hq // 2) if hq else 0
        dk = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) if cfg.mla \
            else cfg.resolved_head_dim
        dv = cfg.v_head_dim if cfg.mla else dk
        n_flash = flash_layers(cfg)

        def read(case, mesh, dt, steps, first=0, want_from=None,
                 rank_check=True):
            """Each rank's case against the one-device steps
            ``first + 0..steps-1`` the rank ran itself (``one_device``:
            the case's, or ``want_from``'s)."""
            tol = MESH_LM_TOL[dt]
            worst = {}

            def gate(path):
                """A leaf's gate: the tolerance, MESH_ILL_FACTOR times it
                for the SSM's per-head scalars."""
                return MESH_ILL_FACTOR * tol \
                    if path.rsplit("::", 1)[-1] in MESH_ILL_LEAVES else tol

            def shares(res):
                """Each leaf's reading over its gate; at bf16 the smaller
                of that and its distance from the f32 step over
                MESH_BF16_EXACT times one device's bf16 step's."""
                two = res.get("updates2", {})
                exact = res.get("one_device", {}).get("exact", {})
                out_ = {}
                for path, (a, b) in res.get("updates", {}).items():
                    if b <= 0:
                        continue
                    share = math.sqrt(a / b) / gate(path)
                    if dt == "bfloat16" and path in two and exact.get(path):
                        a2, b2 = two[path]
                        share = min(share, math.sqrt(a2 / b2)
                                    / (MESH_BF16_EXACT * exact[path]))
                    out_[path] = share
                return out_
            for r, rank in enumerate(ranks):
                res = rank[case]
                want = rank[want_from or case]["one_device"]["metrics"][
                    first:first + steps]
                rel = max(abs(g[k] - w[k]) / abs(w[k])
                          for g, w in zip(res["metrics"], want, strict=True)
                          for k in ("loss", "grad_norm"))
                aux = max([abs(g[k] - w[k]) / abs(w[k])
                           for g, w in zip(res["metrics"], want)
                           for k in ("aux_lb", "aux_z") if w[k]] or [0.0])
                upd, leaf = max([(math.sqrt(a / b), path) for path, (a, b)
                                 in res.get("updates", {}).items() if b > 0]
                                or [(0.0, None)])
                share, at = max([(v, p) for p, v in shares(res).items()]
                                or [(0.0, None)])
                wide = {p.split("::", 1)[-1]: f"{math.sqrt(a / b):.3e}"
                        for p, (a, b) in res.get("updates", {}).items()
                        if b > 0 and gate(p) > tol}
                calls = sorted({c[3] for c in res["flash"]})
                geo = launches(res)
                d_, m_ = mesh
                reckoned = (12 * n / (d_ * m_) + (4 if dt == "float32"
                                                  else 2) * n / m_
                            + 4 * n / m_) / 1e9
                print(f"mesh {case} rank {r} (data "
                      f"{res['coords']['data']}, model "
                      f"{res['coords']['model']}): {steps} steps, loss and "
                      f"grad_norm vs one device worst rel {rel:.3e}, worst "
                      f"leaf update {upd:.3e} ({leaf}; tolerance {tol:g}), "
                      f"at {share:.3f} of its leaf's gate ({at}; "
                      f"{MESH_ILL_FACTOR * tol:g} for {wide}), aux "
                      f"{aux:.3e} (tolerance {MESH_AUX_TOL:g}); losses "
                      f"{[round(m['loss'], 6) for m in res['metrics']]}; "
                      f"flash {geo} over {calls} heads a call; "
                      f"{res['collectives']} collectives ({res['ipc']} "
                      f"through IPC); {res['wall_s']:.1f} s; peak "
                      f"{res.get('peak_gb', 0):.2f} GB (state, compute "
                      f"copy and gradients reckoned {reckoned:.2f} GB) "
                      f"[{card}]")
                worst[r] = dict(rel=rel, aux=aux, update_rel=upd,
                                gate_share=share, widened=wide, flash=geo,
                                collectives=res["collectives"],
                                ipc=res["ipc"],
                                heads=calls, peak_gb=res.get("peak_gb"),
                                wall_s=res["wall_s"])
                if rank_check:
                    check(rel <= tol and share <= 1 and aux <= MESH_AUX_TOL,
                          f"mesh {case} rank {r} disagrees with the "
                          f"one-device step")
                    want_heads = [-(-hq // m_)] if n_flash else []
                    check(calls == want_heads,
                          f"mesh {case} rank {r}: flash over {calls} heads,"
                          f" {want_heads} expected")
                    key = f"{dt}/{dk}/{dv}"
                    check(not on_card or sum(geo.values()) == sum(
                        v for k, v in geo.items() if k.endswith(key))
                        == 2 * steps * n_flash,
                          f"mesh {case} rank {r}: {geo} launches, "
                          f"{2 * steps * n_flash} of {key} expected")
            return worst

        tr_ref = ref.get("train")
        if tr_ref:
            print(f"mesh {name} at full width, {cfg.n_layers} layers "
                  f"({n:,} parameters): the first one-device gradient "
                  f"norm {tr_ref['norm0']:.4e}, grad_clip "
                  f"{tr_ref['opt']['grad_clip']:.4e}, eps "
                  f"{tr_ref['opt']['eps']:.3e}")
            for mesh in plan["train"]:
                case = f"fam {name} f32 {mesh[0]}x{mesh[1]}"
                row[case] = read(case, mesh, "float32", MESH_LM_STEPS)
                if plan.get("routing"):
                    # the one-device forward's (remat: then its recompute)
                    want = ranks[0][case]["one_device"]["routing"]
                    layers = len(want) // 2
                    same = all(
                        torch.equal(a, b) for rank in ranks
                        for ra, rb in zip(rank[case]["one_device"]["routing"],
                                          want) for a, b in zip(ra, rb))
                    for li in range(layers):
                        for m_ in range(mesh[1]):
                            got = [torch.cat([
                                rank[case]["routing"][li][i]
                                for rank in ranks
                                if rank[case]["coords"]["model"] == m_])
                                for i in range(3)]
                            same &= all(torch.equal(g, w) for g, w in zip(
                                got, want[li]))
                    kept = sum(int(w[2].sum()) for w in want[:layers])
                    print(f"mesh {case}: the routing of {layers} MoE layers "
                          f"in the first forward (expert ids, places, "
                          f"{kept} kept pairs) equal to one device's bit for "
                          f"bit on every rank: {same}")
                    check(same, f"mesh {case}: the routing differs from "
                                f"one device's")
                    row[case + " routing"] = same
            if plan.get("bf16"):
                case = f"fam {name} bf16 1x2"
                row[case] = read(case, (1, 2), "bfloat16", 1)
            sound = f"fam {name} f32 {plan['train'][0][0]}x" \
                f"{plan['train'][0][1]}"
            for fault, mesh in plan.get("faults", ()):
                case = f"fam {name} fault {fault}"
                worst = read(case, mesh, "float32", 1, want_from=None
                             if plan.get("fault_updates") else sound,
                             rank_check=False)
                keys, tol = (("aux",), MESH_AUX_TOL) if "aux" in fault \
                    else (("rel", "update_rel"), MESH_LM_TOL["float32"])
                factor = min(max(w[k] for k in keys)
                             for w in worst.values()) / tol
                print(f"mesh {case} at {mesh}: {' / '.join(keys)} read "
                      f"{factor:.1f} x its gate {tol:g} on the rank that "
                      f"reads least (planted: must reach "
                      f"{MESH_FAM_FAULT_RATIO:g} x)")
                check(factor >= MESH_FAM_FAULT_RATIO,
                      f"mesh {name}: the gate cannot tell {fault}")
                row[case] = factor
            if plan.get("reshard"):
                saved = f"{tmp}/{name}/saved"
                cfg32 = dataclasses.replace(cfg, dtype="float32")
                state = init_train_state(cfg32,
                                         torch.Generator(dev).manual_seed(0))
                state = ckpt.restore(state, saved)
                files = ckpt.arrays(saved)
                same_one = all(np.array_equal(t.cpu().numpy(), files[k])
                               for k, t in ckpt.tree_items(state).items())
                del files, state
                case = f"fam {name} reshard 1x2"
                worst = read(case, (1, 2), "float32", 1, first=1,
                             rank_check=False)
                tol = MESH_LM_TOL["float32"]
                for r, rank in enumerate(ranks):
                    res = rank[case]
                    print(f"mesh reshard of {name}: (2, 1)'s state after "
                          f"step 1 restored at (1, 2) rank {r}: bits equal "
                          f"{res['bits_equal']} over {res['leaves']} leaves "
                          f"(on one device: {same_one}); step 2 rel "
                          f"{worst[r]['rel']:.3e}, update "
                          f"{worst[r]['update_rel']:.3e} (tolerance {tol:g})")
                    check(res["bits_equal"] and same_one
                          and worst[r]["rel"] <= tol
                          and worst[r]["gate_share"] <= 1,
                          f"mesh {name}: the reshard differs")
                row[case] = dict(same_one=same_one, **worst[0])
        # the TP prefill
        for case in [k for k in ranks[0] if k.startswith(
                f"fam {name} prefill 1x2")]:
            fault = case != f"fam {name} prefill 1x2"
            worst = 0.0
            for r, rank in enumerate(ranks):
                res = rank[case]
                m_ = res["coords"]["model"]
                for got, want in zip(res["logits"], ref["prefill"]):
                    cols = got.shape[-1]
                    worst = max(worst, rel_norm(
                        got.float(), want[m_ * cols:(m_ + 1) * cols]))
                calls = sorted({c[3] for c in res["flash"]})
                geo = launches(res)
                print(f"mesh {case} rank {r}: last logits of prompts "
                      f"{ref['lens']} vs one device ||a-b||/||b|| "
                      f"{worst:.3e} (" + (f"must exceed "
                                          f"{MESH_FAM_FAULT_RATIO:g} x "
                                          f"{MESH_TP_TOL:g}" if fault else
                                          f"tolerance {MESH_TP_TOL:g}")
                      + f"); flash {geo} over {calls} heads a call; "
                      f"{res['collectives']} collectives ({res['ipc']} "
                      f"through IPC); peak {res.get('peak_gb', 0):.2f} GB "
                      f"[{card}]")
                if not fault:
                    want_heads = [heads] if n_flash else []
                    check(calls == want_heads,
                          f"mesh {case} rank {r}: flash over {calls} heads")
                    key = f"wgmma bfloat16/{dk}/{dv}"
                    check(not on_card or geo.get(key, 0) == sum(
                        geo.values()) == n_flash * len(ref["lens"]),
                          f"mesh {case} rank {r}: {geo}, "
                          f"{n_flash * len(ref['lens'])} of {key} expected")
            check(worst >= MESH_FAM_FAULT_RATIO * MESH_TP_TOL if fault
                  else worst <= MESH_TP_TOL,
                  f"mesh {case}: {worst:.3e} against {MESH_TP_TOL:g}")
            row[case] = worst
        # the decodes
        for case in [k for k in ranks[0] if k.startswith(
                f"fam {name} decode ") or k.startswith(
                f"fam {name} seq decode ")]:
            seq = " seq decode " in case
            dt = case.split()[-1] if seq else "bfloat16"
            want = ref["decode"][dt]
            tol = MESH_DECODE_TOL[dt] if seq else MESH_TP_TOL
            worst, coll = 0.0, []
            for r, rank in enumerate(ranks):
                res = rank[case]
                d_, m_ = res["coords"]["data"], res["coords"]["model"]
                got = res["logits"].float()
                rows_, cols = got.shape[1], got.shape[2]
                d_ = 0 if seq else d_
                w = want[:, d_ * rows_:(d_ + 1) * rows_,
                         m_ * cols:(m_ + 1) * cols]
                live = w > -1e29
                worst = max(worst, rel_norm(got[live], w[live]))
                coll.append((res["collectives"], res["ipc"],
                             round(res.get("peak_gb", 0), 2)))
            print(f"mesh {case}: {MESH_DECODE_STEPS} steps' logits on both "
                  f"ranks vs one device ||a-b||/||b|| {worst:.3e} (tolerance "
                  f"{tol:g}); collectives (through IPC) and peak GB a rank "
                  f"{coll} [{card}]")
            check(worst <= tol, f"mesh {case}: {worst:.3e} against {tol:g}")
            row[case] = worst
    # one launch at each new rank geometry, timed in this process alone
    if on_card:
        b_, s_ = MESH_FAM_BATCH
        geos = []
        for name, ref in refs.items():
            cfg = ref["cfg"]
            if not cfg.n_heads:
                continue
            dk = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) if cfg.mla \
                else cfg.resolved_head_dim
            dv = cfg.v_head_dim if cfg.mla else dk
            h = -(-cfg.n_heads // 2)
            geos.append((f"{name} prefill at (1, 2)", 1, max(ref["lens"]),
                         h, dk, dv))
            if name == "minicpm3-4b":
                geos.append((f"{name} training at (1, 2)", b_, s_, h, dk,
                             dv))
        out["launch_rows"] = [split_launch_row(
            f"{label} a rank", b, s, h, dk, dv, torch.bfloat16, dev, on_card)
            for label, b, s, h, dk, dv in geos]
        for row in out["launch_rows"]:
            print(f"flash_attention ({row['variant']}) at {row['label']} "
                  f"(B={row['b']} S={row['s']} H={row['h']} "
                  f"dk={row['dk']} dv={row['dv']} causal bf16): "
                  f"{row['ms']:.4f} ms (device; {row['tflops']:.2f} "
                  f"TFLOP/s), vs plain max_abs_err {row['max_abs_err']:.3e};"
                  f" bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
                  f"plain {row['plain_ms']:.3f} ms; SDPA "
                  f"{row['library_ms']:.4f} ms ({row['library_backend']}) "
                  f"[{card}]")
    return out


def mesh_loop_cases(dev, tmp: str) -> list:
    """(e)'s cases: TrainLoop on the (2, 1) mesh, failed at step 1 and
    uninterrupted, and the train CLI's ``--mesh 1,2`` on the ranks (see
    MESH_LOOP_*)."""
    from repro_torch import elastic_restart as er
    gen = torch.Generator().manual_seed(2)
    loop = dict(kind="lm_train", mesh=(2, 1), seed=0, condition=True,
                cfg=dataclasses.asdict(er.RESHARD_CFG),
                opt=dataclasses.asdict(er.RESHARD_OPT), ckpt_every=1,
                return_state=True, batches=[
                    {"tokens": torch.randint(0, er.RESHARD_CFG.vocab,
                                             MESH_LOOP_BATCH,
                                             generator=gen).int()}
                    for _ in range(MESH_LOOP_STEPS)])
    return [dict(loop, name="lm loop 2x1", ckpt_dir=f"{tmp}/loop"),
            dict(loop, name="lm loop 2x1 failed", fail_at=1,
                 ckpt_dir=f"{tmp}/loop_failed"),
            dict(kind="lm_cli", name="lm cli 1x2", argv=[
                "--arch", LLM_ARCH, "--preset", "tiny", "--steps",
                str(MESH_CLI_STEPS), "--ckpt-every",
                str(MESH_CLI_STEPS // 2), "--batch", "2", "--seq", "32",
                "--ckpt-dir", f"{tmp}/cli", "--mesh", "1,2", "--device",
                dev.type])]


def mesh_loop_check(card: str, ranks: list, tmp: str) -> dict:
    """(e): the failed run's state equal to the uninterrupted one's
    within the restart demo's 1e-5, one restart; the CLI's checkpoints
    and its rank-0 log; each rank's flash launches over its heads."""
    from repro_torch import elastic_restart as er
    from repro_torch.launch.train import reduced_config
    from repro_torch.train.checkpoint import all_steps, tree_items
    out = {}
    for r, rank in enumerate(ranks):
        ok, failed = rank["lm loop 2x1"], rank["lm loop 2x1 failed"]
        diff = max(float((a.double() - b.double()).abs().max())
                   for a, b in zip(tree_items(ok["state"]).values(),
                                   tree_items(failed["state"]).values()))
        heads = sorted({c[3] for c in failed["flash"]})
        print(f"mesh TrainLoop on (2, 1) rank {r}: {MESH_LOOP_STEPS} steps "
              f"of {er.RESHARD_CFG.name} at the demo's width, checkpoints "
              f"every step; failed at step 1: {failed['restarts']} restart, "
              f"the state's largest divergence from the uninterrupted run "
              f"{diff:.2e} (gate 1e-5); flash over {heads} heads a call "
              f"[{card}]")
        check(failed["restarts"] == 1 and ok["restarts"] == 0
              and diff < 1e-5 and heads == [er.RESHARD_CFG.n_heads],
              f"mesh TrainLoop rank {r}: the restore from its checkpoint "
              f"does not replay the run")
        out[f"loop rank {r}"] = diff
    steps = all_steps(f"{tmp}/cli")
    want_heads = reduced_config(LLM_ARCH, "tiny").n_heads // 2
    for r, rank in enumerate(ranks):
        res = rank["lm cli 1x2"]
        heads = sorted({c[3] for c in res["flash"]})
        log = res["stdout"].strip().splitlines()
        print(f"mesh python -m repro_torch.launch.train --preset tiny "
              f"--steps {MESH_CLI_STEPS} --mesh 1,2 rank {r}: "
              f"{res['wall_s']:.1f} s, checkpoints {steps}, flash over "
              f"{heads} heads a call, launches {res['flash_launches']}; last "
              f"lines: {' | '.join(log[-2:])}")
        check(steps == [MESH_CLI_STEPS // 2, MESH_CLI_STEPS]
              and (log[-1:] == ["[train] done"] if r == 0 else not log),
              f"mesh train CLI rank {r}: checkpoints {steps}, log {log[-2:]}")
        check(heads == [want_heads],
              f"mesh train CLI rank {r}: flash over {heads} heads")
    out["cli_steps"] = steps
    return out


def mesh_lm_check(card: str, dev, refs: dict, ranks: list, tmp: str,
                  train_cfg) -> dict:
    """The ranks' (a), (b) and (d) cases against the references (see
    MESH_LM_*); every rank's flash launches by (dtype, dk, dv) and
    heads, and its peak device memory beside the reckoned state."""
    from repro_torch.models import transformer as tr
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_state import init_train_state
    on_card = dev.type == "cuda"
    n = tr.count_params(train_cfg)
    out = {"train": {}, "decode": {}, "flash": {}}
    hq = train_cfg.n_heads

    def heads_of(res):
        return sorted({c[3] for c in res["flash"]})

    def launches(res):
        return {k: v for name, geo in res["flash_launches"].items()
                for k, v in geo.items()}

    def reckoned(mesh, dt):
        """Bytes a rank holds of the state (f32 masters and moments split
        over both axes), the compute copy and its f32 gradients (split
        over model), before activations."""
        d, m = mesh
        copy = (4 if dt == "float32" else 2) * n / m
        return (12 * n / (d * m) + copy + 4 * n / m) / 1e9

    def read_train(name, mesh, dt, want, steps, updates=True):
        tol = MESH_LM_TOL[dt]
        row = {"ranks": []}
        for r, rank in enumerate(ranks):
            res = rank[name]
            worst = max(abs(g[k] - w[k]) / abs(w[k])
                        for g, w in zip(res["metrics"], want)
                        for k in ("loss", "grad_norm"))
            upd = 0.0
            if updates:
                upd = max(math.sqrt(a / b) for a, b in
                          res["updates"].values() if b > 0)
            geo = launches(res)
            print(f"mesh {name} rank {r} (data {res['coords']['data']}, "
                  f"model {res['coords']['model']}): seconds "
                  + ", ".join(f"{k} {v:.1f}" for k, v in res["laps"].items())
                  + f"; {steps} steps, loss "
                  f"and grad_norm vs one device worst rel {worst:.3e}, "
                  f"worst leaf update ||a-b||/||b|| {upd:.3e} (tolerance "
                  f"{tol:g}); losses "
                  f"{[round(m['loss'], 6) for m in res['metrics']]}; flash "
                  f"launches {geo} over {heads_of(res)} heads a call; peak "
                  f"{res.get('peak_gb', 0):.2f} GB (state, compute copy "
                  f"and gradients reckoned {reckoned(mesh, dt):.2f} GB) "
                  f"[{card}]")
            check(worst <= tol and upd <= tol,
                  f"mesh {name} rank {r} disagrees with the one-device step")
            check(heads_of(res) == [hq // mesh[1]],
                  f"mesh {name} rank {r}: flash over {heads_of(res)} heads, "
                  f"{hq // mesh[1]} expected")
            key = (dt, train_cfg.resolved_head_dim,
                   train_cfg.resolved_head_dim)
            check(not on_card or (sum(geo.values()) == geo.get(
                "/".join(str(v) for v in key), -1) == 2 * steps),
                  f"mesh {name} rank {r}: {geo} launches, {2 * steps} of "
                  f"the {key} instance expected (forward and the remat's)")
            row["ranks"].append(dict(rel=worst, update_rel=upd,
                                     flash=geo, heads=heads_of(res),
                                     peak_gb=res.get("peak_gb"),
                                     wall_s=res["wall_s"]))
        out["train"][name] = row
    # -- (a) -------------------------------------------------------------
    print(f"mesh training {train_cfg.name} at full width, "
          f"{train_cfg.n_layers} layers ({n:,} parameters), "
          f"{'x'.join(map(str, refs['batches'][0]['tokens'].shape))} "
          f"tokens: the first one-device gradient norm "
          f"{refs['norm0']:.4e}, so grad_clip {refs['opt']['grad_clip']:.4e} "
          f"and eps {refs['opt']['eps']:.3e}")
    read_train("lm f32 2x1", (2, 1), "float32", refs["metrics"]["float32"],
               MESH_LM_STEPS)
    read_train("lm f32 1x2", (1, 2), "float32", refs["metrics"]["float32"],
               MESH_LM_STEPS)
    read_train("lm bf16 1x2", (1, 2), "bfloat16",
               refs["metrics"]["bfloat16"], 1)
    for fault, mesh in MESH_LM_FAULTS:
        name = f"lm fault {fault}"
        tol = MESH_LM_TOL["float32"]
        for r, rank in enumerate(ranks):
            got = rank[name]["metrics"][0]
            want = refs["metrics"]["float32"][0]
            rel = max(abs(got[k] - want[k]) / abs(want[k])
                      for k in ("loss", "grad_norm"))
            print(f"mesh {name} at {mesh} rank {r}: loss and grad_norm vs "
                  f"one device worst rel {rel:.3e} (planted: must reach "
                  f"{MESH_FAULT_RATIO:g} x {tol:g})")
            check(rel >= MESH_FAULT_RATIO * tol,
                  f"mesh: the gate cannot tell {fault}")
    # -- (d) the reshard -------------------------------------------------
    saved = f"{tmp}/saved"
    cfg32 = dataclasses.replace(train_cfg, dtype="float32")
    state = init_train_state(cfg32, torch.Generator(dev).manual_seed(0))
    state = ckpt.restore(state, saved)
    files = ckpt.arrays(saved)
    same_one = all(np.array_equal(t.cpu().numpy(), files[k])
                   for k, t in ckpt.tree_items(state).items())
    del files, state
    if on_card:
        torch.cuda.empty_cache()
    tol = MESH_LM_TOL["float32"]
    want = refs["metrics"]["float32"][1]
    for r, rank in enumerate(ranks):
        res = rank["lm reshard 1x2"]
        rel = max(abs(res["metrics"][0][k] - want[k]) / abs(want[k])
                  for k in ("loss", "grad_norm"))
        upd = max(math.sqrt(a / b) for a, b in res["updates"].values()
                  if b > 0)
        print(f"mesh reshard: (2, 1)'s state after step 1 restored at (1, 2) "
              f"rank {r}: bits equal to the saved arrays "
              f"{res['bits_equal']} over {res['leaves']} leaves (restored "
              f"on one device: {same_one}); step 2 from it vs the one-device "
              f"step 2: loss and grad_norm worst rel {rel:.3e}, worst leaf "
              f"update from the drawn weights {upd:.3e} (tolerance {tol:g}); "
              f"seconds " + ", ".join(f"{k} {v:.1f}" for k, v in
                                      res["laps"].items()) + f" [{card}]")
        check(res["bits_equal"] and same_one and rel <= tol and upd <= tol,
              "mesh: the reshard differs from the saved state or its step "
              "from the one-device step")
    out["reshard"] = dict(update_rel=upd, same_one=same_one)
    # -- (b) -------------------------------------------------------------
    for name in ("lm prefill 1x2", "lm prefill 1x2 wo not summed"):
        fault = "wo not summed" in name
        worst = 0.0
        for r, rank in enumerate(ranks):
            res = rank[name]
            m_ = res["coords"]["model"]
            for got, want in zip(res["logits"], refs["prefill"]):
                cols = got.shape[-1]
                worst = max(worst, rel_norm(
                    got.float(), want[m_ * cols:(m_ + 1) * cols]))
            geo = launches(res)
            print(f"mesh {name} rank {r}: last logits of prompts "
                  f"{refs['prompt_lens']} vs one device ||a-b||/||b|| "
                  f"{worst:.3e} ("
                  + (f"must exceed {MESH_TP_TOL:g}" if fault
                     else f"tolerance {MESH_TP_TOL:g}")
                  + f"); flash launches {geo} over {heads_of(res)} heads a "
                  f"call; peak {res.get('peak_gb', 0):.2f} GB [{card}]")
            check(heads_of(res) == [refs["q_heads"] // 2],
                  f"mesh {name} rank {r}: flash over {heads_of(res)} heads")
        tol = MESH_TP_TOL
        check(worst > tol if fault else worst <= tol,
              f"mesh {name}: {worst:.3e} against {tol:g}")
        out["decode"][name] = worst
    for name in [k for k in ranks[0] if k.startswith("lm decode ")]:
        fault = not name.endswith(("1x2", "2x1"))
        want = refs["decode"]["int8" if "int8" in name else "bf16"]
        worst = 0.0
        for r, rank in enumerate(ranks):
            res = rank[name]
            d_, m_ = res["coords"]["data"], res["coords"]["model"]
            got = res["logits"].float()
            rows, cols = got.shape[1], got.shape[2]
            worst = max(worst, rel_norm(got, want[:, d_ * rows:(d_ + 1) * rows,
                                              m_ * cols:(m_ + 1) * cols]))
        tol = MESH_TP_TOL
        print(f"mesh {name}: {MESH_DECODE_STEPS} steps' logits on both ranks "
              f"vs one device ||a-b||/||b|| {worst:.3e} ("
              + (f"must exceed {tol:g}" if fault else f"tolerance {tol:g}")
              + f") [{card}]")
        check(worst > tol if fault else worst <= tol,
              f"mesh {name}: {worst:.3e} against {tol:g}")
        out["decode"][name] = worst
    # one launch at each rank's geometry, timed in this process alone (not
    # under two ranks sharing the card), beside its bound and SDPA
    if on_card:
        b_, s_ = refs["batches"][0]["tokens"].shape
        hd = train_cfg.resolved_head_dim
        qhd = refs["q_hd"]
        out["launch_rows"] = [split_launch_row(
            f"{label} a rank", b, s, h, d, d, torch.bfloat16, dev, on_card)
            for label, b, s, h, d in (
                (f"{train_cfg.name} training at (1, 2)", b_, s_, hq // 2,
                 hd),
                ("qwen1.5-32b prefill at (1, 2)", 1,
                 max(refs["prompt_lens"]), refs["q_heads"] // 2, qhd))]
        for row in out["launch_rows"]:
            print(f"flash_attention ({row['variant']}) at {row['label']} "
                  f"(B={row['b']} S={row['s']} H={row['h']} "
                  f"hd={row['dk']} causal bf16): {row['ms']:.4f} ms "
                  f"(device; {row['tflops']:.2f} TFLOP/s), vs plain "
                  f"max_abs_err {row['max_abs_err']:.3e}; bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}); plain "
                  f"{row['plain_ms']:.3f} ms; SDPA {row['library_ms']:.4f} ms "
                  f"({row['library_backend']}) [{card}]")
    # every rank's flash launches over the LLM cases, by kernel and dtype
    for rank in ranks:
        for name, res in rank.items():
            if name.startswith(("lm ", "fam ")):
                for kname, geo in res["flash_launches"].items():
                    for key, k in geo.items():
                        dt = key.split("/")[0]
                        book = out["flash"].setdefault(kname, {})
                        book[dt] = book.get(dt, 0) + k
    return out


def mesh_phase(card: str, dev, batch: int = BATCH, scale: float = 1.0,
               min_bytes: int | None = None, qwen_cfg=None,
               decode_rows: int = MESH_DECODE_ROWS,
               decode_lens: tuple[int, int] = MESH_DECODE_LENS,
               train_cfg=None, swa_rows: int = MESH_SWA_ROWS,
               swa_lens: tuple[int, int] = MESH_SWA_LENS,
               family_cfgs: dict | None = None,
               family_batch=MESH_FAM_BATCH,
               family_rows: int = MESH_FAM_ROWS,
               family_lens=MESH_FAM_LENS) -> dict:
    """Sharded GAN programs on ``MESH_WORLD`` gloo ranks sharing the card
    (ROADMAP item 12).  The kernels are built before the ranks start, so
    each rank only loads the built libraries.

    1. The full-width generators (batch ``BATCH``) sharded as
       ``MESH_FORWARDS`` says, with the default threshold (DCGAN g1 and
       3D-GAN g1 are ``"cout"``), each against the one-device program on
       the same parameters and latents at ATOL/RTOL (f32) or
       STORAGE_TOL (bf16); every rank's launches by route and by Cout
       printed, every rank launching the model's kernel on each of its
       layers, the ``"cout"`` layers on the rank's slice only.
    2. One DCGAN train step through ``TrainLoop`` at each of
       ``MESH_TRAIN`` against the one-device step from equal state and
       batch: losses and updated parameters at ``MESH_TRAIN_TOL``.
    3. ``GanEngine`` at (2, 1) on ``MESH_ENGINE_BUCKETS``: its stream
       against a one-device engine with the same seed and buckets.
    4. Both ring matmuls on two ranks against the dense product.
    5. NCCL in a world of one: a (1, 1) mesh's ``GanServer`` equal to the
       unsharded one bit for bit.
    6. The sequence-sharded LLM decode (MESH_DECODE_*): full-width
       Qwen1.5-32B at MESH_DECODE_LAYERS layers, bf16 and f32, int8 and
       bf16 caches, against the one-device ``decode_step``, the planted
       combine without ``corr`` above the gates, the collectives
       counted.
    7. The dense transformer on the mesh (MESH_LM_*): (a) tensor- and
       data-parallel training of Gemma3-4B, (b) Qwen1.5-32B's TP prefill,
       TP decode and batch-sharded decode, (c) Gemma3-4B's windowed layers
       under seq_shard_decode, (d) the reshard; ``train_cfg``,
       ``swa_rows`` and ``swa_lens`` cut it down on the CPU.
    8. MLA, MoE, SSM and hybrid layers on the mesh (MESH_FAMILIES):
       MiniCPM3-4B, OLMoE-1B-7B, Llama-4-Scout, Mamba2-2.7B and
       Hymba-1.5B at full width, their layers cut, trained, prefilled and
       decoded against one device, with their planted faults;
       ``family_cfgs`` (name -> config), ``family_batch``,
       ``family_rows`` and ``family_lens`` cut it down on the CPU.
    Every count is set to 0 on each rank just before each case and read
    just after.  A rank that fails fails the phase.  ``batch``,
    ``scale`` and ``min_bytes`` (the sharding threshold), ``qwen_cfg``,
    ``decode_rows`` and ``decode_lens`` cut it down to rehearse on the
    CPU, where the ranks run the kernels' plain versions (no launches to
    count) and the world of one is gloo's."""
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.ganax_conv import (ganax_conv3d_cuda,
                                                ganax_conv_cuda)
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.gan import GanConfig, init_gan
    from repro_torch.program import Program
    from repro_torch.serve.gan import GanServer
    from repro_torch.serve.gan_engine import GanEngine
    from repro_torch.sharding import parity
    from repro_torch.train.loop import make_gan_train_step
    t0 = time.perf_counter()
    on_card = dev.type == "cuda"

    def config(model, dtype="float32"):
        return GanConfig(model, channel_scale=scale, dtype=dtype)
    params = {m: init_gan(config(m), torch.Generator().manual_seed(0),
                          device="cpu") for m in ("dcgan", "3dgan")}
    gen = torch.Generator().manual_seed(1)
    z = torch.randn((batch, 100), generator=gen)
    real = torch.rand((batch, 64, 64, 3), generator=gen) * 2 - 1
    ring = {k: torch.randn(shape, generator=gen) for k, shape in (
        ("x", (MESH_RING[0] * MESH_WORLD, MESH_RING[1])),
        ("w", (MESH_RING[1], MESH_RING[2] * MESH_WORLD)),
        ("x2", (MESH_RING[0] * MESH_WORLD, MESH_RING[1] * MESH_WORLD)),
        ("w2", (MESH_RING[1] * MESH_WORLD, MESH_RING[2])))}
    shared = dict(scale=scale, min_bytes=min_bytes)
    cases = [dict(name=f"fwd {m} {d[0]}x{d[1]} {dt}", kind="forward",
                  model=m, mesh=d, dtype=dt, batch=batch, timed=MESH_TIMED,
                  params=params[m][0], x=z, **shared)
             for m, d, dt in MESH_FORWARDS]
    cases += [dict(name=f"train {d[0]}x{d[1]}", kind="train", model="dcgan",
                   mesh=d, g_params=params["dcgan"][0],
                   d_params=params["dcgan"][1], z=z, real=real, lr=MESH_LR,
                   steps=1, **shared) for d in MESH_TRAIN]
    cases.append(dict(name="engine 2x1", kind="engine", model="dcgan",
                      mesh=(2, 1), params=params["dcgan"][0],
                      buckets=list(MESH_ENGINE_BUCKETS), seed=3,
                      requests=list(MESH_ENGINE_REQUESTS), **shared))
    cases.append(dict(name="ring", kind="ring", mesh=(1, MESH_WORLD),
                      **ring))
    qcfg = qwen_cfg or dataclasses.replace(get_config(QWEN_ARCH),
                                           n_layers=MESH_DECODE_LAYERS)
    prompts = [torch.randint(0, qcfg.vocab, (n,), generator=gen).tolist()
               for n in decode_lens]
    dtoks = torch.randint(0, qcfg.vocab, (MESH_DECODE_STEPS, 2, 1),
                          generator=gen)
    decode_cases = [dict(
        name=f"decode {dt} {kvd}{' no corr' if fault else ''}",
        kind="decode", mesh=(MESH_WORLD, 1),
        cfg=dataclasses.asdict(dataclasses.replace(qcfg, dtype=dt)), seed=0,
        prompts=prompts, max_len=decode_rows, kv_dtype=kvd, tokens=dtoks,
        lengths=torch.tensor(decode_lens), condition=True,
        **({"fault": "no corr"} if fault else {}))
        for dt in ("bfloat16", "float32")
        for kvd, fault in (("bf16", False), ("int8", False), ("bf16", True))]
    cases += decode_cases
    tmp_dir = tempfile.TemporaryDirectory()
    lm_tmp = tmp = tmp_dir.name
    tcfg = train_cfg or dataclasses.replace(get_config(GEMMA3_ARCH),
                                            n_layers=MESH_LM_LAYERS)
    t_ref = time.perf_counter()
    lm_cases, lm_refs = mesh_lm_cases(dev, tmp, gen, tcfg, qcfg,
                                      decode_rows, decode_lens, swa_rows,
                                      swa_lens)
    fam_cases, fam_refs = mesh_family_cases(
        dev, tmp, gen, family_cfgs, family_batch, family_rows, family_lens,
        swa_lens)
    # the training cases first, on a card the other cases have not held
    cases = lm_cases + fam_cases + cases
    decode_cases += lm_refs["swa"]
    print(f"mesh: the LLM cases' one-device references in "
          f"{time.perf_counter() - t_ref:.1f} s")
    if on_card:
        torch.cuda.empty_cache()
    out = {"forwards": {}, "train": {}, "launches": {}}
    case_file = str(Path(tmp) / "cases.pt")
    torch.save(cases, case_file)
    t_spawn = time.perf_counter()
    spawn(parity.run, MESH_WORLD, case_file, tmp, dev.type,
          backend="gloo", device=dev.type)
    spawn_s = time.perf_counter() - t_spawn
    ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=True)
             for r in range(MESH_WORLD)]
    print(f"mesh: {MESH_WORLD} gloo ranks on {dev} ran {len(cases)} cases "
          f"in {spawn_s:.1f} s (spawn to exit); seconds a case on rank 0: "
          + ", ".join(f"{k} {v['wall_s']:.1f}" for k, v in ranks[0].items())
          + "; GB held at a case's start on rank 0: "
          + ", ".join(f"{k} {v.get('held_gb', 0):.2f}"
                      for k, v in ranks[0].items()))
    # every rank's launches, by kernel and dtype (the kernels line)
    launched = {name: {} for name in KERNEL_OF.values()}
    for res in ranks:
        for case in res.values():
            for name, counts in case["launches"].items():
                for dname, n in counts["dtype"].items():
                    launched[name][dname] = launched[name].get(dname, 0) + n
    # -- 1. the sharded forwards ----------------------------------------
    for m, mesh, dt in MESH_FORWARDS:
        name = f"fwd {m} {mesh[0]}x{mesh[1]} {dt}"
        ref_prog = Program.build(config(m, dt), batch, "generator",
                                 device=dev, differentiable=False,
                                 mesh=None)
        ref = ref_prog.apply({k: v.to(dev) for k, v in
                              params[m][0].items()}, z.to(dev))
        cout_layers = [le for le, sh in zip(ref_prog.spec.layers,
                                            ranks[0][name]["shardings"])
                       if sh == "cout"]
        check(cout_layers or mesh[1] == 1,
              f"{name}: no layer is Cout-sharded")
        kernel = KERNEL_OF[m]
        n_layers = len(ref_prog.spec.layers)
        row = {"ranks": []}
        for r, res in enumerate(ranks):
            got = res[name]["out"].to(dev)
            if dt == "float32":
                err, ok = max_err(got, ref)
                gate = f"atol=rtol={ATOL:g}"
            else:
                share = storage_share(got, ref)
                err, ok = (got.float() - ref.float()).abs().max().item(), \
                    share <= 1
                gate = f"STORAGE_TOL: worst output at {share:.4f} of it"
            counts = res[name]["launches"][kernel]
            by_cout = {int(k): v for k, v in counts["cout"].items()}
            calls = 1 + MESH_TIMED
            print(f"mesh {name} rank {r}: vs one device max_abs_err "
                  f"{err:.3e} ({gate}) {'ok' if ok else 'FAIL'}; "
                  f"{kernel} launches by route {counts['route']}, by Cout "
                  f"{dict(sorted(by_cout.items()))} over {calls} calls; "
                  f"{res[name]['ms']:.3f} ms a forward (wall, {MESH_WORLD} "
                  f"ranks sharing one card: not a speed-up) [{card}]")
            check(ok and bool(torch.isfinite(got).all()),
                  f"{name} rank {r} disagrees with the one-device path")
            check(not on_card or (
                sum(counts["route"].values()) == n_layers * calls
                and counts["dtype"] == {dt: n_layers * calls}),
                  f"{name} rank {r}: {counts} launches of {kernel} for "
                  f"{calls} calls of {n_layers} layers")
            for le in cout_layers if on_card else ():
                local = le.cout // mesh[1]
                check(le.cout not in by_cout and by_cout.get(local, 0)
                      >= calls,
                      f"{name} rank {r}: {le.name} (Cout {le.cout}) not "
                      f"launched on its {local}-channel slice: {by_cout}")
            row["ranks"].append(dict(err=err, ms=res[name]["ms"],
                                     routes=counts["route"],
                                     couts=by_cout))
        row["cout_layers"] = [le.name for le in cout_layers]
        out["forwards"][name] = row
        del ref, ref_prog
    # -- 2. the train step -------------------------------------------------
    cfg = config("dcgan")
    for mesh in MESH_TRAIN:
        name = f"train {mesh[0]}x{mesh[1]}"
        g, d = ({k: v.to(dev).clone() for k, v in p.items()}
                for p in params["dcgan"])
        step, (gnet, dnet) = make_gan_train_step(cfg, batch, g, d,
                                                 g_lr=MESH_LR, device=dev,
                                                 mesh=None)
        _, metrics = step((gnet.params, dnet.params),
                          {"z": z.to(dev), "real": real.to(dev)})
        want = {k: float(v) for k, v in metrics.items()}
        worst = 0.0
        for r, res in enumerate(ranks):
            got = res[name]["metrics"][0]
            for k, v in want.items():
                check(math.isclose(got[k], v, rel_tol=MESH_TRAIN_TOL["rtol"]),
                      f"{name} rank {r}: {k} {got[k]} vs one device {v}")
            for part, net in (("g", gnet), ("d", dnet)):
                for k, p in net.params.items():
                    q = res[name][part][k].to(dev)
                    diff = (q - p).abs()
                    lim = MESH_TRAIN_TOL["atol"] + MESH_TRAIN_TOL["rtol"] \
                        * p.abs()
                    worst = max(worst, (diff / lim).max().item())
                    check(bool((diff <= lim).all()),
                          f"{name} rank {r}: {part}.{k} differs from the "
                          f"one-device step by {diff.max().item():.3e} "
                          f"(at {(diff / lim).max().item():.3f} of "
                          f"{MESH_TRAIN_TOL})")
            counts = res[name]["launches"]["ganax_conv"]["route"]
            check(not on_card or sum(counts.values()) == LAUNCHES_PER_STEP,
                  f"{name} rank {r}: {counts} launches for one step")
            print(f"mesh {name} rank {r}: losses {got} (one device "
                  f"{want}); ganax_conv launches by route {counts}; "
                  f"{res[name]['s']:.3f} s for the step and its checkpoint "
                  f"(wall) [{card}]")
        print(f"mesh {name}: every loss within rtol "
              f"{MESH_TRAIN_TOL['rtol']:g} and every updated parameter "
              f"within {MESH_TRAIN_TOL}; worst at {worst:.4f} of it")
        out["train"][name] = dict(losses=want, worst_share=worst)
        del step, gnet, dnet, g, d
    # -- 3. the engine -----------------------------------------------------
    res = ranks[0]["engine 2x1"]
    with GanEngine(cfg, {k: v.to(dev) for k, v in
                         params["dcgan"][0].items()},
                   buckets=MESH_ENGINE_BUCKETS, seed=3, device=dev) as eng:
        want = [eng.submit(n).result(120) for n in MESH_ENGINE_REQUESTS]
    worst = 0.0
    for got, ref in zip(res["images"], want):
        err, ok = max_err(got, ref)
        worst = max(worst, err)
        check(ok, f"mesh engine: a request's images differ from the "
                  f"one-device engine by {err:.3e}")
    for r, rank in enumerate(ranks):
        counts = rank["engine 2x1"]["launches"]["ganax_conv"]["route"]
        check(not on_card or sum(counts.values()) > 0,
              f"mesh engine rank {r} launched nothing")
        print(f"mesh engine 2x1 rank {r}: ganax_conv launches by route "
              f"{counts}; {rank['engine 2x1']['s']:.3f} s (wall) [{card}]")
    print(f"mesh engine 2x1: {len(MESH_ENGINE_REQUESTS)} requests "
          f"{MESH_ENGINE_REQUESTS} on buckets {MESH_ENGINE_BUCKETS}, "
          f"max_abs_err {worst:.3e} against the one-device engine "
          f"(atol=rtol={ATOL:g})")
    # -- 4. the ring matmuls -----------------------------------------------
    y = (ring["x"].to(dev) @ ring["w"].to(dev))
    y2 = (ring["x2"].to(dev) @ ring["w2"].to(dev))
    for r, rank in enumerate(ranks):
        got = rank["ring"]
        (lo, hi), (rlo, rhi) = got["y_cols"], got["y2_rows"]
        e1, ok1 = max_err(got["y"].to(dev), y[:, lo:hi])
        e2, ok2 = max_err(got["y2"].to(dev), y2[rlo:rhi])
        print(f"mesh ring rank {r}: all-gather matmul max_abs_err {e1:.3e}, "
              f"reduce-scatter matmul {e2:.3e} (atol=rtol={ATOL:g}); "
              f"{got['staged']} transfers staged through host (gloo sends "
              f"no CUDA tensor)")
        check(ok1 and ok2, f"mesh ring rank {r} disagrees with the dense "
                           f"product")
    # -- 5. NCCL in a world of one -----------------------------------------
    g = {k: v.to(dev) for k, v in params["dcgan"][0].items()}
    backend = "nccl" if on_card else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1)
        try:
            sharded_before = obs.counter("program.sharded").value
            for k in (ganax_conv_cuda, ganax_conv3d_cuda):
                k.launches = 0
            srv = GanServer(cfg, g, batch_size=batch, seed=0, device=dev,
                            mesh=(1, 1))
            img = srv.generate(batch)
            if on_card:
                torch.cuda.synchronize()
            nccl_launches = ganax_conv_cuda.launches
            check(srv.program.mesh_str == "1x1" and obs.counter(
                "program.sharded").value == sharded_before + 1,
                  "nccl: the (1, 1) program did not run sharded")
        finally:
            dist.destroy_process_group()
    ref = GanServer(cfg, g, batch_size=batch, seed=0,
                    device=dev).generate(batch)
    same = torch.equal(img, ref)
    print(f"mesh {backend} world 1: (1, 1) program's images equal the "
          f"unsharded ones bit for bit: {same}; {nccl_launches} ganax_conv "
          f"launches")
    check(same and (not on_card or nccl_launches == 4),
          f"{backend} world 1: the sharded program differs from the "
          f"unsharded one")
    launched["ganax_conv"]["float32"] = \
        launched["ganax_conv"].get("float32", 0) + nccl_launches
    out["decode"] = mesh_decode(card, dev, decode_cases, ranks)
    out["lm"] = mesh_lm_check(card, dev, lm_refs, ranks, lm_tmp, tcfg)
    out["loop"] = mesh_loop_check(card, ranks, lm_tmp)
    out["families"] = mesh_family_check(card, dev, fam_refs, ranks, lm_tmp)
    tmp_dir.cleanup()
    seconds = time.perf_counter() - t0
    out.update(launches=launched, seconds=seconds, spawn_s=spawn_s)
    print(f"mesh main path: launches by kernel and dtype over both ranks "
          f"and the world of one {launched}; flash launches of the LLM "
          f"cases {out['lm']['flash']}; phase {seconds:.1f} s")
    return out


def mesh_decode(card: str, dev, cases: list, ranks: list) -> dict:
    """The ranks' sequence-sharded decode cases against the one-device
    path on ``dev`` (see MESH_DECODE_*): the logits of every step, each
    attention layer's output against ``parity.attention_oracle`` on rank
    0's layer inputs (every rank's inputs equal rank 0's, the combine's
    results being the same on every rank), the collectives a step; the
    planted fault above the gates."""
    from repro_torch.models import transformer as tr
    from repro_torch.sharding import parity
    memo: dict = {}
    out = {}
    for case in cases:
        name = case["name"]
        dt, fault = case["cfg"]["dtype"], case.get("fault")
        cfg, params, cache, tokens, lengths = parity.decode_inputs(case, dev,
                                                                   memo)
        with torch.no_grad():
            ref = torch.stack([tr.decode_step(params, cache, tokens[i],
                                              lengths + i, cfg)[0].cpu()
                               for i in range(tokens.shape[0])])
        del cache
        inputs = ranks[0][name]["inputs"]
        oracle = parity.attention_oracle(case, dev, inputs, memo)
        n_global = cfg.n_layers * tokens.shape[0]
        row = {"ranks": []}
        for r, res in enumerate(ranks):
            got = res[name]
            logits = max(rel_norm(got["logits"][i][..., :cfg.vocab],
                                  ref[i][..., :cfg.vocab])
                         for i in range(tokens.shape[0]))
            same = all(torch.equal(h, h0) for h, h0 in
                       zip(got["inputs"], inputs))
            attn_rel = max(rel_norm(o, w) for o, w in
                           zip(got["attn"], oracle))
            used = max(((o.float() - w.float()).abs()
                        / (MESH_ATTN_TOL["atol"] + MESH_ATTN_TOL["rtol"]
                           * w.float().abs())).max().item()
                       for o, w in zip(got["attn"], oracle))
            tol = MESH_DECODE_TOL[dt]
            print(f"mesh {name} rank {r} (data {got['coords']['data']}): "
                  f"logits of {tokens.shape[0]} steps vs one device "
                  f"||a-b||/||b|| worst {logits:.3e} ("
                  + (f"must exceed {tol:g}" if fault else f"tolerance {tol:g}")
                  + f"); attention outputs vs one device on the same "
                  f"inputs: ||a-b||/||b|| worst {attn_rel:.3e}, "
                  f"elementwise at {used:.3f} of atol=rtol=2e-5 ("
                  + ("must exceed 1" if fault else "gated"
                     if dt == "float32" else "read")
                  + f"); {got['collectives']} collectives, "
                  f"{got['staged']} staged through host memory [{card}]")
            check(same, f"mesh {name} rank {r}: its layer inputs differ "
                        f"from rank 0's")
            check(fault or got["collectives"] == 3 * n_global,
                  f"mesh {name} rank {r}: {got['collectives']} collectives "
                  f"for {n_global} global layer-steps")
            if fault:
                check(logits > tol and used > 1,
                      f"mesh {name} rank {r}: the gates cannot tell the "
                      f"combine without corr")
            else:
                check(logits <= tol and (dt != "float32" or used <= 1),
                      f"mesh {name} rank {r} disagrees with the one-device "
                      f"decode")
            row["ranks"].append(dict(logits_rel=logits, attn_rel=attn_rel,
                                     attn_tol_used=used,
                                     collectives=got["collectives"],
                                     staged=got["staged"],
                                     wall_s=got["wall_s"]))
        out[name] = row
        del params, oracle, ref
    memo.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    steps = MESH_DECODE_STEPS
    some = next(iter(out.values()))["ranks"][0]
    print(f"mesh decode: {len(cases)} cases of {steps} steps on "
          f"{MESH_WORLD} ranks, {some['collectives'] // steps} collectives "
          f"a step a rank (3 x {cfg.n_layers} layers), "
          f"{some['staged']} of them staged through host memory")
    return out


# The paper phase (ROADMAP item 24): the paper's own models.  The μop
# ISA machine (repro_torch.core.uop) runs each of these single-channel
# tconvs through strided index generators and address-free mac μops in
# float64; the ganax_conv kernel computes the same function at f32 on the
# card (Cin = Cout = 1: the narrow route).  (label, H, W, k, s, p, PVs,
# PEs a PV): tests/test_uop.py's five geometries on their small arrays,
# then each distinct 2-D Table-I generator tconv geometry on the paper's
# 16x16 array.
UOP_CASES = (("uop 4x4 k5 s2 p2", 4, 4, 5, 2, 2, 4, 4),
             ("uop 4x4 k4 s2 p1", 4, 4, 4, 2, 1, 2, 3),
             ("uop 5x3 k3 s3 p1", 5, 3, 3, 3, 1, 4, 2),
             ("uop 6x6 k3 s1 p1", 6, 6, 3, 1, 1, 4, 4),
             ("uop 8x8 k2 s2 p0", 8, 8, 2, 2, 0, 4, 4))
PAPER_ARRAY = (16, 16)
# the reference test's bands of the Fig. 8 means
# (tests/test_analytical.py::test_fig8_speedups) and the rows of run_all
FIG8_BANDS = {"speedup": (2.5, 4.5), "energy": (2.2, 4.0)}
PAPER_ROWS = 88


def machine_cases() -> list[tuple]:
    """UOP_CASES, then the Table-I geometries (k4 s2 p1 at 2-32, k5 s1
    p2 at 8, 16 and 64) on PAPER_ARRAY."""
    from repro_torch.configs.gans import GAN_MODELS
    geos = sorted({(l.in_spatial[0], l.kernel[0], l.strides[0],
                    l.paddings[0])
                   for g, _ in GAN_MODELS.values() for l in g
                   if l.transposed and len(l.in_spatial) == 2},
                  key=lambda t: (t[1], t[0]))
    return list(UOP_CASES) + [(f"Table-I {n}x{n} k{k} s{st} p{p}", n, n, k,
                               st, p, *PAPER_ARRAY)
                              for n, k, st, p in geos]


@contextlib.contextmanager
def dropped_mac(pv: int = 0):
    """The paper phase's planted fault: every program compiled inside
    loses PV ``pv``'s last ``mac`` μop (one sweep of that PV's PEs)."""
    from repro_torch.core import uop
    compile_program = uop.compile_tconv_program

    def faulty(*args, **kwargs):
        programs, rows = compile_program(*args, **kwargs)
        uops = programs[pv].uops
        last = max(i for i, u in enumerate(uops) if u.kind == uop.UopKind.MAC)
        programs[pv] = uop.PEProgram(uops[:last] + uops[last + 1:])
        return programs, rows
    uop.compile_tconv_program = faulty
    try:
        yield
    finally:
        uop.compile_tconv_program = compile_program


@contextlib.contextmanager
def counting_plain(calls: list):
    """Append one entry to ``calls`` for each call of a GANAX kernel's
    plain version made through ``kernels.ops`` inside."""
    from repro_torch.kernels import ops
    saved = dict(ops._KERNELS)

    def counted(plain):
        def fn(**kwargs):
            calls.append(plain.__name__)
            return plain(**kwargs)
        return fn
    for nd, (cuda, plain) in saved.items():
        ops._KERNELS[nd] = (cuda, counted(plain))
    try:
        yield
    finally:
        ops._KERNELS.update(saved)


def machine_vs_kernel(case: tuple, dev, plain: bool = False) -> dict:
    """One case: x (H, W) and w (k, k) from a numpy generator seeded by
    the geometry; the μop machine's float64 output against one call of
    ``ganax_conv_transpose`` on ``dev`` (its plain version where
    ``plain``) at f32, by ATOL/RTOL in float64 (``err``, ``ok``), and the
    same for the machine with the planted fault (``fault_err``,
    ``fault_ok``); the machine's statistics; its mac count against the
    schedule's consequential MACs."""
    from repro_torch.core.scheduler import make_schedule
    from repro_torch.core.uop import run_tconv_on_machine
    from repro_torch.kernels import ops
    _, h, w_, k, s, p, n_pvs, n_pes = case
    rng = np.random.default_rng(h * 100 + k * 10 + s)
    x = rng.normal(size=(h, w_))
    w = rng.normal(size=(k, k))
    sched = make_schedule((h, w_), (k, k), (s, s), (p, p))
    out, stats = run_tconv_on_machine(x, w, sched, n_pvs=n_pvs,
                                      pes_per_pv=n_pes)
    with dropped_mac():
        faulty, _ = run_tconv_on_machine(x, w, sched, n_pvs=n_pvs,
                                         pes_per_pv=n_pes)
    with torch.inference_mode():
        got = ops.ganax_conv_transpose(
            torch.tensor(x[None, :, :, None], dtype=torch.float32,
                         device=dev),
            torch.tensor(w[:, :, None, None], dtype=torch.float32,
                         device=dev), (s, s), (p, p), plain=plain)
    got = got[0, :, :, 0].double().cpu()

    def gate(machine):
        ref = torch.from_numpy(machine)
        return ((got - ref).abs().max().item(),
                bool(torch.allclose(got, ref, atol=ATOL, rtol=RTOL)))
    (err, ok), (fault_err, fault_ok) = gate(out), gate(faulty)
    return dict(err=err, ok=ok, fault_err=fault_err, fault_ok=fault_ok,
                macs=stats["macs"],
                consequential=sched.consequential_macs(1, 1),
                utilization=stats["utilization"], cycles=stats["cycles"],
                finite=bool(np.isfinite(out).all()))


def kernel_products(layer, dev) -> tuple[int, int]:
    """(the products the kernel's launch of this tconv layer makes at
    batch 1, the layer's consequential MACs): from the kernel's own
    operands (``kernels.ops.kernel_operands``' tap tables and phase
    grid), each phase's taps times the grid's positions times Cin·Cout,
    as the kernel loops over them."""
    from repro_torch.kernels import ops
    x = torch.zeros((1, *layer.in_spatial, 1), device=dev)
    w = torch.zeros((*layer.kernel, 1, 1), device=dev)
    with torch.inference_mode():
        operands = ops.kernel_operands(x, w, layer.strides, layer.paddings,
                                       transposed=True)
    taps = sum(len(ph) for ph in operands["tables"].taps)
    products = taps * math.prod(q_sizes(operands)) * layer.cin * layer.cout
    return products, layer.schedule().consequential_macs(layer.cin,
                                                         layer.cout)


def paper_phase(card: str, dev) -> dict:
    """The paper's own models against the card: (a) every figure row of
    ``repro_torch.paper_figs.run_all`` (the analytical cycle/energy model
    and the μop machine; outputs of the paper's 45 nm model, computed on
    the host, not measured) finite, the Fig. 8 means in the reference
    test's bands, 3D-GAN the largest speed-up and MAGAN the smallest;
    (b) the μop machine's float64 output of each ``machine_cases`` case
    against the ``ganax_conv`` CUDA kernel within ATOL/RTOL, its macs
    equal to the consequential MACs, every call launched on the card and
    none through the plain version; (c) the planted fault
    (``dropped_mac``) fails that gate on every case; (d) the kernel's
    products equal the consequential MACs on every Table-I tconv layer,
    2-D and 3-D; (e) the machine's PE utilization per geometry."""
    from repro_torch import paper_figs
    from repro_torch.configs.gans import GAN_MODELS
    from repro_torch.kernels.ganax_conv import ganax_conv_cuda
    t0 = time.perf_counter()
    # (a) the figure rows
    rows = paper_figs.run_all()
    values = {name: float(v) for name, v, _ in rows}
    check(len(rows) == PAPER_ROWS and all(map(math.isfinite,
                                              values.values())),
          f"paper_figs.run_all gave {len(rows)} rows (want {PAPER_ROWS}, "
          f"all finite)")
    means = {k: values[f"fig8/{k}/mean"] for k in FIG8_BANDS}
    for k, (lo, hi) in FIG8_BANDS.items():
        check(lo < means[k] < hi, f"Fig. 8 mean {k} {means[k]:.4f} outside "
                                  f"({lo}, {hi})")
    speedup = {n: values[f"fig8/speedup/{n}"] for n in GAN_MODELS}
    check(max(speedup, key=speedup.get) == "3dgan"
          and min(speedup, key=speedup.get) == "magan",
          f"Fig. 8 speed-up order: {speedup}")
    print(f"paper: {len(rows)} figure rows of the analytical model (45 nm, "
          f"500 MHz, 16x16 PEs; computed on the host, not measured): "
          f"Fig. 8 mean speed-up {means['speedup']:.4f}x, mean energy "
          f"reduction {means['energy']:.4f}x over EYERISS; 3D-GAN "
          f"{speedup['3dgan']:.4f}x, MAGAN {speedup['magan']:.4f}x")
    # (b) the machine against the kernel; (c) the planted fault
    ganax_conv_cuda.launches = 0
    ganax_conv_cuda.launches_by_route.clear()
    plain_calls: list = []
    results = {}
    with counting_plain(plain_calls):
        for case in machine_cases():
            label = case[0]
            r = results[label] = machine_vs_kernel(case, dev)
            print(f"paper machine vs ganax_conv  {label:26s} on "
                  f"{case[6]}x{case[7]} PEs: max_abs_err {r['err']:.3e} "
                  f"(atol=rtol={ATOL:g}) {'ok' if r['ok'] else 'FAIL'}; "
                  f"macs {r['macs']} = consequential {r['consequential']} "
                  f"{'ok' if r['macs'] == r['consequential'] else 'FAIL'}; "
                  f"dropped mac: {r['fault_err']:.3e} "
                  f"{'PASSES (FAIL)' if r['fault_ok'] else 'fails the gate'}")
            check(r["ok"] and r["finite"],
                  f"{label}: the μop machine and the ganax_conv kernel "
                  f"disagree ({r['err']:.3e})")
            check(r["macs"] == r["consequential"],
                  f"{label}: the machine ran {r['macs']} macs, the "
                  f"schedule has {r['consequential']} consequential")
            check(not r["fault_ok"], f"{label}: the planted dropped mac "
                                     f"passes the gate "
                                     f"({r['fault_err']:.3e})")
    torch.cuda.synchronize()
    launches = ganax_conv_cuda.launches
    routes = dict(ganax_conv_cuda.launches_by_route)
    n_runs = len(results)
    check(launches == n_runs and routes == {"narrow": n_runs}
          and not plain_calls,
          f"paper: {launches} ganax_conv launches by route {routes} and "
          f"{len(plain_calls)} plain calls for {n_runs} runs (want every "
          f"run on the card's narrow route)")
    print(f"paper: {launches} ganax_conv launches ({routes}), "
          f"{len(plain_calls)} through the plain version; worst "
          f"machine-kernel error "
          f"{max(r['err'] for r in results.values()):.3e}, smallest "
          f"planted-fault error "
          f"{min(r['fault_err'] for r in results.values()):.3e} [{card}]")
    # (d) the kernel's products against the consequential MACs
    ratios = {}
    for model, (g, _) in GAN_MODELS.items():
        for layer in g:
            if not layer.transposed:
                continue
            products, conseq = kernel_products(layer, dev)
            ratios[f"{model} {layer.name}"] = products / conseq
            sched_total = layer.schedule().zero_inserted_macs(layer.cin,
                                                              layer.cout)
            print(f"paper products {model} {layer.name} "
                  f"{len(layer.in_spatial)}-D: kernel {products} / "
                  f"consequential {conseq} = {products / conseq:.6f}; "
                  f"inconsequential share of the zero-inserted dataflow "
                  f"{1 - conseq / sched_total:.4f}")
            check(products == conseq,
                  f"{model} {layer.name}: the kernel makes {products} "
                  f"products for {conseq} consequential MACs")
    # (e) the machine's utilization
    for case in machine_cases()[len(UOP_CASES):]:
        r = results[case[0]]
        print(f"paper machine utilization {case[0]:26s} "
              f"{r['utilization']:.4f} over {r['cycles']} cycles (one "
              f"channel on {case[6]}x{case[7]} PEs; not the analytical "
              f"model's Fig. 11 column, which counts Cin*Cout)")
    seconds = time.perf_counter() - t0
    print(f"paper: {len(results)} machine runs, {len(ratios)} Table-I "
          f"tconv layers at products/consequential 1; phase "
          f"{seconds:.1f} s")
    return dict(rows=len(rows), fig8=means, launches=launches,
                errs=[r["err"] for r in results.values()],
                fault_errs=[r["fault_err"] for r in results.values()],
                ratios=ratios, seconds=seconds)


def _widen(tree: dict) -> None:
    """Every leaf to f32, in place, one leaf at a time."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _widen(v)
        else:
            tree[k] = v.float()


def exact_sums() -> None:
    """f32 sums on the card, as the port's kernels keep them: no TF32 in
    PyTorch's matmuls and convolutions (the plain versions, the oracles),
    no reduced-precision reductions in its bf16/f16 GEMMs (the port's
    ``dw`` refuses them)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the whole record as JSON here")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.gans import GAN_MODELS
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_ffma,
                                                     flash_attention_plain,
                                                     flash_attention_wgmma)
    from repro_torch.kernels.ganax_conv import (ganax_conv3d_cuda,
                                                ganax_conv3d_plain,
                                                ganax_conv_cuda,
                                                ganax_conv_plain)
    from repro_torch.core.dataflow import Epilogue
    from repro_torch.models.gan import (GanConfig, generator_epilogues,
                                        init_gan)
    from repro_torch.serve.gan import GanServer

    exact_sums()
    dev = torch.device("cuda", 0)
    record: dict = {"phase_s": {}}
    wrappers = {"ganax_conv": (ganax_conv_cuda, ganax_conv_plain),
                "ganax_conv3d": (ganax_conv3d_cuda, ganax_conv3d_plain),
                "flash_attention": (flash_attention_cuda,
                                    flash_attention_plain),
                # the two kernels behind flash_attention_cuda, each with
                # its own count
                "flash_attention_wgmma": (flash_attention_wgmma,
                                          flash_attention_plain),
                "flash_attention_ffma": (flash_attention_ffma,
                                         flash_attention_plain)}
    gan_wrappers = {k: wrappers[k] for k in ("ganax_conv", "ganax_conv3d")}
    phase_t0 = [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        record["phase_s"][name] = now - phase_t0[0]
        print(f"phase {name}: {now - phase_t0[0]:.1f} s (the card holds "
              f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB)")
        phase_t0[0] = now

    # -- 1. environment and build -----------------------------------------
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(f"card: {card}")
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False; bf16 and f16 products "
          "summed in f32: torch.backends.cuda.matmul."
          "allow_bf16_reduced_precision_reduction = False, "
          "allow_fp16_reduced_precision_reduction = False")
    t0 = time.perf_counter()
    built = build.build()
    build_s = time.perf_counter() - t0
    for name, (source, _) in KERNELS.items():
        check(Path(source).stem in built, f"{name} ({source}) did not build")
    for name, res in built.items():
        print(f"built {name} ({'compiled' if res.compiled else 'cached'}, "
              f"{res.seconds:.1f} s) -> {res.path.name}")
        for line in res.log.splitlines():
            if ("registers" in line or "spill" in line or "Compiling" in line
                    or "Performance Loss" in line):
                print(f"  ptxas: {line.strip()}")
    record["build_s"] = build_s
    phase_done("build")
    # -- 1b. the train steps' times, before anything else runs -------------
    step_times = train_step_times(card, dev)
    phase_done("train step times")

    # -- 2. each kernel against its plain version on the card --------------
    gen = torch.Generator().manual_seed(1234)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(dev)

    cases = {name: [] for name in gan_wrappers}
    timed = set()       # the generator layers, timed in phase 4
    for name, model in (("ganax_conv", "dcgan"), ("ganax_conv3d", "3dgan")):
        g_layers, d_layers = GAN_MODELS[model]
        for l, ep in zip(g_layers, generator_epilogues(g_layers)):
            timed.add(f"{model} {l.name}")
            cases[name].append((f"{model} {l.name}", True, l.in_spatial,
                                l.kernel, l.strides, l.paddings, l.cin,
                                l.cout, ep))
        d2 = d_layers[1]
        cases[name].append((f"{model} d2 (SIMD conv)", False, d2.in_spatial,
                            d2.kernel, d2.strides, d2.paddings, d2.cin,
                            d2.cout,
                            Epilogue(bias=True, activation="leaky_relu")))
    cases["ganax_conv"] += [
        ("k1 s2 zero-tap tconv", True, (16, 16), (1, 1), (2, 2), (0, 0), 64,
         32, Epilogue(bias=True, activation="relu")),
        ("k4 s2 no bias, none", True, (8, 8), (4, 4), (2, 2), (1, 1), 128,
         64, Epilogue())]
    cases["ganax_conv3d"] += [
        ("k1 s2 zero-tap tconv3d", True, (8, 8, 8), (1, 1, 1), (2, 2, 2),
         (0, 0, 0), 64, 32, Epilogue(bias=True, activation="relu")),
        ("ragged Cin 33 Cout 65 3d", True, (5, 6, 7), (3, 3, 3), (2, 2, 2),
         (1, 1, 1), 33, 65, Epilogue(bias=True, activation="leaky_relu"))]
    kernel_errs = {name: [] for name in KERNELS}
    tol_used = {name: 0.0 for name in gan_wrappers}
    layer_rows = {name: [] for name in gan_wrappers}
    with torch.inference_mode():
        for name, (kernel, plain) in gan_wrappers.items():
            for label, transposed, sp, k, s, p, cin, cout, ep in cases[name]:
                x = rand(BATCH, *sp, cin)
                w = rand(*k, cin, cout, scale=(math.prod(k) * cin) ** -0.5)
                b = rand(cout, scale=0.1) if ep.bias else None
                operands = ops.kernel_operands(x, w, s, p,
                                               transposed=transposed)
                got = kernel(**operands, bias=b, activation=ep.activation,
                             leaky_slope=ep.leaky_slope)
                ref = plain(**operands, bias=b, activation=ep.activation,
                            leaky_slope=ep.leaky_slope)
                torch.cuda.synchronize()
                err, ok = max_err(got, ref)
                share = tol_share(got, ref)
                kernel_errs[name].append(err)
                tol_used[name] = max(tol_used[name], share)
                print(f"{name} vs plain  {label:26s} out "
                      f"{tuple(got.shape)} [{route_of(operands)}] "
                      f"max_abs_err {err:.3e} (atol=rtol={ATOL:g}; worst "
                      f"output at {share:.4f} of its tolerance) "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok and bool(torch.isfinite(got).all()),
                      f"{label}: {name} disagrees with its plain version")
                if label in timed:
                    layer_rows[name].append((label, operands, b, ep, x, w, s,
                                             p))
                del got, ref
    phase_done("GAN kernels vs plain")

    # -- 3. the main paths: serve each full-width generator ----------------
    servers = {}
    launches = {}
    serve_routes = {}
    for name, model, shape in (("ganax_conv", "dcgan", (64, 64, 3)),
                               ("ganax_conv3d", "3dgan", (64, 64, 64, 1))):
        cfg = GanConfig(model)
        g_params, _ = init_gan(cfg, torch.Generator().manual_seed(0),
                               device=dev)
        server = GanServer(cfg, g_params, batch_size=BATCH, seed=0,
                           device=dev)
        for kernel, _ in wrappers.values():
            kernel.launches = 0
            if hasattr(kernel, "launches_by_route"):
                kernel.launches_by_route.clear()
        served = [server.generate(n) for n in REQUESTS]
        torch.cuda.synchronize()
        counts = {k: wrappers[k][0].launches for k in wrappers}
        serve_routes[name] = routes_launched(gan_wrappers)[name]
        for n, img in zip(REQUESTS, served):
            check(tuple(img.shape) == (n, *shape),
                  f"{model} generate({n}) gave shape {tuple(img.shape)}")
            check(bool(torch.isfinite(img).all()),
                  f"{model} generate({n}) not finite")
            check(img.abs().max().item() <= 1.0,
                  f"{model} generate({n}) leaves [-1, 1] (tanh output)")
        check(server.samples_served + server.samples_buffered
              + server.samples_discarded
              == server.batches_served * server.batch_size,
              f"{model}: served + buffered + discarded != batches x "
              f"batch_size")
        n_layers = len(cfg.layers[0])
        check(counts[name] == n_layers * server.batches_served,
              f"{model}: {counts[name]} {name} launches for "
              f"{server.batches_served} batches of {n_layers} layers")
        check(all(c == 0 for k, c in counts.items() if k != name),
              f"{model} launched another path's kernel: {counts}")
        launches[name] = counts[name]
        print(f"{model}: served {', '.join(map(str, REQUESTS))}: {server}; "
              f"{counts[name]} {name} launches for "
              f"{server.batches_served} batches; by route "
              f"{serve_routes[name]}")
        # the same stream through the plain version of the kernel on the
        # card
        ref_server = GanServer(GanConfig(model, backend="ganax-plain"),
                               g_params, batch_size=BATCH, seed=0,
                               device=dev)
        ref_img = ref_server.generate(BATCH)
        err, ok = max_err(served[0][:BATCH], ref_img)
        print(f"{model} generator vs plain generator (same latents) "
              f"max_abs_err {err:.3e} (atol=rtol={ATOL:g}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"the {model} generator disagrees with its plain version")
        record[f"{model}_generator_max_abs_err"] = err
        servers[name] = server
        del served, ref_img, ref_server
    phase_done("GAN serving paths")

    # -- 4. times ----------------------------------------------------------
    rows = {name: [] for name in gan_wrappers}
    with torch.inference_mode():
        for name, (kernel, plain) in gan_wrappers.items():
            for label, operands, b, ep, x, w, s, p in layer_rows[name]:
                act = ep.activation
                ms = time_ms(lambda: kernel(**operands, bias=b,
                                            activation=act))
                plain_ms = time_ms(lambda: plain(**operands, bias=b,
                                                 activation=act))
                library_ms = time_ms(library_conv_transpose(x, w, b, s, p))
                dev_ms = device_ms(lambda: kernel(**operands, bias=b,
                                                  activation=act))
                library_dev_ms = device_ms(library_conv_transpose(x, w, b, s,
                                                                  p))
                op_ms = time_ms(lambda: ops.ganax_conv_transpose(
                    x, w, s, p, bias=b, epilogue=ep))
                bound_ms, bound_by, flops, nbytes, fp32_ms = bound(operands,
                                                                   b)
                route = route_of(operands)
                rows[name].append(dict(
                    layer=label, route=route, ms=ms, device_ms=dev_ms,
                    library_device_ms=library_dev_ms, plain_ms=plain_ms,
                    library_ms=library_ms, op_ms=op_ms, bound_ms=bound_ms,
                    bound_by=bound_by, bound_fp32_ms=fp32_ms,
                    gflop=flops / 1e9, mbytes=nbytes / 1e6,
                    launches_per_batch=1))
                lib = "conv_transpose2d" if x.ndim == 4 \
                    else "conv_transpose3d"
                print(f"time {label} [{route}]: kernel {ms:.4f} ms (device "
                      f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, {lib} "
                      f"{library_ms:.4f} ms (device {library_dev_ms:.4f}), "
                      f"whole "
                      f"op {op_ms:.4f} ms, bound {bound_ms:.4f} ms "
                      f"({bound_by}; FP32 bound {fp32_ms:.4f} ms; "
                      f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) "
                      f"[{card}]")
            r = rows[name]
            tot = {k: sum(row[k] for row in r) for k in
                   ("ms", "library_ms", "bound_ms", "bound_fp32_ms",
                    "device_ms", "library_device_ms")}
            print(f"{name} serving, a batch ({len(r)} launches): kernels "
                  f"{tot['ms']:.4f} ms, cuDNN {tot['library_ms']:.4f} ms "
                  f"(kernels/cuDNN {tot['ms'] / tot['library_ms']:.3f}); as "
                  f"the device runs them: kernels {tot['device_ms']:.4f} ms, "
                  f"cuDNN {tot['library_device_ms']:.4f} ms; "
                  f"bound {tot['bound_ms']:.4f} ms (share "
                  f"{tot['bound_ms'] / tot['ms']:.3f}), FP32 bound "
                  f"{tot['bound_fp32_ms']:.4f} ms [{card}]")
            server = servers[name]
            z = torch.randn((BATCH, server.cfg.z_dim), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
            gen_ms = time_ms(lambda: server.generator(z))
            prof = profile(lambda: server.generator(z), 5,
                           "generator forwards")
            per_s = BATCH / (gen_ms / 1e3)
            model = server.cfg.name
            unit = "images" if name == "ganax_conv" else "volumes"
            print(f"{model} generator forward at batch {BATCH}: "
                  f"{gen_ms:.4f} ms, {per_s:.1f} {unit}/s [{card}]")
            record[model] = dict(layers=rows[name], generator_ms=gen_ms,
                                 per_s=per_s, unit=unit, profile=prof,
                                 routes=serve_routes[name])
    # the timed layers' operands, the last server and the loops' last
    # tensors go before the phases that need the card whole (3D-GAN's
    # batch-64 tensors: 1.28 GB of them were still held at the qwen phase)
    servers.clear()
    layer_rows.clear()
    del server, z, x, w, b, operands, img, g_params
    torch.cuda.empty_cache()
    phase_done("GAN times")
    # -- 4b. the serving stack: GanEngine, programs, obs --------------------
    engine = record["gan_engine"] = gan_engine_phase(card, dev, wrappers)
    launches["ganax_conv"] += engine["launches"]
    phase_done("gan_engine")
    for name, n in program_phase(dev, wrappers).items():
        launches[name] += n
    phase_done("program")
    record["obs"] = obs_phase(dev, wrappers)
    torch.cuda.empty_cache()
    phase_done("obs")
    # -- 4c. bf16 / f16 storage and int8 programs ----------------------------
    quant = record["quant"] = quant_phase(card, dev, wrappers)
    phase_done("quant")

    # -- 5. training: every launch geometry of the step, kernel vs plain --
    record["train_geometries"] = train_geometries(card, dev, gan_wrappers,
                                                  kernel_errs, tol_used)
    for name, used in tol_used.items():
        print(f"{name}: the worst output of every serving and training "
              f"geometry at {used:.4f} of its tolerance (atol=rtol={ATOL:g})")
    record["tol_used"] = tol_used
    phase_done("training geometries")
    # -- 6. the training paths (DCGAN quickstart, 3D-GAN) ------------------
    train_launches, train_routes = train_paths(dev, wrappers)
    phase_done("training paths")
    # -- 7. one step against ganax-plain, profiles --------------------------
    record["train"] = train_parity_and_profiles(card, dev, step_times)
    phase_done("training parity and profiles")
    # -- 7b. mixed-precision training; 7c. the autotuning planner -----------
    mixed = record["mixed_train"] = mixed_train_phase(card, dev, wrappers)
    phase_done("mixed_train")
    tune = record["tune"] = tune_phase(card, dev, wrappers)
    phase_done("tune")
    # -- 7d. the paper's models: the μop machine against the kernel ---------
    paper = record["paper"] = paper_phase(card, dev)
    phase_done("paper")
    # -- 8. the flash-attention kernel against its plain version -----------
    for key, errs in flash_geometries(dev).items():
        kernel_errs[FLASH_VARIANTS.get(key, key)] = errs
    phase_done("flash_attention vs plain")
    # -- 9. the LLM serving path: full-width Gemma-7B ----------------------
    llm = record["llm"] = llm_serving(card, dev, wrappers)
    phase_done("Gemma-7B serving")
    # -- 9b. LLM training: full-width Gemma-7B with its depth cut -----------
    roofline_steps: dict = {}
    llm_train = record["llm_train"] = llm_train_phase(
        card, dev, wrappers, kernel_errs, roofline=roofline_steps)
    phase_done("llm_train")
    # -- 9c. Gemma3-4B: sliding-window and global layers --------------------
    gemma3 = record["gemma3"] = gemma3_phase(card, dev, wrappers)
    phase_done("gemma3")
    # -- 9d. MiniCPM3-4B: multi-head latent attention, split head dims -----
    minicpm3 = record["minicpm3"] = minicpm3_phase(card, dev, wrappers)
    phase_done("minicpm3")
    # -- 9e. mixture of experts: OLMoE-1B-7B, Llama-4-Scout ----------------
    moe = record["moe"] = moe_phase(card, dev, wrappers)
    phase_done("moe")
    # -- 9f. SSM and hybrid blocks: Mamba2-2.7B, Hymba-1.5B -----------------
    ssm = record["ssm"] = ssm_phase(card, dev, wrappers)
    phase_done("ssm")
    # -- 9g. the encoder and the VLM: HuBERT-XLarge, InternVL2-26B ---------
    enc = record["encoder_vlm"] = encoder_vlm_phase(card, dev, wrappers)
    phase_done("encoder_vlm")
    # -- 9h. Qwen1.5-32B at full width: served, decoded from an int8 cache --
    qwen = record["qwen"] = qwen_phase(card, dev, wrappers,
                                       roofline=roofline_steps)
    phase_done("qwen")
    # -- 9i. the dry-run's counts of those steps against the card ----------
    record["roofline"] = roofline_phase(card, roofline_steps)
    roofline_steps.clear()
    phase_done("roofline")
    # -- 10. programs sharded over two gloo ranks sharing the card ---------
    mesh = record["mesh"] = mesh_phase(card, dev)
    phase_done("mesh")
    record.update(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  launches={"serve": launches, "train": train_launches,
                            "llm": llm["launches"],
                            "llm_train": llm_train["launches"],
                            "gemma3": gemma3["launches_wgmma"],
                            "gemma3_ffma": gemma3["launches_ffma"],
                            "minicpm3": minicpm3["launches"],
                            "minicpm3_train": minicpm3["train"]["launches"],
                            "minicpm3_f32": minicpm3["launches_f32"],
                            "minicpm3_tiny_bf16":
                                minicpm3["tiny_launches_bf16"],
                            "minicpm3_tiny_f32":
                                minicpm3["tiny_launches_f32"],
                            "moe": moe["launches"],
                            "moe_train": moe["train"]["launches"],
                            "moe_f32": moe["launches_f32"],
                            "scout": moe["scout"]["launches"],
                            "hymba": ssm["hymba"]["launches"],
                            "hymba_train": ssm["hymba"]["train"]["launches"],
                            "hymba_f32": ssm["launches_f32"],
                            "mamba2": ssm["mamba2"]["launches"],
                            "hubert": enc["launches_80"],
                            "hubert_f32": enc["launches_80_f32"],
                            "internvl2": enc["launches_128"],
                            "internvl2_f32":
                                enc["internvl2"]["launches_f32"],
                            "qwen": qwen["launches"]},
                  launches_by_route={"serve": serve_routes,
                                     "train": train_routes})

    kernels = []
    for name in gan_wrappers:
        source, replaces = KERNELS[name]
        r = rows[name]
        total_bound = sum(row["bound_ms"] for row in r)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            # the serving path's launches, the training path's, the
            # tuner's (the auto programs' served batch), the mesh's
            # (both ranks and the world of one) at f32 and the paper
            # phase's (the μop machine's geometries)
            "launches": launches[name] + train_launches[name]
            + tune["launches"][name].get("float32", 0)
            + mesh["launches"][name].get("float32", 0)
            + (paper["launches"] if name == "ganax_conv" else 0),
            "max_abs_err": max(kernel_errs[name]),
            # per batch of the path: the sum over its four launches
            "ms": sum(row["ms"] for row in r),
            "plain_ms": sum(row["plain_ms"] for row in r),
            "bound_ms": total_bound,
            "bound_by": ("operations" if sum(
                row["bound_ms"] for row in r
                if row["bound_by"] == "operations") >= total_bound / 2
                else "bytes"),
            "library_ms": sum(row["library_ms"] for row in r),
        })
    # over the LLM serving path's launches: each prompt length timed once,
    # times its requests, times the layers; the wgmma kernel runs them
    # all, and the training path's (counted with them)
    flash = llm["flash_per_path"]
    fa_ops = sum(r["ops_ms"] * r["requests"] for r in llm["flash_rows"])
    fa_hbm = sum(r["hbm_ms"] * r["requests"] for r in llm["flash_rows"])
    kernels.append({
        "name": "flash_attention_wgmma",
        "route": "cuda",
        "source": KERNELS["flash_attention_wgmma"][0],
        "replaces": KERNELS["flash_attention_wgmma"][1],
        "launches": llm["launches"] + llm_train["launches"]
        + gemma3["launches_wgmma"] + moe["launches_wgmma"]
        + enc["launches_128"] + qwen["launches"]
        + sum(mesh["lm"]["flash"].get("flash_attention_wgmma", {})
              .values()),
        "max_abs_err": max(kernel_errs["flash_attention_wgmma"]
                           + moe["errs_wgmma"]
                           + [qwen["launch"]["max_abs_err"]]),
        "ms": flash["ms"],
        "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": "operations" if fa_ops >= fa_hbm else "bytes",
        "library_ms": flash["library_ms"],
    })
    # the FFMA kernel over the f32 check's prefill (one launch a layer);
    # its instances at dk == dv (the split ones are listed below)
    f32 = llm["f32_flash"]
    kernels.append({
        "name": "flash_attention_ffma",
        "route": "cuda",
        "source": KERNELS["flash_attention_ffma"][0],
        "replaces": KERNELS["flash_attention_ffma"][1],
        "launches": f32["launches"] + gemma3["launches_ffma"]
        + moe["launches_f32"] + enc["internvl2"]["launches_f32"]
        + sum(mesh["lm"]["flash"].get("flash_attention_ffma", {})
              .values()),
        "max_abs_err": max(kernel_errs["flash_attention_ffma"]
                           + moe["errs_ffma"]),
        "ms": f32["ms"] * f32["launches"],
        "plain_ms": f32["plain_ms"] * f32["launches"],
        "bound_ms": f32["bound_ms"] * f32["launches"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"] * f32["launches"],
    })
    # the split instances (MLA): launches on MiniCPM3's paths (serving
    # and training at full width through the wgmma kernel's bf16 (96,
    # 64); the f32 check, the tiny preset's train CLI and f32 engine
    # through the FFMA kernel's); times of one launch at the path's
    # geometry (the longest served prompt, the f32 check's, the tiny
    # CLI's step and the tiny engine's longest prompt).  The FFMA
    # kernel's bf16 (96, 64), the wgmma instance's yardstick, launches 0
    # times on a path; its time is on the served prompt's q, k, v.
    serve96 = minicpm3["launch"]
    for (variant, dtype, dk, dv), n, row in (
            ((serve96["variant"], torch.bfloat16, 96, 64),
             minicpm3["launches"] + minicpm3["train"]["launches"], serve96),
            (("ffma", torch.float32, 96, 64), minicpm3["launches_f32"],
             minicpm3["launch_f32"]),
            (("ffma", torch.bfloat16, 48, 32),
             minicpm3["tiny_launches_bf16"], minicpm3["tiny_launch_bf16"]),
            (("ffma", torch.float32, 48, 32), minicpm3["tiny_launches_f32"],
             minicpm3["tiny_launch_f32"]),
            (("ffma", torch.bfloat16, 96, 64), 0,
             dict(serve96, **serve96["ffma"]))):
        name = split_instance(dtype, dk, dv, variant)
        source, replaces = KERNELS[FLASH_VARIANTS[variant]]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": n,
            "max_abs_err": max(kernel_errs[name] + [row["max_abs_err"]]),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    # the hd-64 instances on Hymba's global layers and the hd-80 ones on
    # HuBERT-XLarge's: the wgmma kernel's bf16 one on the serving (or
    # encoding) and training paths (one launch at the longest served
    # prompt or utterance timed), the FFMA kernel's f32 one on the f32
    # checks (Hymba's f32 gradient gate too; one launch at the check's
    # prompt timed); the FFMA kernel's bf16 one, the wgmma instance's
    # yardstick, launches 0 times on a path, timed on the served q, k, v
    hymba, hub = ssm["hymba"], enc["hubert"]
    for hd, serve_row, others, f32_row, n_bf16, n_f32 in (
            (64, hymba["launch"], [hymba["train"]["launch"]],
             hymba["launch_f32"], ssm["launches_bf16"],
             ssm["launches_f32"]),
            (80, hub["launch"], [hub["launch_train"], hub["launch_long"]],
             hub["launch_f32"], enc["launches_80"],
             enc["launches_80_f32"])):
        for (variant, dtype), n, row, errs in (
                ((serve_row["variant"], torch.bfloat16), n_bf16, serve_row,
                 [r["max_abs_err"] for r in [serve_row] + others]),
                (("ffma", torch.float32), n_f32, f32_row,
                 [f32_row["max_abs_err"]]),
                (("ffma", torch.bfloat16), 0, dict(serve_row,
                                                   **serve_row["ffma"]),
                 [r["ffma"]["max_abs_err"] for r in [serve_row] + others])):
            name = split_instance(dtype, hd, hd, variant)
            source, replaces = KERNELS[FLASH_VARIANTS[variant]]
            kernels.append({
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": n,
                "max_abs_err": max(kernel_errs.get(name, []) + errs),
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
            })
    # the storage-dtype instances of both GANAX kernels, on the quant
    # phase's main path, the mixed-precision training path and the
    # tuner's; times per 64-batch of the generator's 4 launches
    for name, model in (("ganax_conv", "dcgan"), ("ganax_conv3d", "3dgan")):
        source, replaces = KERNELS[name]
        for dname, suffix in (("bfloat16", "bf16"), ("float16", "f16")):
            t = quant["times"][f"{model}_{dname}"]
            kernels.append({
                "name": f"{name}_{suffix}",
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": quant["launches"][name][dname]
                + mixed["launches"][name][dname]
                + tune["launches"][name].get(dname, 0)
                + mesh["launches"][name].get(dname, 0),
                "max_abs_err": max(quant["errs"][f"{name}_{dname}"]),
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"],
                "library_ms": t["library_ms"],
            })
    record["kernels"] = kernels
    print("seconds per phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in record["phase_s"].items()))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
