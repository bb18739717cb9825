#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check what it computes.

    python3 chip_smoke.py

    python3 chip_smoke.py --safe-export <dir>   # phase 21's child
    python3 chip_smoke.py --export <dir> <dtype> <int8|none>   # phase 22's
    python3 chip_smoke.py --remat-ab                # phase 42's child

Phases (each prints JSON lines; any failure exits non-zero and prints no
final result):

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions, the build of the kernel libraries from
   maskunet_tpu_torch/csrc (seconds, ptxas registers and spills; those of
   K4's, K1/K2/K6's and K3/K5/K7's wgmma instantiations named, and 0 spill
   bytes required: phases device_k4, device_k1 and device_k3), and the
   body K4, K1/K2 and K3 run in bf16 at each C (wgmma or mma_sync).
2. kernel: K1 `flash_fwd_nomax` against its plain PyTorch version at the
   six serving attention shapes (batch 8, 128x128 images) in bf16 and f32,
   plus a ragged shape, a fully-masked row (must give 0) and a NaN-poisoned
   K row (must give NaN); in bf16 also, at each C its wgmma body takes,
   with and without use_valid, at shapes whose Lq is no multiple of the
   128-query block (or below it) and whose Lk is no multiple of the key
   step, batch 2-3: the edges of its TMA maps and store.
3. kernel_lse, kernel_bwd: K2 `flash_fwd_nomax_lse` (o and lse, K1's
   cases) and K4 `flash_bwd` (dq, dk, dv) against their plain versions at
   the same shapes and cases, both dtypes; K4 also, at each C its wgmma
   body takes,
   at shapes whose Lq is no multiple of the 64-query step (or below it)
   and whose Lk is no multiple of the key tile, batch 2-3: the edges of
   its TMA maps and dQ reduction.
4. serving: `serve.build_model_runner` on the ADE model (c_out 150, 128x128,
   batch 8, bf16, random weights from the recipe seed) behind the serving
   micro-batcher; 16 requests from 4 threads, each answer equal to a direct
   runner call; the kernel must launch 6 times per forward; the model's
   logits on the kernel agree with the logits on its plain version.
5. serving times: the serving forward (ms per batch, img/s), a device
   profile of it, and per attention shape K1 (its body named), its plain
   version, the PyTorch library call computing the same function (timed
   only) and the bound.
6. train: the ADE training step (c_out 150, 128x128, batch 8, bf16, recipe
   seed 42, AdamW lr 5e-5 and weight decay 0.1, the recipe's cached masks
   with precomputed plans) on a fixed synthetic batch: one step launches
   K2 and K4 6 times each and K1 never, one eval step launches K1 6 times,
   the gradients through the kernels agree with those through their plain
   versions (f32: cosine >= 0.99 per tensor; bf16: the loss within 1%, and
   every tensor as close to the f32 gradient as the plain path's), and 10
   steps keep the loss finite and lower it.
7. train times: ms per step and img/s, a device profile of 3 steps, and per
   attention shape K2 and K4 against their plain versions, their bounds and
   the library's forward and backward (each line names the kernel's
   body).
8. kernel_online, kernel_bwd_noclamp: K3 `flash_fwd_online` (o and lse)
   and K4 with `clamp=False` on K3's lse against their plain versions at
   the same shapes and cases, both dtypes, plus a fully-masked row without
   use_valid (K3 gives the mean of V) and exact scores far past the clamp
   at 60 (where K4 clamped and unclamped must differ); K3 also, in bf16 at
   each C its wgmma body takes, K1's edge shapes with and without
   use_valid and a fully-masked row at a ragged Lk, both ways; K4 its own
   edge shapes.
9. safe_serving, safe_train: the same serving and training paths with the
   safe softmax on (`flash_attention._SAFE_SOFTMAX`, what
   MASKUNET_SAFE_SOFTMAX=1 sets): a forward launches K3 6 times and K1
   never; a training step launches K3 6 and K4 6 times (all unclamped),
   K1 and K2 never; an eval step K3 6 times; logits and gradients against
   the plain versions as in 4 and 6; 10 steps lower the loss; wall and
   device times of both.
10. online_time: K3 per attention shape (its body named) against its
    plain version, its bound and the library.
11. tools: the A/B tools' K5 `softmax_ab.old_flash_fwd`, K6
    `softmax_ab.nomax65_fwd` (clamped and not; its repack kernel
    `softmax_ab.repack65` exactly) and K7
    `bf16_softmax_experiment.flash_fwd_bf16` against their plain versions
    at the tools' attn6 inputs, and at ragged shapes: K5 and K7 with a
    fully-masked row (the mean of V), K6 D and E with a general 65th
    channel, scores past 60 (where D and E differ) and a NaN-poisoned key
    row; the three tool mains (the kernels' main path), then each
    kernel's time, plain time, bound and library time.
12. loop: the training loop on the ADE model (c_out 150, 128x128, batch 8,
    bf16) over the seeded synthetic dataset at that size (64 training and
    16 validation examples): `train` for 2 epochs with validation every
    epoch (2 batches) and a checkpoint every 4 steps, counters zeroed just
    before: 16 steps launch K2 and K4 6 times each, each validation batch
    K1 6 times, no other kernel; a finite history at steps 8 and 16; best
    and latest checkpoints. Then the latest checkpoint restores the
    returned state bit for bit, `train(resume=True, max_epochs=3)` runs
    the third epoch only (step 16 to 24), and `build_model_runner` on the
    workdir answers 8 requests through the batcher, equal to a direct
    folded forward of the final state (the same logits, bit for bit).
    Prints the loop's img/s and the seconds its saves held it.
13. loop_time: the host's gaps between train steps (median, mean, max)
    in the `loop` run, in the same 2 epochs without saves or validation,
    with every batch already on the card (no prefetch thread), and for
    the bare step on one batch: what each layer of the loop costs.
14. panoptic_loop: the ADE panoptic recipe (CE 0.9 + triplet 0.1 on the
    150 logits) over the synthetic dataset with instance ids, run as in
    `loop`: 16 steps launch K2 and K4 6 times each, each validation batch
    of both passes (the loss pass and the evaluator's) K1 6 times, no
    other kernel; val_pq and val_ap each epoch, finite. Then one step on
    injected triplets (its loss equals 0.9 CE + 0.1 triplet within 1e-6
    relative, the triplet finite and positive and, within 1e-4 relative,
    equal to `triplet_from_indices` on the logits of a forward of its
    own with the same dropout draws), the f32 gradients with those
    triplets through the kernels against the plain path (cosine >= 0.99
    per tensor), and 10 steps that lower the loss. Prints the
    evaluator's seconds (device eval and host decode) and the loop's img/s
    and median step gap beside the semantic loop's.
15. instance_loop: the Cityscapes instance recipe (19 classes, a 16-d
    embedding head, the boundary head, CE ignoring 255 + triplet 0.5 on
    the embeddings) over the synthetic dataset, run and checked as in 14,
    with val_ap each epoch, and its step on injected triplets checked as
    in 14 (the triplet on the embeddings); then the DBSCAN of the first
    validation batch's embeddings on the card (ms per image) gives the
    masks of its own run on the CPU, image by image.
16. image_io (run right after `device`): `data/image_check.py`'s fixed
    set decoded and resized through cv2 on this host (a committed JPEG
    and 8-bit PNG, a 16-bit Cityscapes-style PNG, a seeded image and id
    map resized INTER_LINEAR and INTER_NEAREST to 128x128): every sha256
    equals the digest the CPU tests pin; the host's cv2 version, and
    whether matplotlib imports.
17. recipes: the port's `make_fake_dataset` writes the ADE (151
    classes), COCO (133 panoptic categories) and Cityscapes (19) layouts,
    16 training and 8 validation images of 96 px; each of the nine
    recipes (batch capped at 8, 128x128, bf16) trains 1 epoch on 8 of
    the training images through the readers with validation, counters zeroed before each: K2 and K4 6
    times a step, K1 6 times a validation batch of each pass, nothing
    else; a finite loss and val_miou (val_pq, val_ap); img/s.
18. predict: `predict_directory` on the card with the ade_panoptic state
    of 17 over 11 fake images (instances, the panoptic export, panels if
    matplotlib imports; without it a panel raises naming it): K1 6 times
    a batch, each mask the argmax of a direct eval forward of its batch,
    and its agreement with the folded bf16 forward.
19. data_rate: a fake ADE layout of 64 images at 512 px: ms per image to
    decode and resize to 128 px on this host, the `BatchIterator` (4 I/O
    threads) and `Prefetcher` img/s against the bare train step's.
20. op_dispatch (right after the serving times): the serving forward with
    K1 launched directly, as the eager wrapper does, and through the
    operator `maskunet::flash_fwd_nomax` that exported artifacts call, in
    3 rounds of turns: 6 launches a forward both ways, the mean device ms
    of 6 samples a way within 2%, wall ms.
21. export (after predict): the ADE serving model (c_out 150, 128x128,
    batch 8, bf16, seeded init) exported with `torch.export` and loaded
    back: over 16 images its maps equal the live runner's exactly, K1 6
    launches a forward through the operator; bytes, ms a batch against
    the live runner; in a subprocess with MASKUNET_SAFE_SOFTMAX=1 (this
    script with `--safe-export <dir>`) the safe artifact, K3 6 a forward,
    equal to the safe live runner; `serve --artifact` in a subprocess
    answers 4 HTTP requests with the runner's maps.
22. int8: the same model with int8 convs, dynamic and calibrated on the
    16 fake ADE images of 17: argmax agreement with bf16 above 0.85, an
    image's map independent of its batch-mates (exact), no float conv,
    K1 6 a forward; the int8 artifact agrees with the live int8 runner
    above 0.95, and in f32 is under 0.45 of the float artifact's bytes
    (JAX's bounds, tests/test_quantize.py); ms a batch int8 vs bf16. Its
    three artifacts are exported by children of this script (`--export`)
    started with phase 21, so that their tracing overlaps it.
23. cli: `python -m maskunet_tpu_torch.cli` in subprocesses on the fake
    layouts: recipes, train (ade_semantic 4 steps, city_instance 2),
    visualize (fails naming matplotlib where the host has none),
    evaluate (semantic; instances), predict, export --quantize int8,
    import-torch of a `module.`-prefixed .pth of the trained state, and
    evaluate of the import, equal to the source's; JSON keys as JAX's.
    cli_parallel, in the same stages: `train --n-data 1` and `evaluate
    --n-data 1` (one NCCL rank; its evaluation equals the plain one) and
    `train --pipeline 2`, which on a one-card host exits 2 with one line
    naming the device count, as JAX's pipeline mesh refuses one device.
24. dp_train: two gloo ranks on the one card (NCCL refuses two ranks on
    one GPU), each on 4 rows of a global batch of 8 (c_out 150, 128x128,
    the recipe's cached masks), f32 then bf16, SGD: 1 f32 step and 2 bf16
    steps a rank, each launching K2 6 and K4 6; a DP eval step, K1 6 a
    rank. The same spawn of two ranks then runs the dp x pp step of 26
    and the parts of 28 and 29 (one CUDA init and library load a rank). Against the
    one-process step on the same global batch and state: loss and mIoU
    within 1%, the running stats, the f32 updates per tensor (cosine >=
    0.99) and the bf16 rule of phase 6 against the f32 update. Wall and
    device ms of each rank's step (two ranks share the card's SMs: no
    speedup is claimed).
25. dp_nccl: one NCCL rank on the card (this process, in a group it
    destroys after) runs the DP step through `make_mesh(n_data=1)`; it
    equals the step with no mesh (f32).
26. pipeline: `pipeline_apply` with both stages on cuda:0 (two streams,
    the decoder issued from a worker thread), 2 microbatches of 4: the
    forward and running stats, and the pipelined step's SGD update (f32),
    equal the sequential per-microbatch loop; a bf16 step launches K2 24
    (12 and their recompute under torch.utils.checkpoint) and K4 12; the
    wall ms of 2 steps, the device ms and the measured overlap of the two
    stage streams in a profiled one;
    then one dp x pp step (2 ranks x 2 microbatches of 2 rows) against the
    one-process sequential loop.
27. dp_serve: `build_model_runner` over a 2-replica mesh on cuda:0 answers
    16 requests, K1 6 a forward a replica; its maps equal the single-
    device runner's exactly in f32, and in bf16 the single-device
    computation of each replica's rows (the 8-row runner within the
    serving agreement bound: bf16 rounds a batch's last row otherwise);
    `serve --n-data 2` on this one-card host exits 2 with one line.
28. tp: a 1x2 (data, model) mesh of the two ranks of 24, each computing
    half the output channels of bottom1's and bottom2's convs on the
    whole global batch of 8, f32 then bf16, SGD, with 24's checks against
    the same one-process steps (K2 6 and K4 6 a rank a step, K1 6 a rank
    an eval step); bottom3's output whole on each rank (8 x 16 x 16 x
    256); wall and device ms of a step; then `build_model_runner` over a
    1x2 mesh that this process drives (f32): K1 6 a forward, maps as the
    single-device runner's.
29. ring: ring attention at attn6's shape ([8, 16384, 64], 8,192 tokens a
    rank, a fully-masked batch row) over the two ranks of 24: the forward
    in f32 and bf16 against the port's plain masked attention at the
    kernels' tolerances, no NaN; the f32 gradients of the token shards
    and the parameters within 5e-4 of the plain ones; wall and device ms;
    the transport (gloo's send and receive take host memory only, so the
    shards cross through host buffers).
30. res256 (after tools): the 256 px configuration through
    `tools/res256_bench.run` in this process, batch 8, the folded bf16
    forward then the train step (AdamW 5e-5 / 0.1, random labels), each
    with its peak memory reset: K1 6 a forward, K2 6 and K4 6 a step
    over the run's calls, a finite loss that falls over 10 steps; wall
    and device ms, img/s, busy share, peak GB. Then K1, K2 and K4 at the
    six 256 px shapes (attn2 and attn4 compacted to 2,560 slots, attn6
    65,536 x 34,304), launched on the batch and held on rows 0 and 7,
    one row at a time, against their plain versions under the bounds of
    2 (bf16), with each one's ms a launch against its bound; and the
    folded forward at batch 1 through the kernels against the plain
    path, on a served uint8 image and on a normal one: bf16 logits
    within the serving bound of 4, f32 logits within the f32 kernel
    bound of 2, and on the served image the bf16 argmax agreement of 4.
31. serve_bench: `tools/serve_bench.py` in a subprocess with the JAX
    tool's defaults (400 requests, concurrency 16, 4 client processes),
    PNG then raw: no failed request, req/s, p50 and p99, a filled batch,
    the server's K1 launches 6 a batch, no client importing torch.
32. serve_breakdown: `tools/serve_breakdown.py` at batch 8 and 16 threads
    in this process: the A/B/C split, stage A within 25% of the serving
    forward's wall-clock img/s, timed as in 5 just before and just after
    the tool (the host's speed drifts over the script's minutes).
33. mfu: `tools/mfu_report.model_flops` at 128 and 256 px over the wall
    and device times of the serving, train_time and res256 phases
    (nothing timed again): every MFU in (0, 1).
34. profile: `tools/profile_step.run` in this process at 128 px (batch 8,
    3 traced calls) and 256 px (batch 8, 1), the folded bf16 forward and
    the train step each warmed and then traced: the top device ops a
    call by the profiler's kernel names (`tools/parse_xplane`); the
    trace names K1 6 times a forward, K2 and K4 6 times each a step, as
    the launch counters count them; the trace's device ms a call within
    15% of `utils/profiling.device_ms_per_call` on the same call.
35. paritycheck: `tools/tpu_kernel_paritycheck.py`'s main: the flash path
    against dense attention, forward and gradient in exact f32, at L
    1,024 / 2,048 / 4,096 (C 64) and 4,096 (C 128), batch 2, and at
    16,384 (C 64, batch 1, the compacted path) against the chunked dense
    reference: JAX's gate at each, K1, K2 and K4 launched at each.
36. training_parity: `tools/training_parity.py` at its defaults (20 steps
    at 16 px, the four loss patterns): the port's step against the torch
    oracle (tests/torch_oracle.py, loaded by path) on the card in exact
    f32; steps 0 and 1 within 1e-5 and 1e-4 in each pattern, JAX's three
    gates in each but `embed`, where any two f32 implementations part
    chaotically (PARITY_CHAOTIC): its statistics and verdict printed.
37. breakdowns: `tools/fwd_breakdown.py` (six modes), `train_breakdown.py`
    (full, noattn, no16k, nodrop, nobnstat, sgd) and `trunk_breakdown.py`
    (five variants) at batch 8, 128 px, with windows of 5 calls, best of
    2, and 2 device-time calls (the step: 1): wall and device ms of
    each; the flash
    launches as each mode leaves them; 'full' within 15% of the serving
    and train profiles' device ms; every patched function the original
    again after each tool.
38. data_bench (after data_rate, on its 512 px layout): `tools/
    data_bench.run` at 1 and 4 threads, 1 epoch: JAX's keys, the 64
    images delivered to the card each time.
39. eval_scale: `tools/eval_scale_bench.py` at 500 images x 120
    categories in a subprocess started before phase 34 (host work, beside
    the card's phases 34-37): the native library loaded, JAX's JSON keys.
40. ab_tools (beside 23's stage B, while its processes run):
    `tools/{infer_ab,plan_ab,opt_ab,quant_ab,conv_ab,conv_model_ab,
    lane_ab}.py` in this process at batch 8, 128 px, one window of 3
    calls a timed function and one device-time call (`conv_model_ab`
    with `--train`):
    finite wall times; each tool's K1, K2 and K4 launches counted call by
    call; int8 agreement with bf16 above JAX's 0.85; im2col within the
    bf16 bound of 2 of cuDNN's conv at each of the 20 shapes; the conv
    restored after `conv_model_ab`.
41. attn_tools: `tools/{attn_microbench,fwd_sweep,bwd_sweep}.py` at
    batch 8, bf16, on the committed kernels (the sweeps' `source` row,
    through the same swap of the wrappers' entry lookup as a variant):
    K1 for each forward call, K2 and K4 for each gradient call; finite
    times; the lookup restored.
42. remat: `tools/remat_ab.py` at 256 px, batch 8, in a child
    (`--remat-ab`, so that an out-of-memory leaves no allocator state in
    this process) started after fake_layouts and run beside 17, 18 and
    21, its allocator held to 0.75 of the card: the interleaved cost A/B
    and both batch walks to their first out-of-memory, each walk's
    largest batch with its peak memory; K2 and K4 launched (K2 more: the
    remat steps run each block again).
43. bf16_validation (after 41): `tools/bf16_validation.py` at 1 epoch,
    32 px: both rows with JAX's keys and finite metrics, JAX's verdict
    printed (one epoch decides nothing; the tool's 30 epochs at 64 px run
    alone).
44. fraction_sweep (after data_bench, on the fake COCO layout):
    `tools/run_fraction_sweep.py` (coco_panoptic, fractions 0.5 and 1.0,
    1 epoch, batch 8): one row a fraction with JAX's keys, K1, K2 and K4
    launched; `tools/plot_sweep.py` draws it or, on a host without
    matplotlib, raises naming it.

It imports torch, numpy and the port, nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

from maskunet_tpu_torch import export as export_lib
from maskunet_tpu_torch import serve
from maskunet_tpu_torch.core import checkpoint as ckpt_lib
from maskunet_tpu_torch.core import layers
from maskunet_tpu_torch.data import ade20k, image_check, resize
from maskunet_tpu_torch.evaluation import clustering
from maskunet_tpu_torch.losses import triplet as triplet_lib
from maskunet_tpu_torch.models import maskattn_unet as mu
from maskunet_tpu_torch.ops import flash_attention as fa
from maskunet_tpu_torch.ops import flash_kernels as fk
from maskunet_tpu_torch.tasks import evaluators, predict, recipes
from maskunet_tpu_torch.tasks.datasets import make_datasets
from maskunet_tpu_torch.tools import bf16_softmax_experiment as bf16_tool
from maskunet_tpu_torch.tools import make_fake_dataset as fake_data
from maskunet_tpu_torch.tools import (attn_microbench, bf16_validation,
                                      bwd_sweep, conv_ab, conv_model_ab,
                                      data_bench, fwd_breakdown, fwd_sweep,
                                      infer_ab, lane_ab, mfu_report,
                                      opt_ab, parse_xplane, plan_ab,
                                      plot_sweep, profile_step, quant_ab,
                                      remat_ab, res256_bench,
                                      run_fraction_sweep, serve_breakdown,
                                      softmax_ab, tpu_kernel_paritycheck,
                                      train_breakdown, training_parity,
                                      trunk_breakdown)
from maskunet_tpu_torch.train import loop as train_loop
from maskunet_tpu_torch.train import step as train_step
from maskunet_tpu_torch.utils import torch_import
from maskunet_tpu_torch.utils import visualize
from maskunet_tpu_torch.utils.profiling import device_ms_per_call

BATCH = 8
IMG = 128
NUM_CLASSES = 150
# (layer, Lq, Lk after compaction, C, use_valid) of the serving forward
SERVING_SHAPES = (
    ("attn1", 4096, 2560, 128, False),
    ("attn2", 1024, 1024, 256, True),
    ("attn3", 256, 256, 256, True),
    ("attn4", 1024, 1024, 128, True),
    ("attn5", 4096, 2560, 64, False),
    ("attn6", 16384, 9216, 64, False),
)
# kernel vs plain version, both scaled to the output itself (the serving
# shapes' outputs are far below 1, so no floor of 1):
#   max|diff| <= TOL * max|plain|      f32: f32 noise (other summation
#     order, ex2.approx vs exp2); bf16: the two round the f32 result to
#     bf16 on either side of a tie, one ulp <= 2^-7 |x|, so 2^-6 is twice
#     the worst single-entry rounding difference;
#   rms(diff) <= RMS_TOL * rms(plain)  catches a small error spread over
#     many entries (one skipped key tile of attn6's 144 moves O by ~8% rms).
TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s,
# dense bf16 tensor-core flop/s, f32 FMA flop/s; exp2 on the special
# function units: 16 results/clock/SM (CUDA C++ Programming Guide's
# arithmetic-instruction throughput table, cc 9.0) x 132 SMs x
# 1.98 GHz boost.
PEAK = {"bytes": 3.35e12, torch.bfloat16: 989e12, torch.float32: 67e12,
        "exp2": 16 * 132 * 1.98e9}
C65 = 65                     # K6's contraction: 64 channels and the bias
SERVE_LOGIT_TOL = 0.05       # x max|logit|, bf16 model, kernel vs plain
SERVE_ARGMAX_AGREE = 0.98
# Gradients of one step through the kernels vs through their plain
# versions (same weights, masks, dropout draws and batch). In f32 every
# tensor's cosine must reach TRAIN_GRAD_COS. In bf16 the two paths round
# p, dS and the activations to bf16 at different points, and that rounding
# alone leaves many tensors' bf16 gradients at cosine ~0.95 from the f32
# gradient in either path (measured on the card); so in bf16 the loss must
# agree within TRAIN_LOSS_RTOL and, for every tensor whose bf16 gradient
# carries signal (plain-path cosine to f32 >= BF16_SIGNAL_COS), the kernel
# path must be as close to the f32 gradient as the plain path, within
# BF16_COS_MARGIN.
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_COS = 0.99
BF16_SIGNAL_COS = 0.9
BF16_COS_MARGIN = 0.02
TRAIN_STEPS = 10
# the blended loss against its terms, both from the same f32 step
BLEND_RTOL = 1e-6
# the step's triplet term against `triplet_from_indices` of a forward of
# its own on the same parameters and dropout draws (the same kernels)
TRIPLET_RTOL = 1e-4
# the data slice: the nine recipes on fake layouts of the reference's
# on-disk formats at the real class counts (ADE's objectInfo150.txt with
# its header line: 151; COCO's 133 panoptic categories, and 134 instance
# classes with the background; Cityscapes' 19), 16 training and 8
# validation images of 96 px, read at 128 px
RECIPE_NAMES = ("ade_semantic", "ade_instance", "ade_panoptic",
                "city_semantic", "city_instance", "city_panoptic",
                "coco_semantic", "coco_instance", "coco_panoptic")
FAKE_TRAIN = 16
FAKE_VAL = 8
RECIPE_FRACTION = 0.5         # each recipe trains on 8 of the 16
DATA_RATE_SIDE = 512          # ADE20K's usual image side
DATA_RATE_IMAGES = 64
PREDICT_IMAGES = 11           # a full batch of 8 and a padded one of 3
PREDICT_FOLDED_AGREE = 0.9    # argmax, folded bf16 model vs unfolded
# the serving extras: JAX's own bounds for int8 serving
# (tests/test_quantize.py): argmax agreement with the float model above
# INT8_AGREE (:84), the int8 artifact under INT8_BYTES of the float one,
# both exported in f32 (:108), the int8 artifact's maps agreeing with
# the live int8 runner's above INT8_ARTIFACT_AGREE (:118)
INT8_AGREE = 0.85
INT8_BYTES = 0.45
INT8_ARTIFACT_AGREE = 0.95
EXPORT_IMAGES = 16
# the flash operators' host cost on the eager serving forward: device ms
# a batch through the operators within OP_DEVICE_RTOL of the direct
# launches' (the same kernels). One sample, the profiler's kernel sum over
# 3 forwards, ranges over 3% of the mean from run to run, so each way's
# figure is the mean of 2 * OP_ROUNDS samples, taken in OP_ROUNDS rounds
# of turns
OP_DEVICE_RTOL = 0.02
OP_ROUNDS = 3

failures: list[str] = []


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        failures.append(what)
        print(f"FAIL: {what}", file=sys.stderr, flush=True)


def device_ms(fn, iters: int, windows: int = 3) -> float:
    """Best-of-`windows` device time per call, by CUDA events. Each window's
    launches queue behind a spin on the stream, so the events bracket the
    device work and not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e5) * iters)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def attention_inputs(gen, lq, lk, c, use_valid, dtype):
    """q (pre-scaled by 1/sqrt(C), as the model calls the kernel), k, v
    and the bias of a Bernoulli(0.5) mask; compacted layers get the bias
    of the capacity buffer's valid slots."""
    dev = "cuda"
    q = (torch.randn(BATCH, lq, c, generator=gen, device=dev)
         * c ** -0.5).to(dtype)
    k = torch.randn(BATCH, lk, c, generator=gen, device=dev).to(dtype)
    v = torch.randn(BATCH, lk, c, generator=gen, device=dev).to(dtype)
    mask = torch.rand(BATCH, lq, generator=gen, device=dev) < 0.5
    if not use_valid:
        mask = fa.plan_compaction(mask).valid
    assert mask.shape[1] == lk
    return q, k, v, fa.mask_to_bias(mask, BATCH, lk)


def bound_ms(q, k, bias) -> tuple[float, float]:
    """Least time for this call's work: bytes moved once (q, k, v, bias
    in, o out) against the operations its data needs (products and exp2
    over the visible keys only)."""
    b, lq, c = q.shape
    visible = int((bias > fa.NEG_INF * 0.5).sum())
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + bias.numel() * 4
    t_bytes = nbytes / PEAK["bytes"]
    t_ops = max(4 * lq * visible * c / PEAK[q.dtype],
                lq * visible / PEAK["exp2"])
    return t_bytes * 1e3, t_ops * 1e3


def device_kernel_rows(prof) -> list:
    """(device us, name, calls) of the device kernels a profile saw,
    largest first. An operator's row repeats its kernels' time, and a user
    annotation on the device (e.g. `Optimizer.step#AdamW.step`) spans them,
    so only the kernels themselves count."""
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.is_user_annotation]
    return sorted(rows, reverse=True)


def wgmma_ptxas(log: str, kernel: str) -> list:
    """(function, stack/spill line, registers line) of each instantiation
    of the wgmma `kernel` (K4's `bwd_wgmma`, K1/K2's `fwd_nomax_wgmma`) in
    ptxas's report."""
    lines = log.splitlines()
    return [[ln.strip().rsplit(" ", 1)[-1], lines[i + 1].strip(),
             lines[i + 2].strip()]
            for i, ln in enumerate(lines[:-2])
            if "Function properties" in ln and kernel in ln]


def phase_device_wgmma(phase: str, kname: str, log: str, kernel: str,
                       body, channels, count: int) -> None:
    """ptxas's registers and spills of each instantiation of a wgmma body
    (`count` of them over its `channels`; 0 spill bytes required), and the
    body `body(c, bf16)` names at each C, which must be wgmma exactly at
    `channels`."""
    found = wgmma_ptxas(log, kernel)
    bodies = {c: body(c, torch.bfloat16) for c in fk.KERNEL_CHANNELS}
    emit(phase=phase, **{f"{kname.lower()}_bodies_bf16": bodies},
         wgmma_ptxas=found)
    check(len(found) == count and all(
        "0 bytes spill stores, 0 bytes spill loads" in ln
        for _, ln, _ in found),
        f"{kname}'s {count} wgmma instantiations built without spills: "
        f"{found}")
    check(all((b == "wgmma") == (c in channels) for c, b in bodies.items()),
          f"{kname} runs wgmma at C in {channels}: {bodies}")


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and bool(card), "nvidia-smi read the card")
    builds = fk.build()
    emit(phase="device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, device_name=torch.cuda.get_device_name(0),
         builds={name: {"seconds": info["seconds"], "cached": info["cached"],
                        "ptxas": [ln.strip() for ln in info["log"].splitlines()
                                  if "registers" in ln or "spill" in ln]}
                 for name, info in builds.items()},
         libraries_with_spills=[
             name for name, info in builds.items()
             if any("spill" in ln and "0 bytes spill stores, 0 bytes spill "
                    "loads" not in ln for ln in info["log"].splitlines())])
    # K4: use_valid x clamp a C; K1/K2: use_valid a C, and K6 D and E at
    # C 64; K3: use_valid a C, and K5 and K7 at C 64
    phase_device_wgmma("device_k4", "K4", builds["flash_bwd"]["log"],
                       "bwd_wgmma", fk.flash_bwd_body, fk.BWD_WGMMA_CHANNELS,
                       4 * len(fk.BWD_WGMMA_CHANNELS))
    phase_device_wgmma("device_k1", "K1", builds["flash_fwd_nomax"]["log"],
                       "fwd_nomax_wgmma", fk.flash_fwd_nomax_body,
                       fk.FWD_WGMMA_CHANNELS,
                       2 * len(fk.FWD_WGMMA_CHANNELS) + 2)
    phase_device_wgmma("device_k3", "K3", builds["flash_fwd_online"]["log"],
                       "fwd_online_wgmma", fk.flash_fwd_online_body,
                       fk.ONLINE_WGMMA_CHANNELS,
                       2 * len(fk.ONLINE_WGMMA_CHANNELS) + 2)
    return card


def agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Kernel output vs plain version over the plain version's finite
    entries, both bounds scaled to the plain output; NaN where it is NaN."""
    finite = torch.isfinite(want)
    plain = want.float()[finite]
    diff = got.float()[finite] - plain
    if plain.numel() == 0:
        err = rel_rms = 0.0
        tol = plain_rms = 1.0
    else:
        err = float(diff.abs().max())
        tol = TOL[want.dtype] * float(plain.abs().max())
        plain_rms = float(plain.square().mean().sqrt()) or 1.0
        rel_rms = float(diff.square().mean().sqrt()) / plain_rms
    same_nan = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    return {"max_abs_err": err, "tol": tol,
            "err_over_rms_plain": err / plain_rms,
            "rms_err_over_rms_plain": rel_rms, "rms_tol": RMS_TOL[want.dtype],
            "nan_match": same_nan,
            "ok": err <= tol and rel_rms <= RMS_TOL[want.dtype] and same_nan}


def kernel_cases(gen, dtype):
    """(name, q, k, v, bias, use_valid, row1) of the kernel checks: the six
    serving shapes, a ragged one, a fully-masked batch row 1 (row1
    'masked') and a NaN-poisoned K in batch row 1 (row1 'nan')."""
    for name, lq, lk, c, uv in SERVING_SHAPES:
        yield (name, *attention_inputs(gen, lq, lk, c, uv, dtype), uv, None)
    q, k, v = (torch.randn(2, 37, 64, generator=gen,
                           device="cuda").to(dtype) for _ in range(3))
    bias = fa.mask_to_bias(torch.rand(2, 37, generator=gen,
                                      device="cuda") < 0.5, 2, 37)
    yield "ragged37", q, k, v, bias, True, None
    masked = bias.clone()
    masked[1] = fa.NEG_INF
    yield "fully_masked_row", q, k, v, masked, True, "masked"
    poisoned = k.clone()
    poisoned[1] = float("nan")
    yield "nan_poisoned_k", q, poisoned, v, bias, False, "nan"


# (batch, Lq, Lk, use_valid) of K4's edge shapes: Lq past a multiple of
# the 64-query step or below it, Lk past a multiple of the key tile (192
# keys at C 64, 128 at C 128) or below it
BWD_EDGES = ((3, 200, 150, True), (3, 37, 200, False), (3, 50, 700, True),
             (2, 1000, 300, False), (3, 64, 40, True))


def bwd_edge_cases(gen, dtype):
    """`kernel_cases`' tuples for K4's edge shapes (BWD_EDGES) at each C
    whose bf16 backward runs the wgmma body."""
    for c in fk.BWD_WGMMA_CHANNELS:
        for b, lq, lk, uv in BWD_EDGES:
            q = (torch.randn(b, lq, c, generator=gen, device="cuda")
                 * c ** -0.5).to(dtype)
            k, v = (torch.randn(b, lk, c, generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            bias = fa.mask_to_bias(torch.rand(b, lk, generator=gen,
                                              device="cuda") < 0.5, b, lk)
            yield f"edge_c{c}_b{b}_q{lq}_k{lk}", q, k, v, bias, uv, None


# (batch, Lq, Lk) of K1's and K2's edge shapes: K4's, and one past the
# 128-query block and the key step (128 keys at C 64, 64 above)
FWD_EDGES = tuple(e[:3] for e in BWD_EDGES) + ((3, 129, 129),)


def fwd_edge_cases(gen, channels=fk.FWD_WGMMA_CHANNELS):
    """`kernel_cases`' tuples for K1's and K2's edge shapes (FWD_EDGES),
    bf16, with and without use_valid, at each C of `channels` (those whose
    bf16 forward runs the wgmma body)."""
    for c in channels:
        for b, lq, lk in FWD_EDGES:
            q = (torch.randn(b, lq, c, generator=gen, device="cuda")
                 * c ** -0.5).bfloat16()
            k, v = (torch.randn(b, lk, c, generator=gen,
                                device="cuda").bfloat16() for _ in range(2))
            bias = fa.mask_to_bias(torch.rand(b, lk, generator=gen,
                                              device="cuda") < 0.5, b, lk)
            for uv in (True, False):
                yield (f"edge_c{c}_b{b}_q{lq}_k{lk}", q, k, v, bias, uv,
                       None)


def forward_cases(gen, dtype):
    """K1's and K2's cases: `kernel_cases`, and in bf16 the edge shapes."""
    yield from kernel_cases(gen, dtype)
    if dtype == torch.bfloat16:
        yield from fwd_edge_cases(gen)


def row1_as_expected(out: torch.Tensor, row1) -> bool:
    """A fully-masked row gives exact zeros, a NaN-poisoned one NaN (and
    row 0 stays finite)."""
    if row1 == "masked":
        return bool((out[1] == 0).all())
    if row1 == "nan":
        return bool(torch.isnan(out[1]).all() and torch.isfinite(out[0]).all())
    return True


def emit_case(phase, name, q, k, use_valid, outputs) -> float:
    """One line per case; returns the case's worst absolute error."""
    ok = all(a["ok"] and a.get("expected", True) for a in outputs.values())
    emit(phase=phase, case=name, dtype=str(q.dtype).split(".")[-1],
         shape=[list(q.shape), list(k.shape)], use_valid=use_valid,
         outputs=outputs, ok=ok)
    check(ok, f"{phase} {name} {q.dtype}")
    return max(a["max_abs_err"] for a in outputs.values())


def phase_kernel() -> dict:
    """K1 vs its plain version; returns the worst absolute error."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, q, k, v, bias, uv, row1 in forward_cases(gen, dtype):
            got = fk.flash_fwd_nomax(q, k, v, bias, 1.0, uv)
            torch.cuda.synchronize()
            a = agreement(got, fk.flash_fwd_nomax_reference(q, k, v, bias,
                                                            1.0, uv))
            a["expected"] = row1_as_expected(got, row1)
            worst = max(worst, emit_case("kernel", name, q, k, uv, {"o": a}))
    return {"max_abs_err": worst}


def phase_kernel_lse() -> dict:
    """K2 (o and lse) vs its plain version; returns the worst error."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, q, k, v, bias, uv, row1 in forward_cases(gen, dtype):
            o, lse = fk.flash_fwd_nomax_lse(q, k, v, bias, 1.0, uv)
            torch.cuda.synchronize()
            want_o, want_lse = fk.flash_fwd_nomax_reference(
                q, k, v, bias, 1.0, uv, with_lse=True)
            outs = {"o": agreement(o, want_o), "lse": agreement(lse, want_lse)}
            outs["o"]["expected"] = row1_as_expected(o, row1)
            worst = max(worst, emit_case("kernel_lse", name, q, k, uv, outs))
    return {"max_abs_err": worst}


def phase_kernel_bwd() -> dict:
    """K4 (dq, dk, dv) vs its plain version on the plain forward's o and
    lse and a random dO; returns the worst error."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, q, k, v, bias, uv, row1 in (*kernel_cases(gen, dtype),
                                              *bwd_edge_cases(gen, dtype)):
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            o, lse = fk.flash_fwd_nomax_reference(q, k, v, bias, 1.0, uv,
                                                  with_lse=True)
            got = fk.flash_bwd(q, k, v, bias, o, lse, do, 1.0, uv)
            torch.cuda.synchronize()
            want = fk.flash_bwd_reference(q, k, v, bias, o, lse, do, 1.0, uv)
            outs = {n: agreement(g, w)
                    for n, g, w in zip(("dq", "dk", "dv"), got, want)}
            outs["dq"]["expected"] = row1_as_expected(got[0], row1)
            if row1 == "nan":
                outs["dk"]["expected"] = bool(torch.isnan(got[1][1]).all())
            worst = max(worst, emit_case("kernel_bwd", name, q, k, uv, outs))
            del o, lse, got, want
    return {"max_abs_err": worst}


def above_clamp_inputs(gen, c, dtype):
    """Base-2 scores far past the clamp at 60 (up to ~100) on batch row 0's
    first 8 queries, computed exactly: integer q and k in [-4, 4] (x 6 on
    those rows) and scale = 1 / (8 log2 e), so q's multiplier is 1/8 and
    every score is a multiple of 1/64, the same in any summation order.
    Random scores that large carry ~1e-4 of f32 summation noise into
    exp2(s - lse), past the f32 bound. Returns (q, k, v, bias, scale)."""
    q = torch.randint(-4, 5, (2, 200, c), generator=gen, device="cuda")
    q[0, :8] *= 6
    k = torch.randint(-4, 5, (2, 150, c), generator=gen, device="cuda")
    v = torch.randn(2, 150, c, generator=gen, device="cuda")
    mask = torch.rand(2, 150, generator=gen, device="cuda") < 0.5
    return (q.to(dtype), k.to(dtype), v.to(dtype),
            fa.mask_to_bias(mask, 2, 150), 0.125 / fk._LOG2E)


def online_cases(gen, dtype):
    """(name, q, k, v, bias, use_valid, row1, scale) of K3 and of K4
    without its clamp: `kernel_cases` at scale 1, a fully-masked batch row
    1 without use_valid (row1 'masked_mean': K3 gives the mean of V), and
    exact scores past the clamp at C 64 and 256 (row1 'above_clamp')."""
    for case in kernel_cases(gen, dtype):
        yield (*case, 1.0)
        if case[-1] == "masked":
            yield ("fully_masked_row_no_valid", *case[1:5], False,
                   "masked_mean", 1.0)
    for c in (64, 256):
        q, k, v, bias, scale = above_clamp_inputs(gen, c, dtype)
        yield f"above_clamp_c{c}", q, k, v, bias, True, "above_clamp", scale


def online_edge_cases(gen):
    """`online_cases`' tuples for K3's bf16 edge shapes at each C whose
    bf16 K3 runs the wgmma body: FWD_EDGES with and without use_valid,
    and a fully-masked batch row 1 at a ragged Lk (129, one key past a
    whole number of key steps at every C), both ways."""
    for case in fwd_edge_cases(gen, fk.ONLINE_WGMMA_CHANNELS):
        yield (*case, 1.0)
    for c in fk.ONLINE_WGMMA_CHANNELS:
        q = (torch.randn(3, 37, c, generator=gen, device="cuda")
             * c ** -0.5).bfloat16()
        k, v = (torch.randn(3, 129, c, generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        bias = fa.mask_to_bias(torch.rand(3, 129, generator=gen,
                                          device="cuda") < 0.5, 3, 129)
        bias[1] = fa.NEG_INF
        for uv, row1 in ((True, "masked"), (False, "masked_mean")):
            yield (f"edge_c{c}_b3_q37_k129_masked_row", q, k, v, bias, uv,
                   row1, 1.0)


def phase_kernel_online() -> dict:
    """K3 (o and lse) vs its plain version; a fully-masked row has lse
    -1e30 and o 0 (use_valid) or the mean of V (not); returns the worst
    error."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    neg = float(torch.tensor(fa.NEG_INF))
    for dtype in (torch.bfloat16, torch.float32):
        cases = online_cases(gen, dtype)
        if dtype == torch.bfloat16:
            cases = (*cases, *online_edge_cases(gen))
        for name, q, k, v, bias, uv, row1, scale in cases:
            o, lse = fk.flash_fwd_online(q, k, v, bias, scale, uv)
            torch.cuda.synchronize()
            want_o, want_lse = fk.flash_fwd_online_reference(
                q, k, v, bias, scale, uv)
            outs = {"o": agreement(o, want_o), "lse": agreement(lse, want_lse)}
            if row1 in ("masked", "masked_mean"):
                mean_v = v[1].float().mean(0).expand(q.shape[1], -1)
                outs["o"]["expected"] = bool((lse[1] == neg).all()) and (
                    row1_as_expected(o, "masked") if uv
                    else agreement(o[1], mean_v.to(dtype))["ok"])
            elif row1 == "above_clamp":
                outs["lse"]["expected"] = float(lse.max()) > fk._NOMAX_CLAMP
            else:
                outs["o"]["expected"] = row1_as_expected(o, row1)
            worst = max(worst, emit_case("kernel_online", name, q, k, uv,
                                         outs))
    return {"max_abs_err": worst}


def phase_kernel_bwd_noclamp() -> dict:
    """K4 with clamp=False vs its plain version on K3's plain o and lse;
    where scores pass the clamp, the clamped kernel must give another dQ.
    Returns the worst error."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        cases = (*online_cases(gen, dtype),
                 *((*case, 1.0) for case in bwd_edge_cases(gen, dtype)))
        for name, q, k, v, bias, uv, row1, scale in cases:
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            o, lse = fk.flash_fwd_online_reference(q, k, v, bias, scale, uv)
            got = fk.flash_bwd(q, k, v, bias, o, lse, do, scale, uv,
                               clamp=False)
            torch.cuda.synchronize()
            want = fk.flash_bwd_reference(q, k, v, bias, o, lse, do, scale,
                                          uv, clamp=False)
            outs = {n: agreement(g, w)
                    for n, g, w in zip(("dq", "dk", "dv"), got, want)}
            if row1 == "above_clamp":
                clamped = fk.flash_bwd(q, k, v, bias, o, lse, do, scale, uv)
                outs["dq"]["expected"] = bool(
                    all(torch.isfinite(g).all() for g in got)
                    and not torch.allclose(clamped[0].float(),
                                           got[0].float()))
            elif row1 == "nan":
                outs["dq"]["expected"] = row1_as_expected(got[0], row1)
                outs["dk"]["expected"] = bool(torch.isnan(got[1][1]).all())
            elif row1 == "masked":
                outs["dq"]["expected"] = row1_as_expected(got[0], row1)
            worst = max(worst, emit_case("kernel_bwd_noclamp", name, q, k, uv,
                                         outs))
            del o, lse, got, want
    return {"max_abs_err": worst}


def phase_serving(card: str, safe: bool = False) -> dict:
    """The serving path: 16 requests through the micro-batcher, then the
    logits of one forward through the kernel against the plain path.
    `safe` runs it with the safe softmax on (phase `safe_serving`): K3 in
    place of K1."""
    phase = "safe_serving" if safe else "serving"
    kname = "K3" if safe else "K1"
    attr, plain = (("flash_fwd_online", fk.flash_fwd_online_reference)
                   if safe else
                   ("flash_fwd_nomax", fk.flash_fwd_nomax_reference))
    t0 = time.monotonic()
    runner, img_size = serve.build_model_runner(
        "ade_semantic", NUM_CLASSES, None, compute_dtype="bfloat16",
        batch_size=BATCH, device="cuda")
    zeros = np.zeros((BATCH, img_size, img_size, 3), np.uint8)
    runner(zeros).cpu()                          # warm-up: cuDNN plans
    setup_s = time.monotonic() - t0

    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (img_size, img_size, 3)).astype(np.uint8)
              for _ in range(16)]
    batcher = serve._Batcher(runner, BATCH, max_wait_ms=20.0)
    zero_launches()                              # the main path's run
    with ThreadPoolExecutor(4) as ex:
        answers = list(ex.map(batcher.predict, images))
    counts = kernel_launches()
    launches = counts[kname]
    metrics = batcher.metrics()
    check(metrics["requests"] == 16 and metrics["errors"] == 0,
          f"{phase}: 16 requests answered: {metrics}")
    check(launches == 6 * metrics["batches"] and launches > 0
          and sum(counts.values()) == launches,
          f"{phase}: 6 {kname} launches per forward, no other kernel: "
          f"{counts}, {metrics['batches']} forwards")

    equal = 0
    for img, ans in zip(images, answers):
        direct = runner(np.stack([img] * BATCH))[0].cpu().numpy()
        equal += int(ans.shape == (img_size, img_size)
                     and ans.dtype == np.uint8 and np.array_equal(ans, direct))
    check(equal == 16, f"{phase}: answers equal direct runner calls "
          f"({equal}/16)")

    # logits of the kernel path vs the plain-version path, same weights
    forward, params, masks, cfg = serve.build_inference_fn(
        "ade_semantic", NUM_CLASSES, None, compute_dtype="bfloat16",
        batch_size=BATCH, device="cuda")
    x = torch.from_numpy(np.stack(images[:BATCH])).cuda().float() / 255.0
    plans = mu.precompute_mask_plans(masks)
    with torch.no_grad():
        zero_launches()
        out_k, _ = mu.apply(params, None, x, cfg=cfg, masks=masks,
                            folded=True, mask_plans=plans)
        one = kernel_launches()
        check(one[kname] == 6 and sum(one.values()) == 6,
              f"{phase}: one forward launches {kname} 6 times and no other "
              f"kernel: {one}")
        kernel_fn = getattr(fk, attr)
        setattr(fk, attr, plain)
        try:
            out_p, _ = mu.apply(params, None, x, cfg=cfg, masks=masks,
                                folded=True, mask_plans=plans)
        finally:
            setattr(fk, attr, kernel_fn)
    lk, lp = out_k.semantic.float(), out_p.semantic.float()
    finite = bool(torch.isfinite(lk).all())
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    emit(phase=phase, card=card, setup_s=setup_s, requests=16,
         forwards=metrics["batches"], kernel_launches=launches,
         launches_one_forward=one,
         answers_equal_direct=equal, logits_shape=list(lk.shape),
         logits_finite=finite, logits_max_abs_diff_vs_plain=err,
         logits_max_abs=scale, tol=SERVE_LOGIT_TOL * scale,
         argmax_agreement=agree, avg_batch_fill=metrics["avg_batch_fill"])
    check(list(lk.shape) == [BATCH, IMG, IMG, NUM_CLASSES] and finite,
          f"{phase}: logits finite, [8,128,128,150]")
    check(err <= SERVE_LOGIT_TOL * scale, f"{phase}: logits kernel vs plain")
    check(agree >= SERVE_ARGMAX_AGREE,
          f"{phase}: argmax agreement kernel vs plain")
    return {"runner": runner, "launches": launches, "images": images}


def serve_wall_and_profile(card: str, runner, batch, prefix: str,
                           tag: str) -> dict:
    """Serving forward wall time (best of 3 x 10) and a device profile of
    three forwards; `tag` names the flash kernel in the profile. Returns
    the wall and device ms a forward (device None if not measured)."""
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            runner(batch)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / 10)
    emit(phase=f"{prefix}serve_time", card=card, ms_per_batch=best * 1e3,
         img_per_s=BATCH / best, batch=BATCH, windows="best of 3 x 10")

    # device profile of three serving forwards: where the time goes
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            runner(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_kernel_rows(prof)
    total_dev = sum(r[0] for r in rows)
    flash_us = sum(r[0] for r in rows if tag in r[1])
    emit(phase=f"{prefix}serve_profile", card=card, forwards=3,
         device_ms_per_forward=total_dev / 3e3 if rows else "not measured",
         wall_ms_per_forward=wall_us / 3e3,
         device_busy_share=total_dev / wall_us if rows else "not measured",
         flash_kernel_share=flash_us / total_dev if rows else "not measured",
         device_launches_per_forward=sum(r[2] for r in rows) / 3,
         top=[{"name": k[:90], "ms_per_forward": us / 3e3, "calls": n // 3}
              for us, k, n in rows[:12]])
    return {"wall_ms": best * 1e3,
            "device_ms": total_dev / 3e3 if rows else None}


def phase_times(card: str, serving: dict) -> dict:
    """K1's sums over the six shapes, its launches, and the serving
    forward's wall and device ms (`serve`)."""
    serve = serve_wall_and_profile(card, serving["runner"],
                                   np.stack(serving["images"][:BATCH]), "",
                                   "fwd_nomax")
    totals = forward_shape_times(card, "attn_time", fk.flash_fwd_nomax,
                                 fk.flash_fwd_nomax_reference, seed=1,
                                 body=fk.flash_fwd_nomax_body)
    totals["launches"] = serving["launches"]
    totals["serve"] = serve
    return totals


def forward_shape_times(card: str, phase: str, kernel, plain,
                        seed: int, lse: bool = False, body=None) -> dict:
    """Per serving attention shape, bf16: the forward `kernel` and its
    `plain` version (both called (q, k, v, bias, 1.0, use_valid)), the
    library's SDPA with the same additive mask, and the bound (plus the
    lse bytes when `lse`); `body(c, dtype)` names the kernel's body on
    each line. Returns the sums over the six shapes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    for name, lq, lk, c, uv in SERVING_SHAPES:
        q, k, v, bias = attention_inputs(gen, lq, lk, c, uv, torch.bfloat16)
        ms = device_ms(lambda: kernel(q, k, v, bias, 1.0, uv), iters=20)
        plain_ms = device_ms(lambda: plain(q, k, v, bias, 1.0, uv), iters=2)
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]
        amask = bias[:, None].to(q.dtype)
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=amask, scale=1.0), iters=20)
        t_bytes, t_ops = bound_ms(q, k, bias)
        if lse:
            t_bytes += 4 * BATCH * lq / PEAK["bytes"] * 1e3
        bnd = max(t_bytes, t_ops)
        by = "bytes" if t_bytes > t_ops else "operations"
        extra = {} if body is None else {"body": body(c, torch.bfloat16)}
        emit(phase=phase, card=card, layer=name, lq=lq, lk=lk, c=c,
             batch=BATCH, dtype="bfloat16", use_valid=uv, ms=ms,
             plain_ms=plain_ms, library_ms=lib, bound_ms=bnd, bound_by=by,
             share_of_bound=bnd / ms, **extra)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib), ("bound_ms", bnd),
                         ("bytes_ms", t_bytes), ("ops_ms", t_ops)):
            totals[key] += val
    return totals


def exact_zero_grad(name: str) -> bool:
    """Parameters whose gradient is zero in exact arithmetic, so that any
    implementation returns rounding noise there: each attention's key bias
    (softmax is shift-invariant), the affine of the BatchNorm that feeds
    the Down/Up blocks' trailing BatchNorm (which normalises it away), the
    conv bias before a head's BatchNorm (the final layer's and the
    embedding head's), and the boundary head's parameters (no term of the
    loss reads that head: exactly zero)."""
    return (name.endswith(".key.bias")
            or name in ("final_layer.0.bias", "embedding_head.0.bias")
            or name.startswith("boundary_head.")
            or (name.startswith("downsample") and ".2.conv_block.4." in name)
            or (name.startswith("upsample") and ".1.conv_block.4." in name))


def counted_wrappers() -> dict:
    """Every kernel's wrapper, the holder of its launch counter."""
    return {"K1": fk.flash_fwd_nomax, "K2": fk.flash_fwd_nomax_lse,
            "K3": fk.flash_fwd_online, "K4": fk.flash_bwd,
            "K5": softmax_ab.old_flash_fwd, "K6": softmax_ab.nomax65_fwd,
            "K6_repack": softmax_ab.repack65,
            "K7": bf16_tool.flash_fwd_bf16}


def kernel_launches() -> dict:
    return {k: fn.launches for k, fn in counted_wrappers().items()}


def zero_launches() -> None:
    for fn in counted_wrappers().values():
        fn.launches = 0


def step_grads(model_cfg, task, ts, batch, plans, gen_state, plain: bool,
               triplets=None) -> tuple[dict, float]:
    """One step's gradients (f64, flattened, the exact-zero tensors left
    out) and loss, through the kernels or (`plain`) their plain versions,
    from the generator state `gen_state` (the same dropout draws)."""
    ts.generator.set_state(gen_state)
    fn = train_step.make_grads_and_metrics(model_cfg, task)
    kernels = (fk.flash_fwd_nomax_lse, fk.flash_fwd_online, fk.flash_bwd)
    if plain:
        fk.flash_fwd_nomax_lse = functools.partial(
            fk.flash_fwd_nomax_reference, with_lse=True)
        fk.flash_fwd_online = fk.flash_fwd_online_reference
        fk.flash_bwd = fk.flash_bwd_reference
    try:
        g, m, _ = fn(ts.params, ts.model_state, batch, ts.masks, plans,
                     ts.generator, triplets)
    finally:
        fk.flash_fwd_nomax_lse, fk.flash_fwd_online, fk.flash_bwd = kernels
    return ({k: v.double().flatten() for k, v in g.items()
             if not exact_zero_grad(k)}, float(m["loss"]))


def cos(a, b) -> float:
    return float(a @ b / (a.norm() * b.norm()).clamp(min=1e-300))


def phase_train(card: str, safe: bool = False) -> dict:
    """The training path: one step, one eval step, gradients through the
    kernels against the plain path, 10 steps. `safe` runs it with the safe
    softmax on (phases `safe_train*`): K3 in place of K2 (and of K1 in
    the eval step), K4 without its clamp."""
    prefix = "safe_" if safe else ""
    fwd = "K3" if safe else "K2"
    t0 = time.monotonic()
    recipe = recipes.get("ade_semantic")
    cfg = train_loop.model_config(recipe, NUM_CLASSES,
                                  compute_dtype="bfloat16")
    ts = train_loop.setup_state(recipe, cfg,
                                train_loop.make_optimizer(recipe),
                                batch_size=BATCH, device="cuda")
    plans = mu.precompute_mask_plans(ts.masks)
    task = train_step.TaskConfig()
    step = train_step.make_train_step(cfg, task, mask_plans=plans,
                                      device="cuda")
    eval_step = train_step.make_eval_step(cfg, task, device="cuda")
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.standard_normal(
                 (BATCH, IMG, IMG, 3)).astype(np.float32)).cuda(),
             "label": torch.from_numpy(rng.integers(
                 0, NUM_CLASSES, (BATCH, IMG, IMG))).cuda()}
    setup_s = time.monotonic() - t0

    # the main path: one training step, counters zeroed just before it;
    # the clamp flag of each backward launch is recorded on the way
    clamps = []
    bwd_kernel = fk.flash_bwd

    def recorded_bwd(*args, **kw):
        clamps.append(kw.get("clamp", True))
        return bwd_kernel(*args, **kw)

    fk.flash_bwd = recorded_bwd
    try:
        zero_launches()
        ts, metrics = step(ts, batch)
        torch.cuda.synchronize()
        step_launches = kernel_launches()
    finally:
        fk.flash_bwd = bwd_kernel
    want = dict.fromkeys(counted_wrappers(), 0)
    check(step_launches == {**want, fwd: 6, "K4": 6}
          and clamps == [not safe] * 6,
          f"one {prefix}train step launches {fwd} 6, K4 6 (clamp "
          f"{not safe}), no other kernel: {step_launches}, clamps {clamps}")
    zero_launches()
    result = eval_step(ts, batch, plans)
    torch.cuda.synchronize()
    eval_launches = kernel_launches()
    check(eval_launches == {**want, "K3" if safe else "K1": 6},
          f"one {prefix}eval step launches {'K3' if safe else 'K1'} 6: "
          f"{eval_launches}")
    check(list(result["pred"].shape) == [BATCH, IMG, IMG]
          and bool(torch.isfinite(result["metrics"]["loss"])),
          f"{prefix}eval step: finite loss, [8,128,128] predictions")

    # gradients through the kernels vs through their plain versions: same
    # state, batch and dropout draws, in f32 and in bf16
    gen_state = ts.generator.get_state()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")

    def grads(model_cfg, plain: bool):
        return step_grads(model_cfg, task, ts, batch, plans, gen_state,
                          plain)

    (k32, loss_k32), (p32, loss_p32) = grads(cfg32, False), grads(cfg32, True)
    cos32 = {n: cos(k32[n], p32[n]) for n in p32}
    del p32
    (kbf, loss_kbf), (pbf, loss_pbf) = grads(cfg, False), grads(cfg, True)
    plain_to_f32 = {n: cos(pbf[n], k32[n]) for n in pbf}
    signal = {n: c for n, c in plain_to_f32.items() if c >= BF16_SIGNAL_COS}
    margin = {n: cos(kbf[n], k32[n]) - signal[n] for n in signal}
    finite = all(bool(torch.isfinite(g).all()) for g in kbf.values())
    worst32, worst_bf = min(cos32, key=cos32.get), min(margin, key=margin.get)
    bf_vs_plain = {n: cos(kbf[n], pbf[n]) for n in pbf}
    least = min(bf_vs_plain, key=bf_vs_plain.get)
    emit(phase=f"{prefix}train_vs_plain", card=card,
         loss_f32_kernels=loss_k32,
         loss_f32_plain=loss_p32, loss_bf16_kernels=loss_kbf,
         loss_bf16_plain=loss_pbf,
         loss_bf16_rel_diff=abs(loss_kbf - loss_pbf) / abs(loss_pbf),
         loss_rtol=TRAIN_LOSS_RTOL, tensors_compared=len(cos32),
         f32_min_cosine=cos32[worst32], f32_min_cosine_tensor=worst32,
         f32_cos_limit=TRAIN_GRAD_COS,
         bf16_min_kernel_vs_plain_cosine=bf_vs_plain[least],
         bf16_min_kernel_vs_plain_tensor=least,
         bf16_that_tensor_cos_to_f32={"kernels": cos(kbf[least], k32[least]),
                                      "plain": plain_to_f32[least]},
         bf16_signal_tensors=len(signal),
         bf16_worst_margin_to_f32=margin[worst_bf],
         bf16_worst_margin_tensor=worst_bf,
         bf16_margin_limit=-BF16_COS_MARGIN, grads_finite=finite)
    check(cos32[worst32] >= TRAIN_GRAD_COS,
          f"{prefix}f32 train gradients, kernels vs plain")
    check(abs(loss_kbf - loss_pbf) <= TRAIN_LOSS_RTOL * abs(loss_pbf),
          f"{prefix}bf16 train loss, kernels vs plain")
    check(margin[worst_bf] >= -BF16_COS_MARGIN and finite,
          f"{prefix}bf16 train gradients as close to f32 as the plain "
          "path's")
    del k32, kbf, pbf

    losses = [float(metrics["loss"])]
    for _ in range(TRAIN_STEPS - 1):
        ts, metrics = step(ts, batch)
        losses.append(float(metrics["loss"]))
    emit(phase=f"{prefix}train", card=card, setup_s=setup_s, batch=BATCH,
         step_launches=step_launches, step_bwd_clamps=clamps,
         eval_launches=eval_launches, losses=losses,
         miou_last=float(metrics["miou"]),
         eval_metrics={k: float(v) for k, v in result["metrics"].items()})
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{prefix}{TRAIN_STEPS} steps: finite loss that falls")
    return {"ts": ts, "step": step, "batch": batch,
            "launches": step_launches}


def train_wall_and_profile(card: str, train: dict, prefix: str,
                           shares: dict) -> dict:
    """Training step wall time (best of 3 x 10) and a device profile of 3
    steps; `shares` names the share keys and the kernel name each reads.
    Drops the training state afterwards. Returns the wall and device ms a
    step (device None if not measured)."""
    step, batch, ts = train["step"], train["batch"], train["ts"]
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            ts, _ = step(ts, batch)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / 10)
    emit(phase=f"{prefix}train_time", card=card, ms_per_step=best * 1e3,
         img_per_s=BATCH / best, batch=BATCH, windows="best of 3 x 10")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            ts, _ = step(ts, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_kernel_rows(prof)
    total = sum(r[0] for r in rows)
    share = (lambda tag: sum(r[0] for r in rows if tag in r[1]) / total
             if rows else "not measured")
    emit(phase=f"{prefix}train_profile", card=card, steps=3,
         device_ms_per_step=total / 3e3 if rows else "not measured",
         wall_ms_per_step=wall_us / 3e3,
         device_busy_share=total / wall_us if rows else "not measured",
         **{key: share(tag) for key, tag in shares.items()},
         device_launches_per_step=sum(r[2] for r in rows) / 3,
         top=[{"name": k[:90], "ms_per_step": us / 3e3, "calls": n // 3}
              for us, k, n in rows[:15]])
    del ts, train["ts"]
    return {"wall_ms": best * 1e3, "device_ms": total / 3e3 if rows else None}


def bwd_bound_ms(q, k, bias) -> tuple[float, float]:
    """K4's least time: bytes (q, k, v, dO, lse, delta, bias read once;
    dQ in f32, dK, dV written once) against operations (five products and
    one exp2 per visible (query, key) pair)."""
    b, lq, c = q.shape
    visible = int((bias > fa.NEG_INF * 0.5).sum())
    e = q.element_size()
    nbytes = (4 * q.numel() + 4 * k.numel()) * e + 2 * 4 * b * lq \
        + bias.numel() * 4 + 4 * q.numel()
    t_ops = max(10 * lq * visible * c / PEAK[q.dtype],
                lq * visible / PEAK["exp2"])
    return nbytes / PEAK["bytes"] * 1e3, t_ops * 1e3


# K4's kernels in a profile, whichever body ran (bwd_wgmma, bwd_bf16,
# bwd_f32)
K4_TAG = "namespace)::bwd_"


def phase_train_time(card: str, train: dict) -> dict:
    """K2's and K4's sums over the six shapes, and the step's wall and
    device ms (`step`)."""
    step = train_wall_and_profile(card, train, "", {"k2_share": "fwd_nomax",
                                                    "k4_share": K4_TAG})
    gen = torch.Generator(device="cuda").manual_seed(4)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "bytes_ms", "ops_ms")
    totals = {"K2": dict.fromkeys(keys, 0.0), "K4": dict.fromkeys(keys, 0.0)}
    for name, lq, lk, c, uv in SERVING_SHAPES:
        q, k, v, bias = attention_inputs(gen, lq, lk, c, uv, torch.bfloat16)
        do = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
        o, lse = fk.flash_fwd_nomax_lse(q, k, v, bias, 1.0, uv)
        q4, k4, v4 = (t[:, None].detach().requires_grad_()
                      for t in (q, k, v))
        amask = bias[:, None].to(q.dtype)
        lib_out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=amask,
                                                 scale=1.0)
        do4 = do[:, None]
        t_bytes, t_ops = bound_ms(q, k, bias)
        fwd = {"ms": device_ms(lambda: fk.flash_fwd_nomax_lse(
                   q, k, v, bias, 1.0, uv), iters=20),
               "plain_ms": device_ms(lambda: fk.flash_fwd_nomax_reference(
                   q, k, v, bias, 1.0, uv, with_lse=True), iters=2),
               "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, attn_mask=amask, scale=1.0), iters=20),
               "bytes_ms": t_bytes + 4 * lse.numel() / PEAK["bytes"] * 1e3,
               "ops_ms": t_ops}
        t_bytes, t_ops = bwd_bound_ms(q, k, bias)
        bwd = {"ms": device_ms(lambda: fk.flash_bwd(
                   q, k, v, bias, o, lse, do, 1.0, uv), iters=10),
               "plain_ms": device_ms(lambda: fk.flash_bwd_reference(
                   q, k, v, bias, o, lse, do, 1.0, uv), iters=2),
               "library_ms": device_ms(lambda: torch.autograd.grad(
                   lib_out, (q4, k4, v4), do4, retain_graph=True), iters=10),
               "bytes_ms": t_bytes, "ops_ms": t_ops}
        fwd["body"] = fk.flash_fwd_nomax_body(c, torch.bfloat16)
        bwd["body"] = fk.flash_bwd_body(c, torch.bfloat16)
        for kname, row in (("K2", fwd), ("K4", bwd)):
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row["bound_by"] = ("bytes" if row["bytes_ms"] > row["ops_ms"]
                               else "operations")
            emit(phase="train_attn_time", card=card, kernel=kname,
                 layer=name, lq=lq, lk=lk, c=c, batch=BATCH, dtype="bfloat16",
                 use_valid=uv, **row, share_of_bound=row["bound_ms"] / row["ms"])
            for key in keys:
                totals[kname][key] += row[key]
        del q4, k4, v4, lib_out, o, lse
    totals["step"] = step
    return totals


def states_equal(a, b) -> bool:
    """Params, BN statistics, AdamW moments and count, masks and step, bit
    for bit."""
    same = a.step == b.step and all(
        torch.equal(ma, mb) for ma, mb in zip(a.masks, b.masks))
    for k, p in a.params.items():
        q = b.params[k]
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        same &= torch.equal(p.detach(), q.detach()) \
            and float(sa["step"]) == float(sb["step"]) \
            and torch.equal(sa["exp_avg"], sb["exp_avg"]) \
            and torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    return same and all(torch.equal(v, b.model_state[k])
                        for k, v in a.model_state.items())


def loop_recipe():
    """The ADE model over the seeded synthetic dataset at its size."""
    return dataclasses.replace(recipes.get("ade_semantic"),
                               dataset="synthetic", num_classes=NUM_CLASSES)


def timed_train(*args, **kw):
    """`train_loop.train`, and the host's gaps between the returns of
    successive train steps (ms): what a step costs the loop, waits on the
    card, the prefetcher's and the save thread's share of the interpreter
    and the epoch-end work included."""
    make, stamps = train_loop.step_lib.make_train_step, []

    def stamped(*a, **k):
        step = make(*a, **k)

        def run(ts, batch):
            out = step(ts, batch)
            stamps.append(time.perf_counter())
            return out
        return run

    train_loop.step_lib.make_train_step = stamped
    try:
        result = train_loop.train(*args, **kw)
    finally:
        train_loop.step_lib.make_train_step = make
    return result, [float(g) for g in np.diff(stamps) * 1e3]


def phase_loop(card: str) -> dict:
    """The training loop from the seeded dataset through checkpoints, a
    resume and serving the trained workdir (phase 12)."""
    recipe = loop_recipe()
    kw = dict(eval_every=1, eval_max_batches=2, ckpt_every=4,
              compute_dtype="bfloat16", verbose=False, device="cuda")
    want = dict.fromkeys(counted_wrappers(), 0)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        zero_launches()                          # the main path's run
        t0 = time.monotonic()
        first, gaps = timed_train(recipe, None, workdir, max_epochs=2, **kw)
        torch.cuda.synchronize()
        first_s = time.monotonic() - t0
        launches = kernel_launches()
        steps = [r["step"] for r in first.history]
        finite = all(np.isfinite([r["loss"], r["miou"], r["val_loss"],
                                  r["val_miou"]]).all()
                     for r in first.history)
        files = sorted(n for n in os.listdir(workdir)
                       if n.endswith(".msgpack"))
        check(launches == {**want, "K2": 6 * 16, "K4": 6 * 16,
                           "K1": 6 * 4},
              f"loop: 16 steps launch K2 and K4 6 times each, 4 validation "
              f"batches K1 6 times each, nothing else: {launches}")
        check(steps == [8, 16] and finite and first.stop_reason ==
              "completed", f"loop: finite history at steps 8, 16: "
              f"{first.history}")
        check(files == ["checkpoint_ade_best.msgpack",
                        "checkpoint_ade_latest.msgpack"],
              f"loop: best and latest checkpoints: {files}")

        # what one save costs its thread: snapshot, host copy, encoding
        # and the write, alone (the loop's saves overlap its steps)
        timed = os.path.join(workdir, "timed.msgpack")
        t0 = time.monotonic()
        ckpt_lib.save(timed, first.state)
        one_save_s = time.monotonic() - t0
        checkpoint_bytes = os.path.getsize(timed)
        os.remove(timed)

        cfg = train_loop.model_config(recipe, NUM_CLASSES,
                                      compute_dtype="bfloat16")
        template = train_loop.setup_state(
            recipe, cfg, train_loop.make_optimizer(recipe), device="cuda")
        restored = ckpt_lib.restore(
            os.path.join(workdir, "checkpoint_ade_latest.msgpack"), template)
        restored_equal = states_equal(restored, first.state)
        check(restored_equal, "loop: the latest checkpoint restores the "
              "returned state bit for bit")
        del template, restored

        zero_launches()
        t0 = time.monotonic()
        second = train_loop.train(recipe, None, workdir, max_epochs=3,
                                  resume=True, **kw)
        torch.cuda.synchronize()
        second_s = time.monotonic() - t0
        resume_launches = kernel_launches()
        check([r["step"] for r in second.history] == [24]
              and second.state.step == 24
              and resume_launches == {**want, "K2": 48, "K4": 48,
                                      "K1": 12},
              f"loop: resume runs steps 17-24 only: {second.history}, "
              f"{resume_launches}")

        # serving the workdir: the runner's answers against a direct folded
        # forward of the final state (what 'latest' holds)
        runner, img_size = serve.build_model_runner(
            recipe, NUM_CLASSES, workdir, "latest", compute_dtype="bfloat16",
            batch_size=BATCH, device="cuda")
        _, infer, masks, scfg = serve.build_inference_fn(
            recipe, NUM_CLASSES, workdir, "latest", compute_dtype="bfloat16",
            batch_size=BATCH, device="cuda")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    st = second.state
    with torch.no_grad():
        direct = mu.cast_params_for_inference(
            mu.fold_bn_for_inference(st.params, st.model_state, scfg))
    same_params = direct.keys() == infer.keys() and all(
        torch.equal(direct[k], infer[k]) for k in direct)
    rng = np.random.default_rng(12)
    images = [rng.integers(0, 256, (img_size, img_size, 3)).astype(np.uint8)
              for _ in range(8)]
    batcher = serve._Batcher(runner, BATCH, max_wait_ms=20.0)
    zero_launches()
    with ThreadPoolExecutor(4) as ex:
        answers = list(ex.map(batcher.predict, images))
    serve_launches = kernel_launches()
    plans = mu.precompute_mask_plans(masks)

    def logits(params, batch):
        x = torch.from_numpy(batch).cuda().float() / 255.0
        with torch.no_grad():
            out, _ = mu.apply(params, None, x, cfg=scfg, masks=masks,
                              folded=True, mask_plans=plans)
        return out.semantic

    served = logits(infer, np.stack(images))
    want_logits = logits(direct, np.stack(images))
    same_logits = torch.equal(served, want_logits)
    answered = sum(
        int(np.array_equal(ans, logits(direct, np.stack([img] * BATCH))[0]
                           .argmax(-1).to(torch.uint8).cpu().numpy()))
        for img, ans in zip(images, answers))
    metrics = batcher.metrics()
    check(same_params and same_logits and answered == 8
          and bool(torch.isfinite(served.float()).all()),
          f"loop: the workdir served equals a direct folded forward of the "
          f"final state (params {same_params}, logits {same_logits}, "
          f"answers {answered}/8)")
    check(serve_launches["K1"] == 6 * metrics["batches"]
          and sum(serve_launches.values()) == serve_launches["K1"],
          f"loop: serving launches K1 6 times a forward: {serve_launches}")
    emit(phase="loop", card=card, batch=BATCH, steps=steps,
         launches=launches, resume_launches=resume_launches,
         serve_launches=serve_launches, seconds_2_epochs=first_s,
         seconds_resumed_epoch=second_s,
         img_per_s=first.images_per_sec,
         img_per_s_resumed=second.images_per_sec,
         save_blocked_s=first.save_blocked_s,
         save_blocked_s_resumed=second.save_blocked_s,
         one_save_s=one_save_s, checkpoint_bytes=checkpoint_bytes,
         history=first.history + second.history,
         checkpoints=files, restored_equal=restored_equal,
         served_params_equal=same_params, served_logits_equal=same_logits,
         answers_equal_direct=answered, serve_batches=metrics["batches"])
    return {"K1": launches["K1"], "K2": launches["K2"],
            "K4": launches["K4"], "gaps": gaps, "img_per_s":
            first.images_per_sec, "save_blocked_s": first.save_blocked_s}


def phase_loop_time(card: str, loop: dict) -> None:
    """Where the loop's time goes (phase 13): the gaps between train steps
    in the `loop` run (saves, validation), in the same 2 epochs without
    saves or validation, the same with every batch already on the card
    (no prefetch thread), and the bare step on one batch."""
    recipe = loop_recipe()
    kw = dict(max_epochs=2, save_checkpoints=False, compute_dtype="bfloat16",
              verbose=False, device="cuda")
    rows = {"loop": (loop["gaps"], loop["img_per_s"])}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_loop_time_")
    try:
        res, gaps = timed_train(recipe, None, workdir, **kw)
        rows["no_saves"] = (gaps, res.images_per_sec)
        prefetcher = train_loop.pipeline.Prefetcher

        class OnCard:
            """Every batch of the epoch copied to the card up front."""

            def __init__(self, iterator, device, depth=2):
                self.items = [train_loop.pipeline.to_device(b, device)
                              for b in iterator]

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                pass

            def __iter__(self):
                return iter(self.items)

        train_loop.pipeline.Prefetcher = OnCard
        try:
            res, gaps = timed_train(recipe, None, workdir, **kw)
        finally:
            train_loop.pipeline.Prefetcher = prefetcher
        rows["batches_on_card"] = (gaps, res.images_per_sec)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    cfg = train_loop.model_config(recipe, NUM_CLASSES,
                                  compute_dtype="bfloat16")
    ts = train_loop.setup_state(recipe, cfg,
                                train_loop.make_optimizer(recipe),
                                device="cuda")
    step = train_step.make_train_step(
        cfg, recipe.task_config, mask_plans=mu.precompute_mask_plans(ts.masks),
        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    batch = {"image": torch.rand(BATCH, IMG, IMG, 3, generator=gen,
                                 device="cuda"),
             "label": torch.randint(0, NUM_CLASSES, (BATCH, IMG, IMG),
                                    generator=gen, device="cuda")}
    for _ in range(3):
        ts, _ = step(ts, batch)
    torch.cuda.synchronize()
    stamps = [time.perf_counter()]
    for _ in range(15):
        ts, _ = step(ts, batch)
        stamps.append(time.perf_counter())
    torch.cuda.synchronize()
    rows["bare_step"] = ([float(g) for g in np.diff(stamps) * 1e3], None)
    del ts
    emit(phase="loop_time", card=card, batch=BATCH,
         save_blocked_s=loop["save_blocked_s"],
         **{name: {"median_step_ms": float(np.median(g)),
                   "img_per_s_at_median": BATCH * 1e3 / float(np.median(g)),
                   "mean_step_ms": float(np.mean(g)),
                   "max_step_ms": float(np.max(g)), "meter_img_per_s": ips,
                   "steps_ms": [round(x, 2) for x in g]}
            for name, (g, ips) in rows.items()})


def panoptic_recipe():
    """ADE panoptic (CE 0.9 + triplet 0.1 on the 150 logits) over the
    seeded synthetic dataset with instance ids, at its size."""
    return dataclasses.replace(recipes.get("ade_panoptic"),
                               dataset="synthetic", num_classes=NUM_CLASSES)


def instance_recipe():
    """Cityscapes instance (19 classes, a 16-d embedding head, the
    boundary head, CE ignoring 255 + triplet 0.5 on the embeddings) over
    the seeded synthetic dataset."""
    return dataclasses.replace(recipes.get("city_instance"),
                               dataset="synthetic")


class EvaluatorClock:
    """Seconds spent in the evaluators (`evaluate_panoptic`,
    `evaluate_instances`) and, of those, inside `_iter_eval`: the eval
    step on the card and the copies of its outputs to the host. The rest
    is host decode (and the DBSCAN's calls) not hidden behind the card."""

    def __enter__(self):
        self.total = self.device = 0.0
        self.saved = (evaluators._iter_eval, evaluators.evaluate_panoptic,
                      evaluators.evaluate_instances)
        iter_eval, panoptic_fn, instances_fn = self.saved

        def timed_iter(*args, **kw):
            items = iter_eval(*args, **kw)
            while True:
                t0 = time.perf_counter()
                item = next(items, None)
                self.device += time.perf_counter() - t0
                if item is None:
                    return
                yield item

        def timed(fn):
            def run(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    self.total += time.perf_counter() - t0
            return run

        evaluators._iter_eval = timed_iter
        evaluators.evaluate_panoptic = timed(panoptic_fn)
        evaluators.evaluate_instances = timed(instances_fn)
        return self

    def __exit__(self, *exc):
        (evaluators._iter_eval, evaluators.evaluate_panoptic,
         evaluators.evaluate_instances) = self.saved


def run_task_loop(card: str, phase: str, recipe, num_classes: int,
                  loop: dict, task_keys: tuple) -> tuple:
    """`train` for 2 epochs as phase `loop` runs it (validation every
    epoch over 2 batches, a checkpoint every 4 steps), counters zeroed
    just before: 16 steps launch K2 and K4 6 times each, each validation
    batch of both passes (the loss and the evaluator) K1 6 times, nothing
    else; a finite history with `task_keys`. Returns (result, line)."""
    kw = dict(eval_every=1, eval_max_batches=2, ckpt_every=4,
              compute_dtype="bfloat16", verbose=False, device="cuda")
    want = dict.fromkeys(counted_wrappers(), 0)
    workdir = tempfile.mkdtemp(prefix=f"chip_smoke_{phase}_")
    try:
        with EvaluatorClock() as clock:
            zero_launches()                      # the main path's run
            t0 = time.monotonic()
            res, gaps = timed_train(recipe, None, workdir, max_epochs=2,
                                    **kw)
            torch.cuda.synchronize()
            seconds = time.monotonic() - t0
            launches = kernel_launches()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    keys = ("loss", "miou", "val_loss", "val_ce_loss", "val_triplet_loss",
            "val_miou") + task_keys
    finite = all(k in r and math.isfinite(r[k]) for r in res.history
                 for k in keys)
    check(launches == {**want, "K2": 6 * 16, "K4": 6 * 16, "K1": 6 * 8},
          f"{phase}: 16 steps launch K2 and K4 6 times each, 2 validation "
          f"batches of each pass K1 6 times each, nothing else: {launches}")
    check([r["step"] for r in res.history] == [8, 16] and finite,
          f"{phase}: a finite history at steps 8, 16 with {keys}: "
          f"{res.history}")
    line = {"phase": phase, "card": card, "batch": BATCH,
            "classes": num_classes, "launches": launches,
            "seconds_2_epochs": seconds, "img_per_s": res.images_per_sec,
            "semantic_loop_img_per_s": loop["img_per_s"],
            "median_step_gap_ms": float(np.median(gaps)),
            "semantic_loop_median_step_gap_ms": float(np.median(
                loop["gaps"])),
            "save_blocked_s": res.save_blocked_s,
            "evaluator_s": clock.total, "evaluator_device_eval_s":
            clock.device, "evaluator_host_decode_s": clock.total
            - clock.device, "history": res.history}
    return res, line


def first_batch(ds) -> dict:
    """The dataset's first batch of 8 on the card, without `valid`."""
    pipe = train_loop.pipeline
    batches = pipe.BatchIterator(ds, BATCH, shuffle=False).epoch(0)
    batch = pipe.to_device(next(batches), "cuda")
    batches.close()
    batch.pop("valid")
    return batch


def eval_batch_ms(recipe, ts, batch) -> dict:
    """Where `_iter_eval`'s time goes on one batch (ms, best of 3): the
    eval step (synchronised), then the copies of its argmax and its
    probabilities to the host."""
    cfg = train_loop.model_config(recipe, recipe.num_classes,
                                  compute_dtype="bfloat16")
    step = train_step.cached_eval_step(cfg, recipe.task_config,
                                       torch.device("cuda"))
    plans = mu.precompute_mask_plans(ts.masks)
    best = dict.fromkeys(("eval_step_ms", "pred_copy_ms", "prob_copy_ms"),
                         float("inf"))
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(ts, batch, plans)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out["pred"].cpu()
        t2 = time.perf_counter()
        out["prob"].cpu()
        t3 = time.perf_counter()
        for key, dt in zip(best, (t1 - t0, t2 - t1, t3 - t2)):
            best[key] = min(best[key], dt * 1e3)
    return best


def injected_step(phase: str, recipe, num_classes: int) -> tuple:
    """One step of `recipe` on the first training batch with injected
    triplets, from a fresh state: the f32 gradients through the kernels
    against the plain path's (cosine >= TRAIN_GRAD_COS per tensor), the
    bf16 step's launches (K2 6, K4 6), its loss the blend of its terms,
    and its triplet term equal to `triplet_from_indices` on the features
    (logits or embeddings) of a forward of its own with the same dropout
    draws. Returns (cfg, state after the step, batch, plans, fields)."""
    task = recipe.task_config
    cfg = train_loop.model_config(recipe, num_classes,
                                  compute_dtype="bfloat16")
    ts = train_loop.setup_state(recipe, cfg,
                                train_loop.make_optimizer(recipe),
                                device="cuda")
    plans = mu.precompute_mask_plans(ts.masks)
    batch = first_batch(make_datasets(recipe, None)[0])
    triplets = triplet_lib.sample_triplets(
        torch.Generator(device="cuda").manual_seed(5), batch["instance"],
        num_samples=task.triplet_samples,
        ignore_label=task.triplet_ignore_label)
    gen_state = ts.generator.get_state()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    (k32, loss_k32), (p32, loss_p32) = (
        step_grads(cfg32, task, ts, batch, plans, gen_state, plain, triplets)
        for plain in (False, True))
    cos32 = {n: cos(k32[n], p32[n]) for n in p32}
    worst = min(cos32, key=cos32.get)
    del k32, p32
    check(cos32[worst] >= TRAIN_GRAD_COS,
          f"{phase} f32 train gradients, kernels vs plain: {worst} "
          f"{cos32[worst]}")

    # the triplet term recomputed on the step's own features
    ts.generator.set_state(gen_state)
    out, _ = mu.apply(ts.params, ts.model_state, batch["image"], cfg=cfg,
                      masks=ts.masks, train=True,
                      dropout_generator=ts.generator, mask_plans=plans)
    feats = (out.embeddings if task.triplet_features == "embeddings"
             else out.semantic.float())
    a_idx, p_idx, n_idx, weight = triplets
    own_triplet = float(triplet_lib.triplet_from_indices(
        feats.detach(), a_idx, p_idx, n_idx, weight))
    del out, feats

    ts.generator.set_state(gen_state)
    step = train_step.make_train_step(cfg, task, mask_plans=plans,
                                      device="cuda")
    zero_launches()
    ts, metrics = step(ts, batch, triplets)
    torch.cuda.synchronize()
    step_launches = kernel_launches()
    check(step_launches == {**dict.fromkeys(counted_wrappers(), 0),
                            "K2": 6, "K4": 6},
          f"{phase} step launches K2 6, K4 6: {step_launches}")
    m = {k: float(v) for k, v in metrics.items()}
    blend = task.ce_weight * m["ce_loss"] + task.triplet_weight * \
        m["triplet_loss"]
    check(abs(m["loss"] - blend) <= BLEND_RTOL * abs(blend)
          and math.isfinite(m["triplet_loss"]) and m["triplet_loss"] > 0,
          f"{phase} step: loss = {task.ce_weight} CE + "
          f"{task.triplet_weight} triplet, the triplet finite and "
          f"positive: {m}")
    triplet_rel = abs(m["triplet_loss"] - own_triplet) / abs(own_triplet)
    check(triplet_rel <= TRIPLET_RTOL,
          f"{phase} step: its triplet term {m['triplet_loss']} equals "
          f"triplet_from_indices on its {task.triplet_features}, "
          f"{own_triplet}")
    fields = dict(step_launches=step_launches, step_metrics=m,
                  blend_rel_diff=abs(m["loss"] - blend) / abs(blend),
                  blend_rtol=BLEND_RTOL, triplet_recomputed=own_triplet,
                  triplet_rel_diff=triplet_rel, triplet_rtol=TRIPLET_RTOL,
                  triplet_weight_sum=float(weight.sum()),
                  loss_f32_kernels=loss_k32, loss_f32_plain=loss_p32,
                  f32_min_cosine=cos32[worst], f32_min_cosine_tensor=worst,
                  f32_cos_limit=TRAIN_GRAD_COS, tensors_compared=len(cos32))
    return cfg, ts, batch, plans, fields


def phase_panoptic_loop(card: str, loop: dict) -> dict:
    """The panoptic recipe's loop with PQ and AP each epoch (phase 14),
    then one step on injected triplets (`injected_step`) and 10 steps
    that lower the loss."""
    recipe = panoptic_recipe()
    res, line = run_task_loop(card, "panoptic_loop", recipe, NUM_CLASSES,
                              loop, ("val_pq", "val_ap"))
    del res
    cfg, ts, batch, plans, fields = injected_step("panoptic", recipe,
                                                  NUM_CLASSES)
    step = train_step.make_train_step(cfg, recipe.task_config,
                                      mask_plans=plans, device="cuda")
    losses = [fields["step_metrics"]["loss"]]
    for _ in range(TRAIN_STEPS - 1):
        ts, metrics = step(ts, batch)
        losses.append(float(metrics["loss"]))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"panoptic {TRAIN_STEPS} steps: finite loss that falls: {losses}")
    eval_ms = eval_batch_ms(recipe, ts, batch)
    emit(**line, **fields, losses=losses, eval_batch=eval_ms)
    return {k: line["launches"][k] for k in ("K1", "K2", "K4")}


def phase_instance_loop(card: str, loop: dict) -> dict:
    """The instance recipe's loop with AP each epoch (phase 15), then the
    DBSCAN on the first validation batch's embeddings: on the card (ms
    per image) and on the CPU, the same masks; then one step on injected
    triplets (`injected_step`, the triplet on the embeddings)."""
    recipe = instance_recipe()
    _, val_ds, num_classes = make_datasets(recipe, None)
    res, line = run_task_loop(card, "instance_loop", recipe, num_classes,
                              loop, ("val_ap",))
    ((_, _, host),) = list(evaluators._iter_eval(
        recipe, val_ds, num_classes, res.state, max_batches=1,
        compute_dtype="bfloat16", device="cuda"))
    eval_ms = eval_batch_ms(recipe, res.state, first_batch(val_ds))
    del res
    pred, emb = host["pred"], host["embeddings"]
    check(emb.is_cuda, "instance eval: the embeddings stay on the card")
    clustering.instances_from_embeddings(pred[0], emb[0])     # warm-up
    card_ms, card_masks, cpu_s, same = [], [], 0.0, []
    for b in range(pred.shape[0]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks = clustering.instances_from_embeddings(pred[b], emb[b])
        torch.cuda.synchronize()
        card_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        cpu = clustering.instances_from_embeddings(pred[b], emb[b].cpu())
        cpu_s += time.perf_counter() - t0
        same.append(len(cpu) == len(masks) and all(
            np.array_equal(a, c) for a, c in zip(masks, cpu)))
        card_masks.append(len(masks))
    pixels = [int(max(np.bincount(p[p > 0].ravel(), minlength=1)))
              for p in pred]
    check(all(same), f"instance DBSCAN: the card's masks equal the CPU's "
          f"image by image: {same}")
    del host, pred, emb
    *_, fields = injected_step("instance", recipe, num_classes)
    emit(**line, **fields, dbscan_ms_per_image=float(np.mean(card_ms)),
         dbscan_ms=card_ms, dbscan_cpu_s=cpu_s, dbscan_masks=card_masks,
         dbscan_largest_class_pixels=pixels, dbscan_card_equals_cpu=same,
         eval_batch=eval_ms)
    return {k: line["launches"][k] for k in ("K1", "K2", "K4")}


def phase_safe(card: str) -> dict:
    """The serving and training paths with the safe softmax on: their
    checks, wall times and device profiles. Returns the launches of K3
    (16 served requests + one step) and of K4 (one step)."""
    fa._SAFE_SOFTMAX = True
    try:
        serving = phase_serving(card, safe=True)
        serve_wall_and_profile(card, serving["runner"],
                               np.stack(serving["images"][:BATCH]), "safe_",
                               "fwd_online")
        del serving["runner"]
        train = phase_train(card, safe=True)
        train_wall_and_profile(card, train, "safe_",
                               {"k3_share": "fwd_online",
                                "k4_share": K4_TAG})
    finally:
        fa._SAFE_SOFTMAX = False
    return {"K3": serving["launches"] + train["launches"]["K3"],
            "K4": train["launches"]["K4"]}


def tool_cases() -> list:
    """(kernel, name, call, plain call, output names, bound (bytes ms, ops
    ms), {library: call}) of K5, K6 (D and E), K6's repack (of q65 and
    k65, as one K6 call makes) and K7 at their tools' attn6 inputs. K6's
    library call is SDPA at C 64 with the bias as an additive mask, which
    computes its function on these inputs (q65 = [q log2e, 1], k65 = [k,
    bias]: exp2(q65 . k65) = exp(q . k + bias)); `library_c65` is SDPA on
    q65 / k65 themselves, which no fused backend takes at C 65."""
    q, k, v, bias = softmax_ab.attn6_inputs(BATCH)
    q65, k65 = softmax_ab.bias_as_channel(q, k, bias)
    bq, bk, bv, bbias = bf16_tool.attn6_inputs(BATCH)
    lq, lk, c = q.shape[1], k.shape[1], q.shape[2]
    e = q.element_size()
    k6_bytes = (q65.numel() + k65.numel() + v.numel() + q.numel()) * e
    k6_ops = max(2 * BATCH * lq * lk * (C65 + c) / PEAK[torch.bfloat16],
                 BATCH * lq * lk / PEAK["exp2"])
    # the repack reads q65 and k65 once and writes 64 bf16 channels and
    # one f32 a row
    repack_bytes = (q65.numel() + k65.numel()) * e \
        + BATCH * (lq + lk) * (c * e + 4)
    k5_bound = bound_ms(q, k, bias)
    k7_bound = bound_ms(bq, bk, bbias)
    lse_ms = 4 * BATCH * lq / PEAK["bytes"] * 1e3
    sdpa = (lambda q_, k_, v_, b_: lambda: F.scaled_dot_product_attention(
        q_[:, None], k_[:, None], v_[:, None],
        attn_mask=b_[:, None].to(q_.dtype), scale=1.0))
    sdpa65 = (lambda: F.scaled_dot_product_attention(
        q65[:, None], k65[:, None], v[:, None], scale=math.log(2.0)))
    k6_bound = (k6_bytes / PEAK["bytes"] * 1e3, k6_ops * 1e3)
    return [
        ("K5", "old_flash_fwd",
         lambda: softmax_ab.old_flash_fwd(q, k, v, bias),
         lambda: softmax_ab.old_flash_fwd_reference(q, k, v, bias),
         ("o", "lse"), (k5_bound[0] + lse_ms, k5_bound[1]),
         {"library": sdpa(q, k, v, bias)}),
        *(("K6", f"nomax65_fwd_{variant}",
           functools.partial(softmax_ab.nomax65_fwd, q65, k65, v, clamp),
           functools.partial(softmax_ab.nomax65_fwd_reference, q65, k65, v,
                             clamp),
           ("o",), k6_bound,
           {"library": sdpa(q, k, v, bias), "library_c65": sdpa65})
          for variant, clamp in (("D", True), ("E", False))),
        ("K6_repack", "repack65",
         lambda: (*softmax_ab.repack65(q65), *softmax_ab.repack65(k65)),
         lambda: (*softmax_ab.repack65_reference(q65),
                  *softmax_ab.repack65_reference(k65)),
         ("q64", "qa", "k64", "kb"), (repack_bytes / PEAK["bytes"] * 1e3, 0.0),
         {}),
        ("K7", "flash_fwd_bf16", lambda: bf16_tool.flash_fwd_bf16(
            bq, bk, bv, bbias),
         lambda: bf16_tool.flash_fwd_bf16_reference(bq, bk, bv, bbias),
         ("o", "lse"), (k7_bound[0] + lse_ms, k7_bound[1]),
         {"library": sdpa(bq, bk, bv, bbias)}),
    ]


def tool_edge_cases() -> list:
    """(kernel, name, call, plain call, output names, expected(outputs))
    of the tools' kernels at ragged shapes, checked only: K5 and K7 where
    Lq and Lk stop short of a tile (Lk one past the 128-key tile, and three
    tiles and 50 keys), with batch row 1 fully masked (the mean of V); K6
    D and E at Lq 37 and Lk 129 and 131 (so that k65's rows start off any
    16-byte boundary) with a 65th channel that is random, 0 and negative,
    scores past 60 on some rows (where D and E differ), and a NaN in one
    key row of batch row 1 (NaN there); K6's repack of those inputs,
    exactly."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = []
    for lq, lk in ((37, 129), (150, 3 * 128 + 50)):
        q = (torch.randn(2, lq, 64, generator=gen, device="cuda")
             * 0.125).bfloat16()
        k, v = (torch.randn(2, lk, 64, generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        bias = fa.mask_to_bias(torch.rand(2, lk, generator=gen,
                                          device="cuda") < 0.5, 2, lk)
        bias[1] = fa.NEG_INF
        mean_v = v[1].float().mean(0).expand(lq, 64).bfloat16()

        def mean_of_v(outs, mean_v=mean_v):
            return agreement(outs[0][1], mean_v)["ok"]

        for kname, name, kernel, plain in (
                ("K5", "old_flash_fwd", softmax_ab.old_flash_fwd,
                 softmax_ab.old_flash_fwd_reference),
                ("K7", "flash_fwd_bf16", bf16_tool.flash_fwd_bf16,
                 bf16_tool.flash_fwd_bf16_reference)):
            cases.append((kname, f"{name}_q{lq}_k{lk}_masked_row",
                          functools.partial(kernel, q, k, v, bias),
                          functools.partial(plain, q, k, v, bias),
                          ("o", "lse"), mean_of_v))
    for lk in (129, 131):
        q65, k65 = (torch.randn(2, n, 65, generator=gen, device="cuda")
                    for n in (37, lk))
        q65[..., :64] *= 0.35
        q65[:, ::5, 64] = 0.0                    # qa 0 on every 5th row
        q65[:, 1::3, 64] *= -1.0
        # s past 60 (~80) where qa = 40 meets kb = 2; |qa kb| stays below
        # ~100 elsewhere, so that E's exp2 stays finite
        q65[0, :4, 64] = 40.0
        k65[..., 64] *= 0.5
        k65[0, ::9, 64] = 2.0
        k65[1, 3] = float("nan")
        q65, k65 = q65.bfloat16(), k65.bfloat16()
        v = torch.randn(2, lk, 64, generator=gen, device="cuda").bfloat16()
        for variant, clamp in (("D", True), ("E", False)):
            other = softmax_ab.nomax65_fwd_reference(q65, k65, v, not clamp)

            def k6_expected(outs, other=other):
                o = outs[0]
                return bool(torch.isnan(o[1]).all()
                            and torch.isfinite(o[0]).all()
                            and not torch.equal(o[0, :4], other[0, :4]))

            cases.append(("K6", f"nomax65_fwd_{variant}_q37_k{lk}",
                          functools.partial(softmax_ab.nomax65_fwd, q65, k65,
                                            v, clamp),
                          functools.partial(softmax_ab.nomax65_fwd_reference,
                                            q65, k65, v, clamp),
                          ("o",), k6_expected))
        cases.append(("K6_repack", f"repack65_q37_k{lk}",
                      lambda q65=q65, k65=k65: (*softmax_ab.repack65(q65),
                                                *softmax_ab.repack65(k65)),
                      lambda q65=q65, k65=k65: (
                          *softmax_ab.repack65_reference(q65),
                          *softmax_ab.repack65_reference(k65)),
                      ("q64", "qa", "k64", "kb"), None))
    return cases


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit for bit (NaN included)."""
    ints = {2: torch.int16, 4: torch.int32}[want.element_size()]
    return got.dtype == want.dtype and torch.equal(got.view(ints),
                                                   want.view(ints))


def phase_tools(card: str) -> dict:
    """K5, K6 and its repack, and K7 against their plain versions at the
    tools' inputs and the edge cases, the three tool mains (the launches
    counted), then each kernel timed. Returns {kernel: {launches,
    max_abs_err, ms, plain_ms, library_ms (K6 also library_c65_ms),
    bytes_ms, ops_ms, bound_ms}} (K6: the clamped variant D's times)."""
    out = {}
    cases = tool_cases()
    checks = [(*case[:5], None) for case in cases] + tool_edge_cases()
    for kname, name, call, plain, names, expected in checks:
        got, want = call(), plain()
        torch.cuda.synchronize()
        got, want = ((got, want) if isinstance(got, tuple)
                     else ((got,), (want,)))
        outs = {n: agreement(g, w) for n, g, w in zip(names, got, want)}
        if kname == "K6_repack":                 # a copy: exact
            for n, g, w in zip(names, got, want):
                outs[n]["expected"] = same_bits(g, w)
        elif expected is not None:
            outs[names[0]]["expected"] = expected(got)
        ok = all(a["ok"] and a.get("expected", True) for a in outs.values())
        emit(phase="tools", case=name, dtype="bfloat16",
             shape=list(got[0].shape), outputs=outs, ok=ok)
        check(ok, f"tools {name}")
        err = max(a["max_abs_err"] for a in outs.values())
        out.setdefault(kname, {"max_abs_err": 0.0})
        out[kname]["max_abs_err"] = max(out[kname]["max_abs_err"], err)
        del got, want

    zero_launches()                              # the tools' main paths
    printed = {"softmax_ab": softmax_ab.main([]),
               "softmax_ab_2": softmax_ab.main2(["2"]),
               "bf16_softmax_experiment": bf16_tool.main()}
    torch.cuda.synchronize()
    counts = kernel_launches()
    emit(phase="tool_mains", card=card, printed=printed, launches=counts)
    check(all(counts[kn] > 0 for kn in ("K5", "K6", "K6_repack", "K7")),
          f"the tool mains launch K5, K6 and its repack, and K7: {counts}")
    check(all(math.isfinite(float(t)) for p in printed.values()
              for t in p["ms"].values()), "tool mains: finite times")

    for kname, name, call, plain, _, (t_bytes, t_ops), libs in cases:
        row = {"ms": device_ms(call, iters=20),
               "plain_ms": device_ms(plain, iters=2),
               **{f"{lib}_ms": device_ms(fn, iters=20)
                  for lib, fn in libs.items()},
               "bytes_ms": t_bytes, "ops_ms": t_ops,
               "bound_ms": max(t_bytes, t_ops)}
        row.setdefault("library_ms", None)
        emit(phase="tool_time", card=card, kernel=kname, case=name,
             batch=BATCH, dtype="bfloat16", **row,
             bound_by="bytes" if t_bytes > t_ops else "operations",
             share_of_bound=row["bound_ms"] / row["ms"])
        if name != "nomax65_fwd_E":
            out[kname].update(row)
    for kname in out:
        out[kname]["launches"] = counts[kname]
    return out


def phase_image_io(card: str) -> dict:
    """Decode and resize `data/image_check.py`'s fixed set on this host
    (phase 16): every digest must equal the one the CPU tests pin.
    Returns the host's cv2 and matplotlib versions (None: no matplotlib)."""
    got = image_check.digests()
    libs = image_check.host_libraries()
    equal = {k: got[k] == image_check.EXPECTED.get(k) for k in got}
    check(set(got) == set(image_check.EXPECTED) and all(equal.values()),
          f"image_io: decodes and resizes equal the CPU's digests: {equal}")
    emit(phase="image_io", card=card, **libs, digests=got,
         equal_to_cpu=equal)
    return libs


def write_fake_layouts(root: str) -> dict:
    """The three fake layouts at the real class counts: {dataset: root}."""
    roots = {"ade20k": os.path.join(root, "ade"),
             "coco": os.path.join(root, "coco"),
             "cityscapes": os.path.join(root, "cityscapes")}
    fake_data.make_ade(roots["ade20k"], n=FAKE_TRAIN, num_classes=151)
    fake_data.make_coco(roots["coco"], n=FAKE_TRAIN, num_classes=134)
    fake_data.make_cityscapes(roots["cityscapes"], n=FAKE_TRAIN)
    return roots


def fake_recipe(name: str):
    """The recipe with its batch capped at 8, as run_all_recipes runs it."""
    rec = recipes.get(name)
    return dataclasses.replace(rec, batch_size=min(rec.batch_size, 8))


def phase_recipes(card: str, roots: dict) -> tuple:
    """The nine recipes on the fake layouts (phase 17): `train` for one
    epoch on RECIPE_FRACTION of the training images with validation,
    counters zeroed before each: K2 and K4 6 times
    a step, K1 6 times a validation batch of each pass (the loss pass, and
    the evaluator's for instance and panoptic recipes), nothing else; a
    finite loss and val_miou (and val_pq, val_ap). Returns (K1, K2 and
    K4's launches summed over the nine, the ade_panoptic state)."""
    kw = dict(eval_every=1, compute_dtype="bfloat16", verbose=False,
              save_checkpoints=False, device="cuda",
              data_fraction=RECIPE_FRACTION)
    zeros = dict.fromkeys(counted_wrappers(), 0)
    total = dict.fromkeys(("K1", "K2", "K4"), 0)
    pan_state = None
    for name in RECIPE_NAMES:
        rec = fake_recipe(name)
        root = roots[rec.dataset]
        train_ds, val_ds, classes = make_datasets(rec, root)
        check(len(train_ds) == FAKE_TRAIN and len(val_ds) == FAKE_VAL,
              f"recipes {name}: {len(train_ds)} training and "
              f"{len(val_ds)} validation images, not {FAKE_TRAIN} and "
              f"{FAKE_VAL}")
        steps = round(len(train_ds) * RECIPE_FRACTION) // rec.batch_size
        val_batches = min(8, -(-len(val_ds) // rec.batch_size))
        passes = 1 if rec.task == "semantic" else 2
        workdir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
        try:
            zero_launches()                  # the main path's run
            t0 = time.monotonic()
            res = train_loop.train(rec, root, workdir, max_epochs=1, **kw)
            torch.cuda.synchronize()
            seconds = time.monotonic() - t0
            launches = kernel_launches()
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        (record,) = res.history
        keys = ("loss", "miou", "val_loss", "val_miou") + {
            "panoptic": ("val_pq", "val_ap"), "instance": ("val_ap",),
            "semantic": ()}[rec.task]
        check(launches == {**zeros, "K2": 6 * steps, "K4": 6 * steps,
                           "K1": 6 * val_batches * passes},
              f"recipes {name}: {steps} steps launch K2 and K4 6 times "
              f"each, {val_batches} validation batches of {passes} "
              f"pass(es) K1 6 times each: {launches}")
        check(record["step"] == steps and all(
            k in record and math.isfinite(record[k]) for k in keys),
              f"recipes {name}: a finite {keys}: {record}")
        for k in total:
            total[k] += launches[k]
        row = {"recipe": name, "classes": classes, "batch": rec.batch_size,
               "steps": steps, "val_images": len(val_ds),
               "launches": launches, "seconds": seconds,
               "img_per_s": res.images_per_sec,
               **{k: record[k] for k in keys}}
        emit(phase="recipes", card=card, **row)
        if name == "ade_panoptic":
            pan_state = res.state
        del res
    return total, pan_state


def phase_data_rate(card: str, root: str) -> None:
    """Whether the loader keeps up with the card (phase 19): a fake ADE
    layout of 512 px images (ADE's usual side), decoded and resized to
    128 px one image at a time on this host (ms per image, and of those
    the two decodes), then `BatchIterator` with 4 I/O threads behind the
    `Prefetcher` to the card (img/s, uncached), against the bare train
    step of ade_semantic (151 classes, batch 8, bf16) on one of those
    batches (img/s)."""
    t0 = time.monotonic()
    fake_data.make_ade(root, n=DATA_RATE_IMAGES, size=DATA_RATE_SIDE,
                       num_classes=151)
    write_s = time.monotonic() - t0
    ds = ade20k.ADE20KSemanticDataset(root, "training", img_size=IMG)
    check(len(ds) == DATA_RATE_IMAGES, f"data_rate: {len(ds)} images")
    load_ms, decode_ms = [], []
    for i in range(len(ds)):
        t0 = time.perf_counter()
        ex = ds[i]
        load_ms.append((time.perf_counter() - t0) * 1e3)
        name = ds.files[i]
        t0 = time.perf_counter()
        full = resize.imread_rgb(os.path.join(ds.img_dir, name))
        resize.imread_gray(os.path.join(
            ds.ann_dir, os.path.splitext(name)[0] + ".png"))
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    check(ex["image"].shape == (IMG, IMG, 3) and full.shape
          == (DATA_RATE_SIDE, DATA_RATE_SIDE, 3),
          f"data_rate: {full.shape} read, {ex['image'].shape} out")

    batches = train_loop.pipeline.BatchIterator(ds, BATCH, shuffle=True,
                                                seed=0, num_threads=4)
    t0 = time.perf_counter()
    count = 0
    with train_loop.pipeline.Prefetcher(batches.epoch(0),
                                        device="cuda") as prefetcher:
        for batch in prefetcher:
            count += int(batch["image"].shape[0])
    torch.cuda.synchronize()
    loader_s = time.perf_counter() - t0
    check(count == DATA_RATE_IMAGES, f"data_rate: the loader gave {count}")

    rec = recipes.get("ade_semantic")
    cfg = train_loop.model_config(rec, len(ds.categories),
                                  compute_dtype="bfloat16")
    ts = train_loop.setup_state(rec, cfg, train_loop.make_optimizer(rec),
                                device="cuda")
    step = train_step.make_train_step(
        cfg, rec.task_config, mask_plans=mu.precompute_mask_plans(ts.masks),
        device="cuda")
    batch = first_batch(ds)
    for _ in range(2):
        ts, _ = step(ts, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        ts, metrics = step(ts, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    check(math.isfinite(float(metrics["loss"])), "data_rate: finite step")
    emit(phase="data_rate", card=card, side=DATA_RATE_SIDE,
         images=DATA_RATE_IMAGES, write_s=write_s,
         load_ms_per_image=float(np.mean(load_ms)),
         load_ms_median=float(np.median(load_ms)),
         decode_ms_per_image=float(np.mean(decode_ms)),
         loader_threads=4, loader_img_per_s=count / loader_s,
         step_ms=step_s * 1e3, step_img_per_s=BATCH / step_s,
         classes=len(ds.categories))


def phase_predict(card: str, ts, roots: dict, matplotlib: str | None
                  ) -> dict:
    """`predict_directory` on the card (phase 18) with the ade_panoptic
    state that `recipes` trained, over 11 of the fake ADE images (a full
    batch and a padded one): instances, the panoptic export and, where
    matplotlib imports, panels. Each mask must equal the argmax of a
    direct eval forward of the same batch (what predict computes), and
    PREDICT_FOLDED_AGREE of the pixels that of the folded bf16 forward."""
    rec = fake_recipe("ade_panoptic")
    src = os.path.join(roots["ade20k"], "images", "training")
    work = tempfile.mkdtemp(prefix="chip_smoke_predict_")
    try:
        images = os.path.join(work, "images")
        os.makedirs(images)
        for name in sorted(os.listdir(src))[:PREDICT_IMAGES]:
            shutil.copy(os.path.join(src, name), images)
        out = os.path.join(work, "out")
        classes = make_datasets(rec, roots["ade20k"])[2]
        zero_launches()
        t0 = time.monotonic()
        written = predict.predict_directory(
            rec, ts, images, out, num_classes=classes,
            compute_dtype="bfloat16", save_instances=True,
            save_panoptic=True, save_panels=matplotlib is not None,
            device="cuda")
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = kernel_launches()
        with open(os.path.join(out, "predictions.json")) as f:
            manifest = json.load(f)
        masks = [resize.imread_gray(p) for p in written]
        outputs = sorted(os.listdir(out))
        panoptic_files = sorted(os.listdir(os.path.join(out, "panoptic")))
        ds = predict._DirectoryDataset(images, rec.img_size)
        cfg = train_loop.model_config(rec, classes,
                                      compute_dtype="bfloat16")
        with torch.no_grad():
            folded = mu.cast_params_for_inference(
                mu.fold_bn_for_inference(ts.params, ts.model_state, cfg))
        plans = mu.precompute_mask_plans(ts.masks)
        direct, fold = [], []
        batches = train_loop.pipeline.BatchIterator(
            ds, rec.batch_size, shuffle=False, drop_last=False,
            pad_last=True)
        for batch in batches.epoch(0):
            x = train_loop.pipeline.to_device(batch, "cuda")["image"]
            with torch.no_grad():
                o, _ = mu.apply(ts.params, ts.model_state, x, cfg=cfg,
                                masks=ts.masks, train=False,
                                mask_plans=plans)
                f, _ = mu.apply(folded, None, x, cfg=cfg, masks=ts.masks,
                                folded=True, mask_plans=plans)
            valid = batch["valid"]
            direct += list(o.semantic.argmax(-1).cpu().numpy()[valid])
            fold += list(f.semantic.argmax(-1).cpu().numpy()[valid])
        no_panel_error = None
        if matplotlib is None:
            try:
                visualize.save_prediction(masks[0], masks[0], masks[0],
                                          os.path.join(work, "panel.png"))
            except ModuleNotFoundError as e:
                no_panel_error = str(e)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    equal = sum(int(np.array_equal(m, d)) for m, d in zip(masks, direct))
    agree = float(np.mean([np.mean(m == f) for m, f in zip(masks, fold)]))
    panels = sum(n.endswith("_panel.png") for n in outputs)
    zeros = dict.fromkeys(counted_wrappers(), 0)
    check(launches == {**zeros, "K1": 12},
          f"predict: 2 batches launch K1 6 times each: {launches}")
    check(len(written) == PREDICT_IMAGES == equal and len(direct)
          == PREDICT_IMAGES,
          f"predict: masks equal a direct eval forward: {equal}/"
          f"{len(written)}")
    check(agree >= PREDICT_FOLDED_AGREE,
          f"predict: masks agree with the folded forward: {agree}")
    check(len(manifest["instances"]) == PREDICT_IMAGES
          and "predictions.json" in panoptic_files
          and panels == (PREDICT_IMAGES if matplotlib else 0),
          f"predict: instances, panoptic export, panels: {outputs}")
    check(matplotlib is not None or "matplotlib" in (no_panel_error or ""),
          f"predict: without matplotlib a panel raises naming it: "
          f"{no_panel_error}")
    emit(phase="predict", card=card, images=PREDICT_IMAGES, classes=classes,
         launches=launches, seconds=seconds, masks_equal_direct=equal,
         folded_agreement=agree, folded_agree_limit=PREDICT_FOLDED_AGREE,
         instances=sum(len(v) for v in manifest["instances"].values()),
         panoptic_files=len(panoptic_files), panels=panels,
         matplotlib=matplotlib, panel_error=no_panel_error)
    return launches


ROOT = os.path.dirname(os.path.abspath(__file__))


def wall_and_device_ms(fn) -> tuple:
    """One serving forward `fn()` timed: the host's wall ms a call, best
    of 3 windows of 10 fenced by a synchronise, and the device's ms a call,
    the profiler's kernel sum over 3 calls ("not measured" if it saw no
    kernel)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / 10)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    rows = device_kernel_rows(prof)
    return best * 1e3, (sum(r[0] for r in rows) / 3e3 if rows
                        else "not measured")


def in_turns(fns: dict, rounds: int = 1) -> dict:
    """`wall_and_device_ms` of two forwards {name: fn} in `rounds` rounds
    of turns a, b, b, a; returns {name: {"wall_ms": [2 * rounds],
    "device_ms": [2 * rounds]}}."""
    (a, fa_), (b, fb_) = fns.items()
    out = {a: {"wall_ms": [], "device_ms": []},
           b: {"wall_ms": [], "device_ms": []}}
    for name, fn in ((a, fa_), (b, fb_), (b, fb_), (a, fa_)) * rounds:
        wall, dev = wall_and_device_ms(fn)
        out[name]["wall_ms"].append(wall)
        out[name]["device_ms"].append(dev)
    return out


def mean_ms(times: list) -> float | str:
    return (float(np.mean(times)) if all(isinstance(t, float) for t in times)
            else "not measured")


def phase_op_dispatch(card: str, runner, batch: np.ndarray) -> None:
    """The flash operators' cost on the eager serving forward (phase 20):
    the same forward with K1 launched directly, as the eager wrapper does
    (unchanged by the operators), and through the operator
    `maskunet::flash_fwd_nomax`, which exported artifacts call, in turns
    direct, operator, operator, direct, OP_ROUNDS rounds: K1 6 launches a
    forward both ways, the mean device ms a batch within OP_DEVICE_RTOL,
    the wall ms printed."""
    direct = fk.flash_fwd_nomax

    def through_op(q, k, v, bias, scale, use_valid=True):
        return fk._flash_fwd_nomax_op(q, k, v, bias, float(scale),
                                      bool(use_valid))

    launches = {}

    def with_kernel(wrapper):
        def run():
            fk.flash_fwd_nomax = wrapper
            try:
                return runner(batch)
            finally:
                fk.flash_fwd_nomax = direct
        return run

    fns = {"direct": with_kernel(direct),
           "operator": with_kernel(through_op)}
    for name, fn in fns.items():
        zero_launches()
        through_op.launches = 0
        fn()
        torch.cuda.synchronize()
        launches[name] = direct.launches + through_op.launches
    times = in_turns(fns, OP_ROUNDS)
    dev = {k: mean_ms(v["device_ms"]) for k, v in times.items()}
    wall = {k: mean_ms(v["wall_ms"]) for k, v in times.items()}
    check(launches == {"direct": 6, "operator": 6},
          f"op_dispatch: K1 6 launches a forward both ways: {launches}")
    check(all(isinstance(v, float) for v in dev.values())
          and abs(dev["operator"] - dev["direct"])
          <= OP_DEVICE_RTOL * dev["direct"],
          f"op_dispatch: device ms a batch through the operator within "
          f"{OP_DEVICE_RTOL} of the direct launches': {dev}")
    emit(phase="op_dispatch", card=card, batch=BATCH, launches=launches,
         device_ms_per_batch=dev, wall_ms_per_batch=wall, turns=times,
         order=f"direct, operator, operator, direct; {OP_ROUNDS} rounds")


def export_images(seed: int = 20) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (EXPORT_IMAGES, IMG, IMG, 3)).astype(np.uint8)


def per_image_equal(got: list, want: list) -> int:
    return sum(int(torch.equal(g[i], w[i])) for g, w in zip(got, want)
               for i in range(g.shape[0]))


def artifact_vs_live(path: str, live, kname: str) -> dict:
    """Load the artifact at `path` and run EXPORT_IMAGES images through it
    (counters zeroed before) and through the live runner `live`: launches,
    images equal, the artifact's bytes and load seconds."""
    t0 = time.monotonic()
    runner, meta = export_lib.load_serving_artifact(path)
    load_s = time.monotonic() - t0
    images = export_images()
    batches = [images[i:i + BATCH] for i in range(0, EXPORT_IMAGES, BATCH)]
    runner(batches[0])                     # warm-up
    torch.cuda.synchronize()
    zero_launches()
    got = [runner(b) for b in batches]
    torch.cuda.synchronize()
    launches = kernel_launches()
    want = [live(b) for b in batches]
    zeros = dict.fromkeys(counted_wrappers(), 0)
    return {"runner": runner, "meta": meta, "load_s": load_s,
            "launches": launches, "forwards": len(batches),
            "launches_ok": launches == {**zeros, kname: 6 * len(batches)},
            "equal": per_image_equal(got, want), "got": got, "want": want,
            "bytes": os.path.getsize(os.path.join(path,
                                                  export_lib.MODULE_NAME))}


def safe_export_child(out_dir: str) -> int:
    """`chip_smoke.py --safe-export <dir>`, run by phase `export` with
    MASKUNET_SAFE_SOFTMAX=1: the safe artifact (K3 in place of K1) against
    the safe live runner over the same images; prints one JSON line."""
    path = os.path.join(out_dir, "artifact_safe")
    export_lib.export_serving_artifact(
        "ade_semantic", NUM_CLASSES, None, "best", path,
        compute_dtype="bfloat16", batch_size=BATCH, device="cuda")
    live, _ = serve.build_model_runner(
        "ade_semantic", NUM_CLASSES, None, compute_dtype="bfloat16",
        batch_size=BATCH, device="cuda")
    res = artifact_vs_live(path, live, "K3")
    ok = fa._SAFE_SOFTMAX and res["launches_ok"] and \
        res["equal"] == EXPORT_IMAGES
    print(json.dumps({"safe": fa._SAFE_SOFTMAX, "launches": res["launches"],
                      "forwards": res["forwards"], "equal": res["equal"],
                      "bytes": res["bytes"], "ok": ok}), flush=True)
    return 0 if ok else 1


# phase 22's artifacts, each exported by a child process of its own
# (`--export`), started with phase 21 so that their tracing overlaps it
INT8_ARTIFACTS = (("int8_bf16", "bfloat16", "int8"),
                  ("int8_f32", "float32", "int8"),
                  ("float_f32", "float32", "none"))


def export_child(path: str, dtype: str, quantize: str) -> int:
    """`chip_smoke.py --export <dir> <dtype> <int8|none>`, started by
    `start_int8_exports` for phase `int8`: one serving artifact of the
    seeded ADE model (c_out 150, 128x128, batch 8) on the card; prints its
    export seconds and bytes."""
    t0 = time.monotonic()
    export_lib.export_serving_artifact(
        "ade_semantic", NUM_CLASSES, None, "best", path, compute_dtype=dtype,
        batch_size=BATCH, device="cuda",
        quantize=None if quantize == "none" else quantize)
    print(json.dumps({"export_s": time.monotonic() - t0, "bytes":
                      os.path.getsize(os.path.join(
                          path, export_lib.MODULE_NAME))}), flush=True)
    return 0


def start_int8_exports(work: str) -> dict:
    """The children that export phase 22's three artifacts into `work`:
    {name: (path, Popen)}."""
    out = {}
    for name, dtype, quantize in INT8_ARTIFACTS:
        path = os.path.join(work, f"artifact_{name}")
        out[name] = (path, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--export", path,
             dtype, quantize], cwd=ROOT, env=subprocess_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return out


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def subprocess_env(**extra) -> dict:
    return {**os.environ, "PYTHONPATH": ROOT, **extra}


def last_json(out: str) -> dict | None:
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def serve_artifact_over_http(path: str, runner) -> dict:
    """`python -m maskunet_tpu_torch.serve --artifact <path>` in a
    subprocess: 4 PNG requests answered with the runner's maps, then a
    drained exit on SIGTERM."""
    import signal
    import urllib.request

    import cv2
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "maskunet_tpu_torch.serve", "--artifact",
         path, "--port", str(port), "--max-wait-ms", "2"],
        cwd=ROOT, env=subprocess_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    equal, health, err = 0, None, ""
    t0 = time.monotonic()
    try:
        while time.monotonic() - t0 < 240 and proc.poll() is None:
            try:
                with urllib.request.urlopen(url + "/healthz",
                                            timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                time.sleep(0.5)
        ready_s = time.monotonic() - t0
        images = export_images(seed=21)[:4]
        for img in images if health else []:
            ok, png = cv2.imencode(".png", img[..., ::-1])   # RGB as BGR
            req = urllib.request.Request(url + "/predict?format=raw",
                                         data=png.tobytes(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                got = np.frombuffer(r.read(), np.uint8).reshape(IMG, IMG)
            want = runner(np.stack([img] * BATCH))[0].cpu().numpy()
            equal += int(np.array_equal(got, want))
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            out, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    stopped = last_json(out) or {}
    return {"health": health, "ready_s": ready_s, "requests": 4,
            "equal": equal, "returncode": proc.returncode,
            "stopped": stopped, "stderr_tail": err[-400:]}


def phase_export(card: str, work: str) -> dict:
    """Serving artifacts on the card (phase 21): the ADE model (c_out 150,
    128x128, batch 8, bf16, the recipe's seeded init) exported and loaded
    back: over 16 images its maps equal the live runner's exactly, K1
    launches 6 times a forward through the operator (counters zeroed
    before); the artifact's bytes, and its ms a batch against the live
    runner's. In a subprocess with MASKUNET_SAFE_SOFTMAX=1 the same for a
    safe artifact (K3 6 a forward, equal to the safe live runner); in
    another, `serve --artifact` answers 4 HTTP requests with the
    runner's maps and drains on SIGTERM."""
    safe_proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--safe-export", work],
        cwd=ROOT, env=subprocess_env(MASKUNET_SAFE_SOFTMAX="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    path = os.path.join(work, "artifact_bf16")
    t0 = time.monotonic()
    export_lib.export_serving_artifact(
        "ade_semantic", NUM_CLASSES, None, "best", path,
        compute_dtype="bfloat16", batch_size=BATCH, device="cuda")
    export_s = time.monotonic() - t0
    live, _ = serve.build_model_runner(
        "ade_semantic", NUM_CLASSES, None, compute_dtype="bfloat16",
        batch_size=BATCH, device="cuda")
    res = artifact_vs_live(path, live, "K1")
    check(res["launches_ok"], f"export: K1 6 launches a forward of the "
          f"artifact, no other kernel: {res['launches']}")
    check(res["equal"] == EXPORT_IMAGES, f"export: the artifact's maps "
          f"equal the live runner's: {res['equal']}/{EXPORT_IMAGES}")
    check(res["meta"]["platforms"] == ["cuda"]
          and res["meta"]["input_shape"] == [BATCH, IMG, IMG, 3],
          f"export: meta {res['meta']}")
    http = serve_artifact_over_http(path, res["runner"])
    check(http["health"] == {"status": "ok", "img_size": IMG,
                             "num_classes": NUM_CLASSES}
          and http["equal"] == 4 and http["returncode"] == 0
          and http["stopped"].get("drained") is True,
          f"export: serve --artifact answers 4 requests with the runner's "
          f"maps and drains: {http}")
    images = export_images()[:BATCH]
    times = in_turns({"live": lambda: live(images),
                      "artifact": lambda: res["runner"](images)})
    try:
        out, err = safe_proc.communicate(timeout=400)
    except subprocess.TimeoutExpired:
        safe_proc.kill()
        out, err = safe_proc.communicate()
    safe = last_json(out) or {}
    zeros = dict.fromkeys(counted_wrappers(), 0)
    check(safe_proc.returncode == 0 and safe.get("ok") is True
          and safe.get("safe") is True
          and safe.get("launches") == {**zeros, "K3": 6 * safe["forwards"]},
          f"export: the safe artifact launches K3 6 times a forward and "
          f"equals the safe live runner: {safe} {err[-600:]}")
    emit(phase="export", card=card, batch=BATCH, images=EXPORT_IMAGES,
         export_s=export_s, load_s=res["load_s"], bytes=res["bytes"],
         launches=res["launches"], forwards=res["forwards"],
         maps_equal_live=res["equal"], meta=res["meta"],
         ms_per_batch={k: {m: mean_ms(v[m]) for m in v}
                       for k, v in times.items()},
         turns=times, safe=safe, http=http)
    return {"K1": res["launches"]["K1"], "K3": safe.get("launches",
                                                        {}).get("K3", 0),
            "bytes": res["bytes"], "live": live}


def phase_int8(card: str, exports: dict, calib_dir: str, live_bf16,
               bf16_bytes: int) -> dict:
    """int8 serving on the card (phase 22), the ADE model at c_out 150,
    128x128, batch 8, bf16: dynamic scales, and static ones calibrated on
    the fake ADE images of `recipes` (16). On those images each agrees
    with the bf16 runner's argmax above INT8_AGREE; an image's map is the
    same with bright and with dark batch-mates (exact); no float
    conv runs (the conv recorder sees none) and K1 launches 6 times a
    forward; the int8 artifact (bf16, dynamic) agrees with the live int8
    runner above INT8_ARTIFACT_AGREE, and the int8 artifact exported in
    f32 is under INT8_BYTES of the float one in f32 (JAX's bound); the
    bf16 ratio is printed. ms a batch int8 against bf16, printed. The
    three artifacts come from `exports` (`start_int8_exports`), whose
    children must have exported each one."""
    ds = predict._DirectoryDataset(calib_dir, IMG)
    images = np.stack([ds[i]["image"] for i in range(len(ds))])
    batches = [images[i:i + BATCH] for i in range(0, len(images), BATCH)]
    kw = dict(compute_dtype="bfloat16", batch_size=BATCH, device="cuda")
    dynamic, _ = serve.build_model_runner("ade_semantic", NUM_CLASSES, None,
                                          quantize="int8", **kw)
    calibrated, _ = serve.build_model_runner(
        "ade_semantic", NUM_CLASSES, None, quantize="int8",
        calibrate_images=calib_dir, **kw)
    float_convs = []
    for runner in (dynamic, calibrated):                 # warm-up
        runner(batches[0])
    torch.cuda.synchronize()
    zero_launches()
    with layers.recording_conv_inputs(lambda w, x: float_convs.append(
            tuple(w.shape))):
        maps = {"dynamic": [dynamic(b) for b in batches],
                "calibrated": [calibrated(b) for b in batches]}
        torch.cuda.synchronize()
    launches = kernel_launches()
    want = [live_bf16(b) for b in batches]
    agree = {k: float(np.mean([float((g == w).float().mean())
                               for g, w in zip(v, want)]))
             for k, v in maps.items()}
    zeros = dict.fromkeys(counted_wrappers(), 0)
    check(not float_convs, f"int8: no float conv ran: {float_convs[:3]}")
    check(launches == {**zeros, "K1": 6 * 2 * len(batches)},
          f"int8: K1 6 launches a forward: {launches}")
    check(all(a > INT8_AGREE for a in agree.values()),
          f"int8: argmax agreement with bf16 above {INT8_AGREE}: {agree}")
    img = images[0]
    bright = np.full_like(img, 255)
    dark = np.zeros_like(img)
    invariant = {}
    for name, runner in (("dynamic", dynamic), ("calibrated", calibrated)):
        a = runner(np.stack([img] + [bright] * (BATCH - 1)))[0]
        b = runner(np.stack([img] + [dark] * (BATCH - 1)))[0]
        invariant[name] = bool(torch.equal(a, b))
    check(all(invariant.values()), f"int8: an image's map does not depend "
          f"on its batch-mates: {invariant}")

    art = {}
    t0 = time.monotonic()
    for name, r in finish({n: p for n, (_, p) in exports.items()}).items():
        line = last_json(r[1]) or {}
        check(r[0] == 0 and "bytes" in line,
              f"int8: the {name} artifact exported: rc {r[0]} {r[2][-600:]}")
        art[name] = {"path": exports[name][0], "bytes": line.get("bytes", 1),
                     "export_s": line.get("export_s")}
    export_wait_s = time.monotonic() - t0
    res = artifact_vs_live(art["int8_bf16"]["path"], dynamic, "K1")
    art_agree = float(np.mean([float((g == w).float().mean())
                               for g, w in zip(res["got"], res["want"])]))
    check(res["launches_ok"], f"int8: the int8 artifact launches K1 6 "
          f"times a forward: {res['launches']}")
    check(art_agree > INT8_ARTIFACT_AGREE, f"int8: the int8 artifact "
          f"agrees with the live int8 runner: {art_agree}")
    ratio_f32 = art["int8_f32"]["bytes"] / art["float_f32"]["bytes"]
    ratio_bf16 = art["int8_bf16"]["bytes"] / bf16_bytes
    check(ratio_f32 < INT8_BYTES, f"int8: the int8 artifact under "
          f"{INT8_BYTES} of the float one (f32): {ratio_f32}")
    times = in_turns({"bf16": lambda: live_bf16(batches[0]),
                      "int8": lambda: dynamic(batches[0])})
    emit(phase="int8", card=card, batch=BATCH, images=len(images),
         launches=launches, float_convs=len(float_convs),
         argmax_agreement_with_bf16=agree, agree_limit=INT8_AGREE,
         batch_composition_invariant=invariant,
         artifact_launches=res["launches"],
         artifact_agreement_with_live=art_agree,
         artifact_maps_equal_live=res["equal"],
         artifact_bytes={k: v["bytes"] for k, v in art.items()},
         bf16_artifact_bytes=bf16_bytes, bytes_ratio_f32=ratio_f32,
         bytes_ratio_vs_bf16=ratio_bf16,
         export_s={k: v["export_s"] for k, v in art.items()},
         export_wait_s=export_wait_s,
         ms_per_batch={k: {m: mean_ms(v[m]) for m in v}
                       for k, v in times.items()}, turns=times)
    return {"K1": launches["K1"] + res["launches"]["K1"]}


CLI_KEYS = {
    "train": {"recipe", "best_loss", "best_iou", "images_per_sec"},
    "predict": {"written", "out"},
    "export": {"exported", "bytes"},
    "import-torch": {"imported", "checkpoint", "attn_output_layout",
                     "ignored_keys"},
}


def start_cli(*argv) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "maskunet_tpu_torch.cli", *argv], cwd=ROOT,
        env=subprocess_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def finish(procs: dict, timeout: float = 600) -> dict:
    """Waits for every process of {name: Popen}; {name: (returncode,
    stdout, stderr, seconds since the stage began)}."""
    t0 = time.monotonic()
    out = {}
    for name, proc in procs.items():
        try:
            o, e = proc.communicate(timeout=max(1.0, timeout - (
                time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            o, e = proc.communicate()
        out[name] = (proc.returncode, o, e, time.monotonic() - t0)
    return out


def phase_cli(card: str, roots: dict, work: str,
              matplotlib: str | None, beside=None) -> None:
    """The command line on the card (phase 23), each command a subprocess
    of `python -m maskunet_tpu_torch.cli` on the fake layouts of
    `recipes`, in two stages of parallel processes: `recipes`, `train`
    (ade_semantic, 4 steps; city_instance, 2 steps) and `visualize` (no
    matplotlib on the card's host: it must fail naming it); then
    `evaluate` (ade_semantic; city_instance with `--mode instances`),
    `predict`, `export --quantize int8`, and beside them `import-torch`
    of a `module.`-prefixed .pth this script writes with `torch.save`
    from the trained ade_semantic state followed by `evaluate` of the
    imported workdir, equal to that of the source state. Each JSON line
    is parsed and its keys checked. `stage_seconds`: stage A, stage B's
    parallel processes, and how long the import chain outlasted them.
    `beside()` runs in this process while stage B's processes run."""
    ade, city = roots["ade20k"], roots["cityscapes"]
    w_ade, w_city = os.path.join(work, "ade"), os.path.join(work, "city")
    common = ("--data-root", ade, "--recipe", "ade_semantic")
    t0 = time.monotonic()
    a = finish({
        "recipes": start_cli("recipes"),
        "train": start_cli("train", *common, "--workdir", w_ade,
                           "--max-steps", "4", "--log-every", "0"),
        "train_city": start_cli("train", "--recipe", "city_instance",
                                "--data-root", city, "--workdir", w_city,
                                "--max-steps", "2", "--log-every", "0"),
        "visualize": start_cli("visualize", *common, "--workdir",
                               os.path.join(work, "viz_w"), "--out",
                               os.path.join(work, "viz")),
        # cli_parallel: one NCCL rank; the pipeline on a one-card host
        "train_n1": start_cli("train", *common, "--workdir",
                              os.path.join(work, "ade_n1"), "--max-steps",
                              "2", "--log-every", "0", "--n-data", "1"),
        "train_pipeline": start_cli("train", *common, "--workdir",
                                    os.path.join(work, "ade_pp"),
                                    "--max-steps", "1", "--pipeline", "2")})
    stage_a = time.monotonic() - t0
    results = {name: (r[0], last_json(r[1])) for name, r in a.items()}
    lines = a["recipes"][1].splitlines()
    check(a["recipes"][0] == 0 and len(lines) == 11
          and lines[0].startswith("ade_instance"),
          f"cli recipes: {a['recipes'][1][:200]} {a['recipes'][2][-300:]}")
    for name in ("train", "train_city", "train_n1"):
        rc, out, err, _ = a[name]
        line = last_json(out) or {}
        check(rc == 0 and set(line) == CLI_KEYS["train"]
              and math.isfinite(line["best_loss"]),
              f"cli {name}: {line} {err[-600:]}")
    rc, out, err, _ = a["train_pipeline"]
    pipe_err = err.strip().splitlines()
    check(rc == 2 and len(pipe_err) == 1 and pipe_err[0].startswith(
              "error: --pipeline 2: pipeline mesh needs exactly 2 devices, "
              f"got {torch.cuda.device_count()}"),
          f"cli train --pipeline 2 on a one-card host: exit 2, one line: "
          f"{rc} {pipe_err}")
    rc, out, err, _ = a["visualize"]
    if matplotlib is None:
        check(rc != 0 and "matplotlib" in err,
              f"cli visualize: fails naming matplotlib: {rc} {err[-300:]}")
    else:
        check(rc == 0 and len((last_json(out) or {}).get("saved", [])) == 2,
              f"cli visualize: {out[-300:]} {err[-300:]}")

    # the trained state as a reference .pth, DataParallel-prefixed
    rec = recipes.get("ade_semantic")
    classes = make_datasets(rec, ade)[2]
    ts = ckpt_lib.restore_inference(
        os.path.join(w_ade, f"{rec.checkpoint_name}_latest.msgpack"),
        train_loop.setup_state(rec, train_loop.model_config(rec, classes),
                               train_loop.make_optimizer(rec),
                               device="cuda"))
    sd = torch_import.export_state_dict(ts.params, ts.model_state)
    pth = os.path.join(work, "reference.pth")
    torch.save({f"module.{k}": v for k, v in sd.items()}, pth)
    del ts
    w_imp = os.path.join(work, "imported")

    def imported():
        """import-torch, then the evaluation of its workdir (stage B's
        longest process outlasts the two in turn)."""
        got = finish({"import-torch": start_cli(
            "import-torch", *common, "--workdir", w_imp,
            "--torch-checkpoint", pth)})
        return {**got, **finish({"evaluate_imported": start_cli(
            "evaluate", *common, "--workdir", w_imp)})}

    t0 = time.monotonic()
    with ThreadPoolExecutor(1) as pool:
        chain = pool.submit(imported)
        procs = {
        "evaluate": start_cli("evaluate", *common, "--workdir", w_ade,
                              "--tag", "latest", "--attn-output-layout",
                              "literal_view"),
        "evaluate_instances": start_cli(
            "evaluate", "--recipe", "city_instance", "--data-root", city,
            "--workdir", w_city, "--tag", "latest", "--mode", "instances",
            "--max-batches", "1"),
        "predict": start_cli("predict", *common, "--workdir", w_ade, "--tag",
                             "latest", "--images",
                             os.path.join(ade, "images", "validation"),
                             "--out", os.path.join(work, "pred")),
        "export": start_cli("export", *common, "--workdir", w_ade, "--tag",
                            "latest", "--out", os.path.join(work, "art8"),
                            "--quantize", "int8"),
        "evaluate_n1": start_cli("evaluate", *common, "--workdir", w_ade,
                                 "--tag", "latest", "--attn-output-layout",
                                 "literal_view", "--n-data", "1")}
        try:
            if beside is not None:
                beside()
        finally:
            b = finish(procs)
        stage_b = time.monotonic() - t0
        c = chain.result()
    stage_c = time.monotonic() - t0 - stage_b
    for name, r in {**b, **c}.items():
        results[name] = (r[0], last_json(r[1]))
        check(r[0] == 0 and results[name][1] is not None,
              f"cli {name}: rc {r[0]} {r[1][-300:]} {r[2][-600:]}")
    line = lambda name: results[name][1] or {}
    for name in ("predict", "export", "import-torch"):
        check(set(line(name)) == CLI_KEYS[name],
              f"cli {name}: the JSON keys of JAX's CLI: {line(name)}")
    source, imported = line("evaluate"), line("evaluate_imported")
    check({"recipe", "loss", "miou"} <= set(source)
          and all(math.isfinite(v) for k, v in source.items()
                  if k != "recipe"),
          f"cli evaluate: {source}")
    check(imported == source, f"cli evaluate of the imported .pth equals "
          f"the source state's: {imported} vs {source}")
    n1 = line("evaluate_n1")
    check(set(n1) == set(source) and all(
        abs(n1[k] - v) <= 1e-5 * abs(v) for k, v in source.items()
        if k != "recipe"),
          f"cli evaluate --n-data 1 (one NCCL rank) equals evaluate: "
          f"{n1} vs {source}")
    inst = line("evaluate_instances").get("instances", {})
    check(sorted(inst, key=int) == [str(q) for q in
                                    recipes.get("city_instance")
                                    .eval_max_queries]
          and all(math.isfinite(v["AP"]) for v in inst.values()),
          f"cli evaluate --mode instances: {line('evaluate_instances')}")
    check(line("predict").get("written") == FAKE_VAL,
          f"cli predict: {line('predict')}")
    art = os.path.join(work, "art8", export_lib.MODULE_NAME)
    check(os.path.exists(art)
          and line("export").get("bytes") == os.path.getsize(art),
          f"cli export: {line('export')}")
    check(line("import-torch").get("attn_output_layout") == "literal_view"
          and line("import-torch").get("ignored_keys") == sum(
              k.endswith("num_batches_tracked") for k in sd),
          f"cli import-torch: {line('import-torch')}")
    emit(phase="cli", card=card, stage_seconds=[stage_a, stage_b, stage_c],
         returncodes={n: r[0] for n, r in results.items()},
         lines={n: r[1] for n, r in results.items()},
         visualize_error=a["visualize"][2][-200:] if matplotlib is None
         else None)


# --- data parallelism and the pipeline (phases 24-28) ----------------------

DP_RANKS = 2                  # two ranks share cuda:0 (gloo)
DP_STEPS = 2
DP_STATE_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
PIPE_MICRO = 2                # microbatches of BATCH // PIPE_MICRO rows
PIPE_TIMED_STEPS = 2
DP_DEADLINE_S = 600.0


class SGD:
    """An optimizer factory as `train.loop.AdamW`: plain SGD, whose update
    is the gradient itself, so updated params compare as gradients do
    (tests/test_sharding.py compares DP and one device so)."""
    schedule = None

    def __call__(self, params):
        return torch.optim.SGD(params, lr=0.1)

    def scheduler(self, optimizer):
        return None


def spawn_ranks(target, n: int, *args, backend: str = "gloo") -> list:
    """`target(rank, *args)` in n spawned processes, ranks of a process
    group met at a local port; their results in rank order. A rank that
    fails, or misses the deadline, fails the phase (the others are
    killed)."""
    import queue
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=rank_entry, args=(target, r, n, port,
                                                   backend, q, args))
             for r in range(n)]
    for p in procs:
        p.start()
    end = time.monotonic() + DP_DEADLINE_S
    results, errors = {}, []
    try:
        for _ in range(n):
            rank, err, out = q.get(timeout=max(1.0, end - time.monotonic()))
            if err is not None:
                errors.append(f"rank {rank}: {err}")
            else:
                results[rank] = out
    except queue.Empty:
        errors.append(f"ranks missed the {DP_DEADLINE_S:.0f} s deadline")
    finally:
        for p in procs:
            p.join(timeout=max(1.0, end - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(10)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(n)]


def rank_entry(target, rank, n, port, backend, q, args) -> None:
    import datetime
    import traceback

    import torch.distributed as dist

    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    try:
        mesh_lib.init_distributed(f"127.0.0.1:{port}", n, rank, backend,
                                  timeout=datetime.timedelta(seconds=300))
        q.put((rank, None, target(rank, *args)))
    except BaseException:  # noqa: BLE001 — reported by the parent
        q.put((rank, traceback.format_exc()[-3000:], None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def dp_setup(dtype: str, device="cuda"):
    """The ADE model (c_out 150, 128x128) at `dtype`, its seeded state with
    SGD and the recipe's cached masks for the global batch of 8, and one
    fixed global batch."""
    recipe = recipes.get("ade_semantic")
    cfg = train_loop.model_config(recipe, NUM_CLASSES, compute_dtype=dtype)
    ts = train_loop.setup_state(recipe, cfg, SGD(), batch_size=BATCH,
                                device=device)
    rng = np.random.default_rng(0)
    batch = {"image": rng.standard_normal((BATCH, IMG, IMG, 3)).astype(
                 np.float32),
             "label": rng.integers(0, NUM_CLASSES, (BATCH, IMG, IMG))}
    return cfg, ts, batch


def snapshot(ts) -> dict:
    return {k: v.detach().clone() for k, v in ts.params.items()}


def update_of(ts, before: dict) -> dict:
    return {k: (v.detach() - before[k]).double().flatten()
            for k, v in ts.params.items() if not exact_zero_grad(k)}


def step_once(step, ts, batch) -> tuple:
    """One step, counters zeroed just before it: (ts, metrics, launches,
    wall ms)."""
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    ts, metrics = step(ts, batch)
    torch.cuda.synchronize()
    return ts, metrics, kernel_launches(), (time.perf_counter() - t0) * 1e3


def profiled_device_ms(fn) -> float | str:
    """The device's kernel time of one call of `fn`, by the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_kernel_rows(prof)
    return sum(r[0] for r in rows) / 1e3 if rows else "not measured"


def compare_updates(got: dict, want: dict) -> tuple:
    """(least per-tensor cosine, its tensor) of two updates."""
    coss = {k: cos(got[k], want[k]) for k in want}
    worst = min(coss, key=coss.get)
    return coss[worst], worst


def state_rel_diff(a: dict, b: dict) -> float:
    """Largest difference of two states' running stats, relative to each
    tensor's largest magnitude where that exceeds 1: absolute for running
    means that are rounding noise about 0 (the input of a BatchNorm that
    follows another has zero channel means in exact arithmetic)."""
    return max(float((a[k] - b[k]).abs().max()
                     / b[k].abs().max().clamp(min=1.0)) for k in b)


def dp_train_rank(rank: int, refs: dict) -> dict:
    """Phase dp_train, one rank: the DP step on its 4 rows of the global
    batch of 8, f32 once, then bf16 DP_STEPS times and once profiled, and
    a DP eval step. Rank 0 also runs the one-process step on the global
    batch and compares: loss, mIoU, the per-tensor cosine of the SGD
    updates (f32), the bf16 rule of `step_grads` against the f32
    one-process update, and the BN running stats; it keeps the
    one-process steps in `refs` (phase tp compares with them too)."""
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(DP_RANKS, devices=["cuda:0"] * DP_RANKS)
    task = train_step.TaskConfig()
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg, ts, batch = dp_setup(dtype)
        mesh_lib.put_replicated(mesh, ts)
        plans = mu.precompute_mask_plans(ts.masks)
        step = train_step.make_train_step(cfg, task, mask_plans=plans,
                                          device="cuda:0", mesh=mesh)
        r, update, state = timed_steps(step, ts, batch, dtype)
        eval_step = train_step.make_eval_step(cfg, task, device="cuda:0",
                                              mesh=mesh)
        zero_launches()
        result = eval_step(ts, batch, plans)
        torch.cuda.synchronize()
        r.update(eval_launches=kernel_launches(),
                 eval_pred_rows=int(result["pred"].shape[0]))
        if rank == 0:
            cfg, ref, batch = dp_setup(dtype)
            ref_before = snapshot(ref)
            ref_step = train_step.make_train_step(
                cfg, task, mask_plans=mu.precompute_mask_plans(ref.masks),
                device="cuda:0")
            ref, m = ref_step(ref, batch)
            refs[dtype] = {"loss": float(m["loss"]),
                           "miou": float(m["miou"]),
                           "update": update_of(ref, ref_before),
                           "state": ref.model_state}
            r.update(compare_to_one_process(update, state, refs, dtype))
            del ref
        out[dtype] = r
        del ts, update
    return out


def timed_steps(step, ts, batch, dtype: str) -> tuple:
    """One f32 step, or DP_STEPS bf16 steps and a profiled one: (their
    losses, mIoUs, launches and walls, the first update, the state after
    it)."""
    before = snapshot(ts)
    runs = []
    for i in range(1 if dtype == "float32" else DP_STEPS):
        ts, metrics, launches, wall = step_once(step, ts, batch)
        runs.append((float(metrics["loss"]), float(metrics["miou"]),
                     launches, wall))
        if i == 0:
            update = update_of(ts, before)
            state = {k: v.clone() for k, v in ts.model_state.items()}
    r = {"losses": [x[0] for x in runs], "mious": [x[1] for x in runs],
         "launches": [x[2] for x in runs], "wall_ms": [x[3] for x in runs]}
    if dtype == "bfloat16":
        r["device_ms"] = profiled_device_ms(lambda: step(ts, batch))
    return r, update, state


def compare_to_one_process(update: dict, state: dict, refs: dict,
                           dtype: str) -> dict:
    """A step's first update and running stats against the one-process
    step's in `refs`: f32 the least per-tensor cosine of the updates, bf16
    the worst margin of `step_grads`' rule against the f32 one-process
    update."""
    ref = refs[dtype]
    r = {"ref_loss": ref["loss"], "ref_miou": ref["miou"],
         "state_rel_diff": state_rel_diff(state, ref["state"])}
    if dtype == "float32":
        r["update_min_cos"], r["update_min_cos_tensor"] = \
            compare_updates(update, ref["update"])
    else:
        truth = refs["float32"]["update"]
        signal = {k for k in truth
                  if cos(ref["update"][k], truth[k]) >= BF16_SIGNAL_COS}
        margin = {k: cos(update[k], truth[k])
                  - cos(ref["update"][k], truth[k]) for k in signal}
        worst = min(margin, key=margin.get)
        r.update(bf16_signal_tensors=len(signal),
                 bf16_worst_margin=margin[worst],
                 bf16_worst_margin_tensor=worst)
    return r


def parallel_rank(rank: int) -> dict:
    """One rank of the spawn of DP_RANKS gloo ranks sharing cuda:0 that
    phases dp_train, pipeline (its dp x pp step), tp and ring share (one
    spawn: one CUDA init and one library load a rank), each part on a
    mesh of its own, timed."""
    refs, out = {}, {}
    parts = (("dp_train", lambda: dp_train_rank(rank, refs)),
             ("dp_pp", lambda: dp_pp_rank(rank)),
             ("tp", lambda: tp_rank(rank, refs)),
             ("ring", lambda: ring_rank(rank)))
    for name, fn in parts:
        t0 = time.monotonic()
        out[name] = fn()
        torch.cuda.empty_cache()
        out[name]["seconds"] = time.monotonic() - t0
    return out


def check_dp_like(phase: str, r0: dict, r1: dict,
                  want_eval_rows: int) -> None:
    """dp_train's checks of a parallel step against the one-process step,
    for each dtype: K2 6 and K4 6 a rank a step, K1 6 a rank an eval
    step on its rows, the ranks' losses equal and finite, loss and mIoU
    within TRAIN_LOSS_RTOL, the BN stats within DP_STATE_RTOL; the f32
    update's least cosine, the bf16 rule's worst margin."""
    want = dict.fromkeys(counted_wrappers(), 0)
    for dtype in ("float32", "bfloat16"):
        a, b = r0[dtype], r1[dtype]
        check(all(l == {**want, "K2": 6, "K4": 6}
                  for r in (a, b) for l in r["launches"]),
              f"{phase} {dtype}: a step of each rank launches K2 6, K4 6: "
              f"{a['launches']} {b['launches']}")
        check(all(r["eval_launches"] == {**want, "K1": 6}
                  and r["eval_pred_rows"] == want_eval_rows
                  for r in (a, b)),
              f"{phase} {dtype}: an eval step launches K1 6 a rank on its "
              f"{want_eval_rows} rows: {a['eval_launches']}")
        check(a["losses"] == b["losses"] and all(np.isfinite(a["losses"])),
              f"{phase} {dtype}: the ranks' losses agree: {a['losses']} "
              f"{b['losses']}")
        check(abs(a["losses"][0] - a["ref_loss"])
              <= TRAIN_LOSS_RTOL * abs(a["ref_loss"])
              and abs(a["mious"][0] - a["ref_miou"])
              <= TRAIN_LOSS_RTOL * abs(a["ref_miou"]),
              f"{phase} {dtype}: loss and mIoU of the one-process step "
              f"({a['losses'][0]} vs {a['ref_loss']}, {a['mious'][0]} vs "
              f"{a['ref_miou']})")
        check(a["state_rel_diff"] <= DP_STATE_RTOL[dtype],
              f"{phase} {dtype}: BN running stats of the one-process step "
              f"({a['state_rel_diff']})")
    check(r0["float32"]["update_min_cos"] >= TRAIN_GRAD_COS,
          f"{phase}: f32 SGD updates, per tensor, against one process: "
          f"{r0['float32']['update_min_cos']}")
    check(r0["bfloat16"]["bf16_worst_margin"] >= -BF16_COS_MARGIN,
          f"{phase}: bf16 updates as close to the f32 one-process update "
          f"as the bf16 one-process update")


def phase_dp_train(card: str) -> tuple:
    """Phase 24, dp_train: two gloo ranks on the one card, each on 4 rows
    of the global batch of 8 (c_out 150, 128x128), against the one-process
    step on the same global batch and state. The spawn runs the parts of
    phases pipeline, tp and ring too (`parallel_rank`); returns (K1, K2,
    K4 launches, the ranks' results)."""
    t0 = time.monotonic()
    parallel = spawn_ranks(parallel_rank, DP_RANKS)
    r0, r1 = (r["dp_train"] for r in parallel)
    check_dp_like("dp_train", r0, r1, BATCH // DP_RANKS)
    emit(phase="dp_train", card=card, ranks=DP_RANKS, global_batch=BATCH,
         seconds=r0["seconds"], spawn_seconds=time.monotonic() - t0,
         part_seconds={k: [r[k]["seconds"] for r in parallel]
                       for k in parallel[0]},
         rank0=r0, rank1=r1,
         note="two ranks share one card's SMs: their img/s says nothing "
              "of DP on two cards")
    return ({"K2": r0["bfloat16"]["launches"][0]["K2"],
             "K4": r0["bfloat16"]["launches"][0]["K4"],
             "K1": r0["bfloat16"]["eval_launches"]["K1"]}, parallel)


def dp_nccl_rank(rank: int) -> dict:
    """Phase dp_nccl: the DP step on `make_mesh(n_data=1)` in a one-rank
    NCCL group against the step with no mesh (f32)."""
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(n_data=1)
    task = train_step.TaskConfig()
    got = []
    for m in (mesh, None):
        cfg, ts, batch = dp_setup("float32")
        mesh_lib.put_replicated(m, ts)
        before = snapshot(ts)
        step = train_step.make_train_step(
            cfg, task, mask_plans=mu.precompute_mask_plans(ts.masks),
            device="cuda:0", mesh=m)
        ts, metrics, launches, wall = step_once(step, ts, batch)
        got.append((float(metrics["loss"]), float(metrics["miou"]),
                    snapshot(ts), before, launches, wall))
    (l1, i1, p1, b1, n1, w1), (l2, i2, p2, _, _, w2) = got
    import torch.distributed as dist
    return {"backend": dist.get_backend(), "device": str(mesh.device),
            "loss": [l1, l2], "miou": [i1, i2], "launches": n1,
            "wall_ms": [w1, w2],
            "params_max_abs_diff": max(float((p1[k] - p2[k]).abs().max())
                                       for k in p1)}


def phase_dp_nccl(card: str) -> None:
    """Phase 25, dp_nccl: NCCL's init and collectives on the card, one
    rank (NCCL refuses two ranks on one GPU): this process, in a group of
    its own that it destroys after."""
    import datetime

    import torch.distributed as dist

    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    mesh_lib.init_distributed(f"127.0.0.1:{free_port()}", 1, 0, "nccl",
                              timeout=datetime.timedelta(seconds=300))
    try:
        r = dp_nccl_rank(0)
    finally:
        dist.destroy_process_group()
    want = dict.fromkeys(counted_wrappers(), 0)
    emit(phase="dp_nccl", card=card, **r)
    check(r["backend"] == "nccl" and r["device"] == "cuda:0",
          f"dp_nccl: an NCCL group on cuda:0: {r['backend']} {r['device']}")
    check(abs(r["loss"][0] - r["loss"][1]) <= 1e-5 * abs(r["loss"][1])
          and abs(r["miou"][0] - r["miou"][1]) <= 1e-5 * abs(r["miou"][1])
          and r["params_max_abs_diff"] <= 1e-5,
          f"dp_nccl: the one-rank NCCL step equals the step with no mesh: "
          f"{r['loss']} {r['miou']} {r['params_max_abs_diff']}")
    check(r["launches"] == {**want, "K2": 6, "K4": 6},
          f"dp_nccl: K2 6, K4 6: {r['launches']}")


def sequential_update(ts, batch, cfg, task, n_micro: int, rows=None):
    """The reference of the pipelined step: `apply` on each microbatch in
    order (running stats threaded through, keep masks drawn as the forward
    draws), one loss over all outputs, one SGD update. `rows`: compare one
    rank's rows of each microbatch only (dp x pp): the loss is over the
    global batch all the same. Returns (ts, new state, loss)."""
    x = torch.from_numpy(batch["image"]).cuda()
    labels = torch.from_numpy(batch["label"]).cuda()
    state, outs = ts.model_state, []
    for m in x.reshape(n_micro, -1, *x.shape[1:]):
        out, new = mu.apply(ts.params, state, m, cfg=cfg, masks=ts.masks,
                            train=True, dropout_generator=ts.generator)
        state = {**state, **new}
        outs.append(out.semantic)
    sem = torch.cat(outs)
    loss, _ = train_step._compute_loss(mu.ModelOutput(sem),
                                       {"label": labels}, task, None)
    keys = list(ts.params)
    grads = torch.autograd.grad(loss, [ts.params[k] for k in keys],
                                allow_unused=True)
    with torch.no_grad():
        for k, g in zip(keys, grads):
            if g is not None:
                ts.params[k] -= 0.1 * g
    return ts, state, float(loss.detach())


def stream_overlap(path: str) -> dict:
    """Kernel time a stream, and the time the two stage streams (the two
    busiest: they run every forward and backward kernel) ran kernels at
    once, from a chrome trace."""
    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("cat") == "kernel"]
    by = {}
    for e in events:
        by.setdefault(e["args"].get("stream"), []).append(
            (e["ts"], e["ts"] + e["dur"]))
    busy = {s: sum(b - a for a, b in v) / 1e3 for s, v in by.items()}
    stages = sorted(by, key=busy.get, reverse=True)[:2]
    overlap = 0.0
    if len(stages) == 2:
        for a0, a1 in by[stages[0]]:
            for b0, b1 in by[stages[1]]:
                overlap += max(0.0, min(a1, b1) - max(a0, b0))
    return {"stream_busy_ms": {str(s): busy[s] for s in by},
            "stage_streams": [str(s) for s in stages],
            "overlap_ms": overlap / 1e3,
            "overlap_share_of_smaller": (
                overlap / 1e3 / min(busy[s] for s in stages)
                if len(stages) == 2 else 0.0)}


def dp_pp_rank(rank: int) -> dict:
    """Phase pipeline's dp x pp step: 2 ranks x 2 microbatches of 2 rows
    (f32, SGD), both stages of both ranks on cuda:0; rank 0 also runs the
    one-process sequential loop on the global batch and compares the
    loss, the updated params and the running stats."""
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    from maskunet_tpu_torch.parallel import pipeline as pp
    mesh = pp.make_dp_pipe_mesh(DP_RANKS, devices=["cuda:0"] * 4)
    task = train_step.TaskConfig()
    cfg, ts, batch = dp_setup("float32")
    ts.masks = tuple(m[:BATCH // PIPE_MICRO] for m in ts.masks)
    mesh_lib.put_replicated(mesh.data, ts)
    before = snapshot(ts)
    step = train_step.make_train_step(
        cfg, task, mask_plans=mu.precompute_mask_plans(ts.masks),
        device="cuda:0", pipe_mesh=mesh, pipe_microbatches=PIPE_MICRO)
    ts, metrics, launches, wall = step_once(step, ts, batch)
    out = {"loss": float(metrics["loss"]), "launches": launches,
           "wall_ms": wall}
    if rank == 0:
        update = update_of(ts, before)
        cfg, ref, batch = dp_setup("float32")
        ref.masks = tuple(m[:BATCH // PIPE_MICRO] for m in ref.masks)
        ref_before = snapshot(ref)
        ref, state, loss = sequential_update(ref, batch, cfg, task,
                                             PIPE_MICRO)
        out.update(ref_loss=loss, state_rel_diff=state_rel_diff(
            ts.model_state, state))
        out["update_min_cos"], out["update_min_cos_tensor"] = \
            compare_updates(update, update_of(ref, ref_before))
    return out


def phase_pipeline(card: str, parallel: list) -> dict:
    """Phase 26, pipeline: the 2-stage GPipe with both stages on cuda:0
    (two CUDA streams, the decoder issued from a worker thread), M = 2
    microbatches of 4. `pipeline_apply`'s forward and running stats, and
    the pipelined step's update (f32, SGD), against the sequential loop;
    then the bf16 step: launches, wall and device ms, and the overlap of
    the two stage streams in a profiled step; then one dp x pp step (run
    in `parallel`, the ranks of dp_train's spawn)."""
    from maskunet_tpu_torch.parallel import pipeline as pp
    t0 = time.monotonic()
    mesh = pp.make_pipe_mesh(devices=["cuda:0", "cuda:0"])
    task = train_step.TaskConfig()
    want = dict.fromkeys(counted_wrappers(), 0)

    # forward and running stats: pipelined vs sequential, same draws
    cfg, ts, batch = dp_setup("float32")
    masks = tuple(m[:BATCH // PIPE_MICRO] for m in ts.masks)
    x = torch.from_numpy(batch["image"]).cuda()
    with torch.no_grad():
        outs = []
        for pipelined in (True, False):
            gen = torch.Generator(device="cuda").manual_seed(11)
            if pipelined:
                out, state = pp.pipeline_apply(
                    ts.params, ts.model_state,
                    pp.split_microbatches(x, PIPE_MICRO), cfg=cfg,
                    mesh=mesh, masks=masks, train=True,
                    dropout_generator=gen)
                sem = out.semantic
            else:
                sems, state = [], ts.model_state
                for m in x.reshape(PIPE_MICRO, -1, *x.shape[1:]):
                    o, new = mu.apply(ts.params, state, m, cfg=cfg,
                                      masks=masks, train=True,
                                      dropout_generator=gen)
                    state = {**state, **new}
                    sems.append(o.semantic)
                sem = torch.stack(sems)
            outs.append((sem.float(), state))
    (s1, st1), (s2, st2) = outs
    fwd_err = float((s1 - s2).abs().max() / s2.abs().max())
    fwd_state = state_rel_diff(st1, st2)

    # the pipelined step's update against the sequential one (f32, SGD)
    ts.masks = masks
    before = snapshot(ts)
    step = train_step.make_train_step(
        cfg, task, mask_plans=mu.precompute_mask_plans(masks),
        device="cuda", pipe_mesh=mesh, pipe_microbatches=PIPE_MICRO)
    ts, metrics, f32_launches, _ = step_once(step, ts, batch)
    update = update_of(ts, before)
    cfg, ref, batch = dp_setup("float32")
    ref.masks = masks
    ref_before = snapshot(ref)
    ref, ref_state, ref_loss = sequential_update(ref, batch, cfg, task,
                                                 PIPE_MICRO)
    upd_cos, upd_tensor = compare_updates(update, update_of(ref, ref_before))
    step_state = state_rel_diff(ts.model_state, ref_state)
    del ts, ref, update

    # the bf16 step: launches, times, overlap
    cfg, ts, batch = dp_setup("bfloat16")
    ts.masks = tuple(m[:BATCH // PIPE_MICRO] for m in ts.masks)
    step = train_step.make_train_step(
        cfg, task, mask_plans=mu.precompute_mask_plans(ts.masks),
        device="cuda", pipe_mesh=mesh, pipe_microbatches=PIPE_MICRO)
    ts, m, launches, _ = step_once(step, ts, batch)
    walls = []
    for _ in range(PIPE_TIMED_STEPS):
        ts, m, _, wall = step_once(step, ts, batch)
        walls.append(wall)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(ts, batch)
        torch.cuda.synchronize()
    rows = device_kernel_rows(prof)
    trace = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_pipe_"),
                         "trace.json")
    prof.export_chrome_trace(trace)
    overlap = stream_overlap(trace)
    shutil.rmtree(os.path.dirname(trace), ignore_errors=True)
    loss_bf16 = float(m["loss"])
    del ts, step

    dpp = [r["dp_pp"] for r in parallel]
    emit(phase="pipeline", card=card, microbatches=PIPE_MICRO,
         microbatch_rows=BATCH // PIPE_MICRO,
         forward_rel_err_vs_sequential=fwd_err,
         forward_state_rel_diff=fwd_state,
         f32_step_launches=f32_launches, f32_step_loss=float(metrics["loss"]),
         sequential_loss=ref_loss, update_min_cos=upd_cos,
         update_min_cos_tensor=upd_tensor, step_state_rel_diff=step_state,
         bf16_step_launches=launches, bf16_loss=loss_bf16,
         wall_ms=walls, wall_ms_best=min(walls),
         device_ms=(sum(r[0] for r in rows) / 1e3 if rows
                    else "not measured"),
         **overlap, dp_pp=dpp, seconds=time.monotonic() - t0,
         note="both stages share one card: the overlap is of two streams "
              "on its SMs, not of two cards")
    # the stages' forwards run once and again in the backward
    # (torch.utils.checkpoint's recompute): K2 2 x 6 a microbatch
    pipe_want = {**want, "K2": 2 * 6 * PIPE_MICRO, "K4": 6 * PIPE_MICRO}
    check(fwd_err <= 1e-5 and fwd_state <= 1e-5,
          f"pipeline: forward and running stats equal the sequential loop "
          f"({fwd_err}, {fwd_state})")
    check(upd_cos >= TRAIN_GRAD_COS and step_state <= 1e-5
          and abs(float(metrics["loss"]) - ref_loss) <= 1e-5 * abs(ref_loss),
          f"pipeline: the step's loss, update and state equal the "
          f"sequential loop's ({float(metrics['loss'])} vs {ref_loss}, "
          f"{upd_cos} {upd_tensor}, {step_state})")
    check(launches == pipe_want and f32_launches == pipe_want,
          f"pipeline: a step launches K2 {2 * 6 * PIPE_MICRO} (forward and "
          f"recompute), K4 {6 * PIPE_MICRO}: {launches} {f32_launches}")
    check(np.isfinite(loss_bf16), "pipeline: finite bf16 loss")
    for r in dpp:
        check(r["launches"] == pipe_want,
              f"pipeline dp x pp: a rank's step launches {pipe_want}: "
              f"{r['launches']}")
    check(dpp[0]["loss"] == dpp[1]["loss"]
          and abs(dpp[0]["loss"] - dpp[0]["ref_loss"])
          <= 1e-5 * abs(dpp[0]["ref_loss"])
          and dpp[0]["update_min_cos"] >= TRAIN_GRAD_COS
          and dpp[0]["state_rel_diff"] <= 1e-5,
          f"pipeline dp x pp: the one-process sequential loop's loss, "
          f"update and state: {dpp[0]}")
    return {"K2": launches["K2"], "K4": launches["K4"], "K1": launches["K1"]}


def phase_dp_serve(card: str) -> dict:
    """Phase 27, dp_serve: `build_model_runner` over a 2-replica mesh on
    cuda:0 (one process, 4 rows a replica) answers 16 requests through
    the batcher, K1 6 a forward a replica. Its maps equal, exactly, the
    single-device computation of each replica's rows (a single-device
    runner at 4 rows on each half) in bf16, and the single-device runner
    at 8 rows in f32 (JAX's contract, tests/test_serve.py); in bf16 the
    last row of a batch rounds otherwise than the others (ROADMAP §3),
    and the replicas have two last rows, so the bf16 maps against the
    8-row runner are held to the serving agreement bound. Each answer
    equals the DP forward of its image in one of the batch's slots.
    `serve --n-data 2` on a one-card host exits 2 with one line."""
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(2, devices=["cuda:0", "cuda:0"])
    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, (IMG, IMG, 3)).astype(np.uint8)
              for _ in range(16)]
    batches = [np.stack(images[i:i + BATCH]) for i in (0, BATCH)]
    maps = {}
    for dtype in ("float32", "bfloat16"):
        kw = dict(compute_dtype=dtype, device="cuda")
        single, _ = serve.build_model_runner(
            "ade_semantic", NUM_CLASSES, None, batch_size=BATCH, **kw)
        half, _ = serve.build_model_runner(
            "ade_semantic", NUM_CLASSES, None, batch_size=BATCH // 2, **kw)
        dp, _ = serve.build_model_runner(
            "ade_semantic", NUM_CLASSES, None, batch_size=BATCH, mesh=mesh,
            **kw)
        got = [dp(b).cpu().numpy() for b in batches]
        maps[dtype] = {
            "dp": got,
            "single": [single(b).cpu().numpy() for b in batches],
            "halves": [np.concatenate([half(b[:BATCH // 2]).cpu().numpy(),
                                       half(b[BATCH // 2:]).cpu().numpy()])
                       for b in batches]}
    stacked = batches[0]
    batcher = serve._Batcher(dp, BATCH, max_wait_ms=20.0)
    zero_launches()
    with ThreadPoolExecutor(4) as ex:
        answers = list(ex.map(batcher.predict, images))
    counts = kernel_launches()
    metrics = batcher.metrics()
    zero_launches()
    dp(stacked).cpu()
    one = kernel_launches()
    in_a_slot = sum(int(any(np.array_equal(a, row) for row in
                            dp(np.stack([img] * BATCH)).cpu().numpy()))
                    for img, a in zip(images, answers))
    wall_dp, dev_dp = wall_and_device_ms(lambda: dp(stacked))
    wall_1, dev_1 = wall_and_device_ms(lambda: single(stacked))
    proc = subprocess.run(
        [sys.executable, "-m", "maskunet_tpu_torch.serve", "--recipe",
         "ade_semantic", "--num-classes", str(NUM_CLASSES), "--n-data", "2"],
        cwd=ROOT, env=subprocess_env(), capture_output=True, text=True,
        timeout=300)
    err = proc.stderr.strip().splitlines()

    def equal(dtype, ref):
        m = maps[dtype]
        return sum(int(np.array_equal(a, b)) for a, b in zip(m["dp"], m[ref]))

    agree_bf16 = float(np.mean([(a == b).mean() for a, b in zip(
        maps["bfloat16"]["dp"], maps["bfloat16"]["single"])]))
    emit(phase="dp_serve", card=card, replicas=2, requests=16,
         forwards=metrics["batches"], launches=counts,
         launches_one_forward=one,
         f32_batches_equal_single=equal("float32", "single"),
         bf16_batches_equal_replica_rows=equal("bfloat16", "halves"),
         bf16_batches_equal_single=equal("bfloat16", "single"),
         bf16_agreement_with_single=agree_bf16,
         answers_equal_a_slot=in_a_slot, wall_ms=wall_dp, device_ms=dev_dp,
         single_wall_ms=wall_1, single_device_ms=dev_1,
         serve_n_data_2=[proc.returncode, err[-1:]],
         note="both replicas share one card")
    want_counts = dict.fromkeys(counted_wrappers(), 0)
    check(metrics["requests"] == 16 and metrics["errors"] == 0
          and in_a_slot == 16,
          f"dp_serve: 16 requests answered, each the DP forward of its "
          f"image in a slot: {metrics} {in_a_slot}")
    check(counts == {**want_counts, "K1": 12 * metrics["batches"]}
          and one == {**want_counts, "K1": 12},
          f"dp_serve: K1 6 a forward a replica: {counts}, {one}")
    check(equal("float32", "single") == 2,
          "dp_serve: f32 maps equal the single-device runner's exactly")
    check(equal("bfloat16", "halves") == 2,
          "dp_serve: bf16 maps equal each replica's rows on one device")
    check(agree_bf16 >= SERVE_ARGMAX_AGREE,
          f"dp_serve: bf16 maps against the 8-row runner: {agree_bf16}")
    check(proc.returncode == 2 and len(err) == 1
          and "--n-data 2" in err[0] and "has 1" in err[0],
          f"dp_serve: serve --n-data 2 on one card exits 2 with one line: "
          f"{proc.returncode} {err}")
    return {"K1": one["K1"]}


# --- tensor parallelism and ring attention (phases 28-29) -------------------

# ring attention at attn6's shape: 128x128 tokens at C 64, batch 8, each of
# the DP_RANKS ranks holding 8,192 tokens; gradients of a fixed weighting
# of the output, f32. The shards' gradients against the plain attention's
# (f32 sums over 2 x 16,384 tokens in another order), as a share of each
# tensor's largest magnitude: JAX's gradient tolerance
# (tests/test_ring_attention.py:61)
# TP serving in f32 against one device: the shards' convs have half the
# output channels, for which cuDNN may choose another algorithm, so an
# argmax near a tie may flip: at most 1 pixel in 10,000
TP_SERVE_AGREE = 0.9999
RING_SHAPE = (BATCH, IMG * IMG, 64)
RING_GRAD_RTOL = 5e-4
# the key projection's bias adds q . b to every score of a query, which
# the softmax cancels: its gradient is zero in exact arithmetic, so both
# paths' rounding noise is held to RING_GRAD_RTOL of the key weight's
# gradient instead
RING_ZERO_GRAD = {"key.bias": "key.weight"}


def tp_rank(rank: int, refs: dict) -> dict:
    """Phase tp, one rank: model index `rank` of a 1x2 (data, model) mesh
    on cuda:0, the whole global batch of 8. The TP step (f32 once, bf16
    DP_STEPS times and once profiled) against the one-process steps of
    dp_train (rank 0's `refs`), a TP eval step's launches, and the
    bottleneck's output (bottom3's, whole on each rank) of the TP eval
    forward."""
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(1, n_model=DP_RANKS,
                              devices=["cuda:0"] * DP_RANKS)
    task = train_step.TaskConfig()
    out = {"data_index": mesh.rank, "model_index": mesh.model_rank,
           "lead": mesh_lib.is_lead(mesh)}
    for dtype in ("float32", "bfloat16"):
        cfg, ts, batch = dp_setup(dtype)
        mesh_lib.put_replicated(mesh, ts)
        plans = mu.precompute_mask_plans(ts.masks)
        step = train_step.make_train_step(cfg, task, mask_plans=plans,
                                          device="cuda:0", mesh=mesh)
        r, update, state = timed_steps(step, ts, batch, dtype)
        eval_step = train_step.make_eval_step(cfg, task, device="cuda:0",
                                              mesh=mesh)
        zero_launches()
        result = eval_step(ts, batch, plans)
        torch.cuda.synchronize()
        r.update(eval_launches=kernel_launches(),
                 eval_pred_rows=int(result["pred"].shape[0]))
        with torch.no_grad():
            (_, _, _, x4), _ = mu.encode(
                ts.params, ts.model_state,
                torch.from_numpy(batch["image"]).cuda(), cfg=cfg,
                masks=ts.masks, mask_plans=plans, mesh=mesh)
        r["bottleneck_shape"] = list(x4.shape)
        if rank == 0:
            r.update(compare_to_one_process(update, state, refs, dtype))
        out[dtype] = r
        del ts, update
    return out


def phase_tp(card: str, parallel: list) -> dict:
    """Phase 28, tp: tensor parallelism over a 1x2 (data, model) mesh, the
    two gloo ranks of dp_train's spawn sharing cuda:0, each computing half
    of the channels of bottom1's and bottom2's convs on the whole global
    batch of 8 (c_out 150, 128x128), against the one-process step on the
    same batch and state with dp_train's checks; K1 6 a rank an eval step
    on all 8 rows; bottom3's output whole on each rank (256 channels at
    16x16); rank 0 alone the lead. Then serving on a 1x2 mesh that this
    process drives (`tp_serving`)."""
    r0, r1 = (r["tp"] for r in parallel)
    check_dp_like("tp", r0, r1, BATCH)
    check([r0["data_index"], r0["model_index"], r1["data_index"],
           r1["model_index"]] == [0, 0, 0, 1] and r0["lead"]
          and not r1["lead"],
          f"tp: ranks 0 and 1 are model indices 0 and 1 of data index 0, "
          f"rank 0 the lead: {r0} {r1}")
    check(all(r[d]["bottleneck_shape"] == [BATCH, IMG // 8, IMG // 8, 256]
              for r in (r0, r1) for d in ("float32", "bfloat16")),
          f"tp: bottom3's output on each rank: "
          f"{r0['float32']['bottleneck_shape']}")
    serving = tp_serving()
    emit(phase="tp", card=card, mesh={"data": 1, "model": DP_RANKS},
         global_batch=BATCH, seconds=r0["seconds"], rank0=r0, rank1=r1,
         serving=serving,
         note="two model ranks share one card's SMs, each running the "
              "whole step but half the bottleneck: their times show the "
              "path and its gathers through gloo, never a TP speedup")
    zeros = dict.fromkeys(counted_wrappers(), 0)
    check(serving["launches"] == {**zeros, "K1": 6 * len(serving["equal"])}
          and serving["agreement"] >= TP_SERVE_AGREE,
          f"tp serving: K1 6 a forward, f32 maps as one device's: "
          f"{serving}")
    return {"K2": r0["bfloat16"]["launches"][0]["K2"],
            "K4": r0["bfloat16"]["launches"][0]["K4"],
            "K1": r0["bfloat16"]["eval_launches"]["K1"]}


def tp_serving() -> dict:
    """`build_model_runner` over a 1x2 (data, model) mesh that this process
    drives, both shards on cuda:0, against the single-device runner (f32,
    two batches of 8): launches, maps equal, pixel agreement."""
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(1, n_model=DP_RANKS,
                              devices=["cuda:0"] * DP_RANKS)
    rng = np.random.default_rng(6)
    batches = [rng.integers(0, 256, (BATCH, IMG, IMG, 3)).astype(np.uint8)
               for _ in range(2)]
    kw = dict(compute_dtype="float32", batch_size=BATCH, device="cuda")
    single, _ = serve.build_model_runner("ade_semantic", NUM_CLASSES, None,
                                         **kw)
    tp, _ = serve.build_model_runner("ade_semantic", NUM_CLASSES, None,
                                     mesh=mesh, **kw)
    want = [single(b).cpu().numpy() for b in batches]
    torch.cuda.synchronize()
    zero_launches()
    got = [tp(b).cpu().numpy() for b in batches]
    launches = kernel_launches()
    return {"launches": launches,
            "equal": [bool(np.array_equal(g, w)) for g, w in zip(got, want)],
            "agreement": float(np.mean([(g == w).mean()
                                        for g, w in zip(got, want)]))}


def gather_tokens(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' token shards put together along dim 1."""
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def wall_ms(fn, n: int = 3) -> float:
    """Best host-clock ms of `n` synchronised calls, after one."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def ring_rank(rank: int) -> dict:
    """Phase ring, one rank: `ring_spatial_attention` at attn6's shape on
    this rank's 8,192 tokens, the global key mask with batch row 1 fully
    masked; forward in f32 and bf16, and the f32 gradients of a fixed
    weighting of the output. Rank 0 compares the gathered output and
    gradients with the port's plain masked attention on the global
    tokens, one batch row at a time (its [L, L] scores fit)."""
    from maskunet_tpu_torch.ops import attention
    from maskunet_tpu_torch.parallel import mesh as mesh_lib
    from maskunet_tpu_torch.parallel import ring_attention as ring
    mesh = mesh_lib.make_mesh(DP_RANKS, devices=["cuda:0"] * DP_RANKS)
    b, l, c = RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(31)
    params = {k: v.cuda() for k, v in attention.attention_init(
        torch.Generator().manual_seed(31), c).items()}
    tokens = torch.randn(b, l, c, generator=gen, device="cuda")
    weight = torch.randn(b, l, c, generator=gen, device="cuda")
    mask = attention.random_key_mask(gen, b, l)
    mask[1] = False
    lmask = mesh_lib.shard_tokens(mesh, mask)
    out = {"transport": ring.transport(mesh.group, tokens),
           "tokens_per_rank": l // DP_RANKS}

    def dense(p, t, m):
        return torch.cat([attention.masked_attention_dense(
            p, t[i:i + 1], m[i:i + 1]) for i in range(t.shape[0])])

    for dtype in (torch.float32, torch.bfloat16):
        local = mesh_lib.shard_tokens(mesh, tokens.to(dtype))
        with torch.no_grad():
            def fwd():
                return ring.ring_spatial_attention(params, local, lmask,
                                                   mesh=mesh)
            y = gather_tokens(fwd(), mesh.group)
            r = {"wall_ms": wall_ms(fwd),
                 "device_ms": profiled_device_ms(fwd),
                 "finite": bool(torch.isfinite(y).all())}
            if rank == 0:
                want = dense(params, tokens.to(dtype), mask)
                r["agreement"] = agreement(y, want)
                r["plain_wall_ms"] = wall_ms(
                    lambda: dense(params, tokens.to(dtype), mask), 1)
                del want
        out[str(dtype).split(".")[1]] = r
        del y

    # f32 gradients: the token shards' and the parameters' (summed)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    local = mesh_lib.shard_tokens(mesh, tokens).clone().requires_grad_(True)
    lweight = mesh_lib.shard_tokens(mesh, weight)
    keys = list(p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = ring.ring_spatial_attention(p, local, lmask, mesh=mesh)
    grads = torch.autograd.grad((y * lweight).sum(),
                                [local] + [p[k] for k in keys])
    torch.cuda.synchronize()
    r = {"fwd_bwd_wall_ms": (time.perf_counter() - t0) * 1e3,
         "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    got = {"tokens": gather_tokens(grads[0], mesh.group)}
    for k, g in zip(keys, grads[1:]):
        got[k] = mesh_lib.all_reduce_(g.clone(), mesh.group)
    del y, grads
    if rank == 0:
        want = {k: torch.zeros_like(v) for k, v in params.items()}
        rows = []
        for i in range(b):
            pw = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            t = tokens[i:i + 1].clone().requires_grad_(True)
            yd = attention.masked_attention_dense(pw, t, mask[i:i + 1])
            g = torch.autograd.grad((yd * weight[i:i + 1]).sum(),
                                    [t] + [pw[k] for k in keys])
            rows.append(g[0])
            for k, gk in zip(keys, g[1:]):
                want[k] += gk
        want["tokens"] = torch.cat(rows)
        r["grad_rel_err"] = {
            k: float((got[k] - want[k]).abs().max() / want[
                RING_ZERO_GRAD.get(k, k)].abs().max().clamp(min=1e-30))
            for k in want}
    out["float32_grads"] = r
    return out


def phase_ring(card: str, parallel: list) -> None:
    """Phase 29, ring: ring attention at attn6's shape over the two gloo
    ranks of dp_train's spawn sharing cuda:0, 8,192 tokens a rank: the
    forward in f32 and bf16 against the port's plain masked attention on
    the global tokens at the kernels' tolerances, the f32 gradients
    within RING_GRAD_RTOL, no NaN with a fully-masked row; the transport
    named."""
    r0, r1 = (r["ring"] for r in parallel)
    emit(phase="ring", card=card, shape=list(RING_SHAPE), ranks=DP_RANKS,
         seconds=r0["seconds"], rank0=r0, rank1=r1,
         note="two ranks share one card: the times show the ring and its "
              "transport, not a sequence-parallel speedup")
    for dtype in ("float32", "bfloat16"):
        check(r0[dtype]["agreement"]["ok"] and r0[dtype]["finite"]
              and r1[dtype]["finite"],
              f"ring {dtype}: the forward equals the plain attention, no "
              f"NaN with a fully-masked row: {r0[dtype]['agreement']}")
    errs = r0["float32_grads"]["grad_rel_err"]
    check(max(errs.values()) <= RING_GRAD_RTOL,
          f"ring: f32 gradients of the token shards and the parameters "
          f"against the plain attention's (key.bias's against the key "
          f"weight's scale): {errs}")
    check(r0["transport"] == r1["transport"] and "gloo" in r0["transport"],
          f"ring: the transport of two gloo ranks: {r0['transport']}")


# the 256 px configuration (phase res256): (layer, Lq, Lk after
# compaction, C, use_valid) of its forward; attn2 and attn4 compact here
RES256_IMG = 256
RES256_SHAPES = (
    ("attn1", 16384, 9216, 128, False),
    ("attn2", 4096, 2560, 256, False),
    ("attn3", 1024, 1024, 256, True),
    ("attn4", 4096, 2560, 128, False),
    ("attn5", 16384, 9216, 64, False),
    ("attn6", 65536, 34304, 64, False),
)
# the batch rows held against the plain versions, one at a time: one f32
# score matrix of attn6 is 65,536 x 34,304 x 4 B = 9.0 GB a row
RES256_ROWS = (0, BATCH - 1)
RES256_STEPS = 10
# serve_breakdown's stage A (the runner's batches back to back) against the
# serving phase's wall-clock img/s in the same run
BREAKDOWN_RTOL = 0.25


def free_card() -> int:
    """Collects the garbage and returns the allocator's cached blocks;
    the bytes still allocated."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def res256_kernels(card: str) -> dict:
    """K1, K2 and K4 at the six 256 px shapes (batch 8, bf16): each launched
    on the whole batch and held, on rows 0 and 7 one at a time, against
    its plain version on the same rows (K4 on K2's o and lse and a random
    dO); then each one's device ms a launch against its bound. Returns
    the worst error and each kernel's sums over the shapes."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    worst = 0.0
    sums = {k: {"ms": 0.0, "bound_ms": 0.0} for k in ("K1", "K2", "K4")}
    for name, lq, lk, c, uv in RES256_SHAPES:
        q, k, v, bias = attention_inputs(gen, lq, lk, c, uv, torch.bfloat16)
        do = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
        o1 = fk.flash_fwd_nomax(q, k, v, bias, 1.0, uv)
        o2, lse = fk.flash_fwd_nomax_lse(q, k, v, bias, 1.0, uv)
        grads = fk.flash_bwd(q, k, v, bias, o2, lse, do, 1.0, uv)
        torch.cuda.synchronize()
        outs = {}
        for r in RES256_ROWS:
            rows = slice(r, r + 1)
            args = (q[rows], k[rows], v[rows], bias[rows])
            want_o, want_lse = fk.flash_fwd_nomax_reference(
                *args, 1.0, uv, with_lse=True)
            outs[f"K1_o_row{r}"] = agreement(o1[rows], want_o)
            outs[f"K2_o_row{r}"] = agreement(o2[rows], want_o)
            outs[f"K2_lse_row{r}"] = agreement(lse[rows], want_lse)
            del want_o, want_lse
            want = fk.flash_bwd_reference(*args, o2[rows], lse[rows],
                                          do[rows], 1.0, uv)
            for n, g, w in zip(("dq", "dk", "dv"), grads, want):
                outs[f"K4_{n}_row{r}"] = agreement(g[rows], w)
            del want
            free_card()
        worst = max(worst, emit_case("res256_kernel", name, q, k, uv, outs))
        times = {}
        fwd_bytes, fwd_ops = bound_ms(q, k, bias)
        bwd_bytes, bwd_ops = bwd_bound_ms(q, k, bias)
        lse_ms = 4 * lse.numel() / PEAK["bytes"] * 1e3
        for kname, fn, bnd in (
                ("K1", lambda: fk.flash_fwd_nomax(q, k, v, bias, 1.0, uv),
                 (fwd_bytes, fwd_ops)),
                ("K2", lambda: fk.flash_fwd_nomax_lse(q, k, v, bias, 1.0, uv),
                 (fwd_bytes + lse_ms, fwd_ops)),
                ("K4", lambda: fk.flash_bwd(q, k, v, bias, o2, lse, do, 1.0,
                                            uv), (bwd_bytes, bwd_ops))):
            ms = device_ms(fn, iters=3 if lq * lk > 2 ** 28 else 10)
            times[kname] = {"ms": ms, "bound_ms": max(bnd),
                            "bound_by": ("bytes" if bnd[0] > bnd[1]
                                         else "operations"),
                            "share_of_bound": max(bnd) / ms}
            sums[kname]["ms"] += ms
            sums[kname]["bound_ms"] += max(bnd)
        emit(phase="res256_attn_time", card=card, layer=name, lq=lq, lk=lk,
             c=c, batch=BATCH, dtype="bfloat16", use_valid=uv,
             body={"K1": fk.flash_fwd_nomax_body(c, torch.bfloat16),
                   "K4": fk.flash_bwd_body(c, torch.bfloat16)}, **times)
        del q, k, v, bias, do, o1, o2, lse, grads
        free_card()
    return {"max_abs_err": worst, "sums": sums}


def res256_forward_vs_plain(card: str) -> dict:
    """The folded forward at 256 px, batch 1, through the kernels (K1 6
    times) and through K1's plain version, the same weights and masks, in
    bf16 and in f32, on two inputs: a seeded uint8 image as the server
    feeds it (x / 255) and a standard normal one (res256_bench's input).
    bf16 logits within the serving bound of phase 4 on both, f32 logits
    within the f32 kernel bound (TOL, scaled to max|logit|) on both; the
    bf16 argmax agreement of phase 4 on the served image. Each bf16
    path's argmax agreement with the f32 plain path (their rounding
    floor) is printed beside: on the normal input both paths fall below
    the serving bound alike, so that bound holds for images only."""
    cfg = mu.MaskAttnUNetConfig(c_out=NUM_CLASSES, img_size=RES256_IMG,
                                compute_dtype="bfloat16", attn_impl="flash")
    params, mstate = mu.init(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        folded = mu.fold_bn_for_inference(
            {k: v.cuda() for k, v in params.items()},
            {k: v.cuda() for k, v in mstate.items()}, cfg)
    masks = tuple(m.cuda() for m in mu.make_attention_masks(
        torch.Generator().manual_seed(1), 1, RES256_IMG))
    plans = mu.precompute_mask_plans(masks)
    shape = (1, RES256_IMG, RES256_IMG, 3)
    inputs = {
        "served": torch.from_numpy(np.random.default_rng(15).integers(
            0, 256, shape).astype(np.uint8)).cuda().float() / 255.0,
        "normal": torch.from_numpy(np.random.default_rng(16).standard_normal(
            shape).astype(np.float32)).cuda()}
    rows = {}
    for name, x in inputs.items():
        logits = {}
        for dtype in ("bfloat16", "float32"):
            c = dataclasses.replace(cfg, compute_dtype=dtype)
            p = (mu.cast_params_for_inference(folded)
                 if dtype == "bfloat16" else folded)
            with torch.no_grad():
                zero_launches()
                logits[dtype, "kernel"] = mu.apply(
                    p, None, x, cfg=c, masks=masks, folded=True,
                    mask_plans=plans)[0].semantic.float()
                one = kernel_launches()
                kernel_fn = fk.flash_fwd_nomax
                fk.flash_fwd_nomax = fk.flash_fwd_nomax_reference
                try:
                    logits[dtype, "plain"] = mu.apply(
                        p, None, x, cfg=c, masks=masks, folded=True,
                        mask_plans=plans)[0].semantic.float()
                finally:
                    fk.flash_fwd_nomax = kernel_fn
            free_card()
            check(one == {**dict.fromkeys(counted_wrappers(), 0), "K1": 6},
                  f"res256 {name} {dtype}: one forward launches K1 6 times, "
                  f"no other kernel: {one}")
        truth = logits["float32", "plain"].argmax(-1)
        for dtype, tol in (("bfloat16", SERVE_LOGIT_TOL),
                           ("float32", TOL[torch.float32])):
            lk, lp = logits[dtype, "kernel"], logits[dtype, "plain"]
            scale = float(lp.abs().max())
            r = rows[f"{name}_{dtype}"] = {
                "logits_finite": bool(torch.isfinite(lk).all()),
                "logits_max_abs_diff_vs_plain": float((lk - lp).abs().max()),
                "logits_max_abs": scale, "tol": tol * scale,
                "argmax_agreement": float(
                    (lk.argmax(-1) == lp.argmax(-1)).float().mean()),
                "argmax_vs_f32_plain": {
                    path: float((logits[dtype, path].argmax(-1) == truth)
                                .float().mean())
                    for path in ("kernel", "plain")}}
            check(list(lk.shape) == [1, RES256_IMG, RES256_IMG, NUM_CLASSES]
                  and r["logits_finite"],
                  f"res256 {name} {dtype}: logits finite, [1,256,256,150]")
            check(r["logits_max_abs_diff_vs_plain"] <= r["tol"],
                  f"res256 {name} {dtype}: batch-1 logits kernel vs plain")
        del logits, truth
    check(rows["served_bfloat16"]["argmax_agreement"] >= SERVE_ARGMAX_AGREE,
          "res256 served bfloat16: batch-1 argmax agreement kernel vs plain")
    emit(phase="res256_vs_plain", card=card, batch=1, **rows)
    return rows


def phase_res256(card: str) -> dict:
    """The 256 px configuration (phase 30): `res256_bench.run` at batch 8,
    inference then train (the peak reset by each), its launches and
    loss; the kernels at its six shapes; the batch-1 forward against the
    plain path. Returns the two rows and the kernels' numbers."""
    emit(phase="res256_start", card=card,
         allocated_gib=free_card() / 2 ** 30)
    rows = {}
    for phase, train in (("inference", False), ("train", True)):
        zero_launches()
        row = res256_bench.run(RES256_IMG, BATCH, RES256_STEPS, train)
        row["busy_share"] = (row["device_ms"] / row["wall_ms"]
                             if row["device_ms"] else None)
        emit(**{**row, "phase": "res256", "run": phase})
        n = row["calls"]
        want = ({"K1": 0, "K2": 6 * n, "K3": 0, "K4": 6 * n} if train
                else {"K1": 6 * n, "K2": 0, "K3": 0, "K4": 0})
        check(row["launches"] == want and kernel_launches()["K1"] == want["K1"],
              f"res256 {phase}: K1 6 a forward, K2 6 and K4 6 a step over "
              f"{n} calls: {row['launches']}")
        check(row["card"] == card and row["peak_hbm_gib"] > 0
              and isinstance(row["device_ms"], float),
              f"res256 {phase}: card, peak GB and device ms measured")
        if train:
            check(all(np.isfinite(row["losses"]))
                  and row["loss_last"] < row["loss_first"],
                  f"res256: a finite loss that falls over "
                  f"{RES256_STEPS} steps: {row['loss_first']} -> "
                  f"{row['losses']}")
        rows[phase] = row
        free_card()
    kernels = res256_kernels(card)
    res256_forward_vs_plain(card)
    free_card()
    return {**rows, "kernels": kernels}


def phase_serve_bench(card: str) -> dict:
    """`tools/serve_bench.py` (phase 31) with the JAX tool's defaults (400
    requests, concurrency 16, 4 client processes), in a subprocess, PNG
    then raw: no failed request, the latency percentiles, a filled batch,
    and the server's K1 launches 6 a batch."""
    out = {}
    for fmt, extra in (("png", []), ("raw", ["--raw"])):
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "maskunet_tpu_torch.tools.serve_bench",
             *extra], capture_output=True, text=True, timeout=300,
            cwd=ROOT, env=subprocess_env())
        res = last_json(proc.stdout) or {}
        emit(**{"card": card, **res, "phase": "serve_bench", "format": fmt,
                "rc": proc.returncode, "seconds": time.monotonic() - t0,
                "stderr": proc.stderr[-2000:] if proc.returncode else ""})
        check(proc.returncode == 0 and res.get("failed_requests") == 0
              and all(res.get(k) is not None
                      for k in ("req_per_sec", "p50_ms", "p99_ms"))
              and res.get("avg_batch_fill", 0) > 0,
              f"serve_bench {fmt}: every request answered, req/s and "
              f"latency measured, batches filled: {res}")
        check(res.get("batches", 0) > 0
              and res.get("kernel_launches") == {"K1": 6 * res["batches"],
                                                 "K3": 0}
              and res.get("client_imports_torch") is False,
              f"serve_bench {fmt}: the server's K1 launches 6 a batch, no "
              f"client imports torch: {res}")
        out[fmt] = res
    return out


def serving_wall_img_s() -> float:
    """The serving runner's wall-clock img/s as phase 5 times it (best of 3
    windows of 10 batches, fenced by a synchronise), on a runner of its
    own."""
    runner, img_size = serve.build_model_runner(
        "ade_semantic", NUM_CLASSES, None, compute_dtype="bfloat16",
        batch_size=BATCH, device="cuda")
    x = np.zeros((BATCH, img_size, img_size, 3), np.uint8)
    runner(x).cpu()
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            runner(x)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / 10)
    return BATCH / best


def phase_serve_breakdown(card: str, serve_times: dict) -> dict:
    """`tools/serve_breakdown.py` at batch 8 and 16 threads (phase 32),
    in this process: stage A within BREAKDOWN_RTOL of the serving
    forward's wall-clock img/s, timed as phase 5 times it just before
    and just after the tool (the host's speed drifts over a run: phase
    5's own number, minutes earlier, is printed beside)."""
    before = serving_wall_img_s()
    res = serve_breakdown.main([str(BATCH), "16"])
    after = serving_wall_img_s()
    serving_img_s = (before + after) / 2
    rel = res["model_img_s"] / serving_img_s - 1
    emit(**res, phase="serve_breakdown", serving_img_s=serving_img_s,
         serving_img_s_before_after=[before, after],
         serving_phase_img_s=BATCH / serve_times["wall_ms"] * 1e3,
         a_vs_serving=rel, rtol=BREAKDOWN_RTOL)
    check(abs(rel) <= BREAKDOWN_RTOL,
          f"serve_breakdown: stage A {res['model_img_s']} img/s within "
          f"{BREAKDOWN_RTOL:.0%} of serving's {serving_img_s:.1f}")
    return res


def phase_mfu(card: str, serve: dict, step: dict, res256: dict) -> dict:
    """`tools/mfu_report.model_flops` at 128 and 256 px over the wall and
    device times that the serving, train_time and res256 phases measured
    (phase 33; nothing is timed again): every MFU in (0, 1)."""
    out = {}
    for img, times in ((IMG, {"fwd": serve, "train": step}),
                       (RES256_IMG, {"fwd": res256["inference"],
                                     "train": res256["train"]})):
        fl = mfu_report.model_flops(img, NUM_CLASSES)
        row = {"gflop_fwd_per_image": fl["fwd"] / 1e9,
               "gflop_train_per_image": fl["train"] / 1e9}
        for name, t in times.items():
            for clock in ("wall", "device"):
                row[f"{name}_ms_{clock}"] = t[f"{clock}_ms"]
                row[f"{name}_mfu_{clock}"] = mfu_report.mfu(
                    fl[name], BATCH, t[f"{clock}_ms"])
        emit(phase="mfu", card=card, img_size=img, batch=BATCH,
             peak_tflops=mfu_report.H100_PEAK_BF16 / 1e12, **row)
        shares = {k: v for k, v in row.items() if "_mfu_" in k}
        check(all(v is not None and 0 < v < 1 for v in shares.values()),
              f"mfu at {img} px: every MFU in (0, 1): {shares}")
        out[img] = row
    return out


# --- the profiling and parity tools (phases 34-39) ---------------------------

PROFILE_RTOL = 0.15           # the trace's device ms vs device_ms_per_call
PROFILE_RUNS = ((IMG, 3), (RES256_IMG, 1))     # (img, traced calls)
FWD_TAG = "fwd_nomax"         # K1's and K2's kernels, every body
# training_parity: the port's loss against the oracle's at step 0 (the
# forward on the same weights) and at step 1 (after one AdamW update);
# the tests hold step 0 to 1e-5 as well
PARITY_STEP_RTOL = (1e-5, 1e-4)
# The pattern whose lockstep statistics measure f32 noise, not the port: in
# `embed` (the triplet on ReLU'd embeddings) any two f32 implementations
# of the same step part chaotically (tests/parity_chaos.py). On a CPU,
# JAX's step and the port's part by 6.5e-3 by step 4 and 1.6e-2 by step
# 7, as much as either parts from the oracle, and the oracle parts from
# itself on the same inputs at another thread count by 1.7e-2 by step 4;
# on the card each side parts from itself run to run by 1-2e-2 by step 8.
# The cumulative statistic, gated at 1%, reads 0.88% for JAX's tool,
# 0.92% and 1.08% for the port's at 4 and 1 CPU threads, and 0.95-1.55%
# in five runs on the card. Its statistics and the verdict are printed.
PARITY_CHAOTIC = ("embed",)
BREAKDOWN_DEVICE_RTOL = 0.15  # a breakdown's 'full' vs the profile phases
BREAKDOWN_WINDOWS = dict(steps=5, repeats=2, device_calls=2)
# the step's: one device-time call a mode (a profiled step of 3,330
# launches takes seconds to summarise)
TRAIN_BREAKDOWN_WINDOWS = dict(BREAKDOWN_WINDOWS, device_calls=1)
TRAIN_BREAKDOWN_MODES = ("full", "noattn", "no16k", "nodrop", "nobnstat",
                         "sgd")
# the flash layers each breakdown mode leaves at 128 px (the others are the
# identity, or the dense path for dense_small's small layers)
FLASH_LAYERS = {"full": 6, "noattn": 0, "no16k": 5, "no4k": 4, "nosmall": 3,
                "dense_small": 3, "nodrop": 6, "nobnstat": 6, "sgd": 6}
EVAL_SCALE_ARGS = (500, 120)  # images x categories (the tool's: 5,000)
EVAL_SCALE_KEYS = {"n_images", "n_cats", "ap_seconds", "pq_1000img_seconds",
                   "inst_extract_img_per_sec", "ok"}


def kernel_kind(name: str) -> str:
    """The family of a device op by its profiler name: the flash kernels,
    cuDNN's and cuBLAS's convs and matmuls, reductions (the norms' sums,
    the loss), elementwise passes, copies (dtype casts, cat, memcpy),
    other."""
    low = name.lower()
    if FWD_TAG in name:
        return "K1/K2"
    if K4_TAG in name:
        return "K4"
    if any(t in low for t in ("xmma", "cutlass", "nvjet", "gemm", "conv")):
        return "conv_matmul"
    if "reduce_kernel" in name:
        return "reduction"
    if "copy" in low or name.startswith(("Memcpy", "Memset")):
        return "copy"
    if "elementwise" in name:
        return "elementwise"
    return "other"


def patch_targets() -> list:
    """Every module attribute a breakdown tool patches, as it is now."""
    from maskunet_tpu_torch.ops import attention, metrics_ops
    return [attention.spatial_attention, layers.gelu, layers.layernorm,
            layers.upsample_2x_bilinear, layers.batchnorm_train,
            metrics_ops.mean_iou, train_step.cross_entropy]


def phase_profile(card: str, serve_times: dict, step_times: dict,
                  res256: dict) -> dict:
    """`tools/profile_step.run` (phase 34) at 128 px (batch 8, 3 traced
    calls) and 256 px (batch 8, 1): for the forward and the step, the top
    device ops a call by the profiler's kernel names (`parse_xplane`);
    the kernels named K1 (6 a forward), K2 and K4 (6 each a step), as the
    launch counters say too; the trace's device ms a call within
    PROFILE_RTOL of `device_ms_per_call` on the same call. The serving,
    train and res256 phases' device ms are printed beside."""
    out = {}
    earlier = {IMG: {"fwd": serve_times["device_ms"],
                     "train": step_times["device_ms"]},
               RES256_IMG: {"fwd": res256["inference"]["device_ms"],
                            "train": res256["train"]["device_ms"]}}
    for img, calls in PROFILE_RUNS:
        work = tempfile.mkdtemp(prefix="chip_smoke_profile_")
        t0 = time.monotonic()
        try:
            res = profile_step.run(BATCH, work, calls, img_size=img)
            for phase, want in (("fwd", {"K1": 6}),
                                ("train", {"K2": 6, "K4": 6})):
                events = parse_xplane.device_events(res[phase])
                times = {n: ms for plane in parse_xplane.op_times(
                    res[phase]).values() for n, ms in plane.items()}
                total = sum(times.values()) / calls
                named = {"K1/K2": sum(FWD_TAG in n for _, n, _ in events),
                         "K4": sum(K4_TAG in n for _, n, _ in events)}
                named_want = {"K1/K2": 6 * calls,
                              "K4": 6 * calls if phase == "train" else 0}
                launches = res["launches"][phase]
                launches_want = {k: 6 * calls * (k in want)
                                 for k in ("K1", "K2", "K3", "K4")}
                dev_ms = device_ms_per_call(res["calls"][phase],
                                            calls=max(calls, 2))
                rel = total / dev_ms - 1 if dev_ms else None
                top = sorted(times.items(), key=lambda kv: -kv[1])
                by_kind = {}
                for name, ms in times.items():
                    kind = kernel_kind(name)
                    by_kind[kind] = by_kind.get(kind, 0.0) + ms / calls
                emit(phase="profile", card=card, img_size=img, batch=BATCH,
                     run=phase, traced_calls=calls,
                     device_ms_per_call_trace=total,
                     device_ms_per_call_profiler=dev_ms, rel=rel,
                     rtol=PROFILE_RTOL,
                     earlier_phase_device_ms=earlier[img][phase],
                     kernels_named=named, launches=launches,
                     device_events_per_call=len(events) / calls,
                     ms_per_call_by_kind=by_kind,
                     top=[{"name": n[:200], "ms_per_call": ms / calls,
                           "share": ms / calls / total}
                          for n, ms in top[:25]])
                check(named == named_want and launches == launches_want,
                      f"profile {img} px {phase}: the trace names the flash "
                      f"kernels 6 times a call ({named}, want {named_want}) "
                      f"and the counters agree ({launches})")
                check(rel is not None and abs(rel) <= PROFILE_RTOL,
                      f"profile {img} px {phase}: the trace's {total:.3f} "
                      f"ms a call within {PROFILE_RTOL:.0%} of "
                      f"device_ms_per_call's {dev_ms}")
                out[(img, phase)] = total
            del res
        finally:
            shutil.rmtree(work, ignore_errors=True)
        free_card()
        emit(phase="profile_time", card=card, img_size=img,
             seconds=time.monotonic() - t0)
    return out


def phase_paritycheck(card: str) -> list:
    """`tools/tpu_kernel_paritycheck.py`'s main (phase 35): the flash path
    against dense attention at JAX's four shapes and against
    `dense_chunked` at 16,384 tokens (the compacted path), forward and
    gradient in exact f32, each passing JAX's gate and launching K1, K2
    and K4 (the tool checks both); no K3."""
    zero_launches()
    t0 = time.monotonic()
    try:
        rows, failed = tpu_kernel_paritycheck.main([]), None
    except SystemExit as e:
        rows, failed = [], str(e)
    launches = kernel_launches()
    emit(phase="paritycheck", card=card, rows=rows, failed=failed,
         launches=launches, seconds=time.monotonic() - t0)
    check(failed is None and len(rows) == 5 and all(r["ok"] for r in rows)
          and all(min(r["launches"].values()) > 0 for r in rows),
          f"paritycheck: five shapes within JAX's gate, K1, K2 and K4 "
          f"launched at each: {failed} {rows}")
    check(launches["K3"] == 0 and launches["K2"] == launches["K4"] == sum(
              r["launches"]["K4"] for r in rows),
          f"paritycheck: no K3; K2 with each K4: {launches}")
    return rows


def phase_training_parity(card: str) -> dict:
    """`tools/training_parity.py` at its defaults (phase 36): the port's
    step against the torch oracle in lockstep, 20 steps at 16 px, the four
    loss patterns, both on the card in exact f32. In every pattern the
    loss of step 0 (the same weights and batch) and of step 1 (after one
    AdamW update) agree within PARITY_STEP_RTOL; JAX's three gates hold
    in every pattern but PARITY_CHAOTIC, whose statistics and the gates'
    verdict are printed (see PARITY_CHAOTIC)."""
    t0 = time.monotonic()
    worst = training_parity.run()
    failed = training_parity.gate_failures(worst)
    stats = {t: {k: v[k] for k in training_parity.LIMITS}
             for t, v in worst.items()}
    early = {t: [abs(p - o) / abs(o) for p, o in zip(
        v["port_losses"][:2], v["oracle_losses"][:2])]
        for t, v in worst.items()}
    emit(phase="training_parity", card=card, stats=stats,
         limits=training_parity.LIMITS, gate_failures=failed,
         steps_0_1_rel=early, steps_0_1_rtol=PARITY_STEP_RTOL,
         rel_by_step={t: [abs(p - o) / abs(o) for p, o in zip(
             v["port_losses"], v["oracle_losses"])]
             for t, v in worst.items()},
         seconds=time.monotonic() - t0)
    check(list(stats) == list(training_parity.TASKS) and all(
              all(r <= tol for r, tol in zip(rel, PARITY_STEP_RTOL))
              for rel in early.values()),
          f"training_parity: steps 0 and 1 within {PARITY_STEP_RTOL} in "
          f"every pattern: {early}")
    check(all(t in PARITY_CHAOTIC for t, _, _ in failed),
          f"training_parity: JAX's gates in "
          f"{[t for t in stats if t not in PARITY_CHAOTIC]}: {failed}")
    return stats


def phase_breakdowns(card: str, serve_times: dict, step_times: dict
                     ) -> dict:
    """The three breakdown tools (phase 37) with short windows
    (BREAKDOWN_WINDOWS, the step's TRAIN_BREAKDOWN_WINDOWS): the
    forward's six modes, the step's TRAIN_BREAKDOWN_MODES, the trunk's
    five variants. Each mode's wall and device ms; the forward's and the
    step's 'full' device ms within BREAKDOWN_DEVICE_RTOL of the serving
    and train profiles'; the flash kernels launched as the modes leave
    them (K1 in the forwards, K2 and K4 in the steps, none in the trunk);
    every patched function the original again after each tool."""
    w, wt = BREAKDOWN_WINDOWS, TRAIN_BREAKDOWN_WINDOWS

    def calls(windows):
        return 1 + windows["steps"] * windows["repeats"] + \
            windows["device_calls"]

    runs = {
        "fwd": (lambda: fwd_breakdown.run(BATCH, fwd_breakdown.MODES, **w),
                {"K1": calls(w) * sum(FLASH_LAYERS[m]
                                      for m in fwd_breakdown.MODES)}, w),
        # a step tool's mode also takes one last call for its loss
        "train": (lambda: train_breakdown.run(BATCH, TRAIN_BREAKDOWN_MODES,
                                              **wt),
                  {k: (calls(wt) + 1) * sum(FLASH_LAYERS[m]
                                            for m in TRAIN_BREAKDOWN_MODES)
                   for k in ("K2", "K4")}, wt),
        "trunk": (lambda: trunk_breakdown.run(
            BATCH, trunk_breakdown.VARIANTS, **w), {}, w)}
    out = {}
    for tool, (run, want, windows) in runs.items():
        before = patch_targets()
        zero_launches()
        t0 = time.monotonic()
        res = run()
        launches = kernel_launches()
        restored = patch_targets() == before
        emit(phase="breakdowns", card=card, tool=tool, batch=BATCH,
             windows=windows, results=res, launches=launches,
             restored=restored,
             seconds=time.monotonic() - t0)
        check(restored, f"breakdowns {tool}: every patched function is the "
              f"original again")
        check(launches == {**dict.fromkeys(counted_wrappers(), 0), **want},
              f"breakdowns {tool}: the flash kernels as the modes leave "
              f"them: {launches}, want {want}")
        check(all(isinstance(r["device_ms"], float) for r in res.values()),
              f"breakdowns {tool}: device ms beside every wall time")
        out[tool] = res
    for tool, earlier in (("fwd", serve_times), ("train", step_times)):
        got, ref = out[tool]["full"]["device_ms"], earlier["device_ms"]
        rel = got / ref - 1 if got and ref else None
        emit(phase="breakdowns_vs_profile", card=card, tool=tool,
             full_device_ms=got, profile_device_ms=ref, rel=rel,
             rtol=BREAKDOWN_DEVICE_RTOL)
        check(rel is not None and abs(rel) <= BREAKDOWN_DEVICE_RTOL,
              f"breakdowns {tool}: 'full' {got} device ms within "
              f"{BREAKDOWN_DEVICE_RTOL:.0%} of the profile's {ref}")
    return out


def phase_data_bench(card: str, root: str) -> list:
    """`tools/data_bench.run` (phase 38) on `data_rate`'s 512 px layout at
    1 and 4 threads for 1 epoch: JAX's keys, every whole batch of the
    64 images delivered to the card each time."""
    t0 = time.monotonic()
    rows = data_bench.run(root, BATCH, 1, (1, 4))
    emit(phase="data_bench", card=card, side=DATA_RATE_SIDE, rows=rows,
         seconds=time.monotonic() - t0)
    check([r["threads"] for r in rows] == [1, 4] and all(
              r["images"] == DATA_RATE_IMAGES // BATCH * BATCH
              and r["dataset_images"] == DATA_RATE_IMAGES
              and r["img_per_sec"] > 0 for r in rows),
          f"data_bench: every whole batch at each thread count: {rows}")
    return rows


def start_eval_scale() -> subprocess.Popen:
    """`tools/eval_scale_bench.py` at EVAL_SCALE_ARGS in a subprocess: host
    work, run beside the card's phases 34-37."""
    return subprocess.Popen(
        [sys.executable, "-m", "maskunet_tpu_torch.tools.eval_scale_bench",
         *map(str, EVAL_SCALE_ARGS)], cwd=ROOT,
        env=subprocess_env(CUDA_VISIBLE_DEVICES=""), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def phase_eval_scale(card: str, proc: subprocess.Popen, started: float
                     ) -> dict:
    """The evaluation at scale (phase 39): the tool's lines, the native
    library loaded, JAX's JSON keys at EVAL_SCALE_ARGS."""
    t0 = time.monotonic()
    r = finish({"eval_scale": proc})["eval_scale"]
    row = last_json(r[1]) or {}
    emit(phase="eval_scale", card=card, rc=r[0], row=row,
         lines=r[1].splitlines()[:-1], stderr=r[2][-600:] if r[0] else "",
         waited_s=time.monotonic() - t0, seconds=time.monotonic() - started)
    check(r[0] == 0 and set(row) == EVAL_SCALE_KEYS
          and (row["n_images"], row["n_cats"]) == EVAL_SCALE_ARGS
          and r[1].startswith("native kernels: True"),
          f"eval_scale: JAX's keys at {EVAL_SCALE_ARGS}, the native "
          f"library loaded: {row} {r[2][-300:]}")
    return row


# ---------------------------------------------------------------------------
# Phases 40-45: the last of tools/ (the same-process A/Bs, remat headroom,
# the attention microbench and sweeps, bf16 validation, the data-fraction
# sweep), each once at a reduced depth
# ---------------------------------------------------------------------------

AB_STEPS = 3                  # the A/B tools' timed calls a window
AB_DEVICE_CALLS = 1           # device_ms_per_call's calls (the tools': 3)
REMAT_ARGS = (BATCH, 1, RES256_IMG)   # remat_ab's batch, steps, img
# phase 42's child runs beside phases 17, 18 and 21 and their children:
# its allocator may hold this share of the card, so that its walk's
# out-of-memory is its own
REMAT_MEMORY_FRACTION = 0.75
BF16_VALIDATION_ARGS = ("1", "32")    # epochs, img (the tool's: 30, 64)
SWEEP_FRACTIONS = ("0.5", "1.0")
SWEEP_KEYS = {"fraction", "train_loss", "train_miou", "epochs_run",
              "stop_reasons", "loop_img_per_sec_compile_dominated",
              "val_miou", "pq", "ap", "seeds", "lr_override",
              "max_epochs_budget"}


# each new tool's launches in its phase (the kernels line sums them)
tool_launches: dict[str, dict] = {}


def calls_of(steps: int, windows: int = 1) -> int:
    """Calls a tool makes of one timed function: a warm-up and `steps` a
    window, then the device-time calls."""
    return windows * (1 + steps) + AB_DEVICE_CALLS


def finite_ms(tree) -> bool:
    """Every wall time ("...ms" keys but the device's) under `tree` a
    finite float (a difference of two, like `opt_ab`'s segment, may be
    negative: host noise). A device time may be None: `device_ms_per_call`
    returns None where the profiler reported no kernel, and the tools
    print "not measured" there."""
    if isinstance(tree, dict):
        return all(finite_ms(v) if isinstance(v, (dict, list)) else
                   (not k.endswith("ms") or "device" in k
                    or (isinstance(v, float) and math.isfinite(v)))
                   for k, v in tree.items())
    if isinstance(tree, list):
        return all(finite_ms(v) for v in tree)
    return True


def printed(fn) -> tuple:
    """(`fn()`, the lines it printed): a tool's printout goes into its
    phase's line, so that `tools/phase_seconds.py` charges the phase."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn()
    return res, buf.getvalue().splitlines()


def run_tool(phase: str, card: str, name: str, fn, want: dict) -> dict:
    """`fn()` with the launch counters zeroed before it; the launches must
    be `want` (the kernels not named: 0) and every wall and device ms
    finite; prints the phase's line."""
    zero_launches()
    t0 = time.monotonic()
    res, lines = printed(fn)
    launches = tool_launches[name] = kernel_launches()
    emit(phase=phase, card=card, tool=name, lines=lines, results=res,
         launches=launches, seconds=time.monotonic() - t0)
    check(launches == {**dict.fromkeys(counted_wrappers(), 0), **want},
          f"{phase} {name}: launches {launches}, want {want}")
    check(finite_ms(res), f"{phase} {name}: every time finite")
    return res


def phase_ab_tools(card: str) -> dict:
    """Phase 40: `infer_ab`, `plan_ab`, `opt_ab`, `quant_ab`, `conv_ab`,
    `conv_model_ab --train` and `lane_ab` in this process, batch 8, 128 px,
    windows of AB_STEPS calls, one round: each tool's launches of K1 (the
    forwards), K2 and K4 (the steps) counted call by call, finite times;
    `quant_ab`'s int8 arms agree with bf16 above JAX's INT8_AGREE;
    `conv_ab`'s im2col within the bf16 kernel bound TOL of cuDNN's conv at
    every shape; `conv_model_ab`'s conv restored."""
    n, k, d = AB_STEPS, calls_of(AB_STEPS), AB_DEVICE_CALLS
    fwd = {"K1": 6}
    step = {"K2": 6, "K4": 6}

    def times(want, count):
        return {kk: v * count for kk, v in want.items()}

    out = {"infer_ab": run_tool(
        "ab_tools", card, "infer_ab",
        lambda: infer_ab.run(BATCH, steps=n, repeats=1, device_calls=d),
        times(fwd, 2 * k))}
    out["plan_ab"] = run_tool(
        "ab_tools", card, "plan_ab",
        lambda: plan_ab.run(BATCH, n, rounds=1, device_calls=d),
        {**times(fwd, 2 * k), **times(step, 2 * k)})
    out["opt_ab"] = run_tool(
        "ab_tools", card, "opt_ab",
        lambda: opt_ab.run(BATCH, n, rounds=1, device_calls=d),
        times(step, 3 * k))
    # three arms, then their argmax and the static arm's calibration pass
    quant = out["quant_ab"] = run_tool(
        "ab_tools", card, "quant_ab",
        lambda: quant_ab.run(BATCH, steps=n, repeats=1, device_calls=d),
        times(fwd, 3 * k + 3 + 1))
    check(quant["agree"] > INT8_AGREE and quant["agree_static"] > INT8_AGREE,
          f"ab_tools quant_ab: int8 agrees with bf16 above {INT8_AGREE}: "
          f"{quant['agree']}, {quant['agree_static']}")
    rows = out["conv_ab"] = run_tool(
        "ab_tools", card, "conv_ab",
        lambda: conv_ab.run(BATCH, steps=n, repeats=1, device_calls=d),
        {})
    check(len(rows) == len(conv_ab.SHAPES)
          and all(r["rel_err"] <= TOL[torch.bfloat16] for r in rows),
          f"ab_tools conv_ab: im2col within {TOL[torch.bfloat16]} of max|y| "
          f"at every shape: {[r['rel_err'] for r in rows]}")
    before = layers.conv2d
    # forward: the rel-err pair, then the two arms; the step: two arms
    out["conv_model_ab"] = run_tool(
        "ab_tools", card, "conv_model_ab",
        lambda: conv_model_ab.run(BATCH, True, steps=n, rounds=1,
                                  device_calls=d),
        {**times(fwd, 2 + 2 * k), **times(step, 2 * k)})
    check(layers.conv2d is before, "ab_tools conv_model_ab: conv2d restored")
    out["lane_ab"] = run_tool("ab_tools", card, "lane_ab",
                              lambda: lane_ab.run(iters=n, device_calls=d),
                              {})
    return out


def phase_attn_tools(card: str) -> dict:
    """Phase 41: `attn_microbench` (4 shapes), `fwd_sweep` and `bwd_sweep`
    on the committed kernels (`source` only: a variant's nvcc build costs
    more than the phase) at batch 8, bf16: K1 for each forward call, K2 and
    K4 for each gradient call, counted call by call; finite times; the
    sweeps' entry lookup restored."""
    lookup = fk._entry
    out = {"attn_microbench": run_tool(
        "attn_tools", card, "attn_microbench",
        lambda: attn_microbench.run(BATCH, fwd_steps=AB_STEPS,
                                    grad_steps=AB_STEPS, repeats=1,
                                    device_calls=AB_DEVICE_CALLS),
        {"K1": 4 * calls_of(AB_STEPS), "K2": 4 * calls_of(AB_STEPS),
         "K4": 4 * calls_of(AB_STEPS)})}
    out["fwd_sweep"] = run_tool(
        "attn_tools", card, "fwd_sweep",
        lambda: fwd_sweep.run(BATCH, ("source",), steps=AB_STEPS,
                              repeats=1, device_calls=AB_DEVICE_CALLS),
        {"K1": calls_of(AB_STEPS)})
    out["bwd_sweep"] = run_tool(
        "attn_tools", card, "bwd_sweep",
        lambda: bwd_sweep.run(BATCH, ("source",), steps=AB_STEPS,
                              repeats=1, device_calls=AB_DEVICE_CALLS),
        {k: 2 * calls_of(AB_STEPS) for k in ("K2", "K4")})
    check(fk._entry is lookup, "attn_tools: the entry lookup restored")
    return out


def remat_child() -> int:
    """`chip_smoke.py --remat-ab`, phase 42's child: `tools/remat_ab.run`
    at REMAT_ARGS with the launch counters zeroed before it, its allocator
    held to REMAT_MEMORY_FRACTION of the card; prints its result and
    launches (a process of its own, so that the walk's out-of-memory
    leaves no allocator state in the parent)."""
    torch.cuda.set_per_process_memory_fraction(REMAT_MEMORY_FRACTION)
    zero_launches()
    res = remat_ab.run(*REMAT_ARGS, device_calls=AB_DEVICE_CALLS)
    print(json.dumps({"result": res, "launches": kernel_launches()}),
          flush=True)
    return 0


def start_remat() -> subprocess.Popen:
    """Phase 42's child, started before phase 17 (the card's memory is
    shared with phases 17, 18 and 21 and their children, its allocator
    capped)."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--remat-ab"],
        cwd=ROOT, env=subprocess_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def phase_remat(card: str, child: subprocess.Popen, started: float
                ) -> dict:
    """Phase 42: `tools/remat_ab` at 256 px, batch 8 (the cost A/B, then
    the batch walk of each configuration to its first out-of-memory under
    REMAT_MEMORY_FRACTION of the card) in a child process beside phases
    17, 18 and 21: finite step times, K2 and K4 launched (K2 more than K4:
    the remat step runs each block's forward again), no K1; each walk
    found a batch that fits, with its peak memory."""
    t0 = time.monotonic()
    rc, out, err, _ = finish({"remat": child})["remat"]
    row = last_json(out) or {}
    res, launches = row.get("result", {}), row.get("launches", {})
    tool_launches["remat_ab"] = launches
    emit(phase="remat", card=card, rc=rc, args=REMAT_ARGS,
         memory_fraction=REMAT_MEMORY_FRACTION, results=res,
         launches=launches,
         lines=[ln for ln in out.splitlines() if not ln.startswith("{")],
         stderr=err[-2000:] if rc else "", waited_s=time.monotonic() - t0,
         seconds=time.monotonic() - started)
    walks = res.get("headroom", {})
    check(rc == 0 and finite_ms(res.get("cost"))
          and set(walks) == {"plain", "remat"}
          and all(w["fit"] and w["fit"][1]["peak_mb"] > 0
                  for w in walks.values()),
          f"remat: the cost A/B and both walks ran: rc {rc} {res} "
          f"{err[-500:]}")
    check(launches.get("K1") == 0 and launches.get("K3") == 0
          and launches.get("K2", 0) > launches.get("K4", 0) > 0,
          f"remat: K2 and K4 launched, K2 again in the remat steps: "
          f"{launches}")
    return res


def phase_bf16_validation(card: str) -> dict:
    """Phase 43: `tools/bf16_validation.main` at BF16_VALIDATION_ARGS
    (1 epoch, 32 px; the tool's 30 epochs at 64 px run standalone): both
    rows with JAX's keys and finite metrics, K1, K2 and K4 launched, JAX's
    verdict printed (one epoch decides nothing, so it is not held)."""
    zero_launches()
    t0 = time.monotonic()
    res, lines = printed(
        lambda: bf16_validation.main(list(BF16_VALIDATION_ARGS)))
    launches = tool_launches["bf16_validation"] = kernel_launches()
    keys = {"dtype", "train_loss", "miou", "pq", "pq_things", "ap",
            "images_per_sec"}
    emit(phase="bf16_validation", card=card, args=BF16_VALIDATION_ARGS,
         lines=lines, results=res, launches=launches,
         seconds=time.monotonic() - t0)
    check(all(set(res[d]) == keys and all(
              math.isfinite(res[d][k]) for k in keys - {"dtype"})
              for d in ("f32", "bf16")),
          f"bf16_validation: JAX's keys, finite metrics: {res}")
    check(launches["K3"] == 0 and min(launches[k] for k in
                                      ("K1", "K2", "K4")) > 0,
          f"bf16_validation: K1, K2 and K4 launched: {launches}")
    return res


def phase_fraction_sweep(card: str, root: str, work: str,
                         matplotlib: str | None) -> list:
    """Phase 44: `tools/run_fraction_sweep` on the fake COCO layout
    (coco_panoptic, fractions 0.5 and 1.0, 1 epoch, batch 8, one
    validation batch): one row a fraction in sweep_results.jsonl with
    JAX's keys; then `tools/plot_sweep` on it, which draws the PNG or,
    where the host has no matplotlib, raises naming it."""
    zero_launches()
    t0 = time.monotonic()
    rows, lines = printed(lambda: run_fraction_sweep.main([
        "--data-root", root, "--workdir", work, "--fractions",
        *SWEEP_FRACTIONS, "--max-epochs", "1", "--batch-size", str(BATCH),
        "--max-eval-batches", "1", "--lr", "1e-3"]))
    launches = tool_launches["run_fraction_sweep"] = kernel_launches()
    path = os.path.join(work, "sweep_results.jsonl")
    with open(path) as f:
        written = [json.loads(line) for line in f]
    png = os.path.join(work, "sweep.png")
    try:
        lines += printed(lambda: plot_sweep.main([path, png]))[1]
        plot_error = None
    except ModuleNotFoundError as e:
        plot_error = str(e)
    emit(phase="fraction_sweep", card=card, lines=lines, rows=rows,
         launches=launches,
         plot_error=plot_error, png=os.path.exists(png),
         seconds=time.monotonic() - t0)
    check(written == rows and [r["fraction"] for r in rows] == [
              float(f) for f in SWEEP_FRACTIONS]
          and all(set(r) == SWEEP_KEYS for r in rows),
          f"fraction_sweep: one row a fraction with JAX's keys: {rows}")
    check(min(launches[k] for k in ("K1", "K2", "K4")) > 0,
          f"fraction_sweep: K1, K2 and K4 launched: {launches}")
    check(os.path.exists(png) if matplotlib else
          "matplotlib" in (plot_error or ""),
          f"fraction_sweep: plot_sweep draws, or names matplotlib where "
          f"the host has none: {plot_error}")
    return rows


def tools_sum(kernel: str) -> int:
    """`kernel`'s launches over phases 40-44's tools."""
    return sum(v.get(kernel, 0) for v in tool_launches.values())


def kernel_entry(name, source, replaces, launches, err, t, **extra) -> dict:
    return {**extra, "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes_ms"] > t["ops_ms"]
                         else "operations"),
            "library_ms": t["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--safe-export"]:
        return safe_export_child(sys.argv[2])
    if sys.argv[1:2] == ["--export"]:
        return export_child(*sys.argv[2:5])
    if sys.argv[1:2] == ["--remat-ab"]:
        return remat_child()
    t0 = time.monotonic()
    card = phase_device()
    libs = phase_image_io(card)
    kernel = phase_kernel()
    kernel_lse = phase_kernel_lse()
    kernel_bwd = phase_kernel_bwd()
    serving = phase_serving(card)
    totals = phase_times(card, serving)
    phase_op_dispatch(card, serving["runner"],
                      np.stack(serving["images"][:BATCH]))
    del serving
    train = phase_train(card)
    train_totals = phase_train_time(card, train)
    train_launches = train["launches"]
    del train
    loop = phase_loop(card)
    phase_loop_time(card, loop)
    panoptic = phase_panoptic_loop(card, loop)
    instance = phase_instance_loop(card, loop)
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_data_")
    int8_exports = {}
    remat_proc = None
    try:
        t0_layouts = time.monotonic()
        roots = write_fake_layouts(data_dir)
        emit(phase="fake_layouts", card=card,
             seconds=time.monotonic() - t0_layouts,
             classes={k: make_datasets(fake_recipe(n), roots[k])[2]
                      for k, n in (("ade20k", "ade_semantic"),
                                   ("coco", "coco_panoptic"),
                                   ("cityscapes", "city_semantic"))})
        free_card()
        remat_started = time.monotonic()
        remat_proc = start_remat()
        recipe_launches, pan_state = phase_recipes(card, roots)
        phase_predict(card, pan_state, roots, libs["matplotlib"])
        del pan_state
        extras = os.path.join(data_dir, "extras")
        os.makedirs(extras)
        int8_exports = start_int8_exports(extras)
        exported = phase_export(card, extras)
        phase_remat(card, remat_proc, remat_started)
        int8 = phase_int8(card, int8_exports,
                          os.path.join(roots["ade20k"], "images", "training"),
                          exported.pop("live"), exported["bytes"])

        def tool_phases():      # 40, 41 and 43, beside the CLI's stage B
            phase_ab_tools(card)
            phase_attn_tools(card)
            phase_bf16_validation(card)

        phase_cli(card, roots, os.path.join(data_dir, "cli"),
                  libs["matplotlib"], beside=tool_phases)
        phase_data_rate(card, os.path.join(data_dir, "ade512"))
        phase_data_bench(card, os.path.join(data_dir, "ade512"))
        phase_fraction_sweep(card, roots["coco"],
                             os.path.join(data_dir, "sweep"),
                             libs["matplotlib"])
    finally:
        for proc in [p for _, p in int8_exports.values()] + [remat_proc]:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(data_dir, ignore_errors=True)
    dp, parallel = phase_dp_train(card)
    phase_dp_nccl(card)
    pipe = phase_pipeline(card, parallel)
    dp_serve = phase_dp_serve(card)
    tp = phase_tp(card, parallel)
    phase_ring(card, parallel)
    del parallel
    kernel_online = phase_kernel_online()
    kernel_bwd_noclamp = phase_kernel_bwd_noclamp()
    safe = phase_safe(card)
    online_totals = forward_shape_times(
        card, "online_attn_time", fk.flash_fwd_online,
        fk.flash_fwd_online_reference, seed=7, lse=True,
        body=fk.flash_fwd_online_body)
    tools = phase_tools(card)
    res256 = phase_res256(card)
    phase_serve_bench(card)
    phase_serve_breakdown(card, totals["serve"])
    phase_mfu(card, totals["serve"], train_totals["step"], res256)
    eval_started = time.monotonic()
    eval_proc = start_eval_scale()
    try:
        phase_profile(card, totals["serve"], train_totals["step"], res256)
        phase_paritycheck(card)
        phase_training_parity(card)
        phase_breakdowns(card, totals["serve"], train_totals["step"])
        phase_eval_scale(card, eval_proc, eval_started)
    finally:
        if eval_proc.poll() is None:
            eval_proc.kill()
            eval_proc.communicate()
    r256 = res256["kernels"]["sums"]
    # every kernel of the port; K1-K4 times are summed over the six
    # attention shapes (one forward's or one step's launches), K5-K7's are
    # one call at their tool's attn6 inputs (K6: variant D, its repack
    # included; the repack's own line: the two it makes), bf16, batch 8;
    # launches are those of the paths' own runs: 16 served requests (K1),
    # one training step (K2), 16 safe requests and one safe step (K3), one
    # step of each path (K4, clamped then not), the tool mains (K5-K7)
    fwd_src = "maskunet_tpu_torch/csrc/flash_fwd_nomax.cu"
    online_src = "maskunet_tpu_torch/csrc/flash_fwd_online.cu"
    fwd_bodies = {str(c): fk.flash_fwd_nomax_body(c, torch.bfloat16)
                  for c in fk.KERNEL_CHANNELS}
    online_bodies = {str(c): fk.flash_fwd_online_body(c, torch.bfloat16)
                     for c in fk.KERNEL_CHANNELS}
    kernels = [
        kernel_entry("flash_fwd_nomax", fwd_src,
                     "maskunet_tpu/ops/flash_attention.py:164",
                     totals["launches"], kernel["max_abs_err"], totals,
                     bodies_bf16=fwd_bodies, launches_loop=loop["K1"],
                     launches_panoptic=panoptic["K1"],
                     launches_instance=instance["K1"],
                     launches_recipes=recipe_launches["K1"],
                     launches_export=exported["K1"],
                     launches_int8=int8["K1"], launches_dp=dp["K1"],
                     launches_pipeline=pipe["K1"],
                     launches_dp_serve=dp_serve["K1"],
                     launches_tp=tp["K1"],
                     launches_res256=res256["inference"]["launches"]["K1"],
                     launches_tool_phases=tools_sum("K1"),
                     res256_ms=r256["K1"]["ms"],
                     res256_bound_ms=r256["K1"]["bound_ms"]),
        kernel_entry("flash_fwd_nomax_lse", fwd_src,
                     "maskunet_tpu/ops/flash_attention.py:267",
                     train_launches["K2"], kernel_lse["max_abs_err"],
                     train_totals["K2"], bodies_bf16=fwd_bodies,
                     launches_loop=loop["K2"],
                     launches_panoptic=panoptic["K2"],
                     launches_instance=instance["K2"],
                     launches_recipes=recipe_launches["K2"],
                     launches_dp=dp["K2"], launches_pipeline=pipe["K2"],
                     launches_dp_serve=0, launches_tp=tp["K2"],
                     launches_res256=res256["train"]["launches"]["K2"],
                     launches_tool_phases=tools_sum("K2"),
                     res256_ms=r256["K2"]["ms"],
                     res256_bound_ms=r256["K2"]["bound_ms"]),
        kernel_entry("flash_fwd_online", online_src,
                     "maskunet_tpu/ops/flash_attention.py:111",
                     safe["K3"], kernel_online["max_abs_err"], online_totals,
                     bodies_bf16=online_bodies,
                     launches_export_safe=exported["K3"]),
        kernel_entry("flash_bwd", "maskunet_tpu_torch/csrc/flash_bwd.cu",
                     "maskunet_tpu/ops/flash_attention.py:323",
                     train_launches["K4"] + safe["K4"],
                     max(kernel_bwd["max_abs_err"],
                         kernel_bwd_noclamp["max_abs_err"]),
                     train_totals["K4"],
                     bodies_bf16={str(c): fk.flash_bwd_body(c, torch.bfloat16)
                                  for c in fk.KERNEL_CHANNELS},
                     launches_loop=loop["K4"],
                     launches_panoptic=panoptic["K4"],
                     launches_instance=instance["K4"],
                     launches_recipes=recipe_launches["K4"],
                     launches_dp=dp["K4"], launches_pipeline=pipe["K4"],
                     launches_dp_serve=0, launches_tp=tp["K4"],
                     launches_res256=res256["train"]["launches"]["K4"],
                     launches_tool_phases=tools_sum("K4"),
                     res256_ms=r256["K4"]["ms"],
                     res256_bound_ms=r256["K4"]["bound_ms"]),
        kernel_entry("old_flash_fwd", online_src, "tools/softmax_ab.py:29",
                     tools["K5"]["launches"], tools["K5"]["max_abs_err"],
                     tools["K5"], bodies_bf16={"64": online_bodies["64"]}),
        kernel_entry("nomax65_fwd", fwd_src, "tools/softmax_ab.py:157",
                     tools["K6"]["launches"], tools["K6"]["max_abs_err"],
                     tools["K6"], bodies_bf16={"64": "wgmma"},
                     library_c65_ms=tools["K6"]["library_c65_ms"]),
        kernel_entry("repack65", fwd_src, "tools/softmax_ab.py:157",
                     tools["K6_repack"]["launches"],
                     tools["K6_repack"]["max_abs_err"], tools["K6_repack"]),
        kernel_entry("flash_fwd_bf16", online_src,
                     "tools/bf16_softmax_experiment.py:32",
                     tools["K7"]["launches"], tools["K7"]["max_abs_err"],
                     tools["K7"], bodies_bf16={"64": online_bodies["64"]}),
    ]
    emit(phase="done", seconds=time.monotonic() - t0, failures=failures)
    if failures:
        print(f"chip_smoke: {len(failures)} failure(s): {failures}",
              file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
