#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``contrad_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--out results.json] [--fused_act_only]

Phases, in order; any failure ends the run with a non-zero exit code and no
result line:

1. the card's name and power limit (``nvidia-smi``);
2. build the hand-written CUDA blur kernel (``contrad_tpu_torch/csrc``) from
   the sources beside this script, and time the build; then the fused
   activation's kernel;
3. hold the blur kernel to its plain PyTorch version at every (shape, pad)
   that a train step of either StyleGAN2 path gives it, forward and
   adjoint (the 32x32 recipe at batch 64, the 512x512 recipe at batch 16),
   each with its launches per step on each path, and that the 32x32 run's
   evaluation gives it (the probe's D forward at batch 256 and its shorter
   last test batch, cDDLS's G and D forward and adjoint at batch 100 and
   its final sample, sampling's G forward at batch 500, the in-loop FID
   sampler's EMA G forward at its chunk of 512 and the progress GIF's at
   its 16 latents), each with its launches per call, in float32 (TF32 off)
   and
   bfloat16, forward, backward and double backward (the kernel through its
   autograd ``Function``, the plain version as three forward calls); then
   time the kernel (L2 warm and cold, float32 and bfloat16), the plain
   version and a depthwise ``F.conv2d`` (a yardstick the port never calls)
   at those shapes, beside the least time the card could take; sum the
   kernel's times weighted by launches per step on each path; time the
   wrapper's host cost per call;
4. the first slice's path: 6 train steps of the StyleGAN2 + ContraD recipe
   (``contrad_tpu_torch.train_stylegan2``: ``stylegan2`` at full width,
   batch 64, R1 every step) on synthetic 32x32 data, with the kernel's
   launch counts set to 0 just before and read just after; losses must be
   finite, every kernel must have launched, as often per step as phase 3
   counts, and never on its scalar path; then a torch.profiler breakdown
   of three more steps (device time by kernel, idle share);
5. G and D forwards on the card against the same modules on the CPU (plain
   versions) on a small input;
6. the SNDCGAN + ContraD flagship, which runs no hand-written kernel (its
   TPU version reached no Pallas kernel): 6 steps of
   ``python -m contrad_tpu_torch.train_gan`` with the README recipe
   (``c10_b512.toml sndcgan --mode contrad --aug simclr --use_warmup``,
   full width, batch 512), 3 of the README's ``std`` baseline
   (``c10_b64.toml``, batch 64) and 3 of the flagship's recipe with the
   ``snresnet18`` D, on synthetic 32x32 data, with the blur's launch count
   set to 0 just before each and read just after (it must stay 0); losses
   must be finite; ms/step, img/s and peak memory; then a torch.profiler
   breakdown of 3 flagship steps (kernel time by class, the 25 largest
   kernels, the idle share, launches per step); then one flagship
   ``GANTrainer`` step on the card against the same step on the CPU (same
   weights and draws, TF32 off, batch 64): losses, parameters, spectral
   norm's ``u`` and the batch-norm statistics;
7. the 512x512 AFHQ recipe, this slice's path: 17 steps of
   ``python -m contrad_tpu_torch.train_stylegan2_contraD`` with the README
   command (``afhq_dog_style64.toml stylegan2_512``, ``simclr_hq``, lazy
   R1 every 16 steps, so step 16 carries it) on synthetic 512x512 data at
   batch 16, full width and depth, with the blur's launch counts set to 0
   just before and read just after: finite losses, launches as phase 3
   counts them for 16 plain steps and one R1 step, none on the scalar
   path; ms per plain step and for the R1 step, img/s, peak memory; a
   torch.profiler breakdown of 3 plain steps (as phase 6's, with the blur's
   ms beside phase 3's launch-weighted sum); then one step of the recipe's
   trainer at batch 4 with R1 on the card against the CPU (same weights,
   images and draws, TF32 off): losses and both phases' gradients, each
   within 1e-4 + 1e-4 * max of the CPU's, with the card taking the CPU's
   branch at every leaky-ReLU element where the two devices' branches
   differ, each such pre-activation read on both devices and within that
   tolerance of 0 (the card's own branches reported beside);
8. the evaluation path, its runs written under a temporary directory (the
   FID reference statistics too): the conditional flagship (``train_gan
   ... --conditional``, batch 512) on labelled synthetic data for 6 steps
   with ``--evaluate_every 3 --save_every 6 --fid_embed moments
   --n_eval_avg 3`` at the config's ``fid_size`` of 10,000 (ms/step, img/s
   and peak memory beside phase 6's; each checkpoint's size and seconds;
   one finite CSV row an evaluation, ``ckpt/best.pt`` at the best score,
   one GIF frame an evaluation, seconds an evaluation), its state restored
   from ``step_6`` equal to the file bitwise on the card, and ``--resume``
   to step 9 (the first resumed step must be 7; the FID history, best and
   ``eval_seed`` restored, the CSV and GIF growing); on that run the
   linear probe (2 epochs at batch 256: seconds an epoch, train and test
   accuracy), 1,000 samples and cDDLS on ``best`` (20 steps, 5,000 samples
   at batch 500: ms a Langevin step, samples/s), no blur launch allowed;
   then phase 4's recipe for 6 steps evaluating as the flagship at steps 3
   and 6 (FID of the EMA G), the blur launching in each evaluation exactly
   as phase 3 counts, and on it the probe (1 epoch), 1,000 samples from
   the EMA G and cDDLS on ``best`` (10 steps at batch 100), the blur
   launching exactly as phase 3 counts per call; then card against CPU
   (TF32 off): one conditional flagship step at batch 64 (losses,
   parameters, ``u``, batch-norm statistics), and on each run's weights one
   probe step and 3 Langevin steps;
9. the FID InceptionV3 with random weights from a numpy seed: card against
   CPU (TF32 off) at batch 2 on 32x32, 299x299 and 512x512 inputs, pool3
   and logits; its forward timed at batch 500 on 32x32 and 512x512 inputs
   (TF32 convs as in training): ms, img/s and TFLOP/s, beside TF32 off,
   NCHW layout and cuDNN's autotuner at 32x32, and a profile of it (kernel
   time by class); then ``test_fid_is --embed moments`` on phase 8's
   StyleGAN2 samples;
10. mixed precision: each README recipe (the flagship at batch 512, the
   32x32 StyleGAN2 recipe at 64, the 512x512 recipe at 16 for 17 steps,
   step 16 with R1) through its CLI in float32 and under the production
   stack ``--dtype bf16 --opt_moments bf16 --opt_nu bf16 --opt_grads bf16``,
   in turns (f32, bf16, f32, bf16): ms/step, img/s, peak memory and the
   512x512 R1 step, the blur launching in every run exactly as phase 3
   counts (its bfloat16 rows), never on its scalar path, finite losses; a
   torch.profiler breakdown of 3 bfloat16 512x512 steps by class beside
   phase 7's float32 one; then a bfloat16 flagship step (batch 64) and a
   bfloat16 512x512 step with R1 (batch 4) card against CPU (TF32 off) at
   the CPU parity test's tolerance (``tests/test_torch_port_bf16_step.py``:
   losses within 3e-2, each gradient tensor's cosine at least 0.99 or
   bfloat16's own float32 distance);
11. the graph path (``--steps_per_dispatch``: a block of 4 steps as 4
   replays of the step's CUDA graphs, one graph per step kind, plain and
   lazy R1; ``contrad_tpu_torch/training/graph.py``) for each README
   recipe at full width (the flagship at batch 512, the 32x32 StyleGAN2
   recipe at 64, the 512x512 recipe at 16): from one snapshot of the
   trainer, two blocks as graph replays, the same steps eagerly, and eagerly
   again, with cuDNN deterministic, every tensor of the state (parameters,
   Adam's moments and counts, ``u``, batch-norm statistics, EMA, the
   generator's state) and the metrics held bitwise where the two eager runs
   agree bitwise, else within twice their distance and 1e-4 + 1e-4 * max,
   the generator's state bitwise, the blur launching through the replays as
   phase 3 counts (the 512x512 run's lazy R1 at step 16, inside its second
   block; float32, and the 512x512 recipe also under the bf16 stack); a
   graph run through each CLI checkpointed at step 4 and resumed to 8, held
   to the uninterrupted one in the same way; each recipe through its CLI
   eager (``--steps_per_dispatch 1``) and as graphs (``4``) in turns
   (eager, graph, eager, graph), float32 and the bf16 stack, printed every
   4 steps: ms/step, img/s, peak memory, capture seconds, the 512x512 R1
   step, the blur launching as phase 3 counts (warm-up steps included),
   never on its scalar path, and a profile of one eager and one graph
   block of plain steps (kernel time by class, idle share); the colour
   jitter's two orders against one and Adam's device-side schedule, timed,
   and its bias corrections on the card against the CPU's, the earlier
   host formula's and the correctly rounded ones; ``--trace_steps 2`` on
   the 32x32 recipe writing one trace file of graph replays at K = 4 with
   the step's phase marks (``utils/trace.py``);
12. data parallelism over processes (``--multihost``,
   ``contrad_tpu_torch/parallel``): (a) each README recipe at full width
   (the flagship at batch 512, the 32x32 StyleGAN2 recipe at 64, the
   512x512 recipe at 16) through its CLI as 8 steps in graph blocks of 4,
   without a world in this process and as an NCCL world of one (a process
   of its own, ``hostenv.spawn_world``), cuDNN deterministic in both: every
   tensor of the step-8 checkpoints and every logged metric bitwise equal,
   the collectives captured in the graphs (calls and bytes a step), the
   graph step's ms in the world against without, the blur launching alike;
   (b) the same three recipes as a gloo world of two on the one card
   (``parallel/_mh_worker.py``: 256, 32 and 8 rows a rank, 4 eager steps,
   2 at 512x512 with R1 in the second) against the recipe in this process
   without a world, TF32 off: step 1's losses and gradients (taking world
   1's leaky-ReLU branch at every pre-activation within 2e-4 of 0, as phase
   7 takes the CPU's) and the parameters after the last step within 1e-4 +
   1e-4 * max, every tensor bitwise
   equal across the ranks, the blur launching on each rank as a world-1
   step does (phase 3's counts); per-rank ms/step and the collectives'
   share; which collectives gloo takes on CUDA tensors;
13. the data paths (``contrad_tpu_torch/data``), cuDNN deterministic: (a)
   the 512x512 recipe (batch 16) and the flagship (batch 512) through their
   CLIs, 8 steps each, host-fed (``DeviceBatchIterator.MAX_BYTES`` below
   the set: ``PrefetchIterator`` over ``BatchIterator``, pinned copies on a
   side stream) and device-resident, eager, and device-resident as graph
   blocks of 4: every tensor of the step-8 checkpoints bitwise equal
   between the loaders, the blur launching as phase 3 counts (warm-up
   steps included); ms/step of each, the prefetch worker's
   gather and copy ms and the step's wait per batch, and a profile of 3
   host-fed steps (idle share); (b) the native gather (``data/native.py``)
   against ``np.take`` at 16 and 64 rows of 512x512 and 512 rows of 32x32,
   bitwise, with MB/s of each and of the pinned host-to-card copy; (c) the
   sharded path as a gloo world of two on the one card
   (``parallel/_mh_worker.py --max_bytes``: one chunk a rank, rotated round
   the ring at each epoch boundary): the 512x512 recipe on 32 rows (shards
   of 16, 8 rows a rank a step: 2 steps an epoch) for 3 steps and the
   32x32 StyleGAN2 recipe on 512 rows for 10, each crossing one rotation:
   every batch bitwise the dataset rows the stream names, each rank's
   shard bitwise its chunk (its neighbour's after the rotation) in storage
   that never moves, and the world's steps held to world 1 fed the same
   global batches (``--feed_world 2``) under phase 12b's rule;
14. the packed layout (``ops/packed.py``, the JAX package's space-to-depth
   form of the 512x512 model's shallow levels): each layer of those levels
   at the 512x512 recipe's batches (D at 48 rows in the D phase and 16 in
   the G phase, G at 16) as the port runs it and packed (D's
   ``block_512.conv1``, ``conv2`` and ``skip``, ``block_256.conv1`` and
   the FromRGB stem; G's top 3x3 conv, its upsampling conv into 512x512
   and ToRGB with the skip upsample), the blurred downsampling convs also
   blur-folded as JAX runs them unpacked, and the packed path's boundary
   copies beside the folded 2x2 stride-2 stem: first every variant's
   output and input gradients against the port's on the card in float32
   (TF32 off), and with its weight gradient in float64 (the blur's plain
   version), each within 1e-4 + 1e-4 * max; then forward, input
   gradient and weight gradient timed as CUDA-graph replays (best of 3),
   float32 with TF32 convs and bfloat16, each beside its byte bound at
   3.35 TB/s and its FLOPs; the rows weighted by the times a 512x512
   plain step runs each, and the verdict: ``port`` where the packed rows
   with the copies save more than 2 % of phase 11's 512x512 plain graph
   step in either dtype, else ``close``;
15. the model variants that no registry architecture builds
   (``ResidualDiscriminator``, ``SkipDiscriminator``, G with
   ``input_is_latent``, ``return_latents`` and ``mean_latent``, the
   SNDCGAN D with its linear head (``mlp_linear=False``) with and without
   labels, ``NullDiscriminator``), at StyleGAN2 32x32's and the flagship's
   widths, on the card against the CPU (TF32 off, within 1e-4 + 1e-4 *
   max, the card taking the CPU's leaky-ReLU branches as in phase 7),
   spectral norm's ``u`` too, the blur kernel launching once forward and
   once in the adjoint per blur of each StyleGAN2 D and once per
   upsampling blur of each G forward;
16. the quality runbook's dry run (``contrad_tpu_torch/tools/
   quality_run.sh`` with ``DATASET=synthetic_32 EMBED=moments``, the
   flagship at batch 512 for 20 steps evaluating FID@1000 at 10 and 20):
   exit 0 and a finite best FID from its trajectory; then
   ``precalc_stats --images`` on 256 PNGs that the phase writes, with the
   InceptionV3 on phase 9's random weights, on the card against the CPU;
17. the fused bias + leaky ReLU + gain kernel (``csrc/fused_act.cu``) at
   the 512x512 recipe's largest activated shapes, in both memory layouts,
   and the style MLP's: modes act and grad (and grad with the gradient in
   the other layout) against the plain op (out and dx bitwise, the bias
   gradient within 1e-5 of sum|dx| of its float64 sum), then timed as
   CUDA-graph replays beside the plain op's three kernels each way and the
   byte bound; then its launches (and the blur's) in one eager step of
   each kind of the 512x512 recipe at batch 16 and the 32x32 recipe at
   batch 64, none on the scalar path. ``--fused_act_only`` runs phases 1,
   2 and 17 alone.

Then it prints the whole run's time, the kernel table as one JSON line,
the card's name and power limit, and, last, ``{"ok": true, "device":
{...}}``. It needs the repository around it and exits non-zero where no
CUDA card is present.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s
# and float32 FLOP/s outside the tensor cores (the blur's arithmetic).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# max |kernel - plain| allowed: float32 sums of 4 + 4 taps in another
# order; bfloat16 output rounded once from float32 in both, one ulp apart
# at most (2^-7 relative).
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 8e-3)}  # (atol, rtol)
MODEL_TOL = (1e-4, 1e-4)  # card vs CPU, float32 convs in other orders
COLD_BYTES = 120e6  # inputs rotated per cold timing: over twice the 50 MB L2
RECIPE = ["configs/gan/stylegan2/c10_style64.toml", "stylegan2",
          "--mode", "contrad", "--aug", "simclr", "--lbd_r1", "0.1",
          "--no_lazy", "--halflife_k", "1000", "--use_warmup"]
BATCH = 64
STEPS = 6  # the first is warm-up: the step time is the mean of the others
# the README's 512x512 AFHQ recipe, on synthetic 512x512 data at batch 16
# (the config's 64 was a multi-GPU batch); the recipe's lazy R1 comes every
# 16 steps, so step 16 of 17 carries it
RECIPE_512 = ["configs/gan/stylegan2/afhq_dog_style64.toml", "stylegan2_512",
              "--mode", "contrad", "--aug", "simclr_hq", "--lbd_r1", "0.5",
              "--halflife_k", "20", "--use_warmup", "--evaluate_every", "5000",
              "--n_eval_avg", "1", "--no_gif"]
BATCH_512 = 16
STEPS_512 = 17
DATA_512 = "synthetic_512"
# the README's SNDCGAN recipes (batch from the config), synthetic data
FLAGSHIP = ["configs/gan/cifar10/c10_b512.toml", "sndcgan", "--mode",
            "contrad", "--aug", "simclr", "--use_warmup"]
GAN_BASELINE = ["configs/gan/cifar10/c10_b64.toml", "sndcgan", "--mode", "std"]
SNRESNET = ["configs/gan/cifar10/c10_b512.toml", "snresnet18", "--mode",
            "contrad", "--aug", "simclr", "--use_warmup"]
GAN_LOSSES = ("D_loss", "D_penalty", "D_real", "D_gen", "G_loss")
# phase 8: the evaluation path, on labelled synthetic data (10 classes)
EVAL_DATA = "synthetic_32_10000"
EVAL_TEST = 2000  # its test split: max(512, min(10000 // 5, 10000)) images
PROBE_BATCH = 256  # test_lineval's default batch
CDDLS_BATCH = 500  # test_gan_sample_cddls's default batch (SNDCGAN run)
CDDLS_BATCH_SG2 = 100  # the StyleGAN2 run's chains
SAMPLE_BATCH = 500  # test_gan_sample's default batch
FID_SIZE = 10000  # the configs' fid_size (c10_b512, c10_style64)
FID_CHUNK = min(512, FID_SIZE)  # the FID sampler's batch_per_call
FID_AVG = 3  # --n_eval_avg
GIF_LATENTS = 16  # the progress GIF's fixed latents


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(msg: str) -> None:
    """A phase's header, with the seconds since the run started."""
    log(f"{msg} (at {time.perf_counter() - T0:.1f} s)")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ blur

def blur_cases():
    """Every (shape, pad, upsample factor) the blur kernel takes in one train
    step of each StyleGAN2 path, with its launches per step on each path
    (``per_step``: ``stylegan2_32``, R1 every step; ``stylegan2_512`` and
    ``stylegan2_512_r1``, the 512x512 recipe's plain step and its lazy-R1
    step). Per path: G's post-upsample blurs (x4 taps, pads (1, 1), on the
    conv-transpose's (2s + 1)-square output), once forward and once as the
    adjoint, at the G phase's batch; D's two downsample blurs per ResBlock
    (3x3 conv2: pads (2, 2); 1x1 skip: pads (1, 1)) on each block's input
    size and channels, once each way at the D phase's batch (3 x batch: the
    real, real, fake of contrad), and at the batch once each way in the G
    phase, and twice more each way in a step with R1 (R1's D pass and its
    double backward). Each adjoint is a row of its own: the gradient's
    shape, the reversed taps, the complementary pads (k - 1 - pad0,
    k - 1 - pad1). 32x32 (small32 channels {32: 128, 16: 256, 8: 512}, batch
    64): 54 launches a step. 512x512 (``stylegan2_channels(1.0)``, batch
    16): 70 a plain step, 126 an R1 step."""
    fwd = []
    ch = {8: 512, 16: 256, 32: 128}
    fwd += [("G 32", (BATCH, 2 * s + 1, 2 * s + 1, ch[2 * s]), (1, 1), 2,
             {"stylegan2_32": 1}) for s in (4, 8, 16)]
    for n, per_step in ((BATCH, 3), (3 * BATCH, 1)):
        for s in (32, 16, 8):
            fwd += [("D 32", (n, s, s, ch[s]), pad, 1,
                     {"stylegan2_32": per_step}) for pad in ((2, 2), (1, 1))]
    ch = {s: min(512, 16384 // s) for s in (8, 16, 32, 64, 128, 256, 512)}
    fwd += [("G 512", (BATCH_512, 2 * s + 1, 2 * s + 1, ch[2 * s]), (1, 1), 2,
             {"stylegan2_512": 1, "stylegan2_512_r1": 1})
            for s in (4, 8, 16, 32, 64, 128, 256)]
    for n, plain, r1 in ((3 * BATCH_512, 1, 1), (BATCH_512, 1, 3)):
        for s in (512, 256, 128, 64, 32, 16, 8):
            fwd += [("D 512", (n, s, s, ch[s]), pad, 1,
                     {"stylegan2_512": plain, "stylegan2_512_r1": r1})
                    for pad in ((2, 2), (1, 1))]
    cases = []
    for who, shape, pad, up, per_step in fwd:
        cases.append(dict(who=who, shape=shape, pad=pad, up=up,
                          per_step=per_step, adjoint=False))
    for who, (n, h, w, c), pad, up, per_step in fwd:
        cases.append(dict(who=who + " adj", shape=(n, h + sum(pad) - 3,
                                                   w + sum(pad) - 3, c),
                          pad=(3 - pad[0], 3 - pad[1]), up=up,
                          per_step=per_step, adjoint=True))
    return cases


def eval_blur_cases(probe_batch: int = PROBE_BATCH,
                    probe_tail: int = EVAL_TEST % PROBE_BATCH,
                    cddls_batch: int = CDDLS_BATCH_SG2,
                    sample_batch: int = SAMPLE_BATCH,
                    fid_batch: int = FID_CHUNK, gif_batch: int = GIF_LATENTS):
    """The blur's (shape, pad, upsample factor) cases on the evaluation
    path of a 32x32 StyleGAN2 run, with its launches per call
    (``per_step``): ``lineval_32``, a probe step or a full test batch (D's
    six downsample blurs forward, no gradient); ``lineval_32_tail``, the
    test set's last, shorter batch; ``cddls_32``, a Langevin step (G's three
    upsample blurs and D's six, forward and adjoint, the adjoint rows
    derived as in :func:`blur_cases`); ``cddls_32_final``, a chain's final
    sample (G forward); ``sample_32``, a batch of ``test_gan_sample`` (G
    forward); ``fid_32``, a chunk of the in-loop FID sampler (the EMA G
    forward at ``batch_per_call``); ``gif_32``, a frame of the progress GIF
    (G forward on the 16 fixed latents). 6, 6, 18, 3, 3, 3 and 3 launches a
    call. ``tests/test_torch_port_blur.py`` holds them to what the port's
    models launch."""
    ch = {8: 512, 16: 256, 32: 128}

    def g(who, n, per_call):
        return [(who, (n, 2 * s + 1, 2 * s + 1, ch[2 * s]), (1, 1), 2,
                 per_call) for s in (4, 8, 16)]

    def d(who, n, per_call):
        return [(who, (n, s, s, ch[s]), pad, 1, per_call)
                for s in (32, 16, 8) for pad in ((2, 2), (1, 1))]

    fwd = d("D probe", probe_batch, {"lineval_32": 1})
    if probe_tail:
        fwd += d("D tail", probe_tail, {"lineval_32_tail": 1})
    chain = (g("G cddls", cddls_batch, {"cddls_32": 1, "cddls_32_final": 1})
             + d("D cddls", cddls_batch, {"cddls_32": 1}))
    fwd += chain + g("G sample", sample_batch, {"sample_32": 1})
    fwd += g("G fid", fid_batch, {"fid_32": 1}) + g("G gif", gif_batch,
                                                     {"gif_32": 1})
    cases = [dict(who=who, shape=shape, pad=pad, up=up, per_step=per_call,
                  adjoint=False) for who, shape, pad, up, per_call in fwd]
    for who, (n, h, w, c), pad, up, _ in chain:
        cases.append(dict(who=who + " adj", shape=(n, h + sum(pad) - 3,
                                                   w + sum(pad) - 3, c),
                          pad=(3 - pad[0], 3 - pad[1]), up=up,
                          per_step={"cddls_32": 1}, adjoint=True))
    return cases


def per_step_launches(cases, path: str) -> int:
    return sum(c["per_step"].get(path, 0) for c in cases)


def fmt_per_step(per_step) -> str:
    return "x" + ",".join(f"{n} {path.replace('stylegan2_', '')}"
                          for path, n in per_step.items())


def case_taps(case):
    from contrad_tpu_torch.ops.upfirdn2d import blur_taps, make_kernel

    taps = blur_taps(make_kernel([1, 3, 3, 1]), case["up"])
    if case["adjoint"]:
        taps = tuple(tuple(reversed(t)) for t in taps)
    return taps


def cuda_ms(fn, inputs, iters: int = 30, graph: bool = False) -> float:
    """Mean ms of ``fn(inputs[i % len(inputs)])`` over ``iters`` calls in a
    row (CUDA events), after a warm-up; one input is the warm-L2 time,
    enough of them to overflow L2 the cold one. With ``graph`` the calls
    are captured once in a CUDA graph and the graph is replayed, so the time
    is the device's and not the host's rate of issuing launches (a blur
    call costs the host more than a small blur costs the card)."""
    import torch

    iters = max(iters, len(inputs))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(inputs[i % len(inputs)])
    torch.cuda.current_stream().wait_stream(side)

    def calls():
        for i in range(iters):
            fn(inputs[i % len(inputs)])

    run = calls
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            calls()
        run = g.replay
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copy_bandwidth() -> float:
    """Device-to-device copy rate in bytes/s (read + write), this card."""
    import torch

    a = torch.empty(1 << 28, dtype=torch.uint8, device="cuda")
    b = torch.empty_like(a)
    ms = cuda_ms(lambda src: b.copy_(src), [a], iters=20)
    return 2 * a.numel() / (ms * 1e-3)


def plain_derivatives(blur, x, g, hh, taps, pad):
    """The plain version's forward, backward and double backward of the blur
    at ``x``, as three forward calls without autograd: ``y = blur(x)``; the
    backward ``blur^T(g)``, a blur of ``g`` with the reversed taps and the
    complementary pads ``(k - 1 - pad0, k - 1 - pad1)``; and the double
    backward ``d<blur^T(g), hh>/dg = blur(hh)``. ``tests/test_torch_port_
    blur.py`` holds them to autograd through the plain version."""
    import torch

    k = len(taps[0])
    adjoint = tuple(tuple(reversed(t)) for t in taps)
    with torch.no_grad():
        return (blur.blur2d_plain(x, *taps, pad),
                blur.blur2d_plain(g, *adjoint, (k - 1 - pad[0], k - 1 - pad[1])),
                blur.blur2d_plain(hh, *taps, pad))


def kernel_derivatives(blur, x, g, hh, taps, pad):
    """The same three through the kernel's autograd ``Function``: the
    forward, then ``torch.autograd.grad`` once and twice, as R1 takes
    them."""
    import torch

    xx = x.clone().requires_grad_(True)
    gg = g.clone().requires_grad_(True)
    y = blur.blur2d(xx, *taps, pad)
    (gx,) = torch.autograd.grad(y, xx, gg, create_graph=True)
    (g2,) = torch.autograd.grad(gx, gg, hh)
    return y.detach(), gx.detach(), g2


def check_blur(blur, cases) -> float:
    """Kernel vs plain version in float32 and bfloat16, forward, backward
    and double backward, at every case; returns the largest float32
    error."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for case in cases:
        shape, pad = case["shape"], case["pad"]
        taps = case_taps(case)
        n, h, w, c = shape
        k = len(taps[0])
        out_shape = (n, h + sum(pad) - k + 1, w + sum(pad) - k + 1, c)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            atol, rtol = TOL[name]
            x, g, hh = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                        for s in (shape, out_shape, shape))
            got = kernel_derivatives(blur, x, g, hh, taps, pad)
            want = plain_derivatives(blur, x, g, hh, taps, pad)
            torch.cuda.synchronize()
            for what, a, b in zip(("fwd", "bwd", "2nd"), got, want):
                err = float((a.float() - b.float()).abs().max())
                limit = float(atol + rtol * b.float().abs().max())
                log(f"  blur {name:8s} {what} {case['who']:6s} "
                    f"{str(shape):20s} pad {pad} up {case['up']}: max|err| "
                    f"{err:.3e} (tol {limit:.3e})")
                if not err <= limit:
                    raise AssertionError(
                        f"blur kernel disagrees with its plain version: "
                        f"{name} {what} {shape} pad {pad}: {err} > {limit}")
                worst[name] = max(worst[name], err)
            del x, g, hh, got, want
    return worst["float32"]


def time_blur(blur, cases, copy_bps: float):
    """Per case and dtype: the kernel with L2 warm (one input) and cold
    (inputs rotated through more than twice L2), the fastest depthwise
    ``F.conv2d`` (channels-last view or NCHW-contiguous copy, the copy
    untimed), each as CUDA-graph replays; the plain version (float32, eager:
    it makes its tap tensors on the host every call); the path the kernel
    took; and the least time the card could take (bytes at the published HBM
    rate, or float32 operations, whichever is larger). Each measurement is
    about 20 ms of the kernel's device work: 3-30 calls, fewer for the
    yardstick and the plain version, which take 5-50 times as long."""
    import torch
    import torch.nn.functional as F

    rows = []
    for case in cases:
        shape, pad = case["shape"], case["pad"]
        taps_v, taps_h = case_taps(case)
        k = len(taps_v)
        n, h, w, c = shape
        ho, wo = h + pad[0] + pad[1] - k + 1, w + pad[0] + pad[1] - k + 1
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            item = dtype.itemsize
            x = torch.randn(shape, device="cuda").to(dtype)
            cold = [x] + [torch.randn_like(x) for _ in range(
                max(1, math.ceil(COLD_BYTES / x.nbytes)) - 1)]
            plan = blur.launch_plan(shape, k, pad, dtype)
            if not plan.vector:
                raise AssertionError(f"main-path shape {shape} took the "
                                     f"scalar path")
            # about 20 ms of device work per measurement (at least 3 calls,
            # at most 30): the largest rows take a millisecond a call, the
            # plain version fifty times the bound
            nbytes = item * n * c * (h * w + ho * wo)
            bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            iters = max(3, min(30, round(20 / (1.5 * bytes_ms))))
            ms = cuda_ms(lambda a: blur.blur2d(a, taps_v, taps_h, pad), [x],
                         iters=iters, graph=True)
            cold_ms = cuda_ms(lambda a: blur.blur2d(a, taps_v, taps_h, pad),
                              cold, iters=iters, graph=True)
            del cold
            w2d = torch.outer(torch.tensor(taps_v), torch.tensor(taps_h))
            w2d = w2d[None, None].expand(c, 1, k, k).contiguous().to(
                "cuda", dtype)
            x_cl = x.permute(0, 3, 1, 2)  # channels_last view, no copy
            x_nchw = x_cl.contiguous()
            assert pad[0] == pad[1]
            library_ms = min(cuda_ms(lambda a: F.conv2d(
                a, w2d, padding=pad[0], groups=c), [xx],
                iters=max(3, iters // 3), graph=True)
                for xx in (x_cl, x_nchw))
            del x_nchw
            plain_ms = (cuda_ms(lambda a: blur.blur2d_plain(
                a, taps_v, taps_h, pad), [x], iters=max(3, iters // 10))
                if dtype == torch.float32 else None)
            flops = 2 * k * n * c * ho * (w + pad[0] + pad[1] + wo)
            flops_ms = 1e3 * flops / F32_FLOP_PER_S
            bound_ms = max(bytes_ms, flops_ms)
            rows.append(dict(
                who=case["who"], shape=list(shape), pad=list(pad),
                up=case["up"], per_step=case["per_step"], dtype=name,
                path="vector" if plan.vector else "scalar", ms=ms,
                cold_ms=cold_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bytes=nbytes, flops=flops,
                bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                copy_bound_ms=1e3 * nbytes / copy_bps))
            plain = "" if plain_ms is None else f", plain {plain_ms:.4f} ms"
            log(f"  blur {name:8s} {case['who']:9s} {str(shape):20s} pad "
                f"{pad} up {case['up']} {fmt_per_step(case['per_step'])} "
                f"[{rows[-1]['path']}]: kernel {ms:.4f} ms warm, "
                f"{cold_ms:.4f} cold, bound {bound_ms:.4f} ms "
                f"({100 * bound_ms / ms:.0f} % warm, "
                f"{100 * bound_ms / cold_ms:.0f} % cold), depthwise conv "
                f"{library_ms:.4f} ms{plain}")
            del x
    return rows


def blur_host_us(blur, calls: int = 200) -> dict:
    """Host time of one call of the wrapper (``blur2d``, autograd Function
    and all) and of the launch alone (``_launch``), microseconds, at the
    smallest main-path shape, whose kernel the card finishes faster than the
    host issues it."""
    import torch

    x = torch.randn(BATCH, 8, 8, 512, device="cuda")
    taps = case_taps(dict(up=1, adjoint=False))
    out = {}
    for what, fn in (("blur2d", blur.blur2d), ("_launch", blur._launch)):
        for _ in range(10):
            fn(x, *taps, (1, 1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(x, *taps, (1, 1))
        out[what] = 1e6 * (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
    return out


# ------------------------------------------------------------ main path

LOG_ROOT = None  # the runs' logdir root: a temporary directory (main)


def cli_argv(recipe, dataset: str, steps: int, batch=None,
             print_every: int = 1):
    """The train CLI's arguments for ``recipe`` on ``dataset`` at ``batch``
    (the config's where None) up to step ``steps``, and the batch. Printing
    every step resolves ``--steps_per_dispatch`` to 1, the eager step."""
    from contrad_tpu_torch.config import default_config_files, load_config

    if batch is None:
        batch = load_config(default_config_files(recipe[0])).options.batch_size
    return recipe + ["--print_every", str(print_every), "--seed", "0",
                     "--logdir_root", LOG_ROOT, "--override",
                     f"options.dataset={dataset}",
                     f"options.batch_size={batch}",
                     f"options.max_steps={steps}"], batch


def run_cli(main, recipe, dataset: str, steps: int, batch=None,
            print_every: int = 1):
    """``steps`` steps of one of the port's training CLIs (its ``main``)
    with ``recipe`` on ``dataset`` at ``batch`` (the config's where None),
    with the blur's launch counts set to 0 just before and read just after;
    every metric it prints must be finite. Returns its history (with the
    run's logdir and the checkpoints it wrote), the blur's launches (all,
    and on the scalar path), the peak device memory and the ms per step
    (the mean of the printed windows after the first; the steps' own,
    checkpoint writes and graph captures excluded) and img/s."""
    import torch

    from contrad_tpu_torch.ops import blur

    argv, batch = cli_argv(recipe, dataset, steps, batch, print_every)
    torch.cuda.reset_peak_memory_stats()
    blur.blur2d.launches = blur.blur2d.scalar_launches = 0
    history = main(argv)
    launches, scalar = blur.blur2d.launches, blur.blur2d.scalar_launches
    peak = torch.cuda.max_memory_allocated()
    for rec in history:
        for k, v in rec.items():
            if not math.isfinite(v):
                raise AssertionError(f"step {rec['step']}: {k} = {v}")
    timed = history[1:] or history
    ms_step = 1e3 * sum(r["seconds_per_step"] for r in timed) / len(timed)
    return dict(history=history, logdir=history.logdir, saves=history.saves,
                dispatch=history.dispatch, data=history.data, batch=batch,
                launches=launches,
                scalar_launches=scalar, launches_per_step=launches / steps,
                ms_per_step=ms_step, img_per_s=batch / (ms_step * 1e-3),
                peak_bytes=peak)


def log_run(name: str, r) -> None:
    log(f"  {name} {r['batch']}: {r['ms_per_step']:.2f} ms/step after the "
        f"first, {r['img_per_s']:.1f} img/s; peak memory "
        f"{r['peak_bytes'] / 2**30:.3f} GiB; blur launches {r['launches']}")


def expect_launches(r, want, what: str) -> None:
    """The blur's launches in a run (``run_cli``) or per profiled step
    (``profile``) must be ``want``, none on the scalar path."""
    got = r.get("blur_launches_per_step", r.get("launches"))
    if got != want:
        raise AssertionError(f"{got} blur launches in {what}, not the {want} "
                             f"that phase 3 counts")
    if r.get("scalar_launches", 0):
        raise AssertionError(f"{r['scalar_launches']} blur launches in "
                             f"{what} took the scalar path")


# a process that draws a dataset (argv[2]) while phases 3-6 run and pickles
# it to argv[3]: the same call, so the same bits, as drawing it in this one
DRAW_DATASET = (
    "import os, pickle, sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "from contrad_tpu_torch.data import get_dataset\n"
    "with open(sys.argv[3] + '.tmp', 'wb') as f:\n"
    "    pickle.dump(get_dataset(sys.argv[2]), f, protocol=5)\n"
    "os.replace(sys.argv[3] + '.tmp', sys.argv[3])\n")


def share_datasets(drawing: dict) -> None:
    """Make each dataset once for the whole run: phase 7's steps and its
    profile read the same ``synthetic_512`` (2,560 images of 512x512, which
    numpy takes about a minute to draw). ``drawing`` maps a dataset to the
    process drawing it (``DRAW_DATASET``, started at the run's start) and
    its file, read at the dataset's first use. The CLIs look
    ``get_dataset`` up in ``contrad_tpu_torch.data`` when they build."""
    import pickle

    from contrad_tpu_torch import data

    plain, made = data.get_dataset, {}

    def get_dataset(dataset, data_path=None):
        key = (dataset, data_path)
        if key not in made:
            if data_path is None and dataset in drawing:
                proc, path = drawing.pop(dataset)
                if proc.wait() != 0:
                    raise RuntimeError(f"drawing {dataset} failed "
                                       f"({proc.returncode})")
                with open(path, "rb") as f:
                    made[key] = pickle.load(f)
                os.remove(path)
            else:
                made[key] = plain(dataset, data_path)
        return made[key]

    data.get_dataset = get_dataset


def profile_rows(step, steps: int):
    """Run ``step()`` ``steps`` times under torch.profiler; returns the wall
    ms per step and (ms per step, launches per step, name) per kernel, the
    kernels' own device time summed by name, largest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels = [e for e in prof.key_averages()  # kernels, not annotations
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    rows = sorted(((e.self_device_time_total / steps / 1e3,
                    e.count / steps, e.key) for e in kernels), reverse=True)
    return wall_ms, rows


def profile(cli, recipe, dataset: str, batch=None, steps: int = 3,
            **step_kwargs):
    """torch.profiler over ``steps`` train steps (after 2 untimed ones) of
    the trainer that the CLI module ``cli`` builds for ``recipe`` on
    ``dataset``, each step's batch from the CLI's loader (a host-fed one's
    gather and copy included): kernel time by class, the largest kernels,
    the idle share and launches per step (``class_report``), with the
    blur's launches and device ms per step."""
    from contrad_tpu_torch.ops import blur

    override = [f"options.dataset={dataset}"]
    if batch is not None:
        override.append(f"options.batch_size={batch}")
    P = cli.parse_args(recipe + ["--seed", "0", "--override"] + override)
    _, loader, trainer = cli.build(P)

    def step():
        images = next(loader)
        if isinstance(images, tuple):  # a host-fed loader's (images, labels)
            images = images[0]
        trainer.train_step(images, **step_kwargs)

    for _ in range(2):
        step()
    blur.blur2d.launches = 0
    report = class_report(*profile_rows(step, steps))
    if hasattr(loader, "close"):
        loader.close()
    report["blur_launches_per_step"] = blur.blur2d.launches / steps
    report["blur_ms_per_step"] = sum(
        k["ms"] for k in report["kernels"] if "blur2d_kernel" in k["name"])
    return report


def model_reference_check() -> float:
    """G and D on the card (blur kernel) vs the same modules on the CPU
    (plain versions), float32 with TF32 off, on a small batch."""
    import torch

    from contrad_tpu_torch.models import get_architecture

    G, D = get_architecture("stylegan2", (32, 32, 3), device="cuda", seed=1)
    Gc, Dc = copy.deepcopy(G).cpu(), copy.deepcopy(D).cpu()
    gen = torch.Generator().manual_seed(2)
    z = torch.randn(4, G.style_dim, generator=gen)
    noise = G.draw_noise(4, gen, torch.device("cpu"))
    mixing = G.draw_mixing(4, 0.9, gen, torch.device("cpu"))
    worst = 0.0
    with torch.no_grad():
        img = G(z.cuda(), [a.cuda() for a in noise],
                tuple(m.cuda() for m in mixing))
        img_c = Gc(z, noise, mixing)
        d, aux = D(img)
        d_c, aux_c = Dc(img_c)
    pairs = [("G images", img, img_c), ("D score", d, d_c)]
    pairs += [(f"D {k}", aux[k], aux_c[k]) for k in aux]
    for what, a, b in pairs:
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: shape {tuple(a.shape)} or values")
        err = float((a.cpu() - b).abs().max())
        limit = MODEL_TOL[0] + MODEL_TOL[1] * float(b.abs().max())
        log(f"  {what:16s} {str(tuple(a.shape)):18s} max|card - cpu| "
            f"{err:.3e} (tol {limit:.3e})")
        if not err <= limit:
            raise AssertionError(f"{what}: card and CPU disagree: {err}")
        worst = max(worst, err)
    return worst


# ------------------------------------------------------- SNDCGAN flagship

def kernel_class(name: str) -> str:
    """A CUDA kernel's class, from its name."""
    n = name.lower()
    for cls, keys in (
            ("blur (hand-written)", ("blur2d_kernel",)),
            ("layout transpose", ("nchwtonhwc", "nhwctonchw")),
            ("batch norm", ("batch_norm", "batchnorm", "welford")),
            ("convolution", ("conv", "dgrad", "wgrad", "fprop",
                             "implicit_gemm", "xmma_fprop", "cudnn")),
            ("matmul", ("gemm", "gemv", "cublas", "cutlass", "sm90_xmma")),
            ("optimizer", ("multi_tensor", "adam", "foreach")),
            ("copy", ("copy", "cat", "transpose", "permute")),
            ("reduction", ("reduce", "norm", "softmax", "argmax", "sum")),
            ("elementwise", ("elementwise", "vectorized", "unrolled",
                             "where", "index"))):
        if any(k in n for k in keys):
            return cls
    return "other"


def class_report(wall_ms: float, rows):
    """Log and return a profile's kernel time by class, the 25 largest
    kernels, the idle share and the launches per step."""
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    classes = {}
    for ms, count, key in rows:
        c = classes.setdefault(kernel_class(key), [0.0, 0.0])
        c[0] += ms
        c[1] += count
    log(f"  profile: {wall_ms:.2f} ms/step wall, kernels {busy:.2f} ms/step "
        f"(idle {100 * (1 - busy / wall_ms):.1f} %), {launches:.0f} kernel "
        f"launches per step")
    for cls, (ms, count) in sorted(classes.items(), key=lambda kv: -kv[1][0]):
        log(f"    class {cls:12s} {ms:8.3f} ms/step ({100 * ms / busy:5.1f} %)"
            f"  x{count:.0f}")
    for ms, count, key in rows[:25]:
        log(f"    {ms:8.3f} ms/step  x{count:<4.0f} {key[:100]}")
    return dict(wall_ms_per_step=wall_ms, kernel_ms_per_step=busy,
                idle_share=1 - busy / wall_ms, launches_per_step=launches,
                classes={k: dict(ms=v[0], count=v[1])
                         for k, v in classes.items()},
                kernels=[dict(ms=ms, count=c, name=k) for ms, c, k in rows])


def _to(obj, device):
    """``obj`` (draws: tensors in dicts, lists and named tuples) on
    ``device``."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to(v, device) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, device) for v in obj)
    return obj


def gan_card_vs_cpu(batch: int = 64, n_classes: int = 1) -> float:
    """One flagship GANTrainer step (sndcgan at full width, contrad, simclr,
    nonsat, Adam with warmup; with ``n_classes > 1`` a conditional D and
    labelled images) on the card and on the CPU, from the same weights,
    images, labels and draws, float32 with TF32 off: the losses and every
    parameter and buffer after the step (``u``, batch-norm statistics)."""
    import torch

    from contrad_tpu_torch.augment import get_augment
    from contrad_tpu_torch.models import get_architecture
    from contrad_tpu_torch.training import GANTrainer, ScheduledAdam

    gen = torch.Generator().manual_seed(3)
    images = torch.rand(batch, 32, 32, 3, generator=gen)
    labels = torch.randint(0, n_classes, (batch,), generator=gen)
    draws, out = None, {}
    for device in ("cpu", "cuda"):
        G, D = get_architecture("sndcgan", (32, 32, 3), device=device, seed=1,
                                n_classes=n_classes)

        def adam(m):
            return ScheduledAdam(m.parameters(), 2e-4, (0.5, 0.999),
                                 warmup=3000, use_warmup=True)

        trainer = GANTrainer(G, D, mode="contrad",
                             augment=get_augment("simclr"),
                             g_optimizer=adam(G), d_optimizer=adam(D),
                             loss_type="nonsat")
        if draws is None:
            draws = trainer.draw_step(images.shape)
        metrics = trainer.train_step(images.to(device),
                                     draws=_to(draws, device),
                                     labels=labels.to(device))
        state = {f"G.{k}": v for k, v in G.state_dict().items()}
        state.update({f"D.{k}": v for k, v in D.state_dict().items()})
        out[device] = ({k: v.reshape(1) for k, v in metrics.items()}, state)
    worst = 0.0
    for what, i in (("loss", 0), ("state", 1)):
        for k, want in out["cpu"][i].items():
            got = out["cuda"][i][k].cpu()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"flagship step on the card: {k} is not "
                                     f"finite")
            err = float((got - want).abs().max())
            limit = MODEL_TOL[0] + MODEL_TOL[1] * float(want.abs().max())
            if what == "loss" or k.endswith(".u") or "running" in k:
                log(f"  {k:32s} max|card - cpu| {err:.3e} (tol {limit:.3e})")
            if not err <= limit:
                raise AssertionError(f"flagship step: {k}: card and CPU "
                                     f"disagree: {err} > {limit}")
            worst = max(worst, err)
    return worst


# ------------------------------------------------------- the 512x512 recipe

class KeepGrads:
    """An optimiser stand-in that keeps the gradients it is given and leaves
    the parameters alone."""

    def __init__(self):
        self.grads = None

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]


class LeakyBranches:
    """The branches of every leaky ReLU in a step (``F.leaky_relu``, which
    the StyleGAN2 models' fused bias + leaky ReLU calls in its plain op),
    call by call. Under ``record()`` each call keeps which elements take the
    identity branch (``x > 0``) and its pre-activations within ``MODEL_TOL``
    of 0; under ``impose()`` each call takes the recorded branches instead
    of its own, and every element whose own branch differs is listed in
    ``flips`` with its pre-activation on both devices. While either runs,
    the fused activation runs its plain op on the card too (its kernel
    takes its own branches, and equals the plain op bitwise in its forward
    and input gradient: ``tests/test_torch_port_cuda.py``)."""

    def __init__(self):
        self.calls, self.flips = [], []
        self._next = 0

    def record(self):
        return self._patched(self._record)

    def impose(self):
        self._next = 0
        return self._patched(self._impose)

    @contextlib.contextmanager
    def _patched(self, fn):
        import torch.nn.functional as F

        from contrad_tpu_torch.models.stylegan2 import layers
        from contrad_tpu_torch.ops import fused_act

        plain = F.leaky_relu
        kernel = fused_act.fused_leaky_relu
        F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: fn(
            plain, x, negative_slope)
        fused_act.fused_leaky_relu = layers.fused_leaky_relu = \
            fused_act.fused_leaky_relu_plain
        try:
            yield self
        finally:
            F.leaky_relu = plain
            fused_act.fused_leaky_relu = layers.fused_leaky_relu = kernel
        if fn == self._impose and self._next != len(self.calls):
            raise AssertionError(f"{self._next} leaky ReLUs imposed, "
                                 f"{len(self.calls)} recorded")

    def _record(self, plain, x, slope):
        flat = x.detach().flatten()
        limit = MODEL_TOL[0] + MODEL_TOL[1] * float(flat.abs().max())
        near = (flat.abs() <= limit).nonzero().squeeze(1)
        self.calls.append(dict(shape=tuple(x.shape), limit=limit,
                               mask=(x.detach() > 0).cpu(), near=near.cpu(),
                               near_x=flat[near].cpu()))
        return plain(x, slope)

    def _impose(self, plain, x, slope):
        import torch

        call = self.calls[self._next]
        if tuple(x.shape) != call["shape"]:
            raise AssertionError(f"leaky ReLU {self._next}: shape "
                                 f"{tuple(x.shape)}, recorded {call['shape']}")
        mask = call["mask"].to(x.device)
        flips = ((x.detach() > 0) != mask).flatten().nonzero().squeeze(1)
        if flips.numel():
            index, near = flips.cpu(), call["near"]
            pos = torch.searchsorted(near, index).clamp(max=max(len(near) - 1,
                                                                0))
            found = (near[pos] == index) if len(near) else \
                torch.zeros_like(index, dtype=torch.bool)
            cpu = torch.where(found, call["near_x"][pos] if len(near) else
                              torch.zeros(()), torch.tensor(float("nan")))
            self.flips.append(dict(
                call=self._next, shape=call["shape"], limit=call["limit"],
                index=index, card=x.detach().flatten()[flips].cpu(), cpu=cpu))
        self._next += 1
        return torch.where(mask, x, x * slope)


def sg2_512_card_vs_cpu(batch: int = 4) -> dict:
    """One ``StyleGAN2Trainer`` step of the 512x512 recipe (``stylegan2_512``
    at full width, contrad, ``simclr_hq``, lazy R1 on) on the card and on
    the CPU, from the same weights, images and draws, float32 with TF32
    off: the losses and the gradients of both phases, each tensor within
    ``MODEL_TOL`` of its largest element on the CPU. A leaky-ReLU
    pre-activation within rounding of 0 can take the other branch on the
    card (its convolutions sum in other orders), which moves whole
    gradients (a bias's, a noise strength's) through one element; so the
    card's step is run twice: with its own branches (reported), and taking
    the CPU's branch at every element (``LeakyBranches``), which is held to
    ``MODEL_TOL``, and where the branches differ, the pre-activation on
    both devices must lie within ``MODEL_TOL`` of 0. Batch 4: the smallest
    whose D batches (4 and 12 images) minibatch stddev's groups of 4
    divide."""
    import torch

    from contrad_tpu_torch.augment import get_augment
    from contrad_tpu_torch.config import default_config_files, load_config
    from contrad_tpu_torch.models import get_architecture
    from contrad_tpu_torch.training import StyleGAN2Trainer

    hyper = load_config(default_config_files(RECIPE_512[0])).get("augment")
    images = torch.rand(batch, 512, 512, 3,
                        generator=torch.Generator().manual_seed(4))
    branches, imposed = LeakyBranches(), "card, CPU's branches"
    draws, out = None, {}
    for run, ctx in (("cpu", branches.record),
                     ("card", contextlib.nullcontext),
                     (imposed, branches.impose)):
        device = "cpu" if run == "cpu" else "cuda"
        G, D = get_architecture("stylegan2_512", (512, 512, 3), device=device,
                                seed=1)
        g_tx, d_tx = KeepGrads(), KeepGrads()
        trainer = StyleGAN2Trainer(G, D, mode="contrad",
                                   augment=get_augment("simclr_hq", hyper),
                                   g_optimizer=g_tx, d_optimizer=d_tx,
                                   loss_type="nonsat", lbd_r1=0.5,
                                   d_reg_every=16)
        if draws is None:
            draws = trainer.draw_step(images.shape, with_r1=True)
        t0 = time.perf_counter()
        with ctx():
            metrics = trainer.train_step(images.to(device),
                                         draws=_to(draws, device))
        grads = {f"G.{k}": g for (k, _), g in zip(G.named_parameters(),
                                                   g_tx.grads)}
        grads.update({f"D.{k}": g for (k, _), g in zip(D.named_parameters(),
                                                        d_tx.grads)})
        out[run] = ({k: v.reshape(1) for k, v in metrics.items()}, grads,
                    time.perf_counter() - t0)
        del trainer, G, D
    worst, beyond = {}, {}
    for run in ("card", imposed):
        worst[run], beyond[run] = {"loss": 0.0, "grad": 0.0}, {}
        for what, i in (("loss", 0), ("grad", 1)):
            for k, want in out["cpu"][i].items():
                got = out[run][i][k].cpu()
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"512x512 step on the {run}: {k} "
                                         f"is not finite")
                diff = (got - want).abs()
                err = float(diff.max())
                limit = MODEL_TOL[0] + MODEL_TOL[1] * float(want.abs().max())
                worst[run][what] = max(worst[run][what], err / limit)
                if what == "loss" and run == "card" or not err <= limit:
                    at = int(diff.flatten().argmax())
                    log(f"  {run:21s} {k:44s} max|card - cpu| {err:.3e} "
                        f"(tol {limit:.3e}; at [{at}]: card "
                        f"{float(got.flatten()[at]):+.5e}, cpu "
                        f"{float(want.flatten()[at]):+.5e})")
                if not err <= limit:
                    beyond[run][k] = err / limit
        log(f"  {run}: {len(out['cpu'][1])} gradient tensors, worst max|card"
            f" - cpu| at {worst[run]['grad']:.3f} of its tolerance, "
            f"{len(beyond[run])} beyond it; losses at "
            f"{worst[run]['loss']:.3f}")
    flips = sum(len(f["index"]) for f in branches.flips)
    elements = sum(math.prod(c["shape"]) for c in branches.calls)
    far = [f for f in branches.flips
           if bool(torch.isnan(f["cpu"]).any())
           or float(f["card"].abs().max()) > f["limit"]]
    for f in branches.flips:
        log(f"  leaky ReLU {f['call']} {f['shape']}: {len(f['index'])} "
            f"elements on the other branch on the card; pre-activation there"
            f" at most {float(f['card'].abs().max()):.3e} (card), "
            f"{float(f['cpu'].abs().max()):.3e} (cpu); limit "
            f"{f['limit']:.3e}")
    log(f"  {len(branches.calls)} leaky ReLUs, {elements} elements: {flips} "
        f"take the other branch on the card; step {out['cpu'][2]:.1f} s on "
        f"the CPU, {out['card'][2]:.2f} s on the card (first)")
    if far or beyond[imposed]:
        raise AssertionError(
            f"512x512 step: card and CPU disagree on {sorted(beyond[imposed])}"
            f", or their branches differ away from 0 in leaky ReLUs "
            f"{[f['call'] for f in far]}")
    return dict(batch=batch, worst_fraction_of_tol=worst,
                beyond_tol_own_branches=beyond["card"],
                leaky_relus=len(branches.calls), elements=elements,
                other_branch=[dict(call=f["call"], shape=f["shape"],
                                   elements=len(f["index"]),
                                   card_max=float(f["card"].abs().max()),
                                   cpu_max=float(f["cpu"].abs().max()),
                                   limit=f["limit"])
                              for f in branches.flips],
                cpu_s=out["cpu"][2], card_s=out["card"][2])


# ------------------------------------------------------- the evaluation path

def flat_tensors(tree, prefix: str = ""):
    """Every tensor of a checkpoint's nested dicts and lists, by path."""
    import torch

    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree} if isinstance(tree, torch.Tensor) else {}
    out = {}
    for k, v in items:
        out.update(flat_tensors(v, f"{prefix}{k}."))
    return out


def restored_equals_saved(cli, argv, logdir: str, name: str) -> int:
    """Build the CLI's trainer for ``argv`` (a ``--resume`` command line),
    restore it as the CLI does and hold every tensor of it (G, D, ``u``,
    batch-norm statistics, Adam's moments, the random streams) to the
    checkpoint ``name`` bitwise, on the card; returns the first step the
    resumed run takes."""
    import torch

    from contrad_tpu_torch.utils.checkpoint import restore_checkpoint
    from contrad_tpu_torch.utils.logger import Logger
    from contrad_tpu_torch.utils.run import restore, run_state

    P = cli.parse_args(argv)
    _, loader, trainer = cli.build(P)
    first = restore(P, trainer, loader, Logger(None, resume=logdir))
    saved = restore_checkpoint(logdir, name, "cuda")
    got = run_state(trainer, loader, first - 1, saved["meta"])
    want_t, got_t = flat_tensors(saved), flat_tensors(got)
    if want_t.keys() != got_t.keys():
        raise AssertionError("restored state holds other tensors than the "
                             "checkpoint")
    for k, v in want_t.items():
        if not (got_t[k].dtype == v.dtype and torch.equal(got_t[k].cpu(),
                                                         v.cpu())):
            raise AssertionError(f"restored {k} differs from the saved one")
    if got["data"] != saved["data"] or saved["step"] != first - 1:
        raise AssertionError("restored data position or step differs")
    log(f"  restored state equals ckpt/{name}.pt bitwise: {len(want_t)} "
        f"tensors; data position {saved['data']}; resumes at step {first}")
    return first


def eval_cli(main, argv, want_launches: int, what: str):
    """One evaluation CLI (its ``main``) with the blur's launch counts set
    to 0 just before and read just after; they must be ``want_launches``,
    none on the scalar path. Returns its result and its seconds."""
    import torch

    from contrad_tpu_torch.ops import blur

    blur.blur2d.launches = blur.blur2d.scalar_launches = 0
    t0 = time.perf_counter()
    out = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    expect_launches(dict(launches=blur.blur2d.launches,
                         scalar_launches=blur.blur2d.scalar_launches),
                    want_launches, what)
    return out, seconds, blur.blur2d.launches


def count_pngs(directory: str) -> int:
    return sum(f.endswith(".png") for _, _, files in os.walk(directory)
               for f in files)


def feature_scale(arch: str, logdir: str, n: int = 256):
    """Mean norm of the penultimate features that the probe reads (eval
    mode, ``n`` test images) from the run's D and from the same D as
    initialised (seed 0), on the card: spectral norm's ``u`` converges in a
    few steps and scales a SNDCGAN D's features."""
    import torch

    from contrad_tpu_torch.data import get_dataset
    from contrad_tpu_torch.models import get_architecture
    from contrad_tpu_torch.test_lineval import features
    from contrad_tpu_torch.utils.run_loading import load_run

    _, _, D, _, image_size = load_run(logdir, arch)
    _, D0 = get_architecture(arch, image_size, device="cuda", seed=0,
                             n_classes=D.n_classes)
    x = torch.from_numpy(get_dataset(EVAL_DATA)[1].images[:n]).cuda()
    x = x.float() / 255.0
    return tuple(float(features(d, x).norm(dim=1).mean()) for d in (D, D0))


def evaluate_run(arch: str, logdir: str, per_step, probe_epochs: int,
                 cddls_steps: int, cddls_samples: int, cddls_batch: int,
                 use_ema: bool):
    """The three evaluation CLIs on a trained run: the linear probe
    (``probe_epochs`` epochs at batch 256), 1,000 samples (from the EMA G
    with ``use_ema``) and cDDLS (``cddls_steps`` steps, ``cddls_samples``
    samples at ``cddls_batch``, the probe's head, ``best``, its default),
    each with the
    blur's launches as ``per_step`` counts them (all zero on SNDCGAN); the
    probe's losses must be finite (its accuracies are reported: on a D
    trained for a few steps they need not beat chance), and every sample
    must be written."""
    from contrad_tpu_torch import (
        test_gan_sample, test_gan_sample_cddls, test_lineval)

    sg2 = arch.startswith("stylegan2")
    n_train = int(EVAL_DATA.split("_")[2])
    probe_calls = n_train // PROBE_BATCH + EVAL_TEST // PROBE_BATCH
    want = (probe_epochs * (probe_calls * per_step["lineval_32"]
                            + bool(EVAL_TEST % PROBE_BATCH)
                            * per_step["lineval_32_tail"]) if sg2 else 0)
    probe, probe_s, probe_n = eval_cli(
        test_lineval.main, [logdir, arch, "--epochs", str(probe_epochs),
                            "--batch_size", str(PROBE_BATCH)], want,
        f"{arch}'s linear probe")
    last = probe["epochs"][-1]
    scale = feature_scale(arch, logdir)
    log(f"  {arch}: mean norm of D's penultimate features {scale[0]:.4f} "
        f"after training, {scale[1]:.4f} as initialised")
    for rec in probe["epochs"]:
        log(f"  probe epoch {rec['epoch']}: {rec['seconds']:.2f} s, train "
            f"acc {rec['train_acc']:.2f} %, test acc {rec['test_acc']:.2f} %"
            f" (loss {rec['train_loss']:.4f} / {rec['test_loss']:.4f})")
    if not all(math.isfinite(last[k]) for k in ("train_loss", "test_loss")):
        raise AssertionError(f"{arch}'s probe diverged: {last}")

    n_samples = 1000
    want = per_step["sample_32"] * -(-n_samples // SAMPLE_BATCH) if sg2 else 0
    subdir, sample_s, sample_n = eval_cli(
        test_gan_sample.main, [logdir, arch, "--n_samples", str(n_samples),
                               "--batch_size", str(SAMPLE_BATCH)]
        + (["--use_ema"] if use_ema else []), want, f"{arch}'s sampling")
    if count_pngs(subdir) != n_samples:
        raise AssertionError(f"{subdir} holds {count_pngs(subdir)} PNGs")

    chains = 10 * -(-cddls_samples // 10 // cddls_batch)
    want = (chains * (cddls_steps * per_step["cddls_32"]
                      + per_step["cddls_32_final"]) if sg2 else 0)
    cddls, cddls_s, cddls_n = eval_cli(
        test_gan_sample_cddls.main,
        [logdir, probe["npz"], arch, "--n_steps", str(cddls_steps),
         "--n_samples", str(cddls_samples), "--batch_size",
         str(cddls_batch)], want, f"{arch}'s cDDLS (ckpt/best)")
    if cddls["samples"] != cddls_samples or count_pngs(
            cddls["subdir"]) != cddls_samples:
        raise AssertionError(f"cDDLS wrote {cddls['samples']} samples")
    ms_step = 1e3 * cddls["chain_seconds"] / (cddls["chains"] * cddls_steps)
    log(f"  {arch}: probe {probe_epochs} epoch(s) in {probe_s:.2f} s (blur "
        f"launches {probe_n}); {n_samples} samples in {sample_s:.2f} s "
        f"(blur {sample_n}); cDDLS {cddls['chains']} chains x {cddls_steps} "
        f"steps at batch {cddls_batch}: {ms_step:.3f} ms a Langevin step "
        f"(the final sample included), {cddls_samples / cddls['chain_seconds']:.1f}"
        f" samples/s in the chains, {cddls_s:.2f} s with the PNGs (blur "
        f"{cddls_n})")
    return dict(probe=probe, probe_s=probe_s, probe_launches=probe_n,
                feature_norm=scale[0], feature_norm_init=scale[1],
                sample_s=sample_s, sample_launches=sample_n, sample_dir=subdir,
                cddls=cddls, cddls_s=cddls_s, cddls_launches=cddls_n,
                cddls_ms_per_step=ms_step, cddls_batch=cddls_batch,
                cddls_samples_per_s=cddls_samples / cddls["chain_seconds"])


def _check_close(what: str, got, want) -> float:
    import torch

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: shape {tuple(got.shape)} or values")
    err = float((got.cpu() - want).abs().max())
    limit = MODEL_TOL[0] + MODEL_TOL[1] * float(want.abs().max())
    log(f"  {what:32s} max|card - cpu| {err:.3e} (tol {limit:.3e})")
    if not err <= limit:
        raise AssertionError(f"{what}: card and CPU disagree: {err} > {limit}")
    return err


def eval_card_vs_cpu(arch: str, logdir: str, batch: int = 8) -> float:
    """On a trained run's weights, on the card and on the CPU (TF32 off):
    one probe step (SNDCGAN runs) and 3 Langevin steps, from the same
    images, labels, augmentation, latents and draws; the probe's loss,
    logits and updated head, and the chain's energy gradients' end state
    ``(z, z2)``."""
    import torch

    from contrad_tpu_torch.augment import AugRng
    from contrad_tpu_torch.data import get_dataset
    from contrad_tpu_torch.test_gan_sample_cddls import (
        draw_noise, langevin_step)
    from contrad_tpu_torch.test_lineval import lin_augment, probe_step
    from contrad_tpu_torch.utils.run_loading import load_run

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(5)
    train, _, image_size = get_dataset(EVAL_DATA)
    images = torch.from_numpy(train.images[:64])
    labels = torch.from_numpy(train.labels[:64])
    aug = lin_augment()
    aug_params = aug.sample(images.shape, AugRng.from_seed(0, cpu))
    out, start, worst = {}, None, 0.0
    for device in ("cpu", "cuda"):
        _, G, D, _, _ = load_run(logdir, arch, device=device)
        if start is None:  # the same probe head, latents and draws for both
            z0 = G.sample_latent(batch, gen)
            z2_0 = torch.randn((batch,) + tuple(image_size), generator=gen)
            draws = [(draw_noise(G, batch, gen, cpu),
                      torch.randn(z0.shape, generator=gen),
                      torch.randn(z2_0.shape, generator=gen))
                     for _ in range(3)]
            start = ({"w": torch.randn(D.d_penul, 10, generator=gen) * 0.01,
                      "b": torch.zeros(10)}, (z0, z2_0, draws))
        probe = {k: v.clone().to(device) for k, v in start[0].items()}
        loss, logits = probe_step(D, probe, images.to(device),
                                  labels.to(device), aug,
                                  _to(aug_params, device), 0.1)
        z, z2, draws = _to(start[1], device)
        w, b = probe["w"], probe["b"]
        for noise, n_z, n_z2 in draws:
            z, z2 = langevin_step(G, D, w, b, z, z2, 3, 0.01, 0.1, 1.0,
                                  noise, n_z, n_z2)
        out[device] = dict(loss=loss.reshape(1), logits=logits,
                           w=probe["w"], b=probe["b"], z=z, z2=z2)
        del G, D
    for k, want in out["cpu"].items():
        worst = max(worst, _check_close(f"{arch} {k}", out["cuda"][k], want))
    return worst


FID_FLAGS = ["--fid_embed", "moments", "--n_eval_avg", str(FID_AVG)]
FLAGSHIP_COND = FLAGSHIP + ["--conditional", "--evaluate_every", "3",
                            "--save_every", "6"] + FID_FLAGS
SG2_EVAL = RECIPE + ["--evaluate_every", "3"] + FID_FLAGS
EVAL_LAUNCHES = []  # the blur's launches in each evaluation of a run


def count_evaluation_launches() -> None:
    """Record the blur's launches in each call of the CLIs' evaluation
    (``utils/run.py::evaluate``, which they look up in its module) in
    ``EVAL_LAUNCHES``."""
    from contrad_tpu_torch.ops import blur
    from contrad_tpu_torch.utils import run

    real = run.evaluate

    def evaluate(*args, **kwargs):
        before = blur.blur2d.launches
        out = real(*args, **kwargs)
        EVAL_LAUNCHES.append(blur.blur2d.launches - before)
        return out

    run.evaluate = evaluate


def gif_frames(path: str) -> int:
    """The number of images in a GIF file, from its block structure."""
    data = Path(path).read_bytes()
    if data[:6] != b"GIF89a":
        raise AssertionError(f"{path} is not a GIF89a file")
    pos, n = 13 + (3 << ((data[10] & 7) + 1) if data[10] & 0x80 else 0), 0

    def skip_sub_blocks(pos):
        while data[pos]:
            pos += data[pos] + 1
        return pos + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:  # an extension: label, then sub-blocks
            pos = skip_sub_blocks(pos + 2)
        elif data[pos] == 0x2C:  # an image: descriptor, code size, data
            n += 1
            pos = skip_sub_blocks(pos + 11)
        else:
            raise AssertionError(f"{path}: unknown block {data[pos]:#x}")
    return n


def check_fid_run(r, steps, what: str):
    """The in-loop evaluation's outputs of a run (``run_cli``) that
    evaluated at ``steps``, maybe across a restart: one CSV (one
    ``eval_seed``) with one finite row an evaluation, ``ckpt/best.pt`` at
    the best mean, one GIF frame an evaluation. Returns the CSV's means
    and the seconds of each evaluation and of its FID trials."""
    import glob

    from contrad_tpu_torch.utils.checkpoint import restore_checkpoint

    logdir, evals = r["logdir"], r["history"].evals
    csvs = glob.glob(os.path.join(logdir, "results_fid_*.csv"))
    if len(csvs) != 1:
        raise AssertionError(f"{what}: FID CSVs {csvs}")
    seed = csvs[0].rsplit("_", 1)[1][:-len(".csv")]
    rows = Path(csvs[0]).read_text().splitlines()
    header = ",".join(["step"] + [f"fid_{i}" for i in range(FID_AVG)]
                      + ["mean"])
    table = [[float(v) for v in row.split(",")] for row in rows[1:]]
    if rows[0] != header or [int(t[0]) for t in table] != list(steps):
        raise AssertionError(f"{what}: CSV {rows}")
    if not all(math.isfinite(v) for t in table for v in t):
        raise AssertionError(f"{what}: FID not finite: {table}")
    means = [t[-1] for t in table]
    best_step = int(table[means.index(min(means))][0])
    if restore_checkpoint(logdir, "best")["step"] != best_step:
        raise AssertionError(f"{what}: ckpt/best.pt is not step {best_step}")
    frames = gif_frames(os.path.join(logdir,
                                     f"training_progress_{seed}.gif"))
    if frames != len(steps):
        raise AssertionError(f"{what}: {frames} GIF frames")
    log(f"  {what}: FID (moments) {', '.join(f'{m:.6g}' for m in means)} at"
        f" steps {list(steps)}, best {min(means):.6g} (ckpt/best.pt at step "
        f"{best_step}); {frames} GIF frames; seconds an evaluation "
        + ", ".join(f"{e['seconds']:.3f} (FID {e['fid_seconds']:.3f})"
                    for e in evals))
    return dict(eval_seed=int(seed), means=means, best_step=best_step,
                eval_seconds=[e["seconds"] for e in evals],
                fid_seconds=[e["fid_seconds"] for e in evals])


def expected_saves(evals, save_every: int):
    return [n for e in evals for n in ["latest"] + ["best"] * e["is_best"]
            + ([f"step_{e['step']}"] if e["step"] % save_every == 0 else [])]


def evaluation_phase(train_gan, train_stylegan2, per_step, flagship):
    """Phase 8: the conditional flagship with checkpoints and resume, the
    evaluation CLIs on it and on a 32x32 StyleGAN2 run, and card against
    CPU (TF32 off at the end); returns its numbers."""
    import torch

    t8 = time.perf_counter()
    phase("[8] the evaluation path: conditional flagship, checkpoints and "
          "resume, probe, sampling and cDDLS")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for training
    EVAL_LAUNCHES.clear()
    cond = run_cli(train_gan.main, FLAGSHIP_COND, EVAL_DATA, 6)
    log_run("conditional flagship contrad, batch", cond)
    log(f"  unconditional (phase 6): {flagship['ms_per_step']:.2f} ms/step, "
        f"{flagship['img_per_s']:.1f} img/s, peak "
        f"{flagship['peak_bytes'] / 2**30:.3f} GiB")
    expect_launches(cond, 0, "the conditional flagship")
    for s in cond["saves"]:
        log(f"  step {s['step']}: ckpt/{s['name']}.pt {s['bytes'] / 2**20:.2f}"
            f" MiB written in {s['seconds']:.3f} s")
    cond_fid = check_fid_run(cond, (3, 6), "conditional flagship")
    if [s["name"] for s in cond["saves"]] != expected_saves(
            cond["history"].evals, 6):
        raise AssertionError(f"checkpoints written: {cond['saves']}")
    logdir = cond["logdir"]
    resume_argv, _ = cli_argv(FLAGSHIP_COND + ["--resume", logdir],
                              EVAL_DATA, 9)
    if restored_equals_saved(train_gan, resume_argv, logdir, "step_6") != 7:
        raise AssertionError("the resumed run would not start at step 7")
    resumed = run_cli(train_gan.main, FLAGSHIP_COND + ["--resume", logdir],
                      EVAL_DATA, 9)
    steps = [r["step"] for r in resumed["history"]]
    if steps != [7, 8, 9] or resumed["logdir"] != logdir:
        raise AssertionError(f"the resumed run took steps {steps}")
    expect_launches(resumed, 0, "the resumed flagship")
    resumed_fid = check_fid_run(resumed, (3, 6, 9),
                                "conditional flagship, resumed")
    (ev,) = resumed["history"].evals
    restored = (f"Eval state restored (eval_seed {cond_fid['eval_seed']}, "
                f"FID best {min(cond_fid['means']):.2f})")
    if restored not in Path(logdir, "log.txt").read_text() or \
            ev["fid_best"] != min(resumed_fid["means"]):
        raise AssertionError("the resumed run did not restore the FID "
                             "history, best and eval_seed")
    log(f"  resumed from ckpt/step_6.pt: steps {steps}; {restored}; the CSV "
        f"appended under the same eval_seed")
    if EVAL_LAUNCHES != [0, 0, 0]:
        raise AssertionError(f"blur launches in the flagship's evaluations: "
                             f"{EVAL_LAUNCHES}")

    sndcgan = evaluate_run("sndcgan", logdir, per_step, probe_epochs=2,
                           cddls_steps=20, cddls_samples=5000,
                           cddls_batch=CDDLS_BATCH, use_ema=False)
    phase(f"  the 32x32 StyleGAN2 run: {STEPS} steps evaluating at 3 and "
          f"6, then its evaluation CLIs")
    EVAL_LAUNCHES.clear()
    sg2_run = run_cli(train_stylegan2.main, SG2_EVAL, EVAL_DATA, STEPS, BATCH)
    per_eval = (FID_AVG * -(-FID_SIZE // FID_CHUNK) * per_step["fid_32"]
                + per_step["gif_32"])
    if EVAL_LAUNCHES != [per_eval, per_eval]:
        raise AssertionError(f"blur launches in the evaluations: "
                             f"{EVAL_LAUNCHES}, not {per_eval} each as phase "
                             f"3 counts")
    expect_launches(sg2_run, STEPS * per_step["stylegan2_32"]
                    + 2 * per_eval, "the 32x32 path with its evaluations")
    sg2_fid = check_fid_run(sg2_run, (3, 6), "32x32 StyleGAN2 (EMA G)")
    log(f"  blur launches per evaluation: {EVAL_LAUNCHES} ({FID_AVG} trials x"
        f" {-(-FID_SIZE // FID_CHUNK)} chunks x {per_step['fid_32']}, + "
        f"{per_step['gif_32']} for the GIF frame)")
    sg2 = evaluate_run("stylegan2", sg2_run["logdir"], per_step,
                       probe_epochs=1, cddls_steps=10, cddls_samples=1000,
                       cddls_batch=CDDLS_BATCH_SG2, use_ema=True)
    torch.cuda.empty_cache()

    phase("  card against CPU: a conditional flagship step (batch 64), a "
          "probe step and 3 Langevin steps")
    torch.backends.cudnn.allow_tf32 = False
    cond_err = gan_card_vs_cpu(n_classes=10)
    eval_err = {arch: eval_card_vs_cpu(arch, d) for arch, d in (
        ("sndcgan", logdir), ("stylegan2", sg2_run["logdir"]))}
    seconds = time.perf_counter() - t8
    log(f"  phase 8: {seconds:.1f} s")
    launches = {
        "sndcgan conditional with FID (phase 8, 6 + 3 steps, 3 evaluations)":
            cond["launches"] + resumed["launches"],
        "stylegan2_32 with FID (phase 8, 6 steps, 2 evaluations)":
            sg2_run["launches"],
        "stylegan2_32 FID + GIF per evaluation (phase 8)": per_eval,
        "sndcgan probe, sampling, cDDLS (phase 8)": sum(
            sndcgan[k] for k in ("probe_launches", "sample_launches",
                                 "cddls_launches")),
        "stylegan2_32 probe (phase 8, 1 epoch)": sg2["probe_launches"],
        "stylegan2_32 sampling (phase 8, 1000 samples)":
            sg2["sample_launches"],
        "stylegan2_32 cDDLS (phase 8, 10 chains x 10 steps)":
            sg2["cddls_launches"]}
    return dict(conditional=cond, resumed=resumed, sndcgan=sndcgan,
                stylegan2_run=sg2_run, stylegan2=sg2,
                fid=dict(conditional=resumed_fid, stylegan2_32=sg2_fid,
                         blur_launches_per_evaluation=per_eval),
                card_vs_cpu=dict(conditional_step=cond_err, **eval_err),
                seconds=seconds, launches=launches)


# ------------------------------------------------------- the Inception net

INCEPTION_BATCH = 500


def inception_weights(seed: int = 0):
    """Random, batch-norm-realistic weights of the FID InceptionV3 from a
    numpy seed, under the checkpoint's names (as in
    ``tests/test_torch_port_inception.py``)."""
    import numpy as np
    import torch

    from contrad_tpu_torch.evaluate.inception import InceptionV3FID

    rng = np.random.default_rng(seed)
    out = {}
    for name, t in InceptionV3FID().state_dict().items():
        shape = tuple(t.shape)
        if ".conv." in name:
            v = rng.normal(0.0, 0.05, shape)
        elif ".bn." in name and name.endswith(("weight", "running_var")):
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "fc.weight":
            v = rng.normal(0.0, 0.02, shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        out[name] = torch.from_numpy(v.astype(np.float32))
    return out


def conv_flops(model, size: int) -> float:
    """Multiply-adds x 2 of the convolutions and the fc of one image of
    ``size`` x ``size`` (the resize and the pools not counted)."""
    import torch

    flops = []

    def hook(module, inputs, out):
        if isinstance(module, torch.nn.Conv2d):
            k = module.in_channels * module.kernel_size[0] * \
                module.kernel_size[1] // module.groups
            flops.append(2.0 * k * out.numel())
        else:
            flops.append(2.0 * module.in_features * out.numel())

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.no_grad():
        model(torch.zeros(1, size, size, 3,
                          device=next(model.parameters()).device))
    for h in hooks:
        h.remove()
    return sum(flops)


def inception_variants(state, flops: float):
    """The batch-500 forward on 32x32 inputs in other settings than the
    port's (channels-last, TF32 convolutions, cuDNN's heuristics): TF32
    off; NCHW-contiguous activations and weights; cuDNN's autotuner
    (``cudnn.benchmark``). Yardsticks for where the time goes; the port
    uses none of them. Returns ms by variant."""
    import torch

    from contrad_tpu_torch.evaluate.inception import from_state_dict

    cudnn, out = torch.backends.cudnn, {}
    gen = torch.Generator(device="cuda").manual_seed(32)
    x = torch.rand(INCEPTION_BATCH, 32, 32, 3, device="cuda", generator=gen)
    nchw = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    channels_last = from_state_dict(state, "cuda")
    plain = from_state_dict(state, "cuda").to(
        memory_format=torch.contiguous_format)  # Module.to works in place
    for name, model, inputs, tf32, bench in (
            ("TF32 off", channels_last, x, False, False),
            ("NCHW, TF32", plain, nchw, True, False),
            ("cudnn.benchmark, TF32", channels_last, x, True, True)):
        cudnn.allow_tf32, cudnn.benchmark = tf32, bench
        with torch.no_grad():
            out[name] = cuda_ms(lambda x: model(x), [inputs], iters=10)
        rate = flops * INCEPTION_BATCH / (out[name] * 1e-3) / 1e12
        log(f"  inception forward, batch {INCEPTION_BATCH} of 32x32, "
            f"{name}: {out[name]:.3f} ms, {rate:.1f} TFLOP/s")
    cudnn.allow_tf32, cudnn.benchmark = True, False
    return out


def inception_phase(sample_dir: str):
    """Phase 9: the InceptionV3 on the card against the CPU (TF32 off) at
    batch 2 on 32x32, 299x299 and 512x512 inputs, pool3 and logits; its
    forward timed at batch 500 on 32x32 and 512x512 inputs with TF32 convs
    as in training, beside other settings, and profiled; ``test_fid_is``
    with the moments embedder on phase 8's samples. Returns its numbers."""
    import numpy as np
    import torch

    from contrad_tpu_torch import test_fid_is
    from contrad_tpu_torch.evaluate.inception import from_state_dict

    t9 = time.perf_counter()
    phase("[9] the InceptionV3 (random weights): card against CPU, its "
          "forward's time, and test_fid_is on phase 8's samples")
    state = inception_weights()
    torch.backends.cudnn.allow_tf32 = False
    cpu, card = from_state_dict(state, "cpu"), from_state_dict(state, "cuda")
    rng = np.random.default_rng(9)
    errs = {}
    for size in (32, 299, 512):
        x = torch.from_numpy(rng.uniform(size=(2, size, size, 3)).astype(
            np.float32))
        with torch.no_grad():
            want, got = cpu(x), card(x.cuda())
        for name, g, w in zip(("pool3", "logits"), got, want):
            errs[f"{name} {size}"] = _check_close(
                f"inception {name} at {size}x{size}", g, w)
    del cpu
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for training
    timing = {}
    flops = conv_flops(card, 299)
    for size in (32, 512):
        gen = torch.Generator(device="cuda").manual_seed(size)
        x = torch.rand(INCEPTION_BATCH, size, size, 3, device="cuda",
                       generator=gen)
        with torch.no_grad():
            ms = cuda_ms(lambda x: card(x), [x], iters=10)
        timing[size] = dict(ms=ms, img_per_s=INCEPTION_BATCH / (ms * 1e-3),
                            tflop_per_s=flops * INCEPTION_BATCH / (ms * 1e-3)
                            / 1e12)
        log(f"  inception forward, batch {INCEPTION_BATCH} of {size}x{size}: "
            f"{ms:.3f} ms, {timing[size]['img_per_s']:.1f} img/s, "
            f"{timing[size]['tflop_per_s']:.1f} TFLOP/s of "
            f"{flops / 1e9:.3f} GFLOP an image (convs and fc at 299x299)")
        del x
    timing["variants_32"] = inception_variants(state, flops)
    gen = torch.Generator(device="cuda").manual_seed(32)
    x = torch.rand(INCEPTION_BATCH, 32, 32, 3, device="cuda", generator=gen)
    log("  the batch-500 forward on 32x32 inputs under the profiler:")
    with torch.no_grad():
        timing["profile_32"] = class_report(*profile_rows(lambda: card(x), 2))
    del x
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scored = test_fid_is.main([sample_dir, "--embed", "moments", "--dataset",
                               EVAL_DATA, "--no_is"])
    score_s = time.perf_counter() - t0
    if scored["n_images"] != 1000 or not math.isfinite(scored["fid"]):
        raise AssertionError(f"test_fid_is: {scored}")
    log(f"  test_fid_is --embed moments on {scored['n_images']} samples: "
        f"FID {scored['fid']:.6g} in {score_s:.2f} s")
    seconds = time.perf_counter() - t9
    log(f"  phase 9: {seconds:.1f} s")
    return dict(card_vs_cpu=errs, gflop_per_image=flops / 1e9,
                forward=timing, test_fid_is=dict(scored, seconds=score_s),
                seconds=seconds)


# ------------------------------------------------------- mixed precision

# the production stack of the JAX record, through the CLIs' four flags
BF16_STACK = ["--dtype", "bf16", "--opt_moments", "bf16", "--opt_nu", "bf16",
              "--opt_grads", "bf16"]
BF16_REL, BF16_COS = 3e-2, 0.99  # tests/test_torch_port_bf16_step.py's
# where bf16's own cosine to float32 is below 0.99: the card's bf16
# gradient at most this many times as far (in 1 - cosine) from the CPU's
# as the float32 one is (their convs accumulate in other orders, so the
# two bf16 roundings share less than the port's and JAX's on the CPU)
BF16_SPREAD = 1.1


def _cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def layer_dtypes(*modules) -> dict:
    """Forward hooks on every submodule: {name: the set of its output
    dtypes}, filled as the modules run."""
    import torch

    seen = {}

    def hook(name):
        def forward_hook(_, __, out):
            if isinstance(out, torch.Tensor):
                seen.setdefault(name, set()).add(str(out.dtype))
        return forward_hook

    for i, module in enumerate(modules):
        for name, m in module.named_modules():
            m.register_forward_hook(hook(f"{'GD'[i]}.{name}"))
    return seen


def strength_sums(G) -> dict:
    """Hooks on a StyleGAN2 G's ``NoiseInjection`` modules: per strength,
    ``sum|g * noise|`` and ``sum(g * noise)`` in float64, ``g`` the gradient
    reaching the injection in the backward of the (one) forward that has
    one. Fills the dict it returns as the step runs."""
    from contrad_tpu_torch.models.stylegan2.generator import NoiseInjection

    sums = {}

    def hook(name):
        def forward_hook(_, args, out):
            if out.requires_grad:
                noise = args[1].detach().double()

                def grad_hook(g):
                    p = g.detach().double() * noise
                    sums[name] = (float(p.abs().sum()), float(p.sum()))
                out.register_hook(grad_hook)
        return forward_hook

    for name, m in G.named_modules():
        if isinstance(m, NoiseInjection):
            m.register_forward_hook(hook(f"G.{name}.weight"))
    return sums


def bf16_card_vs_cpu(arch: str, batch: int) -> dict:
    """One step of a recipe's trainer under the bfloat16 compute dtype on
    the card and on the CPU, from the same weights, images and draws, TF32
    off, the gradients kept (``KeepGrads``): ``sndcgan`` the flagship's
    ``GANTrainer`` (contrad, simclr), ``stylegan2_512`` the 512x512
    recipe's ``StyleGAN2Trainer`` with R1. Held as the CPU parity test
    holds the port to JAX: losses within 3e-2 of the CPU's; each gradient
    tensor's cosine against the CPU's bfloat16 one at least 0.99, or, where
    the CPU's bfloat16 gradient is further from the float32 one (taken on
    the card), ``1 - cosine`` at most ``BF16_SPREAD`` times theirs; every
    module's output dtype the same on both (``layer_dtypes``); where the
    float32 gradient
    vanishes (a bias a batch norm follows) the card's noise at most twice
    the CPU's; each StyleGAN2 noise strength (a scalar, ``sum(g * noise)``
    over its layer) within ``2^-8 * sum|g * noise|`` (``g`` the card's
    gradient reaching the injection) of the CPU's bfloat16 value, of the
    float32 one and of ``sum(g * noise)`` in float64, with their sign
    wherever they exceed that bound."""
    import torch

    from contrad_tpu_torch.augment import get_augment
    from contrad_tpu_torch.config import default_config_files, load_config
    from contrad_tpu_torch.models import get_architecture
    from contrad_tpu_torch.training import GANTrainer, StyleGAN2Trainer

    size = 512 if arch == "stylegan2_512" else 32
    images = torch.rand(batch, size, size, 3,
                        generator=torch.Generator().manual_seed(5))
    draws, out, strengths, dtypes = None, {}, {}, {}
    for device, dtype in (("cpu", "bf16"), ("cuda", "bf16"), ("cuda", "f32")):
        G, D = get_architecture(arch, (size, size, 3), device=device, seed=1,
                                dtype=dtype)
        g_tx, d_tx = KeepGrads(), KeepGrads()
        if (device, dtype) == ("cuda", "bf16"):
            strengths = strength_sums(G)  # filled by the step
        if dtype == "bf16":
            dtypes[device] = layer_dtypes(G, D)  # likewise
        if arch == "stylegan2_512":
            hyper = load_config(default_config_files(RECIPE_512[0])).get(
                "augment")
            trainer = StyleGAN2Trainer(
                G, D, mode="contrad", augment=get_augment("simclr_hq", hyper),
                g_optimizer=g_tx, d_optimizer=d_tx, loss_type="nonsat",
                lbd_r1=0.5, d_reg_every=16)
            if draws is None:
                draws = trainer.draw_step(images.shape, with_r1=True)
        else:
            trainer = GANTrainer(G, D, mode="contrad",
                                 augment=get_augment("simclr"),
                                 g_optimizer=g_tx, d_optimizer=d_tx,
                                 loss_type="nonsat")
            if draws is None:
                draws = trainer.draw_step(images.shape)
        t0 = time.perf_counter()
        metrics = trainer.train_step(images.to(device),
                                     draws=_to(draws, device))
        grads = {f"G.{k}": g.cpu() for (k, _), g in zip(G.named_parameters(),
                                                         g_tx.grads)}
        grads.update({f"D.{k}": g.cpu() for (k, _), g in zip(
            D.named_parameters(), d_tx.grads)})
        out[device, dtype] = ({k: float(v) for k, v in metrics.items()},
                              grads, time.perf_counter() - t0)
        del trainer, G, D
        torch.cuda.empty_cache()
    (want_m, want_g, cpu_s), (got_m, got_g, card_s), (_, f32_g, _) = (
        out["cpu", "bf16"], out["cuda", "bf16"], out["cuda", "f32"])
    failed, worst_loss, cosines = [], 0.0, []
    for k, w in want_m.items():
        g = got_m[k]
        err = abs(g - w)
        log(f"  {k:10s} card {g:.6g} cpu {w:.6g} (tol {BF16_REL * abs(w):.3g})")
        if not (math.isfinite(g) and err <= BF16_REL * abs(w) + 1e-6):
            failed.append(k)
        worst_loss = max(worst_loss, err / (abs(w) + 1e-12))
    for k, w in want_g.items():
        g = got_g[k]
        if not bool(torch.isfinite(g).all()):
            failed.append(k)
            continue
        if k in strengths:
            abs_sum, own = strengths[k]
            bound = 2.0 ** -8 * abs_sum
            refs = (("cpu", float(w)), ("f32", float(f32_g[k])), ("own", own))
            log(f"  {k:44s} card {float(g):+.4e} " + " ".join(
                f"{r} {v:+.4e}" for r, v in refs) + f" (bound {bound:.2e})")
            if not all(abs(float(g) - v) <= bound and (
                    abs(v) <= bound or (float(g) > 0) == (v > 0))
                    for _, v in refs):
                failed.append(k)
            continue
        if float(f32_g[k].norm()) < 1e-6:
            if not float(g.norm()) <= max(2 * float(w.norm()), 1e-4):
                failed.append(k)
            continue
        bound = min(BF16_COS,
                    1 - BF16_SPREAD * (1 - _cosine(w, f32_g[k])))
        cos = _cosine(g, w)
        cosines.append(cos)
        if bound < BF16_COS or not cos >= bound:
            log(f"  {k:44s} cosine {cos:.4f} (bound {bound:.4f}; card f32 "
                f"vs CPU {_cosine(f32_g[k], w):.4f})")
        if not cos >= bound:
            failed.append(k)
    wrong = sorted(k for k in dtypes["cpu"].keys() | dtypes["cuda"].keys()
                   if dtypes["cpu"].get(k) != dtypes["cuda"].get(k))
    if wrong or not any("torch.bfloat16" in d for d in dtypes["cuda"].values()):
        log("  layer dtypes differ (cpu, card): " + ", ".join(
            f"{k} {dtypes['cpu'].get(k)} {dtypes['cuda'].get(k)}"
            for k in wrong))
        failed.append("layer dtypes")
    if arch == "stylegan2_512" and len(strengths) != 15:
        failed.append(f"{len(strengths)} noise strengths seen, not 15")
    log(f"  {len(want_g)} gradient tensors: cosine card vs CPU "
        f"{min(cosines):.4f} at worst ({sum(c >= BF16_COS for c in cosines)}"
        f" of {len(cosines)} at 0.99 or more; {len(strengths)} noise "
        f"strengths checked; {len(dtypes['cuda'])} modules' output dtypes "
        f"as on the CPU); losses within {worst_loss:.2e} "
        f"relative; step {cpu_s:.1f} s on the CPU, {card_s:.2f} s on the card"
        f" (first)")
    if failed:
        raise AssertionError(f"bfloat16 {arch} step: card and CPU disagree "
                             f"on {failed}")
    return dict(batch=batch, min_cosine=min(cosines),
                worst_loss_rel=worst_loss, cpu_s=cpu_s, card_s=card_s)


def bf16_phase(per_step, step_sum) -> dict:
    """Phase 10: each README recipe through its CLI in float32 and under the
    bfloat16 stack, in turns (f32, bf16, f32, bf16): ms/step, img/s, peak
    memory (and the 512x512 recipe's R1 step), the blur launching as phase
    3 counts in every run, never on its scalar path; a profile of 3
    bfloat16 512x512 steps; a bfloat16 flagship step and 512x512 step with
    R1 card against CPU. Returns its numbers."""
    import torch

    from contrad_tpu_torch import (
        train_gan, train_stylegan2, train_stylegan2_contraD)

    t10 = time.perf_counter()
    phase("[10] mixed precision: the three recipes in float32 and under the "
          "bf16 stack (" + " ".join(BF16_STACK) + "), in turns")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for training
    recipes = (
        ("sndcgan", train_gan.main, FLAGSHIP, "synthetic_32", STEPS, None,
         0),
        ("stylegan2_32", train_stylegan2.main, RECIPE, "synthetic_32", STEPS,
         BATCH, STEPS * per_step["stylegan2_32"]),
        ("stylegan2_512", train_stylegan2_contraD.main, RECIPE_512, DATA_512,
         STEPS_512, BATCH_512, (STEPS_512 - 1) * per_step["stylegan2_512"]
         + per_step["stylegan2_512_r1"]))
    runs = {}
    for name, main, recipe, data, steps, batch, launches in recipes:
        for turn in ("f32", "bf16", "f32", "bf16"):
            r = run_cli(main, recipe + (BF16_STACK if turn == "bf16" else []),
                        data, steps, batch)
            expect_launches(r, launches, f"the {turn} {name} run")
            if name == "stylegan2_512":
                h = r["history"]
                if [x["step"] for x in h if x["D_r1"] > 0] != [16]:
                    raise AssertionError("R1 did not run at step 16")
                r["ms_per_plain_step"] = 1e3 * sum(
                    x["seconds_per_step"] for x in h[1:15]) / 14
                r["ms_per_r1_step"] = 1e3 * h[15]["seconds_per_step"]
                r["img_per_s"] = BATCH_512 / (r["ms_per_plain_step"] * 1e-3)
                r["ms_per_step"] = r["ms_per_plain_step"]
            extra = (f", R1 step {r['ms_per_r1_step']:.2f} ms"
                     if "ms_per_r1_step" in r else "")
            log(f"  {name:13s} {turn:4s} batch {r['batch']}: "
                f"{r['ms_per_step']:.2f} ms/step, {r['img_per_s']:.1f} img/s"
                f"{extra}; peak {r['peak_bytes'] / 2**30:.3f} GiB; blur "
                f"launches {r['launches']} (scalar {r['scalar_launches']})")
            runs.setdefault(name, {}).setdefault(turn, []).append(
                {k: v for k, v in r.items() if k != "history"})
            del r
            torch.cuda.empty_cache()
    for name in runs:
        f32 = [r["ms_per_step"] for r in runs[name]["f32"]]
        bf = [r["ms_per_step"] for r in runs[name]["bf16"]]
        log(f"  {name}: f32 {min(f32):.2f}-{max(f32):.2f} ms/step, bf16 "
            f"{min(bf):.2f}-{max(bf):.2f} (bf16/f32 {sum(bf) / sum(f32):.3f})")
    prof = profile(train_stylegan2, RECIPE_512 + BF16_STACK, DATA_512,
                   BATCH_512)
    expect_launches(prof, per_step["stylegan2_512"],
                    "a profiled bf16 512x512 step")
    log(f"  blur kernel per bf16 plain step: {prof['blur_ms_per_step']:.3f} "
        f"ms under the profiler; phase 3's bfloat16 times weighted by "
        f"launches per step: {step_sum['stylegan2_512 bfloat16 ms']:.3f} ms "
        f"warm ({step_sum['stylegan2_32 bfloat16 ms']:.3f} ms a 32x32 step)")
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    phase("  a bf16 flagship step (batch 64) card against CPU")
    gan = bf16_card_vs_cpu("sndcgan", 64)
    phase("  a bf16 512x512 step (batch 4, R1) card against CPU")
    sg512 = bf16_card_vs_cpu("stylegan2_512", 4)
    seconds = time.perf_counter() - t10
    log(f"  phase 10: {seconds:.1f} s")
    return dict(runs=runs, profile_512=prof, card_vs_cpu=dict(
        sndcgan=gan, stylegan2_512=sg512), seconds=seconds)


# ------------------------------------------------------- the graph path

GRAPH_K = 4  # --steps_per_dispatch of phase 11's graph runs
# the first step of each recipe's equality run (two blocks of GRAPH_K
# steps): the 512x512 recipe's lazy R1 (every 16 steps) falls at step 16,
# the second step of the second block
EQUAL_FROM = {"sndcgan": 1, "stylegan2_32": 1, "stylegan2_512": 11}
# each recipe's timed runs: printed every GRAPH_K steps; the 512x512 run's
# last window holds the R1 step
TIMED_STEPS = {"sndcgan": 12, "stylegan2_32": 12, "stylegan2_512": 16}


def graph_recipes(per_step):
    """The README recipes of phase 11: name, the module that builds the
    trainer, the CLI's ``main``, the recipe, its data and batch, and the
    blur's launches per step of each step kind (phase 3's counts)."""
    from contrad_tpu_torch import (
        train_gan, train_stylegan2, train_stylegan2_contraD)

    return (
        ("sndcgan", train_gan, train_gan.main, FLAGSHIP, "synthetic_32",
         None, {"plain": 0}),
        ("stylegan2_32", train_stylegan2, train_stylegan2.main, RECIPE,
         "synthetic_32", BATCH, {"r1": per_step["stylegan2_32"]}),
        ("stylegan2_512", train_stylegan2, train_stylegan2_contraD.main,
         RECIPE_512, DATA_512, BATCH_512,
         {"plain": per_step["stylegan2_512"],
          "r1": per_step["stylegan2_512_r1"]}))


def trainer_tensors(trainer, metrics):
    """Every tensor of the trainer's state (G, D, EMA, ``u``, batch-norm
    statistics, Adam's moments, the generator's state), both optimisers'
    device and host counts and the metrics, copied."""
    import torch

    out = flat_tensors(trainer.state_dict())
    out.update({f"metric.{k}": v for k, v in metrics.items()})
    for name in ("g_tx", "d_tx"):
        opt = getattr(trainer, name)
        out[f"{name}.count_t"] = opt.count_t
        out[f"{name}.count"] = torch.tensor(opt.count)
    return {k: v.detach().clone() for k, v in out.items()}


def hold_to_yardstick(eager, graph, again, what: str, spreads=None):
    """``graph`` against ``eager``, with ``again`` (a second eager run from
    the same state) as the yardstick of the kernels' own nondeterminism:
    bitwise where the two eager runs agree bitwise, else within twice their
    distance (``spreads``, by name, where given) and 1e-4 + 1e-4 * max.
    Returns the counts and the eager runs' distances."""
    import torch

    if not (eager.keys() == graph.keys() == again.keys()):
        raise AssertionError(f"{what}: the runs hold other tensors")
    out = dict(tensors=len(eager), bitwise=0, eager_bitwise=0, worst=0.0,
               worst_name=None)
    dist = {}
    for name, a in eager.items():
        b, g = again[name], graph[name]
        if g.dtype != a.dtype or g.shape != a.shape:
            raise AssertionError(f"{what}: {name} has another dtype or shape")
        same = torch.equal(a, b)
        out["eager_bitwise"] += same
        if torch.equal(g, a):
            out["bitwise"] += 1
            dist[name] = 0.0 if same else float(
                (b.double() - a.double()).abs().max())
            continue
        if same and spreads is None:
            raise AssertionError(f"{what}: {name} differs from the eager "
                                 f"run where two eager runs agree bitwise")
        spread = (float((b.double() - a.double()).abs().max())
                  if spreads is None else spreads.get(name, 0.0))
        err = float((g.double() - a.double()).abs().max())
        scale = float(a.double().abs().max())
        if err > 2 * spread or err > 1e-4 + 1e-4 * scale:
            raise AssertionError(f"{what}: {name} {err:.3g} from the eager "
                                 f"run, the eager runs {spread:.3g} apart")
        dist[name] = spread
        if err / max(scale, 1e-30) > out["worst"]:
            out["worst"], out["worst_name"] = err / max(scale, 1e-30), name
    rng = [k for k in eager if k.startswith("rng.")]
    if not rng or any(not torch.equal(graph[k], eager[k]) for k in rng):
        raise AssertionError(f"{what}: the generator's state differs")
    return out, dist


def graph_trainer(module, recipe, data: str, batch):
    override = [f"options.dataset={data}"] + (
        [f"options.batch_size={batch}"] if batch else [])
    P = module.parse_args(recipe + ["--seed", "0", "--override"] + override)
    cfg, loader, trainer = module.build(P)
    return P, cfg.options, loader, trainer


def block_args(module, P, opt, steps):
    """The per-step ``ema_decay`` and ``do_r1`` the CLI gives a block."""
    return (module.step_args(P, opt.batch_size, steps)
            if hasattr(module, "step_args") else {})


def graph_equality(name, module, recipe, data, batch, kinds, dtype: str):
    """Two blocks of GRAPH_K steps from one snapshot of the recipe's trainer
    as CUDA graph replays, as eager steps, and as eager steps again, held to
    each other (``hold_to_yardstick``), with the blur's launches through
    the replays as phase 3 counts them and none on the scalar path. Returns
    the numbers and the eager runs' distances."""
    import numpy as np
    import torch

    from contrad_tpu_torch.ops import blur
    from contrad_tpu_torch.training.graph import (
        WARMUP_STEPS, BlockRunner, _clone)

    P, opt, loader, trainer = graph_trainer(module, recipe, data, batch)
    n = 2 * GRAPH_K
    pairs = [loader.next_indices() for _ in range(n)]
    idx = [p[0] for p in pairs]
    labels = [p[1] for p in pairs] if trainer.conditional else None
    steps = np.arange(EQUAL_FROM[name], EQUAL_FROM[name] + n)
    args = block_args(module, P, opt, steps)
    step_kinds = ["r1" if r else "plain"
                  for r in args.get("do_r1", np.zeros(n, bool))]
    snapshot = _clone(trainer.state_dict())
    runs = {}
    for run, graphs in (("eager", False), ("graph", True), ("again", False)):
        trainer.load_state_dict(snapshot)
        runner = BlockRunner(trainer, loader, graphs=graphs)
        blur.blur2d.launches = blur.blur2d.scalar_launches = 0
        for b in range(0, n, GRAPH_K):
            metrics = runner.run(
                idx[b:b + GRAPH_K],
                None if labels is None else labels[b:b + GRAPH_K],
                **{k: v[b:b + GRAPH_K] for k, v in args.items()})
        torch.cuda.synchronize()
        runs[run] = (trainer_tensors(trainer, metrics), runner,
                     blur.blur2d.launches, blur.blur2d.scalar_launches)
    del snapshot
    stats = runs["graph"][1].stats
    replays = sum(kinds[k] for k in step_kinds)
    warm = sum(WARMUP_STEPS * kinds[k] for k in stats["capture_seconds"])
    if (stats["captured_launches"] != {k: kinds[k] for k in set(step_kinds)}
            or stats["replay_launches"] != replays
            or runs["graph"][2] != replays + warm
            or runs["eager"][2] != runs["again"][2] != replays
            or any(r[3] for r in runs.values())):
        raise AssertionError(
            f"{name} {dtype}: blur launches {stats} (graph run "
            f"{runs['graph'][2]}, eager {runs['eager'][2]}, scalar "
            f"{[r[3] for r in runs.values()]}), not phase 3's {kinds} a "
            f"step over {step_kinds}")
    held, dist = hold_to_yardstick(runs["eager"][0], runs["graph"][0],
                                   runs["again"][0], f"{name} {dtype}")
    log(f"  {name} {dtype}: graph vs eager over steps {steps[0]}-{steps[-1]}"
        f" ({step_kinds.count('r1')} with R1): {held['bitwise']} of "
        f"{held['tensors']} tensors bitwise (the two eager runs agree on "
        f"{held['eager_bitwise']}); worst relative {held['worst']:.3g} "
        f"({held['worst_name']}); generator state bitwise; blur through "
        f"replays {stats['replay_launches']} (captured {stats['captured_launches']}"
        f", warm-up {warm}), scalar 0; capture "
        + ", ".join(f"{k} {v:.2f} s" for k, v in
                    stats["capture_seconds"].items()))
    del runs, trainer, loader
    return dict(held, capture_seconds=stats["capture_seconds"],
                replay_launches=stats["replay_launches"]), dist


def block_profile(name, module, recipe, data, batch, graphs: bool):
    """torch.profiler over one block of GRAPH_K plain steps (R1 on none of
    them), as graph replays or as eager steps, after a block that warms up
    (and captures the graph): kernel time by class, the idle share and
    launches per step (``class_report``)."""
    import numpy as np

    from contrad_tpu_torch.training.graph import BlockRunner

    P, opt, loader, trainer = graph_trainer(module, recipe, data, batch)
    runner = BlockRunner(trainer, loader, graphs=graphs)
    args = block_args(module, P, opt, np.arange(1, GRAPH_K + 1))

    def run_block():
        block = [loader.next_indices() for _ in range(GRAPH_K)]
        runner.run([b[0] for b in block], [b[1] for b in block]
                   if trainer.conditional else None, **args)

    run_block()  # warm-up (and capture)
    wall, rows = profile_rows(run_block, 1)
    if not rows:
        raise AssertionError("the profiler saw no kernel of the block")
    log(f"  {name}: profile of one {'graph' if graphs else 'eager'} block "
        f"({GRAPH_K} plain steps), per step:")
    return class_report(wall / GRAPH_K, [(ms / GRAPH_K, c / GRAPH_K, k)
                                         for ms, c, k in rows])


def graph_resume(name, main, recipe, data, batch, spreads, kinds):
    """A graph run (K = GRAPH_K) of 8 steps against 4, a checkpoint and
    ``--resume`` to 8, through the recipe's CLI: the final checkpoints held
    to each other as ``hold_to_yardstick`` holds a graph run (bitwise, or
    within twice the eager runs' distance of phase 11's equality run)."""
    import torch

    from contrad_tpu_torch.utils.checkpoint import restore_checkpoint

    flags = ["--steps_per_dispatch", str(GRAPH_K), "--evaluate_every",
             str(GRAPH_K), "--no_fid", "--no_gif"]
    straight = run_cli(main, recipe + flags, data, 8, batch, GRAPH_K)
    first = run_cli(main, recipe + flags, data, 4, batch, GRAPH_K)
    resumed = run_cli(main, recipe + flags + ["--resume", first["logdir"]],
                      data, 8, batch, GRAPH_K)
    if [r["step"] for r in resumed["history"]] != [8] or any(
            r["dispatch"]["k"] != GRAPH_K for r in (straight, resumed)):
        raise AssertionError(f"{name}: the resumed graph run did not take "
                             f"blocks of {GRAPH_K} from step 5")
    want = flat_tensors(restore_checkpoint(straight["logdir"]))
    got = flat_tensors(restore_checkpoint(first["logdir"]))
    held, _ = hold_to_yardstick(want, got, want, f"{name} resume",
                                spreads=spreads)
    log(f"  {name} resumed at step 5 against the uninterrupted graph run: "
        f"{held['bitwise']} of {held['tensors']} checkpoint tensors bitwise"
        f"; worst relative {held['worst']:.3g}")
    torch.cuda.empty_cache()
    return held


def timed_graph_runs(name, main, recipe, data, batch, kinds, flags):
    """The recipe through its CLI, eager (``--steps_per_dispatch 1``) and
    graph (``GRAPH_K``) in turns (eager, graph, eager, graph), printed every
    GRAPH_K steps: ms/step (the windows after the first; the 512x512
    recipe's plain steps from its middle windows and its R1 step from the
    last), img/s, peak memory, capture seconds, and the blur launching as
    phase 3 counts (warm-up steps included), never on its scalar path."""
    import gc

    import torch

    from contrad_tpu_torch.training.graph import WARMUP_STEPS

    steps = TIMED_STEPS[name]
    out = {"eager": [], "graph": []}
    for turn in ("eager", "graph", "eager", "graph"):
        k = 1 if turn == "eager" else GRAPH_K
        r = run_cli(main, recipe + flags + ["--steps_per_dispatch", str(k)],
                    data, steps, batch, GRAPH_K)
        if r["dispatch"]["k"] != k:
            raise AssertionError(f"{name}: K resolved to {r['dispatch']['k']}")
        stats = r["dispatch"]["stats"]
        if "r1" not in kinds:
            n_kind = {"plain": steps}
        elif "plain" not in kinds:
            n_kind = {"r1": steps}
        else:  # lazy R1 every 16 steps (the 512x512 recipe)
            n_kind = {"plain": steps - steps // 16, "r1": steps // 16}
        want = sum(kinds[kd] * c for kd, c in n_kind.items()) + sum(
            kinds[kd] * WARMUP_STEPS for kd in stats["capture_seconds"])
        expect_launches(r, want, f"the {turn} {name} run")
        h = r["history"]
        if name == "stylegan2_512":
            plain = [x["seconds_per_step"] for x in h[1:-1]]
            r["ms_per_step"] = 1e3 * sum(plain) / len(plain)
            r["ms_per_r1_step"] = 1e3 * (GRAPH_K * h[-1]["seconds_per_step"]
                                         - (GRAPH_K - 1) * sum(plain)
                                         / len(plain))
            r["img_per_s"] = r["batch"] / (r["ms_per_step"] * 1e-3)
            if h[-1]["D_r1"] <= 0:
                raise AssertionError("the last window carries no R1")
        r["capture_s"] = sum(stats["capture_seconds"].values())
        extra = (f", R1 step {r['ms_per_r1_step']:.2f} ms"
                 if "ms_per_r1_step" in r else "")
        log(f"  {name:13s} {turn:5s} K={k}: {r['ms_per_step']:.2f} ms/step, "
            f"{r['img_per_s']:.1f} img/s{extra}; peak "
            f"{r['peak_bytes'] / 2**30:.3f} GiB; capture {r['capture_s']:.2f}"
            f" s; blur launches {r['launches']} (scalar "
            f"{r['scalar_launches']})")
        out[turn].append({k_: v for k_, v in r.items() if k_ != "history"})
        del r, h
        gc.collect()
        torch.cuda.empty_cache()
    e = [r["ms_per_step"] for r in out["eager"]]
    g = [r["ms_per_step"] for r in out["graph"]]
    log(f"  {name}: eager {min(e):.2f}-{max(e):.2f} ms/step, graph "
        f"{min(g):.2f}-{max(g):.2f} (graph/eager {sum(g) / sum(e):.3f})")
    return out


def jitter_cost(batch: int = 64, size: int = 512) -> dict:
    """The colour jitter's two orders (both computed, one selected on the
    device) against one order, forward and backward on (batch, size, size,
    3), float32 and bfloat16: ms (CUDA events)."""
    import torch

    from contrad_tpu_torch.augment import AugRng
    from contrad_tpu_torch.augment.color import ColorJitter

    jitter = ColorJitter()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.rand(batch, size, size, 3, device="cuda").to(dtype)
        x.requires_grad_(True)
        params = jitter.sample(tuple(x.shape), AugRng.from_seed(0, x.device))
        one = lambda xx: jitter._contrast(jitter._hsv(xx, params), params)
        both = lambda xx: jitter.apply(xx, params)
        for which, fn in (("two orders", both), ("one order", one)):
            out[f"{which} {str(dtype)[6:]}"] = cuda_ms(
                lambda xx: fn(xx).sum().backward(), [x], iters=10)
    log("  colour jitter, forward + backward at "
        f"({batch}, {size}, {size}, 3): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in out.items()))
    return out


def adam_schedule_cost() -> dict:
    """``ScheduledAdam.schedule`` (the learning rate from the device count,
    warmup and half-life decay, and both bias corrections): host us a
    call, device us a call (CUDA-graph replays) and kernels a call."""
    import torch

    from contrad_tpu_torch.training.state import ScheduledAdam

    p = torch.nn.Parameter(torch.zeros(8, device="cuda"))
    opt = ScheduledAdam([p], 2e-3, (0.0, 0.99), warmup=3000,
                        use_warmup=True,
                        lr_decay_fn=lambda c: 0.5 ** ((c // 1000) * 1000
                                                      * 16 / 2e6))
    call = lambda _: opt.schedule(torch.float32, torch.float32)
    call(None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        call(None)
    torch.cuda.synchronize()
    host_us = 1e3 * (time.perf_counter() - t0)
    _, rows = profile_rows(lambda: call(None), 20)
    kernels = sum(count for _, count, _ in rows)
    device_us = 1e3 * cuda_ms(call, [None], iters=100, graph=True)
    # the bias corrections 1 - b ** t in float32 over the first 200,000
    # updates at the recipes' betas: float32 ulps between the card's and
    # the CPU's ``schedule`` (a float exponent), the host formula of earlier
    # releases (``1 - tensor(b) ** t`` with a Python int t, on the CPU) and
    # the correctly rounded value (float64 from the float32 beta)
    n = 200000
    t = torch.arange(1, n + 1, dtype=torch.float32)
    ulps = {}
    for b in (0.5, 0.999, 0.99):
        bc = {dev: (1.0 - torch.pow(torch.tensor(b, device=dev),
                                    t.to(dev))).cpu()
              for dev in ("cuda", "cpu")}
        beta = torch.tensor(b)
        bc["host formula"] = torch.tensor(
            [float(1.0 - beta ** i) for i in range(1, n + 1)])
        bc["rounded"] = (1.0 - torch.pow(beta.double(), t.double())).float()
        u = {}
        for one, other in (("cuda", "cpu"), ("cuda", "host formula"),
                           ("cuda", "rounded"), ("cpu", "rounded"),
                           ("host formula", "rounded")):
            d = (bc[one].view(torch.int32)
                 - bc[other].view(torch.int32)).abs()
            u[f"{one} vs {other}".replace("cuda", "card")] = dict(
                max=int(d.max()), differ=int((d > 0).sum()))
        ulps[str(b)] = u
    log(f"  Adam's device-side schedule: {host_us:.1f} us host, "
        f"{device_us:.2f} us device, {kernels:.0f} kernels a call")
    for b, u in ulps.items():
        log(f"    bias corrections, beta {b}, updates 1-{n}: " + "; ".join(
            f"{k}: {v['differ']} differ, at most {v['max']} ulps"
            for k, v in u.items()))
    return dict(host_us=host_us, device_us=device_us, kernels=kernels,
                bias_correction_ulps=ulps)


def graph_phase(per_step) -> dict:
    """Phase 11: the graph path (``--steps_per_dispatch``, CUDA graphs of
    the train step) for each README recipe at full width. Returns its
    numbers."""
    import gc

    import torch

    t11 = time.perf_counter()
    phase(f"[11] the graph path: blocks of {GRAPH_K} steps as CUDA graph "
          f"replays, the flagship at 512, StyleGAN2 32x32 at {BATCH}, "
          f"512x512 at {BATCH_512}")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for training
    recipes = graph_recipes(per_step)
    out = {"equality": {}, "resume": {}, "times": {}}
    phase("  equality: graph against eager from one snapshot, cuDNN "
          "deterministic (so that the eager runs agree bitwise)")
    torch.backends.cudnn.deterministic = True
    spreads = {}
    for name, module, main, recipe, data, batch, kinds in recipes:
        for dtype, flags in (("f32", []), ("bf16", BF16_STACK)):
            if dtype == "bf16" and name != "stylegan2_512":
                continue
            out["equality"][f"{name} {dtype}"], dist = graph_equality(
                name, module, recipe + flags, data, batch, kinds, dtype)
            if dtype == "f32":
                spreads[name] = dist
            gc.collect()
            torch.cuda.empty_cache()
    phase("  resume: a graph run checkpointed at step 4 and resumed")
    for name, module, main, recipe, data, batch, kinds in recipes:
        out["resume"][name] = graph_resume(name, main, recipe, data, batch,
                                           spreads[name], kinds)
    torch.backends.cudnn.deterministic = False
    phase("  times: eager and graph in turns, float32 and the bf16 stack, "
          "and a profile of one eager and one graph block")
    out["profiles"] = {}
    for name, module, main, recipe, data, batch, kinds in recipes:
        for dtype, flags in (("f32", []), ("bf16", BF16_STACK)):
            out["times"][f"{name} {dtype}"] = timed_graph_runs(
                name, main, recipe, data, batch, kinds, flags)
            for run in ("eager", "graph"):
                out["profiles"][f"{name} {dtype} {run}"] = block_profile(
                    f"{name} {dtype}", module, recipe + flags, data, batch,
                    graphs=run == "graph")
            gc.collect()
            torch.cuda.empty_cache()
    out["jitter"] = jitter_cost()
    out["adam_schedule"] = adam_schedule_cost()
    phase("  --trace_steps 2 on the 32x32 recipe")
    from contrad_tpu_torch import train_stylegan2

    r = run_cli(train_stylegan2.main, RECIPE + ["--trace_steps", "2"],
                "synthetic_32", 4, BATCH, GRAPH_K)
    traces = sorted(Path(r["logdir"], "profile").glob("*.json"))
    if r["dispatch"]["k"] != GRAPH_K or len(traces) != 1:
        raise AssertionError(f"--trace_steps 2: K {r['dispatch']['k']}, "
                             f"trace files {traces}")
    out["trace_bytes"] = traces[0].stat().st_size
    marks = traces[0].read_text().count('"contrad_mark_step_begin"')
    if marks < GRAPH_K:
        raise AssertionError(f"--trace_steps 2: {marks} step marks")
    log(f"  trace {traces[0].name}: {out['trace_bytes'] / 2**20:.2f} MiB; "
        f"K = {GRAPH_K}, {marks} step marks")
    out["seconds"] = time.perf_counter() - t11
    log(f"  phase 11: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------- the world path

WORLD_STEPS = 8  # phase 12a: two blocks of GRAPH_K steps
WORLD_DATA = {"synthetic_32": "synthetic_32_512",  # fewer rows to draw in a
              DATA_512: "synthetic_512_64"}  # fresh process, same shapes
# a world process of phase 12a: the CLI (argv[1]) with cuDNN deterministic,
# its history, dispatch stats, blur launches and collectives dumped to argv[2]
WORLD_CLI = (
    "import importlib, json, sys, torch\n"
    "torch.backends.cudnn.deterministic = True\n"
    "from contrad_tpu_torch.ops import blur\n"
    "from contrad_tpu_torch.parallel import collectives\n"
    "cli = importlib.import_module('contrad_tpu_torch.' + sys.argv[1])\n"
    "h = cli.main(sys.argv[3:])\n"
    "json.dump(dict(logdir=h.logdir, history=list(h), dispatch=h.dispatch,\n"
    "               launches=blur.blur2d.launches,\n"
    "               scalar_launches=blur.blur2d.scalar_launches,\n"
    "               collectives=collectives.counts),\n"
    "          open(sys.argv[2], 'w'), default=str)\n")
# phase 12b: the worker's recipes at full width, as a gloo world of 2 on the
# one card (256, 32 and 8 rows a rank), 4 steps (2 at 512x512, whose float32
# steps with TF32 off take seconds); the 512x512 run's step 2 has R1
WORLD_RECIPES = (
    ("sndcgan", ["--arch", "sndcgan", "--size", "32", "--batch", "512",
                 "--aug", "simclr", "--data_rows", "1024"]),
    ("stylegan2_32", ["--trainer", "sg2", "--arch", "stylegan2", "--size",
                      "32", "--batch", str(BATCH), "--aug", "simclr",
                      "--lbd_r1", "0.1", "--d_reg_every", "1",
                      "--data_rows", "256"]),
    ("stylegan2_512", ["--trainer", "sg2", "--arch", "stylegan2_512",
                       "--size", "512", "--batch", str(BATCH_512), "--aug",
                       "simclr_hq", "--lbd_r1", "0.5", "--d_reg_every", "2",
                       "--data_rows", "64", "--steps", "2"]))
WORLD_B_STEPS = 4  # unless the recipe says otherwise


def spawn(cmd, world: int, backend: str = "", timeout: float = 300):
    """``cmd`` as the ``world`` processes of a world on this machine."""
    from contrad_tpu_torch.hostenv import (
        free_port, rank_env, spawn_world, worker_env)

    port = free_port()
    env = worker_env(str(ROOT))
    return spawn_world([(cmd(r), rank_env(env, port, r, world, backend))
                        for r in range(world)], cwd=str(ROOT),
                       timeout=timeout)


def world_of_one(name, cli, main, recipe, data, batch):
    """Phase 12a for one recipe: the CLI as graph blocks of GRAPH_K steps
    without a world (in this process) and as an NCCL world of one
    (``--multihost``, a process of its own through ``spawn_world``), cuDNN
    deterministic in both; every tensor of the step-8 checkpoints and every
    logged metric must be bitwise equal. Returns the numbers."""
    import torch

    from contrad_tpu_torch.utils.checkpoint import restore_checkpoint

    flags = ["--steps_per_dispatch", str(GRAPH_K), "--evaluate_every",
             str(WORLD_STEPS), "--no_fid", "--no_gif"]
    solo = run_cli(main, recipe + flags, data, WORLD_STEPS, batch, GRAPH_K)
    argv, _ = cli_argv(recipe + flags, data, WORLD_STEPS, batch, GRAPH_K)
    dump = os.path.join(LOG_ROOT, f"world1_{name}.json")
    spawn(lambda r: [sys.executable, "-c", WORLD_CLI, cli, dump] + argv
          + ["--multihost"], 1)
    world = json.loads(Path(dump).read_text())
    want = flat_tensors(restore_checkpoint(solo["logdir"]))
    got = flat_tensors(restore_checkpoint(world["logdir"]))
    if want.keys() != got.keys():
        raise AssertionError(f"{name}: the world's checkpoint holds other "
                             f"tensors")
    differ = [k for k, v in want.items() if not torch.equal(v, got[k])]
    metrics = [{k: v for k, v in r.items() if k != "seconds_per_step"}
               for r in solo["history"]]
    world_metrics = [{k: v for k, v in r.items() if k != "seconds_per_step"}
                     for r in world["history"]]
    if differ or metrics != world_metrics:
        raise AssertionError(f"{name}: the NCCL world of one differs from the "
                             f"world-less run in {len(differ)} of {len(want)} "
                             f"tensors ({differ[:4]}) or its metrics")
    stats = world["dispatch"]["stats"]
    if (world["dispatch"]["k"] != GRAPH_K or solo["dispatch"]["k"] != GRAPH_K
            or world["launches"] != solo["launches"]
            or world["scalar_launches"]):
        raise AssertionError(f"{name}: K {world['dispatch']['k']}, blur "
                             f"launches {world['launches']} against "
                             f"{solo['launches']}")
    coll = stats["captured_collectives"]
    if not coll or any(c["calls"] == 0 for c in coll.values()):
        raise AssertionError(f"{name}: no collective was captured: {coll}")
    ms_solo = 1e3 * solo["history"][-1]["seconds_per_step"]
    ms_world = 1e3 * world["history"][-1]["seconds_per_step"]
    log(f"  {name}: {len(want)} checkpoint tensors and the metrics bitwise "
        f"equal; collectives captured a step "
        + ", ".join(f"{k}: {c['calls']} calls, {c['bytes'] / 2**20:.2f} MiB"
                    for k, c in coll.items())
        + f"; graph step {ms_world:.2f} ms in the world against "
          f"{ms_solo:.2f} ms without ({ms_world / ms_solo:.3f}); blur "
          f"launches {world['launches']} in both")
    return dict(tensors=len(want), collectives_per_step=coll,
                ms_world=ms_world, ms_solo=ms_solo,
                launches=world["launches"],
                capture_seconds=stats["capture_seconds"])


def _within(got, want, what: str) -> float:
    """max |got - want| within 1e-4 + 1e-4 * max |want| (phase 7's rule);
    returns it over the scale."""
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    if err > MODEL_TOL[0] + MODEL_TOL[1] * scale:
        raise AssertionError(f"{what}: {err:.3g} from world 1 (scale "
                             f"{scale:.3g})")
    return err / max(scale, 1e-30)


BRANCH_TOL = 2e-4  # 12b: the pre-activations whose branch world 1 hands on


class BranchCarry(LeakyBranches):
    """Phase 7's rule for leaky-ReLU kinks, across processes (phase 12b).
    Under ``record()`` (world 1, step 1) each ``F.leaky_relu`` call keeps
    its pre-activations within BRANCH_TOL of 0: their global flat indices,
    values and branches (``x > 0``). Under ``impose()`` (a rank of the
    world, step 1) each call takes world 1's branch at this rank's rows of
    those elements (each part of a call's global rows sliced as
    ``local_rows`` slices a draw) and keeps its own elsewhere; ``flipped``
    counts every element whose own branch differs, with its pre-activation
    in both runs."""

    def __init__(self, calls=None, batch: int = 0):
        super().__init__()
        self.calls = [] if calls is None else calls
        self.batch = batch  # the global batch the rows are parts of
        self.flipped = {"elements": 0, "rank_max": 0.0, "world1_max": 0.0}
        self._local = None

    def _record(self, plain, x, slope):
        flat = x.detach().flatten()
        idx = (flat.abs() <= BRANCH_TOL).nonzero().squeeze(1)
        self.calls.append(dict(rows=x.shape[0], inner=flat.numel()
                               // x.shape[0], idx=idx.cpu(),
                               x=flat[idx].float().cpu(),
                               branch=(flat[idx] > 0).cpu()))
        return plain(x, slope)

    def _localise(self, device):
        """Each call's carried elements that are this rank's: local flat
        index, world 1's branch and value."""
        from contrad_tpu_torch.parallel import data_shard

        rank, world = data_shard()
        per = self.batch // world
        self._local = []
        for c in self.calls:
            if c["rows"] % self.batch:
                raise AssertionError(f"a leaky ReLU of {c['rows']} rows is no "
                                     f"whole number of batches of "
                                     f"{self.batch}")
            row, rest = c["idx"] // c["inner"], c["idx"] % c["inner"]
            part, j = row // self.batch, row % self.batch
            mine = j // per == rank
            local = ((part * per + j % per) * c["inner"] + rest)[mine]
            self._local.append(dict(rows=c["rows"] // world,
                                    inner=c["inner"], idx=local.to(device),
                                    branch=c["branch"][mine].to(device),
                                    x=c["x"][mine].to(device)))

    def _impose(self, plain, x, slope):
        import torch

        if self._local is None:
            self._localise(x.device)
        if self._next >= len(self._local):
            raise AssertionError("more leaky ReLUs than world 1 recorded")
        c = self._local[self._next]
        self._next += 1
        if x.shape[0] != c["rows"] or x.numel() != c["rows"] * c["inner"]:
            raise AssertionError(f"leaky ReLU {self._next - 1}: shape "
                                 f"{tuple(x.shape)}, {c['rows']} rows of "
                                 f"{c['inner']} carried")
        mask = (x.detach() > 0).flatten()
        own = mask[c["idx"]]
        flips = own != c["branch"]
        if bool(flips.any()):
            xs = x.detach().flatten()[c["idx"][flips]].float().abs()
            self.flipped["elements"] += int(flips.sum())
            self.flipped["rank_max"] = max(self.flipped["rank_max"],
                                           float(xs.max()))
            self.flipped["world1_max"] = max(
                self.flipped["world1_max"],
                float(c["x"][flips].abs().max()))
        mask[c["idx"]] = c["branch"]
        return torch.where(mask.view(x.shape), x, x * slope)

    def summary(self) -> dict:
        return dict(self.flipped, calls=len(self.calls), imposed=self._next,
                    carried=sum(int(c["idx"].numel()) for c in self.calls))


def world_rank(argv) -> None:
    """A rank of phase 12b (``python -c "import chip_smoke; ..."``): the
    worker (``argv[1:]``) with world 1's branches (the file ``argv[0]``)
    imposed in step 1; the carried branches' summary beside its output."""
    import torch

    from contrad_tpu_torch.parallel import _mh_worker

    args = _mh_worker.parse_args(argv[1:])
    carry = BranchCarry(torch.load(argv[0], weights_only=False), args.batch)
    _mh_worker.main(argv[1:], step_context=lambda step: (
        carry.impose() if step == 1 else contextlib.nullcontext()))
    torch.save(carry.summary(), f"{args.out}.rank{args.rank}.branches.pt")


def world_launches(name: str, steps: int, per_step) -> list:
    """The blur's launches in each step of a phase-12b run, phase 3's
    counts: none on SNDCGAN, R1 in every 32x32 step, and in the 512x512
    run's step 2."""
    if name == "sndcgan":
        return [0] * steps
    if name == "stylegan2_32":
        return [per_step["stylegan2_32"]] * steps
    return [per_step["stylegan2_512_r1"] if s % 2 == 0
            else per_step["stylegan2_512"] for s in range(1, steps + 1)]


def world_of_two(name, flags, per_step, ref_flags=(), rank_flags=(),
                 tag: str = "world2"):
    """Phase 12b for one recipe: the worker's recipe as a gloo world of two
    on the one card, eager, against the same recipe in this process without
    a world (cuDNN deterministic and TF32 off in both): step 1's losses and
    gradients and the parameters after its last step within 1e-4 +
    1e-4 * max, step 1 taking world 1's leaky-ReLU branch at every
    pre-activation within BRANCH_TOL of 0 (``BranchCarry``; a differing
    branch must lie within it of 0 in both runs), every tensor bitwise
    equal across the ranks, the blur launching on each rank as a world-1
    step does. ``ref_flags`` and ``rank_flags`` go to world 1 and to the
    ranks only (phase 13c: the sharded loader and world 1's feed of its
    global batches). Returns the numbers, with what each run's data path
    fed (the worker's ``data``)."""
    import torch

    from contrad_tpu_torch.ops import blur
    from contrad_tpu_torch.parallel import _mh_worker

    argv = ["--steps", str(WORLD_B_STEPS)] + flags + ["--device", "cuda"]
    out = os.path.join(LOG_ROOT, f"{tag}_{name}")
    args = _mh_worker.parse_args(argv + list(ref_flags) + ["--out", out])
    steps = args.steps
    blur.blur2d.launches = blur.blur2d.scalar_launches = 0
    carry = BranchCarry()
    ref = _mh_worker.run_recipe(args, torch.device("cuda"), lambda step: (
        carry.record() if step == 1 else contextlib.nullcontext()))
    branches = f"{out}.branches.pt"
    torch.save(carry.calls, branches)
    del carry
    torch.cuda.empty_cache()
    spawn(lambda r: [sys.executable, "-c",
                     "import sys, chip_smoke; chip_smoke.world_rank("
                     "sys.argv[1:])", branches, "--rank", str(r), "--world",
                     "2", "--time_collectives",
                     "--deterministic", "--out", out] + argv
          + list(rank_flags), 2, "gloo")
    ranks = [torch.load(f"{out}.rank{r}.pt", weights_only=False)
             for r in range(2)]
    carried = [torch.load(f"{out}.rank{r}.branches.pt", weights_only=False)
               for r in range(2)]
    for c in carried:
        if c["imposed"] != c["calls"] or c["rank_max"] > BRANCH_TOL:
            raise AssertionError(f"{name}: branches carried {c}")
    a, b = ranks
    if a["metrics"] != b["metrics"] or a["state"].keys() != b["state"].keys():
        raise AssertionError(f"{name}: the ranks' metrics or state differ")
    differ = [k for k, v in a["state"].items()
              if not torch.equal(v, b["state"][k])]
    differ += [f"grads {i}" for i, (x, y) in enumerate(zip(
        a["g_grads"][0] + a["d_grads"][0], b["g_grads"][0] + b["d_grads"][0]))
        if not torch.equal(x, y)]
    if differ:
        raise AssertionError(f"{name}: replicas differ in {differ[:4]}")
    want_steps = world_launches(name, steps, per_step)
    launches = {}
    for who, r in (("world 1", ref), ("rank 0", a), ("rank 1", b)):
        launches[who] = [row["blur_launches"] for row in r["steps"]]
        if launches[who] != want_steps:
            raise AssertionError(f"{name} {who}: blur launches "
                                 f"{launches[who]}, not {want_steps}")
    del launches["world 1"]
    worst = {}
    for k, v in ref["metrics"][0].items():
        worst[f"step 1 {k}"] = _within(torch.tensor(a["metrics"][0][k]),
                                       torch.tensor(v), f"{name} step 1 {k}")
    for which in ("g_grads", "d_grads"):
        for i, (x, y) in enumerate(zip(a[which][0], ref[which][0],
                                       strict=True)):
            worst[f"{which} {i}"] = _within(x, y, f"{name} {which} {i}")
    params = [k for k in ref["state"] if k.split("/")[0] in
              ("generator", "discriminator", "g_ema")]
    for k in params:
        worst[k] = _within(a["state"][k], ref["state"][k], f"{name} {k}")
    top = max(worst, key=worst.get)
    ms = [sum(row["ms"] for row in r["steps"][1:]) / (steps - 1)
          for r in (ref, a, b)]
    coll = [sum(row["collective_seconds"] for row in r["steps"][1:])
            / (steps - 1) * 1e3 for r in (a, b)]
    calls = a["steps"][0]["collective_calls"]
    mib = a["steps"][0]["collective_bytes"] / 2**20
    log(f"  {name}: replicas bitwise ({len(a['state'])} tensors, the "
        f"gradients, the metrics); against world 1: {len(worst)} checks, "
        f"worst relative {worst[top]:.3g} ({top}); blur launches a step "
        f"{launches}; ms/step (steps 2-{steps}) world "
        f"1 {ms[0]:.1f}, rank 0 {ms[1]:.1f}, rank 1 {ms[2]:.1f}, of which "
        f"collectives {coll[0]:.1f} and {coll[1]:.1f} ({calls} calls, "
        f"{mib:.2f} MiB a step)")
    flips = [c["elements"] for c in carried]
    log(f"    leaky ReLU in step 1: {carried[0]['calls']} calls, "
        f"{carried[0]['carried']} pre-activations within "
        f"{BRANCH_TOL:g} of 0 carried from world 1, of which {flips} took "
        f"the other branch on the ranks (at most "
        f"{max(c['rank_max'] for c in carried):.3g} from 0 there, "
        f"{max(c['world1_max'] for c in carried):.3g} in world 1)")
    probe = a.get("gloo_cuda")
    return dict(worst=worst[top], worst_name=top, checks=len(worst),
                branch_flips=flips, branches=carried,
                launches_per_step=launches, ms_world1=ms[0],
                ms_ranks=ms[1:], collective_ms=coll, collective_calls=calls,
                collective_mib=mib, gloo_cuda=probe,
                data=dict(world1=ref["data"], ranks=[a["data"], b["data"]]))


def world_phase(per_step) -> dict:
    """Phase 12: data parallelism over processes (``--multihost``). 12a: an
    NCCL world of one, its collectives captured in the CUDA graphs, bitwise
    against the world-less CLI for each recipe at full width; 12b: a gloo
    world of two on the one card against world 1 eager. Returns its
    numbers."""
    import gc

    import torch

    t12 = time.perf_counter()
    phase(f"[12] the world path: (a) an NCCL world of one, {WORLD_STEPS} "
          f"steps as graph blocks of {GRAPH_K}, against the world-less CLI")
    from contrad_tpu_torch import (
        train_gan, train_stylegan2, train_stylegan2_contraD)

    out = {"a": {}, "b": {}}
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for training
    torch.backends.cudnn.deterministic = True
    for name, cli, main, recipe, data, batch in (
            ("sndcgan", "train_gan", train_gan.main, FLAGSHIP,
             "synthetic_32", None),
            ("stylegan2_32", "train_stylegan2", train_stylegan2.main, RECIPE,
             "synthetic_32", BATCH),
            ("stylegan2_512", "train_stylegan2_contraD",
             train_stylegan2_contraD.main, RECIPE_512, DATA_512, BATCH_512)):
        out["a"][name] = world_of_one(name, cli, main, recipe,
                                      WORLD_DATA[data], batch)
        gc.collect()
        torch.cuda.empty_cache()
    phase("  (b) a gloo world of two on the one card, eager steps, against "
          "world 1 (TF32 off)")
    torch.backends.cudnn.allow_tf32 = False
    for name, flags in WORLD_RECIPES:
        out["b"][name] = world_of_two(name, flags, per_step)
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    probe = out["b"]["sndcgan"]["gloo_cuda"]
    log(f"  gloo on CUDA tensors: {probe}")
    out["seconds"] = time.perf_counter() - t12
    log(f"  phase 12: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------- the data paths

DATA_STEPS = 8  # phase 13a: two graph blocks of GRAPH_K steps
DATA_TURNS = ("host", "resident")  # the spread: phases 7 and 11's eager runs
# phase 13c: the worker's recipes on sets the loader must shard in a world
# of two (--max_bytes between half the set and the set), TF32 off; each
# crosses one epoch boundary, so one ring rotation
SHARD_RECIPES = (
    ("stylegan2_512", ["--trainer", "sg2", "--arch", "stylegan2_512",
                       "--size", "512", "--batch", str(BATCH_512), "--aug",
                       "simclr_hq", "--lbd_r1", "0.5", "--d_reg_every", "2",
                       "--data_rows", "32", "--steps", "3",
                       "--max_bytes", str(20 * 2**20)]),  # of 25.2 MB
    ("stylegan2_32", ["--trainer", "sg2", "--arch", "stylegan2", "--size",
                      "32", "--batch", str(BATCH), "--aug", "simclr",
                      "--lbd_r1", "0.1", "--d_reg_every", "1",
                      "--data_rows", "512", "--steps", "10",
                      "--max_bytes", str(2**20)]))  # of 1.57 MB


def data_cli_runs(name, main, module, recipe, data, batch, launches):
    """Phase 13a for one recipe: DATA_STEPS steps through its CLI host-fed
    and device-resident (DATA_TURNS, ``--steps_per_dispatch 1``),
    then device-resident as graph blocks of GRAPH_K; every tensor of the
    step-8 checkpoints bitwise equal between the loaders, the blur's
    ``launches`` a step (warm-up steps included). Then a profile of 3
    host-fed steps. Returns the numbers."""
    import gc

    import torch

    from contrad_tpu_torch import data as data_module
    from contrad_tpu_torch.data import DeviceBatchIterator
    from contrad_tpu_torch.training.graph import WARMUP_STEPS
    from contrad_tpu_torch.utils.checkpoint import restore_checkpoint

    limit = DeviceBatchIterator.MAX_BYTES
    nbytes = data_module.get_dataset(data)[0].images.nbytes
    flags = ["--evaluate_every", str(DATA_STEPS), "--no_fid", "--no_gif"]
    runs, want, out = {"host": [], "resident": [], "graph": []}, None, {}
    for turn in DATA_TURNS + ("graph",):
        k = GRAPH_K if turn == "graph" else 1
        if turn == "host":
            DeviceBatchIterator.MAX_BYTES = nbytes // 2
        try:
            r = run_cli(main, recipe + flags
                        + ["--steps_per_dispatch", str(k)], data, DATA_STEPS,
                        batch, k)
        finally:
            DeviceBatchIterator.MAX_BYTES = limit
        path = "host-fed" if turn == "host" else "device-resident"
        if r["dispatch"]["k"] != k or r["data"]["path"] != path:
            raise AssertionError(f"{name} {turn}: K {r['dispatch']['k']}, "
                                 f"data path {r['data']['path']}")
        warm = WARMUP_STEPS if turn == "graph" else 0
        expect_launches(r, (DATA_STEPS + warm) * launches,
                        f"the {turn} {name} run")
        if turn != "graph":  # graphs agree with eager steps to a tolerance
            got = flat_tensors(restore_checkpoint(r["logdir"]))
            want = got if want is None else want
            differ = [key for key, v in want.items()
                      if key not in got or not torch.equal(v, got[key])]
            if differ or got.keys() != want.keys():
                raise AssertionError(f"{name}: the {turn} run's checkpoint "
                                     f"differs in {len(differ)} of "
                                     f"{len(want)} tensors ({differ[:4]})")
        stats = r["data"]["stats"]
        if turn == "host":
            n = max(stats["batches"], 1)
            r["gather_ms"] = 1e3 * stats["gather_s"] / n
            r["copy_ms"] = stats["copy_ms"] / max(stats["copies_timed"], 1)
            r["wait_ms"] = 1e3 * stats["wait_s"] / n
        log(f"  {name:13s} {turn:8s} K={k}: {r['ms_per_step']:.2f} ms/step, "
            f"{r['img_per_s']:.1f} img/s, peak "
            f"{r['peak_bytes'] / 2**30:.3f} GiB, blur launches "
            f"{r['launches']}"
            + (f"; a batch: gather {r['gather_ms']:.3f} ms, copy "
               f"{r['copy_ms']:.3f} ms ({stats['copies_timed']} timed), the "
               f"step's wait {r['wait_ms']:.3f} ms" if turn == "host" else "")
            + ("" if turn == "graph" else "; checkpoint bitwise"))
        runs[turn].append({k_: v for k_, v in r.items() if k_ != "history"})
        del r
        gc.collect()
        torch.cuda.empty_cache()
    out["tensors"] = len(want)
    out["runs"] = runs
    h = [r["ms_per_step"] for r in runs["host"]]
    d = [r["ms_per_step"] for r in runs["resident"]]
    g = runs["graph"][0]["ms_per_step"]
    log(f"  {name}: host-fed {min(h):.2f}-{max(h):.2f} ms/step, resident "
        f"{min(d):.2f}-{max(d):.2f}, graph {g:.2f} (host-fed/resident "
        f"{sum(h) / sum(d):.3f}, host-fed/graph {sum(h) / len(h) / g:.3f}); "
        f"{len(want)} checkpoint tensors bitwise between the loaders")
    DeviceBatchIterator.MAX_BYTES = nbytes // 2
    try:
        out["profile"] = profile(module, recipe, data, batch)
    finally:
        DeviceBatchIterator.MAX_BYTES = limit
    expect_launches(out["profile"], launches, f"a profiled host-fed {name} "
                                              f"step")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def gather_rates(reps: int = 20) -> dict:
    """Phase 13b: the native gather against ``np.take`` (bitwise) at 16 and
    64 rows of 512x512 and 512 rows of 32x32, MB/s of each (the median of
    ``reps``) and of the pinned host-to-card copy of the batch."""
    import numpy as np
    import torch

    from contrad_tpu_torch import data as data_module
    from contrad_tpu_torch.data import native

    rng = np.random.default_rng(0)
    out = {}
    for data, rows in ((DATA_512, 16), (DATA_512, 64), ("synthetic_32", 512)):
        src = data_module.get_dataset(data)[0].images
        idx = rng.choice(len(src), size=rows, replace=False)
        want = np.take(src, idx, axis=0)
        got = native.gather_native(src, idx, np.empty_like(want))
        if not np.array_equal(got, want):
            raise AssertionError(f"native gather of {rows} rows of {data} "
                                 f"differs from np.take")
        times = {"take": [], "native": []}
        buf = np.empty_like(want)
        for _ in range(reps):
            for how in ("take", "native"):
                t0 = time.perf_counter()
                if how == "take":
                    np.take(src, idx, axis=0, out=buf)
                else:
                    native.gather_native(src, idx, buf)
                times[how].append(time.perf_counter() - t0)
        pinned = torch.from_numpy(want).pin_memory()
        ms = cuda_ms(lambda x: x.to("cuda", non_blocking=True), [pinned],
                     iters=reps)
        mb = want.nbytes / 1e6
        row = {how: mb / float(np.median(t)) for how, t in times.items()}
        row.update(mb=mb, copy=mb / (ms * 1e-3), copy_ms=ms,
                   take_ms=1e3 * float(np.median(times["take"])),
                   native_ms=1e3 * float(np.median(times["native"])),
                   rule="native" if want.nbytes >= native.NATIVE_MIN_BYTES
                   else "np.take")
        out[f"{data} x{rows}"] = row
        log(f"  {rows} rows of {data} ({mb:.2f} MB): np.take "
            f"{row['take']:.0f} MB/s ({row['take_ms']:.3f} ms), native "
            f"{row['native']:.0f} MB/s ({row['native_ms']:.3f} ms), pinned "
            f"copy to the card {row['copy']:.0f} MB/s ({ms:.3f} ms); "
            f"gather_batch takes {row['rule']}; bitwise")
    return out


def sharded_world(name, flags, per_step) -> dict:
    """Phase 13c for one recipe: the worker's recipe as a gloo world of two
    whose loader shards the set (``--max_bytes``), held to world 1 fed the
    same global batches (``--feed_world 2``) as phase 12b holds a world
    (``world_of_two``); every batch bitwise the rows the stream names, each
    rank's shard its chunk before and its neighbour's after the rotation,
    in one storage. Returns the numbers."""
    shard_flags = flags[flags.index("--max_bytes"):]
    common = flags[:flags.index("--max_bytes")]
    r = world_of_two(name, common, per_step, ref_flags=["--feed_world", "2"],
                     rank_flags=shard_flags, tag="sharded")
    ref, ranks = r["data"]["world1"], r["data"]["ranks"]
    steps = len(ref["rows"])
    for rank, d in enumerate(ranks):
        chunks = [s["chunk"] for s in d["shards"]]
        if (d["path"] != "sharded" or not all(d["gathered_equal"])
                or len(d["gathered_equal"]) != steps
                or chunks != [rank, (rank - 1) % 2]
                or not all(s["equal"] for s in d["shards"])
                or len({s["storage"] for s in d["shards"]}) != 1):
            raise AssertionError(f"{name} rank {rank}: data path {d['path']}, "
                                 f"batches bitwise {d['gathered_equal']}, "
                                 f"shards {d['shards']}")
    if ref["path"] != "ShardedFeed" or not all(ref["gathered_equal"]) or any(
            ref["rows"][s] != ranks[0]["rows"][s] + ranks[1]["rows"][s]
            for s in range(steps)):
        raise AssertionError(f"{name}: world 1 was not fed the world's "
                             f"global batches")
    log(f"    sharded: {steps} steps, each rank's batches bitwise the rows "
        f"its stream names; shard storage unmoved; after the rotation "
        f"(step {ranks[0]['shards'][1]['step']}) each rank holds its "
        f"neighbour's chunk")
    return r


def data_phase(per_step) -> dict:
    """Phase 13: the data paths (see the module docstring). Returns its
    numbers."""
    import gc

    import torch

    t13 = time.perf_counter()
    phase(f"[13] the data paths: (a) host-fed against device-resident, "
          f"{DATA_STEPS} steps through the CLIs, cuDNN deterministic")
    from contrad_tpu_torch import (
        train_gan, train_stylegan2, train_stylegan2_contraD)

    out = {"a": {}, "c": {}}
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for training
    torch.backends.cudnn.deterministic = True
    out["a"]["stylegan2_512"] = data_cli_runs(
        "stylegan2_512", train_stylegan2_contraD.main, train_stylegan2,
        RECIPE_512, DATA_512, BATCH_512, per_step["stylegan2_512"])
    out["a"]["sndcgan"] = data_cli_runs(
        "sndcgan", train_gan.main, train_gan, FLAGSHIP, "synthetic_32", None,
        0)
    phase("  (b) the native gather against np.take, and the pinned copy")
    out["b"] = gather_rates()
    phase("  (c) the sharded path: a gloo world of two on the one card "
          "against world 1 fed its global batches (TF32 off)")
    torch.backends.cudnn.allow_tf32 = False
    for name, flags in SHARD_RECIPES:
        out["c"][name] = sharded_world(name, flags, per_step)
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    out["seconds"] = time.perf_counter() - t13
    log(f"  phase 13: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------- fused activation

# the 512x512 recipe's largest activated tensors (D's 512x512 level at the D
# phase's 48 images and G's at 16, D's 256x256 level at 48), each in both
# memory layouts (channel planes: NCHW memory), and the style MLP's rows
ACT_SHAPES = [(48, 512, 512, 32), (16, 512, 512, 32), (48, 256, 256, 64),
              (16, 512)]
ACT_GAIN = math.sqrt(2.0)
ACT_SLOPE = 0.2


def plain_act_grad(dy, t):
    """The kernels autograd runs for the plain op's backward: the gain's
    product, the leaky ReLU's backward on the saved ``x + b``, the bias
    sum."""
    import torch

    dx = torch.ops.aten.leaky_relu_backward(dy * ACT_GAIN, t, ACT_SLOPE,
                                            False)
    return dx, dx.reshape(-1, dx.shape[-1]).sum(0)


def time_fused_act(fused_act) -> list:
    """Per shape and memory layout (float32): the kernel's modes act and
    grad (with the bias gradient; 4-D shapes also with dy in the other
    layout, the transposing path) checked against the plain op (out and dx
    bitwise, db within 1e-5 * sum|dx| of the float64 sum), then timed as
    CUDA-graph replays beside the plain op's three kernels each way and the
    byte bound at 3.35 TB/s (act: x in, out out; grad: dy and out in, dx
    out)."""
    import torch

    rows = []
    for shape, planes in [(s, p) for s in ACT_SHAPES
                          for p in ((False, True) if len(s) > 2 else (False,))]:
        gen = torch.Generator(device="cuda").manual_seed(17)
        x = torch.randn(shape, generator=gen, device="cuda")
        b = torch.randn(shape[-1], generator=gen, device="cuda")
        dy = torch.randn(shape, generator=gen, device="cuda")
        if planes:  # NCHW memory
            x, dy = (a.movedim(-1, 1).contiguous().movedim(1, -1)
                     for a in (x, dy))
        t = x + b
        out = fused_act.fused_leaky_relu(x, b)
        if not torch.equal(out, fused_act.fused_leaky_relu_plain(x, b)):
            raise AssertionError(f"fused activation {shape}: out differs")
        pdx, _ = plain_act_grad(dy, t)
        exact = pdx.double().reshape(-1, shape[-1])
        other = (dy.movedim(-1, 1).contiguous().movedim(1, -1) if not planes
                 else dy.contiguous()) if len(shape) > 2 else None
        db_err = 0.0
        for g in (dy, other):
            if g is None:
                continue
            dx, db = fused_act._grad(g, None, out, ACT_SLOPE, ACT_GAIN, True)
            if not torch.equal(dx, pdx):
                raise AssertionError(f"fused activation {shape}: dx differs")
            db_err = max(db_err, float(((db.double() - exact.sum(0)).abs()
                                        / exact.abs().sum(0)).max()))
            del dx
        if db_err > 1e-5:
            raise AssertionError(f"fused activation {shape}: db off by "
                                 f"{db_err:.2e} of sum|dx|")
        nbytes = x.numel() * x.element_size()
        iters = 20 if nbytes > 1e8 else 200
        ms = dict(
            act=cuda_ms(lambda a: fused_act._act(a, b, ACT_SLOPE, ACT_GAIN),
                        [x], iters, graph=True),
            grad=cuda_ms(lambda g: fused_act._grad(g, None, out, ACT_SLOPE,
                                                   ACT_GAIN, True),
                         [dy], iters, graph=True),
            plain_act=cuda_ms(lambda a: fused_act.fused_leaky_relu_plain(
                a, b), [x], iters, graph=True),
            plain_grad=cuda_ms(lambda g: plain_act_grad(g, t), [dy], iters,
                               graph=True))
        if other is not None:
            ms.update(
                grad_other=cuda_ms(lambda g: fused_act._grad(
                    g, None, out, ACT_SLOPE, ACT_GAIN, True), [other], iters,
                    graph=True),
                plain_grad_other=cuda_ms(lambda g: plain_act_grad(g, t),
                                         [other], iters, graph=True))
        bound = dict(act=2e3 * nbytes / HBM_BYTES_PER_S,
                     grad=3e3 * nbytes / HBM_BYTES_PER_S)
        if other is not None:
            bound["grad_other"] = bound["grad"]
        row = dict(shape=list(shape), planes=planes, mb=nbytes / 1e6,
                   db_rel_err=db_err,
                   **{f"{k}_ms": v for k, v in ms.items()},
                   **{f"{k}_bound_ms": v for k, v in bound.items()},
                   **{f"{k}_pct_of_bound": 100 * bound[k] / ms[k]
                      for k in bound})
        rows.append(row)
        log(f"  {tuple(shape)} {'planes' if planes else 'rows'} "
            f"({row['mb']:.1f} MB): act "
            f"{ms['act']:.4f} ms ({row['act_pct_of_bound']:.1f} % of "
            f"{bound['act']:.4f}; plain {ms['plain_act']:.4f}), grad "
            f"{ms['grad']:.4f} ms ({row['grad_pct_of_bound']:.1f} % of "
            f"{bound['grad']:.4f}; plain {ms['plain_grad']:.4f})"
            + (f", grad with dy in the other layout {ms['grad_other']:.4f} "
               f"ms ({row['grad_other_pct_of_bound']:.1f} %; plain "
               f"{ms['plain_grad_other']:.4f})" if other is not None else "")
            + f"; db {db_err:.2e} of sum|dx|")
        del x, dy, t, out, pdx, exact, other
        torch.cuda.empty_cache()
    return rows


def act_launches_per_step(fused_act) -> dict:
    """The fused activation's launches (and the blur's) in one eager step
    of each kind of the 512x512 recipe at batch 16 and the 32x32 recipe at
    batch 64, through the CLI's ``build`` on small synthetic sets, with the
    bytes each memory layout and mode moves; none may take the scalar
    path."""
    import torch

    from contrad_tpu_torch import train_stylegan2
    from contrad_tpu_torch.ops import blur

    counter = fused_act.fused_leaky_relu
    out = {}
    seen = []
    launch = fused_act._launch

    def recording(mode, x, b, ref, *args):
        seen.append((mode, fused_act._layout(x)[2] > 1,
                     ref is not None and fused_act._layout(ref)
                     != fused_act._layout(x), x.numel() * x.element_size()))
        return launch(mode, x, b, ref, *args)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for training
    for name, recipe, dataset, batch in (
            ("stylegan2_512", RECIPE_512, "synthetic_512_64", BATCH_512),
            ("stylegan2_32", RECIPE, "synthetic_32_256", BATCH)):
        P = train_stylegan2.parse_args(recipe + [
            "--override", f"options.dataset={dataset}",
            f"options.batch_size={batch}"])
        _, loader, trainer = train_stylegan2.build(P)
        idx = loader.next_indices()[0]
        for kind, flag in (("plain", False), ("r1", True)):
            before = (counter.launches, counter.scalar_launches,
                      blur.blur2d.launches)
            seen.clear()
            fused_act._launch = recording
            try:
                trainer.train_step(loader.materialize(idx), do_r1=flag)
            finally:
                fused_act._launch = launch
            torch.cuda.synchronize()
            mb = {}
            for mode, planes, other, nbytes in seen:
                key = (f"{'grad' if mode else 'act'} "
                       f"{'planes' if planes else 'rows'}"
                       f"{' to the other layout' if other else ''}")
                mb[key] = mb.get(key, 0.0) + nbytes / 1e6
            got = dict(launches=counter.launches - before[0],
                       scalar=counter.scalar_launches - before[1],
                       blur=blur.blur2d.launches - before[2],
                       calls=len(seen), input_mb_by_mode_and_layout=mb)
            if got["scalar"]:
                raise AssertionError(f"{name} {kind}: {got['scalar']} fused "
                                     f"activation launches took the scalar "
                                     f"path")
            out[f"{name} {kind}"] = got
            log(f"  {name} {kind} step: {got['launches']} fused activation "
                f"launches ({got['calls']} calls), {got['blur']} blur "
                f"launches; MB in by mode and layout: "
                + ", ".join(f"{k} {v:.0f}" for k, v in sorted(mb.items())))
        del loader, trainer
        torch.cuda.empty_cache()
    return out


def fused_act_phase(fused_act) -> dict:
    """Phase 17: the fused activation kernel's check and times at the main
    path's largest shapes, and its launches a step."""
    t0 = time.perf_counter()
    phase("[17] the fused bias + leaky ReLU + gain kernel: checks and times "
          "at the 512x512 recipe's shapes, launches a step")
    rows = time_fused_act(fused_act)
    launches = act_launches_per_step(fused_act)
    log(f"  phase 17: {time.perf_counter() - t0:.1f} s")
    big = max(rows, key=lambda r: (r["mb"], r["planes"]))
    return dict(rows=rows, launches_per_step=launches, kernel={
        "name": "fused_leaky_relu", "route": "cuda",
        "source": "contrad_tpu_torch/csrc/fused_act.cu",
        "replaces": None, "shape": big["shape"], "planes": big["planes"],
        "ms": {"act": big["act_ms"], "grad": big["grad_ms"]},
        "bound_ms": {"act": big["act_bound_ms"],
                     "grad": big["grad_bound_ms"]},
        "bound_by": "bytes",
        "plain_ms": {"act": big["plain_act_ms"],
                     "grad": big["plain_grad_ms"]},
        "launches_per_step": {k: v["launches"]
                              for k, v in launches.items()}})

# ------------------------------------------------------------------ main

# ------------------------------------------------------- the packed layout

# Phase 14: the peaks a row's bound divides its FLOPs by (float32 convs run
# on TF32 tensor cores in the train steps; dense rates of the card's data
# sheet at 700 W), the share of the 512x512 plain graph step that the
# packed path must save to be ported, and the timing's best-of trials.
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
VERDICT_SHARE = 0.02
PACKED_TRIALS, PACKED_ITERS = 3, 10


def nhwc_conv(x, w, stride: int = 1, padding: int = 0):
    import torch.nn.functional as F

    return F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride,
                    padding=padding).permute(0, 2, 3, 1)


def conv_ops(n, ho, co, ci, k) -> float:
    """FLOPs (2 x multiply-adds) of a conv producing (n, ho, ho, co) from
    ``ci`` channels with a k x k kernel."""
    return 2.0 * n * ho * ho * co * ci * k * k


def packed_rows():
    """Phase 14's rows, each one layer of the 512x512 recipe's shallow
    levels at one batch: as the port runs it (variant ``port``), its packed
    equivalent from ``ops/packed.py`` (``packed``) and, for the blurred
    downsampling convs, JAX's blur-folded unpacked conv (``folded``); then
    the packed path's boundary copies and the folded stem of
    ``tools/fold_micro.py``. ``counts``: the times a 512x512 plain step
    runs the row, by pass (D at 3N = 48 rows in the D phase, forward, input
    and weight gradient, the stem taking no input gradient there; D at N =
    16 in the G phase, forward and input gradient; G at N, all three;
    none for the informational stem row). A variant computes
    ``fn(*inputs, w)`` on NHWC inputs packed by ``f_in`` (one factor an
    input) and an OIHW weight, its output packed by ``f_out``; ``ops`` is a
    forward's FLOPs (each gradient takes its conv's FLOPs again)."""
    from contrad_tpu_torch.ops import packed as pk
    from contrad_tpu_torch.ops.upfirdn2d import (
        blur2d, compose_blur_kernel, make_kernel, upsample2d)

    blur = make_kernel([1, 3, 3, 1])
    n3, n1 = 3 * BATCH_512, BATCH_512
    rows = []

    def row(name, n, counts, shapes, w_shape, variants):
        for v in variants.values():
            v.setdefault("f_in", [1] * len(shapes))
            v.setdefault("f_out", 1)
            v.setdefault("blur", False)
        rows.append(dict(name=name, n=n, counts=counts, shapes=shapes,
                         w_shape=w_shape, variants=variants))

    def plain(stride, pad, k, co, ci, h):
        return dict(fn=lambda x, w: nhwc_conv(x, w, stride, pad),
                    ops=conv_ops(1, h // stride, co, ci, k))

    def packed(pad, k, co, ci, h):
        kk = pk._axis_geometry(k, 2, 2, 1, pad)[1]
        return dict(fn=lambda xp, w: pk.packed_conv(xp, w, 2, 2, 1,
                                                    (pad, pad)),
                    f_in=[2], f_out=2, ops=conv_ops(1, h // 2, 4 * co,
                                                    4 * ci, kk))

    def blurred(k, co, ci, h, bpad):
        """The port's downsampling ConvLayer: the blur kernel, then the
        stride-2 conv."""
        hb = h + sum(bpad) - 3
        return dict(fn=lambda x, w: nhwc_conv(blur2d(x, blur, bpad), w, 2),
                    blur=True, ops=conv_ops(1, h // 2, co, ci, k)
                    + 16.0 * hb * hb * ci)

    def folded(pad, k, co, ci, h):
        return dict(fn=lambda x, w: nhwc_conv(
            x, compose_blur_kernel(blur, w), 2, pad),
            ops=conv_ops(1, h // 2, co, ci, k + 3))

    def packed_folded(pad, k, co, ci, h):
        kk = pk._axis_geometry(k + 3, 2, 2, 2, pad)[1]
        return dict(fn=lambda xp, w: pk.packed_conv(
            xp, compose_blur_kernel(blur, w), 2, 2, 2, (pad, pad)),
            f_in=[2], f_out=2, ops=conv_ops(1, h // 4, 4 * co, 4 * ci, kk))

    for n in (n3, n1):
        c = {"fwd": 1, "dx": 1, "dw": 1} if n == n3 else {"fwd": 1, "dx": 1}
        row(f"D block_512.conv1 3x3 32->32 @512", n, c, [(n, 512, 512, 32)],
            (32, 32, 3, 3), {"port": plain(1, 1, 3, 32, 32, 512),
                             "packed": packed(1, 3, 32, 32, 512)})
        row(f"D block_512.conv2 blur+3x3/2 32->64", n, c,
            [(n, 512, 512, 32)], (64, 32, 3, 3),
            {"port": blurred(3, 64, 32, 512, (2, 2)),
             "folded": folded(2, 3, 64, 32, 512),
             "packed": packed_folded(2, 3, 64, 32, 512)})
        row(f"D block_512.skip blur+1x1/2 32->64", n, c,
            [(n, 512, 512, 32)], (64, 32, 1, 1),
            {"port": blurred(1, 64, 32, 512, (1, 1)),
             "folded": folded(1, 1, 64, 32, 512),
             "packed": packed_folded(1, 1, 64, 32, 512)})
        row(f"D block_256.conv1 3x3 64->64 @256", n, c, [(n, 256, 256, 64)],
            (64, 64, 3, 3), {"port": plain(1, 1, 3, 64, 64, 256),
                             "packed": packed(1, 3, 64, 64, 256)})
        row(f"D from_rgb 1x1 3->32 @512", n, dict(c, dx=0) if n == n3 else c,
            [(n, 512, 512, 3)], (32, 3, 1, 1),
            {"port": plain(1, 0, 1, 32, 3, 512),
             "packed": packed(0, 1, 32, 3, 512)})
    g = {"fwd": 1, "dx": 1, "dw": 1}
    row("G top conv 3x3 32->32 @512", n1, g, [(n1, 512, 512, 32)],
        (32, 32, 3, 3), {"port": plain(1, 1, 3, 32, 32, 512),
                         "packed": packed(1, 3, 32, 32, 512)})

    def g_up(x, w):
        """The port's upsampling ModulatedConv: the transposed conv of the
        flipped kernel, then the blur kernel (x4 taps, pads (1, 1))."""
        import torch.nn.functional as F

        y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                               w.transpose(0, 1).flip(2, 3), stride=2)
        return blur2d(y.permute(0, 2, 3, 1), blur, (1, 1), upsample_factor=2)

    row("G upsampling conv 3x3 64->32 into 512", n1, g, [(n1, 256, 256, 64)],
        (32, 64, 3, 3),
        {"port": dict(fn=g_up, blur=True, ops=conv_ops(1, 256, 64, 32, 3)
                      + 16.0 * 512 * 512 * 32),
         "packed": dict(fn=lambda x, w: pk.packed_conv(
             x, compose_blur_kernel(blur * 4, w), 1, 2, 1, (3, 3),
             lhs_dilation=2), f_out=2, ops=conv_ops(1, 256, 128, 64, 3))})
    row("G ToRGB 1x1 32->3 + skip upsample @512", n1, g,
        [(n1, 512, 512, 32), (n1, 256, 256, 3)], (3, 32, 1, 1),
        {"port": dict(fn=lambda x, skip, w: nhwc_conv(x, w)
                      + upsample2d(skip, blur),
                      ops=conv_ops(1, 512, 3, 32, 1) + 16.0 * 512 * 512 * 3),
         "packed": dict(fn=lambda xp, skip, w: pk.packed_conv(
             xp, w, 2, 2, 1, (0, 0)) + pk.upsample2d_packed(skip, blur),
             f_in=[2, 1], f_out=2,
             ops=conv_ops(1, 256, 12, 128, 1)
             + 2.0 * 512 * 256 * 256 * 3 + 2.0 * 512 * 512 * 256 * 3)})
    # the packed path's boundary copies (tools/fold_micro.py): D's 3N
    # images and the G phase's N fakes packed for D, G's packed image
    # unpacked (the copies' gradients are the inverse copies)
    for name, n, counts, shape, fn in (
            ("copy space_to_depth of D's images", n3, {"fwd": 1},
             (n3, 512, 512, 3), lambda x, w: pk.space_to_depth(x, 2)),
            ("copy space_to_depth of the G phase's fakes", n1,
             {"fwd": 1, "dx": 1}, (n1, 512, 512, 3),
             lambda x, w: pk.space_to_depth(x, 2)),
            ("copy depth_to_space of G's image", n1, {"fwd": 1, "dx": 1},
             (n1, 256, 256, 12), lambda x, w: pk.depth_to_space(x, 2))):
        row(name, n, counts, [shape], None, {"packed": dict(fn=fn, ops=0.0)})
    # the stem as JAX runs it (space_to_depth, then the packed 1x1) against
    # the folded 2x2 stride-2 conv that reads the image in place
    row("D stem: space_to_depth + packed 1x1, or folded 2x2/2", n3, {},
        [(n3, 512, 512, 3)], (32, 3, 1, 1),
        {"packed": dict(fn=lambda x, w: pk.packed_conv(
            pk.space_to_depth(x, 2), w, 2, 2, 1, (0, 0)), f_out=2,
            ops=conv_ops(1, 256, 128, 12, 1)),
         "folded": dict(fn=lambda x, w: pk.packed_conv(x, w, 1, 2, 1, (0, 0)),
                        f_out=2, ops=conv_ops(1, 256, 128, 3, 2))})
    return rows


def _row_tensors(r, dtype, seed: int = 0):
    """Inputs (port layout), weight and output gradient of a row: inputs
    N(0, 1) (images U(0, 1)), the weight N(0, 1/fan_in), on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs = [(torch.rand if s[-1] == 3 else torch.randn)(
        s, generator=gen, device="cuda").to(dtype) for s in r["shapes"]]
    w = None
    if r["w_shape"] is not None:
        w = (torch.randn(r["w_shape"], generator=gen, device="cuda")
             / math.sqrt(math.prod(r["w_shape"][1:]))).to(dtype)
    return xs, w, gen


def _variant_inputs(v, xs):
    from contrad_tpu_torch.ops.packed import space_to_depth

    return [space_to_depth(x, f).contiguous() for x, f in zip(xs, v["f_in"])]


def _fwd_and_grads(v, xs, w, gy):
    """Output, input gradients and weight gradient of a variant through
    autograd, back in the port's layout."""
    import torch

    from contrad_tpu_torch.ops.packed import depth_to_space, space_to_depth

    xr = [x.detach().requires_grad_(True) for x in _variant_inputs(v, xs)]
    wr = w.detach().requires_grad_(True)
    y = v["fn"](*xr, wr)
    grads = torch.autograd.grad(y, xr + [wr],
                                space_to_depth(gy, v["f_out"]).contiguous())
    return ([depth_to_space(y.detach(), v["f_out"])]
            + [depth_to_space(g, f) for g, f in zip(grads[:-1], v["f_in"])]
            + [grads[-1]])


@contextlib.contextmanager
def plain_blur():
    """The models' blur through its plain version on every device, so that
    a float64 check can run the port's blurred layers on the card (the
    kernel takes float32 and bfloat16; phase 3 holds it to this version)."""
    import types

    from contrad_tpu_torch.ops import blur, upfirdn2d

    upfirdn2d._blur = types.SimpleNamespace(blur2d=blur.blur2d_plain)
    try:
        yield
    finally:
        upfirdn2d._blur = blur


def check_packed_rows(rows) -> dict:
    """Each row's variants against its first (the port's, or JAX's stem)
    on the card, each tensor within ``MODEL_TOL`` of the reference's
    largest element: in float32 with TF32 off the output and the input
    gradients (the blur kernel launching once forward and once in the
    adjoint in each blurred variant); in float64, with the blur's plain
    version, those and the weight gradient, a sum over up to 12.6 M
    pixels whose float32 rounding the order of the sum sets (1.2e-4 of its
    largest element between the two layouts at 48 rows)."""
    import torch

    from contrad_tpu_torch.ops.blur import blur2d as blur_op
    from contrad_tpu_torch.ops.packed import depth_to_space

    out = {}
    for dtype in (torch.float32, torch.float64):
        for r in rows:
            labels = list(r["variants"])
            if r["w_shape"] is None or len(labels) < 2:
                continue
            xs, w, gen = _row_tensors(r, dtype)
            ref_v = r["variants"][labels[0]]
            with torch.no_grad(), (plain_blur() if dtype == torch.float64
                                   else contextlib.nullcontext()):
                y = depth_to_space(ref_v["fn"](*_variant_inputs(ref_v, xs),
                                               w), ref_v["f_out"])
            gy = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
            del y
            key = f"{r['name']}, n={r['n']}"
            results, checks = {}, out.setdefault(key, {})
            for label in labels:
                before = blur_op.launches
                with (plain_blur() if dtype == torch.float64
                      else contextlib.nullcontext()):
                    results[label] = _fwd_and_grads(r["variants"][label],
                                                     xs, w, gy)
                launches = blur_op.launches - before
                if dtype == torch.float32:
                    checks[label] = {"blur_launches": launches}
                    if r["variants"][label]["blur"] and launches != 2:
                        raise AssertionError(
                            f"{key} {label}: {launches} blur launches, not "
                            f"1 forward + 1 adjoint")
            what = ["output"] + [f"input {i} grad" for i in range(len(xs))]
            if dtype == torch.float64:
                what.append("weight grad")
            for label in labels[1:]:
                for name, a, b in zip(what, results[label],
                                      results[labels[0]]):
                    if a.shape != b.shape or not bool(torch.isfinite(a).all()):
                        raise AssertionError(f"{key} {label} {name}: shape "
                                             f"{tuple(a.shape)} or values")
                    err = float((a - b).abs().max())
                    limit = MODEL_TOL[0] + MODEL_TOL[1] * float(b.abs().max())
                    checks[label][f"{name} {str(dtype)[6:]}"] = err / limit
                    if not err <= limit:
                        raise AssertionError(
                            f"{key}: {label} against {labels[0]}, {name} "
                            f"({dtype}): max|diff| {err:.3e} > {limit:.3e}")
            worst = max(v for lab in labels[1:] for k, v in
                        checks[lab].items() if k.endswith(str(dtype)[6:]))
            log(f"  check {str(dtype)[6:]} {key:48s} {'/'.join(labels)}: "
                f"worst {worst:.3f} of the tolerance")
            del xs, w, gy, results
            torch.cuda.empty_cache()
    return out


def time_packed_row(r, dtype) -> dict:
    """ms of each variant's forward, input gradient and weight gradient
    (those the row's counts run, the forward always), best of
    ``PACKED_TRIALS``: the forward, the forward with ``autograd.grad`` of
    the inputs and with that of the weight, each as CUDA-graph replays of
    ``PACKED_ITERS`` calls (``cuda_ms``); a gradient's time is the
    difference. With the bytes each pass must move (inputs read and
    outputs written once), its FLOPs and its bound."""
    import torch

    xs, w, gen = _row_tensors(r, dtype)
    size = torch.finfo(dtype).bits // 8
    passes = ["fwd"] + [p for p in ("dx", "dw") if r["counts"].get(p)]
    if not r["counts"]:
        passes = ["fwd", "dx"]  # fold_micro's forward and forward+backward
    out = {}
    for label, v in r["variants"].items():
        vin = _variant_inputs(v, xs)
        with torch.no_grad():
            y = v["fn"](*vin, w)
        gy = torch.randn(y.shape, generator=gen, device="cuda", dtype=dtype)
        xr = [x.detach().requires_grad_(True) for x in vin]
        wr = None if w is None else w.detach().requires_grad_(True)

        def fwd(_):
            with torch.no_grad():
                v["fn"](*vin, w)

        def fwd_dx(_):
            torch.autograd.grad(v["fn"](*xr, w), xr, gy)

        def fwd_dw(_):
            torch.autograd.grad(v["fn"](*vin, wr), wr, gy)

        calls = {"fwd": fwd, "dx": fwd_dx, "dw": fwd_dw}
        t = {p: min(cuda_ms(calls[p], [None], PACKED_ITERS, graph=True)
                    for _ in range(PACKED_TRIALS)) for p in passes}
        x_bytes = sum(x.numel() for x in vin) * size
        w_bytes = 0 if w is None else w.numel() * size
        y_bytes = y.numel() * size
        ops = v["ops"] * r["n"]
        res = {"ms": {"fwd": t["fwd"]}, "bound_ms": {}, "bytes": {},
               "gflop": {}}
        for p in passes:
            if p != "fwd":
                res["ms"][p] = t[p] - t["fwd"]
            moved = {"fwd": x_bytes + w_bytes + y_bytes,
                     "dx": y_bytes + w_bytes + x_bytes,
                     "dw": y_bytes + x_bytes + w_bytes}[p]
            res["bytes"][p] = moved
            res["gflop"][p] = ops / 1e9
            res["bound_ms"][p] = 1e3 * max(moved / HBM_BYTES_PER_S,
                                           ops / PEAK_FLOPS[str(dtype)[6:]])
        out[label] = res
        log(f"  {r['name']:42s} n={r['n']:<3d} {label:6s} "
            + " ".join(f"{p} {res['ms'][p]:7.3f}" for p in passes)
            + " ms; bound " + " ".join(f"{res['bound_ms'][p]:.3f}"
                                       for p in passes)
            + f" ms ({res['bytes']['fwd'] / 1e6:.0f} MB, "
            f"{res['gflop']['fwd']:.1f} GFLOP a pass)")
        del vin, y, gy, xr, wr
    del xs, w
    torch.cuda.empty_cache()
    return out


def packed_phase(step_ms: dict) -> dict:
    """Phase 14: the card's verdict on the packed layout. Checks each
    packed row against the port's, then times every row in float32 (TF32
    convs, as in the train steps) and bfloat16, and weighs the rows by the
    times a 512x512 plain step runs them. ``step_ms``: the 512x512 plain
    graph step of this run (phase 11), by dtype. The verdict is ``port``
    where the packed rows with the boundary copies save more than
    ``VERDICT_SHARE`` of that step in either dtype, else ``close``."""
    import torch

    t14 = time.perf_counter()
    phase("[14] the packed layout (ops/packed.py) against the port's "
          "unpacked layers at the 512x512 recipe's batches (D 48 and 16, G "
          "16)")
    rows = packed_rows()
    torch.backends.cudnn.allow_tf32 = False
    phase("  check: each packed and folded row against the port's, float32 "
          "(TF32 off) and float64")
    out = {"check": check_packed_rows(rows), "rows": {}, "totals": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        torch.backends.cudnn.allow_tf32 = True  # the train steps' setting
        phase(f"  times, {name}: ms a pass (CUDA-graph replays, best of "
              f"{PACKED_TRIALS}); bound at {HBM_BYTES_PER_S / 1e12:.2f} TB/s "
              f"and {PEAK_FLOPS[name] / 1e12:.0f} TFLOP/s")
        totals = {"port": 0.0, "packed": 0.0, "folding": 0.0}
        for r in rows:
            t = time_packed_row(r, dtype)
            out["rows"][f"{r['name']}, n={r['n']} {name}"] = t
            step = {label: sum(c * res["ms"][p]
                               for p, c in r["counts"].items() if c)
                    for label, res in t.items()}
            for label in ("port", "packed"):
                totals[label] += step.get(label, 0.0)
            if "folded" in step and "port" in step:
                totals["folding"] += step["folded"] - step["port"]
        threshold = VERDICT_SHARE * step_ms[name]
        totals.update(saving=totals["port"] - totals["packed"],
                      threshold=threshold, step_ms=step_ms[name])
        out["totals"][name] = totals
        log(f"  {name}: the rows a 512x512 plain step runs: unpacked (the "
            f"port) {totals['port']:.3f} ms, packed with the boundary copies"
            f" {totals['packed']:.3f} ms, saving {totals['saving']:+.3f} ms "
            f"against {VERDICT_SHARE:.0%} of the {step_ms[name]:.2f} ms plain"
            f" graph step ({threshold:.3f} ms); the blur folded into the "
            f"downsampling convs, unpacked: {totals['folding']:+.3f} ms")
    torch.backends.cudnn.allow_tf32 = False
    out["verdict"] = ("port" if any(t["saving"] > t["threshold"]
                                    for t in out["totals"].values())
                      else "close")
    log("  verdict: " + out["verdict"] + " (" + "; ".join(
        f"{k}: packed saves {t['saving']:+.3f} ms of a {t['step_ms']:.2f} ms "
        f"step, {t['saving'] / t['step_ms']:+.2%}"
        for k, t in out["totals"].items()) + ")")
    out["seconds"] = time.perf_counter() - t14
    log(f"  phase 14: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------- the variants

VARIANT_BATCH = 8  # phase 15: two minibatch-stddev groups of 4


def _close_card(what: str, card, cpu, worst: dict) -> None:
    """``card`` within ``MODEL_TOL`` of ``cpu``'s largest element."""
    import torch

    card, cpu = card.detach().cpu(), cpu.detach()
    if card.shape != cpu.shape or not bool(torch.isfinite(card).all()):
        raise AssertionError(f"{what}: shape {tuple(card.shape)} or values")
    err = float((card - cpu).abs().max())
    limit = MODEL_TOL[0] + MODEL_TOL[1] * float(cpu.abs().max())
    worst[what] = err / limit
    if not err <= limit:
        raise AssertionError(f"{what}: card and CPU disagree: max|diff| "
                             f"{err:.3e} > {limit:.3e}")


def _near_zero_flips(branches, what: str) -> int:
    """The leaky-ReLU elements on the other branch on the card, each of
    whose pre-activations must lie within ``MODEL_TOL`` of 0 on both
    devices (phase 7's rule); returns their count."""
    import torch

    far = [f for f in branches.flips
           if bool(torch.isnan(f["cpu"]).any())
           or float(f["card"].abs().max()) > f["limit"]]
    if far:
        raise AssertionError(f"{what}: branches differ away from 0 in leaky "
                             f"ReLUs {[f['call'] for f in far]}")
    return sum(len(f["index"]) for f in branches.flips)


def _blurs(module) -> int:
    from contrad_tpu_torch.models.stylegan2.layers import Blur

    return sum(isinstance(m, Blur) for m in module.modules())


def variants_phase() -> dict:
    """Phase 15: the model variants that no registry architecture builds,
    on the card against the same modules on the CPU (plain versions),
    float32 with TF32 off, at StyleGAN2 32x32's registry widths (small32)
    and the SNDCGAN flagship's: outputs, input gradients and spectral
    norm's ``u``, each within ``MODEL_TOL`` of the CPU's largest element,
    the card taking the CPU's leaky-ReLU branches (``LeakyBranches``); the
    blur kernel launching once forward and once in the adjoint per
    ``Blur`` of each StyleGAN2 D, once per upsampling blur of each G
    forward."""
    import torch

    from contrad_tpu_torch.models import NullDiscriminator, get_architecture
    from contrad_tpu_torch.models.sndcgan import DSndcgan
    from contrad_tpu_torch.models.stylegan2 import (
        ResidualDiscriminator, SkipDiscriminator)
    from contrad_tpu_torch.ops.blur import blur2d
    from contrad_tpu_torch.ops.spectral_norm import commit_u

    t15 = time.perf_counter()
    phase(f"[15] the model variants no registry architecture builds, card "
          f"against CPU at StyleGAN2 32x32's widths (batch {VARIANT_BATCH})")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)
    n = VARIANT_BATCH
    x = torch.rand(n, 32, 32, 3, generator=gen)
    out = {"launches": {}, "worst": {}, "other_branch": {}}

    def card_vs_cpu(name, build, run, want_launches):
        """``run(module, device)`` -> {what: tensor} on the CPU (branches
        recorded) and the card (branches imposed), the blur's launches on
        the card counted."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1)
            cpu = build()
        card = copy.deepcopy(cpu).cuda()
        branches = LeakyBranches()
        with branches.record():
            want = run(cpu, "cpu")
        before = blur2d.launches
        with branches.impose():
            got = run(card, "cuda")
        torch.cuda.synchronize()
        launches = blur2d.launches - before
        worst = {}
        for what in want:
            _close_card(f"{name} {what}", got[what], want[what], worst)
        flips = _near_zero_flips(branches, name)
        out["launches"][name] = launches
        out["worst"][name] = max(worst.values())
        out["other_branch"][name] = flips
        named = [k for k in want if not k.endswith(".u")]
        n_u = len(want) - len(named)
        log(f"  {name:36s} {', '.join(named)}{f' and {n_u} u' * bool(n_u)}:"
            f" worst {max(worst.values()):.3f} of the tolerance; blur "
            f"launches {launches}; {flips} of "
            f"{sum(math.prod(c['shape']) for c in branches.calls)} leaky-ReLU"
            f" elements on the other branch")
        if launches != want_launches:
            raise AssertionError(f"{name}: {launches} blur launches, not "
                                 f"{want_launches}")

    gy = torch.randn(n, 1, generator=gen)

    def d_run(module, device):
        xr = x.to(device).requires_grad_(True)
        score = module(xr)
        (gx,) = torch.autograd.grad((score * gy.to(device)).sum(), xr)
        return {"score": score, "input grad": gx}

    for cls in (ResidualDiscriminator, SkipDiscriminator):
        blurs = _blurs(cls(32, small32=True))
        card_vs_cpu(cls.__name__, lambda cls=cls: cls(32, small32=True),
                    d_run, 2 * blurs)

    # G: mean_latent from a card generator, the same draws mapped on the
    # CPU; then per-layer and per-sample latents in, latents out
    G, _ = get_architecture("stylegan2", (32, 32, 3), device="cpu", seed=1)
    Gc = copy.deepcopy(G).cuda()
    with torch.no_grad():
        w_card = Gc.mean_latent(4096, torch.Generator("cuda").manual_seed(3))
        z = Gc.sample_latent(4096, torch.Generator("cuda").manual_seed(3))
        w_cpu = G.style_forward(z.cpu()).mean(dim=0, keepdim=True)
    worst = {}
    _close_card("G mean_latent", w_card, w_cpu, worst)
    lat = w_cpu[:, None] + 0.5 * torch.randn(n, G.n_latent, G.style_dim,
                                             generator=gen)
    noise = G.draw_noise(n, gen, torch.device("cpu"))
    mixing = G.draw_mixing(n, 0.9, gen, torch.device("cpu"))
    blurs, launches = _blurs(G), 0
    with torch.no_grad():
        for what, args, kw in (
                ("per-layer latents, mixing", (lat, noise, mixing),
                 dict(train=True)),
                ("mean latent, eval", (w_cpu.expand(n, -1), noise, None),
                 dict(train=False))):
            want = G(*args, input_is_latent=True, return_latents=True, **kw)
            before = blur2d.launches
            got = Gc(*_to(args, "cuda"), input_is_latent=True,
                     return_latents=True, **kw)
            launches += blur2d.launches - before
            _close_card(f"G {what}: image", got[0], want[0], worst)
            _close_card(f"G {what}: latents", got[1], want[1], worst)
    out["launches"]["GStylegan2 input_is_latent"] = launches
    out["worst"]["GStylegan2"] = max(worst.values())
    log(f"  {'GStylegan2':36s} mean_latent, images and latents of 2 "
        f"forwards: worst {max(worst.values()):.3f} of the tolerance; blur "
        f"launches {launches}")
    if launches != 2 * blurs:
        raise AssertionError(f"G: {launches} blur launches, not {2 * blurs}")

    # SNDCGAN with the linear head (mlp_linear False, JAX's default), at the
    # flagship's widths, with and without labels; u after the pass
    y = torch.randint(0, 10, (n,), generator=gen)
    gp = torch.randn(n, 128, generator=gen)

    def sn_run(labels):
        def run(module, device):
            xr = x.to(device).requires_grad_(True)
            d, aux = module(xr, y.to(device) if labels else None)
            (gx,) = torch.autograd.grad(
                (d * gy.to(device)).sum()
                + (aux["projection"] * gp.to(device)).sum(), xr)
            commit_u(module)
            return {"score": d, "projection": aux["projection"],
                    "input grad": gx,
                    **{k: v for k, v in module.state_dict().items()
                       if k.endswith(".u")}}
        return run

    for labels in (False, True):
        card_vs_cpu(f"DSndcgan(mlp_linear=False){' labels' * labels}",
                    lambda: DSndcgan((32, 32, 3), d_hidden=512, n_classes=10),
                    sn_run(labels), 0)
    null = NullDiscriminator()
    worst = {}
    _close_card("NullDiscriminator", null(x.cuda()), null(x), worst)
    out["worst"]["NullDiscriminator"] = worst["NullDiscriminator"]
    out["seconds"] = time.perf_counter() - t15
    log(f"  phase 15: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------- the runbook

RUNBOOK = "contrad_tpu_torch/tools/quality_run.sh"
RUNBOOK_ENV = {"DATASET": "synthetic_32", "EMBED": "moments", "STEPS": "20",
               "EVAL_EVERY": "10", "FID_SIZE": "1000", "DEVICE": "cuda"}
PRECALC_IMAGES = 256


def runbook_phase() -> dict:
    """Phase 16: the quality runbook's weights-free dry run on the card
    (the flagship at batch 512 for 20 steps, FID@1000 of the ``moments``
    embedder at steps 10 and 20; its statistics and runs under the run's
    temporary directory): exit 0, a finite best FID from its trajectory,
    the CSV's two rows; then ``precalc_stats --images`` on 256 PNGs the
    phase writes (the synthetic reference split), with the InceptionV3 on
    random weights from a numpy seed (phase 9's), on the card (TF32 off)
    against the CPU: mu and sigma within ``MODEL_TOL``."""
    import numpy as np
    import torch
    from PIL import Image

    from contrad_tpu_torch.data import get_dataset_ref
    from contrad_tpu_torch.tools import precalc_stats

    t16 = time.perf_counter()
    phase("[16] the quality runbook's dry run on the card: "
          + " ".join(f"{k}={v}" for k, v in RUNBOOK_ENV.items()))
    root = Path(LOG_ROOT, "quality")
    env = dict(os.environ, **RUNBOOK_ENV, LOGROOT=str(root / "logs"),
               FID_STATS_DIR=str(root / "stats"))
    t0 = time.perf_counter()
    r = subprocess.run(["bash", RUNBOOK], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"the runbook exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    tag = f"BEST FID@{RUNBOOK_ENV['FID_SIZE']} ({RUNBOOK_ENV['EMBED']} embedder):"
    best = float(r.stdout.rsplit(tag, 1)[1].split()[0])
    csv = r.stdout.split("--- ", 1)[1].splitlines()
    rows = [line for line in csv[2:] if line and line[0].isdigit()]
    steps = [line.split(",")[0] for line in rows]
    for line in r.stdout.splitlines():
        if line.startswith("==") or "img/s" in line or tag in line:
            log(f"  | {line}")
    every, last = int(RUNBOOK_ENV["EVAL_EVERY"]), int(RUNBOOK_ENV["STEPS"])
    if not math.isfinite(best) or steps != [
            str(i) for i in range(every, last + 1, every)]:
        raise AssertionError(f"runbook: best FID {best}, evaluations at "
                             f"steps {steps}")
    log(f"  runbook: {seconds:.1f} s, best FID@{RUNBOOK_ENV['FID_SIZE']} "
        f"{best:.6f} (moments), evaluations at steps {steps}")
    out = {"seconds_runbook": seconds, "best_fid": best, "csv": rows}

    folder = root / "pngs"
    folder.mkdir(parents=True)
    images = np.asarray(get_dataset_ref("synthetic_32").images)
    for i in range(PRECALC_IMAGES):
        Image.fromarray(images[i]).save(folder / f"{i:04d}.png")
    weights = root / "inception_random.pth"
    torch.save(inception_weights(0), weights)
    torch.backends.cudnn.allow_tf32 = False
    stats, secs = {}, {}
    before = os.environ.get("INCEPTION_WEIGHTS")
    os.environ["INCEPTION_WEIGHTS"] = str(weights)
    try:
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            path = precalc_stats.main(
                ["--images", str(folder), "--out",
                 str(root / f"stats_{device}.npz"), "--embed", "inception",
                 "--device", device])
            secs[device] = time.perf_counter() - t0
            stats[device] = np.load(path)
    finally:
        if before is None:
            del os.environ["INCEPTION_WEIGHTS"]
        else:
            os.environ["INCEPTION_WEIGHTS"] = before
    worst = {}
    for k in ("mu", "sigma"):
        _close_card(f"precalc_stats --images {k}",
                    torch.from_numpy(stats["cuda"][k]),
                    torch.from_numpy(stats["cpu"][k]), worst)
    log(f"  precalc_stats --images, {PRECALC_IMAGES} PNGs, InceptionV3 with "
        f"random weights: mu {stats['cuda']['mu'].shape}, sigma "
        f"{stats['cuda']['sigma'].shape}; card against CPU at "
        f"{worst['precalc_stats --images mu']:.3f} and "
        f"{worst['precalc_stats --images sigma']:.3f} of the tolerance; "
        f"{secs['cuda']:.1f} s on the card, {secs['cpu']:.1f} s on the CPU")
    out.update(precalc_worst=worst, precalc_seconds=secs,
               seconds=time.perf_counter() - t16)
    log(f"  phase 16: {out['seconds']:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--fused_act_only", action="store_true",
                    help="run phases 1, 2 and 17 alone")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "contrad_tpu_torch" / "csrc" / "blur2d.cu").is_file():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)

    global LOG_ROOT
    logs = tempfile.TemporaryDirectory(prefix="chip_smoke_runs_")
    LOG_ROOT = logs.name
    drawing = {DATA_512: (subprocess.Popen(
        [sys.executable, "-c", DRAW_DATASET, str(ROOT), DATA_512,
         os.path.join(LOG_ROOT, f"{DATA_512}.pickle")]),
        os.path.join(LOG_ROOT, f"{DATA_512}.pickle"))}
    try:
        return run_phases(args, drawing)
    finally:
        for proc, _ in drawing.values():
            proc.kill()
            proc.wait()
        logs.cleanup()


def run_phases(args, drawing: dict) -> int:
    """Phases 1-16 (``main`` starts the dataset draw and stops it)."""
    import torch

    from contrad_tpu_torch.ops import blur, fused_act

    card = card_line()
    phase(f"[1] card: {card}")
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    blur.build(verbose=True)
    build_s = time.perf_counter() - t0
    phase(f"[2] built the blur kernel in {build_s:.2f} s")
    t0 = time.perf_counter()
    fused_act.build(verbose=True)
    act_build_s = time.perf_counter() - t0
    phase(f"  built the fused activation kernel in {act_build_s:.2f} s")
    if args.fused_act_only:
        phase17 = fused_act_phase(fused_act)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(dict(
                card=card, kind=kind, act_build_s=act_build_s,
                fused_act=phase17), indent=1, default=str))
        print(json.dumps({"kernels": [phase17["kernel"]]}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = blur_cases() + eval_blur_cases()
    paths = ("stylegan2_32", "stylegan2_512", "stylegan2_512_r1",
             "lineval_32", "lineval_32_tail", "cddls_32", "cddls_32_final",
             "sample_32", "fid_32", "gif_32")
    per_step = {path: per_step_launches(cases, path) for path in paths}
    phase(f"[3] blur kernel vs plain version at {len(cases)} cases; launches "
          f"per step (train paths) or per call (evaluation paths): {per_step}")
    max_err = check_blur(blur, cases)
    phase("  timing")
    copy_bps = copy_bandwidth()
    log(f"  device-to-device copy: {copy_bps / 1e9:.1f} GB/s")
    rows = time_blur(blur, cases, copy_bps)
    step_sum = {f"{path} {dtype} {when}": sum(
        r["per_step"].get(path, 0) * r[when] for r in rows
        if r["dtype"] == dtype)
        for path in paths for dtype in ("float32", "bfloat16")
        for when in ("ms", "cold_ms")}
    host_us = blur_host_us(blur)
    log(f"  wrapper host time per call: {host_us['blur2d']:.2f} us "
        f"(blur2d), {host_us['_launch']:.2f} us (_launch)")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for training

    from contrad_tpu_torch import (
        train_gan, train_stylegan2, train_stylegan2_contraD)

    from contrad_tpu_torch.evaluate import fid

    fid.STATS_DIR = os.path.join(LOG_ROOT, "fid_stats")  # made in this run
    share_datasets(drawing)
    count_evaluation_launches()
    phase(f"[4] main path: {STEPS} steps of the 32x32 StyleGAN2 + "
          f"ContraD recipe, batch {BATCH}")
    run = run_cli(train_stylegan2.main, RECIPE, "synthetic_32", STEPS, BATCH)
    log_run("32x32 StyleGAN2 + ContraD, batch", run)
    expect_launches(run, STEPS * per_step["stylegan2_32"], "the 32x32 path")
    prof = profile(train_stylegan2, RECIPE, "synthetic_32", do_r1=True)
    expect_launches(prof, per_step["stylegan2_32"], "a profiled 32x32 step")
    log(f"  blur kernel per step: {prof['blur_ms_per_step']:.3f} ms under "
        f"the profiler; phase 3's times weighted by launches per step: "
        f"{step_sum['stylegan2_32 float32 ms']:.3f} ms warm, "
        f"{step_sum['stylegan2_32 float32 cold_ms']:.3f} ms cold (float32)")

    torch.backends.cudnn.allow_tf32 = False
    phase("[5] G and D forwards, card vs CPU")
    model_err = model_reference_check()

    phase("[6] the SNDCGAN + ContraD flagship and snresnet18 (no hand-written "
          "kernel on their path)")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for training
    flagship = run_cli(train_gan.main, FLAGSHIP, "synthetic_32", STEPS)
    baseline = run_cli(train_gan.main, GAN_BASELINE, "synthetic_32", 3)
    snresnet = run_cli(train_gan.main, SNRESNET, "synthetic_32", 3)
    for name, r in (("flagship contrad, batch", flagship),
                    ("std baseline, batch", baseline),
                    ("snresnet18 contrad, batch", snresnet)):
        log_run(name, r)
        expect_launches(r, 0, name.split(",")[0])
    log("  TF32 convs on, TF32 matmuls off")
    gan_prof = profile(train_gan, FLAGSHIP, "synthetic_32")
    expect_launches(gan_prof, 0, "a profiled flagship step")
    torch.backends.cudnn.allow_tf32 = False
    gan_err = gan_card_vs_cpu()

    phase(f"[7] the 512x512 recipe: {STEPS_512} steps of "
          f"train_stylegan2_contraD at batch {BATCH_512} (step 16 with R1)")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for training
    run512 = run_cli(train_stylegan2_contraD.main, RECIPE_512, DATA_512,
                     STEPS_512, BATCH_512)
    history = run512["history"]
    r1_steps = [r["step"] for r in history if r["D_r1"] > 0]
    if r1_steps != [16]:
        raise AssertionError(f"R1 ran at steps {r1_steps}, not at step 16")
    expect_launches(run512, (STEPS_512 - 1) * per_step["stylegan2_512"]
                    + per_step["stylegan2_512_r1"], "the 512x512 path")
    run512["ms_per_plain_step"] = 1e3 * sum(
        r["seconds_per_step"] for r in history[1:15]) / 14
    run512["ms_per_r1_step"] = 1e3 * history[15]["seconds_per_step"]
    run512["img_per_s"] = BATCH_512 / (run512["ms_per_plain_step"] * 1e-3)
    log(f"  blur launches: {run512['launches']} ({per_step['stylegan2_512']} "
        f"a plain step, {per_step['stylegan2_512_r1']} the R1 step); "
        f"{run512['ms_per_plain_step']:.2f} ms a plain step (steps 2-15), "
        f"{run512['ms_per_r1_step']:.2f} ms the R1 step, first step "
        f"{history[0]['seconds_per_step']:.2f} s; {run512['img_per_s']:.2f} "
        f"img/s; peak memory {run512['peak_bytes'] / 2**30:.3f} GiB")
    torch.cuda.empty_cache()
    prof512 = profile(train_stylegan2, RECIPE_512, DATA_512, BATCH_512)
    expect_launches(prof512, per_step["stylegan2_512"],
                    "a profiled 512x512 step")
    log(f"  blur kernel per plain step: {prof512['blur_ms_per_step']:.3f} ms "
        f"under the profiler; phase 3's times weighted by launches per step:"
        f" {step_sum['stylegan2_512 float32 ms']:.3f} ms warm, "
        f"{step_sum['stylegan2_512 float32 cold_ms']:.3f} ms cold (float32)")
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    phase("  one 512x512 step (batch 4, R1) on the card against the CPU")
    check512 = sg2_512_card_vs_cpu()
    torch.cuda.empty_cache()

    phase8 = evaluation_phase(train_gan, train_stylegan2, per_step, flagship)
    phase9 = inception_phase(phase8["stylegan2"]["sample_dir"])
    phase10 = bf16_phase(per_step, step_sum)
    phase11 = graph_phase(per_step)
    phase12 = world_phase(per_step)
    phase13 = data_phase(per_step)
    phase14 = packed_phase({
        dtype: sum(r["ms_per_step"] for r in runs) / len(runs)
        for dtype, runs in (
            ("float32", phase11["times"]["stylegan2_512 f32"]["graph"]),
            ("bfloat16", phase11["times"]["stylegan2_512 bf16"]["graph"]))})
    phase15 = variants_phase()
    phase16 = runbook_phase()
    phase17 = fused_act_phase(fused_act)

    big = max((r for r in rows if r["dtype"] == "float32"),
              key=lambda r: r["bytes"])
    kernels = [{
        "name": "blur2d", "route": "cuda",
        "source": "contrad_tpu_torch/csrc/blur2d.cu",
        "replaces": "contrad_tpu/ops/pallas_blur.py:73",
        "launches": run512["launches"], "max_abs_err": max_err,
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
        "launches_per_path": {
            "stylegan2_32 (phase 4, 6 steps)": run["launches"],
            "sndcgan (phase 6)": flagship["launches"],
            "snresnet18 (phase 6)": snresnet["launches"],
            f"stylegan2_512 (phase 7, {STEPS_512} steps)": run512["launches"],
            **phase8["launches"],
            **{f"{name} bf16 (phase 10, run {i + 1})": r["launches"]
               for name, turns in phase10["runs"].items()
               for i, r in enumerate(turns["bf16"])},
            **{f"{name} through graph replays (phase 11, 2 blocks of "
               f"{GRAPH_K})": r["replay_launches"]
               for name, r in phase11["equality"].items()},
            **{f"{name} graph run {i + 1} (phase 11, with warm-up)":
               r["launches"] for name, turns in phase11["times"].items()
               for i, r in enumerate(turns["graph"])},
            **{f"{name} NCCL world of 1, {WORLD_STEPS} steps (phase 12a, "
               f"with warm-up)": r["launches"]
               for name, r in phase12["a"].items()},
            **{f"{name} gloo world of 2, per rank a step (phase 12b)":
               r["launches_per_step"] for name, r in phase12["b"].items()},
            **{f"{name} {turn} run {i + 1}, {DATA_STEPS} steps (phase 13a"
               + (", with warm-up)" if turn == "graph" else ")"):
               r["launches"] for name, a in phase13["a"].items()
               for turn, runs in a["runs"].items()
               for i, r in enumerate(runs)},
            **{f"{name} sharded gloo world of 2, per rank a step (phase "
               f"13c)": r["launches_per_step"]
               for name, r in phase13["c"].items()},
            **{f"{row} {label}, forward and adjoint (phase 14 check)":
               v["blur_launches"] for row, labels in phase14["check"].items()
               for label, v in labels.items() if v["blur_launches"]},
            **{f"{name} (phase 15)": n
               for name, n in phase15["launches"].items()}},
        "launches_per_step": dict(per_step, sndcgan=0, snresnet18=0,
                                  sndcgan_conditional=0)},
        phase17["kernel"]]
    total_s = time.perf_counter() - T0
    log(f"whole run: {total_s:.1f} s")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(
            card=card, kind=kind, build_s=build_s, total_s=total_s,
            blur_cases=rows, blur_max_abs_err=max_err,
            copy_bytes_per_s=copy_bps, blur_launches_per_step=per_step,
            blur_ms_per_step_from_cases=step_sum, blur_host_us=host_us,
            train=run, profile=prof,
            model_max_abs_err=model_err, kernels=kernels,
            sndcgan=dict(card=card, flagship=flagship, std_baseline=baseline,
                         snresnet18=snresnet, profile=gan_prof,
                         card_vs_cpu_max_abs_err=gan_err,
                         tf32="convs on, matmuls off (card vs CPU: off)"),
            stylegan2_512=dict(train=run512, profile=prof512,
                               card_vs_cpu=check512),
            evaluation=phase8, inception=phase9, bf16=phase10,
            graphs=phase11, worlds=phase12, data_paths=phase13,
            packed=phase14, variants=phase15, runbook=phase16,
            act_build_s=act_build_s, fused_act=phase17),
            indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
