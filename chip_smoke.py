#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``contrad_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure ends the run with a non-zero exit code and no
result line:

1. the card's name and power limit (``nvidia-smi``);
2. build the hand-written CUDA blur kernel (``contrad_tpu_torch/csrc``) from
   the sources beside this script, and time the build;
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
   images and draws, TF32 off): losses and both phases' gradients;
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
   StyleGAN2 samples.

Then it prints the whole run's time, the kernel table as one JSON line,
the card's name and power limit, and, last, ``{"ok": true, "device":
{...}}``. It needs the repository around it and exits non-zero where no
CUDA card is present.
"""

from __future__ import annotations

import argparse
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


def cli_argv(recipe, dataset: str, steps: int, batch=None):
    """The train CLI's arguments for ``recipe`` on ``dataset`` at ``batch``
    (the config's where None) up to step ``steps``, and the batch."""
    from contrad_tpu_torch.config import default_config_files, load_config

    if batch is None:
        batch = load_config(default_config_files(recipe[0])).options.batch_size
    return recipe + ["--print_every", "1", "--seed", "0", "--logdir_root",
                     LOG_ROOT, "--override", f"options.dataset={dataset}",
                     f"options.batch_size={batch}",
                     f"options.max_steps={steps}"], batch


def run_cli(main, recipe, dataset: str, steps: int, batch=None):
    """``steps`` steps of one of the port's training CLIs (its ``main``)
    with ``recipe`` on ``dataset`` at ``batch`` (the config's where None),
    with the blur's launch counts set to 0 just before and read just after;
    every metric it prints must be finite. Returns its history (with the
    run's logdir and the checkpoints it wrote), the blur's launches (all,
    and on the scalar path), the peak device memory and the ms per step
    (the mean after the first; the steps' own, checkpoint writes excluded)
    and img/s."""
    import torch

    from contrad_tpu_torch.ops import blur

    argv, batch = cli_argv(recipe, dataset, steps, batch)
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
                batch=batch, launches=launches,
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


def share_datasets() -> None:
    """Make each dataset once for the whole run: phase 7's steps and its
    profile read the same ``synthetic_512`` (2,560 images of 512x512, which
    numpy takes about a minute to draw). The CLIs look ``get_dataset`` up in
    ``contrad_tpu_torch.data`` when they build."""
    import functools

    from contrad_tpu_torch import data

    data.get_dataset = functools.lru_cache(maxsize=None)(data.get_dataset)


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
    ``dataset``: kernel time by class, the largest kernels, the idle share
    and launches per step (``class_report``), with the blur's launches and
    device ms per step."""
    from contrad_tpu_torch.ops import blur

    override = [f"options.dataset={dataset}"]
    if batch is not None:
        override.append(f"options.batch_size={batch}")
    P = cli.parse_args(recipe + ["--seed", "0", "--override"] + override)
    _, loader, trainer = cli.build(P)
    for _ in range(2):
        trainer.train_step(next(loader), **step_kwargs)
    blur.blur2d.launches = 0
    report = class_report(*profile_rows(
        lambda: trainer.train_step(next(loader), **step_kwargs), steps))
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


def sg2_512_card_vs_cpu(batch: int = 4) -> dict:
    """One ``StyleGAN2Trainer`` step of the 512x512 recipe (``stylegan2_512``
    at full width, contrad, ``simclr_hq``, lazy R1 on) on the card and on
    the CPU, from the same weights, images and draws, float32 with TF32
    off: the losses and the gradients of both phases, each tensor within
    ``MODEL_TOL`` of its largest element on the CPU. Batch 4: the smallest
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
    draws, out = None, {}
    for device in ("cpu", "cuda"):
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
        metrics = trainer.train_step(images.to(device),
                                     draws=_to(draws, device))
        grads = {f"G.{k}": g for (k, _), g in zip(G.named_parameters(),
                                                   g_tx.grads)}
        grads.update({f"D.{k}": g for (k, _), g in zip(D.named_parameters(),
                                                        d_tx.grads)})
        out[device] = ({k: v.reshape(1) for k, v in metrics.items()}, grads,
                       time.perf_counter() - t0)
        del trainer, G, D
    worst, failed = {"loss": 0.0, "grad": 0.0}, []
    for what, i in (("loss", 0), ("grad", 1)):
        for k, want in out["cpu"][i].items():
            got = out["cuda"][i][k].cpu()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"512x512 step on the card: {k} is not "
                                     f"finite")
            err = float((got - want).abs().max())
            limit = MODEL_TOL[0] + MODEL_TOL[1] * float(want.abs().max())
            worst[what] = max(worst[what], err / limit)
            if what == "loss" or not err <= limit:
                log(f"  {k:44s} max|card - cpu| {err:.3e} (tol {limit:.3e})")
            if not err <= limit:
                failed.append(k)
    log(f"  {len(out['cpu'][1])} gradient tensors: worst max|card - cpu| at "
        f"{worst['grad']:.3f} of its tolerance; losses at "
        f"{worst['loss']:.3f}; step {out['cpu'][2]:.1f} s on the CPU, "
        f"{out['cuda'][2]:.2f} s on the card (first)")
    if failed:
        raise AssertionError(f"512x512 step: card and CPU disagree on "
                             f"{failed}")
    return dict(batch=batch, worst_fraction_of_tol=worst,
                cpu_s=out["cpu"][2], card_s=out["cuda"][2])


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


# ------------------------------------------------------------------ main

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every measurement to this JSON file")
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

    from contrad_tpu_torch.ops import blur

    card = card_line()
    phase(f"[1] card: {card}")
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    blur.build(verbose=True)
    build_s = time.perf_counter() - t0
    phase(f"[2] built the blur kernel in {build_s:.2f} s")

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

    global LOG_ROOT
    logs = tempfile.TemporaryDirectory(prefix="chip_smoke_runs_")
    LOG_ROOT = logs.name
    from contrad_tpu_torch.evaluate import fid

    fid.STATS_DIR = os.path.join(LOG_ROOT, "fid_stats")  # made in this run
    share_datasets()
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
    logs.cleanup()

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
            **phase8["launches"]},
        "launches_per_step": dict(per_step, sndcgan=0, snresnet18=0,
                                  sndcgan_conditional=0)}]
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
            evaluation=phase8, inception=phase9),
            indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
