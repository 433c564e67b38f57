#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``contrad_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure ends the run with a non-zero exit code and no
result line:

1. the card's name and power limit (``nvidia-smi``);
2. build the hand-written CUDA blur kernel (``contrad_tpu_torch/csrc``) from
   the sources beside this script, and time the build;
3. hold the blur kernel to its plain PyTorch version at every (shape, pad)
   the 32x32 StyleGAN2 train step gives it, forward and adjoint, and at the
   512x512 recipe's largest blurs, in float32 (TF32 off) and bfloat16,
   forward, backward and double backward; then time the kernel (L2 warm and
   cold, float32 and bfloat16), the plain version and a depthwise
   ``F.conv2d`` (a yardstick the port never calls) at those shapes, beside
   the least time the card could take; sum the kernel's times weighted by
   launches per step; time the wrapper's host cost per call;
4. the main path: 6 train steps of the StyleGAN2 + ContraD recipe
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
   full width, batch 512) and 3 of the README's ``std`` baseline
   (``c10_b64.toml``, batch 64), on synthetic 32x32 data, with the blur's
   launch count set to 0 just before each and read just after (it must
   stay 0); losses must be finite; ms/step, img/s and peak memory; then a
   torch.profiler breakdown of 3 flagship steps (kernel time by class, the
   25 largest kernels, the idle share, launches per step); then one
   flagship ``GANTrainer`` step on the card against the same step on the
   CPU (same weights and draws, TF32 off, batch 64): losses, parameters,
   spectral norm's ``u`` and the batch-norm statistics.

Then it prints the kernel table as one JSON line, the card's name and power
limit, and, last, ``{"ok": true, "device": {...}}``. It needs the repository
around it and exits non-zero where no CUDA card is present.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import subprocess
import sys
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
# the README's SNDCGAN recipes (batch from the config), synthetic data
FLAGSHIP = ["configs/gan/cifar10/c10_b512.toml", "sndcgan", "--mode",
            "contrad", "--aug", "simclr", "--use_warmup"]
GAN_BASELINE = ["configs/gan/cifar10/c10_b64.toml", "sndcgan", "--mode", "std"]
GAN_LOSSES = ("D_loss", "D_penalty", "D_real", "D_gen", "G_loss")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ blur

def blur_cases():
    """Every (shape, pad, upsample factor) the blur kernel takes in one train
    step of the 32x32 StyleGAN2 (small32 channels {32: 128, 16: 256, 8:
    512}), with its launches per step: G's post-upsample blurs at batch 64,
    once forward and once as the adjoint; D's two downsample blurs per
    ResBlock (3x3 conv2: pads (2, 2); 1x1 skip: pads (1, 1)) at batch 192
    (the D phase's real, real, fake), once each way, and at batch 64 three
    times each way (the G phase, R1, and R1's double backward). Each
    adjoint is a row of its own: the gradient's shape, the reversed taps,
    the complementary pads (k - 1 - pad0, k - 1 - pad1). 54 launches in
    all. Then, off the main path (0 per step), the blurs of the
    512x512 recipe (configs/gan/stylegan2/style512_tpu_demo.toml: batch 8,
    stylegan2_channels(1.0) = {512: 32, 256: 64, 128: 128}): D's 3x3
    downsample blurs at 512, 256 and 128, and G's last post-upsample blur."""
    ch = {8: 512, 16: 256, 32: 128}
    fwd = [("G", (BATCH, 2 * s + 1, 2 * s + 1, ch[2 * s]), (1, 1), 2, 1)
           for s in (4, 8, 16)]
    for n, per_step in ((BATCH, 3), (3 * BATCH, 1)):
        for s in (32, 16, 8):
            fwd += [("D", (n, s, s, ch[s]), (2, 2), 1, per_step),
                    ("D", (n, s, s, ch[s]), (1, 1), 1, per_step)]
    cases = []
    for who, shape, pad, up, per_step in fwd:
        cases.append(dict(who=who, shape=shape, pad=pad, up=up,
                          per_step=per_step, adjoint=False))
    for who, (n, h, w, c), pad, up, per_step in fwd:
        cases.append(dict(who=who + " adj", shape=(n, h + sum(pad) - 3,
                                                   w + sum(pad) - 3, c),
                          pad=(3 - pad[0], 3 - pad[1]), up=up,
                          per_step=per_step, adjoint=True))
    for shape, pad, up, who in (((8, 512, 512, 32), (2, 2), 1, "D 512"),
                                ((8, 256, 256, 64), (2, 2), 1, "D 512"),
                                ((8, 128, 128, 128), (2, 2), 1, "D 512"),
                                ((8, 513, 513, 32), (1, 1), 2, "G 512")):
        cases.append(dict(who=who, shape=shape, pad=pad, up=up, per_step=0,
                          adjoint=False))
    return cases


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


def check_blur(blur, cases) -> float:
    """Kernel vs plain version, forward, backward and double backward, in
    float32 and bfloat16; returns the largest float32 error."""
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

            def run(fn):
                # y = blur(x); gx = blur^T(g), the backward; d<gx, hh>/dg =
                # blur(hh), the double backward R1 takes
                xx = x.clone().requires_grad_(True)
                gg = g.clone().requires_grad_(True)
                y = fn(xx, *taps, pad)
                (gx,) = torch.autograd.grad(y, xx, gg, create_graph=True)
                (g2,) = torch.autograd.grad(gx, gg, hh)
                return y.detach(), gx.detach(), g2

            got = run(blur.blur2d)
            want = run(blur.blur2d_plain)
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
    rate, or float32 operations, whichever is larger)."""
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
            if case["per_step"] and not plan.vector:
                raise AssertionError(f"main-path shape {shape} took the "
                                     f"scalar path")
            ms = cuda_ms(lambda a: blur.blur2d(a, taps_v, taps_h, pad), [x],
                         graph=True)
            cold_ms = cuda_ms(lambda a: blur.blur2d(a, taps_v, taps_h, pad),
                              cold, graph=True)
            del cold
            w2d = torch.outer(torch.tensor(taps_v), torch.tensor(taps_h))
            w2d = w2d[None, None].expand(c, 1, k, k).contiguous().to(
                "cuda", dtype)
            x_cl = x.permute(0, 3, 1, 2)  # channels_last view, no copy
            x_nchw = x_cl.contiguous()
            assert pad[0] == pad[1]
            library_ms = min(cuda_ms(lambda a: F.conv2d(
                a, w2d, padding=pad[0], groups=c), [xx], graph=True)
                for xx in (x_cl, x_nchw))
            del x_nchw
            plain_ms = (cuda_ms(lambda a: blur.blur2d_plain(
                a, taps_v, taps_h, pad), [x]) if dtype == torch.float32
                else None)
            nbytes = item * n * c * (h * w + ho * wo)
            flops = 2 * k * n * c * ho * (w + pad[0] + pad[1] + wo)
            bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
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
            log(f"  blur {name:8s} {case['who']:6s} {str(shape):20s} pad "
                f"{pad} up {case['up']} x{case['per_step']}/step "
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

def train(steps: int):
    from contrad_tpu_torch.ops import blur
    from contrad_tpu_torch.train_stylegan2 import main

    import torch

    argv = RECIPE + ["--print_every", "1", "--seed", "0", "--override",
                     "options.dataset=synthetic_32",
                     f"options.batch_size={BATCH}",
                     f"options.max_steps={steps}"]
    torch.cuda.reset_peak_memory_stats()
    blur.blur2d.launches = blur.blur2d.scalar_launches = 0
    history = main(argv)
    launches, scalar = blur.blur2d.launches, blur.blur2d.scalar_launches
    peak = torch.cuda.max_memory_allocated()
    for rec in history:
        for k in ("D_loss", "D_penalty", "D_real", "D_gen", "D_r1", "G_loss"):
            if not math.isfinite(rec[k]):
                raise AssertionError(f"step {rec['step']}: {k} = {rec[k]}")
    if launches == 0:
        raise AssertionError("the train step never launched the blur kernel")
    if scalar:
        raise AssertionError(f"{scalar} of the main path's blur launches "
                             f"took the scalar path")
    timed = [r["seconds_per_step"] for r in history[1:]]
    ms_step = 1e3 * sum(timed) / len(timed)
    return dict(history=history, launches=launches,
                launches_per_step=launches / steps, ms_per_step=ms_step,
                img_per_s=BATCH / (ms_step * 1e-3), peak_bytes=peak)


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


def profile_step(steps: int = 3):
    """Device time by kernel over a few train steps (torch.profiler): the
    kernels' own time, summed by name, and the device's idle share of the
    wall time of those steps (under the profiler)."""
    import torch

    from contrad_tpu_torch.train_stylegan2 import build, parse_args

    P = parse_args(RECIPE + ["--seed", "0", "--override",
                             "options.dataset=synthetic_32"])
    _, loader, trainer = build(P)
    for _ in range(2):
        trainer.train_step(next(loader), do_r1=True)
    wall_ms, rows = profile_rows(
        lambda: trainer.train_step(next(loader), do_r1=True), steps)
    busy = sum(r[0] for r in rows)
    blur_ms = sum(r[0] for r in rows if "blur2d_kernel" in r[2])
    log(f"  profile: {wall_ms:.2f} ms/step wall, kernels {busy:.2f} ms/step "
        f"(idle {100 * (1 - busy / wall_ms):.1f} %), blur kernel "
        f"{blur_ms:.3f} ms/step ({100 * blur_ms / busy:.1f} % of kernels)")
    for ms, count, key in rows[:25]:
        log(f"    {ms:8.3f} ms/step  x{count:<4.0f} {key[:100]}")
    return dict(wall_ms_per_step=wall_ms, kernel_ms_per_step=busy,
                idle_share=1 - busy / wall_ms, blur_ms_per_step=blur_ms,
                kernels=[dict(ms=ms, count=c, name=k) for ms, c, k in rows])


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

def train_gan(recipe, steps: int):
    """``steps`` steps of ``contrad_tpu_torch.train_gan`` with ``recipe`` on
    synthetic 32x32 data; the blur kernel must not launch."""
    import torch

    from contrad_tpu_torch.ops import blur
    from contrad_tpu_torch.train_gan import main

    argv = recipe + ["--print_every", "1", "--seed", "0", "--override",
                     "options.dataset=synthetic_32",
                     f"options.max_steps={steps}"]
    torch.cuda.reset_peak_memory_stats()
    blur.blur2d.launches = blur.blur2d.scalar_launches = 0
    history = main(argv)
    launches = blur.blur2d.launches
    peak = torch.cuda.max_memory_allocated()
    for rec in history:
        for k in GAN_LOSSES:
            if not math.isfinite(rec[k]):
                raise AssertionError(f"step {rec['step']}: {k} = {rec[k]}")
    if launches:
        raise AssertionError(f"the SNDCGAN path launched the blur kernel "
                             f"{launches} times")
    from contrad_tpu_torch.config import default_config_files, load_config

    batch = load_config(default_config_files(recipe[0])).options.batch_size
    timed = [r["seconds_per_step"] for r in history[1:]]
    ms_step = 1e3 * sum(timed) / len(timed)
    return dict(history=history, batch=batch, blur_launches=launches,
                ms_per_step=ms_step, img_per_s=batch / (ms_step * 1e-3),
                peak_bytes=peak)


def kernel_class(name: str) -> str:
    """A CUDA kernel's class, from its name."""
    n = name.lower()
    for cls, keys in (
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


def profile_gan(steps: int = 3):
    """torch.profiler over ``steps`` flagship steps (after 2 untimed ones):
    kernel time by class, the largest kernels, idle share, launches."""
    from contrad_tpu_torch.train_gan import build, parse_args

    P = parse_args(FLAGSHIP + ["--seed", "0", "--override",
                               "options.dataset=synthetic_32"])
    _, loader, trainer = build(P)
    for _ in range(2):
        trainer.train_step(next(loader))
    wall_ms, rows = profile_rows(lambda: trainer.train_step(next(loader)),
                                 steps)
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


def gan_card_vs_cpu(batch: int = 64) -> float:
    """One flagship GANTrainer step (sndcgan at full width, contrad, simclr,
    nonsat, Adam with warmup) on the card and on the CPU, from the same
    weights, images and draws, float32 with TF32 off: the losses and every
    parameter and buffer after the step (``u``, batch-norm statistics)."""
    import torch

    from contrad_tpu_torch.augment import get_augment
    from contrad_tpu_torch.models import get_architecture
    from contrad_tpu_torch.training import GANTrainer, ScheduledAdam

    images = torch.rand(batch, 32, 32, 3,
                        generator=torch.Generator().manual_seed(3))
    draws, out = None, {}
    for device in ("cpu", "cuda"):
        G, D = get_architecture("sndcgan", (32, 32, 3), device=device, seed=1)

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
                                     draws=_to(draws, device))
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
    log(f"[1] card: {card}")
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    blur.build(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"[2] built the blur kernel in {build_s:.2f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = blur_cases()
    per_step = sum(c["per_step"] for c in cases)
    log(f"[3] blur kernel vs plain version at {len(cases)} cases "
        f"({sum(c['per_step'] > 0 for c in cases)} of the main path, "
        f"{per_step} launches per step)")
    max_err = check_blur(blur, cases)
    copy_bps = copy_bandwidth()
    log(f"  device-to-device copy: {copy_bps / 1e9:.1f} GB/s")
    rows = time_blur(blur, cases, copy_bps)
    step_sum = {f"{dtype} {when}": sum(
        r["per_step"] * r[when] for r in rows if r["dtype"] == dtype)
        for dtype in ("float32", "bfloat16") for when in ("ms", "cold_ms")}
    host_us = blur_host_us(blur)
    log(f"  wrapper host time per call: {host_us['blur2d']:.2f} us "
        f"(blur2d), {host_us['_launch']:.2f} us (_launch)")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for training

    log(f"[4] main path: {STEPS} steps of the 32x32 StyleGAN2 + "
        f"ContraD recipe, batch {BATCH}")
    run = train(STEPS)
    log(f"  blur launches: {run['launches']} ({run['launches_per_step']:.1f}"
        f" per step); {run['ms_per_step']:.2f} ms/step after the first, "
        f"{run['img_per_s']:.1f} img/s; peak memory "
        f"{run['peak_bytes'] / 2**30:.3f} GiB")
    if run["launches_per_step"] != per_step:
        raise AssertionError(f"{run['launches_per_step']} blur launches per "
                             f"step, not the {per_step} that phase 3 times")
    prof = profile_step()
    log(f"  blur kernel per step: {prof['blur_ms_per_step']:.3f} ms under "
        f"the profiler; phase 3's times weighted by launches per step: "
        f"{step_sum['float32 ms']:.3f} ms warm, "
        f"{step_sum['float32 cold_ms']:.3f} ms cold (float32)")

    torch.backends.cudnn.allow_tf32 = False
    log("[5] G and D forwards, card vs CPU")
    model_err = model_reference_check()

    log("[6] the SNDCGAN + ContraD flagship (no hand-written kernel on its "
        "path)")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for training
    flagship = train_gan(FLAGSHIP, STEPS)
    baseline = train_gan(GAN_BASELINE, 3)
    for name, r in (("flagship contrad, batch", flagship),
                    ("std baseline, batch", baseline)):
        log(f"  {name} {r['batch']}: {r['ms_per_step']:.2f} ms/step after "
            f"the first, {r['img_per_s']:.1f} img/s; peak memory "
            f"{r['peak_bytes'] / 2**30:.3f} GiB; blur launches "
            f"{r['blur_launches']}; TF32 convs on, TF32 matmuls off")
    gan_prof = profile_gan()
    torch.backends.cudnn.allow_tf32 = False
    gan_err = gan_card_vs_cpu()

    big = max((r for r in rows if r["per_step"] and r["dtype"] == "float32"),
              key=lambda r: r["bytes"])
    kernels = [{
        "name": "blur2d", "route": "cuda",
        "source": "contrad_tpu_torch/csrc/blur2d.cu",
        "replaces": "contrad_tpu/ops/pallas_blur.py:73",
        "launches": run["launches"], "max_abs_err": max_err,
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": big["library_ms"]}]
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(
            card=card, kind=kind, build_s=build_s, blur_cases=rows,
            blur_max_abs_err=max_err, copy_bytes_per_s=copy_bps,
            blur_ms_per_step_from_cases=step_sum, blur_host_us=host_us,
            train={k: v for k, v in run.items()}, profile=prof,
            model_max_abs_err=model_err, kernels=kernels,
            sndcgan=dict(card=card, flagship=flagship, std_baseline=baseline,
                         profile=gan_prof, card_vs_cpu_max_abs_err=gan_err,
                         tf32="convs on, matmuls off (card vs CPU: off)")),
            indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
