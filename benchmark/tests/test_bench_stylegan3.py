"""The StyleGAN3-T configuration (``configs/stylegan3t_afhq512_b16.json``,
family ``reference/families/stylegan3.py``): its spec is the program's
``state_dict`` at the published widths (a strict load), its schedule the
configuration's table, its filtered leaky ReLU table the launches the
program makes a step at the test width, its step FLOPs pinned, and the
three filtered-lrelu metrics read from a synthetic trace (and read nothing
where the program has no such kernel)."""

from __future__ import annotations

import collections
import math

import pytest

from conftest import ROOT

CONFIG = "stylegan3t_afhq512_b16"
CELL = "sg3t_afhq512_b16.train"


def _config():
    from benchmark.harness.spec import load_json

    return load_json(ROOT / "benchmark" / "configs" / f"{CONFIG}.json")


def test_spec_is_the_programs_state_dict_at_the_published_widths():
    import torch

    from contrad_tpu_torch.models import get_architecture

    from benchmark.reference.families import make_model
    from benchmark.reference.weights import make_weights

    model = _config()["reference"]["model"]
    fam = make_model(model)
    table = model["layers"]
    assert [s["rate_out"] for s in fam.layers] == table["rate"]
    assert [s["size_out"] for s in fam.layers] == table["size"]
    assert [s["cout"] for s in fam.layers] == table["channels"]
    assert [s["up"] for s in fam.layers] == table["up"]
    assert [s["down"] for s in fam.layers] == table["down"]
    G, D = get_architecture("stylegan3_t_512", (512, 512, 3), device="cpu",
                            batch_size=16)
    w = make_weights(model, 7, "cpu")
    G.load_state_dict(w["generator"])  # strict: the same names and shapes
    D.load_state_dict(w["discriminator"])
    for layer in G.synthesis.layers:
        assert layer.magnitude_ema_beta == model["magnitude_ema_beta"]
    assert sum(p.numel() for p in G.parameters()) == sum(
        math.prod(s) for n, s, _ in fam.g_spec()
        if not n.endswith(fam.buffers))
    assert torch.equal(G.synthesis.input.freqs, w["generator"][
        "synthesis.input.freqs"])


def test_filtered_lrelu_table_is_the_programs(traffic, monkeypatch):
    """The program's filtered leaky ReLU at the test width on the CPU, its
    forward and backward counted through an autograd Function around the
    plain op: every launch the kernel would make in a plain and in an R1
    step is a row of the family's table, by shapes, factors and taps."""
    import torch

    import contrad_tpu_torch.models.stylegan3.generator as gen
    from contrad_tpu_torch.models import TINY_SCHEDULE
    from contrad_tpu_torch.ops import filtered_lrelu as flr

    from benchmark.counts import filtered_lrelu as counts
    from benchmark.harness.train import Program

    seen = collections.Counter()

    class Counted(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, b, fu, fd, up, down, pad, *rest):
            y = flr.filtered_lrelu_plain(x, b, fu, fd, up, down, pad, *rest)
            lu, ld = len(fu or (1,)), len(fd or (1,))
            geo = flr.geometry(x.shape[1], x.shape[2], up, down, lu, ld, pad)
            grid = (geo.grid_h, geo.grid_w)
            seen[("forward", tuple(x.shape), tuple(y.shape), grid, up, down,
                  lu, ld)] += 1
            ctx.key = ("backward", tuple(y.shape), tuple(x.shape), grid, down,
                       up, ld, lu)
            ctx.args = (fu, fd, up, down, pad) + rest
            ctx.save_for_backward(x, b)
            return y

        @staticmethod
        def backward(ctx, dy):
            seen[ctx.key] += 1
            x, b = ctx.saved_tensors
            with torch.enable_grad():
                x, b = x.detach().requires_grad_(), b.detach().requires_grad_()
                y = flr.filtered_lrelu_plain(x, b, *ctx.args)
            dx, db = torch.autograd.grad(y, (x, b), dy)
            return (dx, db) + (None,) * (len(ctx.args))

    monkeypatch.setattr(gen, "filtered_lrelu",
                        lambda x, b, *a: Counted.apply(x, b, *a))
    cfg = _config()
    argv = cfg["program"]["argv"]
    argv[1] = "stylegan3_t_tiny"
    argv[:] = [a for a in argv if not a.startswith("options.batch_size")]
    argv += ["--d_reg_every", "2", "--override", "options.batch_size=4",
             "options.dataset=synthetic_32"]
    model = cfg["reference"]["model"]
    model.update(image_size=32, z_dim=32, w_dim=32, d_hidden=32,
                 magnitude_ema_beta=0.5 ** (4 / 20e3),
                 channels={str(2**i): 512 for i in range(2, 6)})
    model["schedule"].update(TINY_SCHEDULE)
    cfg["reference"]["recipe"].update(batch_size=4, d_reg_every=2)
    cfg["data"]["rows"] = 64
    prog = Program(cfg, traffic, 5, "cpu")
    for block in ([1], [2]):
        seen.clear()
        prog.run_block(block)
        kind = prog.kinds(block)[0]
        want = collections.Counter()
        for row in counts.launches(model, 4):
            want[tuple(row[:8])] += row[8][kind]
        assert +seen == +want, kind
        assert counts.step_launches(model, 4, kind) == 2 * 7


def test_pinned_counts():
    """The step's FLOPs (the reference on the meta device: G's convolutions
    and products once, D's as the StyleGAN2 cells count them) and the
    kernel's table: 30 launches a step, its bytes and roofline time."""
    from benchmark.counts import filtered_lrelu as counts
    from benchmark.counts.flops import step_flops

    ref = _config()["reference"]
    assert step_flops(ref, "plain") == 32904964020512.0
    assert step_flops(ref, "r1") == 36581474425120.0
    model = ref["model"]
    rows = counts.launches(model, 16)
    assert counts.step_launches(model, 16, "plain") == 30
    assert counts.step_launches(model, 16, "r1") == 30
    fwd = [r for r in rows if r[0] == "forward"]
    # the upsampled grids: 735.6 M values an image; the outputs 177.7 M
    assert sum(r[3][0] * r[3][1] * r[1][3] for r in fwd) == 735598708
    assert sum(r[2][1] * r[2][2] * r[2][3] for r in fwd) == 177701456
    assert sum(counts.launch_bytes(r) for r in fwd) == 22222407232
    assert sum(counts.launch_macs(r) for r in fwd) == 201411059712
    assert counts.step_seconds(model, 16, "plain") == pytest.approx(
        13.825e-3, rel=1e-3)


def _run(kernels, counters):
    from benchmark.harness.trace import Trace

    return {"trace": Trace(1.0, kernels, []), "window_s": 1.0, "steps": 10,
            "kinds": {"plain": 9, "r1": 1}, "counters": counters,
            "config": _config(), "dtype": "f32", "capture_s": 1.0}


def test_metrics_read_a_synthetic_trace():
    from benchmark.counts.filtered_lrelu import step_seconds
    from benchmark.harness.spec import load_cell
    from benchmark.harness.trace import kernel_class

    name = ("void (anonymous namespace)::filtered_lrelu_tile_kernel<2, 2, 12, "
            "12, 24, 24, 1, false, float>(FlrParams)")
    assert kernel_class(name) == "other"
    kernels = [(name, 0.0, 0.1), (name.replace("false", "true"), 0.2, 0.35),
               ("sm90_xmma_fprop_implicit_gemm", 0.1, 0.2)]
    cell = load_cell(CELL, ROOT)
    run = _run(kernels, {"filtered_lrelu.launches": 300,
                         "filtered_lrelu.scalar_launches": 0})
    read = {m: cell.readers[m](run) for m in (
        "filtered_lrelu_launches_per_step", "filtered_lrelu_ms_per_step",
        "filtered_lrelu_roofline_pct")}
    assert read["filtered_lrelu_launches_per_step"] == 30.0
    assert read["filtered_lrelu_ms_per_step"] == pytest.approx(25.0)
    model = _config()["reference"]["model"]
    bound = 10 * step_seconds(model, 16, "plain")
    assert read["filtered_lrelu_roofline_pct"] == pytest.approx(
        100 * bound / 0.25)
    # a program without the kernel (the parent): nothing to read
    empty = _run([("sm90_xmma_fprop_implicit_gemm", 0.1, 0.2)], {})
    for m in read:
        assert cell.readers[m](empty) is None, m
