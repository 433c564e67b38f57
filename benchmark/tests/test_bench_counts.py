"""The yardstick's counts: the FLOP counter against hand counts of
SNDCGAN's layers, and the blur's table of a step against the rows of
``chip_smoke.py`` that ``PERF.md`` prints and the launches it counts."""

from __future__ import annotations

import pytest

from conftest import ROOT


def _reference(name):
    from benchmark.harness.spec import load_json

    return load_json(ROOT / "benchmark" / "configs" / f"{name}.json")[
        "reference"]


def _conv(h, w, cout, cin, k):
    return 2 * h * w * cout * cin * k * k


def test_sndcgan_forward_flops_by_hand():
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.families.sndcgan import SNDCGAN

    model = SNDCGAN(_reference("sndcgan_c10_b512")["model"])
    d = {n: torch.zeros(s, device="meta") for n, s, _ in model.d_spec()}
    g = {n: torch.zeros(s, device="meta") for n, s, _ in model.g_spec()}
    with FlopCounterMode(display=False) as fc:
        model.discriminator(d, d, torch.zeros(1, 32, 32, 3, device="meta"))
    d_convs = (_conv(32, 32, 64, 3, 3) + _conv(16, 16, 128, 64, 4)
               + _conv(16, 16, 128, 128, 3) + _conv(8, 8, 256, 128, 4)
               + _conv(8, 8, 256, 256, 3) + _conv(4, 4, 512, 256, 4)
               + _conv(4, 4, 512, 512, 3))
    heads = 2 * (8192 * 512 + 512 * 1 + 2 * (8192 * 512 + 512 * 128))
    assert fc.get_total_flops() == d_convs + heads
    with FlopCounterMode(display=False) as fc:
        model.generator(g, dict(g), {"z": torch.zeros(1, 128, device="meta")})
    # transposed convs count their input pixels times their taps
    g_flops = (2 * 128 * 8192 + _conv(4, 4, 512, 256, 4)
               + _conv(8, 8, 256, 128, 4) + _conv(16, 16, 128, 64, 4)
               + _conv(32, 32, 3, 64, 3))
    assert fc.get_total_flops() == g_flops


def test_step_flops_compose():
    """A step is more than its forwards: D's pass on 3N images with its
    weight gradients, G's update through D; an R1 step costs more."""
    from benchmark.counts.flops import step_flops

    snd = _reference("sndcgan_c10_b512")
    fwd_d, fwd_g = 456786944, 206962688  # per image, as above
    n = snd["recipe"]["batch_size"]
    plain = step_flops(snd, "plain")
    # D phase: G forward, D fwd + bwd (weights) on 3N; G phase: G fwd +
    # bwd, D fwd + input bwd on N: between 7 and 10 forwards' worth
    assert 7 * n * (fwd_d + fwd_g) < plain < 10 * n * (fwd_d + fwd_g)
    sg2 = _reference("stylegan2_afhq512_b16")
    assert step_flops(sg2, "r1") > 1.2 * step_flops(sg2, "plain")
    with pytest.raises(ValueError):
        step_flops(snd, "r1")


@pytest.mark.parametrize("shape,pad,up,mb", [
    ((192, 32, 32, 128), (2, 2), 1, 207.7),
    ((48, 512, 512, 32), (2, 2), 1, 3227.5),
    ((16, 8, 8, 512), (1, 1), 1, 3.7),
    ((512, 33, 33, 128), (1, 1), 2, 553.9),
])
def test_blur_bytes_match_the_printed_rows(shape, pad, up, mb):
    from benchmark.counts.blur import launch_bytes

    assert round(launch_bytes(shape, pad) / 1e6, 1) == mb


@pytest.mark.parametrize("config,kind,launches", [
    ("stylegan2_c10_b64", "r1", 54),
    ("stylegan2_afhq512_b16", "plain", 70),
    ("stylegan2_afhq512_b16", "r1", 126),
])
def test_blur_table_launches(config, kind, launches):
    from benchmark.counts.blur import launches as table, step_launches

    ref = _reference(config)
    batch = ref["recipe"]["batch_size"]
    assert step_launches(ref["model"], batch, kind) == launches
    rows = table(ref["model"], batch)
    if config == "stylegan2_afhq512_b16":
        assert ((48, 512, 512, 32), (2, 2), 1,
                {"plain": 1, "r1": 1}) in rows
