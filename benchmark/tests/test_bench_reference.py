"""The plain reference against the program on the CPU at tiny widths: the
compared steps of each configuration's recipe (draws, augment, models,
losses, Adam, EMA, R1) agree to float32 rounding."""

from __future__ import annotations

import pytest

from conftest import tiny_config

CASES = {
    # the flagship at full width, batch 8
    "sndcgan": lambda: tiny_config("sndcgan_c10_b512", 8),
    # R1 every step, the data's mirror
    "sg2_r1_every_step": lambda: tiny_config("stylegan2_c10_b64", 4, size=8),
    # the 512x512 recipe's augment and lazy R1 (at step 2) at 8x8
    "sg2_hq_lazy_r1": lambda: _lazy(tiny_config("stylegan2_afhq512_b16", 4,
                                                size=8)),
}


def _lazy(cfg):
    cfg["program"]["argv"] += ["--d_reg_every", "2"]
    cfg["reference"]["recipe"]["d_reg_every"] = 2
    cfg["compare"] = [[1, 1], [2, 2]]
    return cfg


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_follows_the_program(case, traffic):
    from benchmark.harness.train import compared_gaps

    gaps = compared_gaps(CASES[case](), traffic, 2**31 + 7, "cpu")
    # float32 sums in another layout and order; the noise strengths'
    # gradients, sums of grad x noise over every pixel, cancel the most
    assert gaps["loss1_gap"] < 1e-4, gaps
    assert gaps["loss_gap"] < 1e-4, gaps
    assert gaps["grad_gap"] < 3e-3, gaps
    assert gaps["proj_grad1_diff"] < 1e-4, gaps
    assert gaps["change_gap"] < 1e-2, gaps


@pytest.mark.parametrize("config,size", [("sndcgan_c10_b512", 32),
                                         ("stylegan2_afhq512_b16", 64)])
def test_augment_follows_the_program(config, size):
    """The recipe's augmentation, draws and images, against the program's
    (at 64x64 simclr_hq's Gaussian blur has 7 taps)."""
    import torch

    from contrad_tpu_torch.augment import AugRng, get_augment
    from contrad_tpu_torch.config import (
        default_config_files, finalize_options, load_config)

    from benchmark.reference.augment import SimCLR
    from benchmark.reference.draws import Rand

    cfg = tiny_config(config, 4)
    argv = cfg["program"]["argv"]
    mode = argv[argv.index("--aug") + 1]
    program = get_augment(mode, finalize_options(load_config(
        default_config_files(argv[0]), [])).get("augment"))
    ref = SimCLR(cfg["reference"]["augment"], cfg["reference"]["augment"]["hq"])
    shape = (16, size, size, 3)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(3))
    for seed in range(4):
        got = program.apply(x, program.sample(shape, AugRng.from_seed(seed,
                                                                      "cpu")))
        want = ref.apply(x, ref.sample(shape, Rand.from_seed(seed, "cpu")))
        assert float((got - want).abs().max()) < 1e-5
