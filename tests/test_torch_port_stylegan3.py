"""StyleGAN3-T (``models/stylegan3``) against the benchmark's plain reference
(``benchmark.reference.families.stylegan3``), on the CPU.

* the layer schedule at 512x512 against NVlabs' published one (rates, sizes,
  widths, factors, taps, cutoffs, pads), the port's and the reference's;
* the Kaiser filters against ``scipy.signal.firwin`` (skips where scipy is
  absent);
* at ``stylegan3_t_tiny`` in float64 on seeded random weights (the entries
  that start at zero or one moved, so that every path carries a gradient):
  G's forward, its gradients in ``z`` and in every parameter, and the EMA
  buffers after an updating forward, against the reference plainly and in
  its row blocks (``g_rows``: the styles' batch-wide normalisation then
  differentiated over the whole batch). Float64 on both sides, the same
  function in another order of sums: 1e-12 of the largest magnitude;
* a whole ``ema_r1`` train step of the port, R1 at step 2, against the
  reference ``Trainer`` (``benchmark.harness.train.compared_gaps``), in
  float32, D at 16 channels a level: each number within float32 rounding
  of sums over 32x32 images and 7 layers;
* a checkpoint and ``--resume`` of a ``stylegan3_t_tiny`` run bitwise,
  buffers included, with the in-loop FID sampler (moments) and ``generate``
  (its D narrowed to 16 channels, so that a checkpoint is a megabyte).
"""

import copy
import importlib
import math
import os

import numpy as np
import pytest
import torch

import contrad_tpu_torch.models.stylegan2.discriminator as sg2_d
from contrad_tpu_torch.models import TINY_SCHEDULE, generate, get_architecture
from contrad_tpu_torch.models.stylegan3 import synthesis_schedule
from contrad_tpu_torch.ops.filtered_lrelu import lowpass_filter
from contrad_tpu_torch.utils.checkpoint import restore_checkpoint
from test_torch_port_checkpoint import assert_bitwise
from torch_port_jax import one_torch_thread  # noqa: F401  (autouse)

from benchmark.reference.families.stylegan3 import StyleGAN3, firwin

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

# NVlabs' SynthesisNetwork at 512x512, --cfg=stylegan3-t: per layer (L0-L13,
# ToRGB) rate in/out, size in/out, channels in/out, up, down, taps up/down,
# cutoff in/out, the upsampled side and pads (lo, hi)
TABLE = [
    (16, 16, 36, 36, 512, 512, 2, 2, 12, 12, 2.00, 2.00, 82, 9, 8),
    (16, 16, 36, 36, 512, 512, 2, 2, 12, 12, 2.00, 3.00, 82, 9, 8),
    (16, 32, 36, 52, 512, 512, 4, 2, 24, 12, 3.00, 4.49, 114, -6, -9),
    (32, 32, 52, 52, 512, 512, 2, 2, 12, 12, 4.49, 6.73, 114, 9, 8),
    (32, 64, 52, 84, 512, 512, 4, 2, 24, 12, 6.73, 10.08, 178, -6, -9),
    (64, 64, 84, 84, 512, 512, 2, 2, 12, 12, 10.08, 15.10, 178, 9, 8),
    (64, 128, 84, 148, 512, 512, 4, 2, 24, 12, 15.10, 22.63, 306, -6, -9),
    (128, 128, 148, 148, 512, 483, 2, 2, 12, 12, 22.63, 33.90, 306, 9, 8),
    (128, 256, 148, 276, 483, 323, 4, 2, 24, 12, 33.90, 50.80, 562, -6, -9),
    (256, 256, 276, 276, 323, 215, 2, 2, 12, 12, 50.80, 76.11, 562, 9, 8),
    (256, 512, 276, 532, 215, 144, 4, 2, 24, 12, 76.11, 114.04, 1074, -6, -9),
    (512, 512, 532, 532, 144, 96, 2, 2, 12, 12, 114.04, 170.86, 1074, 9, 8),
    (512, 512, 532, 532, 96, 64, 2, 2, 12, 12, 170.86, 256.0, 1074, 9, 8),
    (512, 512, 532, 512, 64, 64, 2, 2, 12, 12, 256.0, 256.0, 1034, -11, -12),
    (512, 512, 512, 512, 64, 3, 1, 1, 1, 1, 256.0, 256.0, 512, 0, 0),
]
REF_SCHEDULE = dict(channel_base=32768, channel_max=512, num_layers=14,
                    num_critical=2, first_cutoff=2.0, first_stopband=2**2.1,
                    last_stopband_rel=2**0.3, margin_size=10, filter_size=6,
                    lrelu_upsampling=2, conv_kernel=3)


def tiny_model(batch: int, g_rows: int) -> dict:
    """The reference's ``model`` table of ``stylegan3_t_tiny`` at 32x32
    (``stylegan2_tiny``'s D)."""
    sched = dict(REF_SCHEDULE, **TINY_SCHEDULE)
    return {"family": "stylegan3", "image_size": 32, "z_dim": 32, "w_dim": 32,
            "mapping_layers": 2, "lr_mapping": 0.01, "w_avg_beta": 0.998,
            "magnitude_ema_beta": 0.5 ** (batch / (20 * 1e3)),
            "conv_clamp": 256.0, "output_scale": 0.25, "g_rows": g_rows,
            "schedule": sched, "d_hidden": 32,
            "channels": {"4": 512, "8": 512, "16": 512, "32": 512}}


def test_schedule_matches_the_published_table():
    port = synthesis_schedule(512)[1:]
    _, ref = StyleGAN3.schedule(512, **REF_SCHEDULE)
    assert len(port) == len(ref) == len(TABLE)
    for p, r, row in zip(port, ref, TABLE):
        (rin, rout, sin, sout, cin, cout, up, down, tu, td, fin, fout, side,
         lo, hi) = row
        assert (p["in_rate"], p["out_rate"], p["in_size"], p["out_size"]) == (
            rin, rout, sin, sout)
        assert (p["in_channels"], p["out_channels"], p["up"], p["down"]) == (
            cin, cout, up, down)
        assert (p["taps_up"], p["taps_down"], p["padding"]) == (
            tu, td, (lo, hi, lo, hi))
        assert round(p["in_cutoff"], 2) == fin
        assert round(p["out_cutoff"], 2) == fout
        # the upsampled side: (size_in + k - 1) * up + pads - taps_up + 1
        k = p["kernel"]
        assert (sin + k - 1) * up + lo + hi - tu + 1 == side
        assert (r["rate_in"], r["rate_out"], r["size_in"], r["size_out"],
                r["cin"], r["cout"], r["up"], r["down"], r["taps_up"],
                r["taps_down"], r["pad"]) == (rin, rout, sin, sout, cin, cout,
                                              up, down, tu, td, (lo, hi))
        for key in ("in_cutoff", "out_cutoff", "in_half_width",
                    "out_half_width", "tmp_rate"):
            assert p[key] == r[key], key


def test_filters_match_scipy_firwin():
    signal = pytest.importorskip(
        "scipy.signal", reason="scipy is not installed: the comparison with "
        "scipy.signal.firwin needs it")
    for spec in synthesis_schedule(512)[1:]:
        for taps, cut, half in (("taps_up", "in_cutoff", "in_half_width"),
                                ("taps_down", "out_cutoff",
                                 "out_half_width")):
            if spec[taps] == 1:
                assert lowpass_filter(1, 1.0, 1.0, 2.0) is None
                continue
            want = signal.firwin(spec[taps], spec[cut], width=2 * spec[half],
                                 fs=spec["tmp_rate"])
            # float32 taps (as NVlabs keeps them): within their rounding
            got = lowpass_filter(spec[taps], spec[cut], 2 * spec[half],
                                 spec["tmp_rate"])
            assert np.abs(got - want).max() < 1e-7
            ref = firwin(spec[taps], spec[cut], 2 * spec[half],
                         spec["tmp_rate"])
            assert np.abs(ref - want).max() < 1e-14


def _weights(batch: int, g_rows: int):
    """The reference's model, G in float64 with the same entries, and the
    reference's (parameters, buffers) in float64."""
    from benchmark.reference.weights import make_weights

    model = tiny_model(batch, g_rows)
    fam = StyleGAN3(model)
    w = make_weights(model, 2**31 + 11, "cpu")["generator"]
    gen = torch.Generator().manual_seed(5)
    p, state = {}, {}
    for name, v in w.items():
        v = v.double()
        if name.endswith(fam.buffers):
            state[name] = v
        else:  # move the zeros and ones of the init, so that all paths count
            p[name] = v + 0.05 * torch.randn(v.shape, generator=gen,
                                             dtype=torch.float64)
    G, _ = get_architecture("stylegan3_t_tiny", (32, 32, 3), device="cpu",
                            batch_size=batch)
    G = G.double()
    G.load_state_dict({**p, **state})
    return fam, G, p, state


@pytest.mark.parametrize("g_rows", [4, 1])  # plain, then row blocks
def test_generator_matches_the_reference_in_float64(g_rows):
    batch = 4
    fam, G, p, state = _weights(batch, g_rows)
    params = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    z = torch.randn(batch, 32, generator=torch.Generator().manual_seed(9),
                    dtype=torch.float64)
    zp, zr = z.clone().requires_grad_(True), z.clone().requires_grad_(True)
    got = G(zp, train=True)  # an updating forward
    want = fam.generator(params, state, {"z": zr})
    assert float((got - want).detach().abs().max()) <= 1e-12 * float(
        want.detach().abs().max())
    assert got.shape == want.shape == (batch, 32, 32, 3)
    for name, buf in G.named_buffers():
        if name in state:  # the EMAs moved alike; the fixed buffers stayed
            assert torch.allclose(buf, state[name], rtol=0, atol=1e-14), name
    moved = [n for n, b in G.named_buffers() if n.endswith(
        ("w_avg", "magnitude_ema")) and not torch.equal(b, _weights(
            batch, g_rows)[3][n])]
    assert len(moved) == 1 + len(fam.layers)
    dy = torch.randn(got.shape, generator=torch.Generator().manual_seed(2),
                     dtype=torch.float64)
    names = [n for n, _ in G.named_parameters()]
    gp = torch.autograd.grad(got, [zp] + list(G.parameters()), dy)
    gr = torch.autograd.grad(want, [zr] + [params[n] for n in names], dy)
    for name, a, b in zip(["z"] + names, gp, gr):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max()
                                                          + 1e-300), name


def test_train_step_matches_the_reference_trainer(monkeypatch):
    from benchmark.harness.spec import load_json
    from benchmark.harness.train import compared_gaps

    cfg = copy.deepcopy(load_json(os.path.join(
        ROOT, "benchmark", "configs", "stylegan3t_afhq512_b16.json")))
    argv = cfg["program"]["argv"]
    argv[1] = "stylegan3_t_tiny"
    argv[:] = [a for a in argv if not a.startswith("options.batch_size")]
    at = argv.index("--override")
    argv[at:at] = ["--d_reg_every", "2"]
    argv += ["options.batch_size=4", "options.dataset=synthetic_32"]
    # D at 16 channels a level, on both sides
    monkeypatch.setattr(sg2_d, "stylegan2_channels",
                        lambda *a, **kw: {4: 16, 8: 16, 16: 16, 32: 16})
    cfg["reference"]["model"] = dict(tiny_model(4, 2), channels={
        "4": 16, "8": 16, "16": 16, "32": 16})
    cfg["reference"]["recipe"].update(batch_size=4, d_reg_every=2)
    cfg["data"]["rows"] = 64
    cfg["compare"] = [[1, 1], [2, 2]]
    traffic = load_json(os.path.join(ROOT, "benchmark", "traffic",
                                     "train.json"))
    gaps = compared_gaps(cfg, traffic, 2**31 + 7, "cpu")
    # float32 on both sides, sums in other orders over 7 layers at 32x32
    # (read 1e-7 to 1e-5): ten times and more of room
    assert gaps["loss1_gap"] < 1e-5, gaps
    assert gaps["loss_gap"] < 1e-5, gaps
    assert gaps["r1_gap"] < 1e-5, gaps
    assert gaps["grad_gap"] < 1e-4, gaps
    assert gaps["proj_grad1_diff"] < 1e-5, gaps
    assert gaps["change_gap"] < 1e-4, gaps


ARGV = ["configs/gan/stylegan2/afhq_dog_style64.toml", "stylegan3_t_tiny",
        "--halflife_k", "1", "--ema_start_k", "0", "--use_warmup", "--no_gif",
        "--d_reg_every", "2", "--device", "cpu", "--print_every", "2",
        "--evaluate_every", "2", "--fid_embed", "moments", "--n_eval_avg", "1"]


def _run(root, steps, *flags):
    main = importlib.import_module(
        "contrad_tpu_torch.train_stylegan2_contraD").main
    return main(ARGV + list(flags) + [
        "--logdir_root", str(root), "--override",
        "options.dataset=synthetic_32_64", "options.batch_size=4",
        "options.fid_size=8", f"options.max_steps={steps}"])


def test_checkpoint_and_resume_are_bitwise(tmp_path, monkeypatch):
    monkeypatch.setattr(sg2_d, "stylegan2_channels",
                        lambda *a, **kw: {4: 16, 8: 16, 16: 16, 32: 16})
    import contrad_tpu_torch.evaluate.fid as pfid

    monkeypatch.setattr(pfid, "STATS_DIR", str(tmp_path / "stats"))
    straight = _run(tmp_path / "a", 4)
    first = _run(tmp_path / "b", 2)
    resumed = _run(tmp_path / "b", 4, "--resume", first.logdir)
    assert [r["step"] for r in resumed] == [4]
    assert straight[1] == dict(resumed[0], seconds_per_step=straight[1][
        "seconds_per_step"])
    end = restore_checkpoint(straight.logdir)
    assert_bitwise(end, restore_checkpoint(first.logdir))
    g = end["generator"]
    assert any(k.endswith("magnitude_ema") for k in g)
    assert "mapping.w_avg" in g and float(g["mapping.w_avg"].abs().sum()) > 0
    assert not any(k.endswith("_filter") for k in g)  # remade, not saved
    with open(os.path.join(straight.logdir, "log.txt")) as f:
        assert "FID" in f.read()
    assert any(n.startswith("results_fid") for n in os.listdir(
        straight.logdir))
    # the EMA G from the checkpoint, in eval mode: images in [0, 1], its
    # buffers left as they were
    G, _ = get_architecture("stylegan3_t_tiny", (32, 32, 3), device="cpu")
    G.load_state_dict(end["g_ema"])
    before = copy.deepcopy(G.state_dict())
    z = torch.randn(3, 32, generator=torch.Generator().manual_seed(1))
    img = generate(G, z, noise_rng=torch.Generator())
    assert img.shape == (3, 32, 32, 3) and img.dtype == torch.float32
    assert float(img.min()) >= 0 and float(img.max()) <= 1
    assert math.isfinite(float(img.sum()))
    assert_bitwise(before, G.state_dict())
