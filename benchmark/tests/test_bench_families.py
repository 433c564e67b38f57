"""Model families as files (``reference/families/``): a family defined
outside the benchmark's sources and found by its name goes through the
reference, the weights, the FLOP count and the kernel tables with no edit
to a file that is there; the three configurations' counts and weights are
pinned to the values they had before the families moved into files; no
code outside a family's module names a family; and StyleGAN2's table of
the fused activation's launches is the program's, shape by shape."""

from __future__ import annotations

import collections
import hashlib
import math
import re
import sys
import types

import pytest

from conftest import ROOT, tiny_config

FAMILIES = ROOT / "benchmark" / "reference" / "families"


# ------------------------------------------------------------ a new family

def _toy_class():
    import torch
    import torch.nn.functional as F

    from benchmark.reference.families import Family
    from benchmark.reference.nets import fir, head_spec, heads

    class Toy(Family):
        """Fourier features of z with drawn frequencies and phases, scaled
        by a magnitude EMA that G's pass updates (a buffer), a dense layer
        to the image; D a conv, a fixed 4-tap filter (a buffer) and the
        heads."""

        buffers = (".magnitude_ema", ".filter")

        def __init__(self, cfg):
            self.size, self.nz = cfg["image_size"], cfg["nz"]
            self.d_hidden, self.step = cfg["d_hidden"], cfg["step"]
            self.width = 4

        def g_spec(self):
            s = self.size
            return [("fourier.freqs", (self.nz, 2), ("disc", 2.0)),
                    ("fourier.phases", (self.nz,), ("phase",)),
                    ("to_img.weight", (s * s * 3, self.nz), ("normal", 0.05)),
                    ("to_img.bias", (s * s * 3,), ("zeros",)),
                    ("to_img.magnitude_ema", (), ("ones",))]

        def d_spec(self):
            return ([("conv.weight", (self.width, 3, 3, 3), ("normal", 0.1)),
                     ("conv.bias", (self.width,), ("zeros",)),
                     ("down.filter", (4,), ("kaiser",))]
                    + head_spec(self.n_features, self.d_hidden,
                                lambda i: ("normal", 0.1)))

        def make(self, name, shape, init, gen):
            if init[0] == "disc":
                u = torch.rand((2,) + shape[:1], generator=gen,
                               device=gen.device)
                r, a = init[1] * u[0].sqrt(), 2 * math.pi * u[1]
                return torch.stack([r * a.cos(), r * a.sin()], 1)
            if init[0] == "phase":
                return torch.rand(shape, generator=gen,
                                  device=gen.device) - 0.5
            if init[0] == "kaiser":
                k = torch.kaiser_window(shape[0], periodic=False,
                                        device=gen.device)
                return k / k.sum()
            return super().make(name, shape, init, gen)

        @property
        def n_features(self):
            return self.width * self.size * self.size

        def sample_z(self, n, r):
            return {"z": r.randn((n, self.nz))}

        def generator(self, p, state, draws):
            z = draws["z"]
            arg = (z[:, :, None] * p["fourier.freqs"][None]).sum(-1)
            x = torch.sin(2 * math.pi * (arg + p["fourier.phases"]))
            ema = state["to_img.magnitude_ema"]
            with torch.no_grad():
                ema.mul_(0.9).add_(0.1 * x.detach().pow(2).mean())
            y = F.linear(x * torch.rsqrt(ema), p["to_img.weight"],
                         p["to_img.bias"])
            return torch.sigmoid(y).reshape(-1, self.size, self.size, 3)

        def discriminator(self, p, state, x, staged=None, sg_linear=False):
            x = (x * 2.0 - 1.0).permute(0, 3, 1, 2)
            x = F.leaky_relu(F.conv2d(x, p["conv.weight"], p["conv.bias"],
                                      padding=1), 0.2)
            taps = state["down.filter"]
            x = fir(fir(F.pad(x, (1, 2, 1, 2)), taps, 2), taps, 3)
            feats = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            return heads(feats, p, state, staged, sg_linear)

        def blur_launches(self, batch):
            return [((batch, self.size, self.size, 3), (1, 1), 1,
                     {"plain": 1, "r1": 2})]

        def fused_act_launches(self, batch):
            return [((batch, self.size, self.size, self.width), "act",
                     {"plain": 1, "r1": 3})]

    return Toy


@pytest.fixture
def toy(monkeypatch):
    """The family ``toy``, importable under the family package's name
    though no file of the benchmark holds it."""
    module = types.ModuleType("benchmark.reference.families.toy")
    module.MODEL = _toy_class()
    monkeypatch.setitem(sys.modules, module.__name__, module)
    return module


def _toy_reference(step: str) -> dict:
    from benchmark.harness.spec import load_json

    ref = load_json(ROOT / "benchmark" / "configs" /
                    "sndcgan_c10_b512.json")["reference"]
    ref["model"] = {"family": "toy", "image_size": 8, "nz": 6,
                    "d_hidden": 16, "step": step}
    ref["recipe"].update(batch_size=4, warmup=0, lbd_r1=0.5, d_reg_every=2,
                         halflife_k=20, ema_start_k=0)
    return ref


def _digest(weights) -> str:
    h = hashlib.sha256()
    for part in ("generator", "discriminator"):
        for name, w in weights[part].items():
            h.update(name.encode())
            h.update(str(tuple(w.shape)).encode())
            h.update(w.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("step,kinds", [("critic", ("plain",)),
                                        ("ema_r1", ("plain", "r1"))])
def test_a_family_added_by_a_file_alone(toy, step, kinds):
    import torch

    from benchmark.counts import blur, fused_act
    from benchmark.counts.flops import step_flops
    from benchmark.reference.families import make_model
    from benchmark.reference.step import Trainer
    from benchmark.reference.weights import make_weights

    ref = _toy_reference(step)
    assert isinstance(make_model(ref["model"]), toy.MODEL)
    w = make_weights(ref["model"], 2**31 + 11, "cpu")
    assert _digest(w) == _digest(make_weights(ref["model"], 2**31 + 11,
                                              "cpu"))
    assert _digest(w) != _digest(make_weights(ref["model"], 12, "cpu"))
    freqs = w["generator"]["fourier.freqs"]
    assert float(freqs.norm(dim=1).max()) <= 2.0
    assert float(w["discriminator"]["down.filter"].sum()) == pytest.approx(1)

    trainer = Trainer(ref, w, 5, "cpu")
    assert trainer.kinds() == kinds
    assert set(trainer.g_state) == {"to_img.magnitude_ema"}
    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (4, 8, 8, 3), dtype=torch.uint8,
                           generator=g)
    for number, kind in zip((1, 2), kinds):  # R1 at every second step
        out = trainer.step(images, number)
        assert all(math.isfinite(float(v)) for v in out.values())
        assert (float(out.get("D_r1", 0.0)) > 0) == (kind == "r1")
    assert float(trainer.g_state["to_img.magnitude_ema"]) != 1.0
    assert torch.equal(trainer.d_state["down.filter"],
                       w["discriminator"]["down.filter"])
    assert not torch.equal(trainer.g["to_img.weight"],
                           w["generator"]["to_img.weight"])
    assert ("g_ema.to_img.weight" in trainer.leaves()) == (step == "ema_r1")

    for kind in kinds:
        assert step_flops(ref, kind) > 0
    with pytest.raises(ValueError):
        step_flops(ref, "r1" if step == "critic" else "other")
    model = ref["model"]
    assert [blur.step_launches(model, 4, k) for k in ("plain", "r1")] == [1, 2]
    assert blur.step_bytes(model, 4, "r1") == 2 * 4 * 4 * 3 * (64 + 49)
    assert [fused_act.step_launches(model, 4, k)
            for k in ("plain", "r1")] == [1, 3]
    assert fused_act.step_bytes(model, 4, "plain", 2) == 2 * (2 * 1024 + 4)


def test_made_entries_move_no_drawn_entry(toy, monkeypatch):
    """An entry the family makes draws from a stream of its own: the drawn
    entries are those of the same spec without it."""
    import torch

    from benchmark.reference.weights import make_weights

    class Plain(toy.MODEL):
        def g_spec(self):
            return [s for s in super().g_spec() if s[0].startswith("to_img")]

        def d_spec(self):
            return [s for s in super().d_spec() if s[0] != "down.filter"]

    plain = types.ModuleType("benchmark.reference.families.toy_plain")
    plain.MODEL = Plain
    monkeypatch.setitem(sys.modules, plain.__name__, plain)
    ref = _toy_reference("critic")["model"]
    got = make_weights(ref, 99, "cpu")
    want = make_weights(dict(ref, family="toy_plain"), 99, "cpu")
    for part in want:
        for name, w in want[part].items():
            assert torch.equal(got[part][name], w), name


def test_an_unknown_family_is_named():
    from benchmark.reference.families import make_model

    with pytest.raises(ValueError, match="no_such_family"):
        make_model({"family": "no_such_family"})


# ------------------------------------------------------------ pinned

# Each configuration's counts and weights as they were before the families
# moved into files (the FLOPs, the blur's bytes and launches, a SHA-256 of
# make_weights at seed 7 on the CPU), and the fused activation's table
# (launches as PERF.md's section 6 counts them a step).
PINS = {
    "sndcgan_c10_b512": {
        "flops": {"plain": 2970982285312.0},
        "blur": {"plain": (0, 0, 0), "r1": (0, 0, 0)},
        "fused_act": {"plain": (0, 0, 0), "r1": (0, 0, 0)},
        "weights": "7752aa39b2bb5301b8e71c60bf0b5d2aa614dbb4bb61f7a5ce0239d0446de93f"},
    "stylegan2_afhq512_b16": {
        "flops": {"plain": 8522545250304.0, "r1": 12199055654912.0},
        "blur": {"plain": (70, 37850673152, 18925336576),
                 "r1": (126, 54662475776, 27331237888)},
        "fused_act": {"plain": (189, 52560054784, 26280027392),
                      "r1": (285, 75686459136, 37843229568)},
        "weights": "53aa2512ea62c1bbe40e7a44593a9c477ba7bf8fe4521e68508e8f115fae9ce0"},
    "stylegan2_c10_b64": {
        "flops": {"r1": 1808483090432.0},
        "blur": {"plain": (30, 2130640896, 1065320448),
                 "r1": (54, 3072000000, 1536000000)},
        "fused_act": {"plain": (117, 3040999424, 1520499712),
                      "r1": (165, 4379016192, 2189508096)},
        "weights": "3482a9b469310497ec375e9d168f35415eb22ff24c468fb74034d8b99896b790"},
}


def _reference(name):
    from benchmark.harness.spec import load_json

    return load_json(ROOT / "benchmark" / "configs" / f"{name}.json")[
        "reference"]


@pytest.mark.parametrize("config,what", [(c, w) for c in sorted(PINS)
                                         for w in ("flops", "blur",
                                                   "fused_act", "weights")])
def test_pinned_counts_and_weights(config, what):
    from benchmark.counts import blur, fused_act
    from benchmark.counts.flops import step_flops
    from benchmark.reference.weights import make_weights

    ref = _reference(config)
    pin = PINS[config][what]
    model, batch = ref["model"], ref["recipe"]["batch_size"]
    if what == "flops":
        assert {k: step_flops(ref, k) for k in pin} == pin
    elif what == "weights":
        assert _digest(make_weights(model, 7, "cpu")) == pin
    else:
        table = {"blur": blur, "fused_act": fused_act}[what]
        for kind, (n, f32, bf16) in pin.items():
            assert (table.step_launches(model, batch, kind),
                    table.step_bytes(model, batch, kind),
                    table.step_bytes(model, batch, kind, 2)) == (n, f32, bf16)


def test_window_mean_of_the_fused_activation():
    """A 512x512 window of 80 steps holds 75 plain and 5 R1 steps: 195
    launches a step; every 32x32 step is an R1 step: 165."""
    from benchmark.counts.fused_act import step_launches

    ref = _reference("stylegan2_afhq512_b16")
    mean = (75 * step_launches(ref["model"], 16, "plain")
            + 5 * step_launches(ref["model"], 16, "r1")) / 80
    assert mean == 195.0


# ------------------------------------------------------------ no names

def test_no_family_name_outside_a_family_file():
    names = sorted(p.stem for p in FAMILIES.glob("*.py")
                   if p.stem != "__init__")
    assert {"sndcgan", "stylegan2"} <= set(names)
    quoted = re.compile(r"""["'](%s)["']""" % "|".join(names))
    seen = []
    for path in sorted((ROOT / "benchmark").rglob("*.py")):
        if FAMILIES in path.parents or "tests" in path.parts:
            continue
        seen.append(path.name)
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not quoted.search(line), f"{path}:{n}: {line.strip()}"
    assert {"step.py", "flops.py", "blur.py", "train.py"} <= set(seen)


# ------------------------------------------------------------ the program

RECIPES = {
    # the 512x512 recipe's lazy R1 at step 2
    "sg2_hq_lazy_r1": ("stylegan2_afhq512_b16", [[1], [2]], 2),
    # R1 every step
    "sg2_r1_every_step": ("stylegan2_c10_b64", [[1]], None),
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_fused_act_table_is_the_programs(recipe, traffic, monkeypatch):
    """The program's fused activation through its autograd Functions on
    the CPU (its plain op there bypasses them): every launch it would make
    a step, by shape and kind, is a row of the family's table."""
    import contrad_tpu_torch.models.stylegan2.layers as layers
    import contrad_tpu_torch.ops.fused_act as fa
    # the graph runner binds the real op's counters at its import: before
    # the patch, so that no later test finds the stand-in there
    import contrad_tpu_torch.training.graph  # noqa: F401

    from benchmark.counts import fused_act
    from benchmark.harness.train import Program

    seen = collections.Counter()
    act, grad = fa._act, fa._grad

    def counted_act(x, b, slope, gain):
        seen[(tuple(x.shape), "act")] += 1
        return act(x, b, slope, gain)

    def counted_grad(g, b, ref, slope, gain, want_db):
        seen[(tuple(ref.shape), "grad")] += 1
        seen[(tuple(ref.shape), "bias_sum")] += bool(want_db)
        return grad(g, b, ref, slope, gain, want_db)

    def through_functions(x, bias=None, negative_slope=0.2,
                          scale=math.sqrt(2.0)):
        return fa._Act.apply(x, bias, float(negative_slope), float(scale))

    monkeypatch.setattr(fa, "_act", counted_act)
    monkeypatch.setattr(fa, "_grad", counted_grad)
    monkeypatch.setattr(fa, "fused_leaky_relu", through_functions)
    monkeypatch.setattr(layers, "fused_leaky_relu", through_functions)
    name, blocks, every = RECIPES[recipe]
    cfg = tiny_config(name, 4, size=8)
    if every:
        cfg["program"]["argv"] += ["--d_reg_every", str(every)]
        cfg["reference"]["recipe"]["d_reg_every"] = every
    prog = Program(cfg, traffic, 5, "cpu")
    for block in blocks:
        seen.clear()
        prog.run_block(block)
        kind = prog.kinds(block)[0]
        want = collections.Counter()
        for shape, op, per in fused_act.launches(cfg["reference"]["model"],
                                                 4):
            want[(tuple(shape), op)] += per[kind]
        assert +seen == +want, kind
