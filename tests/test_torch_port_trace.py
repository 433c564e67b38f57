"""The train step's phases and the loop's spans (``contrad_tpu_torch/utils/
trace.py``), on the CPU, where a phase marks nothing on the device:

  * under a CPU ``torch.profiler``, one eager step of a tiny ``GANTrainer``
    with two D updates, and of a tiny ``StyleGAN2Trainer`` with and without
    R1, spans exactly the phases the step runs, in order (``aug`` once per
    outermost augment application);
  * with no profiler running, a step, a block and a span open nothing: the
    profiler's record functions are made to raise;
  * every mark's kernel name falls in no kernel class of the benchmark
    (``benchmark/harness/trace.py::kernel_class``), so the class metrics do
    not move, and ``csrc/marks.cu`` defines the marks of ``PHASES`` in order;
  * the shared nvcc build (``ops/nvcc.py``, the blur's and the marks'): a
    library whose source hash is built already is loaded without a compile,
    and a compile that fails raises.
"""

import ctypes
import hashlib
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import contrad_tpu_torch.models.stylegan2.discriminator as sg2_d
import contrad_tpu_torch.models.stylegan2.generator as sg2_g
from contrad_tpu_torch import train_gan, train_stylegan2
from contrad_tpu_torch.data import native
from contrad_tpu_torch.ops import nvcc
from contrad_tpu_torch.training.graph import BlockRunner
from contrad_tpu_torch.utils import trace
from contrad_tpu_torch.utils.trace import PHASES, mark_name
from torch_port_jax import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
GAN = ["configs/gan/cifar10/c10_b64.toml", "sndcgan", "--mode", "contrad",
       "--aug", "simclr"]
SG2 = ["configs/gan/stylegan2/c10_style64.toml", "stylegan2_tiny", "--mode",
       "contrad", "--aug", "simclr", "--lbd_r1", "0.1"]
# each D update: its augment, then its Adam update
D_UPDATE = ["d", "aug", "update"]
SPANS = {
    "gan_n_critic_2": (["step"] + 2 * D_UPDATE
                       + ["g", "aug", "update"]),
    "stylegan2": ["step", "update", "g", "aug", "update"] + D_UPDATE,
    "stylegan2_r1": ["step", "update", "g", "aug", "update", "d", "aug",
                     "r1", "aug", "update"],
}


@pytest.fixture(autouse=True)
def narrow_stylegan2(monkeypatch):
    for module in (sg2_g, sg2_d):
        monkeypatch.setattr(module, "stylegan2_channels",
                            lambda *a, **kw: {4: 16, 8: 16, 16: 16, 32: 16})


def _build(case):
    gan = case.startswith("gan")
    cli = train_gan if gan else train_stylegan2
    P = cli.parse_args((GAN if gan else SG2) + [
        "--device", "cpu", "--override", "options.dataset=synthetic_16_64",
        "options.batch_size=4"] + (["options.n_critic=2"] if gan else []))
    _, loader, trainer = cli.build(P)
    return loader, trainer


def _step(loader, trainer, case):
    kw = {"do_r1": True} if case == "stylegan2_r1" else {}
    images = loader.materialize(loader.next_indices()[0])
    return trainer.train_step(images, ema_decay=0.5, **kw)


def _spans(prof):
    events = sorted((e for e in prof.events()
                     if e.name.startswith("contrad.")),
                    key=lambda e: e.time_range.start)
    return [e.name[len("contrad."):] for e in events]


@pytest.mark.parametrize("case", list(SPANS))
def test_a_step_spans_its_phases_in_order(case):
    loader, trainer = _build(case)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        metrics = _step(loader, trainer, case)
    assert _spans(prof) == SPANS[case]
    assert all(torch.isfinite(v) for v in metrics.values())
    # nested: every phase lies inside the step
    step = [e for e in prof.events() if e.name == "contrad.step"][0]
    for e in prof.events():
        if e.name.startswith("contrad."):
            assert step.time_range.start <= e.time_range.start
            assert e.time_range.end <= step.time_range.end


def test_no_profiler_opens_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler op with no profiler running")

    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    loader, trainer = _build("stylegan2_r1")
    _step(loader, trainer, "stylegan2_r1")
    BlockRunner(trainer, loader).run(
        [loader.next_indices()[0] for _ in range(2)], do_r1=[False, True])
    with trace.span("contrad.loop.read", step=1):
        pass
    with pytest.raises(AssertionError, match="a profiler op"):
        with profile(activities=[ProfilerActivity.CPU]):
            _step(loader, trainer, "stylegan2")


@pytest.mark.parametrize("name", [mark_name(p, e) for p in PHASES
                                  for e in ("begin", "end")])
def test_mark_names_fall_in_no_kernel_class(name):
    from benchmark.harness.trace import kernel_class

    assert kernel_class(name) == "other"


def test_marks_source_defines_the_phases_in_order():
    source = (ROOT / "contrad_tpu_torch" / "csrc" / "marks.cu").read_text()
    listed = re.search(r"#define CONTRAD_PHASES\(X\) (.*)", source).group(1)
    assert tuple(re.findall(r"X\((\w+)\)", listed)) == PHASES


def _fake_nvcc(monkeypatch, tmp_path, compiler):
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(nvcc.shutil, "which", lambda name: compiler)


def test_a_built_source_hash_loads_without_a_compile(monkeypatch, tmp_path):
    source = tmp_path / "lib.cu"
    source.write_text("// built already\n")
    _fake_nvcc(monkeypatch, tmp_path, "/nonexistent/nvcc")
    digest = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
    nvcc.BUILD_DIR.mkdir()
    # in its place, a shared library with a known symbol
    shutil.copy(native.build()._name, nvcc.BUILD_DIR / f"liblib_{digest}.so")
    lib = nvcc.build(source, {"shuffled_indices": (
        [ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p], None)})
    out = np.empty(5, np.int64)
    lib.shuffled_indices(5, 7, out.ctypes.data)
    assert sorted(out) == list(range(5))


def test_a_failed_nvcc_build_raises(monkeypatch, tmp_path):
    _fake_nvcc(monkeypatch, tmp_path, shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        nvcc.build(ROOT / "contrad_tpu_torch" / "csrc" / "marks.cu", {})
    assert not list(nvcc.BUILD_DIR.glob("*.so"))
