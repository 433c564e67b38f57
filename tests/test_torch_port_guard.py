"""Guards of the PyTorch port.

* It stands alone: no module of ``contrad_tpu_torch/``, and not
  ``chip_smoke.py``, imports ``jax``, ``flax``, ``optax``, anything of
  ``contrad_tpu``, or ``third_party`` (whose torch InceptionV3 the port
  keeps a copy of) (an AST scan of every file, dynamic imports included);
  and no shell script of the port calls the JAX CLIs, the JAX package's
  ``tools/`` or a ``contrad_tpu.`` module (a scan of its commands).
* Its entry points run on the card: without one they raise, unless the
  caller asks for ``device="cpu"``; the blur runs its plain version for CPU
  tensors only and refuses any other device.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "contrad_tpu", "third_party"}


def _port_files():
    return sorted((ROOT / "contrad_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def imported_roots(source: str):
    """Top-level package of every import in ``source``: ``import a.b``,
    ``from a.b import c``, ``__import__("a")`` and
    ``importlib.import_module("a")``."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Name)
                    and node.func.id == "__import__")
                   or (isinstance(node.func, ast.Attribute)
                       and node.func.attr == "import_module"))):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    found = FORBIDDEN.intersection(imported_roots(path.read_text()))
    assert not found, f"{path.relative_to(ROOT)} imports {sorted(found)}"


@pytest.mark.parametrize("source,found", [
    ("import jax.numpy as jnp", {"jax"}),
    ("from flax import linen", {"flax"}),
    ("import os, optax", {"optax"}),
    ("from contrad_tpu.ops import blur", {"contrad_tpu"}),
    ("def f():\n    import contrad_tpu.config", {"contrad_tpu"}),
    ("import importlib\nm = importlib.import_module('jax')", {"jax"}),
    ("m = __import__('contrad_tpu.data')", {"contrad_tpu"}),
    ("from third_party.torch_fid import get_embed_fn", {"third_party"}),
    ("from contrad_tpu_torch.ops import blur", set()),
    ("from . import blur", set()),
])
def test_the_scan_finds_each_form_of_import(source, found):
    assert FORBIDDEN.intersection(imported_roots(source)) == found


# a python run that is not a port module; the JAX package's tools/; a
# module of the JAX package
SHELL_FORBIDDEN = re.compile(
    r"\bpython3?\s+(?!-m\s+contrad_tpu_torch\.)|(^|[\s\"'=(])\.?/?tools/"
    r"|\bcontrad_tpu\.")


def forbidden_shell_calls(source: str):
    """The command lines of a shell script (comments dropped) that run
    something of the JAX side."""
    for line in source.splitlines():
        command = re.sub(r"(^|\s)#.*$", "", line)
        if SHELL_FORBIDDEN.search(command):
            yield line.strip()


@pytest.mark.parametrize("path", sorted(
    (ROOT / "contrad_tpu_torch").rglob("*.sh")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_scripts_call_only_the_port(path):
    assert not list(forbidden_shell_calls(path.read_text()))


@pytest.mark.parametrize("line,found", [
    ("python train_gan.py configs/x.toml sndcgan", True),
    ("python tools/precalc_stats.py --dataset cifar10", True),
    ("python3 test_gan_sample.py logs/run sndcgan", True),
    ("bash tools/quality_run.sh", True),
    ("X=$(python -m contrad_tpu.evaluate.fid cifar10)", True),
    ("    python -m contrad_tpu.tools.precalc_stats --dataset x", True),
    ("python -m contrad_tpu_torch.train_gan configs/x.toml sndcgan", False),
    ("python -m contrad_tpu_torch.tools.precalc_stats --dataset x", False),
    ("# python train_gan.py, as the JAX runbook calls it", False),
    ("cd \"$(dirname \"$0\")/../..\"  # python tools/x.py", False),
])
def test_the_shell_scan_finds_each_call(line, found):
    assert bool(list(forbidden_shell_calls(line))) == found


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_needs_a_card_unless_asked_for_the_cpu(no_card):
    from contrad_tpu_torch import resolve_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_get_architecture_defaults_to_the_card(no_card):
    from contrad_tpu_torch.models import get_architecture

    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_architecture("stylegan2_tiny", (8, 8, 3))
    G, D = get_architecture("stylegan2_tiny", (8, 8, 3), device="cpu")
    assert next(G.parameters()).device.type == "cpu"
    assert next(D.parameters()).device.type == "cpu"


def test_batch_stream_defaults_to_the_card(no_card):
    from contrad_tpu_torch.data import ArrayDataset, DeviceBatchIterator

    data = ArrayDataset(np.zeros((4, 8, 8, 3), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceBatchIterator(data, 2)
    batch = next(DeviceBatchIterator(data, 2, device="cpu"))
    assert batch.shape == (2, 8, 8, 3) and batch.device.type == "cpu"


def test_trainer_cli_defaults_to_the_card(no_card):
    from contrad_tpu_torch.train_stylegan2 import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["configs/gan/stylegan2/c10_style64.toml", "stylegan2_tiny",
              "--override", "options.dataset=synthetic_8_16",
              "options.max_steps=1"])


def test_contrad_cli_defaults_to_the_card(no_card):
    from contrad_tpu_torch.train_stylegan2_contraD import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["configs/gan/stylegan2/afhq_dog_style64.toml", "stylegan2_tiny",
              "--override", "options.dataset=synthetic_8_16",
              "options.max_steps=1"])


def test_gan_cli_defaults_to_the_card(no_card):
    from contrad_tpu_torch.models import get_architecture
    from contrad_tpu_torch.train_gan import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["configs/gan/cifar10/c10_b64.toml", "sndcgan",
              "--override", "options.dataset=synthetic_8_16",
              "options.max_steps=1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_architecture("sndcgan", (8, 8, 3))


def test_blur_refuses_devices_other_than_cuda_and_cpu():
    from contrad_tpu_torch.ops.blur import blur2d

    before = blur2d.launches
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        blur2d(torch.zeros(1, 4, 4, 2, device="meta"), (0.5, 0.5),
               (0.5, 0.5), (0, 1))
    assert blur2d.launches == before


@pytest.mark.parametrize("cli,argv", [
    ("test_gan_sample", ["logs/none", "sndcgan"]),
    ("test_lineval", ["logs/none", "sndcgan"]),
    ("test_gan_sample_cddls", ["logs/none", "logs/none/lin.npz", "sndcgan"]),
    ("test_fid_is", ["logs/none", "--dataset", "cifar10"]),
    ("test_tf_inception", ["logs/none", "logs/none/stats.npz"]),
    ("evaluate.fid", ["cifar10"]),
    ("tools.precalc_stats", ["--dataset", "cifar10"]),
    ("tools.precalc_stats", ["--images", "logs/none", "--embed", "moments"]),
])
def test_evaluation_clis_default_to_the_card(no_card, cli, argv):
    import importlib

    main = importlib.import_module(f"contrad_tpu_torch.{cli}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_load_run_defaults_to_the_card(no_card):
    from contrad_tpu_torch.utils.run_loading import load_run

    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_run("logs/none", "sndcgan")
    with pytest.raises(FileNotFoundError, match="config.toml"):
        load_run("logs/none", "sndcgan", device="cpu")


def test_inception_and_its_embedders_default_to_the_card(no_card):
    from contrad_tpu_torch.evaluate.fid import get_embed_fn
    from contrad_tpu_torch.evaluate.inception import (
        get_inception_embed_fn, get_inception_logits_fn, load_inception)
    from contrad_tpu_torch.evaluate.inception_score import inception_score

    for call in (load_inception, get_inception_embed_fn,
                 get_inception_logits_fn, lambda: get_embed_fn("inception"),
                 lambda: inception_score(np.zeros((2, 8, 8, 3), np.uint8))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
