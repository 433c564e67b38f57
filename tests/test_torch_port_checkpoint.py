"""Checkpoints and resume of the port (``contrad_tpu_torch/utils/
checkpoint.py``, ``utils/run.py``, the train CLIs' ``--evaluate_every``,
``--save_every``, ``--resume`` and ``--finetune``), on the CPU:

* a checkpoint restores every tensor bitwise (parameters, buffers, Adam's
  moments, the random streams) and the data stream's position;
* ``find_restorable`` skips an interrupted write's temporary, picks the
  newest completed file, lets ``latest`` win a tie, finds nothing where
  there is nothing, and a write that fails leaves the previous file whole;
* resume equivalence: 4 steps in one run against 2 steps, a checkpoint, a
  disturbed process state, ``--resume`` and 2 more, bitwise equal in every
  tensor of the final checkpoint (G, D, EMA, ``u``, batch-norm statistics,
  Adam's moments and count, the random streams, the data position), for
  ``train_gan --conditional`` and ``train_stylegan2``;
* ``--finetune`` takes D's backbone, projections and ``u`` from the other
  run and keeps this run's fresh GAN-head parameters, G untouched."""

import os

import numpy as np
import pytest
import torch

from contrad_tpu_torch.utils.checkpoint import (
    ckpt_path, find_restorable, has_checkpoint, latest_step,
    restore_checkpoint, save_checkpoint)
from torch_port_jax import one_torch_thread  # noqa: F401  (autouse)

GAN = ["configs/gan/cifar10/c10_b64.toml", "sndcgan", "--mode", "contrad",
       "--aug", "simclr", "--use_warmup", "--conditional", "--device", "cpu",
       "--print_every", "1", "--evaluate_every", "2", "--save_every", "4",
       "--override", "options.dataset=synthetic_16_256",
       "options.batch_size=4"]
SG2 = ["configs/gan/stylegan2/c10_style64.toml", "stylegan2_tiny", "--mode",
       "contrad", "--aug", "simclr", "--lbd_r1", "0.1", "--d_reg_every", "2",
       "--halflife_k", "1", "--ema_start_k", "0", "--use_warmup", "--device",
       "cpu", "--print_every", "1", "--evaluate_every", "2", "--override",
       "options.dataset=synthetic_8_256", "options.batch_size=4"]


def _flat(tree, prefix=""):
    """Every leaf of a checkpoint's nested dicts and lists, by path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def assert_bitwise(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k, va in fa.items():
        vb = fb[k]
        if isinstance(va, torch.Tensor):
            assert va.dtype == vb.dtype and torch.equal(va, vb), k
        else:
            assert va == vb, k


def _steps(history):
    return [r["step"] for r in history]


def test_round_trip_restores_every_tensor_bitwise(tmp_path):
    from contrad_tpu_torch.train_gan import build, parse_args

    P = parse_args(GAN[:-2] + ["options.dataset=synthetic_16_256",
                               "options.batch_size=4"])
    _, loader, trainer = build(P)
    images, labels = next(loader)
    trainer.train_step(images, labels=labels)
    state = dict(trainer.state_dict(), step=1, data=loader.state_dict(),
                 meta={"n_classes": trainer.n_classes})
    save_checkpoint(str(tmp_path), state, "latest")
    back = restore_checkpoint(str(tmp_path))
    assert_bitwise(state, back)
    assert len(_flat(back["d_optimizer"])) > 3 * len(
        list(trainer.discriminator.parameters()))  # both moments and steps

    _, loader2, fresh = build(P)
    fresh.load_state_dict(back)
    loader2.load_state_dict(back["data"])
    assert_bitwise(dict(fresh.state_dict(), data=loader2.state_dict()),
                   dict(trainer.state_dict(), data=loader.state_dict()))
    # the restored stream continues where the saved one was
    for got, want in zip(next(loader2), next(loader)):
        assert torch.equal(got, want)
    assert has_checkpoint(str(tmp_path)) and latest_step(str(tmp_path)) == 1


def test_find_restorable_skips_temporaries_and_prefers_latest(tmp_path):
    logdir = str(tmp_path)
    assert find_restorable(logdir) is None  # no ckpt directory
    os.makedirs(os.path.join(logdir, "ckpt"))
    assert find_restorable(logdir) is None  # an empty one
    save_checkpoint(logdir, {"step": 2}, "step_2")
    # a write killed midway leaves only a temporary, the newest file
    stale = ckpt_path(logdir, "latest") + ".4242.tmp"
    with open(stale, "wb") as f:
        f.write(b"\x80truncated")
    os.utime(ckpt_path(logdir, "step_2"), (100, 100))
    assert find_restorable(logdir) == "step_2"
    save_checkpoint(logdir, {"step": 4}, "step_4")
    save_checkpoint(logdir, {"step": 4}, "latest")
    for name in ("step_4", "latest"):
        os.utime(ckpt_path(logdir, name), (200, 200))
    assert find_restorable(logdir) == "latest"  # latest wins the tie
    os.utime(ckpt_path(logdir, "step_4"), (300, 300))
    assert find_restorable(logdir) == "step_4"  # else the newest


def test_a_failed_write_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    logdir = str(tmp_path)
    save_checkpoint(logdir, {"step": 1, "x": torch.arange(3)})

    def dies_midway(obj, path):
        with open(path, "wb") as f:
            f.write(b"\x80partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", dies_midway)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(logdir, {"step": 2, "x": torch.arange(5)})
    assert restore_checkpoint(logdir)["step"] == 1
    assert find_restorable(logdir) == "latest"


@pytest.mark.parametrize("cli,argv", [("train_gan", GAN),
                                      ("train_stylegan2", SG2)])
def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path, cli, argv):
    import importlib

    main = importlib.import_module(f"contrad_tpu_torch.{cli}").main
    root = ["--logdir_root", str(tmp_path)]
    straight = main(argv + ["options.max_steps=4"] + root)
    first = main(argv + ["options.max_steps=2"] + root)
    assert _steps(straight) == [1, 2, 3, 4] and _steps(first) == [1, 2]
    # disturb every global stream before the resumed run
    torch.manual_seed(1234)
    np.random.seed(1234)
    resumed = main(argv + ["options.max_steps=4", "--resume",
                           first.logdir] + root)
    assert _steps(resumed) == [3, 4] and resumed.logdir == first.logdir
    for a, b in zip(straight[2:], resumed):
        assert a == dict(b, seconds_per_step=a["seconds_per_step"])
    want = restore_checkpoint(straight.logdir)
    got = restore_checkpoint(first.logdir)
    assert want["step"] == got["step"] == 4
    assert_bitwise(want, got)
    if cli == "train_gan":
        assert [s["name"] for s in straight.saves] == [
            "latest", "latest", "step_4"]
        assert "linear.linear_y.u" in got["discriminator"]
        assert got["meta"]["n_classes"] == 10
    else:
        assert got["g_ema"] is not None
    assert open(os.path.join(first.logdir, "log.txt")).read().count(
        "Checkpoint loaded from") == 1


def test_finetune_keeps_d_but_its_gan_head(tmp_path):
    from contrad_tpu_torch.train_gan import build, main, parse_args
    from contrad_tpu_torch.utils.logger import Logger
    from contrad_tpu_torch.utils.run import restore

    base = main(GAN + ["options.max_steps=2", "--logdir_root",
                       str(tmp_path)])
    P = parse_args(GAN + ["options.max_steps=2", "--seed", "5",
                          "--finetune", base.logdir])
    _, loader, trainer = build(P)
    fresh_g = {k: v.clone() for k, v in trainer.generator.state_dict().items()}
    fresh_d = {k: v.clone()
               for k, v in trainer.discriminator.state_dict().items()}
    assert restore(P, trainer, loader, Logger("ft", root=str(tmp_path))) == 1
    loaded = restore_checkpoint(base.logdir)["discriminator"]
    params = dict(trainer.discriminator.named_parameters())
    for k, v in trainer.discriminator.state_dict().items():
        if k.startswith("linear.") and k in params:
            assert torch.equal(v, fresh_d[k]), k  # the GAN head re-initialised
        else:
            assert torch.equal(v, loaded[k]), k  # backbone, projections, u
    assert any(not torch.equal(fresh_d[k], loaded[k]) for k in params
               if k.startswith("backbone."))
    for k, v in trainer.generator.state_dict().items():
        assert torch.equal(v, fresh_g[k]), k
