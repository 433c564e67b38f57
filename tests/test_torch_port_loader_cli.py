"""The train CLIs on the host-fed data path, on the CPU: with
``DeviceBatchIterator.MAX_BYTES`` patched below the set's bytes,
``make_train_loader`` streams the set through ``PrefetchIterator`` and the
train loop runs ``"batch"`` blocks (``utils/run.py::train``,
``training/graph.py::BlockRunner.run``), one eager step each (K = 1, as
the JAX CLIs resolve it for a loader without index vectors).

  * ``train_stylegan2 ... stylegan2_tiny`` (lazy R1 every 2 steps) host-fed
    writes the device-resident run's checkpoint bit for bit, that run
    taking blocks of 2 steps; ``--resume`` of a host-fed run continues it
    bit for bit;
  * ``train_gan --conditional``: the host-fed path hands the real labels to
    the D, bitwise the device-resident run;
  * ``--no_packed_aug``, the JAX StyleGAN2 CLI's switch to the unpacked
    path, is accepted, logged, and changes nothing.

``stylegan2_tiny`` runs at 16 channels a layer, as in
``tests/test_torch_port_dispatch_cli.py``.
"""

import importlib
import os

import pytest

import contrad_tpu_torch.models.stylegan2.discriminator as sg2_d
import contrad_tpu_torch.models.stylegan2.generator as sg2_g
from contrad_tpu_torch.data import DeviceBatchIterator
from contrad_tpu_torch.utils.checkpoint import restore_checkpoint
from test_torch_port_checkpoint import assert_bitwise
from torch_port_jax import one_torch_thread  # noqa: F401  (autouse)

LIMIT = DeviceBatchIterator.MAX_BYTES
RUNS = {
    "train_stylegan2": ["configs/gan/stylegan2/c10_style64.toml",
                        "stylegan2_tiny", "--mode", "contrad", "--aug",
                        "simclr", "--lbd_r1", "0.1", "--d_reg_every", "2",
                        "--halflife_k", "1", "--ema_start_k", "0",
                        "--use_warmup", "--print_every", "2",
                        "--evaluate_every", "2", "--no_fid", "--device",
                        "cpu", "--override", "options.dataset=synthetic_8_256",
                        "options.batch_size=4"],
    "train_gan": ["configs/gan/cifar10/c10_b64.toml", "sndcgan", "--mode",
                  "contrad", "--aug", "simclr", "--use_warmup",
                  "--conditional", "--print_every", "1", "--evaluate_every",
                  "2", "--no_fid", "--device", "cpu", "--override",
                  "options.dataset=synthetic_16_256", "options.batch_size=4"],
}


@pytest.fixture(autouse=True)
def narrow_stylegan2(monkeypatch):
    for module in (sg2_g, sg2_d):
        monkeypatch.setattr(module, "stylegan2_channels",
                            lambda *a, **kw: {4: 16, 8: 16, 16: 16, 32: 16})


def _run(cli, root, steps, *flags, host_fed=False, monkeypatch=None):
    # host-fed: a limit below the 49,152 bytes of synthetic_8_256
    monkeypatch.setattr(DeviceBatchIterator, "MAX_BYTES",
                        4096 if host_fed else LIMIT)
    main = importlib.import_module(f"contrad_tpu_torch.{cli}").main
    argv = RUNS[cli]
    at = argv.index("--override")
    return main(argv[:at] + list(flags) + ["--logdir_root", str(root)]
                + argv[at:] + [f"options.max_steps={steps}"])


def _log(history):
    with open(os.path.join(history.logdir, "log.txt")) as f:
        return f.read()


def test_stylegan2_host_fed_run_and_resume_are_bitwise(tmp_path,
                                                       monkeypatch):
    cli = "train_stylegan2"
    resident = _run(cli, tmp_path / "a", 4, monkeypatch=monkeypatch)
    fed = _run(cli, tmp_path / "b", 4, host_fed=True, monkeypatch=monkeypatch)
    first = _run(cli, tmp_path / "c", 2, host_fed=True,
                 monkeypatch=monkeypatch)
    resumed = _run(cli, tmp_path / "c", 4, "--resume", first.logdir,
                   host_fed=True, monkeypatch=monkeypatch)
    assert resident.dispatch["k"] == 2 and resident.data["path"] == (
        "device-resident")
    assert fed.dispatch["k"] == resumed.dispatch["k"] == 1
    assert fed.data["path"] == "host-fed"
    assert fed.data["stats"]["batches"] == 4
    assert "Data path: host-fed (PrefetchIterator)" in _log(fed)
    assert [r["step"] for r in resumed] == [4]
    assert all(r["D_r1"] > 0 for r in fed)  # the printed steps carry R1
    want = restore_checkpoint(resident.logdir)
    assert want["data"] == {"epoch": 0, "pos": 16, "started": True}
    assert_bitwise(restore_checkpoint(fed.logdir), want)
    assert_bitwise(restore_checkpoint(first.logdir), want)  # resumed in place
    for a, b in zip(resident, fed, strict=True):
        assert dict(a, seconds_per_step=0) == dict(b, seconds_per_step=0)


def test_conditional_gan_host_fed_is_bitwise(tmp_path, monkeypatch):
    resident = _run("train_gan", tmp_path / "a", 2, monkeypatch=monkeypatch)
    fed = _run("train_gan", tmp_path / "b", 2, host_fed=True,
               monkeypatch=monkeypatch)
    assert fed.data["path"] == "host-fed" and fed.dispatch["k"] == 1
    assert_bitwise(restore_checkpoint(fed.logdir),
                   restore_checkpoint(resident.logdir))


def test_no_packed_aug_is_accepted_and_changes_nothing(tmp_path,
                                                       monkeypatch):
    plain = _run("train_stylegan2", tmp_path / "a", 2,
                 monkeypatch=monkeypatch)
    flagged = _run("train_stylegan2", tmp_path / "b", 2, "--no_packed_aug",
                   monkeypatch=monkeypatch)
    assert "--no_packed_aug: the port trains on unpacked NHWC" in _log(
        flagged)
    assert "--no_packed_aug:" not in _log(plain)
    assert_bitwise(restore_checkpoint(flagged.logdir),
                   restore_checkpoint(plain.logdir))
