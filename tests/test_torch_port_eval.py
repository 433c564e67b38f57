"""The port's evaluation pieces against the JAX package's:

* ``evaluate/classifier.py``: ``accuracy``, ``error_k``, ``cross_entropy``
  and ``test_classifier`` (loss, error@1, adv@1, noisy@1) on the same
  logits as ``contrad_tpu.evaluate.classifier``;
* one step of the linear probe of ``test_lineval`` (eval-mode penultimate
  features of D on RRC(0.2, 1) + flip augmented images, the linear layer,
  cross-entropy, SGD at lr 0.1) against the same computation written with
  the JAX package's ``make_d_apply`` and optax, as the JAX CLI's
  ``train_step`` (``test_lineval.py:116-131``) writes it, on the SNDCGAN
  pair of ``tests/test_torch_port_sndcgan.py`` (float64) with the same
  augmentation draws; the probe dataset derivation;
* ``evaluate/visual.py``: the PNG writer read back with pillow, and
  ``to_uint8`` / ``make_grid`` against the JAX package's.

Tolerances: losses and gradients rtol 1e-3 / atol 1e-5; features and the
probe after its update rtol 1e-4 / atol 1e-6; the metrics to 1e-9."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from contrad_tpu.augment import compose, horizontal_flip, random_resize_crop
from contrad_tpu.evaluate import classifier as jax_classifier
from contrad_tpu.evaluate import visual as jax_visual
from contrad_tpu.training.step import make_d_apply
from contrad_tpu_torch.evaluate import classifier, visual
from contrad_tpu_torch.test_lineval import lin_augment, probe_dataset, probe_step
from test_torch_port_sndcgan import IMG, build_sndcgan_pair
from torch_port_jax import (  # noqa: F401  (one_torch_thread is autouse)
    jax_flip_params, jax_rrc_params, one_torch_thread, t)

GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)


def _logits(seed, n=37, k=10):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, k)).astype(np.float32)
    logits[3, :] = 0.0  # a tie: the first class wins in both
    return logits, rng.integers(0, k, size=n)


def test_accuracy_and_cross_entropy_match_jax():
    logits, labels = _logits(0)
    for k in ((1,), (1, 5), (3,)):
        np.testing.assert_allclose(
            classifier.accuracy(torch.from_numpy(logits),
                                torch.from_numpy(labels), topk=k),
            jax_classifier.accuracy(logits, labels, topk=k), rtol=1e-12)
        np.testing.assert_allclose(classifier.error_k(logits, labels, ks=k),
                                   jax_classifier.error_k(logits, labels, ks=k),
                                   rtol=1e-12)
    assert classifier.cross_entropy(torch.from_numpy(logits), labels) == \
        pytest.approx(jax_classifier.cross_entropy(logits, labels), rel=1e-12)


def test_test_classifier_matches_jax():
    batches = [_logits(s, n) for s, n in ((1, 16), (2, 16), (3, 5))]
    metrics = ["loss", "error@1", "adv@1", "noisy@1"]
    want = jax_classifier.test_classifier(lambda x: x, iter(batches), metrics)
    got = classifier.test_classifier(
        lambda x: x, ((torch.from_numpy(a), b) for a, b in batches), metrics)
    assert got.keys() == want.keys()
    for k in metrics:
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-9), k


def test_probe_step_matches_jax():
    _, D, _, d_vars, port = build_sndcgan_pair(seed=2)
    n, n_classes = 8, 10
    rng = np.random.default_rng(5)
    images = rng.uniform(size=(n,) + IMG)
    labels = rng.integers(0, n_classes, size=n)
    d_penul = 8 * 16 * (IMG[0] // 8) ** 2
    w0 = rng.normal(scale=0.1, size=(d_penul, n_classes))
    b0 = rng.normal(scale=0.1, size=(n_classes,))
    key = jax.random.PRNGKey(11)
    with jax.enable_x64(True):
        d_apply = make_d_apply(D)
        lin_aug = compose(random_resize_crop(scale=(0.2, 1.0)),
                          horizontal_flip())
        tx = optax.sgd(0.1)

        def train_step(probe, opt_state, x, labels, rng):
            x = lin_aug(rng, x)
            (_, aux), _ = d_apply(d_vars["params"],
                                  {"spectral": d_vars["spectral"]}, x,
                                  train=False)
            feats = jax.lax.stop_gradient(aux["penultimate"])

            def loss_fn(p):
                logits = feats @ p["w"] + p["b"]
                loss = optax.softmax_cross_entropy_with_integer_labels(
                    logits, labels).mean()
                return loss, logits

            (loss, logits), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(probe)
            updates, opt_state = tx.update(grads, opt_state, probe)
            return optax.apply_updates(probe, updates), loss, logits

        probe = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
        new, loss, logits = jax.jit(train_step)(
            probe, tx.init(probe), jnp.asarray(images), jnp.asarray(labels),
            key)
        params = [jax_rrc_params(jax.random.fold_in(key, 0), n, *IMG[:2]),
                  jax_flip_params(jax.random.fold_in(key, 1), n)]
    _, pd = port()
    p_probe = {"w": t(w0), "b": t(b0)}
    p_loss, p_logits = probe_step(pd, p_probe, t(images),
                                  torch.from_numpy(labels), lin_augment(),
                                  params, 0.1)
    np.testing.assert_allclose(float(p_loss), float(loss), **GRAD_TOL)
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(logits),
                               **GRAD_TOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(p_probe[k].numpy(), np.asarray(new[k]),
                                   **STATE_TOL, err_msg=k)
    assert not np.allclose(p_probe["w"].numpy(), w0)


@pytest.mark.parametrize("base,want", [
    ("cifar10", "cifar10_lin"), ("cifar10_hflip", "cifar10_lin"),
    ("cifar100", "cifar100_lin"), ("cifar100_hflip", "cifar100_lin"),
    ("synthetic_32_10000", "synthetic_32_10000")])
def test_probe_dataset_is_the_jax_clis(base, want):
    from contrad_tpu_torch.data import get_image_size

    assert probe_dataset(base) == want
    assert get_image_size(want) == (32, 32, 3)
    with pytest.raises(NotImplementedError):
        probe_dataset("afhq_dog")


@pytest.mark.parametrize("shape", [(7, 5, 3), (4, 9, 1), (3, 6)])
def test_png_writer_reads_back_with_pillow(tmp_path, shape):
    image = np.random.default_rng(1).integers(0, 256, size=shape,
                                              dtype=np.uint8)
    path = str(tmp_path / "x.png")
    visual.write_png(path, image)
    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(back.reshape(image.shape), image)
    assert Image.open(io.BytesIO(visual.encode_png(image))).size == (
        shape[1], shape[0])


def test_to_uint8_and_make_grid_match_jax():
    x = np.random.default_rng(2).uniform(-0.2, 1.2, size=(5, 4, 3, 3))
    got = visual.to_uint8(torch.from_numpy(x))
    np.testing.assert_array_equal(got, jax_visual.to_uint8(x))
    np.testing.assert_array_equal(visual.make_grid(got, nrow=2),
                                  jax_visual.make_grid(got, nrow=2))


def _write_cifar10(root):
    import os
    import pickle

    rng = np.random.default_rng(4)
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3072), np.uint8),
                         b"labels": list(rng.integers(0, 10, 3))}, f)


def test_lin_datasets_flag_the_probe_augmentation(tmp_path):
    """``cifar10_lin`` as the JAX registry gives it (images, labels,
    ``train_aug == "lin"``); ``cifar100_lin`` loads CIFAR-100, as the
    port's ``cifar100`` does (the JAX registry sends it to the CIFAR-10
    loader, ``ROADMAP.md`` section 4)."""
    from contrad_tpu.data import get_dataset as jax_get_dataset
    from contrad_tpu.data.cifar import load_cifar100 as jax_load_cifar100
    from contrad_tpu_torch.data import get_dataset
    from test_torch_port_datasets import _write_cifar100

    _write_cifar10(str(tmp_path))
    train, test, size = get_dataset("cifar10_lin", str(tmp_path))
    j_train, j_test, j_size = jax_get_dataset("cifar10_lin", str(tmp_path))
    assert size == j_size and train.train_aug == j_train.train_aug == "lin"
    for a, b in ((train, j_train), (test, j_test)):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    _write_cifar100(str(tmp_path))
    train, _, _ = get_dataset("cifar100_lin", str(tmp_path))
    j_train, _ = jax_load_cifar100(str(tmp_path))
    assert train.train_aug == "lin" and train.n_classes == 100
    np.testing.assert_array_equal(train.images, j_train.images)


def test_linear_classifier_matches_jax():
    from contrad_tpu.models.base import LinearClassifier as JaxLinear
    from contrad_tpu_torch.bridge import torch_state_dict
    from contrad_tpu_torch.models.base import LinearClassifier

    x = np.random.default_rng(6).normal(size=(5, 12)).astype(np.float32)
    m = JaxLinear(n_classes=10)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    port = LinearClassifier(12, 10)
    port.load_state_dict(torch_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(m.apply(
        {"params": params}, jnp.asarray(x))), **STATE_TOL)
