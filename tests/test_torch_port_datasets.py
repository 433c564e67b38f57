"""The port's dataset registry for unconditional training
(``contrad_tpu_torch/data``: ``cifar100[_hflip]``, ``celeba128``,
``afhq_{cat,dog,wild}``, ``get_image_size``, the image-folder loader)
against the JAX package, on files the tests write: PNGs of different sizes
and CIFAR-100 pickles. All exact: the copies make the same numpy and PIL
calls."""

import os
import pickle

import numpy as np
import pytest

from contrad_tpu.data import get_dataset as jax_get_dataset
from contrad_tpu.data import get_image_size as jax_get_image_size
from contrad_tpu.data.folder import load_image_folder as jax_load_folder
from contrad_tpu_torch.data import (
    get_dataset, get_image_size, load_image_folder)

NAMES = ("cifar10", "cifar10_hflip", "cifar100", "cifar100_hflip",
         "celeba128", "afhq_cat", "afhq_dog", "afhq_wild", "synthetic",
         "synthetic_8", "synthetic_512", "synthetic_16_64")


def _write_pngs(folder, sizes, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    for i, (h, w) in enumerate(sizes):
        mode = "RGBA" if i % 3 == 2 else "RGB"  # convert("RGB") drops alpha
        pixels = rng.integers(0, 256, size=(h, w, len(mode)), dtype=np.uint8)
        sub = os.path.join(folder, "nested") if i % 2 else folder
        os.makedirs(sub, exist_ok=True)
        Image.fromarray(pixels, mode).save(os.path.join(sub, f"img_{i}.png"))


def _cache_files(root):
    return sorted(f for f in os.listdir(root) if f.startswith(".cache_"))


def test_folder_loader_matches_jax_and_reuses_its_cache(tmp_path):
    folder = str(tmp_path / "images")
    _write_pngs(folder, [(20, 20), (17, 31), (40, 12), (20, 20), (9, 9)])
    want = np.array(jax_load_folder(folder, (20, 20, 3)).images)
    for cache in _cache_files(tmp_path):  # the port decodes on its own
        os.remove(tmp_path / cache)
    got = load_image_folder(folder, (20, 20, 3))
    assert got.images.dtype == np.uint8 and got.images.shape == (5, 20, 20, 3)
    np.testing.assert_array_equal(np.asarray(got.images), want)
    # the cache next to the folder is read back, not decoded again
    [cache] = _cache_files(tmp_path)
    stamp = os.stat(tmp_path / cache).st_mtime_ns
    again = load_image_folder(folder, (20, 20, 3))
    np.testing.assert_array_equal(np.asarray(again.images), want)
    assert os.stat(tmp_path / cache).st_mtime_ns == stamp


def test_folder_loader_rebuilds_a_stale_cache_and_refuses_empty_folders(
        tmp_path):
    folder = str(tmp_path / "images")
    _write_pngs(folder, [(8, 8), (8, 8)])
    assert len(load_image_folder(folder, (8, 8, 3))) == 2
    _write_pngs(str(tmp_path / "images" / "more"), [(8, 8)], seed=1)
    assert len(load_image_folder(folder, (8, 8, 3))) == 3
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no images"):
        load_image_folder(str(tmp_path / "empty"), (8, 8, 3))
    with pytest.raises(FileNotFoundError, match="not found"):
        load_image_folder(str(tmp_path / "missing"), (8, 8, 3))


@pytest.mark.parametrize("name", NAMES)
def test_image_size_matches_jax(name):
    assert get_image_size(name) == jax_get_image_size(name)


def test_image_size_refuses_unknown_names():
    for name in ("cifar10_crop", "afhq_fox", "imagenet"):
        with pytest.raises(NotImplementedError):
            get_image_size(name)
        with pytest.raises(NotImplementedError):
            get_dataset(name)


@pytest.mark.parametrize("kind", ["cat", "dog", "wild"])
def test_afhq_matches_jax_and_flips_its_reals(tmp_path, kind):
    root = tmp_path / "data"
    for split, n in (("train", 3), ("val", 2)):
        _write_pngs(str(root / "afhq" / kind / split),
                    [(24, 24), (30, 20), (24, 24)][:n], seed=n)
    name = f"afhq_{kind}"
    j_train, j_val, j_size = jax_get_dataset(name, str(root))
    j_train, j_val = np.array(j_train.images), np.array(j_val.images)
    for cache in _cache_files(root / "afhq" / kind):
        os.remove(root / "afhq" / kind / cache)
    train, val, size = get_dataset(name, str(root))
    assert size == j_size == (512, 512, 3)
    assert train.train_aug == "hflip" and val.train_aug == "none"
    np.testing.assert_array_equal(np.asarray(train.images), j_train)
    np.testing.assert_array_equal(np.asarray(val.images), j_val)


def test_celeba128_matches_jax(tmp_path):
    split = tmp_path / "CelebAMask-HQ" / "CelebA-128-split"
    _write_pngs(str(split / "train"), [(128, 128), (100, 140)])
    _write_pngs(str(split / "test"), [(128, 128)], seed=1)
    j_train, j_test, _ = jax_get_dataset("celeba128", str(tmp_path))
    j_train, j_test = np.array(j_train.images), np.array(j_test.images)
    for cache in _cache_files(split):
        os.remove(split / cache)
    train, test, size = get_dataset("celeba128", str(tmp_path))
    assert size == (128, 128, 3) and train.train_aug == "none"
    np.testing.assert_array_equal(np.asarray(train.images), j_train)
    np.testing.assert_array_equal(np.asarray(test.images), j_test)


def _write_cifar100(root):
    rng = np.random.default_rng(5)
    base = os.path.join(root, "cifar-100-python")
    os.makedirs(base)
    for split, n in (("train", 6), ("test", 4)):
        with open(os.path.join(base, split), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), np.uint8),
                         b"fine_labels": rng.integers(0, 100, n).tolist(),
                         b"coarse_labels": rng.integers(0, 20, n).tolist()},
                        f)


@pytest.mark.parametrize("name", ["cifar100", "cifar100_hflip"])
def test_cifar100_matches_jax(tmp_path, name):
    """Against the JAX package's ``load_cifar100``: its registry sends
    ``cifar100`` to the CIFAR-10 loader (``dataset.startswith("cifar10")``
    holds for it, ``contrad_tpu/data/__init__.py:65``); the port's loads
    CIFAR-100."""
    from contrad_tpu.data.cifar import load_cifar100 as jax_load_cifar100

    _write_cifar100(str(tmp_path))
    train, test, size = get_dataset(name, str(tmp_path))
    j_train, j_test = jax_load_cifar100(str(tmp_path))
    assert size == (32, 32, 3)
    assert train.train_aug == ("hflip" if name.endswith("_hflip") else "none")
    assert train.n_classes == j_train.n_classes == 100
    for a, b in ((train, j_train), (test, j_test)):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
