"""The port's copies of the JAX package's jax-free modules
(``contrad_tpu_torch/config.py``, ``contrad_tpu_torch/data``) against the
originals: the same TOML files give the same options, the same seed gives
the same synthetic images, and the batch stream visits the same rows in the
same order across epochs. All exact: the copies make the same numpy calls."""

import numpy as np
import pytest
import torch

from contrad_tpu import config as jax_config
from contrad_tpu.data import get_dataset as jax_get_dataset
from contrad_tpu.data.core import BatchIterator
from contrad_tpu_torch import config
from contrad_tpu_torch.data import DeviceBatchIterator, get_dataset


@pytest.mark.parametrize("experiment,overrides", [
    ("configs/gan/stylegan2/c10_style64.toml", []),
    ("configs/gan/stylegan2/c10_style64.toml",
     ["options.dataset=synthetic_32", "options.max_steps=6",
      "options.beta=[0.5, 0.9]"]),
    ("configs/gan/stylegan2/style_smoke.toml", ["augment.rrc.scale=[0.5, 1.0]"]),
])
def test_config_matches_jax(experiment, overrides):
    def load(mod):
        return mod.finalize_options(mod.load_config(
            mod.default_config_files(experiment), overrides)).to_dict()

    assert load(config) == load(jax_config)


@pytest.mark.parametrize("name", ["synthetic_8", "synthetic_16_64"])
def test_synthetic_data_matches_jax(name):
    train, test, size = get_dataset(name)
    j_train, j_test, j_size = jax_get_dataset(name)
    assert size == j_size
    for a, b in ((train, j_train), (test, j_test)):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)


def test_batch_stream_matches_jax_across_epochs():
    train, _, _ = get_dataset("synthetic_8_64")
    port = DeviceBatchIterator(train, 24, seed=5, device="cpu")
    ref = BatchIterator(train, 24, seed=5)
    for _ in range(7):  # 2 batches an epoch, remainder dropped
        idx = ref.next_indices()
        np.testing.assert_array_equal(next(port).numpy(), train.images[idx])
    assert port.epoch == ref.epoch == 3
    assert next(port).dtype == torch.uint8
