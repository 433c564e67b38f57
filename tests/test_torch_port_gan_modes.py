"""More of the port's ``GANTrainer`` steps against the JAX package's, as in
``tests/test_torch_port_gan_step.py``, whose helpers, pair and tolerances
this file uses (the files split the cases between test workers): the
``gp``, ``cr`` and ``bcr`` penalties (``std``), and the ``aug``,
``aug_both`` and ``simclr_only`` modes (``contrad`` is there). Checked: losses,
gradients, ``u``, batch-norm statistics and parameters after the step."""

import pytest

from test_torch_port_gan_step import (
    _compare_grads, _compare_metrics, _compare_state, run_case)
from test_torch_port_sndcgan import build_sndcgan_pair
from torch_port_jax import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def pair():
    return build_sndcgan_pair(seed=1)


@pytest.mark.parametrize("penalty", ["gp", "cr", "bcr"])
def test_std_step_matches_jax_for_each_penalty(pair, penalty):
    r = run_case(pair, "std", penalty=penalty)
    assert float(r["metrics"]["D_penalty"]) > 0
    _compare_metrics(r)
    _compare_grads(r)
    _compare_state(r)


@pytest.mark.parametrize("mode,penalty", [
    ("aug", "bcr"), ("aug_both", "bcr"), ("simclr_only", "none")])
def test_mode_step_matches_jax(pair, mode, penalty):
    r = run_case(pair, mode, penalty=penalty)
    _compare_metrics(r)
    _compare_grads(r)
    _compare_state(r)
