"""The conditional ``GANTrainer`` step against the JAX package's under each
penalty: ``gp`` and ``cr`` score under the real labels, ``bcr`` under both
sets; the cases of ``tests/test_torch_port_conditional.py``'s parametrised
step test that this file holds (the test workers run a file each), with its
pair, draws and tolerances."""

import pytest

from test_torch_port_conditional import check_step, pair  # noqa: F401
from torch_port_jax import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("mode,penalty", [
    ("std", "gp"), ("std", "cr"), ("std", "bcr")])
def test_conditional_step_matches_jax(pair, mode, penalty):  # noqa: F811
    check_step(pair, mode, penalty)
