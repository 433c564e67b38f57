"""The 512x512 recipe's trainer step that carries the lazy R1 penalty
(``d_reg_every = 2``: the penalty on augmented reals, scaled by
``0.5 * lbd_r1 * d_reg_every``, a gradient of a gradient through D and
the blur) against the JAX packed step; the set-up, the checks and their
tolerances are ``tests/test_torch_port_sg512_step.py``'s, which runs the
step without R1."""

from test_torch_port_sg512_step import check_step, run_step
from torch_port_jax import one_torch_thread  # noqa: F401  (autouse)


def test_r1_step_matches_jax_packed():
    check_step(run_step(do_r1=True), do_r1=True)
