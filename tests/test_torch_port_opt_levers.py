"""Adam's storage levers (``contrad_tpu_torch/training/state.py``:
``ScheduledAdam(mu_dtype=, nu_dtype=, grads_dtype=)``) against the JAX
package's ``make_optimizer`` (optax 0.2.6's ``adam`` with the same levers),
on the same float32 parameters and the same gradients from a numpy seed:
each lever alone and the production stack (all three bfloat16), over 10
updates with the recipes' warmup, for the flagship's betas (0.5, 0.999) and
StyleGAN2's (0.0, 0.99).

Tolerances:
  * against optax run op by op (every product and sum rounded to the dtype
    JAX's promotion gives it, the semantics of the optax code): the stored
    ``mu`` and ``nu`` bit for bit, in their lever's dtype; the parameters
    within 1e-6 (the learning rate and the bias corrections are taken in
    float32 on the host, XLA's ``pow`` on the CPU can be an ulp off);
  * against the jitted update, as the JAX trainer runs it (the flagship's
    betas): ``mu`` bit for bit; ``nu`` within 2 float32 ulps (4e-7
    relative) where the gradients stay float32 (XLA reorders the float32
    sum). With the bfloat16 gradients lever XLA keeps ``g²`` unrounded
    inside its fusion (a product of two bfloat16 values is exact in
    float32) where optax's code rounds it to bfloat16: a float32 ``nu``
    (that lever alone) is held within 2^-8 relative, the rounding of
    ``g²`` (measured 2^-8.15), a bfloat16 ``nu`` (the full stack) within
    one bfloat16 ulp, and the parameters within 1e-5. At StyleGAN2's
    betas (0.0, 0.99) the full stack's jitted ``nu`` drifts further, 3
    ulps after 10 updates (measured, not a test): the port follows optax's
    code, bit for bit, not XLA's fusion.

Also: the bias corrections over the first 200,000 updates against
optax's (``BC_ULPS``); the storage dtypes and that the parameters stay
float32 (the dtype audit of the optimiser); ``state_dict`` in the layout of
the checkpoints written while ``ScheduledAdam`` wrapped
``torch.optim.Adam``, such a checkpoint loading, and optax's state carried
into a ``ScheduledAdam`` bit for bit through ``bridge.adam_state_from_optax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from contrad_tpu.training.state import make_optimizer
from contrad_tpu_torch.bridge import adam_state_from_optax
from contrad_tpu_torch.training import ScheduledAdam
from torch_port_jax import one_torch_thread  # noqa: F401

SHAPES = [(16, 8), (8,), (5, 3, 3, 4)]
LEVERS = {"none": (), "mu": ("mu_dtype",), "nu": ("nu_dtype",),
          "grads": ("grads_dtype",),
          "all": ("mu_dtype", "nu_dtype", "grads_dtype")}
BETAS = [(0.5, 0.999), (0.0, 0.99)]
UPDATES, WARMUP, LR = 10, 5, 2e-4


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in SHAPES]


def _grads(seed, n=UPDATES):
    """Gradients over four decades, so that ``g²`` reaches bfloat16's
    rounding at every scale."""
    rng = np.random.default_rng(seed)
    return [[(rng.normal(size=s) * 10 ** rng.uniform(-3, 1)).astype(
        np.float32) for s in SHAPES] for _ in range(n)]


def _run(lever, beta, jit):
    jax_levers = {k: jnp.bfloat16 for k in LEVERS[lever]}
    port_levers = {k: torch.bfloat16 for k in LEVERS[lever]}
    tx = make_optimizer(LR, beta, warmup=WARMUP, use_warmup=True,
                        **jax_levers)
    update = jax.jit(tx.update) if jit else tx.update
    p0 = _params()
    params = [jnp.asarray(p) for p in p0]
    state = tx.init(params)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = ScheduledAdam(tp, LR, beta, warmup=WARMUP, use_warmup=True,
                        **port_levers)
    for g in _grads(1):
        updates, state = update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, updates)
        opt.step([torch.from_numpy(x) for x in g])
    return state[0], params, opt, tp


def _f32(x):
    return np.asarray(x).astype(np.float32) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("lever", list(LEVERS))
def test_levers_match_optax_bitwise(lever, beta):
    adam, params, opt, tp = _run(lever, beta, jit=False)
    want_mu = jnp.bfloat16 if "mu_dtype" in LEVERS[lever] else jnp.float32
    want_nu = jnp.bfloat16 if "nu_dtype" in LEVERS[lever] else jnp.float32
    assert opt.count == int(adam.count) == UPDATES
    for i, (m, v) in enumerate(zip(adam.mu, adam.nu)):
        assert m.dtype == want_mu and v.dtype == want_nu
        assert str(opt.mu[i].dtype).endswith(str(m.dtype)), i
        assert str(opt.nu[i].dtype).endswith(str(v.dtype)), i
        np.testing.assert_array_equal(_f32(opt.mu[i]), _f32(m), err_msg="mu")
        np.testing.assert_array_equal(_f32(opt.nu[i]), _f32(v), err_msg="nu")
    for p, want in zip(tp, params):
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("lever", ["none", "grads", "all"])
def test_levers_match_the_jitted_update(lever):
    adam, params, opt, tp = _run(lever, BETAS[0], jit=True)
    grads_lever = "grads_dtype" in LEVERS[lever]
    for i, (m, v) in enumerate(zip(adam.mu, adam.nu)):
        np.testing.assert_array_equal(_f32(opt.mu[i]), _f32(m), err_msg="mu")
        if opt.nu[i].dtype == torch.bfloat16:  # one ulp: adjacent patterns
            bits = [torch.from_numpy(_f32(x)).bfloat16().view(torch.int16)
                    .int() for x in (opt.nu[i], v)]
            assert int((bits[0] - bits[1]).abs().max()) <= 1, "nu"
            continue
        np.testing.assert_allclose(_f32(opt.nu[i]), _f32(v), atol=0,
                                   rtol=2.0 ** -8 if grads_lever else 4e-7,
                                   err_msg="nu")
    for p, want in zip(tp, params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5 if grads_lever else 1e-6)


# float32 ulps allowed between ``ScheduledAdam.schedule``'s bias
# corrections (torch's pow with a float exponent) and optax's (XLA's pow of
# the int32 count), and between a moment divided by each, over the first
# BC_UPDATES updates on the CPU: bitwise at 0.5 and 0; at 0.999 and 0.99 the
# two pows part on a few counts (measured: 23 counts, at most 4 ulps, at
# 0.999; 3 counts, 2 ulps, 3 after the division, at 0.99)
BC_UPDATES = 200000
BC_ULPS = {0.5: (0, 0), 0.0: (0, 0), 0.999: (4, 4), 0.99: (2, 3)}


def _ulps(a, b) -> int:
    a, b = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
            for x in (a, b))
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("beta", BETAS)
def test_bias_corrections_match_optax(beta):
    """``schedule``'s bias corrections ``1 - b ** t`` for t = 1 ..
    BC_UPDATES (the device count set to every count at once, through the
    same code) against optax's ``1 - decay ** count`` under jit, and a
    moment divided by each against ``optax.tree_utils.tree_bias_correction``
    (what ``scale_by_adam`` divides by), within ``BC_ULPS``."""
    opt = ScheduledAdam([torch.nn.Parameter(torch.zeros(1))], LR, beta)
    opt.count_t = torch.arange(BC_UPDATES, dtype=torch.int32)
    _, bc1, bc2 = opt.schedule(torch.float32, torch.float32)
    count = jnp.arange(1, BC_UPDATES + 1, dtype=jnp.int32)
    moment = np.random.default_rng(0).standard_normal(BC_UPDATES).astype(
        np.float32)
    for b, bc in zip(beta, (bc1, bc2)):
        want = jax.jit(lambda c: 1 - b ** c)(count)
        divided = jax.jit(jax.vmap(
            lambda m, c: optax.tree_utils.tree_bias_correction(m, b, c)))(
                moment, count)
        assert _ulps(bc.numpy(), want) <= BC_ULPS[b][0], b
        assert _ulps(torch.from_numpy(moment) / bc, divided) \
            <= BC_ULPS[b][1], b


def test_state_dict_keeps_the_layout_and_the_storage_dtypes():
    _, _, opt, tp = _run("all", BETAS[0], jit=False)
    sd = opt.state_dict()
    assert sd["count"] == UPDATES
    assert set(sd["adam"]) == {"state", "param_groups"}
    assert sd["adam"]["param_groups"][0]["params"] == [0, 1, 2]
    for i, entry in sd["adam"]["state"].items():
        assert set(entry) == {"step", "exp_avg", "exp_avg_sq"}
        assert float(entry["step"]) == UPDATES
        assert entry["exp_avg"].dtype == entry["exp_avg_sq"].dtype \
            == torch.bfloat16
    # a restored lever run continues bit for bit
    fresh = [torch.nn.Parameter(p.detach().clone()) for p in tp]
    back = ScheduledAdam(fresh, LR, BETAS[0], warmup=WARMUP, use_warmup=True,
                         mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16,
                         grads_dtype=torch.bfloat16)
    back.load_state_dict(sd)
    g = [torch.from_numpy(x) for x in _grads(2, 1)[0]]
    opt.step(g)
    back.step(g)
    for a, b in zip(tp + opt.mu + opt.nu, fresh + back.mu + back.nu):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach())


def test_a_torch_adam_checkpoint_loads():
    """A checkpoint of the earlier ``ScheduledAdam``, which wrapped
    ``torch.optim.Adam``: its ``{"count", "adam":
    torch.optim.Adam.state_dict()}`` loads, into the
    float32 optimiser as it is and into a lever run cast to bfloat16, and
    the next update is Adam's (within 1e-7 of torch's: the same algorithm,
    its operations in another order)."""
    p0 = _params(3)
    ref = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    torch_adam = torch.optim.Adam(ref, lr=LR, betas=BETAS[0], eps=1e-8)
    grads = [[torch.from_numpy(x) for x in g] for g in _grads(4, 3)]
    for g in grads[:2]:
        for p, x in zip(ref, g):
            p.grad = x.clone()
        torch_adam.step()
    old = {"count": 2, "adam": torch_adam.state_dict()}

    mine = [torch.nn.Parameter(p.detach().clone()) for p in ref]
    opt = ScheduledAdam(mine, LR, BETAS[0])
    opt.load_state_dict(old)
    lever = ScheduledAdam([torch.nn.Parameter(p.detach().clone())
                           for p in ref], LR, BETAS[0],
                          mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16)
    lever.load_state_dict(old)
    assert opt.count == lever.count == 2
    for i, p in enumerate(ref):
        st = torch_adam.state[p]
        assert torch.equal(opt.mu[i], st["exp_avg"])
        assert torch.equal(opt.nu[i], st["exp_avg_sq"])
        assert lever.mu[i].dtype == torch.bfloat16
        assert torch.equal(lever.mu[i], st["exp_avg"].bfloat16())
    for p, x in zip(ref, grads[2]):
        p.grad = x.clone()
    torch_adam.step()
    opt.step(grads[2])
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=1e-7)


def test_optax_state_carries_into_scheduled_adam_bitwise():
    """optax's bfloat16 moments, through ``adam_state_from_optax`` on a
    module's parameter tree (a dense kernel, transposed as the bridge
    transposes parameters), load into a ``ScheduledAdam`` unchanged."""
    module = torch.nn.Module()
    module.dense = torch.nn.Module()
    module.dense.weight = torch.nn.Parameter(torch.zeros(4, 6))
    module.dense.bias = torch.nn.Parameter(torch.zeros(4))
    tree = {"dense": {"kernel": jnp.asarray(_params(5)[0][:6, :4]),
                      "bias": jnp.zeros((4,))}}
    tx = make_optimizer(LR, BETAS[0], mu_dtype=jnp.bfloat16,
                        nu_dtype=jnp.bfloat16)
    state = tx.init(tree)
    g = jax.tree.map(lambda a: a + 0.37, tree)
    for _ in range(3):
        _, state = tx.update(g, state, tree)
    adam = state[0]
    opt = ScheduledAdam(module.parameters(), LR, BETAS[0],
                        mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16)
    opt.load_state_dict(adam_state_from_optax(adam, module))
    assert opt.count == 3
    want_mu = _f32(adam.mu["dense"]["kernel"]).T
    assert opt.mu[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(opt.mu[0].float().numpy(), want_mu)
    np.testing.assert_array_equal(opt.nu[1].float().numpy(),
                                  _f32(adam.nu["dense"]["bias"]))
