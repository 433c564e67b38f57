"""The port's InceptionV3 for FID and IS (``contrad_tpu_torch/evaluate/
inception.py``) against the JAX package's flax ``InceptionV3FID``, with the
same random, batch-norm-realistic weights (drawn from a numpy seed in the
checkpoint's layout, converted to flax by the JAX package's
``convert_torch_checkpoint`` and back by the port's
``bridge.inception_state_from_jax``): pool3 features and logits within rtol
1e-3 / atol 1e-4 (``tests/test_inception_parity.py``'s tolerance) at a
299x299 input with no resize, a 32x32 input (upscaled) and a 512x512 input
(downscaled, where JAX's resize antialiases). Also: the resize alone at
strict tolerance, and the reference's finding that pytorch-fid's resize
(``third_party/torch_fid``, no antialiasing) differs from JAX's at
512 -> 299; the port's ``torch_inception`` form equal to
``third_party/torch_fid``'s network; the bridge and the checkpoint loader;
the batched host embedders."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from contrad_tpu.evaluate.inception import (
    InceptionV3FID as JaxInception, convert_torch_checkpoint)
from contrad_tpu_torch.bridge import inception_state_from_jax
from contrad_tpu_torch.evaluate.inception import (
    InceptionV3FID, from_state_dict, get_inception_embed_fn,
    get_inception_logits_fn, load_inception)
from torch_port_jax import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-3, atol=1e-4)


def random_state(seed: int = 0):
    """Random weights in the checkpoint's layout, as numpy: conv N(0, 0.05);
    batch norm scale U(0.5, 1.5), bias N(0, 0.1), mean N(0, 0.1), var
    U(0.5, 1.5); fc N(0, 0.02), bias N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in InceptionV3FID().state_dict().items():
        shape, leaf = tuple(t.shape), name.rsplit(".", 1)[1]
        if ".conv." in name:
            v = rng.normal(0.0, 0.05, shape)
        elif leaf in ("weight", "running_var") and ".bn." in name:
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "fc.weight":
            v = rng.normal(0.0, 0.02, shape)
        else:  # bn bias and mean, fc bias
            v = rng.normal(0.0, 0.1, shape)
        out[name] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def nets():
    state = random_state()
    variables = convert_torch_checkpoint(state)
    port = from_state_dict(inception_state_from_jax(variables), "cpu")
    return state, variables, port


def _jax_forward(variables, x, resize):
    fn = jax.jit(lambda v, x: JaxInception().apply(v, x, resize=resize))
    pool, logits = fn(variables, jnp.asarray(x))
    return np.asarray(pool), np.asarray(logits)


@pytest.mark.parametrize("shape,resize", [
    ((2, 299, 299, 3), False), ((2, 32, 32, 3), True),
    ((1, 512, 512, 3), True)], ids=["299", "32", "512"])
def test_pool3_and_logits_match_jax(nets, shape, resize):
    _, variables, port = nets
    x = np.random.default_rng(shape[1]).uniform(size=shape).astype(np.float32)
    want_pool, want_logits = _jax_forward(variables, x, resize)
    with torch.no_grad():
        pool, logits = port(torch.from_numpy(x), resize=resize)
    assert pool.shape == (shape[0], 2048) and logits.shape == (shape[0], 1008)
    np.testing.assert_allclose(pool.numpy(), want_pool, **TOL)
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)


@pytest.mark.parametrize("size", [32, 128, 512, 300])
def test_resize_matches_jax_image_resize(size):
    x = np.random.default_rng(size).uniform(size=(2, size, size, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3),
                                       method="bilinear"))
    got = InceptionV3FID().resize(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_pytorch_fid_resize_differs_from_jax_when_shrinking():
    """Found in the reference: at 512 -> 299 ``F.interpolate`` without
    antialiasing (``third_party/torch_fid``) is off JAX's resize by over a
    tenth of the [0, 1] range; the port's ``torch_inception`` keeps
    pytorch-fid's resize, its ``inception`` JAX's."""
    x = np.random.default_rng(1).uniform(size=(1, 512, 512, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3),
                                       method="bilinear"))
    plain = InceptionV3FID(antialias=False).resize(
        torch.from_numpy(x).permute(0, 3, 1, 2))
    assert np.abs(plain.permute(0, 2, 3, 1).numpy() - want).max() > 0.1


def test_torch_inception_is_the_torch_fid_network(nets):
    from third_party.torch_fid.inception import InceptionV3FID as TorchFid

    state, _, _ = nets
    ref = TorchFid().eval()
    ref.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                        strict=False)
    port = from_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                           "cpu", antialias=False)
    x = np.random.default_rng(2).uniform(size=(1, 512, 512, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        got = port(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)


def test_bridge_inverts_the_jax_converter(nets):
    state, variables, port = nets
    back = inception_state_from_jax(variables)
    assert set(back) == set(state) == set(port.state_dict())
    for k, v in state.items():
        assert np.array_equal(back[k].numpy(), v), k
    again = convert_torch_checkpoint({k: t.numpy() for k, t in back.items()})
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(variables)):
        assert np.array_equal(a, b)


def test_loader_reads_the_checkpoint_file_and_says_where_it_goes(
        nets, tmp_path, monkeypatch):
    state, _, port = nets
    missing = tmp_path / "none.pth"
    monkeypatch.setenv("INCEPTION_WEIGHTS", str(missing))
    with pytest.raises(FileNotFoundError,
                       match="pt_inception-2015-12-05-6726825d.pth"):
        load_inception(device="cpu")
    path = tmp_path / "pt_inception.pth"
    torch.save(dict({k: torch.from_numpy(v) for k, v in state.items()},
                    **{"Mixed_5b.branch1x1.bn.num_batches_tracked":
                       torch.tensor(0)}), path)
    loaded = load_inception(str(path), device="cpu")
    assert not loaded.training
    for (k, a), b in zip(loaded.state_dict().items(),
                         port.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(RuntimeError, match="no CUDA device"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        load_inception(str(path))


def test_host_embedders_batch_on_the_device(nets):
    _, _, port = nets
    images = np.random.default_rng(4).integers(0, 256, (3, 16, 16, 3),
                                               dtype=np.uint8)
    with torch.no_grad():
        pool, logits = port(torch.from_numpy(images).float() / 255.0)
    embed = get_inception_embed_fn(model=port, per_device_batch=2)
    probs = get_inception_logits_fn(model=port, per_device_batch=2)
    np.testing.assert_allclose(embed(images), pool.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(probs(images),
                               F.softmax(logits, dim=-1).numpy(), rtol=1e-5,
                               atol=1e-7)
