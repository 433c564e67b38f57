"""The port's FID and IS machinery (``contrad_tpu_torch/evaluate/fid.py``,
``inception_score.py``, ``sharded.py``, ``utils/logger.py::append_csv``,
``data::get_dataset_ref``) against the JAX package's, on inputs made from
a numpy seed:

* the Frechet distance (with its imaginary-part guard), ``compute_stats``,
  ``moments_embed_fn``, the sampler path's statistics and the IS of given
  probabilities: the same numpy and scipy math, within 1e-10 relative;
* a dataset's reference statistics as both packages compute and cache them
  (``precompute_stats`` on ``get_dataset_ref``'s split): within 1e-10;
* ``moments_embed_torch`` against ``moments_embed_jax`` in float32 within
  1e-6 (the JAX package's own bound, ``tests/test_fid_is.py:295``), and the
  feature sampler against the same embedder on the same G's images: chunk
  ``i`` of trial ``seed`` from seed ``seed * 100003 + i``, G in eval mode,
  the EMA G with ``use_ema``;
* ``FIDScore``: the scores, best, CSV, diversity and meanshift of a run of
  updates equal JAX's on the same features; ``update`` by ``sampler`` and by
  ``feature_fn`` agree; every ``load_state_dict`` rule (another embedder or
  size resets ``best``, another ``n_avg`` keeps it and drops the history),
  also across the two packages' state dicts.
"""

import os

import numpy as np
import pytest
import torch

import contrad_tpu.evaluate.fid as jfid
import contrad_tpu_torch.evaluate.fid as pfid
from contrad_tpu.evaluate.inception_score import (
    inception_score as j_inception_score,
    inception_score_from_probs as j_is_from_probs)
from contrad_tpu_torch.evaluate.inception_score import (
    inception_score, inception_score_from_probs)
from torch_port_jax import one_torch_thread  # noqa: F401  (autouse)

REL = 1e-10


def _spd(rng, d):
    a = rng.normal(size=(d, d))
    return a @ a.T / d + 0.1 * np.eye(d)


def _close(got, want, rel=REL):
    np.testing.assert_allclose(got, want, rtol=rel, atol=0)


@pytest.mark.parametrize("d", [1, 16, 64])
def test_frechet_distance_matches_jax(d):
    rng = np.random.default_rng(d)
    mu1, mu2 = rng.normal(size=d), rng.normal(size=d)
    s1, s2 = _spd(rng, d), _spd(rng, d)
    for args in ((mu1, s1, mu2, s2), (mu1, s1, mu1, s1)):
        _close(pfid.calculate_frechet_distance(*args),
               jfid.calculate_frechet_distance(*args))


def test_frechet_distance_of_rank_deficient_covariances_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 12))  # 4 samples in 12 dimensions: rank 3
    mu, sigma = pfid.compute_stats(x)
    mu2, sigma2 = pfid.compute_stats(rng.normal(size=(40, 12)))
    np.testing.assert_allclose(
        pfid.calculate_frechet_distance(mu, sigma, mu2, sigma2),
        jfid.calculate_frechet_distance(mu, sigma, mu2, sigma2), rtol=1e-8)


def test_frechet_distance_refuses_a_large_imaginary_part():
    mu = np.zeros(2)
    s1, s2 = np.diag([1.0, -4.0]), np.eye(2)  # sqrtm(s1 s2) is 2j there
    for f in (pfid, jfid):
        with pytest.raises(ValueError, match="imaginary"):
            f.calculate_frechet_distance(mu, s1, mu, s2)


def test_stats_and_moments_match_jax():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(50, 7))
    for got, want in zip(pfid.compute_stats(feats), jfid.compute_stats(feats)):
        _close(got, want)
    for images in (rng.integers(0, 256, (6, 16, 16, 3), dtype=np.uint8),
                   rng.uniform(size=(6, 9, 9, 3)).astype(np.float32),
                   rng.uniform(size=(3, 4, 4, 3))):
        got = pfid.moments_embed_fn(images)
        assert got.shape == (len(images), 6 + 16)
        _close(got, jfid.moments_embed_fn(images))
    images = rng.integers(0, 256, (23, 8, 8, 3), dtype=np.uint8)
    for got, want in zip(
            pfid.compute_stats_from_images(images, pfid.moments_embed_fn, 5),
            jfid.compute_stats_from_images(images, jfid.moments_embed_fn, 5)):
        _close(got, want)


def _sampler(n, seed):
    return np.random.default_rng(seed).uniform(size=(n, 8, 8, 3))


def test_sampler_path_matches_jax():
    """Batch ``i`` of trial ``seed`` from seed ``seed * 100003 + i``, the
    last batch short, as in ``fid_score.py:115-158``."""
    for got, want in zip(
            pfid.compute_stats_from_sampler(_sampler, pfid.moments_embed_fn,
                                            23, batch_size=10, seed=2),
            jfid.compute_stats_from_sampler(_sampler, jfid.moments_embed_fn,
                                            23, batch_size=10, seed=2)):
        _close(got, want)
    ref_mu, ref_sigma = pfid.compute_stats(
        pfid.moments_embed_fn(_sampler(30, 99)))
    _close(pfid.fid_score(_sampler, pfid.moments_embed_fn, ref_mu, ref_sigma,
                          23, 10, 1),
           jfid.fid_score(_sampler, jfid.moments_embed_fn, ref_mu, ref_sigma,
                          23, 10, 1))


def test_inception_score_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(100, 30)) * 3
    probs = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    for splits in (1, 10):
        got, want = inception_score_from_probs(probs, splits), \
            j_is_from_probs(probs, splits)
        _close(got, want)
    images = rng.uniform(size=(37, 4, 4, 3))
    probs_fn = lambda x: np.exp(x.reshape(len(x), -1)[:, :30] * 3) / np.exp(
        x.reshape(len(x), -1)[:, :30] * 3).sum(axis=1, keepdims=True)
    _close(inception_score(images, probs_fn, splits=4, batch_size=8),
           j_inception_score(images, probs_fn, splits=4, batch_size=8))


def test_append_csv_writes_the_header_once(tmp_path):
    from contrad_tpu.utils.logger import append_csv as j_append_csv
    from contrad_tpu_torch.utils.logger import append_csv

    for f, name in ((append_csv, "port.csv"), (j_append_csv, "jax.csv")):
        for row in ([2, 1.5, 2.5], [4, 0.25, 1e-7]):
            f(str(tmp_path / name), ["step", "fid_0", "mean"], row)
    text = (tmp_path / "port.csv").read_text()
    assert text == (tmp_path / "jax.csv").read_text()
    assert text.splitlines() == ["step,fid_0,mean", "2,1.5,2.5",
                                 "4,0.25,1e-07"]


@pytest.mark.parametrize("dataset", ["synthetic_8_64", "synthetic_16"])
def test_reference_split_and_cached_stats_match_jax(tmp_path, dataset):
    from contrad_tpu.data import get_dataset_ref as j_ref
    from contrad_tpu_torch.data import get_dataset_ref

    assert np.array_equal(get_dataset_ref(dataset).images,
                          j_ref(dataset).images)
    got = np.load(pfid.precompute_stats(dataset, pfid.moments_embed_fn,
                                        str(tmp_path / "port")))
    want = np.load(jfid.precompute_stats(dataset, jfid.moments_embed_fn,
                                         str(tmp_path / "jax")))
    for k in ("mu", "sigma"):
        _close(got[k], want[k])
    assert not [f for f in os.listdir(tmp_path / "port") if "tmp" in f]


def test_reference_split_per_dataset_family(monkeypatch):
    """The test split for cifar*, celeba128 and synthetic*, the train split
    for afhq_* (``contrad_tpu/data/__init__.py:116-131``)."""
    import contrad_tpu_torch.data as pdata

    monkeypatch.setattr(pdata, "get_dataset",
                        lambda name, path=None: ("train", "test", None))
    for name, want in (("cifar10", "test"), ("cifar100_lin", "test"),
                       ("celeba128", "test"), ("synthetic_8", "test"),
                       ("afhq_dog", "train"), ("afhq_wild", "train")):
        assert pdata.get_dataset_ref(name) == want, name
    with pytest.raises(NotImplementedError):
        pdata.get_dataset_ref("mnist")


def test_stats_live_where_the_jax_package_keeps_them():
    assert os.path.realpath(pfid.STATS_DIR) == os.path.realpath(jfid.STATS_DIR)
    assert pfid.stats_path("cifar10") == jfid.stats_path("cifar10")
    assert pfid.embedder_stats_dir("inception") == pfid.STATS_DIR
    assert pfid.embedder_stats_dir("moments") == os.path.join(
        pfid.STATS_DIR, "moments")
    assert pfid.embedder_stats_dir("moments", "/x") == "/x"


# ------------------------------------------------------------ the tracker

def _features(n, seed):
    """Deterministic (n, 5) features, drifting with ``seed``."""
    return np.random.default_rng(seed).normal(0.1 * seed, 1.0, size=(n, 5))


def _trackers(tmp_path, n_avg=2, size=40, embedder="moments"):
    ref = np.random.default_rng(0).normal(size=(60, 5))
    mu, sigma = pfid.compute_stats(ref)
    np.savez(pfid.stats_path("ds", str(tmp_path)), mu=mu, sigma=sigma)
    kw = dict(size=size, n_avg=n_avg, stats_dir=str(tmp_path),
              embedder=embedder)
    return pfid.FIDScore("ds", device="cpu", **kw), jfid.FIDScore("ds", **kw)


def test_fid_score_tracker_matches_jax(tmp_path):
    port, jax_ = _trackers(tmp_path)
    for step, shift in ((2, 0), (4, 5), (6, 1), (8, 9)):
        fn = lambda n, s: _features(n, s + shift)
        got, want = port.update(step, feature_fn=fn), \
            jax_.update(step, feature_fn=fn)
        _close(got, want)
        assert port.is_best == jax_.is_best
        for k in ("best", "last_diversity", "last_meanshift"):
            _close(getattr(port, k), getattr(jax_, k))
        port.save(str(tmp_path / "port.csv"))
        jax_.save(str(tmp_path / "jax.csv"))
    assert [r[0] for r in port.history] == [2, 4, 6, 8]
    assert [row[-1] for row in port.history].count(port.best) == 1
    np.testing.assert_allclose(np.asarray(port.history),
                               np.asarray(jax_.history), rtol=REL)
    rows = (tmp_path / "port.csv").read_text().splitlines()
    assert rows[0] == "step,fid_0,fid_1,mean" and len(rows) == 5
    assert rows[0] == (tmp_path / "jax.csv").read_text().splitlines()[0]
    assert 0 < port.last_diversity and 0 < port.last_meanshift


def test_update_by_sampler_and_by_feature_fn_agree(tmp_path):
    port, _ = _trackers(tmp_path, size=23)
    port.batch_size = 10
    port._embed_fn = lambda x: x.reshape(len(x), -1)[:, :5]
    by_sampler = port.update(1, sampler=lambda n, s: _features(n, s)[
        :, :, None, None])
    feature_fn = lambda n, trial: np.concatenate([
        _features(min(10, n - 10 * i), trial * 100003 + i)
        for i in range(-(-n // 10))])
    by_features = port.update(2, feature_fn=feature_fn)
    _close(by_sampler, by_features, rel=1e-12)
    with pytest.raises(ValueError, match="exactly one"):
        port.update(3)


def test_load_state_dict_rules(tmp_path):
    port, jax_ = _trackers(tmp_path)
    for step in (1, 2):
        port.update(step, feature_fn=_features)
        jax_.update(step, feature_fn=_features)
    best = port.best
    # across the packages, both ways
    p2, j2 = _trackers(tmp_path)
    p2.load_state_dict(jax_.state_dict())
    j2.load_state_dict(port.state_dict())
    for tr in (p2, j2):
        assert tr.best == best and len(tr.history) == 2 and not tr.is_best
    # another n_avg: best kept, history dropped
    p3, _ = _trackers(tmp_path, n_avg=3)
    p3.load_state_dict(port.state_dict())
    assert p3.best == best and p3.history == []
    # another embedder or size: a fresh gate
    for kw in (dict(embedder="inception"), dict(size=41)):
        p4, _ = _trackers(tmp_path, **kw)
        p4.load_state_dict(port.state_dict())
        assert p4.best == float("inf") and p4.history == []
    # a state without provenance is taken as it is
    p5, _ = _trackers(tmp_path)
    sd = port.state_dict()
    p5.load_state_dict({"history": sd["history"], "best": sd["best"]})
    assert p5.best == best and len(p5.history) == 2
    state = port.state_dict()
    assert str(state["embedder"]) == "moments" and int(state["size"]) == 40


def test_missing_stats_without_precompute_names_the_ports_command(tmp_path):
    with pytest.raises(FileNotFoundError,
                       match="python -m contrad_tpu_torch.evaluate.fid "
                             "nowhere --embed moments"):
        pfid.FIDScore("nowhere", stats_dir=str(tmp_path), embedder="moments",
                      precompute_ok=False, device="cpu")


def test_stats_cli_writes_the_embedders_file(tmp_path, monkeypatch):
    monkeypatch.setattr(pfid, "STATS_DIR", str(tmp_path))
    path = pfid.main(["synthetic_8_64", "--embed", "moments", "--device",
                      "cpu"])
    assert path == str(tmp_path / "moments" / "synthetic_8_64_stats.npz")
    assert np.load(path)["sigma"].shape == (22, 22)


# --------------------------------------------------- on-device features

def test_moments_embed_torch_matches_jax():
    import jax.numpy as jnp

    from contrad_tpu.evaluate.sharded import moments_embed_jax
    from contrad_tpu_torch.evaluate.sharded import moments_embed_torch

    rng = np.random.default_rng(8)
    for shape in ((5, 32, 32, 3), (3, 8, 8, 3), (2, 3, 3, 3)):
        x = rng.uniform(size=shape).astype(np.float32)
        got = moments_embed_torch(torch.from_numpy(x)).numpy()
        want = np.asarray(moments_embed_jax(jnp.asarray(x)))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got, pfid.moments_embed_fn(x), atol=1e-6,
                                   rtol=0)


class _Trainer:
    def __init__(self, arch):
        from contrad_tpu_torch.models import get_architecture

        self.generator, _ = get_architecture(arch, (8, 8, 3), device="cpu",
                                             seed=1)
        self.g_ema, _ = get_architecture(arch, (8, 8, 3), device="cpu",
                                         seed=2)
        self.device = torch.device("cpu")


@pytest.mark.parametrize("arch,use_ema", [("sndcgan", False),
                                          ("stylegan2_tiny", True)])
def test_feature_sampler_chunks_seeds_and_embeds(arch, use_ema):
    import jax.numpy as jnp

    from contrad_tpu.evaluate.sharded import moments_embed_jax
    from contrad_tpu_torch.evaluate.sharded import make_feature_sampler
    from contrad_tpu_torch.models import generate

    trainer = _Trainer(arch)
    G = trainer.g_ema if use_ema else trainer.generator
    feature_fn = make_feature_sampler(trainer, "moments", batch_per_call=4,
                                      use_ema=use_ema)
    got = feature_fn(10, 3)
    assert got.shape == (10, 22)
    chunks = []
    with torch.no_grad():
        for i in range(3):
            rng = torch.Generator().manual_seed(3 * 100003 + i)
            images = generate(G, G.sample_latent(4, rng), noise_rng=rng)
            chunks.append(np.asarray(moments_embed_jax(jnp.asarray(
                images.float().numpy()))))
    np.testing.assert_allclose(got, np.concatenate(chunks)[:10], atol=1e-6,
                               rtol=0)
    assert np.array_equal(feature_fn(10, 3), got)
    assert not np.allclose(feature_fn(10, 4), got)
    with pytest.raises(ValueError, match="unknown fid embedder"):
        make_feature_sampler(trainer, "vgg")
