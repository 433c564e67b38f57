"""FID features on the card: G and the embedder in one loop (the
counterpart of ``contrad_tpu/evaluate/sharded.py``).

The reference's evaluation (``third_party/fid/fid_score.py:115-158``)
brings every batch of 50 images to the host and feeds it back to a separate
InceptionV3. Here the latents are drawn on the card, G and the embedder run
there chunk after chunk, and only the ``(n, d)`` features come to the host.
The JAX package shards that program over a device mesh; the port shards it
over a world of processes (``parallel/``): every rank draws each chunk's
latents from the same seed, samples and embeds its rows, and the features
are gathered in rank order, so every rank holds the features a world of one
computes.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def moments_embed_torch(x: torch.Tensor) -> torch.Tensor:
    """The torch form of :func:`~contrad_tpu_torch.evaluate.fid.
    moments_embed_fn` (per-channel mean and standard deviation, means of a
    coarse 4x4 grid) on NHWC images in [0, 1], in their own type: float32
    on the card against float64 on the host, features within about 1e-6."""
    n, h, w, _ = x.shape
    q = max(h // 4, 1)
    feats = [x.mean(dim=(1, 2)), x.std(dim=(1, 2), correction=0)]
    for i in range(0, h - q + 1, q):
        for j in range(0, w - q + 1, q):
            feats.append(x[:, i: i + q, j: j + q].mean(dim=(1, 2, 3))[:, None])
    return torch.cat([f.reshape(n, -1) for f in feats], dim=1)


def get_torch_embed_forward(name: str, device,
                            inception_path: Optional[str] = None
                            ) -> Callable[[torch.Tensor], torch.Tensor]:
    """An embedder on the card: NHWC float images in [0, 1] -> (n, d)."""
    if name == "moments":
        return moments_embed_torch
    if name in ("inception", "torch_inception"):
        from contrad_tpu_torch.evaluate.inception import load_inception

        model = load_inception(inception_path, device,
                               antialias=name == "inception")
        return lambda x: model(x)[0]
    raise ValueError(f"unknown fid embedder: {name}")


def make_feature_sampler(trainer, embedder: str = "inception",
                         batch_per_call: int = 512, use_ema: bool = False,
                         inception_path: Optional[str] = None
                         ) -> Callable[[int, int], np.ndarray]:
    """``feature_fn(n, seed) -> np (n, d)``: ``n`` samples of the trainer's
    G (its EMA copy with ``use_ema``, as the reference evaluates StyleGAN2,
    ``train_stylegan2.py:249``) in eval mode, embedded on the card, in
    ``ceil(n / batch_per_call)`` chunks of ``batch_per_call``; chunk ``i``
    draws its latents (and a StyleGAN2 G's noise maps) from a
    ``torch.Generator`` on the card seeded ``seed * 100003 + i``, the JAX
    package's stream-splitting constant (``fid.py:78``). G is read at each
    call, so the features follow the training. In a world of processes it
    is collective: each rank samples its rows of every chunk
    (``batch_per_call`` must divide by the world) and every rank returns
    all ``n`` features."""
    from contrad_tpu_torch.models import generate
    from contrad_tpu_torch.parallel import data_shard, gather_rows

    embed = get_torch_embed_forward(embedder, trainer.device, inception_path)
    rank, world = data_shard()
    if batch_per_call % world:
        raise ValueError(f"the FID sampler's chunk of {batch_per_call} must "
                         f"divide device count {world}")
    per = batch_per_call // world
    rows = slice(rank * per, (rank + 1) * per)

    def feature_fn(n: int, seed: int = 0) -> np.ndarray:
        G = trainer.g_ema if use_ema else trainer.generator
        feats = []
        with torch.no_grad():
            for i in range(-(-n // batch_per_call)):
                rng = torch.Generator(device=trainer.device)
                rng.manual_seed(seed * 100003 + i)
                z = G.sample_latent(batch_per_call, rng)
                images = generate(G, z, noise_rng=rng, rows=rows)
                feats.append(gather_rows(embed(images.float())))
        return torch.cat(feats).double().cpu().numpy()[:n]

    return feature_fn
