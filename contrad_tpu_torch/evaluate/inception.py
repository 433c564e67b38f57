"""InceptionV3 for FID and IS (the port of
``contrad_tpu/evaluate/inception.py``; reference
``third_party/fid/inception.py``).

The FID network is the TF "inception-2015-12-05" graph as pytorch-fid
reproduces it: torchvision's InceptionV3 topology with a 1008-way fc and
its quirks (reference ``inception.py:131-157, 199-314``):
  * every in-block average pool uses ``count_include_pad=False``;
  * Mixed_7c (the second InceptionE) has a MAX pool in its pool branch;
  * batch norm with eps 1e-3 (frozen: the network is never trained here);
  * inputs are resized bilinearly to 299x299 (half-pixel centres,
    ``align_corners=False``) and mapped from [0, 1] to [-1, 1].

The resize follows the JAX package's ``jax.image.resize``, which
antialiases when it shrinks: ``F.interpolate`` gets ``antialias=True`` for
an input larger than 299 (the 512x512 AFHQ samples), and the two agree at
every size. ``antialias=False`` is ``third_party/torch_fid``'s
(pytorch-fid's) resize, the ``torch_inception`` embedder; at 512 -> 299 the
two resizes differ by up to 0.56 a pixel, so the two embedders score 512^2
samples differently.

Module names are the checkpoint's keys: ``load_state_dict`` reads
``pt_inception-2015-12-05-6726825d.pth`` as it is (its
``num_batches_tracked`` entries dropped, as the JAX converter drops them).
Put the file under ``third_party/fid/`` or point ``$INCEPTION_WEIGHTS`` at
it. The network runs NCHW inside, channels-last in memory on the card; its
entry points take NHWC images, as the rest of the port does.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "third_party", "fid", "pt_inception-2015-12-05-6726825d.pth")
SIZE = 299


class FrozenBatchNorm2d(nn.Module):
    """Batch norm with fixed statistics: ``weight``, ``bias``,
    ``running_mean`` and ``running_var`` under the checkpoint's names."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class BasicConv2d(nn.Module):
    """conv (no bias) + batch norm (eps 1e-3) + ReLU."""

    def __init__(self, in_ch, out_ch, **kw):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, bias=False, **kw)
        self.bn = FrozenBatchNorm2d(out_ch)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    return F.avg_pool2d(x, kernel_size=3, stride=1, padding=1,
                        count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_ch, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b1, b5, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, kernel_size=3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch, c7):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_5(self.branch7x7dbl_4(self.branch7x7dbl_3(
            self.branch7x7dbl_2(self.branch7x7dbl_1(x)))))
        return torch.cat([b1, b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(
            self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, kernel_size=3, stride=2)], 1)


class InceptionE(nn.Module):
    """``pool``: ``avg`` (Mixed_7b, ``count_include_pad=False``) or ``max``
    (Mixed_7c, the TF graph's quirk)."""

    def __init__(self, in_ch, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(in_ch, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool == "avg":
            bp = _avg_pool(x)
        else:
            bp = F.max_pool2d(x, kernel_size=3, stride=1, padding=1)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3FID(nn.Module):
    """The FID InceptionV3. ``forward(x)``: NHWC images in [0, 1] ->
    ``(pool3 (N, 2048), logits (N, 1008))``. ``antialias=False`` resizes as
    ``third_party/torch_fid`` does (see the module docstring)."""

    def __init__(self, antialias: bool = True):
        super().__init__()
        self.antialias = antialias
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, 1008)

    def resize(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW -> (N, C, 299, 299), bilinear, half-pixel centres;
        antialiased where the input is larger than 299 (with
        ``antialias``)."""
        h, w = x.shape[-2:]
        if (h, w) == (SIZE, SIZE):
            return x
        return F.interpolate(x, size=(SIZE, SIZE), mode="bilinear",
                             align_corners=False,
                             antialias=self.antialias and max(h, w) > SIZE)

    def forward(self, x: torch.Tensor, resize: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)  # NHWC memory read as NCHW (channels-last)
        if resize:
            x = self.resize(x)
        x = 2.0 * x - 1.0
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x)
        x = F.max_pool2d(x, kernel_size=3, stride=2)
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = F.max_pool2d(x, kernel_size=3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        pool3 = torch.mean(x, dim=(2, 3))
        return pool3, self.fc(pool3)


def load_inception(path: Optional[str] = None, device="cuda",
                   antialias: bool = True) -> InceptionV3FID:
    """The network with the FID weights from ``path``, else
    ``$INCEPTION_WEIGHTS``, else ``third_party/fid/``, in eval mode on
    ``device`` (channels-last on the card)."""
    from contrad_tpu_torch import resolve_device

    device = resolve_device(device)
    path = path or os.environ.get("INCEPTION_WEIGHTS", DEFAULT_WEIGHTS)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"Inception FID weights not found at {path}. Download "
            f"pt_inception-2015-12-05-6726825d.pth (pytorch-fid) and place it "
            f"there, or set $INCEPTION_WEIGHTS.")
    state = torch.load(path, map_location="cpu", weights_only=True)
    return from_state_dict(state, device, antialias)


def from_state_dict(state, device="cuda", antialias: bool = True
                    ) -> InceptionV3FID:
    """The network with the weights ``state`` (the checkpoint's keys; its
    ``num_batches_tracked`` entries are ignored), eval mode, on
    ``device``."""
    model = InceptionV3FID(antialias=antialias)
    model.load_state_dict({k: v for k, v in state.items()
                           if not k.endswith("num_batches_tracked")})
    model = model.to(device).eval().requires_grad_(False)
    if torch.device(device).type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def _batched(forward: Callable[[torch.Tensor], torch.Tensor], device,
             per_device_batch: int) -> Callable[[np.ndarray], np.ndarray]:
    """``forward`` over NHWC uint8 or float images on the host, in batches
    of at most ``per_device_batch`` on ``device``, back as numpy."""

    def run(images: np.ndarray) -> np.ndarray:
        out = []
        with torch.no_grad():
            for i in range(0, len(images), per_device_batch):
                x = torch.from_numpy(np.ascontiguousarray(
                    images[i: i + per_device_batch])).to(device)
                x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
                out.append(forward(x).float().cpu().numpy())
        return np.concatenate(out, axis=0)

    return run


def get_inception_embed_fn(path: Optional[str] = None,
                           per_device_batch: int = 256, device="cuda",
                           model: Optional[InceptionV3FID] = None,
                           antialias: bool = True):
    """``embed_fn(images uint8/float NHWC) -> np (n, 2048)`` pool3
    features. At most ``per_device_batch`` images go to the card at a time:
    the 299^2 network holds about 5.6 MB of activations an image."""
    model = model or load_inception(path, device, antialias)
    device = next(model.parameters()).device
    return _batched(lambda x: model(x)[0], device, per_device_batch)


def get_inception_logits_fn(path: Optional[str] = None, device="cuda",
                            per_device_batch: int = 256,
                            model: Optional[InceptionV3FID] = None,
                            antialias: bool = True):
    """``probs_fn(images) -> np (n, 1008)`` class probabilities (for IS),
    batched as :func:`get_inception_embed_fn`."""
    model = model or load_inception(path, device, antialias)
    device = next(model.parameters()).device
    return _batched(lambda x: F.softmax(model(x)[1].float(), dim=-1), device,
                    per_device_batch)
