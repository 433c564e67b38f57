"""StyleGAN2 (Karras et al. 2020; ContraD ``models/gan/stylegan2``) with
ContraD's discriminator heads; it follows the ``train_stylegan2`` step
(``step = "ema_r1"``: G's EMA, R1 at the recipe's cadence) and has no
buffers.

The style MLP (pixel norm, equalised dense layers at lr_mul 0.01),
modulated and demodulated 3x3 convs with noise and biased leaky ReLU (gain
sqrt 2), upsampling by a transposed conv then the [1, 3, 3, 1] blur, the
skip ToRGB chain; D of residual blocks (blur before the stride-2 conv,
1/sqrt 2), the minibatch standard deviation over groups of 4 and a last
3x3 conv.

Its kernel tables: where a train step runs the program's blur kernel and
its fused bias + leaky ReLU + gain (``blur_launches``,
``fused_act_launches``), from the shapes alone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.families import Family
from benchmark.reference.nets import (
    SQRT2, Params, head_spec, heads, lrelu, upfirdn)


class StyleGAN2(Family):
    """``cfg``: ``image_size``, ``channels`` (resolution -> width),
    ``n_mlp``, ``style_dim``, ``lr_mlp``, ``d_hidden``, ``style_mix``."""

    step = "ema_r1"

    def __init__(self, cfg: dict):
        self.size = cfg["image_size"]
        self.ch = {int(k): v for k, v in cfg["channels"].items()}
        self.n_mlp, self.style_dim = cfg["n_mlp"], cfg["style_dim"]
        self.lr_mlp, self.d_hidden = cfg["lr_mlp"], cfg["d_hidden"]
        self.style_mix = cfg["style_mix"]
        self.log_size = int(math.log2(self.size))
        self.n_latent = 2 * self.log_size - 2

    # ------------------------------------------------------------- specs

    def g_spec(self) -> list:
        sd, n1 = self.style_dim, ("normal", 1.0)
        spec = []
        for i in range(self.n_mlp):
            spec += [(f"style.{i}.weight", (sd, sd), ("normal", 1 / self.lr_mlp)),
                     (f"style.{i}.bias", (sd,), ("zeros",))]
        spec.append(("input.const", (1, 4, 4, self.ch[4]), n1))

        def layer(key, cin, cout, noise=True, k=3):
            out = [(key + ".conv.weight", (cout, cin, k, k), n1),
                   (key + ".conv.modulation.weight", (cin, sd), n1),
                   (key + ".conv.modulation.bias", (cin,), ("zeros",))]
            if noise:
                out += [(key + ".noise.weight", (), ("zeros",)),
                        (key + ".activate.bias", (cout,), ("zeros",))]
            else:
                out.append((key + ".bias", (1, 1, 1, 3), ("zeros",)))
            return out

        spec += layer("conv1", self.ch[4], self.ch[4])
        spec += layer("to_rgb1", self.ch[4], 3, noise=False, k=1)
        cin = self.ch[4]
        for i in range(3, self.log_size + 1):
            cout = self.ch[2**i]
            j = i - 3
            spec += layer(f"layers.{2 * j}", cin, cout)
            spec += layer(f"layers.{2 * j + 1}", cout, cout)
            spec += layer(f"to_rgbs.{j}", cout, 3, noise=False, k=1)
            cin = cout
        return spec

    def d_spec(self) -> list:
        n1, ch = ("normal", 1.0), self.ch
        spec = [("backbone.from_rgb.conv.conv.weight", (ch[self.size], 3, 1, 1),
                 n1),
                ("backbone.from_rgb.conv.act.bias", (ch[self.size],),
                 ("zeros",))]
        for i in range(self.log_size, 2, -1):
            b, cin, cout = f"backbone.block_{2**i}", ch[2**i], ch[2**(i - 1)]
            spec += [(b + ".conv1.conv.weight", (cin, cin, 3, 3), n1),
                     (b + ".conv1.act.bias", (cin,), ("zeros",)),
                     (b + ".conv2.conv.weight", (cout, cin, 3, 3), n1),
                     (b + ".conv2.act.bias", (cout,), ("zeros",)),
                     (b + ".skip.conv.weight", (cout, cin, 1, 1), n1)]
        spec += [("backbone.last_conv.conv.weight", (ch[4], ch[4] + 1, 3, 3),
                  n1),
                 ("backbone.last_conv.act.bias", (ch[4],), ("zeros",))]
        # lecun normal: variance 1 / fan_in, truncated at two deviations
        return spec + head_spec(self.n_features, self.d_hidden,
                                lambda i: ("trunc", 1.0 / math.sqrt(i)))

    @property
    def n_features(self) -> int:
        return self.ch[4] * 16

    # ------------------------------------------------------------- kernels

    def blur_launches(self, batch: int) -> List:
        """Every blur of a train step (``counts/blur.py``'s rows). Per G
        forward: one blur after each upsampling transposed conv, on its
        (2s + 1)-square output, pads (1, 1), taps x4; per D forward: two per
        residual block, before the stride-2 3x3 conv (pads (2, 2)) and
        before the stride-2 1x1 skip (pads (1, 1)), on the block's input.
        Each forward launch has an adjoint launch in the backward: the
        gradient's shape, pads (3 - pad0, 3 - pad1). A step runs G once (G
        phase), D at 3 x batch (the contrastive D pass) and at batch (the G
        phase), and with R1 D twice more each way at batch (R1's pass and
        its double backward)."""
        ch, size = self.ch, self.size
        fwd = []
        s = 4
        while 2 * s <= size:
            fwd.append(((batch, 2 * s + 1, 2 * s + 1, ch[2 * s]), (1, 1), 2,
                        {"plain": 1, "r1": 1}))
            s *= 2
        for n, plain, r1 in ((3 * batch, 1, 1), (batch, 1, 3)):
            s = size
            while s > 4:
                for pad in ((2, 2), (1, 1)):
                    fwd.append(((n, s, s, ch[s]), pad, 1,
                                {"plain": plain, "r1": r1}))
                s //= 2
        adj = [((n, h + sum(pad) - 3, w + sum(pad) - 3, c),
                (3 - pad[0], 3 - pad[1]), up, per)
               for (n, h, w, c), pad, up, per in fwd]
        return fwd + adj

    def _act_sites(self, n: int, d: bool) -> List[Tuple[int, ...]]:
        """The shapes of the biased leaky ReLUs of one G forward at batch
        ``n`` (the style MLP of ``z`` and of ``z_mix``, then each styled
        conv), or of one D forward (FromRGB, the two convs of each
        residual block, the last conv)."""
        if d:
            out = [(n, self.size, self.size, self.ch[self.size])]
            for i in range(self.log_size, 2, -1):
                out += [(n, 2**i, 2**i, self.ch[2**i]),
                        (n, 2**(i - 1), 2**(i - 1), self.ch[2**(i - 1)])]
            return out + [(n, 4, 4, self.ch[4])]
        out = [(n, self.style_dim)] * (2 * self.n_mlp)
        out.append((n, 4, 4, self.ch[4]))
        for i in range(3, self.log_size + 1):
            out += [(n, 2**i, 2**i, self.ch[2**i])] * 2
        return out

    def fused_act_launches(self, batch: int) -> List:
        """Every launch of the fused activation in a train step
        (``counts/fused_act.py``'s rows). Each site's forward is one
        ``act``; its gradient one ``grad`` and, every bias being trained,
        one ``bias_sum``. A step runs G once and D at 3 x batch and at
        batch; an R1 step adds, on each D site at batch, R1's forward (an
        ``act``), its input gradient (a ``grad`` and a ``bias_sum``), and
        in the double backward the gradient's own adjoint (a ``grad``, no
        bias) and the way back through R1's forward (a ``grad`` and a
        ``bias_sum``)."""
        every = {"plain": 1, "r1": 1}
        rows = []
        for shape in (self._act_sites(batch, False)
                      + self._act_sites(3 * batch, True)
                      + self._act_sites(batch, True)):
            rows += [(shape, "act", every), (shape, "grad", every),
                     (shape, "bias_sum", every)]
        for shape in self._act_sites(batch, True):
            rows += [(shape, "act", {"plain": 0, "r1": 1}),
                     (shape, "grad", {"plain": 0, "r1": 3}),
                     (shape, "bias_sum", {"plain": 0, "r1": 2})]
        return rows

    # ------------------------------------------------------------- draws

    def noise_shapes(self, n: int) -> List[Tuple[int, ...]]:
        shapes = [(n, 4, 4, 1)]
        for i in range(3, self.log_size + 1):
            shapes += [(n, 2**i, 2**i, 1)] * 2
        return shapes

    def sample_z(self, n: int, r) -> Dict:
        z = r.randn((n, self.style_dim))
        noise = [r.randn(s) for s in self.noise_shapes(n)]
        nomix = r.rand((n,)) >= self.style_mix
        layer = r.randint(0, self.n_latent, (n,))
        z_mix = r.randn((n, self.style_dim))
        return {"z": z, "noise": noise,
                "mix_layer": torch.where(nomix, self.n_latent, layer),
                "z_mix": z_mix}

    # ------------------------------------------------------------- G

    def styles(self, p: Params, z):
        x = z * torch.rsqrt(torch.mean(z**2, dim=-1, keepdim=True) + 1e-8)
        scale = self.lr_mlp / math.sqrt(self.style_dim)
        for i in range(self.n_mlp):
            x = F.linear(x, p[f"style.{i}.weight"] * scale)
            x = F.leaky_relu(x + p[f"style.{i}.bias"] * self.lr_mlp, 0.2) * SQRT2
        return x

    def modconv(self, p: Params, key: str, x, style, demod=True,
                upsample=False):
        """NCHW ``x``; the style scales the input channels, the
        demodulation the output's."""
        w = p[key + ".weight"]
        cout, cin, k, _ = w.shape
        w = w / math.sqrt(cin * k * k)
        s = F.linear(style, p[key + ".modulation.weight"] / math.sqrt(
            self.style_dim)) + p[key + ".modulation.bias"] + 1.0
        x = x * s[:, :, None, None]
        if upsample:  # the transposed conv of JAX, which does not flip w
            y = F.conv_transpose2d(x, w.transpose(0, 1).flip(2, 3), stride=2)
        else:
            y = F.conv2d(x, w, padding=k // 2)
        if demod:
            d = torch.rsqrt(s**2 @ (w**2).sum((2, 3)).t() + 1e-8)
            y = y * d[:, :, None, None]
        if upsample:
            y = upfirdn(y, 1, (1, 1), gain=4.0)
        return y

    def style_layer(self, p, key, x, style, noise, upsample=False):
        y = self.modconv(p, key + ".conv", x, style, upsample=upsample)
        y = y + p[key + ".noise.weight"] * noise.permute(0, 3, 1, 2)
        return lrelu(y, p[key + ".activate.bias"])

    def to_rgb(self, p, key, x, style, skip):
        y = self.modconv(p, key + ".conv", x, style, demod=False)
        y = y + p[key + ".bias"].permute(0, 3, 1, 2)
        if skip is not None:
            y = y + upfirdn(skip, 2, (2, 1), gain=4.0)
        return y

    def generator(self, p: Params, state: Params, draws: Dict):
        w = self.styles(p, draws["z"])
        w_mix = self.styles(p, draws["z_mix"])
        idx = torch.arange(self.n_latent, device=w.device)[None, :]
        keep = (idx < draws["mix_layer"][:, None]).to(w.dtype)[..., None]
        lat = w[:, None, :] * keep + w_mix[:, None, :] * (1.0 - keep)
        noise = draws["noise"]
        n = lat.shape[0]
        x = p["input.const"].permute(0, 3, 1, 2).expand(n, -1, -1, -1)
        x = self.style_layer(p, "conv1", x, lat[:, 0], noise[0])
        skip = self.to_rgb(p, "to_rgb1", x, lat[:, 1], None)
        j = 1
        for i in range(self.log_size - 2):
            x = self.style_layer(p, f"layers.{2 * i}", x, lat[:, j],
                                 noise[1 + 2 * i], upsample=True)
            x = self.style_layer(p, f"layers.{2 * i + 1}", x, lat[:, j + 1],
                                 noise[2 + 2 * i])
            skip = self.to_rgb(p, f"to_rgbs.{i}", x, lat[:, j + 2], skip)
            j += 2
        return (0.5 * skip + 0.5).permute(0, 2, 3, 1)

    # ------------------------------------------------------------- D

    def conv(self, p, key, x, stride=1, padding=0):
        w = p[key + ".weight"]
        return F.conv2d(x, w / math.sqrt(w[0].numel()), stride=stride,
                        padding=padding)

    def discriminator(self, p: Params, state: Params, x, staged=None,
                      sg_linear: bool = False):
        x = (x * 2.0 - 1.0).permute(0, 3, 1, 2)
        b = "backbone."
        x = lrelu(self.conv(p, b + "from_rgb.conv.conv", x),
                  p[b + "from_rgb.conv.act.bias"])
        for i in range(self.log_size, 2, -1):
            k = f"{b}block_{2**i}."
            y = lrelu(self.conv(p, k + "conv1.conv", x, padding=1),
                      p[k + "conv1.act.bias"])
            y = lrelu(self.conv(p, k + "conv2.conv", upfirdn(y, 1, (2, 2)),
                                stride=2), p[k + "conv2.act.bias"])
            s = self.conv(p, k + "skip.conv", upfirdn(x, 1, (1, 1)), stride=2)
            x = (y + s) / SQRT2
        n, c, h, w = x.shape
        g = min(n, 4)
        std = torch.sqrt(x.reshape(n // g, g, c, h, w).var(1, unbiased=False)
                         + 1e-8).mean((1, 2, 3))
        x = torch.cat([x, std.repeat_interleave(g)[:, None, None, None]
                       .expand(n, 1, h, w)], 1)
        x = lrelu(self.conv(p, b + "last_conv.conv", x, padding=1),
                  p[b + "last_conv.act.bias"])
        feats = x.permute(0, 2, 3, 1).reshape(n, -1)
        return heads(feats, p, state, staged, sg_linear)


MODEL = StyleGAN2
