"""SNDCGAN and StyleGAN2 with ContraD's discriminator heads, in plain
PyTorch: functions of a dict of parameters (named as the program's
``state_dict`` names them, so that one set of weights serves both) and of
the layers' state (spectral norm's ``u``, batch norm's running statistics).

SNDCGAN (Miyato et al. 2018; ContraD ``models/gan/sndcgan.py``):
  G: z (U(-1, 1)^128) -> dense -> BN -> ReLU -> 3 x (4x4/2 transposed conv,
     BN, ReLU) -> 3x3 conv -> tanh, rescaled to [0, 1]; BN in train mode
     normalises with the batch's biased variance, running statistics move by
     0.1 of the batch's.
  D: x * 2 - 1 -> 7 spectrally normalised convs, LeakyReLU(0.1) -> the
     features flattened (h, w, c).
StyleGAN2 (Karras et al. 2020; ContraD ``models/gan/stylegan2``): the
style MLP (pixel norm, equalised dense layers at lr_mul 0.01), modulated
and demodulated 3x3 convs with noise and biased leaky ReLU (gain sqrt 2),
upsampling by a transposed conv then the [1, 3, 3, 1] blur, the skip ToRGB
chain; D of residual blocks (blur before the stride-2 conv, 1/sqrt 2), the
minibatch standard deviation over groups of 4 and a last 3x3 conv.
Heads (ContraD ``models/gan/base.py``): the GAN score MLP (hidden width
``d_hidden``, LeakyReLU 0.1) and two projection MLPs to 128, spectrally
normalised on SNDCGAN.

Spectral norm: one power iteration a pass from the stored ``u``,
``v = normalise(Wᵀu)``, ``u' = normalise(W v)``, ``sigma = u'·(W v)``, the
gradient through ``W`` alone; ``u'`` is kept once the phase's main pass is
done.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
SQRT2 = math.sqrt(2.0)


# ------------------------------------------------------------------ layers

def normalise(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


def sn_weight(w: torch.Tensor, u: torch.Tensor, staged: Optional[dict],
              key: str) -> torch.Tensor:
    """``w / sigma`` by one power iteration from ``u``; the new ``u`` goes
    to ``staged[key]`` where ``staged`` is given."""
    w2 = w.reshape(w.shape[0], -1)
    with torch.no_grad():
        v = normalise(w2.t() @ u)
    wv = w2 @ v
    u_new = normalise(wv.detach())
    if staged is not None:
        staged[key] = u_new
    return (w2 / torch.dot(u_new, wv)).reshape(w.shape)


def batch_norm(x, p: Params, state: Params, key: str, momentum=0.9,
               eps=1e-5):
    dims = [0] + list(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=dims, correction=0)
    with torch.no_grad():
        state[key + ".running_mean"].mul_(momentum).add_(
            (1 - momentum) * mean)
        state[key + ".running_var"].mul_(momentum).add_((1 - momentum) * var)
    shape = [1, -1] + [1] * (x.dim() - 2)
    xh = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
    return xh * p[key + ".weight"].reshape(shape) + p[key + ".bias"].reshape(
        shape)


def dense(x, p: Params, key: str, state: Optional[Params] = None,
          staged: Optional[dict] = None):
    """``x Wᵀ + b``; spectrally normalised where ``state`` holds a ``u``."""
    w = p[key + ".weight"]
    if state is not None and key + ".u" in state:
        w = sn_weight(w, state[key + ".u"], staged, key + ".u")
    return F.linear(x, w, p.get(key + ".bias"))


def l2_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                           min=1e-12)


def heads(feats, p: Params, state: Params, staged, sg_linear: bool):
    """(GAN score, projection, projection2) of the features."""
    f_lin = feats.detach() if sg_linear else feats
    h = F.leaky_relu(dense(f_lin, p, "linear.l1", state, staged), 0.1)
    d = dense(h, p, "linear.l2", state, staged)

    def mlp(name):
        h = F.leaky_relu(dense(feats, p, name + ".fc1", state, staged), 0.1)
        return dense(h, p, name + ".fc2", state, staged)

    return d, mlp("projection"), mlp("projection2")


def head_spec(n_features: int, d_hidden: int, init) -> list:
    spec = []
    for name, (i, o) in (("linear.l1", (n_features, d_hidden)),
                         ("linear.l2", (d_hidden, 1)),
                         ("projection.fc1", (n_features, d_hidden)),
                         ("projection.fc2", (d_hidden, 128)),
                         ("projection2.fc1", (n_features, d_hidden)),
                         ("projection2.fc2", (d_hidden, 128))):
        spec += [(name + ".weight", (o, i), init(i)),
                 (name + ".bias", (o,), ("zeros",))]
    return spec


# ------------------------------------------------------------------ SNDCGAN

class SNDCGAN:
    """``cfg``: ``image_size``, ``ngf``, ``ndf``, ``nz``, ``d_hidden``."""

    def __init__(self, cfg: dict):
        self.size = cfg["image_size"]
        self.ngf, self.ndf, self.nz = cfg["ngf"], cfg["ndf"], cfg["nz"]
        self.d_hidden = cfg["d_hidden"]
        f = self.ndf
        self.d_layers = ((3, f, 3, 1), (f, 2 * f, 4, 2), (2 * f, 2 * f, 3, 1),
                         (2 * f, 4 * f, 4, 2), (4 * f, 4 * f, 3, 1),
                         (4 * f, 8 * f, 4, 2), (8 * f, 8 * f, 3, 1))

    def g_spec(self) -> list:
        g, s = self.ngf, self.size // 8
        width = 8 * g * s * s
        n02 = ("normal", 0.02)
        spec = [("linear.weight", (width, self.nz), n02),
                ("linear.bias", (width,), ("zeros",))]
        spec += bn_spec("norm_init", width)
        chans = (8 * g, 4 * g, 2 * g, g)
        for i in range(3):
            spec += [(f"up{i}.weight", (chans[i], chans[i + 1], 4, 4), n02),
                     (f"up{i}.bias", (chans[i + 1],), ("zeros",))]
            spec += bn_spec(f"norm{i}", chans[i + 1])
        spec += [("to_rgb.weight", (3, g, 3, 3), n02),
                 ("to_rgb.bias", (3,), ("zeros",))]
        return spec

    def d_spec(self) -> list:
        n02 = ("normal", 0.02)
        spec = []
        for i, (cin, cout, k, _) in enumerate(self.d_layers):
            spec += [(f"backbone.c{i}.weight", (cout, cin, k, k), n02),
                     (f"backbone.c{i}.bias", (cout,), ("zeros",)),
                     (f"backbone.c{i}.u", (cout,), ("unit",))]
        for name, shape, init in head_spec(self.n_features, self.d_hidden,
                                           lambda i: n02):
            spec.append((name, shape, init))
            if name.endswith(".weight"):
                spec.append((name[:-len("weight")] + "u", shape[:1], ("unit",)))
        return spec

    @property
    def n_features(self) -> int:
        return 8 * self.ndf * (self.size // 8) ** 2

    def sample_z(self, n: int, r) -> Dict:
        return {"z": r.rand((n, self.nz)) * 2.0 - 1.0}

    def generator(self, p: Params, state: Params, draws: Dict):
        x = F.linear(draws["z"], p["linear.weight"], p["linear.bias"])
        x = F.relu(batch_norm(x, p, state, "norm_init"))
        s = self.size // 8
        x = x.reshape(-1, 8 * self.ngf, s, s)
        for i in range(3):
            x = F.conv_transpose2d(x, p[f"up{i}.weight"], p[f"up{i}.bias"],
                                   stride=2, padding=1)
            x = F.relu(batch_norm(x, p, state, f"norm{i}"))
        x = F.conv2d(x, p["to_rgb.weight"], p["to_rgb.bias"], padding=1)
        return (0.5 * torch.tanh(x) + 0.5).permute(0, 2, 3, 1)

    def discriminator(self, p: Params, state: Params, x, staged=None,
                      sg_linear: bool = False):
        x = (x * 2.0 - 1.0).permute(0, 3, 1, 2)
        for i, (_, _, _, stride) in enumerate(self.d_layers):
            key = f"backbone.c{i}"
            w = sn_weight(p[key + ".weight"], state[key + ".u"], staged,
                          key + ".u")
            x = F.leaky_relu(F.conv2d(x, w, p[key + ".bias"], stride, 1), 0.1)
        feats = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return heads(feats, p, state, staged, sg_linear)


def bn_spec(key: str, n: int) -> list:
    return [(key + ".weight", (n,), ("ones",)), (key + ".bias", (n,), ("zeros",)),
            (key + ".running_mean", (n,), ("zeros",)),
            (key + ".running_var", (n,), ("ones",))]


# ------------------------------------------------------------------ StyleGAN2

BLUR_1D = (0.125, 0.375, 0.375, 0.125)  # [1, 3, 3, 1] / 8; the blur is its outer square


def upfirdn(x: torch.Tensor, up: int, pad: Tuple[int, int],
            gain: float = 1.0) -> torch.Tensor:
    """NCHW: insert ``up - 1`` zeros after each sample, pad both spatial
    dims by ``pad`` (negative crops), correlate each channel with the 4x4
    blur times ``gain``, as its two 1-D factors: sums of shifted slices,
    whose gradient of a gradient (R1's) is as plain as their forward."""
    if up > 1:
        n, c, h, w = x.shape
        z = x.new_zeros(n, c, h, up, w, up)
        z[:, :, :, 0, :, 0] = x
        x = z.reshape(n, c, h * up, w * up)
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    taps = [t * math.sqrt(gain) for t in BLUR_1D]
    return fir(fir(x, taps, 2), taps, 3)


def fir(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """Correlation of ``x`` with ``taps`` along ``dim`` (valid part)."""
    n = x.shape[dim] - len(taps) + 1
    out = taps[0] * x.narrow(dim, 0, n)
    for i, t in enumerate(taps[1:], 1):
        out = out + t * x.narrow(dim, i, n)
    return out


def per_channel(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Each channel of NCHW ``x`` correlated with the 2-D filter ``k``, one
    channel an image."""
    n, c, h, w = x.shape
    y = F.conv2d(x.reshape(n * c, 1, h, w), k[None, None])
    return y.reshape(n, c, y.shape[2], y.shape[3])


def lrelu(x, bias):
    return F.leaky_relu(x + bias.reshape(1, -1, 1, 1), 0.2) * SQRT2


class StyleGAN2:
    """``cfg``: ``image_size``, ``channels`` (resolution -> width),
    ``n_mlp``, ``style_dim``, ``lr_mlp``, ``d_hidden``, ``style_mix``."""

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


def make_model(cfg: dict):
    family = cfg["family"]
    if family == "sndcgan":
        return SNDCGAN(cfg)
    if family == "stylegan2":
        return StyleGAN2(cfg)
    raise ValueError(f"unknown model family {family!r}")
