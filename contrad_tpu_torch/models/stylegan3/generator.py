"""StyleGAN3-T's generator (Karras et al. 2021, "Alias-Free Generative
Adversarial Networks", arXiv:2106.12423; NVlabs ``stylegan3``,
``training/networks_stylegan3.py``, ``train.py --cfg=stylegan3-t``), in
NHWC as the rest of the port.

* **Mapping**: ``z`` normalised by its second moment, two equalised dense
  layers at ``lr_mul`` 0.01 with a biased leaky ReLU times sqrt 2 (the
  port's fused activation); ``w_avg``, the EMA (beta 0.998) of the batch
  mean of ``w``, is kept for truncation; ``w`` is broadcast to one row per
  layer: row 0 to the input, then one per layer and ToRGB.
* **Input**: Fourier features of fixed frequencies and phases (buffers
  drawn at init), rotated and translated per sample by an affine map of
  ``w`` (weight 0, bias [1, 0, 0, 0] at init), damped out of band, on a
  grid of ``size`` points spanning ``size / sampling_rate``, then a
  trainable ``channels x channels`` map.
* **Layers** (:func:`synthesis_schedule`, the published geometric
  schedules of cutoff, stopband, sampling rate, size and width): the
  magnitude EMA of the input gives its gain; the styles and the weight are
  normalised (the styles over the whole batch and every channel); a
  modulated, demodulated 3x3 conv with full padding; then the filtered
  leaky ReLU (``ops/filtered_lrelu.py``, the hand-written kernel on the
  card) with the layer's Kaiser filters and padding, clamped at 256. ToRGB
  is a 1x1 modulated conv (styles times ``1/sqrt(c_in)``, no
  demodulation) with a bias and the clamp. The image is the last layer
  times 0.25, mapped to [0, 1] as :class:`GStylegan2`'s.

Departures from NVlabs:

* the layers are ``synthesis.layers.<i>`` (NVlabs ``L<i>_<size>_<c>``),
  and the mapping's layers ``mapping.fc<i>`` as NVlabs';
* the modulated conv scales the conv's input by the styles and the input
  gain and its output by the demodulation, rather than one grouped conv of
  per-sample weights: the same function. Its autograd ``Function`` saves
  only the layer's input and remakes the rest in the backward, and it pads
  the channels to a multiple of 32 for cuDNN (``_conv``); ToRGB's 1x1 conv
  is a product over channels;
* the EMA buffers (``w_avg``, each ``magnitude_ema``) update in every
  forward with ``train=True``: ContraD's ``ema_r1`` step makes one G
  forward a step, whose fakes serve G's loss and D's, so they update there
  (NVlabs updates them in its ``Dmain`` pass). A magnitude first takes the
  batch's mean square into the EMA, then the EMA gives the gain; both are
  taken over the global batch in a world of processes, as are the styles'
  normalisation and ``w_avg``'s mean (``parallel.all_reduce_sum``);
* no noise inputs and no style mixing (NVlabs' loss mixes styles only for
  ``--cfg=stylegan2``); no truncation in training;
* float32 throughout, with cuDNN's TF32 convolutions (NVlabs runs its four
  highest resolutions in float16). Under a bfloat16 compute dtype the
  convolutions and the kernel's input and output are bfloat16; the
  mapping, the Fourier features, the styles, the normalisations, the
  demodulation and the EMAs stay float32;
* ``magnitude_ema_beta`` is NVlabs ``train.py``'s ``0.5 ** (batch /
  20000)`` where the registry is given the batch, else the layer's default
  0.999;
* the filters are no buffers: each layer keeps its taps on the host
  (``fu``, ``fd``), remade from the schedule, since a step captured in a
  CUDA graph launches the kernel with them and cannot read a device tensor
  on the host.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from contrad_tpu_torch import at_least_f32, cast
from contrad_tpu_torch.ops.filtered_lrelu import filtered_lrelu, lowpass_filter
from contrad_tpu_torch.ops.fused_act import fused_leaky_relu
from contrad_tpu_torch.parallel.collectives import all_reduce_sum
from contrad_tpu_torch.parallel.mesh import data_shard


# Convolutions pad their channels to a multiple of this with zeros: cuDNN
# runs StyleGAN3-T's 512 -> 483 conv at 148x148 through a generic engine
# unless the channels come in 32s (351 ms forward and backward at batch 16
# on the H100 as they are, 350 padded to 8s or 16s, 37 padded to 32s).
CHANNEL_ALIGN = 32


def _conv(x: torch.Tensor, w: torch.Tensor, padding: int) -> torch.Tensor:
    """NHWC ``x`` convolved with OIHW ``w`` (a 1x1 ``w`` as a product over
    channels), its channels zero-padded to a multiple of ``CHANNEL_ALIGN``
    for the library and the padding's outputs dropped."""
    cout, cin = w.shape[:2]
    if w.shape[2] == 1:
        return F.linear(x, w.reshape(cout, cin))
    pin, pout = -cin % CHANNEL_ALIGN, -cout % CHANNEL_ALIGN
    if pin:
        x = F.pad(x, (0, pin))
    if pin or pout:
        w = F.pad(w, (0, 0, 0, 0, 0, pin, 0, pout))
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=padding)
    y = y.permute(0, 2, 3, 1)
    return y[..., :cout] if pout else y


class _ModulatedConv(torch.autograd.Function):
    """``y = conv(x * a, w) * d``: NHWC ``x``, per-sample input scales ``a``
    (N, C), OIHW ``w``, per-sample output scales ``d`` (N, O) or None (all
    in x's dtype). It saves only ``x`` (and the small ``a``, ``w``, ``d``):
    the backward remakes ``x * a`` and, for ``d``'s gradient, the conv's
    output; autograd's own graph would hold three tensors of a layer's size
    (44 GB at batch 16 at 512x512, where this holds 11.5)."""

    @staticmethod
    def forward(ctx, x, a, w, d, padding):
        y = _conv(x * a[:, None, None, :], w, padding)
        ctx.save_for_backward(x, a, w, d)
        ctx.padding = padding
        return y if d is None else y * d[:, None, None, :]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, a, w, d = ctx.saved_tensors
        with torch.enable_grad():
            xm = (x * a[:, None, None, :]).detach().requires_grad_(True)
            wd = w.detach().requires_grad_(True)
            y = _conv(xm, wd, ctx.padding)
        gy = g if d is None else g * d[:, None, None, :]
        dxm, dw = torch.autograd.grad(y, (xm, wd), gy)
        wide = torch.promote_types(x.dtype, torch.float32)
        dd = None
        if d is not None and ctx.needs_input_grad[3]:
            dd = (g * y.detach()).sum((1, 2), dtype=wide).to(d.dtype)
        da = (dxm * x).sum((1, 2), dtype=wide).to(a.dtype)
        return dxm * a[:, None, None, :], da, dw, dd, None


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element of ``x`` over the global batch whose rows,
    an equal number on each rank, are ``x`` here; differentiable."""
    return all_reduce_sum(x.mean()) / data_shard()[1]


def synthesis_schedule(resolution: int, channel_base: int = 32768,
                       channel_max: int = 512, num_layers: int = 14,
                       num_critical: int = 2, first_cutoff: float = 2.0,
                       first_stopband: float = 2**2.1,
                       last_stopband_rel: float = 2**0.3,
                       margin_size: int = 10, filter_size: int = 6,
                       lrelu_upsampling: int = 2, conv_kernel: int = 3,
                       img_channels: int = 3) -> List[Dict]:
    """The synthesis network's layers (NVlabs ``SynthesisNetwork`` and
    ``SynthesisLayer.__init__``): entry 0 is the input's (``channels``,
    ``size``, ``rate``, ``cutoff``), then one per layer, the last ToRGB,
    with its widths, sizes, rates, cutoffs, half widths, up and down
    factors, taps and ``padding`` ``(x_lo, x_hi, y_lo, y_hi)``."""
    exponents = np.minimum(np.arange(num_layers + 1)
                           / (num_layers - num_critical), 1)
    last_cutoff = resolution / 2
    cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
    stopbands = first_stopband * (last_cutoff * last_stopband_rel
                                  / first_stopband) ** exponents
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, resolution))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + margin_size * 2
    sizes[-2:] = resolution
    channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
    channels[-1] = img_channels
    out = [dict(channels=int(channels[0]), size=int(sizes[0]),
                rate=float(rates[0]), cutoff=float(cutoffs[0]))]
    for idx in range(num_layers + 1):
        prev = max(idx - 1, 0)
        torgb = idx == num_layers
        rate_in, rate_out = int(rates[prev]), int(rates[idx])
        tmp = max(rate_in, rate_out) * (1 if torgb else lrelu_upsampling)
        up, down = tmp // rate_in, tmp // rate_out
        k = 1 if torgb else conv_kernel
        taps_up = filter_size * up if up > 1 and not torgb else 1
        taps_down = filter_size * down if down > 1 and not torgb else 1
        size_in, size_out = int(sizes[prev]), int(sizes[idx])
        pad_total = ((size_out - 1) * down + 1 - (size_in + k - 1) * up
                     + taps_up + taps_down - 2)
        pad_lo = (pad_total + up) // 2
        pad_hi = pad_total - pad_lo
        out.append(dict(
            torgb=torgb, critical=idx >= num_layers - num_critical,
            in_channels=int(channels[prev]), out_channels=int(channels[idx]),
            in_size=size_in, out_size=size_out, in_rate=rate_in,
            out_rate=rate_out, tmp_rate=tmp, in_cutoff=float(cutoffs[prev]),
            out_cutoff=float(cutoffs[idx]),
            in_half_width=float(half_widths[prev]),
            out_half_width=float(half_widths[idx]), up=up, down=down,
            taps_up=taps_up, taps_down=taps_down, kernel=k,
            padding=(pad_lo, pad_hi, pad_lo, pad_hi)))
    return out


class Dense(nn.Module):
    """NVlabs' ``FullyConnectedLayer``: weight drawn ``N(0, 1) * init /
    lr_mul``, bias ``bias_init / lr_mul``; at run time the weight times
    ``lr_mul / sqrt(in)`` and the bias times ``lr_mul``; a biased leaky ReLU
    times sqrt 2 where ``activation``. Float32."""

    def __init__(self, in_dim: int, features: int, activation: bool = False,
                 lr_mul: float = 1.0, weight_init: float = 1.0,
                 bias_init=0.0):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(features, in_dim)
                                   * (weight_init / lr_mul))
        self.bias = nn.Parameter(torch.as_tensor(
            np.broadcast_to(np.asarray(bias_init, np.float32), [features])
            / lr_mul).clone())
        self.weight_gain = lr_mul / math.sqrt(in_dim)
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight * self.weight_gain)
        b = self.bias * self.lr_mul
        return fused_leaky_relu(y, b) if self.activation else y + b


class MappingNetwork(nn.Module):
    """z -> w (see the module docstring)."""

    def __init__(self, z_dim: int, w_dim: int, num_ws: int,
                 num_layers: int = 2, lr_mul: float = 0.01,
                 w_avg_beta: float = 0.998):
        super().__init__()
        self.num_ws, self.w_avg_beta = num_ws, w_avg_beta
        for i in range(num_layers):
            self.add_module(f"fc{i}", Dense(z_dim if i == 0 else w_dim, w_dim,
                                            activation=True, lr_mul=lr_mul))
        self.num_layers = num_layers
        self.register_buffer("w_avg", torch.zeros(w_dim))

    def forward(self, z: torch.Tensor, update_emas: bool = False):
        x = z * torch.rsqrt(torch.mean(z**2, dim=1, keepdim=True) + 1e-8)
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        if update_emas:
            with torch.no_grad():
                mean = all_reduce_sum(x.mean(0)) / data_shard()[1]
                self.w_avg.copy_(mean.lerp(self.w_avg, self.w_avg_beta))
        return x[:, None, :].expand(-1, self.num_ws, -1)


class SynthesisInput(nn.Module):
    """The Fourier-feature input (see the module docstring); NHWC out,
    float32."""

    def __init__(self, w_dim: int, channels: int, size: int,
                 sampling_rate: float, bandwidth: float):
        super().__init__()
        self.channels, self.size = channels, size
        self.sampling_rate, self.bandwidth = sampling_rate, bandwidth
        freqs = torch.randn(channels, 2)
        radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
        freqs /= radii * radii.square().exp().pow(0.25)
        freqs *= bandwidth
        phases = torch.rand(channels) - 0.5
        self.weight = nn.Parameter(torch.randn(channels, channels))
        self.affine = Dense(w_dim, 4, weight_init=0.0,
                            bias_init=[1.0, 0.0, 0.0, 0.0])
        self.register_buffer("transform", torch.eye(3, 3))
        self.register_buffer("freqs", freqs)
        self.register_buffer("phases", phases)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        n = w.shape[0]
        t = self.affine(w)  # (r_c, r_s, t_x, t_y)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        zero, one = torch.zeros_like(t[:, 0]), torch.ones_like(t[:, 0])
        m_r = torch.stack([t[:, 0], -t[:, 1], zero, t[:, 1], t[:, 0], zero,
                           zero, zero, one], 1).view(n, 3, 3)
        m_t = torch.stack([one, zero, -t[:, 2], zero, one, -t[:, 3],
                           zero, zero, one], 1).view(n, 3, 3)
        transforms = m_r @ m_t @ self.transform[None]
        phases = self.phases[None] + (self.freqs[None]
                                      @ transforms[:, :2, 2:]).squeeze(2)
        freqs = self.freqs[None] @ transforms[:, :2, :2]
        amplitudes = (1 - (freqs.norm(dim=2) - self.bandwidth)
                      / (self.sampling_rate / 2 - self.bandwidth)).clamp(0, 1)
        # affine_grid's points (align_corners=False) along each axis
        half = 0.5 * self.size / self.sampling_rate
        axis = ((2 * torch.arange(self.size, device=w.device, dtype=w.dtype)
                 + 1) / self.size - 1) * half
        x = (axis[None, None, :, None] * freqs[:, None, None, :, 0]
             + axis[None, :, None, None] * freqs[:, None, None, :, 1])
        x = x + phases[:, None, None, :]
        x = torch.sin(x * (2 * math.pi)) * amplitudes[:, None, None, :]
        return x @ (self.weight / math.sqrt(self.channels)).t()


class SynthesisLayer(nn.Module):
    """One layer of the schedule (``synthesis_schedule``'s entry ``spec``):
    magnitude EMA, styles, modulated conv, filtered leaky ReLU."""

    def __init__(self, w_dim: int, spec: Dict, magnitude_ema_beta: float,
                 conv_clamp: float = 256.0):
        super().__init__()
        self.spec = spec
        self.torgb = spec["torgb"]
        cin, cout, k = spec["in_channels"], spec["out_channels"], spec["kernel"]
        self.affine = Dense(w_dim, cin, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.register_buffer("magnitude_ema", torch.ones(()))
        self.magnitude_ema_beta = magnitude_ema_beta
        self.conv_clamp = conv_clamp
        self.gain = 1.0 if self.torgb else math.sqrt(2.0)
        self.slope = 1.0 if self.torgb else 0.2
        fu = lowpass_filter(spec["taps_up"], spec["in_cutoff"],
                            spec["in_half_width"] * 2, spec["tmp_rate"])
        fd = lowpass_filter(spec["taps_down"], spec["out_cutoff"],
                            spec["out_half_width"] * 2, spec["tmp_rate"])
        self.fu = None if fu is None else tuple(float(v) for v in fu)
        self.fd = None if fd is None else tuple(float(v) for v in fd)

    def forward(self, x: torch.Tensor, w: torch.Tensor,
                update_emas: bool = False) -> torch.Tensor:
        if update_emas:
            with torch.no_grad():
                cur = global_mean(at_least_f32(x.detach()).square())
                self.magnitude_ema.copy_(
                    cur.lerp(self.magnitude_ema, self.magnitude_ema_beta))
        input_gain = torch.rsqrt(self.magnitude_ema)
        cin, k = self.weight.shape[1], self.weight.shape[2]
        s = self.affine(w)
        weight = self.weight
        if self.torgb:
            s = s * (1.0 / math.sqrt(cin * k * k))
        else:
            weight = weight * torch.rsqrt(
                weight.square().mean(dim=(1, 2, 3), keepdim=True))
            s = s * torch.rsqrt(global_mean(s.square()))
        dcoefs = None
        if not self.torgb:
            dcoefs = torch.rsqrt(s.square() @ weight.square().sum(
                dim=(2, 3)).t() + 1e-8).to(x.dtype)
        y = _ModulatedConv.apply(x, (s * input_gain).to(x.dtype),
                                 weight.to(x.dtype), dcoefs, k - 1)
        sp = self.spec
        return filtered_lrelu(y, self.bias, self.fu, self.fd, sp["up"],
                              sp["down"], sp["padding"], self.gain,
                              self.slope, self.conv_clamp)


class GStylegan3(nn.Module):
    """Mapping + synthesis (see the module docstring); images NHWC in
    [0, 1], clamped in eval. ``schedule`` are :func:`synthesis_schedule`'s
    keywords."""

    def __init__(self, size: int, z_dim: int = 512, w_dim: int = 512,
                 mapping_layers: int = 2, magnitude_ema_beta: float = 0.999,
                 output_scale: float = 0.25,
                 dtype: Optional[torch.dtype] = None, **schedule):
        super().__init__()
        self.dtype, self.size, self.style_dim = dtype, size, z_dim
        self.output_scale = output_scale
        self.schedule = synthesis_schedule(size, **schedule)
        first, layers = self.schedule[0], self.schedule[1:]
        self.num_ws = len(layers) + 1
        self.mapping = MappingNetwork(z_dim, w_dim, self.num_ws,
                                      num_layers=mapping_layers)
        self.synthesis = nn.Module()
        self.synthesis.input = SynthesisInput(
            w_dim, first["channels"], first["size"], first["rate"],
            first["cutoff"])
        self.synthesis.layers = nn.ModuleList(
            SynthesisLayer(w_dim, spec, magnitude_ema_beta) for spec in layers)

    def sample_latent(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """n latents from N(0, 1)^z_dim on ``generator``'s device."""
        return torch.randn(n, self.style_dim, generator=generator,
                           device=generator.device)

    def draws(self, n: int, generator: torch.Generator,
              style_mix: float = 0.0) -> Dict[str, torch.Tensor]:
        """The random inputs of a forward at batch ``n``: the latents alone
        (no noise maps; no style mixing, whatever ``style_mix``)."""
        return {"z": self.sample_latent(n, generator)}

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        """Images from latents ``z`` (N, z_dim); ``train`` updates the EMA
        buffers and emits the compute dtype, eval emits float32 clamped to
        [0, 1]."""
        ws = self.mapping(z, update_emas=train)
        x = self.synthesis.input(ws[:, 0])
        x = cast(x, self.dtype)
        for i, layer in enumerate(self.synthesis.layers):
            x = layer(x, ws[:, i + 1], update_emas=train)
        x = x * self.output_scale
        if train:
            return 0.5 * cast(x, self.dtype) + 0.5
        return torch.clamp(0.5 * at_least_f32(x) + 0.5, 0.0, 1.0)
