"""StyleGAN3-T (Karras et al. 2021, arXiv:2106.12423; NVlabs ``stylegan3``,
``training/networks_stylegan3.py``, ``--cfg=stylegan3-t``) as the G of
ContraD's ``train_stylegan2`` step (``step = "ema_r1"``), with the
``stylegan2`` family's discriminator, heads, D spec and kernel rows for D
(this class is that family's, its G replaced).

G: the mapping (``z`` normalised by its second moment, equalised dense
layers at ``lr_mul`` 0.01 with leaky ReLU times sqrt 2, ``w_avg`` an EMA of
the batch's mean ``w``); Fourier features of fixed frequencies and phases
rotated and translated per sample by an affine map of ``w``, on
``affine_grid``'s points, then a trainable map; the layers of the published
schedule (:meth:`schedule`): the input magnitude's EMA and gain, the styles
and weights pre-normalised (the styles over the whole batch), the modulated
and demodulated conv in NVlabs' unfused form (the input scaled by the
styles and the input gain, one conv, the output by the demodulation of
each sample's weights: NVlabs' grouped form is the same function, and
``torch.utils.flop_counter`` counts a grouped conv's weight gradient once
for each group), then the filtered leaky ReLU: bias, polyphase FIR upsampling,
leaky ReLU, gain and clamp, FIR downsampling, each FIR a sum of shifted,
strided slices along one axis (as ``nets.fir``; so ``counts/flops.py``
counts only convolutions and products). The filters are
``scipy.signal.firwin``'s Kaiser design, written out (:func:`firwin`). The
EMA buffers (``freqs``, ``phases`` and ``transform`` are fixed) update in
every G forward; the image is the last layer times 0.25, ``0.5 x + 0.5``.

**Row blocks.** On the card a float32 G at batch 16 and 512x512 cannot keep
its whole autograd graph (the upsampled grids alone are 47 GB a copy). So a
G forward that needs a gradient runs as :class:`_RowBlocked`: (1) the fakes
without a gradient, layer by layer over the whole batch (the EMAs updated
once, from the whole batch), their filters over ``g_rows`` rows at a time;
(2) the step takes ``d loss / d fake`` through D as usual; (3) G's backward:
the mapping, the input's transform and every layer's normalised styles for
the whole batch with a gradient, then the synthesis ``g_rows`` rows at a
time from those styles (held as leaves) and back, then the styles' and the
mapping's graph once with the summed leaf gradients, so that the styles'
batch-wide normalisation is differentiated over the whole batch. No term
across rows is dropped. On the meta device (the FLOP counter) G runs
plainly, so nothing recomputed is counted.

Its kernel tables: the blur's and the fused activation's rows are D's (the
``stylegan2`` family's) and the mapping's activations; ``filtered_lrelu_
launches`` gives the filtered leaky ReLU's (``counts/filtered_lrelu.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.families.stylegan2 import StyleGAN2
from benchmark.reference.nets import SQRT2, Params


def firwin(numtaps: int, cutoff: float, width: float, fs: float):
    """``scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs)``: a
    windowed sinc, Kaiser's window with beta by Kaiser's rule, normalised
    to sum 1 (float64 numpy); None for one tap."""
    if numtaps == 1:
        return None
    nyq = fs / 2
    atten = 2.285 * (numtaps - 1) * np.pi * (width / nyq) + 7.95
    beta = (0.1102 * (atten - 8.7) if atten > 50 else
            0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
            if atten > 21 else 0.0)
    m = np.arange(numtaps) - (numtaps - 1) / 2
    h = (cutoff / nyq) * np.sinc((cutoff / nyq) * m) * np.kaiser(numtaps, beta)
    return h / h.sum()


def _take(x, dim: int, start: int, n: int, step: int = 1):
    """``n`` samples of ``x`` along ``dim`` from ``start`` every ``step``."""
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(start, start + (n - 1) * step + 1, step)
    return x[tuple(idx)]


def up_axis(x, taps, up: int, pad: int, n_out: int, dim: int):
    """Polyphase upsampling along ``dim``: ``u[j] = sum_i x[i] f[i up + pad
    - j]`` for ``j < n_out``, ``f = taps * up``, ``x`` zero outside; phase
    ``q`` of ``j`` is a sum of ``len(taps) / up`` shifted slices of ``x``."""
    f = [t * up for t in taps]
    n_in, per = x.shape[dim], len(f) // up
    m = -(-n_out // up)  # outputs a phase
    first = [-((pad - q) // up) for q in range(up)]  # ceil((q - pad) / up)
    lo = max(0, -min(first))
    hi = max(0, max(first) + per - 1 + m - n_in)
    shape = list(x.shape)
    shape[dim] = lo
    parts = [x.new_zeros(shape), x]
    shape[dim] = hi
    xp = torch.cat(parts + [x.new_zeros(shape)], dim)
    phases = []
    for q in range(up):
        acc = None
        for k in range(per):
            tap, part = f[(first[q] + k) * up + pad - q], _take(
                xp, dim, lo + first[q] + k, m)
            acc = (part * tap if acc is None
                   else torch.add(acc, part, alpha=tap))
        phases.append(acc)
    out = torch.stack(phases, dim + 1).flatten(dim, dim + 1)
    return _take(out, dim, 0, n_out)


def down_axis(x, taps, down: int, n_out: int, dim: int):
    """``y[m] = sum_t f[t] x[m down + t]`` along ``dim``, ``m < n_out``: a
    sum of ``len(taps)`` strided slices."""
    acc = None
    for t, f in enumerate(taps):
        part = _take(x, dim, t, n_out, down)
        acc = part * f if acc is None else torch.add(acc, part, alpha=f)
    return acc


class StyleGAN3(StyleGAN2):
    """``cfg``: ``image_size``, ``z_dim``, ``w_dim``, ``mapping_layers``,
    ``lr_mapping``, ``w_avg_beta``, ``magnitude_ema_beta``, ``conv_clamp``,
    ``output_scale``, ``schedule`` (the synthesis network's: ``channel_base``,
    ``channel_max``, ``num_layers``, ``num_critical``, ``first_cutoff``,
    ``first_stopband``, ``last_stopband_rel``, ``margin_size``,
    ``filter_size``, ``lrelu_upsampling``, ``conv_kernel``), ``g_rows``
    (rows a block of G on the card), and D's ``channels`` and
    ``d_hidden``."""

    step = "ema_r1"
    buffers = ("freqs", "phases", "transform", "magnitude_ema", "w_avg")

    def __init__(self, cfg: dict):
        self.size = cfg["image_size"]
        self.ch = {int(k): v for k, v in cfg["channels"].items()}
        self.d_hidden = cfg["d_hidden"]
        self.log_size = int(math.log2(self.size))
        self.z_dim, self.w_dim = cfg["z_dim"], cfg["w_dim"]
        self.n_map, self.lr_map = cfg["mapping_layers"], cfg["lr_mapping"]
        self.w_avg_beta = cfg["w_avg_beta"]
        self.mag_beta = cfg["magnitude_ema_beta"]
        self.clamp, self.out_scale = cfg["conv_clamp"], cfg["output_scale"]
        self.g_rows = cfg["g_rows"]
        self.input, self.layers = self.schedule(self.size, **cfg["schedule"])
        for spec in self.layers:  # float32 taps, as NVlabs keeps them
            for key, taps, cut, half in (
                    ("fu", "taps_up", "in_cutoff", "in_half_width"),
                    ("fd", "taps_down", "out_cutoff", "out_half_width")):
                f = firwin(spec[taps], spec[cut], 2 * spec[half],
                           spec["tmp_rate"])
                spec[key] = None if f is None else f.astype(np.float32)

    # ------------------------------------------------------------- schedule

    @staticmethod
    def schedule(res: int, channel_base: int, channel_max: int,
                 num_layers: int, num_critical: int, first_cutoff: float,
                 first_stopband: float, last_stopband_rel: float,
                 margin_size: int, filter_size: int, lrelu_upsampling: int,
                 conv_kernel: int) -> Tuple[Dict, List[Dict]]:
        """NVlabs ``SynthesisNetwork``'s geometric schedules and each
        ``SynthesisLayer``'s filters and padding: (the input's entry, the
        layers', ToRGB last)."""
        e = np.minimum(np.arange(num_layers + 1)
                       / (num_layers - num_critical), 1)
        cutoff = first_cutoff * (res / 2 / first_cutoff) ** e
        stop = first_stopband * (res / 2 * last_stopband_rel
                                 / first_stopband) ** e
        rate = np.exp2(np.ceil(np.log2(np.minimum(stop * 2, res))))
        half = np.maximum(stop, rate / 2) - cutoff
        size = rate + 2 * margin_size
        size[-2:] = res
        ch = np.rint(np.minimum(channel_base / 2 / cutoff, channel_max))
        ch[-1] = 3
        layers = []
        for i in range(num_layers + 1):
            j, rgb = max(i - 1, 0), i == num_layers
            tmp = max(rate[j], rate[i]) * (1 if rgb else lrelu_upsampling)
            up, down = int(round(tmp / rate[j])), int(round(tmp / rate[i]))
            k = 1 if rgb else conv_kernel
            lu = filter_size * up if up > 1 and not rgb else 1
            ld = filter_size * down if down > 1 and not rgb else 1
            total = ((int(size[i]) - 1) * down + 1
                     - (int(size[j]) + k - 1) * up + lu + ld - 2)
            lo = (total + up) // 2
            layers.append(dict(
                torgb=rgb, cin=int(ch[j]), cout=int(ch[i]),
                size_in=int(size[j]), size_out=int(size[i]), k=k, up=up,
                down=down, taps_up=lu, taps_down=ld, pad=(lo, total - lo),
                tmp_rate=float(tmp), rate_in=int(rate[j]),
                rate_out=int(rate[i]), in_cutoff=float(cutoff[j]),
                out_cutoff=float(cutoff[i]), in_half_width=float(half[j]),
                out_half_width=float(half[i])))
        return (dict(channels=int(ch[0]), size=int(size[0]),
                     rate=float(rate[0]), bandwidth=float(cutoff[0])), layers)

    # ------------------------------------------------------------- specs

    def g_spec(self) -> list:
        wd, n1 = self.w_dim, ("normal", 1.0)
        spec = [("mapping.w_avg", (wd,), ("zeros",))]
        for i in range(self.n_map):
            spec += [(f"mapping.fc{i}.weight",
                      (wd, self.z_dim if i == 0 else wd),
                      ("normal", 1 / self.lr_map)),
                     (f"mapping.fc{i}.bias", (wd,), ("zeros",))]
        c = self.input["channels"]
        spec += [("synthesis.input.weight", (c, c), n1),
                 ("synthesis.input.transform", (3, 3), ("eye",)),
                 ("synthesis.input.freqs", (c, 2), ("freqs",)),
                 ("synthesis.input.phases", (c,), ("phases",)),
                 ("synthesis.input.affine.weight", (4, wd), ("zeros",)),
                 ("synthesis.input.affine.bias", (4,), ("rotation",))]
        for i, s in enumerate(self.layers):
            key = f"synthesis.layers.{i}."
            spec += [(key + "weight", (s["cout"], s["cin"], s["k"], s["k"]),
                      n1),
                     (key + "bias", (s["cout"],), ("zeros",)),
                     (key + "magnitude_ema", (), ("ones",)),
                     (key + "affine.weight", (s["cin"], wd), n1),
                     (key + "affine.bias", (s["cin"],), ("ones",))]
        return spec

    def make(self, name: str, shape, init, gen):
        """The input's fixed entries: frequencies drawn ``N(0, 1)``, divided
        by ``r exp(r^2)^(1/4)`` and times the bandwidth; phases ``U(-1/2,
        1/2)``; the identity transform; the transform's bias [1, 0, 0, 0]."""
        kind, dev = init[0], gen.device
        if kind == "freqs":
            f = torch.randn(shape, generator=gen, device=dev)
            r = f.square().sum(1, keepdim=True).sqrt()
            return f / (r * r.square().exp().pow(0.25)) * self.input["bandwidth"]
        if kind == "phases":
            return torch.rand(shape, generator=gen, device=dev) - 0.5
        if kind == "eye":
            return torch.eye(3, device=dev)
        if kind == "rotation":
            return torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        return super().make(name, shape, init, gen)

    # ------------------------------------------------------------- kernels

    def blur_launches(self, batch: int) -> List:
        """D's blurs (the ``stylegan2`` family's rows without G's
        upsampling ones): G blurs nothing."""
        return [row for row in super().blur_launches(batch) if row[2] == 1]

    def _act_sites(self, n: int, d: bool) -> List[Tuple[int, ...]]:
        """D's sites (the ``stylegan2`` family's), or the mapping's layers
        for G: the only fused activations of G."""
        if d:
            return super()._act_sites(n, d)
        return [(n, self.w_dim)] * self.n_map

    def filtered_lrelu_launches(self, batch: int) -> List:
        """Every launch of the filtered leaky ReLU in a train step
        (``counts/filtered_lrelu.py``'s rows): each layer's forward and its
        backward, once a step (G runs once; R1 does not reach it). A row
        is ``(op, in NHWC, out NHWC, grid (h, w), up, down, taps up, taps
        down, launches by kind)``, as the kernel sees the launch: the
        backward upsamples ``dy`` by the forward's ``down`` onto the same
        grid and downsamples by its ``up``."""
        rows, every = [], {"plain": 1, "r1": 1}
        for s in self.layers:
            h_in = s["size_in"] + s["k"] - 1
            x = (batch, h_in, h_in, s["cout"])
            y = (batch, s["size_out"], s["size_out"], s["cout"])
            grid = ((s["size_out"] - 1) * s["down"] + s["taps_down"],) * 2
            rows += [("forward", x, y, grid, s["up"], s["down"], s["taps_up"],
                      s["taps_down"], every),
                     ("backward", y, x, grid, s["down"], s["up"],
                      s["taps_down"], s["taps_up"], every)]
        return rows

    # ------------------------------------------------------------- draws

    def sample_z(self, n: int, r) -> Dict:
        return {"z": r.randn((n, self.z_dim))}

    # ------------------------------------------------------------- G

    def mapping(self, p: Params, state: Params, z, update: bool):
        x = z * torch.rsqrt(torch.mean(z**2, dim=1, keepdim=True) + 1e-8)
        in_dim = self.z_dim
        for i in range(self.n_map):
            w = p[f"mapping.fc{i}.weight"] * (self.lr_map / math.sqrt(in_dim))
            x = F.linear(x, w) + p[f"mapping.fc{i}.bias"] * self.lr_map
            x = F.leaky_relu(x, 0.2) * SQRT2
            in_dim = self.w_dim
        if update:
            with torch.no_grad():
                avg = state["mapping.w_avg"]
                avg.copy_(x.mean(0).lerp(avg, self.w_avg_beta))
        return x

    def transform(self, p: Params, w):
        """The input's per-sample (r_c, r_s, t_x, t_y), normalised."""
        t = F.linear(w, p["synthesis.input.affine.weight"]
                     / math.sqrt(self.w_dim)) + p["synthesis.input.affine.bias"]
        return t / t[:, :2].norm(dim=1, keepdim=True)

    def styles(self, p: Params, i: int, w):
        """Layer ``i``'s styles, pre-normalised over the whole batch (ToRGB:
        times its weight gain)."""
        key, s = f"synthesis.layers.{i}.", self.layers[i]
        st = F.linear(w, p[key + "affine.weight"] / math.sqrt(self.w_dim)
                      ) + p[key + "affine.bias"]
        if s["torgb"]:
            return st / math.sqrt(s["cin"] * s["k"] ** 2)
        return st * st.square().mean().rsqrt()

    def fourier(self, p: Params, state: Params, t):
        """NCHW Fourier features of the input (NVlabs ``SynthesisInput``)."""
        n, inp = t.shape[0], self.input
        eye = torch.eye(3, device=t.device, dtype=t.dtype)
        m_r = eye.repeat(n, 1, 1)
        m_r[:, 0, 0], m_r[:, 0, 1] = t[:, 0], -t[:, 1]
        m_r[:, 1, 0], m_r[:, 1, 1] = t[:, 1], t[:, 0]
        m_t = eye.repeat(n, 1, 1)
        m_t[:, 0, 2], m_t[:, 1, 2] = -t[:, 2], -t[:, 3]
        tr = m_r @ m_t @ state["synthesis.input.transform"][None]
        freqs = state["synthesis.input.freqs"][None]
        phases = (state["synthesis.input.phases"][None]
                  + (freqs @ tr[:, :2, 2:]).squeeze(2))
        freqs = freqs @ tr[:, :2, :2]
        amp = (1 - (freqs.norm(dim=2) - inp["bandwidth"])
               / (inp["rate"] / 2 - inp["bandwidth"])).clamp(0, 1)
        theta = torch.eye(2, 3, device=t.device, dtype=t.dtype)
        theta[0, 0] = theta[1, 1] = 0.5 * inp["size"] / inp["rate"]
        grid = F.affine_grid(theta[None], [1, 1, inp["size"], inp["size"]],
                             align_corners=False)
        x = (grid.unsqueeze(3) @ freqs.permute(0, 2, 1)[:, None, None]
             ).squeeze(3)
        x = torch.sin((x + phases[:, None, None]) * (2 * math.pi))
        x = x * amp[:, None, None]
        c = inp["channels"]
        x = x @ (p["synthesis.input.weight"] / math.sqrt(c)).t()
        return x.permute(0, 3, 1, 2)

    def filtered(self, s: Dict, x, bias):
        """The filtered leaky ReLU of NCHW ``x``."""
        gain, slope = (1.0, 1.0) if s["torgb"] else (SQRT2, 0.2)
        x = x + bias.reshape(1, -1, 1, 1)
        n_grid = (s["size_out"] - 1) * s["down"] + s["taps_down"]
        if s["fu"] is not None:
            for dim in (2, 3):
                x = up_axis(x, s["fu"].tolist(), s["up"], s["pad"][0],
                            n_grid, dim)
        x = torch.where(x < 0, x * slope, x) * gain
        x = x.clamp(-self.clamp, self.clamp)
        if s["fd"] is not None:
            for dim in (3, 2):
                x = down_axis(x, s["fd"].tolist(), s["down"], s["size_out"],
                              dim)
        return x

    def layer(self, p: Params, state: Params, i: int, x, st, update: bool):
        """Layer ``i`` on NCHW ``x`` with its styles ``st`` (the rows of
        ``x``)."""
        key, s = f"synthesis.layers.{i}.", self.layers[i]
        ema = state[key + "magnitude_ema"]
        if update:
            with torch.no_grad():
                ema.copy_(x.square().mean().lerp(ema, self.mag_beta))
        n = x.shape[0]
        w = p[key + "weight"]
        if not s["torgb"]:
            w = w * w.square().mean([1, 2, 3], keepdim=True).rsqrt()
        y = F.conv2d(x * (st * ema.rsqrt())[:, :, None, None], w,
                     padding=s["k"] - 1)
        if not s["torgb"]:  # the demodulation of each sample's weights
            d = (st.square() @ w.square().sum([2, 3]).t() + 1e-8).rsqrt()
            y = y * d[:, :, None, None]
        if torch.is_grad_enabled() or self.g_rows >= n:
            return self.filtered(s, y, p[key + "bias"])
        return torch.cat([self.filtered(s, part, p[key + "bias"])
                          for part in y.split(self.g_rows)])

    def synthesis(self, p: Params, state: Params, t, styles, update: bool):
        x = self.fourier(p, state, t)
        for i in range(len(self.layers)):
            x = self.layer(p, state, i, x, styles[i], update)
        return (0.5 * (x * self.out_scale) + 0.5).permute(0, 2, 3, 1)

    def plain(self, p: Params, state: Params, z, update: bool = True):
        w = self.mapping(p, state, z, update)
        return self.synthesis(p, state, self.transform(p, w),
                              [self.styles(p, i, w)
                               for i in range(len(self.layers))], update)

    def generator(self, p: Params, state: Params, draws: Dict):
        z = draws["z"]
        if (z.device.type == "meta" or not torch.is_grad_enabled()
                or self.g_rows >= z.shape[0]):
            return self.plain(p, state, z)
        names = list(p)
        return _RowBlocked.apply(self, state, names, z, *[p[k] for k in names])


class _RowBlocked(torch.autograd.Function):
    """G's forward without a graph, and its backward in row blocks (see the
    module docstring)."""

    @staticmethod
    def forward(ctx, fam, state, names, z, *params):
        with torch.no_grad():
            out = fam.plain(dict(zip(names, params)), state, z)
        ctx.fam, ctx.names = fam, names
        ctx.state = {k: v.clone() for k, v in state.items()}  # after update
        ctx.save_for_backward(z, *params)
        return out

    @staticmethod
    def backward(ctx, dout):
        fam, names = ctx.fam, ctx.names
        z, *params = ctx.saved_tensors
        leaves = [v.detach().requires_grad_(True) for v in (z, *params)]
        p = dict(zip(names, leaves[1:]))
        with torch.enable_grad():
            w = fam.mapping(p, ctx.state, leaves[0], False)
            heads = [fam.transform(p, w)] + [
                fam.styles(p, i, w) for i in range(len(fam.layers))]
            held = [h.detach().requires_grad_(True) for h in heads]
            for rows in torch.arange(z.shape[0], device=z.device).split(
                    fam.g_rows):
                img = fam.synthesis(p, ctx.state, held[0][rows],
                                    [h[rows] for h in held[1:]], False)
                torch.autograd.backward(img, dout[rows])
            torch.autograd.backward(heads, [h.grad for h in held])
        grads = [torch.zeros_like(v) if v.grad is None else v.grad
                 for v in leaves]
        return (None, None, None, *grads)


MODEL = StyleGAN3
