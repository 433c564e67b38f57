"""ContraD's train steps in plain PyTorch (ContraD ``train_gan.py`` and
``train_stylegan2.py``; the ``contrad`` mode of ``training/gan/contrad.py``,
``training/criterion.py``), float32. The model family (``families/``)
names the step it follows (``STEPS``):

``"critic"`` (``train_gan``): per critic sub-step the fakes of G in train
mode without a gradient, ContraD's D loss on the augmented [real, real,
fake] batch, one Adam step of D and D's ``u`` kept; then G's loss on D of
its augmented fakes, one Adam step of G, D's ``u`` kept again.

``"ema_r1"`` (``train_stylegan2``): G's EMA from the parameters before the
step; G's phase first; D's phase on G's fakes, with the R1 penalty
``0.5 * lbd_r1 * d_reg_every * E|grad_x D(x)|^2`` on augmented reals where
the step's number is a multiple of ``d_reg_every``.

ContraD's D loss: NT-Xent of the two real views' projections, plus
``lbd_a`` times the supervised-contrastive loss of the fakes against both
real views (second projection), plus the non-saturating GAN loss of the
score head, which sees the features detached. G's loss: non-saturating,
on D of its augmented fakes. Adam with the learning rate warmed up linearly
over ``warmup`` updates.

Every random draw is made here, in the order the step under test makes it
(``draws.py``). ``Trainer.first_grads`` keeps the gradients of the first
step, as Adam gets them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.augment import SimCLR, hflip_apply, hflip_sample
from benchmark.reference.draws import Rand
from benchmark.reference.families import make_model
from benchmark.reference.nets import l2_rows

# the steps a family may follow (its ``step``), as the docstring says
STEPS = ("critic", "ema_r1")


def nt_xent(a, b, t: float):
    n = a.shape[0]
    out = torch.cat([a, b])
    sim = out @ out.t() / t
    sim = sim.masked_fill(torch.eye(2 * n, dtype=torch.bool,
                                    device=sim.device), -5e4)
    ls = F.log_softmax(sim, dim=1)
    return -(torch.diagonal(ls[:n, n:]).sum()
             + torch.diagonal(ls[n:, :n]).sum()) / (2 * n)


def supcon_fake(a, b, fake, t: float):
    n, m = a.shape[0], fake.shape[0]
    out = torch.cat([a, b, fake])
    sim = out @ out.t() / t
    total = 2 * n + m
    sim = sim.masked_fill(torch.eye(total, dtype=torch.bool,
                                    device=sim.device), -5e4)
    cols = torch.arange(total, device=sim.device)[None, :]
    rows = torch.arange(2 * n, total, device=sim.device)[:, None]
    mask = ((cols >= 2 * n) & (cols != rows)).to(sim.dtype)
    mask = mask / mask.sum(1, keepdim=True)
    return -(F.log_softmax(sim[2 * n:], dim=1) * mask).sum(1).mean()


class Identity:
    """No augmentation: the FLOP counter's stand-in (no draws)."""

    def sample(self, shape, r):
        return None

    def apply(self, x, p):
        return x


class Trainer:
    """The reference trainer of ``cfg`` (a configuration file's
    ``reference`` table) from ``weights`` (``generator`` and
    ``discriminator``: name -> tensor, parameters and state), drawing from
    ``seed`` on ``device``."""

    def __init__(self, cfg: Dict, weights: Dict[str, torch.Tensor],
                 seed: int, device, count_flops: bool = False):
        self.cfg, self.rc = cfg, cfg["recipe"]
        self.model = make_model(cfg["model"])
        if self.model.step not in STEPS:
            raise ValueError(f"unknown step {self.model.step!r}; one of "
                             f"{STEPS}")
        self.ema_r1 = self.model.step == "ema_r1"
        self.r = Rand.from_seed(seed, device)
        self.aug = (Identity() if count_flops
                    else SimCLR(cfg["augment"], cfg["augment"]["hq"]))
        self.hflip = cfg["train_aug"] == "hflip" and not count_flops

        def split(spec, part):
            p, s = {}, {}
            for name, _, _ in spec:
                w = weights[part][name].detach().clone()
                if name.endswith(self.model.buffers):
                    s[name] = w
                else:
                    p[name] = w.requires_grad_(True)
            return p, s

        self.g, self.g_state = split(self.model.g_spec(), "generator")
        self.d, self.d_state = split(self.model.d_spec(), "discriminator")
        self.ema = ({k: v.detach().clone() for k, v in self.g.items()}
                    if self.ema_r1 else None)
        self.adam = {"g": self._adam(self.g), "d": self._adam(self.d)}
        self.first_grads: Optional[Dict[str, torch.Tensor]] = None
        self.grads: Dict[str, torch.Tensor] = {}

    @staticmethod
    def _adam(params):
        return {"t": 0, "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    # ------------------------------------------------------------ pieces

    def adam_step(self, which: str, params, grads) -> None:
        rc, st = self.rc, self.adam[which]
        b1, b2 = rc["beta"]
        lr = rc["lr_d"] if which == "d" else rc["lr"]
        if rc["warmup"] > 0:
            lr *= min(1.0, (st["t"] + 1) / rc["warmup"])
        st["t"] += 1
        t = st["t"]
        with torch.no_grad():
            part = "generator" if which == "g" else "discriminator"
            for k, p in params.items():
                g = grads[k]
                self.grads.setdefault(f"{part}.{k}", g)
                mu = st["mu"][k].mul_(b1).add_((1 - b1) * g)
                nu = st["nu"][k].mul_(b2).add_((1 - b2) * g * g)
                step = (mu / (1 - b1**t)) / (torch.sqrt(nu / (1 - b2**t)) + 1e-8)
                p.sub_(lr * step)

    def grads_of(self, loss, params):
        names = list(params)
        gs = torch.autograd.grad(loss, [params[k] for k in names],
                                 allow_unused=True)
        return {k: (torch.zeros_like(params[k]) if g is None else g)
                for k, g in zip(names, gs)}

    def D(self, x, staged=None, sg_linear=False):
        return self.model.discriminator(self.d, self.d_state, x, staged,
                                        sg_linear)

    def d_loss(self, real, fake, aug_p, staged):
        n = real.shape[0]
        x = self.aug.apply(torch.cat([real, real, fake.detach()]), aug_p)
        d, proj, proj2 = self.D(x, staged, sg_linear=True)
        v = l2_rows(proj)
        simclr = nt_xent(v[:n], v[n:2 * n], self.rc["temp"])
        v2 = l2_rows(proj2)
        sup = supcon_fake(v2[:n], v2[n:2 * n], v2[2 * n:], self.rc["temp"])
        d_real, d_gen = d[:n], d[2 * n:]
        head = F.softplus(d_gen).mean() + F.softplus(-d_real).mean()
        contrastive = simclr + self.rc["lbd_a"] * sup
        return contrastive + head, {"D_loss": contrastive, "D_penalty": head,
                                    "D_real": d_real.mean(),
                                    "D_gen": d_gen.mean()}

    def g_loss(self, fake, aug_p, staged):
        d, _, _ = self.D(self.aug.apply(fake, aug_p), staged)
        return F.softplus(-d).mean()

    def commit(self, staged):
        with torch.no_grad():
            for k, u in staged.items():
                self.d_state[k].copy_(u)

    def G(self, draws):
        return self.model.generator(self.g, self.g_state, draws)

    def kinds(self) -> tuple:
        """The kinds of step the recipe runs: ``plain``, and ``r1`` where
        the step has the R1 penalty (every step where ``d_reg_every`` is
        1)."""
        rc = self.rc
        if not (self.ema_r1 and rc["lbd_r1"] > 0):
            return ("plain",)
        return ("r1",) if rc["d_reg_every"] == 1 else ("plain", "r1")

    # ------------------------------------------------------------ step

    def step(self, images: torch.Tensor, step: int) -> Dict[str, torch.Tensor]:
        """Train step number ``step`` (1-based) on the uint8 NHWC real batch
        ``images`` (``n_critic`` sub-batches); returns its losses."""
        rc, r = self.rc, self.r
        x = images.float() / 255.0
        n = x.shape[0] // rc["n_critic"]
        shape = (n,) + tuple(x.shape[1:])
        big = (3 * n,) + tuple(x.shape[1:])
        flip = hflip_sample(x.shape[0], r) if self.hflip else None
        critic = [(self.model.sample_z(n, r), self.aug.sample(big, r))
                  for _ in range(rc["n_critic"])]
        g_draws, g_aug = self.model.sample_z(n, r), self.aug.sample(shape, r)
        r1 = "r1" in self.kinds() and step % rc["d_reg_every"] == 0
        r1_aug = self.aug.sample(shape, r) if r1 else None
        if flip is not None:
            x = hflip_apply(x, flip)
        batches = x.split(n)
        self.grads = {}
        if self.ema_r1:
            out = self._ema_r1_step(batches, critic, g_draws, g_aug, r1,
                                    r1_aug, step)
        else:
            out = self._critic_step(batches, critic, g_draws, g_aug)
        if self.first_grads is None:
            self.first_grads = self.grads
        return {k: v.detach() for k, v in out.items()}

    def _critic_step(self, batches, critic, g_draws, g_aug):
        for batch, (z, aug_p) in zip(batches, critic):
            with torch.no_grad():
                fake = self.G(z)
            staged = {}
            total, out = self.d_loss(batch, fake, aug_p, staged)
            self.adam_step("d", self.d, self.grads_of(total, self.d))
            self.commit(staged)
        staged = {}
        loss = self.g_loss(self.G(g_draws), g_aug, staged)
        self.adam_step("g", self.g, self.grads_of(loss, self.g))
        self.commit(staged)
        return dict(out, G_loss=loss)

    def _ema_r1_step(self, batches, critic, g_draws, g_aug, do_r1, r1_aug,
                     step):
        rc = self.rc
        decay = (0.5 ** (rc["batch_size"] / (rc["halflife_k"] * 1000))
                 if step * rc["batch_size"] > rc["ema_start_k"] * 1000 else 0.0)
        with torch.no_grad():
            for k, e in self.ema.items():
                e.mul_(decay).add_((1 - decay) * self.g[k])
        fake = self.G(g_draws)
        g_loss = self.g_loss(fake, g_aug, {})
        self.adam_step("g", self.g, self.grads_of(g_loss, self.g))
        total, out = self.d_loss(batches[0], fake.detach(), critic[0][1], {})
        r1 = torch.zeros((), device=fake.device)
        if do_r1:
            xr = self.aug.apply(batches[0], r1_aug).detach().requires_grad_(True)
            d, _, _ = self.D(xr)
            (gx,) = torch.autograd.grad(d.sum(), xr, create_graph=True)
            r1 = gx.reshape(gx.shape[0], -1).pow(2).sum(1).mean()
            total = total + 0.5 * rc["lbd_r1"] * rc["d_reg_every"] * r1
        self.adam_step("d", self.d, self.grads_of(total, self.d))
        for batch, (z, aug_p) in zip(batches[1:], critic[1:]):
            with torch.no_grad():
                fake = self.G(z)
            total, out = self.d_loss(batch, fake, aug_p, {})
            self.adam_step("d", self.d, self.grads_of(total, self.d))
        return dict(out, D_r1=r1, G_loss=g_loss)

    def leaves(self) -> Dict[str, torch.Tensor]:
        """The trained tensors by the program's names: ``generator.*``,
        ``discriminator.*`` and, where the step keeps G's EMA,
        ``g_ema.*``."""
        out = {f"generator.{k}": v for k, v in self.g.items()}
        out.update({f"discriminator.{k}": v for k, v in self.d.items()})
        if self.ema is not None:
            out.update({f"g_ema.{k}": v for k, v in self.ema.items()})
        return out

