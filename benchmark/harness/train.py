"""A training cell: the recipe's trainer built by its CLI's ``build``, the
first steps compared with the plain reference, then a window of graph
replays timed end to end.

Set-up (``setup_s``, from the process's start to the window's first step):
  * the trainer from the recipe's argv and the CLI's defaults
    (``<cli>.build``), with the data set stood in: as many uint8 images as
    the port's synthetic stand-in holds, drawn on the card from the seed
    and handed to the device-resident loader; the weights drawn on the card
    from the seed (``reference/weights.py``) and loaded into G, D and the
    EMA G;
  * the compared steps (the configuration's ``compare`` blocks, e.g.
    ``[[1, 1], [2, 11]]``, first and last step): each block through ``BlockRunner.run`` with index
    vectors from the loader, a block of one step eager, a longer one as
    CUDA-graph replays (its first use of a step kind warms up and captures
    that kind); the readings are taken (each block's last losses, the
    first step's gradients from Adam's first moment, each leaf's change);
  * blocks up to the dispatch alignment, and on until every step kind that
    the window replays has been captured;
  * whole blocks replayed for the mix's ``settle_s`` seconds: a process's
    replays leave a slower state at a random time in their first seconds.
The window: ``BlockDispatcher``'s blocks of K steps (K as the CLI resolves
it from its default cadences), losses read on the host every
``print_every`` steps as the CLI does, until ``seconds`` have passed at a
block boundary that closes a whole period of step kinds (K and the lazy-R1
cadence). No capture, evaluation or save falls inside it. With a trace, a
fixed number of whole periods runs under the profiler instead, after a
lead-in of empty kernels that the trace leaves out (``trace.lead_in``).

After the window the program is freed and the reference follows the
compared steps on the card in float32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import math
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.reference.draws import batch_rows, derive

IMAGES_STREAM = 2


def log(msg: str, t_start: float) -> None:
    print(f"[benchmark {time.perf_counter() - t_start:7.2f} s] {msg}",
          file=sys.stderr, flush=True)


def make_images(data: Dict, size: int, seed: int, device) -> torch.Tensor:
    """The data set's stand-in, ``data["rows"]`` uint8 NHWC images drawn on
    ``device`` from ``seed`` by the recipe of the port's synthetic set
    (``data/synthetic.py``): a base colour in [0.1, 0.4], a Gaussian blob of
    width [0.1, 0.3] x size at a centre in the middle half, of colour
    [0.3, 0.6], and N(0, 0.03) noise, clipped to [0, 1]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, IMAGES_STREAM))
    n = data["rows"]
    u = torch.rand((n, 9), generator=gen, device=device)
    cy, cx = (0.25 + 0.5 * u[:, 0]) * size, (0.25 + 0.5 * u[:, 1]) * size
    sigma = (0.1 + 0.2 * u[:, 2]) * size
    base, amp = 0.1 + 0.3 * u[:, 3:6], 0.3 + 0.3 * u[:, 6:9]
    grid = torch.arange(size, device=device, dtype=torch.float32)
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    chunk = max(1, 2**24 // (size * size))  # 192 MiB of float32 pixels
    for i in range(0, n, chunk):
        j = slice(i, i + chunk)
        dy = (grid[None, :] - cy[j, None]) ** 2
        dx = (grid[None, :] - cx[j, None]) ** 2
        blob = torch.exp(-(dy[:, :, None] + dx[:, None, :])
                         / (2.0 * sigma[j, None, None] ** 2))
        img = base[j, None, None, :] + blob[..., None] * amp[j, None, None, :]
        img += 0.03 * torch.randn(img.shape, generator=gen, device=device)
        out[j] = (img.clamp_(0.0, 1.0) * 255.0).to(torch.uint8)
    return out


@contextlib.contextmanager
def stand_in(data: Dict):
    """While the CLI builds, its data set is a stand-in of ``data["rows"]``
    rows (1x1 pixels: the loader's images are replaced after the build)
    with the set's baked-in augmentation and classes."""
    import contrad_tpu_torch.data as registry
    from contrad_tpu_torch.data import ArrayDataset

    real = registry.get_dataset

    def get_dataset(name, data_path=None):
        size = registry.get_image_size(name)
        rows = np.zeros((data["rows"], 1, 1, size[2]), np.uint8)
        return (ArrayDataset(rows, train_aug=data["train_aug"],
                             n_classes=data["classes"]), None, size)

    registry.get_dataset = get_dataset
    try:
        yield
    finally:
        registry.get_dataset = real


class Program:
    """The trainer under test and its loop's pieces."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: str,
                 extra_argv=()):
        from contrad_tpu_torch.training.dispatch import (
            BlockDispatcher, resolve_steps_per_dispatch)
        from contrad_tpu_torch.training.graph import BlockRunner

        from benchmark.reference.weights import make_weights

        prog = cfg["program"]
        self.cli = importlib.import_module(f"contrad_tpu_torch.{prog['cli']}")
        argv = (list(prog["argv"]) + list(traffic.get("argv", []))
                + list(extra_argv) + ["--seed", str(seed), "--device", device])
        self.P = P = self.cli.parse_args(argv)
        with stand_in(cfg["data"]):
            conf, loader, trainer = self.cli.build(P)
        self.opt = opt = conf.options
        size = cfg["reference"]["model"]["image_size"]
        loader.images = make_images(cfg["data"], size, seed, loader.device)
        weights = make_weights(cfg["reference"]["model"], seed, loader.device)
        trainer.generator.load_state_dict(weights["generator"])
        trainer.discriminator.load_state_dict(weights["discriminator"])
        if trainer.g_ema is not None:
            trainer.g_ema.load_state_dict(weights["generator"])
        del weights
        self.loader, self.trainer = loader, trainer
        self.check_recipe(cfg["reference"]["recipe"])
        self.k = resolve_steps_per_dispatch(
            P.steps_per_dispatch, getattr(loader, "supports_indexed", False),
            P.trace_steps, P.print_every, P.evaluate_every, P.save_every)
        self.dispatcher = BlockDispatcher(loader, self.k, opt.max_steps)
        self.runner = BlockRunner(trainer, loader)
        self.step = 1
        self.sync = (torch.cuda.synchronize if loader.device.type == "cuda"
                     else (lambda: None))
        self.failed = 0  # window steps whose printed losses were not finite

    def check_recipe(self, rc: Dict) -> None:
        """The numbers the reference follows are the program's."""
        P, opt = self.P, self.opt
        have = {"batch_size": opt.batch_size, "n_critic": opt.n_critic,
                "lr": opt.lr, "lr_d": opt.lr_d, "beta": list(opt.beta),
                "warmup": opt.warmup if P.use_warmup else 0,
                "temp": P.temp, "lbd_a": P.lbd_a}
        for key in ("lbd_r1", "d_reg_every", "halflife_k", "ema_start_k"):
            if hasattr(P, key):
                have[key] = getattr(P, key)
        differ = {k: (have[k], rc[k]) for k in have if have[k] != rc.get(k)}
        if differ:
            raise ValueError(f"the reference's recipe differs from the "
                             f"program's (program, reference): {differ}")

    # ------------------------------------------------------------ steps

    def step_args(self, steps: np.ndarray) -> Dict:
        if not hasattr(self.cli, "step_args"):
            return {}
        return self.cli.step_args(self.P, self.opt.batch_size, steps)

    def kinds(self, steps) -> List[str]:
        r1 = self.step_args(np.asarray(steps)).get("do_r1")
        return ["plain"] * len(steps) if r1 is None else [
            "r1" if r else "plain" for r in r1]

    def period(self) -> int:
        """Steps after which the window's blocks and step kinds repeat."""
        r1 = getattr(self.P, "d_reg_every", 1) or 1
        return self.k * r1 // math.gcd(self.k, r1)

    def run_block(self, steps: List[int]):
        """Steps ``steps`` as one ``BlockRunner.run``, index vectors from
        the loader."""
        pairs = [self.loader.next_indices() for _ in steps]
        labels = ([p[1] for p in pairs] if self.trainer.conditional
                  else None)
        metrics = self.runner.run([p[0] for p in pairs], labels,
                                  **self.step_args(np.asarray(steps)))
        self.step = steps[-1] + 1
        return metrics

    def leaves(self) -> Dict[str, torch.Tensor]:
        t = self.trainer
        out = {}
        for part, module in (("generator", t.generator),
                             ("discriminator", t.discriminator),
                             ("g_ema", t.g_ema)):
            if module is not None:
                out.update({f"{part}.{k}": p.detach()
                            for k, p in module.named_parameters()})
        return out

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """Each parameter's gradient as Adam got it, from its first moment
        after one update (``mu = (1 - b1) g``), in float32 on the host."""
        t, out = self.trainer, {}
        for part, module, opt in (("generator", t.generator, t.g_tx),
                                  ("discriminator", t.discriminator, t.d_tx)):
            names = [k for k, _ in module.named_parameters()]
            out.update({f"{part}.{k}": (m.float() / (1.0 - opt.b1)).cpu()
                        for k, m in zip(names, opt.mu)})
        return out

    def compared_steps(self, blocks: List[List[int]]) -> Dict:
        """Run the compared blocks; the program's readings (``first``: the
        first step's gradients, for the reference to judge)."""
        # on the host, so that the check adds nothing to the device's peak
        init = {k: v.to("cpu", copy=True) for k, v in self.leaves().items()}
        losses, first = {}, None
        for block in blocks:
            if block[0] != self.step:
                raise ValueError(f"compared block {block} is not next")
            metrics = self.run_block(block)
            losses[block[-1]] = {k: float(v) for k, v in metrics.items()}
            if first is None:
                if block != [1]:
                    raise ValueError("the first compared block is step 1")
                first = self.first_grads()
        change = {k: float(torch.linalg.vector_norm((v.cpu() - init[k])
                                                    .float()))
                  for k, v in self.leaves().items()}
        grads = {k: float(torch.linalg.vector_norm(g)) for k, g in first.items()}
        return {"losses": losses, "grads": grads, "change": change,
                "first": first}

    def warm(self) -> None:
        """Blocks up to the dispatch alignment, then whole blocks until
        every kind the window replays has been captured."""
        want = set(self.kinds(range(self.step, self.step + self.period())))
        while True:
            aligned = (self.step - 1) % self.k == 0
            captured = set(self.runner.stats["capture_seconds"])
            if aligned and (want <= captured
                            or not self.runner.graphs):
                return
            end = (self.step + self.k - 1 - (self.step - 1) % self.k)
            self.run_block(list(range(self.step, end + 1)))

    def window(self, seconds: float, stop_at: Optional[int] = None,
               period: Optional[int] = None) -> Dict:
        """Blocks of the dispatcher from an aligned step until ``seconds``
        have passed (or ``stop_at`` steps have run) at the end of a whole
        ``period`` (of step kinds where None); losses read every
        ``print_every`` steps."""
        period, n, kinds = period or self.period(), 0, {}
        self.sync()
        t0 = time.perf_counter()
        reads = [(0, t0)]  # (steps, time) at each loss read
        while True:
            blk = self.dispatcher.next_block(self.step)
            if blk.kind != "block":
                raise RuntimeError(f"step {self.step}: the window's blocks "
                                   f"must be graph blocks, got {blk.kind}")
            steps = list(range(self.step, self.step + blk.k))
            labels = blk.labels_block if self.trainer.conditional else None
            metrics = self.runner.run(blk.idx_block, labels,
                                      **self.step_args(np.asarray(steps)))
            for kind in self.kinds(steps):
                kinds[kind] = kinds.get(kind, 0) + 1
            self.step += blk.k
            n += blk.k
            if (self.step - 1) % self.P.print_every == 0:
                read = [float(v) for v in metrics.values()]  # waits, as the CLI
                reads.append((n, time.perf_counter()))
                if not all(math.isfinite(v) for v in read):
                    self.failed += self.P.print_every
            if n % period == 0 and (
                    n == stop_at if stop_at is not None
                    else time.perf_counter() - t0 >= seconds):
                break
        self.sync()
        seconds = time.perf_counter() - t0
        rates = [round((b[0] - a[0]) / (b[1] - a[1]), 2)
                 for a, b in zip(reads, reads[1:])]
        return {"steps": n, "seconds": seconds, "kinds": kinds,
                "t0": t0, "steps_per_s": rates}

    def close(self) -> None:
        """Free the program's device memory (graphs, pool, state)."""
        for entry in self.runner._captured.values():
            entry.graph.reset()
        self.runner = self.trainer = self.loader = self.dispatcher = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def compared_blocks(cfg: Dict) -> List[List[int]]:
    """The configuration's compared blocks, ``[first, last]`` steps each.
    The first graph block sets the runner's block size: no later block may
    be longer, so it is as long as the window's."""
    return [list(range(a, b + 1)) for a, b in cfg["compare"]]


def reference_readings(cfg: Dict, seed: int, device, blocks: List[List[int]],
                       first: Dict[str, torch.Tensor],
                       keep_first: bool = False) -> Dict:
    """The reference's readings of the compared steps, in float32 with
    TF32 off, from the same seed, images and rows; ``grad_diff``, the norm
    of each leaf's first gradient less the program's (``first``); with
    ``keep_first``, ``first``, its own first gradients on the host."""
    from benchmark.reference.step import Trainer
    from benchmark.reference.weights import make_weights

    ref = cfg["reference"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        images = make_images(cfg["data"], ref["model"]["image_size"], seed,
                             device)
        trainer = Trainer(ref, make_weights(ref["model"], seed, device), seed,
                          device)
        init = {k: v.detach().clone() for k, v in trainer.leaves().items()}
        rows = ref["recipe"]["batch_size"] * ref["recipe"]["n_critic"]
        visible = {b[-1] for b in blocks}
        losses, seconds = {}, []
        for step in range(1, blocks[-1][-1] + 1):
            t0 = time.perf_counter()
            idx = torch.as_tensor(batch_rows(seed, cfg["data"]["rows"], rows,
                                             step), device=images.device)
            out = trainer.step(images.index_select(0, idx), step)
            if step in visible:
                losses[step] = {k: float(v) for k, v in out.items()}
            else:
                float(out["G_loss"])  # waits for the step
            seconds.append(time.perf_counter() - t0)
        grads = {k: float(torch.linalg.vector_norm(g))
                 for k, g in trainer.first_grads.items()}
        diff = {k: float(torch.linalg.vector_norm(first[k].to(g.device) - g))
                for k, g in trainer.first_grads.items() if k in first}
        change = {k: float(torch.linalg.vector_norm(v.detach() - init[k]))
                  for k, v in trainer.leaves().items()}
        out = {"losses": losses, "grads": grads, "change": change,
               "grad_diff": diff, "seconds": seconds}
        if keep_first:
            out["first"] = {k: g.cpu() for k, g in trainer.first_grads.items()}
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]


def compared_readings(cfg: Dict, traffic: Dict, seed: int,
                      device: str = "cuda", extra_argv=(),
                      plant: Optional[Callable] = None):
    """The compared steps alone, with no window: the program's readings and
    the reference's."""
    prog = Program(cfg, traffic, seed, device, extra_argv)
    if plant is not None:
        plant(prog)
    blocks = compared_blocks(cfg)
    readings = prog.compared_steps(blocks)
    prog.close()
    del prog
    first = readings.pop("first")
    return readings, reference_readings(cfg, seed, device, blocks, first)


def compared_gaps(cfg: Dict, traffic: Dict, seed: int, device: str = "cuda",
                  extra_argv=(), plant: Optional[Callable] = None
                  ) -> Dict[str, float]:
    """The gaps that decide ``correct`` of the compared steps alone
    (``tools/readings.py`` reads them over many seeds)."""
    return compare.gaps(*compared_readings(cfg, traffic, seed, device,
                                           extra_argv, plant))


def control_readings(cfg: Dict, traffic: Dict, seed: int,
                     device: str = "cuda"):
    """The compared steps of the mix's control against the reference: for
    a float32 mix the program in bfloat16 (``--dtype bf16``, its own
    path); for a bfloat16 mix, which the program has no lower path below,
    the reference in the program's place with float8 products
    (``reference/fp8.py``)."""
    if traffic["dtype"] == "f32":
        return compared_readings(cfg, traffic, seed, device,
                                 ("--dtype", "bf16"))
    from benchmark.reference.fp8 import float8_products

    blocks = compared_blocks(cfg)
    with float8_products():
        low = reference_readings(cfg, seed, device, blocks, {},
                                 keep_first=True)
    first = low.pop("first")
    return low, reference_readings(cfg, seed, device, blocks, first)


def control_gaps(cfg: Dict, traffic: Dict, seed: int,
                 device: str = "cuda") -> Dict[str, float]:
    return compare.gaps(*control_readings(cfg, traffic, seed, device))


def run_cell(cfg: Dict, traffic: Dict, limits: Dict, seed: int,
             seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None,
             plant: Optional[Callable] = None) -> Dict:
    """One run of a training cell (see the module docstring). ``plant``,
    a fault for the tests, is called with the program once it is built.
    Returns the run's record for the result line and the metric readers."""
    from contrad_tpu_torch.training.graph import COUNTED

    from benchmark.harness.trace import LEAD_IN, record

    def counters() -> Dict[str, int]:
        """The program's launch counters of its hand-written kernels."""
        return {f"{op.__name__}.{name}": getattr(op, name)
                for op in COUNTED for name in ("launches", "scalar_launches")}

    t_start = time.perf_counter() if t_start is None else t_start
    blocks = compared_blocks(cfg)
    prog = Program(cfg, traffic, seed, device)
    log(f"built; K = {prog.k}, period {prog.period()} steps", t_start)
    if plant is not None:
        plant(prog)
    readings = prog.compared_steps(blocks)
    log(f"compared steps {blocks} run", t_start)
    prog.warm()
    log(f"warm at step {prog.step}; captured "
        f"{prog.runner.stats['capture_seconds']}", t_start)
    if traffic.get("settle_s"):
        settle = prog.window(traffic["settle_s"], period=prog.k)
        prog.failed = 0
        log(f"settled: {settle['steps']} steps in {settle['seconds']:.3f} s; "
            f"steps/s between loss reads {settle['steps_per_s']}", t_start)
    rec: Dict = {"k": prog.k, "period": prog.period()}
    counted = counters()
    if trace:
        steps = traffic["trace"]["min_steps"]
        steps = -(-steps // prog.period()) * prog.period()
        win = {}
        rec["trace"] = record(
            lambda: win.update(prog.window(0.0, stop_at=steps)), prog.sync,
            card=device == "cuda")
        rec["window_s"] = rec["trace"].window_s
        if device == "cuda":
            log(f"trace: the lead-in's {rec['trace'].lead_in} of {LEAD_IN} "
                f"kernels kept", t_start)
    else:
        win = prog.window(seconds)
        rec["setup_s"] = win["t0"] - t_start
    rec.update(window=win,
               counters={k: v - counted[k] for k, v in counters().items()},
               capture_s=sum(prog.runner.stats["capture_seconds"].values()),
               attempted=win["steps"], failed=min(prog.failed, win["steps"]),
               batch=prog.opt.batch_size * prog.opt.n_critic)
    if device == "cuda":
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"window: {win['steps']} steps in {win['seconds']:.3f} s "
        f"({win['kinds']}); steps/s between loss reads "
        f"{win['steps_per_s']}", t_start)
    prog.close()
    del prog
    ref = reference_readings(cfg, seed, device, blocks,
                             readings.pop("first"))
    log(f"reference done, steps {[round(s, 3) for s in ref['seconds']]} s",
        t_start)
    rec["checks"] = compare.checks(readings, ref, limits)
    rec["correct"] = all(c["value"] <= c["limit"]
                         for c in rec["checks"].values())
    return rec
