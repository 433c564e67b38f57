"""``python -m contrad_tpu_torch.train_stylegan2_contraD``, the port's CLI
of the 512x512 recipe: the README's command line (the recipe's defaults,
``simclr_hq``, the evaluation flags, with FID reported as disabled where
the Inception weights are missing) runs two steps on the CPU at the ``stylegan2_tiny`` width on
synthetic 32x32 data, the second with the lazy R1 (``--d_reg_every 2``),
and prints finite losses; flags given explicitly win over the recipe's
defaults."""

import math
import os
import re
import subprocess
import sys
from pathlib import Path

from contrad_tpu_torch.train_stylegan2 import parse_args
from contrad_tpu_torch.train_stylegan2_contraD import with_defaults

ROOT = Path(__file__).resolve().parent.parent
README_FLAGS = ["configs/gan/stylegan2/afhq_dog_style64.toml",
                "stylegan2_tiny", "--mode", "contrad", "--aug", "simclr_hq",
                "--lbd_r1", "0.5", "--halflife_k", "20", "--use_warmup",
                "--evaluate_every", "5000", "--n_eval_avg", "1", "--no_gif"]


def test_recipe_defaults_fill_in_and_explicit_flags_win():
    P = parse_args(with_defaults(["c.toml", "stylegan2_512"]))
    assert (P.mode, P.aug, P.lbd_r1, P.evaluate_every, P.n_eval_avg) == (
        "contrad", "simclr_hq", 0.5, 5000, 1)
    P = parse_args(with_defaults(["c.toml", "stylegan2_512", "--aug=simclr",
                                  "--lbd_r1", "0.1", "--override", "a=1"]))
    assert (P.aug, P.lbd_r1, P.override, P.mode) == (
        "simclr", 0.1, ["a=1"], "contrad")


def test_readme_command_runs_two_cpu_steps(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "contrad_tpu_torch.train_stylegan2_contraD",
         *README_FLAGS, "--d_reg_every", "2", "--device", "cpu",
         "--print_every", "1", "--override", "options.dataset=synthetic_32",
         "options.batch_size=4", "options.max_steps=2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT),
                 INCEPTION_WEIGHTS=str(tmp_path / "missing.pth")))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FID disabled: Inception FID weights not found" in out.stdout
    losses = [dict(re.findall(r"(\w+)=(\S+)", line))
              for line in out.stdout.splitlines() if "D_loss=" in line]
    assert len(losses) == 2
    for rec in losses:
        for k in ("D_loss", "D_penalty", "D_real", "D_gen", "D_r1", "G_loss"):
            assert math.isfinite(float(rec[k])), (k, rec)
    assert float(losses[0]["D_r1"]) == 0 and float(losses[1]["D_r1"]) > 0
