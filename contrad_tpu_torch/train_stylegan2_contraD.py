"""High-resolution StyleGAN2 + ContraD CLI of the port (the counterpart of
the repo root's ``train_stylegan2_contraD.py``): ``train_stylegan2`` with
the recipe's defaults (``--mode contrad --aug simclr_hq --lbd_r1 0.5
--evaluate_every 5000 --n_eval_avg 1``); flags given explicitly win.

    python -m contrad_tpu_torch.train_stylegan2_contraD \\
        configs/gan/stylegan2/afhq_dog_style64.toml stylegan2_512 \\
        --halflife_k 20 --use_warmup --no_gif
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

from contrad_tpu_torch.train_stylegan2 import main as train_main
from contrad_tpu_torch.utils.run import History

DEFAULTS = {
    "--mode": "contrad",
    "--aug": "simclr_hq",
    "--lbd_r1": "0.5",
    "--evaluate_every": "5000",
    "--n_eval_avg": "1",
}


def with_defaults(argv: Sequence[str]) -> List[str]:
    """``argv`` with each recipe default appended that it does not set."""
    argv = list(argv)
    given = {a.split("=", 1)[0] for a in argv}
    for flag, value in DEFAULTS.items():
        if flag not in given:
            argv += [flag, value]
    return argv


def main(argv: Optional[Sequence[str]] = None) -> History:
    return train_main(with_defaults(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
