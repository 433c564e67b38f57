"""Layered configuration (copy of ``contrad_tpu/config.py``, ``dump_toml``
included).

Configs are parsed as ``[defaults/gan, defaults/augment, experiment]`` with
later files overriding earlier ones, plus dotted-path CLI overrides
(``options.lr=1e-4``). The port reads the same TOML files as the JAX package.
"""

from __future__ import annotations

import ast
import copy
import tomllib
from pathlib import Path
from typing import Any, Iterable


class Config(dict):
    """A dict with attribute access and recursive wrapping."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, Config) else v
                for k, v in self.items()}


def _deep_update(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def _parse_value(text: str) -> Any:
    """Parse a CLI override value: python literal if possible, else string."""
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def apply_override(cfg: dict, dotted_key: str, value: Any) -> None:
    parts = dotted_key.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, Config())
    node[parts[-1]] = value


def load_config(files: Iterable[str | Path],
                overrides: Iterable[str] = ()) -> Config:
    """Load and merge TOML config files in order, then apply CLI overrides
    (``options.lr=0.0002``)."""
    merged: dict = {}
    for f in files:
        with open(Path(f), "rb") as fp:
            _deep_update(merged, tomllib.load(fp))
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must look like key.path=value, got: {ov}")
        key, _, val = ov.partition("=")
        apply_override(merged, key.strip(), _parse_value(val.strip()))
    return Config.wrap(merged)


def _toml_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"cannot serialize {type(v)!r} to TOML")


def dump_toml(cfg: dict) -> str:
    """Serialize a (possibly nested) config dict to TOML text: the EFFECTIVE
    config (defaults + experiment + CLI ``--override``s) that a run keeps
    in its logdir, so that a resume or an evaluation CLI rebuilds the run
    that was trained, not the one the experiment file names."""

    def section(prefix: str, d: dict, out: list) -> None:
        scalars = {k: v for k, v in d.items() if not isinstance(v, dict)}
        tables = {k: v for k, v in d.items() if isinstance(v, dict)}
        if prefix and (scalars or not tables):
            out.append(f"[{prefix}]")
        for k, v in scalars.items():
            out.append(f"{k} = {_toml_value(v)}")
        if scalars:
            out.append("")
        for k, v in tables.items():
            section(f"{prefix}.{k}" if prefix else k, v, out)

    out: list = ["# effective config (defaults + experiment + CLI overrides)"]
    section("", cfg.to_dict() if isinstance(cfg, Config) else dict(cfg), out)
    return "\n".join(out) + "\n"


def default_config_files(experiment: str | Path,
                         repo_root: str | Path | None = None) -> list[Path]:
    """[defaults/gan.toml, defaults/augment.toml, experiment]."""
    if repo_root is None:
        repo_root = Path(__file__).resolve().parent.parent
    root = Path(repo_root)
    return [
        root / "configs" / "defaults" / "gan.toml",
        root / "configs" / "defaults" / "augment.toml",
        Path(experiment),
    ]


# Default "options" values (reference train_gan.py:103-121).
OPTION_DEFAULTS = dict(
    batch_size=64,
    fid_size=10000,
    max_steps=200000,
    warmup=0,
    n_critic=1,
    lr=2e-4,
    lr_d=None,
    beta=(0.5, 0.999),
    lbd=10.0,
    lbd2=10.0,
)


def finalize_options(cfg: Config) -> Config:
    """Fill option defaults and derived fields (lr_d defaults to lr)."""
    opts = cfg.setdefault("options", Config())
    for k, v in OPTION_DEFAULTS.items():
        opts.setdefault(k, copy.deepcopy(v))
    if opts.get("lr_d") is None:
        opts["lr_d"] = opts["lr"]
    if isinstance(opts.get("beta"), list):
        opts["beta"] = tuple(opts["beta"])
    for required in ("dataset", "loss"):
        if required not in opts:
            raise ValueError(
                f"options.{required} is required (set it in the experiment config)")
    return cfg
