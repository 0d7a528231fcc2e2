"""YAML config with dotted CLI overrides (first-party OmegaConf replacement).

The reference drives everything from OmegaConf YAML + dotted CLI merges
(reference ``train.py:223-226``). We keep the same user-facing surface:

    python train.py config=configs/tiny.yaml optimizer.learning_rate=3e-4

but implement it with a tiny attribute-access dict so the framework has no
dependency on OmegaConf.

The port's own copy of ``titok_tpu/config.py`` (the port imports nothing
from the JAX package); it needs only yaml.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Mapping

import re

import yaml


class _Loader(yaml.SafeLoader):
    """SafeLoader + YAML-1.2-style float resolution: YAML 1.1 parses
    ``1e-4`` (no dot) as a *string*; configs absolutely mean the float."""


_Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9][0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def yaml_load(text):
    return yaml.load(text, Loader=_Loader)


class Config(dict):
    """A dict with attribute access, recursive wrapping and dotted set/get."""

    def __init__(self, data: Mapping[str, Any] | None = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    # -- wrapping -----------------------------------------------------------
    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, Config):
            value = Config(value)
        elif isinstance(value, list):
            value = [Config(v) if isinstance(v, Mapping) else v for v in value]
        super().__setitem__(key, value)

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    # -- dotted access ------------------------------------------------------
    def get_dotted(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def set_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Config):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value

    def merge(self, other: Mapping[str, Any]) -> "Config":
        for k, v in other.items():
            if k in self and isinstance(self[k], Config) and isinstance(v, Mapping):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    def to_dict(self) -> dict:
        out: dict = {}
        for k, v in self.items():
            if isinstance(v, Config):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, Config) else x for x in v]
            else:
                out[k] = v
        return out

    def to_yaml(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config(copy.deepcopy(self.to_dict(), memo))

    def __repr__(self) -> str:  # pragma: no cover
        return f"Config({json.dumps(self.to_dict(), indent=2, default=str)})"


def _parse_value(raw: str) -> Any:
    """Parse a CLI override value the way OmegaConf would (YAML scalar).

    YAML 1.1 treats ``1e-4`` (no dot) as a *string*; users absolutely mean
    the float — handle numeric forms before falling back to YAML.
    """
    s = raw.strip()
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    try:
        return yaml_load(raw)
    except yaml.YAMLError:
        return raw


def parse_cli_overrides(argv: list[str]) -> Config:
    """Parse ``key.path=value`` args into a nested Config."""
    cfg = Config()
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"CLI override must be key=value, got: {arg!r}")
        key, _, raw = arg.partition("=")
        cfg.set_dotted(key.strip(), _parse_value(raw))
    return cfg


def load_config(path: str, overrides: list[str] | None = None) -> Config:
    """Load a YAML config file and merge dotted CLI overrides over it."""
    with open(path) as f:
        cfg = Config(yaml_load(f.read()) or {})
    if overrides:
        cfg.merge(parse_cli_overrides(overrides))
    return cfg


def config_from_cli(argv: list[str]) -> Config:
    """Reference-compatible entry: first arg ``config=<yaml>``, rest merges."""
    cli = parse_cli_overrides(argv)
    if "config" not in cli:
        raise ValueError("usage: train.py config=<path/to.yaml> [dotted.overrides=...]")
    cfg = load_config(cli["config"])
    cfg.merge(cli)
    return cfg
