"""Experiment configs (counterpart of cips3dpp_tpu/io/config.py).

The reference's YAML convention (SURVEY.md §5): one file per experiment,
one section per command, `base:` inheritance between sections, and dotted
`key.path value` overrides on the command line. `load_command_config`
resolves a section through its `base:` chain, `apply_overrides` applies
the overrides, `generator_config_from_dict` builds the port's
GeneratorConfig. PyYAML is imported only to read a file: overrides alone
need nothing beyond the standard library.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Mapping, Sequence


def _deep_merge(base: dict, override: Mapping) -> dict:
    """Recursive dict merge: override wins, nested dicts merge."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, Mapping):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _resolve_section(doc: Mapping, name: str, _stack=()) -> dict:
    if name in _stack:
        raise ValueError(f"base: cycle at {name!r} via {_stack}")
    section = doc.get(name)
    if section is None:
        raise KeyError(f"no config section {name!r}; have {sorted(doc)}")
    section = dict(section)
    base_name = section.pop("base", None)
    if base_name is None:
        return section
    return _deep_merge(_resolve_section(doc, base_name, _stack + (name,)), section)


def load_command_config(path: str, command: str) -> dict:
    """Read a YAML file and resolve section `command` through its base: chain."""
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(f"reading {path} needs PyYAML, which is not installed; "
                           "pass the settings with --opts instead") from e
    with open(path) as f:
        doc = yaml.safe_load(f)
    return _resolve_section(doc, command)


def _parse_value(s: str) -> Any:
    """A command-line value: JSON first, then true/false/none, else the string."""
    try:
        return json.loads(s)
    except (json.JSONDecodeError, TypeError):
        pass
    low = str(s).lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    return s


def apply_overrides(cfg: dict, opts: Sequence[str]) -> dict:
    """`k.path value k2.path value2 ...` dotted overrides."""
    if len(opts) % 2 != 0:
        raise ValueError(f"overrides must be key/value pairs, got {opts}")
    cfg = copy.deepcopy(cfg)
    for key, raw in zip(opts[::2], opts[1::2]):
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(raw)
    return cfg


def generator_config_from_dict(d: Mapping):
    """GeneratorConfig from a (possibly partial) nested dict; dataclass
    defaults for everything unspecified, unknown keys ignored."""
    from ..models.generator import (
        DecoderConfig, GeneratorConfig, MappingConfig, RendererConfig,
    )

    def build(cls, sub: Mapping):
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in sub.items() if k in fields})

    parts = {"renderer": RendererConfig, "mapping": MappingConfig, "decoder": DecoderConfig}
    kwargs = {k: build(cls, d[k]) for k, cls in parts.items() if k in d}
    top = {f.name for f in dataclasses.fields(GeneratorConfig)}
    kwargs.update({k: v for k, v in d.items() if k in top and k not in parts})
    return GeneratorConfig(**kwargs)
