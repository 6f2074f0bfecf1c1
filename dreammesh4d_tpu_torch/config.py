"""Config system (counterpart of ``dreammesh4d_tpu/config.py``): YAML +
CLI-dotlist merge, ``${...}`` interpolation with resolvers, and dataclass
validation, read and written through the port's own YAML module
(:mod:`.utils.yaml_lite`), so that no PyYAML is needed.

- ``load_config(*yaml_files, cli_args=[...])`` merges YAML files left to
  right, then applies ``a.b.c=value`` dotlist overrides (values read as YAML),
  resolves interpolations, and validates into :class:`ExperimentConfig`.
- Interpolations: ``${path.to.key}`` references another key; ``${name:a,b}``
  calls a registered resolver: ``calc_exp_lr_decay_rate, add, sub, mul,
  div, idiv, basename, rmspace, tuple2, gt0, cmaxgt0, not,
  cmaxgt0orcmaxgt0``.
- ``parse_structured(Config, cfg_dict)`` fills a (possibly nested) dataclass,
  raising on unknown keys unless the dataclass declares ``__extra_ok__``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from .utils import yaml_lite
from .utils.schedule import C_max

# ---------------------------------------------------------------------------
# Resolvers
# ---------------------------------------------------------------------------

_RESOLVERS = {}


def register_resolver(name):
    def deco(fn):
        _RESOLVERS[name] = fn
        return fn

    return deco


@register_resolver("calc_exp_lr_decay_rate")
def _calc_exp_lr_decay_rate(factor, n):
    return float(factor) ** (1.0 / float(n))


@register_resolver("add")
def _add(a, b):
    return a + b


@register_resolver("sub")
def _sub(a, b):
    return a - b


@register_resolver("mul")
def _mul(a, b):
    return a * b


@register_resolver("div")
def _div(a, b):
    return a / b


@register_resolver("idiv")
def _idiv(a, b):
    return int(a) // int(b)


@register_resolver("basename")
def _basename(p):
    return os.path.basename(str(p))


@register_resolver("rmspace")
def _rmspace(s, sub):
    return str(s).replace(" ", str(sub))


@register_resolver("tuple2")
def _tuple2(s):
    return [s, s]


@register_resolver("gt0")
def _gt0(s):
    return s > 0


@register_resolver("not")
def _not(s):
    return not s


@register_resolver("cmaxgt0")
def _cmaxgt0(s):
    return C_max(s) > 0


@register_resolver("cmaxgt0orcmaxgt0")
def _cmaxgt0or(a, b):
    return (C_max(a) > 0) or (C_max(b) > 0)


# ---------------------------------------------------------------------------
# Dict-with-attribute-access node (tiny OmegaConf stand-in)
# ---------------------------------------------------------------------------


class ConfigDict(dict):
    """dict subclass with attribute access and recursive wrapping."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = _wrap(v)

    def __deepcopy__(self, memo):
        import copy

        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _wrap(v):
    if isinstance(v, ConfigDict):
        return v
    if isinstance(v, dict):
        return ConfigDict({k: _wrap(x) for k, x in v.items()})
    if isinstance(v, (list, tuple)):
        return [_wrap(x) for x in v]
    return v


def merge_dicts(base: dict, override: dict) -> dict:
    """Recursive dict merge; override wins."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = v
    return out


def parse_dotlist(dotlist) -> dict:
    """Parse ``["a.b=1", "c=[1,2]"]`` into a nested dict (YAML-typed values)."""
    out: dict = {}
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"Malformed dotlist override {item!r} (expected key=value)")
        key, val = item.split("=", 1)
        parsed = yaml_lite.safe_load(val) if val != "" else None
        node = out
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"Dotlist key {key} conflicts with scalar value")
        node[parts[-1]] = parsed
    return out


# ---------------------------------------------------------------------------
# Interpolation resolution
# ---------------------------------------------------------------------------

_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


def _lookup(root, path: str):
    node = root
    for p in path.split("."):
        if isinstance(node, dict):
            if p not in node:
                raise KeyError(f"Interpolation ${{{path}}}: key {p!r} not found")
            node = node[p]
        elif isinstance(node, (list, tuple)):
            node = node[int(p)]
        else:
            raise KeyError(f"Interpolation ${{{path}}}: cannot descend into {type(node)}")
    return node


def _split_args(s: str):
    """Split resolver args on commas, respecting [] nesting."""
    args, depth, cur = [], 0, ""
    for ch in s:
        if ch == "," and depth == 0:
            args.append(cur)
            cur = ""
        else:
            if ch in "[(":
                depth += 1
            elif ch in "])":
                depth -= 1
            cur += ch
    if cur:
        args.append(cur)
    return args


def _resolve_expr(expr: str, root, depth):
    expr = expr.strip()
    if ":" in expr:
        name, _, argstr = expr.partition(":")
        name = name.strip()
        if name in _RESOLVERS:
            args = [_resolve_value(a.strip(), root, depth + 1) for a in _split_args(argstr)]
            return _RESOLVERS[name](*args)
    return _resolve_node(_lookup(root, expr), root, depth + 1)


def _resolve_value(v, root, depth=0):
    """Resolve a string that may contain interpolations (or be a plain YAML
    scalar).  Nested interpolations (``${add:${a},2}``) resolve innermost-first
    iteratively."""
    if depth > 32:
        raise RecursionError("Interpolation depth exceeded (cycle?)")
    if not isinstance(v, str):
        return v
    for _ in range(32):
        # whole-string interpolation keeps the referenced value's type
        m = _INTERP_RE.fullmatch(v.strip())
        if m:
            out = _resolve_expr(m.group(1), root, depth)
            if isinstance(out, str) and "${" in out:
                v = out
                continue
            return out
        if "${" not in v:
            # resolver args arrive as raw strings; parse scalars as YAML
            try:
                return yaml_lite.safe_load(v)
            except yaml_lite.YAMLError:
                return v
        # replace innermost (non-nested) interpolations textually, then loop
        v = _INTERP_RE.sub(lambda m: str(_resolve_expr(m.group(1), root, depth)), v)
    raise RecursionError(f"Interpolation did not converge: {v!r}")


def _resolve_node(node, root, depth=0):
    if depth > 64:
        raise RecursionError("Config resolution depth exceeded")
    if isinstance(node, dict):
        return ConfigDict({k: _resolve_node(v, root, depth + 1) for k, v in node.items()})
    if isinstance(node, (list, tuple)):
        return [_resolve_node(v, root, depth + 1) for v in node]
    if isinstance(node, str) and "${" in node:
        return _resolve_value(node, root, depth + 1)
    return node


def resolve(cfg: dict) -> ConfigDict:
    """Resolve all interpolations in a raw config dict."""
    return _resolve_node(cfg, cfg)


# ---------------------------------------------------------------------------
# Structured parsing into dataclasses
# ---------------------------------------------------------------------------


def parse_structured(fields_cls, cfg: Optional[dict] = None):
    """Instantiate dataclass ``fields_cls`` from dict ``cfg``: unknown keys
    raise, nested dataclass fields recurse, missing keys use defaults.
    Fields typed ``dict``/``Any`` pass through as ConfigDict."""
    cfg = dict(cfg or {})
    if not dataclasses.is_dataclass(fields_cls):
        raise TypeError(f"{fields_cls} is not a dataclass")
    kwargs = {}
    names = {f.name: f for f in dataclasses.fields(fields_cls)}
    extra_ok = getattr(fields_cls, "__extra_ok__", False)
    for k, v in cfg.items():
        if k not in names:
            if extra_ok:
                continue
            raise ValueError(f"Unknown config key {k!r} for {fields_cls.__name__}")
        f = names[k]
        if dataclasses.is_dataclass(f.type) and isinstance(v, dict):
            kwargs[k] = parse_structured(f.type, v)
        else:
            kwargs[k] = _wrap(v)
    return fields_cls(**kwargs)


# ---------------------------------------------------------------------------
# ExperimentConfig
# ---------------------------------------------------------------------------


@dataclass
class ExperimentConfig:
    name: str = "default"
    description: str = ""
    tag: str = ""
    seed: int = 0
    use_timestamp: bool = True
    timestamp: Optional[str] = None
    exp_root_dir: str = "outputs"

    n_gpus: int = 1

    resume: Optional[str] = None

    data_type: str = ""
    data: Any = field(default_factory=ConfigDict)

    system_type: str = ""
    system: Any = field(default_factory=ConfigDict)

    trainer: Any = field(default_factory=ConfigDict)
    checkpoint: Any = field(default_factory=ConfigDict)

    # filled post-parse
    trial_name: str = ""
    trial_dir: str = ""
    exp_dir: str = ""

    def finalize(self):
        """Compute the trial's name and directories."""
        if not self.tag and not self.use_timestamp:
            raise ValueError("Either tag is specified or use_timestamp is True.")
        self.trial_name = self.tag
        if self.timestamp is None:
            self.timestamp = ""
            if self.use_timestamp:
                if self.n_gpus > 1:
                    logging.getLogger(__name__).warning("Exp timestamp disabled when n_gpus > 1.")
                else:
                    self.timestamp = time.strftime("@%Y%m%d-%H%M%S")
        self.trial_name += self.timestamp
        self.exp_dir = os.path.join(self.exp_root_dir, self.name)
        self.trial_dir = os.path.join(self.exp_dir, self.trial_name)
        return self


def load_config(*yaml_files: str, cli_args=None, from_string: Optional[str] = None,
                n_gpus: int = 1, makedirs: bool = True) -> ExperimentConfig:
    """Load + merge YAMLs and CLI dotlist into a validated ExperimentConfig."""
    raw: dict = {}
    if from_string is not None:
        raw = yaml_lite.safe_load(from_string) or {}
    for f in yaml_files:
        with open(f) as fh:
            raw = merge_dicts(raw, yaml_lite.safe_load(fh) or {})
    if cli_args:
        raw = merge_dicts(raw, parse_dotlist(cli_args))
    raw.setdefault("n_gpus", n_gpus)
    resolved = resolve(raw)
    cfg = parse_structured(ExperimentConfig, resolved).finalize()
    if makedirs:
        os.makedirs(cfg.trial_dir, exist_ok=True)
    return cfg


def config_to_primitive(cfg) -> Any:
    if isinstance(cfg, dict):
        return {k: config_to_primitive(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [config_to_primitive(v) for v in cfg]
    return cfg


def dump_config(path: str, cfg) -> None:
    if dataclasses.is_dataclass(cfg):
        cfg = dataclasses.asdict(cfg)
    with open(path, "w") as f:
        yaml_lite.safe_dump(config_to_primitive(cfg), f)
