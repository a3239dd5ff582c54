"""Minimal Hydra-like YAML config composer.

Implements the subset of Hydra/OmegaConf semantics the reference relies on
(reference `config/default.yaml:1-5` defaults list, `${...}` interpolation,
custom resolvers like `${pht_run_dirs:...}`, dotted CLI overrides):

- defaults lists: ``defaults: [- _self_, - model: afgsa, - data: default]``
  where plain entries name sibling files and ``group: name`` entries load
  ``<group>/<name>.yaml`` into the ``group`` key. Merge order follows the
  list; ``_self_`` positions this file's own content. Group files may have
  their own (group-relative) defaults (e.g. ``model/afgsa.yaml`` pulling in
  ``model/common.yaml``).
- interpolation: ``${dotted.path}`` looks up the merged tree;
  ``${name:arg1, arg2}`` calls a registered resolver. Nested interpolations
  in resolver args are supported. A string that is exactly one
  interpolation keeps the native type of the result.
- CLI overrides: ``a.b.c=value`` (yaml-parsed value); ``+a.b=value`` adds a
  new key. Also fixes the reference quirk where a dotted literal key like
  ``images.dir:`` under ``data:`` silently failed to nest
  (reference `config/ci.yaml:6`): here dotted mapping keys nest properly.

Copy of the JAX package's `pixel_heal_thyself_tpu/config/loader.py`, so that the
port imports nothing of that package; tests/test_torch_port_host.py
holds the two equal.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Callable

import yaml

_RESOLVERS: dict[str, Callable[..., Any]] = {}


class _YamlLoader(yaml.SafeLoader):
    """SafeLoader with YAML 1.2 float resolution (pyyaml's YAML 1.1 rules
    treat `1e-4` — no dot before the exponent — as a string)."""


_YamlLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:
            [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
            |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
            |\.[0-9][0-9_]*(?:[eE][-+]?[0-9]+)?
            |[-+]?\.(?:inf|Inf|INF)
            |\.(?:nan|NaN|NAN)
        )$""",
        re.X,
    ),
    list("-+0123456789."),
)


def _yaml_load(text: str) -> Any:
    return yaml.load(text, Loader=_YamlLoader)


def register_resolver(name: str, fn: Callable[..., Any], replace: bool = True) -> None:
    """Register a custom `${name:args}` resolver."""
    if not replace and name in _RESOLVERS:
        raise ValueError(f"resolver {name!r} already registered")
    _RESOLVERS[name] = fn


def default_config_dir() -> Path:
    """The bundled YAML config tree shipped with the package."""
    return Path(__file__).resolve().parent.parent / "configs"


# ---------------------------------------------------------------------------
# merging


def _deep_merge(base: dict, over: dict) -> dict:
    """Merge `over` into `base` (returns new dict); dicts merge recursively."""
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _nest_dotted_keys(node: Any) -> Any:
    """Recursively expand literal dotted mapping keys into nested dicts."""
    if not isinstance(node, dict):
        return node
    out: dict = {}
    for k, v in node.items():
        v = _nest_dotted_keys(v)
        if isinstance(k, str) and "." in k:
            parts = k.split(".")
            sub: Any = v
            for p in reversed(parts[1:]):
                sub = {p: sub}
            out = _deep_merge(out, {parts[0]: sub})
        else:
            if k in out and isinstance(out[k], dict) and isinstance(v, dict):
                out[k] = _deep_merge(out[k], v)
            else:
                out[k] = v
    return out


def _load_yaml(path: Path) -> dict:
    if not path.exists():
        raise FileNotFoundError(f"config file not found: {path}")
    with open(path) as f:
        data = _yaml_load(f.read()) or {}
    if not isinstance(data, dict):
        raise TypeError(f"config file must be a mapping: {path}")
    return _nest_dotted_keys(data)


def _compose_file(
    config_dir: Path,
    rel_name: str,
    group_prefix: str = "",
    group_choices: dict[str, str] | None = None,
) -> dict:
    """Load one YAML file, recursively applying its defaults list.

    `group_prefix` is the group path of this file ('' for root files,
    'model' for files under configs/model/, ...). Non-_self_ entries are
    resolved relative to the file's own group directory; `group: name`
    entries nest their content under `group` relative to this file's level.
    `group_choices` overrides which file a group entry loads (Hydra's
    `group=name` CLI override).
    """
    path = config_dir / group_prefix / f"{rel_name}.yaml"
    raw = _load_yaml(path)
    defaults = raw.pop("defaults", None)
    if defaults is None:
        return raw

    merged: dict = {}
    self_seen = False
    for entry in defaults:
        if entry == "_self_":
            merged = _deep_merge(merged, raw)
            self_seen = True
        elif isinstance(entry, str):
            merged = _deep_merge(
                merged,
                _compose_file(config_dir, entry, group_prefix, group_choices),
            )
        elif isinstance(entry, dict):
            for group, name in entry.items():
                sub_prefix = str(Path(group_prefix) / group) if group_prefix else group
                chosen = (group_choices or {}).get(sub_prefix, str(name))
                sub = _compose_file(config_dir, chosen, sub_prefix, group_choices)
                merged = _deep_merge(merged, {group: sub})
        else:
            raise TypeError(f"bad defaults entry {entry!r} in {path}")
    if not self_seen:
        merged = _deep_merge(merged, raw)
    return merged


# ---------------------------------------------------------------------------
# overrides


def _parse_override(s: str) -> tuple[str, Any, bool]:
    if "=" not in s:
        raise ValueError(f"override must look like key=value, got {s!r}")
    key, _, val = s.partition("=")
    allow_new = key.startswith("+")
    key = key.lstrip("+").strip()
    return key, _yaml_load(val) if val != "" else "", allow_new


def _set_path(cfg: dict, dotted: str, value: Any, allow_new: bool = False) -> None:
    parts = dotted.split(".")
    node = cfg
    for depth, p in enumerate(parts[:-1]):
        nxt = node.get(p)
        if not isinstance(nxt, dict):
            if not allow_new and p not in node:
                raise KeyError(
                    f"override path {dotted!r} does not exist in the config "
                    f"(unknown key {'.'.join(parts[: depth + 1])!r}); "
                    "prefix with '+' to add a new key",
                )
            nxt = {}
            node[p] = nxt
        node = nxt
    if not allow_new and parts[-1] not in node:
        raise KeyError(
            f"override key {dotted!r} does not exist in the config; "
            "prefix with '+' to add a new key",
        )
    node[parts[-1]] = value


# ---------------------------------------------------------------------------
# interpolation

_INTERP_RE = re.compile(r"\$\{")


def _find_closing(s: str, start: int) -> int:
    """Index of the `}` matching the `${` whose `$` is at `start`."""
    depth = 0
    i = start
    while i < len(s):
        if s.startswith("${", i):
            depth += 1
            i += 2
        elif s[i] == "}":
            depth -= 1
            if depth == 0:
                return i
            i += 1
        else:
            i += 1
    raise ValueError(f"unbalanced interpolation in {s!r}")


def _lookup(cfg: dict, dotted: str) -> Any:
    node: Any = cfg
    for p in dotted.strip().split("."):
        if not isinstance(node, dict) or p not in node:
            raise KeyError(f"interpolation key not found: {dotted!r}")
        node = node[p]
    return node


def _split_top_level(s: str, sep: str) -> list[str]:
    parts, depth, cur = [], 0, []
    i = 0
    while i < len(s):
        if s.startswith("${", i):
            depth += 1
            cur.append("${")
            i += 2
            continue
        c = s[i]
        if c == "}" and depth > 0:
            depth -= 1
        if c == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    parts.append("".join(cur))
    return parts


class _Resolver:
    def __init__(self, cfg: dict) -> None:
        self.cfg = cfg
        self._active: set[str] = set()

    def resolve_value(self, v: Any) -> Any:
        if isinstance(v, str):
            return self.resolve_str(v)
        if isinstance(v, dict):
            return {k: self.resolve_value(x) for k, x in v.items()}
        if isinstance(v, list):
            return [self.resolve_value(x) for x in v]
        return v

    def resolve_str(self, s: str) -> Any:
        m = _INTERP_RE.search(s)
        if not m:
            return s
        start = m.start()
        end = _find_closing(s, start)
        inner = s[start + 2 : end]
        value = self._eval(inner)
        if start == 0 and end == len(s) - 1:
            return self.resolve_value(value) if isinstance(value, str) else value
        rendered = self.resolve_value(value)
        return self.resolve_str(s[:start] + _to_str(rendered) + s[end + 1 :])

    def _eval(self, inner: str) -> Any:
        head = _split_top_level(inner, ":")
        if len(head) > 1 and head[0].strip() in _RESOLVERS:
            name = head[0].strip()
            argstr = inner[len(head[0]) + 1 :]
            args = [self.resolve_str(a.strip()) for a in _split_top_level(argstr, ",")]
            if args == [""]:
                args = []
            return _RESOLVERS[name](*args)
        key = self.resolve_str(inner.strip())
        key = str(key)
        if key in self._active:
            raise ValueError(f"interpolation cycle at {key!r}")
        self._active.add(key)
        try:
            return self.resolve_value(_lookup(self.cfg, key))
        finally:
            self._active.discard(key)


def _to_str(v: Any) -> str:
    # floats render as-is ("1.0" not "1") — run-dir names like
    # afgsa_p128_n400_r1.0 depend on it (reference parity)
    if isinstance(v, bool):
        return str(v).lower()
    return str(v)


def resolve(cfg: dict) -> dict:
    """Resolve all interpolations in a merged config tree."""
    return _Resolver(cfg).resolve_value(cfg)


# ---------------------------------------------------------------------------
# public entry


def compose(
    config_name: str = "default",
    overrides: list[str] | None = None,
    config_dir: str | Path | None = None,
    resolve_interpolations: bool = True,
) -> dict:
    """Compose a config tree: defaults list + CLI overrides + interpolation."""
    config_dir = Path(config_dir) if config_dir else default_config_dir()
    # split overrides into group choices (key names a config group dir and
    # the value a file inside it, e.g. model=mamba) and value overrides
    group_choices: dict[str, str] = {}
    value_overrides: list[tuple[str, Any, bool]] = []
    for ov in overrides or []:
        key, val, allow_new = _parse_override(ov)
        group_path = config_dir / key.replace(".", "/")
        if (
            isinstance(val, str)
            and group_path.is_dir()
            and (group_path / f"{val}.yaml").exists()
        ):
            group_choices[key.replace(".", "/")] = val
        else:
            value_overrides.append((key, val, allow_new))
    cfg = _compose_file(config_dir, config_name, group_choices=group_choices)
    for key, val, allow_new in value_overrides:
        _set_path(cfg, key, val, allow_new=allow_new)
    if resolve_interpolations:
        cfg = resolve(cfg)
    return cfg
