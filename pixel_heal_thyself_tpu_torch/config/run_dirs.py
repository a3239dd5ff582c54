"""Run-directory allocation for the ``${pht_run_dirs:...}`` resolver.

Layout contract (capability parity with the reference resolver,
`pht/hydra/plugins/pht_run_dirs_resolver.py:14-118`):

* single runs:   ``outputs/runs/<base_pattern>/runNNN``
* sweeps:        ``outputs/trials/runNNN/<job_subdir>``

``NNN`` auto-increments past the highest existing ``runNNN`` sibling unless
an explicit non-negative ``run_num`` is supplied. Because the config engine
may interpolate the resolver several times while composing one config (e.g.
for both the run dir and ``paths.output_dir``), the first resolution is
pinned in a process-level cache and every later call reuses it — that is
what guarantees all interpolations land in the same directory.

Copy of the JAX package's `pixel_heal_thyself_tpu/config/run_dirs.py`, so that the
port imports nothing of that package; tests/test_torch_port_host.py
holds the two equal.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from pixel_heal_thyself_tpu_torch.config.loader import register_resolver
from pixel_heal_thyself_tpu_torch.logger import logger
from pixel_heal_thyself_tpu_torch.utils import (
    SingletonMeta,
    is_none_or_empty,
    is_truthy,
)

_RUN_NAME = re.compile(r"run(\d+)")


@dataclass
class RunDirsCache(metaclass=SingletonMeta):
    """Process-level pin of the first resolved run directory."""

    is_multirun: Optional[bool] = None
    run_dir: Optional[Path] = None

    def reset(self) -> None:
        self.is_multirun = None
        self.run_dir = None


def _as_run_num(raw) -> int:
    """Explicit run number, or -1 (auto) for anything non-integer."""
    try:
        return int(raw)
    except (TypeError, ValueError):
        return -1


def _next_free_index(parent: Path) -> int:
    taken = (
        int(m.group(1))
        for m in (_RUN_NAME.match(p.name) for p in parent.iterdir())
        if m is not None
    )
    return max(taken, default=-1) + 1


def _allocate_run_dir(parent: Path, run_num: int) -> Path:
    parent.mkdir(parents=True, exist_ok=True)
    index = run_num if run_num >= 0 else _next_free_index(parent)
    allocated = parent / f"run{index:03d}"
    allocated.mkdir(parents=True, exist_ok=True)
    return allocated


def pht_run_dirs_resolver(
    cfg_output_root_dir: str = "outputs",
    cfg_base_pattern: Optional[str] = None,
    cfg_job_subdir: Optional[str] = None,
    cfg_run_num: Optional[str] = "-1",
    cfg_is_multirun: Optional[str] = "False",
) -> str:
    """Resolve (creating on first use) the run directory for this process.

    The argument order is the interpolation contract used by the YAML tree
    (``${pht_run_dirs:root,pattern,subdir,run_num,is_multirun}``); all values
    arrive as strings.
    """
    cache = RunDirsCache()
    root = Path.cwd()
    sweeping = is_truthy(cfg_is_multirun)
    if sweeping:
        cache.is_multirun = True

    if cache.run_dir is None:
        if sweeping:
            parent = root / str(cfg_output_root_dir) / "trials"
        elif is_none_or_empty(cfg_base_pattern):
            raise ValueError("base_pattern required for single-run directories")
        else:
            parent = (
                root / str(cfg_output_root_dir) / "runs" / str(cfg_base_pattern)
            )
        cache.run_dir = _allocate_run_dir(parent, _as_run_num(cfg_run_num))

    resolved = cache.run_dir
    # Sweep jobs each get their own leaf under the shared trials/runNNN.
    if cache.is_multirun and not is_none_or_empty(cfg_job_subdir):
        resolved = resolved / str(cfg_job_subdir)
        resolved.mkdir(parents=True, exist_ok=True)

    rel = str(resolved.relative_to(root))
    logger.info(f"Resolved run directory: {rel}")
    return rel


def register_run_dirs_resolver() -> None:
    """Register `${pht_run_dirs:...}` plus a `${cwd:}` helper resolver."""
    register_resolver("pht_run_dirs", pht_run_dirs_resolver)
    register_resolver("cwd", lambda: str(Path.cwd()))


def reset_run_dirs_cache() -> None:
    RunDirsCache().reset()
