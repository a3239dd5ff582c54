"""The PyTorch port never imports JAX, flax or the JAX package.

A fresh interpreter imports every module of `pixel_heal_thyself_tpu_torch`
(and `chip_smoke`) and reports which of jax/flax/jaxlib and which modules
of `pixel_heal_thyself_tpu` ended up in `sys.modules`. The port keeps its
own copies of the host-side modules it needs (config, curves, logger,
run-once helpers, EXR IO, preprocessing, synthetic data, metrics). The
check runs in a subprocess because this test process has JAX loaded
already.
"""

from __future__ import annotations

import json
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

REPO = Path(__file__).resolve().parent.parent
# the port's own copies of the JAX package's host modules
SHARED = [
    "pixel_heal_thyself_tpu_torch.config",
    "pixel_heal_thyself_tpu_torch.ops.curves",
    "pixel_heal_thyself_tpu_torch.logger",
    "pixel_heal_thyself_tpu_torch.utils.run_once",
    "pixel_heal_thyself_tpu_torch.data.exr",
    "pixel_heal_thyself_tpu_torch.data.preprocessing",
    "pixel_heal_thyself_tpu_torch.data.synthetic",
    "pixel_heal_thyself_tpu_torch.metrics",
]


def _port_modules() -> list[str]:
    import pixel_heal_thyself_tpu_torch as port

    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, prefix=port.__name__ + "."):
        names.append(info.name)
    return names


def _imported_frameworks(modules: list[str]) -> list[str]:
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m in ('jax', 'flax', 'jaxlib')\n"
        "    or m in ('pixel_heal_thyself_tpu', 'tools')\n"
        "    or m.startswith(('pixel_heal_thyself_tpu.', 'tools.')))))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=240, check=True,
    )
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_modules_import_no_jax():
    modules = _port_modules()
    assert "pixel_heal_thyself_tpu_torch.ops.attention_cuda" in modules
    assert "pixel_heal_thyself_tpu_torch.inference" in modules
    assert {"pixel_heal_thyself_tpu_torch.ops.library", "pixel_heal_thyself_tpu_torch.serving",
            "pixel_heal_thyself_tpu_torch.tools.export_model",
            "pixel_heal_thyself_tpu_torch.tools.import_torch_checkpoint"} <= set(modules)
    assert {f"pixel_heal_thyself_tpu_torch.parallel.{m}"
            for m in ("distributed", "mesh", "spatial", "sequence", "data",
                      "dryrun")} <= set(modules)
    assert set(SHARED) <= set(modules)
    assert _imported_frameworks(modules + ["chip_smoke"]) == []


_JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(from|import) (pixel_heal_thyself_tpu|tools)(\.|\s|$)", re.M)


def test_no_source_imports_the_jax_package():
    """Lazy imports inside functions included; the repository's `tools/`
    (the JAX package's scripts) neither: the port has its own
    `pixel_heal_thyself_tpu_torch.tools`."""
    sources = sorted((REPO / "pixel_heal_thyself_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 20
    hits = [f"{src.relative_to(REPO)}: {m.group(0).strip()}" for src in sources
            for m in _JAX_PACKAGE_IMPORT.finditer(src.read_text())]
    assert hits == []


TRAINING = [
    "pixel_heal_thyself_tpu_torch.training.train_step",
    "pixel_heal_thyself_tpu_torch.losses",
    "pixel_heal_thyself_tpu_torch.models.discriminators",
    "pixel_heal_thyself_tpu_torch.ops.transforms",
]


def test_training_modules_import_no_jax():
    assert set(TRAINING) <= set(_port_modules())
    assert _imported_frameworks(TRAINING) == []


@pytest.mark.parametrize("module", SHARED)
def test_shared_host_modules_import_no_jax(module):
    assert _imported_frameworks([module]) == []


def test_no_port_source_or_config_is_git_ignored():
    """Every source and config file of the port on disk is one git would
    commit. A `.gitignore` pattern such as `data/` matches any directory of
    that name, the port's `configs/data/` included: an ignored file exists
    here but not in a checkout of the commit, where the code that reads it
    fails."""
    if shutil.which("git") is None or not (REPO / ".git").exists():
        pytest.skip("needs git and the repository's .git")
    port = REPO / "pixel_heal_thyself_tpu_torch"
    files = sorted(str(f.relative_to(REPO)) for ext in ("py", "yaml", "cu", "cuh")
                   for f in port.rglob(f"*.{ext}"))
    assert "pixel_heal_thyself_tpu_torch/configs/data/default.yaml" in files
    proc = subprocess.run(["git", "check-ignore", "--stdin"], cwd=REPO, input="\n".join(files),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode in (0, 1), proc.stderr  # 0: some are ignored, 1: none
    assert proc.stdout.split() == []
