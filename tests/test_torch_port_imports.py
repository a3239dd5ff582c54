"""The PyTorch port never imports JAX or flax.

A fresh interpreter imports every module of `pixel_heal_thyself_tpu_torch`
(and the JAX package's host-side modules the port shares) and reports
which of jax/flax ended up in `sys.modules`. The check runs in a
subprocess because this test process has JAX loaded already.
"""

from __future__ import annotations

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

REPO = Path(__file__).resolve().parent.parent
SHARED = [
    "pixel_heal_thyself_tpu.config",
    "pixel_heal_thyself_tpu.ops.curves",
    "pixel_heal_thyself_tpu.logger",
    "pixel_heal_thyself_tpu.utils.run_once",
    "pixel_heal_thyself_tpu.data.exr",
    "pixel_heal_thyself_tpu.data.preprocessing",
    "pixel_heal_thyself_tpu.data.synthetic",
    "pixel_heal_thyself_tpu.metrics",
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
        "print(json.dumps(sorted(m for m in ('jax', 'flax', 'jaxlib') if m in sys.modules)))\n"
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
    assert _imported_frameworks(modules + ["chip_smoke"]) == []


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
