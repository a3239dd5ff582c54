"""PyTorch port: the bf16 TransformerBlock backward against the TPU
megakernel's, in the reflect and zero padding modes.

The check and its bounds are those of
`tests/test_torch_port_block_bwd.py` (its module docstring gives the
reasons); that file runs the prod padding mode (replicate), this one the
other two, so that neither file spends more than ~20 s tracing the JAX
interpret-mode kernel.
"""

from __future__ import annotations

import pytest

pytest.importorskip("jax")

try:  # pytest prepend import mode puts tests/ on sys.path
    from test_torch_port_block_bwd import check_bf16_against_tpu_kernel_interpret
except ImportError:  # pragma: no cover - direct execution
    import importlib.util
    import pathlib

    _spec = importlib.util.spec_from_file_location(
        "test_torch_port_block_bwd", pathlib.Path(__file__).parent / "test_torch_port_block_bwd.py",
    )
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
    check_bf16_against_tpu_kernel_interpret = _mod.check_bf16_against_tpu_kernel_interpret


@pytest.mark.parametrize("mode", ["reflect", "zeros"])
def test_block_bwd_bf16_matches_tpu_kernel_interpret(mode):
    check_bf16_against_tpu_kernel_interpret(mode)
