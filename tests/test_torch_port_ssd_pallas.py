"""PyTorch port: `ops.ssd.ssd_pallas` (the plain version of the kernel K11)
against the TPU kernel `ssd.ssd_pallas`, run as tests/test_mamba.py:47-70
runs it on the CPU (under `pltpu.force_tpu_interpret_mode()`).

Inputs come from seeded numpy (tests/test_mamba.py `_ssd_inputs`). l 64
with chunk 16 and group 2 gives two TPU programs of two chunks (the carry
crosses the program boundary), l 96 with chunk 32 one program of three.
Tolerances:
- float32: the JAX package's own bound of the kernel against the scan
  oracle (tests/test_mamba.py:59): atol 2e-4, rtol 1e-3;
- bf16: both round at the same points from f32 sums in another order, so
  a value next to a bf16 rounding boundary may round the other way, and a
  flip in a carried state moves the chunks after it by about as much:
  within two bf16 ulps of the largest output, 2**-6 of its magnitude. (XLA
  on the CPU also fuses some of the kernel's bf16 roundings away, which
  puts the rms of port against JAX near 1e-4, above what the state's
  rounding itself moves; the test of that rounding compares the plain
  version with an f32-carry control instead.)
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from pixel_heal_thyself_tpu.ops import ssd as jssd  # noqa: E402
from pixel_heal_thyself_tpu_torch.ops import ssd  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _ssd_inputs(b=2, l=100, h=4, p=8, g=1, n=16, seed=0):
    """tests/test_mamba.py `_ssd_inputs`."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, l, h)).astype(np.float32)
    A = -rng.uniform(1, 8, (h,)).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32) * 0.5
    C = rng.standard_normal((b, l, g, n)).astype(np.float32) * 0.5
    D = rng.standard_normal((h,)).astype(np.float32)
    return x, dt, A, B, C, D


def _both(args, jd, td):
    """The inputs in `jd` for JAX and the same values in `td` for torch."""
    ja = [jnp.asarray(a).astype(jd) for a in args]
    return ja, [torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(td) for a in ja]


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("l,chunk", [(64, 16), (96, 32)])
def test_matches_tpu_kernel_interpret(l, chunk, dtype):
    jd, td = DTYPES[dtype]
    ja, ta = _both(_ssd_inputs(b=2, l=l), jd, td)
    with pltpu.force_tpu_interpret_mode():
        want = _np(jssd.ssd_pallas(*ja, chunk=chunk, group=2))
    got = ssd.ssd_pallas(*ta, chunk=chunk, group=2)
    assert got.dtype == td and got.shape == ta[0].shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, atol=2e-4, rtol=1e-3)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=2**-6 * np.abs(want).max())


def test_group_changes_nothing():
    _, ta = _both(_ssd_inputs(b=2, l=64, seed=1), jnp.bfloat16, torch.bfloat16)
    assert torch.equal(ssd.ssd_pallas_torch(*ta, chunk=16, group=1),
                       ssd.ssd_pallas_torch(*ta, chunk=16, group=4))


@pytest.mark.parametrize("shape", [(2, 1024, 4, 16, 16), (1, 512, 8, 64, 64)])
def test_kernel_bf16_bound_catches_an_f32_carry(shape):
    """K11's bf16 bound (chip_smoke.SSD_SCAN_TOL) must fail the plain scan
    that carries the state in f32 between chunks, which the TPU kernel
    never does: at Mamba-like inputs (chip_smoke.ssd_scan_inputs) the
    carry's rounding moves y by far more than the f32 summation order."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke

    args = chip_smoke.ssd_scan_inputs(torch.device("cpu"), *shape)
    ref = ssd.ssd_pallas_torch(*args, chunk=128).float()
    got = chip_smoke.f32_carry_scan(*args, chunk=128).float()
    rms = (got - ref).pow(2).mean().sqrt().item() / ref.abs().max().item()
    assert rms > chip_smoke.SSD_SCAN_TOL["bf16"][1], rms


@pytest.mark.parametrize("case", ["l_not_chunk_multiple", "two_groups"])
def test_fallback_shapes_run_ssd_chunked(case):
    """As the JAX function: ngroups ≠ 1 or l not a multiple of the chunk go
    to `ssd_chunked` (atol 2e-4, rtol 1e-3 against the JAX function)."""
    kw = dict(l=100) if case == "l_not_chunk_multiple" else dict(h=4, g=2, n=8, l=64)
    ja, ta = _both(_ssd_inputs(**kw), jnp.float32, torch.float32)
    got = ssd.ssd_pallas(*ta, chunk=32)
    assert torch.equal(got, ssd.ssd_chunked(*ta, chunk=32))
    np.testing.assert_allclose(_np(got), _np(jssd.ssd_pallas(*ja, chunk=32)), atol=2e-4, rtol=1e-3)


def test_refuses_grad_mode():
    _, ta = _both(_ssd_inputs(l=64), jnp.float32, torch.float32)
    ta[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        ssd.ssd_pallas(*ta, chunk=16)
    with torch.no_grad():
        assert ssd.ssd_pallas(*ta, chunk=16).shape == ta[0].shape
    with pytest.raises(ValueError, match="ngroups"):
        ssd.ssd_pallas_torch(*(t.detach() for t in ta[:3]), torch.zeros(2, 64, 2, 8),
                             torch.zeros(2, 64, 2, 8), chunk=16)
