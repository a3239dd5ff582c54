"""Intra-block query orderings: the `CurveOrder` enum of the config schema
and AFGSANet.

Copy of the enum in the JAX package's `pixel_heal_thyself_tpu/ops/curves.py`,
so that the port imports nothing of that package (tests/test_torch_port_host.py
holds the values equal). The permutations are not copied: the port's
block-halo attention gives the same result in every order (see
`ops/attention.py`).
"""

from __future__ import annotations

from enum import Enum


class CurveOrder(str, Enum):
    """Intra-block query ordering."""

    RASTER = "raster"
    HILBERT = "hilbert"
    ZORDER = "zorder"
