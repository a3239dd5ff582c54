"""Export a trained generator's params to the flat `.npz` the PyTorch port loads.

    python tools/export_params_npz.py <run>/model_epochN/state params.npz

Restores the Orbax checkpoint with the JAX package's
`training/checkpoints.restore_params` (a trainer state with `g/params`, or
a params-only export) and writes every leaf of the generator's flax param
tree under its `/`-joined path, e.g. `ConvBlock_0/Conv_0/kernel`. The
port reads the file with `pixel_heal_thyself_tpu_torch.params.
load_params_npz` (`inference.py trainer.model_path=params.npz`).

This tool imports JAX (Orbax checkpoints are JAX state); the port does not.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

# keep repo-root execution working like the other tools
sys.path.insert(0, ".")


def flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            flat.update(flatten(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def export_params_npz(model_path: str, out: str) -> int:
    """Write the generator params of `model_path` to `out`; returns the
    number of arrays written."""
    from pixel_heal_thyself_tpu.training import checkpoints

    restored = checkpoints.restore_params(model_path)
    params = restored["g"]["params"] if "g" in restored else restored
    params = params.get("params", params)
    flat = flatten(params)
    np.savez(out, **flat)
    return len(flat)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("model_path", help="Orbax checkpoint dir (trainer state or params)")
    parser.add_argument("out", help="output .npz")
    args = parser.parse_args(argv)
    n = export_params_npz(args.model_path, args.out)
    print(f"wrote {n} arrays to {args.out}")


if __name__ == "__main__":
    main()
