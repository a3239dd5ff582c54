"""Resize every EXR under a tree to 50% (box filter), preserving channels.

Port of the JAX package's `tools/resize_exrs.py` through the port's own
EXR codec (`data/exr.py`) and `data/preprocessing.scale_exr_img`: the same
files, byte for byte, and the same log lines. Each file is rewritten in
place (ZIP compression, half floats). A host tool: no device work.

    python -m pixel_heal_thyself_tpu_torch.tools.resize_exrs [START_DIR] [--scale 0.5]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from pixel_heal_thyself_tpu_torch.data.exr import read_exr_channels, write_exr
from pixel_heal_thyself_tpu_torch.data.preprocessing import scale_exr_img


def resize_exr(path: Path, scale: float) -> None:
    channels = read_exr_channels(path)
    scaled3 = scale_exr_img({k: v[..., None] for k, v in channels.items()}, scale=scale)
    write_exr(path, {k: v[..., 0] for k, v in scaled3.items()}, compression="zip",
              pixel_type="half")


def run(start_dir: str | Path, scale: float = 0.5) -> None:
    print(f"Starting to process EXR files in {start_dir}")
    for f in sorted(Path(start_dir).rglob("*.exr")):
        print(f"Processing {f}")
        try:
            resize_exr(f, scale)
            print(f"Successfully resized {f}")
        except Exception as e:
            print(f"Failed to resize {f}: {e}")
    print("All EXR files processed")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="pixel_heal_thyself_tpu_torch.tools.resize_exrs")
    parser.add_argument("start_dir", nargs="?", default=".")
    parser.add_argument("--scale", type=float, default=0.5)
    args = parser.parse_args(argv)
    run(args.start_dir, args.scale)


if __name__ == "__main__":
    main()
