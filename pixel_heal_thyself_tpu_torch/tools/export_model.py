"""Export a trained denoiser checkpoint to a serving artifact.

    python -m pixel_heal_thyself_tpu_torch.tools.export_model -cn prod \
        trainer.model_path=<run>/model_epochN/state \
        export.out_dir=outputs/exports/afgsa_prod \
        [export.window=128] [export.batch_tiles=8] \
        [export.platforms=cuda | export.platforms=cpu | export.platforms=cpu,cuda]

Port of the JAX package's `tools/export_model.py`. Writes a `torch.export`
artifact (`serving.py`) that `python -m pixel_heal_thyself_tpu_torch.
inference inference.from_export=<dir>`, or any process with torch and
this package's op library, loads without the model code or checkpoint.
`trainer.model_path` is anything `inference.load_generator` reads: the
trainer's checkpoint, a `save_params` file (what
`tools.import_torch_checkpoint` writes from a reference `G.pt`) or a flax
params `.npz`.

`export.platforms=cuda` (the default) traces on the card and keeps the
kernels as `pht::` ops; with no card it raises. `cpu` traces on the CPU
(the ops run their plain versions there). A multi-platform artifact
(`cpu,cuda`) is the plain route (`load_generator(kernels=False)`: the
same routes through the kernels' plain versions, no `fold_qkv`), traced
on the CPU, as the JAX tool rebuilds a portable model without its Pallas
kernels.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from pixel_heal_thyself_tpu_torch.config import ConfigRegistry, compose
from pixel_heal_thyself_tpu_torch.config.run_dirs import register_run_dirs_resolver
from pixel_heal_thyself_tpu_torch.logger import logger

PLATFORMS = ("cpu", "cuda")


def main(argv=None) -> Path:
    register_run_dirs_resolver()
    parser = argparse.ArgumentParser(prog="pixel_heal_thyself_tpu_torch.tools.export_model")
    parser.add_argument("-cn", "--config-name", default="default")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    export_opts = {"out_dir": None, "window": 128, "batch_tiles": 8, "platforms": "cuda"}
    cfg_overrides = []
    for ov in args.overrides:
        key, _, val = ov.partition("=")
        if key.startswith("export."):
            name = key.split(".", 1)[1]
            if name not in export_opts:
                raise SystemExit(
                    f"unknown export option {key!r} "
                    f"(expected one of: {', '.join(sorted(export_opts))})",
                )
            cur = export_opts.get(name)
            export_opts[name] = type(cur)(val) if isinstance(cur, int) else val
        else:
            cfg_overrides.append(ov)

    platforms = tuple(dict.fromkeys(p.strip() for p in export_opts["platforms"].split(",")))
    if not set(platforms) <= set(PLATFORMS):
        raise SystemExit(f"export.platforms={export_opts['platforms']}: each of "
                         f"{', '.join(PLATFORMS)}")
    if platforms == ("cuda",) and not torch.cuda.is_available():
        raise SystemExit("export.platforms=cuda (the default) traces on the card, but no CUDA "
                         "device is available; pass export.platforms=cpu for a CPU artifact")

    cfg = ConfigRegistry.create_config(compose(args.config_name, cfg_overrides))
    logger.setup_logger(cfg.logging.level)
    if not cfg.trainer.model_path:
        raise SystemExit("set trainer.model_path=<checkpoint state dir or params file>")
    if not export_opts["out_dir"]:
        raise SystemExit("set export.out_dir=<artifact dir>")

    from pixel_heal_thyself_tpu_torch.inference import load_generator
    from pixel_heal_thyself_tpu_torch.serving import export_denoiser

    # a multi-platform artifact: the plain route, no pht:: kernel op
    portable = len(platforms) > 1
    model = load_generator(cfg, "cpu" if portable else platforms[0], kernels=not portable)
    out = export_denoiser(
        model,
        export_opts["out_dir"],
        window=export_opts["window"],
        batch_tiles=export_opts["batch_tiles"],
        aux_channels=cfg.model.aux_input_channels,
        platforms=platforms,
        model_name=cfg.model.name,
        extra_meta={"config_name": args.config_name},
    )
    logger.info(f"[Export] wrote artifact to {out} (platforms={list(platforms)})")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
