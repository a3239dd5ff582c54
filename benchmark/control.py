"""The readings a cell's limits are set from, at the cell's own size.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--control-seeds 4]

For each seed, in one process on the card (`benchmark/tests/test_control.py`
calls `readings` on the CPU):
- `program`: the numbers the run compares, for the program as a run
  drives it (serving: the `sample` frames a run compares, here the pool's
  first ones; training: set-up's first steps), against the reference;
- for the first `--control-seeds` seeds, `control`: the same numbers for
  the reference put in the program's place one precision below the
  configuration's (the generator's products in fp8 e4m3, per-tensor
  scaled; the float32 critic's in bfloat16), and for training cells the
  faults a step can have, planted in that reference: `half_batch` (half
  of each batch left out, the mean over the rest) and `altered_output`
  (one sample's generator output replaced by its input). A state left
  unchanged, in all parameters or in any one whose change is at least
  `drivers.train.FLOOR` of the median's, reads 1 on `change_norm_gap` by
  definition and is not run. Training readings carry each parameter's
  norms (`leaves`).
Prints one JSON line per seed and reading; `benchmark/cells/<cell>.json`
keeps the readings its limits were set from. The benchmark's own runs do
not run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(root: Path, name: str, seed: int, device, with_control: bool) -> dict:
    import torch

    from benchmark import spec as specs
    from benchmark.reference.nn import Arith

    bench = specs.benchmark(root)
    cell = specs.cell(root, bench, name, seed, 0.0, False, torch.device(device),
                      time.perf_counter())
    out = {}
    if cell.traffic["kind"] == "serve":
        from benchmark.drivers import serve as drv

        model, frames, serve_fn = drv.setup(cell)
        ids = list(range(min(cell.traffic["sample"], cell.traffic["pool"])))
        served = {i: (i, serve_fn(frames[i])) for i in ids}
        del model, serve_fn
        gc.collect()
        ref = drv.reference_frames(cell, frames, ids, Arith("f32"), cell.device)
        out["program"] = {**drv.compare(served, ref, frames, cell.traffic["tile"]),
                          **drv.detail(served, ref, frames)}
        if with_control:
            low = drv.reference_frames(cell, frames, ids, Arith("fp8"), cell.device)
            low = {i: (i, low[i]) for i in ids}
            out["control"] = {**drv.compare(low, ref, frames, cell.traffic["tile"]),
                              **drv.detail(low, ref, frames)}
    else:
        from benchmark.drivers import train as drv

        tr, feed, side, first, store, loader_seed = drv.setup(cell)
        del tr, feed
        gc.collect()
        checks, ref, batches = drv.reference_check(cell, side, first, store, loader_seed)
        out["program"] = {**checks, **drv.detail(side, ref), "losses": side["losses"],
                          "ref_losses": ref["losses"], "leaves": drv.leaves(side, ref)}
        if with_control:
            low = drv.reference_side(cell, batches, Arith("fp8"), Arith("bf16"), cell.device)
            out["control"] = {**drv.compare(low, ref), **drv.detail(low, ref),
                              "leaves": drv.leaves(low, ref)}
            for fault in ("half_batch", "altered_output"):
                bad = drv.reference_side(cell, batches, Arith("f32"), Arith("f32"), cell.device,
                                         fault=fault)
                out[fault] = {**drv.compare(bad, ref), **drv.detail(bad, ref)}
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark/control.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", type=int, default=3)
    args = parser.parse_args(argv)
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        r = readings(Path.cwd(), args.workload, seed, "cuda", k < args.control_seeds)
        for kind, numbers in r.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": kind,
                              **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
