"""A checkout root holding the benchmark with cells small enough for the CPU.

`tiny_root(tmp)` copies `BENCHMARK.json` and `benchmark/` into `tmp` and
adds, beside the real ones, configurations at narrow widths
(`<config>_tiny`; with `narrow=False` at the real widths, as `-cn ci`
keeps them), traffic mixes at small sizes (`<mix>_tiny`) and cells
(`<config>_tiny.<mix>_tiny`) whose limits are the real cell's, entered in
the copy's `BENCHMARK.json` as a later change would enter them: new files
and entries only.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

WIDTHS = {
    "afgsa_prod": dict(base_ch=16, enc_ch=8, num_blocks=2, num_heads=4),
    "mamba_prod": dict(base_ch=16, enc_ch=8, num_blocks=2, expansion=2, headdim=8, d_state=8),
}
PROGRAM = {  # the same cuts in the port's config tree
    "afgsa_prod": {"feature_map_channels": 16, "enc_channels": 8,
                   "self_attention": {"num_layers": 2, "block_size": 8, "halo_size": 3,
                                      "num_heads": 4}},
    "mamba_prod": {"feature_map_channels": 16, "enc_channels": 8, "num_layers": 2,
                   "expansion": 2, "headdim": 8, "d_state": 8},
}
TRAFFIC = {
    "serve_512": dict(frame=[64, 96], pool=3, tile=32, margin=16, batch=4, warmup_frames=1,
                      sample=2, trace_after=1, trace_items=2, attrib_items=1),
    "train_b8": dict(batch=4, patch=32, store_patches=12, first_steps=3, trace_after=1,
                     trace_items=2, attrib_items=1, sync_every=2),
}


def tiny_root(tmp: Path, narrow: bool = True) -> Path:
    root = Path(tmp)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cfg in list(bench["configs"]):
        c = json.loads((REPO / cfg["file"]).read_text())
        c["name"] += "_tiny"
        if narrow:
            c["widths"].update(WIDTHS[cfg["name"]])
            c["program"]["model"].update(PROGRAM[cfg["name"]])
        c["critic"].update(input_size=32)  # the program fixes base_nf 64
        c["program"]["data"]["patches"].update(patch_size=32)
        path = f"benchmark/configs/{c['name']}.json"
        (root / path).write_text(json.dumps(c))
        bench["configs"].append({**cfg, "name": c["name"], "file": path})
    for mix, change in TRAFFIC.items():
        t = json.loads((REPO / f"benchmark/traffic/{mix}.json").read_text())
        (root / f"benchmark/traffic/{mix}_tiny.json").write_text(json.dumps({**t, **change}))
    for w in list(bench["workloads"]):
        name = f"{w['config']}_tiny.{w['traffic']}_tiny"
        shutil.copy(REPO / f"benchmark/cells/{w['name']}.json",
                    root / f"benchmark/cells/{name}.json")
        bench["workloads"].append({**w, "name": name, "config": w["config"] + "_tiny",
                                   "traffic": w["traffic"] + "_tiny"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
