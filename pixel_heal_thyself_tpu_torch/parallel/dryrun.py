"""A dry run of multi-GPU training and sharded serving on tiny shapes.

The port's counterpart of the JAX package's `dryrun_multichip`
(`__graft_entry__.py`): N ranks of one process group run one full GAN
step (AFGSANet against DiscriminatorVGG, WGAN-GP + L1, both Adams) over
a D × M grid, M = 2 when N is even and at least 4, else 1, as JAX
chooses; then a frame through the row-sharded AFGSA apply and the
sequence-sharded Mamba apply over all N ranks. Every value must be
finite.

    python -m pixel_heal_thyself_tpu_torch.parallel.dryrun --ranks N [--device cpu]

The ranks are spawned (`distributed.spawn_world`): gloo on the CPU, or on
the card(s) by the backend rule (`distributed.choose_backend`).
"""

from __future__ import annotations

import argparse
import math
import tempfile
from pathlib import Path

import numpy as np
import torch

from pixel_heal_thyself_tpu_torch.parallel.distributed import (
    host_batch_bounds,
    process_count,
    process_index,
    spawn_world,
)
from pixel_heal_thyself_tpu_torch.parallel.mesh import make_mesh, row_axis


def _rank(out_dir: str, device_type: str) -> None:
    from pixel_heal_thyself_tpu_torch.models.afgsa import AFGSANet
    from pixel_heal_thyself_tpu_torch.models.discriminators import DiscriminatorVGG
    from pixel_heal_thyself_tpu_torch.models.mamba import MambaDenoiserNet
    from pixel_heal_thyself_tpu_torch.parallel.sequence import make_seq_sharded_apply
    from pixel_heal_thyself_tpu_torch.parallel.spatial import sharded_apply_rows
    from pixel_heal_thyself_tpu_torch.training.train_step import (
        LossesConfig,
        make_optimizer,
        make_train_step,
    )

    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    n = process_count()
    model_axis = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(n // model_axis, model_axis)
    patch, batch = 16, mesh.data * 2
    g = AFGSANet(base_ch=32, enc_ch=32, num_sa=2, num_gcp=1, num_heads=2, device=device,
                 generator=torch.Generator().manual_seed(0))
    d = DiscriminatorVGG(input_size=patch, base_nf=8, device=device, data_group=mesh.data_group,
                         generator=torch.Generator().manual_seed(1))
    spec = make_optimizer(1e-4, [2], 0.5, 4)
    step = make_train_step(g, d, LossesConfig(), False, spec, spec, mesh=mesh)
    rng = np.random.default_rng(0)
    data = {"noisy": np.abs(rng.standard_normal((batch, patch, patch, 3))),
            "gt": np.abs(rng.standard_normal((batch, patch, patch, 3))),
            "aux": rng.standard_normal((batch, patch, patch, 7))}
    lo, hi = host_batch_bounds(batch, mesh.data_index, mesh.data)
    local = {k: torch.from_numpy(v[lo:hi].astype(np.float32)).to(device) for k, v in data.items()}
    gen = torch.Generator(device=device).manual_seed(7)
    metrics = {k: float(v) for k, v in step(local, generator=gen).items()}

    axis = row_axis()
    frame = [torch.from_numpy(np.abs(rng.standard_normal((1, n * 16, 16, c))).astype(np.float32))
             .to(device) for c in (3, 7)]
    with torch.no_grad():
        rows = sharded_apply_rows(g.eval(), 16, *frame, axis)
        m_model = MambaDenoiserNet(base_ch=16, enc_ch=16, num_blocks=2, d_state=8, headdim=8,
                                   expansion=2, num_gcp=1, device=device,
                                   generator=torch.Generator().manual_seed(2)).eval()
        m_frame = [x[:, : n * 8, :8] for x in frame]
        seq = make_seq_sharded_apply(m_model, axis)(*m_frame)
    ok = (all(math.isfinite(v) for v in metrics.values())
          and rows.shape == (1, n * 16, 16, 3) and bool(torch.isfinite(rows).all())
          and seq.shape == (1, n * 8, 8, 3) and bool(torch.isfinite(seq).all()))
    if process_index() == 0:
        torch.save({"ok": ok, "mesh": (mesh.data, mesh.model), "batch": batch, **metrics},
                   Path(out_dir, "dryrun.pt"))
    if not ok:
        raise AssertionError(f"rank {process_index()}: non-finite dry run {metrics}")


def dryrun(ranks: int, device: str = "cuda") -> str:
    """Run the dry run over `ranks` spawned ranks; its one-line summary."""
    device_type = torch.device(device).type
    with tempfile.TemporaryDirectory() as tmp:
        spawn_world(_rank, ranks, f"file://{tmp}/init", device, args=(tmp, device_type),
                    threads=1 if device_type == "cpu" else 0)
        res = torch.load(Path(tmp, "dryrun.pt"), weights_only=False)
    data, model = res["mesh"]
    return (f"dryrun OK: mesh=({data} data x {model} model), batch={res['batch']}, "
            f"g_loss={res['g_loss']:.4f}, d_loss={res['d_loss']:.4f}; spatial-sharded frame "
            f"apply over {ranks} ranks OK; sequence-sharded Mamba frame apply over {ranks} "
            "ranks OK")


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="pixel_heal_thyself_tpu_torch.parallel.dryrun")
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    print(dryrun(args.ranks, args.device))


if __name__ == "__main__":
    main()
