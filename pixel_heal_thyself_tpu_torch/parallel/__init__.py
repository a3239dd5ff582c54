"""Scale-out on `torch.distributed`: multi-GPU training and sharded serving.

Port of `pixel_heal_thyself_tpu/parallel/`: the process group, the
per-rank feeds and the collectives (`distributed.py`), the D × M grid of
ranks with its data and model groups, tensor parallelism's parameter
shards and the row axis of a frame (`mesh.py`), the differentiable
reductions of data-parallel training (`data.py`, which GSPMD inserts in
JAX), the row-sharded AFGSA apply with halo exchange (`spatial.py`), the
exactly chained sequence-sharded Mamba apply (`sequence.py`) and a dry
run of both on tiny shapes (`dryrun.py`).
"""

from pixel_heal_thyself_tpu_torch.parallel.distributed import (
    barrier,
    host_batch_bounds,
    is_main_process,
    maybe_initialize_distributed,
    process_count,
    process_index,
    put_global,
    shutdown,
)
from pixel_heal_thyself_tpu_torch.parallel.mesh import (
    Mesh,
    ParamShards,
    RowAxis,
    auto_data_axis,
    make_mesh,
    make_param_shardings,
    place_state,
    row_axis,
)
from pixel_heal_thyself_tpu_torch.parallel.sequence import make_seq_sharded_apply
from pixel_heal_thyself_tpu_torch.parallel.spatial import (
    make_sharded_apply_rows,
    sharded_apply_rows,
)

__all__ = [
    "Mesh",
    "ParamShards",
    "RowAxis",
    "auto_data_axis",
    "barrier",
    "host_batch_bounds",
    "is_main_process",
    "make_mesh",
    "make_param_shardings",
    "make_seq_sharded_apply",
    "make_sharded_apply_rows",
    "maybe_initialize_distributed",
    "place_state",
    "process_count",
    "process_index",
    "put_global",
    "row_axis",
    "sharded_apply_rows",
    "shutdown",
]
