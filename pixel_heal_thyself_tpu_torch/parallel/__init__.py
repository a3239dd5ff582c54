"""Scale-out on `torch.distributed`: full-frame serving sharded over ranks.

Port of `pixel_heal_thyself_tpu/parallel/`, its serving part: the process
group and its two collectives (`distributed.py`), the row axis of a frame
over the ranks (`mesh.py`), the row-sharded AFGSA apply with halo
exchange (`spatial.py`) and the exactly chained sequence-sharded Mamba
apply (`sequence.py`). Data-parallel training and tensor parallelism are
still to port (ROADMAP.md Queue 1, items 9b and 9c).
"""

from pixel_heal_thyself_tpu_torch.parallel.distributed import (
    is_main_process,
    maybe_initialize_distributed,
    process_count,
    process_index,
    shutdown,
)
from pixel_heal_thyself_tpu_torch.parallel.mesh import RowAxis, auto_data_axis, row_axis
from pixel_heal_thyself_tpu_torch.parallel.sequence import make_seq_sharded_apply
from pixel_heal_thyself_tpu_torch.parallel.spatial import (
    make_sharded_apply_rows,
    sharded_apply_rows,
)

__all__ = [
    "RowAxis",
    "auto_data_axis",
    "is_main_process",
    "make_seq_sharded_apply",
    "make_sharded_apply_rows",
    "maybe_initialize_distributed",
    "process_count",
    "process_index",
    "row_axis",
    "sharded_apply_rows",
    "shutdown",
]
