"""Multi-view SDS training over a data axis of processes (``mesh.py``) and
its steps (``dp.py``). Port of ``dreamwaltz_g_tpu/parallel``; tensor
parallelism and the sharded render are not ported yet."""
from .mesh import (  # noqa: F401
    DATA_AXIS,
    DataMesh,
    local_batch_size,
    make_mesh,
    replicate,
    resolve_dp,
    shard_batch,
)
