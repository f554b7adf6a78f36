"""Several cards: the (data, model) mesh of process groups (``mesh.py``),
the multi-view SDS steps (``dp.py``), the tensor-parallel guidance
(``tp.py``) and the Gaussian-sharded render (``shard_render.py``). Port of
``dreamwaltz_g_tpu/parallel``."""
from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    DataMesh,
    gather_batch,
    local_batch_size,
    make_mesh,
    make_mesh_2d,
    replicate,
    resolve_dp,
    shard_batch,
)
from .tp import guidance_pspecs, shard_guidance_params  # noqa: F401
