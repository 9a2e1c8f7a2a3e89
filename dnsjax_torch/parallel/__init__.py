from dnsjax_torch.parallel.mesh import RayMesh, make_map_fn_dp, ray_mesh  # noqa: F401
from dnsjax_torch.parallel.tp import (  # noqa: F401
    DpTpMesh,
    dp_tp_mesh,
    gather_table,
    hash_encode_tp,
    make_map_fn_dp_tp,
    shard_params,
    shard_table,
)
