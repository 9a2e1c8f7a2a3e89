from dnsjax_torch.parallel.mesh import (  # noqa: F401
    RankLink,
    RayMesh,
    make_map_fn_dp,
    rank_link,
    ray_mesh,
)
from dnsjax_torch.parallel.tp import (  # noqa: F401
    DpTpMesh,
    dp_tp_mesh,
    gather_table,
    hash_encode_tp,
    make_map_fn_dp_tp,
    shard_params,
    shard_table,
)
