from geo4d_tpu_torch.parallel.mesh import (
    Mesh,
    fsdp_shard_dim,
    init_distributed,
    rank_rows,
    shutdown_distributed,
)
