from .mesh import (DEFAULT_TIMEOUT_S, active_group, all_reduce_sum,
                   allreduce_grads, barrier, choose_backend, global_count,
                   init_distributed, rank, replicate, set_active_group,
                   shard_batch, sharded, shutdown, sync_moments, sync_sums,
                   sharded_group, world_size)
