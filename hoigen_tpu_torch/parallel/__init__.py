from .mesh import (Mesh, make_mesh, shard_batch, shard_cache_rows,  # noqa: F401
                   copy_to_group, reduce_from_group, is_cache_row_leaf)
from .distributed import (init_distributed, process_count,  # noqa: F401
                          process_index, is_primary, barrier, all_reduce,
                          capturable, local_batch_indices, local_n_real,
                          process_allgather, process_allgather_ragged,
                          gather_pyobj, global_mesh, launch)
