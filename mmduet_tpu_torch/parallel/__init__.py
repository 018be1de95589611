from .collectives import gather_vocab, model_axis, reduce_model
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, ProcessMesh, initialize_distributed, lane_block,
                   make_mesh, serving_shard_ctx)
from .sharding import (batch_shardings, kv_cache_sharding, local_cache_dims, opt_state_shardings,
                       param_shardings, replicated, shard_params, shard_train_state,
                       train_state_shardings)
