from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh, serving_shard_ctx
