from .mesh import make_mesh, shard_inputs_by_column
