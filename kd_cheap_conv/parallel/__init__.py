from .mesh import make_mesh, shard_batch, replicate, batch_sharding
