from .mesh import DATA_AXIS, data_mesh
from .sharded import ShardedEngine
from .streaming import StreamingShardedEngine
