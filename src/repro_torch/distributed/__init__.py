"""Distribution layer of the port (the counterpart of the JAX package's
`distributed/`): the sharding rules of the production mesh and the GenFV
weighted all-reduce."""
from repro_torch.distributed.sharding import (batch_shardings, cache_shardings,
                                              params_shardings, shard_leaf)
from repro_torch.distributed.collectives import genfv_weighted_allreduce
