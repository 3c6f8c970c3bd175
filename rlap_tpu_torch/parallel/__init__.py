"""The sharded layer on `torch.distributed` (counterpart of
`rlap_tpu/parallel/`): meshes, the sender-block partition, the
edge-partitioned SpMM, tensor parallelism and the distributed rLap. A
rank holds a sharded graph as its slice of the edges, the global node
count, and replicated node arrays (`mesh.py`)."""

from rlap_tpu_torch.parallel.mesh import (make_mesh, make_mesh_2level,  # noqa: F401
                                          init_distributed, graph_shardings,
                                          shard_graph)
from rlap_tpu_torch.parallel.partition import partition_edges_by_sender  # noqa: F401
from rlap_tpu_torch.parallel.spmm import spmm_edge_partitioned  # noqa: F401
from rlap_tpu_torch.parallel.rlap_dist import eliminate_sharded  # noqa: F401
from rlap_tpu_torch.parallel.tp import shard_params_tp  # noqa: F401
