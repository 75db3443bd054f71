"""Tensor parallelism and the data axis over torch.distributed ranks —
counterpart of the JAX package's parallel/ (its tp and dp axes).

  mesh.py         the (dp, tp) rank grid, its process groups, the backend
  wrappers.py     TpRowWeight / TpColWeight, the weight markers matmul
                  dispatches on
  collectives.py  exact and Q80 all-reduces, the one place a collective
                  runs (and stages through host memory under gloo)
  sharding.py     one rank's shard of every leaf of the full params
  tp_q80.py       the row and column matmuls of a shard
  launch.py       starting the ranks: the CLI's and a pool of workers
"""
