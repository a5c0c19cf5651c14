"""Sharded solvers over torch.distributed (counterpart of
my_orb_slam2_tpu/parallel/): camera- and observation-sharded bundle
adjustment, the edge-sharded Sim3 pose graph and the batch front-end.

A `group.Group` stands in for the reference's `jax.sharding.Mesh` plus
`lax.psum`: each rank is one process that calls the solver with its own
shard (SPMD), and the solver all-reduces at the reference's psum points.
Importing this package starts no process group.
"""
