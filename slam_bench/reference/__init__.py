"""The plain reference that decides `correct`.

Plain PyTorch, frozen with the benchmark: the ORB front-end with the
row-band stereo search and the RGB-D depth read (`frontend`), the
single-pose optimization (`pose_opt`), the dense local BA (`local_ba`)
and the flat-problem global BA with its PCG solve (`global_ba`). It
follows the semantics of ORB-SLAM2 as the system under test implements
them, with every hand-written kernel replaced by plain tensor operations
(FAST + 3x3 NMS by rolled copies and a max-pool; the segment sums by
float64 `index_add_`). Nothing here imports jax, the JAX package or the
system under test: the reference works every derived array (atlases,
pattern tables, layouts, Jacobians) out again from the benchmark's own
inputs.
"""
