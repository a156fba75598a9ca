"""Scaling over a torch.distributed process group: the mesh, data-parallel
training (autograd and the training kernels) and multi-process campaigns.
Time sharding and serving over a mesh are ROADMAP Queue 1 item 9b."""

from specenh_torch.parallel.data_parallel import dp_fit, make_dp_train_step, shard_batch  # noqa: F401
from specenh_torch.parallel.mesh import make_mesh  # noqa: F401
