"""Scaling over a torch.distributed process group: the mesh, its
collectives, data-parallel training (autograd and the training kernels),
the time-sharded long-shot path and multi-process campaigns.  Serving
over a mesh is ``bench.harness.make_enhance_shot_fn(mesh=)`` and
``serve.EnhanceService(mesh=)``."""

from specenh_torch.parallel.data_parallel import dp_fit, make_dp_train_step, shard_batch  # noqa: F401
from specenh_torch.parallel.mesh import make_mesh  # noqa: F401
