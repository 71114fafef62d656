"""Multi-device serving and training over ``torch.distributed`` (port of
``semantic_depth_tpu/parallel``).

One process per mesh position, as PyTorch runs several devices; the
collectives are in ``comm.py`` and take their backend from the process
group (NCCL when every rank has a card of its own, gloo when ranks share
one or run on the CPU; ``mesh.init_distributed``):

* 'dp' (throughput, ``make_mesh`` / ``ShardedPipeline``): each rank runs
  the whole frame program on its slice of the batch, and the outputs are
  gathered;
* 'sp' (single-frame latency, ``make_spatial_mesh``): image rows are
  sharded through both networks with a halo exchange before every layer
  that reads neighbouring rows (``spatial.RowShard``, whose layers are in
  ``models/spatial.py``), and the geometry tail runs whole on every rank;
* 'pp' (``make_pp_mesh`` / ``PipelinedPipeline``): GPipe-style microbatch
  streaming through 2 or 3 stages;
* 'dp' x 'tp' training (``make_sharded_train_step`` / ``shard_fcn_params``,
  ``train_step.py``): the FCN-8s batch split over 'dp', fc6 / fc7 split
  over 'tp' (Megatron's pairing); ``FCNTrainer(mesh=...)`` and
  ``MonodepthTrainer(mesh=...)`` train through it.

``launch.run_ranks`` starts a group of local processes (the tests and the
smoke run); the CLIs run under ``torchrun``.
"""

from .inference import ShardedPipeline
from .mesh import make_mesh, make_spatial_mesh, shard_batch
from .pp import PipelinedPipeline, make_pp_mesh
from .train_step import make_sharded_train_step, shard_fcn_params

__all__ = ["ShardedPipeline", "PipelinedPipeline", "make_mesh", "make_spatial_mesh",
           "make_pp_mesh", "shard_batch", "make_sharded_train_step", "shard_fcn_params"]
