"""Multi-device training and evaluation over ``torch.distributed`` (port of
``adfmsl/parallel``): the mesh, the launcher, the collectives, the local-BN
step and tensor parallelism of the Wav2Vec2 encoder.

The model layers import ``parallel.collectives``, so this package imports
nothing beyond torch, numpy and the configuration: not the data pipeline,
the models or the kernels (``shard_map_step`` and ``tp`` load on their own).
"""
from adfmsl_torch.parallel.collectives import (all_reduce_flat, data_group, data_parallel,
                                               global_sum)
from adfmsl_torch.parallel.launch import kernel_launches, launch, reset_kernel_launches
from adfmsl_torch.parallel.mesh import (Mesh, broadcast_floats, check_loader,
                                        check_replicated, make_mesh, mesh_shape,
                                        pad_batch_to_devices, replicate, shard_batch)

__all__ = ["Mesh", "all_reduce_flat", "broadcast_floats", "check_loader",
           "check_replicated", "data_group", "data_parallel", "global_sum",
           "kernel_launches", "launch", "make_mesh", "mesh_shape", "pad_batch_to_devices",
           "replicate", "reset_kernel_launches", "shard_batch"]
