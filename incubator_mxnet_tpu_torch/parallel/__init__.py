"""Data-parallel training of the PyTorch port (counterpart of
incubator_mxnet_tpu/parallel/): meshes of replica contexts, the replica
group's collectives (in-process, or a torch.distributed group),
`functionalize`, ZeRO bucket plans, per-replica dispatch threads and
`ShardedTrainer` with ZeRO levels 0–3; `retry_transient` from the
resilience layer.

Not yet ported (ROADMAP Queue 1 item 7, slice 23), each raising where
it is called: `ResilientTrainer`, `ElasticTrainer` and `ReplicaHealth`
(resilience.py, elastic.py), `pipeline_apply`, `split_microbatches`,
`stack_stage_params` (pipeline.py), `switch_route`, `moe_apply`,
`moe_ffn` (moe.py), `ring_attention`, `ulysses_attention`,
`local_attention` (ring_attention.py).
"""
from .mesh import make_mesh, Mesh, NamedSharding, P, Shards, replicated, \
    batch_sharded, default_dp_mesh, mesh_devices, surviving_mesh, \
    replica_contexts
from .collectives import ReplicaGroup, ProcessReplicaGroup, replica_sync
from .functional import functionalize, extract_params, load_params
from .trainer import (ShardedTrainer, softmax_ce_loss, sgd_momentum_tree,
                      adam_tree)
from .zero import BucketPlan, overlap_schedule, zero_level_default
from .dispatch import DispatchPool
from .resilience import retry_transient

__all__ = ["make_mesh", "Mesh", "NamedSharding", "P", "Shards",
           "replicated", "batch_sharded", "default_dp_mesh", "mesh_devices",
           "surviving_mesh", "replica_contexts", "ReplicaGroup",
           "ProcessReplicaGroup", "replica_sync", "functionalize",
           "extract_params", "load_params", "ShardedTrainer",
           "softmax_ce_loss", "sgd_momentum_tree", "adam_tree",
           "BucketPlan", "overlap_schedule", "zero_level_default",
           "DispatchPool", "retry_transient"]

_SLICE_23 = ("ResilientTrainer", "ElasticTrainer", "ReplicaHealth",
             "pipeline_apply", "split_microbatches", "stack_stage_params",
             "switch_route", "moe_apply", "moe_ffn", "ring_attention",
             "ulysses_attention", "local_attention")


def _not_ported(name):
    def raise_(*args, **kwargs):
        raise NotImplementedError(
            "parallel.%s is not yet ported: it comes with slice 23 of the "
            "port (ROADMAP Queue 1 item 7)" % name)
    raise_.__name__ = name
    return raise_


for _name in _SLICE_23:
    globals()[_name] = _not_ported(_name)
del _name
