"""Parallel training of the PyTorch port (counterpart of
incubator_mxnet_tpu/parallel/).

- meshes of replica contexts, and the process-group mesh with a
  subgroup per axis slice (mesh.py);
- the replica group's collectives, in-process or over a
  torch.distributed group (collectives.py), and `shard_map` with the
  axis collectives `axis_index`, `psum`, `pmean`, `ppermute` and
  `all_to_all` (spmd.py);
- `functionalize`, ZeRO bucket plans, per-replica dispatch threads and
  `ShardedTrainer` with ZeRO levels 0–3 and tensor parallelism over a
  (data, model) mesh (functional.py, zero.py, dispatch.py, trainer.py,
  tensor_parallel.py);
- `ResilientTrainer`: guarded steps, atomic checkpoints with integrity
  manifests, preemption and bit-exact resume; `retry_transient`
  (resilience.py);
- `ElasticTrainer` and `ReplicaHealth`: replica loss, shrink and
  re-admission with fleet telemetry (elastic.py);
- sequence parallelism: `ring_attention`, `ulysses_attention`,
  `local_attention` (ring_attention.py); pipeline parallelism:
  `pipeline_apply`, `split_microbatches`, `stack_stage_params`
  (pipeline.py); expert parallelism: `switch_route`, `moe_apply`,
  `moe_ffn` (moe.py).
"""
from .mesh import make_mesh, Mesh, NamedSharding, P, Shards, replicated, \
    batch_sharded, default_dp_mesh, mesh_devices, surviving_mesh, \
    replica_contexts, process_mesh, squeeze_stage_axis, mark_varying
from .collectives import ReplicaGroup, ProcessReplicaGroup, replica_sync
from .spmd import shard_map, axis_index, axis_size, psum, pmean, \
    ppermute, all_to_all
from .functional import functionalize, extract_params, load_params
from .trainer import (ShardedTrainer, softmax_ce_loss, sgd_momentum_tree,
                      adam_tree)
from .zero import BucketPlan, overlap_schedule, zero_level_default
from .dispatch import DispatchPool
from .resilience import ResilientTrainer, retry_transient
from .elastic import ElasticTrainer, ReplicaHealth
from .ring_attention import ring_attention, ulysses_attention, \
    local_attention
from .pipeline import pipeline_apply, split_microbatches, \
    stack_stage_params
from .moe import switch_route, moe_apply, moe_ffn

__all__ = ["make_mesh", "Mesh", "NamedSharding", "P", "Shards",
           "replicated", "batch_sharded", "default_dp_mesh", "mesh_devices",
           "surviving_mesh", "replica_contexts", "process_mesh",
           "squeeze_stage_axis", "mark_varying", "ReplicaGroup",
           "ProcessReplicaGroup", "replica_sync", "shard_map", "axis_index",
           "axis_size", "psum", "pmean", "ppermute", "all_to_all",
           "functionalize", "extract_params", "load_params",
           "ShardedTrainer", "softmax_ce_loss", "sgd_momentum_tree",
           "adam_tree", "BucketPlan", "overlap_schedule",
           "zero_level_default", "DispatchPool", "ResilientTrainer",
           "retry_transient", "ElasticTrainer", "ReplicaHealth",
           "ring_attention", "ulysses_attention", "local_attention",
           "pipeline_apply", "split_microbatches", "stack_stage_params",
           "switch_route", "moe_apply", "moe_ffn"]
