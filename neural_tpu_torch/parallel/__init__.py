"""Tensor, data, expert, sequence and pipeline parallelism over
``torch.distributed`` (port of ``neural_tpu/parallel``): one process a rank,
a :class:`Mesh` of named axes over the process group, the JAX split table,
the sharded step, prefill and decode loop, ``tp_generate``, ``ep_moe``,
ring attention and the sequence-sharded forward, the GPipe training step,
the sp × ep MoE training step and the multi-rank dry run. Every collective
of the mesh differentiates (``parallel.collectives``)."""
from .dryrun import dryrun_multichip, make_moe_train_step
from .ep import ep_moe, ep_param_specs, expert_capacity
from .multihost import agree, auto_mesh, checksum, init_distributed, \
    is_primary
from .pp import (fix_replicated_grads, make_pp_train_step, pipeline_apply,
                 pp_param_specs, pp_shard_params)
from .sharding import (Mesh, cache_specs, init_cache, make_mesh,
                       param_specs, shard_cache, shard_model, shard_params)
from .sp import ring_attend, sequence_sharded_forward
from .tp import (make_tp_decode_loop, make_tp_prefill, make_tp_step,
                 rank_generator, tp_generate)

__all__ = ["Mesh", "make_mesh", "shard_params", "shard_model",
           "shard_cache", "init_cache", "param_specs", "cache_specs",
           "make_tp_step", "make_tp_prefill", "make_tp_decode_loop",
           "tp_generate", "rank_generator", "init_distributed", "auto_mesh",
           "is_primary", "checksum", "agree", "ep_moe", "expert_capacity",
           "ep_param_specs", "ring_attend", "sequence_sharded_forward",
           "pp_param_specs", "pp_shard_params", "fix_replicated_grads",
           "pipeline_apply", "make_pp_train_step", "make_moe_train_step",
           "dryrun_multichip"]
