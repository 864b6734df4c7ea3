"""Tensor, data and expert parallelism over ``torch.distributed`` (port of
``neural_tpu/parallel``): one process a rank, a :class:`Mesh` of named
axes over the process group, the JAX split table, the sharded step,
prefill and decode loop, ``tp_generate`` and ``ep_moe``. Sequence and
pipeline parallelism (``ring_attend``, the pipeline training step) come
with the training slice."""
from .ep import ep_moe, ep_param_specs, expert_capacity
from .multihost import agree, auto_mesh, checksum, init_distributed, \
    is_primary
from .sharding import (Mesh, cache_specs, init_cache, make_mesh,
                       param_specs, shard_cache, shard_model, shard_params)
from .tp import (make_tp_decode_loop, make_tp_prefill, make_tp_step,
                 rank_generator, tp_generate)

__all__ = ["Mesh", "make_mesh", "shard_params", "shard_model",
           "shard_cache", "init_cache", "param_specs", "cache_specs",
           "make_tp_step", "make_tp_prefill", "make_tp_decode_loop",
           "tp_generate", "rank_generator", "init_distributed", "auto_mesh",
           "is_primary", "checksum", "agree", "ep_moe", "expert_capacity",
           "ep_param_specs"]
