"""Parallelism of the port on torch.distributed (port of spectre_tpu/parallel/):
the process group and the ("data", "model") mesh, DDP, FSDP2 (ZeRO-3),
tensor parallelism with explicit collectives, the collective audit, and the
layout a train state runs in.

JAX names without a counterpart: ``batch_sharding`` and
``replicated_sharding`` (a rank holds local tensors; ``local_rows`` and
``shard_batch`` give its slice), ``fsdp_shardings`` and ``tp_shardings``
(``fsdp_specs`` and ``tp_specs`` give the same specs by parameter name),
``pin_step_shardings`` (FSDP2 does not drift, ``parallel/fsdp.py``) and
``audit_compiled``/``collective_ops`` (an eager step is counted as it runs,
``collective_counts``).
"""

from spectre_tpu_torch.parallel.audit import (
    assert_dp_signature,
    assert_fsdp_signature,
    assert_tp_signature,
    collective_counts,
)
from spectre_tpu_torch.parallel.fsdp import MIN_SHARD_SIZE, apply_fsdp, fsdp_specs
from spectre_tpu_torch.parallel.layout import Layout, augment_rows, parallelize, rank_seed
from spectre_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_rank,
    axis_size,
    create_mesh,
    init_distributed,
    local_rows,
    shard_batch,
)
from spectre_tpu_torch.parallel.tp import SPECTRE_TP_RULES, VIT_TP_RULES, apply_tp, tp_specs

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "MIN_SHARD_SIZE",
    "init_distributed", "create_mesh", "axis_size", "axis_rank", "local_rows", "shard_batch",
    "VIT_TP_RULES", "SPECTRE_TP_RULES", "apply_tp", "tp_specs",
    "apply_fsdp", "fsdp_specs",
    "Layout", "parallelize", "augment_rows", "rank_seed",
    "collective_counts", "assert_dp_signature", "assert_fsdp_signature",
    "assert_tp_signature",
]
