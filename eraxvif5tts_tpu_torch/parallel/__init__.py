"""Multi-device training and serving on ``torch.distributed``: the mesh,
the sharding rules, ZeRO-1 partitions (`parallel/mesh.py`) and the model's
view of its rank (`parallel/shard.py`)."""

from eraxvif5tts_tpu_torch.parallel.mesh import (  # noqa: F401
    LocalBatch,
    local_rows,
    make_mesh,
    param_sharding_rules,
    process_count,
    shard_model,
)
