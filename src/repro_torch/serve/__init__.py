"""`repro_torch.serve` — the serving engine of the PyTorch port.

    from repro_torch.serve import Engine, GenerationConfig, Request

    engine = Engine(cfg, params, max_slots=8, precision="bf16")   # on CUDA
    outs = engine.generate([
        Request(tokens=[1, 2, 3], gen=GenerationConfig(max_new_tokens=16)),
    ])

``Engine(..., device="cpu")`` runs the plain PyTorch attention path;
``paged=True`` serves from a block-paged cache with shared-prefix reuse;
``Engine(cfg, plan=plan, stage_params=...)`` serves the partitions
unjoined, e.g. from per-stage checkpoints:

    sps = stage_params_from_checkpoints(cfg, plan, "ckpt/stages")
    engine = Engine(cfg, plan=plan, stage_params=sps)
"""
from repro_torch.serve.api import (Completion, GenerationConfig, Request,
                                   StreamEvent)
from repro_torch.serve.engine import Engine
from repro_torch.serve.kv_cache import (BlockAllocator, CachePool, PagedAlloc,
                                        PagedCachePool)
from repro_torch.serve.scheduler import Scheduler, SlotState
from repro_torch.serve.staged import (stage_params_from_checkpoints,
                                      staged_decode_step, staged_prefill)

__all__ = [
    "Completion", "GenerationConfig", "Request", "StreamEvent", "Engine",
    "CachePool", "BlockAllocator", "PagedAlloc", "PagedCachePool",
    "Scheduler", "SlotState", "stage_params_from_checkpoints",
    "staged_prefill", "staged_decode_step",
]
