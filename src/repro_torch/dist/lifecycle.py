"""Per-stage checkpoint / resume / join on ``repro_torch.checkpoint``
(counterpart of ``repro/dist/lifecycle.py``).

Each stage owns its checkpoint directory (``<root>/stage_NN``) with its own
manifests and an INDEPENDENT tick counter: the partitions share no training
state, so a stage's failure is recoverable from that stage's checkpoints
alone, without reading the others:

    save_stage(root, k, tick, params, opt_state)     # one stage, one manifest
    restore_stage(root, k, like_params, like_opt,    # -> (params, opt, tick)
                  device=plan.device_for(k))
    join_from_checkpoints(root, like_stage_params,   # full params for eval
                          join_fn=backend.join)

``device=`` lands every restored leaf on that one device, as the executor
pinned the stage at startup.  ``join_from_checkpoints`` gives CPU tensors.
"""
from __future__ import annotations

import os
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    restore_latest_valid, save_checkpoint)


def stage_dir(root: str, k: int) -> str:
    return os.path.join(root, f"stage_{k:02d}")


def save_stage(root: str, k: int, tick: int, stage_params,
               opt_state=None, metadata: Optional[dict] = None,
               keep_last: Optional[int] = None) -> str:
    """Checkpoint one stage: params (and optimizer state) under the stage's
    own directory, at the stage's own tick.  ``keep_last=N`` keeps only the
    N newest ticks of this stage."""
    tree = {"params": stage_params}
    if opt_state is not None:
        tree["opt"] = opt_state
    meta = dict(metadata or {})
    meta.setdefault("stage", k)
    meta.setdefault("tick", int(tick))
    return save_checkpoint(stage_dir(root, k), int(tick), tree,
                           metadata=meta, keep_last=keep_last)


def restore_stage(root: str, k: int, like_params, like_opt=None, *,
                  step: Optional[int] = None, device=None):
    """One stage -> ``(params, opt_state_or_None, tick)``.

    ``like_*`` give the tree structure only.  ``device`` lands every leaf
    on that device; None gives CPU tensors.  With ``step=None`` the restore
    takes the newest tick that VALIDATES (the crash that forced this resume
    may have torn a save), and the returned tick tells the executor how far
    to replay.  An explicit ``step`` stays pinned: corruption there
    raises."""
    d = stage_dir(root, k)
    like = {"params": like_params}
    if like_opt is not None:
        like["opt"] = like_opt
    if step is None:
        try:
            tree, tick = restore_latest_valid(d, like, device=device)
        except FileNotFoundError:
            raise FileNotFoundError(
                f"no checkpoints for stage {k} under {root}") from None
        return tree["params"], tree.get("opt"), tick
    tick = int(step)
    tree = restore_checkpoint(d, like, step=tick, device=device)
    return tree["params"], tree.get("opt"), tick


def stage_ticks(root: str, n_stages: int) -> List[Optional[int]]:
    """Latest checkpointed tick per stage (None where a stage has none),
    read without loading any arrays."""
    return [latest_step(stage_dir(root, k)) for k in range(n_stages)]


def load_stage_params(root: str, like_stage_params: Sequence, *,
                      step: Optional[int] = None,
                      devices: Optional[Sequence] = None) -> List[Any]:
    """Every stage's params (no optimizer state), each from its own latest
    (or ``step``-pinned) manifest."""
    out = []
    for k, like in enumerate(like_stage_params):
        dev = devices[k] if devices is not None else None
        params, _, _ = restore_stage(root, k, like, step=step, device=dev)
        out.append(params)
    return out


def join_from_checkpoints(root: str, like_stage_params: Sequence,
                          join_fn: Callable[[List[Any]], Any], *,
                          step: Optional[int] = None):
    """The full network from per-stage checkpoints (the paper: "the
    partitions can be joined after this stage, to use the network").
    ``join_fn`` is the backend's joiner (``MLPBackend.join`` /
    ``LMBackend.join``)."""
    return join_fn(load_stage_params(root, like_stage_params, step=step))
