"""Checkpointing: a tree of tensors <-> npz + JSON manifest (counterpart of
``repro/checkpoint/checkpoint.py``, in the same on-disk format).

A tree is nested dicts and lists of tensors (``repro_torch.tree``).  Each
leaf is stored under its path as the reference spells it: dict keys joined
by ``/``, list indices as ``[i]`` (``params/[0]/w``), so either package
reads a step the other wrote for trees of the same structure.  Leaves are
copied to the host synchronously (the port's optimizers update params and
state in place, so an asynchronous copy would race the next step) and made
contiguous; bfloat16 leaves are stored as uint16 views with ``"bfloat16"``
in the manifest and restored bit for bit.

Durability contract (as the reference's): writes are **atomic** — both the
array archive and the manifest go through temp file + fsync +
``os.replace``, and the manifest, written last, is the commit record, so a
crash mid-save never leaves a step that looks complete.  Every leaf's CRC32
is recorded in the manifest and verified on restore; with ``step=None`` a
restore falls back across torn or corrupt steps to the newest one that
validates (``CheckpointCorruptError`` marks the skipped ones).
``keep_last=N`` bounds retention without ever deleting the step just
written.  Saves count ``checkpoint_saves_total`` and emit
``checkpoint_save`` on the port's ``obs`` defaults (restores likewise).

``device=`` on restore is one ``torch.device`` that every leaf lands on
(the reference's single-device ``shardings=``), or a tree of devices, one
per leaf; ``None`` gives CPU tensors.
"""
from __future__ import annotations

import json
import os
import re
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.events import default_log
from repro_torch.obs.registry import default_registry

_BF16 = "bfloat16"


class CheckpointCorruptError(ValueError):
    """A checkpoint step that exists on disk but does not validate (torn
    write, truncated archive or manifest, checksum mismatch).  Distinct
    from caller errors (mismatched ``like`` trees) so the fallback path
    knows which failures an older checkpoint can cure."""


def _flatten_with_paths(tree) -> Dict[str, Any]:
    """{path: leaf} in the reference's spelling (dict keys sorted, as JAX
    flattens them)."""
    out: Dict[str, Any] = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (f"[{i}]",))
        else:
            out["/".join(path)] = t
    walk(tree, ())
    return out


def _unflatten(like, leaves: Dict[str, Any], path=()):
    """``like``'s structure (dicts keep their key order) with each leaf
    taken from ``leaves`` by its path."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves, path + (f"[{i}]",))
               for i, v in enumerate(like)]
        return tuple(out) if isinstance(like, tuple) else out
    return leaves["/".join(path)]


def _stored(leaf) -> Tuple[np.ndarray, str]:
    """(the array written to the archive, the manifest's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()      # synchronous copy
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _atomic_write(path: str, write_fn) -> None:
    """temp file + fsync + os.replace: the file at ``path`` is either the
    old content or the complete new content, never a torn prefix."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    # best-effort directory fsync so the rename itself is durable
    try:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def _npz_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.npz")


def _manifest_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.json")


def save_checkpoint(directory: str, step: int, tree: Any, metadata=None,
                    keep_last: Optional[int] = None) -> str:
    """Write ``tree`` as step ``step`` of ``directory``; returns the archive's
    path."""
    os.makedirs(directory, exist_ok=True)
    stored, dtypes = {}, {}
    for k, v in _flatten_with_paths(tree).items():
        stored[k], dtypes[k] = _stored(v)
    path = _npz_path(directory, step)
    _atomic_write(path, lambda f: np.savez(f, **stored))
    manifest = {
        "step": step,
        "keys": sorted(stored),
        "shapes": {k: list(v.shape) for k, v in stored.items()},
        "dtypes": dtypes,
        # CRC32 of the stored bytes (the uint16 view for bf16) per leaf;
        # restore verifies every leaf it reads against these
        "checksums": {k: zlib.crc32(np.ascontiguousarray(v))
                      for k, v in stored.items()},
        "metadata": metadata or {},
    }
    # the manifest commits the step: it is written strictly after the
    # arrays, so a crash between the two leaves a detectable torn step
    _atomic_write(_manifest_path(directory, step),
                  lambda f: f.write(json.dumps(manifest, indent=1)
                                    .encode("utf-8")))
    if keep_last:
        prune_checkpoints(directory, keep_last)
    default_registry().counter("checkpoint_saves_total").inc()
    default_log().emit("checkpoint_save", step=step, directory=directory,
                       leaves=len(stored))
    return path


def prune_checkpoints(directory: str, keep_last: int) -> List[int]:
    """Delete all but the newest ``keep_last`` steps; returns the pruned
    step numbers."""
    steps = available_steps(directory)
    drop = steps[:-keep_last] if keep_last > 0 else []
    for s in drop:
        for p in (_npz_path(directory, s), _manifest_path(directory, s)):
            try:
                os.remove(p)
            except FileNotFoundError:
                pass
    return drop


def _leaf_devices(flat_like: Dict[str, Any], device) -> Dict[str, Any]:
    """Per-leaf restore targets: one device broadcast to every leaf, or a
    tree of devices matching ``like``."""
    if isinstance(device, (torch.device, str)):
        return {k: torch.device(device) for k in flat_like}
    flat_dev = _flatten_with_paths(device)
    missing = [k for k in flat_like if k not in flat_dev]
    if missing:
        raise ValueError(f"device tree lacks leaves for {missing[:3]}... "
                         "pass a matching tree, or one device to broadcast")
    return flat_dev


def _load_step(directory: str, like: Any, step: int, device: Any) -> Any:
    """Restore one specific step, validating archive + manifest + per-leaf
    checksums.  Raises ``CheckpointCorruptError`` for anything an older
    checkpoint could cure, plain ``ValueError`` for caller errors."""
    npz_path = _npz_path(directory, step)
    manifest_path = _manifest_path(directory, step)
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise CheckpointCorruptError(
            f"missing manifest {manifest_path} (crash mid-save: arrays "
            "written, step never committed)") from None
    except json.JSONDecodeError as e:
        raise CheckpointCorruptError(
            f"corrupt/truncated manifest {manifest_path}: {e}") from None
    try:
        z = np.load(npz_path)
        files = set(z.files)
    except Exception as e:  # noqa: BLE001 -- any unreadable archive is torn
        raise CheckpointCorruptError(
            f"corrupt/truncated checkpoint archive {npz_path}: {e}"
        ) from None
    with z:
        flat_like = _flatten_with_paths(like)
        saved_keys = set(manifest.get("keys", ()))
        torn = [k for k in flat_like if k in saved_keys and k not in files]
        if torn:
            raise CheckpointCorruptError(
                f"checkpoint step {step} in {directory} archive lacks "
                f"arrays the manifest committed: {torn[:3]}")
        missing = [k for k in flat_like if k not in files]
        if missing:
            raise ValueError(
                f"checkpoint step {step} in {directory} lacks arrays for "
                f"{missing[:3]}{'...' if len(missing) > 3 else ''} "
                f"(restore `like` tree does not match the saved tree)")
        checksums = manifest.get("checksums")
        devs = None if device is None else _leaf_devices(flat_like, device)
        leaves = {}
        for key in flat_like:
            try:
                arr = z[key]
            except Exception as e:  # noqa: BLE001 -- a torn member
                raise CheckpointCorruptError(
                    f"corrupt array {key!r} in {npz_path}: {e}") from None
            if checksums is not None and key in checksums:
                crc = zlib.crc32(np.ascontiguousarray(arr))
                if crc != checksums[key]:
                    raise CheckpointCorruptError(
                        f"checksum mismatch for {key!r} in {npz_path}: "
                        f"stored {checksums[key]}, read {crc}")
            if manifest["dtypes"].get(key) == _BF16:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            leaves[key] = t if devs is None else t.to(devs[key])
    return _unflatten(like, leaves)


def restore_latest_valid(directory: str, like: Any,
                         device: Any = None) -> Tuple[Any, int]:
    """``(tree, step)`` from the newest step that VALIDATES: torn or
    corrupt steps are skipped (newest first) until one loads cleanly.  The
    newest step's corruption error is raised when nothing validates."""
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    errors: List[CheckpointCorruptError] = []
    for step in reversed(steps):
        try:
            tree = _load_step(directory, like, step, device)
        except CheckpointCorruptError as e:
            errors.append(e)
            continue
        default_registry().counter("checkpoint_restores_total").inc()
        default_log().emit("checkpoint_restore", step=step,
                           directory=directory, skipped=len(errors))
        return tree, step
    tail = f" ({len(errors) - 1} older step(s) also invalid)" \
        if len(errors) > 1 else ""
    raise CheckpointCorruptError(str(errors[0]) + tail) from None


def restore_checkpoint(directory: str, like: Any, step: Optional[int] = None,
                       device: Any = None) -> Any:
    """Restore a ``like``-shaped tree.  ``step=None`` takes the newest
    *valid* step (falling back across corrupt ones); an explicit ``step``
    is pinned: corruption there raises instead of silently substituting
    other training state."""
    if step is None:
        tree, _ = restore_latest_valid(directory, like, device)
        return tree
    tree = _load_step(directory, like, int(step), device)
    default_registry().counter("checkpoint_restores_total").inc()
    default_log().emit("checkpoint_restore", step=int(step),
                       directory=directory, skipped=0)
    return tree


def available_steps(directory: str) -> List[int]:
    """All step numbers with an array archive on disk, ascending (validity
    is judged at restore time)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := re.match(r"ckpt_(\d+)\.npz$", f)))


def latest_step(directory: str) -> Optional[int]:
    steps = available_steps(directory)
    return steps[-1] if steps else None
