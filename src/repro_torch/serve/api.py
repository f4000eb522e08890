"""Typed request/response surface of `repro_torch.serve` (copied from
`repro/serve/api.py`).

A ``Request`` carries one prompt (plus any modality payloads the arch needs)
and a ``GenerationConfig``; the ``Engine`` turns it into a ``Completion``.
Prompts in one ``Engine.generate`` call may have different lengths and
different generation configs — the scheduler batches them continuously.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class GenerationConfig:
    """Per-request sampling/termination knobs.

    temperature <= 0 means greedy; top_k == 0 and top_p >= 1 disable the
    respective filters.  ``seed`` keys this request's private sampling stream
    (continuous batching never couples streams across requests).
    """
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    seed: int = 0

    def replace(self, **kw) -> "GenerationConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Request:
    """One prompt. ``tokens``: 1-D int sequence (list/np/jnp).

    frames / image_embeds: optional modality payloads (whisper / VLM); the
    engine fills in zero stubs when the arch needs them and they are omitted.
    """
    tokens: Any
    gen: GenerationConfig = GenerationConfig()
    frames: Any = None
    image_embeds: Any = None
    id: Optional[str] = None
    # total latency budget in milliseconds, measured from submission: the
    # engine rejects the request (finish_reason "rejected", partial tokens
    # kept) once the budget elapses — queued OR mid-decode.  None = no
    # deadline (the pre-resilience behavior)
    deadline_ms: Optional[float] = None


@dataclass(frozen=True)
class StreamEvent:
    """One increment from ``Engine.stream``.

    kind == "delta": ``token`` is the next generated token of request
    ``req_idx`` (deltas for one request arrive in order; deltas of
    different requests interleave with the continuous batch).
    kind == "done": ``completion`` is the request's final ``Completion``
    (its ``tokens`` are exactly the deltas streamed before it).
    """
    kind: str                        # "delta" | "done"
    req_idx: int
    id: Optional[str]
    token: Optional[int] = None
    completion: Optional["Completion"] = None


@dataclass(frozen=True)
class Completion:
    """The engine's answer to one Request."""
    id: Optional[str]
    prompt_tokens: Tuple[int, ...]
    tokens: Tuple[int, ...]          # generated tokens (eos included if hit)
    # "eos" | "length" | "rejected" — "rejected" marks load shedding (queue
    # timeout, missed deadline, or cache-pressure admission control); its
    # tokens are whatever was emitted before the cut, possibly none
    finish_reason: str

    @property
    def n_prompt(self) -> int:
        return len(self.prompt_tokens)

    @property
    def n_generated(self) -> int:
        return len(self.tokens)
