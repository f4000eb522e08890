"""Serving the dense configs of tests/test_torch_dense.py in the port
against ``repro``'s engine on the CPU: the smoke configs of stablelm-3b,
chatglm3-6b, mistral-large-123b and grok-1-314b, the weights from the
reference's ``init_params`` through ``repro_torch.convert``.  Greedy tokens
and finish reasons must equal the reference engine's on the contiguous and
the paged pool.
"""
import functools

import numpy as np
import pytest

from repro.serve import Engine as JEngine
from repro.serve import GenerationConfig as JGen
from repro.serve import Request as JRequest
from repro_torch.serve import Engine, GenerationConfig, Request

from test_torch_dense import world
from _torch_threads import _one_thread  # noqa: F401


def _requests(cfg, lens=(8, 8, 8, 8), news=(8, 4, 8, 4)):
    rng = np.random.RandomState(0)
    out = []
    for ln, nn in zip(lens, news):
        t = rng.randint(0, cfg.vocab_size, size=(ln,)).astype(np.int32)
        out.append((JRequest(tokens=t, gen=JGen(max_new_tokens=nn)),
                    Request(tokens=t, gen=GenerationConfig(
                        max_new_tokens=nn))))
    return out


@functools.lru_cache(maxsize=None)
def _reference_tokens(name):
    jcfg, jparams, _, _ = world(name)
    done = JEngine(jcfg, jparams, max_slots=2, decode_block=4).generate(
        [j for j, _ in _requests(jcfg)])
    return [c.tokens for c in done], [c.finish_reason for c in done]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("name", ["stablelm", "chatglm3", "mistral", "grok"])
def test_greedy_engine_tokens_match_reference(name, paged):
    """Four requests through two slots on each pool, so slots are reused
    and requests finish at different steps: tokens and finish reasons equal
    the reference engine's (its contiguous pool; the reference's pools
    agree).  One prompt length and whole decode chunks keep the reference
    engine to one prefill and one decode compile a batch size; the mixed
    lengths are the other engine tests'."""
    jcfg, _, tcfg, tparams = world(name)
    got = Engine(tcfg, tparams, device="cpu", max_slots=2, decode_block=4,
                 paged=paged).generate([t for _, t in _requests(jcfg)])
    tokens, reasons = _reference_tokens(name)
    assert [c.tokens for c in got] == tokens
    assert [c.finish_reason for c in got] == reasons
