"""Serving mixture-of-experts models in the port against ``repro``'s
engines on the CPU: granite-moe-3b-a800m's smoke config (2 layers, 4
experts, top 2) and Jamba's smoke config with its experts, the weights
from the reference's ``init_params`` through ``repro_torch.convert``.

Greedy tokens and finish reasons must equal the reference engine's
(``TokensEqual``) on the contiguous and the paged pool, also at a slot
count where decode capacity binds (every slot, live or free, takes part
in routing, so the free slots' inputs decide which live picks drop), and
from the PartitionPlan's stage trees served unjoined.
"""
import numpy as np
import pytest

from repro.core import partition as JP
from repro.serve import Engine as JEngine
from repro.serve import GenerationConfig as JGen
from repro.serve import Request as JRequest
from repro_torch.core import partition as TP
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as TL
from repro_torch.serve import Engine, GenerationConfig, Request

from test_torch_moe import GRANITE, JAMBA, _world
from _torch_threads import _one_thread  # noqa: F401


@pytest.fixture(scope="module")
def granite():
    return _world(GRANITE)


def _requests(cfg, n=5, seed=0):
    rng = np.random.RandomState(seed)
    lens = [8, 12, 5, 10, 8, 7, 12, 9][:n] if n <= 8 else \
        rng.randint(4, 14, size=n).tolist()
    news = [6, 9, 4, 7, 5, 8, 3, 6][:n] if n <= 8 else \
        rng.randint(3, 10, size=n).tolist()
    out = []
    for ln, nn in zip(lens, news):
        t = rng.randint(0, cfg.vocab_size, size=(ln,)).astype(np.int32)
        out.append((JRequest(tokens=t, gen=JGen(max_new_tokens=nn)),
                    Request(tokens=t, gen=GenerationConfig(
                        max_new_tokens=nn))))
    return out


class _DropWatch:
    """Records, for each routing call at ``t`` tokens, whether a pick
    dropped."""

    def __init__(self, monkeypatch, t):
        self.t, self.dropped = t, []
        route = TL.moe_route

        def watched(router, xt, moe_cfg, c):
            res = route(router, xt, moe_cfg, c)
            if xt.shape[1] == self.t:
                self.dropped.append(bool((~res[5]).any()))
            return res
        monkeypatch.setattr(TL, "moe_route", watched)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch,slots,n_req", [
    (GRANITE, 2, 5), (GRANITE, 32, 10), (JAMBA, 2, 5)],
    ids=["granite-2", "granite-32-binding", "jamba-2"])
def test_greedy_engine_tokens_match_reference(monkeypatch, arch, slots,
                                              n_req, paged):
    """Requests of mixed lengths through the engine on both pools: tokens
    and finish reasons equal the reference engine's.  At 32 slots the
    smoke config's decode capacity (24 slots an expert) binds: live tokens
    drop, and which drop depends on what the free slots feed the router."""
    jcfg, jparams, tcfg, tparams = _world(arch)
    pairs = _requests(jcfg, n_req)
    kw = dict(max_slots=slots, decode_block=4, paged=paged)
    want = JEngine(jcfg, jparams, **kw).generate([j for j, _ in pairs])
    watch = _DropWatch(monkeypatch, slots)
    got = Engine(tcfg, tparams, device="cpu", **kw).generate(
        [t for _, t in pairs])
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.finish_reason for c in got] == \
        [c.finish_reason for c in want]
    assert watch.dropped and any(watch.dropped) == (slots == 32)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_staged_engine_matches_reference(granite, paged):
    """granite's two stage trees served unjoined: greedy tokens equal the
    reference's staged engine and the port's joined engine."""
    jcfg, jparams, tcfg, tparams = granite
    jplan, plan = JP.make_plan(jcfg, 2), TP.make_plan(tcfg, 2)
    jsp = [JP.slice_stage_params(jcfg, jplan, jparams, k) for k in (0, 1)]
    sp = [TP.slice_stage_params(tcfg, plan, tparams, k) for k in (0, 1)]
    pairs = _requests(jcfg, 4, seed=1)
    kw = dict(max_slots=2, decode_block=4, paged=paged)
    want = JEngine(jcfg, plan=jplan, stage_params=jsp, **kw).generate(
        [j for j, _ in pairs])
    got = Engine(tcfg, plan=plan, stage_params=sp, device="cpu",
                 **kw).generate([t for _, t in pairs])
    joined = Engine(tcfg, tparams, device="cpu", **kw).generate(
        [t for _, t in pairs])
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.tokens for c in got] == [c.tokens for c in joined]


def test_launch_serve_granite_smoke_on_cpu(capsys):
    assert launch_serve.main(["--arch", GRANITE, "--smoke", "--device",
                              "cpu", "--batch", "2", "--prompt-len", "8",
                              "--new-tokens", "4"]) in (0, None)
    assert "decoded 8 tokens" in capsys.readouterr().out
