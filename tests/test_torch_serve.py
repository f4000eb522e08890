"""The port's serving engine against ``repro.serve.Engine`` on the CPU.

Both engines serve the ``verify.scenarios.serve_cfg`` world (smoke qwen2 at
fp32) from one set of weights, made by the reference's ``init_params`` and
handed across with ``repro_torch.convert.params_from_numpy``.  At
temperature 0 they must give the same tokens and finish reasons; sampling
draws from another random stream in each package, so sampled requests are
held only to the port's own contract (a request's tokens depend on its seed
and logits alone).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import Engine as JEngine
from repro.serve import GenerationConfig as JGen
from repro.serve import Request as JRequest
from repro.serve import sampling as JS
from repro.verify import scenarios
from repro_torch.configs import get as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as TM
from repro_torch.serve import Engine, GenerationConfig, Request
from repro_torch.serve import sampling as TS


@pytest.fixture(scope="module")
def worlds():
    """window -> (jax cfg, jax params, port cfg, port params)."""
    jparams = scenarios.serve_params(scenarios.serve_cfg())
    tcfg = tget("qwen2-1.5b", smoke=True).replace(dtype="float32")
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")

    def world(window=0):
        return (scenarios.serve_cfg(window=window), jparams,
                tcfg.replace(sliding_window=window), tparams)
    return world


def _pair(tokens, **gen):
    """The same request for both packages."""
    t = np.asarray(tokens, np.int32)
    return (JRequest(tokens=t, gen=JGen(**gen)),
            Request(tokens=t, gen=GenerationConfig(**gen)))


def _mixed(cfg, lens=(8, 12, 5, 10), news=(6, 9, 4, 7)):
    rng = np.random.RandomState(0)
    return [_pair(rng.randint(0, cfg.vocab_size, size=(ln,)),
                  max_new_tokens=nn) for ln, nn in zip(lens, news)]


def _run_both(world, pairs, **kw):
    jcfg, jparams, tcfg, tparams = world
    want = JEngine(jcfg, jparams, **kw).generate([j for j, _ in pairs])
    got = Engine(tcfg, tparams, device="cpu", **kw).generate(
        [t for _, t in pairs])
    return want, got


def _same(want, got):
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [c.finish_reason for c in got] == \
        [c.finish_reason for c in want]


@pytest.mark.parametrize("window", [0, 8], ids=["contiguous", "ring"])
def test_greedy_tokens_match_reference(worlds, window):
    """Mixed prompt lengths, more requests than slots."""
    world = worlds(window)
    want, got = _run_both(world, _mixed(world[0]), max_slots=2,
                          decode_block=4)
    _same(want, got)


def test_paged_shared_prefix_matches_reference(worlds):
    world = worlds()
    rng = np.random.RandomState(1)
    t0 = rng.randint(0, world[0].vocab_size, size=(8,))
    other = rng.randint(0, world[0].vocab_size, size=(8,))
    pairs = [_pair(t0, max_new_tokens=6), _pair(t0, max_new_tokens=5),
             _pair(np.concatenate([t0[:4], other[:4]]), max_new_tokens=7),
             _pair(other[:6], max_new_tokens=4)]
    want, got = _run_both(world, pairs, max_slots=3, decode_block=4,
                          paged=True, block_size=4)
    _same(want, got)
    eng = Engine(world[2], world[3], device="cpu", max_slots=3,
                 decode_block=4, paged=True, block_size=4)
    again = eng.generate([t for _, t in pairs])
    assert [c.tokens for c in again] == [c.tokens for c in want]
    assert eng._pool.prefix_hits == 3       # twin: 2 blocks, half-share: 1
    assert eng._pool.allocator.n_used == 0
    contiguous = Engine(world[2], world[3], device="cpu", max_slots=3,
                        decode_block=4).generate([t for _, t in pairs])
    assert [c.tokens for c in contiguous] == [c.tokens for c in want]


def test_eos_on_first_token(worlds):
    world = worlds()
    jcfg, _, tcfg, tparams = world
    rng = np.random.RandomState(2)
    toks = rng.randint(0, jcfg.vocab_size, size=(9,))
    logits, _, _ = TM.prefill(tcfg, tparams,
                              {"tokens": torch.as_tensor(toks[None])}, 16)
    first = int(torch.argmax(logits[0, :tcfg.vocab_size]))
    pairs = [_pair(toks, max_new_tokens=8, eos_id=first),
             _pair(toks[:5], max_new_tokens=3)]
    want, got = _run_both(world, pairs, max_slots=2, decode_block=4)
    _same(want, got)
    assert got[0].tokens == (first,) and got[0].finish_reason == "eos"


def _ticking(dt=0.1):
    """A clock that advances ``dt`` seconds at every read."""
    t = [0.0]

    def tick():
        t[0] += dt
        return t[0]
    return tick


@pytest.mark.parametrize("kw,slots,lens,news,rejected", [
    (dict(max_cache_tokens=16), 2, (8, 8), (6, 60), "rejected_cache"),
    (dict(max_cache_tokens=24, paged=True, block_size=4), 3, (8, 12, 5, 10),
     (6, 9, 4, 7), None),
    (dict(max_queue_wait_ms=250), 1, (8, 8), (8, 8), "rejected_queue"),
], ids=["cache-budget", "paged-block-budget", "queue-wait"])
def test_degradation_knobs_match_reference(worlds, kw, slots, lens, news,
                                           rejected):
    """Admission control and shedding: the same completions, finish reasons
    and rejection counts as the reference under the same knobs and clock
    (a clock that advances 0.1 s at every read)."""
    jcfg, jparams, tcfg, tparams = worlds()
    pairs = _mixed(jcfg, lens=lens, news=news)
    jeng = JEngine(jcfg, jparams, max_slots=slots, decode_block=4,
                   clock=_ticking(), **kw)
    teng = Engine(tcfg, tparams, device="cpu", max_slots=slots,
                  decode_block=4, clock=_ticking(), **kw)
    _same(jeng.generate([j for j, _ in pairs]),
          teng.generate([t for _, t in pairs]))
    assert teng.stats == jeng.stats
    assert sum(teng.stats.values()) == (rejected is not None)
    if rejected:
        assert teng.stats[rejected] == 1


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.9),
                                         (16, 0.5), (3, 0.0)])
def test_filter_logits_matches_reference(top_k, top_p):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 512)).astype(np.float32) * 3
    ks = np.asarray([top_k, 0, top_k, 7], np.int32)
    ps = np.asarray([top_p, top_p, 1.0, 0.8], np.float32)
    want = np.asarray(JS.filter_logits(jnp.asarray(logits), jnp.asarray(ks),
                                       jnp.asarray(ps)))
    got = TS.filter_logits(torch.as_tensor(logits), torch.as_tensor(ks),
                           torch.as_tensor(ps)).numpy()
    np.testing.assert_array_equal(got, want)


def test_mode_for_matches_reference():
    cases = [[GenerationConfig()], [GenerationConfig(temperature=0.7)],
             [GenerationConfig(), GenerationConfig(temperature=1.0,
                                                   top_k=4)],
             [GenerationConfig(temperature=1.0, top_p=0.9)]]
    for gens in cases:
        jgens = [JGen(**g.__dict__) for g in gens]
        assert TS.mode_for(gens) == JS.mode_for(jgens)


def test_sampled_stream_independent_of_batching(worlds):
    """A request's sampled tokens depend on its own seed, not on its slot
    or batch mates."""
    _, _, tcfg, tparams = worlds()
    gen = GenerationConfig(max_new_tokens=6, temperature=0.8, top_k=16,
                           top_p=0.9, seed=13)
    rng = np.random.RandomState(1)
    r = Request(tokens=rng.randint(0, tcfg.vocab_size, size=(8,)), gen=gen)
    others = [t for _, t in _mixed(tcfg, lens=(5, 10), news=(7, 3))]
    solo = Engine(tcfg, tparams, device="cpu", max_slots=1,
                  decode_block=4).generate([r])
    crowd = Engine(tcfg, tparams, device="cpu", max_slots=3,
                   decode_block=4).generate([others[0], r, others[1]])
    assert solo[0].tokens == crowd[1].tokens
    other_seed = Engine(tcfg, tparams, device="cpu", max_slots=1,
                        decode_block=4).generate(
        [Request(tokens=r.tokens, gen=gen.replace(seed=14))])
    assert other_seed[0].tokens != solo[0].tokens


def test_stream_deltas_match_generate(worlds):
    _, _, tcfg, tparams = worlds()
    reqs = [t for _, t in _mixed(tcfg)]
    eng = Engine(tcfg, tparams, device="cpu", max_slots=2, decode_block=4)
    deltas = {}
    done = {}
    for ev in eng.stream(reqs):
        if ev.kind == "delta":
            deltas.setdefault(ev.req_idx, []).append(ev.token)
        else:
            done[ev.req_idx] = ev.completion
    assert {i: tuple(t) for i, t in deltas.items()} == \
        {i: c.tokens for i, c in done.items()}
    assert [c.tokens for c in eng.generate(reqs)] == \
        [done[i].tokens for i in range(len(reqs))]


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_engine_on_card_matches_cpu(worlds, paged):
    """The engine through the CUDA kernels gives the CPU path's greedy
    tokens (fp32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    _, _, tcfg, tparams = worlds()
    reqs = [t for _, t in _mixed(tcfg, lens=(20, 33, 17), news=(9, 5, 12))]
    want = Engine(tcfg, tparams, device="cpu", max_slots=2,
                  decode_block=4).generate(reqs)
    got = Engine(tcfg, tparams, device="cuda", max_slots=2, decode_block=4,
                 paged=paged).generate(reqs)
    assert [c.tokens for c in got] == [c.tokens for c in want]


def test_launcher_token_stream_matches_reference():
    """The launcher's own copy of ``data/lm.py::synthetic_token_stream``."""
    from repro.data.lm import synthetic_token_stream as want
    from repro_torch.launch.serve import synthetic_token_stream as got
    for n, vocab, seed in ((3000, 151936, 0), (500, 512, 7)):
        np.testing.assert_array_equal(got(n, vocab, seed=seed),
                                      want(n, vocab, seed=seed))
