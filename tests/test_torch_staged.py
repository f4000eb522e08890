"""Staged serving (the paper's partitions deployed unjoined) in the port
against ``repro.serve.staged`` and the reference's staged ``Engine`` on the
CPU, on qwen2-1.5b's smoke config (d 256, 4/2 heads of 64, vocab 512) at
fp32, tied and untied, cut into 2 and 3 stages.

Weights come from the reference's ``init_params`` through
``repro_torch.convert``.  Logits and caches are held at the fp32 tier
(rtol 1e-5, atol 1e-5 of the tensor's largest magnitude: a matmul's
summation-order error scales with its output); greedy tokens exactly
(``TokensEqual``).  Within torch, staged == joined where the last stage's
frozen ``tied_unembed`` equals stage 0's embedding, and checkpoints
restore bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.core import partition as JP
from repro.dist import lifecycle as JL
from repro.models import model as JM
from repro.serve import Engine as JEngine
from repro.serve import GenerationConfig as JGen
from repro.serve import Request as JRequest
from repro.serve import staged as JS
from repro.verify.compare import TokensEqual
from repro_torch.configs import get
from repro_torch.convert import params_from_numpy
from repro_torch.core import partition as TP
from repro_torch.dist import lifecycle
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as TM
from repro_torch.serve import (Engine, GenerationConfig, Request,
                               stage_params_from_checkpoints, staged)
from repro_torch.tree import tree_leaves
from repro_torch.verify.compare import Allclose

from test_torch_lm_train import _np_tree, _port_layout

CACHE_LEN = 32


def _world(tied=True, n_layers=2):
    """(jax cfg, port cfg, jax params, port params)."""
    kw = dict(dtype="float32", n_layers=n_layers, tie_embeddings=tied)
    jcfg = j_get("qwen2-1.5b", smoke=True).replace(**kw)
    cfg = get("qwen2-1.5b", smoke=True).replace(**kw)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_numpy(cfg, _np_tree(jparams),
                                                 device="cpu")


def _stages(world, n):
    jcfg, cfg, jparams, params = world
    jplan, plan = JP.make_plan(jcfg, n), TP.make_plan(cfg, n)
    return (jplan, [JP.slice_stage_params(jcfg, jplan, jparams, k)
                    for k in range(n)],
            plan, [TP.slice_stage_params(cfg, plan, params, k)
                   for k in range(n)])


def _close(want, got):
    want = np.asarray(want, np.float32)
    v = Allclose(rtol=1e-5, atol=1e-5 * float(np.abs(want).max())).compare(
        want, got.detach().float().numpy())
    assert v.ok, v.detail


def _tokens(cfg, b=2, s=9, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s))


@pytest.mark.parametrize("tied,n_stages,n_layers", [
    (True, 2, 2), (True, 3, 3), (False, 2, 2), (False, 3, 3)],
    ids=["tied-2", "tied-3", "untied-2", "untied-3"])
def test_staged_prefill_and_decode_match_reference(tied, n_stages, n_layers):
    world = _world(tied, n_layers)
    jcfg, cfg = world[:2]
    jplan, jsp, plan, sp = _stages(world, n_stages)
    toks = _tokens(cfg)
    jl, jc, jpos = JS.staged_prefill(jcfg, jplan, jsp,
                                     {"tokens": jnp.asarray(toks)}, CACHE_LEN)
    tl, tc, tpos = staged.staged_prefill(
        cfg, plan, sp, {"tokens": torch.from_numpy(toks)}, CACHE_LEN)
    assert int(jpos) == tpos == toks.shape[1]
    _close(jl, tl)
    for sk in jc:
        for name in jc[sk]:
            assert tuple(tc[sk][name].shape) == jc[sk][name].shape
            _close(jc[sk][name], tc[sk][name])
    tok = np.argmax(np.asarray(jl)[:, :cfg.vocab_size], -1)
    pos = np.full((toks.shape[0],), toks.shape[1], np.int32)
    for _ in range(2):
        jl, jc = JS.staged_decode_step(jcfg, jplan, jsp, jc,
                                       jnp.asarray(tok, jnp.int32),
                                       jnp.asarray(pos))
        tl, tc2 = staged.staged_decode_step(cfg, plan, sp, tc,
                                            torch.from_numpy(tok),
                                            torch.from_numpy(pos))
        assert tc2 is tc                       # written in place
        _close(jl, tl)
        tok = np.argmax(np.asarray(jl)[:, :cfg.vocab_size], -1)
        pos = pos + 1
    for sk in jc:
        for name in jc[sk]:
            _close(jc[sk][name], tc[sk][name])


def _requests(cfg, lens=(8, 12, 5, 10), news=(6, 9, 4, 7)):
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)) for n in lens]
    return ([JRequest(tokens=p.astype(np.int32),
                      gen=JGen(max_new_tokens=m))
             for p, m in zip(prompts, news)],
            [Request(tokens=p, gen=GenerationConfig(max_new_tokens=m))
             for p, m in zip(prompts, news)])


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_staged_engine_matches_joined_and_reference(paged):
    world = _world()
    jcfg, cfg, _, params = world
    jplan, jsp, plan, sp = _stages(world, 2)
    jreqs, reqs = _requests(cfg)
    kw = dict(max_slots=2, decode_block=4, paged=paged)
    want = JEngine(jcfg, plan=jplan, stage_params=jsp, **kw).generate(jreqs)
    got = Engine(cfg, plan=plan, stage_params=sp, device="cpu",
                 **kw).generate(reqs)
    joined = Engine(cfg, params, device="cpu", **kw).generate(reqs)
    v = TokensEqual().compare([c.tokens for c in want],
                              [c.tokens for c in got])
    assert v.ok, v.detail
    assert [c.tokens for c in got] == [c.tokens for c in joined]
    assert [c.finish_reason for c in got] == \
        [c.finish_reason for c in want]


def test_compute_copy_casts_the_tied_snapshot():
    """The engine's one bf16 copy of a last stage casts ``tied_unembed`` as
    it casts ``tok_embed``, so staged logits equal the joined engine's bit
    for bit."""
    world = _world()
    cfg, params = world[1], world[3]
    _, _, plan, sp = _stages(world, 2)
    cc = TM.compute_copy(sp[1], torch.bfloat16)
    assert cc["tied_unembed"].dtype == torch.bfloat16
    assert torch.equal(cc["tied_unembed"], sp[1]["tied_unembed"].bfloat16())
    assert cc["final_norm"]["scale"].dtype == torch.float32
    eng_s = Engine(cfg, plan=plan, stage_params=sp, device="cpu",
                   precision="bf16")
    eng_j = Engine(cfg, params, device="cpu", precision="bf16")
    assert eng_s.params[1]["tied_unembed"].dtype == torch.bfloat16
    batch = {"tokens": torch.from_numpy(_tokens(cfg))}
    ls, cs, _ = eng_s._prefill_fn(batch, CACHE_LEN)
    lj, cj, _ = eng_j._prefill_fn(batch, CACHE_LEN)
    assert torch.equal(ls, lj)
    tok = torch.argmax(lj[:, :cfg.vocab_size], -1)
    pos = torch.full((2,), batch["tokens"].shape[1], dtype=torch.int32)
    ls, _ = eng_s._decode_fn(cs, tok, pos)
    lj, _ = eng_j._decode_fn(cj, tok, pos)
    assert torch.equal(ls, lj)


def _paths(tree, prefix=""):
    """{path: tensor} of a nested dict/list tree (dict order ignored)."""
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items()
                for p, t in _paths(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: t for i, v in enumerate(tree)
                for p, t in _paths(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _assert_bitwise(a, b):
    pa, pb = _paths(a), _paths(b)
    assert sorted(pa) == sorted(pb)
    for k in pa:
        assert pa[k].dtype == pb[k].dtype and torch.equal(pa[k], pb[k]), k


def test_stage_params_from_port_checkpoints(tmp_path):
    world = _world()
    cfg = world[1]
    _, _, plan, sp = _stages(world, 2)
    for k in range(2):
        lifecycle.save_stage(str(tmp_path), k, 5 + k, sp[k])
    got = stage_params_from_checkpoints(cfg, plan, str(tmp_path))
    _assert_bitwise(got, sp)
    assert all(t.device.type == "cpu" for t in tree_leaves(got))
    placed = stage_params_from_checkpoints(
        cfg, plan, str(tmp_path), devices=[torch.device("cpu")] * 2)
    _assert_bitwise(placed, sp)


def test_stage_params_from_reference_checkpoints(tmp_path):
    """``repro.dist.lifecycle`` writes each stage in the shared format; on
    stage trees of the port's structure (groups as a list: the reference's
    own LM trees stack them, ROADMAP C) the port restores every leaf bit
    for bit."""
    world = _world()
    cfg = world[1]
    jplan, jsp, plan, sp = _stages(world, 2)
    for k in range(2):
        JL.save_stage(str(tmp_path), k, 3, _port_layout(jsp[k]))
    got = stage_params_from_checkpoints(cfg, plan, str(tmp_path), step=3)
    _assert_bitwise(got, sp)


def test_engine_argument_errors_are_the_references():
    world = _world()
    cfg, params = world[1], world[3]
    _, _, plan, sp = _stages(world, 2)
    with pytest.raises(ValueError, match="together"):
        Engine(cfg, device="cpu", plan=plan, seed=0)
    with pytest.raises(ValueError, match="together"):
        Engine(cfg, device="cpu", stage_params=sp)
    with pytest.raises(ValueError, match="not both"):
        Engine(cfg, params, device="cpu", plan=plan, stage_params=sp)
    with pytest.raises(ValueError, match="seed="):
        Engine(cfg, device="cpu")


def test_launch_serve_stages_on_cpu(capsys):
    launch_serve.main(["--smoke", "--stages", "2", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--new-tokens",
                       "3", "--paged"])
    out = capsys.readouterr().out
    assert "decoded 6 tokens" in out and "stages=2" in out


def test_unrefreshed_trees_diverge_alike():
    """After §5 recovery has moved stage 0's embedding, the last stage's
    frozen snapshot is stale: staged serving unembeds with the snapshot,
    the joined tree with stage 0's embedding, in both packages alike."""
    world = _world()
    jcfg, cfg = world[:2]
    jplan, jsp, plan, sp = _stages(world, 2)
    delta = 0.05 * np.random.RandomState(2).randn(
        *sp[0]["tok_embed"].shape).astype(np.float32)
    jsp[0] = dict(jsp[0], tok_embed=jsp[0]["tok_embed"] + delta)
    sp[0] = dict(sp[0], tok_embed=sp[0]["tok_embed"] + torch.from_numpy(delta))
    toks = _tokens(cfg)
    jl, _, _ = JS.staged_prefill(jcfg, jplan, jsp,
                                 {"tokens": jnp.asarray(toks)}, CACHE_LEN)
    tl, _, _ = staged.staged_prefill(cfg, plan, sp,
                                     {"tokens": torch.from_numpy(toks)},
                                     CACHE_LEN)
    _close(jl, tl)
    jj, _, _ = JM.prefill(jcfg, JP.join_stage_params(jcfg, jplan, jsp),
                          {"tokens": jnp.asarray(toks)}, CACHE_LEN)
    tj, _, _ = TM.prefill(cfg, TP.join_stage_params(cfg, plan, sp),
                          {"tokens": torch.from_numpy(toks)}, CACHE_LEN)
    _close(jj, tj)
    gap_ref = float(np.abs(np.asarray(jl) - np.asarray(jj)).max())
    gap = float((tl - tj).abs().max())
    assert gap > 1e-2 and abs(gap - gap_ref) <= 1e-4 * gap_ref + 1e-5
    # refreshing the snapshot (what a deployment does) closes the gap
    TP.refresh_tied_unembed(cfg, plan, sp)
    tl, _, _ = staged.staged_prefill(cfg, plan, sp,
                                     {"tokens": torch.from_numpy(toks)},
                                     CACHE_LEN)
    assert torch.equal(tl, tj)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_staged_engine_on_the_card_equals_joined(paged):
    """On the card (the prefill and decode kernels): staged greedy tokens
    equal the joined engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    world = _world()
    cfg, params = world[1], world[3]
    _, _, plan, sp = _stages(world, 2)
    _, reqs = _requests(cfg)
    kw = dict(max_slots=2, decode_block=4, paged=paged, device="cuda")
    got = Engine(cfg, plan=plan, stage_params=sp, **kw).generate(reqs)
    want = Engine(cfg, params, **kw).generate(reqs)
    assert [c.tokens for c in got] == [c.tokens for c in want]
