"""``repro_torch.dist``: placement plans against ``repro.dist.placement``, the
byte model against ``repro.plan.costs``, the stage executor against the
``ParallelSilPhase`` loop (the port's spelling of the reference's
``train/{mlp,lm}_dist_vs_sequential`` oracles), producer/consumer placement
of the Fig.-3 phases, and stage failure -> resume -> replay against the
uninterrupted run (``checkpoint/resume_vs_uninterrupted``).

Placement and byte counts must be equal to the reference's.  Everything
inside the port is held **bitwise**: with every stage on one device the
executor runs the loop's ops in the loop's order, and a checkpoint restores
bits.  The CPU tests place stages on the CPU device (``stage_devices(n,
"cpu")``); the one test that places two stages on two cards is marked
``gpu`` and skips below two visible cards.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import plan as JPlan
from repro.core import partition as JPart
from repro.dist import placement as JP
from repro.models import model as JMod
from repro.train import LMBackend as JLMBackend
from repro.train import TrainSpec as JTrainSpec
from repro_torch.configs import get
from repro_torch.convert import params_from_numpy
from repro_torch.core import partition as TPart
from repro_torch.data.images import emnist_like
from repro_torch.data.lm import lm_batch_at, synthetic_token_stream
from repro_torch.dist import (StageExecutor, join_from_checkpoints,
                              lifecycle, load_stage_params, stage_devices)
from repro_torch.dist import placement as P
from repro_torch.models import mlp as TM
from repro_torch.obs.trace import TID_STAGE0, Tracer
from repro_torch.plan import mlp_costs
from repro_torch.train import (BoundaryMaterializePhase, FrozenPrefixPhase,
                               LMBackend, MLPBackend, SilStagePhase, Trainer,
                               recipes)
from repro_torch.train import phases as TPh
from repro_torch.train.backends import balanced_bounds, make_optimizer_for
from repro_torch.train.spec import StageSpec, TrainSpec
from repro_torch.train.trainer import TrainState
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.verify.compare import Allclose
from _torch_threads import _one_thread  # noqa: F401

CPU2 = stage_devices(2, "cpu")
CPU3 = stage_devices(3, "cpu")


def _bitwise(a, b):
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())


def _records(hist):
    return [dataclasses.astuple(r) for r in hist.records]


# -- placement, against repro.dist.placement ----------------------------------

PACKINGS = [([100, 60, 40, 30, 30, 10], 3), ([10, 20], 2), ([5, 5, 5, 5], 3),
            ([7], 4), ([3, 9, 1, 12, 4], 2), ([8, 8, 1, 1, 8], 2)]


@pytest.mark.parametrize("sizes,n_dev", PACKINGS)
def test_placements_match_reference(sizes, n_dev):
    devs = tuple(range(n_dev))
    n = len(sizes)
    pairs = [(JP.memory_balanced(sizes, devices=devs),
              P.memory_balanced(sizes, devices=devs)),
             (JP.round_robin(n, devices=devs), P.round_robin(n, devices=devs)),
             (JP.resolve("memory", n, devices=devs, stage_bytes=lambda: sizes),
              P.resolve("memory", n, devices=devs,
                        stage_bytes=lambda: sizes)),
             (JP.explicit([k % n_dev for k in range(n)][::-1], devices=devs),
              P.explicit([k % n_dev for k in range(n)][::-1], devices=devs))]
    for j, t in pairs:
        assert (t.assignments, t.loads, t.strategy, t.describe()) == \
            (j.assignments, j.loads, j.strategy, j.describe())
    mem = pairs[0][1]
    assert sum(mem.loads) == sum(sizes)
    rr = [0] * n_dev
    for k, a in enumerate(pairs[1][1].assignments):
        rr[a] += sizes[k]
    assert max(mem.loads) <= max(rr)


def test_resolve_strategies_and_errors():
    assert P.resolve("round_robin", 4, devices=(0, 1)).strategy == \
        "round_robin"
    assert P.resolve([0, 0, 1], 3, devices=(0, 1)).strategy == "explicit"
    plan = P.PlacementPlan((0, 1), ("a", "b"))
    assert P.resolve(plan, 2) is plan
    with pytest.raises(ValueError):
        P.resolve("memory", 2, devices=(0, 1))     # no byte estimates
    with pytest.raises(ValueError):
        P.resolve("warp_speed", 2, devices=(0, 1))
    with pytest.raises(ValueError):
        P.explicit([0, 2], devices=("a", "b"))
    with pytest.raises(ValueError):
        plan.validate(5)


def test_default_devices_are_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch sees none"):
        P.round_robin(2)
    with pytest.raises(RuntimeError, match="torch sees 0"):
        stage_devices(1, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert P.round_robin(3).devices == (torch.device("cuda", 0),
                                        torch.device("cuda", 1))
    assert stage_devices(2, "cuda") == (torch.device("cuda", 0),
                                        torch.device("cuda", 1))
    with pytest.raises(RuntimeError, match="need 3"):
        stage_devices(3, "cuda")
    assert stage_devices(3, "cpu") == (torch.device("cpu"),) * 3


# -- the byte model, against repro.plan.costs ---------------------------------

@pytest.fixture(scope="module")
def lm_world():
    """The smoke qwen2's reference params in both layouts and a pure batch
    function of the step (numpy, bit-identical in both packages)."""
    from repro.configs import get as j_get
    jcfg = j_get("qwen2-1.5b", smoke=True)
    cfg = get("qwen2-1.5b", smoke=True)
    jparams = JMod.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    stream = synthetic_token_stream(20_000, cfg.vocab_size, seed=0)
    return jcfg, cfg, jparams, params, stream


@pytest.mark.parametrize("opt", ["sgd", "sgdm", "adamw", "adafactor",
                                 "unknown"])
def test_estimate_stage_bytes_matches_reference(lm_world, opt):
    jcfg, cfg, jparams, params, _ = lm_world
    jbe = JLMBackend(jcfg, JPart.make_plan(jcfg, 2), None,
                     JTrainSpec(n_stages=2))
    tbe = LMBackend(cfg, TPart.make_plan(cfg, 2), None,
                    TrainSpec(n_stages=2), device="cpu")
    jsp, tsp = jbe.split(jparams), tbe.split(params)
    assert "tied_unembed" in tsp[1]
    for k in range(2):
        assert P.estimate_stage_bytes(tsp[k], opt) == \
            JP.estimate_stage_bytes(jsp[k], opt)
    mlp = TM.init_params(TM.MLPConfig(), torch.Generator().manual_seed(0))
    jmlp = [{k: np.asarray(v) for k, v in p.items()} for p in mlp]
    assert P.estimate_stage_bytes(mlp[:3], opt) == \
        JP.estimate_stage_bytes(jmlp[:3], opt)
    half = [{"w": torch.zeros(4, 4, dtype=torch.bfloat16)}]
    assert P.estimate_stage_bytes(half, opt) == \
        16 * 2 + 16 * 4 * {"sgd": 0, "sgdm": 1, "adafactor": 0}.get(opt, 2)


@pytest.mark.parametrize("n_stages", [2, 3])
def test_mlp_cost_rows_match_reference(n_stages):
    cfg = TM.MLPConfig()
    from repro.models.mlp import MLPConfig as JMLPConfig
    bounds = balanced_bounds(cfg, n_stages)
    for dtype in ("float32", "bfloat16"):
        got = mlp_costs(cfg, compute_dtype=dtype).stage_costs(bounds)
        want = JPlan.mlp_costs(JMLPConfig(), compute_dtype=dtype) \
            .stage_costs(bounds)
        assert [c.row() for c in got] == [c.row() for c in want]


# -- Fig. 5: the executor against the loop, bitwise ---------------------------

def _mlp_world(epochs=(2, 2, 2)):
    data = emnist_like(n_train=1024, n_test=128, seed=0, noise=0.5)
    spec = TrainSpec(batch_size=128, kappa=10.0, n_stages=len(epochs),
                     stages=tuple(StageSpec(epochs=e, lr=0.01)
                                  for e in epochs))
    return TM.MLPConfig(), data, spec


@pytest.mark.parametrize("dist,devices", [
    ("round_robin", CPU3), ("round_robin", CPU2), ("memory", CPU2),
    ([0, 0, 0], CPU2)], ids=["round_robin3", "round_robin2", "memory",
                             "explicit"])
def test_mlp_executor_matches_the_loop_bitwise(dist, devices):
    cfg, data, spec = _mlp_world()
    out = {}
    for d in (None, dist):
        out[str(d)] = recipes.run_mlp_fig5(
            cfg, data, spec, torch.Generator().manual_seed(2), 3, dist=d,
            dist_devices=devices, device="cpu")
    (p0, h0), (p1, h1) = out["None"], out[str(dist)]
    _bitwise(p0, p1)
    assert _records(h0) == _records(h1)
    losses = [r for r in h1.records if r.loss is not None]
    assert len(losses) == 3 * 2 * 8          # stages x epochs x batches
    assert h1.records[-1].acc is not None and h1.records[-1].stage == -1


def _lm_spec(steps=3, accum=1, precision=None):
    return TrainSpec(n_stages=2, kappa=1.0, precision=precision, stages=tuple(
        StageSpec(steps=steps, lr=1e-3, optimizer="adamw", accum=accum)
        for _ in range(2)))


@pytest.mark.parametrize("dist,accum", [("round_robin", 1), ("memory", 1),
                                        ("round_robin", 2)])
def test_lm_executor_matches_the_loop_bitwise(lm_world, dist, accum):
    _, cfg, _, params, stream = lm_world
    spec = _lm_spec(accum=accum)
    out = {}
    for d in (None, dist):
        out[d] = recipes.run_lm_parallel(
            cfg, 2, params, lambda i: lm_batch_at(stream, 2, 32, i), spec,
            torch.Generator().manual_seed(1), dist=d, dist_devices=CPU2,
            device="cpu")
    (p0, h0), (p1, h1) = out[None], out[dist]
    _bitwise(p0, p1)
    assert _records(h0) == _records(h1)
    assert [(r.step, r.stage) for r in h1.records] == \
        [(i, k) for i in range(3) for k in range(2)]
    # the caller's params are not touched
    _bitwise(params, params_from_numpy(
        cfg, jax.tree.map(np.asarray, lm_world[2]), device="cpu"))


def test_memory_placement_reads_the_live_stage_trees(lm_world):
    _, cfg, _, params, _ = lm_world
    be = LMBackend(cfg, TPart.make_plan(cfg, 2), None, _lm_spec(),
                   device="cpu")
    trainer = Trainer(be, _lm_spec())
    state = TrainState(stage_params=be.split(params))
    plan = TPh._resolve_placement("memory", ("a", "b"), trainer, state)
    want = [P.estimate_stage_bytes(state.stage_params[k], "adamw")
            for k in range(2)]
    assert sorted(plan.loads) == sorted(want) and plan.strategy == "memory"
    assert plan.device_for(int(np.argmax(want))) == "a"


# -- producer / consumer placement of the Fig.-3 phases -----------------------

def test_frozen_prefix_producer_consumer_matches_unplaced(lm_world):
    _, cfg, _, params, stream = lm_world
    spec = _lm_spec(steps=2)

    def run(plan):
        be = LMBackend(cfg, TPart.make_plan(cfg, 2),
                       lambda i: lm_batch_at(stream, 2, 32, i), spec,
                       device="cpu")
        phases = [SilStagePhase(stage=0, steps=2),
                  FrozenPrefixPhase(stage=1, source="live", steps=2,
                                    plan=plan, devices=CPU2)]
        return Trainer(be, spec).run(phases, params=params,
                                     gen=torch.Generator().manual_seed(1))
    p0, h0 = run(None)
    for plan in ("round_robin", P.round_robin(2, CPU2), [1, 0]):
        p1, h1 = run(plan)
        _bitwise(p0, p1)
        assert _records(h0) == _records(h1)


def test_materialize_and_frozen_prefix_placed_match_unplaced():
    cfg, data, _ = _mlp_world()
    spec = TrainSpec(batch_size=128, kappa=10.0, n_stages=2, shuffle=True,
                     stages=(StageSpec(epochs=1, lr=0.01),) * 2)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))

    def run(plan):
        be = MLPBackend(cfg, data, spec, device="cpu")
        phases = [SilStagePhase(stage=0),
                  BoundaryMaterializePhase(upto=1, plan=plan, devices=CPU2),
                  FrozenPrefixPhase(stage=1, plan=plan, devices=CPU2)]
        return Trainer(be, spec).run(phases, params=params,
                                     gen=torch.Generator().manual_seed(3))
    p0, h0 = run(None)
    p1, h1 = run("round_robin")
    _bitwise(p0, p1)
    assert _records(h0) == _records(h1)


# -- stage failure -> resume -> replay == uninterrupted, bitwise --------------

def _executor_world(kind, lm_world, root, ckpt_every, n_ticks):
    """(backend, spec, params, make_ex) for a 3-stage MLP or the 2-stage
    smoke LM, every stage on the CPU."""
    if kind == "mlp":
        cfg, data, spec = _mlp_world(epochs=(n_ticks,) * 3)
        be = MLPBackend(cfg, data, spec, bounds=balanced_bounds(cfg, 3),
                        device="cpu")
        params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    else:
        _, cfg, _, params, stream = lm_world
        spec = _lm_spec(steps=n_ticks)
        be = LMBackend(cfg, TPart.make_plan(cfg, 2),
                       lambda i: lm_batch_at(stream, 2, 32, i), spec,
                       device="cpu")
    sils = be.make_sils(torch.Generator().manual_seed(1), spec.kappa)
    hps = [spec.stage(k) for k in range(be.n_stages)]
    pl = P.round_robin(be.n_stages, stage_devices(be.n_stages, "cpu"))

    def make_ex(**kw):
        opts = [make_optimizer_for(hp, spec) for hp in hps]
        return StageExecutor(be, pl, be.split(params), sils, opts, hps,
                             ckpt_dir=root, ckpt_every=ckpt_every, **kw)
    return be, spec, params, make_ex


def _loss_map(hist):
    return {(r.stage, r.step): r.loss for r in hist.records
            if r.loss is not None}


@pytest.mark.parametrize("kind", ["mlp", "lm"])
def test_stage_failure_resume_replay_matches_uninterrupted(tmp_path,
                                                           lm_world, kind):
    root = str(tmp_path / "stages")
    be, spec, params, make_ex = _executor_world(kind, lm_world, root, 1, 3)
    n = be.n_stages
    ref_ex = make_ex()
    ref_ex.run(3)
    ref = ref_ex.gather()
    assert ref_ex.ticks == [3] * n
    assert lifecycle.stage_ticks(root, n) == [3] * n
    # stage 1 dies after tick 1 and resumes from ITS OWN checkpoint; the
    # other stages never notice
    ex = make_ex()
    ex.run(1)
    ex.params[1] = tree_map(torch.zeros_like, ex.params[1])
    ex.opt_states[1] = tree_map(torch.zeros_like, ex.opt_states[1])
    assert ex.resume_stage(1, step=1) == 1
    ex.run(3, stages=[1])
    ex.run(3, stages=[k for k in range(n) if k != 1])
    got = ex.gather()
    for k in range(n):
        _bitwise(ref[k], got[k])
        _bitwise(ref_ex.opt_states[k], ex.opt_states[k])
    # replayed ticks re-run the math but log nothing twice
    assert ex._metrics_upto == ref_ex._metrics_upto == [3] * n
    st_ref, st = TrainState(stage_params=None), TrainState(stage_params=None)
    ref_ex.finalize(Trainer(be, spec), st_ref)
    ex.finalize(Trainer(be, spec), st)
    per_tick = 8 if kind == "mlp" else 1         # steps a tick
    assert _loss_map(st.history) == _loss_map(st_ref.history)
    assert len(_loss_map(st.history)) == n * 3 * per_tick
    assert [r.acc for r in st.history.records if r.acc is not None] == \
        [r.acc for r in st_ref.history.records if r.acc is not None]
    assert st.cum_macs == st_ref.cum_macs
    # the joined network from the checkpoints is the live join
    like = be.split(params)
    _bitwise(join_from_checkpoints(root, like, be.join), be.join(ref))
    placed = load_stage_params(root, like, devices=[torch.device("cpu")] * n)
    for k in range(n):
        _bitwise(placed[k], ref[k])


def test_resume_falls_back_over_a_torn_latest_tick(tmp_path, lm_world):
    import os
    root = str(tmp_path / "stages")
    _, _, _, make_ex = _executor_world("lm", lm_world, root, 1, 2)
    ref_ex = make_ex().run(2)
    ex = make_ex().run(2)
    # the crash tore stage 1's tick-2 save: its manifest never landed
    os.remove(os.path.join(lifecycle.stage_dir(root, 1),
                           "ckpt_00000002.json"))
    assert ex.resume_stage(1) == 1
    ex.run(2, stages=[1])
    _bitwise(ref_ex.gather(), ex.gather())


def test_parallel_phase_checkpoints_independent_ticks(tmp_path):
    root = str(tmp_path / "mlp_stages")
    cfg, data, spec = _mlp_world(epochs=(1, 2, 3))
    recipes.run_mlp_fig5(cfg, data, spec, torch.Generator().manual_seed(0),
                         3, dist="round_robin", dist_devices=CPU3,
                         ckpt_dir=root, ckpt_every=1, device="cpu")
    assert lifecycle.stage_ticks(root, 3) == [1, 2, 3]
    from repro_torch.checkpoint import available_steps
    assert [available_steps(lifecycle.stage_dir(root, k))
            for k in range(3)] == [[1], [1, 2], [1, 2, 3]]


def test_executor_hook_spans_and_counters(lm_world):
    _, _, _, make_ex = _executor_world("lm", lm_world, None, 0, 2)
    tracer = Tracer()
    ex = make_ex(tracer=tracer)
    seen = []

    def hook(k, i, batch):
        seen.append((k, i))
        return batch
    ex.batch_hook = hook
    ex.run(2)
    assert seen == [(0, 0), (1, 0), (0, 1), (1, 1)]
    assert [(s.name, s.tid) for s in tracer.spans] == [
        ("tick 0", TID_STAGE0), ("tick 0", TID_STAGE0 + 1),
        ("tick 1", TID_STAGE0), ("tick 1", TID_STAGE0 + 1)]
    ctr = ex.metrics.get("executor_ticks_total")
    assert ctr.value(stage=0) == ctr.value(stage=1) == 2
    with pytest.raises(ValueError, match="without ckpt_dir"):
        ex.checkpoint()
    # a tick already run, or past a stage's duration, launches nothing
    ex.tick(0)
    ex.tick(5)
    assert ex.ticks == [2, 2] and len(ex._pending) == 4


# -- two stages on two cards ---------------------------------------------------

@pytest.mark.gpu
def test_two_cards_match_one_card(lm_world):
    """Stage 1 on the second card against both stages on the first, at the
    fp32 tier (each card runs the same kernels; only placement differs)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    _, cfg, _, params, stream = lm_world
    spec = _lm_spec(precision="fp32")
    out = []
    for devs in (stage_devices(1, "cuda"), stage_devices(2, "cuda")):
        out.append(recipes.run_lm_parallel(
            cfg, 2, tree_map(lambda t: t.cuda(), params),
            lambda i: lm_batch_at(stream, 2, 32, i), spec,
            torch.Generator().manual_seed(1), dist="round_robin",
            dist_devices=devs, device="cuda"))
    (p1, h1), (p2, h2) = out
    fp32 = Allclose()
    assert fp32.compare(h1.column("loss"), h2.column("loss")).ok
    assert fp32.compare([t.cpu() for t in tree_leaves(p1)],
                        [t.cpu() for t in tree_leaves(p2)]).ok
