"""The LM's materialized boundary (the paper's Fig. 3 at transformer scale)
in the port against the reference package, on qwen2-1.5b's smoke config (2
layers, d 256, 4/2 heads of 64, vocab 512) on the CPU.

Both packages run the reference's own composition, ``[SilStagePhase(0),
BoundaryMaterializePhase(upto=1, n_batches=N), FrozenPrefixPhase(1,
source="cache"), RecoveryPhase(0)]``, from the reference's params and SIL
table (handed across with ``repro_torch.convert``) on the same numpy
batches.  A capture phase after the materialization copies the cache (and
the frozen stage 0) out before the trainer closes it.  The losses are held
at the fp32 tier (rtol 1e-5), or at the bf16 tier (2e-2) under a bf16
policy; labels and mask bit for bit; the joined params as
``test_torch_lm_train.py`` holds them after AdamW steps, with 2% of a
leaf's elements (not 1%) allowed off the tier: stage 1 trains on rows that
carry stage 0's drift, and 3 of the 256 elements of its ``wq`` bias leave
the tier, in the live schedule as in this one.  ``test_stage1_channels_
split`` shows why: fed the reference's rows, the port's stage 1 holds the
tier whatever tied copy it freezes; fed the port's rows, the reference's
own stage 1 leaves it at the same bias (input sensitivity, ROADMAP C2).  The cache rows
are held at the same tiers (fp32 with an atol of 1e-5 of their largest
magnitude, as a matmul's summation-order error scales with its output)
against the reference's prefix forward of the port's own frozen stage 0 on
the same batches: the two packages' stage 0 differ after AdamW steps by up
to 2 lr an element (``test_torch_lm_train.py``), which moves the rows by
more than the tier.  Within torch, the stored boundary is the live one:
bitwise.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.core import partition as JP
from repro.core import sil as JS
from repro.models import model as JM
from repro.optim import optimizers as JO
from repro.train import (BoundaryMaterializePhase as JMaterialize,
                         FrozenPrefixPhase as JFrozen, LMBackend as JBackend,
                         RecoveryPhase as JRecovery, SilStagePhase as JSil,
                         StageSpec as JStageSpec, TrainSpec as JTrainSpec,
                         Trainer as JTrainer)
from repro_torch.configs import get
from repro_torch.convert import params_from_numpy, sil_from_numpy
from repro_torch.core import partition as TP
from repro_torch.data import lm as TD
from repro_torch.optim import optimizers as TO
from repro_torch.train import (BoundaryMaterializePhase, FrozenPrefixPhase,
                               LMBackend, RecoveryPhase, SilStagePhase,
                               StageSpec, TrainSpec, Trainer)
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.verify.compare import Allclose

from test_torch_lm_train import (_assert_params, _assert_trees, _flat,
                                 _np_tree, _port_layout)
from _torch_threads import _one_thread  # noqa: F401

B, S, STEPS, RECOVERY, LR = 2, 32, 3, 2, 1e-3
FP32 = Allclose()
BF16 = Allclose(rtol=2e-2, atol=2e-2)


class Capture:
    """A phase that copies the materialized boundary out of the state (the
    trainer closes the cache at the end of the run)."""
    needs_sil = False

    def __init__(self):
        self.out = {}

    def run(self, trainer, state):
        b = state.boundary
        self.out = {"rows": np.array(b["h"].array()),
                    "dtype": getattr(b["h"], "dtype", None),
                    "spilled": b["h"].spilled,
                    "labels": np.asarray(b["labels"]),
                    "mask": None if b["mask"] is None
                    else np.asarray(b["mask"]),
                    "batch_size": b["batch_size"],
                    "stage0": tree_map(lambda t: np.array(t),
                                       state.stage_params[0])}


def _batch_fn(stream, mask):
    def fn(i):
        b = TD.lm_batch_at(stream, B, S, i)
        if mask:
            b["mask"] = (np.random.RandomState(i).rand(B, S) > 0.25
                         ).astype(np.float32)
        return b
    return fn


@pytest.fixture(scope="module")
def world():
    jcfg = j_get("qwen2-1.5b", smoke=True).replace(dtype="float32")
    cfg = get("qwen2-1.5b", smoke=True).replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    sil = np.asarray(JS.make_sil(jax.random.PRNGKey(3), jcfg.d_model,
                                 jcfg.vocab_size, 1.0))
    stream = TD.synthetic_token_stream(8000, jcfg.vocab_size, seed=0)
    return jcfg, cfg, jparams, sil, stream


def _specs(precision):
    def spec(St, Tr):
        return Tr(n_stages=2, kappa=1.0, precision=precision,
                  stages=(St(steps=STEPS, lr=LR, optimizer="adamw"),) * 2,
                  recovery=St(steps=RECOVERY, lr=LR / 10, optimizer="adamw"))
    return spec(JStageSpec, JTrainSpec), spec(StageSpec, TrainSpec)


def _port(world, precision="fp32", mask=False):
    _, cfg, jparams, sil, stream = world
    spec = _specs(precision)[1]
    be = LMBackend(cfg, TP.make_plan(cfg, 2), _batch_fn(stream, mask), spec,
                   device="cpu")
    return (be, spec, params_from_numpy(cfg, _np_tree(jparams), device="cpu"),
            [sil_from_numpy(sil, device="cpu")])


def _run_port(world, phases, precision="fp32", mask=False):
    be, spec, params, sils = _port(world, precision, mask)
    return Trainer(be, spec).run(phases, params=params, sils=sils)


def _fig3(M, F, Sil, R, n_batches, cap, **kw):
    return [Sil(stage=0), M(upto=1, n_batches=n_batches, **kw), cap,
            F(stage=1, source="cache"), R(stage=0)]


def _ref_layout(stage):
    """A port stage tree (numpy leaves) in the reference's layout: the
    groups stacked on a leading axis."""
    out = {k: jax.tree.map(jnp.asarray, v) for k, v in stage.items()
           if k != "groups"}
    out["groups"] = jax.tree.map(lambda *xs: jnp.stack(xs), *stage["groups"])
    return out


def _rows(cap):
    """Captured rows as fp32 (the port stores 16-bit floats as int16 bits)."""
    rows = cap["rows"]
    if rows.dtype == np.int16:
        return torch.from_numpy(rows).view(cap["dtype"]).float().numpy()
    return np.asarray(rows, np.float32)


@pytest.mark.parametrize("precision,n_batches,mask", [
    ("fp32", 3, False), ("fp32", 2, True), ("bf16", 3, False)],
    ids=["fp32-divides", "fp32-modulo-mask", "bf16"])
def test_fig3_matches_reference(world, precision, n_batches, mask):
    """SIL_STEPS = 3: with n_batches 3 the cached phase's steps 3, 4, 5 take
    batches 0, 1, 2; with 2 they take 1, 0, 1 (the reference's modulo)."""
    jcfg, cfg, jparams, sil, stream = world
    jspec, _ = _specs(precision)
    jcap, tcap = Capture(), Capture()
    jbatch = _batch_fn(stream, mask)
    jbe = JBackend(jcfg, JP.make_plan(jcfg, 2),
                   lambda i: {k: jnp.asarray(v) for k, v in
                              jbatch(i).items()}, jspec)
    jjoined, jhist = JTrainer(jbe, jspec).run(
        _fig3(JMaterialize, JFrozen, JSil, JRecovery, n_batches, jcap),
        params=jparams, sils=[jnp.asarray(sil)])
    tjoined, thist = _run_port(world, _fig3(
        BoundaryMaterializePhase, FrozenPrefixPhase, SilStagePhase,
        RecoveryPhase, n_batches, tcap), precision, mask)
    want, got = jcap.out, tcap.out
    assert got["batch_size"] == want["batch_size"] == B
    assert got["rows"].shape == want["rows"].shape == (n_batches * B, S,
                                                       cfg.d_model)
    policy = FP32 if precision == "fp32" else BF16
    fwd = jbe.prefix_forward(1)
    frozen = (_ref_layout(got["stage0"]),)
    ref = np.concatenate([
        np.asarray(fwd(frozen, jbe.batch_fn(STEPS + j)), np.float32)
        for j in range(n_batches)])
    tier = policy if precision != "fp32" else Allclose(
        rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))
    v = tier.compare(ref, _rows(got))
    assert v.ok, v.detail
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["labels"].dtype == np.int64
    if mask:
        np.testing.assert_array_equal(got["mask"], want["mask"])
    else:
        assert got["mask"] is None and want["mask"] is None
    for col in ("phase", "stage", "step"):
        assert thist.column(col) == jhist.column(col)
    assert thist.column("phase") == (["left"] * STEPS + ["right"] * STEPS
                                     + ["recovery"] * RECOVERY)
    v = policy.compare(np.asarray(jhist.column("loss"), np.float32),
                       np.asarray(thist.column("loss"), np.float32))
    assert v.ok, v.detail
    if precision == "fp32":
        _assert_params(jjoined, tjoined, LR, STEPS + RECOVERY, frac=2e-2)
    else:
        _assert_trees(policy, jjoined, tjoined)


def _bits(cap):
    return cap["rows"].view(np.uint8)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_spill_equals_ram_bitwise(world, precision, tmp_path):
    """A forced memmap spill holds the same bits as the RAM buffer; bf16
    rows round-trip through the int16 store."""
    caps = {}
    for spill in (None, str(tmp_path)):
        caps[spill] = cap = Capture()
        _run_port(world, [SilStagePhase(stage=0), BoundaryMaterializePhase(
            upto=1, n_batches=2, spill_dir=spill), cap], precision)
    ram, spilled = caps[None].out, caps[str(tmp_path)].out
    assert not ram["spilled"] and spilled["spilled"]
    np.testing.assert_array_equal(_bits(ram), _bits(spilled))
    want = np.int16 if precision == "bf16" else np.float32
    assert ram["rows"].dtype == want
    assert os.listdir(tmp_path) == []       # the run closed the spill


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_cache_equals_live_bitwise(world, precision):
    """With step_idx % n_batches == 0 the cached right phase is the live
    one: the same losses and the same trained stage 1, bit for bit (the
    bf16 rows back from their int16 bits)."""
    cap = Capture()
    cached, hc = _run_port(world, [
        SilStagePhase(stage=0),
        BoundaryMaterializePhase(upto=1, n_batches=STEPS), cap,
        FrozenPrefixPhase(stage=1, source="cache")], precision)
    live, hl = _run_port(world, [SilStagePhase(stage=0),
                                 FrozenPrefixPhase(stage=1, source="live")],
                         precision)
    assert hc.column("loss") == hl.column("loss")
    assert hc.column("step") == hl.column("step")
    _assert_bitwise(cached, live)
    # the rows are the live prefix's output on the right phase's batches
    be, _, _, _ = _port(world, precision)
    sp = be.split(cached)
    h = be.prefix_forward(1)(tuple(sp[:1]), be.batch_fn(STEPS))
    got = torch.from_numpy(cap.out["rows"][:B])
    if precision == "bf16":
        got = got.view(torch.bfloat16)
    assert h.dtype == got.dtype and torch.equal(h, got)


def _assert_bitwise(a, b):
    from repro_torch.tree import tree_leaves
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    assert len(la) == len(lb)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))


def test_placed_phases_equal_unplaced(world):
    """``plan=`` with both stages on the CPU: the prefix runs on the
    producer, the stage trains on the consumer; the same bits."""
    cpu = torch.device("cpu")
    runs = []
    for plan in (None, "round_robin"):
        kw = {} if plan is None else {"plan": plan, "devices": [cpu, cpu]}
        runs.append(_run_port(world, [
            SilStagePhase(stage=0),
            BoundaryMaterializePhase(upto=1, n_batches=2, **kw),
            FrozenPrefixPhase(stage=1, source="cache", **kw)]))
    assert runs[0][1].column("loss") == runs[1][1].column("loss")
    _assert_bitwise(runs[0][0], runs[1][0])


def test_rematerialization_removes_the_old_spill(world, tmp_path):
    seen = []

    class Files:
        needs_sil = False

        def run(self, trainer, state):
            seen.append(sorted(os.listdir(tmp_path)))
    _run_port(world, [
        SilStagePhase(stage=0),
        BoundaryMaterializePhase(upto=1, n_batches=1, spill_dir=str(tmp_path)),
        Files(),
        BoundaryMaterializePhase(upto=1, n_batches=2, spill_dir=str(tmp_path)),
        Files(), FrozenPrefixPhase(stage=1, source="cache")])
    assert len(seen[0]) == len(seen[1]) == 1
    assert seen[0] != seen[1]                # the first file is gone
    assert os.listdir(tmp_path) == []        # and the run closed the second


def test_lm_boundary_errors(world):
    with pytest.raises(ValueError, match="n_batches"):
        _run_port(world, [SilStagePhase(stage=0),
                          BoundaryMaterializePhase(upto=1)])
    with pytest.raises(ValueError, match="materialized boundary"):
        _run_port(world, [FrozenPrefixPhase(stage=1, source="cache")])


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}/{i}")]
    return [prefix]


def test_stage1_on_the_same_rows_holds_the_tier(world):
    """Stage 1's right phase in both packages from the same params (the
    reference's, its tied copy refreshed from the reference's trained stage
    0) on the reference's stored rows: the losses at the fp32 tier and
    stage 1 as ``test_torch_lm_train._assert_params`` holds it, the 1% share
    and every element of the query bias on the tier.  The Fig.-3 run's
    off-tier elements of that bias (ROADMAP C) come from what reaches stage
    1, not from its step."""
    jcfg, cfg, jparams, sil, stream = world
    jspec, tspec = _specs("fp32")
    jbatch = _batch_fn(stream, False)
    jbe = JBackend(jcfg, JP.make_plan(jcfg, 2),
                   lambda i: {k: jnp.asarray(v) for k, v in
                              jbatch(i).items()}, jspec)
    cap = Capture()
    JTrainer(jbe, jspec).run([JSil(stage=0), JMaterialize(
        upto=1, n_batches=STEPS), cap], params=jparams,
        sils=[jnp.asarray(sil)])
    jsp = dict(jbe.split(jparams)[1],
               tied_unembed=jnp.asarray(cap.out["stage0"]["tok_embed"]))
    tbe = LMBackend(cfg, TP.make_plan(cfg, 2), jbatch, tspec, device="cpu")
    tsp = params_from_numpy(cfg.replace(n_layers=1), _np_tree(jsp),
                            device="cpu")
    jopt, topt = JO.adamw(LR), TO.adamw(LR)
    jstep = jbe.build_stage_step(1, jopt, None, jsp)
    tstep = tbe.build_stage_step(1, topt, None)
    jst, tst = jopt.init(jbe.trainable(jsp)), topt.init(tbe.trainable(tsp))
    rows, labels = cap.out["rows"], cap.out["labels"]
    for j in range(STEPS):
        r, lab = rows[j * B:(j + 1) * B], labels[j * B:(j + 1) * B]
        jsp, jst, jl = jstep(jsp, jst, jnp.asarray(r), jnp.asarray(lab))
        tsp, tst, tl = tstep(tsp, tst, torch.from_numpy(r.copy()),
                             torch.from_numpy(lab).long())
        assert FP32.compare(np.float32(jl), tl.numpy()).ok
    _assert_params(jsp, tsp, LR, STEPS)
    want = np.asarray(jsp["groups"]["slot_0"]["attn"]["wq"]["b"][0])
    got = tsp["groups"][0]["slot_0"]["attn"]["wq"]["b"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def fig3_both(world):
    """Fig. 3 + §5 through both packages from the same params and SIL: the
    reference's backend and each package's captured boundary (rows and the
    trained stage 0, whose embedding stage 1 freezes as its tied copy)."""
    jcfg, cfg, jparams, sil, stream = world
    jspec, _ = _specs("fp32")
    jbatch = _batch_fn(stream, False)
    jbe = JBackend(jcfg, JP.make_plan(jcfg, 2),
                   lambda i: {k: jnp.asarray(v) for k, v in
                              jbatch(i).items()}, jspec)
    jcap, tcap = Capture(), Capture()
    JTrainer(jbe, jspec).run(
        _fig3(JMaterialize, JFrozen, JSil, JRecovery, STEPS, jcap),
        params=jparams, sils=[jnp.asarray(sil)])
    _run_port(world, _fig3(BoundaryMaterializePhase, FrozenPrefixPhase,
                           SilStagePhase, RecoveryPhase, STEPS, tcap))
    return jbe, jcap.out, tcap.out


def _right_phase(world, jbe, rows, labels, tied, port):
    """Stage 1's right phase (STEPS AdamW steps on ``rows`` and ``labels``)
    from the
    reference's initial stage 1 with ``tied`` as its frozen unembedding, in
    the port or in the reference; its trained leaves as a flat port-layout
    dict."""
    jcfg, cfg, jparams, sil, stream = world
    _, tspec = _specs("fp32")
    jsp = dict(jbe.split(jparams)[1], tied_unembed=jnp.asarray(tied))
    if port:
        tbe = LMBackend(cfg, TP.make_plan(cfg, 2), _batch_fn(stream, False),
                        tspec, device="cpu")
        tsp = params_from_numpy(cfg.replace(n_layers=1), _np_tree(jsp),
                                device="cpu")
        opt = TO.adamw(LR)
        st, step = opt.init(tbe.trainable(tsp)), tbe.build_stage_step(
            1, opt, None)
        for j in range(STEPS):
            tsp, st, _ = step(tsp, st, torch.from_numpy(
                rows[j * B:(j + 1) * B].copy()), torch.from_numpy(
                labels[j * B:(j + 1) * B]).long())
        out = _flat(tsp)
    else:
        opt = JO.adamw(LR)
        st, step = opt.init(jbe.trainable(jsp)), jbe.build_stage_step(
            1, opt, None, jsp)
        for j in range(STEPS):
            jsp, st, _ = step(jsp, st, jnp.asarray(rows[j * B:(j + 1) * B]),
                              jnp.asarray(labels[j * B:(j + 1) * B]))
        out = _flat(_port_layout(jsp))
    return {k: v for k, v in out.items() if k != "/tied_unembed"}


QUERY_BIAS = "/groups/0/slot_0/attn/wq/b"


def _off_tier(ref, got):
    """{leaf: elements off the fp32 tier} (the key bias left out, as
    ``_assert_params`` leaves it)."""
    return {k: int((np.abs(ref[k] - got[k])
                    > 1e-6 + 1e-5 * np.abs(ref[k])).sum())
            for k in ref if not k.endswith("attn/wk/b")}


@pytest.mark.parametrize("channel", ["reference-rows-port-tied",
                                     "port-rows-reference-tied"])
def test_stage1_channels_split(world, fig3_both, channel):
    """ROADMAP C2, split into its two channels.  What reaches stage 1 from
    stage 0 is its stored rows and its embedding, frozen as the tied
    unembedding; the two packages' differ (rows by ~1e-4 of their largest
    magnitude, the embeddings by up to 2 lr an element).

    * The reference's rows with the port's tied copy: the port's stage 1
      holds the fp32 tier against the reference's own right phase (rows and
      tied copy both the reference's), every query-bias element on it.
    * The port's rows with the reference's tied copy: the port and the
      reference on these same inputs agree at the tier, every query-bias
      element on it; and the reference's own right phase on the port's
      rows leaves the query bias off the tier against its run on its own
      rows, as the port's Fig.-3 run does.  The off-tier elements come
      from the rows' rounding-level difference through AdamW, in either
      package: input sensitivity of the schedule, not a port computation
      that differs."""
    jbe, jout, tout = fig3_both
    labels = jout["labels"]
    np.testing.assert_array_equal(labels, tout["labels"])
    jrows, trows = jout["rows"], _rows(tout)
    jtied = np.asarray(jout["stage0"]["tok_embed"])
    ttied = tout["stage0"]["tok_embed"]
    ref = _right_phase(world, jbe, jrows, labels, jtied, port=False)
    if channel == "reference-rows-port-tied":
        got = _right_phase(world, jbe, jrows, labels, ttied, port=True)
        off = _off_tier(ref, got)
    else:
        got = _right_phase(world, jbe, trows, labels, jtied, port=True)
        same_inputs = _right_phase(world, jbe, trows, labels, jtied,
                                   port=False)
        off = _off_tier(same_inputs, got)
        moved = _off_tier(ref, same_inputs)
        assert moved[QUERY_BIAS] > 0, moved
    assert off[QUERY_BIAS] == 0, off
    for k, n in off.items():
        assert n <= 1e-2 * ref[k].size, f"{k}: {n} of {ref[k].size}"
        assert np.abs(ref[k] - got[k]).max() <= 2 * LR * STEPS, k


@pytest.mark.xfail(strict=True, reason=(
    "input sensitivity (ROADMAP C2, settled by test_stage1_channels_split): "
    "after Fig. 3 + recovery, the 3 of 256 elements of stage 1's query "
    "bias off the fp32 tier have gradients of 1.5e-5 to 1.0e-3 a step and "
    "sqrt(v_hat) of 1.5e-5 to 6.2e-4, far above eps 1e-8: the 2% share of "
    "test_fig3_matches_reference is not a near-zero-gradient allowance; "
    "the reference moves them alike on the port's rows"))
def test_fig3_off_tier_elements_have_near_zero_gradients(world, monkeypatch):
    """Every element of the Fig.-3 joined stage 1 off the fp32 tier is a
    near-zero-gradient element (|g| <= 1e3 eps at every AdamW step of the
    right phase), which would make the 2% share of
    ``test_fig3_matches_reference`` a statement about AdamW alone.  The
    failure message lists each off-tier element with its gradient and
    sqrt(v_hat) a step."""
    jcfg, cfg, jparams, sil, stream = world
    seen = []
    adamw = TO.adamw

    def recording(*a, **kw):
        opt = adamw(*a, **kw)

        def update(grads, state, params):
            names = _paths(params)
            gs = [g.detach().clone() for g in tree_leaves(grads)]
            out = opt.update(grads, state, params)
            if "final_norm" in params:           # stage 1's optimizer
                c = int(state["count"])
                seen.append({n: (g, torch.sqrt(v / (1 - 0.95 ** c)))
                             for n, g, v in zip(names, gs, state["v"])})
            return out
        return TO.Optimizer(opt.init, update, opt.name)
    monkeypatch.setattr(TO, "adamw", recording)
    jspec, _ = _specs("fp32")
    jbatch = _batch_fn(stream, False)
    jbe = JBackend(jcfg, JP.make_plan(jcfg, 2),
                   lambda i: {k: jnp.asarray(v) for k, v in
                              jbatch(i).items()}, jspec)
    jjoined, _ = JTrainer(jbe, jspec).run(
        _fig3(JMaterialize, JFrozen, JSil, JRecovery, STEPS, Capture()),
        params=jparams, sils=[jnp.asarray(sil)])
    tjoined, _ = _run_port(world, _fig3(
        BoundaryMaterializePhase, FrozenPrefixPhase, SilStagePhase,
        RecoveryPhase, STEPS, Capture()))
    assert len(seen) == STEPS
    ref, got = _flat(_port_layout(jjoined)), _flat(tjoined)
    found = []
    for k in ref:
        if not k.startswith("/groups/1/") or k.endswith("attn/wk/b"):
            continue
        local = "/groups/0/" + k[len("/groups/1/"):]
        off = np.abs(ref[k] - got[k]) > 1e-6 + 1e-5 * np.abs(ref[k])
        for i in zip(*np.nonzero(off)):
            steps = [(float(s[local][0][i]), float(s[local][1][i]))
                     for s in seen]
            if any(abs(g) > 1e3 * 1e-8 for g, _ in steps):
                found.append((k, i, steps))
    assert not found, "\n".join(
        f"{k}{list(i)}: " + ", ".join(f"g {g:+.3e} sqrt(v_hat) {v:.3e}"
                                      for g, v in steps)
        for k, i, steps in found)
