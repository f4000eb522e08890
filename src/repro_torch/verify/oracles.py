"""The registered equivalence oracles (counterpart of
``repro/verify/oracles.py``: the same 16 names, contracts, tags, policies
and ``arch_aware`` flags).

Every contract the port asserts — kernel == plain version, concurrent ==
sequential, batched == sequential decode, fused == per-token, bf16 ~= fp32,
resume+replay == uninterrupted, recovered == fault-free, staged == joined —
lives here as one declarative registration, run on ``Context.device``.

Naming: ``group/contract``.  Groups mirror the subsystems: ``kernel``,
``train``, ``serve``, ``precision``, ``checkpoint``, ``resilience``,
``plan``, ``paper``.

The ``kernel/*`` oracles: on the card the optimized side is the
hand-written kernel (``kernels/*/kernel.py``) and the reference side its
plain version (``kernels/*/ref.py``) on the same card tensors.  On the CPU
the optimized side is the plain version the port dispatches to
(``kernels/*/ops.py``), held against the independent formula the
reference's oracle uses: naive attention, the step-by-step scan (here its
closed form: every state as a sum over the inputs, in float64), the direct
SIL-MSE (a one-hot product).  Inputs are drawn on the CPU from a seeded
``torch.Generator`` and placed on the device.

Two shapes differ from the reference's, deliberately:

* the ``kernel/*`` tiny attention shapes use head dim 64 where the
  reference's use 32 (``src/repro/verify/oracles.py:31-37, 69-70``): the
  port's attention kernels take head dims 64, 80, 128 and 256.  The tiny
  preset keeps the causal, window, non-causal, ragged and ring-full
  variants, as the reference's ``full`` shapes do at D 64;
* ``serve/paged_vs_contiguous`` builds its paged engines with 16-token
  blocks (the reference: 4, ``src/repro/verify/oracles.py:244-254``): the
  port's paged decode kernel takes only 16.  Its shared-prefix pair shares
  two full 16-token blocks (a 32-token prefix), admitted in one group, so
  the second admission increfs the first one's blocks (checked on the flat
  paged engine's ``prefix_hits`` where the arch shares prefixes).

``resilience/nan_skip`` runs an epoch through ``backends.epoch_fn`` over
the stage's Fig.-5 step, the executor's MLP tick function (the port has no
``scanned_epoch_fn``).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.tree import tree_map
from repro_torch.verify import scenarios
from repro_torch.verify.compare import AccuracyGap, Allclose, Bitwise, \
    TokensEqual
from repro_torch.verify.oracle import Context, register


def _gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen).to(dev, dtype)


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


# ==========================================================================
# kernels: each CUDA kernel vs its plain version (on the CPU: the plain
# version vs the independent formula)
# ==========================================================================

def _fa_shapes(preset: str):
    tiny = [(1, 64, 4, 2, 64, torch.float32, True, 0),
            (1, 48, 4, 4, 64, torch.bfloat16, True, 16),
            (1, 40, 2, 2, 64, torch.float32, False, 0)]
    full = tiny + [(2, 256, 4, 2, 64, torch.float32, True, 0),
                   (2, 200, 8, 2, 128, torch.bfloat16, True, 64)]
    return full if preset == "full" else tiny


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


@register("kernel/flash_attention",
          "Pallas flash attention == naive attention reference "
          "(fp32 + bf16, causal/window variants)",
          Allclose(), tags=("kernel",))
def _flash_attention(ctx: Context):
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    dev, ref_out, opt_out = ctx.device, {}, {}
    for b, s, h, kv, d, dtype, causal, window in _fa_shapes(ctx.preset):
        g = _gen(0)
        q = _randn(g, (b, s, h, d), dtype, dev)
        k = _randn(g, (b, s, kv, d), dtype, dev)
        v = _randn(g, (b, s, kv, d), dtype, dev)
        name = f"s{s}_{_dtype_name(dtype)}_c{int(causal)}_w{window}"
        if ctx.on_card:
            opt_out[name] = kernel.flash_attention_cuda(
                q, k, v, causal=causal, window=window)
            ref_out[name] = ref.chunked_attention(q, k, v, causal=causal,
                                                  window=window)
        else:
            opt_out[name] = ops.flash_attention(q, k, v, causal=causal,
                                                window=window)
            ref_out[name] = ref.naive_attention(q, k, v, causal=causal,
                                                window=window)
    return ref_out, opt_out


def _decode_direct(q, k, v, pos):
    """Each row's softmax over its valid slots (slot <= pos), by direct
    attention over the slice of the cache they fill."""
    from repro_torch.kernels.flash_attention import ref
    b, lc = q.shape[0], k.shape[1]
    pos_b = torch.as_tensor(pos).reshape(-1).expand(b)
    rows = [ref.naive_attention(q[i:i + 1], k[i:i + 1, :n], v[i:i + 1, :n],
                                causal=False)
            for i, n in enumerate(min(int(p) + 1, lc) for p in pos_b)]
    return torch.cat(rows)


@register("kernel/decode_attention",
          "Pallas decode attention over a KV cache == reference "
          "(scalar / ragged / ring-full position variants)",
          Allclose(), tags=("kernel", "serve"))
def _decode_attention(ctx: Context):
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    dev = ctx.device
    b, lc, h, kv, d = (2, 64, 8, 2, 64) if ctx.preset == "full" \
        else (2, 32, 4, 2, 64)
    g = _gen(0)
    q = _randn(g, (b, 1, h, d), torch.float32, dev)
    k = _randn(g, (b, lc, kv, d), torch.float32, dev)
    v = _randn(g, (b, lc, kv, d), torch.float32, dev)
    ref_out, opt_out = {}, {}
    for name, pos in [("partial", lc // 2),
                      ("ragged", torch.arange(b, dtype=torch.int32,
                                              device=dev) + 3),
                      ("ring_full", 2 * lc)]:
        if ctx.on_card:
            opt_out[name] = kernel.decode_attention_cuda(q, k, v, pos)
            ref_out[name] = ref.decode_attention(q, k, v, pos)
        else:
            opt_out[name] = ops.decode_attention(q, k, v, pos)
            ref_out[name] = _decode_direct(q, k, v, pos)
    return ref_out, opt_out


def _scan_closed_form(u, dt, A, B, C, D):
    """h_t = sum_{s<=t} exp(A (T_t - T_s)) dt_s u_s B_s with T the running
    sum of dt, y_t = C_t . h_t + D u_t: every state written out as a sum
    over the inputs (no recurrence), in float64.  Returns (y, h_last)."""
    u, dt, A, B, C, D = (x.double() for x in (u, dt, A, B, C, D))
    cum = torch.cumsum(dt, 1)                                  # (Ba, S, Di)
    x = (dt * u)[..., None] * B[:, :, None, :]                 # (Ba,S,Di,N)
    ys, h = [], None
    for t in range(u.shape[1]):
        decay = torch.exp(A[None, None]
                          * (cum[:, t:t + 1] - cum[:, :t + 1])[..., None])
        h = (decay * x[:, :t + 1]).sum(1)                      # (Ba, Di, N)
        ys.append((h * C[:, t, None, :]).sum(-1) + D * u[:, t])
    return torch.stack(ys, 1).float(), h.float()


@register("kernel/selective_scan",
          "Pallas chunked selective scan == reference scan (outputs and "
          "final recurrent state)",
          Allclose(rtol=1e-4, atol=1e-4), tags=("kernel",))
def _selective_scan(ctx: Context):
    from repro_torch.kernels.selective_scan import kernel, ops, ref
    dev = ctx.device
    ba, s, di, n = (2, 128, 64, 16) if ctx.preset == "full" \
        else (2, 64, 32, 8)
    g = _gen(0)
    u = _randn(g, (ba, s, di), torch.float32, dev)
    dt = torch.nn.functional.softplus(_randn(g, (ba, s, di), torch.float32,
                                             dev))
    A = -torch.exp(_randn(g, (di, n), torch.float32, dev) * 0.5)
    B = _randn(g, (ba, s, n), torch.float32, dev)
    C = _randn(g, (ba, s, n), torch.float32, dev)
    D = _randn(g, (di,), torch.float32, dev)
    if ctx.on_card:
        y, h = kernel.selective_scan_cuda(u, dt, A, B, C, D)
        ey, eh = ref.selective_scan(u, dt, A, B, C, D)
    else:
        y, h = ops.selective_scan(u, dt, A, B, C, D, chunk=32)
        ey, eh = _scan_closed_form(u, dt, A, B, C, D)
    return {"y": ey, "h": eh}, {"y": y, "h": h}


def _sil_direct(act, sil, lab):
    """loss and dloss/dact with the target as a one-hot product, in
    float64."""
    onehot = torch.nn.functional.one_hot(lab.long(), sil.shape[1]).double()
    diff = act.double() - onehot @ sil.double().t()
    return (diff * diff).mean(), (2.0 / diff.numel()) * diff


@register("kernel/sil_mse",
          "Pallas fused SIL-MSE (loss + activation grad) == reference "
          "(fp32 + bf16 activations, fp32 accumulation)",
          Allclose(rtol=5e-2, atol=1e-4), tags=("kernel", "train"))
def _sil_mse(ctx: Context):
    from repro_torch.kernels.sil_mse import ops, ref
    dev = ctx.device
    t, d, m = (256, 512, 1000) if ctx.preset == "full" else (64, 60, 47)
    ref_out, opt_out = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        g = _gen(0)
        act = _randn(g, (t, d), dtype, dev)
        sil = (torch.rand((d, m), generator=g) * 10).to(dev)
        lab = torch.randint(0, m, (t,), generator=g).to(dev)
        name = _dtype_name(dtype)
        if ctx.on_card:
            from repro_torch.kernels.sil_mse.kernel import sil_mse_cuda
            loss, grad = sil_mse_cuda(act, sil, lab)
            want = (ref.sil_mse(act, sil, lab),
                    ref.sil_mse_grad_act(act, sil, lab))
        else:
            loss, grad = ops.sil_mse_with_grad(act, sil, lab)
            want = _sil_direct(act, sil, lab)
        opt_out[name] = {"loss": loss, "grad": grad.float()}
        ref_out[name] = {"loss": want[0].float(), "grad": want[1].float()}
    return ref_out, opt_out


# ==========================================================================
# train: device-placed concurrent execution vs the sequential phase
# ==========================================================================

@register("train/mlp_dist_vs_sequential",
          "ParallelSilPhase through the dist.StageExecutor (device-placed, "
          "async ticks) == the sequential phase loop, MLP backend",
          Allclose(), tags=("train", "dist"))
def _mlp_dist_vs_sequential(ctx: Context):
    from repro_torch.train import recipes
    n = 3 if ctx.preset == "tiny" else 4
    cfg, data, spec = scenarios.tiny_mlp(
        n_stages=n, epochs=(2,) * n,
        n_train=1024 if ctx.preset == "tiny" else 8192)
    p_seq, _ = recipes.run_mlp_fig5(cfg, data, spec, _gen(0), n_stages=n,
                                    device=ctx.device)
    p_con, _ = recipes.run_mlp_fig5(cfg, data, spec, _gen(0), n_stages=n,
                                    dist="round_robin",
                                    dist_devices=[ctx.device],
                                    device=ctx.device)
    return p_seq, p_con


@register("train/lm_dist_vs_sequential",
          "ParallelSilPhase through the dist.StageExecutor == sequential, "
          "LM backend (params and drained loss curves)",
          Allclose(), tags=("train", "dist"), arch_aware=True)
def _lm_dist_vs_sequential(ctx: Context):
    from repro_torch.train import recipes
    steps = 2 if ctx.preset == "tiny" else 4
    cfg, plan, batch_fn, spec, params = scenarios.tiny_lm(
        ctx.arch, steps=steps, n_stages=2, device=ctx.device)
    p_seq, h_seq = recipes.run_lm_parallel(cfg, plan, params, batch_fn,
                                           spec, _gen(1), device=ctx.device)
    p_con, h_con = recipes.run_lm_parallel(
        cfg, plan, params, batch_fn, spec, _gen(1), dist="round_robin",
        dist_devices=[ctx.device], device=ctx.device)
    return ({"params": p_seq, "loss": h_seq.column("loss")},
            {"params": p_con, "loss": h_con.column("loss")})


# ==========================================================================
# serve: every engine optimization is a pure latency change, never tokens
# ==========================================================================

def _serve_world(ctx: Context):
    cfg = scenarios.serve_cfg(ctx.arch)
    params = scenarios.serve_params(cfg, device=ctx.device)
    lens, news = ((8, 12, 5, 10), (6, 9, 4, 7)) if ctx.preset == "full" \
        else ((8, 5, 10), (5, 4, 6))
    return cfg, params, scenarios.serve_requests(cfg, lens, news)


@register("serve/batched_vs_sequential",
          "Engine continuous batching (slot pool, batched admission) == "
          "one-request-at-a-time prefill+decode, token-identical",
          TokensEqual(), tags=("serve",), arch_aware=True)
def _batched_vs_sequential(ctx: Context):
    from repro_torch.serve import Engine
    cfg, params, reqs = _serve_world(ctx)
    outs = Engine(cfg, params, max_slots=2, decode_block=4,
                  device=ctx.device).generate(reqs)
    ref = [scenarios.greedy_reference(cfg, params, r, device=ctx.device)
           for r in reqs]
    return ref, [c.tokens for c in outs]


@register("serve/fused_chunk_vs_per_token",
          "Fused multi-token decode (lax.scan chunks, sampling folded in) "
          "== per-token decode (decode_block=1), token-identical",
          TokensEqual(), tags=("serve",), arch_aware=True)
def _fused_vs_per_token(ctx: Context):
    from repro_torch.serve import Engine
    cfg, params, reqs = _serve_world(ctx)
    fused = Engine(cfg, params, max_slots=2, decode_block=8,
                   device=ctx.device).generate(reqs)
    per_tok = Engine(cfg, params, max_slots=2, decode_block=1,
                     device=ctx.device).generate(reqs)
    return [c.tokens for c in per_tok], [c.tokens for c in fused]


def _stage_trees(cfg, params, n_stages: int = 2):
    from repro_torch.core import partition
    plan = partition.make_plan(cfg, n_stages)
    return plan, [partition.slice_stage_params(cfg, plan, params, k)
                  for k in range(plan.n_stages)]


@register("serve/staged_vs_joined",
          "PartitionPlan-staged serving (partitions deployed unjoined) == "
          "serving the joined params, token-identical",
          TokensEqual(), tags=("serve", "dist"), arch_aware=True)
def _staged_vs_joined(ctx: Context):
    from repro_torch.serve import Engine
    cfg, params, reqs = _serve_world(ctx)
    joined = Engine(cfg, params, max_slots=2, decode_block=4,
                    device=ctx.device).generate(reqs)
    plan, sp = _stage_trees(cfg, params)
    staged = Engine(cfg, plan=plan, stage_params=sp, max_slots=2,
                    decode_block=4, device=ctx.device).generate(reqs)
    return [c.tokens for c in joined], [c.tokens for c in staged]


# the shared prefix of the paged oracle's pair: two full 16-token blocks
SHARED_PREFIX = 32


@register("serve/paged_vs_contiguous",
          "Block-paged cache pool (block tables, shared-prefix reuse, "
          "garbage block) == the contiguous slot pool, token-identical — "
          "flat and sliding-window attention, joined and staged",
          TokensEqual(), tags=("serve",), arch_aware=True)
def _paged_vs_contiguous(ctx: Context):
    from repro_torch.serve import Engine, Request
    cfg, params, reqs = _serve_world(ctx)
    dev = ctx.device
    # a shared-prefix pair admitted together: the same leading 32 tokens
    # (two full 16-token blocks), so the second admission increfs the
    # first one's blocks
    prefix = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                              size=(SHARED_PREFIX,))
    pair = [Request(tokens=np.concatenate([
        prefix, np.asarray(r.tokens).reshape(-1)]).tolist(), gen=r.gen)
        for r in reqs[:2]]
    reqs = pair + list(reqs)
    want, got = [], []

    def run(paged_engine, contiguous_engine):
        want.extend(c.tokens for c in contiguous_engine.generate(reqs))
        got.extend(c.tokens for c in paged_engine.generate(reqs))
        return paged_engine

    kw = dict(max_slots=2, decode_block=4, device=dev)
    flat = run(Engine(cfg, params, paged=True, block_size=16, **kw),
               Engine(cfg, params, **kw))
    if flat._pool.share_prefixes:    # off for enc-dec and vision configs
        hits = flat._pool.prefix_hits
        assert hits >= SHARED_PREFIX // 16, \
            f"the shared-prefix pair reused {hits} blocks"
    cfgw = scenarios.serve_cfg(ctx.arch, window=8)
    run(Engine(cfgw, params, paged=True, block_size=16, **kw),
        Engine(cfgw, params, **kw))
    plan, sp = _stage_trees(cfg, params)
    run(Engine(cfg, plan=plan, stage_params=sp, paged=True, block_size=16,
               **kw),
        Engine(cfg, plan=plan, stage_params=sp, **kw))
    return want, got


# ==========================================================================
# precision: bf16 compute under the PrecisionPolicy reaches fp32 accuracy
# ==========================================================================

@register("precision/bf16_vs_fp32_train",
          "Baseline MLP training under the bf16 PrecisionPolicy (bf16 "
          "compute, fp32 accumulate) reaches fp32 test accuracy",
          AccuracyGap(budget=0.01, floor=0.85), tags=("precision", "train"))
def _bf16_vs_fp32(ctx: Context):
    from repro_torch.models import mlp as MLP
    from repro_torch.train import BaselinePhase, MLPBackend, Trainer
    n_train, epochs = (18800, 20) if ctx.preset == "full" else (9400, 15)
    accs = {}
    for prec in (None, "bf16"):
        cfg, data, spec = scenarios.tiny_mlp(
            n_stages=2, epochs=(), sizes=(784, 32, 16, 16, 47),
            n_train=n_train, n_test=940, batch_size=470, lr=0.02,
            precision=prec, baseline_epochs=epochs)
        be = MLPBackend(cfg, data, spec, device=ctx.device)
        _, hist = Trainer(be, spec).run(
            [BaselinePhase()],
            params=MLP.init_params(cfg, _gen(0), device=ctx.device))
        accs[prec] = hist.column("acc")[-1]
    return accs[None], accs["bf16"]


# ==========================================================================
# checkpoint: per-stage resume + replay == uninterrupted training
# ==========================================================================

def _mlp_executor_world(ctx: Context, n_stages: int, **kw):
    """(backend, stage params, sils, hps, spec, placement) of a tiny MLP
    Fig. 5 with every stage on ``ctx.device``."""
    from repro_torch.dist import round_robin
    from repro_torch.models import mlp as MLP
    from repro_torch.train import MLPBackend
    from repro_torch.train.backends import balanced_bounds
    cfg, data, spec = scenarios.tiny_mlp(n_stages=n_stages, **kw)
    be = MLPBackend(cfg, data, spec, bounds=balanced_bounds(cfg, n_stages),
                    device=ctx.device)
    params = MLP.init_params(cfg, _gen(0), device=ctx.device)
    sils = be.make_sils(_gen(3), spec.kappa)
    hps = [spec.stage(k) for k in range(n_stages)]
    return (be, be.split(params), sils, hps, spec,
            round_robin(n_stages, [ctx.device]))


@register("checkpoint/resume_vs_uninterrupted",
          "Stage failure -> restore from its own checkpoint -> replay "
          "lost ticks == the uninterrupted run, bitwise",
          Bitwise(), tags=("checkpoint", "dist", "train"))
def _resume_vs_uninterrupted(ctx: Context):
    from repro_torch.dist import StageExecutor
    from repro_torch.train.backends import make_optimizer_for
    n_ticks = 3 if ctx.preset == "tiny" else 6
    be, sp0, sils, hps, spec, pl = _mlp_executor_world(
        ctx, 3, epochs=(n_ticks,) * 3)

    def make_ex(root, ckpt_every):
        opts = [make_optimizer_for(hp, spec) for hp in hps]
        return StageExecutor(be, pl, sp0, sils, opts, hps, shuffle=True,
                             ckpt_dir=root, ckpt_every=ckpt_every)

    # uninterrupted reference
    ref_ex = make_ex(os.path.join(ctx.workdir, "ref"), ckpt_every=0)
    ref_ex.run(n_ticks)
    ref = ref_ex.gather()

    # interrupted run: stage 1 dies after tick 1, resumes from ITS OWN
    # checkpoint, replays — stages 0/2 keep their live state
    root = os.path.join(ctx.workdir, "stages")
    ex = make_ex(root, ckpt_every=1)
    ex.run(1)
    ex.params[1] = tree_map(torch.zeros_like, ex.params[1])
    assert ex.resume_stage(1, step=1) == 1
    ex.run(n_ticks, stages=[1])
    ex.run(n_ticks, stages=[0, 2])
    return ref, ex.gather()


# ==========================================================================
# resilience: faults injected, recovered, and provably invisible
# ==========================================================================

@register("resilience/crash_equivalence",
          "Training under an injected fault schedule (crash, transient, "
          "checkpoint corruption, straggler) self-heals and finishes "
          "bitwise-equal to the fault-free run",
          Bitwise(), tags=("resilience", "dist", "checkpoint", "train"))
def _crash_equivalence(ctx: Context):
    from repro_torch.dist import StageExecutor
    from repro_torch.resilience import (CheckpointCorruption, FakeClock,
                                        FaultSchedule, RetryPolicy,
                                        StageCrash, StragglerDelay,
                                        SupervisedExecutor, TransientError)
    from repro_torch.train.backends import make_optimizer_for
    n_ticks = 4 if ctx.preset == "tiny" else 6
    be, sp0, sils, hps, spec, pl = _mlp_executor_world(
        ctx, 2, epochs=(n_ticks,) * 2, n_train=512, batch_size=128)

    def make_ex(root):
        opts = [make_optimizer_for(hp, spec) for hp in hps]
        return StageExecutor(be, pl, sp0, sils, opts, hps, shuffle=True,
                             ckpt_dir=root)

    ref_ex = make_ex(os.path.join(ctx.workdir, "ref"))
    ref_ex.run(n_ticks)
    ref = ref_ex.gather()

    # one of each recoverable fault kind, at fixed coordinates so the run
    # is replayable without even a seed
    schedule = FaultSchedule(faults=[
        TransientError(stage=0, tick=1, failures=2),
        StageCrash(stage=1, tick=2),
        StragglerDelay(stage=1, tick=3, delay=0.7),
        CheckpointCorruption(stage=0, tick=3, mode="truncate_manifest"),
    ])
    clk = FakeClock()
    ex = make_ex(os.path.join(ctx.workdir, "chaos"))
    sup = SupervisedExecutor(ex, schedule=schedule, clock=clk.monotonic,
                             sleep=clk.sleep, ckpt_every=1,
                             policy=RetryPolicy(max_retries=4), strict=True)
    sup.run(n_ticks)
    assert not sup.unrecovered, sup.report()
    assert len(sup.faults_seen) >= 4, sup.report()
    return ref, ex.gather()


@register("resilience/nan_skip",
          "A NaN/inf-poisoned batch under the step guard == the same run "
          "with the poisoned batch excised, bitwise (skip leaves params "
          "and optimizer state untouched)",
          Bitwise(), tags=("resilience", "train"))
def _nan_skip(ctx: Context):
    from dataclasses import replace

    from repro_torch.models import mlp as MLP
    from repro_torch.optim import read_skipped
    from repro_torch.train import MLPBackend
    from repro_torch.train.backends import (balanced_bounds, epoch_fn,
                                            make_optimizer_for)
    cfg, data, spec = scenarios.tiny_mlp(n_stages=2, epochs=(1, 1),
                                         n_train=512, batch_size=128)
    spec = replace(spec, nan_guard=True)
    be = MLPBackend(cfg, data, spec, bounds=balanced_bounds(cfg, 2),
                    device=ctx.device)
    params = MLP.init_params(cfg, _gen(0), device=ctx.device)
    sils = be.make_sils(_gen(3), spec.kappa)
    p0 = be.split(params)[0]
    opt = make_optimizer_for(spec.stage(0), spec)
    assert opt.name.startswith("guard("), opt.name
    # the executor's MLP tick: one epoch of the stage's Fig.-5 step
    tick = epoch_fn(be.build_parallel_step(0, opt, sils, accum=1))
    batches = be.epoch_arrays(0, shuffle=False)
    poison_idx = batches[0].shape[0] // 2
    x = batches[0].clone()
    x[poison_idx, 0, 0] = float("inf")       # one bad batch mid-epoch
    poisoned = (x,) + tuple(batches[1:])
    excised = tuple(torch.cat([b[:poison_idx], b[poison_idx + 1:]])
                    for b in batches)

    # the optimizer updates in place: each run trains its own copy
    p_ref, o_ref, _ = tick(_clone(p0), opt.init(be.trainable(_clone(p0))),
                           excised)
    p_got, o_got, _ = tick(_clone(p0), opt.init(be.trainable(_clone(p0))),
                           poisoned)
    assert int(read_skipped(o_got)) == 1, "guard did not skip the bad batch"
    assert int(read_skipped(o_ref)) == 0
    return p_ref, p_got


# ==========================================================================
# plan: the auto-partitioner's searched cut is as trainable as the hand cut
# ==========================================================================

def _plan_policy(ctx: Context):
    # budgets mirror the paper gate's presets: both runs sit on the same
    # (reduced or full) schedule, so the cut is the only variable
    return AccuracyGap(budget=0.05 if ctx.preset == "tiny" else 0.02,
                       floor=0.6)


@register("plan/auto_vs_hand",
          "Fig.-3 SIL training at the repro.plan searched cut matches the "
          "paper's hand-picked cut within the accuracy budget; on an "
          "equal-width MLP every balanced cut ties and the searcher "
          "reproduces the divmod hand bounds exactly",
          _plan_policy, tags=("plan", "train"))
def _plan_auto_vs_hand(ctx: Context):
    from repro_torch import plan as plan_lib
    from repro_torch.configs import paper_mlp
    from repro_torch.data.images import emnist_like
    from repro_torch.models.mlp import MLPConfig
    from repro_torch.train import recipes
    from repro_torch.train.backends import (mlp_default_bounds,
                                            mlp_test_accuracy)

    # exact-tie determinism: an equal-width stack makes every balanced cut
    # tie at the optimal bottleneck, and the tie-break must reproduce the
    # hand (divmod) bounds bit-for-bit — auto is a drop-in there
    ucfg = MLPConfig(sizes=(32,) * 7, cut=3)
    for k in (1, 2, 3):
        auto_b = plan_lib.auto_mlp_bounds(ucfg, k)
        hand_b = mlp_default_bounds(ucfg, k)
        assert auto_b == hand_b, \
            f"tie-break drifted at K={k}: {auto_b} != {hand_b}"

    # accuracy parity on the paper's (non-uniform) MLP, where the searcher
    # picks its own cut: same data, spec, and generator seed for both runs
    cfg = paper_mlp.CONFIG
    n_right, n_recovery = (80, 20) if ctx.preset == "tiny" else (160, 10)
    data = emnist_like(n_train=28200, n_test=2820, seed=0, noise=0.5)
    spec = recipes.paper_spec(n_right=n_right, n_baseline=0,
                              n_recovery=n_recovery)
    p_hand, _ = recipes.run_mlp_fig3(cfg, data, spec, _gen(1),
                                     device=ctx.device)
    p_auto, _ = recipes.run_mlp_fig3(
        cfg, data, spec, _gen(1), bounds=plan_lib.auto_mlp_bounds(cfg, 2),
        device=ctx.device)
    tx = torch.as_tensor(data[2]).to(ctx.device, torch.float32)
    ty = torch.as_tensor(data[3]).to(ctx.device, torch.int64)
    return (mlp_test_accuracy(cfg, p_hand, tx, ty),
            mlp_test_accuracy(cfg, p_auto, tx, ty))


# ==========================================================================
# paper: the reproduction gate (EMNIST 6-layer / 2-stage SIL experiment)
# ==========================================================================

def _paper_policy(ctx: Context):
    from repro_torch.verify import paper
    return paper.gap_policy(ctx.preset)


@register("paper/emnist_parity",
          "PNN (paper Fig. 3 schedule, 2 stages, SIL targets) matches "
          "conventional training accuracy on the EMNIST-like task within "
          "the paper's reported budget",
          _paper_policy,
          tags=("paper", "train"))
def _emnist_parity(ctx: Context):
    from repro_torch.verify import paper
    res = paper.run_paper_parity(ctx.preset, device=ctx.device)
    return res["baseline_acc"], res["pnn_acc"]
