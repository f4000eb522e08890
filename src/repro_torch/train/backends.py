"""Training backends for the phase API (counterpart of
``repro/train/backends.py``): the paper's fully-connected EMNIST experiment
(``MLPBackend``) and the transformer over a ``PartitionPlan``
(``LMBackend``).

``MLPBackend`` puts the dataset on the device once.  Each epoch is one
device-side gather of the (shuffled) batches, and the epoch loop
(``epoch_fn``, which stands in for the reference's jitted ``lax.scan``)
writes each step's loss into a preallocated device tensor: the host never
waits on a loss inside the step loop, and reads the losses once per phase.

A step is ``step(params, opt_state, x, y) -> (params, opt_state, loss)``.
Gradients come from ``torch.autograd.grad`` over detached, grad-requiring
aliases of the parameter tensors, so parameter trees never carry autograd
state between steps, and frozen stages (recovery) are plain tensors that
get no gradient at all.  The optimizer updates the backend's own copies of
the parameters in place (``split`` copies, as the reference's
``_copy_tree`` protects callers from buffer donation).

``LMBackend`` takes its batches from a caller's ``batch_fn(step)`` (numpy
or tensors, put on the device as int64), runs each step as a plain Python
function over autograd (loss, ``value_and_accum_grads``, the optimizer's
in-place update) and returns the loss as a device scalar; the trainer reads
a phase's losses once, at its end.  The last stage's frozen
``tied_unembed`` snapshot is carried outside the differentiated tree: it
gets no gradient and no optimizer state.  Every attention layer of a step
runs the CUDA prefill and backward kernels on the card (the scan, which has
no backward yet, refuses to train on the card).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import precision as precision_lib
from repro_torch.core import losses, partition, sil as sil_lib
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import mlp as MLP
from repro_torch.models import model as M
from repro_torch.optim import make_optimizer, mixed_precision, step_guard
from repro_torch.train.spec import StageSpec, TrainSpec
from repro_torch.tree import tree_leaves, tree_map


def resolve_policy(hp=None, spec=None):
    """The explicitly requested PrecisionPolicy for a stage (StageSpec
    override first, then the TrainSpec-wide default), or None -- None keeps
    the paper's fp32 numerics."""
    p = getattr(hp, "precision", None) if hp is not None else None
    if p is None and spec is not None:
        p = getattr(spec, "precision", None)
    return None if p is None else precision_lib.get_policy(p)


def make_optimizer_for(hp: StageSpec, spec: Optional[TrainSpec] = None):
    kw = {"momentum": hp.momentum} if hp.optimizer == "sgdm" else {}
    opt = make_optimizer(hp.optimizer, hp.lr, **kw)
    pol = resolve_policy(hp, spec)
    if pol is not None and pol.wraps_optimizer:
        opt = mixed_precision(opt, loss_scale=pol.loss_scale,
                              dynamic=pol.dynamic_scale,
                              growth_interval=pol.scale_growth_interval)
    else:
        # the NaN/inf step guard, for the unscaled precisions only
        guard = hp.nan_guard
        if guard is None:
            guard = bool(getattr(spec, "nan_guard", False))
        if guard:
            opt = step_guard(opt)
    return opt


def _fold(a, accum: int):
    """``a`` (a tensor, a dict of them, or None) with its batch dim split
    into ``accum`` microbatches on a new leading dim."""
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: _fold(v, accum) for k, v in a.items()}
    if isinstance(a, (tuple, list)):
        return type(a)(_fold(v, accum) for v in a)
    if a.shape[0] % accum:
        raise ValueError(f"batch dim {a.shape[0]} not divisible by "
                         f"accum={accum}")
    return a.reshape((accum, a.shape[0] // accum) + a.shape[1:])


def _micro(a, i: int):
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: _micro(v, i) for k, v in a.items()}
    if isinstance(a, (tuple, list)):
        return type(a)(_micro(v, i) for v in a)
    return a[i]


def _grads(loss, leaves) -> list:
    """d loss / d each leaf; zeros for a leaf the loss does not reach (a
    Fig.-5 encoder-decoder stage after the first runs without its cross
    blocks), as JAX's gradient of an unused argument is."""
    return list(torch.autograd.grad(loss, leaves, materialize_grads=True))


def value_and_accum_grads(loss_fn, params, args, accum: int = 1):
    """(mean loss, grads) of ``loss_fn(params, *args)``, the grads a flat
    list in ``tree_leaves(params)`` order.  With ``accum > 1`` the batch
    (each arg: a tensor, a dict or tuple of tensors, or None) is split into
    ``accum`` microbatches and the grads accumulate in fp32 whatever the
    compute dtype; ``accum=1`` is the single-shot path."""
    gp = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = list(tree_leaves(gp))
    with torch.enable_grad():
        if accum <= 1:
            loss = loss_fn(gp, *args)
            return loss.detach(), _grads(loss, leaves)
        mbs = [_fold(a, accum) for a in args]
        gsum, mb_losses = None, []
        for i in range(accum):
            loss = loss_fn(gp, *[_micro(a, i) for a in mbs])
            g = [x.float() for x in _grads(loss, leaves)]
            gsum = g if gsum is None else [s + x for s, x in zip(gsum, g)]
            mb_losses.append(loss.detach())
    return torch.stack(mb_losses).mean(), [s / accum for s in gsum]


def epoch_fn(step: Callable):
    """One epoch of ``step`` over stacked (nb, bs, ...) batches, returning
    the per-step losses as a device tensor (no host sync); the counterpart
    of the reference's jitted ``scanned_epoch_fn``."""

    def epoch(params, opt_state, batches):
        n = batches[0].shape[0]
        out = torch.empty((n,), dtype=torch.float32,
                          device=batches[0].device)
        for i in range(n):
            params, opt_state, loss = step(params, opt_state,
                                           *[b[i] for b in batches])
            out[i] = loss
        return params, opt_state, out

    return epoch


def balanced_bounds(cfg: MLP.MLPConfig, n_stages: int, *,
                    costs=None) -> Tuple[Tuple[int, int], ...]:
    """Balanced contiguous layer split (the legacy fig-5 scheme).

    ``costs`` routes through the ``repro_torch.plan`` bottleneck searcher
    instead: a ``plan.ModelCosts`` table (head/tail-overhead-aware), a
    per-layer scalar cost sequence, or ``"auto"`` to build the MLP cost
    table from the config (paper batch size, sgdm slots)."""
    if costs is not None:
        from repro_torch import plan as plan_lib
        if isinstance(costs, str):
            if costs != "auto":
                raise ValueError(f"bad costs={costs!r}; expected 'auto', a "
                                 "ModelCosts table, or a scalar sequence")
            return plan_lib.auto_mlp_bounds(cfg, n_stages)
        if isinstance(costs, plan_lib.ModelCosts):
            return plan_lib.solve(costs, n_stages)
        from repro_torch.plan.search import searched_bounds_for_sequence
        return searched_bounds_for_sequence(costs, n_stages)
    base, rem = divmod(cfg.n_layers, n_stages)
    bounds, s = [], 0
    for k in range(n_stages):
        e = s + base + (1 if k < rem else 0)
        bounds.append((s, e))
        s = e
    return tuple(bounds)


def mlp_default_bounds(cfg: MLP.MLPConfig, n_stages: int
                       ) -> Tuple[Tuple[int, int], ...]:
    """2 stages -> the paper's cut; otherwise a balanced contiguous split."""
    if n_stages == 2:
        return ((0, cfg.cut), (cfg.cut, cfg.n_layers))
    return balanced_bounds(cfg, n_stages)


def _copy_tree(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def _class_major(sil: torch.Tensor) -> torch.Tensor:
    """A (d, M) SIL table as the (d, M) view of contiguous (M, d) storage
    (no copy if it is one already)."""
    return sil.detach().t().contiguous().t()


class MLPBackend:
    kind = "mlp"

    def __init__(self, cfg: MLP.MLPConfig, data, spec: TrainSpec,
                 bounds: Optional[Sequence[Tuple[int, int]]] = None,
                 device="cuda"):
        """data: (train_x, train_y, test_x, test_y) numpy arrays, put on
        ``device`` once (``"cuda"`` raises where torch sees no card)."""
        self.cfg = cfg
        self.spec = spec
        self.device = resolve_device(device)
        # spec-wide policy; None = the paper's fp32.  Per-stage
        # StageSpec.precision overrides only reach the optimizer
        self.policy = resolve_policy(None, spec)
        (self.policy or precision_lib.get_policy("fp32")
         ).apply_backend_flags()

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a)).to(self.device, dtype)
        tx, ty, vx, vy = data
        self._tx, self._ty = put(tx, torch.float32), put(ty, torch.int64)
        self._vx, self._vy = put(vx, torch.float32), put(vy, torch.int64)
        self.bounds = tuple(bounds) if bounds is not None \
            else mlp_default_bounds(cfg, spec.n_stages)
        self.n_stages = len(self.bounds)
        bs = spec.batch_size
        self.n_train = len(tx)
        self.batches_per_epoch = self.n_train // bs
        self.samples_per_epoch = self.batches_per_epoch * bs
        self.dropped_per_epoch = self.n_train - self.samples_per_epoch

    # -- params ------------------------------------------------------------

    def split(self, params) -> List[list]:
        return [_copy_tree(list(params[b0:b1])) for b0, b1 in self.bounds]

    def join(self, stage_params) -> list:
        return sum(stage_params, [])

    @staticmethod
    def trainable(stage_params: list) -> list:
        """Every param of an MLP stage trains."""
        return stage_params

    def boundary_width(self, k: int) -> int:
        return self.cfg.sizes[self.bounds[k][1]]

    def make_sils(self, gen: Optional[torch.Generator], kappa: float
                  ) -> list:
        """One SIL per interior cut, drawn in order from ``gen`` and put on
        the backend's device."""
        return sil_lib.make_stage_sils(
            gen, [self.boundary_width(k) for k in range(self.n_stages - 1)],
            self.cfg.n_classes, kappa, device=self.device)

    # -- macs --------------------------------------------------------------

    def stage_macs(self, k: int) -> int:
        b0, b1 = self.bounds[k]
        return MLP.macs(self.cfg, b0, b1)

    def full_macs(self) -> int:
        return MLP.macs(self.cfg)

    # -- data --------------------------------------------------------------

    def _gather(self, x, y, n, seed, shuffle):
        """(nb, bs, ...) batches of the first n samples of ``x``, ``y`` (on
        the device) in the reference's order: ``RandomState(seed)``'s
        shuffle, gathered on the device with one index tensor (uploaded
        from pinned memory, so the host does not wait for the card)."""
        bs = self.spec.batch_size
        if shuffle:
            order = np.arange(len(x))
            np.random.RandomState(seed).shuffle(order)
            idx = torch.from_numpy(order[:n])
            if x.device.type == "cuda":   # upload without waiting on the card
                idx = idx.pin_memory()
            idx = idx.to(x.device, non_blocking=True)
            x, y = x.index_select(0, idx), y.index_select(0, idx)
        return (x[:n].reshape(n // bs, bs, -1), y[:n].reshape(n // bs, bs))

    def epoch_arrays(self, seed: int, shuffle: bool):
        """Stacked (nb, bs, ...) device tensors for one epoch of the
        training set."""
        return self._gather(self._tx, self._ty, self.samples_per_epoch,
                            seed, shuffle)

    def array_epoch_arrays(self, x, y, seed: int, shuffle: bool):
        """The same batching over caller-supplied device tensors (the
        materialized boundary)."""
        bs = self.spec.batch_size
        return self._gather(x, y, (len(x) // bs) * bs, seed, shuffle)

    # -- step builders -----------------------------------------------------

    def _compute_dtype(self):
        return None if self.policy is None else self.policy.compute_torch

    def _range_forward(self, p, x, b0, b1):
        return MLP.forward_range(self.cfg, p, x, b0, b1,
                                 compute_dtype=self._compute_dtype())

    def _cast_in(self, x):
        """Inputs enter the network in the compute dtype."""
        return x if self.policy is None else self.policy.cast_compute(x)

    def _finish_step(self, opt, loss_fn, p, st, args, accum: int):
        """Shared tail of every step: grads (accumulated over ``accum``
        microbatches in fp32) into the optimizer; the loss returned is
        unscaled."""
        scale = precision_lib.read_loss_scale(st)
        fn = loss_fn if scale == 1.0 else \
            (lambda p_, *a: loss_fn(p_, *a) * scale)
        loss, grads = value_and_accum_grads(fn, p, args, accum)
        p, st = opt.update(grads, st, p)
        return p, st, loss if scale == 1.0 else loss / scale

    def build_sil_step(self, k: int, opt, sil, accum: int = 1):
        """Stage k against its SIL table.  The frozen (d, M) table is held
        once, here, as a contiguous (M, d) transpose, so the kernel reads
        each row's target with neighbouring threads on neighbouring
        addresses; the loss sees it as a (d, M) view."""
        b0, b1 = self.bounds[k]
        sil_cols = _class_major(sil)

        def step(p, st, x, y):
            def loss_fn(p_, xb, yb):
                h = self._range_forward(p_, xb, b0, b1)
                return losses.sil_stage_loss(h, sil_cols, yb)
            return self._finish_step(opt, loss_fn, p, st,
                                     (self._cast_in(x), y), accum)
        return step

    def build_ce_step(self, k: int, opt, accum: int = 1):
        """CE through stage k alone (its input is the stage boundary)."""
        b0, b1 = self.bounds[k]

        def step(p, st, h, y):
            def loss_fn(p_, hb, yb):
                return losses.cross_entropy(
                    self._range_forward(p_, hb, b0, b1), yb)
            return self._finish_step(opt, loss_fn, p, st,
                                     (self._cast_in(h), y), accum)
        return step

    def build_baseline_step(self, opt, accum: int = 1):
        n = self.cfg.n_layers

        def step(p, st, x, y):
            def loss_fn(p_, xb, yb):
                return losses.cross_entropy(
                    self._range_forward(p_, xb, 0, n), yb)
            return self._finish_step(opt, loss_fn, p, st,
                                     (self._cast_in(x), y), accum)
        return step

    def build_parallel_step(self, k: int, opt, sils, accum: int = 1):
        """Fig.-5 step of stage k: stage 0 on the real batch, an interior
        stage on SIL_{k-1}[:, y] regressing to SIL_k[:, y], the last with
        CE on SIL_{k-1}[:, y].  The synthetic input is looked up inside the
        step from the labels; both tables are held class-major, as in
        ``build_sil_step``."""
        b0, b1 = self.bounds[k]
        last = k == self.n_stages - 1
        sil_in = None if k == 0 else _class_major(sils[k - 1])
        sil_t = None if last else _class_major(sils[k])

        def step(p, st, x, y):
            def loss_fn(p_, xb, yb):
                xin = xb if k == 0 else sil_lib.sil_lookup(sil_in, yb)
                h = self._range_forward(p_, self._cast_in(xin), b0, b1)
                if last:
                    return losses.cross_entropy(h, yb)
                return losses.sil_stage_loss(h, sil_t, yb)
            return self._finish_step(opt, loss_fn, p, st, (x, y), accum)
        return step

    def build_recovery_step(self, j: int, frozen: list, opt, accum: int = 1):
        """End-to-end CE training of stage j with every other stage frozen
        (paper §5 for j=0).  The frozen stages are detached tensors: no
        gradient is computed or stored for them."""
        bounds = self.bounds
        frozen = [tree_map(lambda t: t.detach(), sp) for sp in frozen]

        def step(pj, st, x, y):
            def loss_fn(pj_, xb, yb):
                h = xb
                for k, (b0, b1) in enumerate(bounds):
                    h = self._range_forward(pj_ if k == j else frozen[k], h,
                                            b0, b1)
                return losses.cross_entropy(h, yb)
            return self._finish_step(opt, loss_fn, pj, st,
                                     (self._cast_in(x), y), accum)
        return step

    # -- prefix / eval -----------------------------------------------------

    def boundary_dtype(self) -> torch.dtype:
        """Storage dtype of materialized boundary activations: the policy's
        compute dtype (halving the spill under bf16)."""
        return torch.float32 if self.policy is None \
            else self.policy.compute_torch

    def prefix_forward(self, k: int):
        bounds = self.bounds

        @torch.no_grad()
        def fwd(prefix, x):
            x = self._cast_in(x)
            for j in range(k):
                b0, b1 = bounds[j]
                x = self._range_forward(prefix[j], x, b0, b1)
            return x
        return fwd

    def eval_joined(self, stage_params) -> float:
        return self.eval_full(self.join(stage_params))

    def eval_full(self, params) -> float:
        return mlp_test_accuracy(self.cfg, params, self._vx, self._vy)


@torch.no_grad()
def mlp_test_accuracy(cfg, params, tx, ty, bs=4096) -> float:
    """Test accuracy of the fp32 network; hits are counted on the device
    and read once."""
    hits = torch.zeros((), dtype=torch.int64, device=tx.device)
    for i in range(0, len(tx), bs):
        logits = MLP.forward_range(cfg, params, tx[i:i + bs], 0,
                                   cfg.n_layers)
        hits += (torch.argmax(logits, dim=-1) == ty[i:i + bs]).sum()
    return hits.item() / len(tx)


# ==========================================================================
# Transformer (PartitionPlan) backend
# ==========================================================================

def _unit(scale) -> bool:
    """The unwrapped optimizer's loss scale, 1.0 (a wrapper's is a tensor)."""
    return isinstance(scale, float) and scale == 1.0


def _scaled(loss, scale):
    return loss if _unit(scale) else loss * scale


def _unscaled(loss, scale):
    return loss if _unit(scale) else loss / scale


class LMBackend:
    kind = "lm"

    def __init__(self, cfg, plan: partition.PartitionPlan,
                 batch_fn: Callable[[int], dict], spec: TrainSpec, *,
                 device="cuda"):
        """An explicit ``spec.precision`` re-dtypes the stage forward
        (activations and boundaries in its compute dtype); params keep
        ``cfg.param_dtype``.  ``batch_fn(i)`` gives step i's
        ``{"tokens", "labels"}`` (and optionally ``"mask"``) as numpy
        arrays or tensors; ``"cuda"`` raises where torch sees no card."""
        self.device = resolve_device(device)
        self.policy = resolve_policy(None, spec)
        if self.policy is not None:
            cfg = self.policy.apply_to_model(cfg)
        precision_lib.policy_for(cfg).apply_backend_flags()
        self.cfg = cfg
        self.plan = plan
        self._batch_fn = batch_fn
        self.spec = spec
        self.n_stages = plan.n_stages

    def host_batch(self, i: int) -> dict:
        """Step i's batch as host tensors, integer arrays as int64, in pinned
        memory when the backend runs on the card."""
        pin = self.device.type == "cuda"

        def host(a):
            t = a if isinstance(a, torch.Tensor) \
                else torch.as_tensor(np.asarray(a))
            if not t.is_floating_point():
                t = t.long()
            return t.pin_memory() if pin and t.device.type == "cpu" else t
        return {k: host(v) for k, v in self._batch_fn(i).items()
                if v is not None}

    def put_batch(self, batch: dict, device=None) -> dict:
        """``batch`` on ``device`` (default: the backend's).  From pinned
        memory the upload does not wait for the device to finish the last
        step."""
        dev = self.device if device is None else device
        return {k: t.to(dev, non_blocking=True) for k, t in batch.items()}

    def batch_fn(self, i: int, device=None) -> dict:
        """Step i's batch on ``device`` (default: the backend's)."""
        return self.put_batch(self.host_batch(i), device)

    # -- params ------------------------------------------------------------

    def split(self, params) -> List[dict]:
        """Per-stage copies: the optimizers update them in place, so the
        caller's tensors never change."""
        return [_copy_tree(partition.slice_stage_params(
            self.cfg, self.plan, params, k)) for k in range(self.n_stages)]

    def join(self, stage_params) -> dict:
        return partition.join_stage_params(self.cfg, self.plan, stage_params)

    def make_sils(self, gen: Optional[torch.Generator], kappa: float
                  ) -> list:
        """One (d_model, vocab) SIL per interior cut, drawn in order from
        ``gen`` into (vocab, d_model) storage: the (d, M) view the loss
        takes has contiguous columns, the layout the SIL-MSE kernel reads
        with 16-byte loads, and the table is never copied transposed."""
        return [sil_lib.make_sil(gen, self.cfg.d_model, self.cfg.vocab_size,
                                 kappa, device=self.device, class_major=True)
                for _ in range(self.n_stages - 1)]

    def before_stage_train(self, stage_params: list, k: int) -> None:
        """Refresh the last stage's frozen tied-unembedding copy from stage
        0's (possibly already trained) embedding before training it."""
        if k == self.n_stages - 1:
            partition.refresh_tied_unembed(self.cfg, self.plan, stage_params)

    @staticmethod
    def trainable(stage_params: dict) -> dict:
        """The stage's differentiated and optimized subtree: the frozen
        ``tied_unembed`` snapshot is left out, so no gradient or optimizer
        state is ever allocated for it."""
        return {k: v for k, v in stage_params.items() if k != "tied_unembed"}

    @staticmethod
    def _split_frozen(sp: dict):
        frozen = {k: v for k, v in sp.items() if k == "tied_unembed"}
        return LMBackend.trainable(sp), frozen

    def _cast_in(self, xin):
        """Boundary inputs enter the stage in the compute dtype."""
        if self.policy is None:
            return xin
        return self.policy.cast_compute(xin)

    def _trim_vision(self, x):
        """A vision config's rows past its ``vision_tokens`` image rows: the
        text rows that the labels, the mask and the SIL targets index."""
        if self.cfg.frontend == "vision":
            return x[:, self.cfg.vision_tokens:]
        return x

    def _refuse_vision_fig5(self, k: int) -> None:
        """Fig. 5's stage k > 0 runs on SIL_{k-1}[:, y], the text rows
        alone, from which ``_trim_vision`` would still drop
        ``vision_tokens`` rows: the reference's stage step fails there
        (``ValueError: Incompatible shapes for broadcasting``), and the
        port refuses the same case before it runs."""
        if self.cfg.frontend == "vision":
            raise ValueError(
                f"Fig. 5 stage {k} of {self.cfg.name}: its synthetic input "
                "SIL[:, y] holds only the text rows, and the vision trim "
                f"would drop {self.cfg.vision_tokens} rows of it (the "
                "reference fails here too: ValueError: Incompatible shapes "
                "for broadcasting); train a vision config stage by stage")

    # -- losses and step builders ------------------------------------------

    def stage_loss(self, k: int, sil, frozen: dict):
        """``loss_fn(p, xin, labels, mask)`` of stage k's step on its
        trainable params ``p`` (``frozen``: the stage's frozen leaves):
        SIL-MSE on the boundary for an interior stage (``sil`` a (d, vocab)
        table), CE through the unembedding for the last; with experts, each
        adds the stage's own MoE aux terms.  A vision config's loss reads
        the text rows alone (``_trim_vision``)."""
        cfg, plan = self.cfg, self.plan
        last = k == self.n_stages - 1

        def loss_fn(p, xin, labels, mask):
            out, aux = partition.stage_forward(cfg, plan, k, {**p, **frozen},
                                               xin)
            if last:
                return losses.train_objective(cfg, self._trim_vision(out),
                                              labels, aux, mask)[0]
            # an encoder-decoder's boundary is the payload (x, enc_out)
            bound = self._trim_vision(out[0] if cfg.enc_dec else out)
            loss = losses.sil_stage_loss(bound, sil, labels)
            if cfg.moe is not None:
                loss = losses.moe_aux_loss(cfg, loss, aux)
            return loss
        return loss_fn

    def recovery_loss(self, j: int, frozen_stages: list, snap: dict):
        """``loss_fn(pj, batch)`` of the end-to-end CE through every stage,
        stage j's trainable params ``pj`` (with its frozen leaves ``snap``)
        and the others as ``frozen_stages`` holds them.  As in the
        reference, only the last stage's MoE aux terms reach the
        objective."""
        cfg, plan = self.cfg, self.plan

        def loss_fn(pj, batch):
            x, aux = batch, {}
            for k in range(self.n_stages):
                p = {**pj, **snap} if k == j else frozen_stages[k]
                x, aux = partition.stage_forward(cfg, plan, k, p, x)
            return losses.train_objective(cfg, self._trim_vision(x),
                                          batch["labels"], aux,
                                          batch.get("mask"))[0]
        return loss_fn

    def build_stage_step(self, k: int, opt, sil, accum: int = 1):
        """Train step for stage k on ``stage_loss``.  ``step(sp, st, xin,
        labels, mask=None) -> (sp, st, loss)``; ``xin`` is the batch for
        stage 0 and the boundary activation otherwise."""

        def step(sp, st, xin, labels, mask=None):
            train, frozen = self._split_frozen(sp)
            scale = precision_lib.read_loss_scale(st)
            base = self.stage_loss(k, sil, frozen)

            def loss_fn(p, xin, labels, mask):
                return _scaled(base(p, xin, labels, mask), scale)
            loss, grads = value_and_accum_grads(
                loss_fn, train, (self._cast_in(xin), labels, mask), accum)
            opt.update(grads, st, train)
            return sp, st, _unscaled(loss, scale)
        return step

    def build_parallel_stage_step(self, k: int, opt, sil_in, sil_target,
                                  accum: int = 1):
        """Fig.-5 step of stage k > 0 with the synthetic-input lookup inside:
        ``step(sp, st, labels) -> (sp, st, loss)``, SIL_{k-1}[:, y] gathered
        from ``sil_in`` (a class-major table on the stage's device: a row
        gather).  ``sil_target`` is SIL_k (None for the last stage, which
        trains with CE).  The math is ``synthetic_input`` followed by
        ``build_stage_step``'s, and so for an encoder-decoder the stage runs
        on ``(syn, None)``: without its cross blocks, as the reference's
        Fig.-5 stage does."""
        if k == 0:
            raise ValueError("stage 0 consumes the real batch; use "
                             "build_stage_step")
        self._refuse_vision_fig5(k)
        inner = self.build_stage_step(k, opt, sil_target, accum=accum)

        def step(sp, st, labels):
            return inner(sp, st, self._synthetic(sil_in, labels), labels)
        return step

    def build_recovery_step(self, j: int, frozen_stages: list, opt,
                            accum: int = 1):
        """End-to-end CE training of stage j, every other stage frozen
        (detached: no gradient is computed or stored for them)."""
        frozen = [tree_map(lambda t: t.detach(), sp) for sp in frozen_stages]

        def step(pj, st, batch):
            train, snap = self._split_frozen(pj)
            scale = precision_lib.read_loss_scale(st)
            base = self.recovery_loss(j, frozen, snap)

            def loss_fn(pj_, batch):
                return _scaled(base(pj_, batch), scale)
            loss, grads = value_and_accum_grads(loss_fn, train, (batch,),
                                                accum)
            opt.update(grads, st, train)
            return pj, st, _unscaled(loss, scale)
        return step

    def build_baseline_step(self, opt, accum: int = 1):
        """Conventional end-to-end training of the unpartitioned network:
        the full joined tree through ``M.forward``, so a tied embedding
        trains with the unembedding's gradient too."""
        cfg = self.cfg

        def step(params, st, batch):
            scale = precision_lib.read_loss_scale(st)

            def loss_fn(p, batch):
                logits, aux = M.forward(cfg, p, batch)
                loss, _ = losses.train_objective(
                    cfg, self._trim_vision(logits), batch["labels"], aux,
                    batch.get("mask"))
                return _scaled(loss, scale)
            loss, grads = value_and_accum_grads(loss_fn, params, (batch,),
                                                accum)
            opt.update(grads, st, params)
            return params, st, _unscaled(loss, scale)
        return step

    def boundary_dtype(self) -> torch.dtype:
        """Storage dtype of boundary activations (the activation dtype)."""
        return self.cfg.activation_dtype()

    def prefix_forward(self, k: int):
        """The frozen forward of stages < k, without grad or recompute: the
        paper's sole inter-partition communication.  An encoder-decoder's
        is the payload ``(x, enc_out)``."""
        cfg, plan = self.cfg, self.plan

        @torch.no_grad()
        def fwd(prefix_params, batch):
            x = batch
            for j in range(k):
                x, _ = partition.stage_forward(cfg, plan, j, prefix_params[j],
                                               x, remat=False)
            return x
        return fwd

    def _synthetic(self, sil, labels):
        """SIL[:, y] in the compute dtype; an encoder-decoder's payload is
        ``(syn, None)``, so the stage runs without its cross blocks (the
        reference's Fig.-5 input: no encoder output reaches a stage after
        the first)."""
        syn = sil_lib.sil_lookup(sil, labels).to(self.cfg.activation_dtype())
        return (syn, None) if self.cfg.enc_dec else syn

    def synthetic_input(self, k: int, sils, labels):
        """The Fig.-5 synthetic input of stage k > 0: SIL_{k-1}[:, y]
        (``(syn, None)`` for an encoder-decoder, see ``_synthetic``); a
        vision config is refused (``_refuse_vision_fig5``)."""
        self._refuse_vision_fig5(k)
        return self._synthetic(sils[k - 1], labels)
