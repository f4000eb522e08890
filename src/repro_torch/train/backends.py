"""Training backend for the phase API: the paper's fully-connected EMNIST
experiment (counterpart of the MLP half of ``repro/train/backends.py``).

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

The transformer backend (``LMBackend``) waits for the LM slice of the port.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import precision as precision_lib
from repro_torch.core import losses, sil as sil_lib
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import mlp as MLP
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


def value_and_accum_grads(loss_fn, params, args, accum: int = 1):
    """(mean loss, grads) of ``loss_fn(params, *args)``, the grads a flat
    list in ``tree_leaves(params)`` order.  With ``accum > 1`` the batch is
    split into ``accum`` microbatches and the grads accumulate in fp32
    whatever the compute dtype; ``accum=1`` is the single-shot path."""
    gp = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = list(tree_leaves(gp))
    with torch.enable_grad():
        if accum <= 1:
            loss = loss_fn(gp, *args)
            return loss.detach(), list(torch.autograd.grad(loss, leaves))
        for a in args:
            if a.shape[0] % accum:
                raise ValueError(f"batch dim {a.shape[0]} not divisible by "
                                 f"accum={accum}")
        mbs = [a.reshape((accum, a.shape[0] // accum) + a.shape[1:])
               for a in args]
        gsum, mb_losses = None, []
        for i in range(accum):
            loss = loss_fn(gp, *[a[i] for a in mbs])
            g = [x.float() for x in torch.autograd.grad(loss, leaves)]
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


def balanced_bounds(cfg: MLP.MLPConfig, n_stages: int
                    ) -> Tuple[Tuple[int, int], ...]:
    """Balanced contiguous layer split (the searched split of the
    reference's ``repro.plan`` is not ported)."""
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
        shuffle, gathered on the device with one index tensor."""
        bs = self.spec.batch_size
        if shuffle:
            order = np.arange(len(x))
            np.random.RandomState(seed).shuffle(order)
            idx = torch.from_numpy(order[:n]).to(x.device)
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
        sil_cols = sil.detach().t().contiguous().t()

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
