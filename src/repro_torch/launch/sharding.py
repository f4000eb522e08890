"""FSDP+TP sharding policy with divisibility fallback (counterpart of
``repro/launch/sharding.py``).

Every rule checks divisibility against the actual mesh axis size and falls
back to replication on that axis when a dimension doesn't divide (e.g.
qwen2's 12 Q heads on a 16-way model axis).  The decisions are queryable
(``explain()``) and recorded by the dry run.

A spec is a tuple of axis names (or tuples of them) and ``None``, one entry
per dim from the first, as ``PartitionSpec`` holds them; missing trailing
entries are ``None``.

Weight layout conventions (see models/layers.py):
  attention  wq (d, H*hd)   / wk, wv (d, KV*hd) / wo (H*hd, d)
  mlp        wg,wu (d, ff)  / wd (ff, d)
  moe        experts (E, d, ff) etc., router (d, E)

The port keeps the layer groups (and Whisper's encoder layers) as a list,
``groups/<i>/...``, where the reference stacks them on a leading G dim that
only pipeline mode shards.  A leaf of such a list gets the spec of its own
dims, a ``LeafSpec`` whose ``lead`` is the entry the reference's stacked
leaf has on G: the axis the list is split over (``"pod"`` in pipeline mode
where ``_stage_axis`` says so), or None.  Prepending ``lead`` gives the
reference's spec.  The cache stays stacked in both packages.

Sharding a fused (H*hd) dim over the model axis is only legal when H divides
the axis size (so shards hold whole heads and the (B,S,H,hd) reshape stays
representable); same for KV heads.

The ``*_shardings`` methods place tensors on a mesh of real cards, which
waits for a machine with more than one (ROADMAP queue A, step 5): they
raise.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import mesh_refusal

Spec = Tuple[Any, ...]
STACKED = ("groups", "encoder")


class LeafSpec(tuple):
    """The spec of one leaf of a stacked list; ``lead`` is the reference's
    entry on the stacked G dim (tuple equality ignores it)."""
    lead: Optional[str]

    def __new__(cls, entries, lead: Optional[str] = None):
        obj = super().__new__(cls, entries)
        obj.lead = lead
        return obj

    def __repr__(self) -> str:
        return f"LeafSpec({tuple(self)!r}, lead={self.lead!r})"


def _refuse_devices(what: str):
    raise NotImplementedError(mesh_refusal(
        f"{what} (tensors placed on the mesh; the *_pspecs specs and the "
        "per-chip bytes need no card)"))


class Policy:
    """Sharding policy for one (cfg, mesh) pair.

    pipeline=True (multi-pod meshes): the conventional model-parallel
    baseline the paper argues against — the layer groups are split over
    the "pod" axis (stage-per-pod), so every microbatch's residual crosses
    pods forward AND backward.  PNN eliminates exactly this traffic.
    """

    def __init__(self, cfg: ModelConfig, mesh, *, fsdp: bool = True,
                 pipeline: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.fsdp = fsdp
        self.tp = "model"
        self.tp_size = mesh.shape["model"]
        self.fsdp_ax = "data" if fsdp else None
        self.fsdp_size = mesh.shape["data"] if fsdp else 1
        self.pipeline = pipeline and "pod" in mesh.axis_names
        if self.pipeline:
            self.dp = ("data",)   # pod axis carries stages, not batch
        else:
            self.dp = ("pod", "data") if "pod" in mesh.axis_names \
                else ("data",)
        self.decisions: Dict[str, str] = {}

    def _stage_axis(self, n_stacked: int) -> Optional[str]:
        """Pipeline stage axis for the layer-group list."""
        if not self.pipeline:
            return None
        pod = self.mesh.shape["pod"]
        ok = n_stacked % pod == 0
        self.decisions.setdefault(
            "pipeline_groups",
            f"pod({n_stacked})" if ok else f"replicated({n_stacked})")
        return "pod" if ok else None

    # -- helpers -----------------------------------------------------------
    def _tp(self, dim: int, why: str) -> Optional[str]:
        ok = dim % self.tp_size == 0
        self.decisions.setdefault(
            why, f"model({dim})" if ok else f"replicated({dim})")
        return self.tp if ok else None

    def _fs(self, dim: int) -> Optional[str]:
        if not self.fsdp:
            return None
        return self.fsdp_ax if dim % self.fsdp_size == 0 else None

    # -- parameter specs ----------------------------------------------------
    def param_spec(self, path: str, shape) -> Spec:
        """The spec of the leaf at ``path`` (``groups/<i>/...`` for a
        group's leaf) of ``shape`` (its own dims): a ``LeafSpec`` for a
        leaf of a stacked list."""
        lead, entries = self._param_entries(path, tuple(shape))
        if path.split("/")[0] in STACKED:
            return LeafSpec(entries, lead)
        return entries

    def _param_entries(self, path: str, shape) -> Tuple[Optional[str], Spec]:
        """(the reference's lead entry, the leaf's own entries)."""
        cfg = self.cfg
        h, kv = cfg.n_heads, cfg.n_kv_heads
        lead = None
        if path.startswith("groups") and self.pipeline:
            from repro_torch.models import model as _M
            lead = self._stage_axis(_M.n_groups(cfg))
        is_bias = path.endswith("/b")

        def spec(*axes):
            return lead, tuple(axes)

        def plain(*axes):                 # no lead entry in the reference
            return None, tuple(axes)

        if "attn/wq" in path or "cross/wq" in path:
            ax = self._tp(h, "attn_q_heads")
            if is_bias:
                return spec(ax)
            return spec(self._fs(shape[-2]), ax)
        if any(s in path for s in ("attn/wk", "attn/wv", "cross/wk",
                                   "cross/wv")):
            ax = self._tp(kv, "attn_kv_heads")
            if is_bias:
                return spec(ax)
            return spec(self._fs(shape[-2]), ax)
        if "attn/wo" in path or "cross/wo" in path:
            if is_bias:
                return spec(None)
            return spec(self._tp(h, "attn_q_heads"), self._fs(shape[-1]))
        if any(s in path for s in ("mlp/wg", "mlp/wu", "mlp/w1")):
            ax = self._tp(cfg.d_ff, "mlp_ff")
            if is_bias:
                return spec(ax)
            return spec(self._fs(shape[-2]), ax)
        if "mlp/wd" in path or "mlp/w2" in path:
            if is_bias:
                return spec(None)
            return spec(self._tp(cfg.d_ff, "mlp_ff"), self._fs(shape[-1]))
        if "moe/router" in path:
            return spec(self._fs(shape[-2]), None)
        if "moe/" in path:  # expert stacks (E, d, ff) or (E, ff, d)
            e = cfg.moe.num_experts
            if e % self.tp_size == 0:
                self.decisions.setdefault("moe_experts",
                                          f"model({e})=expert-parallel")
                return spec(self.tp, self._fs(shape[-2]), None)
            if path.split("/")[-1] in ("wd", "w2"):   # (E, ff, d)
                return spec(None, self._tp(cfg.d_ff, "moe_ff"),
                            self._fs(shape[-1]))
            return spec(None, self._fs(shape[-2]),
                        self._tp(cfg.d_ff, "moe_ff"))
        if "mamba/" in path:
            return self._mamba_spec(path, shape, spec, plain, is_bias)
        if "mlstm/" in path or "slstm/" in path:
            return self._xlstm_spec(path, shape, spec, plain, is_bias)
        if path in ("tok_embed", "tied_unembed"):
            # tied_unembed: the last PNN stage's frozen embedding snapshot
            return plain(self._tp(cfg.vocab_padded, "vocab"),
                         self._fs(cfg.d_model))
        if path == "unembed":
            return plain(self._fs(cfg.d_model),
                         self._tp(cfg.vocab_padded, "vocab"))
        if path.startswith("img_proj") and len(shape) == 2:
            return plain(self._fs(shape[-2]), None)
        # dec_pos, norms, scalars, 1D leftovers: replicate
        return plain(*(None,) * len(shape))

    def _mamba_spec(self, path, shape, spec, plain, is_bias):
        tp = lambda d: self._tp(d, "mamba_inner")  # noqa: E731
        if "in_proj" in path:
            if is_bias:
                return spec(tp(shape[-1]))
            return spec(self._fs(shape[-2]), tp(shape[-1]))
        if "conv_w" in path:
            return spec(None, tp(shape[-1]))
        if "conv_b" in path or path.endswith("/D"):
            return spec(tp(shape[-1]))
        if "x_proj" in path:
            if is_bias:
                return spec(None)
            return spec(tp(shape[-2]), None)
        if "dt_proj" in path:
            if is_bias:
                return spec(tp(shape[-1]))
            return spec(None, tp(shape[-1]))
        if "A_log" in path:
            return spec(tp(shape[-2]), None)
        if "out_proj" in path:
            if is_bias:
                return spec(None)
            return spec(tp(shape[-2]), self._fs(shape[-1]))
        return plain(*(None,) * len(shape))

    def _xlstm_spec(self, path, shape, spec, plain, is_bias):
        tp = lambda d: self._tp(d, "mlstm_up")  # noqa: E731
        if "mlstm/up" in path:
            if is_bias:
                return spec(tp(shape[-1]))
            return spec(self._fs(shape[-2]), tp(shape[-1]))
        if any(s in path for s in ("mlstm/wq", "mlstm/wk", "mlstm/wv")):
            if is_bias:
                return spec(None)
            return spec(tp(shape[-2]), None)
        if "mlstm/down" in path:
            if is_bias:
                return spec(None)
            return spec(tp(shape[-2]), self._fs(shape[-1]))
        # gate projections, slstm weights: data-shard the first matmul dim
        if not is_bias and len(shape) >= 2 and "slstm/r" not in path:
            return plain(*([None] * (len(shape) - 2)
                           + [self._fs(shape[-2]), None]))
        return plain(*(None,) * len(shape))

    # -- whole-tree specs ---------------------------------------------------
    def params_pspecs(self, params) -> Any:
        """A tree of specs shaped as ``params``.  The leaves are visited in
        the reference's order (dict keys sorted, list items in order), so
        the first rule to record a decision is the reference's."""
        specs = {}
        for pstr, leaf in leaves_with_paths(params, sort=True):
            sp = self.param_spec(pstr, leaf.shape)
            assert len(sp) <= len(leaf.shape), (pstr, leaf.shape, sp)
            specs[pstr] = sp
        return _map_paths(lambda pstr, _: specs[pstr], params)

    def params_shardings(self, params):
        _refuse_devices("params_shardings")

    def opt_state_pspecs(self, opt_name: str, params):
        """Specs of ``repro_torch.optim``'s state for ``params``: the
        per-leaf lists in ``tree_leaves(params)`` order, as ``opt.init``
        keeps them.  Adafactor factors a leaf as the port's optimizer
        does, by the leaf's own last two dims (the reference factors its
        stacked (G, n) vectors too, which the port's per-group leaves are
        not)."""
        pspecs = [sp for _, sp in leaves_with_paths(
            self.params_pspecs(params))]
        leaves = [p for _, p in leaves_with_paths(params)]
        scalar = ()
        if opt_name == "sgdm":
            return {"mu": pspecs, "count": scalar}
        if opt_name == "adamw":
            return {"m": pspecs, "v": list(pspecs), "count": scalar}
        if opt_name == "adafactor":
            def fspec(p, s):
                sp = _pad_spec(s, p.dim())
                if p.dim() >= 2 and p.shape[-1] >= 32 and p.shape[-2] >= 32:
                    return {"vr": _like(s, sp[:-1]),
                            "vc": _like(s, sp[:-2] + sp[-1:])}
                return {"v": _like(s, sp)}
            return {"v": [fspec(p, s) for p, s in zip(leaves, pspecs)],
                    "count": scalar}
        raise ValueError(opt_name)

    def opt_state_shardings(self, opt_name, params):
        _refuse_devices("opt_state_shardings")

    # -- activations / batch / cache ----------------------------------------
    def batch_entry(self, batch_size: int):
        """Mesh axes to shard the batch dim over (tuple, possibly empty)."""
        axes = []
        rem = batch_size
        for ax in self.dp:
            sz = self.mesh.shape[ax]
            if rem % sz == 0:
                axes.append(ax)
                rem //= sz
        return tuple(axes)

    def batch_pspec(self, array_shape, batch_size=None) -> Spec:
        b = batch_size if batch_size is not None else array_shape[0]
        ent = self.batch_entry(b)
        first = ent if len(ent) > 1 else (ent[0] if ent else None)
        return (first,) + (None,) * (len(array_shape) - 1)

    def batch_shardings(self, batch_specs: Dict[str, Any]):
        _refuse_devices("batch_shardings")

    def cache_pspecs(self, cache, batch_size: int):
        ent = self.batch_entry(batch_size)
        bent = ent if len(ent) > 1 else (ent[0] if ent else None)
        cfg = self.cfg

        def leaf(pstr, x):
            last = pstr.split("/")[-1]
            rest = [None] * (x.dim() - 2)
            if last in ("k", "v", "cross_k", "cross_v"):
                # (G, B, L, KV, hd): prefer KV-head sharding; fall back to
                # head_dim sharding (always combinable with batch sharding —
                # decode attention contracts hd, giving a small psum, vs. a
                # replicated multi-GiB cache)
                if cfg.n_kv_heads % self.tp_size == 0:
                    rest = [None, self.tp, None]
                elif cfg.hd % self.tp_size == 0:
                    rest = [None, None, self.tp]
            elif last == "ssm":           # (G, B, Di, N)
                rest = [self.tp if x.shape[-2] % self.tp_size == 0 else None,
                        None]
            elif last == "conv":          # (G, B, K-1, Di)
                rest = [None,
                        self.tp if x.shape[-1] % self.tp_size == 0 else None]
            return tuple([None, bent] + rest)

        return _map_paths(leaf, cache)

    def cache_shardings(self, cache, batch_size: int):
        _refuse_devices("cache_shardings")

    def explain(self) -> Dict[str, str]:
        return dict(self.decisions)


def _like(spec, entries) -> Spec:
    """``entries`` as a spec of ``spec``'s kind (a ``LeafSpec`` keeps its
    lead)."""
    return LeafSpec(entries, spec.lead) if isinstance(spec, LeafSpec) \
        else tuple(entries)


def _pad_spec(s: Spec, ndim: int) -> Spec:
    t = tuple(s)
    return t + (None,) * (ndim - len(t))


def leaves_with_paths(tree, *, sort: bool = False, prefix: str = ""
                      ) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a tree of dicts and lists, paths joined with "/";
    a tuple is a leaf (a spec).  In ``tree_leaves`` order, or with
    ``sort`` in jax's flattening order (dict keys sorted), the
    reference's."""
    if isinstance(tree, dict):
        for k in (sorted(tree) if sort else tree):
            yield from leaves_with_paths(
                tree[k], sort=sort, prefix=f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(
                v, sort=sort, prefix=f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _map_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` on every leaf of a tree of dicts and lists, its
    structure and key order kept."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)
