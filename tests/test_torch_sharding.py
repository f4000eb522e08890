"""The port's sharding policy and production mesh (``repro_torch.launch.
{sharding,mesh}``) against the reference's ``repro.launch.sharding.Policy``
on the same duck-typed mesh shapes (``tests/test_sharding.py``'s
``FakeMesh``: 16 x 16 and 2 x 16 x 16), for every arch, on the CPU.

The port keeps the layer groups as a list (``groups/<i>/...``) where the
reference stacks them on a leading G dim; a group leaf's spec, with its
``lead`` prepended, must be the reference's spec of the stacked leaf, and
every group must get the same spec.  Per-chip bytes
(``hlo_analysis.tree_bytes_per_chip`` and ``dtype_byte_breakdown``) are
held exactly against the reference's functions, fed the reference's trees
and specs (each ``PartitionSpec`` wrapped in an object with a ``.spec``,
all they read), for parameters, optimizer state and decode caches under
both meshes, and under pipeline mode for mistral-large-123b and Jamba.

One layout difference is held as such: the reference's Adafactor factors a
stacked per-group vector (G, n) when G and n are both >= 32 (the norms of
mistral-large-123b's 88 groups and grok-1-314b's 64), where the port's
per-group leaf is a vector and keeps a full second moment.  The optimizer
state's per-chip bytes differ by exactly those leaves.  Then the
reference's own ``tests/test_sharding.py`` cases, on the port.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get as j_get
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.launch import hlo_analysis as JH
from repro.launch import specs as JSpecs
from repro.launch import steps as JSteps
from repro.launch.sharding import Policy as JPolicy
from repro.models import model as JM
from repro.optim import make_optimizer as j_make_optimizer
from repro_torch.configs import ARCH_NAMES, get
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import mesh as TMesh
from repro_torch.launch import specs as TSpecs
from repro_torch.launch import steps as TSteps
from repro_torch.launch.sharding import LeafSpec, Policy, _pad_spec
from repro_torch.models import model as TM
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_leaves
from test_sharding import FakeMesh
from _torch_threads import _one_thread  # noqa: F401

MESHES = {"single": False, "multi": True}


def _mesh(multi):
    return TMesh.make_production_mesh(multi_pod=multi)


class _Sh:
    """What the reference's byte functions read of a NamedSharding."""
    def __init__(self, spec):
        self.spec = spec


def _jflat(tree):
    """{path: leaf} of a reference tree, PartitionSpecs as leaves."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def _tflat(tree, prefix=""):
    """{path: leaf} of a port tree (specs as leaves), in insertion order."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tflat(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_tflat(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: tree}


def _stacked(path):
    """A port path's reference path and its list index (None if the leaf
    is not in a stacked list)."""
    parts = path.split("/")
    if parts[0] in ("groups", "encoder"):
        return "/".join(parts[:1] + parts[2:]), int(parts[1])
    return path, None


def _assert_specs(jspecs, tspecs):
    """Every port leaf's spec, its lead prepended for a stacked leaf, is
    the reference's spec of the same (stacked) leaf."""
    ref = _jflat(jspecs)
    seen = set()
    for path, sp in _tflat(tspecs).items():
        rpath, g = _stacked(path)
        want = tuple(ref[rpath])
        if g is None:
            assert not isinstance(sp, LeafSpec), path
            got = tuple(sp)
        else:
            assert isinstance(sp, LeafSpec), path
            got = (sp.lead,) + tuple(sp)
        assert _pad(got, len(want)) == _pad(want, len(got)), \
            (path, got, want)
        seen.add(rpath)
    assert seen == set(ref)


def _pad(t, n):
    return tuple(t) + (None,) * (n - len(t))


def _jbytes(tree, specs, mesh):
    shards = jax.tree_util.tree_map(_Sh, specs,
                                    is_leaf=lambda x: isinstance(x, P))
    return JH.dtype_byte_breakdown(tree, shards, mesh)


@pytest.fixture(scope="module")
def structs():
    """{arch: (reference params struct, port meta params)}."""
    return {a: (jax.eval_shape(lambda a=a: JM.init_params(
                    j_get(a), jax.random.PRNGKey(0))),
                TM.init_params(get(a), torch.Generator(), device="meta"))
            for a in ARCH_NAMES}


def test_production_mesh_matches_fake_mesh():
    for multi in (False, True):
        m, f = _mesh(multi), FakeMesh(multi)
        assert m.shape == f.shape and m.axis_names == f.axis_names
        assert m.size == f.size
        assert TMesh.dp_axes(m) == (("pod", "data") if multi else ("data",))
    assert TMesh.fsdp_axis(m) == "data" and TMesh.tp_axis(m) == "model"
    assert TMesh.make_production_mesh(shape=(32, 8)).shape == \
        {"data": 32, "model": 8}
    with pytest.raises(AssertionError, match="256 chips"):
        TMesh.make_production_mesh(shape=(16, 8))
    assert (TMesh.PEAK_FLOPS_BF16, TMesh.PEAK_FLOPS_FP32, TMesh.HBM_BW) == \
        (989e12, 67e12, 3.35e12)


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_params_pspecs_match_reference(structs, arch, mesh_kind):
    """Every leaf's spec, the decisions (``explain``) and the per-chip
    bytes by dtype."""
    multi = MESHES[mesh_kind]
    jstruct, tstruct = structs[arch]
    jpol, tpol = JPolicy(j_get(arch), FakeMesh(multi)), \
        Policy(get(arch), _mesh(multi))
    jspecs, tspecs = jpol.params_pspecs(jstruct), tpol.params_pspecs(tstruct)
    _assert_specs(jspecs, tspecs)
    assert tpol.explain() == jpol.explain()
    want = _jbytes(jstruct, jspecs, FakeMesh(multi))
    assert H.dtype_byte_breakdown(tstruct, tspecs, _mesh(multi)) == want
    assert H.tree_bytes_per_chip(tstruct, tspecs, _mesh(multi)) == \
        JH.tree_bytes_per_chip(jstruct, jax.tree_util.tree_map(
            _Sh, jspecs, is_leaf=lambda x: isinstance(x, P)),
            FakeMesh(multi))
    assert H.dtype_byte_breakdown(tstruct) == JH.dtype_byte_breakdown(jstruct)


@pytest.mark.parametrize("arch", ["mistral-large-123b",
                                  "jamba-1.5-large-398b"])
def test_pipeline_mode_matches_reference(structs, arch):
    """Pipeline mode on 2 pods: mistral's 88 groups split over "pod"
    (``pod(88)``), Jamba's 9 replicated; specs, decisions, per-chip bytes,
    and the batch over "data" alone."""
    jstruct, tstruct = structs[arch]
    jpol = JPolicy(j_get(arch), FakeMesh(True), pipeline=True)
    tpol = Policy(get(arch), _mesh(True), pipeline=True)
    jspecs, tspecs = jpol.params_pspecs(jstruct), tpol.params_pspecs(tstruct)
    _assert_specs(jspecs, tspecs)
    assert tpol.explain() == jpol.explain()
    split = tpol.explain()["pipeline_groups"] == "pod(88)"
    assert split == (arch == "mistral-large-123b")
    assert H.dtype_byte_breakdown(tstruct, tspecs, _mesh(True)) == \
        _jbytes(jstruct, jspecs, FakeMesh(True))
    assert tpol.dp == jpol.dp == ("data",)
    for shape in INPUT_SHAPES.values():
        assert tpol.batch_entry(shape.global_batch) == \
            jpol.batch_entry(shape.global_batch)


def _ref_factored(jleaf):
    return len(jleaf.shape) >= 2 and jleaf.shape[-1] >= 32 \
        and jleaf.shape[-2] >= 32


def _chip_bytes(shape, spec, mesh, itemsize=4):
    den = 1
    for ent in spec:
        for ax in (() if ent is None else
                   ent if isinstance(ent, tuple) else (ent,)):
            den *= mesh.shape[ax]
    return int(np.prod(shape)) // den * itemsize


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_opt_state_pspecs_match_reference(structs, arch, mesh_kind):
    """The optimizer ``pick_optimizer_name`` picks: every state leaf's spec
    against the reference's for the same param leaf, and the per-chip
    bytes, exact but for the stacked vectors Adafactor factors only in the
    reference (see the module doc)."""
    multi = MESHES[mesh_kind]
    jcfg, cfg = j_get(arch), get(arch)
    jstruct, tstruct = structs[arch]
    name = TSteps.pick_optimizer_name(cfg)
    assert name == JSteps.pick_optimizer_name(jcfg)
    jpol, tpol = JPolicy(jcfg, FakeMesh(multi)), Policy(cfg, _mesh(multi))
    jst, tst = jpol.opt_state_pspecs(name, jstruct), \
        tpol.opt_state_pspecs(name, tstruct)
    tstate = make_optimizer(name, 1e-3).init(tstruct)
    jstate = jax.eval_shape(j_make_optimizer(name, 1e-3).init, jstruct)
    assert tuple(jst["count"]) == tst["count"] == ()
    paths = list(_tflat(tstruct))
    jleaves = _jflat(jstruct)
    gap = 0
    if name == "adamw":
        for slot in ("m", "v"):
            assert len(tst[slot]) == len(paths)
            _assert_specs(jst[slot], dict(zip(paths, tst[slot])))
    else:
        jv = _jflat(jst["v"])
        tparams = _tflat(tpol.params_pspecs(tstruct))
        for path, sp, st in zip(paths, tst["v"], tstate["v"]):
            rpath, g = _stacked(path)
            lead = () if g is None else (sp[next(iter(sp))].lead,)
            if _ref_factored(jleaves[rpath]) and "v" in sp:
                # a stacked (G, n) vector: full in the port
                assert g is not None and st["v"].dim() == 1 \
                    and jleaves[rpath].shape[0] >= 32, path
                assert sp["v"] == tparams[path]
                assert sp["v"].lead == tparams[path].lead
                full = _chip_bytes(st["v"].shape, sp["v"], _mesh(multi))
                if g == 0:
                    jr = jv[rpath + "/vr"]
                    jc = jv[rpath + "/vc"]
                    n_g = jleaves[rpath].shape[0]
                    gap += n_g * full - _chip_bytes(
                        (n_g,), tuple(jr), FakeMesh(multi)) - _chip_bytes(
                        jleaves[rpath].shape[1:], tuple(jc), FakeMesh(multi))
                continue
            for k, s in sp.items():
                want = tuple(jv[f"{rpath}/{k}"])
                got = lead + tuple(s)
                assert _pad(got, len(want)) == _pad(want, len(got)), \
                    (path, k, got, want)
    assert (gap > 0) == (arch in ("mistral-large-123b", "grok-1-314b"))
    jsh = jax.tree_util.tree_map(_Sh, jst, is_leaf=lambda x: isinstance(x, P))
    want = JH.dtype_byte_breakdown(jstate, jsh, FakeMesh(multi))
    got = H.dtype_byte_breakdown(tstate, tst, _mesh(multi))
    assert got.pop("int32") == want.pop("int32") == 4
    assert got == {"float32": want["float32"] + gap}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_cache_match_reference(arch):
    """``batch_entry`` and ``batch_pspec`` for every input shape, and the
    decode cache's specs and per-chip bytes for each applicable one, under
    both meshes; the ``*_shardings`` methods raise."""
    for multi in (False, True):
        for sname, shape in INPUT_SHAPES.items():
            jshape = J_SHAPES[sname]
            jcfg = JSpecs.arch_for_shape(j_get(arch), jshape)
            cfg = TSpecs.arch_for_shape(get(arch), shape)
            jpol, tpol = JPolicy(jcfg, FakeMesh(multi)), \
                Policy(cfg, _mesh(multi))
            b = shape.global_batch
            assert tpol.batch_entry(b) == jpol.batch_entry(b)
            assert tpol.batch_pspec((b, 7)) == tuple(jpol.batch_pspec((b, 7)))
            if not TSpecs.applicable(cfg, shape)[0]:
                continue
            jcache = JSpecs.decode_specs(jcfg, jshape)[0]
            tcache = TSpecs.decode_specs(cfg, shape)[0]
            jcs, tcs = jpol.cache_pspecs(jcache, b), tpol.cache_pspecs(
                tcache, b)
            ref = _jflat(jcs)
            got = _tflat(tcs)
            assert sorted(got) == sorted(ref)
            for k in ref:
                assert got[k] == tuple(ref[k]), (arch, sname, k)
            assert H.dtype_byte_breakdown(tcache, tcs, _mesh(multi)) == \
                _jbytes(jcache, jcs, FakeMesh(multi))
    pol = Policy(get(arch), _mesh(False))
    for meth, args in (("params_shardings", ({},)),
                       ("opt_state_shardings", ("adamw", {})),
                       ("batch_shardings", ({},)),
                       ("cache_shardings", ({}, 1))):
        with pytest.raises(NotImplementedError, match="step 5"):
            getattr(pol, meth)(*args)


def test_pick_accum_matches_reference():
    """``pick_accum(policy=)`` divides by the policy's data shards as the
    reference's does, every arch x shape on both meshes and on one card
    (a 1 x 1 mesh, and no policy)."""
    one = TMesh.AbstractMesh(("data", "model"), (1, 1))
    for arch in ARCH_NAMES:
        for sname, shape in INPUT_SHAPES.items():
            for multi in (False, True):
                want = JSteps.pick_accum(j_get(arch), J_SHAPES[sname],
                                         JPolicy(j_get(arch),
                                                 FakeMesh(multi)))
                got = TSteps.pick_accum(get(arch), shape,
                                        Policy(get(arch), _mesh(multi)))
                assert got == want, (arch, sname, multi)
            alone = TSteps.pick_accum(get(arch), shape)
            assert TSteps.pick_accum(get(arch), shape,
                                     Policy(get(arch), one)) == alone


# -- the reference's tests/test_sharding.py, on the port --------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_param_specs_divisible(structs, name, multi_pod):
    """Every sharded dim must divide by its mesh axes — the policy's core
    contract (fallback to replication otherwise); a split list's length
    divides by its lead's axis."""
    mesh = _mesh(multi_pod)
    pol = Policy(get(name), mesh)
    tstruct = structs[name][1]
    specs = _tflat(pol.params_pspecs(tstruct))
    leaves = _tflat(tstruct)
    assert list(specs) == list(leaves)
    for path, leaf in leaves.items():
        ent = _pad_spec(specs[path], leaf.dim())
        for dim, ax in zip(leaf.shape, ent):
            if ax is None:
                continue
            total = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                total *= mesh.shape[a]
            assert dim % total == 0, (path, leaf.shape, ent)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_batch_entry_divides(name):
    pol = Policy(get(name), _mesh(False))
    for shape in INPUT_SHAPES.values():
        total = 1
        for ax in pol.batch_entry(shape.global_batch):
            total *= pol.mesh.shape[ax]
        assert shape.global_batch % total == 0


def test_decisions_recorded_for_fallbacks(structs):
    pol = Policy(get("qwen2-1.5b"), _mesh(False))  # 12 heads on 16 -> fallback
    pol.params_pspecs(structs["qwen2-1.5b"][1])
    assert "replicated" in pol.explain()["attn_q_heads"]


def test_pipeline_policy_shards_group_stack(structs):
    """Pipeline mode: the group list splits over 'pod' when it divides;
    batch excludes the pod axis; Jamba's 9 groups fall back, recorded."""
    pol = Policy(get("mistral-large-123b"), _mesh(True), pipeline=True)
    specs = pol.params_pspecs(structs["mistral-large-123b"][1])
    leads = {sp.lead for g in specs["groups"]
             for sp in _tflat(g).values()}
    assert leads == {"pod", None}
    assert pol.dp == ("data",)
    pol2 = Policy(get("jamba-1.5-large-398b"), _mesh(True), pipeline=True)
    pol2.params_pspecs(structs["jamba-1.5-large-398b"][1])
    assert "replicated" in pol2.explain()["pipeline_groups"]


def test_applicability_matrix():
    """39 of 40 pairs run; whisper x long_500k is the documented skip."""
    n_ok, skips = 0, []
    for name in ARCH_NAMES:
        for shape in INPUT_SHAPES.values():
            if TSpecs.applicable(get(name), shape)[0]:
                n_ok += 1
            else:
                skips.append((name, shape.name))
    assert n_ok == 39
    assert skips == [("whisper-tiny", "long_500k")]


def test_leaves_in_tree_order():
    """``opt_state_pspecs``' lists line up with ``tree_leaves(params)``,
    the order ``opt.init`` keeps (not the sorted order decisions take)."""
    cfg = get("qwen2-1.5b", smoke=True)
    params = TM.init_params(cfg, torch.Generator(), device="meta")
    pol = Policy(cfg, _mesh(False))
    st = pol.opt_state_pspecs("adamw", params)
    flat = list(_tflat(pol.params_pspecs(params)).values())
    assert st["m"] == flat == st["v"]
    assert len(flat) == len(list(tree_leaves(params)))
    for sp, leaf in zip(flat, tree_leaves(params)):
        assert len(sp) <= leaf.dim()
