"""The port's checkpoints (``repro_torch.checkpoint``) and per-stage lifecycle
(``repro_torch.dist.lifecycle``): every case of ``tests/test_checkpoint.py``
on torch trees, the durability contract (torn manifests and checksum
mismatches fall back, an explicit step stays pinned, ``keep_last`` never
drops the step just written), bf16 and optimizer state bit for bit, and the
on-disk format shared with ``repro.checkpoint`` in both directions on the
paper MLP's param tree, which has the same structure in both packages.
Round trips are bitwise: a checkpoint stores bits, not values."""
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.models import mlp as JM
from repro_torch.checkpoint import (CheckpointCorruptError, available_steps,
                                    latest_step, prune_checkpoints,
                                    restore_checkpoint, restore_latest_valid,
                                    save_checkpoint)
from repro_torch.convert import mlp_params_from_numpy
from repro_torch.dist import lifecycle
from repro_torch.models import mlp as TM
from repro_torch.obs import (EventLog, MetricsRegistry, set_default_log,
                             set_default_registry)
from repro_torch.optim import optimizers as TO
from repro_torch.tree import tree_leaves
from _torch_threads import _one_thread  # noqa: F401


def _tree():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "h": torch.ones(3, dtype=torch.bfloat16) * 1.5,
            "nested": [{"b": torch.zeros(2, dtype=torch.float32)}]}


def _same(a, b):
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16
                           else y)


# -- the cases of tests/test_checkpoint.py ------------------------------------

def test_roundtrip_and_latest_step(tmp_path):
    save_checkpoint(str(tmp_path), 3, _tree())
    save_checkpoint(str(tmp_path), 7, _tree())
    assert latest_step(str(tmp_path)) == 7
    assert available_steps(str(tmp_path)) == [3, 7]
    out = restore_checkpoint(str(tmp_path), _tree())
    assert out["h"].dtype == torch.bfloat16       # uint16-view round trip
    assert isinstance(out["nested"], list)
    _same(_tree(), out)


def test_restore_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        restore_checkpoint(str(tmp_path / "nowhere"), _tree())


def test_restore_truncated_manifest_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    manifest = tmp_path / "ckpt_00000001.json"
    text = manifest.read_text()
    manifest.write_text(text[: len(text) // 2])      # simulated torn write
    with pytest.raises(ValueError, match="corrupt/truncated manifest"):
        restore_checkpoint(str(tmp_path), _tree())


def test_restore_mismatched_like_tree_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": _tree()["w"]})
    bigger = {"w": _tree()["w"], "extra": torch.zeros(2)}
    with pytest.raises(ValueError, match="lacks arrays for"):
        restore_checkpoint(str(tmp_path), bigger)


def test_restore_mismatched_device_tree_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="device tree lacks leaves"):
        restore_checkpoint(str(tmp_path), _tree(),
                           device={"w": torch.device("cpu")})


@pytest.mark.parametrize("device", [torch.device("cpu"), "cpu"],
                         ids=["torch.device", "str"])
def test_restore_single_device_broadcast(tmp_path, device):
    save_checkpoint(str(tmp_path), 1, _tree())
    out = restore_checkpoint(str(tmp_path), _tree(), device=device)
    for leaf in tree_leaves(out):
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
    _same(_tree(), out)
    # a tree of devices, one per leaf, is the counterpart of shardings=
    per_leaf = {"w": "cpu", "h": "cpu", "nested": [{"b": "cpu"}]}
    _same(_tree(), restore_checkpoint(str(tmp_path), _tree(),
                                      device=per_leaf))


def test_restore_stage_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints for stage"):
        lifecycle.restore_stage(str(tmp_path), 2, like_params=_tree())


def test_stage_ticks_reports_missing_stages(tmp_path):
    lifecycle.save_stage(str(tmp_path), 0, 4, {"w": _tree()["w"]})
    assert lifecycle.stage_ticks(str(tmp_path), 3) == [4, None, None]


def test_save_stage_manifest_metadata(tmp_path):
    lifecycle.save_stage(str(tmp_path), 1, 5, {"w": _tree()["w"]},
                         metadata={"kind": "mlp"})
    d = lifecycle.stage_dir(str(tmp_path), 1)
    with open(os.path.join(d, "ckpt_00000005.json")) as f:
        manifest = json.load(f)
    assert manifest["metadata"] == {"kind": "mlp", "stage": 1, "tick": 5}
    params, opt, tick = lifecycle.restore_stage(
        str(tmp_path), 1, like_params={"w": _tree()["w"]})
    assert tick == 5 and opt is None
    _same({"w": _tree()["w"]}, params)


# -- the durability contract --------------------------------------------------

def test_manifest_is_the_commit_record_and_no_temp_file_stays(tmp_path):
    save_checkpoint(str(tmp_path), 2, _tree())
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000002.json",
                                            "ckpt_00000002.npz"]
    m = json.loads((tmp_path / "ckpt_00000002.json").read_text())
    assert m["keys"] == ["h", "nested/[0]/b", "w"]
    assert m["dtypes"] == {"h": "bfloat16", "nested/[0]/b": "float32",
                           "w": "float32"}
    assert m["shapes"]["w"] == [2, 3] and set(m["checksums"]) == set(m["keys"])


@pytest.mark.parametrize("damage", ["no_manifest", "torn_manifest",
                                    "crc_mismatch", "torn_archive"])
def test_latest_valid_falls_back_over_a_bad_newest_step(tmp_path, damage):
    old = _tree()
    new = dict(_tree(), w=_tree()["w"] + 100)
    root = str(tmp_path)
    lifecycle.save_stage(root, 0, 1, old)
    lifecycle.save_stage(root, 0, 2, new)
    d = lifecycle.stage_dir(root, 0)
    npz = os.path.join(d, "ckpt_00000002.npz")
    man = os.path.join(d, "ckpt_00000002.json")
    if damage == "no_manifest":          # crash between archive and manifest
        os.remove(man)
    elif damage == "torn_manifest":
        with open(man, "r+") as f:
            f.truncate(40)
    elif damage == "crc_mismatch":       # one leaf's recorded CRC is wrong
        with open(man) as f:
            m = json.load(f)
        m["checksums"]["params/w"] ^= 1
        with open(man, "w") as f:
            json.dump(m, f)
    else:
        with open(npz, "r+b") as f:
            f.truncate(100)
    tree, step = restore_latest_valid(d, {"params": _tree()})
    assert step == 1
    _same(old, tree["params"])
    params, _, tick = lifecycle.restore_stage(root, 0, _tree())
    assert tick == 1
    _same(old, params)
    # an explicit step stays pinned: corruption there raises
    with pytest.raises(CheckpointCorruptError):
        lifecycle.restore_stage(root, 0, _tree(), step=2)
    # nothing valid at all: the newest step's error
    os.remove(os.path.join(d, "ckpt_00000001.json"))
    with pytest.raises(CheckpointCorruptError, match="also invalid"):
        restore_latest_valid(d, {"params": _tree()})


def test_checksum_catches_a_flipped_bit_in_the_archive(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.arange(64.0)})
    npz = tmp_path / "ckpt_00000001.npz"
    with zipfile.ZipFile(npz) as z:
        raw = {n: z.read(n) for n in z.namelist()}
    body = bytearray(raw["w.npy"])
    body[-1] ^= 0x40
    raw["w.npy"] = bytes(body)
    with zipfile.ZipFile(npz, "w") as z:
        for n, b in raw.items():
            z.writestr(n, b)
    with pytest.raises(CheckpointCorruptError, match="checksum mismatch"):
        restore_checkpoint(str(tmp_path), {"w": torch.zeros(64)}, step=1)
    with pytest.raises(CheckpointCorruptError, match="checksum mismatch"):
        restore_latest_valid(str(tmp_path), {"w": torch.zeros(64)})


def test_keep_last_never_drops_the_step_just_written(tmp_path):
    for s in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), s, _tree(), keep_last=2)
    assert available_steps(str(tmp_path)) == [3, 4]
    save_checkpoint(str(tmp_path), 5, _tree(), keep_last=1)
    assert available_steps(str(tmp_path)) == [5]
    assert prune_checkpoints(str(tmp_path), 1) == []
    assert not [f for f in os.listdir(tmp_path) if "00000004" in f]


def test_bf16_leaf_round_trips_bit_for_bit(tmp_path):
    bits = np.random.RandomState(0).randint(0, 2 ** 16, size=(7, 33),
                                            dtype=np.uint16)
    # every pattern included: NaNs, infinities, subnormals, both zeros
    bits[0, :6] = [0x7FC1, 0xFF80, 0x7F80, 0x0001, 0x8000, 0x0000]
    t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    save_checkpoint(str(tmp_path), 1, {"t": t})
    out = restore_checkpoint(str(tmp_path), {"t": t})["t"]
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.view(torch.int16).numpy()
                                  .view(np.uint16), bits)


def test_non_contiguous_leaf_is_stored_as_its_values(tmp_path):
    base = torch.arange(24.0).reshape(4, 6)
    view = base.t()[1:, ::2]
    assert not view.is_contiguous()
    save_checkpoint(str(tmp_path), 1, {"v": view})
    out = restore_checkpoint(str(tmp_path), {"v": view})["v"]
    assert torch.equal(out, view) and out.is_contiguous()


@pytest.mark.parametrize("name", ["adamw", "sgdm"])
def test_optimizer_state_and_count_round_trip(tmp_path, name):
    params = {"a": torch.randn(4, 3, generator=torch.Generator()
                               .manual_seed(0)),
              "g": [torch.randn(5, generator=torch.Generator()
                                .manual_seed(1))]}
    opt = TO.make_optimizer(name, 1e-2)
    st = opt.init(params)
    for _ in range(3):
        grads = [torch.ones_like(p) * 0.1 for p in tree_leaves(params)]
        opt.update(grads, st, params)
    assert int(st["count"]) == 3
    lifecycle.save_stage(str(tmp_path), 0, 3, params, st)
    like_st = opt.init(params)
    p2, st2, tick = lifecycle.restore_stage(str(tmp_path), 0, params,
                                            like_st)
    assert tick == 3
    _same(params, p2)
    _same(st, st2)
    assert st2["count"].dtype == torch.int32 and int(st2["count"]) == 3
    # training on from the restored state is bitwise the uninterrupted run
    grads = [torch.full_like(p, -0.05) for p in tree_leaves(params)]
    opt.update(grads, st, params)
    opt.update([g.clone() for g in grads], st2, p2)
    _same(params, p2)
    _same(st, st2)


def test_saves_and_restores_are_counted_and_logged(tmp_path):
    reg, log = MetricsRegistry(), EventLog()
    set_default_registry(reg)
    set_default_log(log)
    try:
        save_checkpoint(str(tmp_path), 1, _tree())
        save_checkpoint(str(tmp_path), 2, _tree())
        restore_checkpoint(str(tmp_path), _tree())
    finally:
        set_default_registry(None)
        set_default_log(None)
    assert reg.get("checkpoint_saves_total").total() == 2
    assert reg.get("checkpoint_restores_total").total() == 1
    saves = log.records("checkpoint_save")
    assert [e.fields["step"] for e in saves] == [1, 2]
    assert saves[0].fields["leaves"] == 3
    assert log.records("checkpoint_restore")[0].fields["skipped"] == 0


# -- the format shared with repro.checkpoint ----------------------------------

def _mlp_np():
    return jax.tree.map(np.asarray, JM.init_params(JM.MLPConfig(),
                                                   jax.random.PRNGKey(4)))


def test_repro_reads_a_step_the_port_wrote(tmp_path):
    cfg = TM.MLPConfig()
    ref = _mlp_np()
    tparams = mlp_params_from_numpy(cfg, ref, device="cpu")
    tparams[0]["h"] = torch.tensor([1.5, -2.25, 3e-3], dtype=torch.bfloat16)
    save_checkpoint(str(tmp_path), 9, {"params": tparams},
                    metadata={"by": "port"})
    like = jax.tree.map(jnp.asarray, ref)
    like[0]["h"] = jnp.zeros((3,), jnp.bfloat16)
    got = j_restore(str(tmp_path), {"params": like})["params"]
    for p, g in zip(tparams, got):
        for k in p:
            np.testing.assert_array_equal(
                np.asarray(g[k]).view(np.uint16) if k == "h"
                else np.asarray(g[k]),
                p[k].view(torch.int16).numpy().view(np.uint16) if k == "h"
                else p[k].numpy())
    assert np.asarray(got[0]["h"]).dtype.name == "bfloat16"


def test_port_reads_a_step_repro_wrote(tmp_path):
    cfg = TM.MLPConfig()
    ref = jax.tree.map(jnp.asarray, _mlp_np())
    ref[1]["h"] = jnp.asarray([0.1, -7.0], jnp.bfloat16)
    j_save(str(tmp_path), 4, {"params": ref})
    like = mlp_params_from_numpy(cfg, jax.tree.map(np.zeros_like, _mlp_np()),
                                 device="cpu")
    like[1]["h"] = torch.zeros(2, dtype=torch.bfloat16)
    out, step = restore_latest_valid(str(tmp_path), {"params": like})
    assert step == 4
    for r, o in zip(ref, out["params"]):
        for k in r:
            want = np.asarray(r[k])
            if k == "h":
                assert o[k].dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    o[k].view(torch.int16).numpy().view(np.uint16),
                    want.view(np.uint16))
            else:
                np.testing.assert_array_equal(o[k].numpy(), want)
