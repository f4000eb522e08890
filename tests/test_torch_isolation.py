"""The port stands alone: no JAX and nothing of ``repro`` in its package or
in ``chip_smoke.py``, and its entry points default to the card and raise
where torch sees none (they never fall back to the CPU on their own)."""
import ast
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the suite's convention: both frameworks at the top)
import pytest
import torch

import numpy as np

from repro_torch import convert
from repro_torch.configs import get
from repro_torch.data.images import emnist_like
from repro_torch.launch import serve as launch_serve
from repro_torch.models import mlp as TMLP
from repro_torch.models import model as TM
from repro_torch.serve import Engine
from repro_torch.train import phases as TP
from repro_torch.train import recipes
from repro_torch.train.backends import MLPBackend
from repro_torch.verify import paper
from _torch_threads import _one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scan_ab.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "optax")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.serve, repro_torch.launch.serve\n"
            "import repro_torch.kernels.flash_attention.kernel\n"
            "import repro_torch.convert\n"
            "import repro_torch.train, repro_torch.verify.paper\n"
            "import repro_torch.serve.staged\n"
            "import repro_torch.kernels.sil_mse.kernel\n"
            "import repro_torch.launch.metrics, repro_torch.launch.loadgen\n"
            "import repro_torch.launch.specs, repro_torch.launch.steps\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_defaults_to_cuda_and_raises_without_it(no_card):
    cfg = get("qwen2-1.5b", smoke=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params)
    Engine(cfg, params, device="cpu")          # explicit CPU is fine


def test_launcher_defaults_to_cuda_and_runs_on_cpu(no_card, capsys):
    args = ["--smoke", "--batch", "2", "--prompt-len", "8",
            "--new-tokens", "3"]
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(args)
    launch_serve.main(args + ["--device", "cpu", "--paged"])
    out = capsys.readouterr().out
    assert "decoded 6 tokens" in out and "on cpu" in out


def test_engine_modes_not_ported_raise():
    """Sharded serving (``policy=``) is not ported; staged serving is
    (tests/test_torch_staged.py)."""
    cfg = get("qwen2-1.5b", smoke=True)
    with pytest.raises(NotImplementedError, match="policy"):
        Engine(cfg, None, seed=0, device="cpu", policy=object())


def test_chip_smoke_without_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path, monkeypatch,
                                                     capsys):
    """In a directory holding chip_smoke.py and nothing else of the repo it
    fails even where a card exists."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_alone", tmp_path / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert mod.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_converters_default_to_cuda_and_raise_without_it(no_card):
    cfg = TMLP.MLPConfig(sizes=(4, 3, 2), cut=1, n_classes=2)
    tree = [{"w": np.zeros((4, 3), np.float32), "b": np.zeros(3, np.float32)},
            {"w": np.zeros((3, 2), np.float32), "b": np.zeros(2, np.float32)}]
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.mlp_params_from_numpy(cfg, tree)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.sil_from_numpy(np.zeros((3, 2), np.float32))
    lm = get("qwen2-1.5b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_numpy(lm, {"groups": {}})
    assert convert.mlp_params_from_numpy(cfg, tree, device="cpu")[1][
        "w"].shape == (3, 2)


def test_training_entry_points_default_to_cuda(no_card):
    cfg = TMLP.MLPConfig()
    data = emnist_like(n_train=64, n_test=16)
    spec = recipes.paper_spec(n_left=1, n_right=1, n_baseline=1,
                              n_recovery=1, batch_size=32)
    for run in (recipes.run_mlp_baseline, recipes.run_mlp_fig3):
        with pytest.raises(RuntimeError, match="CUDA"):
            run(cfg, data, spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        MLPBackend(cfg, data, spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        paper.run_paper_parity("tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        paper.main(["--preset", "tiny"])


def test_paper_cli_runs_on_the_cpu(no_card, monkeypatch, capsys, tmp_path):
    small = paper.PaperPreset(n_train=2820, n_test=282, noise=0.5, n_left=1,
                              n_right=1, n_baseline=1, n_recovery=1,
                              lr_recovery=3e-4, budget=1.0, floor=0.0)
    monkeypatch.setitem(paper.PRESETS, "tiny", small)
    out = tmp_path / "r.json"
    assert paper.main(["--device", "cpu", "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "[PASS] paper parity (tiny, cpu)" in text
    import json
    r = json.loads(out.read_text())
    # two 1410-sample steps per epoch: 1 baseline epoch + 3 PNN epochs
    assert r["device"] == "cpu" and r["losses_finite"] and r["n_steps"] == 8
    # one epoch of left + right costs one of the whole network, recovery
    # another: twice the baseline's one epoch
    assert r["macs_ratio"] == 2.0


def test_training_modes_not_ported_raise():
    """The searched cut is ported (``repro_torch.plan``, held against the
    reference in tests/test_torch_plan.py): ``"auto"`` / ``"auto:K"``
    resolve to ``make_plan(strategy="auto")``'s plan and a bad spec raises
    the reference's error; the LM's materialized boundary is ported
    (tests/test_torch_lm_boundary.py) and its phases raise only the
    reference's errors."""
    from repro_torch.core import partition
    from repro_torch.train import LMBackend, TrainSpec
    from repro_torch.train.trainer import Trainer
    cfg = get("qwen2-1.5b", smoke=True)
    auto = partition.make_plan(cfg, 2, strategy="auto")
    assert recipes.resolve_plan(cfg, "auto") == auto
    assert recipes.resolve_plan(cfg, "auto:2") == auto
    with pytest.raises(ValueError, match="bad --stages"):
        recipes.resolve_plan(cfg, "auto:two")
    spec = TrainSpec(n_stages=2)
    be = LMBackend(cfg, partition.make_plan(cfg, 2), None, spec,
                   device="cpu")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    sil = torch.zeros(cfg.d_model, cfg.vocab_size)
    for phase, match in ((TP.BoundaryMaterializePhase(upto=1), "n_batches"),
                         (TP.FrozenPrefixPhase(
                             stage=1, source="cache", plan="round_robin",
                             devices=[torch.device("cpu")] * 2),
                          "materialized boundary")):
        with pytest.raises(ValueError, match=match):
            Trainer(be, spec).run([phase], params=params, sils=[sil])
