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

from repro_torch.configs import get
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as TM
from repro_torch.serve import Engine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


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
    cfg = get("qwen2-1.5b", smoke=True)
    with pytest.raises(NotImplementedError):
        Engine(cfg, None, seed=0, device="cpu", plan=object(),
               stage_params=[])
    with pytest.raises(NotImplementedError):
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
