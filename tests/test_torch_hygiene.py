"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither jax nor the reference package, its entry points default to the GPU
and raise without one, and the chip smoke refuses to run on the CPU."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [SMOKE]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_static_scan_finds_no_jax_or_reference_import():
    files = _port_files()
    assert len(files) > 15
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax", "optax"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_every_module_imports_with_jax_and_repro_blocked():
    modules = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PORT)], prefix="repro_torch.")]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import importlib\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items()"
        " if v is not None)\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
    assert len(modules) > 15


def test_entry_points_default_to_cuda_and_raise_without_it():
    from repro_torch import resolve_device
    from repro_torch.configs.base import UNetConfig
    from repro_torch.core.pipeline import TEXT_VOCAB, SDPipeline
    from repro_torch.models.frontends import text_encoder_config
    from repro_torch.models.transformer import Encoder
    from repro_torch.models.unet import UNet

    cfg = UNetConfig().reduced()
    tcfg = text_encoder_config(TEXT_VOCAB, cfg.text_dim, cfg.text_len)
    assert resolve_device("cpu") == torch.device("cpu")
    assert next(UNet.init(cfg, device="cpu").parameters()).device.type == "cpu"
    assert next(Encoder.init(tcfg, device="cpu").parameters()).device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise here")
    with pytest.raises(RuntimeError, match="CUDA"):
        SDPipeline.init(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        SDPipeline.init(cfg, seed=0, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        UNet.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder.init(tcfg)


def _smoke(cwd):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          timeout=300, cwd=str(cwd), env=env)


def test_chip_smoke_refuses_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke would run")
    res = _smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    # alone in a directory, without the package beside it, it fails too
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    res = _smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
