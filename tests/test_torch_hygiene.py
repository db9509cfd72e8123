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
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.attention import cache_spec
    from repro_torch.models.transformer import Encoder, Transformer
    from repro_torch.models.unet import UNet

    cfg = UNetConfig().reduced()
    tcfg = text_encoder_config(TEXT_VOCAB, cfg.text_dim, cfg.text_len)
    dcfg = get_smoke_config("llama3.2-1b")
    assert resolve_device("cpu") == torch.device("cpu")
    assert next(UNet.init(cfg, device="cpu").parameters()).device.type == "cpu"
    assert next(Encoder.init(tcfg, device="cpu").parameters()).device.type == "cpu"
    assert next(Transformer.init(dcfg, device="cpu").parameters()).device.type == "cpu"
    assert cache_spec(dcfg, 1, 4, device="cpu")["k"].device.type == "cpu"
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
    with pytest.raises(RuntimeError, match="CUDA"):
        Transformer.init(dcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cache_spec(dcfg, 1, 4)


def test_kernel_wrappers_take_no_plain_version_for_cuda_requests():
    """Every wrapper decides by its tensors' device alone: CPU tensors and
    meta tensors (the dry-run's shapes) take the plain version and launch
    nothing; CUDA tensors go to the kernel or raise, and without CUDA that
    raises; a mix of devices raises."""
    from repro_torch.kernels import cfg_combine as KC
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.kernels import rmsnorm as KR

    def calls(dev):
        z = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
        return [lambda: KC.cfg_combine(z(2, 8), z(2, 8), 3.0),
                lambda: KC.cfg_combine_rowscale(z(2, 8), z(2, 8), z(2)),
                lambda: KC.apg_combine(z(2, 8), z(2, 8), 3.0),
                lambda: KF.flash_attention(z(1, 8, 2, 8), z(1, 8, 1, 8), z(1, 8, 1, 8)),
                lambda: KD.decode_attention(z(1, 2, 8), z(1, 8, 1, 8), z(1, 8, 1, 8), 3),
                lambda: KR.rmsnorm(z(4, 8), z(8))]

    modules = (KC, KF, KD, KR)
    for m in modules:
        m.reset_launches()
    for call in calls("cpu"):
        assert call().device.type == "cpu"
    assert sum(v for m in modules for v in m.LAUNCHES.values()) == 0
    for call in calls("meta"):
        assert call().device.type == "meta"
    assert sum(v for m in modules for v in m.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        KR.rmsnorm(torch.zeros(4, 8), torch.zeros(8, device="meta"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: a CUDA request would launch")
    for call in calls("cuda"):
        with pytest.raises((RuntimeError, AssertionError), match="CUDA|Torch not compiled"):
            call()


def test_smoke_attention_tolerance_rejects_planted_causal_faults(monkeypatch):
    """The chip smoke holds B4/B5 to their plain versions row by row. At the
    main path's prefill shape, its planted faults (a late K/V tile or a
    late row's own key mis-weighted) must fail that check; here the plain
    version's faulty outputs are built on the CPU."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    gen = torch.Generator().manual_seed(5)
    chip_smoke._planted_faults(
        lambda *shape, dtype=torch.float32: torch.randn(shape, generator=gen).to(dtype))


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


def test_examples_default_to_cuda():
    """Every example twin runs on the GPU unless ``--device`` says otherwise:
    without CUDA its ``main`` raises before any work."""
    import importlib
    names = sorted(p.stem for p in (PORT / "examples").glob("*.py") if p.stem != "__init__")
    assert names == ["quickstart", "serve_guided", "train_lm", "window_sweep"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise here")
    for name in names:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([])
