"""The port's checkpoint io against the reference's: round trips, each
side reading what the other wrote, the manifest codec against the
``msgpack`` package (which the port does not import), and the SD
pipeline's checkpoint in the reference's tree layout. Exact throughout: the
leaves are the same numpy bytes and the manifest the same msgpack bytes."""

import ast
import sys
from pathlib import Path

import jax
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.configs.base import UNetConfig as JUNetConfig
from repro.core.pipeline import SDPipeline as JPipe
from repro_torch import convert
from repro_torch.checkpoint import io
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import UNetConfig
from repro_torch.core.pipeline import SDPipeline
from repro_torch.train import diffusion as TD

ROOT = Path(__file__).resolve().parents[1]
# what the port may import beside the standard library: the packages the
# GPU machine has
ALLOWED = {"torch", "numpy", "scipy", "einops", "triton", "repro_torch"}


def _tree(gen):
    r = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    return {"w": r(3, 4), "layers": [{"a": r(5), "b": None}, None, (r(2, 2), r(1))],
            "ids": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "mask": torch.tensor([True, False]), "count": torch.tensor(7, dtype=torch.int32)}


def _assert_same(a, b):
    """a: the port's tree of tensors; b: a tree of tensors or arrays."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif a is None:
        assert b is None
    else:
        y = np.asarray(b)
        x = a.numpy()
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("small_shards", [False, True], ids=["one_shard", "shards"])
def test_round_trip(tmp_path, monkeypatch, small_shards):
    if small_shards:
        monkeypatch.setattr(io, "_SHARD_BYTES", 40)
    tree = _tree(torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path), tree, step=12, extra={"note": "x", "n": -3, "ok": True})
    shards = list(tmp_path.glob("shard_*.npz"))
    assert len(shards) > 1 if small_shards else len(shards) == 1
    back, step, extra = load_checkpoint(str(tmp_path), device="cpu")
    assert step == 12 and extra == {"note": "x", "n": -3, "ok": True}
    _assert_same(back, tree)


def test_each_side_reads_the_other(tmp_path):
    tree = _tree(torch.Generator().manual_seed(1))
    save_checkpoint(str(tmp_path / "port"), tree, step=3, extra={"by": "port"})
    jtree, step, extra = jload(str(tmp_path / "port"))
    assert step == 3 and extra == {"by": "port"}
    _assert_same(tree, jax.tree.map(np.asarray, jtree))

    ref = {"p": {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "none": None},
           "seq": [np.int32(4) * np.ones(3, np.int32), (np.zeros(2, np.int64),)]}
    jsave(str(tmp_path / "ref"), ref, step=9, extra={"lr": "2e-3"})
    back, step, extra = load_checkpoint(str(tmp_path / "ref"), device="cpu")
    assert step == 9 and extra == {"lr": "2e-3"}
    _assert_same(back, ref)
    raw = (tmp_path / "ref" / "manifest.msgpack").read_bytes()
    assert io.packb(io.unpackb(raw)) == raw


def test_bfloat16_leaves_are_refused(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        save_checkpoint(str(tmp_path / "a"), {"w": torch.zeros(2, dtype=torch.bfloat16)})
    jsave(str(tmp_path / "b"), {"w": np.zeros(2, ml_dtypes.bfloat16)})
    with pytest.raises(TypeError, match="void"):
        load_checkpoint(str(tmp_path / "b"), device="cpu")


# -- the manifest codec ---------------------------------------------------------------

_INT = st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
_LEAF = st.none() | st.booleans() | _INT | st.text(max_size=300) | st.binary(max_size=300)
_TREE = st.recursive(
    _LEAF, lambda c: st.lists(c, max_size=20) | st.dictionaries(st.text(max_size=40), c,
                                                                  max_size=20),
    max_leaves=60)


@settings(max_examples=200, deadline=None)
@given(_TREE)
def test_codec_equals_msgpack_on_drawn_trees(obj):
    ref = msgpack.packb(obj, use_bin_type=True)
    assert io.packb(obj) == ref
    assert io.unpackb(ref) == msgpack.unpackb(ref, raw=False)
    assert msgpack.unpackb(io.packb(obj), raw=False) == msgpack.unpackb(ref, raw=False)


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_codec_length_boundaries(n):
    for obj in ("x" * n, b"y" * n, list(range(min(n, 70000))),
                {str(i): i for i in range(min(n, 70000))}):
        ref = msgpack.packb(obj, use_bin_type=True)
        assert io.packb(obj) == ref
        assert io.unpackb(ref) == msgpack.unpackb(ref, raw=False)
    for v in (n, -n, 2 ** 32 + n, -(2 ** 31) - n, 2 ** 64 - 1 - n, -(2 ** 63) + n):
        assert io.packb(v) == msgpack.packb(v)
        assert io.unpackb(msgpack.packb(v)) == v


def test_codec_refuses_what_the_manifest_never_holds():
    with pytest.raises(TypeError):
        io.packb(1.5)
    with pytest.raises(OverflowError):
        io.packb(2 ** 64)
    with pytest.raises(ValueError, match="subset"):
        io.unpackb(msgpack.packb(1.5))
    with pytest.raises(ValueError, match="after"):
        io.unpackb(msgpack.packb(1) + b"\x01")


# -- the SD pipeline in the reference's layout -------------------------------------------


def test_pipeline_checkpoint_is_the_references_layout(tmp_path):
    cfg = UNetConfig().reduced()
    pipe = SDPipeline.init(cfg, 3, device="cpu")
    TD.save_pipeline(str(tmp_path / "port"), pipe, step=5)
    jtree, step, _ = jload(str(tmp_path / "port"))
    assert step == 5
    shapes = jax.eval_shape(lambda k: JPipe.init(JUNetConfig().reduced(), k).params,
                            jax.random.PRNGKey(0))
    assert jax.tree.structure(jtree["params"]) == jax.tree.structure(shapes)
    for a, s in zip(jax.tree.leaves(jtree["params"]), jax.tree.leaves(shapes)):
        assert a.shape == s.shape and a.dtype == s.dtype
    # converted back, the reference's tree is the pipeline's state bit for bit
    state = convert.from_jax_params(jax.tree.map(np.asarray, jtree["params"]))
    for module, name in ((pipe.unet, "unet"), (pipe.text, "text")):
        mine = module.state_dict()
        assert set(mine) == set(state[name])
        for k, t in mine.items():
            assert torch.equal(t, state[name][k]), k

    # the reference's own checkpoint of that tree, as trained_pipeline writes it
    jsave(str(tmp_path / "ref"), {"params": jtree["params"]}, step=400)
    back = TD.load_pipeline(str(tmp_path / "ref"), cfg, device="cpu")
    for a, b in ((pipe.unet, back.unet), (pipe.text, back.text)):
        for (k, x), (k2, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert k == k2 and torch.equal(x, y), k


def test_port_imports_nothing_beyond_the_gpu_machines_packages():
    """No ``msgpack`` and nothing outside the standard library, torch,
    numpy, scipy, einops and triton."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {node.module.split(".")[0]}
            else:
                continue
            bad = roots - ALLOWED - set(sys.stdlib_module_names)
            assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
