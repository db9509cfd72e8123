"""The port's step builders and dry-run (``repro_torch.launch.steps``,
``launch.dryrun``) against the reference's ``repro.launch.steps``, on the
CPU and the meta device:

* ``param_count``, ``model_flops``, ``recurrent_supplement`` and the skip
  matrix equal the reference's exactly, for every arch and shape;
* every (arch x shape) bundle at full size holds the reference's bytes in
  every argument: parameters (float32 for training, bf16 otherwise),
  caches, optimizer state and inputs, against the reference's
  ``SpecMaker`` trees built on a one-device host mesh; the donated indices
  and names are the reference's;
* ``run_one`` on meta is ``ok`` for llama3.2-1b and xlstm-350m at all four
  shapes at full size, and its FLOP count of llama's ``serve_full`` agrees
  with ``repro_torch.roofline.decode_step``'s within 1%;
* ``materialize`` gives each bundle real arguments of its specs' shapes
  and dtypes (weights the models' own init draws from the generator, as
  ``Transformer.init`` does; caches zero, ring slots empty), on which the
  step runs on the CPU at reduced configs to finite outputs;
* the meta rule: meta tensors take the plain versions, CUDA tensors never
  do, a CPU/meta mix raises; ``time_scan`` on meta steps once.
"""

import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist
from repro.launch import steps as JST
from repro.launch.mesh import make_host_mesh
from repro_torch import roofline as RL
from repro_torch.configs import SHAPES, InputShape, get_config, get_smoke_config, list_archs
from repro_torch.dist import MeshShape
from repro_torch.kernels import build as KB
from repro_torch.kernels import rmsnorm as KR
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as ST
from repro_torch.models import layers as L
from repro_torch.models import xlstm as XL
from repro_torch.models.transformer import Transformer

@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh()


def test_shapes_and_archs_are_the_reference():
    assert {k: vars(v) for k, v in SHAPES.items()} == {k: vars(v) for k, v in JSHAPES.items()}
    assert list_archs() == jlist()


@pytest.mark.parametrize("arch", list_archs())
def test_arithmetic_equals_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert ST.param_count(cfg) == JST.param_count(jcfg)
    assert ST.supports_long_context(cfg) == JST.supports_long_context(jcfg)
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        assert ST.skip_reason(cfg, shape) == JST.skip_reason(jcfg, jshape)
        assert ST.model_flops(cfg, shape) == JST.model_flops(jcfg, jshape)
        assert ST.recurrent_supplement(cfg, shape) == JST.recurrent_supplement(jcfg, jshape)


def _jbytes(tree) -> int:
    return sum(math.prod(x.shape) * np.dtype(x.dtype).itemsize for x in jax.tree.leaves(tree))


def _dtypes(tree) -> dict:
    """Bytes by dtype name of either side's spec tree."""
    out = {}
    for x in ST.leaves(tree) or jax.tree.leaves(tree):
        if isinstance(x, torch.Tensor):
            name, n = str(x.dtype).replace("torch.", ""), x.numel() * x.element_size()
        else:
            name, n = np.dtype(x.dtype).name, math.prod(x.shape) * np.dtype(x.dtype).itemsize
        out[name] = out.get(name, 0) + n
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_bundle_bytes_equal_the_reference(arch, mesh):
    """Each argument of each bundle: the same bytes of each dtype."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in SHAPES.items():
        if ST.skip_reason(cfg, shape):
            with pytest.raises(ValueError, match="skipped"):
                ST.build(cfg, shape, None)
            continue
        variants = ("full", "cond") if shape.kind == "decode" else ("full",)
        for variant in variants:
            b = ST.build(cfg, shape, None, variant=variant)
            jb = JST.build(jcfg, JSHAPES[name], mesh, variant=variant)
            assert b.name == jb.name and b.donate == jb.donate
            assert len(b.in_specs) == len(jb.in_specs), b.name
            for i, (x, jx) in enumerate(zip(b.in_specs, jb.in_specs)):
                assert _dtypes(x) == _dtypes(jx), (b.name, i)
            assert ST.tree_bytes(b.in_specs) == _jbytes(jb.in_specs)
            assert b.in_shardings is None and b.rules is None


@pytest.mark.parametrize("variant", ["full", "cond"])
def test_sd_bundle_bytes_equal_the_reference(variant, mesh):
    b = ST.build_sd_denoise(None, variant=variant)
    jb = JST.build_sd_denoise(mesh, variant=variant)
    assert b.name == jb.name and b.donate == jb.donate
    for i, (x, jx) in enumerate(zip(b.in_specs, jb.in_specs)):
        assert _dtypes(x) == _dtypes(jx), (b.name, i)


def test_a_mesh_raises_naming_the_sharding_slice():
    """The sharding slice is ported: a mesh builds every bundle with its
    layouts, and the dry-run takes ``--mesh`` and ``--multi-pod``; only a
    card run of a sharded record is refused (one card runs one device's
    step unsharded)."""
    cfg = get_config("llama3.2-1b")
    mesh = MeshShape((16, 16), ("data", "model"))
    for b in (ST.build(cfg, SHAPES["decode_32k"], mesh), ST.build_sd_denoise(mesh)):
        assert b.rules is not None and len(b.in_shardings) == len(b.in_specs)
    rec = DR.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--mesh", "data=1"])[0]
    assert rec["status"] == "ok" and rec["mesh"] == "data=1"
    with pytest.raises(SystemExit):
        DR.main(["--multi-pod", "--arch", "sd-unet", "--device", "cuda"])


@pytest.fixture(scope="module")
def meta_records():
    return {(a, s): DR.run_one(a, s, verbose=False)
            for a in ("llama3.2-1b", "xlstm-350m") for s in SHAPES}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "xlstm-350m"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_run_one_on_meta(meta_records, arch, shape, mesh):
    rec = meta_records[(arch, shape)]
    assert rec["status"] == "ok", rec.get("error")
    cfg = get_config(arch)
    b = ST.build(cfg, SHAPES[shape], None)
    jb = JST.build(jget_config(arch), JSHAPES[shape], mesh)
    assert rec["memory_analysis"]["argument_size"] == _jbytes(jb.in_specs)
    rl = rec["roofline"]
    assert rl["model_flops"] == JST.model_flops(jget_config(arch), JSHAPES[shape])
    supp = ST.recurrent_supplement(cfg, SHAPES[shape])
    assert rl["flops"] == rl["counted_flops"] + supp["flops"] > 0
    assert rl["dominant"] in ("compute", "memory") and rl["collective_s"] == 0.0
    assert rec["cards"] == max(1, math.ceil(ST.tree_bytes(b.in_specs) / 80e9))
    # the model's FLOPs are within a factor of the counted ones (the
    # reference's useful ratios run from ~0.4 to ~1.1 on these shapes)
    assert 0.3 < rl["useful_ratio"] < 1.3, rl["useful_ratio"]


def test_serve_flops_agree_with_the_roofline(meta_records):
    """llama3.2-1b's FULL step at decode_32k: FlopCounterMode's matmuls
    and attention products against ``roofline.decode_step``'s count of the
    same step (two forwards of 128 rows over 32768 keys, the combine's 5
    FLOPs a logit, which the counter does not see): within 1%."""
    cfg, shape = get_config("llama3.2-1b"), SHAPES["decode_32k"]
    B = shape.global_batch
    counted = meta_records[("llama3.2-1b", "decode_32k")]["roofline"]["counted_flops"]
    model = ST.param_specs(cfg, dtype=torch.bfloat16)[0]
    want = RL.decode_step(cfg, forwards=(B, B), kv_tokens=shape.seq_len,
                          weight_bytes=ST.tree_bytes(model), out_rows=B).flops
    assert abs(counted / want - 1) < 0.01, (counted, want)


def test_cond_records_count_one_stream(meta_records):
    """A decode step's ``cond`` record counts one stream of useful FLOPs,
    half of what ``model_flops`` gives the FULL step; its counted FLOPs
    are about half the FULL step's too, so the useful ratio stays put."""
    full = meta_records[("xlstm-350m", "decode_32k")]["roofline"]
    cond = DR.run_one("xlstm-350m", "decode_32k", variant="cond", verbose=False)
    assert cond["status"] == "ok", cond.get("error")
    rl = cond["roofline"]
    assert rl["model_flops"] == full["model_flops"] / 2
    assert abs(rl["useful_ratio"] / full["useful_ratio"] - 1) < 0.05, (rl, full)


def test_the_dry_run_cli_summary(tmp_path, capsys):
    out = tmp_path / "r.jsonl"
    recs = DR.main(["--arch", "hubert-xlarge", "--out", str(out)])
    assert [r["status"] for r in recs] == ["ok", "ok", "skipped", "skipped"]
    assert len(out.read_text().splitlines()) == 4
    assert "dry-run summary: 2 ok, 2 skipped, 0 errors of 4" in capsys.readouterr().out
    sd = DR.run_sd(variant="cond", verbose=False)
    assert sd["status"] == "ok" and sd["roofline"]["flops"] > 0
    assert sd["memory_analysis"]["argument_size"] == ST.tree_bytes(
        ST.build_sd_denoise(None, variant="cond").in_specs)


def test_meta_takes_the_plain_versions_and_a_mix_raises():
    meta = torch.empty(4, 64, device="meta", dtype=torch.bfloat16)
    cpu = torch.ones(4, 64, dtype=torch.bfloat16)
    assert KB.on_cuda(meta) is False and KB.on_cuda(meta, meta) is False
    assert KB.on_cuda(cpu) is False
    with pytest.raises(ValueError, match="need all on the CPU"):
        KB.on_cuda(meta, cpu)
    KR.reset_launches()
    y = KR.rmsnorm(meta, torch.empty(64, device="meta", dtype=torch.bfloat16), 1e-6)
    assert y.is_meta and y.shape == meta.shape and y.dtype == meta.dtype
    assert sum(KR.LAUNCHES.values()) == 0
    spec = L.SpecMaker(torch.float32)((3, 5), ("embed", "mlp"), init="ones")
    assert spec.is_meta and spec.shape == (3, 5) and spec.dtype == torch.float32


def test_time_scan_steps_once_on_meta():
    calls = []

    def step(state, x):
        calls.append(1)
        (h,) = state
        h = h + x[0]
        return (h,), h * 2

    x = torch.empty(2, 4096, 8, device="meta")
    state, ys = XL.time_scan(step, (torch.empty(2, 8, device="meta"),), (x,))
    assert len(calls) == 1 and ys.shape == (2, 4096, 8) and state[0].shape == (2, 8)
    xc = torch.randn(2, 5, 8)
    calls.clear()
    state, ys = XL.time_scan(step, (torch.zeros(2, 8),), (xc,))
    assert len(calls) == 5
    torch.testing.assert_close(state[0], xc.sum(1))
    torch.testing.assert_close(ys, 2 * xc.cumsum(1))


@pytest.mark.parametrize("arch,shape", [
    ("llama3.2-1b", InputShape("long_500k", 96, 1, "decode")),     # rings of 64 under 96
    ("xlstm-350m", InputShape("decode_small", 16, 2, "decode")),
    ("mixtral-8x7b", InputShape("train_small", 16, 2, "train")),
    ("hubert-xlarge", InputShape("prefill_small", 16, 2, "prefill")),
    ("sd-unet", None),
])
def test_materialize_runs_the_step(arch, shape, monkeypatch):
    if arch == "sd-unet":
        import repro_torch.configs.sd_unet as tsd
        monkeypatch.setattr(tsd, "PRODUCTION", tsd.CONFIG.reduced())
        b = ST.build_sd_denoise(None, variant="full", batch=2)
        high = 1000
    else:
        cfg = get_smoke_config(arch)
        b = ST.build(cfg, shape, None)
        high = cfg.vocab_size
    specs = [(t.shape, t.dtype) for t in ST.leaves(b.in_specs)]
    nbytes = ST.tree_bytes(b.in_specs)
    args = ST.materialize(b, torch.Generator().manual_seed(0), "cpu", high=high)
    assert [(t.shape, t.dtype) for t in ST.leaves(args)] == specs
    # the weights are the models' own init, drawn first from the generator
    dtype = next(b.in_specs[0].parameters()).dtype
    own = b.init(L.Maker(torch.Generator().manual_seed(0), dtype, "cpu")).state_dict()
    got = args[0].state_dict()
    assert got.keys() == own.keys() and all(torch.equal(got[k], own[k]) for k in own)
    if arch != "sd-unet":
        want = Transformer.init(cfg, torch.Generator().manual_seed(0), dtype=dtype,
                                device="cpu").state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert ST.tree_bytes(args) == nbytes and not any(t.is_meta for t in ST.leaves(args))
    for i in b.donate[1:] if arch != "sd-unet" else ():
        for t in ST.leaves(args[i]):
            assert not t.any() or t.dtype == torch.int32, "caches and states start zero"
    rings = [c["slot_pos"] for i in b.donate for c in args[i] if isinstance(c, dict)
             and "slot_pos" in c] if shape is not None and shape.kind == "decode" else []
    assert all((r == -1).all() for r in rings)
    if shape is not None and shape.name == "long_500k":
        assert rings, "the SWA substitute's rings"
    out = b.fn(*args)
    floats = [t for t in ST.leaves(out) if t.dtype.is_floating_point]
    assert floats and all(torch.isfinite(t).all() for t in floats)
