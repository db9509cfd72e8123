"""The port's sharding layer (``repro_torch.dist``, ``launch/mesh.py``, the
axes of the init code, the step builders' layouts, the dry-run's per-device
bytes and the pooled arenas' specs) against the reference's, exactly:

* every architecture's parameter axes (and the UNet's, conv axes in the
  port's OIHW order) and its cache axes (linear, ring, ``long_ctx``, int8
  under ``REPRO_KV_QUANT``, paged bf16 and int8) equal the reference's
  ``AxesMaker`` trees key for key, the reference's scan segments unstacked
  (its leading ``layers`` name dropped) as ``convert.model_items`` does;
* the allocator: the reference's ``test_sharding.py`` and ``test_dist.py``
  cases, and a hypothesis property that ``logical_to_spec`` and
  ``sanitize_spec`` equal the reference's on random names, dims, meshes
  and rule tables;
* every (arch x shape) bundle and ``build_sd_denoise`` on ``MeshShape``
  (16, 16) and (2, 16, 16), with and without ``REPRO_RULE_OVERRIDE``: each
  argument's ``P`` equals the reference's ``NamedSharding.spec`` leaf for
  leaf (specs of stacked leaves with their ``layers`` entry dropped, UNet
  conv specs permuted HWIO -> OIHW), and the arguments' per-device bytes
  (``local_shape``) equal the sum of the reference's ``shard_shape`` bytes;
* the slot and paged pools' specs and the pages axis' shard count equal
  the reference's, and the engine's default page count on a (2, 4, 2) mesh
  rounds as the reference engine's does;
* on a one-rank gloo mesh the engine's pools are DTensors sharded on their
  first dim, sharing storage with the tensors the steps write, and it
  serves what the meshless engine serves; two gloo processes distribute a
  reduced llama's parameters and paged pool by the port's placements, each
  rank's shard has ``local_shape``'s shape, and they gather back equal.
"""

import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.configs.sd_unet import PRODUCTION as JUCFG
from repro.dist import compat
from repro.dist import sharding as JS
from repro.launch import steps as JST
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models import unet as JU
from repro.serve import ContinuousEngine as JEngine
from repro.serve import state as JSTATE
from repro_torch import convert
from repro_torch.configs import SHAPES, get_config, get_smoke_config, list_archs
from repro_torch.configs.sd_unet import PRODUCTION as UCFG
from repro_torch.dist import (RULES_LONG, RULES_SERVE, RULES_TRAIN, AxisRule, MeshShape, P,
                              constrain, local_shape, logical_to_spec, sanitize_spec,
                              spec_placements, tree_shardings)
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import chips, make_host_mesh, make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import unet as U
from repro_torch.serve import ContinuousEngine, ServeRequest
from repro_torch.serve import state as S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
OVERRIDE = "state=;kv_seq=model,data"
RULES = {"serve": (RULES_SERVE, JS.RULES_SERVE), "train": (RULES_TRAIN, JS.RULES_TRAIN),
         "long": (RULES_LONG, JS.RULES_LONG)}
STATE_NAMES = {3: ("C", "n", "m"), 4: ("c", "n", "m", "h")}   # mLSTM, sLSTM tuples


@pytest.fixture
def one_thread():
    """Tiny ops run fastest on one torch thread, and steadiest beside the
    other test workers' thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(name):
    shape, names = MESHES[name]
    return MeshShape(shape, names), compat.abstract_mesh(shape, names)


# -- the reference's trees as the port's keys ----------------------------------------


def _flat(tree, prefix=""):
    """(dotted path, leaf) of a dict/list/tuple tree; tuples of names, ``P``s
    and the reference's ``PartitionSpec``s are leaves, ``None`` entries have
    none."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _trim(entries):
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _ref_stack_items(tree, shapes, *, stacked_leaf, prefix="layers."):
    """(port key, leaf) of the reference's ``segments`` list: a plain
    segment is one layer, a scanned one (a list of the pattern's blocks,
    leaves with a leading ``layers`` dim of n) n groups of them, as
    ``convert.model_items`` unstacks them. ``stacked_leaf(leaf)`` gives a
    stacked leaf's per-layer form; tuple containers (xLSTM states) get the
    port's state names."""
    def named(block):
        if isinstance(block, tuple) and not _is_leaf(block):
            return dict(zip(STATE_NAMES[len(block)], block))
        return block

    def leaves(block):
        block = named(block)
        if isinstance(block, dict):
            for k, v in block.items():
                for kk, leaf in leaves(v):
                    yield (f"{k}.{kk}" if kk else k), leaf
        else:
            yield "", block

    layer = 0
    for seg, sseg in zip(tree, shapes):
        if not isinstance(seg, list):
            for k, leaf in leaves(seg):
                yield f"{prefix}{layer}.{k}", leaf
            layer += 1
            continue
        first = next(leaf for _, leaf in leaves(sseg[0]))
        n = first.shape[0]
        for j, block in enumerate(seg):
            for k, leaf in leaves(block):
                for i in range(n):
                    yield f"{prefix}{layer + i * len(seg) + j}.{k}", stacked_leaf(leaf)
        layer += n * len(seg)


def _is_leaf(x):
    """A leaf of the reference's trees: a sharding, a spec, a tuple of names
    or a shape struct (a tuple of them is an xLSTM state)."""
    from jax.sharding import PartitionSpec as JP
    return hasattr(x, "spec") or hasattr(x, "shape") or isinstance(x, JP) or JL.is_axes_leaf(x)


def _ref_model_items(tree, shapes, *, stacked_leaf):
    for key, leaf in _flat({k: v for k, v in tree.items() if k != "segments"}):
        yield key, leaf
    yield from _ref_stack_items(tree["segments"], shapes["segments"], stacked_leaf=stacked_leaf)


def _spec_entries(leaf):
    """A reference ``NamedSharding`` (or spec) as a tuple of entries."""
    spec = leaf.spec if hasattr(leaf, "spec") else leaf
    return tuple(spec)


def _unstack_spec(leaf):
    return _trim(_spec_entries(leaf)[1:])


def _ref_param_specs(sh_tree, spec_tree):
    return {k: _trim(_spec_entries(v)) for k, v in _ref_model_items(
        sh_tree, spec_tree, stacked_leaf=lambda e: P(*_unstack_spec(e)))}


def _ref_cache_items(tree, shapes, stacked_leaf):
    return dict(_ref_stack_items(tree, shapes, stacked_leaf=stacked_leaf, prefix=""))


def _hwio_to_oihw(entries, rank):
    entries = tuple(entries) + (None,) * (rank - len(entries))
    return (entries[3], entries[2], entries[0], entries[1]) if rank == 4 else entries


# -- axes ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_param_axes_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = ST.flat_axes(T.init_model(cfg, L.AxesMaker()))
    jaxes = JT.init_model(jcfg, JL.AxesMaker())
    jspecs = JT.init_model(jcfg, JL.SpecMaker(jnp.bfloat16))

    def stacked(axes):
        assert axes[0] == "layers", axes
        return axes[1:]

    want = dict(_ref_model_items(jaxes, jspecs, stacked_leaf=stacked))
    assert got == want
    model = ST.param_specs(cfg, dtype=torch.bfloat16)[0]
    assert set(got) == {k for k, _ in model.named_parameters()}
    for k, p in model.named_parameters():
        assert len(got[k]) == p.ndim, k


@pytest.mark.parametrize("ucfg", ["production", "reduced"])
def test_unet_axes_equal_the_reference(ucfg):
    cfg, jcfg = (UCFG, JUCFG) if ucfg == "production" else (UCFG.reduced(), JUCFG.reduced())
    got = ST.flat_axes(U.init_unet(cfg, L.AxesMaker()))
    want = {k: _hwio_to_oihw(a, len(a)) for k, a in _flat(JU.init_unet(jcfg, JL.AxesMaker()))}
    assert got == want


def _cache_case_ids():
    out = []
    for arch in list_archs():
        cfg = get_config(arch)
        if cfg.is_encoder:
            continue
        out += [(arch, "decode_32k"), (arch, "long_500k")]
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch,shape", _cache_case_ids())
def test_cache_axes_equal_the_reference(arch, shape, quant, monkeypatch):
    """Linear caches, rings (windows under the capacity, ``long_ctx``'s SWA
    substitute), MLA latents and recurrent states; int8 linear caches under
    the knob."""
    if quant:
        monkeypatch.setenv("REPRO_KV_QUANT", "int8")
    cfg, jcfg, s = get_config(arch), jget_config(arch), SHAPES[shape]
    long_ctx = shape == "long_500k"
    got = dict(_flat(T.cache_axes(cfg, s.seq_len, long_ctx=long_ctx)))
    jaxes = JT.cache_specs(jcfg, JL.AxesMaker(), 1, s.seq_len, long_ctx=long_ctx)
    jspecs = JT.cache_specs(jcfg, JL.SpecMaker(jnp.bfloat16), 1, s.seq_len, long_ctx=long_ctx)
    want = _ref_cache_items(jaxes, jspecs, stacked_leaf=lambda a: a[1:])
    assert got == want
    specs = T.cache_specs(cfg, 1, s.seq_len, long_ctx=long_ctx, device="meta")
    assert {k: t.ndim for k, t in _flat(specs)} == {k: len(a) for k, a in got.items()}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b", "h2o-danube-3-4b"])
def test_paged_cache_axes_equal_the_reference(arch, kv_dtype):
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = dict(_flat(T.paged_cache_axes(cfg, kv_dtype=kv_dtype)))
    jaxes = JT.paged_cache_specs(jcfg, JL.AxesMaker(), 8, 4, kv_dtype=kv_dtype)
    jspecs = JT.paged_cache_specs(jcfg, JL.SpecMaker(jnp.bfloat16), 8, 4, kv_dtype=kv_dtype)
    assert got == _ref_cache_items(jaxes, jspecs, stacked_leaf=lambda a: a[1:])
    with pytest.raises(ValueError, match="paged KV arena"):
        T.paged_cache_axes(get_config("xlstm-350m"))


def test_weights_are_drawn_as_before():
    """The maker takes axes now; what it draws is unchanged: the same
    generator order and values (the parity tests hold the models to the
    reference's draws by conversion; this holds the draw itself)."""
    cfg = get_smoke_config("llama3.2-1b")
    a = T.Transformer.init(cfg, torch.Generator().manual_seed(3), device="cpu").state_dict()
    gen = torch.Generator().manual_seed(3)
    want = torch.randn(tuple(a["embed.table"].shape), generator=gen) \
        * (1.0 / math.sqrt(cfg.d_model))
    assert torch.equal(a["embed.table"], want)


# -- the allocator -------------------------------------------------------------------

ALLOC_CASES = [
    # (names, rules, shape, mesh, expected): the reference's test_sharding.py
    # and test_dist.py cases
    (("embed", "heads", "head_dim"), "serve", (4096, 32, 128), "16x16", P(None, "model")),
    (("batch", "kv_seq", "kv_heads", "head_dim"), "serve", (128, 32768, 16, 64), "16x16",
     P("data", None, "model")),
    (("batch", "kv_seq", "kv_heads", "head_dim"), "serve", (128, 32768, 8, 64), "16x16",
     P("data", "model")),
    (("batch", "kv_seq", "kv_heads", "head_dim"), "serve", (128, 2048, 1, 256), "16x16",
     P("data", "model")),
    (("experts", "expert_embed", "mlp"), "serve", (64, 2048, 1408), "16x16", P("model")),
    (("experts", "expert_embed", "mlp"), "serve", (8, 4096, 14336), "16x16",
     P(None, None, "model")),
    (("embed", "mlp"), "train", (4096, 14336), "16x16", P("data", "model")),
    (("batch", "seq"), "serve", (128, 4096), "2x16x16", P(("pod", "data"))),
    (("batch", "kv_seq", "kv_heads", "head_dim"), "long", (1, 524288, 8, 128), "2x16x16",
     P(None, ("pod", "data", "model"))),
    (("vocab", "embed"), "serve", (504, 1280), "16x16", P()),
    (("batch", "seq", "vocab"), "train", (256, 4096, 151936), "16x16", P("data", None, "model")),
    ((None, "not_a_rule", "heads"), "serve", (8, 8, 32), "16x16", P(None, None, "model")),
    (("experts", "expert_embed", "mlp"), "train", (64, 2048, 1408), "16x16",
     P("model", "data")),
]


@pytest.mark.parametrize("names,rules,shape,mesh,want", ALLOC_CASES)
def test_allocator_cases(names, rules, shape, mesh, want):
    m, jm = _meshes(mesh)
    got = logical_to_spec(names, RULES[rules][0], shape=shape, mesh=m)
    assert got == want
    assert tuple(JS.logical_to_spec(names, RULES[rules][1], shape=shape, mesh=jm)) == tuple(want)


SANITIZE_CASES = [
    ((64, 64), ("model", "model"), P("model")),
    ((64, 64), ("expert", "model"), P(None, "model")),
    ((30, 64), ("data", "model"), P(None, "model")),
    ((32,), (("data", "model"),), P("data")),
]


@pytest.mark.parametrize("shape,spec,want", SANITIZE_CASES)
def test_sanitize_cases(shape, spec, want):
    m, jm = _meshes("16x16")
    assert sanitize_spec(shape, P(*spec), m) == want
    from jax.sharding import PartitionSpec as JP
    assert tuple(JS.sanitize_spec(shape, JP(*spec), jm)) == tuple(want)


def test_override_and_rank_errors():
    m, _ = _meshes("16x16")
    rules = RULES_SERVE.override(kv_seq=("data", "model"))
    assert rules.rule("kv_seq").axes == ("data", "model")
    assert rules.rule("kv_seq").priority == RULES_SERVE.rule("kv_seq").priority
    assert RULES_SERVE.rule("kv_seq").axes == ("model",)
    assert logical_to_spec(("batch", "kv_seq", "kv_heads", "head_dim"), rules,
                           shape=(1, 32768, 8, 64), mesh=m) == P(None, ("data", "model"))
    novel = RULES_SERVE.override(novel=("model",))
    assert novel.rule("novel") == AxisRule(("model",), novel.rule("novel").priority)
    assert logical_to_spec(("novel",), novel, shape=(64,), mesh=m) == P("model")
    with pytest.raises(ValueError, match="rank mismatch"):
        logical_to_spec(("batch",), RULES_SERVE, shape=(8, 8), mesh=m)
    with pytest.raises(ValueError, match="rank exceeds"):
        sanitize_spec((8,), P("data", "model"), m)
    spec = logical_to_spec(("batch", "kv_seq", "kv_heads", "head_dim"), RULES_SERVE,
                           shape=(128, 32768, 16, 64), mesh=m)
    assert sanitize_spec((128, 32768, 16, 64), spec, m) == spec
    assert local_shape((128, 32768, 16, 64), spec, m) == (8, 32768, 1, 64)
    assert P("data") == P("data") and P("data") != P("model") and P() == ()
    # the rule tables are the reference's, name for name
    for mine, ref in RULES.values():
        assert mine.name == ref.name
        assert {k: (v.axes, v.priority) for k, v in mine.table.items()} == \
            {k: (v.axes, v.priority) for k, v in ref.table.items()}


NAMES = ["batch", "kv_seq", "kv_heads", "head_dim", "embed", "mlp", "vocab", "heads",
         "experts", "expert_embed", "pages", "page", "seq", "state", "layers", "novel", None]
MESH_CHOICES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
                ((4, 2), ("data", "model")), ((1, 1), ("data", "model")),
                ((2, 4, 2), ("pod", "data", "model")), ((3, 8), ("data", "expert"))]
DIMS = st.one_of(st.integers(1, 4096), st.sampled_from([1, 2, 8, 16, 32, 48, 256, 512, 32768]))


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from(NAMES), min_size=1, max_size=5),
       st.lists(DIMS, min_size=5, max_size=5), st.sampled_from(sorted(RULES)),
       st.integers(0, len(MESH_CHOICES) - 1),
       st.lists(st.sampled_from([None, "data", "model", "pod", "expert", ("data", "model"),
                                 ("pod", "data"), ("model", "data")]), max_size=5))
def test_allocator_equals_the_reference(names, dims, rules, mesh_i, raw):
    shape = tuple(dims[: len(names)])
    sizes, axis_names = MESH_CHOICES[mesh_i]
    m, jm = MeshShape(sizes, axis_names), compat.abstract_mesh(sizes, axis_names)
    mine, ref = RULES[rules]
    got = logical_to_spec(tuple(names), mine, shape=shape, mesh=m)
    assert tuple(got) == tuple(JS.logical_to_spec(tuple(names), ref, shape=shape, mesh=jm))
    assert local_shape(shape, got, m) == tuple(
        d // math.prod(dict(zip(axis_names, sizes))[a]
                       for a in (e if isinstance(e, tuple) else (e,)) if e is not None)
        for d, e in zip(shape, tuple(got) + (None,) * (len(shape) - len(got))))
    from jax.sharding import PartitionSpec as JP
    raw = raw[: len(shape)]
    assert tuple(sanitize_spec(shape, P(*raw), m)) == \
        tuple(JS.sanitize_spec(shape, JP(*raw), jm))


def test_tree_shardings_and_constrain():
    cfg = get_config("llama3.2-1b")
    m, _ = _meshes("16x16")
    model = ST.param_specs(cfg, dtype=torch.bfloat16)[0]
    sh = ST.module_shardings(T.init_model(cfg, L.AxesMaker()), model, m, RULES_SERVE)
    assert set(sh) == {k for k, _ in model.named_parameters()}
    assert sh["layers.0.attn.wq"] == P(None, "model")
    x = torch.ones(4, 8)
    assert constrain(x, ("batch", "seq"), RULES_SERVE) is x
    assert constrain(x, ("batch", "seq"), None) is x
    mesh = make_host_mesh(device="cpu")
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    d = distribute_tensor(torch.arange(8.0).reshape(2, 4), mesh, (Replicate(), Replicate()))
    c = constrain(d, ("batch", "vocab"), RULES_SERVE)
    assert isinstance(c, DTensor) and c.placements == (Shard(0), Shard(1))
    assert torch.equal(c.full_tensor(), torch.arange(8.0).reshape(2, 4))
    assert spec_placements(P(("data", "model")), mesh) == (Shard(0), Shard(0))
    tree = tree_shardings({"a": ("batch", None)}, {"a": torch.empty(2, 3)}, mesh, RULES_SERVE)
    assert tree == {"a": (Shard(0), Replicate())}
    assert chips(mesh) == 1 and chips(make_production_mesh(multi_pod=True)) == 512


# -- the step builders' layouts ------------------------------------------------------


def _port_items(x, prefix=""):
    """(path, spec entries) of a port in_shardings tree; a model entry (a
    dict by parameter name) keeps its names as they are."""
    if isinstance(x, P):
        yield prefix[:-1], tuple(x)
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _port_items(v, f"{prefix}{k}.")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _port_items(v, f"{prefix}{i}.")


def _ref_arg_items(i, sh, specs, kind):
    """(path, spec entries) of the reference's argument i, in the port's
    keys: parameters and their optimizer moments unstacked, caches too."""
    if kind == "params":
        for k, v in _ref_param_specs(sh, specs).items():
            yield f"{i}.{k}", v
    elif kind == "unet":
        shapes = dict(_flat(specs))               # (jax.tree.map sorts the keys of sh)
        for k, v in _flat(sh):
            yield f"{i}.{k}", _trim(_hwio_to_oihw(_spec_entries(v), len(shapes[k].shape)))
    elif kind == "opt":
        for name in ("m", "v"):
            for k, v in _ref_param_specs(sh[name], specs[name]).items():
                yield f"{i}.{name}.{k}", v
        yield f"{i}.step", _trim(_spec_entries(sh["step"]))
    elif kind == "caches":
        for k, v in _ref_cache_items(sh, specs, stacked_leaf=lambda e: P(*_unstack_spec(e))
                                     ).items():
            yield f"{i}.{k}", _trim(_spec_entries(v))
    else:
        for k, v in _flat(sh):
            yield (f"{i}.{k}" if k else str(i)), _trim(_spec_entries(v))


def _arg_kinds(bundle):
    kinds = []
    for i, x in enumerate(bundle.in_specs):
        if i == 0:
            kinds.append("unet" if "denoise" in bundle.name else "params")
        elif isinstance(x, list):
            kinds.append("caches")
        elif isinstance(x, dict) and "m" in x:
            kinds.append("opt")
        else:
            kinds.append("plain")
    return kinds


def _bundle_cases():
    out = []
    for arch in list_archs():
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            if ST.skip_reason(cfg, shape):
                continue
            for v in (("full", "cond") if shape.kind == "decode" else ("full",)):
                out.append((arch, name, v))
    return out + [("sd-unet", "denoise", "full"), ("sd-unet", "denoise", "cond")]


def _check_bundle(arch, shape, variant, mesh_name):
    m, jm = _meshes(mesh_name)
    if arch == "sd-unet":
        b, jb = ST.build_sd_denoise(m, variant=variant), JST.build_sd_denoise(jm, variant=variant)
    else:
        b = ST.build(get_config(arch), SHAPES[shape], m, variant=variant)
        jb = JST.build(jget_config(arch), JSHAPES[shape], jm, variant=variant)
    assert b.name == jb.name and len(b.in_shardings) == len(jb.in_shardings)
    assert b.rules.name == jb.rules.name
    for i, kind in enumerate(_arg_kinds(b)):
        got = dict(_port_items(b.in_shardings[i], f"{i}."))
        got = {k: _trim(v) for k, v in got.items()}
        want = dict(_ref_arg_items(i, jb.in_shardings[i], jb.in_specs[i], kind))
        if kind == "plain" and not isinstance(b.in_specs[i], dict):
            got, want = {str(i): got[f"{i}"]}, {str(i): want[str(i)]}
        assert got == want, (b.name, i)
    # one device's argument bytes: local_shape against the reference's shard_shape
    jbytes = sum(math.prod(s.shard_shape(x.shape)) * np.dtype(x.dtype).itemsize
                 for s, x in zip(jax.tree.leaves(jb.in_shardings),
                                 jax.tree.leaves(jb.in_specs)))
    assert ST.local_bytes(b.in_specs, b.in_shardings, m) == jbytes, b.name
    # out_shardings: the serve steps' and the train step's mirror their inputs'
    if b.out_shardings is not None and jb.out_shardings is not None and arch != "sd-unet":
        assert len(b.out_shardings) == len(jb.out_shardings)


@pytest.mark.parametrize("override", [False, True], ids=["rules", "override"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_bundle_layouts_equal_the_reference(mesh_name, override, monkeypatch):
    if override:
        monkeypatch.setenv("REPRO_RULE_OVERRIDE", OVERRIDE)
    for arch, shape, variant in _bundle_cases():
        _check_bundle(arch, shape, variant, mesh_name)
    if override:
        assert ST.rules_for_shape(SHAPES["decode_32k"]).rule("kv_seq").axes == ("model", "data")
        assert ST.rules_for_shape(SHAPES["train_4k"]).rule("state").axes == ()


def test_the_one_device_path_is_unchanged():
    b = ST.build(get_config("llama3.2-1b"), SHAPES["decode_32k"], None)
    assert b.in_shardings is None and b.out_shardings is None and b.rules is None


def test_dry_run_records_one_device_of_the_mesh():
    rec = DR.run_one("llama3.2-1b", "decode_32k", mesh_spec="data,model=16,16", verbose=False)
    assert rec["status"] == "ok" and rec["mesh"] == "data,model=16,16"
    m, jm = _meshes("16x16")
    jb = JST.build(jget_config("llama3.2-1b"), JSHAPES["decode_32k"], jm)
    jbytes = sum(math.prod(s.shard_shape(x.shape)) * np.dtype(x.dtype).itemsize
                 for s, x in zip(jax.tree.leaves(jb.in_shardings),
                                 jax.tree.leaves(jb.in_specs)))
    rl = rec["roofline"]
    assert rec["memory_analysis"]["argument_size"] == jbytes
    assert rl["chips"] == 256
    assert rl["flops"] == rl["counted_flops"] / 256
    assert rl["model_flops"] == JST.model_flops(jget_config("llama3.2-1b"),
                                                JSHAPES["decode_32k"]) / 256
    one = DR.run_one("llama3.2-1b", "decode_32k", verbose=False)
    assert one["mesh"] == "1" and one["roofline"]["chips"] == 1
    assert abs(rl["useful_ratio"] - one["roofline"]["useful_ratio"]) < 1e-12
    pod = DR.run_one("xlstm-350m", "decode_32k", multi_pod=True, verbose=False)
    assert pod["status"] == "ok" and pod["mesh"] == "2x16x16" and pod["roofline"]["chips"] == 512


# -- the pooled arenas ---------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", list(MESHES) + ["2x4x2"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-lite-16b", "xlstm-350m",
                                  "h2o-danube-3-4b"])
def test_pool_specs_equal_the_reference(arch, mesh_name):
    """The slot arena's specs (the reference's pool leaf has an interior
    batch-1 dim, which the port's rows replace: its entry, always None, is
    dropped), the paged pool's, and the pages shard count."""
    if mesh_name == "2x4x2":
        m, jm = MeshShape((2, 4, 2), ("pod", "data", "model")), \
            compat.abstract_mesh((2, 4, 2), ("pod", "data", "model"))
    else:
        m, jm = _meshes(mesh_name)
    cfg, jcfg = get_config(arch), jget_config(arch)
    cap = 4096
    for mine, ref in RULES.values():
        got = dict(_flat(S.pool_partition_specs(cfg, 16, cap, rules=mine, mesh=m)))
        jspec = JSTATE.pool_partition_specs(jcfg, 16, cap, rules=ref, mesh=jm)
        jaxes = JT.cache_specs(jcfg, JL.AxesMaker(), 1, cap)
        jshapes = JT.cache_specs(jcfg, JL.SpecMaker(jnp.bfloat16), 1, cap)
        spec_items = _ref_cache_items(jspec, jshapes, stacked_leaf=lambda e: e)
        axes_items = _ref_cache_items(jaxes, jshapes, stacked_leaf=lambda a: a)
        want = {}
        for k, e in spec_items.items():
            a = axes_items[k]
            e = tuple(e) + (None,) * (len(a) + 1 - len(e))     # pooled: slot axis + a
            drop = [j + 1 for j, n in enumerate(a) if n in ("layers", "batch")]
            assert all(e[j] is None for j in drop), (k, e)
            want[k] = _trim(x for j, x in enumerate(e) if j not in drop)
        assert {k: _trim(v) for k, v in got.items()} == want, (arch, mine.name)
        assert S.pages_shard_count(mine, m) == JSTATE.pages_shard_count(ref, jm)
        assert S.pages_shard_count(mine, None) == 1
        if T.ATTN[0] in cfg.blocks and cfg.mla is None and set(cfg.blocks) <= set(T.ATTN):
            for kv_dtype in ("bf16", "int8"):
                got = dict(_flat(S.paged_partition_specs(cfg, 64, 8, rules=mine, mesh=m,
                                                         kv_dtype=kv_dtype)))
                jsp = JSTATE.paged_partition_specs(jcfg, 64, 8, rules=ref, mesh=jm,
                                                   kv_dtype=kv_dtype)
                jsh = JT.paged_cache_specs(jcfg, JL.SpecMaker(jnp.bfloat16), 64, 8,
                                           kv_dtype=kv_dtype)
                want = _ref_cache_items(jsp, jsh, stacked_leaf=_unstack_spec)
                assert {k: _trim(v) for k, v in got.items()} == \
                    {k: _trim(v) for k, v in want.items()}
    axes = S.pooled_cache_axes(cfg, cap)
    assert all(a[0] == "batch" for _, a in _flat(axes))


def test_the_engine_rounds_its_pages_as_the_reference(one_thread):
    """Sizes only: no pool is placed, so no weight is read."""
    jcfg, cfg = jget_smoke("llama3.2-1b"), get_smoke_config("llama3.2-1b")
    params = JT.init_model(jcfg, JL.SpecMaker(jnp.bfloat16))
    model = T.Transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    m = MeshShape((2, 4, 2), ("pod", "data", "model"))
    jm = compat.abstract_mesh((2, 4, 2), ("pod", "data", "model"))
    kw = dict(kv="paged", num_slots=3, prompt_len=8, max_new=6, page_size=8)
    eng, jeng = ContinuousEngine(model, cfg, mesh=m, **kw), JEngine(params, jcfg, mesh=jm, **kw)
    assert eng._pool_shards == jeng._pool_shards == 8
    assert eng.num_pages == jeng.num_pages and eng.num_pages % 8 == 0
    assert eng.num_pages > 2 * 3 * eng.nb_max           # rounded up
    assert eng.rules is RULES_SERVE
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng._init_paged_pool()


# -- real meshes ---------------------------------------------------------------------


@pytest.mark.parametrize("kv,kv_dtype", [("paged", "bf16"), ("paged", "int8"),
                                         ("slot", "bf16")])
def test_one_rank_mesh_engine_serves_as_the_meshless(kv, kv_dtype, one_thread):
    from torch.distributed.tensor import DTensor, Shard
    cfg = get_smoke_config("llama3.2-1b")
    model = T.Transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = make_host_mesh(device="cpu")
    kw = dict(kv=kv, num_slots=3, prompt_len=8, max_new=6, stop_on_eos=False, seed=0)
    if kv == "paged":
        kw.update(page_size=4, kv_dtype=kv_dtype, reservation="lazy")

    def reqs():
        return [ServeRequest(uid=f"m{i}", prompt=f"prompt {i} " * (1 + i % 3), max_new_tokens=6,
                             guidance_scale=3.0) for i in range(5)]

    eng = ContinuousEngine(model, cfg, mesh=mesh, **kw)
    out = eng.serve(reqs())
    ref = ContinuousEngine(model, cfg, **kw)
    assert out == ref.serve(reqs())
    assert eng.metrics.summary()["tokens"] == ref.metrics.summary()["tokens"]
    assert [e.kind for e in eng.metrics.trace] == [e.kind for e in ref.metrics.trace]
    pools = {"p": eng._pool_p} if kv == "paged" else {"c": eng._pool_c, "u": eng._pool_u}
    for name, pool in pools.items():
        for layer, placed in zip(pool, eng.placed[name]):
            for leaf, d in layer.items():
                assert isinstance(placed[leaf], DTensor)
                assert placed[leaf].placements[0] == Shard(0)
                assert placed[leaf].to_local().data_ptr() == d.data_ptr()


WORKER = textwrap.dedent("""
    import sys
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import RULES_SERVE, RULES_TRAIN, MeshShape, local_shape, tree_shardings
    from repro_torch.launch import steps as ST
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve import state as S

    rank, store_path = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2), rank=rank, world_size=2)
    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    shape = MeshShape((2, 1), ("data", "model"))
    cfg = get_smoke_config("llama3.2-1b")
    model = T.Transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    axes = T.init_model(cfg, L.AxesMaker())
    params = dict(model.named_parameters())
    placements = ST.module_shardings(axes, model, mesh, RULES_TRAIN)
    specs = ST.module_shardings(axes, model, shape, RULES_TRAIN)
    pool = T.paged_cache_specs(cfg, 8, 4, device="cpu")[0]
    pool = {n: t[:-1].normal_(generator=torch.Generator().manual_seed(1)) for n, t in pool.items()}
    pl = S.paged_pool_shardings(cfg, 8, 4, rules=RULES_SERVE, mesh=mesh)[0]
    sp = S.paged_partition_specs(cfg, 8, 4, rules=RULES_SERVE, mesh=shape)[0]
    split = 0
    for name, t, place, spec in [(k, params[k], placements[k], specs[k]) for k in params] + \\
            [(f"pool.{k}", pool[k], pl[k], sp[k]) for k in pool]:
        d = distribute_tensor(t.detach(), mesh, place)
        assert tuple(d.to_local().shape) == local_shape(t.shape, spec, shape), name
        split += d.to_local().numel() < t.numel()
        assert torch.equal(d.full_tensor(), t.detach()), name
    assert split > 0
    print("rank", rank, "ok", split)
    dist.destroy_process_group()
""")


def test_two_gloo_ranks_distribute_and_gather_back(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), store], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert " ok " in out
