"""The paged/ragged decode kernels' plain versions (B7-B10), int8 KV
quantization, the paged model path and the per-row-scale APG combine,
against the reference on the same numpy inputs, on the CPU.

Tolerances. float32 inputs: the plain versions against the Pallas kernels
(interpret mode) and ``kernels/ref.py``'s oracles within 2e-5, the
reference's own kernel-vs-oracle tolerance (sums in another order). bf16
inputs: the plain version rounds the scores and the weights to bf16 (the
reference's default paged path does), the Pallas kernels do not, so each
output row is held to 8 bf16 steps (2^-8) of its own max|out|, as the chip
smoke holds the CUDA kernels. Rows at phase 0 are exact zeros. Quantization
is bit-exact (same float32 ops, round half to even). The model path
against the reference's default (jnp gather) path: float32 within 1e-5,
bf16 within 8 bf16 steps of each row's max|out|; written pool pages within
1e-5 (float32) or two bf16 steps (bf16) of each value or of 1, int8 pages within one
quantization step where a product's last bit moves a value across a
rounding boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import cfg_combine as JC
from repro.kernels import paged_decode_attention as JP
from repro.kernels import quant as JQ
from repro.kernels import ref
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import cfg_combine as KC
from repro_torch.kernels import paged_decode_attention as KP
from repro_torch.kernels import quant as TQ
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT

BF16 = 2.0 ** -8
ROW_STEPS = 8
KERNELS = ["ragged_paged_decode_attention", "ragged_paged_decode_attention_int8",
           "paged_decode_attention", "paged_decode_attention_int8"]


def _case(seed, R=5, nb=3, ps=4, K=2, rep=2, hd=8, int8=False):
    """A random launch: positions over the table's span, entries in
    [0, P + 2) (padding columns and rows exercise the clamp), 30% of the
    rows at phase 0."""
    rng = np.random.default_rng(seed)
    P = R * nb + 2
    c = {"q": rng.standard_normal((R, K * rep, hd)).astype(np.float32),
         "bt": rng.integers(0, P + 2, size=(R, nb)).astype(np.int32),
         "pos": rng.integers(0, nb * ps, size=R).astype(np.int32),
         "phase": (rng.random(R) < 0.7).astype(np.int32)}
    c["phase"][0] = 0
    if int8:
        for n in ("k", "v"):
            c[n] = rng.integers(-127, 128, size=(P, ps, K, hd)).astype(np.int8)
            c[n + "s"] = (rng.random((P, ps, K, 1)) * 0.05 + 1e-3).astype(np.float32)
    else:
        for n in ("k", "v"):
            c[n] = rng.standard_normal((P, ps, K, hd)).astype(np.float32)
    return c


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _run_port(name, c, window=None, block_k=None, qdtype=torch.float32, pdtype=None):
    fn = getattr(KP, name)
    q = _t(c["q"], qdtype)
    pages = [_t(c["k"], pdtype), _t(c["v"], pdtype)]
    if name.endswith("int8"):
        pages = [pages[0], _t(c["ks"]), pages[1], _t(c["vs"])]
    args = [q, *pages, _t(c["bt"]), _t(c["pos"])]
    if name.startswith("ragged"):
        args.append(_t(c["phase"]))
    return fn(*args, window=window, block_k=block_k)


def _run_ref(name, c, window=None, block_k=None, qdtype=jnp.float32, pdtype=None):
    q = jnp.asarray(c["q"], qdtype)
    k = jnp.asarray(c["k"], pdtype) if pdtype is not None else jnp.asarray(c["k"])
    v = jnp.asarray(c["v"], pdtype) if pdtype is not None else jnp.asarray(c["v"])
    pages = [k, v] if not name.endswith("int8") else [k, jnp.asarray(c["ks"]), v,
                                                       jnp.asarray(c["vs"])]
    args = [q, *pages, jnp.asarray(c["bt"]), jnp.asarray(c["pos"])]
    oracle = "ref_" + name
    if name.startswith("ragged"):
        args.append(jnp.asarray(c["phase"]))
    pallas = getattr(JP, name + "_pallas")(*args, window=window, block_k=block_k,
                                           interpret=True)
    return np.asarray(pallas.astype(jnp.float32)), \
        np.asarray(getattr(ref, oracle)(*args, window=window).astype(jnp.float32))


def _rows_within(out, want, steps=ROW_STEPS):
    yard = np.abs(want).max(-1, keepdims=True)
    err = np.abs(out - want)
    assert np.all(err <= steps * BF16 * yard + 1e-30), (err / np.maximum(yard, 1e-30)).max()


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_pallas_and_oracle_f32(name, window, seed):
    c = _case(seed, int8=name.endswith("int8"))
    for bk in KP.block_k_candidates(4):
        out = _run_port(name, c, window, bk).numpy()
        pallas, oracle = _run_ref(name, c, window, bk)
        np.testing.assert_allclose(out, pallas, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(out, oracle, atol=2e-5, rtol=2e-5)
        if name.startswith("ragged"):
            assert not np.any(out[c["phase"] == 0])        # exact zeros
            assert np.any(out[c["phase"] == 1])


@pytest.mark.parametrize("name", KERNELS)
def test_plain_matches_pallas_bf16_row_by_row(name):
    c = _case(4, R=6, nb=4, ps=4, K=2, rep=4, hd=16, int8=name.endswith("int8"))
    int8 = name.endswith("int8")
    for window in (None, 5):
        out = _run_port(name, c, window, qdtype=torch.bfloat16,
                        pdtype=None if int8 else torch.bfloat16).float().numpy()
        pallas, oracle = _run_ref(name, c, window, qdtype=jnp.bfloat16,
                                  pdtype=None if int8 else jnp.bfloat16)
        _rows_within(out, pallas)
        _rows_within(out, oracle)
        if name.startswith("ragged"):
            assert not np.any(out[c["phase"] == 0])


def test_rows_independent_and_table_clamp():
    """A live row's output equals its own solo call, and entries past P
    read page P - 1 (the clamp), as in the oracle."""
    c = _case(7, R=5, nb=2)
    full = _run_port("ragged_paged_decode_attention", c).numpy()
    for r in np.flatnonzero(c["phase"]):
        solo = {k: (v[r:r + 1] if k in ("q", "bt", "pos", "phase") else v)
                for k, v in c.items()}
        np.testing.assert_allclose(full[r], _run_port("ragged_paged_decode_attention",
                                                      solo).numpy()[0], atol=1e-6)
    P = c["k"].shape[0]
    clamped = dict(c, bt=np.minimum(c["bt"], P - 1))
    np.testing.assert_array_equal(_run_port("paged_decode_attention", clamped).numpy(),
                                  _run_port("paged_decode_attention", c).numpy())


@pytest.mark.parametrize("name", KERNELS)
def test_block_k_must_divide_page_size(name):
    c = _case(5, int8=name.endswith("int8"))
    with pytest.raises(ValueError, match="block_k"):
        _run_port(name, c, block_k=3)
    assert KP.block_k_candidates(16) == [16, 8, 4]
    assert KP.block_k_candidates(4) == [4, 2, 1]


def test_wrappers_route_cpu_to_plain_and_refuse_other_devices():
    c = _case(3)
    KP.reset_launches()
    for name in KERNELS:
        c8 = _case(3, int8=True) if name.endswith("int8") else c
        assert _run_port(name, c8).device.type == "cpu"
    assert sum(KP.LAUNCHES.values()) == 0
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        KP.ragged_paged_decode_attention(z(2, 4, 8), z(3, 4, 2, 8), z(3, 4, 2, 8),
                                         z(2, 2, dt=torch.int32), z(2, dt=torch.int32),
                                         z(2, dt=torch.int32))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: a CUDA request would launch")
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|Torch not compiled"):
        KP.paged_decode_attention(torch.zeros(2, 4, 8, device="cuda"),
                                  torch.zeros(3, 4, 2, 8, device="cuda"),
                                  torch.zeros(3, 4, 2, 8, device="cuda"),
                                  torch.zeros(2, 2, dtype=torch.int32, device="cuda"),
                                  torch.zeros(2, dtype=torch.int32, device="cuda"))


def test_autotune_times_nothing_on_the_cpu():
    """The kernel has no sub-page tile: autotune picks whole pages without
    timing, and every candidate gives the whole-page output."""
    c = _case(5)
    assert KP.autotune_block_k(KP.block_k_candidates(4)) == 4
    with pytest.raises(ValueError):
        KP.autotune_block_k([])
    whole = _run_port("ragged_paged_decode_attention", c).numpy()
    for bk in KP.block_k_candidates(4):
        np.testing.assert_array_equal(
            _run_port("ragged_paged_decode_attention", c, block_k=bk).numpy(), whole)


def _adversarial(seed, case, shape=(4, 2, 16)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if case == "zeros":
        x[:] = 0.0
    elif case == "outlier":
        x[..., 3] *= 1e4
    elif case == "tiny":
        x *= 1e-30
    elif case == "halves":
        x = (np.round(x * 127) + 0.5).astype(np.float32) / 127.0
    return x


@pytest.mark.parametrize("case", ["normal", "zeros", "outlier", "tiny", "halves"])
def test_quantize_kv_equals_reference(case):
    for seed in range(3):
        x = _adversarial(seed, case)
        jv, js = JQ.quantize_kv(jnp.asarray(x))
        tv, ts = TQ.quantize_kv(torch.from_numpy(x))
        assert tv.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        back = TQ.dequantize_kv(tv, ts)
        np.testing.assert_array_equal(back.numpy(), np.asarray(JQ.dequantize_kv(jv, js)))
        bound = TQ.roundtrip_bound(torch.from_numpy(x))
        assert bool(((back - torch.from_numpy(x)).abs() <= bound).all())
        np.testing.assert_array_equal(bound.numpy(), np.asarray(JQ.roundtrip_bound(x)))
    assert TQ.EPS == JQ.EPS == 1e-20
    xb = torch.from_numpy(_adversarial(1, "normal")).to(torch.bfloat16)
    jv, js = JQ.quantize_kv(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    tv, ts = TQ.quantize_kv(xb)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# -- the model path ----------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jget_smoke("llama3.2-1b"), get_smoke_config("llama3.2-1b")
    params = JT.init_model(jcfg, JL.ArrayMaker(jax.random.PRNGKey(0)))
    model = TT.Transformer.from_state_dict(
        cfg, convert.from_jax_model_params(jax.tree.map(np.asarray, params)))
    return jcfg, cfg, params, model


def _pools(cfg, P, ps, kv_dtype, seed, dtype):
    """The same random history in a reference pool (P pages) and a port
    pool (P pages and the spare)."""
    rng = np.random.default_rng(seed)
    shape = (P, ps, cfg.num_kv_heads, cfg.resolved_head_dim)
    hist = {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
    jpool, tpool = {}, TA.paged_cache_spec(cfg, P, ps, kv_dtype=kv_dtype, dtype=dtype,
                                           device="cpu")
    for n in ("k", "v"):
        if kv_dtype == "int8":
            vals, scales = JQ.quantize_kv(jnp.asarray(hist[n]))
            jpool[n], jpool[n + "_scale"] = vals, scales
            tpool[n][:P] = _t(np.asarray(vals))
            tpool[n + "_scale"][:P] = _t(np.asarray(scales))
        else:
            jpool[n] = jnp.asarray(hist[n]).astype(
                jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
            tpool[n][:P] = _t(hist[n], dtype)
    return jpool, tpool


def _pool_equal(tpool, jpool, P, rtol):
    """Written pages equal up to ``rtol`` of each value or of the unit
    scale the history is drawn at (the K/V products' last bit); int8 values within one quantization step, on under 1% of
    them (a value near a rounding boundary)."""
    for name, leaf in jpool.items():
        got, want = tpool[name][:P].float().numpy(), np.asarray(leaf.astype(jnp.float32))
        if leaf.dtype == jnp.int8:
            assert np.abs(got - want).max() <= 1
            assert (got != want).mean() < 0.01
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("ragged", [False, True])
def test_attn_decode_paged_matches_reference(pair, kv_dtype, ragged):
    """One layer's attention, float32 activations: output within 1e-5 and
    the written pages equal (int8: within a quantization step)."""
    jcfg, cfg, params, model = pair
    jp = jax.tree.map(lambda a: a[0], params["segments"][0][0]["attn"])
    P, ps, B = 9, 4, 3
    jpool, tpool = _pools(cfg, P, ps, kv_dtype, 1, torch.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    bt = np.asarray([[0, 2, 9, 4], [5, 1, 3, 6], [9, 9, 9, 9]], np.int32)
    pos = np.asarray([6, 13, 0], np.int32)
    phase = np.asarray([1, 1, 0], np.int32) if ragged else None
    jout, jnew = JA.attn_decode_paged(jp, jcfg, jnp.asarray(x), jpool, jnp.asarray(bt),
                                      jnp.asarray(pos),
                                      phase=None if phase is None else jnp.asarray(phase))
    layer = model.layers[0].attn
    rope = model._rope(_t(pos)[:, None])
    tout, tnew = TA.attn_decode_paged(layer, cfg, _t(x), tpool, _t(bt), _t(pos), rope,
                                      phase=None if phase is None else _t(phase))
    want = np.asarray(jout)
    live = slice(None) if phase is None else phase == 1
    np.testing.assert_allclose(tout.numpy()[live], want[live], atol=1e-5, rtol=1e-5)
    _pool_equal(tnew, jnew, P, rtol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_decode_step_paged_matches_reference(pair, kv_dtype):
    """The whole stack in bf16, a ragged pass list with a padding row: the
    hidden states and each written K/V row (dequantized for int8) within 8
    bf16 steps of the row's max (int8: 10, two half quantization steps
    more), every other page position unchanged, so the padding row's write
    was dropped."""
    jcfg, cfg, params, model = pair
    P, ps = 10, 4
    jpools1, tpool1 = _pools(cfg, P, ps, kv_dtype, 3, torch.bfloat16)
    jpools = [[jax.tree.map(lambda a: jnp.stack([a] * cfg.num_layers), jpools1)]]
    tpools = [{k: v.clone() for k, v in tpool1.items()} for _ in range(cfg.num_layers)]
    toks = np.asarray([5, 77, 0], np.int32)
    bt = np.asarray([[3, 1, 4, 10], [2, 7, 5, 0], [10, 10, 10, 10]], np.int32)
    pos = np.asarray([9, 14, 0], np.int32)
    phase = np.asarray([1, 1, 0], np.int32)
    emb = JT.embed_tokens(params, jcfg, jnp.asarray(toks)[:, None])
    jh, jnew = JT.decode_step_paged(params, jcfg, emb, jpools, jnp.asarray(bt),
                                    jnp.asarray(pos), phase=jnp.asarray(phase))
    th, tnew = model.decode_step_paged(model.embed_tokens(_t(toks).long()[:, None]), tpools,
                                       _t(bt), _t(pos), phase=_t(phase))
    want = np.asarray(jh.astype(jnp.float32))[:2, 0]
    _rows_within(th.float().numpy()[:2, 0], want)
    written = [(4, 1), (0, 2)]                 # (page, offset) of the two live rows
    steps = 10 if kv_dtype == "int8" else ROW_STEPS
    for i in range(cfg.num_layers):
        jl = jax.tree.map(lambda a: np.asarray(a[i].astype(jnp.float32)), jnew[0][0])
        tl = {k: v[:P].float().numpy() for k, v in tnew[i].items()}
        for name in ("k", "v"):
            for page, off in written:
                got, ref_row = tl[name][page, off], jl[name][page, off]
                if kv_dtype == "int8":
                    got = got * tl[name + "_scale"][page, off]
                    ref_row = ref_row * jl[name + "_scale"][page, off]
                _rows_within(got, ref_row, steps)
        for name in tl:
            keep = np.ones(tl[name].shape[:2], bool)
            for page, off in written:
                keep[page, off] = False
            np.testing.assert_array_equal(tl[name][keep],
                                          tpool1[name][:P].float().numpy()[keep])
            np.testing.assert_array_equal(tl[name][keep], jl[name][keep])


def test_paged_scatter_prefill_drops_out_of_range():
    cfg = get_smoke_config("llama3.2-1b")
    for kv_dtype in ("bf16", "int8"):
        pool = TA.paged_cache_spec(cfg, 3, 2, kv_dtype=kv_dtype, device="cpu")
        cache = {n: torch.randn(1, 4, cfg.num_kv_heads, cfg.resolved_head_dim,
                                generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
                 for n in ("k", "v")}
        pages = torch.tensor([1, 1, 3, -1])
        TA.paged_scatter_prefill(pool, cache, pages, torch.tensor([0, 1, 0, 1]))
        real = TA.pool_view(pool)
        assert not bool(real["k"][0].any()) and not bool(real["k"][2].any())
        assert bool(real["k"][1].any())
        if kv_dtype == "bf16":
            assert torch.equal(real["k"][1], cache["k"][0, :2])


@pytest.mark.parametrize("eta,threshold", [(0.0, 0.0), (0.3, 0.0), (0.3, 2.0)])
def test_apg_per_row_scale_matches_reference(eta, threshold):
    rng = np.random.default_rng(9)
    u = rng.standard_normal((5, 300)).astype(np.float32)
    c = rng.standard_normal((5, 300)).astype(np.float32)
    u[2] = c[2]                                           # a self-paired row
    s = np.asarray([3.0, 1.0, 7.5, 2.0, 1.0], np.float32)
    want = np.asarray(JC.apg_combine_ref(jnp.asarray(u), jnp.asarray(c),
                                         jnp.asarray(s)[:, None], eta=eta,
                                         threshold=threshold))
    got = KC.apg_combine(_t(u), _t(c), _t(s), eta=eta, threshold=threshold).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(got[2], c[2])           # u == c returns c
    # the scalar form keeps its results: a vector of one scale equals it
    scalar = KC.apg_combine(_t(u), _t(c), 3.0, eta=eta, threshold=threshold)
    vector = KC.apg_combine(_t(u), _t(c), torch.full((5,), 3.0), eta=eta,
                            threshold=threshold)
    assert torch.equal(scalar, vector)
    with pytest.raises(ValueError, match="scales"):
        KC.apg_combine(_t(u), _t(c), torch.ones(4))
