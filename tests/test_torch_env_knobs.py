"""The reference's two model env knobs in the port, against the reference:

* ``REPRO_KV_QUANT=int8``: linear decode caches hold int8 values and bf16
  scales (one a position and kv head, amax floor 1e-6), quantized on the
  prefill cache after padding and on every decode write, read dequantized
  to the activation dtype. The values and scales are bit-equal to the
  reference's ``quantize_kv(..., scale_dtype=bf16, eps=1e-6)``; the caches'
  leaves and dtypes equal the reference's; ``guided_decode`` under the knob
  gives the reference's greedy tokens and teacher-forced logits within
  LOGIT_TOL of the largest logit, the bf16 caches' tolerance
  (``test_torch_ar_decode.py``): both sides dequantize the same int8 values
  with the same scales, so the knob adds no difference of its own; the
  slot arena serves under it as the reference's engine does. Rings and the
  paged pool ignore it.
* ``REPRO_BPTT_CHUNK``: xLSTM's chunked BPTT reads its chunk from the env
  at call time (64 unset, 0 naive): chunks 0, 4 and the default give the
  same gradients within float32 tolerance, and the chunk asked for is the
  chunk used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import ar_decode as JAR
from repro.core.guidance import cfg_combine as jcfg_combine
from repro.core.selective import GuidancePlan as JPlan
from repro.core.selective import Mode as JMode
from repro.kernels.quant import quantize_kv as jquantize_kv
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import ContinuousEngine as JEngine
from repro.serve import ServeRequest as JRequest
from repro_torch import convert
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import ar_decode as AR
from repro_torch.core.selective import GuidancePlan
from repro_torch.data.prompts import PAPER_PROMPTS
from repro_torch.kernels.quant import quantize_kv
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as XL
from repro_torch.serve import ContinuousEngine, ServeRequest

LOGIT_TOL = 1.5e-2


@pytest.fixture
def one_thread():
    """Tiny ops run fastest on one torch thread, and steadiest beside the
    other test workers' thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def kv_int8(monkeypatch):
    monkeypatch.setenv("REPRO_KV_QUANT", "int8")


@pytest.fixture(scope="module")
def llama():
    jcfg, cfg = jget_smoke("llama3.2-1b"), get_smoke_config("llama3.2-1b")
    params = JT.init_model(jcfg, JL.ArrayMaker(jax.random.PRNGKey(0)))
    model = TT.Transformer.from_state_dict(
        cfg, convert.from_jax_model_params(jax.tree.map(np.asarray, params)))
    return jcfg, cfg, params, model


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_is_bit_equal_to_the_reference(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 17, 4, 64)).astype(np.float32) * rng.uniform(0, 4, (3, 17, 4, 1))
    x[0, 0] = 0.0                                          # an all-zero row: the eps floor
    x[1, 2, 3] = 1e-9                                      # a row under it
    for xt, xj in ((torch.from_numpy(x), jnp.asarray(x)),
                   (torch.from_numpy(x).bfloat16(), jnp.asarray(x).astype(jnp.bfloat16))):
        q, s = TA.quantize_linear_kv(xt)
        jq, js = jquantize_kv(xj, scale_dtype=jnp.bfloat16, eps=1e-6)
        assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_bits(s), _bits(js))
        q2, s2 = quantize_kv(xt, scale_dtype=torch.bfloat16, eps=1e-6)
        assert torch.equal(q, q2) and torch.equal(s, s2)


def _leaves(caches):
    """{layer index.name: (shape, dtype name)} of the port's per-layer caches."""
    return {f"{i}.{n}": (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for i, c in enumerate(caches) for n, t in c.items()}


def _jleaves(jcfg, caches):
    """The reference's scan-stacked caches unstacked to the port's keys."""
    out, layer = {}, 0
    for seg in caches:
        blocks = [seg] if isinstance(seg, dict) else seg
        n = 1 if isinstance(seg, dict) else next(iter(seg[0].values())).shape[0]
        for j, c in enumerate(blocks):
            for name, t in c.items():
                shape = tuple(t.shape) if isinstance(seg, dict) else tuple(t.shape[1:])
                for i in range(n):
                    out[f"{layer + i * len(blocks) + j}.{name}"] = (shape, np.dtype(t.dtype).name)
        layer += n * len(blocks)
    return out


@pytest.mark.parametrize("arch", ["llama3.2-1b", "h2o-danube-3-4b"])
def test_caches_take_the_reference_leaves_under_the_knob(kv_int8, arch):
    """``cache_specs`` and ``prepare_decode_caches``: int8 k/v and bf16
    scales on linear caches, rings (every danube layer: its window of 64
    is under the capacity) left alone, as in the reference."""
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    cap = 96
    got = _leaves(TT.cache_specs(cfg, 2, cap, device="cpu"))
    want = _jleaves(jcfg, JT.cache_specs(jcfg, JL.SpecMaker(jnp.bfloat16), 2, cap))
    assert got == want
    assert any(v[1] == "int8" for v in got.values()) == (arch == "llama3.2-1b")
    model = TT.Transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 80)))
    _, caches = AR.prefill(model, toks)
    prepared = model.prepare_decode_caches(caches, seq_len=80, capacity=cap)
    assert {k: v[1] for k, v in _leaves(prepared).items()} == \
        {k: v[1] for k, v in want.items()}


def test_guided_decode_matches_the_reference_under_the_knob(kv_int8, llama, one_thread):
    jcfg, cfg, params, model = llama
    n, S = 8, 16
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    jplan, plan = JPlan.suffix(n, 0.5, 3.0), GuidancePlan.suffix(n, 0.5, 3.0)
    ref, _ = JAR.guided_decode(params, jcfg, jnp.asarray(toks), jplan)
    ref = np.array(ref)
    out, end = AR.guided_decode(model, torch.from_numpy(toks).long(), plan)
    assert end == S + n
    # the reference's teacher-forced logits, its steps fed its own tokens
    step = jax.jit(lambda p, t, c, pos: JAR.decode_step_cond(p, jcfg, t, c, pos))
    lc, cc = JAR.prefill(params, jcfg, jnp.asarray(toks))
    lu, cu = JAR.prefill(params, jcfg, JAR.null_prompt(jnp.asarray(toks)))
    cc = JT.prepare_decode_caches(jcfg, cc, seq_len=S, capacity=S + n)
    cu = JT.prepare_decode_caches(jcfg, cu, seq_len=S, capacity=S + n)
    assert cc[0][0]["k"].dtype == jnp.int8 and cc[0][0]["k_scale"].dtype == jnp.bfloat16
    want = [jcfg_combine(lu, lc, 3.0)]
    for i, mode in enumerate(jplan.modes()[:-1]):
        tok = jnp.asarray(ref[:, i])
        lc, cc = step(params, tok, cc, S + i)
        if mode is JMode.FULL:
            lu, cu = step(params, tok, cu, S + i)
            want.append(jcfg_combine(lu, lc, 3.0))
        else:
            want.append(lc)
    want = np.stack([np.asarray(x) for x in want], axis=1)
    got = AR.teacher_forced_logits(model, torch.from_numpy(toks).long(), plan,
                                   torch.from_numpy(ref).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())
    np.testing.assert_array_equal(out.numpy(), ref)


def test_the_slot_arena_serves_under_the_knob(kv_int8, llama, one_thread):
    """The slot arena's pools are int8 linear caches under the knob, rows
    prefilled quantized and written quantized by the per-row step; the
    engine's greedy tokens equal the reference engine's under the knob.
    The prompts are ones whose tokens the logits decide at this vocabulary
    of 512 (a bf16 near-tie can swap an argmax with or without the knob, as
    ``test_torch_ar_decode.py`` sets out)."""
    jcfg, cfg, params, model = llama
    kw = dict(num_slots=3, pass_budget=6, prompt_len=8, max_new=6, stop_on_eos=False, seed=0)
    prompts = PAPER_PROMPTS[:3]

    def reqs(cls):
        return [cls(uid=f"q{i}", prompt=p, max_new_tokens=6, guidance_scale=3.0)
                for i, p in enumerate(prompts)]

    eng = ContinuousEngine(model, cfg, **kw)
    out = eng.serve(reqs(ServeRequest))
    pool = eng._pool_c[0]
    assert pool["k"].dtype == torch.int8 and pool["k_scale"].dtype == torch.bfloat16
    assert out == JEngine(params, jcfg, **kw).serve(reqs(JRequest))


def test_an_int8_cache_without_scales_raises(llama):
    _, cfg, _, model = llama
    cache = TA.cache_spec(cfg, 1, 8, device="cpu")
    cache["k"], cache["v"] = cache["k"].to(torch.int8), cache["v"].to(torch.int8)
    x = torch.zeros(1, 1, cfg.d_model)
    rope = model._rope(torch.zeros(1, 1, dtype=torch.long))
    with pytest.raises(ValueError, match="k_scale"):
        TA.attn_decode(model.layers[0].attn, cfg, x, cache, 0, rope)


def test_the_paged_pool_ignores_the_knob(kv_int8):
    cfg = get_smoke_config("llama3.2-1b")
    pool = TT.paged_cache_specs(cfg, 4, 4, device="cpu")[0]
    assert set(pool) == {"k", "v"} and pool["k"].dtype == torch.bfloat16


# -- REPRO_BPTT_CHUNK -----------------------------------------------------------------


def test_bptt_chunk_is_read_at_call_time(monkeypatch, one_thread):
    cfg = get_smoke_config("xlstm-350m")
    S = 16
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32))
    grads, chunks = {}, {}
    real = XL.checkpoint

    def counting(fn, *a, **kw):
        calls.append(a[2] - a[1])                  # run(state, lo, hi): the chunk's length
        return real(fn, *a, **kw)

    monkeypatch.setattr(XL, "checkpoint", counting)
    for fwd, init in ((XL.mlstm_forward, XL.init_mlstm), (XL.slstm_forward, XL.init_slstm)):
        mk = TL.Maker(torch.Generator().manual_seed(1), torch.float32, "cpu")
        p = TL.tree_module(init(cfg, mk)).requires_grad_(True)
        for env in ("0", "4", None):
            calls = []
            if env is None:
                monkeypatch.delenv("REPRO_BPTT_CHUNK", raising=False)
            else:
                monkeypatch.setenv("REPRO_BPTT_CHUNK", env)
            assert XL.bptt_chunk_default() == (64 if env is None else int(env))
            x = x0.clone().requires_grad_(True)
            out, _ = fwd(p, cfg, x)
            out.square().sum().backward()
            grads[(fwd.__name__, env)] = [x.grad.clone()] + [t.grad.clone() for t in p.parameters()]
            chunks[(fwd.__name__, env)] = list(calls)
            for t in p.parameters():
                t.grad = None
        # 0: naive BPTT; 4: four chunks of 4; the default 64 > S: one pass
        assert chunks[(fwd.__name__, "0")] == [] and chunks[(fwd.__name__, None)] == []
        assert chunks[(fwd.__name__, "4")] == [4] * (S // 4)
        for env in ("4", None):
            for a, b in zip(grads[(fwd.__name__, env)], grads[(fwd.__name__, "0")]):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
