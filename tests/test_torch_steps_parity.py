"""The port's step functions (``repro_torch.launch.steps``) against the
reference's jitted ``bundle.fn`` on the CPU, at reduced configs and small
input shapes (batch 2, sequence 16), on the reference's weights converted:

* the train step (dense llama3.2-1b, MoE mixtral-8x7b, xlstm-350m,
  encoder hubert-xlarge): the loss within 1e-3 relative and the gradient
  norm within 2e-2 (bf16 activations on both sides); the updated
  parameters within 2 lr0 + 1e-6 |p| of the reference's, lr0 the first
  step's rate (AdamW's first step moves each parameter by lr0 times
  sign(g) plus the decay, so a gradient within rounding of 0 may take
  either sign), and at least 99% of the parameters moved the same way;
* the dual-stream prefill (llama3.2-1b, xlstm-350m) and hubert's encode:
  both streams' caches and the logits within 2.5e-2 of their largest
  value (``tests/test_torch_families.py``'s tolerance for a bf16 stack's
  output; xLSTM states within 6e-2 at most and 1e-2 on average, see
  STATE_TOL), the first tokens equal where the logits decide them;
* ``serve_full`` and ``serve_cond`` (llama3.2-1b, mixtral-8x7b,
  xlstm-350m) from the same random caches: next tokens equal where the
  logits decide them, the caches they update as the prefill's are held;
* ``build_sd_denoise`` full and cond at the reduced UNet, bf16: the
  updated latents within 2e-2 of their largest value.

A token is undecided where the port's combined logits hold the two
candidates within ``2 * LOGIT_TOL * (2s - 1)`` of the largest logit
(``tests/test_torch_serve.py``'s rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.sd_unet as jsd
import repro_torch.configs.sd_unet as tsd
from repro.configs import get_smoke_config as jget_smoke
from repro.configs.base import InputShape as JShape
from repro.launch import steps as JST
from repro.launch.mesh import make_host_mesh
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models import unet as JU
from repro_torch import convert
from repro_torch.configs import InputShape, get_smoke_config
from repro_torch.core import ar_decode as AR
from repro_torch.core.guidance import cfg_combine
from repro_torch.launch import steps as ST
from repro_torch.models.transformer import Transformer
from repro_torch.models.unet import UNet
from repro_torch.train.optimizer import AdamWConfig, init_opt_state, schedule

B, S = 2, 16
LOGIT_TOL = 3e-3
STACK_TOL = 2.5e-2   # of a tensor's largest value: a bf16 stack's output, as in
                     # tests/test_torch_families.py's LOGIT_TOL
# xLSTM states: exponential gating compounds the bf16 rounding layer by
# layer (0.5% of the largest value at the first layer, up to 4% at the
# fourth), so their largest error is held at 6e-2 and their mean at 1e-2
STATE_TOL, STATE_MEAN_TOL = 6e-2, 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch, dtype):
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    params = JT.init_model(jcfg, JL.ArrayMaker(jax.random.PRNGKey(0), dtype))
    model = Transformer.from_state_dict(cfg, convert.from_jax_model_params(_np(params)))
    return jcfg, params, cfg, model


# the reference's xLSTM states are tuples; the port's are dicts of these names
STATE_NAMES = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "m", "h")}


def _layers(jcaches, cfg) -> list[dict]:
    """The reference's segment-stacked caches as one dict a layer, in the
    port's layer order (``convert.model_items``'s unstacking) and under the
    port's names."""
    out = {}
    for key, a in convert.model_items({"segments": _np(jcaches)}):
        _, i, name = key.split(".", 2)
        kind = cfg.blocks[int(i)]
        if kind in STATE_NAMES:
            name = STATE_NAMES[kind][int(name)]
        out.setdefault(int(i), {})[name] = a
    return [out[i] for i in sorted(out)]


def _close(got: torch.Tensor, want, tol: float, what, mean_tol: float | None = None) -> None:
    want = convert.to_tensor(np.asarray(want)).float()
    got = got.detach().float()
    assert got.shape == want.shape, what
    top = max(want.abs().max().item(), 1e-6)
    err = (got - want).abs()
    assert err.max().item() <= tol * top, (what, err.max().item(), tol * top)
    if mean_tol is not None:
        assert err.mean().item() <= mean_tol * top, (what, err.mean().item(), mean_tol * top)


def _close_cache(got, want, kind, what) -> None:
    if kind in STATE_NAMES:
        _close(got, want, STATE_TOL, what, STATE_MEAN_TOL)
    else:
        _close(got, want, STACK_TOL, what)


def _tokens_decided(logits, got, want, scale) -> None:
    """Each row's token equals the reference's, or the port's combined
    logits hold both within rounding."""
    for r, (g, w) in enumerate(zip(got.tolist(), np.asarray(want).tolist())):
        if g != w:
            tol = 2 * LOGIT_TOL * (2 * scale - 1) * logits[r].abs().max().item()
            gap = (logits[r, g] - logits[r, w]).abs().item()
            assert gap <= tol, (r, g, w, gap, tol)


# -- the train step --------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b", "xlstm-350m",
                                  "hubert-xlarge"])
def test_train_step_equals_the_reference(arch, mesh):
    _check_train_step(arch, mesh)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hubert-xlarge"])
def test_microbatched_train_step_equals_the_reference(arch, mesh, monkeypatch):
    """``REPRO_MICROBATCH=2`` on both sides: the port's per-microbatch
    gradients accumulated in float32 against the reference's scan, at the
    tolerances of the whole-batch step; both return the accumulated loss
    and the optimizer's metrics and nothing else."""
    monkeypatch.setenv("REPRO_MICROBATCH", "2")
    m, jm = _check_train_step(arch, mesh)
    assert set(m) == set(jm) and "loss" in m and "grad_norm" in m


def _check_train_step(arch, mesh):
    """One train step of the port and of the reference's jitted bundle on
    the same weights and batch, held as the module docstring says. ->
    (the port's metrics, the reference's)."""
    jcfg, params, cfg, model = _pair(arch, jnp.float32)
    shape = InputShape("train_small", S, B, "train")
    jb = JST.build(jcfg, JShape("train_small", S, B, "train"), mesh)
    rng = np.random.default_rng(1)
    if cfg.is_encoder:
        batch = {"features": rng.standard_normal((B, S, cfg.d_model)).astype(jnp.bfloat16),
                 "targets": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
                 "mask": rng.random((B, S)) < 0.5}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)}
    jopt = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jb.in_specs[1])
    jparams, _, jm = jax.jit(jb.fn)(params, jopt, {k: jnp.asarray(v) for k, v in batch.items()})

    b = ST.build(cfg, shape, None)
    model.requires_grad_(True)
    opt = init_opt_state(dict(model.named_parameters()))
    tbatch = {k: convert.to_tensor(v) for k, v in batch.items()}
    out_model, out_opt, m = b.fn(model, opt, tbatch)
    assert out_model is model and int(out_opt["step"]) == 1

    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-3)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=2e-2)
    lr0 = schedule(AdamWConfig(), torch.zeros((), dtype=torch.int32)).item()
    want = convert.from_jax_model_params(_np(jparams))
    before = convert.from_jax_model_params(_np(params))
    same = total = 0
    for name, p in model.named_parameters():
        w, p0, p = want[name].float(), before[name].float(), p.detach().float()
        assert (p - w).abs().max().item() <= 2 * lr0 + 1e-6 * w.abs().max().item(), name
        moved_w, moved_p = torch.sign(w - p0), torch.sign(p - p0)
        same += int((moved_w == moved_p).sum())
        total += p.numel()
    assert same >= 0.99 * total, same / total
    return m, jm


# -- prefill --------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-1b", "xlstm-350m", "hubert-xlarge"])
def test_prefill_equals_the_reference(arch, mesh):
    jcfg, params, cfg, model = _pair(arch, jnp.bfloat16)
    jb = JST.build(jcfg, JShape("prefill_small", S, B, "prefill"), mesh)
    b = ST.build(cfg, InputShape("prefill_small", S, B, "prefill"), None)
    assert b.name == jb.name
    rng = np.random.default_rng(2)
    if cfg.is_encoder:
        feats = rng.standard_normal((B, S, cfg.d_model)).astype(jnp.bfloat16)
        want = jax.jit(jb.fn)(params, feats)
        got = b.fn(model, convert.to_tensor(feats))
        _close(got, want, STACK_TOL, "logits")
        return
    tokens = rng.integers(1, cfg.vocab_size, (B, S), dtype=np.int32)
    jtok, jc, ju = jax.jit(jb.fn)(params, tokens)
    tok, cc, cu = b.fn(model, torch.from_numpy(tokens))
    assert tok.dtype == torch.int32 and tok.shape == (B,)
    for got, want, stream in ((cc, jc, "cond"), (cu, ju, "uncond")):
        want = _layers(want, cfg)
        assert len(got) == len(want) == cfg.num_layers
        for i, (g, w) in enumerate(zip(got, want)):
            assert set(g) == set(w), (stream, i)
            for name in g:
                _close_cache(g[name], w[name], cfg.blocks[i], (stream, i, name))
    l_c, _ = AR.prefill(model, torch.from_numpy(tokens))
    l_u, _ = AR.prefill(model, AR.null_prompt(torch.from_numpy(tokens)))
    _tokens_decided(cfg_combine(l_u, l_c, cfg.guidance_scale), tok, jtok, cfg.guidance_scale)


# -- the serve steps --------------------------------------------------------------


def _random_caches(jb_specs, rng):
    return jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32)).astype(s.dtype),
        jb_specs)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b", "xlstm-350m"])
def test_serve_steps_equal_the_reference(arch, mesh):
    jcfg, params, cfg, model = _pair(arch, jnp.bfloat16)
    jshape, shape = JShape("decode_small", S, B, "decode"), InputShape("decode_small", S, B,
                                                                       "decode")
    rng = np.random.default_rng(3)
    token = rng.integers(1, cfg.vocab_size, (B,), dtype=np.int32)
    for variant in ("full", "cond"):
        jb = JST.build(jcfg, jshape, mesh, variant=variant)
        b = ST.build(cfg, shape, None, variant=variant)
        assert (b.name, b.donate) == (jb.name, jb.donate)
        jcaches = [_random_caches(jb.in_specs[i], rng) for i in jb.donate]
        out = jax.jit(jb.fn)(params, token, *jcaches)
        caches = [[{k: convert.to_tensor(a) for k, a in c.items()} for c in _layers(jc, cfg)]
                  for jc in jcaches]
        fresh = [[{k: t.clone() for k, t in c.items()} for c in cs] for cs in caches]
        got = b.fn(model, torch.from_numpy(token), *caches)
        assert got[0].dtype == torch.int32
        for stream, (g, w) in enumerate(zip(got[1:], out[1:])):
            for i, (gc, wc) in enumerate(zip(g, _layers(w, cfg))):
                for name in gc:
                    _close_cache(gc[name], wc[name], cfg.blocks[i], (variant, stream, i, name))
        tok = torch.from_numpy(token)
        if variant == "full":
            logits, _, _ = AR.decode_step_full(model, tok, *fresh, S - 1, cfg.guidance_scale)
        else:
            logits, _ = AR.decode_step_cond(model, tok, fresh[0], S - 1)
        _tokens_decided(logits, got[0], out[0], cfg.guidance_scale)


# -- the SD denoise step ------------------------------------------------------------


@pytest.fixture(scope="module")
def reduced_unet():
    ucfg = jsd.PRODUCTION.__class__().reduced()
    # numpy draws at ArrayMaker's fan-in scales: ArrayMaker's eager draws
    # compile one program per shape, 14 s of this file
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) / np.sqrt(max(1, np.prod(s.shape[:-1]))))
        .astype(jnp.bfloat16), JU.init_unet(ucfg, JL.SpecMaker(jnp.bfloat16)))
    unet = UNet.from_state_dict(ucfg, {k: convert.to_tensor(a)
                                       for k, a in convert.unet_items(_np(params))})
    return ucfg, params, unet


@pytest.mark.parametrize("variant", ["full", "cond"])
def test_sd_denoise_equals_the_reference(variant, mesh, reduced_unet, monkeypatch):
    ucfg, params, unet = reduced_unet
    monkeypatch.setattr(jsd, "PRODUCTION", ucfg)    # both sides build PRODUCTION
    monkeypatch.setattr(tsd, "PRODUCTION", ucfg)
    jb = JST.build_sd_denoise(mesh, variant=variant, batch=B)
    b = ST.build_sd_denoise(None, variant=variant, batch=B)
    assert b.donate == jb.donate and len(b.in_specs) == len(jb.in_specs)
    rng = np.random.default_rng(4)
    hw = ucfg.latent_size
    x = rng.standard_normal((B, hw, hw, ucfg.in_channels)).astype(jnp.bfloat16)
    t = rng.integers(0, 1000, (B,), dtype=np.int32)
    txt = [rng.standard_normal((B, ucfg.text_len, ucfg.text_dim)).astype(jnp.bfloat16)
           for _ in range(2 if variant == "full" else 1)]
    ab = [np.float32(0.7), np.float32(0.8)]
    want = jax.jit(jb.fn)(params, x, t, *txt, *ab)
    got = b.fn(unet, convert.to_tensor(x), torch.from_numpy(t),
               *[convert.to_tensor(a) for a in txt], *[torch.tensor(a) for a in ab])
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _close(got, want, 2e-2, variant)
