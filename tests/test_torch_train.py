"""The port's training path against the reference's: synthetic data, AdamW,
the diffusion and LM losses with their gradients, eager steps against the
reference's jitted ones, and the launcher. The closed-form backwards that
the CUDA kernels of B4 (flash attention) and B6 (RMSNorm) run under
autograd are held against autograd of their plain versions here, on the
CPU.

Tolerances:
* data: bit for bit (the same numpy code);
* AdamW over 12 steps: 2e-6 relative and 1e-7 absolute on parameters and
  moments, 1e-6 relative on the norm and the rate (float32 sums of the
  global norm taken in another order, float32 cos/pow);
* ``diffusion_loss`` and its gradients on the same inputs: 1e-5 relative
  on the loss, 1e-4 of each gradient's largest magnitude (float32 convs and
  matmuls in another order of summation);
* ``lm_loss`` and its gradients: the stacks run their activations in bf16,
  as the reference does, so 2e-3 relative on the loss and 8 bf16 steps
  (8 * 2^-8) of each gradient's largest magnitude (the worst measured is
  4.8 steps);
* 10 training steps from the same init, data, draws and embeddings:
  losses within 1e-5 relative, each parameter within 5e-4 of its largest
  magnitude (measured: 1e-6 and 5e-5; AdamW's m/sqrt(v) amplifies float32
  differences where a gradient is small);
* the closed-form backwards against autograd in float64 inputs computed
  in float32: 1e-5 of each gradient's largest magnitude.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import UNetConfig as JUNetConfig
from repro.configs.registry import get_smoke_config as jget_smoke
from repro.core.pipeline import SDPipeline as JPipe
from repro.core.schedules import NoiseSchedule as JSched
from repro.data import synthetic as jsyn
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.unet import unet_forward as junet_forward
from repro.train import losses as jlosses
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.configs.base import UNetConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.pipeline import SDPipeline
from repro_torch.core.schedules import NoiseSchedule
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import flash_attention as KF
from repro_torch.kernels import rmsnorm as KR
from repro_torch.models.transformer import Transformer
from repro_torch.train import diffusion as TD
from repro_torch.train import losses as tlosses
from repro_torch.train import optimizer as topt
from repro_torch.train.loop import make_train_step


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Training runs thousands of small ops: on a machine shared by several
    test workers, torch's thread pool spends more time waiting than
    computing, so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close_to_max(out, ref, frac, what):
    out, ref = _np(out), _np(ref)
    tol = frac * max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol, err_msg=what)


# -- data ---------------------------------------------------------------------------


def test_synthetic_data_equals_reference_bit_for_bit():
    t_it = tsyn.shapes_dataset(np.random.default_rng(0), batch=8, size=8)
    j_it = jsyn.shapes_dataset(np.random.default_rng(0), batch=8, size=8)
    for _ in range(3):
        (tl, tc), (jl, jc) = next(t_it), next(j_it)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tc, jc)
        assert tl.dtype == jl.dtype and tc.dtype == jc.dtype
    t_lm = tsyn.lm_batches(np.random.default_rng(3), 97, 4, 33)
    j_lm = jsyn.lm_batches(np.random.default_rng(3), 97, 4, 33)
    for _ in range(3):
        a, b = next(t_lm), next(j_lm)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int32
    for t, j in zip(tsyn.audio_frames(np.random.default_rng(5), 2, 16, 24, 50),
                    jsyn.audio_frames(np.random.default_rng(5), 2, 16, 24, 50)):
        np.testing.assert_array_equal(t, j)
        assert t.dtype == j.dtype
    for cls in range(tsyn.N_CLASSES):
        np.testing.assert_array_equal(tsyn.render_class(cls, 12, (0.3, -0.2), 1.1),
                                      jsyn.render_class(cls, 12, (0.3, -0.2), 1.1))


# -- AdamW ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip_norm", [1e-2, 1e3], ids=["clip_binds", "clip_free"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1], ids=["no_decay", "decay"])
def test_adamw_matches_reference_over_12_steps(clip_norm, weight_decay):
    rng = np.random.default_rng(7)
    shapes = {"a": (6, 5), "b": (17,), "c": (3, 4, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    cfg_kw = dict(lr=3e-2, warmup_steps=4, total_steps=12, weight_decay=weight_decay,
                  clip_norm=clip_norm)
    jcfg, tcfg = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jopt.init_opt_state(jp), topt.init_opt_state(tp)
    update = jax.jit(lambda p, g, s: jopt.adamw_update(jcfg, p, g, s))
    for step in range(12):
        g = {k: (rng.standard_normal(s) * 0.5).astype(np.float32) for k, s in shapes.items()}
        jp, js, jm = update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        tp, ts, tm = topt.adamw_update(tcfg, tp, {k: torch.from_numpy(v) for k, v in g.items()},
                                       ts)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-6,
                                       err_msg=f"step {step} {name}")
        for k in shapes:
            for mine, ref, what in ((tp[k], jp[k], "p"), (ts["m"][k], js["m"][k], "m"),
                                    (ts["v"][k], js["v"][k], "v")):
                np.testing.assert_allclose(_np(mine), np.asarray(ref), rtol=2e-6, atol=1e-7,
                                           err_msg=f"step {step} {what}[{k}]")
        assert int(ts["step"]) == int(js["step"]) == step + 1
    if clip_norm < 1:
        assert float(tm["grad_norm"]) > clip_norm        # the clip bound every step
    assert tp["a"].dtype == torch.float32 and ts["m"]["a"].dtype == torch.float32


def test_schedule_matches_reference():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=50, min_lr_ratio=0.1)
    for step in range(0, 60):
        ref = float(jopt.schedule(jopt.AdamWConfig(**cfg), jnp.asarray(step, jnp.int32)))
        mine = topt.schedule(topt.AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32))
        assert mine.dtype == torch.float32
        np.testing.assert_allclose(float(mine), ref, rtol=1e-6, err_msg=str(step))


# -- diffusion loss --------------------------------------------------------------------


@pytest.fixture(scope="module")
def sd_pair():
    """The reference's reduced pipeline from ``PRNGKey(0)`` and the port's
    on the converted weights."""
    jp = JPipe.init(JUNetConfig().reduced(), jax.random.PRNGKey(0), sched=JSched.sd_default(1000))
    tp = SDPipeline.from_state(UNetConfig().reduced(),
                               convert.from_jax_params(jax.tree.map(np.asarray, jp.params)),
                               device="cpu", sched=NoiseSchedule.sd_default(1000))
    return jp, tp


@pytest.fixture(scope="module")
def ref_value_and_grad(sd_pair):
    """The reference's ``diffusion_loss`` on a key, and its gradient with
    respect to the UNet's parameters, jitted once for both tests below."""
    jp, cfg = sd_pair[0], JUNetConfig().reduced()

    def loss(unet, lat, text, null, key):
        eps_fn = lambda x, t, txt: junet_forward(unet, cfg, x, t, txt)  # noqa: E731
        return jlosses.diffusion_loss(eps_fn, jp.sched, key, lat, text, null)[0]

    return jax.jit(jax.value_and_grad(loss))


def _reference_draws(key, batch, shape, T):
    """``diffusion_loss``'s draws from ``key``, repeated."""
    k_t, k_eps, k_drop = jax.random.split(key, 3)
    return (jax.random.randint(k_t, (batch,), 0, T),
            jax.random.normal(k_eps, shape, jnp.float32),
            jax.random.bernoulli(k_drop, 0.1, (batch,)))


def _text(jp, cls):
    """The class prompts' and the null prompt's reference embeddings (bf16),
    for both sides."""
    prompts = jp.encode_prompts(tsyn.CLASS_PROMPTS)
    null = jp.null_embedding(1)
    text = np.asarray(prompts[cls])
    return text, np.asarray(jnp.broadcast_to(null, text.shape))


def test_diffusion_loss_and_gradients_match_reference(sd_pair, ref_value_and_grad):
    """The port's loss on the reference's draws, repeated from its key,
    against ``jax.value_and_grad`` of the reference's loss on that key."""
    jp, tp = sd_pair
    lat, cls = next(jsyn.shapes_dataset(np.random.default_rng(0), batch=8, size=8))
    text, null = _text(jp, cls)
    # a key whose draws drop some rows and keep others, for the test to bite
    key = next(k for k in (jax.random.PRNGKey(i) for i in range(100))
               if 0 < int(_reference_draws(k, 8, lat.shape, 1000)[2].sum()) < 8)
    t, eps, drop = (torch.from_numpy(np.array(a)) for a in _reference_draws(key, 8, lat.shape,
                                                                              1000))
    ref_loss, ref_grads = ref_value_and_grad(jp.params["unet"], jnp.asarray(lat),
                                             jnp.asarray(text), jnp.asarray(null), key)
    unet = tp.unet.requires_grad_(True)
    try:
        loss, metrics = tlosses.diffusion_loss(unet, tp.sched, torch.from_numpy(lat),
                                               convert.to_tensor(text), convert.to_tensor(null),
                                               t=t, eps=eps, drop=drop)
        names = [n for n, _ in unet.named_parameters()]
        grads = dict(zip(names, torch.autograd.grad(loss, list(unet.parameters()))))
    finally:
        unet.requires_grad_(False)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert metrics["mse"] is loss
    expected = dict(convert.unet_items(jax.tree.map(np.asarray, ref_grads)))
    assert set(expected) == set(grads)
    for name, ref in expected.items():
        _close_to_max(grads[name], ref, 1e-4, name)


def test_diffusion_draws_are_a_generators_and_shaped():
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    a, b = tlosses.diffusion_draws(g1, 8, (8, 8, 8, 4), 1000), \
        tlosses.diffusion_draws(g2, 8, (8, 8, 8, 4), 1000)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    t, eps, drop = a
    assert t.shape == (8,) and int(t.min()) >= 0 and int(t.max()) < 1000
    assert eps.shape == (8, 8, 8, 4) and eps.dtype == torch.float32
    assert drop.dtype == torch.bool and drop.shape == (8,)
    many = tlosses.diffusion_draws(torch.Generator().manual_seed(0), 20000, (1,), 10)[2]
    assert abs(float(many.float().mean()) - 0.1) < 0.01


# -- LM loss ---------------------------------------------------------------------------


# the token streams of the MoE stacks: seeds whose router margins clear
# test_torch_families.ROUTER_MARGIN, so that the data decide the routing
LM_SEEDS = {"mixtral-8x7b": 37, "deepseek-v2-lite-16b": 0}


@functools.lru_cache(maxsize=4)
def _reference_lm(arch):
    """-> (params, tokens, loss, metrics, gradients) of the reference's
    ``lm_loss`` on reduced ``arch``. Its remat changes no number, so one
    jitted run serves the port's runs with and without remat."""
    jcfg = jget_smoke(arch)
    params = JT.init_model(jcfg, JL.ArrayMaker(jax.random.PRNGKey(1)))
    tokens = next(tsyn.lm_batches(np.random.default_rng(LM_SEEDS.get(arch, 2)),
                                  jcfg.vocab_size, 2, 17))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jlosses.lm_loss(p, jcfg, jnp.asarray(tokens), remat=False), has_aux=True))(params)
    return params, tokens, loss, metrics, grads


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-14b", "mixtral-8x7b",
                                  "deepseek-v2-lite-16b"])
def test_lm_loss_and_gradients_match_reference(arch, remat, monkeypatch):
    """The MoE stacks (mixtral: every layer routed; deepseek: MLA and a
    dense first layer) add their aux loss into the loss, as the
    reference's does (within 2e-3 relative, the loss's own bound)."""
    from test_torch_families import RouterMargins
    params, tokens, ref_loss, ref_m, ref_grads = _reference_lm(arch)
    model = Transformer.from_state_dict(
        get_smoke_config(arch),
        convert.from_jax_model_params(jax.tree.map(np.asarray, params))).requires_grad_(True)
    margins = RouterMargins(monkeypatch)
    loss, metrics = tlosses.lm_loss(model, torch.from_numpy(tokens).long(), remat=remat)
    margins.check()
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))

    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=2e-3)
    np.testing.assert_allclose(float(metrics["ce"]), float(ref_m["ce"]), rtol=2e-3)
    if get_smoke_config(arch).moe is None:
        assert float(metrics["aux"]) == float(ref_m["aux"]) == 0.0
    else:
        assert float(ref_m["aux"]) > 0
        np.testing.assert_allclose(float(metrics["aux"]), float(ref_m["aux"]), rtol=2e-3)
    expected = dict(convert.model_items(jax.tree.map(np.asarray, ref_grads)))
    assert set(expected) == set(grads)
    if get_smoke_config(arch).qk_norm:
        assert any(n.endswith("q_norm") for n in expected)
    for name, ref in expected.items():
        _close_to_max(grads[name], ref, 8 * 2 ** -8, name)


# -- eager steps against the reference's jitted ones -------------------------------------


def test_ten_training_steps_match_the_reference(sd_pair, ref_value_and_grad, monkeypatch):
    """``train_pipeline`` from the reference's init, on the reference's data,
    draws and prompt embeddings, against ``benchmarks/common.py``'s step:
    ``value_and_grad`` of its loss on a key split from ``PRNGKey(1)``, then
    ``adamw_update``. (Its step differentiates the text encoder's
    parameters too; their gradients are zero and leave the norm and the
    UNet's update as they are. The port's bf16 text encoder differs from
    the reference's by a few bf16 steps, test_torch_models.py; the
    embeddings are fed in so that the steps alone are compared.)"""
    jp, tp = sd_pair
    cfg, steps = JUNetConfig().reduced(), 10
    data = jsyn.shapes_dataset(np.random.default_rng(0), batch=8, size=cfg.latent_size)
    prompts_emb, null_emb = jp.encode_prompts(jsyn.CLASS_PROMPTS), jp.null_embedding(1)
    opt_cfg = jopt.AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=steps, weight_decay=0.0)
    update = jax.jit(lambda p, g, s: jopt.adamw_update(opt_cfg, p, g, s))
    unet, key = jp.params["unet"], jax.random.PRNGKey(1)
    opt, ref_losses, draws = jopt.init_opt_state(unet), [], []
    for _ in range(steps):
        lat, cls = next(data)
        key, sub = jax.random.split(key)
        text = prompts_emb[jnp.asarray(cls)]
        loss, g = ref_value_and_grad(unet, jnp.asarray(lat), text,
                                     jnp.broadcast_to(null_emb, text.shape), sub)
        unet, opt, _ = update(unet, g, opt)
        ref_losses.append(float(loss))
        draws.append(tuple(np.array(a) for a in _reference_draws(sub, 8, lat.shape, 1000)))

    pe, ne = convert.to_tensor(np.asarray(prompts_emb)), convert.to_tensor(np.asarray(null_emb))
    monkeypatch.setattr(SDPipeline, "encode_prompts", lambda self, prompts: pe)
    monkeypatch.setattr(SDPipeline, "null_embedding", lambda self, batch: ne)
    pipe, losses = TD.train_pipeline(UNetConfig().reduced(), steps, device="cpu",
                                     pipe=copy.deepcopy(tp), draws=draws)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=1e-5)
    expected = dict(convert.unet_items(jax.tree.map(np.asarray, unet)))
    assert set(expected) == set(pipe.unet.state_dict())
    for name, p in pipe.unet.state_dict().items():
        _close_to_max(p, expected[name], 5e-4, name)


def test_diffusion_training_reduces_loss():
    """The analogue of ``test_system.py``'s 60-step run: the port's own
    init and draws, its eager step (``loop.make_train_step``)."""
    cfg = UNetConfig().reduced()
    pipe = SDPipeline.init(cfg, 0, device="cpu", sched=NoiseSchedule.sd_default(100))
    data = tsyn.shapes_dataset(np.random.default_rng(0), batch=8, size=cfg.latent_size)
    prompts_emb, null_emb = pipe.encode_prompts(tsyn.CLASS_PROMPTS), pipe.null_embedding(1)
    opt_cfg = topt.AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=60, weight_decay=0.0)
    unet = pipe.unet.requires_grad_(True)
    params = dict(unet.named_parameters())

    def loss_fn(_params, batch, generator):
        lat, cls = batch
        text = prompts_emb[torch.from_numpy(cls).long()]
        t, eps, drop = tlosses.diffusion_draws(generator, 8, lat.shape, pipe.sched.T)
        return tlosses.diffusion_loss(unet, pipe.sched, torch.from_numpy(lat), text,
                                      null_emb.expand(text.shape), t=t, eps=eps, drop=drop)

    step = make_train_step(loss_fn, opt_cfg)
    opt, gen, hist = topt.init_opt_state(params), torch.Generator().manual_seed(1), []
    for _ in range(60):
        params, opt, m = step(params, opt, next(data), gen)
        hist.append(float(m["loss"]))
    assert np.mean(hist[-10:]) < np.mean(hist[:10]) * 0.95


def test_launch_train_improves_its_loss(tmp_path):
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch import train as launch

    hist = launch.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "40", "--batch", "8",
                        "--seq", "32", "--lr", "1e-2", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path / "ck")])
    assert hist[-1]["loss"] < hist[0]["loss"]
    tree, step, _ = load_checkpoint(str(tmp_path / "ck"), device="cpu")
    assert step == 40 and "embed.table" in tree["params"]
    # the encoder trains on masked prediction of the synthetic audio frames
    hist = launch.main(["--arch", "hubert-xlarge", "--reduced", "--steps", "30", "--batch", "8",
                        "--seq", "32", "--lr", "1e-3", "--device", "cpu"])
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_serve_engine_refuses_the_families_it_does_not_serve():
    """The serve engine refuses what the reference refuses: the paged arena
    raises its ``ValueError`` for MLA latents and recurrent states, which
    have no pages; and an encoder, which has no decode step, raises at
    construction in either arena (the reference fails at its first tick)."""
    from repro_torch.serve import ContinuousEngine
    for arch, kw, match in (("deepseek-v2-lite-16b", dict(kv="paged"), "MLA"),
                            ("recurrentgemma-9b", dict(kv="paged"), "rglru"),
                            ("xlstm-350m", dict(kv="paged"), "mlstm"),
                            ("hubert-xlarge", {}, "encoder"),
                            ("hubert-xlarge", dict(kv="paged"), "encoder")):
        cfg = get_smoke_config(arch)
        model = Transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        with pytest.raises(ValueError, match=match):
            ContinuousEngine(model, cfg, **kw)


# -- the CUDA kernels' backwards, in torch ops --------------------------------------------


@pytest.mark.parametrize("causal,window,H,K,hd", [
    (True, None, 4, 2, 16), (True, 5, 6, 2, 24), (False, None, 4, 4, 8), (False, 3, 4, 1, 8)])
def test_flash_attention_backward_matches_autograd_of_plain(causal, window, H, K, hd):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 13, h, hd, generator=gen, dtype=torch.float64, requires_grad=True)
               for h in (H, K, K))
    out = KF.flash_attention_plain(q, k, v, causal=causal, window=window)
    dout = torch.randn(out.shape, generator=gen, dtype=torch.float64)
    ref = torch.autograd.grad(out, (q, k, v), dout)
    mine = KF.flash_attention_backward(q.detach(), k.detach(), v.detach(), out.detach(), dout,
                                       causal=causal, window=window)
    for a, b, name in zip(mine, ref, "qkv"):
        _close_to_max(a, b, 1e-5, f"d{name}")
    # a dropped mask in the backward is caught by this comparison
    if causal:
        wrong = KF.flash_attention_backward(q.detach(), k.detach(), v.detach(), out.detach(),
                                            dout, causal=False, window=None)
        with pytest.raises(AssertionError):
            _close_to_max(wrong[0], ref[0], 1e-5, "dq")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_matches_autograd_of_plain(dtype):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 32, generator=gen).to(dtype).requires_grad_(True)
    scale = (1 + 0.1 * torch.randn(32, generator=gen)).requires_grad_(True)
    y = KR.rmsnorm_plain(x, scale, 1e-6)
    dy = torch.randn(y.shape, generator=gen).to(dtype)
    ref = torch.autograd.grad(y, (x, scale), dy)
    rstd = torch.rsqrt(x.detach().float().square().mean(-1, keepdim=True) + 1e-6)
    dx, dscale = KR.rmsnorm_backward(x.detach(), scale.detach(), rstd, dy)
    assert dx.dtype == dtype and dscale.dtype == torch.float32
    _close_to_max(dx, ref[0], 1e-5 if dtype == torch.float32 else 2 ** -8, "dx")
    _close_to_max(dscale, ref[1], 1e-5, "dscale")


def test_autograd_functions_carry_the_gradient(monkeypatch):
    """The CUDA path's ``autograd.Function``s, with their kernel launch
    swapped for the plain version (the CPU has no kernel): outputs carry a
    ``grad_fn`` and the gradients are the plain version's."""
    monkeypatch.setattr(KF, "_launch", lambda q, k, v, causal, window:
                        KF.flash_attention_plain(q, k, v, causal=causal, window=window))
    monkeypatch.setattr(KR, "_launch", KR.rmsnorm_plain)
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, 9, h, 8, generator=gen, requires_grad=True) for h in (4, 2, 2))
    out = KF.FlashAttentionFn.apply(q, k, v, True, 4)
    assert out.grad_fn is not None
    ref = torch.autograd.grad(KF.flash_attention_plain(q, k, v, causal=True, window=4).sum(),
                              (q, k, v))
    for a, b in zip(torch.autograd.grad(out.sum(), (q, k, v)), ref):
        _close_to_max(a, b, 1e-5, "flash")
    x = torch.randn(4, 16, generator=gen, requires_grad=True)
    s = (1 + torch.randn(16, generator=gen)).requires_grad_(True)
    w = torch.randn(4, 16, generator=gen)
    y = KR.RmsNormFn.apply(x, s, 1e-6)
    assert y.grad_fn is not None
    ref = torch.autograd.grad((KR.rmsnorm_plain(x, s, 1e-6) * w).sum(), (x, s))
    for a, b in zip(torch.autograd.grad((y * w).sum(), (x, s)), ref):
        _close_to_max(a, b, 1e-5, "rmsnorm")
