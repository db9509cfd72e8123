"""The port's ``Transformer`` on all ten of the reference's architectures at
``reduced()`` (the analogue of ``test_models_smoke.py``): forward logits,
one training step and its gradients against the reference's on the same
converted weights, decode consistency of every decoder, the block
patterns, and greedy guided decode against the reference's on the MLA +
MoE, RG-LRU and xLSTM stacks.

Tolerances. The stacks run their activations in bf16 (hubert, fed float32
frames, in float32), as in ``test_torch_ar_decode.py`` and
``test_torch_train.py``, whose bounds hold the 2-layer dense stacks. The
reduced recurrent stacks are deeper (recurrentgemma 3 layers, xlstm 4),
and their float32 states and exponential gates carry the bf16 stream's
differences further; the measured worst of each case is in brackets:
* forward logits within LOGIT_TOL = 2.5e-2 of the largest logit
  (recurrentgemma 1.67e-2, xlstm 1.44e-2, the rest <= 1.1e-2);
* the stack's MoE aux loss within 5e-3 relative (mixtral 2.5e-3): the
  stream's differences reach the router's probabilities (the MoE layer
  alone, on equal inputs, is held to 1e-5 in ``test_torch_moe_mla.py``);
* losses within 2e-3 relative (recurrentgemma 7.3e-4);
* each gradient within GRAD_STEPS = 24 bf16 steps (24 * 2^-8) of its
  largest magnitude (xlstm's mLSTM input-gate weights 15.0, deepseek's
  router 9.9, recurrentgemma 8.2, the rest <= 5.2), where a tensor whose
  largest gradient is under one bf16 step of its block's largest (mLSTM's
  input-gate bias, whose gradient cancels through the stabiliser) is held
  to its block's scale: it is below the stream's resolution;
* guided decode: ``test_torch_ar_decode.py``'s margin rule, the
  teacher-forced logits within DECODE_TOL = 4e-2 of the largest (over
  prompt seeds 0-9, recurrentgemma 1.1e-2 to 1.9e-2, xlstm 1.7e-2 to
  3.5e-2; the combine multiplies differences by 2s - 1 = 5).

Routing. A token's experts are a discontinuous function of its router
logits, which port and reference compute in bf16 from streams that differ
by bf16 steps (measured: at most 0.0156 between the two). Where a token's
k-th and (k+1)-th router logits are closer than that, the two may route it
differently and nothing downstream compares. So every MoE comparison first
asserts that each routed token's margin (the k-th minus the (k+1)-th
logit, from the port's router probabilities) is at least ROUTER_MARGIN,
twice the measured difference, and the data seeds of the MoE stacks
(DATA_SEEDS) are ones whose margins clear it.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import losses as jlosses
from repro_torch import convert
from repro_torch.configs.registry import ARCHS, get_smoke_config, list_archs
from repro_torch.models import moe as TM
from repro_torch.models.transformer import Transformer
from repro_torch.train import losses as tlosses
from repro_torch.train import optimizer as topt

LOGIT_TOL = 2.5e-2
DECODE_TOL = 4e-2
BF16 = 2.0 ** -8
GRAD_STEPS = 24
ROUTER_MARGIN = 0.03
DECODERS = [a for a in list_archs() if not get_smoke_config(a).is_encoder]
DATA_SEEDS = {"mixtral-8x7b": 21, "deepseek-v2-lite-16b": 2}
DECODE_SEEDS = {"deepseek-v2-lite-16b": 74, "recurrentgemma-9b": 2, "xlstm-350m": 9}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """-> (reference config, port config, reference params, port model on
    the same weights)."""
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    params = JT.init_model(jcfg, JL.ArrayMaker(jax.random.PRNGKey(0)))
    model = Transformer.from_state_dict(
        cfg, convert.from_jax_model_params(jax.tree.map(np.asarray, params)))
    return jcfg, cfg, params, model


def _batch(cfg, seed: int, B: int = 2, S: int = 17) -> dict:
    """Numpy inputs: tokens (B, S) for a decoder; frames (B, S, D) float32,
    targets and a mask for an encoder (``audio_frames``'s kind)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder:
        return {"features": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
                "mask": rng.random((B, S)) < 0.5}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


class RouterMargins:
    """Records, while active, the smallest top-k margin (the k-th minus the
    (k+1)-th router logit) of every token the port's MoE layers route."""

    def __init__(self, monkeypatch):
        self.margins = []
        route = TM.route

        def recording(p, cfg, x, C):
            r = route(p, cfg, x, C)
            lp = torch.log(r.probs.detach()).sort(dim=-1, descending=True).values
            k = cfg.moe.top_k
            self.margins.append(float((lp[..., k - 1] - lp[..., k]).min()))
            return r

        monkeypatch.setattr(TM, "route", recording)

    def check(self):
        if self.margins:
            assert min(self.margins) >= ROUTER_MARGIN, \
                f"a router near-tie ({min(self.margins):.4f}): the data do not decide the routing"


def _port_inputs(batch):
    if "tokens" in batch:
        return torch.from_numpy(batch["tokens"]).long()
    return torch.from_numpy(batch["features"])


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """-> (batch, logits, aux, loss, gradients as port keys) of the
    reference on ``_batch``: ``T.forward`` + ``T.unembed``, and
    ``jax.value_and_grad`` of its ``lm_loss`` or ``masked_prediction_loss``."""
    jcfg, cfg, params, _ = _pair(arch)
    batch = _batch(cfg, DATA_SEEDS.get(arch, 1))
    if cfg.is_encoder:
        x = jnp.asarray(batch["features"])
        loss_fn = lambda p: jlosses.masked_prediction_loss(  # noqa: E731
            p, jcfg, x, jnp.asarray(batch["targets"]), jnp.asarray(batch["mask"]), remat=False)
    else:
        x = jnp.asarray(batch["tokens"])
        loss_fn = lambda p: jlosses.lm_loss(p, jcfg, x, remat=False)  # noqa: E731
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    def fwd(p, x):
        h, _, aux = JT.forward(p, jcfg, x)
        return JT.unembed(p, jcfg, h).astype(jnp.float32), aux

    logits, aux = jax.jit(fwd)(params, x)
    return (batch, np.asarray(logits), float(aux), float(loss),
            dict(convert.model_items(jax.tree.map(np.asarray, grads))))


def _block(name: str) -> str:
    return ".".join(name.split(".")[:2]) if name.startswith("layers.") else name


@pytest.mark.parametrize("arch", list_archs())
def test_forward_logits_and_aux_match_reference(arch, monkeypatch):
    _, cfg, _, model = _pair(arch)
    batch, ref, ref_aux, _, _ = _reference(arch)
    margins = RouterMargins(monkeypatch)
    with torch.no_grad():
        h, _, aux = model(_port_inputs(batch))
        logits = model.unembed(h).float().numpy()
    margins.check()
    assert logits.shape == ref.shape == (2, 17, cfg.vocab_size)
    np.testing.assert_allclose(logits, ref, rtol=0, atol=LOGIT_TOL * np.abs(ref).max())
    if cfg.moe is not None:
        assert ref_aux > 0
        np.testing.assert_allclose(float(aux), ref_aux, rtol=5e-3)
    else:
        assert float(aux) == ref_aux == 0.0


@pytest.mark.parametrize("arch", list_archs())
def test_one_train_step_matches_reference(arch, monkeypatch):
    """The loss and every gradient against ``jax.value_and_grad`` of the
    reference's loss; then one AdamW step moves the parameters."""
    _, cfg, _, model = _pair(arch)
    batch, _, _, ref_loss, ref_grads = _reference(arch)
    model = Transformer.from_state_dict(cfg, {k: v.clone() for k, v in model.state_dict().items()})
    model.requires_grad_(True)
    margins = RouterMargins(monkeypatch)
    if cfg.is_encoder:
        loss, _ = tlosses.masked_prediction_loss(
            model, _port_inputs(batch), torch.from_numpy(batch["targets"]).long(),
            torch.from_numpy(batch["mask"]), remat=False)
    else:
        loss, _ = tlosses.lm_loss(model, _port_inputs(batch), remat=False)
    margins.check()
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    before = {k: p.detach().clone() for k, p in params.items()}
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=2e-3)
    assert set(grads) == set(ref_grads)
    scale = {}
    for name, g in ref_grads.items():
        scale[_block(name)] = max(scale.get(_block(name), 0.0), float(np.abs(g).max()))
    for name, ref in ref_grads.items():
        top = float(np.abs(ref).max())
        if top < BF16 * scale[_block(name)]:
            top = scale[_block(name)]
        np.testing.assert_allclose(grads[name].float().numpy(), ref, rtol=0,
                                   atol=GRAD_STEPS * BF16 * max(top, 1e-30), err_msg=name)
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    _, _, metrics = topt.adamw_update(opt, params, grads, topt.init_opt_state(params))
    assert np.isfinite(float(metrics["grad_norm"]))
    with torch.no_grad():
        assert all(bool(torch.isfinite(p).all()) for p in params.values())
        assert any(float((params[k] - before[k]).abs().max()) > 0 for k in params)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_consistency(arch):
    """The teacher-forced forward equals prefill then three decode steps,
    within the reference's own tolerance (``test_models_smoke.py``), MoE
    capacity raised so that no prefill token drops, as there."""
    _, cfg, _, model = _pair(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
        model = Transformer.from_state_dict(cfg, model.state_dict())
    B, S, EXT = 2, 12, 3
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + EXT)))
    with torch.no_grad():
        h, _, _ = model(toks)
        full = model.unembed(h).float()
        _, caches, _ = model(toks[:, :S], want_caches=True)
        caches = model.prepare_decode_caches(caches, seq_len=S, capacity=S + EXT)
        for i in range(EXT):
            step, caches = model.decode_step(model.embed_tokens(toks[:, S + i][:, None]),
                                             caches, S + i)
            np.testing.assert_allclose(model.unembed(step)[:, 0].float().numpy(),
                                       full[:, S + i].numpy(), rtol=5e-2, atol=1e-1)


def test_block_pattern_coverage():
    for cfg in ARCHS.values():
        assert len(cfg.blocks) == cfg.num_layers
    rg = ARCHS["recurrentgemma-9b"]
    assert rg.blocks[:3] == ("rglru", "rglru", "swa") and rg.blocks.count("swa") == 12
    xl = ARCHS["xlstm-350m"]
    assert xl.blocks.count("slstm") == 6 and xl.blocks.count("mlstm") == 18
    for arch in list_archs():
        cfg = get_smoke_config(arch)
        model = Transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        assert len(model.layers) == cfg.num_layers
        for i, (kind, layer) in enumerate(zip(cfg.blocks, model.layers)):
            names = {n for n, _ in layer.named_children()}
            assert ("attn" in names) == (kind in ("attn", "swa")), (arch, i)
            assert ("mix" in names) == (kind not in ("attn", "swa")), (arch, i)
            assert ("mlp" in names) == (kind != "mlstm" and kind != "slstm" and cfg.d_ff > 0)
            routed = cfg.moe is not None and i >= cfg.moe.first_k_dense
            assert hasattr(getattr(layer, "mlp", None), "router") == routed, (arch, i)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "recurrentgemma-9b", "xlstm-350m"])
def test_guided_decode_matches_reference(arch, monkeypatch):
    """Greedy ``guided_decode`` (f = 0.5) against the reference's under
    ``test_torch_ar_decode.py``'s margin rule, on the MLA + MoE, RG-LRU +
    local attention and xLSTM stacks."""
    from test_torch_ar_decode import Pair, _assert_decode_matches

    pair = Pair(arch)
    margins = RouterMargins(monkeypatch)
    _assert_decode_matches(pair, pair.prompt(2, 16, seed=DECODE_SEEDS[arch]), 8, 0.5,
                           tol=DECODE_TOL)
    margins.check()

