"""Step builders: one function + meta-tensor input specs per (architecture
x input shape). Counterpart of ``repro/launch/steps.py``.

This is what the dry-run (``launch/dryrun.py``) and the roofline consume.
Parameters, caches and optimizer states are built on the meta device from
the same init code as the real ones (``models.layers.SpecMaker``), so a
spec can never drift from what ``Transformer.init`` or ``cache_specs``
build; a step called on them runs under the meta device's shape rules,
every kernel wrapper taking its plain version (``kernels/build.on_cuda``).

Step kinds per shape:
  train_4k    -> train_step   (loss + grad + AdamW update, remat)
  prefill_32k -> prefill      (dual-stream CFG prefill; encoder: forward)
  decode_32k  -> serve_step   (baseline FULL CFG step: two streams)
  long_500k   -> serve_step   (SWA ring / recurrent state / MLA latent cache)

``variant="cond"`` builds the paper-optimized serve step (conditional
stream only), the comparison object of the paper's claim.

Parameters: the first argument of every ``fn`` is the model itself, a
``Transformer`` (or ``UNet``) whose parameters are the step's weights, in
the reference's dtypes (float32 for training, bfloat16 otherwise);
``in_specs[0]`` is that module on the meta device, built by the bundle's
``init`` from a ``SpecMaker``; ``materialize`` builds the real one from a
``Maker``, so both come from the models' own init. A donated argument
(``donate``, the reference's indices) is updated in place by ``fn``, as
the port's decode steps update their caches: the train step's parameters
and optimizer state, the serve steps' caches. ``fn`` returns them all the
same, in the reference's output structure.

Shardings: with ``mesh=None`` (one device) ``in_shardings``,
``out_shardings`` and ``rules`` are ``None``. Given a mesh, ``rules`` is the
shape's table (``rules_for_shape``) and every argument gets its layout from
the logical axes the init code names (``models.layers.AxesMaker``): a
``P`` a tensor on a ``MeshShape`` (the dry-run's production meshes), its
DTensor placements on a ``DeviceMesh``. The model argument's entry is a
dict by parameter name (``named_parameters``), as the optimizer state's
moments are; ``out_shardings`` follows the reference's (None where it lets
the compiler choose). The step itself runs unsharded: the layouts are
where a launcher places its arguments, and what the dry-run prices.
"""

from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import ar_decode as AR
from repro_torch.core.guidance import cfg_combine
from repro_torch.dist.sharding import (RULES_LONG, RULES_SERVE, RULES_TRAIN, AxisRules,
                                       MeshShape, local_shape, logical_to_spec,
                                       spec_placements, tree_shardings)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import losses
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state

META = torch.device("meta")


@dataclass
class StepBundle:
    name: str
    fn: Callable
    in_specs: tuple          # meta tensors / modules / dicts and lists of them (positional)
    in_shardings: Any = None     # P or placements trees (same structure); None: one device
    out_shardings: Any = None    # None -> unspecified
    rules: AxisRules | None = None
    donate: tuple = ()       # arg indices fn updates in place (cache/param aliasing)
    init: Callable | None = None     # maker -> argument 0 (``init_model``/``init_unet``)


def rules_for_shape(shape: InputShape) -> AxisRules:
    if shape.kind == "train":
        rules = RULES_TRAIN
    elif shape.name == "long_500k":
        rules = RULES_LONG
    else:
        rules = RULES_SERVE
    # REPRO_RULE_OVERRIDE="state=;kv_seq=model,data" rebinds logical axes
    # without touching the rule tables.
    ov = os.environ.get("REPRO_RULE_OVERRIDE")
    if ov:
        kw = {}
        for part in ov.split(";"):
            name, _, axes = part.partition("=")
            kw[name.strip()] = tuple(a for a in axes.split(",") if a)
        rules = rules.override(**kw)
    return rules


def _sharding(mesh, rules, logical, shape):
    """One tensor's layout: its ``P`` on a ``MeshShape``, its placements on
    a ``DeviceMesh``."""
    spec = logical_to_spec(logical, rules, shape=shape, mesh=mesh)
    return spec if isinstance(mesh, MeshShape) else spec_placements(spec, mesh)


def flat_axes(tree, prefix: str = "") -> dict:
    """An axes tree as {dotted path: axes}, the paths ``named_parameters``
    gives the module built from the same tree (``None`` entries have none)."""
    if L.is_axes_leaf(tree):
        return {prefix[:-1]: tree}
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if v is not None:
            out.update(flat_axes(v, f"{prefix}{k}."))
    return out


def module_shardings(axes_tree, module, mesh, rules) -> dict:
    """{parameter name: layout} of ``module`` from its init's axes tree."""
    return tree_shardings(flat_axes(axes_tree), dict(module.named_parameters()), mesh, rules)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _transformer(cfg: ModelConfig, maker) -> T.Transformer:
    return T.Transformer(cfg, T.init_model(cfg, maker))


def param_specs(cfg: ModelConfig, *, dtype):
    """-> (the model on the meta device with ``dtype`` parameters, the
    logical axes tree of its init: ``init_model`` under an ``AxesMaker``)."""
    return _transformer(cfg, L.SpecMaker(dtype)), T.init_model(cfg, L.AxesMaker())


def skip_reason(cfg: ModelConfig, shape: InputShape) -> str | None:
    """The skip policy. None = runnable."""
    if cfg.is_encoder and shape.kind == "decode":
        return "encoder-only: no decode step"
    return None


def supports_long_context(cfg: ModelConfig) -> bool:
    # everything decodes at 500k via SWA-substitute / recurrent state / MLA
    # latent cache; encoders are excluded by skip_reason already.
    return not cfg.is_encoder


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def build_train_step(cfg: ModelConfig, shape: InputShape, mesh,
                     opt_cfg: AdamWConfig | None = None) -> StepBundle:
    opt_cfg = opt_cfg or AdamWConfig()
    B, S = shape.global_batch, shape.seq_len
    model, paxes = param_specs(cfg, dtype=torch.float32)
    model.requires_grad_(True)
    opt_specs = init_opt_state(dict(model.named_parameters()))

    if cfg.is_encoder:
        batch_specs = {"features": _spec((B, S, cfg.d_model), torch.bfloat16),
                       "targets": _spec((B, S), torch.int32),
                       "mask": _spec((B, S), torch.bool)}

        def loss_fn(model, batch):
            return losses.masked_prediction_loss(model, batch["features"], batch["targets"],
                                                 batch["mask"])
    else:
        batch_specs = {"tokens": _spec((B, S), torch.int32)}

        def loss_fn(model, batch):
            return losses.lm_loss(model, batch["tokens"])

    # REPRO_MICROBATCH=n -> gradient accumulation over n microbatches,
    # dividing peak activation memory by ~n at the cost of n weight re-reads.
    micro = int(os.environ.get("REPRO_MICROBATCH", "1"))

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        names = list(params)

        def grads_of(loss):
            gs = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
            return {k: torch.zeros_like(params[k]) if g is None else g
                    for k, g in zip(names, gs)}

        if micro > 1:
            loss = torch.zeros((), dtype=torch.float32, device=next(iter(params.values())).device)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
            for i in range(micro):
                b = {k: v.reshape(micro, v.shape[0] // micro, *v.shape[1:])[i]
                     for k, v in batch.items()}
                mb_loss, _ = loss_fn(model, b)
                for k, g in grads_of(mb_loss).items():
                    grads[k] += g.float() / micro
                loss = loss + mb_loss.detach() / micro
            metrics = {}
        else:
            loss, metrics = loss_fn(model, batch)
            grads = grads_of(loss)
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        _, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        return model, opt_state, {"loss": loss, **metrics, **om}

    shard = {}
    if mesh is not None:
        rules = rules_for_shape(shape)
        psh = module_shardings(paxes, model, mesh, rules)
        opt_sh = {"m": psh, "v": psh, "step": _sharding(mesh, rules, (), ())}
        if cfg.is_encoder:
            batch_sh = {"features": _sharding(mesh, rules, ("batch", "seq", None),
                                              (B, S, cfg.d_model)),
                        "targets": _sharding(mesh, rules, ("batch", "seq"), (B, S)),
                        "mask": _sharding(mesh, rules, ("batch", "seq"), (B, S))}
        else:
            batch_sh = {"tokens": _sharding(mesh, rules, ("batch", "seq"), (B, S))}
        shard = dict(in_shardings=(psh, opt_sh, batch_sh), out_shardings=(psh, opt_sh, None),
                     rules=rules)
    return StepBundle(
        name=f"{cfg.name}:{shape.name}:train",
        fn=train_step,
        in_specs=(model, opt_specs, batch_specs),
        donate=(0, 1),
        init=functools.partial(_transformer, cfg),
        **shard,
    )


def build_prefill(cfg: ModelConfig, shape: InputShape, mesh) -> StepBundle:
    B, S = shape.global_batch, shape.seq_len
    long_ctx = shape.name == "long_500k"
    model, paxes = param_specs(cfg, dtype=torch.bfloat16)
    shard = {}
    if mesh is not None:
        rules = rules_for_shape(shape)
        psh = module_shardings(paxes, model, mesh, rules)
        inp = (("batch", "seq", None), (B, S, cfg.d_model)) if cfg.is_encoder \
            else (("batch", "seq"), (B, S))
        shard = dict(in_shardings=(psh, _sharding(mesh, rules, *inp)), rules=rules)

    if cfg.is_encoder:
        @torch.no_grad()
        def encode(model, features):
            h, _, _ = model(features)
            return model.unembed(h)

        return StepBundle(f"{cfg.name}:{shape.name}:encode", encode,
                          (model, _spec((B, S, cfg.d_model), torch.bfloat16)),
                          init=functools.partial(_transformer, cfg), **shard)

    @torch.no_grad()
    def prefill(model, tokens):
        """Dual-stream CFG prefill: both caches + the first sampled token."""
        logits_c, caches_c = AR.prefill(model, tokens, long_ctx=long_ctx)
        logits_u, caches_u = AR.prefill(model, AR.null_prompt(tokens), long_ctx=long_ctx)
        logits = cfg_combine(logits_u, logits_c, cfg.guidance_scale)
        tok = logits.argmax(dim=-1).to(torch.int32)
        return tok, caches_c, caches_u

    return StepBundle(f"{cfg.name}:{shape.name}:prefill", prefill,
                      (model, _spec((B, S), torch.int32)),
                      init=functools.partial(_transformer, cfg), **shard)


def build_serve_step(cfg: ModelConfig, shape: InputShape, mesh, *,
                     variant: str = "full") -> StepBundle:
    """One-token guided decode step with a ``seq_len``-deep cache/state."""
    B, S = shape.global_batch, shape.seq_len
    long_ctx = shape.name == "long_500k"
    model, paxes = param_specs(cfg, dtype=torch.bfloat16)

    def caches():
        return T.cache_specs(cfg, B, S, long_ctx=long_ctx, dtype=torch.bfloat16, device=META)

    psh = tok_sh = csh = rules = None
    if mesh is not None:
        rules = rules_for_shape(shape)
        psh = module_shardings(paxes, model, mesh, rules)
        csh = tree_shardings(T.cache_axes(cfg, S, long_ctx=long_ctx), caches(), mesh, rules)
        tok_sh = _sharding(mesh, rules, ("batch",), (B,))

    def shard(n_caches: int) -> dict:
        if mesh is None:
            return {}
        return dict(in_shardings=(psh, tok_sh) + (csh,) * n_caches,
                    out_shardings=(tok_sh,) + (csh,) * n_caches, rules=rules)

    tok_spec = _spec((B,), torch.int32)
    pos = S - 1   # cache prefilled to S-1; the step writes position S-1

    if variant == "full":
        @torch.no_grad()
        def serve_step(model, token, caches_c, caches_u):
            logits, caches_c, caches_u = AR.decode_step_full(
                model, token, caches_c, caches_u, pos, cfg.guidance_scale, long_ctx=long_ctx)
            nxt = logits.argmax(dim=-1).to(torch.int32)
            return nxt, caches_c, caches_u

        return StepBundle(f"{cfg.name}:{shape.name}:serve_full", serve_step,
                          (model, tok_spec, caches(), caches()), donate=(2, 3),
                          init=functools.partial(_transformer, cfg), **shard(2))

    @torch.no_grad()
    def serve_step_cond(model, token, caches_c):
        logits, caches_c = AR.decode_step_cond(model, token, caches_c, pos, long_ctx=long_ctx)
        nxt = logits.argmax(dim=-1).to(torch.int32)
        return nxt, caches_c

    return StepBundle(f"{cfg.name}:{shape.name}:serve_cond", serve_step_cond,
                      (model, tok_spec, caches()), donate=(2,),
                      init=functools.partial(_transformer, cfg), **shard(1))


def build(cfg: ModelConfig, shape: InputShape, mesh, *, variant="full") -> StepBundle:
    reason = skip_reason(cfg, shape)
    if reason:
        raise ValueError(f"{cfg.name} x {shape.name} skipped: {reason}")
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh)
    return build_serve_step(cfg, shape, mesh, variant=variant)


# ---------------------------------------------------------------------------
# Model-FLOPs reference (roofline "useful compute" numerator)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def param_count(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active-per-token) param counts from the spec model."""
    model, _ = param_specs(cfg, dtype=torch.bfloat16)
    total = sum(p.numel() for p in model.parameters())
    active = total
    if cfg.moe is not None:
        m = cfg.moe
        # routed expert params: 3 matrices per expert per moe layer
        n_moe_layers = cfg.num_layers - m.first_k_dense
        routed = n_moe_layers * m.num_experts * 3 * cfg.d_model * m.expert_d_ff
        active_routed = routed * m.top_k / m.num_experts
        active = total - routed + active_routed
    return int(total), int(active)


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """6*N*D (train) / 2*N*D (inference); D = tokens processed; MoE uses
    N_active; CFG prefill/decode count both streams."""
    total, active = param_count(cfg)
    n = active
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        streams = 1 if cfg.is_encoder else 2
        return 2.0 * n * shape.global_batch * shape.seq_len * streams
    return 2.0 * n * shape.global_batch * 2   # decode: 1 token x 2 streams


def recurrent_supplement(cfg: ModelConfig, shape: InputShape) -> dict:
    """Analytic FLOPs/bytes for the *time-step* loops (mLSTM/sLSTM
    prefill/train) that a meta-device run steps once (``xlstm.time_scan``).
    Whole-step numbers. Zero for decode shapes (no time loop) and non-xLSTM
    archs.
    """
    if shape.kind == "decode":
        return {"flops": 0.0, "bytes": 0.0}
    kinds = cfg.blocks
    n_m = sum(k == "mlstm" for k in kinds)
    n_s = sum(k == "slstm" for k in kinds)
    if n_m == 0 and n_s == 0:
        return {"flops": 0.0, "bytes": 0.0}
    B = shape.global_batch
    S = shape.seq_len
    if shape.kind == "prefill" and not cfg.is_encoder:
        B *= 2  # dual CFG streams
    D = cfg.d_model
    H = cfg.num_heads
    dh_m = 2 * D // H            # mLSTM head dim (proj factor 2)
    dh_s = D // H
    flops = 0.0
    byts = 0.0
    # mLSTM per step: C update (3 ops) + Cq readout (2) ~ 6*B*H*dh^2
    flops += n_m * S * 6.0 * B * H * dh_m ** 2
    byts += n_m * S * 2.0 * B * H * dh_m ** 2 * 4   # C read+write fp32
    # sLSTM per step: 4 input matmuls (8*B*D^2) + 4 recurrent (8*B*D*dh)
    flops += n_s * S * (8.0 * B * D * D + 8.0 * B * D * dh_s)
    byts += n_s * S * (4.0 * D * D * 4 + 6.0 * B * D * 4)
    mult = 3.0 if shape.kind == "train" else 1.0    # fwd+bwd(2x) for train
    return {"flops": flops * mult, "bytes": byts * mult}


# ---------------------------------------------------------------------------
# The paper's own pipeline: one guided denoising step of the production UNet
# ---------------------------------------------------------------------------


def build_sd_denoise(mesh, *, variant: str = "full", batch: int = 64):
    """One DDIM step of the SD-scale UNet under CFG, bf16 weights and
    activations.

    variant="full": 2x-batch denoiser pass + Eq.1 combine (baseline).
    variant="cond": 1x-batch conditional-only pass (the paper's optimized
    step), the structural halving on the paper's own workload.
    """
    from repro_torch.configs.sd_unet import PRODUCTION as ucfg
    from repro_torch.core.sampler import ddim_update
    from repro_torch.models import unet as U

    def init(maker):
        return U.UNet(ucfg, U.init_unet(ucfg, maker))

    unet = init(L.SpecMaker(torch.bfloat16))
    B = batch
    hw = ucfg.latent_size
    lat = _spec((B, hw, hw, ucfg.in_channels), torch.bfloat16)
    txt = _spec((B, ucfg.text_len, ucfg.text_dim), torch.bfloat16)
    scal = _spec((), torch.float32)
    t_spec = _spec((B,), torch.int32)
    in_sh = out_sh = rules = None
    if mesh is not None:
        rules = RULES_SERVE
        psh = module_shardings(U.init_unet(ucfg, L.AxesMaker()), unet, mesh, rules)
        lat_sh = _sharding(mesh, rules, ("batch", None, None, None), lat.shape)
        txt_sh = _sharding(mesh, rules, ("batch", None, None), txt.shape)
        t_sh = _sharding(mesh, rules, ("batch",), (B,))
        rep = _sharding(mesh, rules, (), ())
        in_sh = (psh, lat_sh, t_sh, txt_sh) + ((txt_sh,) if variant == "full" else ()) \
            + (rep, rep)
        out_sh = lat_sh
    shard = dict(in_shardings=in_sh, out_shardings=out_sh, rules=rules)

    if variant == "full":
        @torch.no_grad()
        def denoise_step(unet, x, t, cond, uncond, ab_t, ab_prev):
            x2 = torch.cat([x, x], dim=0)
            t2 = torch.cat([t, t], dim=0)
            txt2 = torch.cat([cond, uncond], dim=0)
            eps2 = U.unet_forward(unet, x2, t2, txt2)
            e_c, e_u = eps2[:B], eps2[B:]
            eps = cfg_combine(e_u, e_c, 7.5)
            return ddim_update(x, eps, ab_t, ab_prev)

        # cond and uncond, ab_t and ab_prev: separate tensors, each counted
        return StepBundle(f"{ucfg.name}:denoise:full", denoise_step,
                          (unet, lat, t_spec, txt, _spec(txt.shape, txt.dtype), scal,
                           _spec((), torch.float32)),
                          donate=(1,), init=init, **shard)

    @torch.no_grad()
    def denoise_step_cond(unet, x, t, cond, ab_t, ab_prev):
        eps = U.unet_forward(unet, x, t, cond)
        return ddim_update(x, eps, ab_t, ab_prev)

    return StepBundle(f"{ucfg.name}:denoise:cond", denoise_step_cond,
                      (unet, lat, t_spec, txt, scal, _spec((), torch.float32)),
                      donate=(1,), init=init, **shard)


# ---------------------------------------------------------------------------
# Argument bytes and real arguments
# ---------------------------------------------------------------------------


def leaves(tree) -> list:
    """The tensors of an argument tree (modules' parameters and buffers,
    dicts, lists and tuples), each storage once."""
    out, seen = [], set()

    def walk(x):
        if isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                walk(t)
        elif isinstance(x, torch.Tensor):
            key = id(x) if x.is_meta else x.untyped_storage().data_ptr()
            if key not in seen:
                seen.add(key)
                out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return out


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def local_bytes(tree, specs, mesh) -> int:
    """The bytes one device holds of an argument tree laid out by ``specs``
    (a ``P`` tree of the same structure; a module's entry a dict by
    parameter name) on ``mesh``: each tensor's ``local_shape``, each
    tensor once."""
    seen, total = set(), 0

    def walk(x, sp):
        nonlocal total
        if isinstance(x, torch.nn.Module):
            for name, t in x.named_parameters():
                walk(t, sp[name])
        elif isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                total += math.prod(local_shape(x.shape, sp, mesh)) * x.element_size()
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, sp[k])
        else:
            for v, s in zip(x, sp):
                walk(v, s)

    walk(tree, specs)
    return total


def materialize(bundle: StepBundle, generator: torch.Generator, device, *,
                high: int) -> tuple:
    """Real arguments for ``bundle.fn`` on ``device``, shaped and typed as
    ``in_specs``: the weights (argument 0) from ``bundle.init`` with a
    ``Maker`` drawing from ``generator`` (the models' own init, as
    ``Transformer.init`` draws them) in ``in_specs[0]``'s dtype; caches and
    the optimizer state (lists and dicts under a donated index) zero, ring
    slots empty (-1); the other tensors random: integers in [0, high),
    floats normal, booleans fair coins, and 0-d floats (the DDIM step's
    alphas-cumprod at t and at the step before) in [0.5, 1), increasing in
    argument order as a schedule's are."""
    device = torch.device(device)
    spec = next(bundle.in_specs[0].parameters())
    model = bundle.init(L.Maker(generator, spec.dtype, device))
    model.requires_grad_(spec.requires_grad)
    n_scalars = sum(1 for x in bundle.in_specs[1:]
                    if isinstance(x, torch.Tensor) and x.ndim == 0 and x.dtype.is_floating_point)
    scalars = iter(sorted((0.5 + 0.5 * torch.rand(n_scalars, generator=generator,
                                                  device=device)).tolist()))

    def draw(t: torch.Tensor) -> torch.Tensor:
        if t.dtype == torch.bool:
            return torch.rand(t.shape, generator=generator, device=device) < 0.5
        if not t.dtype.is_floating_point:
            return torch.randint(0, high, t.shape, generator=generator, device=device,
                                 dtype=t.dtype)
        if t.ndim == 0:
            return torch.tensor(next(scalars), dtype=t.dtype, device=device)
        return torch.randn(t.shape, generator=generator, device=device, dtype=t.dtype)

    def state(x, name=""):
        if isinstance(x, dict):
            return {k: state(v, k) for k, v in x.items()}
        if isinstance(x, list):
            return [state(v) for v in x]
        fill = -1 if name == "slot_pos" else 0
        return torch.full(x.shape, fill, dtype=x.dtype, device=device)

    def tensors(x):
        if isinstance(x, dict):
            return {k: tensors(v) for k, v in x.items()}
        return draw(x)

    args = [model]
    for i, x in enumerate(bundle.in_specs[1:], start=1):
        args.append(state(x) if i in bundle.donate and not isinstance(x, torch.Tensor)
                    else tensors(x))
    return tuple(args)
