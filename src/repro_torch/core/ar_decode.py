"""Guided autoregressive decoding with selective guidance. Counterpart of
``repro/core/ar_decode.py``.

Two streams, conditional (the prompt) and unconditional (the null prompt,
all PAD = 0), each with its own cache and its own forward per step:

    logits_hat = logits_uncond + s * (logits_cond - logits_uncond)

A FULL step runs both forwards and the combine; a COND step (the plan's
suffix) runs the conditional forward alone. Plans must be suffix-only:
after the switch the unconditional cache is stale and is never touched
again. Caches are updated in place (the reference threads them
functionally); the two streams own separate cache tensors.

The functions take a ``Transformer`` where the reference takes
``(params, cfg)``; randomness for temperature sampling comes from a
``torch.Generator`` (the reference's threefry bits are not reproduced).

On CUDA tensors the decode loop runs as CUDA graphs (``graphs=None`` or
``True``), the counterpart of the reference's one ``lax.scan`` a plan
segment: a FULL step (both forwards and the combine) and a COND step (one
forward) are each captured once per (batch, caches' shapes, combine) and
replayed once a step, on static caches that every generate of that shape
reuses (the prefill's caches are copied in) and a position counter on the
device that each replay advances. Prefill and sampling stay eager: the
prompt's length varies, and the draws use the caller's generator (an
xLSTM layer's prefill loop replays one captured time step on CUDA in
both modes, ``models/xlstm.py``). ``graphs=False`` runs every decode
step eagerly, as the CPU always does.
"""

from __future__ import annotations

import torch

from repro_torch.core import graphs as G
from repro_torch.core.guidance import apg_combine, cfg_combine, cfg_combine_rowscale
from repro_torch.core.selective import GuidancePlan, Mode, round_half_up
from repro_torch.models import attention as A

PAD = 0
COMBINES = ("cfg", "apg", "interval")


def _sample_token(logits, temperature: float, generator=None):
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def prefill(model, tokens, *, long_ctx: bool = False):
    """One stream's prefill. tokens (B,S) -> (last logits (B,V) float32,
    per-layer caches)."""
    h, caches, _ = model(tokens, want_caches=True, long_ctx=long_ctx)
    return model.unembed(h[:, -1:, :].contiguous())[:, 0, :].float(), caches


def null_prompt(tokens):
    """The CFG null stream: PAD tokens, the prompt's shape."""
    return torch.full_like(tokens, PAD)


@torch.no_grad()
def decode_step_full(model, token, caches_c, caches_u, pos, scale, *,
                     long_ctx: bool = False, combine_fn=None):
    """The baseline CFG step: two forwards and Eq. 1 (or ``combine_fn(l_u,
    l_c)``). token (B,) -> (logits_hat (B,V) float32, caches_c, caches_u)."""
    emb = model.embed_tokens(token[:, None])
    h_c, caches_c = model.decode_step(emb, caches_c, pos, long_ctx=long_ctx)
    h_u, caches_u = model.decode_step(emb, caches_u, pos, long_ctx=long_ctx)
    l_c = model.unembed(h_c)[:, 0, :].float()
    l_u = model.unembed(h_u)[:, 0, :].float()
    if combine_fn is not None:
        return combine_fn(l_u, l_c), caches_c, caches_u
    return cfg_combine(l_u, l_c, scale), caches_c, caches_u


@torch.no_grad()
def decode_step_cond(model, token, caches_c, pos, *, long_ctx: bool = False):
    """The paper's optimized step: the conditional stream alone."""
    emb = model.embed_tokens(token[:, None])
    h_c, caches_c = model.decode_step(emb, caches_c, pos, long_ctx=long_ctx)
    return model.unembed(h_c)[:, 0, :].float(), caches_c


class _DecodeLoop:
    """The captured decode loop of one (batch, caches' shapes, long_ctx):
    both streams' static caches (every layer's state dict: KV caches, rings,
    MLA latents, recurrent states), the token a step reads, the device
    counter ``ctr`` = (pos, step i) that each step advances, the interval
    combine's bounds [a, b) and scale, and the FULL and COND graphs, keyed
    by their combine, in one memory pool."""

    def __init__(self, model, caches, long_ctx: bool):
        # any leaf but a ring's (W,) slot_pos leads with the batch
        leaf = next(t for c in caches for t in c.values() if t.ndim >= 2)
        dev, B = leaf.device, leaf.shape[0]
        self.model, self.long_ctx = model, long_ctx
        self.caches_c = [{n: torch.empty_like(t) for n, t in c.items()} for c in caches]
        self.caches_u = [{n: torch.empty_like(t) for n, t in c.items()} for c in caches]
        self.tok = torch.zeros(B, dtype=torch.long, device=dev)
        self.ctr = torch.zeros(2, dtype=torch.int32, device=dev)
        self.bounds = torch.zeros(2, dtype=torch.int32, device=dev)
        self.scale = torch.ones(1, device=dev)
        self.one = torch.ones(1, device=dev)
        self.pool = G.pool()
        self.graphs: dict = {}

    def load(self, caches_c, caches_u, S: int, bounds=(0, 0), scale: float = 1.0) -> None:
        """A generate's prefilled caches, its first position and its interval."""
        for static, fresh in zip(self.caches_c + self.caches_u, caches_c + caches_u):
            for n, t in fresh.items():
                static[n].copy_(t)
        self.ctr[0].fill_(S)
        self.ctr[1].fill_(0)
        self.bounds[0].fill_(bounds[0])
        self.bounds[1].fill_(bounds[1])
        self.scale.fill_(scale)

    def interval_scales(self):
        """(B,) float32: the scale at steps a <= i < b, else 1.0."""
        i = self.ctr[1:]
        inside = (self.bounds[:1] <= i) & (i < self.bounds[1:])
        return torch.where(inside, self.scale, self.one).expand(len(self.tok)).contiguous()

    def full(self, scale, combine_fn):
        pos = A.decode_pos(self.ctr[:1], None)
        logits, _, _ = decode_step_full(self.model, self.tok, self.caches_c, self.caches_u, pos,
                                        scale, long_ctx=self.long_ctx, combine_fn=combine_fn)
        self.ctr.add_(1)
        return logits

    def cond(self):
        logits, _ = decode_step_cond(self.model, self.tok, self.caches_c,
                                     A.decode_pos(self.ctr[:1], None), long_ctx=self.long_ctx)
        self.ctr.add_(1)
        return logits

    def step(self, key, fn):
        """One step: ``fn``'s graph replayed, or, the first time, ``fn`` run
        and captured. -> the step's float32 logits (the graph's static
        output: rewritten by the next replay)."""
        graph = self.graphs.get(key)
        if graph is None:
            self.graphs[key], logits = G.capture(fn, self.pool)
            return logits
        return graph.replay()


def decode_loop(model, caches, long_ctx: bool = False) -> _DecodeLoop:
    """The model's captured decode loop for caches shaped as ``caches``
    (made at first use and kept on the model)."""
    key = (long_ctx, tuple(tuple((n, tuple(t.shape), t.dtype) for n, t in sorted(c.items()))
                           for c in caches))
    loops = getattr(model, "_decode_loops", None)
    if loops is None:
        loops = model._decode_loops = {}
    if key not in loops:
        loops[key] = _DecodeLoop(model, caches, long_ctx)
    return loops[key]


def _use_graphs(graphs: bool | None, tokens) -> bool:
    if graphs and not tokens.is_cuda:
        raise ValueError("graphs=True needs CUDA tensors: a CUDA graph captures the card's "
                         "launches")
    return tokens.is_cuda if graphs is None else bool(graphs)


@torch.no_grad()
def _run(model, prompt_tokens, plan: GuidancePlan, next_token, *, long_ctx, capacity,
         combine, apg_eta, apg_threshold, interval, graphs):
    """Prefills both streams, then runs the plan's steps (as CUDA graphs if
    ``graphs``). ``next_token(logits, i)`` gives token i from the logits that
    choose it, for i = 0..n_new; the last call's token is unused (the
    reference runs ``plan.total_steps`` decode steps and drops the last
    one's logits)."""
    if combine not in COMBINES:
        raise ValueError(f"unknown combine mode {combine!r}")
    plan.validate_for_ar()
    use_graphs = _use_graphs(graphs, prompt_tokens)
    B, S = prompt_tokens.shape
    n_new = plan.total_steps
    cap = capacity or (S + n_new)
    logits_c, caches_c = prefill(model, prompt_tokens, long_ctx=long_ctx)
    logits_u, caches_u = prefill(model, null_prompt(prompt_tokens), long_ctx=long_ctx)
    caches_c = model.prepare_decode_caches(caches_c, seq_len=S, capacity=cap, long_ctx=long_ctx)
    caches_u = model.prepare_decode_caches(caches_u, seq_len=S, capacity=cap, long_ctx=long_ctx)

    s = plan.guidance_scale
    a = b = 0
    if combine == "interval":
        lo, hi = (0.0, 1.0) if interval is None else interval
        a, b = round_half_up(n_new * lo), round_half_up(n_new * hi)

    def combine_logits(l_u, l_c, i):
        if combine == "apg":
            return apg_combine(l_u, l_c, s, eta=apg_eta, threshold=apg_threshold)
        if combine == "interval":
            # u + 1.0 * (c - u) outside the interval, as the reference's
            # traced scale computes it: no s == 1 short-circuit
            sc = s if a <= i < b else 1.0
            return cfg_combine_rowscale(l_u, l_c, torch.full((B,), sc, device=l_c.device))
        return cfg_combine(l_u, l_c, s)

    tok = next_token(combine_logits(logits_u, logits_c, 0), 0)
    outs = []
    if use_graphs:
        loop = decode_loop(model, caches_c, long_ctx)
        loop.load(caches_c, caches_u, S, (a, b), s)
        del caches_c, caches_u
        if combine == "interval":
            full_key = ("full", combine)
            fn = lambda l_u, l_c: cfg_combine_rowscale(l_u, l_c, loop.interval_scales())  # noqa: E731
        else:
            full_key = ("full", combine, s, apg_eta, apg_threshold)
            fn = None if combine == "cfg" else (lambda l_u, l_c: combine_logits(l_u, l_c, 0))
        for i, mode in enumerate(plan.modes()):
            outs.append(tok)
            loop.tok.copy_(tok)
            if mode is Mode.FULL:
                logits = loop.step(full_key, lambda: loop.full(s, fn))
            else:
                logits = loop.step(("cond",), loop.cond)
            tok = next_token(logits, i + 1)
        return torch.stack(outs, dim=1), S + n_new
    for i, mode in enumerate(plan.modes()):
        outs.append(tok)
        if mode is Mode.FULL:
            logits, caches_c, caches_u = decode_step_full(
                model, tok, caches_c, caches_u, S + i, s, long_ctx=long_ctx,
                combine_fn=lambda l_u, l_c: combine_logits(l_u, l_c, i))
        else:
            logits, caches_c = decode_step_cond(model, tok, caches_c, S + i,
                                                long_ctx=long_ctx)
        tok = next_token(logits, i + 1)
    return torch.stack(outs, dim=1), S + n_new


def guided_decode(model, prompt_tokens, plan: GuidancePlan, *, generator=None,
                  temperature: float = 0.0, long_ctx: bool = False,
                  capacity: int | None = None, combine: str = "cfg", apg_eta: float = 0.0,
                  apg_threshold: float = 0.0, interval: tuple[float, float] | None = None,
                  graphs: bool | None = None):
    """End-to-end guided generation. prompt_tokens (B,S) on the model's
    device; ``plan.total_steps`` new tokens. -> (generated (B, n_new) int64,
    final position).

    ``combine``: Eq. 1 (``"cfg"``), APG (``"apg"``, with ``apg_eta`` and
    ``apg_threshold``), or Eq. 1 at scale 1.0 outside ``interval`` (fractions
    of the plan; ``"interval"``). With ``temperature > 0`` tokens are drawn
    from ``generator``. ``graphs``: run the steps as CUDA graphs (None: for
    CUDA tensors; True raises on the CPU; False: eager)."""
    return _run(model, prompt_tokens, plan,
                lambda logits, i: _sample_token(logits, temperature, generator),
                long_ctx=long_ctx, capacity=capacity, combine=combine, apg_eta=apg_eta,
                apg_threshold=apg_threshold, interval=interval, graphs=graphs)


def teacher_forced_logits(model, prompt_tokens, plan: GuidancePlan, tokens, *,
                          long_ctx: bool = False, capacity: int | None = None,
                          combine: str = "cfg", apg_eta: float = 0.0,
                          apg_threshold: float = 0.0,
                          interval: tuple[float, float] | None = None,
                          graphs: bool | None = None):
    """The float32 logits (B, n_new, V) that choose each of ``tokens``
    (B, n_new) when the decode is fed ``tokens`` instead of its own choices;
    the other arguments as in ``guided_decode``. Two runs fed the same tokens
    compare step by step, and each step's top-2 margin says where a token
    could flip. ``tokens=None`` feeds each step its own argmax: the logits
    of the greedy ``guided_decode``, whose tokens their ``argmax(-1)`` is."""
    n_new = plan.total_steps
    if tokens is not None and tuple(tokens.shape) != (prompt_tokens.shape[0], n_new):
        raise ValueError(f"tokens {tuple(tokens.shape)} for {n_new} steps")
    logits = []

    def forced(step_logits, i):
        if i < n_new:
            logits.append(step_logits.clone())   # a graph's logits are rewritten next step
            return step_logits.argmax(dim=-1) if tokens is None else tokens[:, i]
        return None

    _run(model, prompt_tokens, plan, forced, long_ctx=long_ctx, capacity=capacity,
         combine=combine, apg_eta=apg_eta, apg_threshold=apg_threshold, interval=interval,
         graphs=graphs)
    return torch.stack(logits, dim=1)
