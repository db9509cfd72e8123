"""The port's RG-LRU and xLSTM blocks (the analogue of
``test_recurrent.py``): each prefill (the doubling scan, the loops over
time) equal to the stepwise decode and to the reference's functions, the
decay's range, long runs that stay finite, chunked BPTT's gradients equal
to plain BPTT's, and the decode loop's static state on a recurrent stack.

Tolerances. float32 throughout: the prefill against stepwise decode and
against the reference within 1e-5 of the largest value (the same
recurrence summed in another order: the doubling scan associates the
products differently from a sequential pass, and sLSTM's input projections
run for the whole sequence at once); chunked BPTT against plain BPTT
within 1e-6 of each gradient's largest (the recompute runs the same ops).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import layers as JL
from repro.models import rglru as JRG
from repro.models import xlstm as JXL
from repro_torch import convert
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import ar_decode as AR
from repro_torch.core.selective import GuidancePlan
from repro_torch.models import layers as TL
from repro_torch.models import rglru as TRG
from repro_torch.models import xlstm as TXL
from repro_torch.models.transformer import Transformer, cache_specs

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _module(tree):
    return TL.tree_module(jax.tree.map(lambda a: convert.to_tensor(np.asarray(a)), tree))


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(out, ref, tol=TOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = ref.detach().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30))


BLOCKS = {   # kind -> (arch, reference init, port forward, reference forward, port decode,
             #          port state spec)
    "rglru": ("recurrentgemma-9b", JRG.init_rglru, TRG.rglru_forward, JRG.rglru_forward,
              TRG.rglru_decode, lambda cfg, B: TRG.rglru_state_spec(cfg, B, dtype=torch.float32,
                                                                      device="cpu")),
    "mlstm": ("xlstm-350m", JXL.init_mlstm, TXL.mlstm_forward, JXL.mlstm_forward,
              TXL.mlstm_decode, lambda cfg, B: TXL.mlstm_state_spec(cfg, B, device="cpu")),
    "slstm": ("xlstm-350m", JXL.init_slstm, TXL.slstm_forward, JXL.slstm_forward,
              TXL.slstm_decode, lambda cfg, B: TXL.slstm_state_spec(cfg, B, device="cpu")),
}


def _block(kind):
    arch, jinit, fwd, jfwd, dec, spec = BLOCKS[kind]
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    params = jinit(jcfg, JL.ArrayMaker(jax.random.PRNGKey(0)))
    return jcfg, cfg, params, _module(params), fwd, jfwd, dec, spec


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_scan_equals_stepwise_and_reference(kind):
    """The prefill over S steps equals S decode steps from the zero state
    (the state updated in place), output and final state, and the
    reference's forward on the same weights."""
    jcfg, cfg, params, p, fwd, jfwd, dec, spec = _block(kind)
    B, S = 2, 10
    x = _x((B, S, cfg.d_model), 1)
    with torch.no_grad():
        out, state = fwd(p, cfg, torch.from_numpy(x))
        st = spec(cfg, B)
        outs = [dec(p, cfg, torch.from_numpy(x[:, t:t + 1]), st)[0][:, 0] for t in range(S)]
    _close(torch.stack(outs, 1), out)
    assert set(st) == set(state)
    for name in state:
        _close(st[name], state[name])
    ref, ref_state = jfwd(params, jcfg, jnp.asarray(x))
    _close(out, ref)
    ref_state = ref_state if isinstance(ref_state, dict) else dict(zip(state, ref_state))
    for name in state:
        _close(state[name], ref_state[name])


def test_rglru_decay_in_unit_interval():
    _, cfg, _, p, *_ = _block("rglru")
    a, _ = TRG._gates(p, torch.from_numpy(_x((4, cfg.d_model), 2, 1.0)))
    assert bool((a > 0).all()) and bool((a < 1).all())


def test_rglru_long_runs_stay_finite():
    """2048 decode steps on one input, and a 2048-token prefill (the
    doubling scan multiplies decays down to underflow without a NaN),
    against the reference's associative scan."""
    jcfg, cfg, params, p, *_ = _block("rglru")
    st = TRG.rglru_state_spec(cfg, 1, dtype=torch.float32, device="cpu")
    x = torch.from_numpy(_x((1, 1, cfg.d_model), 3, 1.0))
    with torch.no_grad():
        for _ in range(2048):
            TRG.rglru_decode(p, cfg, x, st)
    assert bool(torch.isfinite(st["h"]).all()) and float(st["h"].abs().max()) < 1e3
    xs = _x((1, 2048, cfg.d_model), 4, 1.0)
    with torch.no_grad():
        out, state = TRG.rglru_forward(p, cfg, torch.from_numpy(xs))
    assert bool(torch.isfinite(out).all())
    ref, ref_state = jax.jit(lambda p, x: JRG.rglru_forward(p, jcfg, x))(params,
                                                                        jnp.asarray(xs))
    _close(out, ref)
    _close(state["h"], ref_state["h"])


def test_linear_scan_equals_the_sequential_recurrence():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (2, 37, 6)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 37, 6)).astype(np.float32))
    h, hs = torch.zeros(2, 6), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    _close(TRG.linear_scan(a, b), torch.stack(hs, 1))


def test_mlstm_exponential_gating_stable():
    """The stabiliser keeps the exponential gates finite over 256 steps of
    large inputs."""
    _, cfg, _, p, *_ = _block("mlstm")
    with torch.no_grad():
        out, state = TXL.mlstm_forward(p, cfg, torch.from_numpy(_x((1, 256, cfg.d_model), 5,
                                                                     2.0)))
    assert bool(torch.isfinite(out).all())
    assert all(bool(torch.isfinite(t).all()) for t in state.values())


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_chunked_bptt_equals_plain_bptt(kind):
    """Under autograd a 128-step sequence runs as two checkpointed chunks of
    64: its output and every gradient equal the unchunked loop's."""
    _, cfg, _, p, fwd, *_ = _block(kind)
    p.requires_grad_(True)
    x = torch.from_numpy(_x((1, 128, cfg.d_model), 6)).requires_grad_(True)
    w = torch.from_numpy(_x((1, 128, cfg.d_model), 7))
    results = []
    for chunk in (64, 0):
        out, _ = fwd(p, cfg, x, bptt_chunk=chunk)
        grads = torch.autograd.grad((out * w).sum(), [x] + list(p.parameters()))
        results.append((out.detach(), grads))
    (o1, g1), (o2, g2) = results
    assert torch.equal(o1, o2)
    for a, b in zip(g1, g2):
        _close(a, b, 1e-6)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_replayed_scan_equals_the_loop(kind, monkeypatch):
    """The GPU prefill's replay of one captured step (``_replayed_scan``),
    run here with an eager stand-in for the capture, gives the loop over
    time's output and final state bit for bit, capturing once a call."""
    _, cfg, _, p, fwd, *_ = _block(kind)
    x = torch.from_numpy(_x((2, 9, cfg.d_model), 8))
    captures = []

    def stand_in(one):
        captures.append(one)
        one()
        return one

    with torch.no_grad():
        want, want_state = fwd(p, cfg, x)
        monkeypatch.setattr(TXL, "time_scan", lambda step, state, xs, **kw:
                            TXL._replayed_scan(step, state, xs, capture=stand_in))
        got, got_state = fwd(p, cfg, x)
    assert len(captures) == 1
    assert torch.equal(got, want)
    assert got_state.keys() == want_state.keys()
    for name in want_state:
        assert torch.equal(got_state[name], want_state[name]), name


# -- the decode loop on a recurrent stack --------------------------------------------


def test_decode_loop_static_state_on_recurrentgemma(monkeypatch):
    """``decode_loop`` takes the device and batch from any cache leaf (the
    stack's first layer is ``rglru``, with no KV cache), builds static
    state for every layer's leaves, and ``load`` copies every leaf."""
    from repro_torch.core import graphs as G
    monkeypatch.setattr(G, "pool", lambda: None)
    cfg = get_smoke_config("recurrentgemma-9b")
    assert cfg.blocks[0] == "rglru"
    model = Transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 12)))
    _, cc = AR.prefill(model, toks)
    _, cu = AR.prefill(model, AR.null_prompt(toks))
    cc = model.prepare_decode_caches(cc, seq_len=12, capacity=20)
    cu = model.prepare_decode_caches(cu, seq_len=12, capacity=20)
    loop = AR.decode_loop(model, cc)
    assert len(loop.tok) == 3
    spec = cache_specs(cfg, 3, 20, dtype=torch.bfloat16, device="cpu")
    for static, fresh, want in zip(loop.caches_c, cc, spec):
        assert set(static) == set(fresh) == set(want)
        for name in fresh:
            assert static[name].shape == fresh[name].shape == want[name].shape, name
            assert static[name].dtype == fresh[name].dtype == want[name].dtype, name
            assert static[name].data_ptr() != fresh[name].data_ptr()
    loop.load(cc, cu, 12)
    for static, fresh in zip(loop.caches_c + loop.caches_u, cc + cu):
        for name, t in fresh.items():
            assert torch.equal(static[name], t), name
    assert int(loop.ctr[0]) == 12 and int(loop.ctr[1]) == 0


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b", "recurrentgemma-9b",
                                  "xlstm-350m"])
def test_graphed_decode_loop_equals_the_eager_loop(arch, monkeypatch):
    """Every decoder family through the graphed loop's control flow (an
    eager stand-in for capture, as in ``test_torch_graphs.py``): tokens and
    teacher-forced logits equal the eager loop's bit for bit, on the same
    static state across two generates."""
    from test_torch_graphs import _EagerCapture
    from repro_torch.core import graphs as G
    cap = _EagerCapture()
    monkeypatch.setattr(G, "capture", cap)
    monkeypatch.setattr(G, "pool", lambda: None)
    monkeypatch.setattr(AR, "_use_graphs", lambda graphs, tokens: bool(graphs))
    cfg = get_smoke_config(arch)
    model = Transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for seed, frac in ((1, 0.25), (2, 0.5)):
        toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 12)))
        plan = GuidancePlan.suffix(6, frac, 3.0)
        want, _ = AR.guided_decode(model, toks, plan, graphs=False)
        got, _ = AR.guided_decode(model, toks, plan, graphs=True)
        assert torch.equal(got, want)
        assert torch.equal(AR.teacher_forced_logits(model, toks, plan, want, graphs=True),
                           AR.teacher_forced_logits(model, toks, plan, want, graphs=False))
    assert len(model._decode_loops) == 1 and cap.captures == 2
