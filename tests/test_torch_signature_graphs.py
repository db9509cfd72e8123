"""The serve engine's signature steps (the slot arena's, the default, and
the paged arena's at bf16 and int8) driven through their graphed control
flow on the CPU, against the same engine run eagerly (``graphs=False``).

No CUDA here, so a capture is ``tests/test_torch_graphs.py``'s eager
stand-in (``eager_graphs``): the "capture" runs the step once, as the real
capture's warm-up does, and each "replay" runs it again and copies its
outputs into the graph's static tensors. What that checks is the graphed
step's state: one capture per signature bucket at its counted compile, the
bucket's fixed device rows, the harvest of each replay's outputs before the
next, the hot rows drawn after the replay, and the pools updated in place
(a defrag included).

Tolerance: the graphed and eager engines run the same ops on the same
rows, so tokens, events, counters and every logit are held bit for bit.
Reduced llama3.2-1b (2 layers, d_model 256, vocab 512), prompts of 8."""

import numpy as np
import pytest
import torch
from test_torch_graphs import eager_graphs  # noqa: F401  (the fixture)

from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.transformer import Transformer
from repro_torch.serve import ContinuousEngine, ServeRequest

SLOT = dict(num_slots=4, pass_budget=4, prompt_len=8, max_new=6, selective_fraction=0.5,
            stop_on_eos=False, prefills_per_tick=2)
PAGED = dict(SLOT, kv="paged", page_size=4, step_mode="signature")
ARENAS = {"slot": SLOT, "paged-bf16": PAGED, "paged-int8": dict(PAGED, kv_dtype="int8")}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops: one torch thread (as the serve tests)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("llama3.2-1b")
    return Transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")


class _Recording(ContinuousEngine):
    """Keeps the logits each token came from (every sample passes through
    ``_draw``, eager or after a replay; a copy, since a replay rewrites
    the graph's logits) and, per signature bucket, the addresses of the
    device rows its forward read at every step."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.logits: dict = {}
        self.ptrs: dict = {}

    def _draw(self, nxt, logits, uids, temps, keys, steps):
        for i, uid in enumerate(uids):
            self.logits.setdefault(uid, []).append(logits[i].clone())
        return super()._draw(nxt, logits, uids, temps, keys, steps)

    def _signature_forward(self, dev, nf, nc, argmax=False):
        self.ptrs.setdefault((nf, nc), []).append(
            tuple((name, t.data_ptr()) for name, t in dev.items()))
        return super()._signature_forward(dev, nf, nc, argmax)


def _reqs(prefix, n=5, temps=None):
    return [ServeRequest(uid=f"{prefix}{i}", prompt=f"{prefix} request {i}",
                         max_new_tokens=6 - (i % 3), guidance_scale=[3.0, 5.0][i % 2],
                         temperature=0.0 if temps is None else temps[i % len(temps)])
            for i in range(n)]


def _serve(model, kw, graphed, reqs, arrivals):
    eng = _Recording(model, model.cfg, **kw)
    eng.graphs = graphed          # as on a GPU, through the eager stand-in
    return eng, eng.serve_trace(reqs, arrivals)


def _assert_same_run(ge, go, ee, eo):
    """Graphed and eager runs of one trace: tokens, events, counters and
    every logit equal."""
    assert go == eo
    assert ge.metrics.trace.keys() == ee.metrics.trace.keys()
    for name in ("step_compiles", "step_launches", "denoiser_passes", "tokens_emitted"):
        assert getattr(ge.metrics, name) == getattr(ee.metrics, name), name
    assert ge.logits.keys() == ee.logits.keys()
    for uid in ee.logits:
        assert len(ge.logits[uid]) == len(ee.logits[uid])
        for a, b in zip(ge.logits[uid], ee.logits[uid]):
            assert torch.equal(a, b), uid


@pytest.mark.parametrize("combine", [dict(combine="cfg"), dict(combine="apg", apg_eta=0.3)],
                         ids=["cfg", "apg"])
@pytest.mark.parametrize("arena", list(ARENAS))
def test_graphed_signature_steps_equal_eager(model, eager_graphs, arena, combine):
    """Mid-flight joins and mixed guidance scales: one capture per bucket
    at its counted compile, a replay for every other step, each bucket's
    device rows at fixed addresses; tokens, events, counters and logits
    equal to the eager engine's."""
    kw = dict(ARENAS[arena], **combine)
    arrivals = [0, 0, 1, 2, 4]
    ee, eo = _serve(model, kw, False, _reqs("sig"), arrivals)
    assert eager_graphs.captures == 0 and not ee._sig_graphs
    ge, go = _serve(model, kw, True, _reqs("sig"), arrivals)
    _assert_same_run(ge, go, ee, eo)
    keys = sorted(k for k in ge._shapes if k[0] in ("step", "pstep"))
    assert keys == sorted(k for k in ee._shapes if k[0] in ("step", "pstep"))
    assert sorted(ge._sig_graphs) == keys and len(keys) > 1
    assert ge.metrics.step_compiles == len(keys) == eager_graphs.captures
    assert eager_graphs.replays == ge.metrics.step_launches - len(keys)
    for eng in (ge, ee):      # each bucket's rows never move
        for ptrs in eng.ptrs.values():
            assert len(set(ptrs)) == 1
        assert sum(len(p) for p in eng.ptrs.values()) == eng.metrics.step_launches
    # every group's rows, padding too, are the bucket's: a FULL group's
    # scales and tables or slot rows beside its tokens and positions
    ptrs = dict(ge.ptrs[next(k for k in ge.ptrs if k[0] and k[1])][0])
    want = {"f_tok", "f_pos", "f_scale", "c_tok", "c_pos"}
    want |= {"f_rows", "c_rows"} if arena == "slot" else {"f_btc", "f_btu", "c_btc"}
    assert set(ptrs) == want


@pytest.mark.parametrize("arena", ["slot", "paged-bf16"])
def test_graphed_signature_steps_draw_hot_rows_after_the_replay(model, eager_graphs, arena):
    """Rows at temperature > 0 are drawn from the graph's logits after the
    replay, from generators seeded by (key, step): the tokens equal the
    eager engine's, greedy rows and hot rows alike."""
    arrivals = [0, 0, 1, 1, 3]
    ee, eo = _serve(model, ARENAS[arena], False, _reqs("hot", temps=[0.0, 0.7]), arrivals)
    ge, go = _serve(model, ARENAS[arena], True, _reqs("hot", temps=[0.0, 0.7]), arrivals)
    _assert_same_run(ge, go, ee, eo)
    assert eager_graphs.replays > 0
    cold = _serve(model, ARENAS[arena], True, _reqs("hot"), arrivals)[1]
    assert any(go[u] != cold[u] for u in ("hot1", "hot3"))   # the draws took effect
    assert all(go[u] == cold[u] for u in ("hot0", "hot2", "hot4"))


def test_defrag_mid_trace_keeps_graphed_equal_to_eager(model, eager_graphs):
    """Short requests leave holes while a long one decodes; the defrag
    permutes the pools' rows in place, so the buckets captured before it
    replay after it on the moved rows and the graphed run equals the eager
    one."""
    kw = dict(num_slots=3, pass_budget=6, prompt_len=8, max_new=10, selective_fraction=0.5,
              stop_on_eos=False, defrag_threshold=0.3, prefills_per_tick=3)

    def reqs():
        return [ServeRequest(uid="s0", prompt="short zero", max_new_tokens=2),
                ServeRequest(uid="s1", prompt="short one", max_new_tokens=2),
                ServeRequest(uid="long", prompt="the long request", max_new_tokens=10)]

    ee, eo = _serve(model, kw, False, reqs(), [0, 0, 0])
    ge, go = _serve(model, kw, True, reqs(), [0, 0, 0])
    assert ("defrag",) in ge._shapes and ge.pool.fragmentation() == 0.0
    _assert_same_run(ge, go, ee, eo)
    assert eager_graphs.replays == ge.metrics.step_launches - len(ge._sig_graphs) > 0


def test_signature_graphs_default_and_options(model):
    """``graphs=None`` is on for every step mode on a GPU and eager on the
    CPU; ``graphs=True`` on the CPU raises."""
    cfg = model.cfg
    for kw in (SLOT, PAGED, dict(PAGED, step_mode="ragged")):
        assert not ContinuousEngine(model, cfg, **kw).graphs
        with pytest.raises(ValueError, match="CUDA"):
            ContinuousEngine(model, cfg, graphs=True, **kw)
    eng = ContinuousEngine(model, cfg, **SLOT)
    out = eng.serve(_reqs("cpu", n=2))
    assert not eng._sig_graphs and len(eng._sig_stagings) == eng.metrics.step_compiles
    assert all(len(v) >= 1 for v in out.values())
    assert np.all([st["dev_ibuf"].device.type == "cpu" for st in eng._sig_stagings.values()])
