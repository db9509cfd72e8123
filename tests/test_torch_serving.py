"""The port's ``ServingEngine`` facade (static batches over the continuous
engine's slot arena) against the reference's on the same converted weights,
on the CPU at the reduced llama3.2-1b, and the analogue of
``tests/test_system.py::test_serving_side_pass_saving`` on the reduced
qwen3-14b: the plan that drives guided sampling drives the serve engine's
pass accounting, 2 x (8 x 2 + 2 x 1) passes for two requests of 10 tokens
at f = 0.2."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServing
from repro_torch import convert
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.transformer import Transformer
from repro_torch.serving import Request, ServingEngine


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The engines run thousands of small ops: on a machine shared by
    several test workers, torch's thread pool spends more time waiting than
    computing, so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jget_smoke("llama3.2-1b"), get_smoke_config("llama3.2-1b")
    params = JT.init_model(jcfg, JL.ArrayMaker(jax.random.PRNGKey(0)))
    model = Transformer.from_state_dict(
        cfg, convert.from_jax_model_params(jax.tree.map(np.asarray, params)))
    return (jcfg, params), (cfg, model)


def _reqs(R):
    return [R(uid=f"r{i}", prompt=f"a red disc number {i}", max_new_tokens=[8, 5, 8][i % 3],
              guidance_scale=[4.0, 2.0, 6.0][i % 3]) for i in range(5)]


def test_facade_equals_reference(pair):
    """Two buckets (max_batch 3), per-request scales and lengths: tokens,
    bucket stats and the compiled shapes equal the reference facade's."""
    (jcfg, params), (cfg, model) = pair
    kw = dict(max_batch=3, prompt_len=8, max_new=8, selective_fraction=0.25)
    jeng, teng = JServing(params, jcfg, **kw), ServingEngine(model, cfg, **kw)
    jout, tout = jeng.generate(_reqs(JRequest)), teng.generate(_reqs(Request))
    assert tout == jout
    for name in ("batches", "requests", "tokens_generated", "denoiser_passes"):
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    assert teng.stats.batches == 2 and teng.stats.wall_s > 0
    assert teng._engine.kv == "slot"
    assert set(teng._compiled) == set(jeng._compiled)
    assert teng._engine.metrics.trace.keys() == jeng._engine.metrics.trace.keys()


def test_selective_reduces_passes_and_reuses_shapes(pair):
    _, (cfg, model) = pair
    reqs = [Request(uid="a", prompt="hello world")]
    base = ServingEngine(model, cfg, max_batch=1, prompt_len=8, max_new=16,
                         selective_fraction=0.0)
    sel = ServingEngine(model, cfg, max_batch=1, prompt_len=8, max_new=16,
                        selective_fraction=0.5)
    base.generate(reqs)
    sel.generate(reqs)
    assert (sel.stats.denoiser_passes, base.stats.denoiser_passes) == (24, 32)
    eng = ServingEngine(model, cfg, max_batch=2, prompt_len=8, max_new=4)
    two = [Request(uid=f"x{i}", prompt="p") for i in range(2)]
    eng.generate(two)
    n = len(eng._compiled)
    eng.generate(two)
    assert len(eng._compiled) == n


def test_per_request_scale_and_truncation(pair):
    """``test_serve.py``'s facade regressions: a mixed-scale bucket equals
    solo runs, and ``tokens_generated`` counts delivered tokens."""
    _, (cfg, model) = pair
    reqs = [Request(uid="lo", prompt="a quiet prompt", max_new_tokens=6, guidance_scale=1.0),
            Request(uid="hi", prompt="a loud prompt", max_new_tokens=6, guidance_scale=6.0)]
    kw = dict(max_batch=2, prompt_len=8, max_new=6, selective_fraction=0.5)
    mixed = ServingEngine(model, cfg, **kw).generate(reqs)
    for req in reqs:
        assert mixed[req.uid] == ServingEngine(model, cfg, **kw).generate([req])[req.uid]
    eng = ServingEngine(model, cfg, max_batch=2, prompt_len=8, max_new=8,
                        selective_fraction=0.25)
    out = eng.generate([Request(uid="short", prompt="tiny", max_new_tokens=3),
                        Request(uid="full", prompt="regular", max_new_tokens=8)])
    assert len(out["short"]) <= 3
    assert eng.stats.tokens_generated == sum(len(v) for v in out.values())


def test_serving_side_pass_saving():
    """``test_system.py::test_serving_side_pass_saving`` on the port: the
    facade with its defaults (the slot arena) on the reduced qwen3-14b."""
    cfg = get_smoke_config("qwen3-14b")
    model = Transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServingEngine(model, cfg, max_batch=2, prompt_len=8, max_new=10,
                        selective_fraction=0.2)
    out = eng.generate([Request(uid="u1", prompt="a person holding a cat"),
                        Request(uid="u2", prompt="a silver dragon head")])
    assert len(out) == 2
    assert eng.stats.denoiser_passes == 2 * (8 * 2 + 2 * 1)
