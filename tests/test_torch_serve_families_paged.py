"""The GQA families with MoE or qk-norm on the port's paged arena: the
reduced mixtral-8x7b (MoE FFNs under a sliding window) and chameleon-34b
(qk-norm), each against the reference's paged ``ContinuousEngine`` on the
same weights and trace, with ``tests/test_torch_serve_families.py``'s run
contract (events and every counter equal, ``kv_hbm_bytes()`` equal, greedy
tokens equal up to the first step the port's logits do not decide, MoE
router margins of live tokens at least 0.03):

* mixtral, the ragged step over int8 pages with lazy reservation and a
  host tier: growth, the shared uncond prefix and its copy-on-write,
  preemptions whose pages go to the host tier and come back;
* chameleon, the ragged step over bf16 pages with lazy reservation and
  the content prefix cache: a repeated prompt hits, and preemptions resume
  by recompute.

The prefills route each batch of a length bucket as the reference does,
padded to (kb, Sb): a row a group, with the padding positions in it. Then,
port against port: the signature step (B9/B10's plain versions) gives the
ragged step's tokens and events at both pool dtypes under eager
reservation (the reference's ragged == signature contract, which its own
tests hold; each reference step compiles for seconds, so the signature
buckets are held through the ragged step), and graphed equals eager.
"""

import numpy as np
import pytest
import torch
from test_torch_serve_families import (WEIGHT_SEED, Drawn, Recording, check, eager_capture,
                                       in_child, run, run_cases, steps, verdict, world)

from repro_torch.serve import ServeRequest
from repro_torch.serve.state import kv_page_bytes

BASE = dict(num_slots=4, pass_budget=6, prompt_len=8, max_new=6, stop_on_eos=False,
            kv="paged", page_size=4, prefills_per_tick=2)
PRIOS, ARRIVALS = [0, 2, 1, 0], [0, 0, 1, 2]
# per family: the weights' seed and the prompts' prefix (router margins of
# at least 0.03 for mixtral), the prompt lengths, the pool, the scenario
SEED = {"mixtral-8x7b": 38, "chameleon-34b": WEIGHT_SEED}
PREFIX = {"mixtral-8x7b": "w2", "chameleon-34b": "w2"}
LENS = {"mixtral-8x7b": [8, 8, 6, 8], "chameleon-34b": [8, 6, 8, 8]}
SCENARIOS = {
    "mixtral-8x7b": dict(BASE, reservation="lazy", num_pages=9, step_mode="ragged",
                         kv_dtype="int8"),
    "chameleon-34b": dict(BASE, reservation="lazy", num_pages=11, step_mode="ragged",
                          kv_dtype="bf16", prefix_cache="content"),
}


def fam(arch: str):
    return world(arch, SEED[arch])


def scenario(arch: str) -> dict:
    kw = dict(SCENARIOS[arch])
    if arch == "mixtral-8x7b":
        kw["host_pool_bytes"] = 16 * kv_page_bytes(fam(arch)[1], 4, kw["kv_dtype"])
    return kw


def contended(arch: str):
    """Four requests of mixed lengths and priorities in a tight pool,
    suffix fractions 0.25 and 0.5; chameleon's third repeats its first's
    prompt (a content-cache hit once the founder has run)."""
    prompts = [f"{PREFIX[arch]} {i}" for i in range(4)]
    if arch == "chameleon-34b":
        prompts[2] = prompts[0]

    def make(R):
        return [R(uid=f"p{i}", prompt=prompts[i], max_new_tokens=6, guidance_scale=3.0,
                  selective_fraction=[0.25, 0.5][i % 2], prompt_len=LENS[arch][i],
                  priority=PRIOS[i]) for i in range(4)]
    return make


_RUNS: dict = {}


def paged_run(arch: str):
    if arch not in _RUNS:
        _RUNS[arch] = run(arch, scenario(arch), contended(arch), ARRIVALS, SEED[arch])
    return _RUNS[arch]


def _case_paged_arena_matches_reference(arch):
    jeng, jout, teng, tout = paged_run(arch)
    check(arch, jeng, jout, teng, tout, contended(arch)(ServeRequest))
    assert steps(teng) == sorted(k for k in jeng._jit if k[0] in ("rstep", "pstep"))
    m = teng.metrics
    assert m.preemptions >= 1 and m.resumes == m.preemptions
    assert m.pages_grown > 0 and m.shared_page_hits > 0 and m.pages_reclaimed > 0
    assert m.cow_copies > 0 and steps(teng) == [("rstep", teng.ragged_rows)]
    if arch == "mixtral-8x7b":
        assert m.swap_outs >= 1 and m.swap_ins >= 1
    else:
        assert m.prefix_hits >= 1


def _case_ragged_equals_signature_with_eager_reservation(arch, kv_dtype):
    """Eager reservation, both pool dtypes: the ragged step (B7/B8's plain
    versions) and the signature step (B9/B10's) serve the contended trace
    with the same tokens and the same events but the step keys."""
    kw = dict(BASE, num_pages=24, kv_dtype=kv_dtype)
    outs = {}
    for mode in ("ragged", "signature"):
        eng = Recording(fam(arch)[3], fam(arch)[1], step_mode=mode, **kw)
        outs[mode] = (eng, eng.serve_trace(contended(arch)(ServeRequest), ARRIVALS))
    (re, ro), (se, so) = outs["ragged"], outs["signature"]
    assert ro == so and all(len(v) == 6 for v in ro.values())

    def events(m):
        return [k for k in m.trace.keys() if k[0] != "step_compile"]

    assert events(re.metrics) == events(se.metrics)
    assert re.metrics.preemptions == 0 and re.pages.n_free == re.pages.num_pages
    for uid in ro:
        for a, b in zip(re.logits[uid], se.logits[uid]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


def _case_graphed_paged_steps_equal_eager(arch, step_mode):
    """Each family's scenario through the graphed control flow (the ragged
    step captured once; each signature bucket once) equals the eager
    engine bit for bit, preemption, host tier and content cache included."""
    _, cfg, _, model = fam(arch)
    runs = []
    with eager_capture() as eager_graphs:
        for graphed in (False, True):
            eng = Drawn(model, cfg, **dict(scenario(arch), step_mode=step_mode))
            eng.graphs = graphed
            runs.append((eng, eng.serve_trace(contended(arch)(ServeRequest), ARRIVALS)))
    (ee, eo), (ge, go) = runs
    assert go == eo and ge.metrics.trace.keys() == ee.metrics.trace.keys()
    assert eager_graphs.captures == len(steps(ge)) and eager_graphs.replays > 0
    assert ge.metrics.preemptions > 0
    for uid in ee.logits:
        assert all(torch.equal(a, b) for a, b in zip(ge.logits[uid], ee.logits[uid]))


# -- the tests: each case's verdict, from one child process (see
# ``tests/test_torch_serve_families.py``) ---------------------------------------------------

ARCHS = sorted(SCENARIOS)
CASES = {f"paged_arena_matches_reference[{a}]": (_case_paged_arena_matches_reference, (a,))
         for a in ARCHS}
CASES.update({f"ragged_equals_signature_with_eager_reservation[{a}-{dt}]": (
    _case_ragged_equals_signature_with_eager_reservation, (a, dt))
    for a in ARCHS for dt in ("bf16", "int8")})
CASES.update({f"graphed_paged_steps_equal_eager[{a}-{mode}]": (
    _case_graphed_paged_steps_equal_eager, (a, mode))
    for a in ARCHS for mode in ("ragged", "signature")})
assert run_cases                     # the child's entry point, imported for it


@pytest.fixture(scope="module")
def verdicts(tmp_path_factory):
    return in_child(__name__, tmp_path_factory)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_arena_matches_reference(verdicts, arch):
    verdict(verdicts, f"paged_arena_matches_reference[{arch}]")


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_equals_signature_with_eager_reservation(verdicts, arch, kv_dtype):
    verdict(verdicts, f"ragged_equals_signature_with_eager_reservation[{arch}-{kv_dtype}]")


@pytest.mark.parametrize("step_mode", ["ragged", "signature"])
@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_paged_steps_equal_eager(verdicts, arch, step_mode):
    verdict(verdicts, f"graphed_paged_steps_equal_eager[{arch}-{step_mode}]")
