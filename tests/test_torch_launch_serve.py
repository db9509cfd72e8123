"""The port's serve CLI (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``) on the CPU: the same
``argparse.Namespace`` and the same weights (the reference's reduced
llama3.2-1b from ``ArrayMaker``, converted), static, continuous (slot;
paged eager; paged lazy with the content prefix cache) and a two-replica
fleet. Every line each prints is compared with its walls, rates and tick
timings taken out: every count is equal. The static runs' greedy
``sample[...]`` tokens are equal up to the first step the logits do not
decide: activations are bf16 on both sides, and a token whose top-2 margin
is within rounding may flip. Where the two samples first differ, the
port's teacher-forced logits on the reference's tokens must hold the two
candidates within ``2 * LOGIT_TOL * (2s - 1)`` of the largest logit
(``tests/test_torch_serve.py``'s rule: Eq. 1 multiplies the streams'
differences by 2s - 1). Then every ``ap.error`` and the encoder exit give
the reference's message, in the reference's order."""

import argparse
import ast
import contextlib
import io
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.launch import serve as JS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import ar_decode as AR
from repro_torch.core.selective import GuidancePlan
from repro_torch.data.prompts import PAPER_PROMPTS
from repro_torch.data.tokenizer import encode
from repro_torch.launch import serve as TS
from repro_torch.models.transformer import Transformer

# summary keys timed on the host's clock, not counted
TIMED_KEYS = ("wall_s", "tick_s")
LOGIT_TOL = 3e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
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


def _args(argv) -> argparse.Namespace:
    """The port's parser's Namespace for ``argv`` (the reference's flags
    and --device)."""
    return TS.parse_args(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu"] + argv)


def _printed(fn, *a) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a)
    return buf.getvalue().splitlines()


def _samples(lines: list[str]) -> list[list[int]]:
    return [ast.literal_eval(line.split(": ", 1)[1]) for line in lines if "sample[" in line]


def _sample_undecided_at_first_difference(model, cfg, args, frac, want, got) -> None:
    if got == want:
        return
    k = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    prompt = torch.tensor([encode(PAPER_PROMPTS[0], cfg.vocab_size, args.prompt_len)])
    plan = GuidancePlan.suffix(args.max_new, frac, guidance_scale=args.guidance_scale)
    logits = AR.teacher_forced_logits(model, prompt, plan, torch.tensor([want]),
                                      graphs=False)[0, k]
    tol = 2 * LOGIT_TOL * (2 * args.guidance_scale - 1) * logits.abs().max().item()
    gap = (logits[got[k]] - logits[want[k]]).abs().item()
    assert gap <= tol, (k, want, got, gap, tol)


def _counts(lines: list[str], trace_path=None) -> list:
    """Each line with what the host's clock decides taken out: summary
    dicts lose ``wall_s`` and ``tick_s``; ``wall=``, ``tok/s=`` go, and
    the greedy samples, held by ``_sample_undecided_at_first_difference``."""
    out = []
    for line in lines:
        if "sample[" in line:
            out.append(line.split(": ", 1)[0])
            continue
        m = re.match(r"^(\[[^\]]*\]) (\{.*\})$", line)
        if m:
            d = ast.literal_eval(m.group(2))
            for k in TIMED_KEYS:
                d.pop(k)
            out.append((m.group(1), d))
            continue
        line = re.sub(r" wall=[0-9.]+s", "", line)
        line = re.sub(r" tok/s=[0-9.]+", "", line)
        if trace_path is not None:
            line = line.replace(str(trace_path), "TRACE")
        out.append(line)
    return out


COMMON = ["--requests", "5", "--batch", "2", "--prompt-len", "8", "--max-new", "6",
          "--fraction", "0.5", "--rate", "1.5"]

CASES = {
    "static": [],
    "continuous_slot": ["--mode", "continuous"],
    "continuous_paged_eager": ["--mode", "continuous", "--kv", "paged", "--page-size", "4"],
    "continuous_paged_lazy_content": ["--mode", "continuous", "--kv", "paged", "--page-size",
                                      "4", "--reservation", "lazy", "--prefix-cache", "content",
                                      "--trace-out", "TRACE"],
    "fleet_two_replicas": ["--mode", "continuous", "--kv", "paged", "--page-size", "4",
                           "--reservation", "lazy", "--prefix-cache", "content",
                           "--replicas", "2", "--trace-out", "TRACE"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_counts_equal_the_reference(pair, case, tmp_path):
    (jcfg, params), (cfg, model) = pair
    argv = [str(tmp_path / "trace.json") if a == "TRACE" else a
            for a in COMMON + CASES[case]]
    args = _args(argv)
    if args.replicas > 1:
        runs = (JS.run_fleet, TS.run_fleet)
    elif args.mode == "continuous":
        runs = (JS.run_continuous, TS.run_continuous)
    else:
        runs = (JS.run_static, TS.run_static)
    want = _printed(runs[0], params, jcfg, args)
    got = _printed(runs[1], model, cfg, args)
    assert _counts(got, tmp_path / "trace.json") == _counts(want, tmp_path / "trace.json")
    tags = [line.split("]")[0] + "]" for line in got if line.startswith("[")]
    if case == "static":
        assert tags.count("[baseline ]") == 1 and tags.count("[selective]") == 1
        assert len(_samples(got)) == 2
        for frac, w, g in zip((0.0, args.fraction), _samples(want), _samples(got)):
            _sample_undecided_at_first_difference(model, cfg, args, frac, w, g)
    elif case == "fleet_two_replicas":
        assert "[replica 1 ]" in tags and "[trace     ]" in tags
    else:
        assert "[continuous]" in tags and "[static    ]" in tags
        if "lazy" in case:
            assert "[lazy      ]" in tags and "[tier      ]" in tags


def test_paged_cli_runs_equal_the_simulator():
    """The CLI's continuous paged lazy run with the content cache, and the
    same over two replicas, against the port simulator on the CLI's trace
    (its Poisson arrivals, its prompts labelled by their token ids) and
    knobs: counters and events equal, replica by replica."""
    from repro_torch.serve import SimRequest, simulate, simulate_fleet
    from repro_torch.serve.state import content_key

    argv = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--mode", "continuous",
            "--kv", "paged", "--page-size", "4", "--reservation", "lazy", "--prefix-cache",
            "content", "--requests", "16", "--prompt-len", "16", "--max-new", "8"]
    args = _args(argv[5:])
    reqs, arrivals = TS._trace_requests(args)
    plan = GuidancePlan.suffix(args.max_new, args.fraction, guidance_scale=args.guidance_scale)
    for replicas in (1, 2):
        with contextlib.redirect_stdout(io.StringIO()):
            out = TS.main(argv + ["--replicas", str(replicas)])
        engines = [out["continuous"]] if replicas == 1 else out.engines
        eng = engines[0]
        trace = [SimRequest(r.uid, a, plan, prompt_len=args.prompt_len,
                            content=content_key(eng._tokenize(r.prompt, args.prompt_len)))
                 for r, a in zip(reqs, arrivals)]
        kw = dict(num_slots=2 * args.batch, pass_budget=2 * args.batch, kv="paged",
                  page_size=4, prefills_per_tick=2, step_mode="ragged", reservation="lazy",
                  prefix_cache="content")
        sims = [simulate(trace, **kw).metrics] if replicas == 1 else \
            simulate_fleet(trace, 2, policy="affinity", seed=args.seed, **kw).metrics
        for em, sm in zip([e.metrics for e in engines], sims):
            assert em.trace.keys() == sm.trace.keys()
            for k in ("ticks", "denoiser_passes", "prefill_passes", "pages_grown",
                      "shared_page_hits", "pages_reclaimed", "peak_pages_in_use", "prefix_hits",
                      "prefix_misses", "tokens_emitted", "completed"):
                assert getattr(em, k) == getattr(sm, k), k
        assert sum(e.metrics.prefix_hits for e in engines) == 1   # two prompts share 16 ids


def test_main_returns_what_it_built():
    out = TS.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--requests", "2",
                   "--batch", "2", "--prompt-len", "8", "--max-new", "4"])
    assert set(out) == {"baseline", "selective"}
    base, sel = out["baseline"].stats, out["selective"].stats
    assert (base.denoiser_passes, sel.denoiser_passes) == (16, 14)


ERRORS = [
    ["--mode", "continuous", "--reservation", "lazy"],
    ["--mode", "continuous", "--kv-dtype", "int8"],
    ["--mode", "continuous", "--step", "ragged"],
    ["--mode", "continuous", "--kv", "paged", "--host-pool-bytes", "4096"],
    ["--mode", "continuous", "--kv", "paged", "--prefix-cache", "content"],
    ["--mode", "continuous", "--policy", "divergence"],
    ["--mode", "continuous", "--swap-min-pages", "auto"],
    ["--replicas", "0"],
    ["--replicas", "2"],
    ["--mode", "continuous", "--async-ticks"],
    ["--mode", "continuous", "--kv", "paged", "--async-ticks", "--policy", "interval"],
    # several at once: the first in the reference's order wins
    ["--mode", "continuous", "--kv-dtype", "int8", "--reservation", "lazy", "--replicas", "0"],
]


def _error_line(main, argv, monkeypatch, capsys) -> str:
    monkeypatch.setattr(sys, "argv", ["serve.py"] + argv)
    with pytest.raises(SystemExit) as ex:
        main()
    assert ex.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("argv", ERRORS, ids=[" ".join(a) for a in ERRORS])
def test_argument_errors_equal_the_reference(argv, monkeypatch, capsys):
    full = ["--arch", "llama3.2-1b", "--reduced"] + argv
    want = _error_line(JS.main, full, monkeypatch, capsys)
    got = _error_line(lambda: TS.main(full + ["--device", "cpu"]), full, monkeypatch, capsys)
    assert want.startswith("serve.py: error: --")
    assert got == want


def test_encoder_exit_equals_the_reference(monkeypatch):
    argv = ["--arch", "hubert-xlarge", "--reduced"]
    monkeypatch.setattr(sys, "argv", ["serve.py"] + argv)
    with pytest.raises(SystemExit) as want:
        JS.main()
    with pytest.raises(SystemExit) as got:
        TS.main(argv + ["--device", "cpu"])
    assert "encoder-only" in str(want.value.code)
    assert got.value.code == want.value.code
