"""Serve a small model with batched requests and selective guidance: the
static-batching facade at three fractions, then the phase-aware continuous
engine. Counterpart of ``examples/serve_guided.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_guided [--arch llama3.2-1b] \\
        [--device cpu]

Weights are ``Transformer.init(seed 0)`` in float32, not the reference's
draws, so token ids differ from its run; the pass counts do not.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.prompts import PAPER_PROMPTS
from repro_torch.models.transformer import Transformer
from repro_torch.serve import ContinuousEngine, ServeRequest, write_chrome_trace
from repro_torch.serving import Request, ServingEngine


def main(argv=None) -> dict:
    """-> {"fractions": {fraction: (tok/s, passes)}, "continuous": summary}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the continuous run as Chrome-trace JSON "
                         "(open in chrome://tracing or Perfetto)")
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = Transformer.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    reqs = [Request(uid=f"req-{i:02d}", prompt=PAPER_PROMPTS[i], max_new_tokens=24,
                    guidance_scale=4.0)
            for i in range(args.n)]

    print(f"== guided serving: {cfg.name}, {len(reqs)} requests on {dev} ==")
    fractions = {}
    for frac in [0.0, 0.2, 0.5]:
        eng = ServingEngine(model, cfg, max_batch=4, prompt_len=24, max_new=24,
                            selective_fraction=frac)
        eng.generate(reqs)             # warm-up: the steps' first runs (graphs on the GPU)
        eng.stats = type(eng.stats)()
        out = eng.generate(reqs)
        s = eng.stats
        fractions[frac] = (s.tokens_per_s, s.denoiser_passes)
        print(f"fraction={frac:.1f}: {s.tokens_per_s:8.1f} tok/s   "
              f"model passes={s.denoiser_passes}")
    print("\nsample generations (token ids):")
    for uid in list(out)[:3]:
        print(f"  {uid}: {out[uid][:12]}")

    # the same workload on the phase-aware continuous engine: COND-phase
    # requests cost 1 pass slot instead of 2, so more requests fly per tick
    eng = ContinuousEngine(model, cfg, num_slots=8, pass_budget=8, prompt_len=24, max_new=24,
                           selective_fraction=0.5, stop_on_eos=False)
    eng.serve([ServeRequest(uid=f"c-{i:02d}", prompt=PAPER_PROMPTS[i], max_new_tokens=24,
                            guidance_scale=4.0)
               for i in range(args.n)])
    m = eng.metrics
    print(f"\ncontinuous engine: {m.summary()}")
    print(f"guidance savings: {m.passes_saved()} denoiser passes "
          f"({m.savings_fraction():.1%} of full CFG), "
          f"uncond ticks elided={m.uncond_ticks_elided}")
    if args.trace_out:
        doc = write_chrome_trace(m, args.trace_out)
        print(f"chrome trace -> {args.trace_out} "
              f"({doc['otherData']['request_spans']} request spans, "
              f"{doc['otherData']['ticks']} ticks)")
    return {"fractions": fractions, "continuous": m.summary()}


if __name__ == "__main__":
    main()
