"""Serving launcher: static-bucket and continuous-batching guided serving.
Counterpart of ``repro/launch/serve.py`` over the port's engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --reduced --requests 16 --fraction 0.5 --device cpu

    # phase-aware continuous batching under a Poisson-ish arrival trace
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --reduced --mode continuous --requests 16 --rate 1.5 --pass-budget 8 \\
        --device cpu

    # fleet: N replicas behind the prefix-affinity router, async
    # double-buffered ticks overlapping host scheduling with the step
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --reduced --mode continuous --kv paged --reservation lazy \\
        --prefix-cache content --replicas 2 --async-ticks --device cpu

``--device`` defaults to the GPU, where every engine step runs as a CUDA
graph. The weights are ``Transformer.init``'s, drawn from ``--seed``, in
float32 as the reference's ``ArrayMaker`` draws them. Each ``run_*``
returns what it built (the engines or the fleet), and ``main`` returns
that too.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.prompts import PAPER_PROMPTS
from repro_torch.models.transformer import Transformer
from repro_torch.serve import (ContinuousEngine, ServeFleet, ServeRequest,
                               fleet_chrome_trace, poisson_arrivals,
                               write_chrome_trace)
from repro_torch.serving import Request, ServingEngine


def run_static(model, cfg, args) -> dict:
    """-> {"baseline": engine, "selective": engine}."""
    reqs = [Request(uid=f"r{i}", prompt=PAPER_PROMPTS[i % len(PAPER_PROMPTS)],
                    max_new_tokens=args.max_new,
                    guidance_scale=args.guidance_scale)
            for i in range(args.requests)]
    engines = {}
    # baseline pass (no optimization) then the selective pass
    for frac, tag in [(0.0, "baseline"), (args.fraction, "selective")]:
        engine = ServingEngine(model, cfg, max_batch=args.batch,
                               prompt_len=args.prompt_len, max_new=args.max_new,
                               selective_fraction=frac, seed=args.seed)
        engine.generate(reqs)                      # warmup/compile
        engine.stats = type(engine.stats)()        # reset
        out = engine.generate(reqs)
        s = engine.stats
        print(f"[{tag:9s}] frac={frac:.2f} requests={s.requests} "
              f"tokens={s.tokens_generated} wall={s.wall_s:.3f}s "
              f"tok/s={s.tokens_per_s:.1f} passes={s.denoiser_passes}")
        sample_uid = reqs[0].uid
        print(f"           sample[{sample_uid}]: {out[sample_uid][:16]}")
        engines[tag] = engine
    return engines


def _make_engine(model, cfg, args) -> ContinuousEngine:
    budget = "auto" if args.pass_budget == "auto" \
        else (int(args.pass_budget) or 2 * args.batch)
    swap_min = args.swap_min_pages if args.swap_min_pages == "auto" \
        else int(args.swap_min_pages)
    return ContinuousEngine(model, cfg, num_slots=args.slots or 2 * args.batch,
                            pass_budget=budget,
                            prompt_len=args.prompt_len, max_new=args.max_new,
                            selective_fraction=args.fraction, seed=args.seed,
                            stop_on_eos=False, kv=args.kv,
                            page_size=args.page_size,
                            reservation=args.reservation,
                            kv_dtype=args.kv_dtype,
                            host_pool_bytes=args.host_pool_bytes,
                            swap_min_pages=swap_min,
                            prefix_cache=args.prefix_cache,
                            step_mode=None if args.step == "auto"
                            else args.step,
                            guidance_policy=args.policy,
                            combine=args.combine,
                            divergence_threshold=args.divergence_threshold,
                            interval=tuple(args.interval),
                            tick_mode="async" if args.async_ticks
                            else "sync")


def _trace_requests(args) -> tuple[list[ServeRequest], list[float]]:
    arrivals = poisson_arrivals(args.seed, n=args.requests, rate=args.rate)
    reqs = [ServeRequest(uid=f"c{i}",
                         prompt=PAPER_PROMPTS[i % len(PAPER_PROMPTS)],
                         max_new_tokens=args.max_new,
                         guidance_scale=args.guidance_scale)
            for i in range(args.requests)]
    return reqs, arrivals


def run_fleet(model, cfg, args) -> ServeFleet:
    """N replicas behind the prefix-affinity (or random) router; every
    replica is the engine ``run_continuous`` would have built."""
    fleet = ServeFleet([_make_engine(model, cfg, args)
                        for _ in range(args.replicas)],
                       policy=args.route, seed=args.seed)
    reqs, arrivals = _trace_requests(args)
    out = fleet.serve_trace(reqs, arrivals)
    assert len(out) == len(reqs)
    s = fleet.summary()
    print(f"[fleet     ] replicas={args.replicas} route={args.route} "
          f"completed={s['completed']} "
          f"spread={'/'.join(map(str, fleet.router.assigned_count))}")
    print(f"[fleet     ] prefill={s['prefill_passes']} "
          f"decode={s['denoiser_passes']} prefix_hits={s['prefix_hits']} "
          f"hit_rate={s['prefix_hit_rate']:.2f} "
          f"passes_saved={s['passes_saved']} "
          f"({s['savings_fraction']:.1%} of full CFG)")
    ttft, tpot = s["ttft"], s["tpot"]
    print(f"[fleet obs ] ttft p50/p95/p99={ttft['p50']}/{ttft['p95']}/"
          f"{ttft['p99']} tpot p50/p95/p99={tpot['p50']}/{tpot['p95']}/"
          f"{tpot['p99']} (ticks, merged histograms)")
    for rid, m in enumerate(fleet.metrics):
        print(f"[replica {rid} ] completed={m.completed} "
              f"passes={m.denoiser_passes} prefix_hits={m.prefix_hits} "
              f"ticks={m.ticks}")
    if args.trace_out:
        doc = fleet_chrome_trace(fleet.metrics)
        with open(args.trace_out, "w") as f:
            json.dump(doc, f)
        print(f"[trace     ] {args.trace_out}: one timeline, "
              f"{doc['otherData']['replicas']} replicas, "
              f"{doc['otherData']['request_spans']} request spans")
    return fleet


def run_continuous(model, cfg, args) -> dict:
    """Poisson-ish arrivals into the phase-aware engine, vs the static
    facade at the same pass budget. -> {"continuous": engine, "static":
    the facade}."""
    budget = "auto" if args.pass_budget == "auto" \
        else (int(args.pass_budget) or 2 * args.batch)
    eng = _make_engine(model, cfg, args)
    reqs, arrivals = _trace_requests(args)
    eng.serve_trace(reqs, arrivals)
    print(f"[continuous] {eng.metrics.summary()}")
    print(f"[step={eng.step_mode:9s}] "
          f"compiles={eng.metrics.step_compiles} "
          f"launches={eng.metrics.step_launches}")
    m = eng.metrics
    ttft, tpot = m.hists["ttft"].summary(), m.hists["tpot"].summary()
    print(f"[obs       ] ttft p50/p95/p99={ttft['p50']}/{ttft['p95']}/"
          f"{ttft['p99']} tpot p50/p95/p99={tpot['p50']}/{tpot['p95']}/"
          f"{tpot['p99']} (ticks)")
    print(f"[savings   ] passes_saved={m.passes_saved()} "
          f"({m.savings_fraction():.1%} of full CFG) "
          f"uncond_ticks_elided={m.uncond_ticks_elided} "
          f"events={m.trace.emitted} dropped={m.trace.dropped}")
    if args.policy != "static" or args.combine != "cfg":
        s = m.summary()
        print(f"[policy    ] {args.policy}/{args.combine}: "
              f"policy_switches={s['policy_switches']} "
              f"uncond_passes_elided_dynamic="
              f"{s['uncond_passes_elided_dynamic']}")
    if args.trace_out:
        doc = write_chrome_trace(m, args.trace_out)
        print(f"[trace     ] {args.trace_out}: "
              f"{doc['otherData']['request_spans']} request spans, "
              f"{doc['otherData']['ticks']} ticks")
    hbm = eng.kv_hbm_bytes()
    print(f"[kv={args.kv:5s}] dtype={hbm.get('kv_dtype', 'bf16')} "
          f"reserved={hbm['reserved_bytes']/2**20:.2f}MiB "
          f"peak_in_use={hbm['peak_in_use_bytes']/2**20:.2f}MiB")
    if args.reservation == "lazy":
        m = eng.metrics
        print(f"[lazy      ] pages_grown={m.pages_grown} "
              f"shared_page_hits={m.shared_page_hits} "
              f"cow_copies={m.cow_copies} preemptions={m.preemptions} "
              f"resumes={m.resumes}")
    if args.host_pool_bytes or args.prefix_cache == "content":
        m = eng.metrics
        s = m.summary()
        print(f"[tier      ] swap_outs={s['swap_outs']} "
              f"swap_ins={s['swap_ins']} "
              f"host_evictions={s['host_evictions']} "
              f"prefix_hits={s['prefix_hits']} "
              f"prefix_misses={s['prefix_misses']} "
              f"hit_rate={s['prefix_hit_rate']:.2f} "
              f"recompute_passes_avoided={s['recompute_passes_avoided']}")

    static = ServingEngine(model, cfg, max_batch=args.batch,
                           prompt_len=args.prompt_len, max_new=args.max_new,
                           selective_fraction=args.fraction, seed=args.seed)
    static.generate([Request(uid=r.uid, prompt=r.prompt,
                             max_new_tokens=r.max_new_tokens,
                             guidance_scale=r.guidance_scale) for r in reqs])
    sm = static._engine.metrics
    print(f"[static    ] {sm.summary()}")
    print(f"in-flight/tick: continuous={eng.metrics.mean_in_flight():.2f} "
          f"static={sm.mean_in_flight():.2f} "
          f"(equal pass budget {budget})")
    return {"continuous": eng, "static": static}


def parse_args(argv=None) -> argparse.Namespace:
    """The CLI's flags, defaults and checks (``ap.error`` exits) -> the
    Namespace ``main`` serves."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", choices=["static", "continuous"], default="static")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--slots", type=int, default=0,
                    help="continuous: arena slots (default 2*batch)")
    ap.add_argument("--pass-budget", default="0",
                    help="continuous: denoiser passes per tick (default "
                         "2*batch), or 'auto' to derive from the roofline "
                         "step-latency model")
    ap.add_argument("--rate", type=float, default=1.0,
                    help="continuous: mean arrivals per tick")
    ap.add_argument("--kv", choices=["slot", "paged"], default="slot",
                    help="continuous: KV arena model (paged = block tables)")
    ap.add_argument("--page-size", type=int, default=8,
                    help="continuous --kv paged: positions per KV page")
    ap.add_argument("--reservation", choices=["eager", "lazy"],
                    default="eager",
                    help="continuous --kv paged: eager = worst-case page "
                         "reservation at admission; lazy = prompt pages "
                         "only, on-demand growth, uncond prefix sharing "
                         "and priority preemption (DESIGN.md §10)")
    ap.add_argument("--kv-dtype", choices=["bf16", "int8"], default="bf16",
                    help="continuous --kv paged: page pool dtype (int8 = "
                         "quantized pages + fp32 per-row scales, ~2x pages "
                         "per byte, DESIGN.md \u00a711)")
    ap.add_argument("--host-pool-bytes", type=int, default=0,
                    help="continuous --reservation lazy: pinned-host swap "
                         "tier byte budget; preemption victims park their "
                         "KV pages there and resume by DMA restore instead "
                         "of recompute (0 = off, DESIGN.md §14)")
    ap.add_argument("--swap-min-pages", default="0",
                    help="smallest checkpoint (pages) worth swapping to "
                         "host; smaller ones recompute. 'auto' derives the "
                         "restore-vs-recompute break-even from the roofline "
                         "autotuner (requires --pass-budget auto)")
    ap.add_argument("--prefix-cache", choices=["length", "content"],
                    default="length",
                    help="continuous --reservation lazy: 'content' keys "
                         "canonical prompt pages by token-ids hash so "
                         "identical prompts share cond-stream KV "
                         "copy-on-write (DESIGN.md §14); 'length' is the "
                         "uncond length-only sharing of §10")
    ap.add_argument("--step", choices=["auto", "ragged", "signature"],
                    default="auto",
                    help="continuous: decode step mode (ragged = one "
                         "fixed-shape flat-pass-list step, one compile per "
                         "model, requires --kv paged; auto = engine "
                         "default: ragged when paged, DESIGN.md §12)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="continuous: write the run's event trace as "
                         "Chrome-trace JSON (DESIGN.md §13)")
    ap.add_argument("--policy", choices=["static", "divergence", "interval"],
                    default="static",
                    help="continuous: runtime guidance policy (divergence = "
                         "drop the uncond stream when the EMA cond/uncond "
                         "divergence falls below --divergence-threshold; "
                         "interval = guidance only inside --interval, "
                         "DESIGN.md §15)")
    ap.add_argument("--combine", choices=["cfg", "apg", "interval"],
                    default="cfg",
                    help="continuous: FULL-step combine stage (Eq. 1, APG "
                         "normalized guidance arxiv 2410.02416, or "
                         "interval-gated Eq. 1 arxiv 2404.07724)")
    ap.add_argument("--divergence-threshold", type=float, default=0.0,
                    help="continuous --policy divergence: EMA divergence "
                         "level that triggers the FULL->COND switch")
    ap.add_argument("--interval", type=float, nargs=2, default=(0.0, 1.0),
                    metavar=("START", "STOP"),
                    help="continuous: guidance interval as fractions of the "
                         "plan (with --policy interval / --combine interval)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="continuous: engine replicas behind the fleet "
                         "router; >1 routes the trace instead of serving "
                         "it on one engine (DESIGN.md §16)")
    ap.add_argument("--route", choices=["affinity", "random"],
                    default="affinity",
                    help="continuous --replicas N: placement policy — "
                         "prefix-affinity (repeat prompts to the replica "
                         "whose content cache holds them) or the seeded "
                         "random baseline")
    ap.add_argument("--async-ticks", action="store_true",
                    help="continuous: double-buffered tick pipeline — "
                         "host-side scheduling for tick t+1 overlaps tick "
                         "t's device step (requires --kv paged; token "
                         "streams identical to sync, DESIGN.md §16)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--fraction", type=float, default=0.2,
                    help="selective-guidance optimized fraction (paper: 0.2)")
    ap.add_argument("--guidance-scale", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)

    if args.reservation == "lazy" and args.kv != "paged":
        ap.error("--reservation lazy requires --kv paged "
                 "(the slot arena reserves whole rows)")
    if args.kv_dtype == "int8" and args.kv != "paged":
        ap.error("--kv-dtype int8 requires --kv paged")
    if args.step == "ragged" and args.kv != "paged":
        ap.error("--step ragged requires --kv paged (the flat pass list "
                 "addresses KV through block tables)")
    if args.host_pool_bytes and args.reservation != "lazy":
        ap.error("--host-pool-bytes requires --reservation lazy "
                 "(only lazy preempts, so only lazy swaps)")
    if args.prefix_cache == "content" and args.reservation != "lazy":
        ap.error("--prefix-cache content requires --reservation lazy "
                 "(shared pages need CoW growth)")
    if args.policy == "divergence" and args.divergence_threshold <= 0:
        ap.error("--policy divergence needs --divergence-threshold > 0 "
                 "(the EMA divergence level below which the uncond stream "
                 "drops)")
    if args.swap_min_pages == "auto" and args.pass_budget != "auto":
        ap.error("--swap-min-pages auto prices the break-even off the "
                 "roofline autotuner: set --pass-budget auto")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.replicas > 1 and args.mode != "continuous":
        ap.error("--replicas > 1 needs --mode continuous (the fleet "
                 "routes the continuous engine)")
    if args.async_ticks and args.kv != "paged":
        ap.error("--async-ticks requires --kv paged (the pipeline "
                 "double-buffers ragged block tables)")
    if args.async_ticks and args.policy != "static":
        ap.error("--async-ticks requires --policy static (dynamic "
                 "switches read divergence mid-tick)")
    return args


def main(argv=None):
    """-> what the mode's ``run_*`` returns."""
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving "
                         "(DESIGN.md §5)")

    dev = resolve_device(args.device)
    model = Transformer.init(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                             dtype=torch.float32, device=dev)
    if args.replicas > 1:
        return run_fleet(model, cfg, args)
    if args.mode == "continuous":
        return run_continuous(model, cfg, args)
    return run_static(model, cfg, args)


if __name__ == "__main__":
    main()
