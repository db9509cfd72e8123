"""Dry-run: build every (arch x shape) step on the meta device, run it once
there, print its argument and output bytes, its FLOPs and its roofline on
one H100, and append JSONL records. Counterpart of
``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out results.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch sd-unet --device cuda

The reference lowers and compiles each step for a TPU mesh: the compile is
its proof that every architecture builds at every production shape, and
XLA's memory and cost analyses give its numbers. Here the proof is a run
of the step on meta tensors (``launch/steps.py``: shapes and dtypes, no
data, every kernel wrapper on its plain version), and the numbers are:

* ``argument_size``: the bytes of the step's arguments (weights, caches,
  optimizer state, inputs), each tensor once; ``output_size``: the bytes of
  its outputs, those updated in place included (the reference's donated
  outputs are counted there too); ``temp_size``: not known on meta;
* ``flops``: what ``torch.utils.flop_counter.FlopCounterMode`` counts in
  the run: matmuls, convolutions and attention products only, where XLA's
  cost analysis counts every op (elementwise work, reductions, softmax),
  so the port's count sits below the reference's by that much; plus
  ``recurrent_supplement`` for the xLSTM time loops, which the meta run
  steps once (``models/xlstm.time_scan``), as the reference's cost lowering
  counts a scan body once;
* the roofline on one H100 (``repro_torch/roofline.py``'s data-sheet
  rates): ``compute_s`` = flops / the bf16 peak, ``memory_s`` = (argument
  bytes + the bytes of outputs that are new tensors + the supplement's
  bytes) / the HBM rate, each byte moved once: a floor, where the
  reference's ``bytes accessed`` counts every operand of every op;
  collectives 0 on one card;
* ``model_flops``: ``steps.model_flops``, the step's useful FLOPs
  (6ND or 2ND), and ``useful_ratio`` = model_flops / flops; a decode
  step's ``cond`` record counts one stream, half the FULL step's (the
  reference's record keeps both streams for either variant);
* ``cards``: the 80 GB cards the arguments alone need.

``--device cuda`` also runs the step on the card: random arguments from a
seeded generator (caches zero), where they fit; a warm-up, then 3 runs
timed by CUDA events; ``torch.cuda.max_memory_allocated`` over the run, the
counterpart of the compiled temp size; and the argument bytes the meta
build predicted against the bytes the arguments asked of the caching
allocator (its ``requested_bytes``) and against what
``torch.cuda.memory_allocated`` grew by: at least the prediction in
512-byte blocks, more where the allocator hands a large tensor the rest of
its 2 MiB-rounded segment unsplit.

``--mesh`` and ``--multi-pod`` (sharded meshes) are not ported yet (ROADMAP
A8.4).
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import resolve_device
from repro_torch import roofline as RL
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import steps as ST

ALLOC_BLOCK = 512          # the CUDA caching allocator rounds every block to this
TIMED_RUNS = 3
SEED = 0                   # the on-card arguments' generator
MESH = "1"                 # one device: the record's counterpart of the mesh


def _round_block(n: int) -> int:
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


def measure(bundle: ST.StepBundle, *, model_flops: float = 0.0,
            supplement: dict | None = None) -> dict:
    """Runs ``bundle.fn`` once on its meta specs under ``FlopCounterMode``.
    -> the record's ``memory_analysis`` and ``roofline``."""
    supplement = supplement or {"flops": 0.0, "bytes": 0.0}
    args = bundle.in_specs
    arg_leaves = ST.leaves(args)
    arg_ids = {id(t) for t in arg_leaves}
    counter = FlopCounterMode(display=False)
    with counter:
        out = bundle.fn(*args)
    outs = ST.leaves(out)
    arg_bytes = sum(t.numel() * t.element_size() for t in arg_leaves)
    out_bytes = sum(t.numel() * t.element_size() for t in outs)
    new_out_bytes = sum(t.numel() * t.element_size() for t in outs if id(t) not in arg_ids)
    flops = float(counter.get_total_flops()) + supplement["flops"]
    byts = float(arg_bytes + new_out_bytes) + supplement["bytes"]
    cost = RL.StepCost(flops=flops, bytes=byts)
    compute_s, memory_s = cost.compute_s, cost.memory_s
    terms = {"compute": compute_s, "memory": memory_s, "collective": 0.0}
    return {
        "memory_analysis": {"argument_size": arg_bytes, "output_size": out_bytes,
                            "temp_size": None, "code_size": None},
        "roofline": {
            "name": bundle.name, "chips": 1, "flops": flops, "bytes": byts,
            "counted_flops": float(counter.get_total_flops()),
            "supplement": supplement, "coll_bytes": 0.0, "coll_breakdown": {},
            "model_flops": model_flops, "bytes_per_device": arg_bytes + new_out_bytes,
            "compute_s": compute_s, "memory_s": memory_s, "collective_s": 0.0,
            "dominant": max(terms, key=terms.get),
            "useful_ratio": model_flops / flops if flops else 0.0,
        },
        "cards": max(1, math.ceil(arg_bytes / RL.H100_HBM_CAPACITY)),
    }


def _requested(dev) -> int:
    """The bytes the caching allocator's callers asked for and hold, before
    its rounding (``requested_bytes``)."""
    return torch.cuda.memory_stats(dev).get("requested_bytes.all.current", 0)


def run_on_device(bundle: ST.StepBundle, device, *, high: int) -> dict:
    """``bundle.fn`` on real arguments on ``device`` (a CUDA device): the
    record's ``device`` entry. ``high`` bounds the integer arguments (the
    vocabulary, or the diffusion timesteps)."""
    dev = resolve_device(device)
    arg_bytes = ST.tree_bytes(bundle.in_specs)
    predicted = sum(_round_block(t.numel() * t.element_size())
                    for t in ST.leaves(bundle.in_specs))
    torch.cuda.synchronize(dev)
    free, _ = torch.cuda.mem_get_info(dev)
    if predicted > free:
        return {"status": "does not fit", "argument_bytes": arg_bytes, "free_bytes": free}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    before = torch.cuda.memory_allocated(dev), _requested(dev)
    args = ST.materialize(bundle, gen, dev, high=high)
    torch.cuda.synchronize(dev)
    allocated = torch.cuda.memory_allocated(dev) - before[0]
    requested = _requested(dev) - before[1]
    torch.cuda.reset_peak_memory_stats(dev)
    bundle.fn(*args)                                       # warm-up (kernel builds)
    torch.cuda.synchronize(dev)
    ms = []
    for _ in range(TIMED_RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = bundle.fn(*args)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    finite = all(bool(torch.isfinite(t).all()) for t in ST.leaves(out)
                 if t.dtype.is_floating_point)
    rec = {"status": "ok", "ms": ms, "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "argument_bytes": arg_bytes, "requested": requested,
           "predicted_allocated": predicted, "allocated": allocated, "finite": finite,
           "name": torch.cuda.get_device_name(dev)}
    del args, out
    torch.cuda.empty_cache()
    return rec


def _print_ok(rec: dict) -> None:
    mem, rl = rec["memory_analysis"], rec["roofline"]
    print(f"[ok] {rl['name']} device={rec['device_kind']} build+run={rec['compile_s']}s",
          flush=True)
    print(f"     memory: args={mem['argument_size'] / 1e9:.3f}GB "
          f"out={mem['output_size'] / 1e9:.3f}GB cards={rec['cards']}", flush=True)
    print(f"     flops: counted={rl['counted_flops']:.3e} "
          f"supplement={rl['supplement']['flops']:.3e} model={rl['model_flops']:.3e}",
          flush=True)
    print(f"     roofline (1 H100): compute={rl['compute_s']:.3e}s "
          f"memory={rl['memory_s']:.3e}s collective=0 dominant={rl['dominant']} "
          f"useful={rl['useful_ratio']:.2f}", flush=True)
    d = rec.get("device")
    if d and d["status"] == "ok":
        print(f"     on {d['name']}: ms={' '.join(f'{t:.3f}' for t in d['ms'])} "
              f"peak={d['peak_bytes'] / 1e9:.3f}GB args meta={d['argument_bytes']} "
              f"requested={d['requested']} allocated={d['allocated']} "
              f"finite={d['finite']}", flush=True)
    elif d:
        print(f"     on the card: {d['status']} (args {d['argument_bytes'] / 1e9:.3f}GB)",
              flush=True)


def _finish(rec: dict, bundle, t0: float, *, device, high: int,
            model_flops: float = 0.0, supplement=None, verbose: bool = True) -> None:
    rec.update(measure(bundle, model_flops=model_flops, supplement=supplement))
    rec["device_kind"] = "meta"
    if device is not None and torch.device(device).type == "cuda":
        rec["device"] = run_on_device(bundle, device, high=high)
        if rec["device"]["status"] == "ok" and not rec["device"]["finite"]:
            raise FloatingPointError(f"{bundle.name}: non-finite outputs on the card")
    rec.update(status="ok", compile_s=round(time.time() - t0, 1))
    if verbose:
        _print_ok(rec)


def _error(rec: dict, label: str, e: Exception, verbose: bool) -> None:
    rec.update(status="error", error=f"{type(e).__name__}: {e}",
               traceback=traceback.format_exc()[-2000:])
    if verbose:
        print(f"[ERR] {label} {rec['error']}", flush=True)


def run_one(arch: str, shape_name: str, *, variant: str = "full", verbose: bool = True,
            device=None) -> dict:
    """One (arch x shape) record. ``device``: None or "meta" for the meta
    run alone, "cuda" to run the step on the card as well."""
    if arch == "sd-unet":
        return run_sd(variant=variant, verbose=verbose, device=device)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    reason = ST.skip_reason(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "variant": variant, "mesh": MESH}
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec
    t0 = time.time()
    # ``model_flops`` counts a decode step's two streams; its COND step runs one
    useful = ST.model_flops(cfg, shape) / (2 if variant == "cond" and shape.kind == "decode"
                                           else 1)
    try:
        bundle = ST.build(cfg, shape, None, variant=variant)
        _finish(rec, bundle, t0, device=device, high=cfg.vocab_size, model_flops=useful,
                supplement=ST.recurrent_supplement(cfg, shape), verbose=verbose)
    except Exception as e:  # noqa: BLE001 — a dry-run failure IS the signal
        _error(rec, f"{arch}:{shape_name}", e, verbose)
    return rec


def run_sd(*, variant: str = "full", verbose: bool = True, device=None) -> dict:
    """One guided denoising step of the production-scale SD UNet (bf16,
    batch 64): the paper's own workload in the dry-run harness."""
    rec = {"arch": "sd-unet", "shape": "denoise", "variant": variant, "mesh": MESH}
    t0 = time.time()
    try:
        bundle = ST.build_sd_denoise(None, variant=variant)
        _finish(rec, bundle, t0, device=device, high=1000, verbose=verbose)
    except Exception as e:  # noqa: BLE001
        _error(rec, "sd-unet", e, verbose)
    return rec


def main(argv=None) -> list:
    """-> the records."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="not ported yet (ROADMAP A8.4)")
    ap.add_argument("--variant", default="full", choices=["full", "cond"])
    ap.add_argument("--mesh", default=None, help="not ported yet (ROADMAP A8.4)")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"],
                    help="meta: shapes only (default); cuda: also run each step on the card")
    args = ap.parse_args(argv)
    if args.multi_pod or args.mesh:
        raise SystemExit("--mesh and --multi-pod need the sharding tables, "
                         "not ported yet (ROADMAP A8.4)")

    jobs = []
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    for a in archs:
        for s in shapes:
            jobs.append((a, s))
    if args.arch == "sd-unet":
        jobs = jobs[:1]                   # the SD step has one shape

    t0 = time.time()
    results = []
    for a, s in jobs:
        rec = run_one(a, s, variant=args.variant, device=args.device)
        results.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    ok = sum(r["status"] == "ok" for r in results)
    sk = sum(r["status"] == "skipped" for r in results)
    err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run summary: {ok} ok, {sk} skipped, {err} errors "
          f"of {len(results)} in {time.time() - t0:.1f} s")
    if err:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
