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

``--multi-pod`` (the 2x16x16 production mesh) or ``--mesh axes=shape``
(``data,model=16,16`` is the 16x16 one): the bundle is built with that
``MeshShape`` (``launch/steps.py``: a ``P`` for every argument by the rule
tables) and the record is one device's:
``argument_size`` and ``bytes_per_device`` count each argument's
``local_shape`` (outputs as above, unsplit), ``flops`` and
``model_flops`` are divided by the mesh's devices, ``chips`` is their
count. The step itself still runs once on meta, unsharded; collectives
are not priced (``collective_s`` 0: the reference's HLO collective parsing
has no counterpart), so a sharded record is a floor.
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
from repro_torch.dist.sharding import MeshShape
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import chips, make_production_mesh

ALLOC_BLOCK = 512          # the CUDA caching allocator rounds every block to this
TIMED_RUNS = 3
SEED = 0                   # the on-card arguments' generator
MESH = "1"                 # one device: the record's counterpart of the mesh


def _round_block(n: int) -> int:
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


def _custom_mesh(spec: str) -> MeshShape:
    """``"data,model=16,16"`` (the reference's form) or ``"data=16,model=16"``
    -> MeshShape((16, 16), ("data", "model"))."""
    if spec.count("=") > 1:
        pairs = [part.partition("=") for part in spec.split(",")]
        return MeshShape(tuple(int(n) for _, _, n in pairs), tuple(a for a, _, _ in pairs))
    axes_s, _, shape_s = spec.partition("=")
    return MeshShape(tuple(int(x) for x in shape_s.split(",")), tuple(axes_s.split(",")))


def mesh_for(multi_pod: bool, mesh_spec: str | None):
    """-> (the mesh or None, the record's mesh name)."""
    if mesh_spec:
        return _custom_mesh(mesh_spec), mesh_spec
    if multi_pod:
        return make_production_mesh(multi_pod=True), "2x16x16"
    return None, MESH


def measure(bundle: ST.StepBundle, *, model_flops: float = 0.0,
            supplement: dict | None = None, mesh: MeshShape | None = None) -> dict:
    """Runs ``bundle.fn`` once on its meta specs under ``FlopCounterMode``.
    -> the record's ``memory_analysis`` and ``roofline``, one device's
    share under ``mesh`` (the bundle built on it)."""
    supplement = supplement or {"flops": 0.0, "bytes": 0.0}
    n = 1 if mesh is None else chips(mesh)
    args = bundle.in_specs
    arg_leaves = ST.leaves(args)
    arg_ids = {id(t) for t in arg_leaves}
    counter = FlopCounterMode(display=False)
    with counter:
        out = bundle.fn(*args)
    outs = ST.leaves(out)
    total_arg_bytes = sum(t.numel() * t.element_size() for t in arg_leaves)
    arg_bytes = total_arg_bytes if mesh is None \
        else ST.local_bytes(args, bundle.in_shardings, mesh)
    out_bytes = sum(t.numel() * t.element_size() for t in outs)
    new_out_bytes = sum(t.numel() * t.element_size() for t in outs if id(t) not in arg_ids)
    flops = (float(counter.get_total_flops()) + supplement["flops"]) / n
    model_flops = model_flops / n
    byts = float(arg_bytes + new_out_bytes) + supplement["bytes"] / n
    cost = RL.StepCost(flops=flops, bytes=byts)
    compute_s, memory_s = cost.compute_s, cost.memory_s
    terms = {"compute": compute_s, "memory": memory_s, "collective": 0.0}
    return {
        "memory_analysis": {"argument_size": arg_bytes, "output_size": out_bytes,
                            "temp_size": None, "code_size": None},
        "roofline": {
            "name": bundle.name, "chips": n, "flops": flops, "bytes": byts,
            "counted_flops": float(counter.get_total_flops()),
            "supplement": supplement, "coll_bytes": 0.0, "coll_breakdown": {},
            "model_flops": model_flops, "bytes_per_device": arg_bytes + new_out_bytes,
            "compute_s": compute_s, "memory_s": memory_s, "collective_s": 0.0,
            "dominant": max(terms, key=terms.get),
            "useful_ratio": model_flops / flops if flops else 0.0,
        },
        "cards": max(1, math.ceil(total_arg_bytes / RL.H100_HBM_CAPACITY)),
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
    print(f"[ok] {rl['name']} mesh={rec['mesh']} device={rec['device_kind']} "
          f"build+run={rec['compile_s']}s",
          flush=True)
    print(f"     memory: args={mem['argument_size'] / 1e9:.3f}GB "
          f"out={mem['output_size'] / 1e9:.3f}GB cards={rec['cards']}", flush=True)
    print(f"     flops: counted={rl['counted_flops']:.3e} "
          f"supplement={rl['supplement']['flops']:.3e} model={rl['model_flops']:.3e}",
          flush=True)
    where = "1 H100" if rl["chips"] == 1 else f"one of {rl['chips']} H100s, no collectives"
    print(f"     roofline ({where}): compute={rl['compute_s']:.3e}s "
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


def _finish(rec: dict, bundle, t0: float, *, device, high: int, mesh=None,
            model_flops: float = 0.0, supplement=None, verbose: bool = True) -> None:
    rec.update(measure(bundle, model_flops=model_flops, supplement=supplement, mesh=mesh))
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


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False, variant: str = "full",
            verbose: bool = True, device=None, mesh_spec: str | None = None) -> dict:
    """One (arch x shape) record. ``device``: None or "meta" for the meta
    run alone, "cuda" to run the step on the card as well (one device: no
    mesh). ``multi_pod``/``mesh_spec``: the record of one device of that
    mesh."""
    if arch == "sd-unet":
        return run_sd(multi_pod=multi_pod, variant=variant, verbose=verbose, device=device,
                      mesh_spec=mesh_spec)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    reason = ST.skip_reason(cfg, shape)
    mesh, name = mesh_for(multi_pod, mesh_spec)
    rec = {"arch": arch, "shape": shape_name, "variant": variant, "mesh": name}
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec
    t0 = time.time()
    # ``model_flops`` counts a decode step's two streams; its COND step runs one
    useful = ST.model_flops(cfg, shape) / (2 if variant == "cond" and shape.kind == "decode"
                                           else 1)
    try:
        bundle = ST.build(cfg, shape, mesh, variant=variant)
        _finish(rec, bundle, t0, device=device, high=cfg.vocab_size, mesh=mesh,
                model_flops=useful,
                supplement=ST.recurrent_supplement(cfg, shape), verbose=verbose)
    except Exception as e:  # noqa: BLE001 — a dry-run failure IS the signal
        _error(rec, f"{arch}:{shape_name}", e, verbose)
    return rec


def run_sd(*, multi_pod: bool = False, variant: str = "full", verbose: bool = True,
           device=None, mesh_spec: str | None = None) -> dict:
    """One guided denoising step of the production-scale SD UNet (bf16,
    batch 64): the paper's own workload in the dry-run harness."""
    mesh, name = mesh_for(multi_pod, mesh_spec)
    rec = {"arch": "sd-unet", "shape": "denoise", "variant": variant, "mesh": name}
    t0 = time.time()
    try:
        bundle = ST.build_sd_denoise(mesh, variant=variant)
        _finish(rec, bundle, t0, device=device, high=1000, mesh=mesh, verbose=verbose)
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
                    help="one device of the 2x16x16 (pod, data, model) mesh")
    ap.add_argument("--variant", default="full", choices=["full", "cond"])
    ap.add_argument("--mesh", default=None,
                    help="a mesh 'axes=shape', e.g. 'data,model=16,16' (the 16x16 "
                         "production mesh; also 'data=16,model=16') or "
                         "'data,expert,model=16,8,2'")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"],
                    help="meta: shapes only (default); cuda: also run each step on the card")
    args = ap.parse_args(argv)
    if (args.multi_pod or args.mesh) and args.device == "cuda":
        ap.error("--device cuda runs a step on one card: it takes no --mesh or --multi-pod")

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
        rec = run_one(a, s, multi_pod=args.multi_pod, variant=args.variant,
                      device=args.device, mesh_spec=args.mesh)
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
