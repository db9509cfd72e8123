#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the script with a non-zero exit if it fails:

1. device: needs CUDA; prints the card's name and power limit; turns TF32
   off for matmuls and convolutions (the reference is full float32) and
   bf16 matmuls' reduced-precision reductions off;
2. build: compiles ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a;
3. kernels vs plain: each guidance-combine kernel against its plain
   PyTorch version at the main path's shapes (B, 64, 64, 4), B in {1, 2, 8},
   float32 and bfloat16, and its time beside its bytes-moved bound;
4. device parity: the same ``generate`` at ``UNetConfig().reduced()`` on
   the CPU (plain versions) and on the GPU (kernels);
5. main path: ``SDPipeline.generate`` at the ``sd-unet-prod`` width (random
   weights from a seed, 50 DDIM steps), once for each combine mode with the
   launch counters read around it, then the Table-1 protocol for COND
   suffix fractions f in {0, 0.2, 0.5, 1.0};
6. where the time goes: component times by CUDA events, and the kernels
   that lead one generate under ``torch.profiler``;
7. attention and norm kernels vs plain: the flash-prefill, flash-decode and
   RMSNorm kernels against their plain versions around the decode path's
   shapes (attention held row by row, and shown to reject planted causal
   faults), and the three guidance-combine kernels on (4, 128256) float32
   logits, each timed beside its bound and a library call;
8. decode parity: ``guided_decode`` on llama3.2-1b at full width, 2 layers,
   on the CPU (plain versions) and the GPU (kernels), teacher-forced logits
   and margin-guarded tokens, for each combine mode;
9. decode main path: ``guided_decode`` on llama3.2-1b at full width and
   depth (random bf16 weights from a seed), B = 4 prompts of 512 tokens, 256
   new tokens, with exact launch counts, for COND suffix fractions
   f in {0, 0.2, 0.5, 1.0}; then where its time goes (device time of a
   step from a CUDA-graph replay, beside its eager wall time) and the
   kernels that lead a FULL step under ``torch.profiler``.

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12             # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12            # bf16 tensor cores, dense
LATENT = (64, 64, 4)
BF16_STEP = 2.0 ** -8               # one bf16 step, relative
ATTN_BF16_STEPS = 8                 # B4/B5 bf16 tolerance, of each row's max|out|


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


_SLEEP_CYCLES_PER_S = None


def _sleep_cycles_per_s() -> float:
    """Calibrates ``torch.cuda._sleep``, a kernel that spins for a count of
    clock cycles."""
    global _SLEEP_CYCLES_PER_S
    import torch
    if _SLEEP_CYCLES_PER_S is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        cycles = 50_000_000
        torch.cuda._sleep(cycles)                      # warm-up
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_S = cycles / (start.elapsed_time(end) / 1e3)
    return _SLEEP_CYCLES_PER_S


def time_ms(fn, iters: int = 100) -> tuple[float, float]:
    """-> (device ms per call, host ms per call). The device time is taken
    by CUDA events around ``iters`` calls queued behind a sleep kernel, so
    that the host's cost of issuing them stays out of it; the host time is
    the wall time of issuing and finishing them without that cover."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(_sleep_cycles_per_s() * (2.0 * host + 1e-3)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host * 1e3 / iters


def bound_ms(nbytes: int, flops: int, peak: float = H100_FP32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def kernel_modules():
    from repro_torch.kernels import cfg_combine, decode_attention, flash_attention, rmsnorm
    return (cfg_combine, flash_attention, decode_attention, rmsnorm)


def reset_launches() -> None:
    for m in kernel_modules():
        m.reset_launches()


def launch_counts() -> dict:
    return {k: v for m in kernel_modules() for k, v in m.LAUNCHES.items()}


# -- phases ----------------------------------------------------------------------


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs on a GPU only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 matmuls accumulate in float32, as the reference's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    log(f"[device] nvidia-smi: {smi.stdout.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path, text = build.build(verbose=True)
    build.load()
    log(f"[build] {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in text.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"[build] {line.strip()}")


def phase_kernels():
    """-> {name: dict of errors and times} for the JSON line."""
    import torch
    from repro_torch.kernels import cfg_combine as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"cfg_combine": 0.0, "cfg_combine_rowscale": 0.0, "apg_combine": 0.0}
    for B in (1, 2, 8):
        for dtype in (torch.float32, torch.bfloat16):
            shape = (B, *LATENT)
            u = torch.randn(shape, generator=gen, device=dev).to(dtype)
            c = torch.randn(shape, generator=gen, device=dev).to(dtype)
            tag = f"B={B} {str(dtype).split('.')[-1]}"
            # B1: bit-exact; s == 1 returns eps_cond and launches nothing
            before = K.LAUNCHES["cfg_combine"]
            if K.cfg_combine(u, c, 1.0) is not c or K.LAUNCHES["cfg_combine"] != before:
                fail(f"cfg_combine {tag}: s=1 must return eps_cond without a launch")
            out, ref = K.cfg_combine(u, c, 7.5), K.cfg_combine_plain(u, c, 7.5)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            errs["cfg_combine"] = max(errs["cfg_combine"], err)
            if not torch.equal(out, ref):
                fail(f"cfg_combine {tag}: not bit-exact, max err {err}")
            # B3: bit-exact, rows at 1.0 compute u + 1.0 * (c - u)
            scales = torch.tensor([7.5 if r % 2 == 0 else 1.0 for r in range(B)],
                                  device=dev)
            out = K.cfg_combine_rowscale(u, c, scales)
            ref = K.cfg_combine_rowscale_plain(u, c, scales)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            errs["cfg_combine_rowscale"] = max(errs["cfg_combine_rowscale"], err)
            if not torch.equal(out, ref):
                fail(f"cfg_combine_rowscale {tag}: not bit-exact, max err {err}")
            # B2: float32 within 1e-5 + 1e-5|ref| (the row sums are taken in
            # another order); bfloat16 within one bf16 step of the reference
            rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (2 ** -7, 1e-5)
            uq = u.clone()
            uq[0] = c[0]                                   # a u == c row
            diff = torch.randn(shape, generator=gen, device=dev)
            for eta in (0.0, 0.3):
                for thr in (0.0, 1.0):
                    for d in (None, diff):
                        out = K.apg_combine(uq, c, 7.5, eta=eta, threshold=thr, diff=d)
                        ref = K.apg_combine_plain(uq, c, 7.5, eta=eta, threshold=thr,
                                                  diff=d)
                        torch.cuda.synchronize()
                        err = (out.float() - ref.float()).abs()
                        if not bool(torch.isfinite(out).all()) or bool(
                                (err > atol + rtol * ref.float().abs()).any()):
                            fail(f"apg_combine {tag} eta={eta} thr={thr} "
                                 f"diff={d is not None}: max err {err.max().item()}")
                        if d is None and not torch.equal(out[0], c[0]):
                            fail(f"apg_combine {tag}: a u == c row must return c")
                        if dtype == torch.float32:
                            errs["apg_combine"] = max(errs["apg_combine"],
                                                      err.max().item())
            log(f"[kernels] {tag}: cfg_combine bit-exact, cfg_combine_rowscale "
                f"bit-exact, apg_combine within tolerance, u==c rows exact")

    # times at the main path's shape (B=1 float32), and at B = 2 and 8
    rows = {}
    for B in (1, 2, 8):
        shape = (B, *LATENT)
        n = B * LATENT[0] * LATENT[1] * LATENT[2]
        u = torch.randn(shape, generator=gen, device=dev)
        c = torch.randn(shape, generator=gen, device=dev)
        s = torch.full((B,), 7.5, device=dev)
        s4 = s.view(B, 1, 1, 1)
        t = {
            "cfg_combine": (lambda: K.cfg_combine(u, c, 7.5),
                            lambda: K.cfg_combine_plain(u, c, 7.5),
                            lambda: torch.lerp(u, c, 7.5), 12 * n, 3 * n),
            "cfg_combine_rowscale": (lambda: K.cfg_combine_rowscale(u, c, s),
                                     lambda: K.cfg_combine_rowscale_plain(u, c, s),
                                     lambda: torch.lerp(u, c, s4), 12 * n + 4 * B, 3 * n),
            "apg_combine": (lambda: K.apg_combine(u, c, 7.5, eta=0.3, threshold=1.0),
                            lambda: K.apg_combine_plain(u, c, 7.5, eta=0.3, threshold=1.0),
                            None, 12 * n, 16 * n),
        }
        for name, (kern, plain, lib, nbytes, flops) in t.items():
            (ms, host_ms), (plain_ms, _) = time_ms(kern), time_ms(plain)
            lib_ms = time_ms(lib)[0] if lib is not None else None
            b_ms, b_by = bound_ms(nbytes, flops)
            log(f"[kernels] {name} B={B} float32: device time kernel {ms * 1e3:.2f} us "
                f"(host issue {host_ms * 1e3:.2f} us/call), plain {plain_ms * 1e3:.2f} us, "
                f"library {'-' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}, bound "
                f"{b_ms * 1e3:.3f} us ({b_by}, {nbytes} B)")
            if B == 1:
                rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                  bound_ms=b_ms, bound_by=b_by, max_abs_err=errs[name])
    return rows


def phase_parity():
    """The same generate on the CPU (plain versions) and the GPU (kernels)."""
    import torch
    from repro_torch.configs.base import UNetConfig
    from repro_torch.core.pipeline import SDPipeline
    from repro_torch.core.sampler import sample
    from repro_torch.core.selective import GuidancePlan
    from repro_torch.kernels import cfg_combine as K

    cfg = UNetConfig().reduced()
    cpu = SDPipeline.init(cfg, seed=0, device="cpu")
    gpu = cpu.to("cuda")
    plan = GuidancePlan.suffix(10, 0.3, 7.5)
    prompts = ["a red disc", "a blue square"]
    x0 = torch.randn(cpu.latent_shape(2), generator=torch.Generator().manual_seed(1))
    cond, uncond = cpu.encode_prompts(prompts), cpu.null_embedding(2)
    text_err = max((gpu.encode_prompts(prompts).float().cpu() - cond.float()).abs().max().item(),
                   (gpu.null_embedding(2).float().cpu() - uncond.float()).abs().max().item())
    log(f"[parity] text embeddings CPU vs GPU (bf16 encoder): max abs err {text_err:.3g}")
    modes = {"cfg": ("cfg_combine", {}),
             "apg": ("apg_combine", dict(apg_eta=0.3, apg_threshold=1.0)),
             "apg+momentum": ("apg_combine", dict(apg_momentum=0.5)),
             "interval": ("cfg_combine_rowscale", dict(interval=(0.2, 0.6)))}
    full = plan.total_steps - plan.optimized_steps
    for mode, (kernel, kw) in modes.items():
        kw = dict(kw, combine=mode.split("+")[0])
        # errors relative to the largest latent: random weights at s = 7.5
        # drive latents far from unit scale
        # the sampler alone, same embeddings on both: float32 convolution
        # and matmul algorithms differ, so 1e-4 of the largest latent
        a = sample(cpu.eps_fn(), plan, cpu.sched, x0, cond, uncond, **kw)
        K.reset_launches()
        b = sample(gpu.eps_fn(), plan, gpu.sched, x0.cuda(), cond.cuda(), uncond.cuda(), **kw)
        torch.cuda.synchronize()
        launched = K.LAUNCHES[kernel]
        err = ((b.cpu() - a).abs().max() / a.abs().max()).item()
        if launched != full:
            fail(f"parity {mode}: {kernel} launched {launched} times, want {full}")
        if not err <= 1e-4:
            fail(f"parity {mode}: sampler CPU vs GPU relative err {err:.3g} > 1e-4")
        # the whole generate, each device encoding its own prompts: the bf16
        # encoder rounds differently on the two, so 2e-2 of the largest latent
        a = cpu.generate(prompts, plan, x_init=x0, **kw)
        b = gpu.generate(prompts, plan, x_init=x0, **kw)
        gerr = ((b.cpu() - a).abs().max() / a.abs().max()).item()
        if not gerr <= 2e-2:
            fail(f"parity {mode}: generate CPU vs GPU relative err {gerr:.3g} > 2e-2")
        log(f"[parity] {mode}: {kernel} x{launched}; max|latent| {a.abs().max().item():.3g}; "
            f"relative err: sampler {err:.3g} (tol 1e-4), generate {gerr:.3g} (tol 2e-2)")


def phase_main_path():
    """-> launches per kernel from the main path's runs."""
    import torch
    from repro_torch.configs.sd_unet import PRODUCTION
    from repro_torch.core.pipeline import SDPipeline
    from repro_torch.core.selective import GuidancePlan
    from repro_torch.kernels import cfg_combine as K

    t0 = time.perf_counter()
    pipe = SDPipeline.init(PRODUCTION, seed=0)
    torch.cuda.synchronize()
    n_unet = sum(p.numel() for p in pipe.unet.parameters())
    n_text = sum(p.numel() for p in pipe.text.parameters())
    log(f"[main] {PRODUCTION.name}: UNet {n_unet} params, text encoder {n_text} "
        f"params, init {time.perf_counter() - t0:.2f} s")
    prompts = ["a red disc"]
    steps, f_main = 50, 0.2
    launches = {}
    for combine, kernel, kw in (("cfg", "cfg_combine", {}),
                                ("apg", "apg_combine", dict(apg_eta=0.3, apg_threshold=1.0)),
                                ("interval", "cfg_combine_rowscale",
                                 dict(interval=(0.2, 0.8)))):
        plan = GuidancePlan.suffix(steps, f_main, 7.5)
        full = steps - plan.optimized_steps
        torch.cuda.synchronize()
        K.reset_launches()
        t1 = time.perf_counter()
        out = pipe.generate(prompts, plan, seed=1, combine=combine, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        counts = dict(K.LAUNCHES)
        launches[kernel] = counts[kernel]
        if counts[kernel] != full or sum(counts.values()) != full:
            fail(f"main path combine={combine}: launches {counts}, want {full} "
                 f"{kernel} launches only")
        if out.shape != pipe.latent_shape(1) or not bool(torch.isfinite(out).all()):
            fail(f"main path combine={combine}: latents {tuple(out.shape)} not finite")
        log(f"[main] generate combine={combine} f={f_main}: {kernel} x{counts[kernel]} "
            f"(= FULL steps), {dt:.3f} s incl. first-call set-up, latents finite, "
            f"std {out.std().item():.4f}")

    rows = []
    for f in (0.0, 0.2, 0.5, 1.0):
        plan = GuidancePlan.suffix(steps, f, 7.5)
        full = steps - plan.optimized_steps
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        out, mean_s, std_s = pipe.timed_generate(prompts, plan, warmup=1, iters=3)
        per_run = K.LAUNCHES["cfg_combine"] / 4
        if per_run != full:
            fail(f"table1 f={f}: {per_run} cfg launches per generate, want {full}")
        if not bool(torch.isfinite(out).all()):
            fail(f"table1 f={f}: latents not finite")
        rows.append(dict(f=f, mean_s=mean_s, std_s=std_s, passes=plan.denoiser_passes(),
                         cfg_launches=per_run,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9))
    t_full, t_half = rows[0]["mean_s"], rows[-1]["mean_s"]
    share = 2.0 * (t_full - t_half) / t_full
    for r in rows:
        r["saving"] = 1.0 - r["mean_s"] / t_full
        r["predicted"] = r["f"] * 0.5 * share
        log(f"[table1] f={r['f']}: mean {r['mean_s']:.4f} s std {r['std_s']:.4f} s "
            f"(1 warm-up, 3 timed), passes {r['passes']}, cfg launches/run "
            f"{r['cfg_launches']:.0f}, saving {r['saving']:.4f}, predicted f/2*U "
            f"{r['predicted']:.4f}, peak {r['peak_gb']:.2f} GB")
    log(f"[table1] denoiser share U = 2*(t_full - t_half)/t_full = {share:.4f}")
    return pipe, launches


def phase_breakdown(pipe) -> None:
    """Where one generate's time goes: the text encoder, one UNet pass at
    2x and 1x batch, and one combine, each by CUDA events; set against a
    generate at f = 0.2 (40 FULL + 10 COND steps)."""
    import torch
    from repro_torch.core.guidance import cfg_combine
    from repro_torch.core.selective import GuidancePlan

    cfg, dev = pipe.cfg, pipe.device
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(pipe.latent_shape(1), generator=gen, device=dev)
    cond, uncond = pipe.encode_prompts(["a red disc"]), pipe.null_embedding(1)
    text2 = torch.cat([cond, uncond])
    t1, t2 = torch.full((1,), 500, device=dev), torch.full((2,), 500, device=dev)
    with torch.no_grad():
        enc = time_ms(lambda: (pipe.encode_prompts(["a red disc"]), pipe.null_embedding(1)),
                      iters=10)[0]
        u2 = time_ms(lambda: pipe.unet(torch.cat([x, x]), t2, text2), iters=10)[0]
        u1 = time_ms(lambda: pipe.unet(x, t1, cond), iters=10)[0]
    comb = time_ms(lambda: cfg_combine(x, x, 7.5))[0]
    plan = GuidancePlan.suffix(50, 0.2, 7.5)
    _, gen_s, _ = pipe.timed_generate(["a red disc"], plan, warmup=1, iters=3)
    full, cond_steps = 50 - plan.optimized_steps, plan.optimized_steps
    unet_s = (full * u2 + cond_steps * u1) / 1e3
    log(f"[breakdown] {cfg.name} B=1: text encoder (cond + null) {enc:.3f} ms, UNet pass "
        f"2x batch {u2:.3f} ms, 1x batch {u1:.3f} ms (ratio {u2 / u1:.3f}), cfg_combine "
        f"{comb * 1e3:.2f} us (device times)")
    log(f"[breakdown] generate f=0.2 wall {gen_s:.4f} s; {full} x 2x-pass + {cond_steps} x "
        f"1x-pass = {unet_s:.4f} s ({unet_s / gen_s:.4f} of wall); encoder "
        f"{enc / 1e3 / gen_s:.5f}; combines {full * comb / 1e3 / gen_s:.6f}; rest "
        f"{1 - (unet_s + enc / 1e3 + full * comb / 1e3) / gen_s:.4f}")


def phase_profile(pipe) -> None:
    """The kernels that lead one generate at f = 0.2 under ``torch.profiler``,
    in order of their summed device time. The order names the bottleneck;
    the shares come from ``phase_breakdown``."""
    import torch
    from repro_torch.core.selective import GuidancePlan
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.generate(["a red disc"], GuidancePlan.suffix(50, 0.2, 7.5), seed=2)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            t, n = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (t + e.end_ns() - e.start_ns(), n + 1)
    if not by_name:
        log("[profile] not measured: the profiler saw no device time")
    for rank, (name, (_, n)) in enumerate(sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]):
        log(f"[profile] {rank + 1}. {n}x {name[:100]}")


# -- guided AR decode (llama3.2-1b) ----------------------------------------------

DECODE_B, DECODE_S, DECODE_NEW = 4, 512, 256     # the decode main path
DECODE_SCALE = 3.0
LOGIT_TOL = 2e-2    # CPU vs GPU logits, relative to max|logit| (bf16 stacks)


def _within(out, ref, *, rel_to_max=None, per_row=None, elementwise=None):
    """-> (ok, max abs error, largest error over its yardstick). ``ok`` if
    every value is finite and every error is within ``per_row`` of the
    largest |ref| of its row (the last axis), or ``elementwise`` of its own
    |ref|, or ``rel_to_max`` of max|ref|."""
    import torch
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    if per_row is not None:
        yard = ref.abs().amax(-1, keepdim=True)
        bad = err > per_row * yard
    elif elementwise is not None:
        yard = ref.abs().max()
        bad = err > elementwise * ref.abs() + 1e-30
    else:
        yard = ref.abs().max()
        bad = err > rel_to_max * yard
    ok = not bool(bad.any()) and bool(torch.isfinite(out).all())
    return ok, err.max().item(), (err / yard.clamp_min(1e-30)).max().item()


def _err_ok(name, tag, out, ref, **tol):
    """-> (max abs error, largest error over its yardstick); fails unless
    ``_within(out, ref, **tol)``."""
    import torch
    torch.cuda.synchronize()
    ok, e, rel = _within(out, ref, **tol)
    if not ok:
        fail(f"{name} {tag}: max abs err {e:.3g}, largest error over its yardstick "
             f"{rel:.3g} ({tol})")
    return e, rel


def phase_attn_kernels():
    """B4-B6 against their plain versions around the decode path's shapes;
    B1/B2 on (4, 128256) float32 logits. -> {name: row} at the main path's
    shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cfg_combine as KC
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.kernels import rmsnorm as KR

    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # Attention: each output row (b, q, h) is held to its own max|out|, so
    # that late causal rows, whose outputs average many keys and are small,
    # are not judged by row 0's. bf16: ATTN_BF16_STEPS bf16 steps. The plain
    # versions round the scores to bf16 (as ref.py and the reference's
    # model do) and the weights once; the kernels keep the scores in
    # float32 and round p per tile (as the TPU kernels do). On an H100 this
    # sweep's largest per-row differences were 6.31 steps (flash) and 3.97
    # (decode). float32: 1e-5.
    # RMSNorm in bf16: one step of each value; float32 1e-5 of max|out|.
    def tol(dtype):
        return ATTN_BF16_STEPS * BF16_STEP if dtype == bf16 else 1e-5

    errs = {"flash_attention": 0.0, "decode_attention": 0.0, "rmsnorm": 0.0}
    worst = {}      # (kernel, dtype) -> largest error over max|ref|

    def note(name, dtype, e):
        errs[name] = max(errs[name], e[0])
        worst[name, dtype] = max(worst.get((name, dtype), 0.0), e[1])
    for hd, H, K in ((64, 32, 8), (128, 40, 8)):
        for B in (1, 4):
            for S in (77, 512, 2048):
                for dtype in (bf16, f32):
                    q, k, v = rnd(B, S, H, hd, dtype=dtype), rnd(B, S, K, hd, dtype=dtype), \
                        rnd(B, S, K, hd, dtype=dtype)
                    for causal in (True, False):
                        for window in (None, 256):
                            tag = (f"hd={hd} H={H} K={K} B={B} S={S} {str(dtype)[6:]} "
                                   f"causal={causal} window={window}")
                            e = _err_ok("flash_attention", tag,
                                        KF.flash_attention(q, k, v, causal=causal, window=window),
                                        KF.flash_attention_plain(q, k, v, causal=causal,
                                                                 window=window),
                                        per_row=tol(dtype))
                            note("flash_attention", dtype, e)
        log(f"[attn] flash_attention hd={hd} H/K={H}/{K}: B in (1, 4) x S in (77, 512, 2048) "
            f"x causal/non-causal x window None/256 x bf16/f32 within tolerance")
        for B in (1, 4):
            for dtype in (bf16, f32):
                q, k, v = rnd(B, H, hd, dtype=dtype), rnd(B, 768, K, hd, dtype=dtype), \
                    rnd(B, 768, K, hd, dtype=dtype)
                for pos in (0, 511, 767):
                    for window in (None, 256):
                        tag = f"hd={hd} B={B} S=768 pos={pos} window={window} {str(dtype)[6:]}"
                        e = _err_ok("decode_attention", tag,
                                    KD.decode_attention(q, k, v, pos, window=window),
                                    KD.decode_attention_plain(q, k, v, pos, window=window),
                                    per_row=tol(dtype))
                        note("decode_attention", dtype, e)
        log(f"[attn] decode_attention hd={hd} H/K={H}/{K}: capacity 768, pos in (0, 511, 767) "
            f"x window None/256 x B in (1, 4) x bf16/f32 within tolerance")
    for rows, D in ((4, 2048), (2048, 2048), (4 * 32, 64)):
        for xdt, sdt in ((bf16, bf16), (bf16, f32), (f32, f32)):
            x, sc = rnd(rows, D, dtype=xdt) * 3, rnd(D, dtype=sdt)
            out, ref = KR.rmsnorm(x, sc, 1e-5), KR.rmsnorm_plain(x, sc, 1e-5)
            tag = f"rows={rows} D={D} x {str(xdt)[6:]} scale {str(sdt)[6:]}"
            if xdt == bf16:
                e = _err_ok("rmsnorm", tag, out, ref, elementwise=2 * BF16_STEP)
            else:
                e = _err_ok("rmsnorm", tag, out, ref, rel_to_max=1e-5)
            note("rmsnorm", xdt, e)
    log("[attn] rmsnorm rows x D in (4, 2048), (2048, 2048), (128, 64), x/scale bf16/bf16, "
        "bf16/f32, f32/f32: bf16 within one bf16 step of each value, f32 within 1e-5")
    for (name, dtype), w in worst.items():
        yard = "its row's max|out|" if name != "rmsnorm" else "max|out|"
        log(f"[attn] {name} {str(dtype)[6:]}: largest error over the sweep {w:.3g} of {yard} "
            f"({w / BF16_STEP:.2f} bf16 steps)")
    _planted_faults(rnd)

    # timed at the decode main path's shapes (bf16): llama3.2-1b, B = 4
    B, S, H, K, hd, D, cap = DECODE_B, DECODE_S, 32, 8, 64, 2048, DECODE_S + DECODE_NEW
    q, k, v = rnd(B, S, H, hd, dtype=bf16), rnd(B, S, K, hd, dtype=bf16), rnd(B, S, K, hd,
                                                                             dtype=bf16)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    qd, kc, vc = rnd(B, H, hd, dtype=bf16), rnd(B, cap, K, hd, dtype=bf16), \
        rnd(B, cap, K, hd, dtype=bf16)
    kct, vct = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    x, sc = rnd(B, D, dtype=bf16), rnd(D, dtype=bf16)
    xp = rnd(B * S, D, dtype=bf16)
    rows = {}

    def row(name, tag, kern, plain, lib, nbytes, flops, peak=H100_BF16_FLOPS):
        (ms, host_ms), (plain_ms, _) = time_ms(kern), time_ms(plain)
        lib_ms = time_ms(lib)[0] if lib is not None else None
        b_ms, b_by = bound_ms(nbytes, flops, peak)
        log(f"[attn] {name} {tag}: device time kernel {ms * 1e3:.2f} us (host "
            f"{host_ms * 1e3:.2f} us/call), plain {plain_ms * 1e3:.2f} us, library "
            f"{'-' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}, bound {b_ms * 1e3:.3f} us "
            f"({b_by}: {nbytes} B, {flops} flop)")
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                    max_abs_err=errs.get(name, 0.0), host_us=host_ms * 1e3)

    pairs = S * (S + 1) // 2
    rows["flash_attention"] = row(
        "flash_attention", f"B={B} S={S} H={H} K={K} hd={hd} bf16 causal",
        lambda: KF.flash_attention(q, k, v), lambda: KF.flash_attention_plain(q, k, v),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
        2 * B * S * (2 * H + 2 * K) * hd, 4 * B * H * hd * pairs)
    for pos in (DECODE_S, cap - 1):
        mask = (torch.arange(cap, device=dev) <= pos)[None, None, None, :]
        r = row("decode_attention", f"B={B} capacity={cap} pos={pos} H={H} K={K} hd={hd} bf16",
                lambda: KD.decode_attention(qd, kc, vc, pos),
                lambda: KD.decode_attention_plain(qd, kc, vc, pos),
                lambda: F.scaled_dot_product_attention(qd[:, :, None], kct, vct, attn_mask=mask,
                                                       enable_gqa=True),
                2 * (2 * B * H * hd + 2 * B * (pos + 1) * K * hd), 4 * B * H * hd * (pos + 1))
        if pos == cap - 1:
            rows["decode_attention"] = r
    for xs, tag in ((x, f"rows={B} D={D} (decode)"), (xp, f"rows={B * S} D={D} (prefill)")):
        n = xs.numel()
        r = row("rmsnorm", f"{tag} bf16, bf16 scale",
                lambda: KR.rmsnorm(xs, sc, 1e-5), lambda: KR.rmsnorm_plain(xs, sc, 1e-5),
                lambda: F.rms_norm(xs, (D,), sc, 1e-5), 2 * (2 * n + D), 4 * n)
        if xs is x:
            rows["rmsnorm"] = r

    # B1-B3 on the decode path's logits: (B, V) float32; B3's rows at 1.0
    # are those outside the interval
    V = 128256
    lu, lc = rnd(B, V), rnd(B, V)
    ls = torch.tensor([DECODE_SCALE, 1.0, 1.0, DECODE_SCALE], device=dev)
    out, ref = KC.cfg_combine(lu, lc, DECODE_SCALE), KC.cfg_combine_plain(lu, lc, DECODE_SCALE)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        fail(f"cfg_combine (4, {V}) f32: not bit-exact")
    out, ref = KC.cfg_combine_rowscale(lu, lc, ls), KC.cfg_combine_rowscale_plain(lu, lc, ls)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        fail(f"cfg_combine_rowscale (4, {V}) f32, scales {ls.tolist()}: not bit-exact, max "
             f"err {(out - ref).abs().max().item():.3g}")
    e, _ = _err_ok("apg_combine", f"(4, {V}) f32",
                   KC.apg_combine(lu, lc, DECODE_SCALE, eta=0.3),
                   KC.apg_combine_plain(lu, lc, DECODE_SCALE, eta=0.3), rel_to_max=1e-5)
    log(f"[attn] cfg_combine and cfg_combine_rowscale (4, {V}) f32 bit-exact; apg_combine "
        f"within 1e-5 of max|out| (max abs err {e:.3g})")
    n = B * V
    row("cfg_combine", f"(4, {V}) f32", lambda: KC.cfg_combine(lu, lc, DECODE_SCALE),
        lambda: KC.cfg_combine_plain(lu, lc, DECODE_SCALE),
        lambda: torch.lerp(lu, lc, DECODE_SCALE), 12 * n, 3 * n, H100_FP32_FLOPS)
    row("cfg_combine_rowscale", f"(4, {V}) f32", lambda: KC.cfg_combine_rowscale(lu, lc, ls),
        lambda: KC.cfg_combine_rowscale_plain(lu, lc, ls),
        lambda: torch.lerp(lu, lc, ls[:, None]), 12 * n + 4 * B, 3 * n, H100_FP32_FLOPS)
    row("apg_combine", f"(4, {V}) f32", lambda: KC.apg_combine(lu, lc, DECODE_SCALE, eta=0.3),
        lambda: KC.apg_combine_plain(lu, lc, DECODE_SCALE, eta=0.3), None, 12 * n, 16 * n,
        H100_FP32_FLOPS)
    return rows


def _planted_faults(rnd) -> None:
    """The bf16 attention tolerance must catch a causal fault that only
    late rows see, at the main path's prefill shape (B 4, S 512, H 32, K 8,
    hd 64): the plain version with (a) the last 32-key K/V tile (one
    ``kKeys`` tile of the kernel) weighted by 0.8 on the rows that reach
    it, (b) each row's own key weighted by 0.9 on rows >= 256, each held
    against the right output as a kernel's would be. Fails unless both are
    rejected. The log says whether 8 bf16 steps of the whole tensor's
    max|out|, which row 0 sets, would have caught them."""
    import math

    import torch
    from repro_torch.kernels import flash_attention as KF

    B, S, H, K, hd = DECODE_B, DECODE_S, 32, 8, 64
    q, k, v = (rnd(B, S, n, hd, dtype=torch.bfloat16) for n in (H, K, K))
    ref = KF.flash_attention_plain(q, k, v)
    pos = torch.arange(S, device=q.device)
    qp, kp = pos[:, None], pos[None, :]
    s = torch.einsum("bqkrh,bskh->bkrqs", q.reshape(B, S, K, H // K, hd), k).float()
    s = torch.where(kp <= qp, s / math.sqrt(hd), KF.NEG_INF)
    faults = {"last K/V tile weighted 0.8": ((kp >= S - 32) & (qp >= S - 32), 0.8),
              "own key weighted 0.9 on rows >= 256": ((kp == qp) & (qp >= 256), 0.9)}
    for fault, (where, weight) in faults.items():
        w = torch.softmax(s + torch.where(where, math.log(weight), 0.0), dim=-1)
        bad = torch.einsum("bkrqs,bskh->bqkrh", w.to(v.dtype), v).reshape(B, S, H, hd)
        ok, e, rel = _within(bad, ref, per_row=ATTN_BF16_STEPS * BF16_STEP)
        old_ok = _within(bad, ref, rel_to_max=8 * BF16_STEP)[0]
        if ok:
            fail(f"planted fault '{fault}' passes the attention tolerance (max abs err {e:.3g})")
        log(f"[attn] planted fault '{fault}' at B={B} S={S} causal bf16: rejected (largest "
            f"error {rel / BF16_STEP:.1f} bf16 steps of its row's max|out|, max abs {e:.3g}); "
            f"8 steps of the whole tensor's max|out| would {'pass' if old_ok else 'reject'} it")


def _expected_launches(L: int, plan, combine_kernel: str) -> dict:
    """Exact kernel launches of one ``guided_decode``: 2 prefills and
    ``plan.total_steps`` decode steps (FULL: two forwards, COND: one)."""
    n_cond = plan.optimized_steps
    n_full = plan.total_steps - n_cond
    forwards = 2 + 2 * n_full + n_cond
    want = {k: 0 for k in launch_counts()}
    want.update(flash_attention=2 * L, decode_attention=L * (forwards - 2),
                rmsnorm=(2 * L + 1) * forwards)
    if combine_kernel != "cfg_combine" or plan.guidance_scale != 1.0:
        want[combine_kernel] = 1 + n_full
    return want


COMBINE_MODES = {"cfg": ("cfg_combine", {}),
                 "apg": ("apg_combine", dict(apg_eta=0.3)),
                 "interval": ("cfg_combine_rowscale", dict(interval=(0.25, 0.75)))}


def phase_decode_parity():
    """The same ``guided_decode`` on the CPU (plain versions) and the GPU
    (kernels): llama3.2-1b at full width, 2 layers, bf16 weights, B = 2,
    prompts of 64 tokens, 16 new tokens."""
    import dataclasses

    import torch
    from repro_torch.configs.llama3_2_1b import CONFIG
    from repro_torch.core import ar_decode as AR
    from repro_torch.core.selective import GuidancePlan
    from repro_torch.data.prompts import PAPER_PROMPTS
    from repro_torch.data.tokenizer import encode_batch
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(CONFIG, num_layers=2)
    t0 = time.perf_counter()
    cpu = Transformer.init(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                           device="cpu")
    gpu = Transformer.from_state_dict(cfg, {k: t.cuda() for k, t in cpu.state_dict().items()})
    prompts = [" ".join(PAPER_PROMPTS[i::2]) for i in range(2)]
    toks = torch.from_numpy(encode_batch(prompts, cfg.vocab_size, 64)).long()
    plan = GuidancePlan.suffix(16, 0.25, DECODE_SCALE)
    log(f"[dparity] {cfg.name} x{cfg.num_layers} layers, B=2 S=64, 16 new tokens, "
        f"{plan.total_steps - plan.optimized_steps} FULL + {plan.optimized_steps} COND steps; "
        f"set-up {time.perf_counter() - t0:.2f} s")
    for mode, (kernel, kw) in COMBINE_MODES.items():
        kw = dict(kw, combine=mode)
        a, _ = AR.guided_decode(cpu, toks, plan, **kw)
        reset_launches()
        b, _ = AR.guided_decode(gpu, toks.cuda(), plan, **kw)
        torch.cuda.synchronize()
        counts, want = launch_counts(), _expected_launches(cfg.num_layers, plan, kernel)
        if counts != want:
            fail(f"dparity {mode}: launches {counts}, want {want}")
        la = AR.teacher_forced_logits(cpu, toks, plan, a, **kw)
        lb = AR.teacher_forced_logits(gpu, toks.cuda(), plan, a.cuda(), **kw).cpu()
        big = la.abs().max().item()
        err = (lb - la).abs()
        if not err.max().item() <= LOGIT_TOL * big:
            fail(f"dparity {mode}: teacher-forced logits rel err {err.max().item() / big:.3g} "
                 f"> {LOGIT_TOL}")
        # a step is decided where the CPU's margin of its top token over every
        # other token exceeds the two logits' CPU-GPU differences
        top = la.argmax(-1, keepdim=True)
        gap = la.gather(-1, top) - la
        slack = err.gather(-1, top) + err
        other = torch.arange(la.shape[-1]) != top
        undecided = ((gap <= slack) & other).any(-1)                 # (B, n_new)
        compared = 0
        for r in range(a.shape[0]):
            low = undecided[r].nonzero()
            upto = int(low[0]) if len(low) else a.shape[1]
            if not torch.equal(a[r, :upto], b[r, :upto].cpu()):
                fail(f"dparity {mode}: row {r} tokens differ before step {upto}: "
                     f"{a[r].tolist()} vs {b[r].tolist()}")
            compared += upto
        log(f"[dparity] {mode}: launches {want}; teacher-forced logits rel err "
            f"{err.max().item() / big:.3g} (tol {LOGIT_TOL}, max|logit| {big:.3g}); tokens "
            f"equal on the {compared} of {a.numel()} decided steps, "
            f"{int((a == b.cpu()).sum())} equal overall")


def phase_decode_main():
    """``guided_decode`` on llama3.2-1b at full width and depth. -> (model,
    prompts, launches of the counted f = 0.2 runs, seconds per generate by f)."""
    import numpy as np
    import torch
    from repro_torch.configs.llama3_2_1b import CONFIG as cfg
    from repro_torch.core import ar_decode as AR
    from repro_torch.core.selective import GuidancePlan
    from repro_torch.models.transformer import Transformer

    t0 = time.perf_counter()
    model = Transformer.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                             dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (DECODE_B, DECODE_S))).long().cuda()
    log(f"[dmain] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {n_params} "
        f"params in bf16, init {time.perf_counter() - t0:.2f} s; B={DECODE_B} prompts of "
        f"{DECODE_S} tokens, {DECODE_NEW} new tokens, scale {DECODE_SCALE}, greedy")

    def run(plan, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, end = AR.guided_decode(model, toks, plan, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        if tuple(out.shape) != (DECODE_B, DECODE_NEW) or end != DECODE_S + DECODE_NEW or \
                not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
            fail(f"dmain: tokens {tuple(out.shape)} end {end} out of range")
        return out, dt

    launches = {}
    plan = GuidancePlan.suffix(DECODE_NEW, 0.2, DECODE_SCALE)
    for mode, (kernel, kw) in COMBINE_MODES.items():
        reset_launches()
        out, dt = run(plan, combine=mode, **kw)
        counts, want = launch_counts(), _expected_launches(cfg.num_layers, plan, kernel)
        if counts != want:
            fail(f"dmain combine={mode}: launches {counts}, want {want}")
        for name in ("flash_attention", "decode_attention", "rmsnorm", kernel):
            launches[name] = counts[name]
        log(f"[dmain] generate combine={mode} f=0.2: launches {want}, {dt:.3f} s incl. "
            f"first-call set-up, first tokens {out[0, :8].tolist()}")

    rows = []
    for f in (0.0, 0.2, 0.5, 1.0):
        plan = GuidancePlan.suffix(DECODE_NEW, f, DECODE_SCALE)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        times = [run(plan)[1] for _ in range(4)][1:]
        counts = {k: v / 4 for k, v in launch_counts().items()}
        want = _expected_launches(cfg.num_layers, plan, "cfg_combine")
        if counts != want:
            fail(f"dmain f={f}: launches per generate {counts}, want {want}")
        forwards = 2 + 2 * (DECODE_NEW - plan.optimized_steps) + plan.optimized_steps
        rows.append(dict(f=f, mean_s=float(np.mean(times)), std_s=float(np.std(times)),
                         forwards=forwards, peak_gb=torch.cuda.max_memory_allocated() / 1e9))
    for r in rows:
        r["saving"] = 1.0 - r["mean_s"] / rows[0]["mean_s"]
        log(f"[dmain] f={r['f']}: mean {r['mean_s']:.4f} s std {r['std_s']:.4f} s (1 warm-up, "
            f"3 timed), {DECODE_B * DECODE_NEW / r['mean_s']:.1f} tokens/s, forwards "
            f"{r['forwards']}, saving {r['saving']:.4f}, peak {r['peak_gb']:.2f} GB")
    return model, toks, launches, rows


def _graph_ms(fn, iters: int = 20) -> float:
    """Device ms per call of ``fn`` captured once as a CUDA graph and
    replayed: the card's time for its kernels without the host's gaps.
    (Events around eager calls queued behind a sleep kernel do not give it
    here: a decode step issues over a thousand launches, more than the
    launch queue holds, so the host still paces the card.) A measurement
    only; the port runs eagerly."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _wall_ms(fn, iters: int = 10) -> float:
    """Wall ms per eager call, finished: the host's pace where it is slower."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_decode_breakdown(model, toks, rows) -> None:
    """Where a generate's time goes: both prefills, one FULL and one COND
    step, each as device time (CUDA-graph replay) and eager wall time, and
    the device-busy share of the decode loop at f = 0.2."""
    import torch
    from repro_torch.core import ar_decode as AR
    from repro_torch.core.selective import GuidancePlan

    cap = DECODE_S + DECODE_NEW
    null = AR.null_prompt(toks)
    with torch.no_grad():
        prefills = lambda: (AR.prefill(model, toks), AR.prefill(model, null))  # noqa: E731
        pre_dev, pre_wall = _graph_ms(prefills, iters=3), _wall_ms(prefills, iters=3)
        _, cc = AR.prefill(model, toks)
        _, cu = AR.prefill(model, null)
        cc = model.prepare_decode_caches(cc, seq_len=DECODE_S, capacity=cap)
        cu = model.prepare_decode_caches(cu, seq_len=DECODE_S, capacity=cap)
        tok, pos = toks[:, -1], DECODE_S + DECODE_NEW // 2
        full = lambda: AR.decode_step_full(model, tok, cc, cu, pos, DECODE_SCALE)  # noqa: E731
        cond = lambda: AR.decode_step_cond(model, tok, cc, pos)  # noqa: E731
        full_wall, cond_wall = _wall_ms(full), _wall_ms(cond)
        full_dev, cond_dev = _graph_ms(full), _graph_ms(cond)
    plan = GuidancePlan.suffix(DECODE_NEW, 0.2, DECODE_SCALE)
    n_cond = plan.optimized_steps
    n_full = DECODE_NEW - n_cond
    gen_s = next(r["mean_s"] for r in rows if r["f"] == 0.2)
    loop_s = gen_s - pre_wall / 1e3
    busy = (n_full * full_dev + n_cond * cond_dev) / 1e3 / loop_s
    log(f"[dbreak] prefill, both streams: device {pre_dev:.3f} ms, wall {pre_wall:.3f} ms")
    log(f"[dbreak] FULL step at pos {pos}: device {full_dev:.3f} ms, wall {full_wall:.3f} ms; "
        f"COND step: device {cond_dev:.3f} ms, wall {cond_wall:.3f} ms; COND/FULL device "
        f"{cond_dev / full_dev:.3f}, wall {cond_wall / full_wall:.3f}")
    log(f"[dbreak] generate f=0.2 wall {gen_s:.4f} s = prefill {pre_wall / 1e3:.4f} s + decode "
        f"loop {loop_s:.4f} s ({n_full} FULL + {n_cond} COND steps); device-busy share of the "
        f"loop {busy:.4f}")

def phase_decode_profile(model, toks) -> None:
    """The kernels that take a FULL decode step's device time under
    ``torch.profiler``: summed device time by kernel, its share of the
    step's kernel time, and launches per step."""
    import torch
    from repro_torch.core import ar_decode as AR
    from torch.profiler import ProfilerActivity, profile

    cap = DECODE_S + DECODE_NEW
    with torch.no_grad():
        _, cc = AR.prefill(model, toks)
        _, cu = AR.prefill(model, AR.null_prompt(toks))
        cc = model.prepare_decode_caches(cc, seq_len=DECODE_S, capacity=cap)
        cu = model.prepare_decode_caches(cu, seq_len=DECODE_S, capacity=cap)
        step = lambda: AR.decode_step_full(model, toks[:, -1], cc, cu, DECODE_S, DECODE_SCALE)  # noqa: E731
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    by_name, n = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            t, k = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (t + e.end_ns() - e.start_ns(), k + 1)
            n += 1
    total = sum(t for t, _ in by_name.values())
    if not total:
        log("[dprofile] not measured: the profiler saw no device time")
        return
    log(f"[dprofile] one FULL step at pos {DECODE_S}: {n} kernel launches, {total / 1e6:.3f} ms "
        f"of kernel time (profiled)")
    for rank, (name, (t, k)) in enumerate(sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]):
        log(f"[dprofile] {rank + 1}. {t / total:.3f} of kernel time, {k}x {name[:90]}")

def main() -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    smi = phase_device()
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the repro_torch package is not beside this script: {exc}")
    import torch

    phase_build()
    rows = phase_kernels()
    phase_parity()
    pipe, sd_launches = phase_main_path()
    phase_breakdown(pipe)
    phase_profile(pipe)
    del pipe
    torch.cuda.empty_cache()

    rows.update(phase_attn_kernels())
    phase_decode_parity()
    model, toks, ar_launches, ar_rows = phase_decode_main()
    phase_decode_breakdown(model, toks, ar_rows)
    phase_decode_profile(model, toks)

    cu = "src/repro_torch/csrc/"
    kernels = {
        "cfg_combine": ("cfg_combine.cu", "src/repro/kernels/cfg_combine.py:52"),
        "cfg_combine_rowscale": ("cfg_combine.cu", "src/repro/kernels/cfg_combine.py:171"),
        "apg_combine": ("cfg_combine.cu", "src/repro/kernels/cfg_combine.py:136"),
        "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:69"),
        "decode_attention": ("decode_attention.cu", "src/repro/kernels/decode_attention.py:63"),
        "rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:24"),
    }
    out = []
    for name, (src, replaces) in kernels.items():
        sd, ar = sd_launches.get(name, 0), ar_launches.get(name, 0)
        if sd + ar == 0:
            fail(f"{name}: launched no time on the main paths")
        log(f"[launches] {name}: {sd} in the SD generate's run, {ar} in guided_decode's")
        r = {k: v for k, v in rows[name].items() if k != "host_us"}
        out.append(dict(name=name, route="cuda", source=cu + src, replaces=replaces,
                        launches=sd + ar, **r))
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
