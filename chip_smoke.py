#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the script with a non-zero exit if it fails:

1. device: needs CUDA; prints the card's name and power limit; turns TF32
   off for matmuls and convolutions (the reference is full float32);
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
   that lead one generate under ``torch.profiler``.

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
LATENT = (64, 64, 4)


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


def bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


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
    pipe, launches = phase_main_path()
    phase_breakdown(pipe)
    phase_profile(pipe)

    src = "src/repro_torch/csrc/cfg_combine.cu"
    replaces = {"cfg_combine": "src/repro/kernels/cfg_combine.py:52",
                "cfg_combine_rowscale": "src/repro/kernels/cfg_combine.py:171",
                "apg_combine": "src/repro/kernels/cfg_combine.py:136"}
    kernels = [dict(name=name, route="cuda", source=src, replaces=replaces[name],
                    launches=launches[name], **rows[name]) for name in replaces]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
