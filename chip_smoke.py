#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the script with a non-zero exit if it fails:

1. device: needs CUDA; prints the card's name and power limit; turns TF32
   off for matmuls and convolutions (the reference is full float32) and
   bf16 matmuls' reduced-precision reductions off;
2. build: compiles ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a and
   logs the B1/B3, B2, B4, B5, B6 and B7-B10 kernels' registers, shared
   memory and spills (a B1/B3, B2, B6 or B7-B10 instantiation that spills
   fails, and so does a build that holds a ``paged_kernel`` or an
   ``apg_kernel``: B7-B10 run one template, B2 its cluster template);
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
   RMSNorm kernels against their plain versions at every dense decoder's
   head dim and group (hd 64/120/128, H/K 4/5/8), the prefill at S 77 to
   2048 and a serve bucket (B 2, S 128), the decode at capacities 768 and
   4096 and in its ring form (attention held row by row, and shown to
   reject planted causal faults), RMSNorm timed at 4, 16, 256 and 2048 rows
   of 2048, and the three guidance-combine kernels on (4, 128256) float32
   logits, each timed beside its bound and a library call, and B2 on the
   serve engine's (16, 128256) with per-row scales and padding rows and on
   the (1, 151936) and (1, 256000) logits (its re-read route); then the
   latency-bound kernels: RMSNorm over rows {1 .. 4097} x dims {64 .. 8192}
   x the four x/scale dtype pairs (its route logged), Eq. 1 and its per-row
   form bit-exact on ragged lengths and unaligned views, and B1, B3 and B6
   timed in turns against ``torch.lerp`` and ``F.rms_norm`` (median and
   min-max of six each);
8. decode parity: ``guided_decode`` on llama3.2-1b at full width, 2 layers,
   on the CPU (plain versions) and the GPU (kernels), teacher-forced logits
   and margin-guarded tokens, for each combine mode;
9. ring parity: the same on h2o-danube-3-4b at full width, 2 layers, its
   window cut to 128 under a 160-token prompt, so that every decode step
   attends through a ring cache (the flash-decode kernel's ring form);
10. decode main path: ``guided_decode`` on llama3.2-1b at full width and
   depth (random bf16 weights from a seed), B = 4 prompts of 512 tokens, 256
   new tokens, with exact launch counts (RMSNorm's split by rows), for COND
   suffix fractions f in {0, 0.2, 0.5, 1.0}; then where its time goes
   (device time of a step from a CUDA-graph replay, beside its eager wall
   time) and the kernels that lead a FULL step under ``torch.profiler``,
   with RMSNorm's and Eq. 1's shares;
11. paged kernels vs plain: the four paged/ragged decode kernels against
   their plain version at the serve path's shapes (R 16, H 32, K 8, hd 64,
   pages of 16, a pool of 640 pages, tables of 40), positions spread over
   the tables, a quarter of the rows at phase 0, out-of-range table
   entries, with and without a window, and at the other dense decoders'
   head groups (every ``block_k`` giving the same bits: the kernels have no
   sub-page tile); each timed beside its bytes bound and its plain version;
   then B9 against B7, and B8 against B10, with every row at phase 1: the
   same kernel on the same inputs, bit for bit;
12. serve parity: the same arrival trace through ``ContinuousEngine`` on
   llama3.2-1b at full width, 2 layers, on the CPU (plain versions) and the
   GPU (kernels), both step modes and both pool dtypes, and the apg and
   interval combines: event streams equal, tokens equal up to the first
   step the logits do not decide;
13. serve main path: ``ContinuousEngine`` on llama3.2-1b at full width and
   depth, 16 requests of 128 to 512 prompt tokens and 128 new tokens
   arriving two a tick, ragged bf16 at f in {0, 0.2, 0.5} and at f = 0.2
   ragged int8, signature bf16 and signature int8, each after a warm-up,
   with exact launch counts of the paged kernels and RMSNorm's launches by
   rows; then a steady tick under ``torch.profiler``, with RMSNorm's and
   the paged kernel's shares.

``python3 chip_smoke.py --decode-steps [SRC]``, ``--serve-steps [SRC]``,
``--paged-kernels [SRC]`` and ``--apg-kernels [SRC]`` time and profile the
decode steps (the cfg and the APG FULL step), a steady serve tick of each
(step mode, pool dtype) pair, the four paged kernels at the serve shape, or
B2 at its four timed shapes, of the ``repro_torch`` under SRC alone (two
trees compare in turns in one call); ``--apg-plans`` times B2 under other
launch plans than its own.

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


def apg_within(out, ref) -> tuple[bool, float]:
    """B2's tolerance: float32 within 1e-5 + 1e-5 |ref| of each value (the
    row sums are taken in another order), bfloat16 within one bf16 step
    (2^-7 |ref| + 1e-5); every value finite. -> (ok, max abs error)."""
    import torch
    torch.cuda.synchronize()
    rtol, atol = (1e-5, 1e-5) if ref.dtype == torch.float32 else (2 ** -7, 1e-5)
    err = (out.float() - ref.float()).abs()
    ok = bool(torch.isfinite(out).all()) and not bool((err > atol + rtol * ref.float().abs()).any())
    return ok, err.max().item()


def kernel_modules():
    from repro_torch.kernels import (cfg_combine, decode_attention, flash_attention,
                                     paged_decode_attention, rmsnorm)
    return (cfg_combine, flash_attention, decode_attention, rmsnorm, paged_decode_attention)


def reset_launches() -> None:
    for m in kernel_modules():
        m.reset_launches()


def launch_counts() -> dict:
    return {k: v for m in kernel_modules() for k, v in m.LAUNCHES.items()}


class _NormCensus:
    """Counts the RMSNorm kernel's launches by (rows, dim) while active: the
    wrapper is swapped for one that counts each CUDA call and calls it."""

    def __init__(self):
        self.by_shape = {}

    def __enter__(self):
        from repro_torch.kernels import rmsnorm as KR
        self._inner = inner = KR.rmsnorm

        def counted(x, scale, eps=1e-6):
            if x.is_cuda and x.numel():
                key = (x.numel() // x.shape[-1], x.shape[-1])
                self.by_shape[key] = self.by_shape.get(key, 0) + 1
            return inner(x, scale, eps)
        KR.rmsnorm = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import rmsnorm as KR
        KR.rmsnorm = self._inner

    def summary(self) -> str:
        return ", ".join(f"{r}x{d}: {n}" for (r, d), n in sorted(self.by_shape.items()))


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


def _ptxas_report(text: str) -> list:
    """-> [(kernel, registers, static shared bytes, spill stores, spill
    loads)] from ``nvcc -Xptxas -v``'s log, one entry per kernel."""
    import re
    out, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append((name, int(m.group(1)), int(m.group(2) or 0), *spill))
            name = None
    return out


# the kernels whose resources phase 2 reports, by the name nvcc mangles into
# each instantiation; those of NO_SPILL_KERNELS (B1/B3, B2, B6, B7-B10) must
# not spill
REPORTED_KERNELS = ("flash_wgmma_kernel", "decode_mma_kernel", "decode_kernel",
                    "combine_kernel", "apg_cluster_kernel", "rmsnorm_kernel",
                    "paged_split_kernel")
NO_SPILL_KERNELS = ("combine_kernel", "apg_cluster_kernel", "rmsnorm_kernel",
                    "paged_split_kernel")
# the one-block-a-row kernels the templates replaced
RETIRED_KERNELS = ("paged_kernel", "apg_kernel")


def _template_args(mangled: str) -> str:
    """A readable form of an instantiation's mangled template arguments;
    what it does not know it leaves mangled."""
    import re
    words = {"f": "float", "j": "uint32", "y": "uint64", "13__nv_bfloat16": "bf16",
             "Lb0E": "false", "Lb1E": "true"}
    out, last_type = [], ""
    for m in re.finditer(r"13__nv_bfloat16|S\d*_|Lb[01]E|Li(\d+)E?|[fjy]|.+?", mangled):
        if m.group(0)[0] == "S":               # a substitution: the type named before
            out.append(last_type)
            continue
        out.append(m.group(1) or words.get(m.group(0), m.group(0)))
        if m.group(0) in ("f", "13__nv_bfloat16"):
            last_type = out[-1]
    return ",".join(out)


def phase_build():
    import re

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path, text = build.build(verbose=True)
    build.load()
    log(f"[build] {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in text.splitlines():
        if "error" in line.lower() or "Performance Loss" in line:
            log(f"[build] {line.strip()}")
    spilled, stray = [], []
    for name, regs, smem, st, ld in _ptxas_report(text):
        if re.search(r"\d+(" + "|".join(RETIRED_KERNELS) + ")I", name):
            stray.append(name)
        m = re.search("(" + "|".join(REPORTED_KERNELS) + r")I(\w*?)E(Ev|v)", name)
        if m:
            log(f"[build] {m.group(1)}<{_template_args(m.group(2))}>: {regs} registers, {smem} "
                f"bytes static shared memory (the rest is dynamic, sized per launch), spills "
                f"{st} bytes stored / {ld} loaded")
            if m.group(1) in NO_SPILL_KERNELS and st + ld:
                spilled.append(f"{m.group(1)}<{m.group(2)}>")
    if not text:
        log("[build] the library was built before: no register report")
    if spilled:
        fail(f"B1/B3/B2/B6/B7-B10 instantiations spill registers: {spilled}")
    if stray:
        fail(f"the build holds a retired one-block-a-row kernel: {stray}")


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
            # B2: within ``apg_within``'s tolerance
            uq = u.clone()
            uq[0] = c[0]                                   # a u == c row
            diff = torch.randn(shape, generator=gen, device=dev)
            for eta in (0.0, 0.3):
                for thr in (0.0, 1.0):
                    for d in (None, diff):
                        out = K.apg_combine(uq, c, 7.5, eta=eta, threshold=thr, diff=d)
                        ref = K.apg_combine_plain(uq, c, 7.5, eta=eta, threshold=thr,
                                                  diff=d)
                        ok, err = apg_within(out, ref)
                        if not ok:
                            fail(f"apg_combine {tag} eta={eta} thr={thr} "
                                 f"diff={d is not None}: max err {err}")
                        if d is None and not torch.equal(out[0], c[0]):
                            fail(f"apg_combine {tag}: a u == c row must return c")
                        if dtype == torch.float32:
                            errs["apg_combine"] = max(errs["apg_combine"], err)
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
# B6's timed shapes at llama3.2-1b's d_model: rows and where the main paths
# give them
NORM_SHAPES = ((4, "decode"), (16, "a serve ragged tick"), (256, "a serve prefill bucket"),
               (2048, "decode prefill"))
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
    # sweep's largest per-row differences were 6.10 steps (flash) and 3.58
    # (decode). float32: 1e-5.
    # RMSNorm in bf16: one step of each value; float32 1e-5 of max|out|.
    def tol(dtype):
        return ATTN_BF16_STEPS * BF16_STEP if dtype == bf16 else 1e-5

    errs = {"flash_attention": 0.0, "decode_attention": 0.0, "rmsnorm": 0.0}
    worst = {}      # (kernel, dtype) -> largest error over max|ref|

    def note(name, dtype, e):
        errs[name] = max(errs[name], e[0])
        worst[name, dtype] = max(worst.get((name, dtype), 0.0), e[1])
    # every dense decoder's (hd, rep): llama3.2-1b (64, 4), qwen3-14b (128, 5),
    # h2o-danube-3-4b (120, 4), yi-9b (128, 8)
    for hd, H, K in ((64, 32, 8), (128, 40, 8), (120, 32, 8), (128, 32, 4)):
        for B, S in ((1, 77), (1, 512), (1, 2048), (4, 77), (4, 512), (4, 2048), (2, 128)):
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
        log(f"[attn] flash_attention hd={hd} H/K={H}/{K}: (B, S) in (1|4, 77|512|2048) and "
            f"(2, 128) x causal/non-causal x window None/256 x bf16/f32 within tolerance")
        for B, cap, positions in ((1, 768, (0, 63, 64, 511, 767)), (4, 768, (0, 63, 64, 511, 767)),
                                  (1, 4096, (4095,))):
            for dtype in (bf16, f32):
                q, k, v = rnd(B, H, hd, dtype=dtype), rnd(B, cap, K, hd, dtype=dtype), \
                    rnd(B, cap, K, hd, dtype=dtype)
                for pos in positions:
                    for window in (None, 256):
                        tag = f"hd={hd} B={B} S={cap} pos={pos} window={window} {str(dtype)[6:]}"
                        e = _err_ok("decode_attention", tag,
                                    KD.decode_attention(q, k, v, pos, window=window),
                                    KD.decode_attention_plain(q, k, v, pos, window=window),
                                    per_row=tol(dtype))
                        note("decode_attention", dtype, e)
        # the ring form: W slots, position p at slot p % W, the positions past
        # the ring's fill and eight random slots empty (-1)
        W = 256
        for dtype in (bf16, f32):
            q, k, v = rnd(2, H, hd, dtype=dtype), rnd(2, W, K, hd, dtype=dtype), \
                rnd(2, W, K, hd, dtype=dtype)
            for pos in (150, 1000):
                slots = torch.arange(W, device=dev, dtype=torch.int32)
                slot_pos = pos - (pos - slots) % W
                slot_pos = torch.where(slot_pos < 0, -1, slot_pos).to(torch.int32)
                slot_pos[torch.randperm(W, generator=gen, device=dev)[:8]] = -1
                slot_pos[pos % W] = pos
                for window in (64, 256):
                    tag = f"hd={hd} ring W={W} pos={pos} window={window} {str(dtype)[6:]}"
                    e = _err_ok("decode_attention", tag,
                                KD.decode_attention(q, k, v, pos, window=window, slot_pos=slot_pos),
                                KD.decode_attention_plain(
                                    q, k, v, pos, valid=KD.ring_valid(slot_pos, pos, window)),
                                per_row=tol(dtype))
                    note("decode_attention", dtype, e)
        log(f"[attn] decode_attention hd={hd} H/K={H}/{K}: capacity 768 at pos in (0, 63, 64, 511, "
            f"767) x B in (1, 4), capacity 4096 at pos 4095, x window None/256; ring of {W} slots "
            f"at pos 150/1000 x window 64/256; bf16/f32 within tolerance")
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
    qd, kc, vc = rnd(B, H, hd, dtype=bf16), rnd(B, cap, K, hd, dtype=bf16), \
        rnd(B, cap, K, hd, dtype=bf16)
    sc = rnd(D, dtype=bf16)
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

    def flash_row(q, k, v):
        Bq, Sq = q.shape[:2]
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        return row("flash_attention", f"B={Bq} S={Sq} H={H} K={K} hd={hd} bf16 causal",
                   lambda: KF.flash_attention(q, k, v), lambda: KF.flash_attention_plain(q, k, v),
                   lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                          enable_gqa=True),
                   2 * Bq * Sq * (2 * H + 2 * K) * hd, 4 * Bq * H * hd * Sq * (Sq + 1) // 2)

    rows["flash_attention"] = flash_row(q, k, v)
    flash_row(*(t[:2, :128].contiguous() for t in (q, k, v)))     # a serve prefill bucket
    kc4, vc4 = rnd(B, 4096, K, hd, dtype=bf16), rnd(B, 4096, K, hd, dtype=bf16)
    for kk, vv, pos in ((kc, vc, DECODE_S), (kc, vc, cap - 1), (kc4, vc4, 4095)):
        S_kv = kk.shape[1]
        kkt, vvt = kk.transpose(1, 2).contiguous(), vv.transpose(1, 2).contiguous()
        mask = (torch.arange(S_kv, device=dev) <= pos)[None, None, None, :]
        r = row("decode_attention", f"B={B} capacity={S_kv} pos={pos} H={H} K={K} hd={hd} bf16",
                lambda: KD.decode_attention(qd, kk, vv, pos),
                lambda: KD.decode_attention_plain(qd, kk, vv, pos),
                lambda: F.scaled_dot_product_attention(qd[:, :, None], kkt, vvt, attn_mask=mask,
                                                       enable_gqa=True),
                2 * (2 * B * H * hd + 2 * B * (pos + 1) * K * hd), 4 * B * H * hd * (pos + 1))
        if pos == cap - 1:
            rows["decode_attention"] = r
    for n_rows, what in NORM_SHAPES:
        xs = rnd(n_rows, D, dtype=bf16)
        n = xs.numel()
        plan = KR.rmsnorm_plan(n_rows, D, bf16)
        r = row("rmsnorm", f"rows={n_rows} D={D} ({what}) bf16, bf16 scale, {plan.route} "
                f"{plan.threads}x{plan.vecs}x{plan.rows_per_block}",
                lambda: KR.rmsnorm(xs, sc, 1e-5), lambda: KR.rmsnorm_plain(xs, sc, 1e-5),
                lambda: F.rms_norm(xs, (D,), sc, 1e-5), 2 * (2 * n + D), 4 * n)
        if n_rows == DECODE_B:
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
    # B2 within phase 3's tolerance (``apg_within``): the decode logits
    # with one scale, and the per-row form the serve engine combines with,
    # where a self-paired row (u == c) returns c
    apg_errs = []

    def apg_ok(tag, out, ref):
        ok, e = apg_within(out, ref)
        if not ok:
            fail(f"apg_combine {tag}: max abs err {e:.3g}")
        apg_errs.append(e)

    apg_ok(f"(4, {V}) f32", KC.apg_combine(lu, lc, DECODE_SCALE, eta=0.3),
           KC.apg_combine_plain(lu, lc, DECODE_SCALE, eta=0.3))
    lu2 = lu.clone()
    lu2[0] = lc[0]
    out = KC.apg_combine(lu2, lc, ls, eta=0.3, threshold=2.0)
    apg_ok(f"(4, {V}) f32 per-row scales {ls.tolist()}", out,
           KC.apg_combine_plain(lu2, lc, ls, eta=0.3, threshold=2.0))
    if not torch.equal(out[0], lc[0]):
        fail("apg_combine per-row: a u == c row must return c")
    # the serve engine's R = 16 combine: per-row scales, a self-paired row
    # and three padding rows of zeros
    R = SERVE_R
    su, sc16 = rnd(R, V), rnd(R, V)
    su[0] = sc16[0]
    su[-3:], sc16[-3:] = 0.0, 0.0
    ss = torch.linspace(1.0, 7.5, R, device=dev)
    for eta, thr in ((0.0, 0.0), (0.3, 2.0)):
        out = KC.apg_combine(su, sc16, ss, eta=eta, threshold=thr)
        apg_ok(f"({R}, {V}) f32 per-row scales eta={eta} thr={thr}", out,
               KC.apg_combine_plain(su, sc16, ss, eta=eta, threshold=thr))
        if not torch.equal(out[0], sc16[0]) or not bool((out[-3:] == 0).all()):
            fail(f"apg_combine ({R}, {V}): the u == c row must return c, padding rows 0")
    # qwen3-14b's and recurrentgemma-9b's vocabularies: the re-read route
    for Vl in (151936, 256000):
        plan = KC.apg_plan(1, Vl, f32, False)
        lu1, lc1, ld1 = rnd(1, Vl), rnd(1, Vl), rnd(1, Vl)
        for d in (None, ld1):
            apg_ok(f"(1, {Vl}) f32 diff={d is not None} ({plan.route})",
                   KC.apg_combine(lu1, lc1, DECODE_SCALE, eta=0.3, threshold=1.0, diff=d),
                   KC.apg_combine_plain(lu1, lc1, DECODE_SCALE, eta=0.3, threshold=1.0, diff=d))
    log(f"[attn] cfg_combine and cfg_combine_rowscale (4, {V}) f32 bit-exact; apg_combine "
        f"within 1e-5 + 1e-5|ref| (max abs err {max(apg_errs):.3g}) at (4, {V}) with one scale "
        f"and per-row scales, ({R}, {V}) with per-row scales and padding rows, (1, 151936) and "
        f"(1, 256000) (route {KC.apg_plan(1, 256000, f32, False).route}); u == c rows exact")
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
    row("apg_combine", f"(4, {V}) f32, per-row scales",
        lambda: KC.apg_combine(lu, lc, ls, eta=0.3),
        lambda: KC.apg_combine_plain(lu, lc, ls, eta=0.3), None, 12 * n + 4 * B, 16 * n,
        H100_FP32_FLOPS)
    row("apg_combine", f"({R}, {V}) f32, per-row scales",
        lambda: KC.apg_combine(su, sc16, ss, eta=0.3),
        lambda: KC.apg_combine_plain(su, sc16, ss, eta=0.3), None, 12 * R * V + 4 * R,
        16 * R * V, H100_FP32_FLOPS)
    return rows


def phase_latency_sweeps():
    """B6 against its plain version over rows {1, 4, 8, 16, 17, 256, 2048,
    4097} x dims {64, 120, 128, 2048, 3840, 4096, 5120, 8192} x the four
    x/scale dtype pairs, logging each case's route; B1 and B3 bit-exact on
    ragged lengths (a partial last vector) and on views that are not 16-byte
    aligned (the scalar path)."""
    import torch
    from repro_torch.kernels import cfg_combine as KC
    from repro_torch.kernels import rmsnorm as KR

    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(15)

    def rnd(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    worst = {bf16: 0.0, f32: 0.0}
    for n_rows in (1, 4, 8, 16, 17, 256, 2048, 4097):
        routes = []
        for D in (64, 120, 128, 2048, 3840, 4096, 5120, 8192):
            for xdt, sdt in ((bf16, bf16), (bf16, f32), (f32, bf16), (f32, f32)):
                x, sc = rnd(n_rows, D, dtype=xdt) * 3, rnd(D, dtype=sdt)
                out, ref = KR.rmsnorm(x, sc, 1e-5), KR.rmsnorm_plain(x, sc, 1e-5)
                tag = f"rows={n_rows} D={D} x {str(xdt)[6:]} scale {str(sdt)[6:]}"
                if xdt == bf16:
                    e = _err_ok("rmsnorm", tag, out, ref, elementwise=2 * BF16_STEP)
                else:
                    e = _err_ok("rmsnorm", tag, out, ref, rel_to_max=1e-5)
                worst[xdt] = max(worst[xdt], e[1])
            p, q = KR.rmsnorm_plan(n_rows, D, bf16), KR.rmsnorm_plan(n_rows, D, f32)
            routes.append(f"D={D} {p.route} {p.threads}x{p.vecs}x{p.rows_per_block}"
                          f"/{q.threads}x{q.vecs}x{q.rows_per_block}")
        log(f"[lsweep] rmsnorm rows={n_rows}, 4 dtype pairs within tolerance; route "
            f"threads x vecs x rows a block (bf16/f32 x): " + ", ".join(routes))
    log(f"[lsweep] rmsnorm largest error: bf16 x {worst[bf16]:.3g} of |out| elementwise "
        f"(tol {2 * BF16_STEP:.3g}), float32 x {worst[f32]:.3g} of max|out| (tol 1e-5)")

    cases = []
    for dtype in (f32, bf16):
        for n in (1, 3, 7, 4095, 16385, 4 * 128256 + 3):
            cases.append(("1-D", rnd(n + 1, dtype=dtype), rnd(n + 1, dtype=dtype), n, None))
        for R, F_ in ((3, 1001), (4, 128256), (2, 64 * 64 * 4), (5, 24)):
            cases.append(("rows", rnd(R * F_ + 1, dtype=dtype), rnd(R * F_ + 1, dtype=dtype),
                          R * F_, R))
    for kind, ub, cb, n, R in cases:
        for off in (0, 1):                       # 1: one element off a 16-byte boundary
            u, c = ub[off:off + n], cb[off:off + n]
            shape = (n,) if R is None else (R, n // R)
            u, c = u.view(shape), c.view(shape)
            tag = f"{shape} {str(u.dtype)[6:]} offset {off}"
            out, ref = KC.cfg_combine(u, c, 7.5), KC.cfg_combine_plain(u, c, 7.5)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                fail(f"cfg_combine {tag}: not bit-exact")
            rows_ = shape[0] if len(shape) > 1 else 1
            s = torch.tensor([7.5 if r % 2 == 0 else 1.0 for r in range(rows_)], device=dev)
            out = KC.cfg_combine_rowscale(u, c, s)
            ref = KC.cfg_combine_rowscale_plain(u, c, s)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                fail(f"cfg_combine_rowscale {tag}: not bit-exact")
    log(f"[lsweep] cfg_combine and cfg_combine_rowscale bit-exact on {len(cases) // 2} shapes "
        f"x float32/bf16 x 16-byte aligned (the vector path, but B3 on rows of 1001 takes "
        f"the scalar one) / one element off (the scalar path): 1-D lengths 1, 3, 7, "
        f"4095, 16385, 4*128256+3; rows (3, 1001), (4, 128256), (2, 16384), (5, 24)")


def _median_spread(ts):
    import statistics
    return statistics.median(ts), max(ts) - min(ts), min(ts), max(ts)


def phase_alternation() -> dict:
    """B1, B3 and B6 against one PyTorch call of the same function, in turns
    (kernel, library, library, kernel, three times over) at the main paths'
    shapes: B1/B3 at the SD latent and the decode logits against
    ``torch.lerp``, B6 at ``NORM_SHAPES`` against ``F.rms_norm``. Logs each
    one's median device time and min-max, and whether the kernel is at or
    under the library within the larger spread. -> {label: (kernel median
    us, library median us)}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cfg_combine as KC
    from repro_torch.kernels import rmsnorm as KR

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(16)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    pairs = []
    for shape, scales in (((1, *LATENT), [7.5]), ((DECODE_B, 128256),
                                                  [DECODE_SCALE, 1.0, 1.0, DECODE_SCALE])):
        u, c = rnd(*shape), rnd(*shape)
        s = torch.tensor(scales, device=dev)
        sv = s.view(-1, *([1] * (len(shape) - 1)))
        pairs.append((f"cfg_combine {shape} f32", lambda u=u, c=c: KC.cfg_combine(u, c, 7.5),
                      lambda u=u, c=c: torch.lerp(u, c, 7.5)))
        pairs.append((f"cfg_combine_rowscale {shape} f32",
                      lambda u=u, c=c, s=s: KC.cfg_combine_rowscale(u, c, s),
                      lambda u=u, c=c, sv=sv: torch.lerp(u, c, sv)))
    D = 2048
    sc = rnd(D, dtype=bf16)
    for n_rows, what in NORM_SHAPES:
        x = rnd(n_rows, D, dtype=bf16)
        pairs.append((f"rmsnorm {n_rows}x{D} bf16 ({what})",
                      lambda x=x: KR.rmsnorm(x, sc, 1e-5),
                      lambda x=x: F.rms_norm(x, (D,), sc, 1e-5)))
    out = {}
    for label, kern, lib in pairs:
        ts = {"k": [], "l": []}
        for _ in range(3):
            for who, fn in (("k", kern), ("l", lib), ("l", lib), ("k", kern)):
                ts[who].append(time_ms(fn)[0] * 1e3)
        (km, ks, k0, k1), (lm, ls, l0, l1) = _median_spread(ts["k"]), _median_spread(ts["l"])
        verdict = "at or under" if km <= lm + max(ks, ls) else "SLOWER than"
        log(f"[alt] {label}: kernel median {km:.3f} us (min-max {k0:.3f}-{k1:.3f}), library "
            f"median {lm:.3f} us ({l0:.3f}-{l1:.3f}); kernel {verdict} the library within "
            f"the larger spread {max(ks, ls):.3f} us; kernel/library {km / lm:.3f}")
        out[label] = (km, lm)
    return out


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


def _decode_pair(tag, cpu, gpu, toks, plan, kw, want, around_gpu=None) -> str:
    """The same ``guided_decode`` on the CPU (plain versions) and the GPU
    (kernels, inside the context ``around_gpu()`` if given): the GPU run's
    launch counts must equal ``want``, the teacher-forced logits agree
    within ``LOGIT_TOL`` of max|logit|, tokens equal up to each row's first
    step the logits do not decide. -> the log's summary."""
    import contextlib

    import torch
    from repro_torch.core import ar_decode as AR

    a, _ = AR.guided_decode(cpu, toks, plan, **kw)
    reset_launches()
    with (around_gpu or contextlib.nullcontext)():
        b, _ = AR.guided_decode(gpu, toks.cuda(), plan, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != want:
        fail(f"{tag}: launches {counts}, want {want}")
    la = AR.teacher_forced_logits(cpu, toks, plan, a, **kw)
    lb = AR.teacher_forced_logits(gpu, toks.cuda(), plan, a.cuda(), **kw).cpu()
    big = la.abs().max().item()
    err = (lb - la).abs()
    if not err.max().item() <= LOGIT_TOL * big:
        fail(f"{tag}: teacher-forced logits rel err {err.max().item() / big:.3g} > {LOGIT_TOL}")
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
            fail(f"{tag}: row {r} tokens differ before step {upto}: "
                 f"{a[r].tolist()} vs {b[r].tolist()}")
        compared += upto
    return (f"launches {want}; teacher-forced logits rel err {err.max().item() / big:.3g} "
            f"(tol {LOGIT_TOL}, max|logit| {big:.3g}); tokens equal on the {compared} of "
            f"{a.numel()} decided steps, {int((a == b.cpu()).sum())} equal overall")


def phase_decode_parity():
    """The same ``guided_decode`` on the CPU (plain versions) and the GPU
    (kernels): llama3.2-1b at full width, 2 layers, bf16 weights, B = 2,
    prompts of 64 tokens, 16 new tokens."""
    import dataclasses

    import torch
    from repro_torch.configs.llama3_2_1b import CONFIG
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
        summary = _decode_pair(f"dparity {mode}", cpu, gpu, toks, plan, dict(kw, combine=mode),
                               _expected_launches(cfg.num_layers, plan, kernel))
        log(f"[dparity] {mode}: {summary}")


RING_WINDOW, RING_PROMPT = 128, 160


def phase_ring_parity():
    """The ring path: h2o-danube-3-4b at full width (d_model 3840, hd 120),
    2 layers, its window cut to ``RING_WINDOW`` so that a prompt of
    ``RING_PROMPT`` tokens and the decode run on ring caches, B = 2, 16 new
    tokens, CPU against GPU as in the decode parity phase. Every decode
    forward's attention must take the ring path (counted), which on the GPU
    is the flash-decode kernel: one launch per layer and decode forward."""
    import contextlib
    import dataclasses

    import torch
    from repro_torch.configs.h2o_danube3_4b import CONFIG
    from repro_torch.core.selective import GuidancePlan
    from repro_torch.data.prompts import PAPER_PROMPTS
    from repro_torch.data.tokenizer import encode_batch
    from repro_torch.models import attention as A
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(CONFIG, num_layers=2, sliding_window=RING_WINDOW)
    t0 = time.perf_counter()
    cpu = Transformer.init(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                           device="cpu")
    gpu = Transformer.from_state_dict(cfg, {k: t.cuda() for k, t in cpu.state_dict().items()})
    prompts = [" ".join(PAPER_PROMPTS[i::2]) for i in range(2)]
    toks = torch.from_numpy(encode_batch(prompts, cfg.vocab_size, RING_PROMPT)).long()
    plan = GuidancePlan.suffix(16, 0.25, DECODE_SCALE)
    want = _expected_launches(cfg.num_layers, plan, "cfg_combine")
    ring_calls = [0]
    ring = A.attn_decode_ring

    def counted(*args, **kw):
        ring_calls[0] += 1
        return ring(*args, **kw)

    @contextlib.contextmanager
    def counting():
        A.attn_decode_ring = counted
        try:
            yield
        finally:
            A.attn_decode_ring = ring
    summary = _decode_pair("ring parity", cpu, gpu, toks, plan, dict(combine="cfg"), want,
                           counting)
    if ring_calls[0] != want["decode_attention"]:
        fail(f"ring parity: {ring_calls[0]} ring-cache decode calls on the GPU, want "
             f"{want['decode_attention']} (layers x decode forwards)")
    log(f"[ring] {cfg.name} x{cfg.num_layers} layers, window {RING_WINDOW}, B=2 S={RING_PROMPT}, "
        f"16 new tokens, the ring path: attn_decode_ring {ring_calls[0]} times in the GPU run, "
        f"each one decode_attention launch; set-up {time.perf_counter() - t0:.2f} s; {summary}")


def _decode_model():
    """-> (llama3.2-1b at full width and depth, random bf16 weights from seed
    0; ``DECODE_B`` prompts of ``DECODE_S`` random ids from seed 0)."""
    import numpy as np
    import torch
    from repro_torch.configs.llama3_2_1b import CONFIG as cfg
    from repro_torch.models.transformer import Transformer

    model = Transformer.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                             dtype=torch.bfloat16)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (DECODE_B, DECODE_S))).long().cuda()
    torch.cuda.synchronize()
    return model, toks


def _decode_steps(model, toks, pos: int, combine_fn=None):
    """-> (FULL step, COND step) at ``pos`` as callables, on caches of
    capacity ``DECODE_S + DECODE_NEW`` prefilled from ``toks`` and the null
    prompt; the FULL step combines with ``combine_fn(l_u, l_c)`` if given,
    else Eq. 1. Call under ``torch.no_grad()``."""
    from repro_torch.core import ar_decode as AR

    cap = DECODE_S + DECODE_NEW
    _, cc = AR.prefill(model, toks)
    _, cu = AR.prefill(model, AR.null_prompt(toks))
    cc = model.prepare_decode_caches(cc, seq_len=DECODE_S, capacity=cap)
    cu = model.prepare_decode_caches(cu, seq_len=DECODE_S, capacity=cap)
    tok = toks[:, -1]
    return (lambda: AR.decode_step_full(model, tok, cc, cu, pos, DECODE_SCALE,
                                        combine_fn=combine_fn),
            lambda: AR.decode_step_cond(model, tok, cc, pos))


def _apg_fn():
    """``guided_decode``'s APG combine (``combine="apg"``, eta 0.3) as the
    FULL step's ``combine_fn``: one B2 launch a step."""
    from repro_torch.core.guidance import apg_combine
    return lambda l_u, l_c: apg_combine(l_u, l_c, DECODE_SCALE, eta=0.3)


def phase_decode_main():
    """``guided_decode`` on llama3.2-1b at full width and depth. -> (model,
    prompts, launches of the counted f = 0.2 runs, seconds per generate by f)."""
    import numpy as np
    import torch
    from repro_torch.configs.llama3_2_1b import CONFIG as cfg
    from repro_torch.core import ar_decode as AR
    from repro_torch.core.selective import GuidancePlan

    t0 = time.perf_counter()
    model, toks = _decode_model()
    n_params = sum(p.numel() for p in model.parameters())
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
        with _NormCensus() as census:
            out, dt = run(plan, combine=mode, **kw)
        counts, want = launch_counts(), _expected_launches(cfg.num_layers, plan, kernel)
        if sum(census.by_shape.values()) != counts["rmsnorm"]:
            fail(f"dmain combine={mode}: rmsnorm census {census.by_shape} against "
                 f"{counts['rmsnorm']} launches")
        if mode == "cfg":
            log(f"[dmain] rmsnorm launches by rows x dim, one generate f=0.2: "
                f"{census.summary()}")
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

    null = AR.null_prompt(toks)
    pos = DECODE_S + DECODE_NEW // 2
    with torch.no_grad():
        prefills = lambda: (AR.prefill(model, toks), AR.prefill(model, null))  # noqa: E731
        pre_dev, pre_wall = _graph_ms(prefills, iters=3), _wall_ms(prefills, iters=3)
        full, cond = _decode_steps(model, toks, pos)
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

def _profile_share(by_name: dict, key: str) -> tuple[int, int]:
    """(ns, launches) summed over the profiled kernels whose name holds ``key``."""
    hits = [v for name, v in by_name.items() if key in name]
    return sum(t for t, _ in hits), sum(k for _, k in hits)


def phase_decode_profile(model, toks, combine_fn=None, what: str = "FULL") -> None:
    """The kernels that take a FULL decode step's device time under
    ``torch.profiler`` (combining with ``combine_fn`` if given, ``what``
    naming it): summed device time by kernel, its share of the step's
    kernel time, and launches per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        step, _ = _decode_steps(model, toks, DECODE_S, combine_fn)
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
    log(f"[dprofile] one {what} step at pos {DECODE_S}: {n} kernel launches, "
        f"{total / 1e6:.3f} ms of kernel time (profiled)")
    for rank, (name, (t, k)) in enumerate(sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]):
        log(f"[dprofile] {rank + 1}. {t / total:.3f} of kernel time, {k}x {name[:90]}")
    for label, key in (("B6 rmsnorm", "rmsnorm_kernel"), ("B1 cfg_combine", "combine_kernel"),
                       ("B2 apg_combine", "apg_")):
        t, k = _profile_share(by_name, key)
        if k:
            log(f"[dprofile] {what}: {label}: {t / total:.4f} of the step's kernel time, {k} "
                f"launches, {t / max(k, 1) / 1e3:.2f} us each (profiled)")

# -- the paged serve path (llama3.2-1b) ------------------------------------------

SERVE_R, SERVE_PS, SERVE_PAGES, SERVE_NB = 16, 16, 640, 40     # the serve main path
SERVE_LENS = (128, 256, 384, 512)
SERVE_NEW, SERVE_SCALE = 128, 3.0
PAGED = ("ragged_paged_decode_attention", "ragged_paged_decode_attention_int8",
         "paged_decode_attention", "paged_decode_attention_int8")


def _paged_case(gen, dtype, int8: bool, H: int = 32, K: int = 8, hd: int = 64):
    """Inputs of the paged kernels at the serve path's shapes: positions
    spread over the tables' 640 keys, every fourth row at phase 0, each
    row's live pages distinct pool pages (a few past the pool, which the
    kernels clamp to its last page), the rest of its table past the pool."""
    import torch
    dev = gen.device
    R, ps, P, nb = SERVE_R, SERVE_PS, SERVE_PAGES, SERVE_NB
    pos = torch.linspace(0, nb * ps - 1, R, device=dev).round().int()
    phase = (torch.arange(R, device=dev) % 4 != 0).int()
    bt = torch.full((R, nb), P + 3, dtype=torch.int32, device=dev)
    perm = torch.randperm(P, generator=gen, device=dev).int()
    for r in range(R):
        live = int(pos[r]) // ps + 1
        bt[r, :live] = perm[(r * 37) % (P - live):][:live]
        if r % 3 == 1:
            bt[r, live // 2] = P + r                   # out of range inside the span
    q = torch.randn(R, H, hd, generator=gen, device=dev).to(dtype)
    shape = (P, ps, K, hd)
    if int8:
        pages = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
                 for _ in range(2)]
        scales = [torch.rand(shape[:3] + (1,), generator=gen, device=dev) * 0.05 + 1e-3
                  for _ in range(2)]
        kv = (pages[0], scales[0], pages[1], scales[1])
    else:
        kv = tuple(torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(2))
    return q, kv, bt, pos, phase


def _paged_call(mod, name, q, kv, bt, pos, phase, **kw):
    fn = getattr(mod, name)
    if name.startswith("ragged"):
        return lambda: fn(q, *kv, bt, pos, phase, **kw)
    return lambda: fn(q, *kv, bt, pos, **kw)


def _paged_plain(mod, name, q, kv, bt, pos, phase, **kw):
    """The plain version on the same inputs. For int8 pages it runs on q's
    values in float32 and rounds the result to q's dtype once, as the int8
    kernels compute (the TPU kernels and ``ref.py``'s int8 oracle do too);
    with a bf16 q the plain version itself would dequantize into bf16 and
    round the scores and weights, as the reference's jnp path does."""
    ph = phase if name.startswith("ragged") else None
    if name.endswith("int8"):
        k, ks, v, vs = kv
        return lambda: mod.paged_attention_plain(q.float(), k, v, bt, pos, phase=ph,
                                                 k_scales=ks, v_scales=vs, **kw).to(q.dtype)
    k, v = kv
    return lambda: mod.paged_attention_plain(q, k, v, bt, pos, phase=ph, **kw)


def _paged_bytes(name, q, kv, pos, phase, ps: int, window=None) -> tuple[int, int]:
    """(bytes, flops) the call must move and do. Each live row reads the K
    and V rows of its keys [lo, pos] (lo the window's first key), and their
    scales for int8, its q, its position and the table entries of the pages
    those keys lie on; every row writes its out, and the ragged forms read
    every row's phase. QK and PV take 2 flops a key, head and head dim."""
    import torch
    R, H, hd = q.shape
    K = kv[0].shape[2]
    ragged = name.startswith("ragged")
    live = phase.bool() if ragged else torch.ones_like(pos, dtype=torch.bool)
    hi = pos.long().clamp(max=SERVE_NB * ps - 1)
    lo = (pos.long() - window + 1).clamp(min=0) if window else torch.zeros_like(hi)
    span = hi >= lo
    keys = int((hi - lo + 1)[live & span].sum())
    entries = int((hi // ps - lo // ps + 1)[live & span].sum())
    n_live = int(live.sum())
    per_key = 2 * K * hd * kv[0].element_size() + (2 * K * 4 if name.endswith("int8") else 0)
    nbytes = (keys * per_key + (n_live + R) * H * hd * q.element_size()
              + (n_live + entries + (R if ragged else 0)) * 4)
    return nbytes, 4 * H * hd * keys


def phase_paged_kernels():
    """B7-B10 against their plain version at the serve path's shapes. ->
    {name: row} for the JSON line: bf16 (B7, B9) and int8 pages with bf16 q
    (B8, B10), no window."""
    import torch
    from repro_torch.kernels import paged_decode_attention as KP

    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(11)
    errs, worst, rows = {n: 0.0 for n in PAGED}, {}, {}
    for dtype in (bf16, f32):
        for int8 in (False, True):
            q, kv, bt, pos, phase = _paged_case(gen, dtype, int8)
            names = [n for n in PAGED if n.endswith("int8") == int8]
            for name in names:
                for window in (None, 64, 200):
                    tag = f"{str(dtype)[6:]} window={window}"
                    out = _paged_call(KP, name, q, kv, bt, pos, phase, window=window)()
                    ref = _paged_plain(KP, name, q, kv, bt, pos, phase, window=window)()
                    tol = ATTN_BF16_STEPS * BF16_STEP if dtype == bf16 else 1e-5
                    e = _err_ok(name, tag, out, ref, per_row=tol)
                    errs[name] = max(errs[name], e[0])
                    worst[name, dtype] = max(worst.get((name, dtype), 0.0), e[1])
                    if name.startswith("ragged"):
                        dead = out[phase == 0]
                        if not torch.equal(dead, torch.zeros_like(dead)):
                            fail(f"{name} {tag}: phase-0 rows are not exact zeros")
                    # the kernel has no sub-page tile: every block_k gives these bits
                    for bk in KP.block_k_candidates(SERVE_PS)[1:]:
                        got = _paged_call(KP, name, q, kv, bt, pos, phase, window=window,
                                          block_k=bk)()
                        if not torch.equal(got, out):
                            fail(f"{name} {tag}: block_k={bk} differs from whole pages")
            plans = [tuple(KP.paged_split_plan(SERVE_NB, SERVE_PS, w, 4, 64, int8, dtype))
                     for w in (None, 64, 200)]
            log(f"[paged] {', '.join(names)} {str(dtype)[6:]} q: R={SERVE_R} H=32 K=8 hd=64 "
                f"pages {SERVE_PAGES}x{SERVE_PS}, tables of {SERVE_NB} with out-of-range "
                f"entries, window None/64/200 (split plans {plans} as (tile, cluster, tiles "
                f"a block, stages, smem bytes)): within tolerance; phase-0 rows exact zeros; "
                f"block_k {KP.block_k_candidates(SERVE_PS)} bit-identical")
    # the other dense decoders' head groups take other instantiations
    for H, K, hd in ((40, 8, 128), (32, 4, 128), (32, 8, 120)):
        for int8 in (False, True):
            q, kv, bt, pos, phase = _paged_case(gen, bf16, int8, H, K, hd)
            for name in [n for n in PAGED if n.endswith("int8") == int8]:
                tag = f"bf16 H={H} K={K} hd={hd}"
                out = _paged_call(KP, name, q, kv, bt, pos, phase)()
                ref = _paged_plain(KP, name, q, kv, bt, pos, phase)()
                e = _err_ok(name, tag, out, ref, per_row=ATTN_BF16_STEPS * BF16_STEP)
                worst[name, bf16] = max(worst[name, bf16], e[1])
    log("[paged] all four at H/K/hd 40/8/128, 32/4/128, 32/8/120 (bf16 q): within tolerance")
    for (name, dtype), w in sorted(worst.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        log(f"[paged] {name} {str(dtype)[6:]}: largest error over the sweep {w:.3g} of its "
            f"row's max|out| ({w / BF16_STEP:.2f} bf16 steps)")

    for int8 in (False, True):
        q, kv, bt, pos, phase = _paged_case(gen, bf16, int8)
        for name in [n for n in PAGED if n.endswith("int8") == int8]:
            kern = _paged_call(KP, name, q, kv, bt, pos, phase)
            plain = _paged_plain(KP, name, q, kv, bt, pos, phase)
            (ms, host_ms), (plain_ms, _) = time_ms(kern), time_ms(plain, iters=20)
            nbytes, flops = _paged_bytes(name, q, kv, pos, phase, SERVE_PS)
            b_ms, b_by = bound_ms(nbytes, flops, H100_BF16_FLOPS)
            log(f"[paged] {name} R={SERVE_R} pos 0..{SERVE_NB * SERVE_PS - 1} "
                f"{'int8 pages, bf16 q' if int8 else 'bf16'}: device time kernel "
                f"{ms * 1e3:.2f} us (host {host_ms * 1e3:.2f} us/call), plain "
                f"{plain_ms * 1e3:.2f} us, library none, bound {b_ms * 1e3:.3f} us ({b_by}: "
                f"{nbytes} B, {flops} flop)")
            rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                              bound_by=b_by, max_abs_err=errs[name])
    return rows


def phase_paged_identity() -> None:
    """B9 is B7 without a phase and B8 is B10 with one: with every row at
    phase 1, the same kernel on the same inputs must give the same bits,
    for a bf16 and a float32 q, after each pair is held to the plain
    version."""
    import torch
    from repro_torch.kernels import paged_decode_attention as KP

    gen = torch.Generator(device="cuda").manual_seed(12)
    for dtype in (torch.bfloat16, torch.float32):
        tol = ATTN_BF16_STEPS * BF16_STEP if dtype == torch.bfloat16 else 1e-5
        for int8, a, b in ((False, "paged_decode_attention", "ragged_paged_decode_attention"),
                           (True, "ragged_paged_decode_attention_int8",
                            "paged_decode_attention_int8")):
            q, kv, bt, pos, _ = _paged_case(gen, dtype, int8)
            live = torch.ones_like(pos)
            outs = [_paged_call(KP, n, q, kv, bt, pos, live)() for n in (a, b)]
            ref = _paged_plain(KP, a, q, kv, bt, pos, live)()
            for n, out in zip((a, b), outs):
                _err_ok(n, f"{str(dtype)[6:]} q, every row live", out, ref, per_row=tol)
            if not torch.equal(outs[0], outs[1]):
                fail(f"{a} and {b} differ with every row at phase 1 ({str(dtype)[6:]} q)")
            log(f"[pident] {a} equals {b} bit for bit (R={SERVE_R}, every row at phase 1, "
                f"{'int8' if int8 else str(dtype)[6:]} pages, {str(dtype)[6:]} q)")


def _serve_requests(cfg, n: int, lens, new: int, seed: int):
    import numpy as np
    from repro_torch.serve import ServeRequest
    rng = np.random.default_rng(seed)
    return [ServeRequest(uid=f"q{i}", prompt=rng.integers(4, cfg.vocab_size, lens[i % len(lens)])
                         .tolist(), max_new_tokens=new, guidance_scale=SERVE_SCALE,
                         temperature=0.0, prompt_len=lens[i % len(lens)]) for i in range(n)]


def _recording_engine():
    """``ContinuousEngine`` keeping the logits each request's tokens came
    from (host float32 copies: a parity run only)."""
    from repro_torch.serve import ContinuousEngine

    class Recording(ContinuousEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.logits = {}

        def _sample(self, logits, uids, temps, keys, steps):
            host = logits[:len(uids)].float().cpu()
            for i, uid in enumerate(uids):
                self.logits.setdefault(uid, []).append(host[i])
            return super()._sample(logits, uids, temps, keys, steps)

    return Recording


def _decode_forwards(metrics, step_mode: str) -> int:
    """Decode forwards of a run's steps: one per ragged step; per signature
    step two for a FULL group and one for a COND group."""
    if step_mode == "ragged":
        return metrics.step_launches
    return sum(2 * (r.n_full > 0) + (r.n_cond > 0) for r in metrics.records
               if r.n_full + r.n_cond)


def _paged_kernel_of(step_mode: str, kv_dtype: str) -> str:
    return ("ragged_" if step_mode == "ragged" else "") + "paged_decode_attention" + \
        ("_int8" if kv_dtype == "int8" else "")


def phase_serve_parity():
    """The same trace through the engine on the CPU (plain versions) and the
    GPU (kernels): llama3.2-1b at full width, 2 layers, bf16 weights."""
    import dataclasses

    import torch
    from repro_torch.configs.llama3_2_1b import CONFIG
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(CONFIG, num_layers=2)
    cpu = Transformer.init(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                           device="cpu")
    gpu = Transformer.from_state_dict(cfg, {k: t.cuda() for k, t in cpu.state_dict().items()})
    Recording = _recording_engine()
    lens, new = (24, 40, 17, 33), 12
    arrivals = [0, 0, 1, 1, 2, 3]
    kw = dict(kv="paged", page_size=16, num_slots=4, pass_budget=6, prompt_len=48,
              max_new=new, stop_on_eos=False, prefills_per_tick=2, seed=0,
              selective_fraction=0.5)
    cases = [(s, d, {}) for s in ("ragged", "signature") for d in ("bf16", "int8")]
    cases += [("ragged", "bf16", dict(combine="apg", apg_eta=0.3)),
              ("ragged", "bf16", dict(combine="interval", interval=(0.25, 0.75)))]
    for step_mode, kv_dtype, comb in cases:
        runs = {}
        for side, model in (("cpu", cpu), ("gpu", gpu)):
            reqs = _serve_requests(cfg, len(arrivals), lens, new, seed=7)
            eng = Recording(model, cfg, step_mode=step_mode, kv_dtype=kv_dtype, **comb,
                            **kw)
            reset_launches()
            out = eng.serve_trace(reqs, arrivals)
            torch.cuda.synchronize()
            runs[side] = (eng, out, launch_counts())
        (ce, co, cl), (ge, go, gl) = runs["cpu"], runs["gpu"]
        tag = f"step_mode={step_mode} kv_dtype={kv_dtype} combine={eng.combine}"
        kern = _paged_kernel_of(step_mode, kv_dtype)
        want = cfg.num_layers * _decode_forwards(ge.metrics, step_mode)
        if ce.metrics.trace.keys() != ge.metrics.trace.keys():
            fail(f"sparity {tag}: event streams differ")
        comb_kern, other = ("apg_combine", "cfg_combine_rowscale") if ge.combine == "apg" \
            else ("cfg_combine_rowscale", "apg_combine")
        if sum(cl.values()) != 0 or gl[kern] != want or not gl[comb_kern] or gl[other]:
            fail(f"sparity {tag}: launches CPU {cl}, GPU {gl}; want {kern} x{want} and "
                 f"{comb_kern} alone of the combines")
        compared = total = 0
        worst = 0.0
        for uid in co:
            a, b = co[uid], go[uid]
            n = min(len(a), len(b))
            mis = next((i for i in range(n) if a[i] != b[i]), n)
            upto = min(mis + 1, n)
            la = torch.stack(ce.logits[uid][:upto])
            lb = torch.stack(ge.logits[uid][:upto])
            big = la.abs().max().item()
            err = (lb - la).abs()
            worst = max(worst, err.max().item() / big)
            if not err.max().item() <= SERVE_LOGIT_TOL * big:
                fail(f"sparity {tag} {uid}: logits rel err {err.max().item() / big:.3g} "
                     f"> {SERVE_LOGIT_TOL}")
            top = la.argmax(-1, keepdim=True)
            gap = la.gather(-1, top) - la
            slack = err.gather(-1, top) + err
            undecided = ((gap <= slack) & (torch.arange(la.shape[-1]) != top)).any(-1)
            if mis < n and not bool(undecided[mis]):
                fail(f"sparity {tag} {uid}: tokens part at decided step {mis}: {a} vs {b}")
            compared += mis
            total += n
        log(f"[sparity] {tag}: {len(co)} requests, {ge.tick_count} ticks, events equal "
            f"({len(ge.metrics.trace.keys())}), {kern} x{gl[kern]} "
            f"(= {cfg.num_layers} layers x decode forwards); logits rel err {worst:.3g} "
            f"(tol {SERVE_LOGIT_TOL}); tokens equal on {compared} of {total} before any "
            f"undecided parting")


SERVE_LOGIT_TOL = 3e-2   # CPU vs GPU serve logits, of max|logit| (bf16 stacks, int8 pools)


def phase_serve_main():
    """``ContinuousEngine`` on llama3.2-1b at full width and depth. -> (model,
    launches per kernel summed over the counted runs, rows)."""
    import numpy as np
    import torch
    from repro_torch.configs.llama3_2_1b import CONFIG as cfg
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import ContinuousEngine

    t0 = time.perf_counter()
    model = Transformer.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                             dtype=torch.bfloat16)
    torch.cuda.synchronize()
    arrivals = [i // 2 for i in range(16)]
    log(f"[smain] {cfg.name}: {cfg.num_layers} layers, bf16, init "
        f"{time.perf_counter() - t0:.2f} s; 16 requests, prompts {SERVE_LENS} cycling, "
        f"{SERVE_NEW} new tokens, scale {SERVE_SCALE}, greedy, two arriving at each of "
        f"ticks 0-7; pages of {SERVE_PS}, 8 slots, pass budget 16")
    runs = [("ragged", "bf16", 0.0), ("ragged", "bf16", 0.2), ("ragged", "bf16", 0.5),
            ("ragged", "int8", 0.2), ("signature", "bf16", 0.2), ("signature", "int8", 0.2)]
    totals, rows = {}, []
    census = _NormCensus()
    for step_mode, kv_dtype, f in runs:
        def engine():
            return ContinuousEngine(model, cfg, kv="paged", page_size=SERVE_PS, num_slots=8,
                                    pass_budget=16, prompt_len=512, max_new=SERVE_NEW,
                                    stop_on_eos=False, prefills_per_tick=2, seed=0,
                                    selective_fraction=f, step_mode=step_mode,
                                    kv_dtype=kv_dtype)
        engine().serve_trace(_serve_requests(cfg, 16, SERVE_LENS, SERVE_NEW, 0), arrivals)
        eng = engine()
        reqs = _serve_requests(cfg, 16, SERVE_LENS, SERVE_NEW, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t1 = time.perf_counter()
        with census:
            out = eng.serve_trace(reqs, arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = launch_counts()
        m = eng.metrics
        tokens = sum(len(v) for v in out.values())
        if len(out) != 16 or any(len(v) != SERVE_NEW for v in out.values()) or not all(
                0 <= t < cfg.vocab_size for v in out.values() for t in v):
            fail(f"smain {step_mode} {kv_dtype} f={f}: results {len(out)} requests, lengths "
                 f"{sorted({len(v) for v in out.values()})}")
        if eng.pages.n_free != eng.pages.num_pages:
            fail(f"smain {step_mode} {kv_dtype} f={f}: pool not balanced at drain")
        kern = _paged_kernel_of(step_mode, kv_dtype)
        want = cfg.num_layers * _decode_forwards(m, step_mode)
        others = sum(counts[n] for n in PAGED if n != kern)
        if counts[kern] != want or others:
            fail(f"smain {step_mode} {kv_dtype} f={f}: {kern} x{counts[kern]}, want {want} "
                 f"(= {cfg.num_layers} layers x decode forwards); other paged kernels x{others}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated() / 1e9
        row = dict(step_mode=step_mode, kv_dtype=kv_dtype, f=f, wall_s=wall,
                   tokens_per_s=tokens / wall, ticks=m.ticks, passes=m.denoiser_passes,
                   prefill_passes=m.prefill_passes, reclaimed=m.pages_reclaimed,
                   peak_pages=m.peak_pages_in_use, peak_bytes=m.peak_bytes_in_use,
                   step_launches=m.step_launches, peak_gb=peak)
        rows.append(row)
        log(f"[smain] {step_mode} {kv_dtype} f={f}: wall {wall:.4f} s, {tokens / wall:.1f} "
            f"tokens/s, ticks {m.ticks}, denoiser passes {m.denoiser_passes}, prefill passes "
            f"{m.prefill_passes}, pages reclaimed {m.pages_reclaimed}, peak pages "
            f"{m.peak_pages_in_use}, peak bytes {m.peak_bytes_in_use}, step launches "
            f"{m.step_launches} (compiles {m.step_compiles}), launches "
            f"{ {k: v for k, v in counts.items() if v} }, peak device memory {peak:.2f} GB; "
            f"first tokens {out['q0'][:6]}")
    if sum(census.by_shape.values()) != totals["rmsnorm"]:
        fail(f"smain: rmsnorm census {census.by_shape} against {totals['rmsnorm']} launches")
    log(f"[smain] rmsnorm launches by rows x dim over the six runs: {census.summary()}")
    return model, totals, rows


def phase_serve_profile(model, step_mode: str = "ragged", kv_dtype: str = "bf16") -> None:
    """Where a steady serve tick's time goes (f = 0.2, ticks 20-49, eight
    requests in flight and no admissions; the ragged bf16 step by default):
    the wall and its phases from the engine's tick timer over ticks 20-39,
    then the kernels' device time over ticks 40-49 under ``torch.profiler``,
    and the busy share, device time over wall; B6's share and the paged
    kernel's."""
    import torch
    from repro_torch.configs.llama3_2_1b import CONFIG as cfg
    from repro_torch.serve import ContinuousEngine
    from torch.profiler import ProfilerActivity, profile

    eng = ContinuousEngine(model, cfg, kv="paged", page_size=SERVE_PS, num_slots=8,
                           pass_budget=16, prompt_len=512, max_new=SERVE_NEW, stop_on_eos=False,
                           prefills_per_tick=2, seed=0, selective_fraction=0.2,
                           step_mode=step_mode, kv_dtype=kv_dtype)
    reqs = _serve_requests(cfg, 16, SERVE_LENS, SERVE_NEW, 0)
    arrivals = [i // 2 for i in range(16)]
    i = 0
    while eng.tick_count < 40:
        while i < len(reqs) and arrivals[i] <= eng.tick_count:
            eng.submit(reqs[i])
            i += 1
        eng.tick()
    torch.cuda.synchronize()
    steady = eng.metrics.tick_timings[20:40]
    wall = sum(t.duration_s for t in steady) / len(steady)
    seg = {}
    for t in steady:
        for name, s in t.segment_s().items():
            seg[name] = seg.get(name, 0.0) + s / len(steady)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            eng.tick()
        torch.cuda.synchronize()
    by_name, n = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            t_, k = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (t_ + e.end_ns() - e.start_ns(), k + 1)
            n += 1
    total = sum(t_ for t_, _ in by_name.values())
    log(f"[sprofile] steady {step_mode} tick ({kv_dtype}, f=0.2, 8 requests in flight): wall "
        f"{wall * 1e3:.3f} ms, of which " + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in seg.items()))
    if not total:
        log("[sprofile] device time not measured: the profiler saw no device time")
        return
    dev_ms = total / 1e6 / 10
    log(f"[sprofile] {n / 10:.0f} kernel launches and {dev_ms:.3f} ms of kernel time per tick "
        f"(profiled); device-busy share of the unprofiled wall {dev_ms / (wall * 1e3):.4f}")
    for rank, (name, (t_, k)) in enumerate(sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]):
        log(f"[sprofile] {rank + 1}. {t_ / total:.3f} of kernel time, {k / 10:.0f}x per tick "
            f"{name[:80]}")
    paged = {"ragged": {"bf16": "B7", "int8": "B8"},
             "signature": {"bf16": "B9", "int8": "B10"}}[step_mode][kv_dtype]
    for label, key in (("B6 rmsnorm", "rmsnorm_kernel"),
                       (f"{paged} {_paged_kernel_of(step_mode, kv_dtype)}", "paged_")):
        t_, k = _profile_share(by_name, key)
        if k:
            log(f"[sprofile] {label}: {t_ / total:.4f} of a tick's kernel time, {k / 10:.0f} "
                f"launches a tick, {t_ / max(k, 1) / 1e3:.2f} us each (profiled)")


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
    phase_latency_sweeps()
    phase_alternation()
    phase_decode_parity()
    phase_ring_parity()
    model, toks, ar_launches, ar_rows = phase_decode_main()
    phase_decode_breakdown(model, toks, ar_rows)
    phase_decode_profile(model, toks)
    phase_decode_profile(model, toks, _apg_fn(), "APG FULL")
    del model
    torch.cuda.empty_cache()

    rows.update(phase_paged_kernels())
    phase_paged_identity()
    phase_serve_parity()
    model, serve_launches, _ = phase_serve_main()
    phase_serve_profile(model)

    cu = "src/repro_torch/csrc/"
    kernels = {
        "cfg_combine": ("cfg_combine.cu", "src/repro/kernels/cfg_combine.py:52"),
        "cfg_combine_rowscale": ("cfg_combine.cu", "src/repro/kernels/cfg_combine.py:171"),
        "apg_combine": ("cfg_combine.cu", "src/repro/kernels/cfg_combine.py:136"),
        "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:69"),
        "decode_attention": ("decode_attention.cu", "src/repro/kernels/decode_attention.py:63"),
        "rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:24"),
        "ragged_paged_decode_attention": (
            "paged_decode_attention.cu", "src/repro/kernels/paged_decode_attention.py:276"),
        "ragged_paged_decode_attention_int8": (
            "paged_decode_attention.cu", "src/repro/kernels/paged_decode_attention.py:344"),
        "paged_decode_attention": (
            "paged_decode_attention.cu", "src/repro/kernels/paged_decode_attention.py:161"),
        "paged_decode_attention_int8": (
            "paged_decode_attention.cu", "src/repro/kernels/paged_decode_attention.py:214"),
    }
    out = []
    for name, (src, replaces) in kernels.items():
        sd, ar = sd_launches.get(name, 0), ar_launches.get(name, 0)
        sv = serve_launches.get(name, 0)
        if sd + ar + sv == 0:
            fail(f"{name}: launched no time on the main paths")
        log(f"[launches] {name}: {sd} in the SD generate's run, {ar} in guided_decode's, "
            f"{sv} in the serve runs'")
        r = {k: v for k, v in rows[name].items() if k != "host_us"}
        out.append(dict(name=name, route="cuda", source=cu + src, replaces=replaces,
                        launches=sd + ar + sv, **r))
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def decode_steps_main(src: str) -> None:
    """``python3 chip_smoke.py --decode-steps [SRC]``: the FULL, COND and
    APG FULL (``combine="apg"``) decode steps' device time (three CUDA-graph
    replays each, at the position ``[dbreak]`` uses) and a FULL and an APG
    FULL step under ``torch.profiler`` (``[dprofile]``), for the
    ``repro_torch`` package under SRC (this checkout's ``src`` by default).
    Two trees compare on one card when one call runs this for each in turns
    (parent, change, change, parent)."""
    sys.path.insert(0, os.path.abspath(src))
    phase_device()
    import torch

    import repro_torch
    model, toks = _decode_model()
    with torch.no_grad():
        full, cond = _decode_steps(model, toks, DECODE_S + DECODE_NEW // 2)
        full_apg, _ = _decode_steps(model, toks, DECODE_S + DECODE_NEW // 2, _apg_fn())
        f = [_graph_ms(full) for _ in range(3)]
        c = [_graph_ms(cond) for _ in range(3)]
        a = [_graph_ms(full_apg) for _ in range(3)]
    log(f"[steps] {os.path.dirname(repro_torch.__file__)}: FULL step device ms "
        f"{', '.join(f'{t:.3f}' for t in f)}; COND {', '.join(f'{t:.3f}' for t in c)}; "
        f"APG FULL {', '.join(f'{t:.3f}' for t in a)}")
    phase_decode_profile(model, toks)
    phase_decode_profile(model, toks, _apg_fn(), "APG FULL")


def serve_steps_main(src: str) -> None:
    """``python3 chip_smoke.py --serve-steps [SRC]``: a steady serve tick
    (``[sprofile]``) on llama3.2-1b at full width and depth, for each
    (step mode, pool dtype) pair: ragged bf16 (B7), ragged int8 (B8),
    signature bf16 (B9) and signature int8 (B10), on the ``repro_torch``
    package under SRC (this checkout's ``src`` by default). Two trees
    compare on one card when one call runs this for each in turns (parent,
    change, change, parent)."""
    sys.path.insert(0, os.path.abspath(src))
    phase_device()
    import torch

    import repro_torch
    from repro_torch.configs.llama3_2_1b import CONFIG as cfg
    from repro_torch.models.transformer import Transformer

    log(f"[steps] {os.path.dirname(repro_torch.__file__)}")
    model = Transformer.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                             dtype=torch.bfloat16)
    for step_mode in ("ragged", "signature"):
        for kv_dtype in ("bf16", "int8"):
            phase_serve_profile(model, step_mode, kv_dtype)


def paged_kernels_main(src: str) -> None:
    """``python3 chip_smoke.py --paged-kernels [SRC]``: the four paged
    kernels at the serve shape with a bf16 q, each held to its plain version
    and then event-timed as ``[paged]`` times them, three times, and B9 and
    B10 at the signature step's 1, 2, 4 and 8 rows, for the
    ``repro_torch`` package under SRC (this checkout's ``src`` by default).
    Two trees compare on one card when one call runs this for each in turns
    (parent, change, change, parent)."""
    sys.path.insert(0, os.path.abspath(src))
    phase_device()
    import torch

    import repro_torch
    from repro_torch.kernels import paged_decode_attention as KP

    where = os.path.dirname(repro_torch.__file__)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for int8 in (False, True):
        q, kv, bt, pos, phase = _paged_case(gen, torch.bfloat16, int8)
        for name in [n for n in PAGED if n.endswith("int8") == int8]:
            kern = _paged_call(KP, name, q, kv, bt, pos, phase)
            _err_ok(name, "timed inputs", kern(), _paged_plain(KP, name, q, kv, bt, pos, phase)(),
                    per_row=ATTN_BF16_STEPS * BF16_STEP)
            ts = [time_ms(kern)[0] * 1e3 for _ in range(3)]
            log(f"[pkern] {where}: {name} (R={SERVE_R}, pos 0..{SERVE_NB * SERVE_PS - 1}, "
                f"{'int8' if int8 else 'bf16'} pages, bf16 q) device us "
                f"{', '.join(f'{t:.3f}' for t in ts)}")
        # the signature step's few-row launches (a FULL or COND group of 1-8
        # rows), rows spread over the positions up to the longest
        name = "paged_decode_attention" + ("_int8" if int8 else "")
        for R in (1, 2, 4, 8):
            rows = torch.arange(R, device=q.device) * (SERVE_R // R) + SERVE_R // R - 1
            kern = _paged_call(KP, name, q[rows].contiguous(), kv, bt[rows].contiguous(),
                               pos[rows].contiguous(), None)
            log(f"[pkern] {where}: {name} at R={R} (positions {pos[rows].tolist()}) device "
                f"us {time_ms(kern)[0] * 1e3:.3f}")


def apg_kernels_main(src: str) -> None:
    """``python3 chip_smoke.py --apg-kernels [SRC]``: B2 at its four timed
    shapes, float32, eta 0.3, threshold 1.0: the SD latent (1, 64, 64, 4)
    with one scale, the decode logits (4, 128256) with one scale and with
    per-row scales, and the serve engine's (16, 128256) with per-row
    scales; each held to its plain version (``apg_within``) and then
    event-timed three times, beside its bytes bound, for the ``repro_torch``
    package under SRC (this checkout's ``src`` by default). Two trees
    compare on one card when one call runs this for each in turns (parent,
    change, change, parent)."""
    sys.path.insert(0, os.path.abspath(src))
    phase_device()
    import torch

    import repro_torch
    from repro_torch.kernels import cfg_combine as KC

    where = os.path.dirname(repro_torch.__file__)
    gen = torch.Generator(device="cuda").manual_seed(18)
    for shape, per_row in (((1, *LATENT), False), ((DECODE_B, 128256), False),
                           ((DECODE_B, 128256), True), ((SERVE_R, 128256), True)):
        u = torch.randn(shape, generator=gen, device="cuda")
        c = torch.randn(shape, generator=gen, device="cuda")
        scale = torch.linspace(1.0, 7.5, shape[0], device="cuda") if per_row else 7.5
        kern = lambda: KC.apg_combine(u, c, scale, eta=0.3, threshold=1.0)  # noqa: E731
        ok, e = apg_within(kern(), KC.apg_combine_plain(u, c, scale, eta=0.3, threshold=1.0))
        if not ok:
            fail(f"apg_combine {shape}: max abs err {e:.3g}")
        ts = [time_ms(kern)[0] * 1e3 for _ in range(3)]
        n = u.numel()
        b_ms, b_by = bound_ms(12 * n + (4 * shape[0] if per_row else 0), 16 * n)
        log(f"[apgkern] {where}: apg_combine {shape} f32 "
            f"{'per-row scales' if per_row else 'one scale'} device us "
            f"{', '.join(f'{t:.3f}' for t in ts)}; bound {b_ms * 1e3:.3f} us ({b_by}); max abs "
            f"err {e:.3g}")


def apg_plans_main() -> None:
    """``python3 chip_smoke.py --apg-plans``: B2 under launch plans other
    than ``apg_plan``'s, through the C entry point (which checks each plan),
    float32, eta 0.3, each held to the plain version and event-timed three
    times in turns with the plan's own: at the SD latent (clusters of 1-8,
    threads x held accesses), at the decode logits (clusters of 2-8), at 8,
    15 and 16 rows of 128256 in clusters of 8 and 4 (one-block-an-SM
    clusters of 8 past one wave at 16 rows), and on the longer
    vocabularies' re-read route (4 or 8 accesses held). The numbers behind
    ``apg_plan``'s choices."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    phase_device()
    import statistics

    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import cfg_combine as KC

    lib = build.load()
    gen = torch.Generator(device="cuda").manual_seed(19)
    sweeps = {(1, 16384): [(8, 128, 4), (8, 64, 8), (4, 256, 4), (4, 128, 8), (2, 512, 4),
                           (2, 256, 8), (1, 512, 8)],
              (4, 128256): [(8, 512, 8), (4, 512, 8), (2, 512, 8)],
              (8, 128256): [(8, 512, 8), (4, 512, 8)],
              (15, 128256): [(8, 512, 8), (4, 512, 8)],
              (16, 128256): [(4, 512, 8), (8, 512, 8), (8, 512, 4), (2, 512, 8)],
              (1, 151936): [(8, 512, 8), (8, 512, 4)],
              (1, 256000): [(8, 512, 8), (8, 512, 4)]}
    for (rows, feat), plans in sweeps.items():
        u = torch.randn(rows, feat, generator=gen, device="cuda")
        c = torch.randn(rows, feat, generator=gen, device="cuda")
        s = torch.full((rows,), 3.0, device="cuda")
        ref = KC.apg_combine_plain(u, c, s, eta=0.3)
        out = torch.empty_like(c)
        own = KC.apg_plan(rows, feat, torch.float32, False)
        fns = {}
        for cl, th, held in plans:
            sl = -(-(feat // 4) // cl)
            plan = KC.ApgPlan(4, cl, th, held, "on_chip" if th * held >= sl else "reread",
                              4 * (3 * (th // 32) + 3 * KC.APG_MAX_CLUSTER))

            def fn(plan=plan):
                code = lib.apg_combine(u.data_ptr(), c.data_ptr(), None, s.data_ptr(),
                                       out.data_ptr(), rows, feat, 0.0, 0.3, 0.0, 0,
                                       plan.width, plan.cluster, plan.threads, plan.held,
                                       int(plan.route == "reread"), plan.smem, build.stream(c))
                build.check(lib, "apg_combine", code)
            fn()
            ok, e = apg_within(out, ref)
            if not ok:
                fail(f"apg_combine ({rows}, {feat}) under {tuple(plan)}: max abs err {e:.3g}")
            fns[plan] = fn
        ts = {plan: [] for plan in fns}
        for _ in range(3):
            for plan, fn in fns.items():
                ts[plan].append(time_ms(fn)[0] * 1e3)
        for plan, t in ts.items():
            log(f"[apgplan] ({rows}, {feat}) f32 per-row scales: cluster {plan.cluster}, "
                f"{plan.threads} threads x {plan.held} held, {plan.route}"
                f"{' (apg_plan)' if plan == own else ''}: device us median "
                f"{statistics.median(t):.3f} ({', '.join(f'{x:.3f}' for x in t)})")


if __name__ == "__main__":
    default_src = os.path.join(ROOT, "src")
    if sys.argv[1:2] == ["--decode-steps"]:
        decode_steps_main(sys.argv[2] if len(sys.argv) > 2 else default_src)
    elif sys.argv[1:2] == ["--serve-steps"]:
        serve_steps_main(sys.argv[2] if len(sys.argv) > 2 else default_src)
    elif sys.argv[1:2] == ["--paged-kernels"]:
        paged_kernels_main(sys.argv[2] if len(sys.argv) > 2 else default_src)
    elif sys.argv[1:2] == ["--apg-kernels"]:
        apg_kernels_main(sys.argv[2] if len(sys.argv) > 2 else default_src)
    elif sys.argv[1:2] == ["--apg-plans"]:
        apg_plans_main()
    else:
        main()
