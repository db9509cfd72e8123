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
   head dim and group (hd 64/120/128, H/K 4/5/8) and at the other
   families' (recurrentgemma-9b's hd 256, 16:1, window 2048; hubert-xlarge's
   hd 80, 16:16, non-causal, prefill only; chameleon-34b's hd 128, 64:8;
   mixtral-8x7b's hd 128, 32:8, window 4096), RMSNorm also at D 512 and 1024
   and chameleon's q/k-norm rows, the prefill at S 77 to
   2048 and a serve bucket (B 2, S 128), the decode with its position a
   device tensor at capacity 768 (pos 0, TK - 1, TK, 384, 767; TK the
   dtype's tile) and 4096 (pos 0, 511, 4095), with and without a window,
   and in its ring form, and one decode launch captured in a CUDA graph and
   replayed at three positions by rewriting its position tensor (attention
   held row by row, and shown to reject planted causal faults; the decode
   timed at capacity 768, pos 512 and 767, and 4096, pos 511 and 4095),
   RMSNorm timed at 4, 16, 256 and 2048 rows
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
   on the CPU (plain versions) and the GPU (kernels, the steps as CUDA
   graphs: the default on CUDA), teacher-forced logits and margin-guarded
   tokens, for each combine mode, launches exact under replay;
9. ring parity: the same on h2o-danube-3-4b at full width, 2 layers, its
   window cut to 128 under a 160-token prompt, so that every decode step
   attends through a ring cache (the flash-decode kernel's ring form),
   graphed on the GPU: every traced decode attention call is the ring's;
   then ``[fparity]``: the same CPU-against-GPU run for each decoder family
   of phase 25 at full width, cut to 2 or 3 layers (xlstm to one mLSTM and
   one sLSTM block, also on float32 weights and stream), B = 2 prompts of
   32 tokens, 8 new (on the MoE stacks the routings recorded on both
   sides: each flip must be one rounding explains, and the steps it moves
   are not held); after each MoE family, ``[sfparity]``: its slot arena on
   the CPU and the GPU on float32 weights, stream and pools, 4 requests of
   32 tokens, 8 new, events equal, launches exact, tokens margin-guarded,
   routing flips as in ``[fparity]``;
10. decode main path: ``guided_decode`` on llama3.2-1b at full width and
   depth (random bf16 weights from a seed), B = 4 prompts of 512 tokens, 256
   new tokens, graphed (the default), with exact launch counts (RMSNorm's
   split by rows), each combine; graphed against eager
   (``graphs=False``) in one call, each combine at f = 0.2: teacher-forced
   logits within phase 8's tolerance (bit-equal or not, logged) and tokens
   equal up to the first step the logits do not decide (``[dgraphs]``);
   seconds per generate and tokens/s graphed for COND suffix fractions f in
   {0, 0.2, 0.5, 1.0} and eager at f = 0.2, the launches and RMSNorm's by
   shape equal between them; then where its time goes (device time of a
   step from a CUDA-graph replay, beside its eager wall time; the loop's
   busy share graphed and eager; the graphs' capture ms and pool bytes)
   and the kernels that lead a FULL step under ``torch.profiler``, eager
   and as a graph replay, with RMSNorm's and Eq. 1's shares;
11. paged kernels vs plain: the four paged/ragged decode kernels against
   their plain version at the serve path's shapes (R 16, H 32, K 8, hd 64,
   pages of 16, a pool of 640 pages, tables of 40), positions spread over
   the tables, a quarter of the rows at phase 0, out-of-range table
   entries, with and without a window, and at the other dense decoders'
   head groups and those of mixtral-8x7b (window 4096) and chameleon-34b,
   bf16 and int8 pages (every ``block_k`` giving the same bits: the kernels have no
   sub-page tile); each timed beside its bytes bound and its plain version;
   then B9 against B7, and B8 against B10, with every row at phase 1: the
   same kernel on the same inputs, bit for bit;
12. serve parity: the same arrival trace through ``ContinuousEngine`` on
   llama3.2-1b at full width, 2 layers, on the CPU (plain versions) and the
   GPU (kernels; the ragged step a CUDA graph), both step modes and both
   pool dtypes, and the apg and interval combines: event streams equal,
   tokens equal up to the first step the logits do not decide;
13. serve main path: ``ContinuousEngine`` on llama3.2-1b at full width and
   depth, 16 requests of 128 to 512 prompt tokens and 128 new tokens
   arriving two a tick, ragged bf16 (graphed) at f in {0, 0.2, 0.5} and at
   f = 0.2 ragged int8, signature bf16 and signature int8 (graphed, a
   capture a signature bucket), and the same four eager
   (``graphs=False``), after one warm-up a step mode and pool dtype, with exact launch counts of
   the paged kernels and RMSNorm's launches by rows; graphed against eager
   on the same trace at f = 0.2 (``[sgraphs]``), ragged bf16 and int8 at
   full depth and signature bf16 and int8 on the first two layers: event
   streams equal, ``step_compiles`` equal (1 for ragged), tokens equal up
   to the first step the two runs' logits do not decide, launches exact;
   then a steady tick of each of the four ragged (graphed and eager,
   bf16 and int8) under ``torch.profiler``: wall per tick, busy share,
   RMSNorm's and the paged kernel's shares;
14. training kernels vs plain: B6 (bf16 x at 2048 and 16 rows of 2048,
   float32 x at 2048 x 2048, float32 scale) and B4 (bf16, B 4, S 512:
   llama3.2-1b's heads causal and non-causal, h2o-danube-3-4b's with a
   window of 128) under autograd, their outputs and gradients against
   ``torch.autograd.grad`` of the plain versions, a planted fault (B4's
   backward with its mask dropped) rejected, each timed forward, backward
   and both beside its bound, the plain version and ``F.rms_norm`` or SDPA
   under autograd; a backward the port does not cover raises;
15. training parity: the reduced SD pipeline trained 20 AdamW steps on the
   CPU (plain versions) and the GPU from the same weights, batches, draws
   and embeddings (losses and parameters compared), and ``lm_loss`` with
   every gradient on llama3.2-1b at full width, 2 layers, float32
   parameters, CPU against GPU, with and without remat (B4/B6 launches
   exact, a gradient on every parameter);
16. the paper's claims on a pipeline trained on the card:
   ``train_pipeline`` (400 steps), saved and reloaded through the port's
   checkpoint io into ``build/`` (latents equal bit for bit), 40/36 UNet
   passes with 20/16 B1 launches, and ``tests/test_system.py``'s 20%
   threshold and Fig. 1 window inequalities, the distances on one
   ``[claims]`` line;
17. full-width training steps: ``sd-unet-prod`` at batch 4 and
   llama3.2-1b at 16 layers, B 4, S 512, float32 parameters, through
   ``launch/train.py``'s step with and without remat; ms a step, peak
   memory, a finite loss, and B4's and B6's exact launches a step
   (``[tmain]``); then one step of each under ``torch.profiler``, with the
   shares of B4's and B6's kernels and backwards (``[tprofile]``);
18. B5's per-row form, the slot arena's step (a position and a cache row
   a query row), against its plain version at the slot shape (8 rows of a 9-row pool of capacity
   640, positions over [512, 639], in order and permuted with a padding
   row on the spare, bf16 and float32, window None/256), and its
   ring-a-row form, a windowed slot arena's (8 rows of a pool of 9 rings
   of 128 slots, h2o-danube-3-4b's heads, every ring wrapped, a padding
   row on the empty spare), each timed beside its bound, its plain version
   and SDPA with a per-row mask (``[slotkern]``); both also at the
   families' slot shapes (per row: mixtral's, chameleon's and
   recurrentgemma's heads at ``[fserve]``'s capacity; ring a row:
   recurrentgemma's ring of 2048 at hd 256, one kv head);
19. slot and lazy parity: the slot arena and lazy reservation (ragged bf16
   and int8, signature bf16; a pool the simulator sizes to preempt and
   copy on write) on llama3.2-1b at full width, 2 layers, CPU against GPU:
   events equal, tokens margin-guarded, B5's per-row launches and the
   paged kernels' exact, the lazy counters and events equal the port
   simulator's (``[slotparity]``);
20. the slot arena (the engine's default) at full width and depth: phase
   13's 16 requests padded to prompts of 512, 128 new tokens, 8 slots, f =
   0.2; two requests graphed and eager with bit-equal logits, then the
   trace with the signature step graphed (the default) and eager: wall,
   tokens/s, ticks, each capture's ms and pool bytes, B5's per-row and
   B4's launches exact, and a steady tick's busy share of each
   (``[slotmain]``); then 8 requests at temperature 0.7, graphed and
   eager: the host ms a tick spends drawing (``[slotdraw]``);
21. lazy reservation at full width and depth: 16 requests from the port's
   ``poisson_arrivals`` (rate 1.0), prompts of 120/248/376/504 (each 8 short
   of phase 13's, so that a shared prefix ends inside a page of 16, where
   copy-on-write can happen), priorities 0/2/1, the pool sized by the port
   simulator on the CPU (the largest with two preemptions and a
   copy-on-write), bf16 and int8 with the ragged step graphed: counters and
   events equal the simulator's, TTFT/TPOT p50/p99 (``[lazymain]``);
22. ``ServingEngine``: one ``generate`` of 8 requests at full depth, its
   pass count exact (``[facade]``);
23. a windowed model in the slot arena: h2o-danube-3-4b at full width, 2
   layers, its window cut to 128 under prompts of 160 (a ring a row in
   both pools), three requests, CPU against GPU (graphed): events equal,
   tokens margin-guarded, every B5 launch the ring-a-row form's, one per
   layer and decode forward (``[ringslot]``);
24. the engine's last options (``[async]``, ``[tier]``, ``[content]``,
   ``[fleet]``, ``[autotune]``): phase 13's trace ragged and graphed, bf16
   and int8, sync then ``tick_mode="async"`` (tokens equal, events equal the
   simulator's in each mode; with the 16 queued at tick 0 events, tokens
   and logits equal, the overlap window under the sync debug mode
   "error"; wall, tokens/s, busy share, each tick phase's host ms, a
   replay's host launch ms); phase 21's lazy trace with a host tier both
   preemptions swap through (engine == simulator, restored pages equal bit
   for bit, tokens margin-guarded against recompute, the swaps' GB/s); 16
   requests over 4 prompts of 512 with the content prefix cache against
   the length-keyed one (engine == simulator, 12 hits, each hit's token 0
   its founder's); ``ServeFleet`` of two 2-layer replicas, affinity
   against random routing (per-replica events equal ``simulate_fleet``'s,
   affinity strictly more hits and fewer passes); ``pass_budget="auto"``
   (the roofline per pass beside a replay's device time over R, the
   roofline no slower than the card, the budget, the swap break-even);
25. the other model families (``[families]``), each at full width with
   random bf16 weights from a seed: deepseek-v2-lite-16b (14 of 27
   layers: MLA + MoE), mixtral-8x7b (4 of 32 layers), recurrentgemma-9b
   (6 of 38), xlstm-350m (12 of 24) and chameleon-34b (4 of 48), each first
   held to its own teacher-forced forward (prefill plus three decode
   steps, float32 activations), then ``guided_decode`` on B = 4 prompts of
   512 tokens, 64 new, graphed at f in {0, 0.2} (and 1 on deepseek, with
   its apg and interval combines), eager at f = 0 (f = 1 on deepseek,
   none on xlstm),
   launches exact, graphed and eager teacher-forced logits on the graphed
   tokens bit-equal at f = 0.2: seconds per generate,
   tokens/s, the saving, both prefills' wall, FULL and COND device ms
   (replays timed by events and one profiled, with its leading kernels),
   a generate's busy share and peak memory; then ``[fserve]`` on the same
   model: the serve engine's slot arena (and for mixtral and chameleon
   the paged ragged step over bf16 and int8 pages and the paged signature
   step), 16 requests, graphed and eager (the paged signature step graphed
   only), tokens and events equal, one capture a bucket, launches exact,
   wall, ticks and a steady tick's busy
   share; then hubert-xlarge at full depth: a forward over 4 x 512 frames
   and masked-prediction AdamW steps with float32 parameters;
26. the launchers (``[launch]``): the serve CLI in-process
   (``launch.serve.main``) at llama3.2-1b's full width, random float32
   weights, 16 requests of 128 tokens, 32 new, f = 0.2: ``--mode static``,
   ``--mode continuous --kv paged --reservation lazy --prefix-cache
   content`` and that over ``--replicas 2``, each run's wall, launches
   exact (B3, B4, B5 per row, B6, B7), the paged engines' counters and
   events equal the port simulator's on the CLI's trace; then the
   dry-run's bundles on the card (``dryrun --device cuda``): ``sd-unet``
   denoise (bf16, batch 64), llama3.2-1b ``long_500k`` and xlstm-350m
   ``decode_32k``, full and cond, each built on meta and run on random
   arguments: ms, peak memory, the bytes the arguments asked of the
   allocator equal to the meta prediction, launches exact, and the SD
   step's cond/full ratio; last, the dry-run on meta at every shape of
   llama3.2-1b and xlstm-350m (``dryrun --all`` takes ~125 s of the
   host's CPU, past the phase's time: it runs on the CPU);
27. the sharding slice and the env knobs (``[a84]``): ``guided_decode``
   at phase 10's shape under ``REPRO_KV_QUANT=int8`` (int8 linear caches,
   dequantized for B5), graphed and eager at f = 0 and 0.2, launches
   exact, graphed logits bit-equal to eager, tokens against the bf16
   caches', FULL and COND device ms against bf16's, and B5 against its
   plain version on a dequantized cache; ``ContinuousEngine`` on a
   one-device nccl ``DeviceMesh`` (``launch.mesh.make_host_mesh``), paged
   bf16 and int8, equal to the meshless engine (tokens, counters, events),
   its pool leaves DTensors sharded on the pages dim; every call signature
   of those runs held against its plain version as phase 26's are; and the
   meta dry-run with ``--mesh data,model=16,16`` and ``--multi-pod`` at
   every shape of phase 26's two archs;
28. the sharded serve arena (``[a85]``): B7-B10's shard form at phase 13's
   shape, the pool's 640 pages split into 2 and 4 ranges (tables of local
   ids, -1 for another range's page): each range's (o, lse) against its
   plain version, the ranges merged (``dist.exchange.merge_partials``)
   against the whole launch within B7's bf16 tolerance, one range bit-equal
   to it, rows with no key of a range zeros and -inf, and each range's
   launch timed in turns with the whole launch; then two processes on
   ``cuda:0`` over a gloo group (two ranks on one card cannot form an NCCL
   group) serving llama3.2-1b at full width (8 of its 16 layers), 8
   requests, on meshes (2, 1)
   (pages, or a slot pool's rows, split over data) and (1, 2) (kv heads
   split over model), paged ragged and signature over bf16 and int8 pages
   and the slot arena, eagerly: both ranks bit-equal (tokens, logits,
   counters, events, launches), passes, counters, events and launches
   equal the meshless engine's eager run, every step's logits up to the
   first argmax that differs within ``SERVE_LOGIT_TOL``, and token
   agreement reported.

Phases 18-24 run after phase 13, on its model; phase 26 runs after phase
25, then phase 27 and phase 28 last.

``python3 chip_smoke.py --decode-steps [SRC]``, ``--serve-steps [SRC]``,
``--paged-kernels [SRC]`` and ``--apg-kernels [SRC]`` time and profile the
decode steps (the cfg and the APG FULL step), a steady serve tick of each
(step mode, pool dtype) pair, the four paged kernels at the serve shape, or
B2 at its four timed shapes, of the ``repro_torch`` under SRC alone (two
trees compare in turns in one call); ``--apg-plans`` times B2 under other
launch plans than its own.

Every launch count on a graphed path is exact: a capture records the
kernels' launches and each replay adds them (``core/graphs.py``).

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
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


def norm_census() -> dict:
    """RMSNorm's launches by (rows, dim) since the last ``reset_launches``
    (``rmsnorm.LAUNCH_SHAPES``: kept exact under graph replay)."""
    from repro_torch.kernels import rmsnorm as KR
    return dict(KR.LAUNCH_SHAPES)


def census_summary(by_shape: dict) -> str:
    return ", ".join(f"{r}x{d}: {n}" for (r, d), n in sorted(by_shape.items()))


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
    # h2o-danube-3-4b (120, 4), yi-9b (128, 8), causal and not, windows
    # None/256; then the other families' heads on the masks their layers
    # give B4 and B5: recurrentgemma-9b's local attention (hd 256, MQA 16:1,
    # window 2048, also at S 4096 where it binds), hubert-xlarge's encoder
    # (hd 80, 16:16, non-causal; it never decodes), chameleon-34b (hd 128,
    # 64:8) and mixtral-8x7b (hd 128, 32:8, window 4096)
    both = ((True, None), (True, 256), (False, None), (False, 256))
    shapes = ((64, 32, 8, both), (128, 40, 8, both), (120, 32, 8, both), (128, 32, 4, both),
              (256, 16, 1, ((True, None), (True, 256), (True, 2048))),
              (80, 16, 16, ((False, None),)),
              (128, 64, 8, ((True, None),)),
              (128, 32, 8, ((True, None), (True, 4096))))
    for hd, H, K, masks in shapes:
        decodes = any(causal for causal, _ in masks)
        windows = sorted({w for _, w in masks} | {None}, key=lambda w: w or 0)
        sizes = ((1, 77), (1, 512), (1, 2048), (4, 77), (4, 512), (4, 2048), (2, 128)) + \
            (((1, 4096),) if 2048 in windows else ())
        for B, S in sizes:
            for dtype in (bf16, f32):
                q, k, v = rnd(B, S, H, hd, dtype=dtype), rnd(B, S, K, hd, dtype=dtype), \
                    rnd(B, S, K, hd, dtype=dtype)
                for causal, window in masks:
                    tag = (f"hd={hd} H={H} K={K} B={B} S={S} {str(dtype)[6:]} "
                           f"causal={causal} window={window}")
                    e = _err_ok("flash_attention", tag,
                                KF.flash_attention(q, k, v, causal=causal, window=window),
                                KF.flash_attention_plain(q, k, v, causal=causal, window=window),
                                per_row=tol(dtype))
                    note("flash_attention", dtype, e)
        log(f"[attn] flash_attention hd={hd} H/K={H}/{K}: (B, S) in "
            f"{', '.join(f'({b}, {s_})' for b, s_ in sizes)} x (causal, window) in {masks} "
            f"x bf16/f32 within tolerance")
        if not decodes:
            continue
        # B5 reads its position from the device: pos as a one-element int32
        # tensor, at 0, the last key of the first tile, the first of the
        # second, the middle and the last slot, and capacity 4096 at 511
        # (the blocks past pos load nothing) and 4095
        for B, cap in ((1, 768), (4, 768), (1, 4096)):
            for dtype in (bf16, f32):
                tk = KD.TILE[dtype]
                positions = (0, tk - 1, tk, cap // 2, cap - 1) if cap == 768 else (0, 511, 4095)
                q, k, v = rnd(B, H, hd, dtype=dtype), rnd(B, cap, K, hd, dtype=dtype), \
                    rnd(B, cap, K, hd, dtype=dtype)
                for pos in positions:
                    pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
                    for window in windows:
                        tag = (f"hd={hd} H={H} K={K} B={B} S={cap} pos={pos} window={window} "
                               f"{str(dtype)[6:]}")
                        e = _err_ok("decode_attention", tag,
                                    KD.decode_attention(q, k, v, pos_t, window=window),
                                    KD.decode_attention_plain(q, k, v, pos_t, window=window),
                                    per_row=tol(dtype))
                        note("decode_attention", dtype, e)
        # the ring form: W slots, position p at slot p % W, the positions past
        # the ring's fill and eight random slots empty (-1)
        W = 256
        for dtype in (bf16, f32):
            q, k, v = rnd(2, H, hd, dtype=dtype), rnd(2, W, K, hd, dtype=dtype), \
                rnd(2, W, K, hd, dtype=dtype)
            for pos in (150, 1000):
                slot_pos = _ring_slots(W, pos, gen)
                pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
                for window in (64, 256):
                    tag = f"hd={hd} ring W={W} pos={pos} window={window} {str(dtype)[6:]}"
                    e = _err_ok("decode_attention", tag,
                                KD.decode_attention(q, k, v, pos_t, window=window,
                                                    slot_pos=slot_pos),
                                KD.decode_attention_plain(
                                    q, k, v, pos, valid=KD.ring_valid(slot_pos, pos, window)),
                                per_row=tol(dtype))
                    note("decode_attention", dtype, e)
        log(f"[attn] decode_attention hd={hd} H/K={H}/{K}, pos a device tensor: capacity 768 at "
            f"pos 0, TK-1, TK, 384, 767 (TK 64 bf16, 32 f32) x B in (1, 4), capacity 4096 at pos "
            f"0, 511, 4095, x window in {windows}; ring of {W} slots at pos 150/1000 x window "
            f"64/256; bf16/f32 within tolerance")
    _captured_decode(rnd, tol, note)
    # llama3.2-1b's model and q/k norms; deepseek's MLA kv_norm (D 512) and
    # xlstm-350m's block norms (D 1024) at decode and prefill rows; chameleon-34b's
    # q/k norms at prefill (B 4 x S 512 x 64 heads at hd 128)
    for rows, D in ((4, 2048), (2048, 2048), (4 * 32, 64), (4, 512), (2048, 512), (4, 1024),
                    (2048, 1024), (4 * 512 * 64, 128)):
        for xdt, sdt in ((bf16, bf16), (bf16, f32), (f32, f32)):
            x, sc = rnd(rows, D, dtype=xdt) * 3, rnd(D, dtype=sdt)
            out, ref = KR.rmsnorm(x, sc, 1e-5), KR.rmsnorm_plain(x, sc, 1e-5)
            tag = f"rows={rows} D={D} x {str(xdt)[6:]} scale {str(sdt)[6:]}"
            if xdt == bf16:
                e = _err_ok("rmsnorm", tag, out, ref, elementwise=2 * BF16_STEP)
            else:
                e = _err_ok("rmsnorm", tag, out, ref, rel_to_max=1e-5)
            note("rmsnorm", xdt, e)
    log("[attn] rmsnorm rows x D in (4, 2048), (2048, 2048), (128, 64), (4, 512), (2048, 512), "
        "(4, 1024), (2048, 1024), (131072, 128), x/scale bf16/bf16, bf16/f32, f32/f32: bf16 "
        "within one bf16 step of each value, f32 within 1e-5")
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
    for kk, vv, pos in ((kc, vc, DECODE_S), (kc, vc, cap - 1), (kc4, vc4, 4095),
                        (kc4, vc4, 511)):
        S_kv = kk.shape[1]
        kkt, vvt = kk.transpose(1, 2).contiguous(), vv.transpose(1, 2).contiguous()
        mask = (torch.arange(S_kv, device=dev) <= pos)[None, None, None, :]
        pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
        r = row("decode_attention", f"B={B} capacity={S_kv} pos={pos} (a device tensor) H={H} "
                f"K={K} hd={hd} bf16",
                lambda: KD.decode_attention(qd, kk, vv, pos_t),
                lambda: KD.decode_attention_plain(qd, kk, vv, pos_t),
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


def _ring_slots(W: int, pos: int, gen):
    """A ring's (W,) int32 slot positions at ``pos``: position p at slot
    p % W, slots before position 0 and eight random others empty (-1)."""
    import torch
    slots = torch.arange(W, device=gen.device, dtype=torch.int32)
    slot_pos = pos - (pos - slots) % W
    slot_pos = torch.where(slot_pos < 0, -1, slot_pos).to(torch.int32)
    slot_pos[torch.randperm(W, generator=gen, device=gen.device)[:8]] = -1
    slot_pos[pos % W] = pos
    return slot_pos


def _captured_decode(rnd, tol, note) -> None:
    """One B5 launch captured in a CUDA graph (``core/graphs.capture``) and
    replayed at three positions by rewriting its position tensor: equal to
    the plain version at each (llama3.2-1b's heads, capacity 768, bf16 and
    float32, linear with and without a window, and the ring form)."""
    import torch
    from repro_torch.core import graphs as G
    from repro_torch.kernels import decode_attention as KD

    B, H, K, hd, cap, W = 4, 32, 8, 64, 768, 256
    gen = torch.Generator(device="cuda").manual_seed(20)
    pool = G.pool()
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = rnd(B, H, hd, dtype=dtype), rnd(B, cap, K, hd, dtype=dtype), \
            rnd(B, cap, K, hd, dtype=dtype)
        kr, vr = k[:, :W].contiguous(), v[:, :W].contiguous()
        for form, window in (("linear", None), ("linear", 256), ("ring", 128)):
            pos_t = torch.zeros(1, dtype=torch.int32, device="cuda")
            slot_pos = torch.full((W,), -1, dtype=torch.int32, device="cuda")
            if form == "ring":
                step = lambda: KD.decode_attention(q, kr, vr, pos_t, window=window,  # noqa: E731
                                                   slot_pos=slot_pos)
            else:
                step = lambda: KD.decode_attention(q, k, v, pos_t, window=window)  # noqa: E731
            graph, _ = G.capture(step, pool)
            for pos in (5, 300, cap - 1):
                pos_t.fill_(pos)
                if form == "ring":
                    slot_pos.copy_(_ring_slots(W, pos, gen))
                    ref = KD.decode_attention_plain(
                        q, kr, vr, pos, valid=KD.ring_valid(slot_pos, pos, window))
                else:
                    ref = KD.decode_attention_plain(q, k, v, pos, window=window)
                tag = f"captured once, replayed at pos {pos}, {form} window={window} " \
                      f"{str(dtype)[6:]}"
                note("decode_attention", dtype,
                     _err_ok("decode_attention", tag, graph.replay(), ref, per_row=tol(dtype)))
    log(f"[attn] decode_attention captured once and replayed at pos 5, 300, {cap - 1} "
        f"(B={B} H={H} K={K} hd={hd} capacity {cap}; linear, window 256, ring of {W} slots "
        f"with window 128; bf16/f32): equal to the plain version within tolerance at each")


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


def _expected_launches(cfg, plan, kernel: str = "cfg_combine") -> dict:
    """Exact kernel launches of one ``guided_decode`` of any decoder (2
    prefills and ``plan.total_steps`` decode steps, FULL two forwards and
    COND one): B4 once a GQA layer and prefill, B5 once a GQA layer and
    decode forward, B6 per forward once a norm of each block (norm1, norm2
    where the block has an FFN, q and k norms, MLA's ``kv_norm``) and the
    final norm, and the combine once a FULL step and once for the
    prefill's logits."""
    attn = ("attn", "swa")
    n_cond = plan.optimized_steps
    n_full = plan.total_steps - n_cond
    forwards = 2 + 2 * n_full + n_cond
    gqa = 0 if cfg.mla is not None else sum(k in attn for k in cfg.blocks)
    norms = 1 + sum(1 + (k in attn + ("rglru",) and cfg.d_ff > 0)
                    + 2 * (k in attn and cfg.qk_norm and cfg.mla is None)
                    + (k in attn and cfg.mla is not None) for k in cfg.blocks)
    want = {k: 0 for k in launch_counts()}
    want.update(flash_attention=2 * gqa, decode_attention=gqa * (forwards - 2),
                rmsnorm=norms * forwards)
    if kernel != "cfg_combine" or plan.guidance_scale != 1.0:
        want[kernel] = 1 + n_full
    return want


COMBINE_MODES = {"cfg": ("cfg_combine", {}),
                 "apg": ("apg_combine", dict(apg_eta=0.3)),
                 "interval": ("cfg_combine_rowscale", dict(interval=(0.25, 0.75)))}


def _decode_pair(tag, cpu, gpu, toks, plan, kw, want, around_gpu=None, routes=False) -> str:
    """The same greedy ``guided_decode`` on the CPU (plain versions: its
    logits by ``teacher_forced_logits(tokens=None)``, its tokens their
    argmax) and the GPU (kernels, graphed, inside the context
    ``around_gpu()`` if given): the GPU run's launch counts must equal
    ``want`` and ``_margin_guard`` hold.
    ``routes`` (MoE stacks): the GPU's teacher-forced run is repeated eagerly,
    bit-equal to the graphed one, with both sides' routings recorded, and
    the steps that a routing flip between them moves are not held
    (``_routing_moves``). -> the log's summary."""
    import contextlib

    import torch
    from repro_torch.core import ar_decode as AR

    rec_a, rec_b = [], []
    with _recording_routes(rec_a) if routes else contextlib.nullcontext():
        la = AR.teacher_forced_logits(cpu, toks, plan, None, **kw)    # the greedy decode's
    a = la.argmax(-1)
    reset_launches()
    with (around_gpu or contextlib.nullcontext)():
        b, _ = AR.guided_decode(gpu, toks.cuda(), plan, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != want:
        fail(f"{tag}: launches {counts}, want {want}")
    lb = AR.teacher_forced_logits(gpu, toks.cuda(), plan, a.cuda(), **kw).cpu()
    moved = None
    if routes:
        with _recording_routes(rec_b):
            le = AR.teacher_forced_logits(gpu, toks.cuda(), plan, a.cuda(), graphs=False, **kw)
        if not torch.equal(le.cpu(), lb):
            fail(f"{tag}: the eager teacher-forced logits differ from the graphed ones")
        moved = _routing_moves(tag, cpu.cfg, plan, rec_a, rec_b)
    return f"launches {want}; " + _margin_guard(tag, a, b.cpu(), la, lb, moved)


@contextlib.contextmanager
def _recording_routes(rec: list, live=None):
    """Appends each MoE routing's (top-k ids, router probabilities, kept
    pairs), on the CPU, to ``rec`` in call order; with ``live``,
    ``live(p)`` (``p`` the layer's MoE parameters) -> (tags, n): the
    record is the tags followed by the first n rows' tensors."""
    from repro_torch.models import moe as MOE
    route = MOE.route

    def recorded(p, cfg, x, C):
        r = route(p, cfg, x, C)
        tags, n = live(p) if live is not None else ((), None)
        rec.append((*tags, r.ids[:n].cpu(), r.probs[:n].cpu(), r.keep[:n].cpu()))
        return r

    MOE.route = recorded
    try:
        yield rec
    finally:
        MOE.route = route


def _routing_call_ok(tag, k: int, a, b):
    """One routing call of two runs, ``a`` and ``b`` each (top-k ids,
    router probabilities, kept pairs) over (rows, S) tokens, rows the
    routing groups. A flip is a token whose top-k set differs; rounding
    must explain each (run a's k-th router probability within twice the
    largest probability difference of its (k+1)-th), every changed
    capacity drop (the experts that kept the token: one set in either
    top-k order) must sit in a row with a flip, and the router
    probabilities must agree within ``LOGIT_TOL``, or the check fails. ->
    (flip, drop) (rows, S)"""
    import torch
    (ia, pa, ka), (ib, pb, kb) = a, b
    flip = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
    drop = (torch.where(ka, ia, -1).sort(-1).values
            != torch.where(kb, ib, -1).sort(-1).values).any(-1) & ~flip
    top = pa.sort(-1, descending=True).values
    unexplained = flip & (top[..., k - 1] - top[..., k] > 2 * (pa - pb).abs().amax(-1))
    if bool(unexplained.any()) or bool((drop.any(-1) & ~flip.any(-1)).any()):
        fail(f"{tag} differs beyond rounding: flips {flip.nonzero().tolist()}, unexplained "
             f"{unexplained.nonzero().tolist()}, drops {drop.nonzero().tolist()}")
    if (pa - pb).abs().max().item() > LOGIT_TOL:
        fail(f"{tag}: router probabilities differ by {(pa - pb).abs().max().item():.3g} > "
             f"{LOGIT_TOL}")
    return flip, drop


def _routing_moves(tag, cfg, plan, rec_a, rec_b):
    """The teacher-forced steps (B, n) that the routings two runs recorded
    (``_recording_routes``: per forward, prefills then decode steps, each MoE
    layer in order) may move apart. Each call must pass
    ``_routing_call_ok``, and at most a quarter of the steps may move, or
    the check fails. A flip or drop in a layer before the last moves every
    later step of its row; in the last layer only the step its position's
    logits give."""
    import torch
    from repro_torch.core.selective import Mode

    n, k = plan.total_steps, cfg.moe.top_k
    layers = [i for i in range(cfg.num_layers) if i >= cfg.moe.first_k_dense]
    steps = [0, 0] + [i + 1 for i, m in enumerate(plan.modes())
                      for _ in range(2 if m is Mode.FULL else 1)]
    if not len(rec_a) == len(rec_b) == len(steps) * len(layers):
        fail(f"{tag}: {len(rec_a)} and {len(rec_b)} routings recorded, want "
             f"{len(steps) * len(layers)}")
    moved = torch.zeros(rec_a[0][0].shape[0], n, dtype=torch.bool)
    n_flips = 0
    for j, (a, b) in enumerate(zip(rec_a, rec_b)):
        step, layer = steps[j // len(layers)], layers[j % len(layers)]
        flip, drop = _routing_call_ok(f"{tag}: routing call {j} (layer {layer}, step {step})",
                                      k, a, b)
        n_flips += int(flip.sum())
        for b, pos in (flip | drop).nonzero().tolist():
            if step >= n:
                continue
            if layer != cfg.num_layers - 1:
                moved[b, step:] = True
            elif pos == flip.shape[1] - 1:
                moved[b, step] = True
    log(f"[fparity] {tag}: {n_flips} routing flips CPU against GPU over {len(rec_a)} routings, "
        f"each within rounding; {int(moved.sum())} of {moved.numel()} steps moved by them")
    if 4 * int(moved.sum()) > moved.numel():
        fail(f"{tag}: routing flips move {int(moved.sum())} of {moved.numel()} steps, more than "
             f"a quarter")
    return moved


def _margin_guard(tag, a, b, la, lb, moved=None) -> str:
    """Tokens ``a`` and ``b`` (B, n) of two runs, ``la`` and ``lb`` their
    float32 logits teacher-forced on ``a``: the logits within ``LOGIT_TOL``
    of max|la|, the tokens equal up to each row's first step that the
    logits do not decide, where ``a``'s margin of its top token over some
    other token is no larger than the two logits' differences. Steps that
    ``moved`` (B, n) marks are neither held nor decided. -> the log's
    summary."""
    import torch
    big = la.abs().max().item()
    err = (lb - la).abs()
    if moved is not None:
        err = err.masked_fill(moved[..., None], 0.0)
    if not err.max().item() <= LOGIT_TOL * big:
        fail(f"{tag}: teacher-forced logits rel err {err.max().item() / big:.3g} > {LOGIT_TOL}")
    top = la.argmax(-1, keepdim=True)
    gap = la.gather(-1, top) - la
    slack = err.gather(-1, top) + err
    other = torch.arange(la.shape[-1], device=la.device) != top
    undecided = ((gap <= slack) & other).any(-1).cpu()          # (B, n_new)
    if moved is not None:
        undecided |= moved
    a, b = a.cpu(), b.cpu()
    compared = 0
    for r in range(a.shape[0]):
        low = undecided[r].nonzero()
        upto = int(low[0]) if len(low) else a.shape[1]
        if not torch.equal(a[r, :upto], b[r, :upto]):
            fail(f"{tag}: row {r} tokens differ before step {upto}: "
                 f"{a[r].tolist()} vs {b[r].tolist()}")
        compared += upto
    held = "" if moved is None else f" on the {int((~moved).sum())} steps no flip moved"
    return (f"teacher-forced logits rel err {err.max().item() / big:.3g}{held} (tol "
            f"{LOGIT_TOL}, max|logit| {big:.3g}); tokens equal on the {compared} of {a.numel()} "
            f"decided steps, {int((a == b).sum())} equal overall")


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
                               _expected_launches(cfg, plan, kernel))
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
    want = _expected_launches(cfg, plan, "cfg_combine")
    calls = {"ring": 0, "linear": 0}
    ring, linear = A.attn_decode_ring, A.attn_decode

    def counted(kind, fn):
        def wrapped(*args, **kw):
            calls[kind] += 1
            return fn(*args, **kw)
        return wrapped

    @contextlib.contextmanager
    def counting():
        A.attn_decode_ring, A.attn_decode = counted("ring", ring), counted("linear", linear)
        try:
            yield
        finally:
            A.attn_decode_ring, A.attn_decode = ring, linear
    summary = _decode_pair("ring parity", cpu, gpu, toks, plan, dict(combine="cfg"), want,
                           counting)
    # graphed: the layers' Python calls run at the FULL and COND steps'
    # warm-ups and captures, and the replays launch what they captured
    if calls["linear"] or not calls["ring"]:
        fail(f"ring parity: decode attention calls on the GPU {calls}: every layer's must "
             "take the ring path")
    log(f"[ring] {cfg.name} x{cfg.num_layers} layers, window {RING_WINDOW}, B=2 S={RING_PROMPT}, "
        f"16 new tokens, graphed: every decode attention call takes the ring path "
        f"({calls['ring']} traced calls, none linear) and the replays launch decode_attention "
        f"{want['decode_attention']} times (layers x decode forwards); set-up "
        f"{time.perf_counter() - t0:.2f} s; {summary}")


# each decoder family cut to its first block pattern (deepseek: the dense
# layer and one MoE layer; recurrentgemma: rglru, rglru, swa), xlstm to one
# mLSTM and one sLSTM block: its bf16 stream drifts from a float32 one
# faster with depth than the other stacks', the CPU's and the GPU's alike
# (its 4-layer stack's CPU and GPU bf16 logits differed by 0.0256 of
# max|logit|), so a float32-stream pair holds its code to 1e-4 besides
FAMILY_PARITY = (   # arch, layers, block pattern (None: the arch's), a float32 pair
    ("deepseek-v2-lite-16b", 2, None, False), ("mixtral-8x7b", 2, None, False),
    ("recurrentgemma-9b", 3, None, False), ("xlstm-350m", 2, ("mlstm", "slstm"), True),
    ("chameleon-34b", 2, None, False))


@contextlib.contextmanager
def _float32_stream():
    """``Transformer.embed_tokens`` in the table's dtype instead of bf16: a
    model of float32 weights then runs a float32 stream."""
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import Transformer
    embed = Transformer.embed_tokens
    Transformer.embed_tokens = lambda self, tokens: L.embed(self.embed.table, tokens,
                                                            dtype=self.embed.table.dtype)
    try:
        yield
    finally:
        Transformer.embed_tokens = embed


SFPARITY_S, SFPARITY_NEW = 32, 8      # [sfparity]: prompts, new tokens
F32_LOGIT_TOL = 1e-4   # CPU vs GPU logits of float32 weights and stream, of max|logit|


def _slot_parity_engine(rec=None):
    """A recording engine (``_recording_engine``) whose pools' floating
    leaves are float32 (the engine's are bf16, the stream's dtype), for a
    float32 stream, and that, with ``rec``, records each MoE routing of its
    live rows there (``_recording_routes``), tagged (tick, the uid of each
    live row, the layer). The live rows are a slot prefill's one and a
    signature group's requests (its padding rows on the spare route
    nothing live)."""
    Base = _recording_engine()

    class Eng(Base):
        _uids = None

        def _pool_specs(self, rows, device):
            return [{k: t.float() if t.is_floating_point() else t for k, t in layer.items()}
                    for layer in super()._pool_specs(rows, device)]

        def _prefill_slot(self, req, slot, key):
            self._uids = [req.uid]
            return super()._prefill_slot(req, slot, key)

        def _signature_step(self, f, c):
            self._groups = {"f": f["uids"], "c": c["uids"]}
            return super()._signature_step(f, c)

        def _decode_rows(self, emb, dev, group, stream):
            self._uids = self._groups[group]
            return super()._decode_rows(emb, dev, group, stream)

        def serve_trace(self, *a, **kw):
            if rec is None:
                return super().serve_trace(*a, **kw)
            layer_of = {id(layer.mlp): i for i, layer in enumerate(self.model.layers)
                        if hasattr(layer, "mlp")}

            def live(p):
                return (self.tick_count, list(self._uids), layer_of[id(p)]), len(self._uids)
            with _recording_routes(rec, live):
                return super().serve_trace(*a, **kw)
    return Eng


def _serve_moves(tag, cfg, rec_a, rec_b, parted: dict) -> dict:
    """Where each request's tokens may part between two runs' routings
    (``_slot_parity_engine``): a routing flip or a changed capacity drop
    in one of its rows, each call held by ``_routing_call_ok``, in a layer
    before the last, or in the last at the position whose output the step
    reads (a last layer's FFN feeds no cache). A request's rows are
    compared up to the tick ``parted[uid]`` whose token parts the two runs
    (later steps read other tokens), and up to a move before its last
    layer (later layers and steps read other states). -> {uid: [(tick,
    whole)]}: a move in a layer before the last moves the request's tokens
    from that tick on (``whole``), one in the last layer only the token of
    that tick"""
    k = cfg.moe.top_k
    if len(rec_a) != len(rec_b) or any(a[:3] != b[:3] for a, b in zip(rec_a, rec_b)):
        fail(f"{tag}: the two runs' routings do not pair ({len(rec_a)}, {len(rec_b)})")
    moved, n_flips, gone = {}, 0, set()
    for j, ((tick, uids, layer, *a), (_, _, _, *b)) in enumerate(zip(rec_a, rec_b)):
        same = [i for i, u in enumerate(uids)
                if tick <= parted.get(u, tick) and (u, True) not in gone]
        if not same:
            continue
        uids = [uids[i] for i in same]
        flip, drop = _routing_call_ok(f"{tag}: routing call {j} (tick {tick}, layer {layer})",
                                      k, [t[same] for t in a], [t[same] for t in b])
        n_flips += int(flip.sum())
        hit, whole = flip | drop, layer != cfg.num_layers - 1
        if not whole:
            hit = hit[:, -1:]
        for i in hit.any(-1).nonzero()[:, 0].tolist():
            moved.setdefault(uids[i], []).append((tick, whole))
            gone.add((uids[i], whole))
    log(f"[sfparity] {tag}: {n_flips} routing flips over {len(rec_a)} routings, each within "
        f"rounding; requests moved from ticks {moved}")
    return moved


def _moved_tokens(eng, out: dict, moved: dict) -> dict:
    """The indices of each request's tokens that routing moves
    (``_serve_moves``) may part, from the ticks of its token events."""
    out_idx = {}
    for uid, toks in out.items():
        ticks = [k[1] for k in eng.metrics.trace.keys() if k[0] == "token" and k[2] == uid]
        out_idx[uid] = {i for i, tau in enumerate(ticks[:len(toks)])
                        if any(tau >= t if whole else tau == t
                               for t, whole in moved.get(uid, ()))}
    return out_idx


def _slot_family_parity(tag, cpu, gpu) -> str:
    """``[sfparity]`` on a MoE stack: the slot arena on the CPU (plain
    versions) and on the card (kernels, the signature steps graphed), both
    on float32 weights, stream and pools (``_float32_stream``; in bf16 at
    full width the two break router near-ties apart on a quarter to a half
    of the tokens, PERF.md): 4 requests of ``SFPARITY_S`` random tokens,
    ``SFPARITY_NEW`` new, f = 0.25, scale 3; events equal, the card's
    launches exact (``_serve_want``), logits within ``F32_LOGIT_TOL`` and
    tokens equal up to each request's first step the logits do not decide
    (``_serve_margin``). The card's eager run (bit-equal to its graphed one)
    records its routings beside the CPU's: each flip must be one rounding
    explains, a request's tokens that a flip may move are neither held nor
    decided (``_serve_moves``), and at most a quarter of the tokens may
    move, as in ``_routing_moves``. -> the log's summary"""
    import torch
    from repro_torch.models.transformer import Transformer
    cfg = cpu.cfg
    kw = dict(num_slots=4, pass_budget=8, prompt_len=SFPARITY_S, max_new=SFPARITY_NEW,
              stop_on_eos=False, prefills_per_tick=2, seed=0, selective_fraction=0.25)
    arrivals = [0, 0, 1, 2]

    def serve(model, graphs=None, rec=None):
        eng = _slot_parity_engine(rec)(model, cfg, graphs=graphs, **kw)
        out = eng.serve_trace(_serve_requests(cfg, 4, (SFPARITY_S,), SFPARITY_NEW, 7), arrivals)
        torch.cuda.synchronize()
        return eng, out

    with _float32_stream():
        cpu = Transformer.from_state_dict(cfg, {k: t.float() for k, t in cpu.state_dict().items()})
        gpu = Transformer.from_state_dict(cfg, {k: t.cuda() for k, t in cpu.state_dict().items()})
        rec_c, rec_g = [], []
        ce, co = serve(cpu, rec=rec_c)
        reset_launches()
        ge, go = serve(gpu)
        counts, want = launch_counts(), _serve_want(cfg, ge, "signature")
        if counts != want or ce.metrics.trace.keys() != ge.metrics.trace.keys() or \
                not ge.graphs:
            fail(f"{tag}: launches {counts} want {want}, events equal "
                 f"{ce.metrics.trace.keys() == ge.metrics.trace.keys()}")
        ee, eo = serve(gpu, graphs=False, rec=rec_g)
    if eo != go or not all(torch.equal(a, b) for u in go
                           for a, b in zip(ge.logits[u], ee.logits[u])):
        fail(f"{tag}: the card's graphed and eager slot runs differ")
    parted = {}
    for uid, toks in co.items():
        ticks = [k[1] for k in ce.metrics.trace.keys() if k[0] == "token" and k[2] == uid]
        m = next((i for i, (x, y) in enumerate(zip(toks, eo[uid])) if x != y), None)
        if m is not None:
            parted[uid] = ticks[m]
    exempt = _moved_tokens(ge, go, _serve_moves(tag, cfg, rec_c, rec_g, parted))
    n_moved = sum(len(v) for v in exempt.values())
    total = sum(len(v) for v in go.values())
    if 4 * n_moved > total:
        fail(f"{tag}: routing flips move {n_moved} of {total} tokens, more than a quarter")
    return (f"slot arena, float32 weights, stream and pools, 4 requests, launches exact, events "
            f"equal; {n_moved} of {total} tokens a routing flip moves not held; "
            + _serve_margin(tag, ce, co, ge, go, exempt, F32_LOGIT_TOL))


def phase_family_parity():
    """``[fparity]``: the same ``guided_decode`` on the CPU (plain versions)
    and the GPU (kernels, graphed) for every decoder family of phase 25, as
    ``[dparity]`` does for llama3.2-1b: full width, ``FAMILY_PARITY``'s
    depths, bf16 weights from seed 0 (made on the card and copied to the
    CPU), B = 2, prompts of 32 tokens, 8 new tokens at f = 0.25; launches
    exact, teacher-forced logits within ``LOGIT_TOL``, tokens equal where
    the logits decide them. On the MoE stacks bf16 router probabilities tie
    or nearly tie, and the CPU and the GPU break a few such ties apart (a
    flipped expert moved one step's logits by 0.072 of max|logit| on a
    2-layer deepseek): there each flip must be one rounding explains, and
    the steps it moves are not held (``_routing_moves``). xlstm also runs
    the pair on float32 weights and a float32 stream, held within 1e-4."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core import ar_decode as AR
    from repro_torch.core.selective import GuidancePlan
    from repro_torch.data.prompts import PAPER_PROMPTS
    from repro_torch.data.tokenizer import encode_batch
    from repro_torch.models.transformer import Transformer

    prompts = [" ".join(PAPER_PROMPTS[i::2]) for i in range(2)]
    plan = GuidancePlan.suffix(8, 0.25, DECODE_SCALE)
    for arch, n, pattern, f32 in FAMILY_PARITY:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), num_layers=n)
        if pattern:
            cfg = dataclasses.replace(cfg, block_pattern=pattern)
        gpu = Transformer.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                               dtype=torch.bfloat16)
        cpu = Transformer.from_state_dict(cfg, {k: t.cpu() for k, t in gpu.state_dict().items()})
        toks = torch.from_numpy(encode_batch(prompts, cfg.vocab_size, 32)).long()
        summary = _decode_pair(f"fparity {arch}", cpu, gpu, toks, plan, dict(combine="cfg"),
                               _expected_launches(cfg, plan, "cfg_combine"),
                               routes=cfg.moe is not None)
        if f32:
            with _float32_stream():
                c32 = Transformer.from_state_dict(
                    cfg, {k: t.float() for k, t in cpu.state_dict().items()})
                g32 = Transformer.from_state_dict(
                    cfg, {k: t.cuda() for k, t in c32.state_dict().items()})
                la = AR.teacher_forced_logits(c32, toks, plan, None)
                a = la.argmax(-1)
                lb = AR.teacher_forced_logits(g32, toks.cuda(), plan, a.cuda()).cpu()
            big = la.abs().max().item()
            rel = (lb - la).abs().max().item() / big
            if not rel <= F32_LOGIT_TOL:
                fail(f"fparity {arch}: float32 teacher-forced logits rel err {rel:.3g} > "
                     f"{F32_LOGIT_TOL}")
            drift = [(AR.teacher_forced_logits(m, t, plan, a.to(t.device)).cpu() - la).abs().max()
                     .item() / big for m, t in ((cpu, toks), (gpu, toks.cuda()))]
            summary += (f"; float32 weights and stream: logits rel err {rel:.3g} (tol "
                        f"{F32_LOGIT_TOL}); the "
                        f"bf16 runs fed its tokens differ from it by {drift[0]:.3g} (CPU) and "
                        f"{drift[1]:.3g} (GPU)")
            del c32, g32
        log(f"[fparity] {arch} x{n} layers {list(cfg.blocks)}, B=2 S=32, 8 new tokens "
            f"({plan.total_steps - plan.optimized_steps} FULL + {plan.optimized_steps} COND), "
            f"{time.perf_counter() - t0:.1f} s: {summary}")
        if cfg.moe is not None:
            t1 = time.perf_counter()
            summary = _slot_family_parity(f"sfparity {arch}", cpu, gpu)
            log(f"[sfparity] {arch} x{n} layers, {time.perf_counter() - t1:.1f} s: {summary}")
        del cpu, gpu
        gc.collect()              # the model and its decode loops hold each other
        torch.cuda.empty_cache()


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
    """``guided_decode`` on llama3.2-1b at full width and depth, graphed (the
    default) and eager. -> (model, prompts, launches of the counted f = 0.2
    runs, rows of seconds per generate by f and mode)."""
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
        out, dt = run(plan, combine=mode, **kw)       # graphed: captures FULL and COND
        counts, want = launch_counts(), _expected_launches(cfg, plan, kernel)
        census = norm_census()
        if sum(census.values()) != counts["rmsnorm"]:
            fail(f"dmain combine={mode}: rmsnorm census {census} against "
                 f"{counts['rmsnorm']} launches")
        if mode == "cfg":
            log(f"[dmain] rmsnorm launches by rows x dim, one generate f=0.2: "
                f"{census_summary(census)}")
        if counts != want:
            fail(f"dmain combine={mode}: launches {counts}, want {want}")
        for name in ("flash_attention", "decode_attention", "rmsnorm", kernel):
            launches[name] = counts[name]
        log(f"[dmain] generate combine={mode} f=0.2, graphed: launches {want}, {dt:.3f} s incl. "
            f"the graphs' capture, first tokens {out[0, :8].tolist()}")
    phase_decode_graphs(model, toks, plan)

    rows = []
    for f, graphs in ((0.0, None), (0.2, None), (0.5, None), (1.0, None), (0.2, False)):
        plan = GuidancePlan.suffix(DECODE_NEW, f, DECODE_SCALE)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        n = 4 if graphs is None else 2       # eager: one timed run (the script's time limit)
        times = [run(plan, graphs=graphs)[1] for _ in range(n)][1:]
        counts = {k: v / n for k, v in launch_counts().items()}
        want = _expected_launches(cfg, plan, "cfg_combine")
        if counts != want:
            fail(f"dmain f={f} graphs={graphs}: launches per generate {counts}, want {want}")
        forwards = 2 + 2 * (DECODE_NEW - plan.optimized_steps) + plan.optimized_steps
        rows.append(dict(f=f, graphed=graphs is None, timed=len(times),
                         mean_s=float(np.mean(times)),
                         std_s=float(np.std(times)), forwards=forwards,
                         census={k: v / n for k, v in norm_census().items()},   # a generate
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9))
    graphed = {r["f"]: r for r in rows if r["graphed"]}
    eager = next(r for r in rows if not r["graphed"])
    if eager["census"] != graphed[0.2]["census"]:
        fail(f"dmain f=0.2: rmsnorm launches a generate by shape graphed "
             f"{graphed[0.2]['census']} against eager {eager['census']}")
    for r in rows:
        r["saving"] = 1.0 - r["mean_s"] / graphed[0.0]["mean_s"] if r["graphed"] else None
        log(f"[dmain] f={r['f']} {'graphed' if r['graphed'] else 'eager'}: mean "
            f"{r['mean_s']:.4f} s std {r['std_s']:.4f} s (1 warm-up, {r['timed']} timed), "
            f"{DECODE_B * DECODE_NEW / r['mean_s']:.1f} tokens/s, forwards {r['forwards']}, "
            + (f"saving {r['saving']:.4f}, " if r["graphed"] else "")
            + f"peak {r['peak_gb']:.2f} GB")
    log(f"[dmain] f=0.2: graphed {graphed[0.2]['mean_s']:.4f} s against eager "
        f"{eager['mean_s']:.4f} s a generate ({eager['mean_s'] / graphed[0.2]['mean_s']:.2f}x); "
        f"launches per generate and RMSNorm's by shape equal")
    return model, toks, launches, rows


def phase_decode_graphs(model, toks, plan) -> None:
    """Graphed against eager on the card, each combine: the same prompts
    through ``guided_decode(graphs=False)`` and the graphed default, the
    teacher-forced logits of both fed the eager run's tokens (bit-equal or
    not, logged), and ``_margin_guard``."""
    import torch
    from repro_torch.core import ar_decode as AR

    for mode, (_, kw) in COMBINE_MODES.items():
        kw = dict(kw, combine=mode)
        a, _ = AR.guided_decode(model, toks, plan, graphs=False, **kw)
        b, _ = AR.guided_decode(model, toks, plan, **kw)
        la = AR.teacher_forced_logits(model, toks, plan, a, graphs=False, **kw)
        lb = AR.teacher_forced_logits(model, toks, plan, a, **kw)
        summary = _margin_guard(f"dgraphs {mode}", a, b, la, lb)
        log(f"[dgraphs] {mode} f=0.2, graphed against eager: teacher-forced logits bit-equal "
            f"{torch.equal(la, lb)}; {summary}")
        del la, lb
    torch.cuda.empty_cache()


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
    at f = 0.2, graphed and eager, the device-busy share of a generate (its
    kernel time under ``torch.profiler`` over its unprofiled wall); the
    graphs' capture times and pool bytes."""
    import torch
    from repro_torch.core import ar_decode as AR
    from repro_torch.core.selective import GuidancePlan
    from torch.profiler import ProfilerActivity, profile

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
    log(f"[dbreak] prefill, both streams: device {pre_dev:.3f} ms, wall {pre_wall:.3f} ms")
    log(f"[dbreak] FULL step at pos {pos}: device {full_dev:.3f} ms, eager wall {full_wall:.3f} "
        f"ms; COND step: device {cond_dev:.3f} ms, eager wall {cond_wall:.3f} ms; COND/FULL "
        f"device {cond_dev / full_dev:.3f}, eager wall {cond_wall / full_wall:.3f}")
    for r in rows:
        if r["f"] != 0.2:
            continue
        what = "graphed" if r["graphed"] else "eager"
        loop_s = r["mean_s"] - pre_wall / 1e3
        # kernel time of one whole generate under the profiler (its kernels'
        # durations do not depend on the host's pace), over the unprofiled wall
        with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            AR.guided_decode(model, toks, plan, graphs=None if r["graphed"] else False)
            torch.cuda.synchronize()
        kernel_s = sum(e.end_ns() - e.start_ns() for e in prof.profiler.kineto_results.events()
                       if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e9
        log(f"[dbreak] generate f=0.2 {what}: wall {r['mean_s']:.4f} s = prefill "
            f"{pre_wall / 1e3:.4f} s + decode loop {loop_s:.4f} s ({n_full} FULL + {n_cond} COND "
            f"steps, {loop_s / DECODE_NEW * 1e3:.3f} ms a step); kernel time {kernel_s:.4f} s "
            f"(profiled), device-busy share of the wall {kernel_s / r['mean_s']:.4f}")
    graphs = [(key, g) for loop in model._decode_loops.values() for key, g in loop.graphs.items()]
    log(f"[dbreak] {len(graphs)} decode graphs on {len(model._decode_loops)} static cache "
        f"set(s): " + "; ".join(f"{key[:2]} capture {g.capture_s * 1e3:.1f} ms (incl. its "
                                 f"eager first step), {sum(g.launches[4].values())} RMSNorm and "
                                 f"{sum(g.launches[1].values())} B5 launches a replay"
                                 for key, g in graphs)
        + f"; pool bytes reserved {sum(g.pool_bytes for _, g in graphs)}")


def _profile_share(by_name: dict, key: str) -> tuple[int, int]:
    """(ns, launches) summed over the profiled kernels whose name holds ``key``."""
    hits = [v for name, v in by_name.items() if key in name]
    return sum(t for t, _ in hits), sum(k for _, k in hits)


def phase_decode_profile(model, toks, combine_fn=None, what: str = "FULL",
                         graphed: bool = False) -> None:
    """The kernels that take a FULL decode step's device time under
    ``torch.profiler`` (combining with ``combine_fn`` if given, ``what``
    naming it; with ``graphed``, one replay of the step captured as a CUDA
    graph): summed device time by kernel, its share of the step's kernel
    time, and launches per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        step, _ = _decode_steps(model, toks, DECODE_S, combine_fn)
        step()
        torch.cuda.synchronize()
        if graphed:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step()
            step, what = graph.replay, f"{what} (graph replay)"
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


def _paged_case(gen, dtype, int8: bool, H: int = 32, K: int = 8, hd: int = 64, *,
                R: int = SERVE_R, ps: int = SERVE_PS, P: int = SERVE_PAGES, nb: int = SERVE_NB,
                inside_out_of_range: bool = True):
    """Inputs of the paged kernels, by default at the serve path's shapes
    (R rows, a pool of P pages of ps keys, tables of nb pages): positions
    spread over the tables' keys, every fourth row at phase 0, each row's
    live pages distinct pool pages (a few past the pool, which the kernels
    clamp to its last page, unless ``inside_out_of_range`` is off), the rest
    of its table past the pool."""
    import torch
    dev = gen.device
    pos = torch.linspace(0, nb * ps - 1, R, device=dev).round().int()
    phase = (torch.arange(R, device=dev) % 4 != 0).int()
    bt = torch.full((R, nb), P + 3, dtype=torch.int32, device=dev)
    perm = torch.randperm(P, generator=gen, device=dev).int()
    for r in range(R):
        live = int(pos[r]) // ps + 1
        bt[r, :live] = perm[(r * 37) % (P - live):][:live]
        if r % 3 == 1 and inside_out_of_range:
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


# (H, K, hd, window) past the serve shape: llama-class dense decoders, then
# mixtral-8x7b (window 4096) and chameleon-34b, which the paged arena serves
PAGED_SHAPES = ((40, 8, 128, None), (32, 4, 128, None), (32, 8, 120, None),
                (32, 8, 128, 4096), (64, 8, 128, None))


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
    # the other decoders' head groups take other instantiations: the dense
    # ones', mixtral's (its window) and chameleon's, which the paged arena
    # serves
    for H, K, hd, window in PAGED_SHAPES:
        for int8 in (False, True):
            q, kv, bt, pos, phase = _paged_case(gen, bf16, int8, H, K, hd)
            for name in [n for n in PAGED if n.endswith("int8") == int8]:
                tag = f"bf16 H={H} K={K} hd={hd} window={window}"
                out = _paged_call(KP, name, q, kv, bt, pos, phase, window=window)()
                ref = _paged_plain(KP, name, q, kv, bt, pos, phase, window=window)()
                e = _err_ok(name, tag, out, ref, per_row=ATTN_BF16_STEPS * BF16_STEP)
                errs[name] = max(errs[name], e[0])
                worst[name, bf16] = max(worst[name, bf16], e[1])
    log("[paged] all four at H/K/hd/window " + ", ".join(
        f"{H}/{K}/{hd}/{w}" for H, K, hd, w in PAGED_SHAPES) + " (bf16 q, bf16 and int8 "
        "pages): within tolerance")
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
    from (host float32 copies: a parity run only), graphed or eager."""
    from repro_torch.serve import ContinuousEngine

    class Recording(ContinuousEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.logits = {}

        def _draw(self, nxt, logits, uids, temps, keys, steps):
            # every sample, eager or after a replay, passes here; a copy,
            # since a replay rewrites the graph's logits
            host = logits[:len(uids)].float().cpu().clone()
            for i, uid in enumerate(uids):
                self.logits.setdefault(uid, []).append(host[i])
            return super()._draw(nxt, logits, uids, temps, keys, steps)

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
        log(f"[sparity] {tag}: {len(co)} requests, {ge.tick_count} ticks, events equal "
            f"({len(ge.metrics.trace.keys())}), {kern} x{gl[kern]} "
            f"(= {cfg.num_layers} layers x decode forwards); "
            + _serve_margin(f"sparity {tag}", ce, co, ge, go))


SERVE_LOGIT_TOL = 3e-2   # CPU vs GPU serve logits, of max|logit| (bf16 stacks, int8 pools)


def _serve_margin(tag, ea, oa, eb, ob, exempt=None, tol=SERVE_LOGIT_TOL) -> str:
    """Two recording engines' runs of one trace (outputs ``oa``, ``ob``):
    each request's logits within ``tol`` of max|logit| up to
    its first parting token, which must come at a step the logits do not
    decide; the token indices ``exempt[uid]`` are neither held nor
    decided. -> the log's summary."""
    import torch
    compared = total = equal = 0
    worst = 0.0
    bits = True
    for uid in oa:
        a, b = oa[uid], ob[uid]
        n = min(len(a), len(b))
        mis = next((i for i in range(n) if a[i] != b[i]), n)
        upto = min(mis + 1, n)
        la = torch.stack(ea.logits[uid][:upto])
        lb = torch.stack(eb.logits[uid][:upto])
        bits = bits and torch.equal(la, lb)
        big = la.abs().max().item()
        err = (lb - la).abs()
        ex = [i for i in sorted((exempt or {}).get(uid, ())) if i < upto]
        err[ex] = 0.0
        worst = max(worst, err.max().item() / big)
        if not err.max().item() <= tol * big:
            fail(f"{tag} {uid}: logits rel err {err.max().item() / big:.3g} > {tol}")
        top = la.argmax(-1, keepdim=True)
        gap = la.gather(-1, top) - la
        slack = err.gather(-1, top) + err
        undecided = ((gap <= slack) & (torch.arange(la.shape[-1]) != top)).any(-1)
        undecided[ex] = True
        if mis < n and not bool(undecided[mis]):
            fail(f"{tag} {uid}: tokens part at decided step {mis}: {a} vs {b}")
        compared += mis
        total += n
        equal += sum(x == y for x, y in zip(a, b))
    return (f"logits rel err {worst:.3g} (tol {tol}), bit-equal {bits}; tokens "
            f"equal on {compared} of {total} before any undecided parting, {equal} equal "
            f"overall")


def phase_serve_main():
    """``ContinuousEngine`` on llama3.2-1b at full width and depth. -> (model,
    launches per kernel summed over the graphed-default runs, rows)."""
    import torch
    from repro_torch.configs.llama3_2_1b import CONFIG as cfg
    from repro_torch.models.transformer import Transformer

    t0 = time.perf_counter()
    model = Transformer.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                             dtype=torch.bfloat16)
    torch.cuda.synchronize()
    arrivals = [i // 2 for i in range(16)]
    log(f"[smain] {cfg.name}: {cfg.num_layers} layers, bf16, init "
        f"{time.perf_counter() - t0:.2f} s; 16 requests, prompts {SERVE_LENS} cycling, "
        f"{SERVE_NEW} new tokens, scale {SERVE_SCALE}, greedy, two arriving at each of "
        f"ticks 0-7; pages of {SERVE_PS}, 8 slots, pass budget 16")
    runs = [("ragged", "bf16", 0.0, None), ("ragged", "bf16", 0.2, None),
            ("ragged", "bf16", 0.5, None), ("ragged", "int8", 0.2, None),
            ("signature", "bf16", 0.2, None), ("signature", "int8", 0.2, None),
            ("ragged", "bf16", 0.2, False), ("ragged", "int8", 0.2, False),
            ("signature", "bf16", 0.2, False), ("signature", "int8", 0.2, False)]
    totals, rows, census, warmed = {}, [], {}, set()
    for step_mode, kv_dtype, f, graphs in runs:
        def engine():
            return _serve_engine(model, cfg, step_mode, kv_dtype, f, graphs)
        if (step_mode, kv_dtype) not in warmed:
            # one warm-up a step mode and pool dtype (the script's time limit)
            warmed.add((step_mode, kv_dtype))
            engine().serve_trace(_serve_requests(cfg, 16, SERVE_LENS, SERVE_NEW, 0), arrivals)
        eng = engine()
        what = f"{step_mode} {kv_dtype} f={f} {'graphed' if eng.graphs else 'eager'}"
        reqs = _serve_requests(cfg, 16, SERVE_LENS, SERVE_NEW, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t1 = time.perf_counter()
        out = eng.serve_trace(reqs, arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = launch_counts()
        m = eng.metrics
        tokens = sum(len(v) for v in out.values())
        if len(out) != 16 or any(len(v) != SERVE_NEW for v in out.values()) or not all(
                0 <= t < cfg.vocab_size for v in out.values() for t in v):
            fail(f"smain {what}: results {len(out)} requests, lengths "
                 f"{sorted({len(v) for v in out.values()})}")
        if eng.pages.n_free != eng.pages.num_pages:
            fail(f"smain {what}: pool not balanced at drain")
        kern = _paged_kernel_of(step_mode, kv_dtype)
        want = cfg.num_layers * _decode_forwards(m, step_mode)
        others = sum(counts[n] for n in PAGED if n != kern)
        captures = len(eng._sig_graphs) + (eng._ragged_graph is not None)
        if counts[kern] != want or others or captures != (m.step_compiles if eng.graphs else 0):
            fail(f"smain {what}: {kern} x{counts[kern]}, want {want} "
                 f"(= {cfg.num_layers} layers x decode forwards); other paged kernels x{others}; "
                 f"captures {captures} of {m.step_compiles} compiles")
        if graphs is None:        # the main path: the graphed default
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            for k, v in norm_census().items():
                census[k] = census.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated() / 1e9
        row = dict(step_mode=step_mode, kv_dtype=kv_dtype, f=f, graphed=eng.graphs, wall_s=wall,
                   tokens_per_s=tokens / wall, ticks=m.ticks, passes=m.denoiser_passes,
                   prefill_passes=m.prefill_passes, reclaimed=m.pages_reclaimed,
                   peak_pages=m.peak_pages_in_use, peak_bytes=m.peak_bytes_in_use,
                   step_launches=m.step_launches, peak_gb=peak)
        rows.append(row)
        log(f"[smain] {what}: wall {wall:.4f} s, {tokens / wall:.1f} "
            f"tokens/s, ticks {m.ticks}, denoiser passes {m.denoiser_passes}, prefill passes "
            f"{m.prefill_passes}, pages reclaimed {m.pages_reclaimed}, peak pages "
            f"{m.peak_pages_in_use}, peak bytes {m.peak_bytes_in_use}, step launches "
            f"{m.step_launches} (compiles {m.step_compiles}), launches "
            f"{ {k: v for k, v in counts.items() if v} }, peak device memory {peak:.2f} GB; "
            f"first tokens {out['q0'][:6]}" + (f"; {_graph_summary(eng)}" if eng.graphs else ""))
    if sum(census.values()) != totals["rmsnorm"]:
        fail(f"smain: rmsnorm census {census} against {totals['rmsnorm']} launches")
    log(f"[smain] rmsnorm launches by rows x dim over the six graphed runs: "
        f"{census_summary(census)}")
    return model, totals, rows


def _serve_engine(model, cfg, step_mode, kv_dtype, f, graphs=None, cls=None, lazy_pages=None,
                  **extra):
    """The serve main path's engine (phase 13's configuration); with
    ``lazy_pages``, lazy reservation on a pool of that many pages; ``extra``
    overrides or adds engine options."""
    from repro_torch.serve import ContinuousEngine
    lazy = {} if lazy_pages is None else dict(reservation="lazy", num_pages=lazy_pages)
    kw = dict(kv="paged", page_size=SERVE_PS, num_slots=8, pass_budget=16, prompt_len=512,
              max_new=SERVE_NEW, stop_on_eos=False, prefills_per_tick=2, seed=0,
              selective_fraction=f, step_mode=step_mode, kv_dtype=kv_dtype, graphs=graphs,
              **lazy)
    kw.update(extra)
    return (cls or ContinuousEngine)(model, cfg, **kw)


def _shallow(model, n: int):
    """The first ``n`` layers of ``model`` as a model of their own, on the
    same weight tensors (nothing copied)."""
    import dataclasses

    from repro_torch.models.transformer import Transformer
    keep = {k: t for k, t in model.state_dict().items()
            if not k.startswith("layers.") or int(k.split(".")[1]) < n}
    return Transformer.from_state_dict(dataclasses.replace(model.cfg, num_layers=n), keep)


def phase_serve_graphs(model) -> None:
    """Graphed against eager on the serve main path's trace at f = 0.2:
    ragged bf16 and int8 at full depth, and the signature step bf16 and
    int8 on the model's first two layers (phase 13 times both signature
    runs at full depth): event streams equal, ``step_compiles`` equal (1
    for ragged, a capture a signature bucket), tokens equal up to the first
    step that the two runs' logits do not decide (phase 12's guard), logits
    within ``SERVE_LOGIT_TOL``, the paged kernel's launches exact."""
    import torch
    from repro_torch.configs.llama3_2_1b import CONFIG as cfg

    Recording = _recording_engine()
    arrivals = [i // 2 for i in range(16)]
    small = _shallow(model, 2)
    cases = [("ragged", "bf16", model), ("ragged", "int8", model),
             ("signature", "bf16", small), ("signature", "int8", small)]
    for step_mode, kv_dtype, m in cases:
        runs = {}
        for graphs in (False, None):
            eng = _serve_engine(m, m.cfg, step_mode, kv_dtype, 0.2, graphs, Recording)
            reset_launches()
            out = eng.serve_trace(_serve_requests(cfg, 16, SERVE_LENS, SERVE_NEW, 0), arrivals)
            torch.cuda.synchronize()
            runs[eng.graphs] = (eng, out, launch_counts())
        (ee, eo, el), (ge, go, gl) = runs[False], runs[True]
        tag = f"sgraphs {step_mode} {kv_dtype} f=0.2 x{m.cfg.num_layers} layers"
        kern = _paged_kernel_of(step_mode, kv_dtype)
        want = m.cfg.num_layers * _decode_forwards(ge.metrics, step_mode)
        if ee.metrics.trace.keys() != ge.metrics.trace.keys():
            fail(f"{tag}: event streams differ")
        compiles = (ee.metrics.step_compiles, ge.metrics.step_compiles)
        captures = len(ge._sig_graphs) + (ge._ragged_graph is not None)
        if compiles[0] != compiles[1] or (step_mode == "ragged" and compiles[0] != 1) \
                or captures != compiles[1] or el[kern] != want or gl[kern] != want:
            fail(f"{tag}: step_compiles eager/graphed {compiles}, captures {captures}, {kern} "
                 f"x{el[kern]}/x{gl[kern]} (want {want})")
        log(f"[sgraphs] {step_mode} {kv_dtype} f=0.2 x{m.cfg.num_layers} layers, graphed "
            f"against eager: {len(eo)} requests, {ge.tick_count} ticks, events equal "
            f"({len(ge.metrics.trace.keys())}), step_compiles {compiles[0]} and {compiles[1]}, "
            f"{kern} x{want} both; " + _serve_margin(tag, ee, eo, ge, go))
        del runs, ee, ge
    torch.cuda.empty_cache()


def phase_serve_profile(model, step_mode: str = "ragged", kv_dtype: str = "bf16",
                        graphs: bool | None = None) -> None:
    """Where a steady serve tick's time goes (f = 0.2, ticks 20-49, eight
    requests in flight and no admissions; the ragged bf16 step, graphed, by
    default): the wall and its phases from the engine's tick timer over
    ticks 20-39, then the kernels' device time over ticks 40-49 under
    ``torch.profiler`` (a graph's replays included), and the busy share,
    device time over wall; B6's share and the paged kernel's."""
    import torch
    from repro_torch.configs.llama3_2_1b import CONFIG as cfg

    eng = _serve_engine(model, cfg, step_mode, kv_dtype, 0.2, graphs)
    what = f"{step_mode} {'graphed' if eng.graphs else 'eager'}"
    wall, seg, by_name, n = _steady_ticks(eng, _serve_requests(cfg, 16, SERVE_LENS, SERVE_NEW, 0),
                                          [i // 2 for i in range(16)])
    total = sum(t_ for t_, _ in by_name.values())
    log(f"[sprofile] steady {what} tick ({kv_dtype}, f=0.2, 8 requests in flight): wall "
        f"{wall * 1e3:.3f} ms, of which " + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in seg.items()))
    if not total:
        log("[sprofile] device time not measured: the profiler saw no device time")
        return
    dev_ms = total / 1e6 / 10
    log(f"[sprofile] {n / 10:.0f} kernel launches and {dev_ms:.3f} ms of kernel time per tick "
        f"(profiled); device-busy share of the unprofiled wall {dev_ms / (wall * 1e3):.4f}")
    if eng._ragged_graph is not None:
        # the last tick's graph again on its own rows (the same K/V writes):
        # the card's time for a replay, its kernels and the gaps between them
        graph = eng._ragged_graph.graph
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            graph.replay()
        end.record()
        end.synchronize()
        replay_ms = start.elapsed_time(end) / 20
        log(f"[sprofile] one replay of the ragged graph: {replay_ms:.3f} ms on the device "
            f"(events, 20 replays), kernel time {dev_ms / replay_ms:.3f} of it; the host's "
            f"staging, sampling and harvest {wall * 1e3 - replay_ms:.3f} ms of the wall")
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


# -- the slot arena, lazy reservation and the facade (phases 18-22) -------------------

SLOT_S, SLOT_NEW = 512, 128                                  # the slot main path
LAZY_LENS = tuple(n - 8 for n in SERVE_LENS)                 # ends the prefix mid-page
LAZY_PRIOS, LAZY_RATE, LAZY_SEED = (0, 2, 1), 1.0, 0


def phase_slot_kernel() -> dict:
    """B5's per-row form (the slot arena's step: a position and a cache row
    a query row) against its plain version at the slot main path's shape:
    8 query rows on a pool of 9 rows (8 slots and the spare) of capacity
    640, positions spread over [512, 639], H 32, K 8, hd 64, bf16 and
    float32, without and with a window of 256, the rows in order and
    permuted with a padding row on the spare; timed (bf16, rows 0-7) beside
    its bound, its plain version and SDPA with a per-row boolean mask. ->
    {"decode_attention_rows": row}"""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as KD

    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(11)
    B, N, cap, H, K, hd = 8, 9, SLOT_S + SLOT_NEW, 32, 8, 64
    pos = torch.linspace(SLOT_S, cap - 1, B, device=dev).round().to(torch.int32)
    in_order = torch.arange(B, dtype=torch.int32, device=dev)
    permuted = torch.tensor([5, 0, 7, 2, 8, 3, 1, 6], dtype=torch.int32, device=dev)
    err, worst = 0.0, {}
    for dtype in (bf16, f32):
        q = torch.randn(B, H, hd, generator=gen, device=dev).to(dtype)
        k = torch.randn(N, cap, K, hd, generator=gen, device=dev).to(dtype)
        v = torch.randn(N, cap, K, hd, generator=gen, device=dev).to(dtype)
        for rows in (in_order, permuted):
            for window in (None, 256):
                reset_launches()
                out = KD.decode_attention(q, k, v, pos, window=window, rows=rows)
                r = rows.long()
                ref = KD.decode_attention_plain(q, k[r], v[r], pos, window=window)
                tag = (f"B={B} rows of {N} capacity={cap} pos {pos.tolist()} rows "
                       f"{rows.tolist()} window={window} {str(dtype)[6:]}")
                e = _err_ok("decode_attention_rows", tag, out, ref,
                            per_row=ATTN_BF16_STEPS * BF16_STEP if dtype == bf16 else 1e-5)
                if KD.LAUNCH_FORMS != {"rows": 1}:
                    fail(f"decode_attention_rows {tag}: launches {KD.LAUNCH_FORMS}")
                err = max(err, e[0])
                worst[dtype] = max(worst.get(dtype, 0.0), e[1])
        # one position for the batch, written as one a row, is the batch form
        one = KD.decode_attention(q[:4], k[:4], v[:4], pos[:1])
        same = KD.decode_attention(q[:4], k[:4], v[:4], pos[:1].repeat(4))
        torch.cuda.synchronize()
        if not torch.equal(one, same):
            fail(f"decode_attention_rows {str(dtype)[6:]}: a repeated position differs from "
                 "the batch form")
    log(f"[slotkern] decode_attention_rows: largest error over its row's max|out| "
        f"bf16 {worst[bf16]:.3g} ({worst[bf16] / BF16_STEP:.2f} bf16 steps), f32 "
        f"{worst[f32]:.3g}; a repeated position bit-equal to the batch form")
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(bf16)
    k = torch.randn(N, cap, K, hd, generator=gen, device=dev).to(bf16)
    v = torch.randn(N, cap, K, hd, generator=gen, device=dev).to(bf16)
    kt, vt = k[:B].transpose(1, 2).contiguous(), v[:B].transpose(1, 2).contiguous()
    mask = (torch.arange(cap, device=dev)[None] <= pos[:, None])[:, None, None, :]
    r = in_order.long()
    (ms, host_ms), (plain_ms, _) = (
        time_ms(lambda: KD.decode_attention(q, k, v, pos, rows=in_order)),
        time_ms(lambda: KD.decode_attention_plain(q, k[r], v[r], pos)))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True))[0]
    keys = int((pos.long() + 1).sum())
    nbytes = 2 * (2 * B * H * hd + 2 * keys * K * hd) + 8 * B
    b_ms, b_by = bound_ms(nbytes, 4 * H * hd * keys, H100_BF16_FLOPS)
    log(f"[slotkern] decode_attention_rows B={B} rows 0-7 of {N}, capacity={cap}, pos "
        f"{pos.tolist()}, H={H} K={K} hd={hd} bf16: device time kernel {ms * 1e3:.2f} us "
        f"(host {host_ms * 1e3:.2f} us/call), plain {plain_ms * 1e3:.2f} us, SDPA with a "
        f"per-row mask {lib_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({b_by}: {nbytes} B)")
    fam_rows, fam_ring = _slot_family_kernels(gen)
    ring = _slot_ring_kernel(gen)
    ring["max_abs_err"] = max(ring["max_abs_err"], fam_ring)
    return {"decode_attention_rows": dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                          bound_ms=b_ms, bound_by=b_by,
                                          max_abs_err=max(err, fam_rows)),
            "decode_attention_ring_rows": ring}


# the families' slot arena shapes of B5: (H, K, hd, window), per row on
# linear rows (mixtral-8x7b under its window of 4096, chameleon-34b, and
# recurrentgemma-9b's local attention, whose window of 2048 is over
# [fserve]'s capacity), and a ring a row (recurrentgemma-9b past its
# window: W 2048, one kv head)
SLOT_FAMILY_ROWS = ((32, 8, 128, 4096), (64, 8, 128, None), (16, 1, 256, 2048))
SLOT_FAMILY_RING = (16, 1, 256, 2048)


def _slot_family_kernels(gen) -> tuple[float, float]:
    """B5's per-row form at mixtral's, chameleon's and recurrentgemma's
    heads, the shapes ``[fserve]`` gives it (8 query rows on 9 rows of its
    capacity, ``FSERVE_S`` + ``FSERVE_NEW``, positions over its decode
    span, rows permuted with a padding row on the spare), and its
    ring-a-row form at recurrentgemma's (9 rings of 2048 slots, positions
    past the window so that every ring has wrapped; no run of this script
    serves past that window), against their plain versions in bf16 at the
    bf16 tolerance. -> the largest absolute errors (per row, ring a row)"""
    import torch
    from repro_torch.kernels import decode_attention as KD

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    B, N, cap = 8, 9, FSERVE_S + FSERVE_NEW
    rows = torch.tensor([5, 0, 7, 2, 8, 3, 1, 6], dtype=torch.int32, device=dev)
    err, notes = 0.0, []
    for H, K, hd, window in SLOT_FAMILY_ROWS:
        pos = torch.linspace(FSERVE_S, cap - 1, B, device=dev).round().to(torch.int32)
        q = torch.randn(B, H, hd, generator=gen, device=dev).to(bf16)
        k = torch.randn(N, cap, K, hd, generator=gen, device=dev).to(bf16)
        v = torch.randn(N, cap, K, hd, generator=gen, device=dev).to(bf16)
        reset_launches()
        out = KD.decode_attention(q, k, v, pos, window=window, rows=rows)
        ref = KD.decode_attention_plain(q, k[rows.long()], v[rows.long()], pos, window=window)
        tag = f"rows H={H} K={K} hd={hd} window={window} capacity={cap}"
        e = _err_ok("decode_attention_rows", tag, out, ref, per_row=ATTN_BF16_STEPS * BF16_STEP)
        if KD.LAUNCH_FORMS != {"rows": 1}:
            fail(f"decode_attention_rows {tag}: launches {KD.LAUNCH_FORMS}")
        err = max(err, e[0])
        notes.append(f"rows {H}/{K}/{hd}/{window}: {e[1] / BF16_STEP:.2f} bf16 steps")
    H, K, hd, W = SLOT_FAMILY_RING
    pos = torch.linspace(W + 64, W + 63 + FSERVE_NEW, B, device=dev).round().to(torch.int32)
    slot_pos = torch.full((N, W), -1, dtype=torch.int32, device=dev)
    for b in range(B):
        slot_pos[b] = _ring_slots(W, int(pos[b]), gen)
    p = torch.where(rows == N - 1, 0, pos[rows.long().clamp(max=B - 1)]).to(torch.int32)
    slot_pos[N - 1, 0] = 0             # the padding row's write at pos 0
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(bf16)
    k = torch.randn(N, W, K, hd, generator=gen, device=dev).to(bf16)
    v = torch.randn(N, W, K, hd, generator=gen, device=dev).to(bf16)
    reset_launches()
    out = KD.decode_attention(q, k, v, p, window=W, slot_pos=slot_pos, rows=rows)
    r = rows.long()
    ref = KD.decode_attention_plain(q, k[r], v[r], p,
                                    valid=KD.ring_valid(slot_pos[r], p[:, None], W))
    tag = f"ring rows H={H} K={K} hd={hd} W={W}"
    e = _err_ok("decode_attention_ring_rows", tag, out, ref,
                per_row=ATTN_BF16_STEPS * BF16_STEP)
    if KD.LAUNCH_FORMS != {"ring_rows": 1}:
        fail(f"decode_attention_ring_rows {tag}: launches {KD.LAUNCH_FORMS}")
    notes.append(f"ring rows {H}/{K}/{hd}/W {W}: {e[1] / BF16_STEP:.2f} bf16 steps")
    log("[slotkern] the families' shapes (H/K/hd/window, bf16, rows permuted with a padding "
        "row on the spare): " + "; ".join(notes))
    return err, e[0]


def _slot_ring_kernel(gen) -> dict:
    """B5's ring-a-row form (a windowed slot arena's step: a ring, a
    position and a cache row a query row) against its plain version at the
    windowed slot phase's shape: 8 query rows on a pool of 9 rings (8 slots
    and the spare) of ``RING_WINDOW`` slots, h2o-danube-3-4b's heads (H 32,
    K 8, hd 120), positions spread over [RING_PROMPT, RING_PROMPT + 127]
    (every ring wrapped, eight slots of each emptied), the rows in order and
    permuted with a padding row on the empty spare ring, bf16 and float32;
    timed (bf16, rows 0-7) beside its bound, its plain version and SDPA
    with each row's ring mask. -> its kernel-line row"""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as KD

    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    B, N, W, H, K, hd = 8, 9, RING_WINDOW, 32, 8, 120
    pos = torch.linspace(RING_PROMPT, RING_PROMPT + W - 1, B, device=dev).round().to(
        torch.int32)
    slot_pos = torch.full((N, W), -1, dtype=torch.int32, device=dev)
    for b in range(B):
        slot_pos[b] = _ring_slots(W, int(pos[b]), gen)
    in_order = torch.arange(B, dtype=torch.int32, device=dev)
    permuted = torch.tensor([5, 0, 7, 2, 8, 3, 1, 6], dtype=torch.int32, device=dev)
    err, worst = 0.0, {}
    for dtype in (bf16, f32):
        q = torch.randn(B, H, hd, generator=gen, device=dev).to(dtype)
        k = torch.randn(N, W, K, hd, generator=gen, device=dev).to(dtype)
        v = torch.randn(N, W, K, hd, generator=gen, device=dev).to(dtype)
        for rows in (in_order, permuted):
            # a padding row (on the spare) reads the spare's empty ring at pos 0
            p = torch.where(rows == N - 1, 0, pos[rows.long().clamp(max=B - 1)]).to(torch.int32)
            sp = slot_pos.clone()
            sp[N - 1, 0] = 0            # as the step's write at pos 0 leaves it
            reset_launches()
            out = KD.decode_attention(q, k, v, p, window=W, slot_pos=sp, rows=rows)
            r = rows.long()
            ref = KD.decode_attention_plain(q, k[r], v[r], p,
                                            valid=KD.ring_valid(sp[r], p[:, None], W))
            tag = (f"ring rows B={B} of {N} rings of {W}, pos {p.tolist()} rows "
                   f"{rows.tolist()} {str(dtype)[6:]}")
            e = _err_ok("decode_attention_ring_rows", tag, out, ref,
                        per_row=ATTN_BF16_STEPS * BF16_STEP if dtype == bf16 else 1e-5)
            if KD.LAUNCH_FORMS != {"ring_rows": 1}:
                fail(f"decode_attention_ring_rows {tag}: launches {KD.LAUNCH_FORMS}")
            err = max(err, e[0])
            worst[dtype] = max(worst.get(dtype, 0.0), e[1])
    log(f"[slotkern] decode_attention_ring_rows: largest error over its row's max|out| "
        f"bf16 {worst[bf16]:.3g} ({worst[bf16] / BF16_STEP:.2f} bf16 steps), f32 "
        f"{worst[f32]:.3g}")
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(bf16)
    k = torch.randn(N, W, K, hd, generator=gen, device=dev).to(bf16)
    v = torch.randn(N, W, K, hd, generator=gen, device=dev).to(bf16)
    kt, vt = k[:B].transpose(1, 2).contiguous(), v[:B].transpose(1, 2).contiguous()
    valid = KD.ring_valid(slot_pos[:B], pos[:, None], W)
    mask = valid[:, None, None, :]
    r = in_order.long()
    (ms, host_ms), (plain_ms, _) = (
        time_ms(lambda: KD.decode_attention(q, k, v, pos, window=W, slot_pos=slot_pos,
                                            rows=in_order)),
        time_ms(lambda: KD.decode_attention_plain(
            q, k[r], v[r], pos, valid=KD.ring_valid(slot_pos[r], pos[:, None], W))))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True))[0]
    keys = int(valid.sum())
    nbytes = 2 * (2 * B * H * hd + 2 * keys * K * hd) + 4 * B * W + 8 * B
    b_ms, b_by = bound_ms(nbytes, 4 * H * hd * keys, H100_BF16_FLOPS)
    log(f"[slotkern] decode_attention_ring_rows B={B} rows 0-7 of {N} rings of {W}, pos "
        f"{pos.tolist()} ({keys} live keys), H={H} K={K} hd={hd} bf16: device time kernel "
        f"{ms * 1e3:.2f} us (host {host_ms * 1e3:.2f} us/call), plain {plain_ms * 1e3:.2f} us, "
        f"SDPA with each row's ring mask {lib_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us "
        f"({b_by}: {nbytes} B)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err)


def _lazy_trace(cfg, lens, n: int, new: int, arrivals, seed: int):
    """-> (engine requests, simulator requests) of one lazy trace: prompts
    cycling through ``lens``, priorities through ``LAZY_PRIOS``, the plan
    of ``_serve_engine``'s f = 0.2 (``selective_fraction`` 0.2)."""
    import dataclasses
    from repro_torch.core.selective import GuidancePlan
    from repro_torch.serve import SimRequest

    reqs = [dataclasses.replace(r, priority=LAZY_PRIOS[i % len(LAZY_PRIOS)])
            for i, r in enumerate(_serve_requests(cfg, n, lens, new, seed))]
    plan = GuidancePlan.suffix(new, 0.2, SERVE_SCALE)
    sims = [SimRequest(r.uid, int(a), plan, prompt_len=r.prompt_len, priority=r.priority)
            for r, a in zip(reqs, arrivals)]
    return reqs, sims


def _lazy_pool(sims, hi: int, preempts: int, step: int = 1, **kw):
    """The largest pool, from ``hi`` pages down by ``step``, in which the
    port's simulator serves ``sims`` to the end with at least ``preempts``
    preemptions and one copy-on-write. -> (pages, the simulator's metrics)"""
    from repro_torch.serve import simulate
    for n in range(hi, 0, -step):
        m = simulate(sims, num_pages=n, reservation="lazy", kv="paged", **kw).metrics
        if m.preemptions >= preempts and m.cow_copies and m.completed == len(sims):
            return n, m
    fail(f"no pool of at most {hi} pages preempts {preempts} times and copies on write")


LAZY_COUNTERS = ("pages_grown", "preemptions", "resumes", "shared_page_hits", "cow_copies",
                 "pages_reclaimed", "peak_pages_in_use", "completed", "denoiser_passes",
                 "prefill_passes", "tokens_emitted", "ticks")


def _engine_equals_sim(tag, em, sm) -> None:
    if em.trace.keys() != sm.trace.keys():
        fail(f"{tag}: the engine's events differ from the simulator's")
    diff = {k: (getattr(em, k), getattr(sm, k)) for k in LAZY_COUNTERS
            if getattr(em, k) != getattr(sm, k)}
    if diff:
        fail(f"{tag}: engine != simulator counters {diff}")


def phase_slot_parity():
    """The slot arena and lazy reservation at full width, 2 layers, CPU
    (plain versions) against GPU (kernels): events equal, tokens equal up to
    the first step the logits do not decide, B5's per-row launches and the
    paged kernels' exact; the lazy runs' counters equal the simulator's."""
    import dataclasses

    import torch
    from repro_torch.configs.llama3_2_1b import CONFIG
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import simulate

    cfg = dataclasses.replace(CONFIG, num_layers=2)
    cpu = Transformer.init(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                           device="cpu")
    gpu = Transformer.from_state_dict(cfg, {k: t.cuda() for k, t in cpu.state_dict().items()})
    Recording = _recording_engine()
    lens, new, arrivals = (24, 40, 17, 33), 12, [0, 0, 1, 1, 2, 3]
    base = dict(num_slots=4, pass_budget=6, prompt_len=48, max_new=new, stop_on_eos=False,
                prefills_per_tick=2, seed=0, selective_fraction=0.2)
    _, sims = _lazy_trace(cfg, lens, len(arrivals), new, arrivals, 7)
    pages, _ = _lazy_pool(sims, 2 * 4 * 4, 1, num_slots=4, pass_budget=6, page_size=16,
                          prefills_per_tick=2)
    cases = [("slot", "signature", "bf16"), ("lazy", "ragged", "bf16"),
             ("lazy", "ragged", "int8"), ("lazy", "signature", "bf16")]
    for arena, step_mode, kv_dtype in cases:
        if arena == "slot":
            kw = dict(base, kv="slot")
            make = lambda: [dataclasses.replace(r, prompt_len=None)  # noqa: E731
                            for r in _lazy_trace(cfg, lens, len(arrivals), new, arrivals, 7)[0]]
        else:
            kw = dict(base, kv="paged", page_size=16, num_pages=pages, reservation="lazy",
                      step_mode=step_mode, kv_dtype=kv_dtype)
            make = lambda: _lazy_trace(cfg, lens, len(arrivals), new, arrivals, 7)[0]  # noqa: E731
        runs = {}
        for side, model in (("cpu", cpu), ("gpu", gpu)):
            eng = Recording(model, cfg, **kw)
            reset_launches()
            out = eng.serve_trace(make(), arrivals)
            torch.cuda.synchronize()
            runs[side] = (eng, out, launch_counts())
        (ce, co, cl), (ge, go, gl) = runs["cpu"], runs["gpu"]
        tag = f"{arena} step_mode={step_mode} kv_dtype={kv_dtype}"
        if ce.metrics.trace.keys() != ge.metrics.trace.keys():
            fail(f"slotparity {tag}: event streams differ")
        fwd = cfg.num_layers * _decode_forwards(ge.metrics, step_mode)
        if arena == "slot":
            want = {"decode_attention": fwd}
        else:
            want = {_paged_kernel_of(step_mode, kv_dtype): fwd}
            sm = simulate(sims, num_pages=pages, reservation="lazy", kv="paged", num_slots=4,
                          pass_budget=6, page_size=16, prefills_per_tick=2, kv_dtype=kv_dtype,
                          step_mode=step_mode).metrics
            _engine_equals_sim(f"slotparity {tag}", ge.metrics, sm)
            if not ge.metrics.preemptions or not ge.metrics.cow_copies:
                fail(f"slotparity {tag}: no preemption or copy-on-write")
        attn = {k: v for k, v in gl.items() if v and ("decode_attention" in k)}
        if sum(cl.values()) != 0 or attn != want:
            fail(f"slotparity {tag}: launches CPU {cl}, GPU {gl}; want {want}")
        log(f"[slotparity] {tag}: {len(co)} requests, {ge.tick_count} ticks, events equal "
            f"({len(ge.metrics.trace.keys())}), {attn}, preemptions {ge.metrics.preemptions}, "
            f"copies on write {ge.metrics.cow_copies} (pool {pages if arena == 'lazy' else '-'} "
            f"pages); " + _serve_margin(f"slotparity {tag}", ce, co, ge, go))


def _graph_summary(eng) -> str:
    """An engine's captured steps: each capture's key, ms and pool bytes,
    and their totals."""
    graphs = dict(eng._sig_graphs)
    if eng._ragged_graph is not None:
        graphs[("rstep", eng.ragged_rows)] = eng._ragged_graph
    each = ", ".join(f"{k} {g.capture_s * 1e3:.1f} ms {g.pool_bytes} B"
                     for k, g in sorted(graphs.items()))
    return (f"{len(graphs)} captures, {sum(g.capture_s for g in graphs.values()) * 1e3:.1f} ms "
            f"and {sum(g.pool_bytes for g in graphs.values())} pool bytes in all ({each})")


def _steady_ticks(eng, reqs, arrivals) -> tuple:
    """A steady stretch of a 16-request trace (ticks 20-49: eight requests
    in flight, no admissions): the wall a tick and its phases from the
    engine's tick timer over ticks 20-39, then ticks 40-49 under
    ``torch.profiler`` (a graph's replays included). -> (wall s a tick,
    {phase: s}, {kernel name: (ns, launches)} over the 10 profiled ticks,
    kernel launches)"""
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    return wall, seg, by_name, n


def phase_slot_main(model) -> dict:
    """The slot arena (the engine's default) on llama3.2-1b at full width
    and depth: phase 13's 16 requests, padded to prompts of 512, 128 new
    tokens, two arriving a tick, 8 slots, pass budget 16 (phase 13's), f =
    0.2. First two requests graphed and eager, their logits bit-equal (the
    warm-up too); then the trace with the signature step graphed (the
    default) and eager (``graphs=False``): wall, tokens/s, each capture's
    ms and pool bytes, B5's per-row and B4's launches exact; then the busy
    share of a steady tick of each; then the host's cost of the draws at
    temperature 0.7 (``_draw_host``). -> launches per kernel of the graphed
    run."""
    import dataclasses

    import torch
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.serve import ContinuousEngine

    cfg = model.cfg
    arrivals = [i // 2 for i in range(16)]

    def reqs(n):
        return [dataclasses.replace(r, prompt_len=None)
                for r in _serve_requests(cfg, n, SERVE_LENS, SLOT_NEW, 0)]

    def engine(graphs, cls=ContinuousEngine):
        return cls(model, cfg, num_slots=8, pass_budget=16, prompt_len=SLOT_S,
                   max_new=SLOT_NEW, stop_on_eos=False, prefills_per_tick=2, seed=0,
                   selective_fraction=0.2, graphs=graphs)
    Recording = _recording_engine()
    runs = {}
    for graphs in (None, False):
        eng = engine(graphs, Recording)
        out = eng.serve_trace(reqs(2), [0, 0])
        torch.cuda.synchronize()
        runs[eng.graphs] = (eng, out)
    (ge, go), (ee, eo) = runs[True], runs[False]
    bits = go == eo and ge.logits.keys() == ee.logits.keys() and all(
        len(ge.logits[u]) == len(ee.logits[u])
        and all(torch.equal(a, b) for a, b in zip(ge.logits[u], ee.logits[u])) for u in eo)
    if ge.metrics.trace.keys() != ee.metrics.trace.keys() or not bits:
        fail(f"slotmain: two requests graphed and eager differ (tokens equal {go == eo}, "
             f"logits bit-equal {bits})")
    log(f"[slotmain] two requests graphed and eager: events equal, tokens equal, logits "
        f"bit-equal over {sum(len(v) for v in ge.logits.values())} samples; graphed "
        f"{_graph_summary(ge)}")
    del runs, ge, ee
    totals, walls = None, {}
    for graphs in (None, False):
        eng = engine(graphs)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = eng.serve_trace(reqs(16), arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, forms = launch_counts(), dict(KD.LAUNCH_FORMS)
        m = eng.metrics
        tokens = sum(len(v) for v in out.values())
        fwd = cfg.num_layers * _decode_forwards(m, "signature")
        want = {"decode_attention": fwd, "flash_attention": 2 * cfg.num_layers * 16}
        got = {k: counts[k] for k in want}
        what = "graphed" if eng.graphs else "eager"
        if len(out) != 16 or any(len(v) != SLOT_NEW for v in out.values()) or got != want \
                or forms != {"rows": fwd} or any(counts[n] for n in PAGED) \
                or len(eng._sig_graphs) != (m.step_compiles if eng.graphs else 0):
            fail(f"slotmain {what}: {len(out)} results, launches {got} (want {want}), forms "
                 f"{forms}, captures {len(eng._sig_graphs)} of {m.step_compiles} compiles")
        walls[what] = wall
        log(f"[slotmain] {cfg.name} slot arena, 8 slots, pass budget 16, prompt_len {SLOT_S}, "
            f"{SLOT_NEW} new, f=0.2, signature step {what}: wall {wall:.4f} s, "
            f"{tokens / wall:.1f} tokens/s, ticks {m.ticks}, denoiser passes "
            f"{m.denoiser_passes}, step launches {m.step_launches} (compiles "
            f"{m.step_compiles}, shapes {sorted(k for k in eng._shapes if k[0] == 'step')}), "
            f"B5 per-row launches {forms['rows']} (= {cfg.num_layers} layers x decode "
            f"forwards), prefill B4 launches {counts['flash_attention']}, defrags "
            f"{int(('defrag',) in eng._shapes)}, kv {eng.kv_hbm_bytes()}; first tokens "
            f"{out['q0'][:6]}" + (f"; {_graph_summary(eng)}" if eng.graphs else ""))
        if eng.graphs:
            totals = _rows_form(counts)
        del eng
    log(f"[slotmain] graphed against eager: {walls['graphed']:.4f} against "
        f"{walls['eager']:.4f} s, {walls['eager'] / walls['graphed']:.3f}x")
    for graphs in (None, False):
        eng = engine(graphs)
        wall, seg, by_name, n = _steady_ticks(eng, reqs(16), arrivals)
        kern_ms = sum(t for t, _ in by_name.values()) / 1e6 / 10
        log(f"[slotmain] steady {'graphed' if eng.graphs else 'eager'} tick (8 requests in "
            f"flight): wall {wall * 1e3:.3f} ms (" + ", ".join(
                f"{k} {v * 1e3:.3f}" for k, v in seg.items()) + f"), {n / 10:.0f} kernels and "
            f"{kern_ms:.3f} ms of kernel time a tick (profiled): busy share "
            + (f"{kern_ms / (wall * 1e3):.4f}" if kern_ms else "not measured (no device time)"))
        del eng
    _draw_host(engine)
    return totals


def _draw_host(engine) -> None:
    """The host's cost of sampling at temperature > 0: 8 requests of the
    slot main path's trace at T = 0.7 (32 new tokens, all arriving at tick
    0), graphed and eager; the wall of every ``_draw`` call (a generator
    seeded per hot row, a softmax and a multinomial draw, all queued
    without waiting) a tick, beside the tick's wall (the graphed run's
    captures left out)."""
    import dataclasses

    import torch
    from repro_torch.serve import ContinuousEngine

    class Timed(ContinuousEngine):
        draw_s, draws = 0.0, 0

        def _draw(self, nxt, logits, uids, temps, keys, steps):
            t0 = time.perf_counter()
            out = super()._draw(nxt, logits, uids, temps, keys, steps)
            self.draw_s += time.perf_counter() - t0
            self.draws += 1
            return out
    for graphs in (None, False):
        eng = engine(graphs, Timed)
        reqs = [dataclasses.replace(r, prompt_len=None, temperature=0.7, max_new_tokens=32)
                for r in _serve_requests(eng.cfg, 8, SERVE_LENS, 32, 3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.serve_trace(reqs, [0] * 8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if len(out) != 8 or any(len(v) != 32 for v in out.values()):
            fail(f"draw host: {len(out)} results")
        ticks = eng.metrics.ticks
        wall -= sum(g.capture_s for g in eng._sig_graphs.values())
        log(f"[slotdraw] T=0.7, 8 requests, 32 new, {'graphed' if eng.graphs else 'eager'}: "
            f"{ticks} ticks, wall {wall * 1e3 / ticks:.3f} ms a tick (captures left out), of "
            f"which _draw {eng.draw_s * 1e3 / ticks:.3f} ms a tick ({eng.draws} calls, "
            f"{eng.draw_s / wall:.4f} of the wall)")


def _rows_form(counts: dict, form: str = "rows") -> dict:
    """A slot path's launch counts with B5's under its per-row form's name,
    ``decode_attention_<form>`` (every B5 launch there is one,
    ``LAUNCH_FORMS`` says)."""
    from repro_torch.kernels import decode_attention as KD
    out = dict(counts)
    n = out.pop("decode_attention")
    if n != KD.LAUNCH_FORMS.get(form, 0):
        fail(f"B5 launches {n} on a slot path, {form} {KD.LAUNCH_FORMS}")
    out["decode_attention_" + form] = n
    return out


def phase_ring_slot() -> dict:
    """A windowed model in the slot arena: h2o-danube-3-4b at full width
    (d_model 3840, hd 120), 2 layers, its window cut to ``RING_WINDOW``
    under prompts of ``RING_PROMPT``, so that every row of both pools is a
    ring; three requests, 8 new tokens, f = 0.5, on the CPU (plain
    versions) and the GPU (kernels, the signature step graphed): events
    equal, tokens equal up to the first step the logits do not decide, and
    every B5 launch the ring-a-row form's, one per layer and decode
    forward. -> launches per kernel of the GPU run."""
    import dataclasses

    import torch
    from repro_torch.configs.h2o_danube3_4b import CONFIG
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(CONFIG, num_layers=2, sliding_window=RING_WINDOW)
    t0 = time.perf_counter()
    cpu = Transformer.init(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                           device="cpu")
    gpu = Transformer.from_state_dict(cfg, {k: t.cuda() for k, t in cpu.state_dict().items()})
    Recording = _recording_engine()
    new, arrivals = 8, [0, 0, 1]
    kw = dict(num_slots=4, pass_budget=4, prompt_len=RING_PROMPT, max_new=new,
              stop_on_eos=False, prefills_per_tick=2, seed=0, selective_fraction=0.5)
    runs = {}
    for side, model in (("cpu", cpu), ("gpu", gpu)):
        eng = Recording(model, cfg, **kw)
        reset_launches()
        out = eng.serve_trace(_serve_requests(cfg, len(arrivals), (RING_PROMPT,), new, 9),
                              arrivals)
        torch.cuda.synchronize()
        runs[side] = (eng, out, launch_counts(), dict(KD.LAUNCH_FORMS))
    (ce, co, cl, _), (ge, go, gl, gf) = runs["cpu"], runs["gpu"]
    fwd = cfg.num_layers * _decode_forwards(ge.metrics, "signature")
    rings = all("slot_pos" in layer and layer["k"].shape[1] == RING_WINDOW
                for layer in ge._pool_c + ge._pool_u)
    if ce.metrics.trace.keys() != ge.metrics.trace.keys():
        fail("ringslot: event streams differ")
    if not rings or not ge.graphs or sum(cl.values()) or gl["decode_attention"] != fwd \
            or gf != {"ring_rows": fwd} or gl["flash_attention"] != 2 * cfg.num_layers * 3 \
            or len(ge._sig_graphs) != ge.metrics.step_compiles:
        fail(f"ringslot: rings {rings}, graphs {ge.graphs}, launches CPU {cl}, GPU {gl}, forms "
             f"{gf}; want decode_attention x{fwd} all ring_rows")
    log(f"[ringslot] {cfg.name} x{cfg.num_layers} layers, window {RING_WINDOW}, prompts "
        f"{RING_PROMPT}, {new} new, 3 requests, slot arena graphed: rings of {RING_WINDOW} in "
        f"every row, events equal ({len(ge.metrics.trace.keys())}), B5 ring-a-row launches "
        f"{gf['ring_rows']} (= {cfg.num_layers} layers x decode forwards), "
        f"{_graph_summary(ge)}; {time.perf_counter() - t0:.2f} s; "
        + _serve_margin("ringslot", ce, co, ge, go))
    out = dict(gl)
    out["decode_attention_ring_rows"] = out.pop("decode_attention")
    return out


def phase_lazy_main(model) -> dict:
    """Lazy reservation on the paged arena at full width and depth: 16
    requests from the port's ``poisson_arrivals`` (rate 1.0 a tick),
    prompts cycling ``LAZY_LENS``, priorities ``LAZY_PRIOS``, 128 new
    tokens, f = 0.2, pages of 16, the pool sized on the CPU by the port's
    simulator (the largest with two preemptions and a copy-on-write); bf16
    and int8, the ragged step graphed; the engine's counters and events
    equal the simulator's; TTFT and TPOT from ``ServeMetrics``. ->
    launches per kernel."""
    import torch
    from repro_torch.serve import poisson_arrivals, simulate

    cfg = model.cfg
    arrivals = [int(a) for a in poisson_arrivals(LAZY_SEED, n=16, rate=LAZY_RATE)]
    reqs, sims = _lazy_trace(cfg, LAZY_LENS, 16, SERVE_NEW, arrivals, 0)
    sim_kw = dict(num_slots=8, pass_budget=16, page_size=SERVE_PS, prefills_per_tick=2,
                  step_mode="ragged")
    t0 = time.perf_counter()
    pages, _ = _lazy_pool(sims, 2 * 8 * SERVE_NB, 2, SERVE_PS, **sim_kw)
    log(f"[lazymain] {cfg.name}: 16 requests arriving at ticks {arrivals} (poisson_arrivals "
        f"seed {LAZY_SEED}, rate {LAZY_RATE}), prompts {LAZY_LENS} cycling, priorities "
        f"{LAZY_PRIOS} cycling, {SERVE_NEW} new, f=0.2; pool of {pages} pages of {SERVE_PS} "
        f"(the simulator's choice in steps of {SERVE_PS}, {time.perf_counter() - t0:.2f} s on the "
        f"CPU)")
    totals = {}
    for kv_dtype in ("bf16", "int8"):
        def engine():
            return _serve_engine(model, cfg, "ragged", kv_dtype, 0.2, lazy_pages=pages)
        engine().serve_trace(_lazy_trace(cfg, LAZY_LENS, 2, 4, [0, 0], 1)[0], [0, 0])
        eng = engine()
        torch.cuda.synchronize()
        reset_launches()
        t1 = time.perf_counter()
        out = eng.serve_trace(_lazy_trace(cfg, LAZY_LENS, 16, SERVE_NEW, arrivals, 0)[0],
                              arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = launch_counts()
        m = eng.metrics
        sm = simulate(sims, num_pages=pages, reservation="lazy", kv="paged", kv_dtype=kv_dtype,
                      **sim_kw).metrics
        tag = f"lazymain ragged {kv_dtype}"
        _engine_equals_sim(tag, m, sm)
        kern = _paged_kernel_of("ragged", kv_dtype)
        want = cfg.num_layers * m.step_launches
        if m.preemptions < 2 or not m.cow_copies or counts[kern] != want or len(out) != 16 \
                or any(len(v) != SERVE_NEW for v in out.values()) or not eng.graphs \
                or eng.pages.n_free != eng.pages.num_pages:
            fail(f"{tag}: preemptions {m.preemptions}, copies on write {m.cow_copies}, {kern} "
                 f"x{counts[kern]} (want {want}), {len(out)} results, graphs {eng.graphs}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        s = m.summary()
        tick_ms = 1e3 * m.wall_s / max(m.ticks, 1)
        tokens = sum(len(v) for v in out.values())
        log(f"[lazymain] ragged {kv_dtype} graphed: wall {wall:.4f} s, {tokens / wall:.1f} "
            f"tokens/s, ticks {m.ticks} ({tick_ms:.3f} ms a tick), engine == simulator: "
            f"preemptions {m.preemptions}, resumes {m.resumes}, copies on write "
            f"{m.cow_copies}, pages grown {m.pages_grown}, shared page hits "
            f"{m.shared_page_hits}, peak pages {m.peak_pages_in_use}, prefill passes "
            f"{m.prefill_passes}, denoiser passes {m.denoiser_passes}; TTFT ticks p50 "
            f"{s['ttft']['p50']} p99 {s['ttft']['p99']}, TPOT ticks p50 {s['tpot']['p50']} "
            f"p99 {s['tpot']['p99']} (log2 buckets), tick_s p50 {s['tick_s']['p50']} p99 "
            f"{s['tick_s']['p99']}; {kern} x{counts[kern]}")
    return totals


def phase_serving_facade(model) -> dict:
    """``ServingEngine`` (the static-batch facade over the slot arena) on
    llama3.2-1b at full width and depth: one ``generate`` of 8 requests,
    prompts of 128, 32 new tokens at f = 0.2, its pass count exact. ->
    launches per kernel."""
    import torch
    from repro_torch.core.selective import GuidancePlan
    from repro_torch.serving import Request, ServingEngine

    cfg = model.cfg
    eng = ServingEngine(model, cfg, max_batch=8, prompt_len=128, max_new=32,
                        selective_fraction=0.2)
    reqs = [Request(uid=f"g{i}", prompt=f"a serving facade request {i}", max_new_tokens=32,
                    guidance_scale=SERVE_SCALE) for i in range(8)]
    reset_launches()
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = 8 * GuidancePlan.suffix(32, 0.2, SERVE_SCALE).denoiser_passes()
    counts = launch_counts()
    if len(out) != 8 or eng.stats.denoiser_passes != want or not counts["decode_attention"]:
        fail(f"facade: {len(out)} results, passes {eng.stats.denoiser_passes} (want {want}), "
             f"launches {counts}")
    log(f"[facade] ServingEngine 8 requests, prompts 128, 32 new, f=0.2: passes "
        f"{eng.stats.denoiser_passes} = 8 x {want // 8} (exact), tokens "
        f"{eng.stats.tokens_generated}, wall {wall:.4f} s ({eng.stats.tokens_per_s:.1f} "
        f"tokens/s), shapes {sorted(eng._compiled)}")
    return _rows_form(counts)


# -- the engine's host tier, content cache, async tick, fleet, autotune (phase 24) ---

A5_PHASES = ("admit", "schedule", "step", "overlap", "finalize")


def _phase_ms(timings) -> str:
    """Mean host ms of each tick-timer phase over ``timings``."""
    n = max(len(timings), 1)
    seg = {}
    for t in timings:
        for name, s in t.segment_s().items():
            seg[name] = seg.get(name, 0.0) + s / n
    wall = sum(t.duration_s for t in timings) / n
    return f"wall {wall * 1e3:.3f} ms (" + ", ".join(
        f"{k} {seg[k] * 1e3:.3f}" for k in A5_PHASES if k in seg) + ")"


def _add(totals: dict, counts: dict) -> None:
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v


def _launch_ms(step, n: int = 20) -> float:
    """Median host ms of one ``replay()`` call of a captured step's graph
    (the launch alone: the card is idle before each call)."""
    import torch
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.graph.replay()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return sorted(ts)[n // 2] * 1e3


def _replay_ms(step, n: int = 20) -> float:
    """Device ms of one replay of a captured step's graph on its current
    rows: CUDA events around ``n`` replays."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        step.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _a5_async(model, totals: dict) -> None:
    """``[async]``: phase 13's 16 requests, ragged graphed, bf16 and int8,
    sync and then async. On phase 13's arrivals (two a tick at ticks 0-7)
    the pipeline admits each request a tick after sync does, so tokens are
    held to sync's and each run's events to the port simulator's in its
    tick mode; with the 16 queued at tick 0 the admissions are the same in
    both modes, and events, tokens and logits must be equal, with the
    overlap window under ``torch.cuda.set_sync_debug_mode("error")``.
    Then a steady tick's phases and busy share, and one replay's host
    launch ms; at temperature 0.7 the dispatch (its draws) and the window
    under the same mode."""
    import dataclasses

    import torch
    from repro_torch.core.selective import GuidancePlan
    from repro_torch.serve import ContinuousEngine, SimRequest, simulate

    cfg = model.cfg
    arrivals = [i // 2 for i in range(16)]
    plan = GuidancePlan.suffix(SERVE_NEW, 0.2, SERVE_SCALE)
    Recording = _recording_engine()

    class Watched(Recording):
        """The overlap window's ``_admit_collect`` under the sync debug
        mode: a call that waits for the device raises. The logits that the
        window's prefills sample from are kept on the device and recorded
        after it."""
        windows = admitted = 0
        held = None

        def _draw(self, nxt, logits, uids, temps, keys, steps):
            if self.held is None:
                return super()._draw(nxt, logits, uids, temps, keys, steps)
            self.held.append((logits[:len(uids)].float().clone(), list(uids)))
            return super(Recording, self)._draw(nxt, logits, uids, temps, keys, steps)

        def _admit_collect(self, now):
            if now == self.tick_count:
                return super()._admit_collect(now)
            self.held = []
            torch.cuda.set_sync_debug_mode("error")
            try:
                stash = super()._admit_collect(now)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            held, self.held = self.held, None
            for logits, uids in held:
                host = logits.cpu()
                for i, uid in enumerate(uids):
                    self.logits.setdefault(uid, []).append(host[i])
            self.windows += 1
            self.admitted += len(stash.batch) if stash is not None else 0
            return stash

    class Timed(ContinuousEngine):
        """Host seconds of the admission's two halves on ticks 1-7."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.halves = {"collect": 0.0, "bookkeep": 0.0}

        def _timed(self, half, fn, *a):
            t0 = time.perf_counter()
            out = fn(*a)
            if 1 <= self.tick_count <= 7:
                self.halves[half] += time.perf_counter() - t0
            return out

        def _admit_collect(self, now):
            return self._timed("collect", super()._admit_collect, now)

        def _admit_bookkeep(self, stash, now):
            return self._timed("bookkeep", super()._admit_bookkeep, stash, now)

    class Quiet(ContinuousEngine):
        """The async tick at temperature > 0 with its dispatch (the draws
        included, once the step is captured) and its overlap window under
        the sync debug mode: a call that waits for the device raises."""
        checked = 0

        def _quiet(self, fn, *a):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        def _dispatch_ragged(self, plan):
            if self._ragged_graph is None:
                return super()._dispatch_ragged(plan)
            self.checked += 1
            return self._quiet(super()._dispatch_ragged, plan)

        def _admit_collect(self, now):
            if now == self.tick_count:
                return super()._admit_collect(now)
            return self._quiet(super()._admit_collect, now)

    class Serial(Timed):
        """The async tick with its overlap window opened only once the step
        has finished: the window's host cost on an idle card."""

        def _admit_collect(self, now):
            if now > self.tick_count:
                torch.cuda.synchronize()
            return super()._admit_collect(now)

    for kv_dtype in ("bf16", "int8"):
        kern = _paged_kernel_of("ragged", kv_dtype)
        sims = [SimRequest(r.uid, a, plan, prompt_len=r.prompt_len) for r, a in
                zip(_serve_requests(cfg, 16, SERVE_LENS, SERVE_NEW, 0), arrivals)]
        outs, rows = {}, {}
        for mode in ("sync", "async"):
            tag = f"async {kv_dtype} {mode}"

            def engine(cls=None):
                return _serve_engine(model, cfg, "ragged", kv_dtype, 0.2, cls=cls, tick_mode=mode)
            engine().serve_trace(_serve_requests(cfg, 4, SERVE_LENS, 8, 1), [0, 0, 1, 1])
            eng = engine(Timed)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            out = eng.serve_trace(_serve_requests(cfg, 16, SERVE_LENS, SERVE_NEW, 0), arrivals)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts, m = launch_counts(), eng.metrics
            sm = simulate(sims, num_slots=8, pass_budget=16, kv="paged", page_size=SERVE_PS,
                          prefills_per_tick=2, step_mode="ragged",
                          async_ticks=mode == "async").metrics
            if m.trace.keys() != sm.trace.keys() or counts[kern] != cfg.num_layers * \
                    m.step_launches or len(out) != 16:
                fail(f"{tag}: events equal the simulator's {m.trace.keys() == sm.trace.keys()}, "
                     f"{kern} x{counts[kern]} (want {cfg.num_layers} x {m.step_launches})")
            _add(totals, counts)
            outs[mode] = out
            tokens = sum(len(v) for v in out.values())
            admits = _phase_ms(m.tick_timings[1:8])
            sw, seg, by_name, n = _steady_ticks(engine(), _serve_requests(
                cfg, 16, SERVE_LENS, SERVE_NEW, 0), arrivals)
            kern_ms = sum(t_ for t_, _ in by_name.values()) / 1e6 / 10
            busy = f"{kern_ms / (sw * 1e3):.4f}" if kern_ms else "not measured"
            rows[mode] = (wall, sw)
            log(f"[async] {kv_dtype} {mode}: wall {wall:.4f} s, {tokens / wall:.1f} tokens/s, "
                f"ticks {m.ticks}, events equal the simulator's ({len(m.trace.keys())}, "
                f"async_ticks={mode == 'async'}), {kern} x{counts[kern]}; a tick with "
                f"admissions (ticks 1-7): {admits}, of which _admit_collect "
                f"{eng.halves['collect'] / 7 * 1e3:.3f} and _admit_bookkeep "
                f"{eng.halves['bookkeep'] / 7 * 1e3:.3f} ms a tick; a steady tick (8 in flight): "
                f"wall {sw * 1e3:.3f} ms (" + ", ".join(
                    f"{k} {seg[k] * 1e3:.3f}" for k in A5_PHASES if k in seg)
                + f"), {n / 10:.0f} kernels and {kern_ms:.3f} ms of kernel time a tick "
                f"(profiled), busy share {busy}")
        if outs["sync"] != outs["async"]:
            fail(f"async {kv_dtype}: tokens differ between sync and async")
        eng = _serve_engine(model, cfg, "ragged", kv_dtype, 0.2, cls=Serial, tick_mode="async")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.serve_trace(_serve_requests(cfg, 16, SERVE_LENS, SERVE_NEW, 0), arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if out != outs["async"]:
            fail(f"async {kv_dtype}: the serial window changed the tokens")
        log(f"[async] {kv_dtype} async with the window opened after the step (a synchronize "
            f"first): wall {wall:.4f} s; a tick with admissions (ticks 1-7): "
            f"{_phase_ms(eng.metrics.tick_timings[1:8])}, of which _admit_collect "
            f"{eng.halves['collect'] / 7 * 1e3:.3f} ms a tick")
        # the backlogged trace: the same admissions in both modes
        runs = {}
        for mode in ("sync", "async"):
            eng = _serve_engine(model, cfg, "ragged", kv_dtype, 0.2,
                                cls=Watched if mode == "async" else Recording, tick_mode=mode)
            reset_launches()
            out = eng.serve_trace(_serve_requests(cfg, 16, SERVE_LENS, SERVE_NEW, 0), [0] * 16)
            torch.cuda.synchronize()
            runs[mode] = (eng, out, launch_counts())
        (se, so, sl), (ae, ao, al) = runs["sync"], runs["async"]
        bits = all(len(se.logits[u]) == len(ae.logits[u]) and all(
            torch.equal(a, b) for a, b in zip(se.logits[u], ae.logits[u])) for u in so)
        want = cfg.num_layers * ae.metrics.step_launches
        if se.metrics.trace.keys() != ae.metrics.trace.keys() or so != ao or not bits \
                or not sl[kern] == al[kern] == want or not ae.admitted:
            fail(f"async {kv_dtype} backlogged: events equal "
                 f"{se.metrics.trace.keys() == ae.metrics.trace.keys()}, tokens equal "
                 f"{so == ao}, logits bit-equal {bits}, {kern} x{sl[kern]}/x{al[kern]} (want "
                 f"{want}), admitted in the window {ae.admitted}")
        log(f"[async] {kv_dtype}, the 16 queued at tick 0: sync and async events equal "
            f"({len(ae.metrics.trace.keys())}), tokens equal, logits bit-equal over "
            f"{sum(len(v) for v in ae.logits.values())} samples, {kern} x{want} both; "
            f"{ae.windows} overlap windows under sync debug mode 'error', {ae.admitted} "
            f"admissions decided in them, no synchronizing call")
        (sw_, ss), (aw, as_) = rows["sync"], rows["async"]
        log(f"[async] {kv_dtype} sync against async: wall {sw_:.4f} against {aw:.4f} s "
            f"({sw_ / aw:.3f}x); a steady tick {ss * 1e3:.3f} against {as_ * 1e3:.3f} ms; "
            f"one replay of the ragged graph: host launch {_launch_ms(ae._ragged_graph):.3f} "
            f"ms (median of 20), device {_replay_ms(ae._ragged_graph):.3f} ms (events)")
        del runs, se, ae
    # temperature 0.7: the draws after the replay must not wait either
    gen = torch.Generator(device="cuda").manual_seed(1)
    probs = torch.softmax(torch.randn(64, cfg.vocab_size, device="cuda", generator=gen), -1)
    same = all(torch.equal(
        torch.multinomial(p, 1, generator=torch.Generator(device="cuda").manual_seed(k))[0],
        (p / torch.empty_like(p).exponential_(
            1, generator=torch.Generator(device="cuda").manual_seed(k))).argmax())
        for k, p in enumerate(probs))
    hot = [dataclasses.replace(r, temperature=0.7, max_new_tokens=32)
           for r in _serve_requests(cfg, 8, SERVE_LENS, SERVE_NEW, 0)]
    outs = {}
    for mode, cls in (("sync", None), ("async", Quiet)):
        eng = _serve_engine(model, cfg, "ragged", "bf16", 0.2, cls=cls, tick_mode=mode)
        outs[mode] = eng.serve_trace([dataclasses.replace(r) for r in hot], [0] * 8)
    if outs["sync"] != outs["async"] or not same or not eng.checked:
        fail(f"async T=0.7: tokens equal {outs['sync'] == outs['async']}, the draw equals "
             f"torch.multinomial's {same}, dispatches checked {eng.checked}")
    log(f"[async] bf16 at temperature 0.7, 8 requests queued at tick 0, 32 new: sync and "
        f"async tokens equal; {eng.checked} dispatches (their draws included) and every "
        f"overlap window under sync debug mode 'error', no synchronizing call; the draw "
        f"equals torch.multinomial's on 64 rows of {cfg.vocab_size}")


def _a5_tier(model, totals: dict) -> None:
    """``[tier]``: phase 21's lazy Poisson trace on its pool, bf16 and
    int8, with a host tier of two whole checkpoints (both streams at
    capacity), so that both preemptions swap out and restore: engine ==
    simulator (``host_pages``) counters and events, every restored page
    equal bit for bit to the page swapped out, tokens margin-guarded
    against the recompute run (no host tier); the D2H and H2D rates of the
    swaps (CUDA events around them) beside the roofline's host link."""
    import torch
    from repro_torch import roofline
    from repro_torch.serve import poisson_arrivals, simulate
    from repro_torch.serve.state import kv_page_bytes

    cfg = model.cfg
    arrivals = [int(a) for a in poisson_arrivals(LAZY_SEED, n=16, rate=LAZY_RATE)]
    _, sims = _lazy_trace(cfg, LAZY_LENS, 16, SERVE_NEW, arrivals, 0)
    sim_kw = dict(num_slots=8, pass_budget=16, page_size=SERVE_PS, prefills_per_tick=2,
                  step_mode="ragged")
    pages, _ = _lazy_pool(sims, 2 * 8 * SERVE_NB, 2, SERVE_PS, **sim_kw)
    host_pages = 2 * 2 * SERVE_NB
    Recording = _recording_engine()

    class Tiered(Recording):
        """Keeps each swapped-out page's rows and holds its restore to them;
        times each swap by CUDA events."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.saved, self.copies, self.restored, self.differ = {}, [], 0, 0

        def _swap_out(self, uid, swap, placed):
            for s in sorted(swap):
                idx = torch.tensor(self.pages.owned(uid, s), device=self.device)
                self.saved[tuple(placed[s])] = [
                    {n: t.index_select(0, idx).clone() for n, t in layer.items()}
                    for layer in self._pool_p]
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            super()._swap_out(uid, swap, placed)
            b.record()
            self.copies.append(("D2H", sum(swap.values()), a, b))

        def _restore_pages(self, host_slots, dev_pages):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            super()._restore_pages(host_slots, dev_pages)
            b.record()
            self.copies.append(("H2D", len(dev_pages), a, b))
            idx = torch.tensor(dev_pages, device=self.device)
            for layer, want in zip(self._pool_p, self.saved.pop(tuple(host_slots))):
                for n, t in layer.items():
                    self.restored += 1
                    self.differ += not torch.equal(t.index_select(0, idx), want[n])

    for kv_dtype in ("bf16", "int8"):
        page_bytes = kv_page_bytes(cfg, SERVE_PS, kv_dtype)
        sm = simulate(sims, num_pages=pages, reservation="lazy", kv="paged", kv_dtype=kv_dtype,
                      host_pages=host_pages, **sim_kw).metrics
        runs = {}
        for host in (host_pages, 0):
            eng = _serve_engine(model, cfg, "ragged", kv_dtype, 0.2, lazy_pages=pages,
                                cls=Tiered if host else Recording,
                                host_pool_bytes=host * page_bytes)
            reset_launches()
            t0 = time.perf_counter()
            out = eng.serve_trace(_lazy_trace(cfg, LAZY_LENS, 16, SERVE_NEW, arrivals, 0)[0],
                                  arrivals)
            torch.cuda.synchronize()
            runs[host] = (eng, out, time.perf_counter() - t0)
            if host:
                _add(totals, launch_counts())
        (te, to, tw), (re_, ro, rw) = runs[host_pages], runs[0]
        m = te.metrics
        tag = f"tier {kv_dtype}"
        _engine_equals_sim(tag, m, sm)
        diff = {k: (getattr(m, k), getattr(sm, k)) for k in
                ("swap_outs", "swap_ins", "host_evictions", "recompute_passes_avoided")
                if getattr(m, k) != getattr(sm, k)}
        if diff or m.swap_outs < 2 or m.swap_ins != m.swap_outs or te.differ \
                or not te.restored or te.saved or te._host.n_in_use:
            fail(f"{tag}: engine != simulator {diff}, swaps out/in {m.swap_outs}/"
                 f"{m.swap_ins}, restored leaves {te.restored} ({te.differ} differ), "
                 f"unrestored {len(te.saved)}, host pages in use {te._host.n_in_use}")
        rates = []
        for kind, n, a, b in te.copies:
            ms = a.elapsed_time(b)
            rates.append(f"{kind} {n} pages {n * page_bytes} B in {ms:.3f} ms = "
                         f"{n * page_bytes / ms / 1e6:.2f} GB/s")
        log(f"[tier] {kv_dtype}: pool {pages} pages, host tier {host_pages} pages "
            f"({host_pages * page_bytes} B); engine == simulator: preemptions {m.preemptions}, "
            f"swap outs {m.swap_outs}, swap ins {m.swap_ins}, host evictions "
            f"{m.host_evictions}, recompute passes avoided {m.recompute_passes_avoided}, "
            f"prefill passes {m.prefill_passes} (recompute run {re_.metrics.prefill_passes}); "
            f"{te.restored} restored leaves equal bit for bit; wall {tw:.4f} s against the "
            f"recompute run's {rw:.4f} (both recording logits); swaps (events, gather or "
            f"scatter included): " + "; ".join(rates)
            + f"; roofline host link {roofline.H100_HOST_LINK_BYTES_S / 1e9:.0f} GB/s a "
            f"direction; " + _serve_margin(tag, re_, ro, te, to))
        del runs, te, re_
    dev = torch.empty(32 << 20, dtype=torch.uint8, device="cuda")
    host = torch.empty(32 << 20, dtype=torch.uint8, pin_memory=True)
    rate = {}
    for kind, dst, src in (("D2H", host, dev), ("H2D", dev, host)):
        ts = []
        for _ in range(5):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        rate[kind] = (32 << 20) / sorted(ts)[2] / 1e6
    log(f"[tier] one pinned copy of 32 MiB (events, median of 5): D2H {rate['D2H']:.2f} GB/s, "
        f"H2D {rate['H2D']:.2f} GB/s")


def _a5_content(model, totals: dict) -> None:
    """``[content]``: 16 requests over 4 distinct prompts of 512 (two
    arriving a tick), lazy reservation on the default pool, with
    ``prefix_cache="content"`` against ``"length"``: hits, passes and
    events equal the simulator's; token 0 of each hit equals its
    founder's; wall and passes of both."""
    import numpy as np
    import torch
    from repro_torch.core.selective import GuidancePlan
    from repro_torch.serve import ServeRequest, SimRequest, simulate

    cfg = model.cfg
    rng = np.random.default_rng(3)
    prompts = [rng.integers(4, cfg.vocab_size, 512).tolist() for _ in range(4)]
    arrivals = [i // 2 for i in range(16)]

    def reqs():
        return [ServeRequest(uid=f"c{i}", prompt=prompts[i % 4], max_new_tokens=SERVE_NEW,
                             guidance_scale=SERVE_SCALE, prompt_len=512) for i in range(16)]

    plan = GuidancePlan.suffix(SERVE_NEW, 0.2, SERVE_SCALE)
    res = {}
    for cache in ("content", "length"):
        eng = _serve_engine(model, cfg, "ragged", "bf16", 0.2, reservation="lazy",
                            prefix_cache=cache)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = eng.serve_trace(reqs(), arrivals)
        torch.cuda.synchronize()
        res[cache] = (eng, out, time.perf_counter() - t0)
        if cache == "content":
            _add(totals, launch_counts())
    (ce, co, cw), (_, lo, lw) = res["content"], res["length"]
    sm = simulate([SimRequest(f"c{i}", a, plan, prompt_len=512, content=f"p{i % 4}")
                   for i, a in enumerate(arrivals)], num_slots=8, pass_budget=16, kv="paged",
                  page_size=SERVE_PS, prefills_per_tick=2, step_mode="ragged",
                  reservation="lazy", prefix_cache="content").metrics
    m = ce.metrics
    _engine_equals_sim("content", m, sm)
    hits = [ev.uid for ev in m.trace if ev.kind == "prefix_hit"]
    t0_equal = all(co[u][0] == co[f"c{int(u[1:]) % 4}"][0] for u in hits)
    if m.prefix_hits != sm.prefix_hits or not hits or not t0_equal:
        fail(f"content: hits {m.prefix_hits} (simulator {sm.prefix_hits}), token 0 of every "
             f"hit equal to its founder's {t0_equal}")
    passes = {k: (e.metrics.prefill_passes, e.metrics.denoiser_passes)
              for k, (e, _, _) in res.items()}
    log(f"[content] 16 requests over 4 prompts of 512, {SERVE_NEW} new, two a tick: engine == "
        f"simulator, prefix hits {m.prefix_hits}, misses {m.prefix_misses}, cache evictions "
        f"{m.cache_evictions}, recompute passes avoided {m.recompute_passes_avoided}; token 0 "
        f"of each hit equals its founder's; "
        f"content: wall {cw:.4f} s, prefill/denoiser passes {passes['content']}; length: wall "
        f"{lw:.4f} s, passes {passes['length']}; tokens equal between them on "
        f"{sum(co[u] == lo[u] for u in co)} of 16 requests")


def _a5_fleet(model, totals: dict) -> None:
    """``[fleet]``: two replicas on the first two layers of the model (one
    object, each engine its own pool and graphs), lazy with the content
    cache, ``tests/test_fleet.py``'s Zipf trace of 16 over 3 prompts (here
    of 128 tokens, 32 new): affinity against random routing; per-replica
    events equal ``simulate_fleet``'s; affinity has strictly more hits and
    fewer passes."""
    import numpy as np
    import torch
    from repro_torch.core.selective import GuidancePlan
    from repro_torch.serve import (ContinuousEngine, ServeFleet, ServeRequest, SimRequest,
                                   simulate_fleet)

    small = _shallow(model, 2)
    cfg = small.cfg
    rng = np.random.default_rng(5)
    prompts = [rng.integers(4, cfg.vocab_size, 128).tolist() for _ in range(3)]
    zipf = np.random.default_rng(0)
    p = 1.0 / np.arange(1, 4) ** 1.5
    picks = [int(k) for k in zipf.choice(3, size=16, p=p / p.sum())]
    plan = GuidancePlan.suffix(32, 0.5, SERVE_SCALE)
    kw = dict(num_slots=6, pass_budget=12, kv="paged", page_size=SERVE_PS,
              reservation="lazy", prefix_cache="content", prefills_per_tick=2)
    hits, total, walls = {}, {}, {}
    for pol in ("affinity", "random"):
        fleet = ServeFleet([ContinuousEngine(small, cfg, prompt_len=128, max_new=32,
                                             stop_on_eos=False, **kw) for _ in range(2)],
                           policy=pol, seed=7)
        reset_launches()
        t0 = time.perf_counter()
        out = fleet.serve_trace([ServeRequest(uid=f"f{i:02d}", prompt=prompts[picks[i]],
                                              max_new_tokens=32, plan=plan, prompt_len=128)
                                 for i in range(16)], list(range(16)))
        torch.cuda.synchronize()
        walls[pol] = time.perf_counter() - t0
        _add(totals, launch_counts())
        sim = simulate_fleet([SimRequest(f"f{i:02d}", i, plan, prompt_len=128,
                                         content=f"p{picks[i]}") for i in range(16)], 2,
                             policy=pol, seed=7, **kw)
        if sim.assignments != fleet.assignments or len(out) != 16 or any(
                fleet.engines[r].metrics.trace.keys() != sim.replicas[r].metrics.trace.keys()
                for r in range(2)):
            fail(f"fleet {pol}: placement equal {sim.assignments == fleet.assignments}, "
                 f"per-replica events equal the simulator's: " + str([
                     fleet.engines[r].metrics.trace.keys() == sim.replicas[r].metrics.trace.keys()
                     for r in range(2)]))
        s = fleet.summary()
        hits[pol], total[pol] = s["prefix_hits"], s["prefill_passes"] + s["denoiser_passes"]
        log(f"[fleet] {pol}: 2 replicas of {cfg.name} x{cfg.num_layers} layers, placement "
            f"{[sum(1 for v in fleet.assignments.values() if v == r) for r in range(2)]} "
            f"requests, per-replica events equal simulate_fleet's; prefix hits {hits[pol]}, "
            f"prefill + denoiser passes {total[pol]}, wall {walls[pol]:.4f} s")
    if not (hits["affinity"] > hits["random"] and total["affinity"] < total["random"]):
        fail(f"fleet: affinity hits {hits['affinity']} against random {hits['random']}, passes "
             f"{total['affinity']} against {total['random']}")
    log(f"[fleet] affinity against random: hits {hits['affinity']} > {hits['random']}, passes "
        f"{total['affinity']} < {total['random']}")


def _a5_autotune(model, totals: dict) -> None:
    """``[autotune]``: ``pass_budget="auto"`` at ``target_tick_s`` 50 ms on
    phase 13's engine (R 16), ragged bf16 and int8: the roofline's per-pass
    seconds beside one replay's device time (CUDA events over 20 replays
    of the graph on a steady tick's rows) over R; a roofline slower than
    the card fails; the budget and ``swap_break_even_pages``."""
    cfg = model.cfg
    arrivals = [i // 2 for i in range(16)]
    for kv_dtype in ("bf16", "int8"):
        eng = _serve_engine(model, cfg, "ragged", kv_dtype, 0.2, pass_budget="auto",
                            target_tick_s=50e-3)
        reset_launches()
        rep = eng.autotune_budget()
        reqs, i = _serve_requests(cfg, 16, SERVE_LENS, SERVE_NEW, 0), 0
        while eng.tick_count < 20:
            while i < len(reqs) and arrivals[i] <= eng.tick_count:
                eng.submit(reqs[i])
                i += 1
            eng.tick()
        _add(totals, launch_counts())
        replay_ms = _replay_ms(eng._ragged_graph)
        R = eng.ragged_rows
        per_pass = rep["worst_per_pass_s"]
        cost = eng.step_roofline((R,), R)
        if per_pass * R * 1e3 > replay_ms or not isinstance(eng.pass_budget, int):
            fail(f"autotune {kv_dtype}: the roofline {per_pass * R * 1e3:.4f} ms a step exceeds "
                 f"the measured replay {replay_ms:.4f} ms")
        log(f"[autotune] ragged {kv_dtype}, target 50 ms, R {R}: roofline {per_pass * 1e3:.5f} "
            f"ms a pass ({per_pass * R * 1e3:.4f} ms a step: compute "
            f"{cost.compute_s * 1e3:.4f}, memory {cost.memory_s * 1e3:.4f}; {cost.bytes:.4g} B, "
            f"{cost.flops:.4g} FLOP) against one replay {replay_ms:.4f} ms on the device / R = "
            f"{replay_ms / R:.5f} ms a pass ({per_pass * R * 1e3 / replay_ms:.4f} of it); "
            f"budget {eng.pass_budget} (envelope violated {rep['envelope_violated']}, predicted "
            f"tick {rep['predicted_tick_s'] * 1e3:.4f} ms); swap_break_even_pages "
            f"{eng._autotuner.swap_break_even_pages(eng.page_bytes, kv_dtype=kv_dtype)} at "
            f"{eng.page_bytes} B a page")
        del eng


def phase_a5(model) -> dict:
    """Phase 24 on phase 13's model: ``[async]``, ``[tier]``, ``[content]``,
    ``[fleet]``, ``[autotune]``. -> launches per kernel of its runs."""
    import torch
    totals: dict = {}
    for part in (_a5_async, _a5_tier, _a5_content, _a5_fleet, _a5_autotune):
        t0 = time.perf_counter()
        part(model, totals)
        torch.cuda.empty_cache()
        log(f"[time] {part.__name__[1:]} {time.perf_counter() - t0:.1f} s")
    return totals


# -- training ----------------------------------------------------------------------

TRAIN_LM_B, TRAIN_LM_S = 4, 512      # llama3.2-1b training batch and sequence
TRAIN_SD_B = 4                       # sd-unet-prod training batch


def _fwd_bwd(fn, inputs, dout):
    """-> (forward output, gradients of ``inputs``) of ``fn(*inputs)`` under
    autograd, for the output gradient ``dout``."""
    import torch
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, dout)


def _backward_only(fn, inputs, dout):
    """-> a callable that runs the backward of one retained graph of
    ``fn(*inputs)``: the backward alone, for timing."""
    import torch
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def _attn_pairs(S: int, causal: bool, window) -> int:
    """(query, key) pairs a row of heads attends at positions arange(S)."""
    if causal:
        return sum(min(i + 1, window or S) for i in range(S))
    return sum(S - max(0, i - window + 1) for i in range(S)) if window else S * S


def phase_train_kernels() -> None:
    """B6 and B4 under autograd on the card: their kernels' forwards with the
    closed-form backwards of ``FlashAttentionFn`` and ``RmsNormFn`` against
    ``torch.autograd.grad`` of their plain versions, at the training shapes;
    each timed forward, backward and both, beside its bound and the library
    call under autograd; a dropped mask planted in B4's backward must fail
    the check; a call whose backward the port does not cover raises."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.kernels import rmsnorm as KR

    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(14)

    def rnd(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def timed(tag, fwd, bwd, both, plain, lib, nbytes, flops, peak):
        f_ms, b_ms, fb_ms = time_ms(fwd, 20)[0], time_ms(bwd, 20)[0], time_ms(both, 20)[0]
        p_ms = time_ms(plain, 20)[0]
        l_ms = time_ms(lib, 20)[0] if lib is not None else None
        bd = [bound_ms(n, f, peak) for n, f in zip(nbytes, flops)]
        log(f"[tkern] {tag}: device us forward {f_ms * 1e3:.2f} (bound {bd[0][0] * 1e3:.3f}, "
            f"{bd[0][1]}), backward {b_ms * 1e3:.2f} (bound {bd[1][0] * 1e3:.3f}, {bd[1][1]}), "
            f"forward+backward {fb_ms * 1e3:.2f} (bound {(bd[0][0] + bd[1][0]) * 1e3:.3f}); "
            f"plain forward+backward {p_ms * 1e3:.2f}; library forward+backward "
            f"{'-' if l_ms is None else f'{l_ms * 1e3:.2f}'}")

    # RMSNorm: forward as phase 7 (bf16 x within two bf16 steps of each value,
    # float32 within 1e-5 of max|out|); dx within two bf16 steps of max|dx|
    # for bf16 x (both sides round a float32 dx once), 1e-5 for float32;
    # dscale (float32, summed over the rows in another order) within 1e-5
    for rows, D, xdt in ((2048, 2048, bf16), (16, 2048, bf16), (2048, 2048, f32)):
        x, sc, dy = rnd(rows, D, dtype=xdt) * 3, 1 + 0.1 * rnd(D), rnd(rows, D, dtype=xdt)
        tag = f"rmsnorm rows={rows} D={D} x {str(xdt)[6:]} scale float32"
        fn = lambda a, b: KR.rmsnorm(a, b, 1e-5)  # noqa: E731
        plain = lambda a, b: KR.rmsnorm_plain(a, b, 1e-5)  # noqa: E731
        before = KR.LAUNCHES["rmsnorm"]
        out, (dx, dsc) = _fwd_bwd(fn, (x, sc), dy)
        if out.grad_fn is None or KR.LAUNCHES["rmsnorm"] != before + 1:
            fail(f"{tag}: the kernel did not run under autograd with a grad_fn")
        ref, (rdx, rdsc) = _fwd_bwd(plain, (x, sc), dy)
        if xdt == bf16:
            e = (_err_ok("rmsnorm", tag + " out", out, ref, elementwise=2 * BF16_STEP),
                 _err_ok("rmsnorm", tag + " dx", dx, rdx, rel_to_max=2 * BF16_STEP))
        else:
            e = (_err_ok("rmsnorm", tag + " out", out, ref, rel_to_max=1e-5),
                 _err_ok("rmsnorm", tag + " dx", dx, rdx, rel_to_max=1e-5))
        e += (_err_ok("rmsnorm", tag + " dscale", dsc, rdsc, rel_to_max=1e-5),)
        log(f"[tkern] {tag}: out, dx, dscale within tolerance; largest error over the "
            f"yardstick {', '.join(f'{r:.3g}' for _, r in e)}")
        n, xb = rows * D, x.element_size()
        lib = lambda a, b: F.rms_norm(a, (D,), b, 1e-5)  # noqa: E731
        timed(tag, lambda: KR.rmsnorm(x, sc, 1e-5), _backward_only(fn, (x, sc), dy),
              lambda: _fwd_bwd(fn, (x, sc), dy), lambda: _fwd_bwd(plain, (x, sc), dy),
              lambda: _fwd_bwd(lib, (x, sc), dy),
              (2 * n * xb + 4 * D, 3 * n * xb + 8 * D + 4 * rows), (4 * n, 8 * n),
              H100_FP32_FLOPS)

    # Flash attention, bf16: out per row as phase 7; dq, dk, dv within
    # ATTN_BF16_STEPS bf16 steps of each one's max|ref|: the plain version's
    # autograd runs its products in bf16, the backward here in float32
    llama, danube = (32, 8, 64), (32, 8, 120)
    for (H, K, hd), causal, window in ((llama, True, None), (danube, True, 128),
                                       (llama, False, None)):
        B, S = TRAIN_LM_B, TRAIN_LM_S
        q, k, v = rnd(B, S, H, hd, dtype=bf16), rnd(B, S, K, hd, dtype=bf16), \
            rnd(B, S, K, hd, dtype=bf16)
        dout = rnd(B, S, H, hd, dtype=bf16)
        tag = f"flash_attention B={B} S={S} H={H} K={K} hd={hd} bf16 causal={causal} " \
              f"window={window}"
        fn = lambda a, b, c: KF.flash_attention(a, b, c, causal=causal, window=window)  # noqa
        plain = lambda a, b, c: KF.flash_attention_plain(a, b, c, causal=causal,  # noqa: E731
                                                         window=window)
        before = KF.LAUNCHES["flash_attention"]
        out, grads = _fwd_bwd(fn, (q, k, v), dout)
        if out.grad_fn is None or KF.LAUNCHES["flash_attention"] != before + 1:
            fail(f"{tag}: the kernel did not run under autograd with a grad_fn")
        ref, rgrads = _fwd_bwd(plain, (q, k, v), dout)
        tol = ATTN_BF16_STEPS * BF16_STEP
        e = [_err_ok("flash_attention", tag + " out", out, ref, per_row=tol)]
        e += [_err_ok("flash_attention", f"{tag} d{n}", g, r, rel_to_max=tol)
              for n, g, r in zip("qkv", grads, rgrads)]
        # the planted fault: the backward with its mask dropped
        dropped = KF.flash_attention_backward(q, k, v, out.detach(), dout, causal=False,
                                              window=None) if causal else None
        if dropped is not None:
            caught = [not _within(g, r, rel_to_max=tol)[0] for g, r in zip(dropped, rgrads)]
            if not caught[0]:
                fail(f"{tag}: a backward without its mask passed the dq check")
            log(f"[tkern] {tag}: the backward with its mask dropped fails the check "
                f"(dq, dk, dv caught: {caught})")
        log(f"[tkern] {tag}: out per row, dq, dk, dv within {ATTN_BF16_STEPS} bf16 steps; "
            f"largest error over the yardstick in bf16 steps "
            f"{', '.join(f'{r / BF16_STEP:.2f}' for _, r in e)}")
        pairs = _attn_pairs(S, causal, window)
        io_b = 2 * B * S * (2 * H + 2 * K) * hd
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window is None:
            lib = lambda a, b, c: F.scaled_dot_product_attention(  # noqa: E731
                a, b, c, is_causal=causal, enable_gqa=True)
        else:
            pos = torch.arange(S, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            lib = lambda a, b, c: F.scaled_dot_product_attention(  # noqa: E731
                a, b, c, attn_mask=mask, enable_gqa=True)
        dout_t = dout.transpose(1, 2)
        timed(tag, lambda: KF.flash_attention(q, k, v, causal=causal, window=window),
              _backward_only(fn, (q, k, v), dout), lambda: _fwd_bwd(fn, (q, k, v), dout),
              lambda: _fwd_bwd(plain, (q, k, v), dout),
              lambda: _fwd_bwd(lib, (qt, kt, vt), dout_t),
              (io_b, io_b + 2 * 2 * B * S * H * hd), (4 * B * H * hd * pairs,
                                                      10 * B * H * hd * pairs), H100_BF16_FLOPS)
    # a backward the port does not cover raises before the kernel runs
    q = rnd(1, 8192, 32, 64, dtype=bf16).requires_grad_(True)
    kv = rnd(1, 8192, 8, 64, dtype=bf16)
    before = KF.LAUNCHES["flash_attention"]
    try:
        KF.flash_attention(q, kv, kv)
        fail("flash_attention S=8192 H=32 under autograd returned instead of raising")
    except ValueError as exc:
        if KF.LAUNCHES["flash_attention"] != before:
            fail("flash_attention launched before refusing a backward it cannot take")
        log(f"[tkern] flash_attention S=8192 H=32 under autograd raises: {exc}")
    with torch.no_grad():
        KF.flash_attention(q, kv, kv)      # without grad the same call runs
    torch.cuda.synchronize()


def _same_embeddings(emb):
    """A context in which every ``SDPipeline`` encodes to the given (prompt
    embeddings, null embedding), moved to its device: the bf16 text encoder
    rounds differently on the CPU and the GPU (phase 4), and training parity
    compares the steps, not the encoder."""
    import contextlib

    from repro_torch.core.pipeline import SDPipeline

    @contextlib.contextmanager
    def ctx():
        saved = SDPipeline.encode_prompts, SDPipeline.null_embedding
        SDPipeline.encode_prompts = lambda self, prompts: emb[0].to(self.device)
        SDPipeline.null_embedding = lambda self, batch: emb[1].to(self.device)
        try:
            yield
        finally:
            SDPipeline.encode_prompts, SDPipeline.null_embedding = saved
    return ctx()


def phase_train_parity() -> None:
    """The reduced SD pipeline trained 20 AdamW steps on the CPU (plain
    versions) and the GPU (cuDNN, cuBLAS) from the same initial weights,
    batches, CPU-generator draws and prompt embeddings; then ``lm_loss`` and
    every gradient on llama3.2-1b at full width, 2 layers, float32
    parameters, on the CPU (plain versions) and the GPU (B4 and B6 under
    autograd), with and without remat."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.base import UNetConfig
    from repro_torch.configs.llama3_2_1b import CONFIG
    from repro_torch.core.pipeline import SDPipeline
    from repro_torch.data.synthetic import CLASS_PROMPTS
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import diffusion as TD
    from repro_torch.train import losses as TL

    cfg, steps = UNetConfig().reduced(), 20
    # train_pipeline's default initial weights come from a CPU generator on
    # both devices; the embeddings are those of its CPU text encoder
    init = SDPipeline.init(cfg, 0, device="cpu")
    with _same_embeddings((init.encode_prompts(CLASS_PROMPTS), init.null_embedding(1))):
        gpu, gpu_losses = TD.train_pipeline(cfg, steps, device="cuda")
        cpu, cpu_losses = TD.train_pipeline(cfg, steps, device="cpu")
    # float32 on both: convolution and matmul algorithms sum in other orders,
    # and AdamW's m/sqrt(v) amplifies that where a gradient is small (10
    # steps of XLA against torch on the CPU differ by 5e-5 of a tensor's max)
    lerr = ((gpu_losses - cpu_losses).abs() / cpu_losses.abs()).max().item()
    perr = max(((b.cpu() - a).abs().max() / a.abs().max().clamp_min(1e-30)).item()
               for a, b in zip(cpu.unet.state_dict().values(), gpu.unet.state_dict().values()))
    if not (lerr <= 1e-4 and perr <= 2e-3):
        fail(f"training parity: loss rel err {lerr:.3g} (tol 1e-4), parameters err over "
             f"max {perr:.3g} (tol 2e-3)")
    log(f"[tparity] reduced SD, {steps} AdamW steps CPU vs GPU: losses {cpu_losses[0]:.4f} -> "
        f"{cpu_losses[-1]:.4f}, largest loss rel err {lerr:.3g} (tol 1e-4), largest "
        f"parameter err over its tensor's max {perr:.3g} (tol 2e-3)")

    lcfg = dataclasses.replace(CONFIG, num_layers=2)
    cpu_m = Transformer.init(lcfg, torch.Generator().manual_seed(0), device="cpu")
    gpu_m = Transformer.from_state_dict(lcfg, {k: t.cuda() for k, t in
                                               cpu_m.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, lcfg.vocab_size,
                                                               (2, 33))).long()
    cpu_m.requires_grad_(True)
    gpu_m.requires_grad_(True)
    loss_c, _ = TL.lm_loss(cpu_m, toks, remat=False)
    gc = torch.autograd.grad(loss_c, list(cpu_m.parameters()))
    names = [n for n, _ in cpu_m.named_parameters()]
    for remat in (False, True):
        reset_launches()
        loss_g, _ = TL.lm_loss(gpu_m, toks.cuda(), remat=remat)
        gg = torch.autograd.grad(loss_g, list(gpu_m.parameters()), allow_unused=True)
        counts = launch_counts()
        missing = [n for n, g in zip(names, gg) if g is None or not bool(g.abs().sum() > 0)]
        if missing:
            fail(f"lm_loss on the GPU (remat={remat}): no gradient for {missing}")
        want = (lcfg.num_layers * (2 if remat else 1), (2 * lcfg.num_layers) *
                (2 if remat else 1) + 1)
        got = (counts["flash_attention"], counts["rmsnorm"])
        if got != want:
            fail(f"lm_loss remat={remat}: B4, B6 launches {got}, want {want}")
        # bf16 activations on both sides, rounded in other places: the loss
        # within 2e-3, each gradient within 8 bf16 steps of its max
        # (the CPU tests against the reference measured 4.8)
        lrel = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
        gerr = {n: ((b.cpu() - a).abs().max() / a.abs().max()).item()
                for n, a, b in zip(names, gc, gg)}
        worst_n = max(gerr, key=gerr.get)
        if lrel > 2e-3 or gerr[worst_n] > 8 * BF16_STEP:
            fail(f"lm_loss remat={remat}: loss rel err {lrel:.3g}, gradient {worst_n} err over "
                 f"max {gerr[worst_n]:.3g} ({gerr[worst_n] / BF16_STEP:.2f} bf16 steps)")
        log(f"[tparity] lm_loss llama3.2-1b x2 layers B=2 S=33 float32 params remat={remat}: "
            f"loss CPU {loss_c.item():.5f} GPU {loss_g.item():.5f} (rel {lrel:.3g}, tol 2e-3); "
            f"every one of {len(names)} parameters has a gradient; largest gradient err "
            f"{gerr[worst_n] / BF16_STEP:.2f} bf16 steps of its max ({worst_n}; tol 8); "
            f"B4 x{got[0]}, B6 x{got[1]}")
    del cpu_m, gpu_m


CLAIMS_CKPT = os.path.join(ROOT, "build", "claims_pipeline")


def phase_claims() -> dict:
    """The paper's claims on a pipeline trained on the card:
    ``train_pipeline`` (400 steps), saved and reloaded through the port's
    checkpoint io (the same latents bit for bit), the 40/36 pass accounting
    counted around the UNet with B1's launches, and ``test_system.py``'s
    threshold and window inequalities. -> B1's launches in the counted
    generates."""
    import torch
    from repro_torch.configs.base import UNetConfig
    from repro_torch.core.selective import GuidancePlan
    from repro_torch.kernels import cfg_combine as KC
    from repro_torch.train import diffusion as TD

    cfg = UNetConfig().reduced()
    t0 = time.perf_counter()
    pipe, losses = TD.train_pipeline(cfg, 400, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(losses).all()) or \
            not losses[-50:].mean() < 0.5 * losses[:10].mean():
        fail(f"train_pipeline: losses {losses[:3].tolist()} ... {losses[-3:].tolist()}")
    log(f"[claims] train_pipeline 400 steps on the GPU in {dt:.2f} s ({dt / 400 * 1e3:.2f} ms "
        f"a step); loss mean of the first 10 {losses[:10].mean():.4f}, of the last 50 "
        f"{losses[-50:].mean():.4f}")
    TD.save_pipeline(CLAIMS_CKPT, pipe, step=400)
    loaded = TD.load_pipeline(CLAIMS_CKPT, cfg, device="cuda")
    plan = GuidancePlan.suffix(20, 0.2, 5.0)
    a = pipe.generate(["a red disc"], plan, seed=11)
    b = loaded.generate(["a red disc"], plan, seed=11)
    if not torch.equal(a, b):
        fail(f"the reloaded pipeline's latents differ: {(a - b).abs().max().item():.3g}")
    log(f"[claims] saved to {os.path.relpath(CLAIMS_CKPT, ROOT)} and reloaded: latents equal "
        f"bit for bit")

    unet, rows = loaded.unet, []

    class Counted(torch.nn.Module):
        def forward(self, x, t, text):
            rows.append(x.shape[0])
            return unet(x, t, text)

    loaded.unet, b1 = Counted(), 0
    for p, passes, full in ((GuidancePlan.full(20, 5.0), 40, 20), (plan, 36, 16)):
        rows.clear()
        KC.reset_launches()
        loaded.generate(["a red disc"], p, seed=11)
        torch.cuda.synchronize()
        if (sum(rows), KC.LAUNCHES["cfg_combine"]) != (passes, full):
            fail(f"pass accounting: {sum(rows)} passes, {KC.LAUNCHES['cfg_combine']} B1 "
                 f"launches; want {passes} and {full}")
        b1 += full
    loaded.unet = unet
    log("[claims] pass accounting: 40 UNet passes and 20 B1 launches at full guidance, 36 "
        "and 16 with a 20% COND suffix")

    KC.reset_launches()
    c = TD.claim_distances(loaded)
    torch.cuda.synchronize()
    b1 += KC.LAUNCHES["cfg_combine"]
    w = c["windows"]
    log(f"[claims] d20 {c['d20']:.6g} d80 {c['d80']:.6g} scale {c['scale']:.6g} windows "
        f"{' '.join(f'{x:.6g}' for x in w)}")
    import numpy as np
    checks = {"d20 < d80": c["d20"] < c["d80"], "d20 < 0.25 scale": c["d20"] < 0.25 * c["scale"],
              "late windows below early": np.mean(w[2:]) < np.mean(w[:2]),
              "window 0 the worst": int(np.argmax(w)) == 0}
    if not all(checks.values()):
        fail(f"the paper's claims on the card-trained pipeline: {checks}")
    log(f"[claims] all hold: {', '.join(checks)}")
    return {"cfg_combine": b1}


def _timed_steps(step, batches, warmup: int = 1, iters: int = 3):
    """-> (ms per step, peak GB, last loss, launches per timed step): one
    ``step(batch) -> loss`` per batch, timed by the host clock between
    synchronisations."""
    import torch
    for _ in range(warmup):
        step(next(batches))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = step(next(batches))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    per = {k: v / iters for k, v in launch_counts().items() if v}
    return ms, torch.cuda.max_memory_allocated() / 1e9, float(loss), per


def _train_profile(what: str, one_step, batch) -> None:
    """One training step under ``torch.profiler``: its kernel time against
    its wall, the kernels that lead it, and the shares of B4's and B6's
    kernels and of their backwards in torch ops (the device time under the
    autograd nodes ``FlashAttentionFnBackward`` and ``RmsNormFnBackward``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_step(batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            t, k = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (t + e.end_ns() - e.start_ns(), k + 1)
    total = sum(t for t, _ in by_name.values())
    if not total:
        log(f"[tprofile] {what}: not measured: the profiler saw no device time")
        return
    log(f"[tprofile] {what}: {sum(k for _, k in by_name.values())} kernel launches, "
        f"{total / 1e6:.3f} ms of kernel time in {wall_ms:.1f} ms of wall (profiled)")
    for rank, (name, (t, k)) in enumerate(sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]):
        log(f"[tprofile] {what}: {rank + 1}. {t / total:.3f} of kernel time, {k}x {name[:80]}")
    shares = [(label, *_profile_share(by_name, key)) for label, key in
              (("B4 forward kernel", "flash_wgmma_kernel"), ("B6 kernel", "rmsnorm_kernel"))]
    for label, node in (("B4 backward (torch ops)", "FlashAttentionFnBackward"),
                        ("B6 backward (torch ops)", "RmsNormFnBackward")):
        evs = [e for e in prof.key_averages()
               if node in e.key and "evaluate_function" in e.key]
        shares.append((label, sum(getattr(e, "device_time_total", 0) for e in evs) * 1e3,
                       sum(e.count for e in evs)))
    for label, t, k in shares:
        if k:
            log(f"[tprofile] {what}: {label}: {t / total:.4f} of the step's kernel time, "
                f"{k} calls, {t / k / 1e3:.2f} us each (profiled)")


def phase_train_main() -> dict:
    """Full-width training steps: ``sd-unet-prod`` at batch 4 (64x64x4
    latents, 77x768 text, float32) and llama3.2-1b at 16 layers, B 4, S 512,
    float32 parameters, through ``launch/train.py``'s step with and without
    remat; 1 warm-up and 3 timed AdamW steps each, then one profiled
    (``[tprofile]``). -> launches of the timed LM steps."""
    import numpy as np
    import torch
    from repro_torch.configs.llama3_2_1b import CONFIG as lcfg
    from repro_torch.configs.sd_unet import PRODUCTION
    from repro_torch.core.pipeline import SDPipeline
    from repro_torch.core.schedules import NoiseSchedule
    from repro_torch.data.synthetic import shapes_dataset
    from repro_torch.launch import train as LT
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import diffusion as TD
    from repro_torch.train import losses as TL
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    pipe = SDPipeline.init(PRODUCTION, 0, device="cuda", sched=NoiseSchedule.sd_default(1000))
    params = dict(pipe.unet.requires_grad_(True).named_parameters())
    state = {"opt": init_opt_state(params)}
    sd_step = make_train_step(TD.diffusion_loss_fn(pipe),
                              AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=4,
                                          weight_decay=0.0))
    data = shapes_dataset(np.random.default_rng(0), TRAIN_SD_B, PRODUCTION.latent_size)
    gen = torch.Generator().manual_seed(1)

    def sd_batches():
        while True:
            lat, cls = next(data)
            t, eps, drop = TL.diffusion_draws(gen, TRAIN_SD_B, lat.shape, pipe.sched.T)
            yield tuple(x.cuda() for x in (torch.from_numpy(lat), torch.from_numpy(cls).long(),
                                           t, eps, drop))

    def sd_one(batch):
        _, state["opt"], m = sd_step(params, state["opt"], batch, None)
        return m["loss"]

    sd_data = sd_batches()
    ms, peak, loss, _ = _timed_steps(sd_one, sd_data)
    _train_profile("sd-unet-prod step", sd_one, next(sd_data))
    if not np.isfinite(loss):
        fail(f"sd-unet-prod training: loss {loss}")
    log(f"[tmain] sd-unet-prod batch {TRAIN_SD_B} (64x64x4 latents, 77x768 text, float32, "
        f"{sum(p.numel() for p in params.values())} UNet params): {ms:.1f} ms a step (1 "
        f"warm-up, 3 timed), peak {peak:.2f} GB, loss {loss:.4f}")
    pipe.unet.requires_grad_(False)
    del pipe, params, state
    torch.cuda.empty_cache()

    model = Transformer.init(lcfg, torch.Generator(device="cuda").manual_seed(0),
                             device="cuda").requires_grad_(True)
    lparams = dict(model.named_parameters())
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=200)
    lm_launches = {}
    for remat in (False, True):
        lstate = {"opt": init_opt_state(lparams)}
        step = LT.lm_step(model, opt_cfg, remat=remat)
        batches = LT.token_batches(np.random.default_rng(0), lcfg.vocab_size, TRAIN_LM_B,
                                   TRAIN_LM_S, "cuda")

        def lm_one(batch, step=step, lstate=lstate):
            _, lstate["opt"], m = step(lparams, lstate["opt"], batch, None)
            return m["loss"]

        ms, peak, loss, per = _timed_steps(lm_one, batches)
        _train_profile(f"llama3.2-1b step remat={remat}", lm_one, next(batches))
        L = lcfg.num_layers
        want = {"flash_attention": L * (2 if remat else 1),
                "rmsnorm": (2 * L) * (2 if remat else 1) + 1}
        got = {k: per.get(k, 0) for k in want}
        if got != want or not np.isfinite(loss):
            fail(f"llama3.2-1b training remat={remat}: launches a step {got}, want {want}; "
                 f"loss {loss}")
        for k in want:
            lm_launches[k] = lm_launches.get(k, 0) + 3 * want[k]
        log(f"[tmain] llama3.2-1b x{L} layers B={TRAIN_LM_B} S={TRAIN_LM_S} float32 params "
            f"remat={remat}: {ms:.1f} ms a step (1 warm-up, 3 timed), peak {peak:.2f} GB, "
            f"loss {loss:.4f}; a step launches B4 x{got['flash_attention']:.0f} and B6 "
            f"x{got['rmsnorm']:.0f} (forward{' + remat recompute' if remat else ''})")
        del lstate
    del model, lparams
    torch.cuda.empty_cache()
    return lm_launches


# -- the other model families (phase 25) ----------------------------------------------

FAMILY_B, FAMILY_S, FAMILY_NEW = 4, 512, 64       # guided_decode's shape on every decoder
# arch, layers kept (None: full depth), COND fractions, the fractions with a
# timed eager generate besides f = 0.2's eager teacher-forced run (deepseek's
# eager f = 0 generate, 12.6 s, and xlstm's, 7.0 s, are left out). deepseek
# and xlstm ran at full depth (27, 24) until phase 27 came; half depth pays
# for its minute under the script's 1200 s (PERF.md §7).
FAMILIES = (
    ("deepseek-v2-lite-16b", 14, (0.0, 0.2, 1.0), (1.0,)),
    ("mixtral-8x7b", 4, (0.0, 0.2), (0.0,)),
    ("recurrentgemma-9b", 6, (0.0, 0.2), (0.0,)),
    ("xlstm-350m", 12, (0.0, 0.2), ()),
    ("chameleon-34b", 4, (0.0, 0.2), (0.0,)),
)
FAMILY_TEACHER_S = 128    # the teacher-forced consistency check's prompt
ENCODER_B, ENCODER_S = 4, 512
# [fserve]: 16 requests of random prompts of 128 tokens, 32 new tokens, two
# arriving a tick, 8 slots, pass budget 16, f = 0.2, scale 3, greedy
FSERVE_S, FSERVE_NEW, FSERVE_N = 128, 32, 16
# xlstm's prefill is a loop over time (ROADMAP B'9): at prompts of 128 its
# 32 prefills a run take most of a minute, so it serves prompts of 16
FSERVE_S_XLSTM = 16
FSERVE_WINDOW = (20, 25)      # the profiled ticks: 8 requests in flight, none admitted
# the families the paged arena also serves: (step mode, pool dtype) runs
FSERVE_PAGED = ("mixtral-8x7b", "chameleon-34b")
FSERVE_PAGED_RUNS = (("ragged", "bf16"), ("ragged", "int8"), ("signature", "bf16"))


def _gqa_layers(cfg) -> int:
    """Layers that run B4 a prefill forward and B5 or a paged kernel a
    decode forward: the GQA attention layers (MLA runs neither)."""
    return 0 if cfg.mla is not None else sum(k in ("attn", "swa") for k in cfg.blocks)


def _norms_a_forward(cfg) -> int:
    """B6 launches a forward: a norm of each block (two where it has an
    FFN, two more for q/k norms, one more for MLA's kv norm) and the final
    norm."""
    attn = ("attn", "swa")
    return 1 + sum(1 + (k in attn + ("rglru",) and cfg.d_ff > 0)
                   + 2 * (k in attn and cfg.qk_norm and cfg.mla is None)
                   + (k in attn and cfg.mla is not None) for k in cfg.blocks)


def _serve_want(cfg, eng, step_mode: str) -> dict:
    """Exact launches of one serve run of ``eng`` (of any decoder): B4 once
    a GQA layer and prefill forward (two a slot admission, two a paged
    prefill group: every prompt of one length here), B5 per row (slot) or
    the pool's paged kernel once a GQA layer and decode forward, B6 per
    forward once a norm of each block and the final norm (as
    ``_expected_launches``), and B3 once a prefill's combine and once a
    step that combines (a signature step's FULL group, every ragged
    step)."""
    m = eng.metrics
    gqa, norms = _gqa_layers(cfg), _norms_a_forward(cfg)
    dec = _decode_forwards(m, step_mode)
    admits = [k for k in m.trace.keys() if k[0] == "admit"]
    groups = len(admits) if eng.kv == "slot" else len({k[1] for k in admits})
    combines = m.step_launches if step_mode == "ragged" else \
        sum(1 for r in m.records if r.n_full)
    want = {k: 0 for k in launch_counts()}
    want.update(flash_attention=2 * groups * gqa, rmsnorm=norms * (2 * groups + dec),
                cfg_combine_rowscale=groups + combines)
    if eng.kv == "slot":
        want["decode_attention"] = gqa * dec
    else:
        want[_paged_kernel_of(step_mode, eng.kv_dtype)] = gqa * dec
    return want


def _serve_window(eng, reqs, arrivals, window) -> tuple:
    """Drive ``reqs`` through ``eng`` at ``arrivals``, ticks ``window`` (lo,
    hi) under ``torch.profiler``. -> (tokens by uid, the run's wall s, the
    window's wall s, {kernel name: (ns, launches)} over the window)"""
    import torch
    from torch.profiler import ProfilerActivity, profile
    i, prof, win = 0, None, 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while i < len(reqs) or eng.scheduler.n_active or len(eng.queue):
        while i < len(reqs) and arrivals[i] <= eng.tick_count:
            eng.submit(reqs[i])
            i += 1
        if eng.tick_count == window[0]:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            w0 = time.perf_counter()
        eng.tick()
        if eng.tick_count == window[1]:
            torch.cuda.synchronize()
            win = time.perf_counter() - w0
            prof.__exit__(None, None, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.profiler.kineto_results.events() if prof is not None else ():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            t_, k = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (t_ + e.end_ns() - e.start_ns(), k + 1)
    return {r.uid: eng.results[r.uid] for r in reqs}, wall, win, by_name


def _family_serve(model, arch: str, totals: dict, smi: str) -> float:
    """``[fserve]``: the serve engine on a family's loaded model: the slot
    arena (8 slots, prompts of ``FSERVE_S`` (xlstm ``FSERVE_S_XLSTM``),
    ``FSERVE_NEW`` new tokens, 16 seeded requests two a tick, f = 0.2,
    scale 3, greedy), and for ``FSERVE_PAGED`` the paged arena's ragged
    step over bf16 and int8 pages and its signature step; each graphed and
    (but the paged signature step) eager: tokens and events equal, one
    capture per signature bucket (the
    ragged step one), launches exact per kernel (``_serve_want``; B5 all
    per row), the wall and ticks of each run, and the busy share (kernel
    time over wall) of ticks ``FSERVE_WINDOW``, eight requests in flight
    and none admitted, under ``torch.profiler``, with the graphed run's
    kernel census there (the gathers and scatters of the pool rows:
    ``index`` kernels). -> the seconds it took"""
    import dataclasses

    import torch
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.serve import ContinuousEngine

    t0 = time.perf_counter()
    cfg = model.cfg
    S = FSERVE_S_XLSTM if arch == "xlstm-350m" else FSERVE_S
    arrivals = [i // 2 for i in range(FSERVE_N)]
    runs = [("slot", "signature", "bf16")]
    if arch in FSERVE_PAGED:
        runs += [("paged", mode, dt) for mode, dt in FSERVE_PAGED_RUNS]
    for kv, step_mode, kv_dtype in runs:
        kw = dict(num_slots=8, pass_budget=16, prompt_len=S, max_new=FSERVE_NEW,
                  stop_on_eos=False, prefills_per_tick=2, seed=0, selective_fraction=0.2,
                  kv=kv, step_mode=step_mode)
        if kv == "paged":
            kw.update(page_size=16, kv_dtype=kv_dtype)
        what = f"{kv} {step_mode}" + (f" {kv_dtype}" if kv == "paged" else "")
        done = {}
        # the paged signature step graphed alone: graphed = eager is held on
        # the ragged step and in the slot arena (the script's time limit)
        for graphs in (None,) if (kv, step_mode) == ("paged", "signature") else (None, False):
            eng = ContinuousEngine(model, cfg, graphs=graphs, **kw)
            reqs = [dataclasses.replace(r, prompt_len=None if kv == "slot" else S)
                    for r in _serve_requests(cfg, FSERVE_N, (S,), FSERVE_NEW, 5)]
            reset_launches()
            out, wall, win, by_name = _serve_window(eng, reqs, arrivals, FSERVE_WINDOW)
            counts, forms, m = launch_counts(), dict(KD.LAUNCH_FORMS), eng.metrics
            want = _serve_want(cfg, eng, step_mode)
            captures = len(eng._sig_graphs) + (eng._ragged_graph is not None)
            shapes = sorted(k for k in eng._shapes if k[0] in ("step", "pstep", "rstep"))
            tag = f"fserve {arch} {what} {'graphed' if eng.graphs else 'eager'}"
            if len(out) != FSERVE_N or any(len(v) != FSERVE_NEW for v in out.values()) or \
                    not all(0 <= t < cfg.vocab_size for v in out.values() for t in v):
                fail(f"{tag}: {len(out)} results, lengths {sorted({len(v) for v in out.values()})}")
            if counts != want or forms != ({"rows": want["decode_attention"]}
                                           if want["decode_attention"] else {}):
                fail(f"{tag}: launches {counts}, want {want}; B5 forms {forms}")
            if captures != (len(shapes) if eng.graphs else 0) or \
                    m.step_compiles != len(shapes):
                fail(f"{tag}: {captures} captures, {m.step_compiles} compiles, buckets {shapes}")
            if eng.pages is not None and eng.pages.n_free != eng.pages.num_pages:
                fail(f"{tag}: pool not balanced at drain")
            in_flight = {r.active for r in m.records[FSERVE_WINDOW[0]:FSERVE_WINDOW[1]]}
            if in_flight != {8}:
                fail(f"{tag}: the profiled ticks hold {in_flight} requests, want 8")
            kern_s = sum(t_ for t_, _ in by_name.values()) / 1e9
            census = ""
            if eng.graphs:
                _add(totals, _rows_form(counts) if kv == "slot" and counts["decode_attention"]
                     else counts)
                if kern_s:
                    idx = sum(t_ for n, (t_, _) in by_name.items() if "ndex" in n) / 1e9
                    top = sorted(by_name.items(), key=lambda kv_: -kv_[1][0])[:5]
                    census = (f"; the profiled ticks' kernel census: index gathers and scatters "
                              f"{idx / kern_s:.4f} of kernel time; top " + "; ".join(
                                  f"{t_ / 1e9 / kern_s:.3f} {k}x {n[:50]}"
                                  for n, (t_, k) in top))
            busy = f"{kern_s / win:.4f}" if kern_s else "not measured (no device time)"
            n_win = FSERVE_WINDOW[1] - FSERVE_WINDOW[0]
            done[eng.graphs] = (out, m)
            log(f"[fserve] {arch} ({smi}) {what} {'graphed' if eng.graphs else 'eager'}: "
                f"wall {wall:.4f} s, ticks {m.ticks}, "
                f"{sum(len(v) for v in out.values()) / wall:.1f} tokens/s; ticks "
                f"{FSERVE_WINDOW[0]}-{FSERVE_WINDOW[1] - 1} (8 in flight) "
                f"{win * 1e3 / n_win:.3f} ms a tick, {kern_s * 1e3 / n_win:.3f} ms of kernels, "
                f"busy share {busy}; denoiser passes {m.denoiser_passes}, buckets {shapes}, "
                f"launches exact "
                f"{ {k: v for k, v in counts.items() if v} }"
                + (f"; {_graph_summary(eng)}" if eng.graphs else "") + census)
            del eng
        if False not in done:
            continue
        (go, gm), (eo, em) = done[True], done[False]
        if go != eo or gm.trace.keys() != em.trace.keys():
            fail(f"fserve {arch} {what}: graphed and eager differ (tokens equal {go == eo})")
        log(f"[fserve] {arch} {what}: graphed and eager tokens and events equal; first tokens "
            f"{go['q0'][:6]}")
    dt = time.perf_counter() - t0
    log(f"[fserve] {arch}: {dt:.1f} s")
    return dt


def _family_consistency(model, tag: str) -> str:
    """The teacher-forced forward against prefill plus three decode steps on
    the card, within the reference's own tolerance
    (``tests/test_models_smoke.py``: 5e-2 relative, 1e-1 absolute), MoE
    capacity raised so that no prefill token drops, as there: a capacity
    factor of E, so that C = S (at full depth the random stacks' tokens
    crowd onto a few experts, and the reference test's factor of 8 drops
    the last positions). The activations run in float32 on the bf16
    weights (a twin of the model fed the token embeddings): in bf16, 26
    MoE layers of top-6 routing turn the stream's rounding into routing
    flips between the two paths, which no tolerance covers."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(model.cfg, embedding_inputs=True, tie_embeddings=False)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    state = {k: v for k, v in model.state_dict().items() if not k.startswith("embed.")}
    if model.cfg.tie_embeddings:
        state["lm_head"] = model.embed.table.T
    twin = Transformer.from_state_dict(cfg, state)
    S, ext = FAMILY_TEACHER_S, 3
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, S + ext))).long().cuda()
    emb = model.embed.table[toks].float()
    worst = 0.0
    with torch.no_grad():
        h, _, _ = twin(emb)
        full = twin.unembed(h[:, S:].contiguous()).float()
        _, caches, _ = twin(emb[:, :S].contiguous(), want_caches=True)
        caches = twin.prepare_decode_caches(caches, seq_len=S, capacity=S + ext)
        for i in range(ext):
            step, caches = twin.decode_step(emb[:, S + i:S + i + 1].contiguous(), caches, S + i)
            got, want = twin.unembed(step)[:, 0].float(), full[:, i]
            err = (got - want).abs()
            if not bool(torch.isfinite(got).all()) or \
                    not bool((err <= 1e-1 + 5e-2 * want.abs()).all()):
                fail(f"{tag}: decode step {i} against the teacher-forced forward: max err "
                     f"{err.max().item():.4g} of max|logit| {want.abs().max().item():.4g}")
            worst = max(worst, err.max().item() / want.abs().max().item())
    return (f"teacher-forced = prefill + {ext} decode steps, float32 activations (rel err "
            f"{worst:.3g})")


def _family_decoder(arch: str, layers, fracs, eager_fracs, totals: dict, smi: str) -> None:
    """One decoder family at full width: init, the consistency check,
    ``guided_decode`` graphed at each COND fraction (captures, then one
    timed run) and eager at ``eager_fracs``, with exact launches; at f = 0.2
    the eager and graphed teacher-forced runs on the graphed tokens, their
    logits bit-equal; the
    FULL and COND steps' device time (graph replays, CUDA events and a
    profiled replay), a generate's busy share, and deepseek's apg and
    interval combines."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core import ar_decode as AR
    from repro_torch.core.selective import GuidancePlan
    from repro_torch.models.transformer import Transformer
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    full_cfg = get_config(arch)
    cfg = dataclasses.replace(full_cfg, num_layers=layers) if layers else full_cfg
    torch.cuda.reset_peak_memory_stats()
    model = Transformer.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                             dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (FAMILY_B, FAMILY_S))).long().cuda()
    torch.cuda.synchronize()
    tag = f"families {arch}"
    log(f"[families] {arch} ({smi}): {cfg.num_layers} of {full_cfg.num_layers} layers "
        f"{'(full depth)' if not layers else '(depth cut)'}, d_model {cfg.d_model}, blocks "
        f"{sorted(set(cfg.blocks))}, {n_params} params in bf16 ({n_params * 2 / 1e9:.2f} GB), "
        f"init {time.perf_counter() - t0:.2f} s; {_family_consistency(model, tag)}")
    laps = {"init and consistency": time.perf_counter() - t0}

    def run(plan, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, end = AR.guided_decode(model, toks, plan, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        if tuple(out.shape) != (FAMILY_B, FAMILY_NEW) or end != FAMILY_S + FAMILY_NEW or \
                not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
            fail(f"{tag}: tokens {tuple(out.shape)} end {end} out of range")
        return out, dt

    def counted(plan, kernel="cfg_combine", **kw):
        reset_launches()
        out, dt = run(plan, **kw)
        counts, want = launch_counts(), _expected_launches(cfg, plan, kernel)
        if counts != want:
            fail(f"{tag} f={plan.optimized_steps / FAMILY_NEW:.2f} {kw}: launches {counts}, "
                 f"want {want}")
        _add(totals, counts)
        return out, dt

    def teacher_forced(plan, tokens, **kw):
        reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits = AR.teacher_forced_logits(model, toks, plan, tokens, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        if launch_counts() != _expected_launches(cfg, plan):
            fail(f"{tag}: teacher-forced launches {launch_counts()}")
        _add(totals, launch_counts())
        return logits, dt

    t1 = time.perf_counter()
    rows = {}
    for f in fracs:
        plan = GuidancePlan.suffix(FAMILY_NEW, f, DECODE_SCALE)
        out, first = counted(plan)                      # captures FULL and/or COND
        graphed = counted(plan)[1]
        eager, how = None, "an eager generate"
        if f == 0.2:
            # eager and graphed fed the graphed run's tokens: bit-equal logits,
            # and the eager run picks the token it is fed at every step, so it
            # does an eager generate's work and keeps each step's (B, V) float32
            # logits besides
            la, eager = teacher_forced(plan, out, graphs=False)
            lb, _ = teacher_forced(plan, out)
            if not torch.equal(la, lb):
                fail(f"{tag}: graphed teacher-forced logits differ from eager's by "
                     f"{(la - lb).abs().max().item():.4g}")
            if not torch.equal(la.argmax(-1), out):
                fail(f"{tag}: the eager logits do not choose the graphed run's tokens")
            del la, lb
            how = "the eager teacher-forced run on the graphed tokens"
        elif f in eager_fracs:
            eager = counted(plan, graphs=False)[1]
        rows[f] = dict(first=first, graphed=graphed, eager=eager, how=how)
    for f, r in rows.items():
        r["saving"] = 1.0 - r["graphed"] / rows[0.0]["graphed"]
        eager = "not run" if r["eager"] is None else \
            f"{r['eager']:.4f} s ({r['eager'] / r['graphed']:.2f}x; {r['how']})"
        log(f"[families] {arch} f={f}: graphed {r['graphed']:.4f} s a generate (after one of "
            f"{r['first']:.3f} s with any captures), "
            f"{FAMILY_B * FAMILY_NEW / r['graphed']:.1f} tokens/s, saving 1 - t_f/t_0 "
            f"{r['saving']:.4f}; eager {eager}; launches exact; at f=0.2 graphed logits "
            f"bit-equal to eager")
    if arch == "deepseek-v2-lite-16b":
        plan = GuidancePlan.suffix(FAMILY_NEW, 0.2, DECODE_SCALE)
        for mode, (kernel, kw) in COMBINE_MODES.items():
            if mode != "cfg":
                _, dt = counted(plan, kernel, combine=mode, **kw)
                log(f"[families] {arch} combine={mode} f=0.2 graphed: {dt:.4f} s with its "
                    f"FULL capture, {kernel} x{1 + FAMILY_NEW - plan.optimized_steps} exact")

    laps["generates"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    with torch.no_grad():          # the generates above warmed the prefill
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        AR.prefill(model, toks)
        AR.prefill(model, AR.null_prompt(toks))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
    # the steps' device time: replays of the captured graphs from position S
    loop = next(iter(model._decode_loops.values()))
    full_key = next(k for k in loop.graphs if k[0] == "full" and k[1] == "cfg")
    step_ms = {}
    for name, key in (("FULL", full_key), ("COND", ("cond",))):
        g = loop.graphs[key]
        loop.ctr.fill_(0)
        loop.ctr[0].fill_(FAMILY_S)
        events = _replay_ms(g, n=16)
        loop.ctr[0].fill_(FAMILY_S)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            g.graph.replay()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                t, k = by_name.get(e.name(), (0, 0))
                by_name[e.name()] = (t + e.end_ns() - e.start_ns(), k + 1)
        kernel_ms = sum(t for t, _ in by_name.values()) / 1e6
        step_ms[name] = (events, kernel_ms)
        if name == "FULL" and kernel_ms:
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
            log(f"[families] {arch} FULL replay: {sum(k for _, k in by_name.values())} kernels; "
                + "; ".join(f"{t / 1e6 / kernel_ms:.3f} {k}x {n[:60]}" for n, (t, k) in top))
    laps["prefills and steps"] = time.perf_counter() - t2
    t2 = time.perf_counter()
    plan = GuidancePlan.suffix(FAMILY_NEW, 0.2, DECODE_SCALE)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        AR.guided_decode(model, toks, plan)
        torch.cuda.synchronize()
    kernel_s = sum(e.end_ns() - e.start_ns() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e9
    laps["profiled generate"] = time.perf_counter() - t2
    (fe, fk), (ce, ck) = step_ms["FULL"], step_ms["COND"]
    log(f"[families] {arch} ({smi}): FULL step {fe:.3f} ms by events over 16 replays, "
        f"{fk:.3f} ms of kernels in a profiled replay; COND {ce:.3f} ms, {ck:.3f} ms; COND/FULL "
        f"{ce / fe:.3f}; both prefills {prefill_s:.4f} s; a graphed f=0.2 generate: kernel "
        f"time {kernel_s:.4f} s of a {rows[0.2]['graphed']:.4f} s wall, busy share "
        f"{kernel_s / rows[0.2]['graphed']:.4f}; "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del loop
    model._decode_loops.clear()
    gc.collect()
    torch.cuda.empty_cache()
    laps["[fserve]"] = _family_serve(model, arch, totals, smi)
    log(f"[families] {arch}: {time.perf_counter() - t0:.1f} s for the family "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in laps.items())})")
    del model
    gc.collect()                  # the model and its decode loops hold each other
    torch.cuda.empty_cache()


def _family_encoder(totals: dict, smi: str) -> None:
    """hubert-xlarge at full depth: a forward over synthetic frames and
    masked-prediction AdamW steps with float32 parameters, B4 non-causal at
    hd 80."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as LT
    from repro_torch.models.frontends import synthetic_audio_frames
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    t0 = time.perf_counter()
    cfg = get_config("hubert-xlarge")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = Transformer.init(cfg, gen)
    n_params = sum(p.numel() for p in model.parameters())
    frames = synthetic_audio_frames(gen, ENCODER_B, ENCODER_S, cfg.d_model)
    with torch.no_grad():
        model(frames)
        reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        h, _, _ = model(frames)
        logits = model.unembed(h)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t1) * 1e3
    counts = launch_counts()
    want = dict({k: 0 for k in counts}, flash_attention=cfg.num_layers)
    if counts != want or tuple(logits.shape) != (ENCODER_B, ENCODER_S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"families hubert forward: launches {counts} want {want}, logits "
             f"{tuple(logits.shape)}")
    _add(totals, counts)
    del h, logits

    model.requires_grad_(True)
    params = dict(model.named_parameters())
    state = {"opt": init_opt_state(params)}
    step = make_train_step(LT.masked_loss_fn(model),
                           AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=8))
    batches = LT.frame_batches(np.random.default_rng(0), ENCODER_B, ENCODER_S, cfg.d_model,
                               cfg.vocab_size, "cuda")

    def one(batch):
        _, state["opt"], m = step(params, state["opt"], batch, None)
        return m["loss"]

    ms, peak, loss, per = _timed_steps(one, batches)
    if not np.isfinite(loss) or per.get("flash_attention") != cfg.num_layers or \
            set(per) != {"flash_attention"}:
        fail(f"families hubert training: loss {loss}, launches a step {per}")
    _add(totals, {k: int(v * 3) for k, v in per.items()})
    log(f"[families] hubert-xlarge ({smi}): {cfg.num_layers} layers (full depth), d_model "
        f"{cfg.d_model}, {n_params} float32 params; forward over B={ENCODER_B} x {ENCODER_S} "
        f"bf16 frames {fwd_ms:.2f} ms (B4 non-causal at hd {cfg.resolved_head_dim} x"
        f"{cfg.num_layers}); masked-prediction AdamW step on float32 frames {ms:.1f} ms (1 "
        f"warm-up, 3 timed), peak {peak:.2f} GB, loss {loss:.4f}, B4 x{cfg.num_layers} a step; "
        f"{time.perf_counter() - t0:.1f} s")
    model.requires_grad_(False)
    del model, params, state
    gc.collect()
    torch.cuda.empty_cache()


def phase_families(smi: str) -> dict:
    """``[families]``: every other decoder family through ``guided_decode``,
    graphed and eager, and the encoder's forward and training, at full
    width. -> the kernel launches of its runs."""
    import torch
    totals: dict = {}
    t0 = time.perf_counter()
    gc.collect()                  # earlier phases' models, held by their decode loops
    torch.cuda.empty_cache()
    for arch, layers, fracs, eager_fracs in FAMILIES:
        _family_decoder(arch, layers, fracs, eager_fracs, totals, smi)
    _family_encoder(totals, smi)
    log(f"[families] wall {time.perf_counter() - t0:.1f} s")
    return totals


# -- the launchers (phase 26) -------------------------------------------------------

LAUNCH_CLI = ["--arch", "llama3.2-1b", "--requests", "16", "--prompt-len", "128",
              "--max-new", "32", "--fraction", "0.2"]
LAUNCH_PAGED = ["--mode", "continuous", "--kv", "paged", "--reservation", "lazy",
                "--prefix-cache", "content"]
LAUNCH_MODES = (("static", ["--mode", "static"]), ("continuous", LAUNCH_PAGED),
                ("fleet", LAUNCH_PAGED + ["--replicas", "2"]))
LAUNCH_BUNDLES = (("sd-unet", "denoise"), ("llama3.2-1b", "long_500k"),
                  ("xlstm-350m", "decode_32k"))
# ``dryrun --all`` on meta takes ~125 s of the host's CPU, past the phase's
# ~120 s with the rest: the script runs the two archs of the CPU tests
LAUNCH_DRY_ARCHS = ("llama3.2-1b", "xlstm-350m")
DRY_RUNS = 3                  # ``launch/dryrun.TIMED_RUNS``


def _cli_want(cfg, eng) -> dict:
    """Exact launches of one ``ContinuousEngine`` run the serve CLI drove:
    ``_serve_want``, but on pages a prefill group is one admission tick's
    admissions that are not content-cache hits (a hit runs no forward), and
    each hit's token 0 is one B3 launch over the founder's cached logits."""
    want = _serve_want(cfg, eng, eng.step_mode)
    if eng.kv != "paged":
        return want
    m = eng.metrics
    hits = {ev.uid for ev in m.trace if ev.kind == "prefix_hit"}
    groups = len({ev.tick for ev in m.trace if ev.kind == "admit" and ev.uid not in hits})
    dec = _decode_forwards(m, eng.step_mode)
    want.update(flash_attention=2 * groups * _gqa_layers(cfg),
                rmsnorm=_norms_a_forward(cfg) * (2 * groups + dec),
                cfg_combine_rowscale=groups + len(hits) + m.step_launches)
    return want


def _cli_trace_sim(eng, args, replicas: int):
    """The port simulator on the serve CLI's trace (``_trace_requests`` of
    the CLI's own parsed ``args``: its seeded Poisson arrivals,
    ``PAPER_PROMPTS`` labelled by their token ids) with ``eng``'s knobs.
    -> the metrics of each replica."""
    from repro_torch.core.selective import GuidancePlan
    from repro_torch.launch import serve as TS
    from repro_torch.serve import SimRequest, simulate, simulate_fleet
    from repro_torch.serve.state import content_key

    reqs, arrivals = TS._trace_requests(args)
    plan = GuidancePlan.suffix(args.max_new, args.fraction, guidance_scale=args.guidance_scale)
    trace = [SimRequest(r.uid, a, plan, prompt_len=args.prompt_len,
                        content=content_key(eng._tokenize(r.prompt, args.prompt_len)))
             for r, a in zip(reqs, arrivals)]
    kw = dict(num_slots=eng.num_slots, pass_budget=eng.scheduler.pass_budget, kv="paged",
              page_size=eng.page_size, prefills_per_tick=eng.prefills_per_tick,
              step_mode=eng.step_mode, reservation=eng.reservation,
              prefix_cache=eng.prefix_cache)
    if replicas == 1:
        return [simulate(trace, **kw).metrics]
    return simulate_fleet(trace, replicas, policy=args.route, seed=args.seed, **kw).metrics


def _launch_cli(mode: str, extra: list, totals: dict) -> None:
    """One serve CLI run in-process (``launch.serve.main``): its wall, its
    printed summary, launches exact per kernel (B5 all per row: the slot
    arenas of the static facade), and on the paged runs engine == the port
    simulator, counter for counter and event for event."""
    import torch
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.launch import serve as TS

    argv = LAUNCH_CLI + extra
    reset_launches()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = TS.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, forms = launch_counts(), dict(KD.LAUNCH_FORMS)
    if mode == "static":
        engines = [e._engine for e in out.values()]
        paged = []
    elif mode == "continuous":
        engines, paged = [out["continuous"], out["static"]._engine], [out["continuous"]]
    else:
        engines = paged = list(out.engines)
    cfg = engines[0].cfg
    want = {k: 0 for k in counts}
    for eng in engines:
        for k, v in _cli_want(cfg, eng).items():
            want[k] += v
    slot = sum(_cli_want(cfg, e)["decode_attention"] for e in engines if e.kv == "slot")
    if counts != want or forms != ({"rows": slot} if slot else {}):
        fail(f"launch {mode}: launches {counts}, want {want}; B5 forms {forms}")
    _add(totals, _rows_form(counts) if slot else counts)
    if paged:
        sims = _cli_trace_sim(paged[0], TS.parse_args(argv), len(paged))
        for i, (eng, sm) in enumerate(zip(paged, sims)):
            _engine_equals_sim(f"launch {mode} replica {i}", eng.metrics, sm)
            diff = {k: (getattr(eng.metrics, k), getattr(sm, k))
                    for k in ("prefix_hits", "prefix_misses")
                    if getattr(eng.metrics, k) != getattr(sm, k)}
            if diff:
                fail(f"launch {mode} replica {i}: engine != simulator {diff}")
    passes = sum(e.metrics.denoiser_passes for e in engines)
    log(f"[launch] serve CLI --mode {mode}{' --replicas 2' if mode == 'fleet' else ''} "
        f"({' '.join(argv)}): wall {wall:.4f} s (float32 weights drawn, every engine built "
        f"and warmed, its trace served), denoiser passes {passes}"
        + (f", engine == simulator on {len(paged)} paged engine(s) (counters, events, "
           f"prefix hits {[e.metrics.prefix_hits for e in paged]})" if paged else "")
        + f"; launches exact { {k: v for k, v in counts.items() if v} }")


def _bundle_want(arch: str, variant: str) -> dict:
    """Exact launches of a bundle's four runs on the card (a warm-up and 3
    timed): a serve step's forwards (two FULL, one COND) each B6 a norm and
    B5 (its ring form under the SWA substitute) a GQA layer, B1 once a
    FULL step; the SD step B1 once a FULL step (its UNet runs no kernel)."""
    from repro_torch.configs import get_config
    runs, full = 1 + DRY_RUNS, variant == "full"
    want = {"cfg_combine": runs} if full else {}
    if arch != "sd-unet":
        cfg, fwd = get_config(arch), (2 if full else 1)
        want.update(rmsnorm=_norms_a_forward(cfg) * fwd * runs,
                    decode_attention=_gqa_layers(cfg) * fwd * runs)
    return want


def _dry_run_bundles(smi: str, totals: dict) -> None:
    """``dryrun --device cuda`` on ``LAUNCH_BUNDLES``, full and cond: each
    built on meta, then run on the card with random arguments; the bytes
    the arguments asked of the card's allocator equal the meta prediction
    (``memory_allocated`` grows by at least it in 512-byte blocks); ms (3
    runs by CUDA events after a warm-up), peak memory, outputs finite,
    launches exact."""
    import torch
    from repro_torch.launch import dryrun as DR

    ms = {}
    for arch, shape in LAUNCH_BUNDLES:
        for variant in ("full", "cond"):
            gc.collect()
            torch.cuda.empty_cache()
            reset_launches()
            rec = DR.run_one(arch, shape, variant=variant, verbose=False, device="cuda")
            torch.cuda.synchronize()
            counts = launch_counts()
            if rec["status"] != "ok":
                fail(f"launch dryrun {arch}:{shape}:{variant}: {rec.get('error')}\n"
                     f"{rec.get('traceback', '')}")
            d, rl = rec["device"], rec["roofline"]
            if d["status"] != "ok" or d["requested"] != d["argument_bytes"] \
                    or d["allocated"] < d["predicted_allocated"] or not d["finite"]:
                fail(f"launch dryrun {arch}:{shape}:{variant}: on the card {d}")
            want = _bundle_want(arch, variant)
            if counts != {k: want.get(k, 0) for k in counts}:
                fail(f"launch dryrun {arch}:{shape}:{variant}: launches {counts}, want {want}")
            _add(totals, counts)
            ms[(arch, variant)] = min(d["ms"])
            log(f"[launch] dryrun --device cuda {arch}:{shape}:{variant} ({smi}): ms "
                f"{' '.join(f'{t:.3f}' for t in d['ms'])}, peak {d['peak_bytes'] / 1e9:.3f} GB, "
                f"arguments {d['argument_bytes']} B on meta = {d['requested']} B requested of "
                f"the card's allocator; memory_allocated grew {d['allocated']} B "
                f"({d['predicted_allocated']} B in 512 B blocks; the rest whole segment tails), "
                f"outputs finite; meta: counted FLOPs {rl['counted_flops']:.4e}, roofline compute "
                f"{rl['compute_s'] * 1e3:.4f} ms, memory {rl['memory_s'] * 1e3:.4f} ms "
                f"({rl['dominant']}); launches { {k: v for k, v in counts.items() if v} }")
    log(f"[launch] sd-unet denoise step cond/full: {ms[('sd-unet', 'cond')]:.3f} / "
        f"{ms[('sd-unet', 'full')]:.3f} ms = "
        f"{ms[('sd-unet', 'cond')] / ms[('sd-unet', 'full')]:.4f} (bf16, batch 64, best of 3)")


# the kernel wrappers phase 26's runs reach, by module of ``repro_torch.kernels``
LAUNCH_WRAPPERS = {"cfg_combine": ("cfg_combine", "cfg_combine_rowscale"),
                   "flash_attention": ("flash_attention",),
                   "decode_attention": ("decode_attention",),
                   "rmsnorm": ("rmsnorm",),
                   "paged_decode_attention": PAGED + ("paged_decode_attention_shard",)}


def _spec(x):
    import torch
    return (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else x


@contextlib.contextmanager
def _recording_signatures(sigs: dict):
    """Counts in ``sigs`` every call of the wrappers in ``LAUNCH_WRAPPERS``
    while the block runs, by its signature: (name, each positional
    argument's (shape, dtype) or value, each keyword's, sorted). It reads
    no tensor, so the calls a CUDA graph capture makes are recorded too.
    Each wrapper is swapped in its module and in every ``repro_torch``
    module that imported it by name (``core/guidance``)."""
    import importlib
    swaps = []
    for mod_name, names in LAUNCH_WRAPPERS.items():
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        for name in names:
            fn = getattr(mod, name)

            def spy(*a, _fn=fn, _name=name, **kw):
                key = (_name, tuple(map(_spec, a)),
                       tuple(sorted((k, _spec(v)) for k, v in kw.items())))
                sigs[key] = sigs.get(key, 0) + 1
                return _fn(*a, **kw)

            for m in [m for n, m in sys.modules.items() if n.startswith("repro_torch")]:
                if getattr(m, name, None) is fn:
                    swaps.append((m, name, fn))
                    setattr(m, name, spy)
    try:
        yield sigs
    finally:
        for m, name, fn in swaps:
            setattr(m, name, fn)


def _signature_call(key, gen):
    """``key``'s call made anew on random inputs of its shapes and dtypes,
    with the data its kernel's sweep gives such a call: positions spread
    over the second half of a linear cache, a ring wrapped (``_ring_slots``),
    rows permuted over a pool with spare rows, paged tables as
    ``_paged_case`` lays them out. -> (row name of the kernels line, out,
    plain version's out, tolerance); fails on a form it has no check for."""
    import torch
    from repro_torch.kernels import cfg_combine as KC
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.kernels import paged_decode_attention as KP
    from repro_torch.kernels import rmsnorm as KR

    name, args, kw = key
    kw, dev = dict(kw), gen.device

    def rnd(spec):
        shape, dtype = spec
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def attn_tol(dtype):
        return dict(per_row=ATTN_BF16_STEPS * BF16_STEP if dtype == torch.bfloat16 else 1e-5)

    if name == "cfg_combine" and not kw:
        u, c, scale = rnd(args[0]), rnd(args[1]), args[2]
        return name, KC.cfg_combine(u, c, scale), KC.cfg_combine_plain(u, c, scale), None
    if name == "cfg_combine_rowscale" and not kw:
        u, c = rnd(args[0]), rnd(args[1])
        (R,), dtype = args[2]
        scales = torch.tensor([4.0, 1.0], device=dev, dtype=dtype).repeat(R)[:R]
        return (name, KC.cfg_combine_rowscale(u, c, scales),
                KC.cfg_combine_rowscale_plain(u, c, scales), None)
    if name == "rmsnorm" and not kw:
        x, sc, eps = rnd(args[0]) * 3, rnd(args[1]), args[2]
        tol = dict(elementwise=2 * BF16_STEP) if x.dtype == torch.bfloat16 \
            else dict(rel_to_max=1e-5)
        return name, KR.rmsnorm(x, sc, eps), KR.rmsnorm_plain(x, sc, eps), tol
    if name == "flash_attention" and set(kw) <= {"causal", "window"}:
        q, k, v = map(rnd, args)
        return (name, KF.flash_attention(q, k, v, **kw), KF.flash_attention_plain(q, k, v, **kw),
                attn_tol(q.dtype))
    if name == "decode_attention" and set(kw) <= {"window", "slot_pos", "rows"}:
        q, k, v = map(rnd, args[:3])
        (n,), _ = args[3]
        B, (N, cap) = q.shape[0], k.shape[:2]
        window, slot, rows = kw.get("window"), kw.get("slot_pos"), kw.get("rows")
        tol = attn_tol(q.dtype)
        # distinct rows, or with repeats where the batch outnumbers the pool's
        # rows (a rank's slot rows, its spare taking the other ranks')
        r = torch.randperm(N, generator=gen, device=dev)[:B] if B <= N else \
            torch.randint(N, (B,), generator=gen, device=dev)
        if slot is None and (n == 1 or n == B):
            pos = torch.linspace(cap // 2, cap - 1, n, device=dev).round().to(torch.int32)
            if rows is None:
                return (name, KD.decode_attention(q, k, v, pos, window=window),
                        KD.decode_attention_plain(q, k, v, pos, window=window), tol)
            if n == B:
                return ("decode_attention_rows",
                        KD.decode_attention(q, k, v, pos, window=window, rows=r.int()),
                        KD.decode_attention_plain(q, k[r], v[r], pos, window=window), tol)
        elif rows is None and n == 1 and slot[0] == (cap,):
            p = 8 * cap + cap // 3
            slot_pos = _ring_slots(cap, p, gen)
            pos = torch.tensor([p], dtype=torch.int32, device=dev)
            return (name, KD.decode_attention(q, k, v, pos, window=window, slot_pos=slot_pos),
                    KD.decode_attention_plain(q, k, v, p,
                                              valid=KD.ring_valid(slot_pos, p, window)), tol)
        elif rows is not None and slot[0] == (N, cap) and n == B:
            # row b's ring, wrapped, on cache row r[b]; the other rows empty
            pos = torch.linspace(cap + 64, 3 * cap, B, device=dev).round().to(torch.int32)
            sp = torch.full((N, cap), -1, dtype=torch.int32, device=dev)
            sp[r] = torch.stack([_ring_slots(cap, p, gen) for p in pos.tolist()])
            return ("decode_attention_ring_rows",
                    KD.decode_attention(q, k, v, pos, window=window, slot_pos=sp, rows=r.int()),
                    KD.decode_attention_plain(q, k[r], v[r], pos,
                                              valid=KD.ring_valid(sp[r], pos[:, None], window)),
                    tol)
    if name in PAGED and set(kw) <= {"window"}:
        int8 = name.endswith("int8")
        (R, H, hd), dtype = args[0]
        (P, ps, K, _), _ = args[1]
        (_, nb), _ = args[5 if int8 else 3]
        q, kv, bt, pos, phase = _paged_case(gen, dtype, int8, H, K, hd, R=R, ps=ps, P=P, nb=nb)
        if [_spec(t) for t in kv] != list(args[1:5 if int8 else 3]):
            fail(f"{name}: the pools of {key} are not _paged_case's")
        return (name, _paged_call(KP, name, q, kv, bt, pos, phase, **kw)(),
                _paged_plain(KP, name, q, kv, bt, pos, phase, **kw)(), attn_tol(dtype))
    if name == "paged_decode_attention_shard" \
            and set(kw) <= {"phase", "k_scales", "v_scales", "window"}:
        int8 = kw.get("k_scales") is not None
        base = ("ragged_" if kw.get("phase") is not None else "") + "paged_decode_attention" \
            + ("_int8" if int8 else "")
        (R, H, hd), dtype = args[0]
        (P, ps, K, _), _ = args[1]
        (_, nb), _ = args[3]
        # a pool of 2P pages in two ranges: the call is the upper range's, its
        # table local ids, -1 where the lower range holds a page
        q, kv, bt, pos, phase = _paged_case(gen, dtype, int8, H, K, hd, R=R, ps=ps, P=2 * P,
                                            nb=nb, inside_out_of_range=False)
        ph = phase if kw.get("phase") is not None else None
        want = list(args[1:3]) + ([kw["k_scales"], kw["v_scales"]] if int8 else [])
        got = [_spec(t[P:]) for t in ((kv[0], kv[2], kv[1], kv[3]) if int8 else kv)]
        if got != want:
            fail(f"{base}_shard: the pools of {key} are not _paged_case's")
        win = dict(window=kw.get("window"))
        o, lse = _shard_launches(KP, base, q, kv, bt, pos, ph, 2, **win)[1]()
        po = _shard_launches(KP, base, q, kv, bt, pos, ph, 2, plain=True, **win)[1]()[0]
        exact = _shard_launches(KP, base, q, kv, bt, pos, ph, 2, plain=True, f32=True, **win)
        _shard_checks(base + "_shard", f"at the signature {_fmt_sig(key)}", o, lse,
                      exact[1]()[1])
        return base + "_shard", o, po, attn_tol(dtype)
    fail(f"[launch] no kernel check for the signature {key}")


def _fmt_sig(key) -> str:
    name, args, kw = key

    def one(x):
        return f"{'x'.join(map(str, x[0]))} {str(x[1])[6:]}" \
            if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple) else repr(x)
    return f"{name}({', '.join([one(a) for a in args] + [f'{k}={one(v)}' for k, v in kw])})"


def _check_signatures(sigs: dict, totals: dict, label: str = "launch") -> dict:
    """Each call signature the runs of a phase (``label``, its log tag: phase
    26's ``launch``, phase 27's ``a84``, phase 28's ``a85``) gave a wrapper,
    made anew on the card at its shapes and dtypes and held against its
    plain version at the tolerance of its kernel's sweep (B1 and B3
    bit-exact; the shard form's lse as ``_shard_checks`` holds it); each paged
    signature also in its int8-page form at the same geometry (the CLI's
    ``--kv-dtype int8``). Fails if a kernel (or B5 form: its kernels-line
    row) launched in the runs has no signature checked. -> {row name of
    the kernels line: max abs error}"""
    import torch
    keys = sorted(sigs, key=repr)
    for key in list(keys):
        name, args, kw = key
        if name in ("ragged_paged_decode_attention", "paged_decode_attention"):
            hd, ((P, ps, K, _), _) = args[0][0][2], args[1]
            pages, scales = ((P, ps, K, hd), torch.int8), ((P, ps, K, 1), torch.float32)
            keys.append((name + "_int8", (args[0], pages, scales, pages, scales) + args[3:], kw))
    gen = torch.Generator(device="cuda").manual_seed(26)
    errs, notes = {}, []
    for key in keys:
        row, out, ref, tol = _signature_call(key, gen)
        tag = f"at [{label}]'s signature {_fmt_sig(key)}"
        if tol is None:
            torch.cuda.synchronize()
            e = (out.float() - ref.float()).abs().max().item()
            if not torch.equal(out, ref):
                fail(f"{row} {tag}: not bit-exact, max err {e}")
            rel = 0.0
        else:
            e, rel = _err_ok(row, tag, out, ref, **tol)
        errs[row] = max(errs.get(row, 0.0), e)
        notes.append(f"{_fmt_sig(key)}{f' ({sigs[key]} calls)' if key in sigs else ' (int8 form)'}: "
                     f"err {e:.3g}" + (f" = {rel / BF16_STEP:.2f} bf16 steps of its yardstick"
                                       if tol else " (bit-exact)"))
    missing = [k for k, v in totals.items() if v and k not in errs]
    if missing:
        fail(f"[{label}] launched with no call signature checked: {missing}")
    log(f"[{label}] every call signature of the runs ({len(sigs)}, and "
        f"{len(keys) - len(sigs)} int8 forms), made anew on the card and held against the "
        f"plain version: " + "; ".join(notes))
    return errs


def phase_launch(smi: str) -> tuple[dict, dict]:
    """``[launch]``: the serve CLI at full width (static, continuous paged
    lazy with the content cache, and that over two replicas) and the
    dry-run's bundles on the card, every call signature they gave a kernel
    then held against its plain version; the meta dry-run at every shape of
    ``LAUNCH_DRY_ARCHS``. -> (launches per kernel of its runs, max abs
    error per row of the kernels line at its signatures)"""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun as DR
    totals, sigs = {}, {}
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with _recording_signatures(sigs):
        for mode, extra in LAUNCH_MODES:
            _launch_cli(mode, extra, totals)
            gc.collect()
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        _dry_run_bundles(smi, totals)
    t2 = time.perf_counter()
    errs = _check_signatures(sigs, totals)
    t3 = time.perf_counter()
    recs = [DR.run_one(a, s, verbose=False) for a in LAUNCH_DRY_ARCHS for s in SHAPES]
    bad = [(r["arch"], r["shape"], r.get("error")) for r in recs if r["status"] != "ok"]
    if bad:
        fail(f"launch dryrun on meta: {bad}")
    log(f"[launch] dryrun on meta, {' and '.join(LAUNCH_DRY_ARCHS)} at every shape: "
        f"{len(recs)} ok of {len(recs)} in {time.perf_counter() - t3:.1f} s (``--all``, "
        f"the ten archs, runs on the CPU: PERF.md); argument GB "
        + ", ".join(f"{r['arch']}:{r['shape']} "
                    f"{r['memory_analysis']['argument_size'] / 1e9:.3f}" for r in recs))
    log(f"[launch] wall {time.perf_counter() - t0:.1f} s: CLI runs {t1 - t0:.1f} s, bundles on "
        f"the card {t2 - t1:.1f} s, signature checks {t3 - t2:.1f} s, meta dry-run "
        f"{time.perf_counter() - t3:.1f} s")
    return totals, errs


A84_F = (0.0, 0.2)           # [a84] (a): the int8 linear cache's fractions
A84_N = 8                    # [a84] (b): requests of the mesh engine's trace
A84_MESHES = (("--mesh", "data,model=16,16"), ("--multi-pod",))


def _counters(metrics) -> dict:
    """A serve run's counters without its wall times."""
    return {k: v for k, v in metrics.summary().items() if k not in ("wall_s", "tick_s")}


def _a84_int8_decode(model, toks, totals: dict, rows: dict) -> None:
    """(a): ``guided_decode`` at phase 10's shape with int8 linear caches:
    its greedy logits (``teacher_forced_logits(tokens=None)``, the greedy
    generate's) graphed and eager, each with its launches; the bf16 caches'
    greedy run beside it."""
    import torch
    from repro_torch.configs.llama3_2_1b import CONFIG as cfg
    from repro_torch.core import ar_decode as AR
    from repro_torch.core.selective import GuidancePlan
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.kernels.quant import dequantize_kv

    plans = {f: GuidancePlan.suffix(DECODE_NEW, f, DECODE_SCALE) for f in A84_F}
    bf16 = {f: AR.teacher_forced_logits(model, toks, plan, None) for f, plan in plans.items()}
    with torch.no_grad():
        ref_ms = [_graph_ms(fn) for fn in _decode_steps(model, toks, DECODE_S)]
    os.environ["REPRO_KV_QUANT"] = "int8"
    try:
        with torch.no_grad():
            full, cond = _decode_steps(model, toks, DECODE_S)
            q8_ms = [_graph_ms(full), _graph_ms(cond)]
        for f, plan in plans.items():
            want = _expected_launches(cfg, plan)
            logits = {}
            for graphs in (None, False):
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits[graphs] = AR.teacher_forced_logits(model, toks, plan, None, graphs=graphs)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                counts = launch_counts()
                if counts != want:
                    fail(f"a84 int8 f={f} graphs={graphs}: launches {counts}, want {want}")
                _add(totals, counts)
                log(f"[a84] int8 linear caches, f={f} {'graphed' if graphs is None else 'eager'} "
                    f"greedy generate: {dt:.3f} s (graphs' capture included), launches exact "
                    f"{ {k: v for k, v in want.items() if v} }")
            if not torch.equal(logits[None], logits[False]):
                fail(f"a84 int8 f={f}: graphed logits differ from eager's, max "
                     f"{(logits[None] - logits[False]).abs().max().item():.3g}")
            toks8, toks16 = logits[None].argmax(-1), bf16[f].argmax(-1)
            first = [int(r.nonzero()[0]) if r.any() else DECODE_NEW for r in toks8 != toks16]
            note = ""
            if f == A84_F[-1]:
                # int8 fed the bf16 run's tokens: the caches' own difference, no flip carried
                fed = AR.teacher_forced_logits(model, toks, plan, toks16)
                d = (fed - bf16[f]).abs().max().item() / bf16[f].abs().max().item()
                moved = (fed.argmax(-1) != toks16).float().mean().item()
                note = (f"; fed the bf16 tokens, int8 logits within {d:.4f} of max|logit| of "
                        f"bf16's, argmax differs on {moved:.4f} of the steps")
                del fed
            log(f"[a84] int8 f={f}: graphed logits bit-equal to eager; "
                f"{(toks8 == toks16).sum().item()} of {toks16.numel()} greedy tokens equal the "
                f"bf16 caches', rows first differ at steps {first}{note}")
            del logits
        # B5 at the int8 path's shape, on a cache dequantized as the step reads it
        with torch.no_grad():
            _, cc = AR.prefill(model, toks)
            cc = model.prepare_decode_caches(cc, seq_len=DECODE_S,
                                             capacity=DECODE_S + DECODE_NEW)
        c = cc[0]
        k = dequantize_kv(c["k"], c["k_scale"], torch.bfloat16)
        v = dequantize_kv(c["v"], c["v_scale"], torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(84)
        q = torch.randn(DECODE_B, cfg.num_heads, cfg.resolved_head_dim, generator=gen,
                        device="cuda").bfloat16()
        pos = torch.tensor([DECODE_S - 1], dtype=torch.int32, device="cuda")
        e, rel = _err_ok("decode_attention", "on the dequantized int8 cache", KD.decode_attention(
            q, k, v, pos), KD.decode_attention_plain(q, k, v, pos),
            per_row=ATTN_BF16_STEPS * BF16_STEP)
        rows["decode_attention"] = max(rows.get("decode_attention", 0.0), e)
        log(f"[a84] B5 on layer 0's dequantized int8 cache ({tuple(k.shape)}, pos "
            f"{DECODE_S - 1}): max abs err {e:.3g} = {rel / BF16_STEP:.2f} bf16 steps of its "
            "row's max")
        del cc, c, k, v
    finally:
        del os.environ["REPRO_KV_QUANT"]
    log(f"[a84] device ms a step (graph replay, B={DECODE_B}, capacity "
        f"{DECODE_S + DECODE_NEW}): FULL {q8_ms[0]:.4f} int8 against {ref_ms[0]:.4f} bf16 "
        f"({q8_ms[0] / ref_ms[0]:.3f}x), COND {q8_ms[1]:.4f} against {ref_ms[1]:.4f} "
        f"({q8_ms[1] / ref_ms[1]:.3f}x)")
    del bf16
    model._decode_loops = {}
    torch.cuda.empty_cache()


def _a84_mesh_engine(model, totals: dict) -> None:
    """(b): the paged engine on a one-device nccl mesh against the meshless."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.configs.llama3_2_1b import CONFIG as cfg
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import ContinuousEngine

    t0 = time.perf_counter()
    mesh = make_host_mesh()
    log(f"[a84] make_host_mesh(): {mesh} in {time.perf_counter() - t0:.2f} s")
    reqs = lambda: _serve_requests(cfg, A84_N, (64, 128), 32, seed=84)  # noqa: E731
    arrivals = [0, 0, 1, 1, 2, 3, 5, 8]
    try:
        for kv_dtype in ("bf16", "int8"):
            runs = {}
            for m in (None, mesh):
                kw = dict(kv="paged", kv_dtype=kv_dtype, page_size=16, num_slots=4,
                          pass_budget=8, prompt_len=128, max_new=32, stop_on_eos=False, seed=0,
                          selective_fraction=0.2, mesh=m)
                reset_launches()
                t0 = time.perf_counter()
                eng = ContinuousEngine(model, cfg, **kw)
                out = eng.serve_trace(reqs(), arrivals)
                torch.cuda.synchronize()
                runs[m is not None] = (eng, out, time.perf_counter() - t0, launch_counts())
            (e0, o0, w0, c0), (e1, o1, w1, c1) = runs[False], runs[True]
            if o1 != o0:
                fail(f"a84 mesh engine {kv_dtype}: tokens differ from the meshless engine's")
            if _counters(e1.metrics) != _counters(e0.metrics):
                fail(f"a84 mesh engine {kv_dtype}: counters differ")
            if e1.metrics.trace.keys() != e0.metrics.trace.keys():
                fail(f"a84 mesh engine {kv_dtype}: events differ")
            if c1 != c0:
                fail(f"a84 mesh engine {kv_dtype}: launches {c1} against {c0}")
            leaves = [d for layer in e1.placed["p"] for d in layer.values()]
            if not leaves or not all(isinstance(d, DTensor) and d.placements[0] == Shard(0)
                                     for d in leaves):
                fail(f"a84 mesh engine {kv_dtype}: pool leaves are not DTensors on Shard(0)")
            if e1._pool_p[0]["k"].data_ptr() != e1.placed["p"][0]["k"].to_local().data_ptr():
                fail(f"a84 mesh engine {kv_dtype}: the steps do not write the DTensor's storage")
            _add(totals, c1)
            log(f"[a84] mesh engine {kv_dtype} on {mesh} (nccl, world 1): {len(leaves)} pool "
                f"leaves DTensors, placements {leaves[0].placements}; tokens, counters, events "
                f"and launches equal the meshless engine's ({e1.metrics.ticks} ticks); wall "
                f"{w1:.3f} s against {w0:.3f} s; launches {c1}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.cuda.empty_cache()


def _a84_dryrun() -> None:
    """(c): the meta dry-run on the production meshes."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun as DR
    for flags in A84_MESHES:
        t0 = time.perf_counter()
        recs = []
        for arch in LAUNCH_DRY_ARCHS:
            recs += DR.main([*flags, "--arch", arch])
        bad = [(r["arch"], r["shape"], r.get("error")) for r in recs if r["status"] != "ok"]
        if bad or len(recs) != len(LAUNCH_DRY_ARCHS) * len(SHAPES):
            fail(f"a84 dryrun {' '.join(flags)}: {bad}")
        log(f"[a84] dryrun {' '.join(flags)} on meta: {len(recs)} ok in "
            f"{time.perf_counter() - t0:.1f} s; one device's argument GB "
            + ", ".join(f"{r['arch']}:{r['shape']} "
                        f"{r['memory_analysis']['argument_size'] / 1e9:.4f}" for r in recs))


def phase_a84(smi: str) -> tuple[dict, dict]:
    """``[a84]``: the int8 linear cache's guided decode, the mesh engine and
    the meta dry-run on the production meshes (phase 27). -> (launches per
    kernel of its runs, max abs error per row of the kernels line)."""
    totals, sigs, errs = {}, {}, {}
    t0 = time.perf_counter()
    model, toks = _decode_model()
    with _recording_signatures(sigs):
        _a84_int8_decode(model, toks, totals, errs)
        t1 = time.perf_counter()
        _a84_mesh_engine(model, totals)
    del model
    t2 = time.perf_counter()
    for name, e in _check_signatures(sigs, totals, label="a84").items():
        errs[name] = max(errs.get(name, 0.0), e)
    t3 = time.perf_counter()
    _a84_dryrun()
    log(f"[a84] wall {time.perf_counter() - t0:.1f} s: int8 decode {t1 - t0:.1f} s, mesh "
        f"engine {t2 - t1:.1f} s, signature checks {t3 - t2:.1f} s, meta dry-run "
        f"{time.perf_counter() - t3:.1f} s; {smi}")
    return totals, errs


A85_SPLITS = (2, 4)          # [a85] (a): the page ranges the shard form is held over
A85_N = 8                    # [a85] (b): requests of the two-rank engine's trace
A85_LAYERS = 8               # [a85] (b): llama3.2-1b's depth, cut from 16 for the time:
                             # at 16 the two-rank runs alone took 67.6 s of the phase's 60
A85_RUNS = (("paged", "ragged", "bf16"), ("paged", "ragged", "int8"),
            ("paged", "signature", "bf16"), ("paged", "signature", "int8"),
            ("slot", "signature", "bf16"))
A85_MESHES = ((2, 1), (1, 2))
SHARD_LSE_TOL = 1e-3         # the shard form's lse against the float32 plain version's, abs


def _shard_launches(mod, name, q, kv, bt, pos, phase, d: int, *, plain: bool = False,
                    f32: bool = False, **kw):
    """-> d callables, the shard form on each of d page ranges of the pool,
    its table translated by ``local_table``. With ``plain`` its plain
    version: for int8 pages on q's values in float32, as ``_paged_plain``
    holds the int8 kernels; with ``f32`` too on float32 copies of q and
    bf16 pages (the exact lse the kernel's float32 scores give)."""
    int8 = name.endswith("int8")
    n = kv[0].shape[0] // d
    if plain and (f32 or int8):
        q = q.float()
        if not int8:
            kv = [t.float() for t in kv] if f32 else kv
    fn = mod.paged_attention_plain if plain else mod.paged_decode_attention_shard
    extra = dict(shard=True) if plain else {}
    out = []
    for i in range(d):
        cut = [t[i * n:(i + 1) * n] for t in kv]
        scales = dict(k_scales=cut[1], v_scales=cut[3]) if int8 else {}
        k, v = (cut[0], cut[2]) if int8 else cut
        out.append(lambda k=k, v=v, s=scales, t=mod.local_table(bt, i * n, n): (
            fn(q, k, v, t, pos, phase=phase, **s, **extra, **kw)))
    return out


def _shard_checks(name, tag, o, lse, ref_lse) -> float:
    """The shard form's lse against the exact one (``_shard_launches``'s
    ``f32``) within ``SHARD_LSE_TOL``, -inf at the same (row, head)s, and o
    zeros on a row with no key. -> max abs lse error."""
    import torch
    torch.cuda.synchronize()
    if not torch.equal(torch.isinf(lse), torch.isinf(ref_lse)):
        fail(f"{name} {tag}: lse -inf at other (row, head)s than the plain version's")
    fin = torch.isfinite(ref_lse)
    le = (lse[fin] - ref_lse[fin]).abs().max().item() if bool(fin.any()) else 0.0
    if not le <= SHARD_LSE_TOL:
        fail(f"{name} {tag}: lse off by {le:.3g} (> {SHARD_LSE_TOL})")
    empty = torch.isinf(lse).all(-1)
    if not torch.equal(o[empty], torch.zeros_like(o[empty])):
        fail(f"{name} {tag}: rows with no local key are not zeros")
    return le


def _shard_bytes(name, q, kv, bt, pos, phase, d: int, i: int) -> tuple[int, int]:
    """(bytes, flops) of one rank's shard launch: the K and V rows (and int8
    scales) of the live keys on its pages, the table entries of its rows'
    spans, q, pos (and phase), o in float32 and lse."""
    import torch
    R, H, hd = q.shape
    P, ps, K = kv[0].shape[:3]
    n = P // d
    ragged = phase is not None
    live = phase.bool() if ragged else torch.ones_like(pos, dtype=torch.bool)
    kpos = torch.arange(SERVE_NB * ps, device=q.device)
    page = bt.long()[:, kpos // ps]
    mine = (page >= i * n) & (page < (i + 1) * n) & (kpos[None] <= pos.long()[:, None])
    keys = int(mine[live].sum())
    entries = int((pos.long().clamp(max=SERVE_NB * ps - 1) // ps + 1)[live].sum())
    per_key = 2 * K * hd * kv[0].element_size() + (2 * K * 4 if name.endswith("int8") else 0)
    nbytes = (keys * per_key + int(live.sum()) * H * hd * q.element_size()
              + R * H * (hd + 1) * 4 + (int(live.sum()) + entries + (R if ragged else 0)) * 4)
    return nbytes, 4 * H * hd * keys


def _a85_kernels(smi: str) -> dict:
    """(a): B7-B10's shard form at phase 13's shape. -> {name_shard: row}."""
    import torch
    from repro_torch.dist.exchange import merge_partials
    from repro_torch.kernels import paged_decode_attention as KP

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(85)
    rows = {}
    tol = ATTN_BF16_STEPS * BF16_STEP
    for int8 in (False, True):
        q, kv, bt, pos, phase = _paged_case(gen, bf16, int8, inside_out_of_range=False)
        for name in [n for n in PAGED if n.endswith("int8") == int8]:
            ph = phase if name.startswith("ragged") else None
            errs, lse_errs = [0.0], [0.0]
            for window in (None, 200):
                kw = dict(window=window)
                whole = _paged_call(KP, name, q, kv, bt, pos, phase, **kw)()
                one = _shard_launches(KP, name, q, kv, bt, pos, ph, 1, **kw)[0]()
                if not torch.equal(one[0].to(bf16), whole):
                    fail(f"a85 {name} window={window}: d = 1 differs from the whole launch")
                for d in A85_SPLITS:
                    parts = [f() for f in _shard_launches(KP, name, q, kv, bt, pos, ph, d, **kw)]
                    plain = _shard_launches(KP, name, q, kv, bt, pos, ph, d, plain=True, **kw)
                    exact = _shard_launches(KP, name, q, kv, bt, pos, ph, d, plain=True,
                                            f32=True, **kw)
                    for i, (o, lse) in enumerate(parts):
                        tag = f"window={window} range {i} of {d}"
                        errs.append(_err_ok(name + " shard o", tag, o, plain[i]()[0],
                                            per_row=tol)[0])
                        lse_errs.append(_shard_checks("a85 " + name, tag, o, lse, exact[i]()[1]))
                    o, _ = merge_partials(torch.stack([p[0] for p in parts]),
                                          torch.stack([p[1] for p in parts]))
                    errs.append(_err_ok(name + " shard merged", f"window={window} d={d}",
                                        o.to(bf16), whole, per_row=tol)[0])
                    if ph is not None:
                        dead = o[ph == 0]
                        if not torch.equal(dead, torch.zeros_like(dead)):
                            fail(f"a85 {name} d={d}: phase-0 rows are not exact zeros")
            # the shard launches of one rank in turns with the whole launch
            whole = _paged_call(KP, name, q, kv, bt, pos, phase)
            times = {}
            for d in A85_SPLITS:
                fns = _shard_launches(KP, name, q, kv, bt, pos, ph, d)
                for turn in range(2):
                    times.setdefault("whole", []).append(time_ms(whole)[0])
                    times.setdefault(d, []).append([time_ms(f)[0] for f in fns])
            d0 = A85_SPLITS[0]
            ms = sum(sum(t) for t in times[d0]) / (len(times[d0]) * d0)
            plain_ms = time_ms(_shard_launches(KP, name, q, kv, bt, pos, ph, d0, plain=True)[0],
                               iters=20)[0]
            nbytes, flops = _shard_bytes(name, q, kv, bt, pos, ph, d0, 0)
            b_ms, b_by = bound_ms(nbytes, flops, H100_BF16_FLOPS)
            log(f"[a85] {name} shard form at R={SERVE_R} H=32 K=8 hd=64, pages "
                f"{SERVE_PAGES}x{SERVE_PS}, tables of {SERVE_NB}, window None/200: each range "
                f"within {tol:.3g} of its rows' max of the plain version (o), its lse within "
                f"{SHARD_LSE_TOL} of the float32 plain version's (max {max(lse_errs):.3g}); "
                f"merged within {tol:.3g} of the whole launch for d in {A85_SPLITS}; d = 1 "
                f"bit-equal; no-key rows zeros and -inf; max abs err {max(errs):.3g}")
            log(f"[a85] {name} us a launch in turns (whole, then each range's): " + "; ".join(
                f"d={d}: whole {times['whole'][k] * 1e3:.2f}, ranges "
                + "/".join(f"{t * 1e3:.2f}" for t in times[d][j])
                for k, (d, j) in enumerate((d, j) for d in A85_SPLITS for j in range(2)))
                + f"; range 0 of {d0}: plain {plain_ms * 1e3:.2f}, bound {b_ms * 1e3:.3f} "
                f"({b_by}: {nbytes} B, {flops} flop); {smi}")
            rows[name + "_shard"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                         bound_ms=b_ms, bound_by=b_by, max_abs_err=max(errs))
    return rows


A85_WORKER = r'''
import dataclasses, hashlib, json, sys, time
import torch
import torch.distributed as dist

rank, store, out, layers, n_req = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                   int(sys.argv[4]), int(sys.argv[5]))
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
from torch.distributed.device_mesh import init_device_mesh
import numpy as np
from repro_torch.configs.llama3_2_1b import CONFIG
from repro_torch.kernels import (cfg_combine, decode_attention, flash_attention,
                                 paged_decode_attention as KP, rmsnorm)
from repro_torch.models.transformer import Transformer
from repro_torch.serve import ContinuousEngine, ServeRequest
from chip_smoke import _recording_signatures

MODS = (cfg_combine, flash_attention, decode_attention, rmsnorm, KP)
cfg = CONFIG if layers <= 0 else dataclasses.replace(CONFIG, num_layers=layers)
t0 = time.perf_counter()
model = Transformer.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.bfloat16)
torch.cuda.synchronize()
t_init = time.perf_counter() - t0


class Rec(ContinuousEngine):
    """Keeps the logits of every step's sample (host copies), not the
    prefills': a step's are where the exchange enters."""
    rec, in_step = None, False

    def _execute(self, plan):
        self.in_step = True
        try:
            return super()._execute(plan)
        finally:
            self.in_step = False

    def _sample(self, logits, uids, temps, keys, steps):
        if self.in_step:
            self.rec.append(logits[:len(uids)].float().cpu())
        return super()._sample(logits, uids, temps, keys, steps)


def reqs():
    rng = np.random.default_rng(85)
    lens = (32, 64)
    return [ServeRequest(uid=f"q{i}", prompt=rng.integers(4, cfg.vocab_size, lens[i % 2]).tolist(),
                         max_new_tokens=16, guidance_scale=3.0, temperature=0.0,
                         prompt_len=lens[i % 2]) for i in range(n_req)]


def run(kv, step_mode, kv_dtype, mesh):
    kw = dict(kv=kv, step_mode=step_mode, num_slots=4, pass_budget=8, prompt_len=64,
              max_new=16, stop_on_eos=False, seed=0, selective_fraction=0.5)
    if kv == "paged":
        kw.update(page_size=16, kv_dtype=kv_dtype, reservation="lazy")
    for m in MODS:
        m.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng = Rec(model, cfg, mesh=mesh, graphs=False, **kw)
    eng.rec = []
    toks = eng.serve_trace(reqs(), [0, 0, 1, 1, 2, 3, 5, 8][:n_req])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    logit_bytes = b"".join(r.numpy().tobytes() for r in eng.rec)
    pools = eng._pool_p if eng._pool_p is not None else eng._pool_c + eng._pool_u
    summ = {k: v for k, v in eng.metrics.summary().items() if k not in ("wall_s", "tick_s")}
    return dict(tokens=toks, counters=summ, events=[e.kind for e in eng.metrics.trace],
                launches={k: v for m in MODS for k, v in m.LAUNCHES.items()},
                shard=dict(KP.SHARD_LAUNCHES), forms=dict(decode_attention.LAUNCH_FORMS),
                wall=wall,
                logits_sha=hashlib.sha256(logit_bytes).hexdigest(),
                pool_bytes=sum(t.numel() * t.element_size() for l in pools for t in l.values()),
                split=None if eng._shard is None else [eng._shard.lead.n, eng._shard.heads.n],
                first=eng.rec), eng


res = {"init_s": t_init, "runs": {}}
firsts, sigs = {}, {"mesh": {}, "meshless": {}}
for shape in MESHES:
    mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
    for kv, sm, dt in RUNS:
        key = f"{shape[0]}x{shape[1]} {kv} {sm} {dt}"
        with _recording_signatures(sigs["mesh"]):
            r, _ = run(kv, sm, dt, mesh)
        firsts[key] = r.pop("first")
        res["runs"][key] = r
if rank == 0:
    for kv, sm, dt in RUNS:
        with _recording_signatures(sigs["meshless"]):
            r, _ = run(kv, sm, dt, None)
        firsts[f"meshless {kv} {sm} {dt}"] = r.pop("first")
        res["runs"][f"meshless {kv} {sm} {dt}"] = r
torch.save(dict(firsts=firsts, sigs=sigs), out + ".pt")
with open(out, "w") as f:
    json.dump(res, f, default=lambda o: o.item())
dist.barrier()
dist.destroy_process_group()
'''


def _a85_engine(smi: str) -> tuple[dict, dict]:
    """(b): two processes on ``cuda:0`` over a gloo group, the engine on
    meshes (2, 1) and (1, 2) against the meshless engine's eager run; every
    call signature the runs gave a kernel wrapper (the ranks record them)
    then made anew here and held against its plain version. -> (rank 0's
    shard launches by kernel, max abs error per row of the kernels line at
    the signatures)"""
    import tempfile

    import torch
    work = tempfile.mkdtemp(prefix="a85-", dir=os.path.join(ROOT, "build"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]),
               OMP_NUM_THREADS="2")
    code = A85_WORKER.replace("MESHES", repr(A85_MESHES)).replace("RUNS", repr(A85_RUNS))
    layers = A85_LAYERS
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), os.path.join(work, "store"),
                               os.path.join(work, f"rank{r}.json"), str(layers), str(A85_N)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"a85 rank {r} exited {p.returncode}:\n{text[-4000:]}")
    res = [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(2)]
    saved = [torch.load(os.path.join(work, f"rank{r}.json.pt")) for r in range(2)]
    firsts, sigs = saved[0]["firsts"], saved[0]["sigs"]
    if saved[1]["sigs"]["mesh"] != sigs["mesh"]:
        fail("a85: the ranks' call signatures differ")
    shard, totals = {}, {}
    for r in res[0]["runs"].values():
        _add(totals, _a85_row_launches(r))
    for kv, sm, dt in A85_RUNS:
        base = res[0]["runs"][f"meshless {kv} {sm} {dt}"]
        for shape in A85_MESHES:
            key = f"{shape[0]}x{shape[1]} {kv} {sm} {dt}"
            a, b = res[0]["runs"][key], res[1]["runs"][key]
            for field in ("tokens", "counters", "events", "launches", "shard", "logits_sha"):
                if a[field] != b[field]:
                    fail(f"a85 {key}: the ranks' {field} differ")
            for field in ("counters", "events", "launches"):
                if a[field] != base[field]:
                    fail(f"a85 {key}: {field} differ from the meshless engine's: {a[field]} "
                         f"against {base[field]}")
            # every step's logits up to the first whose argmax differs: until
            # then both runs fed the same tokens
            f_mesh, f_base = firsts[key], firsts[f"meshless {kv} {sm} {dt}"]
            n = min(len(f_mesh), len(f_base))
            j = next((j for j in range(n) if not torch.equal(f_mesh[j].argmax(-1),
                                                             f_base[j].argmax(-1))), n - 1)
            e, rel = 0.0, 0.0
            for m_, b_ in zip(f_mesh[:j + 1], f_base[:j + 1]):
                ok, e1, rel1 = _within(m_, b_, rel_to_max=SERVE_LOGIT_TOL)
                if not ok:
                    fail(f"a85 {key}: a step's logits off by {rel1:.3g} of max|logit|")
                e, rel = max(e, e1), max(rel, rel1)
            same = sum(x == y for u in base["tokens"] for x, y in
                       zip(a["tokens"][u], base["tokens"][u]))
            total = sum(len(v) for v in base["tokens"].values())
            for k, n in a["shard"].items():
                if shape[0] > 1:
                    shard[k] = shard.get(k, 0) + n
            log(f"[a85] {key}: ranks bit-equal (tokens, logits sha {a['logits_sha'][:12]}, "
                f"counters, events, launches); passes {a['counters']['denoiser_passes']}, "
                f"counters, events and launches equal the meshless eager run's; split "
                f"(pages or rows, heads) {a['split']}; pool bytes a rank {a['pool_bytes']} "
                f"against {base['pool_bytes']}; the logits of samples 0-{j} (to the first "
                f"argmax that differs, or the last) within {rel:.3g} of max|logit| ({e:.3g}); "
                f"{same} of "
                f"{total} tokens equal the meshless run's; wall "
                f"{a['wall']:.2f} s against {base['wall']:.2f}; shard launches "
                f"{ {k: v for k, v in a['shard'].items() if v} }")
    log(f"[a85] two ranks on cuda:0 over gloo, llama3.2-1b full width, {A85_LAYERS} of 16 "
        "layers, "
        f"{A85_N} requests: {wall:.1f} s for both processes (model init "
        f"{res[0]['init_s']:.1f} s); {smi}")
    calls = {k: sigs["mesh"].get(k, 0) + sigs["meshless"].get(k, 0)
             for k in set(sigs["mesh"]) | set(sigs["meshless"])}
    return shard, _check_signatures(calls, totals, label="a85")


def _a85_row_launches(run: dict) -> dict:
    """A worker run's launches by row of the kernels line: the shard form's
    under ``<kernel>_shard``, B5's per-row form's under
    ``decode_attention_rows``."""
    out = dict(run["launches"])
    for name, n in run["shard"].items():
        out[name] -= n
        out[name + "_shard"] = n
    n = run["forms"].get("rows", 0)
    if n:
        out["decode_attention"] -= n
        out["decode_attention_rows"] = n
    return out


def phase_a85(smi: str) -> tuple[dict, dict, dict]:
    """``[a85]``: B7-B10's shard form and the two-rank engine (phase 28).
    -> (rows of the kernels line for the shard forms, their launches in the
    engine's runs, max abs error per row at the runs' call signatures)."""
    t0 = time.perf_counter()
    rows = _a85_kernels(smi)
    t1 = time.perf_counter()
    shard, errs = _a85_engine(smi)
    log(f"[a85] wall {time.perf_counter() - t0:.1f} s: shard kernels {t1 - t0:.1f} s, "
        f"two-rank engine and its signatures {time.perf_counter() - t1:.1f} s")
    return rows, shard, errs


def main() -> None:
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    smi = phase_device()
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the repro_torch package is not beside this script: {exc}")
    import torch

    t_lap = [time.perf_counter()]

    def lap(phases: str) -> None:
        now = time.perf_counter()
        log(f"[time] {phases} {now - t_lap[0]:.1f} s, after {t_lap[0] - t_start:.1f} s")
        t_lap[0] = now

    phase_build()
    lap("build")
    rows = phase_kernels()
    phase_parity()
    pipe, sd_launches = phase_main_path()
    phase_breakdown(pipe)
    phase_profile(pipe)
    del pipe
    torch.cuda.empty_cache()
    lap("phases 3-6")

    rows.update(phase_attn_kernels())
    phase_latency_sweeps()
    phase_alternation()
    lap("phase 7")
    phase_decode_parity()
    phase_ring_parity()
    lap("phases 8-9")
    phase_family_parity()
    lap("[fparity]")
    model, toks, ar_launches, ar_rows = phase_decode_main()
    phase_decode_breakdown(model, toks, ar_rows)
    phase_decode_profile(model, toks)
    phase_decode_profile(model, toks, graphed=True)
    phase_decode_profile(model, toks, _apg_fn(), "APG FULL")
    del model
    torch.cuda.empty_cache()
    lap("phase 10")

    rows.update(phase_paged_kernels())
    phase_paged_identity()
    phase_serve_parity()
    model, serve_launches, _ = phase_serve_main()
    phase_serve_graphs(model)
    for kv_dtype in ("bf16", "int8"):
        for graphs in (None, False):
            phase_serve_profile(model, "ragged", kv_dtype, graphs)
    lap("phases 11-13")
    rows.update(phase_slot_kernel())
    phase_slot_parity()
    slot_paths = (phase_slot_main(model), phase_lazy_main(model), phase_serving_facade(model),
                  phase_ring_slot())
    lap("phases 18-23")
    a5_launches = phase_a5(model)
    lap("phase 24")
    del model
    torch.cuda.empty_cache()

    phase_train_kernels()
    phase_train_parity()
    claims_launches = phase_claims()
    train_launches = phase_train_main()
    lap("phases 14-17")
    family_launches = phase_families(smi)
    lap("phase 25")
    launch_launches, launch_errs = phase_launch(smi)
    lap("phase 26")
    a84_launches, a84_errs = phase_a84(smi)
    lap("phase 27")
    a85_rows, a85_shard, a85_errs = phase_a85(smi)
    rows.update(a85_rows)
    lap("phase 28")
    for name, e in list(launch_errs.items()) + list(a84_errs.items()) + list(a85_errs.items()):
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], e)

    cu = "src/repro_torch/csrc/"
    kernels = {
        "cfg_combine": ("cfg_combine.cu", "src/repro/kernels/cfg_combine.py:52"),
        "cfg_combine_rowscale": ("cfg_combine.cu", "src/repro/kernels/cfg_combine.py:171"),
        "apg_combine": ("cfg_combine.cu", "src/repro/kernels/cfg_combine.py:136"),
        "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:69"),
        "decode_attention": ("decode_attention.cu", "src/repro/kernels/decode_attention.py:63"),
        "decode_attention_rows": (
            "decode_attention.cu", "src/repro/kernels/decode_attention.py:63"),
        "decode_attention_ring_rows": (
            "decode_attention.cu", "src/repro/kernels/decode_attention.py:63"),
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
    for name in PAGED:
        kernels[name + "_shard"] = kernels[name]
    out = []
    for name, (src, replaces) in kernels.items():
        if name.endswith("_shard"):
            n = a85_shard.get(name[:-len("_shard")], 0)
            if n == 0:
                fail(f"{name}: launched no time in phase 28's two-rank engine")
            log(f"[launches] {name}: {n} in phase 28's two-rank engine runs (rank 0; also "
                f"counted under {name[:-len('_shard')]}, its whole form's name, there)")
            r = {k: v for k, v in rows[name].items() if k != "host_us"}
            out.append(dict(name=name, route="cuda", source=cu + src, replaces=replaces,
                            launches=n, **r))
            continue
        sd, ar = sd_launches.get(name, 0), ar_launches.get(name, 0)
        sv = serve_launches.get(name, 0)
        sl = sum(d.get(name, 0) for d in slot_paths)
        a5 = a5_launches.get(name, 0)
        cl, tr = claims_launches.get(name, 0), train_launches.get(name, 0)
        fam, la = family_launches.get(name, 0), launch_launches.get(name, 0)
        a84 = a84_launches.get(name, 0)
        if sd + ar + sv + sl + a5 + cl + tr + fam + la + a84 == 0:
            fail(f"{name}: launched no time on the main paths")
        log(f"[launches] {name}: {sd} in the SD generate's run, {ar} in guided_decode's, "
            f"{sv} in the paged serve runs', {sl} in the slot, lazy, facade and windowed slot "
            f"runs', {a5} in phase 24's (async, tier, content, fleet, autotune), {cl} in "
            f"the claims' generates on the trained pipeline, {tr} in the timed LM training "
            f"steps, {fam} in phase 25's (the other families), {la} in phase 26's (the "
            f"serve CLI and the dry-run's bundles on the card), {a84} in phase 27's (int8 "
            f"linear caches, the mesh engine)")
        r = {k: v for k, v in rows[name].items() if k != "host_us"}
        out.append(dict(name=name, route="cuda", source=cu + src, replaces=replaces,
                        launches=sd + ar + sv + sl + a5 + cl + tr + fam + la + a84, **r))
    log(f"[time] the whole script {time.perf_counter() - t_start:.1f} s")
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
