"""The serve arena on a mesh of several devices, one process a device.

* B7-B10's shard form (``kernels/paged_decode_attention.py``), on the CPU
  (its plain version): random pools split into d in {1, 2, 3, 4} page
  ranges, each range's table translated to local ids (-1 for another
  range's page). d = 1 is bit-equal to the whole call; the ranges' (o, lse)
  merged (``dist.exchange.merge_partials``) are within 1e-5 of the whole
  call and within 2e-5 of the reference's oracle (``repro.kernels.ref``,
  the reference's own kernel-vs-oracle tolerance); a row with no key in a
  range gives zeros and -inf there, a row at phase 0 exact zeros.
* ``ContinuousEngine`` on four ``gloo`` ranks (subprocesses on a
  ``FileStore``, one torch thread each, each with a timeout of its own) on
  meshes (2, 2), (4, 1) and (1, 4): a contended lazy paged trace (bf16
  pages, ragged step; int8 pages, signature step) that preempts and copies
  shared pages on write, and the slot arena. The reduced llama3.2-1b on
  float32 weights converted from the reference's init; greedy. Each run's
  event stream and counters equal the reference's meshless engine's on the
  same weights, and every rank's tokens, logits, events and counters equal
  rank 0's. Tokens: where only kv heads or slot rows split, each rank
  computes the meshless engine's very bits, and tokens equal the port's
  meshless engine's and the reference's; where pages split, the merge of
  bf16 partials rounds otherwise than the meshless softmax, and tokens
  equal the port's meshless engine's up to each request's first step that
  the logits do not decide (``tests/test_torch_serve.py``'s guard), and the
  logits up to it are within 3% of max|logit| of the meshless ones. Each
  rank holds its shard of the meshless pool and one spare page or row, no
  more.
* What still raises on several devices, on rank 0's (2, 2) mesh.

Start the ranks by hand as the fixture does, or with ``torchrun
--nproc-per-node 4 --standalone`` around a script that builds its mesh
with ``launch.mesh.make_host_mesh(data=2, model=2, device="cpu")``.
"""

import math
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ref as JREF
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.dist import exchange as X
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import paged_decode_attention as KP
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import Transformer
from repro_torch.serve import ContinuousEngine as PortEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ["ragged_paged_decode_attention", "ragged_paged_decode_attention_int8",
           "paged_decode_attention", "paged_decode_attention_int8"]
RANK_TIMEOUT_S = 150


# -- the shard form -------------------------------------------------------------------


def _case(seed, int8, R=7, nb=4, ps=4, K=2, rep=2, hd=8, P=24):
    """A random launch whose live table entries are distinct pool pages (the
    shard form skips an out-of-range entry where the whole call clamps it);
    padding past each row's span; two rows at phase 0."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, nb * ps, size=R).astype(np.int32)
    pos[1] = 0                                  # one key: on one range only
    bt = np.full((R, nb), P + 1, np.int32)
    for r in range(R):
        live = pos[r] // ps + 1
        bt[r, :live] = rng.permutation(P)[:live]
    c = {"q": rng.standard_normal((R, K * rep, hd)).astype(np.float32), "bt": bt, "pos": pos,
         "phase": np.asarray([0, 1, 1, 0, 1, 1, 1], np.int32)[:R]}
    for n in ("k", "v"):
        if int8:
            c[n] = rng.integers(-127, 128, size=(P, ps, K, hd)).astype(np.int8)
            c[n + "s"] = (rng.random((P, ps, K, 1)) * 0.05 + 1e-3).astype(np.float32)
        else:
            c[n] = rng.standard_normal((P, ps, K, hd)).astype(np.float32)
    return c


def _args(name, c, lo=0, hi=None):
    """The call's pages [lo, hi) and the table as they hold it."""
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    sl = slice(lo, hi)
    pages = {"k_pages": t(c["k"][sl]), "v_pages": t(c["v"][sl])}
    if name.endswith("int8"):
        pages.update(k_scales=t(c["ks"][sl]), v_scales=t(c["vs"][sl]))
    phase = t(c["phase"]) if name.startswith("ragged") else None
    return t(c["q"]), pages, t(c["bt"]), t(c["pos"]), phase


def _whole(name, c, window):
    q, pages, bt, pos, phase = _args(name, c)
    kv = [pages["k_pages"], pages["v_pages"]]
    if name.endswith("int8"):
        kv = [pages["k_pages"], pages["k_scales"], pages["v_pages"], pages["v_scales"]]
    return getattr(KP, name)(q, *kv, bt, pos, *([phase] if phase is not None else []),
                             window=window)


def _ranges(name, c, d, window):
    """d ranges' (o, lse), each on its pages and its local table."""
    P = c["k"].shape[0]
    n = P // d
    out = []
    for i in range(d):
        q, pages, bt, pos, phase = _args(name, c, i * n, (i + 1) * n)
        out.append(KP.paged_decode_attention_shard(q, pages["k_pages"], pages["v_pages"],
                                                   KP.local_table(bt, i * n, n), pos,
                                                   phase=phase, window=window,
                                                   k_scales=pages.get("k_scales"),
                                                   v_scales=pages.get("v_scales")))
    return out


def _oracle(name, c, window):
    args = [jnp.asarray(c["q"]), jnp.asarray(c["k"])]
    if name.endswith("int8"):
        args.append(jnp.asarray(c["ks"]))
    args.append(jnp.asarray(c["v"]))
    if name.endswith("int8"):
        args.append(jnp.asarray(c["vs"]))
    args += [jnp.asarray(c["bt"]), jnp.asarray(c["pos"])]
    if name.startswith("ragged"):
        args.append(jnp.asarray(c["phase"]))
    return np.asarray(getattr(JREF, "ref_" + name)(*args, window=window), np.float32)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("name", KERNELS)
def test_shard_form_merges_to_the_whole_call(name, window):
    c = _case(7, name.endswith("int8"))
    whole = _whole(name, c, window)
    oracle = _oracle(name, c, window)
    assert sum(KP.LAUNCHES.values()) == 0          # CPU tensors take the plain version
    P = c["k"].shape[0]
    for d in (1, 2, 3, 4):
        parts = _ranges(name, c, d, window)
        o, lse = X.merge_partials(torch.stack([p[0] for p in parts]),
                                  torch.stack([p[1] for p in parts]))
        if d == 1:
            assert torch.equal(parts[0][0], whole) and torch.equal(o, whole)
        np.testing.assert_allclose(o.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(o.numpy(), oracle, rtol=2e-5, atol=2e-5)
        for i, (oi, li) in enumerate(parts):
            assert oi.dtype == li.dtype == torch.float32 and li.shape == oi.shape[:2]
            # the keys each row has on range i
            n = P // d
            kpos = np.arange(c["bt"].shape[1] * 4)
            pg = c["bt"][:, kpos // 4]
            valid = (kpos[None] <= c["pos"][:, None]) & (pg >= i * n) & (pg < (i + 1) * n)
            if window is not None:
                valid &= kpos[None] > c["pos"][:, None] - window
            if name.startswith("ragged"):
                valid &= c["phase"][:, None] > 0
            empty = torch.from_numpy(~valid.any(1))
            assert torch.equal(oi[empty], torch.zeros_like(oi[empty]))
            assert bool(torch.isneginf(li[empty]).all()) and bool(torch.isfinite(li[~empty]).all())
        if name.startswith("ragged"):
            dead = torch.from_numpy(c["phase"] == 0)
            assert torch.equal(o[dead], torch.zeros_like(o[dead]))
        assert d == 1 or bool(torch.isneginf(torch.stack([p[1] for p in parts])).any())


def test_merge_partials_edges():
    o = torch.randn(1, 3, 2, 4)
    lse = torch.randn(1, 3, 2)
    got = X.merge_partials(o, lse)
    assert torch.equal(got[0], o[0]) and torch.equal(got[1], lse[0])
    # a partial at -inf adds nothing, whatever its o
    o2 = torch.cat([o, torch.full_like(o, float("nan"))])
    lse2 = torch.cat([lse, torch.full_like(lse, -math.inf)])
    got2 = X.merge_partials(o2, lse2)
    assert torch.equal(got2[0], o[0]) and torch.equal(got2[1], lse[0])
    none = X.merge_partials(o2, torch.full_like(lse2, -math.inf))
    assert torch.equal(none[0], torch.zeros_like(o[0])) and bool(torch.isneginf(none[1]).all())
    # two halves of one softmax
    s, v = torch.randn(6), torch.randn(6, 4)
    parts = [(torch.softmax(s[a:b], 0) @ v[a:b], torch.logsumexp(s[a:b], 0))
             for a, b in ((0, 2), (2, 6))]
    mo, ml = X.merge_partials(torch.stack([p[0] for p in parts]),
                              torch.stack([p[1] for p in parts]))
    torch.testing.assert_close(mo, torch.softmax(s, 0) @ v)
    torch.testing.assert_close(ml, torch.logsumexp(s, 0))
    assert torch.equal(X.all_gather(v, X.Split()), v[None])


@pytest.mark.parametrize("arch,kw", [
    ("llama3.2-1b", dict(kv="paged", page_size=4, kv_dtype="int8")),
    ("llama3.2-1b", dict(kv="slot")),
    ("h2o-danube-3-4b", dict(kv="slot", prompt_len=64, max_new=8)),   # rings a row
], ids=["paged_int8", "slot", "slot_rings"])
def test_one_device_mesh_pools_start_as_the_meshless(arch, kw):
    """On one device each placed leaf is the meshless pool's, spare
    included: zeros, and a ring's slot positions -1 (empty)."""
    cfg = get_smoke_config(arch)
    model = Transformer.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    kw = dict(dict(num_slots=3, prompt_len=8, max_new=6), **kw)
    engines = [PortEngine(model, cfg, mesh=make_host_mesh(device="cpu"), **kw),
               PortEngine(model, cfg, **kw)]
    for eng in engines:
        eng._init_paged_pool() if kw["kv"] == "paged" else eng._init_pools()
    pools = [e._pool_p if kw["kv"] == "paged" else e._pool_c + e._pool_u for e in engines]
    assert engines[0].placed and engines[0]._shard is None
    for got, want in zip(*pools):
        assert got.keys() == want.keys()
        assert all(torch.equal(got[n], want[n]) for n in want)
    assert ("slot_pos" in pools[1][0]) == (arch == "h2o-danube-3-4b")


# -- the engine on four ranks -----------------------------------------------------------


# the scenarios, one source for this process and the ranks (which import
# no JAX): the contended lazy trace of ``tests/test_torch_serve_lazy.py``
# in a pool of 8 pages (so that it splits 2 and 4 ways), and the slot arena
SCENARIO_SRC = textwrap.dedent("""
    LENS, PRIOS, ARRIVALS = [5, 5, 7, 7, 6, 6], [0, 1, 0, 2, 1, 0], [0, 0, 1, 2, 2, 3]
    LAZY = dict(num_slots=6, pass_budget=6, prompt_len=8, max_new=6, stop_on_eos=False,
                kv="paged", page_size=4, prefills_per_tick=2, num_pages=8, reservation="lazy")
    SCENARIOS = {
        "paged_bf16_ragged": LAZY,
        "paged_int8_signature": dict(LAZY, kv_dtype="int8", step_mode="signature"),
        "slot": dict(num_slots=4, pass_budget=4, prompt_len=8, max_new=6, stop_on_eos=False,
                     selective_fraction=0.5),
    }
    MESHES = ((2, 2), (4, 1), (1, 4))


    def _summary(metrics):  # metrics.summary() without its wall times
        return {k: v for k, v in metrics.summary().items() if k not in ("wall_s", "tick_s")}


    def _requests(name, R):
        if name == "slot":
            return [R(uid=f"s{i}", prompt=f"slot request {i}", max_new_tokens=6,
                      guidance_scale=3.0) for i in range(6)]
        return [R(uid=f"r{i}", prompt=f"req {i}", max_new_tokens=6, guidance_scale=4.0,
                  prompt_len=LENS[i], priority=PRIOS[i]) for i in range(6)]
""")
exec(SCENARIO_SRC)
REFUSED = ("host_tier", "content_cache", "async", "mla", "recurrent", "windowed_ring",
           "kv_seq", "fleet", "graphs")


WORKER = textwrap.dedent("""
    import pickle, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    rank, store, weights, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.dist import RULES_SERVE
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import ContinuousEngine, ServeFleet, ServeRequest

    cfg = get_smoke_config("llama3.2-1b")
    model = Transformer.from_state_dict(cfg, torch.load(weights))


    class Rec(ContinuousEngine):
        def _sample(self, logits, uids, temps, keys, steps):
            for i, uid in enumerate(uids):
                self.logits.setdefault(uid, []).append(logits[i].float().numpy().copy())
            return super()._sample(logits, uids, temps, keys, steps)


    def run(name, mesh):
        eng = Rec(model, cfg, mesh=mesh, **SCENARIOS[name])
        eng.logits = {}
        toks = eng.serve_trace(_requests(name, ServeRequest), ARRIVALS)
        pools = eng._pool_p if eng._pool_p is not None else eng._pool_c + eng._pool_u
        sh = eng._shard
        return dict(tokens=toks, logits=eng.logits, keys=eng.metrics.trace.keys(),
                    summary=_summary(eng.metrics),
                    leaves=[(tuple(t.shape), t.element_size()) for l in pools
                            for t in l.values()],
                    split=(1, 1) if sh is None else (sh.lead.n, sh.heads.n),
                    balanced=eng.pages is None or eng.pages.n_free == eng.pages.num_pages)


    res = {"runs": {}, "refused": {}}
    meshes = {s: init_device_mesh("cpu", s, mesh_dim_names=("data", "model")) for s in MESHES}
    for name in SCENARIOS:
        for shape in MESHES:
            res["runs"][name, shape] = run(name, meshes[shape])
        if rank == 0:
            res["runs"][name, None] = run(name, None)
    if rank == 0:
        mesh = meshes[2, 2]
        lazy = dict(kv="paged", page_size=4, reservation="lazy", num_slots=2, prompt_len=8,
                    max_new=4)

        def refused(key, make):
            try:
                make()
            except (NotImplementedError, ValueError) as exc:
                res["refused"][key] = (type(exc).__name__, str(exc))

        def smoke(arch):
            c = get_smoke_config(arch)
            return Transformer.init(c, torch.Generator().manual_seed(0), device="cpu"), c

        E = ContinuousEngine
        refused("host_tier", lambda: E(model, cfg, mesh=mesh, host_pool_bytes=1 << 20, **lazy))
        refused("content_cache", lambda: E(model, cfg, mesh=mesh, prefix_cache="content",
                                           **lazy))
        refused("async", lambda: E(model, cfg, mesh=mesh, tick_mode="async",
                                   stop_on_eos=False, **lazy))
        refused("graphs", lambda: E(model, cfg, mesh=mesh, graphs=True, **lazy))
        refused("fleet", lambda: ServeFleet([E(model, cfg, mesh=mesh, **lazy)]))
        refused("mla", lambda: E(*smoke("deepseek-v2-lite-16b"), mesh=mesh, prompt_len=8,
                                 max_new=4))
        refused("recurrent", lambda: E(*smoke("xlstm-350m"), mesh=mesh, prompt_len=8,
                                       max_new=4))
        refused("windowed_ring", lambda: E(*smoke("h2o-danube-3-4b"), mesh=mesh,
                                           prompt_len=64, max_new=8))
        refused("kv_seq", lambda: E(model, cfg, mesh=mesh, prompt_len=8, max_new=4,
                                    rules=RULES_SERVE.override(kv_heads=()))._init_pools())
    with open(out, "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
""")


REFERENCE = textwrap.dedent("""
    import pickle, sys
    import jax
    from repro.configs import get_smoke_config
    from repro.models import layers as JL
    from repro.models import transformer as JT
    from repro.serve import ContinuousEngine, ServeRequest


    def reference(names, params=None):
        \"\"\"The reference's meshless engine on each scenario of ``names``.\"\"\"
        jcfg = get_smoke_config("llama3.2-1b")
        if params is None:
            params = JT.init_model(jcfg, JL.ArrayMaker(jax.random.PRNGKey(0)))
        out = {}
        for name in names:
            eng = ContinuousEngine(params, jcfg, **SCENARIOS[name])
            toks = eng.serve_trace(_requests(name, ServeRequest), ARRIVALS)
            out[name] = dict(tokens=toks, keys=eng.metrics.trace.keys(),
                             summary=_summary(eng.metrics))
        return out


    if __name__ == "__main__":
        with open(sys.argv[2], "wb") as f:
            pickle.dump(reference(sys.argv[1].split(",")), f)
""")
exec(REFERENCE)
# the reference's scenarios run in two processes, beside the ranks
REFERENCE_HERE = ("paged_bf16_ragged", "slot")


def _wait(procs, names):
    """Each process's output, its own timeout for each; a hung one is
    killed and reported."""
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            logs.append(f"timed out after {RANK_TIMEOUT_S} s")
    for p, name, log in zip(procs, names, logs):
        assert p.returncode == 0, f"{name}:\n{log[-4000:]}"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' runs, and the reference's meshless engine's on the
    same scenarios and weights (here and in one more process, while the
    ranks work)."""
    tmp = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    popen = lambda code, *args: subprocess.Popen(  # noqa: E731
        [sys.executable, "-c", code, *map(str, args)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    there = [n for n in SCENARIOS if n not in REFERENCE_HERE]
    procs = [popen(SCENARIO_SRC + REFERENCE, ",".join(there), tmp / "reference.pkl")]
    try:
        jcfg = jget_smoke("llama3.2-1b")
        params = JT.init_model(jcfg, JL.ArrayMaker(jax.random.PRNGKey(0)))
        torch.save(convert.from_jax_model_params(jax.tree.map(np.asarray, params)),
                   tmp / "weights.pt")
        procs += [popen(SCENARIO_SRC + WORKER, r, tmp / "store", tmp / "weights.pt",
                        tmp / f"rank{r}.pkl") for r in range(4)]
        ref = reference(REFERENCE_HERE, params)
        _wait(procs, ["the reference"] + [f"rank {r}" for r in range(4)])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(tmp / "reference.pkl", "rb") as f:
        ref.update(pickle.load(f))
    got = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got, ref


# page-split logits against the meshless run's, of max|logit|, at every step
# both runs fed the same tokens: bf16 pages attend in bf16 (the plain
# version's weights cast to q's dtype), and the ranks' partials round apart
# from the whole row's softmax. Readings, weights of PRNGKey(0): at most
# 0.0184 (bf16 ragged and int8 signature, meshes (2, 2) and (4, 1)).
PAGE_SPLIT_LOGIT_TOL = 3e-2


def _diverges_only_where_undecided(uid, mine, base, got_logits, base_logits):
    """``mine`` equals ``base`` up to the first step the logits do not
    decide: the logits of every step up to it are within
    ``PAGE_SPLIT_LOGIT_TOL`` of max|logit| of the meshless ones, and at the
    first token that differs some other token's margin under the meshless
    logits is no larger than the two runs' logits' difference there. ->
    the tokens before it."""
    n = min(len(mine), len(base))
    k = next((i for i in range(n) if mine[i] != base[i]), n)
    for i in range(min(k + 1, n)):
        a, b = base_logits[uid][i], got_logits[uid][i]
        assert np.abs(a - b).max() <= PAGE_SPLIT_LOGIT_TOL * np.abs(a).max(), (uid, i)
    if k < n:
        a, b = base_logits[uid][k], got_logits[uid][k]
        err = np.abs(a - b)
        top = a.argmax()
        slack = err[top] + err
        assert (a[top] - a <= slack)[np.arange(a.size) != top].any(), (uid, k)
    return k


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_on_a_mesh_serves_as_the_meshless(ranks, name, shape):
    got, ref = ranks
    run, base = got[0]["runs"][name, shape], got[0]["runs"][name, None]
    for r in range(1, 4):
        other = got[r]["runs"][name, shape]
        for field in ("tokens", "keys", "summary", "split"):
            assert other[field] == run[field], (r, field)
        for uid, ls in run["logits"].items():
            assert all(np.array_equal(a, b) for a, b in zip(ls, other["logits"][uid])), (r, uid)
    # the events and counters of the reference's meshless engine
    assert run["keys"] == ref[name]["keys"]
    assert run["summary"] == ref[name]["summary"]
    assert run["balanced"]
    if name != "slot":
        c = run["summary"]
        assert c["preemptions"] > 0 and c["cow_copies"] > 0 and c["shared_page_hits"] > 0
    # each rank: its shard of the meshless pool and one spare page or row
    lead, heads = run["split"]
    pages_split = name != "slot" and lead > 1
    assert (lead, heads) == {(2, 2): (2, 2), (4, 1): (4, 1), (1, 4): (1, 4)}[shape]
    for (shape_r, es), (shape_m, em) in zip(run["leaves"], base["leaves"]):
        want = (shape_m[0] - 1) // lead + 1, shape_m[1], shape_m[2] // heads, *shape_m[3:]
        assert shape_r == want and es == em
    # tokens
    if not pages_split:
        assert run["tokens"] == base["tokens"] == ref[name]["tokens"]
        assert all(np.array_equal(a, b) for uid, ls in run["logits"].items()
                   for a, b in zip(ls, base["logits"][uid]))
        return
    # every request: tokens equal up to its first undecided step (readings,
    # tokens so compared of 36: 28 bf16 ragged, 31 int8 signature, on both
    # meshes)
    assert base["tokens"] == ref[name]["tokens"]
    for uid, toks in base["tokens"].items():
        _diverges_only_where_undecided(uid, run["tokens"][uid], toks, run["logits"],
                                       base["logits"])


@pytest.mark.parametrize("option", REFUSED)
def test_what_still_raises_on_several_devices(ranks, option):
    kind, msg = ranks[0][0]["refused"][option]
    if option == "graphs":
        assert kind == "ValueError" and "eagerly" in msg
    else:
        assert kind == "NotImplementedError" and "ROADMAP" in msg, msg
