#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints one line with its seconds; any failure raises and the
script exits non-zero without printing a result):

  1. device    -- require CUDA; print the card's name and power limit,
  2. build     -- compile the combine kernels from ``src/repro_torch`` with
                  nvcc (sm_90a),
  3. kernels   -- each of the 4 CUDA kernels against its plain PyTorch
                  version on adversarial batches, and kernels 1-3 at S=1 as
                  the single-object steps: bit-equal,
  4. volatile  -- the port's main path at full width: ``serve_shards --mixed
                  --shards 256 --batch 16384 --phases 32 --skew 1.1`` on the
                  card with the kernel backend; launch counters zeroed just
                  before and read just after; every kernel must launch once
                  on every phase that touched its kind.  The first 2 phases
                  are replayed from the same initial state with the plain
                  backend (bit-equal states and responses); the 4 kernels are
                  then held bit for bit against their plain versions at the
                  main path's shapes (a routed batch of phase 3 on the state
                  after phase 2) and timed, beside the other parts of a step,
  5. durable   -- ``serve_shards --mixed --durable --shards 16 --batch 256
                  --phases 50 --threads 4`` on the card (pwb/op, pfence/op);
                  the same durable root from the kernel and plain backends;
                  crashes at a few persistence-op indices, then recover +
                  replay_pending must apply every announced op exactly once.

Then the card line (nvidia-smi), one JSON line with a record per kernel and,
last, ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/dfc_reduce/csrc/dfc_reduce.cu"
# the TPU kernels these replace (JAX package, pallas_call wrappers)
REPLACES = {
    "stack": "src/repro/kernels/dfc_reduce/kernel.py:539",
    "queue": "src/repro/kernels/dfc_reduce/kernel.py:569",
    "deque": "src/repro/kernels/dfc_reduce/kernel.py:598",
    "map": "src/repro/kernels/dfc_reduce/kernel.py:664",
}
NAMES = {"stack": "dfc_stack_reduce", "queue": "dfc_queue_reduce",
         "deque": "dfc_deque_reduce", "map": "dfc_map_reduce"}
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and the f32
# rate outside the tensor cores, used for the kernels' 32-bit scalar ops
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
FULL = ["--mixed", "--shards", "256", "--batch", "16384", "--phases", "32",
        "--skew", "1.1", "--device", "cuda"]
DURABLE = ["--mixed", "--durable", "--shards", "16", "--batch", "256",
           "--phases", "50", "--threads", "4", "--device", "cuda"]


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: ok ({time.perf_counter() - t0:.2f} s)", flush=True)


# ----------------------------------------------------------------- helpers
def bits(t):
    """A tensor's raw 32-bit pattern (so -0.0 != +0.0 and NaNs compare)."""
    import torch
    t = t.detach().contiguous()
    if t.dtype == torch.bool:
        return t.to(torch.int32)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        (bits(a) == bits(b)).all())


def max_abs_err(outs_a, outs_b):
    import torch
    err = 0.0
    for a, b in zip(outs_a, outs_b):
        if a.dtype == torch.float32 and a.numel():
            err = max(err, float((a - b).abs().max()))
    return err


def compare_outputs(what, outs_k, outs_p):
    check(len(outs_k) == len(outs_p), f"{what}: output count differs")
    for i, (a, b) in enumerate(zip(outs_k, outs_p)):
        check(same_bits(a, b), f"{what}: output {i} differs from the plain version")


def compare_states(what, a, b):
    for i, (x, y) in enumerate(zip(a.leaves(), b.leaves())):
        check(same_bits(x, y), f"{what}: state leaf {i} differs")


def cuda_ms(fn, reps, warmup=1):
    """Median CUDA-event time of ``fn`` in ms (after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def durable_digest(root):
    """Content digest of every durable file under ``root``."""
    h = hashlib.blake2b(digest_size=16)
    for p in sorted(Path(root).rglob("*")):
        if p.is_file():
            h.update(p.relative_to(root).as_posix().encode())
            h.update(b"\0")
            h.update(p.read_bytes())
            h.update(b"\1")
    return h.hexdigest()


def run_serve(serve_shards, args, hook=None):
    """``serve_shards.serve`` with its report echoed, minus the per-shard
    load line (256 entries at full width)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve_shards.serve(args, hook=hook)
    for line in buf.getvalue().splitlines():
        if not line.startswith("shard load:"):
            print(f"  serve_shards: {line}", flush=True)
    return out


# ------------------------------------------------------- kernel call sites
def kernel_inputs(kind, state, g_ops, g_params, g_keys):
    """The arguments the main path hands ``kind``'s kernel (windows built
    from ``state`` exactly as the combine step builds them)."""
    from repro_torch.kernels.dfc_reduce import ops as O
    n = g_ops.shape[1]
    if kind == "stack":
        w, sizes = O._stack_window(state, n)
        return (g_ops, g_params, w, sizes)
    if kind == "queue":
        w, sizes = O._queue_window(state, n)
        return (g_ops, g_params, w, sizes)
    if kind == "deque":
        wl, wr, sizes = O._deque_windows(state, n)
        return (g_ops, g_params, wl, wr, sizes)
    return (state.keys, state.values, state.occupied, state.active_count(),
            g_keys, g_ops, g_params)


def calls():
    from repro_torch.kernels.dfc_reduce import kernel as K
    from repro_torch.kernels.dfc_reduce import ref as R
    return {
        "stack": (K.dfc_reduce_grid_call, R.dfc_reduce_ref),
        "queue": (K.dfc_queue_reduce_grid_call, R.dfc_queue_reduce_ref),
        "deque": (K.dfc_deque_reduce_grid_call, R.dfc_deque_reduce_ref),
        "map": (K.dfc_map_reduce_grid_call, R.dfc_map_reduce_ref),
    }


def map_live(ops):
    """Live (map-op) lanes per shard: the map kernel's serial chain."""
    return ((ops >= 1) & (ops <= 4)).sum(1).cpu().numpy()


def bound(kind, args):
    """(least ms, what bounds it): each input read once and each output
    written once at the HBM rate, against the scalar ops at their peak."""
    s, n = args[0].shape if kind != "map" else args[5].shape
    if kind == "map":
        c = args[0].shape[1]
        nbytes = s * c * 12 * 2 + s * 8 + s * n * (12 + 8)
        nops = map_live(args[5]).sum() * 64  # per live lane: probe, compare, update
    else:
        wins = 2 if kind == "deque" else 1
        nbytes = s * n * (8 + 4 * wins) + s * 4 + s * n * (8 + 4 * wins) + s * 16 * wins
        nops = s * n * 40  # three rank passes over every lane
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (float(t_bytes), "bytes") if t_bytes >= t_ops else (float(t_ops), "operations")


# ------------------------------------------------------------------ phases
def phase_kernels_adversarial(torch, T):
    """Adversarial batches (empty, all pushes, pops past the bottom, drained
    queue pairs, deque right pops of left pushes, full bucket, CAS hit and
    miss, key 0, -0.0) and the single-object steps at S=1."""
    from repro_torch.kernels.dfc_reduce import ops as O
    dev = torch.device("cuda")
    fns = calls()
    n, s = 64, 3
    rng = torch.Generator().manual_seed(0)

    def ring_case(kind, rows, sizes, win_vals=()):
        ops = torch.zeros((s, n), dtype=torch.int32)
        par = torch.zeros((s, n))
        for i, (o, p) in enumerate(rows):
            ops[i, : len(o)] = torch.tensor(o, dtype=torch.int32)
            par[i, : len(p)] = torch.tensor(p, dtype=torch.float32)
        wins = [torch.zeros((s, n)) for _ in range(2 if kind == "deque" else 1)]
        for w in wins:
            for (i, j, v) in win_vals:
                w[i, j] = v
        args = [ops, par, *wins, torch.tensor(sizes, dtype=torch.int32)]
        return [a.to(dev) for a in args]

    cases = {
        "stack": [
            ring_case("stack", [([], []), ([], []), ([], [])], [0, 0, 0]),
            ring_case("stack", [([1] * n, list(range(1, n + 1))), ([1, 1], [-0.0, 2.0]),
                                ([1, 2, 1], [5.0, 0, -0.0])], [0, 0, 0]),
            ring_case("stack", [([2] * n, []), ([1, 2, 2, 2], [3.0]), ([2, 2, 2], [])],
                      [0, 0, 2], [(2, n - 2, 7.0), (2, n - 1, -0.0)]),
        ],
        "queue": [
            ring_case("queue", [([2, 2, 1, 1, 2], [0, 0, 4.0, 5.0]),
                                ([2, 2, 1, 2, 2], [0, 0, 6.0]),
                                ([1, 1, 1], [1.0, -0.0, 3.0])], [0, 1, 0], [(1, 0, 9.0)]),
        ],
        "deque": [
            ring_case("deque", [([1, 1, 4, 4, 4], [1.0, 2.0]),
                                ([3, 2, 2, 4, 1], [8.0, 0, 0, 0, -0.0]),
                                ([1, 2, 3, 4], [5.0, 0, 6.0])], [0, 1, 0], [(1, 0, 4.0)]),
        ],
    }
    for kind in ("stack", "queue", "deque"):
        opmax = 3 if kind != "deque" else 5
        rand = [torch.randint(0, opmax, (s, n), generator=rng, dtype=torch.int32),
                (torch.rand((s, n), generator=rng) * 100).round(),
                *[(torch.rand((s, n), generator=rng) * 50).round()
                  for _ in range(2 if kind == "deque" else 1)],
                torch.randint(0, n, (s,), generator=rng, dtype=torch.int32)]
        cases[kind].append([a.to(dev) for a in rand])

    # map: a full bucket, CAS hit and miss, key 0, a stored -0.0
    cap = 64
    bslots, n_buckets = T.map_geometry(cap)
    same_bucket = [k for k in range(1000)
                   if T.map_bucket_host([k], n_buckets)[0] == 0][: bslots + 1]
    lk = torch.zeros((s, n), dtype=torch.int32)
    mo = torch.zeros((s, n), dtype=torch.int32)
    mp = torch.zeros((s, n))
    lk[0, : bslots + 1] = torch.tensor(same_bucket, dtype=torch.int32)
    mo[0, : bslots + 1] = T.OP_MAP_INSERT
    mp[0, : bslots + 1] = torch.arange(1, bslots + 2, dtype=torch.float32)
    lk[1, :6] = torch.tensor([0, 0, 0, 3, 3, 0], dtype=torch.int32)
    mo[1, :6] = torch.tensor([1, 4, 4, 1, 2, 3], dtype=torch.int32)
    mp[1, :6] = torch.tensor([2.0, T.pack_cas(2, 7), T.pack_cas(2, 9), -0.0, 0, 0])
    lk[2] = torch.randint(0, 40, (n,), generator=rng, dtype=torch.int32)
    mo[2] = torch.randint(0, 5, (n,), generator=rng, dtype=torch.int32)
    mp[2] = torch.randint(0, 4, (n,), generator=rng).float()
    cases["map"] = [[a.to(dev) for a in (
        torch.zeros((s, cap), dtype=torch.int32), torch.zeros((s, cap)),
        torch.zeros((s, cap), dtype=torch.int32), torch.zeros((s,), dtype=torch.int32),
        lk, mo, mp)]]

    for kind, kcases in cases.items():
        kfn, pfn = fns[kind]
        for i, args in enumerate(kcases):
            outs_k = kfn(*args)
            torch.cuda.synchronize()
            compare_outputs(f"{kind} adversarial case {i}", outs_k, pfn(*args))

    # kernels 1-3 at S = 1: the single-object steps
    steps = {"stack": O.dfc_combine_step, "queue": O.dfc_queue_combine_step,
             "deque": O.dfc_deque_combine_step}
    for kind, step in steps.items():
        sk = T.STRUCTS[kind].init(256, device=dev)
        sp = T.STRUCTS[kind].init(256, device=dev)
        for _ in range(4):
            ops = torch.randint(0, 3 if kind != "deque" else 5, (48,), generator=rng,
                                dtype=torch.int32).to(dev)
            par = (torch.rand((48,), generator=rng) * 10).round().to(dev)
            sk, rk, kk = step(sk, ops, par)
            sp, rp, kp = step(sp, ops, par, backend="ref")
            compare_outputs(f"{kind} single-object step", (rk, kk), (rp, kp))
            compare_states(f"{kind} single-object step", sk, sp)
    # the single-object calls are kernels 1-3 at S = 1: their launch time
    single = {}
    for kind in ("stack", "queue", "deque"):
        kfn = fns[kind][0]
        args = cases[kind][-1]
        one = [a[:1].contiguous() for a in args]
        single[kind] = cuda_ms(lambda: kfn(*one), 20)
    print("single-object kernels (S=1, N=64): "
          + ", ".join(f"{NAMES[k]} {v:.4f} ms" for k, v in single.items()), flush=True)


def phase_volatile(torch, T, K, serve_shards, records):
    """The main path at full width, the plain-backend replay of its first two
    phases, and the kernels against their plain versions at its shapes."""
    from repro_torch.kernels.dfc_reduce import ops as O
    from repro_torch.runtime.dfc_shard import ShardedDFCRuntime, route_batch

    args = serve_shards.build_parser().parse_args(FULL)
    kinds_all = sorted(T.STRUCTS)
    K.reset_launches()
    seen = {"batches": [], "launch_prev": dict(K.LAUNCHES)}

    def hook(phase, rt, keys, ops, params, resp, kinds):
        touched = {rt.kinds[s] for s in set(rt.route_host(keys).tolist())}
        for k in kinds_all:
            grew = K.LAUNCHES[k] - seen["launch_prev"][k]
            check(grew == (1 if k in touched else 0),
                  f"phase {phase}: {k} kernel launched {grew} times")
        seen["launch_prev"] = dict(K.LAUNCHES)
        if phase < 2:
            seen["batches"].append((keys, ops, params, resp.clone(), kinds.copy()))
        if phase == 1:
            seen["state"] = {k: T.map_state(torch.clone, st) for k, st in rt.groups.items()}
            seen["meta"] = {c: v.clone() for c, v in rt.meta.items()}
        if phase == 2:
            seen["next"] = (keys, ops, params)

    out = run_serve(serve_shards, args, hook=hook)
    launches = dict(K.LAUNCHES)
    check(all(launches[k] > 0 for k in kinds_all), f"a kernel never launched: {launches}")
    rt = out["rt"]
    # the first phase carries one-time warm-up, so the breakdown reads the
    # median step beside the mean
    step_ms = statistics.median(out["phase_seconds"]) * 1e3
    print(f"volatile: {out['n_ops'] / out['seconds']:.1f} ops/s, "
          f"{out['seconds'] / out['phases'] * 1e3:.3f} ms/step mean, {step_ms:.3f} ms "
          f"median, first step {out['phase_seconds'][0] * 1e3:.3f} ms, "
          f"launches {launches}, per step "
          f"{ {k: v / out['phases'] for k, v in launches.items()} }", flush=True)

    # replay the first two phases from the initial state on the plain path
    rt_ref = ShardedDFCRuntime(rt.kinds, rt.n_shards, rt.capacity, rt.lanes,
                               backend="ref", device="cuda")
    for i, (keys, ops, params, resp, kinds) in enumerate(seen["batches"]):
        r2, k2 = rt_ref.step(keys, ops, params)
        check(same_bits(resp, r2), f"plain replay phase {i}: responses differ")
        check(bool((torch.from_numpy(kinds).cuda() == k2).all()),
              f"plain replay phase {i}: kinds differ")
    for k, st in seen["state"].items():
        compare_states(f"plain replay of {k} shards", st, rt_ref.groups[k])
    for c, v in seen["meta"].items():
        check(same_bits(v, rt_ref.meta[c]), f"plain replay meta {c} differs")
    del rt_ref
    print("volatile: plain-backend replay of phases 0-1 is bit-equal", flush=True)
    profile_window(torch, rt, [b[:3] for b in seen["batches"]] + [seen["next"]])

    # the kernels at the main path's shapes: phase 2's routed batch on the
    # state after phase 1, against their plain versions, timed
    keys, ops, params = seen["next"]
    dev = torch.device("cuda")
    k_t, o_t, p_t = rt._upload(keys, ops, params)
    routed = route_batch(k_t, o_t, p_t, n_shards=rt.n_shards, lanes=rt.lanes,
                         table=rt._table_dev)
    shard_ops, shard_params, shard_keys = routed[0], routed[1], routed[6]
    rows = {k: torch.tensor([s for s, kk in enumerate(rt.kinds) if kk == k],
                            dtype=torch.long, device=dev) for k in kinds_all}
    fns = calls()
    parts = {"route": cuda_ms(lambda: route_batch(
        k_t, o_t, p_t, n_shards=rt.n_shards, lanes=rt.lanes, table=rt._table_dev), 10)}
    windows_ms = splice_ms = select_ms = 0.0
    for kind in kinds_all:
        st = seen["state"][kind]
        g = (shard_ops[rows[kind]], shard_params[rows[kind]], shard_keys[rows[kind]])
        kargs = kernel_inputs(kind, st, *g)
        kfn, pfn = fns[kind]
        outs_k = kfn(*kargs)
        torch.cuda.synchronize()
        outs_p = pfn(*kargs)
        compare_outputs(f"{kind} at main-path shapes", outs_k, outs_p)
        reps, preps = (3, 2) if kind == "map" else (20, 3)
        ms = cuda_ms(lambda: kfn(*kargs), reps)
        plain_ms = cuda_ms(lambda: pfn(*kargs), preps, warmup=0)
        bound_ms, bound_by = bound(kind, kargs)
        touched = (g[0] != T.OP_NONE).any(1)
        if kind == "map":
            new = O.dfc_sharded_map_combine_step(st, g[2], g[0], g[1])[0]
        else:
            windows_ms += cuda_ms(lambda: kernel_inputs(kind, st, *g), 10)
            splice = {"stack": lambda: O._stack_splice(st, outs_k[2], outs_k[3]),
                      "queue": lambda: O._queue_splice(st, outs_k[2], outs_k[3]),
                      "deque": lambda: O._deque_splice(st, outs_k[2], outs_k[3],
                                                       outs_k[4])}[kind]
            splice_ms += cuda_ms(splice, 10)
            new = splice()
        select_ms += cuda_ms(lambda: O.select_touched(touched, new, st), 10)
        shape = tuple(kargs[5].shape if kind == "map" else kargs[0].shape)
        records[kind] = {
            "name": NAMES[kind], "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kind], "launches": launches[kind],
            "max_abs_err": max_abs_err(outs_k, outs_p), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "bit_equal": True,
        }
        extra = (f", serial lane chain: longest {int(map_live(kargs[5]).max())} live "
                 f"lanes in a shard, {int(map_live(kargs[5]).sum())} in all"
                 if kind == "map" else "")
        print(f"kernel {NAMES[kind]} S,N={shape}: {ms:.4f} ms (plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.5f} ms by {bound_by}), "
              f"{launches[kind] / out['phases']:.0f} launch/step{extra}", flush=True)
    parts.update(windows=windows_ms, splices=splice_ms, touched_select=select_ms)
    kern = sum(records[k]["ms"] for k in kinds_all)
    # each part is timed alone (its own launches and gaps), so the parts do
    # not add up to the step; the profiler line above gives the overlap-free
    # device time
    print(f"volatile step parts, each timed alone (ms), median step {step_ms:.3f}: "
          f"kernels {kern:.3f} ({kern / step_ms:.1%}), "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()), flush=True)
    return out


def profile_window(torch, rt, batches):
    """Device time by kernel and the device's busy share over the main
    path's steps, from ``torch.profiler`` on a fresh fabric of ``rt``'s
    shape (first batch as warm-up, the rest profiled)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.dfc_shard import ShardedDFCRuntime

    fresh = ShardedDFCRuntime(rt.kinds, rt.n_shards, rt.capacity, rt.lanes,
                              device="cuda")
    fresh.step(*batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            fresh.step(*b)[1].cpu()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev[ev.key] = dev.get(ev.key, 0.0) + float(ev.self_device_time_total)
    total = sum(dev.values())
    steps = len(batches) - 1
    if not total:
        print("profile: the profiler recorded no device time (busy share not "
              "measured)", flush=True)
        return
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile ({steps} steps): device busy {total / steps / 1e3:.3f} ms/step of "
          f"{wall_us / steps / 1e3:.3f} ms wall ({total / wall_us:.1%} busy); top: "
          + "; ".join(f"{k[:48]} {v / steps / 1e3:.3f} ms" for k, v in top), flush=True)


def _exactly_once(rt, sched, completed, report, kinds, lanes, capacity):
    """Recovered + replayed contents must equal the oracle: the completed
    phases, the interrupted phase on the shards that committed, and the
    replayed batch, each op applied once."""
    import numpy as np
    from repro_torch.core import torch_dfc as T
    from repro_torch.runtime.dfc_shard import sequential_hetero_reference as seq

    lists = [{} if k == "map" else [] for k in kinds]

    def flat(p):
        return [np.concatenate([b[i] for b in sched[p]]) for i in range(3)]

    for p in completed:
        f = flat(p)
        seq(kinds, lists, f[0], f[1].tolist(), f[2].tolist(), lanes, capacity=capacity)
    if len(completed) < len(sched):
        p = len(completed)
        f = flat(p)
        committed = set()
        for t, r in report.items():
            if r["token"] == p + 1:
                committed |= {v.shard for v, o in zip(r["ops"], sched[p][t][1])
                              if v.kind is not None and o != T.OP_NONE}
        trial = [dict(x) if isinstance(x, dict) else list(x) for x in lists]
        seq(kinds, trial, f[0], f[1].tolist(), f[2].tolist(), lanes, capacity=capacity)
        for s in committed:
            lists[s] = trial[s]
    replay = [rt._read_ann(t, rt._read_valid(t) & 1)
              for t, _ in (rt.last_dispatch[0] if rt.last_dispatch else ())]
    if replay:
        resp, kk = seq(kinds, lists, sum((a["keys"] for a in replay), []),
                       sum((a["ops"] for a in replay), []),
                       sum((a["params"] for a in replay), []), lanes, capacity=capacity)
        check(sum((a["val"]["kinds"] for a in replay), []) == kk,
              "replayed kinds differ from the oracle")
        check(np.array_equal(np.asarray(sum((a["val"]["resp"] for a in replay), []),
                                        np.float32), np.asarray(resp, np.float32)),
              "replayed responses differ from the oracle")
    for s, k in enumerate(kinds):
        got = rt.shard_contents(s)
        check((dict(got) if k == "map" else got) == lists[s],
              f"shard {s} after replay is not the exactly-once oracle")


def phase_durable(torch, T, K, serve_shards):
    import numpy as np
    from repro_torch.checkpoint.dfc_checkpoint import CrashNow, FaultInjector, SimFS
    from repro_torch.runtime.dfc_shard import ShardedDFCRuntime, route_keys_host

    K.reset_launches()
    out = run_serve(serve_shards, serve_shards.build_parser().parse_args(DURABLE))
    launches = dict(K.LAUNCHES)
    check(all(v > 0 for v in launches.values()), f"durable path skipped a kernel: {launches}")
    print(f"durable: pwb/op {out['pwb'] / out['n_ops']:.4f}, pfence/op "
          f"{out['pfence'] / out['n_ops']:.4f}, {out['n_ops'] / out['seconds']:.1f} ops/s, "
          f"launches {launches}", flush=True)

    kinds = [sorted(T.STRUCTS)[s % 4] for s in range(16)]
    lanes, capacity, threads, per = 256, 1024, 4, 64
    rng = np.random.default_rng(5)
    opmax = np.asarray([T.STRUCTS[k].n_opcodes for k in kinds])
    sched = []
    for _ in range(3):
        batches = []
        for _ in range(threads):
            keys = rng.integers(0, 4096, per)
            ops = rng.integers(0, opmax[route_keys_host(keys, 16)])
            params = (rng.random(per) * 100).round(2).astype(np.float32)
            batches.append((keys, ops, params))
        sched.append(batches)

    def drive(root, crash_at=None, backend="kernel"):
        inj = FaultInjector(crash_at=crash_at)
        rt = ShardedDFCRuntime(kinds, 16, capacity, lanes, fs=SimFS(root, inj),
                               n_threads=threads, backend=backend, device="cuda")
        done = []
        try:
            for p, batches in enumerate(sched):
                for t, (keys, ops, params) in enumerate(batches):
                    rt.announce(t, keys, ops, params, token=p + 1)
                rt.combine_phase()
                done.append(p)
        except CrashNow:
            return done, True, inj.count
        return done, False, inj.count

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        _, crashed, total = drive(tmp / "kernel")
        drive(tmp / "ref", backend="ref")
        check(not crashed, "dry run crashed")
        check(durable_digest(tmp / "kernel") == durable_digest(tmp / "ref"),
              "kernel and plain backends wrote different durable roots")
        points = sorted({total // 6, total // 3, total // 2, 2 * total // 3,
                         5 * total // 6, total - 1})
        for k in points:
            done, crashed, _ = drive(tmp / f"c{k}", crash_at=k)
            check(crashed, f"no crash at op {k}")
            rt, report = ShardedDFCRuntime.recover(
                SimFS(tmp / f"c{k}"), kind=kinds, n_shards=16, capacity=capacity,
                lanes=lanes, n_threads=threads, device="cuda")
            rt.replay_pending(report)
            _exactly_once(rt, sched, done, report, kinds, lanes, capacity)
        print(f"durable: {total} persistence ops per run; crash points {points} "
              "recovered and replayed exactly once", flush=True)


def main(argv=None) -> int:
    argparse.ArgumentParser(description="Smoke run of the port on one card").parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SmokeFailure(f"no src/repro_torch next to {Path(__file__).name}: "
                           "run this script from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    with phase("1 device"):
        check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
        card = smi.stdout.strip()
        print(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}",
              flush=True)
        print(card, flush=True)

    from repro_torch.core import torch_dfc as T
    from repro_torch.kernels.dfc_reduce import kernel as K
    from repro_torch.launch import serve_shards

    with phase("2 build"):
        t0 = time.perf_counter()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            lib = K.build(verbose=True)
        usage = [ln.strip() for ln in log.getvalue().splitlines() if "registers" in ln]
        print(f"build: {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s; "
              + "; ".join(usage), flush=True)

    with phase("3 kernels"):
        phase_kernels_adversarial(torch, T)

    records = {}
    with phase("4 volatile"):
        phase_volatile(torch, T, K, serve_shards, records)

    with phase("5 durable"):
        phase_durable(torch, T, K, serve_shards)

    print(card, flush=True)
    print(json.dumps({"kernels": [records[k] for k in ("stack", "queue", "deque", "map")]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
