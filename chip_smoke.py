#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints one line with its seconds; any failure raises and the
script exits non-zero without printing a result):

  1. device    -- require CUDA; print the card's name and power limit,
  2. build     -- compile the combine kernels from ``src/repro_torch`` with
                  nvcc (sm_90a), one nvcc per source, all started together,
  3. kernels   -- each of the 4 one-phase CUDA kernels against its plain
                  PyTorch version on adversarial batches, kernels 1-3 at S=1
                  as the single-object steps, and the K-phase kernel (B5)
                  against ``phase_grid_combine_ref`` for every kind at S=3,
                  K=3, N in {64, 1024} (a pass-through phase, an untouched
                  shard, committed -0.0, a negative deque ``left``, a full
                  map bucket), then on the stress cases of
                  ``kernels/dfc_reduce/cases.py`` (``STRESS``: K = 1 and 8,
                  ring slots pushed in one phase and overwritten by a later
                  one with the ring wrapping, pops of earlier phases'
                  pushes, a map bucket hit by every lane of a shard and
                  filled to R_FULL, a stored -0.0 read through a lookup and
                  a CAS, more distinct buckets in a shard than the map
                  kernels' cache holds, a row of 16,384 live lanes, rows
                  past one 16,384-lane tile and off the 16-byte vector, a
                  shard untouched in every phase; B5's ring kinds also at
                  K = 1 and the largest N the ring kernels take,
                  ``kernel.MAX_LANES``, and on ``ring_drain`` at K = 1), the
                  one-phase map kernel on the map stress cases' first phase,
                  and the one-phase ring kernels on ``ring_forward``'s,
                  ``ring_edges``' and ``ring_drain``'s first phase at N in
                  ``RING_STRESS_N`` and ``MAX_LANES`` (exactly N/2 lanes
                  eliminated, every pop past the window, pops served, paired
                  and run empty in one row, a committed size past N, rows of
                  two and more tiles, N off the 16-byte vector, the deque's
                  whole shared-memory budget): bit-equal; kernels 1-3 at S=1 timed
                  (``ms``, ``device_ms``, ``host_us``),
  4. volatile  -- the port's main path at full width: ``serve_shards --mixed
                  --shards 256 --batch 16384 --phases 32 --skew 1.1`` on the
                  card with the kernel backend; launch counters zeroed just
                  before and read just after; every kernel must launch once
                  on every phase that touched its kind.  The first 2 phases
                  are replayed from the same initial state with the plain
                  backend (bit-equal states and responses); the 4 kernels are
                  then held bit for bit against their plain versions at the
                  main path's shapes (a routed batch of phase 3 on the state
                  after phase 2) and timed, beside the other parts of a step
                  (``ms`` one call per CUDA-event pair, ``device_ms`` and
                  ``host_us`` as for the model kernels below; the three ring
                  kernels' ``device_ms``, ``host_us`` and bound also side by
                  side on one line),
  5. fused     -- the fused path at the same width on phase 4's 32
                  batches: (a) 32 ``rt.step``, (b) 4 x
                  ``hetero_phase_loop_step(K=8, phase_axis="scan")``, (c) 4 x
                  the same with ``phase_axis="grid"``: bit-equal responses,
                  kinds, final state and meta; counters zeroed before and
                  read after each run ((c) launches B5 4 times per kind and
                  no one-phase kernel); per-phase times; B5 timed at K=8
                  beside its bound (with the map's live lanes per phase), and
                  held against its plain version on one K=2 dispatch (the
                  state after phase 2, phases 3-4) and timed there; B5's
                  ``device_ms`` sums its two launches (the broadcast copy,
                  then the phases) over 5 calls, ``host_us`` over 20,
  6. durable   -- ``serve_shards --mixed --durable --shards 16 --batch 256
                  --phases 50 --threads 4`` (the seeded multi-thread driver)
                  at ``--depth 1`` and ``--depth 3`` (pwb/op, pfence/op, how
                  long retire blocked); depth 3 against depth 1 on one
                  lockstep schedule; ``phase_loop`` on both axes against the
                  serial drive (digest, per-tag counts); the same durable
                  root from the kernel and plain backends, serial and
                  pipelined; crashes at six persistence-op indices of the
                  serial, the pipelined (depth 3, chain 4) and the
                  ``phase_loop`` drives, then recover + replay_pending must
                  apply every announced op exactly once; and the depth-3
                  serve_shards run again with the flight recorder on: the
                  same durable digest and per-tag counts as untraced, and
                  the recorder's pwb/pfence counts equal the store's,
  7. serve     -- the port's serving launcher (``launch/serve.py``) at the
                  published widths, kernel backend: ``smollm-135m`` (batch 8,
                  prompt 512, 32 tokens, 16 sessions), ``falcon-mamba-7b``
                  (batch 4, prompt 512, 16 tokens, 8 sessions; 14.6 GB of
                  bf16 weights drawn on the card), then ``smollm-135m
                  --durable --priority`` run whole, crashed halfway through
                  its persistence ops and resumed with
                  ``--expect-exactly-once``.  Counters zeroed before and read
                  after each run: RMSNorm launches 2L+1 per prefill and per
                  decode step (dense) or L+1 (ssm), flash attention L per
                  dense prefill, the scan L per ssm prefill, and the tier's
                  combine kernels launch.  The first batch's prefill is
                  replayed with the plain backend (last-position logits
                  within a relative max-abs error of 5e-2 in bf16; greedy
                  token agreement over the decode printed, not gated).  The
                  three model kernels are timed at the path's shapes beside
                  their bounds, plain versions and PyTorch calls (RMSNorm
                  also at falcon's prefill rows and both decode rows; the
                  scan in its fused mode, and in its base mode with f32 dt
                  and x under ``at``), each
                  kernel in turns with its PyTorch call (library, kernel,
                  kernel, library): ``ms`` one call per CUDA-event pair,
                  ``device_ms`` device time per call (the profiler's median
                  launch of each kernel over 20 calls, or events around 20
                  calls in one CUDA graph), ``host_us`` host time per call
                  (200 calls without a synchronize),
  8. continuous -- the continuous-batching server (``--k-classes``):
                  ``smollm-135m --batch 8 --prompt-len 512 --gen 32
                  --sessions 24 --k-classes 3 --class-weights 1,2,4
                  --quantum 8 --durable --trace`` (each session prefilled
                  and decoded at batch 1): counters zeroed before and read
                  after; RMSNorm 2L+1 per prefill and per decode step,
                  flash attention L per prefill, one prefill per session and
                  gen-1 decode steps each, the tier's queue, stack and map
                  kernels once per tier phase (the trace's dispatches);
                  every session and token index exactly once; class 0
                  never passed over more than ``starvation_bound()`` times
                  in a row while queued (the tier's ``starvation_gap``);
                  the traced tier root's digest and per-tag counts equal an
                  untraced ``--tier-only`` run's; the first prefill replayed
                  on the plain backend (5e-2); crashed at the first
                  persistence op from halfway on that leaves a session
                  part-served (probed on ``--tier-only`` runs, the same
                  tier schedule) and resumed with ``--expect-exactly-once``
                  (token values against the uncrashed run printed, not
                  gated: a bf16 re-prefill may flip a near-tie), the
                  resume's first re-prefill of prompt + history (S = 512 +
                  start, a ragged flash tile) replayed on the plain backend
                  (5e-2).  Then ``falcon-mamba-7b --batch 4 --prompt-len
                  512 --gen 16 --sessions 8 --k-classes 2 --quantum 4``
                  volatile on phase 7's params (L+1 RMSNorm per prefill and
                  step, the scan L per prefill); a whole smollm run of 16
                  sessions in 8 slots under the profiler (busy share); the
                  tier's combine kernels held bit for bit on every phase
                  the tier-only run dispatched and timed on the busiest,
                  and the model kernels held and timed at batch 1 (the
                  resumed prefills' S included), under ``at`` of their
                  records, with ``continuous_launches``,
  9. lanes and resharding -- (a) ``dfc_lane_combine_step`` on both lanes
                  and ``dfc_handoff_combine_step`` on phase 4's 64 queue and
                  64 deque shards (phase 2's routed batch on the state after
                  phase 1, lanes 16,384), kernel against plain, bit for bit;
                  (b) phase 4's flags plus ``--split-backlog SPLIT_N``: the
                  split lines, each donor's buckets halved in the table,
                  every kind's kernel once a step on its (grown) group, the
                  grown kind's kernel at S + 1 on the first batch after the
                  first split bit-equal to plain, ops/s beside phase 4's;
                  (c) ``DURABLE`` plus ``--split-backlog 64`` at depth 1 and
                  3 (the CPU reference's split lines, pwb/op and pfence/op),
                  the kernel and plain roots equal at depth 1 over the
                  first 10 phases (both splits among them), then two
                  splits and a merge on 16 mixed shards crashed at six
                  persistence ops (inside both split transactions and the
                  merge, before and after the rEpoch commit), recovered
                  (the expected topology) and replayed exactly once; (d)
                  ``split_lanes=True`` on 16 mixed shards: the serial,
                  pipelined (depth 3, chain 4), seeded-driver and
                  ``phase_loop`` (both axes) drives, kernel roots equal to
                  plain and ``phase_loop``'s to the serial drive's, crashes
                  at six ops (both sides of a handoff commit among them)
                  recovered exactly once, and the jitter schedule's pwb/op
                  and pfence/op equal the CPU's; (e) ``smollm-135m`` at
                  phase 7's durable priority flags plus ``--split-lanes
                  --reshard-backlog 4 --trace``: ``splits=1``, the lane
                  pairs and pwb/op / pfence/op of the reference's
                  ``--tier-only`` run, exact launch counts (the tier's
                  kernels once per traced dispatch), the traced root equal
                  to an untraced tier-only run's, the first prefill
                  replayed on the plain backend, and crashes halfway and
                  inside the split transaction (probed on a tier-only run)
                  resumed exactly once with the split topology
                  (``queues=5``).  Each kernel record gains
                  ``lanes_reshard_launches`` (the main-path runs of (b)-(e),
                  the comparisons excluded),
  10. paper objects -- the paper's own detectable objects over the
                  simulated NVM (host code) and the vectorized combine of
                  one object: (a) ``run_dfc_counts`` and the Romulus,
                  OneFile and PMDK baselines for the stack, queue and deque,
                  push-pop and rand-op, at 1-40 threads (800 ops, seed 7,
                  think (0, 30)), the table printed, six points and the
                  baselines at 40 threads held to the reference's values on
                  the CPU (``PAPER_PINNED``, ``BASELINES_T40``) and the
                  paper's ordering at 40 threads; (b) the reference tests'
                  crash sweeps (``CRASH_SWEEPS``: each structure's small
                  workload in MIN, MAX and RANDOM and its larger one in
                  RANDOM), every crash point durably linearizable with the
                  reference's detectability verdicts; (c)
                  ``python -m repro_torch.launch.quickstart`` on the card in
                  a process of its own: the reference quickstart's lines
                  (part 2's header the port's), the stack kernel launched
                  once, its phase bit-equal to the plain version's; (d)
                  kernels 5-7 (the one-object steps, S = 1) phase by phase
                  on the 40 lanes of ``make_workloads("rand-op", 40, 800)``,
                  bit-equal to plain at every phase, 20 launches a kind,
                  each timed at N = 40 beside phase 3's N = 64.  Each kernel
                  record gains ``paper_objects_launches``,
  11. dense configs -- ``qwen2-1.5b`` (QKV bias, GQA 12/2, head dim 128)
                  and ``olmo-1b`` (non-parametric LayerNorm, MHA 16/16) at
                  their published widths, served as phase 7 serves smollm
                  (``DENSE_RUNS``: batch 8, prompt 512, 32 tokens, 16
                  sessions, volatile FIFO tier): exact launch counts (qwen2
                  RMSNorm 2L+1 per prefill and decode step, olmo none, its
                  norm being plain PyTorch; flash attention L per prefill),
                  the first batch replayed on the plain backend (5e-2),
                  prefill tok/s, decode ms per step and the device's busy
                  share; flash attention at (8, 512, 12, 2, 128) and (8,
                  512, 16, 16, 128) and RMSNorm at 4096 x 1536 timed beside
                  their bounds and PyTorch calls (under ``at``).  Each
                  kernel record gains ``dense_configs_launches``.

Phase 3 also holds the three model kernels (RMSNorm, flash attention, the
selective scan) against their plain versions at model shapes, in bf16 and
f32 (tolerances in ``MODEL_TOL``): flash attention at every head dim, a
ragged S, S = T = 1, non-causal, Hq = Hkv and a group of 4, and phase 11's
shapes; RMSNorm at both models' prefill and decode rows, qwen2's prefill
rows (4096 x 1536) and a D off the 16-byte vector; an unaligned
input to both; the scan in its base and fused modes, y and h_S, at the
serving shape, a ragged S, N = 8, S = 1 and DI, N off the 16-byte vector,
the fused mode's z the strided half of an xz (and once contiguous); and a
launch under ``torch.cuda.stream`` runs on that stream.
``--phases`` runs a subset (default all).  ``--turns DIR`` also builds the
combine kernels of the checkout at DIR and times each of them in turns with
this tree's (DIR's, this, this, DIR's) on the same inputs in phases 4 and 5,
after holding their outputs bit for bit (``turns_tree`` in the records).

Then the card line (nvidia-smi), one JSON line with a record per kernel and,
last, ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ALL_PHASES = ("1", "2", "3", "4", "5", "6", "7", "8", "9", "10", "11")
SOURCE = "src/repro_torch/kernels/dfc_reduce/csrc/dfc_reduce.cu"
GRID_SOURCE = "src/repro_torch/kernels/dfc_reduce/csrc/phase_grid.cu"
KINDS = ("stack", "queue", "deque", "map")
# the TPU kernels these replace (JAX package, pallas_call wrappers)
REPLACES = {
    "stack": "src/repro/kernels/dfc_reduce/kernel.py:539",
    "queue": "src/repro/kernels/dfc_reduce/kernel.py:569",
    "deque": "src/repro/kernels/dfc_reduce/kernel.py:598",
    "map": "src/repro/kernels/dfc_reduce/kernel.py:664",
}
GRID_REPLACES = "src/repro/kernels/dfc_reduce/ops.py:482"
NAMES = {"stack": "dfc_stack_reduce", "queue": "dfc_queue_reduce",
         "deque": "dfc_deque_reduce", "map": "dfc_map_reduce"}
GRID_NAMES = {k: f"dfc_phase_{k}" for k in KINDS}
K_PHASES = 8  # phases per fused dispatch on the main path
# (K, N, kinds) of phase 3's stress cases for B5 (kernels/dfc_reduce/cases.py):
# K = 1 and 8, every lane of a 16,384-lane row live, ring rows past one tile
# of 16,384 lanes, N off the 16-byte vector.  The map's plain version walks
# lane by lane, so the map runs at K <= 2 at full width
STRESS = ((1, 1024, KINDS), (8, 1024, KINDS), (2, 16384, KINDS), (8, 16384, KINDS[:3]),
          (3, 1003, KINDS), (2, 20000, KINDS[:3]))
MAP_STRESS_N = (1024, 16384)  # the one-phase map kernel on map_hot's phase 0
# the one-phase ring kernels on ring_forward's, ring_edges' and ring_drain's
# phase 0, and at kernel.MAX_LANES: one tile, two tiles (the second ragged), N
# off the vector
RING_STRESS_N = (64, 1001, 16384, 20000)
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and the f32
# rate outside the tensor cores, used for the kernels' 32-bit scalar ops
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
# Hopper's special-function units (exp2, log2, reciprocal): 16 results per
# SM per clock; the rate is this times the SM count and the max SM clock
# the card reports (phase 1 fills CARD)
SFU_PER_SM_CLOCK = 16
CARD = {"sms": None, "sm_clock_hz": None}
# the model kernels: source, the TPU kernel each replaces, and the tolerance
# against its plain version (absolute and relative, per dtype).  f32: both
# sides compute in f32 and sum in another order; bf16: both round the same
# f32 value to bf16, so they differ by at most a bf16 rounding (2^-8
# relative), from a last-bit difference of the f32 sums.
MODEL_KERNELS = {
    "rmsnorm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:27"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:77"),
    "selective_scan": ("src/repro_torch/kernels/mamba_scan/csrc/selective_scan.cu",
                       "src/repro/kernels/mamba_scan/kernel.py:51"),
}
MODEL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
SCAN_TOL_F32 = 1e-4  # the scan: 512 dependent steps of rounding
SCAN_SHAPES = ((4, 512, 8192, 16), (4, 200, 8192, 16), (2, 512, 8192, 8), (4, 1, 8192, 16),
               (2, 70, 100, 5))  # (B, S, DI, N) checked in phase 3
REPLAY_REL_TOL = 5e-2  # plain-backend replay of a bf16 prefill, whole model
SERVE_RUNS = {
    "smollm-135m": ["--arch", "smollm-135m", "--batch", "8", "--prompt-len", "512",
                    "--gen", "32", "--sessions", "16", "--device", "cuda"],
    "falcon-mamba-7b": ["--arch", "falcon-mamba-7b", "--batch", "4", "--prompt-len", "512",
                        "--gen", "16", "--sessions", "8", "--device", "cuda"],
}
DURABLE_SERVE = ["--durable", "--priority", "--high-every", "3"]
# phase 8: the continuous-batching server (``--k-classes``), smollm durable
# and traced with a crash, falcon volatile and shorter
CONT_RUNS = {
    "smollm-135m": ["--arch", "smollm-135m", "--batch", "8", "--prompt-len", "512",
                    "--gen", "32", "--sessions", "24", "--k-classes", "3",
                    "--class-weights", "1,2,4", "--quantum", "8", "--device", "cuda"],
    "falcon-mamba-7b": ["--arch", "falcon-mamba-7b", "--batch", "4", "--prompt-len", "512",
                        "--gen", "16", "--sessions", "8", "--k-classes", "2",
                        "--quantum", "4", "--device", "cuda"],
}
# a smollm run at the main run's mix (8 slots, sessions of 32 tokens, quantum
# 8, two batches of sessions) under the profiler: the device's busy share
CONT_PROFILE = ["--arch", "smollm-135m", "--batch", "8", "--prompt-len", "512", "--gen",
                "32", "--sessions", "16", "--k-classes", "3", "--class-weights", "1,2,4",
                "--quantum", "8", "--device", "cuda"]
FULL = ["--mixed", "--shards", "256", "--batch", "16384", "--phases", "32",
        "--skew", "1.1", "--device", "cuda"]
DURABLE = ["--mixed", "--durable", "--shards", "16", "--batch", "256",
           "--phases", "50", "--threads", "4", "--device", "cuda"]
DEVICE_CALLS = 20  # calls per profiler window: a kernel's device_ms
HOST_CALLS = 200  # calls per host-clock window: its host_us


VOLATILE = {}  # phase 4's unsplit run, printed beside phase 9's split run
SINGLE_N64 = {}  # phase 3's single-object times (N = 64), printed beside phase 10 (d)


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


def run_serve(serve_shards, args, hook=None, obs=None):
    """``serve_shards.serve`` with its report echoed, minus the per-shard
    load line (256 entries at full width); the report's lines land in
    ``out["lines"]``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve_shards.serve(args, hook=hook, obs=obs)
    out["lines"] = buf.getvalue().splitlines()
    for line in out["lines"]:
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


def ring_reads(kind, ops, sizes):
    """(params, window values) that this batch's ring combine must read:
    a param for each push, a window value for each pop that elimination
    leaves and the window serves (the deque's right pops past the right
    window read this phase's left pushes, an output)."""
    import torch
    sizes = sizes.long()
    p, q, pr, qr = ((ops == c).sum(1).long() for c in (1, 2, 3, 4))
    if kind == "queue":
        return int(p.sum()), int(torch.minimum(q, sizes).sum())
    deep_l = torch.minimum(q - torch.minimum(p, q), sizes)
    if kind == "stack":
        return int(p.sum()), int(deep_l.sum())
    deep_r = torch.minimum(qr - torch.minimum(pr, qr), sizes)
    return int((p + pr).sum()), int((deep_l + deep_r).sum())


def bound(kind, args):
    """(least ms, what bounds it): each input that the batch needs read once
    and each output written once at the HBM rate, against the scalar ops at
    their peak."""
    s, n = args[0].shape if kind != "map" else args[5].shape
    if kind == "map":
        c = args[0].shape[1]
        nbytes = s * c * 12 * 2 + s * 8 + s * n * (12 + 8)
        nops = map_live(args[5]).sum() * 64  # per live lane: probe, compare, update
    else:
        wins = 2 if kind == "deque" else 1
        n_par, n_win = ring_reads(kind, args[0], args[-1])
        # ops and sizes in; responses, kinds, segment rows and counts out
        nbytes = (s * n * 4 + 4 * (n_par + n_win) + s * 4 + s * n * (8 + 4 * wins)
                  + s * 16 * wins)
        nops = s * n * 40  # flags, ranks and routing: some 40 integer ops a lane
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (float(t_bytes), "bytes") if t_bytes >= t_ops else (float(t_ops), "operations")


# ------------------------------------------------------------------ phases
def phase_kernels_adversarial(torch, T):
    """Adversarial batches (empty, all pushes, pops past the bottom, drained
    queue pairs, deque right pops of left pushes, full bucket, CAS hit and
    miss, key 0, -0.0, the map stress cases) and the single-object steps at
    S=1."""
    import numpy as np
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

    # map: the stress cases' phase 0 (cases.py): a hot bucket filled to
    # R_FULL, a stored -0.0 read through a lookup and a CAS (+0.0 here, the
    # masked window sum), every lane of a row live, more buckets than the
    # kernel's cache holds
    from repro_torch.kernels.dfc_reduce import cases as C
    for n_map in MAP_STRESS_N:
        cases["map"].append([torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                             for a in C.map_reduce_args(C.map_hot(1, n_map))])

    for kind, kcases in cases.items():
        kfn, pfn = fns[kind]
        for i, args in enumerate(kcases):
            outs_k = kfn(*args)
            torch.cuda.synchronize()
            compare_outputs(f"{kind} adversarial case {i}", outs_k, pfn(*args))
            if kind == "map" and i > 0:
                check(bits(outs_k[4][0, 0]).item() == 0 and outs_k[5][0, 0].item() == T.R_VALUE
                      and outs_k[5][0, 3].item() == T.R_FULL,
                      f"map adversarial case {i}: +0.0 or R_FULL lost")

    # the ring kernels on the stress cases' first phase (cases.py): exactly
    # N/2 lanes eliminated, every pop past the window, pops served, paired
    # and run empty in one row, one and more tiles, N off the 16-byte vector,
    # and MAX_LANES, where the deque's elimination buffer and rank scratch
    # fill a block's shared memory
    from repro_torch.kernels.dfc_reduce import kernel as K
    ring_ns = RING_STRESS_N + (K.MAX_LANES,)
    for n_ring in ring_ns:
        for kind in ("stack", "queue", "deque"):
            kfn, pfn = fns[kind]
            for case in (C.ring_forward(kind, 1, n_ring), C.ring_edges(kind, n_ring),
                         C.ring_drain(kind, n_ring)):
                args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in C.ring_reduce_args(case)]
                outs_k = kfn(*args)
                torch.cuda.synchronize()
                what = f"{kind} {case[0]} N={n_ring}"
                compare_outputs(what, outs_k, pfn(*args))
                check(not bool((outs_k[1][C.S - 1] != T.R_NONE).any()),
                      f"{what}: the untouched shard answered")
                del outs_k, args
    print(f"one-phase ring kernels: bit-equal to their plain versions on ring_forward, "
          f"ring_edges and ring_drain at N in {ring_ns}", flush=True)

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
        kfn, pfn = fns[kind]
        args = cases[kind][-1]
        one = [a[:1].contiguous() for a in args]
        single[kind] = (cuda_ms(lambda: kfn(*one), 20), cuda_ms(lambda: pfn(*one), 20),
                        *bound(kind, one), time_combine(torch, f"{NAMES[kind]} S=1", kfn, one))
        SINGLE_N64[kind] = (single[kind][0], single[kind][4][0]["device_ms"])
    # at this size the byte and operation bounds are far below a launch's
    # latency, which is what the time measures
    print("single-object kernels (S=1, N=64): "
          + ", ".join(f"{NAMES[k]} {v[0]:.4f} ms, {timing_text(*v[4])} (plain {v[1]:.4f} ms, "
                      f"bound {v[2] * 1e6:.3f} ns by {v[3]})" for k, v in single.items()),
          flush=True)


def phase_grid_cases(torch, T, n, k_phases=3, s=3):
    """B5's adversarial inputs for every kind at S=3, K=3 and ``n`` lanes:
    phase 1 all OP_NONE, shard 2 untouched in every phase, a committed -0.0
    read in phase 0 (a stack top, a wrapped queue head, both deque ends, a
    map value), a negative deque ``left``, a map bucket filled to R_FULL."""
    import numpy as np
    cap = 2 * n  # capacity >= committed size + lanes
    rng = np.random.default_rng(n)
    epoch = np.asarray([0, 2, 4], np.int32)  # active root slots 0, 1, 0
    active = (epoch // 2) % 2
    rows = np.arange(s)
    cases = []
    for kind in KINDS:
        nops = T.STRUCTS[kind].n_opcodes
        ops = rng.integers(0, nops, (k_phases, s, n)).astype(np.int32)
        params = rng.integers(0, 30, (k_phases, s, n)).astype(np.float32)
        params[0, 0, 1] = -0.0  # a pushed or inserted -0.0
        keys = rng.integers(0, 48, (k_phases, s, n)).astype(np.int32)
        if kind == "map":
            bslots, n_buckets = T.map_geometry(cap)
            mk = np.zeros((s, cap), np.int32)
            mv = np.zeros((s, cap), np.float32)
            mo = np.zeros((s, cap), np.int32)
            count = np.zeros((s, 2), np.int32)

            def place(r, key, val):  # skipped when the bucket is full
                base = int(T.map_bucket_host([key], n_buckets)[0]) * bslots
                free = [j for j in range(bslots) if not mo[r, base + j]]
                if free:
                    j = base + free[0]
                    mk[r, j], mv[r, j], mo[r, j] = key, val, 1
                    count[r, active[r]] += 1

            bucket0 = [k for k in range(1000, 200000)
                       if T.map_bucket_host([k], n_buckets)[0] == 0][: bslots + 1]
            for key in bucket0[:bslots]:
                place(1, key, 1.0)
            for r in range(s):
                place(r, 7, -0.0)
                for key in rng.choice(np.arange(8, 48), 10, replace=False):
                    place(r, int(key), float(key % 5))
            cas = ops == T.OP_MAP_CAS
            params[cas] = rng.integers(0, 5, int(cas.sum())) * T.CAS_DOM + 2
            ops[0, 0, :3] = [T.OP_MAP_LOOKUP, T.OP_MAP_CAS, T.OP_MAP_LOOKUP]
            keys[0, 0, :3] = 7
            params[0, 0, 1] = T.pack_cas(0, 3)  # expected 0 matches the -0.0
            ops[0, 1, 0], keys[0, 1, 0] = T.OP_MAP_INSERT, bucket0[bslots]
            leaves = [mk, mv, mo, count, epoch]
        else:
            values = rng.integers(1, 50, (s, cap)).astype(np.float32)
            if kind == "stack":
                root = np.zeros((s, 2), np.int32)
                root[rows, active] = [5, 3, 4]
                values[0, 4] = -0.0
                pop = T.OP_POP
            elif kind == "queue":
                root = np.zeros((s, 2, 2), np.int32)
                root[rows, active] = [[cap - 2, cap + 3], [5, 9], [0, 2]]
                values[0, cap - 2] = -0.0
                pop = T.OP_DEQ
            else:
                root = np.zeros((s, 2, 2), np.int32)
                root[rows, active] = [[-3, 4], [-6, -1], [2, 2]]
                values[0, cap - 3] = values[1, cap - 2] = -0.0
                pop = T.OP_POPL
            ops[0, 0, 2:] = T.OP_NONE  # shard 0's first pops read the ring
            ops[0, :2, :2] = pop
            if kind == "deque":
                ops[0, :2, 2] = T.OP_POPR
            leaves = [values, root, epoch]
        ops[1] = T.OP_NONE
        ops[:, 2] = T.OP_NONE
        state = T.state_from_numpy(kind, leaves, device="cuda")
        cases.append((kind, state, *(torch.from_numpy(a).cuda() for a in (ops, params, keys))))
    return cases


def phase_grid_adversarial(torch, T):
    """B5 against its plain version, bit for bit, for every kind."""
    from repro_torch.kernels.dfc_reduce import kernel as K
    from repro_torch.kernels.dfc_reduce import ref as R
    for n in (64, 1024):
        for kind, state, ops, params, keys in phase_grid_cases(torch, T, n):
            outs_k = K.phase_grid_call(kind, state, ops, params, keys)
            torch.cuda.synchronize()
            outs_p = R.phase_grid_combine_ref(kind, state, ops, params, keys)
            compare_grid(f"phase grid {kind} N={n}", outs_k, outs_p)
            st, resp, kinds = outs_k
            check(not bool((kinds[:, 2] != T.R_NONE).any()) and not bool(
                (st.epoch[:, 2] != state.epoch[2]).any()), f"{kind}: shard 2 moved")
            for a, b in zip(st.leaves(), state.leaves()):
                check(same_bits(a[1], a[0]), f"{kind}: the pass-through phase moved")
            if kind in ("stack", "map"):  # the committed -0.0 reads back as -0.0
                check(bits(resp[0, 0, 0]).item() == bits(torch.tensor(-0.0)).item()
                      and kinds[0, 0, 0].item() == T.R_VALUE, f"{kind}: -0.0 lost")
            if kind == "map":
                check(kinds[0, 1, 0].item() == T.R_FULL, "map: full bucket not R_FULL")
    from repro_torch.kernels.dfc_reduce import cases as C
    stress = STRESS + ((1, K.MAX_LANES, KINDS[:3]),)
    drain_ns = RING_STRESS_N + (K.MAX_LANES,)

    def grid():  # every case of STRESS, then ring_drain at K = 1 on each ring kind
        for k_phases, n, kinds in stress:
            for case in C.grid_cases(k_phases, n):
                if case[1] in kinds:
                    yield k_phases, n, case
        for n in drain_ns:
            for kind in KINDS[:3]:
                yield 1, n, C.ring_drain(kind, n)

    for k_phases, n, (name, kind, leaves, keys, ops, params) in grid():
        state = T.state_from_numpy(kind, leaves, device="cuda")
        ops, params, keys = (torch.from_numpy(a).cuda() for a in (ops, params, keys))
        outs_k = K.phase_grid_call(kind, state, ops, params, keys)
        torch.cuda.synchronize()
        outs_p = R.phase_grid_combine_ref(kind, state, ops, params, keys)
        what = f"phase grid {name} {kind} K={k_phases} N={n}"
        compare_grid(what, outs_k, outs_p)
        st, resp, knd = outs_k
        check(not bool((knd[:, C.S - 1] != T.R_NONE).any()) and not bool(
            (st.epoch[:, C.S - 1] != state.epoch[C.S - 1]).any()), f"{what}: shard 2 moved")
        if kind == "map":  # the stored -0.0 reads back as -0.0 here
            check(bits(resp[0, 0, 0]).item() == bits(torch.tensor(-0.0)).item()
                  and knd[0, 0, 3].item() == T.R_FULL, f"{what}: -0.0 or R_FULL lost")
            nb = T.map_geometry(leaves[0].shape[1])[1]
            buckets = [len(set(T.map_bucket_host(keys[j, 1].cpu().numpy(), nb).tolist()))
                       for j in range(k_phases)]
            print(f"  {what}: {buckets} distinct buckets in shard 1 per phase, "
                  f"{int((knd == T.R_FULL).sum())} R_FULL", flush=True)
        del outs_k, outs_p
    print("phase grid kernel: bit-equal to its plain version for every kind at "
          "S=3, K=3, N in (64, 1024), on the stress cases (K, N) "
          f"{[(k, n) for k, n, _ in stress]}, and on ring_drain at K=1, N in {drain_ns}",
          flush=True)


def compare_grid(what, outs_k, outs_p):
    compare_states(what, outs_k[0], outs_p[0])
    compare_outputs(what, outs_k[1:], outs_p[1:])


def grid_bound(kind, state, g_ops):
    """(least ms, what bounds it) of one K-phase launch: the input state read
    once, K per-phase states written, each phase's ops, params (and keys)
    read and responses and kinds written, at the HBM rate; against the scalar
    ops at their peak."""
    k, s, n = g_ops.shape
    state_bytes = sum(leaf.numel() * leaf.element_size() for leaf in state.leaves())
    lane_bytes = s * n * (4 * (3 if kind == "map" else 2) + 8)
    nbytes = state_bytes * (1 + k) + k * lane_bytes
    if kind == "map":
        nops = int(((g_ops >= 1) & (g_ops <= 4)).sum().item()) * 64
    else:
        nops = k * s * n * 40
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (float(t_bytes), "bytes") if t_bytes >= t_ops else (float(t_ops), "operations")


PARENT = {"K": None}  # the combine-kernel module of the tree given by --turns
B5_DEVICE_CALLS, B5_HOST_CALLS = 5, 20  # B5 outputs K full states a call


def flat_outputs(outs):
    return [t for o in outs for t in (o.leaves() if hasattr(o, "leaves") else [o])]


def time_combine(torch, what, fn, args, n_dev=DEVICE_CALLS, n_host=HOST_CALLS, ms_reps=20):
    """``device_ms``, ``device_ms_by`` and ``host_us`` of the combine
    kernel's wrapper ``fn`` on ``args`` (``in_turns``); with ``--turns``, in
    turns with the same wrapper of that tree (P C C P), whose outputs are
    first held bit for bit against this tree's.  Returns (this tree's
    fields, that tree's ``ms`` / ``device_ms`` / ``host_us`` or None)."""
    other = None
    if PARENT["K"] is not None:
        pfn = getattr(PARENT["K"], fn.__name__)
        for i, (a, b) in enumerate(zip(flat_outputs(pfn(*args)), flat_outputs(fn(*args)))):
            check(same_bits(a, b), f"{what}: output {i} differs from the --turns tree's")
        other = lambda: pfn(*args)  # noqa: E731
    cur, par = in_turns(torch, lambda: fn(*args), other, n_dev, n_host, ms_reps)
    fields = {k: cur[k] for k in ("device_ms", "device_ms_by", "host_us")}
    return fields, None if par is None else {k: par[k] for k in ("ms", "device_ms", "host_us")}


def timing_text(fields, parent):
    text = (f"device {fields['device_ms']:.4f} ms ({fields['device_ms_by']}), host "
            f"{fields['host_us']:.1f} us per call")
    if parent is not None:
        text += (f"; --turns tree: {parent['ms']:.4f} ms, device {parent['device_ms']:.4f} "
                 f"ms, host {parent['host_us']:.1f} us")
    return text


def phase_fused(torch, T, K, serve_shards, records, batches):
    """The fused path at full width: step, scan and grid on the 32 batches
    ``serve_shards`` drew in phase 4, bit-equal, with launch counts,
    per-phase times, B5 at K=8 beside its bound and B5 against its plain
    version on one K=2 dispatch."""
    import numpy as np
    from repro_torch.kernels.dfc_reduce import ref as R
    from repro_torch.runtime.dfc_shard import (
        ShardedDFCRuntime, hetero_phase_loop_step, route_batch)

    args = serve_shards.build_parser().parse_args(FULL)
    kinds = [sorted(KINDS)[s % 4] for s in range(args.shards)]
    capacity, lanes = args.batch * (args.phases + 1), args.batch

    def fabric():
        return ShardedDFCRuntime(kinds, args.shards, capacity, lanes, device="cuda")

    # (a) one rt.step per phase
    rt_a = fabric()
    K.reset_launches()
    resp_a, kinds_a, step_s = [], [], []
    for p, b in enumerate(batches):
        t0 = time.perf_counter()
        r, k = rt_a.step(*b)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        resp_a.append(r)
        kinds_a.append(k)
        if p == 1:
            after2 = {k_: T.map_state(torch.clone, st) for k_, st in rt_a.groups.items()}
    launch_a = dict(K.LAUNCHES)

    # (b) scan and (c) grid: 4 dispatches of K = 8 phases
    dev = torch.device("cuda")
    chunks = []
    for d in range(args.phases // K_PHASES):
        part = batches[d * K_PHASES:(d + 1) * K_PHASES]
        chunks.append((T.to_int32(np.stack([b[0] for b in part])).to(dev),
                       torch.from_numpy(np.stack([b[1] for b in part]).astype(np.int32)).to(dev),
                       torch.from_numpy(np.stack([b[2] for b in part])).to(dev)))
    fused = {}
    for axis in ("scan", "grid"):
        rt = fabric()
        resp, knd, disp_s = [], [], []
        K.reset_launches()
        for d, (k_t, o_t, p_t) in enumerate(chunks):
            t0 = time.perf_counter()
            out = hetero_phase_loop_step(
                rt.groups, rt._table_dev, k_t, o_t, p_t, rt.meta,
                kinds=tuple(rt.kinds), lanes=rt.lanes, phase_axis=axis)
            torch.cuda.synchronize()
            disp_s.append(time.perf_counter() - t0)
            rt.groups, rt.meta = out[0], out[1]
            resp.append(out[2])
            knd.append(out[3])
            if axis == "grid" and d == 0:
                after_d1 = {k_: T.map_state(torch.clone, st) for k_, st in rt.groups.items()}
            del out
        fused[axis] = (rt, torch.cat(resp), torch.cat(knd), disp_s, dict(K.LAUNCHES))

    for axis, (rt, resp, knd, _, launches) in fused.items():
        check(same_bits(torch.stack(resp_a), resp), f"{axis}: responses differ from step")
        check(same_bits(torch.stack(kinds_a), knd), f"{axis}: kinds differ from step")
        for k_ in rt.groups:
            compare_states(f"{axis} final {k_} state", rt.groups[k_], rt_a.groups[k_])
        for c, v in rt.meta.items():
            check(same_bits(v, rt_a.meta[c]), f"{axis}: meta {c} differs from step")
    n_disp = len(chunks)
    for k_ in KINDS:
        check(launch_a[k_] == args.phases and launch_a[f"phase_grid_{k_}"] == 0,
              f"step launches {launch_a}")
        check(fused["scan"][4][k_] == args.phases
              and fused["scan"][4][f"phase_grid_{k_}"] == 0,
              f"scan launches {fused['scan'][4]}")
        check(fused["grid"][4][f"phase_grid_{k_}"] == n_disp and fused["grid"][4][k_] == 0,
              f"grid launches {fused['grid'][4]}")
    per_phase = {
        "step": statistics.median(step_s) * 1e3,
        "scan": statistics.median(fused["scan"][3]) / K_PHASES * 1e3,
        "grid": statistics.median(fused["grid"][3]) / K_PHASES * 1e3,
    }
    print(f"fused: step, scan and grid bit-equal over {args.phases} phases "
          f"(responses, kinds, final state, meta); launches step {launch_a}, scan "
          f"{fused['scan'][4]}, grid {fused['grid'][4]}", flush=True)
    print("fused: median ms per phase: "
          + ", ".join(f"{m} {v:.3f}" for m, v in per_phase.items())
          + f" (dispatch s: scan {[round(x, 4) for x in fused['scan'][3]]}, grid "
          f"{[round(x, 4) for x in fused['grid'][3]]})", flush=True)
    grid_launches = fused["grid"][4]
    del fused, rt_a
    if PARENT["K"] is not None:  # the whole grid dispatch with either tree's B5
        own = K.phase_grid_call

        def dispatch_ms(b5):
            K.phase_grid_call = b5  # ops.py looks it up at each call
            try:
                rt, ms = fabric(), []
                for k_t, o_t, p_t in chunks:
                    t0 = time.perf_counter()
                    out = hetero_phase_loop_step(
                        rt.groups, rt._table_dev, k_t, o_t, p_t, rt.meta,
                        kinds=tuple(rt.kinds), lanes=rt.lanes, phase_axis="grid")
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    rt.groups, rt.meta = out[0], out[1]
                    del out
            finally:
                K.phase_grid_call = own
            return statistics.median(ms)
        other = PARENT["K"].phase_grid_call
        p1, c1, c2, p2 = (dispatch_ms(b5) for b5 in (other, own, own, other))
        print(f"fused: grid dispatch of {K_PHASES} phases, median ms in turns with the --turns "
              f"tree's B5 (P C C P): {p1:.3f} {c1:.3f} {c2:.3f} {p2:.3f}", flush=True)

    def routed_groups(lo, hi):
        rows = {k_: torch.tensor([s for s, kk in enumerate(kinds) if kk == k_],
                                 dtype=torch.long, device=dev) for k_ in KINDS}
        table = torch.arange(args.shards, dtype=torch.int32, device=dev)
        routed = [route_batch(T.to_int32(b[0]).to(dev),
                              torch.from_numpy(b[1].astype(np.int32)).to(dev),
                              torch.from_numpy(b[2]).to(dev), n_shards=args.shards,
                              lanes=lanes, table=table) for b in batches[lo:hi]]
        ops = torch.stack([r[0] for r in routed])
        params = torch.stack([r[1] for r in routed])
        keys = torch.stack([r[6] for r in routed])
        return {k_: (ops[:, rows[k_]].contiguous(), params[:, rows[k_]].contiguous(),
                     keys[:, rows[k_]].contiguous()) for k_ in KINDS}

    # B5 at the main path's shapes: dispatch 2's phases on the state after
    # dispatch 1
    g8 = routed_groups(K_PHASES, 2 * K_PHASES)
    for k_ in KINDS:
        g_ops, g_params, g_keys = g8[k_]
        st = after_d1[k_]
        ms8 = cuda_ms(lambda: K.phase_grid_call(k_, st, g_ops, g_params, g_keys), 3)
        b8, by8 = grid_bound(k_, st, g_ops)
        t8, p8 = time_combine(torch, f"{GRID_NAMES[k_]} K={K_PHASES}", K.phase_grid_call,
                              (k_, st, g_ops, g_params, g_keys), B5_DEVICE_CALLS,
                              B5_HOST_CALLS, 5)
        extra = ""
        if k_ == "map":
            live = [map_live(g_ops[j]) for j in range(K_PHASES)]
            extra = (", serial lane chain per phase: longest "
                     f"{[int(x.max()) for x in live]} live lanes in a shard, "
                     f"{[int(x.sum()) for x in live]} in all")
        print(f"kernel {GRID_NAMES[k_]} K,S,N={tuple(g_ops.shape)}: {ms8:.4f} ms per "
              f"launch, {ms8 / K_PHASES:.4f} ms per phase (bound {b8:.4f} ms by {by8}), "
              f"{timing_text(t8, p8)}; {grid_launches[f'phase_grid_{k_}']} launches on the "
              f"main path ({K_PHASES} phases each){extra}", flush=True)
        records[f"phase_grid_{k_}"] = {
            "ms_k8": ms8, "bound_ms_k8": b8, "device_ms_k8": t8["device_ms"],
            "device_ms_by_k8": t8["device_ms_by"], "host_us_k8": t8["host_us"]}
        if p8 is not None:
            records[f"phase_grid_{k_}"]["turns_tree_k8"] = p8
    del g8, after_d1

    # B5 against its plain version: one K=2 dispatch (phases 3-4) on the
    # state after phase 2
    g2 = routed_groups(2, 4)
    for k_ in KINDS:
        g_ops, g_params, g_keys = g2[k_]
        st = after2[k_]
        outs_k = K.phase_grid_call(k_, st, g_ops, g_params, g_keys)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs_p = R.phase_grid_combine_ref(k_, st, g_ops, g_params, g_keys)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        compare_grid(f"phase grid {k_} at main-path shapes", outs_k, outs_p)
        err = max_abs_err(outs_k[1:], outs_p[1:])
        del outs_k, outs_p
        ms = cuda_ms(lambda: K.phase_grid_call(k_, st, g_ops, g_params, g_keys), 5)
        bound_ms, bound_by = grid_bound(k_, st, g_ops)
        t2, p2 = time_combine(torch, f"{GRID_NAMES[k_]} K=2", K.phase_grid_call,
                              (k_, st, g_ops, g_params, g_keys), B5_DEVICE_CALLS,
                              B5_HOST_CALLS, 5)
        records[f"phase_grid_{k_}"].update({
            "name": GRID_NAMES[k_], "route": "cuda", "source": GRID_SOURCE,
            "replaces": GRID_REPLACES, "launches": grid_launches[f"phase_grid_{k_}"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "bit_equal": True,
            "k_phases": 2, **t2,
        })
        if p2 is not None:
            records[f"phase_grid_{k_}"]["turns_tree"] = p2
        print(f"kernel {GRID_NAMES[k_]} K,S,N={tuple(g_ops.shape)}: bit-equal to its plain "
              f"version; {ms:.4f} ms, {timing_text(t2, p2)} (plain {plain_ms:.1f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by})", flush=True)


def phase_volatile(torch, T, K, serve_shards, records):
    """The main path at full width, the plain-backend replay of its first two
    phases, and the kernels against their plain versions at its shapes."""
    from repro_torch.kernels.dfc_reduce import ops as O
    from repro_torch.runtime.dfc_shard import ShardedDFCRuntime, route_batch

    args = serve_shards.build_parser().parse_args(FULL)
    kinds_all = sorted(T.STRUCTS)
    K.reset_launches()
    seen = {"batches": [], "all": [], "launch_prev": dict(K.LAUNCHES)}

    def hook(phase, rt, keys, ops, params, resp, kinds):
        touched = {rt.kinds[s] for s in set(rt.route_host(keys).tolist())}
        for k in kinds_all:
            grew = K.LAUNCHES[k] - seen["launch_prev"][k]
            check(grew == (1 if k in touched else 0),
                  f"phase {phase}: {k} kernel launched {grew} times")
        seen["launch_prev"] = dict(K.LAUNCHES)
        seen["all"].append((keys, ops, params))
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
    VOLATILE["text"] = f"{out['n_ops'] / out['seconds']:.1f} ops/s, {step_ms:.3f} ms median phase"
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
        timing, other = time_combine(torch, NAMES[kind], kfn, kargs)
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
            "library_ms": None, "bit_equal": True, **timing,
        }
        if other is not None:
            records[kind]["turns_tree"] = other
        extra = (f", serial lane chain: longest {int(map_live(kargs[5]).max())} live "
                 f"lanes in a shard, {int(map_live(kargs[5]).sum())} in all"
                 if kind == "map" else "")
        print(f"kernel {NAMES[kind]} S,N={shape}: {ms:.4f} ms, {timing_text(timing, other)} "
              f"(plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms by {bound_by}), "
              f"{launches[kind] / out['phases']:.0f} launch/step{extra}", flush=True)
    ring_line = []
    for k in ("stack", "queue", "deque"):
        r = records[k]
        text = (f"{NAMES[k]} {r['device_ms']:.4f} / {r['host_us']:.1f} / {r['bound_ms']:.4f} "
                f"({r['device_ms'] / r['bound_ms']:.2f}x)")
        if "turns_tree" in r:
            text += (f" [--turns tree {r['turns_tree']['device_ms']:.4f} / "
                     f"{r['turns_tree']['host_us']:.1f}]")
        ring_line.append(text)
    print("ring kernels at the main path's shapes, device ms / host us / bound ms (device "
          "over bound): " + ", ".join(ring_line), flush=True)
    parts.update(windows=windows_ms, splices=splice_ms, touched_select=select_ms)
    kern = sum(records[k]["ms"] for k in kinds_all)
    # each part is timed alone (its own launches and gaps), so the parts do
    # not add up to the step; the profiler line above gives the overlap-free
    # device time
    print(f"volatile step parts, each timed alone (ms), median step {step_ms:.3f}: "
          f"kernels {kern:.3f} ({kern / step_ms:.1%}), "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()), flush=True)
    return seen["all"]


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


def _values(rt, kinds):
    """Every committed value of the fabric (a map entry's value)."""
    out = []
    for s, k in enumerate(kinds):
        got = rt.shard_contents(s)
        out += [v for _, v in got] if k == "map" else got
    return sorted(out)


def phase_durable(torch, T, K, serve_shards):
    import numpy as np
    from repro_torch.checkpoint.dfc_checkpoint import CrashNow, FaultInjector, SimFS
    from repro_torch.obs import FabricObserver, durable_digest
    from repro_torch.runtime.dfc_shard import ShardedDFCRuntime, route_keys_host

    untraced = {}
    for depth in (1, 3):
        K.reset_launches()
        out = run_serve(serve_shards, serve_shards.build_parser().parse_args(
            DURABLE + ["--depth", str(depth)]))
        launches = dict(K.LAUNCHES)
        check(all(launches[k] > 0 for k in KINDS), f"durable path skipped a kernel: {launches}")
        print(f"durable depth {depth}: pwb/op {out['pwb'] / out['n_ops']:.4f}, pfence/op "
              f"{out['pfence'] / out['n_ops']:.4f}, {out['n_ops'] / out['seconds']:.1f} ops/s, "
              f"retire blocked {out['retire_wait_s'] * 1e3:.3f} ms in all "
              f"({out['retire_wait_s'] / out['phases'] * 1e3:.4f} ms per phase), "
              f"launches {launches}", flush=True)
        untraced[depth] = out
    # the flight recorder on the depth-3 run: a pure observer
    obs = FabricObserver()
    out = run_serve(serve_shards, serve_shards.build_parser().parse_args(
        DURABLE + ["--depth", "3"]), obs=obs)
    ref = untraced[3]
    check((out["digest"], out["pstats"]) == (ref["digest"], ref["pstats"]),
          "traced depth 3: the durable root or the per-tag counts differ from the untraced run's")
    counted = {ev: sum(v for key, v in obs.metrics.counters.items()
                       if key.startswith(f"obs_{ev}{{")) for ev in ("pwb", "pfence")}
    check(counted == {"pwb": out["pwb"], "pfence": out["pfence"]},
          f"traced depth 3: the recorder saw {counted}, the store counted "
          f"{out['pwb']} pwb, {out['pfence']} pfence")
    kinds_seen = sorted({e["ev"] for e in obs.trace.events()})
    print(f"durable depth 3 traced: digest and per-tag counts equal the untraced run's; "
          f"{counted['pwb']} pwb and {counted['pfence']} pfence events, "
          f"{obs.trace.seq} events in all ({kinds_seen} in the last "
          f"{len(obs.trace.events())}), {out['n_ops'] / out['seconds']:.1f} ops/s traced "
          f"against {ref['n_ops'] / ref['seconds']:.1f} untraced", flush=True)

    kinds = [sorted(KINDS)[s % 4] for s in range(16)]
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
    # insert-only twin with unique keys and values: exactly once is then a
    # multiset check, whatever the interleaving of threads and phases
    uniq = rng.permutation(4096)[: 3 * threads * per].reshape(3, threads, per)
    ins = [[(uniq[p, t], np.ones(per, np.int64),
             (1 + (p * threads + t) * per + np.arange(per)).astype(np.float32))
            for t in range(threads)] for p in range(3)]
    everything = sorted(float(v) for b in sum(ins, []) for v in b[2])

    def fabric(root, crash_at=None, backend="kernel", depth=1, chain=1):
        inj = FaultInjector(crash_at=crash_at)
        fs = SimFS(root, inj)
        return ShardedDFCRuntime(kinds, 16, capacity, lanes, fs=fs, n_threads=threads,
                                 backend=backend, depth=depth, chain=chain,
                                 device="cuda"), fs, inj

    def drive(root, rounds=sched, crash_at=None, **kw):
        rt, fs, inj = fabric(root, crash_at, **kw)
        done = []
        try:
            for p, batches in enumerate(rounds):
                for t, (keys, ops, params) in enumerate(batches):
                    rt.announce(t, keys, ops, params, token=p + 1)
                rt.combine_phase()
                done.append(p)
            rt.flush()
        except CrashNow:
            return done, True, inj.count, fs
        return done, False, inj.count, fs

    def recover(root, **kw):
        return ShardedDFCRuntime.recover(
            SimFS(root), kind=kinds, n_shards=16, capacity=capacity, lanes=lanes,
            n_threads=threads, device="cuda", **kw)

    def points(total):
        return sorted({total // 6, total // 3, total // 2, 2 * total // 3,
                       5 * total // 6, total - 1})

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        # the serial drive: kernel and plain backends, crash sweep
        _, crashed, total, _ = drive(tmp / "kernel")
        drive(tmp / "ref", backend="ref")
        check(not crashed, "dry run crashed")
        check(durable_digest(tmp / "kernel") == durable_digest(tmp / "ref"),
              "kernel and plain backends wrote different durable roots")
        for k in points(total):
            done, crashed, _, _ = drive(tmp / f"c{k}", crash_at=k)
            check(crashed, f"no crash at op {k}")
            rt, report = recover(tmp / f"c{k}")
            rt.replay_pending(report)
            _exactly_once(rt, sched, done, report, kinds, lanes, capacity)
        print(f"durable serial: {total} persistence ops per run; crash points "
              f"{points(total)} recovered and replayed exactly once", flush=True)

        # depth 3 against depth 1 on one lockstep schedule (chain 4 at both,
        # as benchmarks/bench_multithread.py runs it)
        stats = {}
        for depth in (1, 3):
            *_, fs = drive(tmp / f"lock{depth}", depth=depth, chain=threads)
            stats[depth] = (dict(fs.stats), fs.pstats.as_dict())
        check(stats[3][0]["pwb"] <= stats[1][0]["pwb"]
              and stats[3][0]["pfence"] <= stats[1][0]["pfence"],
              f"depth 3 costs more than depth 1: {stats}")
        print(f"durable lockstep (chain 4): depth 1 {stats[1][0]}, depth 3 {stats[3][0]}",
              flush=True)

        # phase_loop on both axes against the serial drive of the same
        # schedule (chain 4: each announcement is its own phase)
        flat = [(t, p + 1, *b) for p, batches in enumerate(sched)
                for t, b in enumerate(batches)]
        for axis in ("grid", "scan"):
            rt, fs, _ = fabric(tmp / f"loop_{axis}")
            K.reset_launches()
            rt.phase_loop(flat, phase_axis=axis)
            launches = dict(K.LAUNCHES)
            check(durable_digest(tmp / f"loop_{axis}") == durable_digest(tmp / "lock1"),
                  f"phase_loop {axis}: durable root differs from the serial drive's")
            check((dict(fs.stats), fs.pstats.as_dict()) == stats[1],
                  f"phase_loop {axis}: per-tag pwb/pfence differ from the serial drive's")
            want = ({f"phase_grid_{k}": 1 for k in KINDS} if axis == "grid"
                    else {k: len(flat) for k in KINDS})
            check(all(launches[k] == v for k, v in want.items()),
                  f"phase_loop {axis} launches {launches}")
        print(f"durable phase_loop ({len(flat)} phases): grid and scan write the serial "
              f"drive's root and per-tag counts {stats[1][1]}", flush=True)

        # pipelined (depth 3, chain 4): kernel and plain roots, crash sweep
        pipe = {"depth": 3, "chain": threads}
        _, crashed, total, _ = drive(tmp / "pipe", rounds=ins, **pipe)
        drive(tmp / "pipe_ref", rounds=ins, backend="ref", **pipe)
        check(not crashed and durable_digest(tmp / "pipe") == durable_digest(tmp / "pipe_ref"),
              "pipelined: kernel and plain backends wrote different durable roots")
        prevs = 0
        for k in points(total):
            _, crashed, _, _ = drive(tmp / f"p{k}", rounds=ins, crash_at=k, **pipe)
            check(crashed, f"no crash at op {k}")
            rt, report = recover(tmp / f"p{k}", **pipe)
            prevs += sum(r["prev"] is not None for r in report.values())
            rt.replay_pending(report)
            surfaced = {t: report[t]["token"] or 0 for t in range(threads)}
            for p, batches in enumerate(ins):
                for t, b in enumerate(batches):
                    if p + 1 > surfaced[t]:
                        rt.announce(t, *b, token=p + 1)
                rt.combine_phase()
            rt.flush()
            check(_values(rt, kinds) == everything,
                  f"pipelined crash at op {k}: not exactly once")
        print(f"durable pipelined: {total} persistence ops per run; crash points "
              f"{points(total)} ({prevs} in-flight predecessors reported) recovered and "
              "replayed exactly once", flush=True)

        # phase_loop crash sweep (grid axis)
        flat_ins = [(t, p + 1, *b) for p, batches in enumerate(ins)
                    for t, b in enumerate(batches)]
        rt, _, inj = fabric(tmp / "loop_dry")
        rt.phase_loop(flat_ins, phase_axis="grid")
        total = inj.count
        for k in points(total):
            rt, _, _ = fabric(tmp / f"l{k}", crash_at=k)
            try:
                rt.phase_loop(flat_ins, phase_axis="grid")
                check(False, f"no crash at op {k}")
            except CrashNow:
                pass
            rt, report = recover(tmp / f"l{k}")
            rt.replay_pending(report)
            surfaced = {t: report[t]["token"] or 0 for t in range(threads)}
            rest = [e for e in flat_ins if e[1] > surfaced[e[0]]]
            if rest:
                rt.phase_loop(rest, phase_axis="grid")
            check(_values(rt, kinds) == everything,
                  f"phase_loop crash at op {k}: not exactly once")
        print(f"durable phase_loop: {total} persistence ops per run; crash points "
              f"{points(total)} recovered and replayed exactly once", flush=True)


# ------------------------------------------------------------ model kernels
def model_kernel_mods():
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.mamba_scan import kernel as SK
    from repro_torch.kernels.rmsnorm import kernel as RK
    return {"rmsnorm": RK, "flash_attention": FK, "selective_scan": SK}


def model_fns(name):
    """(the kernel's wrapper, its plain version) for model kernel ``name``."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    mods = model_kernel_mods()
    return {"rmsnorm": (mods["rmsnorm"].rmsnorm, rmsnorm_ref),
            "flash_attention": (mods["flash_attention"].flash_attention, attention_ref),
            "selective_scan": (mods["selective_scan"].selective_scan,
                               selective_scan_ref)}[name]


def model_launches():
    out = {}
    for mod in model_kernel_mods().values():
        out.update(mod.LAUNCHES)
    return out


def reset_model_launches():
    for mod in model_kernel_mods().values():
        mod.reset_launches()


def model_inputs(torch, name, shape, dtype, seed=0):
    """Random inputs of the model kernel ``name`` at ``shape``: RMSNorm (R,
    D); flash (B, S, Hq, Hkv, hd); the scan (B, S, DI, N) with dt and x in
    ``dtype`` and B, C in bf16 when ``dtype`` is f32 (the model path's
    types) or in ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*s, dt=dtype, scale=0.5):
        return (torch.randn(s, generator=g, device="cuda") * scale).to(dt)

    if name == "rmsnorm":
        r, d = shape
        return rn(r, d), rn(d) + 1.0
    if name == "flash_attention":
        b, s, hq, hkv, hd = shape
        return rn(b, s, hq, hd), rn(b, s, hkv, hd), rn(b, s, hkv, hd)
    b, s, di, n = shape
    bc = torch.bfloat16 if dtype == torch.float32 else dtype
    dt = torch.nn.functional.softplus(rn(b, s, di, dt=torch.float32) - 2.0).to(dtype)
    a_log = torch.rand((di, n), generator=g, device="cuda") * 0.5
    return (dt, a_log, rn(b, s, n, dt=bc), rn(b, s, n, dt=bc), rn(b, s, di),
            torch.ones(di, device="cuda"))


def scan_case(torch, shape, dtype, fused=False, z_layout="half"):
    """(args, keyword args) of the selective scan at (B, S, DI, N).  Base
    mode: ``model_inputs``.  Fused mode, as the mamba1 block calls it:
    dt_pre ~ N(0, 1), dt_bias in [-4.6, -1] with every 97th channel at 21
    (past softplus's threshold of 20), x, B, C and z in ``dtype``; z is the
    second half of an (B, S, 2 DI) ``xz`` (``z_layout="half"``, row stride
    2 DI, as the block passes it) or a tensor of its own."""
    if not fused:
        return model_inputs(torch, "selective_scan", shape, dtype), {}
    g = torch.Generator(device="cuda").manual_seed(2)
    b, s, di, n = shape

    def rn(*sz, scale=0.5):
        return (torch.randn(sz, generator=g, device="cuda") * scale).to(dtype)

    dt_pre = rn(b, s, di, scale=1.0)
    bias = torch.rand(di, generator=g, device="cuda") * 3.6 - 4.6
    bias[::97] = 21.0
    xz = rn(b, s, 2 * di)
    z = xz[..., di:] if z_layout == "half" else rn(b, s, di)
    a_log = torch.rand((di, n), generator=g, device="cuda") * 0.5
    args = (dt_pre, a_log, rn(b, s, n), rn(b, s, n), xz[..., :di].contiguous(),
            torch.ones(di, device="cuda"))
    return args, {"dt_bias": bias.to(dtype), "z": z}


def sfu_per_s():
    """Special-function results per second: SMs x 16 x the max SM clock."""
    return CARD["sms"] * SFU_PER_SM_CLOCK * CARD["sm_clock_hz"]


def model_bound(name, shape, dtype_bytes, fused=False):
    """(least ms, what bounds it) of one call of a model kernel: each input
    read once and each output written once at the HBM rate, against the
    operations at the peak for their type (bf16 attention products on the
    tensor cores, the scan's exps on the special-function units, the rest
    at the f32 rate).  The scan: base mode as the model path called it
    before the fused mode (dt, x, y in ``dtype_bytes``, B and C in bf16);
    fused mode (``fused``) dt_pre, x, z, y, B, C and dt_bias in
    ``dtype_bytes``, with a sigmoid (an exp) per element beside the exp per
    state, and in f32 a softplus (exp, log1p) too: a bf16 softplus is a
    lookup in a table of its 65536 inputs."""
    if name == "rmsnorm":
        r, d = shape
        nbytes = 2 * r * d * dtype_bytes + d * dtype_bytes
        t_ops = r * d * 4 / SCALAR_OPS_PER_S
    elif name == "flash_attention":
        b, s, hq, hkv, hd = shape
        nbytes = (2 * b * s * hq * hd + 2 * b * s * hkv * hd) * dtype_bytes
        flops = 4 * b * hq * hd * (s * (s + 1) // 2)  # causal: key t <= query s
        rate = BF16_TENSOR_OPS_PER_S if dtype_bytes == 2 else SCALAR_OPS_PER_S
        t_ops = flops / rate
    else:
        b, s, di, n = shape
        elems = b * s * di
        small = di * n * 4 + di * 4 + b * di * n * 4  # a_log, D, h_S
        if fused:
            nbytes = 4 * elems * dtype_bytes + 2 * b * s * n * dtype_bytes + di * dtype_bytes
            sfu = elems * (n + (1 if dtype_bytes == 2 else 3))
        else:
            nbytes = 3 * elems * dtype_bytes + 2 * b * s * n * 2
            sfu = elems * n
        nbytes += small
        # per state and step: 2 multiplies and 2 FMAs (6 flops) beside its exp
        t_ops = max(sfu / sfu_per_s(), elems * n * 6 / SCALAR_OPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


def model_kernel_vs_plain(torch, name, shape, dtype, args=None, **kw):
    """One call of the model kernel and of its plain version on the same
    inputs (``args``, or ``model_inputs`` at ``shape``), keyword arguments
    ``kw`` to both; returns (max abs err, the tolerance it was held to)."""
    fn, plain = model_fns(name)
    args = model_inputs(torch, name, shape, dtype) if args is None else args
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    key = "float32" if dtype == torch.float32 else "bfloat16"
    tol = SCAN_TOL_F32 if name == "selective_scan" and key == "float32" else MODEL_TOL[key]
    opts = {k: tuple(v.shape) if hasattr(v, "shape") else v for k, v in kw.items()}
    what = f"{name} {shape} {key} {opts or ''}"
    err = 0.0
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{what}: output shape/dtype differs from the plain version")
        check(bool(torch.isfinite(a.float()).all()), f"{what}: non-finite output")
        diff = (a.float() - b.float()).abs()
        err = max(err, float(diff.max()))
        check(bool((diff <= tol + tol * b.float().abs()).all()),
              f"{what}: max abs err {float(diff.max()):.3g} over tolerance {tol}")
    return err, tol


def unaligned(torch, shape, dtype):
    """An input of ``shape`` whose data pointer is 2 bytes past a 16-byte
    boundary: the contiguous slice [1:] of a flat buffer."""
    g = torch.Generator(device="cuda").manual_seed(1)
    n = math.prod(shape)
    flat = (torch.randn(n + 1, generator=g, device="cuda") * 0.5).to(dtype)
    x = flat[1:].view(shape)
    check(x.data_ptr() % 16 != 0 and x.is_contiguous(), "the unaligned input is aligned")
    return x


def phase_model_kernels(torch):
    """The three model kernels against their plain versions in bf16 and
    f32: at the serving path's shapes and around them (flash attention at
    every head dim, a ragged S, S = T = 1, non-causal, no grouping and a
    group of 4; RMSNorm at both models' prefill and decode
    rows, a D off the 16-byte vector; the dense configs' shapes of phase
    11; an unaligned input to both); then a
    kernel launched under ``torch.cuda.stream`` runs on that stream."""
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
    cases = [("rmsnorm", (r, d), {}) for r, d in
             ((4096, 576), (2048, 4096), (8, 576), (4, 4096), (64, 100), (4096, 1536))]
    cases += [("flash_attention", (8, 512, 9, 3, 64), {}),
              ("flash_attention", (8, 200, 9, 3, 64), {}),
              ("flash_attention", (8, 512, 12, 2, 128), {}),
              ("flash_attention", (8, 512, 16, 16, 128), {})]
    cases += [("flash_attention", (2, 512, 9, 3, hd), {}) for hd in HEAD_DIMS if hd != 64]
    cases += [("flash_attention", (2, 1, 9, 3, 64), {}),
              ("flash_attention", (2, 200, 9, 3, 64), {"causal": False}),
              ("flash_attention", (2, 512, 4, 4, 64), {}),
              ("flash_attention", (2, 256, 8, 2, 32), {}),
              ("flash_attention", (1, 100, 4, 4, 128), {"causal": False})]
    lines = []
    for name, shape, kw in cases:
        for dtype in (torch.bfloat16, torch.float32):
            err, tol = model_kernel_vs_plain(torch, name, shape, dtype, **kw)
            lines.append(f"{name}{shape}{kw or ''} {str(dtype)[6:]} {err:.3g} "
                         f"(atol = rtol = {tol:g})")
    # the scan, both modes (y and h_S): the serving shape, a ragged S, N = 8,
    # S = 1, and DI and N off the 16-byte vector (the element-wise copies);
    # the fused mode's z the strided half of an xz, and once contiguous
    scan = [(shape, fused, "half") for shape in SCAN_SHAPES for fused in (False, True)]
    scan.append(((4, 512, 8192, 16), True, "contiguous"))
    for shape, fused, z_layout in scan:
        for dtype in (torch.bfloat16, torch.float32):
            args, kw = scan_case(torch, shape, dtype, fused, z_layout)
            err, tol = model_kernel_vs_plain(torch, "selective_scan", shape, dtype,
                                             args=args, **kw)
            mode = f"fused, z {z_layout}" if fused else "base"
            lines.append(f"selective_scan{shape} {mode} {str(dtype)[6:]} {err:.3g} "
                         f"(atol = rtol = {tol:g})")
    for dtype in (torch.bfloat16, torch.float32):
        x = unaligned(torch, (4096, 576), dtype)
        w = model_inputs(torch, "rmsnorm", (4096, 576), dtype)[1]
        err, tol = model_kernel_vs_plain(torch, "rmsnorm", (4096, 576), dtype, args=(x, w))
        lines.append(f"rmsnorm(4096, 576) unaligned {str(dtype)[6:]} {err:.3g} "
                     f"(atol = rtol = {tol:g})")
        _, k, v = model_inputs(torch, "flash_attention", (2, 200, 9, 3, 64), dtype)
        q = unaligned(torch, (2, 200, 9, 64), dtype)
        err, tol = model_kernel_vs_plain(torch, "flash_attention", (2, 200, 9, 3, 64), dtype,
                                         args=(q, k, v))
        lines.append(f"flash_attention(2, 200, 9, 3, 64) unaligned q {str(dtype)[6:]} "
                     f"{err:.3g} (atol = rtol = {tol:g})")
    print("model kernels vs plain, max abs err: " + "; ".join(lines), flush=True)

    side = torch.cuda.Stream()
    fn, plain = model_fns("flash_attention")
    args = model_inputs(torch, "flash_attention", (8, 512, 9, 3, 64), torch.bfloat16)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        check(nvcc.stream(args[0].device) == side.cuda_stream,
              "nvcc.stream does not follow torch.cuda.stream")
        got = fn(*args)
    side.synchronize()
    check(bool(torch.equal(got, fn(*args))), "flash attention on a side stream differs")
    print("model kernels follow torch.cuda.stream: the launch ran on the side stream",
          flush=True)


# ------------------------------------------------------------------- serve
def _run_serve(serve_mod, argv, params=None, hook=None, echo=True):
    """The port's launcher in-process, its report echoed where ``echo``."""
    args = serve_mod.build_parser().parse_args(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve_mod.serve(args, params=params, hook=hook)
    for line in buf.getvalue().splitlines() if echo else ():
        print(f"  serve: {line}", flush=True)
    return out


def _expected_model_launches(cfg, prefills, steps):
    """Model-kernel launches of ``prefills`` prefills and ``steps`` decode
    steps (a served batch of gen tokens: one prefill, gen-1 steps)."""
    L = cfg.n_layers
    norms = 2 * L + 1 if cfg.family == "dense" else L + 1
    if cfg.norm != "rmsnorm":  # olmo's LayerNorm is plain PyTorch in both packages
        norms = 0
    return {"rmsnorm": (prefills + steps) * norms,
            "flash_attention": prefills * L if cfg.family == "dense" else 0,
            "selective_scan": prefills * L if cfg.family == "ssm" else 0}


def serve_and_check(torch, serve_mod, K, argv, params=None):
    """Drive one launcher run with every counter zeroed just before and read
    just after; check the model-kernel launches against the count the served
    batches imply and that the tier's combine kernels ran.  Returns the run
    record, the first batch (prompts, last logits, tokens) and the counts."""
    first = {}

    def hook(sids, prompts, last, tokens):
        if not first:
            first.update(prompts=prompts.clone(), last=last.clone(), tokens=tokens.clone())

    K.reset_launches()
    reset_model_launches()
    out = _run_serve(serve_mod, argv, params=params, hook=hook)
    model = model_launches()
    fabric = dict(K.LAUNCHES)
    args = serve_mod.build_parser().parse_args(argv)
    check(not out["crashed"], f"{args.arch}: the run crashed")
    want = _expected_model_launches(out["cfg"], out["batches"],
                                    out["batches"] * (args.gen - 1))
    check(out["batches"] > 0 and model == want,
          f"{args.arch}: model-kernel launches {model}, expected {want} for "
          f"{out['batches']} batches of {args.gen} tokens")
    tier_kinds = ("queue" if not args.priority else "deque", "stack", "map")
    check(all(fabric[k] > 0 for k in tier_kinds),
          f"{args.arch}: the tier's combine kernels did not all launch: {fabric}")
    print(f"serve {args.arch}: launches {model} (as expected for {out['batches']} "
          f"batches), tier combine kernels {fabric}", flush=True)
    return out, first, model


def replay_first_batch(torch, out, first, gen, what="batch 1"):
    """The first batch's prefill and greedy decode again with the plain
    backend on the same params: last-position logits within REPLAY_REL_TOL
    (relative max-abs error), token agreement printed.  ``first["tokens"]``
    holds the ``gen`` tokens the run emitted from that prefill on."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    cfg, params = out["cfg"], out["params"]
    before = model_launches()
    prompts = first["prompts"]
    max_len = prompts.shape[1] + gen + 8
    last, cache = make_prefill_step(cfg, max_len, backend="ref")(params, {"tokens": prompts})
    serve_step = make_serve_step(cfg, backend="ref")
    tok = torch.argmax(last[:, -1], dim=-1)[:, None]
    toks = [tok]
    for _ in range(gen - 1):
        step, cache = serve_step(params, cache, {"tokens": tok})
        tok = step["next_token"][:, None]
        toks.append(tok)
    torch.cuda.synchronize()
    check(model_launches() == before, "the plain-backend replay launched a kernel")
    a, b = first["last"].float(), last.float()
    check(bool(torch.isfinite(a).all()) and a.shape == (prompts.shape[0], 1, cfg.vocab),
          f"{cfg.name}: last logits not finite or of the wrong shape {tuple(a.shape)}")
    rel = float((a - b).abs().max() / b.abs().max())
    agree = float((first["tokens"] == torch.cat(toks, 1)).float().mean())
    check(rel <= REPLAY_REL_TOL,
          f"{cfg.name}: kernel prefill vs plain replay relative max-abs error {rel:.3g} "
          f"over {REPLAY_REL_TOL}")
    print(f"serve {cfg.name}: plain-backend replay of {what} -- last logits relative "
          f"max-abs error {rel:.4g} (tol {REPLAY_REL_TOL}), greedy tokens agree on "
          f"{agree:.1%} of {gen} x {prompts.shape[0]} (not gated)", flush=True)
    return rel, agree


def profile_calls(torch, label, fn, n, warmup=True):
    """Device busy share and device time by kernel over ``n`` calls of
    ``fn`` (after one warm-up call where ``warmup``), from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
        torch.cuda.synchronize()
    # the device's activity alone, summed from the raw events: parsing a
    # whole serving run's host events (``key_averages``) takes minutes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            dev[ev.name()] = dev.get(ev.name(), 0.0) + ev.duration_ns() / 1e3
    total = sum(dev.values())
    if not total:
        print(f"profile {label}: the profiler recorded no device time (busy share not "
              "measured)", flush=True)
        return
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile {label} ({n} calls): device busy {total / n / 1e3:.3f} ms per call of "
          f"{wall_us / n / 1e3:.3f} ms wall ({total / wall_us:.1%} busy); top: "
          + "; ".join(f"{k[:40]} {v / n / 1e3:.3f} ms" for k, v in top), flush=True)


def profile_model(torch, out, first, gen):
    """The first batch's prefill and a decode step under the profiler."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    cfg, params, prompts = out["cfg"], out["params"], first["prompts"]
    prefill_step = make_prefill_step(cfg, prompts.shape[1] + gen + 8)
    serve_step = make_serve_step(cfg)
    profile_calls(torch, f"{cfg.name} prefill", lambda: prefill_step(params, {"tokens": prompts}), 2)
    _, cache = prefill_step(params, {"tokens": prompts})
    tok = first["tokens"][:, :1]
    profile_calls(torch, f"{cfg.name} decode step",
                  lambda: serve_step(params, dict(cache), {"tokens": tok}), 4)


def profiler_device_ms(torch, fn, n=DEVICE_CALLS):
    """(device ms per call of ``fn`` from ``torch.profiler`` over ``n``
    calls, the fewest launches it kept of any kernel): each kernel's median
    launch, times its launches per call, summed over the call's kernels.
    The profiler drops some launches of so short a window (in a whole run of
    this script, after phases 4-6, most or all), so the time is None unless
    it kept at least half of each kernel's."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    launches = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            launches.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
    kept = min(map(len, launches.values()), default=0)
    if 2 * kept < n:
        return None, kept
    us = sum(statistics.median(d) * max(1, round(len(d) / n)) for d in launches.values())
    return us / 1e3, kept


def graph_device_ms(torch, fn, n=DEVICE_CALLS):
    """Device ms per call of ``fn``: CUDA events around ``n`` calls captured
    in one CUDA graph (the gaps between the graph's kernels included)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up on a side stream before the capture, as CUDA graphs need
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def host_us_per_call(torch, fn, n=HOST_CALLS):
    """The host's time per call of ``fn`` in microseconds: the host clock
    over ``n`` calls with no synchronize between them, then one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def in_turns(torch, kernel, other, n_dev=DEVICE_CALLS, n_host=HOST_CALLS, ms_reps=20):
    """The kernel's and another call's timings, taken in turns (other,
    kernel, kernel, other; the kernel alone where there is no other call),
    each number the mean of its turns: ``ms``, one call per CUDA-event pair
    (median of ``ms_reps``, as ``cuda_ms``); ``device_ms``, device time per
    call, from the profiler over ``n_dev`` calls where it kept enough
    launches in every turn, else from CUDA graphs of ``n_dev`` calls for all
    turns (``device_ms_by``); ``host_us``, host time per call over
    ``n_host`` calls.  The other call is a model kernel's PyTorch call, or
    a combine kernel of the tree given by ``--turns``.  Returns (kernel's,
    other's or None)."""
    fns = (kernel,) if other is None else (other, kernel, kernel, other)
    dev, kept = zip(*(profiler_device_ms(torch, fn, n_dev) for fn in fns))
    how = f"{'/'.join(map(str, kept))} of {n_dev} launches kept by the profiler"
    if None in dev:
        dev, how = [graph_device_ms(torch, fn, n_dev) for fn in fns], f"graph; {how}"
    else:
        how = f"profiler; {how}"
    turns = [{"ms": cuda_ms(fn, ms_reps), "device_ms": d, "device_ms_by": how,
              "host_us": host_us_per_call(torch, fn, n_host)} for fn, d in zip(fns, dev)]
    if other is None:
        return turns[0], None

    def mean(a, b):
        return {k: (a[k] + b[k]) / 2 if isinstance(a[k], float) else a[k] for k in a}
    return mean(turns[1], turns[2]), mean(turns[0], turns[3])


def library_call(torch, name, args):
    """One PyTorch call computing the model kernel's function on ``args``
    (its inputs laid out as the call wants them beforehand), or None.  A
    yardstick only: the port never calls these."""
    import torch.nn.functional as F
    if name == "rmsnorm":
        x, w = args
        return lambda: F.rms_norm(x, (x.shape[-1],), weight=w, eps=1e-6)
    if name == "flash_attention":
        q, k, v = args
        group = q.shape[2] // k.shape[2]
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    return None


def measure_model_kernel(torch, name, shape, dtype, fused=False):
    """A model kernel at ``shape`` (the scan in its fused mode where
    ``fused``): held against its plain version, then timed in turns with the
    library call (``in_turns``), beside its bound.  Returns the fields of
    its record."""
    fn, plain = model_fns(name)
    if name == "selective_scan":
        args, kw = scan_case(torch, shape, dtype, fused)
    else:
        args, kw = model_inputs(torch, name, shape, dtype), {}
    err, tol = model_kernel_vs_plain(torch, name, shape, dtype, args=args, **kw)
    lib = library_call(torch, name, args)
    kern, libt = in_turns(torch, lambda: fn(*args, **kw), lib)
    plain_ms = cuda_ms(lambda: plain(*args, **kw), 3 if name == "selective_scan" else 10)
    bound_ms, bound_by = model_bound(name, shape, 2 if dtype == torch.bfloat16 else 4, fused)
    rec = {"max_abs_err": err, **kern, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None if libt is None else libt["ms"],
           "library_device_ms": None if libt is None else libt["device_ms"],
           "library_host_us": None if libt is None else libt["host_us"],
           "shape": list(shape), "dtype": str(dtype)[6:], "tolerance": tol}
    if name == "selective_scan":
        rec["mode"] = "fused" if fused else "base"
    lib_txt = "none" if libt is None else (
        f"{libt['ms']:.4f} ms, device {libt['device_ms']:.4f} ms, host "
        f"{libt['host_us']:.1f} us")
    print(f"kernel {name} {shape} {str(dtype)[6:]}{' fused' if fused else ''}: "
          f"{kern['ms']:.4f} ms, device {kern['device_ms']:.4f} ms ({kern['device_ms_by']}), "
          f"host {kern['host_us']:.1f} us per call; library {lib_txt}; plain {plain_ms:.4f} ms; "
          f"bound {bound_ms:.6f} ms by {bound_by}; max abs err {err:.3g}", flush=True)
    return rec


def time_model_kernel(torch, name, shape, dtype, launches, fused=False, more=()):
    """A model kernel's record at the serving path's ``shape``, with the
    same fields under ``at`` for each ``(key, shape, dtype, fused)`` of
    ``more``."""
    src, replaces = MODEL_KERNELS[name]
    rec = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
           "launches": launches, **measure_model_kernel(torch, name, shape, dtype, fused)}
    if more:
        rec["at"] = {key: measure_model_kernel(torch, name, s, dt, f) for key, s, dt, f in more}
    return rec


def phase_serve(torch, K, records):
    """Both models served at full width through the kernels, the durable
    priority tier crashed and resumed exactly once, and the model kernels'
    records at the path's shapes.  Returns each model's params (phase 8
    serves them again rather than drawing 14.6 GB twice)."""
    from repro_torch.launch import serve as serve_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    totals = {"rmsnorm": 0, "flash_attention": 0, "selective_scan": 0}
    params = {}
    for arch, argv in SERVE_RUNS.items():
        torch.cuda.reset_peak_memory_stats()  # the peak of this run alone
        out, first, model = serve_and_check(torch, serve_mod, K, argv)
        gen = serve_mod.build_parser().parse_args(argv).gen
        for k, v in model.items():
            totals[k] += v
        replay_first_batch(torch, out, first, gen)
        profile_model(torch, out, first, gen)
        prefill_s = statistics.median(out["prefill_s"])
        print(f"serve {arch}: prefill {prefill_s * 1e3:.3f} ms per batch median "
              f"({first['prompts'].numel() / prefill_s:.0f} tok/s), decode "
              f"{statistics.median(out['decode_step_s']) * 1e3:.3f} ms per step median over "
              f"{len(out['decode_step_s'])} steps, {out['decoded_tokens'] / out['seconds']:.1f} "
              f"tok/s end to end, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        params[arch] = out["params"]
        del out, first
        torch.cuda.empty_cache()

    # the durable priority tier: whole, then crashed halfway and resumed
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        base = SERVE_RUNS["smollm-135m"] + DURABLE_SERVE
        smollm_params = params["smollm-135m"]
        out, _, _ = serve_and_check(torch, serve_mod, K,
                                    base + ["--state-dir", f"{tmp}/whole"], smollm_params)
        total = out["tier"].rt.fs.injector.count
        p = out["tier"].persistence_stats()
        crash = total // 2
        out = _run_serve(serve_mod, base + ["--state-dir", f"{tmp}/crash",
                                            "--crash-at", str(crash)], smollm_params)
        check(out["crashed"], f"durable serve did not crash at persistence op {crash}")
        out = _run_serve(serve_mod, base + ["--state-dir", f"{tmp}/crash", "--resume",
                                            "--expect-exactly-once"], smollm_params)
        check(not out["crashed"] and out["completed"] == 16,
              "durable serve resume did not complete 16 sessions")
        print(f"serve durable: {total} persistence ops per run, pwb/op "
              f"{p['pwb_per_op']:.4f} pfence/op {p['pfence_per_op']:.4f}; crash at op "
              f"{crash}, resumed, every session served exactly once", flush=True)

    bf16 = torch.bfloat16
    scan_shape = (4, 512, 8192, 16)
    # the path's shape and dtype; the scan in its fused mode, as the mamba1
    # prefill calls it
    runs = {"rmsnorm": ((8 * 512, 576), False), "flash_attention": ((8, 512, 9, 3, 64), False),
            "selective_scan": (scan_shape, True)}
    # RMSNorm also at falcon's prefill rows and at a decode step's rows; the
    # scan also in its base mode with f32 dt and x, as the path called it
    # before the fused mode
    more = {"rmsnorm": [("x".join(map(str, s)), s, bf16, False)
                        for s in ((2048, 4096), (8, 576), (4, 4096))],
            "selective_scan": [("base " + "x".join(map(str, scan_shape)) + " float32",
                                scan_shape, torch.float32, False)]}
    for name, (shape, fused) in runs.items():
        records[name] = time_model_kernel(torch, name, shape, bf16, totals[name], fused,
                                          more.get(name, ()))
    return params


# -------------------------------------------------------------- continuous
def _cont_run(serve_mod, K, argv, params=None, first=None, min_len=0):
    """One continuous-server run of the port's launcher with every counter
    zeroed just before and read just after; ``first`` (a dict) receives the
    session, input row and last-position logits of the first prefill longer
    than ``min_len``.  Returns the run record (``prefill_lens``: the
    prefills' lengths S, in order), the model-kernel and the combine-kernel
    counts."""
    lens = []

    def hook(sids, prompts, last, tokens):
        lens.append(int(prompts.shape[1]))
        if first is not None and not first and prompts.shape[1] > min_len:
            first.update(sid=sids[0], prompts=prompts.clone(), last=last.clone())

    K.reset_launches()
    reset_model_launches()
    out = _run_serve(serve_mod, argv, params=params, hook=hook)
    model, fabric = model_launches(), dict(K.LAUNCHES)
    out["prefill_lens"] = lens
    return out, model, fabric


def _history_crash_point(serve_mod, argv, tmp, total):
    """The first persistence op from ``total // 2`` on (in strides of
    ``total // 64``) at which a crash leaves an unserved session with part of
    its tokens in the consumer's log, so that the resume re-prefills prompt
    + history: found by crashing the ``--tier-only`` run, which runs the same
    tier schedule (its durable root equals the model run's)."""
    gen = serve_mod.build_parser().parse_args(argv).gen
    for crash in range(total // 2, total, max(1, total // 64)):
        d = Path(tmp) / f"probe_{crash}"
        out = _run_serve(serve_mod, argv + ["--tier-only", "--state-dir", str(d), "--crash-at",
                                            str(crash)], echo=False)
        check(out["crashed"], f"the tier-only run did not crash at persistence op {crash}")
        served = set(serve_mod._read_served(d))
        if any(0 < len(e) < gen for sid, e in serve_mod._read_token_entries(d).items()
               if sid not in served):
            return crash
    raise SmokeFailure(f"no crash point from op {total // 2} of {total} leaves a session "
                       "part-served")


COMBINE_FNS = {"stack": "dfc_reduce_grid_call", "queue": "dfc_queue_reduce_grid_call",
               "deque": "dfc_deque_reduce_grid_call", "map": "dfc_map_reduce_grid_call"}


@contextlib.contextmanager
def captured_combines(K):
    """The arguments (cloned) of every one-phase combine-kernel call made
    while the block runs, by kind."""
    got = {kind: [] for kind in COMBINE_FNS}
    saved = {kind: getattr(K, fn) for kind, fn in COMBINE_FNS.items()}

    def wrap(kind):
        def call(*args):
            got[kind].append(tuple(a.clone() for a in args))
            return saved[kind](*args)
        return call

    for kind, fn in COMBINE_FNS.items():
        setattr(K, fn, wrap(kind))
    try:
        yield got
    finally:
        for kind, fn in COMBINE_FNS.items():
            setattr(K, fn, saved[kind])


def _token_values(serve_mod, state_dir):
    return {s: [t for _, t in sorted(e)]
            for s, e in serve_mod._read_token_entries(Path(state_dir)).items()}


def time_tier_kernels(torch, captured, records):
    """The tier's combine kernels on the arguments of every phase that a
    continuous run dispatched (``captured_combines``; 16 lanes per shard):
    each held bit for bit against its plain version, and each kind's
    busiest phase (most live lanes) timed, under ``at`` of its record."""
    fns = calls()
    for kind in ("queue", "stack", "map"):
        phases = captured[kind]
        check(phases, f"the continuous run made no {kind} combine call")
        kfn, pfn = fns[kind]
        for i, args in enumerate(phases):
            outs_k = kfn(*args)
            torch.cuda.synchronize()
            compare_outputs(f"{kind} on the continuous run's phase {i}", outs_k, pfn(*args))
        live = [int((a[5 if kind == "map" else 0] != 0).sum()) for a in phases]  # OP_NONE 0
        kargs = phases[live.index(max(live))]
        outs_k, outs_p = kfn(*kargs), pfn(*kargs)
        ms = cuda_ms(lambda: kfn(*kargs), 20)
        timing, other = time_combine(torch, NAMES[kind], kfn, kargs)
        plain_ms = cuda_ms(lambda: pfn(*kargs), 3, warmup=0)
        bound_ms, bound_by = bound(kind, kargs)
        shape = list(kargs[5].shape if kind == "map" else kargs[0].shape)
        fields = {"shape": shape, "max_abs_err": max_abs_err(outs_k, outs_p), "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": None, **timing, "phases_checked": len(phases),
                  "live_lanes": max(live)}
        if other is not None:
            fields["turns_tree"] = other
        rec = records.setdefault(kind, {"name": NAMES[kind], "route": "cuda",
                                        "source": SOURCE, "replaces": REPLACES[kind], **fields})
        rec.setdefault("at", {})[f"continuous S,N={tuple(shape)}"] = fields
        print(f"kernel {NAMES[kind]} on the continuous run's {len(phases)} phases: bit-equal to "
              f"its plain version; its busiest phase ({max(live)} live lanes, S,N="
              f"{tuple(shape)}) {ms:.4f} ms, {timing_text(timing, other)} (plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.6f} ms by {bound_by})", flush=True)


def phase_continuous(torch, K, records, params):
    """The continuous-batching server at full width: smollm-135m durable and
    traced (launch counts, exactly once, the starvation bound, the traced
    root against an untraced tier-only run, a plain replay of the first
    prefill, a crash from halfway on, a resume exactly once and a plain
    replay of its first re-prefill), falcon-mamba-7b volatile and shorter,
    a profiled run, the kernels at the path's batch-1 shapes and the
    combine kernels on the tier phases it dispatched."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import init_params
    from repro_torch.obs import durable_digest, read_trace

    def params_for(arch):
        if arch not in params:
            params[arch] = init_params(get_config(arch), seed=0, device=torch.device("cuda"))
        return params[arch]

    t0 = time.perf_counter()

    def at():
        return f"[{time.perf_counter() - t0:.1f} s into phase 8]"

    totals = {"rmsnorm": 0, "flash_attention": 0, "selective_scan": 0}
    tier_totals = {k: 0 for k in K.LAUNCHES}
    arch = "smollm-135m"
    base = CONT_RUNS[arch] + ["--durable"]
    args = serve_mod.build_parser().parse_args(base)
    n, gen = args.sessions, args.gen
    sids = list(range(1, n + 1))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cont_") as tmp:
        whole = Path(tmp) / "whole"
        first = {}
        out, model, fabric = _cont_run(serve_mod, K, base + ["--trace", "--state-dir",
                                                             str(whole)], params_for(arch), first)
        check(not out["crashed"] and out["completed"] == n,
              f"continuous {arch}: served {out.get('completed')} of {n} sessions")
        cfg, tier = out["cfg"], out["tier"]
        prefills, steps = len(out["prefill_s"]), len(out["decode_step_s"])
        check(prefills == n and steps == n * (gen - 1),
              f"continuous {arch}: {prefills} prefills and {steps} decode steps, expected "
              f"{n} and {n * (gen - 1)}")
        want = _expected_model_launches(cfg, prefills, steps)
        check(model == want, f"continuous {arch}: model-kernel launches {model}, expected {want}")
        events = read_trace(whole / "tier" / "obs" / "trace.jsonl")
        check([e["seq"] for e in events] == list(range(len(events))),
              f"continuous {arch}: the trace's seq is not 0, 1, 2, ...")
        phases = sum(e["ev"] == "dispatch" for e in events)
        want_tier = {k: (phases if k in ("queue", "stack", "map") else 0) for k in K.LAUNCHES}
        check(phases == tier._token and fabric == want_tier,
              f"continuous {arch}: combine-kernel launches {fabric} over {phases} traced "
              f"dispatches and {tier._token} tier phases")
        serve_mod.verify_exactly_once(sids, gen, serve_mod._read_served(whole),
                                      serve_mod._read_token_entries(whole))
        bound_ = tier.starvation_bound()
        gap = tier.starvation_gap()
        check(gap <= bound_, f"continuous {arch}: class 0 passed over {gap} times in a row "
                             f"while queued, bound {bound_}")
        for k_, v in model.items():
            totals[k_] += v
        for k_, v in fabric.items():
            tier_totals[k_] += v
        lat = tier.latency_stats()
        pst = tier.persistence_stats()
        dec = sorted(out["decode_step_s"])
        pre = sorted(out["prefill_s"])
        print(f"continuous {arch}: {n} sessions, {out['rounds']} rounds, "
              f"{out['decoded_tokens']} tok in {out['seconds']:.3f} s "
              f"({out['decoded_tokens'] / out['seconds']:.1f} tok/s), prefill at batch 1 "
              f"{pre[len(pre) // 2] * 1e3:.3f} ms median, decode at batch 1 "
              f"{dec[len(dec) // 2] * 1e3:.3f} ms/step median ({steps} steps), "
              f"{phases} tier phases; pwb/op {pst['pwb_per_op']:.4f} pfence/op "
              f"{pst['pfence_per_op']:.4f}; "
              + "; ".join(f"{k_} p50 {v['p50']:.3f} p99 {v['p99']:.3f} (n={v['count']})"
                          for k_, v in lat.items())
              + f"; launches {model}, tier {fabric}; exactly once; class 0 passed over at "
              f"most {gap} times in a row (bound {bound_}) {at()}", flush=True)

        # the tier never sees token values: its durable root and per-tag
        # counts equal an untraced tier-only run's at the same flags
        # (its combine calls' arguments captured: the tier phases the
        # server dispatched, which time_tier_kernels checks and times)
        only = Path(tmp) / "tier_only"
        with captured_combines(K) as tier_calls:
            out_t = _run_serve(serve_mod, base + ["--tier-only", "--state-dir", str(only)])
        check(durable_digest(whole / "tier") == durable_digest(only / "tier")
              and tier.rt.fs.pstats.as_dict() == out_t["tier"].rt.fs.pstats.as_dict(),
              f"continuous {arch}: the traced root or its per-tag counts differ from the "
              "untraced tier-only run's")
        print(f"continuous {arch}: traced root {durable_digest(whole / 'tier')} and per-tag "
              f"counts {tier.rt.fs.pstats.as_dict()} equal the untraced tier-only run's {at()}",
              flush=True)

        # the first session's prefill again on the plain backend
        first["tokens"] = torch.tensor([_token_values(serve_mod, whole)[first["sid"]]],
                                       device=first["prompts"].device)
        replay_first_batch(torch, out, first, gen, f"session {first['sid']}'s prefill")

        # crashed from halfway through the persistence ops where a session
        # is part-served, then resumed
        total = tier.rt.fs.injector.count
        crash = _history_crash_point(serve_mod, base, tmp, total)
        cdir = Path(tmp) / "crash"
        out_c = _run_serve(serve_mod, base + ["--trace", "--state-dir", str(cdir),
                                              "--crash-at", str(crash)], params_for(arch))
        check(out_c["crashed"], f"continuous {arch} did not crash at persistence op {crash}")
        first_r = {}  # the first re-prefill of prompt + committed history
        out_r, model_r, _ = _cont_run(serve_mod, K, base + [
            "--trace", "--state-dir", str(cdir), "--resume", "--expect-exactly-once"],
            params_for(arch), first_r, min_len=args.prompt_len)
        check(not out_r["crashed"] and out_r["completed"] == n,
              f"continuous {arch}: the resume served {out_r.get('completed')} of {n}")
        check(first_r, f"continuous {arch}: the resume re-prefilled no session's history "
                       f"(prefill lengths {out_r['prefill_lens']})")
        resumed_lens = sorted({S for S in out_r["prefill_lens"] if S > args.prompt_len})
        serve_mod.verify_exactly_once(sids, gen, serve_mod._read_served(cdir),
                                      serve_mod._read_token_entries(cdir))
        cevents = read_trace(cdir / "tier" / "obs" / "trace.jsonl")
        check([e["seq"] for e in cevents] == list(range(len(cevents))),
              f"continuous {arch}: the crashed and resumed trace is not one seq timeline")
        got, ref = _token_values(serve_mod, cdir), _token_values(serve_mod, whole)
        same = sum(a == b for s in sids for a, b in zip(got[s], ref[s]))
        # the resumed session's re-prefill (S = prompt_len + start, a ragged
        # flash tile) on the plain backend, against the tokens it emitted
        start = first_r["prompts"].shape[1] - args.prompt_len
        first_r["tokens"] = torch.tensor([got[first_r["sid"]][start:]],
                                         device=first_r["prompts"].device)
        replay_first_batch(torch, out_r, first_r, gen - start,
                           f"session {first_r['sid']}'s re-prefill at S={start + args.prompt_len}")
        print(f"continuous {arch}: crashed at persistence op {crash} of "
              f"{total}, resumed with {len(out_r['prefill_s'])} prefills "
              f"at S={resumed_lens} ({model_r}), every session and token index exactly once; "
              f"token values equal "
              f"the uncrashed run's on {same / (n * gen):.1%} of {n * gen} (bf16 re-prefill, "
              f"not gated) {at()}", flush=True)
        time_tier_kernels(torch, tier_calls, records)
        del out, out_t, out_c, out_r, tier, first, first_r, tier_calls

    # falcon-mamba-7b, volatile and shorter, on phase 7's params
    arch = "falcon-mamba-7b"
    argv = CONT_RUNS[arch]
    args = serve_mod.build_parser().parse_args(argv)
    out, model, fabric = _cont_run(serve_mod, K, argv, params_for(arch))
    prefills, steps = len(out["prefill_s"]), len(out["decode_step_s"])
    want = _expected_model_launches(out["cfg"], prefills, steps)
    check(not out["crashed"] and out["completed"] == args.sessions and prefills == args.sessions
          and steps == args.sessions * (args.gen - 1) and model == want,
          f"continuous {arch}: served {out.get('completed')}, {prefills} prefills, {steps} "
          f"steps, launches {model}, expected {want}")
    check(fabric["queue"] == fabric["stack"] == fabric["map"] > 0,
          f"continuous {arch}: the tier's combine kernels {fabric}")
    for k_, v in model.items():
        totals[k_] += v
    for k_, v in fabric.items():
        tier_totals[k_] += v
    dec, pre = sorted(out["decode_step_s"]), sorted(out["prefill_s"])
    print(f"continuous {arch}: {args.sessions} sessions, {out['rounds']} rounds, "
          f"{out['decoded_tokens'] / out['seconds']:.1f} tok/s, prefill at batch 1 "
          f"{pre[len(pre) // 2] * 1e3:.3f} ms median, decode at batch 1 "
          f"{dec[len(dec) // 2] * 1e3:.3f} ms/step median; launches {model}, tier {fabric} "
          f"{at()}", flush=True)
    del out
    params.pop(arch)
    torch.cuda.empty_cache()

    # the device's busy share over a whole smollm run at the main run's mix
    # (its shapes all ran above, so no warm-up run)
    pargs = serve_mod.build_parser().parse_args(CONT_PROFILE)
    prof = {}
    profile_calls(torch, f"continuous {pargs.arch} ({pargs.sessions} sessions of "
                         f"{pargs.gen} tokens, {pargs.batch} slots, one run)",
                  lambda: prof.update(_run_serve(serve_mod, CONT_PROFILE,
                                                 params_for(pargs.arch))), 1, warmup=False)
    check(prof["completed"] == pargs.sessions and prof["rounds"] >= 2,
          f"continuous profile run: {prof.get('completed')} sessions in {prof.get('rounds')} "
          "rounds")
    print(f"continuous: profiled {prof['rounds']} rounds {at()}", flush=True)
    del prof

    # the model kernels at the path's batch-1 shapes, the resumed
    # re-prefills' lengths included
    bf16 = torch.bfloat16
    shapes = {"rmsnorm": [((512, 576), False), ((1, 576), False), ((512, 4096), False),
                          ((1, 4096), False)] + [((S, 576), False) for S in resumed_lens],
              "flash_attention": [((1, S, 9, 3, 64), False) for S in [512] + resumed_lens],
              "selective_scan": [((1, 512, 8192, 16), True)]}
    for name, runs in shapes.items():
        rec = records.get(name)
        for shape, fused in runs:
            fields = measure_model_kernel(torch, name, shape, bf16, fused)
            if rec is None:
                src, replaces = MODEL_KERNELS[name]
                rec = records[name] = {"name": name, "route": "cuda", "source": src,
                                       "replaces": replaces, "launches": totals[name], **fields}
            rec.setdefault("at", {})["continuous " + "x".join(map(str, shape))] = fields
        rec["continuous_launches"] = totals[name]
    for kind in KINDS:
        if kind in records:  # a record made here (phase 4 not run) takes these
            records[kind].setdefault("launches", tier_totals[kind])
            records[kind]["continuous_launches"] = tier_totals[kind]
    print(f"continuous: launches on the path {totals}, tier {tier_totals} {at()}", flush=True)


# ------------------------------------------------------ lanes and resharding
# phase 9 (b): the full-width fabric with --split-backlog SPLIT_N.  From the
# host routing alone (lanes = batch, so nothing overflows and ops_combined is
# the routed count): shard 0 splits after phase 6 and again after phase 7,
# then holds one bucket, so two splits land in the 32 phases
SPLIT_N = 16384
# phase 9 (c): examples/serve_shards.py at DURABLE + --split-backlog 64 on the
# CPU: (pwb/op, pfence/op) by depth, and its split lines
DURABLE_SPLIT_N = 64
DURABLE_SPLIT = {1: ("0.922", "0.178"), 3: ("1.609", "0.300")}
DURABLE_SPLIT_LINES = ["split: phase 1: shard 0 -> +shard 16",
                       "split: phase 2: shard 0 -> +shard 17"]
# phase 9 (d): the jitter schedule's steady-state (pwb/op, pfence/op) on the
# CPU, both packages, by (split lanes, skewed)
JITTER = {(False, False): (0.5, 0.25), (False, True): (1.25, 0.5),
          (True, False): (0.5, 0.25), (True, True): (0.9375, 0.5)}
# phase 9 (e): phase 7's durable priority run with per-side lanes and an
# autosplit; the reference launcher's --tier-only report at these flags
LANE_SERVE = DURABLE_SERVE + ["--split-lanes", "--reshard-backlog", "4"]
LANE_SERVE_LINES = ("split lanes: head/tail epochs s0=[6,8] s1=[0,0] s2=[8,8] s3=[4,4] s6=[4,4]",
                    "pwb/op: 10.41  pfence/op: 3.91")


def op_marks(events):
    """The persistence-op index (1-based, the fault injector's count) at
    which each traced event was recorded: pwb and pfence events count."""
    n, out = 0, []
    for e in events:
        if e["ev"] in ("pwb", "pfence"):
            n += 1
        out.append((n, e))
    return out


def lanes_device_steps(torch, T, seen):
    """(a) The per-side steps at the main path's width: each lane's masked
    step and the handoff step of phase 2's routed batch on the queue and
    deque groups after phase 1, kernel against plain, bit for bit."""
    from repro_torch.kernels.dfc_reduce import ops as O
    routed, kinds = seen["routed"], seen["kinds0"]
    for kind in ("queue", "deque"):
        rows = torch.tensor([s for s, k in enumerate(kinds) if k == kind], device="cuda")
        st, g_ops, g_par = seen["state"][kind], routed[0][rows], routed[1][rows]
        steps = [(f"{kind} {name} lane", functools.partial(
            O.dfc_lane_combine_step, st, g_ops, g_par, kind=kind, lane=lane))
            for name, lane in (("head", T.LANE_HEAD), ("tail", T.LANE_TAIL))]
        steps.append((f"{kind} handoff", functools.partial(
            O.dfc_handoff_combine_step, st, g_ops, g_par, kind=kind)))
        for what, fn in steps:
            outs_k = fn(backend="kernel")
            torch.cuda.synchronize()
            outs_p = fn(backend="ref")
            compare_states(what, outs_k[0], outs_p[0])
            compare_outputs(what, outs_k[1:], outs_p[1:])
        live = T.lane_of_ops(kind, g_ops)
        print(f"lanes (a) {kind}: S,N={tuple(g_ops.shape)}, {int((live == T.LANE_HEAD).sum())} "
              f"head and {int((live == T.LANE_TAIL).sum())} tail ops; both lane steps and the "
              "handoff step bit-equal to plain", flush=True)


def lanes_full_width(torch, T, K, serve_shards, totals):
    """(b) The full-width fabric with --split-backlog: the split lines, the
    donor's buckets halved, every kind's kernel once a step on its (grown)
    group, the grown kind's kernel at S + 1 on the first batch after the
    first split, bit-equal to plain.  Returns what (a) needs."""
    import numpy as np
    from repro_torch.runtime.dfc_shard import route_keys_host
    args = serve_shards.build_parser().parse_args(FULL + ["--split-backlog", str(SPLIT_N)])
    kinds_all = sorted(T.STRUCTS)
    fns = calls()
    K.reset_launches()
    seen = {"launch_prev": dict(K.LAUNCHES), "n_prev": args.shards, "grown": None}

    def hook(phase, rt, keys, ops, params, resp, kinds):
        touched = {rt.kinds[s] for s in set(rt.route_host(keys).tolist())}
        for k in kinds_all:
            grew = K.LAUNCHES[k] - seen["launch_prev"][k]
            check(grew == (1 if k in touched else 0),
                  f"lanes (b) phase {phase}: {k} kernel launched {grew} times")
            check(rt.groups[k].epoch.shape[0] == rt.kinds.count(k),
                  f"lanes (b) phase {phase}: the {k} group has the wrong row count")
        if rt.n_shards > seen["n_prev"] and seen["grown"] is None:
            # the first batch after the first split: the state it met is the
            # previous phase's plus the new shard's fresh row
            kind = rt.kinds[-1]
            pre = T.map_state(lambda leaf, f: torch.cat([leaf, f[None]]),
                              seen["prev_groups"][kind],
                              T.STRUCTS[kind].init(rt.capacity, device="cuda"))
            routed = rt.route(keys, ops, params)
            rows = torch.tensor([s for s, k in enumerate(rt.kinds) if k == kind], device="cuda")
            kargs = kernel_inputs(kind, pre, routed[0][rows], routed[1][rows], routed[6][rows])
            saved = dict(K.LAUNCHES)  # a comparison, not the main path
            kfn, pfn = fns[kind]
            outs_k = kfn(*kargs)
            torch.cuda.synchronize()
            compare_outputs(f"{kind} at S+1 after the split", outs_k, pfn(*kargs))
            K.LAUNCHES.update(saved)
            shape = tuple(kargs[5].shape if kind == "map" else kargs[0].shape)
            check(shape[0] == seen["prev_groups"][kind].epoch.shape[0] + 1,
                  f"lanes (b): the grown {kind} group is not S+1: {shape}")
            seen["grown"] = (phase, kind, shape)
        if phase == 1:
            seen["state"] = {k: T.map_state(torch.clone, st) for k, st in rt.groups.items()}
        if phase == 2:
            seen["routed"], seen["kinds0"] = rt.route(keys, ops, params), list(rt.kinds)
        seen["prev_groups"] = dict(rt.groups)
        seen["n_prev"] = rt.n_shards
        seen["launch_prev"] = dict(K.LAUNCHES)

    out = run_serve(serve_shards, args, hook=hook)
    for k, v in K.LAUNCHES.items():
        totals[k] += v
    rt = out["rt"]
    splits = out["splits"]
    check(2 <= len(splits) <= 4, f"lanes (b): {len(splits)} splits, expected 2-4")
    check([ln for ln in out["lines"] if ln.startswith("split:")]
          == [f"split: phase {p}: shard {d} -> +shard {n}" for p, d, n in splits],
          "lanes (b): the split lines do not match the splits")
    table = (np.arange(4 * args.shards) % args.shards).astype(np.int32)
    for p, donor, new in splits:
        held = np.nonzero(table == donor)[0]
        table[held[1::2]] = new
        check((table == donor).sum() == (len(held) + 1) // 2 and (table == new).sum()
              == len(held) // 2, f"lanes (b): split at phase {p} did not halve shard {donor}")
    check(np.array_equal(table, rt.table), "lanes (b): the routing table differs from the splits'")
    check(seen["grown"] is not None, "lanes (b): no batch ran after the first split")
    check(route_keys_host(np.arange(4096), rt.n_shards, rt.table).max() == rt.n_shards - 1,
          "lanes (b): the last new shard is unrouted")
    step_ms = statistics.median(out["phase_seconds"]) * 1e3
    base = VOLATILE.get("text", "phase 4 not run")
    # a phase that split holds the split too (the drain, the group's new row)
    split_ms = [round(out["phase_seconds"][p] * 1e3, 3) for p, _, _ in splits]
    print(f"lanes (b): --split-backlog {SPLIT_N}: splits {splits}, {rt.n_shards} shards; "
          f"the grown {seen['grown'][1]} kernel bit-equal at S,N={seen['grown'][2]} on phase "
          f"{seen['grown'][0]}; {out['n_ops'] / out['seconds']:.1f} ops/s, {step_ms:.3f} ms "
          f"median phase, the phases that split {split_ms} ms (unsplit, phase 4: {base}; not "
          f"gated); launches {dict(K.LAUNCHES)}", flush=True)
    return seen


def lanes_durable(torch, T, K, serve_shards, totals):
    """(c) The durable width with --split-backlog 64 at depth 1 and 3 (the
    CPU reference's split lines and counts), kernel against plain at depth
    1 over 10 phases, then splits and a merge on a fabric of our own,
    crashed at six ops across both split transactions and the merge,
    recovered exactly once."""
    import numpy as np
    from repro_torch.checkpoint.dfc_checkpoint import CrashNow, FaultInjector, SimFS
    from repro_torch.obs import FabricObserver, durable_digest
    from repro_torch.runtime.dfc_shard import ShardedDFCRuntime

    for depth in (1, 3):
        K.reset_launches()
        out = run_serve(serve_shards, serve_shards.build_parser().parse_args(
            DURABLE + ["--split-backlog", str(DURABLE_SPLIT_N), "--depth", str(depth)]))
        for k, v in K.LAUNCHES.items():
            totals[k] += v
        got = (f"{out['pwb'] / out['n_ops']:.3f}", f"{out['pfence'] / out['n_ops']:.3f}")
        check(got == DURABLE_SPLIT[depth] and [ln for ln in out["lines"] if ln.startswith(
            "split:")] == DURABLE_SPLIT_LINES,
              f"lanes (c) depth {depth}: pwb/op, pfence/op {got} and splits {out['splits']}, "
              f"the reference's {DURABLE_SPLIT[depth]} and {DURABLE_SPLIT_LINES}")
        print(f"lanes (c) depth {depth}: splits {out['splits']}, pwb/op {got[0]} pfence/op "
              f"{got[1]} (the reference's), {out['n_ops'] / out['seconds']:.1f} ops/s, "
              f"launches {dict(K.LAUNCHES)}", flush=True)
    # kernel against plain at depth 1 on the first 10 phases (both splits
    # among them): the map's plain version walks lane by lane on the card
    digests = {}
    argv = DURABLE + ["--split-backlog", str(DURABLE_SPLIT_N), "--phases", "10"]
    for backend in ("kernel", "ref"):
        serve_shards.ShardedDFCRuntime = functools.partial(ShardedDFCRuntime, backend=backend)
        try:
            out = run_serve(serve_shards, serve_shards.build_parser().parse_args(argv))
        finally:
            serve_shards.ShardedDFCRuntime = ShardedDFCRuntime
        digests[backend] = out["digest"]
    check(digests["kernel"] == digests["ref"],
          "lanes (c): kernel and plain backends wrote different durable roots")

    kinds = [sorted(KINDS)[s % 4] for s in range(16)]
    lanes, capacity, threads, per = 256, 1024, 4, 64
    rng = np.random.default_rng(9)
    uniq = rng.permutation(4096)[: 3 * threads * per].reshape(3, threads, per)
    ins = [[(uniq[p, t], np.ones(per, np.int64),
             (1 + (p * threads + t) * per + np.arange(per)).astype(np.float32))
            for t in range(threads)] for p in range(3)]
    everything = sorted(float(v) for b in sum(ins, []) for v in b[2])

    def drive(root, crash_at=None, obs=None, backend="kernel"):
        inj = FaultInjector(crash_at=crash_at)
        rt = ShardedDFCRuntime(kinds, 16, capacity, lanes, fs=SimFS(root, inj), n_threads=threads,
                               n_buckets=64, backend=backend, obs=obs, device="cuda")
        donor = None
        try:
            for p, batches in enumerate(ins):
                if p == 1:  # split the fullest shard
                    donor = int(np.argmax(rt.shard_sizes()))
                    rt.split_shard(donor)
                if p == 2:  # split again, then fold the first new shard back
                    rt.split_shard(int(np.argmax(rt.shard_sizes())))
                    rt.merge_shards(16, donor)
                for t, b in enumerate(batches):
                    rt.announce(t, *b, token=p + 1)
                rt.combine_phase()
            rt.flush()
        except CrashNow:
            return rt, inj.count, True
        return rt, inj.count, False

    with tempfile.TemporaryDirectory(prefix="chip_smoke_reshard_") as tmp:
        tmp = Path(tmp)
        obs = FabricObserver(trace_capacity=1 << 20)
        K.reset_launches()
        rt, total, crashed = drive(tmp / "dry", obs=obs)
        for k, v in K.LAUNCHES.items():
            totals[k] += v
        check(not crashed and _values(rt, rt.kinds) == everything, "lanes (c): the dry run")
        drive(tmp / "ref", backend="ref")
        check(durable_digest(tmp / "dry") == durable_digest(tmp / "ref"),
              "lanes (c): the reshard drive's kernel and plain roots differ")
        marks = [(n, e["op"]) for n, e in op_marks(obs.trace.events()) if e["ev"] == "reshard"]
        check([op for _, op in marks] == ["split", "split", "merge"], f"lanes (c): {marks}")
        (c_a, _), (c_b, _), (c_m, _) = marks
        # the rEpoch commit's even write is op c: c-4 falls after the intent's
        # pfence and before the commit (rolled back), c after it (rolled
        # forward); c_m + 2 is the merge's first shard-epoch pfence
        points = [c_a - 4, c_a, c_b - 1, c_m, c_m + 2, total - 1]
        # the topology each crash must recover: (shard count, shard 16 routed)
        topology = [(16, False), (17, True), (17, True), (18, False), (18, False), (18, False)]
        for k, want in zip(points, topology):
            _, _, crashed = drive(tmp / f"c{k}", crash_at=k)
            check(crashed, f"lanes (c): no crash at op {k}")
            rt, report = ShardedDFCRuntime.recover(
                SimFS(tmp / f"c{k}"), kind=kinds, n_shards=16, capacity=capacity, lanes=lanes,
                n_threads=threads, n_buckets=64, device="cuda")
            check((rt.n_shards, 16 in rt.table) == want,
                  f"lanes (c): crash at op {k} recovered {rt.n_shards} shards, table "
                  f"{rt.table.tolist()}; expected {want}")
            rt.replay_pending(report)
            surfaced = {t: report[t]["token"] or 0 for t in range(threads)}
            for p, batches in enumerate(ins):
                for t, b in enumerate(batches):
                    if p + 1 > surfaced[t]:
                        rt.announce(t, *b, token=p + 1)
                rt.combine_phase()
            rt.flush()
            check(_values(rt, rt.kinds) == everything,
                  f"lanes (c): crash at op {k}: not exactly once")
        print(f"lanes (c): splits and a merge on 16 mixed shards, {total} persistence ops "
              f"(rEpoch commits at ops {c_a}, {c_b}, {c_m}); kernel and plain roots equal "
              f"({durable_digest(tmp / 'dry')}); crash points {points} recovered and replayed "
              "exactly once", flush=True)


def queue_lane_cost(torch, root, split, skewed):
    """Steady-state (pwb/op, pfence/op) of a one-shard queue on the card,
    one lane or two, under arrival skew or drained (after the JAX package's
    elimination-jitter test)."""
    from repro_torch.checkpoint.dfc_checkpoint import SimFS
    from repro_torch.core import torch_dfc as T
    from repro_torch.runtime.dfc_shard import ShardedDFCRuntime
    m, n_phases = 8, 6
    fs = SimFS(root)
    rt = ShardedDFCRuntime("queue", 1, 256, 32, fs=fs, n_threads=1, split_lanes=split,
                           device="cuda")
    key = rt.key_for_shard(0)
    token = [0]

    def phase(ops, params):
        token[0] += 1
        rt.announce(0, [key] * len(ops), ops, params, token=token[0])
        rt.combine_phase()

    if skewed:
        phase([T.OP_PUSH] * (3 * m), [float(i) for i in range(3 * m)])
        for p in (1, 2):
            phase([T.OP_PUSH] * m, [100.0 * p + i for i in range(m)])
            phase([T.OP_POP] * m, [0.0] * m)
        base = dict(fs.stats)
        for p in range(n_phases):
            phase([T.OP_PUSH] * m, [100.0 * (10 + p) + i for i in range(m)])
            phase([T.OP_POP] * m, [0.0] * m)
    else:
        for _ in (1, 2):
            phase([T.OP_PUSH] * m + [T.OP_POP] * m, [float(i) for i in range(2 * m)])
        base = dict(fs.stats)
        for p in range(n_phases):
            phase([T.OP_PUSH] * m + [T.OP_POP] * m, [10.0 * p + i for i in range(2 * m)])
    n = n_phases * 2 * m
    return ((fs.stats["pwb"] - base["pwb"]) / n, (fs.stats["pfence"] - base["pfence"]) / n)


def lanes_library(torch, T, K, totals):
    """(d) Per-side lanes through the library: 16 mixed shards, the serial,
    pipelined (depth 3, chain 4), seeded-driver and phase_loop drives,
    kernel against plain; crashes at six ops, both sides of one handoff
    commit among them, recovered exactly once; the jitter schedule's
    counts."""
    import numpy as np
    from repro_torch.checkpoint.dfc_checkpoint import CrashNow, FaultInjector, SimFS
    from repro_torch.obs import FabricObserver, durable_digest
    from repro_torch.runtime.announce_driver import MultiThreadDriver
    from repro_torch.runtime.dfc_shard import ShardedDFCRuntime, route_keys_host

    kinds = [sorted(KINDS)[s % 4] for s in range(16)]
    lanes, capacity, threads, per = 256, 1024, 4, 64
    rng = np.random.default_rng(5)
    opmax = np.asarray([T.STRUCTS[k].n_opcodes for k in kinds])
    sched = []
    for _ in range(3):
        batches = []
        for _ in range(threads):
            keys = rng.integers(0, 4096, per)
            ops = rng.integers(0, opmax[route_keys_host(keys, 16)])
            batches.append((keys, ops, (rng.random(per) * 100).round(2).astype(np.float32)))
        sched.append(batches)

    def fabric(root, crash_at=None, backend="kernel", depth=1, chain=1, obs=None, split=True):
        inj = FaultInjector(crash_at=crash_at)
        fs = SimFS(root, inj)
        return ShardedDFCRuntime(kinds, 16, capacity, lanes, fs=fs, n_threads=threads,
                                 backend=backend, depth=depth, chain=chain, split_lanes=split,
                                 obs=obs, device="cuda"), fs, inj

    def drive(root, crash_at=None, **kw):
        rt, fs, inj = fabric(root, crash_at, **kw)
        done = []
        try:
            for p, batches in enumerate(sched):
                for t, b in enumerate(batches):
                    rt.announce(t, *b, token=p + 1)
                rt.combine_phase()
                done.append(p)
            rt.flush()
        except CrashNow:
            return rt, done, True, inj.count, fs
        return rt, done, False, inj.count, fs

    def counted(fn):
        K.reset_launches()
        out = fn()
        for k, v in K.LAUNCHES.items():
            totals[k] += v
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_lanes_") as tmp:
        tmp = Path(tmp)
        roots = {}
        for name, kw in (("lock", {"chain": threads}), ("pipe", {"depth": 3, "chain": threads})):
            counted(lambda: drive(tmp / name, **kw))
            drive(tmp / f"{name}_ref", backend="ref", **kw)
            roots[name] = durable_digest(tmp / name)
            check(roots[name] == durable_digest(tmp / f"{name}_ref"),
                  f"lanes (d) {name}: kernel and plain roots differ")
        # the cost of the split-lane commit: the serial drive, one lane and
        # two, on the host clock (the durable path is host-bound)
        cost = {}
        for split in (False, True):
            t1 = time.perf_counter()
            *_, fs = drive(tmp / f"cost{int(split)}", split=split)
            cost[split] = (time.perf_counter() - t1, fs.stats["pwb"], fs.stats["pfence"])
        flat = [(t, p + 1, *b) for p, batches in enumerate(sched) for t, b in enumerate(batches)]
        for axis in ("grid", "scan"):
            rt, _, _ = fabric(tmp / f"loop_{axis}")
            counted(lambda: rt.phase_loop(flat, phase_axis=axis))
            check(durable_digest(tmp / f"loop_{axis}") == roots["lock"],
                  f"lanes (d): phase_loop {axis} differs from the serial drive's root")
        for backend in ("kernel", "ref"):
            rt, _, _ = fabric(tmp / f"drv_{backend}", backend=backend)
            drv = MultiThreadDriver(rt, seed=1)

            def run_driver():
                for batches in sched:
                    for t, b in enumerate(batches):
                        drv.submit(t, *b)
                    drv.run()
            counted(run_driver) if backend == "kernel" else run_driver()
        check(durable_digest(tmp / "drv_kernel") == durable_digest(tmp / "drv_ref"),
              "lanes (d): the seeded driver's kernel and plain roots differ")

        obs = FabricObserver(trace_capacity=1 << 20)
        rt, _, crashed, total, _ = drive(tmp / "dry", obs=obs)
        check(not crashed, "lanes (d): the dry run crashed")
        pairs = rt.lane_stats()["epochs"]
        handoffs = [n for n, e in op_marks(obs.trace.events())
                    if e["ev"] == "epoch_commit" and e.get("mode") == "handoff"]
        check(handoffs, "lanes (d): the schedule made no handoff commit")
        c_h = handoffs[0]  # its even pair write; c_h - 1 is the odd pair's pfence
        points = sorted({total // 6, c_h - 1, c_h, total // 2, 5 * total // 6, total - 1})
        for k in points:
            _, done, crashed, _, _ = drive(tmp / f"c{k}", crash_at=k)
            check(crashed, f"lanes (d): no crash at op {k}")
            rt, report = ShardedDFCRuntime.recover(
                SimFS(tmp / f"c{k}"), kind=kinds, n_shards=16, capacity=capacity, lanes=lanes,
                n_threads=threads, split_lanes=True, device="cuda")
            rt.replay_pending(report)
            _exactly_once(rt, sched, done, report, kinds, lanes, capacity)
        costs = {key: queue_lane_cost(torch, tmp / f"jit{int(key[0])}{int(key[1])}", *key)
                 for key in JITTER}
        check(costs == JITTER, f"lanes (d): the jitter schedule's counts {costs}, the CPU's "
                               f"{JITTER}")
        check(costs[(True, True)][0] < costs[(False, True)][0],
              "lanes (d): two lanes do not beat one under skew")
        print(f"lanes (d): split lanes on 16 mixed shards: serial, depth 3 (chain 4), the seeded "
              f"driver and phase_loop (grid, scan) kernel roots equal the plain ones and "
              f"phase_loop the serial root; {total} persistence ops, first handoff commit at op "
              f"{c_h}; crash points {points} recovered exactly once; the serial drive's lane pairs "
              f"{pairs}; the serial drive with one lane and two (s, pwb, pfence): "
              f"{cost[False][0]:.3f} / {cost[True][0]:.3f} s, {cost[False][1:]} / {cost[True][1:]}; "
              f"jitter "
              f"pwb/op, pfence/op {costs} (the CPU's)", flush=True)


def lanes_serve(torch, K, totals, model_totals, params):
    """(e) smollm-135m served with per-side lanes and an autosplit, durable
    and traced: the reference's split and lane lines and counts, exact
    launch counts, the traced root equal to an untraced tier-only run's, a
    crash halfway and one inside the split transaction, each resumed
    exactly once, and the first prefill replayed on the plain backend."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.obs import durable_digest, read_trace
    base = SERVE_RUNS["smollm-135m"] + LANE_SERVE
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lanes_serve_") as tmp:
        whole = Path(tmp) / "whole"
        out, first, model = serve_and_check(torch, serve_mod, K, base + [
            "--trace", "--state-dir", str(whole)], params)
        fabric = dict(K.LAUNCHES)
        for k, v in fabric.items():
            totals[k] += v
        for k, v in model.items():
            model_totals[k] += v
        tier = out["tier"]
        phases = sum(e["ev"] == "dispatch" for e in read_trace(whole / "tier" / "obs" / "trace.jsonl"))
        want = {k: (phases if k in ("deque", "stack", "map") else 0) for k in K.LAUNCHES}
        check(fabric == want, f"lanes (e): combine launches {fabric} over {phases} tier phases")
        p = tier.persistence_stats()
        pairs = " ".join(f"s{s}=[{e[0]},{e[1]}]" for s, e in sorted(
            tier.rt.lane_stats()["epochs"].items()))
        got = (f"split lanes: head/tail epochs {pairs}",
               f"pwb/op: {p['pwb_per_op']:.2f}  pfence/op: {p['pfence_per_op']:.2f}")
        check(tier.stats["splits"] == 1 and got == LANE_SERVE_LINES,
              f"lanes (e): splits={tier.stats['splits']}, {got}; the reference's {LANE_SERVE_LINES}")
        only = Path(tmp) / "only"
        out_t = _run_serve(serve_mod, base + ["--tier-only", "--state-dir", str(only)], echo=False)
        check(durable_digest(whole / "tier") == durable_digest(only / "tier")
              and tier.rt.fs.pstats.as_dict() == out_t["tier"].rt.fs.pstats.as_dict(),
              "lanes (e): the traced root or its per-tag counts differ from the tier-only run's")
        replay_first_batch(torch, out, first, serve_mod.build_parser().parse_args(base).gen)
        total = tier.rt.fs.injector.count
        # the split transaction's ops, probed on a traced tier-only run: the
        # rEpoch commit's even write, after the odd pair's fsync (committed)
        probe = Path(tmp) / "probe"
        _run_serve(serve_mod, base + ["--tier-only", "--trace", "--state-dir", str(probe)],
                   echo=False)
        marks = [n for n, e in op_marks(read_trace(probe / "tier" / "obs" / "trace.jsonl"))
                 if e["ev"] == "reshard"]
        check(len(marks) == 1, f"lanes (e): the probe split {len(marks)} times")
        for crash in (total // 2, marks[0]):
            cdir = Path(tmp) / f"crash{crash}"
            out_c = _run_serve(serve_mod, base + ["--state-dir", str(cdir), "--crash-at",
                                                  str(crash)], params, echo=False)
            check(out_c["crashed"], f"lanes (e): no crash at persistence op {crash}")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out_r = serve_mod.serve(serve_mod.build_parser().parse_args(
                    base + ["--state-dir", str(cdir), "--resume", "--expect-exactly-once"]),
                    params=params)
            text = buf.getvalue()
            check(not out_r["crashed"] and out_r["completed"] == 16 and "queues=5" in text
                  and "exactly-once OK" in text,
                  f"lanes (e): the resume after a crash at op {crash}: {text[-400:]}")
            print(f"lanes (e): crash at persistence op {crash} of {total}, resumed: "
                  + next(ln for ln in text.splitlines() if ln.startswith("request tier:"))[:60]
                  + "..., exactly once", flush=True)
        print(f"lanes (e): smollm-135m with --split-lanes --reshard-backlog 4: splits=1, "
              f"{got[0]}, {got[1]} (the reference's); {phases} tier phases, launches {fabric}, "
              f"model {model}; traced root equal to the tier-only run's", flush=True)


def phase_lanes_reshard(torch, T, K, serve_shards, records, params):
    """Phase 9: per-side lanes and resharding, (a)-(e) above; each
    kernel's record gains the launches of (b)-(e) (the comparisons with
    the plain versions excluded) under ``lanes_reshard_launches``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    totals = {k: 0 for k in K.LAUNCHES}
    model_totals = {k: 0 for k in MODEL_KERNELS}
    seen = lanes_full_width(torch, T, K, serve_shards, totals)
    lanes_device_steps(torch, T, seen)
    del seen
    torch.cuda.empty_cache()
    print(f"lanes (a), (b): {time.perf_counter() - t0:.1f} s into phase 9", flush=True)
    lanes_durable(torch, T, K, serve_shards, totals)
    print(f"lanes (c): {time.perf_counter() - t0:.1f} s into phase 9", flush=True)
    lanes_library(torch, T, K, totals)
    print(f"lanes (d): {time.perf_counter() - t0:.1f} s into phase 9", flush=True)
    smollm = params.get("smollm-135m") or init_params(get_config("smollm-135m"), seed=0,
                                                      device=torch.device("cuda"))
    lanes_serve(torch, K, totals, model_totals, smollm)
    for name, n in list(totals.items()) + list(model_totals.items()):
        if name in records:
            records[name]["lanes_reshard_launches"] = n
    print(f"lanes: launches {totals}, model {model_totals}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ----------------------------------------------------------- paper objects
# phase 10 (a): the figures' thread counts and the DFC-TOTAL / DFC-combiner
# (pwb/op, pwb/op, pfence/op, pfence/op) the reference's run_dfc_counts gives
# on the CPU at 800 ops, seed 7, think (0, 30) (bench_persistence's
# settings); the baselines at 40 threads on the stack's push-pop
PAPER_THREADS = (1, 2, 4, 8, 16, 24, 32, 40)
PAPER_OPS = 800
PAPER_PINNED = {
    ("stack", "push-pop", 1): (5.5, 3.5, 4.0, 2.0),
    ("stack", "push-pop", 8): (3.70875, 1.70875, 2.515, 0.515),
    ("stack", "push-pop", 40): (3.44, 1.44, 2.1, 0.1),
    ("queue", "push-pop", 40): (3.685, 1.685, 2.1, 0.1),
    ("deque", "push-pop", 40): (3.86625, 1.86625, 2.1, 0.1),
    ("stack", "rand-op", 40): (3.175, 1.175, 2.1, 0.1),
}
BASELINES_T40 = {"romulus": (5.025, 0.075), "onefile": (24.0, 24.0), "pmdk": (4.5, 3.0)}
# phase 10 (b): the reference tests' crash sweeps (tests/test_crash_recovery.py,
# test_dfc_queue.py, test_dfc_deque.py) as (structure, workload, seed, mode,
# stride) -> (crash points, pending ops reported as taken effect, as not, the
# first 16 hex digits of the sha256 of the JSON list of each point's sorted
# took_effect items): the reference's verdicts on the CPU
CRASH_SWEEPS = {
    ("stack", "small", 0, "MIN", 1): (309, 672, 200, "fb47c8531cb7f7fe"),
    ("stack", "small", 0, "MAX", 1): (309, 704, 168, "4993b178b4d418d5"),
    ("stack", "small", 1, "RANDOM", 2): (142, 333, 90, "4edcb6238dc3f600"),
    ("stack", "larger", 0, "RANDOM", 7): (136, 558, 98, "51c9c4c5308d9566"),
    ("queue", "small", 0, "MIN", 1): (351, 782, 193, "a1da7c73b108d85c"),
    ("queue", "small", 0, "MAX", 1): (351, 815, 160, "1e687b3815d503fe"),
    ("queue", "small", 1, "RANDOM", 2): (152, 363, 90, "d01896d1b788da9e"),
    ("queue", "larger", 0, "RANDOM", 7): (119, 395, 63, "962a3def8c926ae5"),
    ("deque", "small", 0, "MIN", 1): (351, 782, 193, "a1da7c73b108d85c"),
    ("deque", "small", 0, "MAX", 1): (351, 815, 160, "1e687b3815d503fe"),
    ("deque", "small", 1, "RANDOM", 2): (152, 361, 90, "0844d482ec1d71f9"),
    ("deque", "larger", 0, "RANDOM", 7): (112, 363, 69, "d9cc3f0167bf2365"),
}
# phase 10 (c): examples/quickstart.py's lines on the CPU, part 2's header
# the port's (it names the card)
QUICKSTART_LINES = [
    "== 1. paper-faithful DFC stack ==",
    "   ops: [('pop', None, 12), ('push', 12, 'ACK'), ('pop', None, 10), ('push', 10, "
    "'ACK'), ('pop', None, 91), ('pop', None, 93), ('push', 93, 'ACK'), ('push', 91, 'ACK')]",
    "   combining phases: 2, eliminated pairs: 4",
    "   pwb: {'announce': 16, 'combine': 12}  pfence: {'announce': 16, 'combine': 4}",
    "   crash injection at step 25 + recovery ...",
    "   durable-linearizable after recovery: True; took-effect: {3: False, 2: True, 1: "
    "False, 0: False}",
    "== 2. CUDA-native vectorized combine ==",
    "   responses: [0. 0. 1. 0. 2. 3.] kinds: [1 1 2 1 2 2]",
    "   stack after phase: []",
    "== 3. DFC-Checkpoint ==",
    "   committed step 1; pwb=20 pfence=10 (4 workers -> 1 slot persist)",
    "   detectability report: {0: {'committed': True, 'step': 1}, 1: {'committed': True, "
    "'step': 1}, 2: {'committed': True, 'step': 1}, 3: {'committed': True, 'step': 1}}",
    "done.",
]


def _paper_structures():
    from repro_torch.core import baselines as B
    from repro_torch.core.dfc import DFCStack
    from repro_torch.core.dfc_deque import DFCDeque
    from repro_torch.core.dfc_queue import DFCQueue
    return {"stack": (DFCStack, B.PMDKStack, B.RomulusStack, B.OneFileStack),
            "queue": (DFCQueue, B.PMDKQueue, B.RomulusQueue, B.OneFileQueue),
            "deque": (DFCDeque, B.PMDKQueue, B.RomulusQueue, B.OneFileQueue)}


def paper_counts():
    """Phase 10 (a): the figure 3b-c table (DFC-TOTAL and DFC-combiner pwb/op
    and pfence/op beside Romulus, OneFile and PMDK) for every structure, mix
    and thread count, printed; the pinned points and the paper's ordering
    held."""
    from repro_torch.core import baselines as B
    t0 = time.perf_counter()
    rows = {}
    for structure, (dfc_cls, pmdk_cls, rom_cls, one_cls) in _paper_structures().items():
        for mix in ("push-pop", "rand-op"):
            line = []
            for n in PAPER_THREADS:
                def work():
                    return B.make_workloads(mix, n, PAPER_OPS, structure=structure)
                d = B.run_dfc_counts(n, work(), seed=7, think=(0, 30), structure=dfc_cls)
                ops = d["ops"]
                rom, one, pmdk = (c(n).run(work()) for c in (rom_cls, one_cls, pmdk_cls))
                row = ((d["pwb_combine"] + d["pwb_announce"]) / ops, d["pwb_combine"] / ops,
                       (d["pfence_combine"] + d["pfence_announce"]) / ops,
                       d["pfence_combine"] / ops)
                rows[(structure, mix, n)] = row
                line.append(f"t{n} {row[0]:.4f}/{row[1]:.4f} {row[2]:.4f}/{row[3]:.4f} "
                            f"rom {rom.pwb_per_op():.3f}/{rom.pfence_per_op():.3f} one "
                            f"{one.pwb_per_op():.2f}/{one.cas / max(one.ops, 1):.2f} pmdk "
                            f"{pmdk.pwb_per_op():.3f}/{pmdk.pfence_per_op():.3f}")
                if (structure, mix, n) == ("stack", "push-pop", 40):
                    got = {"romulus": (rom.pwb_per_op(), rom.pfence_per_op()),
                           "onefile": (one.pwb_per_op(), one.cas / max(one.ops, 1)),
                           "pmdk": (pmdk.pwb_per_op(), pmdk.pfence_per_op())}
                    check(all(math.isclose(a, b, rel_tol=0, abs_tol=1e-12)
                              for k in BASELINES_T40 for a, b in zip(got[k], BASELINES_T40[k])),
                          f"baselines at t40: {got}, expected {BASELINES_T40}")
            print(f"fig 3b-c {structure} {mix} (DFC-TOTAL/DFC-combiner pwb/op, pfence/op; "
                  f"Romulus, OneFile, PMDK pwb/op/pfence/op): " + "; ".join(line), flush=True)
    for key, want in PAPER_PINNED.items():
        check(all(math.isclose(a, b, rel_tol=0, abs_tol=1e-12) for a, b in zip(rows[key], want)),
              f"fig 3b-c {key}: {rows[key]}, the reference's {want}")
    # tests/test_baselines.py::test_paper_ordering_at_high_concurrency
    n, total = 40, 400
    dfc = B.run_dfc_counts(n, B.make_workloads("push-pop", n, total))
    combiner = dfc["pwb_combine"] / dfc["ops"]
    dfc_total = (dfc["pwb_combine"] + dfc["pwb_announce"]) / dfc["ops"]
    rom = B.RomulusStack(n).run(B.make_workloads("push-pop", n, total)).pwb_per_op()
    one = B.OneFileStack(n).run(B.make_workloads("push-pop", n, total)).pwb_per_op()
    check(combiner < rom < one and dfc_total < one,
          f"the paper's ordering at 40 threads: DFC-combiner {combiner}, Romulus {rom}, "
          f"OneFile {one}, DFC-TOTAL {dfc_total}")
    print(f"paper objects (a): the {len(PAPER_PINNED)} pinned points and the baselines at t40 "
          f"equal the reference's; at 40 threads DFC-combiner {combiner:.4f} < Romulus "
          f"{rom:.4f} < OneFile {one:.4f}, DFC-TOTAL {dfc_total:.4f} < OneFile "
          f"({time.perf_counter() - t0:.1f} s host)", flush=True)


def _sweep_workloads(structure, which):
    """The reference tests' ``SMALL`` and larger sweep workloads."""
    from repro_torch.core.dfc import DEQ, ENQ, POP, POPL, POPR, PUSH, PUSHL, PUSHR
    if which == "small":
        return {"stack": [[(PUSH, 11), (POP, None)], [(PUSH, 22), (PUSH, 23)],
                          [(POP, None), (PUSH, 33)]],
                "queue": [[(ENQ, 11), (DEQ, None)], [(ENQ, 22), (ENQ, 23)],
                          [(DEQ, None), (ENQ, 33)]],
                "deque": [[(PUSHL, 11), (POPR, None)], [(PUSHR, 22), (PUSHL, 23)],
                          [(POPL, None), (PUSHR, 33)]]}[structure]
    if structure == "stack":
        return [[(PUSH, 100 * t + i) for i in range(2)] + [(POP, None)] for t in range(5)]
    if structure == "queue":
        return [[(ENQ, 100 * t + i) for i in range(2)] + [(DEQ, None)] for t in range(4)]
    return [[(PUSHL if (t + i) % 2 else PUSHR, 100 * t + i) for i in range(2)]
            + [(POPL if t % 2 else POPR, None)] for t in range(4)]


def paper_crash_sweeps():
    """Phase 10 (b): the reference tests' crash sweeps: every crash point
    durably linearizable after recovery, a taken-effect op's recovered
    response neither BOT nor INIT, and the detectability verdicts the
    reference gives.  Returns the number of crash points."""
    import hashlib
    from repro_torch.core.dfc import BOT, INIT
    from repro_torch.core.harness import (check_durable_linearizability, run_with_crash,
                                          total_steps)
    from repro_torch.nvm.memory import CrashMode
    t0 = time.perf_counter()
    classes = {k: v[0] for k, v in _paper_structures().items()}
    points = 0
    for (structure, which, seed, mode, stride), want in CRASH_SWEEPS.items():
        cls, w = classes[structure], _sweep_workloads(structure, which)
        verdicts, bad = [], []
        for k in range(1, total_steps(w, seed=seed, structure=cls), stride):
            res = run_with_crash(w, crash_at=k, seed=seed, mode=CrashMode[mode], structure=cls)
            check(res.crashed, f"{structure} {which} crash at {k}: no crash")
            for tid, effect in res.took_effect.items():
                check(not effect or (res.recovered[tid] is not BOT
                                     and res.recovered[tid] != INIT),
                      f"{structure} {which} crash at {k}: thread {tid} took effect without "
                      "a response")
            verdicts.append(sorted(res.took_effect.items()))
            if not check_durable_linearizability(res):
                bad.append(k)
        check(not bad, f"{structure} {which} seed {seed} {mode}: not durably linearizable at "
                       f"crash points {bad}")
        n_true = sum(v for pt in verdicts for _, v in pt)
        n_false = sum(not v for pt in verdicts for _, v in pt)
        digest = hashlib.sha256(json.dumps(verdicts).encode()).hexdigest()[:16]
        got = (len(verdicts), n_true, n_false, digest)
        check(got == want, f"{structure} {which} seed {seed} {mode}: verdicts {got}, the "
                           f"reference's {want}")
        points += len(verdicts)
    print(f"paper objects (b): {points} crash points over {len(CRASH_SWEEPS)} sweeps (stack, "
          "queue, deque in MIN, MAX and RANDOM), every one durably linearizable, the "
          f"detectability verdicts the reference's ({time.perf_counter() - t0:.1f} s host)",
          flush=True)
    return points


def paper_quickstart(torch):
    """Phase 10 (c): ``python -m repro_torch.launch.quickstart`` on the card
    in a process of its own: its lines the reference's, the stack kernel
    launched once and its phase equal to the plain version's.  Returns the
    launches."""
    from repro_torch.core.torch_dfc import init_stack
    from repro_torch.kernels.dfc_reduce.ops import dfc_combine_step
    from repro_torch.launch import quickstart as Q
    code = textwrap.dedent("""
        import json
        import torch
        from repro_torch.kernels.dfc_reduce import kernel as K
        from repro_torch.launch import quickstart as Q
        K.reset_launches()
        out = Q.main(["--device", "cuda"])
        outs = (out["resp"], out["kinds"], *out["state"].leaves())
        print(json.dumps({"launches": K.LAUNCHES, "device": str(out["resp"].device),
                          "outs": [t.reshape(-1).view(torch.int32).tolist() for t in outs]}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    check(proc.returncode == 0, f"the quickstart failed: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    got = json.loads(lines[-1])
    check(lines[:-1] == QUICKSTART_LINES,
          "the quickstart's lines differ from the reference's: "
          + repr([(a, b) for a, b in zip(lines[:-1], QUICKSTART_LINES) if a != b][:3]))
    want_launches = {k: int(k == "stack") for k in got["launches"]}
    check(got["device"].startswith("cuda") and got["launches"] == want_launches,
          f"the quickstart's launches {got['launches']} on {got['device']}, expected one of "
          "the stack kernel")
    dev = torch.device("cuda")
    ops = torch.tensor(Q.COMBINE_OPS, dtype=torch.int32, device=dev)
    params = torch.tensor(Q.COMBINE_PARAMS, dtype=torch.float32, device=dev)
    state, resp, kinds = dfc_combine_step(init_stack(64, device=dev), ops, params,
                                          backend="ref")
    plain = [t.reshape(-1).view(torch.int32).tolist()
             for t in (resp, kinds, *state.leaves())]
    check(got["outs"] == plain, "the quickstart's combine differs from the plain version's "
                                f"bits: {got['outs']} against {plain}")
    print(f"paper objects (c): the quickstart on the card prints the reference's "
          f"{len(QUICKSTART_LINES)} lines (part 2's header the port's), the stack kernel "
          "launched once, its responses, kinds and state bit-equal to the plain version's",
          flush=True)
    return got["launches"]


def paper_single_object(torch, T, K):
    """Phase 10 (d): kernels 5-7 (the one-object steps, the one-phase kernels
    at S = 1) phase by phase on the 40 announcement lanes of
    ``make_workloads("rand-op", 40, 800)`` (one lane a thread, 20 phases a
    kind): kernel against plain bit for bit at every phase, the launches
    counted, each kernel timed at N = 40 beside its bound.  Returns the
    launches and the timings."""
    from repro_torch.core import baselines as B
    from repro_torch.core import dfc as D
    from repro_torch.kernels.dfc_reduce import ops as O
    codes = {D.PUSH: T.OP_PUSH, D.POP: T.OP_POP, D.ENQ: T.OP_ENQ, D.DEQ: T.OP_DEQ,
             D.PUSHL: T.OP_PUSHL, D.POPL: T.OP_POPL, D.PUSHR: T.OP_PUSHR, D.POPR: T.OP_POPR}
    steps = {"stack": O.dfc_combine_step, "queue": O.dfc_queue_combine_step,
             "deque": O.dfc_deque_combine_step}
    fns = calls()
    dev = torch.device("cuda")
    n = 40
    launches, timed = {}, {}
    for kind, step in steps.items():
        w = B.make_workloads("rand-op", n, PAPER_OPS, structure=kind)
        n_phases = len(w[0])
        ops = torch.tensor([[codes[w[t][i][0]] for t in range(n)] for i in range(n_phases)],
                           dtype=torch.int32, device=dev)
        par = torch.tensor([[w[t][i][1] or 0 for t in range(n)] for i in range(n_phases)],
                           dtype=torch.float32, device=dev)
        sk = T.STRUCTS[kind].init(1024, device=dev)
        sp = T.STRUCTS[kind].init(1024, device=dev)
        busiest = (-1, 0, sk)  # (committed size before the phase, phase, state)
        before = K.LAUNCHES[kind]
        for i in range(n_phases):
            prev = sk
            sk, rk, kk = step(sk, ops[i], par[i])
            sp, rp, kp = step(sp, ops[i], par[i], backend="ref")
            compare_outputs(f"{kind} one-object step, phase {i}", (rk, kk), (rp, kp))
            compare_states(f"{kind} one-object step, phase {i}", sk, sp)
            if int(prev.active_size()) > busiest[0]:
                busiest = (int(prev.active_size()), i, prev)
        launches[kind] = K.LAUNCHES[kind] - before
        check(launches[kind] == n_phases,
              f"{kind} one-object steps: {launches[kind]} launches over {n_phases} phases")
        # the kernel's own call at S = 1 on the phase with the most committed
        # elements (windows built from the state before it, as the step does)
        _, i, prev = busiest
        one = [a.contiguous() for a in kernel_inputs(
            kind, T.map_state(lambda x: x.unsqueeze(0), prev), ops[i:i + 1], par[i:i + 1],
            None)]
        kfn, pfn = fns[kind]
        compare_outputs(f"{kind} N=40 phase {i}", kfn(*one), pfn(*one))
        fields, _ = time_combine(torch, f"{NAMES[kind]} S=1 N=40", kfn, one)
        timed[kind] = {"ms": cuda_ms(lambda: kfn(*one), 20),
                       "plain_ms": cuda_ms(lambda: pfn(*one), 20),
                       **dict(zip(("bound_ms", "bound_by"), bound(kind, one))), **fields,
                       "phase": i, "shape": [1, n]}
    print("paper objects (d): kernels 5-7 (one object, S=1, N=40, 20 phases a kind of "
          "make_workloads('rand-op', 40, 800)) bit-equal to plain at every phase; launches "
          f"{launches}; " + ", ".join(
              f"{NAMES[k]} at N=40 {v['ms']:.4f} ms, device {v['device_ms']:.4f} ms "
              f"({v['device_ms_by']}), host {v['host_us']:.1f} us (plain {v['plain_ms']:.4f} "
              f"ms, bound {v['bound_ms'] * 1e6:.3f} ns by {v['bound_by']}; at N=64: "
              + (f"{SINGLE_N64[k][0]:.4f} ms, device {SINGLE_N64[k][1]:.4f} ms)"
                 if k in SINGLE_N64 else "phase 3 not run)")
              for k, v in timed.items()), flush=True)
    return launches, timed


def phase_paper_objects(torch, T, K, records):
    """Phase 10: (a)-(d) above; each kernel's record gains
    ``paper_objects_launches`` (the quickstart's and (d)'s) and the stack,
    queue and deque records the N = 40 timings under ``at``."""
    paper_counts()
    paper_crash_sweeps()
    quick = paper_quickstart(torch)
    single, timed = paper_single_object(torch, T, K)
    totals = {k: quick.get(k, 0) + single.get(k, 0) for k in K.LAUNCHES}
    for name in list(K.LAUNCHES) + list(MODEL_KERNELS):
        if name in records:
            records[name]["paper_objects_launches"] = totals.get(name, 0)
    for kind, fields in timed.items():
        if kind in records:
            records[kind].setdefault("at", {})["one object N=40"] = fields
    print(f"paper objects: launches {totals}", flush=True)


# ------------------------------------------------------------ dense configs
# phase 11: the two dense configs at their published widths, as phase 7
# serves smollm-135m (volatile FIFO tier)
DENSE_RUNS = {
    arch: ["--arch", arch, "--batch", "8", "--prompt-len", "512", "--gen", "32",
           "--sessions", "16", "--device", "cuda"] for arch in ("qwen2-1.5b", "olmo-1b")}
# the model kernels at the new shapes: flash attention at each config's
# heads (head dim 128), RMSNorm at qwen2's prefill rows (8 x 512, width 1536)
DENSE_KERNEL_SHAPES = {"flash_attention": [("qwen2-1.5b", (8, 512, 12, 2, 128)),
                                           ("olmo-1b", (8, 512, 16, 16, 128))],
                       "rmsnorm": [("qwen2-1.5b", (4096, 1536))]}


def phase_dense(torch, K, records):
    """Phase 11: ``qwen2-1.5b`` and ``olmo-1b`` served at full width through
    the kernels (exact launch counts, the first batch replayed on the plain
    backend, a profile), then the model kernels at the new shapes against
    their bounds and PyTorch calls; each record gains
    ``dense_configs_launches``."""
    from repro_torch.launch import serve as serve_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    totals = {k: 0 for k in list(K.LAUNCHES) + list(MODEL_KERNELS)}
    for arch, argv in DENSE_RUNS.items():
        torch.cuda.reset_peak_memory_stats()
        out, first, model = serve_and_check(torch, serve_mod, K, argv)
        fabric = dict(K.LAUNCHES)
        gen = serve_mod.build_parser().parse_args(argv).gen
        for k, v in list(model.items()) + list(fabric.items()):
            totals[k] += v
        replay_first_batch(torch, out, first, gen)
        profile_model(torch, out, first, gen)
        prefill_s = statistics.median(out["prefill_s"])
        print(f"serve {arch}: prefill {prefill_s * 1e3:.3f} ms per batch median "
              f"({first['prompts'].numel() / prefill_s:.0f} tok/s), decode "
              f"{statistics.median(out['decode_step_s']) * 1e3:.3f} ms per step median over "
              f"{len(out['decode_step_s'])} steps, {out['decoded_tokens'] / out['seconds']:.1f} "
              f"tok/s end to end, {out['cfg'].param_count() / 1e9:.3f} B params, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        del out, first
        torch.cuda.empty_cache()
    bf16 = torch.bfloat16
    for name, runs in DENSE_KERNEL_SHAPES.items():
        rec = records.get(name)
        for arch, shape in runs:
            fields = measure_model_kernel(torch, name, shape, bf16)
            if rec is None:
                src, replaces = MODEL_KERNELS[name]
                rec = records[name] = {"name": name, "route": "cuda", "source": src,
                                       "replaces": replaces, "launches": totals[name], **fields}
            rec.setdefault("at", {})[f"{arch} " + "x".join(map(str, shape))] = fields
    for name, n in totals.items():
        if name in records:
            records[name]["dense_configs_launches"] = n
    print(f"dense configs: launches {totals}", flush=True)


def turns_kernels(root):
    """The combine-kernel wrappers (``kernel.py``) of the repository checkout
    at ``root``, loaded beside this tree's: its ``csrc`` sources build into
    this tree's ``build/`` under their own content hash."""
    import importlib.util
    path = Path(root).resolve() / "src/repro_torch/kernels/dfc_reduce/kernel.py"
    check(path.is_file(), f"--turns {root}: no {path}")
    spec = importlib.util.spec_from_file_location("turns_dfc_kernel", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one card")
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated phases to run (default: all; 1 and 2 always run)")
    ap.add_argument("--turns", metavar="DIR",
                    help="also time the combine kernels of the repository checkout at DIR "
                         "in turns with this tree's (DIR's, this, this, DIR's) in phases 4 "
                         "and 5, on the same inputs, after holding their outputs bit for bit")
    opts = ap.parse_args(argv)
    run = set(opts.phases.split(",")) | {"1", "2"}
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
        clk = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=60)
        check(clk.returncode == 0, f"nvidia-smi failed: {clk.stderr.strip()}")
        CARD["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
        CARD["sm_clock_hz"] = float(clk.stdout.strip()) * 1e6
        print(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
              f"{CARD['sms']} SMs, max SM clock {CARD['sm_clock_hz'] / 1e6:.0f} MHz",
              flush=True)
        print(card, flush=True)

    from repro_torch.core import torch_dfc as T
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.dfc_reduce import kernel as K
    from repro_torch.launch import serve_shards

    with phase("2 build"):
        t0 = time.perf_counter()
        log = io.StringIO()
        libraries = list(K.LIBRARIES)
        for mod in model_kernel_mods().values():
            libraries += mod.LIBRARIES
        with contextlib.redirect_stdout(log):
            libs = nvcc.build(libraries, verbose=True)
            if opts.turns:
                PARENT["K"] = turns_kernels(opts.turns)
                libs.update({f"{k} (--turns)": v for k, v in PARENT["K"].build().items()})
        usage = [ln.strip() for ln in log.getvalue().splitlines()
                 if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
        print(f"build: {', '.join(str(p.relative_to(ROOT)) for p in libs.values())} in "
              f"{time.perf_counter() - t0:.1f} s; " + "; ".join(usage), flush=True)

    if "3" in run:
        with phase("3 kernels"):
            phase_kernels_adversarial(torch, T)
            phase_grid_adversarial(torch, T)
            phase_model_kernels(torch)

    records = {}
    if "4" in run or "5" in run:
        with phase("4 volatile"):
            batches = phase_volatile(torch, T, K, serve_shards, records)

    if "5" in run:
        with phase("5 fused"):
            phase_fused(torch, T, K, serve_shards, records, batches)

    if "6" in run:
        with phase("6 durable"):
            phase_durable(torch, T, K, serve_shards)

    params = {}
    if "7" in run:
        with phase("7 serve"):
            params = phase_serve(torch, K, records)

    if "8" in run:
        with phase("8 continuous"):
            phase_continuous(torch, K, records, params)

    if "9" in run:
        with phase("9 lanes and resharding"):
            phase_lanes_reshard(torch, T, K, serve_shards, records, params)
    params.clear()
    torch.cuda.empty_cache()

    if "10" in run:
        with phase("10 paper objects"):
            phase_paper_objects(torch, T, K, records)

    if "11" in run:
        with phase("11 dense configs"):
            phase_dense(torch, K, records)

    print(card, flush=True)
    order = list(KINDS) + [f"phase_grid_{k}" for k in KINDS] + list(MODEL_KERNELS)
    print(json.dumps({"kernels": [records[k] for k in order if k in records]}), flush=True)
    if run != set(ALL_PHASES):
        print(f"partial run (phases {sorted(run)}): no result line", flush=True)
        return 0
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
