"""Serving-style traffic over the sharded DFC runtime, on the card.

The port's counterpart of the JAX package's ``examples/serve_shards.py``,
with the same flags and traffic: a Zipf-skewed key draw
(``zipf_keys(rng, batch, 4096, skew)``, seed 0), op codes drawn per key to
be valid for the target shard's kind, ``lanes = batch`` and ``capacity =
batch * (phases + 1)``.  It prints per-shard load, throughput and -- in
durable mode -- pwb/op and pfence/op, the paper's Figure-3 metric.

``--mixed`` runs a heterogeneous fabric (kinds round-robin over the shards
in sorted order: deque, map, queue, stack).  ``--durable`` drives the
durable path as the reference does: with ``--threads 1`` thread 0
announces each phase's batch, then ``combine_phase`` and ``flush``; with
``--threads T > 1`` the batch is sliced over T announcing threads and the
seeded ``MultiThreadDriver(rt, seed=1)`` interleaves their announcements
with combining phases.  ``--depth D`` pipelines the durable path D chains
deep (chains of T batches when D > 1).  ``--split-backlog N`` builds the
fabric with four buckets per shard and, after each phase, splits the hottest
shard (crash-consistently, ``split_shard``) once its ``ops_combined`` leads
the mean by more than N.  ``--device`` picks the device (default ``cuda``).

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_shards [--kind queue |
      --mixed] [--shards 16] [--skew 1.1] [--phases 50] [--batch 256]
      [--durable] [--threads 4] [--depth 3] [--split-backlog N] [--device cuda]
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.dfc_checkpoint import SimFS
from repro_torch.core.torch_dfc import STRUCTS
from repro_torch.obs import durable_digest
from repro_torch.runtime.announce_driver import MultiThreadDriver
from repro_torch.runtime.dfc_shard import R_OVERFLOW, ShardedDFCRuntime, zipf_keys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", default="queue", choices=sorted(STRUCTS))
    ap.add_argument("--mixed", action="store_true",
                    help="heterogeneous fabric: kinds round-robin per shard")
    ap.add_argument("--shards", type=int, default=16)
    ap.add_argument("--skew", type=float, default=1.1)
    ap.add_argument("--phases", type=int, default=50)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--durable", action="store_true")
    ap.add_argument("--threads", type=int, default=1,
                    help="announcing threads per durable phase (seeded "
                         "interleaved scheduler when > 1)")
    ap.add_argument("--depth", type=int, default=0,
                    help="durable pipeline depth (0 or 1 = serial)")
    ap.add_argument("--split-backlog", type=int, default=0,
                    help="split the hottest shard once it leads the mean "
                         "op count by N (0 = never)")
    ap.add_argument("--device", default="cuda")
    return ap


PhaseHook = Callable[..., None]


def serve(args: argparse.Namespace, hook: Optional[PhaseHook] = None,
          obs=None) -> Dict[str, Any]:
    """Drive the fabric for ``args.phases`` phases and print the report.

    ``hook(phase=, rt=, keys=, ops=, params=, resp=, kinds=)`` runs after
    each phase, outside the timed region and before the phase's split
    check.  ``obs`` is a fabric observer (a ``FabricObserver``) handed to
    the runtime.  Returns the run's counts: ``n_ops``, ``n_overflow``,
    ``seconds`` and ``phase_seconds`` (serving time, a split included, hooks
    excluded), ``splits`` (``(phase, donor, new shard)``), ``pwb`` /
    ``pfence`` / ``pstats``, ``retire_wait_s`` and the durable root's
    ``digest`` (durable mode) and the runtime ``rt``.
    """
    rng = np.random.default_rng(0)
    all_kinds = sorted(STRUCTS)
    kinds = (
        [all_kinds[s % len(all_kinds)] for s in range(args.shards)]
        if args.mixed else args.kind
    )
    lanes = args.batch  # worst case: every op on one shard
    capacity = args.batch * (args.phases + 1)

    with tempfile.TemporaryDirectory(prefix="dfc_serve_") as root:
        fs = SimFS(Path(root)) if args.durable else None
        rt = ShardedDFCRuntime(
            kinds, args.shards, capacity, lanes, fs=fs, n_threads=args.threads,
            n_buckets=4 * args.shards if args.split_backlog else None,
            depth=args.depth or None, chain=args.threads if args.depth > 1 else 1,
            device=args.device, obs=obs,
        )
        drv = MultiThreadDriver(rt, seed=1) if args.durable and args.threads > 1 else None
        on_card = rt.device.type == "cuda"
        n_ops = n_overflow = 0
        shard_hits = np.zeros(args.shards, np.int64)
        phase_seconds, splits = [], []
        for phase in range(args.phases):
            keys = zipf_keys(rng, args.batch, 4096, args.skew)
            shard = rt.route_host(keys)
            opmax = np.asarray([STRUCTS[k].n_opcodes for k in rt.kinds])
            ops = rng.integers(1, opmax[shard])  # per-key draw valid for its kind
            params = rng.random(args.batch).astype(np.float32) * 100
            t0 = time.perf_counter()
            if args.durable:
                if drv is not None:
                    # slice the phase's batch over the announcing threads; the
                    # seeded driver interleaves announce/combine actions
                    per = (args.batch + args.threads - 1) // args.threads
                    toks = []
                    for t in range(args.threads):
                        sl = slice(t * per, min((t + 1) * per, args.batch))
                        if sl.start >= sl.stop:
                            break
                        toks.append((t, drv.submit(t, keys[sl], ops[sl], params[sl])))
                    drv.run()
                else:
                    rt.announce(0, keys, ops, params, token=phase + 1)
                    rt.combine_phase()
                    rt.flush()
                    toks = [(0, phase + 1)]
                recs = [rt.read_responses(t, token=tok) for t, tok in toks]
                resp = np.concatenate([np.asarray(r["resp"], np.float32) for r in recs])
                kinds_out = np.concatenate([np.asarray(r["kinds"]) for r in recs])
            else:
                resp, kinds_dev = rt.step(keys, ops, params)
                kinds_out = kinds_dev.cpu().numpy()
            if on_card:
                torch.cuda.synchronize(rt.device)
            phase_seconds.append(time.perf_counter() - t0)
            n_ops += int(np.sum(kinds_out != R_OVERFLOW))
            n_overflow += int(np.sum(kinds_out == R_OVERFLOW))
            shard_hits = _grown(shard_hits, rt.n_shards)
            shard_hits[: shard.max() + 1] += np.bincount(shard, minlength=shard.max() + 1)
            if hook is not None:
                hook(phase=phase, rt=rt, keys=keys, ops=ops, params=params,
                     resp=resp, kinds=kinds_out)
            if args.split_backlog:
                t0 = time.perf_counter()
                ops_comb = rt.meta["ops_combined"].cpu().numpy()
                hot = int(np.argmax(ops_comb))
                if ops_comb[hot] - ops_comb.mean() > args.split_backlog:
                    try:
                        splits.append((phase, hot, rt.split_shard(hot)))
                    except ValueError:
                        pass  # the shard is down to one bucket
                if on_card:
                    torch.cuda.synchronize(rt.device)
                phase_seconds[-1] += time.perf_counter() - t0
        shard_hits = _grown(shard_hits, rt.n_shards)  # a last-phase split

        seconds = sum(phase_seconds)
        label = "mixed" if args.mixed else args.kind
        print(f"kind={label} shards={rt.n_shards} skew={args.skew} device={rt.device}")
        print(f"throughput: {n_ops / seconds:,.0f} ops/s  "
              f"({args.phases} phases, {seconds:.2f}s)")
        print(f"overflow:   {n_overflow} ops rejected (re-announce to retry)")
        hot = ", ".join(f"s{s}({rt.kinds[s][0]}):{h}" for s, h in enumerate(shard_hits))
        print(f"shard load: {hot}")
        touched = rt.meta["phases"].cpu().numpy()
        print(f"phases/shard: min={touched.min()} max={touched.max()}")
        for phase, donor, new_id in splits:
            print(f"split: phase {phase}: shard {donor} -> +shard {new_id}")
        out = {"n_ops": n_ops, "n_overflow": n_overflow, "seconds": seconds,
               "phase_seconds": phase_seconds, "phases": args.phases, "splits": splits,
               "rt": rt}
        if args.durable:
            print(f"pwb/op: {fs.stats['pwb'] / max(n_ops, 1):.3f}  "
                  f"pfence/op: {fs.stats['pfence'] / max(n_ops, 1):.3f}")
            out.update(pwb=fs.stats["pwb"], pfence=fs.stats["pfence"],
                       pstats=fs.pstats.as_dict(), retire_wait_s=rt.retire_wait_s,
                       digest=durable_digest(root))
    return out


def _grown(hits: np.ndarray, n_shards: int) -> np.ndarray:
    """Per-shard hit counts widened to the fabric's shard count (a split
    adds shards)."""
    if hits.shape[0] < n_shards:
        hits = np.concatenate([hits, np.zeros(n_shards - hits.shape[0], np.int64)])
    return hits


def main(argv=None) -> int:
    serve(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
