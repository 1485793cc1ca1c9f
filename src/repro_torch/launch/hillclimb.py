"""Hillclimb harness: the dry run of one (arch x shape) cell under config
variants (counterpart of the JAX package's ``launch/hillclimb.py``).

Runs the dry run (``launch/dryrun.py``) and the body probes
(``launch/probe.py``) for named config overrides and prints, per variant,
the compute term (the step's FLOPs over one H100's 989e12 bf16 FLOP/s), the
memory term (its bytes accessed over 3.35e12 B/s) and the GB the step
allocates beyond its arguments.  The collective term is 0: one card.  The
eager dry run counts every layer, so the probes only break the step down.
A variant that sets only sharding levers (``SHARDING_LEVERS``, inert on one
card) prints the baseline's numbers and says so.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch deepseek-coder-33b \\
      --shape train_4k --variant baseline --variant chunked_attn ...
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch import dryrun as DR

PEAK_FLOPS = 989e12  # one H100 SXM, bf16 dense (NVIDIA's data sheet)
HBM_BW = 3.35e12  # its HBM3, bytes/s
# levers that only add the reference's sharding constraints: inert on one card
SHARDING_LEVERS = ("act_sharding", "attn_seq_shard", "moe_shard_dispatch",
                   "seq_parallel_resid")

VARIANTS = {
    "baseline": {},
    "chunked_attn": {"attn_impl": "chunked", "attn_chunk": 512},
    "chunked_attn_1k": {"attn_impl": "chunked", "attn_chunk": 1024},
    "seq_shard": {"attn_seq_shard": True},
    "seq_shard_chunked": {"attn_seq_shard": True, "attn_impl": "chunked", "attn_chunk": 512},
    "loss_chunk": {"loss_chunk": 512},
    "dots_remat": {"remat": "dots_saveable"},
    "no_remat": {"remat": "none"},
    "chunked_all": {
        "attn_impl": "chunked", "attn_chunk": 512, "attn_seq_shard": True, "loss_chunk": 512,
    },
    "seq_resid": {"attn_seq_shard": True, "seq_parallel_resid": True},
    "seq_resid_loss": {
        "attn_seq_shard": True, "seq_parallel_resid": True, "loss_chunk": 512,
    },
    "seq_resid_loss_chunked": {
        "attn_seq_shard": True, "seq_parallel_resid": True, "loss_chunk": 512,
        "attn_impl": "chunked", "attn_chunk": 1024,
    },
    "seq_resid_dots": {
        "attn_seq_shard": True, "seq_parallel_resid": True, "remat": "dots_saveable",
    },
    "seq_resid_norem": {
        "attn_seq_shard": True, "seq_parallel_resid": True, "remat": "none",
    },
    "moe_ep": {"moe_shard_dispatch": True},
    "moe_ep_seq_resid": {
        "moe_shard_dispatch": True, "attn_seq_shard": True, "seq_parallel_resid": True,
    },
    "moe_ep_seq_resid_cap1": {
        "moe_shard_dispatch": True, "attn_seq_shard": True, "seq_parallel_resid": True,
        "capacity_factor": 1.0,
    },
    "seq_resid_lc_norem": {
        "attn_seq_shard": True, "seq_parallel_resid": True, "loss_chunk": 512,
        "remat": "none",
    },
    "moe_grouped": {"moe_groups": 16},
    "moe_grouped_seq_resid": {
        "moe_groups": 16, "attn_seq_shard": True, "seq_parallel_resid": True,
    },
    "cap_tight": {"capacity_factor": 1.0},
    "cap_tight_chunked": {"capacity_factor": 1.0, "attn_impl": "chunked", "attn_chunk": 512},
}


def effective(overrides: dict) -> dict:
    """The overrides that change the step on one card (the sharding levers
    dropped)."""
    return {k: v for k, v in overrides.items() if k not in SHARDING_LEVERS}


def fmt_seconds(s: float) -> str:
    if s >= 1:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.2f}ms"
    return f"{s * 1e6:.1f}us"


def measure(arch: str, shape, overrides: dict, mesh_kind: str = "single", *,
            reduced: bool = False, backend: str = "kernel"):
    """The dry run and the body probes of one cell under ``overrides``, and
    the roofline terms of one H100."""
    mod = DR.run_cell(arch, shape, mesh_kind, overrides, reduced=reduced, backend=backend)
    bodies = DR.run_bodies(arch, shape, mesh_kind, overrides, reduced=reduced, backend=backend)
    return {
        "flops": mod["flops"],
        "bytes": mod["bytes_accessed"],
        "colls": None,
        "t_compute": mod["flops"] / PEAK_FLOPS,
        "t_memory": mod["bytes_accessed"] / HBM_BW,
        "t_collective": 0.0,
        "temp_gb": mod["memory"]["temp_bytes"] / 1e9,
        "bodies": bodies,
        "module": mod,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--out", default="experiments/hillclimb_torch")
    args = ap.parse_args(argv)
    variants = args.variant or ["baseline"]

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    print(f"{'variant':22s} {'compute':>10s} {'memory':>10s} {'collective':>11s} "
          f"{'temp GB':>8s}  (one H100: 989 TFLOP/s bf16, 3.35 TB/s; no collectives on one "
          "card)")
    done = {}  # effective overrides -> result
    for name in variants:
        ov = VARIANTS[name]
        key = json.dumps(effective(ov), sort_keys=True)
        try:
            r = done[key] if key in done else measure(args.arch, args.shape, ov)
        except Exception as e:  # noqa: BLE001
            print(f"{name:22s} FAILED: {repr(e)[:160]}")
            continue
        done[key] = r
        note = ""
        if len(effective(ov)) < len(ov):
            note = ("  (sharding levers only: inert on one card, the baseline's numbers)"
                    if not effective(ov) else "  (its sharding levers inert on one card)")
        tag = f"{args.arch}_{args.shape}_{name}"
        (outdir / f"{tag}.json").write_text(json.dumps(
            {k: v for k, v in r.items() if k != "module"} | {"module_mem": r["module"]["memory"]},
            indent=2, default=float))
        print(f"{name:22s} {fmt_seconds(r['t_compute']):>10s} {fmt_seconds(r['t_memory']):>10s} "
              f"{fmt_seconds(r['t_collective']):>11s} {r['temp_gb']:8.1f}{note}", flush=True)


if __name__ == "__main__":
    main()
