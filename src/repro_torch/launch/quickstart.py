"""Quickstart: the DFC persistent stack, three ways (the port's counterpart
of the JAX package's ``examples/quickstart.py``, printing the same lines).

1. Paper-faithful simulation (Algorithms 1-2) with persistence counters and
   an injected crash + detectable recovery (host code, no device).
2. The vectorized combine, one combining phase of one stack through the
   one-object step ``dfc_combine_step(..., backend="kernel")``: on the card,
   one launch of the stack's combine kernel; on the CPU, its plain version.
3. DFC-Checkpoint: the same protocol persisting a training state.

Run:  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
      (the default device is ``cuda``)
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.checkpoint.dfc_checkpoint import DFCCheckpointManager, SimFS
from repro_torch.core.dfc import POP, PUSH, DFCStack
from repro_torch.core.harness import check_durable_linearizability, run_with_crash
from repro_torch.core.sim import History, Scheduler, workload_gen
from repro_torch.core.torch_dfc import OP_POP, OP_PUSH, init_stack
from repro_torch.kernels.dfc_reduce.ops import dfc_combine_step
from repro_torch.nvm.memory import CrashMode, NVMemory
from repro_torch.runtime.dfc_shard import resolve_device

# part 2's one combining phase: three pushes and three pops
COMBINE_OPS = [OP_PUSH, OP_PUSH, OP_POP, OP_PUSH, OP_POP, OP_POP]
COMBINE_PARAMS = [1.0, 2.0, 0, 3.0, 0, 0]


def faithful() -> None:
    print("== 1. paper-faithful DFC stack ==")
    mem = NVMemory()
    stack = DFCStack(mem, n_threads=4)
    sched = Scheduler(seed=0)
    hist = History()
    workloads = [
        [(PUSH, 10 + t), (POP, None)] if t % 2 == 0 else [(POP, None), (PUSH, 90 + t)]
        for t in range(4)
    ]
    gens = {t: workload_gen(stack, sched, hist, t, workloads[t]) for t in range(4)}
    sched.run(gens)
    print(f"   ops: {[(o['name'], o['param'], o['value']) for o in hist.ops]}")
    print(f"   combining phases: {stack.phases}, eliminated pairs: {stack.eliminated_pairs}")
    print(f"   pwb: {dict(mem.stats.pwb)}  pfence: {dict(mem.stats.pfence)}")

    print("   crash injection at step 25 + recovery ...")
    res = run_with_crash(workloads, crash_at=25, seed=0, mode=CrashMode.RANDOM)
    ok = check_durable_linearizability(res)
    print(f"   durable-linearizable after recovery: {ok}; took-effect: {res.took_effect}")


def vectorized(device) -> Dict[str, Any]:
    """One combining phase of a 64-slot stack on ``device``; returns the
    inputs, the new state, the responses and the response kinds."""
    print("== 2. CUDA-native vectorized combine ==")
    state = init_stack(capacity=64, device=device)
    ops = torch.tensor(COMBINE_OPS, dtype=torch.int32, device=device)
    params = torch.tensor(COMBINE_PARAMS, dtype=torch.float32, device=device)
    state, resp, kinds = dfc_combine_step(state, ops, params, backend="kernel")
    print(f"   responses: {resp.cpu().numpy()} kinds: {kinds.cpu().numpy()}")
    size = int(state.active_size())
    print(f"   stack after phase: {state.values[:size].cpu().numpy()}")
    return {"ops": ops, "params": params, "state": state, "resp": resp, "kinds": kinds}


def checkpointing() -> None:
    print("== 3. DFC-Checkpoint ==")
    with tempfile.TemporaryDirectory() as d:
        fs = SimFS(Path(d))
        mgr = DFCCheckpointManager(fs, n_workers=4)
        for w in range(4):
            mgr.announce(w, {"step": 1, "cursor": 1})
        mgr.combine([np.eye(3, dtype=np.float32)], {"step": 1, "cursor": 1})
        leaves, man = mgr.load_active()
        print(f"   committed step {man['meta']['step']}; pwb={fs.stats['pwb']} "
              f"pfence={fs.stats['pfence']} (4 workers -> 1 slot persist)")
        _, report = DFCCheckpointManager(fs.crash(), 4).recover()
        print(f"   detectability report: {report}")


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    faithful()
    out = vectorized(device)
    checkpointing()
    print("done.")
    return out


if __name__ == "__main__":
    main()
