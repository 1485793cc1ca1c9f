"""Dry run: every (arch x shape x mesh) cell's step on the ``meta`` device
(counterpart of the JAX package's ``launch/dryrun.py``).

For each cell this builds the parameters (``models/model.py``
``abstract_params``), the AdamW state, the batch and the decode cache as
``meta`` tensors, which hold no storage, and runs the step of the cell's
kind (``launch/steps.py``: ``make_train_step(donate=True)``, the prefill or
the serve step) once, under ``torch.utils.flop_counter.FlopCounterMode``
and :class:`StepCost`, a dispatch mode of live bytes.  The model kernels'
wrappers take their kernels' path on ``meta`` tensors up to the launch
(``kernels/meta.py``): they allocate the kernel's outputs and scratch, not
the plain version's intermediates, and report the kernel's FLOPs and bytes.
Per cell it reports

  * ``flops``: the matrix-product FLOPs (2 a multiply-add) of aten's
    products and of the flash kernels (each query's keys up to its own
    position, the causal half; the backward 7 products a pair, as its two
    kernels do them); elementwise work (norms, softmax, the scan, the
    optimizer) counts none,
  * ``bytes_accessed``: the bytes each aten op reads and writes (views and
    allocations excluded), and each kernel's inputs and outputs once: an
    eager run's traffic, no fusion,
  * ``memory``: ``argument_bytes``, one device's share of the parameters,
    AdamW state, batch and cache under the mesh's specs
    (``launch/sharding.py``); ``argument_bytes_total``, the same unsharded;
    ``peak_bytes``, the step's peak of live bytes on one device running the
    whole step (the port has no partitioner: on the ``single`` and ``multi``
    meshes it is not a per-device peak); ``temp_bytes``, the peak less the
    unsharded arguments,
  * ``params`` / ``active_params``: the configuration's counts.

There is no collective census: the port runs on one card, and nothing here
models the reference's mesh's collectives (``collectives`` is None, and the
result says so).  The meshes: ``single`` (16 x 16) and ``multi`` (2 x 16 x
16), abstract (``launch/mesh.py``), and ``card``, one H100.  Results go to
JSON under ``experiments/dryrun_torch/`` (``--tuned``:
``experiments/dryrun_torch_tuned/``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k --mesh card
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.configs.shapes import SHAPES, input_specs, supports
from repro_torch.kernels import meta
from repro_torch.launch.mesh import Mesh, make_card_mesh, make_production_mesh
from repro_torch.launch.sharding import (
    batch_pspecs,
    cache_pspecs,
    opt_pspecs,
    param_pspecs,
    sharded_bytes,
)
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import abstract_params
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.tree import tree_flatten

NO_COLLECTIVES = ("none counted: the port runs on one card, and the dry run does not model "
                  "the collectives of the reference's mesh")
# ops that move no data: allocations (their first writer is counted)
_ALLOCS = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
           torch.ops.aten.empty_strided.default, torch.ops.aten.new_empty.default,
           torch.ops.aten.new_empty_strided.default}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class StepCost(TorchDispatchMode):
    """Live bytes and traffic of the tensors the ops under it make: each
    output's storage is counted once while it lives (a weak reference tells
    when it dies), ``peak`` is the most live at once, ``bytes`` the bytes
    each op reads and writes (views and allocations excluded).  Tensors made
    before the mode are counted by :meth:`hold`."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.bytes = 0
        self.ops = 0
        self._held = WeakIdKeyDictionary()

    def _free(self, n):
        self.live -= n

    def hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._held:
            return
        n = st.nbytes()
        self._held[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self.hold(t)
        self.ops += 1
        if not func.is_view and func not in _ALLOCS:
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        return out


def count(fn, held=()):
    """Run ``fn`` (on ``meta`` tensors) under the counters; ``held`` the
    tensors alive before it (its arguments).  Returns its FLOPs, bytes
    accessed, peak live bytes, the kernels' calls and the host seconds."""
    kernels = {}

    def sink(name, flops, nbytes):
        k = kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    tracker = StepCost()
    for t in held:
        tracker.hold(t)
    flop_mode = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with meta.account(sink), flop_mode, tracker:
        fn()
    seconds = time.perf_counter() - t0
    return {
        "flops": flop_mode.get_total_flops() + sum(k["flops"] for k in kernels.values()),
        "bytes_accessed": tracker.bytes + sum(k["bytes"] for k in kernels.values()),
        "peak_bytes": tracker.peak,
        "kernels": kernels,
        "ops": tracker.ops,
        "seconds": seconds,
    }


def make_mesh(mesh_kind: str) -> Mesh:
    if mesh_kind == "card":
        return make_card_mesh()
    return make_production_mesh(multi_pod=mesh_kind == "multi")


def opt_config(arch: str) -> AdamWConfig:
    """The reference's AdamW for the arch: bf16 moments for arctic-480b."""
    return AdamWConfig(state_dtype="bfloat16") if arch == "arctic-480b" else AdamWConfig()


def step_inputs(cfg: ModelConfig, sh, opt_cfg: AdamWConfig, backend: str = "kernel"):
    """The step of ``sh``'s kind and its ``meta`` arguments: (a function of
    no arguments running the step, {part: tree} of the arguments).  A
    decode cache is full to its last position.  ``backend="ref"`` runs the
    kernels' plain versions."""
    specs = input_specs(cfg, sh)
    params = abstract_params(cfg)
    parts = {"params": params, "batch": specs["batch"]}
    if sh.kind == "train":
        parts["opt"] = opt = init_opt_state(params, opt_cfg)
        step = make_train_step(cfg, opt_cfg, backend, donate=True)
        return (lambda: step(params, opt, specs["batch"])), parts
    if sh.kind == "prefill":
        step = make_prefill_step(cfg, max_len=sh.seq_len, backend=backend)
        return (lambda: step(params, specs["batch"])), parts
    parts["cache"] = cache = dict(specs["cache"], len=sh.seq_len - 1)
    step = make_serve_step(cfg, backend, window=sh.window)
    return (lambda: step(params, cache, specs["batch"])), parts


def part_specs(parts, cfg: ModelConfig, mesh: Mesh, batch_size: int):
    pspec = param_pspecs(parts["params"], cfg, mesh)
    out = {"params": pspec, "batch": batch_pspecs(parts["batch"], mesh)}
    if "opt" in parts:
        out["opt"] = opt_pspecs(parts["opt"], pspec)
    if "cache" in parts:
        out["cache"] = cache_pspecs(parts["cache"], cfg, mesh, batch_size)
    return out


def measure_step(cfg: ModelConfig, sh, mesh: Mesh, opt_cfg: AdamWConfig | None = None,
                 backend: str = "kernel"):
    """One step of ``cfg`` at shape ``sh`` (a ``ShapeCfg``) on ``meta``,
    counted (:func:`count`), with the arguments' bytes under ``mesh``."""
    opt_cfg = opt_cfg or AdamWConfig()
    fn, parts = step_inputs(cfg, sh, opt_cfg, backend)
    specs = part_specs(parts, cfg, mesh, sh.global_batch)
    held = [t for t in tree_flatten(parts) if isinstance(t, torch.Tensor)]
    total = sum(_nbytes(t) for t in held)
    cost = count(fn, held)
    return {
        "n_devices": mesh.size,
        "seconds": round(cost["seconds"], 2),
        "flops": cost["flops"],
        "bytes_accessed": cost["bytes_accessed"],
        "kernels": cost["kernels"],
        "aten_ops": cost["ops"],
        "memory": {
            "argument_bytes": sum(sharded_bytes(parts[k], specs[k], mesh) for k in parts),
            "argument_bytes_total": total,
            "peak_bytes": cost["peak_bytes"],
            "temp_bytes": cost["peak_bytes"] - total,
        },
        "collectives": None,
        "collectives_note": NO_COLLECTIVES,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }


def cell_config(arch: str, mesh_kind: str, cfg_overrides=None, reduced: bool = False):
    """The cell's configuration: the arch's (or its reduced one), with the
    reference's activation-sharding anchor for the mesh (inert here) and
    ``cfg_overrides``."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    act_axes = ("pod", "data") if mesh_kind == "multi" else ("data",)
    return dataclasses.replace(cfg, act_sharding=act_axes, **(cfg_overrides or {}))


def run_cell(arch: str, shape, mesh_kind: str, cfg_overrides=None, *, reduced: bool = False,
             backend: str = "kernel"):
    """The dry run of one cell: ``shape`` a name of ``SHAPES`` or a
    ``ShapeCfg``; ``reduced`` the arch's reduced configuration (tests)."""
    cfg = cell_config(arch, mesh_kind, cfg_overrides, reduced)
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    res = measure_step(cfg, sh, make_mesh(mesh_kind), opt_config(arch), backend)
    return {"arch": arch, "shape": sh.name, "mesh": mesh_kind, **res}


def run_bodies(arch: str, shape, mesh_kind: str, cfg_overrides=None, *,
               reduced: bool = False, backend: str = "kernel"):
    """Per-body probes and the rest of the step (``launch/probe.py``): each
    body's FLOPs and bytes, and the total as sum(trips x body) + the rest."""
    from repro_torch.launch.probe import probe_bodies

    cfg = cell_config(arch, mesh_kind, cfg_overrides, reduced)
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    return probe_bodies(cfg, sh, make_mesh(mesh_kind), opt_config(arch), backend)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both", "card"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--bodies", action="store_true",
                    help="run per-body probes instead of full modules")
    ap.add_argument("--tuned", action="store_true", help="apply launch.tuned perf levers")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    if args.tuned and args.out == "experiments/dryrun_torch":
        args.out = "experiments/dryrun_torch_tuned"

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            if not supports(arch, shape):
                print(f"SKIP  {arch} x {shape} (documented: full attention at 500k)")
                continue
            for mesh_kind in meshes:
                tag = f"{arch}_{shape}_{mesh_kind}"
                path = outdir / (f"{tag}.bodies.json" if args.bodies else f"{tag}.json")
                if path.exists():
                    print(f"CACHED {tag}")
                    continue
                print(f"RUN   {tag} ...", flush=True)
                overrides = None
                if args.tuned:
                    from repro_torch.launch.tuned import TUNED

                    overrides = TUNED.get(arch, {})
                try:
                    if args.bodies:
                        res = run_bodies(arch, shape, mesh_kind, overrides)
                        path.write_text(json.dumps(res, indent=2))
                        print(f"  ok (bodies): flops {res['flops']:.3e} = sum(trips x body) "
                              f"+ rest {res['rest']['flops']:.3e}", flush=True)
                        continue
                    res = run_cell(arch, shape, mesh_kind, cfg_overrides=overrides)
                except Exception as e:  # noqa: BLE001 - report and continue
                    failures.append((tag, repr(e)[:300]))
                    print(f"  FAIL {tag}: {repr(e)[:300]}", flush=True)
                    continue
                path.write_text(json.dumps(res, indent=2))
                mem = res["memory"]
                print(f"  ok: {res['seconds']} s, flops {res['flops']:.3e}, bytes "
                      f"{res['bytes_accessed']:.3e}, argument bytes/device "
                      f"{mem['argument_bytes'] / 2**30:.2f} GiB, peak (one device, whole "
                      f"step) {mem['peak_bytes'] / 2**30:.2f} GiB; collectives: "
                      f"{res['collectives_note']}", flush=True)
    if failures:
        print("\nFAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err}")
        raise SystemExit(1)
    print("\nall dry-run cells passed")


if __name__ == "__main__":
    main()
