"""Fault-tolerant training runtime wired to DFC-Checkpoint (counterpart of
the JAX package's ``runtime/train_loop.py``).

The loop is the end-to-end use of the paper's protocol: every ``ckpt_every``
steps each worker ANNOUNCES (step, data cursor); the coordinator COMBINES
all ready announcements into one slot persist with the two-increment epoch
commit; on restart, RECOVER() gives a detectability report that says which
step committed, and training resumes from that step with the data cursor
of the committed manifest: exactly-once step semantics end to end.

One process here (the simulated cluster announces N worker records).  The
step runs eagerly on ``device`` (the card unless the caller asks for the
CPU), through the model's kernels and their backward kernels
(``backend="kernel"``), each step writing the new parameters and
AdamW moments over the old ones (``make_train_step(donate=True)``): the
same bits as the reference's pure step, with one copy of the state on the
card.  The combined leaves are ``(params, opt)`` in the
reference's order; ``boot`` reads them back with each leaf's shape and
dtype on the runtime's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List

import torch

from repro_torch.checkpoint.dfc_checkpoint import DFCCheckpointManager, SimFS, leaf_tensor
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.runtime.dfc_shard import resolve_device
from repro_torch.tree import tree_flatten, tree_unflatten


@dataclasses.dataclass
class TrainRuntime:
    cfg: ModelConfig
    opt_cfg: AdamWConfig
    pipeline: DataPipeline
    fs: SimFS
    n_workers: int = 4
    ckpt_every: int = 5
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.mgr = DFCCheckpointManager(self.fs, self.n_workers)
        # the loop owns its state, so each step writes the new one over it
        self._step_fn = make_train_step(self.cfg, self.opt_cfg, donate=True)
        self.step_s: List[float] = []  # host seconds of each step of the last train()
        self.last_boot = None  # (step, cursor, report) of the last boot()

    # ------------------------------------------------------------------ step
    def _fresh_state(self):
        params = init_params(self.cfg, seed=0, device=self.device)
        return params, init_opt_state(params, self.opt_cfg)

    def _batch(self, cursor: int):
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.pipeline.batch_at(cursor).items()}

    # ------------------------------------------------------------------ boot
    def boot(self):
        """Start or resume: returns (params, opt, step, cursor, report), and
        keeps (step, cursor, report) in ``last_boot``.  The committed leaves
        are the ones recovery reads (the active slot, which a recovery
        without a state getter leaves as it is), read once."""
        params, opt = self._fresh_state()
        leaves, report = self.mgr.recover()
        man = self.mgr.active_manifest()
        if leaves is None:
            self.last_boot = (0, 0, report)
            return params, opt, 0, 0, report
        template = tree_flatten((params, opt))
        if len(leaves) != len(template):
            raise ValueError(f"checkpoint holds {len(leaves)} leaves, the state {len(template)}")
        tensors = []
        for arr, entry, like in zip(leaves, man["leaves"], template):
            t = leaf_tensor(arr, entry["dtype"], self.device)
            if t.shape != like.shape or t.dtype != like.dtype:
                raise ValueError(f"{entry['file']}: {tuple(t.shape)} {t.dtype}, the state "
                                 f"holds {tuple(like.shape)} {like.dtype}")
            tensors.append(t)
        params, opt = tree_unflatten((params, opt), tensors)
        self.last_boot = (man["meta"]["step"], man["meta"]["cursor"], report)
        return params, opt, man["meta"]["step"], man["meta"]["cursor"], report

    # ------------------------------------------------------------------ train
    def train(self, n_steps: int, resume: bool = True):
        """Run to n_steps total (resuming from the committed checkpoint)."""
        params, opt, step, cursor, report = self.boot()
        losses = []
        self.step_s = []
        while step < n_steps:
            t0 = time.perf_counter()
            params, opt, metrics = self._step_fn(params, opt, self._batch(cursor))
            losses.append(float(metrics["loss"]))  # waits for the step
            self.step_s.append(time.perf_counter() - t0)
            step += 1
            cursor += 1
            if step % self.ckpt_every == 0 or step == n_steps:
                # all workers announce this step (data-parallel lockstep);
                # worker 0 is the combiner
                for w in range(self.n_workers):
                    self.mgr.announce(w, {"step": step, "cursor": cursor})
                self.mgr.combine((params, opt), extra_meta={"step": step, "cursor": cursor})
        return params, opt, losses
