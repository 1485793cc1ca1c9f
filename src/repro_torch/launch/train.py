"""Training launcher (counterpart of the JAX package's ``launch/train.py``).

Selects an architecture (``--arch``), builds the model and AdamW state on
``--device`` (the card by default), and runs the fault-tolerant training
loop with DFC-Checkpoint (``runtime/train_loop.py``), through the model's
kernels and their backward kernels.  The audio and vlm archs are refused,
as the reference's launcher refuses them; every other family trains on
either device, at any attention head dim up to 128 (the flash kernels pad
one without an instance of its own).  One 80 GB card holds a state of bf16
weights and grads and f32 AdamW moments, 12 bytes a parameter, up to a few
billion parameters, beside the step's activations: smollm-135m, qwen2-1.5b
(with ``loss_chunk`` 512 at 8 x 2,048) and olmo-1b train whole;
deepseek-coder-33b to about 8 of its 62 layers (the dry run,
``launch/dryrun.py``, puts 8 at 60.79 GiB at 8 x 2,048 and 12 at 88.6);
dbrx-132b trains one of its 40 layers at full width (4.49 B parameters with
its embedding and head, about 54 GB); arctic-480b trains no full-width
layer (one layer and its embedding and head are 14.07 B parameters, about
169 GB); the full falcon-mamba-7b (7.27 B, about 87 GB) does not fit.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --steps 50 --ckpt-dir /tmp/dfc_ckpt --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile
from pathlib import Path

from repro_torch.checkpoint.dfc_checkpoint import SimFS
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.tuned import apply_tuning
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train_loop import TrainRuntime


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", help="CPU-sized smoke config")
    ap.add_argument("--tuned", action="store_true", default=True)
    ap.add_argument("--no-tuned", dest="tuned", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "dfc_ckpt"))
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build(args, cfg=None):
    """The configuration (``cfg`` in place of ``--arch``'s), the durable
    store and the runtime the flags describe; raises ``SystemExit`` for an
    arch the launcher refuses."""
    if cfg is None:
        cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
        if args.tuned:
            cfg = apply_tuning(cfg)
    if cfg.family in ("vlm", "audio"):
        raise SystemExit(f"{args.arch}: frontend-stub arch — drive via examples/ or dryrun")
    pipe = DataPipeline(vocab=cfg.vocab, batch_size=args.batch, seq_len=args.seq)
    fs = SimFS(Path(args.ckpt_dir))
    rt = TrainRuntime(cfg, AdamWConfig(), pipe, fs, n_workers=args.workers,
                      ckpt_every=args.ckpt_every, device=args.device)
    return cfg, fs, rt


def main(argv=None):
    args = parse_args(argv)
    _, fs, rt = build(args)
    params, opt, step, cursor, report = rt.boot()
    if step:
        print(f"resuming from committed step {step} (detectability: {report})")
    params, opt, losses = rt.train(args.steps)
    print(f"trained to step {args.steps}: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"persistence: {fs.stats}")


if __name__ == "__main__":
    main()
