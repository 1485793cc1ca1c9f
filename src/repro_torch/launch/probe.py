"""Per-body cost probes (counterpart of the JAX package's
``launch/probe.py``).

The reference compiles each distinct block body alone because XLA's cost
analysis counts a scan's body once whatever its trip count.  The port runs
eagerly, so its dry run (``launch/dryrun.py``) already counts every layer;
the probes break a step down: each distinct body (``self_block``,
``mamba1_layer``, ``mamba2_layer``, ``shared_attn``, ``cross_block``) runs
alone on ``meta`` tensors under the dry run's counters with its trip count,
forward and, for training, under ``_remat`` its backward (the recompute
included), with the parameter gradients the step takes.  Prefill and decode
bodies carry their KV / SSM cache slices, as the reference's do.  The rest
of the step (embedding, head, loss, optimizer) is the same step with no
layers, so

    flops = sum over bodies of trips x (fwd + bwd) + rest

is the whole step's count; :func:`probe_bodies` reports it beside each
body's FLOPs, bytes and peak live bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cross_kv
from repro_torch.tree import tree_flatten, tree_unflatten

META = torch.device("meta")


def _slice_lead(tree, n_lead: int):
    """One layer's leaves of a tree stacked over ``n_lead`` leading axes."""
    return M._map_spec(lambda t: torch.empty(t.shape[n_lead:], dtype=t.dtype, device=META),
                       tree)


def _cost(c) -> Dict[str, Any]:
    return {"flops": c["flops"], "bytes": c["bytes_accessed"], "peak_bytes": c["peak_bytes"],
            "kernels": {k: v["calls"] for k, v in c["kernels"].items()}}


class BodyProber:
    def __init__(self, cfg: ModelConfig, sh, aparams, backend: str = "kernel"):
        self.cfg = cfg
        self.sh = sh
        self.aparams = aparams
        self.kind = sh.kind
        self.b = sh.global_batch
        self.s = 1 if self.kind == "decode" else sh.seq_len
        self.length = sh.seq_len - 1 if self.kind == "decode" else 0
        self.dt = cfg.act_dtype()
        self.backend = backend

    # ---------------------------------------------------------------- pieces
    def h_spec(self):
        return torch.empty((self.b, self.s, self.cfg.d_model), dtype=self.dt, device=META)

    def positions(self):
        if self.kind == "decode":
            return torch.full((1,), self.length, dtype=torch.int64, device=META)
        return torch.arange(self.s, device=META)

    def kv_cache_piece(self):
        cfg, sh = self.cfg, self.sh
        wlen = sh.window or sh.seq_len
        shape = (self.b, wlen, cfg.n_kv_heads, cfg.hd())
        return tuple(torch.empty(shape, dtype=self.dt, device=META) for _ in range(2))

    def ssm_cache_piece(self):
        cfg = self.cfg
        di, n = cfg.d_inner(), cfg.ssm_state
        if cfg.ssm_version == 2:
            nh, hp = di // cfg.ssm_head_dim, cfg.ssm_head_dim
            sshape, conv_c = (self.b, nh, hp, n), di + 2 * n
        else:
            sshape, conv_c = (self.b, di, n), di
        return (torch.empty(sshape, dtype=torch.float32, device=META),
                torch.empty((self.b, cfg.d_conv - 1, conv_c), dtype=self.dt, device=META))

    # ----------------------------------------------------------------- probe
    def _run(self, fn, h, bp, extra=(), vjp=False):
        """``fn(h, bp, *extra)`` counted: its forward, and with ``vjp`` its
        backward to ``h`` and every leaf of ``bp`` (ones as the output's
        gradient)."""
        from repro_torch.launch.dryrun import count

        leaves = tree_flatten(bp)
        held = [h, *leaves, *extra]
        if not vjp:
            with torch.no_grad():
                return {"fwd": _cost(count(lambda: fn(h, bp, *extra), held))}
        h = h.requires_grad_(True)
        leaves = [t.requires_grad_(True) for t in leaves]
        bp = tree_unflatten(bp, leaves)
        box = {}
        out = {"fwd": _cost(count(lambda: box.setdefault("y", fn(h, bp, *extra)), held))}

        def backward():
            y = box.pop("y")
            torch.autograd.grad(y, [h, *leaves], torch.ones_like(y), allow_unused=True,
                                materialize_grads=True)

        out["bwd"] = _cost(count(backward, held))
        return out

    def _attn_body(self, bp, trips, name):
        cfg, kind = self.cfg, self.kind
        pos = self.positions()
        if kind == "train":
            def body(h, bp):
                return M._self_block(h, bp, cfg, pos, backend=self.backend)[0]

            return dict(name=name, trips=trips,
                        **self._run(M._remat(cfg, body), self.h_spec(), bp, vjp=True))
        ring = kind == "decode" and self.sh.window > 0

        def body(h, bp, k_l, v_l):
            return M._self_block(h, bp, cfg, pos, cache=(k_l, v_l, self.length),
                                 backend=self.backend,
                                 window=self.sh.window if kind == "decode" else 0,
                                 ring=ring)[0]

        return dict(name=name, trips=trips,
                    **self._run(body, self.h_spec(), bp, self.kv_cache_piece()))

    def _mamba_body(self, bp, trips, name):
        cfg, kind = self.cfg, self.kind
        if kind == "train":
            def body(h, bp):
                return M._mamba_layer(h, bp, cfg, backend=self.backend)[0]

            return dict(name=name, trips=trips,
                        **self._run(M._remat(cfg, body), self.h_spec(), bp, vjp=True))

        def body(h, bp, s_l, c_l):
            return M._mamba_cached(h, bp, cfg, s_l, c_l,
                                   (s_l, c_l) if kind == "decode" else None, self.backend)

        return dict(name=name, trips=trips,
                    **self._run(body, self.h_spec(), bp, self.ssm_cache_piece()))

    def _cross_body(self, bp, trips):
        cfg, kind = self.cfg, self.kind
        pos = self.positions()
        img = torch.empty((self.b, cfg.n_img_tokens, cfg.d_model), dtype=self.dt, device=META)
        if kind == "train":
            def body(h, bp, img):
                return M._cross_block(h, bp, cfg, pos, img, self.backend)

            return dict(name="cross_block", trips=trips,
                        **self._run(M._remat(cfg, body), self.h_spec(), bp, (img,), vjp=True))
        if kind == "prefill":
            def body(h, bp, img, ik, iv):  # the image K/V made once, cached and attended
                kv = cross_kv(img, bp["attn"], cfg)
                ik.copy_(kv[0])
                iv.copy_(kv[1])
                return M._cross_block(h, bp, cfg, pos, kv, self.backend)
        else:
            def body(h, bp, img, ik, iv):
                return M._cross_block(h, bp, cfg, pos, (ik, iv), self.backend, cached=True)
        kv_shape = (self.b, cfg.n_img_tokens, cfg.n_kv_heads, cfg.hd())
        ik, iv = (torch.empty(kv_shape, dtype=self.dt, device=META) for _ in range(2))
        return dict(name="cross_block", trips=trips,
                    **self._run(body, self.h_spec(), bp, (img, ik, iv)))

    # ------------------------------------------------------------------ main
    def probe(self) -> List[Dict[str, Any]]:
        cfg, p = self.cfg, self.aparams
        fam = cfg.family
        if fam in ("dense", "moe", "audio"):
            return [self._attn_body(_slice_lead(p["blocks"], 1), cfg.n_layers, "self_block")]
        if fam == "ssm":
            return [self._mamba_body(_slice_lead(p["blocks"], 1), cfg.n_layers, "mamba1_layer")]
        if fam == "hybrid":
            return [
                self._mamba_body(_slice_lead(p["mamba_groups"], 2), cfg.n_layers, "mamba2_layer"),
                self._attn_body(p["shared_attn"], M._hybrid_groups(cfg)[0], "shared_attn"),
            ]
        if fam == "vlm":
            g, per = M._groups(cfg)
            return [self._attn_body(_slice_lead(p["self_blocks"], 2), g * per, "self_block"),
                    self._cross_body(_slice_lead(p["cross_blocks"], 1), g)]
        raise ValueError(fam)


def probe_bodies(cfg: ModelConfig, sh, mesh: Mesh, opt_cfg=None, backend: str = "kernel"
                 ) -> Dict[str, Any]:
    """Each body's counts (:class:`BodyProber`), the rest of the step (the
    same step with no layers, ``launch/dryrun.py``'s ``measure_step``), and
    the step's FLOPs and bytes as sum(trips x body) + the rest."""
    from repro_torch.launch.dryrun import measure_step

    bodies = BodyProber(cfg, sh, M.abstract_params(cfg), backend).probe()
    rest = measure_step(dataclasses.replace(cfg, n_layers=0), sh, mesh, opt_cfg, backend)
    rest = {"flops": rest["flops"], "bytes": rest["bytes_accessed"],
            "peak_bytes": rest["memory"]["peak_bytes"]}

    def total(key):
        return sum(b["trips"] * sum(b[part][key] for part in ("fwd", "bwd") if part in b)
                   for b in bodies) + rest[key]

    return {"bodies": bodies, "rest": rest, "flops": total("flops"),
            "bytes_accessed": total("bytes")}
