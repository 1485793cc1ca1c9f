"""Model configuration (counterpart of the JAX package's ``models/config.py``).

Every field of the reference's ``ModelConfig``, in its order and with its
defaults, so a copied configuration reads the same in both packages.  The
fields that change the math: the architecture's own, ``moe_groups`` (the
reference calls it a dispatch layout, but its grouped dispatch gives each
group its own expert capacity, so it changes which assignments are
dropped), ``capacity_factor``, ``attn_impl`` / ``attn_chunk``
(``"chunked"``: the no-cache attention as an online softmax over key
chunks, ``kernels/flash_attention/ops.py::chunked_attention``) and
``loss_chunk`` (the head and cross-entropy per sequence chunk).  ``remat``
(``"none"``, ``"nothing_saveable"`` or ``"dots_saveable"``) chooses what a
block keeps for its backward (``models/model.py`` ``_remat``) and changes no
bit.

The reference's sharding levers, ``act_sharding``, ``attn_seq_shard``,
``moe_shard_dispatch`` and ``seq_parallel_resid``, only add sharding
constraints over a device mesh, and only when ``act_sharding`` is set.  The
port runs on one card and has no partitioner: it accepts them and they are
inert.  ``scan_layers`` and ``logits_chunk`` are read nowhere in the
reference; the port carries them the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # dense-transformer details
    qkv_bias: bool = False  # qwen2
    norm: str = "rmsnorm"  # rmsnorm | layernorm_np (olmo non-parametric)
    mlp: str = "swiglu"  # swiglu | gelu (musicgen)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25

    # SSM (mamba)
    ssm_version: int = 0  # 0 = none, 1 = mamba1, 2 = mamba2
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_head_dim: int = 64  # mamba2
    dt_rank: int = 0  # mamba1; 0 => ceil(d_model/16)

    # hybrid (zamba2): shared attention block every `attn_every` mamba layers
    attn_every: int = 0

    # vlm: cross-attention every k layers against n_img_tokens stub embeddings
    cross_attn_every: int = 0
    n_img_tokens: int = 1024

    # audio: inputs are precomputed frame embeddings instead of token ids
    embedding_inputs: bool = False

    # numerics / scheduling
    dtype: str = "bfloat16"
    remat: str = "nothing_saveable"  # none | nothing_saveable | dots_saveable
    scan_layers: bool = True  # read nowhere, as in the reference
    logits_chunk: int = 0  # read nowhere, as in the reference
    # the reference's activation sharding anchor (the batch-parallel mesh
    # axes, set by its launchers); inert on one card
    act_sharding: Tuple[str, ...] = ()
    # ---- perf levers (the reference's hillclimb, launch/hillclimb.py) ----
    attn_impl: str = "naive"  # naive | chunked (online softmax over key chunks)
    attn_chunk: int = 512  # key-chunk size of the chunked attention
    attn_seq_shard: bool = False  # context-parallel attention: inert on one card
    loss_chunk: int = 0  # sequence-chunked CE loss (0 = off): the head and CE per chunk
    moe_shard_dispatch: bool = False  # expert-parallel anchor: inert on one card
    moe_groups: int = 0  # grouped dispatch: G groups of tokens, each with its
    # own per-expert capacity (so it decides the drops); 0 = flat dispatch
    seq_parallel_resid: bool = False  # sequence-parallel residual: inert on one card

    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def d_inner(self) -> int:
        return self.expand * self.d_model

    def dtr(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    def act_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}[self.dtype]

    # ------------------------------------------------------------ accounting
    def param_count(self) -> int:
        """Analytic parameter count, as the reference counts it."""
        d, v = self.d_model, self.vocab
        total = v * d  # embedding
        if not self.tie_embeddings and not self.embedding_inputs:
            total += d * v  # lm head
        elif self.embedding_inputs:
            total += d * v
        total += d  # final norm
        per_layer = 0
        hd = self.hd()
        if self.family in ("dense", "moe", "vlm", "audio"):
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
            per_layer += attn + 2 * d  # norms
            if self.family == "moe":
                per_layer += d * self.n_experts  # router
                per_layer += self.n_experts * 3 * d * self.moe_dff
                if self.dense_residual:
                    per_layer += 3 * d * self.d_ff
            else:
                n_mats = 3 if self.mlp == "swiglu" else 2
                per_layer += n_mats * d * self.d_ff
            total += self.n_layers * per_layer
            if self.family == "vlm" and self.cross_attn_every:
                n_cross = self.n_layers // self.cross_attn_every
                cross = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d + 2 * d
                total += n_cross * cross
        elif self.family in ("ssm", "hybrid"):
            di = self.d_inner()
            if self.ssm_version == 1:
                m = d * 2 * di  # in_proj
                m += di * self.d_conv  # depthwise conv
                m += di * (self.dtr() + 2 * self.ssm_state)  # x_proj
                m += self.dtr() * di + di  # dt_proj
                m += di * self.ssm_state + di  # A_log, D skip
                m += di * d  # out_proj
                m += d  # norm
            else:  # mamba2
                nh = di // self.ssm_head_dim
                m = d * (2 * di + 2 * self.ssm_state + nh)  # fused in_proj
                m += (di + 2 * self.ssm_state) * self.d_conv
                m += nh * 2  # A_log, D per head
                m += di  # gated rmsnorm scale
                m += di * d  # out_proj
                m += d
            total += self.n_layers * m
            if self.family == "hybrid" and self.attn_every:
                shared = (
                    d * (self.n_heads * hd)
                    + 2 * d * (self.n_kv_heads * hd)
                    + (self.n_heads * hd) * d
                    + 3 * d * self.d_ff
                    + 2 * d
                )
                total += shared
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts + shared)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        inactive = self.n_layers * (self.n_experts - self.top_k) * 3 * d * self.moe_dff
        return int(self.param_count() - inactive)
