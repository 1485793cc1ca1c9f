"""The model, for the ``dense``, ``moe``, ``audio``, ``vlm`` and ``ssm``
families (counterpart of the JAX package's ``models/model.py``).

  dense / audio : L identical pre-norm blocks (attention + MLP); audio reads
                  precomputed frame embeddings instead of token ids
  moe           : L identical pre-norm blocks (attention + the MoE FFN of
                  ``models/moe.py``, arctic's dense residual beside it)
  vlm           : G = L // cross_attn_every groups of (cross_attn_every - 1)
                  self blocks and one tanh-gated cross-attention block over
                  precomputed image embeddings (llama-3.2-vision)
  ssm           : L mamba1 blocks

Parameters keep the reference's names, shapes and dtypes: a nested dict of
tensors whose per-layer leaves are stacked along a leading layer axis.  The
reference's scan over that axis is a Python loop here, each layer reading
views ``leaf[i]``.  Entry points:

  forward(params, cfg, batch)                 -> (logits, aux)
  init_cache(cfg, batch, max_len)             -> cache dict
  prefill(params, cfg, batch, max_len)        -> (last_logits, cache)
  decode_step(params, cfg, cache, batch)      -> (logits, cache)

``backend="kernel"`` (the default) runs RMSNorm, prefill attention and the
selective scan through the hand-written kernels (their plain versions for
CPU tensors); ``backend="ref"`` runs the plain versions wherever the tensors
lie, for a replay on the card.  Caches are updated in place.  ``forward``'s
aux is the MoE load-balance loss summed over the layers (zero for the other
families).  The hybrid family raises ``NotImplementedError`` naming its
slice; the reference's rolling-window decode (``window``) waits for the
long-context slice.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_norm,
    apply_rope,
    attention_block,
    cross_kv,
    gqa_attention,
    mlp_block,
    rope_freqs,
)
from repro_torch.models.mamba import mamba1_block
from repro_torch.models.moe import moe_ffn
from repro_torch.runtime.dfc_shard import resolve_device

Params = Dict[str, Any]
FAMILIES = ("dense", "moe", "audio", "vlm", "ssm")
_ATTN = ("dense", "moe", "audio")  # the families of L identical attention blocks
_SLICES = {"hybrid": "the hybrid slice"}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        slice_ = _SLICES.get(cfg.family)
        if slice_ is None:
            raise ValueError(cfg.family)
        raise NotImplementedError(f"the {cfg.family} family waits for {slice_}")


# ============================================================== initialization
# A leaf is (shape, dtype, init), init one of ("normal", scale), ("zeros",),
# ("ones",), ("full", value), ("a_log",): the reference's init for that leaf.
def param_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's leaves, as the reference's ``init_params`` makes
    them: names, shapes, dtypes and initializers."""
    _check_family(cfg)
    dt = cfg.act_dtype()
    f32 = torch.float32
    d, v, L = cfg.d_model, cfg.vocab, cfg.n_layers

    def dense(shape, scale=0.02, dtype=dt):
        return (tuple(shape), dtype, ("normal", scale))

    def norm(*lead):
        if cfg.norm == "rmsnorm":
            return ((*lead, d), dt, ("ones",))
        return ((*lead, 0), dt, ("zeros",))  # non-parametric: empty leaf

    def block(*lead):  # pre-norm attention + MLP, leaves stacked over ``lead``
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
        attn = {
            "wq": dense((*lead, d, hq * hd)),
            "wk": dense((*lead, d, hkv * hd)),
            "wv": dense((*lead, d, hkv * hd)),
            "wo": dense((*lead, hq * hd, d)),
        }
        if cfg.qkv_bias:
            for name, width in (("bq", hq * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
                attn[name] = ((*lead, width), dt, ("zeros",))
        out = {"norm1": norm(*lead), "norm2": norm(*lead), "attn": attn}
        if cfg.family == "moe":
            out["moe"] = moe(*lead)
        else:
            out["mlp"] = mlp(*lead)
        return out

    def mlp(*lead):
        f = cfg.d_ff
        p = {"w1": dense((*lead, d, f)), "w2": dense((*lead, f, d))}
        if cfg.mlp == "swiglu":
            p["w3"] = dense((*lead, d, f))
        return p

    def moe(*lead):  # the router in f32, the experts in the activation dtype
        e, f = cfg.n_experts, cfg.moe_dff
        p = {"router": dense((*lead, d, e), dtype=f32),
             "w1": dense((*lead, e, d, f)), "w3": dense((*lead, e, d, f)),
             "w2": dense((*lead, e, f, d))}
        if cfg.dense_residual:
            p["dense"] = mlp(*lead)
        return p

    spec: Dict[str, Any] = {}
    if not cfg.embedding_inputs:
        spec["embed"] = dense((v, d))
    spec["final_norm"] = norm()
    if not (cfg.tie_embeddings and not cfg.embedding_inputs):  # else logits via embed.T
        spec["lm_head"] = dense((d, v))
    if cfg.family in _ATTN:
        spec["blocks"] = block(L)
    elif cfg.family == "vlm":
        g, per = _groups(cfg)
        spec["self_blocks"] = block(g, per)
        spec["cross_blocks"] = dict(block(g), gate=((g,), f32, ("zeros",)))  # tanh gate
    else:
        if cfg.ssm_version != 1:
            raise NotImplementedError(f"mamba2 layers wait for {_SLICES['hybrid']}")
        di, n, dtr = cfg.d_inner(), cfg.ssm_state, cfg.dtr()
        spec["blocks"] = {
            "norm1": norm(L),
            "mamba": {
                "in_proj": dense((L, d, 2 * di)),
                "conv_w": dense((L, di, cfg.d_conv), 0.1),
                "conv_b": ((L, di), dt, ("zeros",)),
                "x_proj": dense((L, di, dtr + 2 * n)),
                "dt_proj": dense((L, dtr, di)),
                "dt_bias": ((L, di), dt, ("full", -4.6)),  # softplus^-1(0.01)
                "A_log": ((L, di, n), f32, ("a_log",)),
                "D_skip": ((L, di), f32, ("ones",)),
                "out_proj": dense((L, di, d)),
            },
        }
    return spec


def _groups(cfg: ModelConfig) -> Tuple[int, int]:
    """The vlm's groups and the self blocks in each (one cross block each)."""
    return cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


def _init_leaf(leaf, gen: torch.Generator, device) -> torch.Tensor:
    shape, dtype, (kind, *arg) = leaf
    if kind == "normal":
        out = torch.empty(shape, dtype=dtype, device=device)
        # draw a layer at a time, so the f32 draw never holds a whole stack
        rows = out.reshape(-1, *shape[-2:]) if len(shape) > 2 else out[None]
        for r in rows:
            r.copy_(torch.randn(r.shape, generator=gen, device=device) * arg[0])
        return out
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "full":
        return torch.full(shape, arg[0], dtype=dtype, device=device)
    # a_log: log(1..N) on every channel of every layer
    n = shape[-1]
    row = torch.from_numpy(np.log(np.arange(1, n + 1, dtype=np.float32)))
    return row.to(device).expand(shape).contiguous()


def _map_spec(fn, spec):
    if isinstance(spec, dict):
        return {k: _map_spec(fn, v) for k, v in spec.items()}
    return fn(spec)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters drawn on ``device`` from ``torch.Generator(seed)``:
    the reference's names, shapes, dtypes and scales (normal x 0.02, conv
    weights x 0.1), not its numbers (the two generators differ)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _map_spec(lambda leaf: _init_leaf(leaf, gen, dev), param_spec(cfg))


def _layer(tree, i):
    """Layer ``i``'s parameters (or cache rows): views of the stacked leaves
    (``i`` a tuple indexes several leading axes: a vlm group's self layer)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ================================================================ block bodies
def _self_block(h, bp, cfg, positions, cache=None, backend="kernel"):
    """Pre-norm attention + FFN (an MLP, or the MoE FFN where ``bp`` holds
    ``moe``).  Returns (h, new_cache, aux): the MoE auxiliary loss, None
    for an MLP block (the reference's zero)."""
    x = apply_norm(cfg.norm, h, bp["norm1"], backend)
    attn_out, new_cache = attention_block(
        x, bp["attn"], cfg, positions, kv_cache=cache, backend=backend
    )
    h = h + attn_out
    x = apply_norm(cfg.norm, h, bp["norm2"], backend)
    if "moe" in bp:
        out, aux = moe_ffn(x, bp["moe"], cfg)
        return h + out, new_cache, aux
    return h + mlp_block(x, bp["mlp"], kind=cfg.mlp), new_cache, None


def _cross_block(h, bp, cfg, positions, img_kv, backend="kernel", cached=False):
    """Gated cross-attention block (llama-3.2-vision style) over ``img_kv``:
    the image embeddings (B, T, D) or their (k, v).  ``cached``: a decode
    step over the cache's image K/V, attended in plain PyTorch as the
    reference's decode body does (which adds no ``bq``; no vlm config has
    one)."""
    x = apply_norm(cfg.norm, h, bp["norm1"], backend)
    if cached:
        b, s, _ = x.shape
        hq, hd = cfg.n_heads, cfg.hd()
        q = torch.matmul(x, bp["attn"]["wq"]).reshape(b, s, hq, hd)
        cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
        out = gqa_attention(apply_rope(q, cos, sin), *img_kv, causal=False)
        out = torch.matmul(out.reshape(b, s, hq * hd), bp["attn"]["wo"])
    else:
        out, _ = attention_block(x, bp["attn"], cfg, positions, kv_override=img_kv,
                                 backend=backend)
    h = h + torch.tanh(bp["gate"]).to(h.dtype) * out
    x = apply_norm(cfg.norm, h, bp["norm2"], backend)
    return h + mlp_block(x, bp["mlp"], kind=cfg.mlp)


def _mamba_layer(h, bp, cfg, state=None, backend="kernel"):
    x = apply_norm(cfg.norm, h, bp["norm1"], backend)
    out, new_state = mamba1_block(x, bp["mamba"], cfg, state, backend)
    return h + out, new_state


# ===================================================================== forward
def _embed(params, cfg, batch):
    if cfg.embedding_inputs:
        return batch["embeddings"].to(cfg.act_dtype())
    return params["embed"][batch["tokens"].long()]


def _logits(params, cfg, h, backend="kernel"):
    h = apply_norm(cfg.norm, h, params["final_norm"], backend)
    if cfg.tie_embeddings and not cfg.embedding_inputs:
        return torch.matmul(h, params["embed"].t())
    return torch.matmul(h, params["lm_head"])


def _img_embeds(cfg, batch):
    return batch["image_embeddings"].to(cfg.act_dtype())


def forward(params: Params, cfg: ModelConfig, batch, backend: str = "kernel"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward.  batch: {tokens (B, S)} or {embeddings
    (B, S, D)}, plus image_embeddings (B, T, D) for the vlm.  Returns
    (logits, aux)."""
    _check_family(cfg)
    h = _embed(params, cfg, batch)
    positions = torch.arange(h.shape[1], device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)  # summed over MoE layers
    if cfg.family == "vlm":
        img = _img_embeds(cfg, batch)
        groups, per = _groups(cfg)
        for g in range(groups):
            for j in range(per):
                h, _, _ = _self_block(h, _layer(params["self_blocks"], (g, j)), cfg, positions,
                                      backend=backend)
            h = _cross_block(h, _layer(params["cross_blocks"], g), cfg, positions, img, backend)
    else:
        for i in range(cfg.n_layers):
            bp = _layer(params["blocks"], i)
            if cfg.family in _ATTN:
                h, _, a = _self_block(h, bp, cfg, positions, backend=backend)
                if a is not None:
                    aux = aux + a
            else:
                h, _ = _mamba_layer(h, bp, cfg, backend=backend)
    return _logits(params, cfg, h, backend), aux


# ====================================================================== decode
def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, device="cuda"):
    """Zero decode caches: per-layer K/V buffers (dense, moe, audio; the vlm's
    per self layer of each group, and each group's image K/V) or the SSM
    state and conv tail (ssm), and the filled length."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = cfg.act_dtype()
    hkv, hd = cfg.n_kv_heads, cfg.hd()

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.family in _ATTN:
        shape = (cfg.n_layers, batch_size, max_len, hkv, hd)
        return {"k": zeros(*shape), "v": zeros(*shape), "len": 0}
    if cfg.family == "vlm":
        groups, per = _groups(cfg)
        shape = (groups, per, batch_size, max_len, hkv, hd)
        img = (groups, batch_size, cfg.n_img_tokens, hkv, hd)
        return {"k": zeros(*shape), "v": zeros(*shape), "img_k": zeros(*img),
                "img_v": zeros(*img), "len": 0}
    L, di, n = cfg.n_layers, cfg.d_inner(), cfg.ssm_state
    return {
        "ssm": torch.zeros((L, batch_size, di, n), dtype=torch.float32, device=dev),
        "conv": zeros(L, batch_size, cfg.d_conv - 1, di),
        "len": 0,
    }


def decode_step(params: Params, cfg: ModelConfig, cache, batch, backend: str = "kernel"):
    """One-token decode.  batch: {tokens (B, 1)} or {embeddings (B, 1, D)}.
    Returns (logits, cache); the cache's tensors are updated in place."""
    _check_family(cfg)
    h = _embed(params, cfg, batch)
    length = int(cache["len"])
    positions = torch.full((1,), length, dtype=torch.int64, device=h.device)
    if cfg.family == "vlm":
        groups, per = _groups(cfg)
        for g in range(groups):
            for j in range(per):
                h, _, _ = _self_block(h, _layer(params["self_blocks"], (g, j)), cfg, positions,
                                      cache=(cache["k"][g, j], cache["v"][g, j], length),
                                      backend=backend)
            h = _cross_block(h, _layer(params["cross_blocks"], g), cfg, positions,
                             (cache["img_k"][g], cache["img_v"][g]), backend, cached=True)
    else:
        for i in range(cfg.n_layers):
            bp = _layer(params["blocks"], i)
            if cfg.family in _ATTN:
                h, _, _ = _self_block(h, bp, cfg, positions,
                                      cache=(cache["k"][i], cache["v"][i], length),
                                      backend=backend)
            else:
                h, (ns, nc) = _mamba_layer(h, bp, cfg, state=(cache["ssm"][i], cache["conv"][i]),
                                           backend=backend)
                cache["ssm"][i].copy_(ns)
                cache["conv"][i].copy_(nc)
    return _logits(params, cfg, h, backend), dict(cache, len=length + 1)


def prefill(params: Params, cfg: ModelConfig, batch, max_len: int, backend: str = "kernel"):
    """Full-sequence forward that also fills the decode cache: K/V of the
    prompt (dense, moe, audio, vlm), each vlm group's image K/V (computed once,
    for the cache and the cross-attention), or the scan's final state and
    conv tail (ssm).  Returns (last_logits (B, 1, V), cache)."""
    _check_family(cfg)
    h = _embed(params, cfg, batch)
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device)
    cache = init_cache(cfg, b, max_len, device=h.device)
    if cfg.family == "vlm":
        img = _img_embeds(cfg, batch)
        groups, per = _groups(cfg)
        for g in range(groups):
            for j in range(per):
                h, _, _ = _self_block(h, _layer(params["self_blocks"], (g, j)), cfg, positions,
                                      cache=(cache["k"][g, j], cache["v"][g, j], 0),
                                      backend=backend)
            cp = _layer(params["cross_blocks"], g)
            img_kv = cross_kv(img, cp["attn"], cfg)
            cache["img_k"][g].copy_(img_kv[0])
            cache["img_v"][g].copy_(img_kv[1])
            h = _cross_block(h, cp, cfg, positions, img_kv, backend)
    else:
        for i in range(cfg.n_layers):
            bp = _layer(params["blocks"], i)
            if cfg.family in _ATTN:
                h, _, _ = _self_block(h, bp, cfg, positions,
                                      cache=(cache["k"][i], cache["v"][i], 0), backend=backend)
            else:
                h, (ns, nc) = _mamba_layer(h, bp, cfg, backend=backend)
                cache["ssm"][i].copy_(ns)
                cache["conv"][i].copy_(nc)
    cache["len"] = s
    return _logits(params, cfg, h[:, -1:], backend), cache
