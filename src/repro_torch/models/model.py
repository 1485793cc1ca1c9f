"""The model, for every family of the reference (counterpart of the JAX
package's ``models/model.py``).

  dense / audio : L identical pre-norm blocks (attention + MLP); audio reads
                  precomputed frame embeddings instead of token ids
  moe           : L identical pre-norm blocks (attention + the MoE FFN of
                  ``models/moe.py``, arctic's dense residual beside it)
  vlm           : G = L // cross_attn_every groups of (cross_attn_every - 1)
                  self blocks and one tanh-gated cross-attention block over
                  precomputed image embeddings (llama-3.2-vision)
  ssm           : L mamba1 blocks
  hybrid        : G = L // attn_every groups of attn_every mamba2 blocks,
                  one *shared* attention + MLP block (one set of weights)
                  after every group, then a tail of L - G * attn_every
                  mamba2 blocks (zamba2)

Parameters keep the reference's names, shapes and dtypes: a nested dict of
tensors whose per-layer leaves are stacked along a leading layer axis.  The
reference's scan over that axis is a Python loop here, each layer reading
views ``leaf[i]``.  Entry points:

  forward(params, cfg, batch)                         -> (logits, aux)
  loss_fn(params, cfg, batch)                         -> scalar loss
  init_cache(cfg, batch, max_len, window=0)           -> cache dict
  prefill(params, cfg, batch, max_len)                -> (last_logits, cache)
  decode_step(params, cfg, cache, batch, window=0)    -> (logits, cache)
  abstract_params(cfg)                                -> the tree on ``meta``

``backend="kernel"`` (the default) runs RMSNorm, prefill attention and the
selective scan through the hand-written kernels (their plain versions for
CPU tensors); ``backend="ref"`` runs the plain versions wherever the tensors
lie, for a replay on the card.  Caches are updated in place.  ``forward``'s
aux is the MoE load-balance loss summed over the layers (zero for the other
families).  ``forward`` and ``loss_fn`` run the blocks through ``_trunk``;
under autograd the kernels' Functions give the RMSNorm and flash calls
backward kernels on the card, and ``cfg.remat`` rematerialises each block
(``"dots_saveable"`` keeping the weight products).

Rolling window (``window > 0``, zamba2's ``long_500k``): ``init_cache``
makes attention caches ``window`` wide, and ``decode_step`` treats every
self-attention cache as a right-aligned ring (``_ring_attention``) whose
width is the cache's own, as the reference does.  ``prefill`` always fills
an insert-at-length cache ``max_len`` wide, so a window decode after a
prefill is the ring the reference defines only where ``max_len`` equals the
window.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

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
from repro_torch.models.mamba import mamba1_block, mamba2_block
from repro_torch.models.moe import moe_ffn
from repro_torch.runtime.dfc_shard import resolve_device

Params = Dict[str, Any]
FAMILIES = ("dense", "moe", "audio", "vlm", "ssm", "hybrid")
_ATTN = ("dense", "moe", "audio")  # the families of L identical attention blocks


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


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

    def mamba(*lead):  # mamba1 (falcon) or mamba2 (zamba2) leaves
        di, n = cfg.d_inner(), cfg.ssm_state
        if cfg.ssm_version == 1:
            dtr = cfg.dtr()
            return {
                "in_proj": dense((*lead, d, 2 * di)),
                "conv_w": dense((*lead, di, cfg.d_conv), 0.1),
                "conv_b": ((*lead, di), dt, ("zeros",)),
                "x_proj": dense((*lead, di, dtr + 2 * n)),
                "dt_proj": dense((*lead, dtr, di)),
                "dt_bias": ((*lead, di), dt, ("full", -4.6)),  # softplus^-1(0.01)
                "A_log": ((*lead, di, n), f32, ("a_log",)),
                "D_skip": ((*lead, di), f32, ("ones",)),
                "out_proj": dense((*lead, di, d)),
            }
        nh, conv_c = di // cfg.ssm_head_dim, di + 2 * n
        return {
            "in_proj": dense((*lead, d, 2 * di + 2 * n + nh)),
            "conv_w": dense((*lead, conv_c, cfg.d_conv), 0.1),
            "conv_b": ((*lead, conv_c), dt, ("zeros",)),
            "dt_bias": ((*lead, nh), dt, ("zeros",)),
            "A_log": ((*lead, nh), f32, ("zeros",)),
            "D_skip": ((*lead, nh), f32, ("ones",)),
            "norm_scale": ((*lead, di), dt, ("ones",)),
            "out_proj": dense((*lead, di, d)),
        }

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
    elif cfg.family == "hybrid":
        g, tail = _hybrid_groups(cfg)
        spec["mamba_groups"] = {"norm1": norm(g, cfg.attn_every),
                                "mamba": mamba(g, cfg.attn_every)}
        if tail:
            spec["mamba_tail"] = {"norm1": norm(tail), "mamba": mamba(tail)}
        spec["shared_attn"] = block()  # one block, applied after every group
    else:
        spec["blocks"] = {"norm1": norm(L), "mamba": mamba(L)}
    return spec


def _groups(cfg: ModelConfig) -> Tuple[int, int]:
    """The vlm's groups and the self blocks in each (one cross block each)."""
    return cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


def _hybrid_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """The hybrid's groups of ``attn_every`` mamba2 layers (one shared block
    after each) and the mamba2 layers of its tail."""
    g = cfg.n_layers // cfg.attn_every
    return g, cfg.n_layers - g * cfg.attn_every


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


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameter tree as ``meta`` tensors (names, shapes, dtypes; no
    storage), from :func:`param_spec`: the reference's ``abstract_params``
    (``jax.eval_shape`` of ``init_params``), for the dry run.  A generator
    cannot draw on ``meta``, so ``init_params`` cannot make it."""
    meta = torch.device("meta")
    return _map_spec(lambda leaf: torch.empty(leaf[0], dtype=leaf[1], device=meta),
                     param_spec(cfg))


def _layer(tree, i):
    """Layer ``i``'s parameters (or cache rows): views of the stacked leaves
    (``i`` a tuple indexes several leading axes: a vlm group's self layer)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ================================================================ block bodies
def _self_block(h, bp, cfg, positions, cache=None, backend="kernel", window=0, ring=False):
    """Pre-norm attention + FFN (an MLP, or the MoE FFN where ``bp`` holds
    ``moe``).  ``ring``: a decode step over a rolling-window cache
    (``_ring_attention``); else ``window`` > 0 masks keys more than
    ``window`` - 1 positions back (plain PyTorch).  Returns (h, new_cache,
    aux): the MoE auxiliary loss, None for an MLP block (the reference's
    zero)."""
    x = apply_norm(cfg.norm, h, bp["norm1"], backend)
    if ring:
        attn_out, new_cache = _ring_attention(x, bp["attn"], cfg, positions, cache)
    else:
        attn_out, new_cache = attention_block(
            x, bp["attn"], cfg, positions, kv_cache=cache, backend=backend, window=window
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
    if cfg.ssm_version == 1:
        out, new_state = mamba1_block(x, bp["mamba"], cfg, state, backend)
    else:
        out, new_state = mamba2_block(x, bp["mamba"], cfg, state)
    return h + out, new_state


# ---------------------------------------------------- rolling-window attention
def _ring_attention(x, p, cfg, positions, cache):
    """Decode attention over a right-aligned rolling KV window.

    cache = (k_win (B, W, Hkv, hd) roped, v_win, length); x: (B, 1, D).  The
    window is shifted left by one and this token's roped K/V appended at
    slot W - 1, IN PLACE; slot j holds absolute position length - (W-1-j)
    and is valid iff that is >= 0.  W is the cache's width.  As the
    reference, no QKV bias is added here; softmax in f32, -1e30 on the
    invalid slots."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"ring attention decodes one token, got {s}")
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    k_win, v_win, length = cache
    w = k_win.shape[1]
    q = torch.matmul(x, p["wq"]).reshape(b, 1, hq, hd)
    k = torch.matmul(x, p["wk"]).reshape(b, 1, hkv, hd)
    v = torch.matmul(x, p["wv"]).reshape(b, 1, hkv, hd)
    cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k_win.copy_(torch.cat([k_win[:, 1:], k.to(k_win.dtype)], dim=1))
    v_win.copy_(torch.cat([v_win[:, 1:], v.to(v_win.dtype)], dim=1))
    valid = torch.arange(w, device=x.device) >= (w - 1 - length)
    group = hq // hkv
    qf = q.reshape(b, 1, hkv, group, hd).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k_win.float()) / math.sqrt(hd)
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v_win.float())
    out = out.reshape(b, 1, hq * hd).to(x.dtype)
    return torch.matmul(out, p["wo"]), (k_win, v_win, length + 1)


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


# the products without batch dimensions: torch.matmul folds (B, S, D) @ (D, F)
# into one of these, so they are the weight products (the reference's
# ``dots_with_no_batch_dims_saveable``); bmm and baddbmm have a batch dimension
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """``fn`` under the configuration's rematerialisation, as the
    reference's ``_remat`` wraps its scan bodies: ``"none"`` keeps every
    activation for the backward; ``"nothing_saveable"`` keeps a block's
    inputs only and recomputes the block in the backward
    (``torch.utils.checkpoint``, non-reentrant); ``"dots_saveable"`` also
    keeps the outputs of the products without batch dimensions (``aten.mm``
    / ``addmm``: the weight products) and recomputes the rest, batched
    products such as the MoE's experts included (selective checkpointing).
    The kernels' launches are no aten ops, so no policy keeps their outputs:
    they run again in the recompute under either policy.  Only where
    autograd records; the saved outputs are the recomputed ones' bits."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("nothing_saveable", "dots_saveable"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    kw = {}
    if cfg.remat == "dots_saveable":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_policy)

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return remat


def _trunk(params: Params, cfg: ModelConfig, batch, backend: str = "kernel"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every block before the head (the reference's ``_trunk``), each block
    (a vlm or hybrid group, a hybrid tail layer) under ``_remat``.  Returns
    (h, aux): the hidden states and the MoE load-balance loss summed over
    the layers (zero for the other families)."""
    _check_family(cfg)
    h = _embed(params, cfg, batch)
    positions = torch.arange(h.shape[1], device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "vlm":
        img = _img_embeds(cfg, batch)
        groups, per = _groups(cfg)

        def group_body(h, g):
            for j in range(per):
                h, _, _ = _self_block(h, _layer(params["self_blocks"], (g, j)), cfg, positions,
                                      backend=backend)
            return _cross_block(h, _layer(params["cross_blocks"], g), cfg, positions, img,
                                backend)

        body = _remat(cfg, group_body)
        for g in range(groups):
            h = body(h, g)
    elif cfg.family == "hybrid":
        groups, tail = _hybrid_groups(cfg)

        def group_body(h, g):
            for j in range(cfg.attn_every):
                h, _ = _mamba_layer(h, _layer(params["mamba_groups"], (g, j)), cfg,
                                    backend=backend)
            return _self_block(h, params["shared_attn"], cfg, positions, backend=backend)[0]

        def tail_body(h, i):
            return _mamba_layer(h, _layer(params["mamba_tail"], i), cfg, backend=backend)[0]

        body, tail_fn = _remat(cfg, group_body), _remat(cfg, tail_body)
        for g in range(groups):
            h = body(h, g)
        for i in range(tail):
            h = tail_fn(h, i)
    elif cfg.family in _ATTN:

        def block_body(h, i):
            h, _, a = _self_block(h, _layer(params["blocks"], i), cfg, positions,
                                  backend=backend)
            return h, a

        body = _remat(cfg, block_body)
        for i in range(cfg.n_layers):
            h, a = body(h, i)
            if a is not None:
                aux = aux + a
    else:

        def mamba_body(h, i):
            return _mamba_layer(h, _layer(params["blocks"], i), cfg, backend=backend)[0]

        body = _remat(cfg, mamba_body)
        for i in range(cfg.n_layers):
            h = body(h, i)
    return h, aux


def forward(params: Params, cfg: ModelConfig, batch, backend: str = "kernel"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward.  batch: {tokens (B, S)} or {embeddings
    (B, S, D)}, plus image_embeddings (B, T, D) for the vlm.  Returns
    (logits, aux)."""
    h, aux = _trunk(params, cfg, batch, backend)
    return _logits(params, cfg, h, backend), aux


def _ce_terms(logits, labels):
    """(summed token NLL, token count) in f32 over the labels >= 0 (a
    negative label is masked out; its index wraps as the reference's
    ``take_along_axis`` does, and the mask zeroes it)."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    idx = labels.long().remainder(lf.shape[-1])
    gold = torch.gather(lf, -1, idx[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def loss_fn(params: Params, cfg: ModelConfig, batch, backend: str = "kernel") -> torch.Tensor:
    """Mean next-token cross-entropy plus 0.01 x the MoE aux loss (the
    reference's ``loss_fn``).  batch: the forward's inputs and ``labels``
    (B, S), negative = masked.  With ``cfg.loss_chunk`` dividing S (and
    below it), the trunk runs once and the head and cross-entropy run per
    chunk of the sequence, so the whole (B, S, V) logits never exist at
    once."""
    labels = batch["labels"]
    chunk = cfg.loss_chunk
    if chunk and labels.shape[1] % chunk == 0 and labels.shape[1] > chunk:
        hs, aux = _trunk(params, cfg, batch, backend)
        total = torch.zeros((), dtype=torch.float32, device=hs.device)
        count = torch.zeros((), dtype=torch.float32, device=hs.device)
        for i in range(0, labels.shape[1], chunk):
            lg = _logits(params, cfg, hs[:, i:i + chunk], backend)
            t, c = _ce_terms(lg, labels[:, i:i + chunk])
            total, count = total + t, count + c
        return total / torch.clamp(count, min=1.0) + 0.01 * aux
    logits, aux = forward(params, cfg, batch, backend)
    t, c = _ce_terms(logits, labels)
    return t / torch.clamp(c, min=1.0) + 0.01 * aux


# ====================================================================== decode
def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, window: int = 0,
               device="cuda"):
    """Zero decode caches: per-layer K/V buffers (dense, moe, audio; the vlm's
    per self layer of each group, and each group's image K/V), the SSM
    state and conv tail (ssm), or both for the hybrid (each group's mamba2
    states, one K/V slot per application of the shared block, the tail's
    states), and the filled length.  ``window`` > 0: the attention caches
    are ``window`` wide (rolling windows), else ``max_len``."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = cfg.act_dtype()
    hkv, hd = cfg.n_kv_heads, cfg.hd()
    wlen = window or max_len

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    if cfg.family in _ATTN:
        shape = (cfg.n_layers, batch_size, wlen, hkv, hd)
        return {"k": zeros(*shape), "v": zeros(*shape), "len": 0}
    if cfg.family == "vlm":
        groups, per = _groups(cfg)
        shape = (groups, per, batch_size, wlen, hkv, hd)
        img = (groups, batch_size, cfg.n_img_tokens, hkv, hd)
        return {"k": zeros(*shape), "v": zeros(*shape), "img_k": zeros(*img),
                "img_v": zeros(*img), "len": 0}
    di, n = cfg.d_inner(), cfg.ssm_state
    f32 = torch.float32
    if cfg.family == "ssm":
        L = cfg.n_layers
        return {"ssm": zeros(L, batch_size, di, n, dt=f32),
                "conv": zeros(L, batch_size, cfg.d_conv - 1, di), "len": 0}
    nh, hp = di // cfg.ssm_head_dim, cfg.ssm_head_dim
    groups, tail = _hybrid_groups(cfg)
    e, conv_c = cfg.attn_every, di + 2 * n
    kv = (groups, batch_size, wlen, hkv, hd)
    out = {"ssm": zeros(groups, e, batch_size, nh, hp, n, dt=f32),
           "conv": zeros(groups, e, batch_size, cfg.d_conv - 1, conv_c),
           "attn_k": zeros(*kv), "attn_v": zeros(*kv), "len": 0}
    if tail:
        out["tail_ssm"] = zeros(tail, batch_size, nh, hp, n, dt=f32)
        out["tail_conv"] = zeros(tail, batch_size, cfg.d_conv - 1, conv_c)
    return out


def _mamba_cached(h, bp, cfg, ssm, conv, state, backend):
    """One mamba layer whose final SSM state and conv tail are written into
    the cache rows ``ssm`` / ``conv`` (``state``: read from them first, or
    None for a prefill)."""
    h, (ns, nc) = _mamba_layer(h, bp, cfg, state=state, backend=backend)
    ssm.copy_(ns)
    conv.copy_(nc)
    return h


def _hybrid_trunk(h, params, cfg, cache, positions, length, backend, decode, window=0):
    """The hybrid's groups, shared block and tail over ``cache`` (prefill:
    the states written, K/V inserted at 0; ``decode``: one step from the
    cached states, K/V into the ring where ``window`` > 0)."""
    groups, tail = _hybrid_groups(cfg)
    for g in range(groups):
        for j in range(cfg.attn_every):
            ssm, conv = cache["ssm"][g, j], cache["conv"][g, j]
            h = _mamba_cached(h, _layer(params["mamba_groups"], (g, j)), cfg, ssm, conv,
                              (ssm, conv) if decode else None, backend)
        h, _, _ = _self_block(h, params["shared_attn"], cfg, positions,
                              cache=(cache["attn_k"][g], cache["attn_v"][g], length),
                              backend=backend, window=window, ring=window > 0)
    for i in range(tail):
        ssm, conv = cache["tail_ssm"][i], cache["tail_conv"][i]
        h = _mamba_cached(h, _layer(params["mamba_tail"], i), cfg, ssm, conv,
                          (ssm, conv) if decode else None, backend)
    return h


def decode_step(params: Params, cfg: ModelConfig, cache, batch, backend: str = "kernel",
                window: int = 0):
    """One-token decode.  batch: {tokens (B, 1)} or {embeddings (B, 1, D)}.
    ``window`` > 0: every self-attention cache is a rolling window
    (``_ring_attention``).  Returns (logits, cache); the cache's tensors
    are updated in place."""
    _check_family(cfg)
    h = _embed(params, cfg, batch)
    length = int(cache["len"])
    positions = torch.full((1,), length, dtype=torch.int64, device=h.device)
    ring = window > 0
    if cfg.family == "vlm":
        groups, per = _groups(cfg)
        for g in range(groups):
            for j in range(per):
                h, _, _ = _self_block(h, _layer(params["self_blocks"], (g, j)), cfg, positions,
                                      cache=(cache["k"][g, j], cache["v"][g, j], length),
                                      backend=backend, window=window, ring=ring)
            h = _cross_block(h, _layer(params["cross_blocks"], g), cfg, positions,
                             (cache["img_k"][g], cache["img_v"][g]), backend, cached=True)
    elif cfg.family == "hybrid":
        h = _hybrid_trunk(h, params, cfg, cache, positions, length, backend, True, window)
    else:
        for i in range(cfg.n_layers):
            bp = _layer(params["blocks"], i)
            if cfg.family in _ATTN:
                h, _, _ = _self_block(h, bp, cfg, positions,
                                      cache=(cache["k"][i], cache["v"][i], length),
                                      backend=backend, window=window, ring=ring)
            else:
                ssm, conv = cache["ssm"][i], cache["conv"][i]
                h = _mamba_cached(h, bp, cfg, ssm, conv, (ssm, conv), backend)
    return _logits(params, cfg, h, backend), dict(cache, len=length + 1)


def prefill(params: Params, cfg: ModelConfig, batch, max_len: int, backend: str = "kernel"):
    """Full-sequence forward that also fills the decode cache: K/V of the
    prompt (dense, moe, audio, vlm; the hybrid's shared block, one slot per
    group), each vlm group's image K/V (computed once, for the cache and the
    cross-attention), or the scans' final states and conv tails (ssm,
    hybrid).  The attention caches are insert-at-length, ``max_len`` wide.
    Returns (last_logits (B, 1, V), cache)."""
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
    elif cfg.family == "hybrid":
        h = _hybrid_trunk(h, params, cfg, cache, positions, 0, backend, False)
    else:
        for i in range(cfg.n_layers):
            bp = _layer(params["blocks"], i)
            if cfg.family in _ATTN:
                h, _, _ = _self_block(h, bp, cfg, positions,
                                      cache=(cache["k"][i], cache["v"][i], 0), backend=backend)
            else:
                h = _mamba_cached(h, bp, cfg, cache["ssm"][i], cache["conv"][i], None, backend)
    cache["len"] = s
    return _logits(params, cfg, h[:, -1:], backend), cache
