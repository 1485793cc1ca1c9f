"""The port's ``ModelConfig`` levers against the JAX package's, on the CPU.

Every field of the reference's ``ModelConfig`` with its default, in its
order; ``attn_impl="chunked"``: ``chunked_attention`` against the
reference's at key counts the chunk divides and at one it does not (both
refuse), and the loss and every gradient of reduced configs against
``jax.value_and_grad`` of the reference's (atol = rtol = 1e-4, f32);
``remat="dots_saveable"``: grads bit-equal to ``"nothing_saveable"``'s and
within 1e-4 of the reference's under its ``dots_with_no_batch_dims``
policy, and fewer products run in the backward (a counting dispatch mode);
the MoE's counts without ``torch.bincount`` (which has no ``meta`` kernel)
against ``bincount``.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import configs as JCFG  # noqa: E402
from repro.kernels.flash_attention.ops import chunked_attention as j_chunked  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import configs as TCFG  # noqa: E402
from repro_torch.kernels.flash_attention.ops import chunked_attention  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.tree import tree_flatten, tree_unflatten  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

B, S, ATOL = 2, 16, 1e-4


def test_model_config_fields_and_defaults_match_the_reference():
    want = [(f.name, f.default) for f in dataclasses.fields(JModelConfig)]
    assert [(f.name, f.default) for f in dataclasses.fields(ModelConfig)] == want
    for name in ("scan_layers", "logits_chunk", "act_sharding", "attn_impl", "attn_chunk",
                 "attn_seq_shard", "moe_shard_dispatch", "seq_parallel_resid"):
        assert name in dict(want)


# ------------------------------------------------------------ chunked attention
@pytest.mark.parametrize("b,s,hq,hkv,hd,t,blk", [
    (2, 16, 4, 2, 16, 16, 4),  # 4 chunks, the later ones past some queries
    (1, 12, 3, 3, 32, 12, 12),  # one chunk
    (2, 8, 6, 2, 16, 8, 64),  # a chunk wider than T: one chunk of T
    (1, 5, 2, 1, 16, 20, 5),  # more keys than queries: the causal loop stops early
])
def test_chunked_attention_matches_jax(b, s, hq, hkv, hd, t, blk):
    rng = np.random.default_rng(s * t + blk)
    q = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, t, hkv, hd)).astype(np.float32) for _ in range(2))
    want = j_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, blk_k=blk)
    got = chunked_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True, blk_k=blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_chunked_attention_refuses_a_ragged_chunk_as_the_reference():
    q = np.zeros((1, 10, 2, 16), np.float32)
    with pytest.raises(TypeError, match="reshape"):
        j_chunked(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), blk_k=4)
    with pytest.raises(ValueError, match="10 keys do not split into chunks of 4"):
        chunked_attention(*(torch.from_numpy(q) for _ in range(3)), blk_k=4)


@functools.lru_cache(maxsize=None)
def _jax_tree(arch):
    cfg = JCFG.get_reduced(arch)
    return jax.device_get(jax.jit(lambda key: JM.init_params(cfg, key))(jax.random.PRNGKey(0)))


def _batch(vocab):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _setup(arch, **overrides):
    jcfg = dataclasses.replace(JCFG.get_reduced(arch), **overrides)
    tcfg = dataclasses.replace(TCFG.get_reduced(arch), **overrides)
    tree = _jax_tree(arch)
    return jcfg, tcfg, tree, params_from_numpy(tree, tcfg, "cpu"), _batch(jcfg.vocab)


def _jax_loss_grads(jcfg, tree, batch):
    fn = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, jcfg, b)))
    loss, grads = fn(jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    return loss, jax.tree_util.tree_leaves(grads)


def _port_loss_grads(tparams, tcfg, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_flatten(tparams)]
    loss = TM.loss_fn(tree_unflatten(tparams, leaves), tcfg,
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss.detach(), list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                                   materialize_grads=True))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("chunk", [4, 16, 64])
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-1.5b", "zamba2-7b", "dbrx-132b"])
def test_chunked_loss_and_grads_match_jax(arch, chunk):
    """The training forward's attention as the online softmax over chunks
    of 4 (four chunks of the 16 positions), 16 (one) and 64 (wider than the
    sequence: one of 16)."""
    jcfg, tcfg, tree, tparams, batch = _setup(arch, attn_impl="chunked", attn_chunk=chunk)
    want, jgrads = _jax_loss_grads(jcfg, tree, batch)
    got, grads = _port_loss_grads(tparams, tcfg, batch)
    _close(got, want)
    assert len(grads) == len(jgrads)
    for g, w in zip(grads, jgrads):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    naive, _ = _port_loss_grads(tparams, dataclasses.replace(tcfg, attn_impl="naive"), batch)
    _close(got, naive)


def test_chunked_loss_refuses_a_ragged_chunk_as_the_reference():
    jcfg, tcfg, tree, tparams, batch = _setup("smollm-135m", attn_impl="chunked", attn_chunk=5)
    with pytest.raises(TypeError, match="reshape"):
        _jax_loss_grads(jcfg, tree, batch)
    with pytest.raises(ValueError, match="16 keys do not split into chunks of 5"):
        _port_loss_grads(tparams, tcfg, batch)


def test_chunked_lever_leaves_prefill_and_decode_alone():
    """As the reference's branch: only the attention without a cache takes
    the chunked path; the prefill and decode steps are the same bits."""
    _, tcfg, _, tparams, batch = _setup("smollm-135m")
    chunked = dataclasses.replace(tcfg, attn_impl="chunked", attn_chunk=4)
    toks = {"tokens": torch.from_numpy(batch["tokens"])}
    a, ca = TM.prefill(tparams, tcfg, toks, 24)
    b, cb = TM.prefill(tparams, chunked, toks, 24)
    assert torch.equal(a, b) and torch.equal(ca["k"], cb["k"])
    step = {"tokens": torch.zeros((B, 1), dtype=torch.int64)}
    assert torch.equal(TM.decode_step(tparams, tcfg, ca, step)[0],
                       TM.decode_step(tparams, chunked, cb, step)[0])


# ------------------------------------------------------------- dots_saveable
@pytest.mark.parametrize("arch", ["smollm-135m", "dbrx-132b", "zamba2-7b", "falcon-mamba-7b",
                                  "olmo-1b"])
def test_dots_saveable_is_bit_equal_and_matches_jax(arch):
    jcfg, tcfg, tree, tparams, batch = _setup(arch, remat="dots_saveable")
    got, grads = _port_loss_grads(tparams, tcfg, batch)
    base, base_grads = _port_loss_grads(
        tparams, dataclasses.replace(tcfg, remat="nothing_saveable"), batch)
    assert torch.equal(got, base)
    for g, h in zip(grads, base_grads):
        assert torch.equal(g, h)
    want, jgrads = _jax_loss_grads(jcfg, tree, batch)
    _close(got, want)
    for g, w in zip(grads, jgrads):
        _close(g, w)


class _Products(TorchDispatchMode):
    """Counts the products run under it, by op."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("mm", "addmm", "bmm", "baddbmm"):
            self.calls[name] = self.calls.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_products(tcfg, tparams, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_flatten(tparams)]
    loss = TM.loss_fn(tree_unflatten(tparams, leaves), tcfg,
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    with _Products() as mode:
        torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return mode.calls


@pytest.mark.parametrize("arch", ["smollm-135m", "dbrx-132b"])
def test_dots_saveable_keeps_the_weight_products(arch):
    """A counting dispatch mode over the backward: under ``dots_saveable``
    its recompute runs no weight product (``mm``: as many as with no remat
    at all, fewer than under ``nothing_saveable``), and the batched
    products (``bmm``: the MoE's experts, the plain attention backward's)
    as many as under ``nothing_saveable``."""
    _, tcfg, _, tparams, batch = _setup(arch)
    runs = {r: _backward_products(dataclasses.replace(tcfg, remat=r), tparams, batch)
            for r in ("none", "nothing_saveable", "dots_saveable")}
    assert runs["dots_saveable"]["mm"] == runs["none"]["mm"] < runs["nothing_saveable"]["mm"]
    assert runs["dots_saveable"]["bmm"] == runs["nothing_saveable"]["bmm"] > runs["none"]["bmm"]


# --------------------------------------------------------------------- moe
def test_moe_counts_equal_bincount():
    rng = np.random.default_rng(0)
    for n, size in ((4, 0), (16, 37), (64, 1000)):
        idx = torch.from_numpy(rng.integers(0, n, size))
        assert torch.equal(TMOE._count(idx, n), torch.bincount(idx, minlength=n))
    meta = TMOE._count(torch.empty(10, dtype=torch.int64, device="meta"), 7)
    assert meta.shape == (7,) and meta.dtype == torch.int64
