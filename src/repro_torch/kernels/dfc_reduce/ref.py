"""Plain PyTorch versions of the combine kernels.

Same signatures and outputs as the JAX package's ``kernels/dfc_reduce/ref.py``
but batched over a leading shard axis: each function computes what
``jax.vmap(dfc_*_reduce_ref)`` does there.  The CUDA kernels in
``kernel.py`` are held bit for bit against these, on the CPU by the tests
(through the wrappers, which take these for CPU tensors) and on the card by
``chip_smoke.py``.

Shapes: ``ops`` i32[S, N], ``params`` f32[S, N], windows f32[S, N] (the
caller-built view of each shard's committed end), ``sizes`` i32[S].  The
by-rank routes scatter into zeroed rows, so a pushed ``-0.0`` comes back as
``+0.0``, exactly as the reference's scatter-add gives it.

``phase_grid_combine_ref`` is the plain version of the K-phase kernel: K
phases of the vectorized ``STRUCTS[kind].combine`` in a row.
"""

from __future__ import annotations

import torch

from repro_torch.core.torch_dfc import (
    OP_DEQ,
    OP_ENQ,
    OP_NONE,
    OP_POP,
    OP_POPL,
    OP_POPR,
    OP_PUSH,
    OP_PUSHL,
    OP_PUSHR,
    R_ACK,
    R_EMPTY,
    R_NONE,
    R_VALUE,
    STRUCTS,
    exclusive_rank,
    map_lane_apply,
    map_live_lanes,
    map_state,
    route_rows,
)


def _kinds(ops):
    return torch.full_like(ops, R_NONE, dtype=torch.int32)


def dfc_reduce_ref(ops, params, windows, sizes):
    """Stack combine per shard -> (resp f32[S,N], kinds i32[S,N],
    segments f32[S,N], counts i32[S,4] = (n_push_surplus, n_popped, n_elim,
    q_total)).  ``windows[s, N-1]`` is shard s's committed top."""
    n = ops.shape[1]
    params = params.float()
    windows = windows.float()
    size = sizes.long()[:, None]

    is_push = ops == OP_PUSH
    is_pop = ops == OP_POP
    push_rank = exclusive_rank(is_push)
    pop_rank = exclusive_rank(is_pop)
    p_total = is_push.sum(1)
    q_total = is_pop.sum(1)
    n_elim = torch.minimum(p_total, q_total)
    ne = n_elim[:, None]

    push_by_rank = route_rows(torch.where(is_push, push_rank, n), params, n)
    elim_pop_val = push_by_rank.gather(1, pop_rank.clamp(0, n - 1))

    surplus_push = is_push & (push_rank >= ne)
    segment = route_rows(torch.where(surplus_push, push_rank - ne, n), params, n)

    surplus_pop = is_pop & (pop_rank >= ne)
    depth = pop_rank - ne
    win_src = n - 1 - depth
    pop_ok = surplus_pop & (win_src >= 0) & (depth < size)
    stack_val = windows.gather(1, win_src.clamp(0, n - 1))

    elim = is_pop & (pop_rank < ne)
    kinds = _kinds(ops)
    kinds = torch.where(is_push, R_ACK, kinds)
    kinds = torch.where(elim | pop_ok, R_VALUE, kinds)
    kinds = torch.where(surplus_pop & ~pop_ok, R_EMPTY, kinds).to(torch.int32)
    resp = torch.zeros_like(params)
    resp = torch.where(elim, elim_pop_val, resp)
    resp = torch.where(pop_ok, stack_val, resp)

    counts = torch.stack([
        (p_total - n_elim).clamp_min(0),
        torch.minimum((q_total - n_elim).clamp_min(0), size[:, 0]),
        n_elim,
        q_total,
    ], dim=1).to(torch.int32)
    return resp, kinds, segment, counts


def dfc_queue_reduce_ref(ops, params, windows, sizes):
    """Queue combine per shard -> (resp, kinds, segments, counts i32[S,4] =
    (n_enq_surplus, n_from_q, n_elim, q_total)).  ``windows[s, j]`` is the
    j-th value from shard s's head."""
    n = ops.shape[1]
    params = params.float()
    windows = windows.float()
    size = sizes.long()[:, None]

    is_enq = ops == OP_ENQ
    is_deq = ops == OP_DEQ
    enq_rank = exclusive_rank(is_enq)
    deq_rank = exclusive_rank(is_deq)
    p_total = is_enq.sum(1)
    q_total = is_deq.sum(1)
    n_from_q = torch.minimum(q_total, size[:, 0])
    n_elim = torch.minimum((q_total - size[:, 0]).clamp_min(0), p_total)
    ne = n_elim[:, None]

    served = is_deq & (deq_rank < size)
    ring_val = windows.gather(1, deq_rank.clamp(0, n - 1))

    enq_by_rank = route_rows(torch.where(is_enq, enq_rank, n), params, n)
    paired = is_deq & (deq_rank >= size) & (deq_rank - size < ne)
    pair_val = enq_by_rank.gather(1, (deq_rank - size).clamp(0, n - 1))
    empty = is_deq & (deq_rank >= size + ne)

    surplus_enq = is_enq & (enq_rank >= ne)
    segment = route_rows(torch.where(surplus_enq, enq_rank - ne, n), params, n)

    kinds = _kinds(ops)
    kinds = torch.where(is_enq, R_ACK, kinds)
    kinds = torch.where(served | paired, R_VALUE, kinds)
    kinds = torch.where(empty, R_EMPTY, kinds).to(torch.int32)
    resp = torch.zeros_like(params)
    resp = torch.where(served, ring_val, resp)
    resp = torch.where(paired, pair_val, resp)

    counts = torch.stack(
        [(p_total - n_elim).clamp_min(0), n_from_q, n_elim, q_total], dim=1
    ).to(torch.int32)
    return resp, kinds, segment, counts


def dfc_deque_reduce_ref(ops, params, windows_l, windows_r, sizes):
    """Deque combine per shard -> (resp, kinds, segs_l, segs_r, counts
    i32[S,8] = (sl, dl, sr, dr, nl_elim, nr_elim, size_after, 0)).
    ``windows_l[s, j]`` / ``windows_r[s, j]`` are the j-th values from the
    left / right end."""
    n = ops.shape[1]
    params = params.float()
    windows_l = windows_l.float()
    windows_r = windows_r.float()
    size = sizes.long()
    sz = size[:, None]

    is_pl = ops == OP_PUSHL
    is_ql = ops == OP_POPL
    is_pr = ops == OP_PUSHR
    is_qr = ops == OP_POPR
    pl_rank, ql_rank = exclusive_rank(is_pl), exclusive_rank(is_ql)
    pr_rank, qr_rank = exclusive_rank(is_pr), exclusive_rank(is_qr)
    npl, nql = is_pl.sum(1), is_ql.sum(1)
    npr, nqr = is_pr.sum(1), is_qr.sum(1)
    nl_elim = torch.minimum(npl, nql)
    nr_elim = torch.minimum(npr, nqr)
    nle, nre = nl_elim[:, None], nr_elim[:, None]

    pl_by_rank = route_rows(torch.where(is_pl, pl_rank, n), params, n)
    pr_by_rank = route_rows(torch.where(is_pr, pr_rank, n), params, n)
    eliml = is_ql & (ql_rank < nle)
    elimr = is_qr & (qr_rank < nre)
    eliml_val = pl_by_rank.gather(1, ql_rank.clamp(0, n - 1))
    elimr_val = pr_by_rank.gather(1, qr_rank.clamp(0, n - 1))

    sl = (npl - nl_elim).clamp_min(0)
    tl = (nql - nl_elim).clamp_min(0)
    surplus_pl = is_pl & (pl_rank >= nle)
    seg_l = route_rows(torch.where(surplus_pl, pl_rank - nle, n), params, n)
    dl = torch.minimum(tl, size)
    surplus_ql = is_ql & (ql_rank >= nle)
    kl = ql_rank - nle
    lpop_ok = surplus_ql & (kl < sz)
    lpop_val = windows_l.gather(1, kl.clamp(0, n - 1))
    size_after = size + sl - dl

    sr = (npr - nr_elim).clamp_min(0)
    tr = (nqr - nr_elim).clamp_min(0)
    surplus_pr = is_pr & (pr_rank >= nre)
    seg_r = route_rows(torch.where(surplus_pr, pr_rank - nre, n), params, n)
    dr = torch.minimum(tr, size_after)
    surplus_qr = is_qr & (qr_rank >= nre)
    kr = qr_rank - nre
    rpop_ok = surplus_qr & (kr < size_after[:, None])
    rpop_val = torch.where(
        kr < sz,
        windows_r.gather(1, kr.clamp(0, n - 1)),
        seg_l.gather(1, (kr - sz).clamp(0, n - 1)),
    )

    kinds = _kinds(ops)
    kinds = torch.where(is_pl | is_pr, R_ACK, kinds)
    kinds = torch.where(eliml | elimr | lpop_ok | rpop_ok, R_VALUE, kinds)
    kinds = torch.where(surplus_ql & ~lpop_ok, R_EMPTY, kinds)
    kinds = torch.where(surplus_qr & ~rpop_ok, R_EMPTY, kinds).to(torch.int32)
    resp = torch.zeros_like(params)
    resp = torch.where(eliml, eliml_val, resp)
    resp = torch.where(elimr, elimr_val, resp)
    resp = torch.where(lpop_ok, lpop_val, resp)
    resp = torch.where(rpop_ok, rpop_val, resp)

    counts = torch.stack(
        [sl, dl, sr, dr, nl_elim, nr_elim, size_after, torch.zeros_like(sl)],
        dim=1,
    ).to(torch.int32)
    return resp, kinds, seg_l, seg_r, counts


def dfc_map_reduce_ref(mkeys, mvals, mocc, counts, lkeys, ops, params):
    """Map combine per shard: lanes apply in announcement order (a loop over
    the live lanes, ``map_live_lanes``, vectorized over shards), each
    probing its key's bucket window.
    Takes the tables ``[S, C]`` and active counts ``[S]`` and returns fresh
    ``(keys', values', occupied', count' i32[S], resp f32[S,N], kinds
    i32[S,N])``; the hit value is the masked window sum, as in the
    reference's plain twin."""
    s, n = ops.shape
    mk = mkeys.to(torch.int32).clone()
    mv = mvals.float().clone()
    mo = mocc.to(torch.int32).clone()
    cnt = counts.to(torch.int32).reshape(s)
    lkeys = lkeys.to(torch.int32)
    ops = ops.to(torch.int32)
    params = params.float()
    resp = torch.zeros((s, n), dtype=torch.float32, device=ops.device)
    kinds = torch.zeros((s, n), dtype=torch.int32, device=ops.device)
    for j in map_live_lanes(ops):
        cnt, resp[:, j], kinds[:, j] = map_lane_apply(
            mk, mv, mo, cnt, lkeys[:, j], ops[:, j], params[:, j],
            summed_cur=True,
        )
    return mk, mv, mo, cnt, resp, kinds


def select_touched(touched: torch.Tensor, new_state, old_state):
    """Per shard: the combined state where ``touched``, else the old one --
    shards that received no ops keep their state AND epoch."""

    def pick(new_leaf, old_leaf):
        t = touched.reshape(touched.shape + (1,) * (new_leaf.dim() - 1))
        return torch.where(t, new_leaf, old_leaf)

    return map_state(pick, new_state, old_state)


def phase_grid_combine_ref(kind, state, ops, params, keys):
    """K phases of one kind group, each the vectorized
    ``STRUCTS[kind].combine`` over all shards, a shard with no ops in a phase
    keeping its state and epoch.  ``ops`` / ``params`` / ``keys`` are
    ``[K, S, N]`` (``keys`` read by the map only).  Returns ``(states, resp
    f32[K,S,N], kinds i32[K,S,N])``, every state leaf with a leading K axis
    (the state after each phase)."""
    spec = STRUCTS[kind]
    carry = state
    states, resps, kinds = [], [], []
    for k in range(ops.shape[0]):
        if spec.keyed:
            combined, resp, knd = spec.combine(carry, keys[k], ops[k], params[k])
        else:
            combined, resp, knd = spec.combine(carry, ops[k], params[k])
        carry = select_touched((ops[k] != OP_NONE).any(1), combined, carry)
        states.append(carry)
        resps.append(resp)
        kinds.append(knd)
    return (
        map_state(lambda *leaves: torch.stack(leaves), *states),
        torch.stack(resps),
        torch.stack(kinds),
    )
