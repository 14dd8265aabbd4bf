# -*- coding: utf-8 -*-
"""Iterative No-U-Turn Sampler over a chain batch, one leapfrog a step.

The whole transition is one loop whose body does exactly one leapfrog step
for every chain plus O(max_depth) bookkeeping, as masked selects over the
chain dimension, so every iteration is the same straight-line program and
one batched value+gradient call serves all chains:

  * the trajectory grows leaf by leaf; a doubling's random direction is
    drawn when its first leaf starts, and the finished subtree merges into
    the trajectory (biased-progressive multinomial proposal swap, edge
    extension, trajectory-level U-turn check) when its last leaf lands;
  * within-subtree U-turn detection uses the O(log n) checkpoint stack of
    momenta indexed by the bit pattern of the leaf counter (an even leaf
    opens subtrees at slot popcount(i); an odd leaf closes the slots
    [popcount(i) - trailing_ones(i), popcount(i) - 1]); popcount and
    trailing ones come from lookup tensors of 2^max_depth entries;
  * multinomial sampling over leaves, generalized U-turn criterion
    <M^{-1} rho, r_edge> <= 0, divergence at DeltaE > 1000 (Stan
    conventions).

Randomness goes through a *source* with two methods: ``momentum(mask,
dim, dtype)``, the standard normals (chains, dim) of the transitions that
start (the rows where ``mask`` is set), and ``leaf(mask, dtype)``, each
leaf's direction bit and two uniforms for the chains that take a leaf.
Rows outside ``mask`` are ignored.  :class:`GeneratorSource`, the default,
draws every row from one ``torch.Generator`` on the run's device; a source
that keeps a stream per chain (and draws only the masked rows) reproduces
per-chain samplers exactly.
"""

from typing import NamedTuple

import math

import torch

from .hmc import HMCState, kinetic_energy, leapfrog_one, momentum_map, \
    velocity

__all__ = ["nuts_step", "nuts_draws_persistent", "NUTSInfo",
           "GeneratorSource"]


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor    # mean Metropolis stat over visited leaves
    diverging: torch.Tensor
    energy: torch.Tensor
    depth: torch.Tensor
    n_leapfrog: torch.Tensor


class GeneratorSource(object):
    """Every draw from one ``torch.Generator``, for the whole batch at once
    (no host read of the mask)."""

    def __init__(self, generator):
        self.generator = generator

    def momentum(self, mask, dim, dtype):
        return torch.randn((mask.shape[0], dim), generator=self.generator,
                           dtype=dtype, device=mask.device)

    def leaf(self, mask, dtype):
        u = torch.rand((3, mask.shape[0]), generator=self.generator,
                       dtype=dtype, device=mask.device)
        return u[0] < 0.5, u[1], u[2]


def _as_source(source):
    if isinstance(source, torch.Generator):
        return GeneratorSource(source)
    return source


_TABLES = {}


def _bit_tables(max_depth, device):
    """(popcount(i), trailing_ones(i)) for i < 2^max_depth, once per
    device."""
    key = (max_depth, str(device))
    if key not in _TABLES:
        i = range(1 << max_depth)
        pc = [bin(v).count("1") for v in i]
        to = [bin(((v + 1) & -(v + 1)) - 1).count("1") for v in i]
        _TABLES[key] = (torch.tensor(pc, device=device),
                        torch.tensor(to, device=device))
    return _TABLES[key]


class _State(NamedTuple):
    # Per-transition energy origin (set at transition init).
    energy0: torch.Tensor
    # Committed trajectory.
    z_left: torch.Tensor
    r_left: torch.Tensor
    grad_left: torch.Tensor
    logp_left: torch.Tensor
    z_right: torch.Tensor
    r_right: torch.Tensor
    grad_right: torch.Tensor
    logp_right: torch.Tensor
    z_prop: torch.Tensor
    logp_prop: torch.Tensor
    grad_prop: torch.Tensor
    tree_logw: torch.Tensor
    tree_rho: torch.Tensor
    depth: torch.Tensor
    # Subtree under construction.
    direction: torch.Tensor      # +-1.0
    sub_count: torch.Tensor      # leaves completed in this subtree
    sub_logw: torch.Tensor
    sub_rho: torch.Tensor
    sub_zprop: torch.Tensor
    sub_logp_prop: torch.Tensor
    sub_grad_prop: torch.Tensor
    ckpt_r: torch.Tensor         # (chains, max_depth, dim)
    ckpt_rho: torch.Tensor       # (chains, max_depth, dim)
    # Moving integration edge.
    z_cur: torch.Tensor
    r_cur: torch.Tensor
    grad_cur: torch.Tensor
    logp_cur: torch.Tensor
    # Termination + stats.
    done: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    n_leaves: torch.Tensor


def _select(mask, a, b):
    """Field by field ``where(mask, a, b)`` with a (chains,) mask."""
    return type(a)(*[
        torch.where(mask.view((-1,) + (1,) * (x.dim() - 1)), x, y)
        for x, y in zip(a, b)
    ])


def _init_transition(eps, state, to_momentum, inv_mass, max_depth):
    """Fresh :class:`_State` for one NUTS transition of every chain from
    ``state``, with momenta from the standard normals ``eps``."""
    z, logp, grad = state
    chains, dim = z.shape
    r0 = to_momentum(eps)
    energy0 = -logp + kinetic_energy(r0, inv_mass)
    scalar = z.new_zeros(chains)
    count = torch.zeros(chains, dtype=torch.int64, device=z.device)
    flag = torch.zeros(chains, dtype=torch.bool, device=z.device)
    ckpt = z.new_zeros((chains, max_depth, dim))
    return _State(
        energy0=energy0,
        z_left=z, r_left=r0, grad_left=grad, logp_left=logp,
        z_right=z, r_right=r0, grad_right=grad, logp_right=logp,
        z_prop=z, logp_prop=logp, grad_prop=grad,
        tree_logw=scalar,
        tree_rho=r0,
        depth=count,
        direction=torch.ones_like(scalar),
        sub_count=count,
        sub_logw=torch.full_like(scalar, -math.inf),
        sub_rho=torch.zeros_like(z),
        sub_zprop=z, sub_logp_prop=logp, sub_grad_prop=grad,
        ckpt_r=ckpt, ckpt_rho=ckpt,
        z_cur=z, r_cur=r0, grad_cur=grad, logp_cur=logp,
        done=flag, diverging=flag,
        sum_accept=scalar,
        n_leaves=count,
    )


def _make_body(batched_vg, source, step_size, inv_mass, max_depth,
               divergence_threshold, device):
    """The one-leapfrog-per-iteration transition body (see module docs):
    ``body(st, mask) -> st'`` for every chain; ``mask`` marks the chains
    that take a leaf (the source draws their numbers)."""
    popcount, trailing_ones = _bit_tables(max_depth, device)
    slots = torch.arange(max_depth, device=device)

    def dot(a, b):
        return torch.sum(a * b, dim=-1)

    def is_turning(r_a, r_b, rho):
        return (dot(velocity(r_a, inv_mass), rho) <= 0.0) \
            | (dot(velocity(r_b, inv_mass), rho) <= 0.0)

    def body(st, mask):
        bit, u_mn, u_acc = source.leaf(mask, st.z_prop.dtype)

        # -- subtree start: draw a direction, move the edge, reset trackers.
        starting = st.sub_count == 0
        col = starting[:, None]
        direction = torch.where(
            starting, torch.where(bit, 1.0, -1.0).to(st.direction.dtype),
            st.direction)
        going_right = direction > 0
        right = going_right[:, None]
        z_cur = torch.where(col, torch.where(right, st.z_right, st.z_left),
                            st.z_cur)
        r_cur = torch.where(col, torch.where(right, st.r_right, st.r_left),
                            st.r_cur)
        grad_cur = torch.where(
            col, torch.where(right, st.grad_right, st.grad_left),
            st.grad_cur)
        sub_logw = torch.where(starting, -math.inf, st.sub_logw)
        sub_rho = torch.where(col, 0.0, st.sub_rho)

        # -- one leapfrog step, one batched value+gradient.
        z_new, r_new, logp_new, grad_new = leapfrog_one(
            batched_vg, z_cur, r_cur, grad_cur,
            (direction * step_size)[:, None], inv_mass,
        )
        energy = -logp_new + kinetic_energy(r_new, inv_mass)
        delta = st.energy0 - energy
        delta = torch.where(torch.isnan(delta), -math.inf, delta)
        diverging = (-delta) > divergence_threshold

        # -- multinomial proposal within the subtree.
        sub_logw_new = torch.logaddexp(sub_logw, delta)
        take = torch.log(u_mn) < (delta - sub_logw_new)
        tcol = take[:, None]
        sub_zprop = torch.where(tcol, z_new, st.sub_zprop)
        sub_logp_prop = torch.where(take, logp_new, st.sub_logp_prop)
        sub_grad_prop = torch.where(tcol, grad_new, st.sub_grad_prop)

        # -- checkpoint-stack U-turn bookkeeping (leaf index = sub_count).
        leaf = st.sub_count
        is_even = (leaf % 2) == 0
        pc = popcount[leaf]
        write = (is_even[:, None] & (slots == pc[:, None]))[:, :, None]
        ckpt_r = torch.where(write, r_new[:, None, :], st.ckpt_r)
        ckpt_rho = torch.where(write, sub_rho[:, None, :], st.ckpt_rho)
        sub_rho = sub_rho + r_new
        lo = (pc - trailing_ones[leaf])[:, None]
        active = (~is_even)[:, None] & (slots >= lo) \
            & (slots <= (pc - 1)[:, None])
        seg_rho = sub_rho[:, None, :] - ckpt_rho
        v_new = velocity(r_new, inv_mass)
        seg_turn = (dot(velocity(ckpt_r, inv_mass), seg_rho) <= 0.0) \
            | (dot(seg_rho, v_new[:, None, :]) <= 0.0)
        sub_turning = torch.any(active & seg_turn, dim=1)

        sub_count = leaf + 1
        sub_done = sub_count >= torch.bitwise_left_shift(1, st.depth)
        ok = ~sub_turning & ~diverging

        # -- subtree merge (fires only when the subtree completed cleanly).
        merge = sub_done & ok
        swap = merge & (torch.log(u_acc) < (sub_logw_new - st.tree_logw))
        scol = swap[:, None]
        z_prop = torch.where(scol, sub_zprop, st.z_prop)
        logp_prop = torch.where(swap, sub_logp_prop, st.logp_prop)
        grad_prop = torch.where(scol, sub_grad_prop, st.grad_prop)
        tree_logw = torch.where(
            merge, torch.logaddexp(st.tree_logw, sub_logw_new), st.tree_logw)

        ext_right = merge & going_right
        ext_left = merge & ~going_right
        er, el = ext_right[:, None], ext_left[:, None]
        z_right = torch.where(er, z_new, st.z_right)
        r_right = torch.where(er, r_new, st.r_right)
        grad_right = torch.where(er, grad_new, st.grad_right)
        logp_right = torch.where(ext_right, logp_new, st.logp_right)
        z_left = torch.where(el, z_new, st.z_left)
        r_left = torch.where(el, r_new, st.r_left)
        grad_left = torch.where(el, grad_new, st.grad_left)
        logp_left = torch.where(ext_left, logp_new, st.logp_left)

        tree_rho = torch.where(merge[:, None], st.tree_rho + sub_rho,
                               st.tree_rho)
        tree_turn = merge & is_turning(r_left, r_right, tree_rho)
        depth = st.depth + merge.to(st.depth.dtype)

        done = diverging | sub_turning | tree_turn \
            | (merge & (depth >= max_depth))

        return _State(
            energy0=st.energy0,
            z_left=z_left, r_left=r_left, grad_left=grad_left,
            logp_left=logp_left,
            z_right=z_right, r_right=r_right, grad_right=grad_right,
            logp_right=logp_right,
            z_prop=z_prop, logp_prop=logp_prop, grad_prop=grad_prop,
            tree_logw=tree_logw, tree_rho=tree_rho, depth=depth,
            direction=direction,
            sub_count=torch.where(sub_done, 0, sub_count),
            sub_logw=sub_logw_new, sub_rho=sub_rho,
            sub_zprop=sub_zprop, sub_logp_prop=sub_logp_prop,
            sub_grad_prop=sub_grad_prop,
            ckpt_r=ckpt_r, ckpt_rho=ckpt_rho,
            z_cur=z_new, r_cur=r_new, grad_cur=grad_new, logp_cur=logp_new,
            done=done, diverging=diverging,
            sum_accept=st.sum_accept + torch.clamp(torch.exp(delta),
                                                   max=1.0),
            n_leaves=st.n_leaves + 1,
        )

    return body


def nuts_step(source, state, batched_vg, step_size, inv_mass, max_depth=10,
              divergence_threshold=1000.0):
    """One NUTS transition for every chain.

    :param source: a ``torch.Generator`` or a randomness source (module
        docs).
    :param state: a chain-batched :class:`hmc.HMCState`.
    :param batched_vg: ``f(zs (B, dim)) -> (logps (B,), grads (B, dim))``,
        called once an iteration for all chains; chains that are done keep
        their state.
    :returns: (new :class:`hmc.HMCState`, :class:`NUTSInfo`).
    """
    source = _as_source(source)
    z = state.z
    chains, dim = z.shape
    everyone = torch.ones(chains, dtype=torch.bool, device=z.device)
    st = _init_transition(source.momentum(everyone, dim, z.dtype), state,
                          momentum_map(inv_mass), inv_mass, max_depth)
    body = _make_body(batched_vg, source, step_size, inv_mass, max_depth,
                      divergence_threshold, z.device)
    # One host read an iteration: the loop stops at the last chain's end.
    while True:
        st = _select(st.done, st, body(st, ~st.done))
        if bool(torch.all(st.done)):
            break

    info = NUTSInfo(
        accept_prob=st.sum_accept / torch.clamp(st.n_leaves, min=1),
        diverging=st.diverging,
        energy=-st.logp_prop,
        depth=st.depth,
        n_leapfrog=st.n_leaves,
    )
    return HMCState(st.z_prop, st.logp_prop, st.grad_prop), info


def nuts_draws_persistent(source, states, batched_vg, step_size, inv_mass,
                          num_draws, max_depth=10,
                          divergence_threshold=1000.0):
    """``num_draws`` NUTS transitions of every chain in ONE
    trajectory-persistent loop.

    The per-draw formulation pays the batch's longest trajectory every draw
    (the masked loop in :func:`nuts_step` runs until the last chain's
    U-turn).  Here the loop runs across transitions: the moment a chain's
    trajectory terminates, its draw is recorded and the same iteration
    starts its next transition, so chains never idle waiting for the batch;
    the tail is paid once, at the end.  A chain that reaches its quota
    freezes on its last committed draw (no partial next trajectory and no
    draws from the source), so a continued block carries its stream on.

    The loop runs in segments of ``min(128, max(32, 2 * num_draws))``
    iterations with one host check each; each iteration writes the recorded
    rows into (chains, num_draws + 1, ...) buffers whose last slot takes
    the rows that are not recorded.

    Fixed ``step_size`` / ``inv_mass`` only (the sampling phase).

    :returns: ``(final HMCState, outs)`` with ``outs`` the tuple ``(z
        (chains, num_draws, dim), logp, accept_prob, diverging,
        n_leapfrog)``.
    """
    source = _as_source(source)
    z = states.z
    chains, dim = z.shape
    device, dtype = z.device, z.dtype
    to_momentum = momentum_map(inv_mass)
    everyone = torch.ones(chains, dtype=torch.bool, device=device)
    st = _init_transition(source.momentum(everyone, dim, dtype), states,
                          to_momentum, inv_mass, max_depth)
    body = _make_body(batched_vg, source, step_size, inv_mass, max_depth,
                      divergence_threshold, device)

    slots = num_draws + 1
    bufs = (
        z.new_zeros((chains, slots, dim)),                        # z
        z.new_zeros((chains, slots)),                             # logp
        z.new_zeros((chains, slots)),                             # accept
        torch.zeros((chains, slots), dtype=torch.bool, device=device),
        torch.zeros((chains, slots), dtype=torch.int64, device=device),
    )
    rows = torch.arange(chains, device=device)
    idx = torch.zeros(chains, dtype=torch.int64, device=device)
    seg = min(128, max(32, num_draws * 2))

    while bool(torch.any(idx < num_draws)):
        for _ in range(seg):
            frozen = idx >= num_draws
            restart = st.done & ~frozen
            fresh = _init_transition(
                source.momentum(restart, dim, dtype),
                HMCState(st.z_prop, st.logp_prop, st.grad_prop),
                to_momentum, inv_mass, max_depth,
            )
            st_new = body(_select(st.done, fresh, st), ~frozen)
            st = _select(frozen, st, st_new)
            rec = st.done & ~frozen
            slot = torch.where(rec, idx, num_draws)
            outs = (st.z_prop, st.logp_prop,
                    st.sum_accept / torch.clamp(st.n_leaves, min=1),
                    st.diverging, st.n_leaves)
            for buf, v in zip(bufs, outs):
                buf[rows, slot] = v
            idx = idx + rec.to(idx.dtype)

    outs = tuple(buf[:, :num_draws] for buf in bufs)
    return HMCState(st.z_prop, st.logp_prop, st.grad_prop), outs
