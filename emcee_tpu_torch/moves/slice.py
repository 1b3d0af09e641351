"""Ensemble slice sampling (zeus-style).

The counterpart of ``emcee_tpu/moves/slice.py:45-299`` (Karamanis &
Beutler 2021): each red-blue group slice-samples along ``eta = mu * (c_i
- c_j)`` with Neal's (2003) stepping-out and shrinkage on the slice
``{t : log pi(s + t eta) > y}``, ``y = log pi(s) + log U``, where U is
the accept uniform K2 would read (word 1 at ``(walker, split)``).  Every
walker that lands moves; ``done`` is reported as ``accepted``.  With
``tune_mu`` the carry ``{log_adj, t, frac_expand}`` adapts ``mu`` so
expansions balance contractions.

Both loops run a data-dependent number of iterations, which a recorded
CUDA graph cannot.  Each iteration is masked: stepping out only moves a
walker whose end is still expanding, shrinkage only one that has not
landed, and the iteration counter advances only while the JAX loop's
condition holds (``it < max_steps`` or ``max_shrink``, part of the
result), so extra iterations change nothing.  The proposal is therefore
a short host loop (``chunk_graph.py`` :class:`~..chunk_graph.GraphLoops`
on the card, :class:`~..chunk_graph.EagerLoops` otherwise): segments of
straight-line work, and per loop replays of ``loop_block`` masked
iterations until a device flag, read once per block, says every walker
is done.  The loop state lives in persistent buffers (:class:`_Work`),
written in place, so every recorded segment reads what the last wrote.

The draws: the pair ``i, j``, the window offset and the budget split
``jL`` at ``(row, SLICE_BLOCK)``; shrink iteration ``it``'s uniform from
word 0 at ``(row, SHRINK_BLOCK | it)`` (``it`` a device counter), a
block's in one Philox call at its first iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from ..chunk_graph import EagerLoops
from ..ops._wrap import complement_rows
from ..ops.philox import (
    SHRINK_BLOCK, SHRINK_MAX, SLICE_BLOCK, row_uniforms, row_words,
    to_uniform, walker_words)
from ..utils import tree_flatten, tree_map
from .base import robbins_monro_step
from .red_blue import RedBlueMove, shuffled_order

__all__ = ["EnsembleSliceMove"]


class _Work:
    """The slice move's persistent buffers for one ensemble shape: the
    shuffled split's gathered ensemble, and one group's loop state."""

    def __init__(self, nw, nd, ng, dtype, device, blobs):
        def t(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        self.order = t(nw, torch.int64)
        self.coords, self.log_prob = t((nw, nd)), t(nw)
        self.count = t(nw, torch.int32)
        self.accepted = t(nw, torch.bool)
        self.blobs = tree_map(torch.zeros_like, blobs)
        self.eta, self.y = t((ng, nd)), t(ng)
        self.left, self.right = t(ng), t(ng)
        self.exp_l, self.exp_r = t(ng, torch.bool), t(ng, torch.bool)
        self.cnt_l, self.cnt_r = t(ng, torch.int32), t(ng, torch.int32)
        self.j_l, self.j_r = t(ng, torch.int32), t(ng, torch.int32)
        self.t_acc, self.lp_acc = t(ng), t(ng)
        self.blobs_acc = tree_map(lambda b: torch.zeros_like(b[:ng]), blobs)
        self.done = t(ng, torch.bool)
        self.shrink_u = t((ng, 64))  # a block's shrink uniforms
        self.it = t((), torch.int64)
        self.flag = t((), torch.bool)
        self.nexp, self.ncon = t((), torch.float32), t((), torch.float32)
        self.nexp_sum, self.ncon_sum = (t((), torch.float32),
                                        t((), torch.float32))
        #: iterations [stepping out, shrinkage] the JAX loops would run,
        #: and those run (masked ones included), summed over groups
        self.iterations = t(2, torch.int64)
        self.executed = t(2, torch.int64)
        #: log-prob evaluations [stepping out, shrinkage] a walker-by-walker
        #: loop needs, summed over walkers (only with ``count_evals``)
        self.evals = t(2, torch.int64)


def _signature(blobs):
    leaves, treedef = tree_flatten(blobs)
    return treedef, tuple((tuple(b.shape), b.dtype) for b in leaves)


class EnsembleSliceMove(RedBlueMove):
    """Differential ensemble slice move (Karamanis & Beutler 2021).

    Args:
        mu: direction-scale multiplier on the walker-difference vector.
        max_steps: total stepping-out budget per walker per half-step,
            apportioned randomly between the two ends.
        max_shrink: cap on shrinkage iterations (a walker that hits it
            stays put and is reported unaccepted).
        tune_mu: adapt ``mu`` under ``run_mcmc(..., tune=True)`` so
            expansions balance contractions.
        tune_rate: adaptation rate for ``tune_mu``.
        nsplits / randomize_split / live_dangerously: standard red-blue
            controls.

    ``loop_block`` (an attribute, default 4, at most 64) is the masked
    iterations per block replay on the card.  ``count_evals`` (an
    attribute, default False, set before the first proposal) counts the
    evaluations each walker needs into ``_Work.evals``: an end that is
    still expanding within its budget, a walker not yet landed.
    """

    tunable = True  # the carry's exp(log_adj) scales mu
    blendable = False
    #: the chunk program runs its proposal by block replays
    looped = True
    loop_block = 4
    count_evals = False

    def __init__(self, mu=1.0, max_steps=100, max_shrink=100,
                 tune_mu=False, **kwargs):
        if kwargs.get("tune_target") is not None:
            raise ValueError(
                "EnsembleSliceMove has no accept/reject step, so "
                "acceptance targeting (tune_target) does not apply; "
                "use tune_mu=True to adapt the direction scale"
            )
        self.mu = float(mu)
        if self.mu <= 0:
            raise ValueError("mu must be positive")
        self.max_steps = int(max_steps)
        self.max_shrink = int(max_shrink)
        if self.max_shrink > SHRINK_MAX:
            raise ValueError(f"max_shrink must be at most {SHRINK_MAX}")
        self.tune_mu = bool(tune_mu)
        self._work = {}
        super().__init__(**kwargs)

    def init_carry(self, nwalkers, ndim, device=None):
        if not self.tune_mu:
            return ()
        return {
            "log_adj": torch.zeros((), dtype=torch.float32, device=device),
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "frac_expand": torch.full((), 0.5, dtype=torch.float32,
                                      device=device),
        }

    def _fold_split_stats(self, carry, stats, model):
        """``frac_expand = sum(nexp) / max(sum(nexp) + sum(ncon), 1)``
        over the splits' ``(nexp, ncon)``, in place."""
        if not (self.tune_mu and isinstance(carry, dict)):
            return carry
        nexp = sum(s[0] for s in stats)
        ncon = sum(s[1] for s in stats)
        carry["frac_expand"].copy_(nexp / torch.clamp(nexp + ncon, min=1.0))
        return carry

    def tune(self, carry, state, accepted, model=None):
        if not self.tune_mu or not isinstance(carry, dict):
            return carry
        # frac_expand > 1/2: the window is too narrow, grow mu.
        err = 2.0 * (carry["frac_expand"] - 0.5)
        return robbins_monro_step(carry, err, self.tune_rate)

    def work(self, state, ng):
        """The persistent buffers for ``state``'s shape (made on first
        use, which is eager: the chunk program warms up before it
        records)."""
        nw, nd = state.coords.shape
        dev, dt = state.coords.device, state.coords.dtype
        key = (nw, nd, ng, dt, str(dev), _signature(state.blobs))
        w = self._work.get(key)
        if w is None:
            w = self._work[key] = _Work(nw, nd, ng, dt, dev, state.blobs)
        return w

    def propose(self, rng, state, model, carry, acc_count=None,
                accepted=None, loops=None, log_acc_u=None):
        """One slice update of every group.  ``loops`` runs the segments
        and loops (:class:`~..chunk_graph.EagerLoops` by default);
        ``log_acc_u`` ``(nsplits, ng)`` injects the slice levels'
        log-uniforms (the parity mode)."""
        nwalkers, ndim = state.coords.shape
        nglobal = model.nwalkers or nwalkers
        if nglobal < 2 * model.global_ndim(ndim) and not self.live_dangerously:
            raise RuntimeError(
                "It is unadvisable to use a red-blue move with fewer "
                "walkers than twice the number of dimensions."
            )
        if nwalkers % self.nsplits != 0:
            raise ValueError(
                f"nwalkers ({nwalkers}) must be divisible by "
                f"nsplits ({self.nsplits})"
            )
        ng = nwalkers // self.nsplits
        loops = loops or EagerLoops()
        w = self.work(state, ng)
        if accepted is None:
            accepted = torch.empty(nwalkers, dtype=torch.bool,
                                   device=state.coords.device)
        shuffled = self.randomize_split
        if shuffled:
            ens = (w.coords, w.log_prob, w.blobs,
                   None if acc_count is None else w.count, w.accepted)
        else:
            ens = (state.coords, state.log_prob, state.blobs, acc_count,
                   accepted)

        def start():
            if shuffled:
                order = shuffled_order(rng, nwalkers, self.nsplits,
                                       state.coords.device)
                w.order.copy_(order)
                w.coords.copy_(state.coords.index_select(0, order))
                w.log_prob.copy_(state.log_prob.index_select(0, order))
                for b, g in zip(tree_flatten(w.blobs)[0],
                                tree_flatten(state.blobs)[0]):
                    b.copy_(g.index_select(0, order))
                if acc_count is not None:
                    w.count.copy_(acc_count.index_select(0, order))
            w.nexp_sum.zero_()
            w.ncon_sum.zero_()

        loops.segment(("start",), start)
        for split in range(self.nsplits):
            log_u = None if log_acc_u is None else log_acc_u[split]
            self._group(loops, w, rng, ens, split, ng, model, carry, log_u)

        def end():
            if shuffled:
                order = w.order
                state.coords.index_copy_(0, order, w.coords)
                state.log_prob.index_copy_(0, order, w.log_prob)
                for b, g in zip(tree_flatten(state.blobs)[0],
                                tree_flatten(w.blobs)[0]):
                    b.index_copy_(0, order, g)
                if acc_count is not None:
                    acc_count.index_copy_(0, order, w.count)
                accepted.index_copy_(0, order, w.accepted)
            self._finish(carry, state, model, [(w.nexp_sum, w.ncon_sum)])

        loops.segment(("end",), end)
        return state, accepted, carry

    def _group(self, loops, w, rng, ens, split, ng, model, carry, log_u):
        """Stepping out, then shrinkage, for group ``split`` of ``ens``
        ``(coords, log_prob, blobs, count, accepted)``; the group's rows
        are updated in place."""
        coords, log_prob, blobs, count, accepted = ens
        seed, offset = rng
        nw = coords.shape[0]
        nc = nw - ng
        lo = split * ng
        dev, dt = coords.device, coords.dtype
        s, lp_s = coords[lo:lo + ng], log_prob[lo:lo + ng]
        blobs_s = tree_map(lambda b: b[lo:lo + ng], blobs)

        def setup():
            u = row_uniforms(ng, 4, seed, offset, dev, dt, row0=lo,
                             block=SLICE_BLOCK)
            i = torch.clamp((u[:, 0] * nc).to(torch.int64), max=nc - 1)
            j = torch.clamp((u[:, 1] * (nc - 1)).to(torch.int64),
                            max=nc - 2)
            j = torch.where(j >= i, j + 1, j)
            ci = coords.index_select(0, complement_rows(i, split, ng))
            cj = coords.index_select(0, complement_rows(j, split, ng))
            # Read from the carry here, inside the segment, so a replay
            # reads the tuned scale of its own proposal.
            scale = self._tuned_scale(carry, dt)
            mu = float(np.float32(self.mu))
            if scale is not None:
                mu = mu * scale
            w.eta.copy_(mu * (ci - cj))
            lu = log_u
            if lu is None:
                lu = torch.log(to_uniform(
                    walker_words(ng, split, seed, offset, dev)[1], dt))
            w.y.copy_(lp_s + lu)
            w.left.copy_(-u[:, 2])
            w.right.copy_(w.left + 1.0)
            j_l = torch.clamp((u[:, 3] * self.max_steps).to(torch.int32),
                              max=self.max_steps - 1)
            w.j_l.copy_(j_l)
            w.j_r.copy_((self.max_steps - 1) - j_l)
            w.exp_l.fill_(True)
            w.exp_r.fill_(True)
            w.cnt_l.zero_()
            w.cnt_r.zero_()
            w.nexp.zero_()
            w.it.zero_()
            w.flag.fill_(self.max_steps > 0)

        def step_out(b, block):
            go = (w.it < self.max_steps) & (w.exp_l.any() | w.exp_r.any())
            both = torch.cat((s + w.left[:, None] * w.eta,
                              s + w.right[:, None] * w.eta))
            lp2, _ = model.compute_log_prob(both)
            need_l = go & w.exp_l & (w.cnt_l < w.j_l)
            need_r = go & w.exp_r & (w.cnt_r < w.j_r)
            if self.count_evals:
                w.evals[0].add_(need_l.sum() + need_r.sum())
            in_l = need_l & (lp2[:ng] > w.y)
            in_r = need_r & (lp2[ng:] > w.y)
            w.nexp.add_(in_l.sum(dtype=torch.float32)
                        + in_r.sum(dtype=torch.float32))
            w.left.sub_(in_l.to(dt))
            w.right.add_(in_r.to(dt))
            w.exp_l.copy_(in_l)
            w.exp_r.copy_(in_r)
            w.cnt_l.add_(in_l.to(torch.int32))
            w.cnt_r.add_(in_r.to(torch.int32))
            w.it.add_(go.to(torch.int64))
            w.iterations[0].add_(go.to(torch.int64))
            w.executed[0].add_(1)
            w.flag.copy_((w.it < self.max_steps) & (in_l.any() | in_r.any()))

        def shrink_setup():
            w.t_acc.zero_()
            w.lp_acc.copy_(lp_s)
            for a, b in zip(tree_flatten(w.blobs_acc)[0],
                            tree_flatten(blobs_s)[0]):
                a.copy_(b)
            w.done.zero_()
            w.ncon.zero_()
            w.it.zero_()
            w.flag.fill_(self.max_shrink > 0)

        def shrink(b, block):
            go = (w.it < self.max_shrink) & ~w.done.all()
            if block > w.shrink_u.shape[1]:
                raise ValueError(f"loop_block must be at most "
                                 f"{w.shrink_u.shape[1]}")
            if b == 0:
                # The block's uniforms in one Philox call: iteration b of
                # a block that runs unmasked has it = it0 + b.
                w.shrink_u[:, :block] = to_uniform(row_words(
                    ng, block, SHRINK_BLOCK | w.it, seed, offset, dev,
                    lo)[0], dt)
            t = w.left + w.shrink_u[:, b] * (w.right - w.left)
            lp_t, blobs_t = model.compute_log_prob(s + t[:, None] * w.eta)
            if blobs_t is not None and blobs_s is None:
                raise ValueError(
                    "If you start sampling with a given log_prob, you "
                    "also need to provide the current list of blobs at "
                    "that position."
                )
            ok = lp_t > w.y
            if self.count_evals:
                w.evals[1].add_((go & ~w.done).sum())
            newly = go & ok & ~w.done
            w.t_acc.copy_(torch.where(newly, t, w.t_acc))
            w.lp_acc.copy_(torch.where(newly, lp_t, w.lp_acc))
            if blobs_t is not None:
                for a, b in zip(tree_flatten(w.blobs_acc)[0],
                                tree_flatten(blobs_t)[0]):
                    m = newly.view((ng,) + (1,) * (a.dim() - 1))
                    a.copy_(torch.where(m, b, a))
            miss = go & ~ok & ~w.done
            w.ncon.add_(miss.sum(dtype=torch.float32))
            w.left.copy_(torch.where(miss & (t < 0), t, w.left))
            w.right.copy_(torch.where(miss & (t >= 0), t, w.right))
            w.done.copy_(w.done | (go & ok))
            w.it.add_(go.to(torch.int64))
            w.iterations[1].add_(go.to(torch.int64))
            w.executed[1].add_(1)
            w.flag.copy_((w.it < self.max_shrink) & ~w.done.all())

        def finish():
            done = w.done
            s.copy_(torch.where(done[:, None], s + w.t_acc[:, None] * w.eta,
                                s))
            lp_s.copy_(torch.where(done, w.lp_acc, lp_s))
            for b, a in zip(tree_flatten(blobs_s)[0],
                            tree_flatten(w.blobs_acc)[0]):
                b.copy_(a)
            accepted[lo:lo + ng] = done
            if count is not None:
                count[lo:lo + ng] += done
            w.nexp_sum.add_(w.nexp)
            w.ncon_sum.add_(w.ncon)

        loops.segment(("setup", split), setup)
        loops.loop(("step out", split), step_out, w.flag,
                   start=self.max_steps > 0)
        loops.segment(("shrink setup", split), shrink_setup)
        loops.loop(("shrink", split), shrink, w.flag,
                   start=self.max_shrink > 0)
        loops.segment(("finish", split), finish)
