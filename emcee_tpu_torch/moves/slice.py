"""Ensemble slice sampling (zeus-style).

The counterpart of ``emcee_tpu/moves/slice.py:45-299`` (Karamanis &
Beutler 2021): each red-blue group slice-samples along ``eta = mu * (c_i
- c_j)`` with Neal's (2003) stepping-out and shrinkage on the slice
``{t : log pi(s + t eta) > y}``, ``y = log pi(s) + log U``, where U is
the accept uniform K2 would read (word 1 at ``(walker, split)``).  Every
walker that lands moves; ``done`` is reported as ``accepted``.  With
``tune_mu`` the carry ``{log_adj, t, frac_expand}`` adapts ``mu`` so
expansions balance contractions.

Both loops run a data-dependent number of trips, which a recorded CUDA
graph cannot.  K9 (``ops/slice_kernel.py``, ``csrc/slice_loops.cu``)
runs them on lists: a group's setup (K9a) lists the ends that need an
evaluation, each stepping-out trip (K9b) evaluates the listed ends and
keeps those still expanding, the shrink setup (K9c's first form) lists
every walker, each shrink trip (K9c) evaluates the listed walkers and
keeps those not yet landed, and the finish (K9d) writes the group's rows.
A walker's path depends only on its own values and its own trip number,
so each ends as in the JAX loops, where every walker evaluates in every
trip.  The proposal is a short host loop (``chunk_graph.py``
:meth:`~..chunk_graph.GraphLoops.compacted` on the card,
:meth:`~..chunk_graph.EagerLoops.compacted` otherwise): segments of
straight-line work, and per loop blocks of ``loop_block`` trips, each at
the smallest bucket of evaluation rows that holds the longest list when
the block begins, until one read of the lists' lengths a block says every
list is empty.  The loop state lives in persistent buffers
(:class:`_Work`), written in place, so every recorded segment reads what
the last wrote.

The rung axis: the move is ``rung_batched``.  :meth:`propose_rungs`
proposes every rung of a ladder at once, each rung's lists in its own
rows of one ``(T, bucket, ndim)`` batch, its own counters and its own key
at the one-ensemble counters, so every rung ends as that rung alone, and
one read of the lengths a block serves every rung (JAX vmaps the move,
``emcee_tpu/parallel/tempering.py:449-541``, so one ``while_loop`` serves
every rung, each masked once it is done).

The draws (in K9a and K9c): the pair ``i, j``, the window offset and the
budget split ``jL`` at ``(row, SLICE_BLOCK)``; shrink trip ``it``'s
uniform from word 0 at ``(row, SHRINK_BLOCK | it)``.
"""

from __future__ import annotations

import torch

from ..chunk_graph import BUCKET_FLOOR, EagerLoops
from ..ops import shuffle_kernel, slice_kernel
from ..ops.philox import SHRINK_MAX, rung_words
from ..utils import tree_flatten
from .base import robbins_monro_step
from .red_blue import RedBlueMove, shuffled_order

__all__ = ["EnsembleSliceMove"]

#: the most trips a loop graph holds
LOOP_BLOCK_MAX = 64


class _Work:
    """The slice move's persistent buffers for ``T`` ensembles of one
    shape: the shuffled split's gathered ensemble and K9's loop state
    (:class:`~..ops.slice_kernel.LoopState`; its counters are these
    attributes' views)."""

    def __init__(self, x, ng, leaves):
        T, nw, nd = x.shape

        def t(shape, dt=x.dtype):
            return torch.zeros(shape, dtype=dt, device=x.device)

        self.order = t(T * nw, torch.int64)
        self.coords, self.log_prob = t((T, nw, nd)), t((T, nw))
        self.count = t((T, nw), torch.int32)
        self.accepted = t((T, nw), torch.bool)
        self.blobs = [torch.zeros_like(b) for b in leaves]
        self.loop = slice_kernel.LoopState(T, ng, nd, x.dtype, x.device,
                                           leaves)
        # Rows past a list's length are evaluated and never read: finite
        # points from the start (the ensemble's first row).
        self.loop.pts.copy_(x[None, :, :1].expand_as(self.loop.pts))
        c = self.loop.counters
        #: iterations [stepping out, shrinkage] the JAX loops run, summed
        #: over groups (and rungs)
        self.iterations = c[0]
        #: K9b / K9c trips run (those of a block past the lists' end
        #: included)
        self.executed = c[1]
        #: evaluations [stepping out, shrinkage] a walker-by-walker loop
        #: needs, summed over walkers (only with ``count_evals``)
        self.evals = c[2]
        #: rows evaluated [stepping out, shrinkage], the buckets' padding
        #: included
        self.rows = c[3]


def _signature(x, leaves):
    return (tuple(x.shape), x.dtype, str(x.device),
            tuple((tuple(b.shape), b.dtype) for b in leaves))


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

    ``loop_block`` (an attribute, default 4, at most 64) is the trips a
    block replay runs on the card; ``bucket_floor`` (default
    ``chunk_graph.BUCKET_FLOOR``) the smallest bucket of evaluation rows
    a rung.  ``count_evals`` (an attribute, default False) counts the
    evaluations each walker needs into ``_Work.evals``: an end that is
    still expanding within its budget, a walker not yet landed.
    """

    tunable = True  # the carry's exp(log_adj) scales mu
    blendable = False
    #: the chunk program runs its proposal by block replays
    looped = True
    #: K9 takes the rung axis: a ladder proposes every rung at once
    rung_batched = True
    loop_block = 4
    bucket_floor = BUCKET_FLOOR
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
        over the splits' ``(nexp, ncon)`` (integer counts, or JAX's
        float32 sums), in place."""
        if not (self.tune_mu and isinstance(carry, dict)):
            return carry
        nexp = sum(s[0] for s in stats).to(torch.float32)
        ncon = sum(s[1] for s in stats).to(torch.float32)
        carry["frac_expand"].copy_(nexp / torch.clamp(nexp + ncon, min=1.0))
        return carry

    def tune(self, carry, state, accepted, model=None):
        if not self.tune_mu or not isinstance(carry, dict):
            return carry
        # frac_expand > 1/2: the window is too narrow, grow mu.
        err = 2.0 * (carry["frac_expand"] - 0.5)
        return robbins_monro_step(carry, err, self.tune_rate)

    def work(self, x, ng, leaves):
        """The persistent buffers for the ``(T, nw, nd)`` ensemble ``x``
        and its blob leaves (made on first use, which is eager: the chunk
        program warms up before it records)."""
        key = (ng, _signature(x, leaves))
        w = self._work.get(key)
        if w is None:
            w = self._work[key] = _Work(x, ng, leaves)
        return w

    def _config(self):
        return slice_kernel.SliceConfig(self.mu, self.max_steps,
                                        self.max_shrink, self.count_evals)

    def propose(self, rng, state, model, carry, acc_count=None,
                accepted=None, loops=None, log_acc_u=None, draws=None):
        """One slice update of every group.  ``loops`` runs the segments
        and loops (:class:`~..chunk_graph.EagerLoops` by default);
        ``log_acc_u`` ``(nsplits, ng)`` injects the slice levels'
        log-uniforms and ``draws`` (one dict a split, keys of
        ``slice_kernel.DRAWS`` but ``log_u`` and ``shrink_u``) the other
        draws (the parity mode)."""
        ng = self._check_split(*state.coords.shape, model)
        if accepted is None:
            accepted = torch.empty(state.coords.shape[0], dtype=torch.bool,
                                   device=state.coords.device)
        leaves = tree_flatten(state.blobs)[0]

        def evaluate(q):
            lp, blobs = model.compute_log_prob(q[0])
            return lp[None], [b[None] for b in tree_flatten(blobs)[0]]

        def fold(sums):
            self._finish(carry, state, model, [(sums[0, 0], sums[1, 0])])

        self._propose(
            rng, (state.coords[None], state.log_prob[None],
                  [b[None] for b in leaves],
                  None if acc_count is None else acc_count[None],
                  accepted[None]), evaluate, ng, carry, fold, loops,
            log_acc_u, draws)
        return state, accepted, carry

    def propose_rungs(self, rng, state, model, carry, acc_count=None,
                      accepted=None, loops=None):
        """One slice update of every group of every rung of a ladder:
        ``state``'s buffers are ``(T, nwalkers, ...)``, ``rng`` is
        ``(RungKeys, offset)``, ``model.compute_log_prob`` maps ``(T, n,
        ndim)`` rows to ``(T, n)`` log-probs and blobs, the carry's tensors
        are ``(T,)``; ``acc_count`` and ``accepted`` ``(T, nwalkers)``."""
        ng = self._check_split(*state.coords.shape[1:], model)
        if accepted is None:
            accepted = torch.empty(state.coords.shape[:2], dtype=torch.bool,
                                   device=state.coords.device)

        def evaluate(q):
            lp, blobs = model.compute_log_prob(q)
            return lp, tree_flatten(blobs)[0]

        def fold(sums):
            self._finish(carry, state, model, [tuple(sums)])

        self._propose(
            rng, (state.coords, state.log_prob,
                  tree_flatten(state.blobs)[0], acc_count, accepted),
            evaluate, ng, carry, fold, loops)
        return state, accepted, carry

    def _propose(self, rng, ens, evaluate, ng, carry, fold, loops=None,
                 log_acc_u=None, draws=None):
        """Every group of the ``(T, nw, ...)`` ensemble ``ens`` ``(coords,
        log_prob, blob leaves, count, accepted)``, the shuffled split's
        order, gather and scatter around them, then ``fold`` of the
        proposal's ``(2, T)`` expansions and contractions (the carry's
        update, in the last segment)."""
        if not 1 <= self.loop_block <= LOOP_BLOCK_MAX:
            raise ValueError(f"loop_block must be 1 to {LOOP_BLOCK_MAX}")
        loops = loops or EagerLoops()
        x, lp, leaves, count, accepted = ens
        T, nw, _ = x.shape
        w = self.work(x, ng, leaves)
        shuffled = self.randomize_split
        if shuffled:
            gathered = (w.coords, w.log_prob, w.blobs,
                        None if count is None else w.count, w.accepted)
        else:
            gathered = ens

        def flat(t):  # the rows of every rung as one axis (a view)
            return t.view((-1,) + tuple(t.shape[2:]))

        def pairs(*extra):
            """(ensemble buffer, workspace buffer) of every buffer the
            shuffled split moves, as flat rows."""
            out = [(x, w.coords), (lp, w.log_prob), *zip(leaves, w.blobs)]
            if count is not None:
                out.append((count, w.count))
            return [[flat(t) for t in c] for c in zip(*out, *extra)]

        def start():
            if shuffled:
                seed, offset = rng
                if isinstance(seed, int):
                    shuffled_order(rng, nw, self.nsplits, x.device,
                                   out=w.order)
                else:
                    w3 = rung_words(seed, nw, self.nsplits, offset, x.device,
                                    word=3)
                    shuffle_kernel.group_order(w3.view(T, nw), self.nsplits,
                                               out=w.order)
                shuffle_kernel.gather_rows(w.order, *pairs())
            w.loop.sums.zero_()

        loops.segment(("start",), start)
        for split in range(self.nsplits):
            log_u = None if log_acc_u is None else log_acc_u[split]
            self._group(loops, w, rng, gathered, split, ng, evaluate, carry,
                        log_u, None if draws is None else draws[split])

        def end():
            if shuffled:
                shuffle_kernel.scatter_rows(
                    w.order, *pairs((accepted, w.accepted)))
            fold(w.loop.sums)

        loops.segment(("end",), end)

    def _group(self, loops, w, rng, ens, split, ng, evaluate, carry, log_u,
               draws):
        """Stepping out, then shrinkage, for group ``split`` of ``ens``
        ``(coords, log_prob, blob leaves, count, accepted)`` (``(T, nw,
        ...)`` buffers); the group's rows are updated in place."""
        x, lp, leaves, count, accepted = ens
        seed, offset = rng
        st, cfg, ns = w.loop, self._config(), self.nsplits
        T = x.shape[0]
        extra = dict(draws or {})
        shrink_u = extra.pop("shrink_u", None)
        if log_u is not None:
            extra["log_u"] = log_u.reshape(T, ng)

        def setup():
            # The tuned scale is read from the carry here, inside the
            # segment, so a replay reads its own proposal's.
            scale = self._tuned_scale(carry, x.dtype)
            slice_kernel.slice_setup(x, lp, split, ns, st, seed, offset, cfg,
                                     scale=scale, extra=extra)

        def step_out(b, block, bucket, parity):
            q = st.pts[parity][:, :bucket]
            lp_q, _ = evaluate(q)
            slice_kernel.slice_step_out(x, lp_q, split, ns, st, bucket,
                                        parity, cfg)

        def shrink_setup():
            slice_kernel.slice_shrink(x, None, [], split, ns, st, 0, 0, seed,
                                      offset, cfg, shrink_u)

        def shrink(b, block, bucket, parity):
            q = st.pts[parity][:, :bucket]
            lp_q, blobs_q = evaluate(q)
            if len(blobs_q) != len(leaves):
                raise ValueError(
                    "If you start sampling with a given log_prob, you "
                    "also need to provide the current list of blobs at "
                    "that position." if not leaves else
                    "inconsistent use of blobs: the log-prob's blob "
                    "structure differs from the state's")
            slice_kernel.slice_shrink(x, lp_q, blobs_q, split, ns, st, bucket,
                                      parity, seed, offset, cfg, shrink_u)

        def finish():
            slice_kernel.slice_finish(x, lp, split, ns, st, accepted, count,
                                      leaves)

        loops.segment(("setup", split), setup)
        loops.compacted(("step out", split), step_out, st.length(), 2 * ng,
                        self.bucket_floor, start=self.max_steps > 1)
        loops.segment(("shrink setup", split), shrink_setup)
        loops.compacted(("shrink", split), shrink, st.length(), ng,
                        self.bucket_floor, start=self.max_shrink > 0)
        loops.segment(("finish", split), finish)
