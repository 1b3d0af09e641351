"""Red-blue ensemble-split proposal engine.

The counterpart of ``emcee_tpu/moves/red_blue.py:42-355``.  The ensemble
is split into ``nsplits`` groups; each group is updated against the
frozen others, so detailed balance holds (Foreman-Mackey et al. 2013,
Algorithm 2).  Per split the engine runs K1 (the concrete move's
proposal), the user's log-prob, and K2 (accept/select, written in place
into the ensemble buffer).

* ``randomize_split=False`` (blocked): group j is the contiguous rows
  ``[j*ng, (j+1)*ng)``; K1 reads its complement in place and K2 writes
  its rows in place.  No gather, no scatter, no sort.
* ``randomize_split=True`` (shuffled, the reference default): group
  membership is a permutation drawn from the ``(seed, offset)`` stream
  (a stable argsort of Philox word 3, computed on the walkers' device
  from the offset, which may be a device word, so the CPU and the card
  draw the same one and nothing waits for the host); the ensemble is
  gathered into contiguous buffers in group order, the blocked engine
  runs on them, and the rows are scattered back.  Group j is
  ``perm[j::nsplits]``, as in the JAX package.  On the card the keys are
  K14's (``ops/philox_kernel.py``), the order K16's and the rows K17's
  (``ops/shuffle_kernel.py``): one launch writes the rows in group order,
  one gathers every buffer (coordinates, log-probs, the acceptance
  count, every blob leaf) and one scatters them back with the
  acceptance.

Adaptive moves (``wants_carry``) read the move carry in
``get_proposal(..., carry=)``, and :meth:`RedBlueMove.update_carry` folds
the post-accept ensemble into it once per proposal, after all splits,
on both engines and whatever the ``tune`` flag
(``emcee_tpu/moves/red_blue.py:70-75, 162-167``).  A move whose
``_inner`` returns per-split statistics has them folded by
``_fold_split_stats`` after that (``:169-210``).  Carries are dicts of
tensors of any shape, updated in place, so a recorded graph reads and
writes the same storage at every replay.

The rung axis (parallel tempering, ``emcee_tpu/parallel/tempering.py:
476-541``, which vmaps one move over the ladder): a move that sets
``rung_batched`` (the stretch, DE, DE-snooker, side, walk, KDE, DIME,
DE-Z, blended and the ensemble MALA and HMC moves; ``moves/gradient.py``
has the whole-ensemble MALA and HMC moves' own ``propose_rungs``,
``moves/mh.py`` the MH and Gaussian moves' and ``moves/slice.py`` the
slice move's, over K9's loops) proposes every
rung of a ladder at once with :meth:`RedBlueMove.propose_rungs`.  The
state's buffers are then ``(T, nwalkers, ...)``, ``rng`` is ``(keys,
offset)`` with ``keys`` the rungs' :class:`~..ops.philox.RungKeys`, and
the model evaluates the ``(T, ng, ndim)`` proposals of every rung in one
call.  Each split runs the move's proposal kernels (K1, K5a or K5b; the
side move's K5a; the walk move's K8a, K8b and K18a, or K18b; the
ensemble gradient moves' K11-K13 between their gradients; the KDE move's
K7; DIME's K8a-K8c; DE-Z's K10a and K10b, and K10c once a proposal; the
blend's sub-moves' kernels and K20) and
K2 once for all rungs, and a tuned move's scale is ``(T,)``, each
rung's from its own carry; the shuffled split draws one permutation per
rung (a stable argsort along the walker axis of each rung's Philox
word 3, under its own key: one launch of K16 for every rung), gathers
with the flat indices ``r * nwalkers + perm`` and scatters back (one
launch of K17 each way).  Rung ``r`` ends exactly as :meth:`propose`
of rung ``r`` alone under its own key would leave it (up to the rounding
of the ensemble gradient moves' and the KDE move's batched products,
``ROADMAP.md`` section 3).

Blobs ride with the coordinates: ``state.blobs`` is a pytree of
``(nwalkers, ...)`` buffers, and K2 writes each accepted walker's new
blob row into them in the same launch as its coordinates (the JAX
package's ``tree_where`` and write-back, ``red_blue.py:200-202``,
``:323-344``); the shuffled path gathers and scatters every leaf in the
same K17 launches as the coordinates.
"""

from __future__ import annotations

import torch

from ..ops import accept_kernel, shuffle_kernel
from ..ops.philox import rung_words, split_seed, walker_words
from ..utils import tree_flatten, tree_unflatten
from .base import Move, ScaleTunable, blob_pairs

__all__ = ["RedBlueMove", "rung_shuffled_order", "shuffled_order"]


def shuffled_order(rng, nwalkers, nsplits, device, out=None):
    """Walker rows in group order for the shuffled split: the rows of
    group j are ``order[j*ng:(j+1)*ng]`` (K16 on the card; written into
    ``out`` where given)."""
    seed, offset = rng
    w3 = walker_words(nwalkers, nsplits, seed, offset, device, word=3)
    return shuffle_kernel.group_order(w3, nsplits, out=out)


def rung_shuffled_order(rng, ntemps, nwalkers, nsplits, device):
    """:func:`shuffled_order` of every rung under its own key (``rng`` is
    ``(RungKeys, offset)``), as flat rows of the ``(ntemps * nwalkers,
    ...)`` buffers: rung ``r``'s order plus ``r * nwalkers``."""
    keys, offset = rng
    w3 = rung_words(keys, nwalkers, nsplits, offset, device, word=3)
    return shuffle_kernel.group_order(w3.view(ntemps, nwalkers), nsplits)


class RedBlueMove(ScaleTunable, Move):
    """Abstract parallelizable ensemble move.

    Args:
        nsplits: Number of sub-ensembles (reference default 2).
        randomize_split: Shuffle group membership every proposal
            (reference default True).  ``False`` selects the blocked
            path.
        live_dangerously: Skip the ``nwalkers >= 2 * ndim`` guard.
        tune_target: optional target acceptance rate for
            ``run_mcmc(..., tune=True)`` (tunable moves only).
        tune_rate: adaptation step size (decays as ``1/sqrt(t)``).

    A move written outside the port implements the JAX package's hook,
    ``get_proposal(key, s, c_parts, model, **kw) -> (q, factors)``
    (``docs/moves.md``, "Writing your own move"): ``s`` is the ``(ng,
    ndim)`` group being updated and ``c_parts`` the tuple of the other
    groups, in group order (views of the ensemble buffer, which the
    shuffled split has gathered into group order first); ``kw`` holds
    ``extra=``, ``scale=`` and ``carry=`` only where they are set, as
    ``emcee_tpu/moves/red_blue.py:188-195`` passes them.  ``key`` is the
    port's ``(seed, offset)``: ``seed`` the group's own key
    (:func:`~..ops.philox.split_seed` of the chain's key and the split,
    as the JAX package gives each split its own key), ``offset`` the
    proposal's (an int, or a device word inside a recorded graph).  The
    proposal draws with ``ops/philox.py``'s helpers under it:
    ``row_uniforms(ng, k, seed, offset, s.device)`` and ``normals(ng, k,
    seed, offset, s.device)`` (rows 0 .. ng - 1), or ``word_uniforms``;
    it must not read the offset on the host.  Such a move is not
    ``rung_batched``: a ladder runs it rung by rung.

    The port's own moves keep a hook of their own, ``get_proposal(rng,
    coords, split, model, extra=None, scale=None) -> (q, factors)`` for
    group ``split`` of the contiguous ensemble buffer ``coords`` (and
    ``carry=`` where they set ``wants_carry``): their kernels read the
    rows in place.  The class that defines ``get_proposal`` decides which
    hook a move has (:attr:`_jax_hook`).
    """

    tunable = False
    #: adaptive moves opt in: ``get_proposal`` receives ``carry=`` and
    #: :meth:`update_carry` runs once per proposal, after all splits
    wants_carry = False
    #: moves that couple parameter dimensions set this False (read once
    #: the parameter axis can be sharded, ROADMAP P13)
    _param_shard_ok = True
    #: False for moves whose update is not a ``(q, factors)`` proposal
    #: sharing one log-prob evaluation (``BlendedMove`` refuses them)
    blendable = True
    #: True for moves whose kernels take the rung axis, so that
    #: :meth:`propose_rungs` proposes every rung of a ladder at once
    rung_batched = False
    #: True where ``get_proposal`` is defined outside the port's moves
    #: package: it then has the JAX package's shape (the class docstring)
    _jax_hook = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "get_proposal" in vars(cls):
            cls._jax_hook = not cls.__module__.startswith(__package__ + ".")
        if cls._jax_hook:
            cls.rung_batched = False

    def __init__(self, nsplits=2, randomize_split=True, live_dangerously=False,
                 tune_target=None, tune_rate=0.2):
        self.nsplits = int(nsplits)
        self.randomize_split = bool(randomize_split)
        self.live_dangerously = bool(live_dangerously)
        if tune_target is not None and not self.tunable:
            raise ValueError(
                f"{type(self).__name__} does not support tune_target "
                "(no adaptable proposal scale)"
            )
        self.tune_target = tune_target
        self.tune_rate = float(tune_rate)

    def get_proposal(self, rng, coords, split, model, extra=None,
                     scale=None):
        raise NotImplementedError(
            "The proposal must be implemented by subclasses"
        )

    def _split_proposal(self, rng, coords, split, model, extra=None,
                        scale=None, **kw):
        """``(q, factors)`` of group ``split`` of ``coords`` through the
        move's own hook: the port's, or the JAX package's shape for a
        move written outside the port (the class docstring)."""
        if not self._jax_hook:
            return self.get_proposal(rng, coords, split, model, extra=extra,
                                     scale=scale, **kw)
        ng = coords.shape[0] // self.nsplits
        parts = [coords[j * ng:(j + 1) * ng] for j in range(self.nsplits)]
        if extra is not None:
            kw["extra"] = extra
        if scale is not None:
            kw["scale"] = scale
        seed, offset = rng
        q, factors = self.get_proposal(
            (split_seed(seed, split), offset), parts[split],
            tuple(parts[:split] + parts[split + 1:]), model, **kw)
        return q.contiguous(), factors.to(coords.dtype).contiguous()

    def update_carry(self, carry, state, model):
        """Post-proposal adaptation of the carry, in place (``wants_carry``
        moves); ``state`` is the post-accept ensemble.  Runs every
        proposal, independent of the ``tune`` flag."""
        return carry

    def _fold_split_stats(self, carry, stats, model):
        """Fold the per-split statistics ``_inner`` returned (a list, one
        entry per split) into the carry, in place; default: ignore."""
        return carry

    def _finish(self, carry, state, model, stats):
        """What follows the splits of a proposal: :meth:`update_carry`,
        then the per-split statistics' fold."""
        if self.wants_carry:
            carry = self.update_carry(carry, state, model)
        if stats:
            carry = self._fold_split_stats(carry, stats, model)
        return carry

    def _check_split(self, nwalkers, ndim, model):
        """The red-blue guards; returns the split size ``ng``."""
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
        return nwalkers // self.nsplits

    def propose(self, rng, state, model, carry, acc_count=None,
                accepted=None):
        ng = self._check_split(*state.coords.shape, model)
        scale = self._tuned_scale(carry, state.coords.dtype)
        if self.randomize_split:
            return self._propose_shuffled(
                rng, state, model, carry, ng, scale, acc_count, accepted)
        return self._propose_blocked(
            rng, state, model, carry, ng, scale, acc_count, accepted=accepted)

    def propose_rungs(self, rng, state, model, carry, acc_count=None,
                      accepted=None):
        """One proposal of every rung of a ladder (``rung_batched`` moves):
        ``state``'s buffers are ``(T, nwalkers, ...)``, ``rng`` is
        ``(RungKeys, offset)``, ``model.compute_log_prob`` maps ``(T, n,
        ndim)`` proposals to ``(T, n)`` log-probs and blobs, the carry's
        tensors have a leading ``T`` axis, and ``acc_count`` and
        ``accepted`` are ``(T, nwalkers)``.  Returns ``(state, accepted,
        carry)``."""
        if not self.rung_batched:
            raise ValueError(f"{type(self).__name__} proposes one ensemble "
                             "at a time")
        ng = self._check_split(*state.coords.shape[1:], model)
        scale = self._tuned_scale(carry, state.coords.dtype)
        if self.randomize_split:
            return self._propose_shuffled(
                rng, state, model, carry, ng, scale, acc_count, accepted)
        return self._propose_blocked(rng, state, model, carry, ng, scale,
                                     acc_count, accepted=accepted)

    def _inner(self, rng, coords, log_prob, split, model, accepted,
               acc_count=None, log_u=None, extra=None, scale=None,
               blobs=None, carry=None):
        """Propose (K1), evaluate, and accept (K2) for one group; the
        group's rows of ``coords``/``log_prob``/``accepted`` and of every
        leaf of ``blobs`` are updated in place.  Returns the split's
        tuning statistics for :meth:`_fold_split_stats` (None here)."""
        kw = {"carry": carry} if self.wants_carry else {}
        q, factors = self._split_proposal(
            rng, coords, split, model, extra=extra, scale=scale, **kw
        )
        new_lp, new_blobs = model.compute_log_prob(q)
        seed, offset = rng
        accept_kernel.accept_select(
            q, factors, new_lp, coords, log_prob, split, self.nsplits,
            accepted, acc_count, seed=seed, offset=offset, log_u=log_u,
            blobs=blob_pairs(new_blobs, blobs),
        )
        return None

    def _propose_blocked(self, rng, state, model, carry, ng, scale=None,
                         acc_count=None, log_acc_u=None, extra_u=None,
                         accepted=None, stats=None):
        """Fixed contiguous-block membership; ``log_acc_u``
        ``(nsplits, ng)`` and ``extra_u`` ``(nsplits, n_extra)`` inject
        the uniforms (parity mode), as in the JAX package.  ``accepted``:
        the ``(nwalkers,)`` bool buffer K2 writes (a new one if None).
        ``stats``: a list that collects the splits' statistics, for a
        caller that finishes the proposal itself (the shuffled engine,
        after its scatter); without one, the carry is finished here."""
        if accepted is None:
            accepted = torch.empty(
                state.coords.shape[:-1], dtype=torch.bool,
                device=state.coords.device,
            )
        collected = [] if stats is None else stats
        for split in range(self.nsplits):
            st = self._inner(
                rng, state.coords, state.log_prob, split, model, accepted,
                acc_count,
                log_u=None if log_acc_u is None else log_acc_u[split],
                extra=None if extra_u is None else extra_u[split],
                scale=scale, blobs=state.blobs, carry=carry,
            )
            if st is not None:
                collected.append(st)
        if stats is None:
            carry = self._finish(carry, state, model, collected)
        return state, accepted, carry

    def _propose_shuffled(self, rng, state, model, carry, ng, scale=None,
                          acc_count=None, accepted=None, extra_u=None,
                          log_acc_u=None):
        """Random membership: gather into group order, run the blocked
        engine, scatter back.  On the rung axis (``(T, nwalkers, ...)``
        buffers) every rung has its own order, and the gathers and
        scatters run over the flat ``(T * nwalkers, ...)`` rows.
        ``log_acc_u`` and ``extra_u`` inject the uniforms of each split's
        members in group order (the parity mode)."""
        coords, log_prob = state.coords, state.log_prob
        k = coords.dim() - 1  # the walker axes: (nwalkers,) or (T, nwalkers)
        if k == 2:
            order = rung_shuffled_order(rng, *coords.shape[:2], self.nsplits,
                                        coords.device)
        else:
            order = shuffled_order(
                rng, coords.shape[0], self.nsplits, coords.device
            )

        def flat(x):  # the rows of x as one axis (a view)
            return x if k == 1 else x.view((-1,) + tuple(x.shape[k:]))

        leaves, treedef = tree_flatten(state.blobs)
        ens = [coords, log_prob, *leaves]
        if acc_count is not None:
            ens.append(acc_count)
        rows = shuffle_kernel.gather_rows(order, [flat(x) for x in ens])
        rows = [r.view(x.shape) for r, x in zip(rows, ens)]
        buf = state._replace(
            coords=rows[0], log_prob=rows[1],
            blobs=tree_unflatten(treedef, rows[2:2 + len(leaves)]),
        )
        count = None if acc_count is None else rows[-1]
        stats = []
        _, acc_buf, carry = self._propose_blocked(
            rng, buf, model, carry, ng, scale, count, log_acc_u=log_acc_u,
            extra_u=extra_u, stats=stats
        )
        if accepted is None:
            accepted = torch.empty_like(acc_buf)
        shuffle_kernel.scatter_rows(
            order, [flat(x) for x in ens + [accepted]],
            [flat(x) for x in rows + [acc_buf]])
        # The carry sees the ensemble in walker order, as in the JAX
        # package (DE-Z's subsample picks rows by index).
        carry = self._finish(carry, state, model, stats)
        return state, accepted, carry
