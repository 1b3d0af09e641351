"""Gradient moves: MALA and HMC on ``torch.func.grad``.

The counterpart of ``emcee_tpu/moves/gradient.py``: the user's log-prob
is differentiated by ``torch.func.grad`` through the same wrapped
callable every other move evaluates (``model.log_prob_for_grad()``), and

* :class:`MALAMove` -- Metropolis-adjusted Langevin: drift along the
  gradient plus Gaussian noise, with the exact asymmetric-proposal
  correction; two gradient evaluations a proposal;
* :class:`HMCMove` -- ``n_leapfrog`` velocity-Verlet steps from fresh
  momenta, accepted by the Hamiltonian difference; ``n_leapfrog + 1``
  gradient evaluations a proposal;
* :class:`ChEESHMCMove` -- HMC whose trajectory length adapts across
  the ensemble by Adam ascent on the ChEES criterion (Hoffman, Radul &
  Sountsov 2021);
* :class:`EnsembleMALAMove` / :class:`EnsembleHMCMove` -- red-blue MALA
  and HMC whose metric is the complementary group's sample covariance.

The fused chains between the gradient evaluations are the port's
kernels (``ops/langevin_kernel.py``): K11 draws the normals (and makes
the MALA proposal), K13 runs the leapfrog's kicks and drifts, K12 the
Hastings factor or kinetic-energy difference per walker, and K2
accepts (``nsplits=1`` for the whole-ensemble moves, as ``MHMove``).  The
full preconditioners' products by ``L`` are ``torch.matmul`` calls in
full float32 between kernel launches, as the JAX package leaves them to
XLA's plain ``@``.

The current state's gradient is recomputed every proposal, never cached
(``gradient.py:64-69``: a tempering swap would leave a cached one
stale).  At the proposed point the log-prob, its blobs and its gradient
come from one forward pass (:func:`batch_value_and_grad`).

The draws (``ops/philox.py``): the noise ``z`` and the momenta at
``NORMAL_BLOCK`` (rows of the proposal's ensemble buffer), the accept
uniform K2's (word 1 at ``(walker, split)``), a proposal's step-size
jitter word 0 at ``(ROLL_LANE, GRAD_BLOCK | split)``, drawn by the
momenta's K11 launch (a plain Philox call for one scalar is ~110 small
kernels, ~134 us of device time on an NVIDIA H100 80GB HBM3 at 700 W).
Each move takes ``extra=`` to inject them (``z``; ``p0`` and the
jitter's ``v`` in ``[-1, 1)``) and the whole-ensemble moves ``log_u=``
(the parity mode).

ChEES's trip count ``ceil(u T / eps)`` (clipped to ``[1,
max_leapfrog]``) is a device word, known before its loop starts, so the
move is ``looped``: K21a (``ops/chees_kernel.py`` ``chees_start``) writes
it with the step size and jitter, the chunk program reads it once a
proposal and replays a one-step leapfrog graph that many times
(``chunk_graph.GraphLoops.repeat``); eagerly the loop is
``EagerLoops.repeat``, the JAX ``while_loop``'s steps one by one.  A
tuning proposal's ChEES gradient is K21b (``chees_gradient``).

On a tempered ladder (``emcee_tpu/parallel/tempering.py:538`` vmaps every
move over the rungs) every move here is ``rung_batched``: one proposal of
every rung at once (``propose_rungs``), the state ``(T, nwalkers,
ndim)``, ``rng`` ``(RungKeys, offset)``, the step size ``(T,)`` (each
rung's tuned scale), one gradient of the tempered log-prob over ``T * n``
rows, and K11, K12, K13 and K2 launched once a step for every rung (their
rung axes).  ChEES reads the largest of the rungs' trip counts once and
replays that many trips, each rung stepping (K13's masked rung mode) only
while it has trips left, as JAX's vmapped ``while_loop`` masks a finished
rung.  Rung ``r`` ends exactly as the same move on rung ``r`` alone under
its own key would leave it; where the full metrics' and the ensemble
moves' products by ``L`` run as one batched ``torch.matmul`` they may
round otherwise than the rung's own (``ROADMAP.md`` section 3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..chunk_graph import EagerLoops
from ..ops import accept_kernel, chees_kernel, langevin_kernel
from ..ops.chees_kernel import van_der_corput
from ..utils import tree_flatten, tree_unflatten
from .base import Move, ScaleTunable, blob_pairs, robbins_monro_tune
from .dime import full_float32
from .red_blue import RedBlueMove
from .walk import cholesky_or_nan, complement

__all__ = [
    "ChEESHMCMove",
    "EnsembleHMCMove",
    "EnsembleMALAMove",
    "HMCMove",
    "MALAMove",
    "batch_grad",
    "batch_value_and_grad",
    "van_der_corput",
]


def _grad_fn(model):
    """The callable gradient moves differentiate, or the JAX package's
    refusal (``gradient.py:71-83``)."""
    if not model.grad_ok:
        raise NotImplementedError(
            "gradient moves need a differentiable log-prob; this model's "
            "log-prob cannot be differentiated (host evaluation) -- use a "
            "log_prob_fn written in torch operations"
        )
    return model.log_prob_for_grad()


def batch_grad(model):
    """``x -> d sum(log-prob) / dx``: the per-walker log-probs decouple, so
    the gradient of their sum is the stack of per-walker gradients (one
    backward pass for the ensemble); blobs are discarded."""
    fn = _grad_fn(model)

    def total(x):
        return fn(x)[0].sum()

    grad = torch.func.grad(total)
    return lambda x: grad(x).contiguous()


def batch_value_and_grad(model):
    """``q -> (log_prob, blobs, gradient)`` from one forward pass of the
    log-prob (the pass XLA's CSE shares between ``compute_log_prob(q)``
    and ``grad(q)`` in the JAX package).  The blobs cross
    ``torch.func.grad`` as flat leaves, rebuilt after it."""
    fn = _grad_fn(model)
    treedef = []

    def total(q):
        lp, blobs = fn(q)
        leaves, d = tree_flatten(blobs)
        treedef.append(d)
        return lp.sum(), (lp, tuple(leaves))

    grad = torch.func.grad(total, has_aux=True)

    def value_and_grad(q):
        del treedef[:]
        g, (lp, leaves) = grad(q)
        return lp, tree_unflatten(treedef[0], list(leaves)), g.contiguous()

    return value_and_grad


def _jittered(eps, jitter, v):
    """``eps (1 + jitter v)``, ``v`` in ``[-1, 1)``."""
    return eps * (1.0 + jitter * v)


class _Metric:
    """A preconditioner on one device: ``kind`` ``"id"``, ``"diag"`` (the
    scalar and vector ``cov``, ``d`` the ``(ndim,)`` diagonal of ``L``)
    or ``"full"`` (``L`` the ``(ndim, ndim)`` lower Cholesky factor)."""

    def __init__(self, kind, m):
        self.kind, self.m = kind, m

    @property
    def d(self):
        return self.m if self.kind == "diag" else None

    def apply_L(self, v):
        """``v -> v L^T`` (rows are walkers; a ``(T, d, d)`` ``L`` holds one
        factor a rung)."""
        if self.kind == "id":
            return v
        if self.kind == "diag":
            return v * self.m
        with full_float32():
            return v @ self.m.mT

    def apply_LT(self, v):
        """``v -> v L``: x-space gradients to y-space."""
        if self.kind == "full":
            with full_float32():
                return v @ self.m
        return self.apply_L(v)


def _leapfrog(metric, eps, p_in, p_out, g, kicks, x_in=None, x_out=None,
              mask=None):
    """K13: ``kicks`` half-kicks of ``p_in`` by ``g`` into ``p_out``, then
    the drift of ``x_in`` into ``x_out`` when given.  A full metric kicks
    with ``g L`` and drifts by a second launch with ``p L^T``.  ``mask``
    (a :class:`~..ops.langevin_kernel.TripMask`) steps only the rungs with
    trips left; the last launch ends the trip."""
    lf = langevin_kernel.leapfrog
    if metric.kind != "full":
        lf(p_in, g, eps, d=metric.d, kicks=kicks, x=x_in, x_out=x_out,
           p_out=p_out, mask=mask)
        return
    lf(p_in, metric.apply_LT(g), eps, kicks=kicks, p_out=p_out, mask=mask,
       advance=x_in is None)
    if x_in is not None:
        lf(metric.apply_L(p_out), None, eps, kicks=0, x=x_in, x_out=x_out,
           mask=mask)


def _draw(shape, device, seed, offset, row0, given):
    """K11's normals of rows ``row0 ..``, unless ``given``."""
    if given is not None:
        return given
    return langevin_kernel.langevin_step(shape, device, seed=seed,
                                         offset=offset, row0=row0)[0]


def _momenta(shape, device, rng, row0, split, extra, jitter):
    """An HMC proposal's momenta ``p0`` (rows ``row0 ..``) and, when
    ``jitter``, the jitter's ``v = 2 u - 1`` of ``split`` (else None; a
    ``(T,)`` one on the rung axis), both from one K11 launch; ``extra``
    injects either."""
    p0, v = extra.get("p0"), extra.get("v") if jitter else None
    if p0 is None or (jitter and v is None):
        seed, offset = rng
        out = None
        if jitter and v is None:
            out = v = torch.empty(shape[:-2], dtype=torch.float32,
                                  device=device)
        p0, _ = langevin_kernel.langevin_step(
            shape, device, seed=seed, offset=offset, row0=row0, z=p0, v=out,
            v_split=split)
    return p0, v


def _mala(x, g_x, eps, metric, value_and_grad, rng, z=None):
    """The MALA proposal of rows ``x`` (the whole ensemble): ``(q, factors,
    lp_q, blobs_q)``, through K11 (one launch that draws ``z`` and makes
    ``q``; for a full metric a draw, the torch.matmul products and a
    second launch) and K12.  ``z`` injects the noise."""
    k11 = langevin_kernel.langevin_step
    shape, dev = tuple(x.shape), x.device
    seed, offset = rng
    if metric.kind == "full":
        z = _draw(shape, dev, seed, offset, 0, z)
        a = metric.apply_L(metric.apply_LT(g_x))
        _, q = k11(shape, dev, z=metric.apply_L(z), x=x, g=a, eps=eps)
    else:
        z, q = k11(shape, dev, seed=seed, offset=offset, z=z, x=x, g=g_x,
                   eps=eps, d=metric.d)
    lp_q, blobs_q, g_q = value_and_grad(q)
    if metric.kind == "full":
        f = langevin_kernel.langevin_factor(z, metric.apply_LT(g_x + g_q),
                                            eps=eps)
    else:
        f = langevin_kernel.langevin_factor(z, g_x, g_q, eps=eps,
                                            d=metric.d)
    return q, f, lp_q, blobs_q


def _hmc(x, eps, metric, grad, value_and_grad, p0, n_leapfrog):
    """``n_leapfrog`` leapfrog steps from ``(x, p0)``: ``(q, factors,
    lp_q, blobs_q)``, factors the kinetic-energy difference (K13, K12)."""
    q, p = torch.empty_like(x), torch.empty_like(x)
    _leapfrog(metric, eps, p0, p, grad(x), 1, x, q)
    for _ in range(n_leapfrog - 1):
        _leapfrog(metric, eps, p, p, grad(q), 2, q, q)
    lp_q, blobs_q, g = value_and_grad(q)
    _leapfrog(metric, eps, p, p, g, 1)
    return q, langevin_kernel.langevin_factor(p0, p), lp_q, blobs_q


def _accept(rng, state, q, factors, lp_q, blobs_q, acc_count, accepted,
            log_u):
    """K2 over the whole ensemble (``nsplits=1``), in place; on the rung
    axis every rung in one launch of K2's rung kernel."""
    if accepted is None:
        accepted = torch.empty(state.coords.shape[:-1], dtype=torch.bool,
                               device=state.coords.device)
    seed, offset = rng
    accept_kernel.accept_select(
        q, factors, lp_q, state.coords, state.log_prob, 0, 1, accepted,
        acc_count, seed=seed, offset=offset, log_u=log_u,
        blobs=blob_pairs(blobs_q, state.blobs))
    return accepted


class _GradientMove(ScaleTunable, Move):
    """Shared machinery: the step size and its Robbins-Monro carry, and
    the optional preconditioner ``C = L L^T`` from ``cov`` (None, a
    positive scalar, a positive vector or a covariance matrix, factored
    on the host by numpy)."""

    #: True for the moves that propose every rung of a ladder at once
    #: (:meth:`propose_rungs`; every gradient move here)
    rung_batched = False

    def __init__(self, step_size, cov=None, tune_target=None,
                 tune_rate=0.2):
        self.step_size = float(step_size)
        if self.step_size <= 0:
            raise ValueError("step_size must be positive")
        self.tune_target = tune_target
        self.tune_rate = float(tune_rate)
        self._precond = "id"
        self._L = None
        self._metrics = {}
        if cov is None:
            return
        try:
            c = float(cov)
            if not np.isfinite(c) or c <= 0:
                raise ValueError("cov must be positive and finite")
            self._L = float(np.sqrt(c))
            self._precond = "scalar"
        except TypeError:
            cov = np.atleast_1d(np.asarray(cov, dtype=np.float64))
            if cov.ndim == 1:
                if not np.all(np.isfinite(cov)) or np.any(cov <= 0):
                    raise ValueError(
                        "diagonal cov entries must be positive and finite")
                self._L = np.sqrt(cov)
                self._precond = "diag"
            elif cov.ndim == 2 and cov.shape[0] == cov.shape[1]:
                if not np.all(np.isfinite(cov)):
                    raise ValueError("cov entries must be finite")
                self._L = np.linalg.cholesky(cov)
                if not np.all(np.isfinite(self._L)):
                    raise ValueError("cov must be positive definite")
                self._precond = "full"
            else:
                raise ValueError("Invalid cov dimensions")

    def __getstate__(self):
        return dict(self.__dict__, _metrics={})

    def _metric(self, nd, device):
        """The preconditioner on ``device`` for ``nd`` dimensions, made at
        the first call there (an eager one: the chunk program warms up
        before it records), so a recorded proposal copies nothing from
        the host."""
        key = (str(device), nd)
        if key not in self._metrics:
            if self._precond == "id":
                metric = _Metric("id", None)
            else:
                m = np.asarray(self._L, dtype=np.float32)
                if self._precond == "scalar":
                    m = np.full(nd, m, dtype=np.float32)
                if m.shape[0] != nd:
                    raise ValueError(f"cov is for {m.shape[0]} dimensions, "
                                     f"the walkers have {nd}")
                metric = _Metric("full" if m.ndim == 2 else "diag",
                                 torch.as_tensor(m, device=device))
            self._metrics[key] = metric
        return self._metrics[key]

    def _eps(self, carry, x):
        """The step size times the tuned scale, a 0-d tensor on ``x``'s
        device (``(T,)`` for ``(T, nwalkers, ndim)`` rows, each rung's
        scale from its own carry)."""
        eps = torch.full(x.shape[:-2], self.step_size, dtype=x.dtype,
                         device=x.device)
        s = self._tuned_scale(carry, x.dtype)
        return eps if s is None else eps * s

    def propose_rungs(self, rng, state, model, carry, acc_count=None,
                      accepted=None, extra=None, log_u=None, **kw):
        """One proposal of every rung of a ladder (``rung_batched`` moves):
        ``state``'s buffers are ``(T, nwalkers, ...)``, ``rng`` is
        ``(RungKeys, offset)``, ``model.compute_log_prob`` maps ``(T, n,
        ndim)`` rows to ``(T, n)`` log-probs and blobs (and is
        differentiated over all of them at once), the carry's tensors have
        a leading ``T`` axis, and ``acc_count`` and ``accepted`` are ``(T,
        nwalkers)``.  ``extra`` and ``log_u`` inject ``(T, ...)`` draws as
        :meth:`propose` takes them; ``kw`` (ChEES's ``loops`` and
        ``tune``) goes on to it.  Returns ``(state, accepted, carry)``."""
        if not self.rung_batched:
            raise ValueError(f"{type(self).__name__} proposes one ensemble "
                             "at a time")
        if state.coords.dim() != 3:
            raise ValueError("propose_rungs takes (ntemps, nwalkers, ndim) "
                             "coordinates")
        return self.propose(rng, state, model, carry, acc_count, accepted,
                            extra=extra, log_u=log_u, **kw)


class MALAMove(_GradientMove):
    """Metropolis-adjusted Langevin move.

    Proposal ``q = x + (eps^2/2) C grad(x) + eps L N(0, I)`` with the
    exact asymmetry correction ``factors = log q(x|q) - log q(q|x)``.

    Args:
        step_size: the Langevin step ``eps``.
        cov: optional preconditioner ``C = L L^T``.
        tune_target: optional target acceptance for Robbins-Monro
            step-size adaptation under ``run_mcmc(..., tune=True)``
            (0.574 is the classic MALA optimum).
        tune_rate: adaptation rate (decays as ``1/sqrt(t)``).
    """

    rung_batched = True

    def propose(self, rng, state, model, carry, acc_count=None,
                accepted=None, extra=None, log_u=None):
        """One MALA proposal of every walker, accepted through K2 in
        place.  ``extra={"z": ...}`` injects the noise and ``log_u`` the
        accept uniforms' logs (the parity mode)."""
        x = state.coords
        metric = self._metric(x.shape[-1], x.device)
        eps = self._eps(carry, x)
        g_x = batch_grad(model)(x)
        q, f, lp_q, blobs_q = _mala(x, g_x, eps, metric,
                                    batch_value_and_grad(model), rng,
                                    (extra or {}).get("z"))
        accepted = _accept(rng, state, q, f, lp_q, blobs_q, acc_count,
                           accepted, log_u)
        return state, accepted, carry


class HMCMove(_GradientMove):
    """Hamiltonian Monte Carlo move.

    ``n_leapfrog`` velocity-Verlet steps from freshly drawn unit Gaussian
    momenta; accept with ``log U < logpi(q) - logpi(x) + (|p0|^2 -
    |pL|^2)/2``.

    Args:
        step_size: leapfrog step ``eps``.
        n_leapfrog: number of leapfrog steps per proposal.
        jitter: relative step-size jitter; each proposal scales ``eps``
            by ``U(1 - jitter, 1 + jitter)`` (0.2 suits Gaussian-like
            targets; it breaks resonant trajectory lengths).
        cov: optional preconditioner, as :class:`MALAMove`.
        tune_target: optional Robbins-Monro step-size adaptation target
            (typical HMC operating range 0.65-0.8).
        tune_rate: adaptation rate.
    """

    rung_batched = True

    def __init__(self, step_size, n_leapfrog=10, jitter=0.0, cov=None,
                 tune_target=None, tune_rate=0.2):
        super().__init__(step_size, cov=cov, tune_target=tune_target,
                         tune_rate=tune_rate)
        self.n_leapfrog = int(n_leapfrog)
        if self.n_leapfrog < 1:
            raise ValueError("n_leapfrog must be >= 1")
        self.jitter = float(jitter)
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")

    def propose(self, rng, state, model, carry, acc_count=None,
                accepted=None, extra=None, log_u=None):
        """One HMC proposal of every walker, accepted through K2 in place.
        ``extra`` injects ``p0`` and the jitter's ``v`` in ``[-1, 1)``;
        ``log_u`` the accept uniforms' logs (the parity mode)."""
        x = state.coords
        metric = self._metric(x.shape[-1], x.device)
        eps = self._eps(carry, x)
        p0, v = _momenta(tuple(x.shape), x.device, rng, 0, 0, extra or {},
                         self.jitter > 0.0)
        if v is not None:
            eps = _jittered(eps, self.jitter, v)
        q, f, lp_q, blobs_q = _hmc(x, eps, metric, batch_grad(model),
                                   batch_value_and_grad(model), p0,
                                   self.n_leapfrog)
        accepted = _accept(rng, state, q, f, lp_q, blobs_q, acc_count,
                           accepted, log_u)
        return state, accepted, carry


class _ChEESWork:
    """ChEES's persistent buffers for one ensemble shape (``(nw, nd)``, or
    ``(T, nw, nd)`` on the rung axis): what the segments of a proposal
    hand on to each other."""

    def __init__(self, shape, dtype, device):
        def t(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        lead = shape[:-2]
        self.q, self.p, self.p0 = t(shape), t(shape), t(shape)
        #: K21a's outputs: each rung's eps, u, T and leapfrog steps after
        #: the first (``more``), the largest of them (``top``, read by the
        #: host) and the trips run (``trip``)
        self.start = chees_kernel.start_out(lead, device, dtype)
        self.eps, self.u, self.T, self.more = self.start[:4]
        #: K13's masked rung mode on a ladder of more than one rung
        self.mask = (langevin_kernel.trip_mask(self.more, self.start.trip)
                     if lead and lead[0] > 1 else None)
        #: K21b's buffers (None where one block a rung serves)
        self.scratch = chees_kernel.grad_scratch(
            lead[0] if lead else 1, shape[-1],
            chees_kernel.grad_plan(shape[-2]), device)


class ChEESHMCMove(_GradientMove):
    """HMC with a ChEES-adapted trajectory length.

    All walkers share one trajectory length ``T``, adapted across the
    ensemble by Adam ascent on the Change-in-the-Estimator-of-the-
    Expected-Square criterion (Hoffman, Radul & Sountsov, AISTATS 2021).
    Each proposal integrates ``ceil(u T / eps)`` leapfrog steps (clipped
    to ``[1, max_leapfrog]``), ``u`` the base-2 van der Corput value of
    the proposal counter; under ``run_mcmc(..., tune=True)`` the step
    size follows Robbins-Monro toward ``tune_target`` and ``log T`` the
    ChEES gradient, which is estimated only in tuning runs
    (``wants_tune_flag``).

    Args:
        step_size: initial leapfrog step ``eps``.
        trajectory_length: initial trajectory length ``T``.
        max_leapfrog: cap on leapfrog steps per proposal.
        cov: optional preconditioner, as :class:`HMCMove`.
        tune_target: acceptance target for ``eps`` (default 0.651; None
            freezes ``eps``).
        tune_rate: Robbins-Monro rate for ``eps``.
        adapt_rate: Adam learning rate for ``log T`` (decays as
            ``1/sqrt(t)``).
    """

    wants_tune_flag = True
    #: the trip count is a device word: the chunk program reads it once a
    #: proposal (the largest of every rung's on a ladder) and replays a
    #: one-step graph that many times
    looped = True
    rung_batched = True

    def __init__(self, step_size, trajectory_length=1.0, max_leapfrog=1024,
                 cov=None, tune_target=0.651, tune_rate=0.2,
                 adapt_rate=0.05):
        super().__init__(step_size, cov=cov, tune_target=tune_target,
                         tune_rate=tune_rate)
        self.trajectory_length = float(trajectory_length)
        if self.trajectory_length <= 0:
            raise ValueError("trajectory_length must be positive")
        self.max_leapfrog = int(max_leapfrog)
        if self.max_leapfrog < 1:
            raise ValueError("max_leapfrog must be >= 1")
        self.adapt_rate = float(adapt_rate)
        if self.adapt_rate <= 0:
            raise ValueError("adapt_rate must be positive")
        self._work = {}

    def __getstate__(self):
        return dict(super().__getstate__(), _work={})

    def init_carry(self, nwalkers, ndim, device=None):
        def f(v, dt=torch.float32):
            return torch.full((), v, dtype=dt, device=device)

        return {
            # eps Robbins-Monro state (the ScaleTunable carry)
            "log_adj": f(0.0), "t": f(0, torch.int32),
            # the trajectory length's Adam state
            "log_T": f(float(np.float32(np.log(self.trajectory_length)))),
            "m": f(0.0), "v": f(0.0), "k": f(0, torch.int32),
            # the pending ChEES gradient (set by propose, read by tune)
            "g": f(0.0),
            # the proposal counter of the van der Corput jitter
            "n": f(1, torch.int32),
        }

    def work(self, x):
        key = (tuple(x.shape), x.dtype, str(x.device))
        if key not in self._work:
            self._work[key] = _ChEESWork(tuple(x.shape), x.dtype, x.device)
        return self._work[key]

    def propose(self, rng, state, model, carry, acc_count=None,
                accepted=None, loops=None, tune=False, extra=None,
                log_u=None):
        """One ChEES proposal of every walker (of every rung, for ``(T,
        nwalkers, ndim)`` buffers, a ``(T,)`` carry and ``RungKeys``),
        accepted through K2 in place: a start segment (K21a: eps, the
        jitter, T and the trip counts; K11's momenta; the first leapfrog
        step), the remaining steps by ``loops.repeat`` of the largest trip
        count (:class:`~..chunk_graph.EagerLoops` by default; on a ladder
        each rung steps only while it has trips left), and an end segment
        (the last gradient and kick, K12's factors, K21b's ChEES gradient
        when ``tune``, K2).  ``extra={"p0": ...}`` and ``log_u`` inject
        the draws (the parity mode)."""
        x = state.coords
        seed, offset = rng
        loops = loops or EagerLoops()
        w = self.work(x)
        metric = self._metric(x.shape[-1], x.device)
        grad = batch_grad(model)
        p0 = (extra or {}).get("p0")
        if accepted is None:
            accepted = torch.empty(x.shape[:-1], dtype=torch.bool,
                                   device=x.device)

        def start():
            chees_kernel.chees_start(carry["log_adj"], carry["log_T"],
                                     carry["n"], self.step_size,
                                     self.max_leapfrog, w.start)
            w.p0.copy_(_draw(tuple(x.shape), x.device, seed, offset, 0, p0))
            _leapfrog(metric, w.eps, w.p0, w.p, grad(x), 1, x, w.q)

        def step():
            _leapfrog(metric, w.eps, w.p, w.p, grad(w.q), 2, w.q, w.q,
                      mask=w.mask)

        def end():
            lp_q, blobs_q, g = batch_value_and_grad(model)(w.q)
            _leapfrog(metric, w.eps, w.p, w.p, g, 1)
            f = langevin_kernel.langevin_factor(w.p0, w.p)
            if tune:
                full = metric.kind == "full"
                chees_kernel.chees_gradient(
                    x, w.q, w.p, state.log_prob, lp_q, f, w.u, w.T,
                    carry["g"], d=metric.d, L=metric.m if full else None,
                    scratch=w.scratch)
            else:
                carry["g"].zero_()
            carry["n"].add_(1)
            _accept(rng, state, w.q, f, lp_q, blobs_q, acc_count, accepted,
                    log_u)

        loops.segment(("start",), start)
        loops.repeat(("step",), step, w.start.top)
        loops.segment(("end", bool(tune)), end)
        return state, accepted, carry

    def tune(self, carry, state, accepted, model=None):
        """Robbins-Monro on ``eps`` (with a ``tune_target``), then Adam
        ascent on ``log T`` from the pending ChEES gradient, in place."""
        if self.tune_target is not None:
            robbins_monro_tune(carry, accepted, self.tune_target,
                               self.tune_rate, model)
        b1, b2 = 0.9, 0.999
        g = carry["g"]
        k = carry["k"] + 1
        kf = k.to(torch.float32)
        m = b1 * carry["m"] + (1.0 - b1) * g
        v = b2 * carry["v"] + (1.0 - b2) * g * g
        mh = m / (1.0 - b1**kf)
        vh = v / (1.0 - b2**kf)
        lr = self.adapt_rate / torch.sqrt(1.0 + kf)
        carry["log_T"].copy_(torch.clamp(
            carry["log_T"] + lr * mh / (torch.sqrt(vh) + 1e-8), -15.0, 15.0))
        carry["m"].copy_(m)
        carry["v"].copy_(v)
        carry["k"].copy_(k)
        return carry


def complement_chol(c, ridge):
    """The complement's sample covariance plus ``ridge`` on the diagonal,
    and its lower Cholesky factor (NaN where it does not exist), in full
    float32: one ``(d, n) @ (n, d)`` product (``gradient.py:579-598``).
    On the rung axis (``c`` ``(T, n, d)``) every rung's in one batched
    ``(T, d, n) @ (T, n, d)`` product and one batched Cholesky."""
    nc = c.shape[-2]
    X = ((c - c.mean(dim=-2, keepdim=True))
         / float(np.sqrt(np.float32(nc - 1.0))))
    with full_float32():
        C = X.mT @ X
    C.diagonal(dim1=-2, dim2=-1).add_(ridge)
    return C, cholesky_or_nan(C)


class _EnsembleGradient(RedBlueMove):
    """A red-blue gradient move: ``get_proposal`` returns ``(q,
    factors)`` as in the JAX package, and the engine's accept reuses the
    log-prob and blobs of the gradient's forward pass at ``q``.  On the
    rung axis (``coords`` ``(T, nwalkers, ndim)``, ``rng``'s seed a
    :class:`~..ops.philox.RungKeys`, ``scale`` ``(T,)``) every rung's
    group at once, each rung's metric from its own complement."""

    tunable = True
    rung_batched = True
    #: the complement-covariance metric couples the dimensions
    _param_shard_ok = False

    def _group(self, coords, split, scale):
        """``(s, lo, eps, C, metric)`` of group ``split``: its rows, their
        first row, the step size (times the tuned ``scale``), and the
        complement's covariance and metric (``(T, ...)`` each on the
        rung axis)."""
        ng = coords.shape[-2] // self.nsplits
        lo = split * ng
        s = coords[..., lo:lo + ng, :].contiguous()
        C, L = complement_chol(complement(coords, split, ng), self.ridge)
        eps = torch.full(coords.shape[:-2], self.step_size, dtype=s.dtype,
                         device=s.device)
        if scale is not None:
            eps = eps * scale
        return s, lo, eps, C, _Metric("full", L)

    def _proposal(self, rng, coords, split, model, extra, scale):
        """``(q, factors, lp_q, blobs_q)`` of group ``split``."""
        raise NotImplementedError

    def get_proposal(self, rng, coords, split, model, extra=None,
                     scale=None):
        """``(q, factors)`` of group ``split`` of the ensemble buffer
        ``coords``; ``extra`` injects the draws (see the subclass)."""
        return self._proposal(rng, coords, split, model, extra, scale)[:2]

    def _inner(self, rng, coords, log_prob, split, model, accepted,
               acc_count=None, log_u=None, extra=None, scale=None,
               blobs=None, carry=None):
        q, factors, lp_q, blobs_q = self._proposal(rng, coords, split,
                                                   model, extra, scale)
        seed, offset = rng
        accept_kernel.accept_select(
            q, factors, lp_q, coords, log_prob, split, self.nsplits,
            accepted, acc_count, seed=seed, offset=offset, log_u=log_u,
            blobs=blob_pairs(blobs_q, blobs))
        return None


class EnsembleMALAMove(_EnsembleGradient):
    """Affine-invariant Langevin: ensemble-preconditioned MALA.

    Each red-blue group takes a MALA step preconditioned by the
    complementary group's sample covariance (plus a small ridge); the
    metric is built from walkers frozen during the half-step, so detailed
    balance holds (the red-blue argument).

    Args:
        step_size: Langevin step in the whitened frame.
        ridge: diagonal regularizer added to the complement covariance.
        tune_target: optional Robbins-Monro step-size adaptation target
            (0.574 is the MALA optimum) under ``run_mcmc(..., tune=True)``.
        nsplits / randomize_split / live_dangerously: standard red-blue
            controls.

    ``extra={"z": ...}`` injects a group's ``(ng, ndim)`` noise.
    """

    def __init__(self, step_size=0.5, ridge=1e-6, **kwargs):
        self.step_size = float(step_size)
        if self.step_size <= 0:
            raise ValueError("step_size must be positive")
        self.ridge = float(ridge)
        super().__init__(**kwargs)

    def _proposal(self, rng, coords, split, model, extra, scale):
        s, lo, eps, C, metric = self._group(coords, split, scale)
        seed, offset = rng
        g_s = batch_grad(model)(s)
        z = _draw(tuple(s.shape), s.device, seed, offset, lo,
                  (extra or {}).get("z"))
        with full_float32():
            a = g_s @ C
        # Rows are walkers: C g == g @ C (C symmetric); L z == z @ L.T.
        _, q = langevin_kernel.langevin_step(
            tuple(s.shape), s.device, z=metric.apply_L(z), x=s, g=a, eps=eps)
        lp_q, blobs_q, g_q = batch_value_and_grad(model)(q)
        f = langevin_kernel.langevin_factor(
            z, metric.apply_LT(g_s + g_q), eps=eps)
        return q, f, lp_q, blobs_q


class EnsembleHMCMove(_EnsembleGradient):
    """Affine-invariant HMC: complement-covariance mass matrix.

    Each red-blue group runs ``n_leapfrog`` velocity-Verlet steps whose
    metric is the complementary group's sample covariance (plus a small
    ridge), the zero-configuration counterpart of ``HMCMove(cov=...)``.

    Args:
        step_size: leapfrog step in the whitened frame.
        n_leapfrog: leapfrog steps per proposal.
        jitter: relative step-size jitter per half-step.
        ridge: diagonal regularizer on the complement covariance.
        tune_target: optional Robbins-Monro step-size adaptation target
            under ``run_mcmc(..., tune=True)``.

    ``extra`` injects a group's ``p0`` and the jitter's ``v`` in ``[-1,
    1)``.
    """

    def __init__(self, step_size=0.5, n_leapfrog=5, jitter=0.2, ridge=1e-6,
                 **kwargs):
        self.step_size = float(step_size)
        if self.step_size <= 0:
            raise ValueError("step_size must be positive")
        self.n_leapfrog = int(n_leapfrog)
        if self.n_leapfrog < 1:
            raise ValueError("n_leapfrog must be >= 1")
        self.jitter = float(jitter)
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.ridge = float(ridge)
        super().__init__(**kwargs)

    def _proposal(self, rng, coords, split, model, extra, scale):
        s, lo, eps, _, metric = self._group(coords, split, scale)
        p0, v = _momenta(tuple(s.shape), s.device, rng, lo, split,
                         extra or {}, self.jitter > 0.0)
        if v is not None:
            eps = _jittered(eps, self.jitter, v)
        return _hmc(s, eps, metric, batch_grad(model),
                    batch_value_and_grad(model), p0, self.n_leapfrog)
