"""DIME: differential-evolution + adaptive-independence mixture move.

The counterpart of ``emcee_tpu/moves/dime.py:49-468`` (Boehl 2022): each
walker proposes, with probability ``aimh_prob``, from an adaptive
independence Student-t (or Gaussian, ``df=None``) whose moments pool the
frozen complement with an exponentially decayed history of past
ensembles (decay ``rho``), and otherwise takes a DE step; with
``n_components > 1`` the independence proposal is a mixture of K such
components with a nearest-mean hard assignment.  The carry ``{mean, cov,
w}`` ((ndim,), (ndim, ndim), () or with a leading K axis) is updated in
place once per proposal by :meth:`DIMEMove.update_carry`.

K8 does the work (``ops/dime_kernel.py``, ``csrc/dime_moments.cu``,
``csrc/dime_propose.cu``): a split's proposal is K8a (the complement's
moment partials, read in place), K8b (their tree, the pooling with the
carry, the t-shape's Cholesky factor and inverse, the log-weights) and
K8c (the draws, ``q`` and the Hastings factor), then K2; the carry update
is K8a over the ensemble and K8b writing the carry.  On the CPU the same
calls run the kernels' plain versions.  Nothing syncs with the host: the
cold start (``w == 0``) and a factor that does not exist (NaN, as JAX's
Cholesky) are selects inside the kernels.

The rung axis (parallel tempering: ``emcee_tpu/parallel/tempering.py:
449-541`` vmaps DIME over the ladder): the move is ``rung_batched``, so a
ladder proposes every rung at once on ``(T, nwalkers, ndim)`` buffers with
``(T, ...)`` carries under the rungs' keys; each kernel launch serves
every rung and computes each exactly as alone, so the batched path equals
the per-rung loop bit for bit.

The draws: normals at ``(row, NORMAL_BLOCK | k)`` (the ``ndim`` normals
of the independence draw, then the DE gamma jitter); uniforms at ``(row,
DIME_BLOCK)`` (the kernel select, the DE picks ``i`` and ``j``, the
component); the chi-square at ``(row, CHI2_BLOCK | k)``:
:func:`chi_square`.
"""

from __future__ import annotations

import contextlib

import torch

from ..ops import dime_kernel
from ..ops.de_kernel import de_gamma0
from .red_blue import RedBlueMove

__all__ = ["DIMEMove", "MT_CANDIDATES", "chi_square", "full_float32"]

#: Marsaglia-Tsang candidates per walker for a chi-square of non-integer
#: ``df``: a candidate is refused with probability below 0.049 at any
#: shape ``df / 2 > 1``, so a walker exhausts 10 with probability below
#: 0.049**10 < 1e-12 (read at every proposal)
MT_CANDIDATES = dime_kernel.MT_CANDIDATES


@contextlib.contextmanager
def full_float32():
    """Float32 matmuls in full float32 (no TF32) inside the block; the
    caller's setting is restored after it."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def chi_square(n, df, seed, offset, device, dtype=torch.float32, row0=0,
               exhausted=None):
    """``n`` chi-square draws of ``df`` degrees of freedom for rows
    ``row0 ..``, from counters ``(row, CHI2_BLOCK | k, offset)``: the
    draws of K8c (``ops/dime_kernel.py`` ``chi_square``) with
    :data:`MT_CANDIDATES` candidates."""
    return dime_kernel.chi_square(n, df, seed, offset, device, dtype, row0,
                                  exhausted, candidates=MT_CANDIDATES)


class DIMEMove(RedBlueMove):
    """Differential-Independence Mixture Ensemble proposal.

    Args:
        sigma: stddev of the gamma jitter of the DE component.
        gamma0: DE mean stretch factor; default ``2.38 / sqrt(2 ndim)``.
        aimh_prob: per-walker probability of an independence proposal.
        df: degrees of freedom of the Student-t proposal (> 2; default
            10); ``None`` for a Gaussian.
        rho: per-proposal decay of the history weight (default 0.999).
        n_components: components of the independence proposal.
    """

    wants_carry = True
    blendable = False
    _param_shard_ok = False
    rung_batched = True

    def __init__(self, sigma=1.0e-5, gamma0=None, aimh_prob=0.1, df=10.0,
                 rho=0.999, n_components=1, **kwargs):
        self.sigma = float(sigma)
        self.gamma0 = gamma0
        self.aimh_prob = float(aimh_prob)
        if not 0.0 <= self.aimh_prob <= 1.0:
            raise ValueError("aimh_prob must be in [0, 1]")
        self.df = None if df is None else float(df)
        if self.df is not None and self.df <= 2.0:
            raise ValueError("df must be > 2 (or None for Gaussian)")
        self.rho = float(rho)
        if not 0.0 <= self.rho < 1.0:
            raise ValueError("rho must be in [0, 1)")
        self.n_components = int(n_components)
        if self.n_components < 1:
            raise ValueError("n_components must be >= 1")
        # Chi-square exhaustions per device (non-integer df), counted on
        # the device: a diagnostic that must stay 0.
        self._exhaust_counts = {}
        super().__init__(**kwargs)

    def init_carry(self, nwalkers, ndim, device=None):
        # Cold start: w == 0 means the first proposals use pure
        # complement moments.
        lead = () if self.n_components == 1 else (self.n_components,)
        eye = torch.eye(ndim, dtype=torch.float32, device=device)
        return {
            "mean": torch.zeros(lead + (ndim,), dtype=torch.float32,
                                device=device),
            "cov": eye.expand(lead + (ndim, ndim)).clone(),
            "w": torch.zeros(lead, dtype=torch.float32, device=device),
        }

    def _exhausted(self, device):
        """The 0-d int64 count of chi-square exhaustions on ``device``
        (made at the first, eager, proposal there).  ``"cuda"`` and
        ``"cuda:0"`` name one counter: the key is the device with its
        index resolved."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = str(dev)
        if key not in self._exhaust_counts:
            self._exhaust_counts[key] = torch.zeros(
                (), dtype=torch.int64, device=dev)
        return self._exhaust_counts[key]

    def _config(self, model, nd):
        """The move's constants as K8 takes them."""
        return dime_kernel.DimeConfig(
            self.n_components, self.rho, self.df, self.aimh_prob,
            de_gamma0(self.gamma0, model.global_ndim(nd)), self.sigma,
            MT_CANDIDATES)

    # -- the JAX package's steps, on the plain versions ----------------------

    def _pooled(self, carry, mean_b, cov_b, n, dtype):
        """Pool the decayed history with a batch's centered (mean, cov,
        n) by the parallel-combine recursion."""
        n = torch.as_tensor(n, dtype=dtype, device=mean_b.device)
        mean, cov, total = dime_kernel.pool_plain(
            carry["mean"].to(dtype)[None], carry["cov"].to(dtype)[None],
            carry["w"].to(dtype)[None], n[None], mean_b[None], cov_b[None],
            self.rho)
        return mean[0], cov[0], total[0]

    def _pooled_k(self, carry, n_k, means_b, covs_b, dtype):
        """The K-axis analogue of :meth:`_pooled`; a component with no
        points keeps its history."""
        return dime_kernel.pool_plain(
            carry["mean"].to(dtype), carry["cov"].to(dtype),
            carry["w"].to(dtype), n_k, means_b, covs_b, self.rho)

    def _t_shape_chol(self, cov, ndim, dtype):
        """Cholesky factor of the proposal shape ``cov * (df - 2) / df``
        (or ``cov``) plus the trace-scaled jitter, batched over leading
        axes; NaN where it does not exist."""
        return dime_kernel.t_shape_chol_plain(cov.to(dtype), self.df)

    def _assign_means(self, carry, x):
        """The carry's component means, or K strided rows of ``x`` at the
        cold start (total history weight zero)."""
        K = self.n_components
        n = x.shape[0]
        idx = (torch.arange(K, device=x.device) * max(1, n // K)) % n
        cold = carry["w"].sum() == 0.0
        return torch.where(cold, x[idx].to(torch.float32), carry["mean"])

    def _masked_moments(self, x, assign_means):
        """Per-component (count, mean, centered cov) of ``x`` under the
        nearest-mean hard assignment (K8a's partials and K8b's tree)."""
        return dime_kernel.masked_moments_plain(x, assign_means)

    def _mixture_quantities(self, carry, c, dtype):
        """Pooled per-component means, Cholesky factors, their inverses,
        log-weights and log-determinants, from the complement ``c`` and the
        history only (K8a and K8b's plain versions)."""
        nd = c.shape[-1]
        cfg = dime_kernel.DimeConfig(self.n_components, self.rho, self.df,
                                     self.aimh_prob, 0.0, self.sigma)
        part = dime_kernel.dime_moments_plain(
            c.to(dtype), (0, 0), carry["mean"], carry["w"], self.n_components)
        table = dime_kernel.dime_finish_plain(part, carry["mean"],
                                              carry["cov"], carry["w"], cfg)
        means, L, L_inv, logw, logdet, _ = dime_kernel.unpack_table(
            table, self.n_components, nd)
        return means, L, L_inv, logw, logdet

    def _mixture_logq(self, x, means, L_inv, logw, logdet, ndim):
        """Mixture log-density up to the shared normalizing constant."""
        return dime_kernel.logq_plain(x, means, L_inv, logw, logdet,
                                      self.df, ndim)

    # -- the proposal ------------------------------------------------------

    def get_proposal(self, rng, coords, split, model, extra=None,
                     scale=None, carry=None):
        """The proposal of group ``split``: K8a, K8b and K8c.  ``extra``
        injects draws as a dict (the parity mode): ``z`` ``(ng, ndim)``
        normals, ``zg`` ``(ng, 1)`` the DE gamma jitter, the raw DE picks
        ``i`` and ``j``, the kernel select ``use_t`` (bool), the
        components ``comp`` (ints) and ``chi2``; on the rung axis
        (``coords`` ``(T, nwalkers, ndim)``, ``rng``'s seed a
        :class:`~..ops.philox.RungKeys`) each with a leading ``T``
        axis."""
        seed, offset = rng
        nw, nd = coords.shape[-2:]
        ng = nw // self.nsplits
        cfg = self._config(model, nd)
        part = dime_kernel.dime_moments(coords, (split * ng, ng),
                                        carry["mean"], carry["w"],
                                        self.n_components)
        table = dime_kernel.dime_finish(part, carry["mean"], carry["cov"],
                                        carry["w"], cfg)
        return dime_kernel.dime_propose(
            coords, split, self.nsplits, table, seed, offset, cfg, extra,
            self._exhausted(coords.device) if self.df is not None
            and not float(self.df).is_integer() else None)

    def update_carry(self, carry, state, model):
        """Fold the post-accept ensemble into the decayed history
        moments, in place (K8a over the ensemble, K8b writing the
        carry)."""
        coords = state.coords
        part = dime_kernel.dime_moments(coords, (0, 0), carry["mean"],
                                        carry["w"], self.n_components)
        dime_kernel.dime_finish(part, carry["mean"], carry["cov"],
                                carry["w"],
                                self._config(model, coords.shape[-1]),
                                mode="update")
        return carry
