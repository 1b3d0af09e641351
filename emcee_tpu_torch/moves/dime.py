"""DIME: differential-evolution + adaptive-independence mixture move.

The counterpart of ``emcee_tpu/moves/dime.py:49-468`` (Boehl 2022): each
walker proposes, with probability ``aimh_prob``, from an adaptive
independence Student-t (or Gaussian, ``df=None``) whose moments pool the
frozen complement with an exponentially decayed history of past
ensembles (decay ``rho``), and otherwise takes a DE step; with
``n_components > 1`` the independence proposal is a mixture of K such
components with a nearest-mean hard assignment.  Plain torch; each
split's accept/select is K2.  The carry ``{mean, cov, w}`` ((ndim,),
(ndim, ndim), () or with a leading K axis) is updated in place once per
proposal by :meth:`DIMEMove.update_carry`.

Nothing on the path syncs with the host: the Cholesky factor is
``torch.linalg.cholesky_ex`` (NaN where the matrix is not positive
definite, as JAX's Cholesky), its inverse ``torch.linalg.
solve_triangular``; the cold start (``w == 0``) is a ``torch.where``.
Every matmul runs in full float32, never TF32 (:func:`full_float32`):
the quadratic forms enter the acceptance, as ``Precision.HIGHEST`` keeps
them in the JAX package.

The draws: normals at ``(row, NORMAL_BLOCK | k)`` (the ``ndim`` normals
of the independence draw, then the DE gamma jitter); uniforms at ``(row,
DIME_BLOCK)`` (the kernel select, the DE picks ``i`` and ``j``, the
component); the chi-square at ``(row, CHI2_BLOCK | k)``:
:func:`chi_square`.
"""

from __future__ import annotations

import contextlib
import math

import torch

from ..ops._wrap import complement_rows
from ..ops.de_kernel import de_gamma0
from ..ops.philox import (
    CHI2_BLOCK, DIME_BLOCK, box_muller, normals, row_uniforms, row_words,
    to_uniform)
from .red_blue import RedBlueMove
from .walk import complement

__all__ = ["DIMEMove", "MT_CANDIDATES", "chi_square", "full_float32"]

#: Marsaglia-Tsang candidates per walker for a chi-square of non-integer
#: ``df``: a candidate is refused with probability below 0.049 at any
#: shape ``df / 2 > 1``, so a walker exhausts 10 with probability below
#: 0.049**10 < 1e-12
MT_CANDIDATES = 10


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
    ``row0 ..``, from counters ``(row, CHI2_BLOCK | k, offset)``.

    An integer ``df`` sums ``df`` squared Box-Muller normals (exact, no
    loop).  Any other ``df`` takes the first accepted of
    :data:`MT_CANDIDATES` Marsaglia-Tsang candidates for a Gamma(df / 2)
    (candidate k: a normal from words 0 and 2, its uniform from word 1);
    a walker whose candidates are all refused gets ``df`` and adds one
    to ``exhausted`` (a 0-d int64 tensor), if given."""
    if float(df).is_integer():
        z = normals(n, int(df), seed, offset, device, dtype, row0=row0,
                    block=CHI2_BLOCK)
        return (z * z).sum(-1)
    w0, w1, w2, _ = row_words(n, MT_CANDIDATES, CHI2_BLOCK, seed, offset,
                              device, row0)
    x = box_muller(w0, w2, dtype)
    u = to_uniform(w1, dtype)
    d = df / 2.0 - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                    + d * torch.log(torch.clamp(v, min=1e-30)))
    first = ok.to(torch.int8).argmax(dim=1, keepdim=True)
    got = ok.any(dim=1)
    value = 2.0 * d * v.gather(1, first)[:, 0]
    if exhausted is not None:
        exhausted.add_((~got).sum())
    return torch.where(got, value, torch.full_like(value, df))


def _centered_moments(x):
    """Population mean and centered covariance of ``x`` (n, d)."""
    mean = x.mean(dim=0)
    xc = x - mean
    return mean, (xc.T @ xc) / x.shape[0]


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

    def _pooled(self, carry, mean_b, cov_b, n, dtype):
        """Pool the decayed history with a batch's centered (mean, cov,
        n) by the parallel-combine recursion."""
        wh = self.rho * carry["w"].to(dtype)
        total = wh + n
        mean_h = carry["mean"].to(dtype)
        delta = mean_b - mean_h
        mean = mean_h + delta * (n / total)
        cov = (wh * carry["cov"].to(dtype) + n * cov_b) / total + (
            wh * n / (total * total)) * torch.outer(delta, delta)
        return mean, cov, total

    def _t_shape_chol(self, cov, ndim, dtype):
        """Cholesky factor of the proposal shape ``cov * (df - 2) / df``
        (or ``cov``), batched over leading axes; NaN where it does not
        exist."""
        scale = 1.0 if self.df is None else (self.df - 2.0) / self.df
        tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)
        eps = 1e-6 * (tr / ndim) + 1e-12
        eye = torch.eye(ndim, dtype=dtype, device=cov.device)
        S = cov * scale + eps[..., None, None] * eye
        chol, info = torch.linalg.cholesky_ex(S)
        return torch.where((info == 0)[..., None, None], chol, torch.nan)

    @staticmethod
    def _inverse(L):
        """``L^-1`` of lower-triangular factors, batched."""
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        return torch.linalg.solve_triangular(L, eye.expand_as(L).clone(),
                                             upper=False)

    @staticmethod
    def _t_quad(L_inv, x, mean):
        """Mahalanobis quadratic form of the rows of ``x`` under
        ``chol(S)^-1``."""
        y = (x - mean) @ L_inv.T
        return (y * y).sum(-1)

    # -- K-component machinery (n_components > 1) ----------------------

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
        nearest-mean hard assignment."""
        K = self.n_components
        mu = assign_means.to(x.dtype)
        d2 = ((x * x).sum(1)[:, None] - 2.0 * x @ mu.T
              + (mu * mu).sum(1)[None, :])
        onehot = torch.nn.functional.one_hot(d2.argmin(dim=1), K).to(x.dtype)
        n_k = onehot.sum(0)
        safe = torch.clamp(n_k, min=1.0)
        means = (onehot.T @ x) / safe[:, None]
        xc = x[None, :, :] - means[:, None, :]
        # One (d, n) @ (n, d) product per component: the einsum
        # "nk,kni,knj->kij" becomes a batched product with one output
        # tile per component that runs its n-long reduction serially
        # (3.6 of 6.0 ms a proposal at 1e5 walkers on the H100).
        covs = torch.stack([(xc[k] * onehot[:, k:k + 1]).T @ xc[k]
                            for k in range(K)])
        return n_k, means, covs / safe[:, None, None]

    def _pooled_k(self, carry, n_k, means_b, covs_b, dtype):
        """The K-axis analogue of :meth:`_pooled`; a component with no
        points keeps its history."""
        wh = self.rho * carry["w"].to(dtype)
        total = wh + n_k
        safe = torch.clamp(total, min=1e-12)
        mean_h = carry["mean"].to(dtype)
        delta = means_b - mean_h
        mean = mean_h + delta * (n_k / safe)[:, None]
        cov = (wh[:, None, None] * carry["cov"].to(dtype)
               + n_k[:, None, None] * covs_b) / safe[:, None, None] + (
            (wh * n_k) / (safe * safe))[:, None, None] * torch.einsum(
                "ki,kj->kij", delta, delta)
        return mean, cov, total

    def _mixture_quantities(self, carry, c, dtype):
        """Pooled per-component means, Cholesky factors, their inverses,
        log-weights and log-determinants, from the complement and the
        history only."""
        ndim = c.shape[1]
        n_k, mb, cb = self._masked_moments(c, self._assign_means(carry, c))
        means, covs, wk = self._pooled_k(carry, n_k, mb, cb, dtype)
        L = self._t_shape_chol(covs, ndim, dtype)
        w_floor = wk + 1e-6 * wk.sum() + 1e-30
        logw = torch.log(w_floor) - torch.log(w_floor.sum())
        logdet = torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(1)
        return means, L, self._inverse(L), logw, logdet

    def _mixture_logq(self, x, means, L_inv, logw, logdet, ndim):
        """Mixture log-density up to the shared normalizing constant."""
        # Centred before the product, as _t_quad: x - mean cancels
        # nothing when |mean| >> the spread.
        y = torch.einsum("kmi,kji->kmj", x[None] - means[:, None], L_inv)
        m_k = (y * y).sum(-1)
        if self.df is None:
            comp = logw[:, None] - logdet[:, None] - 0.5 * m_k
        else:
            comp = (logw[:, None] - logdet[:, None]
                    - ((self.df + ndim) / 2.0) * torch.log1p(m_k / self.df))
        return torch.logsumexp(comp, dim=0)

    # -- the proposal ------------------------------------------------------

    def _draws(self, ng, nc, nd, rng, row0, dev, dt, extra):
        """The proposal's draws as a dict, ``extra``'s where it has them:
        ``z`` ``(ng, nd)`` normals, ``zg`` ``(ng, 1)`` the DE gamma
        jitter, the raw DE picks ``i`` and ``j``, the kernel select
        ``use_t`` (bool), the component ``comp`` and ``chi2`` (None for
        ``df=None``)."""
        seed, offset = rng
        d = dict(extra)
        if "z" not in d or "zg" not in d:
            zz = normals(ng, nd + 1, seed, offset, dev, dt, row0=row0)
            d.setdefault("z", zz[:, :nd])
            d.setdefault("zg", zz[:, nd:])
        # The pure independence sampler with one component reads none.
        wanted = self.aimh_prob < 1.0 or self.n_components > 1
        if wanted and any(k not in d for k in ("use_t", "i", "j",
                                                "u_comp")):
            u = row_uniforms(ng, 4, seed, offset, dev, dt, row0=row0,
                             block=DIME_BLOCK)
            d.setdefault("use_t", u[:, 0] < self.aimh_prob)
            d.setdefault("i", torch.clamp((u[:, 1] * nc).to(torch.int64),
                                          max=nc - 1))
            d.setdefault("j", torch.clamp(
                (u[:, 2] * (nc - 1)).to(torch.int64), max=nc - 2))
            d.setdefault("u_comp", u[:, 3])
        if "chi2" not in d:
            d["chi2"] = None if self.df is None else chi_square(
                ng, self.df, seed, offset, dev, dt, row0=row0,
                exhausted=self._exhausted(dev))
        return d

    def _de_step(self, coords, s, split, ng, d, model):
        """The DE component: ``s + gamma (c[j] - c[i])``."""
        nd = coords.shape[1]
        i, j = d["i"].to(torch.int64), d["j"].to(torch.int64)
        j = torch.where(j >= i, j + 1, j)
        gamma = de_gamma0(self.gamma0, model.global_ndim(nd)) * (
            1.0 + self.sigma * d["zg"])
        ci = coords.index_select(0, complement_rows(i, split, ng))
        cj = coords.index_select(0, complement_rows(j, split, ng))
        return s + gamma * (cj - ci)

    def get_proposal(self, rng, coords, split, model, extra=None,
                     scale=None, carry=None):
        """The proposal of group ``split``.  ``extra`` injects draws as a
        dict (the parity mode; see :meth:`_draws`; ``comp`` the
        components as ints)."""
        with full_float32():
            return self._proposal(rng, coords, split, model, extra or {},
                                  carry)

    def _proposal(self, rng, coords, split, model, extra, carry):
        nw, nd = coords.shape
        ng = nw // self.nsplits
        nc = nw - ng
        dev, dt = coords.device, coords.dtype
        row0 = split * ng
        s = coords[row0:row0 + ng]
        c = complement(coords, split, ng)
        d = self._draws(ng, nc, nd, rng, row0, dev, dt, extra)
        z, chi2 = d["z"], d["chi2"]
        if self.n_components > 1:
            means, L, L_inv, logw, logdet = self._mixture_quantities(
                carry, c, dt)
            comp = d.get("comp")
            if comp is None:
                # Inverse CDF of the component weights.
                cdf = torch.cumsum(torch.exp(logw), 0)
                comp = torch.clamp(
                    (d["u_comp"][:, None] >= cdf[None, :-1]).sum(1),
                    max=self.n_components - 1)
            sel = torch.nn.functional.one_hot(
                comp.to(torch.int64), self.n_components).to(dt)
            draws_k = means[:, None, :] + torch.einsum("ni,kji->knj", z, L)
            q_t = torch.einsum("nk,knj->nj", sel, draws_k)
            if chi2 is not None:
                mean_sel = sel @ means
                q_t = mean_sel + (q_t - mean_sel) * torch.sqrt(
                    self.df / chi2)[:, None]
        else:
            mean_c, cov_c = _centered_moments(c)
            mean, cov, _ = self._pooled(carry, mean_c, cov_c, nc, dt)
            L = self._t_shape_chol(cov, nd, dt)
            L_inv = self._inverse(L)
            q_t = z @ L.T
            if chi2 is not None:
                q_t = q_t * torch.sqrt(self.df / chi2)[:, None]
            q_t = mean + q_t
        if self.aimh_prob >= 1.0:
            q = q_t
            use_t = torch.ones(ng, dtype=torch.bool, device=dev)
        else:
            use_t = d["use_t"]
            q = torch.where(use_t[:, None], q_t,
                            self._de_step(coords, s, split, ng, d, model))
        if self.n_components > 1:
            f_t = (self._mixture_logq(s, means, L_inv, logw, logdet, nd)
                   - self._mixture_logq(q_t, means, L_inv, logw, logdet,
                                        nd))
        else:
            m_s = self._t_quad(L_inv, s, mean)
            m_q = self._t_quad(L_inv, q_t, mean)
            if self.df is None:
                f_t = 0.5 * (m_q - m_s)
            else:
                f_t = (-(self.df + nd) / 2.0) * (
                    torch.log1p(m_s / self.df) - torch.log1p(m_q / self.df))
        return q, torch.where(use_t, f_t, torch.zeros_like(f_t))

    def update_carry(self, carry, state, model):
        """Fold the post-accept ensemble into the decayed history
        moments, in place."""
        coords = state.coords
        dt = coords.dtype
        with full_float32():
            if self.n_components > 1:
                n_k, mb, cb = self._masked_moments(
                    coords, self._assign_means(carry, coords))
                mean, cov, total = self._pooled_k(carry, n_k, mb, cb, dt)
            else:
                mean_b, cov_b = _centered_moments(coords)
                mean, cov, total = self._pooled(carry, mean_b, cov_b,
                                                coords.shape[0], dt)
        carry["mean"].copy_(mean)
        carry["cov"].copy_(cov)
        carry["w"].copy_(total)
        return carry
