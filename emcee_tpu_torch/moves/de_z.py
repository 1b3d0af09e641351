"""DE-MC(Z): differential evolution with an archive of past states.

The counterpart of ``emcee_tpu/moves/de_z.py:32-280`` (ter Braak & Vrugt
2008): the pair pool of each group is the frozen complement together
with the filled part of an archive of past ensemble rows, a ring buffer
carried from proposal to proposal; ``g1_prob`` full-length jumps, the
``de_noise`` term scaled by the complement's spread, and a snooker
update from the pool.  Plain torch; each split's accept/select is K2.

The carry is ``{z (capacity, ndim) float32, filled, ptr, t}``, updated
in place by :meth:`DEZMove.update_carry` (a strided, rotating subsample
of the post-accept ensemble written at ``(ptr + arange(nrows)) %
capacity``), so a recorded graph reads and writes the same archive at
every replay.  Pool index ``r`` reads complement row ``r`` for ``r <
nc`` and archive row ``r - nc`` otherwise: the two are never
concatenated (at 1e5 walkers the archive holds 1e6 rows, 20 MB a copy).
The number of rows to draw from, ``nc + filled``, is a device tensor,
and a pick is ``min(int(u * n), n - 1)`` of a Philox uniform.

The draws: uniforms at ``(row, DEZ_BLOCK | k)`` (``i, j, a, b`` at k =
0; ``e``, the jump and the snooker select at k = 1) and normals at
``(row, NORMAL_BLOCK | k)`` (column 0 the gamma jitter, 1.. the noise).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops._wrap import complement_rows
from ..ops.de_kernel import de_gamma0
from ..ops.philox import DEZ_BLOCK, normals, row_uniforms
from .red_blue import RedBlueMove
from .walk import complement

__all__ = ["DEZMove"]


#: the draws a DE-Z proposal takes, each injectable
_DRAWS = ("i", "j", "a", "b", "e", "jump", "snooker")


def _pick(u, n):
    """``min(int(u * n), n - 1)`` for a float32 uniform ``u`` and a row
    count ``n`` (an int64 device tensor): the port's ``randint(0, n)``."""
    return torch.minimum((u * n.to(u.dtype)).to(torch.int64), n - 1)


class DEZMove(RedBlueMove):
    """Differential evolution from past states (DE-MC(Z)).

    Args:
        sigma: stddev of the Gaussian jitter on gamma (default 1e-5).
        gamma0: mean stretch factor; default ``2.38 / sqrt(2 ndim)``.
        g1_prob: per-walker probability of a ``gamma = 1`` jump.
        snooker_prob: per-walker probability of a snooker update.
        gammas: the snooker's stretch (default 1.7).
        de_noise: scale of the additive noise relative to the
            complement's per-dimension spread (default 1e-2).
        archive_size: ring capacity in rows (default ``max(10 *
            nwalkers, 1024)``, rounded up to a multiple of
            ``update_rows``).
        update_rows: ensemble rows folded in per proposal (default 64;
            clamped to the ensemble size).
        archive_init: optional ``(n, ndim)`` states pre-loaded into the
            archive.

    For ``nwalkers < 2 * ndim`` pass ``live_dangerously=True``.
    """

    wants_carry = True
    blendable = False
    _param_shard_ok = False

    def __init__(self, sigma=1.0e-5, gamma0=None, g1_prob=0.1,
                 snooker_prob=0.1, gammas=1.7, de_noise=1.0e-2,
                 archive_size=None, update_rows=64, archive_init=None,
                 **kwargs):
        self.sigma = float(sigma)
        self.gamma0 = gamma0
        self.g1_prob = float(g1_prob)
        if not 0.0 <= self.g1_prob <= 1.0:
            raise ValueError("g1_prob must be in [0, 1]")
        self.snooker_prob = float(snooker_prob)
        if not 0.0 <= self.snooker_prob <= 1.0:
            raise ValueError("snooker_prob must be in [0, 1]")
        self.gammas = float(gammas)
        self.de_noise = float(de_noise)
        if self.de_noise < 0.0:
            raise ValueError("de_noise must be >= 0")
        self.archive_size = archive_size
        self.update_rows = int(update_rows)
        if self.update_rows < 1:
            raise ValueError("update_rows must be >= 1")
        if archive_init is not None:
            archive_init = np.asarray(archive_init, dtype=np.float32)
            if archive_init.ndim != 2:
                raise ValueError(
                    "archive_init must be a (n, ndim) array of states"
                )
        self.archive_init = archive_init
        super().__init__(**kwargs)

    def _capacity(self, nwalkers):
        k = self.archive_size
        if k is None:
            k = max(10 * nwalkers, 1024)
        u = self.update_rows
        return ((int(k) + u - 1) // u) * u  # multiple of update_rows

    def _rows(self, nwalkers):
        """Rows folded in per update: distinct walkers, at least one."""
        return min(max(1, self.update_rows), nwalkers)

    def init_carry(self, nwalkers, ndim, device=None):
        k = self._capacity(nwalkers)
        nrows = self._rows(nwalkers)
        if nrows > k:
            raise ValueError(
                f"archive_size ({k}) is smaller than one update's rows "
                f"({nrows}); raise archive_size or lower update_rows — "
                "a same-scatter wrap would drop rows nondeterministically"
            )
        z = torch.zeros((k, ndim), dtype=torch.float32, device=device)
        filled = 0
        if self.archive_init is not None:
            seed = self.archive_init
            if seed.shape[1] != ndim:
                raise ValueError(
                    f"archive_init has {seed.shape[1]} columns; the "
                    f"sampler has ndim={ndim}"
                )
            filled = min(seed.shape[0], k)
            z[:filled] = torch.as_tensor(seed[:filled], device=device)

        def word(v):
            return torch.tensor(v, dtype=torch.int32, device=device)

        # The next write lands after the seed (or at 0 when it exactly
        # fills the ring).
        return {"z": z, "filled": word(filled), "ptr": word(filled % k),
                "t": word(0)}

    def get_proposal(self, rng, coords, split, model, extra=None,
                     scale=None, carry=None):
        """The proposal of group ``split``.  ``extra`` injects draws as a
        dict (the parity mode): the raw picks ``i, j, a, b, e`` (int
        tensors, ``j`` before it is moved past ``i``), the bools ``jump``
        and ``snooker``, and ``z`` ``(ng, 1 + ndim)`` normals (the gamma
        jitter, then the noise)."""
        seed, offset = rng
        nw, nd = coords.shape
        ng = nw // self.nsplits
        nc = nw - ng
        dev, dt = coords.device, coords.dtype
        row0 = split * ng
        s = coords[row0:row0 + ng]
        archive = carry["z"]
        n_avail = nc + carry["filled"].to(torch.int64)
        d = dict(extra or {})
        if any(k not in d for k in _DRAWS):
            u = row_uniforms(ng, 8, seed, offset, dev, dt, row0=row0,
                             block=DEZ_BLOCK)
            for k, col in zip(("i", "a", "b", "e"), (0, 2, 3, 4)):
                d.setdefault(k, _pick(u[:, col], n_avail))
            d.setdefault("j", _pick(u[:, 1], n_avail - 1))
            d.setdefault("jump", u[:, 5] < self.g1_prob)
            d.setdefault("snooker", u[:, 6] < self.snooker_prob)
        z = d.get("z")
        if z is None:
            z = normals(ng, 1 + nd, seed, offset, dev, dt, row0=row0)

        def pool(r):
            """Rows ``r`` of ``complement ++ archive[:filled]``."""
            r = r.to(torch.int64)
            crow = complement_rows(torch.clamp(r, max=nc - 1), split, ng)
            arow = torch.clamp(r - nc, min=0)
            return torch.where((r < nc)[:, None], coords[crow],
                               archive[arow].to(dt))

        i, j = d["i"].to(torch.int64), d["j"].to(torch.int64)
        j = torch.where(j >= i, j + 1, j)
        diffs = pool(j) - pool(i)
        g0 = de_gamma0(self.gamma0, model.global_ndim(nd))
        gamma = g0 * (1.0 + self.sigma * z[:, :1])
        if self.g1_prob > 0.0:
            gamma = torch.where(d["jump"][:, None], torch.ones_like(gamma),
                                gamma)
        q = s + gamma * diffs
        if self.de_noise > 0.0:
            spread = complement(coords, split, ng).std(dim=0, correction=0)
            spread = torch.maximum(spread, 0.01 * spread.mean() + 1e-12)
            q = q + self.de_noise * spread * z[:, 1:]
        factors = torch.zeros(ng, dtype=dt, device=dev)
        if self.snooker_prob > 0.0:
            zr = pool(d["a"])
            delta = s - zr
            norm = torch.sqrt(torch.clamp((delta * delta).sum(-1),
                                          min=1e-24))
            u_dir = delta / norm[:, None]
            proj = (u_dir * (pool(d["b"]) - pool(d["e"]))).sum(-1)
            gp = self.gammas * proj
            q_sn = s + u_dir * gp[:, None]
            f_sn = (model.global_ndim(nd) - 1.0) * (
                torch.log(torch.clamp((norm + gp).abs(), min=1e-24))
                - torch.log(norm))
            use_sn = d["snooker"]
            q = torch.where(use_sn[:, None], q_sn, q)
            factors = torch.where(use_sn, f_sn, factors)
        return q, factors

    def update_carry(self, carry, state, model):
        """Fold a strided, rotating ensemble subsample into the ring, in
        place: rows ``(t + arange(u) * stride) % nwalkers`` written at
        ``(ptr + arange(u)) % capacity`` (``emcee_tpu/moves/de_z.py:
        227-280``; the base advances by one walker per update, so every
        walker reaches the archive in ``stride`` updates)."""
        coords = state.coords
        nw = coords.shape[0]
        nrows = self._rows(nw)
        stride = max(1, nw // nrows)
        z = carry["z"]
        k = z.shape[0]
        ar = torch.arange(nrows, dtype=torch.int64, device=coords.device)
        idx = (carry["t"].to(torch.int64) + ar * stride) % nw
        slots = (carry["ptr"].to(torch.int64) + ar) % k
        z.index_copy_(0, slots, coords.index_select(0, idx).to(z.dtype))
        carry["filled"].copy_(torch.clamp(carry["filled"] + nrows, max=k))
        carry["ptr"].copy_((carry["ptr"] + nrows) % k)
        carry["t"].add_(1)
        return carry
