"""DE-MC(Z): differential evolution with an archive of past states.

The counterpart of ``emcee_tpu/moves/de_z.py:32-280`` (ter Braak & Vrugt
2008): the pair pool of each group is the frozen complement together
with the filled part of an archive of past ensemble rows, a ring buffer
carried from proposal to proposal; ``g1_prob`` full-length jumps, the
``de_noise`` term scaled by the complement's spread, and a snooker
update from the pool.  K10 proposes (below); each split's accept/select is
K2.

The carry is ``{z (capacity, ndim) float32, filled, ptr, t}`` (int32
words), updated in place by :meth:`DEZMove.update_carry` (a strided,
rotating subsample of the post-accept ensemble written at ``(ptr +
arange(nrows)) % capacity``), so a recorded graph reads and writes the
same archive at every replay.  Pool index ``r`` reads complement row
``r`` for ``r < nc`` and archive row ``r - nc`` otherwise: the two are
never concatenated (at 1e5 walkers the archive holds 1e6 rows, 20 MB a
copy).  The number of rows to draw from, ``nc + filled``, is read from
the device word, and a pick is ``min(int(u * n), n - 1)`` of a Philox
uniform.

K10 does the work (``ops/dez_kernel.py``, ``csrc/dez_propose.cu``,
``csrc/dez_archive.cu``): a split's proposal is K10a (the complement's
spread partials, read in place; only where ``de_noise > 0``) and K10b (the
spread's floor, the draws, the pool rows, ``q`` and the factor), then K2;
the carry update is K10c.  On the CPU the same calls run the kernels'
plain versions.

The rung axis (parallel tempering: ``emcee_tpu/parallel/tempering.py:
439-541`` vmaps DE-Z over the ladder with one archive a rung): the move is
``rung_batched``, so a ladder proposes every rung at once on ``(T,
nwalkers, ndim)`` buffers with ``(T, ...)`` carries under the rungs' keys;
each kernel launch serves every rung and computes each exactly as alone,
so the batched path equals the per-rung loop bit for bit.

The draws: uniforms at ``(row, DEZ_BLOCK | k)`` (``i, j, a, b`` at k =
0; ``e``, the jump and the snooker select at k = 1) and normals at
``(row, NORMAL_BLOCK | k)`` (column 0 the gamma jitter, 1.. the noise).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import dez_kernel
from ..ops.de_kernel import de_gamma0
from .red_blue import RedBlueMove

__all__ = ["DEZMove"]


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
    rung_batched = True

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

    def _config(self, model, nd):
        """The move's constants as K10b takes them."""
        return dez_kernel.DezConfig(
            de_gamma0(self.gamma0, model.global_ndim(nd)), self.sigma,
            self.g1_prob, self.snooker_prob, self.gammas, self.de_noise,
            model.global_ndim(nd) - 1.0)

    def get_proposal(self, rng, coords, split, model, extra=None,
                     scale=None, carry=None):
        """The proposal of group ``split``: K10a (where ``de_noise > 0``)
        and K10b.  ``extra`` injects draws as a dict (the parity mode): the
        raw picks ``i, j, a, b, e`` (int tensors, ``j`` before it is moved
        past ``i``), the bools ``jump`` and ``snooker``, and ``z`` ``(ng, 1
        + ndim)`` normals (the gamma jitter, then the noise); on the rung
        axis (``coords`` ``(T, nwalkers, ndim)``, ``rng``'s seed a
        :class:`~..ops.philox.RungKeys`) each with a leading ``T`` axis."""
        seed, offset = rng
        nw, nd = coords.shape[-2:]
        ng = nw // self.nsplits
        part = None
        if self.de_noise > 0.0:
            part = dez_kernel.dez_spread(coords, (split * ng, ng))
        return dez_kernel.dez_propose(
            coords, split, self.nsplits, carry["z"], carry["filled"], part,
            seed, offset, self._config(model, nd), extra)

    def update_carry(self, carry, state, model):
        """Fold a strided, rotating ensemble subsample into the ring, in
        place (K10c): rows ``(t + arange(u) * stride) % nwalkers`` written
        at ``(ptr + arange(u)) % capacity`` (``emcee_tpu/moves/de_z.py:
        227-280``; the base advances by one walker per update, so every
        walker reaches the archive in ``stride`` updates)."""
        coords = state.coords
        dez_kernel.dez_fold(coords, carry["z"], carry["filled"],
                            carry["ptr"], carry["t"],
                            self._rows(coords.shape[-2]))
        return carry
