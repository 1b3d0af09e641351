#!/usr/bin/env python3
"""Drive the port's main path on one CUDA GPU and check its kernels.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU
(``sm_90a``) and the CUDA toolkit.  It builds the kernels from
``emcee_tpu_torch/csrc`` into ``build/kernels/``, then:

0. prints the device name and ``nvidia-smi``'s name and power limit;
1. builds every kernel (one ``nvcc`` per source, in parallel);
2. holds K1 (stretch proposal) and K2 (accept/select) against their plain
   PyTorch versions at the main path's shapes, with injected uniforms and
   with the in-kernel Philox stream (host offset and device offset word),
   in both pair modes, and one whole proposal of the kernel path against
   the plain path; sweeps K1 and K2 over edge shapes (ndim 1, 3, 5, 8;
   a split size no tile divides; nsplits 2-4, spans that are not 16-byte
   aligned; all, none, NaN and +-inf acceptance; with and without a count
   buffer), bit for bit; and holds 64 graph-replayed main-path proposals
   against the same 64 run eagerly on the plain versions, bit for bit;
3. runs the main path (1e5 walkers, 5-D unit Gaussian, blocked/roll
   stretch move) with ``store=False``: every proposal a replay of K3, the
   chunk program's CUDA graphs, and no timed run records a graph or calls
   a kernel wrapper;
4. stores 100 kept steps at ``thin_by=20`` into the host ``Backend`` and
   into ``DeviceBackend`` (each beside the same proposals unstored) and
   estimates tau, walker-steps/s and ESS/s; then profiles a window of the
   main path: device time by kernel, the device idle share, host time per
   replay, and each kernel's launches as the profiler counts them, held
   to exactly 2 x K1 and 2 x K2 per proposal;
5. runs the reference defaults (``StretchMove()``) at full width;
7. holds K5a (DE proposal) and K5b (DE-snooker proposal) against their
   plain versions bit for bit at workload 3's shapes (ng = 5000,
   ndim = 100), both pair modes, snooker with nsplits 2 and 4, injected
   draws and the in-kernel Philox stream (host offset and device offset
   word); K2 at ndim = 100; the edge-shape sweep of K1 and K2 at ndim 100
   and 129; the edge-shape sweep of K5a and K5b (ndim 1-129, a split size
   no tile divides, nsplits 2-4, both pair modes, injected / host offset
   / device offset draws, scale unset and set, bases that are not 16-byte
   aligned, K5a's staged variant, K5b's warps taking walkers in turn),
   bit for bit; one whole proposal of each move on the kernel path
   against the plain path, bit for bit; and 64 graph-replayed workload-3
   proposals against the same 64 run eagerly on the plain versions;
8. runs workload 3 (``benchmarks/workload3.py:57-77``: 1e4 walkers, 100-D
   correlated Gaussian, DE 0.8 + snooker 0.2, roll, blocked) with
   ``store=False``, with ``mixture_block=4``, and stored into
   ``DeviceBackend`` (256 kept x ``thin_by=16``) for tau and ESS/s; then
   profiles a window of it, with the profiler's launches held to exactly
   2 x K5a per DE proposal, 2 x K5b per snooker proposal and 2 x K2 per
   proposal;
6. times each kernel and its plain version alone with CUDA events (K2
   also at ndim = 100), K1 and K2 over tiles of 16-256 walkers with K2's
   two variants (q staged in shared memory or read directly) at both
   shapes, K5a (its two variants: own rows read directly or staged by a
   bulk copy) and K5b over tiles of 4-64 at workload 3's shape, and both
   paths on the plain versions for reference;
9. K3: from the same state and seed, the graph-replayed chain equals the
   eager per-proposal chain (the sampler's private ``_use_graphs``
   switch) on the main path, ``StretchMove()``, the host ``Backend``,
   ``DeviceBackend``, ``tune=True`` and workload 3 with
   ``mixture_block`` 1 and 4 (coords, log_prob, acceptance counts,
   random_state); eager and graph rates in turns (eager, graph, graph,
   eager); K3's replay and host times; and a log-prob that synchronizes
   with the host is refused with an error.

10. the MH, Gaussian (K19), walk and KDE (K7) moves at full width
   through K3 (K7's launches held to exactly 2 a KDE
   proposal: one a split for ``s`` and ``q``), K6, the diagnostics and
   ``run_until_converged`` (K6's calls on its kernels counted);
11. blobs and io: K2 with blob leaves against its plain version bit for
   bit (six dtypes, five row shapes, 1-3, 17 and 33 leaves, unaligned
   bases, scalar leaves through registers, scalar and wider leaves in
   one launch, 1- and 16-byte units, nsplits 1 and 2, ng 5003, 50000
   and 37, through the wrapper and forced onto each path) and the main
   path's three leaves timed through registers and by phase C; the
   main path with the blobs tutorial's three blobs (``blobs_dtype``):
   rates with and without blobs in turns, the host ``Backend`` and
   ``DeviceBackend`` from one start (chains and blobs equal), stored
   blobs against the function at the stored coords, K2's device time with
   and without blob leaves inside replays; ``io_dtype=float16`` into both
   backends; workload 2 (the line fit with a blob) at its own size with
   its oracle; and the ``HDFBackend`` where h5py is installed (else it
   prints ``hdf: h5py not installed`` and goes on).

12. the extension moves at full width through ``run_mcmc``: (a)
   ``bench.py``'s DIME stage (1e5 x 5-D, ``aimh_prob=1``, ``df=None``,
   ``DeviceBackend``, 400 kept, a warm run then two timed runs; tau,
   ESS/s, acceptance, device time and kernels a proposal with K8's
   launches held to 3 K8a, 3 K8b, 2 K8c and 2 K2 a proposal, K8 in float32
   against its plain versions in float64); (b) its bimodal stage
   (1e5 x 3-D, K = 2, ``df=10``, 400 kept x 2; the mode fraction; 0
   exhaustions in a ``df=7.5`` twin; K8's launches held likewise) and both
   chi-square routes on the card (K-S, 0 exhaustions); (c)
   ``BlendedMove`` on workload 3 through K5a + K5b and K20 in turns with
   the sampler-level mixture (launches by the profiler); (d)
   ``SideMove(roll)`` and ``EnsembleSliceMove()`` at 1e5 x 5-D (graph
   chains == eager chains; the slice move's K9 and K14 launches held
   exactly by device words beside the profiler's, its block replays,
   flag reads, trips and rows evaluated beside the evaluations needed,
   ``loop_block`` in turns, its caps binding); (e) K10a, K10b and K10c (DE-Z's
   spread, proposal and archive fold) against their plain versions bit
   for bit (ndim 1-129, 37-5e4 walkers a split, nsplits 2-4, the ring
   empty, partly filled, full and wrapping, every branch of ``g1_prob``,
   ``snooker_prob`` and ``de_noise``, a complement at mean 1e4, injected /
   host offset / device offset draws, unaligned bases), ``DEZMove`` at 8
   x 10-D (12000 proposals, the moment checks) and at 1e5 x 5-D with its
   1e6-row archive (graph chain == plain eager chain; launches held to 2
   K10a, 2 K10b, 1 K10c, 2 K2 and 1 K14 a proposal with the shuffle's,
   by the profiler and by device words).  ``python3 chip_smoke.py 12``
   runs phases 0, 1 and 12 alone (``11`` likewise phase 11).

13. the gradient moves: (e) K11 (Langevin step), K12 (Hastings /
   kinetic reduction) and K13 (leapfrog) against their plain versions,
   ``torch.equal``, over ndim 1-128 and 1-1e5 rows in every mode (K11
   also at unaligned bases and other tiles than its plan's; its tile
   sweep, its instructions from the compiled kernel, and its time beside
   the same bytes copied); (a)
   ``bench.py``'s MALA stage (1e5 x 5-D, ``MALAMove(1.0)``,
   ``DeviceBackend``, 500 kept x 2, a warm run and two timed ones; tau,
   ESS/s, device time a proposal and the gradient's share by the
   profiler); (b) ``HMCMove(0.5, n_leapfrog=10, jitter=0.2)`` at the
   same width, beside its ``jitter=0`` twin; (c) ``ChEESHMCMove`` (200
   tuning proposals, then 200 production replays against the eager
   chain; log T, trips and flag reads a proposal); (d)
   ``EnsembleMALAMove()`` and ``EnsembleHMCMove()`` on workload 3's
   target; every graph chain
   against the plain versions' eager chain, bit for bit; each path's
   replayed launches counted on the card in graphs of its own sampler
   (``counted_replays``), the profiler's count beside.  ``python3
   chip_smoke.py 13`` runs phases 0, 1 and 13 alone.

14. parallel tempering (workload 4, ``benchmarks/workloads5.py:196-262``
   ``pt_multimodal``): (a) K1 and K2 with the rung axis against their
   plain versions bit for bit (1-16 rungs, 6-1000 walkers, ndim 1, 5, 8
   and 9, nsplits 2 and 3, both pair modes, injected / host offset /
   device offset draws, one rung against the single-ensemble launch; K2
   by the wrapper and by forced plans of 32-512 threads with the q rows
   and the leaves through registers or after the decision) and K15,
   the swap (2-16 rungs, ndim 1, 5 and 9, both parities, ``swap_every``
   1 and 3, NaN and +-inf ``logL``, -inf ``logP``; the wrapper's launch
   and blocks of 32, 64 and 128 threads); (b) 64 graph-replayed tempered
   proposals at 16 x 256 (runs of odd lengths, so replays start at both
   parities) against the plain versions' eager chain; (c) the
   rung-batched path against the per-rung loop, bit for bit, and both
   timed in turns; (d) workload 4 at full size, ``PTDeviceBackend``, 512
   kept x ``thin_by=4``: walker-steps/s over all rungs, the cold rung's
   tau and ESS/s, the mean swap acceptance and the cold mode fraction,
   each held to its window, and ``PTDeviceBackend`` == ``PTBackend``;
   (e) a profiled window held to exactly 2 K1, 2 K2, 1 K15, 1 K14 (the
   shuffle's sort keys), 1 K16 and 2 K17 (its order and rows) a proposal; (f) the rows of K1 and K2 with the
   rung axis and of K15, and K15's time a launch over its block sizes.
   ``python3 chip_smoke.py 14`` runs phases 0, 1 and 14 alone.

15. the rest of tempering (workload 4's configuration): (a) K2 with the
   rung axis and user blob leaves (through registers, after the decision
   and both, past 16 leaves; 1-16 rungs, 6-1000 walkers, f32 / f64
   scalars, rows of 1-9 units, int8 ``(3,)`` and int16 ``(3,)`` rows and
   mixes of them, injected / host offset / device offset draws; the
   wrapper and forced plans) and
   K15 with a leaf table (rows of 1-20 bytes at unaligned bases, 2-16
   rungs, both parities, ``swap_every`` 1 and 3, NaN and +-inf ``logL``,
   -inf ``logP``) against their plain versions byte for byte; (b) 64
   graph-replayed proposals of the mixture ``[(StretchMove(), 0.7),
   (DEMove(), 0.3)]`` with the blobs ``(2 logL, x)`` and
   ``adaptive=True``, ``mixture_block`` 1 and 4, against the plain
   versions' eager chain; (c) the blobs at full size into both backends
   (equal chains and blobs; every stored blob the function of its row),
   rates with and without blobs in turns, K2's and K15's device time with
   and without leaves in replays; (d) the mixture at full size (rate,
   cold tau, swap acceptance, phase 14's checks) and each move's device
   time and kernels a proposal alone (DE on every rung at once and forced
   to loop over them); (e) the adaptive ladder from
   ``max_temp=1e6`` against the frozen ladder, and the host's work a
   chunk; (f) ``EnsembleSliceMove`` and ``ChEESHMCMove`` on every rung
   (graph chain == eager chain; the slice move every rung at once ==
   its forced per-rung loop, bit for bit, both timed in turns; µs, flag
   reads and kernels a proposal);
   (g) ``run_until_converged`` on the cold rung; (h) ``PTHDFBackend``
   with ``io_dtype`` and ``parameter_names`` (without h5py it prints
   ``pt-hdf: h5py not installed``); the rows of K2 with the blobs'
   leaves on the rung axis and of K15 with leaves.  ``python3
   chip_smoke.py 15`` runs phases 0, 1 and 15 alone.

16. K14, the counter-based Philox draws (``csrc/philox_draw.cu``): (a)
   against its plain version (the torch rounds), ``torch.equal``, in
   every kind (words, uniforms, normals) and dtype, 1 to 1e5+3 rows, 1
   to 17 counters a row, lanes from 0 and above, the rung axis (1-16
   rungs, with and without ``ROLL_LANE``), int and device blocks, host
   and device offsets, the public draws against their ``plain=True``
   twins, graph replays, counters against ``philox4x32_scalar``, and
   forced launch plans (blocks of 32-1024 threads, rows with and without
   a tail, blocks across rungs, graph replays); (b) its row: device time
   a launch at workload 4's shape (phase 14's replays) and at the DIME
   stage's (alone: the stage draws in K8c), eagerly (also over other
   blocks), back to back
   and plain, beside its bounds and two yardsticks: torch's fill of the
   same output and torch's own Philox draw into it.  ``python3
   chip_smoke.py 16`` runs phases 0, 1 and 16 alone (with a short
   workload-4 run of its own for the replays).  Every path's exact launch counts (phases 4, 8, 10-15)
   name K14's launches a proposal; the row gives those counted in this
   run at workload 4 and (with phase 12) the DIME stage.

17. DE and DE-snooker on every rung (K5a and K5b with the rung axis):
   (a) both kernels against their plain versions bit for bit (2-64
   rungs, 1-1000 walkers a split, ndim 1-100, nsplits 2-4, both pair
   modes, injected / host offset / device offset draws, scale per rung,
   bases off 16 bytes, K5a staged and direct, K5b one warp for a tile,
   each rung against the one-ensemble launch); (b) ``DEMove()``,
   ``DESnookerMove()`` and the mixture DE 0.8 + snooker 0.2 at workload
   4's configuration: graph chain == the plain versions' eager chain and
   the batched path == the per-rung loop over 64 proposals, bit for bit;
   (c) both paths in turns (batched, loop, loop, batched), device µs and
   kernels a proposal, the batched path's launches counted by device
   words (2 K5a a DE proposal, 4 K5b a snooker one); (d) 512 kept x 4
   into ``PTDeviceBackend`` with phase 14's checks; (e) the rows of K5a
   and K5b with the rung axis.  ``python3 chip_smoke.py 17`` runs phases
   0, 1 and 17 alone.

18. the gradient moves on every rung (K11, K12 and K13 with the rung
   axis): (a) the three kernels against their plain versions bit for bit
   (1-64 rungs, 1-1000 rows a rung, ndim 1-128, eps per rung; K11 drawing
   and in MALA mode with the identity and a diagonal, with and without
   the ``(T,)`` jitter, injected / host offset / device offset draws; K12
   both modes; K13 0-2 kicks with and without the drift; each rung at 3
   rungs against the one-ensemble launch); (b) ``MALAMove(0.8)``,
   ``HMCMove(0.5, n_leapfrog=10, jitter=0.2)``, ``EnsembleMALAMove()``
   and ``EnsembleHMCMove()`` at workload 4's configuration: graph chain
   == the plain versions' eager chain bit for bit over 64 proposals, and
   the batched path against the per-rung loop: bit for bit over the 64
   for the whole-ensemble moves; for the ensemble moves, whose batched
   matmuls and Cholesky round otherwise, each rung's metric held to its
   own to 1e-4 and one proposal's difference logged; (c) both paths in
   turns (batched,
   loop, loop, batched), device µs and kernels a proposal, the batched
   path's launches counted by device words; (d) ``MALAMove(0.8)`` into
   ``PTDeviceBackend``, 512 kept x 4: rate, cold tau and ESS/s, a finite
   chain and ``PTDeviceBackend`` == ``PTBackend``; (e) the rows of K11,
   K12 and K13 with the rung axis.  ``python3 chip_smoke.py 18`` runs
   phases 0, 1 and 18 alone.

19. K7, the KDE log-density (``csrc/kde_logpdf.cu``): (a) K7 against its
   plain version bit for bit (NaN included): rows 1-1e5, kernels 1-5e4
   with lanes left idle, ndim 1-128 (above 8 through shared memory, at
   128 above 48 KB of it), forced plans, rows far from every kernel, a
   NaN factor and ``s`` and ``q`` stacked through ``moves/kde.py``, and
   the rung axis (1-64 rungs, each rung of 3 against the one-ensemble
   launch); (b) K7 alone at phase 10's shape (5e4 x 5e4 x 5) beside the
   blocked matmul + logsumexp route it replaced ("before"), the plain
   version, each route's peak memory, the bound, and rows a warp x tiles
   timed; (c) ``KDEMove()`` at 1e5 x 5-D: walker-steps/s graph against
   eager in turns, device µs and kernels a proposal, launches by device
   words (2 K7, 2 K2, 5 K14); (d) ``KDEMove()`` at workload 4's
   configuration: graph chain == the plain versions' eager chain bit for
   bit, the batched path against the per-rung loop (bit for bit, or each
   rung's kernel covariance and factor held to 1e-4), both in turns,
   launches by device words (2 K7, 2 K2, 5 K14, 1 K15), K7's rows a warp
   timed in the ladder's replays, and 512 kept x 4 into
   ``PTDeviceBackend`` held to phase 14's windows; (e) the rows of K7 and
   K7 with the rung axis.  ``python3 chip_smoke.py 19`` runs phases 0, 1
   and 19 alone.

20. the shuffled split (K16, the group order, ``csrc/shuffle_order.cu``;
   K17, the rows, ``csrc/gather_rows.cu``): (a) K16 against its plain
   version, ``torch.equal``, 1-64 segments of 2 to 200004 walkers, nsplits
   2-4, Philox keys at a host offset and a device word and injected keys
   with ties (all equal, two values, sorted, reversed), through the
   wrapper's plan and forced chunks (the rank, bitonic and merge routes),
   and graph replays at a device offset word; (b) K17 against ``index_select`` /
   ``index_copy_`` byte for byte (float32, float64, int64, int32, int16,
   int8 and bool, rows of 1-129 units, 1-34 buffers a call, bases off 16
   bytes, 1000 rows, workload 4's flat rung rows and 1e5 rows); (c) 64
   graph-replayed proposals against the plain versions' eager chain, bit
   for bit: workload 4, ``DEMove()`` on the ladder, ``StretchMove()`` and
   ``EnsembleSliceMove()`` at 1e5 walkers; (d) the slice's main path,
   counted from 0 just before it: workload 4 and ``StretchMove()`` at 1e5,
   device µs and kernels a proposal and each kernel's µs a launch in
   replays, the replayed launches held exactly (K16 one launch a
   proposal on the ladder, its plan's at 1e5; K17 one each way); K16 and
   K17 alone at both shapes beside their plain versions,
   ``torch.argsort(stable=True)`` of the same keys and the
   ``index_select`` / ``index_copy_`` calls of the plain route, K16's
   bitonic block beside its rank route on the ladder and its chunks at
   1e5; (e) the rows of K16 and K17.  ``python3 chip_smoke.py
   20`` runs phases 0, 1 and 20 alone.  Every shuffled path's exact
   launch counts (phases 10, 12-19) name K16 and K17.

21. K8, DIME's moments, factor and proposal (K8a and K8b,
   ``csrc/dime_moments.cu``; K8c, ``csrc/dime_propose.cu``): (a) the three
   against their plain versions bit for bit (NaN included): ndim 1, 3, 5
   and 100, one ensemble with ten K8a blocks a set and three rungs of 7
   walkers a split, 1-3 components, ``df`` None, 10 and 7.5, ``aimh_prob``
   0.3 and 1, cold and warm carries, both splits and the carry update,
   each rung of three against the one-ensemble launch, injected draws, a
   device offset word, a shape with no factor; (b) each alone at the DIME
   stage's and the bimodal stage's shapes (CUDA events around graph
   replays), the carry update, the plain versions, the yardsticks
   ``torch.cov`` and ``torch.linalg.cholesky_ex``, the bounds; (c) the
   DIME stage's replays: device us and kernels a proposal, us a launch,
   launches by device words (3 K8a, 3 K8b, 2 K8c, 2 K2 a proposal); (d)
   ``DIMEMove()`` and ``DIMEMove(aimh_prob=0.3, n_components=2)`` at
   workload 4's configuration: graph chain == the plain versions' eager
   chain and the batched path == the per-rung loop over 64 proposals, bit
   for bit with the carries; both in turns; the batched launches by
   device words; 512 kept x 4 into ``PTDeviceBackend`` (rate, cold tau)
   held to phase 14's windows, and ``PTDeviceBackend`` == ``PTBackend``;
   (e) the rows of K8a, K8b and
   K8c, one ensemble and with the rung axis.  ``python3 chip_smoke.py 21``
   runs phases 0, 1 and 21 alone.

22. K10, DE-Z's spread, proposal and archive fold: (a) K10a, K10b and
   K10c with the rung axis against their plain versions and each rung
   against the one-ensemble launch, bit for bit; (b) each alone at 1e5 x
   5-D and at workload 4's ladder (CUDA events around graph replays)
   beside its plain version, its bound and its yardstick
   (``torch.std(correction=0)`` of the complement; ``index_select`` +
   ``index_copy_`` of the folded rows), and K10a + K10b over (rows a
   run, runs a block); (c) ``DEZMove()`` at 1e5 x 5-D:
   device time and kernels a proposal, launches by device words; (d)
   ``DEZMove()`` at workload 4's configuration as phase 21's (d) holds
   DIME's: graph == eager plain, batched == per-rung loop with every
   rung's archive and words, turns, launches by device words, 512 kept x
   4 in phase 14's windows, ``PTDeviceBackend`` == ``PTBackend``; (e) the
   rows of K10a, K10b and K10c, one ensemble and with the rung axis.
   ``python3 chip_smoke.py 22`` runs phases 0, 1 and 22 alone.

23. K9, the slice move's loops on compacted lists (K9a the setup, K9b a
   stepping-out trip, K9c a shrink trip or its first list, K9d the
   finish, ``csrc/slice_loops.cu``): (a) each against its plain version
   in lockstep over a group's whole loops, every buffer of the loop state
   and the ensemble compared bit for bit after every launch (ndim 1, 2,
   5, 8 and 100; groups odd, at bucket boundaries and of 5e4; 1, 3 and 16
   rungs; binding caps; blobs; a tuned scale; injected draws; a device
   offset word; bucket floors and trips a block); (b) each alone at the
   first trip of its loop at 1e5 x 5-D and at workload 4's ladder (CUDA
   events) beside its plain version and its bound; (c) the bucket floor
   at 1e5 (host and device µs a proposal, rows evaluated); (d)
   ``EnsembleSliceMove()``'s replays at 1e5 and on workload 4's ladder:
   launches by device words (held exactly), device µs and kernels a
   proposal, each K9 kernel's µs a launch; (e) the rows of K9a-K9d, one
   ensemble and with the rung axis.  ``python3 chip_smoke.py 23`` runs
   phases 0, 1 and 23 alone.

24. K6, the diagnostics' fused chains (K6a ``acf_center`` / ``acf_power``
   and K6b ``acf_reduce`` / ``tau_window``, ``csrc/acf.cu``; K6c
   ``rank_keys`` / ``rank_scores`` and K6d ``psrf``, ``csrc/rhat.cu``;
   K16 sorts the keys): (a) every K6 launch against its plain version on
   the same inputs: the ACF at phase 4's shape (100 x 4000 x 5) in one
   chunk and in 40, float64, ``n_t`` 1, 2, 3 and 33, a constant series
   and integer draws, both windows, a thinned and a walker-sliced view
   against their contiguous copies; R-hat split and not, rank-normalised
   and raw, an odd length, integer ties, an all-tied column, NaN, +-0 and
   +-inf draws, float64 (K16's two passes), the split halves and a
   thinned view read in place, the rank passes in parameter groups
   against one group, the raw PSRF of more draws than K16 sorts (the
   rank passes refuse them); each public entry point on a CUDA tensor
   (``integrated_time``, ``ess``, ``function_1d``, ``rhat``'s four
   variants, ``DeviceBackend.get_autocorr_time``) with its launches held
   and torch's sort, cumulative sums, scatters, ``ndtri`` and ``var``
   refused; the keys, K16's order (== the stable
   ``torch.sort``), the tie groups (the ranks), the medians, the mean ACF
   and the windows bit for bit, the rest within ``K6_TOL``; each whole
   route against the plain route on the card and the float64 host path;
   (b) phase 10's ``run_until_converged`` at full width, the wrappers'
   counts from 0: seconds and device kernels a check (beside the 1566 of
   the plain route), launches, and a check's largest device-to-host copy
   held to ``n_d x 8`` bytes; (c) each K6 wrapper alone at phase 4's
   shape and at the monitor's last chain (CUDA events; R-hat's at the
   route's first parameter group) beside its plain version, the library
   call where one computes it (``acf_power``: ``torch.mul(F, F.conj())``)
   and its bound, with cuFFT's ``rfft`` / ``irfft`` and
   ``torch.sort(stable=True)`` of the same columns as yardsticks; (d) the
   rows of K6a-K6d.  ``python3 chip_smoke.py 24`` runs phases 0, 1 and 24
   alone.

25. The side and walk moves (K5a's side mode, ``csrc/de_propose.cu``;
   K8a and K8b's walk mode, ``csrc/dime_moments.cu``; K18a and K18b,
   ``csrc/walk_propose.cu``): (a) every new kernel and mode against its
   plain version on the same inputs, bit for bit (ndim 1-100, 37-5e4
   walkers a split, 1, 3 and 16 rungs, both splits, scale unset and set,
   a host offset and a device offset word, both pair modes, exact and
   bootstrap subsets of s0 1 to nc - 1, the exact sort at nc 4096 and
   above 4096 by K16 in two ranges of walkers, picks and normals staged
   and drawn as summed, injected draws, each rung against the rung
   alone, a singular complement); (b) each alone at 1e5 x 5-D and on
   workload 4's ladder (CUDA events around graph replays) beside its
   plain version, its bound and the library calls ``cholesky_ex``,
   ``addmm`` / ``baddbmm`` and ``argsort(stable=True)``; (c)
   ``SideMove(roll)``, ``WalkMove()`` and ``WalkMove(s=16)`` at 1e5 on the
   blocked split (graph == plain eager chain, device us and kernels a
   proposal, launches held exactly by device words: no K14) and a
   singular walk complement (every proposal rejected, the chain
   unchanged); (d) ``SideMove()``, ``SideMove(roll)``, ``WalkMove()`` and
   ``WalkMove(s=16)`` on workload 4's ladder (``pt21_path``: graph ==
   eager, batched == per-rung loop bit for bit, turns, launches, 512 kept
   x 4 in phase 14's windows, both backends equal); (e) the rows, one
   ensemble and with the rung axis.  ``python3 chip_smoke.py 25`` runs
   phases 0, 1 and 25 alone.  Phase 10's walk moves and phase 12's side
   move count these kernels too (K14 only for the shuffle's keys).

26. The Gaussian, MH and blended moves on every rung (K19,
   ``csrc/gaussian_propose.cu``; K20, ``csrc/blend_select.cu``): (a) K19
   and K20 against their plain versions on the same inputs, bit for bit
   (ndim 1-129, 1-1e5 walkers, 1, 2 and 16 rungs, every covariance and
   mode, a factor and tuning, a host offset and a device offset word,
   injected draws, 2-4 sub-moves, drawn, injected and out-of-range
   choices, each rung against the rung alone) and K2's rung kernel at
   ``nsplits=1``; (b) each alone at 1e5 x 5-D and on workload 4's ladder
   (CUDA events around graph replays) beside its plain version, its bound
   and the library calls ``torch.add(x, z, alpha)`` and ``addmm`` /
   ``baddbmm`` (K20: none; a copy of its bytes as a yardstick); (c)
   ``GaussianMove(0.5)``, its ``random`` mode, its full covariance,
   phase 10's ``MHMove(Philox normals)`` and the DE + snooker blend at
   1e5 on the blocked split (graph == plain eager chain, device us and
   kernels a proposal, launches held exactly by device words: no K14 but
   the MH function's); (d) the same moves and a three-way blend with the
   side move on workload 4's ladder (``pt21_path``: graph == eager,
   batched == per-rung loop bit for bit, turns, launches, kept x 4 stored,
   both backends equal; the blends held to phase 14's windows, the
   random-walk moves' windows reported); (e) the rows, one ensemble and
   with the rung axis.  ``python3 chip_smoke.py 26`` runs phases 0, 1 and
   26 alone.  Phase 10's Gaussian moves and phase 12's blend count these
   kernels too.

27. ChEES-HMC on every rung (K21a, its start, and K21b, its tuning
   gradient, ``csrc/chees.cu``; K13's masked rung mode,
   ``csrc/leapfrog.cu``): (a) the three against their plain versions on
   the same inputs, bit for bit (K21a: 1-200 rungs and one ensemble's
   ``()`` carry, carries over the clamps' ranges, the counter at its int32
   ends, a cap that binds on some rungs; K13 masked: 2-32 rungs, 1-1000
   rows, ndim 1-128, trips 0-5 a rung, the identity, a diagonal and the
   full metric's two launches, every trip and one past the last, each rung
   against the rung alone; K21b: one ensemble to 1e5 rows and 1-32 rungs,
   ndim 1-128, one block a rung and forced blocks, the three metrics,
   non-finite ``lnpdiff``, each rung against the rung alone); (b) each
   alone at 1e5 x 5-D and on workload 4's ladder (CUDA events around graph
   replays) beside its plain version and its bound (no library call
   computes any of them), and K21b at 1e5 over 256-4096 rows a block; (c) ``ChEESHMCMove(0.5)`` at 1e5 and on workload
   4's ladder, tuning and in production: host and device us and kernels a
   proposal, one flag read a proposal, us a launch, the launches held
   exactly by device words; (d) the rows of K21a and K21b, one ensemble
   and with the rung axis, and of K13's masked rung mode.  ``python3
   chip_smoke.py 27`` runs phases 0, 1 and 27 alone.  Phase 13 (c) and
   phase 15 (f) run ChEES through these kernels too.

Phases run in the order 0-5, 7, 8, 6, 9, 10, 11, 12, 13, 14, 15, 16, 17,
18, 19, 20, 21, 22, 23, 24, 25, 26, 27.  Every phase raises on failure.  ``python3
chip_smoke.py sass-diff TREE`` builds TREE's and this checkout's K1, K2,
K5a, K5b, K11, K12, K13 and K15 and compares their SASS function by
function.

Four modes compare this checkout with another tree inside it (TREE,
e.g. the parent commit unpacked by ``git archive`` into the git-ignored
``build/parent``; a TREE outside this checkout is refused):
``python3 chip_smoke.py main-path TREE`` runs phase 3's main path alone
with TREE's package, for turns of two trees; ``python3 chip_smoke.py
kernel-turn TREE`` times K14 and K2's rung axis in the replays of
workload 4 (with and without its blobs), of the DIME stage and of
``StretchMove()`` at 1e5 walkers with TREE's package (and K16 and K17
where TREE has them; the DE-Z, slice, side, walk, Gaussian, MH and
blended moves' device time and kernels a proposal), likewise;
``python3 chip_smoke.py check-turn TREE`` times one convergence check at
phase 24's monitor's last chain with TREE's package (its seconds, kernels
and device memory), likewise;
``python3 chip_smoke.py phase-times TREE``
runs TREE's whole ``chip_smoke.py`` in a child process, echoes its
output, and prints the seconds each phase took (each output line's wait
charged to the phase it names) and the total.
The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  It exits non-zero, printing no
result, without a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import subprocess
import sys
import time
from pathlib import Path

NW, ND = 100_000, 5
NW3, ND3 = 10_000, 100  # workload 3 (benchmarks/workload3.py:28-29)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# H100 SXM special-function results (exp2, log2, rcp, ...): 132 SMs x 16
# per clock (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) x 1.98 GHz boost clock.
SFU_OPS_PER_S = 132 * 16 * 1.98e9
# H100 SXM instruction issue: 132 SMs x 4 schedulers x one warp
# instruction (32 threads) a clock x 1.98 GHz boost clock, in
# thread-instructions a second.
ISSUE_PER_S = 132 * 4 * 32 * 1.98e9
# The instructions a function needs (not those a build issues), from its
# operations.  A Philox4x32-10 block whose round keys are made once: ten
# rounds of two 32 x 32 -> 64-bit multiplies (IMAD.WIDE) and two
# three-input xors (LOP3).  A stored Box-Muller normal of two words: for
# each word a shift and an int -> float conversion (its exact scaling
# folded into 1 - u and the angle, one instruction each), lg2 and its
# scaling, a sqrt (rsqrt and a multiply), cos (a prescale and the
# special function) and r cos: 13, of them 5 special-function results
# (two conversions, lg2, rsqrt, cos).  The accurate logf and cosf and the
# IEEE sqrt take more, so these are floors.
PHILOX_INSTR = 40
NORMAL_INSTR, NORMAL_SFU = 13, 5
#: an H100 SM's registers and threads (resident blocks a kernel gets)
SM_REGISTERS, SM_THREADS = 65536, 2048
#: ``{kernel label: (registers, static shared bytes, spilled bytes)}`` of
#: every kernel built by this run (phase 1, ``-Xptxas -v``; labels as
#: :func:`demangle` gives them)
PTXAS = {}
RTOL = ATOL = 1e-6
#: walkers per split in the edge-shape sweeps: no tile divides it
SWEEP_NG = 5003
#: ndims of K5a's and K5b's edge-shape sweep (phase 7)
K5_SWEEP_NDS = (1, 3, 5, 8, 100, 129)
#: tiles of K1's and K2's timing sweep (phase 6)
SWEEP_TILES = (16, 32, 64, 128, 256)
#: tiles of K5a's and K5b's timing sweep (phase 6; K5b's cap is 16)
K5_SWEEP_TILES = {"de_propose": (4, 8, 16, 32, 64),
                  "snooker_propose": (4, 8, 16)}
#: the kernel functions a wrapper launches besides ``<wrapper>_kernel``
#: (K2's rung axis has a kernel of its own)
KERNEL_ALIASES = {"accept_select": ("accept_rungs_kernel",),
                  "group_order": ("group_rank_kernel", "group_merge_kernel"),
                  "rank_scores": ("rank_scan_kernel", "rank_finish_kernel"),
                  "walk_subset": ("walk_sort_kernel", "walk_keys_kernel"),
                  "gaussian_propose": ("gaussian_pairs_kernel",
                                       "gaussian_advance_kernel"),
                  "leapfrog": ("leapfrog_masked_kernel",)}


def launched_by(name, key):
    """Whether the profiler's kernel ``key`` is a launch of wrapper
    ``name``'s kernel."""
    return f"{name}_kernel" in key or any(
        a in key for a in KERNEL_ALIASES.get(name, ()))


#: (module under emcee_tpu_torch.ops, wrapper) of every kernel
KERNELS = (("stretch_kernel", "stretch_propose"),
           ("accept_kernel", "accept_select"),
           ("de_kernel", "de_propose"),
           ("snooker_kernel", "snooker_propose"),
           ("langevin_kernel", "langevin_step"),
           ("langevin_kernel", "langevin_factor"),
           ("langevin_kernel", "leapfrog"),
           ("swap_kernel", "pt_swap"),
           ("philox_kernel", "philox_draw"),
           ("kde_kernel", "kde_logpdf"),
           ("shuffle_kernel", "group_order"),
           ("shuffle_kernel", "gather_rows"),
           ("shuffle_kernel", "scatter_rows"),
           ("dime_kernel", "dime_moments"),
           ("dime_kernel", "dime_finish"),
           ("dime_kernel", "dime_propose"),
           ("dez_kernel", "dez_spread"),
           ("dez_kernel", "dez_propose"),
           ("dez_kernel", "dez_fold"),
           ("slice_kernel", "slice_setup"),
           ("slice_kernel", "slice_step_out"),
           ("slice_kernel", "slice_shrink"),
           ("slice_kernel", "slice_finish"),
           ("autocorr_kernel", "acf_center"),
           ("autocorr_kernel", "acf_power"),
           ("autocorr_kernel", "acf_reduce"),
           ("autocorr_kernel", "tau_window"),
           ("autocorr_kernel", "rank_keys"),
           ("autocorr_kernel", "rank_scores"),
           ("autocorr_kernel", "psrf"),
           ("walk_kernel", "walk_propose"),
           ("walk_kernel", "walk_subset"),
           ("gaussian_kernel", "gaussian_propose"),
           ("blend_kernel", "blend_select"),
           ("chees_kernel", "chees_start"),
           ("chees_kernel", "chees_gradient"))
#: the shuffled split's kernels (K16, K17's gather and scatter)
SHUFFLE_KERNELS = ("group_order", "gather_rows", "scatter_rows")
#: their launches a shuffled proposal of workload 4's ladder (16 rungs of
#: 256 walkers, every rung at once): K16's rank route, one launch for
#: every rung, and one K17 each way (:func:`shuffle_per`)
SHUF4 = {"group_order": 1, "gather_rows": 1, "scatter_rows": 1}
#: ndims and rows of K11-K13's edge-shape sweep (phase 13)
GRAD_SWEEP_NDS = (1, 2, 3, 5, 7, 16, 100, 128)
GRAD_SWEEP_ROWS = (1, 2, 31, 5003, 100_000)
#: K11's tiles (rows a block) swept against its plain version beside the
#: plan's own (phase 13): one row, a ragged few, the plan's at 1e5 rows,
#: more than a block's threads
K11_SWEEP_TILES = (1, 5, 127, 300)


def log(msg):
    print(msg, flush=True)


def shuffle_per(T=1, n=NW, nsplits=2, loop=False):
    """K16's and K17's launches a shuffled proposal of ``T`` segments of
    ``n`` walkers (one ensemble, or every rung of a ladder at once; with
    ``loop`` rung by rung, ``T`` times one segment's): K16's plan on this
    card (``shuffle_plan``: one launch on the rank and short routes, one and a merge
    pass each on the long one) and one K17 each way."""
    import torch
    from emcee_tpu_torch.ops._wrap import sm_count
    from emcee_tpu_torch.ops.shuffle_kernel import shuffle_plan

    if loop:
        return {k: T * v for k, v in shuffle_per(1, n, nsplits).items()}
    plan = shuffle_plan(T, n, nsplits, sm_count(torch.cuda.current_device()))
    return {"group_order": plan.launches, "gather_rows": 1,
            "scatter_rows": 1}


def shuffle_of(move, T=1, n=NW):
    """:func:`shuffle_per` of ``move`` (0 of each where it does not
    shuffle: not a red-blue move, or ``randomize_split=False``)."""
    from emcee_tpu_torch.moves.red_blue import RedBlueMove

    if isinstance(move, RedBlueMove) and move.randomize_split:
        return shuffle_per(T, n, move.nsplits)
    return dict.fromkeys(SHUFFLE_KERNELS, 0)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def gaussian(x):
    return -0.5 * (x**2).sum(-1)


def demangle(names):
    """``{mangled name: label}``, by the toolkit's ``cu++filt``: the
    demangled name without ``void``, the anonymous namespaces and the
    parameters, bools as words, e.g. ``langevin_step_kernel<true, true,
    false>``.  Without ``cu++filt`` a name stays mangled (and its
    kernel's registers are then not found: "not measured")."""
    import re

    from emcee_tpu_torch.ops._build import _nvcc

    tool = Path(_nvcc()).parent / "cu++filt"
    if not names or not tool.is_file():
        return {n: n for n in names}
    out = subprocess.run([str(tool), *names], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    labels = {}
    for n, d in zip(names, out.splitlines()):
        d = re.sub(r"<unnamed>::|\(anonymous namespace\)::|^void ", "", d)
        d = re.sub(r"\(bool\)([01])",
                   lambda m: ("false", "true")[int(m.group(1))], d)
        depth = 0
        for i, ch in enumerate(d):  # the parameters: a "(" outside <>
            depth += (ch == "<") - (ch == ">")
            if ch == "(" and depth == 0:
                d = d[:i]
                break
        labels[n] = d.replace(" >", ">")
    return labels


def instruction_bound(instr, sfu):
    """The least time in ms of ``instr`` thread-instructions of which
    ``sfu`` are special-function results: the larger of all of them at
    the issue rate and the special functions at theirs."""
    return max(instr / ISSUE_PER_S, sfu / SFU_OPS_PER_S) * 1e3


def ptxas_table(report):
    """``{kernel label: (registers, static shared bytes, spill stores)}``
    from an ``nvcc -Xptxas -v`` report."""
    import re

    rows, name = [], None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            rows.append((name, int(m.group(1)), int(m.group(2) or 0), spill))
            name = None
    labels = demangle([r[0] for r in rows])
    return {labels[n]: (regs, smem, spill) for n, regs, smem, spill in rows}


def resident_blocks(registers, threads, smem=0):
    """Blocks of ``threads`` an H100 SM holds at once with ``registers`` a
    thread (allocated in units of 8) and ``smem`` bytes a block."""
    regs = -(-registers // 8) * 8 * threads
    return min(SM_THREADS // threads, SM_REGISTERS // regs,
               (228 * 1024) // max(smem + 1024, 1))


def max_err(got, want, rtol=RTOL, atol=ATOL):
    """Max abs error, raising unless |got - want| <= atol + rtol |want|."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    if not bool((diff <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"mismatch: max abs err {float(diff.max())}")
    return float(diff.max())


def cuda_ms(torch, fn, reps=200):
    """Mean time of one call of ``fn`` on the card, by CUDA events."""
    for _ in range(10):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_window(torch, fn, primer=False):
    """Run ``fn`` under ``torch.profiler``; return the wall seconds and
    ``{kernel name: (launches, device microseconds)}`` for every kernel
    the card ran in the window (empty if the profiler saw none).

    With ``primer``, ``fn`` (or ``primer`` itself, a function) runs just
    before the window, in the same trace, and only the events after the
    window's mark are kept:
    late in a long process the profiler loses the first card events of a
    trace (the first ~30 us of work, window after window, in the whole
    script; never with phase 13 alone)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = "profiled window"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if primer:
            (primer if callable(primer) else fn)()
        torch.cuda.synchronize()
        with record_function(mark) if primer else contextlib.nullcontext():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.events()
    start = min((e.time_range.start for e in events if e.name == mark),
                default=-math.inf)
    cards = [e for e in events if e.device_type == DeviceType.CUDA
             and e.name != mark and e.time_range.start >= start]
    WINDOW_EVENTS[:] = sorted((e.time_range.start, e.name) for e in cards)
    kernels = {}
    if primer:
        for e in cards:
            c, us = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (c + 1, us + e.time_range.elapsed_us())
        return wall, kernels
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            kernels[e.key] = (e.count, us)
    return wall, kernels


#: the card's events of the last profiled window, ``(start, name)`` in
#: start order, microseconds from the trace's start
WINDOW_EVENTS = []


def window_events_line(names):
    """Where the last profiled window's card events lie: the first few,
    and the starts of ``names``' launches (a log line for a window whose
    counts differ)."""
    ev = WINDOW_EVENTS
    first = "; ".join(f"{t:.0f} {name[:28]}" for t, name in ev[:6])
    starts = {k: [round(t) for t, name in ev if launched_by(k, name)][:4]
              for k in names}
    return (f"{len(ev)} events from {ev[0][0]:.0f} to {ev[-1][0]:.0f} us "
            f"after the trace's start; the first: {first}; the first "
            f"launches of {starts}" if ev else "no events")


def wrappers():
    """``{wrapper name: (module, wrapper)}`` of every kernel."""
    import importlib

    out = {}
    for mod, name in KERNELS:
        m = importlib.import_module(f"emcee_tpu_torch.ops.{mod}")
        out[name] = (m, getattr(m, name))
    return out


def launch_counts():
    return {name: fn.launches for name, (_, fn) in wrappers().items()}


@contextlib.contextmanager
def plain_kernels():
    """Route the moves through every kernel's plain version (the moves
    look the wrappers up on their modules at each call)."""
    saved = wrappers()
    for name, (m, _) in saved.items():
        setattr(m, name, getattr(m, f"{name}_plain"))
    try:
        yield
    finally:
        for name, (m, fn) in saved.items():
            setattr(m, name, fn)


def device_ms(kernels, kname):
    """Mean device ms per launch of ``kname`` in a profiled window."""
    hits = [(c, us) for key, (c, us) in kernels.items()
            if launched_by(kname, key)]
    if not hits:
        return None
    return sum(us for _, us in hits) / sum(c for c, _ in hits) * 1e-3


def profiled_ms(torch, fn, kname, tries=6, primer=False):
    """Mean device ms per launch of ``kname`` over a profiled window of
    ``fn`` (primed with ``primer``: late in the whole script the profiler
    loses a trace's first ~30 us of card work, all of a window of twenty
    1.5 us launches).  The profiler now and then records no launch at all
    in a window of eager launches, at times several in a row; such a
    window is run again after half a second, up to ``tries`` times, and
    said so."""
    for _ in range(tries):
        _, kernels = profile_window(torch, fn, primer=primer)
        ms = device_ms(kernels, kname)
        if ms is not None:
            return ms
        log(f"  the profiler recorded no {kname} launch; window run again")
        time.sleep(0.5)
    raise AssertionError(f"the profiler recorded no {kname} launch in "
                         f"{tries} windows")


def counted_window(torch, run, expect, what, tries=3):
    """A profiled window of ``run`` (:func:`profile_window`) whose kernel
    launches, as the profiler counts them (:func:`profiled_counts`), must
    equal ``expect()``, the counts of the next window, computed just
    before it (a window advances the chain).  The profiler now and then
    drops events of a window (~100 of 10^4; on the parent's tree too), so
    a window whose counts differ is run again, up to ``tries`` times, and
    said so; a kernel launched too often or too seldom differs in every
    window.  Late in the whole script the profiler loses a trace's first
    card work, the first launch of the first graph replay (one K11 of 32
    MALA proposals; one K14 of a DE-Z window of 64, its shuffle's sort
    keys, in each of three tries), so the window is primed
    (:func:`profile_window`): the same work runs once before the marked
    window, and the expectation is taken after it.  Returns ``(wall,
    kernels, counts, graph replays)``."""
    from emcee_tpu_torch.chunk_graph import ChunkProgram

    for _ in range(tries):
        at = {}

        def primer():
            run()
            torch.cuda.synchronize()
            # A kernel the expectation does not name must not launch.
            at["want"] = {name: 0 for _, name in KERNELS} | expect()
            at["replays"] = ChunkProgram.replays

        wall, kernels = profile_window(torch, run, primer=primer)
        want = at["want"]
        counts = profiled_counts(kernels)
        if counts == want:
            return wall, kernels, counts, ChunkProgram.replays - at["replays"]
        log(f"  {what}: the profiler counted {counts}, expected {want}; "
            "window run again")
    raise AssertionError(f"{what}: profiled launches {counts}, expected "
                         f"{want} in {tries} windows")


def profiled_counts(kernels):
    """``{wrapper name: launches}`` of every kernel, as the profiler
    counted them in a window (graph replays included)."""
    return {name: sum(c for key, (c, _) in kernels.items()
                      if launched_by(name, key))
            for _, name in KERNELS}


def warm_graphs(smp, top=None):
    """Record every graph of a sampler's chunk program now (each move,
    every size up to ``top``, by default ``MAX_GRAPH``), so that no later
    run records one; recording does not move the chain."""
    from emcee_tpu_torch.chunk_graph import MAX_GRAPH

    for i in range(len(smp._moves)):
        if smp._moves[i].looped:
            continue  # recorded by segments in its first run
        size = 1
        while size <= (top or MAX_GRAPH):
            smp._program.graph(i, size, False)
            size *= 2


class LoopLaunches:
    """A kernel's launches in a run of the slice move, from the move's own
    counters: ``fixed`` a proposal (K9a, K9d and K9c's first list: one a
    group) plus, for ``loop`` 0 or 1, the trips of that loop the run ran
    (``_Work.executed``: K9b's or K9c's launches, one a trip, in graph
    replays and eagerly alike)."""

    def __init__(self, move, loop, fixed):
        self.move, self.loop, self.fixed, self.ex0 = move, loop, fixed, 0

    def executed(self):
        return sum(int(w.executed[self.loop])
                   for w in self.move._work.values())

    def begin(self):
        self.ex0 = self.executed()
        return self

    def count(self, proposals, block=None):
        return proposals * self.fixed + self.executed() - self.ex0


def slice_launches(move):
    """K9's launches a proposal of ``move`` (an ``EnsembleSliceMove``):
    K9a, K9d and K9c's first list once a group, K9b and K9c once a trip
    (:class:`LoopLaunches`)."""
    ns = move.nsplits
    return {"slice_setup": ns, "slice_finish": ns,
            "slice_step_out": LoopLaunches(move, 0, 0),
            "slice_shrink": LoopLaunches(move, 1, ns)}


def drive(smp, state, n, per_proposal=None, **kw):
    """``run_mcmc`` with its launch checks; returns ``(state, seconds)``.

    On the graph path, a run of a sampler whose chunk program exists
    records no graph and calls no kernel wrapper: every proposal is a
    replay.  On the eager path (``_use_graphs`` off), the wrappers'
    counters show a proposal kernel twice and K2 twice per proposal, or
    ``per_proposal``'s ``{wrapper: launches per proposal}`` (others 0; a
    :class:`LoopLaunches` gives the run's count from the move's
    counters)."""
    from emcee_tpu_torch.chunk_graph import ChunkProgram

    prog = smp._program
    ngraphs = None if prog is None else len(prog.graphs)
    loop_draws = {k: v.begin() for k, v in (per_proposal or {}).items()
                  if isinstance(v, LoopLaunches)}
    before, r0 = launch_counts(), ChunkProgram.replays
    t0 = time.perf_counter()
    out = smp.run_mcmc(state, n, **kw)
    dt = time.perf_counter() - t0
    rose = {k: v - before[k] for k, v in launch_counts().items()}
    n_prop = n * kw.get("thin_by", 1)
    if smp._use_graphs:
        if ChunkProgram.replays == r0:
            raise AssertionError("a graph-path run replayed no graph")
        if ngraphs is not None and smp._program is prog and (
                any(rose.values()) or len(prog.graphs) != ngraphs):
            raise AssertionError(f"a run after recording called kernel "
                                 f"wrappers {rose} or recorded a graph")
    elif per_proposal is not None:
        want = {k: (loop_draws[k].count(n_prop, 1) if k in loop_draws
                    else per_proposal.get(k, 0) * n_prop) for k in rose}
        if rose != want:
            raise AssertionError(f"eager run: launches rose by {rose} for "
                                 f"{n_prop} proposals, expected {want}")
    elif (rose["stretch_propose"] + rose["de_propose"]
          + rose["snooker_propose"] != 2 * n_prop
          or rose["accept_select"] != 2 * n_prop):
        raise AssertionError(f"eager run: launches rose by {rose} for "
                             f"{n_prop} proposals")
    return out, dt


def storage_split(torch, np, dev, k, reps=5):
    """One chunk of ``k`` kept main-path steps on its way from the card
    into the host ``Backend`` by the port's route, timed piece by piece
    on the host clock (each piece ends in a synchronize; the median of
    ``reps``): the rows, converted to float64 on the card (contiguous
    coords and log_prob, bool acceptance), copied to pinned memory, and
    ``Backend.save_chunk``'s write of those rows.  Returns ms per kept
    step of each."""
    from emcee_tpu_torch.backends import Backend

    rows = torch.randn(k, NW, ND + 2, device=dev)
    f64 = (rows[..., :ND].double(), rows[..., ND].double(),
           rows[..., ND + 1] > 0)
    pinned64 = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in f64)
    host64 = tuple(t.numpy() for t in pinned64)
    backend = Backend()
    backend.reset(NW, ND)
    backend.grow(k * (reps + 1), None)

    def copy64():
        for p, t in zip(pinned64, f64):
            p.copy_(t, non_blocking=True)

    def timed(fn):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return float(np.median(out)) / k * 1e3

    copy64()
    torch.cuda.synchronize()
    return {"f64_copy_pinned": timed(copy64),
            "f64_write": timed(lambda: backend.save_chunk(
                *host64[:2], None, host64[2], (0, 0)))}


def stored_rates(torch, np, dev, card, mv, state, plans=((20, 100),
                                                         (1, 400))):
    """The main path stored into the host ``Backend`` at each ``(thin_by,
    kept)`` of ``plans``, each beside the same proposals unstored just
    before (for the cost of storing), graphs recorded first; and the
    split of one chunk's storage (:func:`storage_split`) at the chunk
    size the sampler picks.  Returns ``({thin_by: (stored, unstored)
    walker-steps/s}, {thin_by: split}, state)``."""
    from emcee_tpu_torch import EnsembleSampler

    rates, splits = {}, {}
    for thin_by, kept in plans:
        smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=1,
                              moves=mv)
        # A first stored run of the same size records the graphs and
        # allocates the storage buffers.
        state, _ = drive(smp, state, kept, thin_by=thin_by,
                         skip_initial_state_check=True)
        warm_graphs(smp)
        smp.reset()
        state, dt_free = drive(smp, state, kept * thin_by, store=False,
                               skip_initial_state_check=True)
        state, dt_store = drive(smp, state, kept, thin_by=thin_by,
                                skip_initial_state_check=True)
        chain = smp.get_chain()
        if chain.shape != (kept, NW, ND) or not np.isfinite(chain).all():
            raise AssertionError(f"stored chain {chain.shape}")
        n = kept * thin_by * NW
        rates[thin_by] = (n / dt_store, n / dt_free)
        k = smp._chunk_schedule(kept, smp._auto_chunk(True))[0]
        splits[thin_by] = dict(storage_split(torch, np, dev, k), chunk=k)
        log(f"phase 4: host Backend, thin_by {thin_by}, {kept} kept: "
            f"stored {n / dt_store:.4e} walker-steps/s, the same "
            f"proposals unstored {n / dt_free:.4e} {card}; one chunk of "
            f"{k} kept steps, ms per kept step: "
            + ", ".join(f"{key} {v:.4f}" for key, v in splits[thin_by].items()
                        if key != "chunk")
            + f"; device time per kept step "
            f"{thin_by * NW / (n / dt_free) * 1e3:.4f} ms")
    return rates, splits, state


def workload3_target(np, torch, dev, nw=NW3, nd=ND3):
    """``benchmarks/workload3.py:57-69,118-121``: the 100-D correlated
    Gaussian ``lp = -1/2 |x W|^2`` with ``W = chol(inv(cov))``, and a
    start drawn from the target, from one numpy stream (seed 0)."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(nd, nd)) / np.sqrt(nd)
    cov = a @ a.T + 0.5 * np.eye(nd)
    w = torch.as_tensor(np.linalg.cholesky(np.linalg.inv(cov)),
                        dtype=torch.float32, device=dev)
    p0 = (rng.normal(size=(nw, nd)) @ np.linalg.cholesky(cov).T).astype(
        np.float32)

    def log_prob(x):
        y = x @ w
        return -0.5 * (y * y).sum(-1)

    return log_prob, p0


def workload3_moves(moves):
    """The mixture of ``benchmarks/workload3.py:71-77``."""
    return [(moves.DEMove(pair_mode="roll", randomize_split=False), 0.8),
            (moves.DESnookerMove(pair_mode="roll", nsplits=2,
                                 randomize_split=False), 0.2)]


def same_from_device_offset(torch, fn, args, kw, want):
    """Call kernel wrapper ``fn`` with ``kw``'s int offset held as a
    device word plus an increment (as a CUDA graph's proposals read it)
    and raise unless it returns exactly ``want``.  No-op for injected
    draws (no ``offset`` in ``kw``)."""
    from emcee_tpu_torch.ops.philox import DeviceOffset

    if "offset" not in kw:
        return
    dev = args[0].device
    word = torch.tensor(kw["offset"] - 3, dtype=torch.int64, device=dev)
    got = fn(*args, **{**kw, "offset": DeviceOffset(word, 3)})
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{fn.__name__}: device offset draws differ")


def misaligned(torch, t):
    """A contiguous copy of ``t`` whose base is 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def lp_variants(torch, q):
    """``(label, lp_q)`` of K2's edge cases for a proposal ``q``: its own
    log-prob, one that accepts every walker, none, and one that holds NaN
    and +-inf."""
    special = torch.tensor([float("nan"), float("inf"), -float("inf")],
                           device=q.device)
    mixed = gaussian(q).clone()
    mixed[::3] = special.repeat(-(-q.shape[0] // 9))[:mixed[::3].numel()]
    return (("proposal's lp_q", gaussian(q)),
            ("all accepted", torch.full_like(mixed, float("inf"))),
            ("none accepted", torch.full_like(mixed, -float("inf"))),
            ("NaN and +-inf in lp_q", mixed))


def k2_direct(q, f, lp_q, c, l, split, ns, acc, cnt, seed=0, offset=0,
              log_u=None):
    """K2 with q read from device memory (no staging)."""
    from emcee_tpu_torch.ops import accept_kernel as ak
    from emcee_tpu_torch.ops._wrap import device_sm_count, tile_plan

    plan = tile_plan(q.shape[0], c.shape[1], split,
                     device_sm_count(c.device), c.data_ptr(), q.data_ptr())
    ak._launch(plan, q, f, lp_q, c, l, split, acc, cnt, seed, offset, log_u)


def k2_whole_sweep(torch, dev, nds, ngs=(SWEEP_NG, 4096)):
    """K2 at ``nsplits=1`` (split 0 is the whole ensemble, ``ng =
    nwalkers``, as ``MHMove`` and ``GaussianMove`` launch it) against its
    plain version, bit for bit (``torch.equal``): ndim in ``nds``; ``ng``
    in ``ngs`` (5003, which no tile divides, and 4096); ``coords``, ``q``
    and ``log_prob`` with 16-byte aligned bases and with bases 4 bytes
    past one; ``lp_q`` the proposal's, all / none accepted, NaN and
    +-inf; with and without a count; injected ``log_u``, a host offset
    and a device offset word; as the wrapper launches it (q staged in
    shared memory where it can be) and in the direct variant.  Returns
    the number of comparisons."""
    from emcee_tpu_torch.ops import accept_kernel as ak
    from emcee_tpu_torch.ops.philox import DeviceOffset

    gen = torch.Generator(device=dev).manual_seed(19)
    seed, offset = 97531, (1 << 33) + 9
    word = torch.tensor(offset - 3, dtype=torch.int64, device=dev)
    n_cmp = 0
    for nd in nds:
        for ng in ngs:
            for copy in (torch.clone, lambda t: misaligned(torch, t)):
                coords = copy(torch.randn(ng, nd, device=dev, generator=gen))
                q = copy(coords + 0.5 * torch.randn(ng, nd, device=dev,
                                                    generator=gen))
                f = torch.randn(ng, device=dev, generator=gen) * 0.1
                lp = copy(gaussian(coords))
                draws = (
                    ("injected", dict(log_u=torch.log(torch.rand(
                        ng, device=dev, generator=gen)))),
                    ("host offset", dict(seed=seed, offset=offset)),
                    ("device offset", dict(seed=seed, offset=DeviceOffset(
                        word, 3))))
                for label, lp_q in lp_variants(torch, q):
                    for draw, kw in draws:
                        for counted in (False, True):
                            outs = []
                            for fn in (ak.accept_select, k2_direct,
                                       ak.accept_select_plain):
                                c, l = copy(coords), copy(lp)
                                acc = torch.zeros(ng, dtype=torch.bool,
                                                  device=dev)
                                cnt = (torch.arange(ng, dtype=torch.int32,
                                                    device=dev)
                                       if counted else None)
                                fn(q, f, lp_q, c, l, 0, 1, acc, cnt, **kw)
                                outs.append((c, l, acc) + (
                                    (cnt,) if counted else ()))
                            for got in outs[:-1]:
                                n_cmp += 1
                                if not all(torch.equal(a, b) for a, b in
                                           zip(got, outs[-1])):
                                    raise AssertionError(
                                        f"K2 nsplits=1, ndim {nd}, ng {ng},"
                                        f" {label}, {draw}, count="
                                        f"{counted}: kernel and plain "
                                        "version differ")
    return n_cmp


def edge_sweep(torch, dev, nds, ng=SWEEP_NG):
    """K1 and K2 against their plain versions, bit for bit (``torch.equal``),
    over edge shapes: ndim in ``nds``; ``ng`` walkers per split, which no
    tile divides; nsplits 2, 3 and 4, every split (at odd ndim most
    splits' spans are not 16-byte aligned); both pair modes; injected
    uniforms (K1 tuned), and the in-kernel Philox at a host offset and at
    a device offset word.  K2 runs on each K1 proposal without and with a
    count buffer, and on ``lp_q`` that is the proposal's, that accepts
    every walker, none, or that holds NaN and +-inf; each time both as
    its wrapper launches it (q staged in shared memory) and in its direct
    variant (q read from device memory).  Then both kernels once more on
    a ``coords`` and a ``q`` whose bases are not 16-byte aligned.
    Returns the number of comparisons."""
    from emcee_tpu_torch.ops import accept_kernel as ak
    from emcee_tpu_torch.ops import stretch_kernel as sk
    from emcee_tpu_torch.ops.philox import DeviceOffset

    gen = torch.Generator(device=dev).manual_seed(13)
    seed, offset = 24680, (1 << 33) + 5  # the offset's high word is set
    word = torch.tensor(offset - 3, dtype=torch.int64, device=dev)
    scale = torch.tensor(0.7, device=dev)
    n_cmp = 0

    def same(got, want, what):
        nonlocal n_cmp
        n_cmp += 1
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"edge sweep, {what}: kernel and plain "
                                 "version differ")

    # The wrapper (staged wherever it can), the direct variant, the plain
    # version.
    k2_fns = (ak.accept_select, k2_direct, ak.accept_select_plain)

    def k2(q, f, coords, lp, split, ns, what, copy, **kw):
        nw = coords.shape[0]
        for label, lp_q in lp_variants(torch, q):
            for counted in (False, True):
                outs = []
                for fn in k2_fns:
                    c, l = copy(coords), copy(lp)
                    acc = torch.zeros(nw, dtype=torch.bool, device=dev)
                    cnt = (torch.arange(nw, dtype=torch.int32, device=dev)
                           if counted else None)
                    fn(q, f, lp_q, c, l, split, ns, acc, cnt, **kw)
                    outs.append((c, l, acc) + ((cnt,) if counted else ()))
                for got in outs[:-1]:
                    same(got, outs[-1], f"K2 {what}, {label}, "
                         f"count={counted}")

    def case(coords, split, ns, nd, pair_mode, copy=torch.clone,
             draws=("injected", "host offset", "device offset")):
        lp = gaussian(coords)
        inj = (dict(u_shift=torch.rand((), device=dev, generator=gen))
               if pair_mode == "roll" else
               dict(u_pair=torch.rand(ng, device=dev, generator=gen)))
        for draw in draws:
            if draw == "injected":
                kw = dict(u_z=torch.rand(ng, device=dev, generator=gen),
                          scale=scale, **inj)
                k2kw = dict(log_u=torch.log(
                    torch.rand(ng, device=dev, generator=gen)))
            else:
                off = offset if draw == "host offset" else DeviceOffset(
                    word, 3)
                kw = k2kw = dict(seed=seed, offset=off)
            what = (f"ndim {nd}, nsplits {ns}, split {split}, {pair_mode}, "
                    f"{draw}")
            args = (coords, split, ns)
            k1kw = dict(a=2.0, ndim_global=nd, pair_mode=pair_mode, **kw)
            q, f = sk.stretch_propose(*args, **k1kw)
            same((q, f), sk.stretch_propose_plain(*args, **k1kw), f"K1 {what}")
            k2(copy(q), f, coords, lp, split, ns, what, copy, **k2kw)

    for nd in nds:
        for ns in (2, 3, 4):
            coords = torch.randn(ng * ns, nd, device=dev, generator=gen)
            for split in range(ns):
                for pair_mode in ("roll", "random"):
                    case(coords, split, ns, nd, pair_mode)
        coords = misaligned(torch, torch.randn(ng * 3, nd, device=dev,
                                               generator=gen))
        for pair_mode in ("roll", "random"):
            case(coords, 1, 3, nd, pair_mode, lambda t: misaligned(torch, t),
                 draws=("host offset",))
    return n_cmp


def graph_vs_plain_chain(torch, make, p0, n=64):
    """``n`` graph-replayed proposals of the sampler ``make()`` builds
    against the same ``n`` run eagerly on the plain versions, from one
    state and seed: coords, log_prob, acceptance counts and random_state
    must be identical.  Returns the acceptance fraction."""
    ends = []
    for plain in (False, True):
        smp = make()
        smp._use_graphs = not plain
        with plain_kernels() if plain else contextlib.nullcontext():
            st = smp.run_mcmc(p0, n, store=False,
                              skip_initial_state_check=True)
        ends.append((st, smp.last_run_stats.accepted))
    (a, acc_a), (b, acc_b) = ends
    if not (torch.equal(a.coords, b.coords)
            and torch.equal(a.log_prob, b.log_prob)
            and torch.equal(acc_a, acc_b)
            and a.random_state == b.random_state):
        raise AssertionError(f"{n} graph-replayed proposals differ from "
                             "the plain versions' eager chain")
    return float(acc_a.float().mean()) / n


def k5_edge_sweep(torch, dev, nds=K5_SWEEP_NDS, ng=SWEEP_NG):
    """K5a and K5b against their plain versions, bit for bit
    (``torch.equal``), over edge shapes: ndim in ``nds``; ``ng`` walkers
    per split, which no tile divides; K5a with nsplits 2, 3 and 4, K5b
    with nsplits 4 and, in roll mode, 2, every split; both pair modes;
    injected draws (the roll uniforms of the last split at the top of
    their range), and the in-kernel Philox at a host offset and at a
    device offset word; ``scale`` unset and set.  Each case runs the
    wrapper's launch and, through ``_launch``, a ``q`` whose base is not
    16-byte aligned, K5a's other variant (its own rows bulk-copied to
    shared memory) and K5b with fewer warps than walkers (each warp takes
    walkers in turn).  Then both kernels once more on a ``coords`` whose
    base is not 16-byte aligned.  Returns the number of comparisons."""
    from emcee_tpu_torch.ops import de_kernel as dk
    from emcee_tpu_torch.ops import snooker_kernel as snk
    from emcee_tpu_torch.ops._wrap import de_plan, device_sm_count
    from emcee_tpu_torch.ops.philox import DeviceOffset

    gen = torch.Generator(device=dev).manual_seed(17)
    seed, offset = 13579, (1 << 33) + 7  # the offset's high word is set
    word = torch.tensor(offset - 3, dtype=torch.int64, device=dev)
    scale = torch.tensor(0.7, device=dev)
    top = 1.0 - 2.0**-24
    n_sm = device_sm_count(dev)
    n_cmp = 0

    def launches(mod, kind, coords, split, ns, kw):
        """``(label, (q, factor))`` of every launch path of one case."""
        nd = coords.shape[1]
        snooker = kind == "snooker"
        out = [("wrapper", getattr(mod, f"{kind}_propose")(
            coords, split, ns, **kw))]
        q_odd = misaligned(torch, torch.empty(ng, nd, device=dev))
        plans = [("q base not aligned", q_odd, de_plan(
            ng, nd, split, n_sm, coords.data_ptr(), q_odd.data_ptr(),
            snooker=snooker))]
        q = torch.empty(ng, nd, device=dev)
        plan = de_plan(ng, nd, split, n_sm, coords.data_ptr(), q.data_ptr(),
                       snooker=snooker, stage=not snooker)
        if snooker:
            plans.append(("2 warps, walkers in turn", q,
                          plan._replace(threads=64)))
        elif plan.stage:
            plans.append(("own rows staged", q, plan))
        for label, qb, p in plans:
            f = torch.empty(ng, device=dev)
            mod._launch(p, coords, qb, f, split, ns, **kw)
            out.append((label, (qb, f)))
        return out

    def case(mod, kind, coords, split, ns, pair_mode, inj, base,
             draws=("injected", "host offset", "device offset")):
        nonlocal n_cmp
        for draw in draws:
            for sc in (None, scale):
                kw = dict(base, pair_mode=pair_mode, scale=sc, seed=0,
                          offset=0)
                if draw == "injected":
                    kw.update(inj)
                else:
                    kw.update(seed=seed, offset=offset if draw ==
                              "host offset" else DeviceOffset(word, 3))
                want = getattr(mod, f"{kind}_propose_plain")(
                    coords, split, ns, **kw)
                for label, got in launches(mod, kind, coords, split, ns,
                                           kw):
                    n_cmp += 1
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError(
                            f"K5 edge sweep, {kind}, ndim "
                            f"{coords.shape[1]}, nsplits {ns}, split "
                            f"{split}, {pair_mode}, {draw}, scale "
                            f"{sc is not None}, {label}: kernel and plain "
                            "version differ")

    def de_inj(ns, split, pair_mode):
        nc = (ns - 1) * ng
        z = dict(z=torch.randn(ng, device=dev, generator=gen))
        if pair_mode == "roll":
            u = (torch.full((2,), top, device=dev) if split == ns - 1
                 else torch.rand(2, device=dev, generator=gen))
            return dict(z, u_shift=u, idx_a=None, idx_b=None)
        ri = dict(device=dev, generator=gen, dtype=torch.int32)
        return dict(z, u_shift=None,
                    idx_a=torch.randint(0, nc, (ng,), **ri),
                    idx_b=torch.randint(0, nc - 1, (ng,), **ri))

    def sn_inj(ns, split, pair_mode):
        if pair_mode == "roll":
            u = torch.rand(4, device=dev, generator=gen)
            if split == ns - 1:
                u[1:] = top
            return dict(u4=u, idx=None, perm=None)
        ri = dict(device=dev, generator=gen, dtype=torch.int32)
        return dict(u4=None, idx=torch.randint(0, ng, (3, ng), **ri),
                    perm=torch.randint(0, 6, (ng,), **ri))

    for nd in nds:
        de_base = dict(gamma0=dk.de_gamma0(None, nd), sigma=0.1, z=None,
                       u_shift=None, idx_a=None, idx_b=None)
        sn_base = dict(gammas=1.7, ndim_global=nd, u4=None, idx=None,
                       perm=None)
        for ns in (2, 3, 4):
            coords = torch.randn(ng * ns, nd, device=dev, generator=gen)
            for split in range(ns):
                for pair_mode in ("roll", "random"):
                    case(dk, "de", coords, split, ns, pair_mode,
                         de_inj(ns, split, pair_mode), de_base)
                    if ns == 4 or (ns == 2 and pair_mode == "roll"):
                        case(snk, "snooker", coords, split, ns, pair_mode,
                             sn_inj(ns, split, pair_mode), sn_base)
        for ns in (2, 4):
            coords = misaligned(torch, torch.randn(ng * ns, nd, device=dev,
                                                   generator=gen))
            for pair_mode in ("roll", "random"):
                case(dk, "de", coords, 1, ns, pair_mode, {}, de_base,
                     draws=("host offset",))
                if ns == 4 or pair_mode == "roll":
                    case(snk, "snooker", coords, 1, ns, pair_mode, {},
                         sn_base, draws=("host offset",))
    return n_cmp


def tile_sweep(torch, coords, q, f, lp_q, work, nsplits, seed, offset,
               reps=100):
    """K1's and K2's device us per launch for split 0 at every tile of
    ``SWEEP_TILES``: K1 in roll mode on ``coords``; K2 on the proposal
    ``(q, f, lp_q)`` with each tile's q span bulk-copied to shared memory
    ("K2 staged", where it fits) and read from device memory ("K2
    direct"), each launch on a fresh copy of ``work`` (coords, log_prob,
    accepted, count).  Eager launches, profiled; the tiles are swept up,
    then down, and the two passes averaged.  Returns ``{tile: {name:
    us}}`` and the plan's tile."""
    from emcee_tpu_torch.ops import accept_kernel as ak
    from emcee_tpu_torch.ops import stretch_kernel as sk
    from emcee_tpu_torch.ops._wrap import (
        SMEM_LIMIT, STATIC_SMEM, device_sm_count, tile_plan)

    ng, nd = q.shape
    plan = tile_plan(ng, nd, 0, device_sm_count(coords.device),
                     coords.data_ptr(), q.data_ptr(), stage=True)
    qk, fk = torch.empty_like(q), torch.empty_like(f)
    k1kw = dict(a=2.0, scale=None, ndim_global=nd, pair_mode="roll",
                seed=seed, offset=offset, u_z=None, u_pair=None,
                u_shift=None)
    bufs = [w.clone() for w in work]

    def k2(p):
        for b, w in zip(bufs, work):
            b.copy_(w)
        ak._launch(p, q, f, lp_q, bufs[0], bufs[1], 0, bufs[2], bufs[3],
                   seed, offset, None)

    got = {}
    for tile in SWEEP_TILES + SWEEP_TILES[::-1]:
        grid = -(-ng // tile)
        p = plan._replace(tile=tile, grid=grid, stage=0, smem=0)
        runs = {"K1": ("stretch_propose", lambda: sk._launch(
                    p, coords, qk, fk, 0, nsplits, **k1kw)),
                "K2 direct": ("accept_select", lambda: k2(p))}
        if 4 * tile * nd <= SMEM_LIMIT - STATIC_SMEM:
            ps = p._replace(stage=1, smem=4 * tile * nd)
            runs["K2 staged"] = ("accept_select", lambda: k2(ps))
        for name, (kname, fn) in runs.items():
            got.setdefault(tile, {}).setdefault(name, []).append(
                profiled_ms(torch, lambda: [fn() for _ in range(reps)],
                            kname) * 1e3)
    return ({t: {k: sum(v) / len(v) for k, v in d.items()}
             for t, d in got.items()}, plan.tile)


def identical(got, want, what):
    """Raise unless every tensor of ``got`` equals its ``want`` exactly
    (``torch.equal``); returns the max abs error, 0.0."""
    if not all(a.equal(b) for a, b in zip(got, want)):
        raise AssertionError(f"{what}: kernel and plain version differ")
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def k5_tile_sweep(torch, coords, seed, offset, reps=100):
    """K5a's and K5b's device us per launch for split 0 of ``coords``
    (nsplits 2, roll mode, the in-kernel Philox) at every tile of
    ``K5_SWEEP_TILES``: K5a direct (its own rows read from device memory)
    and staged (bulk-copied to shared memory, where they fit), K5b with
    one warp per walker.  Eager launches, profiled; the tiles are swept
    up, then down, and the two passes averaged.  Returns ``{tile: {name:
    us}}`` and the plans' tiles ``{kernel: tile}``."""
    from emcee_tpu_torch.ops import de_kernel as dk
    from emcee_tpu_torch.ops import snooker_kernel as snk
    from emcee_tpu_torch.ops._wrap import (
        DE_THREADS, SMEM_LIMIT, STATIC_SMEM, de_plan, device_sm_count)

    nw, nd = coords.shape
    ng = nw // 2
    dev = coords.device
    n_sm = device_sm_count(dev)
    q, f = torch.empty(ng, nd, device=dev), torch.empty(ng, device=dev)
    de_kw = dict(gamma0=dk.de_gamma0(None, nd), sigma=1e-5, scale=None,
                 pair_mode="roll", seed=seed, offset=offset, z=None,
                 u_shift=None, idx_a=None, idx_b=None)
    sn_kw = dict(gammas=1.7, scale=None, ndim_global=nd, pair_mode="roll",
                 seed=seed, offset=offset, u4=None, idx=None, perm=None)
    plans = {"de_propose": de_plan(ng, nd, 0, n_sm, coords.data_ptr(),
                                   q.data_ptr(), stage=True),
             "snooker_propose": de_plan(ng, nd, 0, n_sm, coords.data_ptr(),
                                        q.data_ptr(), snooker=True)}

    def runs(tile):
        out = {}
        grid = -(-ng // tile)
        if tile in K5_SWEEP_TILES["de_propose"]:
            pd = plans["de_propose"]._replace(
                tile=tile, grid=grid, stage=0, smem=0,
                threads=max(DE_THREADS, 32 * -(-tile // 32) + 32))
            out["K5a direct"] = ("de_propose", lambda: dk._launch(
                pd, coords, q, f, 0, 2, **de_kw))
            if (plans["de_propose"].stage
                    and 4 * tile * nd <= SMEM_LIMIT - STATIC_SMEM):
                ps = pd._replace(stage=1, smem=4 * tile * nd)
                out["K5a staged"] = ("de_propose", lambda: dk._launch(
                    ps, coords, q, f, 0, 2, **de_kw))
        if tile in K5_SWEEP_TILES["snooker_propose"]:
            pb = plans["snooker_propose"]._replace(tile=tile, grid=grid,
                                                   threads=32 * tile)
            out["K5b"] = ("snooker_propose", lambda: snk._launch(
                pb, coords, q, f, 0, 2, **sn_kw))
        return out

    tiles = sorted(set().union(*K5_SWEEP_TILES.values()))
    got = {}
    for tile in tiles + tiles[::-1]:
        for name, (kname, fn) in runs(tile).items():
            got.setdefault(tile, {}).setdefault(name, []).append(
                profiled_ms(torch, lambda: [fn() for _ in range(reps)],
                            kname) * 1e3)
    return ({t: {k: sum(v) / len(v) for k, v in d.items()}
             for t, d in got.items()},
            {k: p.tile for k, p in plans.items()})


def phase7(torch, np, dev, errs, nw=NW3, nd=ND3):
    """K5a, K5b and K2 at workload 3's shapes against their plain
    versions, bit for bit; the K1/K2 and K5a/K5b edge-shape sweeps at
    large ndim; one whole proposal of each move; and 64 graph-replayed
    workload-3 proposals against the plain versions' eager chain."""
    from emcee_tpu_torch import EnsembleSampler, State, moves
    from emcee_tpu_torch.model import Model, wrap_log_prob_fn
    from emcee_tpu_torch.ops import accept_kernel as ak
    from emcee_tpu_torch.ops import de_kernel as dk
    from emcee_tpu_torch.ops import snooker_kernel as snk

    gen = torch.Generator(device=dev).manual_seed(11)
    ng = nw // 2
    seed, offset = 987654321, 77
    coords = torch.randn(nw, nd, device=dev, generator=gen)
    g0 = dk.de_gamma0(None, nd)
    scale = torch.tensor(0.8, device=dev)
    for pair_mode in ("roll", "random"):
        for split in range(2):
            z = torch.randn(ng, device=dev, generator=gen)
            if pair_mode == "roll":
                inj = dict(u_shift=torch.rand(2, device=dev, generator=gen))
            else:
                inj = dict(
                    idx_a=torch.randint(0, nw - ng, (ng,), device=dev,
                                        generator=gen, dtype=torch.int32),
                    idx_b=torch.randint(0, nw - ng - 1, (ng,), device=dev,
                                        generator=gen, dtype=torch.int32))
            for kw in (dict(z=z, sigma=1e-5, **inj),
                       dict(z=z, sigma=0.5, scale=scale, **inj),
                       dict(sigma=1e-5, seed=seed, offset=offset),
                       dict(sigma=0.5, seed=seed, offset=offset + 1)):
                args = (coords, split, 2)
                kw = dict(gamma0=g0, pair_mode=pair_mode, **kw)
                q, f = dk.de_propose(*args, **kw)
                same_from_device_offset(torch, dk.de_propose, args, kw,
                                        (q, f))
                errs["de_propose"] = max(errs["de_propose"], identical(
                    (q, f), dk.de_propose_plain(*args, **kw),
                    f"K5a {pair_mode} split {split}"))
        log(f"phase 7: K5a {pair_mode}: identical to the plain version "
            f"(torch.equal); device-offset draws identical")

    for pair_mode, nsplits in (("roll", 2), ("roll", 4), ("random", 4)):
        ngs = ng  # 5000 walkers per split: 2e4 walkers with nsplits=4
        c = coords if nsplits == 2 else torch.randn(
            ngs * nsplits, nd, device=dev, generator=gen)
        for split in range(nsplits):
            if pair_mode == "roll":
                inj = dict(u4=torch.rand(4, device=dev, generator=gen))
            else:
                inj = dict(
                    idx=torch.randint(0, ngs, (3, ngs), device=dev,
                                      generator=gen, dtype=torch.int32),
                    perm=torch.randint(0, 6, (ngs,), device=dev,
                                       generator=gen, dtype=torch.int32))
            for kw in (dict(**inj), dict(scale=scale, **inj),
                       dict(seed=seed, offset=offset)):
                args = (c, split, nsplits)
                kw = dict(gammas=1.7, ndim_global=nd, pair_mode=pair_mode,
                          **kw)
                q, f = snk.snooker_propose(*args, **kw)
                same_from_device_offset(torch, snk.snooker_propose, args, kw,
                                        (q, f))
                errs["snooker_propose"] = max(
                    errs["snooker_propose"], identical(
                        (q, f), snk.snooker_propose_plain(*args, **kw),
                        f"K5b {pair_mode} nsplits {nsplits} split {split}"))
        log(f"phase 7: K5b {pair_mode} nsplits={nsplits}: identical to the "
            f"plain version (torch.equal); device-offset draws identical")

    # K2 at ndim = 100, on a snooker proposal.
    q, f = snk.snooker_propose(coords, 0, 2, gammas=1.7, ndim_global=nd,
                               pair_mode="roll", seed=seed, offset=offset)
    lp = gaussian(coords)
    lp_q = gaussian(q)
    log_u = torch.log(torch.rand(ng, device=dev, generator=gen))
    for k2kw in (dict(log_u=log_u), dict(seed=seed, offset=offset)):
        outs = []
        for fn in (ak.accept_select, ak.accept_select_plain):
            cc, ll = coords.clone(), lp.clone()
            acc = torch.zeros(nw, dtype=torch.bool, device=dev)
            cnt = torch.ones(nw, dtype=torch.int32, device=dev)
            fn(q, f, lp_q, cc, ll, 0, 2, acc, cnt, **k2kw)
            outs.append((cc, ll, acc, cnt))
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError("K2 at ndim 100: kernel and plain disagree")
        if "offset" in k2kw:
            cc, ll = coords.clone(), lp.clone()
            acc = torch.zeros(nw, dtype=torch.bool, device=dev)
            cnt = torch.ones(nw, dtype=torch.int32, device=dev)
            same_from_device_offset(
                torch, lambda *a, **kw: (ak.accept_select(*a, **kw), cc, ll,
                                         acc, cnt),
                (q, f, lp_q, cc, ll, 0, 2, acc, cnt), k2kw,
                (outs[0][2][:ng],) + outs[0])
    log(f"phase 7: K2 at ndim {nd}: identical "
        f"({int(outs[0][2][:ng].sum())} of {ng} accepted)")
    t0 = time.perf_counter()
    n_cmp = k2_whole_sweep(torch, dev, (100, 129))
    log(f"phase 7: K2 at nsplits=1 (ng = nwalkers 5003 and 4096, ndim 100, "
        f"129): {n_cmp} comparisons with its plain version, all identical "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n_cmp = edge_sweep(torch, dev, (100, 129))
    log(f"phase 7: edge-shape sweep, ndim 100, 129, ng {SWEEP_NG}, nsplits "
        f"2-4: {n_cmp} comparisons of K1/K2 with their plain versions, all "
        f"identical ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    n_cmp = k5_edge_sweep(torch, dev)
    log(f"phase 7: K5 edge-shape sweep, ndim "
        f"{', '.join(map(str, K5_SWEEP_NDS))}, ng {SWEEP_NG}: {n_cmp} "
        f"comparisons of K5a/K5b with their plain versions, all identical "
        f"({time.perf_counter() - t0:.1f} s)")

    # One whole proposal of each move, kernel path against plain path.
    model = Model(wrap_log_prob_fn(gaussian, vectorize=True), nw, nd)
    lp = gaussian(coords)
    for mv in (moves.DEMove(pair_mode="roll", randomize_split=False),
               moves.DEMove(sigma=0.3),
               moves.DESnookerMove(pair_mode="roll", nsplits=2,
                                   randomize_split=False),
               moves.DESnookerMove()):
        st_k, acc_k, _ = mv.propose((5, 9), State(coords.clone(), lp.clone()),
                                    model, ())
        with plain_kernels():
            st_p, acc_p, _ = mv.propose(
                (5, 9), State(coords.clone(), lp.clone()), model, ())
        name = (f"{type(mv).__name__}({mv.pair_mode}, nsplits={mv.nsplits}, "
                f"randomize_split={mv.randomize_split})")
        if not (torch.equal(acc_k, acc_p) and torch.equal(
                st_k.coords, st_p.coords) and torch.equal(st_k.log_prob,
                                                          st_p.log_prob)):
            raise AssertionError(f"whole proposal {name}: kernel path and "
                                 "plain path differ")
        log(f"phase 7: whole proposal {name}: identical to the plain path "
            f"(acceptance {float(acc_k.float().mean()):.3f})")

    # 64 graph-replayed proposals of workload 3 against the plain chain.
    log_prob3, p03 = workload3_target(np, torch, dev)
    acc64 = graph_vs_plain_chain(torch, lambda: EnsembleSampler(
        NW3, ND3, log_prob3, vectorize=True, seed=9, device=dev,
        moves=workload3_moves(moves)), p03)
    log(f"phase 7: 64 graph-replayed workload-3 proposals equal the same "
        f"64 run eagerly on the plain versions, bit for bit (acceptance "
        f"{acc64:.4f})")


def move_seq(smp, state, n, thin_by=1, store=True):
    """The move index of every proposal the next ``run_mcmc(state, n)``
    of ``smp`` runs, from the host-known sequence of each chunk."""
    from emcee_tpu_torch.driver import move_sequence

    rs = getattr(state, "random_state", None) or smp.random_state
    seq = []
    for k in smp._chunk_schedule(n, smp._auto_chunk(store)):
        seq += move_sequence(smp._weights, rs[0], rs[1] + len(seq), k,
                             thin_by, smp._mixture_block).tolist()
    return seq


def phase8(torch, np, dev, card, nw=NW3, nd=ND3, n_timed=2000):
    """Workload 3 through the port's entry points, every proposal a graph
    replay.  Returns a dict of its numbers and the wrapper launch counts
    of its runs (K3's recordings and their warm-ups)."""
    from emcee_tpu_torch import EnsembleSampler, moves
    from emcee_tpu_torch.autocorr import integrated_time
    from emcee_tpu_torch.backends import DeviceBackend

    log_prob, p0 = workload3_target(np, torch, dev, nw, nd)
    mix = workload3_moves(moves)
    out = {}
    for _, fn in wrappers().values():
        fn.launches = 0

    def run3(smp, state, n, **kw):
        seq = move_seq(smp, state, n, kw.get("thin_by", 1),
                       kw.get("store", True))
        st, dt = drive(smp, state, n, **kw)
        return st, dt, seq.count(0) / len(seq)

    def check(st, label, dt, n_prop, share):
        mean_lp = float(st.log_prob.mean())
        if not -0.8 * nd < mean_lp < -0.2 * nd:  # workload3.py:201
            raise AssertionError(f"{label}: mean log-prob {mean_lp}")
        ws = n_prop * nw / dt
        log(f"phase 8: {label}: {n_prop} proposals x {nw} walkers in "
            f"{dt:.3f} s: {ws:.4e} walker-steps/s {card}; mean lp "
            f"{mean_lp:.3f}; DE / snooker share of proposals {share:.4f} / "
            f"{1 - share:.4f}")
        return ws

    smp = EnsembleSampler(nw, nd, log_prob, vectorize=True, seed=0,
                          moves=mix, device=dev)
    st, _, _ = run3(smp, p0, 200, store=False, skip_initial_state_check=True)
    warm_graphs(smp)
    st, dt, share = run3(smp, None, n_timed, store=False)
    out["acceptance"] = float(smp.last_run_stats.acceptance_fraction.mean())
    out["ws"] = check(st, "store=False", dt, n_timed, share)
    log(f"phase 8: store=False acceptance {out['acceptance']:.4f}")

    # mixture_block=4 against 1 in turns (1, 4, 4, 1): host time spreads
    # between and within calls, so the two compare only side by side.
    smp_b = EnsembleSampler(nw, nd, log_prob, vectorize=True, seed=3,
                            moves=mix, mixture_block=4, device=dev)
    st_b, _, _ = run3(smp_b, st, 40, store=False,
                      skip_initial_state_check=True)
    warm_graphs(smp_b)
    st_b, dt, share = run3(smp_b, None, n_timed, store=False)
    ws_b = [check(st_b, "mixture_block=4", dt, n_timed, share)]
    st_b, dt, share = run3(smp_b, None, n_timed, store=False)
    ws_b.append(check(st_b, "mixture_block=4, again", dt, n_timed, share))
    st, dt, share = run3(smp, None, n_timed, store=False)
    ws_1 = [out["ws"], check(st, "store=False, again", dt, n_timed, share)]
    out["ws_pairs"] = (ws_1, ws_b)
    log(f"phase 8: mixture_block=4 / 1, in turns: "
        f"{(ws_b[0] + ws_b[1]) / (ws_1[0] + ws_1[1]):.4f}")

    kept, thin_by = 256, 16  # workload3.py:53-54
    smp_d = EnsembleSampler(nw, nd, log_prob, vectorize=True, seed=4,
                            moves=mix, backend=DeviceBackend(),
                            device=dev)
    st, _, _ = run3(smp_d, st, 2, thin_by=thin_by,
                    skip_initial_state_check=True)
    warm_graphs(smp_d)
    smp_d.reset()
    st, dt, share = run3(smp_d, st, kept, thin_by=thin_by,
                         skip_initial_state_check=True)
    chain = smp_d.backend.chain
    if tuple(chain.shape[1:]) != (nw, nd) or smp_d.iteration != kept:
        raise AssertionError(f"DeviceBackend chain {tuple(chain.shape)}")
    # tau from a walker/dim subset, sliced on the device (workload3.py:146).
    sub = chain[:kept, :512, :16].cpu().numpy()
    if not np.isfinite(sub).all():
        raise AssertionError("DeviceBackend chain is not finite")
    tau = float(np.max(integrated_time(sub, quiet=True))) * thin_by
    span = kept * thin_by
    out["ws_stored"] = check(st, "DeviceBackend stored", dt, span, share)
    out["tau"] = tau
    out["ess"] = out["ws_stored"] / tau
    log(f"phase 8: DeviceBackend {kept} kept x thin_by {thin_by}: tau "
        f"{tau:.2f} proposals (max over a [:, :512, :16] subset), ESS/s "
        f"{out['ess']:.4e} {card}; span {span} >= 30 tau: "
        f"{span >= 30 * tau}")
    out["chain"] = chain[:kept, :1000, :16].clone()
    del chain, smp_d

    # A profiled window: the profiler's launches must be exactly those of
    # the host-known move sequence, inside the replayed graphs.
    n_prof = 1000

    def expect():
        n_de = move_seq(smp, None, n_prof, store=False).count(0)
        return {"stretch_propose": 0, "accept_select": 2 * n_prof,
                "de_propose": 2 * n_de,
                "snooker_propose": 2 * (n_prof - n_de)}

    wall, kernels, counts, n_replays = counted_window(
        torch, lambda: drive(smp, None, n_prof, store=False), expect,
        "workload 3")
    busy = sum(us for _, us in kernels.values()) * 1e-6
    out["idle"] = 1 - busy / wall
    out["busy_us_per_prop"] = busy / n_prof * 1e6
    out["host_us_per_replay"] = wall / n_replays * 1e6
    out["dev_ms"] = {k: device_ms(kernels, k)
                     for k in ("de_propose", "snooker_propose",
                               "accept_select")}
    log(f"phase 8: profiled {n_prof} proposals ({n_replays} replays): wall "
        f"{wall:.4f} s, device busy {busy:.4f} s, idle share "
        f"{out['idle']:.4f}, device {out['busy_us_per_prop']:.2f} us per "
        f"proposal {card}; profiled launches {counts} (exactly the move "
        f"sequence's)")
    for key, (cnt, us) in sorted(kernels.items(),
                                 key=lambda kv: -kv[1][1])[:10]:
        log(f"  {us / cnt:9.2f} us x {cnt:6d}  {key[:90]}")
    out["launches"] = launch_counts()
    out["state"] = st
    return out


def phase9(torch, np, dev, card, bytes_per_prop, busy_us_per_prop):
    """K3: graph-replayed chains against the eager per-proposal chain,
    rates in turns, K3's own times, and the refusal of a log-prob that
    synchronizes with the host.  Returns K3's row of the kernel table."""
    from emcee_tpu_torch import EnsembleSampler, moves
    from emcee_tpu_torch.backends import DeviceBackend
    from emcee_tpu_torch.chunk_graph import MAX_GRAPH

    log_prob3, p03 = workload3_target(np, torch, dev)
    p0 = np.random.default_rng(1).normal(size=(NW, ND)).astype(np.float32)

    def roll(**kw):
        return moves.StretchMove(randomize_split=False, pair_mode="roll",
                                 **kw)

    def main_path(mv, backend=None):
        return lambda: EnsembleSampler(
            NW, ND, gaussian, vectorize=True, seed=5, moves=mv, device=dev,
            backend=None if backend is None else backend())

    def workload3(blk):
        return lambda: EnsembleSampler(
            NW3, ND3, log_prob3, vectorize=True, seed=6, mixture_block=blk,
            moves=workload3_moves(moves), device=dev)

    # -- the graph chain equals the eager chain ---------------------------
    err = 0.0
    for label, make, start, n, kw in (
            ("main path, store=False", main_path(roll()), p0, 128,
             dict(store=False)),
            ("StretchMove(), store=False", main_path(moves.StretchMove()),
             p0, 100, dict(store=False)),
            ("main path, host Backend", main_path(roll()), p0, 10,
             dict(thin_by=10)),
            ("main path, DeviceBackend", main_path(roll(), DeviceBackend),
             p0, 10, dict(thin_by=10)),
            ("tune=True, tune_target=0.3", main_path(roll(tune_target=0.3)),
             p0, 100, dict(store=False, tune=True)),
            ("workload 3, mixture_block=1", workload3(1), p03, 100,
             dict(store=False)),
            ("workload 3, mixture_block=4", workload3(4), p03, 100,
             dict(store=False))):
        ends = []
        for graphs in (False, True):
            smp = make()
            smp._use_graphs = graphs
            end, _ = drive(smp, start, n, skip_initial_state_check=True, **kw)
            ends.append((smp, end))
        (e, a), (g, b) = ends
        same_acc = torch.equal(e.last_run_stats.accepted,
                               g.last_run_stats.accepted)
        if a.random_state != b.random_state or not same_acc:
            raise AssertionError(f"K3 {label}: random_state "
                                 f"{a.random_state} / {b.random_state}, "
                                 f"acceptance counts equal: {same_acc}")
        if kw.get("store", True):
            for name in ("chain", "log_prob"):
                if not np.array_equal(e.get_value(name), g.get_value(name)):
                    raise AssertionError(f"K3 {label}: stored {name} differs")
            if not np.array_equal(e.backend.accepted, g.backend.accepted):
                raise AssertionError(f"K3 {label}: stored acceptance differs")
        for ce, cg in zip(e._move_carries, g._move_carries):
            if isinstance(ce, dict) and not all(
                    torch.equal(ce[k], cg[k]) for k in ce):
                raise AssertionError(f"K3 {label}: tuning carries differ")
        diff = max(float((a.coords - b.coords).abs().max()),
                   float((a.log_prob - b.log_prob).abs().max()))
        if diff and not label.startswith("workload 3"):
            raise AssertionError(f"K3 {label}: chains differ by {diff}")
        err = max(err, diff)
        note = ("bit for bit" if not diff else
                f"coords/log_prob max abs diff {diff:.3g} (the cuBLAS "
                "matmul under capture), acceptance counts identical")
        log(f"phase 9: K3 {label}: {n * kw.get('thin_by', 1)} proposals, "
            f"graph chain equals eager chain {note}; random_state "
            f"{b.random_state}")

    # -- eager and graph rates in turns (eager, graph, graph, eager) ------
    k3 = {}
    for label, make, start, kw, n_e, n_g in (
            ("main path, store=False", main_path(roll()), p0,
             dict(store=False), 500, 4000),
            ("main path, host Backend", main_path(roll()), p0,
             dict(thin_by=20), 50, 100),
            ("main path, DeviceBackend", main_path(roll(), DeviceBackend),
             p0, dict(thin_by=20), 50, 100),
            ("workload 3, store=False, mixture_block=1", workload3(1), p03,
             dict(store=False), 300, 2000),
            ("workload 3, store=False, mixture_block=4", workload3(4), p03,
             dict(store=False), 300, 2000)):
        smps = {}
        for graphs in (False, True):
            smp = smps[graphs] = make()
            smp._use_graphs = graphs
            drive(smp, start, 4, skip_initial_state_check=True, **kw)
        warm_graphs(smps[True])
        rates = {False: [], True: []}
        for graphs in (False, True, True, False):
            smp = smps[graphs]
            n = n_g if graphs else n_e
            if kw.get("store", True):
                smp.reset()
            _, dt = drive(smp, None, n, **kw)
            rates[graphs].append(n * kw.get("thin_by", 1) * smp.nwalkers
                                 / dt)
        ratio = sum(rates[True]) / sum(rates[False])
        log(f"phase 9: {label}: walker-steps/s in turns eager "
            f"{rates[False][0]:.4e}, graph {rates[True][0]:.4e}, graph "
            f"{rates[True][1]:.4e}, eager {rates[False][1]:.4e}; graph / "
            f"eager {ratio:.4f} {card}")
        k3[label] = (rates, smps[True])

    # -- K3's own times, on the main path's graphs -------------------------
    prog = k3["main path, store=False"][1]._program
    g_big, g_one = prog.graph(0, MAX_GRAPH, False), prog.graph(0, 1, False)
    ms_big = cuda_ms(torch, g_big.replay, reps=30)
    ms_one = cuda_ms(torch, g_one.replay, reps=200)
    eager_ms = cuda_ms(torch, lambda: prog.program(prog.ws, 0, MAX_GRAPH,
                                                   False), reps=3)

    def host_us(graph, reps=100):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            graph.replay()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / reps * 1e6

    prog3 = k3["workload 3, store=False, mixture_block=1"][1]._program
    host = {"main 1": host_us(g_one), f"main {MAX_GRAPH}": host_us(g_big),
            "workload 3 1": host_us(prog3.graph(0, 1, False))}
    log(f"phase 9: K3 replay of {MAX_GRAPH} main-path proposals "
        f"{ms_big * 1e3:.2f} us ({ms_big / MAX_GRAPH * 1e3:.2f} us per "
        f"proposal), of 1 proposal {ms_one * 1e3:.2f} us; the same "
        f"{MAX_GRAPH} proposals eagerly {eager_ms * 1e3:.2f} us {card}")
    log(f"phase 9: K3 host time per replay (enqueue, back to back): "
        + ", ".join(f"{k} proposals {v:.2f} us" for k, v in host.items()))

    # -- a log-prob that synchronizes with the host is refused ------------
    def syncing(x):
        lp = -0.5 * (x**2).sum(-1)
        if bool(torch.isnan(lp).any()):  # a host sync
            raise ValueError("NaN")
        return lp

    n_ref = min(1024, NW)
    smp = EnsembleSampler(n_ref, ND, syncing, vectorize=True, seed=0,
                          moves=roll(), device=dev)
    try:
        smp.run_mcmc(p0[:n_ref], 2, store=False)
    except RuntimeError as exc:
        msg = str(exc)
        if "CUDA graph" not in msg or "synchronize" not in msg:
            raise AssertionError(f"refusal without its cause: {msg}")
    else:
        raise AssertionError("a log-prob that synchronizes was not refused")
    torch.cuda.synchronize()
    if torch.cuda.current_stream() != torch.cuda.default_stream():
        raise AssertionError("a failed recording left its stream current")
    log(f"phase 9: a log-prob that synchronizes is refused: "
        f"{msg.splitlines()[0][:300]}")

    bound_ms = MAX_GRAPH * bytes_per_prop / HBM_BYTES_PER_S * 1e3
    return {
        "name": "chunk_graph", "route": "cuda",
        "source": "emcee_tpu_torch/chunk_graph.py",
        "replaces": "emcee_tpu/sampler.py:783", "launches": None,
        "max_abs_err": err, "ms": ms_big, "plain_ms": eager_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
        "proposals_per_replay": MAX_GRAPH, "ms_one_proposal": ms_one,
        "kernels_device_ms": MAX_GRAPH * busy_us_per_prop * 1e-3,
        "host_us_per_replay": host,
        "rates_in_turns": {k: v[0] for k, v in k3.items()},
    }


def d2h_bytes(torch, fn, path):
    """Run ``fn`` under ``torch.profiler`` and return the largest
    device-to-host copy of the trace, in bytes (the trace is written to
    ``path``), and ``fn``'s result."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    sizes = [int(e.get("args", {}).get("bytes", 0)) for e in events
             if "DtoH" in e.get("name", "") or "Device -> Pageable"
             in e.get("name", "") or "Device -> Pinned" in e.get("name", "")]
    return max(sizes, default=0), out


def diagnostics(torch, np, dev, card, chains, trace_path):
    """Geyer tau, ``ess`` and ``rhat`` on device chains (tensors ``(n_t,
    n_w, n_d)``): the device path against the float64 host path on the
    same chain, to float32 tolerance (rtol 1e-4), each timed; the
    profiler shows no device-to-host copy larger than the walker-averaged
    ACF.  Returns ``{label: {...}}``."""
    from emcee_tpu_torch.autocorr import ess, integrated_time, rhat

    fns = (("tau (Geyer)", lambda x: integrated_time(
               x, method="geyer", quiet=True)),
           ("ess (Geyer)", lambda x: ess(x, method="geyer", quiet=True)),
           ("rhat", rhat))
    out = {}
    for label, chain in chains.items():
        host = chain.double().cpu().numpy()
        n_t, _, n_d = chain.shape
        row = {"shape": list(chain.shape)}
        for name, fn in fns:
            fn(chain)  # warm-up: cuFFT plans, sort buffers
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(chain)
            t_dev = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = fn(host)
            t_host = time.perf_counter() - t0
            if not np.allclose(got, want, rtol=1e-4, atol=0.0,
                               equal_nan=True):
                raise AssertionError(f"{label} {name}: device {got} vs "
                                     f"host {want}")
            err = float(np.nanmax(np.abs(got - want)))
            big, _ = d2h_bytes(torch, lambda: fn(chain), trace_path)
            if big > n_t * n_d * 8:
                raise AssertionError(f"{label} {name}: a {big}-byte "
                                     "device-to-host copy")
            row[name] = dict(device_s=t_dev, host_s=t_host, max_abs_err=err,
                             largest_d2h_bytes=big, value=got.tolist())
            log(f"phase 10: {label} {tuple(chain.shape)}: {name} "
                f"{np.array2string(got[:5], precision=4)}"
                f"{' ...' if n_d > 5 else ''} on the card in {t_dev:.4f} s, "
                f"the float64 host path {t_host:.4f} s, max abs diff "
                f"{err:.3g}; largest device-to-host copy {big} bytes "
                f"(ACF {n_t * n_d * 4}) {card}")
        out[label] = row
    return out


def phase10(torch, np, dev, card, chains):
    """This slice's paths at full width (1e5 walkers, the main path's
    5-D unit Gaussian): each new move through K3's graphs, its graph
    chain against the plain versions' eager chain bit for bit (64
    proposals, KDE 8), its acceptance, mean log-prob, walker-steps/s
    graph vs eager in turns, and K2's launches per proposal as the
    profiler counts them; KDE's peak memory; the diagnostics on the
    device chains of phases 4 and 8; one ``run_until_converged`` into a
    ``DeviceBackend``.  Returns the numbers and the K6 row (K7's rows
    are phase 19's)."""
    from emcee_tpu_torch import moves
    from emcee_tpu_torch.ops import kde_kernel

    p0 = np.random.default_rng(3).normal(size=(NW, ND)).astype(np.float32)

    # (label, move, proposals, K2 and K14 launches a proposal[, other
    # kernels a proposal]).  K14: the MH function's normals (one draw; a
    # split's each for the red-blue moves), the KDE move's kernel centres
    # (one a split each), and the shuffled split's sort keys (one a
    # proposal, the red-blue moves' default); the Gaussian move draws in
    # K19 (phase 26; two launches in the sequential mode: the proposal and
    # the index's advance), the walk move in its kernels (phase 25: K8a,
    # K8b and K18a, or K18b).
    configs = (
        ("GaussianMove(0.5)", lambda: moves.GaussianMove(0.5), 64, 1, 0,
         {"gaussian_propose": 1}),
        ("GaussianMove(0.5, mode='random')",
         lambda: moves.GaussianMove(0.5, mode="random"), 64, 1, 0,
         {"gaussian_propose": 1}),
        ("GaussianMove(0.5, mode='sequential')",
         lambda: moves.GaussianMove(0.5, mode="sequential"), 64, 1, 0,
         {"gaussian_propose": 2}),
        ("GaussianMove(full cov)", lambda: moves.GaussianMove(FULL26), 64,
         1, 0, {"gaussian_propose": 1}),
        ("MHMove(Philox normals)", lambda: moves.MHMove(mh_normals), 64,
         1, 1),
        ("WalkMove()", moves.WalkMove, 64, 2, 1,
         {k: v for k, v in WALK_SHARED_PER.items() if k != "accept_select"}),
        ("WalkMove(s=16)", lambda: moves.WalkMove(s=16), 64, 2, 1,
         {"walk_subset": 2}),
        ("KDEMove()", moves.KDEMove, 8, 2, 5),
    )
    out = {"moves": {}}
    # K7's launches, counted on the card: the wrapper adds one to a device
    # word at each launch, and the add is recorded into the graphs beside
    # the launch, so every replayed launch counts too.
    k7_calls = torch.zeros((), dtype=torch.int64, device=dev)
    kde_kernel.kde_logpdf.device_launches = k7_calls
    try:
        for config in configs:
            out["moves"][config[0]] = phase10_move(
                torch, np, dev, card, p0, config, k7_calls)
    finally:
        kde_kernel.kde_logpdf.device_launches = None
    return phase10_rest(torch, np, dev, card, chains, p0, out)


def phase10_move(torch, np, dev, card, p0, config, k7_calls,
                 phase="phase 10"):
    """One move of phase 10 (see :func:`phase10`; phase 12 runs its side
    and slice moves through it too); returns its row."""
    from emcee_tpu_torch import EnsembleSampler

    label, make_move, n, k2_per, k14_per, *more = config
    more = more[0] if more else {}

    def per_of(smp):
        """The path's launches a proposal: K2's, K14's, the KDE move's K7
        (one a split: ``s`` and ``q`` in one launch) and the config's other
        kernels (``more``: DE-Z's K10; a function of the move for the
        slice move's K9, :func:`slice_launches`)."""
        mv = smp._moves[0]
        return {"accept_select": k2_per, "philox_draw": k14_per,
                "kde_logpdf": 2 if kde else 0} | shuffle_of(mv) | (
                    more(mv) if callable(more) else more)

    def make():
        return EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=12,
                               device=dev, moves=make_move())

    kde = label.startswith("KDE")
    if kde:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    acc_chain = graph_vs_plain_chain(torch, make, p0, n=n)
    # K7's calls are counted from here to the last profiled window.
    k7_calls.zero_()
    smps = {}
    for graphs in (False, True):
        smp = smps[graphs] = make()
        smp._use_graphs = graphs
        drive(smp, p0, n, per_proposal=per_of(smp), store=False,
              skip_initial_state_check=True)
    # KDE is profiled in windows of one proposal (below): record that
    # graph too, so no timed or profiled run records one.
    n_prof = 1 if kde else n
    looped = smps[True]._moves[0].looped
    if not looped:
        smps[True]._program.graph(0, n_prof, False)
    # A KDE proposal is ~10 ms on the card: sixteen per turn.
    n_timed = 16 if kde else n
    if n_timed != n:
        smps[True]._program.graph(0, n_timed, False)
    rates = {False: [], True: []}
    for graphs in (False, True, True, False):
        _, dt = drive(smps[graphs], None, n_timed,
                      per_proposal=per_of(smps[graphs]), store=False)
        rates[graphs].append(n_timed * NW / dt)
    smp = smps[True]
    st = smp._previous_state
    mean_lp = float(st.log_prob.mean())
    acc = float(smp.last_run_stats.acceptance_fraction.mean())
    if not -3.5 < mean_lp < -1.5:  # bench.py:161
        raise AssertionError(f"{phase}: {label}: mean log-prob {mean_lp}")
    # K2's launches by the profiler, each window checked on its own.  KDE
    # takes four windows of one proposal, each also holding K7's device
    # count to 2 (two splits, each one launch for s and q).  Each window's
    # kernel events are printed.
    busy_us, events = 0.0, []
    k14 = per_of(smp)["philox_draw"]
    shuf = shuffle_of(smp._moves[0])
    profiled = None
    for _ in range(4 if kde else 1):
        k7_before = [int(k7_calls)]
        if looped:
            # The slice move's K9b and K9c launches follow its trips
            # (LoopLaunches), and the profiler, late in the whole script,
            # drops a few of a window's events: so every launch is counted
            # exactly on the card (a device word beside each launch), the
            # profiler's count is read beside it, and a profiled window
            # times.
            per = per_of(smp)
            trips = [v for v in per.values() if isinstance(v, LoopLaunches)]
            counts, profiled = counted_replays(
                torch, dev, smp, n_prof, lambda r: {
                    k: (v.count(n_prof) if isinstance(v, LoopLaunches)
                        else v * n_prof) for k, v in per.items() if v},
                f"{phase}: {label}",
                before=lambda: [v.begin() for v in trips], store=False)
            k7_before = [int(k7_calls)]
            wall, kernels = profile_window(
                torch, lambda: drive(smp, None, n_prof, store=False))
        else:
            def expect():
                k7_before.append(int(k7_calls))
                return {"stretch_propose": 0,
                        "accept_select": k2_per * n_prof,
                        "de_propose": 0, "snooker_propose": 0,
                        "philox_draw": k14 * n_prof,
                        "kde_logpdf": (2 if kde else 0) * n_prof} | {
                            k: v * n_prof for k, v in (shuf | more).items()}

            wall, kernels, counts, _ = counted_window(
                torch, lambda: drive(smp, None, n_prof, store=False), expect,
                label)
        k7_window = int(k7_calls) - k7_before[-1]
        events.append(sum(c for c, _ in kernels.values()))
        if k7_window != (2 * n_prof if kde else 0):
            raise AssertionError(
                f"{label}: K7 calls {k7_window}; {events[-1]} kernel "
                "events")
        busy_us += sum(us for _, us in kernels.values())
    row = dict(acceptance=acc, acceptance_64=acc_chain, mean_lp=mean_lp,
               rates=rates, k2_per_proposal=k2_per,
               k14_launches=counts["philox_draw"],
               profiled_windows=len(events), kernel_events=events,
               device_us_per_proposal=busy_us / (n_prof * len(events)),
               k7_calls=int(k7_calls), seconds=time.perf_counter() - t_all)
    if looped:
        row.update(replayed_launches=counts, profiled_replayed=profiled,
                   proposals_counted=n_prof,
                   ms_per_launch={k: device_ms(kernels, k)
                                  for k in K9_KERNELS})
    if kde:
        row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    log(f"{phase}: {label}: {n} graph-replayed proposals equal the "
        f"plain versions' eager chain, bit for bit; acceptance "
        f"{acc:.4f}, mean lp {mean_lp:.4f}; walker-steps/s in turns "
        f"eager {rates[False][0]:.4e}, graph {rates[True][0]:.4e}, graph "
        f"{rates[True][1]:.4e}, eager {rates[False][1]:.4e}; device "
        f"{row['device_us_per_proposal']:.1f} us per proposal; K2 "
        f"launches per proposal {k2_per}, K14 launches "
        f"{counts['philox_draw']} ({'device words' if looped else 'profiler'}"
        f") in {len(events)} "
        f"window(s) of {n_prof} proposal(s), kernel events {events}"
        + (f"; K7 launches {row['k7_calls']} (device counter); peak memory "
           f"{row['peak_memory_bytes'] / 2**30:.2f} GiB" if kde else "")
        + f" ({row['seconds']:.1f} s) {card}")
    return row


def phase10_rest(torch, np, dev, card, chains, p0, out):
    """Phase 10 after the moves and K7: the diagnostics, one
    ``run_until_converged`` and K6 (see :func:`phase10`)."""
    from emcee_tpu_torch import (
        ConvergenceMonitor, EnsembleSampler, moves, run_until_converged)
    from emcee_tpu_torch.autocorr import integrated_time, rhat
    from emcee_tpu_torch.backends import DeviceBackend
    from emcee_tpu_torch.monitor import stored_chain
    from emcee_tpu_torch.ops import autocorr as ac

    trace = Path(__file__).resolve().parent / "build" / "d2h_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    out["diagnostics"] = diagnostics(torch, np, dev, card, chains, trace)

    # One run_until_converged on the main path into a DeviceBackend.
    smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=21,
                          device=dev, backend=DeviceBackend(),
                          moves=moves.StretchMove(randomize_split=False,
                                                  pair_mode="roll"))
    mon = ConvergenceMonitor(rhat_threshold=1.01)
    # K6's calls in this run, counted where they run on the card: the
    # walker-averaged ACF and its window (tau) and the rank-normalised
    # R-hat, each on its kernels (phase 24 counts their launches).
    k6_calls = {"_acf_kernels": 0, "_rhat_kernels": 0}
    saved = {name: getattr(ac, name) for name in k6_calls}

    def counting(name):
        def call(x, *args, **kw):
            k6_calls[name] += x.is_cuda
            return saved[name](x, *args, **kw)
        return call

    for name in k6_calls:
        setattr(ac, name, counting(name))
    try:
        t0 = time.perf_counter()
        _, mon = run_until_converged(smp, p0, max_steps=2000,
                                     check_every=200, monitor=mon,
                                     thin_by=10,
                                     skip_initial_state_check=True)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(ac, name, fn)
    chain = stored_chain(smp)
    t0 = time.perf_counter()
    ConvergenceMonitor(rhat_threshold=1.01).update(chain)
    t_check = time.perf_counter() - t0
    # The device kernels of one check, by the profiler.
    _, kernels = profile_window(
        torch, lambda: ConvergenceMonitor(rhat_threshold=1.01).update(chain))
    check_kernels = {
        what: sum(c for key, (c, _) in kernels.items()
                  if any(w in key.lower() for w in words))
        for what, words in (("fft", ("fft",)), ("sort", ("sort",)),
                            ("all", ("",)))}
    converged = mon.iterations[-1] < 2000 or bool(
        np.all(mon.tau * mon.tau_factor < smp.iteration))
    out["monitor"] = dict(iteration=smp.iteration, checks=len(mon.history),
                          seconds=total, seconds_per_check=t_check,
                          tau=mon.tau.tolist(), rhat=mon.rhat.tolist(),
                          converged=converged, k6_calls=k6_calls,
                          kernels_per_check=check_kernels)
    if not np.isfinite(mon.tau).all() or not np.isfinite(mon.rhat).all():
        raise AssertionError(f"monitor: tau {mon.tau}, rhat {mon.rhat}")
    log(f"phase 10: run_until_converged (main path, DeviceBackend, "
        f"check_every=200, thin_by=10, rhat_threshold=1.01): stopped at "
        f"iteration {smp.iteration} after {len(mon.history)} checks "
        f"(converged: {converged}), tau {np.array2string(mon.tau, precision=2)}"
        f" kept steps, rhat {np.array2string(mon.rhat, precision=4)}; "
        f"{total:.2f} s in all, {t_check:.3f} s per check at the final "
        f"length {card}; K6 calls on the card {k6_calls}; device kernels "
        f"of one check (profiler) {check_kernels}")
    # K6 on the device chain of phase 4: Geyer tau and R-hat, the device
    # path against the float64 host path.
    k6_label = next(iter(chains))
    ch4 = chains[k6_label]
    geyer_rhat = (lambda x: integrated_time(x, method="geyer", quiet=True),
                  rhat)
    ms6 = cuda_ms(torch, lambda: [f(ch4) for f in geyer_rhat], reps=3)
    host4 = ch4.double().cpu().numpy()
    t0 = time.perf_counter()
    for f in geyer_rhat:
        f(host4)
    plain6 = (time.perf_counter() - t0) * 1e3
    diag4 = out["diagnostics"][k6_label]
    out["k6"] = {
        "name": "autocorr", "route": "cuda",
        "source": "emcee_tpu_torch/ops/autocorr.py",
        "replaces": "emcee_tpu/ops/autocorr.py:115",
        "launches": sum(k6_calls.values()),
        "max_abs_err": max(diag4[k]["max_abs_err"]
                           for k in ("tau (Geyer)", "rhat")),
        "ms": ms6, "plain_ms": plain6,
        "bound_ms": ch4.numel() * 4 / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
        "note": "the whole chain on K6a-K6d, K16 and cuFFT (before "
                "them: plain torch and cuFFT): Geyer tau and "
                "rank-normalised R-hat of one chain; plain_ms is the "
                "float64 host path; launches are the ACF and R-hat calls "
                "on the card in the run_until_converged run, counted "
                "(phase 24's rows count each kernel's)",
        "kernels_per_check": check_kernels,
        "shape": list(ch4.shape)}
    log(f"phase 10: K6 (Geyer tau + R-hat) on {tuple(ch4.shape)}: "
        f"{ms6:.2f} ms on the card, {plain6:.2f} ms the float64 host path; "
        f"bound {out['k6']['bound_ms']:.3f} ms (the chain's bytes) {card}")
    return out


#: the blob leaves of phase 11's sweep: dtypes and row shapes
BLOB_DTYPES = ("float32", "float64", "float16", "int32", "int64", "bool")
BLOB_ROWS = ((), (1,), (3,), (2, 2), (7,))
#: phase 11(b)'s blobs, the blobs tutorial's pattern
BLOBS_DTYPE = [("log_prior", float), ("mean", float), ("npos", int)]


def blob_gaussian(x):
    """The main path's target with three blobs (phase 11): the log-prior,
    the walker's mean and its count of positive coordinates."""
    import torch

    log_prior = torch.where((x.abs() < 10).all(-1), 0.0, -torch.inf)
    lp = log_prior - 0.5 * (x**2).sum(-1)
    return lp, log_prior, x.mean(-1), (x > 0).sum(-1).int()


def random_leaf(torch, n, row, dtype, gen, offset=0):
    """``(n, *row)`` of random bytes (NaN payloads included), or 0/1 for
    bool; ``offset`` elements past a fresh allocation (an unaligned
    base)."""
    dt = getattr(torch, dtype)
    size = torch.empty((), dtype=dt).element_size()
    count = n * int(torch.Size(row).numel())
    if dt == torch.bool:
        flat = torch.randint(0, 2, (count + offset,), generator=gen,
                             device=gen.device).bool()
    else:
        raw = torch.randint(0, 256, ((count + offset) * size,),
                            dtype=torch.uint8, generator=gen,
                            device=gen.device)
        flat = raw.view(dt)
    return flat[offset:].view((n,) + tuple(row))


#: K2's blob variants in phase 11's sweep: the wrapper, and launches
#: that force a path, as (q staged, scalar leaves read into registers
#: where the plan says so; else phase C)
K2_BLOB_VARIANTS = {"the wrapper's": None,
                    "q direct": (False, True),
                    "q staged, leaves by phase C": (True, False),
                    "q direct, leaves by phase C": (False, False)}


def k2_blob_launch(q, f, lp_q, c, l, split, ns, acc, cnt, log_u, blobs,
                   stage_q, rows):
    """K2 with blob leaf pairs ``blobs``, forced onto a path: q staged in
    shared memory or read directly; the leaves as the plan
    (``leaf_plan``) chooses, or by phase C where ``rows`` is False.
    Returns the leaves' descriptors and the row unit launched."""
    from emcee_tpu_torch.ops import accept_kernel as ak
    from emcee_tpu_torch.ops._wrap import device_sm_count, tile_plan

    ng, nw = q.shape[0], c.shape[0]
    plan = tile_plan(ng, c.shape[1], split, device_sm_count(c.device),
                     c.data_ptr(), q.data_ptr(), stage=stage_q)
    descs, row_unit = ak.leaf_plan(ak.blob_leaves(blobs, ng, nw, c.device))
    row_unit = row_unit if rows else 0
    ak._launch(plan, q, f, lp_q, c, l, split, acc, cnt, 0, 0, log_u, descs,
               row_unit)
    return descs, row_unit


def k2_blob_sweep(torch, dev):
    """K2 with blob leaves against its plain version, bit for bit (the
    coords, log-prob, acceptance and count with ``torch.equal``; every
    leaf's buffer compared as bytes, so NaN payloads count): leaf dtypes
    float32, float64, float16, int32, int64 and bool; row shapes (),
    (1,), (3,), (2, 2), (7,); one leaf of each, two and three leaves of
    mixed kinds, leaves whose bases are not aligned to their unit,
    scalar and wider leaves in one launch, 400-byte rows, 1-byte and
    16-byte units, scalar leaves read into registers (the main path's
    three; four, the most; eight 8-byte ones and nine 4-byte ones, too
    many; 4- and 8-byte mixed), and 17 and 33 leaves (beyond the
    launch's 16: blob-only launches); ``nsplits`` 1 and 2 with both
    splits; ``ng`` 5003 (no tile divides it), the main path's 50000 and
    37; each of ``K2_BLOB_VARIANTS``, the first through the wrapper
    ``accept_select`` as the sampler calls it.  Returns the number of
    comparisons and the leaves of the launches' first groups seen read
    into registers (``rows``) and by phase C (``phase C``)."""
    from emcee_tpu_torch.ops import accept_kernel as ak

    gen = torch.Generator(device=dev).manual_seed(29)
    kinds = [(d, r) for d in BLOB_DTYPES for r in BLOB_ROWS]
    sets = [[k] for k in kinds]
    sets += [[kinds[i], kinds[(7 * i + 3) % len(kinds)]]
             for i in range(0, len(kinds), 3)]
    sets += [[kinds[i], kinds[(5 * i + 1) % len(kinds)],
              kinds[(11 * i + 7) % len(kinds)]]
             for i in range(0, len(kinds), 3)]
    # (dtype, row, elements past an aligned base)
    edges = [
        [("float16", (3,), 1), ("float32", (2, 2), 1), ("float64", (7,), 1),
         ("int32", (), 1)],  # unaligned bases
        [("float32", (), 0), ("float32", (3,), 1), ("int64", (2,), 0),
         ("bool", (7,), 1), ("int32", (), 0)],  # scalar and wider rows
        [("float32", (100,), 0)],  # 400-byte rows
        [("float32", (60,), 0), ("float32", (60,), 0),
         ("int32", (), 0)],  # two wide rows and a scalar
        [("bool", (), 0), ("bool", (3,), 0), ("float64", (2,), 0),
         ("float32", (4,), 0)],  # 1-byte and 16-byte units
        [("float32", (), 0), ("float32", (), 0), ("int32", (), 0)],  # rows
        [("int32", (), i % 2) for i in range(4)],  # four: the most rows
        [("float64", (), i % 2) for i in range(4)]
        + [("int64", (1,), 0)] * 4,  # eight 8-byte rows
        [("float32", (), 0)] * 9,  # too many for registers
        [("float32", (), 0), ("float64", (), 0)],  # two units: phase C
    ]
    big = [[kinds[i % len(kinds)] for i in range(n)] for n in (17, 33)]
    nd = ND
    n_cmp = 0
    seen = {"rows": 0, "phase C": 0}

    for ng in (SWEEP_NG, NW // 2, 37):
        for ns, split in ((1, 0), (2, 0), (2, 1)):
            nw = ng * ns
            coords = torch.randn(nw, nd, device=dev, generator=gen)
            lp = gaussian(coords)
            q = coords[:ng] + 0.5 * torch.randn(ng, nd, device=dev,
                                                generator=gen)
            lp_q = gaussian(q)
            f = torch.zeros(ng, device=dev)
            log_u = torch.log(torch.rand(ng, device=dev, generator=gen))
            for leafset in sets + edges + big:
                spec = [k if len(k) == 3 else k + (0,) for k in leafset]
                news = [random_leaf(torch, ng, r, d, gen, off)
                        for d, r, off in spec]
                bufs = [random_leaf(torch, nw, r, d, gen, off)
                        for d, r, off in spec]
                outs = []
                for variant in (*K2_BLOB_VARIANTS, "plain"):
                    c, l = coords.clone(), lp.clone()
                    acc = torch.zeros(nw, dtype=torch.bool, device=dev)
                    cnt = torch.zeros(nw, dtype=torch.int32, device=dev)
                    bs = []
                    for b, (d, r, off) in zip(bufs, spec):
                        copy = random_leaf(torch, nw, r, d, gen, off)
                        copy.copy_(b)
                        bs.append(copy)
                    pairs = list(zip(news, bs))
                    if variant == "plain":
                        ak.accept_select_plain(q, f, lp_q, c, l, split, ns,
                                               acc, cnt, log_u=log_u,
                                               blobs=pairs)
                    elif K2_BLOB_VARIANTS[variant] is None:
                        ak.accept_select(q, f, lp_q, c, l, split, ns, acc,
                                         cnt, log_u=log_u, blobs=pairs)
                        descs, row_unit = ak.leaf_plan(
                            ak.blob_leaves(pairs, ng, nw, c.device))
                        seen["rows" if row_unit else "phase C"] += min(
                            len(descs), ak.BLOB_CAPACITY)
                    else:
                        k2_blob_launch(q, f, lp_q, c, l, split, ns, acc, cnt,
                                       log_u, pairs,
                                       *K2_BLOB_VARIANTS[variant])
                    outs.append(((c, l, acc, cnt),
                                 [b.reshape(-1).view(torch.uint8)
                                  for b in bs]))
                (want, wleaves) = outs[-1]
                if not 0 < int(want[2].sum()) < ng:
                    raise AssertionError("phase 11: K2 sweep acceptance is "
                                         "all or nothing")
                for variant, (got, gleaves) in zip(K2_BLOB_VARIANTS,
                                                   outs[:-1]):
                    n_cmp += 1
                    if not (all(torch.equal(a, b) for a, b in zip(got, want))
                            and all(torch.equal(a, b)
                                    for a, b in zip(gleaves, wleaves))):
                        raise AssertionError(
                            f"phase 11: K2 with blob leaves {spec}, ng {ng},"
                            f" nsplits {ns}, split {split}, {variant}: "
                            "kernel and plain version differ")
    torch.cuda.synchronize()
    return n_cmp, seen


def k2_leaf_sweep(torch, q, f, lp_q, work, pairs, reps=200):
    """K2 on the proposal ``(q, f, lp_q)`` of split 0 with blob leaf pairs
    ``pairs``, each of their paths on fresh copies of ``work`` (coords,
    log_prob, accepted, count): the plan's (scalar leaves in registers),
    the leaves by phase C, and no leaves.  Eager launches profiled, the
    paths in turns, up then down, averaged.  Returns ``{path: device us a
    launch}``."""
    bufs = [w.clone() for w in work]
    paths = {"registers": (pairs, True), "phase C": (pairs, False),
             "no leaves": ([], True)}

    def run(blobs, rows):
        for b, w in zip(bufs, work):
            b.copy_(w)
        k2_blob_launch(q, f, lp_q, bufs[0], bufs[1], 0, 2, bufs[2], bufs[3],
                       None, blobs, True, rows)

    got = {}
    for name in list(paths) + list(paths)[::-1]:
        got.setdefault(name, []).append(profiled_ms(
            torch, lambda: [run(*paths[name]) for _ in range(reps)],
            "accept_select") * 1e3)
    return {k: sum(v) / len(v) for k, v in got.items()}


def blob_subset_check(torch, np, smp, steps):
    """Every stored blob of kept steps ``steps`` of a ``DeviceBackend``
    run equals :func:`blob_gaussian` evaluated on the card at the stored
    coords: the int leaf exactly, the float leaves to float32 rounding
    (the same float32 operations on the same rows).  A blob row selected
    for the wrong walker would differ.  Returns the number of values
    held."""
    from emcee_tpu_torch.utils import tree_leaves

    n = 0
    for k in steps:
        x = smp.backend.chain[k]
        _, *want = blob_gaussian(x)
        got = tree_leaves(smp.backend.blobs)
        for g, w in zip(got, want):
            g = g[k]
            if torch.equal(g, w):
                pass
            elif g.dtype.is_floating_point:
                max_err(g, w, rtol=1.2e-7, atol=0.0)
            else:
                raise AssertionError(f"phase 11: stored int blob of kept "
                                     f"step {k} differs from the function")
            n += g.numel()
    return n


def phase11(torch, np, dev, card):
    """Phase 11 (blobs and io): (a) K2 with blob leaves against its plain
    version (:func:`k2_blob_sweep`); (b) the main path with the blobs
    tutorial's three blobs (``blob_gaussian``, ``BLOBS_DTYPE``) at full
    width: ``store=False`` rates with and without blobs in turns (the
    counts set to 0 before the blob run and read after it), the host
    ``Backend`` and ``DeviceBackend`` from one start (100 kept x
    ``thin_by=20``; chains and blobs equal), the stored blobs of a subset
    of kept steps against the function at the stored coords, and K2's
    device time per launch with and without blob leaves, by the profiler
    inside replays, with its launches counted; (c) ``io_dtype=float16``
    into ``DeviceBackend`` and the host ``Backend``; (d) workload 2, the
    line fit with a blob, at its own size with its oracle; (e) the
    ``HDFBackend``, where h5py is installed.  Returns phase 11's numbers
    and the K2-with-blobs row of the kernel table."""
    from emcee_tpu_torch import EnsembleSampler, moves
    from emcee_tpu_torch.backends import Backend, DeviceBackend
    from emcee_tpu_torch.chunk_graph import ChunkProgram
    from emcee_tpu_torch.ops import accept_kernel as ak
    from emcee_tpu_torch.ops import stretch_kernel as sk
    from emcee_tpu_torch.ops._wrap import device_sm_count, tile_plan

    out = {}
    # -- (a) K2 with blob leaves ---------------------------------------------
    t0 = time.perf_counter()
    n_cmp, seen = k2_blob_sweep(torch, dev)
    out["k2_blob_comparisons"], out["k2_blob_leaves_seen"] = n_cmp, seen
    log(f"phase 11: K2 with blob leaves (float32, float64, float16, int32, "
        f"int64, bool; rows (), (1,), (3,), (2, 2), (7,); 1-3, 17 and 33 "
        f"leaves; unaligned bases; scalar and wider leaves in one launch; "
        f"400-byte rows; 1- and 16-byte units; nsplits 1 and 2, both "
        f"splits; ng {SWEEP_NG}, {NW // 2} and 37; "
        f"{', '.join(K2_BLOB_VARIANTS)}): {n_cmp} comparisons with its "
        f"plain version, all identical; leaves of the wrapper's first "
        f"groups in registers {seen['rows']}, by phase C "
        f"{seen['phase C']} ({time.perf_counter() - t0:.1f} s)")
    if not all(seen.values()):
        raise AssertionError(f"phase 11: the sweep did not reach both leaf "
                             f"paths: {seen}")

    # -- (b) the main path with blobs ----------------------------------------
    mv = moves.StretchMove(randomize_split=False, pair_mode="roll")
    p0 = np.random.default_rng(11).normal(size=(NW, ND)).astype(np.float32)

    def sampler(blobs, **kw):
        if blobs:
            return EnsembleSampler(NW, ND, blob_gaussian, vectorize=True,
                                   seed=21, moves=mv,
                                   blobs_dtype=BLOBS_DTYPE, **kw)
        return EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=21,
                               moves=mv, **kw)

    plain, blob = sampler(False), sampler(True)
    drive(plain, p0, 200, store=False, skip_initial_state_check=True)
    warm_graphs(plain)
    for _, fn in wrappers().values():
        fn.launches = 0
    r0 = ChunkProgram.replays
    st, _ = drive(blob, p0, 200, store=False, skip_initial_state_check=True)
    warm_graphs(blob)
    n_rate = 4000
    _, dt = drive(blob, None, n_rate, store=False)
    blob_launches = launch_counts()
    blob_replays = ChunkProgram.replays - r0
    if not (blob_launches["stretch_propose"]
            and blob_launches["accept_select"] and blob_replays):
        raise AssertionError(f"phase 11: main path with blobs: launches "
                             f"{blob_launches}, replays {blob_replays}")
    if st.blobs is None or len(st.blobs) != 3:
        raise AssertionError("phase 11: the state carries no blobs")
    rates = {"no blobs": [], "blobs": []}
    for label in ("no blobs", "blobs", "blobs", "no blobs"):
        smp = blob if label == "blobs" else plain
        _, dt = drive(smp, None, n_rate, store=False)
        rates[label].append(n_rate * NW / dt)
    acc = blob.last_run_stats.acceptance_fraction.mean()
    if not 0.2 < acc < 0.8:
        raise AssertionError(f"phase 11: acceptance {acc}")
    out["rates"] = rates
    log(f"phase 11: main path store=False in turns (no blobs, blobs, "
        f"blobs, no blobs): {rates['no blobs'][0]:.4e}, "
        f"{rates['blobs'][0]:.4e}, {rates['blobs'][1]:.4e}, "
        f"{rates['no blobs'][1]:.4e} walker-steps/s {card}; acceptance "
        f"{acc:.4f}; counts from 0 over the blob runs: wrapper launches "
        f"{blob_launches}, K3 replays {blob_replays}")

    # Host Backend and DeviceBackend with blobs, from one start.
    thin_by, kept = 20, 100
    stored = {}
    for label, backend in (("Backend", None), ("DeviceBackend",
                                               DeviceBackend())):
        smp = sampler(True, backend=backend)
        t0 = time.perf_counter()
        drive(smp, st, kept, thin_by=thin_by, skip_initial_state_check=True)
        dt = time.perf_counter() - t0
        stored[label] = smp
        log(f"phase 11: {label} with blobs: {kept} kept x thin_by {thin_by}"
            f" in {dt:.3f} s (graphs recorded in it) {card}")
    hs, ds = stored["Backend"], stored["DeviceBackend"]
    hb, db = hs.get_blobs(), ds.get_blobs()
    if not (np.array_equal(hs.get_chain(), ds.get_chain().astype(np.float64))
            and np.array_equal(hs.get_log_prob(), ds.get_log_prob())
            and hb.dtype == db.dtype and hb.shape == (kept, NW)
            and hb.tobytes() == db.tobytes()
            and hb.dtype.names == ("log_prior", "mean", "npos")):
        raise AssertionError("phase 11: the host Backend's chain or blobs "
                             "differ from the DeviceBackend's")
    n_vals = blob_subset_check(torch, np, ds, (0, 37, 73, kept - 1))
    if not np.array_equal(hb["npos"], (hs.get_chain() > 0).sum(-1)):
        raise AssertionError("phase 11: host blobs: npos differs")
    log(f"phase 11: host Backend and DeviceBackend with blobs: chains, "
        f"log-probs and blobs (fields {hb.dtype.names}, {hb.dtype}) equal; "
        f"the stored blobs of 4 kept steps equal the function at the "
        f"stored coords ({n_vals} values; int exact, float to float32 "
        f"rounding)")
    out["stored_blob_values_checked"] = n_vals

    # K2's device time with and without blob leaves, inside replays, in
    # windows of 320 proposals (~10^4 kernel events with blobs: the
    # profiler has dropped events of a 1280-proposal window, ~4 x 10^4).
    # A window whose K2 count is not exactly 2 per proposal is run again,
    # up to three times, and said so.
    n_prof = 320
    k2_us, busy_us = {}, {}
    for label, smp in (("no blobs", plain), ("blobs", blob)):
        # The instantiation's Blobs type names the variant (NoBlobs, or
        # BlobRows / BlobLeaves).
        for attempt in range(3):
            _, kernels = profile_window(
                torch, lambda: drive(smp, None, n_prof, store=False))
            hits = [(c, us) for k, (c, us) in kernels.items()
                    if "accept_select_kernel<" in k
                    and ("NoBlobs" in k) == (label == "no blobs")]
            n = sum(c for c, _ in hits)
            if any("accept_blobs_only_kernel" in k for k in kernels):
                raise AssertionError("phase 11: a blob-only K2 launch on "
                                     "the main path")
            if n == 2 * n_prof:
                break
            log(f"  phase 11: {label}: the profiler counted {n} K2 "
                f"launches for {n_prof} proposals; window run again")
        else:
            raise AssertionError(f"phase 11: {label}: {n} K2 launches "
                                 f"profiled for {n_prof} proposals")
        k2_us[label] = sum(us for _, us in hits) / n
        busy_us[label] = (sum(us for _, us in kernels.values()) / n_prof,
                          sum(c for c, _ in kernels.values()) / n_prof)
    out["k2_us"], out["device_us_per_proposal"] = k2_us, busy_us
    log(f"phase 11: K2 device us/launch inside replays, profiled "
        f"({2 * n_prof} launches each): no blobs {k2_us['no blobs']:.3f}, "
        f"three 4-byte blob leaves {k2_us['blobs']:.3f}; device us (kernel "
        f"launches) per proposal: no blobs {busy_us['no blobs'][0]:.2f} "
        f"({busy_us['no blobs'][1]:.1f}), blobs {busy_us['blobs'][0]:.2f} "
        f"({busy_us['blobs'][1]:.1f}) {card}")

    # K2 with blobs alone: the kernel, the plain version, the bound.
    coords = torch.as_tensor(p0, device=dev)
    ng = NW // 2
    q, f = sk.stretch_propose(coords, 0, 2, a=2.0, ndim_global=ND,
                              pair_mode="roll", seed=3, offset=8)
    lp_q, *new = blob_gaussian(q)
    lp = gaussian(coords)
    bufs = [b.clone() for b in blob_gaussian(coords)[1:]]
    pairs = list(zip([b.contiguous() for b in new], bufs))
    work = [coords.clone(), lp.clone(),
            torch.zeros(NW, dtype=torch.bool, device=dev),
            torch.zeros(NW, dtype=torch.int32, device=dev)]
    k2 = dict(seed=3, offset=8)
    ak.accept_select(q, f, lp_q, work[0].clone(), work[1].clone(), 0, 2,
                     work[2], work[3], **k2)
    n_acc = int(work[2][:ng].sum())
    call_ms = cuda_ms(torch, lambda: ak.accept_select(
        q, f, lp_q, work[0], work[1], 0, 2, work[2], work[3], blobs=pairs,
        **k2))
    plain_ms = cuda_ms(torch, lambda: ak.accept_select_plain(
        q, f, lp_q, work[0], work[1], 0, 2, work[2], work[3], blobs=pairs,
        **k2), reps=20)
    blob_row = 12  # three 4-byte leaves
    nbytes = (4 * ng * 3 + ng + n_acc * (4 * ND + 4 * (ND + 1) + 8)
              + n_acc * 2 * blob_row)
    # Instructions the function needs a walker: the accept uniform's
    # Philox block, its log (a shift, a conversion and its scaling, lg2
    # and its scaling: two special-function results) and the decision
    # (two adds and a compare).
    per_walker = PHILOX_INSTR + 8
    plan = tile_plan(ng, ND, 0, device_sm_count(dev), work[0].data_ptr(),
                     q.data_ptr(), stage=True)
    _, row_unit = ak.leaf_plan(ak.blob_leaves(pairs, ng, NW, work[0].device))
    sweep = k2_leaf_sweep(torch, q, f, lp_q, work, pairs)
    t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
         "operations": instruction_bound(per_walker * ng, 2 * ng)}
    by = max(t, key=t.get)
    blobs_type = {4: "BlobRows<unsigned int>", 8: "BlobRows<uint2>",
                  0: "BlobLeaves"}[row_unit]
    label = (f"accept_select_kernel<{str(bool(plan.vec)).lower()}, "
             f"{str(bool(plan.stage)).lower()}, {blobs_type}>")
    regs = PTXAS.get(label)
    waves = (plan.grid / (device_sm_count(dev) * resident_blocks(
        regs[0], 256, regs[1] + plan.smem)) if regs else None)
    log(f"phase 11: K2 with the main path's three blob leaves, eager "
        f"launches profiled, in turns: " + ", ".join(
            f"{k} {v:.3f} us" for k, v in sweep.items()) + f" {card}")
    row = {
        "name": "accept_select_blobs", "route": "cuda",
        "source": "emcee_tpu_torch/csrc/accept_select.cu",
        "replaces": "emcee_tpu/moves/red_blue.py:200",
        "launches": blob_launches["accept_select"], "max_abs_err": 0.0,
        "ms": k2_us["blobs"] * 1e-3, "call_ms": call_ms,
        "plain_ms": plain_ms, "bound_ms": t[by], "bound_by": by,
        "bound_bytes_ms": t["bytes"],
        "bound_instructions_ms": t["operations"],
        "instructions_per_walker": per_walker,
        "library_ms": None, "ms_without_blobs": k2_us["no blobs"] * 1e-3,
        "blob_leaves": 3, "row_unit": row_unit,
        "smem_bytes": plan.smem, "ptxas": regs, "waves": waves,
        "leaf_sweep_us": sweep,
        "comparisons": n_cmp,
        "note": "ms_without_blobs: the blob-free K2 in the same windows; "
                "bound: the larger of the bytes (each input read once, "
                "each output written once) at 3.35 TB/s and the "
                "instructions the function needs (a Philox block, a log "
                "and the decision a walker) at the issue rate, their "
                "special functions at theirs",
    }
    log(f"phase 11: K2 with three blob leaves: device "
        f"{row['ms'] * 1e3:.3f} us/launch (without blobs "
        f"{k2_us['no blobs']:.3f}), {call_ms * 1e3:.2f} us per back-to-back "
        f"call, plain {plain_ms * 1e3:.2f} us, bound "
        f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}; bytes "
        f"{t['bytes'] * 1e3:.3f} us: {nbytes} bytes, {n_acc} of {ng} "
        f"accepted; instructions {t['operations'] * 1e3:.3f} us: "
        f"{per_walker} a walker); leaves in registers (row unit "
        f"{row_unit}), {plan.smem} bytes of dynamic shared memory, {label} "
        f"{regs} (registers, static shared, spilled), "
        f"{measured(waves, '.3f')} waves {card}")

    # -- (c) io_dtype float16 --------------------------------------------------
    kept16, thin16 = 20, 5
    ref = sampler(True, backend=DeviceBackend())
    drive(ref, st, kept16, thin_by=thin16, skip_initial_state_check=True)
    want = ref.get_chain().astype(np.float16)
    for label, backend in (("DeviceBackend", DeviceBackend()),
                           ("Backend(dtype=float16)",
                            Backend(dtype=np.float16))):
        smp = sampler(True, backend=backend, io_dtype=np.float16)
        drive(smp, st, kept16, thin_by=thin16, skip_initial_state_check=True)
        got = smp.get_chain()
        if got.dtype != np.float16 or not np.array_equal(got, want):
            raise AssertionError(f"phase 11: io_dtype float16 into {label}:"
                                 " the stored chain is not the float32 "
                                 "chain cast")
        if smp.get_blobs()["mean"].dtype.base != np.float64:
            raise AssertionError("phase 11: declared blob field dtype")
    log(f"phase 11: io_dtype=float16 into DeviceBackend and Backend("
        f"dtype=float16): the stored chains are float16 and equal the "
        f"float32 chain cast ({kept16} kept x thin_by {thin16})")

    # -- (d) workload 2 --------------------------------------------------------
    out["workload2"] = workload2(torch, np, dev, card)

    # -- (e) HDFBackend ------------------------------------------------------
    try:
        import h5py  # noqa: F401
    except ImportError:
        log("hdf: h5py not installed")
        out["hdf"] = "h5py not installed"
    else:
        out["hdf"] = hdf_check(torch, np, sampler, st, card)
    return out, row


def workload2(torch, np, dev, card):
    """Workload 2 (``BASELINE.json`` config 2, the line fit of the
    reference's tutorial with the log posterior as its blob) at its own
    size, 32 walkers x 3, 5000 proposals, on the card, against
    ``tests/integration/test_line_fit.py``'s oracle."""
    from emcee_tpu_torch import EnsembleSampler

    rng = np.random.default_rng(123)
    n = 50
    x = np.sort(10 * rng.uniform(size=n))
    yerr = 0.1 + 0.5 * rng.uniform(size=n)
    y = -0.9594 * x + 4.294
    y += np.abs(0.534 * y) * rng.normal(size=n)
    y += yerr * rng.normal(size=n)
    data = [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (x, y, yerr)]

    def log_prob(theta, x, y, yerr):
        m, b, log_f = theta[0], theta[1], theta[2]
        in_bounds = ((-5.0 < m) & (m < 0.5) & (0.0 < b) & (b < 10.0)
                     & (-10.0 < log_f) & (log_f < 1.0))
        model = m * x + b
        sigma2 = yerr**2 + torch.exp(2 * log_f) * model**2
        log_like = -0.5 * ((y - model) ** 2 / sigma2
                           + torch.log(sigma2)).sum()
        lp = torch.where(in_bounds, log_like, -torch.inf)
        return lp, lp

    p0 = np.array([-1.0, 4.5, -0.7]) + 1e-4 * np.random.default_rng(
        0).normal(size=(32, 3))
    smp = EnsembleSampler(32, 3, log_prob, args=data, seed=42)
    t0 = time.perf_counter()
    smp.run_mcmc(p0, 5000)
    dt = time.perf_counter() - t0
    tau = smp.get_autocorr_time(quiet=True)
    discard = int(5 * tau.max())
    flat = smp.get_chain(flat=True, discard=discard, thin=10)
    med = np.percentile(flat, 50, axis=0)
    blobs = smp.get_blobs(flat=True, discard=discard, thin=10)
    lpv = smp.get_log_prob(flat=True, discard=discard, thin=10)
    ok = (np.all(tau < 80) and abs(med[0] + 0.9594) < 0.15
          and abs(med[1] - 4.294) < 0.6
          and abs(med[2] - np.log(0.534)) < 0.3
          and np.array_equal(smp.get_blobs(), smp.get_log_prob()))
    np.testing.assert_allclose(blobs, lpv, rtol=1e-5)
    if not ok:
        raise AssertionError(f"phase 11: workload 2 oracle: tau {tau}, "
                             f"medians {med}")
    log(f"phase 11: workload 2 (line fit, 32 x 3, 5000 proposals, blob = "
        f"lp): tau {np.array2string(tau, precision=2)}, medians "
        f"{np.array2string(med, precision=4)}, get_blobs == get_log_prob, "
        f"acceptance {smp.acceptance_fraction.mean():.4f}, "
        f"{dt:.2f} s with recording {card}")
    return {"tau": tau.tolist(), "medians": med.tolist(), "seconds": dt}


def hdf_check(torch, np, sampler, st, card):
    """20 kept steps of phase 11(b) into an ``HDFBackend`` (a file under
    ``build/``, removed after) read back equal to the host ``Backend``'s
    of the same start."""
    import os
    import tempfile

    from emcee_tpu_torch.backends import HDFBackend

    kept, thin_by = 20, 20
    fd, path = tempfile.mkstemp(suffix=".h5", dir=_build_dir())
    os.close(fd)
    os.remove(path)
    try:
        hs = sampler(True)
        drive(hs, st, kept, thin_by=thin_by, skip_initial_state_check=True)
        fs = sampler(True, backend=HDFBackend(path))
        t0 = time.perf_counter()
        drive(fs, st, kept, thin_by=thin_by, skip_initial_state_check=True)
        dt = time.perf_counter() - t0
        back = HDFBackend(path, read_only=True)
        hb, fb = hs.get_blobs(), back.get_blobs()
        if not (np.array_equal(hs.get_chain(), back.get_chain())
                and np.array_equal(hs.get_log_prob(), back.get_log_prob())
                and hb.dtype == fb.dtype and hb.tobytes() == fb.tobytes()
                and np.array_equal(hs.backend.accepted, back.accepted)):
            raise AssertionError("phase 11: the HDF file differs from the "
                                 "host Backend")
    finally:
        if os.path.exists(path):
            os.remove(path)
    log(f"hdf: {kept} kept x thin_by {thin_by} of the main path with blobs "
        f"into HDFBackend in {dt:.3f} s, read back equal to the host "
        f"Backend's {card}")
    return {"kept": kept, "seconds": dt}


def busy_window(torch, run, n, what, expect=None, names=None, tries=4,
                raw=False):
    """Device microseconds a proposal, kernel events a proposal and the
    idle share over a profiled window of ``run`` (``n`` proposals); with
    ``expect``, the kernels' launches are held to it
    (:func:`counted_window`).

    With ``names`` (``{wrapper: launches a proposal}``, the path's exact
    counts), also the device ms a launch of each (``ms_per_launch``) and
    the device time of every other kernel a proposal
    (``other_us_per_proposal``, its share ``other_share``).  A window in
    which the profiler counted other launches of them is run again, up to
    ``tries`` times (in the whole script it now and then drops events of
    a window, most of one at times); if every window dropped some, the
    per-proposal numbers are None (not measured) and ``ms_per_launch``
    averages the launches it recorded (none recorded raises).  With
    ``raw``, also the window's ``{kernel: (launches, us)}``
    (``kernels``)."""
    want = {k: v * n for k, v in (names or {}).items()}
    for _ in range(tries):
        if expect is None:
            wall, kernels = profile_window(torch, run, primer=bool(want))
            counts = profiled_counts(kernels)
        else:
            wall, kernels, counts, _ = counted_window(torch, run, expect,
                                                      what)
        complete = all(counts[k] == v for k, v in want.items())
        if complete:
            break
        log(f"  {what}: the profiler counted {counts}, the path launches "
            f"{want}; {window_events_line(want)}; window run again")
        time.sleep(0.5)
    if not all(counts[k] for k in want):
        raise AssertionError(f"{what}: no profiled launch of one of "
                             f"{list(want)}")
    busy = sum(us for _, us in kernels.values())
    events = sum(c for c, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
    log(f"  {what}: the six kernels of most device time, us a proposal "
        "(launches a proposal): " + "; ".join(
            f"{us / n:.1f} ({c / n:.1f}) {key[:60]}" for key, (c, us) in top))
    out = dict(device_us_per_proposal=busy / n,
               kernels_per_proposal=events / n,
               idle=1 - busy * 1e-6 / wall, launches=counts,
               top_us_per_proposal={key[:80]: us / n
                                    for key, (_, us) in top})
    if raw:
        out["kernels"] = kernels
    if want:
        ours_us = sum(us for key, (_, us) in kernels.items()
                      if any(launched_by(k, key) for k in want))
        out.update(ms_per_launch={k: device_ms(kernels, k) for k in want},
                   other_us_per_proposal=(busy - ours_us) / n,
                   other_share=(busy - ours_us) / busy)
        if not complete:
            log(f"  {what}: the profiler dropped launches in each of "
                f"{tries} windows; device time a proposal not measured")
            for k in ("device_us_per_proposal", "kernels_per_proposal",
                      "idle", "other_us_per_proposal", "other_share"):
                out[k] = None
    return out


def measured(x, spec=".1f"):
    """A number of a profiled window for the log, or "not measured"."""
    return "not measured" if x is None else format(x, spec)


def tau_of(np, chain, thin_by=1):
    """Max Sokal tau over a stored chain, in proposals (at least 1, as
    ``bench.py:333``)."""
    from emcee_tpu_torch.autocorr import integrated_time

    return max(float(np.max(integrated_time(chain, quiet=True))) * thin_by,
               1.0)


def stage_runs(smp, st, kept, thin_by):
    """``bench.py``'s DIME timing: the stored run twice after the warm
    one, each into a reset backend; returns the last state and the
    faster time."""
    best = float("inf")
    for _ in range(2):
        smp.backend.reset(smp.nwalkers, smp.ndim)
        st, dt = drive(smp, st, kept, thin_by=thin_by,
                       skip_initial_state_check=True)
        best = min(best, dt)
    return st, best


def dime_factor_check(torch, np, dev, move, state_coords, carry):
    """One DIME proposal of split 0 on the card through K8 in float32, and
    the same from the same draws by K8's plain versions in float64: the
    largest differences of the Cholesky factor, the Hastings factors and
    ``q`` (TF32 anywhere would show ~1e-3)."""
    from emcee_tpu_torch.model import Model, wrap_log_prob_fn
    from emcee_tpu_torch.ops import dime_kernel as dk

    nw, nd = state_coords.shape
    ng = nw // move.nsplits
    K = move.n_components
    model = Model(wrap_log_prob_fn(gaussian, vectorize=True), nw, nd)
    cfg = move._config(model, nd)
    gen = torch.Generator(device=dev).manual_seed(31)
    draws = dict(z=torch.randn(ng, nd, device=dev, generator=gen),
                 zg=torch.randn(ng, 1, device=dev, generator=gen))
    if move.df is not None:
        draws["chi2"] = move.df * (1 + 0.1 * torch.rand(
            ng, device=dev, generator=gen))
    q32, f32 = move.get_proposal((0, 0), state_coords, 0, model,
                                 carry=carry, extra=draws)
    t32 = dk.dime_finish(dk.dime_moments(
        state_coords, (0, ng), carry["mean"], carry["w"], K), carry["mean"],
        carry["cov"], carry["w"], cfg)
    c64 = state_coords.double()
    cy = {k: v.double() for k, v in carry.items()}
    t64 = dk.dime_finish_plain(dk.dime_moments_plain(
        c64, (0, ng), cy["mean"], cy["w"], K), cy["mean"], cy["cov"],
        cy["w"], cfg)
    q64, f64 = dk.dime_propose_plain(c64, 0, move.nsplits, t64, 0, 0, cfg,
                                     extra={k: v.double()
                                            for k, v in draws.items()})
    l32 = dk.unpack_table(t32, K, nd)[1].double()
    l64 = dk.unpack_table(t64, K, nd)[1]
    f32 = f32.double()
    return dict(chol=float((l32 - l64).abs().max()),
                factors=float((f32 - f64).abs().max()),
                factors_rel=float(((f32 - f64).abs()
                                   / (1 + f64.abs())).max()),
                q=float((q32.double() - q64).abs().max()))


def chi2_check(torch, np, dev, card, n_calls=20):
    """Both chi-square routes at the bimodal stage's width (one split,
    5e4 walkers) on the card: draws against the chi-square law by K-S,
    and the Marsaglia-Tsang route's exhaustions (must be 0)."""
    from scipy import stats

    from emcee_tpu_torch.moves.dime import MT_CANDIDATES, chi_square

    ng = NW // 2
    out = {}
    for df in (10.0, 7.5):
        word = torch.zeros((), dtype=torch.int64, device=dev)
        x = torch.cat([chi_square(ng, df, 17, k, dev, exhausted=word)
                       for k in range(n_calls)])
        ks = stats.kstest(x[::20].cpu().numpy(), stats.chi2(df).cdf)
        out[df] = dict(draws=x.numel(), exhausted=int(word),
                       ks=float(ks.statistic), p=float(ks.pvalue))
        if int(word) or ks.pvalue < 1e-4:
            raise AssertionError(f"phase 12: chi-square df={df}: {out[df]}")
    log(f"phase 12: chi-square on the card: df=10 (ten squared normals) "
        f"{out[10.0]}, df=7.5 (Marsaglia-Tsang, {MT_CANDIDATES} candidates) "
        f"{out[7.5]}")
    return out


def phase12(torch, np, dev, card):
    """The extension moves at full width through ``run_mcmc`` (see the
    module docstring, 12): bench.py's two DIME stages, ``BlendedMove`` on
    workload 3 in turns with the sampler-level mixture, the side and
    slice moves at the main path's width, DE-Z at its use case and at
    1e5 walkers.  Returns its numbers and no row (K8's rows are phase
    21's, K10's phase 22's, K9's phase 23's)."""
    out = {}
    with path_launches(out, "dime", tuple(K8_PER)):
        out["dime"] = phase12_dime(torch, np, dev, card)
    with path_launches(out, "dime_bimodal", tuple(K8_PER)):
        out["dime_bimodal"] = phase12_bimodal(torch, np, dev, card)
    out["chi2"] = chi2_check(torch, np, dev, card)
    with path_launches(out, "blended", (
            "accept_select", "de_propose", "snooker_propose",
            "blend_select")):
        out["blended"] = phase12_blended(torch, np, dev, card)
    with path_launches(out, "side_slice",
                       ("accept_select", "de_propose") + K9_KERNELS):
        out["side_slice"] = phase12_side_slice(torch, np, dev, card)
    with path_launches(out, "dez", ("accept_select",) + tuple(K10_KERNELS)):
        out["dez"] = phase12_dez(torch, np, dev, card)
    log(f"phase 12: kernel wrapper launches of each path, counted from 0 "
        f"(recordings and eager runs): {out['launches']}")
    return out, []


@contextlib.contextmanager
def path_launches(out, path, kernels, phase="phase 12"):
    """Set every kernel wrapper's count to 0 before a path of phase 12
    (or 13) and read them after it into ``out["launches"][path]``,
    failing if one of ``kernels`` (the path's) was launched no time."""
    for _, fn in wrappers().values():
        fn.launches = 0
    yield
    counts = launch_counts()
    out.setdefault("launches", {})[path] = counts
    if not all(counts[k] for k in kernels):
        raise AssertionError(f"{phase}: {path}: kernel launches {counts}")


def phase12_dime(torch, np, dev, card):
    """(a) ``bench.py:305-349``: 1e5 walkers x 5-D, ``DIMEMove(aimh_prob=
    1.0, df=None, randomize_split=False)`` into ``DeviceBackend``, 400
    kept x 1; a warm run, then two timed runs."""
    from emcee_tpu_torch import EnsembleSampler, moves
    from emcee_tpu_torch.backends import DeviceBackend

    p0 = np.random.default_rng(4).normal(size=(NW, ND)).astype(np.float32)

    def make(backend=None):
        return EnsembleSampler(
            NW, ND, gaussian, vectorize=True, seed=3, device=dev,
            backend=backend, moves=moves.DIMEMove(
                aimh_prob=1.0, df=None, randomize_split=False))

    acc64 = graph_vs_plain_chain(torch, make, p0)
    smp = make(DeviceBackend())
    kept = 400
    t0 = time.perf_counter()
    st, _ = drive(smp, p0, kept, skip_initial_state_check=True)
    warm_s = time.perf_counter() - t0
    tau = tau_of(np, smp.get_chain()[:, :512, :])
    warm_graphs(smp)
    st, dt = stage_runs(smp, st, kept, 1)
    rate = kept * NW / dt
    acc = float(smp.last_run_stats.acceptance_fraction.mean())
    mean_lp = float(st.log_prob.mean())
    if not (-3.5 < mean_lp < -1.5 and acc > 0.9 and np.isfinite(tau)):
        raise AssertionError(f"phase 12: DIME stage: mean lp {mean_lp}, "
                             f"acceptance {acc}, tau {tau}")
    n_prof = 16
    # K8a and K8b for each split and the carry, K8c and K2 for each split;
    # no K14 (K8c draws its own numbers).
    busy = busy_window(torch, lambda: drive(smp, None, n_prof, store=False),
                       n_prof, "DIME stage", lambda: {
                           k: v * n_prof for k, v in K8_PER.items()},
                       names=K8_PER)
    # The same proposals eagerly, for the plain-version column.
    smp._use_graphs = False
    _, dt_eager = drive(smp, None, n_prof, store=False, per_proposal=K8_PER)
    smp._use_graphs = True
    carry = smp._program.ws.carries[0]
    fcheck = dime_factor_check(torch, np, dev, smp._moves[0],
                               smp._program.ws.coords, carry)
    if fcheck["factors_rel"] > 1e-3 or fcheck["chol"] > 1e-4:
        raise AssertionError(f"phase 12: DIME factors against float64: "
                             f"{fcheck}")
    res = dict(walker_steps_per_s=rate, tau=tau, ess_per_s=rate / tau,
               acceptance=acc, mean_lp=mean_lp, seconds=dt,
               warm_seconds=warm_s, acceptance_64=acc64,
               eager_ms_per_proposal=dt_eager / n_prof * 1e3,
               float64=fcheck, proposals_profiled=n_prof, **busy)
    log(f"phase 12: (a) DIME stage (bench.py:305-349; 1e5 x 5-D, "
        f"aimh_prob=1, df=None, DeviceBackend, {kept} kept x 1): "
        f"{rate:.4e} walker-steps/s (best of two), tau {tau:.3f} proposals, "
        f"ESS/s {rate / tau:.4e}, acceptance {acc:.4f}, mean lp "
        f"{mean_lp:.4f} {card}; device "
        f"{measured(busy['device_us_per_proposal'])} us and "
        f"{measured(busy['kernels_per_proposal'], '.0f')} kernels a "
        f"proposal, idle {measured(busy['idle'], '.4f')}, launches "
        f"{ {k: busy['launches'][k] for k in K8_PER} } in {n_prof} "
        f"proposals (profiler), us a launch " + ", ".join(
            f"{k} {measured(v and v * 1e3, '.2f')}"
            for k, v in busy["ms_per_launch"].items())
        + f"; eager {dt_eager / n_prof * 1e3:.3f} ms a proposal; graph chain"
        f" == plain eager chain (64 proposals, acceptance {acc64:.4f}); K8 "
        f"in float32 vs its plain versions in float64: Cholesky "
        f"{fcheck['chol']:.3g}, factors {fcheck['factors']:.3g} (relative "
        f"{fcheck['factors_rel']:.3g}), q {fcheck['q']:.3g}")
    return res


def lp_bimodal(x):
    """``bench.py:357-364``: equal-mass modes at -6 (scale 1) and +6
    (scale 0.2) in 3-D."""
    a = -0.5 * ((x + 6.0) ** 2).sum(-1)
    b = -0.5 * ((x - 6.0) ** 2).sum(-1) / 0.04 - 3 * math.log(0.2)
    return a.logaddexp(b)


def phase12_bimodal(torch, np, dev, card):
    """(b) ``bench.py:351-416``: 1e5 walkers x 3-D asymmetric bimodal,
    ``DIMEMove(aimh_prob=0.3, n_components=2, randomize_split=False)``
    (``df=10``), 400 kept x ``thin_by=2``."""
    from emcee_tpu_torch import EnsembleSampler, moves
    from emcee_tpu_torch.backends import DeviceBackend

    nd = 3
    rng = np.random.default_rng(6)
    p0 = np.concatenate([rng.normal(size=(NW // 2, nd)) - 6.0,
                         rng.normal(size=(NW // 2, nd)) * 0.2 + 6.0]
                        ).astype(np.float32)
    move = moves.DIMEMove(aimh_prob=0.3, n_components=2,
                          randomize_split=False)
    smp = EnsembleSampler(NW, nd, lp_bimodal, vectorize=True, seed=5,
                          device=dev, backend=DeviceBackend(), moves=move)
    kept, thin_by = 400, 2
    st, _ = drive(smp, p0, kept, thin_by=thin_by,
                  skip_initial_state_check=True)
    chain = smp.get_chain()[:, :512, :]
    tau = tau_of(np, chain, thin_by)
    frac = float((chain[kept // 2:, :, 0] > 0).mean())
    warm_graphs(smp)
    st, dt = stage_runs(smp, st, kept, thin_by)
    rate = kept * thin_by * NW / dt
    acc = float(smp.last_run_stats.acceptance_fraction.mean())
    # df=10 takes the integer route, which cannot exhaust: the counter is
    # read from a twin at df=7.5 (Marsaglia-Tsang) through run_mcmc, by
    # the device name the proposals used (one counter only).
    twin = moves.DIMEMove(aimh_prob=0.3, n_components=2, df=7.5,
                          randomize_split=False)
    EnsembleSampler(NW, nd, lp_bimodal, vectorize=True, seed=5, device=dev,
                    moves=twin).run_mcmc(p0, 64, store=False,
                                         skip_initial_state_check=True)
    exhausted = int(twin._exhausted(st.coords.device))
    if (not 0.4 < frac < 0.6 or exhausted or not np.isfinite(tau)
            or len(twin._exhaust_counts) != 1
            or twin._exhausted(dev) is not twin._exhausted(st.coords.device)):
        raise AssertionError(f"phase 12: bimodal DIME: mode fraction "
                             f"{frac}, exhaustions {exhausted} (counters "
                             f"{list(twin._exhaust_counts)}), tau {tau}")
    n_prof = 16
    busy = busy_window(torch, lambda: drive(smp, None, n_prof, store=False),
                       n_prof, "bimodal DIME", lambda: {
                           k: v * n_prof for k, v in K8_PER.items()},
                       names=K8_PER)
    res = dict(walker_steps_per_s=rate, tau=tau, ess_per_s=rate / tau,
               mode_fraction=frac, acceptance=acc, seconds=dt,
               chi2_exhausted=exhausted, **busy)
    log(f"phase 12: (b) bimodal DIME stage (bench.py:351-416; 1e5 x 3-D, "
        f"K=2, df=10, {kept} kept x {thin_by}): {rate:.4e} walker-steps/s, "
        f"tau {tau:.2f} proposals, ESS/s {rate / tau:.4e}, mode fraction "
        f"{frac:.4f}, acceptance {acc:.4f} {card}; chi-square exhaustions "
        f"{exhausted} in a df=7.5 twin of 64 proposals (Marsaglia-Tsang; "
        f"df=10 sums ten squared normals and cannot exhaust); device "
        f"{measured(busy['device_us_per_proposal'])} us and "
        f"{measured(busy['kernels_per_proposal'], '.0f')} kernels a "
        f"proposal, idle {measured(busy['idle'], '.4f')}, us a launch "
        + ", ".join(f"{k} {measured(v and v * 1e3, '.2f')}"
                    for k, v in busy["ms_per_launch"].items()))
    return res


def phase12_blended(torch, np, dev, card, n=1000):
    """(c) ``BlendedMove`` over K5a + K5b on workload 3, in turns with the
    sampler-level mixture of phase 8 (mixture, blended, blended,
    mixture), and the kernels each launches inside the replays."""
    from emcee_tpu_torch import EnsembleSampler, moves

    log_prob, p0 = workload3_target(np, torch, dev)

    def blend():
        return moves.BlendedMove(
            [(moves.DEMove(pair_mode="roll"), 0.8),
             (moves.DESnookerMove(pair_mode="roll", nsplits=2), 0.2)],
            randomize_split=False)

    def make(mv, seed=0):
        return EnsembleSampler(NW3, ND3, log_prob, vectorize=True,
                               seed=seed, device=dev, moves=mv)

    acc64 = graph_vs_plain_chain(torch, lambda: make(blend(), 9), p0)
    smps = {"mixture": make(workload3_moves(moves)), "blended": make(blend())}
    for smp in smps.values():
        drive(smp, p0, 200, store=False, skip_initial_state_check=True)
        warm_graphs(smp)
    rates = {k: [] for k in smps}
    for label in ("mixture", "blended", "blended", "mixture"):
        st, dt = drive(smps[label], None, n, store=False)
        rates[label].append(n * NW3 / dt)
    mean_lp = float(smps["blended"]._previous_state.log_prob.mean())
    acc = float(smps["blended"].last_run_stats.acceptance_fraction.mean())
    if not -0.8 * ND3 < mean_lp < -0.2 * ND3:  # workload3.py:201
        raise AssertionError(f"phase 12: blended mean lp {mean_lp}")
    n_prof = 200
    mix = smps["mixture"]
    busy = {
        "blended": busy_window(
            torch, lambda: drive(smps["blended"], None, n_prof, store=False),
            n_prof, "blended", lambda: {
                "stretch_propose": 0, "accept_select": 2 * n_prof,
                "de_propose": 2 * n_prof, "snooker_propose": 2 * n_prof,
                "blend_select": 2 * n_prof}),  # K20: a split's choice
        # The mixture's exact launches are phase 8's check.
        "mixture": busy_window(
            torch, lambda: drive(mix, None, n_prof, store=False), n_prof,
            "mixture")}
    res = dict(rates=rates, mean_lp=mean_lp, acceptance=acc,
               acceptance_64=acc64, busy=busy)
    log(f"phase 12: (c) BlendedMove on workload 3 (1e4 x 100-D): "
        f"walker-steps/s in turns mixture {rates['mixture'][0]:.4e}, "
        f"blended {rates['blended'][0]:.4e}, blended "
        f"{rates['blended'][1]:.4e}, mixture {rates['mixture'][1]:.4e} "
        f"{card}; device us a proposal blended "
        f"{busy['blended']['device_us_per_proposal']:.1f} "
        f"({busy['blended']['kernels_per_proposal']:.0f} kernels), mixture "
        f"{busy['mixture']['device_us_per_proposal']:.1f} "
        f"({busy['mixture']['kernels_per_proposal']:.0f}); blended launches "
        f"in {n_prof} proposals (profiler) {busy['blended']['launches']}; "
        f"mean lp {mean_lp:.3f}, acceptance {acc:.4f}; graph chain == plain "
        f"eager chain (64 proposals)")
    return res


def phase12_side_slice(torch, np, dev, card, n=64):
    """(d) ``SideMove(pair_mode="roll", randomize_split=False)`` and
    ``EnsembleSliceMove()`` at the main path's width, ``n`` proposals
    each: graph chain against the eager chain bit for bit, rates in
    turns; the slice move's block size, flag reads and evaluations in a
    run of its own; and a slice move whose ``max_steps`` / ``max_shrink``
    caps bind."""
    from emcee_tpu_torch import EnsembleSampler, moves
    from emcee_tpu_torch.chunk_graph import ChunkProgram

    p0 = np.random.default_rng(8).normal(size=(NW, ND)).astype(np.float32)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    out = {"side": phase10_move(
        torch, np, dev, card, p0,
        ("SideMove(pair_mode='roll', randomize_split=False)",
         lambda: moves.SideMove(pair_mode="roll", randomize_split=False),
         n, 2, 0, {"de_propose": 2}), zero, phase="phase 12: (d)")}
    # A slice proposal: K14 once (the shuffle's keys: K9a and K9c draw
    # their own), K9a, K9d and K9c's first list once a group, K9b and K9c
    # once a trip, held exactly by device words.
    out["slice"] = row = phase10_move(
        torch, np, dev, card, p0,
        ("EnsembleSliceMove()", moves.EnsembleSliceMove, n, 0, 1,
         slice_launches), zero, phase="phase 12: (d)")
    rl, pl = row["replayed_launches"], row["profiled_replayed"]
    k9 = {k: rl[k] for k in K9_KERNELS}
    if any(pl[k] > rl[k] for k in K9_KERNELS) or rl["philox_draw"] != (
            row["proposals_counted"]):
        raise AssertionError(f"phase 12: slice: replayed launches {rl}, "
                             f"the profiler's {pl}")
    # The loops of one graph run of n proposals, after its first (which
    # records): iterations the JAX loops need, trips run, rows evaluated,
    # flag reads and block replays.
    # An untimed run, so with the per-walker evaluation counts.
    mv = moves.EnsembleSliceMove()
    mv.count_evals = True
    smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=15,
                          device=dev, moves=mv)
    st, _ = drive(smp, p0, n, store=False, skip_initial_state_check=True)
    w = next(iter(mv._work.values()))
    c0 = [c.clone() for c in (w.iterations, w.executed, w.evals, w.rows)]
    reads0 = ChunkProgram.flag_reads
    drive(smp, None, n, store=False)
    it, ex, ev, rows = ((c - b).tolist() for c, b in zip(
        (w.iterations, w.executed, w.evals, w.rows), c0))
    half_steps = 2 * n  # group updates; each walker is in n of them
    row.update(
        block=mv.loop_block, floor=mv.bucket_floor, proposals=n,
        iterations=it, executed=ex, evals=ev, rows=rows,
        flag_reads_per_proposal=(ChunkProgram.flag_reads - reads0) / n,
        evals_per_walker_half_step=sum(ev) / (n * NW),
        rows_per_walker_half_step=sum(rows) / (n * NW),
        trip_evals_per_walker_half_step=(2 * it[0] + it[1]) / half_steps,
        acceptance_run=float(smp.last_run_stats.acceptance_fraction.mean()))
    log(f"phase 12: (d) slice, B = {mv.loop_block}, bucket floor "
        f"{mv.bucket_floor}: per proposal "
        f"{row['flag_reads_per_proposal']:.2f} flag reads (one a block "
        f"replay); a walker a half-step: "
        f"{row['rows_per_walker_half_step']:.3f} rows evaluated (padding "
        f"included; stepping out {rows[0] / (n * NW):.3f}, shrink "
        f"{rows[1] / (n * NW):.3f}) beside "
        f"{row['evals_per_walker_half_step']:.3f} evaluations needed "
        f"(stepping out {ev[0] / (n * NW):.3f}, shrink "
        f"{ev[1] / (n * NW):.3f}) and "
        f"{row['trip_evals_per_walker_half_step']:.3f} by the group trips "
        f"the JAX loops run (every walker in every trip of its group); "
        f"trips a group: stepping out {it[0] / half_steps:.3f} needed, "
        f"{ex[0] / half_steps:.3f} run, shrink {it[1] / half_steps:.3f} / "
        f"{ex[1] / half_steps:.3f}; K9 launches in {row['proposals_counted']}"
        f" replayed proposals {k9} (device words; the profiler "
        f"{ {k: pl[k] for k in K9_KERNELS} }), K14 "
        f"{rl['philox_draw']}; us a launch in the replays: " + ", ".join(
            f"{k} {measured(v and v * 1e3, '.2f')}"
            for k, v in row["ms_per_launch"].items())
        + f"; acceptance {row['acceptance_run']:.4f} {card}")
    out["slice_block_sweep"] = slice_block_sweep(torch, dev, card, p0)
    out["slice_capped"] = slice_capped(torch, np, dev, p0)
    return out


def slice_block_sweep(torch, dev, card, p0, n=16, blocks=(2, 4, 8, 16)):
    """The slice move's graph rate, flag reads, trips run and rows
    evaluated for several ``loop_block`` B, in turns (each B's segments
    recorded before its timed run); the chains are equal for every B."""
    from emcee_tpu_torch import EnsembleSampler, moves
    from emcee_tpu_torch.chunk_graph import ChunkProgram

    smps, res, ends = {}, {}, []
    for b in blocks:
        mv = moves.EnsembleSliceMove()
        mv.loop_block = b
        smps[b] = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=16,
                                  device=dev, moves=mv)
        drive(smps[b], p0, 1, store=False, skip_initial_state_check=True)
    for b in blocks + blocks[::-1]:
        smp = smps[b]
        w = next(iter(smp._moves[0]._work.values()))
        ex0, reads0 = w.executed.clone(), ChunkProgram.flag_reads
        rows0 = w.rows.clone()
        st, dt = drive(smp, None, n, store=False)
        r = res.setdefault(b, dict(rates=[], flag_reads_per_proposal=(
            ChunkProgram.flag_reads - reads0) / n, executed_per_proposal=(
            (w.executed - ex0) / n).tolist(), rows_per_walker_half_step=(
            float((w.rows - rows0).sum()) / (n * NW))))
        r["rates"].append(n * NW / dt)
        if len(r["rates"]) == 2:
            ends.append(st.coords)
    if not all(torch.equal(e, ends[0]) for e in ends[1:]):
        raise AssertionError("phase 12: slice chains differ between B")
    log("phase 12: (d) slice loop_block sweep, in turns ("
        + ", ".join(str(b) for b in blocks + blocks[::-1]) + "): "
        + "; ".join(f"B={b}: {r['rates'][0]:.4e} / {r['rates'][1]:.4e} "
                    f"walker-steps/s, {r['flag_reads_per_proposal']:.2f} "
                    f"flag reads, {r['executed_per_proposal']} "
                    f"trips run a proposal and "
                    f"{r['rows_per_walker_half_step']:.3f} rows evaluated a "
                    "walker a half-step" for b, r in res.items())
        + f"; chains equal for every B {card}")
    return res


def slice_capped(torch, np, dev, p0, n=8):
    """A slice move whose caps bind (``max_steps=2``, ``max_shrink=2``):
    the graph chain equals the eager chain, no group runs past its caps,
    and some walkers stay put (unaccepted)."""
    from emcee_tpu_torch import EnsembleSampler, moves

    ends = []
    for graphs in (True, False):
        mv = moves.EnsembleSliceMove(mu=5.0, max_steps=2, max_shrink=2,
                                     randomize_split=False)
        smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=14,
                              device=dev, moves=mv)
        smp._use_graphs = graphs
        st = smp.run_mcmc(p0, n, store=False, skip_initial_state_check=True)
        w = next(iter(mv._work.values()))
        ends.append((st, smp.last_run_stats.accepted, w.iterations.clone()))
    # The eager run's loop counters (the graph run's include its
    # warm-up proposal).
    (a, acc_a, _), (b, acc_b, it_a) = ends
    if not (torch.equal(a.coords, b.coords) and torch.equal(acc_a, acc_b)
            and torch.equal(a.log_prob, b.log_prob)):
        raise AssertionError("phase 12: capped slice: graph != eager")
    groups = 2 * n
    frac = float(acc_a.float().mean()) / n
    if int(it_a[0]) > 2 * groups or int(it_a[1]) > 2 * groups or frac >= 1:
        raise AssertionError(f"phase 12: capped slice: iterations "
                             f"{it_a.tolist()} for {groups} groups, "
                             f"acceptance {frac}")
    log(f"phase 12: (d) slice capped at max_steps=2, max_shrink=2 (mu=5): "
        f"graph chain == eager chain ({n} proposals); iterations "
        f"{it_a.tolist()} for {groups} groups (<= 2 each); acceptance "
        f"{frac:.4f} (walkers that hit max_shrink stay put)")
    return dict(iterations=it_a.tolist(), groups=groups, acceptance=frac)


def phase12_dez(torch, np, dev, card):
    """(e) DE-Z at its use case (``tests/integration/test_de_z.py:51-83``:
    8 walkers x 10-D, 12000 proposals, that test's moment checks) and at
    1e5 x 5-D for 64 proposals with the 1e6-row archive."""
    from emcee_tpu_torch import EnsembleSampler, moves

    nw, nd, nsteps = 8, 10, 12000
    coords = np.random.default_rng(2).normal(size=(nw, nd))
    smp = EnsembleSampler(
        nw, nd, gaussian, vectorize=True, seed=1, device=dev,
        moves=moves.DEZMove(update_rows=8, de_noise=0.1,
                            live_dangerously=True))
    t0 = time.perf_counter()
    smp.run_mcmc(coords, nsteps, skip_initial_state_check=True)
    torch.cuda.synchronize()
    small_s = time.perf_counter() - t0
    flat = smp.get_chain(discard=nsteps // 2, flat=True)
    centered = coords - coords.mean(axis=0)
    _, sv, vt = np.linalg.svd(centered, full_matrices=True)
    ortho = vt[np.sum(sv > 1e-8):]
    proj = (flat @ ortho.T).std(axis=0)
    mean, std = flat.mean(axis=0), flat.std(axis=0)
    if not (np.all(np.abs(mean) < 0.2) and np.all(np.abs(std - 1) < 0.15)
            and np.all(proj > 0.7)):
        raise AssertionError(f"phase 12: DE-Z 8 x 10: mean {mean}, std "
                             f"{std}, orthogonal std {proj}")
    log(f"phase 12: (e) DE-Z 8 x 10-D, {nsteps} proposals in {small_s:.2f} "
        f"s (graphs): mean "
        f"|max| {np.abs(mean).max():.4f} (< 0.2), std max |1 - s| "
        f"{np.abs(std - 1).max():.4f} (< 0.15), orthogonal std min "
        f"{proj.min():.4f} (> 0.7) {card}")
    t0 = time.perf_counter()
    n_cmp = k10_sweep(torch, dev)
    log(f"phase 12: (e) K10a, K10b and K10c against their plain versions "
        f"(ndim {K10_SWEEP_ND}, (walkers a split, nsplits) "
        f"{K10_SWEEP_SHAPES}, the ring empty, partly filled, full and "
        f"wrapping, every branch of g1_prob, snooker_prob and de_noise, a "
        f"complement at mean 1e4, injected / host offset / device offset "
        f"draws, unaligned bases): {n_cmp} comparisons, all bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")
    p0 = np.random.default_rng(9).normal(size=(NW, ND)).astype(np.float32)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    row = phase10_move(torch, np, dev, card, p0,
                       ("DEZMove()", moves.DEZMove, 64, 2, 1, K10_ONLY),
                       zero, phase="phase 12: (e)")
    # Every kernel's launches in replayed proposals, by device words.
    smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=0,
                          device=dev, moves=moves.DEZMove())
    n_c = 16
    smp.run_mcmc(p0, n_c, store=False, skip_initial_state_check=True)
    per = K10_PER | shuffle_of(smp._moves[0])
    row["replayed_launches"], _ = counted_replays(
        torch, dev, smp, n_c, lambda r: {k: v * n_c for k, v in per.items()},
        "phase 12: (e) DEZMove() at 1e5", store=False)
    row["proposals_counted"] = n_c
    log(f"phase 12: (e) DE-Z 1e5 x 5-D: launches in {n_c} replayed "
        f"proposals "
        f"{ {k: v for k, v in row['replayed_launches'].items() if v} } "
        f"(device words; exactly {per} a proposal) {card}")
    return dict(small=dict(seconds=small_s, proposals=nsteps,
                           mean=mean.tolist(), std=std.tolist(),
                           orthogonal_std=proj.tolist()), full=row,
                sweep=n_cmp)


# -- phase 13: the gradient moves ---------------------------------------------

#: K11-K13 and K2, the kernels of the gradient moves' paths
GRAD_KERNELS = ("langevin_step", "langevin_factor", "leapfrog",
                "accept_select")


def grad_kernel_sweep(torch, dev):
    """K11, K12 and K13 against their plain versions, ``torch.equal``,
    over ``GRAD_SWEEP_NDS`` x ``GRAD_SWEEP_ROWS``: K11's draws (host and
    device offset words, rows from 0 and 17; with the jitter's ``v``
    beside drawn and injected normals, and alone) and its MALA step (the
    identity and a diagonal preconditioner, drawn and injected ``z``,
    rows from 3, and x, g and z at bases 4 bytes past 16-byte alignment,
    as a split half may be), K11 at every tile of ``K11_SWEEP_TILES``,
    K12 in kinetic mode and in MALA mode (with and without ``c`` and
    ``d``), K13 with 0, 1 and 2 kicks, with and without the drift, both
    metrics, into new buffers and in place.  Returns the number of
    comparisons."""
    from emcee_tpu_torch.ops import langevin_kernel as lk
    from emcee_tpu_torch.ops.philox import DeviceOffset, normals

    gen = torch.Generator(device=dev).manual_seed(13)
    n_cmp = 0

    def same(got, want, what):
        nonlocal n_cmp
        for a, b in zip(got, want):
            if (a is None) != (b is None) or (
                    a is not None and not torch.equal(a, b)):
                raise AssertionError(f"phase 13: {what}: kernel and plain "
                                     "version differ")
        n_cmp += 1

    word = torch.tensor(5, dtype=torch.int64, device=dev)
    for nd in GRAD_SWEEP_NDS:
        for n in GRAD_SWEEP_ROWS:
            x, g, z, c = (torch.randn(n, nd, device=dev, generator=gen)
                          for _ in range(4))
            d = torch.rand(nd, device=dev, generator=gen) + 0.5
            eps = torch.rand((), device=dev, generator=gen) + 0.2
            what = f"{n} x {nd}"
            for row0 in (0, 17):
                want = normals(n, nd, 9, 8, dev, row0=row0)
                for off in (8, DeviceOffset(word, 3)):
                    same(lk.langevin_step((n, nd), dev, seed=9, offset=off,
                                          row0=row0)[:1], (want,),
                         f"K11 draw {what}")
                    # With the jitter's v of a split, drawn or injected z.
                    for split, zin in ((0, None), (3, want.contiguous())):
                        outs = []
                        for fn in (lk.langevin_step, lk.langevin_step_plain):
                            v = torch.empty((), device=dev)
                            z, _ = fn((n, nd), dev, seed=9, offset=off,
                                      row0=row0, z=zin, v=v, v_split=split)
                            outs.append((z, v))
                        same(outs[0], outs[1], f"K11 draw and v {what}")
            xm, gm, zm = (misaligned(torch, t) for t in (x, g, z))
            for dd in (None, d):
                for zin in (None, z):
                    kw = dict(seed=4, offset=11, row0=3, z=zin, x=x, g=g,
                              eps=eps, d=dd)
                    same(lk.langevin_step((n, nd), dev, **kw),
                         lk.langevin_step_plain((n, nd), dev, **kw),
                         f"K11 MALA {what}")
                    kw.update(x=xm, g=gm, z=None if zin is None else zm)
                    same(lk.langevin_step((n, nd), dev, **kw),
                         lk.langevin_step_plain((n, nd), dev, **kw),
                         f"K11 MALA {what}, unaligned bases")
                for cc in (None, c):
                    same((lk.langevin_factor(z, g, cc, eps=eps, d=dd),),
                         (lk.langevin_factor_plain(z, g, cc, eps=eps,
                                                   d=dd),),
                         f"K12 MALA {what}")
                for kicks in (0, 1, 2):
                    for drift in (False, True):
                        if not (kicks or drift):
                            continue
                        for fresh in (False, True):
                            outs = []
                            for fn in (lk.leapfrog, lk.leapfrog_plain):
                                xx, pp = x.clone(), z.clone()
                                kw = dict(d=dd, kicks=kicks,
                                          x=xx if drift else None)
                                if fresh:
                                    kw.update(
                                        x_out=torch.empty_like(x)
                                        if drift else None,
                                        p_out=torch.empty_like(x)
                                        if kicks else None)
                                xo, po = fn(pp, g, eps, **kw)
                                outs.append((xo, po, xx, pp))
                            same(outs[0], outs[1],
                                 f"K13 {what} kicks {kicks} drift {drift}")
            same((lk.langevin_factor(z, g),),
                 (lk.langevin_factor_plain(z, g),), f"K12 kinetic {what}")
    for nd in (1, 5):  # the jitter's v alone: no rows
        outs = []
        for fn in (lk.langevin_step, lk.langevin_step_plain):
            v = torch.empty((), device=dev)
            outs.append((fn((0, nd), dev, seed=2, offset=DeviceOffset(word, 1),
                            v=v, v_split=1)[0], v))
        same(outs[0], outs[1], f"K11 v with no rows, ndim {nd}")
    # K11 at other tiles than its plan's: every mode, row0 17.
    for n, nd in ((100_000, 5), (5003, 100), (31, 7), (1000, 128)):
        x, g, z = (torch.randn(n, nd, device=dev, generator=gen)
                   for _ in range(3))
        d = torch.rand(nd, device=dev, generator=gen) + 0.5
        eps = torch.rand((), device=dev, generator=gen) + 0.2
        for tile in K11_SWEEP_TILES:
            plan = lk.LangevinPlan(tile, -(-n // tile))
            for kw in (dict(), dict(x=x, g=g, eps=eps),
                       dict(x=x, g=g, eps=eps, d=d),
                       dict(x=x, g=g, eps=eps, z=z)):
                want = lk.langevin_step_plain((n, nd), dev, seed=6, offset=7,
                                              row0=17, **kw)
                zin = kw.get("z")
                z_out = None if zin is not None else torch.empty_like(x)
                q = torch.empty_like(x) if "x" in kw else None
                v = torch.empty((), device=dev)
                lk._launch(plan, dev, kw.get("x"), kw.get("g"), kw.get("d"),
                           kw.get("eps"), zin, z_out, q, v, 2, n, nd, 17, 6,
                           7)
                same((z_out if zin is None else zin, q, v),
                     (*want, grad_v(torch, lk, dev, 6, 7, 2)),
                     f"K11 {n} x {nd} at tile {tile}, {sorted(kw)}")
    torch.cuda.synchronize()
    return n_cmp


def grad_v(torch, lk, dev, seed, offset, split):
    """The plain jitter ``v`` of ``split`` (K11's ``v_out``)."""
    v = torch.empty((), device=dev)
    lk.langevin_step_plain((0, 1), dev, seed=seed, offset=offset, v=v,
                           v_split=split)
    return v


def counted_replays(torch, dev, smp, n, expect, what, before=None,
                    warm=False, **kw):
    """Every kernel's launches in ``n`` replayed proposals of ``smp``'s own
    chunk program (``run_mcmc(None, n, **kw)``), counted on the card and
    held exactly to ``expect(replays)`` (``replays``: the graph replays
    of the counted run; a kernel it does not name must not launch).

    Each wrapper's ``device_launches`` word is set
    (``ops._wrap.count_launches``) and the program's graphs are recorded
    anew while it is, so each replayed launch adds one to its word beside
    its kernel: a first run records, the words are zeroed, a second run
    is counted, under the profiler too, whose count of the same launches
    is returned beside.  The timed graphs are set aside meanwhile and put
    back after, so no timed or profiled window replays a graph that holds
    the adds.  ``before``, if given, is called just before the counted run
    (a :class:`LoopDraws`' ``begin``).  ``warm`` records every graph size
    of every move before the words are zeroed (:func:`warm_graphs`): a
    mixture's counted run may need a size the first run did not, and the
    eager warm-up before that recording would count.  Returns ``(device
    counts, profiler counts)``."""
    from emcee_tpu_torch.chunk_graph import ChunkProgram

    prog = smp._program
    timed, prog.graphs = prog.graphs, {}
    fns = {name: fn for name, (_, fn) in wrappers().items()}
    words = {name: torch.zeros((), dtype=torch.int64, device=dev)
             for name in fns}
    for name, fn in fns.items():
        fn.device_launches = words[name]
    try:
        smp.run_mcmc(None, n, **kw)
        if warm:
            warm_graphs(smp)
        torch.cuda.synchronize()
        for w in words.values():
            w.zero_()
        if before is not None:
            before()
        r0 = ChunkProgram.replays
        _, kernels = profile_window(torch, lambda: smp.run_mcmc(None, n,
                                                                **kw))
        replays = ChunkProgram.replays - r0
    finally:
        for fn in fns.values():
            fn.device_launches = None
        prog.graphs = timed
    got = {k: int(w) for k, w in words.items()}
    want = {k: 0 for k in words} | expect(replays)
    if got != want:
        raise AssertionError(f"{what}: replayed launches {got} (device "
                             f"counters), expected {want}")
    return got, profiled_counts(kernels)


def grad_sampler(dev, move, seed, target=None, nw=NW, nd=ND, backend=None):
    from emcee_tpu_torch import EnsembleSampler

    return EnsembleSampler(nw, nd, target or gaussian, vectorize=True,
                           seed=seed, device=dev, backend=backend,
                           moves=move)


def phase13(torch, np, dev, card):
    """The gradient moves (see the module docstring, 13): the K11-K13
    sweep, then each path with the wrappers' counts set to 0 just before
    it and read just after (its comparisons with the plain versions run
    before that).  Returns its numbers and the K11-K13 rows."""
    out = {}
    t0 = time.perf_counter()
    out["sweep"] = grad_kernel_sweep(torch, dev)
    log(f"phase 13: (e) K11-K13 against their plain versions over ndim "
        f"{GRAD_SWEEP_NDS} x rows {GRAD_SWEEP_ROWS}, every mode: "
        f"{out['sweep']} comparisons, all identical "
        f"({time.perf_counter() - t0:.1f} s)")
    out["mala"] = phase13_mala(torch, np, dev, card, out)
    out["hmc"] = phase13_hmc(torch, np, dev, card, out)
    out["chees"] = phase13_chees(torch, np, dev, card, out)
    out["ensemble"] = phase13_ensemble(torch, np, dev, card, out)
    log(f"phase 13: kernel wrapper launches of each path, counted from 0 "
        f"(recordings and eager runs): {out['launches']}")
    return out, phase13_rows(torch, dev, out, card)


def replay_counts(counted, profiled, n):
    """The log's words for :func:`counted_replays`' two counts."""
    same = "the same" if profiled == counted else f"{profiled}"
    return (f"launches in {n} replayed proposals of the path's own sampler "
            f"{counted} (device counters; the profiler: {same})")


def phase13_mala(torch, np, dev, card, out):
    """(a) ``bench.py:260-303``: 1e5 walkers x 5-D unit Gaussian,
    ``MALAMove(1.0)`` into ``DeviceBackend``; a warm run of 500 kept x
    ``thin_by=2`` (tau from its first 120 kept), two timed runs, a
    profiled window and a counted one."""
    from emcee_tpu_torch import moves
    from emcee_tpu_torch.backends import DeviceBackend

    per_proposal = {"langevin_step": 1, "langevin_factor": 1,
                    "accept_select": 1}
    p0 = np.random.default_rng(10).normal(size=(NW, ND)).astype(np.float32)
    acc64 = graph_vs_plain_chain(torch, lambda: grad_sampler(
        dev, moves.MALAMove(1.0), 2), p0)
    smp = grad_sampler(dev, moves.MALAMove(1.0), 2, backend=DeviceBackend())
    kept, thin = 500, 2
    with path_launches(out, "mala", tuple(per_proposal), "phase 13"):
        t0 = time.perf_counter()
        st, _ = drive(smp, p0, kept, thin_by=thin,
                      skip_initial_state_check=True)
        warm_s = time.perf_counter() - t0
        tau = tau_of(np, smp.backend.chain[:120], thin)
        warm_graphs(smp)
        st, dt = stage_runs(smp, st, kept, thin)
        rate = kept * thin * NW / dt
        acc = float(smp.last_run_stats.acceptance_fraction.mean())
        mean_lp = float(st.log_prob.mean())
        if not (-3.5 < mean_lp < -1.5 and np.isfinite(tau)):  # bench.py:161
            raise AssertionError(f"phase 13: MALA stage: mean lp "
                                 f"{mean_lp}, tau {tau}")
        n_prof = 32
        win = busy_window(torch, lambda: drive(smp, None, n_prof,
                                               store=False),
                          n_prof, "MALA stage", names=per_proposal)
        n_kept = 16
        n_cnt = n_kept * thin
        counted, profiled = counted_replays(
            torch, dev, smp, n_kept,
            lambda r: {k: v * n_cnt for k, v in per_proposal.items()}
            | {"philox_draw": 0},  # K11 draws the normals
            "MALA stage", thin_by=thin)
    smp._use_graphs = False
    _, dt_eager = drive(smp, None, 16, store=False,
                        per_proposal=per_proposal)
    smp._use_graphs = True
    res = dict(walker_steps_per_s=rate, tau=tau, ess_per_s=rate / tau,
               acceptance=acc, mean_lp=mean_lp, seconds=dt,
               warm_seconds=warm_s, acceptance_64=acc64,
               eager_ms_per_proposal=dt_eager / 16 * 1e3,
               replayed_launches=counted, profiled_replayed=profiled,
               proposals_counted=n_cnt, **win)
    log(f"phase 13: (a) MALA stage (bench.py:260-303; 1e5 x 5-D, "
        f"MALAMove(1.0), DeviceBackend, {kept} kept x {thin}): {rate:.4e} "
        f"walker-steps/s (best of two), tau {tau:.3f} proposals, ESS/s "
        f"{rate / tau:.4e}, acceptance {acc:.4f}, mean lp {mean_lp:.4f} "
        f"{card}; device {measured(win['device_us_per_proposal'])} us and "
        f"{measured(win['kernels_per_proposal'], '.0f')} kernels a "
        f"proposal, idle {measured(win['idle'], '.4f')}; the gradient (the "
        f"log-prob's forward and backward) and the move's small torch ops "
        f"{measured(win['other_us_per_proposal'])} us a proposal, share "
        f"{measured(win['other_share'], '.3f')}; "
        f"{replay_counts(counted, profiled, n_cnt)}"
        f"; eager {res['eager_ms_per_proposal']:.3f} ms a proposal; graph "
        f"chain == plain eager chain (64 proposals, acceptance "
        f"{acc64:.4f})")
    return res


def phase13_hmc(torch, np, dev, card, out, n=64, n_leapfrog=10):
    """(b) ``HMCMove(0.5, n_leapfrog=10, jitter=0.2)`` at 1e5 x 5-D, ``n``
    proposals a run; then the same move without jitter (K11 draws the
    jitter beside the momenta, so the two should cost the same)."""
    from emcee_tpu_torch import moves

    def mv(jitter=0.2):
        return moves.HMCMove(0.5, n_leapfrog=n_leapfrog, jitter=jitter)

    per_proposal = {"langevin_step": 1, "langevin_factor": 1,
                    "leapfrog": n_leapfrog + 1, "accept_select": 1}
    p0 = np.random.default_rng(11).normal(size=(NW, ND)).astype(np.float32)
    acc64 = graph_vs_plain_chain(torch, lambda: grad_sampler(dev, mv(), 3),
                                 p0, n=n)
    smp = grad_sampler(dev, mv(), 3)
    n_prof = 8
    with path_launches(out, "hmc", GRAD_KERNELS, "phase 13"):
        st, _ = drive(smp, p0, n, store=False, skip_initial_state_check=True)
        smp._program.graph(0, n_prof, False)
        dts = []
        for _ in range(2):
            st, dt = drive(smp, None, n, store=False)
            dts.append(dt)
        rate = n * NW / min(dts)
        acc = float(smp.last_run_stats.acceptance_fraction.mean())
        mean_lp = float(st.log_prob.mean())
        if not (-3.5 < mean_lp < -1.5 and acc > 0.5):
            raise AssertionError(f"phase 13: HMC: mean lp {mean_lp}, "
                                 f"acceptance {acc}")
        win = busy_window(torch, lambda: drive(smp, None, n_prof,
                                               store=False),
                          n_prof, "HMC", names=per_proposal)
        n_cnt = 16
        counted, profiled = counted_replays(
            torch, dev, smp, n_cnt,
            lambda r: {k: v * n_cnt for k, v in per_proposal.items()}
            | {"philox_draw": 0},  # K11 draws the normals
            "HMC", store=False)
    smp0 = grad_sampler(dev, mv(0.0), 3)
    drive(smp0, p0, n_prof, store=False, skip_initial_state_check=True)
    win0 = busy_window(torch, lambda: drive(smp0, None, n_prof,
                                            store=False),
                       n_prof, "HMC, jitter 0", names=per_proposal)
    n_grad = n_leapfrog + 1
    per_grad, per_grad0 = (
        None if w["other_us_per_proposal"] is None
        else w["other_us_per_proposal"] / n_grad for w in (win, win0))
    res = dict(walker_steps_per_s=rate, acceptance=acc, mean_lp=mean_lp,
               acceptance_64=acc64, us_per_gradient=per_grad,
               us_per_gradient_without_jitter=per_grad0,
               device_us_per_proposal_jitter0=win0["device_us_per_proposal"],
               kernels_per_proposal_jitter0=win0["kernels_per_proposal"],
               replayed_launches=counted, profiled_replayed=profiled,
               proposals_counted=n_cnt, **win)
    log(f"phase 13: (b) HMCMove(0.5, n_leapfrog={n_leapfrog}, jitter=0.2), "
        f"1e5 x 5-D, {n} proposals a run: {rate:.4e} walker-steps/s (best "
        f"of two), acceptance {acc:.4f}, mean lp {mean_lp:.4f} {card}; "
        f"device {measured(win['device_us_per_proposal'])} us and "
        f"{measured(win['kernels_per_proposal'], '.0f')} kernels a proposal, "
        f"{measured(per_grad)} us a gradient evaluation ({n_grad} a proposal, "
        f"with the move's small torch ops); jitter 0: "
        f"{measured(win0['device_us_per_proposal'])} us and "
        f"{measured(win0['kernels_per_proposal'], '.0f')} kernels a proposal, "
        f"{measured(per_grad0)} us a gradient evaluation; "
        f"{replay_counts(counted, profiled, n_cnt)}; graph chain == plain "
        f"eager chain ({n} proposals, acceptance {acc64:.4f})")
    return res


def phase13_chees(torch, np, dev, card, out, n=200):
    """(c) ``ChEESHMCMove(0.5)`` at 1e5 x 5-D: ``n`` tuning proposals,
    then ``n`` production proposals by replays against the same ``n``
    run eagerly from the same state and carry."""
    from emcee_tpu_torch import moves
    from emcee_tpu_torch.chunk_graph import ChunkProgram, clone_carry

    p0 = np.random.default_rng(12).normal(size=(NW, ND)).astype(np.float32)
    smp = grad_sampler(dev, moves.ChEESHMCMove(0.5), 4)
    log_t0 = float(smp._moves[0].init_carry(NW, ND)["log_T"])

    def run(s, state, tune):
        r0, f0 = ChunkProgram.replays, ChunkProgram.flag_reads
        st, dt = drive(s, state, n, store=False, tune=tune,
                       skip_initial_state_check=True)
        return st, dt, (ChunkProgram.replays - r0) / n, (
            ChunkProgram.flag_reads - f0) / n

    with path_launches(out, "chees", CHEES_KERNELS + ("chees_gradient",),
                       "phase 13"):
        st, dt_tune, rep_tune, reads_tune = run(smp, p0, True)
        carry = smp._move_carries[0]
        log_t1 = float(carry["log_T"])
        eps1 = 0.5 * math.exp(float(carry["log_adj"]))
        # Two production proposals record the production segments, so the
        # compared runs record nothing.
        st = smp.run_mcmc(st, 2, store=False, skip_initial_state_check=True)
        twin = grad_sampler(dev, moves.ChEESHMCMove(0.5), 4)
        twin._move_carries = tuple(clone_carry(c)
                                   for c in smp._move_carries)
        twin._use_graphs = False
        st_g, dt, rep, reads = run(smp, st, False)
        acc = float(smp.last_run_stats.acceptance_fraction.mean())
        t0 = time.perf_counter()
        st_e = twin.run_mcmc(st, n, store=False,
                             skip_initial_state_check=True)
        dt_eager = time.perf_counter() - t0
        if not (torch.equal(st_g.coords, st_e.coords)
                and torch.equal(st_g.log_prob, st_e.log_prob)
                and st_g.random_state == st_e.random_state):
            raise AssertionError("phase 13: ChEES production replays "
                                 "differ from the eager chain")
        mean_lp = float(st_g.log_prob.mean())
        if not (-3.5 < mean_lp < -1.5 and reads == 1.0
                and log_t1 != log_t0):
            raise AssertionError(f"phase 13: ChEES: mean lp {mean_lp}, "
                                 f"flag reads {reads} a proposal, log T "
                                 f"{log_t1}")
        # A proposal replays start, (trips - 1) steps, end and the tune /
        # advance segment.
        trips, trips_tune = rep - 2, rep_tune - 2
        n_cnt = 16
        # K13 launches trips + 1 times a proposal, which replays trips + 2
        # graphs (start, trips - 1 steps, end, tune / advance); K21a once
        # a proposal, K21b's two launches a tuning one.
        counted, profiled = counted_replays(
            torch, dev, smp, n_cnt, chees_expect(n_cnt, False, 0), "ChEES",
            store=False)
        # The tuning proposals' window, after the production comparisons
        # (it tunes the carry on).
        grads = k21b_launches(NW)
        tune_per = dict(CHEES_PER, chees_gradient=grads)
        win_t = busy_window(torch, lambda: drive(smp, None, n_cnt,
                                                 store=False, tune=True),
                            n_cnt, "ChEES tuning", names=tune_per)
        counted_t, _ = counted_replays(
            torch, dev, smp, n_cnt, chees_expect(n_cnt, True, grads),
            "ChEES tuning", store=False, tune=True)
    res = dict(log_T_before=log_t0, log_T_after=log_t1, eps_after=eps1,
               trips_per_proposal=trips, trips_per_proposal_tune=trips_tune,
               flag_reads_per_proposal=reads,
               flag_reads_per_proposal_tune=reads_tune,
               walker_steps_per_s=n * NW / dt,
               walker_steps_per_s_tune=n * NW / dt_tune,
               eager_walker_steps_per_s=n * NW / dt_eager, acceptance=acc,
               mean_lp=mean_lp, replayed_launches=counted,
               profiled_replayed=profiled, proposals_counted=n_cnt,
               tune_window=win_t, replayed_launches_tune=counted_t)
    log(f"phase 13: (c) ChEESHMCMove(0.5) at 1e5 x 5-D: log T "
        f"{log_t0:.4f} -> {log_t1:.4f} after {n} tuning proposals (eps "
        f"{eps1:.4f}); trips a proposal {trips_tune:.2f} tuning, "
        f"{trips:.2f} production; flag reads a proposal {reads_tune:.2f} / "
        f"{reads:.2f}; {n * NW / dt_tune:.4e} walker-steps/s tuning, "
        f"{n * NW / dt:.4e} production (replays; its first run records), "
        f"{n * NW / dt_eager:.4e} eager; acceptance {acc:.4f}, mean lp "
        f"{mean_lp:.4f} {card}; production replays == eager chain ({n} "
        f"proposals); {replay_counts(counted, profiled, n_cnt)}; tuning "
        f"window ({n_cnt} replayed proposals): device "
        f"{measured(win_t['device_us_per_proposal'])} us and "
        f"{measured(win_t['kernels_per_proposal'], '.0f')} kernels a "
        f"proposal, idle {measured(win_t['idle'], '.4f')}, us a launch "
        + ", ".join(f"{k} {measured(v and v * 1e3, '.2f')}"
                    for k, v in win_t["ms_per_launch"].items())
        + f"; tuning launches { {k: v for k, v in counted_t.items() if v} } "
        f"(device words)")
    return res


def phase13_ensemble(torch, np, dev, card, out, n=200):
    """(d) ``EnsembleMALAMove()`` and ``EnsembleHMCMove()`` on workload
    3's target (1e4 x 100-D, ``benchmarks/workload3.py:57-77``), ``n``
    proposals a run."""
    from emcee_tpu_torch import moves

    log_prob3, p03 = workload3_target(np, torch, dev)
    res = {}
    for path, name, mv, per_split in (
            ("ensemble_mala", "EnsembleMALAMove()", moves.EnsembleMALAMove,
             {"langevin_step": 2, "langevin_factor": 1, "accept_select": 1}),
            ("ensemble_hmc", "EnsembleHMCMove()", moves.EnsembleHMCMove,
             {"langevin_step": 1, "leapfrog": 11, "langevin_factor": 1,
              "accept_select": 1})):
        def make():
            return grad_sampler(dev, mv(), 5, log_prob3, NW3, ND3)

        acc16 = graph_vs_plain_chain(torch, make, p03, n=16)
        smp = make()
        n_prof = 8
        # K14: the shuffled split's sort keys, one draw a proposal; K16
        # (the long route at 1e4 walkers) and K17 its order and rows.
        shuf = shuffle_per(1, NW3)
        with path_launches(out, path, tuple(per_split) + ("philox_draw",)
                           + SHUFFLE_KERNELS, "phase 13"):
            drive(smp, p03, n, store=False, skip_initial_state_check=True)
            smp._program.graph(0, n_prof, False)
            st, dt = drive(smp, None, n, store=False)
            rate = n * NW3 / dt
            acc = float(smp.last_run_stats.acceptance_fraction.mean())
            mean_lp = float(st.log_prob.mean())
            if not -80.0 < mean_lp < -20.0:  # workload3.py:201
                raise AssertionError(f"phase 13: {name}: mean lp "
                                     f"{mean_lp}")
            win = busy_window(torch, lambda: drive(smp, None, n_prof,
                                                   store=False),
                              n_prof, name, names={
                                  k: 2 * v for k, v in per_split.items()}
                              | {"philox_draw": 1} | shuf)
            counted, profiled = counted_replays(
                torch, dev, smp, n_prof,
                lambda r: {k: 2 * v * n_prof for k, v in per_split.items()}
                | {"philox_draw": n_prof}
                | {k: v * n_prof for k, v in shuf.items()}, name,
                store=False)
        res[name] = dict(walker_steps_per_s=rate, acceptance=acc,
                         mean_lp=mean_lp, acceptance_16=acc16,
                         replayed_launches=counted,
                         profiled_replayed=profiled,
                         proposals_counted=n_prof, **win)
        log(f"phase 13: (d) {name} on workload 3's target (1e4 x 100-D), "
            f"{n} proposals: {rate:.4e} walker-steps/s, acceptance "
            f"{acc:.4f}, mean lp {mean_lp:.3f} {card}; device "
            f"{measured(win['device_us_per_proposal'])} us and "
            f"{measured(win['kernels_per_proposal'], '.0f')} kernels a "
            f"proposal (K11 / "
            f"K13 in full mode: cuBLAS products and cholesky_ex inside the "
            f"graphs); {replay_counts(counted, profiled, n_prof)}; graph "
            f"chain == plain eager chain (16 proposals)")
    return res


def k11_yardsticks(torch, dev, x, g, eps, reps=100):
    """K11's MALA step at ``x``'s shape beside two same-bytes yardsticks
    in one profiled window, each ``reps`` times in turns: the copies
    ``q.copy_(x)``, ``z.copy_(g)`` (x and g read, q and z written: K11's
    bytes; torch hands a contiguous copy to the copy engine) and the
    elementwise ``torch.mul(x, 1.0, out=q)``, ``torch.mul(g, 1.0,
    out=z)`` (the same bytes through the SMs).  Returns device us a
    launch of K11 and a pair of each yardstick."""
    from emcee_tpu_torch.ops import langevin_kernel as lk

    n, nd = x.shape
    q, z = torch.empty_like(x), torch.empty_like(x)

    def turn():
        lk.langevin_step((n, nd), dev, seed=1, offset=2, x=x, g=g, eps=eps)
        q.copy_(x)
        z.copy_(g)
        torch.mul(x, 1.0, out=q)
        torch.mul(g, 1.0, out=z)

    turn()
    _, kernels = profile_window(torch, lambda: [turn() for _ in range(reps)])
    got = {"k11": [0, 0.0], "copy": [0, 0.0], "mul": [0, 0.0]}
    for name, (c, t) in kernels.items():
        key = ("k11" if "langevin_step_kernel" in name
               else "copy" if "Memcpy" in name or "copy" in name.lower()
               else "mul" if "elementwise" in name else None)
        if key:
            got[key][0] += c
            got[key][1] += t
    # A pair of each yardstick moves K11's bytes; the profiler's own
    # count of each, since it may drop an event.
    return {k: (t / c * (1 if k == "k11" else 2) if c else None)
            for k, (c, t) in got.items()}


def k11_tile_sweep(torch, dev, shapes=((NW, ND), (5000, 100)), reps=100):
    """K11's MALA step (drawn z, no d) at the tiles that make the grid one
    wave at 2-8 blocks an SM, and the plan's, at ``shapes``: eager
    launches profiled, the tiles swept up then down and averaged.
    Returns ``{shape: {tile: (grid, us)}}`` and the plan's tiles."""
    from emcee_tpu_torch.ops import langevin_kernel as lk
    from emcee_tpu_torch.ops._wrap import device_sm_count

    n_sm = device_sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    eps = torch.tensor(0.7, device=dev)
    got, plans = {}, {}
    for n, nd in shapes:
        x, g = (torch.randn(n, nd, device=dev, generator=gen)
                for _ in range(2))
        z, q = torch.empty_like(x), torch.empty_like(x)
        plans[(n, nd)] = lk.langevin_plan(n, n_sm).tile
        tiles = sorted({-(-n // (n_sm * b)) for b in range(2, 9)}
                       | {plans[(n, nd)]})
        res = {}
        for tile in tiles + tiles[::-1]:
            plan = lk.LangevinPlan(tile, -(-n // tile))
            fn = lambda: lk._launch(plan, dev, x, g, None, eps, None, z, q,
                                    None, 0, n, nd, 0, 1, 2)
            res.setdefault(tile, []).append(profiled_ms(
                torch, lambda: [fn() for _ in range(reps)],
                "langevin_step") * 1e3)
        got[(n, nd)] = {t: (-(-n // t), sum(v) / len(v))
                        for t, v in res.items()}
    return got, plans


def phase13_rows(torch, dev, out, card):
    """The K11-K13 rows of the kernel table at the MALA stage's shape (1e5
    x 5): device time a launch inside the replays (profiler: K11 and K12
    in the MALA stage, K13 in the HMC path, its three modes averaged),
    time a back-to-back call and the plain version's (CUDA events), and
    the least time the card could take."""
    from emcee_tpu_torch.ops import langevin_kernel as lk

    gen = torch.Generator(device=dev).manual_seed(14)
    x, g, gq, p = (torch.randn(NW, ND, device=dev, generator=gen)
                   for _ in range(4))
    eps = torch.tensor(0.7, device=dev)
    calls = {
        "langevin_step": (
            lambda: lk.langevin_step((NW, ND), dev, seed=1, offset=2, x=x,
                                     g=g, eps=eps),
            lambda: lk.langevin_step_plain((NW, ND), dev, seed=1, offset=2,
                                           x=x, g=g, eps=eps)),
        "langevin_factor": (
            lambda: lk.langevin_factor(p, g, gq, eps=eps),
            lambda: lk.langevin_factor_plain(p, g, gq, eps=eps)),
        "leapfrog": (
            lambda: lk.leapfrog(p, g, eps, kicks=2, x=x),
            lambda: lk.leapfrog_plain(p, g, eps, kicks=2, x=x)),
    }
    elems = NW * ND
    # Each input read once, each output written once; float32 words.
    work = {
        # x, g in; z, q out (K11's operations: instructions, below)
        "langevin_step": (4 * 4 * elems, 0),
        # z, g_x, g_q in; the factors out; ~9 operations an element
        "langevin_factor": (4 * (3 * elems + NW), 9 * elems),
        # x, p, g in; x, p out (two kicks and the drift); 5 operations
        "leapfrog": (4 * 5 * elems, 5 * elems),
    }
    meta = {
        "langevin_step": ("emcee_tpu_torch/csrc/langevin_step.cu",
                          "emcee_tpu/moves/gradient.py:218", "mala"),
        "langevin_factor": ("emcee_tpu_torch/csrc/langevin_factor.cu",
                            "emcee_tpu/moves/gradient.py:233", "mala"),
        "leapfrog": ("emcee_tpu_torch/csrc/leapfrog.cu",
                     "emcee_tpu/moves/gradient.py:314", "hmc"),
    }
    # K11's two modes side by side, eager launches profiled: the draw
    # alone (HMC's momenta: 2 MB out) and the MALA step (8 MB).
    k11_modes = {mode: profiled_ms(torch, lambda: [fn() for _ in range(100)],
                                   "langevin_step")
                 for mode, fn in (("draw", lambda: lk.langevin_step(
                     (NW, ND), dev, seed=1, offset=2)),
                     ("mala", calls["langevin_step"][0]))}
    log(f"phase 13: langevin_step, eager launches profiled: draw only "
        f"{k11_modes['draw'] * 1e3:.2f} us, MALA step "
        f"{k11_modes['mala'] * 1e3:.2f} us a launch {card}")
    # K11's instructions: what the MALA step needs, a Philox block an item
    # (a row's column pair) and for each stored normal its Box-Muller and
    # the step's two multiply-adds.
    from emcee_tpu_torch.ops._wrap import device_sm_count

    label = "langevin_step_kernel<true, true, false, false>"
    items = NW * ((ND + 1) // 2)
    n_ins = items * PHILOX_INSTR + NW * ND * (NORMAL_INSTR + 2)
    n_sfu = NW * ND * NORMAL_SFU
    k11_plan = lk.langevin_plan(NW, device_sm_count(dev))
    regs = PTXAS.get(label)
    waves = (k11_plan.grid / (device_sm_count(dev) * resident_blocks(
        regs[0], lk.LANGEVIN_THREADS)) if regs else None)
    yard = k11_yardsticks(torch, dev, x, g, eps)
    sweep, sweep_plans = k11_tile_sweep(torch, dev)
    log(f"phase 13: langevin_step {label}: {n_ins} instructions needed "
        f"({n_sfu} special-function results), {items} items; {regs} "
        f"(registers, static shared, spilled); plan {tuple(k11_plan)} "
        f"(tile, grid), {measured(waves, '.3f')} waves; in one window: K11 "
        f"{measured(yard['k11'], '.3f')} us, the same bytes copied "
        f"(q.copy_(x), z.copy_(g)) {measured(yard['copy'], '.3f')} us, "
        f"multiplied by 1 on the SMs {measured(yard['mul'], '.3f')} us "
        f"{card}")
    for shape, res in sweep.items():
        log(f"phase 13: langevin_step MALA tile sweep at {shape} (plan's "
            f"tile {sweep_plans[shape]}): " + ", ".join(
                f"{t} rows x {gr} blocks {us:.3f} us"
                for t, (gr, us) in sorted(res.items())) + f" {card}")
    rows = []
    for kname, (kernel, plain) in calls.items():
        src, jax_src, path = meta[kname]
        call_ms = cuda_ms(torch, kernel)
        plain_ms = cuda_ms(torch, plain, reps=20)
        nbytes, nops = work[kname]
        t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3}
        if kname != "langevin_step":
            t["operations"] = nops / F32_OPS_PER_S * 1e3
        else:
            t["operations"] = instruction_bound(n_ins, n_sfu)
        by = max(t, key=t.get)
        ms = out[path]["ms_per_launch"][kname]
        n_cnt = out[path]["proposals_counted"]
        launches = out[path]["replayed_launches"][kname]
        row = {"name": kname, "route": "cuda", "source": src,
               "replaces": jax_src, "launches": launches,
               "max_abs_err": 0.0, "ms": ms, "call_ms": call_ms,
               "plain_ms": plain_ms, "bound_ms": t[by], "bound_by": by,
               "library_ms": None,
               "launches_per_proposal": launches / n_cnt,
               "wrapper_launches": out["launches"][path][kname],
               "note": f"{kname}: launches are counted on the card in "
                       f"{n_cnt} replayed proposals of the {path} path's "
                       "own sampler (each launch adds to a device word "
                       "recorded beside it); wrapper_launches: the host "
                       "count over the path (recordings and eager runs); "
                       "max_abs_err: torch.equal over the edge sweep; "
                       "library_ms: none, no single PyTorch call computes "
                       "it"}
        if kname == "langevin_step":
            row.update(
                ms_draw_only_eager=k11_modes["draw"],
                ms_mala_eager=k11_modes["mala"],
                bound_bytes_ms=t["bytes"],
                bound_instructions_ms=t["operations"],
                instructions_needed=n_ins, items=items,
                plan=tuple(k11_plan), ptxas=regs, waves=waves,
                yardstick_us=yard,
                tile_sweep_us={f"{n}x{nd}": {t_: us for t_, (_, us)
                                             in res.items()}
                               for (n, nd), res in sweep.items()})
            row["note"] += (
                "; bound: the larger of the bytes at 3.35 TB/s and the "
                "instructions the function needs (a Philox block an item, "
                "a Box-Muller normal and two multiply-adds an element) at "
                "the issue rate, their special functions at theirs; "
                "yardstick_us: K11 beside the same bytes "
                "copied (copy engine) and multiplied by 1 (SMs) in one "
                "window, the card's practical byte floor")
        rows.append(row)
        log(f"phase 13: {kname}: device {ms * 1e3:.2f} us/launch in the "
            f"{path} replays, {call_ms * 1e3:.2f} us per back-to-back call, "
            f"plain {plain_ms * 1e3:.2f} us, bound {t[by] * 1e3:.3f} us "
            f"({nbytes} bytes, {by}) {card}")
    return rows


# -- 14. parallel tempering --------------------------------------------------
#: workload 4 (benchmarks/workloads5.py:196-262 pt_multimodal): 16 rungs x
#: 256 walkers x 5-D, two unit modes 8 sigma apart, a box prior
NT4, NW4, ND4 = 16, 256, 5
#: the modes' centres, +-PT_SEP in every coordinate
PT_SEP = 4.0
#: phase 14's sweep of K1 and K2 with the rung axis: rungs, walkers (by
#: nsplits) and ndims
PT_SWEEP_T = (1, 2, 3, 16)
PT_SWEEP_NW = {2: (8, 256, 1000), 3: (6, 258, 999)}
PT_SWEEP_ND = (1, 5, 8, 9)
#: K2's rung-axis launches forced beside the wrapper's plan (phases 14 and
#: 15): (threads, q rows through registers where ndim allows, leaves
#: through registers where the leaf plan allows)
K2_RUNG_PLANS = ((32, 0, 0), (64, 1, 1), (128, 1, 0), (512, 0, 1))
#: rungs of K15's sweep
SWAP_SWEEP_T = (2, 3, 5, 16)
#: ndims of K15's sweep: rows through registers (up to SWAP_ROW_REGS) and
#: past them
SWAP_SWEEP_ND = (1, 5, 9)
#: K15's block sizes swept beside the wrapper's plan
SWAP_SWEEP_THREADS = (32, 64, 128)


def pt_log_like(x):
    """``pt_multimodal``'s log likelihood of one walker (the torch twin of
    ``benchmarks/workloads5.py:205-208``)."""
    import torch

    a = -0.5 * torch.sum((x - PT_SEP) ** 2)
    b = -0.5 * torch.sum((x + PT_SEP) ** 2)
    return torch.logaddexp(a, b + math.log(0.5))


def pt_log_prior(x):
    """``pt_multimodal``'s box prior of one walker (``:210-211``)."""
    import torch

    return torch.where(torch.all(torch.abs(x) < 50.0), 0.0, -torch.inf)


def same_bits(got, want, what):
    """Raise unless every tensor of ``got`` equals its ``want`` bit for bit
    (``torch.equal`` of the bits, so NaNs compare too)."""
    import torch

    def bits(t):
        if t.dtype == torch.float32:
            return t.view(torch.int32)
        if t.dtype == torch.float64:
            return t.view(torch.int64)
        return t

    if not all(bits(a).equal(bits(b)) for a, b in zip(got, want)):
        raise AssertionError(f"{what}: kernel and plain version differ")


def pt_sampler(dev, seed=4, backend=None, move=None, nt=NT4, nw=NW4,
               nd=ND4):
    """Workload 4's sampler: ``pt_multimodal``'s configuration (default
    ladder, ``StretchMove()``, ``swap_every=1``) on ``dev``."""
    from emcee_tpu_torch import PTSampler

    return PTSampler(nt, nw, nd, pt_log_like, pt_log_prior, seed=seed,
                     backend=backend, moves=move, device=dev)


def pt_p0(np, nt=NT4, nw=NW4, nd=ND4):
    """``pt_multimodal``'s start (``:218-220``): unit normals about a
    random mode per walker."""
    rng = np.random.default_rng(5)
    p0 = rng.normal(size=(nt, nw, nd)).astype(np.float32)
    p0 += PT_SEP * rng.choice([-1.0, 1.0], size=(nt, nw, 1))
    return p0.astype(np.float32)


def rung_kernel_sweep(torch, dev):
    """(a) K1 and K2 with the rung axis against their plain versions, bit
    for bit: rungs ``PT_SWEEP_T``, walkers ``PT_SWEEP_NW`` (nsplits 2 and
    3), ndim ``PT_SWEEP_ND``, both pair modes, scale unset and per rung,
    injected draws and the in-kernel stream (host offset; the device
    offset word at 16 rungs), K2 with the two scalar leaves ``logL`` and
    ``logP`` and NaN and +-inf in ``lp_q``; at one rung, each launch
    against today's launch on the same 2-D inputs.  Returns the count of
    comparisons."""
    from emcee_tpu_torch.ops import accept_kernel as ak
    from emcee_tpu_torch.ops import stretch_kernel as sk
    from emcee_tpu_torch.ops.philox import DeviceOffset, rung_keys

    gen = torch.Generator(device=dev).manual_seed(140)
    word = torch.tensor(74, dtype=torch.int64, device=dev)
    n = 0
    for T in PT_SWEEP_T:
        for nsplits, nws in PT_SWEEP_NW.items():
            for nw in nws:
                for nd in PT_SWEEP_ND:
                    coords = torch.randn(T, nw, nd, device=dev,
                                         generator=gen)
                    ng = nw // nsplits
                    keys = rung_keys(1000 + 7 * T + nw, T, dev)
                    split = (nw + nd) % nsplits
                    for pair_mode in ("roll", "random"):
                        u = torch.rand(T, 2 * ng, device=dev, generator=gen)
                        inj = dict(u_z=u[:, :ng].contiguous())
                        if pair_mode == "roll":
                            inj["u_shift"] = u[:, ng].contiguous()
                        else:
                            inj["u_pair"] = u[:, ng:].contiguous()
                        draws = [dict(seed=keys, **inj),
                                 dict(seed=keys, offset=77)]
                        if T == 16:
                            draws.append(dict(seed=keys, offset=DeviceOffset(
                                word, 3)))
                        for j, kw in enumerate(draws):
                            scale = (None if (j + nd) % 2 else 0.5 + torch.rand(
                                T, device=dev, generator=gen))
                            k1 = dict(a=2.0, ndim_global=nd,
                                      pair_mode=pair_mode, scale=scale, **kw)
                            got = sk.stretch_propose(coords, split, nsplits,
                                                     **k1)
                            want = sk.stretch_propose_plain(
                                coords, split, nsplits, **k1)
                            same_bits(got, want, f"K1 rungs T={T} nw={nw} "
                                      f"nd={nd} {pair_mode} {j}")
                            n += 1
                            if T == 1:
                                flat = dict(k1, seed=keys.seed,
                                            scale=None if scale is None
                                            else scale[0])
                                for key in ("u_z", "u_pair", "u_shift"):
                                    if key in flat:
                                        flat[key] = flat[key][0]
                                one = sk.stretch_propose(coords[0], split,
                                                         nsplits, **flat)
                                same_bits((got[0][0], got[1][0]), one,
                                          f"K1 one rung nw={nw} nd={nd}")
                                n += 1
                            n += k2_rung_check(torch, dev, gen, coords,
                                               want, split, nsplits, kw, T)
    return n


def k2_rung_launches(plans=K2_RUNG_PLANS):
    """The K2 rung-axis launches a sweep holds against the plain version:
    the wrapper, and the rung kernel at each of ``plans`` through
    ``accept_kernel._launch_rungs`` (a forced plan's leaves go all after
    the decision unless its third field lets the leaf plan's register
    leaves through)."""
    from emcee_tpu_torch.ops import accept_kernel as ak
    from emcee_tpu_torch.ops._wrap import RUNG_ROW_REGS, rung_plan

    def forced(threads, reg_row, reg_leaves):
        def run(q, f, lp_q, c, l, split, nsplits, acc, cnt=None, *, seed,
                offset=0, log_u=None, blobs=()):
            T, nw, nd = c.shape
            ng = q.shape[1]
            leaves, n_reg = ak.leaf_plan(ak.blob_leaves(
                blobs, ng, nw, c.device, (T,)), rungs=True)
            plan = rung_plan(ng, nd)._replace(
                threads=threads, reg_row=int(reg_row and nd <= RUNG_ROW_REGS))
            ak._launch_rungs(plan, q, f, lp_q, c, l, split, acc, cnt, seed,
                             offset, log_u, leaves, n_reg if reg_leaves else 0)
        return run

    return [ak.accept_select] + [forced(*p) for p in plans]


def k2_rung_check(torch, dev, gen, coords, proposal, split, nsplits, kw, T):
    """K2 with the rung axis on one proposal against its plain version
    (and, at one rung, today's launch), with and without injected
    ``log_u``, the ``logL`` / ``logP`` leaves riding the register path, by
    the wrapper and by the forced plans of :func:`k2_rung_launches`;
    returns the comparisons made."""
    from emcee_tpu_torch.ops import accept_kernel as ak

    q, f = proposal
    nw, ng = coords.shape[1], q.shape[1]
    lp = -0.5 * (coords ** 2).sum(-1)
    lp_q = -0.5 * (q ** 2).sum(-1)
    lp_q.view(-1)[::7] = float("nan")
    lp_q.view(-1)[3::11] = float("inf")
    lp_q.view(-1)[5::13] = -float("inf")
    new = (torch.randn(T, ng, device=dev, generator=gen),
           torch.randn(T, ng, device=dev, generator=gen))
    bufs = (torch.randn(T, nw, device=dev, generator=gen),
            torch.randn(T, nw, device=dev, generator=gen))
    seed = kw["seed"]
    variants = [dict(log_u=torch.log(torch.rand(T, ng, device=dev,
                                                generator=gen)))]
    if "offset" in kw:
        variants.append(dict(offset=kw["offset"]))
    n = 0

    def run(fn, v):
        c, l = coords.clone(), lp.clone()
        acc = torch.zeros(T, nw, dtype=torch.bool, device=dev)
        cnt = torch.ones(T, nw, dtype=torch.int32, device=dev)
        b = [x.clone() for x in bufs]
        fn(q, f, lp_q, c, l, split, nsplits, acc, cnt, seed=seed,
           blobs=list(zip(new, b)), **v)
        return (c, l, acc, cnt, *b)

    for v in variants:
        want = run(ak.accept_select_plain, v)
        for i, fn in enumerate(k2_rung_launches()):
            outs = [run(fn, v), want]
            same_bits(*outs, f"K2 rungs T={T} nw={nw} {sorted(v)} launch "
                      f"{i}")
            n += 1
        if T == 1:
            c, l = coords[0].clone(), lp[0].clone()
            acc = torch.zeros(nw, dtype=torch.bool, device=dev)
            cnt = torch.ones(nw, dtype=torch.int32, device=dev)
            b = [x[0].clone() for x in bufs]
            one = {k: (x[0] if k == "log_u" else x) for k, x in v.items()}
            ak.accept_select(q[0], f[0], lp_q[0], c, l, split, nsplits, acc,
                             cnt, seed=seed.seed,
                             blobs=[(x[0], y) for x, y in zip(new, b)],
                             **one)
            same_bits([t[0] for t in outs[0]], (c, l, acc, cnt, *b),
                      f"K2 one rung nw={nw}")
            n += 1
    if T > 1:
        # An 8-byte scalar leaf: two 4-byte units through registers.
        outs = []
        for fn in (ak.accept_select, ak.accept_select_plain):
            c, l, b = coords.clone(), lp.clone(), bufs[0].double()
            acc = torch.zeros(T, nw, dtype=torch.bool, device=dev)
            fn(q, f, lp_q, c, l, split, nsplits, acc, seed=seed,
               blobs=[(new[0].double(), b)], **variants[-1])
            outs.append((c, l, acc, b))
        same_bits(*outs, f"K2 rungs T={T} nw={nw} an 8-byte leaf")
        n += 1
    return n


def swap_launches(plans=SWAP_SWEEP_THREADS):
    """The K15 launches a sweep holds against the plain version: the
    wrapper, and the kernel at blocks of each of ``plans`` threads (the
    wrapper's leaf plan kept), through ``swap_kernel._launch``."""
    from emcee_tpu_torch.ops import swap_kernel as swk

    def forced(threads):
        def run(coords, ll, lpr, lp, betas, cnt, *, seed, offset,
                swap_every, u=None, leaves=()):
            T, nw, _ = coords.shape
            plan, table = swk.swap_plan(nw, T, 1, swk.swap_leaves(
                leaves, T, nw, coords.device))
            plan = plan._replace(threads=threads)
            if swap_every >= 1 and T >= 2:
                swk._launch(plan, coords, ll, lpr, lp, betas, cnt, seed,
                            offset, swap_every, u, table)
        return run

    return [swk.pt_swap] + [forced(t) for t in plans]


def swap_kernel_sweep(torch, np, dev):
    """(a) K15 against its plain version, bit for bit: rungs
    ``SWAP_SWEEP_T``, 256 and 1000 walkers, ndim ``SWAP_SWEEP_ND`` (rows
    in registers and, past ``SWAP_ROW_REGS``, after the decision), steps
    0-5 (both parities, and at ``swap_every=3`` the steps that do not
    swap), injected ``u``, the in-kernel stream at a host offset and at
    the device offset word, with NaN and +-inf ``logL`` and -inf and NaN
    ``logP``; the wrapper's launch and blocks of ``SWAP_SWEEP_THREADS``
    (:func:`swap_launches`).  Returns the count of comparisons."""
    from emcee_tpu_torch.ops import swap_kernel as swk
    from emcee_tpu_torch.ops.philox import DeviceOffset
    from emcee_tpu_torch.parallel import default_beta_ladder

    gen = torch.Generator(device=dev).manual_seed(150)
    n = 0
    for T in SWAP_SWEEP_T:
        for nw in (256, 1000):
            for nd in SWAP_SWEEP_ND:
                coords = torch.randn(T, nw, nd, device=dev, generator=gen)
                ll = 4.0 * torch.randn(T, nw, device=dev, generator=gen)
                ll[:, ::7] = float("nan")
                ll[:, 1::11] = float("inf")
                ll[:, 2::13] = -float("inf")
                lpr = torch.zeros(T, nw, device=dev)
                lpr[:, 3::5] = -float("inf")
                lpr[:, 4::17] = float("nan")
                betas = torch.tensor(default_beta_ladder(T, nd),
                                     dtype=torch.float32, device=dev)
                lp = swk.tempered_log_prob(betas[:, None], ll, lpr)
                for swap_every in (1, 3):
                    for step in range(6):
                        pairs = swk.swap_pairs(step, T, swap_every)
                        word = torch.tensor(step - 2, dtype=torch.int64,
                                            device=dev)
                        for mode, kw in (
                                ("injected", dict(offset=step, u=torch.rand(
                                    len(pairs), nw, device=dev,
                                    generator=gen))),
                                ("host", dict(offset=step)),
                                ("device", dict(offset=DeviceOffset(
                                    word, 2)))):
                            outs = {}
                            for i, fn in enumerate(swap_launches()
                                                   + [swk.pt_swap_plain]):
                                bufs = [x.clone()
                                        for x in (coords, ll, lpr, lp)]
                                cnt = torch.zeros(T - 1, dtype=torch.int64,
                                                  device=dev)
                                fn(*bufs, betas, cnt, seed=99 + T,
                                   swap_every=swap_every, **kw)
                                outs[i] = (*bufs, cnt)
                            want = outs.pop(len(outs) - 1)
                            for i, got in outs.items():
                                same_bits(got, want, f"K15 T={T} nw={nw} "
                                          f"nd={nd} step={step} swap_every="
                                          f"{swap_every} {mode} launch {i}")
                                n += 1
    return n


def pt_chain_end(smp):
    """What a tempered run leaves: the stored rows, counts and anchors."""
    return (smp.get_chain(), smp.get_log_like(), smp.get_log_prior(),
            smp.backend.accepted, smp.swaps_accepted, smp.swaps_proposed,
            smp._previous_state.coords.cpu().numpy(),
            smp._previous_state.log_like.cpu().numpy(),
            np_of(smp._previous_state.random_state))


def np_of(x):
    import numpy as np

    return np.asarray(x)


def pt_runs(smp, p0):
    """64 tempered proposals in three runs whose lengths and starts vary
    the parity a replay starts at: 7 kept x ``thin_by=3`` stored (graphs
    of 2 and 1 at even and odd offsets), 32 unstored from offset 21 (one
    graph of 32 at an odd start), 11 kept stored."""
    smp.run_mcmc(p0, 7, thin_by=3, skip_initial_state_check=True)
    smp.run_mcmc(None, 32, store=False)
    smp.run_mcmc(None, 11)
    return pt_chain_end(smp)


def same_ends(np, a, b, what):
    for x, y in zip(a, b):
        if not np.array_equal(x, y, equal_nan=True):
            raise AssertionError(f"phase 14: {what} differ")


def phase14(torch, np, dev, card):
    """Parallel tempering (see the module docstring, 14): the sweeps, the
    graph chain against the plain eager chain, the batched path against
    the per-rung loop, workload 4 at full size with its launches counted
    from 0 just before it, a profiled window, and the K1 / K2 rung-axis
    and K15 rows.  Returns its numbers and the rows."""
    from emcee_tpu_torch.backends import PTBackend, PTDeviceBackend

    out = {}
    t0 = time.perf_counter()
    out["sweep_k1_k2"] = rung_kernel_sweep(torch, dev)
    out["sweep_k15"] = swap_kernel_sweep(torch, np, dev)
    log(f"phase 14: (a) K1 and K2 with the rung axis against their plain "
        f"versions (rungs {PT_SWEEP_T}, walkers {PT_SWEEP_NW} by nsplits, "
        f"ndim {PT_SWEEP_ND}, both pair modes, injected / host offset / "
        f"device offset draws, one rung against today's launch): "
        f"{out['sweep_k1_k2']} comparisons; K15 (rungs {SWAP_SWEEP_T}, "
        f"steps 0-5, swap_every 1 and 3, NaN and +-inf logL, -inf and NaN "
        f"logP): {out['sweep_k15']} comparisons; all bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")

    # (b) graph replays against the plain versions' eager chain.
    t0 = time.perf_counter()
    p0 = pt_p0(np)
    ends = []
    for plain in (False, True):
        smp = pt_sampler(dev, seed=41)
        smp._use_graphs = not plain
        with plain_kernels() if plain else contextlib.nullcontext():
            ends.append(pt_runs(smp, p0))
    same_ends(np, *ends, "graph-replayed and eager plain chains")
    log(f"phase 14: (b) 64 graph-replayed tempered proposals at {NT4} x "
        f"{NW4} (runs of 21 stored, 32 unstored from an odd offset, 11 "
        f"stored) equal the same run eagerly on the plain versions, bit for "
        f"bit: chain, logL, logP, acceptance, swap counts "
        f"{ends[0][4].tolist()} of {ends[0][5].tolist()}, offset "
        f"({time.perf_counter() - t0:.1f} s)")

    # (c) the rung-batched path against the per-rung loop.
    t0 = time.perf_counter()
    paths = {}
    for batched in (True, False):
        smp = pt_sampler(dev, seed=42)
        smp._batched = batched
        st = smp.run_mcmc(p0, 16, skip_initial_state_check=True)
        paths[batched] = (smp, pt_chain_end(smp), st)
        smp.run_mcmc(None, 16, store=False)  # records the timed graph
    same_ends(np, paths[True][1], paths[False][1],
              "the batched path and the per-rung loop")
    n_c = 16
    times = {True: [], False: []}
    for batched in (True, False, False, True):
        smp = paths[batched][0]
        _, dt = drive(smp, None, n_c, store=False)
        times[batched].append(dt / n_c * 1e6)
    kinds = {}
    for batched in (True, False):
        smp = paths[batched][0]
        win = busy_window(torch, lambda: smp.run_mcmc(None, n_c, store=False),
                          n_c, "batched" if batched else "per-rung loop")
        kinds[batched] = win
    out["batched_vs_loop"] = {
        "batched_us_per_proposal": min(times[True]),
        "loop_us_per_proposal": min(times[False]),
        "batched_kernels_per_proposal": kinds[True]["kernels_per_proposal"],
        "loop_kernels_per_proposal": kinds[False]["kernels_per_proposal"],
        "batched_device_us": kinds[True]["device_us_per_proposal"],
        "loop_device_us": kinds[False]["device_us_per_proposal"]}
    bl = out["batched_vs_loop"]
    log(f"phase 14: (c) the rung-batched path equals the per-rung loop bit "
        f"for bit (16 kept, stored); in turns (batched, loop, loop, "
        f"batched), {n_c}-proposal replays: batched "
        f"{bl['batched_us_per_proposal']:.1f} us a proposal "
        f"({measured(bl['batched_kernels_per_proposal'], '.0f')} kernels, "
        f"device {measured(bl['batched_device_us'])} us), per-rung loop "
        f"{bl['loop_us_per_proposal']:.1f} us "
        f"({measured(bl['loop_kernels_per_proposal'], '.0f')} kernels, "
        f"device {measured(bl['loop_device_us'])} us) {card} "
        f"({time.perf_counter() - t0:.1f} s)")
    del paths

    # (d) workload 4 at full size, counted from 0 just before it.
    t0 = time.perf_counter()
    kept, thin = 512, 4
    names = ("stretch_propose", "accept_select", "pt_swap",
             "philox_draw") + SHUFFLE_KERNELS
    with path_launches(out, "workload 4", names, "phase 14"):
        smp = pt_sampler(dev, backend=PTDeviceBackend())
        st, _ = drive(smp, p0, kept, thin_by=thin,
                      skip_initial_state_check=True)
        warm_graphs(smp)
        dt = float("inf")
        for _ in range(2):  # workloads5.py:224-233: the best of two
            smp.reset()
            st, dt_run = drive(smp, st, kept, thin_by=thin,
                               skip_initial_state_check=True)
            dt = min(dt, dt_run)
        n_prop = kept * thin
        rate = NT4 * NW4 * n_prop / dt
        cold = smp.get_chain(temp=0)
        tau = tau_of(np, cold, thin)
        swap_mean = float(np.mean(smp.tswap_acceptance_fraction))
        x0 = cold[..., 0]
        mode_frac = float(np.mean(x0 > 0))
        mean_abs, spread = float(np.mean(np.abs(x0))), float(np.std(
            np.abs(x0)))
        acc = float(smp.acceptance_fraction[0].mean())
        # The profiled window: exactly 2 K1, 2 K2, 1 K15, 1 K14 (the
        # shuffle's sort keys of every rung), 1 K16 and 2 K17 a proposal,
        # over four replays of the 64-proposal graph (recorded above), so
        # that a run's fixed host work is shared as in the timed runs.
        n_prof = 256
        per = {"stretch_propose": 2, "accept_select": 2, "pt_swap": 1,
               "philox_draw": 1} | SHUF4
        win = busy_window(
            torch, lambda: smp.run_mcmc(None, n_prof, store=False), n_prof,
            "workload 4",
            expect=lambda: {k: v * n_prof for k, v in per.items()},
            names=per)
        n_kept = 16
        counted, profiled = counted_replays(
            torch, dev, smp, n_kept,
            lambda r: {k: v * n_kept * thin for k, v in per.items()},
            "workload 4", thin_by=thin, store=False)
    checks = {
        "swap acceptance mean in (0.4, 0.9)": 0.4 < swap_mean < 0.9,
        "cold mode fraction in (0.25, 0.75)": 0.25 < mode_frac < 0.75,
        "cold mean |x0| within 0.25 of 4": abs(mean_abs - PT_SEP) < 0.25,
        "cold spread of |x0| within 0.2 of 1": abs(spread - 1.0) < 0.2,
        "tau finite": bool(np.isfinite(tau)),
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 14: workload 4 checks {checks}")
    # PTDeviceBackend against PTBackend from the same seed and start.
    chains = []
    for backend in (PTDeviceBackend(), PTBackend()):
        s2 = pt_sampler(dev, seed=43, backend=backend)
        s2.run_mcmc(p0, kept, thin_by=thin, skip_initial_state_check=True)
        chains.append((s2.get_chain().astype(np.float64),
                       s2.get_log_like().astype(np.float64),
                       s2.get_log_prior().astype(np.float64),
                       s2.backend.accepted, s2.swaps_accepted,
                       s2.swaps_proposed,
                       np_of(s2.backend.random_state)))
    same_ends(np, *chains, "PTDeviceBackend and PTBackend chains")
    res = dict(walker_steps_per_s=rate, tau_cold=tau,
               ess_per_s_cold=NW4 * (n_prop / dt) / tau,
               tau_reliable=bool(n_prop / tau >= 30.0),
               swap_acceptance_mean=swap_mean,
               swap_acceptance=smp.tswap_acceptance_fraction.tolist(),
               cold_mode_fraction=mode_frac, cold_mean_abs_x0=mean_abs,
               cold_spread_abs_x0=spread, cold_acceptance=acc, seconds=dt,
               replayed_launches=counted, profiled_replayed=profiled,
               proposals_counted=n_kept * thin, **win)
    out["workload4"] = res
    log(f"phase 14: (d) workload 4 (benchmarks/workloads5.py:196-262; "
        f"{NT4} x {NW4} x {ND4}, PTDeviceBackend, {kept} kept x {thin}): "
        f"{rate:.4e} walker-steps/s over all rungs (best of two), cold tau "
        f"{tau:.2f} proposals, cold ESS/s {res['ess_per_s_cold']:.4e}, "
        f"tau_reliable {res['tau_reliable']}, swap acceptance mean "
        f"{swap_mean:.3f}, cold mode fraction {mode_frac:.3f}, cold mean "
        f"|x0| {mean_abs:.3f} (spread {spread:.3f}), cold acceptance "
        f"{acc:.3f} {card}; PTDeviceBackend == PTBackend bit for bit")
    log(f"phase 14: (e) profiled {n_prof} proposals: device "
        f"{measured(win['device_us_per_proposal'])} us and "
        f"{measured(win['kernels_per_proposal'], '.0f')} kernels a "
        f"proposal, idle share {measured(win['idle'], '.4f')}, launches "
        f"{win['launches']} (exactly 2 K1, 2 K2, 1 K15, 1 K14, 1 K16 and "
        f"2 K17 a proposal); "
        f"{replay_counts(counted, profiled, n_kept * thin)} {card} "
        f"({time.perf_counter() - t0:.1f} s)")
    return out, phase14_rows(torch, dev, out, card)


def phase14_rows(torch, dev, out, card):
    """(f) The rows of K1 and K2 with the rung axis and of K15 at
    workload 4's shape: device time a launch in the workload's replays
    (profiler), a back-to-back call's and the plain version's (CUDA
    events), registers and waves, and the least time the card could
    take (bytes, with this run's acceptance and swaps)."""
    from emcee_tpu_torch.ops import accept_kernel as ak
    from emcee_tpu_torch.ops import stretch_kernel as sk
    from emcee_tpu_torch.ops import swap_kernel as swk
    from emcee_tpu_torch.ops._wrap import (
        device_sm_count, rung_plan, tile_plan)
    from emcee_tpu_torch.ops.philox import rung_keys
    from emcee_tpu_torch.parallel import default_beta_ladder

    T, nw, nd, ng = NT4, NW4, ND4, NW4 // 2
    gen = torch.Generator(device=dev).manual_seed(160)
    coords = PT_SEP * torch.randn(T, nw, nd, device=dev, generator=gen)
    keys = rung_keys(4, T, dev)
    k1 = dict(a=2.0, ndim_global=nd, pair_mode="random", seed=keys,
              offset=5)
    q, f = sk.stretch_propose(coords, 0, 2, **k1)
    betas = torch.tensor(default_beta_ladder(T, nd), dtype=torch.float32,
                         device=dev)
    flat_ll = torch.func.vmap(pt_log_like)
    ll = flat_ll(coords.reshape(-1, nd)).reshape(T, nw)
    lpr = torch.zeros(T, nw, device=dev)
    lp = swk.tempered_log_prob(betas[:, None], ll, lpr)
    ll_q = flat_ll(q.reshape(-1, nd)).reshape(T, ng)
    lpr_q = torch.zeros(T, ng, device=dev)
    lp_q = swk.tempered_log_prob(betas[:, None], ll_q, lpr_q)
    work = [coords.clone(), lp.clone(),
            torch.zeros(T, nw, dtype=torch.bool, device=dev),
            torch.zeros(T, nw, dtype=torch.int32, device=dev),
            ll.clone(), lpr.clone()]
    blobs = [(ll_q, work[4]), (lpr_q, work[5])]
    ak.accept_select(q, f, lp_q, *[w.clone() for w in work[:2]], 0, 2,
                     work[2], work[3], seed=keys, offset=5,
                     blobs=[(a, b.clone()) for a, b in blobs])
    n_acc = int(work[2][:, :ng].sum())
    sw = [coords.clone(), ll.clone(), lpr.clone(), lp.clone()]
    cnt = torch.zeros(T - 1, dtype=torch.int64, device=dev)
    swk.pt_swap(*sw, betas, cnt, seed=4, offset=0)
    n_swap = int(cnt.sum())
    n_pairs = len(swk.swap_pairs(0, T, 1))
    k2 = dict(seed=keys, offset=5, blobs=blobs)
    calls = {
        "stretch_propose": (
            lambda: sk.stretch_propose(coords, 0, 2, **k1),
            lambda: sk.stretch_propose_plain(coords, 0, 2, **k1)),
        "accept_select": (
            lambda: ak.accept_select(q, f, lp_q, work[0], work[1], 0, 2,
                                     work[2], work[3], **k2),
            lambda: ak.accept_select_plain(q, f, lp_q, work[0], work[1], 0,
                                           2, work[2], work[3], **k2)),
        # Steps 0 and 1 in turns would swap back and forth; step 0 each
        # time swaps the same pairs again from the state it left.
        "pt_swap": (
            lambda: swk.pt_swap(*sw, betas, cnt, seed=4, offset=0),
            lambda: swk.pt_swap_plain(*sw, betas, cnt, seed=4, offset=0)),
    }
    # Each input read once, each output written once (float32 words):
    # K1 reads every rung's rows and writes q and the factor; K2 reads the
    # factor, lp_q and lp of every split walker and writes its acc, and
    # for an accepted walker reads q and its two leaves and writes its
    # row, lp, leaves and count; K15 reads both rungs' logL of every
    # walker of a pair (once) and the pair's two betas, and for an accepted
    # swap reads both walkers' rows and logP and writes their rows, logL,
    # logP and lp (lp is only written), and writes the pair's count.
    # Operations: a Philox block (PHILOX_INSTR) a walker in K1, K2 and K15
    # at the issue rate.
    philox = PHILOX_INSTR
    work_of = {
        "stretch_propose": (4 * T * (nw * nd + ng * nd + ng),
                            T * ng * (philox + 25 + 3 * nd)),
        "accept_select": (4 * T * ng * 3 + T * ng + n_acc * (
            4 * nd + 4 * (nd + 1) + 8 + 2 * 4 * 2), T * ng * (philox + 6)),
        "pt_swap": (4 * n_pairs * nw * 2 + 4 * 2 * n_pairs
                    + n_swap * 2 * 4 * (2 * nd + 4) + 8 * n_pairs,
                    n_pairs * nw * (philox + 10)),
    }
    meta = {
        "stretch_propose": ("emcee_tpu_torch/csrc/stretch_propose.cu",
                            "emcee_tpu/moves/stretch.py:59 (vmapped by "
                            "emcee_tpu/parallel/tempering.py:538)",
                            "stretch_propose_kernel<true, true>", 256 + 32),
        "accept_select": ("emcee_tpu_torch/csrc/accept_select.cu",
                          "emcee_tpu/moves/red_blue.py:196 (vmapped by "
                          "emcee_tpu/parallel/tempering.py:538)",
                          "accept_rungs_kernel<true, true>",
                          rung_plan(ng, nd).threads),
        "pt_swap": ("emcee_tpu_torch/csrc/pt_swap.cu",
                    "emcee_tpu/parallel/tempering.py:543",
                    "pt_swap_kernel<NoLeaves>",
                    swk.swap_plan(nw, T, device_sm_count(dev))[0].threads),
    }
    n_sm = device_sm_count(dev)
    plan = tile_plan(ng, nd, 0, n_sm, coords.data_ptr(), q.data_ptr(),
                     rungs=T, nsplits=2)
    blocks = {"stretch_propose": plan.grid * T,
              "accept_select": rung_plan(ng, nd).grid * T,
              "pt_swap": -(-nw // meta["pt_swap"][3]) * (T // 2)}
    w4 = out["workload4"]
    # K15's device time a launch over its block sizes, 50 eager launches
    # each (the plan's block is the row's).
    swap_us = {}
    for threads, run in zip(SWAP_SWEEP_THREADS, swap_launches()[1:]):
        swap_us[threads] = profiled_ms(torch, lambda: [run(
            *sw, betas, cnt, seed=4, offset=0, swap_every=1)
            for _ in range(50)], "pt_swap", primer=True) * 1e3
    log(f"phase 14: (f) K15 device time a launch (eager) over blocks of "
        f"{SWAP_SWEEP_THREADS} threads: "
        + ", ".join(f"{t}: {us:.2f} us" for t, us in swap_us.items())
        + f" (the plan's: {meta['pt_swap'][3]}) {card}")
    rows = []
    for kname, (kernel, plain) in calls.items():
        src, jax_src, label, threads = meta[kname]
        call_ms = cuda_ms(torch, kernel)
        plain_ms = cuda_ms(torch, plain, reps=20)
        nbytes, nops = work_of[kname]
        t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": nops / ISSUE_PER_S * 1e3}
        by = max(t, key=t.get)
        regs = PTXAS.get(label)  # the instantiation workload 4 launches
        waves = (blocks[kname] / (n_sm * resident_blocks(regs[0], threads))
                 if regs else None)
        ms = w4["ms_per_launch"][kname]
        launches = w4["replayed_launches"][kname]
        name = kname if kname == "pt_swap" else f"{kname} (rung axis)"
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": jax_src, "launches": launches,
               "max_abs_err": 0.0, "ms": ms, "call_ms": call_ms,
               "plain_ms": plain_ms, "bound_ms": t[by], "bound_by": by,
               "library_ms": None, "ptxas": regs, "blocks": blocks[kname],
               "waves": waves,
               "launches_per_proposal": launches / w4["proposals_counted"],
               "wrapper_launches": out["launches"]["workload 4"][kname],
               **({"threads": threads, "eager_us_by_threads": swap_us}
                  if kname == "pt_swap" else {}),
               "note": f"{name} at workload 4's shape ({T} x {nw} x {nd}): "
                       f"ms in the workload's replays (profiler); launches "
                       f"counted on the card in {w4['proposals_counted']} "
                       "replayed proposals; max_abs_err: bit for bit over "
                       "phase 14's sweep; bound: this run's acceptance "
                       f"({n_acc} of {T * ng}) and swaps ({n_swap} of "
                       f"{n_pairs * nw}); library_ms: none, no single "
                       "PyTorch call computes it"}
        rows.append(row)
        log(f"phase 14: (f) {name}: device {ms * 1e3:.2f} us/launch in the "
            f"workload 4 replays, {call_ms * 1e3:.2f} us per back-to-back "
            f"call, plain {plain_ms * 1e3:.2f} us, bound {t[by] * 1e3:.3f} "
            f"us ({nbytes} bytes, {by}); {regs} (registers, static shared, "
            f"spilled), {blocks[kname]} blocks, {measured(waves, '.3f')} "
            f"waves {card}")
    return rows


# -- 15. the rest of tempering -----------------------------------------------
#: user blob leaves of phase 15's K2 sweep: name -> (dtype, row shape)
PT_LEAVES = {"f32": ("float32", ()), "f64": ("float64", ()),
             "i8x3": ("int8", (3,)), "f32x5": ("float32", (5,)),
             "f32x3": ("float32", (3,)), "f32x8": ("float32", (8,)),
             "f32x9": ("float32", (9,)), "f64x2": ("float64", (2,)),
             "i16x3": ("int16", (3,))}
#: the user leaf sets swept beside logL and logP: rows of 1-8 4-byte units
#: ride registers, four leaves at most (logL and logP among them); rows of
#: other units or past 8 units, and the fifth short leaf on, are copied
#: after the decision; past 16 leaves the blob-only kernel takes the rest
PT_LEAF_SETS = (("f32",), ("f32", "f32"), ("f64",), ("i8x3",), ("f32x5",),
                ("f32", "f32x5"), ("f64", "i8x3", "f32x5"),
                ("f32", "f64", "i8x3", "f32x5"), ("f32x3",), ("f32x8",),
                ("f32x9",), ("f64x2", "i16x3"), ("f32", "f32", "f32"),
                ("f32",) * 16)
#: K15's user leaves: (dtype, row shape, bytes the base lies past a
#: 16-byte boundary); rows of 1, 3, 12 and 20 bytes at unaligned bases
SWAP_LEAF_SPECS = (("uint8", (1,), 1), ("uint8", (3,), 3),
                   ("int16", (6,), 2), ("float32", (5,), 4),
                   ("float64", (), 8), ("int8", (3,), 0),
                   ("float32", (), 0))
#: K15's leaf sets of the register path (swap_kernel.swap_plan): four
#: 4-byte scalars (all in registers), five (the fifth by the table), two
#: 8-byte scalars, an 8-byte scalar beside a 3-byte row, and a 4-byte row
#: at a base 2 bytes past a boundary (a unit of 2: the table only)
SWAP_REG_LEAF_SETS = (
    (("float32", (), 0),) * 4, (("int32", (), 4),) * 5,
    (("float64", (), 0), ("int64", (), 8)),
    (("float64", (), 0), ("int8", (3,), 1)), (("int16", (2,), 2),))
#: the mixture of phase 15 (the JAX package's test_pt_mixture_block)
PT_MIX_WEIGHTS = (0.7, 0.3)


def pt_blob_like(x):
    """Workload 4's likelihood with the blobs of the JAX package's blob
    tests (``tests/unit/test_pt_parity.py:218-220``): ``(logL, 2 logL,
    x)``."""
    ll = pt_log_like(x)
    return ll, 2.0 * ll, x


def pt_named_like(p):
    """Workload 4's likelihood on named parameters ``a`` (coordinate 0)
    and ``b`` (the rest)."""
    import torch

    x = torch.cat([p["a"].reshape(1), p["b"]])
    return pt_log_like(x)


def pt_named_prior(p):
    import torch

    x = torch.cat([p["a"].reshape(1), p["b"]])
    return pt_log_prior(x)


def pt_mix(moves):
    return [(moves.StretchMove(), PT_MIX_WEIGHTS[0]),
            (moves.DEMove(), PT_MIX_WEIGHTS[1])]


def raw_leaf(torch, shape, dtype, gen, dev, misalign=0):
    """A tensor of random bytes of ``shape`` and ``dtype`` whose base lies
    ``misalign`` bytes past a 16-byte boundary."""
    dt = getattr(torch, dtype)
    item = torch.empty(0, dtype=dt).element_size()
    n = math.prod(shape) * item
    store = torch.randint(0, 256, (n + 16 + misalign,), dtype=torch.uint8,
                          device=dev, generator=gen)
    skip = (-store.data_ptr() + misalign) % 16
    return store[skip: skip + n].view(dt).view(shape)


def same_bytes(got, want, what):
    """Raise unless every tensor of ``got`` equals its ``want`` byte for
    byte."""
    import torch

    def raw(t):
        return t.contiguous().view(-1).view(torch.uint8)

    if not all(raw(a).equal(raw(b)) for a, b in zip(got, want)):
        raise AssertionError(f"{what}: kernel and plain version differ")


def k2_rung_leaf_sweep(torch, dev):
    """(a) K2 with the rung axis and user blob leaves against its plain
    version, byte for byte: rungs ``PT_SWEEP_T``, walkers ``PT_SWEEP_NW``
    (nsplits 2 and 3), the leaf sets ``PT_LEAF_SETS`` beside the ``logL``
    and ``logP`` leaves (through registers, after the decision, both, and
    past 16 leaves; and an 8-byte scalar alone), NaN and +-inf in
    ``lp_q``, injected ``log_u`` and the in-kernel stream at a host offset
    and (16 rungs) at the device offset word; by the wrapper and by the
    forced plans of :func:`k2_rung_launches`.  Returns ``(comparisons,
    {the wrapper's leaf path: launches})``."""
    from emcee_tpu_torch.ops import accept_kernel as ak
    from emcee_tpu_torch.ops.philox import DeviceOffset, rung_keys

    gen = torch.Generator(device=dev).manual_seed(151)
    word = torch.tensor(41, dtype=torch.int64, device=dev)
    n, paths = 0, {"registers": 0, "registers and after": 0, "after": 0,
                   "past 16 leaves": 0}
    nd = ND4
    for T in PT_SWEEP_T:
        for nsplits, nws in PT_SWEEP_NW.items():
            for nw in nws:
                ng = nw // nsplits
                split = (nw + T) % nsplits
                keys = rung_keys(2000 + 7 * T + nw, T, dev)
                coords = torch.randn(T, nw, nd, device=dev, generator=gen)
                q = torch.randn(T, ng, nd, device=dev, generator=gen)
                f = 0.3 * torch.randn(T, ng, device=dev, generator=gen)
                lp = -0.5 * (coords ** 2).sum(-1)
                lp_q = -0.5 * (q ** 2).sum(-1)
                lp_q.view(-1)[::7] = float("nan")
                lp_q.view(-1)[3::11] = float("inf")
                lp_q.view(-1)[5::13] = -float("inf")
                sets = PT_LEAF_SETS + ((),)
                for s_i, names in enumerate(sets):
                    tempered = names != ()
                    specs = ([("float32", ())] * 2 if tempered else
                             [("float64", ())])
                    specs += [PT_LEAVES[k] for k in names]
                    news = [raw_leaf(torch, (T, ng) + row, dt, gen, dev)
                            for dt, row in specs]
                    bufs = [raw_leaf(torch, (T, nw) + row, dt, gen, dev)
                            for dt, row in specs]
                    draws = [dict(log_u=torch.log(torch.rand(
                                 T, ng, device=dev, generator=gen))),
                             dict(offset=77 + s_i)]
                    if T == 16:
                        draws.append(dict(offset=DeviceOffset(word, s_i)))
                    n_reg = ak.leaf_plan(ak.blob_leaves(
                        list(zip(news, bufs)), ng, nw, coords.device, (T,)),
                        rungs=True)[1]
                    path = ("past 16 leaves" if len(specs) > 16
                            else "after" if not n_reg
                            else "registers" if n_reg == len(specs)
                            else "registers and after")

                    def run(fn, kw):
                        c, l = coords.clone(), lp.clone()
                        acc = torch.zeros(T, nw, dtype=torch.bool,
                                          device=dev)
                        cnt = torch.ones(T, nw, dtype=torch.int32,
                                         device=dev)
                        b = [x.clone() for x in bufs]
                        fn(q, f, lp_q, c, l, split, nsplits, acc, cnt,
                           seed=keys, blobs=list(zip(news, b)), **kw)
                        return (c, l, acc, cnt, *b)

                    for kw in draws:
                        want = run(ak.accept_select_plain, kw)
                        for i, fn in enumerate(k2_rung_launches()):
                            same_bytes(run(fn, kw), want,
                                       f"K2 rungs T={T} nw={nw} leaves "
                                       f"{names or 'f64 alone'} "
                                       f"{sorted(kw)} launch {i}")
                            n += 1
                        paths[path] += 1
    return n, paths


def swap_leaf_sweep(torch, np, dev):
    """(a) K15 with user blob leaves against its plain version, byte for
    byte: rungs ``SWAP_SWEEP_T``, 256 and 1000 walkers, the leaves of
    ``SWAP_LEAF_SPECS`` (rows of 1-20 bytes at unaligned bases) and the
    blob tests' two (``2 logL``, ``x``), steps 0-5 (both parities, and at
    ``swap_every=3`` the steps that do not swap), injected ``u``, the
    in-kernel stream at a host offset and at the device offset word, NaN
    and +-inf ``logL`` and -inf ``logP``.  Returns the comparisons."""
    from emcee_tpu_torch.ops import swap_kernel as swk
    from emcee_tpu_torch.ops.philox import DeviceOffset
    from emcee_tpu_torch.parallel import default_beta_ladder

    gen = torch.Generator(device=dev).manual_seed(152)
    n = 0
    for T in SWAP_SWEEP_T:
        for nw in (256, 1000):
            coords = torch.randn(T, nw, ND4, device=dev, generator=gen)
            ll = 4.0 * torch.randn(T, nw, device=dev, generator=gen)
            ll[:, ::7] = float("nan")
            ll[:, 1::11] = float("inf")
            ll[:, 2::13] = -float("inf")
            lpr = torch.zeros(T, nw, device=dev)
            lpr[:, 3::5] = -float("inf")
            betas = torch.tensor(default_beta_ladder(T, ND4),
                                 dtype=torch.float32, device=dev)
            lp = swk.tempered_log_prob(betas[:, None], ll, lpr)
            sets = ([raw_leaf(torch, (T, nw) + row, dt, gen, dev, mis)
                     for dt, row, mis in SWAP_LEAF_SPECS],
                    [2.0 * ll, coords.clone()],
                    *([raw_leaf(torch, (T, nw) + row, dt, gen, dev, mis)
                       for dt, row, mis in spec]
                      for spec in SWAP_REG_LEAF_SETS))
            for leaves in sets:
                for swap_every in (1, 3):
                    for step in range(6):
                        pairs = swk.swap_pairs(step, T, swap_every)
                        word = torch.tensor(step - 2, dtype=torch.int64,
                                            device=dev)
                        for mode, kw in (
                                ("injected", dict(offset=step, u=torch.rand(
                                    len(pairs), nw, device=dev,
                                    generator=gen))),
                                ("host", dict(offset=step)),
                                ("device", dict(offset=DeviceOffset(word,
                                                                    2)))):
                            outs = {}
                            for i, fn in enumerate(
                                    swap_launches((32,))
                                    + [swk.pt_swap_plain]):
                                bufs = [x.clone() for x in (coords, ll, lpr,
                                                            lp)]
                                lv = [x.clone() for x in leaves]
                                cnt = torch.zeros(T - 1, dtype=torch.int64,
                                                  device=dev)
                                fn(*bufs, betas, cnt, seed=99 + T,
                                   swap_every=swap_every, leaves=lv, **kw)
                                outs[i] = (*bufs, cnt, *lv)
                            want = outs.pop(len(outs) - 1)
                            for i, got in outs.items():
                                same_bytes(got, want, f"K15 leaves T={T} "
                                           f"nw={nw} step={step} swap_every="
                                           f"{swap_every} {mode} "
                                           f"{len(leaves)} leaves launch {i}")
                                n += 1
    return n


def pt15_sampler(dev, seed=4, backend=None, move=None, like=None, **kw):
    """Workload 4's configuration with ``move`` (default: the phase's
    mixture) and ``like`` (default: the blob likelihood)."""
    from emcee_tpu_torch import PTSampler, moves

    return PTSampler(NT4, NW4, ND4, like or pt_blob_like, pt_log_prior,
                     seed=seed, backend=backend,
                     moves=pt_mix(moves) if move is None else move,
                     device=dev, **kw)


def pt15_end(smp):
    """What a tempered run with blobs leaves: :func:`pt_chain_end`, the
    stored blobs, the ladder and the offset."""
    import numpy as np

    blobs = smp.get_blobs()
    return pt_chain_end(smp) + (
        np.asarray(blobs[0]), np.asarray(blobs[1]), smp.betas.copy(),
        np.asarray(smp._previous_state.blobs[1].cpu()))


def pt15_graph_vs_eager(torch, np, dev, p0):
    """(b) 64 graph-replayed proposals of the mixture with blobs and the
    adaptive ladder (``mixture_block`` 1 and 4; chunks of 4 kept steps,
    so the ladder adapts 14 times) against the same 64 run eagerly on the
    plain versions: 8 kept x 2 stored, 32 unstored, 16 kept stored."""
    step_bytes = NT4 * NW4 * (ND4 * 4 + 3 * 4 + 4 + ND4 * 4)
    out = {}
    for blk in (1, 4):
        ends = []
        for plain in (False, True):
            smp = pt15_sampler(dev, seed=45 + blk, adaptive=True,
                               mixture_block=blk,
                               io_chunk_bytes=4 * step_bytes)
            smp._use_graphs = not plain
            with plain_kernels() if plain else contextlib.nullcontext():
                smp.run_mcmc(p0, 8, thin_by=2, skip_initial_state_check=True)
                smp.run_mcmc(None, 32, store=False)
                smp.run_mcmc(None, 16)
            ends.append(pt15_end(smp))
        same_ends(np, *ends, f"mixture_block={blk}: graph and eager chains")
        out[blk] = dict(swaps=ends[0][4].tolist(),
                        proposed=ends[0][5].tolist(),
                        betas=ends[0][-2].tolist())
    return out


def pt15_blobs(torch, np, dev, card, p0, kept=512, thin=4):
    """(c) Workload 4 with the blobs ``(2 logL, x)`` at full size: both
    backends from one start, the stored blobs against the stored rows,
    the stored rates with and without blobs in turns, and K2's and K15's
    device time a launch inside replays with and without leaves."""
    from emcee_tpu_torch import moves
    from emcee_tpu_torch.backends import PTBackend, PTDeviceBackend

    ends = []
    for backend in (PTDeviceBackend(), PTBackend()):
        smp = pt15_sampler(dev, seed=44, backend=backend,
                           move=moves.StretchMove())
        smp.run_mcmc(p0, kept, thin_by=thin, skip_initial_state_check=True)
        b = smp.get_blobs()
        ends.append((smp.get_chain().astype(np.float64),
                     smp.get_log_like().astype(np.float64),
                     smp.get_log_prior().astype(np.float64),
                     np.asarray(b[0], dtype=np.float64),
                     np.asarray(b[1], dtype=np.float64),
                     smp.backend.accepted, smp.swaps_accepted,
                     np_of(smp.backend.random_state)))
    same_ends(np, *ends, "PTDeviceBackend and PTBackend chains and blobs")
    chain, ll, _, b1, b2 = ends[1][:5]
    if not (np.array_equal(b1, 2.0 * ll) and np.array_equal(b2, chain)):
        raise AssertionError("phase 15: a stored blob differs from the "
                             "function at its stored row")
    samplers = {
        True: pt15_sampler(dev, seed=44, backend=PTDeviceBackend(),
                           move=moves.StretchMove()),
        False: pt_sampler(dev, seed=44, backend=PTDeviceBackend())}
    states = {}
    for blobs, smp in samplers.items():
        states[blobs], _ = drive(smp, p0, kept, thin_by=thin,
                                 skip_initial_state_check=True)
        warm_graphs(smp, top=thin)
    rates = {True: [], False: []}
    for blobs in (True, False, False, True):
        smp = samplers[blobs]
        smp.reset()
        states[blobs], dt = drive(smp, states[blobs], kept, thin_by=thin,
                                  skip_initial_state_check=True)
        rates[blobs].append(NT4 * NW4 * kept * thin / dt)
    names = {"stretch_propose": 2, "accept_select": 2, "pt_swap": 1,
             "philox_draw": 1} | SHUF4  # K14: the shuffle's sort keys
    wins = {}
    for blobs, smp in samplers.items():
        wins[blobs] = busy_window(
            torch, lambda: smp.run_mcmc(None, 256, store=False), 256,
            f"workload 4 {'with' if blobs else 'without'} blobs",
            names=names)
    counted, profiled = counted_replays(
        torch, dev, samplers[True], 16,
        lambda r: {k: v * 16 * thin for k, v in names.items()},
        "workload 4 with blobs", thin_by=thin, store=False)
    return dict(rates_blobs=rates[True], rates_none=rates[False],
                win_blobs=wins[True], win_none=wins[False],
                replayed_launches=counted, profiled_replayed=profiled,
                proposals_counted=16 * thin,
                acc=float(samplers[True].acceptance_fraction.mean()))


def pt15_mixture(torch, np, dev, card, p0, kept=512, thin=4, n_win=8):
    """(d) The mixture at full size into ``PTDeviceBackend``: its rate
    (the best of two timed runs), the cold rung's tau and the swap
    acceptance with phase 14's checks; then the device time and kernels
    a proposal of each move alone (the rung-batched stretch move, DE on
    every rung at once, and DE forced to loop over the rungs) in profiled
    windows of ``n_win`` proposals."""
    from emcee_tpu_torch import moves
    from emcee_tpu_torch.backends import PTDeviceBackend

    smp = pt15_sampler(dev, backend=PTDeviceBackend(), like=pt_log_like)
    st, _ = drive(smp, p0, kept, thin_by=thin, skip_initial_state_check=True)
    warm_graphs(smp, top=thin)
    dt = float("inf")
    for _ in range(2):
        smp.reset()
        st, dt_run = drive(smp, st, kept, thin_by=thin,
                           skip_initial_state_check=True)
        dt = min(dt, dt_run)
    n_prop = kept * thin
    cold = smp.get_chain(temp=0)
    tau = tau_of(np, cold, thin)
    swap_mean = float(np.mean(smp.tswap_acceptance_fraction))
    mode_frac = float(np.mean(cold[..., 0] > 0))
    checks = {
        "swap acceptance mean in (0.4, 0.9)": 0.4 < swap_mean < 0.9,
        "cold mode fraction in (0.25, 0.75)": 0.25 < mode_frac < 0.75,
        "tau finite": bool(np.isfinite(tau)),
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 15: mixture checks {checks}")
    per_move = {}
    for name, mv, batched in (("stretch", moves.StretchMove(), True),
                              ("de", moves.DEMove(), True),
                              ("de loop", moves.DEMove(), False)):
        one = pt15_sampler(dev, seed=46, move=mv, like=pt_log_like)
        one._batched = batched
        one.run_mcmc(p0, n_win, store=False, skip_initial_state_check=True)
        warm_graphs(one)
        win = busy_window(
            torch, lambda: one.run_mcmc(None, n_win, store=False), n_win,
            f"mixture's {name} move alone")
        per_move[name] = dict(
            device_us=win["device_us_per_proposal"],
            kernels=win["kernels_per_proposal"], idle=win["idle"],
            launches={kk: v / n_win for kk, v in win["launches"].items()
                      if v})
    return dict(walker_steps_per_s=NT4 * NW4 * n_prop / dt, seconds=dt,
                tau_cold=tau, ess_per_s_cold=NW4 * (n_prop / dt) / tau,
                swap_acceptance_mean=swap_mean, cold_mode_fraction=mode_frac,
                per_move=per_move)


def pt15_adaptive(torch, np, dev, card, p0, reps=20):
    """(e) The adaptive ladder from the bad ladder of the JAX package's
    ``test_adaptive_ladder_equalizes_swap_rates`` (``max_temp=1e6``, lag
    1000, time 20) at workload 4's size, the test's schedule (13 unstored
    runs of 100, then 300 stored), against the frozen ladder in the same
    call; then the host's work a chunk (the swap counts' read,
    ``_adapt_ladder`` and the tempered log-prob formed again), the median
    of ``reps``."""
    from emcee_tpu_torch import moves
    from emcee_tpu_torch.parallel import default_beta_ladder

    bad = default_beta_ladder(NT4, ND4, max_temp=1e6)
    runs = {}
    for adaptive in (True, False):
        smp = pt15_sampler(dev, seed=3, like=pt_log_like, betas=bad.copy(),
                           move=moves.StretchMove(),
                           adaptive=adaptive, adaptation_lag=1000,
                           adaptation_time=20)
        t0 = time.perf_counter()
        smp.run_mcmc(p0, 100, store=False, skip_initial_state_check=True)
        for _ in range(12):
            smp.run_mcmc(None, 100, store=False)
        smp.run_mcmc(None, 300)
        runs[adaptive] = (smp, np.asarray(smp.tswap_acceptance_fraction,
                                          dtype=float),
                          time.perf_counter() - t0)
    smp, rates_a, sec_a = runs[True]
    _, rates_f, sec_f = runs[False]
    checks = {"the ladder moved": not np.allclose(smp.betas, bad),
              "beta_0 is 1": smp.betas[0] == 1.0,
              "spread of swap rates below the frozen ladder's":
                  rates_a.std() < rates_f.std()}
    if not all(checks.values()):
        raise AssertionError(f"phase 15: adaptive ladder checks {checks}")
    prog = smp._program
    prev = np.zeros(NT4 - 1, dtype=np.int64)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        swaps = prog.ws.swaps.cpu().numpy().astype(np.int64)
        betas, _ = smp._adapt_ladder(swaps, prev, 100, 1400)
        prog.set_betas(smp._betas_tensor(betas))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prog.set_betas(smp._betas_tensor(smp.betas))
    return dict(rates_adaptive=rates_a.tolist(), rates_frozen=rates_f.tolist(),
                std_adaptive=float(rates_a.std()),
                std_frozen=float(rates_f.std()), betas=smp.betas.tolist(),
                seconds_adaptive=sec_a, seconds_frozen=sec_f,
                host_us_per_chunk=float(np.median(times)) * 1e6)


def pt15_looped(torch, np, dev, card, p0, n=32, n_timed=8, n_cnt=16):
    """(f) ``EnsembleSliceMove()`` and ``ChEESHMCMove(0.5)`` on every rung
    at workload 4's size, ``n`` proposals each: the graph chain against the
    plain versions' eager chain and against the forced per-rung loop's
    graph chain, bit for bit (both moves every rung at once, one read a
    loop block or a proposal serving every rung).  Then µs and flag reads
    a proposal over ``n_timed`` more, and device µs and kernels a proposal
    in a profiled window of 4, for each path (the per-rung loop in turns
    with the batched path); ChEES's batched launches in ``n_cnt``
    replayed proposals counted by device words (``chees_expect``)."""
    from emcee_tpu_torch import moves
    from emcee_tpu_torch.chunk_graph import ChunkProgram

    def timed(smp):
        reads = ChunkProgram.flag_reads
        t0 = time.perf_counter()
        smp.run_mcmc(None, n_timed, store=False)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) / n_timed * 1e6,
                (ChunkProgram.flag_reads - reads) / n_timed)

    out = {}
    for name, make in (("slice", moves.EnsembleSliceMove),
                       ("chees", lambda: moves.ChEESHMCMove(0.5))):
        ends, smps = [], {}
        for plain, batched in ((False, True), (True, True), (False, False)):
            smp = pt15_sampler(dev, seed=47, move=make())
            smp._use_graphs = not plain
            smp._batched = batched
            with plain_kernels() if plain else contextlib.nullcontext():
                smp.run_mcmc(p0, n // 2, tune=True,
                             skip_initial_state_check=True)
                smp.run_mcmc(None, n // 2)
            ends.append(pt15_end(smp))
            if not plain:
                smps[batched] = smp
        same_ends(np, ends[0], ends[1],
                  f"{name} on every rung: graph and eager chains")
        if len(ends) > 2:
            same_ends(np, ends[0], ends[2], f"{name} on every rung: the "
                      "batched path and the per-rung loop")
        rows = {}
        for batched in (True, False, False, True):
            if batched not in smps:
                continue
            us, flag_reads = timed(smps[batched])
            r = rows.setdefault(batched, dict(us_per_proposal=[],
                                              flag_reads=flag_reads))
            r["us_per_proposal"].append(us)
        for batched, r in rows.items():
            smp = smps[batched]
            win = busy_window(torch,
                              lambda: smp.run_mcmc(None, 4, store=False),
                              4, f"{name} on every rung"
                              + ("" if batched else " (per-rung loop)"))
            r.update(flag_reads_per_rung=r["flag_reads"] / NT4,
                     device_us=win["device_us_per_proposal"],
                     kernels=win["kernels_per_proposal"], idle=win["idle"],
                     acc=float(smp.acceptance_fraction.mean()))
        turns = rows[True]["us_per_proposal"]
        out[name] = rows[True] | {"us_per_proposal": turns[0],
                                  "us_per_proposal_turns": turns,
                                  "loop": rows[False]}
        if name == "chees":
            if rows[True]["flag_reads"] != 1.0:
                raise AssertionError(f"phase 15: ChEES on every rung: "
                                     f"{rows[True]['flag_reads']} flag "
                                     "reads a proposal")
            out[name]["replayed_launches"], _ = counted_replays(
                torch, dev, smps[True], n_cnt,
                chees_expect(n_cnt, False, 0, swaps=True),
                "phase 15 ChEES on every rung", store=False)
            out[name]["proposals_counted"] = n_cnt
    return out


def pt15_monitor(torch, np, dev, card, p0):
    """(g) ``run_until_converged`` on workload 4's tempered sampler into
    ``PTDeviceBackend``, judged on the cold rung; its seconds a check."""
    from emcee_tpu_torch import ConvergenceMonitor, run_until_converged
    from emcee_tpu_torch.backends import PTDeviceBackend
    from emcee_tpu_torch.monitor import stored_chain

    smp = pt_sampler(dev, seed=48, backend=PTDeviceBackend())
    mon = ConvergenceMonitor(tau_factor=50, dtau_rel=0.05)
    t0 = time.perf_counter()
    _, mon = run_until_converged(smp, p0, max_steps=8000, check_every=1000,
                                 monitor=mon, skip_initial_state_check=True)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    t1 = time.perf_counter()
    ConvergenceMonitor().update(stored_chain(smp))
    check = time.perf_counter() - t1
    if mon.tau is None or mon.tau.shape != (ND4,) or not np.all(
            np.isfinite(mon.tau)):
        raise AssertionError(f"phase 15: the monitor's tau {mon.tau}")
    return dict(iterations=smp.iteration, tau=mon.tau.tolist(),
                converged=smp.iteration < 8000, seconds=total,
                seconds_a_check=check, checks=len(mon.history))


def pt15_hdf(torch, np, dev, card, p0, kept=64):
    """(h) ``PTHDFBackend`` with ``io_dtype=float32`` and
    ``parameter_names`` against ``PTBackend`` of the plain likelihood
    from one start, a fresh sampler resuming the file, and the blobs'
    record dataset; without h5py, a log line."""
    import tempfile

    try:
        import h5py  # noqa: F401
    except ImportError:
        log("phase 15: (h) pt-hdf: h5py not installed")
        return None
    from emcee_tpu_torch import PTSampler
    from emcee_tpu_torch.backends import PTBackend, PTHDFBackend

    with tempfile.TemporaryDirectory(dir=_build_dir()) as d:
        path = f"{d}/pt.h5"
        names = {"a": 0, "b": list(range(1, ND4))}
        a = PTSampler(NT4, NW4, ND4, pt_named_like, pt_named_prior, seed=49,
                      backend=PTHDFBackend(path), io_dtype=np.float32,
                      parameter_names=names, device=dev)
        a.run_mcmc(p0, kept, skip_initial_state_check=True)
        b = pt_sampler(dev, seed=49, backend=PTBackend())
        b.run_mcmc(p0, kept, skip_initial_state_check=True)
        same_ends(np, (a.get_chain(), a.get_log_like(), a.swaps_accepted),
                  (b.get_chain(), b.get_log_like(), b.swaps_accepted),
                  "PTHDFBackend (named, io float32) and PTBackend chains")
        c = PTSampler(NT4, NW4, ND4, pt_blob_like, pt_log_prior, seed=50,
                      backend=PTHDFBackend(path, name="blobs"), device=dev)
        c.run_mcmc(p0, kept // 2, skip_initial_state_check=True)
        again = PTSampler(NT4, NW4, ND4, pt_blob_like, pt_log_prior,
                          seed=50, backend=PTHDFBackend(path, name="blobs"),
                          device=dev)
        again.run_mcmc(None, kept // 2)
        rec = again.backend.get_blobs(structured=True)
        blob1 = again.get_blobs()[0]
        if (rec.shape != (kept, NT4, NW4)
                or set(rec.dtype.names) != {"blob0", "blob1"}
                or not np.array_equal(blob1, 2.0 * again.get_log_like())):
            raise AssertionError("phase 15: PTHDFBackend blobs")
        return dict(iterations=again.iteration, fields=list(rec.dtype.names))


def phase15(torch, np, dev, card):
    """The rest of tempering (see the module docstring, 15): the sweeps
    of K2's rung axis with leaves and of K15 with leaves, the graph
    chains against the eager ones, blobs, the mixture, the adaptive
    ladder, the looped moves on every rung, the monitor and
    ``PTHDFBackend``; each path's kernel launches counted from 0 just
    before it.  Returns its numbers and the rows of K2 with the rung
    axis and the blobs' leaves and of K15 with leaves."""
    out = {}
    t0 = time.perf_counter()
    out["sweep_k2"], out["k2_paths"] = k2_rung_leaf_sweep(torch, dev)
    out["sweep_k15"] = swap_leaf_sweep(torch, np, dev)
    log(f"phase 15: (a) K2 with the rung axis and user leaves (rungs "
        f"{PT_SWEEP_T}, walkers {PT_SWEEP_NW} by nsplits, leaf sets "
        f"{PT_LEAF_SETS} beside logL and logP and an 8-byte scalar alone, "
        f"injected / host offset / device offset draws): {out['sweep_k2']} "
        f"comparisons, the wrapper and {len(K2_RUNG_PLANS)} forced plans "
        f"({out['k2_paths']} by the wrapper's leaf path); K15 with leaves "
        f"(rungs {SWAP_SWEEP_T}, 256 and 1000 walkers, rows of 1-20 bytes at "
        f"unaligned bases, steps 0-5, swap_every 1 and 3, NaN and +-inf "
        f"logL, -inf logP): {out['sweep_k15']} comparisons; all byte for "
        f"byte ({time.perf_counter() - t0:.1f} s)")
    p0 = pt_p0(np)
    t0 = time.perf_counter()
    with path_launches(out, "graph vs eager", (
            "stretch_propose", "accept_select", "de_propose", "pt_swap"),
            "phase 15"):
        out["graph_vs_eager"] = pt15_graph_vs_eager(torch, np, dev, p0)
    log(f"phase 15: (b) 64 graph-replayed proposals of the mixture "
        f"(stretch {PT_MIX_WEIGHTS[0]}, DE {PT_MIX_WEIGHTS[1]}) with the "
        f"blobs (2 logL, x) and adaptive=True, mixture_block 1 and 4, equal "
        f"the same 64 eagerly on the plain versions bit for bit (coords, "
        f"logL, logP, blobs, acceptance, swap counts, ladder, offset): "
        f"{out['graph_vs_eager']} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    with path_launches(out, "blobs", ("stretch_propose", "accept_select",
                                      "pt_swap"), "phase 15"):
        bl = out["blobs"] = pt15_blobs(torch, np, dev, card, p0)
    wb, wn = bl["win_blobs"], bl["win_none"]
    log(f"phase 15: (c) workload 4 with blobs (2 logL, x), 512 kept x 4: "
        f"PTDeviceBackend == PTBackend, chains and blobs; every stored blob "
        f"equals 2 logL and the coords of its row; stored rates in turns "
        f"(blobs, none, none, blobs): with blobs "
        f"{', '.join(f'{r:.4e}' for r in bl['rates_blobs'])}, without "
        f"{', '.join(f'{r:.4e}' for r in bl['rates_none'])} walker-steps/s; "
        f"device {measured(wb['device_us_per_proposal'])} / "
        f"{measured(wn['device_us_per_proposal'])} us and "
        f"{measured(wb['kernels_per_proposal'], '.0f')} / "
        f"{measured(wn['kernels_per_proposal'], '.0f')} kernels a proposal "
        f"(with / without); K2 "
        f"{wb['ms_per_launch']['accept_select'] * 1e3:.2f} / "
        f"{wn['ms_per_launch']['accept_select'] * 1e3:.2f} us, K15 "
        f"{wb['ms_per_launch']['pt_swap'] * 1e3:.2f} / "
        f"{wn['ms_per_launch']['pt_swap'] * 1e3:.2f} us a launch in replays; "
        + replay_counts(bl["replayed_launches"], bl["profiled_replayed"],
                        bl["proposals_counted"])
        + f" {card} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    with path_launches(out, "mixture", ("stretch_propose", "accept_select",
                                        "de_propose", "pt_swap"),
                       "phase 15"):
        mx = out["mixture"] = pt15_mixture(torch, np, dev, card, p0)
    pm = mx["per_move"]
    log(f"phase 15: (d) the mixture at workload 4's size, PTDeviceBackend, "
        f"512 kept x 4: {mx['walker_steps_per_s']:.4e} walker-steps/s over "
        f"all rungs (best of two), cold tau {mx['tau_cold']:.2f} proposals, "
        f"cold ESS/s {mx['ess_per_s_cold']:.4e}, swap acceptance mean "
        f"{mx['swap_acceptance_mean']:.3f}, cold mode fraction "
        f"{mx['cold_mode_fraction']:.3f}; alone, a proposal: the batched "
        f"stretch move {measured(pm['stretch']['device_us'])} us of device "
        f"time and {measured(pm['stretch']['kernels'], '.0f')} kernels "
        f"({pm['stretch']['launches']}), batched DE "
        f"{measured(pm['de']['device_us'])} us and "
        f"{measured(pm['de']['kernels'], '.0f')} kernels "
        f"({pm['de']['launches']}), DE forced to loop over the rungs "
        f"{measured(pm['de loop']['device_us'])} us and "
        f"{measured(pm['de loop']['kernels'], '.0f')} kernels "
        f"({pm['de loop']['launches']}) {card} "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    with path_launches(out, "adaptive", ("stretch_propose", "accept_select",
                                         "pt_swap"),
                       "phase 15"):
        ad = out["adaptive"] = pt15_adaptive(torch, np, dev, card, p0)
    log(f"phase 15: (e) the adaptive ladder from max_temp=1e6 (13 x 100 "
        f"unstored, 300 stored): swap rates' spread {ad['std_adaptive']:.4f} "
        f"against {ad['std_frozen']:.4f} frozen; beta_0 1; ladder "
        f"{[round(b, 6) for b in ad['betas']]}; the host's work a chunk "
        f"(read, adapt, log-prob formed again) "
        f"{ad['host_us_per_chunk']:.1f} us {card} "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    with path_launches(out, "looped", CHEES_KERNELS + ("pt_swap",)
                       + K9_KERNELS, "phase 15"):
        lo = out["looped"] = pt15_looped(torch, np, dev, card, p0)
    log("phase 15: (f) the looped moves on every rung, graph chain == eager "
        "plain chain and batched path == per-rung loop, bit for bit; "
        + "; ".join(
            f"{k}: {v['us_per_proposal']:.1f} us a proposal, "
            f"{v['flag_reads']:.2f} flag reads a proposal "
            f"({v['flag_reads_per_rung']:.2f} a rung), device "
            f"{measured(v['device_us'])} us and "
            f"{measured(v['kernels'], '.0f')} kernels a proposal; its "
            f"per-rung loop: {[round(u, 1) for u in v['loop']['us_per_proposal']]}"
            f" us a proposal (in turns with the batched path's "
            f"{[round(u, 1) for u in v['us_per_proposal_turns']]}), "
            f"{v['loop']['flag_reads']:.2f} flag reads, device "
            f"{measured(v['loop']['device_us'])} us and "
            f"{measured(v['loop']['kernels'], '.0f')} kernels a proposal"
            for k, v in lo.items())
        + f"; ChEES's batched launches in "
        f"{lo['chees']['proposals_counted']} replayed proposals "
        f"{ {k: v for k, v in lo['chees']['replayed_launches'].items() if v} }"
        f" (device words) {card} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    mo = out["monitor"] = pt15_monitor(torch, np, dev, card, p0)
    log(f"phase 15: (g) run_until_converged on the tempered sampler (cold "
        f"rung, tau_factor 50, dtau_rel 0.05): {mo['iterations']} steps, "
        f"converged {mo['converged']}, cold tau "
        f"{[round(t, 2) for t in mo['tau']]}, {mo['checks']} checks, "
        f"{mo['seconds']:.2f} s in all, {mo['seconds_a_check'] * 1e3:.1f} ms "
        f"a check {card} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    hd = out["hdf"] = pt15_hdf(torch, np, dev, card, p0)
    if hd is not None:
        log(f"phase 15: (h) PTHDFBackend with io_dtype=float32 and "
            f"parameter_names equals PTBackend of the plain likelihood; a "
            f"fresh sampler resumes the file with blobs to "
            f"{hd['iterations']} steps, fields {hd['fields']} "
            f"({time.perf_counter() - t0:.1f} s)")
    log(f"phase 15: kernel wrapper launches of each path, counted from 0 "
        f"(recordings and eager runs): {out['launches']}")
    return out, phase15_rows(torch, dev, out, card)


def phase15_rows(torch, dev, out, card):
    """The rows of K2 with the rung axis and the blobs' leaves and of K15
    with leaves at workload 4's shape with the blobs ``(2 logL, x)``:
    device time a launch in the blob path's replays (profiler), a
    back-to-back call's (K2's also with every leaf copied after the
    decision) and the plain version's (CUDA events), registers, and the
    least time the card could take (bytes, leaves counted, with this
    call's acceptance and swaps)."""
    from emcee_tpu_torch.ops import accept_kernel as ak
    from emcee_tpu_torch.ops import stretch_kernel as sk
    from emcee_tpu_torch.ops import swap_kernel as swk
    from emcee_tpu_torch.ops._wrap import rung_plan
    from emcee_tpu_torch.ops.philox import rung_keys
    from emcee_tpu_torch.parallel import default_beta_ladder

    T, nw, nd, ng = NT4, NW4, ND4, NW4 // 2
    gen = torch.Generator(device=dev).manual_seed(161)
    coords = PT_SEP * torch.randn(T, nw, nd, device=dev, generator=gen)
    keys = rung_keys(4, T, dev)
    q, f = sk.stretch_propose(coords, 0, 2, a=2.0, ndim_global=nd,
                              pair_mode="random", seed=keys, offset=5)
    betas = torch.tensor(default_beta_ladder(T, nd), dtype=torch.float32,
                         device=dev)
    flat_ll = torch.func.vmap(pt_log_like)
    ll = flat_ll(coords.reshape(-1, nd)).reshape(T, nw)
    lpr = torch.zeros(T, nw, device=dev)
    lp = swk.tempered_log_prob(betas[:, None], ll, lpr)
    ll_q = flat_ll(q.reshape(-1, nd)).reshape(T, ng)
    lp_q = swk.tempered_log_prob(betas[:, None], ll_q, torch.zeros_like(
        ll_q))
    news = (ll_q, torch.zeros_like(ll_q), 2.0 * ll_q, q.clone())
    bufs = (ll, lpr, 2.0 * ll, coords.clone())
    work = [coords.clone(), lp.clone(),
            torch.zeros(T, nw, dtype=torch.bool, device=dev),
            torch.zeros(T, nw, dtype=torch.int32, device=dev)]
    blobs = list(zip(news, [b.clone() for b in bufs]))
    if ak.leaf_plan(ak.blob_leaves(blobs, ng, nw, coords.device, (T,)),
                    True)[1] != len(blobs):
        raise AssertionError("phase 15: the blob path's leaves did not all "
                             "go through registers")
    ak.accept_select(q, f, lp_q, *[w.clone() for w in work[:2]], 0, 2,
                     work[2], work[3], seed=keys, offset=5,
                     blobs=[(a, b.clone()) for a, b in blobs])
    n_acc = int(work[2][:, :ng].sum())
    sw = [coords.clone(), ll.clone(), lpr.clone(), lp.clone()]
    leaves = [2.0 * ll, coords.clone()]
    cnt = torch.zeros(T - 1, dtype=torch.int64, device=dev)
    swk.pt_swap(*sw, betas, cnt, seed=4, offset=0, leaves=leaves)
    n_swap = int(cnt.sum())
    n_pairs = len(swk.swap_pairs(0, T, 1))
    k2 = dict(seed=keys, offset=5, blobs=blobs)
    calls = {
        "accept_select": (
            lambda: ak.accept_select(q, f, lp_q, work[0], work[1], 0, 2,
                                     work[2], work[3], **k2),
            lambda: ak.accept_select_plain(q, f, lp_q, work[0], work[1], 0,
                                           2, work[2], work[3], **k2)),
        "pt_swap": (
            lambda: swk.pt_swap(*sw, betas, cnt, seed=4, offset=0,
                                leaves=leaves),
            lambda: swk.pt_swap_plain(*sw, betas, cnt, seed=4, offset=0,
                                      leaves=leaves)),
    }
    # Bytes: K2 reads the factor, lp_q and lp of every split walker and
    # writes its acc; an accepted walker reads its q row and its four
    # leaves' new rows (4 + 4 + 4 + 20 bytes) and writes its row, lp, the
    # leaves and its count.  K15 reads both rungs' logL of every walker of
    # a pair and the pair's two betas; a swap reads both walkers' rows,
    # logP and user leaves (24 bytes) and writes them, logL and lp; and
    # the pair's count.  Operations: a Philox block a walker.
    leaf_bytes = 4 + 4 + 4 + 4 * nd
    user_bytes = 4 + 4 * nd
    work_of = {
        "accept_select": (
            4 * T * ng * 3 + T * ng + n_acc * (
                4 * nd + 4 * (nd + 1) + 4 + 2 * leaf_bytes),
            T * ng * (PHILOX_INSTR + 6)),
        "pt_swap": (
            4 * n_pairs * nw * 2 + 4 * 2 * n_pairs + n_swap * 2 * (
                4 * (2 * nd + 4) + 2 * user_bytes) + 8 * n_pairs,
            n_pairs * nw * (PHILOX_INSTR + 10)),
    }
    meta = {
        "accept_select": (
            "K2 (rung axis, blob leaves)", "accept_select.cu",
            "emcee_tpu/moves/red_blue.py:196 and :200-202 (vmapped by "
            "emcee_tpu/parallel/tempering.py:538)",
            "accept_rungs_kernel<true, true>"),
        "pt_swap": ("K15 (with leaves)", "pt_swap.cu",
                    "emcee_tpu/parallel/tempering.py:543-580",
                    "pt_swap_kernel<Leaves<unsigned int>>"),
    }
    bl = out["blobs"]
    rows = []
    for kname, (kernel, plain) in calls.items():
        name, src, jax_src, label = meta[kname]
        call_ms = cuda_ms(torch, kernel)
        plain_ms = cuda_ms(torch, plain, reps=20)
        extra = {}
        if kname == "accept_select":
            # The same launch with every leaf copied after the decision.
            after = k2_rung_launches(((rung_plan(ng, nd).threads, 1, 0),))[1]
            extra["call_ms_leaves_after"] = cuda_ms(torch, lambda: after(
                q, f, lp_q, work[0], work[1], 0, 2, work[2], work[3], **k2))
        nbytes, nops = work_of[kname]
        t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": nops / ISSUE_PER_S * 1e3}
        by = max(t, key=t.get)
        ms = bl["win_blobs"]["ms_per_launch"][kname]
        launches = bl["replayed_launches"][kname]
        regs = PTXAS.get(label)
        row = {"name": name, "route": "cuda",
               "source": f"emcee_tpu_torch/csrc/{src}",
               "replaces": jax_src, "launches": launches,
               "max_abs_err": 0.0, "ms": ms, "call_ms": call_ms,
               "plain_ms": plain_ms, "bound_ms": t[by], "bound_by": by,
               "library_ms": None, "ptxas": regs,
               "ms_without_leaves": bl["win_none"]["ms_per_launch"][kname],
               **extra,
               "launches_per_proposal": launches / bl["proposals_counted"],
               "wrapper_launches": out["launches"]["blobs"][kname],
               "note": f"{name} at workload 4's shape ({T} x {nw} x {nd}) "
                       "with the blobs (2 logL, x): ms in the blob path's "
                       "replays (profiler), ms_without_leaves the same "
                       "window of the blob-free path; launches counted on "
                       f"the card in {bl['proposals_counted']} replayed "
                       "proposals; max_abs_err: byte for byte over phase "
                       "15's sweep; bound: this call's acceptance "
                       f"({n_acc} of {T * ng}) and swaps ({n_swap} of "
                       f"{n_pairs * nw}), leaves counted; library_ms: none, "
                       "no single PyTorch call computes it"}
        rows.append(row)
        log(f"phase 15: {name}: device {ms * 1e3:.2f} us/launch in the blob "
            f"path's replays ({row['ms_without_leaves'] * 1e3:.2f} without "
            f"leaves), {call_ms * 1e3:.2f} us per back-to-back call"
            + (f" ({extra['call_ms_leaves_after'] * 1e3:.2f} with every leaf "
               "after the decision)" if extra else "")
            + f", plain {plain_ms * 1e3:.2f} us, bound {t[by] * 1e3:.3f} us "
            f"({nbytes} bytes, {by}); {regs} (registers, static shared, "
            f"spilled) {card}")
    return rows


# -- 16. K14, the counter-based draws -----------------------------------------
#: rows, counters a row and rungs of K14's sweep (phase 16)
K14_SWEEP_N = (1, 2, 31, 255, 5003, 100_003)
K14_SWEEP_K = (1, 2, 3, 5, 17)
K14_SWEEP_T = (1, 2, 3, 16)
#: K14's blocks forced beside the wrapper's plan (threads; blocks that
#: end inside a row or a rung, 96 not a power of two)
K14_SWEEP_PLANS = (32, 96, 128, 256, 1024)
#: K14's blocks timed at phase 16's two shapes beside the wrapper's plan
K14_TIME_PLANS = (32, 128, 256, 512, 1024)


@contextlib.contextmanager
def forced_draw_plan(threads):
    """K14's wrapper launching with ``threads`` a block (the rest of its
    plan as ``draw_plan`` makes it)."""
    from emcee_tpu_torch.ops import philox_kernel as pk

    real = pk.draw_plan

    def plan(kind, rows, k, d, word, ntemps):
        return real(kind, rows, k, d, word, ntemps)._replace(
            threads=threads, blocks=-(-ntemps * rows * k // threads))

    pk.draw_plan = plan
    try:
        yield
    finally:
        pk.draw_plan = real


def philox_kernel_sweep(torch, dev):
    """(a) K14 against its plain version (the torch rounds), ``torch.equal``
    on every output: every kind (all four words or one; uniforms of every
    word or one; normals) in float32 and float64, rows ``K14_SWEEP_N``,
    counters a row ``K14_SWEEP_K`` (the stored columns' tail cut), lanes
    from 0 and from 1000003, the block an int and a device tensor, a host
    offset and a device offset word; the rung axis (``K14_SWEEP_T`` rungs,
    6-1000 walkers, with and without the ``ROLL_LANE`` column); the
    public draws (``ops/philox.py``) against their ``plain=True`` twins;
    draws recorded into a CUDA graph and replayed after the offset word
    and the block word changed; and a few counters against
    ``philox4x32_scalar`` on the host.  Returns the comparisons."""
    from emcee_tpu_torch.ops import de_kernel as dk
    from emcee_tpu_torch.ops import philox
    from emcee_tpu_torch.ops import philox_kernel as pk
    from emcee_tpu_torch.ops.philox import DeviceOffset, rung_keys

    n_cmp = 0

    def same(got, want, what):
        nonlocal n_cmp
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if len(got) != len(want):
            raise AssertionError(f"phase 16: K14 {what}: {len(got)} outputs "
                                 f"against {len(want)}")
        for a, b in zip(got, want):
            if (a.dtype != b.dtype or a.shape != b.shape
                    or not torch.equal(a, b)):
                raise AssertionError(f"phase 16: K14 {what}: kernel and "
                                     "plain version differ")
            n_cmp += 1

    def check(args, kw, what):
        same(pk.philox_draw(*args, **kw), pk.philox_draw_plain(*args, **kw),
             what)

    seed = 0x0123456789ABCDEF
    word = torch.tensor((1 << 33) + 5, dtype=torch.int64, device=dev)
    offsets = {"host": (1 << 33) + 8, "device": DeviceOffset(word, 3)}
    for kind in ("words", "uniforms", "normals"):
        dtypes = ((torch.int64,) if kind == "words"
                  else (torch.float32, torch.float64))
        sels = (None,) if kind == "normals" else (None, 0, 3)
        for dt in dtypes:
            for n in K14_SWEEP_N:
                for k in K14_SWEEP_K:
                    for sel in sels:
                        kw = dict(word=sel)
                        kk = k
                        if kind != "words":
                            kw["dtype"] = dt
                            if sel is None:  # d fixes k: cut the tail
                                per = 4 if kind == "uniforms" else 2
                                kw["d"], kk = per * k - k % per, None
                        for row0 in (0, 1_000_003):
                            for blk in ("int", "tensor"):
                                block = philox.PICK_BLOCK | 40
                                if blk == "tensor":
                                    block = torch.tensor(
                                        block, dtype=torch.int64, device=dev)
                                for off, offset in offsets.items():
                                    check((kind, n, kk, block, seed, offset,
                                           dev), dict(kw, row0=row0),
                                          f"{kind} {dt} n={n} k={k} "
                                          f"word={sel} row0={row0} {blk} "
                                          f"block, {off} offset")
    for T in K14_SWEEP_T:
        keys = rung_keys(seed + T, T, dev)
        for n in (6, 256, 1000):
            for roll in (False, True):
                for sel in (None, 1, 3):
                    for split in (0, 2):
                        for off, offset in offsets.items():
                            check(("words", n, 1, split, keys, offset, dev),
                                  dict(word=sel, roll=roll),
                                  f"rung axis T={T} n={n} roll={roll} "
                                  f"word={sel} split={split} {off} offset")
    # The public draws: K14 against the torch rounds (plain=True).
    keys = rung_keys(seed, 16, dev)
    shrink = torch.tensor(philox.SHRINK_BLOCK | 3, dtype=torch.int64,
                          device=dev)
    for offset in offsets.values():
        for name, fn in (
                ("walker_words", lambda pl: philox.walker_words(
                    5003, 1, seed, offset, dev, plain=pl)),
                ("walker_words word 3", lambda pl: philox.walker_words(
                    5003, 2, seed, offset, dev, word=3, plain=pl)),
                ("rung_words", lambda pl: philox.rung_words(
                    keys, 256, 2, offset, dev, word=3, plain=pl)),
                ("rung_words roll", lambda pl: philox.rung_words(
                    keys, 128, 1, offset, dev, roll=True, plain=pl)),
                ("row_words", lambda pl: philox.row_words(
                    31, 5, philox.DEZ_BLOCK, seed, offset, dev, 7,
                    plain=pl)),
                ("normals", lambda pl: philox.normals(
                    50_000, 6, seed, offset, dev, row0=50_000, plain=pl)),
                ("normals f64 chi2", lambda pl: philox.normals(
                    5003, 7, seed, offset, dev, torch.float64,
                    block=philox.CHI2_BLOCK, plain=pl)),
                ("row_uniforms", lambda pl: philox.row_uniforms(
                    5003, 8, seed, offset, dev, row0=3,
                    block=philox.DEZ_BLOCK, plain=pl)),
                ("word_uniforms shrink", lambda pl: philox.word_uniforms(
                    5003, 4, shrink, seed, offset, dev, 0, torch.float64,
                    11, plain=pl)),
                ("word_uniforms one column", lambda pl: philox.word_uniforms(
                    5003, 1, 1, seed, offset, dev, 1, plain=pl)[:, 0]),
                ("roll_uniforms", lambda pl: philox.roll_uniforms(
                    seed, 1, offset, dev, plain=pl)),
                ("grad_uniform", lambda pl: philox.grad_uniform(
                    seed, 1, offset, dev, plain=pl)),
                ("walker_normal", lambda pl: dk.walker_normal(
                    5003, 1, seed, offset, dev, plain=pl)),
                ("de_pairs random", lambda pl: dk.de_pairs(
                    5003, 5003, 1, "random", seed, offset, dev, plain=pl)),
                ("de_pairs roll", lambda pl: dk.de_pairs(
                    5003, 5003, 1, "roll", seed, offset, dev, plain=pl))):
            same(fn(False), fn(True), f"public draw {name}")
    # Recorded into a graph, replayed after the words changed.
    blk = torch.tensor(philox.SHRINK_BLOCK, dtype=torch.int64, device=dev)

    def draws(plain=False):
        draw = pk.philox_draw_plain if plain else pk.philox_draw
        return [draw("normals", 5003, None, philox.NORMAL_BLOCK, seed,
                     DeviceOffset(word, 1), dev, d=7),
                draw("uniforms", 5003, 4, blk, seed, DeviceOffset(word, 2),
                     dev, word=0),
                draw("words", 256, 1, 2, keys, DeviceOffset(word, 0), dev,
                     word=3),
                draw("uniforms", 1, None, 3, seed, DeviceOffset(word, 0),
                     dev, row0=philox.ROLL_LANE, d=4, dtype=torch.float64)]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        draws()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = draws()
    for rep in range(3):
        word.fill_(1000 + 37 * rep)
        blk.fill_(philox.SHRINK_BLOCK | (9 * rep))
        graph.replay()
        for i, (a, b) in enumerate(zip(outs, draws(plain=True))):
            same(a, b, f"graph replay {rep}, draw {i}")
    word.fill_((1 << 33) + 5)
    # Forced plans: every kind and dtype, rows with and without a tail
    # (d odd, d short of 4k), the rung axis with and without ROLL_LANE, and
    # graph replays.
    for threads in K14_SWEEP_PLANS:
        with forced_draw_plan(threads):
            for n in (1, 31, 255, 5003):
                for k in (1, 2, 3, 5, 17):
                    at = f"blocks of {threads} n={n} k={k}"
                    for sel in (None, 3):
                        check(("words", n, k, 7, seed, offsets["device"],
                               dev), dict(word=sel, row0=5), f"{at} words "
                              f"{sel}")
                    for dt in (torch.float32, torch.float64):
                        for d in {4 * k, 4 * k - 1}:
                            check(("uniforms", n, None, 7, seed,
                                   offsets["host"], dev),
                                  dict(d=d, dtype=dt), f"{at} uniforms d={d}")
                        check(("uniforms", n, k, 7, seed, offsets["host"],
                               dev), dict(word=1, dtype=dt),
                              f"{at} uniforms word 1")
                        for d in {2 * k, 2 * k - 1}:
                            check(("normals", n, None, 7, seed,
                                   offsets["device"], dev),
                                  dict(d=d, dtype=dt), f"{at} normals d={d}")
            for T in (1, 3, 16):
                keys = rung_keys(seed + 7 * T, T, dev)
                for n in (6, 256, 1000):
                    for roll in (False, True):
                        check(("words", n, 1, 2, keys, offsets["device"],
                               dev), dict(word=3, roll=roll),
                              f"blocks of {threads} rung axis T={T} n={n} "
                              f"roll={roll}")
                check(("normals", 1000, None, 9, keys, offsets["host"], dev),
                      dict(d=7), f"blocks of {threads} rung axis T={T} "
                      "normals")
    with forced_draw_plan(96):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = draws()
        for rep in range(3):
            word.fill_(2000 + 41 * rep)
            blk.fill_(philox.SHRINK_BLOCK | (5 * rep))
            graph.replay()
            for i, (a, b) in enumerate(zip(outs, draws(plain=True))):
                same(a, b, f"blocks of 96 graph replay {rep}, draw {i}")
    word.fill_((1 << 33) + 5)
    # A few counters against the scalar reference, on the host.
    off = (1 << 40) + 5
    lo, hi = philox.split_offset(off)
    row0, block = (1 << 32) - 3, 0xFFFFFFF0
    got = pk.philox_draw("words", 3, 2, block, seed, off, dev, row0=row0)
    got = [w.cpu() for w in got]
    rk = rung_keys(seed, 3, dev)
    grk = [w.cpu() for w in pk.philox_draw("words", 2, 1, 5, rk, off, dev,
                                           roll=True)]
    for r in range(3):
        for j in range(2):
            want = philox.philox4x32_scalar((row0 + r, block + j, lo, hi),
                                            philox.split_key(seed))
            if [int(got[w][r, j]) for w in range(4)] != want:
                raise AssertionError(f"phase 16: K14 counter ({row0 + r}, "
                                     f"{block + j}) differs from "
                                     "philox4x32_scalar")
            n_cmp += 1
    for t in range(3):
        for r, lane in enumerate((0, 1, philox.ROLL_LANE)):
            want = philox.philox4x32_scalar(
                (lane, 5, lo, hi), philox.split_key(rk.seeds[t]))
            if [int(grk[w][t, r, 0]) for w in range(4)] != want:
                raise AssertionError(f"phase 16: K14 rung {t} lane {lane} "
                                     "differs from philox4x32_scalar")
            n_cmp += 1
    return n_cmp


def k14_workload4(torch, np, dev, out, n_prof=64, n_kept=8, thin=4):
    """Workload 4 briefly (for ``python3 chip_smoke.py 16`` alone): K14's
    device ms a launch in a profiled window of replays and its launches
    counted on the card in replayed proposals, with every kernel's count
    held exactly."""
    per = {"stretch_propose": 2, "accept_select": 2, "pt_swap": 1,
           "philox_draw": 1} | SHUF4
    with path_launches(out, "workload 4", tuple(per), "phase 16"):
        smp = pt_sampler(dev)
        smp.run_mcmc(pt_p0(np), n_kept, thin_by=thin,
                     skip_initial_state_check=True)
        smp.run_mcmc(None, n_prof, store=False)  # records the window's graphs
        win = busy_window(
            torch, lambda: smp.run_mcmc(None, n_prof, store=False), n_prof,
            "workload 4", expect=lambda: {k: v * n_prof
                                          for k, v in per.items()},
            names=per)
        counted, _ = counted_replays(
            torch, dev, smp, n_kept,
            lambda r: {k: v * n_kept * thin for k, v in per.items()},
            "workload 4", thin_by=thin, store=False)
    return dict(ms_per_launch=win["ms_per_launch"],
                replayed_launches=counted, proposals_counted=n_kept * thin,
                kernels_per_proposal=win["kernels_per_proposal"],
                device_us_per_proposal=win["device_us_per_proposal"])


def phase16(torch, np, dev, card, p12=None, p14=None):
    """K14 (see the module docstring, 16): the sweep, then its row: device
    time a launch at workload 4's shape (every rung's sort key, word 3 of
    16 x 256 counters) in the workload's replays (phase 14's window, or a
    short run of its own when phase 16 runs alone) and eagerly, and at
    the DIME stage's shape (a split's 5e4 x 6 float32 normals) alone,
    eagerly (the stage draws in K8c: K14 has no launch on its path, and
    phase 12's window counts 0 a proposal); back-to-back calls and the
    plain version (CUDA events); the bounds by bytes and by the
    instructions the function needs."""
    from emcee_tpu_torch.ops import philox
    from emcee_tpu_torch.ops.philox import rung_keys

    out = {}
    t0 = time.perf_counter()
    out["comparisons"] = n_cmp = philox_kernel_sweep(torch, dev)
    log(f"phase 16: (a) K14 against its plain version (torch.equal; words, "
        f"uniforms and normals in float32 and float64, rows {K14_SWEEP_N}, "
        f"counters a row {K14_SWEEP_K}, lanes from 0 and 1000003, int and "
        f"device blocks, host and device offsets; the rung axis over "
        f"{K14_SWEEP_T} rungs with and without ROLL_LANE; the public draws "
        f"against plain=True; graph replays; counters against "
        f"philox4x32_scalar): {n_cmp} comparisons, all identical "
        f"({time.perf_counter() - t0:.1f} s)")
    w4 = (p14 or {}).get("workload4") or k14_workload4(torch, np, dev, out)
    keys = rung_keys(4, NT4, dev)
    ng = NW // 2
    shapes = {
        "workload 4": (
            lambda pl=False: philox.rung_words(keys, NW4, 2, 5, dev, word=3,
                                               plain=pl),
            # int64 word 3 of every rung's walkers written, the key table
            # and the offset read; a Philox block a counter
            8 * NT4 * NW4 + 8 * NT4, NT4 * NW4 * PHILOX_INSTR, 0),
        "DIME stage": (
            lambda pl=False: philox.normals(ng, ND + 1, 3, 5, dev,
                                            plain=pl),
            # float32 normals written; 3 Philox blocks and 6 stored normals
            # a row
            4 * ng * (ND + 1), ng * (
                (ND + 2) // 2 * PHILOX_INSTR + (ND + 1) * NORMAL_INSTR),
            ng * (ND + 1) * NORMAL_SFU)}
    res = {}
    gen = torch.Generator(device=dev).manual_seed(16)

    def launch_ms(fn):
        """Device ms a launch of one-launch torch calls, 50 of them."""
        _, kernels = profile_window(torch, lambda: [fn() for _ in range(50)],
                                    primer=True)
        return (sum(us for _, us in kernels.values())
                / max(1, sum(c for c, _ in kernels.values())) * 1e-3)

    for shape, (fn, nbytes, instr, sfu) in shapes.items():
        t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": instruction_bound(instr, sfu)}
        by = max(t, key=t.get)
        # The yardsticks, device time a launch: torch's fill of the same
        # output (the same bytes written, one launch), and torch's own
        # Philox draw into it (random_ of the int64 words, normal_ of the
        # float32 normals under a CUDA generator: one launch, but another
        # stream than K14's, so not a call that computes its function).
        buf = fn()
        buf = buf[0] if isinstance(buf, tuple) else buf
        yard = launch_ms(lambda: buf.fill_(0))
        philox_fill = (buf.random_ if buf.dtype == torch.int64
                       else buf.normal_)
        torch_philox = launch_ms(lambda: philox_fill(generator=gen))
        # Eager device time over other plans than the wrapper's.
        by_plan = {}
        for threads in K14_TIME_PLANS:
            with forced_draw_plan(threads):
                by_plan[threads] = profiled_ms(
                    torch, lambda: [fn() for _ in range(20)], "philox_draw",
                    primer=True) * 1e3
        log(f"phase 16: (b) K14 at {shape}'s shape, eager us a launch by "
            "threads a block: " + ", ".join(
                f"{k}: {v:.2f}" for k, v in by_plan.items()) + f" {card}")
        res[shape] = dict(
            yardstick_ms=yard, torch_philox_ms=torch_philox,
            eager_us_by_plan=by_plan,
            call_ms=cuda_ms(torch, fn),
            plain_ms=cuda_ms(torch, lambda: fn(True), reps=20),
            eager_ms=profiled_ms(torch, lambda: [fn() for _ in range(20)],
                                 "philox_draw", primer=True),
            bound_ms=t[by], bound_by=by, bound_bytes_ms=t["bytes"],
            bound_instructions_ms=t["operations"], bytes=nbytes,
            instructions=instr)
    res["workload 4"]["ms"] = w4["ms_per_launch"]["philox_draw"]
    dime = (p12 or {}).get("dime") or {}
    # K8c draws the DIME stage's numbers: no K14 launch in its replays.
    res["DIME stage"]["ms"] = None
    for shape, r in res.items():
        log(f"phase 16: (b) K14 at {shape}'s shape: device "
            f"{measured(r['ms'] and r['ms'] * 1e3, '.2f')} us/launch in the "
            f"path's replays, {r['eager_ms'] * 1e3:.2f} eagerly, "
            f"{r['call_ms'] * 1e3:.2f} us per back-to-back call, plain "
            f"{r['plain_ms'] * 1e3:.2f} us, torch's fill of the same output "
            f"{r['yardstick_ms'] * 1e3:.2f} us and its own Philox draw into "
            f"it {r['torch_philox_ms'] * 1e3:.2f} us, bound "
            f"{r['bound_ms'] * 1e3:.4f} "
            f"us ({r['bound_by']}; bytes {r['bound_bytes_ms'] * 1e3:.4f}, "
            f"instructions {r['bound_instructions_ms'] * 1e3:.4f}) {card}")
    regs = {k: v for k, v in PTXAS.items() if "philox_draw_kernel" in k}
    a, b = res["workload 4"], res["DIME stage"]
    launches = w4["replayed_launches"]["philox_draw"]
    # K14's launches a proposal, as this run counted them: on the card in
    # workload 4's replays, and by the profiler in the DIME stage's
    # window (phase 12; None when phase 12 did not run).
    per_proposal = {
        "workload 4": launches / w4["proposals_counted"],
        "DIME stage": (dime["launches"]["philox_draw"]
                       / dime["proposals_profiled"] if dime else None)}
    row = {"name": "philox_draw", "route": "cuda",
           "source": "emcee_tpu_torch/csrc/philox_draw.cu",
           "replaces": "emcee_tpu/moves/red_blue.py:218",
           "launches": launches, "max_abs_err": 0.0,
           "ms": a["ms"] if a["ms"] is not None else a["eager_ms"],
           "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
           "bound_by": a["bound_by"], "library_ms": None,
           "call_ms": a["call_ms"], "eager_ms": a["eager_ms"],
           "yardstick_ms": a["yardstick_ms"],
           "yardstick_ms_dime": b["yardstick_ms"],
           "torch_philox_ms": a["torch_philox_ms"],
           "torch_philox_ms_dime": b["torch_philox_ms"],
           "eager_us_by_plan": a["eager_us_by_plan"],
           "eager_us_by_plan_dime": b["eager_us_by_plan"],
           "bound_bytes_ms": a["bound_bytes_ms"],
           "bound_instructions_ms": a["bound_instructions_ms"],
           "ms_dime": b["ms"], "eager_ms_dime": b["eager_ms"],
           "call_ms_dime": b["call_ms"], "plain_ms_dime": b["plain_ms"],
           "bound_ms_dime": b["bound_ms"], "bound_by_dime": b["bound_by"],
           "bound_bytes_ms_dime": b["bound_bytes_ms"],
           "bound_instructions_ms_dime": b["bound_instructions_ms"],
           "comparisons": n_cmp, "ptxas": regs,
           "launches_per_proposal": per_proposal,
           "note": f"K14 at workload 4's shape ({NT4} rungs x {NW4} walkers, "
                   "the shuffle's word 3): ms in the workload's replays "
                   "(profiler); launches counted on the card in "
                   f"{w4['proposals_counted']} replayed proposals; _dime: "
                   f"K14 alone at the DIME stage's {ng} x {ND + 1} float32 "
                   "normals of a split (the stage draws in K8c: ms_dime "
                   "None, its launches a proposal 0); max_abs_err: "
                   f"torch.equal over {n_cmp} comparisons; bound: the "
                   "bytes written and read, and the instructions needed "
                   "(PHILOX_INSTR a counter, NORMAL_INSTR / NORMAL_SFU a "
                   "stored normal); yardstick: torch's fill_ of the same "
                   "output, eager device time; torch_philox: torch's own "
                   "Philox draw into the same output (random_ / normal_ "
                   "under a CUDA generator, one launch), a yardstick only: "
                   "its stream is not K14's; library_ms: none, no PyTorch "
                   "call draws these counters"}
    log(f"phase 16: K14 ptxas {regs}; launches in {w4['proposals_counted']} "
        f"replayed workload-4 proposals {launches} (device counters); a "
        f"proposal {per_proposal} {card}")
    return out, [row]


# -- 17. DE and DE-snooker on every rung ---------------------------------------
#: rungs, walkers a split and ndims of K5a's and K5b's rung-axis sweep
K5R_SWEEP_T = (2, 3, 16, 64)
K5R_SWEEP_NG = (1, 3, 31, 128, 1000)
K5R_SWEEP_ND = (1, 3, 5, 8, 100)
#: phase 17's moves at workload 4's configuration
PT17_MOVES = ("DEMove()", "DESnookerMove()", "the mixture")
#: each move's kernels a proposal at 16 rungs (the mixture's depend on
#: its draws of the move)
PT17_PER = {"DEMove()": {"de_propose": 2, "accept_select": 2, "pt_swap": 1,
                         "philox_draw": 1} | SHUF4,
            "DESnookerMove()": {"snooker_propose": 4, "accept_select": 4,
                                "pt_swap": 1, "philox_draw": 1} | SHUF4}


def pt17_move(label):
    """A fresh move of ``PT17_MOVES``: the DE family of workload 3
    (``benchmarks/workload3.py:71-77``) at the JAX package's defaults."""
    from emcee_tpu_torch import moves

    if label == "DEMove()":
        return moves.DEMove()
    if label == "DESnookerMove()":
        return moves.DESnookerMove()
    return [(moves.DEMove(), 0.8), (moves.DESnookerMove(), 0.2)]


def pt17_expect(smp, label, n, offset):
    """Each kernel's launches in ``n`` tempered proposals of ``smp`` from
    Philox offset ``offset`` at 16 rungs: ``PT17_PER`` a proposal, or for
    the mixture 2 K5a a DE proposal and 4 K5b a snooker one, in the order
    the chain's seed draws them on the host (``driver.move_sequence``)."""
    from emcee_tpu_torch.driver import move_sequence

    if label in PT17_PER:
        return {k: v * n for k, v in PT17_PER[label].items()}
    seq = move_sequence(smp._weights, smp._program.seed, offset, n, 1,
                        smp._mixture_block)
    n_de = int((seq == 0).sum())
    n_sn = n - n_de
    return {"de_propose": 2 * n_de, "snooker_propose": 4 * n_sn,
            "accept_select": 2 * n_de + 4 * n_sn, "pt_swap": n,
            "philox_draw": n} | {k: v * n for k, v in SHUF4.items()}


def k5_rung_sweep(torch, dev):
    """(a) K5a and K5b with the rung axis against their plain versions, bit
    for bit (the bits compared, NaN included): rungs ``K5R_SWEEP_T``,
    walkers a split ``K5R_SWEEP_NG``, ndim ``K5R_SWEEP_ND``; K5a at
    nsplits 2, 3 and 4 (a complement of two rows or more), K5b at nsplits
    4 and, in roll mode, 2; both pair modes; injected draws (a rung's roll
    uniforms at the top of their range) with a per-rung scale, the
    in-kernel stream at a host offset (scale unset) and at the device
    offset word (scale per rung).  At the host offset each case also runs,
    through ``_launch``, a ``q`` whose base is 4 bytes past a 16-byte
    boundary, K5a's other variant (its own rows read directly where the
    plan stages them) and K5b with one warp taking its tile's walkers in
    turn; at 3 rungs each rung is also held against the one-ensemble launch
    of that rung under its own key; at ndim 5 a ``coords`` base off a
    16-byte boundary (staging dropped by the plan).  Returns the count of
    comparisons."""
    from emcee_tpu_torch.ops import de_kernel as dk
    from emcee_tpu_torch.ops import snooker_kernel as snk
    from emcee_tpu_torch.ops._wrap import de_plan, device_sm_count
    from emcee_tpu_torch.ops.philox import DeviceOffset, rung_keys

    gen = torch.Generator(device=dev).manual_seed(170)
    offset = (1 << 33) + 11  # the offset's high word is set
    word = torch.tensor(offset - 3, dtype=torch.int64, device=dev)
    top = 1.0 - 2.0**-24
    n_sm = device_sm_count(dev)
    ri = dict(device=dev, generator=gen, dtype=torch.int32)
    n = 0

    def launches(mod, kind, coords, split, ns, kw, extra):
        """``(label, (q, factor))`` of the launch paths of one case."""
        T, nw, nd = coords.shape
        ng = nw // ns
        snooker = kind == "snooker"
        out = [("wrapper", getattr(mod, f"{kind}_propose")(
            coords, split, ns, **kw))]
        if not extra:
            return out
        q_odd = misaligned(torch, torch.empty(T, ng, nd, device=dev))
        plans = [("q base not aligned", q_odd, de_plan(
            ng, nd, split, n_sm, coords.data_ptr(), q_odd.data_ptr(),
            snooker=snooker, rungs=T, nsplits=ns))]
        q = torch.empty(T, ng, nd, device=dev)
        plan = de_plan(ng, nd, split, n_sm, coords.data_ptr(), q.data_ptr(),
                       snooker=snooker, stage=not snooker, rungs=T,
                       nsplits=ns)
        if snooker:
            plans.append(("one warp, walkers in turn", q,
                          plan._replace(threads=32)))
        elif plan.stage:
            plans.append(("own rows read directly", q,
                          plan._replace(stage=0, smem=0)))
        for label, qb, p in plans:
            f = torch.empty(T, ng, device=dev)
            mod._launch(p, coords, qb, f, split, ns, **kw)
            out.append((label, (qb, f)))
        return out

    def case(mod, kind, coords, split, ns, pair_mode, inj, base, keys,
             scale, draws=("injected", "host offset", "device offset")):
        nonlocal n
        T = coords.shape[0]
        for draw in draws:
            kw = dict(base, pair_mode=pair_mode, seed=keys, offset=0,
                      scale=scale)
            if draw == "injected":
                kw.update(inj)
            elif draw == "host offset":
                kw.update(offset=offset, scale=None)
            else:
                kw.update(offset=DeviceOffset(word, 3))
            want = getattr(mod, f"{kind}_propose_plain")(coords, split, ns,
                                                         **kw)
            what = (f"K5 rung sweep, {kind}, T={T} nw={coords.shape[1]} "
                    f"nd={coords.shape[2]} nsplits={ns} split={split} "
                    f"{pair_mode} {draw}")
            for label, got in launches(mod, kind, coords, split, ns, kw,
                                       draw == "host offset"):
                same_bits(got, want, f"{what} {label}")
                n += 1
            if T == 3 and draw != "device offset":
                for r in range(T):
                    one = {k: (v[r] if isinstance(v, torch.Tensor)
                               and k != "seed" else v) for k, v in kw.items()}
                    one["seed"] = keys.seeds[r]
                    got = getattr(mod, f"{kind}_propose")(coords[r], split,
                                                          ns, **one)
                    same_bits(got, (want[0][r], want[1][r]),
                              f"{what}: rung {r} against one ensemble")
                    n += 1

    def de_inj(T, ng, nc, pair_mode):
        z = dict(z=torch.randn(T, ng, device=dev, generator=gen))
        if pair_mode == "roll":
            u = torch.rand(T, 2, device=dev, generator=gen)
            u[-1] = top
            return dict(z, u_shift=u)
        return dict(z, idx_a=torch.randint(0, nc, (T, ng), **ri),
                    idx_b=torch.randint(0, nc - 1, (T, ng), **ri))

    def sn_inj(T, ng, pair_mode):
        if pair_mode == "roll":
            u = torch.rand(T, 4, device=dev, generator=gen)
            u[-1, 1:] = top
            return dict(u4=u)
        return dict(idx=torch.randint(0, ng, (T, 3, ng), **ri),
                    perm=torch.randint(0, 6, (T, ng), **ri))

    for T in K5R_SWEEP_T:
        keys = rung_keys(2000 + T, T, dev)
        scale = 0.5 + torch.rand(T, device=dev, generator=gen)
        for ng in K5R_SWEEP_NG:
            for nd in K5R_SWEEP_ND:
                de_base = dict(gamma0=dk.de_gamma0(None, nd), sigma=0.1,
                               z=None, u_shift=None, idx_a=None, idx_b=None)
                sn_base = dict(gammas=1.7, ndim_global=nd, u4=None,
                               idx=None, perm=None)
                for ns in (2, 3, 4):
                    nw = ns * ng
                    coords = torch.randn(T, nw, nd, device=dev,
                                         generator=gen)
                    split = (ng + nd + T) % ns
                    odd = (misaligned(torch, coords)
                           if nd == 5 and ns != 3 else None)
                    for pair_mode in ("roll", "random"):
                        if (ns - 1) * ng >= 2:
                            case(dk, "de", coords, split, ns, pair_mode,
                                 de_inj(T, ng, nw - ng, pair_mode), de_base,
                                 keys, scale)
                            if odd is not None:
                                case(dk, "de", odd, split, ns, pair_mode, {},
                                     de_base, keys, scale,
                                     draws=("host offset",))
                        if ns == 4 or (ns == 2 and pair_mode == "roll"):
                            case(snk, "snooker", coords, split, ns,
                                 pair_mode, sn_inj(T, ng, pair_mode),
                                 sn_base, keys, scale)
                            if odd is not None:
                                case(snk, "snooker", odd, split, ns,
                                     pair_mode, {}, sn_base, keys, scale,
                                     draws=("host offset",))
    return n


def pt17_path(torch, np, dev, card, label, p0, n_c=16, kept=512, thin=4):
    """(b)-(c) of phase 17 for one move at workload 4's configuration: the
    graph chain against the plain versions' eager chain and the
    rung-batched path against the per-rung loop, bit for bit over 64
    proposals; both paths timed in turns (batched, loop, loop, batched):
    host µs and device µs and kernels a proposal, the batched path's
    launches counted by device words; then 512 kept x 4 into
    ``PTDeviceBackend`` (the best of two timed runs) with phase 14's
    checks, a profiled window and the replayed launches counted."""
    from emcee_tpu_torch.backends import PTDeviceBackend

    out = {}
    ends = []
    for plain in (False, True):
        smp = pt_sampler(dev, seed=47, move=pt17_move(label))
        smp._use_graphs = not plain
        with plain_kernels() if plain else contextlib.nullcontext():
            ends.append(pt_runs(smp, p0))
    same_ends(np, *ends, f"{label}: graph-replayed and eager plain chains")
    paths = {}
    for batched in (True, False):
        smp = pt_sampler(dev, seed=48, move=pt17_move(label))
        smp._batched = batched
        paths[batched] = (smp, pt_runs(smp, p0))
        smp.run_mcmc(None, n_c, store=False)  # records the timed graph
    same_ends(np, paths[True][1], paths[False][1],
              f"{label}: the batched path and the per-rung loop")
    out["swaps_64"] = paths[True][1][4].tolist()
    host = {True: [], False: []}
    dev_us = {True: [], False: []}
    kernels = {True: [], False: []}
    for batched in (True, False, False, True):
        smp = paths[batched][0]
        _, dt = drive(smp, None, n_c, store=False)
        host[batched].append(dt / n_c * 1e6)
        win = busy_window(torch, lambda: smp.run_mcmc(None, n_c, store=False),
                          n_c, f"{label} {'batched' if batched else 'loop'}")
        dev_us[batched].append(win["device_us_per_proposal"])
        kernels[batched].append(win["kernels_per_proposal"])
    per = PT17_PER.get(label)
    smp = paths[True][0]
    counted, _ = counted_replays(
        torch, dev, smp, n_c,
        lambda r: pt17_expect(smp, label, n_c, smp._rng[1] - n_c),
        f"{label} batched", warm=per is None, store=False)
    out["batched_vs_loop"] = dict(
        host_us=host, device_us=dev_us, kernels=kernels,
        batched_launches=counted)
    del paths

    smp = pt_sampler(dev, move=pt17_move(label), backend=PTDeviceBackend())
    st, _ = drive(smp, p0, kept, thin_by=thin, skip_initial_state_check=True)
    warm_graphs(smp)
    dt = float("inf")
    for _ in range(2):  # workloads5.py:224-233: the best of two
        smp.reset()
        st, dt_run = drive(smp, st, kept, thin_by=thin,
                           skip_initial_state_check=True)
        dt = min(dt, dt_run)
    n_prop = kept * thin
    cold = smp.get_chain(temp=0)
    tau = tau_of(np, cold, thin)
    swap_mean = float(np.mean(smp.tswap_acceptance_fraction))
    x0 = cold[..., 0]
    mode_frac = float(np.mean(x0 > 0))
    mean_abs, spread = float(np.mean(np.abs(x0))), float(np.std(np.abs(x0)))
    checks = {
        "swap acceptance mean in (0.4, 0.9)": 0.4 < swap_mean < 0.9,
        "cold mode fraction in (0.25, 0.75)": 0.25 < mode_frac < 0.75,
        "cold mean |x0| within 0.25 of 4": abs(mean_abs - PT_SEP) < 0.25,
        "cold spread of |x0| within 0.2 of 1": abs(spread - 1.0) < 0.2,
        "tau finite": bool(np.isfinite(tau)),
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 17: {label}: workload 4 checks "
                             f"{checks} (swap {swap_mean}, mode {mode_frac},"
                             f" |x0| {mean_abs} +- {spread}, tau {tau})")
    n_prof = 256
    win = busy_window(torch, lambda: smp.run_mcmc(None, n_prof, store=False),
                      n_prof, f"{label} at workload 4", names=per)
    res = dict(walker_steps_per_s=NT4 * NW4 * n_prop / dt, seconds=dt,
               tau_cold=tau, ess_per_s_cold=NW4 * (n_prop / dt) / tau,
               tau_reliable=bool(n_prop / tau >= 30.0),
               swap_acceptance_mean=swap_mean, cold_mode_fraction=mode_frac,
               cold_mean_abs_x0=mean_abs, cold_spread_abs_x0=spread,
               cold_acceptance=float(smp.acceptance_fraction[0].mean()),
               win=win)
    n_kept = 16
    res["replayed_launches"], res["profiled_replayed"] = counted_replays(
        torch, dev, smp, n_kept,
        lambda r: pt17_expect(smp, label, n_kept * thin,
                              smp._rng[1] - n_kept * thin),
        f"{label} at workload 4", warm=per is None, thin_by=thin,
        store=False)
    res["proposals_counted"] = n_kept * thin
    out["workload4"] = res
    return out


def phase17(torch, np, dev, card):
    """DE and DE-snooker on every rung (see the module docstring, 17): the
    sweep of K5a and K5b with the rung axis, then ``DEMove()``,
    ``DESnookerMove()`` and their mixture at workload 4's configuration,
    each path's kernel launches counted from 0 just before it, and the
    rows of K5a and K5b with the rung axis.  Returns its numbers and the
    rows."""
    out = {}
    t0 = time.perf_counter()
    out["sweep"] = k5_rung_sweep(torch, dev)
    log(f"phase 17: (a) K5a and K5b with the rung axis against their plain "
        f"versions (rungs {K5R_SWEEP_T}, walkers a split {K5R_SWEEP_NG}, "
        f"ndim {K5R_SWEEP_ND}, nsplits 2-4, both pair modes, injected / "
        f"host offset / device offset draws, scale per rung, q and coords "
        f"bases off 16 bytes, K5a direct and staged, K5b one warp for a "
        f"tile, each rung at 3 rungs against the one-ensemble launch): "
        f"{out['sweep']} comparisons, all bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")
    p0 = pt_p0(np)
    kernels_of = {"DEMove()": ("de_propose",),
                  "DESnookerMove()": ("snooker_propose",),
                  "the mixture": ("de_propose", "snooker_propose")}
    for label in PT17_MOVES:
        t0 = time.perf_counter()
        with path_launches(out, label, kernels_of[label] + (
                "accept_select", "pt_swap", "philox_draw") + SHUFFLE_KERNELS,
                "phase 17"):
            r = out[label] = pt17_path(torch, np, dev, card, label, p0)
        bl, w4 = r["batched_vs_loop"], r["workload4"]
        log(f"phase 17: (b) {label} at {NT4} x {NW4} x {ND4}: 64 "
            f"graph-replayed proposals equal the plain versions' eager chain "
            f"and the batched path equals the per-rung loop, bit for bit "
            f"(chain, logL, logP, acceptance, swaps {r['swaps_64']}, offset)")
        log(f"phase 17: (c) {label} in turns (batched, loop, loop, batched), "
            f"a proposal: host {[round(x, 1) for x in bl['host_us'][True]]} / "
            f"{[round(x, 1) for x in bl['host_us'][False]]} us, device "
            f"{[measured(x) for x in bl['device_us'][True]]} / "
            f"{[measured(x) for x in bl['device_us'][False]]} us, kernels "
            f"{[measured(x, '.0f') for x in bl['kernels'][True]]} / "
            f"{[measured(x, '.0f') for x in bl['kernels'][False]]} (batched "
            f"/ loop); batched launches in 16 proposals "
            f"{ {k: v for k, v in bl['batched_launches'].items() if v} } "
            f"{card}")
        win = w4["win"]
        log(f"phase 17: (d) {label}, workload 4's configuration, "
            f"PTDeviceBackend, 512 kept x 4: {w4['walker_steps_per_s']:.4e} "
            f"walker-steps/s over all rungs (best of two), cold tau "
            f"{w4['tau_cold']:.2f} proposals, cold ESS/s "
            f"{w4['ess_per_s_cold']:.4e}, tau_reliable {w4['tau_reliable']}, "
            f"swap acceptance mean {w4['swap_acceptance_mean']:.3f}, cold "
            f"mode fraction {w4['cold_mode_fraction']:.3f}, cold mean |x0| "
            f"{w4['cold_mean_abs_x0']:.3f} (spread "
            f"{w4['cold_spread_abs_x0']:.3f}), cold acceptance "
            f"{w4['cold_acceptance']:.3f}; profiled 256 proposals: device "
            f"{measured(win['device_us_per_proposal'])} us and "
            f"{measured(win['kernels_per_proposal'], '.0f')} kernels a "
            f"proposal, idle share {measured(win['idle'], '.4f')}"
            + "; " + replay_counts(w4["replayed_launches"],
                                   w4["profiled_replayed"],
                                   w4["proposals_counted"])
            + f" {card} ({time.perf_counter() - t0:.1f} s)")
    log(f"phase 17: kernel wrapper launches of each path, counted from 0 "
        f"(recordings and eager runs): {out['launches']}")
    return out, phase17_rows(torch, dev, out, card)


def phase17_rows(torch, dev, out, card):
    """(e) The rows of K5a and K5b with the rung axis at workload 4's
    shape: device time a launch in the path's replays (``DEMove()``'s and
    ``DESnookerMove()``'s, profiler), a back-to-back call's and the plain
    version's (CUDA events), registers and waves, and the least time the
    card could take (bytes, and the instructions the function needs)."""
    from emcee_tpu_torch.ops import de_kernel as dk
    from emcee_tpu_torch.ops import snooker_kernel as snk
    from emcee_tpu_torch.ops._wrap import de_plan, device_sm_count
    from emcee_tpu_torch.ops.philox import rung_keys

    T, nw, nd = NT4, NW4, ND4
    gen = torch.Generator(device=dev).manual_seed(171)
    coords = PT_SEP * torch.randn(T, nw, nd, device=dev, generator=gen)
    keys = rung_keys(4, T, dev)
    n_sm = device_sm_count(dev)
    k5a = dict(gamma0=dk.de_gamma0(None, nd), sigma=1e-5, pair_mode="random",
               seed=keys, offset=5)
    k5b = dict(gammas=1.7, ndim_global=nd, pair_mode="random", seed=keys,
               offset=5)
    # (path, wrapper, module, kw, nsplits, label of the instantiation, the
    # instructions a walker needs: K5a a Philox block for its normal and
    # one for its pair, the stored normal, 3 a coordinate; K5b a Philox
    # block for its picks and ~10 a coordinate and 20 more)
    spec = {
        "de_propose": ("DEMove()", dk, k5a, 2, "de_propose.cu",
                       "emcee_tpu/moves/de.py:45-85 (vmapped by "
                       "emcee_tpu/parallel/tempering.py:538)",
                       "de_propose_kernel<false, true, true>",
                       2 * PHILOX_INSTR + NORMAL_INSTR + 3 * nd),
        "snooker_propose": ("DESnookerMove()", snk, k5b, 4,
                            "snooker_propose.cu",
                            "emcee_tpu/moves/de_snooker.py:78-139 "
                            "(vmapped by emcee_tpu/parallel/tempering.py:538)",
                            "snooker_propose_kernel<false, true, true>",
                            PHILOX_INSTR + 10 * nd + 20),
    }
    rows = []
    for kname, (path, mod, kw, ns, src, jax_src, label, instr) in (
            spec.items()):
        ng = nw // ns
        wrapper = getattr(mod, kname)
        plain = getattr(mod, f"{kname}_plain")
        call_ms = cuda_ms(torch, lambda: wrapper(coords, 0, ns, **kw))
        plain_ms = cuda_ms(torch, lambda: plain(coords, 0, ns, **kw), reps=20)
        q = torch.empty(T, ng, nd, device=dev)
        plan = de_plan(ng, nd, 0, n_sm, coords.data_ptr(), q.data_ptr(),
                       snooker=kname == "snooker_propose",
                       stage=kname == "de_propose", rungs=T, nsplits=ns)
        # Each input read once, each output written once: every rung's
        # ensemble (its own rows and its partners'), q and the factor.
        nbytes = 4 * T * (nw * nd + ng * nd + ng)
        nops = T * ng * instr
        t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": nops / ISSUE_PER_S * 1e3}
        by = max(t, key=t.get)
        regs = PTXAS.get(label)
        blocks = plan.grid * T
        waves = (blocks / (n_sm * resident_blocks(regs[0], plan.threads,
                                                  plan.smem + regs[1]))
                 if regs else None)
        w4 = out[path]["workload4"]
        ms = w4["win"]["ms_per_launch"][kname]
        launches = w4["replayed_launches"][kname]
        bvl = out[path]["batched_vs_loop"]
        name = f"{kname} (rung axis)"
        row = {"name": name, "route": "cuda",
               "source": f"emcee_tpu_torch/csrc/{src}", "replaces": jax_src,
               "launches": launches, "max_abs_err": 0.0, "ms": ms,
               "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": t[by],
               "bound_by": by, "library_ms": None, "ptxas": regs,
               "plan": plan._asdict(), "blocks": blocks, "waves": waves,
               "launches_per_proposal": launches / w4["proposals_counted"],
               "wrapper_launches": out["launches"][path][kname],
               "path_device_us_batched_loop": (bvl["device_us"][True],
                                               bvl["device_us"][False]),
               "path_kernels_batched_loop": (bvl["kernels"][True],
                                             bvl["kernels"][False]),
               "note": f"{name} at workload 4's shape ({T} x {nw} x {nd}, "
                       f"{ns} splits, random pairs): ms in {path}'s replays "
                       "(profiler); launches counted on the card in "
                       f"{w4['proposals_counted']} replayed proposals; "
                       "max_abs_err: bit for bit over phase 17's sweep; "
                       "bound: every rung's ensemble, q and the factor, "
                       "and the instructions a walker needs; library_ms: "
                       "none, no single PyTorch call computes it"}
        rows.append(row)
        log(f"phase 17: (e) {name}: device {ms * 1e3:.2f} us/launch in the "
            f"{path} replays, {call_ms * 1e3:.2f} us per back-to-back call, "
            f"plain {plain_ms * 1e3:.2f} us, bound {t[by] * 1e3:.3f} us "
            f"({nbytes} bytes, {by}); plan {tuple(plan)}, {regs} (registers,"
            f" static shared, spilled), {blocks} blocks, "
            f"{measured(waves, '.3f')} waves {card}")
    return rows


# -- 18. the gradient moves on every rung ------------------------------------
#: rungs, rows a rung and ndims of K11's, K12's and K13's rung-axis sweep
GR_SWEEP_T = (1, 2, 3, 16, 64)
GR_SWEEP_N = (1, 31, 256, 1000)
GR_SWEEP_ND = (1, 5, 8, 128)
#: phase 18's moves at workload 4's configuration
PT18_MOVES = ("MALAMove(0.8)", "HMCMove(0.5, n_leapfrog=10, jitter=0.2)",
              "EnsembleMALAMove()", "EnsembleHMCMove()")
#: each move's kernels a proposal at 16 rungs, every rung at once: the
#: whole-ensemble moves one K11 (MALA's step, HMC's momenta and jitter),
#: HMC n_leapfrog + 1 K13, one K12 and one K2; the ensemble moves per split
#: two K11 (the draw, then the step with z L^T) or one (the momenta) and
#: 2 n_leapfrog + 1 K13 (a full metric kicks and drifts in two launches),
#: one K12 and one K2, and the shuffle's K14, K16 and two K17
PT18_PER = {
    "MALAMove(0.8)": {"langevin_step": 1, "langevin_factor": 1,
                      "accept_select": 1, "pt_swap": 1},
    "HMCMove(0.5, n_leapfrog=10, jitter=0.2)": {
        "langevin_step": 1, "leapfrog": 11, "langevin_factor": 1,
        "accept_select": 1, "pt_swap": 1},
    "EnsembleMALAMove()": {"langevin_step": 4, "langevin_factor": 2,
                           "accept_select": 2, "pt_swap": 1,
                           "philox_draw": 1} | SHUF4,
    "EnsembleHMCMove()": {"langevin_step": 2, "leapfrog": 22,
                          "langevin_factor": 2, "accept_select": 2,
                          "pt_swap": 1, "philox_draw": 1} | SHUF4,
}
#: the moves whose batched path is held to the per-rung loop bit for bit
#: over 64 proposals.  The ensemble moves' batched matmuls and Cholesky
#: (each rung's complement covariance and its products by L) round
#: otherwise on the H100 than each rung's own, and their trajectories
#: amplify an ulp into a flipped acceptance within a few proposals (at
#: workload 4 the 64-proposal chains part within 7 and 2 kept steps;
#: PERF.md), so for them each rung's metric (C and L) of the batched path
#: is held to its own to PT18_TOL (relative to 1 + |value|), and one
#: proposal's difference is logged
PT18_EXACT = ("MALAMove(0.8)", "HMCMove(0.5, n_leapfrog=10, jitter=0.2)")
PT18_TOL = 1e-4
#: proposals a replay of the per-rung loop's timed graph (~8700 kernels a
#: proposal for HMC, ~11300 for the ensemble HMC: the loop's recording and
#: its profiled windows are the costliest part of the phase; PERF.md)
PT18_LOOP_N = 1


def pt18_move(label):
    """A fresh move of ``PT18_MOVES``."""
    from emcee_tpu_torch import moves

    return {"MALAMove(0.8)": lambda: moves.MALAMove(0.8),
            "HMCMove(0.5, n_leapfrog=10, jitter=0.2)":
                lambda: moves.HMCMove(0.5, n_leapfrog=10, jitter=0.2),
            "EnsembleMALAMove()": moves.EnsembleMALAMove,
            "EnsembleHMCMove()": moves.EnsembleHMCMove}[label]()


def grad_rung_sweep(torch, dev):
    """(a) K11, K12 and K13 with the rung axis against their plain
    versions, bit for bit (the bits compared): rungs ``GR_SWEEP_T``, rows
    a rung ``GR_SWEEP_N``, ndim ``GR_SWEEP_ND``, eps per rung; K11 drawing
    only, in MALA mode with the identity and a diagonal, each with and
    without the ``(T,)`` jitter, with injected ``z`` and from the stream at
    a host offset and at the device offset word, rows from 0 or 7; K12 in
    kinetic mode and in MALA mode with and without ``c`` and ``d``; K13
    with 0, 1 and 2 kicks, with and without the drift, both metrics.  At 3
    rungs each rung of K11, K12 and K13 is also held against the
    one-ensemble launch under its own key.  Returns the count of
    comparisons."""
    from emcee_tpu_torch.ops import langevin_kernel as lk
    from emcee_tpu_torch.ops.philox import DeviceOffset, rung_keys

    gen = torch.Generator(device=dev).manual_seed(180)
    offset = (1 << 33) + 7  # the offset's high word is set
    word = torch.tensor(offset - 2, dtype=torch.int64, device=dev)
    n = 0

    def same(got, want, what):
        nonlocal n
        if [a is None for a in got] != [b is None for b in want]:
            raise AssertionError(f"{what}: outputs differ in kind")
        same_bits([a for a in got if a is not None],
                  [b for b in want if b is not None], what)
        n += 1

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    for T in GR_SWEEP_T:
        keys = rung_keys(3000 + T, T, dev)
        for nw in GR_SWEEP_N:
            for nd in GR_SWEEP_ND:
                shape = (T, nw, nd)
                x, g, z, c = rnd(*shape), rnd(*shape), rnd(*shape), rnd(
                    *shape)
                eps = 0.2 + torch.rand(T, device=dev, generator=gen)
                d = 0.5 + torch.rand(nd, device=dev, generator=gen)
                row0 = 7 * ((nw + nd) % 2)
                what = f"K11-K13 rung sweep, T={T} n={nw} nd={nd}"
                draws = {"injected": 0, "host offset": offset,
                         "device offset": DeviceOffset(word, 2)}
                for draw, off in draws.items():
                    zin = z if draw == "injected" else None
                    for mode in ({}, dict(x=x, g=g, eps=eps),
                                 dict(x=x, g=g, eps=eps, d=d)):
                        for jitter in (False, True):
                            outs = []
                            for fn in (lk.langevin_step,
                                       lk.langevin_step_plain):
                                v = (torch.empty(T, device=dev) if jitter
                                     else None)
                                zz, qq = fn(shape, dev, seed=keys,
                                            offset=off, row0=row0, z=zin,
                                            v=v, v_split=1, **mode)
                                outs.append((zz, qq, v))
                            same(outs[0], outs[1],
                                 f"{what} K11 {draw} {sorted(mode)} "
                                 f"jitter {jitter}")
                            if T != 3 or draw == "device offset":
                                continue
                            for r in range(T):
                                one = {k: (t if k == "d" else t[r])
                                       for k, t in mode.items()}
                                v = (torch.empty((), device=dev) if jitter
                                     else None)
                                zz, qq = lk.langevin_step(
                                    (nw, nd), dev, seed=keys.seeds[r],
                                    offset=off, row0=row0,
                                    z=None if zin is None else zin[r], v=v,
                                    v_split=1, **one)
                                want = outs[0]
                                same((zz, qq, v),
                                     (want[0][r], None if want[1] is None
                                      else want[1][r],
                                      None if want[2] is None
                                      else want[2][r]),
                                     f"{what} K11 {draw} {sorted(mode)}: "
                                     f"rung {r} against one ensemble")
                for kw, cc in ((dict(), None), (dict(eps=eps), None),
                               (dict(eps=eps), c), (dict(eps=eps, d=d), c)):
                    got = lk.langevin_factor(z, g, cc, **kw)
                    same((got,), (lk.langevin_factor_plain(z, g, cc, **kw),),
                         f"{what} K12 {sorted(kw)} c {cc is not None}")
                    if T == 3:
                        for r in range(T):
                            one = dict(kw, eps=eps[r]) if kw else kw
                            same((lk.langevin_factor(
                                z[r], g[r], None if cc is None else cc[r],
                                **one),), (got[r],),
                                 f"{what} K12: rung {r} against one "
                                 "ensemble")
                for kicks in (0, 1, 2):
                    for drift in (False, True):
                        if not (kicks or drift):
                            continue
                        for dd in (None, d):
                            outs = []
                            for fn in (lk.leapfrog, lk.leapfrog_plain):
                                xx, pp = x.clone(), z.clone()
                                fn(pp, g, eps, d=dd, kicks=kicks,
                                   x=xx if drift else None)
                                outs.append((xx, pp))
                            same(outs[0], outs[1], f"{what} K13 kicks "
                                 f"{kicks} drift {drift} d {dd is not None}")
                            if T == 3:
                                for r in range(T):
                                    xx, pp = x[r].clone(), z[r].clone()
                                    lk.leapfrog(pp, g[r], eps[r], d=dd,
                                                kicks=kicks,
                                                x=xx if drift else None)
                                    same((xx, pp),
                                         (outs[0][0][r], outs[0][1][r]),
                                         f"{what} K13: rung {r} against one"
                                         " ensemble")
    torch.cuda.synchronize()
    return n


def pt18_rel(a, b):
    """The largest ``|a - b|`` relative to ``1 + |b|``."""
    return float(((a - b).abs() / (1 + b.abs())).max())


def pt18_proposal_diff(smp, offset=3):
    """An ensemble move's metric and one proposal of every rung at once
    against each rung's own (the per-rung loop's), from the state in
    ``smp``'s workspace, both blocked splits, the draws from the stream:
    the largest differences (:func:`pt18_rel`) of each rung's complement
    covariance ``C`` and its Cholesky factor ``L`` (one batched product
    and Cholesky against the rung's own) and of ``q`` and the factors."""
    from emcee_tpu_torch.moves.gradient import complement_chol
    from emcee_tpu_torch.moves.walk import complement

    prog = smp._program
    ws, mv = prog.ws, smp._moves[0]
    ng = ws.coords.shape[1] // mv.nsplits
    worst = dict(C=0.0, L=0.0, q=0.0, factors=0.0)
    for split in range(mv.nsplits):
        c = complement(ws.coords, split, ng)
        metric = complement_chol(c, mv.ridge)
        q, f = mv.get_proposal((prog.keys, offset), ws.coords, split,
                               prog.model(ws))
        for r, seed in enumerate(prog.keys.seeds):
            one = complement_chol(c[r], mv.ridge) + mv.get_proposal(
                (seed, offset), ws.coords[r], split, prog.model(ws, r))
            both = (metric[0][r], metric[1][r], q[r], f[r])
            for k, a, b in zip(worst, one, both):
                worst[k] = max(worst[k], pt18_rel(a, b))
    return worst


def pt18_path(torch, np, dev, card, label, p0, n_c=16, n_l=PT18_LOOP_N):
    """(b)-(c) of phase 18 for one move at workload 4's configuration: over
    64 proposals the graph chain (every rung at once) against the plain
    versions' eager chain, bit for bit, and for ``PT18_EXACT`` against the
    per-rung loop run eagerly on the kernels, bit for bit (else the metric
    held and one proposal measured by :func:`pt18_proposal_diff`); both
    paths timed in turns (batched, loop, loop, batched; ``n_c`` proposals
    a batched replay, ``n_l`` a loop one): host µs and device µs and
    kernels a proposal; the batched path's launches counted by device
    words and its kernels' device time a launch in its replays
    (profiler)."""
    out = {}
    ends = {}
    t0 = time.perf_counter()
    runs = ("graph", "plain") + (("loop",) if label in PT18_EXACT else ())
    for run in runs:
        smp = pt_sampler(dev, seed=57, move=pt18_move(label))
        smp._use_graphs = run == "graph"
        smp._batched = run != "loop"
        with plain_kernels() if run == "plain" else contextlib.nullcontext():
            ends[run] = pt_runs(smp, p0)
        if run == "graph":
            batched = smp
    same_ends(np, ends["graph"], ends["plain"],
              f"{label}: graph-replayed and eager plain chains")
    if label in PT18_EXACT:
        same_ends(np, ends["graph"], ends["loop"],
                  f"{label}: the batched path and the per-rung loop")
    else:
        out["proposal_diff"] = d = pt18_proposal_diff(batched)
        if not max(d["C"], d["L"]) <= PT18_TOL:
            raise AssertionError(
                f"phase 18: {label}: every rung's metric at once against "
                f"each rung's own: {d} above {PT18_TOL}")
    out["swaps_64"] = ends["graph"][4].tolist()
    seconds = {"chains": time.perf_counter() - t0}
    t0 = time.perf_counter()
    loop = pt_sampler(dev, seed=58, move=pt18_move(label))
    loop._batched = False
    loop.run_mcmc(p0, n_l, store=False,  # records the timed graph
                  skip_initial_state_check=True)
    batched.run_mcmc(None, n_c, store=False)  # records the timed graph
    host = {True: [], False: []}
    dev_us = {True: [], False: []}
    kernels = {True: [], False: []}
    for is_batched in (True, False, False, True):
        smp, n = (batched, n_c) if is_batched else (loop, n_l)
        _, dt = drive(smp, None, n, store=False)
        host[is_batched].append(dt / n * 1e6)
        win = busy_window(torch, lambda: smp.run_mcmc(None, n, store=False),
                          n, f"{label} {'batched' if is_batched else 'loop'}")
        dev_us[is_batched].append(win["device_us_per_proposal"])
        kernels[is_batched].append(win["kernels_per_proposal"])
    del loop
    seconds["turns"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    per = PT18_PER[label]
    win = busy_window(torch, lambda: batched.run_mcmc(None, n_c,
                                                      store=False),
                      n_c, f"{label} batched, its kernels", names=per)
    counted, profiled = counted_replays(
        torch, dev, batched, n_c,
        lambda r: {k: v * n_c for k, v in per.items()}, f"{label} batched",
        store=False)
    seconds["counts"] = time.perf_counter() - t0
    out.update(host_us=host, device_us=dev_us, kernels=kernels, win=win,
               replayed_launches=counted, profiled_replayed=profiled,
               proposals_counted=n_c, loop_proposals_a_replay=n_l,
               seconds={k: round(v, 1) for k, v in seconds.items()})
    return out


def pt18_stored(torch, np, dev, card, p0, kept=512, thin=4):
    """(d) ``MALAMove(0.8)`` at workload 4's configuration into
    ``PTDeviceBackend``, 512 kept x 4 (the best of two timed runs):
    walker-steps/s, the cold rung's tau and ESS/s; held: a finite chain
    and tau, and ``PTDeviceBackend`` == ``PTBackend`` from one seed.  The
    swap acceptance and the cold mode fraction are printed beside phase
    14's windows, unheld: at this step they are the sampler's, not the
    kernels'."""
    from emcee_tpu_torch.backends import PTBackend, PTDeviceBackend

    label = "MALAMove(0.8)"
    smp = pt_sampler(dev, move=pt18_move(label), backend=PTDeviceBackend())
    st, _ = drive(smp, p0, kept, thin_by=thin, skip_initial_state_check=True)
    warm_graphs(smp)
    dt = float("inf")
    for _ in range(2):  # workloads5.py:224-233: the best of two
        smp.reset()
        st, dt_run = drive(smp, st, kept, thin_by=thin,
                           skip_initial_state_check=True)
        dt = min(dt, dt_run)
    n_prop = kept * thin
    chain = smp.get_chain()
    cold = chain[:, 0]
    tau = tau_of(np, cold, thin)
    if not (np.all(np.isfinite(chain)) and np.isfinite(tau)):
        raise AssertionError(f"phase 18: {label}: a chain or tau that is "
                             f"not finite (tau {tau})")
    x0 = cold[..., 0]
    res = dict(walker_steps_per_s=NT4 * NW4 * n_prop / dt, seconds=dt,
               tau_cold=tau, ess_per_s_cold=NW4 * (n_prop / dt) / tau,
               tau_reliable=bool(n_prop / tau >= 30.0),
               swap_acceptance_mean=float(np.mean(
                   smp.tswap_acceptance_fraction)),
               cold_mode_fraction=float(np.mean(x0 > 0)),
               cold_acceptance=float(smp.acceptance_fraction[0].mean()))
    chains = []
    for backend in (PTDeviceBackend(), PTBackend()):
        s2 = pt_sampler(dev, seed=59, backend=backend, move=pt18_move(label))
        s2.run_mcmc(p0, 64, thin_by=thin, skip_initial_state_check=True)
        chains.append((s2.get_chain().astype(np.float64),
                       s2.get_log_like().astype(np.float64),
                       s2.get_log_prior().astype(np.float64),
                       s2.backend.accepted, s2.swaps_accepted,
                       s2.swaps_proposed, np_of(s2.backend.random_state)))
    same_ends(np, *chains, f"{label}: PTDeviceBackend and PTBackend chains")
    return res


def phase18(torch, np, dev, card):
    """The gradient moves on every rung (see the module docstring, 18): the
    sweep of K11, K12 and K13 with the rung axis, then ``MALAMove(0.8)``,
    ``HMCMove(0.5, n_leapfrog=10, jitter=0.2)``, ``EnsembleMALAMove()``
    and ``EnsembleHMCMove()`` at workload 4's configuration, each path's
    kernel launches counted from 0 just before it, ``MALAMove(0.8)``
    stored, and the rows of K11, K12 and K13 with the rung axis.  Returns
    its numbers and the rows."""
    out = {}
    t0 = time.perf_counter()
    out["sweep"] = grad_rung_sweep(torch, dev)
    log(f"phase 18: (a) K11, K12 and K13 with the rung axis against their "
        f"plain versions (rungs {GR_SWEEP_T}, rows a rung {GR_SWEEP_N}, "
        f"ndim {GR_SWEEP_ND}, eps per rung; K11 drawing and in MALA mode "
        f"(identity, diagonal) with and without the jitter, injected / "
        f"host offset / device offset draws; K12 both modes; K13 0-2 kicks "
        f"with and without the drift; each rung at 3 rungs against the "
        f"one-ensemble launch): {out['sweep']} comparisons, all bit for "
        f"bit ({time.perf_counter() - t0:.1f} s)")
    p0 = pt_p0(np)
    for label in PT18_MOVES:
        t0 = time.perf_counter()
        names = tuple(k for k in PT18_PER[label] if k != "philox_draw")
        with path_launches(out, label, names, "phase 18"):
            r = out[label] = pt18_path(torch, np, dev, card, label, p0)
        if label in PT18_EXACT:
            held = ("equal the per-rung loop (run eagerly on the kernels) "
                    "bit for bit")
        else:
            d = r["proposal_diff"]
            held = (f"against the per-rung loop, from one state, both "
                    f"splits, relative to 1 + |value|: each rung's "
                    f"complement covariance and Cholesky factor within "
                    f"{d['C']:.3e} and {d['L']:.3e} of its own (held to "
                    f"{PT18_TOL}), one proposal's q and factors within "
                    f"{d['q']:.3e} and {d['factors']:.3e}")
        log(f"phase 18: (b) {label} at {NT4} x {NW4} x {ND4}: 64 "
            f"graph-replayed proposals of every rung at once equal the "
            f"plain versions' eager chain bit for bit, and {held} (swaps "
            f"{r['swaps_64']})")
        log(f"phase 18: (c) {label} in turns (batched, loop, loop, batched; "
            f"replays of {r['proposals_counted']} and "
            f"{r['loop_proposals_a_replay']} proposals), a proposal: host {[round(x, 1) for x in r['host_us'][True]]} / "
            f"{[round(x, 1) for x in r['host_us'][False]]} us, device "
            f"{[measured(x) for x in r['device_us'][True]]} / "
            f"{[measured(x) for x in r['device_us'][False]]} us, kernels "
            f"{[measured(x, '.0f') for x in r['kernels'][True]]} / "
            f"{[measured(x, '.0f') for x in r['kernels'][False]]} (batched "
            f"/ loop); batched launches in {r['proposals_counted']} "
            f"proposals {r['replayed_launches']} (device words; exactly "
            f"{PT18_PER[label]} a proposal); us a launch in its replays: "
            + ", ".join(f"{k} {measured(v and v * 1e3, '.3f')}"
                        for k, v in r["win"]["ms_per_launch"].items())
            + f" {card} ({time.perf_counter() - t0:.1f} s: "
            f"{r['seconds']})")
    t0 = time.perf_counter()
    with path_launches(out, "stored", ("langevin_step", "langevin_factor",
                                       "accept_select", "pt_swap"),
                       "phase 18"):
        w4 = out["stored"] = pt18_stored(torch, np, dev, card, p0)
    log(f"phase 18: (d) MALAMove(0.8), workload 4's configuration, "
        f"PTDeviceBackend, 512 kept x 4: {w4['walker_steps_per_s']:.4e} "
        f"walker-steps/s over all rungs (best of two), cold tau "
        f"{w4['tau_cold']:.2f} proposals, cold ESS/s "
        f"{w4['ess_per_s_cold']:.4e}, tau_reliable {w4['tau_reliable']}; "
        f"beside phase 14's windows (not held: the sampler's at this step): "
        f"swap acceptance mean {w4['swap_acceptance_mean']:.3f} (0.4-0.9), "
        f"cold mode fraction {w4['cold_mode_fraction']:.3f} (0.25-0.75); "
        f"cold acceptance {w4['cold_acceptance']:.3f}; PTDeviceBackend == "
        f"PTBackend bit for bit {card} ({time.perf_counter() - t0:.1f} s)")
    log(f"phase 18: kernel wrapper launches of each path, counted from 0 "
        f"(recordings and eager runs): {out['launches']}")
    return out, phase18_rows(torch, dev, out, card)


def phase18_rows(torch, dev, out, card):
    """(e) The rows of K11, K12 and K13 with the rung axis at workload 4's
    shape: device time a launch in a path's replays (profiler: K11 and K12
    in ``MALAMove(0.8)``'s, K13 in HMC's), launches counted by device
    words there, a back-to-back call's time and the plain version's (CUDA
    events), registers, and the least time the card could take."""
    from emcee_tpu_torch.ops import langevin_kernel as lk
    from emcee_tpu_torch.ops._wrap import device_sm_count
    from emcee_tpu_torch.ops.philox import rung_keys

    T, nw, nd = NT4, NW4, ND4
    gen = torch.Generator(device=dev).manual_seed(181)
    x, g, gq, p = (torch.randn(T, nw, nd, device=dev, generator=gen)
                   for _ in range(4))
    eps = 0.5 + torch.rand(T, device=dev, generator=gen)
    keys = rung_keys(4, T, dev)
    elems, rows = T * nw * nd, T * nw
    items = rows * ((nd + 1) // 2)
    mala, hmc = PT18_MOVES[0], PT18_MOVES[1]
    spec = {
        "langevin_step": (
            lambda: lk.langevin_step((T, nw, nd), dev, seed=keys, offset=2,
                                     x=x, g=g, eps=eps),
            lambda: lk.langevin_step_plain((T, nw, nd), dev, seed=keys,
                                           offset=2, x=x, g=g, eps=eps),
            "langevin_step.cu", "emcee_tpu/moves/gradient.py:218-225", mala,
            "langevin_step_kernel<true, true, false, true>",
            # x, g in; z, q out
            4 * 4 * elems,
            instruction_bound(items * PHILOX_INSTR
                              + elems * (NORMAL_INSTR + 2),
                              elems * NORMAL_SFU)),
        "langevin_factor": (
            lambda: lk.langevin_factor(p, g, gq, eps=eps),
            lambda: lk.langevin_factor_plain(p, g, gq, eps=eps),
            "langevin_factor.cu", "emcee_tpu/moves/gradient.py:233-237",
            mala, "langevin_factor_kernel<true>",
            # z, g_x, g_q in; the factors out
            4 * (3 * elems + rows), 9 * elems / F32_OPS_PER_S * 1e3),
        "leapfrog": (
            lambda: lk.leapfrog(p, g, eps, kicks=2, x=x),
            lambda: lk.leapfrog_plain(p, g, eps, kicks=2, x=x),
            "leapfrog.cu", "emcee_tpu/moves/gradient.py:314-324", hmc,
            "leapfrog_kernel<true>",
            # x, p, g in; x, p out (two kicks and the drift)
            4 * 5 * elems, 5 * elems / F32_OPS_PER_S * 1e3),
    }
    rows_out = []
    for kname, (kernel, plain, src, jax_src, path, label, nbytes,
                ops_ms) in spec.items():
        call_ms = cuda_ms(torch, kernel)
        plain_ms = cuda_ms(torch, plain, reps=20)
        t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": ops_ms}
        by = max(t, key=t.get)
        r = out[path]
        ms = r["win"]["ms_per_launch"][kname]
        launches = r["replayed_launches"][kname]
        regs = PTXAS.get(label)
        name = f"{kname} (rung axis)"
        row = {"name": name, "route": "cuda",
               "source": f"emcee_tpu_torch/csrc/{src}",
               "replaces": f"{jax_src} (vmapped by "
                           "emcee_tpu/parallel/tempering.py:538)",
               "launches": launches, "max_abs_err": 0.0, "ms": ms,
               "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": t[by],
               "bound_by": by, "library_ms": None, "ptxas": regs,
               "launches_per_proposal": launches / r["proposals_counted"],
               "wrapper_launches": out["launches"][path][kname],
               "path_device_us_batched_loop": (r["device_us"][True],
                                               r["device_us"][False]),
               "path_kernels_batched_loop": (r["kernels"][True],
                                             r["kernels"][False]),
               "note": f"{name} at workload 4's shape ({T} x {nw} x {nd}): "
                       f"ms in {path}'s replays (profiler); launches "
                       f"counted on the card in {r['proposals_counted']} "
                       "replayed proposals; max_abs_err: bit for bit over "
                       "phase 18's sweep; bound: each input read once and "
                       "each output written once, and the operations (K11: "
                       "the instructions the function needs); library_ms: "
                       "none, no single PyTorch call computes it"}
        if kname == "langevin_step":
            plan = lk.langevin_plan(nw, device_sm_count(dev), T)
            row.update(plan=tuple(plan), blocks=plan.grid * T)
        rows_out.append(row)
        log(f"phase 18: (e) {name}: device {measured(ms and ms * 1e3, '.2f')}"
            f" us/launch in the {path} replays, {call_ms * 1e3:.2f} us per "
            f"back-to-back call, plain {plain_ms * 1e3:.2f} us, bound "
            f"{t[by] * 1e3:.3f} us ({nbytes} bytes, {by}); {regs} "
            f"(registers, static shared, spilled) {card}")
    return rows_out


# -- 19. K7, the KDE log-density ---------------------------------------------
#: one-ensemble shapes (rows, kernels, ndim) of K7's sweep: ragged lanes
#: (kernels not a multiple of 32), one kernel, ndim 1-8 in registers and
#: 9-128 through shared memory (128: above 48 KB, the kernel's opt-in), and
#: the main path's launch (s and q of a split stacked: 1e5 rows, 5e4
#: kernels)
K7_SWEEP = ((1, 1, 1), (31, 33, 3), (1000, 31, 1), (7, 2000, 2),
            (257, 100, 8), (100, 77, 9), (64, 300, 17), (40, 129, 128),
            (5003, 1000, 5), (NW, NW // 2, ND))
#: forced plans (rows a warp, warps, tile) held to the plain version beside
#: the wrapper's own on the small shapes
K7_SWEEP_PLANS = ((1, 4, 32), (2, 8, 64), (3, 1, 128), (8, 2, 96))
#: rungs, and shapes (rows, kernels, ndim) a rung, of the rung axis's sweep
K7R_SWEEP_T = (1, 2, 3, 16, 64)
K7R_SWEEP = ((256, 128, 5), (33, 47, 3), (10, 70, 12))
#: rows a warp timed at the main path's shape (eagerly, tiles 64 and 256)
#: and on workload 4's ladder (in its replays)
K7_TIME_ROWS = (1, 2, 4, 8)
K7_TIME_TILES = (64, 256)
#: each rung's complement covariance and Cholesky factor on the batched
#: path against its own (the per-rung loop's), relative to 1 + |value|,
#: where the batched products round otherwise (PT18_TOL's rule)
PT19_TOL = 1e-4
#: KDEMove()'s kernels a proposal at 1e5 walkers and on workload 4's
#: ladder (every rung at once): K7 and K2 a split, K14 the shuffle's sort
#: keys and a split's kernel centres and noise, K15 the swap, K16 and K17
#: the shuffle's order and rows (at 1e5 walkers K16's long route:
#: :func:`shuffle_per`, added where it is used)
PT19_PER = {"kde_logpdf": 2, "accept_select": 2, "philox_draw": 5,
            "pt_swap": 1} | SHUF4
MAIN19_PER = {"kde_logpdf": 2, "accept_select": 2, "philox_draw": 5}
#: proposals a replay of the per-rung loop's timed graph
PT19_LOOP_N = 4


def slow_ms(torch, fn, reps=2):
    """Mean time of one call of a slow ``fn`` (tens of ms or more) on the
    card by CUDA events, after one warm-up call."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def forced_kde_plan(rows, warps, tile):
    """K7's wrapper launching with ``rows`` a warp, ``warps`` a block and
    tiles of ``tile`` kernels (the shared memory its layout needs)."""
    from emcee_tpu_torch.ops import kde_kernel as kk

    saved = kk.kde_plan

    def plan(n, nd, n_sm, rungs=1):
        return kk.KDEPlan(rows, warps, tile, kk.kde_smem(nd, rows, warps,
                                                        tile))

    kk.kde_plan = plan
    try:
        yield
    finally:
        kk.kde_plan = saved


def blocked_logpdf(torch, x, c, chol, block_bytes=256 << 20):
    """The route K7 had before its kernel (``moves/kde.py`` until this
    slice), kept here as the "before" yardstick: triangular solves, the
    ``ns x nc`` cross term by ``torch.matmul`` in row blocks of
    ``block_bytes``, and ``torch.logsumexp`` over each block."""
    n, nd = x.shape
    nc = c.shape[0]
    xw = torch.linalg.solve_triangular(chol, x.T, upper=False).T
    cw = torch.linalg.solve_triangular(chol, c.T, upper=False).T
    x2 = (xw**2).sum(dim=1, keepdim=True)
    c2 = (cw**2).sum(dim=1)[None, :]
    lognorm = (math.log(nc) + 0.5 * nd * math.log(2.0 * math.pi)
               + torch.log(torch.diagonal(chol)).sum())
    rows = max(1, block_bytes // (nc * x.element_size()))
    out = []
    for lo in range(0, n, rows):
        d2 = x2[lo:lo + rows] + c2 - 2.0 * (xw[lo:lo + rows] @ cw.T)
        out.append(torch.logsumexp(-0.5 * d2, dim=1))
    return torch.cat(out) - lognorm


def k7_sweep(torch, dev):
    """(a) K7 against its plain version, bit for bit (the bits compared,
    NaN included): ``K7_SWEEP``'s one-ensemble shapes by the wrapper's
    plan, the small ones also by ``K7_SWEEP_PLANS``; a NaN factor through
    ``moves/kde.py`` (whitening and all); rows far from every kernel (each
    exp below float32's range); and the rung axis (``K7R_SWEEP_T`` rungs
    of ``K7R_SWEEP``'s shapes, each rung of 3 also against the
    one-ensemble launch).  Returns the count of comparisons."""
    from emcee_tpu_torch.moves import kde as kde_mod
    from emcee_tpu_torch.moves.walk import cholesky_or_nan, cov
    from emcee_tpu_torch.ops import kde_kernel as kk

    gen = torch.Generator(device=dev).manual_seed(190)
    n_cmp = 0

    def same(got, want, what):
        nonlocal n_cmp
        same_bits([got], [want], what)
        n_cmp += 1

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=dev, generator=gen)

    for n, nc, nd in K7_SWEEP:
        x, c = rnd(n, nd), rnd(nc, nd, scale=1.5)
        norm = rnd(())
        want = kk.kde_logpdf_plain(x, c, norm)
        what = f"K7 sweep n={n} nc={nc} nd={nd}"
        same(kk.kde_logpdf(x, c, norm), want, what)
        if n * nc <= 1 << 22:
            for rows, warps, tile in K7_SWEEP_PLANS:
                with forced_kde_plan(rows, warps, tile):
                    same(kk.kde_logpdf(x, c, norm), want,
                         f"{what} plan {(rows, warps, tile)}")
        far = x + 300.0  # every term below float32's exp range
        same(kk.kde_logpdf(far, c, norm), kk.kde_logpdf_plain(far, c, norm),
             f"{what}, far rows")
    # A complement that is not positive definite: a NaN factor, NaN rows.
    x, c = rnd(100, 3), rnd(64, 3)
    bad = cholesky_or_nan(torch.tensor([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0],
                                        [0.0, 0.0, 1.0]], device=dev))
    got = kde_mod.kde_logpdf(x, c, bad)
    with plain_kernels():
        want = kde_mod.kde_logpdf(x, c, bad)
    if not bool(torch.isnan(got).all()):
        raise AssertionError("K7 sweep: a NaN factor gave rows not NaN")
    same(got, want, "K7 sweep, a NaN factor")
    # Through the move's route: whitening, the normaliser, s and q stacked.
    x, c = rnd(5000, 5), rnd(5000, 5)
    chol = cholesky_or_nan(5000 ** (-2.0 / 9) * cov(c))
    got = kde_mod._logpdfs((x[:2500], x[2500:]), c, chol)
    with plain_kernels():
        want = kde_mod._logpdfs((x[:2500], x[2500:]), c, chol)
    for g, w in zip(got, want):
        same(g, w, "K7 sweep, s and q stacked through moves/kde.py")
    for T in K7R_SWEEP_T:
        for n, nc, nd in K7R_SWEEP:
            x, c = rnd(T, n, nd), rnd(T, nc, nd, scale=1.5)
            norm = rnd(T)
            if T == 3:
                x[2, n // 2, 0] = float("nan")  # one rung's row NaN
            got = kk.kde_logpdf(x, c, norm)
            what = f"K7 rung sweep T={T} n={n} nc={nc} nd={nd}"
            same(got, kk.kde_logpdf_plain(x, c, norm), what)
            with forced_kde_plan(1, 8, 32):
                same(kk.kde_logpdf(x, c, norm), got, f"{what}, plan 1-8-32")
            if T == 3:
                for r in range(T):
                    same(kk.kde_logpdf(x[r], c[r], norm[r]), got[r],
                         f"{what}: rung {r} against one ensemble")
    torch.cuda.synchronize()
    return n_cmp


def k7_alone(torch, dev, card):
    """(b) K7 alone at phase 10's shape (one split of 1e5 walkers: 5e4
    rows under 5e4 kernels, ndim 5): the kernel a log-density and as the
    path launches it (s and q stacked, 1e5 rows), the plain version, the
    old blocked route ("before", ``blocked_logpdf``), each route's peak
    memory, the bound, and rows a warp x tiles timed.  Every time here is
    by CUDA events around back-to-back calls (a launch is milliseconds,
    its host cost tens of microseconds): late in the whole script the
    profiler has recorded no launch of three in a window, six windows in
    a row."""
    from emcee_tpu_torch.moves import kde as kde_mod
    from emcee_tpu_torch.moves.walk import cholesky_or_nan, cov
    from emcee_tpu_torch.ops import kde_kernel as kk
    from emcee_tpu_torch.ops._wrap import device_sm_count

    gen = torch.Generator(device=dev).manual_seed(23)
    ng = NW // 2
    torch.cuda.empty_cache()
    x = torch.randn(2 * ng, ND, device=dev, generator=gen)
    c = torch.randn(ng, ND, device=dev, generator=gen)
    chol = cholesky_or_nan(ng ** (-2.0 / (ND + 4)) * cov(c))
    s = x[:ng]
    out = {}

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    one = lambda: kde_mod.kde_logpdf(s, c, chol)  # noqa: E731
    stacked = lambda: kde_mod._logpdfs((s, x[ng:]), c, chol)  # noqa: E731
    before = lambda: blocked_logpdf(torch, s, c, chol)  # noqa: E731
    got, old = one(), before()
    out["max_abs_diff_before"] = float((got - old).abs().max())
    out["ms"] = slow_ms(torch, one, reps=5)
    out["ms_stacked"] = slow_ms(torch, stacked, reps=5)
    out["ms_before"] = slow_ms(torch, before, reps=3)
    with plain_kernels():
        out["plain_ms"] = slow_ms(torch, one, reps=1)
    out["peak_bytes"] = peak(one)
    out["peak_bytes_before"] = peak(before)
    # K7 itself, without the whitening.
    xw, cw = kde_mod._whiten(x, chol), kde_mod._whiten(c, chol)
    norm = torch.zeros((), device=dev)
    sweep = {}
    for rows in K7_TIME_ROWS:
        for tile in K7_TIME_TILES:
            with forced_kde_plan(rows, kk.KDE_WARPS, tile):
                sweep[(rows, tile)] = slow_ms(
                    torch, lambda: kk.kde_logpdf(xw, cw, norm), reps=3)
    out["plan"] = tuple(kk.kde_plan(2 * ng, ND, device_sm_count(dev)))
    out["kernel_ms_stacked"] = slow_ms(
        torch, lambda: kk.kde_logpdf(xw, cw, norm), reps=5)
    xw1 = xw[:ng]
    out["kernel_ms_one"] = slow_ms(
        torch, lambda: kk.kde_logpdf(xw1, cw, norm), reps=5)
    out["plan_sweep_ms"] = {f"{r}x{t}": v for (r, t), v in sweep.items()}
    # Bound: what the function needs.  Bytes: the rows and kernels read
    # once, the log-densities written once.  Operations, per pair of a
    # row and a kernel: the cross term (2 ND), the squared distance (3),
    # the scale (1), logsumexp's max, subtract and sum (3) at the float32
    # rate, and one exponential at the special-function rate.
    for key, rows in (("", ng), ("_stacked", 2 * ng)):
        pairs = rows * ng
        t = {"bytes": 4 * ((rows + ng) * ND + ND * ND + rows)
             / HBM_BYTES_PER_S * 1e3,
             "operations": max(pairs * (2 * ND + 7) / F32_OPS_PER_S,
                               pairs / SFU_OPS_PER_S) * 1e3}
        by = max(t, key=t.get)
        out[f"bound_ms{key}"], out[f"bound_by{key}"] = t[by], by
        out[f"bound_ms_bytes{key}"] = t["bytes"]
    out["matrix_bytes_ms"] = 2 * ng * ng * 4 / HBM_BYTES_PER_S * 1e3
    log(f"phase 19: (b) K7 at {ng} x {ng} x {ND}: {out['ms']:.3f} ms a "
        f"log-density with its whitening ({out['kernel_ms_one']:.3f} ms the "
        f"kernel alone), {out['ms_stacked']:.3f} ms s and q stacked as the "
        f"path launches it ({out['kernel_ms_stacked']:.3f} ms the kernel; "
        f"plan {out['plan']}); before (the blocked matmul + "
        f"logsumexp route) {out['ms_before']:.3f} ms, max abs diff "
        f"{out['max_abs_diff_before']:.3g}; plain version "
        f"{out['plain_ms']:.1f} ms; peak memory {out['peak_bytes']} B "
        f"(before {out['peak_bytes_before']} B); bound {out['bound_ms']:.3f}"
        f" ms a log-density ({out['bound_by']}; bytes "
        f"{out['bound_ms_bytes']:.4f} ms), {out['bound_ms_stacked']:.3f} ms "
        f"stacked; the matrix written and read once "
        f"{out['matrix_bytes_ms']:.3f} ms {card}")
    log("phase 19: (b) K7 ms a stacked launch by rows a warp x tile "
        "(CUDA events): " + ", ".join(
            f"{k} {v:.3f}" for k, v in out["plan_sweep_ms"].items())
        + f" {card}")
    return out


def k7_main(torch, np, dev, card, n=16, n_prof=2):
    """(c) ``KDEMove()`` at 1e5 walkers x 5-D (phase 10's configuration):
    walker-steps/s graph against eager in turns (eager, graph, graph,
    eager; ``n`` proposals each), device µs and kernels a proposal and
    K7's device time a launch in a profiled window of replays, and the
    replayed launches counted by device words, exactly ``MAIN19_PER`` a
    proposal."""
    from emcee_tpu_torch import EnsembleSampler, moves

    per = MAIN19_PER | shuffle_per(1, NW)
    p0 = np.random.default_rng(3).normal(size=(NW, ND)).astype(np.float32)
    smps = {}
    for graphs in (False, True):
        smp = smps[graphs] = EnsembleSampler(
            NW, ND, gaussian, vectorize=True, seed=19, device=dev,
            moves=moves.KDEMove())
        smp._use_graphs = graphs
        drive(smp, p0, 2, per_proposal=per, store=False,
              skip_initial_state_check=True)
    smps[True]._program.graph(0, n, False)
    smps[True]._program.graph(0, n_prof, False)
    rates = {False: [], True: []}
    for graphs in (False, True, True, False):
        _, dt = drive(smps[graphs], None, n, per_proposal=per,
                      store=False)
        rates[graphs].append(n * NW / dt)
    smp = smps[True]
    mean_lp = float(smp._previous_state.log_prob.mean())
    if not -3.5 < mean_lp < -1.5:  # bench.py:161
        raise AssertionError(f"phase 19: KDEMove() mean log-prob {mean_lp}")
    win = busy_window(torch, lambda: smp.run_mcmc(None, n_prof, store=False),
                      n_prof, "KDEMove() at 1e5", names=per)
    counted, _ = counted_replays(
        torch, dev, smp, n_prof,
        lambda r: {k: v * n_prof for k, v in per.items()},
        "KDEMove() at 1e5", store=False)
    out = dict(rates=rates, mean_lp=mean_lp, win=win,
               replayed_launches=counted, proposals_counted=n_prof,
               acceptance=float(smp.last_run_stats.acceptance_fraction
                                .mean()))
    log(f"phase 19: (c) KDEMove() at {NW} x {ND}: walker-steps/s in turns "
        f"eager {rates[False][0]:.4e}, graph {rates[True][0]:.4e}, graph "
        f"{rates[True][1]:.4e}, eager {rates[False][1]:.4e}; mean lp "
        f"{mean_lp:.4f}, acceptance {out['acceptance']:.4f}; a proposal: "
        f"device {measured(win['device_us_per_proposal'])} us, "
        f"{measured(win['kernels_per_proposal'], '.0f')} kernels, idle "
        f"share {measured(win['idle'], '.4f')}; K7 "
        f"{measured(win['ms_per_launch']['kde_logpdf'], '.3f')} ms a launch "
        f"in the replays; replayed launches in {n_prof} proposals "
        f"{ {k: v for k, v in counted.items() if v} } (device words; "
        f"exactly {per} a proposal) {card}")
    return out


def pt19_sampler(dev, seed, backend=None):
    """Workload 4's sampler with ``KDEMove()``."""
    from emcee_tpu_torch import moves

    return pt_sampler(dev, seed=seed, backend=backend, move=moves.KDEMove())


def pt19_metric_diff(smp, offset=3):
    """``KDEMove()``'s kernel covariance and Cholesky factor of every rung
    at once against each rung's own, from the state in ``smp``'s
    workspace, both blocked splits, and one proposal's ``q`` and factors
    (the draws from the stream): the largest differences relative to ``1 +
    |value|`` (:func:`pt18_rel`)."""
    from emcee_tpu_torch.moves.walk import cholesky_or_nan, complement, cov

    prog = smp._program
    ws, mv = prog.ws, smp._moves[0]
    ng = ws.coords.shape[1] // mv.nsplits
    worst = dict(C=0.0, L=0.0, q=0.0, factors=0.0)
    for split in range(mv.nsplits):
        c = complement(ws.coords, split, ng)
        k = mv._factor(c.shape[-2], c.shape[-1]) ** 2
        C = k * cov(c)
        L = cholesky_or_nan(C)
        q, f = mv.get_proposal((prog.keys, offset), ws.coords, split,
                               prog.model(ws))
        for r, seed in enumerate(prog.keys.seeds):
            Cr = k * cov(c[r])
            one = (Cr, cholesky_or_nan(Cr)) + mv.get_proposal(
                (seed, offset), ws.coords[r], split, prog.model(ws, r))
            for key, a, b in zip(worst, one, (C[r], L[r], q[r], f[r])):
                worst[key] = max(worst[key], pt18_rel(a, b))
    return worst


def pt19_path(torch, np, dev, card, p0, n_c=16, n_l=PT19_LOOP_N, kept=512,
              thin=4):
    """(d) ``KDEMove()`` at workload 4's configuration: over 64 proposals
    the graph chain (every rung at once) against the plain versions' eager
    chain, bit for bit, and against the per-rung loop (bit for bit, or
    where the batched products round otherwise each rung's kernel
    covariance and factor held to ``PT19_TOL`` and the first kept step
    where the chains part logged); both paths in turns (batched, loop,
    loop, batched): host µs, device µs and kernels a proposal; the batched
    path's launches counted by device words (``PT19_PER``); K7's device
    time a launch in the replays at every rows a warp of
    ``K7_TIME_ROWS``; then 512 kept x 4 into ``PTDeviceBackend`` with phase
    14's checks."""
    from emcee_tpu_torch.backends import PTDeviceBackend
    from emcee_tpu_torch.ops import kde_kernel as kk
    from emcee_tpu_torch.ops._wrap import device_sm_count

    out = {}
    t0 = time.perf_counter()
    ends = []
    for plain in (False, True):
        smp = pt19_sampler(dev, 67)
        smp._use_graphs = not plain
        with plain_kernels() if plain else contextlib.nullcontext():
            ends.append(pt_runs(smp, p0))
    same_ends(np, *ends, "KDEMove(): graph-replayed and eager plain chains")
    paths = {}
    for batched in (True, False):
        smp = pt19_sampler(dev, 68)
        smp._batched = batched
        paths[batched] = (smp, pt_runs(smp, p0))
        smp.run_mcmc(None, n_c if batched else n_l, store=False)
    a, b = paths[True][1], paths[False][1]
    exact = all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))
    out["batched_equals_loop"] = exact
    if not exact:
        parted = np.nonzero(np.any(a[0] != b[0], axis=(1, 2, 3)))[0]
        out["chains_part_at_kept_step"] = (int(parted[0]) if parted.size
                                           else None)
        out["same_acceptance"] = bool(np.array_equal(a[3], b[3]))
        # From one state: the batched path's workspace.
        out["metric_diff"] = d = pt19_metric_diff(paths[True][0])
        if not max(d["C"], d["L"]) <= PT19_TOL:
            raise AssertionError(
                f"phase 19: KDEMove(): every rung's kernel covariance and "
                f"factor at once against each rung's own: {d} above "
                f"{PT19_TOL}")
    out["swaps_64"] = a[4].tolist()
    host = {True: [], False: []}
    dev_us = {True: [], False: []}
    kernels = {True: [], False: []}
    for batched in (True, False, False, True):
        smp, n = (paths[True][0], n_c) if batched else (paths[False][0], n_l)
        _, dt = drive(smp, None, n, store=False)
        host[batched].append(dt / n * 1e6)
        win = busy_window(torch, lambda: smp.run_mcmc(None, n, store=False),
                          n, f"KDEMove() {'batched' if batched else 'loop'}")
        dev_us[batched].append(win["device_us_per_proposal"])
        kernels[batched].append(win["kernels_per_proposal"])
    smp = paths[True][0]
    win = busy_window(torch, lambda: smp.run_mcmc(None, n_c, store=False),
                      n_c, "KDEMove() batched, its kernels", names=PT19_PER)
    counted, profiled = counted_replays(
        torch, dev, smp, n_c, lambda r: {k: v * n_c
                                         for k, v in PT19_PER.items()},
        "KDEMove() batched", store=False)
    out.update(host_us=host, device_us=dev_us, kernels=kernels, win=win,
               replayed_launches=counted, profiled_replayed=profiled,
               proposals_counted=n_c, loop_proposals_a_replay=n_l)
    del paths
    # K7's rows a warp in the ladder's own replays (forced plans, each on
    # a sampler recorded under it).
    plan_us = {}
    for rows in K7_TIME_ROWS:
        with forced_kde_plan(rows, kk.KDE_WARPS, kk.KDE_TILE):
            s2 = pt19_sampler(dev, 69)
            s2.run_mcmc(p0, 4, thin_by=4, skip_initial_state_check=True)
            s2.run_mcmc(None, n_c, store=False)  # records the window's graph
            w = busy_window(torch, lambda: s2.run_mcmc(None, n_c,
                                                       store=False),
                            n_c, f"KDEMove() K7 rows {rows}",
                            names={"kde_logpdf": 2})
        plan_us[rows] = w["ms_per_launch"]["kde_logpdf"] * 1e3
    out["plan_sweep_us"] = plan_us
    out["plan"] = tuple(kk.kde_plan(2 * (NW4 // 2), ND4,
                                    device_sm_count(dev), NT4))
    out["seconds_paths"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    smp = pt19_sampler(dev, 4, backend=PTDeviceBackend())
    st, _ = drive(smp, p0, kept, thin_by=thin, skip_initial_state_check=True)
    warm_graphs(smp)
    dt = float("inf")
    for _ in range(2):  # workloads5.py:224-233: the best of two
        smp.reset()
        st, dt_run = drive(smp, st, kept, thin_by=thin,
                           skip_initial_state_check=True)
        dt = min(dt, dt_run)
    n_prop = kept * thin
    cold = smp.get_chain(temp=0)
    tau = tau_of(np, cold, thin)
    swap_mean = float(np.mean(smp.tswap_acceptance_fraction))
    x0 = cold[..., 0]
    mode_frac = float(np.mean(x0 > 0))
    mean_abs, spread = float(np.mean(np.abs(x0))), float(np.std(np.abs(x0)))
    checks = {
        "swap acceptance mean in (0.4, 0.9)": 0.4 < swap_mean < 0.9,
        "cold mode fraction in (0.25, 0.75)": 0.25 < mode_frac < 0.75,
        "cold mean |x0| within 0.25 of 4": abs(mean_abs - PT_SEP) < 0.25,
        "cold spread of |x0| within 0.2 of 1": abs(spread - 1.0) < 0.2,
        "tau finite": bool(np.isfinite(tau)),
    }
    out["workload4"] = res = dict(
        walker_steps_per_s=NT4 * NW4 * n_prop / dt, seconds=dt, tau_cold=tau,
        ess_per_s_cold=NW4 * (n_prop / dt) / tau,
        tau_reliable=bool(n_prop / tau >= 30.0),
        swap_acceptance_mean=swap_mean, cold_mode_fraction=mode_frac,
        cold_mean_abs_x0=mean_abs, cold_spread_abs_x0=spread,
        cold_acceptance=float(smp.acceptance_fraction[0].mean()),
        checks=checks)
    log(f"phase 19: (d) KDEMove(), workload 4's configuration, "
        f"PTDeviceBackend, 512 kept x 4: {res['walker_steps_per_s']:.4e} "
        f"walker-steps/s over all rungs (best of two), cold tau "
        f"{tau:.2f} proposals, cold ESS/s {res['ess_per_s_cold']:.4e}, "
        f"tau_reliable {res['tau_reliable']}, swap acceptance mean "
        f"{swap_mean:.3f}, cold mode fraction {mode_frac:.3f}, cold mean "
        f"|x0| {mean_abs:.3f} (spread {spread:.3f}), cold acceptance "
        f"{res['cold_acceptance']:.3f}; checks {checks} {card} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not all(checks.values()):
        raise AssertionError(f"phase 19: KDEMove(): workload 4 checks "
                             f"{checks} (swap {swap_mean}, mode {mode_frac},"
                             f" |x0| {mean_abs} +- {spread}, tau {tau})")
    return out


def phase19(torch, np, dev, card):
    """K7, the KDE log-density (see the module docstring, 19): the sweep of
    K7 and its rung axis, K7 alone at phase 10's shape beside the old
    route, ``KDEMove()`` at 1e5 walkers and on workload 4's ladder (every
    rung at once against the per-rung loop), each path's kernel launches
    counted from 0 just before it, and the rows of K7 and K7 with the rung
    axis.  Returns its numbers and the rows."""
    out = {}
    t0 = time.perf_counter()
    out["sweep"] = k7_sweep(torch, dev)
    log(f"phase 19: (a) K7 and its rung axis against the plain version "
        f"(one ensemble: (rows, kernels, ndim) {K7_SWEEP}, forced plans "
        f"{K7_SWEEP_PLANS} on the small shapes, rows far from every kernel; "
        f"a NaN factor and s and q stacked through moves/kde.py; rungs "
        f"{K7R_SWEEP_T} of {K7R_SWEEP}, each rung of 3 against the "
        f"one-ensemble launch): {out['sweep']} comparisons, all bit for bit"
        f" ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out["alone"] = k7_alone(torch, dev, card)
    log(f"phase 19: (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with path_launches(out, "KDEMove() at 1e5", ("kde_logpdf",
                                                 "accept_select",
                                                 "philox_draw")
                       + SHUFFLE_KERNELS, "phase 19"):
        out["main"] = k7_main(torch, np, dev, card)
    log(f"phase 19: (c) {time.perf_counter() - t0:.1f} s")
    p0 = pt_p0(np)
    t0 = time.perf_counter()
    with path_launches(out, "KDEMove() at workload 4",
                       tuple(PT19_PER), "phase 19"):
        r = out["ladder"] = pt19_path(torch, np, dev, card, p0)
    if r["batched_equals_loop"]:
        held = "equal the per-rung loop bit for bit"
    else:
        d = r["metric_diff"]
        held = (f"part from the per-rung loop at kept step "
                f"{r['chains_part_at_kept_step']} (acceptance the same: "
                f"{r['same_acceptance']}); from one state, both splits, "
                f"relative to 1 + |value|: each rung's kernel covariance and "
                f"Cholesky factor within {d['C']:.3e} and {d['L']:.3e} of "
                f"its own (held to {PT19_TOL}), one proposal's q and factors "
                f"within {d['q']:.3e} and {d['factors']:.3e}")
    log(f"phase 19: (d) KDEMove() at {NT4} x {NW4} x {ND4}: 64 "
        f"graph-replayed proposals of every rung at once equal the plain "
        f"versions' eager chain bit for bit, and {held} (swaps "
        f"{r['swaps_64']})")
    log(f"phase 19: (d) KDEMove() in turns (batched, loop, loop, batched; "
        f"replays of {r['proposals_counted']} and "
        f"{r['loop_proposals_a_replay']} proposals), a proposal: host "
        f"{[round(x, 1) for x in r['host_us'][True]]} / "
        f"{[round(x, 1) for x in r['host_us'][False]]} us, device "
        f"{[measured(x) for x in r['device_us'][True]]} / "
        f"{[measured(x) for x in r['device_us'][False]]} us, kernels "
        f"{[measured(x, '.0f') for x in r['kernels'][True]]} / "
        f"{[measured(x, '.0f') for x in r['kernels'][False]]} (batched / "
        f"loop); batched launches in {r['proposals_counted']} proposals "
        f"{ {k: v for k, v in r['replayed_launches'].items() if v} } (device"
        f" words; exactly {PT19_PER} a proposal); us a launch in its "
        f"replays: " + ", ".join(
            f"{k} {measured(v and v * 1e3, '.3f')}"
            for k, v in r["win"]["ms_per_launch"].items())
        + f"; K7 us a launch by rows a warp (forced, in replays): "
        f"{ {k: round(v, 3) for k, v in r['plan_sweep_us'].items()} }, the "
        f"plan's {r['plan']} {card} ({time.perf_counter() - t0:.1f} s)")
    log(f"phase 19: kernel wrapper launches of each path, counted from 0 "
        f"(recordings and eager runs): {out['launches']}")
    return out, phase19_rows(torch, dev, out, card)


def phase19_rows(torch, dev, out, card):
    """(e) The rows of K7 (at the main path's shape: ``KDEMove()`` at 1e5
    walkers, s and q of a split in one launch) and of K7 with the rung axis
    (workload 4's ladder): device time a launch in the path's replays
    (profiler), launches counted by device words there, a back-to-back
    call's time and the plain version's (CUDA events), registers, and the
    least time the card could take."""
    from emcee_tpu_torch.ops import kde_kernel as kk

    al, mn, ld = out["alone"], out["main"], out["ladder"]
    rows = []
    regs = PTXAS.get("kde_logpdf_kernel<(int)5, false>")
    rows.append({
        "name": "kde_logpdf", "route": "cuda",
        "source": "emcee_tpu_torch/csrc/kde_logpdf.cu",
        "replaces": "emcee_tpu/moves/kde.py:89-106",
        "launches": mn["replayed_launches"]["kde_logpdf"],
        "max_abs_err": 0.0,
        "ms": mn["win"]["ms_per_launch"]["kde_logpdf"],
        "call_ms": al["ms_stacked"], "plain_ms": al["plain_ms"],
        "bound_ms": al["bound_ms_stacked"],
        "bound_by": al["bound_by_stacked"], "library_ms": None,
        "ms_before_per_logdensity": al["ms_before"],
        "ms_per_logdensity": al["ms"],
        "kernel_ms_per_logdensity": al["kernel_ms_one"],
        "bound_ms_per_logdensity": al["bound_ms"],
        "peak_bytes": al["peak_bytes"],
        "peak_bytes_before": al["peak_bytes_before"],
        "max_abs_diff_before": al["max_abs_diff_before"],
        "plan": al["plan"], "plan_sweep_ms": al["plan_sweep_ms"],
        "ptxas": regs,
        "launches_per_proposal": (mn["replayed_launches"]["kde_logpdf"]
                                  / mn["proposals_counted"]),
        "wrapper_launches": out["launches"]["KDEMove() at 1e5"]["kde_logpdf"],
        "note": "K7 at KDEMove()'s shape (1e5 walkers x 5: s and q of a "
                "split, 1e5 rows, under 5e4 kernels a launch): ms in the "
                "path's replays (profiler); call_ms the move's route "
                "(whitening and K7) back to back; plain_ms the plain version "
                "a log-density of 5e4 rows; launches counted on the card in "
                "replayed proposals; max_abs_err: bit for bit over phase "
                "19's sweep; bound: the pairs' operations (2 ndim + 7 at the "
                "float32 rate, one exp at the special-function rate); "
                "before: the blocked matmul + logsumexp route a log-density; "
                "library_ms: none, no single PyTorch call computes it"})
    T, nw, nd = NT4, NW4, ND4
    ng = nw // 2
    gen = torch.Generator(device=dev).manual_seed(191)
    x = torch.randn(T, 2 * ng, nd, device=dev, generator=gen)
    c = 4.0 * torch.randn(T, ng, nd, device=dev, generator=gen)
    norm = torch.randn(T, device=dev, generator=gen)
    call_ms = cuda_ms(torch, lambda: kk.kde_logpdf(x, c, norm))
    plain_ms = cuda_ms(torch, lambda: kk.kde_logpdf_plain(x, c, norm),
                       reps=20)
    pairs = T * 2 * ng * ng
    t = {"bytes": 4 * T * (2 * ng * nd + ng * nd + 1 + 2 * ng)
         / HBM_BYTES_PER_S * 1e3,
         "operations": max(pairs * (2 * nd + 7) / F32_OPS_PER_S,
                           pairs / SFU_OPS_PER_S) * 1e3}
    by = max(t, key=t.get)
    regs_r = PTXAS.get("kde_logpdf_kernel<(int)5, true>")
    ms = ld["win"]["ms_per_launch"]["kde_logpdf"]
    rows.append({
        "name": "kde_logpdf (rung axis)", "route": "cuda",
        "source": "emcee_tpu_torch/csrc/kde_logpdf.cu",
        "replaces": "emcee_tpu/moves/kde.py:89-106 (vmapped by "
                    "emcee_tpu/parallel/tempering.py:538)",
        "launches": ld["replayed_launches"]["kde_logpdf"],
        "max_abs_err": 0.0, "ms": ms, "call_ms": call_ms,
        "plain_ms": plain_ms, "bound_ms": t[by], "bound_by": by,
        "library_ms": None, "ptxas": regs_r, "plan": ld["plan"],
        "plan_sweep_us": ld["plan_sweep_us"],
        "launches_per_proposal": (ld["replayed_launches"]["kde_logpdf"]
                                  / ld["proposals_counted"]),
        "wrapper_launches":
            out["launches"]["KDEMove() at workload 4"]["kde_logpdf"],
        "path_device_us_batched_loop": (ld["device_us"][True],
                                        ld["device_us"][False]),
        "path_kernels_batched_loop": (ld["kernels"][True],
                                      ld["kernels"][False]),
        "note": f"K7 with the rung axis at workload 4's shape ({T} rungs, "
                f"s and q of a split: {2 * ng} rows under {ng} kernels a "
                "rung): ms in KDEMove()'s replays (profiler); launches "
                "counted on the card in replayed proposals; max_abs_err: bit "
                "for bit over phase 19's sweep; bound: each input read once "
                "and the output written once, and the pairs' operations; "
                "library_ms: none, no single PyTorch call computes it"})
    for row in rows:
        log(f"phase 19: (e) {row['name']}: device "
            f"{measured(row['ms'] and row['ms'] * 1e3, '.2f')} us/launch in "
            f"its path's replays, {row['call_ms'] * 1e3:.2f} us per "
            f"back-to-back call, plain {row['plain_ms'] * 1e3:.2f} us, bound "
            f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}); launches "
            f"{row['launches']}; {row['ptxas']} (registers, static shared, "
            f"spilled) {card}")
    return rows


# -- 20. the shuffled split: K16 and K17 --------------------------------------
#: (segments, walkers a segment, nsplits) of K16's sweep: one walker pair
#: to 2e5+ walkers, 1 to 64 rungs, both routes by the wrapper's plan
K16_SWEEP = ((1, 2, 2), (1, 6, 3), (3, 24, 4), (16, 256, 2), (64, 256, 4),
             (5, 1000, 2), (3, 2048, 2), (1, 4096, 4), (2, 4098, 3),
             (1, 10_002, 2),
             (1, 100_000, 2), (2, 100_000, 4), (1, 200_004, 3))
#: the chunks K16's sweep forces beside the wrapper's plan (a chunk below a
#: segment's walkers takes the long route)
K16_CHUNKS = (None, 2, 64, 1024, 4096)
#: the sort keys of K16's sweep: Philox word 3 at a host offset and at a
#: device word, and injected keys with ties
K16_KEYS = ("stream", "device word", "equal", "two values", "sorted",
            "reversed")
#: K17's sweep: dtypes, rows (in units of the dtype), and buffer counts
K17_DTYPES = ("float32", "float64", "int64", "int32", "int16", "int8", "bool")
K17_ROWS = ((), (2,), (3,), (5,), (17,), (129,))
K17_NBUFS = (1, 3, 18, 34)


@contextlib.contextmanager
def forced_shuffle_plan(chunk):
    """K16's wrapper launching with ``chunk`` walkers a sorting block (the
    plan's own where None)."""
    from emcee_tpu_torch.ops import shuffle_kernel as shk

    plan = shk.shuffle_plan
    shk.shuffle_plan = lambda T, n, ns, n_sm: plan(T, n, ns, n_sm,
                                                   chunk=chunk)
    try:
        yield
    finally:
        shk.shuffle_plan = plan


def k16_keys(torch, dev, kind, T, n, ns, gen, word):
    """Sort keys of ``T`` segments of ``n`` walkers: word 3 of the stream
    (``(n,)`` for one segment, ``(T, n)`` else), or injected ties."""
    from emcee_tpu_torch.ops.philox import (
        DeviceOffset, rung_keys, rung_words, walker_words)

    if kind in ("stream", "device word"):
        offset = 7 if kind == "stream" else DeviceOffset(word, 4)
        if T == 1:
            return walker_words(n, ns, 2001, offset, dev, word=3)
        return rung_words(rung_keys(2001, T, dev), n, ns, offset, dev,
                          word=3).view(T, n)
    if kind == "equal":
        return torch.full((T, n), 7, dtype=torch.int64, device=dev)
    if kind == "two values":
        return torch.randint(0, 2, (T, n), device=dev, generator=gen) * (
            2**32 - 1)
    k = torch.randint(0, 5, (T, n), device=dev, generator=gen)
    k = torch.sort(k, dim=-1).values
    return k if kind == "sorted" else k.flip(-1).contiguous()


def k16_sweep(torch, dev):
    """(a) K16 against its plain version, ``torch.equal``: every shape of
    ``K16_SWEEP`` with every key kind of ``K16_KEYS`` through the wrapper's
    plan and every forced chunk of ``K16_CHUNKS``; then the order recorded
    in a CUDA graph with K14's keys at a device offset word, replayed at
    four values of the word, at workload 4's shape (rank route) and at
    1e5 walkers (long route).  Returns the comparisons."""
    from emcee_tpu_torch.ops import shuffle_kernel as shk
    from emcee_tpu_torch.ops.philox import (
        DeviceOffset, rung_keys, rung_words, walker_words)

    gen = torch.Generator(device=dev).manual_seed(200)
    word = torch.tensor(3, dtype=torch.int64, device=dev)
    n_cmp = 0
    for T, n, ns in K16_SWEEP:
        for kind in K16_KEYS:
            keys = k16_keys(torch, dev, kind, T, n, ns, gen, word)
            want = shk.group_order_plain(keys, ns)
            for chunk in K16_CHUNKS:
                with forced_shuffle_plan(chunk):
                    got = shk.group_order(keys, ns)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"phase 20: K16 {T} x {n} / {ns}, {kind}, chunk "
                        f"{chunk}: kernel and plain version differ")
                n_cmp += 1
    for T, n in ((NT4, NW4), (1, NW)):
        keys = rung_keys(2002, T, dev)

        def draw(off):
            if T == 1:
                return walker_words(n, 2, 2002, off, dev, word=3)
            return rung_words(keys, n, 2, off, dev, word=3)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            shk.group_order(draw(DeviceOffset(word, 1)), 2)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = shk.group_order(draw(DeviceOffset(word, 1)), 2)
        for v in (0, 1, 5, 2**40 + 3):
            word.fill_(v)
            graph.replay()
            want = shk.group_order_plain(draw(v + 1), 2)
            if not torch.equal(got, want):
                raise AssertionError(f"phase 20: K16 replayed at {T} x {n}, "
                                     f"offset {v + 1}: kernel and plain "
                                     "version differ")
            n_cmp += 1
    torch.cuda.synchronize()
    return n_cmp


def k17_leaf(torch, shape, dtype, gen, dev, misalign):
    """A buffer of random bytes (0 or 1 for bool) whose base lies
    ``misalign`` bytes past a 16-byte boundary."""
    if dtype != "bool":
        return raw_leaf(torch, shape, dtype, gen, dev, misalign)
    t = raw_leaf(torch, shape, "uint8", gen, dev, misalign)
    t &= 1
    return t.view(torch.bool)


def k17_sweep(torch, dev):
    """(b) K17 against ``index_select`` / ``index_copy_``, byte for byte:
    sets of ``K17_NBUFS`` buffers cycling through ``K17_DTYPES`` x
    ``K17_ROWS`` (random bytes, so NaN rows too), bases on and off 16-byte
    boundaries (source and destination apart), over a random permutation
    of 1000 rows, K16's flat rung rows of workload 4's ladder and K16's
    order of 1e5 walkers; the gather into new buffers and into given ones,
    and the scatter.  Returns the comparisons."""
    from emcee_tpu_torch.ops import shuffle_kernel as shk
    from emcee_tpu_torch.ops.philox import rung_keys, rung_words

    gen = torch.Generator(device=dev).manual_seed(201)
    kinds = [(d, r) for r in K17_ROWS for d in K17_DTYPES]
    w4 = rung_words(rung_keys(5, NT4, dev), NW4, 2, 9, dev, word=3)
    orders = {
        "a permutation of 1000 rows": torch.randperm(1000, device=dev,
                                                     generator=gen),
        "workload 4's rung rows": shk.group_order(w4.view(NT4, NW4), 2),
        "1e5 walkers": torch.randperm(NW, device=dev, generator=gen)}
    n_cmp = 0
    for what, order in orders.items():
        rows = order.shape[0]
        for nb in K17_NBUFS:
            if rows == NW and nb > 3:
                continue
            spec = [kinds[(nb * 7 + i) % len(kinds)] for i in range(nb)]
            sizes = [torch.empty(0, dtype=getattr(torch, d)).element_size()
                     for d, _ in spec]
            for mis in (0, 1, 3):
                def make(shift=0):
                    return [k17_leaf(torch, (rows, *r), d, gen, dev,
                                     (mis + shift) * s % 16)
                            for (d, r), s in zip(spec, sizes)]

                srcs = make()
                got = shk.gather_rows(order, srcs)
                want = [s.index_select(0, order) for s in srcs]
                same_bytes(got, want, f"phase 20: K17 gather, {what}, {nb} "
                                      f"buffers, misalign {mis}")
                outs = make(1)
                shk.gather_rows(order, srcs, outs)
                same_bytes(outs, want, f"phase 20: K17 gather into given "
                                       f"buffers, {what}, {nb} buffers")
                dsts = make(2)
                ref = [d.clone().index_copy_(0, order, s)
                       for d, s in zip(dsts, srcs)]
                shk.scatter_rows(order, dsts, srcs)
                same_bytes(dsts, ref, f"phase 20: K17 scatter, {what}, {nb} "
                                      f"buffers, misalign {mis}")
                n_cmp += 3 * nb
    torch.cuda.synchronize()
    return n_cmp


def shuffle_buffers(torch, run):
    """The buffers one shuffled proposal moves, as ``[(shape, dtype)]`` of
    the gather's sources and of the scatter's destinations, from one
    eager proposal run by ``run()`` (K17's launches read on their way)."""
    from emcee_tpu_torch.ops import shuffle_kernel as shk

    seen = {}
    launch_rows = shk._launch_rows

    def record(order, pairs, scatter, fn):
        # (src, dst) pairs: the scatter's sources have its destinations'
        # shapes and dtypes.
        seen["scatter" if scatter else "gather"] = [
            (tuple(src.shape), src.dtype) for src, _ in pairs]
        return launch_rows(order, pairs, scatter, fn)

    shk._launch_rows = record
    try:
        run()
    finally:
        shk._launch_rows = launch_rows
    return seen["gather"], seen["scatter"]


def replay_ms(torch, fn, reps=20, replays=10):
    """Device ms of one call of ``fn``: CUDA events around ``replays``
    replays of a CUDA graph that holds ``reps`` calls, so no host work
    lies in the window (a call's kernels and the gaps between them).  Late
    in the whole script the profiler records no kernel of some windows of
    eager calls at all, so the times of calls alone are taken so, the
    profiler's only in the paths' replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def shuffle_alone(torch, dev, card, shape, bufs):
    """(d) K16 and K17 alone at ``shape`` (``(T, n)``: workload 4's ladder
    or one ensemble of 1e5 walkers) on the buffers ``bufs`` (gather
    sources, scatter destinations) its proposals move: device ms a call
    in graph replays (:func:`replay_ms`), a back-to-back eager call's ms
    (CUDA events), the plain versions', the library yardsticks'
    (``torch.argsort(stable=True)`` of the same keys for K16; the
    ``index_select`` / ``index_copy_`` calls of the plain route for K17,
    both also in graph replays) and the bounds."""
    from emcee_tpu_torch.ops import shuffle_kernel as shk
    from emcee_tpu_torch.ops._wrap import sm_count
    from emcee_tpu_torch.ops.philox import rung_keys, rung_words, walker_words

    T, n = shape
    keys = (walker_words(n, 2, 11, 3, dev, word=3) if T == 1 else
            rung_words(rung_keys(11, T, dev), n, 2, 3, dev, word=3))
    order = shk.group_order(keys, 2)
    plan = shk.shuffle_plan(T, n, 2, sm_count(torch.cuda.current_device()))
    gen = torch.Generator(device=dev).manual_seed(202)

    def leaves(spec):
        return [k17_leaf(torch, shp, str(dt).removeprefix("torch."), gen,
                         dev, 0) for shp, dt in spec]

    # The gather's sources; the scatter's destinations (the same buffers
    # and the acceptance) and sources (the gathered rows).
    srcs, dsts = leaves(bufs[0]), leaves(bufs[1])
    rows_src = leaves(bufs[1])
    res = {}

    def row_bytes(ts):
        return sum(t[0].numel() * t.element_size() for t in ts)

    fns = {
        "group_order": (lambda: shk.group_order(keys, 2),
                        lambda: shk.group_order_plain(keys, 2),
                        lambda: torch.argsort(keys, dim=-1, stable=True),
                        16 * T * n, T * n * max(1, math.ceil(math.log2(n)))),
        "gather_rows": (lambda: shk.gather_rows(order, srcs),
                        lambda: shk.gather_rows_plain(order, srcs),
                        lambda: [s.index_select(0, order) for s in srcs],
                        2 * T * n * row_bytes(srcs) + 8 * T * n, 0),
        "scatter_rows": (lambda: shk.scatter_rows(order, dsts, rows_src),
                         lambda: shk.scatter_rows_plain(order, dsts,
                                                        rows_src),
                         lambda: [d.index_copy_(0, order, s)
                                  for d, s in zip(dsts, rows_src)],
                         2 * T * n * row_bytes(dsts) + 8 * T * n, 0),
    }
    for name, (fn, plain, lib, nbytes, nops) in fns.items():
        t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": nops / F32_OPS_PER_S * 1e3}
        by = max(t, key=t.get)
        per_call = plan.launches if name == "group_order" else 1
        res[name] = dict(
            device_ms=replay_ms(torch, fn),
            call_ms=cuda_ms(torch, fn), plain_ms=cuda_ms(torch, plain,
                                                         reps=50),
            library_ms=replay_ms(torch, lib),
            library_call_ms=cuda_ms(torch, lib), bound_ms=t[by],
            bound_by=by, bytes=nbytes, operations=nops,
            launches_per_call=per_call)
        r = res[name]
        log(f"phase 20: (d) {name} alone at {T} x {n} ({len(srcs)} buffers "
            f"gathered, {len(dsts)} scattered): device "
            f"{r['device_ms'] * 1e3:.2f} us a call ({r['launches_per_call']} "
            f"launches; graph replays), {r['call_ms'] * 1e3:.2f} us back to "
            f"back eagerly, plain {r['plain_ms'] * 1e3:.2f} us, library "
            f"{r['library_ms'] * 1e3:.2f} us in graph replays / "
            f"{r['library_call_ms'] * 1e3:.2f} us back to back, bound "
            f"{r['bound_ms'] * 1e3:.3f} us ({by}) {card}")
    # The other routes forced: the bitonic block beside the rank route on
    # the ladder, other chunks of the long route at 1e5.
    chunks = {}
    for chunk in ((256,) if plan.route == "rank" else (1024, 2048, 4096)):
        with forced_shuffle_plan(chunk):
            chunks[chunk] = replay_ms(torch,
                                      lambda: shk.group_order(keys, 2))
    res["group_order"]["device_ms_by_chunk"] = chunks
    log(f"phase 20: (d) group_order at {T} x {n}, device us a call by "
        f"forced chunk: " + ", ".join(
            f"{k}: {v * 1e3:.2f}" for k, v in chunks.items())
        + f" (the plan: {plan.route} route, chunk {plan.chunk}) {card}")
    return res


def pt20_chains(torch, np, dev):
    """(c) 64 graph-replayed proposals against the plain versions' eager
    chain, bit for bit: workload 4 (``StretchMove()`` on every rung) and
    ``DEMove()`` on the ladder, ``StretchMove()`` and
    ``EnsembleSliceMove()`` at 1e5 walkers."""
    from emcee_tpu_torch import EnsembleSampler, moves

    p0 = pt_p0(np)
    out = {}
    for label, make in (("workload 4", lambda: pt_sampler(dev, seed=71)),
                        ("DEMove() on the ladder", lambda: pt_sampler(
                            dev, seed=72, move=moves.DEMove()))):
        ends = []
        for plain in (False, True):
            smp = make()
            smp._use_graphs = not plain
            with plain_kernels() if plain else contextlib.nullcontext():
                ends.append(pt_runs(smp, p0))
        same_ends(np, *ends, f"phase 20: {label}: graph and eager plain "
                             "chains")
        out[label] = float(ends[0][3].sum()) / (NT4 * NW4 * 64)
    p1 = np.random.default_rng(20).normal(size=(NW, ND)).astype(np.float32)
    for label, mv in (("StretchMove() at 1e5", moves.StretchMove),
                      ("EnsembleSliceMove() at 1e5",
                       moves.EnsembleSliceMove)):
        out[label] = graph_vs_plain_chain(torch, lambda: EnsembleSampler(
            NW, ND, gaussian, vectorize=True, seed=73, device=dev,
            moves=mv()), p1)
    return out


def shuffle_main(torch, np, dev, card, out, n4=64, n1=16):
    """(d) This slice's main path, its launches counted from 0 just before
    it: workload 4 (``StretchMove()`` on every rung) and ``StretchMove()``
    at 1e5 walkers, each recorded, then a profiled window of replays
    (device µs and kernels a proposal, each kernel's device time a launch,
    the path's counts held exactly) and the replayed launches counted on
    the card."""
    from emcee_tpu_torch import EnsembleSampler

    res = {}
    runs = {
        "workload 4": (lambda: pt_sampler(dev, seed=74), n4,
                       {"stretch_propose": 2, "accept_select": 2,
                        "pt_swap": 1, "philox_draw": 1} | SHUF4),
        "StretchMove() at 1e5": (lambda: EnsembleSampler(
            NW, ND, gaussian, vectorize=True, seed=75, device=dev), n1,
            {"stretch_propose": 2, "accept_select": 2, "philox_draw": 1}
            | shuffle_per(1, NW))}
    p0 = {"workload 4": pt_p0(np),
          "StretchMove() at 1e5": np.random.default_rng(21).normal(
              size=(NW, ND)).astype(np.float32)}
    for label, (make, n, per) in runs.items():
        with path_launches(out, label, tuple(per), "phase 20"):
            smp = make()
            smp.run_mcmc(p0[label], 8, thin_by=4,
                         skip_initial_state_check=True)
            smp.run_mcmc(None, n, store=False)  # records the window's graph
            t0 = time.perf_counter()
            smp.run_mcmc(None, n, store=False)
            torch.cuda.synchronize()
            host_us = (time.perf_counter() - t0) / n * 1e6
            win = busy_window(
                torch, lambda: smp.run_mcmc(None, n, store=False), n, label,
                expect=lambda: {k: v * n for k, v in per.items()},
                names=per)
            counted, profiled = counted_replays(
                torch, dev, smp, n, lambda r: {k: v * n
                                               for k, v in per.items()},
                label, store=False)
            acc = float(np.mean(smp.acceptance_fraction))
            if not 0.1 < acc < 0.9:
                raise AssertionError(f"phase 20: {label}: acceptance {acc}")
        res[label] = dict(win=win, host_us=host_us, replayed_launches=counted,
                          profiled_replayed=profiled, proposals_counted=n,
                          per_proposal=per, acceptance=acc,
                          wrapper_launches=out["launches"][label])
        log(f"phase 20: (d) {label}: a proposal: device "
            f"{measured(win['device_us_per_proposal'], '.2f')} us, "
            f"{measured(win['kernels_per_proposal'], '.1f')} kernels, idle "
            f"share {measured(win['idle'], '.4f')}, host {host_us:.1f} us "
            f"(replays of {n}); us a launch in the replays: " + ", ".join(
                f"{k} {measured(v and v * 1e3, '.3f')}"
                for k, v in win["ms_per_launch"].items())
            + f"; {replay_counts(counted, profiled, n)}; acceptance "
            f"{acc:.4f} {card}")
    return res


def phase20(torch, np, dev, card):
    """The shuffled split through K16 and K17 (see the module docstring,
    20).  Returns its numbers and the rows of K16 and K17."""
    from emcee_tpu_torch import EnsembleSampler

    out = {}
    t0 = time.perf_counter()
    out["k16_comparisons"] = k16_sweep(torch, dev)
    log(f"phase 20: (a) K16 against its plain version (torch.equal): "
        f"segments x walkers / nsplits {K16_SWEEP}, keys {K16_KEYS}, the "
        f"plan's chunk and forced chunks {K16_CHUNKS[1:]}, graph replays at "
        f"a device offset word: {out['k16_comparisons']} comparisons, all "
        f"identical ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out["k17_comparisons"] = k17_sweep(torch, dev)
    log(f"phase 20: (b) K17 against index_select / index_copy_ (bytes): "
        f"dtypes {K17_DTYPES}, rows {K17_ROWS} units, {K17_NBUFS} buffers "
        f"a launch, bases off 16 bytes, a permutation of 1000 rows, "
        f"workload 4's flat rung rows and 1e5 rows: "
        f"{out['k17_comparisons']} comparisons, all identical "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out["chains"] = pt20_chains(torch, np, dev)
    log(f"phase 20: (c) 64 graph-replayed proposals equal the plain "
        f"versions' eager chain bit for bit: "
        + ", ".join(f"{k} (acceptance {v:.4f})"
                    for k, v in out["chains"].items())
        + f" ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out["main"] = shuffle_main(torch, np, dev, card, out)

    # The buffers each path's proposals move, from one eager proposal.
    def one_pt():
        s = pt_sampler(dev, seed=76)
        s._use_graphs = False
        s.run_mcmc(pt_p0(np), 1, store=False, skip_initial_state_check=True)

    def one_1e5():
        s = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=77,
                            device=dev)
        s._use_graphs = False
        s.run_mcmc(np.random.default_rng(22).normal(size=(NW, ND)).astype(
            np.float32), 1, store=False, skip_initial_state_check=True)

    out["alone"] = {
        "workload 4": shuffle_alone(torch, dev, card, (NT4, NW4),
                                    shuffle_buffers(torch, one_pt)),
        "1e5": shuffle_alone(torch, dev, card, (1, NW),
                             shuffle_buffers(torch, one_1e5))}
    log(f"phase 20: (d) {time.perf_counter() - t0:.1f} s")
    log(f"phase 20: kernel wrapper launches of each path, counted from 0 "
        f"(recordings and eager runs): {out['launches']}")
    return out, phase20_rows(out)


def phase20_rows(out):
    """(e) The rows of K16 and K17: at workload 4's shape (K16's short
    route) the main keys, at 1e5 walkers (K16's long route) the ``_1e5``
    ones.  ``ms`` is the device time of one call in the path's replays
    (the profiler's mean a launch times the call's launches), ``launches``
    the replayed launches counted on the card."""
    mains, alone = out["main"], out["alone"]
    w4, m1 = mains["workload 4"], mains["StretchMove() at 1e5"]
    meta = {
        "group_order": ("emcee_tpu_torch/csrc/shuffle_order.cu",
                        "emcee_tpu/moves/red_blue.py:218-219 (vmapped by "
                        "emcee_tpu/parallel/tempering.py:538)"),
        "gather_rows": ("emcee_tpu_torch/csrc/gather_rows.cu",
                        "emcee_tpu/moves/red_blue.py:228-244"),
        "scatter_rows": ("emcee_tpu_torch/csrc/gather_rows.cu",
                         "emcee_tpu/moves/red_blue.py:252-264")}
    fns = {"group_order": ("group_rank_kernel", "group_order_kernel",
                           "group_merge_kernel"),
           "gather_rows": ("gather_rows_kernel",),
           "scatter_rows": ("scatter_rows_kernel",)}
    rows = []
    for name, (source, replaces) in meta.items():
        a, b = alone["workload 4"][name], alone["1e5"][name]

        def call_ms(m):
            ms = m["win"]["ms_per_launch"].get(name)
            return None if ms is None else ms * m["per_proposal"][name]

        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": w4["replayed_launches"][name],
               "max_abs_err": 0.0, "ms": call_ms(w4),
               "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
               "bound_by": a["bound_by"], "library_ms": a["library_ms"],
               "call_ms": a["call_ms"], "alone_ms": a["device_ms"],
               "library_call_ms": a["library_call_ms"],
               "launches_per_proposal": w4["per_proposal"][name],
               "launches_1e5": m1["replayed_launches"][name],
               "launches_per_proposal_1e5": m1["per_proposal"][name],
               "ms_1e5": call_ms(m1), "plain_ms_1e5": b["plain_ms"],
               "bound_ms_1e5": b["bound_ms"], "bound_by_1e5": b["bound_by"],
               "library_ms_1e5": b["library_ms"],
               "call_ms_1e5": b["call_ms"],
               "alone_ms_1e5": b["device_ms"],
               "library_call_ms_1e5": b["library_call_ms"],
               "comparisons": out["k16_comparisons" if name == "group_order"
                                  else "k17_comparisons"],
               "ptxas": {k: v for k, v in PTXAS.items()
                         if any(f in k for f in fns[name])}}
        if name == "group_order":
            row["device_ms_by_chunk"] = a["device_ms_by_chunk"]
            row["device_ms_by_chunk_1e5"] = b["device_ms_by_chunk"]
        row["note"] = (
            f"workload 4's ladder ({NT4} rungs x {NW4} walkers; K16's rank "
            f"route) and, in the _1e5 keys, StretchMove() at {NW} walkers "
            "(K16's long route: a sort and its merge passes a call): ms the "
            "device time of one call in the path's replays (profiler); "
            "alone_ms a call alone and library_ms in graph replays "
            "of 20 calls (CUDA events); "
            "launches counted on the card in replayed proposals; max_abs_err:"
            " bit and byte equality over phase 20's sweeps; bound: each input "
            "read once and each output written once (K16 also a comparison "
            "sort's n log2 n compares at the float32 rate); library_ms: "
            + ("torch.argsort(stable=True) of the same keys (the sort "
               "alone; its device time a call)" if name == "group_order" else
               "the plain route's index_select (gather) or index_copy_ "
               "(scatter) calls on the same buffers, their device time"))
        rows.append(row)
        log(f"phase 20: (e) {name}: device "
            f"{measured(row['ms'] and row['ms'] * 1e3, '.2f')} us a call in "
            f"workload 4's replays, {measured(row['ms_1e5'] and row['ms_1e5'] * 1e3, '.2f')}"
            f" us at 1e5; launches {row['launches']} / {row['launches_1e5']}"
            f" (device counters); ptxas {row['ptxas']}")
    return rows


# -- 21. K8, DIME's moments, factor and proposal -------------------------------
#: ndims of K8's sweep: 1-5 through K8c's registers, 100 by its loop (the
#: q row as scratch) and through K8b's factor in global memory
K8_SWEEP_ND = (1, 3, 5, 100)
#: (rungs, walkers a split) of the sweep: one ensemble whose sets span ten
#: K8a blocks (a tree of four levels with an odd node), and three rungs of
#: an odd few
K8_SWEEP_TN = ((1, 2501), (3, 7))
#: df of the sweep: Gaussian, ten squared normals, Marsaglia-Tsang
K8_SWEEP_DF = (None, 10.0, 7.5)
#: K8's and K2's launches a DIME proposal: K8a and K8b for each split and
#: for the carry, K8c and K2 for each split
K8_PER = {"dime_moments": 3, "dime_finish": 3, "dime_propose": 2,
          "accept_select": 2}
#: phase 21's moves on workload 4's ladder
PT21_MOVES = ("DIMEMove()", "DIMEMove(aimh_prob=0.3, n_components=2)")
#: their kernels a proposal there (every rung at once): K8, K2, K15, the
#: shuffle's K14 sort keys, K16 and K17
PT21_PER = K8_PER | {"pt_swap": 1, "philox_draw": 1} | SHUF4
#: proposals a replay of the per-rung loop's timed graph
PT21_LOOP_N = 4


def pt21_move(label):
    from emcee_tpu_torch import moves

    if label == "DIMEMove()":
        return moves.DIMEMove()
    return moves.DIMEMove(aimh_prob=0.3, n_components=2)


def k8_carry(torch, dev, gen, lead, K, nd, warm, offset=0.0):
    """A DIME carry of ``lead`` rungs (``()`` or ``(T,)``) and ``K``
    components: warm (moments near the rows, weight 40) where ``warm``
    (a bool, or a ``(T,)`` list), else the cold one."""
    kk = (K,) if K > 1 else ()
    on = torch.tensor(warm, dtype=torch.float32, device=dev).expand(
        lead).reshape(lead + (1,) * len(kk))
    mean = (offset + torch.randn(lead + kk + (nd,), device=dev,
                                 generator=gen)) * on[..., None]
    a = 0.3 * torch.randn(lead + kk + (nd, nd), device=dev, generator=gen)
    cov = torch.eye(nd, device=dev) + a @ a.mT
    w = 40.0 * on.expand(lead + kk).contiguous()
    return mean.contiguous(), cov.contiguous(), w


def k8_rows(torch, dev, gen, lead, nw, nd, K, offset=3.0):
    """Rows of spread 1.5 at ``offset`` in ``K`` clusters 12 apart, each
    a run of rows."""
    x = 1.5 * torch.randn(lead + (nw, nd), device=dev, generator=gen)
    cl = torch.clamp(torch.arange(nw, device=dev) // max(1, nw // K),
                     max=K - 1)
    return (x + offset + 12.0 * cl[:, None].float()).contiguous()


@contextlib.contextmanager
def forced_k8_paths(staged=None, shared=None, group=None):
    """K8a staging its rows in shared memory (or reading them from global
    memory) and K8b working in shared memory (or in global memory), as
    forced, whatever the sizes (None: the plan's choice); with ``group``,
    K8a's runs a block."""
    from emcee_tpu_torch.ops import dime_kernel as dk

    saved = dk.moments_staged, dk.finish_shared, dk.moments_group
    if staged is not None:
        dk.moments_staged = lambda rows, g, nd, k: staged
    if shared is not None:
        dk.finish_shared = lambda blocks, nd, k: shared
    if group is not None:
        dk.moments_group = lambda rows, nd, k: group
    try:
        yield
    finally:
        dk.moments_staged, dk.finish_shared, dk.moments_group = saved


def k8_sweep(torch, dev):
    """(a) K8a, K8b and K8c against their plain versions, bit for bit (the
    bits compared, NaN included): ndim ``K8_SWEEP_ND``, one ensemble and
    three rungs (``K8_SWEEP_TN``, odd walkers a split), 1-3 components,
    ``df`` ``K8_SWEEP_DF``, ``aimh_prob`` 0.3 and 1, cold and warm carries,
    both splits, the carry update, the chi-square exhaustion count; each
    rung of three against the one-ensemble launch; K8a's and K8b's memory
    paths forced both ways and K8a's runs a block 1-8
    (``forced_k8_paths``); injected draws; a
    device offset word against the same int offset; a history that leaves
    the shape without a factor.  Returns the count of comparisons."""
    from emcee_tpu_torch.ops import dime_kernel as dk
    from emcee_tpu_torch.ops.de_kernel import de_gamma0
    from emcee_tpu_torch.ops.philox import DeviceOffset, rung_keys

    gen = torch.Generator(device=dev).manual_seed(210)
    n_cmp = 0

    def same(got, want, what):
        nonlocal n_cmp
        same_bits(got, want, what)
        n_cmp += len(got)

    def word():
        return torch.zeros((), dtype=torch.int64, device=dev)

    def one(x, T, K, nd, cfg, seed, carry, what, offset=5, extra=None):
        """Both splits and the update of one setting, kernel against plain;
        returns the kernel's tables and proposals."""
        mean, cov, w = carry
        ng = x.shape[-2] // 2
        outs = []
        for split in (0, 1):
            part = dk.dime_moments(x, (split * ng, ng), mean, w, K)
            same([part], [dk.dime_moments_plain(x, (split * ng, ng), mean,
                                                w, K)],
                 f"{what} split {split}: K8a")
            table = dk.dime_finish(part.clone(), mean, cov, w, cfg)
            same([table], [dk.dime_finish_plain(part, mean, cov, w, cfg)],
                 f"{what} split {split}: K8b")
            ek, ep = word(), word()
            q, f = dk.dime_propose(x, split, 2, table, seed, offset, cfg,
                                   extra=extra, exhausted=ek)
            qp, fp = dk.dime_propose_plain(x, split, 2, table, seed, offset,
                                           cfg, extra=extra, exhausted=ep)
            same([q, f, ek], [qp, fp, ep], f"{what} split {split}: K8c")
            outs.append((part, table, q, f))
        got = [t.clone() for t in carry]
        want = [t.clone() for t in carry]
        dk.dime_finish(dk.dime_moments(x, (0, 0), got[0], got[2], K), *got,
                       cfg, mode="update")
        dk.dime_finish_plain(dk.dime_moments_plain(x, (0, 0), want[0],
                                                   want[2], K), *want, cfg,
                             mode="update")
        same(got, want, f"{what}: the carry update")
        return outs

    for nd in K8_SWEEP_ND:
        for T, ng in K8_SWEEP_TN:
            lead = (T,) if T > 1 else ()
            # ndim 100 (K8c's loop, K8b's global memory): one setting a
            # ladder shape; its plain factor alone is ~2e4 launches.
            for K in (((2,) if T == 1 else (1,)) if nd == 100
                      else (1, 2, 3)):
                for df in ((10.0,) if nd == 100 else K8_SWEEP_DF):
                    for aimh in ((0.3,) if nd == 100 else (0.3, 1.0)):
                        warm = ([False] + [True] * (T - 1) if T > 1
                                else aimh < 1.0)
                        carry = k8_carry(torch, dev, gen, lead, K, nd, warm)
                        x = k8_rows(torch, dev, gen, lead, 2 * ng, nd, K)
                        cfg = dk.DimeConfig(K, 0.999, df, aimh,
                                            de_gamma0(None, nd), 1e-5)
                        seed = rung_keys(31, T, dev) if T > 1 else 31
                        what = (f"K8 sweep T={T} ng={ng} nd={nd} K={K} "
                                f"df={df} aimh={aimh}")
                        outs = one(x, T, K, nd, cfg, seed, carry, what)
                        if T != 3 or df != 7.5 or aimh != 0.3:
                            continue
                        for r in range(T):
                            rc = tuple(t[r].contiguous() for t in carry)
                            mine = one(x[r].contiguous(), 1, K, nd, cfg,
                                       seed.seeds[r], rc,
                                       f"{what}, rung {r} alone")
                            for o, m in zip(outs, mine):
                                same(list(m), [v[r] for v in o],
                                     f"{what}: rung {r} against one "
                                     "ensemble")
    # Both memory paths of K8a and K8b and other groups of runs, forced
    # whatever the sizes.
    for staged, shared, group in ((False, False, 1), (True, False, 2),
                                  (False, True, 4), (True, True, 8)):
        for T, ng, nd, K in ((1, 1001, 5, 1), (3, 300, 3, 3), (1, 77, 100, 2)):
            lead = (T,) if T > 1 else ()
            carry = k8_carry(torch, dev, gen, lead, K, nd,
                             [False] + [True] * (T - 1) if T > 1 else True)
            x = k8_rows(torch, dev, gen, lead, 2 * ng, nd, K)
            cfg = dk.DimeConfig(K, 0.999, 10.0, 0.3, de_gamma0(None, nd),
                                1e-5)
            if nd == 100 and group > 1:
                continue  # the runs' partials do not fit a block
            with forced_k8_paths(staged, shared, group):
                one(x, T, K, nd, cfg, rung_keys(7, T, dev) if T > 1 else 7,
                    carry, f"K8 sweep staged={staged} shared={shared} "
                    f"group={group} T={T} ng={ng} nd={nd} K={K}")
    # Injected draws, one ensemble and three rungs.
    for lead in ((), (3,)):
        for K in (1, 3):
            nd, ng = 4, 33
            carry = k8_carry(torch, dev, gen, lead, K, nd, True)
            x = k8_rows(torch, dev, gen, lead, 2 * ng, nd, K)
            extra = dict(
                z=torch.randn(lead + (ng, nd), device=dev, generator=gen),
                zg=torch.randn(lead + (ng, 1), device=dev, generator=gen),
                i=torch.randint(0, ng, lead + (ng,), device=dev,
                                generator=gen),
                j=torch.randint(0, ng - 1, lead + (ng,), device=dev,
                                generator=gen),
                use_t=torch.rand(lead + (ng,), device=dev,
                                 generator=gen) < 0.5,
                chi2=4.0 + torch.rand(lead + (ng,), device=dev,
                                      generator=gen),
                comp=torch.randint(0, K, lead + (ng,), device=dev,
                                   generator=gen))
            cfg = dk.DimeConfig(K, 0.999, 7.5, 0.3, de_gamma0(None, nd), 0.1)
            one(x, len(lead), K, nd, cfg, 0, carry,
                f"K8 sweep injected draws lead={lead} K={K}", extra=extra)
    # A device offset word against the same int offset.
    nd, ng, K = 5, 1001, 2
    carry = k8_carry(torch, dev, gen, (), K, nd, True)
    x = k8_rows(torch, dev, gen, (), 2 * ng, nd, K)
    cfg = dk.DimeConfig(K, 0.999, 7.5, 0.3, de_gamma0(None, nd), 1e-5)
    table = dk.dime_finish(dk.dime_moments(x, (0, ng), carry[0], carry[2],
                                           K), *carry, cfg)
    w8 = torch.tensor(40, dtype=torch.int64, device=dev)
    same(dk.dime_propose(x, 0, 2, table, 17, DeviceOffset(w8, 2), cfg),
         dk.dime_propose(x, 0, 2, table, 17, 42, cfg),
         "K8c: a device offset word against the int offset")
    # No factor: a negative-definite history that outweighs the batch.
    for K in (1, 2):
        nd = 3
        kk = (K,) if K > 1 else ()
        mean = torch.zeros(kk + (nd,), device=dev)
        cov = (-50.0 * torch.eye(nd, device=dev)).expand(
            kk + (nd, nd)).contiguous()
        w = torch.full(kk, 1000.0, device=dev)
        x = k8_rows(torch, dev, gen, (), 64, nd, K)
        cfg = dk.DimeConfig(K, 0.999, 10.0, 0.3, de_gamma0(None, nd), 1e-5)
        outs = one(x, 1, K, nd, cfg, 3, (mean, cov, w),
                   f"K8 sweep no factor K={K}")
        L = dk.unpack_table(outs[0][1], K, nd)[1]
        if not bool(torch.isnan(L).all()):
            raise AssertionError("K8 sweep: a shape with no factor gave "
                                 "entries that are not NaN")
    torch.cuda.synchronize()
    return n_cmp


def k8_bounds(n, nd, K, nb, ng, df, aimh):
    """The least work of K8a (the set's rows once, the partials written;
    per row and component the assignment, the mean and the
    cross-products), K8b (the partials read, the table written; the tree,
    the pool and the factor) and K8c (each walker's row read and its q and
    factor written, a DE walker's two partner rows; its Philox blocks and
    normals, the draw by L and both quadratic forms), as ``{name: (bytes,
    instructions, special-function results)}``."""
    node = 1 + nd + nd * nd
    tab = K * (nd + 2 * nd * nd + 3)
    de = aimh < 1.0
    blocks = (nd + de + 1) // 2 + (de or K > 1) + (
        0 if df is None else (int(df) + 1) // 2 if float(df).is_integer()
        else 2)
    normals = nd + de + (0 if df is None else int(df) if
                         float(df).is_integer() else 2)
    per_walker = (blocks * PHILOX_INSTR + normals * NORMAL_INSTR
                  + nd * nd + 2 * K * (nd * nd + 2 * nd) + 20)
    return {
        "dime_moments": (4 * (n * nd + nb * K * node),
                         n * (K * 3 * nd + 2 * nd + 4 * nd * nd), 0),
        "dime_finish": (4 * (nb * K * node + tab),
                        nb * K * 4 * nd * nd + K * (nd ** 3 // 3 + 8 * nd
                                                    * nd), 3 * K),
        "dime_propose": (4 * (2 * ng * nd + ng + tab + int(de) * 2 * ng
                              * nd),
                         ng * per_walker,
                         ng * (normals * NORMAL_SFU + 2 * K + 2)),
    }


#: (rows a run, runs a K8a block) timed by ``k8_plan_sweep``
K8_PLAN_SWEEP = tuple((r, g) for r in (64, 128, 256) for g in (1, 2, 4, 8))


def k8_plan_sweep(torch, dev, card):
    """K8a and K8b (the moments of a split's complement and the table; the
    carry update) alone at the DIME stage's shape for every (rows a run,
    runs a block) of ``K8_PLAN_SWEEP``: device us a call by CUDA events
    around graph replays.  The runs a block leave the bits as they are;
    the rows a run set them (the plain version follows either)."""
    from emcee_tpu_torch.ops import dime_kernel as dk

    gen = torch.Generator(device=dev).manual_seed(213)
    ng = NW // 2
    x = k8_rows(torch, dev, gen, (), NW, ND, 1, offset=0.0)
    carry = k8_carry(torch, dev, gen, (), 1, ND, True)
    cfg = dk.DimeConfig(1, 0.999, None, 1.0, 0.5, 1e-5)
    out = {}
    for rows, group in K8_PLAN_SWEEP:
        with forced_k8_paths(group=group):
            part = dk.dime_moments(x, (0, ng), carry[0], carry[2], 1,
                                   rows=rows)
            scratch = part.clone()
            upd = [t.clone() for t in carry]
            out[(rows, group)] = {
                "moments": replay_ms(torch, lambda: dk.dime_moments(
                    x, (0, ng), carry[0], carry[2], 1, rows=rows)),
                "finish": replay_ms(torch, lambda: dk.dime_finish(
                    scratch, *carry, cfg)),
                "update": replay_ms(torch, lambda: dk.dime_finish(
                    dk.dime_moments(x, (0, 0), upd[0], upd[2], 1,
                                    rows=rows), *upd, cfg, mode="update")),
                "blocks": part.shape[-3]}
    log("phase 21: (b) K8a + K8b at the DIME stage's shape (a split's "
        "5e4-row complement; the update's 1e5 rows) by (rows a run, runs a "
        "block), device us a call (graph replays): " + "; ".join(
            f"{k}: {v['moments'] * 1e3:.2f} + {v['finish'] * 1e3:.2f} "
            f"({v['blocks']} partials), update {v['update'] * 1e3:.2f}"
            for k, v in out.items()) + f" {card}")
    return {f"{r}x{g}": v for (r, g), v in out.items()}


def k8_alone(torch, dev, card):
    """(b) K8a, K8b and K8c alone at the DIME stage's shape (1e5 x 5, one
    component, ``df=None``, ``aimh_prob=1``: a split's complement of 5e4
    rows) and the bimodal stage's (1e5 x 3, two components, ``df=10``,
    ``aimh_prob=0.3``), a warm carry: device ms a call by CUDA events
    around graph replays (``replay_ms``), the carry update (K8a over the
    ensemble and K8b writing the carry), the plain versions (CUDA events,
    eager), the yardsticks ``torch.cov(x.T, correction=0)`` of the same
    complement rows and ``torch.linalg.cholesky_ex`` of the pooled shape
    (CUDA events, back to back: ``torch.cov`` cannot be recorded into a
    graph), a call back to back from Python (which the host's enqueue
    bounds), and the bounds (bytes, and instructions at the issue rate)."""
    from emcee_tpu_torch.ops import dime_kernel as dk
    from emcee_tpu_torch.ops.de_kernel import de_gamma0

    gen = torch.Generator(device=dev).manual_seed(211)
    out = {}
    for shape, (nd, K, df, aimh) in {
            "DIME stage": (ND, 1, None, 1.0),
            "bimodal stage": (3, 2, 10.0, 0.3)}.items():
        ng = NW // 2
        x = k8_rows(torch, dev, gen, (), NW, nd, K, offset=0.0)
        carry = k8_carry(torch, dev, gen, (), K, nd, True)
        cfg = dk.DimeConfig(K, 0.999, df, aimh, de_gamma0(None, nd), 1e-5)
        part = dk.dime_moments(x, (0, ng), carry[0], carry[2], K)
        scratch = part.clone()
        table = dk.dime_finish(part.clone(), *carry, cfg)
        upd = [t.clone() for t in carry]
        calls = {
            "dime_moments": lambda: dk.dime_moments(x, (0, ng), carry[0],
                                                    carry[2], K),
            "dime_finish": lambda: dk.dime_finish(scratch, *carry, cfg),
            "dime_propose": lambda: dk.dime_propose(x, 0, 2, table, 3, 5,
                                                    cfg),
            "update": lambda: dk.dime_finish(dk.dime_moments(
                x, (0, 0), upd[0], upd[2], K), *upd, cfg, mode="update"),
        }
        plain = {
            "dime_moments": lambda: dk.dime_moments_plain(
                x, (0, ng), carry[0], carry[2], K),
            "dime_finish": lambda: dk.dime_finish_plain(part, *carry, cfg),
            "dime_propose": lambda: dk.dime_propose_plain(
                x, 0, 2, table, 3, 5, cfg),
        }
        c = x[ng:]
        pooled = dk.unpack_table(table, K, nd)[1][0]
        pooled = pooled @ pooled.mT
        # torch.cov cannot be recorded into a graph: both yardsticks are
        # timed back to back by CUDA events, eagerly.
        lib = {"dime_moments": cuda_ms(
                   torch, lambda: torch.cov(c.T, correction=0)),
               "dime_finish": cuda_ms(
                   torch, lambda: torch.linalg.cholesky_ex(pooled))}
        bounds = k8_bounds(NW - ng, nd, K, part.shape[-3], ng, df, aimh)
        res = {}
        for name, fn in calls.items():
            r = res[name] = {"ms": replay_ms(torch, fn),
                             "call_ms": cuda_ms(torch, fn, reps=50)}
            if name in plain:
                r["plain_ms"] = slow_ms(torch, plain[name], reps=3)
                nbytes, instr, sfu = bounds[name]
                t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     "operations": instruction_bound(instr, sfu)}
                r.update(bound_ms=max(t.values()),
                         bound_by=max(t, key=t.get), bytes=nbytes,
                         instructions=instr, library_ms=lib.get(name))
        out[shape] = res
        log(f"phase 21: (b) K8 alone at the {shape}'s shape (1e5 x {nd}, "
            f"K={K}, df={df}, aimh_prob={aimh}), device us a call (graph "
            f"replays): " + ", ".join(
                f"{k} {v['ms'] * 1e3:.2f}" + (
                    f" (plain {v['plain_ms'] * 1e3:.1f}, bound "
                    f"{v['bound_ms'] * 1e3:.3f} by {v['bound_by']}"
                    + (f", library {v['library_ms'] * 1e3:.2f}"
                       if v.get("library_ms") else "") + ")"
                    if "plain_ms" in v else "")
                for k, v in res.items()) + f" {card}")
    return out


def k8_stage(torch, np, dev, card, n=16):
    """(c) The DIME stage's configuration (``bench.py:305-349``: 1e5 x
    5-D, ``DIMEMove(aimh_prob=1.0, df=None, randomize_split=False)``) for
    the one-ensemble rows: device us and kernels a proposal and each
    kernel's us a launch in ``n`` replayed proposals (profiler), the
    launches counted by device words (exactly ``K8_PER`` a proposal)."""
    from emcee_tpu_torch import EnsembleSampler, moves

    smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=23,
                          device=dev, moves=moves.DIMEMove(
                              aimh_prob=1.0, df=None, randomize_split=False))
    p0 = np.random.default_rng(4).normal(size=(NW, ND)).astype(np.float32)
    smp.run_mcmc(p0, n, store=False, skip_initial_state_check=True)
    smp.run_mcmc(None, n, store=False)
    win = busy_window(torch, lambda: smp.run_mcmc(None, n, store=False), n,
                      "phase 21 DIME stage", names=K8_PER)
    counted, _ = counted_replays(
        torch, dev, smp, n, lambda r: {k: v * n for k, v in K8_PER.items()},
        "phase 21 DIME stage", store=False)
    log(f"phase 21: (c) the DIME stage (1e5 x 5-D), {n} replayed "
        f"proposals: device {measured(win['device_us_per_proposal'])} us "
        f"and {measured(win['kernels_per_proposal'], '.0f')} kernels a "
        f"proposal, idle {measured(win['idle'], '.4f')}; us a launch: "
        + ", ".join(f"{k} {measured(v and v * 1e3, '.2f')}"
                    for k, v in win["ms_per_launch"].items())
        + f"; launches {counted} (device words, exactly {K8_PER} a "
        f"proposal) {card}")
    return dict(win=win, replayed_launches=counted, proposals_counted=n)


def pt21_sampler(dev, label, seed, backend=None):
    return pt_sampler(dev, seed=seed, backend=backend, move=pt21_move(label))


def pt21_path(torch, np, dev, card, label, p0, n_c=16, n_l=PT21_LOOP_N,
              kept=512, thin=4, sampler=None, per=None, phase="phase 21",
              hold=True):
    """(d) ``label`` at workload 4's configuration: over 64 proposals the
    graph chain (every rung at once) against the plain versions' eager
    chain and against the per-rung loop, bit for bit (the carries too);
    both paths in turns (batched, loop, loop, batched): host us, device us
    and kernels a proposal; the batched path's launches counted by device
    words (``per``, by default ``PT21_PER``; ``sampler(dev, label, seed,
    backend)`` makes the samplers, by default ``pt21_sampler``); then 512
    kept x 4 into ``PTDeviceBackend`` (the
    best of two timed runs: walker-steps/s, the cold rung's tau and
    ESS/s; held: a finite chain and tau, and phase 14's windows: the swap
    acceptance, the cold mode fraction, the cold |x0|'s mean and spread;
    with ``hold`` False they are reported only) and ``PTDeviceBackend`` ==
    ``PTBackend`` from one seed."""
    from emcee_tpu_torch.backends import PTBackend, PTDeviceBackend

    sampler = sampler or pt21_sampler
    per = PT21_PER if per is None else per
    out = {}
    t0 = time.perf_counter()

    def carries(smp):
        c = smp._move_carries[0]
        return tuple(v.clone() for v in c.values()) if c else ()

    ends = []
    for plain in (False, True):
        smp = sampler(dev, label, 87)
        smp._use_graphs = not plain
        with plain_kernels() if plain else contextlib.nullcontext():
            ends.append(pt_runs(smp, p0) + carries(smp))
    same_ends(np, *[[np_of(v.cpu()) if isinstance(v, torch.Tensor) else v
                     for v in e] for e in ends],
              f"{label}: graph-replayed and eager plain chains")
    paths = {}
    for batched in (True, False):
        smp = sampler(dev, label, 88)
        smp._batched = batched
        paths[batched] = (smp, pt_runs(smp, p0) + carries(smp))
        smp.run_mcmc(None, n_c if batched else n_l, store=False)
    a, b = paths[True][1], paths[False][1]
    same_ends(np, *[[np_of(v.cpu()) if isinstance(v, torch.Tensor) else v
                     for v in e] for e in (a, b)],
              f"{label}: every rung at once and the per-rung loop")
    out["swaps_64"] = a[4].tolist()
    host = {True: [], False: []}
    dev_us = {True: [], False: []}
    kernels = {True: [], False: []}
    for batched in (True, False, False, True):
        smp, n = (paths[True][0], n_c) if batched else (paths[False][0], n_l)
        _, dt = drive(smp, None, n, store=False)
        host[batched].append(dt / n * 1e6)
        win = busy_window(torch, lambda: smp.run_mcmc(None, n, store=False),
                          n, f"{label} {'batched' if batched else 'loop'}")
        dev_us[batched].append(win["device_us_per_proposal"])
        kernels[batched].append(win["kernels_per_proposal"])
    smp = paths[True][0]
    win = busy_window(torch, lambda: smp.run_mcmc(None, n_c, store=False),
                      n_c, f"{label} batched, its kernels", names=per)
    counted, profiled = counted_replays(
        torch, dev, smp, n_c, lambda r: {k: v * n_c
                                         for k, v in per.items()},
        f"{label} batched", store=False)
    out.update(host_us=host, device_us=dev_us, kernels=kernels, win=win,
               replayed_launches=counted, profiled_replayed=profiled,
               proposals_counted=n_c, loop_proposals_a_replay=n_l,
               seconds_paths=time.perf_counter() - t0)
    del paths

    t0 = time.perf_counter()
    smp = sampler(dev, label, 4, backend=PTDeviceBackend())
    st, _ = drive(smp, p0, kept, thin_by=thin, skip_initial_state_check=True)
    warm_graphs(smp)
    dt = float("inf")
    for _ in range(2):  # workloads5.py:224-233: the best of two
        smp.reset()
        st, dt_run = drive(smp, st, kept, thin_by=thin,
                           skip_initial_state_check=True)
        dt = min(dt, dt_run)
    n_prop = kept * thin
    chain = smp.get_chain()
    cold = chain[:, 0]
    tau = tau_of(np, cold, thin)
    if not (np.all(np.isfinite(chain)) and np.isfinite(tau)):
        raise AssertionError(f"{phase}: {label}: a chain or tau that is "
                             f"not finite (tau {tau})")
    x0 = cold[..., 0]
    swap_mean = float(np.mean(smp.tswap_acceptance_fraction))
    mode_frac = float(np.mean(x0 > 0))
    mean_abs, spread = float(np.mean(np.abs(x0))), float(np.std(np.abs(x0)))
    checks = {
        "swap acceptance mean in (0.4, 0.9)": 0.4 < swap_mean < 0.9,
        "cold mode fraction in (0.25, 0.75)": 0.25 < mode_frac < 0.75,
        "cold mean |x0| within 0.25 of 4": abs(mean_abs - PT_SEP) < 0.25,
        "cold spread of |x0| within 0.2 of 1": abs(spread - 1.0) < 0.2,
    }
    out["workload4"] = res = dict(
        walker_steps_per_s=NT4 * NW4 * n_prop / dt, seconds=dt, tau_cold=tau,
        ess_per_s_cold=NW4 * (n_prop / dt) / tau,
        tau_reliable=bool(n_prop / tau >= 30.0),
        swap_acceptance_mean=swap_mean, cold_mode_fraction=mode_frac,
        cold_mean_abs_x0=mean_abs, cold_spread_abs_x0=spread,
        cold_acceptance=float(smp.acceptance_fraction[0].mean()),
        checks=checks)
    chains = []
    for backend in (PTDeviceBackend(), PTBackend()):
        s2 = sampler(dev, label, 59, backend=backend)
        s2.run_mcmc(p0, kept, thin_by=thin, skip_initial_state_check=True)
        chains.append((s2.get_chain().astype(np.float64),
                       s2.get_log_like().astype(np.float64),
                       s2.get_log_prior().astype(np.float64),
                       s2.backend.accepted, s2.swaps_accepted,
                       s2.swaps_proposed, np_of(s2.backend.random_state)))
    same_ends(np, *chains, f"{label}: PTDeviceBackend and PTBackend chains")
    log(f"{phase}: (d) {label}, workload 4's configuration, "
        f"PTDeviceBackend, {kept} kept x {thin}: "
        f"{res['walker_steps_per_s']:.4e} walker-steps/s over all rungs "
        f"(best of two), cold tau {tau:.2f} proposals, cold ESS/s "
        f"{res['ess_per_s_cold']:.4e}, tau_reliable {res['tau_reliable']}, "
        f"swap acceptance mean {swap_mean:.3f}, cold mode fraction "
        f"{mode_frac:.3f}, cold mean |x0| {mean_abs:.3f} (spread "
        f"{spread:.3f}), cold acceptance {res['cold_acceptance']:.3f}; "
        f"checks {checks}; {kept} kept x {thin} into PTDeviceBackend == "
        f"PTBackend {card} ({time.perf_counter() - t0:.1f} s)")
    if hold and not all(checks.values()):
        raise AssertionError(f"{phase}: {label}: workload 4 checks "
                             f"{checks}")
    return out


def phase21(torch, np, dev, card):
    """K8, DIME's moments, factor and proposal (see the module docstring,
    21): the sweep, the kernels alone, the DIME stage's replays, the two
    moves on workload 4's ladder (every rung at once against the per-rung
    loop), each path's launches counted from 0 just before it, and the
    rows of K8a, K8b and K8c, one ensemble and with the rung axis.
    Returns its numbers and the rows."""
    out = {}
    t0 = time.perf_counter()
    out["sweep"] = k8_sweep(torch, dev)
    log(f"phase 21: (a) K8a, K8b and K8c against their plain versions "
        f"(ndim {K8_SWEEP_ND}, (rungs, walkers a split) {K8_SWEEP_TN}, K 1-3,"
        f" df {K8_SWEEP_DF}, aimh_prob 0.3 and 1, cold and warm carries, "
        f"both splits and the carry update, each rung of 3 against the "
        f"one-ensemble launch, injected draws, a device offset word, a "
        f"shape with no factor): {out['sweep']} comparisons, all bit for "
        f"bit ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out["alone"] = k8_alone(torch, dev, card)
    out["plan_sweep"] = k8_plan_sweep(torch, dev, card)
    log(f"phase 21: (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with path_launches(out, "DIME stage", tuple(K8_PER), "phase 21"):
        out["stage"] = k8_stage(torch, np, dev, card)
    log(f"phase 21: (c) {time.perf_counter() - t0:.1f} s")
    p0 = pt_p0(np)
    for label in PT21_MOVES:
        t0 = time.perf_counter()
        with path_launches(out, label, tuple(PT21_PER), "phase 21"):
            r = out[label] = pt21_path(torch, np, dev, card, label, p0)
        log(f"phase 21: (d) {label} at {NT4} x {NW4} x {ND4}: 64 "
            f"graph-replayed proposals of every rung at once equal the "
            f"plain versions' eager chain and the per-rung loop bit for bit,"
            f" carries included (swaps {r['swaps_64']}); in turns (batched, "
            f"loop, loop, batched; replays of {r['proposals_counted']} and "
            f"{r['loop_proposals_a_replay']} proposals), a proposal: host "
            f"{[round(v, 1) for v in r['host_us'][True]]} / "
            f"{[round(v, 1) for v in r['host_us'][False]]} us, device "
            f"{[measured(v) for v in r['device_us'][True]]} / "
            f"{[measured(v) for v in r['device_us'][False]]} us, kernels "
            f"{[measured(v, '.0f') for v in r['kernels'][True]]} / "
            f"{[measured(v, '.0f') for v in r['kernels'][False]]} (batched /"
            f" loop); batched launches in {r['proposals_counted']} proposals "
            f"{ {k: v for k, v in r['replayed_launches'].items() if v} } "
            f"(device words; exactly {PT21_PER} a proposal); us a launch in "
            f"its replays: " + ", ".join(
                f"{k} {measured(v and v * 1e3, '.3f')}"
                for k, v in r["win"]["ms_per_launch"].items())
            + f" {card} ({time.perf_counter() - t0:.1f} s)")
    log(f"phase 21: kernel wrapper launches of each path, counted from 0 "
        f"(recordings and eager runs): {out['launches']}")
    return out, phase21_rows(torch, dev, out, card)


def phase21_rows(torch, dev, out, card):
    """(e) The rows of K8a, K8b and K8c at the DIME stage's shape (device
    time a launch in the stage's replays by the profiler; launches by
    device words there; a call alone and the plain version by CUDA
    events; the bound and the yardstick at that shape) and with the rung
    axis (workload 4's ladder under ``DIMEMove()``: device time a launch
    in its replays, launches by device words there, a call alone and the
    plain version at its shape)."""
    from emcee_tpu_torch.ops import dime_kernel as dk
    from emcee_tpu_torch.ops.de_kernel import de_gamma0
    from emcee_tpu_torch.ops.philox import rung_keys

    st, al = out["stage"], out["alone"]
    lad = out["DIMEMove()"]
    meta = {
        "dime_moments": ("emcee_tpu_torch/csrc/dime_moments.cu",
                         "emcee_tpu/moves/dime.py:38-47, :180-231",
                         "torch.cov(x.T, correction=0) of the same "
                         "complement rows"),
        "dime_finish": ("emcee_tpu_torch/csrc/dime_moments.cu",
                        "emcee_tpu/moves/dime.py:133-155, :233-276",
                        "torch.linalg.cholesky_ex of the pooled shape"),
        "dime_propose": ("emcee_tpu_torch/csrc/dime_propose.cu",
                         "emcee_tpu/moves/dime.py:298-431",
                         "none: no single PyTorch call computes it"),
    }
    # The ladder's shapes: 16 rungs, a split's complement of 128 rows, ndim 5.
    T, nw, nd = NT4, NW4, ND4
    ng = nw // 2
    gen = torch.Generator(device=dev).manual_seed(212)
    x = k8_rows(torch, dev, gen, (T,), nw, nd, 1)
    carry = k8_carry(torch, dev, gen, (T,), 1, nd, [True] * T)
    cfg = dk.DimeConfig(1, 0.999, 10.0, 0.1, de_gamma0(None, nd), 1e-5)
    keys = rung_keys(5, T, dev)
    part = dk.dime_moments(x, (0, ng), carry[0], carry[2], 1)
    scratch = part.clone()
    table = dk.dime_finish(part.clone(), *carry, cfg)
    rung_calls = {
        "dime_moments": (lambda: dk.dime_moments(x, (0, ng), carry[0],
                                                 carry[2], 1),
                         lambda: dk.dime_moments_plain(x, (0, ng), carry[0],
                                                       carry[2], 1)),
        "dime_finish": (lambda: dk.dime_finish(scratch, *carry, cfg),
                        lambda: dk.dime_finish_plain(part, *carry, cfg)),
        "dime_propose": (lambda: dk.dime_propose(x, 0, 2, table, keys, 5,
                                                 cfg),
                         lambda: dk.dime_propose_plain(x, 0, 2, table, keys,
                                                       5, cfg)),
    }
    rbounds = k8_bounds(T * (nw - ng), nd, 1, T * part.shape[-3], T * ng,
                        10.0, 0.1)
    rows = []
    for name, (src, jax, lib_note) in meta.items():
        a = al["DIME stage"][name]
        regs = {k: v for k, v in PTXAS.items() if f"{name}_kernel" in k}
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": jax,
            "launches": st["replayed_launches"][name], "max_abs_err": 0.0,
            "ms": st["win"]["ms_per_launch"][name], "call_ms": a["call_ms"],
            "alone_ms": a["ms"],
            "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": a["bound_by"], "library_ms": a["library_ms"],
            "bytes": a["bytes"], "instructions": a["instructions"],
            "bimodal": al["bimodal stage"][name],
            "update_call_ms": al["DIME stage"]["update"]["ms"],
            "launches_per_proposal": (st["replayed_launches"][name]
                                      / st["proposals_counted"]),
            "ptxas": regs,
            "note": f"K8 at the DIME stage's shape (1e5 x 5-D, one "
                    f"component, df=None, aimh_prob=1: a split's complement "
                    f"of 5e4 rows): ms in the stage's replays (profiler); "
                    f"alone_ms a call alone (CUDA events around graph "
                    f"replays); call_ms a call back to back from Python "
                    f"(CUDA events); launches counted on the card in "
                    f"{st['proposals_counted']} replayed proposals; "
                    f"max_abs_err: bit for bit over phase 21's sweep of "
                    f"{out['sweep']} comparisons; bound: the bytes (each "
                    f"input once, each output once) and the instructions "
                    f"needed at the issue rate; bimodal: the same at the "
                    f"bimodal stage's shape; library_ms: {lib_note}"})
        fn, pl = rung_calls[name]
        nbytes, instr, sfu = rbounds[name]
        t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": instruction_bound(instr, sfu)}
        rows.append({
            "name": f"{name} (rung axis)", "route": "cuda", "source": src,
            "replaces": f"{jax} (vmapped by "
                        "emcee_tpu/parallel/tempering.py:449-541)",
            "launches": lad["replayed_launches"][name], "max_abs_err": 0.0,
            "ms": lad["win"]["ms_per_launch"][name],
            "call_ms": cuda_ms(torch, fn, reps=50),
            "alone_ms": replay_ms(torch, fn),
            "plain_ms": slow_ms(torch, pl, reps=3),
            "bound_ms": max(t.values()), "bound_by": max(t, key=t.get),
            "library_ms": None,
            "launches_per_proposal": (lad["replayed_launches"][name]
                                      / lad["proposals_counted"]),
            "path_device_us_batched_loop": (lad["device_us"][True],
                                            lad["device_us"][False]),
            "path_kernels_batched_loop": (lad["kernels"][True],
                                          lad["kernels"][False]),
            "note": f"K8 with the rung axis at workload 4's shape ({T} "
                    f"rungs x {nw} walkers x {nd}, DIMEMove()): ms in the "
                    f"ladder's replays (profiler); launches counted on the "
                    f"card in replayed proposals; alone_ms a call alone at "
                    f"that shape (CUDA events around graph replays), "
                    f"call_ms back to back from Python; "
                    f"max_abs_err: bit for bit over phase 21's sweep; "
                    f"library_ms: none, no single PyTorch call computes "
                    f"every rung's {'moments' if name == 'dime_moments' else 'factor' if name == 'dime_finish' else 'proposal'}"})
    for row in rows:
        log(f"phase 21: (e) {row['name']}: device "
            f"{measured(row['ms'] and row['ms'] * 1e3, '.2f')} us/launch in "
            f"its path's replays, {row['alone_ms'] * 1e3:.2f} us a call "
            f"alone, {row['call_ms'] * 1e3:.2f} back to back, plain "
            f"{row['plain_ms'] * 1e3:.1f} us, bound "
            f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}), library "
            f"{measured(row['library_ms'] and row['library_ms'] * 1e3, '.2f')}"
            f" us; launches {row['launches']} {card}")
    return rows


# -- 22. K10, DE-Z's spread, proposal and archive fold ------------------------
#: ndims of K10's sweep: K10b's columns unrolled (1-8) and looped (9, 100,
#: 129); K10a's rows staged in shared memory, and read from global memory
#: at 129
K10_SWEEP_ND = (1, 2, 5, 8, 9, 100, 129)
#: (walkers a split, nsplits) of the sweep; 50000 at ndim 5 and 129 only
K10_SWEEP_SHAPES = ((37, 2), (5003, 3), (5003, 4), (50000, 2))
#: the move's branches in the sweep: (g1_prob, snooker_prob, de_noise)
K10_SWEEP_CFG = ((0.1, 0.1, 1e-2), (1.0, 0.0, 0.0), (0.0, 1.0, 0.2),
                 (0.5, 0.5, 0.3), (0.0, 0.0, 1e-2))
#: (rungs, walkers a split, ndim) of the rung-axis sweep (phase 22)
K10_RUNG_SWEEP = ((3, 37, 1), (3, 37, 9), (16, 128, 5), (3, 501, 100))
#: K10's launches a DE-Z proposal: K10a and K10b a split, K10c the carry
K10_ONLY = {"dez_spread": 2, "dez_propose": 2, "dez_fold": 1}
K10_KERNELS = tuple(K10_ONLY)
#: with K2 a split and K14's one draw (the shuffled split's sort keys)
K10_PER = K10_ONLY | {"accept_select": 2, "philox_draw": 1}
#: phase 22's DEZMove() on workload 4's ladder (every rung at once): K10,
#: K2, K14, K15, K16 and K17
PT22_PER = K10_PER | {"pt_swap": 1} | SHUF4
#: proposals a replay of the per-rung loop's timed graph
PT22_LOOP_N = 4


def k10_config(nd, g1=0.1, snooker=0.1, noise=1e-2):
    """``DEZMove``'s constants at ndim ``nd`` (its defaults, or the branch
    given) as K10b takes them."""
    from emcee_tpu_torch.ops import dez_kernel as dk
    from emcee_tpu_torch.ops.de_kernel import de_gamma0

    return dk.DezConfig(de_gamma0(None, nd), 1e-5, g1, snooker, 1.7, noise,
                        nd - 1.0)


def k10_check(same, x, split, ns, z, filled, cfg, seed, offset, what,
              extra=None):
    """K10a (where the noise needs it) and K10b of one split, each against
    its plain version on the same inputs; returns the kernels' outputs."""
    from emcee_tpu_torch.ops import dez_kernel as dk

    ng = x.shape[-2] // ns
    part = None
    if cfg.de_noise > 0:
        part = dk.dez_spread(x, (split * ng, ng))
        same([part], [dk.dez_spread_plain(x, (split * ng, ng))],
             f"{what}: K10a")
    got = dk.dez_propose(x, split, ns, z, filled, part, seed, offset, cfg,
                         extra=extra)
    same(list(got), list(dk.dez_propose_plain(
        x, split, ns, z, filled, part, seed, offset, cfg, extra=extra)),
        f"{what}: K10b")
    return part, got


def k10_fold_check(same, x, z, words, nrows, calls, what):
    """``calls`` K10c folds of ``x`` into copies of the ring ``z`` and its
    words against the plain version's, compared after each."""
    from emcee_tpu_torch.ops import dez_kernel as dk

    a = [z.clone()] + [w.clone() for w in words]
    b = [z.clone()] + [w.clone() for w in words]
    for c in range(calls):
        dk.dez_fold(x, *a, nrows)
        dk.dez_fold_plain(x, *b, nrows)
        same(a, b, f"{what}: K10c call {c}")
    return a


@contextlib.contextmanager
def forced_k10_tree(shared):
    """K10b's prologue merging K10a's partials in shared memory (or from
    global memory, a thread a column), as forced, whatever the sizes."""
    from emcee_tpu_torch.ops import dez_kernel as dk

    saved = dk.tree_shared
    dk.tree_shared = lambda blocks, nd: shared
    try:
        yield
    finally:
        dk.tree_shared = saved


def k10_words(torch, dev, lead, filled, k, ptr=0, t=0):
    return [torch.tensor(v, dtype=torch.int32, device=dev).expand(
        lead).contiguous() for v in (filled, ptr % k, t)]


def k10_sweep(torch, dev):
    """(e) K10a, K10b and K10c against their plain versions, bit for bit
    (the bits compared, NaN included): ndim ``K10_SWEEP_ND``, (walkers a
    split, nsplits) ``K10_SWEEP_SHAPES``, the ring empty, a third filled
    and full, every branch of ``K10_SWEEP_CFG``, every split, a complement
    and archive at mean 1e4 (5003 x 3), unaligned bases (5003 x 4),
    injected draws and a device offset word against the same int offset,
    and K10c's folds over rings that wrap (one row, 64, a whole ensemble).
    K10b's prologue forced both ways (``forced_k10_tree``) and K10a's runs
    a block 1-8, each against the plan's bits.  Returns the count of
    comparisons."""
    from emcee_tpu_torch.ops import dez_kernel as dk
    from emcee_tpu_torch.ops.philox import DeviceOffset

    gen = torch.Generator(device=dev).manual_seed(220)
    n_cmp = 0

    def same(got, want, what):
        nonlocal n_cmp
        same_bits(got, want, what)
        n_cmp += len(got)

    for nd in K10_SWEEP_ND:
        for ng, ns in K10_SWEEP_SHAPES:
            if ng == 50000 and nd not in (5, 129):
                continue
            nw, k = ng * ns, ng + 64
            mean = 1e4 if ns == 3 else 0.0
            x = (mean + 1.5 * torch.randn(nw, nd, device=dev,
                                          generator=gen)).contiguous()
            z = (mean + torch.randn(k, nd, device=dev, generator=gen)
                 ).contiguous()
            if ns == 4:
                x, z = misaligned(torch, x), misaligned(torch, z)
            tag = f"K10 sweep nd={nd} ng={ng} ns={ns}"
            for fi, filled in enumerate((0, k // 3, k)):
                fw = torch.tensor(filled, dtype=torch.int32, device=dev)
                for ci, branch in enumerate(K10_SWEEP_CFG):
                    k10_check(same, x, (fi + ci) % ns, ns,
                              z, fw, k10_config(nd, *branch), 31 + ci,
                              5 + fi, f"{tag} filled={filled} {branch}")
            fw = torch.tensor(k // 3, dtype=torch.int32, device=dev)
            cfg = k10_config(nd, 0.5, 0.5, 0.3)
            w8 = torch.tensor(40, dtype=torch.int64, device=dev)
            part, got = k10_check(same, x, 1, ns, z, fw,
                                  cfg, 17, DeviceOffset(w8, 2),
                                  f"{tag} device offset")
            same(list(got), list(k10_check(
                same, x, 1, ns, z, fw, cfg, 17, 42,
                f"{tag} int offset")[1]), f"{tag}: a device offset word "
                "against the int offset")
            if ng < 50000:
                n_avail = nw - ng + k // 3
                extra = dict(
                    i=torch.randint(0, n_avail, (ng,), device=dev,
                                    generator=gen),
                    j=torch.randint(0, n_avail - 1, (ng,), device=dev,
                                    generator=gen),
                    a=torch.randint(0, n_avail, (ng,), device=dev,
                                    generator=gen),
                    b=torch.randint(0, n_avail, (ng,), device=dev,
                                    generator=gen),
                    e=torch.randint(0, n_avail, (ng,), device=dev,
                                    generator=gen),
                    jump=torch.rand(ng, device=dev, generator=gen) < 0.5,
                    snooker=torch.rand(ng, device=dev, generator=gen) < 0.5,
                    z=torch.randn(ng, 1 + nd, device=dev, generator=gen))
                k10_check(same, x, ns - 1, ns, z, fw, cfg, 0,
                          0, f"{tag} injected draws", extra=extra)
            if ng == 5003 and nd in (1, 9):
                # K10b's two prologues forced, and K10a's runs a block
                # (no bit changes with either).
                ref = None
                for shared in (True, False):
                    with forced_k10_tree(shared):
                        got = k10_check(same, x, 0, ns, z, fw, cfg, 9, 1,
                                        f"{tag} shared tree {shared}")[1]
                    if ref is not None:
                        same(list(got), list(ref), f"{tag}: the two "
                             "prologues")
                    ref = got
                for g in (1, 2, 4, 8):
                    part = dk.dez_spread(x, (0, ng), group=g)
                    same([part], [dk.dez_spread_plain(x, (0, ng), group=g)],
                         f"{tag} group {g}: K10a")
                    same(list(dk.dez_propose(x, 0, ns, z, fw, part, 9, 1,
                                             cfg)), list(ref),
                         f"{tag} group {g}: K10b against the plan's")
            # Folds over a ring that wraps within the first calls.
            for nrows in sorted({1, 64, min(nw, k)}):
                k10_fold_check(same, x, z, k10_words(
                    torch, dev, (), k - 5, k, k - 20, 7), nrows,
                    3 if nrows > 1 else 25, f"{tag} nrows={nrows}")
    torch.cuda.synchronize()
    return n_cmp


def k10_rung_sweep(torch, dev):
    """(a) K10a, K10b and K10c with the rung axis against their plain
    versions and each rung against the one-ensemble launch under its own
    key, bit for bit: (rungs, walkers a split, ndim) ``K10_RUNG_SWEEP``,
    every rung's ring filled otherwise (empty, partly, full), each branch
    of ``K10_SWEEP_CFG``, both splits, and the folds.  Returns the count
    of comparisons."""
    from emcee_tpu_torch.ops.philox import rung_keys

    gen = torch.Generator(device=dev).manual_seed(221)
    n_cmp = 0

    def same(got, want, what):
        nonlocal n_cmp
        same_bits(got, want, what)
        n_cmp += len(got)

    for T, ng, nd in K10_RUNG_SWEEP:
        nw, k = 2 * ng, 3 * ng
        x = (torch.randn(T, nw, nd, device=dev, generator=gen)
             * torch.linspace(0.5, 3.0, T, device=dev)[:, None, None]
             ).contiguous()
        z = torch.randn(T, k, nd, device=dev, generator=gen)
        filled = torch.tensor([(r * k) // (T - 1) for r in range(T)],
                              dtype=torch.int32, device=dev)
        keys = rung_keys(41, T, dev)
        tag = f"K10 rung sweep T={T} ng={ng} nd={nd}"
        for ci, branch in enumerate(K10_SWEEP_CFG):
            cfg = k10_config(nd, *branch)
            for split in (0, 1):
                what = f"{tag} {branch} split {split}"
                part, (q, f) = k10_check(same, x, split, 2,
                                         z, filled, cfg, keys, 3 + ci, what)
                for r in (0, T // 2, T - 1):
                    pr, (qr, fr) = k10_check(
                        same, x[r].contiguous(), split, 2,
                        z[r].contiguous(), filled[r].contiguous(), cfg,
                        keys.seeds[r], 3 + ci, f"{what}, rung {r} alone")
                    same([qr, fr] + ([pr] if part is not None else []),
                         [q[r], f[r]] + ([part[r]] if part is not None
                                         else []),
                         f"{what}: rung {r} against one ensemble")
        words = k10_words(torch, dev, (T,), k - 3, k, k - 10, 5)
        a = k10_fold_check(same, x, z, words, min(64, nw), 4,
                           f"{tag} folds")
        for r in (0, T - 1):
            b = k10_fold_check(same, x[r].contiguous(),
                               z[r].contiguous(),
                               [w[r].contiguous() for w in words],
                               min(64, nw), 4, f"{tag} folds, rung {r}")
            same(b, [t[r] for t in a], f"{tag}: rung {r}'s folds against "
                 "one ensemble")
    torch.cuda.synchronize()
    return n_cmp


def k10_bounds(T, nw, nd, ng, cfg, blocks, nrows):
    """The least work of K10a (the complement's rows once, the partials
    written; a subtract and an add a value for the mean, a subtract, a
    multiply and an add for the sum of squares), K10b (each walker's row
    and its pool rows read, DE's two or the snooker's three, its q and
    factor written, the partials read once a rung; the Philox blocks,
    normals and arithmetic a walker needs) and K10c (the folded rows read
    and written, three words), as ``{name: (bytes, instructions,
    special-function results)}``, summed over ``T`` rungs."""
    nc = nw - ng
    p_sn = cfg.snooker_prob
    node = 1 + 2 * nd
    normals = (1 - p_sn) * (1 + (nd if cfg.de_noise > 0 else 0))
    blocks_w = 2 + (1 - p_sn) * (1 + (nd if cfg.de_noise > 0 else 0)) / 2
    per_walker = (blocks_w * PHILOX_INSTR + normals * NORMAL_INSTR
                  + (1 - p_sn) * 4 * nd + p_sn * 10 * nd + 30)
    return {
        "dez_spread": (4 * T * (nc * nd + blocks * node),
                       T * nc * nd * 5, 0),
        "dez_propose": (4 * T * (ng * nd * (2 + 2 + p_sn) + ng + blocks
                                 * node),
                        T * ng * per_walker,
                        T * ng * (normals * NORMAL_SFU + p_sn * 3)),
        "dez_fold": (4 * T * (2 * nrows * nd + 6), T * nrows * nd * 4, 0),
    }


def k10_alone(torch, dev, card, T=1, nw=NW, nd=ND):
    """(b) K10a, K10b and K10c alone at ``DEZMove()``'s shape, one ensemble
    of 1e5 x 5 (a split's complement of 5e4 rows, the 1e6-row ring full;
    ``T`` rungs of ``nw`` walkers on a ladder): device ms a call by CUDA
    events around graph replays (``replay_ms``), a call back to back from
    Python, the plain versions (CUDA events, eager), the yardsticks
    ``torch.std(correction=0)`` of the complement (K10a) and
    ``index_select`` + ``index_copy_`` of the folded rows (K10c), and the
    bounds (bytes, and instructions at the issue rate)."""
    from emcee_tpu_torch import moves
    from emcee_tpu_torch.ops import dez_kernel as dk
    from emcee_tpu_torch.ops.philox import rung_keys

    gen = torch.Generator(device=dev).manual_seed(222)
    lead = (T,) if T > 1 else ()
    mv = moves.DEZMove()
    k = mv._capacity(nw)
    nrows = mv._rows(nw)
    ng = nw // 2
    x = torch.randn(lead + (nw, nd), device=dev, generator=gen)
    z = torch.randn(lead + (k, nd), device=dev, generator=gen)
    words = k10_words(torch, dev, lead, k, k, 17, 3)
    cfg = k10_config(nd)
    seed = rung_keys(5, T, dev) if T > 1 else 5
    part = dk.dez_spread(x, (0, ng))
    fz = [z.clone()] + [w.clone() for w in words]
    base = torch.arange(T, device=dev)[:, None]
    idx = ((3 + torch.arange(nrows, device=dev) * max(1, nw // nrows)) % nw
           + base * nw).reshape(-1)
    slots = ((17 + torch.arange(nrows, device=dev)) % k
             + base * k).reshape(-1)
    flat_x, flat_z = x.view(-1, nd), fz[0].view(-1, nd)
    comp = x[..., ng:, :]
    calls = {
        "dez_spread": (lambda: dk.dez_spread(x, (0, ng)),
                       lambda: dk.dez_spread_plain(x, (0, ng)),
                       lambda: comp.std(-2, correction=0)),
        "dez_propose": (lambda: dk.dez_propose(x, 0, 2, z, words[0], part,
                                               seed, 5, cfg),
                        lambda: dk.dez_propose_plain(x, 0, 2, z, words[0],
                                                     part, seed, 5, cfg),
                        None),
        "dez_fold": (lambda: dk.dez_fold(x, *fz, nrows),
                     lambda: dk.dez_fold_plain(x, *fz, nrows),
                     lambda: flat_z.index_copy_(0, slots, flat_x.index_select(
                         0, idx))),
    }
    bounds = k10_bounds(T, nw, nd, ng, cfg, part.shape[-2], nrows)
    out = {}
    for name, (fn, plain, lib) in calls.items():
        nbytes, instr, sfu = bounds[name]
        t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": instruction_bound(instr, sfu)}
        out[name] = {"ms": replay_ms(torch, fn),
                     "call_ms": cuda_ms(torch, fn, reps=50),
                     "plain_ms": slow_ms(torch, plain, reps=3),
                     "bound_ms": max(t.values()),
                     "bound_by": max(t, key=t.get), "bytes": nbytes,
                     "instructions": instr,
                     "library_ms": None if lib is None else replay_ms(
                         torch, lib)}
    what = ("one ensemble of 1e5 x 5" if T == 1
            else f"{T} rungs x {nw} walkers x {nd}")
    log(f"phase 22: (b) K10 alone at DEZMove()'s shape ({what}; a split's "
        f"complement of {nw - ng} rows, a ring of {k} rows, {nrows} folded "
        f"a proposal), device us a call (graph replays): " + ", ".join(
            f"{name} {v['ms'] * 1e3:.2f} (back to back "
            f"{v['call_ms'] * 1e3:.2f}, plain {v['plain_ms'] * 1e3:.1f}, "
            f"bound {v['bound_ms'] * 1e3:.3f} by {v['bound_by']}"
            + (f", library {v['library_ms'] * 1e3:.2f}"
               if v["library_ms"] is not None else "") + ")"
            for name, v in out.items()) + f" {card}")
    return out


#: (rows a run, runs a K10a block) timed by ``k10_plan_sweep``
K10_PLAN_SWEEP = tuple((r, g) for r in (32, 64, 128) for g in (1, 2, 4, 8))


def k10_plan_sweep(torch, dev, card):
    """K10a and K10b (the split's complement's partials; the proposal that
    merges them in its prologue) alone at ``DEZMove()``'s shape at 1e5 for
    every (rows a run, runs a block) of ``K10_PLAN_SWEEP``: device us a
    call by CUDA events around graph replays.  The runs a block leave the
    bits as they are; the rows a run set them (the plain version follows
    either)."""
    from emcee_tpu_torch import moves
    from emcee_tpu_torch.ops import dez_kernel as dk

    gen = torch.Generator(device=dev).manual_seed(223)
    ng = NW // 2
    k = moves.DEZMove()._capacity(NW)
    x = torch.randn(NW, ND, device=dev, generator=gen)
    z = torch.randn(k, ND, device=dev, generator=gen)
    filled = torch.tensor(k, dtype=torch.int32, device=dev)
    cfg = k10_config(ND)
    out = {}
    for rows, group in K10_PLAN_SWEEP:
        part = dk.dez_spread(x, (0, ng), rows=rows, group=group)
        out[(rows, group)] = {
            "spread": replay_ms(torch, lambda: dk.dez_spread(
                x, (0, ng), rows=rows, group=group)),
            "propose": replay_ms(torch, lambda: dk.dez_propose(
                x, 0, 2, z, filled, part, 3, 5, cfg)),
            "blocks": part.shape[-2]}
    # K10b without the noise: no partials, no prologue.
    quiet = k10_config(ND, noise=0.0)
    out["no noise"] = {"propose": replay_ms(torch, lambda: dk.dez_propose(
        x, 0, 2, z, filled, None, 3, 5, quiet))}
    log("phase 22: (b) K10a + K10b at DEZMove()'s shape (1e5 x 5, a split's "
        "5e4-row complement) by (rows a run, runs a block), device us a "
        "call (graph replays): " + "; ".join(
            f"{key}: {v['spread'] * 1e3:.2f} + {v['propose'] * 1e3:.2f} "
            f"({v['blocks']} partials)" for key, v in out.items()
            if key != "no noise")
        + f"; K10b with de_noise=0 (no prologue) "
        f"{out['no noise']['propose'] * 1e3:.2f} {card}")
    return {(k if isinstance(k, str) else f"{k[0]}x{k[1]}"): v
            for k, v in out.items()}


def k10_stage(torch, np, dev, card, n=16):
    """(c) ``DEZMove()`` at 1e5 x 5-D (its defaults: the shuffled split, a
    1e6-row ring) for the one-ensemble rows: device us and kernels a
    proposal and each kernel's us a launch in ``n`` replayed proposals
    (profiler), the launches counted by device words (exactly ``K10_PER``
    and the shuffle's a proposal)."""
    from emcee_tpu_torch import EnsembleSampler, moves

    smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=24,
                          device=dev, moves=moves.DEZMove())
    p0 = np.random.default_rng(4).normal(size=(NW, ND)).astype(np.float32)
    smp.run_mcmc(p0, n, store=False, skip_initial_state_check=True)
    smp.run_mcmc(None, n, store=False)
    per = K10_PER | shuffle_of(smp._moves[0])
    win = busy_window(torch, lambda: smp.run_mcmc(None, n, store=False), n,
                      "phase 22 DEZMove() at 1e5", names=per)
    counted, _ = counted_replays(
        torch, dev, smp, n, lambda r: {k: v * n for k, v in per.items()},
        "phase 22 DEZMove() at 1e5", store=False)
    log(f"phase 22: (c) DEZMove() at 1e5 x 5-D, {n} replayed proposals: "
        f"device {measured(win['device_us_per_proposal'])} us and "
        f"{measured(win['kernels_per_proposal'], '.0f')} kernels a "
        f"proposal, idle {measured(win['idle'], '.4f')}; us a launch: "
        + ", ".join(f"{k} {measured(v and v * 1e3, '.2f')}"
                    for k, v in win["ms_per_launch"].items())
        + f"; launches { {k: v for k, v in counted.items() if v} } (device "
        f"words, exactly {per} a proposal) {card}")
    return dict(win=win, replayed_launches=counted, proposals_counted=n)


def pt22_sampler(dev, label, seed, backend=None):
    from emcee_tpu_torch import moves

    return pt_sampler(dev, seed=seed, backend=backend,
                      move=moves.DEZMove())


def phase22(torch, np, dev, card):
    """K10, DE-Z's spread, proposal and archive fold (see the module
    docstring, 22): the rung-axis sweep, the kernels alone at 1e5 and on
    the ladder, ``DEZMove()``'s replays at 1e5, ``DEZMove()`` on workload
    4's ladder (every rung at once against the per-rung loop), each path's
    launches counted from 0 just before it, and the rows of K10a, K10b
    and K10c, one ensemble and with the rung axis.  Returns its numbers
    and the rows."""
    out = {}
    t0 = time.perf_counter()
    out["sweep"] = k10_rung_sweep(torch, dev)
    log(f"phase 22: (a) K10a, K10b and K10c with the rung axis against "
        f"their plain versions and each rung against the one-ensemble "
        f"launch ((rungs, walkers a split, ndim) {K10_RUNG_SWEEP}, every "
        f"branch, both splits, the folds): {out['sweep']} comparisons, all "
        f"bit for bit ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out["alone"] = k10_alone(torch, dev, card)
    out["alone_rungs"] = k10_alone(torch, dev, card, NT4, NW4, ND4)
    out["plan_sweep"] = k10_plan_sweep(torch, dev, card)
    log(f"phase 22: (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with path_launches(out, "DEZMove() at 1e5", K10_KERNELS, "phase 22"):
        out["stage"] = k10_stage(torch, np, dev, card)
    log(f"phase 22: (c) {time.perf_counter() - t0:.1f} s")
    p0 = pt_p0(np)
    t0 = time.perf_counter()
    label = "DEZMove()"
    with path_launches(out, label, tuple(PT22_PER), "phase 22"):
        r = out[label] = pt21_path(torch, np, dev, card, label, p0,
                                   n_l=PT22_LOOP_N, sampler=pt22_sampler,
                                   per=PT22_PER, phase="phase 22")
    log(f"phase 22: (d) {label} at {NT4} x {NW4} x {ND4}: 64 graph-replayed "
        f"proposals of every rung at once equal the plain versions' eager "
        f"chain and the per-rung loop bit for bit, archives and words "
        f"included (swaps {r['swaps_64']}); in turns (batched, loop, loop, "
        f"batched; replays of {r['proposals_counted']} and "
        f"{r['loop_proposals_a_replay']} proposals), a proposal: host "
        f"{[round(v, 1) for v in r['host_us'][True]]} / "
        f"{[round(v, 1) for v in r['host_us'][False]]} us, device "
        f"{[measured(v) for v in r['device_us'][True]]} / "
        f"{[measured(v) for v in r['device_us'][False]]} us, kernels "
        f"{[measured(v, '.0f') for v in r['kernels'][True]]} / "
        f"{[measured(v, '.0f') for v in r['kernels'][False]]} (batched / "
        f"loop); batched launches in {r['proposals_counted']} proposals "
        f"{ {k: v for k, v in r['replayed_launches'].items() if v} } "
        f"(device words; exactly {PT22_PER} a proposal); us a launch in its "
        f"replays: " + ", ".join(
            f"{k} {measured(v and v * 1e3, '.3f')}"
            for k, v in r["win"]["ms_per_launch"].items())
        + f" {card} ({time.perf_counter() - t0:.1f} s)")
    log(f"phase 22: kernel wrapper launches of each path, counted from 0 "
        f"(recordings and eager runs): {out['launches']}")
    return out, phase22_rows(out, card)


def phase22_rows(out, card):
    """(e) The rows of K10a, K10b and K10c at ``DEZMove()``'s shape at 1e5
    (device time a launch in its replays by the profiler; launches by
    device words there; a call alone, back to back and the plain version
    by CUDA events; the bound and the yardstick) and with the rung axis
    (workload 4's ladder under ``DEZMove()``: the same from its replays
    and at its shape)."""
    meta = {
        "dez_spread": ("emcee_tpu_torch/csrc/dez_propose.cu",
                       "emcee_tpu/moves/de_z.py:185-189",
                       "torch.std(correction=0) of the same complement rows"),
        "dez_propose": ("emcee_tpu_torch/csrc/dez_propose.cu",
                        "emcee_tpu/moves/de_z.py:144-225",
                        "none: no single PyTorch call computes it"),
        "dez_fold": ("emcee_tpu_torch/csrc/dez_archive.cu",
                     "emcee_tpu/moves/de_z.py:227-280",
                     "index_select of the folded rows + index_copy_ into "
                     "the ring"),
    }
    rows = []
    for rung in (False, True):
        path = out["DEZMove()"] if rung else out["stage"]
        shape = (f"with the rung axis at workload 4's shape ({NT4} rungs x "
                 f"{NW4} walkers x {ND4}" if rung else
                 "at DEZMove()'s shape (1e5 x 5-D, a 1e6-row ring")
        al = out["alone_rungs" if rung else "alone"]
        for name, (src, jax, lib_note) in meta.items():
            a = al[name]
            regs = {k: v for k, v in PTXAS.items() if f"{name}_kernel" in k}
            rows.append({
                "name": f"{name} (rung axis)" if rung else name,
                "route": "cuda", "source": src,
                "replaces": jax + (" (vmapped by emcee_tpu/parallel/"
                                   "tempering.py:439-541)" if rung else ""),
                "launches": path["replayed_launches"][name],
                "max_abs_err": 0.0,
                "ms": path["win"]["ms_per_launch"][name],
                "alone_ms": a["ms"], "call_ms": a["call_ms"],
                "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
                "bound_by": a["bound_by"], "library_ms": a["library_ms"],
                "bytes": a["bytes"], "instructions": a["instructions"],
                "launches_per_proposal": (path["replayed_launches"][name]
                                          / path["proposals_counted"]),
                "ptxas": regs,
                **({"path_device_us_batched_loop": (path["device_us"][True],
                                                    path["device_us"][False]),
                    "path_kernels_batched_loop": (path["kernels"][True],
                                                  path["kernels"][False])}
                   if rung else {}),
                "note": (f"K10 {shape}, DEZMove()): ms in the path's replays "
                         f"(profiler); alone_ms a call alone (CUDA events "
                         f"around graph replays), call_ms back to back from "
                         f"Python; launches counted on the card in "
                         f"{path['proposals_counted']} replayed proposals; "
                         f"max_abs_err: bit for bit over the sweeps of "
                         f"phases 12 (e) and 22 (a) ({out['sweep']} "
                         f"rung-axis comparisons); bound: the bytes (each "
                         f"input once, each output once) and the "
                         f"instructions needed at the issue rate; "
                         f"library_ms: {lib_note}")})
    for row in rows:
        log(f"phase 22: (e) {row['name']}: device "
            f"{measured(row['ms'] and row['ms'] * 1e3, '.2f')} us/launch in "
            f"its path's replays, {row['alone_ms'] * 1e3:.2f} us a call "
            f"alone, {row['call_ms'] * 1e3:.2f} back to back, plain "
            f"{row['plain_ms'] * 1e3:.1f} us, bound "
            f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}), library "
            f"{measured(row['library_ms'] and row['library_ms'] * 1e3, '.2f')}"
            f" us; launches {row['launches']} {card}")
    return rows


# -- phase 23: K9, the slice move's loops -----------------------------------

#: K9's wrappers, in launch order of a group
K9_KERNELS = ("slice_setup", "slice_step_out", "slice_shrink", "slice_finish")
#: (rungs, walkers a group, nsplits, ndim) of K9's sweep: ndim 1, 2, 5, 8
#: and 100; groups odd, at bucket boundaries (2 ng a power of two) and of
#: the main path (5e4); 1, 3 and 16 rungs
K9_SWEEP = ((1, 37, 2, 1), (1, 32, 2, 2), (1, 5003, 2, 5), (1, 256, 3, 8),
            (1, 129, 2, 100), (1, 50000, 2, 5), (3, 37, 2, 5),
            (3, 64, 3, 2), (16, 128, 2, 5), (16, 33, 2, 1), (3, 21, 2, 100))
#: (bucket floor, trips a block) of the sweep's loops
K9_SWEEP_LOOPS = ((32, 4), (1, 1), (1024, 3))
#: the bucket floors timed by the plan sweep at 1e5 walkers
K9_FLOORS = (32, 256, 2048, 1 << 30)
#: a proposal's launches of the slice move on workload 4's ladder, every
#: rung at once, besides K9b's and K9c's trips (K9a and K9d a split, K9c's
#: first form a split, K15, and the shuffle's keys and K16 / K17)
PT23_FIXED = {"slice_setup": 2, "slice_finish": 2, "pt_swap": 1,
              "philox_draw": 1} | SHUF4


def k9_blobs(torch, q):
    """The sweep's blob leaves of rows ``q`` (``(T, n, nd)``): a float32
    scalar, the rows themselves (a view of the evaluated rows), a bool
    and a float64 scalar."""
    lp = -0.5 * (q * q).sum(-1)
    return lp, [2.0 * lp, q, q[..., 0] > 0, q.sum(-1).double()]


def k9_state(st):
    """Every buffer of K9's loop state that both versions write."""
    return [st.eta, st.y, st.ends, st.budget, st.cnt, st.t, st.t_acc,
            st.lp_acc, st.done, st.lists, st.pts, st.words, st.sums,
            st.counters, *st.blobs_acc]


def k9_lockstep(torch, same, routes, split, ns, seed, offset, cfg, scale,
                extra, shrink_u, floor, block, what):
    """One group's setup, stepping out, shrink and finish on each route
    (``routes``: the kernels' and the plain versions', each a dict of its
    own buffers and functions) in lockstep, the bucket rule of
    ``chunk_graph.GraphLoops.compacted``, every buffer compared bit for bit
    after every launch."""
    from emcee_tpu_torch.chunk_graph import bucket_of

    ng = routes[0]["st"].shape[1]

    def both(call, step):
        for r in routes:
            call(r)
        same(*[k9_state(r["st"]) + [r["x"], r["lp"], r["acc"], r["cnt"],
                                    *r["leaves"]] for r in routes],
             f"{what}: {step}")

    both(lambda r: r["fns"][0](r["x"], r["lp"], split, ns, r["st"], seed,
                               offset, cfg, scale=scale, extra=extra),
         "K9a")
    for loop, top, start in ((0, 2 * ng, cfg.max_steps > 1),
                             (1, ng, cfg.max_shrink > 0)):
        if loop:
            both(lambda r: r["fns"][2](r["x"], None, [], split, ns, r["st"],
                                       0, 0, seed, offset, cfg, shrink_u),
                 "K9c's first list")
        blocks, bucket, go = 0, top, start
        while go:
            for b in range(block):
                parity = (blocks * block + b) & 1

                def trip(r, bucket=bucket, parity=parity):
                    lp_q, bl = k9_blobs(torch, r["st"].pts[parity][:, :bucket])
                    if loop:
                        r["fns"][2](r["x"], lp_q, bl, split, ns, r["st"],
                                    bucket, parity, seed, offset, cfg,
                                    shrink_u)
                    else:
                        r["fns"][1](r["x"], lp_q, split, ns, r["st"], bucket,
                                    parity, cfg)

                both(trip, f"{('K9b', 'K9c')[loop]} bucket {bucket}")
            blocks += 1
            m = max(routes[0]["st"].length().tolist())
            go = m > 0
            if go:
                bucket = bucket_of(m, top, floor)
    both(lambda r: r["fns"][3](r["x"], r["lp"], split, ns, r["st"], r["acc"],
                               r["cnt"], r["leaves"]), "K9d")


def k9_sweep(torch, dev):
    """(a) K9a, K9b, K9c and K9d against their plain versions in lockstep,
    every buffer of the loop state and of the ensemble compared bit for
    bit after every launch: (rungs, walkers a group, nsplits, ndim)
    ``K9_SWEEP``, every split, four blob leaves (float32, the evaluated
    rows, bool, float64), the caps binding (``max_steps=2``,
    ``max_shrink=2`` at ``mu=20``) and not, a tuned scale, injected draws,
    a device offset word, bucket floors and trips a block
    ``K9_SWEEP_LOOPS``.  Returns the count of comparisons."""
    from emcee_tpu_torch.ops import slice_kernel as sk
    from emcee_tpu_torch.ops.philox import DeviceOffset, rung_keys

    gen = torch.Generator(device=dev).manual_seed(230)
    n_cmp = 0

    def same(got, want, what):
        nonlocal n_cmp
        same_bits(got, want, what)
        n_cmp += len(got)

    fns = {"kernel": (sk.slice_setup, sk.slice_step_out, sk.slice_shrink,
                      sk.slice_finish),
           "plain": (sk.slice_setup_plain, sk.slice_step_out_plain,
                     sk.slice_shrink_plain, sk.slice_finish_plain)}
    word = torch.tensor(40, dtype=torch.int64, device=dev)
    for ci, (T, ng, ns, nd) in enumerate(K9_SWEEP):
        nw = ng * ns
        x0 = torch.randn(T, nw, nd, device=dev, generator=gen)
        lp0, leaves0 = k9_blobs(torch, x0)
        seed = rung_keys(23 + ci, T, dev) if T > 1 else 23 + ci
        big = ng >= 50000
        cases = [("plain", sk.SliceConfig(1.0, 100, 100, True), None, {},
                  None, 7, K9_SWEEP_LOOPS[ci % 3])]
        if not big:
            cases += [
                ("caps", sk.SliceConfig(20.0, 2, 2, True), None, {}, None,
                 DeviceOffset(word, 3), K9_SWEEP_LOOPS[(ci + 1) % 3]),
                ("scale", sk.SliceConfig(0.5, 7, 100, False),
                 torch.rand(T, device=dev, generator=gen) + 0.5, {}, None, 9,
                 K9_SWEEP_LOOPS[(ci + 2) % 3]),
                ("injected", sk.SliceConfig(1.0, 10, 12, True), None, dict(
                    i=torch.randint(0, nw - ng, (T, ng), device=dev,
                                    generator=gen),
                    j=torch.randint(0, nw - ng - 1, (T, ng), device=dev,
                                    generator=gen),
                    u=torch.rand(T, ng, device=dev, generator=gen),
                    j_l=torch.randint(0, 10, (T, ng), device=dev,
                                      generator=gen),
                    log_u=torch.log(torch.rand(T, ng, device=dev,
                                               generator=gen))),
                 torch.rand(T, ng, 12, device=dev, generator=gen), 0,
                 (1, 2))]
        for label, cfg, scale, extra, shrink_u, offset, loops in cases:
            floor, block = loops
            routes = []
            for route in ("kernel", "plain"):
                leaves = [b.clone() for b in leaves0]
                routes.append(dict(
                    fns=fns[route], x=x0.clone(), lp=lp0.clone(),
                    acc=torch.zeros(T, nw, dtype=torch.bool, device=dev),
                    cnt=torch.zeros(T, nw, dtype=torch.int32, device=dev),
                    leaves=leaves, st=sk.LoopState(T, ng, nd, x0.dtype, dev,
                                                   leaves)))
            for split in range(ns):
                k9_lockstep(torch, same, routes, split, ns, seed, offset,
                            cfg, scale, extra, shrink_u, floor, block,
                            f"K9 sweep T={T} ng={ng} ns={ns} nd={nd} "
                            f"{label} split {split}")
            if label == "caps" and bool(routes[0]["acc"].all()):
                raise AssertionError(f"K9 sweep T={T} ng={ng}: the caps "
                                     "left every walker accepted")
    torch.cuda.synchronize()
    return n_cmp


def k9_snapshot(st, bufs):
    """A copy of K9's loop state and the ensemble's buffers, and the
    function that puts it back."""
    saved = [t.clone() for t in k9_state(st) + bufs]

    def restore():
        for t, v in zip(k9_state(st) + bufs, saved):
            t.copy_(v)

    return restore


def behind_ms(torch, fn, prep, reps=20):
    """Device ms of one call of ``fn`` after ``prep`` (untimed): CUDA
    events around the call, enqueued behind ~0.5 ms of the card's sleep so
    that the host's work of the call lies outside the window."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    total = 0.0
    for _ in range(reps + 1):
        prep()
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end) if _ else 0.0
    return total / reps


def k9_bounds(T, ng, nd, m, m_next, kind, first=False):
    """The least work of one K9 launch with ``m`` listed entries (walkers
    for K9a, K9c's first list (``first``) and K9d) of which ``m_next`` stay
    listed (K9d: landed), as
    ``(bytes, instructions, special-function results)``: each input read
    once and each output written once, the Philox blocks and arithmetic
    the entries need (summed over ``T`` rungs: ``m`` and ``m_next`` are
    totals)."""
    row = 4 * nd
    if kind == "slice_setup":  # own row, two complement rows, lp; eta, 6
        return (m * (3 * row + 4 + row + 24) + m_next * (4 + row),
                m * (2 * PHILOX_INSTR + 3 * nd + 30) + m_next * 2 * nd,
                m)
    if kind == "slice_step_out":
        return (m * 32 + m_next * (4 + 3 * row),
                m * 15 + m_next * (3 * nd + 5), 0)
    if kind == "slice_shrink":
        if first:
            return (m * (8 + 2 * row + 9 + row),
                    m * (PHILOX_INSTR + 3 * nd + 10), 0)
        return (m * 25 + m_next * (12 + 3 * row),
                m * 12 + m_next * (PHILOX_INSTR + 3 * nd + 10), 0)
    # slice_finish: m walkers, m_next of them landed
    return (m * 2 + m_next * (16 + 3 * row + 5),
            m * 4 + m_next * (2 * nd + 6), 0)


def k9_alone(torch, dev, card, T=1, nw=NW, nd=ND):
    """(b) K9a, K9b, K9c (trip and first list) and K9d alone at the slice
    move's first trip of each loop (one ensemble of 1e5 x 5, or ``T``
    rungs of ``nw`` walkers): device ms a call by CUDA events
    (:func:`behind_ms`), the plain versions (CUDA events, eager), and the
    bounds of this run's lists (:func:`k9_bounds`).  K9b and K9c from the
    state of their loop's first trip, each call after the state is put
    back."""
    from emcee_tpu_torch.ops import slice_kernel as sk
    from emcee_tpu_torch.ops.philox import rung_keys

    gen = torch.Generator(device=dev).manual_seed(231)
    ng = nw // 2
    x = torch.randn(T, nw, nd, device=dev, generator=gen)
    lp = gaussian(x)
    acc = torch.zeros(T, nw, dtype=torch.bool, device=dev)
    cnt = torch.zeros(T, nw, dtype=torch.int32, device=dev)
    seed = rung_keys(5, T, dev) if T > 1 else 5
    cfg = sk.SliceConfig(1.0, 100, 100, False)
    st = sk.LoopState(T, ng, nd, torch.float32, dev, [])
    bufs = [x, lp, acc, cnt]
    length = lambda: int(st.length().sum())  # noqa: E731
    calls = {}
    prep = k9_snapshot(st, bufs)
    calls["slice_setup"] = (
        lambda fn: fn(x, lp, 0, 2, st, seed, 5, cfg), prep,
        (sk.slice_setup, sk.slice_setup_plain), T * ng)
    prep()
    sk.slice_setup(x, lp, 0, 2, st, seed, 5, cfg)
    m_setup = length()
    q = gaussian(st.pts[0][:, :2 * ng])
    calls["slice_step_out"] = (
        lambda fn: fn(x, q, 0, 2, st, 2 * ng, 0, cfg),
        k9_snapshot(st, bufs), (sk.slice_step_out, sk.slice_step_out_plain),
        m_setup)
    # The stepping-out loop to its end, then the shrink's first list.
    p = 0
    while length():
        b = max(st.length().tolist())
        sk.slice_step_out(x, gaussian(st.pts[p][:, :b]), 0, 2, st, b, p,
                          cfg)
        p ^= 1
    calls["slice_shrink (first list)"] = (
        lambda fn: fn(x, None, [], 0, 2, st, 0, 0, seed, 5, cfg),
        k9_snapshot(st, bufs), (sk.slice_shrink, sk.slice_shrink_plain),
        T * ng)
    sk.slice_shrink(x, None, [], 0, 2, st, 0, 0, seed, 5, cfg)
    q2 = gaussian(st.pts[0][:, :ng])
    calls["slice_shrink"] = (
        lambda fn: fn(x, q2, [], 0, 2, st, ng, 0, seed, 5, cfg),
        k9_snapshot(st, bufs), (sk.slice_shrink, sk.slice_shrink_plain),
        T * ng)
    p = 0
    while length():
        b = max(st.length().tolist())
        sk.slice_shrink(x, gaussian(st.pts[p][:, :b]), [], 0, 2, st, b, p,
                        seed, 5, cfg)
        p ^= 1
    calls["slice_finish"] = (
        lambda fn: fn(x, lp, 0, 2, st, acc, cnt, []), k9_snapshot(st, bufs),
        (sk.slice_finish, sk.slice_finish_plain), T * ng)
    out = {}
    for name, (call, put_back, (fn, plain), m) in calls.items():
        put_back()
        call(fn)
        first = "first" in name
        m_next = (int(st.done.sum()) if name == "slice_finish" else length())
        nbytes, instr, sfu = k9_bounds(T, ng, nd, m, m_next,
                                       name.split(" ")[0], first)
        t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": instruction_bound(instr, sfu)}
        out[name] = {"ms": behind_ms(torch, lambda: call(fn), put_back),
                     "plain_ms": behind_ms(torch, lambda: call(plain),
                                           put_back, reps=3),
                     "bound_ms": max(t.values()),
                     "bound_by": max(t, key=t.get), "bytes": nbytes,
                     "instructions": instr, "entries": m,
                     "kept": m_next}
    what = ("one ensemble of 1e5 x 5" if T == 1
            else f"{T} rungs x {nw} walkers x {nd}")
    log(f"phase 23: (b) K9 alone at the slice move's shape ({what}; a "
        f"group of {ng} walkers a rung, each loop's first trip), device us "
        f"a call (CUDA events): " + ", ".join(
            f"{name} {v['ms'] * 1e3:.2f} (plain {v['plain_ms'] * 1e3:.1f}, "
            f"bound {v['bound_ms'] * 1e3:.3f} by {v['bound_by']}; "
            f"{v['entries']} entries, {v['kept']} kept)"
            for name, v in out.items()) + f" {card}")
    return out


def k9_plan_sweep(torch, np, dev, card, n=16):
    """(c) The bucket floor (``chunk_graph.BUCKET_FLOOR``, the one plan
    choice of K9's loops) over ``K9_FLOORS`` at ``EnsembleSliceMove()``'s
    1e5 walkers, ``loop_block`` 4: host µs a proposal in turns, device µs
    and kernels a proposal (profiler), rows evaluated a walker a
    half-step; the chains equal for every floor."""
    from emcee_tpu_torch import EnsembleSampler, moves

    p0 = np.random.default_rng(9).normal(size=(NW, ND)).astype(np.float32)
    smps, res, ends = {}, {}, {}
    for f in K9_FLOORS:
        mv = moves.EnsembleSliceMove()
        mv.bucket_floor = f
        smps[f] = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=17,
                                  device=dev, moves=mv)
        drive(smps[f], p0, n, store=False, skip_initial_state_check=True)
        ends[f] = smps[f]._previous_state.coords.clone()
    if not all(torch.equal(e, ends[K9_FLOORS[0]]) for e in ends.values()):
        raise AssertionError("phase 23: slice chains differ between floors")
    for f in K9_FLOORS + K9_FLOORS[::-1]:
        smp = smps[f]
        w = next(iter(smp._moves[0]._work.values()))
        rows0 = w.rows.clone()
        _, dt = drive(smp, None, n, store=False)
        r = res.setdefault(f, dict(host_us=[], rows_per_walker_half_step=(
            float((w.rows - rows0).sum()) / (n * NW))))
        r["host_us"].append(dt / n * 1e6)
    for f, r in res.items():
        win = busy_window(torch, lambda: smps[f].run_mcmc(None, 4,
                                                          store=False),
                          4, f"slice at floor {f}")
        r.update(device_us=win["device_us_per_proposal"],
                 kernels=win["kernels_per_proposal"], idle=win["idle"])
    log("phase 23: (c) bucket floors at 1e5 walkers, in turns ("
        + ", ".join(str(f) for f in K9_FLOORS + K9_FLOORS[::-1]) + "): "
        + "; ".join(f"floor {f}: host {[round(u, 1) for u in r['host_us']]}"
                    f" us, device {measured(r['device_us'])} us and "
                    f"{measured(r['kernels'], '.0f')} kernels a proposal, "
                    f"{r['rows_per_walker_half_step']:.3f} rows evaluated a "
                    "walker a half-step" for f, r in res.items())
        + f"; chains equal for every floor {card}")
    return res


def k9_stage(torch, np, dev, card, ladder, n=16):
    """(d) ``EnsembleSliceMove()``'s replays at 1e5 walkers, or (``ladder``)
    on workload 4's ladder every rung at once: the launches of ``n``
    replayed proposals counted on the card (device words, held exactly:
    :func:`slice_launches`, the shuffle's, K14 once and on the ladder K15
    once a proposal) beside the profiler's, and in a profiled window each
    K9 kernel's device time a launch, device µs and kernels a
    proposal."""
    from emcee_tpu_torch import EnsembleSampler, moves

    mv = moves.EnsembleSliceMove()
    if ladder:
        smp = pt_sampler(dev, seed=90, move=mv)
        smp.run_mcmc(pt_p0(np), 8, thin_by=2, skip_initial_state_check=True)
        fixed = {"pt_swap": 1, "philox_draw": 1} | SHUF4
    else:
        smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=18,
                              device=dev, moves=mv)
        smp.run_mcmc(np.random.default_rng(10).normal(size=(NW, ND)).astype(
            np.float32), 8, store=False, skip_initial_state_check=True)
        fixed = {"philox_draw": 1} | shuffle_per(1, NW)
    per = fixed | slice_launches(mv)
    trips = [v for v in per.values() if isinstance(v, LoopLaunches)]
    smp.run_mcmc(None, n, store=False)
    counted, profiled = counted_replays(
        torch, dev, smp, n, lambda r: {
            k: (v.count(n) if isinstance(v, LoopLaunches) else v * n)
            for k, v in per.items()}, "phase 23: slice", store=False,
        before=lambda: [v.begin() for v in trips])
    win = busy_window(torch, lambda: smp.run_mcmc(None, n, store=False), n,
                      "slice" + (" on the ladder" if ladder else " at 1e5"))
    _, kernels = profile_window(torch, lambda: smp.run_mcmc(None, n,
                                                            store=False))
    ms = {k: device_ms(kernels, k) for k in K9_KERNELS}
    res = dict(replayed_launches=counted, profiled_replayed=profiled,
               proposals_counted=n, win=win, ms_per_launch=ms)
    log(f"phase 23: (d) slice {'on workload 4' if ladder else 'at 1e5'}: "
        f"launches in {n} replayed proposals {counted} (device words, "
        f"held exactly; the profiler's K9 "
        f"{ {k: profiled[k] for k in K9_KERNELS} }); a proposal: device "
        f"{measured(win['device_us_per_proposal'])} us, "
        f"{measured(win['kernels_per_proposal'], '.0f')} kernels, idle "
        f"{measured(win['idle'], '.4f')}; us a launch in the replays: "
        + ", ".join(f"{k} {measured(v and v * 1e3, '.2f')}"
                    for k, v in ms.items()) + f" {card}")
    return res


def phase23(torch, np, dev, card):
    """K9, the slice move's loops (see the module docstring, 23): the
    sweep, each kernel alone at 1e5 and on the ladder, the bucket floors,
    the slice move's replays at 1e5 and on workload 4's ladder, each path's
    launches counted from 0 just before it, and the rows of K9a-K9d, one
    ensemble and with the rung axis.  Returns its numbers and the rows."""
    out = {}
    t0 = time.perf_counter()
    out["sweep"] = k9_sweep(torch, dev)
    log(f"phase 23: (a) K9a, K9b, K9c and K9d against their plain versions "
        f"in lockstep ((rungs, walkers a group, nsplits, ndim) {K9_SWEEP}, "
        f"every split, four blob leaves, binding caps, a tuned scale, "
        f"injected draws, a device offset word, (bucket floor, trips a "
        f"block) {K9_SWEEP_LOOPS}), every buffer after every launch: "
        f"{out['sweep']} comparisons, all bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out["alone"] = k9_alone(torch, dev, card)
    out["alone_rungs"] = k9_alone(torch, dev, card, NT4, NW4, ND4)
    with path_launches(out, "plan sweep", K9_KERNELS, "phase 23"):
        out["plan_sweep"] = k9_plan_sweep(torch, np, dev, card)
    log(f"phase 23: (b, c) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for ladder in (False, True):
        label = "workload 4" if ladder else "1e5"
        with path_launches(out, label, K9_KERNELS, "phase 23"):
            out[label] = k9_stage(torch, np, dev, card, ladder)
    log(f"phase 23: (d) {time.perf_counter() - t0:.1f} s")
    log(f"phase 23: kernel wrapper launches of each path, counted from 0 "
        f"(recordings and eager runs): {out['launches']}")
    return out, phase23_rows(out, card)


def phase23_rows(out, card):
    """(e) The rows of K9a, K9b, K9c and K9d at ``EnsembleSliceMove()``'s
    shape at 1e5 and with the rung axis on workload 4's ladder: device time
    a launch in the path's replays (profiler), launches by device words
    there, a call alone at the first trip (CUDA events), the plain version
    and the bound of that call's lists."""
    meta = {"slice_setup": ("emcee_tpu/moves/slice.py:158-202", "slice_setup"),
            "slice_step_out": ("emcee_tpu/moves/slice.py:204-241",
                               "slice_step_out"),
            "slice_shrink": ("emcee_tpu/moves/slice.py:243-293",
                             "slice_shrink"),
            "slice_finish": ("emcee_tpu/moves/slice.py:295-299",
                             "slice_finish")}
    rows = []
    for rung in (False, True):
        path = out["workload 4" if rung else "1e5"]
        al = out["alone_rungs" if rung else "alone"]
        shape = (f"the rung axis at workload 4's shape ({NT4} rungs x {NW4} "
                 f"walkers x {ND4})" if rung else
                 "EnsembleSliceMove()'s shape (1e5 x 5-D)")
        for name, (jax, key) in meta.items():
            a = al[key]
            regs = {k: v for k, v in PTXAS.items() if f"{name}_kernel" in k}
            rows.append({
                "name": f"{name} (rung axis)" if rung else name,
                "route": "cuda",
                "source": "emcee_tpu_torch/csrc/slice_loops.cu",
                "replaces": jax + (" (vmapped by emcee_tpu/parallel/"
                                   "tempering.py:449-541)" if rung else ""),
                "launches": path["replayed_launches"][name],
                "max_abs_err": 0.0,
                "ms": path["ms_per_launch"][name],
                "alone_ms": a["ms"], "plain_ms": a["plain_ms"],
                "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
                "library_ms": None, "bytes": a["bytes"],
                "instructions": a["instructions"],
                "launches_per_proposal": (path["replayed_launches"][name]
                                          / path["proposals_counted"]),
                "ptxas": regs,
                **({"first_list_alone_ms": al["slice_shrink (first list)"][
                    "ms"]} if name == "slice_shrink" else {}),
                "note": (f"K9 at {shape}: ms a launch in the path's replays "
                         f"(profiler, the mean over every trip's lists); "
                         f"alone_ms, plain_ms and the bound at the first "
                         f"trip of its loop (CUDA events; bound: the bytes "
                         f"and instructions that call's lists need); "
                         f"launches counted on the card in "
                         f"{path['proposals_counted']} replayed proposals; "
                         f"max_abs_err: bit for bit over the sweep of phase "
                         f"23 (a) ({out['sweep']} comparisons); library_ms: "
                         f"none: no single PyTorch call computes it")})
    for row in rows:
        log(f"phase 23: (e) {row['name']}: device "
            f"{measured(row['ms'] and row['ms'] * 1e3, '.2f')} us/launch in "
            f"its path's replays, {row['alone_ms'] * 1e3:.2f} us a call "
            f"alone at its loop's first trip, plain "
            f"{row['plain_ms'] * 1e3:.1f} us, bound "
            f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}); launches "
            f"{row['launches']} {card}")
    return rows


#: K6's wrappers: K6a ``acf_center`` and ``acf_power``, K6b ``acf_reduce``
#: and ``tau_window``, K6c ``rank_keys`` and ``rank_scores``, K6d ``psrf``
K6_KERNELS = ("acf_center", "acf_power", "acf_reduce", "tau_window",
              "rank_keys", "rank_scores", "psrf")
#: the K6 wrappers of the ACF (K6a, K6b), timed on a walker chunk
ACF_ROWS = K6_KERNELS[:4]
#: device kernels of one convergence check at the monitor's last length on
#: the plain torch + cuFFT route, as PERF.md's kernel table records it
K6_OLD_KERNELS_PER_CHECK = 1566
#: phase 24's tolerances, kernel against plain version where they are not
#: bit for bit: the centred series (the mean summed in float64 in another
#: order: ulps of the chain's largest value), the power spectrum (each
#: product rounded once: ulps of the largest |F|^2), the walker sums
#: (float64 in another order), Geyer's sum (float64, another order), the
#: normal scores (CUDA's log and sqrt in Cephes' ndtri), the PSRF (Welford
#: and Chan's combine against torch.var, float64) and whole routes against
#: the plain route on the card (float32 walker sums there) and the float64
#: host path (with an absolute floor for a tau near 0, as at n_t 2)
K6_TOL = {"acf_center": 16, "acf_power": 8, "acf_reduce": 1e-12,
          "geyer": 1e-12, "ndtri": 1e-12, "psrf": 1e-9,
          "route": 1e-4, "route atol": 1e-6}


def k6_chain(torch, dev, n_t, n_w, n_d, dtype=None, a=0.9, seed=0):
    """An AR(1) chain ``(n_t, n_w, n_d)`` on the card (float64 built, then
    ``dtype``, float32 by default)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.empty(n_t, n_w, n_d, dtype=torch.float64, device=dev)
    x[0] = torch.randn(n_w, n_d, generator=g, dtype=torch.float64,
                       device=dev)
    for t in range(1, n_t):
        x[t] = a * x[t - 1] + torch.randn(n_w, n_d, generator=g,
                                          dtype=torch.float64, device=dev)
    return x.to(dtype or torch.float32)


def k6_close(torch, got, want, rtol, atol, what):
    """Raise unless ``got`` is within ``atol + rtol |want|`` of ``want``
    (NaN where ``want`` is NaN); returns the largest difference."""
    got, want = got.double(), want.double()
    if not bool(torch.isclose(got, want, rtol=rtol, atol=atol,
                              equal_nan=True).all()):
        raise AssertionError(f"{what}: kernel and plain version differ: "
                             f"{got} vs {want}")
    diff = (got - want).abs()
    diff = diff[~diff.isnan()]
    return float(diff.max()) if diff.numel() else 0.0


def k6_acf_check(torch, x, method, budget, errs, what):
    """K6a and K6b on chain ``x`` launch by launch against their plain
    versions on the same inputs (each chunk's centred series, its
    spectrum's power, the walker sums; the window of the kernel's
    partials), and the whole route against the plain route on the card;
    returns the comparisons made."""
    from emcee_tpu_torch.ops import autocorr as ac
    from emcee_tpu_torch.ops import autocorr_kernel as ak

    n_t, n_w, n_d = x.shape
    dev = x.device
    plan = ak.acf_plan(n_t, n_w, n_d, x.element_size(), ak.plan_sms(dev),
                       budget)
    eps = torch.finfo(x.dtype).eps
    part = torch.empty(plan.groups, n_t, n_d, dtype=torch.float64,
                       device=dev)
    part_p = torch.empty_like(part)
    n = 0
    for lo in range(0, n_w, plan.chunk):
        w = min(plan.chunk, n_w - lo)
        bk = torch.empty(w * n_d, plan.m2, dtype=x.dtype, device=dev)
        bp = torch.empty_like(bk)
        ak.acf_center(x, lo, w, bk)
        ak.acf_center_plain(x, lo, w, bp)
        scale = float(x[:, lo:lo + w].abs().max())
        errs["acf_center"] = max(errs["acf_center"], k6_close(
            torch, bk, bp, 0.0, K6_TOL["acf_center"] * eps * scale,
            f"{what}: acf_center"))
        s = torch.fft.rfft(bk, dim=-1)
        sp = s.clone()
        ak.acf_power(s)
        ak.acf_power_plain(sp)
        top = float(sp.real.abs().max())
        errs["acf_power"] = max(errs["acf_power"], k6_close(
            torch, torch.view_as_real(s), torch.view_as_real(sp), 0.0,
            K6_TOL["acf_power"] * eps * top, f"{what}: acf_power"))
        acf = torch.fft.irfft(s, n=plan.m2, dim=-1)
        ak.acf_reduce(acf, part, n_t, n_d, w, plan.wg, lo == 0)
        ak.acf_reduce_plain(acf, part_p, n_t, n_d, w, plan.wg, lo == 0)
        errs["acf_reduce"] = max(errs["acf_reduce"], k6_close(
            torch, part, part_p, K6_TOL["acf_reduce"],
            K6_TOL["acf_reduce"] * (lo + w), f"{what}: acf_reduce"))
        n += 3
    outs = [torch.empty(n_t, n_d, dtype=torch.float64, device=dev),
            torch.empty(n_d, dtype=torch.float64, device=dev),
            torch.empty(n_d, dtype=torch.int64, device=dev)]
    want = [torch.empty_like(o) for o in outs]
    ak.tau_window(part, n_w, method, 5.0, *outs)
    ak.tau_window_plain(part, n_w, method, 5.0, *want)
    same_bits([outs[0], outs[2]], [want[0], want[2]],
              f"{what}: tau_window's mean ACF and window")
    if method == "sokal":
        same_bits([outs[1]], [want[1]], f"{what}: Sokal's tau")
    else:
        errs["tau_window"] = max(errs["tau_window"], k6_close(
            torch, outs[1], want[1], K6_TOL["geyer"], 0.0,
            f"{what}: Geyer's tau"))
    f, tau = ac._acf_kernels(x, method, 5.0, budget)
    same_bits([f, tau], [outs[0], outs[1]], f"{what}: the route")
    f_p = ac._walker_mean_acf(x, budget)
    tau_p = (ac._tau_from_f(f_p.cpu().double().numpy(), 5.0)
             if method == "sokal" else ac._tau_geyer(f_p).cpu().numpy())
    errs["acf route"] = max(errs["acf route"], k6_close(
        torch, tau.cpu(), torch.as_tensor(tau_p), K6_TOL["route"],
        K6_TOL["route atol"], f"{what}: the route against the plain route"))
    return n + 5


def k6_pass_check(torch, draws, lo, hi, center, errs, what):
    """One R-hat pass of K6c and K6d (the bulk pass, or the tail pass about
    ``center``) launch by launch against the plain versions on the same
    inputs: the keys, K16's order against ``torch.sort(stable=True)`` of
    the pooled values, the groups' links, the medians, the scores and the
    PSRF.  Returns ``(comparisons, the kernel's scores, medians,
    psrf)``."""
    from emcee_tpu_torch.ops import autocorr_kernel as ak

    d, S, dev = draws.d, draws.S, draws.x.device
    lo_p, hi_p = torch.empty_like(lo), None if hi is None else \
        torch.empty_like(hi)
    ak.rank_keys(draws, lo, hi, center)
    ak.rank_keys_plain(draws, lo_p, hi_p, center)
    same_bits([lo] + ([hi] if hi is not None else []),
              [lo_p] + ([hi_p] if hi is not None else []),
              f"{what}: rank_keys")
    sw = torch.empty_like(lo)
    sh = None if hi is None else torch.empty_like(hi)
    ak.stable_order(lo, hi, sw, sh)
    v = ak.pooled_values(draws)
    if center is not None:
        v = (v - center[:, None]).abs()
    # -0.0 as +0.0: they tie, as the keys and rankdata tie them
    v = torch.where(v == 0, 0.0, v)
    want = torch.sort(v, dim=1, stable=True).indices
    same_bits([sw & 0xFFFFFFFF], [want], f"{what}: the stable order")
    # the sorted words carry each position's key (and high word)
    pos = sw & 0xFFFFFFFF
    same_bits([(sw >> 32) & 0xFFFFFFFF] + ([] if sh is None else [
        (sh >> 32) & 0xFFFFFFFF]), [lo.gather(1, pos)] + (
        [] if hi is None else [hi.gather(1, pos)]),
        f"{what}: the sorted words' keys")
    grp, grp_p = (torch.empty(d * S, dtype=torch.int32, device=dev)
                  for _ in range(2))
    z, z_p = (torch.empty(d, S, dtype=torch.float64, device=dev)
              for _ in range(2))
    med, med_p = ((torch.empty(d, dtype=draws.x.dtype, device=dev)
                   for _ in range(2)) if center is None else (None, None))
    ak.rank_scores(draws, sw, sh, grp, z, med)
    ak.rank_scores_plain(draws, sw, sh, grp_p, z_p, med_p)
    same_bits([grp] + ([med] if med is not None else []),
              [grp_p] + ([med_p] if med is not None else []),
              f"{what}: rank_scores' groups and medians")
    errs["rank_scores"] = max(errs["rank_scores"], k6_close(
        torch, z, z_p, 0.0, K6_TOL["ndtri"], f"{what}: the normal scores"))
    scores = ak.score_draws(z, draws.h, draws.C)
    r, r_p = (torch.empty(d, dtype=torch.float64, device=dev)
              for _ in range(2))
    ak.psrf(scores, r)
    ak.psrf_plain(scores, r_p)
    errs["psrf"] = max(errs["psrf"], k6_close(
        torch, r, r_p, K6_TOL["psrf"], 0.0, f"{what}: psrf"))
    return 8, z, med, r


def k6_rhat_check(torch, np, x, split, rank_normalized, errs, what):
    """K6c and K6d on chain ``x`` pass by pass against their plain versions
    (:func:`k6_pass_check`; the raw PSRF against the plain version of the
    draws in float64, the kernel's accumulation type), and the whole route
    against the plain route on the card and the float64 host path; returns
    the comparisons made."""
    from emcee_tpu_torch.ops import autocorr as ac
    from emcee_tpu_torch.ops import autocorr_kernel as ak

    draws = ak.split_draws(x, split)
    d, S, dev = draws.d, draws.S, x.device
    got = ac._rhat_kernels(x, split, rank_normalized)
    if not bool(x.isnan().any()):
        # (scipy's rankdata makes a column with a NaN all NaN; the device
        # routes rank NaNs last, as JAX's device path does)
        host = ac.rhat(x.double().cpu().numpy(), split=split,
                       rank_normalized=rank_normalized)
        errs["rhat route"] = max(errs["rhat route"], k6_close(
            torch, got.cpu(), torch.as_tensor(host), K6_TOL["route"], 0.0,
            f"{what}: the route against the float64 host path"))
    block = draws.block()
    if not rank_normalized:
        r = torch.empty(d, dtype=torch.float64, device=dev)
        r_p = torch.empty_like(r)
        ak.psrf(draws, r)
        ak.psrf_plain(draws._replace(x=x.double()), r_p)
        errs["psrf"] = max(errs["psrf"], k6_close(
            torch, r, r_p, K6_TOL["psrf"], 0.0, f"{what}: raw psrf"))
        same_bits([got], [r], f"{what}: the route")
        plain = ac._psrf_device(block.double())
        errs["psrf"] = max(errs["psrf"], k6_close(
            torch, got, plain, K6_TOL["psrf"], 0.0,
            f"{what}: the plain route"))
        return 4
    lo = torch.empty(d, S, dtype=torch.int64, device=dev)
    hi = torch.empty_like(lo) if x.dtype == torch.float64 else None
    n, _, med, bulk = k6_pass_check(torch, draws, lo, hi, None, errs,
                                    f"{what} (bulk)")
    m, _, _, tail = k6_pass_check(torch, draws, lo, hi, med, errs,
                                  f"{what} (tail)")
    same_bits([got], [torch.maximum(bulk, tail)], f"{what}: the route")
    plain = ac._rhat_device(block)
    errs["rhat route"] = max(errs["rhat route"], k6_close(
        torch, got, plain, K6_TOL["psrf"], 0.0, f"{what}: the plain route"))
    return n + m + 3


def k6_sweep(torch, np, dev):
    """(a) Every K6 launch against its plain version on the card: the ACF
    at phase 4's shape (one chunk and 40), a thinned and a walker-sliced
    view against their contiguous copies, float64, ``n_t`` 1, 2, 3 and 33,
    a constant series (NaN) and integer draws, both windows; R-hat split
    and not, rank-normalised and raw, at phase 4's shape, an odd length,
    integer ties, an all-tied column (NaN), NaN, +-0 and +-inf draws,
    float64 (the two-pass order), and the split halves and a thinned view
    read in place against contiguous copies; the rank passes in parameter
    groups against one group; the raw PSRF of more draws than K16 sorts.
    Returns ``(comparisons, {check: largest difference})``."""
    from emcee_tpu_torch.ops import autocorr as ac
    from emcee_tpu_torch.ops import autocorr_kernel as ak

    errs = dict.fromkeys(("acf_center", "acf_power", "acf_reduce",
                          "tau_window", "acf route", "rank_scores", "psrf",
                          "rhat route"), 0.0)
    n = 0
    x4 = k6_chain(torch, dev, 100, 4000, 5)
    big = ac.FFT_BUDGET
    ints = torch.round(2 * k6_chain(torch, dev, 64, 300, 3, seed=2))
    const = k6_chain(torch, dev, 40, 200, 3, seed=3)
    const[..., 1] = 1.5
    acf_cases = [("phase 4's shape", x4, big), ("40 chunks", x4, 1 << 20),
                 ("float64", k6_chain(torch, dev, 64, 300, 3,
                                      torch.float64, seed=1), big),
                 ("integer draws", ints, big), ("a constant series", const,
                                                  big)]
    acf_cases += [(f"n_t {t}", k6_chain(torch, dev, t, 50, 2, seed=t), big)
                  for t in (1, 2, 3, 33)]
    for label, x, budget in acf_cases:
        for method in ("sokal", "geyer"):
            n += k6_acf_check(torch, x, method, budget, errs,
                              f"phase 24: {label}, {method}")
    long = k6_chain(torch, dev, 300, 1000, 5, seed=4)
    for label, view in (("thinned", long[2::3]), ("walkers 100:900",
                                                   long[:, 100:900])):
        for method in ("sokal", "geyer"):
            for budget in (big, 1 << 20):
                got = ac._acf_kernels(view, method, 5.0, budget)
                want = ac._acf_kernels(view.contiguous(), method, 5.0,
                                       budget)
                same_bits(got, want, f"phase 24: a {label} view")
                n += 2
    odd = k6_chain(torch, dev, 101, 300, 3, seed=5)
    tied = k6_chain(torch, dev, 60, 200, 3, seed=6)
    tied[..., 0] = 1.0
    special = k6_chain(torch, dev, 60, 200, 3, seed=7)
    g = torch.Generator(device=dev).manual_seed(8)
    pick = torch.rand(special.shape, generator=g, device=dev)
    special[pick < 0.2] = 0.0
    special[(pick >= 0.2) & (pick < 0.4)] = -0.0
    special[(pick >= 0.4) & (pick < 0.41)] = float("nan")
    special[..., 2][pick[..., 2] > 0.97] = float("inf")
    special[..., 2][pick[..., 2] < 0.01] = -float("inf")
    s64 = torch.round(4 * k6_chain(torch, dev, 60, 300, 3, torch.float64,
                                   seed=9))
    s64[torch.rand(s64.shape, generator=g, device=dev) < 0.1] = -0.0
    s64[0, 0, 1] = float("nan")
    rhat_cases = [("phase 4's shape", x4), ("an odd length", odd),
                  ("integer ties", ints), ("an all-tied column", tied),
                  ("NaN, +-0, +-inf", special), ("float64", s64),
                  ("float64 AR(1)", k6_chain(torch, dev, 40, 100, 2,
                                             torch.float64, seed=10))]
    for label, x in rhat_cases:
        for split, rn in ((True, True), (False, True), (True, False),
                          (False, False)):
            n += k6_rhat_check(torch, np, x, split, rn, errs,
                               f"phase 24: R-hat, {label}, split={split}, "
                               f"rank_normalized={rn}")
    for label, view in (("second half", long[150:]), ("thinned",
                                                      long[::2]),
                        ("walkers 100:900", long[:, 100:900])):
        for split in (True, False):
            got = ac._rhat_kernels(view, split, True)
            want = ac._rhat_kernels(view.contiguous(), split, True)
            same_bits([got], [want], f"phase 24: R-hat of a {label} view")
            n += 1
    # the rank passes a parameter at a time and two at a time (the budget's
    # groups) against one group, bit for bit
    for label, x in (("phase 4's shape", x4), ("float64", s64)):
        per = ak.split_draws(x, True).S * ak.RHAT_BYTES[
            x.dtype == torch.float64]
        want = ac._rhat_kernels(x, True, True)
        for budget in (per, 2 * per):
            got = ac._rhat_kernels(x, True, True, budget)
            same_bits([got], [want], f"phase 24: R-hat of {label} in groups "
                      f"of {budget // per}")
            n += 1
    # the raw PSRF of more draws a parameter than K16 sorts; the rank
    # passes refuse them
    wide = torch.randn(2048, (ak.DRAWS_MAX + 1) // 2048 + 1, 1, device=dev,
                       generator=g)
    draws = ak.split_draws(wide, False)
    r, r_p = (torch.empty(1, dtype=torch.float64, device=dev)
              for _ in range(2))
    ak.psrf(draws, r)
    ak.psrf_plain(draws._replace(x=wide.double()), r_p)
    errs["psrf"] = max(errs["psrf"], k6_close(
        torch, r, r_p, K6_TOL["psrf"], 0.0,
        f"phase 24: raw psrf of {draws.S} draws"))
    try:
        ac._rhat_kernels(wide, False, True)
    except ValueError:
        pass
    else:
        raise AssertionError(f"phase 24: ranks of {draws.S} draws a "
                             f"parameter were not refused")
    del wide, draws
    return n + 2, errs


#: the torch calls no K6 route may make on a CUDA tensor (the plain
#: route's sort, cumulative sums, scatters, normal quantile and variance)
K6_FORBIDDEN = (("torch", "sort"), ("torch", "argsort"), ("torch", "cumsum"),
                ("torch", "cummax"), ("torch", "cummin"), ("torch", "var"),
                ("torch.special", "ndtri"), ("torch.Tensor", "sort"),
                ("torch.Tensor", "argsort"), ("torch.Tensor", "cumsum"),
                ("torch.Tensor", "scatter_add_"), ("torch.Tensor", "var"))


@contextlib.contextmanager
def k6_forbidden(torch):
    """Make every call of ``K6_FORBIDDEN`` and of K6's plain versions
    raise while the block runs."""
    import importlib

    from emcee_tpu_torch.ops import autocorr_kernel as ak

    def refuse(name):
        def call(*a, **kw):
            raise AssertionError(f"phase 24: a K6 route called {name}")
        return call

    saved = []
    for mod, name in K6_FORBIDDEN:
        owner = (torch.Tensor if mod == "torch.Tensor"
                 else importlib.import_module(mod))
        saved.append((owner, name, getattr(owner, name)))
    saved += [(ak, f"{k}_plain", getattr(ak, f"{k}_plain"))
              for k in K6_KERNELS]
    for owner, name, _ in saved:
        setattr(owner, name, refuse(name))
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def k6_entry_points(torch, np, dev):
    """(a) Each public entry point on a CUDA tensor launches K6 (and K16
    for R-hat), with the torch calls of ``K6_FORBIDDEN`` and every plain
    version refused: ``integrated_time`` (both methods), ``ess``,
    ``function_1d``, ``rhat`` (split or not, rank-normalised or raw) and
    ``DeviceBackend.get_autocorr_time`` of a stored run (``thin=2``, a
    strided view); each call's wrapper launches, counted from 0, held to
    the route's.  Returns ``{call: launches}``."""
    from emcee_tpu_torch import EnsembleSampler, moves
    from emcee_tpu_torch.autocorr import (
        ess, function_1d, integrated_time, rhat)
    from emcee_tpu_torch.backends import DeviceBackend

    smp = EnsembleSampler(2000, ND, gaussian, vectorize=True, seed=5,
                          device=dev, backend=DeviceBackend(),
                          moves=moves.StretchMove(randomize_split=False,
                                                  pair_mode="roll"))
    p0 = np.random.default_rng(4).normal(size=(2000, ND)).astype(np.float32)
    smp.run_mcmc(p0, 300, skip_initial_state_check=True)
    x = smp.backend.chain[:smp.backend.iteration]
    acf = {"acf_center": 1, "acf_power": 1, "acf_reduce": 1,
           "tau_window": 1}
    sort = {"rank_keys": 2, "rank_scores": 4, "psrf": 2}
    calls = {
        "integrated_time (Sokal)": (lambda: integrated_time(x, quiet=True),
                                    acf),
        "integrated_time (Geyer)": (lambda: integrated_time(
            x, method="geyer", quiet=True), acf),
        "ess": (lambda: ess(x, quiet=True), acf),
        "function_1d": (lambda: function_1d(x[:, 0, 0]), acf),
        "get_autocorr_time(thin=2)": (lambda: smp.get_autocorr_time(
            thin=2, discard=20, quiet=True), acf),
        "rhat": (lambda: rhat(x), sort),
        "rhat(split=False)": (lambda: rhat(x, split=False), sort),
        "rhat(rank_normalized=False)": (
            lambda: rhat(x, rank_normalized=False), {"psrf": 1}),
        "rhat(split=False, rank_normalized=False)": (
            lambda: rhat(x, split=False, rank_normalized=False),
            {"psrf": 1})}
    out = {}
    fns = wrappers()
    for label, (fn, want) in calls.items():
        for _, w in fns.values():
            w.launches = 0
        with k6_forbidden(torch):
            got = fn()
        torch.cuda.synchronize()
        if not np.all(np.isfinite(got)):
            raise AssertionError(f"phase 24: {label}: {got}")
        counts = {k: w.launches for k, (_, w) in fns.items() if w.launches}
        expect = dict(want)
        if "rank_keys" in want:
            expect["group_order"] = counts.get("group_order", 0)
            if not expect["group_order"]:
                raise AssertionError(f"phase 24: {label}: no K16 launch")
        if counts != expect:
            raise AssertionError(f"phase 24: {label}: launches {counts}, "
                                 f"expected {expect}")
        out[label] = counts
    return out


def k6_monitor(torch, np, dev, card, trace):
    """(b) Phase 10's ``run_until_converged`` at full width (the main
    path, ``DeviceBackend``, ``thin_by=10``, ``check_every=200``,
    ``ConvergenceMonitor(rhat_threshold=1.01)``), every wrapper's count
    set to 0 just before it; then one check at the final length: seconds
    (host clock), kernels by the profiler, each wrapper's launches, and its
    largest device-to-host copy, held to ``n_d x 8`` bytes."""
    from emcee_tpu_torch import (
        ConvergenceMonitor, EnsembleSampler, moves, run_until_converged)
    from emcee_tpu_torch.backends import DeviceBackend
    from emcee_tpu_torch.monitor import stored_chain

    out = {}
    smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=21,
                          device=dev, backend=DeviceBackend(),
                          moves=moves.StretchMove(randomize_split=False,
                                                  pair_mode="roll"))
    p0 = np.random.default_rng(3).normal(size=(NW, ND)).astype(np.float32)
    mon = ConvergenceMonitor(rhat_threshold=1.01)
    with path_launches(out, "run_until_converged", K6_KERNELS
                       + ("group_order",), "phase 24"):
        t0 = time.perf_counter()
        run_until_converged(smp, p0, max_steps=2000, check_every=200,
                            monitor=mon, thin_by=10,
                            skip_initial_state_check=True)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    chain = stored_chain(smp)

    def check():
        return ConvergenceMonitor(rhat_threshold=1.01).update(chain)

    check()
    with path_launches(out, "one check", K6_KERNELS + ("group_order",),
                       "phase 24"):
        t0 = time.perf_counter()
        check()
        torch.cuda.synchronize()
        t_check = time.perf_counter() - t0
    _, kernels = profile_window(torch, check)
    per_check = sum(c for c, _ in kernels.values())
    big, _ = d2h_bytes(torch, check, trace)
    if big > ND * 8:
        raise AssertionError(f"phase 24: a check copied {big} bytes to the "
                             f"host (at most {ND * 8})")
    # The same check on the plain route (the port's torch code before K6,
    # on the card), for comparison in this run.
    from emcee_tpu_torch.ops import autocorr as ac

    kernel_route = ac._on_kernels
    ac._on_kernels = lambda x: False
    try:
        check()
        t0 = time.perf_counter()
        plain = ConvergenceMonitor(rhat_threshold=1.01)
        plain.update(chain)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        _, plain_kernels = profile_window(torch, check)
    finally:
        ac._on_kernels = kernel_route
    mine = ConvergenceMonitor(rhat_threshold=1.01)
    mine.update(chain)
    if not (np.allclose(mine.tau, plain.tau, rtol=1e-4)
            and np.allclose(mine.rhat, plain.rhat, rtol=1e-9)):
        raise AssertionError(f"phase 24: a check on the kernels {mine.tau} "
                             f"{mine.rhat}, on the plain route {plain.tau} "
                             f"{plain.rhat}")
    per_check_plain = sum(c for c, _ in plain_kernels.values())

    def costliest(ks):
        top = sorted(ks.items(), key=lambda kv: -kv[1][1])[:6]
        return "; ".join(f"{k[:40]} {c} x {us / c:.1f} us" for k, (c, us)
                         in top)
    if not (np.isfinite(mon.tau).all() and np.isfinite(mon.rhat).all()):
        raise AssertionError(f"phase 24: tau {mon.tau}, rhat {mon.rhat}")
    out.update(iteration=smp.iteration, checks=len(mon.history),
               seconds=total, seconds_per_check=t_check,
               kernels_per_check=per_check,
               kernels_per_check_before=K6_OLD_KERNELS_PER_CHECK,
               plain_seconds_per_check=t_plain,
               plain_kernels_per_check=per_check_plain,
               costliest=costliest(kernels),
               plain_costliest=costliest(plain_kernels),
               kernels={k: c for k, (c, _) in kernels.items()},
               largest_d2h_bytes=big, tau=mon.tau.tolist(),
               rhat=mon.rhat.tolist(), shape=list(chain.shape))
    ran = {k: v for k, v in out["launches"]["run_until_converged"].items()
           if v}
    log(f"phase 24: (b) run_until_converged (main path, DeviceBackend, "
        f"check_every=200, thin_by=10, rhat_threshold=1.01): stopped at "
        f"iteration {smp.iteration} after {len(mon.history)} checks, tau "
        f"{np.array2string(mon.tau, precision=2)}, rhat "
        f"{np.array2string(mon.rhat, precision=4)}, {total:.2f} s in all; "
        f"one check at {tuple(chain.shape)}: {t_check * 1e3:.2f} ms, "
        f"{per_check} device kernels (profiler; before K6: "
        f"{K6_OLD_KERNELS_PER_CHECK}); on the plain route "
        f"{t_plain * 1e3:.2f} ms and {per_check_plain} kernels; launches "
        f"{ {k: v for k, v in out['launches']['one check'].items() if v} }"
        f", largest device-to-host copy {big} bytes (at most {ND * 8}); "
        f"the run's launches {ran} {card}")
    log(f"phase 24: (b) a check's costliest kernels (profiler): on K6 "
        f"{out['costliest']}; on the plain route {out['plain_costliest']}")
    return out, chain


def k6_bytes(name, n_t, n_d, w, m2, groups, S, item):
    """The bytes K6 wrapper ``name``'s function must move (each input read
    once, each output written once) at a chunk of ``w`` walkers (ACF; the
    first chunk, whose partials are written, not added to) or ``S`` pooled
    draws of ``n_d`` parameters (R-hat): a key of ``item`` bytes (the
    draw's width; the int64 words are K16's interface), a position of 4
    (``S < 2**29``), a float64 score, the medians' two draws and value."""
    series = w * n_d
    return {
        "acf_center": series * n_t * item + series * m2 * item,
        "acf_power": 2 * series * (m2 // 2 + 1) * 2 * item,
        "acf_reduce": series * n_t * item + groups * n_t * n_d * 8,
        "tau_window": groups * n_t * n_d * 8 + n_t * n_d * 8 + n_d * 16,
        "rank_keys": 2 * S * n_d * item,
        "rank_scores": S * n_d * (item + 4) + S * n_d * 8 + 3 * n_d * item,
        "psrf": S * n_d * 8 + n_d * 8}[name]


def k6_alone(torch, dev, card, acf_x, rhat_x, label):
    """(c) Each K6 wrapper alone at ``acf_x``'s first walker chunk and at
    the first parameter group (``rhat_group``, as the route takes them) of
    ``rhat_x``'s split draws: device ms by CUDA events behind a sleep of
    the card, for the kernel, its plain version (into buffers made
    beforehand) and, for ``acf_power``, the one PyTorch call that computes
    it (``torch.mul(F, F.conj(), out=...)``); its bound by bytes; and the
    yardsticks: cuFFT's ``rfft`` and ``irfft`` of the chunk,
    ``torch.sort(stable=True)`` of the group's pooled columns beside
    ``rank_keys`` + K16 + ``rank_scores``."""
    from emcee_tpu_torch.ops import autocorr_kernel as ak

    n_t, n_w, n_d = acf_x.shape
    plan = ak.acf_plan(n_t, n_w, n_d, acf_x.element_size(),
                       ak.plan_sms(dev))
    w = plan.chunk
    buf = torch.empty(w * n_d, plan.m2, dtype=acf_x.dtype, device=dev)
    ak.acf_center(acf_x, 0, w, buf)
    spec = torch.fft.rfft(buf, dim=-1)
    acf = torch.fft.irfft(spec, n=plan.m2, dim=-1)
    part = torch.empty(plan.groups, n_t, n_d, dtype=torch.float64,
                       device=dev)
    ak.acf_reduce(acf, part, n_t, n_d, w, plan.wg, True)
    win = [torch.empty(n_t, n_d, dtype=torch.float64, device=dev),
           torch.empty(n_d, dtype=torch.float64, device=dev),
           torch.empty(n_d, dtype=torch.int64, device=dev)]
    draws = ak.split_draws(rhat_x, True)
    d = ak.rhat_group(draws.d, draws.S, rhat_x.dtype == torch.float64)
    draws = draws._replace(x=draws.x[..., :d])
    S = draws.S
    lo = torch.empty(d, S, dtype=torch.int64, device=dev)
    sw = torch.empty_like(lo)
    grp = torch.empty(d * S, dtype=torch.int32, device=dev)
    z = torch.empty(d, S, dtype=torch.float64, device=dev)
    med = torch.empty(d, dtype=rhat_x.dtype, device=dev)
    r = torch.empty(d, dtype=torch.float64, device=dev)
    ak.rank_keys(draws, lo)
    ak.stable_order(lo, None, sw)
    scores = ak.score_draws(z, draws.h, draws.C)
    # the plain versions' outputs, made before the timed calls
    buf_p, part_p, lo_p, grp_p, z_p, med_p, r_p = (
        torch.empty_like(t) for t in (buf, part, lo, grp, z, med, r))
    win_p = [torch.empty_like(t) for t in win]
    spec_p, spec_l = spec.clone(), torch.empty_like(spec)
    calls = {
        "acf_center": (lambda: ak.acf_center(acf_x, 0, w, buf),
                       lambda: ak.acf_center_plain(acf_x, 0, w, buf_p)),
        "acf_power": (lambda: ak.acf_power(spec),
                      lambda: ak.acf_power_plain(spec_p)),
        "acf_reduce": (lambda: ak.acf_reduce(acf, part, n_t, n_d, w,
                                             plan.wg, True),
                       lambda: ak.acf_reduce_plain(acf, part_p, n_t, n_d, w,
                                                   plan.wg, True)),
        # the chunk's mean ACF (its own walkers'), so the window ends where
        # a chain's does
        "tau_window": (lambda: ak.tau_window(part, w, "sokal", 5.0, *win),
                       lambda: ak.tau_window_plain(part, w, "sokal", 5.0,
                                                   *win_p)),
        "rank_keys": (lambda: ak.rank_keys(draws, lo),
                      lambda: ak.rank_keys_plain(draws, lo_p)),
        "rank_scores": (lambda: ak.rank_scores(draws, sw, None, grp, z,
                                               med),
                        lambda: ak.rank_scores_plain(draws, sw, None, grp_p,
                                                     z_p, med_p)),
        "psrf": (lambda: ak.psrf(scores, r),
                 lambda: ak.psrf_plain(scores, r_p))}
    library = {"acf_power": lambda: torch.mul(spec, spec.conj(),
                                              out=spec_l)}
    cols = ak.pooled_values(draws).contiguous()
    out = {"shape": {"acf": list(acf_x.shape), "chunk": w,
                     "groups": plan.groups, "rhat_draws": [d, S]}}
    item = acf_x.element_size()
    for name, (fn, plain) in calls.items():
        ms = behind_ms(torch, fn, lambda: None, reps=10)
        plain_ms = behind_ms(torch, plain, lambda: None, reps=2)
        lib_ms = (behind_ms(torch, library[name], lambda: None, reps=10)
                  if name in library else None)
        nbytes = k6_bytes(name, n_t, n_d if name in ACF_ROWS else d, w,
                          plan.m2, plan.groups, S, item)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bytes=nbytes,
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    # the library call computes what the plain version does
    f = torch.fft.rfft(buf, dim=-1)
    torch.mul(f, f.conj(), out=spec_l)
    ak.acf_power_plain(f)
    eps = torch.finfo(acf_x.dtype).eps
    k6_close(torch, torch.view_as_real(spec_l), torch.view_as_real(f), 0.0,
             K6_TOL["acf_power"] * eps * float(f.real.abs().max()),
             f"phase 24: {label}: torch.mul(F, F.conj())")
    del f
    out["yardsticks"] = {
        "rfft_ms": behind_ms(torch, lambda: torch.fft.rfft(buf, dim=-1),
                             lambda: None, reps=10),
        "irfft_ms": behind_ms(torch, lambda: torch.fft.irfft(
            spec, n=plan.m2, dim=-1), lambda: None, reps=10),
        "stable_order_ms": behind_ms(
            torch, lambda: ak.stable_order(lo, None, sw), lambda: None,
            reps=5),
        "torch_sort_ms": behind_ms(
            torch, lambda: torch.sort(cols, dim=1, stable=True),
            lambda: None, reps=5)}
    y = out["yardsticks"]
    y["keys_sort_scores_ms"] = (out["rank_keys"]["ms"] + y["stable_order_ms"]
                                + out["rank_scores"]["ms"])
    for name in calls:
        a = out[name]
        lib = ("" if a["library_ms"] is None else
               f", library {a['library_ms'] * 1e3:.2f} us")
        log(f"phase 24: (c) {label}: {name}: {a['ms'] * 1e3:.2f} us a call "
            f"(CUDA events), plain {a['plain_ms'] * 1e3:.1f} us{lib}, bound "
            f"{a['bound_ms'] * 1e3:.3f} us ({a['bytes']} bytes) {card}")
    log(f"phase 24: (c) {label}: yardsticks: rfft {y['rfft_ms'] * 1e3:.2f} "
        f"us and irfft {y['irfft_ms'] * 1e3:.2f} us of the chunk; "
        f"rank_keys + K16 + rank_scores {y['keys_sort_scores_ms'] * 1e3:.1f}"
        f" us (K16 {y['stable_order_ms'] * 1e3:.1f}) against "
        f"torch.sort(stable=True) of the same columns "
        f"{y['torch_sort_ms'] * 1e3:.1f} us {card}")
    return out


def phase24(torch, np, dev, card):
    """K6, the diagnostics' fused chains (see the module docstring, 24):
    the sweep, the full-width ``run_until_converged``, each kernel alone
    at phase 4's shape and at the monitor's last chain, and the rows of
    K6a-K6d.  Returns its numbers and the rows."""
    out = {}
    t0 = time.perf_counter()
    out["sweep"], out["errs"] = k6_sweep(torch, np, dev)
    out["entry_points"] = k6_entry_points(torch, np, dev)
    log(f"phase 24: (a) each entry point on a CUDA tensor, with "
        f"{', '.join('.'.join(f) for f in K6_FORBIDDEN)} and every plain "
        f"version refused, launches (from 0): {out['entry_points']}")
    log(f"phase 24: (a) every K6 launch against its plain version: "
        f"{out['sweep']} comparisons; the keys, K16's order (== "
        f"torch.sort(stable=True)), the groups' links (the ranks), the "
        f"medians, the mean ACF and windows bit for bit; largest "
        f"differences elsewhere {out['errs']} (tolerances {K6_TOL}) "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    trace = Path(__file__).resolve().parent / "build" / "d2h_trace24.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    out["monitor"], chain = k6_monitor(torch, np, dev, card, trace)
    log(f"phase 24: (b) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    x4 = k6_chain(torch, dev, 100, 4000, ND)
    out["alone"] = {
        "phase 4": k6_alone(torch, dev, card, x4, x4, "phase 4's shape"),
        "monitor": k6_alone(torch, dev, card, chain,
                            chain[chain.shape[0] // 2:],
                            "the monitor's last chain")}
    log(f"phase 24: (c) {time.perf_counter() - t0:.1f} s")
    return out, phase24_rows(out, card)


def phase24_rows(out, card):
    """(d) The rows of K6a-K6d's wrappers at the monitor's last chain (one
    walker chunk for K6a and K6b, the first parameter group of the split
    draws of its second half for K6c and K6d): device time a call by CUDA
    events, the launches of phase 24's ``run_until_converged``, the
    sweep's largest difference, the plain version, the library call where
    one computes the function, and the bound."""
    meta = {
        "acf_center": ("csrc/acf.cu", "emcee_tpu/ops/autocorr.py:51-53",
                       ("acf_center",)),
        "acf_power": ("csrc/acf.cu", "emcee_tpu/ops/autocorr.py:54-55",
                      ("acf_power",)),
        "acf_reduce": ("csrc/acf.cu", "emcee_tpu/ops/autocorr.py:55-56, "
                       ":67-69, :103-107", ("acf_reduce", "acf route")),
        "tau_window": ("csrc/acf.cu", "emcee_tpu/ops/autocorr.py:75-85, "
                       ":115-143", ("tau_window",)),
        "rank_keys": ("csrc/rhat.cu", "emcee_tpu/ops/autocorr.py:237, "
                      ":269, :354", ()),
        "rank_scores": ("csrc/rhat.cu", "emcee_tpu/ops/autocorr.py:229-250,"
                        " :262-266, :364", ("rank_scores",)),
        "psrf": ("csrc/rhat.cu", "emcee_tpu/ops/autocorr.py:219-226, :271",
                 ("psrf", "rhat route"))}
    mon = out["monitor"]
    rows = []
    for name, (src, jax, err_keys) in meta.items():
        a = out["alone"]["monitor"][name]
        b = out["alone"]["phase 4"][name]
        y = out["alone"]["monitor"]["yardsticks"]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"emcee_tpu_torch/{src}", "replaces": jax,
            "launches": mon["launches"]["run_until_converged"][name],
            "max_abs_err": max((out["errs"][k] for k in err_keys),
                               default=0.0),
            "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"], "bound_by": "bytes",
            "library_ms": a["library_ms"], "bytes": a["bytes"],
            "phase4_ms": b["ms"], "phase4_plain_ms": b["plain_ms"],
            "phase4_library_ms": b["library_ms"],
            "phase4_bound_ms": b["bound_ms"],
            "launches_per_check": mon["launches"]["one check"][name],
            **({"yardsticks": y} if name in ("acf_power",
                                             "rank_scores") else {}),
            "note": (f"K6 at the monitor's last chain {mon['shape']} (ACF: "
                     f"one walker chunk of "
                     f"{out['alone']['monitor']['shape']['chunk']}; R-hat: "
                     f"the first parameter group of the split draws of "
                     f"its second half, "
                     f"{out['alone']['monitor']['shape']['rhat_draws']}): "
                     f"ms, plain_ms and library_ms a call by CUDA events "
                     f"behind a sleep of the card; launches counted from 0 "
                     f"in phase 24's run_until_converged "
                     f"({mon['checks']} checks); max_abs_err: the largest "
                     f"difference over the sweep of phase 24 (a) "
                     f"({out['sweep']} comparisons; 0.0: bit for bit); "
                     + ("library_ms: torch.mul(F, F.conj(), out=...)"
                        if name == "acf_power" else
                        "library_ms: none, no single PyTorch call computes "
                        "it (yardsticks: cuFFT's rfft / irfft, "
                        "torch.sort(stable=True))"))})
    for row in rows:
        lib = ("" if row["library_ms"] is None else
               f"; library {row['library_ms'] * 1e3:.2f} us")
        log(f"phase 24: (d) {row['name']}: {row['ms'] * 1e3:.2f} us a call "
            f"at the monitor's last chain, {row['phase4_ms'] * 1e3:.2f} at "
            f"phase 4's shape; plain {row['plain_ms'] * 1e3:.1f} us{lib}; "
            f"bound "
            f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}); launches "
            f"{row['launches']} in the run, {row['launches_per_check']} a "
            f"check {card}")
    return rows


# -- phase 25: the side and walk moves ---------------------------------------

#: a proposal's launches of the side move (K5a's side mode, K2; no K14 on
#: the blocked split)
SIDE_PER = {"de_propose": 2, "accept_select": 2}
#: of the walk move with the shared covariance: K8a, K8b's walk mode,
#: K18a and K2
WALK_SHARED_PER = {"dime_moments": 2, "dime_finish": 2, "walk_propose": 2,
                   "accept_select": 2}
#: of the walk move with a subset: K18b and K2
WALK_SUBSET_PER = {"walk_subset": 2, "accept_select": 2}
#: phase 25's moves at the main path's width (the blocked split) and their
#: launches a proposal
MAIN25 = {"SideMove(pair_mode='roll', randomize_split=False)": SIDE_PER,
          "WalkMove(randomize_split=False)": WALK_SHARED_PER,
          "WalkMove(s=16, randomize_split=False)": WALK_SUBSET_PER}
#: on workload 4's ladder (the shuffled split adds K14, K16 and K17 once
#: each, and K15 swaps)
PT25 = {"SideMove()": SIDE_PER, "SideMove(pair_mode='roll')": SIDE_PER,
        "WalkMove()": WALK_SHARED_PER, "WalkMove(s=16)": WALK_SUBSET_PER}
PT25_PER = {k: v | {"pt_swap": 1, "philox_draw": 1} | SHUF4
            for k, v in PT25.items()}
#: proposals a replay of the per-rung loop (each proposal 16 rungs' work)
PT25_LOOP_N = 4
#: (rungs, walkers, ndim, (s0, exact_subset_max) cases) of the sweep: the
#: ladder, ndim 100 for the factor, 1e5 walkers (bootstrap), the exact
#: sort at nc = 4096 (one block a walker) and above 4096 (K16, two ranges
#: of walkers), and s0 above what a block stages (6149 picks and normals:
#: K18b draws them as it sums, bootstrap and after K16)
K25_SWEEP = ((1, 256, 5, ((1, 4096), (2, 4096), (16, 4096), (127, 4096),
                          (16, 0))),
             (3, 74, 3, ((5, 4096), (5, 0))),
             (16, 256, 5, ((16, 4096), (16, 0), (2, 4096))),
             (1, 1000, 100, ((16, 4096),)),
             (1, NW, ND, ((16, 0), (2, 0))),
             (1, 8192, 2, ((4095, 4096), (16, 4096))),
             (1, 8194, 1, ((4096, 8192), (2, 8192))),
             (1, 12300, 1, ((6149, 0), (6149, 8192))))


def move25(label):
    """Phase 25's move ``label``."""
    from emcee_tpu_torch import moves

    return {
        "SideMove(pair_mode='roll', randomize_split=False)":
            lambda: moves.SideMove(pair_mode="roll", randomize_split=False),
        "WalkMove(randomize_split=False)":
            lambda: moves.WalkMove(randomize_split=False),
        "WalkMove(s=16, randomize_split=False)":
            lambda: moves.WalkMove(s=16, randomize_split=False),
        "SideMove()": moves.SideMove,
        "SideMove(pair_mode='roll')":
            lambda: moves.SideMove(pair_mode="roll"),
        "WalkMove()": moves.WalkMove,
        "WalkMove(s=16)": lambda: moves.WalkMove(s=16),
    }[label]()


def pt25_sampler(dev, label, seed, backend=None):
    return pt_sampler(dev, seed=seed, backend=backend, move=move25(label))


def k25_sweep(torch, dev):
    """(a) K5a's side mode, K8b's walk mode (after K8a), K18a and K18b
    against their plain versions on the same inputs, bit for bit (the
    bits, so NaN compares too): every shape of ``K25_SWEEP``, both splits,
    scale unset and set (one a rung), the stream at a host offset and at
    a device offset word, K5a's two pair modes, K18b's cases (exact and
    bootstrap, ``s0`` 1 to ``nc - 1``), injected draws at the ladder's
    shape, and a singular complement (a constant column: every factor
    entry NaN).  Returns the number of comparisons."""
    from emcee_tpu_torch.ops import de_kernel as dk
    from emcee_tpu_torch.ops import dime_kernel as mk
    from emcee_tpu_torch.ops import walk_kernel as wk
    from emcee_tpu_torch.ops.philox import DeviceOffset, rung_keys

    gen = torch.Generator(device=dev).manual_seed(250)
    word = torch.tensor(3, dtype=torch.int64, device=dev)
    n = 0
    shapes = list(K25_SWEEP) + [(1, 256, 3, ((4, 4096),), "singular")]
    for T, nw, nd, cases, *flag in shapes:
        lead = (T,) if T > 1 else ()
        x = torch.randn(lead + (nw, nd), device=dev, generator=gen) + 2.0
        if flag:
            x[..., 1] = 0.5
        ng = nw // 2
        nc = nw - ng
        keys = rung_keys(7, T, dev) if T > 1 else 7
        scale = 0.5 + torch.rand(lead, device=dev, generator=gen)
        for split in (0, 1):
            for sc, off in ((None, 5), (scale, DeviceOffset(word, 2))):
                what = (f"T {T}, nw {nw}, nd {nd}, split {split}, "
                        f"{'scaled, device word' if sc is not None else ''}")
                for pm in ("roll", "random"):
                    kw = dict(gamma0=0.9, scale=sc, pair_mode=pm,
                              seed=keys, offset=off, mode="side")
                    same_bits(dk.de_propose(x, split, 2, **kw),
                              dk.de_propose_plain(x, split, 2, **kw),
                              f"K5a side {pm} {what}")
                    n += 1
                part = mk.dime_moments(x, (split * ng, ng), None, None, 1)
                want = mk.dime_finish_plain(part, mode="walk")
                L = mk.dime_finish(part.clone(), mode="walk")
                same_bits((L,), (want,), f"K8b walk {what}")
                if flag and not torch.isnan(L).all():
                    raise AssertionError("phase 25: a singular complement's "
                                         "factor is not NaN")
                args = (x, split, 2, L, keys, off, sc)
                same_bits(wk.walk_propose(*args), wk.walk_propose_plain(*args),
                          f"K18a {what}")
                n += 2
                for s0, exact in cases:
                    args = (x, split, 2, s0, exact, keys, off, sc)
                    same_bits(wk.walk_subset(*args),
                              wk.walk_subset_plain(*args),
                              f"K18b s0 {s0} exact_max {exact} {what}")
                    n += 1
        if (T, nw) == (16, 256):
            # Injected draws, rung by rung.
            z = torch.randn(T, ng, nd, device=dev, generator=gen)
            zs = torch.randn(T, ng, 16, device=dev, generator=gen)
            picks = torch.randint(0, nc, (T, ng, 16), device=dev,
                                  generator=gen)
            part = mk.dime_moments(x, (0, ng), None, None, 1)
            L = mk.dime_finish(part, mode="walk")
            same_bits(wk.walk_propose(x, 0, 2, L, 7, 5, scale, z),
                      wk.walk_propose_plain(x, 0, 2, L, 7, 5, scale, z),
                      "K18a injected")
            same_bits(wk.walk_subset(x, 0, 2, 16, 4096, 7, 5, scale, zs,
                                     picks),
                      wk.walk_subset_plain(x, 0, 2, 16, 4096, 7, 5, scale,
                                           zs, picks), "K18b injected")
            zi = torch.randn(T, ng, device=dev, generator=gen)
            for pm, inj in (("roll", dict(u_shift=torch.rand(
                    T, 2, device=dev, generator=gen))),
                            ("random", dict(idx_a=torch.randint(
                                0, nc, (T, ng), device=dev, generator=gen,
                                dtype=torch.int32), idx_b=torch.randint(
                                0, nc - 1, (T, ng), device=dev, generator=gen,
                                dtype=torch.int32)))):
                kw = dict(gamma0=0.9, scale=scale, pair_mode=pm,
                          seed=7, offset=5, mode="side", z=zi, **inj)
                same_bits(dk.de_propose(x, 1, 2, **kw),
                          dk.de_propose_plain(x, 1, 2, **kw),
                          f"K5a side {pm} injected")
            n += 4
            # Each rung of the axis equals that rung alone.
            for r in (0, 5, 15):
                part = mk.dime_moments(x[r].contiguous(), (0, ng), None,
                                       None, 1)
                Lr = mk.dime_finish(part, mode="walk")
                same_bits((Lr,), (L[r],), f"K8b walk rung {r} alone")
                for fn, args, full in (
                        (wk.walk_propose, (Lr,), (L,)),
                        (wk.walk_subset, (16, 4096), (16, 4096))):
                    got = fn(x[r].contiguous(), 0, 2, *args, keys.seeds[r],
                             5, scale[r].contiguous())
                    all_r = fn(x, 0, 2, *full, keys, 5, scale)
                    same_bits((got[0],), (all_r[0][r],),
                              f"{fn.__name__} rung {r} alone")
                n += 3
    return n


def k25_bounds(T, nw, nd, s0=16, exact=False):
    """The least work of one launch of each kernel at a split of ``T``
    rungs of ``nw`` walkers (``ng = nw / 2``), as ``{name: (bytes,
    instructions, special-function results)}``, each input read once and
    each output written once: K5a's side mode (the ensemble's rows read,
    ``q`` and the factor written; a Philox block and a normal a walker,
    roll pairs, three operations an element), K8b's
    walk mode (the partials read, ``L`` written; Chan's combine a partial,
    the factor's ``nd^3 / 3`` multiply-adds), K18a (the split's rows and
    ``L`` read, ``q`` and the factor written; ``ceil(nd / 2)`` Philox
    blocks and ``nd`` normals a walker and ``nd (nd + 1)`` operations)
    and K18b (the ensemble's rows read, ``q`` and the factor written; the
    picks' Philox blocks, or the exact subset's ``nc`` keys and a
    selection of their ``s0`` smallest, ``nc ceil(log2 s0)`` compare-swaps
    of four instructions (a heap of ``s0``; the kernel's full bitonic
    sort does more); ``s0`` normals, five operations a pick and column).
    K18b's picked rows as 32-byte sectors, the traffic its gathers issue
    (most of it from L2), are ``sector_bytes`` of :func:`k25_sectors`."""
    from emcee_tpu_torch.ops.dime_kernel import dime_plan

    ng = nw // 2
    nc = nw - ng
    rows = T * ng
    node = 1 + nd + nd * nd
    nb = dime_plan(nc, nd).blocks
    if exact:
        picks = (-(-nc // 4) * PHILOX_INSTR
                 + nc * max(1, (s0 - 1).bit_length()) * 4)
    else:
        picks = -(-s0 // 4) * PHILOX_INSTR
    return {
        "de_propose": (4 * T * (nw * nd + ng * nd + ng),
                       rows * (PHILOX_INSTR + NORMAL_INSTR + 3 * nd),
                       rows * NORMAL_SFU),
        "dime_finish": (4 * T * (nb * node + nd * nd),
                        T * (nb * node * 6 + nd ** 3 // 3 * 2 + nd * 4),
                        T * nd),
        "walk_propose": (4 * T * (2 * ng * nd + ng + nd * nd),
                         rows * (-(-nd // 2) * PHILOX_INSTR
                                 + nd * NORMAL_INSTR + nd * (nd + 1)),
                         rows * nd * NORMAL_SFU),
        "walk_subset": (4 * T * (nw * nd + ng * nd + ng),
                        rows * (picks + -(-s0 // 2) * PHILOX_INSTR
                                + s0 * NORMAL_INSTR + 5 * s0 * nd),
                        rows * s0 * NORMAL_SFU),
    }


def k25_sectors(T, nw, nd, s0=16):
    """K18b's picked rows as 32-byte sectors: the bytes its gathers
    issue, each walker's ``s0`` rows."""
    return T * (nw // 2) * s0 * -(-4 * nd // 32) * 32


def k25_alone(torch, dev, card, T=1, nw=NW, nd=ND):
    """(b) Each kernel alone at the shape of one ensemble of 1e5 x 5 (the
    walk subset by bootstrap, ``nc`` = 5e4) or of ``T`` rungs of ``nw``
    walkers (workload 4's ladder: the exact subset, ``nc`` = 128), ``s0``
    16: device ms a call by CUDA events around graph replays
    (``replay_ms``), a call back to back from Python, the plain versions
    (CUDA events, eager), the yardsticks (``torch.linalg.cholesky_ex`` of
    the covariance beside K8b's walk mode, ``torch.addmm(s, z, L^T,
    alpha=adj)`` of the same normals beside K18a (``baddbmm`` on the rung
    axis), ``torch.argsort(stable=True)`` of the ``(ng, nc)`` keys beside
    K18b's exact picks) and the bounds (bytes, and instructions at the
    issue rate)."""
    from emcee_tpu_torch.moves.walk import complement, cov
    from emcee_tpu_torch.ops import de_kernel as dk
    from emcee_tpu_torch.ops import dime_kernel as mk
    from emcee_tpu_torch.ops import walk_kernel as wk
    from emcee_tpu_torch.ops.philox import normals, row_uniforms, rung_keys

    gen = torch.Generator(device=dev).manual_seed(251)
    lead = (T,) if T > 1 else ()
    ng = nw // 2
    nc = nw - ng
    exact = nc <= 4096
    x = torch.randn(lead + (nw, nd), device=dev, generator=gen)
    seed = rung_keys(5, T, dev) if T > 1 else 5
    scale = 0.5 + torch.rand(lead, device=dev, generator=gen)
    part = mk.dime_moments(x, (0, ng), None, None, 1)
    L = mk.dime_finish(part.clone(), mode="walk")
    c = cov(complement(x, 0, ng))
    z = normals(ng, nd, seed, 5, dev, row0=0)
    s = x[..., :ng, :]
    keys = row_uniforms(ng, nc, seed, 5, dev) if exact else None
    side = dict(gamma0=0.9, scale=scale, pair_mode="roll", seed=seed,
                offset=5, mode="side")

    def finish():  # the partials in shared memory: part is left as it was
        return mk.dime_finish(part, mode="walk")

    def finish_plain():
        return mk.dime_finish_plain(part, mode="walk")

    if T > 1:
        addmm = (lambda: torch.baddbmm(s, z, L.mT, alpha=0.8))
    else:
        addmm = (lambda: torch.addmm(s, z, L.mT, alpha=0.8))
    if not mk.finish_shared(part.shape[-3], nd, 1):
        raise AssertionError("phase 25: K8b's partials do not fit shared "
                             "memory at the timed shape")
    calls = {
        "de_propose": (lambda: dk.de_propose(x, 0, 2, **side),
                       lambda: dk.de_propose_plain(x, 0, 2, **side), None),
        "dime_finish": (finish, finish_plain,
                        lambda: torch.linalg.cholesky_ex(c)),
        "walk_propose": (
            lambda: wk.walk_propose(x, 0, 2, L, seed, 5, scale),
            lambda: wk.walk_propose_plain(x, 0, 2, L, seed, 5, scale),
            addmm),
        "walk_subset": (
            lambda: wk.walk_subset(x, 0, 2, 16, 4096, seed, 5, scale),
            lambda: wk.walk_subset_plain(x, 0, 2, 16, 4096, seed, 5, scale),
            (lambda: torch.argsort(keys, dim=-1, stable=True))
            if exact else None),
    }
    bounds = k25_bounds(T, nw, nd, 16, exact)
    out = {}
    for name, (fn, plain, lib) in calls.items():
        nbytes, instr, sfu = bounds[name]
        t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": instruction_bound(instr, sfu)}
        out[name] = {"ms": replay_ms(torch, fn),
                     "call_ms": cuda_ms(torch, fn, reps=50),
                     "plain_ms": slow_ms(torch, plain, reps=3),
                     "bound_ms": max(t.values()),
                     "bound_by": max(t, key=t.get), "bytes": nbytes,
                     "instructions": instr,
                     "library_ms": None if lib is None else replay_ms(
                         torch, lib)}
    out["walk_subset"]["sector_bytes"] = k25_sectors(T, nw, nd)
    out["dime_moments (K8a, for the walk)"] = {
        "ms": replay_ms(torch, lambda: mk.dime_moments(x, (0, ng), None,
                                                       None, 1))}
    what = (f"one ensemble of {nw} x {nd}, the subset by bootstrap"
            if T == 1 else f"{T} rungs x {nw} walkers x {nd}, the subset "
            f"exact")
    log(f"phase 25: (b) alone ({what}; s0 16), device us a call (graph "
        f"replays): " + ", ".join(
            f"{name} {v['ms'] * 1e3:.2f}" + (
                f" (back to back {v['call_ms'] * 1e3:.2f}, plain "
                f"{v['plain_ms'] * 1e3:.1f}, bound {v['bound_ms'] * 1e3:.3f}"
                f" by {v['bound_by']}" + (
                    f", library {v['library_ms'] * 1e3:.2f}"
                    if v["library_ms"] is not None else "") + ")"
                if "call_ms" in v else "")
            for name, v in out.items()) + f" {card}")
    return out


def k25_stage(torch, np, dev, card, label, n=16):
    """(c) ``label`` at the main path's width (1e5 x 5-D, the blocked
    split): ``n`` graph-replayed proposals against the plain versions'
    eager chain bit for bit; device us and kernels a proposal and each
    kernel's us a launch in ``n`` replayed proposals (profiler); the
    launches counted by device words (exactly ``MAIN25[label]`` a
    proposal, no K14)."""
    from emcee_tpu_torch import EnsembleSampler

    per = MAIN25[label]

    def make():
        return EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=25,
                               device=dev, moves=move25(label))

    p0 = np.random.default_rng(4).normal(size=(NW, ND)).astype(np.float32)
    acc = graph_vs_plain_chain(torch, make, p0, n=n)
    smp = make()
    smp.run_mcmc(p0, n, store=False, skip_initial_state_check=True)
    smp.run_mcmc(None, n, store=False)
    host = []
    for _ in range(2):
        _, dt = drive(smp, None, n, store=False)
        host.append(dt / n * 1e6)
    win = busy_window(torch, lambda: smp.run_mcmc(None, n, store=False), n,
                      f"phase 25 {label} at 1e5", names=per)
    counted, _ = counted_replays(
        torch, dev, smp, n, lambda r: {k: v * n for k, v in per.items()},
        f"phase 25 {label} at 1e5", store=False)
    log(f"phase 25: (c) {label} at 1e5 x 5-D: {n} graph-replayed proposals "
        f"equal the plain versions' eager chain bit for bit (acceptance "
        f"{acc:.4f}); {n} replayed proposals: host "
        f"{[round(v, 1) for v in host]} us, device "
        f"{measured(win['device_us_per_proposal'])} us and "
        f"{measured(win['kernels_per_proposal'], '.0f')} kernels a "
        f"proposal, idle {measured(win['idle'], '.4f')}; us a launch: "
        + ", ".join(f"{k} {measured(v and v * 1e3, '.2f')}"
                    for k, v in win["ms_per_launch"].items())
        + f"; launches { {k: v for k, v in counted.items() if v} } (device "
        f"words, exactly {per} a proposal) {card}")
    return dict(win=win, replayed_launches=counted, proposals_counted=n,
                acceptance=acc, host_us=host)


def k25_singular(torch, np, dev, card, n=8):
    """(c) A walk complement whose covariance is singular (a constant
    column): every factor is NaN, every proposal rejected, the chain
    unchanged (graph replays, the shuffled split)."""
    from emcee_tpu_torch import EnsembleSampler, moves

    p0 = np.random.default_rng(6).normal(size=(1000, 3)).astype(np.float32)
    p0[:, 1] = 0.25
    smp = EnsembleSampler(1000, 3, gaussian, vectorize=True, seed=8,
                          device=dev, moves=moves.WalkMove())
    smp.run_mcmc(p0, n, store=False, skip_initial_state_check=True)
    st = smp.run_mcmc(None, n, store=False)
    same = bool(np.array_equal(st.coords.cpu().numpy(), p0))
    acc = int(smp.last_run_stats.accepted.sum())
    log(f"phase 25: (c) a singular walk complement (1000 x 3, a constant "
        f"column), {2 * n} proposals: accepted {acc}, chain unchanged "
        f"{same} {card}")
    if acc or not same:
        raise AssertionError("phase 25: a singular walk complement moved "
                             "the chain")
    return {"accepted": acc, "unchanged": same}


def phase25(torch, np, dev, card):
    """The side and walk moves (see the module docstring, 25): the sweep,
    the kernels alone at 1e5 and on the ladder, the three moves at the
    main path's width, the singular complement, the four moves on
    workload 4's ladder (every rung at once against the per-rung loop),
    each path's launches counted from 0 just before it, and the rows of
    K5a's side mode, K8b's walk mode, K18a and K18b, one ensemble and
    with the rung axis.  Returns its numbers and the rows."""
    out = {}
    t0 = time.perf_counter()
    out["sweep"] = k25_sweep(torch, dev)
    log(f"phase 25: (a) K5a's side mode, K8b's walk mode, K18a and K18b "
        f"against their plain versions ((rungs, walkers, ndim) "
        f"{[c[:3] for c in K25_SWEEP]} and a singular complement; both "
        f"splits, scale unset and set, host offset and device word, "
        f"injected draws, each rung against the rung alone, the exact sort "
        f"at nc 4096 and 4097 by K16): {out['sweep']} comparisons, all bit "
        f"for bit ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out["alone"] = k25_alone(torch, dev, card)
    out["alone_rungs"] = k25_alone(torch, dev, card, NT4, NW4, ND4)
    log(f"phase 25: (b) {time.perf_counter() - t0:.1f} s")
    for label, per in MAIN25.items():
        t0 = time.perf_counter()
        with path_launches(out, label, tuple(per), "phase 25"):
            out[label] = k25_stage(torch, np, dev, card, label)
        log(f"phase 25: (c) {label}: {time.perf_counter() - t0:.1f} s")
    out["singular"] = k25_singular(torch, np, dev, card)
    p0 = pt_p0(np)
    for label, per in PT25_PER.items():
        t0 = time.perf_counter()
        with path_launches(out, label, tuple(per), "phase 25"):
            r = out[label] = pt21_path(torch, np, dev, card, label, p0,
                                       n_l=PT25_LOOP_N, sampler=pt25_sampler,
                                       per=per, phase="phase 25")
        log(f"phase 25: (d) {label} at {NT4} x {NW4} x {ND4}: 64 "
            f"graph-replayed proposals of every rung at once equal the "
            f"plain versions' eager chain and the per-rung loop bit for bit "
            f"(swaps {r['swaps_64']}); in turns (batched, loop, loop, "
            f"batched; replays of {r['proposals_counted']} and "
            f"{r['loop_proposals_a_replay']} proposals), a proposal: host "
            f"{[round(v, 1) for v in r['host_us'][True]]} / "
            f"{[round(v, 1) for v in r['host_us'][False]]} us, device "
            f"{[measured(v) for v in r['device_us'][True]]} / "
            f"{[measured(v) for v in r['device_us'][False]]} us, kernels "
            f"{[measured(v, '.0f') for v in r['kernels'][True]]} / "
            f"{[measured(v, '.0f') for v in r['kernels'][False]]} (batched "
            f"/ loop); batched launches in {r['proposals_counted']} "
            f"proposals { {k: v for k, v in r['replayed_launches'].items() if v} }"
            f" (device words; exactly {per} a proposal); us a launch in its "
            f"replays: " + ", ".join(
                f"{k} {measured(v and v * 1e3, '.3f')}"
                for k, v in r["win"]["ms_per_launch"].items())
            + f" {card} ({time.perf_counter() - t0:.1f} s)")
    log(f"phase 25: kernel wrapper launches of each path, counted from 0 "
        f"(recordings and eager runs): {out['launches']}")
    return out, phase25_rows(out, card)


def phase25_rows(out, card):
    """(e) The rows of K5a's side mode, K8b's walk mode, K18a and K18b at
    the main path's width (device time a launch in the blocked moves'
    replays by the profiler; launches by device words there; a call
    alone, back to back and the plain version by CUDA events; the bound
    and the yardstick) and with the rung axis (workload 4's ladder: the
    same from its replays and at its shape)."""
    meta = {
        "de_propose": ("side mode", "emcee_tpu_torch/csrc/de_propose.cu",
                       "emcee_tpu/moves/side.py:57-85",
                       ("SideMove(pair_mode='roll', randomize_split=False)",
                        "SideMove()"),
                       "none: no single PyTorch call computes it"),
        "dime_finish": ("walk mode", "emcee_tpu_torch/csrc/dime_moments.cu",
                        "emcee_tpu/moves/walk.py:29-33, 73-79",
                        ("WalkMove(randomize_split=False)", "WalkMove()"),
                        "torch.linalg.cholesky_ex of the covariance"),
        "walk_propose": (None, "emcee_tpu_torch/csrc/walk_propose.cu",
                         "emcee_tpu/moves/walk.py:73-79",
                         ("WalkMove(randomize_split=False)", "WalkMove()"),
                         "torch.addmm(s, z, L^T, alpha) of the same normals "
                         "(baddbmm on the rung axis)"),
        "walk_subset": (None, "emcee_tpu_torch/csrc/walk_propose.cu",
                        "emcee_tpu/moves/walk.py:81-97",
                        ("WalkMove(s=16, randomize_split=False)",
                         "WalkMove(s=16)"),
                        "torch.argsort(stable=True) of the (ng, nc) keys "
                        "beside the exact picks (null at 1e5: bootstrap)"),
    }
    rows = []
    for rung in (False, True):
        al = out["alone_rungs" if rung else "alone"]
        for name, (mode, src, jax, paths, lib_note) in meta.items():
            path = out[paths[rung]]
            a = al[name]
            label = name + (f" ({mode})" if mode else "")
            shape = (f"with the rung axis at workload 4's shape ({NT4} rungs "
                     f"x {NW4} walkers x {ND4}, {paths[1]}" if rung else
                     f"at the main path's width (1e5 x 5-D, {paths[0]}")
            rows.append({
                "name": label[:-1] + ", rung axis)" if rung and mode
                else label + (" (rung axis)" if rung else ""),
                "route": "cuda", "source": src,
                "replaces": jax + (" (vmapped by emcee_tpu/parallel/"
                                   "tempering.py:449-541)" if rung else ""),
                "launches": path["replayed_launches"][name],
                "max_abs_err": 0.0,
                "ms": path["win"]["ms_per_launch"][name],
                "alone_ms": a["ms"], "call_ms": a["call_ms"],
                "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
                "bound_by": a["bound_by"], "library_ms": a["library_ms"],
                "bytes": a["bytes"], "instructions": a["instructions"],
                **({"sector_bytes": a["sector_bytes"]}
                   if "sector_bytes" in a else {}),
                "launches_per_proposal": (path["replayed_launches"][name]
                                          / path["proposals_counted"]),
                "ptxas": {k: v for k, v in PTXAS.items()
                          if f"{name}_kernel" in k or (
                              name == "walk_subset" and (
                                  "walk_sort_kernel" in k
                                  or "walk_keys_kernel" in k))},
                **({"path_device_us_batched_loop": (path["device_us"][True],
                                                    path["device_us"][False]),
                    "path_kernels_batched_loop": (path["kernels"][True],
                                                  path["kernels"][False])}
                   if rung else {}),
                "note": (f"{shape}): ms in the path's replays (profiler); "
                         f"alone_ms a call alone (CUDA events around graph "
                         f"replays), call_ms back to back from Python; "
                         f"launches counted on the card in "
                         f"{path['proposals_counted']} replayed proposals; "
                         f"max_abs_err: bit for bit over phase 25 (a)'s "
                         f"{out['sweep']} comparisons; bound: the bytes "
                         f"(each input once, each output once; sector_bytes: "
                         f"K18b's picked rows as 32-byte sectors) and the "
                         f"instructions needed at the issue rate; "
                         f"library_ms: {lib_note}")})
    for row in rows:
        log(f"phase 25: (e) {row['name']}: device "
            f"{measured(row['ms'] and row['ms'] * 1e3, '.2f')} us/launch in "
            f"its path's replays, {row['alone_ms'] * 1e3:.2f} us a call "
            f"alone, {row['call_ms'] * 1e3:.2f} back to back, plain "
            f"{row['plain_ms'] * 1e3:.1f} us, bound "
            f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}), library "
            f"{measured(row['library_ms'] and row['library_ms'] * 1e3, '.2f')}"
            f" us; launches {row['launches']} {card}")
    return rows


# -- phase 26: the Gaussian, MH and blended moves on every rung ----------------

#: the Gaussian move's full covariance at ND (phase 10's)
FULL26 = [[0.375 if i == j else 0.125 for j in range(ND)] for i in range(ND)]
#: a proposal's launches of the Gaussian move (K19, K2 at nsplits=1; no
#: K14: K19 draws its own)
GAUSS_PER = {"gaussian_propose": 1, "accept_select": 1}
#: of phase 10's MH move (its function's normals by K14)
MH_PER = {"philox_draw": 1, "accept_select": 1}
#: of the blend of DE and DE-snooker (each split: K5a, K5b, K20, K2)
BLEND_PER = {"de_propose": 2, "snooker_propose": 2, "blend_select": 2,
             "accept_select": 2}
#: of the three-way blend (K5a for DE and for the side move)
BLEND3_PER = BLEND_PER | {"de_propose": 4}
#: phase 26's moves at the main path's width and their launches a proposal
MAIN26 = {"GaussianMove(0.5)": GAUSS_PER,
          "GaussianMove(0.5, mode='random')": GAUSS_PER,
          "GaussianMove(full cov)": GAUSS_PER,
          "MHMove(Philox normals)": MH_PER,
          "BlendedMove(DE 0.8, snooker 0.2, blocked)": BLEND_PER}
#: on workload 4's ladder (MH's function runs once a rung: NT4 K14
#: launches; the blends' shuffled split adds K14, K16 and K17 once each;
#: K15 swaps)
PT26 = {"GaussianMove(0.5)": GAUSS_PER,
        "GaussianMove(0.5, mode='random')": GAUSS_PER,
        "GaussianMove(full cov)": GAUSS_PER,
        "MHMove(Philox normals)": MH_PER | {"philox_draw": NT4},
        "BlendedMove(DE 0.8, snooker 0.2)":
            BLEND_PER | {"philox_draw": 1} | SHUF4,
        "BlendedMove(DE, snooker, side)":
            BLEND3_PER | {"philox_draw": 1} | SHUF4}
PT26_PER = {k: v | {"pt_swap": 1} for k, v in PT26.items()}
#: the ladder moves held to phase 14's windows (the random-walk moves'
#: windows are reported, not held: a Gaussian step of 0.5 does not cross
#: between modes 8 apart)
PT26_HELD = ("BlendedMove(DE 0.8, snooker 0.2)",
             "BlendedMove(DE, snooker, side)")
#: (rungs, walkers, ndim) of K19's sweep
K19_SWEEP = ((1, 1, 5), (1, 31, 1), (1, 31, 33), (1, 5003, 2),
             (1, 5003, 129), (1, NW, ND), (2, 31, 100), (16, 256, 5),
             (16, 5003, 33))
#: (cov, mode) of K19's sweep: a full covariance takes the vector mode only
K19_CASES = (("scalar", "vector"), ("scalar", "random"),
             ("scalar", "sequential"), ("diag", "vector"), ("diag", "random"),
             ("diag", "sequential"), ("full", "vector"))
#: (rungs, walkers a split, ndim, sub-moves) of K20's sweep
K20_SWEEP = ((1, 1, 1, 2), (1, 31, 5, 3), (1, 5003, 100, 4), (1, 50000, 5, 2),
             (2, 31, 33, 3), (16, 128, 5, 4), (16, 5003, 1, 2))
#: (rungs, walkers, ndim) of K2's rung kernel at nsplits=1
K2_NS1_SWEEP = ((1, 1, 1), (1, 31, 5), (2, 31, 33), (16, 256, 5),
                (16, 5003, 2), (3, 50000, 5))


def mh_normals(rng, x):
    """Phase 10's MH proposal: ``x + 0.5 z`` of the port's Philox normals."""
    import torch
    from emcee_tpu_torch.ops.philox import normals

    seed, offset = rng
    z = normals(x.shape[0], x.shape[1], seed, offset, x.device)
    return x + 0.5 * z, torch.zeros(x.shape[0], device=x.device)


def move26(label):
    """Phase 26's move ``label``."""
    from emcee_tpu_torch import moves

    def de_snooker(**kw):  # workload 3's pair (benchmarks/workload3.py:71-77)
        return moves.BlendedMove(
            [(moves.DEMove(pair_mode="roll"), 0.8),
             (moves.DESnookerMove(pair_mode="roll", nsplits=2), 0.2)], **kw)

    return {
        "GaussianMove(0.5)": lambda: moves.GaussianMove(0.5),
        "GaussianMove(0.5, mode='random')":
            lambda: moves.GaussianMove(0.5, mode="random"),
        "GaussianMove(full cov)": lambda: moves.GaussianMove(FULL26),
        "MHMove(Philox normals)": lambda: moves.MHMove(mh_normals),
        "BlendedMove(DE 0.8, snooker 0.2, blocked)":
            lambda: de_snooker(randomize_split=False),
        "BlendedMove(DE 0.8, snooker 0.2)": de_snooker,
        "BlendedMove(DE, snooker, side)": lambda: moves.BlendedMove(
            [(moves.DEMove(), 0.5),
             (moves.DESnookerMove(pair_mode="roll", nsplits=2), 0.2),
             (moves.SideMove(), 0.3)]),
    }[label]()


def pt26_sampler(dev, label, seed, backend=None):
    return pt_sampler(dev, seed=seed, backend=backend, move=move26(label))


def k19_scales(torch, np, dev, nd, gen):
    """K19's ``(scale, L)`` of each covariance kind at ``nd``: a scalar, a
    diagonal and a full covariance's Cholesky factor (factored in float64
    on the host, as ``GaussianMove`` does)."""
    a = np.random.default_rng(nd).normal(size=(nd, nd))
    L = np.linalg.cholesky(a @ a.T / nd + 0.5 * np.eye(nd))
    return {"scalar": (torch.tensor(0.7, device=dev), None),
            "diag": (0.3 + torch.rand(nd, device=dev, generator=gen), None),
            "full": (None, torch.tensor(L, dtype=torch.float32, device=dev))}


def k26_sweep(torch, np, dev):
    """(a) K19 and K20 against their plain versions on the same inputs, bit
    for bit (the bits, so NaN compares too), and K2's rung kernel at
    ``nsplits=1``: K19 over ``K19_SWEEP`` x ``K19_CASES``, without a factor
    at a host offset and with a factor, per-rung ``log_adj`` and a device
    offset word, the sequential index after both; injected draws and each
    rung against the rung alone at 16 rungs; K20 over ``K20_SWEEP`` (2-4
    sub-moves, a factor of one value among them) with the choice drawn at a
    host offset and a device word, injected as an int, as a tensor and out
    of range, and each rung against the rung alone; K2's rung kernel at
    ``nsplits=1`` over ``K2_NS1_SWEEP``, with and without the ``logL`` /
    ``logP`` leaves, each rung against the one-ensemble K2 of the rung
    alone.  Returns the number of comparisons."""
    from emcee_tpu_torch.ops import accept_kernel as ak
    from emcee_tpu_torch.ops import blend_kernel as bk
    from emcee_tpu_torch.ops import gaussian_kernel as gk
    from emcee_tpu_torch.ops.philox import DeviceOffset, rung_keys

    gen = torch.Generator(device=dev).manual_seed(260)
    word = torch.tensor(3, dtype=torch.int64, device=dev)
    lf = math.log(2.5)
    n = 0
    for T, nw, nd in K19_SWEEP:
        lead = (T,) if T > 1 else ()
        x = torch.randn(lead + (nw, nd), device=dev, generator=gen)
        keys = rung_keys(9, T, dev) if T > 1 else 9
        log_adj = 0.3 * torch.randn(lead, device=dev, generator=gen)
        index = (torch.arange(T, dtype=torch.int32, device=dev) * 3 - 1
                 ).reshape(lead)
        scales = k19_scales(torch, np, dev, nd, gen)
        for kind, mode in K19_CASES:
            scale, L = scales[kind]
            for f, la, off in ((None, None, 5),
                               (lf, log_adj, DeviceOffset(word, 2))):
                i_k, i_p = index.clone(), index.clone()
                args = (x, scale, L, keys, off, mode, f, la)
                same_bits(gk.gaussian_propose(*args, i_k) + (i_k,),
                          gk.gaussian_propose_plain(*args, i_p) + (i_p,),
                          f"K19 {kind} {mode} T {T} nw {nw} nd {nd} "
                          f"factor {f}")
                n += 1
            if T == 16:
                inj = dict(z=torch.randn(T, nw, nd, device=dev, generator=gen),
                           u=torch.rand(T, device=dev, generator=gen),
                           dims=torch.randint(0, nd, (T, nw), device=dev,
                                              generator=gen)
                           if mode == "random" else None)
                i_k, i_p = index.clone(), index.clone()
                args = (x, scale, L, 9, 5, mode, lf, log_adj)
                same_bits(gk.gaussian_propose(*args, i_k, **inj) + (i_k,),
                          gk.gaussian_propose_plain(*args, i_p, **inj)
                          + (i_p,), f"K19 {kind} {mode} injected")
                i_all = index.clone()
                all_r = gk.gaussian_propose(x, scale, L, keys, 5, mode, lf,
                                            log_adj, i_all)
                for r in (0, 7, 15):
                    i_r = index[r].clone()
                    got = gk.gaussian_propose(x[r].contiguous(), scale, L,
                                              keys.seeds[r], 5, mode, lf,
                                              log_adj[r].contiguous(), i_r)
                    same_bits(got + (i_r,), (all_r[0][r], all_r[1][r],
                                             i_all[r]),
                              f"K19 {kind} {mode} rung {r} alone")
                n += 4
    for T, ng, nd, k in K20_SWEEP:
        lead = (T,) if T > 1 else ()
        keys = rung_keys(13, T, dev) if T > 1 else 13
        qs = [torch.randn(lead + (ng, nd), device=dev, generator=gen)
              for _ in range(k)]
        fs = [torch.randn((), device=dev, generator=gen) if j == 1 else
              torch.randn(lead + (ng,), device=dev, generator=gen)
              for j in range(k)]
        w = np.random.default_rng(k + ng).uniform(0.1, 1.0, size=k)
        cdf = [float(c) for c in np.cumsum(w / w.sum())[:-1]]
        chosen = torch.randint(0, k, lead, device=dev, generator=gen)
        for split in (0, 1):
            for choice, off in ((None, 5), (None, DeviceOffset(word, 7)),
                                (k - 1, 5), (chosen, 5), (k + 2, 5)):
                args = (qs, fs, cdf, keys, off, split, choice)
                same_bits(bk.blend_select(*args), bk.blend_select_plain(*args),
                          f"K20 T {T} ng {ng} nd {nd} k {k} split {split} "
                          f"choice {choice if choice is None else 'given'}")
                n += 1
        if T == 16:
            all_r = bk.blend_select(qs, fs, cdf, keys, 5, 1)
            for r in (0, 9, 15):
                got = bk.blend_select(
                    [q[r].contiguous() for q in qs],
                    [f if f.dim() == 0 else f[r].contiguous() for f in fs],
                    cdf, keys.seeds[r], 5, 1)
                same_bits(got, (all_r[0][r], all_r[1][r]),
                          f"K20 rung {r} alone")
                n += 1
    for T, nw, nd in K2_NS1_SWEEP:
        keys = rung_keys(11, T, dev)
        coords = torch.randn(T, nw, nd, device=dev, generator=gen)
        q = coords + 0.5 * torch.randn(T, nw, nd, device=dev, generator=gen)
        lp = gaussian(coords.reshape(-1, nd)).reshape(T, nw)
        lp_q = gaussian(q.reshape(-1, nd)).reshape(T, nw)
        factor = 0.1 * torch.randn(T, nw, device=dev, generator=gen)
        new_l = torch.randn(2, T, nw, device=dev, generator=gen)
        for with_leaves in (False, True):
            for off in (5, DeviceOffset(word, 2)):
                outs = []
                for fn in (ak.accept_select, ak.accept_select_plain):
                    bufs = [coords.clone(), lp.clone(),
                            torch.zeros(T, nw, dtype=torch.bool, device=dev),
                            torch.ones(T, nw, dtype=torch.int32, device=dev),
                            torch.zeros(2, T, nw, device=dev)]
                    blobs = ([(new_l[0], bufs[4][0]), (new_l[1], bufs[4][1])]
                             if with_leaves else ())
                    fn(q, factor, lp_q, bufs[0], bufs[1], 0, 1, bufs[2],
                       bufs[3], seed=keys, offset=off, blobs=blobs)
                    outs.append(bufs)
                same_bits(outs[0], outs[1], f"K2 rung kernel nsplits=1 T {T} "
                          f"nw {nw} nd {nd} leaves {with_leaves}")
                n += 1
        if T == 16:
            ref = [coords.clone(), lp.clone(),
                   torch.zeros(T, nw, dtype=torch.bool, device=dev),
                   torch.ones(T, nw, dtype=torch.int32, device=dev)]
            ak.accept_select(q, factor, lp_q, ref[0], ref[1], 0, 1, ref[2],
                             ref[3], seed=keys, offset=5)
            for r in (0, 15):
                bufs = [b[r].clone() for b in (coords, lp)] + [
                    torch.zeros(nw, dtype=torch.bool, device=dev),
                    torch.ones(nw, dtype=torch.int32, device=dev)]
                ak.accept_select(q[r].contiguous(), factor[r].contiguous(),
                                 lp_q[r].contiguous(), bufs[0], bufs[1], 0, 1,
                                 bufs[2], bufs[3], seed=keys.seeds[r],
                                 offset=5)
                same_bits(bufs, [b[r] for b in ref],
                          f"K2 nsplits=1 rung {r} alone")
                n += 1
    return n


def k26_bounds(T, nw, nd, full=False, k=2):
    """The least work of one launch at ``T`` rungs of ``nw`` walkers, as
    ``{name: (bytes, instructions, special-function results)}``, each
    input read once and each output written once: K19 (``x`` read, ``q``
    and the factor written, ``L`` read for a full covariance; a Philox
    block a pair of columns, a normal a column, and three operations a
    column, or ``nd (nd + 1)`` for the full covariance's sum) and K20 with
    ``k`` sub-moves (the chosen ``q`` and factor read and written; a Philox
    block and ``k - 1`` compares a rung)."""
    rows = T * nw
    return {
        "gaussian_propose": (
            4 * (T * (2 * nw * nd + nw) + (nd * nd if full else 0)),
            rows * (-(-nd // 2) * PHILOX_INSTR + nd * NORMAL_INSTR
                    + (nd * (nd + 1) if full else 3 * nd)),
            rows * nd * NORMAL_SFU),
        "blend_select": (8 * T * (nw * nd + nw),
                         T * (PHILOX_INSTR + k), 0),
    }


def k26_alone(torch, np, dev, card, T=1, nw=NW, nd=ND):
    """(b) Each kernel alone at one ensemble of 1e5 x 5 or at ``T`` rungs
    of ``nw`` walkers (workload 4's ladder): device ms a call by CUDA
    events around graph replays (``replay_ms``), a call back to back from
    Python, the plain version (CUDA events, eager), the library calls
    (K19: ``torch.add(x, z, alpha=s)`` of the same normals for a scalar
    scale, ``torch.addmm(x, z, L^T)`` for a full covariance, ``baddbmm``
    on the rung axis; K20: none, with a copy of the same bytes,
    ``Tensor.copy_``, as a yardstick) and the bounds (bytes, and
    instructions at the issue rate)."""
    from emcee_tpu_torch.ops import blend_kernel as bk
    from emcee_tpu_torch.ops import gaussian_kernel as gk
    from emcee_tpu_torch.ops.philox import normals, rung_keys

    gen = torch.Generator(device=dev).manual_seed(261)
    lead = (T,) if T > 1 else ()
    x = torch.randn(lead + (nw, nd), device=dev, generator=gen)
    seed = rung_keys(5, T, dev) if T > 1 else 5
    scale = torch.tensor(math.sqrt(0.5), device=dev)
    L = torch.tensor(np.linalg.cholesky(np.asarray(FULL26)),
                     dtype=torch.float32, device=dev)
    z = normals(nw, nd, seed, 5, dev)
    ng = nw // 2
    qs = [torch.randn(lead + (ng, nd), device=dev, generator=gen)
          for _ in range(2)]
    fs = [torch.zeros(lead + (ng,), device=dev) for _ in range(2)]
    q_out = torch.empty_like(qs[0])
    if T > 1:
        full_lib = (lambda: torch.baddbmm(x, z, L.T.expand(T, nd, nd)))
    else:
        full_lib = (lambda: torch.addmm(x, z, L.T))
    calls = {
        "gaussian_propose": (
            lambda: gk.gaussian_propose(x, scale, None, seed, 5),
            lambda: gk.gaussian_propose_plain(x, scale, None, seed, 5),
            lambda: torch.add(x, z, alpha=math.sqrt(0.5)), False),
        "gaussian_propose (full cov)": (
            lambda: gk.gaussian_propose(x, None, L, seed, 5),
            lambda: gk.gaussian_propose_plain(x, None, L, seed, 5),
            full_lib, True),
        "blend_select": (
            lambda: bk.blend_select(qs, fs, [0.8], seed, 5, 0),
            lambda: bk.blend_select_plain(qs, fs, [0.8], seed, 5, 0),
            None, False),
    }
    out = {}
    for name, (fn, plain, lib, full) in calls.items():
        key = name.split(" ")[0]
        nbytes, instr, sfu = k26_bounds(T, ng if key == "blend_select"
                                        else nw, nd, full)[key]
        t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": instruction_bound(instr, sfu)}
        out[name] = {"ms": replay_ms(torch, fn),
                     "call_ms": cuda_ms(torch, fn, reps=50),
                     "plain_ms": slow_ms(torch, plain, reps=3),
                     "bound_ms": max(t.values()),
                     "bound_by": max(t, key=t.get), "bytes": nbytes,
                     "instructions": instr,
                     "library_ms": None if lib is None else replay_ms(
                         torch, lib)}
    out["blend_select"]["copy_ms"] = replay_ms(
        torch, lambda: q_out.copy_(qs[1]))
    what = (f"one ensemble of {nw} x {nd}" if T == 1
            else f"{T} rungs x {nw} walkers x {nd}")
    log(f"phase 26: (b) alone ({what}; K20 two sub-moves of {ng} rows), "
        f"device us a call (graph replays): " + ", ".join(
            f"{name} {v['ms'] * 1e3:.2f} (back to back "
            f"{v['call_ms'] * 1e3:.2f}, plain {v['plain_ms'] * 1e3:.1f}, "
            f"bound {v['bound_ms'] * 1e3:.3f} by {v['bound_by']}"
            + (f", library {v['library_ms'] * 1e3:.2f}"
               if v["library_ms"] is not None else "")
            + (f", copy of the bytes {v['copy_ms'] * 1e3:.2f}"
               if "copy_ms" in v else "") + ")"
            for name, v in out.items()) + f" {card}")
    return out


def k26_stage(torch, np, dev, card, label, n=16):
    """(c) ``label`` at the main path's width (1e5 x 5-D): ``n``
    graph-replayed proposals against the plain versions' eager chain bit
    for bit; host us, device us and kernels a proposal and each kernel's
    us a launch in ``n`` replayed proposals (profiler); the launches
    counted by device words (exactly ``MAIN26[label]`` a proposal)."""
    from emcee_tpu_torch import EnsembleSampler

    per = MAIN26[label]

    def make():
        return EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=26,
                               device=dev, moves=move26(label))

    p0 = np.random.default_rng(4).normal(size=(NW, ND)).astype(np.float32)
    acc = graph_vs_plain_chain(torch, make, p0, n=n)
    smp = make()
    smp.run_mcmc(p0, n, store=False, skip_initial_state_check=True)
    smp.run_mcmc(None, n, store=False)
    host = []
    for _ in range(2):
        _, dt = drive(smp, None, n, store=False)
        host.append(dt / n * 1e6)
    win = busy_window(torch, lambda: smp.run_mcmc(None, n, store=False), n,
                      f"phase 26 {label} at 1e5", names=per)
    counted, _ = counted_replays(
        torch, dev, smp, n, lambda r: {k: v * n for k, v in per.items()},
        f"phase 26 {label} at 1e5", store=False)
    log(f"phase 26: (c) {label} at 1e5 x 5-D: {n} graph-replayed proposals "
        f"equal the plain versions' eager chain bit for bit (acceptance "
        f"{acc:.4f}); {n} replayed proposals: host "
        f"{[round(v, 1) for v in host]} us, device "
        f"{measured(win['device_us_per_proposal'])} us and "
        f"{measured(win['kernels_per_proposal'], '.0f')} kernels a "
        f"proposal, idle {measured(win['idle'], '.4f')}; us a launch: "
        + ", ".join(f"{k} {measured(v and v * 1e3, '.2f')}"
                    for k, v in win["ms_per_launch"].items())
        + f"; launches { {k: v for k, v in counted.items() if v} } (device "
        f"words, exactly {per} a proposal) {card}")
    return dict(win=win, replayed_launches=counted, proposals_counted=n,
                acceptance=acc, host_us=host)


def phase26(torch, np, dev, card):
    """The Gaussian, MH and blended moves (see the module docstring, 26):
    the sweep, the kernels alone at 1e5 and on the ladder, the five moves
    at the main path's width, the six moves on workload 4's ladder (every
    rung at once against the per-rung loop), each path's launches counted
    from 0 just before it, and the rows of K19 and K20, one ensemble and
    with the rung axis.  Returns its numbers and the rows."""
    out = {}
    t0 = time.perf_counter()
    out["sweep"] = k26_sweep(torch, np, dev)
    log(f"phase 26: (a) K19 ((rungs, walkers, ndim) {list(K19_SWEEP)}, every "
        f"covariance and mode, with and without a factor and tuning, host "
        f"offset and device word, injected draws, each rung against the "
        f"rung alone), K20 ((rungs, walkers, ndim, sub-moves) "
        f"{list(K20_SWEEP)}, drawn and injected choices) and K2's rung "
        f"kernel at nsplits=1 ({list(K2_NS1_SWEEP)}, with and without leaves) "
        f"against their plain versions: {out['sweep']} comparisons, all bit "
        f"for bit ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out["alone"] = k26_alone(torch, np, dev, card)
    out["alone_rungs"] = k26_alone(torch, np, dev, card, NT4, NW4, ND4)
    log(f"phase 26: (b) {time.perf_counter() - t0:.1f} s")
    for label, per in MAIN26.items():
        t0 = time.perf_counter()
        with path_launches(out, label, tuple(per), "phase 26"):
            out[label] = k26_stage(torch, np, dev, card, label)
        log(f"phase 26: (c) {label}: {time.perf_counter() - t0:.1f} s")
    p0 = pt_p0(np)
    for label, per in PT26_PER.items():
        t0 = time.perf_counter()
        held = label in PT26_HELD
        with path_launches(out, f"ladder {label}", tuple(per), "phase 26"):
            r = out[f"ladder {label}"] = pt21_path(
                torch, np, dev, card, label, p0, n_l=PT25_LOOP_N,
                sampler=pt26_sampler, per=per, phase="phase 26",
                kept=512 if held else 256, hold=held)
        log(f"phase 26: (d) {label} at {NT4} x {NW4} x {ND4}: 64 "
            f"graph-replayed proposals of every rung at once equal the "
            f"plain versions' eager chain and the per-rung loop bit for bit "
            f"(swaps {r['swaps_64']}); in turns (batched, loop, loop, "
            f"batched; replays of {r['proposals_counted']} and "
            f"{r['loop_proposals_a_replay']} proposals), a proposal: host "
            f"{[round(v, 1) for v in r['host_us'][True]]} / "
            f"{[round(v, 1) for v in r['host_us'][False]]} us, device "
            f"{[measured(v) for v in r['device_us'][True]]} / "
            f"{[measured(v) for v in r['device_us'][False]]} us, kernels "
            f"{[measured(v, '.0f') for v in r['kernels'][True]]} / "
            f"{[measured(v, '.0f') for v in r['kernels'][False]]} (batched "
            f"/ loop); batched launches in {r['proposals_counted']} "
            f"proposals { {k: v for k, v in r['replayed_launches'].items() if v} }"
            f" (device words; exactly {per} a proposal); us a launch in its "
            f"replays: " + ", ".join(
                f"{k} {measured(v and v * 1e3, '.3f')}"
                for k, v in r["win"]["ms_per_launch"].items())
            + f"; phase 14's windows {'held' if held else 'reported'} "
            f"{card} ({time.perf_counter() - t0:.1f} s)")
    log(f"phase 26: kernel wrapper launches of each path, counted from 0 "
        f"(recordings and eager runs): {out['launches']}")
    return out, phase26_rows(out, card)


def phase26_rows(out, card):
    """(e) The rows of K19 and K20 at the main path's width (device time a
    launch in the paths' replays by the profiler; launches by device words
    there; a call alone, back to back and the plain version by CUDA
    events; the bound and the library call) and with the rung axis
    (workload 4's ladder: the same from its replays and at its shape)."""
    meta = {
        "gaussian_propose": (
            "emcee_tpu_torch/csrc/gaussian_propose.cu",
            "emcee_tpu/moves/gaussian.py:118-150",
            ("GaussianMove(0.5)", "ladder GaussianMove(0.5)"),
            "torch.add(x, z, alpha=scale) of the same normals (the full "
            "covariance's torch.addmm(x, z, L^T) / baddbmm in "
            "alone_full_cov)"),
        "blend_select": (
            "emcee_tpu_torch/csrc/blend_select.cu",
            "emcee_tpu/moves/blended.py:87-120",
            ("BlendedMove(DE 0.8, snooker 0.2, blocked)",
             "ladder BlendedMove(DE 0.8, snooker 0.2)"),
            "none: no single PyTorch call draws the choice and selects "
            "(copy_ms: Tensor.copy_ of the same bytes)"),
    }
    rows = []
    for rung in (False, True):
        al = out["alone_rungs" if rung else "alone"]
        for name, (src, jax, paths, lib_note) in meta.items():
            path = out[paths[rung]]
            a = al[name]
            shape = (f"with the rung axis at workload 4's shape ({NT4} rungs "
                     f"x {NW4} walkers x {ND4}, {paths[1]}" if rung else
                     f"at the main path's width (1e5 x 5-D, {paths[0]}")
            extra = {}
            if name == "gaussian_propose":
                f = al["gaussian_propose (full cov)"]
                extra = {"alone_full_cov": {k: f[k] for k in (
                    "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}
            else:
                extra = {"copy_ms": a["copy_ms"]}
            rows.append({
                "name": name + (" (rung axis)" if rung else ""),
                "route": "cuda", "source": src,
                "replaces": jax + (" (vmapped by emcee_tpu/parallel/"
                                   "tempering.py:538)" if rung else ""),
                "launches": path["replayed_launches"][name],
                "max_abs_err": 0.0,
                "ms": path["win"]["ms_per_launch"][name],
                "alone_ms": a["ms"], "call_ms": a["call_ms"],
                "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
                "bound_by": a["bound_by"], "library_ms": a["library_ms"],
                "bytes": a["bytes"], "instructions": a["instructions"],
                **extra,
                "launches_per_proposal": (path["replayed_launches"][name]
                                          / path["proposals_counted"]),
                "ptxas": {k: v for k, v in PTXAS.items()
                          if launched_by(name, k)},
                **({"path_device_us_batched_loop": (path["device_us"][True],
                                                    path["device_us"][False]),
                    "path_kernels_batched_loop": (path["kernels"][True],
                                                  path["kernels"][False])}
                   if rung else {}),
                "note": (f"{shape}): ms in the path's replays (profiler); "
                         f"alone_ms a call alone (CUDA events around graph "
                         f"replays), call_ms back to back from Python; "
                         f"launches counted on the card in "
                         f"{path['proposals_counted']} replayed proposals; "
                         f"max_abs_err: bit for bit over phase 26 (a)'s "
                         f"{out['sweep']} comparisons; bound: the bytes "
                         f"(each input once, each output once) and the "
                         f"instructions needed at the issue rate; "
                         f"library_ms: {lib_note}")})
    for row in rows:
        log(f"phase 26: (e) {row['name']}: device "
            f"{measured(row['ms'] and row['ms'] * 1e3, '.2f')} us/launch in "
            f"its path's replays, {row['alone_ms'] * 1e3:.2f} us a call "
            f"alone, {row['call_ms'] * 1e3:.2f} back to back, plain "
            f"{row['plain_ms'] * 1e3:.1f} us, bound "
            f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}), library "
            f"{measured(row['library_ms'] and row['library_ms'] * 1e3, '.2f')}"
            f" us; launches {row['launches']} {card}")
    return rows


#: K21a's sweep: rungs (None: one ensemble's ``()`` carry)
K21A_SWEEP_T = (None, 1, 2, 3, 16, 32, 200)
#: (step size, max_leapfrog) of K21a's sweep; the small caps bind on some
#: rungs
K21A_STEPS = ((0.05, 1024), (0.5, 4), (1.7, 1), (0.3, 2**20))
#: (rungs, rows a rung, ndim) of the sweep of K13's masked rung mode
K13M_SWEEP = ((2, 1, 1), (3, 31, 2), (16, 256, 5), (32, 256, 5),
              (3, 1000, 128), (16, 37, 7))
#: (rungs (None: one ensemble), rows a rung, ndim, rows a block (None: the
#: plan's)) of K21b's sweep
K21B_SWEEP = ((None, 1, 1, None), (None, 5003, 2, None), (None, NW, ND, None),
              (None, 5003, 3, 512), (1, 2049, 7, None), (3, 37, 1, None),
              (16, 256, 5, None), (32, 256, 128, None), (2, 3000, 16, 1024),
              (16, 1000, 5, 256))
#: a ChEES proposal's launches besides K13's (its trips + 2) and K21b's
#: (a tuning proposal's: 1 with one block a rung, 2 at 1e5)
CHEES_PER = {"langevin_step": 1, "chees_start": 1, "langevin_factor": 1,
             "accept_select": 1}
#: the kernels of a ChEES path (path_launches)
CHEES_KERNELS = ("langevin_step", "chees_start", "langevin_factor",
                 "leapfrog", "accept_select")


def k21b_launches(rows):
    """K21b's launches a call at ``rows`` walkers a rung (its plan's: 1
    with one block a rung, 2 at 1e5)."""
    from emcee_tpu_torch.ops.chees_kernel import grad_plan

    return grad_plan(rows).launches


def chees_expect(n, tune, grads, swaps=False):
    """``counted_replays``' expectation of ``n`` ChEES proposals: each
    replays start, its steps, end and the tune / advance segment, so K13's
    launches (the first step, each replayed step, the last kick) are the
    replays less ``n``; K21b ``grads`` a tuning proposal; K15 once a
    proposal on a ladder."""
    def expect(r):
        out = {k: v * n for k, v in CHEES_PER.items()} | {
            "leapfrog": r - n, "philox_draw": 0,
            "chees_gradient": grads * n if tune else 0}
        return out | ({"pt_swap": n} if swaps else {})

    return expect


def k27_sweep(torch, np, dev):
    """(a) K21a, K13's masked rung mode and K21b against their plain
    versions on the same inputs, bit for bit (NaN included).  K21a over
    ``K21A_SWEEP_T`` x ``K21A_STEPS`` with carries spread over the
    clamps' ranges (the counter at its int32 ends).  K13 masked over
    ``K13M_SWEEP``: each rung's trips drawn in 0-5, the identity, a
    diagonal and the full metric's two launches (kicks, then the drift by
    another row), every buffer and the trip word after every trip, one
    trip past the last, the done-counter back at 0; each rung against the
    one-ensemble K13 of the rung alone stepping its own trips.  K21b over
    ``K21B_SWEEP`` x the three metrics with a NaN, an infinite and a large
    ``lnpdiff``, twice on the same scratch (the done-counters reset);
    each rung against the rung alone.  Returns the number of
    comparisons."""
    from emcee_tpu_torch.ops import chees_kernel as ck
    from emcee_tpu_torch.ops import langevin_kernel as lk

    gen = torch.Generator(device=dev).manual_seed(270)
    n = 0

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def rand(*shape):
        return torch.rand(shape, device=dev, generator=gen)

    for T in K21A_SWEEP_T:
        lead = () if T is None else (T,)
        for step, cap in K21A_STEPS:
            log_adj = (4.0 * randn(*lead)).clamp(-10.0, 10.0)
            log_T = (5.0 * randn(*lead)).clamp(-15.0, 15.0)
            cnt = torch.randint(-2**31, 2**31 - 1, lead, dtype=torch.int32,
                                device=dev, generator=gen)
            if T is not None and T > 2:
                cnt[0], cnt[1] = 2**31 - 1, -2**31
                log_T[2] = 15.0
            outs = [ck.start_out(lead, dev) for _ in range(2)]
            for o in outs:
                o.trip.fill_(5)
            ck.chees_start(log_adj, log_T, cnt, step, cap, outs[0])
            ck.chees_start_plain(log_adj, log_T, cnt, step, cap, outs[1])
            same_bits(outs[0], outs[1], f"K21a T {T} step {step} cap {cap}")
            n += 1
    metrics = ("id", "diag", "full")
    for T, nw, nd in K13M_SWEEP:
        x, p = randn(T, nw, nd), randn(T, nw, nd)
        more = torch.randint(0, 6, (T,), dtype=torch.int64, device=dev,
                             generator=gen)
        more[0], more[-1] = 0, 5
        gs = [randn(T, nw, nd) for _ in range(7)]
        eps = 0.2 + 0.3 * rand(T)
        d = 0.5 + rand(nd)
        for kind in metrics:
            kw = {"d": d} if kind == "diag" else {}
            runs = []
            for fn in (lk.leapfrog, lk.leapfrog_plain):
                xb, pb = x.clone(), p.clone()
                mask = lk.trip_mask(more, torch.zeros((), dtype=torch.int64,
                                                      device=dev))
                rec = []
                for k in range(6):
                    if kind == "full":
                        fn(pb, gs[k], eps, kicks=2, mask=mask, advance=False)
                        fn(pb.flip(-1).contiguous(), None, eps, kicks=0,
                           x=xb, mask=mask)
                    else:
                        fn(pb, gs[k], eps, kicks=2, x=xb, mask=mask, **kw)
                    rec.append((pb.clone(), xb.clone(), mask.trip.clone()))
                if fn is lk.leapfrog and int(mask.done) != 0:
                    raise AssertionError("K13 masked: the done-counter was "
                                         "left at " + str(int(mask.done)))
                runs.append(rec)
            for k, (a, b) in enumerate(zip(*runs)):
                same_bits(a, b, f"K13 masked {kind} T {T} nw {nw} nd {nd} "
                          f"trip {k}")
                n += 1
            if kind != "full":
                for r in (0, T - 1):
                    xr, pr = x[r].clone(), p[r].clone()
                    for k in range(int(more[r])):
                        lk.leapfrog(pr, gs[k][r].contiguous(),
                                    eps[r].contiguous(), kicks=2, x=xr, **kw)
                    same_bits((pr, xr), (runs[0][-1][0][r], runs[0][-1][1][r]),
                              f"K13 masked {kind} rung {r} alone")
                    n += 1
    for T, nw, nd, rows in K21B_SWEEP:
        lead = () if T is None else (T,)
        x, q, p = (randn(*lead, nw, nd) for _ in range(3))
        lp, lp_q = randn(*lead, nw), randn(*lead, nw)
        kin = 0.3 * randn(*lead, nw)
        if nw > 4:
            lp_q[..., 1] = float("nan")
            lp_q[..., 2] = float("inf")
            lp[..., 3] = float("-inf")
            kin[..., 4] = 50.0
        u, traj = rand(*lead), 0.5 + rand(*lead)
        a = randn(nd, nd)
        L = torch.linalg.cholesky(
            a @ a.T + nd * torch.eye(nd, device=dev)).contiguous()
        plan = ck.grad_plan(nw, rows)
        scratch = ck.grad_scratch(T or 1, nd, plan, dev)
        args = (x, q, p, lp, lp_q, kin, u, traj)
        for kind in metrics:
            kw = ({"d": 0.5 + rand(nd)} if kind == "diag" else
                  {"L": L} if kind == "full" else {})
            g_p = torch.zeros(lead, device=dev)
            ck.chees_gradient_plain(*args, g_p, plan=plan, **kw)
            for again in range(2):
                g_k = torch.full(lead, float("nan"), device=dev)
                ck._launch(plan, *args, g_k, scratch=scratch, **kw)
                same_bits((g_k,), (g_p,), f"K21b {kind} T {T} nw {nw} nd "
                          f"{nd} plan {plan} call {again}")
                n += 1
            if T is not None and T >= 16:
                for r in (0, T - 1):
                    g_r = torch.zeros((), device=dev)
                    ck._launch(plan, *(t[r].contiguous() for t in args), g_r,
                               **kw)
                    same_bits((g_r,), (g_p[r],), f"K21b {kind} rung {r} "
                              "alone")
                    n += 1
    return n


def k27_bounds(T, nw, nd, full=False):
    """The least work of one launch of each kernel at ``T`` rungs of
    ``nw`` walkers, ``{name: (bytes, flops)}``, each input read once and
    each output written once: K21a (a rung's three carry words in, eps,
    u, T and more out, the two words), K21b (x, q, p, lp, lp_q and the
    kinetic factor in, g out; ~10 flops a column and ~10 a walker) and K13
    masked with every rung stepping (x, p, g in, x and p out; more and
    the trip word)."""
    rows = T * nw * nd
    return {"chees_start": (T * (12 + 20) + 16, 20 * T),
            "chees_gradient": (4 * (3 * rows + 3 * T * nw + 3 * T)
                               + (4 * nd * nd if full else 0),
                               T * nw * (10 * nd + 10)),
            "leapfrog (masked rung mode)": (4 * 5 * rows + 8 * T + 16,
                                            5 * rows)}


def k27_alone(torch, dev, card, T=1, nw=NW, nd=ND):
    """(b) Each kernel alone at one ensemble of 1e5 x 5 or at ``T`` rungs
    of ``nw`` walkers (workload 4's ladder; K13's masked mode there, every
    rung stepping): device ms a call by CUDA events around graph replays
    (``replay_ms``), a call back to back from Python, the plain version
    (CUDA events, eager) and the bounds.  No single PyTorch call computes
    any of them (library_ms None)."""
    from emcee_tpu_torch.ops import chees_kernel as ck
    from emcee_tpu_torch.ops import langevin_kernel as lk

    gen = torch.Generator(device=dev).manual_seed(271)
    lead = (T,) if T > 1 else ()
    log_adj = 0.1 * torch.randn(lead, device=dev, generator=gen)
    log_T = 0.5 + 0.1 * torch.randn(lead, device=dev, generator=gen)
    cnt = torch.full(lead, 7, dtype=torch.int32, device=dev)
    so = ck.start_out(lead, dev)
    x, q, p = (torch.randn(lead + (nw, nd), device=dev, generator=gen)
               for _ in range(3))
    lp, lp_q, kin = (torch.randn(lead + (nw,), device=dev, generator=gen)
                     for _ in range(3))
    u, traj = torch.rand(lead, device=dev), 1.0 + torch.rand(lead, device=dev)
    g = torch.zeros(lead, device=dev)
    plan = ck.grad_plan(nw)
    scratch = ck.grad_scratch(T, nd, plan, dev)
    grad_args = (x, q, p, lp, lp_q, kin, u, traj, g)
    calls = {
        "chees_start": (
            lambda: ck.chees_start(log_adj, log_T, cnt, 0.5, 1024, so),
            lambda: ck.chees_start_plain(log_adj, log_T, cnt, 0.5, 1024, so)),
        "chees_gradient": (
            lambda: ck.chees_gradient(*grad_args, scratch=scratch),
            lambda: ck.chees_gradient_plain(*grad_args)),
    }
    if T > 1:
        eps = 0.01 + 0.01 * torch.rand(T, device=dev)
        mask = lk.trip_mask(torch.full((T,), 2**40, dtype=torch.int64,
                                       device=dev),
                            torch.zeros((), dtype=torch.int64, device=dev))
        xm, pm, gm = x.clone(), p.clone(), q.clone()
        calls["leapfrog (masked rung mode)"] = (
            lambda: lk.leapfrog(pm, gm, eps, kicks=2, x=xm, mask=mask),
            lambda: lk.leapfrog_plain(pm, gm, eps, kicks=2, x=xm, mask=mask))
    bounds = k27_bounds(T, nw, nd)
    out = {}
    for name, (fn, plain) in calls.items():
        nbytes, flops = bounds[name]
        t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / F32_OPS_PER_S * 1e3}
        out[name] = {"ms": replay_ms(torch, fn),
                     "call_ms": cuda_ms(torch, fn, reps=50),
                     "plain_ms": slow_ms(torch, plain, reps=3),
                     "bound_ms": max(t.values()),
                     "bound_by": max(t, key=t.get), "bytes": nbytes,
                     "flops": flops, "library_ms": None}
    out["chees_gradient"]["launches_a_call"] = plan.launches
    what = (f"one ensemble of {nw} x {nd}" if T == 1
            else f"{T} rungs x {nw} walkers x {nd}")
    log(f"phase 27: (b) alone ({what}), device us a call (graph replays): "
        + ", ".join(
            f"{name} {v['ms'] * 1e3:.2f} (back to back "
            f"{v['call_ms'] * 1e3:.2f}, plain {v['plain_ms'] * 1e3:.1f}, "
            f"bound {v['bound_ms'] * 1e3:.4f} by {v['bound_by']})"
            for name, v in out.items())
        + f"; K21b {plan.launches} launch(es) a call (rows a block "
        f"{plan.rows}, {plan.blocks} a rung) {card}")
    return out


#: K21b's rows a block timed at 1e5 walkers (phase 27 (b))
K21B_ROWS = (256, 512, 1024, 2048, 4096)


def k27_plan_sweep(torch, dev, card, nw=NW, nd=ND):
    """(b) K21b at one ensemble of ``nw`` x ``nd`` under plans of
    ``K21B_ROWS`` rows a block: device ms a call (CUDA events around graph
    replays), each against the plan's plain version bit for bit."""
    from emcee_tpu_torch.ops import chees_kernel as ck

    gen = torch.Generator(device=dev).manual_seed(272)
    args = [torch.randn(nw, nd, device=dev, generator=gen) for _ in range(3)]
    args += [torch.randn(nw, device=dev, generator=gen) for _ in range(3)]
    args += [torch.rand((), device=dev), 1.0 + torch.rand((), device=dev)]
    out = {}
    for rows in K21B_ROWS:
        plan = ck.grad_plan(nw, rows)
        scratch = ck.grad_scratch(1, nd, plan, dev)
        g, g_p = torch.zeros((), device=dev), torch.zeros((), device=dev)
        ck.chees_gradient_plain(*args, g_p, plan=plan)
        ck._launch(plan, *args, g, scratch=scratch)
        same_bits((g,), (g_p,), f"K21b rows {rows}")
        out[rows] = replay_ms(torch, lambda: ck._launch(
            plan, *args, g, scratch=scratch))
    log(f"phase 27: (b) K21b at {nw} x {nd} by rows a block (blocks): "
        + ", ".join(f"{r} ({-(-nw // r)}) {ms * 1e3:.2f} us"
                    for r, ms in out.items()) + f" a call {card}")
    return out


def k27_stage(torch, np, dev, card, make, p0, label, grads, swaps, n=16):
    """(c) ChEES on one path (``make()``'s sampler from ``p0``): a tuning
    run and a production run record the segments; then, tuning and in
    production, host us, device us and kernels a proposal in ``n``
    replayed proposals (profiler; K21a and K21b us a launch, K13 masked's
    from the same events) and the launches counted by device words
    (``chees_expect``); the flag reads a proposal (one)."""
    from emcee_tpu_torch.chunk_graph import ChunkProgram

    smp = make()
    smp.run_mcmc(p0, n, store=False, tune=True, skip_initial_state_check=True)
    smp.run_mcmc(None, n, store=False)
    res = {}
    for tune in (True, False):
        names = dict(CHEES_PER) | ({"chees_gradient": grads} if tune
                                   else {}) | ({"pt_swap": 1} if swaps
                                               else {})
        what = f"phase 27 {label} {'tuning' if tune else 'production'}"
        reads = ChunkProgram.flag_reads
        t0 = time.perf_counter()
        smp.run_mcmc(None, n, store=False, tune=tune)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / n * 1e6
        reads = (ChunkProgram.flag_reads - reads) / n
        win = busy_window(torch, lambda: smp.run_mcmc(
            None, n, store=False, tune=tune), n, what, names=names,
                          raw=True)
        counted, _ = counted_replays(torch, dev, smp, n,
                                     chees_expect(n, tune, grads, swaps),
                                     what, store=False, tune=tune)
        masked = device_ms(win.pop("kernels"), "leapfrog_masked")
        res[tune] = dict(win=win, host_us=host, flag_reads=reads,
                         replayed_launches=counted, proposals_counted=n,
                         masked_ms=masked)
        if reads != 1.0:
            raise AssertionError(f"{what}: {reads} flag reads a proposal")
        log(f"phase 27: (c) {label}, {'tuning' if tune else 'production'}: "
            f"{n} replayed proposals: host {host:.1f} us, flag reads "
            f"{reads:.2f} a proposal, device "
            f"{measured(win['device_us_per_proposal'])} us and "
            f"{measured(win['kernels_per_proposal'], '.0f')} kernels a "
            f"proposal, idle {measured(win['idle'], '.4f')}; us a launch: "
            + ", ".join(f"{k} {measured(v and v * 1e3, '.2f')}"
                        for k, v in win["ms_per_launch"].items())
            + f", K13 masked {measured(masked and masked * 1e3, '.2f')}; "
            f"launches { {k: v for k, v in counted.items() if v} } (device "
            f"words, exactly {n} x {names} and K13 the replays less {n}) "
            f"{card}")
    return res


def phase27(torch, np, dev, card):
    """ChEES-HMC's kernels (see the module docstring, 27): the sweep, each
    kernel alone at 1e5 and on workload 4's ladder, ChEES at 1e5 and on
    the ladder tuning and in production (each path's launches counted from
    0 just before it), and the rows of K21a, K21b and K13's masked rung
    mode.  Returns its numbers and the rows."""
    from emcee_tpu_torch import moves

    out = {}
    t0 = time.perf_counter()
    out["sweep"] = k27_sweep(torch, np, dev)
    log(f"phase 27: (a) K21a (rungs {list(K21A_SWEEP_T)} x (step, "
        f"max_leapfrog) {list(K21A_STEPS)}), K13's masked rung mode ((rungs, "
        f"rows, ndim) {list(K13M_SWEEP)}, trips 0-5 a rung, the three "
        f"metrics, every trip, each rung against the rung alone) and K21b "
        f"({list(K21B_SWEEP)}, the three metrics, non-finite lnpdiff, each "
        f"rung alone) against their plain versions: {out['sweep']} "
        f"comparisons, all bit for bit ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out["alone"] = k27_alone(torch, dev, card)
    out["alone_rungs"] = k27_alone(torch, dev, card, NT4, NW4, ND4)
    out["plans"] = k27_plan_sweep(torch, dev, card)
    log(f"phase 27: (b) {time.perf_counter() - t0:.1f} s")
    p0 = np.random.default_rng(13).normal(size=(NW, ND)).astype(np.float32)
    t0 = time.perf_counter()
    with path_launches(out, "ChEES at 1e5", CHEES_KERNELS
                       + ("chees_gradient",), "phase 27"):
        out["main"] = k27_stage(
            torch, np, dev, card,
            lambda: grad_sampler(dev, moves.ChEESHMCMove(0.5), 27), p0,
            "ChEESHMCMove(0.5) at 1e5 x 5-D", k21b_launches(NW), False)
    log(f"phase 27: (c) at 1e5: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with path_launches(out, "ChEES on the ladder", CHEES_KERNELS
                       + ("chees_gradient", "pt_swap"), "phase 27"):
        out["ladder"] = k27_stage(
            torch, np, dev, card,
            lambda: pt_sampler(dev, seed=27, move=moves.ChEESHMCMove(0.5)),
            pt_p0(np), f"ChEESHMCMove(0.5) on {NT4} x {NW4} x {ND4}",
            k21b_launches(NW4), True)
    log(f"phase 27: (c) on the ladder: {time.perf_counter() - t0:.1f} s")
    log(f"phase 27: kernel wrapper launches of each path, counted from 0 "
        f"(recordings and eager runs): {out['launches']}")
    return out, phase27_rows(out, card)


def phase27_rows(out, card):
    """(d) The rows of K21a and K21b at the main path's width (tuning
    replays of ``ChEESHMCMove(0.5)`` at 1e5) and with the rung axis
    (workload 4's ladder), and of K13's masked rung mode (the ladder's
    replays): device time a launch in the path's replays (profiler),
    launches by device words there, a call alone, back to back and the
    plain version (CUDA events), and the bound."""
    meta = {
        "chees_start": ("emcee_tpu_torch/csrc/chees.cu",
                        "emcee_tpu/moves/gradient.py:468-483"),
        "chees_gradient": ("emcee_tpu_torch/csrc/chees.cu",
                           "emcee_tpu/moves/gradient.py:514-548"),
        "leapfrog (masked rung mode)": (
            "emcee_tpu_torch/csrc/leapfrog.cu",
            "emcee_tpu/moves/gradient.py:485-499"),
    }
    rows = []
    for rung in (False, True):
        path = out["ladder" if rung else "main"][True]
        al = out["alone_rungs" if rung else "alone"]
        shape = (f"workload 4's width ({NT4} x {NW4} x {ND4}" if rung
                 else "the main path's width (1e5 x 5-D")
        for name, (src, jax) in meta.items():
            if name not in al:
                continue
            masked = name.startswith("leapfrog")
            a = al[name]
            n = path["proposals_counted"]
            if masked:
                # Every K13 launch but a proposal's first step and last
                # kick (the one-ensemble rung kernel) is a masked trip.
                ms = path["masked_ms"]
                launches = path["replayed_launches"]["leapfrog"] - 2 * n
            else:
                ms = path["win"]["ms_per_launch"][name]
                launches = path["replayed_launches"][name]
            rows.append({
                "name": name + (" (rung axis)" if rung and not masked
                                else ""),
                "route": "cuda", "source": src,
                "replaces": jax + (" (vmapped by emcee_tpu/parallel/"
                                   "tempering.py:538)" if rung else ""),
                "launches": launches, "max_abs_err": 0.0, "ms": ms,
                "alone_ms": a["ms"], "call_ms": a["call_ms"],
                "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
                "bound_by": a["bound_by"], "library_ms": None,
                "bytes": a["bytes"], "flops": a["flops"],
                "launches_per_proposal": launches / n,
                "ptxas": {k: v for k, v in PTXAS.items()
                          if launched_by("leapfrog_masked" if masked
                                         else name, k)},
                "note": shape + ", ChEESHMCMove(0.5)'s tuning replays): "
                "ms in the "
                "path's replays (profiler; K13 masked: its own kernel's "
                "events, its launches counted with K13's); alone_ms a call "
                "alone (CUDA events around graph replays), call_ms back to "
                "back from Python; launches counted on the card in "
                f"{path['proposals_counted']} replayed proposals; "
                f"max_abs_err: bit for bit over phase 27 (a)'s "
                f"{out['sweep']} comparisons; bound: the bytes (each input "
                "once, each output once) and the float32 operations; "
                "library_ms: none, no single PyTorch call computes it"})
    for row in rows:
        log(f"phase 27: (d) {row['name']}: device "
            f"{measured(row['ms'] and row['ms'] * 1e3, '.2f')} us/launch in "
            f"its path's replays, {row['alone_ms'] * 1e3:.2f} us a call "
            f"alone, {row['call_ms'] * 1e3:.2f} back to back, plain "
            f"{row['plain_ms'] * 1e3:.1f} us, bound "
            f"{row['bound_ms'] * 1e3:.4f} us ({row['bound_by']}); launches "
            f"{row['launches']} {card}")
    return rows


def main_path_turn(torch, np, dev, card, reps=3, n=4000, n_prof=1280):
    """Phase 3's main path alone, for two trees timed in turns, one
    process each (``python3 chip_smoke.py main-path TREE``, TREE a
    checkout whose ``emcee_tpu_torch`` is imported): the best of ``reps``
    unstored runs of ``n`` proposals after the graphs are recorded, and
    K1's and K2's device time a launch in a profiled window of ``n_prof``
    proposals.  Uses only what every tree with tiled K1 and K2 has."""
    import emcee_tpu_torch
    from emcee_tpu_torch import EnsembleSampler, moves
    from emcee_tpu_torch.chunk_graph import MAX_GRAPH

    smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=0,
                          moves=moves.StretchMove(randomize_split=False,
                                                  pair_mode="roll"))
    p0 = np.random.default_rng(1).normal(size=(NW, ND)).astype(np.float32)
    smp.run_mcmc(p0, 500, store=False, skip_initial_state_check=True)
    size = 1
    while size <= MAX_GRAPH:
        smp._program.graph(0, size, False)
        size *= 2
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        smp.run_mcmc(None, n, store=False)
        best = min(best, time.perf_counter() - t0)
    _, kernels = profile_window(
        torch, lambda: smp.run_mcmc(None, n_prof, store=False))
    k1, k2 = (device_ms(kernels, k) for k in ("stretch_propose",
                                              "accept_select"))
    log(f"main-path turn: {Path(emcee_tpu_torch.__file__).parent.parent}: "
        f"{n * NW / best:.4e} walker-steps/s (best of {reps} x {n} "
        f"proposals), K1 {measured(k1 and k1 * 1e3, '.3f')} us, K2 "
        f"{measured(k2 and k2 * 1e3, '.3f')} us a launch ({n_prof} "
        f"proposals profiled) {card}")


def check_turn(torch, np, dev, card, reps=3):
    """One convergence check at the monitor's last chain, for two trees
    timed in turns, one process each (``python3 chip_smoke.py check-turn
    TREE``, TREE a checkout whose ``emcee_tpu_torch`` is imported): phase
    24's ``run_until_converged`` (the same seeds, so the same chain), then
    the best of ``reps`` checks by the host clock (synchronised), the
    device memory a check allocates beyond what it is given, and a
    profiled check's kernels.  Uses only what every tree with K6 has."""
    import emcee_tpu_torch
    from emcee_tpu_torch import (
        ConvergenceMonitor, EnsembleSampler, moves, run_until_converged)
    from emcee_tpu_torch.backends import DeviceBackend
    from emcee_tpu_torch.monitor import stored_chain

    tree = Path(emcee_tpu_torch.__file__).parent.parent
    smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=21,
                          device=dev, backend=DeviceBackend(),
                          moves=moves.StretchMove(randomize_split=False,
                                                  pair_mode="roll"))
    p0 = np.random.default_rng(3).normal(size=(NW, ND)).astype(np.float32)
    run_until_converged(smp, p0, max_steps=2000, check_every=200,
                        monitor=ConvergenceMonitor(rhat_threshold=1.01),
                        thin_by=10, skip_initial_state_check=True)
    chain = stored_chain(smp)
    mon = ConvergenceMonitor(rhat_threshold=1.01)
    mon.update(chain)

    def check():
        return ConvergenceMonitor(rhat_threshold=1.01).update(chain)

    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    check()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    _, kernels = profile_window(torch, check)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
    log(f"check turn: {tree}: one check at {tuple(chain.shape)}: "
        f"{best * 1e3:.2f} ms (best of {reps}), "
        f"{sum(c for c, _ in kernels.values())} kernels, {extra} bytes of "
        f"device memory beyond the chain; tau "
        f"{np.array2string(mon.tau, precision=4)}, rhat "
        f"{np.array2string(mon.rhat, precision=6)}; costliest "
        + "; ".join(f"{k[:40]} {c} x {us / c:.1f} us" for k, (c, us) in top)
        + f" {card}")


def kernel_turn(torch, np, dev, card, n_prof=64):
    """K14 and K2's rung axis in the paths' replays, for two trees timed
    in turns, one process each (``python3 chip_smoke.py kernel-turn
    TREE``, TREE a checkout whose ``emcee_tpu_torch`` is imported): device
    time a launch of K1, K2, K15 and K14 and the device time and kernels a
    proposal in profiled windows of ``n_prof`` replayed proposals of
    workload 4 (K14: every rung's sort keys; K2 with the ``logL`` /
    ``logP`` leaves) and of workload 4 with the blobs ``(2 logL, x)``
    (K2 with four leaves), of 16 replayed proposals of the DIME stage
    (K8a, K8b and K8c where the tree has them, else K14: a split's
    normals), of 16 of ``StretchMove()`` at the main
    path's width (1e5 walkers, the shuffled split), and of 16 of
    ``DEZMove()`` and of ``EnsembleSliceMove()`` at 1e5 walkers and on
    workload 4's ladder (the device time and kernels a proposal: K10 or K9
    where the tree has it, else plain torch, rung by rung on the ladder),
    and of phase 25's side and walk moves at 1e5 walkers (the blocked
    split) and on workload 4's ladder (K5a's side mode, K8 and K18 where
    the tree has them, else plain torch), and of phase 26's Gaussian, MH
    and blended moves likewise (K19 and K20 where the tree has them), and
    ``ChEESHMCMove(0.5)`` tuning at 1e5 walkers and on workload 4's ladder
    tuning and not (K21a, K21b and K13's masked rung mode where the tree
    has them); the host's µs a proposal of every path.  A tree with K16 and
    K17 (``ops/shuffle_kernel.py``) also gives their device time a launch
    on the shuffled paths.  Uses only what every tree with K14 has."""
    import importlib.util

    import emcee_tpu_torch
    from emcee_tpu_torch import EnsembleSampler, moves

    tree = Path(emcee_tpu_torch.__file__).parent.parent
    has16 = importlib.util.find_spec(
        "emcee_tpu_torch.ops.shuffle_kernel") is not None
    has8 = importlib.util.find_spec(
        "emcee_tpu_torch.ops.dime_kernel") is not None
    p0 = pt_p0(np)
    per = {"stretch_propose": 2, "accept_select": 2, "pt_swap": 1,
           "philox_draw": 1} | (SHUF4 if has16 else {})
    runs = {"workload 4": (pt_sampler(dev), n_prof, per),
            "workload 4 with blobs": (pt15_sampler(
                dev, move=moves.StretchMove()), n_prof, per)}
    dime = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=3,
                           device=dev, moves=moves.DIMEMove(
                               aimh_prob=1.0, df=None, randomize_split=False))
    runs["DIME stage"] = (dime, 16, K8_PER if has8 else {
        "accept_select": 2, "philox_draw": 2})
    stretch = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=20,
                              device=dev)
    runs["StretchMove() at 1e5"] = (stretch, 16, {
        "stretch_propose": 2, "accept_select": 2, "philox_draw": 1}
        | (shuffle_per(1, NW) if has16 else {}))
    # DE-Z: K10 where the tree has it (every rung at once on the ladder),
    # else plain torch (rung by rung); the device time and kernels only.
    runs["DEZMove() at 1e5"] = (EnsembleSampler(
        NW, ND, gaussian, vectorize=True, seed=24, device=dev,
        moves=moves.DEZMove()), 16, None)
    runs["DEZMove() on workload 4"] = (pt_sampler(
        dev, seed=88, move=moves.DEZMove()), 16, None)
    # The slice move: K9 where the tree has it (every rung at once on the
    # ladder), else plain torch (rung by rung); its proposals are loops of
    # host reads, so the host's µs a proposal too.
    runs["EnsembleSliceMove() at 1e5"] = (EnsembleSampler(
        NW, ND, gaussian, vectorize=True, seed=26, device=dev,
        moves=moves.EnsembleSliceMove()), 8, None)
    runs["EnsembleSliceMove() on workload 4"] = (pt_sampler(
        dev, seed=89, move=moves.EnsembleSliceMove()), 8, None)
    # The side and walk moves: K5a's side mode, K8a + K8b + K18a or K18b
    # where the tree has them (every rung at once on the ladder), else
    # plain torch (rung by rung); the device time and kernels only.
    for label in MAIN25:
        runs[f"{label} at 1e5"] = (EnsembleSampler(
            NW, ND, gaussian, vectorize=True, seed=27, device=dev,
            moves=move25(label)), 16, None)
    for label in PT25:
        runs[f"{label} on workload 4"] = (pt_sampler(
            dev, seed=90, move=move25(label)), 16, None)
    # The Gaussian, MH and blended moves: K19 and K20 where the tree has
    # them (every rung at once on the ladder), else plain torch and K14
    # (rung by rung); the device time and kernels only.
    for label in MAIN26:
        runs[f"{label} at 1e5"] = (EnsembleSampler(
            NW, ND, gaussian, vectorize=True, seed=28, device=dev,
            moves=move26(label)), 16, None)
    for label in PT26:
        runs[f"{label} on workload 4"] = (pt_sampler(
            dev, seed=91, move=move26(label)), 16, None)
    # ChEES: K21a, K21b and K13's masked rung mode where the tree has them
    # (every rung at once on the ladder), else its plain torch start and
    # gradient (rung by rung on the ladder); tuning runs estimate the
    # ChEES gradient.
    tuned = {"ChEESHMCMove(0.5) tuning at 1e5",
             "ChEESHMCMove(0.5) tuning on workload 4"}
    runs["ChEESHMCMove(0.5) tuning at 1e5"] = (grad_sampler(
        dev, moves.ChEESHMCMove(0.5), 29), 16, None)
    for label in ("ChEESHMCMove(0.5) on workload 4",
                  "ChEESHMCMove(0.5) tuning on workload 4"):
        runs[label] = (pt_sampler(dev, seed=92,
                                  move=moves.ChEESHMCMove(0.5)), 16, None)
    for what, (smp, n, names) in runs.items():
        kw = {"tune": True} if what in tuned else {}
        if what == "DIME stage" or what.endswith(" at 1e5"):
            smp.run_mcmc(np.random.default_rng(4).normal(size=(NW, ND))
                         .astype(np.float32), n, store=False,
                         skip_initial_state_check=True, **kw)
        else:
            smp.run_mcmc(p0, 8, thin_by=4, skip_initial_state_check=True,
                         **kw)
        # records the window's graphs
        smp.run_mcmc(None, n, store=False, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        smp.run_mcmc(None, n, store=False, **kw)
        torch.cuda.synchronize()
        host_us = (time.perf_counter() - t0) / n * 1e6
        win = busy_window(torch, lambda: smp.run_mcmc(None, n, store=False,
                                                      **kw),
                          n, what, names=names)
        log(f"kernel turn: {tree}: {what}: host {host_us:.1f} us, device "
            f"{measured(win['device_us_per_proposal'], '.2f')} us and "
            f"{measured(win['kernels_per_proposal'], '.0f')} kernels a "
            f"proposal ({n} replayed)" + ("; us a launch: " + ", ".join(
                f"{k} {measured(v and v * 1e3, '.3f')}"
                for k, v in win["ms_per_launch"].items()) if names else "")
            + f" {card}")


def inner_tree(arg):
    """The directory ``arg`` resolved, if it lies inside this checkout
    (the directory of this script); raise otherwise."""
    here = Path(__file__).resolve().parent
    tree = Path(arg).resolve()
    if tree != here and here not in tree.parents:
        raise SystemExit(f"chip_smoke: {arg} is not inside {here}")
    return tree


def phase_times(tree) -> int:
    """Run ``tree``'s whole ``chip_smoke.py`` in a child process, echo
    its output, and print the seconds each phase took: each line's wait
    since the line before is charged to the phase that the line names
    (``phase N: ...``), or else to the last phase named.  Returns the
    child's exit code."""
    import re

    t0 = last = time.perf_counter()
    seconds = {}
    phase = "0"
    with subprocess.Popen([sys.executable, "-u", "chip_smoke.py"], cwd=tree,
                          stdout=subprocess.PIPE, text=True) as child:
        for line in child.stdout:
            now = time.perf_counter()
            m = re.match(r"phase (\d+)\b", line)
            phase = m.group(1) if m else phase
            seconds[phase] = seconds.get(phase, 0.0) + now - last
            last = now
            print(line, end="", flush=True)
    split = ", ".join(f"phase {k} {v:.1f} s" for k, v in seconds.items())
    log(f"phase times of {tree}: {split}; total "
        f"{time.perf_counter() - t0:.1f} s, exit {child.returncode}")
    return child.returncode


def sass_functions(lib):
    """``{label: SASS}`` of every kernel in library ``lib`` by the
    toolkit's ``cuobjdump -sass``: each function's instructions without
    their addresses and encodings, constant-bank offsets masked (a kernel
    parameter added after the others moves no other parameter, but the
    offsets of the driver's own constants may move)."""
    import re

    from emcee_tpu_torch.ops._build import _nvcc

    tool = Path(_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if name and m:
            funcs[name].append(re.sub(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]",
                                      "c[.][.]", m.group(1)))
    labels = demangle(list(funcs))
    return {labels[n]: "\n".join(v) for n, v in funcs.items()}


def sass_diff(tree) -> int:
    """Build ``tree``'s and this checkout's K1, K2, K5a, K5b, K11, K12, K13
    and K15 sources with the build's flags into ``build/sass`` and compare
    the SASS of every kernel function that both hold (K15's blob-free
    kernel gained the template parameter ``NoLeaves``, which the
    comparison drops from its name; K2's tiled kernel lost its rung
    parameter, so a tree's one-ensemble ``accept_select_kernel<...,
    false>`` is compared with this checkout's ``accept_select_kernel<...>``;
    K5a, K5b and K11 gained one, so a tree's ``de_propose_kernel<a, b>`` is
    compared with this checkout's ``de_propose_kernel<a, b, false>`` (K5a
    gained the side mode's ``kSide`` last since, so a tree's
    ``de_propose_kernel<a, b, c>`` is compared with ``<a, b, c, false>``,
    and a tree before the rung axis finds none to compare), and
    K12 and K13 gained one as their only template parameter, so a tree's
    ``leapfrog_kernel`` is compared with ``leapfrog_kernel<false>``).
    Prints each function's verdict; returns 1 when a one-ensemble
    instantiation of K1, K2, K5a, K5b, K11, K12 or K13 differs, else 0."""
    import re

    from emcee_tpu_torch.ops import _build

    here = Path(__file__).resolve().parent
    out_dir = _build.build_dir().parent / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    bad = []
    gained = ("de_propose_kernel", "snooker_propose_kernel",
              "langevin_step_kernel", "langevin_factor_kernel",
              "leapfrog_kernel")
    for src in ("stretch_propose.cu", "accept_select.cu", "pt_swap.cu",
                "de_propose.cu", "snooker_propose.cu", "langevin_step.cu",
                "langevin_factor.cu", "leapfrog.cu"):
        sass = {}
        for label, root in (("parent", tree), ("change", here)):
            lib = out_dir / f"{label}-{src}.so"
            subprocess.run([nvcc, *_build._FLAGS, "-o", str(lib),
                            str(root / "emcee_tpu_torch" / "csrc" / src)],
                           check=True, capture_output=True, timeout=600)
            sass[label] = {k.replace("<NoLeaves>", ""): v
                           for k, v in sass_functions(lib).items()}
        mapped = set()
        for fn in sorted(sass["parent"]):
            one = fn.endswith(", false>") and fn.startswith((
                "stretch_propose_kernel", "accept_select_kernel") + gained)
            mine = fn
            if fn.startswith("accept_select_kernel") and not any(
                    k.startswith("accept_select_kernel") and
                    k.endswith(", false>") for k in sass["change"]):
                mine = re.sub(r", false>$", ">", fn)
            if fn.startswith(gained) and fn not in sass["change"]:
                # A tree before the rung axis: every instantiation is one
                # ensemble's.
                mine = (fn[:-1] + ", false>" if fn.endswith(">")
                        else fn + "<false>")
                one = True
            mapped.add(mine)
            same = sass["change"].get(mine) == sass["parent"][fn]
            where = ("missing in the change" if mine not in sass["change"]
                     else "equal" if same else "differs")
            log(f"sass-diff: {src}: {fn}: {where}"
                + (f" (as {mine})" if mine != fn else ""))
            if one and not same:
                bad.append(fn)
        for fn in sorted(set(sass["change"]) - set(sass["parent"])):
            if not (fn.startswith("accept_select_kernel")
                    and fn[:-1] + ", false>" in sass["parent"]
                    or fn in mapped):
                log(f"sass-diff: {src}: {fn}: new in the change")
    log(f"sass-diff: one-ensemble K1 / K2 / K5a / K5b / K11 / K12 / K13 "
        f"instantiations that differ from {tree}'s: {bad or 'none'}")
    return 1 if bad else 0


def _build_dir():
    from emcee_tpu_torch.ops._build import build_dir

    d = build_dir()
    d.mkdir(parents=True, exist_ok=True)
    return str(d)


def main() -> int:
    turn = sys.argv[1:2] in (["main-path"], ["kernel-turn"],
                             ["check-turn"])
    if turn and len(sys.argv) > 2:
        # The tree whose package the turn imports, ahead of this one's.
        sys.path.insert(0, str(inner_tree(sys.argv[2])))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["phase-times"] and len(sys.argv) > 2:
        return phase_times(inner_tree(sys.argv[2]))
    if sys.argv[1:2] == ["sass-diff"] and len(sys.argv) > 2:
        return sass_diff(inner_tree(sys.argv[2]))

    import numpy as np

    import emcee_tpu_torch
    from emcee_tpu_torch import EnsembleSampler, State, moves
    from emcee_tpu_torch.autocorr import integrated_time
    from emcee_tpu_torch.backends import DeviceBackend
    from emcee_tpu_torch.chunk_graph import ChunkProgram
    from emcee_tpu_torch.model import Model, wrap_log_prob_fn
    from emcee_tpu_torch.ops import _build
    from emcee_tpu_torch.ops import accept_kernel as ak
    from emcee_tpu_torch.ops import de_kernel as dk
    from emcee_tpu_torch.ops import snooker_kernel as snk
    from emcee_tpu_torch.ops import stretch_kernel as sk
    from emcee_tpu_torch.ops.philox import (
        ROLL_LANE, to_uniform, uniform_scalar, walker_words)

    dev = torch.device("cuda")
    # The short stored chains trip the tau-length caution; keep it quiet.
    logging.getLogger("emcee_tpu_torch.ops.autocorr").setLevel(logging.ERROR)

    # -- 0. device ---------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    card = f"[{smi}]"
    log(f"device: {name}")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    if turn:
        if sys.argv[1] == "main-path":
            _build.build_all(["stretch_propose", "accept_select"])
            main_path_turn(torch, np, dev, card)
        elif sys.argv[1] == "check-turn":
            _build.build_all()
            check_turn(torch, np, dev, card)
        else:
            _build.build_all([k for k in (
                "stretch_propose", "accept_select", "pt_swap", "philox_draw",
                "group_order", "copy_rows") if k in _build.KERNELS])
            kernel_turn(torch, np, dev, card)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"phase 1: built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.2f} s into {_build.build_dir()}")
    for k, rep in reports.items():
        table = ptxas_table(rep)
        PTXAS.update(table)
        for fn, (regs, smem, spill) in table.items():
            log(f"  ptxas {k}: {fn}: {regs} registers, {smem} bytes static "
                f"shared memory, {spill} bytes spilled")

    if sys.argv[1:] in (["11"], ["12"], ["13"], ["14"], ["15"], ["16"],
                        ["17"], ["18"], ["19"], ["20"], ["21"], ["22"],
                        ["23"], ["24"], ["25"], ["26"], ["27"]):
        # Phase 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
        # 26 or 27 alone (a first check of the blobs, the extension moves,
        # the gradient moves, tempering, K14, the DE family on every rung,
        # the gradient moves on every rung, K7, the shuffled split's K16 and
        # K17, K8, K10, K9, K6, the side and walk moves, the Gaussian, MH
        # and blended moves or ChEES's K21a, K21b and masked K13).
        torch.backends.cuda.matmul.allow_tf32 = False
        t0 = time.perf_counter()
        phase = {"11": phase11, "12": phase12, "13": phase13,
                 "14": phase14, "15": phase15,
                 "16": phase16, "17": phase17,
                 "18": phase18, "19": phase19,
                 "20": phase20, "21": phase21,
                 "22": phase22, "23": phase23,
                 "24": phase24, "25": phase25,
                 "26": phase26, "27": phase27}[sys.argv[1]]
        _, rows_alone = phase(torch, np, dev, card)
        rows_alone = ([rows_alone] if isinstance(rows_alone, dict)
                      else rows_alone)
        log(f"phase {sys.argv[1]}: {time.perf_counter() - t0:.1f} s in all")
        log(f"nvidia-smi: {smi}")
        log(json.dumps({"kernels": rows_alone}))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0

    # -- 2. kernels against their plain versions ---------------------------
    ns, ng = 2, NW // 2
    gen = torch.Generator(device=dev).manual_seed(7)
    coords = torch.randn(NW, ND, device=dev, generator=gen)
    # Index-coded rows: column 0 holds the row number, so with u_z = 0
    # (z = 1/a = 1/2) the partner row is 2 q - s, exactly in float32.
    coded = coords.clone()
    coded[:, 0] = torch.arange(NW, device=dev, dtype=torch.float32)
    errs = {"stretch_propose": 0.0, "accept_select": 0.0}
    seed, offset = 1234567, 42
    k1 = dict(a=2.0, ndim_global=ND)
    for pair_mode in ("roll", "random"):
        for split in range(ns):
            words = walker_words(ng, split, seed, offset, dev)
            u_pair = to_uniform(words[2])
            u_shift = torch.tensor(
                uniform_scalar(seed, ROLL_LANE, split, offset),
                dtype=torch.float32, device=dev)
            inj = dict(u_pair=u_pair) if pair_mode == "random" else dict(
                u_shift=u_shift)
            # (a) partner indices, exactly.
            zeros = torch.zeros(ng, device=dev)
            got = sk.stretch_propose(coded, split, ns, pair_mode=pair_mode,
                                     u_z=zeros, **inj, **k1)[0]
            want = sk.stretch_propose_plain(
                coded, split, ns, pair_mode=pair_mode, u_z=zeros, **inj,
                **k1)[0]
            s0 = coded[split * ng:(split + 1) * ng, 0]
            p_got, p_want = 2 * got[:, 0] - s0, 2 * want[:, 0] - s0
            if not torch.equal(p_got, p_want):
                raise AssertionError(f"K1 {pair_mode}: partner rows differ")
            own = (p_got >= split * ng) & (p_got < (split + 1) * ng)
            if bool(own.any()):
                raise AssertionError(f"K1 {pair_mode}: partner in own group")
            # (b) injected uniforms, (c) the Philox stream.
            u_z = torch.rand(ng, device=dev, generator=gen)
            scale = torch.tensor(1.3, device=dev)
            for kw in (dict(u_z=u_z, **inj),
                       dict(u_z=u_z, scale=scale, **inj),
                       dict(seed=seed, offset=offset)):
                q, f = sk.stretch_propose(coords, split, ns,
                                          pair_mode=pair_mode, **kw, **k1)
                same_from_device_offset(
                    torch, sk.stretch_propose, (coords, split, ns),
                    dict(pair_mode=pair_mode, **kw, **k1), (q, f))
                qp, fp = sk.stretch_propose_plain(
                    coords, split, ns, pair_mode=pair_mode, **kw, **k1)
                e = max(max_err(q, qp), max_err(f, fp))
                errs["stretch_propose"] = max(errs["stretch_propose"], e)
                # K2 on this proposal, injected log_u and Philox.
                lp_q = gaussian(qp)
                lp = gaussian(coords)
                log_u = torch.log(torch.rand(ng, device=dev, generator=gen))
                for k2kw in (dict(log_u=log_u),
                             dict(seed=seed, offset=offset)):
                    outs = []
                    for fn in (ak.accept_select, ak.accept_select_plain):
                        c, l = coords.clone(), lp.clone()
                        acc = torch.zeros(NW, dtype=torch.bool, device=dev)
                        cnt = torch.ones(NW, dtype=torch.int32, device=dev)
                        fn(qp, fp, lp_q, c, l, split, ns, acc, cnt, **k2kw)
                        outs.append((c, l, acc, cnt))
                    for a, b in zip(*outs):
                        if not torch.equal(a, b):
                            raise AssertionError(
                                f"K2 {pair_mode} split {split}: kernel and "
                                "plain disagree")
                    if "offset" in k2kw:
                        c, l = coords.clone(), lp.clone()
                        acc = torch.zeros(NW, dtype=torch.bool, device=dev)
                        cnt = torch.ones(NW, dtype=torch.int32, device=dev)
                        same_from_device_offset(
                            torch, lambda *a, **kw: (
                                ak.accept_select(*a, **kw), c, l, acc, cnt),
                            (qp, fp, lp_q, c, l, split, ns, acc, cnt), k2kw,
                            (outs[0][2][split * ng:(split + 1) * ng],)
                            + outs[0])
                    errs["accept_select"] = max(
                        errs["accept_select"],
                        *(float((a - b).abs().max())
                          for a, b in zip(outs[0][:2], outs[1][:2])))
        log(f"phase 2: K1/K2 {pair_mode}: partners identical; q/factor "
            f"max abs err {errs['stretch_propose']:.3g}; K2 identical; "
            f"device-offset draws identical")

    # One whole proposal, kernel path against plain path.
    model = Model(wrap_log_prob_fn(gaussian, vectorize=True), NW, ND)
    for mv in (moves.StretchMove(randomize_split=False, pair_mode="roll"),
               moves.StretchMove()):
        lp = gaussian(coords)
        st_k, acc_k, _ = mv.propose((5, 9), State(coords.clone(), lp.clone()),
                                    model, ())
        with plain_kernels():
            st_p, acc_p, _ = mv.propose(
                (5, 9), State(coords.clone(), lp.clone()), model, ())
        if not torch.equal(acc_k, acc_p):
            raise AssertionError("whole proposal: acceptance differs")
        e = max(max_err(st_k.coords, st_p.coords),
                max_err(st_k.log_prob, st_p.log_prob))
        log(f"phase 2: whole proposal ({mv.pair_mode}, randomize_split="
            f"{mv.randomize_split}): acceptance identical "
            f"({float(acc_k.float().mean()):.3f}), coords max abs err {e:.3g}")
    t0 = time.perf_counter()
    n_cmp = k2_whole_sweep(torch, dev, (1, 3, 5, 8))
    log(f"phase 2: K2 at nsplits=1 (ng = nwalkers 5003 and 4096, ndim 1, 3, "
        f"5, 8, aligned and unaligned bases): {n_cmp} comparisons with its "
        f"plain version, all identical ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n_cmp = edge_sweep(torch, dev, (1, 3, 5, 8))
    log(f"phase 2: edge-shape sweep, ndim 1, 3, 5, 8, ng {SWEEP_NG}, "
        f"nsplits 2-4: {n_cmp} comparisons of K1/K2 with their plain "
        f"versions, all identical ({time.perf_counter() - t0:.1f} s)")
    p0 = np.random.default_rng(2).normal(size=(NW, ND)).astype(np.float32)
    acc64 = graph_vs_plain_chain(torch, lambda: EnsembleSampler(
        NW, ND, gaussian, vectorize=True, seed=8, device=dev,
        moves=moves.StretchMove(randomize_split=False, pair_mode="roll")),
        p0)
    log(f"phase 2: 64 graph-replayed main-path proposals equal the same 64 "
        f"run eagerly on the plain versions, bit for bit (acceptance "
        f"{acc64:.4f})")
    torch.cuda.synchronize()

    # -- 3. main path, store=False -----------------------------------------
    # The counts are set to 0 just before the main path and read after it
    # (phase 4): the wrappers count the launches of K3's recordings (and
    # their eager warm-ups), K3 its replays.
    for _, fn in wrappers().values():
        fn.launches = 0
    ChunkProgram.replays = 0
    mv = moves.StretchMove(randomize_split=False, pair_mode="roll")
    sampler = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=0,
                              moves=mv)
    p0 = np.random.default_rng(1).normal(size=(NW, ND)).astype(np.float32)
    st, _ = drive(sampler, p0, 500, store=False,
                  skip_initial_state_check=True)
    warm_graphs(sampler)
    n_main = 4000
    st, dt = drive(sampler, None, n_main, store=False)
    mean_lp = float(st.log_prob.mean())
    acc = sampler.last_run_stats.acceptance_fraction.mean()
    if not -0.7 * ND < mean_lp < -0.3 * ND:
        raise AssertionError(f"mean log-prob {mean_lp} outside the window")
    if not 0.2 < acc < 0.8:
        raise AssertionError(f"acceptance fraction {acc}")
    ws = n_main * NW / dt
    log(f"phase 3: store=False {n_main} proposals x {NW} walkers in "
        f"{dt:.3f} s: {ws:.4e} walker-steps/s {card}; mean lp "
        f"{mean_lp:.4f}, acceptance {acc:.4f}; graphs recorded "
        f"{len(sampler._program.graphs)}")
    # -- 4. storage --------------------------------------------------------
    # Both backends store the same kept steps: the same start state (its
    # random_state sets the stream), so the host chain must equal the
    # DeviceBackend chain after the float64 cast.
    thin_by, kept = 20, 100
    stored, chains4 = {}, {}
    st0 = st
    for label, backend in (("Backend", None), ("DeviceBackend",
                                               DeviceBackend())):
        smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=1,
                              moves=mv, backend=backend)
        drive(smp, st0, kept, thin_by=thin_by, skip_initial_state_check=True)
        warm_graphs(smp)
        smp.reset()
        # The same proposals unstored, just before, for the cost of storing.
        _, dt_free = drive(smp, st0, kept * thin_by, store=False,
                           skip_initial_state_check=True)
        st, dt_store = drive(smp, st0, kept, thin_by=thin_by,
                             skip_initial_state_check=True)  # bench.py:203
        chain = smp.get_chain()
        if chain.shape != (kept, NW, ND) or not np.isfinite(chain).all():
            raise AssertionError(f"{label}: chain {chain.shape}")
        if smp.get_log_prob().shape != (kept, NW):
            raise AssertionError(f"{label}: log_prob shape")
        chains4[label] = (chain, smp.get_log_prob(), smp.backend.accepted)
        t1 = time.perf_counter()
        if label == "Backend":
            tau = integrated_time(chain, quiet=True)
        else:
            tau = smp.get_autocorr_time(quiet=True)  # FFTs on the card
            dev_chain4 = smp.backend.chain[:kept, :4000].clone()
        t_tau = time.perf_counter() - t1
        tau = tau * thin_by  # in proposals
        if not np.isfinite(tau).all():
            raise AssertionError(f"{label}: tau {tau}")
        rate = kept * thin_by * NW / dt_store
        ess = rate / float(np.max(tau))
        stored[label] = (rate, ess)
        log(f"phase 4: {label}: {kept} kept x thin_by {thin_by} in "
            f"{dt_store:.3f} s: {rate:.4e} stored walker-steps/s, "
            f"tau {np.array2string(tau, precision=2)} proposals "
            f"({t_tau:.2f} s), {ess:.4e} ESS/s {card}")
        log(f"phase 4: {label}: the same proposals unstored took "
            f"{dt_free:.3f} s; stored / unstored rate "
            f"{dt_free / dt_store:.4f}")
    (hc, hl, ha), (dc, dl, da) = chains4["Backend"], chains4["DeviceBackend"]
    if not (hc.dtype == np.float64
            and np.array_equal(hc, dc.astype(np.float64))
            and np.array_equal(hl, dl.astype(np.float64))
            and np.array_equal(ha, da)):
        raise AssertionError("the host Backend's chain differs from the "
                             "DeviceBackend chain of the same seed")
    log(f"phase 4: the host Backend's float64 chain, log-prob and "
        f"acceptance equal the DeviceBackend's of the same seed after the "
        f"float64 cast, bit for bit ({kept} kept x {NW} x {ND})")
    del chains4, hc, hl, dc, dl
    rates4, splits4, _ = stored_rates(torch, np, dev, card, mv, st0)
    # The phase-3 sampler re-timed now: whether a slower stored phase is
    # the host drifting over the call or something of the new samplers.
    _, dt = drive(sampler, None, kept * thin_by, store=False)
    log(f"phase 4: the phase-3 sampler re-timed, unstored: "
        f"{kept * thin_by * NW / dt:.4e} walker-steps/s {card}")

    # Where the time goes: device time by kernel over a profiled window
    # of the main path, the device's idle share, and each kernel's
    # launches as the profiler counts them inside the replayed graphs.
    # It comes after every timed run, so that no timed run follows the
    # profiler.
    n_prof = 1280  # twenty replays of the 64-proposal graph
    wall, kernels, counts, n_replays = counted_window(
        torch, lambda: drive(sampler, None, n_prof, store=False),
        lambda: {"stretch_propose": 2 * n_prof, "accept_select": 2 * n_prof,
                 "de_propose": 0, "snooker_propose": 0}, "main path")
    busy = sum(us for _, us in kernels.values()) * 1e-6
    dev_ms = {k: device_ms(kernels, k)
              for k in ("stretch_propose", "accept_select")}
    main_prof = dict(idle=1 - busy / wall, busy_us_per_prop=busy / n_prof
                     * 1e6, host_us_per_replay=wall / n_replays * 1e6)
    log(f"phase 4: profiled {n_prof} proposals ({n_replays} replays): wall "
        f"{wall:.4f} s, device busy {busy:.4f} s, idle share "
        f"{main_prof['idle']:.4f}, device {main_prof['busy_us_per_prop']:.2f}"
        f" us per proposal {card}; profiled launches {counts} (exactly 2 x "
        f"K1 and 2 x K2 per proposal)")
    for key, (c, us) in sorted(kernels.items(),
                               key=lambda kv: -kv[1][1])[:8]:
        log(f"  {us / c:9.2f} us x {c:6d}  {key[:90]}")
    main_launches = launch_counts()
    main_replays = ChunkProgram.replays
    if not (main_launches["stretch_propose"] and main_launches[
            "accept_select"] and main_replays):
        raise AssertionError(f"main path launches {main_launches}, "
                             f"replays {main_replays}")
    log(f"phase 4: main path (phases 3-4): wrapper launches {main_launches} "
        f"(recordings and their warm-ups), K3 replays {main_replays}")

    # -- 5. reference defaults at full width -------------------------------
    smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=2)
    out, _ = drive(smp, st, 20, store=False)
    acc5 = smp.last_run_stats.acceptance_fraction.mean()
    if not (torch.isfinite(out.coords).all() and 0.2 < acc5 < 0.8):
        raise AssertionError(f"defaults run: acceptance {acc5}")
    log(f"phase 5: StretchMove() defaults, 20 proposals: acceptance "
        f"{acc5:.4f}")

    # -- 7. K5a / K5b against their plain versions ---------------------------
    # Float32 matmuls in full float32 on the card (workload 3's x @ W).
    torch.backends.cuda.matmul.allow_tf32 = False
    errs.update(de_propose=0.0, snooker_propose=0.0)
    phase7(torch, np, dev, errs)
    torch.cuda.synchronize()

    # -- 8. workload 3 -------------------------------------------------------
    w3 = phase8(torch, np, dev, card)

    # -- 6. per-kernel times -----------------------------------------------
    k1 = dict(a=2.0, ndim_global=ND, pair_mode="roll", seed=3, offset=8)
    q, f = sk.stretch_propose(coords, 0, ns, **k1)
    lp = gaussian(coords)
    lp_q = gaussian(q)
    work = [coords.clone(), lp.clone(),
            torch.zeros(NW, dtype=torch.bool, device=dev),
            torch.zeros(NW, dtype=torch.int32, device=dev)]
    k2 = dict(seed=3, offset=8)
    ak.accept_select(q, f, lp_q, *[w.clone() for w in work[:2]], 0, ns,
                     work[2], work[3], **k2)
    n_acc = int(work[2][:ng].sum())
    # Workload 3's shapes: one split of 1e4 x 100 (ng = nc = 5000).
    ng3 = NW3 // 2
    log_prob3, p03 = workload3_target(np, torch, dev)
    coords3 = torch.as_tensor(p03, device=dev)
    k5a = dict(gamma0=dk.de_gamma0(None, ND3), sigma=1e-5, pair_mode="roll",
               seed=3, offset=8)
    k5b = dict(gammas=1.7, ndim_global=ND3, pair_mode="roll", seed=3,
               offset=8)
    q3, f3 = snk.snooker_propose(coords3, 0, 2, **k5b)
    lp3, lp_q3 = log_prob3(coords3), log_prob3(q3)
    work3 = [coords3.clone(), lp3.clone(),
             torch.zeros(NW3, dtype=torch.bool, device=dev),
             torch.zeros(NW3, dtype=torch.int32, device=dev)]
    ak.accept_select(q3, f3, lp_q3, *[w.clone() for w in work3[:2]], 0, 2,
                     work3[2], work3[3], **k2)
    n_acc3 = int(work3[2][:ng3].sum())
    # K1 and K2 over tiles, and K2's two variants, at both shapes, on the
    # inputs of the bounds below (before the timings update them in place).
    sweeps = {
        "nd5": tile_sweep(torch, coords, q, f, lp_q, work, ns, **k2),
        "nd100": tile_sweep(torch, coords3, q3, f3, lp_q3, work3, 2, **k2),
    }
    for shape, (us, tile) in sweeps.items():
        for t, row in us.items():
            log(f"phase 6: tile sweep {shape}, tile {t:3d}"
                f"{' (the plan)' if t == tile else ''}: device us/launch "
                + ", ".join(f"{k} {v:.3f}" for k, v in sorted(row.items()))
                + f" {card}")
    # K5a (direct, the kept variant, and staged) and K5b over tiles, at
    # workload 3's shape.
    k5_us, k5_tiles = k5_tile_sweep(torch, coords3, **k2)
    for t, row in k5_us.items():
        plan_of = [k for k, v in k5_tiles.items() if v == t]
        log(f"phase 6: K5 tile sweep nd100, tile {t:3d}"
            f"{f' (the plan of {plan_of})' if plan_of else ''}: device "
            f"us/launch " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in sorted(row.items()))
            + f" {card}")
    times = {
        "de_propose": (
            cuda_ms(torch, lambda: dk.de_propose(coords3, 0, 2, **k5a)),
            cuda_ms(torch, lambda: dk.de_propose_plain(
                coords3, 0, 2, **k5a), reps=20)),
        "snooker_propose": (
            cuda_ms(torch, lambda: snk.snooker_propose(coords3, 0, 2, **k5b)),
            cuda_ms(torch, lambda: snk.snooker_propose_plain(
                coords3, 0, 2, **k5b), reps=20)),
        "accept_select_nd100": (
            cuda_ms(torch, lambda: ak.accept_select(
                q3, f3, lp_q3, work3[0], work3[1], 0, 2, work3[2], work3[3],
                **k2)),
            cuda_ms(torch, lambda: ak.accept_select_plain(
                q3, f3, lp_q3, work3[0], work3[1], 0, 2, work3[2], work3[3],
                **k2), reps=20)),
        "stretch_propose": (
            cuda_ms(torch, lambda: sk.stretch_propose(coords, 0, ns, **k1)),
            cuda_ms(torch, lambda: sk.stretch_propose_plain(
                coords, 0, ns, **k1), reps=20)),
        "accept_select": (
            cuda_ms(torch, lambda: ak.accept_select(
                q, f, lp_q, work[0], work[1], 0, ns, work[2], work[3],
                **k2)),
            cuda_ms(torch, lambda: ak.accept_select_plain(
                q, f, lp_q, work[0], work[1], 0, ns, work[2], work[3],
                **k2), reps=20)),
    }
    # Each kernel's device time with its offset as a host int and as a
    # device word plus an increment (as the graphs launch it), profiled
    # side by side over eager launches of the same inputs.
    from emcee_tpu_torch.ops.philox import DeviceOffset

    def offset_cost(fn, args, kw, reps=100):
        word = torch.tensor(kw["offset"] - 3, dtype=torch.int64, device=dev)
        out = []
        for off in (kw["offset"], DeviceOffset(word, 3)):
            out.append(profiled_ms(torch, lambda: [
                fn(*args, **{**kw, "offset": off}) for _ in range(reps)],
                fn.__name__))
        return out

    offset_ms = {
        "stretch_propose": offset_cost(sk.stretch_propose,
                                       (coords, 0, ns), k1),
        "accept_select": offset_cost(
            ak.accept_select,
            (q, f, lp_q, work[0], work[1], 0, ns, work[2], work[3]), k2),
        "accept_select_nd100": offset_cost(
            ak.accept_select,
            (q3, f3, lp_q3, work3[0], work3[1], 0, 2, work3[2], work3[3]),
            k2),
        "de_propose": offset_cost(dk.de_propose, (coords3, 0, 2), k5a),
        "snooker_propose": offset_cost(snk.snooker_propose,
                                       (coords3, 0, 2), k5b),
    }
    for kname, (ms_h, ms_d) in offset_ms.items():
        log(f"phase 6: {kname}: device {ms_h * 1e3:.2f} us/launch with a "
            f"host offset, {ms_d * 1e3:.2f} us with a device offset word "
            f"(eager launches, profiled) {card}")

    # Least work each function must do: each input read once, each
    # output written once; integer and float operations counted at the
    # float32 rate.  K1 reads s and one partner row per walker and writes
    # q and factor.  K2 reads factor, lp_q and lp_s and writes acc for
    # every walker, but reads q and writes the row, its lp and its count
    # (read and write) only for the n_acc walkers this run accepts.
    # K5a and K5b read s and the complement (the whole ensemble, once)
    # and write q and factor; K5a also draws a Philox normal per walker
    # and does 3 flops per element, K5b ~10 flops per element.
    philox_ops = 10 * 10  # ten rounds of ~10 32-bit operations
    bounds = {
        "stretch_propose": (
            4 * (NW * ND + ng * ND + ng),
            ng * (philox_ops + 25 + 3 * ND) + philox_ops),
        "accept_select": (
            4 * ng * 3 + ng + n_acc * (4 * ND + 4 * (ND + 1) + 8),
            ng * (philox_ops + 6)),
        "de_propose": (
            4 * (NW3 * ND3 + ng3 * ND3 + ng3),
            ng3 * (philox_ops + 40 + 3 * ND3)),
        "snooker_propose": (
            4 * (NW3 * ND3 + ng3 * ND3 + ng3),
            ng3 * (10 * ND3 + 20)),
        "accept_select_nd100": (
            4 * ng3 * 3 + ng3 + n_acc3 * (4 * ND3 + 4 * (ND3 + 1) + 8),
            ng3 * (philox_ops + 6)),
    }
    meta = {
        "de_propose": (
            "emcee_tpu_torch/csrc/de_propose.cu",
            "emcee_tpu/moves/de.py:45"),
        "snooker_propose": (
            "emcee_tpu_torch/csrc/snooker_propose.cu",
            "emcee_tpu/moves/de_snooker.py:118"),
        "stretch_propose": (
            "emcee_tpu_torch/csrc/stretch_propose.cu",
            "emcee_tpu/moves/stretch.py:59"),
        "accept_select": (
            "emcee_tpu_torch/csrc/accept_select.cu",
            "emcee_tpu/moves/red_blue.py:196"),
    }
    # "ms" is the kernel's mean device time on the main path (profiler);
    # "call_ms" is the time per call when launched back to back from
    # Python (CUDA events), which the host's enqueue cost bounds.
    log(f"phase 6: accept_select's bound counts the {n_acc} of {ng} "
        f"walkers its timed inputs accept ({n_acc3} of {ng3} at ndim {ND3})")

    def bound(kname):
        nbytes, nops = bounds[kname]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_OPS_PER_S * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations", nbytes)

    # K1 and K2 launches are the main path's (phases 3-4), K5a and K5b
    # launches workload 3's (phase 8): the wrappers' counts, i.e. the
    # launches recorded into K3's graphs and their eager warm-ups; the
    # profiled windows count the replayed launches.
    launches_of = {"stretch_propose": main_launches["stretch_propose"],
                   "accept_select": main_launches["accept_select"],
                   "de_propose": w3["launches"]["de_propose"],
                   "snooker_propose": w3["launches"]["snooker_propose"]}
    rows = []
    for kname in ("stretch_propose", "accept_select", "de_propose",
                  "snooker_propose"):
        b_ms, b_by, nbytes = bound(kname)
        call_ms, plain_ms = times[kname]
        ms = (dev_ms if kname in ("stretch_propose", "accept_select")
              else w3["dev_ms"]).get(kname) or call_ms
        row = {
            "name": kname, "route": "cuda", "source": meta[kname][0],
            "replaces": meta[kname][1], "launches": launches_of[kname],
            "max_abs_err": errs[kname], "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "ms_host_offset": offset_ms[kname][0],
            "ms_device_offset": offset_ms[kname][1],
        }
        if kname in ("de_propose", "snooker_propose"):
            part = "K5a" if kname == "de_propose" else "K5b"
            row["redesigned"] = "PR 5"
            row["tile_sweep_us"] = {
                "nd100": {t: {k: v for k, v in r.items()
                              if k.startswith(part)}
                          for t, r in k5_us.items()
                          if any(k.startswith(part) for k in r)}}
            if kname == "de_propose":
                at = k5_us[k5_tiles[kname]]
                row.update(variant="staged",
                           ms_staged_eager=at["K5a staged"] * 1e-3,
                           ms_direct_eager=at["K5a direct"] * 1e-3)
        if kname in ("stretch_propose", "accept_select"):
            part = "K1" if kname == "stretch_propose" else "K2"
            row["redesigned"] = "PR 4"
            row["tile_sweep_us"] = {
                shape: {t: {k: v for k, v in r.items() if k.startswith(part)}
                        for t, r in us.items()}
                for shape, (us, _) in sweeps.items()}
        log(f"phase 6: {kname}: device {ms * 1e3:.2f} us/launch, "
            f"{call_ms * 1e3:.2f} us per back-to-back call, plain "
            f"{plain_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({nbytes} "
            f"bytes, {b_by}) {card}")
        if kname == "accept_select":
            # K2 on workload 3's path too: ndim 100, ng 5000.
            b_ms, b_by, nbytes = bound("accept_select_nd100")
            call_ms, plain_ms = times["accept_select_nd100"]
            ms = w3["dev_ms"].get(kname) or call_ms
            row.update(
                launches_workload3=w3["launches"]["accept_select"],
                ms_nd100=ms, call_ms_nd100=call_ms, plain_ms_nd100=plain_ms,
                bound_ms_nd100=b_ms, bound_by_nd100=b_by,
                ms_host_offset_nd100=offset_ms["accept_select_nd100"][0],
                ms_device_offset_nd100=offset_ms["accept_select_nd100"][1],
                **{f"ms_{v}_{shape}": us[tile][f"K2 {v}"] * 1e-3
                   for shape, (us, tile) in sweeps.items()
                   for v in ("staged", "direct")})
            log(f"phase 6: accept_select at ndim {ND3}: device "
                f"{ms * 1e3:.2f} us/launch, {call_ms * 1e3:.2f} us per "
                f"back-to-back call, plain {plain_ms * 1e3:.2f} us, bound "
                f"{b_ms * 1e3:.3f} us ({nbytes} bytes, {b_by}) {card}")
        rows.append(row)

    # The main path on the plain versions, for reference only (eager: the
    # plain versions are not recorded into graphs).
    smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=0, moves=mv)
    smp._use_graphs = False
    with plain_kernels():
        smp.run_mcmc(p0, 20, store=False, skip_initial_state_check=True)
        n_plain = 200
        t0 = time.perf_counter()
        smp.run_mcmc(None, n_plain, store=False)
        dt_plain = time.perf_counter() - t0
    log(f"phase 6: plain-version main path (reference only): "
        f"{n_plain * NW / dt_plain:.4e} walker-steps/s {card}")
    # Workload 3 on the plain versions, for reference only.
    smp = EnsembleSampler(NW3, ND3, log_prob3, vectorize=True, seed=0,
                          moves=workload3_moves(moves))
    smp._use_graphs = False
    with plain_kernels():
        smp.run_mcmc(w3["state"], 5, store=False,
                     skip_initial_state_check=True)
        n_plain3 = 40
        t0 = time.perf_counter()
        smp.run_mcmc(None, n_plain3, store=False)
        dt_plain3 = time.perf_counter() - t0
    log(f"phase 6: plain-version workload 3 (reference only): "
        f"{n_plain3 * NW3 / dt_plain3:.4e} walker-steps/s {card}")

    # -- 9. K3 -------------------------------------------------------------
    # The bytes one main-path proposal must move: per split K1, the
    # log-prob (read q, write lp) and K2 (at phase 6's acceptance).
    lp_bytes = 4 * (ng * ND + ng)
    per_prop = 2 * (bounds["stretch_propose"][0] + lp_bytes
                    + bounds["accept_select"][0])
    k3 = phase9(torch, np, dev, card, per_prop, main_prof["busy_us_per_prop"])
    k3["launches"] = main_replays
    k3["idle_share"] = {"main path": main_prof["idle"],
                        "workload 3": w3["idle"]}
    k3["host_us_per_replay_profiled"] = {
        "main path": main_prof["host_us_per_replay"],
        "workload 3": w3["host_us_per_replay"]}
    rows.append(k3)

    # -- 10. this slice's paths ----------------------------------------------
    p10 = phase10(torch, np, dev, card, {
        "phase 4 DeviceBackend [:, :4000]": dev_chain4,
        "phase 8 DeviceBackend [:, :1000, :16]": w3["chain"]})
    rows.append(p10["k6"])

    # -- 11. blobs and io ------------------------------------------------------
    t0 = time.perf_counter()
    p11, k2_blob_row = phase11(torch, np, dev, card)
    rows.append(k2_blob_row)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s in all")

    # -- 12. the extension moves -------------------------------------------------
    t0 = time.perf_counter()
    p12, rows12 = phase12(torch, np, dev, card)
    rows += rows12
    log(f"phase 12: {time.perf_counter() - t0:.1f} s in all")

    # -- 13. the gradient moves ---------------------------------------------------
    t0 = time.perf_counter()
    p13, rows13 = phase13(torch, np, dev, card)
    rows += rows13
    log(f"phase 13: {time.perf_counter() - t0:.1f} s in all")

    # -- 14. parallel tempering -------------------------------------------------
    t0 = time.perf_counter()
    p14, rows14 = phase14(torch, np, dev, card)
    rows += rows14
    log(f"phase 14: {time.perf_counter() - t0:.1f} s in all")

    # -- 15. the rest of tempering -----------------------------------------
    t0 = time.perf_counter()
    p15, rows15 = phase15(torch, np, dev, card)
    rows += rows15
    log(f"phase 15: {time.perf_counter() - t0:.1f} s in all")

    # -- 16. K14, the counter-based draws ------------------------------------
    t0 = time.perf_counter()
    p16, rows16 = phase16(torch, np, dev, card, p12, p14)
    rows += rows16
    log(f"phase 16: {time.perf_counter() - t0:.1f} s in all")

    # -- 17. DE and DE-snooker on every rung ---------------------------------
    t0 = time.perf_counter()
    _, rows17 = phase17(torch, np, dev, card)
    rows += rows17
    log(f"phase 17: {time.perf_counter() - t0:.1f} s in all")

    # -- 18. the gradient moves on every rung --------------------------------
    t0 = time.perf_counter()
    _, rows18 = phase18(torch, np, dev, card)
    rows += rows18
    log(f"phase 18: {time.perf_counter() - t0:.1f} s in all")

    # -- 19. K7, the KDE log-density -----------------------------------------
    t0 = time.perf_counter()
    _, rows19 = phase19(torch, np, dev, card)
    rows += rows19
    log(f"phase 19: {time.perf_counter() - t0:.1f} s in all")

    # -- 20. the shuffled split: K16 and K17 ---------------------------------
    t0 = time.perf_counter()
    _, rows20 = phase20(torch, np, dev, card)
    rows += rows20
    log(f"phase 20: {time.perf_counter() - t0:.1f} s in all")

    # -- 21. K8, DIME's moments, factor and proposal ---------------------------
    t0 = time.perf_counter()
    _, rows21 = phase21(torch, np, dev, card)
    rows += rows21
    log(f"phase 21: {time.perf_counter() - t0:.1f} s in all")

    # -- 22. K10, DE-Z's spread, proposal and archive fold --------------------
    t0 = time.perf_counter()
    _, rows22 = phase22(torch, np, dev, card)
    rows += rows22
    log(f"phase 22: {time.perf_counter() - t0:.1f} s in all")

    # -- 23. K9, the slice move's loops --------------------------------------
    t0 = time.perf_counter()
    _, rows23 = phase23(torch, np, dev, card)
    rows += rows23
    log(f"phase 23: {time.perf_counter() - t0:.1f} s in all")

    # -- 24. K6, the diagnostics' fused chains --------------------------------
    t0 = time.perf_counter()
    _, rows24 = phase24(torch, np, dev, card)
    rows += rows24
    log(f"phase 24: {time.perf_counter() - t0:.1f} s in all")

    # -- 25. the side and walk moves -----------------------------------------
    t0 = time.perf_counter()
    _, rows25 = phase25(torch, np, dev, card)
    rows += rows25
    log(f"phase 25: {time.perf_counter() - t0:.1f} s in all")

    # -- 26. the Gaussian, MH and blended moves on every rung ----------------
    t0 = time.perf_counter()
    _, rows26 = phase26(torch, np, dev, card)
    rows += rows26
    log(f"phase 26: {time.perf_counter() - t0:.1f} s in all")

    # -- 27. ChEES-HMC's start, tuning gradient and masked trips -------------
    t0 = time.perf_counter()
    _, rows27 = phase27(torch, np, dev, card)
    rows += rows27
    log(f"phase 27: {time.perf_counter() - t0:.1f} s in all")
    for thin, (r_s, r_f) in sorted(rates4.items()):
        log(f"summary: host Backend stored, thin_by {thin}: {r_s:.4e} "
            f"walker-steps/s (unstored {r_f:.4e}); split per kept step "
            + ", ".join(f"{k} {v:.4f}" for k, v in splits4[thin].items()
                        if k != "chunk") + f" ms {card}")
    log(f"phase 9: K3: {k3['launches']} replays on the main path; replay "
        f"of {k3['proposals_per_replay']} proposals {k3['ms'] * 1e3:.2f} "
        f"us against its kernels' device time "
        f"{k3['kernels_device_ms'] * 1e3:.2f} us and a byte bound of "
        f"{k3['bound_ms'] * 1e3:.2f} us {card}")

    log(f"summary: main path {ws:.4e} walker-steps/s; stored "
        f"{stored['Backend'][0]:.4e} (Backend) / "
        f"{stored['DeviceBackend'][0]:.4e} (DeviceBackend) walker-steps/s; "
        f"ESS/s {stored['Backend'][1]:.4e} / {stored['DeviceBackend'][1]:.4e} "
        f"{card}; package {emcee_tpu_torch.__name__}")
    (w1a, w1b), (w4a, w4b) = w3["ws_pairs"]
    log(f"summary: workload 3 {w1a:.4e} / {w1b:.4e} walker-steps/s "
        f"(mixture_block=4: {w4a:.4e} / {w4b:.4e}; DeviceBackend stored "
        f"{w3['ws_stored']:.4e}), tau {w3['tau']:.2f} proposals, ESS/s "
        f"{w3['ess']:.4e}, idle share {w3['idle']:.4f} {card}")
    log(f"nvidia-smi: {smi}")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
