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

Phases run in the order 0-5, 7, 8, 6, 9.  Every phase raises on failure.
The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  It exits non-zero, printing no
result, without a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import logging
import subprocess
import sys
import time

NW, ND = 100_000, 5
NW3, ND3 = 10_000, 100  # workload 3 (benchmarks/workload3.py:28-29)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
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
#: (module under emcee_tpu_torch.ops, wrapper) of every kernel
KERNELS = (("stretch_kernel", "stretch_propose"),
           ("accept_kernel", "accept_select"),
           ("de_kernel", "de_propose"),
           ("snooker_kernel", "snooker_propose"))


def log(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def gaussian(x):
    return -0.5 * (x**2).sum(-1)


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


def profile_window(torch, fn):
    """Run ``fn`` under ``torch.profiler``; return the wall seconds and
    ``{kernel name: (launches, device microseconds)}`` for every kernel
    the card ran in the window (empty if the profiler saw none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            kernels[e.key] = (e.count, us)
    return wall, kernels


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
    """Route the moves through all four kernels' plain versions (the
    moves look the wrappers up on their modules at each call)."""
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
            if f"{kname}_kernel" in key]
    if not hits:
        return None
    return sum(us for _, us in hits) / sum(c for c, _ in hits) * 1e-3


def profiled_ms(torch, fn, kname, tries=3):
    """Mean device ms per launch of ``kname`` over a profiled window of
    ``fn``.  The profiler now and then records no launch at all in a
    window of eager launches; such a window is run again, up to
    ``tries`` times, and said so."""
    for _ in range(tries):
        _, kernels = profile_window(torch, fn)
        ms = device_ms(kernels, kname)
        if ms is not None:
            return ms
        log(f"  the profiler recorded no {kname} launch; window run again")
    raise AssertionError(f"the profiler recorded no {kname} launch in "
                         f"{tries} windows")


def profiled_counts(kernels):
    """``{wrapper name: launches}`` of every kernel, as the profiler
    counted them in a window (graph replays included)."""
    return {name: sum(c for key, (c, _) in kernels.items()
                      if f"{name}_kernel" in key)
            for _, name in KERNELS}


def warm_graphs(smp):
    """Record every graph of a sampler's chunk program now (each move,
    every size up to ``MAX_GRAPH``), so that no later run records one;
    recording does not move the chain."""
    from emcee_tpu_torch.chunk_graph import MAX_GRAPH

    for i in range(len(smp._moves)):
        size = 1
        while size <= MAX_GRAPH:
            smp._program.graph(i, size, False)
            size *= 2


def drive(smp, state, n, **kw):
    """``run_mcmc`` with its launch checks; returns ``(state, seconds)``.

    On the graph path, a run of a sampler whose chunk program exists
    records no graph and calls no kernel wrapper: every proposal is a
    replay.  On the eager path (``_use_graphs`` off), the wrappers'
    counters show a proposal kernel twice and K2 twice per proposal."""
    from emcee_tpu_torch.chunk_graph import ChunkProgram

    prog = smp._program
    ngraphs = None if prog is None else len(prog.graphs)
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
    elif (rose["stretch_propose"] + rose["de_propose"]
          + rose["snooker_propose"] != 2 * n_prop
          or rose["accept_select"] != 2 * n_prop):
        raise AssertionError(f"eager run: launches rose by {rose} for "
                             f"{n_prop} proposals")
    return out, dt


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
    from emcee_tpu_torch.ops._wrap import device_sm_count, tile_plan
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

    def lp_variants(q):
        special = torch.tensor([float("nan"), float("inf"), -float("inf")],
                               device=dev)
        mixed = gaussian(q).clone()
        mixed[::3] = special.repeat(-(-q.shape[0] // 9))[:mixed[::3].numel()]
        return (("proposal's lp_q", gaussian(q)),
                ("all accepted", torch.full_like(mixed, float("inf"))),
                ("none accepted", torch.full_like(mixed, -float("inf"))),
                ("NaN and +-inf in lp_q", mixed))

    def direct(q, f, lp_q, c, l, split, ns, acc, cnt, seed=0, offset=0,
               log_u=None):
        """K2 with q read from device memory (no staging)."""
        plan = tile_plan(q.shape[0], c.shape[1], split,
                         device_sm_count(c.device), c.data_ptr(),
                         q.data_ptr())
        ak._launch(plan, q, f, lp_q, c, l, split, acc, cnt, seed, offset,
                   log_u)

    # The wrapper (staged wherever it can), the direct variant, the plain
    # version.
    k2_fns = (ak.accept_select, direct, ak.accept_select_plain)

    def k2(q, f, coords, lp, split, ns, what, copy, **kw):
        nw = coords.shape[0]
        for label, lp_q in lp_variants(q):
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
    from emcee_tpu_torch.chunk_graph import ChunkProgram

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
    del chain, smp_d

    # A profiled window: the profiler's launches must be exactly those of
    # the host-known move sequence, inside the replayed graphs.
    n_prof = 1000
    seq = move_seq(smp, None, n_prof, store=False)
    r0 = ChunkProgram.replays
    wall, kernels = profile_window(
        torch, lambda: drive(smp, None, n_prof, store=False))
    n_replays = ChunkProgram.replays - r0
    counts = profiled_counts(kernels)
    n_de = seq.count(0)
    want = {"stretch_propose": 0, "accept_select": 2 * n_prof,
            "de_propose": 2 * n_de, "snooker_propose": 2 * (n_prof - n_de)}
    if counts != want:
        raise AssertionError(f"workload 3: profiled launches {counts}, "
                             f"expected {want}")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 1

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

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"phase 1: built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.2f} s into {_build.build_dir()}")
    for k, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {k}: {line.strip()}")

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
    thin_by, kept = 20, 100
    stored = {}
    for label, backend in (("Backend", None), ("DeviceBackend",
                                               DeviceBackend())):
        smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=1,
                              moves=mv, backend=backend)
        st, _ = drive(smp, st, kept, thin_by=thin_by,
                      skip_initial_state_check=True)
        warm_graphs(smp)
        smp.reset()
        # The same proposals unstored, just before, for the cost of storing.
        st, dt_free = drive(smp, st, kept * thin_by, store=False,
                            skip_initial_state_check=True)
        st, dt_store = drive(smp, st, kept, thin_by=thin_by,
                             skip_initial_state_check=True)  # bench.py:203
        chain = smp.get_chain()
        if chain.shape != (kept, NW, ND) or not np.isfinite(chain).all():
            raise AssertionError(f"{label}: chain {chain.shape}")
        if smp.get_log_prob().shape != (kept, NW):
            raise AssertionError(f"{label}: log_prob shape")
        t1 = time.perf_counter()
        if label == "Backend":
            tau = integrated_time(chain, quiet=True)
        else:
            tau = smp.get_autocorr_time(quiet=True)  # FFTs on the card
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
    r0 = ChunkProgram.replays
    wall, kernels = profile_window(
        torch, lambda: drive(sampler, None, n_prof, store=False))
    n_replays = ChunkProgram.replays - r0
    busy = sum(us for _, us in kernels.values()) * 1e-6
    dev_ms = {k: device_ms(kernels, k)
              for k in ("stretch_propose", "accept_select")}
    counts = profiled_counts(kernels)
    want = {"stretch_propose": 2 * n_prof, "accept_select": 2 * n_prof,
            "de_propose": 0, "snooker_propose": 0}
    if counts != want:
        raise AssertionError(f"profiled launches {counts}, expected {want} "
                             f"for {n_prof} proposals")
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
