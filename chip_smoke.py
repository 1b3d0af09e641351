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
   with the in-kernel Philox stream, in both pair modes, and one whole
   proposal of the kernel path against the plain path;
3. runs the main path (1e5 walkers, 5-D unit Gaussian, blocked/roll
   stretch move) with ``store=False`` and checks that every proposal went
   through K1 and K2;
4. stores 100 kept steps at ``thin_by=20`` into the host ``Backend`` and
   into ``DeviceBackend`` (each beside the same proposals unstored) and
   estimates tau, walker-steps/s and ESS/s; then profiles a window of the
   main path (device time by kernel, device idle share);
5. runs the reference defaults (``StretchMove()``) at full width;
7. holds K5a (DE proposal) and K5b (DE-snooker proposal) against their
   plain versions at workload 3's shapes (ng = 5000, ndim = 100), both
   pair modes, snooker with nsplits 2 and 4, injected draws and the
   in-kernel Philox stream; K2 at ndim = 100; and one whole proposal of
   each move on the kernel path against the plain path;
8. runs workload 3 (``benchmarks/workload3.py:57-77``: 1e4 walkers, 100-D
   correlated Gaussian, DE 0.8 + snooker 0.2, roll, blocked) with
   ``store=False``, with ``mixture_block=4``, and stored into
   ``DeviceBackend`` (256 kept x ``thin_by=16``) for tau and ESS/s, and
   checks that every proposal went through K5a or K5b and then K2; then
   profiles a window of it;
6. times each kernel and its plain version alone with CUDA events (K2
   also at ndim = 100), and both paths on the plain versions for
   reference.

Phases run in the order 0-5, 7, 8, 6.  Every phase raises on failure.
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
# K5b sums a row in another order than torch.sum: q to rounding of the
# sums, the factor ((ndim - 1) = 99 times a log difference) to 1e-4.
SN_RTOL = SN_ATOL = 1e-5
SN_F_ATOL = 1e-4
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


def acceptance_flips(torch, log_u, lnp_k, lnp_p):
    """Walkers whose acceptance differs between two lnpdiff vectors; each
    must lie within the two's largest disagreement of the threshold.
    Returns ``(flips, margin)``."""
    margin = float((lnp_k - lnp_p).abs().max())
    flips = (log_u < lnp_k) != (log_u < lnp_p)
    if bool(((lnp_p - log_u).abs()[flips] > margin).any()):
        raise AssertionError("acceptance differs away from the threshold")
    return int(flips.sum()), margin


def phase7(torch, dev, errs, nw=NW3, nd=ND3):
    """K5a, K5b and K2 at workload 3's shapes against their plain
    versions, then one whole proposal of each move."""
    from emcee_tpu_torch import State, moves
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
                qp, fp = dk.de_propose_plain(*args, **kw)
                errs["de_propose"] = max(errs["de_propose"], max_err(q, qp),
                                         max_err(f, fp))
        log(f"phase 7: K5a {pair_mode}: q max abs err "
            f"{errs['de_propose']:.3g} (tolerance {RTOL:g})")

    gauss = wrap_log_prob_fn(gaussian, vectorize=True)
    n_flip_all = 0
    for pair_mode, nsplits in (("roll", 2), ("roll", 4), ("random", 4)):
        ngs = ng  # 5000 walkers per split: 2e4 walkers with nsplits=4
        c = coords if nsplits == 2 else torch.randn(
            ngs * nsplits, nd, device=dev, generator=gen)
        lp = gaussian(c)
        for split in range(nsplits):
            if pair_mode == "roll":
                inj = dict(u4=torch.rand(4, device=dev, generator=gen))
            else:
                inj = dict(
                    idx=torch.randint(0, ngs, (3, ngs), device=dev,
                                      generator=gen, dtype=torch.int32),
                    perm=torch.randint(0, 6, (ngs,), device=dev,
                                       generator=gen, dtype=torch.int32))
            log_u = torch.log(torch.rand(ngs, device=dev, generator=gen))
            lp_s = lp[split * ngs:(split + 1) * ngs]
            for kw in (dict(**inj), dict(scale=scale, **inj),
                       dict(seed=seed, offset=offset)):
                args = (c, split, nsplits)
                kw = dict(gammas=1.7, ndim_global=nd, pair_mode=pair_mode,
                          **kw)
                q, f = snk.snooker_propose(*args, **kw)
                qp, fp = snk.snooker_propose_plain(*args, **kw)
                e = max(max_err(q, qp, SN_RTOL, SN_ATOL),
                        max_err(f, fp, 0.0, SN_F_ATOL))
                errs["snooker_propose"] = max(errs["snooker_propose"], e)
                n_flip, margin = acceptance_flips(
                    torch, log_u, f + gauss(q)[0] - lp_s,
                    fp + gauss(qp)[0] - lp_s)
                n_flip_all += n_flip
        log(f"phase 7: K5b {pair_mode} nsplits={nsplits}: q/factor max abs "
            f"err {errs['snooker_propose']:.3g} (tolerance {SN_ATOL:g} / "
            f"{SN_F_ATOL:g}); acceptance flips so far {n_flip_all}, each "
            f"within the lnpdiff disagreement (last {margin:.3g})")

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
    log(f"phase 7: K2 at ndim {nd}: identical "
        f"({int(outs[0][2][:ng].sum())} of {ng} accepted)")

    # One whole proposal of each move, kernel path against plain path.
    model = Model(gauss, nw, nd)
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
        n_flip = int((acc_k != acc_p).sum())
        if isinstance(mv, moves.DEMove):
            if n_flip:
                raise AssertionError(f"{name}: acceptance differs")
            e = max(max_err(st_k.coords, st_p.coords),
                    max_err(st_k.log_prob, st_p.log_prob))
            note = "acceptance identical"
        else:
            # A flipped walker changes its own row and, in later splits,
            # at most the few walkers that pick it.
            tol = SN_ATOL + SN_RTOL * st_p.coords.abs()
            bad = int(((st_k.coords - st_p.coords).abs() > tol).any(1).sum())
            if n_flip > max(2, nw // 1000) or bad > 8 * n_flip:
                raise AssertionError(f"{name}: {n_flip} acceptance flips, "
                                     f"{bad} rows differ")
            ok = ((st_k.coords - st_p.coords).abs() <= tol).all(1)
            e = float((st_k.coords - st_p.coords).abs()[ok].max())
            note = f"{n_flip} acceptance flips, {bad} rows beyond tolerance"
        log(f"phase 7: whole proposal {name}: {note} (acceptance "
            f"{float(acc_k.float().mean()):.3f}), coords max abs err {e:.3g}")


def phase8(torch, np, dev, card, nw=NW3, nd=ND3, n_timed=2000,
           profile=True):
    """Workload 3 through the port's entry points.  Returns a dict of its
    numbers and the launch counts of the timed ``store=False`` run."""
    from emcee_tpu_torch import EnsembleSampler, moves
    from emcee_tpu_torch.autocorr import integrated_time
    from emcee_tpu_torch.backends import DeviceBackend

    log_prob, p0 = workload3_target(np, torch, dev, nw, nd)
    mix = workload3_moves(moves)
    out = {}

    def run3(smp, state, n, **kw):
        """run_mcmc with the counts set to 0 just before and read just
        after: every proposal ran K5a or K5b twice, then K2 twice."""
        for _, fn in wrappers().values():
            fn.launches = 0
        t0 = time.perf_counter()
        st = smp.run_mcmc(state, n, **kw)
        dt = time.perf_counter() - t0
        c = launch_counts()
        n_prop = n * kw.get("thin_by", 1)
        if (c["de_propose"] + c["snooker_propose"] != 2 * n_prop
                or c["accept_select"] != 2 * n_prop
                or c["stretch_propose"] != 0):
            raise AssertionError(f"workload 3: launches {c} for {n_prop} "
                                 "proposals")
        return st, dt, c

    def check(st, label, dt, n_prop, c):
        mean_lp = float(st.log_prob.mean())
        if not -0.8 * nd < mean_lp < -0.2 * nd:  # workload3.py:201
            raise AssertionError(f"{label}: mean log-prob {mean_lp}")
        ws = n_prop * nw / dt
        share = c["de_propose"] / (2 * n_prop)
        log(f"phase 8: {label}: {n_prop} proposals x {nw} walkers in "
            f"{dt:.3f} s: {ws:.4e} walker-steps/s {card}; mean lp "
            f"{mean_lp:.3f}; DE / snooker share of proposals {share:.4f} / "
            f"{1 - share:.4f}; launches {c}")
        return ws

    smp = EnsembleSampler(nw, nd, log_prob, vectorize=True, seed=0,
                          moves=mix, device=dev)
    st, _, _ = run3(smp, p0, 200, store=False, skip_initial_state_check=True)
    st, dt, c = run3(smp, None, n_timed, store=False)
    out["acceptance"] = float(smp.last_run_stats.acceptance_fraction.mean())
    out["ws"] = check(st, "store=False", dt, n_timed, c)
    out["launches"] = c
    log(f"phase 8: store=False acceptance {out['acceptance']:.4f}")

    # mixture_block=4 against 1 in turns (1, 4, 4, 1): host time spreads
    # between and within calls, so the two compare only side by side.
    smp_b = EnsembleSampler(nw, nd, log_prob, vectorize=True, seed=3,
                            moves=mix, mixture_block=4, device=dev)
    st_b, dt, c = run3(smp_b, st, n_timed, store=False,
                       skip_initial_state_check=True)
    ws_b = [check(st_b, "mixture_block=4", dt, n_timed, c)]
    st_b, dt, c = run3(smp_b, None, n_timed, store=False)
    ws_b.append(check(st_b, "mixture_block=4, again", dt, n_timed, c))
    st, dt, c = run3(smp, None, n_timed, store=False)
    ws_1 = [out["ws"], check(st, "store=False, again", dt, n_timed, c)]
    out["ws_pairs"] = (ws_1, ws_b)
    log(f"phase 8: mixture_block=4 / 1, in turns: "
        f"{(ws_b[0] + ws_b[1]) / (ws_1[0] + ws_1[1]):.4f}")

    kept, thin_by = 256, 16  # workload3.py:53-54
    smp_d = EnsembleSampler(nw, nd, log_prob, vectorize=True, seed=4,
                            moves=mix, backend=DeviceBackend(),
                            device=dev)
    st, dt, c = run3(smp_d, st, kept, thin_by=thin_by,
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
    out["ws_stored"] = check(st, "DeviceBackend stored", dt, span, c)
    out["tau"] = tau
    out["ess"] = out["ws_stored"] / tau
    log(f"phase 8: DeviceBackend {kept} kept x thin_by {thin_by}: tau "
        f"{tau:.2f} proposals (max over a [:, :512, :16] subset), ESS/s "
        f"{out['ess']:.4e} {card}; span {span} >= 30 tau: "
        f"{span >= 30 * tau}")
    del chain, smp_d

    out["dev_ms"] = {}
    out["state"] = st
    out["sampler"] = smp
    if not profile:
        return out
    n_prof = 200
    wall, kernels = profile_window(
        torch, lambda: run3(smp, None, n_prof, store=False))
    if kernels:
        busy = sum(us for _, us in kernels.values()) * 1e-6
        out["idle"] = 1 - busy / wall
        for kname in ("de_propose", "snooker_propose", "accept_select"):
            out["dev_ms"][kname] = device_ms(kernels, kname)
        log(f"phase 8: profiled {n_prof} proposals: wall {wall:.4f} s, "
            f"device busy {busy:.4f} s, idle share {out['idle']:.4f} {card}")
        for key, (cnt, us) in sorted(kernels.items(),
                                     key=lambda kv: -kv[1][1])[:10]:
            log(f"  {us / cnt:9.2f} us x {cnt:6d}  {key[:90]}")
    else:
        log("phase 8: the profiler saw no device time; device time and "
            "idle share not measured")
    return out



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
                    errs["accept_select"] = max(
                        errs["accept_select"],
                        *(float((a - b).abs().max())
                          for a, b in zip(outs[0][:2], outs[1][:2])))
        log(f"phase 2: K1/K2 {pair_mode}: partners identical; q/factor "
            f"max abs err {errs['stretch_propose']:.3g}; K2 identical")

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
    torch.cuda.synchronize()

    # -- 3. main path, store=False -----------------------------------------
    for _, fn in wrappers().values():
        fn.launches = 0
    mv = moves.StretchMove(randomize_split=False, pair_mode="roll")
    sampler = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=0,
                              moves=mv)
    p0 = np.random.default_rng(1).normal(size=(NW, ND)).astype(np.float32)

    def launches():
        return sk.stretch_propose.launches, ak.accept_select.launches

    def run_checked(smp, state, n, **kw):
        before = launches()
        out = smp.run_mcmc(state, n, **kw)
        n_prop = n * kw.get("thin_by", 1)
        rose = tuple(b - a for a, b in zip(before, launches()))
        if rose != (2 * n_prop, 2 * n_prop):
            raise AssertionError(f"launches rose by {rose}, expected "
                                 f"{2 * n_prop} each")
        return out

    st = run_checked(sampler, p0, 500, store=False,
                     skip_initial_state_check=True)
    n_main = 4000
    t0 = time.perf_counter()
    st = run_checked(sampler, None, n_main, store=False)
    dt = time.perf_counter() - t0
    mean_lp = float(st.log_prob.mean())
    acc = sampler.last_run_stats.acceptance_fraction.mean()
    if not -0.7 * ND < mean_lp < -0.3 * ND:
        raise AssertionError(f"mean log-prob {mean_lp} outside the window")
    if not 0.2 < acc < 0.8:
        raise AssertionError(f"acceptance fraction {acc}")
    ws = n_main * NW / dt
    log(f"phase 3: store=False {n_main} proposals x {NW} walkers in "
        f"{dt:.3f} s: {ws:.4e} walker-steps/s {card}; mean lp "
        f"{mean_lp:.4f}, acceptance {acc:.4f}")
    # -- 4. storage --------------------------------------------------------
    thin_by, kept = 20, 100
    stored = {}
    for label, backend in (("Backend", None), ("DeviceBackend",
                                               DeviceBackend())):
        smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=1,
                              moves=mv, backend=backend)
        st = run_checked(smp, st, kept, thin_by=thin_by,
                         skip_initial_state_check=True)
        smp.reset()
        # The same proposals unstored, just before, for the cost of storing.
        t0 = time.perf_counter()
        st = run_checked(smp, st, kept * thin_by, store=False,
                         skip_initial_state_check=True)
        dt_free = time.perf_counter() - t0
        t0 = time.perf_counter()
        st = run_checked(smp, st, kept, thin_by=thin_by,
                         skip_initial_state_check=True)  # as bench.py:203
        dt_store = time.perf_counter() - t0
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
    t0 = time.perf_counter()
    run_checked(sampler, None, kept * thin_by, store=False)
    log(f"phase 4: the phase-3 sampler re-timed, unstored: "
        f"{kept * thin_by * NW / (time.perf_counter() - t0):.4e} "
        f"walker-steps/s {card}")

    # Where the time goes: device time by kernel over a profiled window
    # of the main path, and the device's idle share.  It comes after every
    # timed run, so that no timed run follows the profiler.
    n_prof = 200
    wall, kernels = profile_window(
        torch, lambda: run_checked(sampler, None, n_prof, store=False))
    busy = sum(us for _, us in kernels.values()) * 1e-6
    dev_ms = {k: device_ms(kernels, k)
              for k in ("stretch_propose", "accept_select")}
    if kernels:
        log(f"phase 4: profiled {n_prof} proposals: wall {wall:.4f} s, "
            f"device busy {busy:.4f} s, idle share {1 - busy / wall:.4f} "
            f"{card}")
        for key, (c, us) in sorted(kernels.items(),
                                   key=lambda kv: -kv[1][1])[:8]:
            log(f"  {us / c:9.2f} us x {c:6d}  {key[:90]}")
    else:
        log("phase 4: the profiler saw no device time; device time and "
            "idle share not measured")
    main_launches = launches()

    # -- 5. reference defaults at full width -------------------------------
    smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=2)
    out = run_checked(smp, st, 20, store=False)
    acc5 = smp.last_run_stats.acceptance_fraction.mean()
    if not (torch.isfinite(out.coords).all() and 0.2 < acc5 < 0.8):
        raise AssertionError(f"defaults run: acceptance {acc5}")
    log(f"phase 5: StretchMove() defaults, 20 proposals: acceptance "
        f"{acc5:.4f}")

    # -- 7. K5a / K5b against their plain versions ---------------------------
    errs.update(de_propose=0.0, snooker_propose=0.0)
    phase7(torch, dev, errs)
    torch.cuda.synchronize()

    # -- 8. workload 3 -------------------------------------------------------
    # Float32 matmuls in full float32 on the card (the log-prob's x @ W).
    torch.backends.cuda.matmul.allow_tf32 = False
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

    # K1 and K2 launches are the main path's (phases 3-4); K5a and K5b
    # launches are workload 3's timed store=False run (phase 8).
    launches_of = {"stretch_propose": main_launches[0],
                   "accept_select": main_launches[1],
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
            "library_ms": None,
        }
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
                bound_ms_nd100=b_ms, bound_by_nd100=b_by)
            log(f"phase 6: accept_select at ndim {ND3}: device "
                f"{ms * 1e3:.2f} us/launch, {call_ms * 1e3:.2f} us per "
                f"back-to-back call, plain {plain_ms * 1e3:.2f} us, bound "
                f"{b_ms * 1e3:.3f} us ({nbytes} bytes, {b_by}) {card}")
        rows.append(row)

    # The main path on the plain versions, for reference only.
    smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=0, moves=mv)
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
    with plain_kernels():
        smp.run_mcmc(w3["state"], 5, store=False,
                     skip_initial_state_check=True)
        n_plain3 = 40
        t0 = time.perf_counter()
        smp.run_mcmc(None, n_plain3, store=False)
        dt_plain3 = time.perf_counter() - t0
    log(f"phase 6: plain-version workload 3 (reference only): "
        f"{n_plain3 * NW3 / dt_plain3:.4e} walker-steps/s {card}")

    log(f"summary: main path {ws:.4e} walker-steps/s; stored "
        f"{stored['Backend'][0]:.4e} (Backend) / "
        f"{stored['DeviceBackend'][0]:.4e} (DeviceBackend) walker-steps/s; "
        f"ESS/s {stored['Backend'][1]:.4e} / {stored['DeviceBackend'][1]:.4e} "
        f"{card}; package {emcee_tpu_torch.__name__}")
    (w1a, w1b), (w4a, w4b) = w3["ws_pairs"]
    log(f"summary: workload 3 {w1a:.4e} / {w1b:.4e} walker-steps/s "
        f"(mixture_block=4: {w4a:.4e} / {w4b:.4e}; DeviceBackend stored "
        f"{w3['ws_stored']:.4e}), tau {w3['tau']:.2f} proposals, ESS/s "
        f"{w3['ess']:.4e}, idle share "
        f"{w3.get('idle', float('nan')):.4f} {card}")
    log(f"nvidia-smi: {smi}")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
