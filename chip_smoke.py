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
6. times each kernel and its plain version alone with CUDA events, and
   the whole main path on the plain versions for reference.

Every phase raises on failure.  The line before the last is the kernel
table as JSON; the last line is ``{"ok": true, "device": {...}}``.  It
exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import logging
import subprocess
import sys
import time

NW, ND = 100_000, 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
RTOL = ATOL = 1e-6


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


def max_err(got, want):
    """Max abs error, raising unless |got - want| <= ATOL + RTOL |want|."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    if not bool((diff <= ATOL + RTOL * want.abs()).all()):
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


@contextlib.contextmanager
def plain_kernels(sk, ak):
    """Route the moves through the kernels' plain versions (the moves
    look the wrappers up on their modules at each call)."""
    saved = sk.stretch_propose, ak.accept_select
    sk.stretch_propose, ak.accept_select = (
        sk.stretch_propose_plain, ak.accept_select_plain)
    try:
        yield
    finally:
        sk.stretch_propose, ak.accept_select = saved


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
        with plain_kernels(sk, ak):
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
    sk.stretch_propose.launches = 0
    ak.accept_select.launches = 0
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
    dev_ms = {}
    for kname in ("stretch_propose", "accept_select"):
        hits = [(c, us) for key, (c, us) in kernels.items()
                if f"{kname}_kernel" in key]
        if hits:
            dev_ms[kname] = sum(us for _, us in hits) / sum(
                c for c, _ in hits) * 1e-3
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
    times = {
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
    philox_ops = 10 * 10  # ten rounds of ~10 32-bit operations
    bounds = {
        "stretch_propose": (
            4 * (NW * ND + ng * ND + ng),
            ng * (philox_ops + 25 + 3 * ND) + philox_ops),
        "accept_select": (
            4 * ng * 3 + ng + n_acc * (4 * ND + 4 * (ND + 1) + 8),
            ng * (philox_ops + 6)),
    }
    meta = {
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
        "walkers its timed inputs accept")
    rows = []
    for i, kname in enumerate(("stretch_propose", "accept_select")):
        nbytes, nops = bounds[kname]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_OPS_PER_S * 1e3
        call_ms, plain_ms = times[kname]
        ms = dev_ms.get(kname, call_ms)
        rows.append({
            "name": kname, "route": "cuda", "source": meta[kname][0],
            "replaces": meta[kname][1], "launches": main_launches[i],
            "max_abs_err": errs[kname], "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        log(f"phase 6: {kname}: device {ms * 1e3:.2f} us/launch, "
            f"{call_ms * 1e3:.2f} us per back-to-back call, plain "
            f"{plain_ms * 1e3:.2f} us, bound {max(t_bytes, t_ops) * 1e3:.3f} "
            f"us ({nbytes} bytes) {card}")

    # The main path on the plain versions, for reference only.
    smp = EnsembleSampler(NW, ND, gaussian, vectorize=True, seed=0, moves=mv)
    with plain_kernels(sk, ak):
        smp.run_mcmc(p0, 20, store=False, skip_initial_state_check=True)
        n_plain = 200
        t0 = time.perf_counter()
        smp.run_mcmc(None, n_plain, store=False)
        dt_plain = time.perf_counter() - t0
    log(f"phase 6: plain-version main path (reference only): "
        f"{n_plain * NW / dt_plain:.4e} walker-steps/s {card}")

    log(f"summary: main path {ws:.4e} walker-steps/s; stored "
        f"{stored['Backend'][0]:.4e} (Backend) / "
        f"{stored['DeviceBackend'][0]:.4e} (DeviceBackend) walker-steps/s; "
        f"ESS/s {stored['Backend'][1]:.4e} / {stored['DeviceBackend'][1]:.4e} "
        f"{card}; package {emcee_tpu_torch.__name__}")
    log(f"nvidia-smi: {smi}")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
