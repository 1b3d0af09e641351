"""K3: the chunk program, recorded once as a CUDA graph and replayed.

The counterpart of ``emcee_tpu/sampler.py:783-925`` (``_get_run_chunk``:
one ``jax.jit`` of a ``lax.scan`` over kept steps and ``thin_by``
proposals, the ``lax.switch`` of the move mixture and ``mixture_block``'s
per-block switch, cached by ``(nkeep, thin_by, store, tune, blobs)``)
together with ``:719-774`` (``_make_step``).  A shuffled move's order,
gathers and scatters (K16 and K17) are recorded with its other kernels,
the radix route's scratch in the graph's own memory pool.  Eager PyTorch enqueues each
kernel from Python, which costs tens of microseconds of host time per
launch against a few on the device; a CUDA graph enqueues a recorded
sequence of them with one call, as the jitted scan does.

A :class:`ChunkProgram` holds one sampler's workspace of persistent
device buffers: the ensemble, its log-prob, its blobs (one buffer per
leaf, allocated once from the initial state's blobs, so recorded graphs
keep their addresses), the ``accepted`` flags of the last proposal, the
per-walker acceptance count, the tuning carries and the int64 proposal
counter (the Philox offset word).  Every proposal
reads and writes only those buffers and draws its random numbers at
``offset word + j``, ``j`` its place in the graph; a graph of ``n``
proposals ends by adding ``n`` to the word.  So the same recording serves
every replay, and the host tracks the same offset as an integer.

A chunk is a host-known sequence of runs of one move (``driver.py``
:func:`~.driver.chunk_replays`: the move choice is host Philox
arithmetic, so no replay waits for the device).  A run of ``n``
proposals replays graphs of :data:`MAX_GRAPH` proposals, then the powers
of two of the rest, so each move needs at most ``log2(MAX_GRAPH) + 1``
recordings per ``tune`` flag.  The cache key is ``(move, proposals,
tune)``: JAX's ``nkeep`` and ``thin_by`` fold into the proposal count,
``store`` adds nothing to the graph (kept rows are copied out after the
replay that ends a kept step), and the blobs' structure is fixed per
program (a state with other blobs gets a new program).  Graphs are
recorded on first use and kept for the life of the program, across
chunks and ``run_mcmc`` calls; a program serves one seed, since the seed
is a kernel argument fixed at recording.

A move whose proposal runs loops of a data-dependent length (the slice
move, ``looped = True``) cannot be one graph: a recorded graph cannot
branch on a device value.  Its proposal is a short host loop of replays
instead (:class:`GraphLoops`): straight-line segments, each a graph of
its own, and loops over lists that only shrink (``compacted``: the slice
move's ends still expanding and walkers not yet landed), whose graph
holds ``loop_block`` trips at one bucket of evaluation rows, replayed
until the lists' lengths, read once per block, are all 0.  Each block
runs at the smallest bucket of a fixed ladder (:func:`buckets`: a floor
and its doublings, up to the lists' capacity) that holds the longest
list when it begins, so a recorded graph serves every block of that
bucket; trips past a list's end change nothing, so the result equals
the eager loop's (:class:`EagerLoops`, the same bucket rule at any block
size) bit for bit.  A loop whose trip count is known on the device
before it starts (ChEES-HMC's leapfrog steps; on a ladder the largest of
the rungs' counts, each rung stepping only while it has trips left)
reads the count once and replays a graph of one iteration that many
times (``repeat``).  Runs of such a move interleave with the other
moves' whole-proposal graphs in the chunk's order.

Before a recording, one proposal of the same move runs eagerly on a
scratch copy of the workspace (the warm-up that creates library handles
and loads kernels), so recording never moves the chain.  If recording
fails, for example because the log-prob synchronizes with the host, the
run raises: it never goes on eagerly.  On the CPU, and on the card when
the sampler's private ``_use_graphs`` switch is off (the eager reference
of the tests and ``chip_smoke.py``), the same per-proposal function runs
eagerly in the same order.

:class:`TemperedProgram` is the chunk program of a tempered ladder
(``parallel/tempering.py``; ``emcee_tpu/parallel/tempering.py:694-903``):
its workspace (:class:`TemperedWorkspace`) holds every rung, ``(T,
nwalkers, ndim)`` coords, ``logL``, ``logP`` and the tempered log-prob,
the ladder's inverse temperatures ``betas`` (a device tensor that the
graphs read, so a new ladder needs no new recording), the swap counts
and the per-rung carries (each carry tensor with a leading ``T`` axis).
A proposal is the move step on every rung, then the even/odd swap (K15),
which reads its parity and whether to swap from the offset word.  The
move step is one rung-batched proposal (K1, K5a or K5b and K2 over all
rungs, the log-prob once over ``T * ng`` rows) for a ``rung_batched``
move (the stretch, DE, DE-snooker and side moves; the walk move through
K8a, K8b and K18a, or K18b, and K2; the MALA, HMC, ensemble MALA and
ensemble HMC moves through K11, K12, K13 and K2, the gradient once over
``T * n`` rows; the KDE move through K7 and K2; DIME through K8a-K8c
and K2; DE-Z through K10a-K10c and K2; the slice move through
K9a-K9d, every rung's lists in one ``(T, bucket, ndim)`` batch; ChEES
through K21a, K11, K13 (its masked rung mode in the loop), K12, K21b
when tuning and K2; the Gaussian move through K19 and K2; the MH move's
function a rung at a time into one buffer, then K2 once; the blend
through its sub-moves' kernels and K20; their shuffled split through
K14, K16 and K17), or else, under the private ``batched=False`` switch
(the reference the batched path is held to), a loop over the rungs, each
rung an ensemble of its own (its views of the buffers, its tempered
model, its carry and its key).  The user blobs of the likelihood ride in
the workspace as ``(T, nwalkers, ...)`` buffers beside ``logL`` and
``logP`` (the tempered model's blobs are ``(logL, logP, user blobs)``):
K2 selects them with the rows and K15 exchanges them with the walkers.
It is recorded, replayed and warmed up as :class:`ChunkProgram` is.  A
looped move (the slice move, ChEES) runs one proposal of every rung
under one :class:`GraphLoops`, one read a block (the slice move's lists'
lengths, ChEES's largest trip count) serving every rung, as one vmapped
JAX ``while_loop`` serves the ladder; under ``batched=False`` each
rung's loops run by the rung's own segment and loop replays
(:class:`GraphLoops` tagged with the rung).  Then one closing segment
tunes every rung, swaps and advances the offset.  Either way a rung's
loops end where its own would (JAX's vmapped ``while_loop`` masks each
finished rung), so each rung's result is its own.
"""

from __future__ import annotations

import gc
from dataclasses import dataclass, fields

import torch

from .model import Model
from .ops import swap_kernel
from .ops.philox import DeviceOffset
from .state import State
from .utils import tree_flatten, tree_map

__all__ = ["BUCKET_FLOOR", "MAX_GRAPH", "ChunkProgram", "EagerLoops",
           "GraphLoops", "TemperedProgram", "TemperedWorkspace", "Workspace",
           "blob_signature", "bucket_of", "buckets", "clone_carry",
           "graph_sizes", "rung_carry"]

#: proposals in the largest graph (a power of two)
MAX_GRAPH = 64
#: the smallest bucket a rung of a compacted loop (:meth:`GraphLoops.
#: compacted`): a trip evaluates this many rows or a power of two times
#: it, or the list's capacity.  On the H100 a trip of the 5-D Gaussian at
#: 1e5 walkers costs about the same at 32 to a few thousand rows
#: (launch-bound); a small floor evaluates fewer padding rows of a costly
#: log-prob (PERF.md)
BUCKET_FLOOR = 32


def buckets(top, floor=BUCKET_FLOOR):
    """The bucket ladder of a list of at most ``top`` entries: ``floor``
    and its doublings below ``top``, then ``top`` (``top`` alone where
    ``floor >= top``)."""
    top, floor = int(top), max(1, int(floor))
    out, b = [], floor
    while b < top:
        out.append(b)
        b *= 2
    return out + [top]


def bucket_of(m, top, floor=BUCKET_FLOOR):
    """The smallest bucket of :func:`buckets` holding ``m`` entries."""
    if not 0 <= m <= top:
        raise ValueError(f"a list of {m} entries in a bucket ladder to {top}")
    return next(b for b in buckets(top, floor) if b >= m)


def _compacted(run, block, length, top, floor, start):
    """The host side of a compacted loop: ``run(bucket, parity)`` runs a
    block of ``block`` trips at ``bucket`` rows, the first trip's list and
    evaluation buffer ``parity``; the first block runs at ``top`` when
    ``start`` (no read), each later one at the bucket of the longest list
    (``length``, a device vector of each rung's, read once a block) until
    every list is empty.  Returns the blocks run."""
    blocks, bucket = 0, int(top)
    go = start
    while go:
        run(bucket, (blocks * block) & 1)
        blocks += 1
        m = max(length.tolist())
        go = m > 0
        if go:
            bucket = bucket_of(m, top, floor)
    return blocks


def graph_sizes(n, cap=MAX_GRAPH):
    """``n`` proposals as graph sizes: ``cap``-sized graphs, then the
    powers of two of the rest, largest first."""
    sizes = [cap] * (n // cap)
    rest = n % cap
    while rest:
        top = 1 << (rest.bit_length() - 1)
        sizes.append(top)
        rest -= top
    return sizes


class EagerLoops:
    """Runs a looped move's segments and loops eagerly: a compacted loop
    reads its lists' lengths (synced to the host) after every ``block``
    trips; ``block=1`` follows the lists trip by trip."""

    def __init__(self, block=1):
        self.block = int(block)

    def segment(self, key, fn):
        fn()

    def compacted(self, key, body, length, top, floor=BUCKET_FLOOR,
                  start=True):
        """A loop over lists that only shrink: ``body(b, block, bucket,
        parity)`` runs trip ``b`` of a block at ``bucket`` evaluation rows
        a rung, reading list and evaluation buffer ``parity``; after each
        block of ``block`` trips the longest of the lists' lengths
        (``length``, a device vector) is read and picks the next block's
        bucket (:func:`bucket_of` up to ``top``), until it reads 0.  The
        first block runs at ``top`` when ``start`` (no read), none
        otherwise."""
        def run(bucket, parity):
            for b in range(self.block):
                body(b, self.block, bucket, (parity + b) & 1)

        _compacted(run, self.block, length, top, floor, start)

    def repeat(self, key, body, count):
        """Run ``body()`` ``count`` times, ``count`` a 0-d integer tensor
        read once (on a ladder the largest of the rungs' counts)."""
        for _ in range(int(count)):
            body()


class GraphLoops:
    """Runs a looped move's proposal as replays of the chunk program's
    graphs (:meth:`ChunkProgram.segment`, recorded on first use): each
    segment one replay, each compacted loop replays of graphs of
    ``block`` trips, each replay followed by a read of the lists' lengths
    (a host sync, counted in ``ChunkProgram.flag_reads``), until they
    read 0."""

    def __init__(self, prog, i, block, tag=()):
        self.prog, self.i, self.block = prog, i, int(block)
        #: keys the graphs apart from another ensemble's of the same move
        #: (a tempered ladder's rung: ``("rung", r)``)
        self.tag = tuple(tag)

    def segment(self, key, fn):
        self.prog.segment((self.i, "segment") + self.tag + key, fn).replay()
        ChunkProgram.replays += 1

    def compacted(self, key, body, length, top, floor=BUCKET_FLOOR,
                  start=True):
        """:meth:`EagerLoops.compacted` by replays: each block a graph of
        ``block`` trips at one bucket and first parity, every bucket's
        trips reading the first rows of the same buffers; each replay is
        followed by one read of the lengths (a flag read).  The graphs of
        every bucket of the ladder (and, for an odd ``block``, both first
        parities) are recorded when the loop first runs, so no later run
        records one."""
        def name(bucket, parity):
            return ((self.i, "compacted", self.block, bucket, parity)
                    + self.tag + key)

        def graph(bucket, parity):
            def trips():
                for b in range(self.block):
                    body(b, self.block, bucket, (parity + b) & 1)

            return self.prog.segment(name(bucket, parity), trips)

        def run(bucket, parity):
            if name(top, 0) not in self.prog.graphs:
                for b in buckets(top, floor):
                    for p in (0,) if self.block % 2 == 0 else (0, 1):
                        graph(b, p)
            graph(bucket, parity).replay()
            ChunkProgram.replays += 1
            ChunkProgram.flag_reads += 1

        _compacted(run, self.block, length, top, floor, start)

    def repeat(self, key, body, count):
        """Replay the graph of ``body()`` ``count`` times: ``count``, a 0-d
        integer tensor (on a ladder the largest of the rungs' counts), is
        read once (one flag read for every rung); the graph is recorded at
        its first replay."""
        n = int(count)
        ChunkProgram.flag_reads += 1
        if n:
            graph = self.prog.segment((self.i, "repeat") + self.tag + key,
                                      body)
        for _ in range(n):
            graph.replay()
            ChunkProgram.replays += 1


def _tune_kw(move, tune):
    """``{"tune": tune}`` for a move whose proposal reads the run's tune
    flag (``wants_tune_flag``, ``emcee_tpu/sampler.py:733-738``), else
    ``{}``."""
    return {"tune": bool(tune)} if move.wants_tune_flag else {}


def clone_carry(carry):
    """A copy of a move's carry (a dict of tensors, or ``()``)."""
    if isinstance(carry, dict):
        return {k: v.clone() for k, v in carry.items()}
    return carry


def rung_carry(carry, r):
    """Rung ``r``'s carry of a ladder's carry (each tensor's row ``r``, a
    view, so the move's in-place updates land in the ladder's carry)."""
    if isinstance(carry, dict):
        return {k: v[r] for k, v in carry.items()}
    return carry


def blob_signature(blobs):
    """The structure, row shapes and dtypes of a blob pytree (None for no
    blobs): what a workspace's blob buffers are allocated for."""
    if blobs is None:
        return None
    leaves, treedef = tree_flatten(blobs)
    return treedef, tuple((tuple(b.shape), b.dtype) for b in leaves)


@dataclass
class Workspace:
    """The persistent device buffers every proposal reads and writes."""

    coords: torch.Tensor  # (nwalkers, ndim)
    log_prob: torch.Tensor  # (nwalkers,)
    accepted: torch.Tensor  # (nwalkers,) bool, the last proposal's
    count: torch.Tensor  # (nwalkers,) int32, accepted proposals
    offset: torch.Tensor  # 0-d int64, the next proposal's Philox offset
    carries: tuple  # one tuning carry per move
    blobs: object = None  # a pytree of (nwalkers, ...) buffers, or None

    def clone(self):
        def copy(name):
            v = getattr(self, name)
            if name == "carries":
                return tuple(clone_carry(c) for c in v)
            if name == "blobs":
                return tree_map(torch.clone, v)
            return v.clone()

        return type(self)(**{f.name: copy(f.name) for f in fields(self)})


class ChunkProgram:
    """The chunk program of one sampler and one seed.

    Args:
        moves: the sampler's moves.
        model: the sampler's :class:`~.model.Model`.
        seed: the Philox seed of the chain.
        coords, log_prob: a state whose shapes, dtype and device the
            workspace takes.
        carries: the moves' tuning carries (copied into the workspace).
        blobs: the state's blobs (their structure, shapes and dtypes), or
            None.
    """

    #: what a recording's proposals are called in its capture message
    kind = "proposals"
    #: graph replays in this process (K3's launch count)
    replays = 0
    #: looped moves' flag reads (host syncs, one a loop-block replay)
    #: in this process
    flag_reads = 0

    def __init__(self, moves, model, seed, coords, log_prob, carries,
                 blobs=None):
        self.moves = moves
        self.model = model
        self.seed = int(seed)
        self.blob_signature = blob_signature(blobs)
        dev = coords.device
        self.ws = Workspace(
            coords=torch.empty_like(coords),
            log_prob=torch.empty_like(log_prob),
            accepted=torch.zeros(coords.shape[0], dtype=torch.bool,
                                 device=dev),
            count=torch.zeros(coords.shape[0], dtype=torch.int32, device=dev),
            offset=torch.zeros((), dtype=torch.int64, device=dev),
            carries=tuple(clone_carry(c) for c in carries),
            blobs=tree_map(lambda b: torch.empty_like(
                b, memory_format=torch.contiguous_format), blobs),
        )
        self.graphs = {}
        self._warmed = set()  # looped moves warmed up before recording
        self._stream = None

    def load(self, coords, log_prob, offset, carries, blobs=None):
        """Start a run: copy the state, its blobs, its offset and the
        carries into the workspace (device copies and fills, no sync)."""
        ws = self.ws
        ws.coords.copy_(coords)
        ws.log_prob.copy_(log_prob)
        for mine, given in zip(tree_flatten(ws.blobs)[0],
                               tree_flatten(blobs)[0]):
            mine.copy_(given)
        ws.offset.fill_(int(offset))
        for mine, given in zip(ws.carries, carries):
            if isinstance(mine, dict) and mine is not given:
                for k, v in mine.items():
                    v.copy_(given[k])

    def proposal(self, ws, i, j, tune):
        """One proposal of move ``i`` at offset ``ws.offset + j``: the work
        a graph records, reading and writing only ``ws``."""
        move = self.moves[i]
        state = State(ws.coords, ws.log_prob, ws.blobs)
        move.propose((self.seed, DeviceOffset(ws.offset, j)), state,
                     self.model, ws.carries[i], ws.count,
                     accepted=ws.accepted, **_tune_kw(move, tune))
        if tune:
            move.tune(ws.carries[i], state, ws.accepted, self.model)

    def program(self, ws, i, n, tune):
        """``n`` proposals of move ``i``, then the offset word advanced."""
        for j in range(n):
            self.proposal(ws, i, j, tune)
        ws.offset.add_(n)

    def run(self, i, n, tune, graphs):
        """Advance the chain by ``n`` proposals of move ``i``: by graph
        replays when ``graphs``, else eagerly."""
        if graphs and self.moves[i].looped:
            for _ in range(n):
                self.looped_proposal(i, tune)
            return
        for size in graph_sizes(n):
            if graphs:
                self.graph(i, size, tune).replay()
                ChunkProgram.replays += 1
            else:
                self.program(self.ws, i, size, tune)

    def looped_proposal(self, i, tune):
        """One proposal of looped move ``i`` by segment and loop replays
        (:class:`GraphLoops`), then the tuning and the offset advance as
        one more segment.  The first one of a move is preceded by an eager
        proposal on a scratch copy (the warm-up)."""
        move = self.moves[i]
        ws = self.ws
        if i not in self._warmed:
            self._warm_up(i, tune)
            self._warmed.add(i)
        loops = GraphLoops(self, i, move.loop_block)
        state = State(ws.coords, ws.log_prob, ws.blobs)
        move.propose((self.seed, DeviceOffset(ws.offset, 0)), state,
                     self.model, ws.carries[i], ws.count,
                     accepted=ws.accepted, loops=loops,
                     **_tune_kw(move, tune))

        def end():
            if tune:
                move.tune(ws.carries[i], state, ws.accepted, self.model)
            ws.offset.add_(1)

        # Keyed apart from the move's own segments (GraphLoops keys them
        # (i, "segment", ...)), so a move may name a segment "end".
        self.segment((i, "tune and advance", bool(tune)), end).replay()
        ChunkProgram.replays += 1

    def graph(self, i, n, tune):
        """The graph of ``n`` proposals of move ``i``, recorded on first
        use (not for a looped move, whose proposal is several graphs)."""
        if self.moves[i].looped:
            raise ValueError(f"{type(self.moves[i]).__name__} runs its "
                             "loops by block replays; it has no "
                             "whole-proposal graph")
        key = (i, n, bool(tune))
        if key not in self.graphs:
            self.graphs[key] = self._record(i, n, tune)
        return self.graphs[key]

    def segment(self, key, fn):
        """The graph of ``fn``, a segment of a looped move's proposal,
        recorded on first use under ``key``."""
        if key not in self.graphs:
            self.graphs[key] = self._capture(
                fn, f"{key[2:]} of {type(self.moves[key[0]]).__name__}")
        return self.graphs[key]

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.ws.coords.device)
        return self._stream

    def _warm_up(self, i, tune):
        """One eager proposal of move ``i`` on a scratch copy, on the
        recording stream: library handles and kernels load before any
        capture, and the chain does not move."""
        side = self._side_stream()
        main = torch.cuda.current_stream(self.ws.coords.device)
        scratch = self.ws.clone()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.program(scratch, i, 1, tune)
        main.wait_stream(side)

    def _record(self, i, n, tune):
        self._warm_up(i, tune)
        return self._capture(
            lambda: self.program(self.ws, i, n, tune),
            f"{n} {self.kind} of {type(self.moves[i]).__name__}")

    def _capture(self, fn, what):
        side = self._side_stream()
        graph = torch.cuda.CUDAGraph()
        # The outer stream context puts the caller's stream back even when
        # a failed capture makes the graph context raise on its way out.
        # The graph context collects garbage before the capture begins;
        # during it the collector is off, so that no finalizer of older
        # garbage (a pinned buffer, another graph) calls into CUDA inside
        # the capture, and the capture is checked for this thread's calls
        # only ("thread_local"), so that no other thread's can void it.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side), torch.cuda.graph(
                    graph, stream=side, capture_error_mode="thread_local"):
                fn()
        except RuntimeError as err:
            # A failed capture raises again on its way out; the first
            # error is the cause.
            cause = err
            while cause.__context__ is not None:
                cause = cause.__context__
            raise RuntimeError(
                f"recording {what} as a CUDA graph failed: "
                f"{str(cause).splitlines()[0]}.  On a CUDA device every "
                "proposal of run_mcmc and sample runs inside a CUDA "
                "graph, so the log-prob function "
                "must not synchronize with the host (no .item(), float(), "
                "bool() or .cpu() of a tensor, no Python branch on a "
                "tensor's value)"
            ) from err
        finally:
            if collecting:
                gc.enable()
        return graph


@dataclass
class TemperedWorkspace(Workspace):
    """The persistent device buffers of a tempered ladder of ``T`` rungs:
    ``coords`` ``(T, nwalkers, ndim)``, ``log_prob`` (the tempered
    ``beta logL + logP``), ``accepted`` and ``count`` ``(T, nwalkers)``,
    and these."""

    log_like: torch.Tensor = None  # (T, nwalkers)
    log_prior: torch.Tensor = None  # (T, nwalkers)
    betas: torch.Tensor = None  # (T,) float32, the ladder
    swaps: torch.Tensor = None  # (max(T - 1, 1),) int64, accepted swaps


class TemperedLogProb:
    """The tempered model's log-prob (``emcee_tpu/parallel/tempering.py:
    379-435``): ``beta logL + logP``, with ``logL`` set to 0 and the
    log-prob to ``-inf`` where ``logP`` is not above ``-inf``; the blobs
    are ``(logL, logP)``, and ``(logL, logP, user blobs)`` where the
    likelihood returns blobs (the prior's are ignored).  ``beta`` is a
    0-d tensor (one rung: ``q`` is ``(n, ndim)``) or the ``(T,)`` ladder
    (every rung: ``q`` is ``(T, n, ndim)``, evaluated as one batch of ``T
    * n`` rows, each blob leaf returned as ``(T, n, ...)``)."""

    def __init__(self, log_like, log_prior, beta):
        self.log_like, self.log_prior, self.beta = log_like, log_prior, beta

    def __call__(self, q):
        beta = self.beta
        if beta.dim():
            lead = q.shape[:-1]
            ll, lpr, ub = self.evaluate(q.reshape(-1, q.shape[-1]))
            ll, lpr = ll.reshape(lead), lpr.reshape(lead)
            ub = tree_map(lambda b: b.reshape(lead + b.shape[1:]), ub)
            beta = beta[:, None]
        else:
            ll, lpr, ub = self.evaluate(q)
        finite = lpr > -torch.inf
        ll = torch.where(finite, ll, 0.0)
        blobs = (ll, lpr) if ub is None else (ll, lpr, ub)
        return swap_kernel.tempered_log_prob(beta, ll, lpr), blobs

    def evaluate(self, q):
        """``(logL, logP, user blobs)`` of rows ``q`` (the user
        functions, wrapped; the blobs None where the likelihood returns
        none)."""
        ll, ub = self.log_like(q)
        lpr, _ = self.log_prior(q)
        return ll, lpr, ub


class TemperedProgram(ChunkProgram):
    """The chunk program of a tempered ladder and one chain seed.

    Args:
        moves: the sampler's moves.
        log_like, log_prior: the wrapped user functions (``q -> (values,
            blobs)``).
        keys: the rungs' :class:`~.ops.philox.RungKeys`.
        coords: a ``(T, nwalkers, ndim)`` state whose shapes, dtype and
            device the workspace takes.
        carries: the moves' ladder carries (copied into the workspace).
        swap_every: proposals between swap attempts (< 1: none).
        batched: propose every rung at once where the move is
            ``rung_batched``; False loops over the rungs for every move.
        blobs: the state's user blobs (``(T, nwalkers, ...)`` leaves), or
            None.
    """

    kind = "tempered proposals"

    def __init__(self, moves, log_like, log_prior, keys, coords, carries,
                 swap_every, batched, blobs=None):
        self.moves = moves
        self.log_like, self.log_prior = log_like, log_prior
        self.keys = keys
        self.seed = keys.seed
        self.swap_every = int(swap_every)
        self.batched = bool(batched)
        self.blob_signature = blob_signature(blobs)
        T, nw, _ = coords.shape
        dev = coords.device

        def rows(dtype=coords.dtype):
            return torch.zeros((T, nw), dtype=dtype, device=dev)

        self.ws = TemperedWorkspace(
            coords=torch.empty_like(coords), log_prob=rows(),
            accepted=rows(torch.bool), count=rows(torch.int32),
            offset=torch.zeros((), dtype=torch.int64, device=dev),
            carries=tuple(clone_carry(c) for c in carries),
            log_like=rows(), log_prior=rows(),
            betas=torch.zeros(T, dtype=coords.dtype, device=dev),
            swaps=torch.zeros(max(T - 1, 1), dtype=torch.int64, device=dev),
            blobs=tree_map(lambda b: torch.empty_like(
                b, memory_format=torch.contiguous_format), blobs),
        )
        self.graphs = {}
        self._warmed = set()
        self._stream = None

    def load(self, coords, log_like, log_prior, betas, offset, carries,
             blobs=None):
        """Start a run: copy the state, its user blobs, the ladder, the
        offset and the carries into the workspace, form the tempered
        log-prob, and zero the run's acceptance and swap counts (device
        work, no sync)."""
        ws = self.ws
        ws.coords.copy_(coords)
        ws.log_like.copy_(log_like)
        ws.log_prior.copy_(log_prior)
        for mine, given in zip(tree_flatten(ws.blobs)[0],
                               tree_flatten(blobs)[0]):
            mine.copy_(given)
        self.set_betas(betas)
        ws.offset.fill_(int(offset))
        ws.count.zero_()
        ws.swaps.zero_()
        for mine, given in zip(ws.carries, carries):
            if isinstance(mine, dict) and mine is not given:
                for k, v in mine.items():
                    v.copy_(given[k])

    def set_betas(self, betas):
        """Put a ladder into the workspace and form the tempered log-prob
        anew from ``logL`` and ``logP`` (device work, no sync; the graphs
        read ``ws.betas``, so nothing is recorded again)."""
        ws = self.ws
        ws.betas.copy_(betas)
        ws.log_prob.copy_(swap_kernel.tempered_log_prob(
            ws.betas[:, None], ws.log_like, ws.log_prior))

    def model(self, ws, r=None):
        """The tempered model of rung ``r`` (every rung for None), reading
        ``ws``'s ladder."""
        T, nw, nd = ws.coords.shape
        beta = ws.betas if r is None else ws.betas[r]
        return Model(TemperedLogProb(self.log_like, self.log_prior, beta),
                     nwalkers=nw, ndim=nd)

    @staticmethod
    def _blobs(ws, r=None):
        """The move-level blobs ``(logL, logP[, user blobs])`` of every
        rung, or rung ``r``'s views of them."""
        blobs = (ws.log_like, ws.log_prior)
        if ws.blobs is not None:
            blobs += (ws.blobs,)
        return blobs if r is None else tree_map(lambda b: b[r], blobs)

    def _rung(self, ws, i, r):
        """Rung ``r``'s state, tempered model and move ``i``'s carry: views
        of ``ws``, so the move's in-place updates land in the ladder."""
        return (State(ws.coords[r], ws.log_prob[r], self._blobs(ws, r)),
                self.model(ws, r), rung_carry(ws.carries[i], r))

    def _swap(self, ws, off):
        """K15 at offset ``off``, the user blob leaves with the walkers."""
        if ws.coords.shape[0] > 1 and self.swap_every >= 1:
            swap_kernel.pt_swap(ws.coords, ws.log_like, ws.log_prior,
                                ws.log_prob, ws.betas, ws.swaps,
                                seed=self.seed, offset=off,
                                swap_every=self.swap_every,
                                leaves=tree_flatten(ws.blobs)[0])

    def proposal(self, ws, i, j, tune):
        """One tempered proposal at offset ``ws.offset + j``: move ``i`` on
        every rung, then the swap, reading and writing only ``ws``."""
        move = self.moves[i]
        off = DeviceOffset(ws.offset, j)
        if self.batched and getattr(move, "rung_batched", False):
            state = State(ws.coords, ws.log_prob, self._blobs(ws))
            model = self.model(ws)
            move.propose_rungs((self.keys, off), state, model,
                               ws.carries[i], ws.count, accepted=ws.accepted,
                               **_tune_kw(move, tune))
            if tune:
                # Every rung's carry at once, each on its own acceptance.
                move.tune(ws.carries[i], state, ws.accepted, model)
        else:
            for r, seed in enumerate(self.keys.seeds):
                state, model, carry = self._rung(ws, i, r)
                move.propose((seed, off), state, model, carry, ws.count[r],
                             accepted=ws.accepted[r], **_tune_kw(move, tune))
                if tune:
                    move.tune(carry, state, ws.accepted[r], model)
        self._swap(ws, off)

    def looped_proposal(self, i, tune):
        """One tempered proposal of looped move ``i`` by replays, then one
        segment that tunes every rung, swaps and advances the offset.  A
        ``rung_batched`` move (the slice move, ChEES) proposes every rung
        at once (:meth:`propose_rungs` under one :class:`GraphLoops`,
        whose reads serve every rung); under the private
        ``batched=False`` switch each rung's segments and loops run by
        themselves (:class:`GraphLoops` tagged with the rung, so each
        rung's loops end on its own flag), ``T`` times the flag reads of
        one ensemble.  The first one of a move is preceded by an eager
        proposal on a scratch copy (the warm-up)."""
        move = self.moves[i]
        ws = self.ws
        if i not in self._warmed:
            self._warm_up(i, tune)
            self._warmed.add(i)
        off = DeviceOffset(ws.offset, 0)
        if self.batched and getattr(move, "rung_batched", False):
            state = State(ws.coords, ws.log_prob, self._blobs(ws))
            model = self.model(ws)
            move.propose_rungs((self.keys, off), state, model,
                               ws.carries[i], ws.count, accepted=ws.accepted,
                               loops=GraphLoops(self, i, move.loop_block),
                               **_tune_kw(move, tune))
            rungs = None
        else:
            rungs = []
            for r, seed in enumerate(self.keys.seeds):
                state, model, carry = self._rung(ws, i, r)
                loops = GraphLoops(self, i, move.loop_block, ("rung", r))
                move.propose((seed, off), state, model, carry, ws.count[r],
                             accepted=ws.accepted[r], loops=loops,
                             **_tune_kw(move, tune))
                rungs.append((state, model, carry))

        def end():
            if tune and rungs is None:
                move.tune(ws.carries[i], state, ws.accepted, model)
            elif tune:
                for r, (state_r, model_r, carry) in enumerate(rungs):
                    move.tune(carry, state_r, ws.accepted[r], model_r)
            self._swap(ws, off)
            ws.offset.add_(1)

        self.segment((i, "tune, swap and advance", bool(tune)), end).replay()
        ChunkProgram.replays += 1
