"""K3: the chunk program, recorded once as a CUDA graph and replayed.

The counterpart of ``emcee_tpu/sampler.py:783-925`` (``_get_run_chunk``:
one ``jax.jit`` of a ``lax.scan`` over kept steps and ``thin_by``
proposals, the ``lax.switch`` of the move mixture and ``mixture_block``'s
per-block switch, cached by ``(nkeep, thin_by, store, tune, blobs)``)
together with ``:719-774`` (``_make_step``).  Eager PyTorch enqueues each
kernel from Python, which costs tens of microseconds of host time per
launch against a few on the device; a CUDA graph enqueues a recorded
sequence of them with one call, as the jitted scan does.

A :class:`ChunkProgram` holds one sampler's workspace of persistent
device buffers: the ensemble, its log-prob, the ``accepted`` flags of the
last proposal, the per-walker acceptance count, the tuning carries and
the int64 proposal counter (the Philox offset word).  Every proposal
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
replay that ends a kept step), and blobs are not ported.  Graphs are
recorded on first use and kept for the life of the program, across
chunks and ``run_mcmc`` calls; a program serves one seed, since the seed
is a kernel argument fixed at recording.

Before a recording, one proposal of the same move runs eagerly on a
scratch copy of the workspace (the warm-up that creates library handles
and loads kernels), so recording never moves the chain.  If recording
fails, for example because the log-prob synchronizes with the host, the
run raises: it never goes on eagerly.  On the CPU, and on the card when
the sampler's private ``_use_graphs`` switch is off (the eager reference
of the tests and ``chip_smoke.py``), the same per-proposal function runs
eagerly in the same order.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from .ops.philox import DeviceOffset
from .state import State

__all__ = ["MAX_GRAPH", "ChunkProgram", "Workspace", "graph_sizes"]

#: proposals in the largest graph (a power of two)
MAX_GRAPH = 64


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


def _clone_carry(carry):
    if isinstance(carry, dict):
        return {k: v.clone() for k, v in carry.items()}
    return carry


@dataclass
class Workspace:
    """The persistent device buffers every proposal reads and writes."""

    coords: torch.Tensor  # (nwalkers, ndim)
    log_prob: torch.Tensor  # (nwalkers,)
    accepted: torch.Tensor  # (nwalkers,) bool, the last proposal's
    count: torch.Tensor  # (nwalkers,) int32, accepted proposals
    offset: torch.Tensor  # 0-d int64, the next proposal's Philox offset
    carries: tuple  # one tuning carry per move

    def clone(self):
        return Workspace(**{
            f.name: (tuple(_clone_carry(c) for c in self.carries)
                     if f.name == "carries" else getattr(self, f.name).clone())
            for f in fields(self)
        })


class ChunkProgram:
    """The chunk program of one sampler and one seed.

    Args:
        moves: the sampler's moves.
        model: the sampler's :class:`~.model.Model`.
        seed: the Philox seed of the chain.
        coords, log_prob: a state whose shapes, dtype and device the
            workspace takes.
        carries: the moves' tuning carries (copied into the workspace).
    """

    #: graph replays in this process (K3's launch count)
    replays = 0

    def __init__(self, moves, model, seed, coords, log_prob, carries):
        self.moves = moves
        self.model = model
        self.seed = int(seed)
        dev = coords.device
        self.ws = Workspace(
            coords=torch.empty_like(coords),
            log_prob=torch.empty_like(log_prob),
            accepted=torch.zeros(coords.shape[0], dtype=torch.bool,
                                 device=dev),
            count=torch.zeros(coords.shape[0], dtype=torch.int32, device=dev),
            offset=torch.zeros((), dtype=torch.int64, device=dev),
            carries=tuple(_clone_carry(c) for c in carries),
        )
        self.graphs = {}
        self._stream = None

    def load(self, coords, log_prob, offset, carries):
        """Start a run: copy the state, its offset and the carries into the
        workspace (device copies and fills, no sync)."""
        ws = self.ws
        ws.coords.copy_(coords)
        ws.log_prob.copy_(log_prob)
        ws.offset.fill_(int(offset))
        for mine, given in zip(ws.carries, carries):
            if isinstance(mine, dict) and mine is not given:
                for k, v in mine.items():
                    v.copy_(given[k])

    def proposal(self, ws, i, j, tune):
        """One proposal of move ``i`` at offset ``ws.offset + j``: the work
        a graph records, reading and writing only ``ws``."""
        move = self.moves[i]
        state = State(ws.coords, ws.log_prob)
        move.propose((self.seed, DeviceOffset(ws.offset, j)), state,
                     self.model, ws.carries[i], ws.count,
                     accepted=ws.accepted)
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
        for size in graph_sizes(n):
            if graphs:
                self.graph(i, size, tune).replay()
                ChunkProgram.replays += 1
            else:
                self.program(self.ws, i, size, tune)

    def graph(self, i, n, tune):
        """The graph of ``n`` proposals of move ``i``, recorded on first
        use."""
        key = (i, n, bool(tune))
        if key not in self.graphs:
            self.graphs[key] = self._record(i, n, tune)
        return self.graphs[key]

    def _record(self, i, n, tune):
        dev = self.ws.coords.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        side = self._stream
        main = torch.cuda.current_stream(dev)
        # Warm-up on a scratch copy, on the recording stream.
        scratch = self.ws.clone()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.program(scratch, i, 1, tune)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # The outer stream context puts the caller's stream back even when
        # a failed capture makes the graph context raise on its way out.
        try:
            with torch.cuda.stream(side), torch.cuda.graph(graph,
                                                           stream=side):
                self.program(self.ws, i, n, tune)
        except RuntimeError as err:
            # A failed capture raises again on its way out; the first
            # error is the cause.
            cause = err
            while cause.__context__ is not None:
                cause = cause.__context__
            raise RuntimeError(
                f"recording {n} proposals of "
                f"{type(self.moves[i]).__name__} as a CUDA graph failed: "
                f"{str(cause).splitlines()[0]}.  On a CUDA device every "
                "proposal of run_mcmc and sample runs inside a CUDA "
                "graph, so the log-prob function "
                "must not synchronize with the host (no .item(), float(), "
                "bool() or .cpu() of a tensor, no Python branch on a "
                "tensor's value)"
            ) from err
        return graph
