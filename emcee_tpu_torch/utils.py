"""Helpers of the port's run loop.

The counterpart of ``emcee_tpu/utils.py:27-69`` (``defer_interrupts``).
The walker-initialisation helpers and ``find_map`` of that module are not
ported yet (ROADMAP P12).
"""

from __future__ import annotations

import contextlib
import signal
import threading

__all__ = ["defer_interrupts"]


@contextlib.contextmanager
def defer_interrupts():
    """Hold SIGINT while a chunk is written to the backend and the resume
    anchors move to it, so that a Ctrl-C never lands between the two
    (which would leave the backend one chunk ahead of the anchors, and
    ``run_mcmc(None, n)`` would store that chunk twice).

    A held interrupt is delivered again through the restored handler
    when the block ends cleanly (``signal.raise_signal``), so a process
    that ignores SIGINT or installed its own handler keeps its
    behaviour.  If the block itself raised, the held interrupt is
    dropped so it cannot mask that exception.  Off the main thread
    (signal handlers are the main thread's) and under a handler not
    installed from Python, the block runs undeferred.
    """
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    prev = signal.getsignal(signal.SIGINT)
    if prev is None:  # a handler not installed from Python
        yield
        return
    held = []
    try:
        signal.signal(signal.SIGINT, lambda sig, frame: held.append(sig))
    except ValueError:  # an embedding that refuses the handler
        yield
        return
    body_raised = False
    try:
        yield
    except BaseException:
        body_raised = True
        raise
    finally:
        signal.signal(signal.SIGINT, prev)
        if held and not body_raised:
            signal.raise_signal(signal.SIGINT)
