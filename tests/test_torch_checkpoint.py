"""``checkpoint.save_state`` / ``load_state`` of the port.

The counterpart of ``emcee_tpu/checkpoint.py`` (Orbax there, one
``torch.save`` file here): a round trip keeps every tensor, blob leaf and
the Philox ``(seed, offset)`` exactly, and a run resumed from a
checkpoint is bit-identical to the uninterrupted run (the moves here are
untuned, so the state is all there is to resume, as in the JAX
package's pattern).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from emcee_tpu_torch import EnsembleSampler, State, checkpoint, moves

NW, ND = 16, 3


def lp(x):
    return (-0.5 * (x**2).sum(-1),
            {"m": x.mean(-1), "n": (x > 0).sum(-1).int(),
             "w": (x**2).double()})


def make(seed=3, **kw):
    return EnsembleSampler(NW, ND, lp, vectorize=True, seed=seed,
                           device="cpu", **kw)


def p0():
    return np.random.default_rng(0).normal(size=(NW, ND))


def test_round_trip_keeps_every_tensor(tmp_path):
    path = tmp_path / "state.pt"
    st = make().run_mcmc(p0(), 5, store=False)
    checkpoint.save_state(str(path), st)
    back = checkpoint.load_state(str(path), device="cpu")
    assert isinstance(back, State)
    assert torch.equal(back.coords, st.coords)
    assert torch.equal(back.log_prob, st.log_prob)
    assert back.random_state == st.random_state == (3, 5)
    assert set(back.blobs) == {"m", "n", "w"}
    for k in back.blobs:
        assert back.blobs[k].dtype == st.blobs[k].dtype
        assert torch.equal(back.blobs[k], st.blobs[k])
    like = checkpoint.load_state(str(path), like=st)
    assert like.coords.device == st.coords.device


def test_resumed_run_is_bit_identical(tmp_path):
    """Save after 6 proposals, load in a fresh sampler, run 8 more:
    chain, log-prob, blobs, acceptance and random state equal the 14-step
    run's last 8 steps."""
    path = str(tmp_path / "mid.pt")
    full = make(moves=moves.StretchMove())
    full.run_mcmc(p0(), 14, thin_by=1)
    first = make(moves=moves.StretchMove())
    st = first.run_mcmc(p0(), 6)
    checkpoint.save_state(path, st)
    second = make(seed=99, moves=moves.StretchMove())
    end = second.run_mcmc(checkpoint.load_state(path, device="cpu"), 8)
    np.testing.assert_array_equal(second.get_chain(), full.get_chain()[6:])
    np.testing.assert_array_equal(second.get_log_prob(),
                                  full.get_log_prob()[6:])
    for k in ("m", "n", "w"):
        np.testing.assert_array_equal(second.get_blobs()[k],
                                      full.get_blobs()[k][6:])
    np.testing.assert_array_equal(
        first.backend.accepted + second.backend.accepted,
        full.backend.accepted)
    assert end.random_state == full.random_state == (3, 14)


def test_numpy_state_and_overwrite(tmp_path):
    path = str(tmp_path / "np.pt")
    st = State(np.zeros((NW, ND), np.float32), np.ones(NW), None, None)
    checkpoint.save_state(path, st)
    back = checkpoint.load_state(path, device="cpu")
    assert back.blobs is None and back.random_state is None
    assert back.log_prob.dtype == torch.float64
    with pytest.raises(FileExistsError):
        checkpoint.save_state(path, st, force=False)
    checkpoint.save_state(path, st._replace(coords=np.ones((NW, ND))))
    assert float(checkpoint.load_state(path, device="cpu").coords[0, 0]) == 1


def test_load_refuses_anything_but_tensors(tmp_path):
    """``weights_only=True``: a file holding another object is refused,
    not unpickled."""
    path = str(tmp_path / "evil.pt")
    torch.save({"coords": torch.zeros(2), "log_prob": None, "blobs": None,
                "random_state": None, "x": object()}, path)
    with pytest.raises(Exception, match="[Ww]eights only"):
        checkpoint.load_state(path, device="cpu")


def test_load_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU contract is not testable")
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint.load_state("unused.pt")
