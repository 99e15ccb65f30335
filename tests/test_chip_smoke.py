"""chip_smoke.py's phases at a tiny size on the CPU: the same entry points and oracle
checks the card runs at 2^20 x 128, so a wrong path or argument shows up here first."""

import functools

import numpy as np
from jax.experimental import pallas as pl

import chip_smoke as cs


def test_chip_smoke_phases_tiny(monkeypatch, eight_devices):
    # the Pallas-Triton phase 1 runs in the interpreter here
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    X, Q = cs.make_data(0, 2 * 4096, 128, 16)
    oracles = {m: cs.Oracle(X, Q, m) for m in ("l2", "cosine")}
    qp_a, _, id2row, live, dead = cs.phase_a(X, Q, oracles, ks=(10,))
    qp_b = cs.phase_b(X, Q, oracles, dead, ks=(10, 100))
    t = cs.phase1_timings(qp_b, Q, ks=(10,), reps=1)
    assert set(t) == {(light, 10, impl) for light in (True, False) for impl in ("xla", "triton")}
    cs.phase_c(qp_a, Q, oracles["l2"], id2row, live, n_clients=8)
    recall = cs.phase_d(qp_a, Q, oracles["l2"], id2row, live, n_clusters=16, nprobe=4)
    assert 0.0 < recall <= 1.0
    if cs.rest_available():
        cs.phase_e(qp_a, X, Q, oracles["l2"], id2row, live, n_rest=200)
    assert np.isfinite(oracles["l2"].d).all()
    # the --four-cards path on four of the simulated CPU devices
    X4, _ = cs.make_data(1, 4 * 2 * 4096, 128, 16)
    cs.four_cards(X4, Q, {m: cs.Oracle(X4, Q, m) for m in ("l2", "cosine")}, ks=(10,))
