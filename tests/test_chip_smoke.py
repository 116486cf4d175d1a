"""chip_smoke.py's checks on the CPU, and the `gpu`-marked comparisons.

The `gpu` tests decide inside a fixture whether JAX sees a card, and skip
without one; run them on a machine with a GPU as
`NANOCALL_TEST_GPU=1 python -m pytest -m gpu tests/` (see conftest.py).
"""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import oracle  # noqa: E402
from nanocall_tpu import train, transitions  # noqa: E402
from nanocall_tpu.models import load_builtin_models  # noqa: E402
from nanocall_tpu.ops import hmm  # noqa: E402


@pytest.fixture
def gpu():
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("JAX sees no GPU: run with NANOCALL_TEST_GPU=1 on a "
                    "machine with a card")


def _decoded(device, B, T, seed):
    pm = load_builtin_models("r73")["r73.t.006"]
    tp = transitions.TransitionParams()
    gt = hmm.make_grouped_trans(tp, 6)
    model = hmm.make_model_arrays(*pm.state_arrays())
    ev = chip_smoke.walk_batch(pm, B, T, seed)
    out = chip_smoke.decode(gt, model, ev, device)
    M = oracle.dense_logp(transitions.build_structured(tp, 6), 6)
    return pm, ev, out, M


def test_device_check_refuses_cpu():
    """Without a GPU the smoke script stops before any work, naming it."""
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.gpu_info()


def test_compare_paths_near_ties_and_mismatch():
    T = 48
    pm, ev, out, M = _decoded(jax.devices("cpu")[0], 2, T, seed=0)
    paths = chip_smoke.paths_of(out, T)

    def score(p, row):
        return chip_smoke.path_logp(p, pm.state_arrays(), ev["mean"][row],
                                    ev["stdv"][row], M)

    # the path scoring reproduces the decoder's own log-probability
    for row in range(2):
        assert chip_smoke.rel_err(score(paths[row], row),
                                  float(out["logp"][row])) <= 1e-5
    copies = [p.copy() for p in paths]
    assert chip_smoke.compare_paths(paths, copies, score, 1e-5) == 0
    # a different path of the last event: a stay instead of the decoded
    # move (or a step instead of the decoded stay) — always a valid move
    alt = paths[1].copy()
    if alt[-1] != alt[-2]:
        alt[-1] = alt[-2]
    else:
        alt[-1] = ((alt[-2] << 2) & 4095) | ((alt[-2] + 1) & 3)
    assert np.isfinite(score(alt, 1))
    # near-tie: it differs, but scores within tolerance -> counted, accepted
    assert chip_smoke.compare_paths(
        paths, [paths[0], alt], lambda p, row: score(paths[row], row),
        1e-5) == 1
    # a real mismatch: the same path under its true score is rejected
    with pytest.raises(AssertionError, match="row 1: paths differ at 1 "):
        chip_smoke.compare_paths(paths, [paths[0], alt], score, 1e-5)


def test_compare_em_bounds():
    """Round counts must match, the fit agree to EM_RTOL, and each trained
    parameter stay within EM_SPREAD_FACTOR (4) x its one-ulp spread."""
    G = 3
    pm = np.tile(np.array([1.0, 0.5, 0.01, 1.2, 1.0, 1.1]), (G, 1))
    st = np.full((G, 2, 2), [0.1, 0.3])
    fit = np.full(G, -1800.0)
    rounds = np.array([12, 14, 20])
    res = (pm, st, fit, rounds, np.ones(G, bool))
    spread = (np.full(6, 1e-3), np.full(4, 1e-5))
    assert chip_smoke.compare_em(res, res, spread, "same") == 0
    pm2 = pm.copy()
    pm2[1, 1] += 3.9e-3  # within 4 x the 1e-3 spread
    worst = chip_smoke.compare_em((pm2, *res[1:]), res, spread, "within")
    assert 3.8 < worst < 4
    pm2[1, 1] += 0.2e-3  # 4.1e-3: beyond it
    with pytest.raises(AssertionError, match="pm differs"):
        chip_smoke.compare_em((pm2, *res[1:]), res, spread, "beyond")
    with pytest.raises(AssertionError, match="round counts differ"):
        chip_smoke.compare_em((pm, st, fit, rounds + 1, res[4]), res,
                              spread, "rounds")
    with pytest.raises(AssertionError, match="fit differs"):
        chip_smoke.compare_em((pm, st, fit * (1 + 2e-4), rounds, res[4]),
                              res, spread, "fit")


def test_rejection_requires_a_failure():
    """A control must fail its check: rejection() returns the check's
    message, and raises when the control passes."""
    def fails():
        chip_smoke.check(False, "pm differs by up to 16 one-ulp spreads")

    assert chip_smoke.rejection(fails) == (
        "pm differs by up to 16 one-ulp spreads")
    with pytest.raises(AssertionError, match="a control passed"):
        chip_smoke.rejection(lambda: chip_smoke.check(True, "unused"))


@pytest.mark.gpu
def test_gpu_decode_matches_oracle_n4096(gpu):
    T = 128  # the float64 dense oracle takes ~0.25 s per event at n=4096
    pm, ev, out, M = _decoded(gpu, 2, T, seed=2)
    from nanocall_tpu.events import EventSequence

    for row, path in enumerate(chip_smoke.paths_of(out, T)):
        em = oracle.emissions(pm.state_arrays(), EventSequence(
            ev["mean"][row], ev["stdv"][row], np.zeros(T), np.zeros(T)))
        ref, _ = oracle.viterbi(M, em)
        assert np.array_equal(path, ref)


@pytest.mark.gpu
def test_gpu_em_round_matches_cpu(gpu):
    args = chip_smoke.em_inputs(load_builtin_models("r73"), 16, 4, 128,
                                seed=5)
    cfg = train.EMConfig(train_drift=True, K=6)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(gpu):
        res_g = train.run_em(*args, cfg)
    with jax.default_device(cpu):
        res_c = train.run_em(*args, cfg)
    chip_smoke.compare_em(res_g, res_c,
                          chip_smoke.em_ulp_spread(args, cfg, cpu),
                          "EM GPU vs CPU")
