import os

# Tests must see the host as-is (1 CPU device) — only dryrun.py forces 512.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

# Modules whose tests form the ~2min pre-commit smoke tier (run with
# ``-m quick``); anything marked ``slow`` is excluded even within these.
QUICK_MODULES = {
    "test_wfa_core",
    "test_engine",
    "test_session",
    "test_cigar_pipeline",
    "test_scoring_models",
    "test_mapping",
    "test_serving",
    "test_wfa_property",
    "test_biwfa",
    "test_analysis",
    "test_fault_dist",
    "test_obs",
    "test_obs_analyze",
}


@pytest.fixture(autouse=True, scope="session")
def _flightrec_tmpdir(tmp_path_factory):
    """Route flight-recorder post-mortems to a tmp dir for the whole run.

    Session/serve failure tests trip the dump hooks on purpose; without
    this they would scatter ``results/flightrec/*.json`` into the repo.
    """
    d = tmp_path_factory.mktemp("flightrec")
    prev = os.environ.get("REPRO_FLIGHTREC_DIR")
    os.environ["REPRO_FLIGHTREC_DIR"] = str(d)
    yield
    if prev is None:
        os.environ.pop("REPRO_FLIGHTREC_DIR", None)
    else:
        os.environ["REPRO_FLIGHTREC_DIR"] = prev


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_pairs(rng, n, lo=5, hi=200, drift=4):
    """n read pairs whose mate drifts by < ``drift`` edits (shared helper)."""
    pats, txts = [], []
    for _ in range(n):
        L = int(rng.integers(lo, hi))
        p = "".join(rng.choice(list("ACGT"), size=L))
        t = list(p)
        for _ in range(int(rng.integers(0, drift))):
            pos = int(rng.integers(0, max(1, len(t))))
            r = rng.random()
            if r < 0.5 and t:
                t[pos] = rng.choice(list("ACGT"))
            elif r < 0.8:
                t.insert(pos, rng.choice(list("ACGT")))
            elif t:
                del t[pos]
        pats.append(p)
        txts.append("".join(t))
    return pats, txts


def gotoh_oracle(pats, txts, pen=None):
    """Exact dense-DP scores for string pairs (the correctness contract)."""
    from repro.core.gotoh import gotoh_score_vec
    from repro.core.penalties import DEFAULT
    return np.asarray([
        gotoh_score_vec(np.frombuffer(p.encode(), np.uint8),
                        np.frombuffer(t.encode(), np.uint8), pen or DEFAULT)
        for p, t in zip(pats, txts)], np.int32)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running end-to-end drills")
    config.addinivalue_line(
        "markers", "quick: ~2min smoke subset (pre-commit tier; -m quick)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skips without one")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if (item.module.__name__ in QUICK_MODULES
                and "slow" not in item.keywords):
            item.add_marker(pytest.mark.quick)
