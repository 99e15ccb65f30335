"""Test harness: force an 8-device CPU simulation BEFORE jax initializes.

The sharded search / replication paths are validated on a host-simulated 8-device
mesh (SURVEY.md §4: the equivalent of the reference's single-process tests,
generalized with the numpy-oracle pattern from reference
tests/test_query_processor.py:30-33).  Tests marked ``gpu`` need an NVIDIA GPU: they
skip here and run on the card with ``MLVDB_TEST_GPU=1 python -m pytest -m gpu tests/``.
"""

import os

# MLVDB_TEST_GPU=1 runs the suite on the GPU instead of the CPU simulation (the
# 8-device parallel tests then skip unless 8 devices exist).
_ON_GPU = os.environ.get("MLVDB_TEST_GPU") == "1"

if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` run only where JAX has an NVIDIA GPU (decided here, at
    run time, never while modules are collected)."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (MLVDB_TEST_GPU=1 on the card)")


@pytest.fixture
def eight_devices():
    """The 8-device mesh tests: skip when fewer devices exist (a real host)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (the CPU simulation provides them)")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def small_config():
    from mlvectordb_tpu.config import EngineConfig

    # tiny capacities so capacity-growth and compaction paths are exercised
    return EngineConfig(
        initial_capacity=64,
        capacity_multiple=32,
        db_tile=128,
        query_buckets=(4, 16, 64),
        k_buckets=(8, 32, 128),
    )


def numpy_knn(q, db, k, metric):
    """Brute-force oracle matching the engine's internal distance conventions
    (ports the oracle pattern of reference tests/test_query_processor.py:30-33)."""
    q = np.asarray(q, np.float32)
    db = np.asarray(db, np.float32)
    dots = q @ db.T
    if metric == "l2":
        d = (q * q).sum(-1)[:, None] + (db * db).sum(-1)[None, :] - 2 * dots
        d = np.maximum(d, 0)
    elif metric == "ip":
        d = 1.0 - dots
    elif metric == "cosine":
        qn = np.linalg.norm(q, axis=-1)[:, None]
        dn = np.linalg.norm(db, axis=-1)[None, :]
        d = 1.0 - dots / np.maximum(qn * dn, 1e-30)
    else:
        raise ValueError(metric)
    idx = np.argsort(d, axis=-1, kind="stable")[:, :k]
    return np.take_along_axis(d, idx, axis=-1), idx


@pytest.fixture
def oracle():
    return numpy_knn
