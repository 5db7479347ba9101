import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest

warnings.filterwarnings("ignore")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def run_forced_mesh():
    """Run python `code` in a subprocess pinned to forced host devices.

    Multi-device mesh tests need >1 device while the main test process
    must keep seeing exactly 1 (the dry-run contract), so they run in
    subprocesses. scripts/run_tier1.sh pins DIST_SUBPROCESS_XLA_FLAGS for
    reproducibility on CPU-only boxes; the default matches the pin.
    """
    def run(code: str, timeout: float = 420) -> str:
        env = dict(os.environ)
        env["XLA_FLAGS"] = env.get(
            "DIST_SUBPROCESS_XLA_FLAGS",
            "--xla_force_host_platform_device_count=8")
        env["PYTHONPATH"] = os.path.join(REPO, "src")
        out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                             capture_output=True, text=True, env=env,
                             timeout=timeout)
        assert out.returncode == 0, out.stdout + out.stderr
        return out.stdout
    return run

# Graceful skip for property-based test modules when hypothesis is not
# installed (see requirements-dev.txt): ignoring them at collection keeps
# the rest of the suite collectable instead of erroring the whole session.
try:
    import hypothesis  # noqa: F401
except ImportError:
    collect_ignore = ["test_ft.py", "test_ortho.py", "test_partition.py",
                      "test_tiles.py", "test_safs_props.py"]


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "disk: filesystem-touching test (SAFS page files); run in a bounded "
        "TMPDIR via scripts/run_tier1.sh and size-guarded by disk_tmp")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the port's hand-written kernels); skips "
        "inside the test when torch.cuda.is_available() is false")


# Per-test byte budget for SAFS page files — a runaway page store should
# fail its own test, not fill the build box's disk.
DISK_TMP_BUDGET = 64 << 20


def _tree_bytes(root: str) -> int:
    total = 0
    for dirpath, _, files in os.walk(root):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, f))
            except OSError:
                pass
    return total


@pytest.fixture
def disk_tmp(tmp_path):
    """tmp dir for pytest.mark.disk tests with a teardown size guard."""
    yield str(tmp_path)
    used = _tree_bytes(str(tmp_path))
    assert used <= DISK_TMP_BUDGET, (
        f"disk test left {used/1e6:.1f} MB in {tmp_path} "
        f"(budget {DISK_TMP_BUDGET/1e6:.0f} MB)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def small_graph():
    """Symmetric normalized-adjacency RMAT graph (n=1200) + scipy CSR."""
    import scipy.sparse as sp
    from repro.graphs import rmat_graph, normalized_adjacency
    n = 1200
    r, c, v = rmat_graph(n, 10000, seed=5, symmetric=True)
    r2, c2, v2 = normalized_adjacency(n, r, c, v)
    a = sp.coo_matrix((v2, (r2, c2)), shape=(n, n)).tocsr()
    return n, r2, c2, v2, a
