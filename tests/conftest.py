import os
import sys

# tests must see exactly 1 device (the dry-run sets 512 in its own process)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# The container has no `hypothesis`; fall back to the vendored shim (same
# API surface, deterministic draws).  A real install takes precedence.
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    sys.path.append(os.path.join(os.path.dirname(__file__), "_vendor"))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: needs a CUDA device; the test skips "
        "where none is visible")
