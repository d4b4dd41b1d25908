import os
import sys

# ensure src/ is importable regardless of how pytest is invoked
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# NOTE: no XLA_FLAGS here on purpose — tests must see 1 (host) device;
# only launch/dryrun.py sets the 512-device flag (in a subprocess when
# exercised from tests).


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "property: hypothesis property-based suites; the CI `property` job "
        "re-runs them with a raised example budget (PROPERTY_EXAMPLES), "
        "tier-1 keeps the fast default profile")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; skips without one (decided inside each "
        "test). On the H100: python -m pytest -m gpu tests/test_torch_gpu.py")
