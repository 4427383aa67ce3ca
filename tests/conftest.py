import os
import sys

# Tests must see exactly ONE device (the dry-run alone forces 512); keep any
# inherited XLA_FLAGS from leaking a device-count override into tests.
os.environ.pop("XLA_FLAGS", None)

sys.path.insert(0, os.path.dirname(__file__))  # proptest/oracle importable


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: subprocess / multi-device / multi-minute tests excluded from "
        "the fast CI lane (scripts/ci.sh runs them only with --full)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips (from a fixture) where "
        "torch.cuda.is_available() is False",
    )
