import os
import sys

# never force multi-device here: smoke tests and benches must see 1 device
# (the dry-run sets its own XLA_FLAGS in a subprocess).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(__file__))
    # property tests degrade to deterministic randomized replay (see stub)
    import _hypothesis_stub

    sys.modules["hypothesis"] = _hypothesis_stub
    sys.modules["hypothesis.strategies"] = _hypothesis_stub.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one "
        "(run on the card with `pytest -m gpu tests/test_torch_gpu.py`)")
