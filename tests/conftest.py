import os
import sys

# NOTE: do NOT set xla_force_host_platform_device_count here — smoke tests
# and benches must see 1 device; only launch/dryrun.py forces 512.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    # tier-1 but memory-heavier than the rest: the N=1e5 tiered-store
    # smoke (tests/test_store.py) runs in the CI shard matrix by default;
    # deselect locally with -m "not scale" when RAM is tight
    config.addinivalue_line(
        "markers",
        "scale: population-scale smoke tests (N >= 1e5, still CI-fast)")
    # tests of the PyTorch port's CUDA kernels: they run on an NVIDIA GPU
    # and skip elsewhere (python3 chip_smoke.py covers the same on a card)
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skipped where torch.cuda.is_available() "
        "is False")
