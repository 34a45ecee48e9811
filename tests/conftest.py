import numpy as np
import pytest

import jax

# Tests run on the single host CPU device (the dry-run's 512-device override
# lives ONLY in repro.launch.dryrun / subprocesses).
jax.config.update("jax_platform_name", "cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")
