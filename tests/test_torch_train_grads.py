"""The port's training gradients against the JAX package's, block by block,
for the registry configs without recurrent blocks (the checks and their
tolerances: ``tests/torch_train_grads.py``); zamba2-2.7b and xlstm-350m are
in ``tests/test_torch_train_grads_ssm.py``."""
import pytest

from torch_train_common import ARCHS
from torch_train_grads import check_block_grads

SSM = ("zamba2-2.7b", "xlstm-350m")


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in SSM])
def test_block_grads_match_reference(arch):
    check_block_grads(arch)
