"""The port's training gradients against the JAX package's, block by block,
for the registry configs with recurrent blocks: zamba2-2.7b (Mamba2 and an
attention block per period) and xlstm-350m (mLSTM and sLSTM).  The checks
and their tolerances: ``tests/torch_train_grads.py``."""
import pytest

from torch_train_grads import check_block_grads


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-350m"])
def test_block_grads_match_reference(arch):
    check_block_grads(arch)
