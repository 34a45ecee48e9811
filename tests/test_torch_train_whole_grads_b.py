"""``tests/test_torch_train_whole_grads.py``'s check for deepseek-v2-lite-16b
(MLA and MoE) and xlstm-350m (mLSTM and sLSTM)."""
import pytest

from torch_train_grads import check_whole_grads


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "xlstm-350m"])
def test_whole_grads_within_the_reference_own_gap(arch):
    check_whole_grads(arch)
