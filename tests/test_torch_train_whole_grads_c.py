"""``tests/test_torch_train_whole_grads.py``'s check for zamba2-2.7b (five
Mamba2 blocks and an attention block a period)."""
from torch_train_grads import check_whole_grads


def test_whole_grads_within_the_reference_own_gap():
    check_whole_grads("zamba2-2.7b")
