"""The gradient of the port's whole training loss against the JAX
package's, held to the reference's own jitted-vs-op-by-op gap
(``check_whole_grads`` in ``tests/torch_train_grads.py``), for seven of the
registry configs; deepseek-v2-lite-16b and xlstm-350m are in
``tests/test_torch_train_whole_grads_b.py``, zamba2-2.7b in
``tests/test_torch_train_whole_grads_c.py`` (split by their CPU time); and
the check rejecting a planted fault."""
import re

import pytest

from torch_train_grads import _whole_grads, check_whole_grads, whole_grads_own_gaps


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "glm4-9b", "internlm2-20b", "qwen2.5-32b",
                                  "mixtral-8x7b", "phi-3-vision-4.2b", "musicgen-medium"])
def test_whole_grads_within_the_reference_own_gap(arch):
    check_whole_grads(arch)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mixtral-8x7b"])
def test_whole_grads_reject_a_zeroed_leaf(arch):
    """A planted fault the check must reject: the port's gradient of the
    leaf on which the reference parts from itself most (the loosest bound)
    set to zero."""
    gaps = whole_grads_own_gaps(arch)
    worst = max(range(len(gaps)), key=gaps.__getitem__)
    name = _whole_grads(arch)[0][worst]
    with pytest.raises(AssertionError, match=re.escape(f"{name}: 1 >")):
        check_whole_grads(arch, zeroed=worst)
