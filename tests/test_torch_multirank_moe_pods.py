"""The port's multi-device path across real ranks, continued from
``tests/test_torch_multirank.py``:
the sharded serve and train steps of reduced stablelm-1.6b on the
three-axis mesh (2,1,2) ("pod", "data", "model"), and reduced
mixtral-8x7b's MoE on (2,2), where an expert overflows, so that the sharded
MoE is held to the capacity and slots of the whole batch.  The rank bodies
and their tolerances are in ``tests/torch_multirank_workers.py``."""
import torch_multirank_workers as workers


def test_sharded_serve_steps_on_three_axes(tmp_path):
    workers.spawn(workers.serve_steps, "2x1x2", tmp_path)


def test_sharded_train_step_on_three_axes(tmp_path):
    workers.spawn(workers.train_step, "2x1x2", tmp_path)


def test_sharded_moe_serve_steps_keep_the_whole_batch_capacity(tmp_path):
    """Reduced mixtral-8x7b on (2,2): an expert overflows in the unsharded
    prefill, and the sharded steps (each device routing its own rows) drop
    the same choices, ranked over the whole batch."""
    workers.spawn(workers.serve_steps, "2x2", tmp_path, "mixtral-8x7b")


def test_sharded_moe_train_step_equals_unsharded(tmp_path):
    """Reduced mixtral-8x7b on (2,2): one train step through the sharded
    MoE (experts split over "model", their capacity split over "data")
    against the unsharded step."""
    workers.spawn(workers.train_step, "2x2", tmp_path, "mixtral-8x7b")
