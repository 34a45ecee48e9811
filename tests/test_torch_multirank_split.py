"""Split-KV decode across real ranks: 2 and 4 gloo processes on the CPU
(spawned, joined through a ``FileStore`` under ``tmp_path``), the decode
caches laid out by ``sharding.cache_specs``, whose sequence split now stays
where it lies (each device attends to its own keys and the shards'
partials are combined).  Each case holds the sharded decode steps to the
unsharded ones on the same rank (tokens and exit stages equal, confidences
at atol 1e-3; ``tests/torch_multirank_workers.py``'s ``split_decode``):

  * reduced stablelm-1.6b on (1,2) and (2,2) under ``CollectiveRecorder``:
    no collective record over 16 KB, and the kernel wrappers' split paths
    held to their unsharded calls;
  * B 1 long context on (2,2): the batch cannot split, so the sequence is
    split over data x model jointly (``cache_specs``' else branch);
  * reduced deepseek-v2-lite-16b (MLA's latent cache) and reduced
    mixtral-8x7b with a window ring (a 40-token prompt past its window of
    32; the ring's ``slot_pos`` shards with it) on (2,2)."""
import pytest

import torch_multirank_workers as workers


@pytest.mark.parametrize("mesh_key", ["1x2", "2x2"])
def test_split_kv_decode_moves_no_large_record(mesh_key, tmp_path):
    workers.spawn(workers.split_decode, mesh_key, tmp_path, "stablelm-1.6b", 4, 16, 32, 4, True)


def test_split_kv_decode_batch_one_long_context(tmp_path):
    workers.spawn(workers.split_decode, "2x2", tmp_path, "stablelm-1.6b", 1, 24, 64, 4)


@pytest.mark.parametrize("arch,S,max_len", [("deepseek-v2-lite-16b", 16, 32),
                                            ("mixtral-8x7b", 40, 48)])
def test_split_kv_decode_mla_and_window_ring(arch, S, max_len, tmp_path):
    workers.spawn(workers.split_decode, "2x2", tmp_path, arch, 4, S, max_len, 3)
