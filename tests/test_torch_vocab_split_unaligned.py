"""An LM head split along its vocab into shards that are no whole number of
16-byte rows stays split (``ops._vocab_splits``: an even split is enough,
since the exit kernel loads such rows in 8-, 4- or 2-byte pieces,
``exit_confidence.w_piece``), as phi-3-vision-4.2b's 32064 columns over a
16-wide "model" axis (2004 a shard) now do.

  * ``w_piece`` picks the kernel's load path from V and w's address.
  * Reduced stablelm-1.6b with a vocab of 500 over a 2- and a 4-wide
    "model" axis (250 and 125 columns a shard), its decode step counted on
    meta tensors under a fake group of 4 (``launch.dryrun.count_step``): no
    collective record is as large as one shard of the head (a gathered head
    would be an all-gather of all of it).
  * The same head through gloo (1 x 2 and 1 x 4 ranks,
    ``tests/torch_multirank_workers.py``'s ``unaligned_vocab_head``): conf
    at atol 1e-3 and argmax exactly those of the unsharded head, the top
    columns at the shards' edges."""
import dataclasses

import pytest
from torch.distributed.device_mesh import init_device_mesh

import torch_multirank_workers as workers
from repro_torch.configs import SHAPES, get_config
from repro_torch.kernels import exit_confidence as kexit
from repro_torch.launch import dryrun


@pytest.mark.parametrize("V,address,piece", [(2000, 0, 16), (2004, 0, 8), (2002, 0, 4),
                                             (2003, 0, 2), (2000, 8, 8), (2000, 2, 2),
                                             (32064, 256, 16)])
def test_w_piece_follows_rows_and_address(V, address, piece):
    assert kexit.w_piece(V, address) == piece


@pytest.mark.parametrize("mesh_shape,cols", [((2, 2), 250), ((1, 4), 125)])
def test_unaligned_vocab_split_moves_no_head(mesh_shape, cols):
    cfg = get_config("stablelm-1.6b").reduced(vocab_size=500)
    shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=8, seq_len=256)
    assert cfg.vocab_size // mesh_shape[1] == cols and cols % 8 != 0
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))
        mode, _, _ = dryrun.count_step(cfg, shape, mesh)
    shard_bytes = cfg.d_model * cols * 2
    biggest = max(nbytes for _, nbytes, _ in mode.records)
    assert biggest < shard_bytes, (biggest, shard_bytes, sorted(set(mode.records))[-3:])


@pytest.mark.parametrize("mesh_key", ["1x2", "1x4"])
def test_unaligned_vocab_split_head_over_gloo(mesh_key, tmp_path):
    workers.spawn(workers.unaligned_vocab_head, mesh_key, tmp_path)
