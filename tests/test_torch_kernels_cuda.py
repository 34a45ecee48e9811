"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; the ``cuda`` fixture skips them where no card is present.
Run on a machine with one: ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_kernels_cuda.py``.  Tolerances as on the CPU: decode
attention bf16 2e-2; exit confidence 1e-3 on conf with an exact argmax on
inputs with a clear top-1 margin.  On the card two tighter gates come on
top, each shown to reject a planted fault: decode attention element-wise at
rtol 1.6e-2 / atol 1e-2 against the f32-score plain version (the kernel's
own rounding), and conf at rtol 1e-4 as well (f32 summation order), since
at V = 100352 the atol alone passes a head that drops vocab tiles.  Paged
decode attention is held to the same element-wise gate on the gathered
cache, and to the dense kernel bit for bit.  Prefill flash attention is held
element-wise to its plain version at bf16 2e-2 and f32 2e-5, and its gate is
shown to reject three planted faults.  The decode walk (tensor cores, split
over the sequence, one walk for every G) is held to the same gates at the
warp tile's and the split's edges at every G, and its gate is shown to
reject a dropped last split and a skipped combine at G 1 and 16.  Above 16
query heads per KV head the wrappers launch the walk once per chunk of at
most 16, held to the same gates at G 17, 24 and 32.  The exit head is held
at the five LM heads of the registry, at B up to 65 (one pass over w per 64
rows), at a d of 16384 and one not a multiple of 8, with fewer vocab
columns than its CTAs' unit, and with a tie across a CTA boundary; and
where w's rows are no whole number of 16-byte units or w lies off a
16-byte boundary (the producer warp's cp.async pieces), phi-3-vision's
2004-column vocab shard among them, a dropped last column rejected.  A
reduced train step on the card reaches every Q/K/V projection and launches
no kernel, and every wrapper refuses CUDA inputs that require grad.
"""
import math

import pytest
import torch

from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import exit_confidence as texit
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import paged_decode_attention as tpaged
from repro_torch.kernels import ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, gen, dev, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "B,S,Hq,KVH,hd",
    [
        (8, 200, 32, 32, 64),  # stablelm-1.6b at the serve's shapes
        (2, 300, 8, 2, 64),  # GQA 4:1
        (1, 512, 4, 4, 128),
        (3, 1000, 16, 4, 64),
        (2, 300, 8, 1, 32),  # MQA, G = 8
        (4, 130, 8, 4, 128),  # G = 2
        (8, 130, 32, 2, 128),  # glm4-9b: G = 16, two CTAs per KV head
        (8, 200, 32, 32, 80),  # zamba2-2.7b's attention: hd 80, G = 1
        (2, 700, 8, 2, 80),  # hd 80 over two splits, G = 4
        (8, 120, 32, 8, 128),  # mixtral-8x7b's engine serve: G = 4, hd 128
        (2, 4096, 32, 8, 128),  # ... on a 4096-key cache
    ],
)
def test_decode_attention_matches_plain(cuda, B, S, Hq, KVH, hd):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn((B, Hq, hd), gen, cuda)
    k = _randn((B, S, KVH, hd), gen, cuda)
    v = _randn((B, S, KVH, hd), gen, cuda)
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=cuda, dtype=torch.int32)
    lengths[0] = S
    n0 = tdec.decode_attention.launches
    got = tdec.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert tdec.decode_attention.launches == n0 + 1
    want = ref.decode_attention_ref(q, k, v, lengths)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)
    want32 = ref.decode_attention_f32_scores_ref(q, k, v, lengths)
    torch.testing.assert_close(got.float(), want32.float(), rtol=1.6e-2, atol=1e-2)


def test_decode_attention_gate_rejects_a_dropped_token(cuda):
    """The current token dropped (lengths - 1) at the serve's shapes fails the
    element-wise gate against the f32-score plain version."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    B, S, Hq, hd = 8, 182, 32, 64
    q, k, v = (_randn(shape, gen, cuda) for shape in ((B, Hq, hd), (B, S, Hq, hd), (B, S, Hq, hd)))
    lengths = torch.randint(50, 120, (B,), generator=gen, device=cuda, dtype=torch.int32)
    want32 = ref.decode_attention_f32_scores_ref(q, k, v, lengths)
    torch.testing.assert_close(tdec.decode_attention(q, k, v, lengths).float(), want32.float(),
                               rtol=1.6e-2, atol=1e-2)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(tdec.decode_attention(q, k, v, lengths - 1).float(),
                                   want32.float(), rtol=1.6e-2, atol=1e-2)


def test_decode_attention_length_zero_and_past_cache(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    B, S, Hq, KVH, hd = 4, 96, 4, 4, 64
    q = _randn((B, Hq, hd), gen, cuda)
    k = _randn((B, S, KVH, hd), gen, cuda)
    v = _randn((B, S, KVH, hd), gen, cuda)
    lengths = torch.tensor([0, 50, S + 7, 1], dtype=torch.int32, device=cuda)
    got = tdec.decode_attention(q, k, v, lengths)
    assert torch.all(got[0] == 0)  # an empty cache row returns zeros
    want = ref.decode_attention_ref(q, k, v, lengths)  # lengths past S read the whole row
    torch.testing.assert_close(got[1:].float(), want[1:].float(), rtol=0, atol=2e-2)
    # rows are independent: a row alone gives what it gave in the batch
    one = tdec.decode_attention(q[1:2], k[1:2], v[1:2], lengths[1:2])
    torch.testing.assert_close(one, got[1:2], rtol=0, atol=0)


def test_decode_attention_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 6, 64), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    assert tdec.decode_attention(q, k, k, one).shape == q.shape  # G = 3 is taken
    for heads in (34, 64):  # G = 17, 32: past the walk's 16 rows, launched in chunks
        qg = torch.zeros((1, heads, 64), dtype=torch.bfloat16, device=cuda)
        assert tdec.decode_attention(qg, k, k, one).shape == qg.shape
    with pytest.raises(ValueError, match="hd in"):  # hd 96: no instance
        tdec.decode_attention(torch.zeros((1, 2, 96), dtype=torch.bfloat16, device=cuda),
                              torch.zeros((1, 8, 2, 96), dtype=torch.bfloat16, device=cuda),
                              torch.zeros((1, 8, 2, 96), dtype=torch.bfloat16, device=cuda), one)
    with pytest.raises(TypeError):
        tdec.decode_attention(q.float(), k.float(), k.float(),
                              torch.ones(1, dtype=torch.int32, device=cuda))


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------


def _paged_case(gen, dev, Hq, KVH, hd, bs, lengths):
    """Shuffled physical blocks, one trailing trash block, and each row's
    table pointing at the trash block past its length."""
    B, S = len(lengths), max(lengths)
    n_logical = -(-S // bs)
    NB = B * n_logical + 1
    perm = torch.randperm(NB - 1, generator=gen, device=dev).int()
    table = torch.full((B, n_logical), NB - 1, dtype=torch.int32, device=dev)
    for b, n in enumerate(lengths):
        used = -(-n // bs)
        table[b, :used] = perm[b * n_logical : b * n_logical + used]
    q = _randn((B, Hq, hd), gen, dev)
    k_pool = _randn((NB, bs, KVH, hd), gen, dev)
    v_pool = _randn((NB, bs, KVH, hd), gen, dev)
    return q, k_pool, v_pool, table, torch.tensor(lengths, dtype=torch.int32, device=dev)


def _gathered(pool, table, seq_len):
    B = table.shape[0]
    return pool[table.long()].reshape(B, -1, *pool.shape[2:])[:, :seq_len].contiguous()


def _assert_paged_gates(q, k_pool, v_pool, table, lengths, seq_len):
    """Element-wise against the f32-score plain version on the gathered cache,
    and bitwise against the dense kernel on it; one launch per chunk of at
    most 16 query heads per KV head."""
    n0 = tpaged.paged_decode_attention.launches
    got = tpaged.paged_decode_attention(q, k_pool, v_pool, table, lengths, seq_len=seq_len)
    torch.cuda.synchronize()
    G = q.shape[1] // k_pool.shape[2]
    assert tpaged.paged_decode_attention.launches == n0 + -(-G // tdec.MMA_G)
    kg, vg = _gathered(k_pool, table, seq_len), _gathered(v_pool, table, seq_len)
    ln = lengths.clamp(max=seq_len)
    torch.testing.assert_close(got.float(), ref.decode_attention_f32_scores_ref(q, kg, vg, ln).float(),
                               rtol=1.6e-2, atol=1e-2)
    plain = ref.paged_decode_attention_ref(q, k_pool, v_pool, table, lengths, seq_len=seq_len)
    nz = ln > 0  # the plain version gives a length-0 row the mean of V, the kernels zeros
    torch.testing.assert_close(got[nz].float(), plain[nz].float(), rtol=0, atol=2e-2)
    assert torch.equal(got, tdec.decode_attention(q, kg, vg, ln))
    return got


@pytest.mark.parametrize(
    "Hq,KVH,hd,bs,lengths",
    [
        (32, 32, 64, 16, [68, 87, 88, 55, 112, 70, 60, 106]),  # stablelm-1.6b at the serve's shapes
        (32, 32, 64, 1, [68, 87, 88, 55, 112, 70, 60, 106]),
        (8, 2, 64, 3, [300, 17, 1, 256]),  # GQA 4:1
        (16, 4, 128, 5, [129, 64, 200]),
        (8, 1, 32, 4, [999, 513]),  # G = 8
        (8, 4, 128, 16, [130, 7, 16, 33]),  # G = 2
        (32, 2, 128, 16, [104, 112, 97, 120, 1, 64, 110, 88]),  # glm4-9b: G = 16
        (32, 32, 80, 16, [68, 87, 88, 55, 112, 70, 60, 106]),  # zamba2-2.7b: hd 80
        (32, 32, 80, 1, [68, 87, 88, 55, 112, 70, 60, 106]),
        (8, 2, 80, 3, [700, 17, 1, 513]),  # hd 80, G = 4, two splits
        (32, 8, 128, 16, [68, 87, 88, 55, 112, 70, 60, 106]),  # mixtral-8x7b: G = 4
        (32, 8, 128, 1, [68, 87, 88, 55, 112, 70, 60, 106]),
    ],
)
def test_paged_decode_attention_matches_plain_and_dense(cuda, Hq, KVH, hd, bs, lengths):
    gen = torch.Generator(device=cuda).manual_seed(8)
    case = _paged_case(gen, cuda, Hq, KVH, hd, bs, lengths)
    seq_len = max(lengths)
    _assert_paged_gates(*case, seq_len)


def test_paged_decode_attention_edge_rows(cuda):
    """A length-0 row gives zeros; a padded all-trash row reads the trash
    block; seq_len short of n_logical * bs cuts a row that overhangs it."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k_pool, v_pool, table, lengths = _paged_case(gen, cuda, 8, 4, 64, 3, [40, 25, 1, 40])
    lengths[2] = 0
    table[3] = k_pool.shape[0] - 1  # padded row: every entry the trash block
    lengths[3] = 3
    got = _assert_paged_gates(q, k_pool, v_pool, table, lengths, seq_len=37)
    assert torch.all(got[2] == 0)


def test_paged_decode_attention_gate_rejects_planted_faults(cuda):
    """Each fault, held to the gathered cache of the true table, fails the
    element-wise gate: one table entry pointing at the neighbouring block,
    and the last partial block of every row dropped."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    q, k_pool, v_pool, table, lengths = _paged_case(
        gen, cuda, 32, 32, 64, 16, [68, 87, 88, 55, 112, 70, 60, 106])
    S = int(lengths.max())
    neighbour = table.clone()
    neighbour[0, 1] = (neighbour[0, 1] + 1) % (k_pool.shape[0] - 1)
    kg, vg = _gathered(k_pool, table, S), _gathered(v_pool, table, S)
    want32 = ref.decode_attention_f32_scores_ref(q, kg, vg, lengths).float()
    for fault in (tpaged.paged_decode_attention(q, k_pool, v_pool, neighbour, lengths, seq_len=S),
                  tpaged.paged_decode_attention(q, k_pool, v_pool, table, lengths // 16 * 16,
                                                seq_len=S)):
        with pytest.raises(AssertionError):
            torch.testing.assert_close(fault.float(), want32, rtol=1.6e-2, atol=1e-2)


def test_paged_decode_attention_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 6, 64), dtype=torch.bfloat16, device=cuda)
    pool = torch.zeros((3, 4, 2, 64), dtype=torch.bfloat16, device=cuda)
    table = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    assert tpaged.paged_decode_attention(q, pool, pool, table, one).shape == q.shape  # G = 3
    qg = torch.zeros((1, 34, 64), dtype=torch.bfloat16, device=cuda)  # G = 17, in two chunks
    assert tpaged.paged_decode_attention(qg, pool, pool, table, one).shape == qg.shape
    with pytest.raises(TypeError):
        tpaged.paged_decode_attention(q[:, :4], pool, pool, table.long(), one)


# ---------------------------------------------------------------------------
# the decode walk at every G: tensor cores, split over the sequence
# ---------------------------------------------------------------------------

SPLIT = tdec.SPLIT_KEYS
EDGE_LENGTHS = [0, 1, 31, 32, 33, SPLIT - 1, SPLIT, SPLIT + 1, 3000, 4096]


def _split_case(gen, dev, lengths, S, hd=128, G=16):
    """G query heads over each of 2 KV heads (glm4-9b's heads at G 16)."""
    B = len(lengths)
    return (_randn((B, 2 * G, hd), gen, dev), _randn((B, S, 2, hd), gen, dev),
            _randn((B, S, 2, hd), gen, dev), torch.tensor(lengths, dtype=torch.int32, device=dev))


def _assert_split_gates(got, q, k, v, lengths):
    """Element-wise against the f32-score plain version, and at 2e-2 against
    the plain version on the rows that have keys."""
    want32 = ref.decode_attention_f32_scores_ref(q, k, v, lengths)
    torch.testing.assert_close(got.float(), want32.float(), rtol=1.6e-2, atol=1e-2)
    nz = lengths > 0
    torch.testing.assert_close(got[nz].float(), ref.decode_attention_ref(q, k, v, lengths)[nz].float(),
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("G", range(1, tdec.MMA_G + 1))
@pytest.mark.parametrize("hd", [32, 64, 80, 128])
def test_decode_attention_g16_split_edges_match_plain(cuda, hd, G):
    """Lengths 0, 1, either side of the 32-key warp tile and of the split
    size, and a whole 4096-key cache: one split and no combine, two splits,
    eight; at every G."""
    gen = torch.Generator(device=cuda).manual_seed(20)
    q, k, v, ln = _split_case(gen, cuda, EDGE_LENGTHS, 4096, hd, G)
    n0 = tdec.decode_attention.launches
    got = tdec.decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    assert tdec.decode_attention.launches == n0 + 1
    assert torch.all(got[0] == 0)  # an empty cache row returns zeros
    _assert_split_gates(got, q, k, v, ln)


@pytest.mark.parametrize("G", [1, 5, 6, 8, 16])
@pytest.mark.parametrize("bs", [16, 3, 1])
def test_paged_decode_attention_g16_bitwise_equal_to_dense(cuda, bs, G):
    gen = torch.Generator(device=cuda).manual_seed(21)
    lengths = [4096, 3000, SPLIT + 1, 1, 0, 700, SPLIT, 2049]
    case = _paged_case(gen, cuda, 2 * G, 2, 128, bs, lengths)
    got = _assert_paged_gates(*case, seq_len=max(lengths))
    assert torch.all(got[4] == 0)


@pytest.mark.parametrize("G", [17, 24, 32])
def test_decode_attention_above_16_heads_per_kv_head(cuda, G):
    """G above the walk's 16 rows: one launch per chunk of at most 16 query
    heads per KV head, held to the split gates, each chunk bitwise the
    kernel on that chunk's heads alone; paged bitwise dense at bs 16, 3, 1."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    q, k, v, ln = _split_case(gen, cuda, EDGE_LENGTHS, 4096, 128, G)
    n0 = tdec.decode_attention.launches
    got = tdec.decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    assert tdec.decode_attention.launches == n0 + -(-G // 16)
    _assert_split_gates(got, q, k, v, ln)
    B = q.shape[0]
    first = q.view(B, 2, G, 128)[:, :, :16].reshape(B, 32, 128).contiguous()
    assert torch.equal(tdec.decode_attention(first, k, v, ln),
                       got.view(B, 2, G, 128)[:, :, :16].reshape(B, 32, 128))
    lengths = [4096, 3000, SPLIT + 1, 1, 0, 700, SPLIT, 2049]
    for bs in (16, 3, 1):
        _assert_paged_gates(*_paged_case(gen, cuda, 2 * G, 2, 128, bs, lengths), seq_len=max(lengths))


@pytest.mark.parametrize("G", [1, 16])
def test_decode_attention_g16_row_does_not_depend_on_batch_or_cache_size(cuda, G):
    """A row is bitwise the same alone, with a cache cut just past its length,
    as inside a batch of 8 with a 4096-key cache: its splits depend on its
    own length only."""
    gen = torch.Generator(device=cuda).manual_seed(22)
    q, k, v, ln = _split_case(gen, cuda, [3000, 1100, 97, 4096, 513, 0, 2048, 777], 4096, G=G)
    full = tdec.decode_attention(q, k, v, ln)
    for b in range(8):
        S_b = max(int(ln[b]), 1) + 5
        alone = tdec.decode_attention(q[b:b + 1], k[b:b + 1, :S_b].contiguous(),
                                      v[b:b + 1, :S_b].contiguous(), ln[b:b + 1])
        assert torch.equal(alone, full[b:b + 1]), f"row {b}"


@pytest.mark.parametrize("G", [1, 16])
def test_decode_attention_g16_gate_rejects_planted_faults(cuda, G):
    """Each fault fails the element-wise gate against the f32-score plain
    version: the last split of every row with more than one dropped, and the
    combine over splits skipped (those rows keep the zeros they were given)."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    q, k, v, ln = _split_case(gen, cuda, [4096, 3000, 1500, SPLIT + 1], 4096, G=G)
    want32 = ref.decode_attention_f32_scores_ref(q, k, v, ln).float()
    torch.testing.assert_close(tdec.decode_attention(q, k, v, ln).float(), want32,
                               rtol=1.6e-2, atol=1e-2)
    dropped = tdec.decode_attention(q, k, v, (ln - 1) // SPLIT * SPLIT)
    skipped = torch.zeros_like(q)
    tdec._launch(q, k, v, ln, skipped, combine=False)
    for fault in (dropped, skipped):
        with pytest.raises(AssertionError):
            torch.testing.assert_close(fault.float(), want32, rtol=1.6e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# exit confidence
# ---------------------------------------------------------------------------


def _margin_inputs(gen, dev, B, d, V):
    """Logits ~ N(0, 1) with row b's target raised by 8: a clear top-1
    margin, and a confidence that still depends on the whole vocab."""
    h = torch.randn((B, d), generator=gen, device=dev)
    w = torch.randn((d, V), generator=gen, device=dev) / math.sqrt(d)
    targets = torch.randperm(V, generator=gen, device=dev)[:B]
    w[:, targets] += 8.0 * (h / h.norm(dim=1, keepdim=True) ** 2).T
    h, w = h.bfloat16(), w.bfloat16()
    logits = h.double() @ w.double()
    top2 = logits.topk(2, dim=1).values
    assert bool(torch.all(top2[:, 0] - top2[:, 1] > 0.05)), "inputs lack a clear top-1 margin"
    return h, w


def _assert_conf_close(conf, cref):
    """atol 1e-3 (the CPU tests' tolerance) and rtol 1e-4, both."""
    torch.testing.assert_close(conf, cref, rtol=0, atol=1e-3)
    torch.testing.assert_close(conf, cref, rtol=1e-4, atol=0)


# vocabs that are multiples of 8 (TMA's path for w), most not of the
# 256-column tile; the five LM heads of the registry at B 1 and 8; B 16-65
# at stablelm-1.6b's head (65: two passes over w); d 16384 and d 100 (not a
# multiple of 8: an aligned, zero-padded copy of h); V 120 and 136, fewer
# columns than a 64-column unit per CTA; the LM heads of mixtral-8x7b,
# phi-3-vision-4.2b and musicgen-medium (32 units over 119 CTAs)
LM_HEADS = [(2048, 100352), (4096, 151552), (2048, 102400), (6144, 92544), (5120, 152064),
            (4096, 32000), (3072, 32064), (1536, 2048)]


@pytest.mark.parametrize(
    "B,d,V",
    [(B, d, V) for d, V in LM_HEADS for B in (1, 8)]
    + [(B, 2048, 100352) for B in (16, 32, 64, 65)]
    + [(4, 64, 1000), (3, 32, 520), (5, 16, 136), (13, 128, 2048), (6, 16, 120),
       (3, 16384, 1024), (5, 100, 2056)],
)
def test_exit_confidence_matches_plain(cuda, B, d, V):
    gen = torch.Generator(device=cuda).manual_seed(2)
    h, w = _margin_inputs(gen, cuda, B, d, V)
    n0 = texit.exit_confidence.launches
    conf, idx = texit.exit_confidence(h, w)
    torch.cuda.synchronize()
    assert texit.exit_confidence.launches == n0 + -(-B // texit.MAX_ROWS)
    cref, iref = ref.exit_confidence_ref(h, w)
    _assert_conf_close(conf, cref)
    assert torch.equal(idx, iref)


def test_exit_confidence_gate_rejects_a_dropped_tile(cuda):
    """The last 256-column vocab tile never read, at full width: within the
    atol, outside the rtol."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    h, w = _margin_inputs(gen, cuda, 8, 2048, 100352)
    cref, _ = ref.exit_confidence_ref(h, w)
    conf, _ = texit.exit_confidence(h, w[:, :-256].contiguous())
    with pytest.raises(AssertionError):
        _assert_conf_close(conf, cref)


def test_exit_confidence_rejects_what_it_cannot_take(cuda):
    h = torch.zeros((2, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        texit.exit_confidence(h, torch.zeros((16, 100), dtype=torch.float32, device=cuda))
    with pytest.raises(ValueError, match="shapes"):
        texit.exit_confidence(h, torch.zeros((8, 100), dtype=torch.bfloat16, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        texit.exit_confidence(h, torch.zeros((100, 16), dtype=torch.bfloat16, device=cuda).T)


# w's rows in pieces (``w_piece``): 2004 columns (phi-3-vision-4.2b's head
# over 16 devices, 8-byte cp.async), 2002 (4), 2003 and 125 (odd: 2 bytes
# through registers), 100 (fewer columns than a unit), and w 2 bytes past a
# 16-byte boundary (2-byte pieces) and 8 bytes past it (8); B past one pass
# and d not a multiple of 8 or of 64
@pytest.mark.parametrize(
    "B,d,V,offset",
    [(B, 3072, 2004, 0) for B in (1, 8, 32)]
    + [(8, 2048, 2002, 0), (8, 2048, 2003, 0), (5, 256, 125, 0), (3, 16, 100, 0),
       (4, 100, 2003, 0), (8, 128, 2048, 1), (8, 128, 2048, 4), (65, 512, 2004, 0),
       (4, 100, 2004, 0)],
)
def test_exit_confidence_unaligned_rows_match_plain(cuda, B, d, V, offset):
    gen = torch.Generator(device=cuda).manual_seed(8)
    h, w = _margin_inputs(gen, cuda, B, d, V)
    if offset:
        flat = torch.empty(d * V + offset, dtype=torch.bfloat16, device=cuda)
        flat[offset:] = w.flatten()
        w = flat[offset:].view(d, V)
    assert texit.w_piece(V, w.data_ptr()) < 16
    n0 = texit.exit_confidence.launches
    conf, idx, mx = texit.exit_confidence_partial(h, w)
    c0, i0 = texit.exit_confidence(h, w)
    torch.cuda.synchronize()
    assert texit.exit_confidence.launches == n0 + 2 * -(-B // texit.MAX_ROWS)
    cref, iref, mref = ref.exit_confidence_partial_ref(h, w)
    _assert_conf_close(conf, cref)
    assert torch.equal(idx, iref)
    torch.testing.assert_close(mx, mref, rtol=0, atol=1e-3)
    assert torch.equal(conf, c0) and torch.equal(idx, i0)


def test_exit_confidence_unaligned_gate_rejects_a_dropped_column(cuda):
    """A 2004-wide shard read as 2003 columns, its last column row 0's top:
    the argmax moves."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    h, w = _margin_inputs(gen, cuda, 8, 3072, 2004)
    w[:, -1] = w[:, int(ref.exit_confidence_ref(h, w)[1][0])] * 1.5
    cref, iref = ref.exit_confidence_ref(h, w)
    assert int(iref[0]) == 2003
    conf, idx = texit.exit_confidence(h, w[:, :-1].contiguous())
    assert not torch.equal(idx, iref)


def test_exit_confidence_tie_takes_first_index(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    h = torch.randn((3, 64), generator=gen, device=cuda)
    w = torch.randn((64, 3000), generator=gen, device=cuda) * 0.01
    col = 4.0 * h.sum(0) / h.sum(0).norm()
    w[:, 40] = col
    w[:, 2900] = col  # the same logits in a later vocab tile
    w[:, 41] = col  # and in the same tile
    conf, idx = texit.exit_confidence(h.bfloat16(), w.bfloat16())
    assert torch.all(idx == 40)
    _, iref = ref.exit_confidence_ref(h.bfloat16(), w.bfloat16())
    assert torch.equal(idx, iref)


def test_exit_confidence_tie_across_a_cta_boundary(cuda):
    """Equal top logits at the last column of one CTA's vocab range, the
    first of the next and one in the last range: the first wins."""
    V = 100352
    ranges = texit.vocab_ranges(V, texit.grid_ctas(V, texit._ctas(cuda)))
    a, b = ranges[4][1] - 1, ranges[5][0]
    gen = torch.Generator(device=cuda).manual_seed(7)
    h = torch.randn((5, 256), generator=gen, device=cuda)
    w = torch.randn((256, V), generator=gen, device=cuda) * 0.01
    col = 4.0 * h.sum(0) / h.sum(0).norm()
    for c in (b, a, ranges[-1][0]):
        w[:, c] = col
    conf, idx = texit.exit_confidence(h.bfloat16(), w.bfloat16())
    assert torch.all(idx == a)
    cref, iref = ref.exit_confidence_ref(h.bfloat16(), w.bfloat16())
    assert torch.equal(idx, iref)
    _assert_conf_close(conf, cref)


def test_exit_confidence_padded_rows_do_not_leak(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    h = _randn((3, 256), gen, cuda)
    w = _randn((256, 5000), gen, cuda)
    c3, i3 = texit.exit_confidence(h, w)
    hp = torch.cat([h, torch.zeros((5, 256), dtype=h.dtype, device=cuda)])
    c8, i8 = texit.exit_confidence(hp, w)
    torch.testing.assert_close(c8[:3], c3, rtol=0, atol=0)
    assert torch.equal(i8[:3], i3)


# ---------------------------------------------------------------------------
# prefill flash attention
# ---------------------------------------------------------------------------


def _flash_case(gen, dev, B, Sq, Sk, Hq, KVH, hd, dtype=torch.bfloat16):
    return (_randn((B, Sq, Hq, hd), gen, dev, dtype), _randn((B, Sk, KVH, hd), gen, dev, dtype),
            _randn((B, Sk, KVH, hd), gen, dev, dtype))


FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


@pytest.mark.parametrize(
    "B,Sq,Sk,Hq,KVH,hd,causal,window,dtype",
    [
        (8, 104, 104, 32, 32, 64, True, None, torch.bfloat16),  # stablelm-1.6b's first prefill batch
        (8, 104, 104, 32, 2, 128, True, None, torch.bfloat16),  # glm4-9b's heads: G = 16
        (1, 2048, 2048, 32, 32, 64, True, None, torch.bfloat16),  # one 2048-token prompt
        (2, 128, 384, 4, 4, 128, True, None, torch.bfloat16),  # Sk > Sq, top-left positions
        (1, 128, 128, 2, 2, 64, False, None, torch.bfloat16),  # not causal
        (1, 256, 256, 4, 4, 64, True, 100, torch.bfloat16),  # sliding window
        (2, 1, 50, 8, 2, 32, True, None, torch.bfloat16),  # Sq = 1
        (3, 77, 77, 8, 2, 32, True, None, torch.bfloat16),  # S not a multiple of 64
        (8, 104, 104, 32, 32, 80, True, None, torch.bfloat16),  # zamba2-2.7b's heads: hd 80
        (1, 2048, 2048, 32, 32, 80, True, None, torch.bfloat16),
        (2, 128, 384, 4, 4, 80, True, None, torch.bfloat16),
        (1, 256, 256, 4, 4, 80, True, 100, torch.bfloat16),
        (4, 512, 512, 32, 32, 96, True, None, torch.bfloat16),  # phi-3-vision's heads: hd 96
        (8, 104, 104, 32, 32, 96, True, None, torch.bfloat16),
        (1, 2048, 2048, 32, 32, 96, True, None, torch.bfloat16),
        (1, 256, 256, 4, 4, 96, True, 100, torch.bfloat16),
        # mixtral-8x7b's heads (G 4, hd 128) with its 4096-key window past it
        (1, 4160, 4160, 32, 8, 128, True, 4096, torch.bfloat16),
        # tests/test_kernels.py's sweep in f32
        (1, 128, 128, 4, 4, 64, True, None, torch.float32),
        (2, 256, 256, 8, 2, 64, True, None, torch.float32),
        (1, 192, 192, 4, 1, 32, True, None, torch.float32),
        (2, 128, 384, 4, 4, 128, True, None, torch.float32),
        (1, 256, 256, 4, 4, 64, True, 32, torch.float32),
        (1, 128, 128, 2, 2, 64, False, None, torch.float32),
        (2, 200, 200, 8, 2, 80, True, None, torch.float32),
        (2, 200, 200, 8, 2, 96, True, None, torch.float32),
        (1, 300, 300, 4, 4, 96, True, 130, torch.float32),
    ],
)
def test_flash_attention_matches_plain(cuda, B, Sq, Sk, Hq, KVH, hd, causal, window, dtype):
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = _flash_case(gen, cuda, B, Sq, Sk, Hq, KVH, hd, dtype)
    n0 = tflash.flash_attention.launches
    got = tflash.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=FLASH_TOL[dtype])


@pytest.mark.parametrize(
    "B,Sq,Sk,Hq,KVH,hd,causal,window",
    [
        # query lengths that are not multiples of the 128-row work tile
        (2, 129, 129, 4, 4, 32, True, None),
        (2, 129, 129, 4, 4, 64, True, None),
        (2, 129, 129, 4, 4, 128, True, None),
        (2, 200, 200, 8, 2, 32, True, None),
        (2, 200, 200, 8, 2, 64, True, None),
        (2, 200, 200, 8, 2, 128, True, None),
        (2, 129, 129, 4, 4, 80, True, None),
        (2, 200, 200, 8, 2, 80, True, None),
        (1, 300, 300, 4, 4, 80, True, 130),
        (1, 200, 600, 4, 4, 80, False, 130),
        (2, 129, 129, 4, 4, 96, True, None),
        (2, 200, 200, 8, 2, 96, True, None),
        (1, 300, 300, 4, 4, 96, True, 130),
        (1, 200, 600, 4, 4, 96, False, 130),
        # mixtral-8x7b's window at G 4 over several 128-key tiles of band
        (1, 1100, 1100, 8, 2, 128, True, 500),
        # Sk > Sq, top-left positions
        (2, 129, 400, 4, 4, 64, True, None),
        (1, 200, 600, 4, 4, 128, True, None),
        # windows whose bounds cross the 128-key tiles
        (1, 300, 300, 4, 4, 64, True, 130),
        (1, 200, 600, 4, 4, 128, False, 130),
        (2, 257, 257, 4, 2, 32, True, 129),
        # glm4-9b's GQA 16 at 2048 tokens
        (1, 2048, 2048, 32, 2, 128, True, None),
    ],
)
def test_flash_attention_wgmma_tiles_match_plain(cuda, B, Sq, Sk, Hq, KVH, hd, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(14)
    q, k, v = _flash_case(gen, cuda, B, Sq, Sk, Hq, KVH, hd)
    got = tflash.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)


def test_flash_attention_gate_rejects_planted_faults(cuda):
    """Each fault, made on the kernel's inputs and held to the plain version
    on the true inputs, fails the element-wise gate: K/V shifted by one
    position, Sk cut to the last whole tile, the KV heads permuted at G 16."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    q, k, v = _flash_case(gen, cuda, 8, 104, 104, 32, 2, 128)
    want = ref.flash_attention_ref(q, k, v).float()
    torch.testing.assert_close(tflash.flash_attention(q, k, v).float(), want, rtol=0, atol=2e-2)
    shift = (torch.roll(k, -1, dims=1), torch.roll(v, -1, dims=1))
    cut = (k[:, :64].contiguous(), v[:, :64].contiguous())
    perm = (k.flip(2).contiguous(), v.flip(2).contiguous())
    for kf, vf in (shift, cut, perm):
        with pytest.raises(AssertionError):
            torch.testing.assert_close(tflash.flash_attention(q, kf, vf).float(), want,
                                       rtol=0, atol=2e-2)


def test_flash_attention_rows_do_not_depend_on_batch_or_length(cuda):
    """A row's output is bitwise the same alone and inside a batch, and a
    prefix's outputs are the same inside a longer prompt (causal): the key
    tiles start at absolute positions.  A row that sees no key gives zeros."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = _flash_case(gen, cuda, 8, 68, 68, 8, 2, 64)
    full = tflash.flash_attention(q, k, v)
    alone = tflash.flash_attention(q[3:4].contiguous(), k[3:4].contiguous(), v[3:4].contiguous())
    assert torch.equal(alone, full[3:4])
    short = tflash.flash_attention(q[:, :57].contiguous(), k[:, :57].contiguous(),
                                   v[:, :57].contiguous())
    assert torch.equal(short, full[:, :57])
    # not causal, window 5, Sk 10: rows 14 and on see no key
    out = tflash.flash_attention(q, k[:, :10].contiguous(), v[:, :10].contiguous(),
                                 causal=False, window=5)
    assert torch.all(out[:, 14:] == 0)
    want = ref.flash_attention_ref(q, k[:, :10], v[:, :10], causal=False, window=5)
    torch.testing.assert_close(out[:, :14].float(), want[:, :14].float(), rtol=0, atol=2e-2)


def test_flash_attention_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # hd 48 (96 is taken since phi-3-vision-4.2b)
        tflash.flash_attention(*(torch.zeros((1, 8, 2, 48), dtype=torch.bfloat16, device=cuda),) * 3)
    with pytest.raises(TypeError):
        tflash.flash_attention(q, kv.float(), kv)
    with pytest.raises(ValueError):  # not contiguous
        tflash.flash_attention(q.transpose(1, 2), kv, kv)
    with pytest.raises(ValueError):
        tflash.flash_attention(q, kv, kv, window=0)
    with pytest.raises(ValueError):  # 3 query heads over 2 KV heads
        tflash.flash_attention(q[:, :, :3].contiguous(), kv, kv)


# ---------------------------------------------------------------------------
# the serve's wall time on the card
# ---------------------------------------------------------------------------


def test_traced_serve_syncs_before_each_wall_reading(cuda, monkeypatch):
    """A tracer makes the engine synchronize the card once per stage batch
    before it reads the batch's wall time; a serve with no observer adds no
    sync, and both give the same tokens, exits and simulated delays."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.profiles import profile_from_arch
    from repro_torch.core.thresholds import synthetic_validation
    from repro_torch.core.topology import NetworkSpec, build_edge_network
    from repro_torch.models import model as model_lib
    from repro_torch.obs import SpanTracer, roofline_utilization
    from repro_torch.serving import CollaborativeEngine

    cfg = get_config("stablelm-1.6b").reduced()
    profile = profile_from_arch(cfg)
    engine = CollaborativeEngine(
        model_lib.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda), cfg,
        build_edge_network(seed=0, profile=profile, spec=NetworkSpec(num_eds=4, es_per_stage=(2, 2))),
        profile, synthetic_validation(seed=1, profile=profile), seed=0, device=cuda,
    )
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, 10 + i).astype(np.int32)
               for i in range(6)]
    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: (syncs.append(a), real(*a, **k)))

    def serve(**kw):
        engine.rng = np.random.default_rng(3)
        return engine.serve(prompts, arrival_rate=1e3, batch_size=4, gen_len=3, **kw)

    plain = serve()
    n_plain = len(syncs)
    tracer = SpanTracer()
    traced = serve(tracer=tracer)
    assert n_plain == 0 and len(syncs) == traced.num_batches > 0
    assert traced.sequences_by_rid() == plain.sequences_by_rid() and traced.delays == plain.delays
    rows = roofline_utilization(tracer, cfg)
    assert rows and all(r["measured_wall_s"] > 0 for r in rows.values())


# ---------------------------------------------------------------------------
# training on the card: no kernel, every projection reached
# ---------------------------------------------------------------------------


def test_train_step_reaches_qkv_and_launches_no_kernel(cuda):
    """One reduced stablelm-1.6b train step on the card (f32 masters): the
    loss is finite, every stage's Q, K and V projections get a nonzero
    gradient (the forward-only flash kernel would cut them), and no kernel's
    launch counter moves (training attends with the plain version)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, token_stream
    from repro_torch.models import model as model_lib
    from repro_torch.training import AdamWConfig, make_train_step
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_step as train_step_lib

    wrappers = (texit.exit_confidence, tdec.decode_attention, tpaged.paged_decode_attention,
                tflash.flash_attention)
    before = [f.launches for f in wrappers]
    cfg = get_config("stablelm-1.6b").reduced()
    params = model_lib.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda,
                                   master=True)
    batch = next(token_stream(cfg, DataConfig(batch_size=2, seq_len=64), device=cuda))
    _, _, grads = train_step_lib.value_and_grad(
        lambda p, b: model_lib.loss_fn(p, b, cfg), params, batch)
    for stage in grads["stages"]:
        for w in ("w_q", "w_k", "w_v"):
            assert float(torch.linalg.vector_norm(stage["blocks"][0]["attn"][w])) > 0
    step = make_train_step(cfg, AdamWConfig(total_steps=2, warmup_steps=1))
    _, state, metrics = step(params, opt_lib.init_opt_state(params), batch)
    assert math.isfinite(float(metrics["loss"])) and int(state["step"]) == 1
    assert [f.launches for f in wrappers] == before


def test_kernel_wrappers_refuse_grad_inputs_on_the_card(cuda, monkeypatch):
    """On CUDA tensors that require grad each wrapper raises before it builds
    or launches; under ``torch.no_grad()`` the same call runs."""
    from repro_torch.kernels import build

    gen = torch.Generator(device=cuda).manual_seed(3)
    q4 = _randn((1, 128, 2, 64), gen, cuda)
    kv4 = _randn((1, 128, 2, 64), gen, cuda)
    kv2 = _randn((2, 128, 2, 64), gen, cuda)
    q3 = _randn((2, 2, 64), gen, cuda)
    lengths = torch.tensor([100, 7], dtype=torch.int32, device=cuda)
    pool = _randn((9, 16, 2, 64), gen, cuda)
    table = torch.arange(16, dtype=torch.int32, device=cuda).reshape(2, 8) % 8
    h, w = _randn((2, 64), gen, cuda), _randn((64, 256), gen, cuda)
    calls = {
        "flash_attention": lambda q: tflash.flash_attention(q, kv4, kv4),
        "decode_attention": lambda q: tdec.decode_attention(q, kv2, kv2, lengths),
        "paged_decode_attention": lambda q: tpaged.paged_decode_attention(q, pool, pool, table,
                                                                          lengths),
        "exit_confidence": lambda x: texit.exit_confidence(x, w),
    }
    inputs = {"flash_attention": q4, "decode_attention": q3, "paged_decode_attention": q3,
              "exit_confidence": h}
    real_load = build.load
    for name, call in calls.items():
        x = inputs[name].clone().requires_grad_(True)
        monkeypatch.setattr(build, "load", lambda n: (_ for _ in ()).throw(AssertionError(n)))
        with pytest.raises(RuntimeError, match="no backward"):
            call(x)
        monkeypatch.setattr(build, "load", real_load)
        with torch.no_grad():
            out = call(x)
        torch.cuda.synchronize()
        assert all(torch.isfinite(o).all() for o in (out if isinstance(out, tuple) else (out,))
                   if o.is_floating_point())
