"""The port's ``BlockAllocator`` against the JAX package's, step for step.

A hypothesis state machine drives the same random alloc / fork / append /
free / double-free schedule through both allocators and requires the same
return values (``AllocResult`` / ``AppendResult`` field by field, handles,
``None`` on exhaustion), the same exceptions, and after every step the same
tables, lengths, refcounts and pool accounting.  Direct cases pin
reuse-before-growth, a double free and copy-on-write moving the writer.
"""
import dataclasses

import pytest
from hypothesis import HealthCheck, settings
from hypothesis import strategies as st
from hypothesis.stateful import RuleBasedStateMachine, invariant, precondition, rule

from repro.serving import paging as jpaging
from repro_torch.serving import paging as tpaging

NUM_BLOCKS, BLOCK_SIZE = 12, 3


def _outcome(fn, *args):
    """What a call gave: ("ok", plain value) or ("raise", type name, message)."""
    try:
        out = fn(*args)
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return ("raise", type(e).__name__, str(e))
    if dataclasses.is_dataclass(out):
        return ("ok", type(out).__name__, dataclasses.asdict(out))
    return ("ok", out)


class TwinAllocators(RuleBasedStateMachine):
    def __init__(self):
        super().__init__()
        self.j = jpaging.BlockAllocator(NUM_BLOCKS, BLOCK_SIZE, prefix_sharing=True)
        self.t = tpaging.BlockAllocator(NUM_BLOCKS, BLOCK_SIZE, prefix_sharing=True)
        self.handles: list[int] = []
        self.retired: list[int] = []

    def _both(self, method: str, *args):
        got = _outcome(getattr(self.t, method), *args)
        want = _outcome(getattr(self.j, method), *args)
        assert got == want, (method, args)
        return want

    @rule(toks=st.lists(st.integers(0, 2), min_size=0, max_size=4 * BLOCK_SIZE + 1))
    def alloc(self, toks):
        out = self._both("alloc", toks)
        if out[0] == "ok" and out[1] is not None:
            self.handles.append(out[2]["handle"])

    @precondition(lambda self: self.handles)
    @rule(data=st.data())
    def fork(self, data):
        h = data.draw(st.sampled_from(self.handles))
        self.handles.append(self._both("fork", h)[1])

    @precondition(lambda self: self.handles)
    @rule(data=st.data())
    def append(self, data):
        h = data.draw(st.sampled_from(self.handles))
        assert self.t.append_cost(h) == self.j.append_cost(h)
        assert self.t.can_append(h) == self.j.can_append(h)
        self._both("append", h)

    @precondition(lambda self: self.handles)
    @rule(data=st.data())
    def free(self, data):
        h = data.draw(st.sampled_from(self.handles))
        self._both("free", h)
        self.handles.remove(h)
        self.retired.append(h)

    @precondition(lambda self: self.retired)
    @rule(data=st.data())
    def free_again(self, data):
        out = self._both("free", data.draw(st.sampled_from(self.retired)))
        assert out[0] == "raise" and out[1] == "ValueError"

    @invariant()
    def same_state(self):
        assert self.t.refcounts() == self.j.refcounts()
        assert self.t.live_handles() == self.j.live_handles()
        assert self.t.occupancy_stats() == self.j.occupancy_stats()
        for h in self.j.live_handles():
            assert self.t.table(h) == self.j.table(h)
            assert self.t.length(h) == self.j.length(h)


TestTwinAllocators = TwinAllocators.TestCase
TestTwinAllocators.settings = settings(
    max_examples=40, stateful_step_count=40, deadline=None,
    suppress_health_check=[HealthCheck.too_slow],
)


@pytest.mark.parametrize(
    "args", [(0, 4), (4, 0), (-1, 1)], ids=["no-blocks", "no-block-size", "negative"]
)
def test_constructor_checks_match(args):
    got = _outcome(tpaging.BlockAllocator, *args)
    want = _outcome(jpaging.BlockAllocator, *args)
    assert got[0] == want[0] == "raise" and got[1:] == want[1:]


@pytest.mark.parametrize("n_tokens,block_size", [(5, 2), (9, 3), (4, 4), (1, 1)])
def test_freed_blocks_reused_before_growth(n_tokens, block_size):
    for paging in (tpaging, jpaging):
        a = paging.BlockAllocator(16, block_size, prefix_sharing=False)
        first = a.alloc(list(range(n_tokens)))
        a.alloc([7] * n_tokens)  # keeps the fresh frontier moving
        fresh = a._fresh
        a.free(first.handle)
        again = a.alloc(list(range(100, 100 + n_tokens)))
        assert sorted(again.new_blocks) == sorted(first.table)
        assert a._fresh == fresh


def test_double_free_raises_and_leaves_pool_intact():
    for paging in (tpaging, jpaging):
        a = paging.BlockAllocator(8, 2)
        res = a.alloc([1, 2, 3, 4, 5])
        other = a.alloc([1, 2, 3, 4, 9])  # shares the two full blocks
        a.free(res.handle)
        before = (a.refcounts(), a.free_blocks)
        with pytest.raises(ValueError, match="not live"):
            a.free(res.handle)
        assert (a.refcounts(), a.free_blocks) == before
        assert a.table(other.handle)[:2] == res.table[:2]


def test_copy_on_write_moves_writer_not_reader():
    results = []
    for paging in (tpaging, jpaging):
        a = paging.BlockAllocator(8, 4)
        src = a.alloc([1, 2, 3, 4, 5, 6])  # blocks: one full, one partial
        child = a.fork(src.handle)
        shared = a.table(src.handle)[1]
        res = a.append(child)  # lands in the shared partial block
        assert res.cow is not None and res.cow[0] == shared and res.block == res.cow[1]
        assert a.table(src.handle)[1] == shared  # the reader keeps its block
        assert a.table(child)[1] == res.block != shared
        assert a.refcount(shared) == 1 and a.refcount(res.block) == 1
        assert a.refcount(a.table(src.handle)[0]) == 2
        results.append((dataclasses.asdict(res), a.refcounts(), a.table(child)))
    assert results[0] == results[1]
