"""Request queue + batcher for the collaborative serving engine.

Requests carry their token prompt and bookkeeping (arrival time, current
stage, exit status).  The batcher groups requests heading to the same stage
replica into fixed-size padded batches — static shapes for the jit'd stage
programs.

``ShapeBucketBatcher`` is the per-replica queue of the micro-batched data
plane: requests are bucketed by input shape (prompt length at stage 1, the
residual-stream shape beyond), each bucket is a ``FifoBatcher``, and batches
drain FIFO *across* buckets — the bucket holding the oldest waiting request
goes first, so an odd shape can't be starved by a hot one.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Hashable

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray  # prompt token ids
    arrival: float
    # runtime state
    stage: int = 0
    node: int = -1
    ed: int = -1  # arrival end device (failure re-submissions restart here)
    hidden: Any = None  # residual stream handed between stages
    exited: bool = False
    exit_stage: int = -1
    # execution attempts: 1 + number of fail-stop re-executions from the ED
    attempts: int = 1
    output_token: int = -1
    confidence: float = 0.0
    t_done: float = 0.0
    # autoregressive decode state
    phase: str = "prefill"  # "prefill" (first pass) | "decode" (cached steps)
    generated: list = dataclasses.field(default_factory=list)  # emitted tokens
    # per-stage route affinity: stage -> (node, edge); sampled on the first
    # pass and reused every decode step, so a request's stage-local KV cache
    # stays resident at the replica that built it
    path: dict = dataclasses.field(default_factory=dict)
    # stage-local cache residency: node -> slot index in that replica's ring
    slots: dict = dataclasses.field(default_factory=dict)
    # paged layout: node -> BlockAllocator sequence handle at that replica
    block_seq: dict = dataclasses.field(default_factory=dict)
    # latest observed confidence per early branch (previous token's reading;
    # the threshold-aware packer's exit predictor reads these)
    last_conf: dict = dataclasses.field(default_factory=dict)

    @property
    def delay(self) -> float:
        return self.t_done - self.arrival

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])

    def all_tokens(self) -> np.ndarray:
        """Prompt plus everything generated so far (the stateless-decode
        re-prefill input)."""
        if not self.generated:
            return self.tokens
        return np.concatenate(
            [self.tokens, np.asarray(self.generated, np.int32)]
        )


class FifoBatcher:
    """Per-replica FIFO with fixed-batch draining."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.queue: deque[Request] = deque()

    def push(self, req: Request) -> None:
        self.queue.append(req)

    def drain(self, max_batches: int | None = None) -> list[list[Request]]:
        batches = []
        while self.queue and (max_batches is None or len(batches) < max_batches):
            take = min(self.batch_size, len(self.queue))
            batches.append([self.queue.popleft() for _ in range(take)])
        return batches

    def __len__(self) -> int:
        return len(self.queue)


class ShapeBucketBatcher:
    """Shape-bucketed FIFO batching for one replica.

    Each distinct input shape gets its own ``FifoBatcher``; ``pop_batch``
    serves the bucket whose head request has waited longest (FIFO across
    buckets), taking at most ``batch_size`` requests of that one shape so
    the padded batch stays rectangular.
    """

    def __init__(self, batch_size: int, seq=None):
        self.batch_size = batch_size
        self.buckets: dict[Hashable, FifoBatcher] = {}
        self._seqs: dict[Hashable, deque[int]] = {}
        # ``seq`` lets several queues share one arrival counter, so FIFO
        # order is comparable across them (prefill buckets vs decode rows)
        self._push_seq = seq if seq is not None else itertools.count()

    def push(self, key: Hashable, req: Request) -> None:
        bucket = self.buckets.get(key)
        if bucket is None:
            bucket = self.buckets[key] = FifoBatcher(self.batch_size)
            self._seqs[key] = deque()
        bucket.push(req)
        self._seqs[key].append(next(self._push_seq))

    def head_seq(self) -> int | None:
        """Push sequence number of the longest-waiting request, or None."""
        heads = [s[0] for s in self._seqs.values() if s]
        return min(heads) if heads else None

    def peek(self) -> tuple[Hashable, Request] | None:
        """(bucket key, head request) the next ``pop_batch`` would serve —
        lets the engine size ``max_take`` (e.g. to free cache blocks) before
        committing to the pop."""
        heads = [(s[0], k) for k, s in self._seqs.items() if s]
        if not heads:
            return None
        _, key = min(heads)
        return key, self.buckets[key].queue[0]

    def head_len(self) -> int:
        """Queue length of the bucket the next ``pop_batch`` would serve
        (0 when idle) — lets a packing policy trim the take to an exact
        padded shape before committing to the pop."""
        head = self.peek()
        return len(self.buckets[head[0]].queue) if head is not None else 0

    def pop_batch(
        self, max_take: int | None = None
    ) -> tuple[Hashable, list[Request]] | None:
        """Drain one batch from the longest-waiting bucket, or None if idle.

        ``max_take`` caps the batch below ``batch_size`` (e.g. to the number
        of free cache slots at the replica); the rest of the bucket stays
        queued.
        """
        heads = [(s[0], k) for k, s in self._seqs.items() if s]
        if not heads:
            return None
        _, key = min(heads)
        take = self.batch_size if max_take is None else min(max_take, self.batch_size)
        if take < 1:
            return None
        bucket = self.buckets[key]
        batch = [bucket.queue.popleft() for _ in range(min(take, len(bucket.queue)))]
        seqs = self._seqs[key]
        for _ in batch:
            seqs.popleft()
        return key, batch

    def __len__(self) -> int:
        return sum(len(b) for b in self.buckets.values())


class SlotRing:
    """Ring allocator over a replica's cache slots.

    Freed slots rejoin at the tail, so allocation cycles through the ring —
    a retired request's rows are the last to be overwritten (friendly to
    debugging and to future prefix reuse).
    """

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.num_slots = num_slots
        self._free: deque[int] = deque(range(num_slots))

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self) -> int | None:
        return self._free.popleft() if self._free else None

    def free(self, slot: int) -> None:
        if not (0 <= slot < self.num_slots):
            raise ValueError(f"slot {slot} out of range")
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        self._free.append(slot)


def pad_tokens(reqs: list[Request], pad_id: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad prompts (plus any generated suffix) to a common length;
    returns (tokens [B, S], lengths [B])."""
    toks = [r.all_tokens() for r in reqs]
    max_len = max(int(t.shape[0]) for t in toks)
    B = len(reqs)
    out = np.full((B, max_len), pad_id, np.int32)
    lengths = np.zeros((B,), np.int32)
    for i, t in enumerate(toks):
        n = int(t.shape[0])
        out[i, :n] = t
        lengths[i] = n
    return out, lengths


def padded_batch_size(n: int, batch_size: int) -> int:
    """Static batch dim for ``n`` live rows: next power of two, capped at
    ``batch_size`` — bounds the jit cache to log2(batch_size) entries per
    shape bucket while not paying the full batch for stragglers."""
    if n >= batch_size:
        return batch_size
    b = 1
    while b < n:
        b <<= 1
    return min(b, batch_size)


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1) — the biggest batch that pads to
    exactly itself under ``padded_batch_size``."""
    if n < 1:
        raise ValueError("pow2_floor needs n >= 1")
    b = 1
    while b * 2 <= n:
        b <<= 1
    return b


class ExitPredictor:
    """Predicts a decode row's retirement class from the DTO-EE thresholds
    and the row's own confidence history (the threshold-aware batch policy).

    Exit decisions per token are fresh reads of the model's branch
    confidences, but confidences autocorrelate strongly across a request's
    tokens — a row whose last token's branch-``b`` confidence already sits
    within ``margin`` of the threshold ``c_b`` is very likely to clear it on
    an upcoming token.  Rows not near any threshold retire when their
    generation budget runs out, so their class is the remaining token count.

    ``thresholds_fn`` is read at every call: when the online controller
    swaps thresholds mid-serve, predictions follow immediately.
    """

    def __init__(self, thresholds_fn, gen_len: int, margin: float = 0.9):
        self.thresholds_fn = thresholds_fn
        self.gen_len = gen_len
        self.margin = margin

    def __call__(self, req: Request) -> Hashable:
        thresholds = self.thresholds_fn()
        for b in range(len(thresholds)):
            c = req.last_conf.get(b)
            if c is not None and c >= self.margin * float(thresholds[b]):
                return ("exit", b)
        return ("run", self.gen_len - len(req.generated))


def pack_decode_batch(
    items: list,
    batch_size: int,
    classify,
) -> tuple[list, list]:
    """Threshold-aware batch packing over a FIFO decode queue.

    ``items`` is the queue content, ``(seq, Request)`` pairs in FIFO order.
    The head row always dispatches (no starvation); the batch is filled
    first with rows sharing the head's predicted retirement class — so the
    whole batch tends to retire together instead of bleeding rows one at a
    time — then with the remaining rows in FIFO order.  When fewer rows than
    ``batch_size`` are available, the take is trimmed to the largest power
    of two so the padded shape holds zero dead rows (``padded_batch_size``
    pads to the next power of two; a 5-row batch would ship 3 padding rows).

    Returns ``(take, rest)`` with ``rest`` in the original FIFO order.
    """
    if not items:
        return [], []
    classes = [classify(r) for _, r in items]
    head_cls = classes[0]
    same = [it for it, c in zip(items, classes) if c == head_cls]
    other = [it for it, c in zip(items, classes) if c != head_cls]
    cand = (same + other)[:batch_size]
    n = len(cand)
    if n < batch_size:
        n = pow2_floor(n)
    taken = {id(it) for it in cand[:n]}
    take = cand[:n]
    rest = [it for it in items if id(it) not in taken]
    return take, rest


def batch_tokens(reqs: list[Request], batch_size: int, pad_id: int = 0) -> np.ndarray:
    """Stack same-length prompts into a padded [B, S] token batch."""
    toks, _ = pad_tokens(reqs, pad_id)
    B = padded_batch_size(len(reqs), batch_size)
    if B > len(reqs):
        toks = np.concatenate(
            [toks, np.full((B - len(reqs), toks.shape[1]), pad_id, np.int32)]
        )
    return toks
