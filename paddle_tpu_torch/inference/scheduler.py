"""Request scheduling for the continuous-batching serving engine (the
port's copy of ``paddle_tpu/inference/scheduler.py``, host-side Python).

The scheduler owns the FCFS admission queue and the slot free-list; the
engine (``serving.py``) owns the device state.  Kept here: what the dense
engine uses.  The fleet router's hooks (enqueue, steal, drain, requeue),
priorities, handoff and tracing fields come with their ports.
"""
import collections
import itertools
import threading
import time

__all__ = ["Request", "FCFSScheduler"]


class Request:
    """One generation request's lifecycle record.

    ``tokens`` accumulates streamed output ids (host ints); timing marks
    are ``time.perf_counter_ns`` stamps taken by the engine at submit /
    first-token sync / finish.  ``finish_reason`` is ``"eos"``,
    ``"budget"`` (max_new_tokens reached) or None while running.
    """

    __slots__ = ("req_id", "prompt", "max_new_tokens", "callback",
                 "tokens", "submit_ns", "admit_ns", "first_token_ns",
                 "finish_ns", "finish_reason", "slot", "bucket")

    def __init__(self, req_id, prompt, max_new_tokens, callback=None):
        self.req_id = req_id
        self.prompt = prompt                    # np.int32 1-D
        self.max_new_tokens = int(max_new_tokens)
        self.callback = callback                # fn(req, token, is_last)
        self.tokens = []
        self.submit_ns = time.perf_counter_ns()
        self.admit_ns = None
        self.first_token_ns = None
        self.finish_ns = None
        self.finish_reason = None
        self.slot = None
        self.bucket = None

    @property
    def done(self):
        return self.finish_reason is not None

    @property
    def ttft_ms(self):
        """Time to first token (observed at the engine's chunk-boundary
        sync, so quantized to the chunk cadence); None until then."""
        if self.first_token_ns is None:
            return None
        return (self.first_token_ns - self.submit_ns) / 1e6


class FCFSScheduler:
    """First-come-first-served admission over a fixed slot pool.

    ``max_prefills_per_gap`` is the prefill-vs-decode interleave knob:
    at most that many queued requests are admitted (= that many prefill
    dispatches run) between two decode chunks.  ``None`` admits into
    every free slot — lowest TTFT, but a deep queue can starve decode
    of wall-clock; ``1`` favors decode throughput under load.
    """

    def __init__(self, num_slots, max_prefills_per_gap=None):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if max_prefills_per_gap is not None and max_prefills_per_gap < 1:
            raise ValueError("max_prefills_per_gap must be >= 1 or None")
        self.num_slots = num_slots
        self.max_prefills_per_gap = max_prefills_per_gap
        self._queue = collections.deque()
        self._free = list(range(num_slots - 1, -1, -1))  # pop() -> slot 0
        self._running = {}                               # slot -> Request
        self._ids = itertools.count()
        # submit() may come from another thread while the engine loop
        # admits and releases
        self._lock = threading.Lock()

    def submit(self, prompt, max_new_tokens, callback=None):
        req = Request(next(self._ids), prompt, max_new_tokens, callback)
        with self._lock:
            self._queue.append(req)
        return req

    @property
    def queue_depth(self):
        return len(self._queue)

    @property
    def active(self):
        """Slot -> Request view of in-flight work (live dict: engine
        mutates via admit/release)."""
        return self._running

    @property
    def has_work(self):
        return bool(self._queue or self._running)

    def admissions(self):
        """Pop (request, slot) pairs for this inter-chunk gap: FCFS order,
        bounded by free slots and the interleave knob."""
        out = []
        budget = self.max_prefills_per_gap
        with self._lock:
            while self._queue and self._free and \
                    (budget is None or len(out) < budget):
                req = self._queue.popleft()
                slot = self._free.pop()
                req.slot = slot
                req.admit_ns = time.perf_counter_ns()
                self._running[slot] = req
                out.append((req, slot))
        return out

    def release(self, slot):
        """Return a finished slot to the free list."""
        with self._lock:
            req = self._running.pop(slot)
            self._free.append(slot)
        return req
