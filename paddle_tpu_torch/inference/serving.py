"""Continuous-batching serving engine (counterpart of
``paddle_tpu/inference/serving.py``, dense KV mode).

The engine keeps **S fixed slots** alive instead of decoding one static
batch:

- per-slot device state (``tokens``/``pos``/``active``/``remaining``)
  and per-slot KV buffers ``(S, MAX, nH, D)`` per layer on the device —
  the same fixed-buffer cache ``generate()`` uses, indexed per row through
  the vector-``pos`` cached-attention path;
- decode runs ``chunk`` steps at a time over every slot, with the
  reference's masked-finish formulation (inactive slots ride along
  emitting pad), so greedy picks stay bitwise equal to ``generate()``;
- between chunks the FCFS scheduler admits queued requests into free
  slots: each prompt is right-padded to the smallest power-of-two bucket
  that fits and prefilled straight into its slot's KV rows (pad positions
  sit after the real tokens, so the causal prefix mask excludes them and
  decode overwrites them before they are attended);
- each chunk boundary makes exactly ONE device-to-host copy: the bundle of
  first tokens, chunk tokens and slot liveness that :meth:`_sync` reads.

``quant_mode="int8"`` quantizes every Linear weight and the tied LM head
once (``generation.quantize_weights``); every decode and prefill matmul
then runs the hand-written ``int8_matmul`` kernel.  Paged KV,
speculative decoding and fp8 are not ported yet and raise.  The engine
runs on its model's device and never moves the model.
"""
import time

import numpy as np
import torch

from ..device import module_device
from ..models.generation import (build_apply, build_pick, cast_weights,
                                 dominant_float_dtype, parameter_slots,
                                 quantize_weights, to_dtype)
from .scheduler import FCFSScheduler, Request

__all__ = ["ServingEngine", "Request", "FCFSScheduler"]


class ServingEngine:
    """Continuous-batching greedy decode over ``num_slots`` fixed slots.

    Usage::

        eng = ServingEngine(model, num_slots=8, chunk=32)
        req = eng.submit(prompt_ids, max_new_tokens=64,
                         callback=lambda r, tok, last: ...)
        eng.run()              # drain queue + in-flight work
        req.tokens             # generated ids (list of host ints)

    Knobs: ``num_slots`` (concurrent sequences), ``chunk`` (decode steps
    between admissions), ``max_seq_len`` (KV buffer length; defaults to
    the model's ``max_position_embeddings``), ``prefill_buckets``
    (prompt-length buckets; default powers of two from 16 below
    ``max_seq_len``), ``dtype`` (e.g. ``"bfloat16"`` casts weights and KV
    once), ``eos_token_id``/``pad_token_id``, ``max_prefills_per_gap``
    (see :class:`FCFSScheduler`) and ``quant_mode`` (None or ``"int8"``).
    """

    def __init__(self, model, num_slots=8, chunk=32, max_seq_len=None,
                 prefill_buckets=None, dtype=None, eos_token_id=None,
                 pad_token_id=0, max_prefills_per_gap=None,
                 kv_mode="dense", spec_decode=None, quant_mode=None):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if quant_mode is not None and quant_mode not in ("int8", "fp8"):
            raise ValueError(f"quant_mode {quant_mode!r} not in "
                             "(None, 'int8', 'fp8')")
        if kv_mode not in ("dense", "paged"):
            raise ValueError(f"kv_mode {kv_mode!r} not in "
                             "('dense', 'paged')")
        if kv_mode == "paged" or spec_decode is not None \
                or quant_mode == "fp8":
            raise NotImplementedError(
                "paged KV, speculative decoding and fp8 are not ported "
                "yet; the port serves kv_mode='dense' with quant_mode None "
                "or 'int8'")
        self.model = model
        self.device = module_device(model)
        limit = model.config.max_position_embeddings
        self.MAX = int(max_seq_len or limit)
        if self.MAX > limit:
            raise ValueError(
                f"max_seq_len {self.MAX} exceeds the model's "
                f"max_position_embeddings {limit}")
        self.num_slots = int(num_slots)
        self.chunk = int(chunk)
        self.eos = None if eos_token_id is None else int(eos_token_id)
        self.pad = int(pad_token_id)
        if prefill_buckets is None:
            b, buckets = 16, []
            while b < self.MAX:
                buckets.append(b)
                b *= 2
            prefill_buckets = buckets or [self.MAX - 1]
        self.buckets = sorted(int(b) for b in prefill_buckets)
        if self.buckets[-1] >= self.MAX:
            raise ValueError(
                "largest prefill bucket must leave room for at least one "
                f"generated token (bucket {self.buckets[-1]} >= "
                f"max_seq_len {self.MAX})")
        self._kvspec = model.kv_cache_spec()
        self._pvals = [p for _, p in model.named_parameters()]
        self.cache_dtype = dominant_float_dtype(self._pvals)
        if dtype is not None:
            self.cache_dtype = to_dtype(dtype)
            self._pvals = cast_weights(model, self._pvals, self.cache_dtype)
        self.quant_mode = quant_mode
        if quant_mode is not None:
            # after the cast, as in the reference: the int8 copies remember
            # the serving dtype, which the matmul outputs keep
            self._pvals = quantize_weights(model, self._pvals, quant_mode)
        self._apply = build_apply(model, parameter_slots(model))
        self._pick = build_pick()
        self.scheduler = FCFSScheduler(self.num_slots,
                                       max_prefills_per_gap)
        self._init_state()

    # -- state -------------------------------------------------------------
    def _init_state(self):
        S, dev = self.num_slots, self.device
        self._tokens = torch.full((S,), self.pad, dtype=torch.long,
                                  device=dev)
        self._pos = torch.zeros((S,), dtype=torch.long, device=dev)
        self._active = torch.zeros((S,), dtype=torch.bool, device=dev)
        self._remaining = torch.zeros((S,), dtype=torch.long, device=dev)
        self._caches = [
            (torch.zeros((S, self.MAX, nh, d), dtype=self.cache_dtype,
                         device=dev),
             torch.zeros((S, self.MAX, nh, d), dtype=self.cache_dtype,
                         device=dev))
            for nh, d in self._kvspec]
        self.stats = {"requests": 0, "finished": 0, "decoded_tokens": 0,
                      "chunks": 0, "prefills": 0, "ttft_ms": [],
                      "max_concurrent": 0, "page_evictions": 0,
                      "spec_proposed": 0, "spec_accepted": 0,
                      "spec_verify_steps": 0, "spec_chunks": 0}

    # -- API ---------------------------------------------------------------
    def _check_extent(self, prompt_len, total_extent):
        if prompt_len == 0:
            raise ValueError("empty prompt")
        if prompt_len > self.buckets[-1]:
            raise ValueError(
                f"prompt length {prompt_len} exceeds the largest "
                f"prefill bucket {self.buckets[-1]}")
        if total_extent > self.MAX:
            raise ValueError(
                f"prompt_len + max_new_tokens = {total_extent} exceeds "
                f"max_seq_len = {self.MAX}")

    def submit(self, prompt, max_new_tokens=32, callback=None):
        """Queue one request; returns its :class:`Request`.  ``prompt``
        is a 1-D int sequence (list, numpy array or CPU tensor)."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self._check_extent(int(prompt.size),
                           int(prompt.size) + int(max_new_tokens))
        self.stats["requests"] += 1
        return self.scheduler.submit(prompt, max_new_tokens, callback)

    def step(self):
        """One engine cycle: admit queued requests into free slots (bucket
        prefills), run one decode chunk over all slots, then ONE host copy
        that streams tokens and frees finished slots.  Returns the
        requests finished this cycle."""
        toks = valid = None
        pending = self._admit()
        if self.scheduler.active:
            toks, valid = self._decode_chunk()
            self.stats["chunks"] += 1
        self.stats["max_concurrent"] = max(self.stats["max_concurrent"],
                                           len(self.scheduler.active))
        return self._sync(pending, toks, valid)

    def run(self):
        """Drain the queue and all in-flight slots; returns the finished
        requests in submission order."""
        was_training = self.model.training
        self.model.eval()
        finished = []
        try:
            while self.scheduler.has_work:
                finished.extend(self.step())
        finally:
            if was_training:
                self.model.train()
        return sorted(finished, key=lambda r: r.req_id)

    # -- internals ---------------------------------------------------------
    def _bucket_for(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket")

    def _prefill(self, ids, length, slot, budget):
        """Run the model over the right-padded (1, bucket) prompt, writing
        its KV straight into the slot's rows (in place: the reference
        prefills fresh single-row buffers and copies them in), pick the
        first token from the last real position, and arm the slot."""
        rows = [(ck[slot:slot + 1], vc[slot:slot + 1])
                for ck, vc in self._caches]
        logits, _ = self._apply(self._pvals, ids, rows, 0)
        t0 = self._pick(logits[:, length - 1])[0][0]
        fin0 = t0 == self.eos if self.eos is not None \
            else torch.zeros((), dtype=torch.bool, device=self.device)
        if budget <= 1:
            fin0 = torch.ones((), dtype=torch.bool, device=self.device)
        self._tokens[slot] = t0
        self._pos[slot] = length
        self._active[slot] = ~fin0
        self._remaining[slot] = budget - 1
        return t0, fin0

    def _decode_chunk(self):
        """``chunk`` decode steps over all S slots: only active slots
        advance; inactive ones ride along emitting pad with
        ``valid=False``.  Returns the (chunk, S) tokens and validity."""
        tokens, pos = self._tokens, self._pos
        active, remaining = self._active, self._remaining
        toks, valid = [], []
        for _ in range(self.chunk):
            logits, self._caches = self._apply(self._pvals, tokens[:, None],
                                               self._caches, pos)
            nxt, _ = self._pick(logits[:, 0, :])
            nxt = torch.where(active, nxt, self.pad)
            emitted = active
            live = active.long()
            pos = pos + live
            remaining = remaining - live
            hit_eos = nxt == self.eos if self.eos is not None \
                else torch.zeros_like(active)
            done = active & (hit_eos | (remaining <= 0))
            tokens = torch.where(active, nxt, tokens)
            active = active & ~done
            toks.append(nxt)
            valid.append(emitted)
        self._tokens, self._pos = tokens, pos
        self._active, self._remaining = active, remaining
        return torch.stack(toks), torch.stack(valid)

    def _admit(self):
        """Admit queued requests into free slots (bounded by the
        interleave knob): one bucket prefill each.  Returns the pending
        (request, slot, first-token, finished-flag) device handles, read
        back at the chunk-boundary sync, never here."""
        pending = []
        for req, slot in self.scheduler.admissions():
            n = int(req.prompt.size)
            bucket = self._bucket_for(n)
            ids = np.full((1, bucket), self.pad, np.int64)
            ids[0, :n] = req.prompt
            t0, fin0 = self._prefill(
                torch.as_tensor(ids, device=self.device), n, slot,
                req.max_new_tokens)
            self.stats["prefills"] += 1
            req.bucket = bucket
            pending.append((req, slot, t0, fin0))
        return pending

    def _sync(self, pending, toks, valid):
        """THE chunk-boundary host sync: one device-to-host copy of the
        prefill first tokens + the chunk's tokens + slot liveness, then
        stream callbacks, stamp TTFT, and free finished slots."""
        parts = [t.reshape(-1).long() for _, _, t, _ in pending] + \
            [f.reshape(-1).long() for _, _, _, f in pending]
        if toks is not None:
            parts += [toks.reshape(-1), valid.reshape(-1).long()]
        parts.append(self._active.long())
        bundle = torch.cat(parts).cpu().numpy()
        P, S = len(pending), self.num_slots
        first, fins = bundle[:P], bundle[P:2 * P]
        if toks is not None:
            n = self.chunk * S
            toks_h = bundle[2 * P:2 * P + n].reshape(self.chunk, S)
            valid_h = bundle[2 * P + n:2 * P + 2 * n].reshape(self.chunk, S)
        active_h = bundle[-S:]
        now = time.perf_counter_ns()
        # per-slot emissions this cycle, in order: the prefill's first
        # token, then the chunk's tokens
        emitted = {}
        for (req, slot, _, _), t0, fin0 in zip(pending, first, fins):
            req.first_token_ns = now
            self.stats["ttft_ms"].append(req.ttft_ms)
            emitted[slot] = [int(t0)]
            if fin0:
                req.finish_reason = "eos" if (
                    self.eos is not None and int(t0) == self.eos) \
                    else "budget"
        if toks is not None:
            for s in range(self.chunk):
                for slot in np.nonzero(valid_h[s])[0]:
                    emitted.setdefault(int(slot), []).append(
                        int(toks_h[s, slot]))
        finished = []
        for slot, toks_slot in sorted(emitted.items()):
            req = self.scheduler.active[slot]
            req.tokens.extend(toks_slot)
            if req.finish_reason is None and not bool(active_h[slot]):
                last = toks_slot[-1] if toks_slot else None
                req.finish_reason = "eos" if (
                    self.eos is not None and last == self.eos) \
                    else "budget"
            self.stats["decoded_tokens"] += len(toks_slot)
            done = req.finish_reason is not None
            if req.callback is not None:
                for i, tok in enumerate(toks_slot):
                    req.callback(req, tok,
                                 done and i == len(toks_slot) - 1)
            if done:
                req.finish_ns = now
                self.scheduler.release(slot)
                self.stats["finished"] += 1
                finished.append(req)
        return finished
