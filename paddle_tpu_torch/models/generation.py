"""Greedy autoregressive generation over the cached decode path
(counterpart of ``paddle_tpu/models/generation.py``), and the helpers the
serving engine shares with it: dtype selection, the one-time weight cast
and int8 quantization passes, the parameter swap (``build_apply``) and
the token pick (``build_pick``).

The reference runs prefill plus a ``lax.scan`` as one compiled program;
here the steps are a Python loop of eager device work, with the same
masked-finish formulation.  Sampling, beam search and the extra pad mask
are not ported yet.
"""
import threading

import numpy as np
import torch

from ..device import module_device, resolve_device

__all__ = ["generate", "GenerationMixin", "build_apply", "build_pick",
           "cast_weights", "dominant_float_dtype", "quantize_weights",
           "parameter_slots", "to_dtype"]


def to_dtype(dtype):
    """A torch dtype from a torch dtype or its name ("bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def _caches_for(model):
    """Per-model caches of the cast and quantized weight lists, stored on
    the instance (a module-global registry would pin every model)."""
    entry = model.__dict__.get("_generation_caches")
    if entry is None:
        entry = {"cast": None, "quant": None}
        model.__dict__["_generation_caches"] = entry
    return entry


def _identity(pvals):
    # a tensor updated in place (an optimizer step) keeps its identity but
    # bumps its version counter, so both key the cached copies
    return [(id(v), v._version) for v in pvals]


def dominant_float_dtype(pvals):
    """The model's dominant floating dtype by element count."""
    sizes = {}
    for v in pvals:
        if v.is_floating_point():
            sizes[v.dtype] = sizes.get(v.dtype, 0) + v.numel()
    return max(sizes, key=sizes.get) if sizes else torch.float32


def cast_weights(model, pvals, cache_dtype):
    """The parameter values cast to ``cache_dtype``, once per (dtype,
    weight identity and version): repeated calls reuse the copies."""
    caches = _caches_for(model)
    key = (cache_dtype, _identity(pvals))
    cast = caches["cast"]
    if cast is not None and cast[0] == key:
        return cast[2]
    out = [v.detach().to(cache_dtype) if v.is_floating_point() else v
           for v in pvals]
    caches["cast"] = (key, pvals, out)   # pvals held: their ids stay valid
    return out


def _linear_weight_indices(model):
    """Positions (in ``named_parameters()`` order) of the 2-D floating
    Linear weights — the matmuls the quantization pass narrows."""
    from ..nn.layer.common import Linear
    index = {id(p): i for i, (_, p) in enumerate(model.named_parameters())}
    out = set()
    for sub in model.modules():
        if isinstance(sub, Linear):
            i = index.get(id(sub.weight))
            if i is not None and sub.weight.dim() == 2 \
                    and sub.weight.is_floating_point():
                out.add(i)
    return sorted(out)


def quantize_weights(model, pvals, mode):
    """``pvals`` with every Linear weight replaced by a
    :class:`QuantizedWeight`, once per (mode, weight identity and
    version).  A tied LM head is quantized TRANSPOSED, (H, V) with
    per-vocab scales, so one narrow copy serves the head matmul and the
    input-embedding gather."""
    from ..ops.quant_dispatch import quantize_weight
    caches = _caches_for(model)
    key = (mode, _identity(pvals))
    ent = caches["quant"]
    if ent is not None and ent[0] == key:
        return ent[2]
    out = list(pvals)
    for i in _linear_weight_indices(model):
        out[i] = quantize_weight(pvals[i], mode)
    tied = getattr(model, "tied_lm_head", None)
    if tied is not None:
        for i, (_, p) in enumerate(model.named_parameters()):
            if p is tied:
                v = pvals[i]
                if v.dim() == 2 and v.is_floating_point():
                    out[i] = quantize_weight(v.T, mode)
                break
    caches["quant"] = (key, pvals, out)
    return out


def parameter_slots(model):
    """(owning module, attribute name) of every parameter, in
    ``named_parameters()`` order — where :func:`build_apply` swaps."""
    slots = []
    for name, _ in model.named_parameters():
        owner, _, attr = name.rpartition(".")
        slots.append((model.get_submodule(owner), attr))
    return slots


# build_apply swaps values into the (shared) model for the duration of one
# forward; two threads applying over one model must not interleave
_APPLY_LOCK = threading.RLock()


def build_apply(model, slots):
    """Forward over the model's cached decode path with the values ``pv``
    (aligned with ``slots``, see :func:`parameter_slots`) in place of its
    parameters: a cast tensor or a :class:`QuantizedWeight` is set in the
    owning module's instance ``__dict__``, which attribute lookup reads
    before ``nn.Module``'s parameter table, and is removed after the
    forward.  ``pos`` is an int (uniform batch) or a per-row (B,) tensor.
    Returns ``(logits, caches)``."""
    def apply(pv, ids, caches, pos):
        with _APPLY_LOCK:
            for (mod, attr), v in zip(slots, pv):
                mod.__dict__[attr] = v
            try:
                with torch.no_grad():
                    return model(ids, caches=caches, pos=pos)
            finally:
                for mod, attr in slots:
                    mod.__dict__.pop(attr, None)
    return apply


def build_pick():
    """Greedy token selection shared by :func:`generate` and the serving
    engine: fp32 log-softmax, argmax (first maximum on ties).  Returns
    ``(next_token, logprob)``."""
    def pick(logits):
        lg = logits.float()
        logp = torch.log_softmax(lg, dim=-1)
        nxt = torch.argmax(lg, dim=-1)
        score = torch.gather(logp, -1, nxt[:, None])[:, 0]
        return nxt, score
    return pick


class GenerationMixin:
    """``generate()`` and the per-layer KV-cache spec from the config."""

    def kv_cache_spec(self):
        """Per-layer (num_heads, head_dim) of the cache buffers."""
        c = self.config
        return [(c.num_attention_heads,
                 c.hidden_size // c.num_attention_heads)] * \
            c.num_hidden_layers

    def generate(self, input_ids, **kw):
        return generate(self, input_ids, **kw)


def generate(model, input_ids, max_new_tokens=32,
             decode_strategy="greedy_search", eos_token_id=None,
             pad_token_id=0, dtype=None, device=None):
    """Greedy continuation of ``input_ids`` (B, P).  Returns ``(ids,
    scores)``: the generated tokens (B, max_new_tokens) and their
    log-probabilities, as tensors on the model's device.

    ``device=None`` means the current CUDA device and raises when there is
    none; the model must already be on the resolved device (it is never
    moved).  ``dtype="bfloat16"`` runs weights and caches in bf16; picks
    stay fp32.  Rows that emitted ``eos_token_id`` emit ``pad_token_id``
    from then on."""
    if decode_strategy != "greedy_search":
        raise NotImplementedError(f"decode_strategy {decode_strategy!r} is "
                                  "not ported yet; only greedy_search")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    device = resolve_device(device)
    if module_device(model) != device:
        raise ValueError(f"the model is on {module_device(model)}, not on "
                         f"{device}")
    ids = torch.as_tensor(np.asarray(input_ids, dtype=np.int64),
                          device=device)
    if ids.dim() != 2:
        raise ValueError("input_ids must be (batch, prompt_len)")
    B, P = ids.shape
    MAX = P + max_new_tokens
    limit = model.config.max_position_embeddings
    if MAX > limit:
        raise ValueError(
            f"prompt_len + max_new_tokens = {MAX} exceeds the model's "
            f"max_position_embeddings = {limit}")
    slots = parameter_slots(model)
    pvals = [p for _, p in model.named_parameters()]
    cache_dtype = dominant_float_dtype(pvals)
    if dtype is not None:
        cache_dtype = to_dtype(dtype)
        pvals = cast_weights(model, pvals, cache_dtype)
    eos = None if eos_token_id is None else int(eos_token_id)
    apply = build_apply(model, slots)
    pick = build_pick()
    was_training = model.training
    model.eval()
    try:
        caches = [(torch.zeros((B, MAX, nh, d), dtype=cache_dtype,
                               device=device),
                   torch.zeros((B, MAX, nh, d), dtype=cache_dtype,
                               device=device))
                  for nh, d in model.kv_cache_spec()]
        logits, caches = apply(pvals, ids, caches, 0)
        tok, sc = pick(logits[:, -1, :])
        finished = torch.zeros((B,), dtype=torch.bool, device=device) \
            if eos is None else tok == eos
        out_ids, out_sc = [tok], [sc]
        for i in range(max_new_tokens - 1):
            logits, caches = apply(pvals, tok[:, None], caches, P + i)
            nxt, score = pick(logits[:, 0, :])
            nxt = torch.where(finished, pad_token_id, nxt)
            score = torch.where(finished, 0.0, score)
            if eos is not None:
                finished = finished | (nxt == eos)
            tok = nxt
            out_ids.append(nxt)
            out_sc.append(score)
    finally:
        if was_training:
            model.train()
    return torch.stack(out_ids, dim=1), torch.stack(out_sc, dim=1)
