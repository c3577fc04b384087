"""GPT family (counterpart of ``paddle_tpu/models/gpt.py``): the same
modules, parameter names and init draw order, so that a reference
model's ``named_parameters()`` load here unchanged.

Ported: the plain causal forward and the cached forward that generation
and the serving engine run (fixed-size KV buffers written at ``pos``,
additive prefix mask).  Tensor parallelism, remat, dropout, paged cache
views and the pretraining criterion are not ported yet.
"""
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .. import nn as pnn
from ..device import resolve_device
from ..nn import functional as F
from ..ops.quant_dispatch import QuantizedWeight, quant_matmul
from .generation import GenerationMixin

__all__ = ["GPTConfig", "GPTModel", "GPTForPretraining", "gpt3_tiny",
           "gpt3_125m"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 0        # 0 -> 4*hidden
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5

    def __post_init__(self):
        if not self.intermediate_size:
            self.intermediate_size = 4 * self.hidden_size


def gpt3_tiny(**kw):
    return GPTConfig(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, max_position_embeddings=128,
                     **kw)


def gpt3_125m(**kw):
    return GPTConfig(hidden_size=768, num_hidden_layers=12,
                     num_attention_heads=12, **kw)


class GPTAttention(nn.Module):
    def __init__(self, config):
        super().__init__()
        H = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = H // self.num_heads
        self.qkv_proj = pnn.Linear(H, 3 * H)
        self.out_proj = pnn.Linear(H, H)

    def forward(self, x, cache=None, pos=None):
        B, S, H = x.shape
        qkv = self.qkv_proj(x).reshape(B, S, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if pos is not None:
            return _cached_attention(self.out_proj, q, k, v, cache, pos,
                                     B, S, H)
        # the reference's SDPA, which picks flash for long sequences on a
        # TPU; the port runs the plain math (this path serves parity checks)
        out = F._xla_attention(q, k, v, causal=True)
        return self.out_proj(out.reshape(B, S, H))


def _decode_position_ids(p, S, device):
    """Absolute positions of this chunk: an int ``pos`` yields (S,) shared
    across the batch; a per-row (B,) tensor (the serving engine's per-slot
    offsets) yields (B, S)."""
    ar = torch.arange(S, device=device)
    if torch.is_tensor(p) and p.dim():
        return p[:, None].long() + ar
    return int(p) + ar


def _cached_attention(out_proj, q, k, v, cache, pos, B, S, H):
    """Fixed-buffer KV attention: k/v land at ``pos`` in the (B, MAX, nH,
    D) buffers, and queries at pos..pos+S-1 attend to the positions at or
    before theirs through an additive mask.  The buffers are written in
    place (the reference returns updated copies); returns (out, (k_buf,
    v_buf))."""
    k_buf, v_buf = cache
    MAX = k_buf.shape[1]
    if torch.is_tensor(pos) and pos.dim():
        idx = _decode_position_ids(pos, S, k_buf.device)           # (B, S)
        rows = torch.arange(B, device=k_buf.device)[:, None]
        k_buf[rows, idx] = k.to(k_buf.dtype)
        v_buf[rows, idx] = v.to(v_buf.dtype)
    else:
        p = int(pos)
        k_buf[:, p:p + S] = k.to(k_buf.dtype)
        v_buf[:, p:p + S] = v.to(v_buf.dtype)
    qpos = _decode_position_ids(pos, S, k_buf.device)   # (S,) or (B, S)
    valid = torch.arange(MAX, device=k_buf.device) <= qpos[..., None]
    m = torch.where(valid, 0.0, -1e30)                  # fp32
    # (1,1,S,MAX) for a shared pos; (B,1,S,MAX) for per-row pos
    m = m[None, None] if m.dim() == 2 else m[:, None]
    out = F._xla_attention(q, k_buf, v_buf, mask=m)
    return out_proj(out.reshape(B, S, H)), (k_buf, v_buf)


def _cached_block(ln1, attn, ln2, ffn, x, cache, pos):
    """One decode step of a pre-LN block: cached attention + FFN with
    residuals."""
    a, cache = attn(ln1(x), cache=cache, pos=pos)
    x = x + a
    x = x + ffn(ln2(x))
    return x, cache


def _cached_layers(layers, caches, pos, x, final_norm):
    """Thread per-layer KV caches through the block stack and apply the
    final norm."""
    new_caches = []
    for blk, cache in zip(layers, caches):
        x, cache = blk(x, cache=cache, pos=pos)
        new_caches.append(cache)
    return final_norm(x), new_caches


class GPTMLP(nn.Module):
    def __init__(self, config):
        super().__init__()
        H, I = config.hidden_size, config.intermediate_size
        self.up = pnn.Linear(H, I)
        self.down = pnn.Linear(I, H)

    def forward(self, x):
        return self.down(F.gelu(self.up(x), approximate=True))


class GPTDecoderLayer(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.ln1 = pnn.LayerNorm(config.hidden_size,
                                 epsilon=config.layer_norm_epsilon)
        self.attn = GPTAttention(config)
        self.ln2 = pnn.LayerNorm(config.hidden_size,
                                 epsilon=config.layer_norm_epsilon)
        self.mlp = GPTMLP(config)

    def forward(self, x, cache=None, pos=None):
        if pos is not None:
            return _cached_block(self.ln1, self.attn, self.ln2, self.mlp,
                                 x, cache, pos)
        x = x + self.attn(self.ln1(x))
        x = x + self.mlp(self.ln2(x))
        return x


class GPTEmbeddings(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.word_embeddings = pnn.Embedding(config.vocab_size,
                                             config.hidden_size)
        self.position_embeddings = pnn.Embedding(
            config.max_position_embeddings, config.hidden_size)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        return self.word_embeddings(input_ids) + \
            self.position_embeddings(position_ids)


class GPTModel(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        self.embeddings = GPTEmbeddings(config)
        self.layers = nn.ModuleList(
            [GPTDecoderLayer(config)
             for _ in range(config.num_hidden_layers)])
        self.final_norm = pnn.LayerNorm(config.hidden_size,
                                        epsilon=config.layer_norm_epsilon)

    def forward(self, input_ids, position_ids=None, caches=None, pos=None):
        if pos is not None:
            position_ids = _decode_position_ids(pos, input_ids.shape[1],
                                                input_ids.device)
            x = self.embeddings(input_ids, position_ids)
            return _cached_layers(self.layers, caches, pos, x,
                                  self.final_norm)
        x = self.embeddings(input_ids, position_ids)
        for blk in self.layers:
            x = blk(x)
        return self.final_norm(x)


@torch.no_grad()
def _init_gpt_weights(root, std):
    """normal(0, initializer_range) for matmul/embedding weights, zero
    biases, ones for norm scales — the reference's scheme with the same
    numpy ``RandomState(0)`` draws in the same order, so both packages
    start from equal weights."""
    rng = np.random.RandomState(0)
    for name, p in root.named_parameters():
        shape = tuple(p.shape)
        if name.endswith("bias") or len(shape) == 0:
            p.zero_()
        elif len(shape) == 1:
            if "norm" in name or name.endswith(".weight") and \
                    "embedding" not in name:
                p.fill_(1.0)
        else:
            p.copy_(torch.from_numpy(
                rng.normal(0.0, std, shape).astype("float32")))


class GPTForPretraining(nn.Module, GenerationMixin):
    """LM head tied to the input embedding (the tie is literal reuse).

    ``device=None`` puts the model on the current CUDA device and raises
    when there is none; pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, config, device=None):
        super().__init__()
        if config.hidden_dropout_prob or config.attention_probs_dropout_prob:
            raise NotImplementedError("dropout is not ported yet; the "
                                      "port's GPT runs with dropout 0")
        device = resolve_device(device)
        self.gpt = GPTModel(config)
        self.config = config
        _init_gpt_weights(self, config.initializer_range)
        self.to(device)

    @property
    def tied_lm_head(self):
        """The vocab embedding doubling as the LM head.
        ``generation.quantize_weights`` narrows it TRANSPOSED, so that one
        narrow copy serves the head matmul and the input gather."""
        return self.gpt.embeddings.word_embeddings.weight

    def _head(self, x, w):
        if isinstance(w, QuantizedWeight):
            return quant_matmul(x, w, out_dtype=x.dtype)
        return x @ w.T

    def forward(self, input_ids, position_ids=None, caches=None, pos=None):
        w = self.gpt.embeddings.word_embeddings.weight
        if pos is not None:
            x, caches = self.gpt(input_ids, caches=caches, pos=pos)
            return self._head(x, w), caches
        x = self.gpt(input_ids, position_ids)
        return self._head(x, w)
