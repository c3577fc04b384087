"""Linear and Embedding layers (counterpart of
``paddle_tpu/nn/layer/common.py``), with Paddle's parameter names and
layouts.  Parameters start at zero; the model that owns a layer fills
them with its own init scheme (the reference's per-layer default
initializers are not ported)."""
import torch
from torch import nn

from .. import functional as F

__all__ = ["Linear", "Embedding"]


class Linear(nn.Module):
    """``weight`` is (in_features, out_features), Paddle's layout."""

    def __init__(self, in_features, out_features):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.weight.shape[0]}, "
                f"out_features={self.weight.shape[1]}")


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None):
        super().__init__()
        self._padding_idx = padding_idx
        self.weight = nn.Parameter(torch.zeros(num_embeddings,
                                               embedding_dim))

    def forward(self, x):
        return F.embedding(x, self.weight, self._padding_idx)
