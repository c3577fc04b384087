"""Models of the port (counterpart of ``paddle_tpu/models``)."""
from .gpt import (GPTConfig, GPTForPretraining, GPTModel, gpt3_125m,
                  gpt3_tiny)

__all__ = ["GPTConfig", "GPTModel", "GPTForPretraining", "gpt3_tiny",
           "gpt3_125m"]
