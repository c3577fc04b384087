"""Kernel dispatch of the port (counterpart of ``paddle_tpu/ops``)."""
