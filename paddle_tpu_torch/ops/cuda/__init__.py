"""Hand-written CUDA kernels for Hopper (the counterparts of the TPU
package's ``ops/pallas``), built from ``csrc/`` at first use."""
