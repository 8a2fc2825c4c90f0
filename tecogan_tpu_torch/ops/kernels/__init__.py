"""Hand-written CUDA kernels for Hopper (sources under ``csrc/``), each
beside its plain PyTorch version."""
