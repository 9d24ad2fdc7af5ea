"""Field math and device kernels: GF(2^8) host math, GF(2) bit-matrix
kernels (CUDA on the card, plain PyTorch on the CPU)."""
