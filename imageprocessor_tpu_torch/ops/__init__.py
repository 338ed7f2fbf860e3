"""Device ops: plain PyTorch versions beside the hand-written CUDA kernels."""
