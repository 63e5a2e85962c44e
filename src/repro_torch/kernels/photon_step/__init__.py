"""Photon-step kernel: CUDA kernel, host kernel, plain PyTorch version,
dispatcher."""
