"""Photon-step kernel: CUDA kernel, plain PyTorch version, dispatcher."""
