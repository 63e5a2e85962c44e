"""PyTorch/CUDA port of the Monte Carlo photon transport engine.

Laid out like the JAX package ``repro`` (the reference, which this
package never imports): ``core/`` holds the volume, RNG, photon physics,
simulator and analysis; ``sources/`` the photon sources;
``kernels/photon_step/`` the hand-written CUDA and host (C++) photon-step
kernels with their plain PyTorch version; ``launch/simulate.py`` the
CLI.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU the round executor is the host kernel.
"""
