"""Hand-written kernels of the port, each beside its plain version."""
