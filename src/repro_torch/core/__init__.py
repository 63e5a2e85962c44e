"""Core engine: volumes, RNG, photon physics, simulator, analysis."""
