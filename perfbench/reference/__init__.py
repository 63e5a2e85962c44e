"""The plain reference: the port's step, RNG and sources, frozen."""
