"""Hand-written kernels, named after the Pallas modules they replace."""
