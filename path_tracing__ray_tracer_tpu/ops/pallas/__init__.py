"""Hand-written GPU kernels (Pallas through Triton)."""
