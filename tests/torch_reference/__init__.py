"""Plain float32 PyTorch references of architectures the JAX package does
not have, for the tests of the port (no import of the port, no kernels)."""
