"""Backend-free helpers of the port (twins of the JAX package's
``utils`` modules that the port needs)."""
