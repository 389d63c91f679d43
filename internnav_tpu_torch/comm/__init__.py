"""The agent server and its HTTP client (the JAX package's `comm/`)."""
