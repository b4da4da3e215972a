"""NN substrate of the port (plain dicts of tensors, JAX layouts)."""
