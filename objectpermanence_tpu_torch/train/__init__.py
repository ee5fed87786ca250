"""Training entry points of the port."""
