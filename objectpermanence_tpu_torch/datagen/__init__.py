"""Dataset generation of the port (the parts its other modules need)."""
