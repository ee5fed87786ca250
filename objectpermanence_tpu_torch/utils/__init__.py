"""Checkpoints, spans and counters of the port."""
