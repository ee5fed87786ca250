"""Inference entry points of the port."""
