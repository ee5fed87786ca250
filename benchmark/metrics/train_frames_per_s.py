"""Frames trained on (steps x batch x frames) over the window, which ends
in a synchronise."""

from benchmark.readers import frames_per_s as read  # noqa: F401
