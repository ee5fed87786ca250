"""Video frames whose int16 boxes reached the host, over the seconds from
the window's first call to its last batch on the host."""

from benchmark.readers import frames_per_s as read  # noqa: F401
