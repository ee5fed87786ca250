"""The port's native (C++) ingest library, built with g++ at first use and
loaded with ctypes (`native/build.py`)."""
