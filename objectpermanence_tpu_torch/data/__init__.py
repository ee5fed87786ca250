"""Data ingest and fixtures of the port."""
