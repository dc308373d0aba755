"""Observability of the port (so far: per-request span tracing)."""
