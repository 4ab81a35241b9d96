"""Serving-side runtime helpers: deterministic fault injection
(`chaos.py`)."""
