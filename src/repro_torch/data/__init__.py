"""Deterministic, stateless data pipeline (numpy only)."""
