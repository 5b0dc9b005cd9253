"""Paged continuous-batching serving runtime."""
