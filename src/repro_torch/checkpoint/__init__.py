"""Checkpoint I/O of the port (numpy + torch only)."""
