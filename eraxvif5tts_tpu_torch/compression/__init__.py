"""Checkpoint conversion for the port."""
