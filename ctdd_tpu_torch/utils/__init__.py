"""Checkpoint bookkeeping of the port."""
