"""Checkpoint store of the port (service pool snapshots)."""
