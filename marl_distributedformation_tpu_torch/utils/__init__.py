"""Checkpoint reading and configuration parsing."""
