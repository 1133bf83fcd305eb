"""Selective-SSM scan: the Mamba recurrence over a whole sequence, with
its final state."""
