"""Fused drain kernel: merge and ring deposit of a superstep block."""
