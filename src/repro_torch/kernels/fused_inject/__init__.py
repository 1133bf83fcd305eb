"""Fused inject kernel: route, admit and flush-pack a superstep block."""
