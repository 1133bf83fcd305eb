"""Pulse-communication core on one device, chips on a leading axis."""
