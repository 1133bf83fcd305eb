"""Optimizer and learning-rate schedules of the trainer (``repro.optim``
without its cross-device parts: ``compression`` and the ZeRO-1 moment
specs come with ``models/sharding.py``)."""
