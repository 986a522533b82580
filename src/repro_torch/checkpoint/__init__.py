"""Checkpoints of the trainer's state (the port of ``repro.checkpoint``)."""
