"""Rooflines of the port on an NVIDIA H100 (the port of ``repro.roofline``)."""
