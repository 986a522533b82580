"""The general code of the benchmark; see ``portbench/__init__.py``."""
