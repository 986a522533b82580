"""The training data pipeline (the port of ``repro.data``)."""
