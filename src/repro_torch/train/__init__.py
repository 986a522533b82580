"""Training steps of the port (the port of ``repro.train``)."""
