"""Model code of the port: dense GQA, SSM and hybrid decoders for serving
(the port of ``repro.models``; the other families come in later slices)."""
