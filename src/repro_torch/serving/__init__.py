"""LM serving on the pilot substrate (see repro_torch.serving.engine)."""
from repro_torch.serving.engine import (ServeRequest, ServingEngine,
                                        sample_tokens, splice_row)

__all__ = ["ServingEngine", "ServeRequest", "sample_tokens", "splice_row"]
