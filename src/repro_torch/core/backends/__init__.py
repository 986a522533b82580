from repro_torch.core.backends.base import ComputeBackend, get_backend
from repro_torch.core.backends.inprocess import InProcessBackend
from repro_torch.core.backends.simulated import SimulatedClusterBackend
