"""repro_torch: the Pilot-Abstraction system in PyTorch, for an NVIDIA H100.

The port of the JAX package ``repro`` (which stays as the reference).
``repro_torch.core`` holds the Pilot-API substrate and the KMeans main
path; ``repro_torch.kernels`` the hand-written Hopper kernels;
``repro_torch.carry`` moves state across from plain numpy arrays.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
