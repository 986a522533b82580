"""Optimizer of the port: AdamW with fp32, bf16 or int8 state, its LR
schedule, the blockwise quantization of the int8 state, and the
error-feedback int8 gradient mean over a mesh's pod axis
(``compression``)."""
