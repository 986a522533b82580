"""Optimizer of the port: AdamW with fp32, bf16 or int8 state, its LR
schedule and the blockwise quantization of the int8 state."""
