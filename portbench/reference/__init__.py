"""Plain forward passes of the benchmark's model families, one module each
(``reference/<family>.py``), in fp32 PyTorch with TF32 off.

A family module gives `layout(cfg)`, the weights a configuration of the
family has (a name path, a shape, a dtype and how the benchmark draws
them), and `logits(cfg, params, seqs, wanted, mm)`, the logits at the
`wanted` positions of each token sequence in `seqs`, computed from the
weights alone with every product through `mm` (``ops.exact`` or a lower
precision for the control).  It imports nothing of the program: it works
the cache and the state out again from the prompts and the weights.
"""
