"""Hand-written Hopper kernels of the port, one directory each: the
kernel's source and its wrapper, an ``ops.py`` dispatcher and a
``ref.py`` plain PyTorch version of the same function.

The kernels are forward-only (the JAX package has no backward kernel
either): a launch fills its output through a raw pointer, which leaves no
autograd history.  So each ``*_op`` refuses, on every route, a tensor
argument that requires grad while grad mode is on (`refuse_autograd`):
on the CPU the plain version would be differentiable, and a caller that
trained through it would lose its gradients silently on the card."""
import torch


def refuse_autograd(op: str, *tensors) -> None:
    """Raise if grad mode is on and any of `tensors` requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op} is forward-only: its kernel records no autograd history, "
            f"so a gradient would be lost on the card; call it under "
            f"torch.no_grad() or torch.inference_mode(), or train through "
            f"the model's training route (train=True)")


def is_abstract(t: torch.Tensor) -> bool:
    """A tensor with a shape and no data: fake (``FakeTensorMode``) or on
    the meta device.  The dispatchers plan a call on one (an empty output
    of the kernel's shape, its cost charged to ``roofline.op_cost``)."""
    from torch._subclasses.fake_tensor import is_fake
    return t.device.type == "meta" or is_fake(t)
