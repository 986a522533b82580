"""The unsharded train step of both packages on ``reduced(deepseek_v3_671b)``
at its published 18432-wide dense FFN, on the CPU, in float32 and then in
float64: how far the port's params lie from the JAX step's after 3 steps
(the element count outside rtol 1e-4, atol 1e-6, the tolerance of
tests/test_torch_parallel.py and tests/test_torch_ep.py, which cut that
width to 128; the largest absolute and relative differences).

In float64 (JAX in x64 mode, and every float32 cast of both packages --
the norms', the router's, the loss's, AdamW's moments -- made a float64
one) the two steps agree to about 1e-15 in absolute terms: the float32
misses are the order of float32 sums, not a fault of the port.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_dense_width_probe.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import ParallelConfig as RefParallelConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.configs.base import reduced as ref_reduced
from repro.models.common import ParamSpec as RefParamSpec
from repro.models.model import build_model as ref_build_model
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.train import steps as ref_steps
from repro_torch.carry import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, TrainConfig, reduced
from repro_torch.models.common import tree_leaves
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.train import steps
from test_torch_ep import STEP_CFG
from test_torch_train import _batch, _fan_in_scale


def compare(dtype: str) -> None:
    npdt = np.dtype(dtype).type
    rcfg = ref_reduced(ref_get_config("deepseek_v3_671b"), dtype=dtype)
    ref = ref_build_model(rcfg)
    port = build_model(reduced(get_config("deepseek_v3_671b"), dtype=dtype))
    params = jax.tree.map(
        lambda spec, leaf: np.asarray(leaf, np.float32).astype(npdt)
        * npdt(_fan_in_scale(spec)),
        ref.specs, ref.init(jax.random.key(0)),
        is_leaf=lambda x: isinstance(x, RefParamSpec))
    batches = [_batch(port.cfg, b=4, s=16, seed=10 + i) for i in range(3)]

    step = jax.jit(ref_steps.make_train_step(ref, RefParallelConfig(),
                                             RefTrainConfig(**STEP_CFG)))
    jp = jax.tree.map(jnp.asarray, params)
    state = ref_steps.TrainState(jp, ref_adamw_init(jp))
    for batch in batches:
        state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    want = [np.asarray(x) for x in jax.tree.leaves(state.params)]

    tp = params_from_numpy(params, "cpu")
    pstate = steps.TrainState(tp, adamw_init(tp))
    pstep = steps.make_train_step(port, ParallelConfig(),
                                  TrainConfig(**STEP_CFG))
    for batch in batches:
        pstate, _ = pstep(pstate, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    got = [t.detach().numpy() for t in tree_leaves(pstate.params)]

    diff = [np.abs(g - w) for g, w in zip(got, want)]
    off = sum(int(np.sum(d > 1e-6 + 1e-4 * np.abs(w)))
              for d, w in zip(diff, want))
    print(f"{dtype}: first_dense_d_ff {rcfg.moe.first_dense_d_ff}, params "
          f"{sorted({str(g.dtype) for g in got})}; outside rtol 1e-4, atol "
          f"1e-6: {off} of {sum(w.size for w in want)}; largest difference "
          f"{max(float(d.max()) for d in diff):.3e} absolute, "
          f"{max(float(np.max(d / (np.abs(w) + 1e-30))) for d, w in zip(diff, want)):.3e} "
          f"relative")


def main():
    compare("float32")
    # every float32 cast of both packages becomes a float64 one (the
    # float32 steps above are traced and run already)
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    torch.float32 = torch.float64
    torch.Tensor.float = torch.Tensor.double
    compare("float64")


if __name__ == "__main__":
    main()
