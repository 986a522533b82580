"""The unsharded train step of both packages on ``reduced(deepseek_v3_671b)``
at its published 18432-wide dense FFN, on the CPU: every param element that
misses the JAX step's after 3 steps at rtol 1e-4, atol 1e-6 (the tolerance
of tests/test_torch_parallel.py and tests/test_torch_ep.py, which cut that
width to 128), with its gradient at each step from both packages.

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
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.train import steps
from test_torch_ep import STEP_CFG
from test_torch_train import _batch, _fan_in_scale


def flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def main():
    rcfg = ref_reduced(ref_get_config("deepseek_v3_671b"), dtype="float32")
    ref = ref_build_model(rcfg)
    port = build_model(reduced(get_config("deepseek_v3_671b"),
                               dtype="float32"))
    params = jax.tree.map(
        lambda spec, leaf: np.asarray(leaf, np.float32)
        * np.float32(_fan_in_scale(spec)),
        ref.specs, ref.init(jax.random.key(0)),
        is_leaf=lambda x: isinstance(x, RefParamSpec))
    batches = [_batch(port.cfg, b=4, s=16, seed=10 + i) for i in range(3)]
    rtcfg, tcfg = RefTrainConfig(**STEP_CFG), TrainConfig(**STEP_CFG)

    step = jax.jit(ref_steps.make_train_step(ref, RefParallelConfig(), rtcfg))
    grad = jax.jit(jax.grad(
        lambda p, b: ref_steps.compute_loss(ref, p, b, rtcfg)[0]))
    jp = jax.tree.map(jnp.asarray, params)
    state = ref_steps.TrainState(jp, ref_adamw_init(jp))
    ref_grads = []
    for batch in batches:
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        ref_grads.append(dict(flat(jax.tree.map(np.asarray,
                                                grad(state.params, b)))))
        state, _ = step(state, b)
    want = dict(flat(jax.tree.map(np.asarray, state.params)))

    tp = params_from_numpy(params, "cpu")
    pstate = steps.TrainState(tp, adamw_init(tp))
    pstep = steps.make_train_step(port, ParallelConfig(), tcfg)
    port_grads = []
    for batch in batches:
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        _, g = steps.loss_and_grads(port, pstate.params, b, tcfg)
        port_grads.append({k: v.numpy() for k, v in flat(g)})
        pstate, _ = pstep(pstate, b)
    got = {k: v.detach().numpy() for k, v in flat(pstate.params)}

    print(f"first_dense_d_ff {rcfg.moe.first_dense_d_ff}")
    for k, w in want.items():
        bad = np.abs(got[k] - w) > 1e-6 + 1e-4 * np.abs(w)
        for idx in zip(*np.nonzero(bad)):
            idx = tuple(int(i) for i in idx)
            print(f"{k}{list(idx)} of {w.size}: port "
                  f"{float(got[k][idx])}, jax {float(w[idx])}")
            for i in range(len(batches)):
                print(f"  gradient at step {i + 1}: port "
                      f"{float(port_grads[i][k][idx])}, jax "
                      f"{float(ref_grads[i][k][idx])}")


if __name__ == "__main__":
    main()
