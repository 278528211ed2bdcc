"""A batch of ``solver="xla"`` worlds: the port against ``jax.vmap`` on the CPU.

JAX has no vmap rule for the xla branch, so ``jax.vmap(physics_step)``
batches the per-env code op by op (dense member narrowphase, the colored
phases). The port's batched ``physics_step`` routes an xla model to the
per-env step with the phase solves; it used to run the fused sweep, which
fails this test on the stacked boxes. 3 worlds of each fixture of
test_torch_xla_step.py, 2 steps, state and diagnostics within 2e-4 and
feature ids exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evomotion_tpu.physics.engine import init_state, physics_step
from evomotion_tpu_torch import convert
from evomotion_tpu_torch.physics import engine as tengine
from test_torch_perenv_step import ATOL, DT
from test_torch_step import perturbed_states
from test_torch_xla_step import FIXTURES


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_batched_xla_matches_jax_vmap(name):
    """3 worlds of a contact model with solver="xla": the port's batched
    ``physics_step`` against ``jax.vmap(physics_step)``, 2 steps."""
    model = FIXTURES[name]()
    n = 3
    st = perturbed_states(model, n, seed=7, scale=0.01)
    ns = model.n_slider
    tgt = (np.random.default_rng(5).normal(size=(n, ns)) * 0.5).astype(np.float32)
    en = np.ones((n, ns), bool)
    step_v = jax.jit(jax.vmap(lambda s, t, e: physics_step(model, s, t, e, DT)))
    sj = type(init_state(model))(**{f: jnp.asarray(v) for f, v in st.items()})
    tmodel = convert.model_from_arrays(model)
    sp = convert.physics_state(st, "cpu")
    for i in range(2):
        sj, dj = step_v(sj, jnp.asarray(tgt), jnp.asarray(en))
        sp, dp = tengine.physics_step(tmodel, sp, torch.as_tensor(tgt), torch.as_tensor(en), DT)
        for f in ("pos", "quat", "lin_vel", "ang_vel", "contact_lambda", "joint_lambda",
                  "dyn_lambda"):
            np.testing.assert_allclose(getattr(sp, f).numpy(), np.asarray(getattr(sj, f)),
                                       atol=ATOL, rtol=0, err_msg=f"step {i} {f}")
        for f in ("contact_vid", "dyn_vid"):
            np.testing.assert_array_equal(getattr(sp, f).numpy(), np.asarray(getattr(sj, f)))
        for f in dj._fields:
            np.testing.assert_allclose(getattr(dp, f).numpy(), np.asarray(getattr(dj, f)),
                                       atol=ATOL, rtol=0, err_msg=f"step {i} {f}")
