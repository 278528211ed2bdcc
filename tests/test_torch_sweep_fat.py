"""The fat-row sweep's plain version against the JAX package's Pallas kernel.

Random fat rows of all three kinds (joint, contact normal, friction with a
live parent), with and without a static body B, and a normal-only row set
(the split-impulse pass), go through ``solver_sweep`` of the JAX package
(interpret mode, as its own tests run it, B = one 1,024-env tile) and of the
port (CPU tensors -> the plain version), over 3 solver iterations, at 1e-5.

The CUDA kernel itself is held against this plain version on the card by
chip_smoke.py and by test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evomotion_tpu.physics import solver_pallas as jsp
from evomotion_tpu_torch.kernels import sweep_fat as tsf
from test_torch_gpu import random_fat_rows

B = jsp.TILE  # the JAX kernel's env tile


@pytest.mark.parametrize("push", [False, True], ids=["full", "push"])
def test_plain_fat_sweep_matches_jax_kernel(push):
    rows, vel6, lam0, meta = random_fat_rows(0, B, push=push)
    ia, ib, parent, mu, kind, skip = meta
    jv, jl = jsp.solver_sweep(
        jnp.asarray(rows), jnp.asarray(vel6), jnp.asarray(lam0), ia, ib, parent, mu, 3,
        kind=kind, skip_b=skip, interpret=True,
    )
    m = tsf.make_fat_meta(ia, ib, parent, mu, kind, skip, "cpu")
    tv, tl = tsf.solver_sweep(torch.as_tensor(rows), torch.as_tensor(vel6),
                              torch.as_tensor(lam0), m, 3)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0, err_msg="vel6")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0, err_msg="lam")
    # every row did work
    assert (np.abs(tl.numpy() - lam0) > 1e-3).mean() > 0.5


def test_fat_sweep_wrapper_rejects_bad_inputs():
    rows, vel6, lam0, meta = random_fat_rows(1, 4)
    m = tsf.make_fat_meta(*meta, "cpu")
    args = [torch.as_tensor(x) for x in (rows, vel6, lam0)]
    with pytest.raises(TypeError):
        tsf.solver_sweep(args[0].double(), *args[1:], m, 1)
    with pytest.raises(ValueError):
        tsf.solver_sweep(args[0][:, :, :27], *args[1:], m, 1)
    with pytest.raises(ValueError):
        tsf.solver_sweep(args[0], args[1], args[2][:, :-1], m, 1)
    with pytest.raises(ValueError):
        tsf.solver_sweep(args[0].transpose(0, 1).contiguous().transpose(0, 1), *args[1:], m, 1)
    with pytest.raises(NotImplementedError):
        tsf.solver_sweep(*args, m, 1, groups=((0, 1),))
    before = tsf.KERNEL.launches
    tsf.solver_sweep(*args, m, 1)  # CPU: plain version, no launch
    assert tsf.KERNEL.launches == before
