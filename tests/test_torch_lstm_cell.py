"""The port's fused LSTM cell (``bigdl_tpu_torch.ops.lstm_cell``) on the CPU,
where it runs its plain versions, against the reference's Pallas cell
(``bigdl_tpu.ops.pallas_lstm.lstm_cell``) run in interpret mode under jit,
as ``tests/test_pallas_kernels.py`` runs it.

Tolerances are the reference test's own: (5, 130) and (1, 64) f32 forward
1e-5, gradients 1e-4; the PTB shape (20, 650) f32 forward 1e-4, gradients
1e-3 (a 650-term f32 dot product summed in another order); (8, 128) bf16
forward 3e-2, gradients 2e-1 (outputs rounded to bf16 on both sides, the
gradients' bf16 casts landing on either side of a rounding boundary).
Each case runs with ``forget_bias`` 0 (PTB) and 1.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu.ops import pallas_lstm  # noqa: E402
from bigdl_tpu_torch.ops import lstm_cell as port  # noqa: E402

CASES = [
    (5, 130, "float32", 1e-5, 1e-4),
    (1, 64, "float32", 1e-5, 1e-4),
    (20, 650, "float32", 1e-4, 1e-3),
    (8, 128, "bfloat16", 3e-2, 2e-1),
]


def _inputs(N, H, seed):
    rng = np.random.default_rng(N * 1000 + H + seed)
    mk = lambda *s: rng.normal(0, 0.5, s).astype(np.float32)  # noqa: E731
    return mk(N, 4 * H), mk(N, H), mk(N, H), mk(H, 4 * H)


def _loss(h, c):
    return (h.astype(jnp.float32) ** 2).sum() \
        + (c.astype(jnp.float32) * 1.5).sum()


@pytest.mark.parametrize("fb", [0.0, 1.0], ids=["fb0", "fb1"])
@pytest.mark.parametrize("N,H,dtype,ftol,gtol", CASES,
                         ids=lambda v: str(v))
def test_cell_matches_pallas_reference(N, H, dtype, ftol, gtol, fb):
    arrays = _inputs(N, H, int(fb))
    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(a).astype(jdt) for a in arrays]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
             for a in arrays]

    def jcell(*a):
        return pallas_lstm.lstm_cell(*a, forget_bias=fb, interpret=True)

    hj, cj = jax.jit(jcell)(*jargs)
    gj = jax.jit(jax.grad(lambda *a: _loss(*jcell(*a)),
                          argnums=(0, 1, 2, 3)))(*jargs)
    before = (port.fwd_launches, port.bwd_launches)
    ht, ct = port.lstm_cell(*targs, forget_bias=fb)
    (ht.float() ** 2 + ct.float() * 1.5).sum().backward()
    # the CPU runs the plain versions: no kernel launched
    assert (port.fwd_launches, port.bwd_launches) == before
    assert ht.dtype == ct.dtype == getattr(torch, dtype)

    def close(t, j, tol, what):
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(j.astype(jnp.float32)),
                                   rtol=tol, atol=tol, err_msg=what)

    close(ht, hj, ftol, "h'")
    close(ct, cj, ftol, "c'")
    for name, t, g in zip(("dzx", "dh", "dc", "dw_t"), targs, gj):
        assert t.grad.dtype == t.dtype
        close(t.grad, g, gtol, name)


@pytest.mark.parametrize("fb", [0.0, 1.0], ids=["fb0", "fb1"])
def test_backward_matches_autograd_of_plain_forward(fb):
    """The hand-derived backward (B2b's formulas plus the two products)
    equals autograd through the plain forward, in f32 (tolerance 1e-5:
    exact formulas of the same function, rounded in another order)."""
    arrays = [torch.from_numpy(a) for a in _inputs(6, 33, 7)]
    a1 = [a.clone().requires_grad_() for a in arrays]
    a2 = [a.clone().requires_grad_() for a in arrays]
    h1, c1 = port.lstm_cell(*a1, forget_bias=fb)
    h2, c2, _ = port.lstm_cell_fwd_reference(*a2, forget_bias=fb)
    for h, c in ((h1, c1), (h2, c2)):
        (h.sin().sum() + (c * c).sum()).backward()
    for x, y in zip(a1, a2):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-5)


def test_reference_forward_emits_f32_z_and_input_dtype_state():
    zx, h, c, w = (torch.from_numpy(a).bfloat16() for a in _inputs(3, 16, 0))
    h2, c2, z = port.lstm_cell_fwd_reference(zx, h, c, w, 0.0)
    assert (h2.dtype, c2.dtype, z.dtype) == (torch.bfloat16,) * 2 \
        + (torch.float32,)
    assert z.shape == (3, 64)
    dz, dcp = port.lstm_cell_bwd_reference(z, c, h2, c2, 0.0)
    assert (dz.dtype, dcp.dtype) == (torch.float32, torch.bfloat16)


def test_kernel_launch_refuses_cpu_tensors():
    zx, h, c, w = (torch.from_numpy(a) for a in _inputs(2, 8, 0))
    with pytest.raises(RuntimeError, match="runs on CUDA"):
        port.launch_fwd(zx, h, c, w)
    with pytest.raises(RuntimeError, match="runs on CUDA"):
        port.launch_bwd(torch.zeros(2, 32), c, h, c)


def test_backward_floor_launch_refuses_cpu_tensors():
    """The empty kernel of B2b's grid (the floor chip_smoke.py measures) is
    a card launch like the backward's: CPU tensors raise."""
    zx, h, c, w = (torch.from_numpy(a) for a in _inputs(2, 8, 0))
    with pytest.raises(RuntimeError, match="runs on CUDA"):
        port.launch_bwd_empty(torch.zeros(2, 32), c, h, c)
