"""Ring attention: attention over a sequence split on the mesh's ``seq``
axis (port of ``bigdl_tpu/parallel/ring_attention.py``).

The sequence of (B, H, T, D) queries, keys and values is cut into the
``seq`` group's p chunks of T/p positions, chunk r on device r of the group
(this process's ``mesh.axis_devices("seq")``; ``["cpu"] * p`` in the
tests, ``[cuda:0] * p`` on one card).  Each rank keeps the online-softmax
statistics of its queries (running max ``m``, normalizer ``l``,
unnormalized f32 output ``o``) and attends first to its own keys and
values, then p - 1 times to the chunk that arrives from the previous rank
(the rotation copies every rank's K/V to the next device of the group), so
at step s rank r holds the chunk of rank (r - s) mod p.  The causal mask
is built from global positions.  The ranks' outputs, ``o / max(l,
1e-30)`` in the queries' dtype, are gathered back onto the home device
(the group's first) in sequence order.

The products stay ``torch`` einsums, as the reference leaves them to XLA:
no hand-written kernel runs here.  Autograd runs through the loop and the
copies.  The batch rows are this process's (the ``data`` axis is the
process group), so ``batch_axis`` names an axis and splits nothing.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.parallel.mesh import AXES


def _block(q, k, v, m, l, o, scale, mask):
    """One online-softmax accumulation: ``q`` (B, H, Tq, D), ``k``/``v``
    (B, H, Tk, D), ``m``/``l`` (B, H, Tq) f32, ``o`` (B, H, Tq, D) f32,
    ``mask`` (Tq, Tk) bool, True to attend.  A row with no key yet keeps
    ``m = -inf`` and gives ``alpha = 0`` (torch's ``exp(-inf - -inf)`` is
    NaN, so the guard is a ``where``, as in the reference)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    s = torch.where(mask, s, -torch.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
    p = torch.exp(s - m_new[..., None])
    p = torch.where(mask, p, 0.0)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
    return m_new, l_new, o_new


def _mask(r, src, tl, causal, device):
    """(tl, tl) bool: which keys of rank ``src``'s chunk the queries of
    rank ``r``'s may attend to, by global position."""
    if not causal:
        return torch.ones((tl, tl), dtype=torch.bool, device=device)
    pos = torch.arange(tl, device=device)
    return (r * tl + pos)[:, None] >= (src * tl + pos)[None, :]


def ring_attention(q, k, v, mesh, *, seq_axis: str = "seq",
                   batch_axis: str = "data", causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel softmax attention of (B, H, T, D) ``q``, ``k``,
    ``v`` over ``mesh``'s ``seq_axis`` group; T must split into the
    group's chunks.  Returns (B, H, T, D) in ``q``'s dtype on the group's
    first device.  ``scale`` defaults to ``1 / sqrt(D)``."""
    if seq_axis not in AXES[1:] or batch_axis not in AXES:
        raise ValueError(f"mesh axes are {AXES}; seq_axis {seq_axis!r} "
                         f"must be a device axis, batch_axis "
                         f"{batch_axis!r} one of them")
    group = mesh.axis_devices(seq_axis)
    if group is None:
        raise ValueError("ring_attention needs a mesh with a device group "
                         "(create_mesh(seq=n, devices=...))")
    p_size = len(group)
    B, H, T, D = q.shape
    if T % p_size:
        raise ValueError(f"a sequence of {T} does not split over a "
                         f"{seq_axis!r} axis of {p_size}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    tl = T // p_size
    qs, ks, vs = ([t[:, :, r * tl:(r + 1) * tl].to(group[r])
                   for r in range(p_size)] for t in (q, k, v))
    state = []
    for r, dev in enumerate(group):
        m = torch.full((B, H, tl), -torch.inf, device=dev)
        state.append((m, torch.zeros((B, H, tl), device=dev),
                      torch.zeros((B, H, tl, D), device=dev)))
    for step in range(p_size):
        if step:  # rank r hands its chunk to rank r + 1
            ks = [ks[r - 1].to(group[r]) for r in range(p_size)]
            vs = [vs[r - 1].to(group[r]) for r in range(p_size)]
        for r, dev in enumerate(group):
            mask = _mask(r, (r - step) % p_size, tl, causal, dev)
            state[r] = _block(qs[r], ks[r], vs[r], *state[r], scale, mask)
    home = group[0]
    return torch.cat([(o / torch.clamp(l[..., None], min=1e-30))
                      .to(q.dtype).to(home) for _, l, o in state], dim=2)
