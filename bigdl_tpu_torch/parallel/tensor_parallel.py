"""Tensor (Megatron) parallelism over a mesh's ``model`` axis (port of
``bigdl_tpu/parallel/tensor_parallel.py``).

The reference declares column/row splits as ``PartitionSpec``s and lets
GSPMD place the shards and insert the collectives.  The port keeps the
declarations (:class:`Spec`, a small value type of its own: one entry a
dim, an axis name or None) and places the shards itself: the ``model``
axis is a device group that the process drives (``parallel/mesh.py``),
and :func:`shard_module` replaces every opted-in parameter by
:class:`Shards`, its equal slices along the split dim, slice r a
``Parameter`` on the group's device r.  Every other parameter and every
buffer goes to the group's first device, the home device, where the
activations between layers live too.

The opted-in layers compute on their shards (``nn.Linear(shard=
"column"|"row")``, ``nn.MultiHeadAttention(shard=True)``): each moves its
input to device r with ``.to``, computes slice r there and moves the
result home.  A column split's slices are concatenated in order; a row
split's partial sums are added at home in rank order, a fixed order, so a
result does not depend on timing.  Autograd carries the backward through
the ``.to`` copies, so no collective needs a backward of its own, and the
same mechanism serves training (``DistriOptimizer(param_specs=)``) and
serving (``ShardedReplicaSet``, ``DecodeService(mesh=)``).  On one card a
group such as ``[cuda:0, cuda:0]`` runs the whole sharded path on the
card, the copies then being no-ops.

The shard layout is placement only: the logical parameter tree stays the
unsharded one, so :func:`logical_tensors` reassembles a placed model's
values under the unsharded names (snapshots, summaries, ``interop``) and
:func:`split_tensors` cuts such values back into slices.  A placed model
is not re-initialised; place a copy of an initialised model.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import torch

AXIS = "model"


class Spec(tuple):
    """How one parameter lies on a mesh (the ``PartitionSpec`` twin): one
    entry a dim, the mesh axis it is split over or None.  ``Spec()``
    (and a spec of Nones) is replicated."""

    def __new__(cls, *axes):
        return tuple.__new__(cls, axes)

    def __repr__(self) -> str:
        return "Spec(" + ", ".join(map(repr, self)) + ")"

    def split_dim(self, axis: str = AXIS) -> Optional[int]:
        """The dim split over ``axis``, or None (replicated on it)."""
        return self.index(axis) if axis in self else None


REPLICATED = Spec()


def column_parallel_linear_specs(with_bias: bool = True, axis: str = AXIS):
    """Split the OUTPUT features: weight (out, in) -> ``Spec(axis,
    None)``, bias ``Spec(axis)``; the activations come out split on the
    feature dim."""
    sp = {"weight": Spec(axis, None)}
    if with_bias:
        sp["bias"] = Spec(axis)
    return sp


def row_parallel_linear_specs(with_bias: bool = True, axis: str = AXIS):
    """Split the INPUT features: weight (out, in) -> ``Spec(None, axis)``;
    the products are partial sums added across the group; bias
    replicated."""
    sp = {"weight": Spec(None, axis)}
    if with_bias:
        sp["bias"] = REPLICATED
    return sp


class Shards(torch.nn.Module):
    """One parameter split into equal slices along ``dim`` over a model
    device group: slice r is the ``Parameter`` named ``str(r)`` on
    ``devices[r]``.  ``spec`` is the declaration it was placed by.

    ``.to()``/``.cpu()``/``.float()`` on a model that holds it apply to
    each slice and leave the slice on its own device: a service that
    moves "the model" to its home device leaves the shards in place."""

    def __init__(self, full: torch.Tensor, dim: int, devices: Sequence,
                 spec: Spec):
        super().__init__()
        m = len(devices)
        if full.shape[dim] % m:
            raise ValueError(f"a dim of {full.shape[dim]} does not split "
                             f"into {m} equal shards")
        self.dim, self.spec = dim, Spec(*spec)
        self.devices = tuple(torch.device(d) for d in devices)
        self.full_shape = tuple(full.shape)
        for r, piece in enumerate(full.detach().chunk(m, dim)):
            self.register_parameter(str(r), torch.nn.Parameter(
                piece.to(self.devices[r], copy=True).contiguous(),
                requires_grad=full.requires_grad))

    def __len__(self) -> int:
        return len(self.devices)

    def __getitem__(self, r: int) -> torch.nn.Parameter:
        return self._parameters[str(r)]

    @property
    def parts(self):
        return [self[r] for r in range(len(self))]

    @property
    def shape(self) -> torch.Size:
        return torch.Size(self.full_shape)

    @torch.no_grad()
    def load_(self, full) -> None:
        """Copy the whole value ``full`` into the slices, in place."""
        full = torch.as_tensor(full)
        if tuple(full.shape) != self.full_shape:
            raise ValueError(f"shape {tuple(full.shape)} does not fit "
                             f"{self.full_shape}")
        for p, piece in zip(self.parts, full.chunk(len(self), self.dim)):
            p.copy_(piece)

    def _apply(self, fn, recurse=True):
        for r, p in enumerate(self.parts):
            with torch.no_grad():
                p.data = fn(p.data).to(self.devices[r])
        return self

    def extra_repr(self) -> str:
        return (f"{self.full_shape}, dim={self.dim}, "
                f"devices={[str(d) for d in self.devices]}")


def _own_specs(module) -> Optional[dict]:
    """What ``module`` declares for its own parameters (a ``Remat``
    declares its inner module's), or None."""
    from bigdl_tpu_torch.nn.module import Remat
    target = module.inner if isinstance(module, Remat) else module
    fn = getattr(target, "param_specs", None)
    return fn() if fn is not None else None


def _join(prefix: str, k: str) -> str:
    return f"{prefix}.{k}" if prefix else k


def named_param_specs(model: torch.nn.Module) -> Dict[str, Spec]:
    """``{parameter name: Spec}`` of ``model``'s (unsharded) parameters:
    what each layer declares (``param_specs()``), replicated where it
    declares nothing.  A placed model's shards answer under their
    logical names."""
    out = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, Shards):
            continue
        own = _own_specs(mod) or {}
        for k, _ in mod.named_parameters(recurse=False):
            out[_join(prefix, k)] = Spec(*own[k]) if k in own else REPLICATED
        for k, c in mod.named_children():
            if isinstance(c, Shards):
                out[_join(prefix, k)] = c.spec
    return out


def build_param_specs(module: torch.nn.Module, params=None) -> dict:
    """The tree of :class:`Spec` over ``module``'s parameters in the
    reference's layout (``interop.jax_tree``: containers keyed by child
    index, ``TimeDistributed``/``Recurrent`` holding their inner module's
    tree as their own), so the opt-ins survive any nesting.  ``params`` is
    accepted for the reference's signature and not read."""
    from bigdl_tpu_torch.interop.jax_weights import jax_tree
    return jax_tree(module, named_param_specs(module), "params")


def _specs_by_name(model, specs) -> Dict[str, Spec]:
    """A spec tree in the reference's layout as ``{parameter name:
    Spec}``."""
    from bigdl_tpu_torch.interop.jax_weights import _jax_names
    names = _jax_names(model, "params")
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
                continue
            key = f"{prefix}{k}"
            if key not in names:
                raise KeyError(f"spec {key!r} has no parameter in "
                               f"{type(model).__name__}")
            out[names[key]] = REPLICATED if v is None else Spec(*v)

    walk(specs, "")
    return out


def shard_module(model: torch.nn.Module, mesh, specs=None
                 ) -> torch.nn.Module:
    """Place ``model`` on ``mesh``'s model device group, in place, and
    return it: every parameter its layer declares split over the
    ``model`` axis becomes :class:`Shards`, every other parameter and
    every buffer moves to the home device.  ``specs`` (a tree of
    :class:`Spec` in the reference's layout, as ``DistriOptimizer`` takes
    it) must agree with the declarations, since a layer computes only on
    the split it declares; a split must divide its dim into equal shards.
    Raises ``ValueError`` otherwise.  A group of one device moves the
    model there whole."""
    devices = mesh.axis_devices("model") if hasattr(mesh, "axis_devices") \
        else getattr(mesh, "devices", None)
    if not devices:
        raise ValueError("shard_module needs a mesh with a model device "
                         "group (create_mesh(model=n, devices=...))")
    home = devices[0]
    declared = named_param_specs(model)
    for name, spec in ({} if specs is None
                       else _specs_by_name(model, specs)).items():
        if spec.split_dim() != declared[name].split_dim():
            raise ValueError(
                f"{name}: spec {spec!r} is not the one its layer declares "
                f"({declared[name]!r}); the port computes only on the "
                f"splits its layers declare")
    with torch.no_grad():
        for prefix, mod in list(model.named_modules()):
            if isinstance(mod, Shards):
                continue
            for k, b in list(mod._buffers.items()):
                if b is not None:
                    mod._buffers[k] = b.to(home)
            for k, p in list(mod._parameters.items()):
                if p is None:
                    continue
                name = _join(prefix, k)
                spec = declared[name]
                dim = spec.split_dim()
                if dim is None or len(devices) == 1:
                    p.data = p.data.to(home)
                    continue
                if p.shape[dim] % len(devices):
                    raise ValueError(
                        f"{name}: dim {dim} of {tuple(p.shape)} does not "
                        f"split over a model axis of {len(devices)}")
                del mod._parameters[k]
                mod.add_module(k, Shards(p, dim, devices, spec))
    return model


def placed_devices(model: torch.nn.Module) -> Optional[tuple]:
    """The model device group ``model`` was placed on, or None."""
    for m in model.modules():
        if isinstance(m, Shards):
            return m.devices
    return None


def _shard_paths(net) -> Dict[str, Shards]:
    return {p: m for p, m in net.named_modules() if isinstance(m, Shards)}


def logical_tensors(net: torch.nn.Module, named: Dict[str, torch.Tensor],
                    device=None) -> Dict[str, torch.Tensor]:
    """Values keyed by ``net``'s parameter names (a placed net's shard
    slices ``<path>.<r>``) keyed by the unsharded names instead, each
    parameter's slices concatenated (detached) on ``device`` (default:
    slice 0's).  Identity for a net without shards."""
    groups = _shard_paths(net)
    if not groups:
        return named
    out = {}
    for name, v in named.items():
        owner = name.rpartition(".")[0]
        if owner not in groups:
            out[name] = v
        elif name == f"{owner}.0":
            sh = groups[owner]
            parts = [named[f"{owner}.{r}"] for r in range(len(sh))]
            dev = device or parts[0].device
            out[owner] = torch.cat([p.detach().to(dev) for p in parts],
                                   sh.dim)
    return out


def split_tensors(net: torch.nn.Module, full: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`logical_tensors`: values keyed by the
    unsharded names keyed by ``net``'s parameter names, a sharded one cut
    into its slices (each on its slice's device)."""
    groups = _shard_paths(net)
    out = {}
    for name, v in full.items():
        sh = groups.get(name)
        if sh is None:
            out[name] = v
            continue
        for r, piece in enumerate(torch.as_tensor(v).chunk(len(sh),
                                                           sh.dim)):
            out[f"{name}.{r}"] = piece.to(sh.devices[r])
    return out


def logical_parameters(net: torch.nn.Module, device=None
                       ) -> Dict[str, torch.Tensor]:
    """``net``'s parameters under their unsharded names (a sharded one
    reassembled and detached)."""
    return logical_tensors(net, dict(net.named_parameters()), device)


# ------------------------------------------------------------ the layers
def column_linear(x: torch.Tensor, weight: Shards,
                  bias: Optional[Shards]) -> torch.Tensor:
    """``x @ W^T + b`` with W (out, in) and b split on the output dim:
    slice r computed on device r, the slices concatenated in order at
    ``x``'s device."""
    home, outs = x.device, []
    for r, dev in enumerate(weight.devices):
        y = x.to(dev) @ weight[r].T
        if bias is not None:
            y = y + bias[r]
        outs.append(y.to(home))
    return torch.cat(outs, -1)


def row_sum(parts: Iterable[torch.Tensor], home) -> torch.Tensor:
    """The partial sums ``parts`` moved to ``home`` and added in rank
    order."""
    out = None
    for p in parts:
        p = p.to(home)
        out = p if out is None else out + p
    return out


def row_linear(x: torch.Tensor, weight: Shards,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ W^T + b`` with W (out, in) split on the input dim: ``x``'s
    matching feature slice goes to device r, the partial products come
    back and are added in rank order; the replicated bias is added
    last."""
    xs = x.chunk(len(weight), -1)
    y = row_sum((xs[r].to(dev) @ weight[r].T
                 for r, dev in enumerate(weight.devices)), x.device)
    return y if bias is None else y + bias


__all__ = ["REPLICATED", "Shards", "Spec", "build_param_specs",
           "column_linear", "column_parallel_linear_specs",
           "logical_parameters", "logical_tensors", "named_param_specs",
           "placed_devices", "row_linear", "row_parallel_linear_specs",
           "row_sum", "shard_module", "split_tensors"]
