"""Param sharding and the sharded forward (counterpart of
``int8inferenceengine_tpu.parallel.sharding``).

Design: a ``(data, model)`` mesh; the batch is split over ``data``;
conv/fc weights are sharded by OUTPUT channel over ``model``, each layer
computes its local channel slice and all-gathers the activation so the
next layer sees full channels.  Transformer models name other roles
(``Module.tp_roles``): 'col_local' keeps a column shard's output sharded
(head-local attention, a row-parallel consumer), 'row' shards a Linear's
INPUT channels and sums its int32 partial accumulators over the model
group before one requant, and 'expert' splits a ``QuantMoE``'s stacked
experts.  Layers whose channels do not divide the model axis (a 10-class
head), grouped convs and W4A8 Linears stay replicated.

In the JAX package a layer's params are global arrays placed on the mesh,
and ``shard_map`` hands each device its block.  Here every rank is a
process that keeps the WHOLE layer (what ``prepare()``, ``convert()``,
``state_dict`` and ``utils.save`` read, as the JAX package's calibration
reads the global arrays) and, beside it, its own slice of every sharded
buffer (``layer._tp_view``).  ``local_params(module)`` swaps the slices in
for the length of a sharded forward or ``generate()``, so every layer runs
its ordinary code on its shard; the collectives sit where the JAX package
puts them.  A rank therefore holds its model once plus 1/model_size of
every sharded buffer.  The slices are cut again when the whole buffers
they came from change (``Module.load``, ``utils.load``,
``load_state_dict``, a lever, ``convert()``): each layer stamps its
whole buffers when it is sliced, and ``local_params`` slices anew when a
stamp no longer matches.

A spec maps each buffer of a layer to the dimension that the model axis
slices (this rank takes block ``model_index`` of ``model_size`` along it),
to None (replicated), or to ``LOCAL_SUM``: a row-parallel layer's
``rowsum``, recomputed as the sum over this rank's K rows of ``qw``, so
that the summed local corrections reproduce the full offset exactly.
"""

from __future__ import annotations

import contextlib
import weakref

import torch
import torch.distributed as dist

from .context import ParallelAxes, axes, current_axes

# a row-parallel rowsum: the sum over this rank's rows of the weight
LOCAL_SUM = "local_sum"


def _params(layer) -> dict:
    """The layer's buffers that hold a tensor (JAX's ``layer.params``)."""
    return {k: v for k, v in layer._buffers.items() if v is not None}


def layer_param_specs(layer, model_axis: str, model_size: int,
                      role: str = "col") -> dict:
    """The spec of each buffer (see the module docstring); every buffer
    replicated (None) when the layer cannot shard evenly over the model
    axis.  Sets the layer's role flags ``_tp_sharded`` / ``_tp_local`` /
    ``_tp_row`` / ``_tp_expert``.

    ``role`` (from ``Module.tp_roles``): 'col' — output-channel sharding,
    output all-gathered (the default); 'col_local' — the same sharding but
    the output STAYS a channel shard; 'row' — Linear-only input-channel
    sharding, int32 partial accumulators summed over the model group
    before one requant (``Linear._forward_int8_row``); 'expert' — a
    ``QuantMoE``'s [E, ...] stacks split on E.  Roles that do not apply
    fall back to 'col'."""
    from ..layers import Linear
    layer._tp_local = False
    layer._tp_row = False
    layer._tp_expert = False
    layer._tp_sharded = False
    params = _params(layer)
    if role == "expert":
        e = getattr(layer, "n_experts", 0)
        if (e > 0 and model_size > 1 and e % model_size == 0
                and not layer.quant_fallback):
            layer._tp_expert = True
            return {k: (None if k == "router" else 0) for k in params}
        role = "col"                    # -> replicated fallback below
    w4a8 = (isinstance(layer, Linear) and not layer.config.weight_only
            and layer.config.weight_bits == 4)
    if role == "row":
        in_channels = getattr(layer, "in_channels", 0)
        row_ok = (isinstance(layer, Linear) and model_size > 1
                  and in_channels % model_size == 0
                  and not layer.quant_fallback
                  and not layer.config.weight_only
                  and not w4a8)       # W4A8: no integer partials to sum
        if row_ok:
            layer._tp_row = True
            specs = {}
            for k in params:
                if k in ("weight", "qw"):          # [N, K] -> K sharded
                    specs[k] = 1
                elif k == "rowsum":
                    specs[k] = LOCAL_SUM
                else:                              # q_bias/bias/w_scale
                    specs[k] = None
            return specs
        role = "col"
    out_channels = getattr(layer, "out_channels", 0)  # weightless layers
    # Grouped convs tie output channels to input-channel groups; with fully
    # gathered activations their channel shards would need per-shard input
    # slices, so they stay replicated.  W4A8 Linears stay replicated too:
    # the JAX package has no sharding rules for their packed scheme.
    grouped = getattr(layer, "groups", 1) > 1
    shardable = (out_channels > 0 and out_channels % model_size == 0
                 and model_size > 1 and not grouped and not w4a8)
    layer._tp_sharded = shardable
    layer._tp_local = shardable and role == "col_local"
    if not shardable:
        return {k: None for k in params}
    # every buffer of a Linear/Conv2d that leads with the output channels
    # (weight, bias, qw, q_bias, rowsum, w_scale, q_weight, the 4-bit
    # weight-only arrays) shards on that dimension
    return {k: (0 if v.dim() >= 1 and v.shape[0] == out_channels else None)
            for k, v in params.items()}


def module_param_specs(module, model_axis: str, model_size: int) -> dict:
    roles = module.tp_roles(model_size) if hasattr(module, "tp_roles") \
        else {}
    return {
        name: layer_param_specs(layer, model_axis, model_size,
                                role=roles.get(name, "col"))
        for name, layer in module.named_layers()
    }


def _block(t: torch.Tensor, dim: int, index: int, parts: int
           ) -> torch.Tensor:
    """Block ``index`` of ``parts`` along ``dim``, in a fresh contiguous
    allocation (a kernel may require an aligned base address)."""
    size = t.shape[dim] // parts
    return t.narrow(dim, index * size, size).clone(
        memory_format=torch.contiguous_format)


def _local_view(layer, spec: dict, index: int, parts: int) -> dict:
    """The attributes a layer takes while it runs on its shard: its sliced
    buffers, its local channel count and fresh operand caches (which are
    built from the local buffers)."""
    view = {}
    for k, d in spec.items():
        if d is not None and d != LOCAL_SUM:
            view[k] = _block(getattr(layer, k), d, index, parts)
    if any(d == LOCAL_SUM for d in spec.values()):
        view["rowsum"] = view["qw"].to(torch.int32).sum(dim=1,
                                                         dtype=torch.int32)
    if not view:
        return {}
    if layer._tp_expert:
        view["n_experts"] = layer.n_experts // parts
    elif layer._tp_row:
        view["in_channels"] = layer.in_channels // parts
    else:
        view["out_channels"] = layer.out_channels // parts
    view.update(_epilogue_cache={}, _merged_cache={}, _s2d_cache=None)
    return view


def _stamp(layer, spec: dict) -> dict:
    """What the layer's slices were cut from: the names of its buffers,
    and each sliced buffer by weak reference with its version counter
    (None for an inference tensor, which keeps no count)."""
    params = _params(layer)
    return {"names": frozenset(params), "sources": {
        k: (weakref.ref(params[k]),
            None if params[k].is_inference() else params[k]._version)
        for k, d in spec.items() if d is not None and k in params}}


def _stale(module) -> bool:
    """True when a whole buffer that a layer's slices came from was
    replaced, written in place, added or dropped since it was sliced."""
    for _, layer in module.named_layers():
        stamp = layer._tp_stamp
        params = _params(layer)
        if frozenset(params) != stamp["names"]:
            return True
        for k, (ref, version) in stamp["sources"].items():
            v = params[k]
            if ref() is not v or (version is not None
                                  and v._version != version):
                return True
    return False


def shard_module(module, mesh, data_axis: str = "data",
                 model_axis: str = "model", overlap: bool = False) -> None:
    """Slice this rank's shard of every layer and switch the Module to
    the sharded forward.  Call after convert() (or before, for FP32
    serving: ``convert()`` shards again).

    ``overlap=True`` turns on ring tensor parallelism for Linear chains:
    sharded Linears keep their outputs channel-sharded, and a consuming
    sharded Linear runs the ring product (parallel/overlap.py) instead of
    waiting on an all-gather; any other consumer gathers lazily.  Results
    are bit-identical to gather mode (integer partial sums are exact)."""
    if module.device.type != mesh.device.type:
        raise ValueError(f"the model is on {module.device}, the mesh's "
                         f"rank on {mesh.device}")
    data_size = mesh.shape[data_axis]
    model_size = mesh.shape[model_axis]
    index = mesh.coords[model_axis]
    specs = module_param_specs(module, model_axis, model_size)
    for name, layer in module.named_layers():
        layer._tp_view = _local_view(layer, specs[name], index, model_size)
        layer._tp_stamp = _stamp(layer, specs[name])
    module._mesh = mesh
    module._parallel_axes = ParallelAxes(
        data_axis=data_axis, model_axis=model_axis, data_size=data_size,
        model_size=model_size, overlap=overlap,
        data_index=mesh.coords[data_axis], model_index=index,
        data_group=mesh.groups[data_axis],
        model_group=mesh.groups[model_axis])
    module._tp_specs = specs


@contextlib.contextmanager
def local_params(module):
    """Swap every layer's shard (``layer._tp_view``) in for the block;
    the whole layer comes back after it, and the caches the shard built
    stay with the shard.  Shards cut from whole buffers that have changed
    since are cut again first.  Re-entering while bound changes
    nothing."""
    if getattr(module, "_tp_bound", False):
        yield
        return
    if _stale(module):
        pa = module._parallel_axes
        shard_module(module, module._mesh, data_axis=pa.data_axis,
                     model_axis=pa.model_axis, overlap=pa.overlap)
    swapped = []
    module._tp_bound = True
    try:
        for _, layer in module.named_layers():
            view = getattr(layer, "_tp_view", None)
            if view:
                whole = {k: getattr(layer, k, None) for k in view}
                for k, v in view.items():
                    setattr(layer, k, v)
                swapped.append((layer, view, whole))
        yield
    finally:
        for layer, view, whole in swapped:
            for k in view:
                view[k] = getattr(layer, k, None)
            for k, v in whole.items():
                setattr(layer, k, v)
        module._tp_bound = False


@contextlib.contextmanager
def sharded(module):
    """The block runs as this rank of ``module``'s mesh: its shards bound
    and its parallel context active."""
    with local_params(module), axes(module._parallel_axes):
        yield module._parallel_axes


def data_rows(pa: ParallelAxes, b: int, what: str = "batch") -> slice:
    """This rank's rows of a batch of ``b`` split over the data axis."""
    if b % pa.data_size:
        raise ValueError(f"{what} {b} does not split over the data axis of "
                         f"size {pa.data_size}")
    n = b // pa.data_size
    return slice(pa.data_index * n, (pa.data_index + 1) * n)


def sharded_forward(module, t, run):
    """``run(t_local)`` (the Module's unsharded call body) on this rank's
    rows of ``t`` with its shards bound and the TP context active, then
    the rows of every data shard gathered: every rank returns the whole
    output, as JAX's ``out_specs=P(data)`` gives it.  In overlap mode a
    channel-sharded output is gathered once, at exit."""
    from ..tensor import Tensor
    pa = module._parallel_axes
    rows = data_rows(pa, t.data.shape[0])
    local = Tensor(t.data[rows], t.scale, t.zero_point, _nhwc=t._nhwc,
                   _ingest=t._ingest)
    with sharded(module):
        out = run(local)
        data = out.logical_data
        if out._tp_sharded:       # overlap mode: gather once at exit
            data = gather_channels(data, -1)
    data = all_gather_cat(data, pa.data_group, 0)
    return Tensor(data, out.scale, out.zero_point)


# -- collectives --------------------------------------------------------------

def all_gather_cat(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` concatenated on ``axis`` in rank
    order (JAX's tiled ``all_gather``); ``x`` itself without a group."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=axis)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' ``x`` over ``group`` (JAX's ``psum``)."""
    x = x.contiguous()
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def gather_channels(x: torch.Tensor, axis: int) -> torch.Tensor:
    """All-gather a channel-sharded activation over the model axis.

    No-op when no TP context is active."""
    pa = current_axes()
    if pa is None or pa.model_size <= 1:
        return x
    return all_gather_cat(x, pa.model_group, axis)
