"""`MetaTrace`, the dispatch mode under which the port runs steps on meta
tensors: it counts FLOPs as `torch.utils.flop_counter.FlopCounterMode`
does, and answers a repeated pure op from a cache.

Most meta functions are Python (the `torch._refs` decompositions), and a
step loops over kv chunks or the sequence hundreds of thousands of times. A pure op's meta outputs are a function of
its inputs' shapes, strides, dtypes and devices and its other arguments,
so the mode keeps them, with the op's FLOPs, under that key and returns
fresh meta tensors of the kept shapes on a repeat instead of running the
meta function again. tests/test_torch_launch.py holds its FLOPs
to FlopCounterMode's and its outputs to an uncached trace.

`CollectiveCounter` is the dispatch mode of the collective trace: it sees
each collective that a sharded step (DTensor) issues on one rank and adds
up, by the JAX package's HLO kind, the bytes of the output that the rank
holds, the quantity the JAX dry-run's `collective_bytes` sums from the
per-device shapes of the compiled HLO. (`CommDebugMode` counts calls, not
bytes; tests/test_torch_collectives.py holds the two counts of calls
together.)
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.memory_format, torch.layout)
_CIA = torch._C.DispatchKey.CompositeImplicitAutograd


class _Uncached(Exception):
    pass


def _sig(x):
    """What a pure op's output shapes can depend on, hashable."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device)
    if isinstance(x, (list, tuple)):
        return (type(x),) + tuple(_sig(v) for v in x)
    if isinstance(x, _SCALARS):
        return x
    raise _Uncached


class MetaTrace(TorchDispatchMode):
    """Dispatch mode of the meta trace: FLOPs by op as FlopCounterMode
    counts them (`flops`), and a cache of pure ops on meta tensors.

    An op is pure when its schema lets it neither write nor alias an input
    or an output; its meta outputs are then a function of its inputs'
    shapes, strides, dtypes and devices and its other arguments. A repeat
    of such a call returns fresh meta tensors of the recorded shapes and
    adds the recorded FLOPs (those of its decomposition too) without
    running the meta function. Views and in-place ops always run. An op on
    DTensors is let through to DTensor, and the mode sees the ops on the
    local meta shards that it lowers to."""

    def __init__(self):
        super().__init__()
        self.flops = {}
        self.calls = self.hits = 0
        self._cache = {}
        self._ops = {}

    def _op(self, func):
        info = self._ops.get(func)
        if info is None:
            sch = func._schema
            pure = not any(a.alias_info is not None for a in sch.arguments) and \
                not any(r.alias_info is not None for r in sch.returns)
            formula = flop_registry.get(func._overloadpacket)
            # FlopCounterMode decomposes an op it has no formula for
            decomposes = (formula is None and func is not torch.ops.prim.device.default
                          and torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), _CIA))
            info = self._ops[func] = (pure, decomposes, formula)
        return info

    def _add(self, flops):
        for k, v in flops:
            self.flops[k] = self.flops.get(k, 0) + v

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is not torch.Tensor and issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        self.calls += 1
        pure, decomposes, formula = self._op(func)
        key = None
        if pure:
            try:
                key = (func, _sig(args), _sig(tuple(sorted(kwargs.items()))))
            except _Uncached:
                key = None
        if key is not None:
            hit = self._cache.get(key)
            if hit is not None:
                self.hits += 1
                metas, flops, is_tuple = hit
                self._add(flops)
                out = [torch.empty_strided(s, st, dtype=d, device="meta") for s, st, d in metas]
                return tuple(out) if is_tuple else out[0]
            before = dict(self.flops)
        out = NotImplemented
        if decomposes:
            with self:
                out = func.decompose(*args, **kwargs)
        if out is NotImplemented:
            out = func(*args, **kwargs)
            if formula is not None:
                self._add([(func._overloadpacket, formula(*args, **kwargs, out_val=out))])
        if key is not None:
            outs = out if isinstance(out, tuple) else (out,)
            if all(isinstance(o, torch.Tensor) and o.device.type == "meta" for o in outs):
                delta = [(k, v - before.get(k, 0)) for k, v in self.flops.items()
                         if v != before.get(k, 0)]
                self._cache[key] = ([(o.shape, o.stride(), o.dtype) for o in outs], delta,
                                    isinstance(out, tuple))
        return out


# collective op -> the JAX package's HLO kind; any other collective is
# recorded under its own name
JAX_KIND = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd", "mesh_get_process_group",
                    "check_for_nan"}


def _out_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_out_bytes(o) for o in out)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives one rank issues (module docstring):
    `bytes_by_kind` and `calls_by_kind` under the JAX HLO kinds
    (all-gather, all-reduce, reduce-scatter, all-to-all), any other
    collective under its own op name. A DTensor op is let through to
    DTensor, so the mode sees the collectives it lowers to."""

    def __init__(self):
        super().__init__()
        self.bytes_by_kind = {}
        self.calls_by_kind = {}

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is not torch.Tensor and issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        ns = getattr(func, "namespace", None)
        name = getattr(func, "_opname", None) or str(func)
        if ns in _COLLECTIVE_NAMESPACES and name not in _NOT_COLLECTIVES:
            kind = JAX_KIND.get(name, f"{ns}::{name}")
            self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + _out_bytes(out)
            self.calls_by_kind[kind] = self.calls_by_kind.get(kind, 0) + 1
        return out
