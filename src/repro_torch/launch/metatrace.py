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
"""
from __future__ import annotations

import torch
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
    running the meta function. Views and in-place ops always run."""

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
