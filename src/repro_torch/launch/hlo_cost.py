"""Per-rank cost of one eager step, counted op by op: the port of the JAX
package's ``repro/launch/hlo_cost.py``.

The JAX module parses optimized (post-SPMD) HLO text. The port has no HLO:
it runs the step itself, once, under a ``TorchDispatchMode`` that sees
every aten op on this rank's local tensors (:class:`CostMode`), and counts
what the HLO parser counts:

* FLOPs of the matrix products, by ``torch.utils.flop_counter``'s formulas
  (``mm``, ``bmm``, ``addmm``, attention, convolution; elementwise work is
  not counted, as JAX counts ``dot`` ops only);
* HBM bytes: eager mode fuses nothing, so each op reads its tensor inputs
  and writes its outputs. JAX's rules carry over: views, ``detach`` and
  ``expand`` move nothing (``_NO_TRAFFIC``); ``index_select``, ``gather``,
  ``embedding`` and indexing move their output's bytes (the dynamic-slice
  and gather rule); ``index_put``, ``scatter``, ``index_add`` and
  ``copy_`` move twice the update's bytes (the dynamic-update-slice rule);
  a stride-0 (expanded) input is read once per distinct element;
* collectives (``_c10d_functional`` and ``c10d`` ops), by kind, on the ring
  model: all-gather moves its result's bytes, all-reduce twice its result,
  reduce-scatter its result times the group size, all-to-all and
  send/recv (``collective-permute``) their result. JAX's
  ``all-reduce->rs`` label has no counterpart: it marks an all-reduce that
  XLA's CPU pipeline left in place of a reduce-scatter, and DTensor emits
  the reduce-scatter itself.

Loops need no trip counts: a Python loop, a remat recomputation and a
gradient-accumulation loop run, and are counted, as often as they run
(JAX multiplies ``while`` bodies by their ``known_trip_count``).

DTensor ops are not counted themselves: the mode steps aside for them
(``NotImplemented``) and counts the local ops DTensor runs on the shards and
the collectives it issues. Ops on ``FakeTensor`` (DTensor's sharding
propagation runs the op on fake global tensors once per signature) are
not counted either. So every figure is this rank's, as JAX's SPMD module
is per device.

The mode also tracks the storage the step allocates (each new storage's
bytes while it lives, by weak reference), for the dry-run's
``temp_size_in_bytes``.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["analyze_step", "CostMode", "HloCost", "tensor_bytes"]


@dataclasses.dataclass
class HloCost:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    collectives: Dict[str, dict]

    def as_dict(self):
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "collectives": self.collectives,
        }


_PLAIN = (torch.Tensor, torch.nn.Parameter)
_aten = torch.ops.aten

# no traffic (besides views, found by their schema)
_NO_TRAFFIC = {
    _aten.detach.default, _aten.alias.default, _aten.expand.default, _aten.empty.memory_format,
    _aten.empty_strided.default, _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten.lift_fresh.default, _aten.set_.source_Storage_storage_offset,
}
# writes its output, reads nothing
_WRITE_ONLY = {"fill_", "zero_", "zeros", "ones", "full", "zeros_like", "ones_like", "full_like", "new_zeros",
               "new_ones", "new_full", "arange", "scalar_tensor"}
# reads only the region it gathers: its output's bytes
_GATHER = {"index_select", "gather", "embedding", "index"}
# read-modify-write of the update region: twice the update's bytes
_UPDATE = {"index_put": "values", "index_put_": "values", "_index_put_impl_": "values", "scatter": "src",
           "scatter_": "src", "scatter_add": "src", "scatter_add_": "src", "index_add": "source",
           "index_add_": "source"}
# collective op name -> (kind, factor on the result's bytes; None: the group size)
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", 1), "all_gather_into_tensor_coalesced": ("all-gather", 1),
    "allgather_": ("all-gather", 1), "_allgather_base_": ("all-gather", 1),
    "all_reduce": ("all-reduce", 2), "all_reduce_": ("all-reduce", 2), "all_reduce_coalesced": ("all-reduce", 2),
    "allreduce_": ("all-reduce", 2),
    "reduce_scatter_tensor": ("reduce-scatter", None), "reduce_scatter_tensor_coalesced": ("reduce-scatter", None),
    "reduce_scatter_": ("reduce-scatter", None), "_reduce_scatter_base_": ("reduce-scatter", None),
    "all_to_all_single": ("all-to-all", 1), "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 1), "recv_": ("collective-permute", 1),
}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d")


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes of a tensor's distinct elements (a stride-0 dimension is
    stored once), as an op reads or writes them."""
    if t.numel() == 0:
        return 0
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _tensors(x) -> list:
    out, seen = [], set()
    for t in tree_leaves(x):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _named_arg(func, args, kwargs, name):
    for i, a in enumerate(func._schema.arguments):
        if a.name == name:
            return kwargs[name] if name in kwargs else (args[i] if i < len(args) else None)
    return None


def _group_size(func, args, kwargs) -> int:
    size = _named_arg(func, args, kwargs, "group_size")
    if isinstance(size, int):
        return size
    name = _named_arg(func, args, kwargs, "group_name")
    if isinstance(name, str):
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group(name).size()
    group = _named_arg(func, args, kwargs, "process_group")
    if group is None:
        return 1
    from torch.distributed.distributed_c10d import ProcessGroup

    return ProcessGroup.unbox(group).size() if isinstance(group, torch.ScriptObject) else group.size()


class CostMode(TorchDispatchMode):
    """Counts FLOPs, HBM bytes and collectives of the local ops run under
    it, and the bytes of the storage they allocate while it lives
    (``live_bytes``, ``peak_bytes``). Storage already alive when the mode
    is entered (the step's arguments) is never counted as allocated."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives: Dict[str, dict] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: Dict[int, weakref.ref] = {}
        self._known = set()

    def known(self, tensors) -> None:
        """Mark the storage of ``tensors`` (and of DTensors' local shards)
        as existing before the step: never counted as allocated."""
        for t in tensors:
            if not isinstance(t, torch.Tensor):
                continue
            local = getattr(t, "_local_tensor", t)
            self._known.add(local.untyped_storage()._cdata)

    def cost(self) -> HloCost:
        colls = {k: dict(v, groups=dict(sorted(v["groups"].items()))) for k, v in sorted(self.collectives.items())}
        return HloCost(self.flops, self.hbm_bytes, sum(v["bytes"] for v in colls.values()), colls)

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not all(t in _PLAIN for t in types):
            from repro_torch.sharding.compat import dtensor_api

            if any(issubclass(t, dtensor_api()[0]) for t in types):
                return NotImplemented  # DTensor runs it on the shards, under this mode
            return func(*args, **kwargs)  # FakeTensor: sharding propagation, not this rank's work
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if all(type(t) in _PLAIN for t in outs):
            self._count(func, args, kwargs, out, outs)
            self._track(outs)
        return out

    def _count(self, func, args, kwargs, out, outs) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in _COLLECTIVE_NS:
            if name in _COLLECTIVES:
                kind, factor = _COLLECTIVES[name]
                b = sum(tensor_bytes(t) for t in (outs or _tensors((args, kwargs))))  # send: what it sends
                size = _group_size(func, args, kwargs)
                d = self.collectives.setdefault(kind, {"count": 0, "bytes": 0.0, "groups": {}})
                d["count"] += 1
                d["bytes"] += b * (size if factor is None else factor)
                d["groups"][size] = d["groups"].get(size, 0) + 1
            return
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += float(self._flop_registry[packet](*args, **kwargs, out_val=out))
        if not outs or func in _NO_TRAFFIC or func.is_view:
            return
        if name in _WRITE_ONLY:
            self.hbm_bytes += sum(tensor_bytes(t) for t in outs)
        elif name in _GATHER:
            self.hbm_bytes += sum(tensor_bytes(t) for t in outs)
        elif name in _UPDATE:
            upd = _named_arg(func, args, kwargs, _UPDATE[name])
            if isinstance(upd, torch.Tensor):
                self.hbm_bytes += 2 * tensor_bytes(upd)
            else:  # a scalar scattered at each index
                index = _named_arg(func, args, kwargs, "index")
                self.hbm_bytes += 2 * index.numel() * outs[0].element_size()
        elif name == "copy_":
            self.hbm_bytes += tensor_bytes(args[1]) + tensor_bytes(args[0])
        else:
            ins = _tensors((args, kwargs))
            ids = {id(t) for t in ins}
            self.hbm_bytes += sum(tensor_bytes(t) for t in ins)
            self.hbm_bytes += sum(tensor_bytes(t) for t in outs if id(t) not in ids or func._schema.is_mutable)

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known or key in self._storages:
                continue
            n = st.nbytes()
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            self._storages[key] = weakref.ref(st, lambda _, key=key, n=n: self._free(key, n))

    def _free(self, key, n) -> None:
        if self._storages.pop(key, None) is not None:
            self.live_bytes -= n


def analyze_step(fn, *args, **kw) -> HloCost:
    """Run ``fn(*args, **kw)`` once under :class:`CostMode` and return this
    rank's FLOPs, HBM bytes and collectives. Meant for meta tensors (or
    DTensors over meta shards), which cost nothing to run: on real tensors
    the step runs for real."""
    with CostMode() as mode:
        fn(*args, **kw)
    return mode.cost()
