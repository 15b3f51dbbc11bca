"""Roofline terms of a step on the NVIDIA H100 (``repro.roofline.analysis``,
whose target is the TPU v5e).

Per (arch x shape x mesh), per device:

    compute term    = FLOPs / peak bf16 FLOP/s
    memory term     = compulsory bytes / HBM bandwidth
    collective term = collective bytes / the collective bandwidth

The JAX package reads FLOPs and bytes from XLA's ``cost_analysis`` of the
partitioned module and parses the collectives out of its HLO text. The
port runs the step eagerly under :class:`StepCounter` and counts the same
three things on what runs, on the reference math (``force_ref=True``), so
the bound is the same whichever kernel implements the step:

* **FLOPs** per device: ``torch.utils.flop_counter``'s formulas (the ones
  ``FlopCounterMode`` applies: matmuls, convolutions, attention) on each
  op. An op on DTensors is counted at its global shapes and divided by
  the ranks that split it: the product of the mesh sizes on which its
  output is ``Shard`` or ``Partial`` (a ``Replicate`` output was computed
  whole on every rank). ``FlopCounterMode`` alone, above DTensor, would
  count the global product. Ops on plain tensors (a ``local_map`` body,
  an unsharded step) count as they are. The reference attention's two
  einsums compute every (query, key) pair and mask the scores; a causal
  or windowed kernel computes only the pairs the mask keeps, so the
  attention reports its mask (:func:`note_attention_scores`) and the
  masked pairs are taken back out, in the forward and the backward: the
  count is what the function needs, and no kernel can beat the compute
  term.
  The scans' reference math is the JAX models' chunked math, whose
  intra-chunk matmuls grow with the chunk length; the sequential
  recurrence needs none of them, so the chunked math counts as the
  sequential oracle at the same shapes (:func:`count_as`), in the
  forward and the backward: the count does not depend on the chunk
  length, and no kernel can beat the compute term there either.
* **Bytes**: there is no compiler fusion to count after, so the memory
  term's bytes are the step's compulsory traffic, per device: each
  argument's local shard read once and each output's written once; an
  output that is an argument updated in place (the decode cache) counts
  once, as read. An argument that the step reads only through gathers
  (a token embedding table under an untied head) counts the rows it
  gathers, not the whole table.
* **Collectives**: each ``_c10d_functional`` collective the step issues
  (DTensor's redistributions and the MoE's explicit ones), recorded as
  (kind, result dtype, result shape) and summed by the JAX package's rule:
  result-shape bytes, about the data crossing the links per op.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from ..compat import is_dtensor

# ------------------------------------------------------------ H100 constants
# NVIDIA H100 SXM5 80GB data sheet: dense BF16 tensor-core peak (989.4
# TFLOP/s without sparsity) and HBM3 bandwidth (3.35 TB/s), at the card's
# 700 W limit.
PEAK_FLOPS_BF16 = 989.4e12        # FLOP/s per GPU
HBM_BW = 3.35e12                  # B/s per GPU
# The production meshes' 16-wide model axis spans two 8-GPU NVLink nodes
# (DGX H100: 8 GPUs a node), so its collectives cross the nodes' network:
# one 400 Gb/s NDR InfiniBand port per GPU (ConnectX-7), 50 GB/s.
COLLECTIVE_BW = 50e9              # B/s per GPU

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: ``_c10d_functional`` op name fragment -> collective kind
_KIND_OF = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
            ("reduce_scatter", "reduce-scatter"),
            ("all_to_all", "all-to-all"), ("permute", "collective-permute"))


def collective_bytes(records: Iterable) -> dict:
    """Sum result-shape bytes per collective kind over ``(kind, dtype,
    shape)`` records (``dtype`` a torch dtype, ``shape`` a tuple)."""
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for kind, dtype, shape in records:
        itemsize = torch.empty((), dtype=dtype).element_size()
        out[kind] += math.prod(shape) * itemsize
        counts[kind] += 1
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    out["counts"] = counts
    return out


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_global: float
    model_flops_ratio: float          # model_flops / (FLOPs * chips)
    collectives: dict

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg, shape, n_active_params: Optional[int] = None) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train, 2·N·D inference (N = active)."""
    n = n_active_params if n_active_params is not None \
        else cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.batch * (shape.seq - cfg.n_prefix_embeds)
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.batch * shape.seq
        return 2.0 * n * tokens
    return 2.0 * n * shape.batch      # decode: one token per sequence


def analyze(cost: dict, collectives: Iterable, cfg, shape,
            n_chips: int) -> Roofline:
    """Roofline terms from a step's per-device ``cost`` (``flops``,
    ``bytes accessed``) and its recorded collectives."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    coll = collective_bytes(collectives)
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = nbytes / HBM_BW
    collective_s = coll["total"] / COLLECTIVE_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    ratio = mf / (flops * n_chips) if flops > 0 else 0.0
    return Roofline(
        flops_per_device=flops,
        bytes_per_device=nbytes,
        collective_bytes_per_device=float(coll["total"]),
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops_global=mf,
        model_flops_ratio=ratio,
        collectives=coll,
    )


# ---------------------------------------------------------------- counting
def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


def _tensors(tree) -> list:
    """The tensor leaves of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def local_bytes(tree, skip: Iterable = ()) -> int:
    """Bytes of the local shards of a tree's tensors (each storage once),
    leaving out the storages of the tensors in ``skip``."""
    seen = {_local(t).untyped_storage()._cdata for t in _tensors(skip)}
    n = 0
    for t in _tensors(tree):
        loc = _local(t)
        key = loc.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            n += loc.numel() * loc.element_size()
    return n


def _split(out) -> int:
    """Ranks that split the op whose output is ``out``: the product of the
    mesh sizes on which it is Shard or Partial (1 for a plain tensor)."""
    t = next(iter(_tensors(out)), None)
    if not is_dtensor(t):
        return 1
    mesh = t.device_mesh
    return math.prod(mesh.size(i) for i, p in enumerate(t.placements)
                     if not p.is_replicate())


def _has_values(t: torch.Tensor) -> bool:
    """Whether ``t`` holds data (not a meta, fake or distributed stand-in
    whose values the count cannot read)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return not (t.is_meta or isinstance(t, FakeTensor) or is_dtensor(t))


#: the StepCounters running, innermost last
_COUNTERS: list = []


def note_attention_scores(q: torch.Tensor, k: torch.Tensor,
                          mask: torch.Tensor,
                          pairs: Optional[int] = None) -> int:
    """Called by the reference attention after its score einsum, with q
    [B, S, nh, hd], k [B, T, nkv, hd] and its bool mask [B or 1, S, T].
    Each of its two einsums takes ``2 hd`` FLOPs per (query, key) pair
    and head, masked or not; under a counter this takes the score
    einsum's masked pairs back out and returns one einsum's masked FLOPs
    for :func:`note_attention_output` (0 with no counter). ``pairs``: the
    pairs kept per batch row, where the caller knows them (a causal
    prefill: row ``s`` sees ``min(s + 1, window)`` keys); otherwise they
    are counted from the mask, or all kept where the mask holds no
    values (the dry-run's decode shapes, whose contexts are full)."""
    if not _COUNTERS:
        return 0
    B, S, nh, hd = q.shape
    T = k.shape[1]
    if pairs is not None:
        kept = B * pairs
    elif _has_values(mask):
        kept = int(mask.expand(B, S, T).sum())
    else:
        kept = B * S * T
    masked = 2 * nh * hd * (B * S * T - kept) // _split(q)
    _COUNTERS[-1].credit_flops(masked)
    return masked


def note_attention_output(masked: int, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, out: torch.Tensor) -> None:
    """Called by the reference attention after its output einsum, with
    ``note_attention_scores``' ``masked``: takes that einsum's masked
    pairs out, and its backward's (one einsum of the same size per input
    that needs a gradient: dq, dk, the weights' dw and dv) when the
    gradient reaches ``out``, once a backward pass. Under activation
    checkpointing the recomputed forward credits what it recomputes:
    PyTorch stops it once it has the tensors the backward needs."""
    if not masked or not _COUNTERS:
        return
    counter = _COUNTERS[-1]
    counter.credit_flops(masked)
    if out.requires_grad:
        n = (q.requires_grad + k.requires_grad
             + (q.requires_grad or k.requires_grad) + v.requires_grad)
        out.register_hook(lambda g: counter.credit_flops(n * masked))


class _Region:
    """The FLOPs the ops run inside :func:`count_as` count (``fwd``), and
    those their backward will count (``bwd``: a matmul's backward takes
    one product of its size per operand that needs a gradient)."""

    def __init__(self):
        self.fwd = 0
        self.bwd = 0


def count_as(fn, args: tuple, fwd: int, bwd: int):
    """``fn(*args)``, counted as ``fwd`` FLOPs in the forward and ``bwd``
    in the backward in place of what its ops count (0 with no counter
    running). ``fn``'s ops that count FLOPs must be matmuls (``mm``,
    ``bmm``), whose backward the count reckons from their operands, and
    they must all feed its first output, which carries the gradient: the
    backward's difference is taken out when the gradient reaches it, once
    a backward pass, as in :func:`note_attention_output`. (An op that
    feeds another output only, such as a scan's last chunk summary, which
    feeds its final state, goes in a nested ``count_as`` of its own
    around that output; a nested call's ops count there only.)"""
    if not _COUNTERS:
        return fn(*args)
    counter = _COUNTERS[-1]
    region = _Region()
    counter._flops.regions.append(region)
    try:
        out = fn(*args)
    finally:
        counter._flops.regions.remove(region)
    counter.credit_flops(region.fwd - fwd)
    first = _tensors(out)[0]
    if first.requires_grad:
        excess = region.bwd - bwd
        first.register_hook(lambda g: counter.credit_flops(excess))
    return out


#: ops that read from their first operand only the elements they return
_GATHERS = ("aten::embedding", "aten::index", "aten::index_select",
            "aten::gather")


def _is_dtensor_type(cls) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(cls, DTensor)


class _Propagation:
    """Marks DTensor's sharding propagation while it runs: it computes an
    op's output layout by running the op, or its decomposition, on fake
    or meta tensors of the global shapes, which are no work of the step.
    It wraps the propagator's two entry points (the cached and the
    uncached) on DTensor's dispatcher for the duration of a count."""

    _NAMES = ("propagate_op_sharding", "propagate_op_sharding_non_cached")

    def __init__(self):
        self.depth = 0
        self._saved = {}

    def _wrap(self, fn):
        def wrapped(*a, **k):
            self.depth += 1
            try:
                return fn(*a, **k)
            finally:
                self.depth -= 1
        return wrapped

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        for name in self._NAMES if prop is not None else ():
            if hasattr(prop, name):
                self._saved[name] = prop.__dict__.get(name)
                setattr(prop, name, self._wrap(getattr(prop, name)))
        self._prop = prop
        return self

    def __exit__(self, *exc):
        for name, old in self._saved.items():
            if old is None:
                delattr(self._prop, name)
            else:
                setattr(self._prop, name, old)
        self._saved = {}


class _Flops(TorchDispatchMode):
    """Above DTensor: each op once, at its global shapes."""

    def __init__(self, prop: _Propagation):
        super().__init__()
        self.flops = 0
        self._prop = prop
        self.regions = []        # the count_as calls running

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None and not self._prop.depth:
            n = fn(*args, **kwargs, out_val=out) // _split(out)
            self.flops += n
            if self.regions:         # the innermost count_as running
                grads = torch.is_grad_enabled() and sum(
                    isinstance(a, torch.Tensor) and a.requires_grad
                    for a in args)
                self.regions[-1].fwd += n
                self.regions[-1].bwd += n * grads
        return out


class _Local(TorchDispatchMode):
    """Below DTensor (it declines DTensor ops, so DTensor's own local ops
    and collectives reach it): records the collectives and the live bytes
    of the local tensors the step makes."""

    def __init__(self, args, prop: _Propagation):
        super().__init__()
        self._prop = prop
        self.collectives = []
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        # argument storage -> [read whole, bytes gathered from it]
        self.reads = {}
        for t in _tensors(args):
            st = _local(t).untyped_storage()
            self._seen[st] = True
            self.reads[st._cdata] = [False, 0]

    def _free(self, n: int) -> None:
        self.live -= n

    def _note_reads(self, func, args, kwargs, out) -> None:
        """How much of each argument storage ``func`` reads: a view or an
        in-place write reads nothing, a gather its output's elements from
        its first operand, any other op the whole storage."""
        if func.is_view:
            return
        schema = func._schema
        gather = schema.name in _GATHERS
        vals = list(args) + [kwargs[a.name] for a in
                             schema.arguments[len(args):] if a.name in kwargs]
        for i, (arg, val) in enumerate(zip(schema.arguments, vals)):
            if arg.alias_info is not None and arg.alias_info.is_write:
                continue
            for t in _tensors(val):
                rec = self.reads.get(t.untyped_storage()._cdata)
                if rec is None:
                    continue
                if gather and i == 0:
                    rec[1] += sum(o.numel() for o in _tensors(out)) \
                        * t.element_size()
                else:
                    rec[0] = True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if self._prop.depth:
            return out
        self._note_reads(func, args, kwargs or {}, out)
        name = func.name()
        kind = next((k for frag, k in _KIND_OF if frag in name), None) \
            if "_c10d_functional" in name else None
        if kind is not None:
            for t in _tensors(out):
                self.collectives.append((kind, t.dtype, tuple(t.shape)))
        for t in _tensors(out):
            st = t.untyped_storage()
            if st not in self._seen:
                self._seen[st] = True
                n = st.nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, n)
        return out


class StepCounter:
    """Counts one step run inside it: ``flops`` per device, the recorded
    ``collectives`` (kind, dtype, shape), and ``temp_bytes``, the peak of
    live local bytes the step made beyond its arguments (``args``, whose
    storages, updated in place or not, are not counted)."""

    def __init__(self, args=()):
        self._prop = _Propagation()
        self._flops = _Flops(self._prop)
        self._local = _Local(args, self._prop)

    def __enter__(self):
        self._prop.__enter__()
        self._local.__enter__()
        self._flops.__enter__()
        _COUNTERS.append(self)
        return self

    def __exit__(self, *exc):
        _COUNTERS.remove(self)
        self._flops.__exit__(*exc)
        self._local.__exit__(*exc)
        self._prop.__exit__(*exc)

    def credit_flops(self, n: int) -> None:
        """Takes ``n`` FLOPs that the step's ops computed but its function
        does not need (masked attention pairs) out of the count."""
        self._flops.flops -= n

    def read_bytes(self, args) -> int:
        """Bytes of the arguments' local shards the step read: each
        storage whole, or only the bytes gathered from it where gathers
        were all that read it (each storage once)."""
        n, seen = 0, set()
        for t in _tensors(args):
            st = _local(t).untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            whole, gathered = self._local.reads[st._cdata]
            n += st.nbytes() if whole or not gathered \
                else min(gathered, st.nbytes())
        return n

    @property
    def flops(self) -> int:
        return self._flops.flops

    @property
    def collectives(self) -> list:
        return self._local.collectives

    @property
    def temp_bytes(self) -> int:
        return self._local.peak


def count_step(step, args: tuple, donated=None) -> dict:
    """Run ``step(*args)`` once under :class:`StepCounter` and return its
    per-device ``cost`` (``flops``, ``bytes accessed``), ``memory``
    (``argument_size_in_bytes``, ``output_size_in_bytes``,
    ``temp_size_in_bytes``, ``alias_size_in_bytes``: the donated
    ``donated`` tree's bytes), ``collectives`` and the step's output.
    ``bytes accessed`` counts each argument read (whole, or its gathered
    bytes where only gathers read it) and each output not updated in
    place written, once."""
    with StepCounter(args) as c:
        out = step(*args)
    arg_b = local_bytes(args)
    out_b = local_bytes(out)
    written = local_bytes(out, skip=args)   # outputs not updated in place
    return {
        "cost": {"flops": float(c.flops),
                 "bytes accessed": float(c.read_bytes(args) + written)},
        "memory": {"argument_size_in_bytes": arg_b,
                   "output_size_in_bytes": out_b,
                   "temp_size_in_bytes": c.temp_bytes,
                   "alias_size_in_bytes": (local_bytes(donated)
                                           if donated is not None else 0)},
        "collectives": c.collectives,
        "out": out,
    }
