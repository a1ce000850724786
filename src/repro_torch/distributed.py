"""The sharded train step's collectives and layout (the port's counterpart
of what XLA's SPMD partitioner and ``shard_map`` do for the JAX package).

A rank holds its shards of every leaf (``weights.shard_params``) and its
rows of the batch. Activations are replicated over the "model" axis and
split over the data axes ("pod", "data"). The schedule is Megatron's:

* **copy-in** (``copy_in``): the identity forward, an all-reduce of the
  gradient backward. It goes in front of a product whose weight is
  sharded on its output dim (each rank's gradient of the input is a
  partial sum);
* **reduce-out** (``reduce_out``): an all-reduce forward, the identity
  backward. It goes after a product whose weight is sharded on its input
  dim, and sums a vocabulary- or expert-parallel result;
* **gather-along** (``gather``): a dim a rank holds a slice of, made whole
  by writing the slice into a zero buffer at the rank's offset and
  all-reducing it; backward, the gradient is all-reduced (the consumers
  are each rank's own heads or experts) and the rank keeps its slice;
* an all-reduce over the data axes for the gradients and the loss sums.

Every collective is an ``all_reduce`` (sum or max; bf16 sums over more
than two ranks taken in fp32), the one operation
gloo carries for CUDA tensors as well as CPU ones (several ranks on one
card run over gloo: NCCL refuses two ranks on one device). Where gloo
refuses a CUDA tensor's all-reduce (a dtype it lacks), ``all_reduce``
stages it through host memory explicitly, counts the call in
``staged_calls`` and prints the first of each kind.

Under autograd the model-axis sums carry gradients: ``Layout.sum_model``
(every rank reads the whole sum: the gradient is summed over "model"
too) and ``Layout.row_parallel`` (each rank's fp32 partial product, the
sum rounded once; the identity backward, as reduce-out's).

``Plan`` resolves the layout of one config's param tree under
``ShardingRules`` (each leaf's spec, the dim that "model" shards and,
under FSDP, the dim the data axes shard; the port's layout,
``transformer.param_specs``) and refuses what this schedule does not run
(``check_rules``): in mode "train" ``seq_sharded``, and a Mamba2 layer
whose heads do not divide "model". The serving steps under a plan also
refuse paged caches (``check_serving``).

Under FSDP (``fsdp=True``, in every mode) a rank holds its slice of each
weight's ``w_embed`` dim over the data axes, beside its "model" split, and
AdamW's moments alike. Each layer gathers its leaves whole where it uses
them (``Layout.gathered``: ``gather`` over the data axes, whose backward
all-reduces the gradient and keeps the rank's slice, FSDP's
reduce-scatter), inside its remat body, so that remat "full" gathers them
again in the backward rather than holding them; in serving, in every
prefill and decode pass, and frees them after the layer. Their gradients
then skip the data-axes all-reduce of the rest (``Plan.reduce_grad``).

A Mamba2 layer's B and C columns of ``in_proj`` (and channels of
``conv_w`` and ``conv_b``) are whole on every model rank, and each rank
reads them for its own heads: their gradient is summed over "model"
before the step (``Plan.reduce_grad``) and counted once in the norm.

The attention caches' positions split over the axis group that their
leaf's spec names (``cache_groups``): the data axes under ``seq_sharded``
(serving only, JAX's long-context rule, which also leaves the batch whole
on every rank), "model" under ``shard_v2`` where the kv heads do not take
it (its ``cache_seq``), ("data", "model") under both. Rank r of that
group holds positions [r S / n, (r + 1) S / n); a decode step attends over
each rank's slice and merges the slices by their log-sum-exp with
all-reduces over the group (``attention.merge_slices``).

A spec entry is a mesh axis, a tuple of them, None, ``HeadsRead`` (the kv
heads a rank's query heads read, the port's layout of a GQA cache where
JAX's rules put "model" on the head dim) or ``Mamba2Read`` (a Mamba2
leaf's concatenated channels as a rank's heads read them).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

staged_calls = 0
# while a list (``launch.dryrun`` sets it), every all-reduce that leaves
# this rank appends (op, payload bytes, group size) to it
collective_log: Optional[list] = None
_staged_kinds: set = set()
_refused: set = set()


class Axis:
    """One mesh-axis group as this rank sees it: its process group (None
    when the group has one rank), its size and this rank's index in it
    (the row-major coordinate over the group's axes, in their order, which
    is the order JAX lays shards out)."""

    def __init__(self, group, size: int, index: int,
                 names: Tuple[str, ...]):
        self.group, self.size, self.index, self.names = (group, size, index,
                                                         names)

    def __repr__(self):
        return f"Axis({self.names}, size={self.size}, index={self.index})"


ONE = Axis(None, 1, 0, ())
_AXES: Dict = {}


def axis(mesh, axes) -> Optional[Axis]:
    """The group of ``axes`` (those the mesh has) containing this rank
    (None for a rank outside the mesh). Every rank of the process group
    creates every group of the partition, in one order, so each rank must
    call this for the same meshes and axes in the same order (the sharded
    step does: it is one program on every rank)."""
    import torch.distributed as dist
    from repro_torch.models.sharding import axis_names
    names = axis_names(mesh)
    axes = tuple(a for a in axes if a in names)
    if not axes:
        return ONE
    key = (id(mesh), axes)
    if key in _AXES:
        return _AXES[key][1]
    grid = mesh.mesh
    size = math.prod(grid.shape[names.index(a)] for a in axes)
    perm = ([i for i, a in enumerate(names) if a not in axes]
            + [names.index(a) for a in axes])
    me = dist.get_rank()
    mine = None
    for row in grid.permute(perm).reshape(-1, size).tolist():
        group = dist.new_group(row) if size > 1 else None
        if me in row:
            mine = Axis(group, size, row.index(me), axes)
    _AXES[key] = (mesh, mine)          # the mesh kept alive: ids stay unique
    return mine


def all_reduce(t: torch.Tensor, ax: Axis, op: str = "sum") -> torch.Tensor:
    """In place over ``ax``: the sum (or max) of every rank's ``t``. A
    bf16 or fp16 sum over more than two ranks is taken in fp32 and rounded
    once, as one product's fp32 accumulator rounds a result that no rank
    splits (over two ranks the backend's one add rounds once already)."""
    global staged_calls
    if ax.size == 1:
        return t
    if op == "sum" and t.dtype in (torch.bfloat16, torch.float16) \
            and ax.size > 2:
        return t.copy_(all_reduce(t.float(), ax, op))
    if collective_log is not None:
        collective_log.append((op, t.numel() * t.element_size(), ax.size))
    import torch.distributed as dist
    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    kind = (t.dtype, op)
    if t.is_cuda and kind in _refused:
        host = t.cpu()
        dist.all_reduce(host, red, group=ax.group)
        t.copy_(host)
        staged_calls += 1
        return t
    try:
        dist.all_reduce(t, red, group=ax.group)
    except RuntimeError as e:
        if not t.is_cuda:
            raise
        _refused.add(kind)
        if kind not in _staged_kinds:
            _staged_kinds.add(kind)
            print(f"[dist] all_reduce({op}) of a CUDA {t.dtype} tensor "
                  f"refused by the backend ({str(e).splitlines()[0]}): "
                  "staged through host memory from here on", flush=True)
        return all_reduce(t, ax, op)
    return t


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          ctx.ax), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x.clone(memory_format=torch.contiguous_format), ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return all_reduce(x.clone(memory_format=torch.contiguous_format), ax)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          ctx.ax), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax, reduce_grad):
        ctx.dim, ctx.ax, ctx.reduce_grad, ctx.n = dim, ax, reduce_grad, \
            x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= ax.size
        full = x.new_zeros(shape)
        full.narrow(dim, ax.index * x.shape[dim], x.shape[dim]).copy_(x)
        return all_reduce(full, ax)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        if ctx.reduce_grad:
            all_reduce(g, ctx.ax)
        return (g.narrow(ctx.dim, ctx.ax.index * ctx.n, ctx.n).contiguous(),
                None, None, None)


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def copy_in(x, ax: Axis):
    return x if ax.size == 1 else _CopyIn.apply(x, ax)


def reduce_out(x, ax: Axis):
    return x if ax.size == 1 else _ReduceOut.apply(x, ax)


def gather(x, dim: int, ax: Axis, reduce_grad: bool = True):
    """Gather-along ``dim`` (see the module docstring). With
    ``reduce_grad=False`` the backward only keeps the rank's slice, for a
    whole tensor whose consumers every rank computes alike."""
    if ax.size == 1:
        return x
    return _Gather.apply(x, dim % x.ndim, ax, reduce_grad)


def grad_scale(x, s: float):
    """The identity whose gradient is scaled by ``s``."""
    return x if s == 1 else _GradScale.apply(x, s)


def local_slice(t: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over ``ax``."""
    n = t.shape[dim] // ax.size
    return t.narrow(dim, ax.index * n, n)


class HeadsRead:
    """A spec entry for the kv-heads dim of GQA K/V: on each "model" rank,
    the kv heads its query heads (``nh / size`` of them, in order) read,
    global query head h meeting kv head h // (nh / kvh). They are laid
    out so that local query head i meets local kv head i // (n / local kv
    heads): the contiguous run of kv heads where that holds, else one kv
    head a query head (``heads``). Where several ranks read a kv head,
    each holds a copy."""

    def __init__(self, num_heads: int, num_kv_heads: int):
        self.nh, self.kvh = num_heads, num_kv_heads

    def __eq__(self, other):
        return (isinstance(other, HeadsRead)
                and (self.nh, self.kvh) == (other.nh, other.kvh))

    def __hash__(self):
        return hash((HeadsRead, self.nh, self.kvh))

    def __repr__(self):
        return f"HeadsRead({self.nh}/{self.kvh} over 'model')"

    def heads(self, index: int, size: int):
        """The global kv head of each local kv head of model rank
        ``index`` of ``size``."""
        n, group = self.nh // size, self.nh // self.kvh
        idx = [(index * n + i) // group for i in range(n)]
        lo, hi = idx[0], idx[-1] + 1
        per = n // (hi - lo)
        if n % (hi - lo) == 0 and idx == [lo + i // per for i in range(n)]:
            return list(range(lo, hi))
        return idx

    def take(self, t: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
        """This rank's kv heads of the whole ``t`` along ``dim``."""
        idx = self.heads(ax.index, ax.size)
        if idx == list(range(idx[0], idx[-1] + 1)):
            return t.narrow(dim, idx[0], len(idx))
        return t.index_select(dim, torch.tensor(idx, device=t.device))

    @torch.no_grad()
    def whole(self, t: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
        """The whole tensor from every rank's ``take``: each kv head
        written by the lowest rank that holds it (the rank of its first
        query head), then summed over the model axis."""
        n, group = self.nh // ax.size, self.nh // self.kvh
        shape = list(t.shape)
        shape[dim] = self.kvh
        full = t.new_zeros(shape)
        seen = set()
        for p, g in enumerate(self.heads(ax.index, ax.size)):
            if g not in seen and (g * group) // n == ax.index:
                full.narrow(dim, g, 1).copy_(t.narrow(dim, p, 1))
            seen.add(g)
        return all_reduce(full, ax)

    def local_size(self, ax: Axis) -> int:
        return len(self.heads(ax.index, ax.size))


class Mamba2Read:
    """A spec entry for the concatenated channel dim of a Mamba2 leaf:
    ``in_proj``'s z | x | B | C | dt, and x | B | C of ``conv_w``,
    ``conv_b`` and the conv window. On each "model" rank it holds its
    heads' slices of the parts that follow the heads (z, x, dt) and the
    parts every head reads whole (B and C, one group), in the leaf's
    order, so that the rank's slice splits as the whole leaf does at the
    rank's d_inner and heads. JAX's rules split the concatenated dim
    contiguously, which does not follow the heads. ``parts``: (size,
    split over "model") of each part in order."""

    def __init__(self, parts):
        self.parts = tuple((int(n), bool(split)) for n, split in parts)

    @classmethod
    def in_proj(cls, d_in: int, state: int, heads: int) -> "Mamba2Read":
        return cls(((d_in, True), (d_in, True), (2 * state, False),
                    (heads, True)))

    @classmethod
    def conv(cls, d_in: int, state: int) -> "Mamba2Read":
        return cls(((d_in, True), (2 * state, False)))

    def __eq__(self, other):
        return isinstance(other, Mamba2Read) and self.parts == other.parts

    def __hash__(self):
        return hash((Mamba2Read, self.parts))

    def __repr__(self):
        return ("Mamba2Read(" + " | ".join(
            f"{n}{'/model' if split else ''}" for n, split in self.parts)
            + ")")

    def take(self, t: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
        """This rank's channels of the whole ``t`` along ``dim``."""
        out, off = [], 0
        for n, split in self.parts:
            part = t.narrow(dim, off, n)
            out.append(local_slice(part, dim, ax) if split else part)
            off += n
        return torch.cat(out, dim)

    @torch.no_grad()
    def whole(self, t: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
        """The whole tensor from every rank's ``take``: the split parts
        gathered along ``dim``, the whole ones as this rank holds them."""
        out, off = [], 0
        for n, split in self.parts:
            k = n // ax.size if split else n
            part = t.narrow(dim, off, k)
            out.append(gather(part, dim, ax) if split else part)
            off += k
        return torch.cat(out, dim)

    def local_size(self, ax: Axis) -> int:
        return sum(n // ax.size if split else n for n, split in self.parts)

    def local_parts(self, size: int):
        """(offset, size, split) of each part in a rank's slice over a
        model axis of ``size``."""
        out, off = [], 0
        for n, split in self.parts:
            k = n // size if split else n
            out.append((off, k, split))
            off += k
        return out


def read_parts(spec, t: torch.Tensor, size: int):
    """``t``, laid out by ``spec`` over a model axis of ``size`` (a rank's
    slice; with ``size`` 1 the whole leaf), cut by the spec's
    ``Mamba2Read`` entry into (piece, whether every model rank holds it
    whole): a Mamba2 leaf's B and C are whole on every model rank though
    each reads them for its own heads. [] for a leaf without one."""
    for i, e in enumerate(spec):
        if isinstance(e, Mamba2Read):
            return [(t.narrow(i, off, n), not split)
                    for off, n, split in e.local_parts(size)]
    return []


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

class Layout:
    """The model-axis layout of one block (or one module) of the tree:
    ``dim(name)`` is the dim of the per-layer leaf ``name`` (its "scan"
    dim dropped) that "model" shards, or None; ``model`` and ``data`` are
    this rank's axis groups; ``batch`` the group the batch's rows split
    over (``data``, or one rank where the batch is whole on every rank:
    ``seq_sharded``); ``seq`` the group the attention caches' positions
    split over (``cache_groups``), else None."""

    def __init__(self, dims: Dict[str, Optional[int]], specs: Dict,
                 model: Axis, data: Axis, prefix: str = "",
                 seq: Optional[Axis] = None, fsdp: Optional[Dict] = None,
                 batch: Optional[Axis] = None):
        self.dims, self.specs, self.model, self.data = dims, specs, model, data
        self.prefix, self.seq, self.fsdp = prefix, seq, fsdp or {}
        self.batch = data if batch is None else batch

    def _key(self, name: str) -> str:
        return f"{self.prefix}.{name}" if self.prefix else name

    def dim(self, name: str) -> Optional[int]:
        return self.dims[self._key(name)]

    def spec(self, name: str):
        return self.specs[self._key(name)]

    def sub(self, prefix: str) -> "Layout":
        return Layout(self.dims, self.specs, self.model, self.data,
                      self._key(prefix), self.seq, self.fsdp, self.batch)

    def gathered(self, p, prefix: str = ""):
        """The module's leaves ``p`` (a nested dict, or one leaf named
        ``prefix``) with each leaf FSDP shards over the data axes gathered
        whole along that dim (``gather``: its gradient all-reduced over
        those axes and cut to the rank's slice); ``p`` itself without
        FSDP."""
        if not self.fsdp:
            return p
        if isinstance(p, dict):
            return {k: self.gathered(v, f"{prefix}.{k}" if prefix else k)
                    for k, v in p.items()}
        hit = self.fsdp.get(self._key(prefix))
        return p if hit is None else gather(p, hit[0], hit[1])

    def split(self, names, want, what: str) -> bool:
        """Whether the module whose leaves are ``names`` runs on the
        rank's share of "model": False where no leaf is sharded; True
        where each leaf is sharded on the dim of ``want`` (None: left
        whole); else ``refuse`` (``what`` says the layout the schedule
        runs)."""
        dims = [self.dim(n) for n in names]
        if all(d is None for d in dims):
            return False
        if dims != list(want):
            bad = next(n for n, d, w in zip(names, dims, want) if d != w)
            self.refuse(bad, what)
        return True

    def sum_model(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the model axis, as a new tensor whose gradient
        is summed over "model" too, since every rank reads the whole sum
        (a norm's sum of squares; row-parallel products of which each rank
        keeps its own heads: the gradient of the sum is then each rank's
        heads' written into zeros, summed)."""
        return t if self.model.size == 1 else _SumBoth.apply(t, self.model)

    def row_parallel(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` where both hold the rank's slice of the contracted dim
        and every rank uses the result whole: each rank's partial product
        kept in fp32 (its accumulator unrounded), summed over "model" in
        fp32 and rounded to ``x``'s dtype once, as one product over the
        whole dim rounds its accumulator. A reduce-out of bf16 partials
        would round each partial and then their sum. The sum is a
        reduce-out (the identity backward)."""
        from repro_torch.models.layers import mm_fp32
        return reduce_out(mm_fp32(x, w), self.model).to(x.dtype)

    def copy_in(self, x):
        return copy_in(x, self.model)

    def reduce_out(self, x):
        return reduce_out(x, self.model)

    def gather(self, x, dim: int, reduce_grad: bool = True):
        return gather(x, dim, self.model, reduce_grad)

    def refuse(self, name: str, why: str):
        raise NotImplementedError(
            f"{self._key(name)}: spec {tuple(self.spec(name))} ({why}) is "
            f"not run by the sharded schedule; it {_LATER}")


_LATER = ("comes with a later slice of the PyTorch port's distribution "
          "(ROADMAP Queue A, distribution)")


_DATA = ("pod", "data")


def _layout_dims(specs: Dict, axes: Dict[str, tuple]):
    """(path -> the per-layer dim "model" shards, or None; path -> (the
    per-layer dim the data axes shard, those axes) for the leaves FSDP
    shards)."""
    dims, fsdp = {}, {}
    for path, spec in specs.items():
        shift = 1 if axes[path][:1] == ("scan",) else 0
        dims[path] = None
        for i, e in enumerate(spec):
            group = (e,) if isinstance(e, str) else e
            if e is None:
                continue
            if e == "model" or isinstance(e, Mamba2Read):
                dims[path] = i - shift
            elif isinstance(group, tuple) and set(group) <= set(_DATA):
                fsdp[path] = (i - shift, group)
            else:
                raise NotImplementedError(
                    f"{path}: spec {tuple(spec)} is not run by the sharded "
                    f"schedule; it {_LATER}")
    return dims, fsdp


def check_rules(cfg, rules, mode: str = "train"):
    """Raise ``NotImplementedError`` for what the sharded schedule does not
    run in ``mode``: in mode "train" ``seq_sharded`` (JAX's dry run sets it
    for decode only), and a Mamba2 layer whose heads do not divide "model"
    where JAX's rules put "model" on its channels. Each names a leaf (or
    activation), its spec and the later slice."""
    from repro_torch.models import transformer as tf
    axes = tf.param_axes(cfg)
    shapes = tf.param_shapes(cfg)
    if rules.seq_sharded and mode == "train":
        spec = rules.spec((1, 1, 1), ("batch", "seq", "embed"))
        raise NotImplementedError(
            f"activations ('batch', 'seq', 'embed'): spec {tuple(spec)} "
            f"under seq_sharded=True shards the sequence; sequence-sharded "
            f"training {_LATER}")
    if cfg.family == "hybrid":
        from repro_torch.models import mamba2 as m2
        d_in, nh = m2._dims(cfg)[:2]
        path = "mamba.in_proj"
        spec = rules.spec(shapes[path], axes[path])
        m = rules.axis_sizes.get("model", 1)
        if spec[-1] == "model" and (nh % m or d_in % m):
            raise NotImplementedError(
                f"{path}: spec {tuple(spec)}: {nh} Mamba2 heads on a "
                f"'model' axis of {m}; the Mamba2 layer runs with its heads "
                f"split over 'model', and this layout {_LATER}")


def check_serving(mode: str, caches=None):
    """Raise ``NotImplementedError`` for what the serving steps under a
    mesh do not run: paged caches, which modes "chunk" and "verify" take
    (JAX gives their pools no logical axes and runs none of them
    sharded). It names the cache leaf, its spec and the later slice."""
    paged = [k for k, c in (caches or {}).items()
             if isinstance(c, dict) and "k_pool" in c]
    if paged or mode in ("chunk", "verify"):
        raise NotImplementedError(
            f"{(paged or ['attn'])[0]}.k_pool: spec None (JAX gives paged "
            f"pools no logical axes) in mode {mode!r}; paged caches, "
            f"chunk_step and verify_step under a mesh {_LATER}")


def group_of(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes: () for None, (name,) for one axis."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def cache_groups(cfg, rules):
    """(the axes the batch's rows split over, the axes the attention
    caches' positions split over) as JAX's rules resolve a cache leaf
    (``attention.cache_axes``) whose batch and length divide every mesh
    axis group: the data axes and (), or under ``seq_sharded`` () and the
    data axes; under ``shard_v2`` ``cache_seq`` takes "model" where the kv
    heads do not, and under both flags ("data", "model") or nothing. A
    cache whose length the positions' group does not divide is refused
    where it is made (``transformer.init_cache``)."""
    from repro_torch.models import attention as attn
    n = math.prod(rules.axis_sizes.values())
    batch = group_of(rules.spec((n,), ("batch",))[0])
    if cfg.attn_type not in ("gqa", "mla") or cfg.encoder_only:
        return batch, ()
    name = "c_kv" if cfg.attn_type == "mla" else "k"
    spec = rules.spec(attn.cache_spec(cfg, n, n)[name][0],
                      attn.cache_axes(cfg)[name])
    return group_of(spec[0]), group_of(spec[1])


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of this rank's shard of a ``shape`` leaf laid out by
    ``spec`` (``weights.shard_params``'s)."""
    out = list(shape)
    for i, e in enumerate(spec):
        if isinstance(e, (HeadsRead, Mamba2Read)):
            out[i] = e.local_size(axis(mesh, ("model",)))
        elif e is not None:
            out[i] //= axis(mesh, (e,) if isinstance(e, str) else e).size
    return tuple(out)


class Plan:
    """One config's sharded step on this rank: each leaf's spec
    (``specs``, by JAX's dotted path: the port's layout,
    ``transformer.param_specs``), model-sharded dim (``dims``) and, under
    FSDP, data-sharded dim and its axis group (``fsdp``); the rules, and
    the rank's "model" and data-axes groups; ``seq`` is the data-axes
    group under ``seq_sharded`` (the caches' sequence split over it, the
    batch whole on every rank), else None."""

    def __init__(self, cfg, rules, mesh):
        from repro_torch.models import transformer as tf
        axes = tf.param_axes(cfg)
        self.specs = tf.param_specs(cfg, rules)
        self.dims, fsdp = _layout_dims(self.specs, axes)
        if cfg.family == "moe":
            _check_ep(cfg, rules, self.dims, self.specs, "layers.moe.")
        self.model = axis(mesh, ("model",))
        self.data = axis(mesh, _DATA)
        batch, seq = cache_groups(cfg, rules)
        self.batch = axis(mesh, batch)
        self.seq = axis(mesh, seq) if seq else None
        self.fsdp = {p: (dim, axis(mesh, group))
                     for p, (dim, group) in fsdp.items()}
        # the data axes each leaf's gradient is still summed over after
        # the backward (those FSDP's gathers do not reduce-scatter)
        self.rest = {p: axis(mesh, tuple(a for a in _DATA
                                         if a not in fsdp.get(p, (0, ()))[1]))
                     for p in self.specs}
        self.cfg, self.rules, self.mesh = cfg, rules, mesh

    def block(self, pkey: str) -> Layout:
        return Layout(self.dims, self.specs, self.model, self.data, pkey,
                      self.seq, self.fsdp, self.batch)

    def rows(self, t):
        """This rank's rows of a global batch tensor (JAX's batch sharding
        over ("pod", "data")); the batch must divide over them. Under
        ``seq_sharded`` the batch is replicated: ``t`` itself."""
        if t is None or self.batch.size == 1:
            return t
        if t.shape[0] % self.batch.size:
            raise ValueError(f"a batch of {t.shape[0]} rows does not divide "
                             f"over the data axes ({self.batch.size} ranks)")
        return local_slice(t, 0, self.batch)

    def parts(self, path: str, g: torch.Tensor):
        """Leaf ``path``'s gradient ``g`` cut into (piece, whether model
        ranks hold it whole): a Mamba2 leaf's parts (``read_parts``), else
        ``g`` itself."""
        return (self.model.size > 1
                and read_parts(self.specs[path], g, self.model.size)) \
            or [(g, self.dims[path] is None)]

    def reduce_grad(self, path: str, g: torch.Tensor) -> torch.Tensor:
        """Leaf ``path``'s gradient (its rows' share on this rank), in
        place, made the rank's shard of the whole batch's gradient: summed
        over the data axes FSDP's gather did not reduce-scatter it over;
        a Mamba2 leaf's B and C parts summed over "model"."""
        all_reduce(g, self.rest[path])
        parts = self.parts(path, g)
        if len(parts) > 1:                  # a Mamba2 leaf
            for piece, whole in parts:
                if whole:
                    piece.copy_(all_reduce(piece.contiguous(), self.model))
        return g

    def global_norm(self, grads) -> torch.Tensor:
        """sqrt of the fp32 sum of squares of every leaf of the whole tree
        (``reduce_grad``'s gradients): each share summed over the ranks
        that hold other shares of it, model-sharded parts over "model" and
        FSDP leaves over their data axes; what model ranks hold alike
        (replicated leaves, a Mamba2 leaf's B and C) counted once."""
        from repro_torch import tree
        from repro_torch.models.optim import slices
        buckets: Dict = {}
        for path, g in tree.flatten(grads).items():
            path = path.replace("/", ".")
            data = self.fsdp[path][1] if path in self.fsdp else ONE
            for piece, whole in self.parts(path, g):
                # in slices: an fp32 copy of a whole stacked leaf would
                # be 9 GB (internlm2_20b's wi on (2, 2) under FSDP)
                buckets.setdefault((not whole, data.names), (data, []))[
                    1].extend(torch.sum(torch.square(p.float()))
                              for p in slices(piece))
        dev = tree.leaves(grads)[0].device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for (split, _), (data, sqs) in sorted(buckets.items()):
            t = sum(sqs).reshape(()).clone()
            if split:
                t = all_reduce(t, self.model)
            total = total + all_reduce(t, data)
        return torch.sqrt(total)


_PLANS: Dict = {}


def plan(cfg, rules, mesh, mode: str = "train", caches=None
         ) -> Optional[Plan]:
    """The ``Plan`` of ``cfg`` under ``rules``/``mesh`` (cached), or None
    without a mesh. For a serving ``mode`` (over ``caches``) it first
    refuses what the serving steps do not run (``check_serving``)."""
    if mesh is None and rules is None:
        return None
    if rules is None:
        from repro_torch.models.sharding import ShardingRules
        rules = ShardingRules(mesh)
    check_rules(cfg, rules, mode)
    if mode != "train":
        check_serving(mode, caches)
    key = (cfg, id(rules), id(mesh if mesh is not None else rules.mesh))
    if key not in _PLANS:
        _PLANS[key] = (rules, mesh, Plan(cfg, rules, mesh if mesh is not None
                                         else rules.mesh))
    return _PLANS[key][2]


def moe_layout(cfg, mesh, rules=None) -> Layout:
    """The layout of one MoE module's leaves (``moe.init_moe``'s tree,
    paths "router", "wi", "shared.wi", ...) under ``rules`` (JAX's
    defaults on ``mesh`` when None), for ``apply_moe`` called alone."""
    from repro_torch.models.layers import Initializer
    from repro_torch.models.moe import init_moe
    from repro_torch.models.sharding import ShardingRules
    rules = rules or ShardingRules(mesh)
    init = Initializer(cfg, None, "meta", record=True)
    tree = init_moe(init, cfg)
    specs, axes = {}, {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
        else:
            axes[prefix] = init.axes[id(t)]
            specs[prefix] = rules.spec(tuple(t.shape), axes[prefix])
    walk(tree, "")
    dims, _ = _layout_dims(specs, axes)
    _check_ep(cfg, rules, dims, specs, "")
    return Layout(dims, specs, axis(mesh, ("model",)),
                  axis(mesh, ("pod", "data")))


def _check_ep(cfg, rules, dims, specs, prefix):
    """Raise where "model" (> 1) does not split the MoE experts: the rules
    then lay ``wi``/``wo`` out on their ff dim, which the expert-parallel
    schedule does not run."""
    m = rules.axis_sizes.get("model", 1)
    path = f"{prefix}wi"
    if m > 1 and (cfg.moe.num_experts % m or dims[path] != 0):
        raise NotImplementedError(
            f"{path}: spec {tuple(specs[path])}: {cfg.moe.num_experts} "
            f"experts on a 'model' axis of {m}; expert parallelism runs "
            f"with the experts split over 'model', and this layout {_LATER}")
