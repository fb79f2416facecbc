"""Logical-axis sharding substrate of the port (``repro.distributed.sharding``
over ``torch.distributed.tensor``).

Model code never names mesh axes.  Every tensor dimension carries a
*logical* axis name ('batch', 'heads', 'd_ff', ...), and a
:class:`ShardingRules` maps logical names onto the mesh axes that exist
('pod', 'data', 'model').  The same model then runs unsharded on one device,
tensor-parallel on a (16, 16) mesh or pod+data+model sharded on (2, 16, 16):
only the rules change.

A resolved spec has the reference's ``PartitionSpec`` shape: a tuple with,
per dimension, ``None``, one mesh-axis name or a tuple of names, trailing
``None``s trimmed, so it compares to the reference's spec by plain
equality.  On a ``DeviceMesh`` it becomes DTensor placements
(:func:`placements_for`): ``Shard(d)`` on each mesh dimension the spec names
for tensor dimension ``d`` (unless ``d`` has size 1) and ``Replicate()``
elsewhere; a dimension split over two mesh axes, ``("pod", "data")``,
takes two ``Shard(d)`` in mesh-dimension order, which is the block order
of the reference's ``NamedSharding``.

``shard(x, *axes)`` is the reference's sharding constraint: the identity on a
plain tensor or without ambient rules, a redistribution of a DTensor to the
resolved placements otherwise.  Parameter templates (:class:`TensorSpec`)
feed ``init_from_template`` (real tensors, distributed when rules with a
mesh are given), ``abstract_from_template`` (meta tensors, never allocated)
and ``specs_from_template``.  Nothing here touches ``torch.distributed`` at
import.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Iterable, Mapping

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Logical axis rules (the reference's, one for one)
# ---------------------------------------------------------------------------

# A rule value is a tuple of mesh axes (the logical axis is sharded over
# their product), one mesh-axis name, or None (replicated).  Axes absent from
# the mesh are dropped at resolution, so the same rules serve 1-device,
# single-pod and multi-pod meshes.
DEFAULT_RULES: dict[str, Any] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "act_d_model": None,
    "act_heads": "model",
    "act_d_ff": "model",
    "act_vocab": "model",
    "kv_seq": None,
    # parameters (tensor-parallel pattern)
    "d_model": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "d_ff": "model",
    "experts": "model",
    "vocab": "model",
    "lora": None,
    "ssm_heads": "model",
    "ssm_state": None,
    "conv": None,
    # KV cache: the sequence dim over the model axis by default (most archs'
    # KV heads do not divide a 16-way axis); archs whose KV heads divide it
    # override to head sharding.
    "cache_batch": ("pod", "data"),
    "cache_kv_heads": None,
    "cache_seq": "model",
    # the stacked layer axis is never sharded
    "layers": None,
}

# FSDP overlay for >= 100B models: the weights' d_model dims also sharded over
# the data axis, so resident parameter bytes scale with the whole mesh.
FSDP_OVERRIDES: dict[str, Any] = {
    "d_model": ("data",),
}


def mesh_axis_sizes(mesh: Any) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or of a stand-in with
    ``axis_names`` and ``devices.shape`` (the reference's Mesh interface)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """A mesh plus the logical -> mesh axis mapping active for a program."""

    mesh: Any
    rules: Mapping[str, Any] = dataclasses.field(default_factory=lambda: DEFAULT_RULES)

    def with_overrides(self, overrides: Mapping[str, Any] | None) -> "ShardingRules":
        if not overrides:
            return self
        merged = dict(self.rules)
        merged.update(overrides)
        return ShardingRules(self.mesh, merged)

    def mesh_axes_for(self, logical: str | None) -> tuple[str, ...]:
        if logical is None or self.mesh is None:
            return ()
        rule = self.rules.get(logical)
        if rule is None:
            return ()
        if isinstance(rule, str):
            rule = (rule,)
        present = mesh_axis_sizes(self.mesh)
        return tuple(a for a in rule if a in present)

    def spec_for(self, logical_axes: Iterable[str | None]) -> tuple:
        parts: list[Any] = []
        used: set[str] = set()
        for ax in logical_axes:
            mesh_axes = tuple(a for a in self.mesh_axes_for(ax) if a not in used)
            used.update(mesh_axes)
            parts.append(_entry(mesh_axes))
        return _trim(parts)

    def spec_for_shape(self, shape: tuple[int, ...], logical_axes: Iterable[str | None]) -> tuple:
        """Per dimension the longest prefix of the rule's mesh axes whose
        product divides the dimension (no mesh axis used twice); a dimension
        that no prefix divides is replicated: 20 heads on a 16-way axis, or a
        global batch of 1 on the data axis."""
        parts: list[Any] = []
        used: set[str] = set()
        sizes = mesh_axis_sizes(self.mesh) if self.mesh is not None else {}
        for dim, ax in zip(shape, logical_axes):
            cand = [a for a in self.mesh_axes_for(ax) if a not in used]
            while cand and dim % int(np.prod([sizes[a] for a in cand])):
                cand.pop()
            used.update(cand)
            parts.append(_entry(tuple(cand)))
        return _trim(parts)


def _entry(mesh_axes: tuple[str, ...]) -> Any:
    if not mesh_axes:
        return None
    return mesh_axes[0] if len(mesh_axes) == 1 else mesh_axes


def _trim(parts: list) -> tuple:
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dtensor_class():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_dtensor(x: Any) -> bool:
    return torch.distributed.is_available() and isinstance(x, _dtensor_class())


def is_rank0() -> bool:
    """Rank 0 of a process group, or the only process: the one that logs
    and writes files."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def placement_types():
    """(Partial, Replicate, Shard)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return Partial, Replicate, Shard


def as_dtensor(t: torch.Tensor | None, mesh: Any) -> torch.Tensor | None:
    """A plain tensor beside DTensors: replicated on ``mesh``."""
    if t is None or is_dtensor(t):
        return t
    Replicate = placement_types()[1]
    return _dtensor_class().from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def from_block(local: torch.Tensor, mesh: Any, placements, shape) -> torch.Tensor:
    """A DTensor of global ``shape`` from this rank's block, made contiguous
    (DTensor's views of it need a plain layout)."""
    return _dtensor_class().from_local(
        local.contiguous(), mesh, placements, run_check=False, shape=torch.Size(shape),
        stride=_contiguous_strides(shape))


def _contiguous_strides(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``, in integer
    arithmetic: no tensor is made, so a dry-run's counter of live bytes
    sees none."""
    strides, n = [], 1
    for size in reversed(tuple(shape)):
        strides.append(n)
        n *= max(int(size), 1)
    return tuple(reversed(strides))


def redistributed(t: torch.Tensor | None, placements) -> torch.Tensor | None:
    """``t`` in ``placements`` (itself where it already is)."""
    if t is None or tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def placements_for(spec: tuple, mesh: Any, shape: tuple[int, ...]) -> tuple:
    """A resolved spec of a tensor of ``shape`` -> one placement per mesh
    dimension.  A dim of size 1 stays whole: only one-way axes divide it (a
    KV head on a 1-way "model" axis, a batch of 1 on a 1-way "data" axis),
    where a Shard holds the same block as a Replicate, and DTensor refuses
    a view that merges or drops a sharded dim.  The spec itself keeps the
    entry, as the reference writes it."""
    _, Replicate, Shard = placement_types()
    names = list(mesh_axis_sizes(mesh))
    out: list[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None or shape[dim] == 1:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def local_block(shape: tuple[int, ...], mesh: Any, placements: tuple) -> tuple[slice, ...]:
    """This rank's block of a tensor of global ``shape`` under
    ``placements``: DTensor's chunking (blocks of ceil(n / k), mesh dims in
    order), in integer arithmetic, so that it also runs under a
    ``FakeTensorMode``."""
    coord = mesh.get_coordinate()
    start, size = [0] * len(shape), list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            d = p.dim
            chunk = -(-size[d] // mesh.size(i))
            lo = min(coord[i] * chunk, size[d])
            start[d] += lo
            size[d] = min(lo + chunk, size[d]) - lo
    return tuple(slice(a, a + n) for a, n in zip(start, size))


def distribute(t: torch.Tensor, spec: tuple, mesh: Any) -> torch.Tensor:
    """A full tensor, the same on every rank, -> a DTensor holding this
    rank's block; no communication."""
    return distribute_as(t, mesh, placements_for(spec, mesh, tuple(t.shape)))


def distribute_as(t: torch.Tensor, mesh: Any, placements: tuple) -> torch.Tensor:
    """:func:`distribute` with the placements given."""
    return from_block(t[local_block(tuple(t.shape), mesh, tuple(placements))], mesh,
                      placements, t.shape)


def empty_sharded(shape: tuple[int, ...], dtype: torch.dtype, spec: tuple, mesh: Any,
                  device: torch.device) -> torch.Tensor:
    """An uninitialised DTensor of global ``shape``: only this rank's block is
    made, so under a ``FakeTensorMode`` nothing is allocated."""
    pl = placements_for(spec, mesh, shape)
    block = local_block(shape, mesh, pl)
    local = torch.empty([s.stop - s.start for s in block], dtype=dtype, device=device)
    return from_block(local, mesh, pl, shape)


# ---------------------------------------------------------------------------
# Ambient rules and the constraint points
# ---------------------------------------------------------------------------

_CTX = threading.local()


def current_rules() -> ShardingRules | None:
    return getattr(_CTX, "rules", None)


@contextlib.contextmanager
def use_sharding_rules(rules: ShardingRules | None):
    """Install ambient sharding rules for model code."""
    prev = getattr(_CTX, "rules", None)
    _CTX.rules = rules
    try:
        yield rules
    finally:
        _CTX.rules = prev


def seq_sharded() -> bool:
    """True when the ambient rules shard the activation 'seq' axis: the
    sequence-parallel mode of archs whose head counts do not divide the model
    axis (qwen1.5, minicpm3, whisper)."""
    rules = current_rules()
    return bool(rules and rules.mesh is not None and rules.mesh_axes_for("seq"))


def resolve_spec(logical_axes: Iterable[str | None], rules: ShardingRules | None = None) -> tuple:
    rules = rules or current_rules()
    if rules is None:
        return ()
    return rules.spec_for(logical_axes)


def shard(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """A sharding constraint in logical axes: a DTensor is redistributed to
    the placements the ambient rules give its shape, and so is its gradient
    (as the reference's constraint binds the cotangent too); a plain tensor,
    or any tensor without rules, is returned as it is."""
    rules = current_rules()
    if rules is None or rules.mesh is None or not is_dtensor(x):
        return x
    pl = placements_for(rules.spec_for_shape(tuple(x.shape), logical_axes), x.device_mesh,
                        tuple(x.shape))
    if tuple(x.placements) != pl:
        x = x.redistribute(x.device_mesh, pl)
    if x.requires_grad and torch.is_grad_enabled():
        x = _GradPlacements.apply(x, pl)
    return x


class _GradPlacements(torch.autograd.Function):
    """Identity whose gradient is redistributed to ``placements``."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def pad(x: torch.Tensor, pads: tuple[int, ...]) -> torch.Tensor:
    """``F.pad`` with zeros; a DTensor is padded block by block, the padded
    dims gathered first (DTensor's own pad fails on some releases)."""
    import torch.nn.functional as F

    if not is_dtensor(x):
        return F.pad(x, pads)
    grown = {x.ndim - 1 - i: pads[2 * i] + pads[2 * i + 1] for i in range(len(pads) // 2)}
    x = gather_dims(x, tuple(d for d, n in grown.items() if n))
    shape = [n + grown.get(d, 0) for d, n in enumerate(x.shape)]
    return from_block(F.pad(x.to_local(), pads), x.device_mesh, x.placements, shape)


def gather_dims(x: torch.Tensor, dims: tuple[int, ...], keep: list[bool] | None = None
                ) -> torch.Tensor:
    """A DTensor with its shards of tensor dims ``dims`` gathered (those
    mesh dims replicated, but for the mesh dims ``keep`` marks) and its
    partial sums reduced, the other shards kept."""
    Replicate = placement_types()[1]
    keep = keep or [False] * len(x.placements)
    return redistributed(x, [Replicate() if p.is_partial() or (p.is_shard() and p.dim in dims and not k)
                             else p for p, k in zip(x.placements, keep)])


def idle_contraction(x_shape: tuple[int, ...], x_placements, w_placements, mesh
                     ) -> tuple[int, int] | None:
    """The mesh dims ``(i, j)`` on which :func:`matmul` contracts w's FSDP
    blocks over an idle axis, or None.  Dim i is idle: neither x's rows nor
    w's columns are sharded there (8 KV heads' wk and wv on a 16-way
    "model" axis, 4 q heads' wq on an 8-way one, grok-1's router with its
    experts replicated).  Dim j holds w's rows (the FSDP overlay's "data",
    n ranks) beside x's rows, so the other branches would gather the whole
    weight over j and compute the whole product on every rank of i.  The
    rule applies where i has m = c * n ranks (c >= 1), n > 1, m divides the
    contraction K, nothing else shards x's last dim or w's rows, and the
    rows on a rank are fewer than K: the partial output it all-reduces
    (rows x N) is then smaller than the weight (K x N) the other branches
    gather.  That boundary is the reference's, read off its compiled decode
    and prefill steps on ("data", "model") host meshes of (2, 2), (4, 4),
    (2, 4), (2, 6), (3, 6), (2, 8), (4, 8) and (2, 16) devices, at K = 20,
    96 and 192: a collective-permute of K / m rows of wq, wk and wv, and an
    all-reduce over "model", up to K - 1 rows a rank; at K rows the weight
    gathered over "data" and the whole product, as here.  Where "model" is
    smaller than "data", or no multiple of it ((4, 2), (8, 2), (4, 6)),
    the reference gathers.  On the (16, 16) production mesh
    nemotron-4-340b ``decode_32k`` has 8 rows a rank against K = 18,432,
    grok-1 ``decode_32k`` 8 against 6,144 (wk, wv and the router): they
    contract; their ``prefill_32k`` has 65,536 rows a rank (32,768 on the
    multi-pod mesh): it gathers.  ``train_4k``'s microbatch of 8 sequences
    does not shard over "data", so it never meets the rule."""
    last = len(x_shape) - 1
    if any(p.is_partial() for p in (*x_placements, *w_placements)) or \
            any(p.is_shard(last) for p in x_placements):
        return None
    fsdp = [j for j, p in enumerate(w_placements) if p.is_shard(0)]
    if len(fsdp) != 1 or not (x_placements[fsdp[0]].is_shard()):
        return None
    j, k = fsdp[0], x_shape[-1]
    n = mesh.size(j)
    block = local_block(x_shape, mesh, tuple(x_placements))
    rows = int(np.prod([s.stop - s.start for s in block[:-1]]))
    for i, (px, pw) in enumerate(zip(x_placements, w_placements)):
        m = mesh.size(i)
        if i != j and n > 1 and m % n == 0 and px.is_replicate() and pw.is_replicate() \
                and k % m == 0 and rows < k:
            return i, j
    return None


def _shift_rows(block: torch.Tensor, group_name: str, n: int, r: int, shift: int) -> torch.Tensor:
    """Group rank r receives the block of rank (r + shift) mod n and sends
    its own to rank (r - shift) mod n: one all_to_all_single, a permute."""
    send, recv = [0] * n, [0] * n
    send[(r - shift) % n] = recv[(r + shift) % n] = block.shape[0]
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(c10d.all_to_all_single(block.contiguous(), recv, send, group_name))


class _ShiftRows(torch.autograd.Function):
    """:func:`_shift_rows`, whose gradient goes back to the block's owner."""

    @staticmethod
    def forward(ctx, block, group_name, n, r, shift):
        ctx.args = (group_name, n, r, -shift)
        return _shift_rows(block, group_name, n, r, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift_rows(g, *ctx.args), None, None, None, None


def contract_block(x_block: torch.Tensor, w_block: torch.Tensor) -> torch.Tensor:
    """One rank's partial product over its block of K, in f32.  On the card,
    bf16 or f16 operands go through a product with an f32 output (tensor
    cores, nothing rounded before the reduction) where no gradient is
    needed, as that product has none; otherwise the operands are cast to
    f32 first, as the reference's compiled program casts them."""
    if x_block.is_cuda and x_block.dtype in (torch.bfloat16, torch.float16) and not (
            torch.is_grad_enabled() and (x_block.requires_grad or w_block.requires_grad)):
        out = torch.mm(x_block.reshape(-1, x_block.shape[-1]), w_block, out_dtype=torch.float32)
        return out.reshape(*x_block.shape[:-1], w_block.shape[1])
    return x_block.float() @ w_block.float()


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., K) and w (K, N).  On DTensors it runs on this
    rank's blocks, as the kernels do (:mod:`repro_torch.kernels.ops`): per
    mesh dim x's row shards are kept (w gathered there), else w's column
    shards (x gathered), else a contraction shard of either side with the
    other side's matching block, whose product is partial; anything else is
    gathered.  Running the product block by block never flattens a sharded
    row dim (a sequence shard under sequence parallelism), which DTensor's
    own matmul does; a replicated operand whose gradient differs per block
    gets a partial gradient.

    Where :func:`idle_contraction` finds an idle dim i of m = c * n ranks
    beside w's FSDP dim j of n, K is contracted over i in m slices of K /
    m instead: the rank at (a on j, b on i) keeps its rows of x and
    contracts slice s = (a * c + b) mod m.  That slice is slice s mod c of
    the FSDP block of j rank floor(s / c) = (a + floor(b / c)) mod n, so
    for one b every rank of the j group sends slice b mod c of its own
    block floor(b / c) ranks down the group (one permute, not a gather).
    x's matching slice is at hand (x is replicated on i: nothing moves);
    the product runs in f32 and returns an f32 output ``Partial`` on i,
    which the caller reduces and casts.  The reference's compiled program
    converts the operands to f32 and all-reduces the partial in f32 (its
    permutation of the slices is another; any whose slices cover K over i
    gives the same sum).  With c = 1 the slice is the whole block.  x's
    gradient is partial on i, and w's slice gradient goes back to its
    owner, partial on i."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return x @ w
    Partial, Replicate, Shard = placement_types()
    mesh = (x if is_dtensor(x) else w).device_mesh
    x, w = as_dtensor(x, mesh), as_dtensor(w, mesh)
    last = x.ndim - 1
    idle = idle_contraction(tuple(x.shape), x.placements, w.placements, mesh)
    x_pl, w_pl, out_pl, gx, gw = [], [], [], [], []
    for d, (px, pw) in enumerate(zip(x.placements, w.placements)):
        if idle and d == idle[0]:  # contracted on permuted blocks
            x_pl.append(px), w_pl.append(pw), out_pl.append(Partial())
            gx.append(Partial()), gw.append(Partial())
        elif idle and d == idle[1]:  # x's rows beside w's FSDP blocks, both kept
            x_pl.append(px), w_pl.append(pw), out_pl.append(px)
            gx.append(px), gw.append(pw)
        elif px.is_shard() and px.dim < last:  # x's rows
            x_pl.append(px), w_pl.append(Replicate()), out_pl.append(px)
            gx.append(px), gw.append(Partial())
        elif pw.is_shard(1):  # w's columns
            x_pl.append(Replicate()), w_pl.append(pw), out_pl.append(Shard(last))
            gx.append(Partial()), gw.append(pw)
        elif px.is_shard(last) or pw.is_shard(0):  # the contraction
            x_pl.append(Shard(last)), w_pl.append(Shard(0)), out_pl.append(Partial())
            gx.append(Shard(last)), gw.append(Shard(0))
        else:
            x_pl.append(Replicate()), w_pl.append(Replicate()), out_pl.append(Replicate())
            gx.append(Replicate()), gw.append(Replicate())
    x, w = redistributed(x, x_pl), redistributed(w, w_pl)
    xl, wl = x.to_local(grad_placements=gx), w.to_local(grad_placements=gw)
    if idle:
        i, j = idle
        n, m, a, b = mesh.size(j), mesh.size(i), mesh.get_coordinate()[j], mesh.get_coordinate()[i]
        c, kb = m // n, x.shape[-1] // m
        shift, r = divmod(b, c)
        wl = _ShiftRows.apply(wl.narrow(0, r * kb, kb), mesh.get_group(j).group_name, n, a, shift)
        s = (a * c + b) % m
        out = contract_block(xl[..., s * kb:(s + 1) * kb], wl)
    else:
        out = xl @ wl
    return from_block(out, mesh, out_pl, (*x.shape[:-1], w.shape[1]))


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` without an ellipsis; on DTensors it runs on this
    rank's blocks.  Per mesh dim one index that an operand is sharded on is
    kept, an index of the output first, else a contracted one: every
    operand holding that index is sharded on it there (and its block gets
    its own gradient), the others are replicated (and get a partial
    gradient).  A kept output index shards the output; a kept contracted
    index leaves each rank the sum over its own blocks, a ``Partial``
    output, reduced where the next op or constraint needs it (as GSPMD
    all-reduces or reduce-scatters a dot's partial sums).  Any other shard
    is gathered, and a partial operand is reduced.  DTensor's own einsum
    flattens the batch indices into one dim, which a shard of an inner one
    (heads, say) cannot survive."""
    if not any(is_dtensor(t) for t in operands):
        return torch.einsum(eq, *operands)
    Partial, Replicate, Shard = placement_types()
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    mesh = next(t.device_mesh for t in operands if is_dtensor(t))
    ops = [as_dtensor(t, mesh) for t in operands]
    pls, grads, out_pl = [[] for _ in ops], [[] for _ in ops], []
    for i in range(mesh.ndim):
        sharded = [spec[t.placements[i].dim] for spec, t in zip(ins, ops) if t.placements[i].is_shard()]
        keep = next((c for c in sharded if c in out), None)
        if keep is None:  # a contracted index, read once by each operand holding it
            keep = next((c for c in sharded if all(spec.count(c) < 2 for spec in ins)), None)
        for k, spec in enumerate(ins):
            if keep is not None and keep in spec:
                pls[k].append(Shard(spec.index(keep)))
                grads[k].append(Shard(spec.index(keep)))
            else:
                pls[k].append(Replicate())
                grads[k].append(Partial() if keep is not None else Replicate())
        out_pl.append(Replicate() if keep is None else
                      Shard(out.index(keep)) if keep in out else Partial())
    ops = [redistributed(t, pl) for t, pl in zip(ops, pls)]
    local = torch.einsum(eq, *[t.to_local(grad_placements=g) for t, g in zip(ops, grads)])
    size = {c: n for spec, t in zip(ins, ops) for c, n in zip(spec, t.shape)}
    return from_block(local, mesh, out_pl, tuple(size[c] for c in out))


def constrain_layer_params(lp: Any, template: Any) -> Any:
    """Pin one layer's parameters to their tensor-parallel-only placements
    (d_model replicated) where the FSDP overlay is active.  Unused, as in the
    reference, whose measurement refuted it (re-gathers in forward, backward
    and recompute without freeing the hoisted buffer)."""
    rules = current_rules()
    if rules is None or rules.mesh is None or not rules.mesh_axes_for("d_model"):
        return lp
    tp_rules = rules.with_overrides({"d_model": None})

    def one(leaf, spec):
        if not is_dtensor(leaf):
            return leaf
        pl = placements_for(tp_rules.spec_for_shape(tuple(leaf.shape), spec.axes), leaf.device_mesh,
                            tuple(leaf.shape))
        return leaf.redistribute(leaf.device_mesh, pl)

    return map_pair(one, lp, template)


# ---------------------------------------------------------------------------
# Parameter templates
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Declarative parameter leaf: shape, logical axes (one per dimension),
    init law and dtype."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'ssm_a' | 'ssm_dt'
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")

    def stacked(self, n: int) -> "TensorSpec":
        """Prepend the scan-over-layers axis (logical axis ``layers``)."""
        return dataclasses.replace(self, shape=(n, *self.shape), axes=("layers", *self.axes))


def map_template(fn, template: Any) -> Any:
    if isinstance(template, dict):
        return {k: map_template(fn, v) for k, v in template.items()}
    return fn(template)


def map_pair(fn, tree: Any, other: Any) -> Any:
    """``fn(leaf, other_leaf)`` over two trees of the same dict structure."""
    if isinstance(tree, dict):
        return {k: map_pair(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def stack_template(template: Any, n: int) -> Any:
    return map_template(lambda s: s.stacked(n), template)


def param_count(template: Any) -> int:
    if isinstance(template, dict):
        return sum(param_count(v) for v in template.values())
    return int(np.prod(template.shape))


def param_bytes(template: Any, dtype_bytes: int = 2) -> int:
    return param_count(template) * dtype_bytes


def specs_from_template(template: Any, rules: ShardingRules) -> Any:
    """Resolved-spec tree matching the template (shape-aware)."""
    return map_template(lambda s: rules.spec_for_shape(s.shape, s.axes), template)


def specs_for_axes(abstract: Any, axes: Any, rules: ShardingRules) -> Any:
    """Resolved-spec tree of a tree of tensors (meta or real) whose logical
    axes come as a parallel tree of tuples: the caches and batches."""
    return map_pair(lambda t, ax: rules.spec_for_shape(tuple(t.shape), ax), abstract, axes)


def abstract_from_template(template: Any, dtype: Any | None = None) -> Any:
    """Meta tensors of the template's shapes and dtypes: never allocated."""
    return map_template(
        lambda s: torch.empty(s.shape, dtype=dtype or s.dtype, device="meta"), template)


# -- init laws ---------------------------------------------------------------


def init_std(spec: TensorSpec) -> float:
    """The reference's init law: std = 1/sqrt(shape[0]) for rank >= 2.

    On a stacked layer leaf shape[0] is ``n_layers``, so every layer weight
    gets std 1/sqrt(n_layers) (1/6 for 36-layer granite).  Copied as it is so
    that a port-initialised model behaves like a JAX-initialised one."""
    fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
    return 1.0 / float(np.sqrt(max(fan_in, 1)))


def ssm_a_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """The reference's ``ssm_a`` law on uniform draws u in [0, 1): Mamba2's A
    is a negative scalar per head, A = -exp(u * (log 16 - log 1) + log 1).
    The leaf that holds it is named ``a_log``; the model uses it as A."""
    return -torch.exp(u * float(np.log(16.0) - np.log(1.0)) + float(np.log(1.0)))


def ssm_dt_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """The reference's ``ssm_dt`` law: dt = exp(u * (log 0.1 - log 1e-3) +
    log 1e-3) spans [1e-3, 1e-1], and the bias is softplus's inverse of it."""
    dt = torch.exp(u * float(np.log(0.1) - np.log(1e-3)) + float(np.log(1e-3)))
    return dt + torch.log(-torch.expm1(-dt))


def init_leaf(spec: TensorSpec, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """One leaf in full, drawn from ``gen`` under the reference's law."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init in ("ssm_a", "ssm_dt"):
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float32, device=device)
        law = ssm_a_from_uniform if spec.init == "ssm_a" else ssm_dt_from_uniform
        return law(u).to(spec.dtype)
    if spec.init != "normal":
        raise ValueError(f"unknown init {spec.init!r}")
    std = init_std(spec)
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    # draw in f32 one layer slice at a time: the largest granite leaf is
    # 8.5 GB in f32 but one layer slice of it is 235 MB
    for part in out.unbind(0) if len(spec.shape) > 2 else (out,):
        noise = torch.randn(part.shape, generator=gen, dtype=torch.float32, device=device)
        part.copy_(noise.mul_(std))
    return out


def distribute_tree(tree: Any, template: Any, rules: ShardingRules) -> Any:
    """Full tensors (the same on every rank), placed by the template's
    logical axes under ``rules``."""
    return map_pair(lambda t, s: distribute(t, rules.spec_for_shape(s.shape, s.axes), rules.mesh),
                    tree, template)


def init_from_template(template: Any, gen: torch.Generator, device: torch.device,
                       rules: ShardingRules | None = None) -> Any:
    """Parameters drawn leaf by leaf, in template order, from ``gen``.  With
    rules on a mesh each leaf is drawn in full and then distributed (this
    rank keeps its block), so a sharded model starts from exactly the
    weights of the unsharded one with the same generator."""
    def one(s: TensorSpec) -> torch.Tensor:
        t = init_leaf(s, gen, device)
        if rules is None or rules.mesh is None:
            return t
        return distribute(t, rules.spec_for_shape(s.shape, s.axes), rules.mesh)

    return map_template(one, template)
