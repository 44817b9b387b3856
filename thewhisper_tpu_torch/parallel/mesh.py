"""The (dp, tp) device mesh and its sharding rules (port of thewhisper_tpu's
``parallel/mesh.py``).

JAX has one controller: the parameters and inputs carry ``NamedSharding``s
and GSPMD inserts the collectives. Here every rank is a process of its own
(``parallel.launch``) and the collectives are written out, Megatron style,
from the same partition rules (:func:`param_pspecs`):

- ``dp`` splits the padded batch bucket (:func:`batch_rows`); each dp
  group decodes its rows with no collective inside its loop, and the rows
  are gathered back to rank 0 at the end.
- ``tp`` splits the attention heads and the MLP's hidden width. The
  column-parallel linears (``q``, ``k``, ``v``, ``fc1`` and their biases)
  keep this rank's block of output rows: the weight's dim 0 in torch's
  (out, in) layout, JAX's last axis in its (in, out) one. The
  row-parallel linears (``out``, ``fc2``) keep the matching block of input
  columns (dim 1); their partial products are all-reduced over ``tp`` and
  the bias, which JAX leaves replicated, is added once, after the reduce
  (:class:`RowParallelLinear`). LayerNorms, the conv stem and the
  embeddings stay whole on every rank.

A sharded model's attention modules hold ``heads // tp`` heads, its
decode cache and cross K/V as many, and its alignment capture sums the
heads of every tp rank (``models.whisper``). The residual stream after
each reduce is the same on every rank of a tp group, so the replicated
logits and the tokens picked from them are too (the tests assert it).

Training (JAX's ``shard_params`` before ``tx.init``, the batch on
``P("dp")``, GSPMD's gradient psums) has one process a rank here, so the
conjugate pairs are written out as Megatron's *f* and *g*, each a
``torch.autograd.Function``:

- :func:`reduce_from_tp` (*g*): all-reduce over ``tp`` forward, identity
  backward; :class:`RowParallelLinear` sums its partial product through
  it, so its bias (added once, after the reduce) gets a replicated
  gradient.
- :func:`copy_to_tp` (*f*): identity forward, all-reduce over ``tp``
  backward; ``models.whisper`` puts it where a replicated activation
  enters column-parallel linears (the LayerNorm outputs before q/k/v and
  fc1, the cross q's input, the encoder states once before the decoder).
  With it, every replicated leaf's gradient (LayerNorms, embeddings, the
  conv stem, positions) comes out the same bits on every tp rank (the
  conv stem's once cuDNN runs deterministic algorithms, which a meshed
  train step asks for).

Both are identities at tp = 1, where the row-parallel bias stays inside
the product, so a mesh of one rank computes what the unsharded model
does. Over ``dp``, :func:`reduce_gradients` sums the gradients in flat
buckets after the backward (``training.train.make_train_step``), and
:func:`sum_over_dp` gives the loss its global denominator.

The sequence-parallel encoder (JAX's ``seq_sharding``: batch over ``dp``,
time over ``tp``; :func:`seq_rows`, :func:`gather_seq`) runs on whole
encoder weights: each tp rank keeps a block of time rows
(:func:`split_seq`), all-gathers K and V over ``tp`` (:func:`gather_kv`)
and runs K2 with its queries over every key. Splitting heads and time
over the same axis at once would need an all-to-all that JAX's GSPMD
hides; SP's purpose is activation memory on long audio, which whole
weights leave intact (a turbo encoder is 1.3 GB in bf16). So a tp-sharded
model passed to it raises ``ValueError``.

Under autograd (JAX's ``jax.grad`` through its ``with_sharding_constraint``s)
each of SP's steps has its conjugate, an ``autograd.Function`` with the
collective written out:

- :func:`gather_kv`'s all-gather of the K and V blocks: a reduce-scatter
  over ``tp``. Every rank's queries put gradient on every key, so rank
  r's block of dK and dV is the sum of all ranks' contributions to rows
  [r c, (r + 1) c) (the pad rows past T get none: K2-dkv writes zeros for
  keys >= valid_len).
- :func:`split_seq`'s slice and pad: a scatter of the block's gradient
  into a zero (B, T, d), so everything upstream of it (the conv stem and
  positions, which every rank runs on the whole mel, and the mel itself)
  gets this rank's rows' share.
- :func:`gather_seq`'s all-gather of the output blocks: a slice of this
  rank's block. A loss on the assembled (B, T, d) is the same on every tp
  rank, so each rank's cotangent is already the whole one; a
  reduce-scatter here (the conjugate of an all-gather whose input blocks
  are summed into one loss) would multiply the gradient by tp.
- Whole weights: each rank's gradient of every encoder leaf covers its
  own rows, so :func:`sum_over_tp` sums them (and the mel's) over ``tp``,
  as :func:`reduce_gradients` sums over ``dp``; after it the replicated
  gradients are the same bits on every tp rank.

Remat re-runs :func:`gather_kv` inside the backward; every rank re-runs
it in the same order, as it re-runs *g*.

Rank r sits at (r // tp, r % tp) of the mesh: JAX's ``reshape(dp, tp)``
of the device list. ``torch.distributed`` is imported inside the
functions that need it, so importing this module stays cheap.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# All-reduces a sharded model issued since import, and how many of them
# were recorded into a CUDA graph (a replay runs those again without
# counting them); all-gathers (the sequence-parallel encoder's K/V,
# gather_seq, gather_params); reduce-scatters (gather_kv's backward).
ALL_REDUCES = 0
CAPTURED_ALL_REDUCES = 0
ALL_GATHERS = 0
REDUCE_SCATTERS = 0

# Bytes of gradients summed over dp by one all-reduce
# (DistributedDataParallel's default bucket).
GRAD_BUCKET_BYTES = 25 * 2 ** 20

# Seconds a collective of the host group (a meshed engine's messages) may
# wait: the ranks above 0 wait there while rank 0's server is idle.
HOST_TIMEOUT_S = 24 * 3600.0


def mesh_shape(n_devices: int, dp: Optional[int] = None,
               tp: Optional[int] = None) -> Tuple[int, int]:
    """JAX's ``make_mesh`` split of ``n_devices``: tp = 2 when the count
    is even (every Whisper size's heads divide by 2), else 1; ``dp`` given
    alone derives tp = n // dp. Raises ``ValueError`` where dp * tp != n."""
    n = n_devices
    if tp is None:
        tp = n // dp if dp else 2 if n % 2 == 0 and n >= 2 else 1
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != n_devices({n})")
    return dp, tp


def local_device(device=None) -> torch.device:
    """``device`` with its index filled in: by default the current CUDA
    device where there is a card, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_divides(arch, tp: int) -> None:
    """``ValueError`` unless tp divides both head counts and ``d_ff``."""
    for name in ("encoder_heads", "decoder_heads", "d_ff"):
        if getattr(arch, name) % tp:
            raise ValueError(f"tp={tp} does not divide {name}="
                             f"{getattr(arch, name)}")


@dataclasses.dataclass
class Mesh:
    """One rank's view of a ``(dp, tp)`` mesh: its shape, its rank and, once
    the process group is up (:func:`make_mesh` after
    ``parallel.launch.init``), the ``DeviceMesh`` with dims ``("dp",
    "tp")``, the gloo group that carries the host's messages and gathers,
    and the backend of the device collectives. Without a process group it
    is a layout alone (shape and rank), which :func:`shard_params` can
    read and an engine refuses."""

    dp: int
    tp: int
    rank: int = 0
    device: torch.device = torch.device("cpu")
    device_mesh: Any = None
    host_group: Any = None
    backend: Optional[str] = None

    @property
    def shape(self) -> Tuple[int, int]:
        return self.dp, self.tp

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def live(self) -> bool:
        """Whether the process group behind it is up."""
        return self.device_mesh is not None

    def group(self, dim: str):
        """The process group of mesh dim ``"dp"`` or ``"tp"`` (None for a
        layout)."""
        return (None if self.device_mesh is None
                else self.device_mesh.get_group(dim))


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None, arch=None, device=None) -> Mesh:
    """A ``(dp, tp)`` mesh over ``n_devices`` ranks (JAX's split and
    ``ValueError``s, :func:`mesh_shape`; with ``arch``, also where tp does
    not divide its heads or ``d_ff``).

    With the process group up, ``n_devices`` defaults to (and must equal)
    the world size, and every rank must call this in the same order: it
    builds the ``DeviceMesh`` (``init_device_mesh(device.type, (dp, tp),
    mesh_dim_names=("dp", "tp"))``) and a gloo group over every rank for
    the host's messages (``HOST_TIMEOUT_S``). ``device`` is this rank's
    (:func:`local_device`). Without a process group the mesh is a layout
    for rank 0 of ``n_devices`` (default 1)."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else None
    n = n_devices or world or 1
    dp, tp = mesh_shape(n, dp, tp)
    if arch is not None:
        check_divides(arch, tp)
    device = local_device(device)
    if not up:
        return Mesh(dp, tp, device=device)
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    import datetime

    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(device.type, (dp, tp),
                                   mesh_dim_names=("dp", "tp"))
    host = dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=HOST_TIMEOUT_S))
    return Mesh(dp, tp, rank=dist.get_rank(), device=device,
                device_mesh=device_mesh, host_group=host,
                backend=dist.get_backend())


def replicated():
    """The placement of a leaf every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return Replicate()


def param_pspecs() -> Dict[str, Any]:
    """The placement of every float leaf of the port's state dict, keyed by
    its name with the layer index as ``*`` (JAX's ``param_pspecs`` in the
    port's names and (out, in) layout): ``Shard(0)`` for the
    column-parallel weights and biases, ``Shard(1)`` for the row-parallel
    weights, :func:`replicated` for the rest (the row-parallel biases
    among them). A leaf's placement: :func:`placement`."""
    from torch.distributed.tensor import Shard

    col, row, rep = Shard(0), Shard(1), replicated()

    def attn(prefix: str) -> Dict[str, Any]:
        return {f"{prefix}.q.weight": col, f"{prefix}.q.bias": col,
                f"{prefix}.k.weight": col,
                f"{prefix}.v.weight": col, f"{prefix}.v.bias": col,
                f"{prefix}.out.weight": row, f"{prefix}.out.bias": rep}

    def layer(side: str, attns, lns) -> Dict[str, Any]:
        p = f"{side}.layers.*"
        specs = {}
        for a in attns:
            specs.update(attn(f"{p}.{a}"))
        for ln in lns:
            specs.update({f"{p}.{ln}.weight": rep, f"{p}.{ln}.bias": rep})
        specs.update({f"{p}.fc1.weight": col, f"{p}.fc1.bias": col,
                      f"{p}.fc2.weight": row, f"{p}.fc2.bias": rep})
        return specs

    specs = {"encoder.conv1.weight": rep, "encoder.conv1.bias": rep,
             "encoder.conv2.weight": rep, "encoder.conv2.bias": rep,
             "encoder.pos_emb": rep,
             "encoder.ln_post.weight": rep, "encoder.ln_post.bias": rep,
             "decoder.token_emb": rep, "decoder.pos_emb": rep,
             "decoder.ln_post.weight": rep, "decoder.ln_post.bias": rep}
    specs.update(layer("encoder", ("attn",), ("ln1", "ln2")))
    specs.update(layer("decoder", ("self_attn", "cross_attn"),
                       ("ln1", "ln_cross", "ln2")))
    return specs


def placement(name: str, specs: Optional[Dict[str, Any]] = None):
    """The placement of state-dict leaf ``name`` (``KeyError`` for a leaf
    the rules do not know, such as a quantized one)."""
    specs = specs or param_pspecs()
    for pattern, spec in specs.items():
        if fnmatch.fnmatchcase(name, pattern):
            return spec
    raise KeyError(name)


def batch_rows(mesh: Mesh, bucket: int) -> slice:
    """The rows of a padded batch bucket this rank holds (JAX's
    ``batch_sharding`` as the engine's ``_transfer`` applies it): its dp
    block when dp divides the bucket, else every row."""
    if mesh.dp > 1 and bucket % mesh.dp == 0:
        m = bucket // mesh.dp
        return slice(mesh.dp_rank * m, (mesh.dp_rank + 1) * m)
    return slice(0, bucket)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, in place (x must be contiguous)."""
    import torch.distributed as dist

    global ALL_REDUCES, CAPTURED_ALL_REDUCES
    dist.all_reduce(x, group=group)
    ALL_REDUCES += 1
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        CAPTURED_ALL_REDUCES += 1
    return x


def _all_gather(x: torch.Tensor, group, size: int):
    """Every rank's ``x`` of ``group`` (``size`` ranks), in rank order."""
    import torch.distributed as dist

    global ALL_GATHERS
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(out, x, group=group)
    ALL_GATHERS += 1
    return out


def _reduce_scatter(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """``x`` (size n, ...) summed over ``group`` (``size`` ranks), this
    rank's n rows of dim 0 (rank r's are rows [r n, (r + 1) n))."""
    import torch.distributed as dist

    global REDUCE_SCATTERS
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // size, *x.shape[1:]))
    # reduce_scatter_single is the newer name of the same call.
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(
        out, x, group=group)
    REDUCE_SCATTERS += 1
    return out


class TensorParallel(NamedTuple):
    """A sharded model's tp group (``model.tp``): its size, this rank's
    place in it and the process group (None in a layout)."""

    size: int
    rank: int
    group: Any

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the group: in place, or in a contiguous copy
        where x is not contiguous (NCCL takes no strides); returns the sum.
        Also at size 1, so that a mesh of one card runs the collectives it
        would run on more."""
        return _all_reduce(x.contiguous(), self.group)

    def summed(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`all_reduce` into a new tensor (``x`` left as it is)."""
        return _all_reduce(x.clone(memory_format=torch.contiguous_format),
                           self.group)


class _CopyToTP(torch.autograd.Function):
    """Megatron's *f*: the identity forward, the gradient all-reduced over
    ``tp`` backward (each rank's column-parallel linears give the part of
    the input's gradient that its heads or hidden units make)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.summed(grad), None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's *g*: the partial products all-reduced over ``tp``
    forward, the gradient passed on as it is backward (every rank's
    partial product had the whole sum's gradient)."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.summed(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """*f* on a replicated activation ``x`` that enters column-parallel
    linears: ``x`` itself where there is no tp group or no gradient to
    carry (inference runs no collective here)."""
    if tp is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """*g*: ``x``'s partial products summed over ``tp``; under autograd
    through :class:`_ReduceFromTP` into a new tensor, else in place (the
    serving path, whose all-reduces a CUDA graph captures)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTP.apply(x, tp)
    return tp.all_reduce(x)


class RowParallelLinear(nn.Linear):
    """A linear that holds this rank's block of input columns: the partial
    product is all-reduced over ``tp`` (:func:`reduce_from_tp`), then the
    bias, which every rank holds whole, is added once (JAX's ``P(None)``
    bias after GSPMD's reduce), so its gradient is the replicated one. At
    tp = 1 the bias goes into the product, as ``nn.Linear`` adds it, so a
    mesh of one rank computes what the unsharded model does, bit for bit.
    Weights of another type than x are cast to x's
    (``models.whisper._linear``'s rule)."""

    tp: TensorParallel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if w.dtype != x.dtype:
            w, b = w.to(x.dtype), b.to(x.dtype)
        if self.tp.size == 1:
            return reduce_from_tp(F.linear(x, w, b), self.tp)
        return reduce_from_tp(F.linear(x, w), self.tp) + b


def _row_parallel(lin: nn.Linear, weight: torch.Tensor,
                  tp: TensorParallel) -> RowParallelLinear:
    with torch.device("meta"):
        row = RowParallelLinear(weight.shape[1], weight.shape[0],
                                dtype=weight.dtype)
    row.weight = nn.Parameter(weight, requires_grad=lin.weight.requires_grad)
    row.bias = nn.Parameter(lin.bias.detach(),
                            requires_grad=lin.bias.requires_grad)
    row.tp = tp
    return row


def _attentions(model):
    if model.encoder is not None:
        for layer in model.encoder.layers:
            yield layer.attn
    for layer in model.decoder.layers:
        yield layer.self_attn
        yield layer.cross_attn


def shard_params(model, mesh: Mesh):
    """Keep this rank's slice of every sharded leaf of ``model``, in place
    (JAX's ``shard_params``): column-parallel leaves their dim-0 block,
    row-parallel weights their dim-1 block, ``out`` and ``fc2`` turned into
    :class:`RowParallelLinear`; every ``Attention`` then holds ``heads //
    tp`` heads, and ``model.tp`` is the tp group. Refuses (``ValueError``)
    a quantized model, a decoder whose self q/k/v are fused, a model
    already sharded and a tp that does not divide the heads or ``d_ff``.
    Every leaf keeps ``requires_grad`` as the caller set it (JAX shards
    before ``tx.init``: so may a caller here, or after
    ``training.train.init_train_state``'s unfreezing). Returns ``model``."""
    if getattr(model, "tp", None) is not None:
        raise ValueError("the model is sharded already")
    if model.mega is not None:
        raise ValueError("a model packed for K3 does not shard")
    check_divides(model.arch, mesh.tp)
    specs = param_pspecs()
    names = [n for n, _ in model.named_parameters()]
    names += [n for n, _ in model.named_buffers()]
    for name in names:
        try:
            placement(name, specs)
        except KeyError:
            raise ValueError(
                f"{name}: only float, unfused models shard (quantized leaves "
                "and a fused self q/k/v have no rule)") from None
    tp = TensorParallel(mesh.tp, mesh.tp_rank, mesh.group("tp"))
    for name, param in list(model.named_parameters()):
        spec = placement(name, specs)
        if not spec.is_shard():
            continue
        part = local_part(param.detach(), spec, tp).clone()
        mod_name, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        if isinstance(mod, nn.Linear) and spec.dim == 1:
            parent, child = mod_name.rsplit(".", 1)
            setattr(model.get_submodule(parent), child,
                    _row_parallel(mod, part, tp))
            continue
        setattr(mod, leaf, nn.Parameter(part, requires_grad=param.requires_grad))
        if isinstance(mod, nn.Linear) and leaf == "weight":
            mod.out_features = part.shape[0]
    for attn in _attentions(model):
        attn.n_heads //= tp.size
    model.tp = tp
    model.__dict__.pop("_align_sel", None)
    return model


# ---------------------------------------------------------------------------
# Leaves: this rank's part of a whole tensor, and the whole from the parts
# ---------------------------------------------------------------------------


def local_part(x: torch.Tensor, spec, tp: TensorParallel) -> torch.Tensor:
    """This tp rank's block of the whole tensor ``x`` under placement
    ``spec`` (a view; ``x`` itself for a replicated one)."""
    if not spec.is_shard():
        return x
    return x.chunk(tp.size, dim=spec.dim)[tp.rank]


def gather_leaf(x: torch.Tensor, spec, tp: TensorParallel) -> torch.Tensor:
    """The whole tensor from every tp rank's block ``x`` (a collective of
    the tp group; a replicated ``x`` comes back as it is)."""
    if not spec.is_shard():
        return x
    return torch.cat(_all_gather(x.detach(), tp.group, tp.size), dim=spec.dim)


def gather_params(model, rank0_only: bool = False):
    """{state-dict name: whole tensor} of ``model``: every sharded leaf
    all-gathered over its tp group back to the full tensor, the replicated
    ones as they are (detached), on every rank, or with ``rank0_only`` on
    global rank 0 alone (the others return None). Every rank of the mesh
    calls it (the gathers are collectives). Used to save a meshed model,
    to compare it in tests and to hand trained weights to the
    sequence-parallel encoder. An unsharded model gives its own leaves."""
    import torch.distributed as dist

    state = model.state_dict(keep_vars=True)
    if model.tp is None:
        return {k: v.detach() for k, v in state.items()}
    specs = param_pspecs()
    out = {k: gather_leaf(v, placement(k, specs), model.tp)
           for k, v in state.items()}
    if rank0_only and dist.get_rank() != 0:
        return None
    return {k: v.detach() for k, v in out.items()}


# ---------------------------------------------------------------------------
# Training over dp
# ---------------------------------------------------------------------------


def sum_over_dp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over this rank's dp group, as a new tensor of x's
    shape (a loss, a mask count)."""
    flat = x.detach().reshape(1, -1).clone()
    return _all_reduce(flat, mesh.group("dp")).reshape(x.shape)


def _sum_gradients(params, group) -> int:
    """Sum the gradients of ``params`` over ``group`` in flat buckets, in
    place (:func:`reduce_gradients`); returns the number of all-reduces."""
    grads = []
    for p in params:
        if not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    buckets, size = [], 0
    for g in grads:
        nbytes = g.numel() * g.element_size()
        last = buckets[-1] if buckets else None
        if (last is None or last[0].dtype != g.dtype
                or last[0].device != g.device
                or size + nbytes > GRAD_BUCKET_BYTES):
            buckets.append([g])
            size = nbytes
        else:
            last.append(g)
            size += nbytes
    for bucket in buckets:
        flat = _all_reduce(torch.cat([g.reshape(-1) for g in bucket]), group)
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))
    return len(buckets)


def reduce_gradients(params, mesh: Mesh) -> int:
    """Sum the gradients of ``params`` (those that require grad, in order;
    a missing gradient counts as zeros) over the dp group, in place: the
    gradients are packed into flat buckets of one type and device of at
    most ``GRAD_BUCKET_BYTES`` (one gradient larger than that is a bucket
    of its own), each all-reduced and copied back. Every rank of a dp group
    holds the same leaves in the same order, so the buckets match.
    Returns the number of all-reduces."""
    return _sum_gradients(params, mesh.group("dp"))


def sum_over_tp(params, mesh: Mesh) -> int:
    """Sum the gradients of ``params`` over the tp group, in place, as
    :func:`reduce_gradients` sums over dp: the sequence-parallel encoder's
    whole-weight leaves (and any input that requires grad, such as the
    mel), whose gradient on each tp rank covers its own time rows. Every
    rank of the tp group gets the same bits. Returns the all-reduces."""
    return _sum_gradients(params, mesh.group("tp"))


# ---------------------------------------------------------------------------
# The sequence-parallel encoder's time split
# ---------------------------------------------------------------------------


def seq_block(mesh: Mesh, t: int) -> int:
    """The rows of every tp rank's time block: ``ceil(t / tp)``."""
    return -(-t // mesh.tp)


def seq_rows(mesh: Mesh, t: int) -> slice:
    """This rank's time rows of ``t`` encoder positions (JAX's
    ``seq_sharding``, time over ``tp``): ``[r c, min((r + 1) c, t))`` for
    tp rank r and block ``c`` (:func:`seq_block`); the last ranks' blocks
    may be short or empty where tp does not divide t."""
    c = seq_block(mesh, t)
    return slice(min(mesh.tp_rank * c, t), min((mesh.tp_rank + 1) * c, t))


class _SplitSeq(torch.autograd.Function):
    """The time split: this rank's rows of the whole (B, T, d), padded to
    the block; backward, the block's rows scattered into a zero (B, T, d)
    (the pad rows' gradient dropped)."""

    @staticmethod
    def forward(ctx, x, mesh):
        t = x.shape[1]
        rows = ctx.rows = seq_rows(mesh, t)
        ctx.shape = x.shape
        return F.pad(x[:, rows], (0, 0, 0, seq_block(mesh, t)
                                  - (rows.stop - rows.start)))

    @staticmethod
    def backward(ctx, grad):
        rows = ctx.rows
        out = grad.new_zeros(ctx.shape)
        out[:, rows] = grad[:, :rows.stop - rows.start]
        return out, None


def split_seq(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This tp rank's time rows (:func:`seq_rows`) of the (B, T, d) ``x``
    every rank holds whole, zero-padded to the block of ``ceil(T / tp)``
    rows every rank holds (pad rows sit past T in the gathered keys, where
    K2's valid_len masks them). Its gradient is the block's, scattered
    into zeros."""
    return _SplitSeq.apply(x, mesh)


class _GatherKV(torch.autograd.Function):
    """The K/V all-gather over tp; backward, a reduce-scatter over tp."""

    @staticmethod
    def forward(ctx, kv, mesh):
        ctx.mesh = mesh
        return torch.cat(_all_gather(kv, mesh.group("tp"), mesh.tp), dim=2)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        two, b, n, h, dh = grad.shape
        # (2, B, tp c, H, dh) -> (tp 2, B, c, H, dh): rank r's rows first.
        blocks = grad.reshape(two, b, mesh.tp, n // mesh.tp, h, dh).movedim(2, 0)
        part = _reduce_scatter(blocks.reshape(mesh.tp * two, b, n // mesh.tp, h, dh),
                               mesh.group("tp"), mesh.tp)
        return part, None


def gather_kv(mesh: Mesh, k: torch.Tensor, v: torch.Tensor):
    """A sequence-parallel layer's keys and values: this rank's (B, c, H,
    dh) blocks all-gathered over tp (one collective for both) into
    (B, c tp, H, dh) views of one contiguous (2, B, c tp, H, dh) tensor,
    rank r's block at rows [r c, (r + 1) c): the layout K2's TMA maps take
    (16-byte-aligned bases and strides). Under autograd the gradient of
    the gathered keys and values is reduce-scattered back over tp."""
    kv = _GatherKV.apply(torch.stack([k, v]), mesh)
    return kv[0], kv[1]


class _GatherSeq(torch.autograd.Function):
    """The output blocks' all-gather over tp; backward, this rank's slice
    of the whole cotangent (the loss that reads the assembled output is
    the same on every tp rank)."""

    @staticmethod
    def forward(ctx, x, mesh, t):
        ctx.rows = seq_rows(mesh, t)
        block = F.pad(x, (0, 0, 0, seq_block(mesh, t) - x.shape[1]))
        return torch.cat(_all_gather(block, mesh.group("tp"), mesh.tp),
                         dim=1)[:, :t]

    @staticmethod
    def backward(ctx, grad):
        return grad[:, ctx.rows], None, None


def gather_seq(mesh: Mesh, x: torch.Tensor, t: int) -> torch.Tensor:
    """The sequence-parallel encoder's output assembled: this rank's
    (B, rows, d) time block (:func:`seq_rows`) all-gathered over tp into
    (B, t, d), the same on every rank of the tp group. Its gradient is
    this rank's rows of the output's (a slice, not a reduce-scatter: see
    the module docstring)."""
    return _GatherSeq.apply(x, mesh, t)
