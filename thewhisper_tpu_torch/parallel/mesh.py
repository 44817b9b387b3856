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
# counting them).
ALL_REDUCES = 0
CAPTURED_ALL_REDUCES = 0

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
        import torch.distributed as dist

        global ALL_REDUCES, CAPTURED_ALL_REDUCES
        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        ALL_REDUCES += 1
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            CAPTURED_ALL_REDUCES += 1
        return x


class RowParallelLinear(nn.Linear):
    """A linear that holds this rank's block of input columns: the partial
    product is all-reduced over ``tp``, then the bias, which every rank
    holds whole, is added once (JAX's ``P(None)`` bias after GSPMD's
    reduce). At tp = 1 the bias goes into the product, as ``nn.Linear``
    adds it, so a mesh of one rank computes what the unsharded model
    does, bit for bit. Weights of another type than x are cast to x's
    (``models.whisper._linear``'s rule)."""

    tp: TensorParallel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if w.dtype != x.dtype:
            w, b = w.to(x.dtype), b.to(x.dtype)
        if self.tp.size == 1:
            return self.tp.all_reduce(F.linear(x, w, b))
        return self.tp.all_reduce(F.linear(x, w)) + b


def _row_parallel(lin: nn.Linear, weight: torch.Tensor,
                  tp: TensorParallel) -> RowParallelLinear:
    with torch.device("meta"):
        row = RowParallelLinear(weight.shape[1], weight.shape[0],
                                dtype=weight.dtype)
    row.weight = nn.Parameter(weight, requires_grad=False)
    row.bias = nn.Parameter(lin.bias.detach(), requires_grad=False)
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
    Returns ``model``."""
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
        part = param.detach().chunk(tp.size, dim=spec.dim)[tp.rank].clone()
        mod_name, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        if isinstance(mod, nn.Linear) and spec.dim == 1:
            parent, child = mod_name.rsplit(".", 1)
            setattr(model.get_submodule(parent), child,
                    _row_parallel(mod, part, tp))
            continue
        setattr(mod, leaf, nn.Parameter(part, requires_grad=False))
        if isinstance(mod, nn.Linear) and leaf == "weight":
            mod.out_features = part.shape[0]
    for attn in _attentions(model):
        attn.n_heads //= tp.size
    model.tp = tp
    model.__dict__.pop("_align_sel", None)
    return model
