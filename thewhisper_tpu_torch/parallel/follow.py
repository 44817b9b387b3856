"""Leader and followers of a meshed engine.

JAX has one controller, so its pipeline, coalescer and server exist once
and every device runs what that one program launches. Here each rank is a
process, and rank 0 alone runs the user's program (pipeline, coalescer,
server) on its ``WhisperEngine(mesh=...)``. The ranks above 0 run
:func:`follow`, which mirrors every device program rank 0 launches: before
each encode (K1 and the encoder, with the tp all-reduces) and each decode
(the loop, with its all-reduces, and the gather of the rows), rank 0
broadcasts the program's key and inputs (:class:`Mirror`: the mel or audio
with the encode, a speculative call's proposal tokens with the decode),
and every rank then runs it.

Programs are mirrored, not public calls: the pipeline queues window n+1's
encoder before it fetches window n (``engine.PendingResult``), and a
coalescer builds its batches from its own clock, so the order in which
rank 0 launches is the only order every rank can share. Messages go over
the mesh's gloo group on the host; input tensors over the default group,
on the device (NCCL, or gloo through host memory). ``close()`` on rank 0's
engine ends the followers' loops.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from thewhisper_tpu_torch.parallel.mesh import Mesh, batch_rows


class Mirror:
    """What the ranks of a meshed engine share: rank 0 (``leader``) sends
    each program's message, the others receive it; :meth:`gather_rows`
    brings the dp groups' result rows to rank 0."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.leader = mesh.rank == 0
        self._ids = itertools.count()

    def send(self, msg: Tuple, tensor: Optional[torch.Tensor] = None) -> None:
        """Rank 0: broadcast ``msg`` (picklable, on the host), then
        ``tensor`` (on its device)."""
        import torch.distributed as dist

        dist.broadcast_object_list([msg], src=0, group=self.mesh.host_group)
        if tensor is not None:
            dist.broadcast(tensor.contiguous(), src=0)

    def recv(self) -> Tuple:
        import torch.distributed as dist

        box: List[Any] = [None]
        dist.broadcast_object_list(box, src=0, group=self.mesh.host_group)
        return box[0]

    def recv_tensor(self, shape: Sequence[int], dtype: str) -> torch.Tensor:
        import torch.distributed as dist

        t = torch.empty(tuple(shape), dtype=getattr(torch, dtype),
                        device=self.mesh.device)
        dist.broadcast(t, src=0)
        return t

    def encode(self, handle) -> torch.Tensor:
        """A handle's input rows this rank encodes: rank 0 first sends the
        handle's message and its whole padded input."""
        x = handle._x
        if self.leader:
            handle.id = next(self._ids)
            self.send(("encode", handle.id, handle._audio, handle.b,
                       handle.options, handle.languages, tuple(x.shape),
                       str(x.dtype).split(".")[1]), x)
        return x[batch_rows(self.mesh, x.shape[0])]

    def decode(self, handle, key: Tuple, warm: bool,
               proposals: Optional[np.ndarray] = None) -> None:
        """Rank 0: send a handle's decode (its program key, whether warmup
        made that key, and the call's (bucket, max_new) proposal tokens or
        None: host data only rank 0 has); the others check that they
        computed the same key (its mode among it) from them."""
        if self.leader:
            self.send(("decode", handle.id, key, warm, proposals))
        elif key != handle.mirror_key:
            raise RuntimeError(f"rank {self.mesh.rank} out of step: key {key}, "
                               f"rank 0's {handle.mirror_key}")

    def gather_rows(self, rows: List[np.ndarray], counts: Tuple, bucket: int
                    ) -> Optional[Tuple[List[np.ndarray], Tuple]]:
        """The whole bucket's result rows and loop counts (decode steps,
        speculative rounds; None where the loop has none), on rank 0 (None
        elsewhere). Where dp splits the bucket, tp rank 0 of each dp group
        sends its rows (each group's the same shape, the bucket's share)
        and rank 0 stacks them in dp order; each count is the most any
        group ran, as one program over the whole bucket runs. Where dp
        does not split it, every rank holds every row and nothing moves."""
        import torch.distributed as dist

        mesh = self.mesh
        if batch_rows(mesh, bucket) == slice(0, bucket):
            return (rows, counts) if self.leader else None
        payload = (rows, counts) if mesh.tp_rank == 0 else None
        parts: Optional[List[Any]] = [None] * mesh.size if self.leader else None
        dist.gather_object(payload, parts, dst=0, group=mesh.host_group)
        if not self.leader:
            return None
        parts = [parts[d * mesh.tp] for d in range(mesh.dp)]
        most = tuple(None if c is None else max(p[1][i] for p in parts)
                     for i, c in enumerate(counts))
        return ([np.concatenate([p[0][i] for p in parts])
                 for i in range(len(rows))], most)


def follow(engine) -> None:
    """Run a rank above 0 of a meshed engine: mirror each program rank 0's
    engine launches, in its order, until rank 0 calls ``close()``. A
    handle rank 0 gives up (``release()``) is dropped here too; one that
    rank 0 drops without either keeps its encoder states here until the
    close."""
    from thewhisper_tpu_torch.engine.engine import PendingResult

    mirror = engine._mirror
    if mirror is None or mirror.leader:
        raise ValueError(
            "follow() runs on the ranks above 0 of a meshed engine")
    handles = {}
    while True:
        msg = mirror.recv()
        op = msg[0]
        if op == "encode":
            _, hid, audio, b, options, languages, shape, dtype = msg
            handle = PendingResult(engine, mirror.recv_tensor(shape, dtype),
                                   audio, b, options, languages,
                                   time.perf_counter())
            handle.id = hid
            handles[hid] = handle
            handle.encode()
        elif op == "decode":
            _, hid, key, warm, proposals = msg
            handle = handles.pop(hid)
            handle.mirror_key = key
            handle.draft_tokens = proposals
            if warm:
                engine._warm_keys.add(key)
            handle.result()
        elif op == "release":
            handles.pop(msg[1]).release()
        elif op == "detect":
            _, shape, dtype = msg
            engine.detect_language(mirror.recv_tensor(shape, dtype))
        elif op == "close":
            return
        else:
            raise RuntimeError(f"unknown message {op!r}")
