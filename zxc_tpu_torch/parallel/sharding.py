"""Multi-device decode and encode on ``torch.distributed``: the port of
``zxc_tpu.parallel.sharding``.

The JAX package drives every device of a ``Mesh`` from one controller.
Here each device is a rank, its own process (``parallel.launch`` starts
them), and every rank calls the same function with the same plan or data
(``plan_frame`` is deterministic). Every rank returns the whole frame's
bytes, equal to the JAX function's return value.

* **dp**: blocks shard over the ranks on the batch axis. The dp coordinate
  ``r`` holds batch rows ``[r·B/ndp, (r+1)·B/ndp)``, as ``P(dp)`` shards
  them; the sp members of one dp row hold the same rows.
* **sp**: inside a block, output position chunk ``c`` belongs to sp
  coordinate ``c``; the pointer-doubling rounds all-gather the resolution
  array over the sp group, a fixed number of rounds.
* The error words of a whole batch are gathered before any rank raises,
  so every rank raises the same first error and none is left waiting in a
  collective; then the outputs are gathered in batch order.

The per-rank work is the JAX package's: the expansion (``ops.expand``) on
decode, the tensor-op matcher and the doubling parse on encode. Every
gather goes through ``all_gather``, one call of ``dist.all_gather`` that
gloo and NCCL both take, with the tensors on the mesh's device.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import constants as C
from .. import profiling
from ..codec import block_encode
from ..codec.frame import level_params
from ..format import headers
from ..format.hashes import global_hash_update
from ..ops import encode as ENC
from ..ops import expand
from ..ops.batch import FramePlan, _pad_batch, _raise_errbits, _pow2
from ..ops.device_pipeline import _device

_I32 = torch.int32
_DECODE_PHASES = ("pad", "device", "collective", "emit")
_ENCODE_PHASES = ("device", "emit", "collective", "tail")


def make_mesh(device=None, axes: tuple[str, ...] = ("dp",),
              shape: tuple[int, ...] | None = None) -> DeviceMesh:
    """A ``DeviceMesh`` over the default process group, which the caller
    initialised (``torch.distributed.init_process_group``, or a rank of
    ``parallel.launch``), row major: rank ``k`` sits at
    ``np.unravel_index(k, shape)``. Defaults to 1-D data-parallel over
    every rank, and to ``(n // 2, 2)`` for two axes. ``device`` None
    means cuda and raises without CUDA; ``"cpu"`` gives a CPU mesh
    (gloo). Every rank must build it alike: creating its groups is
    collective."""
    dev = _device(device, "make_mesh")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no process group: call "
                           "torch.distributed.init_process_group first, or "
                           "run the function on ranks of "
                           "zxc_tpu_torch.parallel.launch")
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) if len(axes) == 1 else (n // 2, 2)
    if len(shape) != len(axes) or math.prod(shape) != n:
        raise ValueError(f"make_mesh: shape {tuple(shape)} over axes "
                         f"{tuple(axes)} does not cover the {n} ranks")
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def _size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def _coord(mesh: DeviceMesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank's tensors: the current cuda device, or the
    CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def all_gather(t: torch.Tensor, mesh: DeviceMesh, axis: str
               ) -> torch.Tensor:
    """The ``t`` of every member of this rank's ``axis`` group,
    concatenated on dim 0 in coordinate order (JAX's tiled
    ``all_gather``). Every member must call it with the same shape."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(_size(mesh, axis))]
    dist.all_gather(parts, t, group=mesh.get_group(axis))
    return torch.cat(parts)


def _pmax(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Element-wise max of ``t`` over the ``axis`` group."""
    return all_gather(t[None], mesh, axis).amax(0)


def _rows(n: int, mesh: DeviceMesh, axis: str) -> tuple[int, int]:
    """The batch rows [lo, hi) of this rank's coordinate on ``axis`` when
    ``n`` rows (a multiple of the axis) shard over it."""
    per = n // _size(mesh, axis)
    lo = _coord(mesh, axis) * per
    return lo, lo + per


def _to(host, dev: torch.device):
    return tuple(torch.from_numpy(a).to(dev) for a in host)


def _check_plan(plan: FramePlan, name: str) -> None:
    if plan.deferred:
        raise ValueError(f"{name}: the plan keeps entropy sections as wire "
                         "bytes (defer_entropy); plan it without")


def _raise_first(err: np.ndarray) -> None:
    """JAX's pick: the first nonzero error word of the batch, in order."""
    if err.any():
        _raise_errbits(int(err[err != 0][0]))


# ---------------------------------------------------------------------------
# dp: batched blocks sharded over the mesh
# ---------------------------------------------------------------------------

def decode_plan_sharded(plan: FramePlan, mesh: DeviceMesh,
                        dp_axis: str = "dp", batch: int | None = None, *,
                        _phases: dict | None = None) -> bytes:
    """Decode a FramePlan with blocks sharded data-parallel over the mesh:
    each batch is padded to a multiple of the dp axis (pad rows: no
    sequences, ``off`` 1), each rank expands its rows, and the error
    words and then the outputs are gathered in batch order. The
    dictionary, when the plan has one, is padded on every rank's device
    (JAX replicates it). ``_phases`` (a dict) receives the seconds of
    the ``profiling`` spans ``pad`` (the batch padded and copied to the
    device), ``device`` (the expansion issued), ``collective`` (the
    gathers, with the host's wait on the card's work: nothing
    synchronises the card before them) and ``emit``."""
    _check_plan(plan, "decode_plan_sharded")
    nb = plan.n_blocks
    if nb == 0:
        return b""
    dev = mesh_device(mesh)
    has_dict = plan.dict_buf is not None
    ndev = _size(mesh, dp_axis)
    if batch is None:
        batch = max(ndev, ((min(nb, 64) + ndev - 1) // ndev) * ndev)
    S = _pow2(plan.max_seq)
    L = _pow2(plan.max_lit)
    kern = expand.expand_kernel(plan.block_size, has_dict)
    dict_args = ((expand.pad_dict(plan.dict_buf, dev), plan.dict_len)
                 if has_dict else ())

    out_parts: list[np.ndarray] = []
    with profiling.collect_into(_phases, _DECODE_PHASES):
        for base in range(0, nb, batch):
            n = min(base + batch, nb) - base
            pad_to = ((n + ndev - 1) // ndev) * ndev
            lo, hi = _rows(pad_to, mesh, dp_axis)
            rows = range(base + min(lo, n), base + min(hi, n))
            with profiling.span("pad"):
                host = _pad_batch(plan, rows, S, L, B=hi - lo)
                args = _to(host, dev)
            with profiling.span("device"):
                out, _, err = kern(*args, *dict_args)
            with profiling.span("collective"):
                err_all = all_gather(err, mesh, dp_axis)[:n].cpu().numpy()
            _raise_first(err_all)
            with profiling.span("collective"):
                out_all = all_gather(out, mesh, dp_axis).cpu().numpy()
            with profiling.span("emit"):
                out_parts += [out_all[j, :plan.totals[base + j]]
                              for j in range(n)]
    return np.concatenate(out_parts).tobytes()


# ---------------------------------------------------------------------------
# dp x sp: positions inside each block sharded too (all_gather a round)
# ---------------------------------------------------------------------------

def _expand_sp_local(ll, ml, off, lit, n_seq, lit_len, *, block: int,
                     mesh: DeviceMesh, sp_axis: str):
    """This rank's ``block / n_sp`` output positions of each of its rows
    (JAX's per-shard body under ``vmap``): ll/ml/off (B, S) int32, lit
    (B, L) uint8, n_seq/lit_len (B,) int32. Returns (out (B, chunk)
    uint8, total (B,) int32, err (B,) int32, max-reduced over sp)."""
    B, S = ll.shape
    L = lit.shape[1]
    dev = ll.device
    n_sp = _size(mesh, sp_axis)
    chunk = block // n_sp
    p0 = _coord(mesh, sp_axis) * chunk

    valid = torch.arange(S, dtype=_I32, device=dev) < n_seq[:, None]
    ll = torch.where(valid, ll, 0)
    ml = torch.where(valid, ml, 0)
    off = torch.where(valid, off.clamp_min(1), 1)
    seq_out = ll + ml
    out_start = expand._exclusive_cumsum(seq_out)
    match_start = out_start + ll
    cum_ll = expand._exclusive_cumsum(ll)
    total_seq = seq_out.sum(1, dtype=_I32)
    lit_used = ll.sum(1, dtype=_I32)
    total = total_seq + (lit_len - lit_used).clamp_min(0)
    err = ((lit_used > lit_len).to(_I32)
           | ((total > block).to(_I32) << 1)
           | ((valid & (off > match_start)).any(1).to(_I32) << 2))

    # local positions; the segment id by a right-side search over the
    # valid starts (padding parks at the 2**30 sentinel)
    p = (p0 + torch.arange(chunk, dtype=_I32, device=dev))[None].expand(
        B, chunk).contiguous()
    starts = torch.where(valid, out_start, 2 ** 30).contiguous()
    sid = torch.searchsorted(starts, p, right=True).to(_I32) - 1
    sid = torch.minimum(sid.clamp_min(0), (n_seq - 1).clamp_min(0)[:, None])
    sid = sid.clamp(max=S - 1).long()   # JAX clamps the gathers below
    in_seq = (p < total_seq[:, None]) & (n_seq[:, None] > 0)
    ms = match_start.gather(1, sid)
    osr = out_start.gather(1, sid)
    is_match = in_seq & (p >= ms)
    lit_idx = torch.where(in_seq, cum_ll.gather(1, sid) + (p - osr),
                          lit_used[:, None] + (p - total_seq[:, None]))
    lit_byte = lit.gather(1, lit_idx.clamp(0, L - 1).long()).to(_I32)
    offv = off.gather(1, sid)
    rel = p - ms
    collapsed = torch.where(rel >= offv, rel % offv, rel) - offv
    node = torch.where(is_match, (ms + collapsed).clamp_min(0),
                       -(lit_byte + 1))

    # Fixed trip count: each round holds a collective, so every sp member
    # must run the same number of rounds; a data-dependent exit would
    # leave the others waiting in the all_gather.
    max_iters = int(math.ceil(math.log2(max(block, 2)))) + 1
    for _ in range(max_iters):
        full = all_gather(node, mesh, sp_axis).view(n_sp, B, chunk)
        full = full.transpose(0, 1).reshape(B, block)
        node = torch.where(node >= 0,
                           full.gather(1, node.clamp(0, block - 1).long()),
                           node)
    out = (-node - 1).to(torch.uint8)
    out = torch.where(p < total[:, None], out, 0)
    return out, total, _pmax(err, mesh, sp_axis)


def dp_sp_kernel(block: int, mesh: DeviceMesh, dp_axis: str = "dp",
                 sp_axis: str = "sp"):
    """The fully sharded decode step: blocks over dp, each block's
    ``block`` output positions over sp. Returns a callable over this
    rank's rows, ``(ll, ml, off, lit, n_seq, lit_len)``, giving this
    rank's ``(out (B_local, block / n_sp), total, err)``: the shard of
    JAX's ``out_specs (P(dp, sp), P(dp), P(dp))`` at its coordinates.
    The caller has already taken its dp rows (``dp_axis`` is the JAX
    signature's); the step itself gathers over sp only. This is the step
    ``entry.dryrun_multichip`` runs over its mesh."""
    n_sp = _size(mesh, sp_axis)
    if block % n_sp:
        raise ValueError(f"dp_sp_kernel: block {block} does not split over "
                         f"{n_sp} sp ranks")

    def fn(ll, ml, off, lit, n_seq, lit_len):
        return _expand_sp_local(ll, ml, off, lit, n_seq, lit_len,
                                block=block, mesh=mesh, sp_axis=sp_axis)
    return fn


def decode_plan_dp_sp(plan: FramePlan, mesh: DeviceMesh, *,
                      _phases: dict | None = None) -> bytes:
    """Decode with the fully sharded dp x sp step, every block in one
    call on a batch padded to a multiple of dp (the JAX package's
    demonstration path; ``decode_plan_sharded`` is the production one).
    As in JAX, no dictionary is passed: a match into a dictionary raises
    the offset error. ``_phases`` as in ``decode_plan_sharded``
    (``device`` holds the step's own gathers over sp)."""
    _check_plan(plan, "decode_plan_dp_sp")
    nb = plan.n_blocks
    if nb == 0:
        return b""
    dev = mesh_device(mesh)
    ndp = _size(mesh, "dp")
    n_sp = _size(mesh, "sp")
    S = _pow2(plan.max_seq)
    L = _pow2(plan.max_lit)
    B = ((nb + ndp - 1) // ndp) * ndp
    kern = dp_sp_kernel(plan.block_size, mesh)
    lo, hi = _rows(B, mesh, "dp")
    with profiling.collect_into(_phases, _DECODE_PHASES):
        with profiling.span("pad"):
            host = _pad_batch(plan, range(min(lo, nb), min(hi, nb)), S, L,
                              B=hi - lo)
            args = _to(host, dev)
        with profiling.span("device"):
            out, _, err = kern(*args)
        with profiling.span("collective"):
            err_all = all_gather(err, mesh, "dp")[:nb].cpu().numpy()
        _raise_first(err_all)
        with profiling.span("collective"):
            rows = all_gather(out, mesh, "sp").view(n_sp, hi - lo, -1)
            rows = rows.transpose(0, 1).reshape(hi - lo, plan.block_size)
            out_np = all_gather(rows, mesh, "dp").cpu().numpy()
        with profiling.span("emit"):
            data = np.concatenate([out_np[i, :plan.totals[i]]
                                   for i in range(nb)]).tobytes()
    return data


# ---------------------------------------------------------------------------
# Encode-side dp: match finding and parse sharded over blocks
# ---------------------------------------------------------------------------

def _match_parse(blocks: torch.Tensor, level: int):
    """The tensor-op matcher and the doubling parse on each row of a
    (b, S) uint8 batch (JAX's ``vmap(match+parse)``): (n_seq (b,), pos,
    len, off (b, S // 5 + 1)), int32."""
    params = level_params(level)
    outs = []
    for row in blocks:
        lens, offs = ENC.find_matches_device(row, params.n_candidates)
        outs.append(ENC.parse_compact_device(lens, offs, params.lazy))
    return tuple(torch.stack([o[k].to(_I32) for o in outs])
                 for k in range(4))


def _rank_blocks(blocks: np.ndarray, lo: int, hi: int,
                 mesh: DeviceMesh) -> torch.Tensor:
    return torch.from_numpy(np.array(blocks[lo:hi], np.uint8)).to(
        mesh_device(mesh))


def encode_blocks_sharded(blocks: np.ndarray, mesh: DeviceMesh,
                          level: int = 3, dp_axis: str = "dp"):
    """Match+parse a (B, S) uint8 batch of equal-size blocks across the
    mesh.

    Returns (n_seq (B,), pos, len, off, each (B, S // 5 + 1) int32,
    compacted) on the mesh's device, the whole batch on every rank. B
    must be a multiple of the dp axis size (pad with zero blocks and
    ignore their outputs). Byte emission stays on the host."""
    B = blocks.shape[0]
    ndp = _size(mesh, dp_axis)
    if B % ndp:
        raise ValueError(f"encode_blocks_sharded: {B} blocks do not split "
                         f"over {ndp} dp ranks (pad with zero blocks)")
    mine = _rank_blocks(blocks, *_rows(B, mesh, dp_axis), mesh)
    return tuple(all_gather(t, mesh, dp_axis)
                 for t in _match_parse(mine, level))


def _gather_bytes(blobs: list[bytes], mesh: DeviceMesh, axis: str
                  ) -> list[bytes]:
    """Every member's list of byte strings (each the same count), in
    coordinate order: the lengths first, then the rows padded to the
    longest."""
    dev = mesh_device(mesh)
    lens = all_gather(torch.tensor([len(b) for b in blobs],
                                   dtype=torch.int64, device=dev),
                      mesh, axis).cpu().numpy()
    width = max(int(lens.max()), 1)
    rows = np.zeros((len(blobs), width), np.uint8)
    for i, b in enumerate(blobs):
        rows[i, :len(b)] = np.frombuffer(b, np.uint8)
    got = all_gather(torch.from_numpy(rows).to(dev), mesh, axis)
    got = got.cpu().numpy()
    return [got[i, :int(n)].tobytes() for i, n in enumerate(lens)]


def compress_sharded(data: bytes, mesh: DeviceMesh, level: int = 3,
                     block_size: int = 65536, checksum: bool = False,
                     dp_axis: str = "dp", *,
                     _phases: dict | None = None) -> bytes:
    """Frame encode with match finding dp-sharded across the mesh.

    The first ``(n_full // ndp) · ndp`` full blocks shard over dp: each
    rank matches, parses and emits its own blocks, and the block bytes
    are gathered in order. The remaining blocks (the tail, and full
    blocks that do not fill the mesh) go through ``encode_chunk_device``
    on every rank alike. The archive equals the JAX package's
    ``compress_sharded``. ``_phases`` (a dict) receives the seconds of
    the ``profiling`` spans ``device`` (match and parse, up to the
    sequences' readback, where the host waits on the card's work),
    ``emit``, ``collective`` and ``tail``."""
    C.block_size_code(block_size)
    dev = mesh_device(mesh)
    ndp = _size(mesh, dp_axis)
    n_full = len(data) // block_size
    n_batch = (n_full // ndp) * ndp
    blks: list[bytes] = []
    with profiling.collect_into(_phases, _ENCODE_PHASES) as col:
        if n_batch:
            blocks = np.frombuffer(data, np.uint8,
                                   n_batch * block_size).reshape(n_batch,
                                                                 block_size)
            lo, hi = _rows(n_batch, mesh, dp_axis)
            with profiling.span("device"):
                seqs = ENC._host_seqs(*_match_parse(
                    _rank_blocks(blocks, lo, hi, mesh), level))
            with profiling.span("emit"):
                local = [block_encode.encode_chunk(blocks[lo + j], level,
                                                   checksum=checksum,
                                                   sequences=seqs[j])
                         for j in range(hi - lo)]
            with profiling.span("collective"):
                blks = _gather_bytes(local, mesh, dp_axis)
        # the tail's own spans go to a collector apart, so that ``emit``
        # holds the sharded blocks alone
        apart = (profiling.collect_phases() if col is not None
                 else contextlib.nullcontext())
        with profiling.span("tail"), apart:
            for pos in range(n_batch * block_size, len(data), block_size):
                blks.append(ENC.encode_chunk_device(
                    data[pos:pos + block_size], level, dev, checksum))
    out = bytearray(headers.write_file_header(block_size, checksum))
    global_hash = 0
    for blk in blks:
        if checksum:
            global_hash = global_hash_update(
                global_hash, int.from_bytes(blk[-4:], "little"))
        out += blk
    out += headers.write_block_header(C.BLOCK_EOF, 0)
    out += headers.write_file_footer(len(data), global_hash, checksum)
    return bytes(out)
