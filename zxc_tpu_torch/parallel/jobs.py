"""The rank side of a launch that runs a list of sharded calls
(``parallel.launch`` with ``"zxc_tpu_torch.parallel.jobs:run_jobs"``).

``run_jobs(spec_path)`` reads a JSON spec ``{"out": dir, "device":
"cpu"|"cuda", "jobs": [...]}`` and runs each job on this rank, in order,
on a mesh of its own (``"axes"``, ``"shape"``). A job is one of

* ``decode_plan_sharded`` / ``decode_plan_dp_sp``: ``"archive"`` (a
  file), with ``"dict"`` (a file of dictionary content), ``"batch"`` and
  ``"tamper"``, a list of ``[block, sequence, field, value]``, each
  setting one entry of the plan's ``ll``, ``ml`` or ``off`` before the
  decode;
* ``dp_sp_kernel``: ``"arrays"`` (an ``.npz`` of a whole padded batch
  ``ll, ml, off, lit, n_seq, lit_len``) and ``"block"``; the result is
  this rank's shard ``(out, total, err)``;
* ``encode_blocks_sharded``: ``"input"`` (a file of B·block_size bytes),
  ``"block_size"``, ``"level"``;
* ``compress_sharded``: ``"input"``, ``"block_size"``, ``"level"``,
  ``"checksum"``;
* ``fail``: rank ``"rank"`` raises before a collective that the others
  enter, and so ends the launch.

Each result goes to ``<out>/<name>.r<rank>.pkl``: ``{"ok": bytes or
arrays}`` or ``{"error": [type, code, message]}`` for a ZxcError or a
ValueError (which every rank raises alike), with ``"wall"`` seconds,
``"phases"`` and ``"launches"``, the hand-written kernels the job
launched on this rank. ``<out>/modules.r<rank>.json`` lists the modules
of JAX or of the JAX package that the rank had loaded: none.
"""
from __future__ import annotations

import json
import os
import pickle
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..codec.frame import DecodeOpts
from ..errors import ZxcError
from ..ops.batch import plan_frame
from . import sharding as SH


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _plan(job: dict):
    opts = DecodeOpts(dict_content=_read(job["dict"])) if job.get(
        "dict") else None
    plan = plan_frame(_read(job["archive"]), opts)
    for blk, seq, fld, value in job.get("tamper") or ():
        getattr(plan, fld)[blk][seq] = value
    return plan


def _run(job: dict, mesh, phases: dict):
    op = job["op"]
    if op == "decode_plan_sharded":
        return SH.decode_plan_sharded(_plan(job), mesh,
                                      batch=job.get("batch"),
                                      _phases=phases)
    if op == "decode_plan_dp_sp":
        return SH.decode_plan_dp_sp(_plan(job), mesh, _phases=phases)
    if op == "dp_sp_kernel":
        arrays = np.load(job["arrays"])
        host = [arrays[k] for k in ("ll", "ml", "off", "lit", "n_seq",
                                    "lit_len")]
        lo, hi = SH._rows(len(host[0]), mesh, "dp")
        args = [torch.from_numpy(a[lo:hi].copy()).to(SH.mesh_device(mesh))
                for a in host]
        kern = SH.dp_sp_kernel(job["block"], mesh)
        return tuple(t.cpu().numpy() for t in kern(*args))
    if op == "encode_blocks_sharded":
        data = np.frombuffer(_read(job["input"]), np.uint8)
        blocks = data.reshape(-1, job["block_size"])
        out = SH.encode_blocks_sharded(blocks, mesh, job["level"])
        return tuple(t.cpu().numpy() for t in out)
    if op == "compress_sharded":
        return SH.compress_sharded(_read(job["input"]), mesh,
                                   job["level"], job["block_size"],
                                   job["checksum"], _phases=phases)
    if op == "fail":
        if dist.get_rank() == job["rank"]:
            raise RuntimeError(f"rank {job['rank']} fails before the "
                               "collective, as its job asks")
        zero = torch.zeros(1, device=SH.mesh_device(mesh))
        return SH.all_gather(zero, mesh,
                             mesh.mesh_dim_names[0]).cpu().numpy()
    raise ValueError(f"unknown job {op!r}")


def _launches() -> dict:
    from ..ops import attic, copy_engine, encode_kernels, probes
    return {name: k.launches for fam in (copy_engine.KERNELS,
                                         encode_kernels.KERNELS,
                                         attic.KERNELS, probes.KERNELS)
            for name, k in fam.items()}


def run_jobs(spec_path: str) -> None:
    """Run the spec's jobs on this rank and write their results."""
    with open(spec_path) as f:
        spec = json.load(f)
    rank = dist.get_rank()
    for job in spec["jobs"]:
        mesh = SH.make_mesh(spec.get("device"), tuple(job["axes"]),
                            tuple(job["shape"]) if job.get("shape")
                            else None)
        phases: dict = {}
        before = _launches()
        t0 = time.perf_counter()
        try:
            res = {"ok": _run(job, mesh, phases)}
        except (ZxcError, ValueError) as e:
            res = {"error": [type(e).__name__, getattr(e, "code", None),
                             str(e)]}
        res["wall"] = time.perf_counter() - t0
        res["phases"] = phases
        res["launches"] = {k: v - before[k] for k, v in _launches().items()
                           if v != before[k]}
        with open(os.path.join(spec["out"], f"{job['name']}.r{rank}.pkl"),
                  "wb") as f:
            pickle.dump(res, f)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "zxc_tpu"))
    with open(os.path.join(spec["out"], f"modules.r{rank}.json"), "w") as f:
        json.dump(loaded, f)
