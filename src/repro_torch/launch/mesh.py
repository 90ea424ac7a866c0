"""Device meshes over a process group, and a runner for a group of ranks.

The port of ``src/repro/launch/mesh.py``. A torch ``DeviceMesh`` spans the
ranks of the initialised default process group (one process per mesh
position), where the reference's ``jax.make_mesh`` spans the devices one
process sees:

  * single pod: (data=16, model=16), 256 ranks;
  * multi-pod: (pod=2, data=16, model=16), 512 ranks; the 'pod' axis is
    pure data parallelism, where gradients can cross int8-compressed
    (``optim/compress.py``).

Functions, not module constants: importing this module starts no process
group. :func:`run_ranks` starts the ranks of a group on one host (each a
``spawn``-ed process with a process group over a ``file://`` store) and
returns what each returned: the CPU tests run 4 gloo ranks with it, and
``chip_smoke.py`` and ``sharding/scaling.py`` 2 ranks on one card, over
gloo (``cpu:gloo,cuda:gloo``), since NCCL takes one GPU per rank.
"""
from __future__ import annotations

import datetime
import io
import os
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Tuple

import torch

__all__ = ["make_mesh", "make_host_mesh", "make_production_mesh", "run_ranks"]


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the default
    process group's ranks, rank-major (the last axis varies fastest)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("no process group: call torch.distributed.init_process_group "
                         "(or run through launch.mesh.run_ranks) before building a mesh")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, model: int = 16,
                         device_type: str = "cuda"):
    """256 ranks a pod; ``model`` sets the tensor-parallel degree (data =
    256 / model). Raises ValueError unless the group has exactly that many
    ranks."""
    if model < 1 or 256 % model:
        raise ValueError(f"model={model} must divide the pod's 256 ranks")
    data = 256 // model
    shape = (2, data, model) if multi_pod else (data, model)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n, want = _world_size(), (512 if multi_pod else 256)
    if n != want:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} needs {want} ranks; "
                         f"the process group has {n}")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """A (data, model) mesh over the process group's ranks (tests,
    examples, one host).

    Raises ValueError (not a bare assert, which ``python -O`` strips) when
    ``model`` exceeds or does not divide the world size.
    """
    n = _world_size()
    if model < 1:
        raise ValueError(f"model={model} must be >= 1")
    if model > n:
        raise ValueError(
            f"model={model} exceeds the {n} available rank(s); start more with "
            "torch.distributed (world_size=N, e.g. launch.mesh.run_ranks or "
            "sharding.scaling --ranks N) or lower the model-parallel degree")
    if n % model != 0:
        raise ValueError(f"world size {n} is not divisible by model={model}")
    return make_mesh((n // model, model), ("data", "model"), device_type)


def _backend(device_type: str) -> str:
    """Gloo on the CPU, and for CUDA tensors too: NCCL refuses two ranks on
    one GPU."""
    return "gloo" if device_type == "cpu" else "cpu:gloo,cuda:gloo"


def _dumps(obj) -> bytes:
    # Bytes, not tensors, cross the process boundary: a tensor pickled by
    # multiprocessing is shared through a file descriptor that dies with
    # the rank that sent it.
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _loads(data: bytes):
    return torch.load(io.BytesIO(data), weights_only=False)


def _rank_main(fn, rank: int, n_ranks: int, store: str, backend: str, timeout_s: float,
               threads: int, args: bytes, results) -> None:
    import torch.distributed as dist

    torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=n_ranks,
                                timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, *_loads(args))
        results.put((rank, True, _dumps(out)))
    except BaseException:                      # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, n_ranks: int, *args: Any, device_type: str = "cuda",
              timeout_s: float = 600.0, threads: int = 1) -> List[Any]:
    """``[fn(rank, *args) for each rank]``, each rank its own process of one
    process group (gloo, for CUDA tensors too).

    ``fn`` and ``args`` are pickled (``fn`` must be importable by name):
    the ranks start with ``spawn``, never ``fork`` (the caller may hold a
    CUDA context). Each rank sets ``threads`` intra-op threads. Collectives
    time out after ``timeout_s``; the whole run must end by then too. When a
    rank raises, exits without a result or the deadline passes, the other
    ranks are killed and RuntimeError names the rank and its traceback.
    """
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    store = os.path.join(tmp, "store")
    backend = _backend(device_type)
    payload = _dumps(args)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n_ranks, store, backend, timeout_s, threads, payload,
                               results))
             for r in range(n_ranks)]
    out: dict = {}
    failure = None
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < n_ranks and failure is None:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    # A rank that died before reporting (killed, os._exit) may
                    # still have its report in flight: give it a moment.
                    try:
                        rank, ok, value = results.get(timeout=2.0)
                    except queue_lib.Empty:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} without a result")
                        break
                elif time.monotonic() > deadline:
                    failure = (f"ranks {sorted(set(range(n_ranks)) - set(out))} did not "
                               f"finish within {timeout_s} s")
                    break
                else:
                    continue
            if ok:
                out[rank] = _loads(value)
            else:
                failure = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.kill()
            p.join(timeout=None if failure is not None else max(5.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(n_ranks)]
