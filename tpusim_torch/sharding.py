"""Node sharding: split the node axis (and a snapshot or scenario axis) over
a mesh of processes.

A mesh is a torch.distributed DeviceMesh over the default process group's
ranks, one process a rank, with named axes: ("snap", "node") from make_mesh
or ("scenario", "node") from make_scenario_mesh. Its "node" axis is the
process group mesh.get_group("node"). The node-sharded scan
(scan.sharded_scan_fn) gives each rank a contiguous block of the node axis
and every pod; its per-step reductions are all_reduces over that group.
State stays in plain local tensors: a rank's block is an ordinary tensor on
its device, and no collective runs that the step does not name.

On the card rank r uses cuda:(LOCAL_RANK mod device_count) (shard_device),
so with one card every rank shares it; those ranks must talk over gloo,
since NCCL takes one card a rank. On the CPU the ranks are processes.

Which axis of a field is the node axis comes from the axis registries
(scan.STATICS_AXES, CARRY_AXES), so a new field pads and shards by its
registry entry. A partition spec is a tuple with, for each axis of a field,
the mesh axis it is split over or None (whole); () leaves a field whole.

Padding: a node padded onto the node axis can never be chosen. Bit 62 of
its condition bits fails the condition stage, and the reason histogram
decodes only the bits below the reason width, so a padded node shows in no
FitError text (count mode masks it out, scan._evaluate). A what-if batch
pads every scenario to one node count the same way.
"""

from __future__ import annotations

import os
import re
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tpusim_torch.device import resolve_device
from tpusim_torch.scan import (
    CARRY_AXES,
    PAD_FILLS,
    PAD_SENTINEL,
    PODX_AXES,
    STATICS_AXES,
    Carry,
    PodX,
    Statics,
)


class MeshSharding(NamedTuple):
    """How a field lies on a mesh: for each of its axes the mesh axis it is
    split over (a rank holds the block at its coordinate on that mesh axis)
    or None (whole on every rank)."""
    mesh: object
    spec: tuple

    def block(self, arr: np.ndarray) -> np.ndarray:
        """This rank's block of host array `arr`."""
        arr = np.asarray(arr)
        for ax, name in enumerate(self.spec):
            if name is None:
                continue
            size = _axis_size(self.mesh, name)
            per = arr.shape[ax] // size
            lo = self.mesh.get_local_rank(name) * per
            arr = arr[(slice(None),) * ax + (slice(lo, lo + per),)]
        return arr


def _axis_size(mesh, name: str) -> int:
    return mesh.size(tuple(mesh.mesh_dim_names).index(name))


def shard_device(device="cuda") -> torch.device:
    """This process's device: on the card cuda:(LOCAL_RANK mod
    device_count), LOCAL_RANK the process's rank on its machine (the
    default group's rank where unset); cpu stays cpu."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        import torch.distributed as dist

        local = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", int(local) % torch.cuda.device_count())


def stage_tree(tree, sharding=None, device="cuda", index: bool = False):
    """Stage a tree of host numpy arrays (Statics, Carry or PodX) on this
    process's device, the one staging shape of the sharded route:

      sharding=None            -> every field whole
      a MeshSharding           -> that placement for every field
      a tree of MeshShardings  -> fieldwise (the tree must match)

    `index` widens int32 ids to int64 (Statics and PodX)."""
    dev = shard_device(device)
    if sharding is None or isinstance(sharding, MeshSharding):
        sharding = type(tree)(*(sharding for _ in tree))

    def put(arr, sh):
        arr = np.asarray(arr) if sh is None else sh.block(arr)
        t = torch.tensor(arr, device=dev)
        if index and t.dtype == torch.int32:
            t = t.to(torch.int64)
        return t

    return type(tree)(*(put(a, sh) for a, sh in zip(tree, sharding)))


def _valid_shard_counts(n: int) -> list:
    """Divisors of n: the shard counts a leading mesh axis can take."""
    return [d for d in range(1, n + 1) if n % d == 0]


def _factoring_error(n: int, first_axis: str, first: int,
                     second_axis: str) -> ValueError:
    """A mesh request that does not factor: names both axes the grid would
    have had and lists the shard counts that do divide the device count."""
    return ValueError(
        f"{n} devices do not factor into a ({first_axis!r}, {second_axis!r}) "
        f"mesh with {first_axis}={first} ({second_axis} would not get a "
        f"whole number of devices); valid {first_axis} counts for "
        f"{n} devices: {_valid_shard_counts(n)}")


# built meshes by (device type, axis names, grid, default group, tag):
# building one creates a process group an axis, a collective every rank
# must join, so a batch reuses its mesh instead of creating groups a
# dispatch
_MESHES: Dict[tuple, object] = {}


def _mesh(devices: list, rows: int, names: Tuple[str, str],
          device_type: str, tag: str = ""):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    grid = torch.tensor(devices, dtype=torch.int64).reshape(
        rows, len(devices) // rows)
    key = (device_type, names, tuple(grid.shape), tuple(devices),
           id(dist.distributed_c10d._get_default_group()), tag)
    mesh = _MESHES.get(key)
    if mesh is None:
        if device_type == "cuda":
            # the mesh leaves a device that is set as it is
            torch.cuda.set_device(shard_device("cuda"))
        if not tag:
            mesh = DeviceMesh(device_type, grid, mesh_dim_names=names)
        else:
            mesh = _tagged_mesh(devices, rows, grid, names, device_type)
        _MESHES[key] = mesh
    return mesh


def forget_meshes() -> None:
    """Drop the meshes built over the current default group (before it is
    destroyed: a later group may reuse its id)."""
    import torch.distributed as dist

    gid = id(dist.distributed_c10d._get_default_group())
    for key in [k for k in _MESHES if k[4] == gid]:
        del _MESHES[key]


def _tagged_mesh(devices: list, rows: int, grid, names, device_type: str):
    """A one-row mesh on process groups of its own: a DeviceMesh over the
    same ranks reuses the groups of the first one built, and two threads
    whose collectives share a group interleave them differently on each
    rank (a hang, or wrong sums). Every rank of the default group creates
    the groups, in the same order."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if rows != 1:
        raise ValueError(f"a tagged mesh has one row of ranks, not {rows}")
    node = dist.new_group(list(devices))
    rows_groups = [dist.new_group([d]) for d in devices]
    me = dist.get_rank()
    row = rows_groups[devices.index(me)] if me in devices else None
    return DeviceMesh.from_group([row, node], device_type, mesh=grid,
                                 mesh_dim_names=names)


def _ranks(devices: Optional[list], n_devices: Optional[int]) -> list:
    if devices is None:
        import torch.distributed as dist

        devices = list(range(dist.get_world_size()))
    return list(devices)[: (n_devices or len(devices))]


def make_mesh(n_devices: Optional[int] = None, snap: int = 1,
              devices: Optional[list] = None, device_type: str = "cpu",
              tag: str = ""):
    """A ("snap", "node") DeviceMesh over the first n_devices ranks
    (`devices`, the default group's ranks by default). device_type names
    the ranks' devices ("cuda" on the card). A nonempty `tag` (snap=1
    only) gives the mesh process groups of its own, shared with no mesh of
    another tag: one for each streaming twin of a process whose twins run
    on threads of their own. Build a tagged mesh on every rank in the same
    order, on one thread, before the threads that use it start."""
    devices = _ranks(devices, n_devices)
    n = len(devices)
    if snap < 1 or n % snap != 0:
        raise _factoring_error(n, "snap", snap, "node")
    return _mesh(devices, snap, ("snap", "node"), device_type, tag)


def make_scenario_mesh(n_devices: Optional[int] = None,
                       scenario: Optional[int] = None,
                       devices: Optional[list] = None,
                       device_type: str = "cpu"):
    """A ("scenario", "node") DeviceMesh for a what-if split by scenario,
    node columns whole on each rank; `scenario` defaults to every rank (a
    node axis of 1)."""
    devices = _ranks(devices, n_devices)
    n = len(devices)
    scenario = scenario or n
    if scenario < 1 or n % scenario != 0:
        raise _factoring_error(n, "scenario", scenario, "node")
    return _mesh(devices, scenario, ("scenario", "node"), device_type)


def mesh_kind(mesh) -> str:
    """Which what-if route a mesh selects: "snap" (the snapshot axis over
    "snap", node columns over "node") or "scenario" (scenarios over
    "scenario", node columns whole). Anything else is a caller error,
    named here."""
    names = tuple(mesh.mesh_dim_names)
    if names == ("snap", "node"):
        return "snap"
    if names == ("scenario", "node"):
        return "scenario"
    raise ValueError(
        f"what-if mesh has axes {names!r}; want ('snap', 'node') "
        "(make_mesh: GSPMD-sharded vmap) or ('scenario', 'node') "
        "(make_scenario_mesh: manual shard_map over scenarios)")


def check_mesh(mesh, what: str = "what-if mesh") -> str:
    """The mesh's kind (mesh_kind), once its ranks are known to lie in this
    process's initialized default group with this process among them; a
    ValueError names what is wrong (`what` names the mesh). Runs before
    any host work."""
    import torch.distributed as dist

    kind = mesh_kind(mesh)
    ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"{what} spans {len(ranks)} rank(s), but this process has no "
            "default process group; initialize torch.distributed on every "
            "rank and rebuild the mesh")
    world = dist.get_world_size()
    missing = [r for r in ranks if r >= world]
    if missing:
        raise ValueError(
            f"{what} spans {len(missing)} rank(s) not in this process's "
            f"default group of {world} (e.g. rank {missing[0]}); rebuild "
            "the mesh from the group's ranks")
    if dist.get_rank() not in ranks:
        raise ValueError(
            f"{what} does not hold this process's rank {dist.get_rank()}; "
            "every rank of the mesh makes the call")
    return kind


def match_partition_rules(rules: Sequence[Tuple[str, tuple]],
                          fields: Sequence[str],
                          prefix: str = "") -> Dict[str, tuple]:
    """Partition specs by regex rule: each field, as "prefix/name", takes
    the spec of the first rule that matches it; no match leaves it whole
    (())."""
    out: Dict[str, tuple] = {}
    for name in fields:
        path = f"{prefix}/{name}" if prefix else name
        for pattern, spec in rules:
            if re.search(pattern, path):
                out[name] = spec
                break
        else:
            out[name] = ()
    return out


# The stacked what-if batch: every statics, carry and pod field gains a
# leading scenario axis, so every tree matches its prefix rule; the whole
# default only catches scalar or config fields to come.
SCENARIO_BATCH_RULES: Tuple[Tuple[str, tuple], ...] = (
    (r"^statics/", ("scenario",)),
    (r"^carry/", ("scenario",)),
    (r"^xs/", ("scenario",)),
)


def scenario_specs() -> Tuple[Carry, Statics, PodX]:
    """Partition-spec trees (carry, statics, xs) of a what-if batch split by
    scenario, from the axis registries through the regex rules."""
    ca = match_partition_rules(SCENARIO_BATCH_RULES, CARRY_AXES, "carry")
    st = match_partition_rules(SCENARIO_BATCH_RULES, STATICS_AXES, "statics")
    xs = match_partition_rules(SCENARIO_BATCH_RULES, PODX_AXES, "xs")
    return Carry(**ca), Statics(**st), PodX(**xs)


def scenario_shardings(mesh) -> Tuple[Carry, Statics, PodX]:
    """MeshSharding trees of scenario_specs on `mesh`, for staging the
    stacked host batch."""
    ca, st, xs = scenario_specs()

    def named(tree):
        return type(tree)(*(MeshSharding(mesh, spec) for spec in tree))

    return named(ca), named(st), named(xs)


def _pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _pad_node_tree(tree, axes_map, pad: int):
    """`tree` (host numpy arrays) with `pad` nodes appended on every node
    axis: condition bits the sentinel, every other field its PAD_FILLS
    value (0)."""
    fields = {}
    for name, arr in tree._asdict().items():
        spec = axes_map[name]
        arr = np.asarray(arr)
        if "node" not in spec:
            fields[name] = arr
            continue
        if name == "cond_fail_bits":
            fields[name] = np.concatenate(
                [arr, np.full(pad, PAD_SENTINEL, dtype=np.int64)])
            continue
        widths = [(0, 0)] * arr.ndim
        widths[spec.index("node")] = (0, pad)
        fields[name] = np.pad(arr, widths,
                              constant_values=PAD_FILLS.get(name, 0))
    return type(tree)(**fields)


def pad_node_axis(statics: Statics, carry: Carry, n_shards: int
                  ) -> Tuple[Statics, Carry, int]:
    """Pad the node axis of host trees up to a multiple of `n_shards` (the
    what-if unifier passes the batch's node count, so every scenario pads
    to it). Returns the padded trees and the real node count."""
    n = np.asarray(statics.alloc_cpu).shape[0]
    pad = _pad_to(n, n_shards) - n
    if pad == 0:
        return statics, carry, n
    return (_pad_node_tree(statics, STATICS_AXES, pad),
            _pad_node_tree(carry, CARRY_AXES, pad), n)


def pad_carry_node_axis(carry: Carry, n_shards: int) -> Carry:
    """Pad only the carry's node axis to the mesh multiple (a fresh carry
    against statics padded and placed before)."""
    name = next(n for n, spec in CARRY_AXES.items() if "node" in spec)
    ax = CARRY_AXES[name].index("node")
    n = np.asarray(getattr(carry, name)).shape[ax]
    pad = _pad_to(n, n_shards) - n
    return carry if pad == 0 else _pad_node_tree(carry, CARRY_AXES, pad)


def _sharding_tree(tree_cls, axes_map, mesh, leading: Optional[str] = None):
    return tree_cls(**{
        name: MeshSharding(mesh, tuple(
            ([leading] if leading is not None else [])
            + ["node" if a == "node" else None for a in spec]))
        for name, spec in axes_map.items()})


def node_shardings(mesh) -> Tuple[Statics, Carry]:
    """MeshSharding trees for statics and carry: the node axis split over
    "node", every other axis whole."""
    return (_sharding_tree(Statics, STATICS_AXES, mesh),
            _sharding_tree(Carry, CARRY_AXES, mesh))


def node_blocks(mesh, statics: Statics, carry: Carry
                ) -> Tuple[Statics, Carry]:
    """This rank's blocks of host trees: the node axis padded to the mesh's
    multiple and cut to the rank's contiguous block, every other axis
    whole."""
    statics, carry, _ = pad_node_axis(statics, carry,
                                      _axis_size(mesh, "node"))
    st_spec, ca_spec = node_shardings(mesh)
    return (Statics(*(sh.block(a) for a, sh in zip(statics, st_spec))),
            Carry(*(sh.block(a) for a, sh in zip(carry, ca_spec))))


def shard_for_mesh(mesh, statics: Statics, carry: Carry, xs: PodX,
                   device="cuda") -> Tuple[Statics, Carry, PodX]:
    """Stage host trees for the node-sharded scan on this process's device:
    this rank's node blocks (node_blocks), every pod's columns whole (each
    rank sees every pod; its work a pod is the reduction over its
    block)."""
    statics, carry = node_blocks(mesh, statics, carry)
    return (stage_tree(statics, None, device, index=True),
            stage_tree(carry, None, device),
            stage_tree(xs, None, device, index=True))


def snap_shardings(mesh) -> Tuple[Statics, Carry, MeshSharding]:
    """Shardings of a multi-snapshot what-if: a leading snapshot axis split
    over "snap", the node axis over "node"."""
    statics = _sharding_tree(Statics, STATICS_AXES, mesh, leading="snap")
    carry = _sharding_tree(Carry, CARRY_AXES, mesh, leading="snap")
    return statics, carry, MeshSharding(mesh, ("snap",))


def gather_blocks(mesh, axis: str, *blocks):
    """Whole arrays from row blocks split over a mesh axis: each rank writes
    its block (rows at its coordinate on `axis`) into zeros, and one sum
    over the axis's process group, the ranks that share this rank's other
    coordinates, puts the rows together. Never a sum over the whole mesh:
    the ranks of the other axis hold the same rows and would count each
    once more. Returns numpy arrays, the same on every rank."""
    import torch.distributed as dist

    size = _axis_size(mesh, axis)
    coord = mesh.get_local_rank(axis)
    out = []
    for b in blocks:
        per = b.shape[0]
        full = torch.zeros((per * size,) + tuple(b.shape[1:]), dtype=b.dtype,
                           device=b.device)
        full[coord * per:(coord + 1) * per].copy_(b)
        if size > 1:
            dist.all_reduce(full, group=mesh.get_group(axis))
        out.append(full.cpu().numpy())
    return out


def rank_directory(directory: Optional[str]) -> Optional[str]:
    """This process's directory of a per-rank output such as a stream's
    WAL and checkpoints: `directory` itself outside a process group of
    several ranks and on its rank 0, `<directory>.rank<r>` on rank r > 0,
    so that every rank journals on its own and no two ranks append to one
    file."""
    if directory is None:
        return None
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1 and dist.get_rank() > 0:
        return f"{directory}.rank{dist.get_rank()}"
    return directory


# ---------------------------------------------------------------------------
# Ranks on one machine: k spawned processes under a gloo group, for the
# tests on the CPU and for k ranks sharing one card. The ranks meet through
# a file in a fresh temporary directory, not a TCP port picked beforehand,
# which another run starting at the same moment could take.


def _rank_main(fn, rank: int, world: int, store: str, timeout: float,
               env: Optional[dict], args: tuple, results) -> None:
    import datetime
    import traceback

    import torch.distributed as dist

    os.environ.update({"RANK": str(rank), "LOCAL_RANK": str(rank),
                       "WORLD_SIZE": str(world)})
    os.environ.update(env or {})
    # the ranks share the machine's cores: one intra-op thread a rank (a
    # rank's host work is a step's small tensors and its collectives)
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:   # noqa: BLE001 (reported to the parent)
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, args: tuple = (), timeout: float = 120.0,
              env: Optional[dict] = None) -> list:
    """fn(rank, world, *args) in `world` spawned processes joined by a gloo
    process group (a file store in a fresh temporary directory), each with
    RANK, LOCAL_RANK and WORLD_SIZE set and `env` on top. Returns their
    results by rank. A rank that raises or dies fails the run, and so does
    a run past `timeout` seconds (the group's collectives time out there
    too); either way every process is stopped before this returns or
    raises. fn must be importable by name (the spawn start method)."""
    import multiprocessing as mp
    import queue
    import shutil
    import tempfile
    import time

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="tpusim-ranks-")
    store = os.path.join(store_dir, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, store, timeout, env, args,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks did not finish within "
                                   f"{timeout:.0f} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} died with exit code "
                        f"{procs[dead[0]].exitcode}") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)
    return [got[r] for r in range(world)]


def run_ranks_each(fn, worlds: Sequence[int], args: tuple = (),
                   timeout: float = 120.0, env: Optional[dict] = None
                   ) -> Dict[int, list]:
    """run_ranks of fn at each world size of `worlds`, all at once (one
    thread each): world -> its ranks' results."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(worlds)) as pool:
        runs = {k: pool.submit(run_ranks, fn, k, args, timeout, env)
                for k in worlds}
        return {k: run.result() for k, run in runs.items()}
