"""Meshes across processes (counterpart of
`bayesnf_tpu/parallel/distributed.py`).

One process (rank of a `torch.distributed` group) per device, as NCCL wants
it, each holding the cells of a `Mesh` whose `ranks` grid names it. The
fits and predicts run SPMD, as the JAX package runs them:

- every rank runs the same fit with the same arguments and builds the same
  full host values from the same seed: the initialization, the minibatch
  permutations and the VI noise (their generators are seeded by member and
  shard, never by rank, so each cell draws what it draws in one process),
  the streamed slices and a restored checkpoint;
- each rank keeps only its own cells (`make_global`) and drives only those;
- a step's shard sum gathers every shard's losses and gradients to the
  ranks of its ensemble group (`exchange_shards`), which add them in shard
  order with the float operations of the single-process mesh. It is never
  an `all_reduce`, whose order of sums the backend chooses;
- results are gathered on every rank (`host_value`), so `params_` and
  `losses_` come back whole on each.

So a fit across ranks computes, cell for cell, the bits of the
single-process mesh of the same layout.

Typical use, the same script on every rank (started by `torchrun`, or by
hand with `initialize('localhost:<port>', num_processes, process_id)`):

    from bayesnf_torch.parallel import distributed
    distributed.initialize()
    mesh = distributed.multihost_mesh(data_devices_per_host=1)
    model.fit(df, seed=0, ensemble_size=64, mesh=mesh)

A mesh across ranks spans every rank of the group: the gathers, the
checkpoint barriers and the row groups are collectives of all of them.
"""

import datetime
import functools
import os

import torch
import torch.distributed as dist

from bayesnf_torch.parallel import mesh as mesh_lib

# A peer that died leaves the others in a collective: the group's timeout
# turns that into an error instead of a hang.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def default_backend(local_ranks: int | None, world: int) -> str:
  """'nccl' when each rank of this host has a CUDA device of its own,
  'gloo' otherwise (two ranks on one card are the 'gloo' case: NCCL
  refuses two ranks on one device). Gloo takes CPU and CUDA tensors.

  Args:
    local_ranks: the ranks on this host (LOCAL_WORLD_SIZE, as `torchrun`
      sets it), or None when the launcher did not say.
    world: the ranks of the whole group.

  Raises:
    ValueError: when `local_ranks` is None and the `world` ranks outnumber
      this host's cards: they may be spread over hosts, a card each, or
      share this host's cards, and only the caller knows which.
  """
  if not (torch.cuda.is_available() and dist.is_nccl_available()):
    return 'gloo'
  cards = torch.cuda.device_count()
  if local_ranks is None:
    if world > cards:
      raise ValueError(
          f'{world} ranks and {cards} CUDA devices on this host, and no '
          'LOCAL_WORLD_SIZE: pass `backend` (\'nccl\' with a card a rank, '
          '\'gloo\' for ranks that share a card).')
    local_ranks = world
  return 'nccl' if local_ranks <= cards else 'gloo'


def _local_index(process_id=None) -> int:
  """This rank's index among its host's ranks: LOCAL_RANK as `torchrun`
  sets it, else the rank."""
  if 'LOCAL_RANK' in os.environ:
    return int(os.environ['LOCAL_RANK'])
  if process_id is not None:
    return int(process_id)
  return dist.get_rank() if dist.is_initialized() else int(
      os.environ.get('RANK', 0))


def local_device() -> torch.device:
  """This rank's CUDA device, `cuda:{LOCAL_RANK % device_count}`.

  Raises:
    ValueError: without a CUDA device.
  """
  if not torch.cuda.is_available():
    raise ValueError(
        'No CUDA device: pass `local_devices` to `multihost_mesh`.')
  return torch.device('cuda', _local_index() % torch.cuda.device_count())


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None, timeout=DEFAULT_TIMEOUT):
  """Joins this process to the group of ranks (a no-op if it has joined).

  Args:
    coordinator_address: 'host:port' (or a 'tcp://' URL) of rank 0; None
      reads MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK from the
      environment ('env://', as `torchrun` sets them).
    num_processes: the world size (None: WORLD_SIZE).
    process_id: this process's rank (None: RANK).
    backend: 'nccl', 'gloo', or None for `default_backend` of this host's
      ranks (LOCAL_WORLD_SIZE) and the world size.
    timeout: how long a collective waits for its peers before it fails.

  Raises:
    ValueError: from `default_backend`, when `backend` is None and the
      rule cannot tell.
  """
  if dist.is_initialized():
    return
  if coordinator_address is None:
    init_method = 'env://'
  elif '://' in str(coordinator_address):
    init_method = str(coordinator_address)
  else:
    init_method = f'tcp://{coordinator_address}'
  world = (int(num_processes) if num_processes is not None
           else int(os.environ.get('WORLD_SIZE', 1)))
  if backend is None:
    local = os.environ.get('LOCAL_WORLD_SIZE')
    backend = default_backend(None if local is None else int(local), world)
  if backend == 'nccl':
    # NCCL runs each rank's collectives on its current device.
    torch.cuda.set_device(
        _local_index(process_id) % torch.cuda.device_count())
  dist.init_process_group(
      backend, init_method=init_method, timeout=timeout,
      world_size=-1 if num_processes is None else int(num_processes),
      rank=-1 if process_id is None else int(process_id))


def multihost_mesh(data_devices_per_host: int = 1,
                   local_devices=None) -> mesh_lib.Mesh:
  """The ('ens', 'data') mesh over every rank's devices, the JAX layout:
  the devices of rank 0, then rank 1, ..., in rows of
  `data_devices_per_host`, so that 'ens' runs across ranks and each data
  row stays within one rank.

  Args:
    data_devices_per_host: the 'data' extent; it divides each rank's
      device count.
    local_devices: this rank's devices; None is `local_device()` alone
      (one process per card). The CPU tests pass ['cpu'] * k.

  Raises:
    ValueError: if `data_devices_per_host` does not divide the local
      device count, or `local_devices` is None without a CUDA device.
  """
  local = ([local_device()] if local_devices is None
           else [torch.device(d) for d in local_devices])
  if len(local) % data_devices_per_host != 0:
    raise ValueError(
        f'{data_devices_per_host=} must divide local device count'
        f' {len(local)}.'
    )
  per_rank = [None] * dist.get_world_size()
  dist.all_gather_object(per_rank, [str(d) for d in local])
  return mesh_lib.default_mesh(
      [d for devices in per_rank for d in devices], None,
      data_devices_per_host,
      ranks=[r for r, devices in enumerate(per_rank) for _ in devices])


def is_multiprocess_mesh(mesh) -> bool:
  """True when the mesh's cells belong to more than one rank."""
  return isinstance(mesh, mesh_lib.Mesh) and mesh.is_multiprocess


def make_global(x: torch.Tensor, mesh: mesh_lib.Mesh) -> list:
  """This rank's ensemble groups of a leaf every rank holds whole (members
  on dim 0): group i, members [i E / ens, (i + 1) E / ens), on
  `mesh.home(i)`, and None for a group of which this rank holds no cell.

  Raises:
    ValueError: if E is not a multiple of the 'ens' extent.
  """
  groups = mesh.shape[mesh_lib.ENSEMBLE_AXIS]
  if x.shape[0] % groups:
    raise ValueError(
        f'{x.shape[0]} members do not split into {groups} ensemble groups; '
        'pad them to a multiple (`mesh.pad_ensemble_size`).')
  size = x.shape[0] // groups
  mine = {i for i, _ in mesh.local_cells}
  return [x[i * size:(i + 1) * size].to(mesh.home(i)) if i in mine else None
          for i in range(groups)]


def host_value(parts, owners, device, group=None) -> list:
  """Every part on every rank of `group` (None: all ranks), in index order.

  Part k is the value of rank `owners[k]`. `parts` holds this rank's values
  (None where it has none); they share one shape and dtype. Each rank's
  own parts, stacked and zero-padded to the most any rank owns, go through
  one `all_gather`, so the parts of the other ranks come back on `device`
  as copies of their owners' bits; this rank's own are returned as they
  are.
  """
  rank = dist.get_rank()
  members = dist.get_process_group_ranks(
      dist.group.WORLD if group is None else group)
  held = {r: [k for k, o in enumerate(owners) if o == r] for r in members}
  like = next(p for p in parts if p is not None)
  stack = torch.zeros((max(len(ks) for ks in held.values()),) + like.shape,
                      dtype=like.dtype, device=device)
  for n, k in enumerate(held[rank]):
    stack[n] = parts[k]
  gathered = [torch.empty_like(stack) for _ in members]
  dist.all_gather(gathered, stack, group=group)
  return [parts[k] if owner == rank else
          gathered[members.index(owner)][held[owner].index(k)]
          for k, owner in enumerate(owners)]


def host_leaves(parts, owners, device, group=None) -> list:
  """`host_value` of parts that are tuples of tensors (one tuple's shapes
  for all, one dtype): each tuple travels as one flat tensor."""
  shapes = [t.shape for t in next(p for p in parts if p is not None)]
  sizes = [int(torch.Size(s).numel()) for s in shapes]
  full = host_value(
      [None if p is None else torch.cat([t.reshape(-1) for t in p])
       for p in parts], owners, device, group)
  return [tuple(t.reshape(s) for t, s in zip(f.split(sizes), shapes))
          for f in full]


def row_groups(mesh: mesh_lib.Mesh) -> dict:
  """The process group of each row of `mesh` that spans several ranks,
  keyed by its sorted ranks (the whole world's is the default group).
  Made once per mesh, by every rank in the same order, as
  `torch.distributed.new_group` asks; the trainers call this on entry."""
  if getattr(mesh, '_row_groups', None) is None:
    world = tuple(range(dist.get_world_size()))
    groups = {}
    for row in mesh.ranks:
      key = tuple(sorted(set(row)))
      if len(key) > 1 and key not in groups:
        groups[key] = (dist.group.WORLD if key == world
                       else dist.new_group(list(key)))
    mesh._row_groups = groups  # pylint: disable=protected-access
  return mesh._row_groups  # pylint: disable=protected-access


def shard_exchange(mesh: mesh_lib.Mesh, i: int):
  """The `exchange` that `map.sum_over_shards` takes for ensemble group i:
  None when one rank holds every cell of row i, else `exchange_shards` of
  row i."""
  if mesh.ranks is None or len(set(mesh.ranks[i])) == 1:
    return None
  return functools.partial(exchange_shards, mesh, i)


def exchange_shards(mesh: mesh_lib.Mesh, i: int, results) -> list:
  """Every data shard's (losses, grads) of ensemble group i, on each rank of
  row i: `results` holds this rank's shards' (None for the others), all on
  one device, and the others come from the ranks that computed them, bit
  for bit. The caller adds them in shard order."""
  device = next(r for r in results if r is not None)[0].device
  full = host_leaves(
      [None if r is None else (r[0], *r[1]) for r in results],
      list(mesh.ranks[i]), device,
      group=row_groups(mesh)[tuple(sorted(set(mesh.ranks[i])))])
  return [(leaves[0], list(leaves[1:])) for leaves in full]


def barrier() -> None:
  """Waits for every rank (the checkpointer's single writer uses it)."""
  dist.barrier()
