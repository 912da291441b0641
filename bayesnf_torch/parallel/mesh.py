"""The ('ens', 'data') device mesh (counterpart of
`bayesnf_tpu/parallel/mesh.py`).

A `Mesh` is a grid of `torch.device`s:

- axis 'ens' splits the ensemble's members into groups, one group per row
  of the grid; groups never talk to each other.
- axis 'data' splits the training rows into shards, one per column; each
  step sums the shards' losses and gradients over it.

Any ensemble size runs on any mesh: the members are padded up to a multiple
of the 'ens' extent and the padding is dropped on the way out.

A device may appear in the grid more than once. That is the port's
counterpart of the JAX package's virtual CPU devices: the CPU tests run
every mesh path on a grid of 'cpu' entries, and one card rehearses a mesh
as a grid of 'cuda:0' entries.

A mesh may also span processes, one process (rank of a
`torch.distributed` group) per device, as NCCL wants it: `ranks` is then a
grid of ranks parallel to `devices`, since a `torch.device` cannot say which
process holds it (`cuda:0` of rank 0 is not `cuda:0` of rank 1). Every rank
builds the same `Mesh` and runs the same fit; each drives only its own
cells (`local_cells`) and the results are gathered on every rank
(`parallel/distributed.py`). Without ranks a mesh lives in one process.
"""

import math

import torch

ENSEMBLE_AXIS = 'ens'
DATA_AXIS = 'data'


class Mesh:
  """An (ens, data) grid of devices, in one process or across ranks.

  Attributes:
    devices: the grid, a tuple of `ens` rows of `data` `torch.device`s.
    ranks: None (one process), or the grid of the ranks that hold each
      cell, parallel to `devices`.
    rank: this process's rank in the `torch.distributed` group (None
      without `ranks`).
    shape: {'ens': rows, 'data': columns}.
    size: rows x columns.
  """

  def __init__(self, devices, ranks=None):
    """Args:
      devices: rows of devices (entries may repeat).
      ranks: None, or rows of ranks of the same shape: the process of each
        cell (this process's own rank is read from the initialized
        `torch.distributed` group).

    Raises:
      ValueError: for a grid that is empty or not rectangular, ranks of
        another shape, or ranks among which this process holds no cell.
    """
    rows = tuple(tuple(torch.device(d) for d in row) for row in devices)
    if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
      raise ValueError(
          f'A mesh is a non-empty rectangular grid of devices, got {devices}.')
    self.devices = rows
    self.shape = {ENSEMBLE_AXIS: len(rows), DATA_AXIS: len(rows[0])}
    self.size = len(rows) * len(rows[0])
    self.ranks = self.rank = None
    if ranks is not None:
      self.ranks = tuple(tuple(int(r) for r in row) for row in ranks)
      if [len(r) for r in self.ranks] != [len(r) for r in rows]:
        raise ValueError(
            f'ranks {ranks} are not a grid of the devices\' shape '
            f'{self.shape}.')
      self.rank = int(torch.distributed.get_rank())
      if not self.local_cells:
        raise ValueError(
            f'Rank {self.rank} holds no cell of the mesh (ranks {ranks}).')

  @property
  def is_multiprocess(self) -> bool:
    """True when the cells belong to more than one rank."""
    return self.ranks is not None and len(
        {r for row in self.ranks for r in row}) > 1

  def is_local(self, i: int, j: int) -> bool:
    """Whether this process holds cell (i, j)."""
    return self.ranks is None or self.ranks[i][j] == self.rank

  @property
  def local_cells(self) -> list[tuple[int, int]]:
    """The (group, shard) cells this process drives, row by row."""
    return [(i, j) for i, row in enumerate(self.devices)
            for j in range(len(row)) if self.is_local(i, j)]

  def home(self, i: int) -> torch.device:
    """The device of this process's first cell of row i, where it keeps
    group i (the row's first device in one process)."""
    return next(self.devices[i][j] for j in range(len(self.devices[i]))
                if self.is_local(i, j))

  @property
  def first_device(self) -> torch.device:
    """This process's first device, where a fit's results are gathered:
    the device of cell (0, 0) in one process."""
    i, j = self.local_cells[0]
    return self.devices[i][j]

  @property
  def device_type(self) -> str:
    """The one device type of the grid ('cuda' or 'cpu')."""
    types = {d.type for row in self.devices for d in row}
    if len(types) != 1:
      raise ValueError(f'A mesh holds devices of one type, got {types}.')
    return types.pop()

  def __repr__(self):
    ranks = '' if self.ranks is None else f', ranks={list(self.ranks)}'
    return (f'Mesh({self.shape}, {[[str(d) for d in r] for r in self.devices]}'
            f'{ranks})')


def default_mesh(devices=None, ensemble_devices: int | None = None,
                 data_devices: int = 1, ranks=None) -> Mesh:
  """The ('ens', 'data') mesh over `devices`, in order, row by row.

  Args:
    devices: a list of devices (entries may repeat); None means every CUDA
      device.
    ensemble_devices: the 'ens' extent; None means len(devices) //
      data_devices.
    data_devices: the 'data' extent.
    ranks: None (one process), or the rank that holds each of `devices`,
      laid out with them (`Mesh`).

  Raises:
    ValueError: if the extents do not multiply to the device count, or
      `devices` is None and there is no CUDA device.
  """
  if devices is None:
    devices = [torch.device('cuda', i) for i in range(torch.cuda.device_count())]
    if not devices:
      raise ValueError('No CUDA device: pass the mesh its devices.')
  n = len(devices)
  if ensemble_devices is None:
    if n % data_devices != 0:
      raise ValueError(f'{data_devices=} must divide device count {n}.')
    ensemble_devices = n // data_devices
  if ensemble_devices * data_devices != n:
    raise ValueError(
        f'{ensemble_devices=} * {data_devices=} != device count {n}.'
    )
  def rows(cells):
    cells = list(cells)
    return [cells[i * data_devices:(i + 1) * data_devices]
            for i in range(ensemble_devices)]

  return Mesh(rows(devices), None if ranks is None else rows(ranks))


def pad_ensemble_size(ensemble_size: int, mesh: Mesh) -> int:
  """Smallest multiple of the mesh's ensemble extent >= ensemble_size."""
  extent = mesh.shape[ENSEMBLE_AXIS]
  return int(math.ceil(ensemble_size / extent) * extent)


def check_mesh(mesh) -> Mesh:
  """`mesh` itself if it is a `Mesh` (in one process or across ranks).

  Raises:
    TypeError: for anything else (a JAX mesh included).
  """
  if not isinstance(mesh, Mesh):
    raise TypeError(
        f'mesh must be a bayesnf_torch.parallel.mesh.Mesh (see '
        f'`default_mesh`), got {type(mesh).__name__}.')
  return mesh
