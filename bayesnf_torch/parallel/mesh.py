"""The ('ens', 'data') device mesh (counterpart of
`bayesnf_tpu/parallel/mesh.py`).

A `Mesh` is a grid of `torch.device`s in one process:

- axis 'ens' splits the ensemble's members into groups, one group per row
  of the grid; groups never talk to each other.
- axis 'data' splits the training rows into shards, one per column; each
  step sums the shards' losses and gradients over it.

Any ensemble size runs on any mesh: the members are padded up to a multiple
of the 'ens' extent and the padding is dropped on the way out.

A device may appear in the grid more than once. That is the port's
counterpart of the JAX package's virtual CPU devices: the CPU tests run
every mesh path on a grid of 'cpu' entries, and one card rehearses a mesh
as a grid of 'cuda:0' entries. It is not `torch.distributed.DeviceMesh`,
which needs one process per device; meshes across processes are not ported
yet (ROADMAP.md, queue 1).
"""

import math

import torch

ENSEMBLE_AXIS = 'ens'
DATA_AXIS = 'data'


class Mesh:
  """An (ens, data) grid of devices.

  Attributes:
    devices: the grid, a tuple of `ens` rows of `data` `torch.device`s.
    shape: {'ens': rows, 'data': columns}.
    size: rows x columns.
  """

  def __init__(self, devices):
    rows = tuple(tuple(torch.device(d) for d in row) for row in devices)
    if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
      raise ValueError(
          f'A mesh is a non-empty rectangular grid of devices, got {devices}.')
    self.devices = rows
    self.shape = {ENSEMBLE_AXIS: len(rows), DATA_AXIS: len(rows[0])}
    self.size = len(rows) * len(rows[0])

  @property
  def first_device(self) -> torch.device:
    """The device of cell (0, 0), where a fit's results are gathered."""
    return self.devices[0][0]

  @property
  def device_type(self) -> str:
    """The one device type of the grid ('cuda' or 'cpu')."""
    types = {d.type for row in self.devices for d in row}
    if len(types) != 1:
      raise ValueError(f'A mesh holds devices of one type, got {types}.')
    return types.pop()

  def __repr__(self):
    return f'Mesh({self.shape}, {[[str(d) for d in r] for r in self.devices]})'


def default_mesh(devices=None, ensemble_devices: int | None = None,
                 data_devices: int = 1) -> Mesh:
  """The ('ens', 'data') mesh over `devices`, in order, row by row.

  Args:
    devices: a list of devices (entries may repeat); None means every CUDA
      device.
    ensemble_devices: the 'ens' extent; None means len(devices) //
      data_devices.
    data_devices: the 'data' extent.

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
  devices = list(devices)
  return Mesh([devices[i * data_devices:(i + 1) * data_devices]
               for i in range(ensemble_devices)])


def pad_ensemble_size(ensemble_size: int, mesh: Mesh) -> int:
  """Smallest multiple of the mesh's ensemble extent >= ensemble_size."""
  extent = mesh.shape[ENSEMBLE_AXIS]
  return int(math.ceil(ensemble_size / extent) * extent)


def check_mesh(mesh) -> Mesh:
  """`mesh` itself if it is a `Mesh`.

  Raises:
    TypeError: for anything else (a JAX mesh included).
  """
  if not isinstance(mesh, Mesh):
    raise TypeError(
        f'mesh must be a bayesnf_torch.parallel.mesh.Mesh (see '
        f'`default_mesh`), got {type(mesh).__name__}.')
  return mesh
