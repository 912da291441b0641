"""Checkpoint and resume of an ensemble fit (counterpart of
`bayesnf_tpu/utils/checkpoint.py`).

A fit with a `checkpoint_dir` trains in chunks and saves, after each chunk,
everything the rest of the fit depends on: the parameters (MAP) or the
surrogate's locs and raw scales (VI), the Adam state, the state of every
random generator the fit draws from, the loss history and the epoch (MAP)
or step (VI). A fit restarted on the same directory resumes from the
newest save, and its losses and parameters equal those of a fit that was
never interrupted, bit for bit.

Intended differences from the JAX package:

- The format: one `torch.save` file a saved step (`step_<n>.pt`), written
  to a temporary name and then `os.replace`d, where the JAX package writes
  orbax directories. Neither package reads the other's checkpoints.
- Local directories only: a remote URI (`gs://...`) raises ValueError,
  since the port does not depend on orbax or etils, which write them.
"""

import dataclasses
import hashlib
import json
import os
import re

import torch

_STEP_FILE = re.compile(r'^step_(\d+)\.pt$')


@dataclasses.dataclass
class TrainState:
  """A host snapshot of a fit between two chunks.

  Attributes:
    params: the parameter leaves (MAP), or the surrogate's locs then raw
      scales (VI), each with a leading member axis.
    opt_count: Adam's step count, a Python int (its bias corrections are
      computed from it on the host).
    opt_mu: Adam's first moments, one per leaf of `params`.
    opt_nu: Adam's second moments.
    rng_states: the `get_state()` of each generator the fit draws from, in
      the fit's own order.
    losses: the loss history so far, a list of (E, chunk) tensors.
    epoch: epochs (MAP) or steps (VI) done.
  """

  params: tuple
  opt_count: int
  opt_mu: tuple
  opt_nu: tuple
  rng_states: tuple
  losses: list
  epoch: int

  @classmethod
  def from_fit(cls, params, opt_state, generators, losses, epoch):
    """A snapshot of tensors on any device: every tensor copied to the
    CPU, Adam's state from an `AdamState` (count, mu, nu)."""

    def host(leaves):
      return tuple(t.detach().cpu() for t in leaves)

    return cls(host(params), int(opt_state.count), host(opt_state.mu),
               host(opt_state.nu), tuple(g.get_state() for g in generators),
               list(host(losses)), int(epoch))

  def place(self, device):
    """(params, (count, mu, nu)) of this snapshot on `device`."""

    def put(leaves):
      return tuple(t.to(device) for t in leaves)

    return put(self.params), (self.opt_count, put(self.opt_mu),
                              put(self.opt_nu))

  def restore_generators(self, generators):
    """Sets each of `generators` to its saved state.

    Raises:
      ValueError: if the fit draws from another number of generators than
        the one that saved.
    """
    if len(generators) != len(self.rng_states):
      raise ValueError(
          f'The checkpoint holds {len(self.rng_states)} generator states; '
          f'this fit draws from {len(generators)}.')
    for generator, state in zip(generators, self.rng_states):
      generator.set_state(state)

  def to_dict(self):
    return {
        'params': list(self.params),
        'opt_count': self.opt_count,
        'opt_mu': list(self.opt_mu),
        'opt_nu': list(self.opt_nu),
        'rng_states': list(self.rng_states),
        'losses': list(self.losses),
        'epoch': self.epoch,
    }

  @classmethod
  def from_dict(cls, tree):
    return cls(
        params=tuple(tree['params']),
        opt_count=int(tree['opt_count']),
        opt_mu=tuple(tree['opt_mu']),
        opt_nu=tuple(tree['opt_nu']),
        rng_states=tuple(tree['rng_states']),
        losses=list(tree['losses']),
        epoch=int(tree['epoch']),
    )


def run_fingerprint(**kwargs) -> str:
  """A short digest of what identifies a fit (model config, objective,
  ensemble size, optimizer settings, ...): the first 16 hex digits of the
  sha256 of `repr(sorted(kwargs.items()))`, the JAX package's recipe. A
  directory written under one fingerprint refuses to resume under another.
  Every value's repr must be stable across processes (no object
  addresses): the port's `FieldConfig` is a frozen dataclass of tuples."""
  blob = repr(sorted(kwargs.items()))
  return hashlib.sha256(blob.encode('utf-8')).hexdigest()[:16]


def _local_directory(directory) -> str:
  """`directory` made absolute.

  Raises:
    ValueError: for a remote URI (scheme://...).
  """
  if re.match(r'^[a-zA-Z][a-zA-Z0-9+.-]*://', str(directory)):
    raise ValueError(
        f'checkpoint_dir {directory!r} is a remote URI: the port writes '
        'checkpoints to local directories only (the JAX package writes '
        'remote ones through orbax, which the port does not use).')
  return os.path.abspath(directory)


class TrainCheckpointer:
  """Saves `TrainState`s of one fit into a directory, one file a step.

  With a `fingerprint`, the directory carries it in `fingerprint.json`;
  opening a directory whose saved steps were written under another one
  raises at once instead of resuming the wrong fit.
  """

  def __init__(self, directory, max_to_keep: int = 2,
               fingerprint: str | None = None,
               legacy_fingerprints: tuple[str, ...] = ()):
    """Opens (and creates) `directory`.

    Args:
      directory: a local directory.
      max_to_keep: the newest saves kept; older ones are deleted.
      fingerprint: `run_fingerprint` of this fit, or None (no check).
      legacy_fingerprints: earlier digests of this same configuration
        (a superseded recipe), accepted as this fit; a directory marked
        with one keeps its marker, so it stays resumable by both recipes.

    Raises:
      ValueError: for a remote URI, or if the directory holds saved steps
        of a fit with another fingerprint.
    """
    self.directory = _local_directory(directory)
    os.makedirs(self.directory, exist_ok=True)
    self.max_to_keep = int(max_to_keep)
    self._fingerprint = fingerprint
    self._meta_path = os.path.join(self.directory, 'fingerprint.json')
    if fingerprint is None:
      return
    stored = self._read_marker()
    if stored in tuple(legacy_fingerprints):
      # This configuration under the superseded recipe: resume, and keep
      # its marker.
      self._fingerprint = stored
      return
    if stored is not None and stored != fingerprint:
      if self.latest_step() is not None:
        raise ValueError(
            f'Checkpoint directory {self.directory!r} was written by a run '
            f'with a different configuration (stored fingerprint {stored}, '
            f'this run {fingerprint}). Use a fresh directory, or delete the '
            'stale checkpoints.')
      # A marker with no saved step is left by a fit that stopped before
      # its first save: nothing to resume, so this fit claims the
      # directory. (If that fit is in fact alive, its first save then
      # fails: `save` checks the marker again.)
      stored = None
    if stored is None:
      self._write_marker(fingerprint)

  def _write_marker(self, fingerprint: str):
    # Published in one step (a temporary file, then os.replace), so a
    # reader never sees half a marker.
    tmp = os.path.join(self.directory, f'.fingerprint.{os.getpid()}.tmp')
    with open(tmp, 'w') as f:
      json.dump({'fingerprint': fingerprint}, f)
    os.replace(tmp, self._meta_path)

  def _read_marker(self):
    """The stored fingerprint; None when there is none, or when the marker
    is torn or empty (damage from outside: writes publish atomically)."""
    try:
      with open(self._meta_path) as f:
        return json.load(f).get('fingerprint')
    except FileNotFoundError:
      return None
    except (json.JSONDecodeError, ValueError, AttributeError):
      return None

  def steps(self) -> list[int]:
    """The saved steps, oldest first."""
    found = (_STEP_FILE.match(name) for name in os.listdir(self.directory))
    return sorted(int(m.group(1)) for m in found if m)

  def latest_step(self):
    steps = self.steps()
    return steps[-1] if steps else None

  def _path(self, step: int) -> str:
    return os.path.join(self.directory, f'step_{int(step)}.pt')

  def save(self, state: TrainState):
    """Writes `state` as step `state.epoch`, then deletes all but the
    newest `max_to_keep` steps.

    Raises:
      ValueError: if another fit has claimed the directory since this one
        opened it.
    """
    if self._fingerprint is not None:
      stored = self._read_marker()
      if stored != self._fingerprint:
        raise ValueError(
            'Checkpoint directory was claimed by a different run since this '
            f'one started (marker fingerprint {stored}, this run '
            f'{self._fingerprint}); refusing to interleave saves.')
    path = self._path(state.epoch)
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save(state.to_dict(), tmp)
    os.replace(tmp, path)
    for step in self.steps()[:-self.max_to_keep]:
      os.remove(self._path(step))

  def restore_latest(self) -> TrainState | None:
    """The newest saved state, its tensors on the CPU; None if there is
    none."""
    step = self.latest_step()
    if step is None:
      return None
    tree = torch.load(self._path(step), map_location='cpu',
                      weights_only=True)
    return TrainState.from_dict(tree)
