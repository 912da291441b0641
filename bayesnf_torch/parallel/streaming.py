"""Host-streaming minibatch training (counterpart of
`bayesnf_tpu/parallel/streaming.py`).

The on-device trainers keep the whole table on the card. A streamed fit
(`stream_chunk_steps`) keeps it in host memory, a numpy array or an
`np.memmap` on disk, and sends the card one slice of `stream_chunk_steps`
steps' batches at a time. The card then holds the model, its optimizer
state and two slices, whatever the table's size.

The copy pipeline (`run_stream_driver`) in CUDA's idiom: each slice is
gathered in numpy into a pinned staging buffer, copied to the card with
`non_blocking=True` on a side `torch.cuda.Stream`, and an event recorded
there; the compute stream waits on that event before the slice's first K1
call. Two slots of staging and device buffers take turns: before slot k % 2
is refilled, the host waits on slice k - 2's copy event (so the pinned
buffer is free) and the copy stream waits on slice k - 2's last step (so
the device buffer is no longer read). On the CPU the same loop runs without
streams.

Across ranks (`parallel/distributed.py`) every rank builds the same
slices from the same entropy and keeps only the columns of its own data
shards (`run_stream_driver(columns=...)`), which it uploads to its own
first device.

The batch schedule is the JAX package's, derived in numpy from an entropy
tuple (`epoch_permutation`, `step_sample`): one permutation of the rows an
epoch, shared by every member (MAP, MLE; split into N // B steps, the
ragged tail dropped), or a fresh batch of B rows each step (VI,
`per_step_resample`). Given the JAX package's entropy
(`stream_entropy(opt_seed)` there) the port draws its batches bit for bit.
The port's fits take the entropy from their int seed instead
(`map.stream_seed(seed, map.HOST_STREAM)`), an RNG deviation. The schedule
depends only on (entropy, step), so a resumed fit replays it with no stream
state saved.

Member remix (`stream_member_remix`): each member permutes the slice's
S x B resident rows into its own S batches, with a generator of its own on
the fit's device seeded from `map.stream_seed(seed, map.REMIX_STREAM,
slice start step, global member id)` (`remix_indices`). That is
deterministic in the slice's absolute start step, so a resume replays it,
and does not depend on how the members are grouped over a mesh. It is an
RNG deviation from the JAX package, whose `fold_in` and `permutation` torch
cannot reproduce: the remixed batches differ, the scheme is the same.
"""

import numpy as np
import torch


def _step_rng(entropy: tuple[int, ...], step: int) -> np.random.Generator:
  return np.random.default_rng(
      np.random.SeedSequence(entropy=list(entropy) + [int(step)]))


def epoch_permutation(entropy: tuple[int, ...], epoch: int,
                      data_size: int) -> np.ndarray:
  """The row permutation of `epoch`, shared by every member (int32 where it
  fits: at streaming scale it is the one O(N) array on the host)."""
  rng = _step_rng(entropy, epoch)
  if data_size <= np.iinfo(np.int32).max:
    return rng.permutation(np.arange(data_size, dtype=np.int32))
  return rng.permutation(data_size)


def step_sample(entropy: tuple[int, ...], step: int, data_size: int,
                batch_size: int) -> np.ndarray:
  """A batch of `batch_size` distinct rows for VI step `step`, in O(batch)
  host work (`Generator.choice` without replacement), deterministic in
  (entropy, step)."""
  return _step_rng(entropy, step).choice(
      data_size, size=batch_size, replace=False)


class HostBatchStream:
  """Assembles each step's minibatch from a host-resident table.

  Args:
    aug_t: (F, N) float32 inputs, features-major: the transposed view of an
      (N, F) numpy array or memmap, so that a batch gathers whole rows of
      the original.
    target: (N,) float32 targets.
    batch_size: rows a step; each epoch drops its ragged tail.
    entropy: a tuple of ints seeding the schedule.
    per_step_resample: False (MAP, MLE): epoch e's permutation split into
      N // B batches; True (VI): a fresh batch every step (`step_sample`).

  Raises:
    ValueError: if the batch is larger than the table.
  """

  def __init__(self, aug_t, target, batch_size: int, entropy,
               per_step_resample: bool = False):
    self.aug_t = aug_t
    self.target = target
    self.batch_size = int(batch_size)
    self.data_size = int(target.shape[0])
    self.num_batches = self.data_size // self.batch_size
    if self.num_batches < 1:
      raise ValueError(
          f'batch_size {batch_size} exceeds the dataset ({self.data_size}'
          ' rows).')
    self.per_step_resample = bool(per_step_resample)
    self.entropy = tuple(int(v) for v in entropy)
    self._perm_epoch = -1
    self._perm = None

  def batch_rows(self, step: int) -> np.ndarray:
    """Row indices of step `step` (0-based, counted across epochs)."""
    if self.per_step_resample:
      return step_sample(self.entropy, step, self.data_size, self.batch_size)
    epoch, b = divmod(step, self.num_batches)
    if epoch != self._perm_epoch:
      self._perm = epoch_permutation(self.entropy, epoch, self.data_size)
      self._perm_epoch = epoch
    return self._perm[b * self.batch_size:(b + 1) * self.batch_size]

  def slice_at(self, step: int, num_steps: int, out=None, columns=None):
    """(num_steps, F, B) inputs and (num_steps, B) targets of steps `step`
    on, written into `out` (a pair of float32 arrays at least that large)
    when it is given; with `columns` (positions within a batch) only those
    B' columns of each step's batch, (num_steps, F, B') and (num_steps,
    B')."""
    width = self.batch_size if columns is None else len(columns)
    shape = (num_steps, self.aug_t.shape[0], width)
    if out is None:
      aug = np.empty(shape, dtype=np.float32)
      y = np.empty((num_steps, width), dtype=np.float32)
    else:
      aug, y = out[0][:num_steps], out[1][:num_steps]
    for s in range(num_steps):
      rows = self.batch_rows(step + s)
      if columns is not None:
        rows = rows[columns]
      aug[s] = self.aug_t[:, rows]
      y[s] = self.target[rows]
    return aug, y

  def slices(self, start_step: int, num_steps: int, slice_steps: int):
    """Yields (step, aug, y) slices covering `num_steps` steps from
    `start_step`, each of `slice_steps` steps but maybe the last."""
    for step, s in slice_bounds(start_step, num_steps, slice_steps):
      aug, y = self.slice_at(step, s)
      yield step, aug, y


def slice_bounds(start_step: int, num_steps: int, slice_steps: int):
  """(first step, steps) of each slice covering `num_steps` steps."""
  step, end = start_step, start_step + num_steps
  while step < end:
    s = min(slice_steps, end - step)
    yield step, s
    step += s


def remix_indices(member_seeds, steps: int, rows: int, device):
  """The member remix of one slice: (steps, E, rows) positions into the
  slice's pool of steps x rows resident rows (step-major), member m's S
  batches a permutation of the pool drawn by a generator on `device`
  seeded with `member_seeds[m]`."""
  uniforms = torch.stack([
      torch.rand(steps * rows, device=device, generator=torch.Generator(
          device=device).manual_seed(int(seed))) for seed in member_seeds])
  perms = torch.argsort(uniforms, dim=1)
  return perms.reshape(len(member_seeds), steps, rows).transpose(0, 1)


def remix_pool(aug_s, y_s):
  """The resident rows of a slice, (S, F, B) and (S, B), as one pool of
  S x B rows, step-major: (F, S x B) and (S x B,)."""
  s, f, b = aug_s.shape
  return aug_s.permute(1, 0, 2).reshape(f, s * b), y_s.reshape(s * b)


def validate_remix_alignment(window: int, start_step: int,
                             checkpoint_steps: int | None) -> None:
  """Remix windows are keyed by their absolute start step: checkpoint
  chunks and the resume step must fall on window boundaries, or a resumed
  fit would compose its batches mid-window and leave the schedule of the
  fit it claims to continue.

  Raises:
    ValueError: for a chunk that is not a whole number of windows, or a
      start step inside a window.
  """
  window = int(window)
  if checkpoint_steps is not None and checkpoint_steps % window:
    raise ValueError(
        'stream_member_remix makes stream_chunk_steps the remix '
        'window: checkpoint chunks must cover whole windows so a '
        'resume replays identical batches (got checkpoint chunk of '
        f'{checkpoint_steps} steps, window {window}). Pick '
        'checkpoint_every/batch_size so the checkpoint chunk step count '
        'is a multiple of stream_chunk_steps.')
  if start_step % window:
    raise ValueError(
        'stream_member_remix resume must start on a remix window '
        f'boundary (window {window} steps, resuming at step '
        f'{start_step}): extending a run whose completed step count is '
        'not a multiple of the window would recompose batches mid-window '
        'instead of replaying the fresh-run schedule. Pick num_epochs so '
        'the total step count is a multiple of stream_chunk_steps.')


class _Slot:
  """One upload's buffers: pinned host memory and its twin on the card, with
  the events of the last copy into them and of the last work that read
  them."""

  def __init__(self, shapes, device):
    self.host = [torch.empty(s, pin_memory=True) for s in shapes]
    self.dev = [torch.empty(s, device=device) for s in shapes]
    self.rows = 0
    self.copied = None
    self.consumed = None


class HostUploads:
  """Host-to-device uploads through two slots of pinned buffers (the copy
  pipeline of the module docstring), shared by the streamed fits and the
  streamed predict.

  `send` fills the next slot's pinned buffers on the host and copies them
  to the card on a side stream; `receive` makes the current stream wait for
  that copy and returns the device buffers; `release`, called once the
  work that reads them is queued, lets the slot be refilled after that
  work. Before a slot is refilled the host waits for its last copy (so the
  pinned buffer is free) and the copy stream for its last reader (so the
  device buffer is). On the CPU each upload is a new array and the three
  calls need no streams.

  Args:
    shapes: the shape of each buffer of a slot; an upload fills a leading
      run of rows of each.
    device: where the uploads go.
  """

  def __init__(self, shapes, device):
    self.shapes = [tuple(int(d) for d in s) for s in shapes]
    self.device = torch.device(device)
    self.cuda = self.device.type == 'cuda'
    if self.cuda:
      self._slots = [_Slot(self.shapes, self.device) for _ in range(2)]
      self._copies = torch.cuda.Stream(self.device)
      self._compute = torch.cuda.current_stream(self.device)
    self._count = 0

  def send(self, fill):
    """Starts an upload: `fill(arrays)` writes the host arrays (numpy views
    of the slot's buffers, one per shape) and returns how many leading rows
    to copy. Returns the upload's handle."""
    if not self.cuda:
      host = [np.empty(s, dtype=np.float32) for s in self.shapes]
      rows = fill(host)
      return [torch.from_numpy(h[:rows]) for h in host]
    slot = self._slots[self._count % 2]
    self._count += 1
    if slot.copied is not None:
      slot.copied.synchronize()  # the pinned buffer is free again
    slot.rows = fill([h.numpy() for h in slot.host])
    with torch.cuda.stream(self._copies):
      if slot.consumed is not None:
        self._copies.wait_event(slot.consumed)  # nothing reads it any more
      for dev, host in zip(slot.dev, slot.host):
        dev[:slot.rows].copy_(host[:slot.rows], non_blocking=True)
      slot.copied = torch.cuda.Event()
      slot.copied.record(self._copies)
    return slot

  def receive(self, handle):
    """The uploaded device tensors, the current stream ordered after their
    copy."""
    if not self.cuda:
      return handle
    self._compute.wait_event(handle.copied)
    return [dev[:handle.rows] for dev in handle.dev]

  def release(self, handle):
    """Marks the upload's device buffers free once the work queued so far
    on the current stream is done."""
    if self.cuda:
      handle.consumed = torch.cuda.Event()
      handle.consumed.record(self._compute)


def run_stream_driver(stream: HostBatchStream, *, device, run_slice, state,
                      start_step: int, num_steps: int, slice_steps: int,
                      checkpoint_steps: int | None, on_chunk, columns=None):
  """The host loop of a streamed fit, shared by the MAP and VI trainers.

  Runs steps `start_step` to `num_steps` in chunks of `checkpoint_steps`
  (None: one chunk), each in slices of `slice_steps` steps sent to `device`
  (see the module docstring for the copies on CUDA).

  Args:
    stream: the host batch stream.
    device: where the slices go (a mesh fit's first device).
    run_slice: `(state, aug (S, F, B), y (S, B), slice_step) -> (state,
      losses)`, the trainer's steps over one slice on the current stream,
      `losses` a list of one entry a step.
    state: the trainer's state, passed through `run_slice`.
    start_step: the first step (0, or a resumed fit's).
    num_steps: the fit's total steps.
    slice_steps: steps a slice.
    checkpoint_steps: steps a chunk, or None.
    on_chunk: `(state, losses, steps_done)` after each chunk, `losses` its
      list of `run_slice`'s per-step entries.
    columns: None, or the positions within a step's batch to send (a rank's
      data shards, `HostBatchStream.slice_at`); the slices are then
      (S, F, len(columns)).

  Returns:
    The final state.
  """
  features = stream.aug_t.shape[0]
  width = stream.batch_size if columns is None else len(columns)
  uploads = HostUploads([(slice_steps, features, width),
                         (slice_steps, width)], device)
  step = start_step
  while step < num_steps:
    chunk = (num_steps - step if checkpoint_steps is None
             else min(checkpoint_steps, num_steps - step))
    chunk_losses = []
    for slice_step, s in slice_bounds(step, chunk, slice_steps):

      def fill(host, slice_step=slice_step, s=s):
        stream.slice_at(slice_step, s, out=host, columns=columns)
        return s

      upload = uploads.send(fill)
      aug, y = uploads.receive(upload)
      state, losses = run_slice(state, aug, y, slice_step)
      chunk_losses.extend(losses)
      uploads.release(upload)
    step += chunk
    on_chunk(state, chunk_losses, step)
  return state
