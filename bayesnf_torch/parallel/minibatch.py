"""The row layout over a mesh's 'data' axis and its per-shard minibatches
(counterpart of `bayesnf_tpu/parallel/minibatch.py`).

Row layout. The stored rows are laid out so that each data shard holds a
valid prefix: shard s stores `local_rows` rows, of which the first n_s are
real (the n_s differ by at most 1: "balanced") and the rest are zero
padding. When N % shards == 0 the layout is the identity. A full-batch step
over the shards masks each shard's padding: K1 takes the shard's valid-row
count (`fused_train(n_valid=n_s)`), the 'torch' backend weights the padded
rows 0 (`valid_row_weights`).

Minibatches. With a batch that splits evenly over the shards, each shard
contributes batch_size / shards rows to every step, drawn from its own valid
rows by a per-shard local permutation (`local_permutation`), so rows never
leave their shard. Balance is what guarantees every shard can supply
(N // B) * (B / shards) rows an epoch. A batch that does not split evenly
takes the global permutation of the one-shard scheme, mapped into the
stored layout by `stored_positions` (the 'torch' backend only, as the JAX
package's GSPMD path).

RNG deviation: the JAX package draws a shard's uniforms from its member
key with the shard index folded in (`jax.random.fold_in`). The port's MAP
fits draw them from a generator per (member, data shard), its VI fits from
the fit's one step generator, all seeded from the fit's seed
(`map.stream_seed`); both backends of a fit use the same draws, and tests
feed the JAX package's permutations instead.
"""

from typing import NamedTuple

import numpy as np
import torch


class RowShard(NamedTuple):
  """One data shard's stored rows, on one device."""

  x_t: torch.Tensor  # (D, local_rows)
  seasonal_t: torch.Tensor  # (2F, local_rows)
  y: torch.Tensor  # (local_rows,)
  n_valid: int | None  # its valid prefix; None when it holds no padding


def shard_counts(data_size: int, shards: int) -> tuple[int, list[int]]:
  """(local_rows, per-shard valid counts) of the balanced layout."""
  base, extra = divmod(data_size, shards)
  local_rows = base + (1 if extra else 0)
  return local_rows, [base + (1 if s < extra else 0) for s in range(shards)]


def pad_rows_balanced(aug_t: torch.Tensor, target: torch.Tensor,
                      data_size: int, shards: int):
  """(aug_t, target) of (F, N) and (N,) in the balanced layout: shard s's
  segment is original rows [sum(n_<s), sum(n_<=s)) followed by
  local_rows - n_s zero rows. Identity when N % shards == 0."""
  local_rows, counts = shard_counts(data_size, shards)
  if local_rows * shards == data_size:
    return aug_t, target
  segs_a, segs_y, off = [], [], 0
  for n_s in counts:
    pad = local_rows - n_s
    segs_a.append(torch.nn.functional.pad(aug_t[:, off:off + n_s], (0, pad)))
    segs_y.append(torch.nn.functional.pad(target[off:off + n_s], (0, pad)))
    off += n_s
  return torch.cat(segs_a, dim=1), torch.cat(segs_y)


def valid_row_weights(data_size: int, shards: int, device='cpu'):
  """(shards * local_rows,) float32 mask of the real rows of the balanced
  layout: 1.0 real, 0.0 padding."""
  local_rows, counts = shard_counts(data_size, shards)
  pos = torch.arange(local_rows, device=device)
  return torch.cat([(pos < n_s).float() for n_s in counts])


def local_valid_count(data_size: int, shards: int, shard_index: int) -> int:
  """Shard `shard_index`'s valid-row count n_s."""
  base, extra = divmod(data_size, shards)
  return base + int(shard_index < extra)


def stored_positions(data_size: int, shards: int) -> np.ndarray:
  """(N,) map from original row index to stored position."""
  local_rows, counts = shard_counts(data_size, shards)
  out = np.empty(data_size, np.int64)
  off = 0
  for s, n_s in enumerate(counts):
    out[off:off + n_s] = s * local_rows + np.arange(n_s)
    off += n_s
  return out


def local_permutation(uniforms: torch.Tensor, n_valid: int, count: int):
  """`count` distinct uniformly random valid local row positions per row of
  `uniforms` (members, local_rows): the JAX package's scheme, padding rows
  pushed to +inf, a stable argsort, its prefix. Given the JAX package's
  uniforms it returns its positions."""
  local_rows = uniforms.shape[-1]
  valid = torch.arange(local_rows, device=uniforms.device) < n_valid
  u = torch.where(valid, uniforms, torch.inf)
  return torch.argsort(u, dim=-1, stable=True)[..., :count]


def local_permutations(generator, members: int, local_rows: int,
                       n_valid: int, count: int):
  """`local_permutation` of one draw of (members, local_rows) uniforms from
  `generator`, on its device."""
  return local_permutation(
      torch.rand((members, local_rows), generator=generator,
                 device=generator.device), n_valid, count)


def shard_rows(aug_t, target, mesh, num_inputs: int):
  """The balanced layout of the N rows over `mesh`: rows[i][j] is data
  shard j as a `RowShard` on device (i, j), or None for a cell of another
  rank (a rank places only its own cells' rows). A device that appears in
  several cells holds one copy of each shard it serves; a one-shard mesh
  keeps `aug_t`'s rows as they are (views, no copy, on their device)."""
  n = target.shape[0]
  shards = len(mesh.devices[0])
  local_rows, counts = shard_counts(n, shards)
  aug_p, y_p = pad_rows_balanced(aug_t, target, n, shards)
  placed = {}
  rows = []
  for i, row in enumerate(mesh.devices):
    rows.append([])
    for j, dev in enumerate(row):
      if not mesh.is_local(i, j):
        rows[-1].append(None)
        continue
      if (j, dev) not in placed:
        cols = slice(j * local_rows, (j + 1) * local_rows)
        a = aug_p[:, cols].to(dev)
        if not a.is_contiguous():
          a = a.contiguous()
        placed[j, dev] = RowShard(
            a[:num_inputs], a[num_inputs:], y_p[cols].to(dev),
            counts[j] if counts[j] < local_rows else None)
      rows[-1].append(placed[j, dev])
  return rows
