"""Spatiotemporal feature encoders (counterpart of
`bayesnf_tpu/models/features.py`).

- Seasonal harmonics: frequencies {k/p_j : k=1..h_j}, deduplicated (first
  occurrence kept), features [cos(2*pi*f*t), sin(2*pi*f*t)] / harmonic.
- Fourier features: per input dimension with degree d,
  [cos(2*pi*2^k*x), sin(2*pi*2^k*x)] / (k+1) for k in [0, d), every octave
  after the first from the double-angle recurrence, as the JAX package
  computes them (so both round alike).
"""

import math

import numpy as np
import torch


def seasonal_frequency_table(
    seasonality_periods: np.ndarray, num_harmonics: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
  """Return deduplicated (frequencies, harmonic_numbers) for the periods.

  Harmonic k of period p contributes frequency k/p. Duplicate frequencies
  (e.g. harmonic 2 of period 12 == harmonic 1 of period 6) are removed,
  keeping the first occurrence in concatenation order.

  Raises:
    ValueError: if any harmonic count exceeds half its period, if the two
      arrays have different shapes, or if they are not rank 1.
  """
  seasonality_periods = np.asarray(seasonality_periods, dtype=np.float32)
  num_harmonics = np.asarray(num_harmonics)
  if np.any(num_harmonics > seasonality_periods / 2):
    raise ValueError(
        'num_harmonics[i] is capped at seasonality_periods[i] / 2: harmonics '
        'past the Nyquist count alias onto lower ones.'
    )
  if seasonality_periods.shape != num_harmonics.shape:
    raise ValueError(
        f'shape mismatch: {seasonality_periods.shape=} vs '
        f'{num_harmonics.shape=} (one harmonic count per period).'
    )
  if num_harmonics.ndim != 1:
    raise ValueError(
        f'seasonality_periods/num_harmonics must be rank-1 arrays, got '
        f'rank {num_harmonics.ndim}.'
    )
  if seasonality_periods.size == 0:
    return (np.zeros(0), np.zeros(0))
  table: dict[float, float] = {}
  for period, count in zip(seasonality_periods, num_harmonics):
    for k in np.arange(1, count + 1, dtype=np.float32):
      table.setdefault(float(k / period), float(k))
  return (
      np.fromiter(table.keys(), dtype=np.float32, count=len(table)),
      np.fromiter(table.values(), dtype=np.float32, count=len(table)),
  )


def seasonal_features(
    t: torch.Tensor,
    frequencies,
    harmonics,
    rescale: bool = True,
) -> torch.Tensor:
  """Seasonal harmonic features of the raw time column.

  Args:
    t: (N,) raw (unscaled) float32 time values.
    frequencies: (F,) deduplicated frequencies from
      :func:`seasonal_frequency_table`.
    harmonics: (F,) harmonic numbers aligned with `frequencies`.
    rescale: divide each cos/sin pair by its harmonic number.

  Returns:
    (N, 2F) tensor laid out [cos_f1..cos_fF, sin_f1..sin_fF].
  """
  frequencies = torch.as_tensor(
      np.asarray(frequencies, dtype=np.float32), device=t.device
  )
  harmonics = torch.as_tensor(
      np.asarray(harmonics, dtype=np.float32), device=t.device
  )
  if frequencies.shape[0] == 0:
    return torch.zeros(t.shape[:1] + (0,), dtype=torch.float32, device=t.device)
  # Same association as the JAX package, (2*pi*f) * t: at t ~ 4e4 one f32
  # ulp of the angle is ~1e-3 rad, so the order of the products matters.
  angles = (2.0 * math.pi * frequencies) * t[..., None]
  feats = torch.cat([torch.cos(angles), torch.sin(angles)], dim=-1)
  if rescale:
    feats = feats / harmonics.repeat(2)
  return feats


def fourier_features_t(
    x: torch.Tensor, max_degree: int, rescale: bool = True
) -> torch.Tensor:
  """Features-major octave Fourier features: (..., N) -> (..., 2d, N).

  Rows index [cos_0..cos_{d-1}, sin_0..sin_{d-1}]; octave k+1 comes from
  octave k through cos2t = 2c^2 - 1, sin2t = 2sc.
  """
  if max_degree <= 0:
    return torch.zeros(
        x.shape[:-1] + (0,) + x.shape[-1:], dtype=x.dtype, device=x.device
    )
  theta = 2.0 * math.pi * x
  c, s = torch.cos(theta), torch.sin(theta)
  coss, sins = [c], [s]
  for _ in range(max_degree - 1):
    c, s = 2.0 * c * c - 1.0, 2.0 * s * c
    coss.append(c)
    sins.append(s)
  feats = torch.stack(coss + sins, dim=-2)
  if rescale:
    denom = torch.arange(
        1, max_degree + 1, dtype=x.dtype, device=x.device
    ).repeat(2)
    feats = feats / denom[:, None]
  return feats


def fourier_features(
    x: torch.Tensor, max_degree: int, rescale: bool = True
) -> torch.Tensor:
  """Row-major octave Fourier features: (N,) -> (N, 2d)."""
  return fourier_features_t(x, max_degree, rescale).transpose(-1, -2)
