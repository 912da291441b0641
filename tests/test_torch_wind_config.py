"""The published wind stanza's field through the port against the
benchmark's plain reference, on the CPU.

The field is wind's exactly as `benchmark/configs/wind.json` states it:
inputs (t, latitude, longitude), seasonal periods 7, 30.4375 and 365.25
days with 3, 10 and 10 harmonics, Fourier degree 5 (F = 79), NORMAL, at
width 32 on a few hundred rows of the daily table (`benchmark/tables/
daily.py`). The benchmark's loads drive the port's estimators and trainers
on the 'torch' backend (the plain versions the kernels are held to on the
card) from seeded random parameters, and the reference
(`benchmark/reference/bayesnf_field.py`, plain PyTorch, loaded by path)
computes the same from the same inputs:

- predict means and mixture quantiles of 1,100 members (22 VI surrogates x
  50 posterior draws), past the 1,020 members that `quantiles.member_mean`
  sums in one block;
- a MAP step's and a VI step's loss and gradients (the first of the
  check's three steps from the benchmark's parameters).

Each number is held to a tolerance that the reference one precision down
('bf16': bfloat16 products, and a bfloat16 mixture CDF) exceeds.

The counters of its predict are tested beside their code:
`bnf.k2.row_chunks` in `test_torch_fused_mlp.py`,
`bnf.predict.member_blocks` in `test_torch_quantiles.py`.
"""

import json

import numpy as np
import pytest
import torch

from benchmark import loads
from benchmark import spec
from bayesnf_torch.inference import quantiles as t_quantiles

torch.set_num_threads(1)

SEED = 2**33 + 19
ROWS = 300  # 25 days of the 12 stations.
WIDTH = 32
SURROGATES, POSTERIOR_DRAWS = 22, 50  # 1,100 predict members.
QUANTILES = [0.5, 0.025, 0.975]

# Tolerances, each with the reading that it must separate.
# The means: the port and the reference sum the same float32 products in
# other orders (the port's encode and MLP against the reference's); at
# width 32 that moves a mean by ~1e-6 of the means' RMS, while bfloat16
# operands move it by ~1e-2.
MEAN_GAP = 1e-5
# The quantiles: the search stops where its float32 mixture CDF is within
# 1e-5 of q; the float64 CDF of the reference's means differs from that
# float32 one by float32 rounding over 1,100 members (< 1e-6). A bfloat16
# CDF (8 bits of mantissa) misses q by ~1e-3.
QUANTILE_RESIDUAL = 2e-5
# A training step: both sides sum the same float32 likelihood terms over
# the rows, in other orders: the loss agrees to ~1e-7 of itself or better,
# the median leaf's gradient norm to ~1e-8 of itself; bfloat16 products
# move the loss by ~5e-5 of itself and that norm by ~1e-4.
LOSS_GAP = 1e-5
GRAD_MEDIAN_GAP = 1e-5


def _cfg(objective):
  cfg = json.loads((spec.ROOT / 'configs' / 'wind.json').read_text())
  cfg['table']['rows'] = ROWS
  cfg['model']['width'] = WIDTH
  cfg['inference']['map'].update(num_particles=4, batch_size=ROWS)
  if objective == 'predict':
    cfg['inference']['vi'].update(num_particles=SURROGATES, batch_size=100,
                                  sample_size_divergence=2)
    cfg['posterior_draws'] = POSTERIOR_DRAWS
  else:
    cfg['inference']['vi'].update(num_particles=3, batch_size=64,
                                  sample_size_divergence=2)
  return cfg


def _load(objective):
  """The benchmark's load of the cut wind stanza on the CPU, set up."""
  traffic = ({'kind': 'predict', 'objective': 'vi', 'quantiles': QUANTILES,
              'grids': 1, 'trace_calls': 1, 'k2_chunk_rows': 4096}
             if objective == 'predict' else
             {'kind': 'fit', 'objective': objective, 'chunk_seconds': 0.1,
              'trace_steps': 1})
  load = loads.make(
      _cfg(objective), traffic, SEED, 'cpu', 'torch',
      spec.load_module(spec.ROOT / 'tables' / 'daily.py'),
      spec.load_module(spec.ROOT / 'reference' / 'bayesnf_field.py'))
  load.setup()
  return load


@pytest.fixture(scope='module')
def predict_load():
  """The predict load after its set-up, whose warm call kept the one
  grid's means and quantiles."""
  load = _load('predict')
  load.release()
  return load


def test_the_daily_table_has_wind_s_layout():
  table = spec.load_module(spec.ROOT / 'tables' / 'daily.py').make(78_888, 5)
  assert list(table.columns) == ['datetime', 'latitude', 'longitude', 'wind']
  assert len(table) == 78_888
  assert table['datetime'].iloc[0] == np.datetime64('1961-01-01')
  assert table['datetime'].iloc[-1] == np.datetime64('1978-12-31')
  assert table.groupby('datetime').size().eq(12).all()
  assert table[['latitude', 'longitude']].drop_duplicates().shape[0] == 12


def test_the_field_is_wind_s_published_layout(predict_load):
  m = predict_load.ref_model
  assert (m.num_inputs, len(m.freqs), m.encoded_dim) == (3, 23, 79)
  assert predict_load.shapes['members'] == SURROGATES * POSTERIOR_DRAWS
  assert predict_load.shapes['members'] > t_quantiles.MEMBER_BLOCK


@pytest.mark.parametrize('precision, within', [('f32', True),
                                                ('bf16', False)])
def test_predict_of_1100_members_against_the_reference(predict_load,
                                                       precision, within):
  load = predict_load
  if precision == 'f32':
    numbers = load.numbers(load.kept)
  else:
    numbers = load.numbers({g: load.reference_outputs(g, 'bf16')
                            for g in range(len(load.grids))})
  assert (numbers['mean_gap'] <= MEAN_GAP) == within, numbers
  assert (numbers['quantile_residual'] <= QUANTILE_RESIDUAL) == within, (
      numbers)


@pytest.mark.parametrize('objective', ['map', 'vi'])
def test_a_training_step_against_the_reference(objective):
  load = _load(objective)
  got = load.numbers(load.program)
  low = load.numbers(load.reference_readings('bf16'))
  assert got['loss_gap'] <= LOSS_GAP < low['loss_gap'], (got, low)
  assert (got['grad_median_gap'] <= GRAD_MEDIAN_GAP
          < low['grad_median_gap']), (got, low)
