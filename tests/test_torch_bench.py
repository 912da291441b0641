"""`bench_torch.py`, the port's bench leg, rehearsed on the CPU.

Each cell's leg runs on the 'torch' backend at a tiny size (a few hundred
rows, width 8, two members): the warm-up fit, the timed epochs, the
predicts, their checks and the JSON fields. The card's numbers come only
from a run on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import bench_torch

torch.set_num_threads(1)


def _tiny(leg):
  rows = 3 * bench_torch.SST_LOCATIONS if leg.dataset == 'sst' else 400
  return dataclasses.replace(
      leg, width=8, rows=rows, members=2, timed_epochs=2,
      batch_size=None if leg.batch_size is None else 100)


@pytest.mark.parametrize('cell', sorted(bench_torch.CELLS))
def test_each_cell_runs_on_the_cpu(cell, monkeypatch):
  monkeypatch.setattr(bench_torch, 'PREDICT_CALLS', 2)
  leg = next(l for l in bench_torch.CELLS[cell] if l.backend == 'torch'
             ) if cell != 'widths' else dataclasses.replace(
                 bench_torch.CELLS[cell][0], backend='torch')
  leg = _tiny(leg)
  out = bench_torch.run_leg(leg, repeats=2, seed=0, device='cpu', card='cpu')
  rate = out['member_steps_per_s']
  assert rate['min'] <= rate['median'] <= rate['max']
  assert rate['spread'] == pytest.approx(
      (rate['max'] - rate['min']) / rate['median'])
  assert len(rate['runs']) == 2 and len(out['predict_ms']['runs']) == 2
  steps = leg.timed_epochs * (1 if leg.batch_size is None else 4)
  assert out['steps_per_repeat'] == steps
  assert (out['rows'], out['members'], out['width']) == (leg.rows, 2, 8)
  assert out['likelihood'] == ('NB' if cell == 'nb' else 'NORMAL')


def test_cells_are_the_published_stanzas():
  main = bench_torch.CELLS['main']
  assert {(l.backend, l.precision) for l in main} == {
      ('kernel', 'f32'), ('torch', 'f32'), ('kernel', 'bf16'),
      ('torch', 'bf16')}
  assert all(l.rows == 38_096 and l.members == 64 for l in main)
  assert bench_torch.make_estimator(main[0]).width == 512
  assert [l.width for l in bench_torch.CELLS['widths']] == [256, 768, 1024]
  sst = bench_torch.CELLS['sst'][0]
  est = bench_torch.make_estimator(sst)
  assert (sst.rows, sst.members, est.width) == (221_127, 16, 768)
  assert est.feature_cols == ['datetime', 'latitude', 'longitude', 'soi']
  vi = bench_torch.CELLS['vi'][0]
  assert (vi.members, vi.batch_size, vi.learning_rate) == (16, 3_500, 0.01)
  table = bench_torch.sst_table(3 * bench_torch.SST_LOCATIONS + 5, 0)
  assert table['datetime'].nunique() == 4
  counts = bench_torch.hourly_table(50, 0, counts=True)['pm10'].to_numpy()
  assert np.array_equal(counts, np.round(counts)) and (counts >= 0).all()


def test_refuses_without_cuda(capsys):
  assert bench_torch.main(['--cells', 'main']) == 1
  assert 'CUDA is not available' in capsys.readouterr().err
  with pytest.raises(SystemExit):
    bench_torch.main(['--cells', 'bogus'])
