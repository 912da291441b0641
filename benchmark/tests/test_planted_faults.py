"""`correct` comes out false when the timed path is broken underneath, and
when the control (the plain reference one precision down) or bfloat16
takes the program's place; it comes out true for the program. Tiny cells
on the CPU through the program's 'torch' backend, the rest of a run as on
the card (the harness skips only the look for a card), judged by the
limits of the cells they stand for."""

import math
import time

import pytest
import torch

from benchmark import checks
from benchmark import loads
from benchmark import harness

SEED = 2**31 + 7


def _run(bench, cell, tmp_path):
  result, _ = harness.run(bench, cell, SEED, 0.2, 0, time.monotonic(),
                          device='cpu', backend='torch',
                          out_dir=str(tmp_path / 'out'))
  return result


def _unchanged_state(monkeypatch):
  from bayesnf_torch.inference import map as map_lib

  def adam_update(grads, state, learning_rate):
    del learning_rate
    return tuple(torch.zeros_like(g) for g in grads), state

  monkeypatch.setattr(map_lib, 'adam_update', adam_update)


def _half_batch(monkeypatch):
  from bayesnf_torch.inference import map as map_lib
  original = map_lib.make_nll_and_grads

  def make_nll_and_grads(config, distribution, lik_scale, backend,
                         precision='f32'):
    nll = original(config, distribution, 2 * lik_scale, backend, precision)

    def half(params, x_t, seasonal_t, y, n_valid=None, row_weights=None):
      b = y.shape[-1] // 2
      return nll(params, x_t[..., :b], seasonal_t[..., :b], y[..., :b],
                 n_valid, row_weights)

    return half

  monkeypatch.setattr(map_lib, 'make_nll_and_grads', make_nll_and_grads)


def _altered_answer(monkeypatch):
  from bayesnf_torch.ops import fused_mlp
  original = fused_mlp.fused_field_mlp_t_reference

  def forward(*args, **kwargs):
    out = original(*args, **kwargs).clone()
    out[:, 0] = out[:, 1]
    return out

  monkeypatch.setattr(fused_mlp, 'fused_field_mlp_t_reference', forward)


def _half_members(monkeypatch):
  from bayesnf_torch.inference import quantiles
  original = quantiles.member_mean

  def member_mean(x, axis):
    k = math.prod(x.shape[:len(axis)])
    flat = x.reshape((k,) + tuple(x.shape[len(axis):]))
    return original(flat[:k // 2], (0,))

  monkeypatch.setattr(quantiles, 'member_mean', member_mean)


def _extra_launch(monkeypatch):
  """The 'torch' path counts one kernel launch a step or call more than the
  work asks for (no launch is due off the 'kernel' backend)."""
  import bayesnf_torch
  from bayesnf_torch.inference import map as map_lib
  from bayesnf_torch.inference import vi as vi_lib
  from bayesnf_torch.ops import fused_mlp

  def counting(original, entry):
    def wrapped(*args, **kwargs):
      getattr(fused_mlp, entry).launches += 1
      return original(*args, **kwargs)
    return wrapped

  monkeypatch.setattr(map_lib, 'train', counting(map_lib.train, 'fused_train'))
  monkeypatch.setattr(vi_lib, 'train', counting(vi_lib.train, 'fused_train'))
  cls = bayesnf_torch.BayesianNeuralFieldVI
  monkeypatch.setattr(cls, 'predict',
                      counting(cls.predict, 'fused_field_mlp_t'))


@pytest.mark.parametrize('cell, fault', [
    ('tiny.map_fit', _unchanged_state), ('tiny.map_fit', _half_batch),
    ('tiny.vi_fit', _unchanged_state), ('tiny.vi_fit', _half_batch),
    ('tiny.vi_predict', _altered_answer), ('tiny.vi_predict', _half_members),
    ('tiny.map_fit', _extra_launch), ('tiny.vi_fit', _extra_launch),
    ('tiny.vi_predict', _extra_launch),
])
def test_a_planted_fault_is_not_correct(tiny_bench, tmp_path, monkeypatch,
                                        cell, fault):
  fault(monkeypatch)
  result = _run(tiny_bench, cell, tmp_path)
  assert not result['correct'], result['checks']


def _load(bench, cell):
  w = bench.workload(cell)
  cfg = bench.config(w['config'])
  load = loads.make(cfg, bench.traffic(w['traffic']), SEED, 'cpu', 'torch',
                    bench.table(cfg['table']['generator']),
                    bench.reference(cfg['reference']))
  load.setup()
  return load


def _outputs(load, precision):
  if isinstance(load, loads.Fit):
    return load.reference_readings(precision)
  return {g: load.reference_outputs(g, precision)
          for g in range(len(load.grids))}


@pytest.mark.parametrize('cell', ['tiny.map_fit', 'tiny.vi_fit',
                                  'tiny.vi_predict'])
def test_the_program_passes_and_the_controls_fail(tiny_bench, cell):
  load = _load(tiny_bench, cell)
  limits = tiny_bench.limits(cell)
  if isinstance(load, loads.Predict):
    for g in range(len(load.grids)):
      load.call(g)
    load.release()
    program = load.kept
  else:
    program = load.program
  ok, table = checks.judge(load.numbers(program), limits)
  assert ok, table
  for precision in ('tf32', 'bf16'):
    ok, table = checks.judge(load.numbers(_outputs(load, precision)),
                             limits)
    assert not ok, (precision, table)
