"""The harness on the CPU: every name in BENCHMARK.json finds its files, a
cell added as files and entries alone runs, the result line has the keys
the load reads, the readers' arithmetic on a synthetic trace, and the
command's refusal without a card. The one case that needs the card runs
the command there."""

import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark import spec
from benchmark import tracing

RESULT_KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


def test_every_name_in_benchmark_json_finds_its_files():
  bench = spec.Bench()
  for cell in bench.spec['workloads']:
    cfg = bench.config(cell['config'])
    assert cfg['name'] == cell['config']
    bench.table(cfg['table']['generator'])
    bench.reference(cfg['reference'])
    assert bench.traffic(cell['traffic'])['kind'] in ('fit', 'predict')
    assert bench.limits(cell['name'])
    assert any(m['name'] == 'setup_s' for m in bench.end_to_end(cell['name']))
    assert bench.per_layer(cell['name'])
  for metric in bench.spec['per_layer']:
    assert callable(bench.reader(metric['name']).read)


@pytest.mark.parametrize('cell', ['tiny.map_fit', 'tiny.vi_fit',
                                  'tiny.vi_predict'])
@pytest.mark.parametrize('trace', [0, 1])
def test_a_cell_added_by_files_runs_and_its_line_has_the_read_keys(
    tiny_bench, tmp_path, cell, trace):
  result, info = harness.run(tiny_bench, cell, 2**31 + 11, 0.2, trace,
                             time.monotonic(), device='cpu', backend='torch',
                             out_dir=str(tmp_path / 'out'))
  assert list(result)[:5] == RESULT_KEYS
  assert list(result)[-1] == 'checks'
  assert result['correct'], result['checks']
  assert result['attempted'] > 0 and result['failed'] == 0
  names = {m['name'] for m in (tiny_bench.per_layer(cell) if trace
                               else tiny_bench.end_to_end(cell))}
  # On the CPU nothing runs on a device, so the device readers find nothing.
  assert set(result['metrics']) == (set() if trace else names)
  for row in result['checks'].values():
    assert set(row) == {'value', 'limit'} and row['value'] <= row['limit']
  if trace:
    assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
    assert result['device']['window_s'] > 0
  assert info['setup_s'] > 0
  json.dumps(result)


def _event(cat, name, ts, dur, **args):
  return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
          'tid': 1, 'args': args}


def synthetic_trace():
  """A 1,000 us span: two K1 calls (kernels 300 + 100 us, launched inside
  `bench.k1`), one other kernel of 100 us, a memcpy of 50 us overlapping
  the first kernel, and a kernel outside the span."""
  return {'traceEvents': [
      _event('user_annotation', tracing.SPAN, 0, 1000),
      _event('user_annotation', 'bench.k1', 10, 20),
      _event('cuda_runtime', 'cudaLaunchKernel', 15, 2, correlation=1),
      _event('kernel', 'gemm', 100, 300, correlation=1),
      _event('gpu_memcpy', 'Memcpy HtoD', 150, 50, correlation=4),
      _event('cuda_runtime', 'cudaMemcpyAsync', 40, 2, correlation=4),
      _event('user_annotation', 'bench.k1', 500, 20),
      _event('cpu_op', 'aten::empty', 505, 5, **{'External id': 9}),
      _event('kernel', 'gemm', 600, 100, **{'External id': 9}),
      _event('cpu_op', 'aten::add', 700, 10),
      _event('cuda_runtime', 'cudaLaunchKernel', 705, 2, correlation=3),
      _event('kernel', 'add', 800, 100, correlation=3),
      _event('kernel', 'late', 2000, 100, correlation=8),
  ]}


def test_trace_reduction_on_a_synthetic_profile():
  s = tracing.summarize(synthetic_trace(), ('bench.k1',))
  assert s.window_s == pytest.approx(1e-3)
  assert s.busy_s == pytest.approx(500e-6)  # 300 + 100 + 100; memcpy inside
  assert s.device_s == pytest.approx(550e-6)
  assert s.range_device_s == {'bench.k1': pytest.approx(400e-6)}
  assert s.range_calls == {'bench.k1': 2}
  assert s.device_ops[0] == ['gemm', pytest.approx(400e-6)]
  assert s.idle_gaps == [[tracing.IDLE_HOST, pytest.approx(300e-6)],
                         ['bench.k1', pytest.approx(200e-6)]]


def test_device_only_trace_spans_its_first_to_last_cuda_event():
  trace = {'traceEvents': [
      e for e in synthetic_trace()['traceEvents']
      if e['cat'] in tracing.DEVICE_CATS + tracing.LAUNCH_CATS]}
  span_s, busy_s = tracing.busy_span(trace)
  # From the launch at 15 us to the end of the late kernel at 2,100 us.
  assert span_s == pytest.approx(2085e-6)
  assert busy_s == pytest.approx(600e-6)
  assert tracing.busy_span(synthetic_trace()) == (
      pytest.approx(1e-3), pytest.approx(500e-6))
  assert tracing.busy_span({'traceEvents': []}) == (0.0, 0.0)


def _reading(summary, units, busy_s, span_s, window_units, window_s):
  return tracing.Reading(summary=summary, units=units, busy_s=busy_s,
                         span_s=span_s, window_units=window_units,
                         window_s=window_s)


def test_readers_arithmetic_on_the_synthetic_profile():
  bench = spec.Bench()
  s = tracing.summarize(synthetic_trace(), ('bench.k1',))
  shapes = dict(kernel_members=16, rows=38096, num_inputs=3, num_seasonal=16,
                groups=5, f=49, width=512, depth=2, data_groups=None,
                precision='f32')
  flops = 3 * 16 * 38096 * 2 * (49 * 512 + 512 * 512 + 512)
  units = 2
  reading = _reading(s, units, busy_s=0.8, span_s=1.0, window_units=50,
                     window_s=2.5)
  read = {m: bench.reader(m).read(reading, shapes) for m in (
      'k1_roofline_pct', 'mfu_pct.fit', 'other_device_ms.fit',
      'device_idle_pct.fit')}
  assert read['k1_roofline_pct'] == pytest.approx(
      100 * flops / 67e12 / (400e-6 / units))
  assert read['mfu_pct.fit'] == pytest.approx(100 * flops * 50 / 2.5 / 67e12)
  assert read['other_device_ms.fit'] == pytest.approx(150e-3 / units)
  assert read['device_idle_pct.fit'] == pytest.approx(20.0)
  empty = tracing.summarize({'traceEvents': synthetic_trace()[
      'traceEvents'][:1]}, ('bench.k1',))
  nothing = _reading(empty, units, 0.0, 1e-3, 50, 2.5)
  assert all(bench.reader(m).read(nothing, shapes) is None for m in read)


def test_predict_readers_arithmetic():
  bench = spec.Bench()
  s = tracing.Summary(window_s=2.0, busy_s=1.5, device_s=1.6,
                      range_device_s={'bench.k2': 0.9}, range_calls={},
                      device_ops=[], idle_gaps=[])
  reading = _reading(s, 3, busy_s=1.5, span_s=2.0, window_units=80,
                     window_s=50.0)
  shapes = dict(members=480, rows=38096, f=49, width=512, depth=2,
                precision='f32')
  flops = 480 * 38096 * 2 * (49 * 512 + 512 * 512 + 512)
  assert bench.reader('k2_roofline_pct').read(
      reading, shapes) == pytest.approx(100 * flops / 67e12 / 0.3, rel=1e-3)
  assert bench.reader('mfu_pct.predict').read(
      reading, shapes) == pytest.approx(100 * flops * 80 / 50.0 / 67e12)
  assert bench.reader('other_device_ms.predict').read(
      reading, shapes) == pytest.approx(1e3 * 0.7 / 3)
  assert bench.reader('device_idle_pct.predict').read(
      reading, shapes) == pytest.approx(25.0)


def _command(cwd, env=None):
  return subprocess.run(
      [sys.executable, '-m', 'benchmark.run', '--workload',
       'air_quality.map_fit', '--seed', str(2**31 + 5), '--seconds', '1',
       '--trace', '0'], cwd=cwd, env=env, capture_output=True, text=True,
      timeout=600)


def test_the_command_fails_without_a_card():
  env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
  out = _command(spec.REPO, env)
  assert out.returncode != 0
  assert out.stdout.strip() == ''


def test_the_command_fails_without_the_program(tmp_path):
  import shutil
  shutil.copytree(spec.ROOT, tmp_path / 'benchmark')
  shutil.copy(spec.REPO / 'BENCHMARK.json', tmp_path)
  out = _command(tmp_path)
  assert out.returncode != 0
  assert out.stdout.strip() == ''


@pytest.mark.gpu
def test_the_command_on_the_card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card')
  out = _command(spec.REPO)
  assert out.returncode == 0, out.stderr[-2000:]
  result = json.loads(out.stdout.strip().splitlines()[-1])
  assert result['correct'], result['checks']
  assert result['device']['platform'] == 'gpu'
  rate = result['metrics']['fit_member_steps_per_s']['value']
  assert math.isfinite(rate) and rate > 0
