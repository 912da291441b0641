"""The predict cells `wind.vi_predict` and `air_quality.map_predict`: their
files, the readers of the encode span and of K2's row chunks on synthetic
tables (each reads nothing from a program without the span or counter, as
before they existed), and the metrics each cell lists."""

import pytest

from bayesnf_torch.utils import profiling

from benchmark import spec
from benchmark import tracing

CELLS = ('wind.vi_predict', 'air_quality.map_predict')
NEW = ('encode_host_ms.predict', 'k2_rows_per_chunk.predict')
SHARED = ('k2_roofline_pct', 'mfu_pct.predict', 'other_device_ms.predict',
          'device_idle_pct.predict', 'handler_host_ms.predict',
          'forward_host_ms.predict', 'rootfind_host_ms.predict')


def _reading(busy_s=1.0):
  summary = tracing.Summary(window_s=2.0, busy_s=busy_s, device_s=busy_s,
                            range_device_s={}, range_calls={}, device_ops=[],
                            idle_gaps=[])
  return tracing.Reading(summary=summary, units=3, busy_s=busy_s, span_s=2.0,
                         window_units=17, window_s=51.0)


TABLE = {'bnf.predict': profiling.SpanStats(6, 18.0, 0.1),
         'bnf.predict.forward': profiling.SpanStats(6, 15.6, 0.2),
         'bnf.predict.encode': profiling.SpanStats(120, 15.3, 15.3)}
# Six wind calls: 78,888 rows padded to 20 forward chunks of 4,096, each
# K2 call in 32 row chunks of 128.
COUNTERS = {'bnf.k2.row_chunks': 6 * 20 * 32}
SHAPES = {'rows': 78_888}


@pytest.mark.parametrize('metric, want', [('encode_host_ms.predict', 2550.0),
                                          ('k2_rows_per_chunk.predict',
                                           128.0)])
def test_a_reader_reads_per_call(monkeypatch, metric, want):
  monkeypatch.setattr(profiling, 'span_table', lambda: TABLE)
  monkeypatch.setattr(profiling, 'counters', lambda: COUNTERS)
  read = spec.Bench().reader(metric).read
  assert read(_reading(), SHAPES) == pytest.approx(want)
  assert read(_reading(busy_s=0.0), SHAPES) is None


@pytest.mark.parametrize('metric', NEW)
def test_a_reader_reads_nothing_without_its_span_or_counter(monkeypatch,
                                                            metric):
  older = {k: v for k, v in TABLE.items() if k != 'bnf.predict.encode'}
  monkeypatch.setattr(profiling, 'span_table', lambda: older)
  monkeypatch.setattr(profiling, 'counters', dict)
  read = spec.Bench().reader(metric).read
  assert read(_reading(), SHAPES) is None
  monkeypatch.delattr(profiling, 'span_table')
  monkeypatch.delattr(profiling, 'counters')
  assert read(_reading(), SHAPES) is None


@pytest.mark.parametrize('cell', CELLS)
def test_each_cell_finds_its_files_and_lists_its_metrics(cell):
  bench = spec.Bench()
  w = bench.workload(cell)
  cfg = bench.config(w['config'])
  assert bench.traffic(w['traffic'])['kind'] == 'predict'
  assert bench.limits(cell)
  bench.table(cfg['table']['generator'])
  assert {m['name'] for m in bench.end_to_end(cell)} == {
      'predict_rows_per_s', 'setup_s'}
  assert {m['name'] for m in bench.per_layer(cell)} == set(NEW + SHARED)
