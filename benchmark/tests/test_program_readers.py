"""The readers of the program's spans and counters on synthetic tables:
each divides by the table's own count of its outer span (or reads the
counters' ratio), reads nothing from an empty table, from a program
without the table, or from a run whose stretches ran nothing on the
device, and is listed in its named cells only."""

import pytest

from bayesnf_torch.utils import profiling

from benchmark import spec
from benchmark import tracing

PREDICT = ('handler_host_ms.predict', 'forward_host_ms.predict',
           'rootfind_host_ms.predict', 'rootfind_useful_pct.predict')
FIT = ('trainer_host_ms.fit',)
FIT_CELLS = ('air_quality.map_fit', 'sst.map_fit', 'air_quality.vi_fit')


def _reading(busy_s=1.0):
  summary = tracing.Summary(window_s=2.0, busy_s=busy_s, device_s=busy_s,
                            range_device_s={}, range_calls={}, device_ops=[],
                            idle_gaps=[])
  return tracing.Reading(summary=summary, units=3, busy_s=busy_s, span_s=2.0,
                         window_units=80, window_s=50.0)


def _table(**rows):
  return {name.replace('_', '.'): profiling.SpanStats(calls, host_s, host_s)
          for name, (calls, host_s) in rows.items()}


TABLE = _table(bnf_predict=(6, 4.2), bnf_predict_handler=(6, 0.6),
               bnf_predict_forward=(6, 0.12), bnf_predict_quantile=(18, 1.5),
               bnf_fit_step=(40, 1.0), bnf_k1=(40, 0.2))
COUNTERS = {'bnf.rootfind.iterations_run': 1080,
            'bnf.rootfind.iterations_needed': 270}
EXPECTED = {'handler_host_ms.predict': 100.0,
            'forward_host_ms.predict': 20.0,
            'rootfind_host_ms.predict': 250.0,
            'rootfind_useful_pct.predict': 25.0,
            'trainer_host_ms.fit': 20.0}


@pytest.mark.parametrize('metric', PREDICT + FIT)
def test_a_reader_divides_by_its_outer_count(monkeypatch, metric):
  monkeypatch.setattr(profiling, 'span_table', lambda: TABLE)
  monkeypatch.setattr(profiling, 'counters', lambda: COUNTERS)
  read = spec.Bench().reader(metric).read
  assert read(_reading(), {}) == pytest.approx(EXPECTED[metric])
  assert read(_reading(busy_s=0.0), {}) is None


@pytest.mark.parametrize('metric', PREDICT + FIT)
def test_a_reader_reads_nothing_from_an_empty_table(monkeypatch, metric):
  monkeypatch.setattr(profiling, 'span_table', dict)
  monkeypatch.setattr(profiling, 'counters', dict)
  assert spec.Bench().reader(metric).read(_reading(), {}) is None
  monkeypatch.delattr(profiling, 'span_table')
  monkeypatch.delattr(profiling, 'counters')
  assert spec.Bench().reader(metric).read(_reading(), {}) is None


@pytest.mark.parametrize('cell', ('air_quality.vi_predict',) + FIT_CELLS)
def test_each_metric_is_listed_in_its_named_cells_only(cell):
  names = {m['name'] for m in spec.Bench().per_layer(cell)}
  wanted = PREDICT if cell == 'air_quality.vi_predict' else FIT
  assert set(PREDICT + FIT) & names == set(wanted)
