"""The general generator of the benchmark's traffic. A traffic file names a
load ('fit' or 'predict') and its parameters; the configuration gives
the model, the table and the published inference stanzas. Everything a run
sends the program comes from the run's seed: the table (the configuration's
generator), the parameters and the generator from which the VI trainer
draws each step's noise and batch, all made here and handed to both the
program and the plain reference, which replays that generator.

What the loads call in the program (`bayesnf_torch`): the estimators'
constructor, `fit`, `predict`, `params_` and `_fit_inputs` (the inputs
`fit` hands its trainer); `inference.map.train` / `init_opt_state` and the
Adam state's `mu`; `inference.vi.train`, which draws each step from the
generator it is given one `randn((E, S) + shape)` a leaf in `param_specs`
order, then the batch `argsort(rand((E, N)))[:, :B]`;
`ops.fused_mlp.fused_train` and `fused_field_mlp_t` and their `launches`
counters.
"""

import math
import statistics
import time

import bayesnf_torch
from bayesnf_torch.inference import map as map_lib
from bayesnf_torch.inference import vi as vi_lib
from bayesnf_torch.models import likelihoods
from bayesnf_torch.ops import fused_mlp
import numpy as np
import torch

from benchmark import checks
from benchmark.spec import derive

CHECK_STEPS = 3  # Training steps the reference follows.
RAW_SCALE = math.log(math.expm1(0.3))  # A VI surrogate's starting raw scale.
SEED_BITS = 63


def sync(device):
  if torch.device(device).type == 'cuda':
    torch.cuda.synchronize(device)


def draw_leaves(shapes, lead, generator, log_noise):
  """Parameter leaves of `lead` members each, drawn from `generator` on its
  device in two calls: weight matrices from N(0, 1) clipped to [-2, 2],
  every other entry from U(-0.5, 0.5), plus `log_noise` on the noise
  scale's leaf (the first)."""
  count = math.prod(lead)
  sizes = [count * math.prod(shape) for shape, _, _ in shapes]
  matrix = [is_matrix for _, _, is_matrix in shapes]
  device = generator.device
  normal = torch.randn(sum(s for s, m in zip(sizes, matrix) if m),
                       generator=generator, device=device).clamp_(-2, 2)
  uniform = torch.rand(sum(s for s, m in zip(sizes, matrix) if not m),
                       generator=generator, device=device).sub_(0.5)
  leaves, at = [], {True: 0, False: 0}
  for (shape, _, is_matrix), size in zip(shapes, sizes):
    pool = normal if is_matrix else uniform
    leaves.append(pool[at[is_matrix]:at[is_matrix] + size].reshape(
        tuple(lead) + tuple(shape)))
    at[is_matrix] += size
  leaves[0] = leaves[0] + log_noise
  return leaves


def make_estimator(cfg, objective):
  data, model = cfg['data'], cfg['model']
  cls = (bayesnf_torch.BayesianNeuralFieldVI if objective == 'vi'
         else bayesnf_torch.BayesianNeuralFieldMAP)
  return cls(
      feature_cols=data['feature_cols'], target_col=data['target_col'],
      seasonality_periods=model['seasonality_periods'],
      num_seasonal_harmonics=model['num_seasonal_harmonics'],
      fourier_degrees=model.get('fourier_degrees'),
      interactions=model.get('interactions'), freq=data['freq'],
      timetype=data['timetype'], depth=model['depth'], width=model['width'],
      observation_model=model['observation_model'],
      standardize=data.get('standardize'))


class _Load:
  """What both loads share: the cell's inputs, its estimator and its
  one-epoch warm fit through the estimator, and the count of the program's
  kernel launches against what the work asks for."""

  ranges = ()
  entry = None  # The program's kernel entry the load drives (`fused_mlp`).
  launch_check = None  # Its name in the result's checks.

  def __init__(self, cfg, traffic, seed, device, backend, tables, reference):
    self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
    self.device, self.backend = torch.device(device), backend
    self.tables, self.reference = tables, reference
    reference.enable_fp32()
    self.objective = traffic['objective']
    self.stanza = cfg['inference'][self.objective]
    self.precision = cfg['precision']
    self.members = int(self.stanza['num_particles'])
    self.draws = int(self.stanza.get('sample_size_divergence', 1))
    self.attempted = self.failed = 0
    self.launch_gap = 0
    self.info = {}

  def launches(self):
    """The entry's launch counter (kept on the program's function)."""
    return getattr(fused_mlp, self.entry).launches

  def expected_launches(self, units):
    """The entry's launches that `units` steps or calls make: none off the
    'kernel' backend."""
    return units * self.launches_per_unit() if self.backend == 'kernel' else 0

  def count_launches(self, before, units):
    """Notes how far the launches since `before` missed `units`' count."""
    self.launch_gap = max(self.launch_gap, abs(
        self.launches() - before - self.expected_launches(units)))

  def _fit_estimator(self, table):
    est = make_estimator(self.cfg, self.objective)
    kwargs = dict(ensemble_size=self.members,
                  learning_rate=self.stanza['learning_rate'], num_epochs=1,
                  batch_size=self.stanza.get('batch_size'),
                  backend=self.backend, device=self.device,
                  precision=self.precision)
    if self.objective == 'vi':
      kwargs.update(sample_size_divergence=self.draws,
                    kl_weight=self.stanza['kl_weight'],
                    sample_size_posterior=self.cfg['posterior_draws'])
    est.fit(table, self.seed % (1 << SEED_BITS), **kwargs)
    return est

  def _generator(self, tag):
    return torch.Generator(device=self.device).manual_seed(
        derive(self.seed, tag))

  def _model(self, table):
    return self.reference.Model(self.cfg, table)

  @property
  def shapes(self):
    """The sizes the per-layer readers count work from."""
    m = self.ref_model
    return dict(num_inputs=m.num_inputs, num_seasonal=2 * len(m.freqs),
                groups=m.num_groups, f=m.encoded_dim, width=m.width,
                depth=m.depth, precision=self.precision)


class Fit(_Load):
  """Training: MAP full batch, or VI minibatches, driven through the
  trainer `fit` calls (`map.train` / `vi.train`) in chunks of steps, each
  ending in a synchronize, the state carried from chunk to chunk. Set-up
  runs the one-epoch warm fit, then the check's CHECK_STEPS steps from the
  benchmark's parameters through the same call (one step, then the rest),
  which the window then continues. K1 (`fused_mlp.fused_train`) runs once
  a step."""

  ranges = ('bench.k1',)
  entry = 'fused_train'
  launch_check = 'k1_launch_gap'

  def launches_per_unit(self):
    return 1

  def setup(self):
    rows = self.cfg['table']['rows']
    self.table = self.tables.make(rows, self.seed)
    self.ref_model = self._model(self.table)
    est = self._fit_estimator(self.table)
    batch = self.stanza.get('batch_size')
    config, aug, target, batch, _ = est._fit_inputs(
        self.table, batch, 1, self.device, None)
    del est
    self.config, self.n, self.batch = config, len(target), batch
    if self.objective == 'map' and batch != self.n:
      raise ValueError('The fit load runs MAP on the full batch only.')
    self.aug_t = torch.as_tensor(aug, dtype=torch.float32,
                                 device=self.device).T.contiguous()
    self.y = torch.tensor(np.asarray(target), dtype=torch.float32,
                          device=self.device)
    self.distribution = likelihoods.LikelihoodDist(
        self.cfg['model']['observation_model'])
    log_noise = float(np.log(np.nanstd(np.asarray(target)) / 2))
    shapes = self.ref_model.leaf_shapes()
    start = draw_leaves(shapes, (self.members,), self._generator(1),
                        log_noise)
    if self.objective == 'vi':
      # Raw scales RAW_SCALE + U(-0.05, 0.05): the uniform leaves' draw.
      raws = draw_leaves([(s, 0.0, False) for s, _, _ in shapes],
                         (self.members,), self._generator(4), 0.0)
      start = start + [RAW_SCALE + 0.1 * t for t in raws]
      self.step_generator = self._generator(3)
    self.start = [t.detach().cpu() for t in start]
    self.state = map_lib.init_opt_state(tuple(start))
    self.params = tuple(start)
    first = self._step(1)
    sync(self.device)
    # Adam's first moment after one step is (1 - b1) g.
    grad = [m.detach().cpu() / (1 - self.reference.ADAM_B1)
            for m in self.state.mu]
    tic = time.perf_counter()
    rest = self._step(CHECK_STEPS - 1)
    sync(self.device)
    step_s = (time.perf_counter() - tic) / (CHECK_STEPS - 1)
    self.chunk = max(1, round(self.traffic['chunk_seconds'] / step_s))
    self.program = (torch.cat([first, rest], dim=1).cpu(), grad,
                    [t.detach().cpu() for t in self.params])

  def _step(self, steps):
    """`steps` steps of the program from the current state; the losses."""
    lr = self.stanza['learning_rate']
    if self.objective == 'map':
      self.params, self.state, losses = map_lib.train(
          self.params, self.state, self.aug_t, self.y, self.config,
          self.distribution, lr, steps, backend=self.backend,
          precision=self.precision)
      return losses
    num = len(self.params) // 2
    surrogate = (self.params[:num], self.params[num:])
    surrogate, self.state, losses = vi_lib.train(
        surrogate, self.state, self.aug_t, self.y, self.config,
        self.distribution, lr, steps, self.batch, self.draws,
        self.stanza['kl_weight'], self.step_generator, self.backend,
        self.precision)
    self.params = (*surrogate[0], *surrogate[1])
    return losses

  def window(self, seconds):
    """Chunks of steps until `seconds` have passed; the rate over all the
    steps and all the time."""
    losses, steps, ends = [], 0, []
    sync(self.device)
    before = self.launches()
    tic = time.perf_counter()
    while True:
      losses.append(self._step(self.chunk))
      sync(self.device)
      steps += self.chunk
      ends.append(time.perf_counter() - tic)
      elapsed = ends[-1]
      if elapsed >= seconds:
        break
    self.count_launches(before, steps)
    finite = torch.isfinite(torch.cat(losses, dim=1)).all(dim=0)
    self.attempted, self.failed = steps, int((~finite).sum())
    chunk_ms = [round((b - a) * 1e3, 1) for a, b in zip([0.0] + ends, ends)]
    self.info = dict(steps=steps, chunk_steps=self.chunk, window_s=elapsed,
                     chunk_ms=chunk_ms)
    return {'fit_member_steps_per_s': self.members * steps / elapsed}

  def stretch(self, profiled):
    """One chunk unprofiled, then `trace_steps` steps inside `profiled`."""
    self._step(self.chunk)
    sync(self.device)
    steps = self.traffic['trace_steps']
    before = self.launches()
    with profiled():
      losses = self._step(steps)
    self.count_launches(before, steps)
    finite = torch.isfinite(losses).all(dim=0)
    self.attempted += steps
    self.failed += int((~finite).sum())
    return steps

  @property
  def shapes(self):
    vi = self.objective == 'vi'
    return dict(super().shapes,
                kernel_members=self.members * (self.draws if vi else 1),
                rows=self.batch, data_groups=self.members if vi else None)

  def release(self):
    del self.params, self.state, self.aug_t, self.y
    if self.device.type == 'cuda':
      torch.cuda.empty_cache()

  def reference_readings(self, precision='f32', half_batch=False):
    """(losses, first gradient, parameters after CHECK_STEPS) of the plain
    reference from the same table and parameters; VI replays the step
    generator as `vi.train` draws from it: each step one standard normal
    (E, S, ...) a leaf in `param_specs` order, then the batch's
    permutation."""
    ref, m = self.reference, self.ref_model
    x, seasonal = m.inputs(self.table, self.device)
    y = m.target(self.table, self.device)
    start = [t.to(self.device) for t in self.start]
    lr = self.stanza['learning_rate']
    if self.objective == 'map':
      out = ref.map_steps(m, start, x, seasonal, y, lr, CHECK_STEPS,
                          precision, half_batch)
    else:
      gen = self._generator(3)
      noises, batches = [], []
      for _ in range(CHECK_STEPS):
        noises.append([torch.randn((self.members, self.draws) + tuple(shape),
                                   generator=gen, device=self.device)
                       for shape, _, _ in m.leaf_shapes()])
        batches.append(torch.argsort(torch.rand(
            (self.members, self.n), generator=gen, device=self.device),
                                     dim=1)[:, :self.batch])
      num = len(start) // 2
      losses, (g_loc, g_raw), (locs, raws) = ref.vi_steps(
          m, start[:num], start[num:], x, seasonal, y, lr, batches, noises,
          self.batch, self.stanza['kl_weight'], precision, half_batch)
      out = losses, [*g_loc, *g_raw], [*locs, *raws]
    losses, grad, end = out
    return (losses.cpu(), [g.detach().cpu() for g in grad],
            [t.detach().cpu() for t in end])

  def numbers(self, readings):
    return checks.fit_numbers(readings, self.reference_readings(),
                              self.start)

  def check(self):
    return self.numbers(self.program)


class Predict(_Load):
  """Serving: `predict(grid, quantiles)` over grids of the table's shape,
  back to back, one client. Set-up runs the one-epoch warm fit of the
  objective's stanza, puts the benchmark's parameters in place of its
  `params_` (the public layout: (1, S, E) members for VI, (1, E) for MAP),
  makes the grids and runs one warm call. The grids, `grids` of them drawn
  from the seed, take turns, so that no call repeats the one before it.
  K2 (`fused_mlp.fused_field_mlp_t`) runs once a `k2_chunk_rows` chunk of
  a grid."""

  ranges = ('bench.k2',)
  entry = 'fused_field_mlp_t'
  launch_check = 'k2_launch_gap'

  def launches_per_unit(self):
    return -(-len(self.grids[0]) // self.traffic['k2_chunk_rows'])

  def setup(self):
    rows = self.cfg['table']['rows']
    self.table = self.tables.make(rows, self.seed)
    self.ref_model = self._model(self.table)
    self.est = self._fit_estimator(self.table)
    lead = ((1, self.cfg['posterior_draws'], self.members)
            if self.objective == 'vi' else (1, self.members))
    target = self.table[self.cfg['data']['target_col']].to_numpy()
    log_noise = float(np.log(np.nanstd(target) / 2))
    params = draw_leaves(self.ref_model.leaf_shapes(), lead,
                         self._generator(1), log_noise)
    self.est.params_ = tuple(params)
    self.start = [t.reshape((-1,) + t.shape[len(lead):]).cpu()
                  for t in params]
    self.grids = [self.tables.make(rows, derive(self.seed, 100 + g))
                  for g in range(self.traffic['grids'])]
    self.quantiles = tuple(self.traffic['quantiles'])
    self.kept = {}
    self.call(0)
    sync(self.device)

  def call(self, g):
    means, quantiles = self.est.predict(self.grids[g],
                                        quantiles=self.quantiles,
                                        backend=self.backend)
    quantiles = torch.stack(quantiles)
    ok = bool(torch.isfinite(means).all() & torch.isfinite(quantiles).all())
    self.kept[g] = (means, quantiles)
    return ok

  def window(self, seconds):
    """Calls until `seconds` have passed; the rows returned over all the
    calls and all the time."""
    calls = rows = 0
    latencies = []
    sync(self.device)
    before = self.launches()
    tic = time.perf_counter()
    while True:
      start = time.perf_counter()
      g = calls % len(self.grids)
      ok = self.call(g)
      sync(self.device)
      latencies.append(time.perf_counter() - start)
      calls += 1
      self.failed += not ok
      rows += len(self.grids[g])
      elapsed = time.perf_counter() - tic
      if elapsed >= seconds:
        break
    self.count_launches(before, calls)
    self.attempted = calls
    lat = sorted(latencies)
    self.info = dict(calls=calls, window_s=elapsed,
                     latency_p50_ms=statistics.median(lat) * 1e3,
                     latency_p90_ms=lat[min(len(lat) - 1,
                                            int(0.9 * len(lat)))] * 1e3,
                     latencies_ms=[round(t * 1e3, 1) for t in latencies])
    return {'predict_rows_per_s': rows / elapsed}

  def stretch(self, profiled):
    """One call unprofiled, then `trace_calls` calls inside `profiled`."""
    self.call(0)
    sync(self.device)
    calls = self.traffic['trace_calls']
    before = self.launches()
    with profiled():
      oks = [self.call(i % len(self.grids)) for i in range(calls)]
    self.count_launches(before, calls)
    self.attempted += calls
    self.failed += oks.count(False)
    return calls

  @property
  def shapes(self):
    return dict(super().shapes, members=self.start[0].shape[0],
                rows=len(self.grids[0]))

  def release(self):
    self.kept = {g: tuple(t.cpu() for t in out)
                 for g, out in self.kept.items()}
    del self.est
    if self.device.type == 'cuda':
      torch.cuda.empty_cache()

  def reference_outputs(self, g, precision='f32', members=None):
    """(means (K, n), quantiles (Q, n)) of grid g by the plain reference
    (a control's or a planted fault's outputs): the products at
    `precision`, the quantiles' CDF in bfloat16 when that is not 'f32', the
    quantiles over the first `members` members (default all)."""
    ref, m = self.reference, self.ref_model
    x, seasonal = m.inputs(self.grids[g], self.device)
    params = [t.to(self.device) for t in self.start]
    dtype = torch.float32 if precision == 'f32' else torch.bfloat16
    with torch.no_grad():
      means = ref.predict_means(m, params, x, seasonal, precision)
      q = ref.mixture_quantiles(means[:members],
                                ref.noise_scale(params)[:members],
                                self.quantiles, dtype)
    return means.cpu(), q.cpu()

  def numbers(self, outputs):
    """The worst numbers over the grids of `outputs` ({g: (means (K, n),
    quantiles (Q, n))})."""
    ref, m = self.reference, self.ref_model
    params = [t.to(self.device) for t in self.start]
    scales = ref.noise_scale(params)
    found = []
    for g, (means, q) in outputs.items():
      x, seasonal = m.inputs(self.grids[g], self.device)
      with torch.no_grad():
        r_means = ref.predict_means(m, params, x, seasonal)
      found.append(checks.predict_numbers(
          means.reshape(r_means.shape).to(self.device), q.to(self.device),
          r_means, lambda v, r=r_means: ref.mixture_cdf(v, r, scales),
          self.quantiles))
    return checks.worst(found)

  def check(self):
    return self.numbers(self.kept)


LOADS = {'fit': Fit, 'predict': Predict}


def make(cfg, traffic, seed, device, backend, tables, reference):
  return LOADS[traffic['kind']](cfg, traffic, seed, device, backend, tables,
                                reference)
