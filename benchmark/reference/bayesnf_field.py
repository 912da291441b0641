"""Plain reference of the Bayesian neural field (BayesNF, Saad et al. 2024)
with a NORMAL observation model: the table's features, the field, its MAP
and VI training steps with Adam, and the predictive means and mixture
quantiles.

Written from the model's description (the JAX package's `models/field.py`,
`models/features.py`, `models/likelihoods.py`, `models/priors.py`,
`inference/map.py` and `inference/vi.py` document the same equations). It
imports torch, numpy and pandas only: nothing of the program, and no JAX.
Every tensor is float32 unless said otherwise; the matrix products run in
true fp32 (TF32 off), or at the `precision` of a control run:

- 'f32': fp32 operands and sums;
- 'tf32': both operands of every product of the field MLP, forward and
  backward, rounded to TF32's 10-bit mantissa (as the tensor cores take
  them), products summed in fp32;
- 'bf16': the same with bfloat16 operands.

The mixture quantiles' search, which runs no product, evaluates its CDF in
float32, or in a control run in bfloat16 (`mixture_quantiles`' dtype).

Parameters are the flat tuple of `PARAM_ORDER` (the artifact order of the
BayesNF packages), each leaf with one leading member axis.

Departures from the exact mathematics, each as the model defines it in
float32: the seasonal angles (2 pi f) t are rounded to float32 before the
cosine (at t ~ 4e4 hours one ulp of the angle is ~1e-3 rad, which the
model's float32 definition carries); each Fourier octave after the first
comes from the previous one by the double-angle formulas.
"""

import math

import numpy as np
import torch

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
VI_SCALE_FLOOR = 1e-4
DEFAULT_FOURIER_DEGREE = 5
NOISE_FLOOR = 0.01  # NORMAL scale = NOISE_FLOOR + exp(log_noise_scale).
ROW_BLOCK = 8192
MEMBER_BLOCK = 64
BISECTIONS = 80

# Leaves 0-6 of the flat parameter tuple; the dense layers follow as
# (W_0, b_0, ..., W_out, b_out).
PARAM_ORDER = ('log_noise_scale', 'nb_shape_raw', 'zinb_logit',
               'log_scale_adjustment', 'feature_scales_raw',
               'activation_logit', 'layer_scales_raw')
FIRST_DENSE = len(PARAM_ORDER)


def enable_fp32():
  """Turns TF32 off for every fp32 product of this process."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.set_float32_matmul_precision('highest')


# --- The model's static description -------------------------------------


class Model:
  """Sizes and feature layout of one configuration (its 'model' and 'data'
  sections) and the train-time statistics of one training table."""

  def __init__(self, cfg, train_table):
    data, model = cfg['data'], cfg['model']
    self.feature_cols = list(data['feature_cols'])
    self.target_col = data['target_col']
    self.freq = data['freq']
    self.standardize = list(data.get('standardize') or [])
    self.width = int(model['width'])
    self.depth = int(model['depth'])
    degrees = model.get('fourier_degrees')
    self.fourier_degrees = ([DEFAULT_FOURIER_DEGREE] * len(self.feature_cols)
                            if degrees is None else [int(d) for d in degrees])
    self.interactions = [tuple(p) for p in model.get('interactions') or []]
    self.freqs, self.harmonics = seasonal_table(
        model['seasonality_periods'], model['num_seasonal_harmonics'])
    times = time_index(train_table[self.feature_cols[0]], self.freq)
    self.time_min = times.min()
    self.time_scale = float((times - self.time_min).max())
    cols = train_table[self.standardize].to_numpy(np.float64)
    self.mu = dict(zip(self.standardize, cols.mean(axis=0)))
    self.std = dict(zip(self.standardize, cols.std(axis=0)))

  @property
  def num_inputs(self):
    return len(self.feature_cols)

  @property
  def num_groups(self):
    return (1 + sum(d > 0 for d in self.fourier_degrees)
            + (len(self.freqs) > 0) + (len(self.interactions) > 0))

  @property
  def encoded_dim(self):
    return (self.num_inputs + 2 * sum(self.fourier_degrees)
            + 2 * len(self.freqs) + len(self.interactions))

  def leaf_shapes(self):
    """Per-member shape of every leaf, with its prior location and whether
    it is a weight matrix."""
    shapes = [((), 0.0, False), ((), -1.5, False), ((), 0.0, False),
              ((self.num_inputs,), 0.0, False),
              ((self.num_groups,), 0.0, False), ((), 0.0, False),
              ((self.depth + 1,), 0.0, False)]
    fan_in = self.encoded_dim
    for _ in range(self.depth):
      shapes += [((fan_in, self.width), 0.0, True), ((self.width,), 0.0, False)]
      fan_in = self.width
    return shapes + [((fan_in, 1), 0.0, True), ((1,), 0.0, False)]

  def inputs(self, table, device):
    """(x (N, D), seasonal (N, 2F)) float32 tensors of a table's rows."""
    cols = []
    for name in self.feature_cols:
      if name == self.feature_cols[0]:
        v = (time_index(table[name], self.freq) - self.time_min).astype(
            np.float64)
      else:
        v = table[name].to_numpy(np.float64)
        if name in self.mu:
          v = (v - self.mu[name]) / self.std[name]
      cols.append(v)
    x = torch.as_tensor(np.stack(cols, axis=1).astype(np.float32),
                        device=device)
    return x, self.seasonal(x[:, 0])

  def seasonal(self, t):
    """[cos | sin] of the float32 angles (2 pi f) t, over harmonic k."""
    if not len(self.freqs):
      return torch.zeros((t.shape[0], 0), device=t.device)
    f = torch.as_tensor(self.freqs, device=t.device)
    angles = (np.float32(2 * math.pi) * f)[None, :] * t[:, None]
    a64 = angles.double()
    k = torch.as_tensor(self.harmonics, device=t.device).double().repeat(2)
    return (torch.cat([torch.cos(a64), torch.sin(a64)], dim=1) / k).float()

  def target(self, table, device):
    return torch.as_tensor(table[self.target_col].to_numpy(np.float32),
                           device=device)


def time_index(col, freq):
  """Whole periods of `freq` since 1970 (hours, days or months)."""
  unit = {'h': 'h', 'H': 'h', 'D': 'D', 'M': 'M', 'MS': 'M'}[freq]
  return col.to_numpy().astype(f'datetime64[{unit}]').astype(np.int64)


def seasonal_table(periods, harmonics):
  """float32 frequencies k / p (k = 1..h per period p), each kept at its
  first occurrence, and their harmonic numbers k."""
  seen = {}
  for p, h in zip(np.asarray(periods, np.float32),
                  np.asarray(harmonics, np.float32)):
    for k in np.arange(1, h + 1, dtype=np.float32):
      seen.setdefault(float(np.float32(k / p)), float(k))
  return (np.asarray(list(seen), np.float32),
          np.asarray(list(seen.values()), np.float32))


# --- Products at a precision --------------------------------------------


def round_operand(t, precision):
  if precision == 'f32':
    return t
  if precision == 'bf16':
    return t.to(torch.bfloat16).float()
  if precision == 'tf32':
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
  raise ValueError(f'Unknown precision {precision!r}.')


class _Product(torch.autograd.Function):
  """a @ b with both operands of the product and of its two gradient
  products rounded to `precision`."""

  @staticmethod
  def forward(ctx, a, b, precision):
    ctx.save_for_backward(a, b)
    ctx.precision = precision
    return torch.matmul(round_operand(a, precision),
                        round_operand(b, precision))

  @staticmethod
  def backward(ctx, g):
    a, b = ctx.saved_tensors
    p = ctx.precision
    g = round_operand(g, p)
    da = torch.matmul(g, round_operand(b, p).transpose(-1, -2))
    db = torch.matmul(round_operand(a, p).transpose(-1, -2), g)
    return da, db, None


def product(a, b, precision):
  return _Product.apply(a, b, precision)


# --- The field ------------------------------------------------------------


def softplus(x):
  return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def fourier(x, degree):
  """(..., 2 degree) [cos 2 pi 2^k x | sin 2 pi 2^k x] / (k + 1)."""
  c, s = torch.cos(2 * math.pi * x), torch.sin(2 * math.pi * x)
  coss, sins = [c], [s]
  for _ in range(degree - 1):
    c, s = 2 * c * c - 1, 2 * s * c
    coss.append(c)
    sins.append(s)
  k = torch.arange(1, degree + 1, dtype=x.dtype, device=x.device).repeat(2)
  return torch.stack(coss + sins, dim=-1) / k


def encode(m, p, x, seasonal):
  """(E, n, F) encoded features of rows x (n, D), or (E, n, D) one row set
  per member, with their seasonal features."""
  e = p[0].shape[0]
  scales = torch.tensor([m.time_scale] + [1.0] * (m.num_inputs - 1),
                        device=x.device)
  sx = x / (scales * torch.exp(p[3]))[:, None, :]  # (E, n, D)
  gs = softplus(p[4])
  groups = [sx]
  groups += [fourier(sx[..., i], d) for i, d in enumerate(m.fourier_degrees)
             if d > 0]
  out = [g * gs[:, i, None, None] for i, g in enumerate(groups)]
  if len(m.freqs):
    s3 = seasonal if seasonal.ndim == 3 else seasonal.expand(e, -1, -1)
    out.append(s3 * gs[:, len(out), None, None])
  if m.interactions:
    out.append(torch.stack([sx[..., i] * sx[..., j] for i, j in
                            m.interactions], dim=-1)
               * gs[:, len(out), None, None])
  return torch.cat(out, dim=-1)


def forward(m, p, x, seasonal, precision='f32'):
  """(E, n) field values at rows x (see `encode`)."""
  h = encode(m, p, x, seasonal)
  s = softplus(p[6])
  w = torch.sigmoid(p[5])[:, None, None]
  for l in range(m.depth + 1):
    weight, bias = p[FIRST_DENSE + 2 * l], p[FIRST_DENSE + 2 * l + 1]
    z = product(h / math.sqrt(weight.shape[1]), weight, precision)
    z = s[:, l, None, None] * (z + bias[:, None, :])
    if l < m.depth:
      elu = torch.where(z > 0, z, torch.expm1(torch.clamp(z, max=0)))
      h = w * elu + (1 - w) * torch.tanh(z)
  return z[..., 0]


def noise_scale(p):
  return NOISE_FLOOR + torch.exp(p[0])


def normal_log_prob(x, loc, scale):
  return (-0.5 * ((x - loc) / scale) ** 2 - torch.log(scale)
          - 0.5 * math.log(2 * math.pi))


def nll(m, p, x, seasonal, y, precision):
  """(E,) -sum_rows log N(y | field, scale) of rows x (n, D) shared, or
  (E, n, D) per member with y (E, n)."""
  pred = forward(m, p, x, seasonal, precision)
  return -normal_log_prob(y, pred, noise_scale(p)[:, None]).sum(dim=1)


def log_prior(m, p):
  """(E,) log density of the elementwise Logistic(loc, 1) prior."""
  e = p[0].shape[0]
  total = 0
  for (_, loc, _), leaf in zip(m.leaf_shapes(), p):
    z = leaf - loc
    total = total + (-z - 2 * softplus(-z)).reshape(e, -1).sum(dim=1)
  return total


def adam(params, grads, state, lr):
  """One Adam step (b1 0.9, b2 0.999, eps 1e-8); state (t, mu, nu). The
  bias corrections 1 - b^t are taken in float32, as optax takes them for
  float32 parameters."""
  t, mu, nu = state
  t += 1
  mu = [ADAM_B1 * a + (1 - ADAM_B1) * g for a, g in zip(mu, grads)]
  nu = [ADAM_B2 * a + (1 - ADAM_B2) * g * g for a, g in zip(nu, grads)]
  c1, c2 = (float(np.float32(1) - np.float32(b) ** np.float32(t))
            for b in (ADAM_B1, ADAM_B2))
  new = [q - lr * (a / c1) / (torch.sqrt(b / c2) + ADAM_EPS)
         for q, a, b in zip(params, mu, nu)]
  return new, (t, mu, nu)


def _leaves(p):
  return [t.detach().clone().requires_grad_(True) for t in p]


def map_loss_and_grads(m, p, x, seasonal, y, lik_scale, precision,
                       rows=None):
  """(E,) lik_scale * NLL - log prior over the rows `rows` (default all),
  and its gradient, summed over blocks of ROW_BLOCK rows."""
  rows = torch.arange(y.shape[0], device=y.device) if rows is None else rows
  leaves = _leaves(p)
  loss = torch.zeros(p[0].shape[0], device=y.device)
  grads = [torch.zeros_like(t) for t in p]
  for lo in range(0, rows.shape[0], ROW_BLOCK):
    r = rows[lo:lo + ROW_BLOCK]
    with torch.enable_grad():
      part = lik_scale * nll(m, leaves, x[r], seasonal[r], y[r], precision)
      g = torch.autograd.grad(part.sum(), leaves, allow_unused=True,
                              materialize_grads=True)
    loss += part.detach()
    grads = [a + b for a, b in zip(grads, g)]
  with torch.enable_grad():
    prior = -log_prior(m, leaves)
    g = torch.autograd.grad(prior.sum(), leaves)
  return loss + prior.detach(), [a + b for a, b in zip(grads, g)]


def map_steps(m, p0, x, seasonal, y, lr, steps, precision='f32',
              half_batch=False):
  """`steps` full-batch MAP steps from p0: (losses (E, steps), the first
  step's gradient, the parameters after the last step). With `half_batch`
  the likelihood takes the first half of the rows, times two (a fault)."""
  n = y.shape[0]
  rows = torch.arange(n // 2 if half_batch else n, device=y.device)
  scale = n / rows.shape[0]
  p, state = list(p0), (0, [torch.zeros_like(t) for t in p0],
                        [torch.zeros_like(t) for t in p0])
  losses, first = [], None
  for _ in range(steps):
    loss, grads = map_loss_and_grads(m, p, x, seasonal, y, scale, precision,
                                     rows)
    first = grads if first is None else first
    losses.append(loss)
    p, state = adam(p, grads, state, lr)
  return torch.stack(losses, dim=1), first, p


def vi_steps(m, locs, raws, x, seasonal, y, lr, batches, noises, batch_size,
             kl_weight, precision='f32', half_batch=False):
  """VI steps of the mean-field surrogates (locs, raws): one step per entry
  of `batches` ((E, B) row indices per surrogate) and `noises` (leaves
  (E, S, ...)). Returns (losses (E, steps) times kl_weight, the first
  step's gradient of (locs, raws), (locs, raws) after the last step).
  With `half_batch` each batch keeps its first half of the rows, times two
  (a fault)."""
  n = y.shape[0]
  lik_scale = (n / batch_size) / kl_weight
  params = list(locs) + list(raws)
  num = len(locs)
  state = (0, [torch.zeros_like(t) for t in params],
           [torch.zeros_like(t) for t in params])
  losses, first = [], None
  for idx, eps in zip(batches, noises):
    if half_batch:
      idx = idx[:, :idx.shape[1] // 2]
    scale = lik_scale * batch_size / idx.shape[1]
    leaves = _leaves(params)
    with torch.enable_grad():
      loc, raw = leaves[:num], leaves[num:]
      sd = [VI_SCALE_FLOOR + softplus(r) for r in raw]
      z = [a[:, None] + b[:, None] * c for a, b, c in zip(loc, sd, eps)]
      e, s = z[0].shape[:2]
      flat = [t.reshape((e * s,) + t.shape[2:]) for t in z]
      log_q = sum(normal_log_prob(t, a[:, None], b[:, None]).reshape(e, s, -1)
                  .sum(dim=-1) for t, a, b in zip(z, loc, sd))
      rows = idx.repeat_interleave(s, dim=0)  # member e * s + j: batch e
      lik = scale * nll(m, flat, x[rows], seasonal[rows], y[rows], precision)
      target = log_prior(m, flat) - lik
      loss = (log_q - target.reshape(e, s)).mean(dim=1)
      grads = torch.autograd.grad(loss.sum(), leaves)
    first = grads if first is None else first
    losses.append(loss.detach() * kl_weight)
    params, state = adam(params, grads, state, lr)
  return (torch.stack(losses, dim=1), (first[:num], first[num:]),
          (params[:num], params[num:]))


# --- Prediction -----------------------------------------------------------


def predict_means(m, p, x, seasonal, precision='f32'):
  """(K, n) field values of K members, in blocks of members and rows."""
  out = torch.empty((p[0].shape[0], x.shape[0]), device=x.device)
  for lo in range(0, p[0].shape[0], MEMBER_BLOCK):
    part = [t[lo:lo + MEMBER_BLOCK] for t in p]
    for r in range(0, x.shape[0], ROW_BLOCK):
      rows = slice(r, r + ROW_BLOCK)
      out[lo:lo + MEMBER_BLOCK, rows] = forward(m, part, x[rows],
                                                seasonal[rows], precision)
  return out


def mixture_cdf(x, means, scales):
  """(n,) CDF at x (n,) of the equal mixture over k of Normal(means[k],
  scales[k]), in float64."""
  z = (x.double()[None, :] - means.double()) / scales.double()[:, None]
  return torch.special.ndtr(z).mean(dim=0)


def mixture_quantiles(means, scales, quantiles, dtype=torch.float32):
  """(Q, n) quantiles of the mixture of `mixture_cdf`, by bisection on
  [min mean - 10 max scale, max mean + 10 max scale], the CDF evaluated in
  `dtype` (float32; a control's bfloat16)."""
  mu, sd = means.to(dtype), scales.to(dtype)[:, None]
  out = []
  for q in quantiles:
    lo = means.amin(dim=0) - 10 * float(scales.max())
    hi = means.amax(dim=0) + 10 * float(scales.max())
    for _ in range(BISECTIONS):
      mid = 0.5 * (lo + hi)
      z = (mid.to(dtype)[None, :] - mu) / sd
      below = torch.special.ndtr(z.float()).to(dtype).mean(dim=0) < q
      lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    out.append(0.5 * (lo + hi))
  return torch.stack(out)
