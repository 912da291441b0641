"""Distribution objects behind `likelihood_model` and the count quantiles
(counterpart of `bayesnf_tpu/models/distributions.py`).

Normal, NegativeBinomial (TFP's parametrization), ZeroInflatedNegativeBinomial
and Independent, with the moments, densities and CDFs the public API needs.
Parameters broadcast against the event arguments as in TFP. `sample` draws
from an explicit `torch.Generator`; its draws are not the JAX package's
(another generator), only their distribution is the same.
"""

import dataclasses

import torch

from bayesnf_torch.ops import special


def _batch_shape(*tensors) -> torch.Size:
  return torch.broadcast_shapes(*(torch.as_tensor(t).shape for t in tensors))


@dataclasses.dataclass(frozen=True)
class Normal:
  """Normal(loc, scale)."""

  loc: torch.Tensor
  scale: torch.Tensor

  def mean(self):
    return self.loc * torch.ones_like(self.scale * self.loc)

  def stddev(self):
    return self.scale * torch.ones_like(self.loc)

  def variance(self):
    return torch.square(self.stddev())

  def log_prob(self, x):
    return special.normal_log_prob(x, self.loc, self.scale)

  def prob(self, x):
    return torch.exp(self.log_prob(x))

  def cdf(self, x):
    return special.normal_cdf(x, self.loc, self.scale)

  def quantile(self, q):
    return special.normal_quantile(q, self.loc, self.scale)

  def sample(self, generator: torch.Generator, sample_shape=()):
    shape = tuple(sample_shape) + tuple(_batch_shape(self.loc, self.scale))
    return self.loc + self.scale * torch.randn(
        shape, generator=generator, device=self.loc.device)


@dataclasses.dataclass(frozen=True)
class NegativeBinomial:
  """NegativeBinomial(total_count, logits), TFP's parametrization.

  log-pmf lgamma(r + x) - lgamma(1 + x) - lgamma(r) + r log_sigmoid(-logits)
  + x log_sigmoid(logits); mean r exp(logits); variance mean /
  sigmoid(-logits).
  """

  total_count: torch.Tensor
  logits: torch.Tensor

  def mean(self):
    return special.nb_mean(self.total_count, self.logits)

  def variance(self):
    return special.nb_variance(self.total_count, self.logits)

  def stddev(self):
    return torch.sqrt(self.variance())

  def log_prob(self, x):
    return special.nb_log_prob(x, self.total_count, self.logits)

  def prob(self, x):
    return torch.exp(self.log_prob(x))

  def cdf(self, x):
    return special.nb_cdf(x, self.total_count, self.logits)

  def sample(self, generator: torch.Generator, sample_shape=()):
    # Gamma-Poisson mixture: X ~ Poisson(Gamma(r, 1) * exp(logits)).
    shape = tuple(sample_shape) + tuple(
        _batch_shape(self.total_count, self.logits))
    rate = torch._standard_gamma(  # pylint: disable=protected-access
        torch.broadcast_to(self.total_count, shape).contiguous(),
        generator=generator) * torch.exp(self.logits)
    return torch.poisson(rate, generator=generator)


@dataclasses.dataclass(frozen=True)
class ZeroInflatedNegativeBinomial:
  """The mixture pi delta_0 + (1 - pi) NegativeBinomial(total_count,
  logits), pi = inflated_loc_probs."""

  total_count: torch.Tensor
  logits: torch.Tensor
  inflated_loc_probs: torch.Tensor

  @property
  def _nb(self):
    return NegativeBinomial(self.total_count, self.logits)

  def mean(self):
    return (1.0 - self.inflated_loc_probs) * self._nb.mean()

  def variance(self):
    nb = self._nb
    second_moment = (1.0 - self.inflated_loc_probs) * (
        nb.variance() + torch.square(nb.mean()))
    return second_moment - torch.square(self.mean())

  def stddev(self):
    return torch.sqrt(self.variance())

  def log_prob(self, x):
    x = torch.as_tensor(x, dtype=torch.float32, device=self.logits.device)
    pi = self.inflated_loc_probs
    nonzero_lp = torch.log1p(-pi) + self._nb.log_prob(x)
    zero_lp = torch.logaddexp(torch.log(pi), nonzero_lp)
    return torch.where(x == 0, zero_lp, nonzero_lp)

  def prob(self, x):
    return torch.exp(self.log_prob(x))

  def cdf(self, x):
    x = torch.as_tensor(x, dtype=torch.float32, device=self.logits.device)
    step = torch.where(x >= 0, 1.0, 0.0)
    pi = self.inflated_loc_probs
    return pi * step + (1.0 - pi) * self._nb.cdf(x)

  def sample(self, generator: torch.Generator, sample_shape=()):
    # The batch shape includes pi (as in TFP), and the NB parameters are
    # widened to it BEFORE drawing, so every batch element gets a draw of
    # its own (broadcasting a draw afterwards would repeat it).
    batch = tuple(_batch_shape(self.total_count, self.logits,
                               self.inflated_loc_probs))
    nb_wide = NegativeBinomial(torch.broadcast_to(self.total_count, batch),
                               torch.broadcast_to(self.logits, batch))
    nb_draw = nb_wide.sample(generator, sample_shape)
    inflate = torch.bernoulli(
        torch.broadcast_to(self.inflated_loc_probs,
                           tuple(sample_shape) + batch).contiguous(),
        generator=generator)
    return torch.where(inflate.bool(), 0.0, nb_draw)


def count_obs_dist(total_count, logits, inflated_loc_probs=None):
  """The count observation distribution from flat forecast parameters.

  The one construction that predict and `likelihood_model` share: the
  per-member scalar `total_count` broadcasts over the per-row `logits`
  through a trailing axis.
  """
  tc = total_count[..., None]
  if inflated_loc_probs is None:
    return NegativeBinomial(total_count=tc, logits=logits)
  return ZeroInflatedNegativeBinomial(
      total_count=tc, logits=logits, inflated_loc_probs=inflated_loc_probs)


@dataclasses.dataclass(frozen=True)
class Independent:
  """Reinterprets the rightmost `reinterpreted_batch_ndims` batch dims as
  event dims: log-probs sum, and CDFs multiply, over them; moments and
  draws come from the base distribution."""

  distribution: object
  reinterpreted_batch_ndims: int = 1

  def _event_axes(self):
    return tuple(range(-self.reinterpreted_batch_ndims, 0))

  def log_prob(self, x):
    return torch.sum(self.distribution.log_prob(x), dim=self._event_axes())

  def mean(self):
    return self.distribution.mean()

  def stddev(self):
    return self.distribution.stddev()

  def variance(self):
    return self.distribution.variance()

  def cdf(self, x):
    cdf = self.distribution.cdf(x)
    for axis in self._event_axes():
      cdf = torch.prod(cdf, dim=axis)
    return cdf

  def prob(self, x):
    return torch.exp(self.log_prob(x))

  def sample(self, generator: torch.Generator, sample_shape=()):
    return self.distribution.sample(generator, sample_shape)
