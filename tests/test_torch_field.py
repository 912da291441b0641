"""The port's field model against `bayesnf_tpu.models.field`.

The same numpy parameters go to both packages (the port receives them
through `params_from_numpy`); encode and forward must agree to rtol/atol
2e-5, the bound of the JAX package's own kernel-vs-oracle forward test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesnf_torch.models import features as t_features
from bayesnf_torch.models import field as t_field
from bayesnf_tpu.models import features as j_features
from bayesnf_tpu.models import field as j_field

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)

CONFIGS = {
    'seasonal+interactions': dict(
        width=16, depth=2, input_scales=[49.0, 1.0, 1.0],
        fourier_degrees=[3, 2, 0], interactions=[(0, 1), (1, 2)],
        seasonality_periods=[24.0, 168.0], num_seasonal_harmonics=[2, 3],
    ),
    'depth1-plain': dict(
        width=32, depth=1, input_scales=[20.0, 1.0],
        fourier_degrees=[2, 2], interactions=[],
        seasonality_periods=[], num_seasonal_harmonics=[],
    ),
    'depth3-duplicate-harmonics': dict(
        width=16, depth=3, input_scales=[30.0, 1.0, 1.0],
        fourier_degrees=[1, 1, 1], interactions=[(0, 2)],
        seasonality_periods=[12.0, 6.0], num_seasonal_harmonics=[4, 2],
    ),
}


def _configs(name):
  kwargs = CONFIGS[name]
  return j_field.FieldConfig.create(**kwargs), t_field.FieldConfig.create(
      **kwargs)


def _numpy_params(config, members, seed):
  rng = np.random.default_rng(seed)
  out = []
  for spec in j_field.param_specs(config):
    shape = (members,) + spec.shape
    if spec.is_matrix:
      out.append(np.clip(rng.normal(size=shape), -2, 2).astype(np.float32))
    else:
      out.append(rng.normal(scale=0.5, size=shape).astype(np.float32))
  return out


def _inputs(config, n, seed):
  rng = np.random.default_rng(seed)
  t = rng.uniform(0.0, 50.0, size=(n, 1))
  space = rng.normal(size=(n, config.num_inputs - 1))
  return np.concatenate([t, space], axis=1).astype(np.float32)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_param_specs_match(name):
  j_cfg, t_cfg = _configs(name)
  assert [(s.name, s.shape, s.prior_loc, s.is_matrix)
          for s in t_field.param_specs(t_cfg)] == [
              (s.name, s.shape, s.prior_loc, s.is_matrix)
              for s in j_field.param_specs(j_cfg)]
  assert t_cfg.encoded_dim == j_cfg.encoded_dim
  assert t_cfg.num_feature_groups == j_cfg.num_feature_groups
  assert t_cfg.seasonal_frequencies == j_cfg.seasonal_frequencies


def test_frequency_table_matches():
  periods, harmonics = np.array([12.0, 6.0, 7.0]), np.array([4, 2, 3])
  for a, b in zip(t_features.seasonal_frequency_table(periods, harmonics),
                  j_features.seasonal_frequency_table(periods, harmonics)):
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('degree', [1, 4])
def test_fourier_features_match(degree):
  x = np.random.default_rng(degree).normal(size=33).astype(np.float32)
  np.testing.assert_allclose(
      t_features.fourier_features(torch.from_numpy(x), degree).numpy(),
      np.asarray(j_features.fourier_features(jnp.asarray(x), degree)), **TOL)
  np.testing.assert_allclose(
      t_features.fourier_features_t(torch.from_numpy(x), degree).numpy(),
      np.asarray(j_features.fourier_features_t(jnp.asarray(x), degree)),
      **TOL)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_aug_features_matches(name):
  j_cfg, t_cfg = _configs(name)
  x = _inputs(j_cfg, 57, seed=1)
  np.testing.assert_allclose(
      t_field.aug_features(t_cfg, torch.from_numpy(x)).numpy(),
      np.asarray(j_field.aug_features(j_cfg, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_encode_t_groups_matches(name):
  j_cfg, t_cfg = _configs(name)
  arrays = _numpy_params(j_cfg, members=3, seed=2)
  x = _inputs(j_cfg, 41, seed=3)
  aug_t = np.asarray(j_field.aug_features(j_cfg, jnp.asarray(x))).T
  d = j_cfg.num_inputs
  want = jax.vmap(
      lambda p: tuple(j_field.encode_t_groups(
          j_cfg, p, jnp.asarray(aug_t[:d]), jnp.asarray(aug_t[d:])))
  )(tuple(jnp.asarray(a) for a in arrays))
  got = t_field.encode_t_groups(
      t_cfg, t_field.params_from_numpy(t_cfg, arrays, 1, 'cpu'),
      torch.from_numpy(aug_t[:d].copy()), torch.from_numpy(aug_t[d:].copy()))
  assert len(got) == len(want) == t_cfg.num_feature_groups
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_apply_field_t_matches(name):
  j_cfg, t_cfg = _configs(name)
  arrays = _numpy_params(j_cfg, members=2, seed=4)
  x = _inputs(j_cfg, 63, seed=5)
  aug_t = np.asarray(j_field.aug_features(j_cfg, jnp.asarray(x))).T
  d = j_cfg.num_inputs
  want = jax.vmap(
      lambda p: j_field.apply_field_t(
          j_cfg, p, jnp.asarray(aug_t[:d]), jnp.asarray(aug_t[d:]))
  )(tuple(jnp.asarray(a) for a in arrays))
  got = t_field.apply_field_t(
      t_cfg, t_field.params_from_numpy(t_cfg, arrays, 1, 'cpu'),
      torch.from_numpy(aug_t[:d].copy()), torch.from_numpy(aug_t[d:].copy()))
  assert got.shape == (2, 63)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_from_numpy_checks_shapes():
  _, t_cfg = _configs('depth1-plain')
  arrays = _numpy_params(t_cfg, members=2, seed=6)
  params = t_field.params_from_numpy(t_cfg, arrays, 1, 'cpu')
  assert all(p.dtype == torch.float32 for p in params)
  with pytest.raises(ValueError, match='parameter leaves'):
    t_field.params_from_numpy(t_cfg, arrays[:-1], 1, 'cpu')
  bad = list(arrays)
  bad[t_field.IDX_FIRST_DENSE] = bad[t_field.IDX_FIRST_DENSE][:, :-1]
  with pytest.raises(ValueError, match='kernel_0'):
    t_field.params_from_numpy(t_cfg, bad, 1, 'cpu')
  mixed = list(arrays)
  mixed[0] = np.zeros((3,), np.float32)
  with pytest.raises(ValueError, match='ensemble axes'):
    t_field.params_from_numpy(t_cfg, mixed, 1, 'cpu')


def test_init_params_shapes_and_draws():
  _, t_cfg = _configs('seasonal+interactions')
  draw = lambda seed: t_field.init_params(
      t_cfg, torch.Generator().manual_seed(seed), 'cpu',
      log_noise_scale_init=0.25)
  a, b, c = draw(0), draw(0), draw(1)
  specs = t_field.param_specs(t_cfg)
  for spec, pa, pb, pc in zip(specs, a, b, c):
    assert tuple(pa.shape) == spec.shape and pa.dtype == torch.float32
    assert torch.equal(pa, pb)
    if spec.is_matrix:
      assert pa.abs().max() <= 2.0 and not torch.equal(pa, pc)
      assert 0.5 < pa.std() < 1.2  # TruncatedNormal(0, 1, -2, 2): sd 0.88
    elif spec.name == 'log_noise_scale':
      assert pa.item() == 0.25
    else:
      assert not pa.any()


def test_blended_act_and_its_gradient_match_jax():
  rng = np.random.default_rng(7)
  z = rng.normal(scale=2.0, size=(3, 5, 11)).astype(np.float32)
  w = rng.uniform(size=(3, 1, 1)).astype(np.float32)
  ct = rng.normal(size=z.shape).astype(np.float32)

  def j_loss(z, w):
    return jnp.sum(j_field.blended_act(z, w) * ct)

  want_val = j_field.blended_act(jnp.asarray(z), jnp.asarray(w))
  want_dz, want_dw = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(z),
                                                      jnp.asarray(w))
  tz = torch.from_numpy(z).requires_grad_(True)
  tw = torch.from_numpy(w).requires_grad_(True)
  got = t_field.blended_act(tz, tw)
  dz, dw = torch.autograd.grad((got * torch.from_numpy(ct)).sum(), (tz, tw))
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_val),
                             **TOL)
  np.testing.assert_allclose(dz.numpy(), np.asarray(want_dz), **TOL)
  np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), **TOL)
  assert dw.shape == tw.shape


def _grouped_aug_t(config, groups, n, seed):
  """(G, D + 2F, N) inputs with seasonal rows: each group rows of its own."""
  return np.stack([
      np.asarray(j_field.aug_features(
          config, jnp.asarray(_inputs(config, n, seed + i)))).T
      for i in range(groups)])


@pytest.mark.parametrize('groups', [4, 2], ids=['per-member', 'grouped-rep2'])
@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_grouped_encode_and_forward_match_vmap(name, groups):
  # Member m reads group m // rep: the JAX functions vmapped over members,
  # each given its own group's rows.
  j_cfg, t_cfg = _configs(name)
  members = 4
  arrays = _numpy_params(j_cfg, members=members, seed=8)
  aug_t = _grouped_aug_t(j_cfg, groups, 29, seed=9)
  member_aug = jnp.asarray(aug_t[np.arange(members) // (members // groups)])
  d = j_cfg.num_inputs
  j_params = tuple(jnp.asarray(a) for a in arrays)
  want_groups = jax.vmap(lambda p, a: tuple(j_field.encode_t_groups(
      j_cfg, p, a[:d], a[d:])))(j_params, member_aug)
  want = jax.vmap(lambda p, a: j_field.apply_field_t(
      j_cfg, p, a[:d], a[d:]))(j_params, member_aug)
  t_params = t_field.params_from_numpy(t_cfg, arrays, 1, 'cpu')
  x_t = torch.from_numpy(aug_t[:, :d].copy())
  seasonal_t = torch.from_numpy(aug_t[:, d:].copy())
  got_groups = t_field.encode_t_groups(t_cfg, t_params, x_t, seasonal_t)
  assert len(got_groups) == len(want_groups)
  for g, w in zip(got_groups, want_groups):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
  got = t_field.apply_field_t(t_cfg, t_params, x_t, seasonal_t)
  assert got.shape == (members, 29)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_grouped_rejects_a_group_count_that_does_not_divide():
  x = torch.zeros((3, 2, 5))
  assert t_field.grouped(x, 6, 2).shape == (3, 1, 2, 5)
  assert t_field.grouped(x[0], 6, 2).shape == (1, 1, 2, 5)
  with pytest.raises(ValueError, match='divides the member count'):
    t_field.grouped(x, 4, 2)
  with pytest.raises(ValueError, match='divides the member count'):
    t_field.grouped(x[None], 6, 2)
