"""The port's CUDA kernel and CUDA serving path, on a card.

Every test here is marked `gpu` and skips without a CUDA device. The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py -q

(`--noconftest` skips `tests/conftest.py`, which needs JAX.)
"""

import pathlib

import numpy as np
import pandas as pd
import pytest
import torch

import bayesnf_torch
from bayesnf_torch.ops import fused_mlp

DATA = pathlib.Path(__file__).resolve().parent / 'test_data'
# fp32 sums over fan-in <= 1024 taken in another order than torch.matmul.
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(name='cuda')
def _cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device('cuda')


def _inputs(depth, groups, n, width, members, device, seed=0):
  rng = np.random.default_rng(seed)
  fan_ins = [sum(groups)] + [width] * depth
  fan_outs = [width] * depth + [1]

  def put(a):
    return torch.as_tensor(a.astype(np.float32), device=device)

  return dict(
      h0_groups=[put(rng.uniform(-1, 1, (members, g, n))) for g in groups],
      weights=[put(np.clip(rng.normal(size=(members, fi, fo)), -2, 2))
               for fi, fo in zip(fan_ins, fan_outs)],
      biases=[put(rng.normal(scale=0.3, size=(members, fo)))
              for fo in fan_outs],
      scales_raw=put(rng.normal(scale=0.5, size=(members, depth + 1))),
      logit=put(rng.normal(size=(members,))),
  )


@pytest.mark.gpu
@pytest.mark.parametrize('depth,width,n', [
    (2, 64, 333), (1, 256, 70), (3, 32, 65), (0, 1, 40), (2, 1024, 17),
])
def test_kernel_matches_plain(cuda, depth, width, n):
  args = _inputs(depth, (3, 10, 6), n, width, members=3, device=cuda)
  before = fused_mlp.fused_field_mlp_t.launches
  got = fused_mlp.fused_field_mlp_t(depth, **args)
  torch.cuda.synchronize()
  assert fused_mlp.fused_field_mlp_t.launches == before + 1
  want = fused_mlp.fused_field_mlp_t_reference(depth, **args)
  torch.testing.assert_close(got, want, **KERNEL_TOL)


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take(cuda):
  args = _inputs(1, (5,), 8, 4096, members=2, device=cuda)
  with pytest.raises(ValueError, match='shared memory'):
    fused_mlp.fused_field_mlp_t(1, **args)
  args = _inputs(1, (5,), 8, 16, members=2, device=cuda)
  args['logit'] = args['logit'].cpu()
  with pytest.raises(ValueError, match='must be on'):
    fused_mlp.fused_field_mlp_t(1, **args)


@pytest.mark.gpu
def test_served_predict_on_cuda_matches_torch_backend(cuda):
  model = bayesnf_torch.BayesianNeuralFieldMAP.load(
      str(DATA / 'bnf-map.chickenpox.8.port.npz'), device=cuda)
  table = pd.read_csv(DATA / 'chickenpox.8.train.csv', index_col=0,
                      parse_dates=['datetime'])
  before = fused_mlp.fused_field_mlp_t.launches
  means, quantiles = model.predict(table, quantiles=(0.5, 0.975))
  assert fused_mlp.fused_field_mlp_t.launches == before + 1
  t_means, t_quantiles = model.predict(table, quantiles=(0.5, 0.975),
                                       backend='torch')
  assert means.device.type == 'cuda'
  torch.testing.assert_close(means, t_means, **KERNEL_TOL)
  noise = 0.01 + torch.exp(model.params_[0]).max().item()
  for got, want in zip(quantiles, t_quantiles):
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-3 * noise)
