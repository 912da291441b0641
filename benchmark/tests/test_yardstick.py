"""The frozen yardstick: the peaks and the kernels' bounds, pinned to the
values of the port's kernel table (K1 13.51 ms at 64 members x 8,192
rows, K2 2.25 ms at 64 x 4,096, width 512, depth 2, F = 49)."""

import pytest

from benchmark import roofline

F, WIDTH, DEPTH = 49, 512, 2


def test_peaks_are_the_h100_sxm_data_sheet():
  assert roofline.PEAK_FP32_FLOPS == 67e12
  assert roofline.PEAK_BF16_FLOPS == 989e12
  assert roofline.PEAK_BYTES_PER_S == 3.35e12


def test_k1_bound_at_the_kernel_tables_shape():
  args = roofline.k1_args(64, 8192, 3, 16, 5, F, WIDTH, DEPTH)
  ms, kind = roofline.k1_bound(args)
  assert kind == 'operations'
  assert ms == pytest.approx(13.51, abs=0.005)
  assert roofline.k1_bound(args, 'bf16')[0] == pytest.approx(0.92, abs=0.005)


def test_k2_bound_at_the_kernel_tables_shape():
  ms, kind = roofline.field_mlp_bound(
      roofline.k2_args(64, 4096, F, WIDTH, DEPTH), DEPTH)
  assert kind == 'operations'
  assert ms == pytest.approx(2.25, abs=0.005)


def test_grouped_k1_bound_reads_its_inputs_once_per_group():
  shared = roofline.k1_bound(roofline.k1_args(80, 3500, 3, 16, 5, F, WIDTH,
                                              DEPTH))
  grouped = roofline.k1_bound(roofline.k1_args(80, 3500, 3, 16, 5, F, WIDTH,
                                               DEPTH, data_groups=16))
  assert grouped[0] == pytest.approx(7.22, abs=0.005)
  assert grouped == shared  # Operations bound both: the bytes do not show.


def test_mlp_flops_per_row():
  assert roofline.mlp_flops_per_row(F, WIDTH, DEPTH) == 2 * (
      F * WIDTH + WIDTH * WIDTH + WIDTH)
  assert roofline.mlp_flops_per_row(F, WIDTH, 0) == 2 * F
