"""Checks that need an NVIDIA GPU (``gpu`` marker): they skip elsewhere, and
``python chip_smoke.py`` runs them on the card. The same check functions
run on the CPU at a small size in tests/test_chip_smoke.py."""

import numpy as np
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_postprocess_gt_probs_gpu_labels_match_cpu():
    got, cpu, n_gt = chip_smoke.postprocess_vs_cpu(512)
    np.testing.assert_array_equal(got, cpu)
    assert len(np.unique(got[got > 0])) == n_gt


def test_relabel_matmul_and_scatter_bit_identical_on_gpu():
    (mm, n_mm), (sc, n_sc) = chip_smoke.relabel_pair(512)
    np.testing.assert_array_equal(np.asarray(mm), np.asarray(sc))
    assert int(n_mm) == int(n_sc) > 0
