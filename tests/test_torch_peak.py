"""Kernel K6's plain twin (line3d_tpu_torch.utils.peak) on the CPU.

bench.py's probe has no JAX function to hold K6 against at its own shape;
the twin is held against a numpy float32 chain of the same two roundings
(identical) and against the one-rounding chain the kernel computes (fmaf,
emulated in float64 and rounded once), within CHAIN_RTOL, the bound the
module derives from the chain's contraction."""
import numpy as np
import pytest
import torch

from line3d_tpu_torch.utils import peak


def _numpy_chains(x, steps, fused):
    a, b = np.float32(peak.A), np.float32(peak.B)
    v = x.astype(np.float32)
    for _ in range(steps):
        if fused:
            v = (v.astype(np.float64) * np.float64(a) + np.float64(b)) \
                .astype(np.float32)
        else:
            v = v * a + b
    acc = v[:, 0]
    for c in range(1, peak.CHAINS):
        acc = acc + v[:, c]
    return acc


@pytest.mark.parametrize("trips", [1, 8, 64])
def test_twin_chain_matches_numpy(trips):
    x = peak.chain_starts(256, seed=trips)
    before = peak.LAUNCHES
    got = peak.fma_chain(x, trips).numpy()
    assert peak.LAUNCHES == before
    steps = peak.UNROLL * trips
    np.testing.assert_array_equal(got, _numpy_chains(x.numpy(), steps,
                                                     fused=False))
    np.testing.assert_allclose(got, _numpy_chains(x.numpy(), steps,
                                                  fused=True),
                               rtol=peak.CHAIN_RTOL, atol=0)


def test_measure_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        peak.measure_fp32_peak(device="cpu")
    with pytest.raises(ValueError):
        peak.fma_chain_cuda(torch.zeros(4, 3), 1)
