"""Kernel K6: the card's measured float32 FMA rate (no tensor cores).

`fma_chain` launches the CUDA kernel `csrc/fma_peak.cu` (replacing the
Pallas probe of `bench.py:_measure_vpu_peak`) for CUDA tensors and runs
`fma_chain_plain`, the same chain in plain PyTorch, for CPU tensors.
`measure_fp32_peak` keeps bench.py's marginal-rate protocol: the rate is
(flops_long - flops_short) / (t_long - t_short) between a short and a long
chain, so the fixed cost of a launch cancels.

The kernel rounds once per step (fmaf) and the twin twice (a multiply, then
an add).  The chain contracts by `a` at each step, so an error made at one
step shrinks by that factor at each later one and the two differ by at most
about 1 / (1 - a) roundings: with a = 0.999, 1000 ulp, 6e-5 relative near
the chain's fixed point.  The tolerance `CHAIN_RTOL` is that bound.
"""
from __future__ import annotations

import numpy as np
import torch

from ..native import cuda

CHAINS = 8              # chains per thread (csrc/fma_peak.cu kChains)
UNROLL = 16             # steps per loop trip (kUnroll)
THREADS_PER_SM = 2048   # a full SM: 8 blocks of 256 threads
A, B = 0.999, 0.001     # v -> v * a + b, fixed point 1.0
CHAIN_RTOL = 1.2e-4     # 2^-24 / (1 - A), twice over
# loop trips of the short and the long chain (16 steps each), and timed
# launches of each: the long chain runs ~8 ms, so launch costs cancel
TRIPS_SHORT, TRIPS_LONG, REPS = 1000, 8000, 5
# NVIDIA's H100 SXM5 data sheet: 67 TFLOP/s float32 outside the tensor
# cores; a reading above it is an error of the measurement
H100_FP32_PEAK = 67e12

# launches of the CUDA kernel in this process
LAUNCHES = 0


def chain_starts(n: int, seed: int = 0, *, device) -> torch.Tensor:
    """[n, CHAINS] float32 chain start values in [0, 2), from a seed."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, (n, CHAINS)).astype(np.float32)
    return torch.as_tensor(x, device=device)


def fma_chain_plain(x: torch.Tensor, trips: int) -> torch.Tensor:
    """[n] sums over the chains of x [n, CHAINS] after UNROLL * trips steps
    of v * A + B; plain PyTorch, two roundings a step."""
    a32 = torch.tensor(A, dtype=torch.float32, device=x.device)
    b32 = torch.tensor(B, dtype=torch.float32, device=x.device)
    v = x.clone()
    for _ in range(UNROLL * trips):
        v = v * a32 + b32
    acc = v[:, 0]
    for c in range(1, CHAINS):
        acc = acc + v[:, c]
    return acc


def fma_chain_cuda(x: torch.Tensor, trips: int) -> torch.Tensor:
    """The same chains in the CUDA kernel (one launch, one fmaf a step)."""
    global LAUNCHES
    if x.dim() != 2 or x.shape[1] != CHAINS:
        raise ValueError(f"fma_chain: x must be [n, {CHAINS}], got "
                         f"{tuple(x.shape)}")
    if trips < 0 or x.shape[0] >= 2 ** 31:
        raise ValueError("fma_chain: trips must be >= 0 and n < 2^31")
    cuda.require_cuda("fma_chain", x, dtypes=[torch.float32])
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    with cuda.on_device(x):
        rc = cuda.lib().l3d_fma_peak(x.data_ptr(), float(np.float32(A)),
                                     float(np.float32(B)), int(trips),
                                     x.shape[0], out.data_ptr(),
                                     cuda.stream_of(x))
    cuda.check(rc, "l3d_fma_peak")
    LAUNCHES += 1
    return out


def fma_chain(x: torch.Tensor, trips: int) -> torch.Tensor:
    """Chain sums: kernel K6 on CUDA, the plain twin on the CPU."""
    if x.device.type == "cpu":
        return fma_chain_plain(x, trips)
    return fma_chain_cuda(x, trips)


def measure_fp32_peak(device="cuda") -> dict:
    """Marginal float32 FMA rate of the card (bench.py's protocol).

    Returns dict(tflops, ms_short, ms_long, threads, sms).  Raises when no
    card is present or when the reading exceeds the H100's published
    float32 peak, which only a broken measurement can do."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("measure_fp32_peak needs a CUDA device")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = sms * THREADS_PER_SM
    x = chain_starts(n, device=dev)
    ms = {}
    for trips in (TRIPS_SHORT, TRIPS_LONG):
        fma_chain(x, trips)                      # warm-up
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(REPS):
            out = fma_chain(x, trips)
        t1.record()
        torch.cuda.synchronize(dev)
        ms[trips] = t0.elapsed_time(t1) / REPS
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError("measure_fp32_peak: non-finite chain sums")
    dflops = 2.0 * CHAINS * UNROLL * n * (TRIPS_LONG - TRIPS_SHORT)
    dt = (ms[TRIPS_LONG] - ms[TRIPS_SHORT]) * 1e-3
    if dt <= 0:
        raise RuntimeError(f"measure_fp32_peak: long chain not slower "
                           f"({ms})")
    rate = dflops / dt
    if rate > H100_FP32_PEAK:
        raise RuntimeError(f"measure_fp32_peak: {rate / 1e12:.1f} TFLOP/s "
                           f"exceeds the published H100 float32 peak")
    return dict(tflops=rate / 1e12, ms_short=ms[TRIPS_SHORT],
                ms_long=ms[TRIPS_LONG], threads=n, sms=sms)
