"""Published peak rates per device kind, for utilization (MFU) reporting.

Keyed by ``jax.Device.device_kind`` matched EXACTLY: an H100 PCIe or a
future card must get its own row (its own data-sheet figures), never the
SXM part's peaks by a prefix match. An unknown kind raises.

H100 SXM row: NVIDIA H100 Tensor Core GPU data sheet (SXM5, dense rates
without sparsity, at the 700 W power limit): 80 GB HBM3 at 3.35 TB/s,
989 TFLOP/s bf16, 1,979 TOP/s int8. The ``cpu`` row (the emulated test
devices) has no published peak: MFU reads None there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class DeviceProfile:
    kind: str
    hbm_gb: Optional[float]  #: device memory capacity
    hbm_gbps: Optional[float]  #: peak memory bandwidth (GB/s)
    peak_bf16_tflops: Optional[float]  #: dense bf16 matmul peak
    peak_int8_tops: Optional[float]  #: dense int8 matmul peak


PROFILES = {
    "NVIDIA H100 80GB HBM3": DeviceProfile(
        kind="NVIDIA H100 80GB HBM3", hbm_gb=80, hbm_gbps=3350,
        peak_bf16_tflops=989, peak_int8_tops=1979,
    ),
    "cpu": DeviceProfile(
        kind="cpu", hbm_gb=None, hbm_gbps=None,
        peak_bf16_tflops=None, peak_int8_tops=None,
    ),
}


def resolve_profile(kind: str) -> DeviceProfile:
    """The table row for ``kind``; raises ``KeyError`` for unknown kinds."""
    try:
        return PROFILES[kind]
    except KeyError:
        raise KeyError(
            f"no device profile for device kind {kind!r}; add its "
            f"published peaks to ops/device_profile.py (known: "
            f"{sorted(PROFILES)})"
        ) from None


def peak_bf16_flops(kind: str) -> Optional[float]:
    """Peak dense bf16 FLOP/s for ``kind`` (None where no peak is
    published)."""
    tflops = resolve_profile(kind).peak_bf16_tflops
    return tflops * 1e12 if tflops else None


def peak_matmul_flops(kind: str, dtype) -> Optional[float]:
    """Peak matmul op rate at an operand dtype: the int8 rate for int8
    stores, the bf16 rate for every other dtype."""
    import jax.numpy as jnp

    prof = resolve_profile(kind)
    if jnp.dtype(dtype) == jnp.int8:
        return prof.peak_int8_tops * 1e12 if prof.peak_int8_tops else None
    return peak_bf16_flops(kind)
