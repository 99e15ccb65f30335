"""Capacity planning: device-memory footprint estimation for a namespace / deployment.

The reference's only scale knob was a hardcoded 10k-element cap (reference:
src/mlvectordb/implementations/index.py:37).  Here capacity is bounded by device
memory; this helper answers "how many devices do I need for N vectors of dim D?"
before any data moves — the sizing question every sharded deployment starts with.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..config import DEFAULT_CONFIG, EngineConfig

# Device memory per card, keyed by ``jax.Device.device_kind`` (NVIDIA data sheet).
# Used only when the runtime reports no ``bytes_limit``; a device in neither place
# is an error, never a guess.
HBM_BYTES = {
    "NVIDIA H100 80GB HBM3": 80 * 10**9,
}


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    n_vectors: int
    dim: int
    dim_padded: int
    dtype: str
    bytes_per_vector: int
    data_bytes: int          # padded matrix
    overhead_bytes: int      # masks + norms + phase-1 workspace
    total_bytes: int
    hbm_per_chip: int
    fits_single_chip: bool
    min_shards: int          # chips needed on the shard axis at ~70% HBM budget


def plan_capacity(
    n_vectors: int,
    dim: int,
    config: EngineConfig = DEFAULT_CONFIG,
    hbm_per_chip: Optional[int] = None,
    hbm_budget_fraction: float = 0.7,
) -> CapacityPlan:
    """Estimate device memory for a namespace and the shard count it needs."""
    if hbm_per_chip is None:
        hbm_per_chip = _detect_hbm()
    dpad = config.pad_dim(dim)
    itemsize = 2 if config.dtype == "bfloat16" else 4
    cap = config.round_capacity(n_vectors)
    per_dim = itemsize
    # transposed sweep mirror (config.sweep_dtype) + the int8 residual-correction
    # codes of the mixed certified configs ride in HBM next to the store
    if config.sweep_dtype is not None:
        sweep_itemsize = {"bfloat16": 2, "int8": 1}.get(config.sweep_dtype, 4)
        per_dim += sweep_itemsize
        # residual codes: bf16 mirror keeps int8 codes of row - bf16(row) (only
        # for MIXED f32 stores); the int8 PRIMARY sweep keeps a second int8
        # stream (two-level quantizer) for ANY store dtype — mirror
        # NamespaceStore._use_resid exactly, or the planner under-counts and a
        # "fits" verdict OOMs on load
        resid_applies = config.sweep_dtype == "int8" or (
            config.dtype == "float32" and config.sweep_dtype == "bfloat16"
        )
        if resid_applies and config.sweep_resid:
            per_dim += 1
    data = cap * dpad * per_dim
    # valid (1B) + sq_norms (4B) + certificate scalars (scale/err, <=12B) +
    # window-min workspace [cap/R1, B~256] f32 + slack
    overhead = cap * 17 + (cap // 32) * 256 * 4
    total = data + overhead
    budget = int(hbm_per_chip * hbm_budget_fraction)
    min_shards = max(1, -(-total // budget))
    return CapacityPlan(
        n_vectors=n_vectors,
        dim=dim,
        dim_padded=dpad,
        dtype=config.dtype,
        bytes_per_vector=dpad * per_dim,
        data_bytes=data,
        overhead_bytes=overhead,
        total_bytes=total,
        hbm_per_chip=hbm_per_chip,
        fits_single_chip=total <= budget,
        min_shards=min_shards,
    )


def _detect_hbm(device=None) -> int:
    """Usable device memory: the runtime's ``bytes_limit`` (the share this process
    may allocate), else the card's size from HBM_BYTES by ``device_kind``."""
    if device is None:
        import jax

        device = jax.local_devices()[0]
    stats = device.memory_stats() or {}
    if stats.get("bytes_limit"):
        return int(stats["bytes_limit"])
    if device.device_kind in HBM_BYTES:
        return HBM_BYTES[device.device_kind]
    raise ValueError(
        f"unknown device kind {device.device_kind!r}: pass hbm_per_chip explicitly"
    )
