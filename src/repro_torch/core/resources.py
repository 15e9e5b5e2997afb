"""FPGA resource proxy model.

The paper evaluates banking schemes by LUT/FF/BRAM/DSP after place-and-route.
We have no Vivado here, so the *paper-faithful* benchmarks (Tables 2/3) are
scored with this proxy: a structural estimator of the generated circuit --
crossbars sized by fan-out/fan-in (Table 1 metrics), bank-resolution
arithmetic costed from the (transformed) op graphs of Sec 3.4, and BRAM
quantization by 18Kb blocks.  The same features feed the ML cost model of
Sec 3.5, whose *labels* on the TPU side come from real compiled-HLO costs
instead (see core/dataset.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Sequence

from .transforms import Cost

BRAM_BITS = 18 * 1024


@dataclass
class ResourceEstimate:
    lut: float = 0.0
    ff: float = 0.0
    bram: int = 0
    dsp: int = 0
    # TPU-side analogue: scalar ops on the hot index path
    tpu_index_ops: int = 0

    def __add__(self, o: "ResourceEstimate") -> "ResourceEstimate":
        return ResourceEstimate(
            self.lut + o.lut, self.ff + o.ff, self.bram + o.bram,
            self.dsp + o.dsp, self.tpu_index_ops + o.tpu_index_ops,
        )

    def scaled(self, k: float) -> "ResourceEstimate":
        return ResourceEstimate(
            self.lut * k, self.ff * k, int(self.bram * k), int(self.dsp * k),
            int(self.tpu_index_ops * k),
        )

    def weighted(self, w_lut=1.0, w_ff=0.4, w_bram=200.0, w_dsp=400.0) -> float:
        """Scalar ranking score (used only as non-ML fallback ranking)."""
        return (self.lut * w_lut + self.ff * w_ff + self.bram * w_bram
                + self.dsp * w_dsp)


def bram_blocks(bank_volume: int, word_bits: int) -> int:
    """BRAM18K blocks for one bank, with the narrow-deep quantization FPGAs
    actually impose (a 18Kb block is at most 16K deep at 1 bit)."""
    if bank_volume <= 0:
        return 1
    by_bits = math.ceil(bank_volume * word_bits / BRAM_BITS)
    by_depth = math.ceil(bank_volume / (16 * 1024))
    return max(1, by_bits, by_depth)


def crossbar_cost(fan: int, width_bits: int) -> Cost:
    """fan-to-1 one-hot mux tree on a ``width_bits`` bus."""
    if fan <= 1:
        return Cost()
    lut = (fan - 1) * width_bits * 0.5
    ff = width_bits  # registered output
    return Cost(lut=lut, ff=ff, dsp=0, tpu_ops=max(1, fan.bit_length()))


def resolution_cost(ba_cost: Cost, bo_cost: Cost, ba_is_const: bool) -> Cost:
    c = bo_cost if ba_is_const else (ba_cost + bo_cost)
    return c


@dataclass
class SchemeResources:
    """Breakdown for one banking solution."""

    total: ResourceEstimate
    crossbar: ResourceEstimate
    resolution: ResourceEstimate
    storage: ResourceEstimate
    notes: Dict[str, float] = field(default_factory=dict)


def estimate_scheme(
    *,
    num_banks: int,
    bank_volume: int,
    word_bits: int,
    addr_bits: int,
    fan_outs: Sequence[int],
    fan_ins: Sequence[int],
    writes_fan_outs: Sequence[int],
    resolution_costs: Sequence[Cost],
    duplicates: int = 1,
) -> SchemeResources:
    xb = Cost()
    for fo in fan_outs:  # read-data return muxes
        xb = xb + crossbar_cost(fo, word_bits)
    for fi in fan_ins:   # per-bank request arbitration (addr + enables)
        xb = xb + crossbar_cost(fi, addr_bits + 2)
    for fo in writes_fan_outs:  # write data+addr distribution
        xb = xb + crossbar_cost(fo, word_bits + addr_bits)

    res = Cost()
    for c in resolution_costs:
        res = res + c

    storage_bram = duplicates * num_banks * bram_blocks(bank_volume, word_bits)
    storage = ResourceEstimate(
        lut=duplicates * num_banks * 6.0,   # per-bank control glue
        ff=duplicates * num_banks * (addr_bits + 4.0),
        bram=storage_bram,
        dsp=0,
    )
    xbr = ResourceEstimate(xb.lut, xb.ff, 0, xb.dsp, xb.tpu_ops).scaled(duplicates)
    resr = ResourceEstimate(res.lut, res.ff, 0, res.dsp, res.tpu_ops)
    total = xbr + resr + storage
    return SchemeResources(total=total, crossbar=xbr, resolution=resr,
                           storage=storage)
