"""Three-term roofline report from a traced program (``trace_analysis``).

Hardware model (one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at
the full 700 W power limit):
  peak bf16 / fp16 tensor-core compute  989 TFLOP/s
  peak f32 compute outside the tensor cores  67 TFLOP/s  (TF32 is off, so
               an f32 matmul is SGEMM)
  HBM bandwidth   3.35 TB/s
  NVLink          450 GB/s each way to the other cards of the host

Terms (seconds, per step, per device — the trace counts the whole
program, spread evenly over ``num_partitions``):
  compute    = bf16_FLOPs / 989e12 + f32_FLOPs / 67e12
  memory     = bytes / 3.35e12
  collective = wire_bytes / 450e9    (ring-model wire bytes a partition
               receives; the operand-byte sum is also reported)

What the bound measures: the least time the card needs for the port's
own eager op sequence as it runs, each op a kernel that reads its inputs
and writes its outputs through HBM (``trace_analysis``), intermediates
included.  It is not the hardware floor of the function: fusing ops
removes their intermediates' bytes from ``memory`` and so lowers the
bound together with the time, and a share ``bound_s / measured`` read
before and after a fusion moves less than the time does.  (The
reference's HLO bytes count XLA's fusions, a floor of the same kind for
its own compiled program.)

``roofline_fraction`` keeps the reference's definition: the model's
useful FLOPs at the bf16 peak over the bound.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.roofline.trace_analysis import TraceCost

PEAK_FLOPS = 989e12       # bf16 / fp16, tensor cores, dense
PEAK_FLOPS_F32 = 67e12    # f32 outside the tensor cores
HBM_BW = 3.35e12
LINK_BW = 450e9           # NVLink, each way


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    hbm_bytes: float
    coll_operand_bytes: float
    coll_wire_bytes: float
    coll_by_type: dict
    dynamic_whiles: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Lower-bound step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self, model_flops_global: float,
                          chips: int) -> float:
        """'How close to roofline': useful-FLOPs time at peak vs the bound."""
        useful_s = model_flops_global / (chips * PEAK_FLOPS)
        return useful_s / max(self.bound_s, 1e-30)

    def mfu_ratio(self, model_flops_global: float, chips: int) -> float:
        """MODEL_FLOPS / traced FLOPs (global) — remat/redundancy probe."""
        return model_flops_global / max(self.flops * chips, 1e-30)


def roofline_from_trace(cost: TraceCost, num_partitions: int = 1
                        ) -> Roofline:
    """The per-device terms of a whole-program trace over
    ``num_partitions`` devices (collective bytes are per partition
    already)."""
    P = num_partitions
    by = cost.flops_by_dtype
    half = by.get("bf16", 0.0) / P
    rest = (cost.flops - by.get("bf16", 0.0)) / P
    return Roofline(
        compute_s=half / PEAK_FLOPS + rest / PEAK_FLOPS_F32,
        memory_s=cost.hbm_bytes / P / HBM_BW,
        collective_s=cost.coll_wire_bytes / LINK_BW,
        flops=cost.flops / P,
        hbm_bytes=cost.hbm_bytes / P,
        coll_operand_bytes=cost.coll_operand_bytes,
        coll_wire_bytes=cost.coll_wire_bytes,
        coll_by_type=dict(cost.coll_by_type),
        dynamic_whiles=cost.dynamic_loops,
    )


def report_dict(rf: Roofline, meta: dict, chips: int) -> dict[str, Any]:
    mf = float(meta.get("model_flops", 0.0))
    return {
        "compute_s": rf.compute_s,
        "memory_s": rf.memory_s,
        "collective_s": rf.collective_s,
        "dominant": rf.dominant,
        "bound_s": rf.bound_s,
        "flops_per_device": rf.flops,
        "hbm_bytes_per_device": rf.hbm_bytes,
        "coll_operand_bytes": rf.coll_operand_bytes,
        "coll_wire_bytes": rf.coll_wire_bytes,
        "coll_by_type": rf.coll_by_type,
        "dynamic_whiles": rf.dynamic_whiles,
        "model_flops": mf,
        "model_flops_ratio": rf.mfu_ratio(mf, chips) if mf else None,
        "roofline_fraction": rf.roofline_fraction(mf, chips) if mf else None,
        "chips": chips,
    }
