"""Roofline terms of a step on one NVIDIA H100 SXM, the port's card.

The port of ``src/repro/launch/roofline.py``. Three terms, each in seconds
a step on the card:

  compute    = FLOPs a device / PEAK_FLOPS
  memory     = HBM bytes a device / HBM_BW
  collective = the wire bytes of the step's collectives / link rate
               (NVLink within a host, the inter-host link for a group that
               spans pods)

Where the numbers come from (``launch/dryrun.py``):

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the traced
    step. It counts matrix products and attention, not elementwise work;
    XLA's ``cost_analysis``, the reference's source, counts both, so the
    two packages' FLOP counts are never compared.
  * HBM bytes: ``launch/memmodel.py``'s component model.
  * Collectives: ``sharding/comm.py``'s record of what the port's program
    issues (:func:`tally_collectives`), where the reference parsed the
    compiled HLO text. The wire factors, the pod test and the output keys
    are the reference's. The reference also kept a "TPU-corrected" tally
    that halved f32 reductions which XLA's CPU backend had upcast from
    bf16; the port's record holds what the program sends, so there is
    nothing to correct and that tally (its ``*_tpu`` / ``*_raw`` keys and
    ``cpu_upcast``) is gone.

``ici_bytes`` and ``dcn_bytes`` keep the reference's names: on the H100
they are the bytes on NVLink (within a host) and between hosts.

Hardware constants, one NVIDIA H100 SXM5 80GB at a 700 W power limit (the
H100 Tensor Core GPU data sheet, dense rates, no sparsity):
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

PEAK_FLOPS = 989e12       # bf16 tensor cores, dense; H100 SXM data sheet, 700 W
PEAK_FLOPS_F32 = 67e12    # f32 (non-tensor); H100 SXM data sheet, 700 W
HBM_BW = 3.35e12          # bytes/s, HBM3; H100 SXM data sheet, 700 W
HBM_BYTES = 80e9          # HBM3 capacity; H100 SXM data sheet
NVLINK_BW = 450e9         # bytes/s each way: NVLink 4 at 900 GB/s per GPU in
                          # both directions; H100 SXM data sheet, 700 W
INTER_HOST_BW = 50e9      # bytes/s each way between hosts: an assumption, not
                          # measured -- one 400 Gb/s NIC per GPU, as in NVIDIA's
                          # DGX H100 system layout

_WIRE_FACTOR = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: (g - 1) / g,
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}


def _crosses_pod(groups, pod_size: Optional[int]) -> bool:
    if not pod_size:
        return False
    return any(len({i // pod_size for i in ids}) > 1 for ids in groups)


def tally_collectives(records: List[Dict], n_devices: int,
                      pod_size: Optional[int] = None) -> Dict:
    """Wire bytes a device over the collectives in ``records``
    (``sharding.comm.record``'s entries: ``op``, ``bytes`` of the result,
    ``ranks`` of the group), with the ring-algorithm wire factor over the
    group size g:

      all-reduce      2*(g-1)/g     all-gather / reduce-scatter   (g-1)/g
      all-to-all      (g-1)/g       collective-permute            1

    A group whose ranks span more than one pod of ``pod_size`` ranks goes
    to ``dcn_bytes``, any other to ``ici_bytes``. A record without ranks
    spans all ``n_devices``, as the reference takes an op without replica
    groups."""
    ici_bytes = 0.0
    dcn_bytes = 0.0
    ops: List[Dict] = []
    for r in records:
        nbytes = r["bytes"]
        if nbytes == 0:
            continue
        ranks = r.get("ranks") or list(range(n_devices))
        g = len(ranks)
        crosses = _crosses_pod([ranks], pod_size)
        wire = _WIRE_FACTOR[r["op"]](max(g, 1)) * nbytes
        if crosses:
            dcn_bytes += wire
        else:
            ici_bytes += wire
        ops.append({"op": r["op"], "bytes": nbytes, "group": g,
                    "wire_bytes": wire, "cross_pod": crosses})
    return {"ici_bytes": ici_bytes, "dcn_bytes": dcn_bytes, "ops": ops}


def elementwise_hbm_bytes(n_elements: int, *, n_operands: int = 2,
                          n_results: int = 1, dtype_bytes: int = 4,
                          n_devices: int = 1) -> float:
    """Per-device HBM traffic of an elementwise kernel: each operand read
    once and each result written once, every device on its 1/n slice."""
    return (n_operands + n_results) * n_elements * dtype_bytes / n_devices


def allreduce_wire_bytes(n_elements: int, group_size: int,
                         dtype_bytes: int = 4) -> float:
    """Ring all-reduce wire bytes per device: 2*(g-1)/g * payload."""
    return _WIRE_FACTOR["all-reduce"](max(group_size, 1)) * n_elements * dtype_bytes


@dataclasses.dataclass
class Roofline:
    flops: float                # per device (FlopCounterMode)
    bytes_accessed: float       # per device (memmodel)
    ici_bytes: float            # NVLink wire bytes per device
    dcn_bytes: float            # inter-host wire bytes per device
    model_flops: float          # 6ND (train) / 2ND (inference), per device

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.ici_bytes / NVLINK_BW + self.dcn_bytes / INTER_HOST_BW

    @property
    def bound(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def t_step(self) -> float:
        """Perfect-overlap model: step time = max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu(self) -> float:
        """Model-flops utilization at the roofline step time."""
        if self.t_step == 0:
            return 0.0
        return self.model_flops / PEAK_FLOPS / self.t_step

    @property
    def flops_efficiency(self) -> float:
        """MODEL_FLOPS / counted FLOPs: the share of the executed matrix
        work that is 'useful' (remat recompute lowers it)."""
        return self.model_flops / self.flops if self.flops else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops, "bytes_accessed": self.bytes_accessed,
            "ici_bytes": self.ici_bytes, "dcn_bytes": self.dcn_bytes,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "t_step": self.t_step,
            "bound": self.bound, "mfu": self.mfu,
            "flops_efficiency": self.flops_efficiency,
        }


def model_flops_per_device(n_active_params: int, tokens_global: int,
                           n_devices: int, kind: str) -> float:
    """6ND for training, 2ND for inference forward passes. N is the
    reference's ``active_param_count``: it includes the input embedding
    table, which the step reads by a gather and multiplies by nothing."""
    c = 6.0 if kind == "train" else 2.0
    return c * n_active_params * tokens_global / n_devices


def measured_mfu(model_flops: float, step_s: float) -> float:
    """Model-flops utilization of a measured step: model FLOPs a device over
    PEAK_FLOPS times the step's seconds."""
    return model_flops / (PEAK_FLOPS * step_s) if step_s > 0 else 0.0
