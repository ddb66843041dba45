"""Three-term roofline model of a traced dry-run step — the port of
``repro.roofline.report``.

    compute    = FLOPs       / (chips × peak FLOP/s)
    memory     = bytes       / (chips × HBM bandwidth)
    collective = coll_bytes  / (chips × link bandwidth)

plus MODEL_FLOPS = 6·N·D (6·N_active·D for MoE) and the useful-compute
ratio MODEL_FLOPS / FLOPs. The reference reads FLOPs and bytes from
XLA's ``cost_analysis`` and the collective bytes from the HLO; the
port's dry run counts them on one rank's traced step
(``repro_torch.roofline.trace``, ``repro_torch.roofline.collectives``)
and scales them by the chips, so the same formulas hold. The field
names (``hlo_flops``, ``hlo_bytes``) are the reference's. The
constants are the H100's (``repro_torch.roofline.constants``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig, MoEConfig, ShapeConfig
from repro_torch.roofline import constants as C


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, int]
    model_flops: float
    bytes_per_device: Optional[float] = None   # the traced peak

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * C.PEAK_FLOPS_BF16)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * C.HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * C.ICI_BW_PER_LINK)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "bytes_per_device": self.bytes_per_device,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
        }


# ----------------------------------------------------------------------
def _leaves(cfg: ArchConfig):
    from repro_torch.common.pytree import tree_leaves_with_paths
    from repro_torch.models.model import param_specs
    return tree_leaves_with_paths(param_specs(cfg))


def param_count(cfg: ArchConfig) -> int:
    """Total parameter count N (exact, from the ``meta`` param tree)."""
    return sum(int(x.numel()) for _, x in _leaves(cfg))


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters touched per token (MoE: top_k + shared experts
    instead of all experts)."""
    if cfg.moe is None:
        return param_count(cfg)
    moe: MoEConfig = cfg.moe
    total = 0
    for path, leaf in _leaves(cfg):
        if "experts" in path:
            # leading axis is the expert count
            per_expert = int(leaf.numel()) // moe.n_experts
            total += per_expert * moe.top_k
        else:
            total += int(leaf.numel())
    return total


def model_flops(cfg: ArchConfig, shape: ShapeConfig,
                n_agents: int = 1) -> float:
    """6·N·D  (N = active params, D = tokens in the step)."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len * n_agents
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens          # forward only
    tokens = shape.global_batch          # decode: 1 token per slot
    return 2.0 * n * tokens


def analyze(arch: str, shape: ShapeConfig, mesh_name: str, chips: int,
            cost: dict, coll: dict, mflops: float,
            bytes_per_device: Optional[float] = None) -> Roofline:
    """``cost``: {"flops", "bytes accessed"} over all chips; ``coll``:
    {kind: bytes, "total": bytes} over all chips
    (``collectives.collective_bytes`` of a rank's records, scaled)."""
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=float(cost.get("flops", 0.0)),
        hlo_bytes=float(cost.get("bytes accessed", 0.0)),
        coll_bytes=float(coll["total"]),
        coll_breakdown={k: v for k, v in coll.items() if k != "total"},
        model_flops=mflops,
        bytes_per_device=bytes_per_device,
    )
