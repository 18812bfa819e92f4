"""The three-term roofline of a dry-run cell — the twin of
``repro/roofline/model.py``::

    compute    = FLOPs / peak               (a device's counted FLOPs)
    memory     = bytes / HBM rate
    collective = collective bytes / (links × link rate)

The counts are a device's (``launch/dryrun.py`` divides the step's counts
by the mesh size). ``MODEL_FLOPS`` is 6·N·D for training (N the active
parameters, D the step's tokens) and 2·N·D forward-only, and
``useful_ratio`` how much of the counted compute it is. The hardware is
``core/costmodel.py``'s ``H100_SXM`` by default — 989 TFLOP/s bf16,
3.35 TB/s HBM, 450 GB/s NVLink a direction: published peaks, so every
term here is modelled, never measured.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.costmodel import H100_SXM, HardwareSpec
from repro_torch.roofline.hlo import CollectiveStats


@dataclasses.dataclass
class Roofline:
    arch: str
    cell: str
    mesh: str
    flops: float               # a device's counted FLOPs
    hbm_bytes: float           # a device's counted bytes
    coll_bytes: float          # a device's collective bytes
    model_flops_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    useful_ratio: float        # MODEL_FLOPS / counted FLOPs (a device)
    roofline_fraction: float   # ideal step time / the dominant term
    coll_detail: str = ""

    def row(self) -> str:
        return (f"| {self.arch} | {self.cell} | {self.mesh} "
                f"| {self.t_compute*1e3:.2f} | {self.t_memory*1e3:.2f} "
                f"| {self.t_collective*1e3:.2f} | {self.bottleneck} "
                f"| {self.useful_ratio:.2f} | {self.roofline_fraction:.2f} |")


def build(arch: str, cell: str, mesh_name: str, *, flops: float,
          hbm_bytes: float, coll: CollectiveStats,
          model_flops_total: float, n_chips: int,
          hw: HardwareSpec = H100_SXM, ici_links: int = 1,
          args_bytes: float = 0.0) -> Roofline:
    """The roofline of one cell from a device's counts (JAX's ``build``,
    on ``hw``). The ideal step time is the larger of the useful compute at
    peak and touching every argument byte once."""
    t_comp = flops / hw.peak_flops_bf16
    t_mem = hbm_bytes / hw.hbm_bandwidth
    t_coll = coll.total_bytes / (hw.ici_bandwidth * ici_links)
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    mf_dev = model_flops_total / n_chips
    useful = mf_dev / flops if flops > 0 else 0.0
    ideal = max(mf_dev / hw.peak_flops_bf16, args_bytes / hw.hbm_bandwidth)
    lower = max(terms.values())
    frac = ideal / lower if lower > 0 else 0.0
    return Roofline(arch=arch, cell=cell, mesh=mesh_name, flops=flops,
                    hbm_bytes=hbm_bytes, coll_bytes=coll.total_bytes,
                    model_flops_per_device=mf_dev, t_compute=t_comp,
                    t_memory=t_mem, t_collective=t_coll,
                    bottleneck=bottleneck, useful_ratio=useful,
                    roofline_fraction=min(frac, 1.0),
                    coll_detail=coll.summary())


def model_flops(cfg, cell) -> float:
    """6·N·D training FLOPs (forward and backward); 2·N·D for prefill and
    decode. N = active parameters, D = tokens the step processes (one a
    sequence at decode)."""
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        return 6.0 * n_active * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n_active * cell.global_batch * cell.seq_len
    return 2.0 * n_active * cell.global_batch
