"""Public names of the hand-written kernels — the twin of
``repro/kernels/ops.py``. The Pallas wrappers there pad to MXU tiles and
repeat GQA heads; the CUDA kernels mask ragged edges and read KV heads in
place, so nothing is left to wrap and these are plain re-exports."""

from repro_torch.kernels.collective_matmul import (  # noqa: F401
    ag_matmul_fused as pk_ag_matmul,
    matmul_ar_fused as pk_matmul_ar,
    matmul_rs_fused as pk_matmul_rs,
)
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_hop,
)
from repro_torch.kernels.grouped_matmul import grouped_matmul  # noqa: F401
from repro_torch.kernels.mamba_scan import mamba_scan  # noqa: F401
from repro_torch.kernels.matmul import matmul  # noqa: F401
from repro_torch.kernels.pk_comm import (  # noqa: F401
    p2p_ring_shift as pk_ring_shift,
    ring_all_gather as pk_all_gather,
    ring_reduce_scatter as pk_reduce_scatter,
)
