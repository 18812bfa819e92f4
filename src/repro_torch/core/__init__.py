"""ParallelKittens core on virtual ranks — the twin of ``repro/core``.

Sequence-parallel attention is re-exported here, as the JAX package does;
the other modules are imported by name."""

from repro_torch.core.ring_attention import (  # noqa: F401
    pk_ring_attention,
    ring_attention_baseline,
    ssm_entry_states,
)
from repro_torch.core.ulysses import (  # noqa: F401
    pk_ulysses_attention,
    ulysses_attention_baseline,
)
