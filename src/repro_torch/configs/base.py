"""Architecture + run configuration dataclasses.

`ArchConfig` describes the model (one file per assigned architecture in this
package); `RunConfig` describes how it is executed (mesh axes, PK overlap
flags, remat/microbatching, dtypes). The same ArchConfig drives the smoke
test (via `.reduced()`), the dry-run (full shapes, ShapeDtypeStruct only) and
training/serving.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One position in the repeating layer pattern."""
    mixer: Literal["attn", "mamba"] = "attn"
    mlp: Literal["dense", "moe", "none"] = "dense"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1               # pattern: layer i is MoE iff i % moe_every == (moe_every-1)

    # SSM / hybrid
    ssm_state: int = 16
    d_inner_mult: int = 2
    conv_kernel: int = 4
    dt_rank: int | None = None
    attn_every: int = 0              # hybrid: layer i is attention iff i % attn_every == 0

    # attention
    rope_theta: float = 10000.0
    sliding_window: int | None = None

    # encoder-decoder
    encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # modality frontend (STUB — input_specs provides precomputed embeddings)
    frontend: Literal[None, "audio", "vision"] = None
    n_frontend_tokens: int = 0

    act: str = "silu"
    gated_mlp: bool = True
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- derived ---
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.d_inner_mult * self.d_model

    @property
    def dtr(self) -> int:
        return self.dt_rank if self.dt_rank is not None else math.ceil(self.d_model / 16)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.attn_every > 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (sub-quadratic sequence mixing)."""
        return self.is_ssm_only or self.is_hybrid or self.sliding_window is not None

    def padded_vocab(self, multiple: int = 16) -> int:
        return _round_up(self.vocab_size, multiple)

    def layer_pattern(self) -> tuple[LayerSpec, ...]:
        """The repeating period of layer types.

        Hybrid (jamba): period = attn_every layers, attention at position 0,
        mamba elsewhere; MoE every `moe_every` positions. Pure archs: period
        length lcm(moe_every, 1) so the scan body stays small.
        """
        if self.is_hybrid:
            period = self.attn_every
        elif self.is_moe:
            period = self.moe_every
        else:
            period = 1
        specs = []
        for i in range(period):
            mixer = "mamba" if (self.is_ssm_only or
                                (self.is_hybrid and i % self.attn_every != 0)) else "attn"
            if self.is_ssm_only:
                mlp = "none"          # mamba-1 blocks have no separate MLP
                mixer = "mamba"
            else:
                mlp = "moe" if (self.is_moe and i % self.moe_every ==
                                (self.moe_every - 1)) else "dense"
            specs.append(LayerSpec(mixer=mixer, mlp=mlp))
        assert self.n_layers % len(specs) == 0, (self.name, self.n_layers, len(specs))
        return tuple(specs)

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.layer_pattern())

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.hd
        per_period = 0
        for spec in self.layer_pattern():
            if spec.mixer == "attn":
                per_period += d * (self.n_heads * hd) * 2      # wq, wo
                per_period += d * (self.n_kv_heads * hd) * 2   # wk, wv
            else:
                di, ns, dtr = self.d_inner, self.ssm_state, self.dtr
                per_period += (d * 2 * di + di * self.conv_kernel
                               + di * (dtr + 2 * ns) + dtr * di
                               + di * ns + di + di * d)
            n_proj = 3 if self.gated_mlp else 2
            if spec.mlp == "dense":
                per_period += n_proj * d * self.d_ff
            elif spec.mlp == "moe":
                per_period += (self.n_experts * n_proj * d * self.d_ff
                               + d * self.n_experts)
            per_period += 2 * d                                # norms
        n = per_period * self.n_periods
        v = self.padded_vocab()
        n += v * d * (1 if self.tie_embeddings else 2)
        if self.encoder_decoder:
            n += (d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
                  + (3 if self.gated_mlp else 2) * d * self.d_ff
                  + 2 * d) * self.n_encoder_layers
            # decoder cross-attention blocks
            n += (d * (self.n_heads * hd) * 2 +
                  d * (self.n_kv_heads * hd) * 2 + d) * self.n_layers
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        moe_layers = sum(1 for s in self.layer_pattern()
                         if s.mlp == "moe") * self.n_periods
        inactive = (moe_layers * (self.n_experts - self.top_k)
                    * (3 if self.gated_mlp else 2) * d * self.d_ff)
        return total - inactive

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        pattern = len(self.layer_pattern())
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(pattern, 2 if pattern == 1 else pattern),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) if self.is_moe else 0,
            top_k=min(self.top_k, 2) if self.is_moe else 0,
            n_encoder_layers=2 if self.encoder_decoder else 0,
            n_frontend_tokens=8 if self.frontend else 0,
            sliding_window=16 if self.sliding_window else None,
            d_inner_mult=2,
            ssm_state=8,
            dt_rank=8,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""
    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution / distribution knobs."""
    # mesh
    dp_axes: tuple[str, ...] = ("data",)    # ("pod","data") multi-pod
    tp_axis: str = "model"
    fsdp: bool = True                        # shard params over dp_axes too

    # PK overlap features (paper technique on/off per site)
    pk_overlap: bool = True                  # use pk_* overlapped collectives
    reference_mode: bool = False             # force EVERY core.template
                                             # Island to its dense reference
                                             # path (stronger than
                                             # pk_overlap=False: also covers
                                             # embed/loss/decode/gpipe
                                             # islands) — debugging oracle
    pk_bidirectional: bool = False           # 2-link bidirectional rings
    comm_backend: str | None = None          # pin one CommContext backend
                                             # ("bulk"/"ring"/...; None=policy)
    comm_policy: Literal["analytic", "measured", "auto"] = "analytic"
                                             # cost source for backend=None
                                             # dispatch (core/autotune.py)
    calibration_path: str | None = None      # explicit calibration table for
                                             # comm_policy="measured"; None =
                                             # user cache then in-repo seeds
    sp_attention: Literal["ring", "ulysses", "none"] = "ring"
    moe_strategy: Literal["replicated", "a2a"] = "replicated"
    moe_chunks: int = 1                      # MoE dispatch/combine chunks;
                                             # 0 = auto (measured a2a island
                                             # rows first, analytic policy
                                             # otherwise)
    ulysses_chunks: int = 1                  # a2a chunk count for the Ulysses
                                             # island (paper Fig. 11: attention
                                             # on early head chunks overlaps
                                             # later chunks' transfer);
                                             # 0 = auto (plan override >
                                             # measured a2a rows > analytic)
    comm_chunks: int | None = None           # force the sub-chunk count of
                                             # every chunk-pipelined ring
                                             # GEMM×collective (None = per-call
                                             # kwarg > measured table > the
                                             # analytic chunk scheduler)
    comm_wire: str | None = None             # on-wire format for ring
                                             # GEMM×collectives: None/"bf16" =
                                             # full precision, "int8" =
                                             # per-block int8 + f32 scales,
                                             # "int8_sr" = int8 + stochastic
                                             # rounding (core/quant.py);
                                             # threaded to CommContext.wire

    # compute
    attention_impl: Literal["xla", "pallas"] = "xla"
    remat: bool = True
    microbatches: int = 1
    optimizer_moment_dtype: str = "float32"  # bf16 for the >=300B archs
    logits_fp32: bool = True
    loss_chunk: int = 512                    # CE loss sequence chunking
    ssm_chunk: int = 256                     # mamba scan chunk
    scan_layers: bool = True                 # False: python-unroll periods
                                             # (cost-calibration mode)
    # §Perf hillclimb knobs (EXPERIMENTS.md)
    bf16_backward_ars: bool = False          # cast residual-stream cotangents
                                             # to bf16 (halves backward ARs)
    save_collectives: bool = False           # remat policy: save sub-block
                                             # outputs so fwd psums are not
                                             # recomputed in the backward
    ssm_scan_dtype: str = "float32"          # mamba chunk-scan accum dtype
    pk_ring_psum: bool = False               # MoE combine via ppermute ring
                                             # (bf16 payload, overlappable)
    pk_attn_out_island: bool = False         # attention out-proj through the
                                             # PK GEMM+AR island

    # serving
    decode_seq_shard: bool = True            # shard KV cache seq over tp axis
    serve_moe_tp_data: bool = False          # resident 2D-TP expert weights
                                             # (ff over dp as TP, not FSDP):
                                             # no per-token weight gathers
    # per-island plan overrides: frozen ((island_name, backend, chunks), ...)
    # entries produced by core.template.plan_overrides() from resolved
    # Island.plan() reports. The serving engine evaluates island_plans() per
    # shape bucket at startup and threads the chosen backend / sub-chunk
    # count back into each bucket's CommContext through this field, so the
    # decode bucket can run a different schedule than the prefill bucket.
    # () = no overrides (policy dispatch, the default everywhere else).
    # Entries may also be 4-tuples carrying a source tag (e.g. "health" for
    # runtime demotions layered above the measured plan by the
    # runtime.health.HealthMonitor); later entries win.
    island_overrides: tuple = ()

    # runtime health (runtime/health.py)
    island_guards: bool = False              # jit-compatible finite-checks on
                                             # island inputs/outputs; trips are
                                             # logged per island (core.template
                                             # guard registry) and drained by
                                             # the serving engine each step
    comm_fault: tuple | None = None          # scripted comms-level fault for
                                             # THIS trace: (kind, island, hop)
                                             # with kind "corrupt"|"bitflip",
                                             # island name or "*"; consumed by
                                             # Island.make_context -> the ring
                                             # collectives corrupt hop's
                                             # payload. Test-only seam: set by
                                             # the serving engine when a
                                             # CommFaultPlan event is active,
                                             # never in production configs.


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Continuous-batching serving knobs (runtime/serving.py engine).

    ``bucket_edges`` are the padded prompt lengths the engine jits prefill
    steps for: a request is admitted into the smallest bucket >= its prompt
    length (strictly increasing edges). ``max_batch`` is the decode pool
    size (slots); ``prefill_batch`` the fixed prefill group size (groups are
    padded with inert slots so every bucket compiles exactly one program).
    ``queue_policy``:

    * ``"fcfs"`` — admit the queue head's bucket, taking only the contiguous
      prefix of same-bucket requests behind it (strict arrival order);
    * ``"bucket-greedy"`` — scan the whole queue for requests in the head's
      bucket to fill the group (better bucket occupancy, may reorder).

    ``exact_buckets`` disables padding (each distinct prompt length is its
    own bucket) — required for SSM/hybrid architectures, whose recurrent
    state cannot mask right-padding the way attention masks stale cache.

    ``cache_layout`` selects the KV-cache memory layout:

    * ``"slab"`` — one dense ``padded_s_max`` slab per slot (the default);
    * ``"paged"`` — a fixed global page pool (``runtime/paging.py``) with
      per-slot block tables, refcounted copy-on-write prefix sharing, and
      admission backpressure when the pool is exhausted. Attention-only
      architectures only (SSM state has no paged equivalent here).

    ``kv_dtype`` selects the stored KV-cache element type: ``"bf16"`` (the
    default — byte-identical to the historical layout) or ``"int8"``, which
    stores K/V as int8 with one f32 scale per (token, head) plane —
    quantize-on-write, dequantize-on-read — roughly halving cache HBM.

    ``page_size`` is the tokens-per-page granularity of the paged layout
    (rounded up to a multiple of the tp axis size so pages stripe evenly
    over shards). ``n_pages`` sizes the pool; 0 = auto (slab-equivalent:
    ``max_batch`` slots' worth of pages). ``prefill_chunk`` > 0 splits
    prefill across engine steps in chunks of that many tokens (page-aligned;
    must be a positive multiple of ``page_size``) so decode ticks interleave
    mid-prefill; 0 = single-shot prefill per bucket.
    """

    max_batch: int = 8
    prefill_batch: int = 4
    bucket_edges: tuple[int, ...] = (16, 32, 64)
    max_new_tokens: int = 16
    queue_policy: Literal["fcfs", "bucket-greedy"] = "fcfs"
    exact_buckets: bool = False
    cache_layout: Literal["slab", "paged"] = "slab"
    kv_dtype: Literal["bf16", "int8"] = "bf16"
    page_size: int = 16
    n_pages: int = 0
    prefill_chunk: int = 0
    # request-level robustness (runtime/health.py + engine poison handling):
    # a request whose prefill yields non-finite logits is re-queued up to
    # max_retries times with exponential backoff (retry_backoff * 2**attempt
    # engine steps) before being quarantined; deadline_steps > 0 expires
    # requests (queued or in-slot) that many steps after submission.
    max_retries: int = 1
    retry_backoff: int = 1
    deadline_steps: int = 0                  # 0 = no deadline
    # island health monitoring: when True the engine runs a
    # runtime.health.HealthMonitor over per-island step timings and demotes
    # a drifting island's backend (ring_bidir -> ring -> bulk) with
    # hysteresis through RunConfig.island_overrides, re-promoting after
    # health_probation consecutive clean samples (doubled per demotion).
    health_monitor: bool = False
    health_factor: float = 3.0
    health_demote_after: int = 2
    health_probation: int = 6

    def __post_init__(self):
        if not self.bucket_edges or \
                list(self.bucket_edges) != sorted(set(self.bucket_edges)):
            raise ValueError(
                f"bucket_edges must be strictly increasing, got "
                f"{self.bucket_edges}")
        if self.prefill_batch > self.max_batch:
            raise ValueError("prefill_batch cannot exceed max_batch")
        if self.cache_layout not in ("slab", "paged"):
            raise ValueError(f"unknown cache_layout {self.cache_layout!r}")
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.n_pages < 0:
            raise ValueError("n_pages must be >= 0 (0 = auto)")
        if self.prefill_chunk:
            if self.cache_layout != "paged":
                raise ValueError(
                    "prefill_chunk requires cache_layout='paged'")
            if self.prefill_chunk % self.page_size:
                raise ValueError(
                    f"prefill_chunk ({self.prefill_chunk}) must be a "
                    f"multiple of page_size ({self.page_size})")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.retry_backoff < 1:
            raise ValueError("retry_backoff must be >= 1")
        if self.deadline_steps < 0:
            raise ValueError("deadline_steps must be >= 0 (0 = no deadline)")
        if self.health_factor <= 1.0:
            raise ValueError("health_factor must be > 1")
        if self.health_demote_after < 1:
            raise ValueError("health_demote_after must be >= 1")
        if self.health_probation < 1:
            raise ValueError("health_probation must be >= 1")

    @property
    def s_max(self) -> int:
        """Cache length every bucket shares: worst prompt + generation."""
        return self.bucket_edges[-1] + self.max_new_tokens

    def bucket_for(self, prompt_len: int) -> int:
        """Padded length of the bucket admitting a prompt of this length."""
        if self.exact_buckets:
            if prompt_len > self.bucket_edges[-1]:
                raise ValueError(
                    f"prompt length {prompt_len} exceeds the largest bucket "
                    f"edge {self.bucket_edges[-1]}")
            return prompt_len
        for edge in self.bucket_edges:
            if prompt_len <= edge:
                return edge
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest bucket edge "
            f"{self.bucket_edges[-1]}")


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Multi-replica serving fleet knobs (runtime/fleet.py).

    ``router`` is the admission-steering policy the fleet's deterministic
    router runs over per-replica feedback (queue depth, live slots,
    mid-prefill rows, tokens/s, cache occupancy):

    * ``"fcfs"`` — fixed rotation over the admitting replicas in request
      order (no feedback; the baseline);
    * ``"least-loaded"`` — argmin of (queued + in-flight + prefill rows),
      lowest replica index breaks ties;
    * ``"cache-affinity"`` — paged engines only: route to the replica whose
      ``PrefixCache`` holds the longest prefix of the prompt (ties and
      misses fall back to least-loaded).

    ``step_budget`` is how many engine steps each live replica runs per
    fleet step (the cooperative interleave quantum). ``steal`` enables
    straggler-aware request stealing: queued (never in-flight) requests are
    pulled back from a replica the ``FleetWatchdog`` flags — EMA above
    ``steal_factor`` x the live-median, a blown per-replica deadline, or a
    scripted stall — and rerouted. ``stall_dt`` is the synthetic step time
    a stalled (fault-injected ``delay``) tick records into that replica's
    watchdog feed, so scripted faults drive the same signal real slowness
    would."""

    n_replicas: int = 2
    router: Literal["fcfs", "least-loaded", "cache-affinity"] = \
        "least-loaded"
    step_budget: int = 1
    steal: bool = True
    steal_factor: float = 3.0
    stall_dt: float = 1.0

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if self.router not in ("fcfs", "least-loaded", "cache-affinity"):
            raise ValueError(f"unknown router {self.router!r}")
        if self.step_budget < 1:
            raise ValueError("step_budget must be >= 1")
        if self.steal_factor <= 1.0:
            raise ValueError("steal_factor must exceed 1.0")
