"""Engine configuration (the fields the port's engines read).

Field names and defaults are those of ``llmd_tpu.config``, so one kwargs
dict builds a configuration for either package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any


@dataclasses.dataclass
class ModelConfig:
    """Architecture hyperparameters of a Llama-class decoder: dense, MoE
    (``num_experts > 0``), MLA (``kv_lora_rank > 0``, DeepSeek V2/V3) and
    gpt-oss (sliding windows, attention sinks, biased clamped-SwiGLU
    experts)."""

    name: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int | None = None  # defaults to hidden_size // num_heads
    rope_theta: float = 500000.0
    # HF-style rope_scaling dict (rope_type: default | linear | llama3 |
    # yarn); None is the unscaled rope.
    rope_scaling: dict | None = None
    rms_norm_eps: float = 1e-5
    max_model_len: int = 8192
    dtype: str = "bfloat16"
    # Weight quantization: None (the float dtype) or "int8" (W8A8:
    # per-output-channel int8 weights with f32 scales, per-token int8
    # activations, int8 x int8 -> int32 products rescaled in f32;
    # ``ops/quant.py``). Embeddings, norms, routers, biases, sinks and MLA's
    # ``wkv_b`` stay in the float dtype.
    quantization: str | None = None
    tie_word_embeddings: bool = False
    # Qwen2-style attention bias on QKV projections.
    attention_bias: bool = False
    # gpt-oss: a bias on the o projection too, and per-q-head attention
    # sinks (a learned logit of one extra key whose value is zero).
    attention_out_bias: bool = False
    attention_sinks: bool = False
    # Qwen3-style per-head RMS norm on Q and K (applied before RoPE).
    qk_norm: bool = False
    # Sliding-window attention: sliding_window > 0 limits a layer to the
    # trailing N positions. Which layers slide follows the HF conventions:
    # layer_types names each layer "sliding_attention" or "full_attention"
    # (gpt-oss); else max_window_layers >= 0 slides the layers from it up
    # (Qwen2); else every layer slides (Mistral).
    sliding_window: int = 0
    layer_types: tuple | None = None
    max_window_layers: int | None = None
    # --- MoE (0 experts => dense MLP) ---
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: int | None = None  # defaults to intermediate_size
    # Router: softmax or sigmoid scores; plain ("greedy") or group-limited
    # top-k (DeepSeek-V2 max per group, V3 top-2 sum per group).
    router_scoring: str = "softmax"  # "softmax" | "sigmoid"
    topk_method: str = "greedy"  # "greedy" | "group_max" | "group_top2"
    # gpt-oss: the router bias is part of the logits (selection and weights
    # both), unlike V3's selection-only correction bias.
    router_logit_bias: bool = False
    # Expert GLU: "silu" (Mixtral, Qwen, DeepSeek) or "swiglu_oss" (gpt-oss:
    # biased gate/up, gate clamped above at swiglu_limit, up to
    # [-limit, limit], out = (up + 1) * gate * sigmoid(1.702 * gate)).
    moe_activation: str = "silu"
    swiglu_limit: float = 7.0
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    n_group: int = 1
    topk_group: int = 1
    # DeepSeek-style: the first N layers use a dense MLP, the rest are MoE.
    first_dense_layers: int = 0
    # Always-on shared expert (DeepSeek V2/V3); 0 = none.
    shared_expert_intermediate_size: int = 0
    # --- MLA (multi-head latent attention, DeepSeek V2/V3/R1) ---
    # kv_lora_rank > 0 switches attention to MLA: the pool caches one
    # latent row [rmsnorm(c_kv) | rope(k_pe)] per token. q_lora_rank 0 = a
    # dense q projection (V2-Lite).
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    def __post_init__(self) -> None:
        if self.quantization not in (None, "int8"):
            raise ValueError(
                f"quantization={self.quantization!r} not supported "
                "(None or 'int8')"
            )
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_heads
        if self.moe_intermediate_size is None:
            self.moe_intermediate_size = self.intermediate_size
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_heads={self.num_heads} is not a multiple of "
                f"num_kv_heads={self.num_kv_heads}"
            )
        if self.layer_types is not None:
            self.layer_types = tuple(self.layer_types)
            if len(self.layer_types) != self.num_layers:
                raise ValueError(
                    f"layer_types has {len(self.layer_types)} entries for "
                    f"{self.num_layers} layers"
                )
        if self.sliding_window > 0 and self.kv_lora_rank > 0:
            raise ValueError(
                "sliding_window is not supported with MLA (no known MLA "
                "architecture slides; the latent path would attend past the "
                "window)"
            )
        if self.kv_lora_rank > 0 and self.attention_bias:
            raise ValueError(
                "attention_bias is not supported with MLA (kv_lora_rank > 0): "
                "no known MLA architecture uses QKV biases"
            )

    def window_for_layer(self, i: int) -> int:
        """Attention window of layer ``i`` (0 = full attention)."""
        if self.sliding_window <= 0:
            return 0
        if self.layer_types is not None:
            return (
                self.sliding_window
                if self.layer_types[i] == "sliding_attention"
                else 0
            )
        if self.max_window_layers is not None:
            return self.sliding_window if i >= self.max_window_layers else 0
        return self.sliding_window

    @property
    def layer_windows(self) -> tuple[int, ...]:
        return tuple(self.window_for_layer(i) for i in range(self.num_layers))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def mla_latent_dim(self) -> int:
        """Unpadded latent width cached per token."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def kv_cache_heads(self) -> int:
        """Head count of the paged pool (MLA: one latent "head")."""
        return 1 if self.is_mla else self.num_kv_heads

    @property
    def kv_cache_entry_dim(self) -> int:
        """Last-axis width of one pool row: 2 * head_dim for K|V pairs, the
        latent width padded to a multiple of 128 for MLA (the JAX layout,
        so a pool page is byte-compatible with the reference's)."""
        if self.is_mla:
            return ((self.mla_latent_dim + 127) // 128) * 128
        return 2 * self.head_dim


@dataclasses.dataclass
class CacheConfig:
    """Paged KV cache geometry: ``num_blocks`` pages of ``page_size`` tokens
    in one pool ``[L, num_blocks, K, page_size, 2D]`` (MLA:
    ``[L, num_blocks, 1, page_size, Dl]``, see ``ModelConfig``).

    ``dtype="int8"`` is the quantized pool (``ops/quant_kv.py``): the pool
    is a pair (int8 data of that shape, f32 scales ``[L, num_blocks, K,
    page_size, 2]``, one per row and K|V half, valued on the f16 grid).
    It halves the bytes a decode step reads; MLA pools refuse it.
    ``swa_ring`` adds a second pool for the sliding layers (``swa_ring``
    below, ``SwaRingSpec``): the main pool then holds the full layers."""

    page_size: int = 16
    num_blocks: int = 512
    dtype: str = "bfloat16"
    enable_prefix_caching: bool = True
    # The sliding-window ring: a model's sliding layers move to a second,
    # smaller pool where each sequence holds a fixed ring of pages reused
    # circularly (``swa_ring_spec``), while its full layers keep this
    # pool; about half the KV bytes of a long sequence on gpt-oss-class
    # models. Prefix caching becomes hybrid: a hit is taken only where a
    # retained sliding-window section can seed the fresh ring.
    swa_ring: bool = False
    # Sections retained for hybrid prefix hits under the ring (each about
    # window / page + 1 ring-pool pages, captured when a prompt completes);
    # 0 retains none, and the ring engine then turns prefix caching off.
    swa_section_cache: int = 8
    # Ring-pool pages; 0 sizes it as max_num_seqs rings.
    swa_blocks: int = 0

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"

    def max_pages_per_seq(self, max_model_len: int) -> int:
        return math.ceil(max_model_len / self.page_size)


@dataclasses.dataclass
class SchedulerConfig:
    """Continuous batching knobs (vLLM flag names)."""

    max_num_seqs: int = 64
    # Per-step token budget; longer prompts prefill in chunks of at most
    # this many tokens, so decodes are never starved.
    max_num_batched_tokens: int = 1024
    # Chunked prefill. Off: a prompt is admitted only whole, in one step's
    # budget (a longer one is refused at arrival), and waits while it does
    # not fit what is left of the step's budget.
    enable_chunked_prefill: bool = True
    # Shape buckets of the bucketed programs, under the JAX package's names
    # so one set of keyword arguments builds either package's config; ()
    # derives powers of two up to the limit (the runner's ``_buckets``).
    # ``prefill_token_buckets`` groups prompt chunks into programs by width
    # and ``decode_batch_buckets`` pads the decode batch with pad rows.
    # ``prefill_batch_buckets`` pads no array here: it only sizes a prefill
    # group's draw from the seed stream (the runner's ``_seed_rows``).
    prefill_token_buckets: tuple[int, ...] = ()
    decode_batch_buckets: tuple[int, ...] = ()
    prefill_batch_buckets: tuple[int, ...] = ()
    # Fused decode window: K decode iterations per dispatch with on-device
    # token feedback and one readback. 1 = one step per token. A larger K
    # spreads the readback and the scheduling pass over K tokens, at the
    # cost of K-token streaming granularity and a bounded overrun past
    # stop tokens.
    decode_window: int = 1
    # One program for a whole window-1 step (prefill chunks and decode
    # rows together, one readback). Off: the split engine, one program per
    # prefill Q-bucket group plus the decode program.
    unified_step: bool = True
    # The unified step runs over the packed token stream (the flat step).
    # Off: the bucketed [B, Q] unified program.
    ragged_qlens: bool = True
    # Async stepping: while step N runs on the device, the engine schedules
    # step N+1 against the dispatched token counts and stages its host
    # arrays, then blocks on N's readback, rolls back the staged rows of
    # sequences that finished in N, and dispatches N+1. What the engine
    # emits is unchanged; outputs arrive one step later
    # (``LLMEngine._step_async``).
    async_scheduling: bool = False
    # Speculative decoding with n-gram drafts (``engine/spec.py``): each
    # decode row drafts up to ``spec_ngram_k`` tokens by matching the tail
    # of its own history, and one forward scores all 1 + k positions.
    # Acceptance is exact (greedy: the argmax; seeded: the per-(seed,
    # output index) draw), so the streams are those of the engine without
    # it. Rejected drafts' KV is truncated before any page commit.
    speculative_ngram: bool = False
    # Most draft tokens a row a step (the k of the [B, 1 + k] verify rows).
    spec_ngram_k: int = 4
    # Shortest n-gram match that proposes a draft.
    spec_ngram_min_match: int = 2
    # Fused verify window: up to this many [B, 1 + k] verify iterations in
    # one dispatch, acceptance on the device, one readback. 0 inherits
    # ``decode_window``; 1 keeps one-shot verify steps.
    spec_verify_window: int = 0
    # The batch tier: requests at or below ``PriorityClass.BATCH`` ride the
    # same continuous batch, but only backfill the token budget and pages
    # the interactive rows left this step. They never displace an
    # interactive admission, run one token a step (no draft, no window),
    # and are the first recompute-preemption victims when interactive load
    # returns, so interactive streams are the same with and without them.
    # Off: batch-priority rows are plain low-priority rows.
    batch_backfill: bool = True
    # Most batch rows running at once (0: no cap of their own; they take
    # the ``max_num_seqs`` slots interactive rows leave idle).
    batch_max_seqs: int = 0
    # New batch rows are admitted only while the main pool's used share is
    # at or below this fraction, so backfill never pushes the pool into
    # the preemption regime interactive rows would pay for.
    batch_kv_watermark: float = 0.85

    def __post_init__(self) -> None:
        if not (0.0 < self.batch_kv_watermark <= 1.0):
            raise ValueError(
                f"batch_kv_watermark={self.batch_kv_watermark} must be in "
                "(0, 1] (fraction of KV pool utilization)"
            )
        if self.batch_max_seqs < 0:
            raise ValueError(
                f"batch_max_seqs={self.batch_max_seqs} must be >= 0 "
                "(0 = no dedicated cap)"
            )
        if self.spec_verify_window < 0:
            raise ValueError(
                f"spec_verify_window={self.spec_verify_window} must be >= 0 "
                "(0 inherits decode_window)"
            )
        if self.spec_verify_window > 1 and not self.speculative_ngram:
            raise ValueError(
                "spec_verify_window > 1 without speculative_ngram configures "
                "nothing: the fused verify window only exists for the "
                "speculative engine"
            )
        if self.speculative_ngram:
            if self.spec_ngram_k < 1:
                raise ValueError(
                    f"spec_ngram_k={self.spec_ngram_k} must be >= 1 when "
                    "speculative_ngram is enabled"
                )
            if self.spec_ngram_min_match < 1:
                raise ValueError(
                    f"spec_ngram_min_match={self.spec_ngram_min_match} "
                    "must be >= 1"
                )
            if (
                self.spec_window > 1
                and 2 * (1 + self.spec_ngram_k) > self.max_num_batched_tokens
            ):
                # A windowed row plans window x (1 + k) budget tokens: if
                # the smallest window (2) cannot fit one row, the window
                # never engages.
                raise ValueError(
                    "speculative_ngram with a fused verify window needs "
                    f"max_num_batched_tokens >= {2 * (1 + self.spec_ngram_k)} "
                    f"(2 verify iterations x (1 + spec_ngram_k)); got "
                    f"{self.max_num_batched_tokens}"
                )

    @property
    def spec_window(self) -> int:
        """The fused verify window's cap (1: one-shot verify steps):
        ``spec_verify_window``, or ``decode_window`` where that is 0."""
        if not self.speculative_ngram:
            return 1
        return max(1, self.spec_verify_window or self.decode_window)

    @property
    def spec_window_set(self) -> tuple[int, ...]:
        """The window sizes the scheduler picks from, ascending: powers of
        two below the cap, and the cap. The scheduler takes the largest
        whose window x (1 + k) x rows fits the step's budget; warmup
        prepares exactly these."""
        cap = self.spec_window
        if cap <= 1:
            return ()
        out, w = [], 2
        while w < cap:
            out.append(w)
            w *= 2
        out.append(cap)
        return tuple(out)


@dataclasses.dataclass
class ParallelConfig:
    """The JAX package's ``ParallelConfig`` (``llmd_tpu/config.py:548``)
    trimmed to the two fields the chart passes: ``tensor_parallel_size``
    and ``moe_backend``, with JAX's defaults. The port runs one card and
    the grouped expert path; any other value is refused with the
    ROADMAP.md queue 1 item that would bring it (a sharded model is item
    10; the dense one-hot oracle and the all-to-all expert dispatch are
    item 9, the latter with item 10)."""

    tensor_parallel_size: int = 1
    moe_backend: str = "grouped"

    def __post_init__(self) -> None:
        if self.tensor_parallel_size != 1:
            raise ValueError(
                f"tensor_parallel_size={self.tensor_parallel_size}: the port "
                "serves a model from one card; tensor parallelism is not "
                "ported yet (ROADMAP.md queue 1 item 10)"
            )
        if self.moe_backend == "dense":
            raise ValueError(
                "moe_backend='dense': the port runs the grouped expert path "
                "only; the dense one-hot combine is not ported (ROADMAP.md "
                "queue 1 item 9)"
            )
        if self.moe_backend == "ep":
            raise ValueError(
                "moe_backend='ep': the all-to-all expert dispatch needs "
                "expert parallelism across cards, which is not ported yet "
                "(ROADMAP.md queue 1 items 9 and 10)"
            )
        if self.moe_backend != "grouped":
            raise ValueError(
                f"moe_backend={self.moe_backend!r} is not one of 'grouped', "
                "'dense', 'ep'"
            )


@dataclasses.dataclass
class OffloadConfig:
    """Tiered KV offload: HBM -> host DRAM -> files -> the cross-slice
    store (``kvtransfer/offload.py``). ``cpu_chunks`` caps the host page
    cache (pages); ``fs_dir`` turns on the file tier, where pages the host
    cache evicts go and from where they load back, across restarts;
    ``fs_max_pages`` caps it. ``store_master_url`` turns on the store tier
    behind them (``kvstore/``, ``federation/``): this host contributes a
    segment of ``store_segment_bytes`` served on ``store_data_port`` (0:
    any free port); ``publish_policy`` is ``save`` (publish every host
    save), ``evict-hot`` (publish a page the device evicts once its hash
    was used ``publish_min_hits`` times) or ``off`` (fetch only). Defaults
    are JAX's; an unknown policy is refused when the engine builds its
    federation, as in JAX.

    ``decode_paging`` is the JAX package's switch for the decode pager,
    which the port does not have yet (ROADMAP.md queue 1 item 7.6): a
    configuration that sets it is refused with the item named, and the
    pager's own knob is not a field here, so a configuration that sets it
    fails as an unknown argument."""

    enabled: bool = True
    cpu_chunks: int = 25_000
    fs_dir: str | None = None
    fs_max_pages: int = 100_000
    store_master_url: str | None = None
    store_segment_bytes: int = 8 << 30
    store_data_port: int = 0
    publish_policy: str = "save"
    publish_min_hits: int = 2
    decode_paging: bool = False

    def __post_init__(self) -> None:
        if self.decode_paging:
            raise ValueError(
                "OffloadConfig.decode_paging: the decode pager is not ported "
                "yet (ROADMAP.md queue 1 item 7.6, the pager)"
            )


@dataclasses.dataclass
class EngineConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    # Seed of the random weights and of the engine's sampling stream.
    seed: int = 0
    # An HF model directory (config.json + *.safetensors) whose weights the
    # runner loads (``models/loader.py``); None draws random weights from
    # ``seed``.
    weights_path: str | None = None
    # The server's tokenizer: an HF tokenizer directory or name, or None /
    # "byte" for the byte tokenizer (``serve/tokenizer.py``).
    tokenizer_path: str | None = None
    # P/D disaggregation (``kvtransfer/connector.py``): None, kv_producer,
    # kv_consumer or kv_both; the address consumers are told (the
    # server's --advertised-address); the shipper's port (0: any free
    # one); the lease of an export; what a failed import does (recompute
    # or fail); the wire form (auto: the pool's dtype, int8: q8 rows,
    # adaptive: the faster on this link); the in-process fast path; the
    # v3 wire's layer groups (1: the v2 chunk framing).
    kv_role: str | None = None
    kv_host: str = "127.0.0.1"
    kv_transfer_port: int = 9100
    kv_lease_ms: int = 30_000
    kv_load_failure_policy: str = "recompute"
    kv_transfer_dtype: str = "auto"
    kv_local_fastpath: bool = True
    kv_stream_groups: int = 4
    # The KV events' publisher endpoint (``events/publisher.py``: a ZMTP
    # PUB socket, ``tcp://HOST:PORT``; the server builds the publisher);
    # None publishes nothing.
    kv_events_endpoint: str | None = None
    # Tiered KV offload; None turns it off.
    offload: OffloadConfig | None = None


@dataclasses.dataclass(frozen=True)
class SwaRingSpec:
    """Geometry of the sliding-window ring pool.

    ``ring_pages`` (R) is a sequence's ring length. Within one engine step
    a sequence's sliding layers must hold every position of ``[first query
    - window, last write]`` at once (the step writes its whole chunk
    before attention reads it): at most ``window + chunk`` tokens, so
    ``R = ceil((window + chunk) / page) + 1`` (the 1 for a span that
    straddles a page). Older logical pages alias onto overwritten ring
    slots, and they are the pages the attention kernels' window never
    reads."""

    windows: tuple[int, ...]      # per layer (0 = full attention)
    full_layers: tuple[int, ...]  # layer ids on the main pool
    swa_layers: tuple[int, ...]   # layer ids on the ring pool
    ring_pages: int               # R
    num_swa_blocks: int           # ring-pool pages
    # The prefill chunk cap a sequence keeps under the ring (R is sized
    # for it; a finer chunk is always correct).
    chunk_tokens: int

    def section(self, prompt_len: int, page_size: int) -> tuple[int, int, int]:
        """A prompt's sliding-window section: (n_pre, s0, count). ``n_pre``
        is the full pages a hit may skip (never the whole prompt: the last
        token is computed for its logits); the section is logical pages
        ``[s0, n_pre)``, the window before the continuation point."""
        n_pre = max(0, (prompt_len - 1) // page_size)
        wmax = max(self.windows[i] for i in self.swa_layers)
        s0 = max(0, (n_pre * page_size - wmax) // page_size)
        return n_pre, s0, n_pre - s0

    def max_section_pages(self, page_size: int) -> int:
        """The most pages a section holds: the window, plus one page a
        span may straddle."""
        wmax = max(self.windows[i] for i in self.swa_layers)
        return -(-wmax // page_size) + 1


# A sequence's prefill chunk cap under the ring, whatever the step's token
# budget: it bounds the ring's length.
_SWA_RING_CHUNK = 2048


def swa_ring_spec(
    model: ModelConfig, cache: CacheConfig, sched: SchedulerConfig
) -> SwaRingSpec | None:
    """The ring's geometry, or None where ``swa_ring`` changes nothing: off,
    no sliding layer, MLA, or a ring as long as the full page table. A
    step writes at most the budget's chunk, a decode window, or under
    speculative decoding ``1 + k`` provisional positions a verify
    iteration for up to ``spec_window`` iterations a row."""
    if not cache.swa_ring or model.sliding_window <= 0 or model.is_mla:
        return None
    windows = model.layer_windows
    swa = tuple(i for i, w in enumerate(windows) if w > 0)
    if not swa:
        return None
    full = tuple(i for i, w in enumerate(windows) if w == 0)
    wmax = max(windows[i] for i in swa)
    chunk = max(
        min(_SWA_RING_CHUNK, sched.max_num_batched_tokens),
        sched.decode_window,
        (1 + sched.spec_ngram_k) * sched.spec_window if sched.speculative_ngram else 1,
    )
    ring = math.ceil((wmax + chunk) / cache.page_size) + 1
    if ring >= cache.max_pages_per_seq(model.max_model_len):
        return None
    if cache.swa_blocks and cache.swa_blocks < ring:
        # A pool smaller than one ring could admit no sequence: admission
        # would wait forever.
        raise ValueError(
            f"cache.swa_blocks={cache.swa_blocks} is smaller than one "
            f"ring ({ring} pages); no sequence could ever be admitted"
        )
    blocks = cache.swa_blocks or sched.max_num_seqs * ring
    return SwaRingSpec(windows, full, swa, ring, blocks, chunk)


def tiny_model_config(**overrides: Any) -> ModelConfig:
    """A toy config small enough for CPU unit tests."""
    base = dict(
        name="tiny-llama",
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        rope_theta=10000.0,
        max_model_len=128,
        dtype="float32",
    )
    base.update(overrides)
    return ModelConfig(**base)
