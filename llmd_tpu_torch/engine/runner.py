"""Model runner: owns the device state (params + KV pool) and the step programs.

The port of ``llmd_tpu/engine/runner.py``'s synchronous programs. Each
enqueues device work and returns a pending handle; ``wait_step`` is the one
place that reads the step's tokens back.

**The flat step** (``dispatch_unified`` with ``ragged_qlens``; JAX
``stage_unified`` / ``_build_flat``): one engine step packs every scheduled
sequence's tokens (prefill chunks and one-token decode rows) into one
``[T]`` stream, padded to a 16-token bucket, with per-row ``(row_start,
pos0, qlen)`` metadata. On the device the step derives each token's row,
position and causal horizon (``kv_len = position + 1``), runs the decoder
stack, gathers each row's last hidden state, projects logits and samples.
One row per sequence: the JAX runner's 64-token sub-rows and its run plan
(``_fill_flat_runs``) exist for its bucketed layout and for the TPU write
kernel, which cannot store one row; the port's flat kernels address each
token themselves.

**The bucketed programs** (``token_rows is None``: ``[B, Q]`` rows):

- ``dispatch_prefill`` (JAX ``dispatch_prefill`` / ``_build_forward``):
  prompt chunks grouped by Q bucket, one forward per group, each row's last
  valid position sampled, a packed ``[n, 2]`` per group.
- ``stage_decode`` / ``dispatch_staged_decode`` (JAX ``_build_multi``): the
  fused K-step decode window. K forwards with ``Q = 1`` are enqueued back
  to back; the token sampled in iteration i is iteration i + 1's input on
  the device, seeds are column i of a ``[B, K]`` block, and the output is
  one packed ``[B, 2K]`` tensor. The loop reads nothing back to the host.
  ``Q = 1`` runs on the decode kernels (``ops.write_kv_pages_decode_full``,
  ``ops.decode_paged_attention_full``).
- the bucketed unified step (``dispatch_unified`` without ``ragged_qlens``;
  JAX ``_build_unified``): prefill chunks split into sub-rows of at most 64
  tokens and one-token decode rows in one ``[B, Q]`` forward. Each layer
  writes the whole step's KV before attention reads it, so a later sub-row
  attends its earlier sub-rows' fresh KV.

**Staging and dispatch** (JAX ``stage_unified`` / ``dispatch_staged_unified``,
``stage_decode`` / ``dispatch_staged_decode``). A step is staged from its
schedule first: the row structure, the page tables and the sampling knobs.
What depends on the tokens (the token stream or ``[B, Q]`` tokens, the
rows' positions, a window's first tokens) and the seed block are filled at
dispatch, from the requests' committed state. So the async engine can
stage step N+1 while step N runs and dispatch it once N's readback is
committed; a rollback of rows that finished late keeps the survivors'
staging (``subset_staged_unified``). Staging fills numpy arrays only; a
program's static inputs are written at dispatch.

**Decode steps as CUDA graphs** (``engine/graphs.py``; JAX ``warmup``).
Every decode-only step is one program per key, captured as a CUDA graph on
the card and replayed: the decode window per (batch bucket, K,
``all_greedy``), which also carries the split engine's and the bucketed
layouts' one-token decode steps, and the flat step that holds decode rows
only per (T, ``all_greedy``). Its body (``_multi``, ``_flat_step``) reads
only the key's static inputs, and the flat step's live count reaches the
KV write on the device. ``warmup`` captures the keys the scheduler reaches
at its largest batch; any other key is captured at its first use. A flat
step that holds a prefill chunk, a prefill group and the bucketed unified
step run eagerly: they are bound by the device. On the CPU the same bodies
run eagerly from the same static inputs.

**Buckets.** The JAX runner pads every shape to a bucket so that XLA
compiles each program once. The port keeps the buckets that key its
graphs: the decode batch bucket (``batch_buckets``), whose pad rows
(``valid = 0``, ``kv_len = 0``) the decode kernels skip, and the flat
step's 16-token stream granule; and the prefill Q bucket
(``prefill_buckets``) as the grouping key, because it decides how many
programs a step dispatches and so whether the engine takes the unified
step. A prefill group and the bucketed unified step pad their arrays only
to the longest row they hold, with no pad rows. The JAX row buckets of
those programs survive in one place, ``_seed_rows``: the engine's seed
stream advances by them, so unseeded sampling draws what the JAX engine
draws.

**Speculative decoding** (``SchedulerConfig.speculative_ngram``; JAX
``_build_flat``, ``_build_unified``, ``_build_verify``,
``_build_verify_window``). A decode row that drafted feeds ``[next token,
draft...]`` and is sampled at every position: the flat step and the
bucketed unified step carry an ``[B, S]`` sample plane (S = 1 + k on a
speculative engine, 1 otherwise) and a ``verify_row`` flag, and return
``[B, 2S]``. Decode-only steps of the split and bucketed engines run the
one-shot verify program (``[B, 1 + k]`` rows, every position sampled), a
step where only some rows drafted runs it beside the plain one-token
program (``dispatch_spec_split``), and in the saturated regime the fused
verify window runs ``window`` verify iterations in one program, with
acceptance, the seeded rows' seeds (``sampler.spec_seed``) and the
position advance on the device, and one readback of 4 meta columns and
``window x (1 + k)`` token and logprob columns. The verify and window
programs are graph replays keyed by their batch bucket (and the window's
size). Their ``[B, 1 + k]`` rows run on the kernels (``_verify_hidden``):
a GQA model packs the rows' live tokens into the flat step's stream on
the device (K1', K2'), an MLA model scores each position as a decode row
of its own over its row's pages (K4''s latent store, K5'). The JAX
package sends these ``Q > 1`` rows to XLA (``_geometry_ok``); the plain
``[B, Q]`` attention here is the bucketed unified step's and the prefill
groups' only.

**The sliding-window ring** (``CacheConfig.swa_ring``, ``SwaRingSpec``;
JAX ``_alloc_swa``, ``_swa_table``). The sliding layers live in a second
pool, ``kv_swa`` (``len(swa_layers)`` planes of ``num_swa_blocks`` pages),
the full layers in ``kv_cache``. Every step layout carries a second page
table, ``swa_table``, of the main table's shape: row i maps logical page l
to ``ring[l % R]`` of its sequence's ring. The same kernels run both pools
(their window, sink and int8 branches), each through its own table.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from llmd_tpu_torch import ops
from llmd_tpu_torch.config import EngineConfig, SwaRingSpec, swa_ring_spec
from llmd_tpu_torch.engine.graphs import Spec, StepPrograms
from llmd_tpu_torch.engine.request import Request
from llmd_tpu_torch.engine.sampler import accept_counts, sample_tokens, spec_seed
from llmd_tpu_torch.engine.scheduler import ScheduledSeq
from llmd_tpu_torch.models import llama
from llmd_tpu_torch.models.common import StepInput
from llmd_tpu_torch.models.loader import load_params
from llmd_tpu_torch.ops import _build
from llmd_tpu_torch.ops.quant_kv import (
    dequantize_pages,
    dequantize_rows_q8,
    pool_scales_to_wire,
    quantize_pages,
    quantize_rows_q8,
    wire_scales_to_pool,
)

# Packed-stream length granule: T pads up to a multiple of 16 tokens.
_T_GRANULE = 16
# Most tokens one row of the bucketed unified step carries: longer prefill
# chunks split into consecutive sub-rows of the same sequence, which bounds
# the [B, Q] padding a one-token decode row pays beside them.
_UNIFIED_ROW_TOKENS = 64


def _buckets(limit: int, start: int = 8) -> tuple[int, ...]:
    out, b = [], start
    while b < limit:
        out.append(b)
        b *= 2
    out.append(limit)
    return tuple(dict.fromkeys(out))


def pad_to_bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return device


@dataclass
class StepResult:
    """Sampled tokens and their logprobs for each row; [n, K] (K = 1
    except for a fused decode window, a verify step's 1 + k or a fused
    verify window's window x (1 + k)); ``meta`` [n, 4] the fused verify
    window's (emitted, drafted, accepted, iterations active) a row."""

    tokens: np.ndarray
    logprobs: np.ndarray
    meta: np.ndarray | None = None


@dataclass
class StagedUnified:
    """One step's rows staged ahead of their tokens: the row structure,
    fixed by the schedule, and the arrays that do not depend on the tokens
    (the page tables and the sampling knobs, one row each). ``program``
    is "flat" (the flat step), "unified" (the bucketed unified step) or
    "prefill" (one prefill Q-bucket group). A row is (scheduled sequence,
    offset in its chunk, tokens); ``prefill_rows`` and ``decode_rows``
    are the rows that carry each prefill's and each decode's sample."""

    prefills: list[ScheduledSeq]
    decodes: list[ScheduledSeq]
    rows: list[tuple[ScheduledSeq, int, int]]
    prefill_rows: list[int]
    decode_rows: list[int]
    arrays: dict
    all_greedy: bool
    program: str

    def widths(self) -> list[int]:
        """Each row's tokens at dispatch: a prefill row its chunk, a
        decode row 1 + its draft (proposed at dispatch; a row is planned
        at its max-acceptance width)."""
        first_decode = self.decode_rows[0] if self.decode_rows else len(self.rows)
        return [w if r < first_decode else 1 + len(s.draft_tokens or ())
                for r, (s, _, w) in enumerate(self.rows)]


@dataclass
class PendingUnified:
    """One dispatched-but-unread unified step: the packed [rows, 2S] device
    output (S sample columns, then S logprobs) and which of its rows carry
    each prefill's and each decode's sample."""

    packed: torch.Tensor
    prefill_rows: list[int]
    decode_rows: list[int]
    S: int = 1


@dataclass
class PendingPrefill:
    """Dispatched prefill groups: (packed [n_g, 2], the group's indices
    into the step's prefill list) per Q-bucket group."""

    entries: list[tuple[torch.Tensor, list[int]]]
    n: int


@dataclass
class StagedDecode:
    """Host arrays of one decode window; ``first``/``start`` and the seeds
    are filled at dispatch."""

    seqs: list[ScheduledSeq]
    arrays: dict
    B: int
    k: int
    all_greedy: bool


@dataclass
class StagedVerify:
    """Host arrays of one one-shot verify step ([B, Q] rows, Q = 1 + k);
    tokens, first positions, lengths and seeds are filled at dispatch."""

    seqs: list[ScheduledSeq]
    arrays: dict
    B: int
    q: int
    all_greedy: bool


@dataclass
class StagedVerifyWindow:
    """Host arrays of one fused verify window; the first tokens, the
    pre-drafts, the seeds and the output offsets are filled at dispatch."""

    seqs: list[ScheduledSeq]
    arrays: dict
    B: int
    window: int
    q: int
    all_greedy: bool


@dataclass
class PendingDecode:
    """The dispatched decode programs of one step: entries of (packed
    [B, meta + 2k], the step's decode rows it holds, k, meta columns);
    one entry, or two for a split verify step (the verify rows and the
    plain rows). ``k`` is the widest entry's."""

    entries: list[tuple[torch.Tensor, list[int], int, int]]
    n: int
    k: int


def pages_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host bundle as numpy, sharing its memory. numpy has no bfloat16
    and the port does not import ``ml_dtypes``: a bf16 bundle comes out
    as its bits, ``uint16``."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def pages_from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host bundle as a CPU tensor of ``dtype``: ``uint16`` (or an
    ``ml_dtypes`` bfloat16 array) read as bf16 bits, anything else cast."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy wants writable memory
        a = a.copy()
    if a.dtype.name == "bfloat16" or (a.dtype == np.uint16 and dtype == torch.bfloat16):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dtype)
    return torch.from_numpy(a).to(dtype)


class ModelRunner:
    def __init__(
        self,
        config: EngineConfig,
        params: dict | None = None,
        device: str | torch.device = "cuda",
        swa_spec: SwaRingSpec | None = None,
    ) -> None:
        self.config = config
        self.cfg = config.model
        self.device = resolve_device(device)
        self.page = config.cache.page_size
        self.max_pages = config.cache.max_pages_per_seq(self.cfg.max_model_len)
        # The tree's q|k|v and gate|up fused (JAX's ``_maybe_fuse``; MLA's
        # projections stay unfused). Loaded and drawn trees are built fused,
        # so that no unfused stacked leaf is held beside its fused copy.
        if params is not None:
            params = _to_device(params, self.device)
            self.params = params if self.cfg.is_mla else llama.fuse_projections(params)
        elif config.weights_path:
            self.params = load_params(self.cfg, config.weights_path, device=self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            self.params = llama.init_params(self.cfg, gen, self.device, fused=True)
        # The ring's geometry (the engine passes its own: its pool has room
        # for retained sections too), or None without the ring.
        self.swa = swa_spec or swa_ring_spec(self.cfg, config.cache, config.scheduler)
        c = config.cache
        if self.swa is None:
            self.kv_cache, self.kv_swa = self._alloc_pool(self.cfg.num_layers, c.num_blocks), None
        else:
            self.kv_cache = self._alloc_pool(len(self.swa.full_layers), c.num_blocks)
            self.kv_swa = self._alloc_pool(len(self.swa.swa_layers), self.swa.num_swa_blocks)
        sched = config.scheduler
        self.batch_buckets = sched.decode_batch_buckets or _buckets(sched.max_num_seqs)
        self.prefill_buckets = sched.prefill_token_buckets or _buckets(
            sched.max_num_batched_tokens, start=16
        )
        # Row buckets of the JAX programs whose arrays the port does not
        # pad; read by ``_seed_rows`` alone. A unified step's row bound:
        # every scheduled sequence is one row, plus at most budget // cap
        # extra sub-rows from chunk splitting.
        self._seed_buckets = {
            "prefill": sched.prefill_batch_buckets
            or _buckets(sched.max_num_seqs, start=1),
            "unified": _buckets(
                sched.max_num_seqs
                + sched.max_num_batched_tokens // _UNIFIED_ROW_TOKENS,
                start=1,
            ),
        }
        # The unified step runs flat (packed stream) or bucketed ([B, Q]).
        # MLA keeps the bucketed layout, as in JAX.
        self.flat = sched.unified_step and sched.ragged_qlens and not self.cfg.is_mla
        # Row-metadata width of the flat step: every sequence is one row.
        self.flat_rows = sched.max_num_seqs
        self._np_rng = np.random.default_rng(config.seed ^ 0x5EED)
        # The page tables' host buffers by name (``_host_table``).
        self._table_bufs: dict[str, np.ndarray] = {}
        # Padding accounting: live tokens and the pads the shapes added.
        self.live_tokens_total = 0
        self.padded_tokens_total = 0
        # Speculative decoding: the verify width Q = 1 + k (0: off), the
        # unified steps' sample columns S, the fused verify windows, and the
        # decode windows the engine may dispatch (JAX ``decode_windows``:
        # the plain window a windowed step falls back to when no row
        # drafted is the largest of these at or below its depth).
        self.spec_q = 1 + sched.spec_ngram_k if sched.speculative_ngram else 0
        self.unified_s = max(self.spec_q, 1)
        self.spec_windows = sched.spec_window_set
        self.decode_windows = tuple(sorted({
            1, sched.spec_window if sched.speculative_ngram else sched.decode_window,
            *self.spec_windows}))
        # The decode steps' programs (CUDA graphs on the card), by key:
        # ("window", B, K, all_greedy), ("flat", T, all_greedy),
        # ("verify", B, all_greedy) or ("vwindow", B, window, all_greedy).
        self.programs = StepPrograms(self.device, self._program)
        # The page copies to the host (``launch_page_copies``,
        # ``download_pages``) and the P/D uploads (``upload_pages_device``).
        self._copy_stream = None
        self._upload_stream = None

    def _alloc_pool(self, num_layers: int, num_blocks: int):
        """A KV pool: [L, pages, K, page, 2D], the K|V halves side by side
        on the last axis (MLA: [L, pages, 1, page, Dl], one latent row per
        token); for ``CacheConfig.dtype="int8"`` the pair (int8 data of that
        shape in zeros, f32 scales [L, pages, K, page, 2] in ones), as the
        JAX runner allocates it (``ops/quant_kv.py``)."""
        c = self.config.cache
        shape = (
            num_layers, num_blocks, self.cfg.kv_cache_heads,
            self.page, self.cfg.kv_cache_entry_dim,
        )
        if c.quantized and self.cfg.is_mla:
            # Latent rows need their own scale layout; the K|V midpoint
            # split is wrong for them: refuse, as the JAX runner does.
            raise ValueError("kv cache dtype 'int8' is not supported for MLA models")
        if c.quantized:
            return (
                torch.zeros(shape, dtype=torch.int8, device=self.device),
                torch.ones((*shape[:4], 2), dtype=torch.float32, device=self.device),
            )
        return torch.zeros(shape, dtype=getattr(torch, c.dtype), device=self.device)

    # ------------------------------------------------------------------ #
    # host-side input prep

    @staticmethod
    def _overwrite_seeded_rows(
        seeds: np.ndarray, requests: list[Request], K: int
    ) -> None:
        """Seeded rows sample deterministically per (request seed, output
        index), whatever their batch-mates or the window size."""
        for i, req in enumerate(requests):
            if req.sampling.seed is not None:
                pos = req.total_output_tokens
                for j in range(K):
                    seeds[i, j] = spec_seed(req.sampling.seed, pos + j)

    @staticmethod
    def _sampling_knobs(requests: list[Request], B: int):
        """(temp, top_k, top_p) rows of a dispatch. Seeds are not here:
        they come from the stateful rng, which advances at dispatch."""
        temp = np.zeros(B, np.float32)
        top_k = np.zeros(B, np.int32)
        top_p = np.ones(B, np.float32)
        for i, req in enumerate(requests):
            sp = req.sampling
            temp[i] = 0.0 if sp.greedy else sp.temperature
            top_k[i] = sp.top_k
            top_p[i] = sp.top_p
        return temp, top_k, top_p

    def _seed_rows(self, program: str, n: int) -> int:
        """Rows of the seed block that ``program`` ("prefill", "unified" or
        "flat") draws for ``n`` live rows: the row count of the JAX
        program's arrays (its row bucket; the flat program's metadata is
        as wide as the largest unified bucket). This exists only so that
        unseeded sampling consumes the engine's seed stream as the JAX
        engine does; no array is padded to it."""
        if program == "flat":
            return max(n, self._seed_buckets["unified"][-1])
        return max(n, pad_to_bucket(n, self._seed_buckets[program]))

    def _draw_seeds(self, requests: list[Request], B: int, K: int) -> np.ndarray:
        """One [B, K] block of the engine's seed stream (int64 holding
        uint32 values), seeded rows overwritten."""
        seeds = self._np_rng.integers(0, 2**32, size=(B, K), dtype=np.uint32)
        seeds = seeds.astype(np.int64)
        self._overwrite_seeded_rows(seeds, requests, K)
        return seeds

    def _host_table(self, name: str, B: int) -> np.ndarray:
        """A zeroed [B, max_pages] int32 host table, rows of one buffer a
        name (a table of one program kind) that every step reuses. A step
        copies its tables to the device at its dispatch (the static
        inputs' staging copy; an eager step's transfer reads its source
        before it returns), before the next step of its kind is staged;
        under async stepping the next step is staged while this one runs,
        which is after its dispatch. Kinds keep separate buffers because
        one step may hold a staged decode window while its prefill groups
        stage theirs. A fresh table a step costs the host more: on an H100
        host, building a 64 x 8,192 ring table took 1.2-1.9 ms fresh and
        0.6-0.7 ms reused (``profile_step.py``'s ``host_staging``)."""
        buf = self._table_bufs.get(name)
        if buf is None or buf.shape[0] < B:
            buf = self._table_bufs[name] = np.zeros((B, self.max_pages), np.int32)
            return buf
        buf = buf[:B]
        buf.fill(0)
        return buf

    def _page_table(self, requests: list[Request], B: int, kind: str = "step") -> np.ndarray:
        pt = self._host_table(f"{kind}.page_table", B)
        for i, req in enumerate(requests):
            pt[i, : len(req.block_ids)] = req.block_ids
        return pt

    def _swa_table(self, requests: list[Request], B: int, kind: str = "step") -> np.ndarray:
        """The sliding layers' ring-view table: logical page l of row i is
        ``ring[l % R]``. The main table's shape, so every kernel path is
        unchanged; the repeats past the window are the pages the window
        never reads. A row is fixed once its ring is allocated, so it is
        memoized on the request (the scheduler drops it with the ring)."""
        pt = self._host_table(f"{kind}.swa_table", B)
        for i, req in enumerate(requests):
            ring = req.swa_block_ids
            if not ring:
                continue
            if req.swa_table_row is None:
                req.swa_table_row = np.asarray(ring, np.int32)[
                    np.arange(self.max_pages) % len(ring)
                ]
            pt[i] = req.swa_table_row
        return pt

    def _tables(self, requests: list[Request], B: int, kind: str = "step") -> dict[str, np.ndarray]:
        """The step's page tables by input name: ``page_table``, and under
        the ring ``swa_table``; ``kind`` names the program kind whose
        buffers they fill (``_host_table``)."""
        out = {"page_table": self._page_table(requests, B, kind)}
        if self.swa is not None:
            out["swa_table"] = self._swa_table(requests, B, kind)
        return out

    @staticmethod
    def _slice_staged_rows(arrays: dict, idxs: list[int], B: int) -> dict:
        """Staged row arrays (tables, knobs) of rows ``idxs`` only, padded to
        B rows as staging pads them: one gather an array, not another walk
        over the requests' pages (JAX ``_slice_staged_rows``)."""
        rows = np.asarray(idxs, np.int64)
        out = {}
        for name, src in arrays.items():
            dst = np.zeros((B, *src.shape[1:]), src.dtype)
            if name == "top_p":
                dst[:] = 1.0  # pad rows keep the neutral knob
            dst[: len(rows)] = src[rows]
            out[name] = dst
        return out

    def _forward(self, inp: StepInput) -> torch.Tensor:
        """The decoder stack over ``inp`` on the runner's pools (updated in
        place); returns the hidden states."""
        if self.kv_swa is None:
            hidden, self.kv_cache = llama.forward_hidden(
                self.params, self.kv_cache, inp, self.cfg)
        else:
            hidden, self.kv_cache, self.kv_swa = llama.forward_hidden(
                self.params, self.kv_cache, inp, self.cfg, self.kv_swa)
        return hidden

    def copy_ring_pages(self, src: list[int], dst: list[int]) -> None:
        """Copy ring-pool pages ``src`` -> ``dst`` on the device, every plane
        and both halves of an int8 pool (JAX ``copy_pages_on_device(...,
        swa=True)``): a retained section's capture and a ring's seeding."""
        s, d = self._on_device(np.asarray(src, np.int64)), self._on_device(np.asarray(dst, np.int64))
        for t in self.kv_swa if isinstance(self.kv_swa, tuple) else (self.kv_swa,):
            t[:, d] = t[:, s]

    def kv_bytes(self) -> int:
        """Bytes of the KV pools (both halves of an int8 pool, and the
        ring pool)."""
        pools = (self.kv_cache,) if self.kv_swa is None else (self.kv_cache, self.kv_swa)
        return sum(t.numel() * t.element_size() for pool in pools
                   for t in (pool if isinstance(pool, tuple) else (pool,)))

    # ------------------------------------------------------------------ #
    # Page I/O: one set of legs for the tiered offload (JAX
    # ``gather_pages``, ``scatter_pages``) and the P/D transfer (JAX
    # ``runner.py:2400-2702``). The canonical transfer form is ``[L, n, K,
    # page, 2D]`` (MLA: ``[L, n, 1, page, Dl]``; the port keeps no
    # replicated heads) in the staging dtype, or its q8 wire form ``(int8
    # [L, n, K, page, 2D], f16 [L, n, K, page, 2])``.
    # - The gather (``_gather``): independent copies of pages, on the
    #   compute stream at the call, so program order puts them before any
    #   later write to the pool; on the card each carries the event
    #   recorded after it (``ready``).
    # - Down (``launch_host_copies``): on a copy stream after that event,
    #   into host memory the caller holds (on the card pinned slots of a
    #   ``HostPagePool``, which the copy engine writes directly), so the
    #   steps dispatched after it run beside it.
    # - Up (``upload_pages_device``): host pages (pinned slots, or the
    #   pageable arrays of the wire or a file, which the driver stages: no
    #   host copy here) on an upload stream, marked ready.
    # - The scatter (``scatter_pages_from_device``): ``index_copy_`` in
    #   place (captured graphs keep the pool's address) on the compute
    #   stream after the upload's event, so a step dispatched after it
    #   reads the pages.
    # Staging and fetch threads call these legs too: every one holds
    # ``device_lock`` (a graph capture holds it) around its device calls,
    # and none waits for the device while it holds it.

    @property
    def staging_dtype(self) -> torch.dtype:
        """The dtype of host pages: the model's for an int8 pool (its pages
        dequantized), the pool's otherwise."""
        if isinstance(self.kv_cache, tuple):
            return getattr(torch, self.cfg.dtype)
        return self.kv_cache.dtype

    @property
    def staging_dtype_name(self) -> str:
        return str(self.staging_dtype).removeprefix("torch.")

    @property
    def page_shape(self) -> tuple[int, ...]:
        """One host page: ``[L, K, page, 2D]`` (MLA: ``[L, 1, page, Dl]``)."""
        pool = self.kv_cache[0] if isinstance(self.kv_cache, tuple) else self.kv_cache
        return (pool.shape[0], *pool.shape[2:])

    @property
    def kv_quantized(self) -> bool:
        return isinstance(self.kv_cache, tuple)

    @property
    def device_lock(self):
        return self.programs.capture_lock

    def _mark_ready(self, *tensors: torch.Tensor) -> None:
        """Record, on the current stream, the event that a use of these
        tensors on another stream waits for."""
        if self.device.type != "cuda":
            return
        ev = torch.cuda.Event()
        ev.record()
        for t in tensors:
            t.ready = ev

    @staticmethod
    def _wait_ready(*tensors: torch.Tensor) -> None:
        """Make the current stream wait for each tensor's ``ready`` event,
        and keep the tensor's memory until the current stream used it."""
        for t in tensors:
            ev = getattr(t, "ready", None)
            if ev is not None:
                torch.cuda.current_stream(t.device).wait_event(ev)
                t.record_stream(torch.cuda.current_stream(t.device))

    def _gather(self, pool, page_ids: list[int], pad_to: int = 0,
                layers: tuple[int, int] | None = None,
                page_major: bool = False) -> tuple[torch.Tensor, ...]:
        """Independent copies of ``pool``'s pages (its data and, an int8
        pool, its scales): ``page_ids`` padded to ``pad_to`` by repeating
        the last id (a duplicate page of the same values), every layer or
        ``layers = (l0, Lg)``; ``[Lg, n, ...]``, or with ``page_major``
        ``[n, Lg, ...]`` (each page contiguous)."""
        ids = list(page_ids) + [page_ids[-1]] * max(pad_to - len(page_ids), 0)
        idx = self._on_device(np.asarray(ids, np.int64))
        parts = pool if isinstance(pool, tuple) else (pool,)
        if layers is not None:
            parts = tuple(t.narrow(0, layers[0], layers[1]) for t in parts)
        if page_major:
            return tuple(t.transpose(0, 1).index_select(0, idx) for t in parts)
        return tuple(t.index_select(1, idx) for t in parts)

    def _float_pages(self, parts: tuple[torch.Tensor, ...]) -> torch.Tensor:
        """Gathered pages in the staging dtype: an int8 pool's dequantized
        as JAX's ``dequantize_pages`` does."""
        return dequantize_pages(*parts, self.staging_dtype) if len(parts) == 2 else parts[0]

    def snapshot_pages_device(self, page_ids: list[int], pad_to: int = 0,
                              layers: tuple[int, int] | None = None) -> torch.Tensor:
        """The main pool's pages ``page_ids`` (padded to ``pad_to``) on the
        device, ``[L, pad_to, K, page, 2D]`` (``layers=(l0, Lg)``: that
        slice, ``[Lg, ...]``) in the staging dtype, an int8 pool's
        dequantized; an independent buffer, gathered now (JAX
        ``snapshot_pages_device``)."""
        snap = self._float_pages(self._gather(self.kv_cache, page_ids, pad_to, layers))
        self._mark_ready(snap)
        return snap

    def snapshot_swa_pages_device(self, page_ids: list[int], pad_to: int) -> torch.Tensor:
        """The ring pool's pages ``page_ids``, ``[L_swa, pad_to, ...]``, as
        ``snapshot_pages_device`` (JAX ``snapshot_swa_pages_device``)."""
        if self.kv_swa is None:
            raise RuntimeError("no sliding-window ring pool on this runner")
        snap = self._float_pages(self._gather(self.kv_swa, page_ids, pad_to))
        self._mark_ready(snap)
        return snap

    def snapshot_pages_device_q8(self, page_ids: list[int], pad_to: int,
                                 layers: tuple[int, int] | None = None):
        """The q8 wire form of the main pool's pages: a float pool's rows
        quantized on the device (``quantize_rows_q8``), an int8 pool's
        bytes and scales as they are (JAX ``snapshot_pages_device_q8``)."""
        parts = self._gather(self.kv_cache, page_ids, pad_to, layers)
        if len(parts) == 2:
            q8, scales = parts[0], pool_scales_to_wire(parts[1])
        else:
            q8, scales = quantize_rows_q8(parts[0])
        self._mark_ready(q8, scales)
        return q8, scales

    def launch_host_copies(self, src: torch.Tensor, dests):
        """Enqueue the copy of gathered pages (``src``, marked ready) into
        host memory: into ``dests``, a host tensor of ``src``'s shape, or,
        ``dests`` a list, row ``i`` of ``src`` into ``dests[i]``. On the
        card the copies run on a copy stream after the gather's event, so
        a step dispatched after this call runs beside them; returns the
        event ``wait_copies`` waits for (None on the CPU, where the copies
        are done on return). The caller keeps ``dests`` until then."""
        pairs = list(zip(dests, src)) if isinstance(dests, list) else [(dests, src)]
        if src.device.type != "cuda":
            for d, s in pairs:
                d.copy_(s)
            return None
        with self.device_lock:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            stream = self._copy_stream
            with torch.cuda.stream(stream):
                self._wait_ready(src)  # after the gather; the allocator keeps src
                for d, s in pairs:
                    d.copy_(s, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
        return done

    @staticmethod
    def wait_copies(done) -> None:
        """Wait for ``launch_host_copies``' copies (not for anything
        enqueued after them)."""
        if done is not None:
            done.synchronize()

    def launch_page_copies(self, page_ids: list[int], dests: list[torch.Tensor]):
        """The tiered offload's save: the main pool's pages ``page_ids``,
        gathered page by page in a row, into the host pages ``dests`` (each
        ``page_shape`` in ``staging_dtype``: ``HostPagePool``'s pinned
        slots) by ``launch_host_copies``; returns its event."""
        dev = self._float_pages(self._gather(self.kv_cache, page_ids, page_major=True))
        self._mark_ready(dev)
        return self.launch_host_copies(dev, dests)

    def download_pages(self, snap: torch.Tensor, host: torch.Tensor | None = None) -> np.ndarray:
        """A snapshot on the host as numpy (bf16 as ``uint16`` bits),
        sharing the memory of ``host`` (a host tensor of its shape and
        dtype: the transfer's pinned staging slot) or of a buffer of its
        own; waits for the copy."""
        if host is None:
            host = torch.empty(snap.shape, dtype=snap.dtype,
                               pin_memory=snap.device.type == "cuda")
        self.wait_copies(self.launch_host_copies(snap, host))
        return pages_to_numpy(host)

    def gather_pages(self, page_ids: list[int]) -> np.ndarray:
        """Stage pages HBM -> host in JAX's canonical form: the bundle ``[L,
        n, K, page, 2D]`` of ``page_ids`` (MLA: ``[L, n, 1, page, Dl]``;
        ``pages_to_numpy``: bf16 as ``uint16`` bits). Unlike JAX nothing is
        padded to a bucket (XLA compiles one program a shape; the port does
        not)."""
        return self.download_pages(self.snapshot_pages_device(page_ids))

    def _upload(self, srcs: list[torch.Tensor], pages: bool = False) -> torch.Tensor:
        """Host tensors on the device: ``srcs[0]``, or with ``pages`` the
        host pages ``srcs`` (each ``[L, ...]``) as the bundle ``[L, n,
        ...]``; on the card copied on the upload stream and marked ready."""
        if self.device.type != "cuda":
            return torch.stack(srcs, 1) if pages else srcs[0].clone()
        shape = (len(srcs), *srcs[0].shape) if pages else srcs[0].shape
        with self.device_lock:
            if self._upload_stream is None:
                self._upload_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._upload_stream):
                dev = torch.empty(shape, dtype=srcs[0].dtype, device=self.device)
                for d, s in zip(dev if pages else (dev,), srcs):
                    d.copy_(s, non_blocking=True)
                out = dev.transpose(0, 1) if pages else dev
                self._mark_ready(out)
        return out

    def _host_pages(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            return pages_from_numpy(a, self.staging_dtype)
        return a.to(self.staging_dtype)

    def upload_pages_device(self, pages) -> torch.Tensor:
        """Host pages on the device in the staging dtype (JAX
        ``upload_pages_device``): a canonical bundle (numpy as
        ``pages_from_numpy`` reads it, or a CPU tensor), or a list of host
        pages (each ``page_shape``: ``HostPagePool``'s slots, pages loaded
        from a file) as the bundle ``[L, n, ...]``."""
        if isinstance(pages, list):
            return self._upload([self._host_pages(p) for p in pages], pages=True)
        return self._upload([self._host_pages(pages)])

    def upload_pages_device_q8(self, q8, scales):
        """A q8 wire bundle on the device: an int8 pool keeps the pair
        (written as it is); a float pool's is dequantized there into the
        staging dtype (JAX ``upload_pages_device_q8``)."""
        q = self._upload([torch.from_numpy(np.require(q8, requirements=["C", "W"]))])
        s = self._upload([torch.from_numpy(np.require(scales, requirements=["C", "W"]))])
        if self.kv_quantized:
            return q, s
        with self.device_lock:
            self._wait_ready(q, s)
            return dequantize_rows_q8(q, s, self.staging_dtype)

    def scatter_pages_from_device(self, page_ids: list[int], vals, swa: bool = False,
                                  layers: tuple[int, int] | None = None) -> None:
        """Write a bundle on the device into the pool's pages ``page_ids``
        in place (JAX ``scatter_pages_from_device``): ``vals`` a float
        bundle (an int8 pool requantizes it on the f16 grid as JAX's
        ``quantize_pages`` does; a float pool casts it, JAX
        ``_scatter_canonical``) or a q8 pair (an int8 pool takes its bytes
        and scales as they are, with no round trip; a float pool
        dequantizes it); ``swa`` the ring pool; ``layers=(l0, Lg)`` that
        layer slice."""
        pool = self.kv_swa if swa else self.kv_cache
        parts = pool if isinstance(pool, tuple) else (pool,)
        if layers is not None:
            parts = tuple(t.narrow(0, layers[0], layers[1]) for t in parts)
        with self.device_lock:
            ids = self._on_device(np.asarray(page_ids, np.int64))
            pair = vals if isinstance(vals, tuple) else (vals,)
            self._wait_ready(*pair)
            if isinstance(vals, tuple):
                if len(parts) == 2:
                    rows = (vals[0], wire_scales_to_pool(vals[1]))
                else:
                    rows = (dequantize_rows_q8(*vals, parts[0].dtype),)
            elif len(parts) == 2:
                rows = quantize_pages(vals.to(self.staging_dtype))
            else:
                rows = (vals.to(parts[0].dtype),)
            for dst, src in zip(parts, rows):
                dst.index_copy_(1, ids, src)

    def scatter_pages(self, page_ids: list[int], pages, swa: bool = False,
                      layers: tuple[int, int] | None = None) -> None:
        """Host pages -> the pool's pages ``page_ids`` (JAX
        ``scatter_pages``): a canonical bundle ``[L, n, K, page, 2D]`` or a
        list of host pages (``upload_pages_device``), into the main pool,
        with ``swa`` the ring pool, with ``layers=(l0, Lg)`` that layer
        slice (``scatter_pages_from_device``). The tiered offload's restore
        passes its pinned slots or the pages of its files."""
        if page_ids:
            self.scatter_pages_from_device(page_ids, self.upload_pages_device(pages),
                                           swa=swa, layers=layers)

    def scatter_pages_q8(self, page_ids: list[int], q8: np.ndarray, scales: np.ndarray,
                         swa: bool = False) -> None:
        """Host q8 wire bundle -> the pool's pages (JAX
        ``scatter_pages_q8``)."""
        if page_ids:
            self.scatter_pages_from_device(page_ids, self.upload_pages_device_q8(q8, scales),
                                           swa=swa)

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        # Not blocking: a blocking host->device copy synchronises the
        # stream, and a dispatch must not wait for the device.
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, non_blocking=True)

    # ------------------------------------------------------------------ #
    # the flat step

    def stage_unified(
        self, prefills: list[ScheduledSeq], decodes: list[ScheduledSeq]
    ) -> StagedUnified:
        """Stage a window-1 step as one program, ahead of its tokens (JAX
        ``stage_unified``). The schedule fixes the rows: on the flat step
        one a sequence (prefill chunks, then one-token decodes); on the
        bucketed unified step prefill chunks cut into sub-rows of at most
        64 tokens, then the decodes. The page tables and sampling knobs
        are built here; the token stream, the rows' positions and the
        seeds are filled at dispatch (``dispatch_staged_unified``), after
        the previous step's readback has been committed: under async
        stepping a step is staged while the one before it still runs."""
        if self.flat:
            rows = [(s, 0, s.num_tokens) for s in (*prefills, *decodes)]
            n_p = len(prefills)
            return self._stage_rows(rows, "flat", prefills, decodes,
                                    list(range(n_p)), list(range(n_p, len(rows))))
        rows, prefill_rows = [], []
        for s in prefills:
            for off in range(0, s.num_tokens, _UNIFIED_ROW_TOKENS):
                rows.append((s, off, min(_UNIFIED_ROW_TOKENS, s.num_tokens - off)))
            # The chunk's sample is its last sub-row's.
            prefill_rows.append(len(rows) - 1)
        decode_rows = list(range(len(rows), len(rows) + len(decodes)))
        rows += [(s, 0, s.num_tokens) for s in decodes]
        return self._stage_rows(rows, "unified", prefills, decodes, prefill_rows, decode_rows)

    def _stage_rows(self, rows: list[tuple[ScheduledSeq, int, int]], program: str,
                    prefills: list[ScheduledSeq], decodes: list[ScheduledSeq],
                    prefill_rows: list[int], decode_rows: list[int]) -> StagedUnified:
        """Tables and knobs of ``rows``: as wide as the flat step's row
        metadata on the flat step, one per row on a bucketed program."""
        requests = [s.request for s, _, _ in rows]
        B = max(self.flat_rows, len(rows)) if program == "flat" else len(rows)
        temp, top_k, top_p = self._sampling_knobs(requests, B)
        arrays = {**self._tables(requests, B, program), "temp": temp, "top_k": top_k, "top_p": top_p}
        all_greedy = all(req.sampling.greedy for req in requests)
        return StagedUnified(list(prefills), list(decodes), rows, prefill_rows, decode_rows,
                             arrays, all_greedy, program)

    def subset_staged_unified(
        self, staged: StagedUnified, live_p: list[ScheduledSeq], live_d: list[ScheduledSeq]
    ) -> StagedUnified:
        """The staged step of the rows that survive a rollback (JAX
        ``subset_staged_unified``): their tables and knobs sliced out of the
        full staging (``_slice_staged_rows``)."""
        rows_of: dict[int, list[int]] = {}
        for r, (s, _, _) in enumerate(staged.rows):
            rows_of.setdefault(id(s), []).append(r)
        keep: list[int] = []
        prefill_rows: list[int] = []
        for s in live_p:
            keep += rows_of[id(s)]
            prefill_rows.append(len(keep) - 1)
        decode_rows = list(range(len(keep), len(keep) + len(live_d)))
        for s in live_d:
            keep += rows_of[id(s)]
        rows = [staged.rows[r] for r in keep]
        B = max(self.flat_rows, len(rows)) if staged.program == "flat" else len(rows)
        all_greedy = all(s.request.sampling.greedy for s, _, _ in rows)
        return StagedUnified(list(live_p), list(live_d), rows, prefill_rows, decode_rows,
                             self._slice_staged_rows(staged.arrays, keep, B), all_greedy,
                             staged.program)

    def dispatch_unified(
        self, prefills: list[ScheduledSeq], decodes: list[ScheduledSeq]
    ) -> PendingUnified:
        """Stage and enqueue the whole window-1 step as one program: the
        flat step, or the bucketed unified step without ``ragged_qlens``."""
        return self.dispatch_staged_unified(self.stage_unified(prefills, decodes))

    def dispatch_staged_unified(self, staged: StagedUnified) -> PendingUnified:
        """Fill a staged unified step's token-dependent arrays from the
        requests' committed state and enqueue it. A flat step with no
        prefill is its program's graph replay; one with a prefill chunk
        runs eagerly."""
        if staged.program != "flat":
            packed = self._run_rows(staged)
        else:
            a = self.fill_flat(staged)
            T, live = len(a["stream"]), int(a["qlens"].sum())
            self.live_tokens_total += live
            self.padded_tokens_total += T - live
            if staged.prefills:
                x = {name: self._on_device(arr) for name, arr in a.items()}
                packed = self._flat_step(x, staged.all_greedy)
            else:
                packed = self.programs.run(("flat", T, staged.all_greedy), a)
        return PendingUnified(packed, list(staged.prefill_rows), list(staged.decode_rows),
                              self.unified_s)

    def fill_flat(self, staged: StagedUnified) -> dict:
        """A staged flat step's arrays with the token-dependent ones filled:
        the packed stream, the per-row ``(row_start, pos0, qlens,
        verify_row)`` and the ``[B, S]`` seeds. A decode row that drafted
        feeds ``[next token, draft...]`` and is a verify row. The stream's
        length is the rows' planned widths (a speculative row's 1 + k)
        padded to the 16-token granule, as the JAX step buckets it, so a
        schedule fixes its program. Pad rows carry ``row_start = total`` so
        the boundary array stays monotonic. The seed block is drawn here,
        so the engine's seed stream advances in dispatch order."""
        B = len(staged.arrays["temp"])
        widths = staged.widths()
        total = sum(widths)
        T = -(-sum(w for _, _, w in staged.rows) // _T_GRANULE) * _T_GRANULE
        requests = [s.request for s, _, _ in staged.rows]
        a = {
            "stream": np.zeros(T, np.int64),
            "row_start": np.full(B, total, np.int64),
            "pos0": np.zeros(B, np.int64),
            "qlens": np.zeros(B, np.int64),
            "verify_row": np.zeros(B, np.bool_),
            **staged.arrays,
            "seeds": self._draw_seeds(requests, self._seed_rows("flat", B), self.unified_s)[:B],
        }
        t = 0
        for r, ((seq, off, _), w) in enumerate(zip(staged.rows, widths)):
            start = seq.start_pos + off
            a["stream"][t : t + w] = self._row_tokens(seq, start, w)
            a["row_start"][r] = t
            a["pos0"][r] = start
            a["qlens"][r] = w
            a["verify_row"][r] = bool(seq.draft_tokens)
            t += w
        return a

    @staticmethod
    def _row_tokens(seq: ScheduledSeq, start: int, w: int) -> list[int]:
        """A row's w input tokens from ``start``: the committed tokens, and
        past them a decode row's draft."""
        if seq.draft_tokens:
            return [*seq.request.token_slice(start, 1), *seq.draft_tokens]
        return seq.request.token_slice(start, w)

    def _flat_spec(self, T: int) -> Spec:
        """The static inputs of the flat step at stream length T (the
        arrays of ``stage_unified``)."""
        R, i64, i32, f32 = self.flat_rows, torch.int64, torch.int32, torch.float32
        return {
            "stream": ((T,), i64), "row_start": ((R,), i64), "pos0": ((R,), i64),
            "qlens": ((R,), i64), "verify_row": ((R,), torch.bool), **self._table_spec(R),
            "temp": ((R,), f32), "top_k": ((R,), i32), "top_p": ((R,), f32),
            "seeds": ((R, self.unified_s), i64),
        }

    def _table_spec(self, B: int) -> Spec:
        """The page tables' static inputs (``_tables``) at B rows."""
        names = ("page_table",) if self.swa is None else ("page_table", "swa_table")
        return {name: ((B, self.max_pages), torch.int32) for name in names}

    @torch.inference_mode()
    def _flat_step(self, x: dict[str, torch.Tensor], all_greedy: bool) -> torch.Tensor:
        """The flat step's body on the device arrays ``x`` (the names of
        ``_flat_spec``); returns the packed [B, 2S]. Nothing it computes
        depends on a host value but the arrays' shapes."""
        stream, row_start, qlens = x["stream"], x["row_start"], x["qlens"]
        T, B = stream.shape[0], row_start.shape[0]
        hidden = self._forward(self._flat_input(stream, row_start, x["pos0"], qlens, x))
        # The [B, S] sample plane: a verify row's every position, any
        # other row's last (its S columns repeat one sample).
        samp = self._sample_plane(qlens, x["verify_row"])
        idx = (row_start[:, None] + samp).clamp(0, T - 1).reshape(-1)
        return self._sample_packed(hidden[idx, 0], x, B, all_greedy)

    def _flat_input(self, stream: torch.Tensor, row_start: torch.Tensor, pos0: torch.Tensor,
                    qlens: torch.Tensor, x: dict[str, torch.Tensor]) -> StepInput:
        """The flat layout's per-token view, derived on the device from the
        cu_q_lens metadata: token t belongs to the row whose [row_start,
        row_start + qlen) span holds it, its position is pos0 + its offset
        in the row, and its causal horizon is position + 1. ``row_start +
        qlens`` is non-decreasing (pad rows start at the live total)."""
        T, B = stream.shape[0], row_start.shape[0]
        t = torch.arange(T, device=self.device)
        ends = row_start + qlens
        row_of = torch.searchsorted(ends, t, right=True).clamp_(0, B - 1)
        live = t < ends[-1]
        positions = torch.where(live, pos0[row_of] + (t - row_start[row_of]), 0)
        kv_lens = torch.where(live, positions + 1, 0).int()
        group = self.cfg.num_heads // self.cfg.num_kv_heads
        return StepInput(
            token_ids=torch.where(live, stream, 0)[:, None],
            positions=positions.int()[:, None],
            kv_lens=kv_lens,
            page_table=x["page_table"],
            token_rows=row_of.int(),
            num_live=ends[-1:].int(),
            # The attention kernel's query tiles, once for every layer.
            flat_items=ops.flat_work_items(row_of, kv_lens, group),
            swa_page_table=x.get("swa_table"),
        )

    def _sample_plane(self, qlens: torch.Tensor, verify_row: torch.Tensor) -> torch.Tensor:
        """[B, S] offsets in each row of the positions sampled (JAX
        ``samp_local``)."""
        last = (qlens - 1).clamp(min=0)
        cols = torch.arange(self.unified_s, device=qlens.device)
        return torch.where(verify_row[:, None], torch.minimum(cols[None, :], last[:, None]),
                           last[:, None])

    def _sample_packed(self, h: torch.Tensor, x: dict, B: int, all_greedy: bool,
                       seeds: torch.Tensor | None = None) -> torch.Tensor:
        """Logits of the hidden rows ``h`` [B * S, H] (S per row), sampled
        with each row's knobs and the seeds ``x["seeds"]`` [B, S] (or
        ``seeds``); returns the packed [B, 2S]: S tokens, then S logprobs."""
        S = h.shape[0] // B
        logits = llama.compute_logits(self.params, h, self.cfg)

        def rep(name):
            v = x[name]
            return torch.as_tensor(np.repeat(v, S) if isinstance(v, np.ndarray) else
                                   v.repeat_interleave(S), device=logits.device)

        tok, logp = sample_tokens(logits, rep("temp"), rep("top_k"), rep("top_p"),
                                  (x["seeds"] if seeds is None else seeds).reshape(-1),
                                  all_greedy)
        return torch.cat([tok.reshape(B, S).float(), logp.reshape(B, S)], dim=1)

    # ------------------------------------------------------------------ #
    # bucketed [B, Q] programs: prefill groups and the unified step

    @torch.inference_mode()
    def _run_rows(self, staged: StagedUnified) -> torch.Tensor:
        """One bucketed forward over a staged bucketed program's rows;
        returns the packed [n, 2S]. A prefill group samples each row's last
        position (S = 1); the unified step samples S = 1 + k positions of a
        verify row (a decode row that drafted) and the last of any other.
        The tokens and positions come from the requests' committed state
        now; ``staged.program`` ("prefill" or "unified") sizes the draw
        from the seed stream (``_seed_rows``)."""
        rows = staged.rows
        n = len(rows)
        widths = staged.widths()
        Q = max(widths)
        S = self.unified_s if staged.program == "unified" else 1
        tokens = np.zeros((n, Q), np.int64)
        positions = np.zeros((n, Q), np.int32)
        qlens = np.zeros(n, np.int32)
        kvlens = np.zeros(n, np.int32)
        verify = np.zeros(n, np.bool_)
        for i, ((seq, off, _), w) in enumerate(zip(rows, widths)):
            start = seq.start_pos + off
            tokens[i, :w] = self._row_tokens(seq, start, w)
            positions[i, :w] = np.arange(start, start + w)
            positions[i, w:] = start + w - 1  # pad slots repeat the last
            qlens[i] = w
            kvlens[i] = start + w
            verify[i] = bool(seq.draft_tokens)
        requests = [s.request for s, _, _ in rows]
        seeds = self._draw_seeds(requests, self._seed_rows(staged.program, n), S)[:n]
        live = int(qlens.sum())
        self.live_tokens_total += live
        self.padded_tokens_total += n * Q - live
        a = staged.arrays
        swa = a.get("swa_table")
        inp = StepInput(
            token_ids=self._on_device(tokens),
            positions=self._on_device(positions),
            kv_lens=self._on_device(kvlens),
            page_table=self._on_device(a["page_table"]),
            query_lens=self._on_device(qlens),
            live_pages=-(-int(kvlens.max()) // self.page),
            swa_page_table=None if swa is None else self._on_device(swa),
        )
        hidden = self._forward(inp)
        samp = self._sample_plane(self._on_device(qlens).long(), self._on_device(verify))[:, :S]
        h = hidden[torch.arange(n, device=self.device)[:, None], samp].reshape(n * S, -1)
        return self._sample_packed(h, {**a, "seeds": seeds}, n, staged.all_greedy)

    def prefill_group_count(self, seqs: list[ScheduledSeq]) -> int:
        """How many Q-bucket programs ``dispatch_prefill`` would enqueue
        for these chunks: the engine's probe for the bucketed unified step
        (a single-group prefill-only step is already one dispatch)."""
        return len({pad_to_bucket(s.num_tokens, self.prefill_buckets) for s in seqs})

    def dispatch_prefill(self, seqs: list[ScheduledSeq]) -> PendingPrefill:
        """Stage and enqueue all scheduled prompt chunks, one forward per Q
        bucket, so a long chunk does not pad every short chunk up to its
        width."""
        groups: dict[int, list[int]] = {}
        for i, s in enumerate(seqs):
            groups.setdefault(
                pad_to_bucket(s.num_tokens, self.prefill_buckets), []
            ).append(i)
        entries = []
        for _, idxs in sorted(groups.items()):
            group = [seqs[i] for i in idxs]
            rows = [(s, 0, s.num_tokens) for s in group]
            staged = self._stage_rows(rows, "prefill", group, [], list(range(len(rows))), [])
            entries.append((self._run_rows(staged), idxs))
        return PendingPrefill(entries, len(seqs))

    # ------------------------------------------------------------------ #
    # the fused decode window

    def stage_decode(self, seqs: list[ScheduledSeq], k_steps: int = 1) -> StagedDecode:
        """Build the decode window's host arrays: page tables (the
        scheduler has allocated every page the K tokens need), the active
        mask over the batch bucket, the sampling knobs."""
        n = len(seqs)
        B = pad_to_bucket(n, self.batch_buckets)
        requests = [s.request for s in seqs]
        active = np.zeros(B, np.bool_)
        active[:n] = True
        temp, top_k, top_p = self._sampling_knobs(requests, B)
        arrays = {
            "first": np.zeros(B, np.int64), "start": np.zeros(B, np.int32),
            **self._tables(requests, B, "window"), "active": active,
            "temp": temp, "top_k": top_k, "top_p": top_p,
        }
        all_greedy = all(req.sampling.greedy for req in requests)
        return StagedDecode(list(seqs), arrays, B, k_steps, all_greedy)

    def dispatch_staged_decode(self, staged: StagedDecode) -> PendingDecode:
        """Fill the token-dependent slots of a staged decode and enqueue
        its K iterations. One [B, K] block of the seed stream is drawn
        here, so the stream advances in dispatch order; seeded rows
        overwrite theirs per (request seed, output index)."""
        a = staged.arrays
        requests = [s.request for s in staged.seqs]
        a["seeds"] = self._draw_seeds(requests, staged.B, staged.k)
        for i, req in enumerate(requests):
            a["first"][i] = req.token_slice(req.num_computed_tokens, 1)[0]
            a["start"][i] = req.num_computed_tokens
        n = len(requests)
        self.live_tokens_total += n * staged.k
        self.padded_tokens_total += (staged.B - n) * staged.k
        packed = self.programs.run(("window", staged.B, staged.k, staged.all_greedy), a)
        return PendingDecode([(packed, list(range(n)), staged.k, 0)], n, staged.k)

    def _window_spec(self, B: int, K: int) -> Spec:
        """The static inputs of a decode window of K iterations over the
        batch bucket B (the arrays of ``stage_decode`` with the seeds)."""
        i64, i32, f32 = torch.int64, torch.int32, torch.float32
        return {
            "first": ((B,), i64), "start": ((B,), i32),
            **self._table_spec(B), "active": ((B,), torch.bool),
            "temp": ((B,), f32), "top_k": ((B,), i32), "top_p": ((B,), f32),
            "seeds": ((B, K), i64),
        }

    @torch.inference_mode()
    def _multi(self, x: dict[str, torch.Tensor], k_steps: int, all_greedy: bool) -> torch.Tensor:
        """The decode window's body on the device arrays ``x`` (the names
        of ``_window_spec``): K decode iterations with on-device token
        feedback; returns the packed [B, 2K]. Nothing in the loop reads
        the device."""
        dev = self.device
        tok, start, page_table, active = (
            x[name] for name in ("first", "start", "page_table", "active")
        )
        temp, top_k, top_p, seeds = (x[name] for name in ("temp", "top_k", "top_p", "seeds"))
        qlens = active.int()
        B = tok.shape[0]
        out_t = torch.zeros((B, k_steps), dtype=torch.float32, device=dev)
        out_l = torch.zeros((B, k_steps), dtype=torch.float32, device=dev)
        for i in range(k_steps):
            pos = start + i
            inp = StepInput(
                token_ids=tok[:, None],
                positions=pos[:, None],
                kv_lens=torch.where(active, pos + 1, 0).int(),
                page_table=page_table,
                query_lens=qlens,
                swa_page_table=x.get("swa_table"),
            )
            hidden = self._forward(inp)
            logits = llama.compute_logits(self.params, hidden[:, 0], self.cfg)
            nxt, logp = sample_tokens(
                logits, temp, top_k, top_p, seeds[:, i], all_greedy
            )
            out_t[:, i] = nxt
            out_l[:, i] = logp
            tok = nxt.long()
        return torch.cat([out_t, out_l], dim=1)

    # ------------------------------------------------------------------ #
    # speculative decoding: the one-shot verify and the fused verify window

    def _verify_hidden(self, tokens: torch.Tensor, pos0: torch.Tensor, qlen: torch.Tensor,
                       x: dict[str, torch.Tensor]) -> torch.Tensor:
        """The hidden states [B, Q, H] of ``[B, Q]`` verify rows: row b's
        first ``qlen[b]`` tokens at positions ``pos0[b] + j`` (a column past
        the row's length takes its last live column's state). A GQA model
        packs the live tokens into a flat stream of B x Q slots on the
        device and runs the flat step's kernels (K1', K2'); an MLA model,
        which has no flat step, runs each column as a decode row of its own
        over its row's pages (K4''s latent store, K5'), causal because every
        layer stores the step's rows before any attends. Nothing here reads
        the device."""
        B, Q = tokens.shape
        cols = torch.arange(Q, device=self.device)
        live = cols[None, :] < qlen[:, None]
        last = torch.minimum(cols[None, :], (qlen - 1).clamp(min=0)[:, None])
        if self.cfg.is_mla:
            # Positions past the table (a stopped row's) stay inside it.
            positions = (pos0[:, None] + cols[None, :]).clamp(max=self.max_pages * self.page - 1)
            inp = StepInput(
                token_ids=torch.where(live, tokens, 0).reshape(B * Q, 1),
                positions=positions.int().reshape(B * Q, 1),
                kv_lens=torch.where(live, positions + 1, 0).int().reshape(B * Q),
                page_table=x["page_table"].repeat_interleave(Q, dim=0),
                query_lens=live.int().reshape(B * Q),
            )
            hidden = self._forward(inp).reshape(B, Q, -1)
            return torch.gather(hidden, 1, last[:, :, None].expand(-1, -1, hidden.shape[-1]))
        T = B * Q
        row_start = torch.cumsum(qlen, 0) - qlen
        # Dead slots scatter to a spare slot past the stream.
        slot = torch.where(live, row_start[:, None] + cols[None, :], T).reshape(-1)
        stream = torch.zeros(T + 1, dtype=torch.int64, device=self.device)
        stream = stream.scatter(0, slot, tokens.reshape(-1))[:T]
        hidden = self._forward(self._flat_input(stream, row_start, pos0, qlen, x))
        return hidden[(row_start[:, None] + last).clamp(max=T - 1).reshape(-1), 0].reshape(B, Q, -1)

    def stage_spec_verify(self, seqs: list[ScheduledSeq]) -> StagedVerify:
        """Stage a one-shot verify step (JAX ``stage_spec_verify``): the
        tables and knobs now; tokens, positions, lengths and seeds at
        dispatch. Rows pad to the prefill row buckets, as in JAX: a step
        where few rows drafted verifies only those."""
        B = pad_to_bucket(len(seqs), self._seed_buckets["prefill"])
        requests = [s.request for s in seqs]
        temp, top_k, top_p = self._sampling_knobs(requests, B)
        Q = self.spec_q
        arrays = {
            **self._verify_rows(B), **self._tables(requests, B, "verify"),
            "temp": temp, "top_k": top_k, "top_p": top_p,
        }
        return StagedVerify(list(seqs), arrays, B, Q, all(r.sampling.greedy for r in requests))

    def _verify_rows(self, B: int) -> dict[str, np.ndarray]:
        """A verify step's token arrays, filled at dispatch."""
        return {"tokens": np.zeros((B, self.spec_q), np.int64), "pos0": np.zeros(B, np.int64),
                "qlens": np.zeros(B, np.int64)}

    def dispatch_staged_verify(self, staged: StagedVerify) -> PendingDecode:
        """Fill a staged verify step and enqueue it (JAX
        ``dispatch_staged_verify``): each row feeds ``[next token,
        draft...]``. One [B, Q] block of the seed stream is drawn here, in
        dispatch order; seeded rows overwrite theirs per (request seed,
        output index)."""
        a = staged.arrays
        requests = [s.request for s in staged.seqs]
        a["seeds"] = self._draw_seeds(requests, staged.B, staged.q)
        for i, seq in enumerate(staged.seqs):
            nc = seq.request.num_computed_tokens
            m = 1 + len(seq.draft_tokens or ())
            a["tokens"][i, :m] = self._row_tokens(seq, nc, m)
            a["pos0"][i] = nc
            a["qlens"][i] = m
        live = int(a["qlens"].sum())
        self.live_tokens_total += live
        self.padded_tokens_total += staged.B * staged.q - live
        packed = self.programs.run(("verify", staged.B, staged.all_greedy), a)
        n = len(staged.seqs)
        return PendingDecode([(packed, list(range(n)), staged.q, 0)], n, staged.q)

    def _verify_spec(self, B: int) -> Spec:
        """The static inputs of a one-shot verify step over B rows."""
        Q, i64, i32, f32 = self.spec_q, torch.int64, torch.int32, torch.float32
        return {
            "tokens": ((B, Q), i64), "pos0": ((B,), i64), "qlens": ((B,), i64),
            **self._table_spec(B),
            "temp": ((B,), f32), "top_k": ((B,), i32), "top_p": ((B,), f32),
            "seeds": ((B, Q), i64),
        }

    @torch.inference_mode()
    def _verify(self, x: dict[str, torch.Tensor], all_greedy: bool) -> torch.Tensor:
        """The one-shot verify body (JAX ``_build_verify``): the ``[B, Q]``
        forward, every position sampled; returns the packed [B, 2Q]."""
        B = x["tokens"].shape[0]
        hidden = self._verify_hidden(x["tokens"], x["pos0"], x["qlens"], x)
        return self._sample_packed(hidden.reshape(B * self.spec_q, -1), x, B, all_greedy)

    @staticmethod
    def _slice_rows(arrays: dict, idxs: list[int], B: int) -> dict:
        """The tables and knobs of rows ``idxs`` out of a staged verify
        step or window, padded to B rows (JAX ``_ROW_SLICE_NAMES``)."""
        names = ("page_table", "swa_table", "temp", "top_k", "top_p")
        return ModelRunner._slice_staged_rows(
            {k: v for k, v in arrays.items() if k in names}, idxs, B)

    def _subset_staged_verify(self, staged: StagedVerify, idxs: list[int]) -> StagedVerify:
        """The verify staging of rows ``idxs`` of a staged verify step (JAX
        ``_subset_staged_verify``): tables and knobs sliced, the dispatch's
        arrays fresh."""
        B = pad_to_bucket(len(idxs), self._seed_buckets["prefill"])
        Q = self.spec_q
        arrays = self._slice_rows(staged.arrays, idxs, B)
        arrays.update(self._verify_rows(B))
        sub = [staged.seqs[i] for i in idxs]
        return StagedVerify(sub, arrays, B, Q, all(s.request.sampling.greedy for s in sub))

    def _subset_staged_decode(self, staged: StagedVerify | StagedVerifyWindow,
                              idxs: list[int], k_steps: int) -> StagedDecode:
        """A plain decode window's staging of rows ``idxs`` out of a staged
        verify step or window (JAX ``_subset_staged_decode``): where the
        staged rows turn out not to draft at dispatch."""
        B = pad_to_bucket(len(idxs), self.batch_buckets)
        arrays = self._slice_rows(staged.arrays, idxs, B)
        active = np.zeros(B, np.bool_)
        active[: len(idxs)] = True
        arrays.update({"first": np.zeros(B, np.int64), "start": np.zeros(B, np.int32),
                       "active": active})
        sub = [staged.seqs[i] for i in idxs]
        return StagedDecode(sub, arrays, B, k_steps, all(s.request.sampling.greedy for s in sub))

    def degrade_staged_window(self, staged: StagedVerifyWindow, k_steps: int) -> StagedDecode:
        """A staged verify window as a plain decode window of ``k_steps``
        (JAX ``degrade_staged_window``): no row drafted at dispatch."""
        return self._subset_staged_decode(staged, list(range(len(staged.seqs))), k_steps)

    def dispatch_spec_split(self, seqs: list[ScheduledSeq],
                            staged: StagedVerify | None = None) -> PendingDecode:
        """A decode step where only some rows drafted (JAX
        ``dispatch_spec_split``): those verify, the others run the plain
        one-token program; two enqueues, one readback (``wait_step``).
        ``staged`` is the whole batch's verify staging, sliced for both."""
        drafted = [i for i, s in enumerate(seqs) if s.draft_tokens]
        plain = [i for i, s in enumerate(seqs) if not s.draft_tokens]
        reuse = staged is not None and len(staged.seqs) == len(seqs) and all(
            a is b for a, b in zip(staged.seqs, seqs))
        sub_v = (self._subset_staged_verify(staged, drafted) if reuse
                 else self.stage_spec_verify([seqs[i] for i in drafted]))
        packed = self.dispatch_staged_verify(sub_v).entries[0][0]
        entries = [(packed, drafted, self.spec_q, 0)]
        if plain:
            sub_d = (self._subset_staged_decode(staged, plain, 1) if reuse
                     else self.stage_decode([seqs[i] for i in plain], 1))
            entries.append((self.dispatch_staged_decode(sub_d).entries[0][0], plain, 1, 0))
        return PendingDecode(entries, len(seqs), self.spec_q)

    def stage_spec_verify_window(self, seqs: list[ScheduledSeq], window: int) -> StagedVerifyWindow:
        """Stage a fused verify window (JAX ``stage_spec_verify_window``):
        rows pad to the decode batch buckets; tables, knobs, the active mask
        and each row's emission limit (its planned width) now; the first
        tokens, pre-drafts, seeds and output offsets at dispatch."""
        n = len(seqs)
        B = pad_to_bucket(n, self.batch_buckets)
        Q = self.spec_q
        requests = [s.request for s in seqs]
        temp, top_k, top_p = self._sampling_knobs(requests, B)
        active = np.zeros(B, np.bool_)
        active[:n] = True
        limit = np.ones(B, np.int64)
        limit[:n] = [s.num_tokens for s in seqs]
        arrays = {
            "first": np.zeros(B, np.int64), "start": np.zeros(B, np.int64),
            "predraft": np.zeros((B, window * Q - 1), np.int64), "dlen": np.zeros(B, np.int64),
            "limit": limit, **self._tables(requests, B, "vwindow"), "active": active,
            "temp": temp, "top_k": top_k, "top_p": top_p,
            "seed_base": np.zeros(B, np.int64), "seeded": np.zeros(B, np.bool_),
            "out0": np.zeros(B, np.int64),
        }
        return StagedVerifyWindow(list(seqs), arrays, B, window, Q,
                                  all(r.sampling.greedy for r in requests))

    def dispatch_staged_verify_window(self, staged: StagedVerifyWindow) -> PendingDecode:
        """Fill a staged verify window and enqueue it (JAX
        ``dispatch_staged_verify_window``): one [B, window, Q] block of the
        seed stream, in dispatch order; a seeded row's seeds are derived
        on the device, since its output index after the first iteration
        depends on its own acceptance."""
        a = staged.arrays
        W, Q = staged.window, staged.q
        a["seeds"] = self._np_rng.integers(0, 2**32, size=(staged.B, W, Q),
                                           dtype=np.uint32).astype(np.int64)
        for i, seq in enumerate(staged.seqs):
            req = seq.request
            nc = req.num_computed_tokens
            draft = seq.draft_tokens or []
            a["first"][i] = req.token_slice(nc, 1)[0]
            a["start"][i] = nc
            a["predraft"][i, : len(draft)] = draft
            a["dlen"][i] = len(draft)
            a["out0"][i] = req.total_output_tokens
            if req.sampling.seed is not None:
                a["seed_base"][i] = req.sampling.seed & 0xFFFFFFFF
                a["seeded"][i] = True
        n = len(staged.seqs)
        # Planned widths: what is emitted is decided on the device, so the
        # padding counts pad rows only.
        self.live_tokens_total += n * W * Q
        self.padded_tokens_total += (staged.B - n) * W * Q
        key = ("vwindow", staged.B, W, staged.all_greedy)
        packed = self.programs.run(key, a)
        return PendingDecode([(packed, list(range(n)), W * Q, 4)], n, W * Q)

    def _vwindow_spec(self, B: int, W: int) -> Spec:
        """The static inputs of a fused verify window of W iterations over
        B rows."""
        Q, i64, i32, f32 = self.spec_q, torch.int64, torch.int32, torch.float32
        return {
            "first": ((B,), i64), "start": ((B,), i64), "predraft": ((B, W * Q - 1), i64),
            "dlen": ((B,), i64), "limit": ((B,), i64), **self._table_spec(B),
            "active": ((B,), torch.bool), "temp": ((B,), f32), "top_k": ((B,), i32),
            "top_p": ((B,), f32), "seed_base": ((B,), i64), "seeded": ((B,), torch.bool),
            "out0": ((B,), i64), "seeds": ((B, W, Q), i64),
        }

    @torch.inference_mode()
    def _verify_window(self, x: dict[str, torch.Tensor], window: int,
                       all_greedy: bool) -> torch.Tensor:
        """The fused verify window's body (JAX ``_build_verify_window``):
        ``window`` iterations, each reading a row's next k pre-drafted
        tokens at its own pointer, running the ``[B, 1 + k]`` forward,
        sampling (seeded rows with ``spec_seed`` of their output index),
        applying ``accept_counts``, advancing the row by what it emitted
        and feeding its last sample back. A row whose draft diverged or ran
        out continues with one-token iterations; a row at its emission
        limit stops (query length 0). Returns the packed [B, 4 + 2 window
        Q]: (emitted, drafted, accepted, iterations active), the emitted
        tokens at their output offsets, their logprobs. Nothing reads the
        device."""
        dev = self.device
        Q = self.spec_q
        k = Q - 1
        Wmax = window * Q
        first, start, predraft, dlen, limit, active = (
            x[name] for name in ("first", "start", "predraft", "dlen", "limit", "active"))
        B = first.shape[0]
        qcols = torch.arange(Q, device=dev)
        dcols = torch.arange(k, device=dev)
        last_col = predraft.shape[1] - 1
        tok, pos = first, start
        zeros = torch.zeros(B, dtype=torch.int64, device=dev)
        emitted, dptr, drafted, accepted, iters = zeros, zeros, zeros, zeros, zeros
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        # One column past the window takes the dropped (rejected) samples.
        out_t = torch.zeros((B, Wmax + 1), dtype=torch.float32, device=dev)
        out_l = torch.zeros((B, Wmax + 1), dtype=torch.float32, device=dev)
        for t in range(window):
            rem = limit - emitted
            row_on = active & (rem > 0)
            avail = torch.where(alive & row_on, (dlen - dptr).clamp(0, k), 0)
            qlen = torch.where(row_on, torch.minimum(1 + avail, rem.clamp(min=1)), 0)
            dl = (qlen - 1).clamp(min=0)  # draft columns scored
            draft = torch.gather(predraft, 1, (dptr[:, None] + dcols[None, :]).clamp(0, last_col))
            tokens = torch.cat([tok[:, None], draft], dim=1)
            hidden = self._verify_hidden(tokens, pos, qlen, x)
            out_idx = (x["out0"] + emitted)[:, None] + qcols[None, :]
            seeds = torch.where(x["seeded"][:, None], spec_seed(x["seed_base"][:, None], out_idx),
                                x["seeds"][:, t])
            packed = self._sample_packed(hidden.reshape(B * Q, -1), x, B, all_greedy, seeds)
            tgt, logp = packed[:, :Q].long(), packed[:, Q:]
            n_emit, n_acc = accept_counts(draft, tgt, dl)
            n_emit = torch.where(row_on, torch.minimum(n_emit, qlen), 0)
            col = torch.where(qcols[None, :] < n_emit[:, None], emitted[:, None] + qcols[None, :],
                              Wmax)
            out_t = out_t.scatter(1, col, tgt.float())
            out_l = out_l.scatter(1, col, logp)
            last = torch.gather(tgt, 1, (n_emit - 1).clamp(min=0)[:, None])[:, 0]
            tok = torch.where(row_on, last, tok)
            pos = pos + n_emit
            # The iteration consumed n_emit slots of the pre-draft: n_acc
            # scored columns and the correction or bonus sample, whose slot
            # had no input column. The rest of the pre-draft holds only if
            # nothing mismatched and the bonus equals its slot.
            bonus_idx = dptr + n_acc
            bonus_pred = torch.gather(predraft, 1, bonus_idx.clamp(0, last_col)[:, None])[:, 0]
            bonus_ok = (bonus_idx >= dlen) | (bonus_pred == last)
            alive = alive & torch.where(row_on, (n_acc >= dl) & bonus_ok, True)
            dptr = dptr + n_emit
            emitted = emitted + n_emit
            drafted = drafted + dl
            accepted = accepted + n_acc
            iters = iters + row_on.long()
        meta = torch.stack([emitted, drafted, accepted, iters], dim=1).float()
        return torch.cat([meta, out_t[:, :Wmax], out_l[:, :Wmax]], dim=1)

    # ------------------------------------------------------------------ #
    # the programs of the decode steps

    def _program(self, key: tuple) -> tuple[Spec, object]:
        """A program key's static inputs and body (``StepPrograms``)."""
        if key[0] == "window":
            _, B, K, greedy = key
            return self._window_spec(B, K), functools.partial(
                self._multi, k_steps=K, all_greedy=greedy)
        if key[0] == "verify":
            _, B, greedy = key
            return self._verify_spec(B), functools.partial(self._verify, all_greedy=greedy)
        if key[0] == "vwindow":
            _, B, W, greedy = key
            return self._vwindow_spec(B, W), functools.partial(
                self._verify_window, window=W, all_greedy=greedy)
        _, T, greedy = key
        return self._flat_spec(T), functools.partial(self._flat_step, all_greedy=greedy)

    def warm_keys(self) -> list[tuple]:
        """The programs ``warmup`` prepares, as the JAX runner's default
        warm set: both ``all_greedy`` values of every decode window the
        scheduler dispatches (K = 1 where window-1 decode steps are not
        flat, and ``decode_window``, or under speculative decoding the
        verify windows' sizes) at the largest batch bucket, and of the flat
        step at the largest decode-only stream length. A speculative
        engine adds its verify programs (not on the flat step, which
        verifies inside its own program: the one-row and the largest
        prefill row bucket) and every fused verify window at the largest
        batch bucket."""
        sched = self.config.scheduler
        windows = sorted({k for k in self.decode_windows if k > 1 or not self.flat})
        B = self.batch_buckets[-1]
        keys = [("window", B, k, g) for k in windows for g in (True, False)]
        if self.flat:
            T = sched.max_num_seqs
            if self.spec_q:
                T = min(T * self.spec_q, sched.max_num_batched_tokens)
            T = -(-T // _T_GRANULE) * _T_GRANULE
            keys += [("flat", T, g) for g in (True, False)]
        if self.spec_q and not self.flat:
            rows = sorted({1, self._seed_buckets["prefill"][-1]})
            keys += [("verify", b, g) for b in rows for g in (True, False)]
        keys += [("vwindow", B, w, g) for w in self.spec_windows for g in (True, False)]
        return keys

    def warmup(self) -> int:
        """Build every kernel and prepare ``warm_keys``' programs (on the
        card: capture them as CUDA graphs); returns the number of programs
        prepared. Any other key is prepared at its first use. The KV pool
        is left as it was: a program is prepared on inputs with no live
        row."""
        if self.device.type == "cuda":
            _build.build_all()
        return sum(self.programs.prepare(key) for key in self.warm_keys())

    # ------------------------------------------------------------------ #

    def wait_step(
        self,
        prefill: PendingPrefill | None = None,
        decode: PendingDecode | None = None,
        unified: PendingUnified | None = None,
    ) -> tuple[StepResult | None, StepResult | None]:
        """Block on one engine step's token readback: every program the
        step dispatched (prefill groups, the decode programs, or the one
        unified program) comes back in ONE device->host copy, and is split
        into the prefill and decode results. A fused verify window's meta
        columns go to ``StepResult.meta``; a split verify step's two
        programs fill their rows of one result."""
        packs: list[torch.Tensor] = []
        if prefill is not None:
            packs.extend(p for p, _ in prefill.entries)
        if decode is not None:
            packs.extend(p for p, _, _, _ in decode.entries)
        if unified is not None:
            packs.append(unified.packed)
        if not packs:
            return None, None
        flat = packs[0].reshape(-1) if len(packs) == 1 else torch.cat(
            [p.reshape(-1) for p in packs]
        )
        host = flat.cpu().numpy()
        hosts, off = [], 0
        for p in packs:
            hosts.append(host[off : off + p.numel()].reshape(p.shape))
            off += p.numel()
        pres = dres = None
        if prefill is not None:
            tokens = np.zeros((prefill.n, 1), np.int32)
            logprobs = np.zeros((prefill.n, 1), np.float32)
            for arr, (_, idxs) in zip(hosts, prefill.entries):
                tokens[idxs, 0] = arr[:, 0].astype(np.int32)
                logprobs[idxs, 0] = arr[:, 1]
            pres = StepResult(tokens, logprobs)
        if decode is not None:
            base = len(prefill.entries) if prefill is not None else 0
            n, K = decode.n, decode.k
            tokens = np.zeros((n, K), np.int32)
            logprobs = np.zeros((n, K), np.float32)
            meta = None
            for arr, (_, idxs, k, mc) in zip(hosts[base:], decode.entries):
                rows, m = np.asarray(idxs, np.int64), len(idxs)
                if mc:
                    if meta is None:
                        meta = np.zeros((n, mc), np.int64)
                    meta[rows] = arr[:m, :mc].astype(np.int64)
                tokens[rows, :k] = arr[:m, mc : mc + k].astype(np.int32)
                logprobs[rows, :k] = arr[:m, mc + k : mc + 2 * k]
            dres = StepResult(tokens, logprobs, meta)
        if unified is not None:
            arr, S = hosts[-1], unified.S
            if unified.prefill_rows:
                rows = unified.prefill_rows
                pres = StepResult(arr[rows, :1].astype(np.int32), arr[rows, S : S + 1])
            if unified.decode_rows:
                rows = unified.decode_rows
                dres = StepResult(arr[rows, :S].astype(np.int32), arr[rows, S : 2 * S])
        return pres, dres


def _to_device(tree: dict, device: torch.device) -> dict:
    return {
        k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
        for k, v in tree.items()
    }
