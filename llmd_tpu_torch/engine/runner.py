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
from llmd_tpu_torch.engine.sampler import sample_tokens, spec_seed
from llmd_tpu_torch.engine.scheduler import ScheduledSeq
from llmd_tpu_torch.models import llama
from llmd_tpu_torch.models.common import StepInput
from llmd_tpu_torch.models.loader import load_params
from llmd_tpu_torch.ops import _build

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
    except for a fused decode window)."""

    tokens: np.ndarray
    logprobs: np.ndarray


@dataclass
class StagedUnified:
    """Host arrays of one flat step: the packed token stream and the
    per-row metadata, built from the schedule."""

    prefills: list[ScheduledSeq]
    decodes: list[ScheduledSeq]
    arrays: dict
    num_live: int
    all_greedy: bool


@dataclass
class PendingUnified:
    """One dispatched-but-unread unified step: the packed [rows, 2] device
    output and which of its rows carry each prefill's and each decode's
    sample."""

    packed: torch.Tensor
    prefill_rows: list[int]
    decode_rows: list[int]


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
class PendingDecode:
    """One dispatched decode window: packed [B, 2K] (K tokens, then K
    logprobs, per row); rows [0, n) are live."""

    packed: torch.Tensor
    n: int
    k: int


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
        # The decode steps' programs (CUDA graphs on the card), by key:
        # ("window", B, K, all_greedy) or ("flat", T, all_greedy).
        self.programs = StepPrograms(self.device, self._program)

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
        table name that every step reuses. Each step copies its tables to
        the device before the next builds them (the static inputs' staging
        copy; an eager step's transfer reads its source before it
        returns). A fresh table a step costs the host more: on an H100
        host, building a 64 x 8,192 ring table took 1.2-1.9 ms fresh and
        0.6-0.7 ms reused (``profile_step.py``'s ``host_staging``)."""
        buf = self._table_bufs.get(name)
        if buf is None or buf.shape[0] < B:
            buf = self._table_bufs[name] = np.zeros((B, self.max_pages), np.int32)
            return buf
        buf = buf[:B]
        buf.fill(0)
        return buf

    def _page_table(self, requests: list[Request], B: int) -> np.ndarray:
        pt = self._host_table("page_table", B)
        for i, req in enumerate(requests):
            pt[i, : len(req.block_ids)] = req.block_ids
        return pt

    def _swa_table(self, requests: list[Request], B: int) -> np.ndarray:
        """The sliding layers' ring-view table: logical page l of row i is
        ``ring[l % R]``. The main table's shape, so every kernel path is
        unchanged; the repeats past the window are the pages the window
        never reads. A row is fixed once its ring is allocated, so it is
        memoized on the request (the scheduler drops it with the ring)."""
        pt = self._host_table("swa_table", B)
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

    def _tables(self, requests: list[Request], B: int) -> dict[str, np.ndarray]:
        """The step's page tables by input name: ``page_table``, and under
        the ring ``swa_table``."""
        out = {"page_table": self._page_table(requests, B)}
        if self.swa is not None:
            out["swa_table"] = self._swa_table(requests, B)
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

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        # Not blocking: a blocking host->device copy synchronises the
        # stream, and a dispatch must not wait for the device.
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, non_blocking=True)

    # ------------------------------------------------------------------ #
    # the flat step

    def stage_unified(
        self, prefills: list[ScheduledSeq], decodes: list[ScheduledSeq]
    ) -> StagedUnified:
        """Pack the step's rows (prefill chunks, then one-token decodes)
        into the token stream and per-row metadata. Pad rows carry
        ``row_start = total`` so the boundary array stays monotonic."""
        seqs = [*prefills, *decodes]
        B = max(self.flat_rows, len(seqs))
        total = sum(s.num_tokens for s in seqs)
        T = -(-total // _T_GRANULE) * _T_GRANULE
        requests = [s.request for s in seqs]
        temp, top_k, top_p = self._sampling_knobs(requests, B)
        a = {
            "stream": np.zeros(T, np.int64),
            "row_start": np.full(B, total, np.int64),
            "pos0": np.zeros(B, np.int64),
            "qlens": np.zeros(B, np.int64),
            **self._tables(requests, B),
            "temp": temp, "top_k": top_k, "top_p": top_p,
            "seeds": self._draw_seeds(requests, self._seed_rows("flat", B), 1)[:B, 0],
        }
        t = 0
        for r, seq in enumerate(seqs):
            req = seq.request
            start = seq.start_pos
            w = seq.num_tokens
            a["stream"][t : t + w] = req.all_token_ids[start : start + w]
            a["row_start"][r] = t
            a["pos0"][r] = start
            a["qlens"][r] = w
            t += w
        all_greedy = all(req.sampling.greedy for req in requests)
        return StagedUnified(list(prefills), list(decodes), a, total, all_greedy)

    def dispatch_unified(
        self, prefills: list[ScheduledSeq], decodes: list[ScheduledSeq]
    ) -> PendingUnified:
        """Stage and enqueue the whole window-1 step as one program: the
        flat step, or the bucketed unified step without ``ragged_qlens``."""
        if not self.flat:
            return self._dispatch_unified_bucketed(prefills, decodes)
        staged = self.stage_unified(prefills, decodes)
        a = staged.arrays
        T = len(a["stream"])
        self.live_tokens_total += staged.num_live
        self.padded_tokens_total += T - staged.num_live
        if prefills:
            x = {name: self._on_device(arr) for name, arr in a.items()}
            packed = self._flat_step(x, staged.all_greedy)
        else:
            packed = self.programs.run(("flat", T, staged.all_greedy), a)
        n_p, n_d = len(prefills), len(decodes)
        return PendingUnified(
            packed, list(range(n_p)), list(range(n_p, n_p + n_d))
        )

    def _flat_spec(self, T: int) -> Spec:
        """The static inputs of the flat step at stream length T (the
        arrays of ``stage_unified``)."""
        R, i64, i32, f32 = self.flat_rows, torch.int64, torch.int32, torch.float32
        return {
            "stream": ((T,), i64), "row_start": ((R,), i64), "pos0": ((R,), i64),
            "qlens": ((R,), i64), **self._table_spec(R),
            "temp": ((R,), f32), "top_k": ((R,), i32), "top_p": ((R,), f32),
            "seeds": ((R,), i64),
        }

    def _table_spec(self, B: int) -> Spec:
        """The page tables' static inputs (``_tables``) at B rows."""
        names = ("page_table",) if self.swa is None else ("page_table", "swa_table")
        return {name: ((B, self.max_pages), torch.int32) for name in names}

    @torch.inference_mode()
    def _flat_step(self, x: dict[str, torch.Tensor], all_greedy: bool) -> torch.Tensor:
        """The flat step's body on the device arrays ``x`` (the names of
        ``_flat_spec``); returns the packed [B, 2]. Nothing it computes
        depends on a host value but the arrays' shapes."""
        dev = self.device
        stream, row_start, pos0, qlens, page_table = (
            x[name] for name in ("stream", "row_start", "pos0", "qlens", "page_table")
        )
        T, B = stream.shape[0], row_start.shape[0]
        # Per-token view derived on device from the cu_q_lens metadata:
        # token t belongs to the row whose [row_start, row_start + qlen)
        # span holds it, its position is pos0 + its offset in the row,
        # and its causal horizon is position + 1.
        t = torch.arange(T, device=dev)
        ends = row_start + qlens  # non-decreasing (pad rows = total)
        row_of = torch.searchsorted(ends, t, right=True).clamp_(0, B - 1)
        live = t < ends[-1]
        positions = torch.where(live, pos0[row_of] + (t - row_start[row_of]), 0)
        kv_lens = torch.where(live, positions + 1, 0).int()
        group = self.cfg.num_heads // self.cfg.num_kv_heads
        inp = StepInput(
            token_ids=torch.where(live, stream, 0)[:, None],
            positions=positions.int()[:, None],
            kv_lens=kv_lens,
            page_table=page_table,
            token_rows=row_of.int(),
            num_live=ends[-1:].int(),
            # The attention kernel's query tiles, once for every layer.
            flat_items=ops.flat_work_items(row_of, kv_lens, group),
            swa_page_table=x.get("swa_table"),
        )
        hidden = self._forward(inp)
        last = (row_start + (qlens - 1).clamp(min=0)).clamp(0, T - 1)
        logits = llama.compute_logits(self.params, hidden[last, 0], self.cfg)
        tok, logp = sample_tokens(
            logits, x["temp"], x["top_k"], x["top_p"], x["seeds"], all_greedy
        )
        return torch.stack([tok.float(), logp], dim=1)  # [B, 2]

    # ------------------------------------------------------------------ #
    # bucketed [B, Q] programs: prefill groups and the unified step

    @torch.inference_mode()
    def _rows_step(
        self, rows: list[tuple[Request, int, int]], program: str
    ) -> torch.Tensor:
        """One bucketed forward over ``rows`` of (request, start position,
        token count), each row's last valid position sampled; returns the
        packed [n, 2] (token, logprob). ``program`` ("prefill" or
        "unified") sizes the draw from the seed stream (``_seed_rows``)."""
        n = len(rows)
        Q = max(w for _, _, w in rows)
        tokens = np.zeros((n, Q), np.int64)
        positions = np.zeros((n, Q), np.int32)
        qlens = np.zeros(n, np.int32)
        kvlens = np.zeros(n, np.int32)
        for i, (req, start, w) in enumerate(rows):
            tokens[i, :w] = req.all_token_ids[start : start + w]
            positions[i, :w] = np.arange(start, start + w)
            positions[i, w:] = start + w - 1  # pad slots repeat the last
            qlens[i] = w
            kvlens[i] = start + w
        requests = [req for req, _, _ in rows]
        temp, top_k, top_p = self._sampling_knobs(requests, n)
        seeds = self._draw_seeds(requests, self._seed_rows(program, n), 1)[:n, 0]
        live = int(qlens.sum())
        self.live_tokens_total += live
        self.padded_tokens_total += n * Q - live
        tables = {name: self._on_device(t) for name, t in self._tables(requests, n).items()}
        inp = StepInput(
            token_ids=self._on_device(tokens),
            positions=self._on_device(positions),
            kv_lens=self._on_device(kvlens),
            page_table=tables["page_table"],
            query_lens=self._on_device(qlens),
            live_pages=-(-int(kvlens.max()) // self.page),
            swa_page_table=tables.get("swa_table"),
        )
        hidden = self._forward(inp)
        last = self._on_device(qlens - 1).long()
        h_last = hidden[torch.arange(n, device=self.device), last]
        logits = llama.compute_logits(self.params, h_last, self.cfg)
        all_greedy = all(req.sampling.greedy for req in requests)
        tok, logp = sample_tokens(logits, temp, top_k, top_p, seeds, all_greedy)
        return torch.stack([tok.float(), logp], dim=1)

    def prefill_group_count(self, seqs: list[ScheduledSeq]) -> int:
        """How many Q-bucket programs ``dispatch_prefill`` would enqueue
        for these chunks: the engine's probe for the bucketed unified step
        (a single-group prefill-only step is already one dispatch)."""
        return len({pad_to_bucket(s.num_tokens, self.prefill_buckets) for s in seqs})

    def dispatch_prefill(self, seqs: list[ScheduledSeq]) -> PendingPrefill:
        """Enqueue all scheduled prompt chunks, one forward per Q bucket,
        so a long chunk does not pad every short chunk up to its width."""
        groups: dict[int, list[int]] = {}
        for i, s in enumerate(seqs):
            groups.setdefault(
                pad_to_bucket(s.num_tokens, self.prefill_buckets), []
            ).append(i)
        entries = []
        for _, idxs in sorted(groups.items()):
            rows = [
                (seqs[i].request, seqs[i].start_pos, seqs[i].num_tokens)
                for i in idxs
            ]
            entries.append((self._rows_step(rows, "prefill"), idxs))
        return PendingPrefill(entries, len(seqs))

    def _dispatch_unified_bucketed(
        self, prefills: list[ScheduledSeq], decodes: list[ScheduledSeq]
    ) -> PendingUnified:
        rows: list[tuple[Request, int, int]] = []
        prefill_rows: list[int] = []
        for s in prefills:
            for off in range(0, s.num_tokens, _UNIFIED_ROW_TOKENS):
                w = min(_UNIFIED_ROW_TOKENS, s.num_tokens - off)
                rows.append((s.request, s.start_pos + off, w))
            # The chunk's sample is its last sub-row's.
            prefill_rows.append(len(rows) - 1)
        decode_rows = list(range(len(rows), len(rows) + len(decodes)))
        rows += [(s.request, s.start_pos, 1) for s in decodes]
        return PendingUnified(
            self._rows_step(rows, "unified"), prefill_rows, decode_rows
        )

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
            **self._tables(requests, B), "active": active,
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
            a["first"][i] = req.all_token_ids[req.num_computed_tokens]
            a["start"][i] = req.num_computed_tokens
        n = len(requests)
        self.live_tokens_total += n * staged.k
        self.padded_tokens_total += (staged.B - n) * staged.k
        packed = self.programs.run(("window", staged.B, staged.k, staged.all_greedy), a)
        return PendingDecode(packed, n, staged.k)

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
    # the programs of the decode steps

    def _program(self, key: tuple) -> tuple[Spec, object]:
        """A program key's static inputs and body (``StepPrograms``)."""
        if key[0] == "window":
            _, B, K, greedy = key
            return self._window_spec(B, K), functools.partial(
                self._multi, k_steps=K, all_greedy=greedy)
        _, T, greedy = key
        return self._flat_spec(T), functools.partial(self._flat_step, all_greedy=greedy)

    def warm_keys(self) -> list[tuple]:
        """The programs ``warmup`` prepares, as the JAX runner's default
        warm set: both ``all_greedy`` values of every decode window the
        scheduler dispatches (K = 1 where window-1 decode steps are not
        flat, and ``decode_window``) at the largest batch bucket, and of
        the flat step at the largest decode-only stream length."""
        sched = self.config.scheduler
        windows = sorted({k for k in (1, sched.decode_window) if k > 1 or not self.flat})
        keys = [("window", self.batch_buckets[-1], k, g)
                for k in windows for g in (True, False)]
        if self.flat:
            T = -(-sched.max_num_seqs // _T_GRANULE) * _T_GRANULE
            keys += [("flat", T, g) for g in (True, False)]
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
        step dispatched (prefill groups, the decode window, or the one
        unified program) comes back in ONE device->host copy, and is split
        into the prefill and decode results."""
        packs: list[torch.Tensor] = []
        if prefill is not None:
            packs.extend(p for p, _ in prefill.entries)
        if decode is not None:
            packs.append(decode.packed)
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
            arr, n, K = hosts[-1], decode.n, decode.k
            dres = StepResult(arr[:n, :K].astype(np.int32), arr[:n, K : 2 * K])
        if unified is not None:
            arr = hosts[-1]
            if unified.prefill_rows:
                rows = unified.prefill_rows
                pres = StepResult(arr[rows, :1].astype(np.int32), arr[rows, 1:2])
            if unified.decode_rows:
                rows = unified.decode_rows
                dres = StepResult(arr[rows, :1].astype(np.int32), arr[rows, 1:2])
        return pres, dres


def _to_device(tree: dict, device: torch.device) -> dict:
    return {
        k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
        for k, v in tree.items()
    }
