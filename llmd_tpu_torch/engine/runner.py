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

**Buckets.** The JAX runner pads every shape to a bucket so that XLA
compiles each program once. PyTorch runs eagerly, so the port keeps only
the buckets that mean something beyond compilation: the decode batch
bucket (``batch_buckets``), because pad rows (``valid = 0``, ``kv_len = 0``)
are part of what the decode kernels define and a CUDA graph per bucket is
the next step; and the prefill Q bucket (``prefill_buckets``) as the
grouping key, because it decides how many programs a step dispatches and so
whether the engine takes the unified step. A prefill group and the
bucketed unified step pad their arrays only to the longest row they hold,
with no pad rows. The JAX row buckets of those programs survive in one
place, ``_seed_rows``: the engine's seed stream advances by them, so
unseeded sampling draws what the JAX engine draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from llmd_tpu_torch import ops
from llmd_tpu_torch.config import EngineConfig
from llmd_tpu_torch.engine.request import Request
from llmd_tpu_torch.engine.sampler import sample_tokens, spec_seed
from llmd_tpu_torch.engine.scheduler import ScheduledSeq
from llmd_tpu_torch.models import llama
from llmd_tpu_torch.models.common import StepInput

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
    ) -> None:
        self.config = config
        self.cfg = config.model
        self.device = resolve_device(device)
        self.page = config.cache.page_size
        self.max_pages = config.cache.max_pages_per_seq(self.cfg.max_model_len)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            params = llama.init_params(self.cfg, gen, self.device)
        else:
            params = _to_device(params, self.device)
        # JAX's ``_maybe_fuse`` leaves MLA's projections unfused.
        self.params = params if self.cfg.is_mla else llama.fuse_projections(params)
        self.kv_cache = self._alloc_pool()
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
        # Padding accounting: live tokens and the pads the shapes added.
        self.live_tokens_total = 0
        self.padded_tokens_total = 0

    def _alloc_pool(self):
        """The KV pool: [L, pages, K, page, 2D], the K|V halves side by side
        on the last axis (MLA: [L, pages, 1, page, Dl], one latent row per
        token); for ``CacheConfig.dtype="int8"`` the pair (int8 data of that
        shape in zeros, f32 scales [L, pages, K, page, 2] in ones), as the
        JAX runner allocates it (``ops/quant_kv.py``)."""
        c = self.config.cache
        shape = (
            self.cfg.num_layers, c.num_blocks, self.cfg.kv_cache_heads,
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

    def _page_table(self, requests: list[Request], B: int) -> np.ndarray:
        pt = np.zeros((B, self.max_pages), np.int32)
        for i, req in enumerate(requests):
            pt[i, : len(req.block_ids)] = req.block_ids
        return pt

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
            "page_table": self._page_table(requests, B),
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
        self.live_tokens_total += staged.num_live
        self.padded_tokens_total += len(a["stream"]) - staged.num_live
        packed = self._flat_step(a, staged.num_live, staged.all_greedy)
        n_p, n_d = len(prefills), len(decodes)
        return PendingUnified(
            packed, list(range(n_p)), list(range(n_p, n_p + n_d))
        )

    @torch.inference_mode()
    def _flat_step(self, a: dict, num_live: int, all_greedy: bool) -> torch.Tensor:
        dev = self.device
        stream = torch.as_tensor(a["stream"], device=dev)
        row_start = torch.as_tensor(a["row_start"], device=dev)
        pos0 = torch.as_tensor(a["pos0"], device=dev)
        qlens = torch.as_tensor(a["qlens"], device=dev)
        page_table = torch.as_tensor(a["page_table"], device=dev)
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
            num_live=num_live,
            # The attention kernel's query tiles, once for every layer.
            flat_items=ops.flat_work_items(row_of, kv_lens, group),
        )
        hidden, self.kv_cache = llama.forward_hidden(
            self.params, self.kv_cache, inp, self.cfg
        )
        last = (row_start + (qlens - 1).clamp(min=0)).clamp(0, T - 1)
        logits = llama.compute_logits(self.params, hidden[last, 0], self.cfg)
        tok, logp = sample_tokens(
            logits, a["temp"], a["top_k"], a["top_p"], a["seeds"], all_greedy
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
        inp = StepInput(
            token_ids=self._on_device(tokens),
            positions=self._on_device(positions),
            kv_lens=self._on_device(kvlens),
            page_table=self._on_device(self._page_table(requests, n)),
            query_lens=self._on_device(qlens),
            live_pages=-(-int(kvlens.max()) // self.page),
        )
        hidden, self.kv_cache = llama.forward_hidden(
            self.params, self.kv_cache, inp, self.cfg
        )
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
            "page_table": self._page_table(requests, B), "active": active,
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
        packed = self._multi(a, staged.k, staged.all_greedy)
        return PendingDecode(packed, n, staged.k)

    @torch.inference_mode()
    def _multi(self, a: dict, k_steps: int, all_greedy: bool) -> torch.Tensor:
        """K decode iterations with on-device token feedback; returns the
        packed [B, 2K]. Nothing in the loop reads the device."""
        dev = self.device
        tok = self._on_device(a["first"])
        start = self._on_device(a["start"])
        page_table = self._on_device(a["page_table"])
        active = self._on_device(a["active"])
        temp, top_k, top_p, seeds = (
            self._on_device(a[name]) for name in ("temp", "top_k", "top_p", "seeds")
        )
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
            )
            hidden, self.kv_cache = llama.forward_hidden(
                self.params, self.kv_cache, inp, self.cfg
            )
            logits = llama.compute_logits(self.params, hidden[:, 0], self.cfg)
            nxt, logp = sample_tokens(
                logits, temp, top_k, top_p, seeds[:, i], all_greedy
            )
            out_t[:, i] = nxt
            out_l[:, i] = logp
            tok = nxt.long()
        return torch.cat([out_t, out_l], dim=1)

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
