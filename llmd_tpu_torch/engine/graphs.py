"""The decode steps' programs: static inputs, and one CUDA graph per key.

The port of the JAX runner's ahead-of-time programs
(``llmd_tpu/engine/runner.py:3652 warmup``, ``:3885 _warm_decode``,
``:3761 _warm_flat``). XLA compiles each bucketed step into one program and
dispatches it as one call; the port captures each decode step's body into
one CUDA graph per key and replays it, so a step of 1,600-3,300 kernels is
one launch from the host. A key fixes every shape the body sees (the decode
window's batch bucket, K and ``all_greedy``; the decode-only flat step's
stream length T and ``all_greedy``), and the body reads only the key's
static inputs: named arrays packed into one device buffer, which a step
fills from one host buffer (pinned on the card) with one non-blocking
copy. Nothing the body computes depends on a host value that changes from
step to step.

On the card ``StepPrograms.run`` captures a key's body at its first use
(or in ``ModelRunner.warmup``) and replays it afterwards; on the CPU the
same body runs eagerly from the same buffers, so the CPU tests run what is
captured. A key's program is prepared on zero inputs: every row a pad,
nothing live, so the body writes nothing to the KV pool. On the card it
runs once eagerly on a side stream (which loads the kernels and sets their
attributes outside the capture), then under capture into the runner's one
graph memory pool. The kernel wrappers count launches when Python calls
them, which a replay does not: the counts of the preparing runs are taken
back, and the counts of the capture are added at every replay, so a count
stays the launches that ran.

A graph's output is a static tensor, and the staging buffers are reused:
step N's output is read (``ModelRunner.wait_step``, one blocking copy)
before step N+1 writes a key's host buffer and copies it to the device.
That holds under async stepping too: step N+1 is staged while N runs, but
only into numpy arrays (``ModelRunner.stage_unified``, ``stage_decode``);
its static inputs are written at its dispatch, after N's readback, when
N's copy from the host buffer has landed and N's output has been read.
The programs share one memory pool for their scratch, where a program
captured earlier may reuse a later-captured program's memory when it
replays. Each program's output is therefore a buffer of its own outside
the pool, which its graph's last kernel fills: a step may replay two
programs before its one readback (a split verify step,
``ModelRunner.dispatch_spec_split``).
A failed capture or replay raises; there is no eager retry.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import threading
from collections import Counter
from typing import Callable

import numpy as np
import torch

from llmd_tpu_torch import ops

# Name -> (shape, dtype) of a program's static inputs.
Spec = dict[str, tuple[tuple[int, ...], torch.dtype]]
_ALIGN = 16  # bytes between the packed arrays' starts


def _layout(spec: Spec) -> tuple[dict[str, int], int]:
    """Each array's byte offset in the packed buffer, and its size."""
    offsets, off = {}, 0
    for name, (shape, dtype) in spec.items():
        offsets[name] = off
        off += -(-math.prod(shape) * dtype.itemsize // _ALIGN) * _ALIGN
    return offsets, off


class StaticInputs:
    """A program's inputs: the arrays of ``spec`` packed in one device
    buffer (``views``, zeros until staged) and one host buffer of the same
    layout."""

    def __init__(self, spec: Spec, device: torch.device) -> None:
        offsets, nbytes = _layout(spec)
        self.host = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=device.type == "cuda")
        self.dev = torch.zeros(nbytes, dtype=torch.uint8, device=device)

        def views(buf: torch.Tensor) -> dict[str, torch.Tensor]:
            return {name: buf[offsets[name] : offsets[name] + math.prod(shape) * dtype.itemsize]
                    .view(dtype).view(shape) for name, (shape, dtype) in spec.items()}

        self._host = views(self.host)
        self.views = views(self.dev)

    def stage(self, arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """Write ``arrays`` (the spec's names, shapes and dtypes exactly)
        into the host buffer and copy it to the device buffer without
        waiting; returns the device views."""
        for name, dst in self._host.items():
            src = torch.from_numpy(arrays[name])
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"{name}: {src.dtype} {tuple(src.shape)}, the program's "
                                 f"input is {dst.dtype} {tuple(dst.shape)}")
            dst.copy_(src)
        self.dev.copy_(self.host, non_blocking=True)
        return self.views


@dataclasses.dataclass
class Program:
    """One key's static inputs, body and, on the card, graph; ``out`` is
    the graph's static output (outside the graph pool) and ``launches`` the kernel launches of one
    replay (``ops.launch_delta``)."""

    inputs: StaticInputs
    body: Callable[[dict[str, torch.Tensor]], torch.Tensor]
    graph: torch.cuda.CUDAGraph | None = None
    out: torch.Tensor | None = None
    launches: dict | None = None


class StepPrograms:
    """A runner's programs by key. ``build(key)`` gives a key's input spec
    and body; ``runs`` counts the steps each key ran (replays on the card,
    eager runs on the CPU)."""

    def __init__(self, device: torch.device, build: Callable) -> None:
        self.device = device
        self.build = build
        self.programs: dict[tuple, Program] = {}
        self.runs: Counter = Counter()
        self.pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        # Held while a graph is captured. A capture forbids CUDA calls
        # from other threads that could touch it (allocations, copies,
        # waits); the P/D transfer's staging and fetch threads take this
        # lock around their device work (``ModelRunner.device_lock``).
        self.capture_lock = threading.RLock()

    def prepare(self, key: tuple) -> bool:
        """Make ``key``'s program ready on zero inputs (on the card:
        captured); returns whether it was new."""
        if key in self.programs:
            return False
        spec, body = self.build(key)
        prog = Program(StaticInputs(spec, self.device), body)
        if self.device.type == "cuda":
            self._capture(prog)
        else:
            body(prog.inputs.views)
        self.programs[key] = prog
        return True

    def _capture(self, prog: Program) -> None:
        with self.capture_lock:
            self._capture_locked(prog)

    def _capture_locked(self, prog: Program) -> None:
        before = ops.launch_state()
        x = prog.inputs.views
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            out = prog.body(x)
        stream.wait_stream(side)
        prog.out = torch.empty_like(out)
        del out
        warm = ops.launch_state()
        graph = torch.cuda.CUDAGraph()
        # A graph destroyed while another is captured (an engine dropped in
        # a reference cycle, freed by a garbage collection the capture's
        # allocations set off) invalidates the capture: collect first, and
        # not during it.
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                prog.out.copy_(prog.body(x))
        finally:
            gc.enable()
        prog.launches = ops.launch_delta(ops.launch_state(), warm)
        prog.graph = graph
        ops.set_launch_state(before)

    def run(self, key: tuple, arrays: dict[str, np.ndarray]) -> torch.Tensor:
        """One step of ``key`` on ``arrays``: a replay on the card, the body
        run eagerly on the CPU."""
        self.prepare(key)
        self.runs[key] += 1
        if self.device.type == "cuda":
            return self.replay(key, arrays)
        return self.eager(key, arrays)

    def replay(self, key: tuple, arrays: dict[str, np.ndarray]) -> torch.Tensor:
        prog = self.programs[key]
        prog.inputs.stage(arrays)
        prog.graph.replay()
        ops.add_launches(prog.launches)
        return prog.out

    def eager(self, key: tuple, arrays: dict[str, np.ndarray]) -> torch.Tensor:
        """The body of ``key``'s program run eagerly on ``arrays``, from the
        same static inputs a replay reads."""
        prog = self.programs[key]
        return prog.body(prog.inputs.stage(arrays))
